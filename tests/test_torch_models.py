"""The PyTorch port's increment, write-once register and single-copy
register encodings held against the JAX package, exactly.

* ``encode`` on every reachable host state, walked in both packages in
  lockstep, and the single-copy linearizability truth table;
* ``step_cols`` / ``property_conditions_cols`` (and the register's
  ``enabled_bits_cols`` / ``step_slot_cols``) against JAX ``jax.vmap``
  of the ``*_vec`` functions on every reachable state, plus seeded
  random-walk states of the 6-thread increment-lock;
* the ``increment``, ``increment-lock``, ``register`` and
  ``single-copy-register check-gpu --device cpu`` reports against JAX
  ``check-tpu`` (both in ONE process: frozenset reprs iterate alike),
  byte for byte but the header and ``sec=``;
* the register's dense wave against the JAX dense engine, replayed
  paths, the compiled 3-client single-copy register (4,243), and what
  is left out.

``slow``: increment-lock 6 (7,825) against the JAX engine.
"""

import contextlib
import io
import re
from collections import deque

import numpy as np
import pytest
import torch

SEED = 20261017


def _model(pkg: str, name: str):
    """The host model of configuration ``name`` in package ``pkg``."""
    import importlib

    root = "stateright_tpu" if pkg == "jax" else "stateright_tpu_torch"
    kind, n = name.rsplit("-", 1)
    n = int(n)
    if kind == "increment":
        return importlib.import_module(
            f"{root}.models.increment").Increment(n)
    if kind == "increment-lock":
        return importlib.import_module(
            f"{root}.models.increment").IncrementLock(n)
    if kind == "register":
        return importlib.import_module(
            f"{root}.models.nclient_register").NClientRegSys(n_clients=n)
    if kind == "single-copy":
        m = importlib.import_module(f"{root}.models.single_copy_register")
        return m.single_copy_register_model(
            m.SingleCopyRegisterCfg(client_count=n))
    raise KeyError(name)


def _bfs_lockstep(jm, pm):
    """Every reachable state of two host models of one configuration,
    in BFS order, walked in lockstep (the same action index in both)."""
    [ji], [pi] = jm.init_states(), pm.init_states()
    seen = {ji}
    order = [(ji, pi)]
    q = deque(order)
    while q:
        js, ps = q.popleft()
        j_steps, p_steps = jm.next_steps(js), pm.next_steps(ps)
        assert len(j_steps) == len(p_steps)
        for (_, jn), (_, pn) in zip(j_steps, p_steps):
            if jn not in seen:
                seen.add(jn)
                order.append((jn, pn))
                q.append((jn, pn))
    return order


def _t(vecs):
    """``[N, W]`` uint32 rows -> the port's ``[W, N]`` int64 block."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(vecs, np.uint32).astype(np.int64).T))


def _compare_device_fns(j, p, vecs):
    """``step_cols`` and ``property_conditions_cols`` == JAX ``vmap`` of
    ``step_vec`` / ``property_conditions_vec`` on ``vecs``."""
    import jax
    import jax.numpy as jnp

    def run(v):
        succ, valid = jax.vmap(j.step_vec)(v)
        return succ, valid, jax.vmap(j.property_conditions_vec)(v)

    j_succ, j_valid, j_cond = (np.asarray(x) for x in
                               jax.jit(run)(jnp.asarray(vecs)))
    succ, valid, trunc = p.step_cols(_t(vecs))
    assert trunc is None
    assert succ.shape == (p.width, len(vecs), p.max_actions)
    assert int(succ.min()) >= 0 and int(succ.max()) < 1 << 32
    assert np.array_equal(succ.permute(1, 2, 0).numpy(), j_succ)
    assert np.array_equal(valid.numpy(), j_valid)
    assert np.array_equal(p.property_conditions_cols(_t(vecs)).numpy(),
                          j_cond)
    assert j_valid.any()


@pytest.mark.parametrize("name,unique", [
    ("increment-3", 84), ("increment-lock-3", 61), ("register-3", 55),
    ("single-copy-2", 93),
])
def test_encoding_matches_jax(name, unique):
    jm, pm = _model("jax", name), _model("torch", name)
    j, p = jm.to_encoded(), pm.to_encoded()
    assert (p.width, p.max_actions) == (j.width, j.max_actions)
    pairs = _bfs_lockstep(jm, pm)
    assert len(pairs) == unique
    vecs = np.stack([j.encode(js) for js, _ in pairs])
    for (_, ps), vec in zip(pairs, vecs):
        assert np.array_equal(p.encode(ps), vec)
        if hasattr(p, "decode"):
            assert p.decode(vec) == ps
    assert np.array_equal(p.init_vecs(), j.init_vecs())
    _compare_device_fns(j, p, vecs)


def test_increment_lock_random_walks_match_jax():
    """6 threads (two thread lanes), seeded random walks."""
    jm, pm = _model("jax", "increment-lock-6"), _model("torch",
                                                        "increment-lock-6")
    j, p = jm.to_encoded(), pm.to_encoded()
    rng = np.random.default_rng(SEED)
    vecs = []
    for _ in range(60):
        js, ps = jm.init_states()[0], pm.init_states()[0]
        for _ in range(int(rng.integers(1, 25))):
            j_steps, p_steps = jm.next_steps(js), pm.next_steps(ps)
            if not j_steps:
                break
            i = int(rng.integers(len(j_steps)))
            js, ps = j_steps[i][1], p_steps[i][1]
            vecs.append(j.encode(js))
            assert np.array_equal(p.encode(ps), vecs[-1])
    _compare_device_fns(j, p, np.stack(vecs))


def test_single_copy_lin_table_matches_jax():
    j = _model("jax", "single-copy-2").to_encoded()
    p = _model("torch", "single-copy-2").to_encoded()
    assert p._lin_table.shape == (36 ** 2,)
    assert np.array_equal(p._lin_table, j._lin_table)
    assert p.universe == j.universe
    assert 0 < p._lin_table.sum() < p._lin_table.size


def test_register_sparse_matches_jax():
    """The register's sparse half: enabled words and the pair step on
    every enabled (state, slot) pair of the 4-client space."""
    import jax
    import jax.numpy as jnp

    from stateright_tpu_torch.ops.bitmask import words_to_mask

    jm, pm = _model("jax", "register-4"), _model("torch", "register-4")
    j, p = jm.to_encoded(), pm.to_encoded()
    vecs = np.stack([j.encode(js) for js, _ in _bfs_lockstep(jm, pm)])
    assert len(vecs) == 217
    bits = p.enabled_bits_cols(_t(vecs))
    rows, slots = words_to_mask(bits, p.max_actions).nonzero(as_tuple=True)
    succ, trunc, hard = p.step_slot_cols(_t(vecs)[:, rows], slots)
    assert trunc is None and hard is None
    j_bits = jax.jit(jax.vmap(j.enabled_bits_vec))(jnp.asarray(vecs))
    j_succ = jax.jit(jax.vmap(j.step_slot_vec))(
        jnp.asarray(vecs[rows.numpy()]),
        jnp.asarray(slots.numpy().astype(np.uint32)))
    assert np.array_equal(bits.numpy(), np.asarray(j_bits))
    assert np.array_equal(succ.T.numpy(), np.asarray(j_succ))


# -- CLI lanes and engine runs ------------------------------------------------


def _mask_sec(text):
    return re.sub(r"sec=[0-9.]+", "sec=X", text)


@pytest.mark.parametrize("args,done,header", [
    (["increment-lock", "3"], "Done. states=61, unique=61, depth=13",
     "Model checking increment_lock with 3 threads"),
    (["register", "2"], "Done. states=17, unique=13, depth=5",
     "Checking the write-once register with 2 clients"),
    (["register", "3"], "Done. states=103, unique=55, depth=7",
     "Checking the write-once register with 3 clients"),
    (["register", "4"], "Done. states=545, unique=217, depth=9",
     "Checking the write-once register with 4 clients"),
    (["single-copy-register", "2"], "Done. states=121, unique=93, depth=9",
     "Model checking a single-copy register with 2 clients"),
])
def test_cli_report_matches_jax_lane(args, done, header):
    from stateright_tpu.cli import main as jax_main
    from stateright_tpu_torch.cli import main as port_main

    out_j, out_p = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out_j):
        jax_main([args[0], "check-tpu", *args[1:]])
    with contextlib.redirect_stdout(out_p):
        port_main([args[0], "check-gpu", *args[1:], "--device", "cpu"])
    j_lines = _mask_sec(out_j.getvalue()).splitlines()
    p_lines = _mask_sec(out_p.getvalue()).splitlines()
    assert p_lines[0] == f"{header} on the CPU wave engine."
    assert p_lines[1] == f"{done}, sec=X"
    assert p_lines[1:] == j_lines[1:]


def _replays(model, path, prop) -> bool:
    from stateright_tpu_torch.model import Expectation
    from stateright_tpu_torch.path import Path

    replayed = Path.from_fingerprints(model, path.fingerprints())
    if replayed.fingerprints() != path.fingerprints():
        return False
    last = replayed.last_state()
    if prop.expectation == Expectation.SOMETIMES:
        return prop.condition(model, last)
    return not prop.condition(model, last)


@pytest.mark.parametrize("name,found", [
    ("increment-3", {"fin"}),
    ("increment-lock-3", set()),
    ("single-copy-2", {"value chosen"}),
])
def test_discoveries_replay(name, found):
    pm = _model("torch", name)
    c = pm.checker().spawn_sortmerge(capacity=1 << 12,
                                     device="cpu").join()
    assert c.metrics["expansion"] == "dense"
    assert c.discovered_property_names() == found
    for prop_name, path in c.discoveries().items():
        assert _replays(pm, path, pm.property_by_name(prop_name))


def test_register_dense_engine_matches_jax():
    jm, pm = _model("jax", "register-3"), _model("torch", "register-3")
    jr = jm.checker().spawn_tpu_sortmerge(
        capacity=1 << 10, frontier_capacity=256, cand_capacity=1 << 10,
        sparse=False, merge_impl="xla").join()
    pr = pm.checker().spawn_sortmerge(capacity=1 << 10, sparse=False,
                                      device="cpu").join()
    assert pr.metrics["expansion"] == "dense"
    assert (pr.unique_state_count(), pr.state_count(), pr.max_depth()) \
        == (jr.unique_state_count(), jr.state_count(), jr.max_depth()) \
        == (55, 103, 7)
    assert pr.discovery_fingerprints() == jr.discovery_fingerprints()
    jd = jr.discoveries()
    for prop_name, path in pr.discoveries().items():
        assert path.encode() == jd[prop_name].encode(), prop_name


def test_single_copy_three_clients_compiles():
    """Beyond 2 clients ``to_encoded`` takes the compiler with the
    history bound: 4,243 states (the JAX host BFS's count)."""
    import warnings

    from stateright_tpu_torch.actor.compile import CompiledActorEncoding
    from stateright_tpu_torch.cli import single_copy_checker

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        c = single_copy_checker(3, "cpu")
        assert isinstance(c.encoded, CompiledActorEncoding)
        c.join()
    assert (c.unique_state_count(), c.max_depth()) == (4243, 13)
    assert c.discovered_property_names() == {"value chosen"}
    assert c.metrics["expansion"] == "sparse"


def test_single_copy_one_client_matches_jax_host():
    """One client: 5 states, depth 5 and the JAX host check's "value
    chosen" discovery; every reachable state steps as JAX ``step_vec``
    does. The JAX encoding cannot be built at one client (its table
    builder reads a value no client wrote), so the comparison uses a
    subclass that skips those table entries, as the port does."""
    from stateright_tpu.models.single_copy_register import (
        SingleCopyRegisterCfg,
    )
    from stateright_tpu.models.single_copy_register_tpu import (
        SingleCopyEncoded,
    )
    from stateright_tpu_torch.cli import single_copy_checker

    class JaxOneClient(SingleCopyEncoded):
        def _tester_for(self, combos):
            if any(ph == 3 and rv > len(self.values)
                   for ph, rv, _ in combos):
                return None
            return super()._tester_for(combos)

    jm, pm = _model("jax", "single-copy-1"), _model("torch",
                                                     "single-copy-1")
    host = jm.checker().spawn_dfs().join()
    c = single_copy_checker(1, "cpu").join()
    assert c.unique_state_count() == host.unique_state_count() == 5
    assert c.max_depth() == host.max_depth() == 5
    assert set(c.discoveries()) == set(host.discoveries()) == {
        "value chosen"}
    assert (c.discovery("value chosen").fingerprints()
            == host.discovery("value chosen").fingerprints())
    j = JaxOneClient(SingleCopyRegisterCfg(client_count=1))
    p = pm.to_encoded()
    pairs = _bfs_lockstep(jm, pm)
    assert len(pairs) == 5
    vecs = np.stack([j.encode(js) for js, _ in pairs])
    for (_, ps), vec in zip(pairs, vecs):
        assert np.array_equal(p.encode(ps), vec)
    assert np.array_equal(p._lin_table, j._lin_table)
    _compare_device_fns(j, p, vecs)


def test_left_out_and_limits():
    from stateright_tpu_torch.models.increment_tpu import IncrementEncoded
    from stateright_tpu_torch.models.nclient_register_tpu import (
        NClientRegEncoded,
    )

    # the register declares its clients' symmetry; one client
    # has nothing to permute
    spec = NClientRegEncoded(3).device_rewrite_spec()
    assert spec.n_members == 3 and len(spec.fields) == 1
    assert NClientRegEncoded(1).device_rewrite_spec() is None
    with pytest.raises(ValueError, match="at most 8 threads"):
        IncrementEncoded(9)
    with pytest.raises(ValueError, match="up to 8 clients"):
        NClientRegEncoded(9)


def test_new_lanes_refuse_without_cuda():
    from stateright_tpu_torch.cli import main as port_main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for args in (["increment", "check-gpu", "2"],
                 ["increment-lock", "check-gpu", "2"],
                 ["register", "check-gpu", "2"],
                 ["single-copy-register", "check-gpu", "2"]):
        with contextlib.redirect_stdout(io.StringIO()), \
                pytest.raises(RuntimeError, match="no CUDA device"):
            port_main(args)


@pytest.mark.slow
def test_increment_lock_6_matches_jax():
    jm, pm = _model("jax", "increment-lock-6"), _model("torch",
                                                        "increment-lock-6")
    jr = jm.checker().spawn_tpu_sortmerge(
        capacity=1 << 13, frontier_capacity=1 << 10,
        cand_capacity=1 << 12, merge_impl="xla").join()
    pr = pm.checker().spawn_sortmerge(capacity=1 << 13,
                                      device="cpu").join()
    assert pr.unique_state_count() == jr.unique_state_count() == 7825
    assert (pr.state_count(), pr.max_depth()) == (jr.state_count(),
                                                  jr.max_depth())
    assert pr.discovery_fingerprints() == jr.discovery_fingerprints() == {}
