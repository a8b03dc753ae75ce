"""The PyTorch port's dense wave held against the JAX package, exactly.

* ``step_cols`` (the dense step) against JAX ``jax.vmap(step_vec)`` —
  successors in every slot, ``valid`` and ``trunc`` — on every state
  the port's dense engine steps: 2pc rm=3 (plus seeded random lanes),
  paxos 1 client, the compiled ping-pong (lossy duplicating network,
  max_nat=5) and the compiled ``2pc-actors`` rm=3;
* the engine with ``sparse=False`` against JAX
  ``spawn_tpu_sortmerge(sparse=False)``: unique, ``states=``, depth,
  discovery fingerprints and ``Path.encode()`` at 2pc rm=3/4, paxos 1
  client and ping-pong;
* a dense run split into many row chunks against a run in one chunk;
* which expansion the engine picks, and loud truncation on the dense
  wave.

``slow``: paxos 2 clients and ``2pc-actors`` rm=5 against the JAX dense
engine, and the two-lane Paxos layout (4 clients) step.
"""

import warnings

import numpy as np
import pytest
import torch

SEED = 20261017

#: the JAX engine's sizes for the engine comparisons
JAX_SIZES = dict(capacity=1 << 13, frontier_capacity=1 << 11,
                 cand_capacity=1 << 16, merge_impl="xla")


def _build(pkg: str, name: str):
    """``(model, encoding)`` of configuration ``name`` in package ``pkg``
    ("jax" or "torch"), built the same way in both."""
    import importlib

    root = "stateright_tpu" if pkg == "jax" else "stateright_tpu_torch"

    def mod(path):
        return importlib.import_module(f"{root}.{path}")

    if name.startswith("2pc-actors-"):
        t = mod("models.two_phase_commit_actors")
        rm = int(name.rsplit("-", 1)[1])
        return (t.two_phase_sys_actor_model(rm),
                t.two_phase_sys_compiled_encoded(rm))
    if name.startswith("2pc-"):
        model = mod("models.two_phase_commit").TwoPhaseSys(
            rm_count=int(name[4:]))
        return model, model.to_encoded()
    if name.startswith("paxos-"):
        px = mod("models.paxos")
        model = px.paxos_model(px.PaxosModelCfg(
            client_count=int(name[6]), server_count=3))
        return model, model.to_encoded()
    if name == "pp-lossy-5":
        pp = mod("models.ping_pong")
        cfg = pp.PingPongCfg(maintains_history=True, max_nat=5)
        model = pp.ping_pong_model(cfg)
        model.set_lossy_network(True)
        return model, mod("actor.compile").compile_actor_model(
            model, **pp.ping_pong_device_specs(cfg))
    raise KeyError(name)


def _t(vecs):
    """``[N, W]`` uint32 rows -> the port's ``[W, N]`` int64 block."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(vecs, np.uint32).astype(np.int64).T))


def _dense_engine_states(model, enc):
    """Every frontier the port's dense engine hands ``step_cols``, as
    ``[N, W]`` uint32 rows."""
    blocks = []
    real = enc.step_cols

    def recording(states_t):
        blocks.append(states_t.T.numpy().astype(np.uint32))
        return real(states_t)

    enc.step_cols = recording
    try:
        c = model.checker().spawn_sortmerge(
            encoded=enc, capacity=1 << 16, track_paths=False,
            sparse=False, device="cpu").join()
    finally:
        del enc.step_cols
    vecs = np.concatenate(blocks)
    assert len(vecs) == c.unique_state_count()
    return vecs


def _compare_step(j, p, vecs):
    """Port ``step_cols`` == JAX ``vmap(step_vec)`` on ``vecs``: every
    slot's successor, ``valid`` and ``trunc``."""
    import jax
    import jax.numpy as jnp

    res = jax.jit(jax.vmap(j.step_vec))(jnp.asarray(vecs))
    j_succ, j_valid = np.asarray(res[0]), np.asarray(res[1])
    j_trunc = (np.asarray(res[2]) if len(res) == 3
               else np.zeros(len(vecs), bool))
    succ, valid, trunc = p.step_cols(_t(vecs))
    n, K, W = len(vecs), p.max_actions, p.width
    assert succ.shape == (W, n, K) and succ.dtype == torch.int64
    assert valid.shape == (n, K) and valid.dtype == torch.bool
    assert int(succ.min()) >= 0 and int(succ.max()) < 1 << 32
    assert np.array_equal(succ.permute(1, 2, 0).numpy(), j_succ)
    assert np.array_equal(valid.numpy(), j_valid)
    got_trunc = np.zeros(n, bool) if trunc is None else trunc.numpy()
    assert np.array_equal(got_trunc, j_trunc)
    assert j_valid.any()


# -- 1. the dense step ------------------------------------------------------


@pytest.mark.parametrize("name,unique", [
    ("2pc-3", 288), ("paxos-1c", 265), ("pp-lossy-5", 4094),
    ("2pc-actors-3", 288),
])
def test_dense_step_matches_jax(name, unique):
    (_, j), (pm, p) = _build("jax", name), _build("torch", name)
    vecs = _dense_engine_states(pm, p)
    assert len(vecs) == unique
    _compare_step(j, p, vecs)


def test_dense_step_matches_jax_random_lanes():
    """2pc's step is pure bit arithmetic: hold it on seeded arbitrary
    lanes too (bits no reachable state sets)."""
    (_, j), (_, p) = _build("jax", "2pc-3"), _build("torch", "2pc-3")
    rng = np.random.default_rng(SEED)
    vecs = rng.integers(0, 1 << 32, size=(2000, 2), dtype=np.uint64)
    _compare_step(j, p, vecs.astype(np.uint32))


# -- 2. the dense engine ------------------------------------------------------


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


def _assert_same_run(pr, jr, pm):
    assert pr.unique_state_count() == jr.unique_state_count()
    assert pr.state_count() == jr.state_count()
    assert pr.max_depth() == jr.max_depth()
    assert pr.discovery_fingerprints() == jr.discovery_fingerprints()
    jd, pd = jr.discoveries(), pr.discoveries()
    assert set(pd) == set(jd) and pd
    for prop_name, path in pd.items():
        assert path.encode() == jd[prop_name].encode(), prop_name
        assert _replays(pm, path, pm.property_by_name(prop_name)), prop_name


@pytest.mark.parametrize("name,unique,generated", [
    ("2pc-3", 288, 1146), ("2pc-4", 1568, 8258), ("paxos-1c", 265, 482),
    ("pp-lossy-5", 4094, 21505),
])
def test_dense_engine_matches_jax(name, unique, generated):
    (jm, j), (pm, p) = _build("jax", name), _build("torch", name)
    jr = jm.checker().spawn_tpu_sortmerge(encoded=j, sparse=False,
                                          **JAX_SIZES).join()
    pr = pm.checker().spawn_sortmerge(
        encoded=p, capacity=1 << 13, sparse=False, device="cpu").join()
    assert pr.metrics["expansion"] == "dense"
    assert (pr.unique_state_count(), pr.state_count()) == (unique,
                                                           generated)
    _assert_same_run(pr, jr, pm)


@pytest.mark.parametrize("name,rows", [("2pc-4", 3), ("paxos-1c", 3),
                                       ("pp-lossy-5", 40)])
def test_chunked_run_equals_one_chunk(name, rows):
    """A dense run stepped a few rows at a time equals one stepped in
    one chunk per wave: counts, depth, discoveries, paths and the
    widest waves' shapes."""
    pm, p = _build("torch", name)
    one = pm.checker().spawn_sortmerge(
        encoded=p, capacity=1 << 13, sparse=False, device="cpu").join()
    many = pm.checker().spawn_sortmerge(
        encoded=p, capacity=1 << 13, sparse=False, device="cpu",
        dense_chunk_bytes=8 * p.width * p.max_actions * rows).join()
    assert one.metrics["dense_chunks"] == one.metrics["waves"]
    assert many.metrics["chunk_rows"] == rows
    assert many.metrics["dense_chunks"] > 3 * many.metrics["waves"]
    assert many.metrics["max_wave_chunks"] > 1
    _assert_same_run(many, one, pm)
    for key in ("waves", "max_wave_candidates", "max_wave_new",
                "member_shape", "merge_shape"):
        assert many.metrics[key] == one.metrics[key], key


# -- 3. the engine's choice and loud truncation ------------------------------


def test_expansion_choice():
    """Sparse iff the encoding has enabled_bits_cols and step_slot_cols,
    unless the caller forces it; a forced expansion the encoding lacks
    raises at spawn."""
    from stateright_tpu_torch.models.increment import Increment
    from stateright_tpu_torch.models.nclient_register import NClientRegSys
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    def expansion(model, **kw):
        c = model.checker().spawn_sortmerge(device="cpu", **kw).join()
        return c.metrics["expansion"]

    assert expansion(TwoPhaseSys(rm_count=2)) == "sparse"
    assert expansion(NClientRegSys(n_clients=2)) == "sparse"
    assert expansion(TwoPhaseSys(rm_count=2), sparse=False) == "dense"
    assert expansion(Increment(2)) == "dense"
    with pytest.raises(ValueError, match="enabled_bits_cols"):
        Increment(2).checker().spawn_sortmerge(device="cpu", sparse=True)


def test_dense_count_bound_overflow_raises():
    """The compiled dense step's count-bound ``trunc`` fails the run
    loudly, naming what it discovered before (the sparse wave's
    contract, tests/test_torch_compile.py)."""
    from stateright_tpu_torch.actor import Actor, ActorModel, Network
    from stateright_tpu_torch.actor.compile import compile_actor_model
    from stateright_tpu_torch.model import Expectation

    class Flooder(Actor):
        def on_start(self, id, out):
            out.send(id, "go")
            return 0

        def on_msg(self, id, state, src, msg, out):
            out.send(id, "go")
            out.send(id, "go")

    model = (
        ActorModel(cfg=None).actor(Flooder())
        .init_network(Network.new_unordered_nonduplicating())
        .property(Expectation.SOMETIMES, "go in flight",
                  lambda m, s: any(True for _ in
                                   s.network.iter_deliverable()))
        .property(Expectation.ALWAYS, "state stays 0",
                  lambda m, s: s.actor_states[0] == 0)
    )
    enc = compile_actor_model(model, properties={
        "go in flight": lambda ctx, xp: ctx.network_any(lambda e: True),
        "state stays 0": lambda ctx, xp: (
            ctx.actor_values(lambda i, s: s) == 0).all(dim=0),
    })
    c = model.checker().spawn_sortmerge(
        encoded=enc, capacity=1 << 9, sparse=False, device="cpu")
    with pytest.raises(RuntimeError, match="encoding-bound overflow") as e:
        c.join()
    assert "before truncation (valid counterexamples): ['go in flight']" \
        in str(e.value)


# -- 4. slow ----------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("name,unique", [("paxos-2c", 16668),
                                         ("2pc-actors-5", 8832)])
def test_dense_engine_matches_jax_slow(name, unique):
    (jm, j), (pm, p) = _build("jax", name), _build("torch", name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jr = jm.checker().spawn_tpu_sortmerge(
            encoded=j, sparse=False, merge_impl="xla", capacity=1 << 15,
            frontier_capacity=1 << 13, cand_capacity=1 << 17).join()
    pr = pm.checker().spawn_sortmerge(
        encoded=p, capacity=1 << 15, sparse=False, device="cpu").join()
    assert pr.unique_state_count() == unique
    _assert_same_run(pr, jr, pm)


@pytest.mark.slow
def test_dense_step_matches_jax_paxos_two_lane():
    """4 clients: prepares ride in their own lane (``two_lane``); seeded
    random walks from the host model."""
    (jm, j), (_, p) = _build("jax", "paxos-4c"), _build("torch", "paxos-4c")
    assert p.two_lane
    rng = np.random.default_rng(SEED)
    vecs = []
    for _ in range(40):
        state = jm.init_states()[0]
        for _ in range(int(rng.integers(1, 14))):
            steps = jm.next_steps(state)
            if not steps:
                break
            state = steps[int(rng.integers(len(steps)))][1]
            vecs.append(j.encode(state))
    _compare_step(j, p, np.stack(vecs))
