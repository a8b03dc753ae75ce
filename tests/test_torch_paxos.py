"""The PyTorch port's Paxos lane held against the JAX package, exactly.

* the host tables of the encoding at 1-5 clients (envelope universe,
  per-slot params, the send table, the guard-class words, the
  linearizability truth table, the lane layout);
* ``encode`` / ``init_vecs`` and the host fingerprint on the same host
  states, walked in both packages in lockstep;
* ``enabled_bits_cols`` / ``step_slot_cols`` / ``property_conditions_cols``
  against JAX ``jax.vmap`` of the ``*_vec`` functions on every state of
  the 1-client space, every state of the 2-client space (collected by
  the port engine), and host-BFS plus seeded random-walk states at 3, 4
  and 5 clients (``two_lane`` and the second client lane);
* the engine and the CLI report against JAX ``spawn_tpu_sortmerge`` and
  ``paxos check-tpu`` at 1 client, paths on and off, and a run
  continued from a JAX mid-depth carry; the pinned 16,668 at 2 clients
  with a replayed path and no poison bit set.
"""

import contextlib
import io
import re
from collections import deque

import numpy as np
import pytest
import torch

SEED = 20261017
#: host-BFS depth per client count for the device-function states
BFS_DEPTH = {1: None, 3: 6, 4: 5, 5: 5}


def _jax_enc(c):
    from stateright_tpu.models.paxos import PaxosModelCfg
    from stateright_tpu.models.paxos_tpu import PaxosEncoded

    return PaxosEncoded(PaxosModelCfg(client_count=c, server_count=3))


def _port_enc(c):
    from stateright_tpu_torch.models.paxos import PaxosModelCfg
    from stateright_tpu_torch.models.paxos_tpu import PaxosEncoded

    return PaxosEncoded(PaxosModelCfg(client_count=c, server_count=3))


@pytest.fixture(scope="module")
def encs():
    return {c: (_jax_enc(c), _port_enc(c)) for c in range(1, 6)}


def _bfs(model, max_depth):
    """Host states in BFS order, to ``max_depth`` (None: all)."""
    [init] = model.init_states()
    seen = {init: 0}
    order = [init]
    q = deque([init])
    while q:
        s = q.popleft()
        d = seen[s]
        if max_depth is not None and d >= max_depth:
            continue
        for n in model.next_states(s):
            if n not in seen:
                seen[n] = d + 1
                order.append(n)
                q.append(n)
    return order


def _walks(models, n_walks, max_len, seed):
    """Seeded random walks taken in lockstep through several host
    models of the same configuration: each step picks the same action
    index in every model. Returns one list of states per model."""
    rng = np.random.default_rng(seed)
    out = [[] for _ in models]
    for _ in range(n_walks):
        states = [m.init_states()[0] for m in models]
        for _ in range(int(rng.integers(1, max_len + 1))):
            steps = [m.next_steps(s) for m, s in zip(models, states)]
            if not steps[0]:
                break
            i = int(rng.integers(len(steps[0])))
            states = [st[i][1] for st in steps]
            for o, s in zip(out, states):
                o.append(s)
    return out


def _jax_device_fns(j, vecs, pair_vecs, slots):
    """JAX ``vmap`` of the three ``*_vec`` functions, in one program
    (one compile): ``(bits, successors, conditions)`` as numpy."""
    import jax
    import jax.numpy as jnp

    def run(v, pv, sl):
        return (jax.vmap(j.enabled_bits_vec)(v),
                jax.vmap(j.step_slot_vec)(pv, sl),
                jax.vmap(j.property_conditions_vec)(v))

    out = jax.jit(run)(jnp.asarray(vecs), jnp.asarray(pair_vecs),
                       jnp.asarray(slots.astype(np.uint32)))
    return tuple(np.asarray(o) for o in out)


def _t(vecs):
    """``[N, W]`` uint32 rows -> the port's ``[W, N]`` int64 block."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(vecs, np.uint32).astype(np.int64).T))


# -- 1. host tables --------------------------------------------------------


@pytest.mark.parametrize("clients", [1, 2, 3, 4, 5])
def test_host_tables_match_jax(encs, clients):
    j, p = encs[clients]
    for attr in ("width", "K", "max_actions", "two_lane", "n_client_lanes",
                 "n_state_lanes", "net_lanes", "NB", "P", "W_BALLOT",
                 "W_PROP", "W_ACC", "W_PREP", "B_PROP", "B_ACC", "B_DEC",
                 "B_ACCEPTS", "B_PREP", "CST", "CPL", "TB", "TBV",
                 "ballots", "choosable", "la_universe"):
        assert getattr(p, attr) == getattr(j, attr), attr
    assert [p._env_key(e) for e in p.universe] == \
        [j._env_key(e) for e in j.universe]
    assert p.index == j.index
    js, ps = j._sparse_tables(), p._sparse_tables()
    assert ps["SEL"] == js["SEL"]
    for name in ("params", "sendtab"):
        assert ps[name].dtype == js[name].dtype
        assert np.array_equal(ps[name], js[name]), name
    assert p._bits_word_tables() == j._bits_word_tables()
    assert np.array_equal(p._lin_table, j._lin_table)
    assert p._lin_table.size == p.TB ** clients
    want = {1: (5, 14), 2: (7, 72), 3: (13, 284), 4: (19, 380),
            5: (23, 462)}[clients]
    assert (p.width, p.K) == want
    assert p.two_lane == (clients >= 4)
    assert p.n_client_lanes == (2 if clients == 5 else 1)


# -- 2. encode / init_vecs ------------------------------------------------


def _assert_same_encoding(j, p, j_states, p_states):
    from stateright_tpu.fingerprint import fingerprint as j_fp
    from stateright_tpu_torch.fingerprint import fingerprint as p_fp

    assert len(j_states) == len(p_states) > 0
    for js, ps in zip(j_states, p_states):
        assert np.array_equal(p.encode(ps), j.encode(js))
        assert p_fp(ps) == j_fp(js)


@pytest.mark.parametrize("clients", [1, 2, 3, 4, 5])
def test_encode_matches_jax(encs, clients):
    """``init_vecs`` equal; ``encode`` and the host fingerprint equal on
    the same host states: the whole 1-client space in BFS order, and
    seeded random walks at 2-5 clients (deep states too: decided
    servers, reads in flight and done)."""
    j, p = encs[clients]
    assert np.array_equal(p.init_vecs(), j.init_vecs())
    if clients == 1:
        js = _bfs(j.host_model, None)
        ps = _bfs(p.host_model, None)
        assert len(ps) == 265
    else:
        js, ps = _walks([j.host_model, p.host_model], n_walks=10,
                        max_len=30, seed=SEED + clients)
    _assert_same_encoding(j, p, js, ps)


# -- 3. device functions ----------------------------------------------------


def _port_engine_states(clients):
    """Every state the port engine visits, collected from the frontier
    its wave loop hands ``enabled_bits_cols`` (the frontiers of a run
    partition its visited set)."""
    from stateright_tpu_torch.models.paxos_tpu import (
        STRUCTURAL_SIZES,
        PaxosEncoded,
    )

    frontiers = []

    class Recording(PaxosEncoded):
        def enabled_bits_cols(self, states_t):
            frontiers.append(states_t.T.numpy().astype(np.uint32))
            return super().enabled_bits_cols(states_t)

    enc = _port_enc(clients)
    rec = Recording(enc.cfg)
    c = enc.host_model.checker().spawn_sortmerge(
        encoded=rec, track_paths=False, device="cpu",
        **STRUCTURAL_SIZES[clients],
    ).join()
    vecs = np.concatenate(frontiers)
    assert len(vecs) == c.unique_state_count()
    return vecs


def _device_states(j, clients):
    """Encoded states (``[N, W]`` uint32) for the device differential."""
    if clients == 2:
        return _port_engine_states(2)
    vecs = [j.encode(s) for s in _bfs(j.host_model, BFS_DEPTH[clients])]
    if clients >= 3:
        [walked] = _walks([j.host_model], n_walks=10, max_len=40,
                          seed=SEED + 10 * clients)
        vecs += [j.encode(s) for s in walked]
    return np.unique(np.stack(vecs), axis=0)


@pytest.mark.parametrize("clients", [1, 2, 3, 4, 5])
def test_device_functions_match_jax(encs, clients):
    from stateright_tpu_torch.ops.bitmask import words_to_mask

    j, p = encs[clients]
    vecs = _device_states(j, clients)
    n = len(vecs)
    assert n >= {1: 265, 2: 16668, 3: 773, 4: 477, 5: 772}[clients]
    block = _t(vecs)

    bits = p.enabled_bits_cols(block)
    assert bits.shape == (n, p.net_lanes) and bits.dtype == torch.int64
    # the pairs come from the port's words; the JAX words must equal them
    rows, slots = words_to_mask(bits, p.K).nonzero(as_tuple=True)
    assert rows.numel() > n  # every state has an enabled slot or more
    succ, trunc, hard = p.step_slot_cols(block[:, rows], slots)
    assert trunc is None and hard is None
    assert succ.shape == (p.width, rows.numel())
    assert int(succ.min()) >= 0 and int(succ.max()) < 1 << 32
    cond = p.property_conditions_cols(block)
    assert cond.shape == (n, 2) and cond.dtype == torch.bool

    j_bits, j_succ, j_cond = _jax_device_fns(
        j, vecs, vecs[rows.numpy()], slots.numpy())
    assert np.array_equal(bits.numpy(), j_bits)
    assert np.array_equal(succ.T.numpy(), j_succ)
    assert np.array_equal(cond.numpy(), j_cond)
    assert bool(cond[:, 0].all())  # no reachable state is a counterexample
    if clients >= 4:
        assert p.two_lane


def test_poison_bit_clear_on_every_reached_state():
    """The poison bit (bit 30 of client lane 0) marks states the proof
    says are unreachable; a wrong port would set it silently and show
    only as a count that differs."""
    from stateright_tpu_torch.models.paxos_tpu import _B_POISON

    for clients in (1, 2):
        p = _port_enc(clients)
        vecs = _port_engine_states(clients)
        assert len(vecs) == {1: 265, 2: 16668}[clients]
        lane = vecs[:, p._clane_index(0)].astype(np.int64)
        assert not ((lane >> _B_POISON) & 1).any()


def test_uint32_wrap_is_masked():
    """The int64 lanes reproduce uint32 wraparound where the JAX code
    relies on it: a Put's prepares field is written at a shift past bit
    31 only for a client src, and must drop the high bits; and a
    subtraction below zero writes the same low bits."""
    from stateright_tpu_torch.models.paxos_tpu import _fset, _M32

    lane = torch.tensor([0xFFFFFFFF, 0x12345678, 0], dtype=torch.int64)
    shift = torch.tensor([30, 35, 28], dtype=torch.int64)
    out = _fset(lane, shift, 5, torch.tensor([31, 7, -1]))
    assert out.tolist() == [
        0x3FFFFFFF | (31 << 30) & _M32,  # bits past 31 dropped
        0x12345678,                      # shift >= 32: no field
        (31 << 28) & _M32,               # -1 writes all-ones low bits
    ]


# -- 4. engine --------------------------------------------------------------


def _jax_checker(clients, **kw):
    from stateright_tpu.models.paxos import PaxosModelCfg, paxos_model
    from stateright_tpu.models.paxos_tpu import STRUCTURAL_SIZES

    return paxos_model(PaxosModelCfg(client_count=clients)).checker() \
        .spawn_tpu_sortmerge(cand_capacity="auto",
                             **STRUCTURAL_SIZES[clients], **kw)


def _port_checker(clients, **kw):
    from stateright_tpu_torch.models.paxos import PaxosModelCfg, paxos_model
    from stateright_tpu_torch.models.paxos_tpu import STRUCTURAL_SIZES

    kw.setdefault("device", "cpu")
    return paxos_model(PaxosModelCfg(client_count=clients)).checker() \
        .spawn_sortmerge(**STRUCTURAL_SIZES[clients], **kw)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine at 1 client: the CLI lane's configuration (paths
    on; its compiled programs serve the CLI test too), and paths off
    in chunks of 4 waves (its programs serve the carry test)."""
    return {
        "on": _jax_checker(1, track_paths=True).join(),
        "off": _jax_checker(1, track_paths=False, waves_per_sync=4).join(),
    }


def test_engine_matches_jax_1client(jax_runs):
    j = jax_runs["on"]
    p = _port_checker(1).join()
    assert p.unique_state_count() == j.unique_state_count() == 265
    assert p.state_count() == j.state_count() == 482
    assert p.max_depth() == j.max_depth() == 14
    assert p.discovered_property_names() == j.discovered_property_names() \
        == {"value chosen"}
    assert p.discovery_fingerprints() == j.discovery_fingerprints()
    jd, pd = j.discoveries(), p.discoveries()
    assert set(jd) == set(pd)
    for name in jd:
        assert pd[name].encode() == jd[name].encode(), name
        assert pd[name].fingerprints() == jd[name].fingerprints(), name
    p.assert_properties()


def _replays(model, path, prop) -> bool:
    from stateright_tpu_torch.path import Path

    replayed = Path.from_fingerprints(model, path.fingerprints())
    return (replayed.fingerprints() == path.fingerprints()
            and prop.condition(model, replayed.last_state()))


def test_engine_2clients_pin():
    """The reference-pinned 16,668 (examples/paxos.rs:325, 349) on the
    port engine, with the "value chosen" path replayed through the
    port's host model and no counterexample to "linearizable"."""
    p = _port_checker(2).join()
    assert p.unique_state_count() == 16668
    assert (p.state_count(), p.max_depth()) == (32971, 21)
    assert p.discovered_property_names() == {"value chosen"}
    path = p.discovery("value chosen")
    model = p.model
    assert _replays(model, path, model.property_by_name("value chosen"))
    p.assert_properties()
    off = _port_checker(2, track_paths=False).join()
    assert off.discovery_fingerprints() == p.discovery_fingerprints()
    assert off.unique_state_count() == 16668


@pytest.mark.slow
def test_engine_3clients_pin():
    """`paxos check-gpu 3` on the port's CPU engine: 1,194,428."""
    p = _port_checker(3, track_paths=False).join()
    assert p.unique_state_count() == 1194428
    assert p.discovered_property_names() == {"value chosen"}


def test_gpu_lane_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port_checker(1, device="cuda").join()


# -- 5. CLI -----------------------------------------------------------------


def _mask_sec(text):
    return re.sub(r"sec=[0-9.]+", "sec=X", text)


def test_cli_report_matches_jax_lane(jax_runs):
    """Both lanes in ONE process (frozenset reprs iterate alike); the
    header line names the engine and differs by design."""
    from stateright_tpu.cli import main as jax_main
    from stateright_tpu_torch.cli import main as port_main

    out_j, out_p = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out_j):
        jax_main(["paxos", "check-tpu", "1"])
    with contextlib.redirect_stdout(out_p):
        port_main(["paxos", "check-gpu", "1", "--device", "cpu"])
    j_lines = _mask_sec(out_j.getvalue()).splitlines()
    p_lines = _mask_sec(out_p.getvalue()).splitlines()
    assert p_lines[0] == (
        "Model checking Single Decree Paxos with 1 clients on the CPU "
        "wave engine."
    )
    assert p_lines[1] == "Done. states=482, unique=265, depth=14, sec=X"
    assert p_lines[1:] == j_lines[1:]
    assert len(p_lines) > 10


def test_cli_refuses_client_counts_outside_1_to_5():
    from stateright_tpu_torch.cli import main as port_main

    with pytest.raises(SystemExit, match="1-5 clients"):
        port_main(["paxos", "check-gpu", "6", "--device", "cpu"])


def test_paths_off_report_matches_jax(jax_runs):
    from stateright_tpu.report import WriteReporter as JaxReporter
    from stateright_tpu_torch.report import WriteReporter

    out_j, out_p = io.StringIO(), io.StringIO()
    jax_runs["off"].report(JaxReporter(out_j))
    _port_checker(1, track_paths=False).report(WriteReporter(out_p))
    text = _mask_sec(out_p.getvalue())
    assert text == _mask_sec(out_j.getvalue())
    assert "(fingerprint only;" in text


# -- 6. carry ---------------------------------------------------------------


def test_continue_from_jax_mid_depth_carry(jax_runs):
    """Seed the JAX engine, run one chunk (4 waves), carry its visited
    set and frontier across, and finish on the port: the same counts
    as the JAX run to completion."""
    import jax.numpy as jnp

    from stateright_tpu_torch.convert import carry_from_numpy

    j = _jax_checker(1, track_paths=False, waves_per_sync=4)
    init = np.asarray(j.encoded.init_vecs(), np.uint32)
    seed_fn, chunk_fn = j._lookup_programs(init.shape[0])
    carry, _ = chunk_fn(seed_fn(jnp.asarray(init)))
    c = {k: np.asarray(v) for k, v in carry.items()}
    assert not c["done"] and int(c["depth"]) == 5
    state = carry_from_numpy(
        c["vkeys"], c["frontier"], int(c["n_frontier"]), c["ebits"],
        depth=int(c["depth"]),
        generated=int(c["gen_lo"]) | (int(c["gen_hi"]) << 32),
    )
    p = _port_checker(1, track_paths=False).start_from(state).join()
    full = jax_runs["off"]
    assert p.unique_state_count() == full.unique_state_count() == 265
    assert p.state_count() == full.state_count()
    assert p.max_depth() == full.max_depth()
    assert p.discovery_fingerprints() == full.discovery_fingerprints()
