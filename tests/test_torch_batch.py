"""The PyTorch port's wave batching (batch.py), on the CPU, held against
the JAX package's ``batch`` module: the fused encoding's host half and
its ``step_cols`` / ``property_conditions_cols`` against JAX's vmapped
``step_vec`` / ``property_conditions_vec`` on reachable fused states
(2pc rm=3+4, paxos 2c/3s + 2pc rm=3); ``batch_eligible``'s reasons and
class keys; ``FusedWaveChecker([2pc rm=3, rm=4])`` against JAX's at
``waves_per_sync=1`` (per-lane unique, depth and generated counts,
every wave's lane rows, fused discovery fingerprints); a fused wave's
host reads equal to a solo hash wave's; and ``BatchGroup`` on threads,
as JAX ``tests/test_serve.py`` drives it through its service
(:481 pinned counts with no cross-session bleed, :541 no ``diff_traces``
divergence from JAX and port solo traces and the JAX seat's paths, :574
the early peel, :603 the incompatible fallback, :626 a fused admission
refusal priced through ``memplan.fused_session_bytes``)."""

import threading

import numpy as np
import pytest

pytestmark = pytest.mark.serve


def _port_2pc(n):
    from stateright_tpu_torch.cli import twopc_sizes
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    return TwoPhaseSys(rm_count=n).checker().spawn_sortmerge(
        device="cpu", **twopc_sizes(n))


def _jax_2pc(n):
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.cli import twopc_sizes

    sizes = twopc_sizes(n)
    return TwoPhaseSys(rm_count=n).checker().spawn_tpu_sortmerge(
        capacity=sizes["capacity"],
        frontier_capacity=sizes["frontier_capacity"], cand_capacity="auto")


def _port_paxos2():
    from stateright_tpu_torch.cli import paxos_checker

    return paxos_checker(2, "cpu")


def _models(pkg, lanes):
    """The member models of ``lanes`` in package ``pkg``."""
    out = []
    for lane in lanes:
        if lane.startswith("2pc"):
            mod = __import__(f"{pkg}.models.two_phase_commit",
                             fromlist=["TwoPhaseSys"])
            out.append(mod.TwoPhaseSys(rm_count=int(lane[-1])))
        else:
            mod = __import__(f"{pkg}.models.paxos",
                             fromlist=["paxos_model"])
            out.append(mod.paxos_model(mod.PaxosModelCfg(2, 3)))
    return out


def _fused_encodings(lanes):
    import stateright_tpu.batch as jb
    import stateright_tpu_torch.batch as pb

    out = []
    for pkg, b in (("stateright_tpu", jb), ("stateright_tpu_torch", pb)):
        models = _models(pkg, lanes)
        fm = b.FusedModel(models)
        out.append(b.FusedEncodedModel([m.to_encoded() for m in models], fm))
    return out


def _reachable(fm, limit=400):
    """Up to ``limit`` reachable fused states, breadth first from every
    member's init states, in sid order."""
    seen, order, frontier = set(), [], list(fm.init_states())
    while frontier and len(order) < limit:
        nxt = []
        for st in frontier:
            if st in seen:
                continue
            seen.add(st)
            order.append(st)
            nxt += [t for a in fm.actions(st)
                    if (t := fm.next_state(st, a)) is not None]
        frontier = nxt
    return sorted(order[:limit], key=lambda st: st[0])


@pytest.mark.parametrize("lanes", [("2pc rm=3", "2pc rm=4"),
                                   ("paxos 2c/3s", "2pc rm=3")])
def test_fused_encoding_matches_jax(lanes):
    import jax
    import jax.numpy as jnp
    import torch

    jenc, penc = _fused_encodings(lanes)
    assert (penc.width, penc.max_actions) == (jenc.width, jenc.max_actions)
    assert np.array_equal(penc.init_vecs(), jenc.init_vecs())
    assert penc.cache_key() == jenc.cache_key()
    states = _reachable(penc.host_model)
    assert {st[0] for st in states} == {0, 1}
    rows = np.stack([penc.encode(st) for st in states])
    # the same walk of JAX's own host model encodes to the same rows
    assert np.array_equal(rows, np.stack(
        [jenc.encode(st) for st in _reachable(jenc.host_model)]))

    j_succ, j_valid, _ = jax.vmap(jenc.step_vec)(jnp.asarray(rows))
    j_succ, j_valid = np.asarray(j_succ), np.asarray(j_valid)
    j_cond = np.asarray(jax.vmap(jenc.property_conditions_vec)(
        jnp.asarray(rows)))
    block = torch.from_numpy(rows.astype(np.int64).T.copy())
    counts = np.bincount(rows[:, -1], minlength=2).tolist()
    succ, valid, _ = penc.step_cols(block, counts)
    valid = valid.numpy()
    assert np.array_equal(valid, j_valid)
    p_succ = succ.permute(1, 2, 0).numpy()  # [n, K, W] as JAX's
    assert np.array_equal(p_succ[valid], j_succ[valid].astype(np.int64))
    # the sid on every row, valid or not
    assert (p_succ[:, :, -1] == rows[:, -1:]).all()
    cond = penc.property_conditions_cols(block, counts).numpy()
    assert np.array_equal(cond, j_cond)
    with pytest.raises(ValueError, match="do not cover"):
        penc.step_cols(block, [counts[0], counts[1] - 1])


def test_batch_eligible_matches_jax():
    import stateright_tpu.batch as jb
    import stateright_tpu_torch.batch as pb
    from stateright_tpu.models.increment import Increment as j_inc
    from stateright_tpu_torch.models.increment import Increment as p_inc

    def cases(pkg, inc):
        tp = __import__(f"{pkg}.models.two_phase_commit",
                        fromlist=["TwoPhaseSys"]).TwoPhaseSys
        sm = ("spawn_tpu_sortmerge" if pkg == "stateright_tpu"
              else "spawn_sortmerge")
        kw = {} if pkg == "stateright_tpu" else {"device": "cpu"}

        def spawn(builder, **more):
            return getattr(builder, sm)(capacity=1 << 12, **kw, **more)

        return [
            spawn(tp(3).checker()),
            spawn(tp(9).checker()),
            spawn(inc(2).checker()),
            spawn(tp(3).checker(), track_paths=False),
            spawn(tp(3).checker().target_state_count(10)),
            spawn(tp(3).checker(), checkpoint_every=2),
            spawn(tp(3).checker().symmetry()),
            tp(3).checker().spawn_bfs(),
        ]

    got = [pb.batch_eligible(c) for c in cases("stateright_tpu_torch", p_inc)]
    want = [jb.batch_eligible(c) for c in cases("stateright_tpu", j_inc)]
    assert got == want
    assert got[0] == (("batch", 2, 32), None)
    assert got[1] == (("batch", 2, 64), None)
    assert [r for _, r in got[3:]] == [
        "untracked-path sessions cannot batch",
        "bounded-target sessions cannot batch",
        "checkpointing sessions cannot batch",
        "symmetry-reduced sessions cannot fuse (canonical keys are a "
        "different compatibility class)",
        "not a device wave engine"]
    twopc = _models("stateright_tpu_torch", ["2pc rm=3"])[0]
    mesh = twopc.checker().spawn_sharded_sortmerge(devices=["cpu"] * 2,
                                                   capacity=1 << 10)
    assert pb.batch_eligible(mesh) == (
        None, "sharded mesh sessions batch per-shard already")
    # a device simulation is no breadth-first search: the port refuses
    # it, where JAX's check takes it (ROADMAP §3)
    sim = dict(n_walks=64, max_steps=8, rounds=1, seed=0)
    assert pb.batch_eligible(twopc.checker().spawn_device_simulation(
        device="cpu", **sim)) == (None, "simulation sessions cannot batch")
    jax_twopc = _models("stateright_tpu", ["2pc rm=3"])[0]
    assert jb.batch_eligible(jax_twopc.checker().spawn_tpu_simulation(
        **sim))[1] is None


@pytest.fixture(scope="module")
def fused_pair():
    """(JAX, port) ``FusedWaveChecker`` over 2pc rm=3 and rm=4, joined;
    JAX's at one wave a sync."""
    from stateright_tpu.batch import FusedWaveChecker as JaxFused
    from stateright_tpu_torch.batch import FusedWaveChecker
    from stateright_tpu_torch.checkers.tpu import READS

    jax_run = JaxFused([_jax_2pc(3), _jax_2pc(4)], waves_per_sync=1)
    jax_run.unique_state_count()
    port = FusedWaveChecker([_port_2pc(3), _port_2pc(4)])
    calls = READS.calls
    port.join()
    return jax_run, port, READS.calls - calls


def test_fused_checker_matches_jax(fused_pair):
    jax_run, port, _ = fused_pair
    assert port.metrics["lane_unique"] == [288, 1568]
    assert port.metrics["lane_depth"] == [11, 14]
    assert port.metrics["lane_generated"] == [1146, 8258]
    final = jax_run._final_lanes
    assert port.metrics["lane_unique"] == final["unique"].tolist()
    assert port.metrics["lane_depth"] == final["depth"].tolist()
    assert port.metrics["lane_generated"] == final["gen"].tolist()
    assert (port.unique_state_count(), port.state_count(),
            port.max_depth()) == (jax_run.unique_state_count(),
                                  jax_run.state_count(), jax_run.max_depth())
    assert port.discovery_fingerprints() == jax_run.discovery_fingerprints()
    assert len(port.chunk_records) == len(jax_run.chunk_records)
    for p, j in zip(port.chunk_records, jax_run.chunk_records):
        assert np.array_equal(p["rows"], j["rows"][:j["n_waves"]]), \
            p["chunk_no"]
        for k in ("unique", "depth", "gen", "disc", "disc_lo", "disc_hi",
                  "done"):
            assert np.array_equal(np.asarray(p[k]), np.asarray(j[k])), k
    for name, path in port.discoveries().items():
        assert path.encode() == jax_run.discoveries()[name].encode(), name


def test_fused_paths_decode_when_asked():
    """The fused engine alone compacts no parent log at its end: its
    paths are walked in the live table when first asked for, one counted
    read a step, and replay to its discoveries."""
    from stateright_tpu_torch.batch import FusedWaveChecker
    from stateright_tpu_torch.checkers.tpu import READS

    fused = FusedWaveChecker([_port_2pc(3), _port_2pc(3)])
    fused.join()
    assert fused._plog is None and fused._discoveries == {}
    fps = fused.discovery_fingerprints()
    calls = READS.calls
    paths = fused.discoveries()
    steps = max(len(p.steps) for p in paths.values())
    assert 0 < READS.calls - calls <= steps
    assert set(paths) == set(fps)
    for name, path in paths.items():
        assert fused._vec_fp(fused.encoded.encode(path.last_state())) \
            == fps[name]
    assert fused.discoveries() == paths  # walked once


def test_find_matches_the_probe():
    """``find`` gives the slot ``insert`` put each key at, and -1 for
    absent keys, as ``contains`` says, in a table crowded enough for
    probes to run several rounds."""
    import torch

    from stateright_tpu_torch.ops.hashset import (
        DeviceHashSet,
        contains,
        find,
        insert,
    )

    gen = torch.Generator().manual_seed(7)
    keys = torch.randint(1, 1 << 62, (3000,), generator=gen)
    table = DeviceHashSet.empty(1 << 12, torch.device("cpu"))
    _, _, over, slot = insert(table, keys[:2000])
    assert not over.any()
    got = find(table, keys)
    assert torch.equal(got[:2000], slot)
    assert torch.equal(got >= 0, contains(table, keys))
    assert (got[2000:] == -1).all()


def test_fused_wave_reads_equal_a_solo_hash_wave(fused_pair):
    """One seed read, then each wave's discovery read and its flags read
    (the lane counts ride the latter), as a solo hash run."""
    from stateright_tpu_torch.checkers.tpu import READS
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    _, port, fused_calls = fused_pair
    solo = TwoPhaseSys(rm_count=4).checker().spawn_hash(
        capacity=1 << 14, device="cpu")
    calls = READS.calls
    solo.join()
    solo_calls = READS.calls - calls
    assert solo_calls == 1 + 2 * solo.metrics["waves"]
    assert fused_calls == 1 + 2 * port.metrics["waves"]


def _run_threads(checkers, tracers):
    def run(c, tr):
        with tr.activate_thread():
            c.join()

    threads = [threading.Thread(target=run, args=pair)
               for pair in zip(checkers, tracers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def _seated(checkers, **kw):
    from stateright_tpu_torch import telemetry
    from stateright_tpu_torch.batch import seat_sessions

    notes = []
    seats = seat_sessions(checkers, window_sec=kw.pop("window_sec", 30.0),
                          notify=notes.append, **kw)
    tracers = [telemetry.RunTracer() for _ in checkers]
    _run_threads(checkers, tracers)
    return seats, tracers, notes


def test_batched_sessions_pinned_counts_zero_bleed():
    """JAX test_serve.py:481: paxos 2c/3s x2 and 2pc rm=4 x2 fuse into
    two groups of two; every seat gives its solo count and its trace
    validates alone, naming only its own encoding."""
    from stateright_tpu_torch import telemetry

    checkers = [_port_paxos2(), _port_paxos2(), _port_2pc(4), _port_2pc(4)]
    seats, tracers, notes = _seated(checkers, max_sessions=2)
    assert notes == []
    pinned = [16668, 16668, 1568, 1568]
    assert [c.unique_state_count() for c in checkers] == pinned
    groups = [m.group for m, _ in seats]
    assert groups[0] is groups[1] and groups[2] is groups[3]
    assert groups[0] is not groups[2]
    for c, tr, want, enc in zip(checkers, tracers, pinned,
                                ["PaxosEncoded"] * 2
                                + ["TwoPhaseSysEncoded"] * 2):
        assert c.metrics["batch_size"] == 2
        telemetry.validate_events(tr.events)
        begins = [e for e in tr.events if e["ev"] == "run_begin"]
        assert len(begins) == 1 and begins[0]["lane"]["encoding"] == enc
        assert {e.get("run") for e in tr.events} == {0}
        waves = [e for e in tr.events if e["ev"] == "wave"]
        assert waves[-1]["unique_total"] == want
        marks = [e for e in tr.events if e["ev"] == "batch"]
        assert len(marks) == 1 and marks[0]["size"] == 2
    assert checkers[0].discovered_property_names() == {"value chosen"}


def _jax_seats(lanes):
    """JAX's ``BatchGroup`` over JAX checkers on threads, each seat under
    its own JAX tracer, as its service seats them."""
    from stateright_tpu import telemetry as jt
    from stateright_tpu.batch import BatchGroup, batch_eligible

    checkers = [_jax_2pc(n) for n in lanes]
    key, _ = batch_eligible(checkers[0])
    group = BatchGroup(0, key, max_sessions=len(checkers), window_sec=30.0)
    for c in checkers:
        m = group.try_join(c)
        c._run = (lambda reporter=None, m=m: group.member_run(m, reporter))
    tracers = [jt.RunTracer() for _ in checkers]
    _run_threads(checkers, tracers)
    return checkers, tracers


def test_batched_vs_solo_trace_diff_zero_divergence():
    """JAX test_serve.py:541: a batched 2pc rm=4 seat against a JAX solo
    trace and a port solo trace (the lane's sort-merge run): no counter,
    latency or memory divergence; its paths are the JAX seat's and the
    solo hash engine's, its fingerprints the solo run's."""
    from stateright_tpu import telemetry as jt
    from stateright_tpu_torch import telemetry as pt
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    checkers = [_port_2pc(4), _port_2pc(4)]
    _, tracers, _ = _seated(checkers, max_sessions=2)
    jax_solo, port_solo = jt.RunTracer(), pt.RunTracer()
    with jax_solo.activate():
        assert _jax_2pc(4).unique_state_count() == 1568
    solo = _port_2pc(4)
    with port_solo.activate():
        assert solo.unique_state_count() == 1568
    jax_seats, jax_tracers = _jax_seats([4, 4])
    hashed = TwoPhaseSys(rm_count=4).checker().spawn_hash(
        capacity=1 << 14, device="cpu").join()
    for c, tr, jc, jtr in zip(checkers, tracers, jax_seats, jax_tracers):
        assert c.unique_state_count() == 1568
        for other in (jax_solo.events, port_solo.events, jtr.events):
            rep = jt.diff_traces(tr.events, other)
            assert rep["divergences"] == []
            assert rep["latency"]["divergences"] == []
            assert rep["memory"]["divergences"] == []
        assert pt.diff_traces(tr.events, port_solo.events)["divergences"] \
            == []
        assert sorted(c.discoveries()) == sorted(solo.discoveries())
        assert c.discovery_fingerprints() == solo.discovery_fingerprints()
        for name, path in c.discoveries().items():
            assert path.encode() == jc.discoveries()[name].encode(), name
            assert path.encode() == hashed.discovery(name).encode(), name


def test_batch_early_settle_peels_out():
    """JAX test_serve.py:574: rm=3 (11 waves) fuses with rm=4 (14 waves);
    seat 0 leads, and the rm=3 seat peels first with fewer chunks."""
    big, small = _port_2pc(4), _port_2pc(3)
    seats, tracers, _ = _seated([big, small], max_sessions=2)
    assert (big.unique_state_count(), small.unique_state_count()) == (
        1568, 288)
    assert [m.index for m, _ in seats] == [0, 1]
    assert big.metrics["batch_size"] == small.metrics["batch_size"] == 2
    assert seats[0][0].group.settle_order == [1, 0]

    def chunks(tr):
        return [e for e in tr.events
                if e["ev"] == "latency_profile"][-1]["chunks"]

    assert chunks(tracers[1]) == 11 < chunks(tracers[0]) == 14
    # each seat's trace holds the leader's walk of its paths and its own
    # replay, as spans
    for k, tr in enumerate(tracers):
        spans = {e["phase"]: e for e in tr.events if e["ev"] == "span"}
        assert spans["batch_peel"]["seat"] == k
        assert spans["batch_replay"]["seat"] == k
        assert spans["batch_peel"]["dur"] >= 0
        assert spans["batch_replay"]["dur"] > 0


def test_batch_incompatible_shapes_fall_back_solo():
    """JAX test_serve.py:603: increment and 2pc land in different
    classes; each seat falls back to its solo run with JAX's one-line
    reason, counts unaffected, and no group fuses."""
    from stateright_tpu_torch.cli import increment_checker

    inc = increment_checker(2, False, "cpu")
    twopc = _port_2pc(3)
    seats, _, notes = _seated([inc, twopc], max_sessions=2, window_sec=0.5)
    assert twopc.unique_state_count() == 288
    assert inc.discovered_property_names() == {"fin"}
    assert seats[0][0].group is not seats[1][0].group
    assert notes == ["batch: no compatible peers arrived within the "
                     "batching window; running solo via the FIFO gate"] * 2
    assert all(m.group.fused is None for m, _ in seats)
    assert "batch_size" not in twopc.metrics


def test_batch_fused_admission_refusal():
    """JAX test_serve.py:626: an ``admit`` hook prices the fused plan
    through ``memplan.fused_session_bytes`` before any device work and
    refuses it over budget; both seats fall back with the reason. The
    price is JAX's rows at the port's 8-byte lanes."""
    from stateright_tpu import memplan as jm
    from stateright_tpu.batch import FusedWaveChecker as JaxFused
    from stateright_tpu_torch import memplan

    priced = []

    def admit(fused, members):
        plan = memplan.fused_session_bytes(fused, len(members))
        priced.append(plan)
        if plan["total_bytes"] > 1024:
            return (f"batch: fused plan of {len(members)} session(s) "
                    f"projects {plan['total_bytes']:,} resident bytes; "
                    "falling back to solo FIFO")
        return None

    checkers = [_port_2pc(3), _port_2pc(3)]
    _, _, notes = _seated(checkers, max_sessions=2, admit=admit)
    assert [c.unique_state_count() for c in checkers] == [288, 288]
    assert len(notes) == 2 and all(
        n.startswith("batch: fused plan of 2 session(s)")
        and n.endswith("falling back to solo FIFO") for n in notes)
    want = jm.fused_session_bytes(JaxFused([_jax_2pc(3), _jax_2pc(3)]), 2)
    got = priced[0]
    lane = memplan.LANE_BYTES // 4
    assert got["visited_bytes"] == want["visited_bytes"]
    assert got["frontier_bytes"] == lane * want["frontier_bytes"]
    assert got["cand_bytes"] == lane * want["cand_bytes"]
    assert got["n_sessions"] == want["n_sessions"] == 2
    assert got["per_session_bytes"] == got["total_bytes"] // 2
