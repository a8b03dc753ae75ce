"""The port's device-resident chunk (checkers/chunk.py) on the CPU: up to
``waves_per_sync`` waves between two host syncs, on the sort-merge engine
(sparse and dense) and the hash engine.

* At N in {1, 2, 7, 64} the unique count, ``states=``, depth, discovery
  fingerprints and ``Path.encode()`` are identical, with paths on and
  off, on 2pc rm=3 and rm=4, and on the compiled 2pc-actors at one N.
* JAX ``spawn_tpu_sortmerge(waves_per_sync=4)`` on 2pc rm=3 gives the
  port's counts at N = 4, the same wave-log rows, and JAX's
  ``diff_traces`` finds no divergence between the two traces.
* A run from the smallest classes grows them and gives the N = 1
  counts; crossing a configured capacity raises the one-wave loop's
  message.
* ``target_state_count`` and ``target_max_depth`` stop at the same wave
  at every N.
* An untraced run makes at most ceil(waves / N) + resizes + 1 blocking
  host reads, and a traced one the same; besides, the host waits on
  each wave's polled scalars, once a wave run (``host_waits``); the
  deep level forces one wave a sync with JAX's ``deep_sync_override``.
* The kernels' device-count forms (their plain versions here) equal
  the host-count ones with garbage past the counts, at counts 0 and
  full.
* A chunked wave makes no host sync (so it can be captured as a CUDA
  graph on the card): no aten op that reads a device value back runs
  in it outside the plain kernels' own count reads.
"""

import math

import numpy as np
import pytest
import torch

from stateright_tpu_torch import telemetry as pt
from stateright_tpu_torch.checkers import chunk
from stateright_tpu_torch.checkers.tpu import READS
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.ops import hashset, merge

NS = (1, 2, 7, 64)
WAVE_KEYS = ("frontier_rows", "enabled_pairs", "candidates", "new_states",
             "unique_total", "depth")


def _spawn(rm: int, engine: str, n: int, **kw):
    b = TwoPhaseSys(rm_count=rm).checker()
    if engine == "hash":
        return b.spawn_hash(capacity=1 << 13, device="cpu",
                            waves_per_sync=n, **kw)
    return b.spawn_sortmerge(capacity=1 << 13, device="cpu",
                             waves_per_sync=n,
                             sparse=None if engine == "sparse" else False,
                             **kw)


def _result(c, paths: bool):
    c.join()
    out = (c.unique_state_count(), c.state_count(), c.max_depth(),
           sorted(c.discovery_fingerprints().items()))
    if paths:
        out += (sorted((k, v.encode()) for k, v in c.discoveries().items()),)
    return out


@pytest.mark.parametrize("rm,unique", [(3, 288), (4, 1568)])
@pytest.mark.parametrize("engine", ["sparse", "dense", "hash"])
def test_results_do_not_depend_on_n(rm, unique, engine):
    for paths in (True, False):
        got = {n: _result(_spawn(rm, engine, n, track_paths=paths), paths)
               for n in NS}
        assert got[1][0] == unique
        assert all(v == got[1] for v in got.values()), (engine, paths)
        assert got[1][3], "2pc discovers its SOMETIMES properties"


def test_compiled_2pc_actors_chunked():
    from stateright_tpu_torch.models.two_phase_commit_actors import (
        two_phase_sys_actor_model,
        two_phase_sys_compiled_encoded,
    )

    enc = two_phase_sys_compiled_encoded(3)

    def run(n):
        c = two_phase_sys_actor_model(3).checker().spawn_sortmerge(
            encoded=enc, capacity=1 << 12, device="cpu", waves_per_sync=n)
        return _result(c, True)

    one, many = run(1), run(64)
    assert one == many
    assert one[:3] == (288, 810, 11)


def _traced(spawn, tel):
    tr = tel.RunTracer()
    with tr.activate():
        c = spawn().join()
    tel.validate_events(tr.events)
    return tr.events, c


def _waves(evs):
    return [{k: e[k] for k in ("wave",) + WAVE_KEYS}
            for e in evs if e["ev"] == "wave"]


def test_jax_chunk_of_four_equals_the_port():
    from stateright_tpu import telemetry as jt
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as J

    je, j = _traced(lambda: J(rm_count=3).checker().spawn_tpu_sortmerge(
        capacity=1 << 11, frontier_capacity=1 << 9, cand_capacity=1 << 11,
        waves_per_sync=4, merge_impl="xla"), jt)
    pe, p = _traced(lambda: TwoPhaseSys(rm_count=3).checker()
                    .spawn_sortmerge(capacity=1 << 11, device="cpu",
                                     waves_per_sync=4), pt)
    assert (p.unique_state_count(), p.state_count(), p.max_depth()) == (
        j.unique_state_count(), j.state_count(), j.max_depth()) == (
        288, 1146, 11)
    assert p.discovery_fingerprints() == j.discovery_fingerprints()
    assert _waves(pe) == _waves(je)
    rep = jt.diff_traces(je, pe)
    assert rep["divergences"] == [], rep["divergences"][:5]
    # the port's chunks hold up to four waves, as JAX's
    sizes = [e["waves"] for e in pe if e["ev"] == "chunk"]
    assert max(sizes) <= 4 and sum(sizes) == p.metrics["waves"]


def test_smallest_classes_grow_and_capacity_still_raises():
    one = _result(_spawn(4, "sparse", 1), True)
    c = _spawn(4, "sparse", 64)
    assert _result(c, True) == one
    m = c.metrics
    assert m["resizes"] >= 1 and len(m["classes"]) >= 2
    assert m["classes"][0][0] == chunk.FLOOR_F
    plan = c.memory_plan
    assert [[k["frontier_rows"], k["pair_rows"], k["visited_rows"]]
            for k in plan["classes"]] == m["classes"]
    assert all(k["staging_bytes"] > 0 for k in plan["classes"])
    for engine in ("sparse", "hash"):
        msgs = []
        for n in (1, 64):
            b = TwoPhaseSys(rm_count=4).checker()
            spawn = b.spawn_hash if engine == "hash" else b.spawn_sortmerge
            kw = (dict(capacity=1 << 12, frontier_capacity=64)
                  if engine == "hash" else dict(capacity=1000))
            with pytest.raises(RuntimeError) as ei:
                spawn(device="cpu", waves_per_sync=n, **kw).join()
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]
        assert "overflow" in msgs[0]


@pytest.mark.parametrize("engine", ["sparse", "hash"])
def test_targets_stop_at_the_same_wave(engine):
    for target in (dict(target_state_count=500),
                   dict(target_max_depth=6)):
        got = []
        for n in NS:
            b = TwoPhaseSys(rm_count=4).checker()
            b = (b.target_state_count(target["target_state_count"])
                 if "target_state_count" in target
                 else b.target_max_depth(target["target_max_depth"]))
            spawn = b.spawn_hash if engine == "hash" else b.spawn_sortmerge
            c = spawn(capacity=1 << 13, device="cpu", waves_per_sync=n)
            got.append(_result(c, True) + (c.metrics["waves"],))
        assert all(g == got[0] for g in got), (target, got)
        assert got[0][0] < 1568


@pytest.mark.parametrize("engine", ["sparse", "dense", "hash"])
def test_host_reads_one_a_chunk(engine):
    for n in (4, 64):
        r0 = READS.calls
        c = _spawn(4, engine, n)
        c.join()
        reads = READS.calls - r0
        m = c.metrics
        # the hash engine's seed insert reads its overflow flag once
        assert reads <= math.ceil(m["waves"] / n) + m["resizes"] + 1, (
            n, reads, m)
        assert m["chunks"] == reads - (1 if engine == "hash" else 0)
        # the host still waits once a wave run, on its polled scalars: a
        # committed wave, or one that grew its classes and ran again
        assert m["waves"] <= m["host_waits"] <= m["waves"] + m["resizes"], (
            n, m)
        assert m["host_waits"] == m["eager_waves"] + m["graph_replays"]


@pytest.mark.parametrize("engine", ["sparse", "hash"])
def test_traced_chunks_read_as_untraced(engine):
    """A traced run at N = 64 makes the reads of an untraced one (the
    wave log rides the chunk's one read), with equal counts and metrics
    (but the poll's wall); the deep level forces one wave a sync, with
    JAX's ``deep_sync_override`` event."""
    r0 = READS.calls
    c0 = _spawn(4, engine, 64).join()
    untraced = READS.calls - r0
    r0 = READS.calls
    evs, c1 = _traced(lambda: _spawn(4, engine, 64), pt)
    assert READS.calls - r0 == untraced
    assert _result(c0, True) == _result(c1, True)
    drop = ("poll_sec",)
    assert ({k: v for k, v in c0.metrics.items() if k not in drop}
            == {k: v for k, v in c1.metrics.items() if k not in drop})
    chunks = [e for e in evs if e["ev"] == "chunk"]
    assert len(chunks) == c1.metrics["chunks"]
    assert sum(e["waves"] for e in chunks) == c1.metrics["waves"]
    tr = pt.RunTracer(level="deep")
    with tr.activate():
        c2 = _spawn(4, engine, 64).join()
    over = [e for e in tr.events if e["ev"] == "deep_sync_override"]
    assert len(over) == 1 and over[0]["waves_per_sync"] == 1
    assert over[0]["waves_per_sync_old"] == 64
    assert c2.metrics["waves_per_sync"] == 1
    assert _result(c2, True) == _result(c0, True)


def _garbage(n, gen):
    return torch.from_numpy(gen.integers(-(1 << 62), 1 << 62, n,
                                         dtype=np.int64))


@pytest.mark.parametrize("na,nb", [(0, 0), (0, 37), (50, 0), (33, 21),
                                   (64, 40)])
def test_device_count_entries_equal_host_count(na, nb):
    gen = np.random.default_rng(na * 100 + nb)
    a, b = _garbage(64, gen), _garbage(40, gen)
    a[:na] = torch.sort(a[:na]).values
    b[:nb] = torch.sort(torch.cat([a[:na][::3], b])[:nb]).values
    ta, tb = torch.tensor(na), torch.tensor(nb)
    hit = merge.member_keys_dev(a, ta, b, tb)
    assert torch.equal(hit[:nb], merge.member_keys(a[:na], b[:nb]))
    out = _garbage(104, gen)
    merge.merge_keys_dev(a, ta, b, tb, out)
    assert torch.equal(out[:na + nb], merge.merge_keys(a[:na], b[:nb]))
    # the insert: the first nb keys where active, the rest untouched
    keys = torch.cat([b[:nb], b[:nb // 2], _garbage(10, gen)])
    n = torch.tensor(nb + nb // 2)
    active = torch.ones(keys.numel(), dtype=torch.bool)
    active[::5] = False
    t1 = hashset.DeviceHashSet.empty(1 << 8)
    t2 = hashset.DeviceHashSet.empty(1 << 8)
    got = hashset.insert_dev(t1, keys, active, n, torch.tensor(0))
    k = int(n)
    _, *want = hashset.insert(t2, keys[:k], active[:k])
    for g, w in zip(got, want):
        assert torch.equal(g[:k], w)
    assert torch.equal(t1.keys, t2.keys)


def test_rank_compact_is_order_preserving():
    mask = torch.tensor([0, 1, 1, 0, 1, 0, 1], dtype=torch.bool)
    lanes = torch.arange(14).view(2, 7)
    out = merge.rank_compact(mask, 3, lanes, [-1, -2])
    assert out.tolist() == [[1, 2, 4], [8, 9, 11]]
    out = merge.rank_compact(mask, 6, lanes, [-1, -2])
    assert out.tolist() == [[1, 2, 4, 6, -1, -1], [8, 9, 11, 13, -2, -2]]


#: aten ops that read a device value back to the host, or (``lift_fresh``:
#: a tensor made from host data) copy one to it
_SYNCING = ("nonzero", "_local_scalar_dense", "item", "is_nonzero",
            "masked_select", "unique", "equal", "lift_fresh",
            "lift_fresh_copy")


def _compiled_2pc(n):
    from stateright_tpu_torch.models.two_phase_commit_actors import (
        two_phase_sys_actor_model,
        two_phase_sys_compiled_encoded,
    )

    return two_phase_sys_actor_model(3).checker().spawn_sortmerge(
        encoded=two_phase_sys_compiled_encoded(3), capacity=1 << 12,
        device="cpu", waves_per_sync=n)


def _paxos_1c(n):
    from stateright_tpu_torch.models.paxos import PaxosModelCfg, paxos_model
    from stateright_tpu_torch.models.paxos_tpu import STRUCTURAL_SIZES

    return paxos_model(PaxosModelCfg(client_count=1, server_count=3)) \
        .checker().spawn_sortmerge(**STRUCTURAL_SIZES[1], device="cpu",
                                   waves_per_sync=n)


def _symmetric_2pc(n):
    return TwoPhaseSys(rm_count=4).checker().symmetry().spawn_sortmerge(
        capacity=1 << 13, device="cpu", waves_per_sync=n)


def _pinger(n):
    from stateright_tpu_torch.models.timers import (
        PingerModelCfg,
        pinger_compiled,
    )

    model, enc = pinger_compiled(PingerModelCfg(3), 8)
    return model.checker().target_max_depth(8).spawn_sortmerge(
        encoded=enc, capacity=1 << 14, device="cpu", waves_per_sync=n)


#: each case: a spawn at N waves a sync, and its unique count
_NO_SYNC_CASES = {
    "sparse": (lambda n: _spawn(4, "sparse", n), 1568),
    "dense": (lambda n: _spawn(4, "dense", n), 1568),
    "hash": (lambda n: _spawn(4, "hash", n), 1568),
    "compiled 2pc-actors": (_compiled_2pc, 288),
    "paxos 1c": (_paxos_1c, 265),
    "2pc --symmetry": (_symmetric_2pc, None),
    "compiled pinger": (_pinger, None),
}


@pytest.mark.parametrize("engine", sorted(_NO_SYNC_CASES))
def test_chunked_wave_makes_no_host_sync(engine, monkeypatch):
    from torch.utils._python_dispatch import TorchDispatchMode

    from stateright_tpu_torch.checkers import tpu, tpu_sortmerge

    seen, inside = [], [0]

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if not inside[0]:
                if name in _SYNCING:
                    seen.append(name)
                if name == "index" and any(
                        isinstance(i, torch.Tensor) and i.dtype == torch.bool
                        for i in (args[1] if len(args) > 1 else [])
                        if i is not None):
                    seen.append("index(bool)")
            return func(*args, **(kwargs or {}))

    def plain(fn):
        # the plain kernels read their counts on the host; the CUDA
        # kernels read them on the device
        def run(*a, **kw):
            inside[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                inside[0] -= 1
        return run

    for mod, name in ((tpu_sortmerge, "member_keys_dev"),
                      (tpu_sortmerge, "merge_keys_dev"),
                      (tpu, "insert_dev")):
        monkeypatch.setattr(mod, name, plain(getattr(mod, name)))
    cls, name = ((tpu.TpuBfsChecker, "_hash_wave") if engine == "hash"
                 else (tpu_sortmerge.SortMergeTpuBfsChecker, "_sm_wave"))
    real = getattr(cls, name)
    ran = []

    def watched(self, *a, **kw):
        # the first wave of a class runs once eagerly on the card before
        # its capture: what it builds once (a cached constant) is its own
        first = (self, a[0].key) not in ran
        ran.append((self, a[0].key))
        if first:
            return real(self, *a, **kw)
        with Watch():
            return real(self, *a, **kw)

    monkeypatch.setattr(cls, name, watched)
    make, want = _NO_SYNC_CASES[engine]
    one = _result(make(1), False)
    got = _result(make(64), False)
    assert got == one and (want is None or got[0] == want)
    assert any(ran.count(x) > 1 for x in ran), "no wave replayed a class"
    assert seen == []


@pytest.mark.parametrize("engine", ["sparse", "hash"])
def test_resumed_chunked_run_keeps_the_classes(tmp_path, engine):
    """A chunked run killed after a snapshot and resumed goes on in the
    classes it was in and makes the same class changes: its classes and
    its memory plan's equal an unkilled run's (so a trace diff of the
    two finds no memory-plan divergence), with the same result."""
    from stateright_tpu_torch import faultinject

    base = _spawn(4, engine, 2)
    want = _result(base, True)
    snap = str(tmp_path / "c.ckpt")
    killed = _spawn(4, engine, 2, checkpoint_every=1, checkpoint_path=snap)
    killed.max_fault_retries = 0
    faultinject.arm("raise", "chunk_boundary", 2)
    try:
        with pytest.raises(faultinject.InjectedFault):
            killed.join()
    finally:
        faultinject.disarm_all()
    resumed = _spawn(4, engine, 2)
    assert resumed.resume_from(snap)["wave"] == 6
    assert _result(resumed, True) == want
    assert resumed.metrics["classes"] == base.metrics["classes"]
    assert resumed.memory_plan["classes"] == base.memory_plan["classes"]
