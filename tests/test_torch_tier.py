"""The PyTorch port's tiered visited set (stateright_tpu_torch/tier.py and
the tiered sort-merge wave), on the CPU, held against the JAX package.

* The port's ``ColdStore`` against JAX's on the same ``(lo, hi)`` runs
  (numpy, from a seed): membership, compaction past ``max_runs``, the
  ``repartitioned(4)`` owners and order, the ``snapshot_runs`` /
  ``from_runs`` round trip, and ``convert.cold_store_from_runs`` of a
  JAX snapshot.
* The engine tiered against JAX ``spawn_tpu_sortmerge(...,
  waves_per_sync=1, merge_impl="xla")`` tiered, in every field: unique,
  ``states=``, depth, discovery fingerprints, ``Path.encode()``,
  ``tier_spills``, ``cold_rows`` and ``hot_rows`` — 2pc rm=3 sparse,
  dense and ``--symmetry`` at a 32-key hot tier, paxos 2c/3s at 1,024,
  and ``"auto"`` dormant and armed — and against the port's own
  resident run.
* The CLI's ``--tier-hot-rows``, a start state carrying cold runs, a
  tiered run past the resident capacity, and the cancel path joining
  the ingest worker.
* The sharded tier (parallel/engine_sortmerge.py, one cold-store shard
  a shard) against the port's own resident sharded run in every field
  and against the pinned host count, and its snapshots re-sharded. JAX's
  sharded tier is not the reference here:
  ``tests/test_tier.py::test_tier_mesh_and_reshard_with_cold_runs`` is a
  known failure under JAX 0.9.
"""

import contextlib
import io
import re
import threading

import numpy as np
import pytest

JAX_2PC = dict(capacity=1 << 10, frontier_capacity=128, cand_capacity=512)
JAX_PAXOS = dict(capacity=1 << 15, frontier_capacity=1 << 12,
                 cand_capacity=1 << 14)
#: the budget that fits exactly one 64-key class (JAX
#: test_tier_auto_ceiling_dormant)
AUTO_BUDGET = dict(tier_hot_rows="auto", tier_budget_bytes=2 * (64 + 128) * 8,
                   v_min=64)

#: case -> (model, tier arguments, other spawn arguments)
CASES = {
    "2pc3": ("2pc", dict(tier_hot_rows=32), {}),
    "2pc3-dense": ("2pc", dict(tier_hot_rows=32), dict(sparse=False)),
    "2pc3-symmetry": ("2pc-sym", dict(tier_hot_rows=32), {}),
    "paxos2c": ("paxos", dict(tier_hot_rows=1024), {}),
    "2pc3-auto-dormant": ("2pc", dict(tier_hot_rows="auto"), {}),
    "2pc3-auto-budget": ("2pc", AUTO_BUDGET, {}),
}
#: unique count and the fewest spills of each case
WANT = {"2pc3": (288, 2), "2pc3-dense": (288, 2), "2pc3-symmetry": (80, 2),
        "paxos2c": (16668, 2), "2pc3-auto-dormant": (288, 0),
        "2pc3-auto-budget": (288, 1)}


def _builder(pkg: str, model: str):
    if model == "paxos":
        mod = __import__(f"{pkg}.models.paxos", fromlist=["paxos_model"])
        return mod.paxos_model(mod.PaxosModelCfg(client_count=2,
                                                 server_count=3)).checker()
    mod = __import__(f"{pkg}.models.two_phase_commit",
                     fromlist=["TwoPhaseSys"])
    b = mod.TwoPhaseSys(rm_count=3).checker()
    return b.symmetry() if model == "2pc-sym" else b


def _jax_run(case: str):
    model, tier, extra = CASES[case]
    sizes = JAX_PAXOS if model == "paxos" else JAX_2PC
    return _builder("stateright_tpu", model).spawn_tpu_sortmerge(
        **sizes, waves_per_sync=1, merge_impl="xla", **tier, **extra).join()


def _port_run(case: str, tiered: bool = True, **kw):
    model, tier, extra = CASES[case]
    sizes = JAX_PAXOS if model == "paxos" else JAX_2PC
    sizes = {k: v for k, v in sizes.items() if k != "cand_capacity"}
    args = dict(sizes, device="cpu", **(tier if tiered else {}), **extra)
    return _builder("stateright_tpu_torch", model).spawn_sortmerge(
        **{**args, **kw}).join()


@pytest.fixture(scope="module")
def jax_runs():
    import warnings

    with warnings.catch_warnings():  # the JAX frontier-headroom warning
        warnings.simplefilter("ignore", RuntimeWarning)
        return {case: _jax_run(case) for case in CASES}


def _paths(c):
    return {name: p.encode() for name, p in c.discoveries().items()}


TIER_FIELDS = ("tier_spills", "cold_rows", "hot_rows")


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiered_engine_matches_jax(jax_runs, case):
    j = jax_runs[case]
    p = _port_run(case)
    unique, spills = WANT[case]
    assert p.unique_state_count() == j.unique_state_count() == unique
    assert p.state_count() == j.state_count()
    assert p.max_depth() == j.max_depth()
    assert p.discovery_fingerprints() == j.discovery_fingerprints()
    assert _paths(p) == _paths(j)
    for f in TIER_FIELDS:
        assert p.metrics.get(f) == j.metrics.get(f), f
    assert (p.metrics.get("tier_spills") or 0) >= spills
    if spills:
        assert p.metrics["cold_rows"] + p.metrics["hot_rows"] == unique
        assert p.metrics["cold_bytes"] == 8 * p.metrics["cold_rows"]
        assert p.metrics["hot_rows"] == p._final.vkeys.numel()
    assert p._tier_hot_ceiling == j._tier_hot_ceiling
    model = p.model
    for name, path in p.discoveries().items():
        prop = model.property_by_name(name)
        assert prop.condition(model, path.last_state()), name
    # and the port's own resident run
    r = _port_run(case, tiered=False)
    assert (r.unique_state_count(), r.state_count(), r.max_depth()) == (
        p.unique_state_count(), p.state_count(), p.max_depth())
    assert r.discovery_fingerprints() == p.discovery_fingerprints()
    assert _paths(r) == _paths(p)
    assert r.metrics.get("tier_spills") is None


def test_auto_ceiling_is_jax_decide_hot_rows(jax_runs):
    assert jax_runs["2pc3-auto-budget"]._tier_hot_ceiling == 64
    assert _port_run("2pc3-auto-budget").metrics["hot_ceiling_rows"] == 64
    assert jax_runs["2pc3-auto-dormant"]._tier_hot_ceiling == 1 << 10


# -- the ColdStore against JAX's ------------------------------------------


def _sorted_pair(rng, n):
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    hi = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    hi[: n // 8] = np.uint32(0x80000000)  # at the sign bit of the key
    order = np.lexsort((lo, hi))
    return lo[order], hi[order]


def _snapshots_equal(a, b) -> bool:
    return len(a) == len(b) and all(
        len(sa) == len(sb) and all(
            np.array_equal(la, lb) and np.array_equal(ha, hb)
            and la.dtype == lb.dtype == np.uint32
            for (la, ha), (lb, hb) in zip(sa, sb))
        for sa, sb in zip(a, b))


@pytest.mark.parametrize("asynchronous", [False, True])
def test_cold_store_matches_jax(asynchronous):
    from stateright_tpu import tier as jt
    from stateright_tpu_torch import tier as pt

    rng = np.random.default_rng(20261017)
    js, ps = jt.ColdStore(max_runs=2), pt.ColdStore(max_runs=2)
    spilled = []
    for _ in range(5):
        lo, hi = _sorted_pair(rng, 200)
        spilled.append((lo, hi))
        js.ingest([(lo, hi)], asynchronous=asynchronous)
        ps.ingest([pt.pack_keys_np(lo, hi)], asynchronous=asynchronous)
    js.sync()
    ps.sync()
    assert ps.rows() == js.rows() == 1000
    assert ps.run_count() == js.run_count() <= 2  # compacted
    assert ps.bytes() == js.bytes()
    assert ps.spills == js.spills == 5
    s_j, s_p = js.summary(), ps.summary()
    for k in ("n_shards", "spills", "runs", "cold_rows_total",
              "cold_bytes_total", "rows_per_shard"):
        assert s_p[k] == s_j[k], k
    # queries: half spilled keys, half fresh
    q_lo, q_hi = _sorted_pair(rng, 300)
    q_lo = np.concatenate([q_lo, spilled[1][0][:150], spilled[4][0][:150]])
    q_hi = np.concatenate([q_hi, spilled[1][1][:150], spilled[4][1][:150]])
    want = js.member(0, q_lo, q_hi)
    assert want.sum() == 300
    assert np.array_equal(ps.member(0, pt.pack_keys_np(q_lo, q_hi)), want)
    # the snapshot interface is JAX's, array for array
    assert _snapshots_equal(ps.snapshot_runs(), js.snapshot_runs())
    assert _snapshots_equal(ps.repartitioned(4).snapshot_runs(),
                            js.repartitioned(4).snapshot_runs())
    re4 = ps.repartitioned(4)
    assert re4.rows() == 1000
    for d in range(4):
        for run in re4.runs[d]:
            assert (np.diff(run) > 0).all()
            lo, _ = pt.unpack_keys_np(run)
            assert (lo % 4 == d).all()
    back = pt.ColdStore.from_runs(js.snapshot_runs(), spills=js.spills)
    assert back.rows() == js.rows() and back.spills == js.spills
    assert np.array_equal(back.member(0, pt.pack_keys_np(q_lo, q_hi)), want)


def test_cold_store_from_jax_snapshot_via_convert():
    from stateright_tpu import tier as jt
    from stateright_tpu_torch import tier as pt
    from stateright_tpu_torch.convert import cold_store_from_runs

    rng = np.random.default_rng(7)
    js = jt.ColdStore(n_shards=2)
    parts = [_sorted_pair(rng, 64) for _ in range(2)]
    js.ingest(parts, asynchronous=False)
    store = cold_store_from_runs(js.snapshot_runs())
    assert store.n_shards == 2 and store.rows() == js.rows() == 128
    for s in range(2):
        q_lo = np.concatenate([parts[s][0], parts[1 - s][0]])
        q_hi = np.concatenate([parts[s][1], parts[1 - s][1]])
        assert np.array_equal(store.member(s, pt.pack_keys_np(q_lo, q_hi)),
                              js.member(s, q_lo, q_hi))


def test_packed_keys_order_as_unsigned_pairs():
    from stateright_tpu_torch.ops.fingerprint import pack_keys
    from stateright_tpu_torch.tier import pack_keys_np, unpack_keys_np

    import torch

    rng = np.random.default_rng(3)
    lo, hi = _sorted_pair(rng, 1000)
    keys = pack_keys_np(lo, hi)
    assert (np.diff(keys) >= 0).all()
    assert np.array_equal(keys, pack_keys(
        torch.from_numpy(lo.astype(np.int64)),
        torch.from_numpy(hi.astype(np.int64))).numpy())
    lo2, hi2 = unpack_keys_np(keys)
    assert np.array_equal(lo2, lo) and np.array_equal(hi2, hi)


# -- the engine -------------------------------------------------------------


def test_cli_tiered_report_equals_resident():
    from stateright_tpu_torch.cli import main

    out = {}
    for args in ([], ["--tier-hot-rows=32"], ["--tier-hot-rows=auto"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["2pc", "check-gpu", "3", "--device", "cpu", *args])
        out[tuple(args)] = re.sub(r"sec=[0-9.]+", "sec=", buf.getvalue())
    assert "Done. states=1146, unique=288, depth=11, sec=" in out[()]
    assert out[("--tier-hot-rows=32",)] == out[()]
    assert out[("--tier-hot-rows=auto",)] == out[()]
    for bad in ("--tier-hot-rows=0", "--tier-hot-rows=-3"):
        with pytest.raises(SystemExit, match="the hot ceiling must be >= 1"):
            main(["2pc", "check-gpu", "3", "--device", "cpu", bad])
    with pytest.raises(SystemExit, match="--tier-hot-rows apply to check-gpu"):
        main(["2pc", "check", "3", "--tier-hot-rows=32"])
    with pytest.raises(ValueError, match="tier_hot_rows must be >= 1"):
        _port_run("2pc3", tier_hot_rows=0)


def test_tiered_run_past_the_resident_capacity():
    """The hot tier, not the visited set, is bounded by ``capacity``:
    a capacity below the 288 states overflows a resident run and holds
    a tiered one."""
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    def spawn(**kw):
        return TwoPhaseSys(rm_count=3).checker().spawn_sortmerge(
            capacity=200, frontier_capacity=64, device="cpu", **kw)

    with pytest.raises(RuntimeError, match="visited table overflow"):
        spawn().join()
    c = spawn(tier_hot_rows=64).join()
    assert c.unique_state_count() == 288
    assert c.metrics["cold_rows"] + c.metrics["hot_rows"] == 288
    assert c.metrics["hot_rows"] <= 200


def test_start_state_with_cold_runs():
    """A start state whose visited keys are split between the device and
    a cold store (built through the JAX snapshot interface) continues as
    the same state held wholly on the device does: the same counts,
    depth and discoveries, with the tier armed or not."""
    from stateright_tpu_torch.checkers.tpu_sortmerge import WaveState
    from stateright_tpu_torch.convert import cold_store_from_runs
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.tier import ColdStore

    def spawn(**kw):
        return TwoPhaseSys(rm_count=3).checker().spawn_sortmerge(
            capacity=1 << 10, frontier_capacity=128, device="cpu",
            track_paths=False, **kw)

    def mid_state():
        # stops after the wave that reaches 100 states, its winners not
        # yet expanded
        part = TwoPhaseSys(rm_count=3).checker().target_state_count(100)
        st = part.spawn_sortmerge(capacity=1 << 10, frontier_capacity=128,
                                  device="cpu", track_paths=False
                                  ).join()._final
        return WaveState(st.vkeys, st.frontier, st.ebits, st.depth,
                         st.generated)

    whole = spawn().start_from(mid_state()).join()
    assert whole.unique_state_count() == 288
    for tier in (None, 16):
        st = mid_state()
        n = st.vkeys.numel() // 2
        cold = ColdStore()
        cold.ingest([st.vkeys[:n].numpy()], asynchronous=False)
        st.cold = cold_store_from_runs(cold.snapshot_runs())
        st.vkeys = st.vkeys[n:]
        c = spawn(tier_hot_rows=tier).start_from(st).join()
        assert c.unique_state_count() == 288
        assert c.state_count() == whole.state_count()
        assert c.max_depth() == whole.max_depth()
        assert c.discovery_fingerprints() == whole.discovery_fingerprints()
        assert c.metrics["cold_rows"] + c.metrics["hot_rows"] == 288


class _SetAfter:
    """A cancel event that reads set from its ``n``-th test on."""

    def __init__(self, n):
        self.n = n

    def is_set(self):
        self.n -= 1
        return self.n < 0


def test_cancel_joins_the_ingest_worker(monkeypatch):
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.tier import ColdStore

    gate = threading.Event()
    slow = ColdStore._do_ingest

    def held(self, per_shard):
        gate.wait(5)
        slow(self, per_shard)

    monkeypatch.setattr(ColdStore, "_do_ingest", held)
    c = TwoPhaseSys(rm_count=3).checker().spawn_sortmerge(
        capacity=1 << 10, frontier_capacity=128, device="cpu",
        tier_hot_rows=32)
    c.cancel_event = _SetAfter(8)
    threading.Timer(0.2, gate.set).start()
    c.join()
    assert c.cancelled
    cold = c._final.cold
    assert cold is not None and cold._worker is None  # joined
    assert c.metrics["tier_spills"] >= 1
    assert c.metrics["cold_rows"] == cold.rows() > 0


# -- the sharded tier ----------------------------------------------------------


def _mesh5(S, **kw):
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    return TwoPhaseSys(rm_count=5).checker().spawn_sharded_sortmerge(
        devices=["cpu"] * S, capacity=1 << 14, frontier_capacity=1 << 12,
        **kw)


def _all_fields(c) -> tuple:
    return (c.unique_state_count(), c.state_count(), c.max_depth(),
            c.discovery_fingerprints(), _paths(c))


@pytest.fixture(scope="module")
def mesh_resident():
    return _mesh5(2).join()


def test_sharded_tier_equals_resident_sharded_run(mesh_resident):
    """2pc rm=5 at S = 2 with a 512-key hot tier a shard: the resident
    sharded run's every field and path, 8,832 (the host count), hot
    plus cold rows equal to unique, the spills shared by both shards."""
    t = _mesh5(2, tier_hot_rows=512).join()
    assert _all_fields(t) == _all_fields(mesh_resident)
    assert t.unique_state_count() == 8832
    m = t.metrics
    assert m["tier_spills"] >= 2 and m["hot_ceiling_rows"] == 512
    assert m["cold_rows"] + m["hot_rows"] == 8832
    assert len(m["cold_rows_per_shard"]) == 2
    assert all(r > 0 for r in m["cold_rows_per_shard"])
    assert m["cold_rows_per_shard"] == [
        u - h for u, h in zip(mesh_resident.metrics["shard_unique"],
                              m["shard_unique"])]


def test_sharded_tier_snapshot_resumes_anywhere(tmp_path, mesh_resident):
    """A tiered S = 2 snapshot taken after its spills resumes tiered at
    S = 2 to every field, and re-shards tiered onto S = 3, un-tiered
    onto S = 4, and onto one device tiered, to the counts."""
    from stateright_tpu_torch import faultinject
    from stateright_tpu_torch.checkpoint import load_snapshot
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    snap = str(tmp_path / "mesh_tier.ckpt")
    c = _mesh5(2, tier_hot_rows=512, checkpoint_every=1,
               checkpoint_path=snap)
    c.max_fault_retries = 0
    faultinject.arm("raise", "chunk_boundary", 12)
    try:
        with pytest.raises(faultinject.InjectedFault):
            c.join()
    finally:
        faultinject.disarm_all()
    manifest, buffers = load_snapshot(snap)
    assert manifest["tier"]["spills"] >= 2
    assert len(manifest["tier"]["run_rows"]) == 2
    assert int(buffers["u_loc"].sum()) == manifest["unique"]
    assert int(buffers["h_loc"].sum()) == buffers["vkeys"].shape[1]
    one = TwoPhaseSys(rm_count=5).checker().spawn_sortmerge(
        device="cpu", capacity=1 << 15, frontier_capacity=1 << 13,
        tier_hot_rows=1024)
    base = _all_fields(mesh_resident)
    for target, exact in ((_mesh5(2, tier_hot_rows=512), True),
                          (_mesh5(3, tier_hot_rows=512), False),
                          (_mesh5(4), False), (one, False)):
        target.resume_from(snap)
        target.join()
        got = _all_fields(target)
        assert (got if exact else got[:3]) == (base if exact else base[:3])
        assert target.discovered_property_names() == \
            mesh_resident.discovered_property_names()
