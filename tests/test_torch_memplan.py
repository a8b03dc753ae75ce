"""The PyTorch port's memory plan (stateright_tpu_torch/memplan.py) and
occupancy formatter (occupancy.py), on the CPU, held against the JAX
package: the pure pricing functions on a grid of inputs, the warning
strings, and ``checker.memory_plan`` against the real tensors the
sort-merge engine (paths on and off, resident and tiered) and the hash
engine keep, as JAX ``tests/test_memplan.py::_check_plan_vs_nbytes``
holds its engines' carries."""

import itertools

import numpy as np
import pytest


def test_decide_hot_rows_matches_jax():
    from stateright_tpu import memplan as jm
    from stateright_tpu_torch import memplan as pm

    grid = itertools.product(
        (1 << 10, 3000, 1 << 20, 1 << 25),        # capacity
        (64, 1 << 10, 1 << 19),                   # v_min
        (2, 3, 4),                                # v_ladder_step
        (128, 1 << 8, 1 << 23),                   # frontier_capacity
        (1, 3072, 2 * ((1 << 14) + 256) * 8, 1 << 31, 1 << 40))
    n = 0
    for cap, v_min, step, F, budget in grid:
        assert pm.decide_hot_rows(cap, v_min, step, F, budget) == \
            jm.decide_hot_rows(cap, v_min, step, F, budget), (
                cap, v_min, step, F, budget)
        n += 1
    assert n == 540


def test_tier_frontier_headroom_matches_jax():
    from stateright_tpu import memplan as jm
    from stateright_tpu_torch import memplan as pm

    for cap, F, B in itertools.product((1 << 10, 1 << 20), (128, 4096),
                                       (None, "auto", 64, 128, 512, 1 << 14)):
        assert pm.tier_frontier_headroom(cap, F, B) == \
            jm.tier_frontier_headroom(cap, F, B), (cap, F, B)


def test_format_bytes_buffer_entry_and_v_classes_match_jax():
    from stateright_tpu import memplan as jm
    from stateright_tpu_torch import memplan as pm

    for n in (None, 0, 1, 1023, 1024, 7200, 5 * 2 ** 20, 3.3e9, 2 ** 45,
              -4096):
        assert pm.format_bytes(n) == jm.format_bytes(n), n
    for name, shape, dtype in (("vkeys", (2, 1088), np.uint32),
                               ("frontier", (19, 0), np.uint32),
                               ("ebits", (256,), np.int64),
                               ("fval", (7, 3, 5), np.bool_),
                               ("scalar", (), np.uint32)):
        assert pm.buffer_entry(name, shape, dtype) == \
            jm.buffer_entry(name, shape, dtype)
    for ladder, nf in (([64, 128, 256, 1024], 128), ([1 << 19], 1 << 23),
                       ([], 5)):
        assert pm.v_class_entries(ladder, nf) == jm.v_class_entries(ladder, nf)
    assert pm.plan_total(pm.plan_entries(
        {"a": ((3, 4), np.int64), "b": ((5,), np.bool_)})) == 101


def test_torch_dtypes_price_as_numpy():
    import torch

    from stateright_tpu_torch.memplan import buffer_entry, plan_entries

    t = torch.zeros((3, 5), dtype=torch.int64)
    assert buffer_entry("t", t.shape, t.dtype) == buffer_entry(
        "t", (3, 5), np.int64)
    rows = plan_entries({"b": torch.zeros(7, dtype=torch.bool), "t": t})
    assert [(r["name"], r["dtype"], r["bytes"]) for r in rows] == [
        ("b", "bool", 7), ("t", "int64", 120)]


def test_device_bytes_in_use_is_plain_on_the_cpu():
    from stateright_tpu_torch.memplan import device_bytes_in_use

    assert device_bytes_in_use("cpu") == (None, None)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(used=900, capacity=1000),
    dict(used=900, capacity=1000, bytes_per_row=8),
    dict(used=900, capacity=1000, bytes_per_row=24, kind="visited keys",
         threshold=0.8, consequence="one skewed wave can overflow"),
    dict(bytes_per_row=8),
])
@pytest.mark.parametrize("occupancy", [0.5, 0.7, 0.8, 0.85, 1.2])
def test_occupancy_warning_matches_jax(occupancy, kw):
    from stateright_tpu import occupancy as jo
    from stateright_tpu_torch import occupancy as po

    assert po.occupancy_warning(occupancy, **kw) == \
        jo.occupancy_warning(occupancy, **kw)
    assert po.HEADROOM_THRESHOLD == jo.HEADROOM_THRESHOLD
    assert po.PROBE_PRESSURE_THRESHOLD == jo.PROBE_PRESSURE_THRESHOLD


def _check_plan_vs_nbytes(plan, tensors: dict):
    """Every resident row matches its tensor's shape, dtype and nbytes,
    and the totals add up."""
    assert {e["name"] for e in plan["resident"]} == set(tensors)
    total = 0
    for e in plan["resident"]:
        t = tensors[e["name"]]
        assert tuple(e["shape"]) == tuple(t.shape), e["name"]
        assert e["dtype"] == str(t.dtype).replace("torch.", ""), e["name"]
        assert e["bytes"] == t.nbytes == t.numel() * t.element_size()
        total += t.nbytes
    assert plan["resident_bytes"] == total
    assert plan["n_shards"] == 1
    assert plan["staging_bytes"] == sum(e["bytes"] for e in plan["staging"])
    assert plan["total_bytes"] == total + plan["staging_bytes"]


def _twopc(rm=3):
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    return TwoPhaseSys(rm_count=rm).checker()


@pytest.mark.parametrize("track_paths", [True, False])
def test_sortmerge_plan_matches_nbytes(track_paths):
    c = _twopc().spawn_sortmerge(capacity=1 << 10, frontier_capacity=256,
                                 track_paths=track_paths,
                                 device="cpu").join()
    assert c.unique_state_count() == 288
    st = c._final
    assert st.vkeys.numel() == 288
    tensors = dict(vkeys=st.vkeys, frontier=st.frontier, ebits=st.ebits)
    if track_paths:
        tensors.update(plog_child=c._plog[0], plog_parent=c._plog[1])
        assert c._plog[0].numel() == 288 - 1  # every state but the root
    _check_plan_vs_nbytes(c.memory_plan, tensors)
    plan = c.memory_plan
    assert "host" not in plan
    w, nc = c.encoded.width, c.metrics["max_wave_candidates"]
    assert {e["name"]: e["shape"] for e in plan["staging"]} == dict(
        candidates=[w, nc], candidate_keys=[nc], sorted_keys=[nc],
        sorted_pos=[nc])
    # the JAX engine's per-row pricing and next-class projection
    assert c._visited_bytes_per_row() == 8 + (16 if track_paths else 0)
    proj = plan["projection"]
    assert proj["kind"] == "next_v_class"
    assert proj["next_vkeys_bytes"] == (proj["next_rows"] + 256) * 8
    assert proj["next_merge_scratch_bytes"] == proj["next_vkeys_bytes"]


def test_sortmerge_plan_projection_matches_jax_ladder():
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as JSys

    kw = dict(capacity=1 << 12, frontier_capacity=512, track_paths=False)
    p = _twopc(4).spawn_sortmerge(v_min=256, device="cpu", **kw).join()
    j = JSys(rm_count=4).checker().spawn_tpu_sortmerge(
        v_min=256, cand_capacity=4096, waves_per_sync=4, merge_impl="xla",
        **kw).join()
    assert p.unique_state_count() == j.unique_state_count() == 1568
    assert p.memory_plan["projection"] == j._memory_projection()


def test_tiered_plan_keeps_the_parent_log_on_the_host():
    c = _twopc().spawn_sortmerge(capacity=1 << 10, frontier_capacity=128,
                                 tier_hot_rows=32, device="cpu").join()
    st = c._final
    _check_plan_vs_nbytes(c.memory_plan, dict(
        vkeys=st.vkeys, frontier=st.frontier, ebits=st.ebits))
    host = {e["name"]: e for e in c.memory_plan["host"]}
    assert host["cold_keys"]["bytes"] == c.metrics["cold_bytes"]
    assert host["plog_child"]["bytes"] == c._plog[0].nbytes == 287 * 8
    assert isinstance(c._plog[0], np.ndarray)


def test_hash_plan_matches_nbytes():
    c = _twopc().spawn_hash(capacity=1 << 10, device="cpu").join()
    assert c.unique_state_count() == 288
    f = c._final
    table = f["table"]
    assert table.entries is None  # a CPU table is its key array
    assert int(table.occupied().sum()) == 288
    _check_plan_vs_nbytes(c.memory_plan, dict(
        table=table.keys, parents=f["parents"], frontier=f["frontier"],
        ebits=f["ebits"]))
    assert c.memory_plan["projection"] == dict(
        kind="capacity_x2", next_rows=1 << 11,
        next_visited_bytes=(1 << 11) * 16)


def test_session_resident_bytes_prices_int64_lanes():
    from stateright_tpu_torch.memplan import LANE_BYTES, session_resident_bytes

    c = _twopc().spawn_sortmerge(capacity=1 << 10, frontier_capacity=256,
                                 device="cpu")
    got = session_resident_bytes(c)
    W, K = c.encoded.width, c.encoded.max_actions
    assert got == dict(
        visited_bytes=(1 << 10) * 24, frontier_bytes=256 * W * LANE_BYTES,
        cand_bytes=256 * K * W * LANE_BYTES,
        total_bytes=(1 << 10) * 24 + 256 * W * 8 * (1 + K))
