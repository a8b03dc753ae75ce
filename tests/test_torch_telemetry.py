"""The PyTorch port's run telemetry (stateright_tpu_torch/telemetry.py,
artifacts.py) held against the JAX package's on the CPU.

(a) The module alone: the same event lists go through both packages'
    ``validate_events``, ``diff_traces``, ``format_diff``,
    ``shard_balance``, ``memory_summary``, ``latency_summary``,
    ``detect_stragglers`` and ``_derive_latency_profile`` and give the
    same result, or the same ``ValueError`` on JAX's bad inputs (JAX
    ``tests/test_telemetry.py:118``, ``tests/test_memplan.py:242``); a
    trace either package wrote loads in the other.
(b) The engines, wave for wave: JAX ``spawn_tpu_sortmerge`` against the
    port's ``spawn_sortmerge`` at 2pc rm=4 (sparse and dense) and Paxos
    2c/3s, and JAX ``spawn_tpu`` against ``spawn_hash`` at 2pc rm=4:
    JAX's ``diff_traces`` finds no divergence, the ``wave`` events are
    equal on ``DIFF_COUNTERS``, ``enabled_pairs`` and ``depth``, and
    the ``verdict`` events agree on property and kind. (The hash
    engines keep no wave log in either package: their chunks land
    without waves.)
(c) The sharded engines at S = 2: the ``shard_wave`` rows equal JAX's as
    a multiset on ``SHARD_DIFF_COUNTERS`` every wave (``dest_cap`` is
    config, outside the set: the port's exchange has no padded tile).
(d) The straggler detector flags a skewed shard and feeds the
    supervisor's classification; a killed-and-resumed run diffs with no
    divergence against its uninterrupted run (the trace half of JAX
    ``tests/test_fault.py:259``).
(e) JAX's ``tools/trace_diff.py``, ``shard_report.py``,
    ``latency_report.py`` and ``mem_report.py``, unchanged, accept port
    traces with the exit codes JAX's tests expect.
(f) No tracer: every hook is a no-op, and a traced run at the default
    level makes exactly the host reads an untraced one makes, with equal
    counts and ``checker.metrics``.

The CLI's ``--trace`` lane is held here too (levels, artifacts on a
failed run, the metrics plane refused)."""

import json
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest

from stateright_tpu_torch import faultinject
from stateright_tpu_torch import telemetry as pt
from stateright_tpu_torch.checkers.tpu import READS
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

pytestmark = pytest.mark.trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SM = dict(capacity=512, frontier_capacity=128)
WAVE_KEYS = ("frontier_rows", "enabled_pairs", "candidates", "new_states",
             "unique_total", "depth")


def _jt():
    from stateright_tpu import telemetry

    return telemetry


def _trace(tel, spawn):
    """``(events, checker)`` of one traced run on ``tel``'s tracer."""
    tr = tel.RunTracer()
    with tr.activate():
        c = spawn().join()
    tel.validate_events(tr.events)
    return tr.events, c


def _port(spawn):
    return _trace(pt, spawn)


def _jax(spawn):
    return _trace(_jt(), spawn)


def _norm(x):
    """JSON-normal form (tuples as lists, keys sorted)."""
    return json.loads(json.dumps(x, sort_keys=True, default=str))


def _waves(evs):
    return [{k: e[k] for k in ("wave",) + WAVE_KEYS}
            for e in evs if e["ev"] == "wave"]


def _verdicts(evs):
    return sorted((e["property"], e["kind"]) for e in evs
                  if e["ev"] == "verdict")


def _shard_multisets(evs):
    out: dict = {}
    for e in evs:
        if e["ev"] == "shard_wave":
            out.setdefault(e["wave"], Counter())[tuple(
                e[f] for f in pt.SHARD_DIFF_COUNTERS)] += 1
    return out


def _same_stream(je, pe, waves=True):
    rep = _jt().diff_traces(je, pe)
    assert rep["divergences"] == [], rep["divergences"][:5]
    assert _waves(je) == _waves(pe)
    assert bool(_waves(pe)) == waves
    assert _verdicts(je) == _verdicts(pe)


@pytest.fixture(scope="module")
def mesh_traces():
    """A traced port run of each sharded engine at S = 2 (the sort-merge
    one with the straggler detector armed far above any skew a balanced
    run shows) and JAX's of the same check."""
    jt = _jt()
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as J

    def port_sm():
        c = TwoPhaseSys(rm_count=3).checker().spawn_sharded_sortmerge(
            devices=["cpu"] * 2, **SM)
        c.straggler_factor = 50.0
        return c

    return dict(
        port_sm=_port(port_sm)[0],
        jax_sm=_jax(lambda: J(rm_count=3).checker()
                    .spawn_tpu_sharded_sortmerge(
                        n_shards=2, cand_capacity=1024, bucket_capacity=512,
                        waves_per_sync=4, **SM))[0],
        port_hash=_port(lambda: TwoPhaseSys(rm_count=3).checker()
                        .spawn_sharded_hash(devices=["cpu"] * 2,
                                            capacity=1 << 10,
                                            frontier_capacity=128))[0],
        jax_hash=_jax(lambda: J(rm_count=3).checker().spawn_tpu_sharded(
            n_shards=2, capacity=1 << 10, frontier_capacity=128,
            cand_capacity=512, bucket_capacity=256))[0],
        jt=jt,
    )


@pytest.fixture(scope="module")
def twopc4():
    """Port and JAX traces of 2pc rm=4 on the sparse sort-merge engine,
    and the port's run."""
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as J

    pe, pc = _port(lambda: TwoPhaseSys(rm_count=4).checker().spawn_sortmerge(
        capacity=1 << 12, device="cpu"))
    je, _ = _jax(lambda: J(rm_count=4).checker().spawn_tpu_sortmerge(
        capacity=1 << 12, frontier_capacity=1 << 10, cand_capacity=1 << 12,
        waves_per_sync=4))
    return dict(port=pe, jax=je, checker=pc)


# -- (a) the module alone -------------------------------------------------


def test_schema_is_jax_schema():
    jt = _jt()
    for name in ("SCHEMA_VERSION", "WAVE_LOG_FIELDS", "WAVE_LOG_OPT_FIELDS",
                 "SHARD_LOG_FIELDS", "BUILD_TIERS", "VERDICT_KINDS",
                 "_REQUIRED", "DIFF_COUNTERS", "SHARD_DIFF_COUNTERS",
                 "STRAGGLER_MIN_MEDIAN_ROWS"):
        assert getattr(pt, name) == getattr(jt, name), name


def test_summaries_equal_jax_on_the_same_events(mesh_traces, twopc4):
    jt = mesh_traces["jt"]
    for evs in (mesh_traces["port_sm"], mesh_traces["jax_sm"],
                mesh_traces["port_hash"], twopc4["port"], twopc4["jax"]):
        jt.validate_events(evs)
        pt.validate_events(evs)
        for fn in ("shard_balance", "memory_summary", "latency_summary"):
            assert _norm(getattr(pt, fn)(evs)) == \
                _norm(getattr(jt, fn)(evs)), fn
    for a, b in ((mesh_traces["jax_sm"], mesh_traces["port_sm"]),
                 (twopc4["jax"], twopc4["port"]),
                 (twopc4["port"], twopc4["port"])):
        for kw in ({}, dict(threshold=0.0, min_sec=0.0)):
            jr, pr = jt.diff_traces(a, b, **kw), pt.diff_traces(a, b, **kw)
            assert _norm(pr) == _norm(jr)
            assert pt.format_diff(pr) == jt.format_diff(jr)
    bal = pt.shard_balance(mesh_traces["port_sm"])
    assert bal["n_shards"] == 2 and bal["warnings"] == []
    assert 0 < bal["dest_fill_worst"]["util"] <= 0.8


def test_latency_profile_and_stragglers_equal_jax(twopc4):
    jt = _jt()
    for evs in (twopc4["port"], twopc4["jax"]):
        j, p = jt.RunTracer(), pt.RunTracer()
        for tr in (j, p):
            tr.events = [dict(e) for e in evs]
            tr._run_idx = max(e["run"] for e in evs if "run" in e)
        for wall in (None, 1.5):
            assert p._derive_latency_profile(wall) == \
                j._derive_latency_profile(wall)
    rng = np.random.default_rng(0)
    for S in (1, 2, 4, 8):
        rows = rng.integers(0, 400, size=(S, len(pt.SHARD_LOG_FIELDS)))
        rows[0, 2] = 10_000  # a skewed candidates lane
        for factor in (1.5, 3.0):
            assert pt.detect_stragglers(rows, factor) == \
                jt.detect_stragglers(rows, factor)
    for bad in (None, 1.0, 0.5):
        with pytest.raises(ValueError) as pe:
            pt.detect_stragglers(rows, bad)
        with pytest.raises(ValueError) as je:
            jt.detect_stragglers(rows, bad)
        assert str(pe.value) == str(je.value)


def _bad_waves(tel):
    tr = tel.RunTracer()
    with tr.activate():
        tr.begin_run()
        tr.record_chunk(
            chunk=0, wave0=0, t0=0.0, t1=1.0, dispatch_sec=0.1,
            fetch_sec=0.9,
            wave_rows=np.array([[1, 2, 2, 2, 10, 1, 0, 0],
                                [2, 4, 4, 4, 99, 2, 0, 0]]))
        tr.end_run()
    return tr.events


def _bad_plan(tel):
    tr = tel.RunTracer()
    with tr.activate():
        tr.begin_run(lane={})
        tr.event("memory_plan", engine="X",
                 resident=[dict(name="a", shape=[2, 4], dtype="uint32",
                                bytes=32)],
                 resident_bytes=999, classes=[], compiled=None,
                 total_bytes=999)
        tr.end_run()
    return tr.events


@pytest.mark.parametrize("make,match", [(_bad_waves, "unique_total"),
                                        (_bad_plan, "resident_bytes")])
def test_bad_inputs_raise_jax_error(make, match):
    jt = _jt()
    for evs in (make(pt), make(jt)):
        msgs = []
        for tel in (pt, jt):
            with pytest.raises(ValueError, match=match) as err:
                tel.validate_events(evs)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    with pytest.raises(ValueError):
        pt.RunTracer(level="verbose")


def test_traces_cross_load(tmp_path, twopc4):
    jt = _jt()
    for tel, evs in ((pt, twopc4["jax"]), (jt, twopc4["port"])):
        tr = tel.RunTracer()
        tr.events = list(evs)
        path = tr.write_jsonl(str(tmp_path / "x.jsonl"))
        other = jt if tel is pt else pt
        back = other.load_trace(path)
        other.validate_events(back)
        assert _norm(back) == _norm(evs)
    bad = tmp_path / "bad.jsonl"
    bad.write_text("not json\n")
    for tel in (pt, jt):
        with pytest.raises(ValueError, match="not JSON"):
            tel.load_trace(str(bad))


# -- (b) the engines, wave for wave -----------------------------------------


def test_sparse_sortmerge_waves_equal_jax(twopc4):
    _same_stream(twopc4["jax"], twopc4["port"])
    ev = twopc4["port"]
    kinds = Counter(e["ev"] for e in ev)
    assert kinds["run_begin"] == kinds["run_end"] == 1
    assert kinds["wave"] == kinds["chunk"] == 14
    assert kinds["memory_plan"] == kinds["memory_watermark"] == 1
    assert kinds["latency_profile"] == 1
    spans = {e["phase"] for e in ev if e["ev"] == "span"}
    assert {"compile", "seed_upload", "counterexample_reconstruction",
            "cex_parent_drain", "cex_host_decode"} <= spans
    wave = [e for e in ev if e["ev"] == "wave"]
    assert wave[-1]["unique_total"] == twopc4["checker"].unique_state_count()
    assert all(w["f_class"] is None and w["v_class"] is None for w in wave)
    lane = ev[0]["lane"]
    assert lane["engine"] == "SortMergeTpuBfsChecker"
    assert ev[0]["provenance"]["backend"] == "cpu"


@pytest.mark.parametrize("case", ["dense", "hash"])
def test_dense_and_hash_waves_equal_jax(case):
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as J

    if case == "dense":
        je, _ = _jax(lambda: J(rm_count=4).checker().spawn_tpu_sortmerge(
            capacity=1 << 12, frontier_capacity=1 << 10,
            cand_capacity=1 << 12, waves_per_sync=4, sparse=False))
        pe, _ = _port(lambda: TwoPhaseSys(rm_count=4).checker()
                      .spawn_sortmerge(capacity=1 << 12, device="cpu",
                                       sparse=False))
    else:
        je, _ = _jax(lambda: J(rm_count=4).checker().spawn_tpu(
            capacity=1 << 12, frontier_capacity=1 << 10))
        pe, _ = _port(lambda: TwoPhaseSys(rm_count=4).checker().spawn_hash(
            capacity=1 << 12, device="cpu"))
    _same_stream(je, pe, waves=case == "dense")
    assert sum(e["ev"] == "chunk" for e in pe) == 14


def test_paxos_waves_equal_jax():
    from stateright_tpu.models.paxos import PaxosModelCfg as JC
    from stateright_tpu.models.paxos import paxos_model as jpm
    from stateright_tpu.models.paxos_tpu import STRUCTURAL_SIZES as JS
    from stateright_tpu_torch.models.paxos import PaxosModelCfg, paxos_model
    from stateright_tpu_torch.models.paxos_tpu import STRUCTURAL_SIZES

    je, _ = _jax(lambda: jpm(JC(client_count=2)).checker()
                 .spawn_tpu_sortmerge(cand_capacity="auto",
                                      track_paths=False, waves_per_sync=8,
                                      **JS[2]))
    pe, pc = _port(lambda: paxos_model(PaxosModelCfg(client_count=2))
                   .checker().spawn_sortmerge(device="cpu",
                                              track_paths=False,
                                              **STRUCTURAL_SIZES[2]))
    _same_stream(je, pe)
    assert _verdicts(pe) == [("linearizable", "exhaustion"),
                             ("value chosen", "discovery")]
    assert pc.unique_state_count() == 16668


def test_symmetry_canonical_hits_ride_the_wave():
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as J

    je, _ = _jax(lambda: J(rm_count=3).checker().symmetry()
                 .spawn_tpu_sortmerge(capacity=1 << 10,
                                      frontier_capacity=256,
                                      cand_capacity=1024, waves_per_sync=4))
    pe, pc = _port(lambda: TwoPhaseSys(rm_count=3).checker().symmetry()
                   .spawn_sortmerge(capacity=1 << 10, device="cpu"))
    # Both lanes carry the certificate status. The port's analyzer
    # certifies 2pc (spec and mask); JAX 0.9's refuses the mask it
    # certified under JAX 0.4.37 (SOUND_r01.json; ROADMAP §3), and its
    # lane says so. Past that known fault the streams must be equal.
    from stateright_tpu.analysis.soundness import certify_encoding
    from stateright_tpu.models.two_phase_commit_tpu import (
        TwoPhaseSysEncoded as JEnc,
    )

    [jb] = [e for e in je if e["ev"] == "run_begin"]
    [pb] = [e for e in pe if e["ev"] == "run_begin"]
    assert pb["lane"]["soundness_certified"] is True
    assert pb["lane"]["symmetry"] is True and pb["lane"]["ample_set"] is False
    assert jb["lane"]["soundness_certified"] is certify_encoding(
        JEnc(3)).certified
    jb["lane"]["soundness_certified"] = True
    _same_stream(je, pe)
    hits = [e["canonical_hits"] for e in pe if e["ev"] == "wave"]
    assert hits == [e["canonical_hits"] for e in je if e["ev"] == "wave"]
    assert sum(hits) == pc.metrics["canonical_hits"] > 0


# -- (c) the sharded engines ----------------------------------------------


@pytest.mark.parametrize("family", ["sm", "hash"])
def test_shard_rows_equal_jax(mesh_traces, family):
    je, pe = mesh_traces[f"jax_{family}"], mesh_traces[f"port_{family}"]
    _same_stream(je, pe)
    # every SHARD_DIFF_COUNTERS field, as a multiset a wave
    assert _shard_multisets(je) == _shard_multisets(pe)
    rows = [e for e in pe if e["ev"] == "shard_wave"]
    assert len(rows) == 2 * sum(e["ev"] == "wave" for e in pe)
    waves = {e["wave"]: e for e in pe if e["ev"] == "wave"}
    for w, group in _group(rows).items():
        assert sum(r["recv_rows"] for r in group) == \
            waves[w]["candidates"]
        assert sum(r["frontier_rows"] for r in group) == \
            waves[w]["frontier_rows"]
        for r in group:
            assert r["dest_cap"] >= max(128, r["dest_fill_peak"])
    # the balanced run raised no straggler verdict
    assert not [e for e in pe if e["ev"] == "shard_health"]


def _group(rows):
    out: dict = {}
    for r in rows:
        out.setdefault(r["wave"], []).append(r)
    return out


# -- (d) the straggler detector and the fault pieces ----------------------


def test_straggler_detector_flags_a_skewed_shard():
    from stateright_tpu_torch.checkpoint import FailurePolicy

    c = TwoPhaseSys(rm_count=3).checker().spawn_sharded_sortmerge(
        devices=["cpu"] * 4, **SM)
    c.straggler_factor = 2.0
    tr = pt.RunTracer()
    rows = np.zeros((4, len(pt.SHARD_LOG_FIELDS)), np.int64)
    rows[:, 2] = [100, 100, 100, 100]
    with tr.activate():
        tr.begin_run()
        c._note_shard_health(rows, 0)  # balanced: no verdict
        rows[2, 2] = 1000
        for w in range(1, 4):
            c._note_shard_health(rows, w)
        tr.end_run()
    health = [e for e in tr.events if e["ev"] == "shard_health"]
    assert [(e["shard"], e["wave"], e["sustained"]) for e in health] == [
        (2, 1, 1), (2, 2, 2), (2, 3, 3)]
    assert health[0]["ratio"] == 10.0 and health[0]["kind"] == "straggler"
    pt.validate_events(tr.events)
    assert c._sustained_stragglers() == (2,)
    # the supervisor's classification names the straggling shard
    kind, shard = FailurePolicy().classify(
        faultinject.InjectedFault("mid_chunk", 4),
        straggler_shards=c._sustained_stragglers())
    assert (kind, shard) == ("transient", 2)


def test_killed_and_resumed_run_diffs_clean(tmp_path):
    path = str(tmp_path / "rm4.ckpt")
    full, c0 = _port(lambda: TwoPhaseSys(rm_count=4).checker()
                     .spawn_sortmerge(capacity=1 << 12, device="cpu"))
    # the killed process: snapshots every 2 waves, a fault at the
    # boundary after wave 5 (its snapshot, of wave 6, is committed)
    faultinject.arm("raise", "chunk_boundary", 5)
    killed = TwoPhaseSys(rm_count=4).checker().spawn_sortmerge(
        capacity=1 << 12, device="cpu", checkpoint_every=2,
        checkpoint_path=path)
    killed.max_fault_retries = 0
    tr = pt.RunTracer()
    try:
        with tr.activate(), pytest.raises(faultinject.InjectedFault):
            killed.join()
    finally:
        faultinject.disarm_all()
    pt.validate_events(tr.events)
    kinds = Counter(e["ev"] for e in tr.events)
    assert kinds["checkpoint"] == 3 and kinds["fault_injected"] == 1
    assert tr.events[-1]["ev"] == "run_end" and "InjectedFault" in \
        tr.events[-1]["error"]

    def resumed():
        c = TwoPhaseSys(rm_count=4).checker().spawn_sortmerge(
            capacity=1 << 12, device="cpu")
        c.resume_from(path)
        return c

    rev, c1 = _port(resumed)
    restore = [e for e in rev if e["ev"] == "restore"]
    assert len(restore) == 1 and restore[0]["wave"] == 6
    assert [e["wave"] for e in rev if e["ev"] == "wave"][0] == 6
    for tel in (pt, _jt()):
        rep = tel.diff_traces(full, rev)
        assert rep["divergences"] == [] and rep["resume_wave_b"] == 6
    assert c1.unique_state_count() == c0.unique_state_count() == 1568


def test_supervised_recovery_events(tmp_path):
    faultinject.arm("raise", "mid_chunk", 4)
    try:
        evs, c = _port(lambda: _ckpt_checker(tmp_path))
    finally:
        faultinject.disarm_all()
    kinds = Counter(e["ev"] for e in evs)
    assert kinds["fault_injected"] == kinds["fault_recovery"] == 1
    assert kinds["restore"] == 1 and kinds["checkpoint"] >= 2
    rec = next(e for e in evs if e["ev"] == "fault_recovery")
    assert rec["attempt"] == 1 and rec["failure_class"] == "transient"
    assert c.unique_state_count() == 1568


def test_watchdog_timeout_event(tmp_path):
    c = _ckpt_checker(tmp_path)
    c.checkpoint_every = 1
    c.watchdog_factor = 2.0
    c.watchdog_floor_sec = 0.3
    c.watchdog_grace_sec = 15.0
    faultinject.arm("hang", "mid_chunk", 2, hang_sec=1.0)
    try:
        evs, c = _port(lambda: c)
    finally:
        faultinject.disarm_all()
    wd = [e for e in evs if e["ev"] == "watchdog_timeout"]
    assert len(wd) == 1 and wd[0]["chunk"] == 2
    assert 0.3 <= wd[0]["deadline_sec"] <= 15.0
    rec = next(e for e in evs if e["ev"] == "fault_recovery")
    assert rec["failure_class"] == "hang"
    assert c.unique_state_count() == 1568


def _ckpt_checker(tmp_path):
    c = TwoPhaseSys(rm_count=4).checker().spawn_sortmerge(
        capacity=1 << 12, device="cpu", checkpoint_every=2,
        checkpoint_path=str(tmp_path / "sup.ckpt"))
    c.retry_backoff_sec = 0.0
    return c


def test_tier_spill_events(tmp_path):
    evs, c = _port(lambda: TwoPhaseSys(rm_count=3).checker().spawn_sortmerge(
        capacity=1 << 10, device="cpu", tier_hot_rows=32))
    spills = [e for e in evs if e["ev"] == "tier_spill"]
    assert len(spills) == c.metrics["tier_spills"] > 1
    assert spills[-1]["cold_rows_total"] == c.metrics["cold_rows"]
    assert [e["spill_index"] for e in spills] == list(
        range(1, len(spills) + 1))
    wm = next(e for e in evs if e["ev"] == "memory_watermark")
    assert wm["cold_tier_bytes"] == c.metrics["cold_bytes"]
    assert c.unique_state_count() == 288


# -- (e) the JAX tools on a port trace ------------------------------------


def _tool(name, *args):
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", name), *args],
        capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=120)


def test_jax_tools_read_port_traces(tmp_path, mesh_traces, twopc4):
    paths = {}
    # a pair above the noise floor whose B blocks ten times longer
    def blocked(sec):
        return [dict(e, fetch_sec=e["fetch_sec"] + sec)
                if e["ev"] == "chunk" else e for e in twopc4["port"]]

    for name, evs in (("port", twopc4["port"]), ("fast", blocked(0.1)),
                      ("slow", blocked(1.0)),
                      ("mesh", mesh_traces["port_sm"])):
        tr = pt.RunTracer()
        tr.events = evs
        paths[name] = tr.write_jsonl(str(tmp_path / f"{name}.jsonl"))
    out = _tool("trace_diff.py", paths["port"], paths["port"])
    assert out.returncode == 0 and "verdict: OK" in out.stdout, out.stderr
    out = _tool("trace_diff.py", paths["fast"], paths["slow"])
    assert out.returncode == 1 and "REGRESSION" in out.stdout, out.stdout
    out = _tool("shard_report.py", paths["mesh"])
    assert out.returncode == 0, out.stderr
    assert "shard balance: run #0, 2 shards" in out.stdout
    assert _tool("shard_report.py", paths["port"]).returncode == 2
    out = _tool("latency_report.py", paths["port"], "--json", "--root",
                str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "time to verdict" in out.stdout
    assert os.path.exists(tmp_path / "LAT_r01.json")
    out = _tool("mem_report.py", paths["port"])
    assert out.returncode == 0, out.stderr
    assert "resident-buffer ledger" in out.stdout and "vkeys" in out.stdout


def test_memory_artifact_and_trace_pair(tmp_path, twopc4):
    from stateright_tpu_torch.memplan import write_memory_artifact

    s = pt.memory_summary(twopc4["port"])
    path = write_memory_artifact(dict(s, trace="TRACE_rXX.jsonl"),
                                 root=str(tmp_path))
    assert os.path.basename(path) == "MEM_r01.json"
    doc = json.load(open(path))
    assert doc["plan"]["compiled"] is None and doc["plan"]["classes"] == []
    assert doc["provenance"]["torch"] and "jax" not in doc["provenance"]
    tr = pt.RunTracer()
    tr.events = twopc4["port"]
    jsonl, chrome = pt.write_artifacts(tr, root=str(tmp_path))
    assert os.path.basename(jsonl) == "TRACE_r01.jsonl"
    assert os.path.basename(chrome) == "TRACE_r01.trace.json"
    ct = json.load(open(chrome))
    assert any(e.get("name") == "host_blocked_ms" for e in ct["traceEvents"])


# -- (f) no tracer ----------------------------------------------------------


def test_hooks_are_noops_without_a_tracer():
    assert pt.current_tracer() is None
    assert pt.span("anything") is pt._NULL_SPAN
    pt.emit("ignored", x=1)


@pytest.mark.parametrize("spawn", ["sparse", "dense", "hash", "mesh"])
def test_traced_run_reads_and_counts_as_untraced(spawn):
    def make():
        b = TwoPhaseSys(rm_count=3).checker()
        if spawn == "hash":
            return b.spawn_hash(capacity=1 << 10, device="cpu")
        if spawn == "mesh":
            return b.spawn_sharded_sortmerge(devices=["cpu"] * 2, **SM)
        return b.spawn_sortmerge(capacity=1 << 10, device="cpu",
                                 sparse=spawn == "sparse")

    n0 = READS.calls
    c0 = make().join()
    untraced = READS.calls - n0
    n1 = READS.calls
    evs, c1 = _port(make)
    assert READS.calls - n1 == untraced > 0
    assert (c1.unique_state_count(), c1.state_count(), c1.max_depth(),
            c1.discovery_fingerprints()) == \
        (c0.unique_state_count(), c0.state_count(), c0.max_depth(),
         c0.discovery_fingerprints())
    assert c1.metrics == c0.metrics
    assert sum(e["ev"] == "chunk" for e in evs) == c1.metrics["waves"]


def test_deep_level_exact_walls():
    tr = pt.RunTracer(level="deep")
    with tr.activate():
        c = TwoPhaseSys(rm_count=3).checker().spawn_sortmerge(
            capacity=1 << 10, device="cpu").join()
    pt.validate_events(tr.events)
    waves = [e for e in tr.events if e["ev"] == "wave"]
    assert waves and not any(w["t_est"] for w in waves)
    chunks = [e for e in tr.events if e["ev"] == "chunk"]
    assert all(ch["device_sec"] is not None for ch in chunks)
    assert tr.events[0]["level"] == "deep"
    assert c.unique_state_count() == 288


# -- host checkers and the hybrid -----------------------------------------


def test_host_checkers_trace_as_jax():
    jt = _jt()
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as J

    for spawn in ("spawn_bfs", "spawn_dfs"):
        je, _ = _jax(lambda: getattr(J(rm_count=3).checker(), spawn)())
        pe, _ = _port(lambda: getattr(TwoPhaseSys(rm_count=3).checker(),
                                      spawn)())
        assert _verdicts(je) == _verdicts(pe)
        for evs in (je, pe):
            totals = {e["phase"]: e["count"] for e in evs
                      if e["ev"] == "phase_total"}
            assert totals["property_check"] == 288
        assert _norm(pt.latency_summary(pe)["verdicts"][0].keys()) == \
            _norm(jt.latency_summary(je)["verdicts"][0].keys())
    tr = pt.RunTracer()
    with tr.activate():
        c = TwoPhaseSys(rm_count=2).checker().spawn_on_demand()
        c.run_to_completion()
    pt.validate_events(tr.events)
    assert {e["run"] for e in tr.events if e["ev"] == "run_begin"} == {0}
    assert dict((v["property"], v["kind"]) for v in tr.events
                if v["ev"] == "verdict")["consistent"] == "exhaustion"


def test_hybrid_records_into_one_run():
    tr = pt.RunTracer()
    with tr.activate():
        h = TwoPhaseSys(rm_count=3).checker().spawn_hybrid(
            device="cpu").join()
    pt.validate_events(tr.events)
    assert [e["run"] for e in tr.events if e["ev"] == "run_begin"] == [0]
    assert sum(e["ev"] == "run_end" for e in tr.events) == 1
    assert {e["run"] for e in tr.events} == {0}
    kinds = [(v["property"], v["kind"]) for v in tr.events
             if v["ev"] == "verdict" and v["kind"] == "exhaustion"]
    assert kinds == [("consistent", "exhaustion")]
    assert h.unique_state_count() == 288


def test_cancelled_run_emits_no_exhaustion_verdicts():
    import threading

    tr = pt.RunTracer()
    with tr.activate():
        c = TwoPhaseSys(rm_count=3).checker().spawn_sortmerge(
            capacity=1 << 10, device="cpu")
        c.cancel_event = threading.Event()
        c.cancel_event.set()
        c.join()
    assert c.cancelled
    assert not [e for e in tr.events if e["ev"] == "verdict"]


# -- the CLI lane ---------------------------------------------------------


def test_cli_trace_levels_and_failed_run(tmp_path, capsys):
    from stateright_tpu_torch.cli import main

    with pytest.raises(SystemExit, match="unknown level"):
        main(["2pc", "check-gpu", "2", "--device", "cpu", "--trace=verbose"])
    # the metrics plane's flag is taken (a rollup, no trace artifact);
    # a cadence that is not > 0 is refused
    with pytest.raises(SystemExit, match="must be > 0 seconds"):
        main(["2pc", "check-gpu", "2", "--device", "cpu",
              "--metrics-interval=0"])
    rollup = tmp_path / "m.jsonl"
    main(["2pc", "check-gpu", "2", "--device", "cpu",
          "--metrics-interval=1", f"--metrics-path={rollup}"])
    assert rollup.exists() and not list(tmp_path.glob("TRACE_*"))
    root = f"--trace-root={tmp_path}"
    main(["--trace=deep", "2pc", "check-gpu", "2", "--device", "cpu", root])
    main(["2pc", "check", "2", "--trace", root])
    assert "Done. states=" in capsys.readouterr().out
    evs = pt.load_trace(str(tmp_path / "TRACE_r01.jsonl"))
    pt.validate_events(evs)
    assert evs[0]["level"] == "deep"
    host = pt.load_trace(str(tmp_path / "TRACE_r02.jsonl"))
    assert host[0]["lane"]["engine"] == "DfsChecker"
    # a failed run still writes its trace, the error on its run_end
    faultinject.arm("raise", "mid_chunk", 2)
    try:
        with pytest.raises(faultinject.InjectedFault):
            main(["2pc", "check-gpu", "3", "--device", "cpu", "--trace",
                  root])
    finally:
        faultinject.disarm_all()
    failed = pt.load_trace(str(tmp_path / "TRACE_r03.jsonl"))
    pt.validate_events(failed)
    assert "InjectedFault" in failed[-1]["error"]
    assert os.path.exists(tmp_path / "TRACE_r03.trace.json")
