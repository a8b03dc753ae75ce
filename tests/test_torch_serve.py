"""The PyTorch port's resident checking service (serve.py) on the CPU,
held against the JAX package's.

The counterparts of JAX ``tests/test_serve.py``, each on a
``CheckService(device="cpu")``: concurrent sessions on real threads
giving the pinned paxos 2c/3s = 16,668 and 2pc rm=4 = 1,568 with no
event of one session in another's trace (:51), an Explorer query on the
same service (:113), the warm-start re-check settling with zero new
waves (:193, :233), admission refusing before any wave (:288), the flag
refusal (:306), the FIFO gate (:347), the summary and the SERVE artifact
(:379, :438), the registry's server (:448), batched sessions through the
service (:481, :541, :574, :603, :626) and the snapshot spool's LRU
(:675). The second in-process check's ``in_process`` tier (:315) is
pinned in ``tests/test_torch_cuda_build.py``, where the port's kernel
libraries load. The port builds nothing per session, so JAX's program
LRU (:245) and pre-warm (:653) have no counterpart here.

Parity with JAX: the same lane through both services reports the same
counts and paths, JAX's ``diff_traces`` finds no divergence between the
two sessions' traces, JAX's ``serve_summary`` over the port's merged
trace equals the port's, and the JAX package's ``tools/serve_report.py``
reads a port service trace. Every thread join, socket and request here
is bounded by a timeout."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from stateright_tpu_torch import cli, telemetry
from stateright_tpu_torch.serve import (
    CheckService,
    FifoLock,
    serve_summary,
)
from stateright_tpu_torch.telemetry import validate_events

pytestmark = pytest.mark.serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds any one thread, request or subprocess may take here
TIMEOUT = 120


def _service(tmp_path, **kw):
    return CheckService(device="cpu", spool_dir=str(tmp_path), **kw)


def _wave_events(session):
    return [e for e in session.tracer.events if e["ev"] == "wave"]


def _concurrent(service, lanes, stagger_sec=0.0):
    """Submit lanes on real threads (staggered where the join ORDER
    matters: seat 0 leads a fused run) and return the sessions in
    submission order."""
    results: dict = {}

    def run(i, argv):
        results[i] = service.check(argv)

    threads = []
    for i, argv in enumerate(lanes):
        t = threading.Thread(target=run, args=(i, argv))
        t.start()
        threads.append(t)
        if stagger_sec and i + 1 < len(lanes):
            time.sleep(stagger_sec)
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive(), "a session did not settle"
    return [results[i] for i in range(len(lanes))]


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _post(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body or {}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _serving(service):
    """The service's HTTP server on an ephemeral port, serving on a
    thread: ``(server, port)``."""
    server = service.http_server("127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def _done_line(output: str) -> str:
    """The report's ``Done.`` line without its ``sec=``."""
    line = next(ln for ln in output.splitlines() if ln.startswith("Done."))
    return line.split(", sec=")[0]


# -- concurrent sessions: pinned counts, zero bleed -----------------------


def test_concurrent_sessions_pinned_counts_zero_bleed(tmp_path):
    service = _service(tmp_path)
    paxos, twopc = _concurrent(service, [["paxos", "check-gpu", "2"],
                                         ["2pc", "check-gpu", "4"]])
    assert paxos.state == "done", paxos.error
    assert twopc.state == "done", twopc.error
    assert paxos.unique == 16668 and twopc.unique == 1568
    assert "unique=16668" in paxos.output
    assert "unique=1568" in twopc.output
    assert "on the CPU wave engine" in twopc.output  # the service's device
    for s, enc in ((paxos, "PaxosEncoded"), (twopc, "TwoPhaseSysEncoded")):
        validate_events(s.tracer.events)
        begins = [e for e in s.tracer.events if e["ev"] == "run_begin"]
        assert len(begins) == 1
        assert begins[0]["lane"]["encoding"] == enc
        assert begins[0]["lane"]["device"] == "cpu"
        assert {e.get("run") for e in s.tracer.events} == {0}
        # the shared device's bytes are the process's, and say so
        marks = [e for e in s.tracer.events
                 if e["ev"] == "memory_watermark"]
        assert [e["scope"] for e in marks] == ["process"]
    assert _wave_events(paxos)[-1]["unique_total"] == 16668
    assert _wave_events(twopc)[-1]["unique_total"] == 1568
    merged = service.events()
    validate_events(merged)
    kinds = [e["ev"] for e in merged]
    assert kinds.count("session_begin") == kinds.count("session_end") == 2
    assert len({e["run"] for e in merged if e["ev"] == "run_begin"}) == 2


# -- the Explorer on the same service -------------------------------------


def test_explorer_query_on_the_warm_service(tmp_path):
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    service = _service(tmp_path)
    service.mount_explorer(TwoPhaseSys(rm_count=2).checker(), "2pc")
    server, port = _serving(service)
    try:
        done = []
        worker = threading.Thread(
            target=lambda: done.append(service.check(["2pc", "check-gpu",
                                                      "3"])))
        worker.start()
        status = _get(port, "/.status")
        assert status["model"] == "TwoPhaseSys" and "service" in status
        views = _get(port, "/.states/")
        assert views and "fingerprint" in views[0]
        resp = _post(port, "/.check", {"argv": ["2pc", "check-gpu", "3"]})
        assert resp["ok"] is True and "unique=288" in resp["output"]
        worker.join(timeout=TIMEOUT)
        assert done[0].state == "done" and done[0].unique == 288
        states = {s["lane"]: s["state"]
                  for s in _get(port, "/.serve/sessions")["sessions"]}
        assert states["explore 2pc"] == "serving"
    finally:
        server.shutdown()
        server.server_close()
    merged = service.events()
    validate_events(merged)
    spans = [e for e in merged if e["ev"] == "span"
             and e.get("phase") == "explorer_request"]
    assert len(spans) >= 2
    ex = next(s for s in service._sessions if s.kind == "explorer")
    assert len([e for e in ex.tracer.events if e["ev"] == "span"
                and e["phase"] == "explorer_request"]) == len(spans)
    for s in service._sessions:
        if s.kind == "check":
            assert not [e for e in s.tracer.events
                        if e.get("phase") == "explorer_request"]


# -- warm start -----------------------------------------------------------


def test_warm_start_recheck_equal_counts_zero_waves(tmp_path):
    service = _service(tmp_path)
    cold = service.check(["2pc", "check-gpu", "3"])
    assert cold.state == "done" and cold.unique == 288
    assert not cold.warm_start and len(_wave_events(cold)) == 11
    assert cold.snapshot_bytes > 0 and cold.retain_sec >= 0

    warm = service.check(["2pc", "check-gpu", "3"])
    assert warm.state == "done", warm.error
    assert warm.warm_start is True
    assert (warm.unique, warm.total) == (cold.unique, cold.total)
    assert _done_line(warm.output) == _done_line(cold.output)
    # the discoveries' paths are the report's lines after Done.
    assert (warm.output.split("sec=")[1].split("\n", 1)[1]
            == cold.output.split("sec=")[1].split("\n", 1)[1])
    assert warm.checker.discovery_fingerprints() == \
        cold.checker.discovery_fingerprints()
    # the warm session wrote nothing: its snapshot is the spool's
    assert warm.retain_sec is None and warm.snapshot_bytes is None
    assert service.spool_bytes() == cold.snapshot_bytes
    # the snapshot is read inside the run, after it began
    begin = next(e for e in warm.tracer.events if e["ev"] == "run_begin")
    reads = [e for e in warm.tracer.events
             if e["ev"] == "span" and e["phase"] == "restore_read"]
    assert len(reads) == 1 and reads[0]["t0"] >= begin["t"]
    # zero new waves: the retained state is settled
    assert _wave_events(warm) == []
    assert not [e for e in warm.tracer.events if e["ev"] == "chunk"]
    restore = [e for e in warm.tracer.events if e["ev"] == "restore"]
    assert [r["wave"] for r in restore] == [11]
    # every property still settles exactly once in the warm trace
    verdicts = sorted((e["property"], e["kind"]) for e in warm.tracer.events
                      if e["ev"] == "verdict")
    assert verdicts == sorted((e["property"], e["kind"])
                              for e in cold.tracer.events
                              if e["ev"] == "verdict")
    # the finished runs hold no device state
    assert cold.checker._final is None and cold.checker._final_carry is None

    # an edited model (another fingerprint) runs cold
    other = service.check(["2pc", "check-gpu", "4"])
    assert other.state == "done" and other.unique == 1568
    assert not other.warm_start and len(_wave_events(other)) > 0


def test_warm_start_disabled_explores_again(tmp_path):
    service = _service(tmp_path, warm_start=False)
    a = service.check(["2pc", "check-gpu", "3"])
    b = service.check(["2pc", "check-gpu", "3"])
    assert a.unique == b.unique == 288
    assert not b.warm_start and len(_wave_events(b)) > 0
    assert b.snapshot_bytes is None


def _retained_pair(tmp_path, spawn):
    """A finished run of ``spawn()`` retained, and a fresh ``spawn()``
    resumed from the snapshot and traced: ``(cold, warm, events,
    manifest)``."""
    from stateright_tpu_torch import checkpoint

    cold = spawn()
    cold.keep_final_carry = True
    cold.join()
    path = str(tmp_path / "retained.ckpt")
    manifest = checkpoint.retain_final_snapshot(cold, path)
    warm = spawn()
    warm.resume_from(path)
    tr = telemetry.RunTracer()
    with tr.activate_thread():
        warm.join()
    validate_events(tr.events)
    return cold, warm, tr.events, manifest


@pytest.mark.parametrize("engine", ["sortmerge", "tiered", "hash"])
def test_retained_snapshot_of_a_finished_run_settles(tmp_path, engine):
    """``checkpoint.retain_final_snapshot`` (JAX checkpoint.py:407) for
    both engine families, the tiered visited set with both tiers: the
    resumed run settles with zero waves and the cold run's counts,
    depth, discovery fingerprints and paths. Increment 2 finishes by
    discovering every property, with a frontier left: the snapshot holds
    none."""
    from stateright_tpu_torch.cli import twopc_sizes
    from stateright_tpu_torch.models.increment import Increment
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    def spawn(model):
        b = model.checker()
        if engine == "hash":
            return b.spawn_hash(capacity=1 << 13, device="cpu")
        tier = dict(tier_hot_rows=32) if engine == "tiered" else {}
        return b.spawn_sortmerge(device="cpu", **twopc_sizes(4), **tier)

    for model in (TwoPhaseSys(4), Increment(2)):
        cold, warm, events, manifest = _retained_pair(
            tmp_path, lambda: spawn(model))
        assert manifest is not None
        assert (warm.unique_state_count(), warm.state_count(),
                warm.max_depth()) == (cold.unique_state_count(),
                                      cold.state_count(), cold.max_depth())
        assert warm.discovery_fingerprints() == cold.discovery_fingerprints()
        assert ({k: p.encode() for k, p in warm.discoveries().items()}
                == {k: p.encode() for k, p in cold.discoveries().items()})
        assert not [e for e in events if e["ev"] == "wave"]
        assert warm.metrics["waves"] == cold.metrics["waves"]
        if engine == "tiered" and isinstance(model, TwoPhaseSys):
            assert cold.metrics["tier_spills"] > 0
            assert manifest["tier"] is not None


def test_retention_refuses_a_tiered_run_without_its_cold_store(tmp_path):
    """JAX checkpoint.py:425-431: the device tier alone would warm-start
    from a subset, so a tiered run whose cold store is gone retains
    nothing, and neither does a run that raised."""
    from stateright_tpu_torch import checkpoint
    from stateright_tpu_torch.cli import twopc_sizes
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    c = TwoPhaseSys(4).checker().spawn_sortmerge(
        device="cpu", tier_hot_rows=32, **twopc_sizes(4))
    c.keep_final_carry = True
    c.join()
    assert c.metrics["tier_spills"] > 0
    c._final_carry[0].cold = None
    assert checkpoint.retain_final_snapshot(c, str(tmp_path / "x")) is None
    assert not (tmp_path / "x").exists()

    small = TwoPhaseSys(4).checker().spawn_sortmerge(
        device="cpu", capacity=64, frontier_capacity=64)
    small.keep_final_carry = True
    with pytest.raises(RuntimeError):
        small.join()
    assert checkpoint.retain_final_snapshot(small, str(tmp_path / "y")) \
        is None


# -- admission --------------------------------------------------------------


def test_admission_refuses_oversized_before_device_work(tmp_path):
    service = _service(tmp_path, device_budget_bytes=1024)
    s = service.check(["2pc", "check-gpu", "3"])
    assert s.state == "refused"
    assert "admission refused" in s.error and "REFUSED" in s.output
    # refused before any wave or kernel: the run never started
    assert s.checker is not None and not s.checker._done
    assert s.checker.metrics == {} and s.launches == {}
    assert not [e for e in s.tracer.events if e["ev"] in ("chunk", "wave")]
    # no in-flight bytes leaked from the refusal
    service.device_budget_bytes = 1 << 30
    ok = service.check(["2pc", "check-gpu", "3"])
    assert ok.state == "done" and ok.unique == 288


@pytest.mark.parametrize("argv", [
    ["2pc", "check-gpu", "3", "--trace"],
    ["2pc", "check-gpu", "3", "--device=cuda"],
    ["serve", "127.0.0.1:0"],
    ["2pc", "explore", "2"],
])
def test_session_lanes_refused(argv):
    with pytest.raises(ValueError):
        CheckService(device="cpu").check(argv)


def test_a_card_service_never_runs_a_session_on_the_cpu(tmp_path):
    """Without a card, a ``device="cuda"`` session fails with the
    engine's error (the JAX session's ``failed`` state, serve.py:540);
    it is not rerun on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the session would run on it")
    s = CheckService(spool_dir=str(tmp_path)).check(
        ["2pc", "check-gpu", "3"])
    assert s.state == "failed" and "CUDA" in s.error
    assert s.unique == 0 and "Done." not in s.output


# -- FIFO gate ----------------------------------------------------------------


def test_fifo_lock_is_arrival_ordered():
    lock = FifoLock()
    order = []
    lock.acquire()

    def waiter(i):
        def run():
            with lock:
                order.append(i)

        t = threading.Thread(target=run)
        t.start()
        deadline = time.monotonic() + 5.0
        while len(lock._waiters) < i + 1:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        return t

    threads = [waiter(i) for i in range(4)]
    lock.release()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert order == [0, 1, 2, 3]


# -- summary, artifact, and the JAX package's readers ----------------------


def test_serve_summary_and_artifact(tmp_path):
    from stateright_tpu.serve import serve_summary as jax_serve_summary
    from stateright_tpu_torch.artifacts import latest_serve_summary
    from stateright_tpu_torch.serve import write_serve_artifact

    service = _service(tmp_path)
    service.check(["2pc", "check-gpu", "3"])
    service.check(["2pc", "check-gpu", "3"])
    jsonl, _ = service.write_trace(root=str(tmp_path))
    assert "TRACE_r01" in jsonl
    events = telemetry.load_trace(jsonl)
    validate_events(events)
    summary = serve_summary(events)
    assert summary == jax_serve_summary(events)
    s0, s1 = summary["sessions"]
    assert s0["unique"] == s1["unique"] == 288
    assert s0["warm_start"] is False and s1["warm_start"] is True
    assert s0["time_to_verdict_sec"] is not None
    assert s1["time_to_verdict_sec"] is not None
    wvc = summary["warm_vs_cold"]
    assert [(w["cold_session"], w["warm_session"]) for w in wvc] == [
        (s0["session"], s1["session"])]
    assert wvc[0]["ttv_delta_sec"] is not None

    # the JAX package's report reads the port's trace unchanged
    (tmp_path / "jax").mkdir()
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "serve_report.py"),
         jsonl, "--json", "--root", str(tmp_path / "jax")],
        capture_output=True, text=True, timeout=TIMEOUT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert "serve report" in out.stdout and "warm vs cold" in out.stdout

    path = write_serve_artifact(summary, root=str(tmp_path),
                                metrics=service.metrics.snapshot())
    assert os.path.basename(path) == "SERVE_r01.json"
    ref = latest_serve_summary(root=str(tmp_path))
    assert ref["artifact"] == "SERVE_r01.json" and ref["sessions"] == 2
    assert ref["warm_vs_cold"]["warm_start"] is True


def test_serve_summary_rejects_non_service_trace():
    assert serve_summary([{"ev": "run_begin", "run": 0}]) is None


def test_make_server_requires_checker_or_registry():
    from stateright_tpu_torch.explorer.server import Snapshot, make_server

    with pytest.raises(ValueError, match="checker, a registry"):
        make_server(None, Snapshot(), "127.0.0.1", 0)


def test_same_session_as_the_jax_service(tmp_path):
    """One lane through JAX's ``CheckService`` and the port's: the same
    ``Done.`` line and discovery paths, and JAX's ``diff_traces`` finds
    no divergence between the two sessions' traces."""
    from stateright_tpu import telemetry as jt
    from stateright_tpu.serve import CheckService as JaxService

    jax = JaxService(spool_dir=str(tmp_path / "jax"),
                     warm_start=False).check(["2pc", "check-tpu", "3"])
    port = _service(tmp_path, warm_start=False).check(
        ["2pc", "check-gpu", "3"])
    assert jax.state == port.state == "done", (jax.error, port.error)
    assert _done_line(jax.output) == _done_line(port.output)
    assert (jax.output.split("sec=")[1].split("\n", 1)[1]
            == port.output.split("sec=")[1].split("\n", 1)[1])
    rep = jt.diff_traces(jax.tracer.events, port.tracer.events)
    assert rep["divergences"] == [], rep["divergences"][:5]


# -- batched sessions through the service -----------------------------------


def test_batched_sessions_pinned_counts_zero_bleed(tmp_path):
    service = _service(tmp_path, warm_start=False, batch_sessions=2,
                       batch_window_sec=30.0)
    sessions = _concurrent(service, [
        ["paxos", "check-gpu", "2"], ["paxos", "check-gpu", "2"],
        ["2pc", "check-gpu", "4"], ["2pc", "check-gpu", "4"]])
    pinned = {"paxos": 16668, "2pc": 1568}
    for s in sessions:
        assert s.state == "done", s.error
        assert s.unique == pinned[s.argv[0]]
        assert f"unique={pinned[s.argv[0]]}" in s.output
        assert s.batch is not None and s.batch["size"] == 2
    assert len({s.batch["group"] for s in sessions[:2]}) == 1
    assert len({s.batch["group"] for s in sessions[2:]}) == 1
    assert sessions[0].batch["group"] != sessions[2].batch["group"]
    for s, enc in zip(sessions, ("PaxosEncoded",) * 2
                      + ("TwoPhaseSysEncoded",) * 2):
        validate_events(s.tracer.events)
        begins = [e for e in s.tracer.events if e["ev"] == "run_begin"]
        assert [b["lane"]["encoding"] for b in begins] == [enc]
        assert {e.get("run") for e in s.tracer.events} == {0}
        assert _wave_events(s)[-1]["unique_total"] == pinned[s.argv[0]]
        marks = [e for e in s.tracer.events if e["ev"] == "batch"]
        assert len(marks) == 1 and marks[0]["size"] == 2
    merged = service.events()
    validate_events(merged)
    batches = serve_summary(merged)["batches"]
    assert len(batches) == 2
    for g in batches:
        assert g["size"] == 2 and len(g["sessions"]) == 2
        assert g["per_query_overhead_sec"] is not None


def test_batched_vs_solo_trace_diff_zero_divergence(tmp_path):
    service = _service(tmp_path, warm_start=False, batch_sessions=2,
                       batch_window_sec=30.0)
    batched = _concurrent(service, [["2pc", "check-gpu", "4"],
                                    ["2pc", "check-gpu", "4"]])
    solo = _service(tmp_path / "solo", warm_start=False).check(
        ["2pc", "check-gpu", "4"])
    assert solo.unique == 1568
    for s in batched:
        assert s.unique == 1568 and s.batch["size"] == 2
        rep = telemetry.diff_traces(s.tracer.events, solo.tracer.events)
        assert rep["divergences"] == []
        assert rep["latency"]["divergences"] == []
        assert rep["memory"]["divergences"] == []
        assert sorted(s.checker.discoveries()) == \
            sorted(solo.checker.discoveries())


def test_batch_early_settle_peels_out(tmp_path):
    """2pc rm=3 (11 waves) fuses with rm=4 (14 waves): the rm=3 seat
    peels out after fewer fused waves than rm=4 rides. Seat 0 leads, so
    the early settler joins second."""
    service = _service(tmp_path, warm_start=False, batch_sessions=2,
                       batch_window_sec=30.0)
    big, small = _concurrent(service, [["2pc", "check-gpu", "4"],
                                       ["2pc", "check-gpu", "3"]],
                             stagger_sec=1.0)
    assert big.state == "done" and big.unique == 1568
    assert small.state == "done" and small.unique == 288
    assert (big.batch["index"], small.batch["index"]) == (0, 1)
    assert big.batch["size"] == small.batch["size"] == 2

    def chunks(s):
        return [e for e in s.tracer.events
                if e["ev"] == "latency_profile"][-1]["chunks"]

    assert chunks(small) < chunks(big)


def test_batch_incompatible_shapes_fall_back_solo(tmp_path):
    service = _service(tmp_path, warm_start=False, batch_sessions=2,
                       batch_window_sec=0.5)
    inc, twopc = _concurrent(service, [["increment", "check-gpu", "2"],
                                       ["2pc", "check-gpu", "3"]])
    assert inc.state == "done" and twopc.state == "done"
    assert twopc.unique == 288
    for s in (inc, twopc):
        assert s.batch is None
        assert ("batch: no compatible peers arrived within the "
                "batching window") in s.output
    assert serve_summary(service.events())["batches"] == []


def test_batch_fused_admission_refusal(tmp_path):
    service = _service(tmp_path, warm_start=False, batch_sessions=2,
                       batch_window_sec=30.0, device_budget_bytes=1024)
    for s in _concurrent(service, [["2pc", "check-gpu", "3"],
                                   ["2pc", "check-gpu", "3"]]):
        assert "batch: fused plan of 2 session(s)" in s.output
        assert "falling back to solo FIFO" in s.output
        assert s.state == "refused" and "admission refused" in s.error
        # the solo admission raised inside the seat's run: no wave ran
        assert s.checker.metrics == {} and s.launches == {}
        assert not [e for e in s.tracer.events
                    if e["ev"] in ("chunk", "wave")]


# -- the snapshot spool's LRU ---------------------------------------------


def test_snapshot_spool_budget_evicts_lru(tmp_path):
    service = _service(tmp_path, snapshot_budget_bytes=1)
    a = service.check(["2pc", "check-gpu", "3"])
    b = service.check(["2pc", "check-gpu", "4"])
    assert a.unique == 288 and b.unique == 1568
    assert b.snapshot_evictions
    assert service.spool_bytes() > 1
    c = service.check(["2pc", "check-gpu", "3"])
    assert c.unique == 288 and not c.warm_start
    assert len(_wave_events(c)) > 0
    merged = service.events()
    validate_events(merged)
    ev = [e for e in merged if e["ev"] == "snapshot_evict"]
    assert ev and (ev[0]["key"], ev[0]["bytes"]) == b.snapshot_evictions[0]


def test_own_spool_made_at_first_retention_and_removed_on_close():
    """Without a ``spool_dir`` the service makes its own at the first
    retention; :meth:`CheckService.close` removes it with its snapshots,
    and a re-check after that runs cold."""
    service = CheckService(device="cpu")
    assert service.spool_dir is None
    a = service.check(["2pc", "check-gpu", "3"])
    spool = service.spool_dir
    assert a.unique == 288 and a.snapshot_bytes > 0
    assert os.listdir(spool) and service.spool_bytes() > 0
    service.close()
    assert not os.path.exists(spool) and service.spool_bytes() == 0
    b = service.check(["2pc", "check-gpu", "3"])
    assert b.unique == 288 and not b.warm_start
    assert len(_wave_events(b)) > 0
    service.close()
    assert service.spool_dir is None


def test_a_failed_warm_read_runs_cold(tmp_path):
    """A spooled snapshot that is gone by the time the warm run reads it
    (a race with its eviction): the session runs cold, with its counts,
    and retains a snapshot anew."""
    service = _service(tmp_path)
    a = service.check(["2pc", "check-gpu", "3"])
    for name in os.listdir(tmp_path):
        os.remove(tmp_path / name)
    b = service.check(["2pc", "check-gpu", "3"])
    assert b.state == "done" and b.unique == a.unique == 288
    assert not b.warm_start and len(_wave_events(b)) == 11
    assert b.snapshot_bytes == a.snapshot_bytes
    c = service.check(["2pc", "check-gpu", "3"])
    assert c.warm_start and _wave_events(c) == []


# -- the CLI: --connect and serve ---------------------------------------------


def test_connect_client_and_daemon(tmp_path):
    """``client_main`` (``--connect``) against a CPU service's server: the
    report of the same lane run in this process; a refused lane exits 1
    with the reason, a dead address 2. Then ``python -m
    stateright_tpu_torch serve --device cpu`` in a process of its own
    answers ``--connect`` from another, cold and then warm, and removes
    its snapshot spool when it is terminated."""
    import contextlib
    import io
    import socket

    from stateright_tpu_torch.serve import client_main

    service = _service(tmp_path)
    server, port = _serving(service)
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = client_main(f"127.0.0.1:{port}", ["2pc", "check-gpu", "3"],
                             timeout=TIMEOUT)
        assert rc == 0 and "unique=288," in buf.getvalue()
        with contextlib.redirect_stdout(io.StringIO()):
            assert client_main(f"127.0.0.1:{port}", ["nope"],
                               timeout=TIMEOUT) == 1
    finally:
        server.shutdown()
        server.server_close()

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    assert client_main(f"127.0.0.1:{free}", ["2pc", "check-gpu", "3"],
                       timeout=5) == 2

    daemon_tmp = tmp_path / "daemon_tmp"
    daemon_tmp.mkdir()
    env = dict(os.environ, PYTHONPATH=ROOT, TMPDIR=str(daemon_tmp))
    daemon = subprocess.Popen(
        [sys.executable, "-m", "stateright_tpu_torch", "serve",
         f"127.0.0.1:{free}", "--device", "cpu"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + TIMEOUT
        while True:
            try:
                _get(free, "/.serve/sessions")
                break
            except OSError:
                assert daemon.poll() is None, daemon.stdout.read()
                assert time.monotonic() < deadline, "the daemon never served"
                time.sleep(0.1)
        outs = []
        for _ in range(2):
            p = subprocess.run(
                [sys.executable, "-m", "stateright_tpu_torch",
                 f"--connect=127.0.0.1:{free}", "2pc", "check-gpu", "3"],
                cwd=str(tmp_path), env=env, capture_output=True, text=True,
                timeout=TIMEOUT)
            assert p.returncode == 0, p.stderr
            outs.append(p.stdout)
        assert all("unique=288," in o for o in outs)
        block = _get(free, "/.serve/sessions")
        assert [s["warm_start"] for s in block["sessions"]] == [False, True]
        assert [p.name for p in daemon_tmp.iterdir()
                if p.name.startswith("stpu_serve_")]
    finally:
        daemon.terminate()
        try:
            daemon.wait(timeout=30)
        except subprocess.TimeoutExpired:
            daemon.kill()
            daemon.wait(timeout=30)
    assert daemon.returncode == 0, daemon.stdout.read()
    assert not [p.name for p in daemon_tmp.iterdir()
                if p.name.startswith("stpu_serve_")]


def test_connect_flag_parsing():
    with pytest.raises(SystemExit, match="needs an address"):
        cli.main(["--connect", "2pc", "check-gpu", "3"])
    assert cli._pop_connect_flag(["2pc", "--connect=h:1", "check-gpu"]) == (
        "h:1", ["2pc", "check-gpu"])
