"""The port's operator tools (stateright_tpu_torch/tools/) against the
repository's JAX tools.

* The crash matrix at ``--device cpu --count 4 --seed 0`` (every cell
  but the ``kill`` cell's processes, the hang at 3 s under JAX's 1 s
  watchdog floor) lands each cell on the verdict and count of JAX's
  committed ``CKPT_r02.json`` (1,568; ``mesh_degrade`` 8,832 on 7
  shards with no counter divergence), and
  ``artifacts.latest_ckpt_summary`` reads its artifact as JAX's does.
  The whole tool with its ``kill`` cell (two
  processes) and ``--trace`` at rm=3 is ``slow``, as JAX's
  ``tests/test_checkpoint.py:519-522`` is.
* ``trace_diff`` and each reader print what the JAX tool prints on the
  same port trace, rollup, endpoint or artifact and exit with the same
  code (the JAX tool loaded in-process, as ``tests/test_metrics.py``'s
  ``_load_tool`` does).
* The load test: the A/B's two arms agree, and the ``--sustained``
  smoke (ramp 1 / spike 2 / drain 1 of ``2pc check-gpu 3`` on a CPU
  service, 288) serves JAX's required families less the program-LRU
  ones and passes its SLO gate (JAX ``tests/test_metrics.py:525-560``).
* ``--waves-per-sync=N`` is refused on a host lane with JAX's message
  and, on a device lane, puts the snapshots every K·N waves with the
  counts unchanged.
* Outside a git checkout a snapshot's code identity is a hash of the
  package's sources, so the matrix's ``stale_sha`` cell is refused
  there too.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from stateright_tpu_torch import checkpoint, telemetry
from stateright_tpu_torch.cli import main as port_main
from stateright_tpu_torch.tools import crash_matrix, latency_report, \
    mem_report, serve_loadtest, serve_report, shard_report, slo_report, \
    trace_diff

ROOT = Path(__file__).resolve().parents[1]
#: JAX's committed crash matrix (2pc rm=4, seed 0, --mesh-degrade)
CKPT_R02 = json.loads((ROOT / "CKPT_r02.json").read_text())
#: seconds any one thread or subprocess may take here
TIMEOUT_SEC = 120

PORT_TOOLS = {"trace_diff": trace_diff, "latency_report": latency_report,
              "mem_report": mem_report, "shard_report": shard_report,
              "serve_report": serve_report, "slo_report": slo_report}


def _load_tool(name):
    """The repository's ``tools/<name>.py``, imported in-process."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _call(fn):
    """``(exit code, stdout)`` of ``fn()``, which returns or raises
    SystemExit."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            code = fn()
        except SystemExit as exc:
            code = exc.code
    return code or 0, out.getvalue()


def _jax_tool(name, argv):
    tool = _load_tool(name)
    old = sys.argv
    sys.argv = [f"{name}.py"] + list(argv)
    try:
        return _call(tool.main)
    finally:
        sys.argv = old


def _same(name, argv, code=None):
    """The port tool and the JAX tool on ``argv``: equal stdout and exit
    code (``code`` when given). Returns the stdout."""
    port = _call(lambda: PORT_TOOLS[name].main(list(argv)))
    jax = _jax_tool(name, argv)
    assert port == jax, (name, argv, port, jax)
    if code is not None:
        assert port[0] == code, (name, argv, port)
    return port[1]


def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port_main(list(argv))
    return out.getvalue()


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """Port traces: ``2pc check-gpu 3`` (plain, and twice with its
    fetches blocked 0.1 s / 1 s a wave for a regression pair), a 2pc
    rm=3 run on two shards, and a rollup of ``2pc check-gpu 3``."""
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    d = tmp_path_factory.mktemp("tools")
    _cli(["2pc", "check-gpu", "3", "--device", "cpu", "--trace",
          f"--trace-root={d}", "--metrics-interval=60",
          f"--metrics-path={d / 'm.jsonl'}"])
    paths = {"plain": str(d / "TRACE_r01.jsonl"),
             "rollup": str(d / "m.jsonl")}
    plain = telemetry.load_trace(paths["plain"])

    def blocked(sec):
        return [dict(e, fetch_sec=e["fetch_sec"] + sec)
                if e["ev"] == "chunk" else e for e in plain]

    tr = telemetry.RunTracer()
    with tr.activate():
        TwoPhaseSys(rm_count=3).checker().spawn_sharded_sortmerge(
            devices=["cpu"] * 2, capacity=1 << 10).join()
    for name, evs in (("fast", blocked(0.1)), ("slow", blocked(1.0)),
                      ("mesh", tr.events)):
        t = telemetry.RunTracer()
        t.events = evs
        paths[name] = t.write_jsonl(str(d / f"{name}.jsonl"))
    return paths


# -- the crash matrix ---------------------------------------------------------


def _matrix_args(tmp_path, *extra):
    return crash_matrix.parse_args(
        ["--device", "cpu", "--count", "4", "--seed", "0", "--json",
         "--root", str(tmp_path), "--hang-sec", "3", *extra])


def test_crash_matrix_cells_equal_the_committed_jax_matrix(tmp_path):
    """Every in-process cell and the traced 8-shard degrade pair land on
    ``CKPT_r02.json``'s verdict and count."""
    from stateright_tpu import artifacts as jax_artifacts
    from stateright_tpu_torch import artifacts

    args = _matrix_args(tmp_path, "--mesh-degrade")
    cells = tuple(c for c in crash_matrix.CELLS if c != "kill")
    code, doc = crash_matrix.run_matrix(args, cells=cells)
    assert code == 0 and doc["clean"]
    assert doc["baseline_unique"] == CKPT_R02["baseline_unique"] == 1568
    assert doc["kill_chunk"] == CKPT_R02["kill_chunk"] == 2
    assert set(CKPT_R02) <= set(doc)
    assert set(doc["cells"]) == set(CKPT_R02["cells"]) - {"kill"}
    for name, cell in doc["cells"].items():
        want = CKPT_R02["cells"][name]
        for key in ("verdict", "count", "error", "to_shards",
                    "from_shards", "counter_divergences"):
            assert cell.get(key) == want.get(key), (name, key, cell)
        assert cell["wall_sec"] >= 0
    assert doc["cells"]["hang_watchdog"]["verdict"] == "recovered"
    md = doc["mesh_degrade"]
    for key in ("baseline_unique", "degraded_unique", "from_shards",
                "to_shards", "counter_divergences", "diff_ok",
                "fault_chunk", "fault_shard", "degrade_wave"):
        assert md[key] == CKPT_R02["mesh_degrade"][key], key
    assert doc["degrade_cells"] == CKPT_R02["degrade_cells"]
    assert doc["snapshot_bytes"] > 0 and doc["memplan_resident_bytes"] > 0
    assert (tmp_path / "CKPT_r01.json").exists()
    assert (tmp_path / md["degraded_trace"]).exists()
    summary = artifacts.latest_ckpt_summary(str(tmp_path))
    assert summary == jax_artifacts.latest_ckpt_summary(str(tmp_path))
    assert summary["clean"] and summary["cells"]["stale_sha"] == "refused"
    assert artifacts.latest_ckpt_summary(str(tmp_path / "none")) is None


def test_crash_matrix_refuses_bad_arguments():
    with pytest.raises(SystemExit):
        crash_matrix.parse_args(["--checkpoint-every", "0"])
    with pytest.raises(SystemExit):
        crash_matrix.parse_args(["--device", "tpu"])


@pytest.mark.slow
def test_crash_matrix_tool_kills_and_resumes(tmp_path):
    """The whole tool in a process of its own at 2pc rm=3 with
    ``--trace``: the ``kill`` cell's process exits 137 after its
    snapshot, the resumed process reaches 288, and its trace diffs
    against the baseline's with no divergence."""
    out = subprocess.run(
        [sys.executable, "-m", "stateright_tpu_torch.tools.crash_matrix",
         "--device", "cpu", "--count", "3", "--trace", "--json", "--root",
         str(tmp_path), "--hang-sec", "3"],
        cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT_SEC,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stdout + out.stderr
    doc = json.loads((tmp_path / "CKPT_r01.json").read_text())
    kill = doc["cells"]["kill"]
    assert (kill["verdict"], kill["resumed"], kill["kill_wave"]) == (
        "recovered", 288, 5)
    assert kill["trace_diff"]["counter_divergences"] == 0
    assert kill["trace_diff"]["resume_wave"] == 6
    assert all(c["verdict"] in crash_matrix.GOOD_VERDICTS
               for c in doc["cells"].values())


def test_snapshot_identity_outside_a_git_checkout(tmp_path, monkeypatch):
    """Without ``.git`` the code's identity is the hash of the package's
    sources: stable, and changed by any source byte."""
    pkg = tmp_path / "pkg"
    (pkg / "csrc").mkdir(parents=True)
    (pkg / "a.py").write_text("x = 1\n")
    (pkg / "csrc" / "k.cu").write_text("// k\n")
    (pkg / "notes.txt").write_text("not code\n")
    sha = checkpoint.source_tree_sha.__wrapped__(str(pkg))
    assert sha.startswith("tree-")
    assert checkpoint.source_tree_sha.__wrapped__(str(pkg)) == sha
    (pkg / "notes.txt").write_text("still not code\n")
    assert checkpoint.source_tree_sha.__wrapped__(str(pkg)) == sha
    (pkg / "csrc" / "k.cu").write_text("// k2\n")
    assert checkpoint.source_tree_sha.__wrapped__(str(pkg)) != sha
    monkeypatch.setattr(checkpoint, "_repo_root", lambda: str(tmp_path))
    assert checkpoint._git_sha() == checkpoint.source_tree_sha(
        os.path.dirname(checkpoint.__file__))


# -- --waves-per-sync ---------------------------------------------------------


def test_waves_per_sync_scales_the_checkpoint_cadence(tmp_path):
    with pytest.raises(SystemExit, match="need a device engine: use a "
                       "check-gpu lane"):
        port_main(["2pc", "check", "2", "--waves-per-sync=2"])
    with pytest.raises(SystemExit, match="must be >= 1"):
        port_main(["2pc", "check-gpu", "2", "--waves-per-sync=0"])
    snap = tmp_path / "w.ckpt"
    out = _cli(["2pc", "check-gpu", "3", "--device", "cpu",
                "--checkpoint-every=1", "--waves-per-sync=2",
                f"--checkpoint-path={snap}", "--trace",
                f"--trace-root={tmp_path}"])
    assert "Done. states=1146, unique=288, depth=11" in out
    events = telemetry.load_trace(str(tmp_path / "TRACE_r01.jsonl"))
    waves = [e["wave"] for e in events if e["ev"] == "checkpoint"]
    assert waves == [2, 4, 6, 8, 10]
    manifest, _ = checkpoint.load_snapshot(str(snap))
    assert manifest["waves_per_sync"] == 2
    # resumed from the wave-10 snapshot: the same counts
    out = _cli(["2pc", "check-gpu", "3", "--device", "cpu", "--resume",
                "--waves-per-sync=2", f"--checkpoint-path={snap}"])
    assert ": wave 10, depth 11" in out
    assert "Done. states=1146, unique=288, depth=11" in out


# -- trace_diff and the readers -----------------------------------------------


def test_trace_diff_equals_jax(traces, tmp_path):
    assert "verdict: OK" in _same(
        "trace_diff", [traces["plain"], traces["plain"]], 0)
    assert "REGRESSION" in _same(
        "trace_diff", [traces["fast"], traces["slow"], "--threshold",
                       "0.05"], 1)
    _same("trace_diff", [traces["mesh"], traces["mesh"], "--run-a", "0",
                         "--run-b", "0"], 0)
    _same("trace_diff", [traces["plain"], str(tmp_path / "missing")], 2)


def test_latency_and_memory_reports_equal_jax(traces, tmp_path):
    assert "time to verdict" in _same("latency_report",
                                      [traces["plain"]], 0)
    assert "resident-buffer ledger" in _same("mem_report",
                                             [traces["plain"]], 0)
    _same("mem_report", [traces["mesh"], "--chunks", "3"], 0)
    for name in ("latency_report", "mem_report"):
        _same(name, [traces["plain"], "--run", "7"], 2)
        _same(name, [str(tmp_path / "missing")], 2)
    code, out = _call(lambda: latency_report.main(
        [traces["plain"], "--json", "--root", str(tmp_path)]))
    assert code == 0 and (tmp_path / "LAT_r01.json").exists()
    code, out = _call(lambda: mem_report.main(
        [traces["plain"], "--json", "--root", str(tmp_path)]))
    assert code == 0 and (tmp_path / "MEM_r01.json").exists()


def test_shard_report_equals_jax(traces):
    assert "shard balance: run #0, 2 shards" in _same(
        "shard_report", [traces["mesh"], "--waves", "4"], 0)
    _same("shard_report", [traces["plain"]], 2)


def test_slo_report_equals_jax(traces, tmp_path):
    rollup = traces["rollup"]
    for argv in (["--max-ttv-p99", "600"], ["--max-ttv-p99", "0.000001"],
                 ["--max-refusal-rate", "0", "--max-queue-wait-p99", "5"],
                 ["--min-cache-hit-rate", "0.5"]):
        code, _ = _call(lambda: slo_report.main(["--rollup", rollup]
                                                + argv))
        _same("slo_report", ["--rollup", rollup] + argv, code)
    assert "VIOLATED" in _same(
        "slo_report", ["--rollup", rollup, "--max-ttv-p99", "0.000001"], 1)
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"bogus_objective": 1}))
    _same("slo_report", ["--rollup", rollup, "--spec", str(spec)], 2)
    _same("slo_report", ["--rollup", rollup], 2)
    _same("slo_report", ["--rollup", str(tmp_path / "missing.jsonl"),
                         "--max-ttv-p99", "1"], 2)
    code, _ = _call(lambda: slo_report.main(
        ["--rollup", rollup, "--max-ttv-p99", "600", "--json", "--root",
         str(tmp_path)]))
    assert code == 0 and (tmp_path / "SLO_r01.json").exists()


def test_slo_report_scrapes_a_live_service():
    from stateright_tpu_torch.serve import CheckService

    service = CheckService(device="cpu", warm_start=False)
    server = service.http_server("127.0.0.1", 0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        assert service.check(["2pc", "check-gpu", "2"]).state == "done"
        url = f"http://127.0.0.1:{server.server_address[1]}"
        assert "gate: OK" in _same(
            "slo_report", ["--url", url, "--max-ttv-p99", "600",
                           "--max-refusal-rate", "0"], 0)
        _same("slo_report", ["--url", url + "/.metrics",
                             "--max-ttv-p99", "0.000001"], 1)
    finally:
        server.shutdown()
        server.server_close()
        t.join(TIMEOUT_SEC)
    assert not t.is_alive()


# -- the load test --------------------------------------------------------------


def test_required_families_are_jax_less_the_program_lru():
    jax_tool = _load_tool("serve_loadtest")
    assert serve_loadtest.PROGRAM_LRU_FAMILIES == (
        "stpu_serve_program_evictions_total",)
    assert serve_loadtest.REQUIRED_FAMILIES == tuple(
        f for f in jax_tool.REQUIRED_FAMILIES
        if f not in serve_loadtest.PROGRAM_LRU_FAMILIES)


def test_load_test_ab_arms_agree():
    code, summary = serve_loadtest.run_ab(["2pc", "check-gpu", "3"], 2,
                                          device="cpu")
    assert code == 0
    assert [s["unique"] for s in summary["sessions"]] == [288, 288]
    assert [s["unique"] for s in summary["fifo_baseline"]["sessions"]] \
        == [288, 288]
    assert summary["batches"] and summary["batches"][0]["size"] == 2
    lt = summary["loadtest"]
    assert lt["clients"] == 2 and lt["batched_per_query_overhead_sec"] >= 0


def test_sustained_loadtest_smoke(tmp_path, traces):
    """ramp(1) -> spike(2) -> drain(1) of ``2pc check-gpu 3`` against one
    live CPU service over HTTP: the scrape serves the required families,
    every count is the solo run's 288, the quantiles come out both ways,
    the SLO gate passes, the artifacts land, and ``serve_report`` reads
    the service trace as JAX's does (and refuses a plain run's)."""
    code, doc = serve_loadtest.run_sustained(
        ["2pc", "check-gpu", "3"], [("ramp", 1), ("spike", 2),
                                     ("drain", 1)],
        dict(max_ttv_p99_sec=600.0, max_refusal_rate=0.0,
             min_cache_hit_rate=0.5),
        json_out=True, root=str(tmp_path), device="cpu")
    assert code == 0
    assert doc["solo_unique"] == 288
    assert doc["evaluation"]["ok"] is True
    assert [p["phase"] for p in doc["phases"]] == ["ramp", "spike", "drain"]
    for p in doc["phases"]:
        assert p["sessions"] == p["clients"]
        assert p["ttv_p50_sec"] is not None
        assert p["ttv_p99_bucket_sec"] is not None
    assert {"active_sessions", "queue_depth"} <= set(doc["status_metrics"])
    serve = json.loads((tmp_path / "SERVE_r01.json").read_text())
    assert serve["sustained"]["solo_unique"] == 288
    for fam in serve_loadtest.REQUIRED_FAMILIES:
        assert fam in serve["metrics"], fam
    slo = json.loads((tmp_path / "SLO_r01.json").read_text())
    assert slo["evaluation"]["ok"] is True
    assert slo["serve_artifact"] == "SERVE_r01.json"
    trace = str(tmp_path / slo["trace"])
    assert "serve report: 4 session(s)" in _same("serve_report", [trace], 0)
    _same("serve_report", [traces["plain"]], 2)
    code, _ = _call(lambda: serve_report.main(
        [trace, "--json", "--root", str(tmp_path)]))
    assert code == 0 and (tmp_path / "SERVE_r02.json").exists()


def test_concurrent_snapshot_writes_to_one_path(tmp_path):
    """Threads of one process writing one snapshot path at once (the
    service retaining concurrent sessions of one model, found by the
    sustained load test on the card): every write commits, and the file
    left is whole."""
    import numpy as np

    path = str(tmp_path / "warm.ckpt")
    n = 8
    barrier = threading.Barrier(n)
    errors = []

    def write(i):
        buffers = {"vkeys": np.full(1 << 20, i, dtype=np.int64)}
        try:
            barrier.wait(TIMEOUT_SEC)
            checkpoint._write_file(path, {"wave": i}, buffers)
        except Exception as exc:
            errors.append(exc)

    threads = [threading.Thread(target=write, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_SEC)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    manifest, buffers = checkpoint._read_raw(path)
    assert (buffers["vkeys"] == manifest["wave"]).all()
    assert os.listdir(tmp_path) == ["warm.ckpt"]
