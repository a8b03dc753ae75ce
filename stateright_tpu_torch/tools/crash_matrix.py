"""Crash matrix: the end-to-end proof that checkpoint and resume recover —
the port of the repository's ``tools/crash_matrix.py`` over the port's
``checkpoint``, ``faultinject`` and ``telemetry``.

Runs every cell of the fault-injection matrix against one workload and
gives each a verdict: **recovered** (a kill or a device fault, resumed
or retried to the baseline's exact count), **refused** (a torn snapshot
or a stale manifest, refused with the named ``Snapshot*`` error, or a
hang refused with ``WatchdogTimeout``) or **continue-degraded** (a
persistent shard fault: the supervisor dropped the shard, re-sharded
the last snapshot onto the survivors and the degraded run reached the
same count). Anything else fails the matrix: never a silent wrong
answer, never a hang.

* ``kill`` — a ``python -m stateright_tpu_torch … check-gpu`` process
  with ``STPU_FAULTS=kill@chunk_boundary:W`` exits 137 right after a
  snapshot (``os._exit``, no cleanup); a second process ``--resume``\\ s
  from it and must reach the baseline count;
* ``device_fault`` — an injected mid-wave raise under supervision
  (checkpoint.py ``supervised_run``) recovers in one join;
* ``torn_truncate`` / ``torn_flip`` — a damaged snapshot is refused with
  ``SnapshotCorruptError``;
* ``stale_sha`` / ``stale_encoding`` — a rewritten manifest is refused
  with ``SnapshotStaleError``;
* ``shard_fault_degrade`` — a persistent fault on shard 1 of
  ``spawn_sharded_sortmerge`` at S = 2 under ``degrade_on_fault``
  finishes on one shard at the baseline count;
* ``collective_raise`` — an injected raise at the exchange's
  ``collective_seam`` recovers like any wave fault;
* ``hang_watchdog`` — an injected hang (a sleep, no exception) under an
  armed watchdog recovers from the snapshot or raises
  ``WatchdogTimeout`` naming the wave.

``--mesh-degrade`` adds the traced pair: 2pc rm=5 over 8 shards with a
persistent fault on shard 5 degrades to 7 shards and reaches 8,832, and
``diff_traces`` against the uninterrupted traced run finds no counter
divergence. ``--trace`` traces the baseline and the resumed run of the
``kill`` cell and diffs them. ``--json`` writes an auto-numbered
``CKPT_r*.json`` under ``--root`` with the JAX tool's keys.

Where the port differs from the JAX tool:

* **Chunks are JAX's** on the single-device engine (checkers/chunk.py):
  its cells run chunks of ``--waves-per-sync`` waves, a snapshot every
  ``--checkpoint-every`` chunks, the kill at the end of the chunk right
  after the seeded snapshot and the mid-chunk faults in the chunk after
  it, the chunks where JAX's fire. The sharded engines run one wave a
  chunk, so the mesh cells count the same places in waves.
* The runs take the sizes of the port's ``check-gpu`` lanes, and run on
  the CUDA device unless ``--device cpu`` (passed to every process);
  the mesh cells put their shards on that device.
* The baseline runs the CLI lane in this process; the seeded
  fault-free run is its count.
* The torn and stale cells damage the ``device_fault`` cell's last
  snapshot, so they do not need the ``kill`` cell's processes.
* The mesh cells run the workload's own model.

    python -m stateright_tpu_torch.tools.crash_matrix --device cpu --count 4
    python -m stateright_tpu_torch.tools.crash_matrix --count 9 --waves-per-sync 1 --checkpoint-every 4 --trace --json
    python -m stateright_tpu_torch.tools.crash_matrix --device cpu --mesh-degrade --json --root /tmp/ckpt

Exit status: 0 every cell recovered, refused or continue-degraded, 1 any
cell failed, 2 bad input (the baseline run failed).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

#: the directory the package sits in (the processes' import root)
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_DONE_RE = re.compile(r"Done\. states=(\d+), unique=(\d+)")

#: every cell, in the order the matrix runs them (``mesh_degrade`` only
#: with ``--mesh-degrade``)
CELLS = ("kill", "device_fault", "torn_truncate", "torn_flip", "stale_sha",
         "stale_encoding", "shard_fault_degrade", "collective_raise",
         "hang_watchdog")

#: the verdicts a cell may land on
GOOD_VERDICTS = ("recovered", "refused", "continue-degraded")

#: seconds one CLI process may take
CLI_TIMEOUT_SEC = 1800


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="fault-injection crash matrix over the "
        "checkpoint/resume path"
    )
    ap.add_argument("--workload", choices=("2pc", "paxos"),
                    default="2pc")
    ap.add_argument("--count", type=int, default=4,
                    help="model size (2pc RMs / paxos clients; "
                    "default 4)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the kill/fault chunk choice "
                    "(faultinject.chunk_for_seed)")
    ap.add_argument("--chunks-hint", type=int, default=5,
                    help="upper bound fed to the seeded chunk pick "
                    "(keep below the workload's real chunk count)")
    ap.add_argument("--waves-per-sync", type=int, default=2,
                    help="waves in one of JAX's chunks, the unit of "
                    "the seeded pick (default 2)")
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    help="a snapshot every N chunks (default 1)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where every run goes (default cuda: no "
                    "fallback to the CPU)")
    ap.add_argument("--hang-sec", type=float, default=25.0,
                    help="the injected hang's seconds (default 25)")
    ap.add_argument("--watchdog-floor-sec", type=float, default=1.0,
                    help="the watchdog deadline's floor (default 1)")
    ap.add_argument("--trace", action="store_true",
                    help="trace the baseline + resumed runs and embed "
                    "the trace_diff zero-divergence verdict")
    ap.add_argument("--json", action="store_true",
                    help="write an auto-numbered CKPT_r*.json "
                    "artifact")
    ap.add_argument("--root", default=None,
                    help="artifact directory (default: the repo root)")
    ap.add_argument("--mesh-degrade", action="store_true",
                    help="additionally run the traced 8-shard 2pc "
                    "rm=5 degrade pair (TRACE artifacts + "
                    "zero-divergence diff embedded in the JSON)")
    args = ap.parse_args(argv)
    for name in ("count", "chunks_hint", "waves_per_sync",
                 "checkpoint_every"):
        if getattr(args, name) < 1:
            ap.error(f"--{name.replace('_', '-')} must be >= 1")
    return args


def _cli_env(faults: str | None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_PKG_PARENT, env.get("PYTHONPATH")) if p)
    if faults:
        env["STPU_FAULTS"] = faults
    else:
        env.pop("STPU_FAULTS", None)
    return env


def _traces(root: str) -> set:
    return {f for f in os.listdir(root)
            if f.startswith("TRACE_r") and f.endswith(".jsonl")}


def _unique(stdout: str):
    m = _DONE_RE.search(stdout)
    return int(m.group(2)) if m else None


def _run_cli(args: list[str], root: str, faults: str | None = None):
    """One ``python -m stateright_tpu_torch`` process: ``(completed
    process, unique count or None, the TRACE files it wrote in
    root)``."""
    before = _traces(root)
    proc = subprocess.run(
        [sys.executable, "-m", "stateright_tpu_torch"] + args,
        cwd=_PKG_PARENT, env=_cli_env(faults), capture_output=True,
        text=True, timeout=CLI_TIMEOUT_SEC)
    return proc, _unique(proc.stdout), sorted(_traces(root) - before)


def _run_main(args: list[str], root: str):
    """The CLI lane in this process: ``(stdout, unique count or None,
    the TRACE files it wrote in root)``."""
    from ..cli import main

    before = _traces(root)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(list(args))
    return out.getvalue(), _unique(out.getvalue()), sorted(
        _traces(root) - before)


def _model(workload: str, count: int):
    """``(model, sizes)``: the workload at the sizes of its ``check-gpu``
    lane (cli.py)."""
    from ..cli import twopc_sizes

    if workload == "2pc":
        from ..models.two_phase_commit import TwoPhaseSys

        return TwoPhaseSys(rm_count=count), twopc_sizes(count)
    from ..models.paxos import PaxosModelCfg, paxos_model
    from ..models.paxos_tpu import STRUCTURAL_SIZES

    cfg = PaxosModelCfg(client_count=count, server_count=3)
    return paxos_model(cfg), dict(track_paths=count <= 2,
                                  **STRUCTURAL_SIZES[count])


def _spawn(args, **kw):
    model, sizes = _model(args.workload, args.count)
    return model.checker().spawn_sortmerge(device=args.device, **sizes,
                                           **kw)


def _spawn_mesh(args, n_shards: int, **kw):
    model, sizes = _model(args.workload, args.count)
    return model.checker().spawn_sharded_sortmerge(
        devices=[args.device] * n_shards, **sizes, **kw)


def _join_quiet(checker):
    """Join with the supervisor's recovery warnings silenced (the
    verdict says what happened)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        checker.join()
    return checker


def _mesh_degrade_proof(args, root: str, cell) -> dict:
    """The traced pair (``--mesh-degrade``): 2pc rm=5 over 8 shards on
    ``args.device``, a persistent fault on shard 5 from JAX's chunk 3 (2
    waves a chunk, a snapshot every chunk), must degrade and reach the
    uninterrupted traced run's 8,832 with no counter divergence. Writes
    the TRACE pair under ``root`` and returns the block the artifact
    embeds."""
    from .. import faultinject
    from ..models.two_phase_commit import TwoPhaseSys
    from ..telemetry import RunTracer, diff_traces, validate_events, \
        write_artifacts

    def spawn(**kw):
        return TwoPhaseSys(rm_count=5).checker().spawn_sharded_sortmerge(
            devices=[args.device] * 8, capacity=1 << 12,
            frontier_capacity=512, track_paths=True, **kw)

    fault_chunk, fault_shard, wps = 3, 5, 2
    print("mesh degrade acceptance: traced 2pc rm=5 S=8, "
          f"persistent shard fault (shard {fault_shard}) from chunk "
          f"{fault_chunk}")
    t0 = time.monotonic()
    tr_base = RunTracer()
    with tr_base.activate():
        b = spawn().join()
    base_n = b.unique_state_count()
    validate_events(tr_base.events)
    jsonl_a, _ = write_artifacts(tr_base, root=root)
    print(f"  baseline: {base_n:,} states "
          f"({os.path.basename(jsonl_a)})")

    tmp = tempfile.mkdtemp(prefix="stpu_torch_mesh_degrade_")
    c = spawn(checkpoint_every=wps,
              checkpoint_path=os.path.join(tmp, "mesh.ckpt"))
    c.degrade_on_fault = True
    c.retry_backoff_sec = 0.01
    tr_deg = RunTracer()
    faultinject.arm("shard_fault", "mid_chunk", fault_chunk * wps,
                    shard=fault_shard)
    err = None
    try:
        with tr_deg.activate():
            _join_quiet(c)
    except Exception as exc:
        err = f"{type(exc).__name__}: {exc}"
    finally:
        faultinject.disarm_all()
        shutil.rmtree(tmp, ignore_errors=True)
    validate_events(tr_deg.events)
    jsonl_b, _ = write_artifacts(tr_deg, root=root)
    wall = round(time.monotonic() - t0, 3)
    if err is not None:
        cell("mesh_degrade", "raised", error=err,
             degraded_trace=os.path.basename(jsonl_b), wall_sec=wall)
        return dict(error=err)
    n = c.unique_state_count()
    rep = diff_traces(tr_base.events, tr_deg.events)
    degraded = bool(rep["degrades_b"]) and c.n_shards < 8
    good = (n == base_n and degraded
            and not rep["divergences"] and rep["ok"])
    cell("mesh_degrade", "continue-degraded" if good else "count_mismatch",
         count=n, baseline=base_n, to_shards=c.n_shards,
         counter_divergences=len(rep["divergences"]), wall_sec=wall)
    print(f"  trace_diff: {os.path.basename(jsonl_a)} vs "
          f"{os.path.basename(jsonl_b)} — "
          f"{len(rep['divergences'])} counter divergences, "
          f"degraded at wave "
          f"{rep['degrades_b'][0]['wave'] if rep['degrades_b'] else '-'}, "
          f"{'OK' if rep['ok'] else 'FAIL'}")
    return dict(
        baseline_trace=os.path.basename(jsonl_a),
        degraded_trace=os.path.basename(jsonl_b),
        baseline_unique=base_n,
        degraded_unique=n,
        fault_chunk=fault_chunk,
        fault_shard=fault_shard,
        from_shards=8,
        to_shards=int(c.n_shards),
        degrade_wave=(rep["degrades_b"][0]["wave"]
                      if rep["degrades_b"] else None),
        counter_divergences=len(rep["divergences"]),
        diff_ok=bool(rep["ok"]),
    )


def run_matrix(args: argparse.Namespace, cells=CELLS) -> tuple[int, dict]:
    """Run ``cells`` (a subset of :data:`CELLS`, in their order) and,
    with ``args.mesh_degrade``, the traced pair: ``(exit status, the
    CKPT document)``; the document is also written with
    ``args.json``."""
    from .. import faultinject
    from ..artifacts import artifact_path, next_round, provenance, \
        repo_root
    from ..checkpoint import SnapshotCorruptError, SnapshotStaleError, \
        WatchdogTimeout

    root = args.root or repo_root()
    os.makedirs(root, exist_ok=True)
    wps, every = args.waves_per_sync, args.checkpoint_every
    cadence = wps * every  # waves between snapshots
    kill_chunk = 1 + faultinject.chunk_for_seed(
        args.seed, max(args.chunks_hint - 1, 1))
    # the kill ends the chunk right after the seeded snapshot; the
    # mid-chunk faults strike the chunk after the one before it: chunk
    # indices at wps waves a chunk, and the same places in waves (the
    # mesh engines run one wave a chunk)
    kill_at = (kill_chunk + 1) * every - 1
    fault_at = kill_chunk * every
    kill_wave = (kill_at + 1) * wps - 1
    fault_wave = fault_at * wps
    tmp = tempfile.mkdtemp(prefix="stpu_torch_crash_matrix_")
    snap = os.path.join(tmp, "matrix.ckpt")
    out_cells: dict = {}
    ok = True
    t_cell = None  # when the running cell began

    def cell(name, verdict, **detail):
        nonlocal ok
        if verdict not in GOOD_VERDICTS:
            ok = False
        if t_cell is not None and "wall_sec" not in detail:
            detail["wall_sec"] = round(time.monotonic() - t_cell, 3)
        out_cells[name] = dict(verdict=verdict, **detail)
        print(f"  {name:20s} {verdict:18s} "
              + " ".join(f"{k}={v}" for k, v in detail.items()),
              flush=True)

    print(f"crash matrix: {args.workload} count={args.count} "
          f"seed={args.seed} kill_chunk={kill_chunk} "
          f"waves_per_sync={wps} checkpoint_every={every} "
          f"device={args.device} (kill at wave {kill_wave}, faults at "
          f"wave {fault_wave})", flush=True)
    trace_flags = ["--trace", f"--trace-root={root}"] if args.trace else []
    lane = [args.workload, "check-gpu", str(args.count),
            f"--device={args.device}", f"--waves-per-sync={wps}"]

    try:
        # -- baseline (the CLI lane in this process, traced on --trace) -
        t0 = time.monotonic()
        stdout, baseline, base_traces = _run_main(lane + trace_flags, root)
        if baseline is None:
            print(stdout)
            print("crash_matrix: baseline run failed", file=sys.stderr)
            return 2, {}
        print(f"  baseline count: {baseline:,} in "
              f"{time.monotonic() - t0:.3f}s"
              + (f" (trace {base_traces})" if base_traces else ""),
              flush=True)
        snapshot_bytes = plan_bytes = None

        def kill():
            kill_snap = os.path.join(tmp, "kill.ckpt")
            path = f"--checkpoint-path={kill_snap}"
            proc, _, _ = _run_cli(
                lane + [f"--checkpoint-every={every}", path], root,
                faults=f"kill@chunk_boundary:{kill_at}")
            if proc.returncode != faultinject.KILL_EXIT_CODE:
                cell("kill", "no_kill", returncode=proc.returncode,
                     note="run completed before the seeded kill chunk — "
                     "lower --chunks-hint")
                return
            if not os.path.exists(kill_snap):
                cell("kill", "no_snapshot", returncode=proc.returncode)
                return
            proc2, resumed, res_traces = _run_cli(
                lane + ["--resume", path] + trace_flags, root)
            if proc2.returncode != 0 or resumed != baseline:
                print(proc2.stdout)
                print(proc2.stderr, file=sys.stderr)
                cell("kill", "count_mismatch", baseline=baseline,
                     resumed=resumed, returncode=proc2.returncode)
            else:
                cell("kill", "recovered", kill_chunk=kill_chunk,
                     kill_wave=kill_wave, baseline=baseline,
                     resumed=resumed,
                     **({"trace": res_traces[0]} if res_traces else {}))
            if args.trace and base_traces and res_traces:
                trace_diff(base_traces[0], res_traces[0])

        def trace_diff(base, resumed):
            nonlocal ok
            from ..telemetry import diff_traces, load_trace, \
                validate_events

            a = load_trace(os.path.join(root, base))
            b = load_trace(os.path.join(root, resumed))
            validate_events(a)
            validate_events(b)
            rep = diff_traces(a, b)
            out_cells["kill"]["trace_diff"] = dict(
                baseline=base, resumed=resumed,
                resume_wave=rep["resume_wave_b"],
                counter_divergences=len(rep["divergences"]),
                ok=rep["ok"])
            if rep["divergences"] or not rep["ok"]:
                ok = False
                out_cells["kill"]["verdict"] = "trace_divergence"
            print(f"  trace_diff: {base} vs {resumed} — "
                  f"{len(rep['divergences'])} counter divergences, "
                  f"resumed at wave {rep['resume_wave_b']}, "
                  f"{'OK' if rep['ok'] else 'FAIL'}", flush=True)

        def device_fault():
            nonlocal snapshot_bytes, plan_bytes
            c = _spawn(args, checkpoint_every=every, checkpoint_path=snap,
                       waves_per_sync=wps)
            c.retry_backoff_sec = 0.01
            faultinject.arm("raise", "mid_chunk", fault_at)
            try:
                n = _join_quiet(c).unique_state_count()
                plan_bytes = (c.memory_plan or {}).get("resident_bytes")
                snapshot_bytes = c.metrics.get("snapshot_bytes")
                cell("device_fault",
                     "recovered" if n == baseline else "count_mismatch",
                     count=n)
            except Exception as exc:
                cell("device_fault", "raised",
                     error=f"{type(exc).__name__}: {exc}")
            finally:
                faultinject.disarm_all()

        def damaged(name, damage, error):
            if not os.path.exists(snap):
                cell(name, "no_snapshot")
                return
            bad = os.path.join(tmp, f"{name}.ckpt")
            shutil.copy(snap, bad)
            damage(bad)
            try:
                _spawn(args).resume_from(bad)
                cell(name, "undetected")
            except error as exc:
                cell(name, "refused", error=type(exc).__name__)
            except Exception as exc:
                cell(name, "wrong_error",
                     error=f"{type(exc).__name__}: {exc}")

        def torn(mode):
            damaged(f"torn_{mode}", lambda p: faultinject.corrupt_snapshot(
                p, mode, seed=args.seed), SnapshotCorruptError)

        def stale(field):
            damaged(f"stale_{field.replace('git_', '')}",
                    lambda p: faultinject.stale_manifest(p, field),
                    SnapshotStaleError)

        def shard_fault_degrade():
            c = _spawn_mesh(args, 2, checkpoint_every=cadence,
                            checkpoint_path=os.path.join(tmp, "deg.ckpt"))
            c.degrade_on_fault = True
            c.retry_backoff_sec = 0.01
            faultinject.arm("shard_fault", "mid_chunk", fault_wave, shard=1)
            try:
                n = _join_quiet(c).unique_state_count()
                if n == baseline and c.n_shards == 1:
                    cell("shard_fault_degrade", "continue-degraded",
                         count=n, from_shards=2, to_shards=c.n_shards)
                else:
                    cell("shard_fault_degrade", "count_mismatch",
                         count=n, n_shards=c.n_shards, baseline=baseline)
            except Exception as exc:
                cell("shard_fault_degrade", "raised",
                     error=f"{type(exc).__name__}: {exc}")
            finally:
                faultinject.disarm_all()

        def collective_raise():
            c = _spawn_mesh(args, 2, checkpoint_every=cadence,
                            checkpoint_path=os.path.join(tmp, "coll.ckpt"))
            c.retry_backoff_sec = 0.01
            faultinject.arm("raise", "collective_seam", fault_wave,
                            once=True)
            try:
                n = _join_quiet(c).unique_state_count()
                cell("collective_raise",
                     "recovered" if n == baseline else "count_mismatch",
                     count=n)
            except Exception as exc:
                cell("collective_raise", "raised",
                     error=f"{type(exc).__name__}: {exc}")
            finally:
                faultinject.disarm_all()

        def hang_watchdog():
            c = _spawn(args, checkpoint_every=every, waves_per_sync=wps,
                       checkpoint_path=os.path.join(tmp, "hang.ckpt"))
            c.retry_backoff_sec = 0.01
            c.watchdog_factor = 5.0
            c.watchdog_floor_sec = args.watchdog_floor_sec
            c.watchdog_grace_sec = 20.0
            faultinject.arm("hang", "mid_chunk", fault_at,
                            hang_sec=args.hang_sec)
            try:
                n = _join_quiet(c).unique_state_count()
                cell("hang_watchdog",
                     "recovered" if n == baseline else "count_mismatch",
                     count=n)
            except WatchdogTimeout as exc:
                cell("hang_watchdog", "refused", error="WatchdogTimeout",
                     chunk=exc.chunk, deadline_sec=round(exc.deadline_sec,
                                                         3))
            except Exception as exc:
                cell("hang_watchdog", "raised",
                     error=f"{type(exc).__name__}: {exc}")
            finally:
                faultinject.disarm_all()

        runners = {
            "kill": kill, "device_fault": device_fault,
            "torn_truncate": lambda: torn("truncate"),
            "torn_flip": lambda: torn("flip"),
            "stale_sha": lambda: stale("git_sha"),
            "stale_encoding": lambda: stale("encoding"),
            "shard_fault_degrade": shard_fault_degrade,
            "collective_raise": collective_raise,
            "hang_watchdog": hang_watchdog,
        }
        for name in CELLS:
            if name in cells:
                t_cell = time.monotonic()
                runners[name]()
        t_cell = None
        mesh_degrade = None
        if args.mesh_degrade:
            mesh_degrade = _mesh_degrade_proof(args, root, cell)
    finally:
        faultinject.disarm_all()
        shutil.rmtree(tmp, ignore_errors=True)

    n_good = sum(1 for c in out_cells.values()
                 if c["verdict"] in GOOD_VERDICTS)
    print(f"verdict: {'CLEAN' if ok else 'FAIL'} ({n_good}/"
          f"{len(out_cells)} cells continue-degraded/recover/refuse)")
    if snapshot_bytes is not None:
        print(f"snapshot bytes: {snapshot_bytes:,}"
              + (f" (memplan resident: {plan_bytes:,})"
                 if plan_bytes else ""))
    doc = dict(
        workload=args.workload,
        count=args.count,
        seed=args.seed,
        kill_chunk=kill_chunk,
        waves_per_sync=wps,
        checkpoint_every=every,
        device=args.device,
        baseline_unique=baseline,
        snapshot_bytes=snapshot_bytes,
        memplan_resident_bytes=plan_bytes,
        cells=out_cells,
        degrade_cells={
            name: {k: c[k] for k in ("from_shards", "to_shards") if k in c}
            for name, c in out_cells.items()
            if c["verdict"] == "continue-degraded"
        },
        mesh_degrade=mesh_degrade,
        clean=ok,
        provenance=provenance(),
    )
    if args.json:
        path = artifact_path("CKPT", "json", root=root,
                             round=next_round(root, stems=("CKPT",)))
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"wrote {path}")
    return (0 if ok else 1), doc


def main(argv: list[str] | None = None) -> int:
    return run_matrix(parse_args(argv))[0]


if __name__ == "__main__":
    sys.exit(main())
