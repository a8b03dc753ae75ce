"""Latency report: the human-readable view of a run's wall-clock
telemetry, where the time went — the port of the repository's
``tools/latency_report.py`` over telemetry.py's ``latency_summary``.

Reads a ``TRACE_r*.jsonl`` artifact whose run carries the latency events
(``program_build`` / ``verdict`` / ``latency_profile``: any traced run
of the port) and renders the JAX tool's three tables: the compile-cache
ledger (each CUDA library load with its tier and wall), the dispatch /
sync-floor split (time to first wave, host dispatch against the timed
host reads, the deep level's device wait, the compile attribution) and
the per-property time to verdict, plus the counterexample
reconstruction walls. ``--json`` also writes an auto-numbered
``LAT_r*.json`` under ``--root``.

    python -m stateright_tpu_torch.tools.latency_report TRACE_r01.jsonl
    python -m stateright_tpu_torch.tools.latency_report TRACE_r01.jsonl --run 0 --json

Exit status: 0 (report printed), 2 bad input / no latency events in
the trace.
"""

from __future__ import annotations

import argparse
import os
import sys


def _sec(x) -> str:
    if x is None:
        return "-"
    return f"{x:,.4f} s" if x >= 0.001 else f"{x * 1e3:,.3f} ms"


def format_report(summary: dict) -> str:
    lines = [
        f"latency report: run #{summary['run']}, "
        f"engine {summary['engine']}",
    ]
    lane = summary.get("lane") or {}
    if lane:
        lines.append(
            "lane: " + ", ".join(
                f"{k}={lane[k]}" for k in sorted(lane)
            )
        )
    if summary.get("error"):
        lines.append(f"RUN ERROR: {summary['error']}")

    builds = summary.get("builds") or []
    if builds:
        lines.append("")
        lines.append("compile-cache ledger:")
        lines.append(
            f"  {'program':<16s} {'tier':<11s} {'key':<13s} "
            f"{'wall':>12s} {'cold':>12s}"
        )
        for b in builds:
            lines.append(
                f"  {b['program']:<16s} {b['tier']:<11s} "
                f"{(b.get('key') or '-'):<13s} "
                f"{_sec(b.get('wall_sec')):>12s} "
                f"{_sec(b.get('cold_sec')):>12s}"
            )

    prof = summary.get("profile")
    if prof:
        comp = prof.get("compile") or {}
        lines.append("")
        lines.append(
            f"wall split ({prof['chunks']} chunk(s), "
            f"{prof['waves']} waves, run wall "
            f"{_sec(prof['run_wall_sec'])}):"
        )
        if prof.get("resumed_from_wave") is not None:
            lines.append(
                f"  RESUMED from wave {prof['resumed_from_wave']}: "
                "walls cover the resumed half only (time to first "
                "wave = first wave AFTER the restore)"
            )

        def share(x):
            return f" ({x:.1%})" if x is not None else ""

        lines.append(
            f"  time to first wave:  "
            f"{_sec(prof['time_to_first_wave_sec'])}"
        )
        lines.append(
            f"  host dispatch:       {_sec(prof['dispatch_sec'])}"
            f"{share(prof.get('dispatch_share'))}"
            + (f"  [net of compile: "
               f"{_sec(prof['dispatch_net_sec'])}]"
               if prof.get("dispatch_net_sec")
               != prof.get("dispatch_sec") else "")
        )
        lines.append(
            f"  sync floor (fetch):  {_sec(prof['fetch_sec'])}"
            f"{share(prof.get('sync_share'))}  "
            f"[min/chunk {_sec(prof.get('fetch_min_sec'))}]"
        )
        if prof.get("device_sec") is not None:
            lines.append(
                f"  device wait (deep):  {_sec(prof['device_sec'])}"
                + (f" ({prof['overlap_share']:.1%} of chunk wall)"
                   if prof.get("overlap_share") is not None else "")
            )
        lines.append(
            f"  between chunks:      {_sec(prof['interchunk_sec'])}"
        )
        lines.append(
            f"  compile:             span {_sec(comp.get('span_sec'))}"
            f" + builds {_sec(comp.get('build_wall_sec'))}"
            f" (cold {_sec(comp.get('cold_sec'))})"
            f"{share(comp.get('share'))}"
            + (f"  tiers {comp['builds']}"
               if comp.get("builds") else "")
        )

    for w in summary.get("watchdogs") or ():
        lines.append(
            f"WATCHDOG TIMEOUT at chunk {w.get('chunk')}: deadline "
            f"{_sec(w.get('deadline_sec'))} "
            f"(rolling max chunk wall "
            f"{_sec(w.get('rolling_max_chunk_sec'))}, waited "
            f"{_sec(w.get('waited_sec'))}) — a hung dispatch; the "
            "latency attribution rides the event"
        )
    for d in summary.get("degrades") or ():
        lines.append(
            f"DEGRADED at wave {d.get('wave')}: "
            f"S={d.get('from_shards')} -> S={d.get('to_shards')} "
            f"({d.get('reason')}, {d.get('rerouted_rows')} rows "
            "re-routed from the snapshot)"
        )

    verdicts = summary.get("verdicts") or []
    if verdicts:
        lines.append("")
        lines.append("time to verdict:")
        lines.append(
            f"  {'property':<28s} {'expectation':<12s} "
            f"{'settled':<11s} {'wave':>5s} {'depth':>5s} "
            f"{'wall':>12s}"
        )
        for v in verdicts:
            lines.append(
                f"  {v['property']:<28s} {v['expectation']:<12s} "
                f"{v['kind']:<11s} "
                f"{v['wave'] if v.get('wave') is not None else '-':>5} "
                f"{v['depth'] if v.get('depth') is not None else '-':>5} "
                f"{_sec(v['t_since_run']):>12s}"
            )

    phases = summary.get("phases") or {}
    cex = {k: v for k, v in phases.items()
           if k.startswith("cex_")
           or k == "counterexample_reconstruction"}
    if cex:
        lines.append(
            "counterexample reconstruction: "
            + ", ".join(
                f"{k.replace('cex_', '')} {_sec(v)}"
                for k, v in sorted(cex.items())
            )
        )
    if "property_check" in phases:
        lines.append(
            f"host property checks: {_sec(phases['property_check'])}"
        )
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="compile-ledger / sync-floor / time-to-verdict "
        "report over a TRACE"
    )
    ap.add_argument("trace", help="TRACE_r*.jsonl artifact")
    ap.add_argument(
        "--run", type=int, default=None,
        help="run index inside the trace (default: the last run)",
    )
    ap.add_argument(
        "--json", action="store_true",
        help="also write an auto-numbered LAT_r*.json artifact "
        "(beside the trace's repo artifacts)",
    )
    ap.add_argument(
        "--root", default=None,
        help="artifact directory for --json (default: the repo root)",
    )
    args = ap.parse_args(argv)

    from ..telemetry import latency_summary, load_trace, \
        validate_events, write_latency_artifact

    try:
        events = load_trace(args.trace)
        validate_events(events)
    except (OSError, ValueError) as exc:
        print(f"latency_report: bad input: {exc}", file=sys.stderr)
        return 2

    runs = sorted({e["run"] for e in events
                   if e["ev"] == "run_begin"})
    if args.run is not None and args.run not in runs:
        print(
            f"latency_report: run {args.run} not in this trace "
            f"(runs: {runs})",
            file=sys.stderr,
        )
        return 2

    summary = latency_summary(events, run=args.run)
    if summary is None:
        print(
            "latency_report: no latency events in this trace — trace "
            "a device-engine run (program_build/verdict/"
            "latency_profile land automatically on traced runs)",
            file=sys.stderr,
        )
        return 2
    print(format_report(summary))
    if args.json:
        summary = dict(summary, trace=os.path.basename(args.trace))
        path = write_latency_artifact(summary, root=args.root)
        print(f"\nwrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
