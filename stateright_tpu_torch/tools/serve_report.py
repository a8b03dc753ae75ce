"""Serve report: the latency-per-query view of a resident-service trace —
the port of the repository's ``tools/serve_report.py`` over serve.py's
``serve_summary``.

Reads a ``TRACE_r*.jsonl`` artifact exported by the resident checking
service (serve.py ``CheckService.write_trace``, or ``POST /.serve/trace``
on a running daemon: one run index a session, bracketed by
``session_begin`` / ``session_end``) and renders the JAX tool's tables:
the per-session table (kind, lane, state, time to verdict, queue wait,
build tiers, warm start, counts), the time-to-verdict quantiles, the
warm-vs-cold pairing of repeat queries, the batch occupancy of fused
groups with each member's share of the fused walls, and the
snapshot-spool evictions. The port's service keeps no program LRU, so
its traces hold no program evictions. ``--json`` also writes an
auto-numbered ``SERVE_r*.json`` under ``--root``.

    python -m stateright_tpu_torch.tools.serve_report TRACE_r01.jsonl
    python -m stateright_tpu_torch.tools.serve_report TRACE_r01.jsonl --json

Exit status: 0 (report printed), 2 bad input / no session events in
the trace (not a service trace).
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
    sessions = summary["sessions"]
    lines = [
        f"serve report: {len(sessions)} session(s)",
        "",
        f"  {'#':>3s} {'kind':<9s} {'lane':<26s} {'state':<8s} "
        f"{'ttv':>12s} {'queue':>10s} {'tiers':<22s} "
        f"{'warm':<5s} {'unique':>9s}",
    ]
    for s in sessions:
        tiers = ",".join(
            f"{k}:{v}" for k, v in sorted(
                (s.get("builds") or {}).get("tiers", {}).items()
            )
        ) or "-"
        warm = "yes" if s.get("warm_start") else "no"
        if s.get("resumed_from_wave") is not None:
            warm += f"@w{s['resumed_from_wave']}"
        lines.append(
            f"  {s['session']:>3d} {s['kind']:<9s} "
            f"{(s.get('lane') or '')[:26]:<26s} "
            f"{(s.get('state') or '?'):<8s} "
            f"{_sec(s.get('time_to_verdict_sec')):>12s} "
            f"{_sec(s.get('queue_wait_sec')):>10s} {tiers:<22s} "
            f"{warm:<5s} "
            f"{s['unique'] if s.get('unique') is not None else '-':>9}"
        )
        if s.get("error"):
            lines.append(f"      ERROR: {s['error']}")
        ex = s.get("explorer")
        if ex:
            hits = ex["cache_hits"]
            n = ex["requests"]
            lines.append(
                f"      explorer: {n} request(s), {hits} cache "
                f"hit(s) ({hits / n:.0%})" if n else
                "      explorer: 0 requests"
            )

    # the aggregate quantiles ride the one shared implementation
    # (metrics.py quantile, the function serve_loadtest and the SLO gate
    # use), so the report and the gate cannot disagree on "p99"
    from ..metrics import quantile

    ttvs = [s.get("time_to_verdict_sec") for s in sessions
            if s.get("time_to_verdict_sec") is not None]
    if len(ttvs) >= 2:
        lines.append("")
        lines.append(
            f"  time-to-verdict: p50 {_sec(quantile(ttvs, 0.50))} / "
            f"p99 {_sec(quantile(ttvs, 0.99))} "
            f"across {len(ttvs)} session(s)"
        )

    wvc = summary.get("warm_vs_cold") or []
    if wvc:
        lines.append("")
        lines.append("warm vs cold (repeat queries of one program):")
        for p in wvc:
            lines.append(
                f"  program {p['program_key']}: cold #"
                f"{p['cold_session']} ttv {_sec(p['cold_ttv_sec'])}"
                f" -> warm #{p['warm_session']} ttv "
                f"{_sec(p['warm_ttv_sec'])} "
                f"(delta {_sec(p['ttv_delta_sec'])}; compile-tier "
                f"{_sec(p['compile_delta_sec'])}, dispatch "
                f"{_sec(abs(p['dispatch_net_delta_sec']))} "
                f"{'less' if p['dispatch_net_delta_sec'] >= 0 else 'more'}"
                f"; waves {p.get('waves_cold')} -> "
                f"{p.get('waves_warm')}"
                + (", warm-start" if p.get("warm_start") else "")
                + ")"
            )

    batches = summary.get("batches") or []
    if batches:
        lines.append("")
        # the JAX tool's heading, word for word: the two reports are
        # held equal on one trace
        lines.append(
            "batch occupancy (fused wave dispatch, "
            "stateright_tpu/batch.py):"
        )
        lines.append(
            f"  {'grp':>4s} {'size':>4s} {'chunks':>6s} "
            f"{'sessions':<18s} {'per-query overhead':>19s}"
        )
        for g in batches:
            sess = ",".join(f"#{s}" for s in g["sessions"])
            lines.append(
                f"  {g['group']:>4d} "
                f"{g.get('size') or len(g['sessions']):>4d} "
                f"{g.get('chunks') if g.get('chunks') is not None else '-':>6} "
                f"{sess:<18s} "
                f"{_sec(g.get('per_query_overhead_sec')):>19s}"
            )
        lines.append("")
        lines.append(
            "amortized floor per query (each member's dispatch+sync "
            "is its 1/N_active share of the fused walls):"
        )
        lines.append(
            f"  {'grp':>4s} {'#':>4s} {'waves':>6s} "
            f"{'dispatch':>12s} {'fetch':>12s} {'overhead':>12s} "
            f"{'ttv':>12s}"
        )
        for g in batches:
            for m in g["members"]:
                lines.append(
                    f"  {g['group']:>4d} {m['session']:>4d} "
                    f"{m.get('waves') if m.get('waves') is not None else '-':>6} "
                    f"{_sec(m.get('dispatch_net_sec')):>12s} "
                    f"{_sec(m.get('fetch_sec')):>12s} "
                    f"{_sec(m.get('overhead_sec')):>12s} "
                    f"{_sec(m.get('time_to_verdict_sec')):>12s}"
                )

    ev = summary.get("evictions") or []
    if ev:
        lines.append("")
        lines.append("program-LRU evictions:")
        for e in ev:
            lines.append(
                f"  key {e.get('key')}: {e.get('bytes'):,} B "
                f"(session run {e.get('run')})"
            )
    sev = summary.get("snapshot_evictions") or []
    if sev:
        lines.append("")
        lines.append("snapshot-spool evictions (byte-budget LRU):")
        for e in sev:
            lines.append(
                f"  key {e.get('key')}: {e.get('bytes'):,} B "
                f"(session run {e.get('run')})"
            )
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="per-session latency-per-query report over a "
        "resident-service TRACE"
    )
    ap.add_argument("trace", help="TRACE_r*.jsonl artifact (from "
                    "CheckService.write_trace)")
    ap.add_argument(
        "--json", action="store_true",
        help="also write an auto-numbered SERVE_r*.json artifact",
    )
    ap.add_argument(
        "--root", default=None,
        help="artifact directory for --json (default: the repo root)",
    )
    args = ap.parse_args(argv)

    from ..serve import serve_summary, write_serve_artifact
    from ..telemetry import load_trace, validate_events

    try:
        events = load_trace(args.trace)
        validate_events(events)
    except (OSError, ValueError) as exc:
        print(f"serve_report: bad input: {exc}", file=sys.stderr)
        return 2

    summary = serve_summary(events)
    if summary is None:
        print(
            "serve_report: no session events in this trace — export "
            "one from a resident service "
            "(serve.py CheckService.write_trace, or POST /.serve/trace "
            "on a running daemon)",
            file=sys.stderr,
        )
        return 2
    print(format_report(summary))
    if args.json:
        summary = dict(summary, trace=os.path.basename(args.trace))
        path = write_serve_artifact(summary, root=args.root)
        print(f"\nwrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
