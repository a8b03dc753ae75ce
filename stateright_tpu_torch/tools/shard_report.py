"""Shard-balance report: the human-readable view of a mesh TRACE — the
port of the repository's ``tools/shard_report.py`` over telemetry.py's
``shard_balance``.

Reads a ``TRACE_r*.jsonl`` artifact whose run carries ``shard_wave``
events (a traced run of either sharded engine,
``spawn_sharded_sortmerge`` / ``spawn_sharded_hash``) and renders the
JAX tool's tables: per-wave frontier and candidate skew across shards,
the rows routed off-shard, the destination fill against its cap (the
port derives ``dest_cap`` from the run's candidate peak), the comms
reconciliation and the visited rows per shard.

    python -m stateright_tpu_torch.tools.shard_report TRACE_r01.jsonl
    python -m stateright_tpu_torch.tools.shard_report TRACE_r01.jsonl --run 0 --waves 50

Exit status: 0 (report printed, warnings included), 2 bad input / no
shard events in the trace.
"""

from __future__ import annotations

import argparse
import sys


def _fmt_skew(x):
    return "-" if x is None else f"{x:.2f}"


def format_report(bal: dict, max_waves: int) -> str:
    lines = [
        f"shard balance: run #{bal['run']}, {bal['n_shards']} shards, "
        f"{bal['waves']} waves",
        "",
        f"{'wave':>5s} {'frontier':>9s} {'f-skew':>7s} "
        f"{'cands':>9s} {'c-skew':>7s} {'routed':>8s} "
        f"{'fill/cap':>12s} {'util':>6s}",
    ]
    waves = bal["per_wave"]
    shown = waves if len(waves) <= max_waves else waves[:max_waves]
    for m in shown:
        util = "-" if m["dest_util"] is None else f"{m['dest_util']:.0%}"
        lines.append(
            f"{m['wave']:5d} {m['frontier_total']:9d} "
            f"{_fmt_skew(m['frontier_skew']):>7s} "
            f"{m['candidates_total']:9d} "
            f"{_fmt_skew(m['candidate_skew']):>7s} "
            f"{m['routed_rows']:8d} "
            f"{m['dest_fill_peak']:5d}/{m['dest_cap']:<6d} "
            f"{util:>6s}"
        )
    if len(waves) > max_waves:
        lines.append(f"  ... {len(waves) - max_waves} more waves "
                     "(--waves N to widen)")
    lines.append("")
    wf = bal["frontier_skew_worst"]
    wc = bal["candidate_skew_worst"]
    lines.append(
        "worst-wave skew: frontier "
        + ("-" if wf is None
           else f"{wf['skew']:.2f}x (wave {wf['wave']})")
        + ", candidates "
        + ("-" if wc is None
           else f"{wc['skew']:.2f}x (wave {wc['wave']})")
        + ", size-weighted frontier "
        + _fmt_skew(bal["frontier_skew_weighted"])
        + "x"
    )
    rb = bal["routed_bytes_total"]
    lines.append(
        f"cumulative shuffle: {bal['routed_rows_total']:,} rows "
        "routed off-shard"
        + (f" ({rb / 1e6:.2f} MB of routed-tile payload)"
           if rb is not None else "")
        + f"; {bal['recv_rows_total']:,} rows received "
        "(incl. self-owned)"
    )
    df = bal["dest_fill_worst"]
    if df is not None:
        lines.append(
            f"dest-tile headroom: peak fill {df['fill']}/{df['cap']} "
            f"({df['util']:.0%}, wave {df['wave']}) vs the lossless "
            "Bd cap"
        )
    cs = bal.get("comms_static")
    if cs is not None:
        # static-vs-runtime comms reconciliation (comms-lint, PERF.md
        # §comms-lint): measured routed rows x the static per-row
        # price vs the per-wave all_to_all exchange ceiling.
        # bound_util is None on a trace whose waves all report
        # dest_cap=0 (truncated/foreign traces) — the producer admits
        # the case, so the report must too.
        util = (
            f"= {cs['bound_util']:.1%} of"
            if cs["bound_util"] is not None else "vs"
        )
        lines.append(
            f"comms static: {cs['row_bytes']} B/row routed-tile "
            f"price; measured {cs['measured_routed_bytes'] / 1e6:.2f}"
            f" MB {util} the "
            f"{cs['bytes_bound_total'] / 1e6:.2f} MB static "
            "all_to_all exchange bound"
        )
    vis = bal["visited_per_shard"]
    cap = bal["shard_capacity"]
    occ = (
        f"; occupancy max {bal['occupancy_max']:.1%} of "
        f"{cap}/shard" if bal["occupancy_max"] is not None else ""
    )
    lines.append(
        f"visited per shard: min {min(vis)}, max {max(vis)} "
        f"(balance {_fmt_skew(bal['visited_skew'])}x){occ}"
    )
    if bal["warnings"]:
        lines.append("")
        for w in bal["warnings"]:
            lines.append(f"WARNING: {w}")
    else:
        lines.append("no headroom/skew warnings")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="shard balance/routing report over a mesh TRACE"
    )
    ap.add_argument("trace", help="TRACE_r*.jsonl artifact")
    ap.add_argument(
        "--run", type=int, default=None,
        help="run index inside the trace (default: the last run)",
    )
    ap.add_argument(
        "--waves", type=int, default=40,
        help="max per-wave rows to print (default 40)",
    )
    args = ap.parse_args(argv)

    from ..telemetry import load_trace, shard_balance, validate_events

    try:
        events = load_trace(args.trace)
        validate_events(events)
    except (OSError, ValueError) as exc:
        print(f"shard_report: bad input: {exc}", file=sys.stderr)
        return 2

    runs = sorted({e["run"] for e in events
                   if e["ev"] == "run_begin"})
    if args.run is not None and args.run not in runs:
        print(
            f"shard_report: run {args.run} not in this trace "
            f"(runs: {runs})",
            file=sys.stderr,
        )
        return 2

    bal = shard_balance(events, run=args.run)
    if bal is None:
        print(
            "shard_report: no shard_wave events in this trace — "
            "trace a SHARDED engine run "
            "(spawn_sharded_sortmerge / spawn_sharded_hash)",
            file=sys.stderr,
        )
        return 2
    print(format_report(bal, args.waves))
    return 0


if __name__ == "__main__":
    sys.exit(main())
