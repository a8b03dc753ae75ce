"""Memory report: the human-readable view of a run's memory telemetry —
the port of the repository's ``tools/mem_report.py`` over telemetry.py's
``memory_summary`` and memplan.py.

Reads a ``TRACE_r*.jsonl`` artifact whose run carries the memory events
(``memory_plan`` / ``memory_watermark`` / per-chunk ``mem_bytes``: any
traced run of the device engines) and renders the JAX tool's tables:
the resident-buffer ledger (the tensors the engine keeps between waves,
per shard on a sharded run), the tier spills, the live watermarks, the
visited headroom and the capacity projection. An eager wave has no
ladder classes and no XLA ``memory_analysis``: the port's plan carries
empty ``classes`` and a null ``compiled``, so those rows print the JAX
tool's "not reported by this backend". ``--json`` also writes an
auto-numbered ``MEM_r*.json`` under ``--root``.

    python -m stateright_tpu_torch.tools.mem_report TRACE_r01.jsonl
    python -m stateright_tpu_torch.tools.mem_report TRACE_r01.jsonl --run 0 --json

Exit status: 0 (report printed), 2 bad input / no memory events in the
trace.
"""

from __future__ import annotations

import argparse
import os
import sys


def format_report(summary: dict, max_chunks: int = 20) -> str:
    from ..memplan import format_bytes as fb

    lines = [
        f"memory report: run #{summary['run']}, "
        f"engine {summary['engine']}",
    ]
    lane = summary.get("lane") or {}
    if lane:
        lines.append(
            "lane: " + ", ".join(
                f"{k}={lane[k]}" for k in sorted(lane)
            )
        )
    plan = summary.get("plan")
    if plan:
        lines.append("")
        lines.append(
            f"resident-buffer ledger ({plan['n_shards']} shard(s), "
            f"total {fb(plan['resident_bytes'])}):"
        )
        lines.append(
            f"  {'buffer':14s} {'shape':>18s} {'dtype':>8s} "
            f"{'bytes':>14s}" + (
                f" {'per-shard':>12s}" if plan["n_shards"] > 1 else ""
            )
        )
        for e in plan["resident"]:
            shape = "x".join(map(str, e["shape"])) or "scalar"
            row = (
                f"  {e['name']:14s} {shape:>18s} {e['dtype']:>8s} "
                f"{e['bytes']:>14,d}"
            )
            if plan["n_shards"] > 1:
                row += f" {e.get('per_shard_bytes', e['bytes']):>12,d}"
            lines.append(row)
        if plan.get("classes"):
            lines.append("")
            lines.append("per-ladder-class staging (per shard):")
            lines.append(
                f"  {'f':>2s} {'mode':12s} {'frontier':>9s} "
                f"{'buffer':>9s} {'tiles':>6s} {'bytes':>14s}"
            )
            for c in plan["classes"]:
                lines.append(
                    f"  {c['f_class']:2d} {c['mode']:12s} "
                    f"{c['frontier_rows']:9,d} "
                    f"{c.get('buffer_rows', 0):9,d} "
                    f"{c.get('tiles', 1):6d} "
                    f"{c['staging_bytes']:>14,d}"
                )
        if plan.get("v_classes"):
            lines.append("  v-ladder merge scratch: " + ", ".join(
                f"v{v['v_class']}={v['visited_rows']:,}rows/"
                f"{fb(v['merge_scratch_bytes'])}"
                for v in plan["v_classes"]
            ))
        lines.append(
            f"plan total (resident + peak-class staging): "
            f"{fb(plan['total_bytes'])}"
        )
        comp = plan.get("compiled")
        lines.append("")
        if comp:
            lines.append(
                "compiled wave program (XLA memory_analysis): "
                f"temp {fb(comp.get('temp_size_in_bytes'))}, "
                f"args {fb(comp.get('argument_size_in_bytes'))}, "
                f"out {fb(comp.get('output_size_in_bytes'))}, "
                f"alias {fb(comp.get('alias_size_in_bytes'))}"
            )
        else:
            lines.append(
                "compiled wave program: memory_analysis not reported "
                "by this backend"
            )
    for m in summary.get("engine_modes") or ():
        lines.append(
            f"ENGINE MODE: {m.get('engine')} f_class "
            f"{m.get('f_class')} ran {m.get('mode').upper()} "
            f"memory-lean ({m.get('buffer_rows'):,} rows in "
            f"{m.get('chunks')} chunks of {m.get('chunk_rows'):,}; "
            f"flat budget {fb(m.get('flat_budget_bytes'))})"
        )
    spills = summary.get("tier_spills") or []
    if spills:
        lines.append("")
        lines.append(
            f"tier spills ({len(spills)} — hot prefix -> host-DRAM "
            "cold runs at the chunk sync):"
        )
        shown = spills[:max_chunks]
        lines.append(
            "  rows per spill: " + " ".join(
                f"{s['rows']:,}" for s in shown
            ) + (f" ... ({len(spills) - max_chunks} more)"
                 if len(spills) > max_chunks else "")
        )
        last = spills[-1]
        lines.append(
            f"  cold tier after last spill: "
            f"{last['cold_rows_total']:,} rows = "
            f"{fb(last['cold_bytes_total'])}"
        )
    wm = summary.get("watermark")
    chunks = summary.get("chunk_mem") or []
    if wm or chunks:
        lines.append("")
        lines.append("live watermarks:")
    if chunks:
        shown = chunks[:max_chunks]
        lines.append(
            "  per-chunk bytes-in-use: " + " ".join(
                fb(c["bytes"]) for c in shown
            ) + (f" ... ({len(chunks) - max_chunks} more)"
                 if len(chunks) > max_chunks else "")
        )
    if wm:
        lines.append(
            f"  run peak: {fb(wm.get('device_peak_bytes'))} "
            f"(source: {wm.get('source')}, "
            f"{wm.get('polls', 0)} polls)"
        )
        hr = wm.get("headroom") or {}
        occ = hr.get("occupancy")
        lines.append(
            f"  visited headroom: {hr.get('visited_rows', 0):,}/"
            f"{hr.get('visited_capacity', 0):,} rows"
            + (f" ({occ:.1%})" if occ is not None else "")
            + f" = {fb(hr.get('visited_used_bytes'))} of "
            f"{fb(hr.get('visited_capacity_bytes'))}"
        )
        budget = hr.get("budget")
        if budget:
            ratio = budget.get("headroom_ratio")
            lines.append(
                f"  auto-budget: cand_capacity "
                f"{budget.get('cand_capacity'):,} vs observed peak "
                f"{budget.get('observed_peak') or 0:,}"
                + (f" ({ratio:.2f}x headroom)"
                   if ratio is not None else "")
            )
        tier = (hr.get("tier") or {}) if hr else {}
        if tier:
            hot = tier.get("hot_ceiling_rows")
            cold_rows = tier.get("cold_rows_total", 0)
            hot_rows = hr.get("visited_rows", 0) - cold_rows
            lines.append(
                f"  tiered visited set: hot {hot_rows:,} rows "
                f"(device, ceiling "
                + (f"{hot:,}" if hot is not None else "-")
                + f") / cold {cold_rows:,} rows = "
                f"{fb(tier.get('cold_bytes_total'))} in "
                f"{tier.get('runs', 0)} host-DRAM run(s), "
                f"{tier.get('spills', 0)} spill(s) "
                f"(spill wall {tier.get('spill_wall_sec', 0):.3f}s, "
                f"worker ingest {tier.get('ingest_sec', 0):.3f}s "
                "overlapped)"
            )
        proj = wm.get("projection") or {}
        if proj.get("kind") == "next_v_class":
            lines.append(
                f"  projection (next v-class): "
                f"{proj.get('current_rows', 0):,} -> "
                f"{proj.get('next_rows', 0):,} visited rows = "
                f"{fb(proj.get('next_vkeys_bytes'))} resident vkeys "
                f"+ {fb(proj.get('next_merge_scratch_bytes'))} merge "
                "scratch"
            )
        elif proj:
            lines.append(
                f"  projection ({proj.get('kind')}): "
                f"{proj.get('next_rows', 0):,} rows = "
                f"{fb(proj.get('next_visited_bytes'))}"
            )
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="memory plan/watermark/headroom report over a "
        "TRACE"
    )
    ap.add_argument("trace", help="TRACE_r*.jsonl artifact")
    ap.add_argument(
        "--run", type=int, default=None,
        help="run index inside the trace (default: the last run)",
    )
    ap.add_argument(
        "--json", action="store_true",
        help="also write an auto-numbered MEM_r*.json artifact "
        "(beside the trace's repo artifacts)",
    )
    ap.add_argument(
        "--root", default=None,
        help="artifact directory for --json (default: the repo root)",
    )
    ap.add_argument(
        "--chunks", type=int, default=20,
        help="max per-chunk watermark samples to print (default 20)",
    )
    args = ap.parse_args(argv)

    from ..telemetry import load_trace, memory_summary, validate_events

    try:
        events = load_trace(args.trace)
        validate_events(events)
    except (OSError, ValueError) as exc:
        print(f"mem_report: bad input: {exc}", file=sys.stderr)
        return 2

    runs = sorted({e["run"] for e in events
                   if e["ev"] == "run_begin"})
    if args.run is not None and args.run not in runs:
        print(
            f"mem_report: run {args.run} not in this trace "
            f"(runs: {runs})",
            file=sys.stderr,
        )
        return 2

    summary = memory_summary(events, run=args.run)
    if summary is None:
        print(
            "mem_report: no memory events in this trace — trace a "
            "device-engine run (memory_plan/memory_watermark land "
            "automatically on traced runs)",
            file=sys.stderr,
        )
        return 2
    print(format_report(summary, args.chunks))
    if args.json:
        from ..memplan import write_memory_artifact

        summary = dict(summary, trace=os.path.basename(args.trace))
        path = write_memory_artifact(summary, root=args.root)
        print(f"\nwrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
