"""Trace-diff gate: align two ``TRACE_r*.jsonl`` run-telemetry artifacts
wave by wave and price the per-phase deltas — the port of the
repository's ``tools/trace_diff.py`` over telemetry.py's ``load_trace``,
``validate_events`` and ``diff_traces``: the same alignments (wave
counters, shard rows as a multiset, memory plans, latency lanes, tier
spills, the soundness certificate), the same report and exit codes.

    python -m stateright_tpu_torch.tools.trace_diff A.jsonl B.jsonl
    python -m stateright_tpu_torch.tools.trace_diff a.jsonl b.jsonl --threshold 0.05
    python -m stateright_tpu_torch.tools.trace_diff a.jsonl b.jsonl --run-a 0 --run-b 2

Exit status: 0 clean, 1 regression/divergence, 2 bad input.
"""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="diff two TRACE_r*.jsonl run-telemetry artifacts"
    )
    ap.add_argument("a", help="baseline trace (JSONL)")
    ap.add_argument("b", help="candidate trace (JSONL)")
    ap.add_argument(
        "--threshold", type=float, default=0.10,
        help="relative per-phase regression bar (default 0.10 = +10%%)",
    )
    ap.add_argument(
        "--min-sec", type=float, default=0.05,
        help="ignore phases shorter than this on the A side "
        "(noise floor, default 0.05s)",
    )
    ap.add_argument(
        "--run-a", type=int, default=None,
        help="run index inside A (default: the last run)",
    )
    ap.add_argument(
        "--run-b", type=int, default=None,
        help="run index inside B (default: the last run)",
    )
    args = ap.parse_args(argv)

    from ..telemetry import diff_traces, format_diff, load_trace, \
        validate_events

    try:
        a = load_trace(args.a)
        b = load_trace(args.b)
        validate_events(a)
        validate_events(b)
    except (OSError, ValueError) as exc:
        print(f"trace_diff: bad input: {exc}", file=sys.stderr)
        return 2

    try:
        report = diff_traces(
            a, b,
            run_a=args.run_a, run_b=args.run_b,
            threshold=args.threshold, min_sec=args.min_sec,
        )
    except IndexError:
        print("trace_diff: a file contains no runs", file=sys.stderr)
        return 2

    print(format_diff(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
