"""SLO report: the exit-code gate over a metrics rollup or a live
``/.metrics`` endpoint — the port of the repository's
``tools/slo_report.py`` over metrics.py.

Evaluates a declarative SLO spec (metrics.py ``SLO_OBJECTIVES``: max
p50/p99 time to verdict, max admission refusal rate, max p99 queue
wait, min warm-start cache-hit rate) against either a
``--metrics-interval`` JSONL rollup (``--rollup FILE``, its last
``metrics_rollup`` line) or one scrape of a live endpoint (``--url``,
``GET /.metrics`` parsed back by ``parse_prometheus``). The spec comes
from ``--spec FILE`` or the ``--max-*`` / ``--min-*`` flags (flags win).
An objective whose signal is absent evaluates unmeasured and fails the
gate. ``--json`` also writes an auto-numbered ``SLO_r*.json`` under
``--root``.

    python -m stateright_tpu_torch.tools.slo_report --rollup m.jsonl --max-ttv-p99 30
    python -m stateright_tpu_torch.tools.slo_report --url http://127.0.0.1:3000 --spec slo.json --json

Exit status: 0 all objectives met, 1 any objective violated or
unmeasured, 2 bad input (unreadable rollup or endpoint, no rollup
event, empty spec, unknown spec key).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import urllib.error
import urllib.request

#: flag name -> SLO_OBJECTIVES spec key
_FLAG_OBJECTIVES = {
    "max_ttv_p50": "max_ttv_p50_sec",
    "max_ttv_p99": "max_ttv_p99_sec",
    "max_refusal_rate": "max_refusal_rate",
    "max_queue_wait_p99": "max_queue_wait_p99_sec",
    "min_cache_hit_rate": "min_cache_hit_rate",
}


def _load_families(args):
    """The observed side: snapshot families from the rollup file or
    one live scrape. Raises ValueError on bad input."""
    if args.rollup is not None:
        from ..metrics import load_rollup

        try:
            return load_rollup(args.rollup)["families"], args.rollup
        except OSError as exc:
            raise ValueError(f"cannot read rollup: {exc}")
    from ..metrics import parse_prometheus

    url = args.url.rstrip("/")
    if not url.endswith("/.metrics"):
        url += "/.metrics"
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            text = r.read().decode()
    except (urllib.error.URLError, OSError) as exc:
        raise ValueError(f"cannot scrape {url}: {exc}")
    return parse_prometheus(text), url


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="evaluate a declarative SLO spec against a "
        "metrics rollup or a live /.metrics endpoint; the exit code "
        "is the gate"
    )
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--rollup", default=None,
                     help="metrics rollup JSONL (--metrics-interval "
                     "output); the LAST rollup event is evaluated")
    src.add_argument("--url", default=None,
                     help="live endpoint base URL or full /.metrics "
                     "URL to scrape once")
    ap.add_argument("--spec", default=None,
                    help="JSON file of SLO objectives "
                    "(metrics.py SLO_OBJECTIVES keys)")
    ap.add_argument("--max-ttv-p50", type=float, default=None,
                    help="max p50 time-to-verdict (seconds)")
    ap.add_argument("--max-ttv-p99", type=float, default=None,
                    help="max p99 time-to-verdict (seconds)")
    ap.add_argument("--max-refusal-rate", type=float, default=None,
                    help="max admission refusal rate (0..1)")
    ap.add_argument("--max-queue-wait-p99", type=float, default=None,
                    help="max p99 device-queue wait (seconds)")
    ap.add_argument("--min-cache-hit-rate", type=float, default=None,
                    help="min warm-start cache-hit rate (0..1)")
    ap.add_argument(
        "--json", action="store_true",
        help="also write an auto-numbered SLO_r*.json artifact",
    )
    ap.add_argument(
        "--root", default=None,
        help="artifact directory for --json (default: the repo root)",
    )
    args = ap.parse_args(argv)

    from ..metrics import evaluate_slo, slo_observed, write_slo_artifact

    spec = {}
    if args.spec is not None:
        try:
            with open(args.spec) as f:
                loaded = json.load(f)
        except (OSError, ValueError) as exc:
            print(f"slo_report: bad --spec: {exc}", file=sys.stderr)
            return 2
        if not isinstance(loaded, dict):
            print("slo_report: --spec must be a JSON object",
                  file=sys.stderr)
            return 2
        spec.update(loaded)
    for flag, key in _FLAG_OBJECTIVES.items():
        v = getattr(args, flag)
        if v is not None:
            spec[key] = v
    if not spec:
        print(
            "slo_report: empty spec — pass --spec FILE or at least "
            "one objective flag "
            "(--max-ttv-p50/--max-ttv-p99/--max-refusal-rate/"
            "--max-queue-wait-p99/--min-cache-hit-rate)",
            file=sys.stderr,
        )
        return 2

    try:
        families, source = _load_families(args)
        observed = slo_observed(families)
        evaluation = evaluate_slo(spec, observed)
    except ValueError as exc:
        print(f"slo_report: bad input: {exc}", file=sys.stderr)
        return 2

    print(f"slo report: {source}")
    print(f"  {'objective':<26s} {'threshold':>12s} "
          f"{'observed':>12s} {'status':<10s}")
    for o in evaluation["objectives"]:
        obs = ("-" if o["observed"] is None
               else f"{o['observed']:g}{o['unit']}")
        thr = f"{o['op']} {o['threshold']:g}{o['unit']}"
        print(
            f"  {o['objective']:<26s} {thr:>12s} "
            f"{obs:>12s} {o['status'].upper():<10s}"
        )
    print(f"  gate: {'OK' if evaluation['ok'] else 'FAILED'}")

    if args.json:
        path = write_slo_artifact(
            dict(
                source=os.path.basename(source)
                if args.rollup else source,
                spec=spec,
                observed=observed,
                evaluation=evaluation,
            ),
            root=args.root,
        )
        print(f"\nwrote {path}")
    return 0 if evaluation["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
