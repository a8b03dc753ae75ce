"""Serve load test: the wave-batching A/B and the sustained
ramp→spike→drain SLO run against the resident checking service — the
port of the repository's ``tools/serve_loadtest.py`` over serve.py and
metrics.py.

**A/B mode (default).** N concurrent clients run one lane on two
services (serve.py ``CheckService``, warm start off on both):

* **batched** — ``batch_sessions=N``: the clients seat in one
  compatibility class and run as ONE fused run of the hash engine
  (batch.py), each session billed its 1/N_active share of the fused
  waves' walls;
* **fifo-serial** — batching off: each session runs the lane's own
  engine (the sort-merge engine of ``check-gpu``), a wave at a time
  through the FIFO gate.

The counts must be equal across both arms. Each arm reports p50/p99
time to verdict and the per-query ``dispatch_net_sec + fetch_sec`` of
the sessions' latency profiles.

**Sustained mode (``--sustained``).** ONE service behind its real HTTP
server (``CheckService.http_server``, explorer/server.py
``make_server``), driven through ``POST /.check`` in three phases: ramp,
spike, drain. Mid-spike it scrapes ``GET /.metrics`` and
``/.serve/sessions`` (the ``/.status`` block) and checks that the live
registry serves :data:`REQUIRED_FAMILIES`. Then it reports per-phase
p50/p99 time to verdict both ways, exact (``metrics.quantile``) and
from a ``metrics.Histogram``, runs the SLO gate
(``metrics.evaluate_slo`` over ``slo_observed``), and checks that every
session's count equals a solo run of the lane on a fresh service.
``--json`` writes the TRACE pair, ``SERVE_r*.json`` (the sustained
block and the registry snapshot embedded) and ``SLO_r*.json`` under
``--root``.

Every service runs its sessions on ``--device`` (the CUDA device unless
``--device cpu``; no fallback). Every request and client thread has a
timeout.

    python -m stateright_tpu_torch.tools.serve_loadtest --device cpu --lane "2pc check-gpu 4"
    python -m stateright_tpu_torch.tools.serve_loadtest --clients 4 --lane "2pc check-gpu 9" --json
    python -m stateright_tpu_torch.tools.serve_loadtest --sustained --lane "2pc check-gpu 9" --ramp 2 --spike 4 --drain 2 --slo-ttv-p99 120 --json

Exit status: 0 on success, 1 when a session fails, a count differs
from the solo run or across arms, a required family is missing from
the live scrape, or the SLO gate fails.
"""

from __future__ import annotations

import argparse
import json as _json
import os
import sys
import tempfile
import threading
import time
import urllib.request

#: the JAX tool's required families that name the program LRU: the
#: port's service builds nothing per session (its CUDA libraries load
#: once a process), so it keeps no program cache and meters no
#: program eviction (serve.py, "Programs")
PROGRAM_LRU_FAMILIES = ("stpu_serve_program_evictions_total",)

#: the families the mid-spike scrape must find on a live /.metrics: the
#: JAX tool's list less :data:`PROGRAM_LRU_FAMILIES`
REQUIRED_FAMILIES = (
    "stpu_serve_queue_depth",
    "stpu_serve_queue_wait_seconds",
    "stpu_serve_admission_total",
    "stpu_time_to_verdict_seconds",
    "stpu_program_builds_total",
    "stpu_serve_snapshot_evictions_total",
)

#: seconds one client request or client thread may take
REQUEST_TIMEOUT_SEC = 1800.0


def _fleet(fn, n: int) -> list:
    """``fn(i)`` on N concurrent threads, each joined within
    :data:`REQUEST_TIMEOUT_SEC`: the results in submission order. A
    thread still running at its deadline raises."""
    results: dict = {}
    errors: dict = {}

    def run(i):
        try:
            results[i] = fn(i)
        except Exception as exc:  # reported by the caller's thread
            errors[i] = exc

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + REQUEST_TIMEOUT_SEC
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            raise TimeoutError(
                f"a client took over {REQUEST_TIMEOUT_SEC:.0f} s")
    if errors:
        raise next(iter(errors.values()))
    return [results[i] for i in range(n)]


def _arm_stats(summary: dict) -> dict:
    """Each session's row and the arm's aggregate: the latency profile's
    ``dispatch_net_sec + fetch_sec`` and the time-to-verdict quantiles
    (metrics.py ``quantile``, the one the SLO gate uses)."""
    from ..metrics import quantile

    rows = []
    for s in summary["sessions"]:
        overhead = ((s.get("dispatch_net_sec") or 0.0)
                    + (s.get("fetch_sec") or 0.0))
        rows.append(dict(
            session=s["session"],
            unique=s.get("unique"),
            waves=s.get("waves"),
            batch=s.get("batch"),
            time_to_verdict_sec=s.get("time_to_verdict_sec"),
            dispatch_net_sec=s.get("dispatch_net_sec"),
            fetch_sec=s.get("fetch_sec"),
            overhead_sec=round(overhead, 6),
            compile_wall_sec=(s.get("builds") or {}).get("wall_sec"),
        ))
    ttvs = [r["time_to_verdict_sec"] for r in rows
            if r["time_to_verdict_sec"] is not None]
    ov = [r["overhead_sec"] for r in rows]
    return dict(
        sessions=rows,
        per_query_overhead_sec=(
            round(sum(ov) / len(ov), 6) if ov else None
        ),
        ttv_p50_sec=quantile(ttvs, 0.50),
        ttv_p99_sec=quantile(ttvs, 0.99),
    )


# -- sustained ramp -> spike -> drain (the SLO evidence run) --------------


def _post_check(port: int, lane_argv) -> dict:
    """One client query through the live HTTP surface (the ``--connect``
    route): the response dict."""
    body = _json.dumps({"argv": list(lane_argv)}).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/.check", data=body,
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=REQUEST_TIMEOUT_SEC) as r:
        return _json.loads(r.read())


def _get(port: int, path: str) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.read().decode()


def run_sustained(lane, phases, slo_spec, json_out: bool = False,
                  root=None, device: str = "cuda"):
    """The sustained-load SLO run. ``phases`` is ``[(name, clients),
    ...]``; returns ``(exit status, doc)``, ``doc`` the sustained block
    (also written into SERVE_r*/SLO_r* with ``json_out``), None when
    the solo run failed."""
    from ..metrics import Histogram, evaluate_slo, quantile, \
        slo_observed, write_slo_artifact
    from ..serve import CheckService, serve_summary, write_serve_artifact

    failures = []
    with tempfile.TemporaryDirectory() as spool:
        # the solo run first: one session on a fresh service, the count
        # every served session must reproduce
        solo_svc = CheckService(device=device, warm_start=False,
                                spool_dir=os.path.join(spool, "solo"))
        solo = solo_svc.check(list(lane))
        solo_svc.close()
        if solo.state != "done":
            print(f"solo baseline failed: {solo.error}", file=sys.stderr)
            return 1, None
        baseline_unique = solo.unique

        service = CheckService(device=device,
                               spool_dir=os.path.join(spool, "serve"))
        server = service.http_server("127.0.0.1", 0)
        port = server.server_address[1]
        threading.Thread(target=server.serve_forever, daemon=True).start()
        scrape = status_metrics = None
        phase_of: dict = {}
        responses: list = []
        try:
            for name, clients in phases:
                print(f"  phase {name}: {clients} client(s) x "
                      f"'{' '.join(lane)}'", flush=True)
                if name == "spike":
                    # the mid-spike scrape: launch the fleet, read
                    # /.metrics and the /.status block while it runs
                    box: dict = {}
                    fleet = threading.Thread(
                        target=lambda: box.update(out=_fleet(
                            lambda i: _post_check(port, lane), clients)),
                        daemon=True)
                    fleet.start()
                    time.sleep(0.2)
                    scrape = _get(port, "/.metrics")
                    status_metrics = _json.loads(
                        _get(port, "/.serve/sessions")).get("metrics")
                    fleet.join(REQUEST_TIMEOUT_SEC)
                    if "out" not in box:
                        raise RuntimeError("the spike's clients did not "
                                           "all answer")
                    batch = box["out"]
                else:
                    batch = _fleet(lambda i: _post_check(port, lane),
                                   clients)
                for resp in batch:
                    responses.append(resp)
                    sid = (resp.get("session") or {}).get("session")
                    phase_of[sid] = name
        finally:
            server.shutdown()
            server.server_close()

        # -- every served session equal to the solo run ---------------
        for resp in responses:
            sess = resp.get("session") or {}
            if not resp.get("ok"):
                failures.append(f"session {sess.get('session')} failed: "
                                f"{sess.get('error')}")
            elif sess.get("unique") != baseline_unique:
                failures.append(
                    f"count divergence: session {sess.get('session')} "
                    f"unique={sess.get('unique')} vs solo "
                    f"{baseline_unique}")
        if not failures:
            print(f"  counts: unique={baseline_unique:,} on every "
                  f"served session == the solo baseline")

        # -- the live scrape must serve the required families ---------
        missing = [f for f in REQUIRED_FAMILIES
                   if scrape is None or f not in scrape]
        if missing:
            failures.append(f"/.metrics scrape missing families: {missing}")
        else:
            print(f"  /.metrics scrape: all {len(REQUIRED_FAMILIES)} "
                  "required families live (the program-LRU families "
                  f"{list(PROGRAM_LRU_FAMILIES)} are not the port's)")
        if not isinstance(status_metrics, dict) or not {
            "active_sessions", "queue_depth", "refusals", "ttv_p99_sec",
        } <= set(status_metrics):
            failures.append(
                f"/.status metrics block incomplete: {status_metrics}")

        # -- per-phase percentiles, exact and bucket-interpolated -----
        summary = serve_summary(service.events())
        ttv_of = {s["session"]: s.get("time_to_verdict_sec")
                  for s in summary["sessions"]}
        phase_rows = []
        for name, clients in phases:
            ttvs = [v for sid, v in sorted(ttv_of.items())
                    if phase_of.get(sid) == name and v is not None]
            hist = Histogram("phase_ttv", "", threading.Lock())
            for v in ttvs:
                hist.observe(v)
            phase_rows.append(dict(
                phase=name,
                clients=clients,
                sessions=len(ttvs),
                ttv_p50_sec=quantile(ttvs, 0.50),
                ttv_p99_sec=quantile(ttvs, 0.99),
                ttv_p50_bucket_sec=hist.quantile(0.50),
                ttv_p99_bucket_sec=hist.quantile(0.99),
            ))
        print(f"  {'phase':<8s} {'n':>3s} {'p50':>10s} {'p99':>10s} "
              f"{'p50(bkt)':>10s} {'p99(bkt)':>10s}")
        for row in phase_rows:
            print("  " + f"{row['phase']:<8s} {row['sessions']:>3d} "
                  + " ".join("         -" if row[k] is None
                             else f"{row[k]:>10.4f}"
                             for k in ("ttv_p50_sec", "ttv_p99_sec",
                                       "ttv_p50_bucket_sec",
                                       "ttv_p99_bucket_sec")))

        # -- the SLO gate ---------------------------------------------
        families = service.metrics.snapshot()
        observed = slo_observed(families)
        evaluation = evaluate_slo(slo_spec, observed)
        for o in evaluation["objectives"]:
            print(f"  slo {o['objective']}: observed "
                  f"{o['observed']}{o['unit']} {o['op']} "
                  f"{o['threshold']}{o['unit']} -> {o['status']}")
        print(f"  slo gate: {'OK' if evaluation['ok'] else 'FAILED'}")
        if not evaluation["ok"]:
            failures.append("SLO gate failed")

        doc = dict(
            lane=" ".join(lane),
            device=device,
            phases=phase_rows,
            solo_unique=baseline_unique,
            spec=slo_spec,
            observed=observed,
            evaluation=evaluation,
            status_metrics=status_metrics,
        )
        if json_out:
            jsonl, _chrome = service.write_trace(root=root)
            summary = dict(summary, trace=os.path.basename(jsonl),
                           sustained=doc)
            serve_path = write_serve_artifact(summary, root=root,
                                              metrics=families)
            slo_path = write_slo_artifact(
                dict(doc, serve_artifact=os.path.basename(serve_path),
                     trace=os.path.basename(jsonl)),
                root=root,
            )
            doc = dict(doc, artifacts=[jsonl, serve_path, slo_path])
            print(f"\nwrote {jsonl}\nwrote {serve_path}\nwrote {slo_path}")
        service.close()

    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    return (1 if failures else 0), doc


def run_ab(lane, clients: int, json_out: bool = False, root=None,
           device: str = "cuda"):
    """The batched-vs-FIFO A/B: ``(exit status, summary)``, the summary
    the batched arm's ``serve_summary`` with both arms' figures (also
    written as SERVE_r* with ``json_out``), None on a failure."""
    from ..serve import CheckService, serve_summary, write_serve_artifact

    with tempfile.TemporaryDirectory() as spool:
        batched_svc = CheckService(
            device=device, warm_start=False,
            spool_dir=os.path.join(spool, "batched"),
            batch_sessions=clients, batch_window_sec=60.0)
        batched_sessions = _fleet(lambda i: batched_svc.check(list(lane)),
                                  clients)
        fifo_svc = CheckService(device=device, warm_start=False,
                                spool_dir=os.path.join(spool, "fifo"))
        fifo_sessions = _fleet(lambda i: fifo_svc.check(list(lane)),
                               clients)
        for svc in (batched_svc, fifo_svc):
            svc.close()

        for arm, sessions in (("batched", batched_sessions),
                              ("fifo", fifo_sessions)):
            for s in sessions:
                if s.state != "done":
                    print(f"{arm} session {s.id} failed: {s.error}",
                          file=sys.stderr)
                    return 1, None
        counts = ({s.unique for s in batched_sessions}
                  | {s.unique for s in fifo_sessions})
        if len(counts) != 1:
            print(f"count divergence across arms: {counts}",
                  file=sys.stderr)
            return 1, None

        summary = serve_summary(batched_svc.events())
        batched = _arm_stats(summary)
        fifo = _arm_stats(serve_summary(fifo_svc.events()))
        amortization = (
            round(fifo["per_query_overhead_sec"]
                  / batched["per_query_overhead_sec"], 2)
            if batched["per_query_overhead_sec"] else None
        )

        print(f"  counts: unique={counts.pop():,} on every session, "
              "both arms")
        for label, arm, engine in (
                ("batched", batched, "the fused hash engine"),
                ("fifo-serial", fifo, "the lane's own engine")):
            print(f"  {label:<12s} per-query dispatch+sync "
                  f"{arm['per_query_overhead_sec']:.4f} s | ttv p50 "
                  f"{arm['ttv_p50_sec']:.4f} s p99 "
                  f"{arm['ttv_p99_sec']:.4f} s ({engine})")
        print(f"  amortization: {amortization}x lower per-query "
              "overhead under the fused dispatch")

        summary["fifo_baseline"] = fifo
        summary["latency_quantiles"] = dict(
            batched={k: batched[k] for k in ("ttv_p50_sec", "ttv_p99_sec")},
            fifo_serial={k: fifo[k] for k in ("ttv_p50_sec",
                                              "ttv_p99_sec")},
        )
        summary["loadtest"] = dict(
            clients=clients,
            lane=" ".join(lane),
            device=device,
            batched_engine="fused hash engine (batch.py)",
            fifo_engine="the lane's own engine",
            amortization_x=amortization,
            batched_per_query_overhead_sec=batched["per_query_overhead_sec"],
            fifo_per_query_overhead_sec=fifo["per_query_overhead_sec"],
        )
        if json_out:
            jsonl, _chrome = batched_svc.write_trace(root=root)
            summary["trace"] = os.path.basename(jsonl)
            path = write_serve_artifact(
                summary, root=root, metrics=batched_svc.metrics.snapshot())
            print(f"\nwrote {jsonl}\nwrote {path}")
    return 0, summary


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="wave-batching A/B or sustained "
        "ramp->spike->drain SLO run against the resident checking "
        "service"
    )
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument(
        "--lane", default="2pc check-gpu 4",
        help='lane argv, e.g. "2pc check-gpu 4" (default)',
    )
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the services' device (default cuda: no "
                    "fallback to the CPU)")
    ap.add_argument(
        "--sustained", action="store_true",
        help="ramp->spike->drain against ONE live service over HTTP "
        "with the mid-spike /.metrics scrape and the SLO gate",
    )
    ap.add_argument("--ramp", type=int, default=2,
                    help="ramp-phase clients (sustained mode)")
    ap.add_argument("--spike", type=int, default=None,
                    help="spike-phase clients (default: --clients)")
    ap.add_argument("--drain", type=int, default=2,
                    help="drain-phase clients (sustained mode)")
    ap.add_argument("--slo-ttv-p50", type=float, default=None,
                    help="SLO: max p50 time-to-verdict (seconds)")
    ap.add_argument("--slo-ttv-p99", type=float, default=600.0,
                    help="SLO: max p99 time-to-verdict (seconds)")
    ap.add_argument("--slo-max-refusal-rate", type=float,
                    default=0.0, help="SLO: max admission refusal "
                    "rate (0..1)")
    ap.add_argument("--slo-max-queue-wait-p99", type=float,
                    default=600.0,
                    help="SLO: max p99 device-queue wait (seconds)")
    ap.add_argument("--slo-min-cache-hit-rate", type=float,
                    default=None,
                    help="SLO: min warm-start cache-hit rate (0..1)")
    ap.add_argument(
        "--json", action="store_true",
        help="export the TRACE_r* pair and write auto-numbered "
        "SERVE_r*.json (+ SLO_r*.json in sustained mode)",
    )
    ap.add_argument(
        "--root", default=None,
        help="artifact directory for --json (default: the repo root)",
    )
    args = ap.parse_args(argv)
    lane = args.lane.split()

    if args.sustained:
        spec = dict(
            max_ttv_p50_sec=args.slo_ttv_p50,
            max_ttv_p99_sec=args.slo_ttv_p99,
            max_refusal_rate=args.slo_max_refusal_rate,
            max_queue_wait_p99_sec=args.slo_max_queue_wait_p99,
            min_cache_hit_rate=args.slo_min_cache_hit_rate,
        )
        spec = {k: v for k, v in spec.items() if v is not None}
        phases = [
            ("ramp", args.ramp),
            ("spike", args.spike or args.clients),
            ("drain", args.drain),
        ]
        print(f"serve loadtest (sustained): "
              f"{'/'.join(str(c) for _, c in phases)} clients "
              f"ramp/spike/drain x '{args.lane}' on {args.device}")
        return run_sustained(lane, phases, spec, json_out=args.json,
                             root=args.root, device=args.device)[0]

    print(f"serve loadtest: {args.clients} concurrent clients x "
          f"'{args.lane}' on {args.device} (batched: the fused hash "
          "engine, vs fifo-serial: the lane's own engine)")
    return run_ab(lane, args.clients, json_out=args.json, root=args.root,
                  device=args.device)[0]


if __name__ == "__main__":
    sys.exit(main())
