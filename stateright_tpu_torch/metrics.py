"""The live metrics plane: a registry, the tracer->metrics bridge, rollups
and the SLO gate.

A copy of the JAX package's ``metrics`` module (the port imports
nothing of that package); it imports no torch either. What it holds:

* **Registry** (:class:`MetricsRegistry`): thread-safe counters, gauges
  and fixed log-bucket streaming histograms (:data:`SECONDS_BUCKETS`,
  sub-ms to minutes), labeled; families are get-or-create by name.
* **No cost when inactive**: with no registry activated the module
  hooks (:func:`counter` / :func:`gauge` / :func:`histogram`) return one
  shared no-op singleton (:data:`_NULL`, ``__slots__ = ()``). The
  engines make no metrics calls at all: their signals arrive through
  the bridge.
* **Tracer->metrics bridge** (:func:`bridge_events`): folds a validated
  telemetry event stream (chunk walls, ``program_build`` tiers, spills,
  checkpoints, watchdog timeouts, degrades, shard health, evictions,
  ``batch`` occupancy, the verdict timeline, session brackets) into
  registry families. The same function feeds a live registry and
  replays a committed trace.
* **Export**: the Prometheus text format
  (:meth:`MetricsRegistry.render_prometheus`, read back by
  :func:`parse_prometheus`), periodic JSONL rollups (:class:`Rollup`,
  one ``metrics_rollup`` event a tick, which loads and validates through
  telemetry's ``load_trace`` / ``validate_events``; the CLI's
  ``--metrics-interval``), and a JSON snapshot.
* **Quantiles**: :func:`quantile` (exact, small samples) and
  :func:`bucket_quantile` (interpolated over histogram buckets).
* **SLO layer**: a declarative spec (:data:`SLO_OBJECTIVES`),
  :func:`evaluate_slo` over an observed block (:func:`slo_observed`) and
  the ``SLO_r*`` artifact (:func:`write_slo_artifact`, its own round
  sequence, summarized by ``artifacts.latest_slo_summary``).
"""

from __future__ import annotations

import json
import math
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Callable, Optional

#: fixed log-bucket upper bounds (seconds) every streaming histogram
#: defaults to: the 1-2.5-5 decade ladder from 100 µs (the sub-ms
#: dispatch/queue lanes) to 5 minutes (cold-compile time-to-verdict
#: tails past the 60 s mark), +Inf implicit as the overflow bucket.
#: Fixed — not per-family — so two histograms are always comparable
#: bucket-for-bucket and a rollup diff never re-bins.
SECONDS_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 60.0, 120.0,
    300.0,
)


# -- quantile math ----------------------------------------------------------


def quantile(values, q: float) -> Optional[float]:
    """Exact linear-interpolated quantile of a small in-memory sample
    (no numpy dependency)."""
    if not values:
        return None
    xs = sorted(values)
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return round(xs[lo] + (xs[hi] - xs[lo]) * (pos - lo), 6)


def bucket_quantile(edges, counts, q: float,
                    vmin: Optional[float] = None,
                    vmax: Optional[float] = None) -> Optional[float]:
    """Streaming quantile estimate over histogram bucket counts
    (``len(counts) == len(edges) + 1``, last bucket is the +Inf
    overflow): find the bucket the rank lands in, interpolate linearly
    inside it. The observed ``vmin``/``vmax`` (tracked by
    :class:`Histogram`) tighten the first/overflow buckets and clamp
    the estimate — without them the overflow bucket degrades to the
    highest finite edge, the Prometheus ``histogram_quantile``
    convention."""
    total = sum(counts)
    if total == 0:
        return None
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= target:
            lower = edges[i - 1] if i > 0 else (
                vmin if vmin is not None else 0.0
            )
            if i < len(edges):
                upper = edges[i]
            else:
                upper = vmax if vmax is not None else edges[-1]
            if upper < lower:
                upper = lower
            frac = (target - cum) / c
            est = lower + (upper - lower) * frac
            if vmin is not None:
                est = max(est, vmin)
            if vmax is not None:
                est = min(est, vmax)
            return round(est, 6)
        cum += c
    return None


# -- metric families ------------------------------------------------------


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class _Family:
    """One named metric family: a dict of label-set -> value cell,
    guarded by the owning registry's lock. Subclasses define the cell
    shape and the mutators."""

    kind = "untyped"

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock
        self._cells: "OrderedDict[tuple, object]" = OrderedDict()

    def label_sets(self) -> list:
        with self._lock:
            return [dict(k) for k in self._cells]


class Counter(_Family):
    """Monotonic counter (Prometheus ``counter``)."""

    kind = "counter"

    def inc(self, n: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._cells[key] = self._cells.get(key, 0.0) + n

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._cells.get(_label_key(labels), 0.0))

    def total(self) -> float:
        """Sum across every label set — the reconciliation view."""
        with self._lock:
            return float(sum(self._cells.values()))


class Gauge(_Family):
    """Set/inc/dec point-in-time value (Prometheus ``gauge``)."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._cells[_label_key(labels)] = float(v)

    def inc(self, n: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._cells[key] = self._cells.get(key, 0.0) + n

    def dec(self, n: float = 1.0, **labels) -> None:
        self.inc(-n, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._cells.get(_label_key(labels), 0.0))


class _HistCell:
    __slots__ = ("counts", "sum", "count", "min", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets
        self.sum = 0.0
        self.count = 0
        self.min: Optional[float] = None
        self.max: Optional[float] = None


class Histogram(_Family):
    """Fixed log-bucket streaming histogram: per label set, one count
    per bucket plus exact sum/count and the observed min/max (which
    tighten :func:`bucket_quantile`'s first/overflow buckets). The
    bucket layout is :data:`SECONDS_BUCKETS` unless pinned at
    creation."""

    kind = "histogram"

    def __init__(self, name: str, help: str, lock: threading.Lock,
                 buckets=SECONDS_BUCKETS):
        super().__init__(name, help, lock)
        self.buckets = tuple(buckets)

    def _bucket_index(self, v: float) -> int:
        for i, edge in enumerate(self.buckets):
            if v <= edge:
                return i
        return len(self.buckets)

    def observe(self, v: float, **labels) -> None:
        if v is None or not math.isfinite(v):
            return
        key = _label_key(labels)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = _HistCell(
                    len(self.buckets) + 1
                )
            cell.counts[self._bucket_index(v)] += 1
            cell.sum += v
            cell.count += 1
            cell.min = v if cell.min is None else min(cell.min, v)
            cell.max = v if cell.max is None else max(cell.max, v)

    def _cell(self, labels) -> Optional[_HistCell]:
        return self._cells.get(_label_key(labels))

    def count(self, **labels) -> int:
        with self._lock:
            cell = self._cell(labels)
            return cell.count if cell is not None else 0

    def sum(self, **labels) -> float:
        with self._lock:
            cell = self._cell(labels)
            return cell.sum if cell is not None else 0.0

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Bucket-interpolated streaming quantile (the pair of the
        exact :func:`quantile`, pinned against it by the metrics
        tests)."""
        with self._lock:
            cell = self._cell(labels)
            if cell is None:
                return None
            counts = list(cell.counts)
            vmin, vmax = cell.min, cell.max
        return bucket_quantile(self.buckets, counts, q,
                               vmin=vmin, vmax=vmax)


# -- the registry ---------------------------------------------------------


class MetricsRegistry:
    """Thread-safe process- or service-wide metric registry: families
    are get-or-create by name (a kind conflict raises — one name, one
    type, the Prometheus contract), snapshots are JSON-able, and the
    text rendering is the Prometheus exposition format."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: "OrderedDict[str, _Family]" = OrderedDict()
        self._t0 = time.monotonic()

    def _get(self, cls, name: str, help: str, **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = cls(name, help, self._lock, **kw)
                self._families[name] = fam
                return fam
        if not isinstance(fam, cls):
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}, "
                f"not {cls.kind}"
            )
        return fam

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=SECONDS_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    # -- value helpers (the /.status compact block, SLO derivation) ---

    def counter_value(self, name: str, **labels) -> float:
        with self._lock:
            fam = self._families.get(name)
        return fam.value(**labels) if isinstance(fam, Counter) else 0.0

    def gauge_value(self, name: str, **labels) -> float:
        with self._lock:
            fam = self._families.get(name)
        return fam.value(**labels) if isinstance(fam, Gauge) else 0.0

    def histogram_quantile(self, name: str, q: float,
                           **labels) -> Optional[float]:
        with self._lock:
            fam = self._families.get(name)
        if not isinstance(fam, Histogram):
            return None
        return fam.quantile(q, **labels)

    # -- export -------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able dump of every family: the rollup payload."""
        out: dict = {}
        with self._lock:
            fams = list(self._families.items())
        for name, fam in fams:
            with self._lock:
                cells = list(fam._cells.items())
            entry: dict = dict(kind=fam.kind, help=fam.help)
            if isinstance(fam, Histogram):
                entry["buckets"] = list(fam.buckets)
                entry["values"] = [
                    dict(labels=dict(k), counts=list(c.counts),
                         sum=round(c.sum, 6), count=c.count,
                         min=c.min, max=c.max)
                    for k, c in cells
                ]
            else:
                entry["values"] = [
                    dict(labels=dict(k), value=v) for k, v in cells
                ]
            out[name] = entry
        return out

    def rollup_event(self, t: Optional[float] = None) -> dict:
        """One ``metrics_rollup`` telemetry event: the snapshot under
        the schema telemetry.validate_events checks (registered in
        telemetry._REQUIRED), so rollup JSONL files load and validate
        exactly like TRACE artifacts."""
        if t is None:
            t = time.monotonic() - self._t0
        return dict(ev="metrics_rollup", t=round(t, 6),
                    families=self.snapshot())

    def render_prometheus(self) -> str:
        """The Prometheus text exposition format (version 0.0.4):
        HELP/TYPE headers, ``_bucket``/``_sum``/``_count`` expansion
        for histograms with cumulative ``le`` buckets, escaped label
        values."""
        lines: list[str] = []
        with self._lock:
            fams = list(self._families.items())
        for name, fam in fams:
            if fam.help:
                lines.append(f"# HELP {name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {name} {fam.kind}")
            with self._lock:
                cells = list(fam._cells.items())
            if isinstance(fam, Histogram):
                for key, cell in cells:
                    base = dict(key)
                    cum = 0
                    for edge, c in zip(fam.buckets, cell.counts):
                        cum += c
                        lines.append(
                            f"{name}_bucket"
                            f"{_render_labels(base, le=_fmt_num(edge))}"
                            f" {cum}"
                        )
                    cum += cell.counts[-1]
                    lines.append(
                        f"{name}_bucket"
                        f"{_render_labels(base, le='+Inf')} {cum}"
                    )
                    lines.append(
                        f"{name}_sum{_render_labels(base)} "
                        f"{_fmt_num(cell.sum)}"
                    )
                    lines.append(
                        f"{name}_count{_render_labels(base)} "
                        f"{cell.count}"
                    )
            else:
                if not cells:
                    continue
                for key, v in cells:
                    lines.append(
                        f"{name}{_render_labels(dict(key))} "
                        f"{_fmt_num(v)}"
                    )
        return "\n".join(lines) + "\n"


def _fmt_num(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (str(s).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _render_labels(labels: dict, **extra) -> str:
    items = list(labels.items()) + list(extra.items())
    if not items:
        return ""
    body = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in items
    )
    return "{" + body + "}"


def parse_prometheus(text: str) -> dict:
    """Parse the exposition format BACK into a snapshot-shaped
    families dict — the live-endpoint half of tools/slo_report.py
    (scrape ``GET /.metrics``, evaluate the SLO against it). Handles
    exactly what :meth:`MetricsRegistry.render_prometheus` emits:
    TYPE headers, escaped labels, cumulative histogram buckets
    (de-cumulated into per-bucket counts; observed min/max are not in
    the text format, so quantiles from a scrape interpolate on edges
    alone)."""
    kinds: dict = {}
    samples: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, kind = rest.partition(" ")
            kinds[name] = kind.strip()
            continue
        if line.startswith("#"):
            continue
        name, labels, value = _parse_sample(line)
        samples.setdefault(name, []).append((labels, value))
    out: dict = {}
    for name, kind in kinds.items():
        if kind == "histogram":
            out[name] = _assemble_histogram(name, samples)
        else:
            out[name] = dict(kind=kind, help="", values=[
                dict(labels=labels, value=value)
                for labels, value in samples.get(name, [])
            ])
    return out


def _parse_sample(line: str) -> tuple:
    if "{" in line:
        name, _, rest = line.partition("{")
        body, _, tail = rest.rpartition("}")
        labels = _parse_labels(body)
        value = float(tail.strip())
    else:
        name, _, tail = line.partition(" ")
        labels = {}
        value = float(tail.strip())
    return name, labels, value


def _parse_labels(body: str) -> dict:
    labels: dict = {}
    i = 0
    while i < len(body):
        eq = body.index("=", i)
        key = body[i:eq].strip().lstrip(",").strip()
        assert body[eq + 1] == '"', body
        j = eq + 2
        val = []
        while body[j] != '"':
            if body[j] == "\\":
                nxt = body[j + 1]
                val.append({"n": "\n", "\\": "\\", '"': '"'}
                           .get(nxt, nxt))
                j += 2
            else:
                val.append(body[j])
                j += 1
        labels[key] = "".join(val)
        i = j + 1
    return labels


def _assemble_histogram(name: str, samples: dict) -> dict:
    cells: dict = {}
    edges: list = []
    for labels, value in samples.get(f"{name}_bucket", []):
        le = labels.pop("le", None)
        key = _label_key(labels)
        cell = cells.setdefault(
            key, dict(labels=labels, cum=[], sum=0.0, count=0)
        )
        edge = math.inf if le == "+Inf" else float(le)
        cell["cum"].append((edge, value))
        if edge is not math.inf and edge not in edges:
            edges.append(edge)
    for labels, value in samples.get(f"{name}_sum", []):
        cells.setdefault(
            _label_key(labels),
            dict(labels=labels, cum=[], sum=0.0, count=0),
        )["sum"] = value
    for labels, value in samples.get(f"{name}_count", []):
        cells.setdefault(
            _label_key(labels),
            dict(labels=labels, cum=[], sum=0.0, count=0),
        )["count"] = int(value)
    edges.sort()
    values = []
    for cell in cells.values():
        cum = [v for _, v in sorted(cell["cum"],
                                    key=lambda p: p[0])]
        counts = [
            int(cum[i] - (cum[i - 1] if i else 0))
            for i in range(len(cum))
        ]
        values.append(dict(
            labels=cell["labels"], counts=counts,
            sum=cell["sum"], count=cell["count"],
            min=None, max=None,
        ))
    return dict(kind="histogram", help="", buckets=edges,
                values=values)


# -- near-zero-overhead module hooks (the tracer discipline) --------------

_ACTIVE: Optional[MetricsRegistry] = None
_ACTIVE_LOCK = threading.Lock()


def active_registry() -> Optional[MetricsRegistry]:
    """The process-activated registry, or None (the common,
    zero-overhead case — the module hooks guard on this exactly like
    telemetry.current_tracer)."""
    return _ACTIVE


@contextmanager
def activate(registry: MetricsRegistry):
    """Install ``registry`` as the process-active registry for the
    block (one at a time, the RunTracer.activate contract)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is not None and _ACTIVE is not registry:
            raise RuntimeError(
                "another MetricsRegistry is already active"
            )
        _ACTIVE = registry
    try:
        yield registry
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE = None


class _NullMetric:
    """The shared no-op metric: every mutator is a pass, every reader
    answers zero/None, and ``__slots__ = ()`` pins that the unmetered
    fast path allocates no per-call Python objects (the regression
    test in tests/test_torch_metrics.py)."""

    __slots__ = ()

    def inc(self, n=1.0, **labels):
        pass

    def dec(self, n=1.0, **labels):
        pass

    def set(self, v, **labels):
        pass

    def observe(self, v, **labels):
        pass

    def value(self, **labels):
        return 0.0

    def total(self):
        return 0.0

    def count(self, **labels):
        return 0

    def sum(self, **labels):
        return 0.0

    def quantile(self, q, **labels):
        return None


_NULL = _NullMetric()


def counter(name: str, help: str = ""):
    """Module-level hook: the active registry's counter, or the
    shared no-op singleton — call sites never need a registry
    reference or an if."""
    reg = _ACTIVE
    return _NULL if reg is None else reg.counter(name, help)


def gauge(name: str, help: str = ""):
    reg = _ACTIVE
    return _NULL if reg is None else reg.gauge(name, help)


def histogram(name: str, help: str = ""):
    reg = _ACTIVE
    return _NULL if reg is None else reg.histogram(name, help)


# -- the tracer -> metrics bridge -----------------------------------------

#: the bridge's family names (slo_observed derives the SLO block from
#: them)
BRIDGE_FAMILIES = (
    "stpu_sessions_total",
    "stpu_queue_wait_seconds",
    "stpu_admission_wait_seconds",
    "stpu_admitted_bytes_total",
    "stpu_warm_start_sessions_total",
    "stpu_time_to_verdict_seconds",
    "stpu_verdicts_total",
    "stpu_program_builds_total",
    "stpu_program_build_seconds",
    "stpu_chunks_total",
    "stpu_chunk_dispatch_seconds",
    "stpu_chunk_fetch_seconds",
    "stpu_waves_total",
    "stpu_new_states_total",
    "stpu_tier_spills_total",
    "stpu_tier_spill_rows_total",
    "stpu_checkpoints_total",
    "stpu_checkpoint_bytes_total",
    "stpu_watchdog_timeouts_total",
    "stpu_fault_degrades_total",
    "stpu_shard_health_events_total",
    "stpu_program_evictions_total",
    "stpu_program_evicted_bytes_total",
    "stpu_snapshot_evictions_total",
    "stpu_snapshot_evicted_bytes_total",
    "stpu_batched_sessions_total",
    "stpu_batch_occupancy",
)


def bridge_events(events, registry: Optional[MetricsRegistry] = None,
                  ) -> MetricsRegistry:
    """Fold a telemetry event stream into metric families — the
    tracer→metrics bridge. Pure over its input: feeding the SAME
    events twice doubles the counters, so callers feed each stream
    exactly once (the service bridges a session's tracer at settle;
    the rollup thread rebuilds a fresh registry per tick).

    Derivations mirror the offline tools so the bridge can never
    silently disagree with them (pinned by the TRACE_r30/r31
    reconciliation test): per-run time-to-verdict is the max verdict
    ``round(t - run_begin.t, 6)`` — exactly serve_summary's
    ``t_since_run`` — and the per-tier build counts aggregate the
    same ``program_build`` rows serve_report tables."""
    reg = registry if registry is not None else MetricsRegistry()
    c_sessions = reg.counter(
        "stpu_sessions_total", "settled sessions by final state"
    )
    h_queue = reg.histogram(
        "stpu_queue_wait_seconds",
        "per-session accumulated FIFO device-gate wait",
    )
    h_adm_wait = reg.histogram(
        "stpu_admission_wait_seconds",
        "submit-to-admit wait per session",
    )
    c_adm_bytes = reg.counter(
        "stpu_admitted_bytes_total",
        "priced resident bytes admitted across sessions",
    )
    c_warm = reg.counter(
        "stpu_warm_start_sessions_total",
        "sessions resumed from a retained warm snapshot",
    )
    h_ttv = reg.histogram(
        "stpu_time_to_verdict_seconds",
        "per-run wall from run begin to the last verdict",
    )
    c_verdicts = reg.counter(
        "stpu_verdicts_total", "property verdicts by kind"
    )
    c_builds = reg.counter(
        "stpu_program_builds_total",
        "compile-cache ledger rows by tier",
    )
    h_build = reg.histogram(
        "stpu_program_build_seconds", "program build-or-fetch walls"
    )
    c_chunks = reg.counter("stpu_chunks_total", "device chunks")
    h_disp = reg.histogram(
        "stpu_chunk_dispatch_seconds", "per-chunk dispatch walls"
    )
    h_fetch = reg.histogram(
        "stpu_chunk_fetch_seconds", "per-chunk host fetch walls"
    )
    c_waves = reg.counter("stpu_waves_total", "BFS waves")
    c_new = reg.counter(
        "stpu_new_states_total", "post-dedup new states"
    )
    c_spills = reg.counter(
        "stpu_tier_spills_total", "hot->cold visited-set spills"
    )
    c_spill_rows = reg.counter(
        "stpu_tier_spill_rows_total", "rows moved hot->cold"
    )
    c_ckpt = reg.counter("stpu_checkpoints_total", "snapshots written")
    c_ckpt_bytes = reg.counter(
        "stpu_checkpoint_bytes_total", "snapshot bytes written"
    )
    c_watchdog = reg.counter(
        "stpu_watchdog_timeouts_total", "hung-dispatch deadline hits"
    )
    c_degrade = reg.counter(
        "stpu_fault_degrades_total", "elastic shard degrades"
    )
    c_health = reg.counter(
        "stpu_shard_health_events_total",
        "shard-health verdicts by kind",
    )
    c_pevict = reg.counter(
        "stpu_program_evictions_total", "program-LRU evictions"
    )
    c_pevict_b = reg.counter(
        "stpu_program_evicted_bytes_total", "program bytes evicted"
    )
    c_sevict = reg.counter(
        "stpu_snapshot_evictions_total", "snapshot-spool evictions"
    )
    c_sevict_b = reg.counter(
        "stpu_snapshot_evicted_bytes_total", "snapshot bytes evicted"
    )
    c_batched = reg.counter(
        "stpu_batched_sessions_total",
        "sessions that rode a fused dispatch",
    )
    h_occupancy = reg.histogram(
        "stpu_batch_occupancy",
        "fused group size per batched session",
        buckets=(1, 2, 4, 8, 16, 32),
    )
    run_t0: dict = {}
    run_ttv: dict = {}
    for ev in events:
        kind = ev.get("ev")
        if kind == "run_begin":
            run_t0[ev.get("run")] = ev.get("t", 0.0)
        elif kind == "session_begin":
            wait = ev.get("admission_wait_sec")
            if wait is not None:
                h_adm_wait.observe(wait)
            if ev.get("admitted_bytes"):
                c_adm_bytes.inc(ev["admitted_bytes"])
        elif kind == "session_end":
            c_sessions.inc(state=str(ev.get("state")))
            if ev.get("queue_wait_sec") is not None:
                h_queue.observe(ev["queue_wait_sec"])
            if ev.get("warm_start"):
                c_warm.inc()
        elif kind == "verdict":
            c_verdicts.inc(kind=str(ev.get("kind")))
            run = ev.get("run")
            t_since = round(
                ev.get("t", 0.0) - run_t0.get(run, 0.0), 6
            )
            prev = run_ttv.get(run)
            if prev is None or t_since > prev:
                run_ttv[run] = t_since
        elif kind == "program_build":
            c_builds.inc(tier=str(ev.get("tier")))
            if ev.get("wall_sec") is not None:
                h_build.observe(ev["wall_sec"])
        elif kind == "chunk":
            c_chunks.inc()
            if ev.get("dispatch_sec") is not None:
                h_disp.observe(ev["dispatch_sec"])
            if ev.get("fetch_sec") is not None:
                h_fetch.observe(ev["fetch_sec"])
        elif kind == "wave":
            c_waves.inc()
            if ev.get("new_states") is not None:
                c_new.inc(ev["new_states"])
        elif kind == "tier_spill":
            c_spills.inc()
            if ev.get("rows") is not None:
                c_spill_rows.inc(ev["rows"])
        elif kind == "checkpoint":
            c_ckpt.inc()
            if ev.get("snapshot_bytes"):
                c_ckpt_bytes.inc(ev["snapshot_bytes"])
        elif kind == "watchdog_timeout":
            c_watchdog.inc()
        elif kind == "fault_degrade":
            c_degrade.inc()
        elif kind == "shard_health":
            c_health.inc(kind=str(ev.get("kind")))
        elif kind == "program_evict":
            c_pevict.inc()
            if ev.get("bytes"):
                c_pevict_b.inc(ev["bytes"])
        elif kind == "snapshot_evict":
            c_sevict.inc()
            if ev.get("bytes"):
                c_sevict_b.inc(ev["bytes"])
        elif kind == "batch":
            c_batched.inc()
            if ev.get("size"):
                h_occupancy.observe(ev["size"])
    for run in sorted(run_ttv):
        h_ttv.observe(run_ttv[run])
    return reg


# -- periodic JSONL rollup (--metrics-interval=N) -------------------------


class Rollup:
    """Append one ``metrics_rollup`` JSONL line every ``interval_sec``
    (plus a final one at :meth:`stop`): the headless/long-mesh-run
    export — no HTTP server, no scrape loop, just a file that loads
    and validates through telemetry's load_trace/validate_events.
    ``source`` returns the registry to snapshot each tick: the CLI check
    lanes pass a closure that rebuilds one from the active tracer
    through the bridge (cumulative since the start, so successive lines
    diff like counters)."""

    def __init__(self, path: str, interval_sec: float,
                 source: Callable[[], MetricsRegistry]):
        if interval_sec <= 0:
            raise ValueError(
                f"metrics interval must be > 0, got {interval_sec}"
            )
        self.path = path
        self.interval_sec = float(interval_sec)
        self._source = source
        self._t0 = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _write(self) -> None:
        reg = self._source()
        ev = reg.rollup_event(t=time.monotonic() - self._t0)
        with open(self.path, "a") as fh:
            fh.write(json.dumps(ev, sort_keys=True) + "\n")

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_sec):
            try:
                self._write()
            except Exception:
                # the rollup is an export, never a run failure
                pass

    def start(self) -> "Rollup":
        self._thread = threading.Thread(
            target=self._loop, name="metrics-rollup", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the ticker and write one final rollup (so even a run
        shorter than the interval leaves a line)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        try:
            self._write()
        except Exception:
            pass


def load_rollup(path: str) -> dict:
    """The LAST ``metrics_rollup`` line of a rollup JSONL file (the
    cumulative totals), validated through telemetry's loader — raises
    ValueError when the file carries none."""
    from .telemetry import load_trace, validate_events

    events = load_trace(path)
    validate_events(events)
    rollups = [e for e in events if e.get("ev") == "metrics_rollup"]
    if not rollups:
        raise ValueError(f"{path}: no metrics_rollup events")
    return rollups[-1]


# -- the SLO layer --------------------------------------------------------

#: the declarative objective vocabulary: spec key -> (observed key,
#: comparison, unit). A spec is a plain dict using these keys (any
#: subset; unknown keys are refused loudly by evaluate_slo).
SLO_OBJECTIVES = {
    "max_ttv_p50_sec": ("ttv_p50_sec", "<=", "s"),
    "max_ttv_p99_sec": ("ttv_p99_sec", "<=", "s"),
    "max_refusal_rate": ("refusal_rate", "<=", ""),
    "max_queue_wait_p99_sec": ("queue_wait_p99_sec", "<=", "s"),
    "min_cache_hit_rate": ("cache_hit_rate", ">=", ""),
}


def slo_observed(families: dict) -> dict:
    """Derive the observed SLO block from a families snapshot (a
    registry :meth:`~MetricsRegistry.snapshot`, a rollup line's
    ``families``, or a parsed ``/.metrics`` scrape): time-to-verdict
    and queue-wait percentiles from the histogram buckets, the
    refusal rate from the admission counters, the cache-hit rate from
    the warm/cold split. Missing families observe as None
    (unmeasured), never raise."""

    def hist_quantile(name, q):
        fam = families.get(name)
        if not isinstance(fam, dict) or fam.get("kind") != "histogram":
            return None
        edges = fam.get("buckets") or []
        best = None
        for cell in fam.get("values") or []:
            est = bucket_quantile(
                edges, cell.get("counts") or [], q,
                vmin=cell.get("min"), vmax=cell.get("max"),
            )
            if est is not None and (best is None or est > best):
                best = est
        return best

    def counter_sum(name, **labels):
        fam = families.get(name)
        if not isinstance(fam, dict):
            return 0.0
        total = 0.0
        for cell in fam.get("values") or []:
            cl = cell.get("labels") or {}
            if all(cl.get(k) == v for k, v in labels.items()):
                total += cell.get("value") or 0.0
        return total

    accepted = counter_sum(
        "stpu_serve_admission_total", decision="accepted"
    )
    refused = counter_sum(
        "stpu_serve_admission_total", decision="refused"
    )
    warm = counter_sum("stpu_serve_warm_hits_total", result="warm")
    cold = counter_sum("stpu_serve_warm_hits_total", result="cold")
    queue_p99 = hist_quantile("stpu_serve_queue_wait_seconds", 0.99)
    if queue_p99 is None:
        queue_p99 = hist_quantile("stpu_queue_wait_seconds", 0.99)
    return dict(
        ttv_p50_sec=hist_quantile("stpu_time_to_verdict_seconds", 0.5),
        ttv_p99_sec=hist_quantile(
            "stpu_time_to_verdict_seconds", 0.99
        ),
        refusal_rate=(
            round(refused / (accepted + refused), 6)
            if accepted + refused > 0 else None
        ),
        queue_wait_p99_sec=queue_p99,
        cache_hit_rate=(
            round(warm / (warm + cold), 6)
            if warm + cold > 0 else None
        ),
    )


def evaluate_slo(spec: dict, observed: dict) -> dict:
    """Evaluate a declarative SLO spec against an observed block
    (:func:`slo_observed`). Per objective: ``ok`` / ``violated`` /
    ``unmeasured`` (the signal exists in the spec but not in the
    data — a gate cannot claim a pass it didn't measure, so
    unmeasured fails the overall verdict too). Unknown spec keys
    raise ValueError (a typo must not silently gate nothing)."""
    objectives = []
    ok = True
    for key, threshold in sorted(spec.items()):
        if key not in SLO_OBJECTIVES:
            raise ValueError(
                f"unknown SLO objective {key!r} "
                f"(known: {', '.join(sorted(SLO_OBJECTIVES))})"
            )
        if threshold is None:
            continue
        obs_key, op, unit = SLO_OBJECTIVES[key]
        value = observed.get(obs_key)
        if value is None:
            status = "unmeasured"
            ok = False
        elif (value <= threshold if op == "<="
              else value >= threshold):
            status = "ok"
        else:
            status = "violated"
            ok = False
        objectives.append(dict(
            objective=key, threshold=threshold,
            observed=value, op=op, unit=unit, status=status,
        ))
    return dict(ok=ok, objectives=objectives)


def write_slo_artifact(doc: dict, root: Optional[str] = None) -> str:
    """Write one auto-numbered ``SLO_r*.json`` (own round sequence
    like MEM/LAT/SERVE — the gate evaluation over one load test or
    rollup, cross-referenced BY bench provenance via
    ``artifacts.latest_slo_summary``)."""
    from .artifacts import artifact_path, next_round, provenance, \
        repo_root

    root = repo_root() if root is None else root
    path = artifact_path(
        "SLO", "json", root=root,
        round=next_round(root, stems=("SLO",)),
    )
    out = dict(doc)
    out.setdefault("provenance", provenance())
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return path
