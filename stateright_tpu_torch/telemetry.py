"""Run telemetry: structured trace events for check runs.

A copy of the JAX package's ``telemetry`` module (no JAX in it): the
event schema (:data:`SCHEMA_VERSION`, :data:`WAVE_LOG_FIELDS`,
:data:`WAVE_LOG_OPT_FIELDS`, :data:`SHARD_LOG_FIELDS`,
:data:`BUILD_TIERS`, :data:`VERDICT_KINDS`, the ``_REQUIRED`` fields
and :data:`DIFF_COUNTERS` / :data:`SHARD_DIFF_COUNTERS`) is kept
exactly, so the JAX package's tools (``tools/trace_diff.py``,
``shard_report.py``, ``latency_report.py``, ``mem_report.py``) read the
port's traces, and a JAX trace and a port trace of one check diff wave
for wave.

What the port's engines record, and where it comes from:

* **Per-wave events** (``wave``): one a wave, from host values the
  wave already holds — the frontier's live rows, the enabled pairs
  (the candidate count on the dense wave, JAX's dense convention), the
  surviving candidates, the wave's new states, the running unique
  count and the depth entering the wave; ``canonical_hits`` with
  symmetry on. The port has no class ladder, so ``f_class`` and
  ``v_class`` are null (no reader of a trace does arithmetic on them).
  The hash engine, like JAX's, keeps no wave log: its chunks land
  without waves.
* **Per-shard wave events** (``shard_wave``) from the sharded engines
  (parallel/): one a (wave, shard), from the S×S counts matrix the
  exchange reads at the wave's one host sync.
* **Chunk events**: one wave a chunk (the port syncs every wave). A
  wave's blocking host reads go through one timed helper
  (``checkers.tpu.host_read``); their sum is the chunk's ``fetch_sec``
  and the rest of the wave its ``dispatch_sec``. ``level="deep"``
  synchronizes the device before the wave's first read and records the
  wait as ``device_sec``; its wave walls are exact (``t_est`` false).
* **Host-phase spans**: compile, seed and restore uploads,
  counterexample reconstruction and its two halves, symmetry
  canonicalization and property checks of the host checkers.
* **Latency events**: ``program_build`` (ops/cuda_build.py: ``cold``
  where nvcc ran, ``disk`` where a built library was loaded,
  ``in_process`` for the process's cached library), per-property
  ``verdict`` events, and the run-end ``latency_profile`` the tracer
  derives itself from the run's chunk, span and build events.
* **Memory events**: ``memory_plan`` (memplan.py; the port fills its
  plan at the end of a run, so the event lands there), per-chunk
  ``mem_bytes`` and the run-end ``memory_watermark``.
* **Durability and health events**: ``checkpoint``,
  ``checkpoint_cadence``, ``restore``, ``fault_injected``,
  ``fault_recovery``, ``fault_degrade``, ``watchdog_timeout``,
  ``tier_spill`` and ``shard_health`` (the straggler detector,
  :func:`detect_stragglers`).
* **Exporters**: JSONL (``TRACE_r*.jsonl``, numbered through
  artifacts.py) and Chrome-trace / Perfetto JSON
  (``TRACE_r*.trace.json``), and the wave-aligned differ
  (:func:`diff_traces`, :func:`format_diff`).

Activation is explicit and process-global: the CLI builds a
:class:`RunTracer` and runs the checker inside ``tracer.activate()``;
engines pick it up with :func:`current_tracer` when they run (a plain
global, not a contextvar — the hybrid racer's second thread must see
it). With no tracer active every hook is a no-op.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Any, Optional

#: bump when an event type gains/loses REQUIRED fields.
SCHEMA_VERSION = 1

#: device wave-log lane layout (uint32[waves_per_sync, WAVE_LOG_LANES]
#: in the chunk carry; the engines write one row per wave, the host
#: unpacks rows into ``wave`` events). Lane 1 is 0 on engines that
#: can't see the enabled popcount from the log wrapper (the sharded
#: engine) — those pass ``pairs_valid=False`` and the event carries
#: ``enabled_pairs: null``.
WAVE_LOG_LANES = 9
WAVE_LOG_FIELDS = (
    "frontier_rows",   # live rows entering the wave
    "enabled_pairs",   # enabled-bitmap popcount (sparse single-chip)
    "candidates",      # surviving candidates (what the gen counter adds)
    "new_states",      # post-dedup winners appended to visited
    "unique_total",    # running unique count AFTER the wave
    "depth",           # depth entering the wave
    "f_class",         # frontier ladder class dispatched
    "v_class",         # visited ladder class dispatched
)
#: OPTIONAL trailing lanes past the required WAVE_LOG_FIELDS — lanes
#: an engine writes only when the matching feature is on (writers
#: that stack the 8 required lanes leave the tail zero via the
#: dynamic_update_slice into the [wps, WAVE_LOG_LANES] log, and rows
#: shorter than the lane count simply omit the field from the wave
#: event). ``canonical_hits``: candidates this wave whose canonical
#: form differed from the raw successor (device symmetry reduction,
#: ops/canonical.py) — the per-wave measure of how much symmetry is
#: folding. NOT in the trace-validation REQUIRED set: pre-symmetry
#: traces and engines without the pass stay valid.
WAVE_LOG_OPT_FIELDS = (
    "canonical_hits",  # candidates remapped by canonicalization
)

#: per-SHARD device wave-log lane layout (the round-11 mesh
#: observability layer): the sharded engines additionally keep a
#: ``uint32[waves_per_sync, SHARD_LOG_LANES]`` log PER SHARD that is
#: NOT psum-collapsed — it rides the chunk carry next to the global
#: log and is downloaded with the packed stats (one extra device
#: array in the same sync; no extra round trip). The host unpacks
#: rows into ``shard_wave`` events, one per (wave, shard).
#: ``enabled_pairs`` here is measured INSIDE the wave switch, so it is
#: real on the sharded engine too (the global log's lane 1 can't see
#: it and records null; :meth:`RunTracer.record_chunk` back-fills the
#: global ``wave`` event from the shard sum). On dense paths — which
#: have no (row, slot) pair extraction — the lane holds the candidate
#: count, mirroring the single-chip dense wave's convention.
SHARD_LOG_LANES = 9
SHARD_LOG_FIELDS = (
    "frontier_rows",   # live rows entering the wave on this shard
    "enabled_pairs",   # local enabled-pair popcount (candidates on dense)
    "candidates",      # surviving local candidates
    "routed_rows",     # rows this shard sent to OTHER shards (send side)
    "recv_rows",       # valid rows received after the all_to_all
    "dest_fill_peak",  # peak per-destination send-tile fill this wave
    "dest_cap",        # the lossless per-destination tile cap (Bd_c)
    "new_states",      # post-dedup winners this shard appended
    "visited_total",   # this shard's visited count AFTER the wave
)

#: compile-cache hit tiers a ``program_build`` event may carry
#: (the round-14 compile-cache ledger, checkers/tpu.py):
#: ``in_process`` — served from a same-process cache (the engine's
#: ``_programs`` cache, jit's executable cache, or the memory-analysis
#: result cache) with no XLA work; ``disk`` — the persistent XLA
#: compile cache loaded the executable (wall = retrieval);
#: ``cold`` — a real backend compile (wall = the multi-second cost
#: warm/cold A/Bs attribute); ``mixed`` — one seam covered both
#: (e.g. seed cold + chunk disk in one window); ``unknown`` — the
#: ``jax.monitoring`` hooks were unavailable, tier undecidable.
BUILD_TIERS = ("in_process", "disk", "cold", "mixed", "unknown")

#: what a ``verdict`` event settles as: ``discovery`` — the property
#: found its example/counterexample state; ``exhaustion`` — the search
#: completed without one (an always-property that HOLDS settles only
#: here, which is why time-to-verdict != time-to-first-hit).
VERDICT_KINDS = ("discovery", "exhaustion")

_ACTIVE: Optional["RunTracer"] = None
_ACTIVE_LOCK = threading.Lock()
#: thread-scoped tracer override (the resident service,
#: stateright_tpu/serve.py): each session runs its checker on its own
#: thread with its OWN tracer installed here, so concurrent sessions
#: record into disjoint event streams with zero cross-session bleed —
#: while single-query processes (CLI --trace, bench) keep using the
#: process-global activation, and threads with no override (the hybrid
#: racer's device worker) still see the global tracer.
_TLS = threading.local()


def current_tracer() -> Optional["RunTracer"]:
    """The active tracer for THIS thread — the thread-scoped override
    when one is installed (``RunTracer.activate_thread``), else the
    process-global one — or None (the common, zero-overhead case —
    every instrumentation site guards on this)."""
    tracer = getattr(_TLS, "tracer", None)
    if tracer is not None:
        return tracer
    return _ACTIVE


class _DiscardMeta(dict):
    """The no-op span's meta sink: span bodies may attach fields
    discovered mid-span (the Explorer request handlers' cache-hit
    state) — with no tracer active, writes are discarded outright so
    the shared instance never grows and the untraced hot loops (one
    ``with _NULL_SPAN`` per explored state in the host checkers)
    stay allocation-free."""

    __slots__ = ()

    def __setitem__(self, key, value):
        pass


_NULL_META = _DiscardMeta()


class _NullSpan:
    def __enter__(self):
        return _NULL_META

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def span(phase: str, **meta):
    """Module-level span hook: a real span on the active tracer
    (thread-scoped override first — see :func:`current_tracer`), a
    shared no-op context manager otherwise — call sites never need a
    tracer reference or an if."""
    tracer = current_tracer()
    if tracer is None:
        return _NULL_SPAN
    return tracer.span(phase, **meta)


def emit(ev: str, **fields) -> None:
    """Module-level instant-event hook (no-op without a tracer)."""
    tracer = current_tracer()
    if tracer is not None:
        tracer.event(ev, **fields)


class _PhaseAcc:
    """Reusable accumulating timer for phases that run once per STATE
    (property checks, symmetry canonicalization): entering/exiting
    adds to a per-run total instead of emitting an event per state —
    one ``phase_total`` event lands at run end. Create once, reuse in
    the hot loop."""

    __slots__ = ("tracer", "phase", "_t0")

    def __init__(self, tracer: "RunTracer", phase: str):
        self.tracer = tracer
        self.phase = phase
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.tracer._accumulate(self.phase, time.monotonic() - self._t0)
        return False


class RunTracer:
    """Collects one process's trace events; see the module docstring.

    ``level`` is ``"default"`` (no extra device syncs: exact per-wave
    COUNTS from the chunk wave log, per-chunk wall split, per-wave
    times estimated by even division and flagged ``t_est``) or
    ``"deep"`` (engines force waves_per_sync=1 and block on the carry:
    real per-wave walls and a device/fetch split, at per-wave sync
    cost)."""

    def __init__(self, level: str = "default"):
        if level not in ("default", "deep"):
            raise ValueError(f"unknown trace level {level!r}")
        self.level = level
        self.events: list[dict] = []
        self._t_base = time.monotonic()
        self._lock = threading.Lock()
        self._run_idx = -1
        self._run_open = False
        self._phase_totals: dict[str, list] = {}

    # -- activation ------------------------------------------------------

    @contextmanager
    def activate(self):
        """Install as the process-active tracer for the block."""
        global _ACTIVE
        with _ACTIVE_LOCK:
            if _ACTIVE is not None and _ACTIVE is not self:
                raise RuntimeError("another RunTracer is already active")
            _ACTIVE = self
        try:
            yield self
        finally:
            with _ACTIVE_LOCK:
                _ACTIVE = None

    @contextmanager
    def activate_thread(self):
        """Install as THIS THREAD's tracer for the block (the resident
        service's per-session scope, stateright_tpu/serve.py): every
        instrumentation site reached from this thread — engine chunk
        loops, checkpoint/restore events, Explorer request spans —
        records here instead of the process-global tracer, so
        concurrent sessions trace into disjoint streams. Nests: the
        previous thread-scoped tracer (if any) is restored on exit.
        Threads the session spawns itself (the hybrid racer's worker)
        do NOT inherit the override — they fall back to the global
        tracer, exactly the pre-existing contract."""
        prev = getattr(_TLS, "tracer", None)
        _TLS.tracer = self
        try:
            yield self
        finally:
            _TLS.tracer = prev

    # -- event plumbing --------------------------------------------------

    def _now(self) -> float:
        return time.monotonic() - self._t_base

    def _append(self, ev: dict) -> None:
        with self._lock:
            self.events.append(ev)

    def event(self, ev: str, **fields) -> None:
        """Instant event (auto-budget retries, level overrides, ...)."""
        self._append(
            dict(ev=ev, run=self._run_idx, t=round(self._now(), 6),
                 **fields)
        )

    # -- runs ------------------------------------------------------------

    def begin_run(self, lane: dict | None = None) -> int:
        """Open a run (one checker execution). Embeds provenance —
        the satellite contract: every TRACE artifact names the
        toolchain/device/SHA/lane it measured."""
        from .artifacts import provenance

        with self._lock:
            self._run_idx += 1
            self._run_open = True
            self._phase_totals = {}
            self.events.append(
                dict(
                    ev="run_begin",
                    run=self._run_idx,
                    t=round(self._now(), 6),
                    schema=SCHEMA_VERSION,
                    level=self.level,
                    provenance=provenance(),
                    lane=lane or {},
                )
            )
            return self._run_idx

    def end_run(self, *, error: str | None = None, **stats) -> None:
        if not self._run_open:
            return
        for phase, (dur, count) in sorted(self._phase_totals.items()):
            self._append(
                dict(ev="phase_total", run=self._run_idx, phase=phase,
                     dur=round(dur, 6), count=count)
            )
        prof = self._derive_latency_profile(stats.get("duration_sec"))
        if prof is not None:
            self._append(
                dict(ev="latency_profile", run=self._run_idx,
                     t=round(self._now(), 6), **prof)
            )
        self.event("run_end", error=error,
                   **{k: v for k, v in stats.items()})
        self._run_open = False

    def _derive_latency_profile(self, run_wall) -> Optional[dict]:
        """The run-end wall-clock attribution (the round-14 latency
        layer), derived here — the one place every engine passes
        through — from the run's own chunk / span / ``program_build``
        events, so any engine that records chunks gets the profile
        with zero engine-side accumulation. None for runs without
        chunk events (host checkers: their wall lives in spans and
        phase totals already).

        The lanes are ATTRIBUTIONS over one run wall, not a disjoint
        partition: a cold chunk compile is counted in the compile
        block AND physically sits inside chunk 0's ``dispatch_sec``
        (``dispatch_net_sec`` is dispatch with the ledger-attributed
        compile walls subtracted — the lane trace_diff compares, so a
        forced cold compile flags as compile, not as dispatch).

        The profile covers the WHOLE run — including auto-budget
        retry attempts, whose recompiles and re-explored chunks are
        genuinely where the run's wall went (``attempts`` counts
        them, from chunks restarting at wave 0). The untraced
        ``checker.latency_accounting()`` deliberately differs: it
        resets per attempt and reports the FINAL one (the bench
        lane's converged-budget number)."""
        with self._lock:
            evs = [e for e in self.events
                   if e.get("run") == self._run_idx]
        chunks = [e for e in evs if e["ev"] == "chunk"]
        if not chunks:
            return None
        begin = next((e for e in evs if e["ev"] == "run_begin"), None)
        t_run0 = (begin or {}).get("t", 0.0)
        disp = sum(c["dispatch_sec"] for c in chunks)
        fetch = sum(c["fetch_sec"] for c in chunks)
        dev = sum(c.get("device_sec") or 0.0 for c in chunks)
        chunk_wall = sum(c["t1"] - c["t0"] for c in chunks)
        waves = sum(c.get("waves") or 0 for c in chunks)
        if run_wall is None:
            run_wall = max(
                max((c["t1"] for c in chunks)) - t_run0, 0.0
            )
        builds = [e for e in evs if e["ev"] == "program_build"]
        tiers: dict[str, int] = {}
        for b in builds:
            tiers[b["tier"]] = tiers.get(b["tier"], 0) + 1
        cold = sum(b.get("cold_sec") or 0.0 for b in builds)
        build_wall = sum(b.get("wall_sec") or 0.0 for b in builds)
        chunk_compile = sum(
            b.get("wall_sec") or 0.0 for b in builds
            if b.get("program") == "chunk"
        )
        compile_span = sum(
            s["dur"] for s in evs
            if s["ev"] == "span" and s["phase"] == "compile"
        )
        restores = [e for e in evs if e["ev"] == "restore"]
        return dict(
            chunks=len(chunks),
            waves=waves,
            attempts=sum(
                1 for c in chunks if c.get("wave0") == 0
            ) or 1,
            # set on a run restored from a snapshot: its wave stream
            # (and every wall below) covers the search FROM this wave
            # — time_to_first_wave is time to the first RESUMED
            # wave's visibility, not the killed process's first wave
            # (tools/latency_report.py prints it; the resumed-trace
            # report tests pin that nothing here misattributes)
            resumed_from_wave=(
                min(int(r.get("wave") or 0) for r in restores)
                if restores else None
            ),
            run_wall_sec=round(run_wall, 6),
            # when the FIRST wave's results became host-visible: the
            # end of chunk 0's blocking readback, relative to
            # run_begin (covers compile + seed upload + first chunk)
            time_to_first_wave_sec=round(chunks[0]["t1"] - t_run0, 6),
            dispatch_sec=round(disp, 6),
            dispatch_net_sec=round(max(disp - chunk_compile, 0.0), 6),
            # the sync floor: host wall blocked at the per-chunk
            # stats readback (at level="default" this includes the
            # device wait hidden behind the sync — the honest number
            # for "what the host paid at the sync seam")
            fetch_sec=round(fetch, 6),
            fetch_min_sec=round(
                min(c["fetch_sec"] for c in chunks), 6
            ),
            device_sec=(round(dev, 6) if dev else None),
            chunk_wall_sec=round(chunk_wall, 6),
            # host wall OUTSIDE the chunk brackets: per-chunk host
            # bookkeeping, reporter callbacks, compile/seed spans
            interchunk_sec=round(max(run_wall - chunk_wall, 0.0), 6),
            sync_share=(round(fetch / run_wall, 4)
                        if run_wall else None),
            dispatch_share=(round(disp / run_wall, 4)
                            if run_wall else None),
            overlap_share=(round(dev / chunk_wall, 4)
                           if dev and chunk_wall else None),
            compile=dict(
                span_sec=round(compile_span, 6),
                build_wall_sec=round(build_wall, 6),
                cold_sec=round(cold, 6),
                builds=tiers,
                share=(round((compile_span + build_wall) / run_wall, 4)
                       if run_wall else None),
            ),
        )

    # -- spans / accumulators -------------------------------------------

    @contextmanager
    def span(self, phase: str, **meta):
        """Yields the span's meta dict: fields added to it inside the
        block land on the emitted event (for meta only known mid-span,
        e.g. a request handler's cache-hit state)."""
        t0 = self._now()
        try:
            yield meta
        finally:
            t1 = self._now()
            self._append(
                dict(ev="span", run=self._run_idx, phase=phase,
                     t0=round(t0, 6), t1=round(t1, 6),
                     dur=round(t1 - t0, 6), **meta)
            )

    def record_span(self, phase: str, t0: float, t1: float,
                    **meta) -> None:
        """A span measured elsewhere: ``t0``/``t1`` are absolute
        ``time.monotonic()`` stamps (a compiled encoding's host compile,
        which runs before the run that uses it)."""
        rt0, rt1 = t0 - self._t_base, t1 - self._t_base
        self._append(
            dict(ev="span", run=self._run_idx, phase=phase,
                 t0=round(rt0, 6), t1=round(rt1, 6),
                 dur=round(rt1 - rt0, 6), **meta)
        )

    def phase_acc(self, phase: str) -> _PhaseAcc:
        return _PhaseAcc(self, phase)

    def _accumulate(self, phase: str, dur: float) -> None:
        tot = self._phase_totals.setdefault(phase, [0.0, 0])
        tot[0] += dur
        tot[1] += 1

    # -- engine chunk/wave ingestion -------------------------------------

    def record_chunk(
        self,
        *,
        chunk: int,
        wave0: int,
        t0: float,
        t1: float,
        dispatch_sec: float,
        fetch_sec: float,
        device_sec: float | None = None,
        n_waves: int | None = None,
        wave_rows=None,
        pairs_valid: bool = True,
        shard_rows=None,
        mem_bytes: int | None = None,
    ) -> None:
        """One chunk sync: the host wall split plus the downloaded
        device wave-log rows (``wave_rows``: int array
        [n_waves, WAVE_LOG_LANES]; None for engines without a wave
        log — the chunk event still lands). ``shard_rows`` is the
        per-shard mesh log (int array
        [n_shards, n_waves, SHARD_LOG_LANES]; None off the sharded
        engines) — it lands as one ``shard_wave`` event per
        (wave, shard), and when the GLOBAL log can't see the
        enabled-pair popcount (``pairs_valid=False``) the wave event's
        ``enabled_pairs`` is back-filled from the shard sum, closing
        the sharded ``enabled_pairs=null`` hole. ``t0``/``t1`` are
        absolute ``time.monotonic()`` stamps bracketing
        dispatch→fetch. ``mem_bytes`` is the device bytes-in-use the
        engine polled at this sync (memplan.device_bytes_in_use —
        OPTIONAL so pre-round-12 traces stay valid; None means not
        polled)."""
        rt0 = t0 - self._t_base
        rt1 = t1 - self._t_base
        if wave_rows is not None and n_waves is None:
            n_waves = len(wave_rows)
        self._append(
            dict(
                ev="chunk", run=self._run_idx, chunk=chunk,
                wave0=wave0, waves=n_waves,
                t0=round(rt0, 6), t1=round(rt1, 6),
                dispatch_sec=round(dispatch_sec, 6),
                device_sec=(None if device_sec is None
                            else round(device_sec, 6)),
                fetch_sec=round(fetch_sec, 6),
                **({"mem_bytes": int(mem_bytes)}
                   if mem_bytes is not None else {}),
            )
        )
        if wave_rows is None or n_waves is None or n_waves == 0:
            if shard_rows is not None and n_waves != 0:
                # loud, not silent: shard rows borrow their wave's
                # identity (and its Chrome interval) — an engine that
                # logs per-shard without a global log is a contract
                # violation, not an empty trace
                raise ValueError(
                    "record_chunk: shard_rows without wave_rows — "
                    "the per-shard mesh log requires the global wave "
                    "log (shard_wave events hang off wave events)"
                )
            return
        # Default level: the chunk ran async, so per-wave walls don't
        # exist — spread the chunk interval evenly and flag the
        # estimate. Deep level (1 wave/chunk): the division is exact.
        per = (rt1 - rt0) / n_waves
        est = not (self.level == "deep" and n_waves == 1)
        for i in range(n_waves):
            # the port's rows carry None for the ladder classes it has
            # not got (f_class, v_class)
            row = [None if x is None else int(x) for x in wave_rows[i]]
            fields = dict(zip(WAVE_LOG_FIELDS, row))
            for j, name in enumerate(WAVE_LOG_OPT_FIELDS):
                k = len(WAVE_LOG_FIELDS) + j
                if k < len(row):
                    fields[name] = row[k]
            if not pairs_valid:
                if shard_rows is not None:
                    # lane 1 of SHARD_LOG_FIELDS, summed over shards
                    fields["enabled_pairs"] = int(
                        sum(int(sr[i][1]) for sr in shard_rows)
                    )
                else:
                    fields["enabled_pairs"] = None
            self._append(
                dict(
                    ev="wave", run=self._run_idx, wave=wave0 + i,
                    chunk=chunk,
                    t0=round(rt0 + i * per, 6),
                    t1=round(rt0 + (i + 1) * per, 6),
                    t_est=est,
                    **fields,
                )
            )
            if shard_rows is not None:
                for s, srows in enumerate(shard_rows):
                    self._append(
                        dict(
                            ev="shard_wave", run=self._run_idx,
                            wave=wave0 + i, chunk=chunk, shard=s,
                            **dict(zip(SHARD_LOG_FIELDS,
                                       [int(x) for x in srows[i]])),
                        )
                    )

    # -- exporters -------------------------------------------------------

    def write_jsonl(self, path: str) -> str:
        with open(path, "w") as fh:
            with self._lock:
                for ev in self.events:
                    fh.write(json.dumps(ev, sort_keys=True) + "\n")
        return path

    def write_chrome_trace(self, path: str) -> str:
        """Chrome-trace / Perfetto JSON: host phases, device chunks,
        and waves on three named tracks — plus one track PER SHARD
        when the trace carries ``shard_wave`` events (tid 3+shard, so
        a mesh run's per-shard load renders side by side) — and
        counter tracks for the frontier/new-state curves
        (``chrome://tracing`` or ui.perfetto.dev)."""
        with self._lock:
            events = list(self.events)
        out: list[dict] = []
        for pid, name in ((0, "stateright_tpu_torch"),):
            out.append(dict(ph="M", pid=pid, name="process_name",
                            args=dict(name=name)))
        tracks = [(0, "host phases"), (1, "device chunks"),
                  (2, "waves")]
        shards = sorted({ev["shard"] for ev in events
                         if ev.get("ev") == "shard_wave"})
        tracks += [(3 + s, f"shard {s}") for s in shards]
        for tid, name in tracks:
            out.append(dict(ph="M", pid=0, tid=tid, name="thread_name",
                            args=dict(name=name)))
        # shard_wave events carry no walls of their own: they borrow
        # their wave's interval, so index those intervals first.
        wave_span = {
            (ev["run"], ev["wave"]): (ev["t0"], ev["t1"])
            for ev in events if ev.get("ev") == "wave"
        }

        def us(t):
            return round(t * 1e6, 1)

        for ev in events:
            kind = ev.get("ev")
            if kind == "shard_wave":
                t0, t1 = wave_span.get(
                    (ev["run"], ev["wave"]), (0.0, 0.0)
                )
                out.append(
                    dict(ph="X", pid=0, tid=3 + ev["shard"],
                         name=f"wave {ev['wave']}",
                         ts=us(t0), dur=us(t1 - t0),
                         args={k: ev[k] for k in SHARD_LOG_FIELDS})
                )
            elif kind == "span":
                out.append(
                    dict(ph="X", pid=0, tid=0, name=ev["phase"],
                         ts=us(ev["t0"]), dur=us(ev["dur"]),
                         args={k: v for k, v in ev.items()
                               if k not in ("ev", "t0", "t1", "dur")})
                )
            elif kind == "chunk":
                out.append(
                    dict(ph="X", pid=0, tid=1,
                         name=f"chunk {ev['chunk']}",
                         ts=us(ev["t0"]),
                         dur=us(ev["t1"] - ev["t0"]),
                         args={k: ev[k] for k in
                               ("run", "waves", "dispatch_sec",
                                "device_sec", "fetch_sec")})
                )
                if ev.get("mem_bytes") is not None:
                    # memory watermark as a counter track: the
                    # bytes-in-use curve next to the frontier curve
                    out.append(
                        dict(ph="C", pid=0, name="mem_bytes",
                             ts=us(ev["t1"]),
                             args=dict(bytes=ev["mem_bytes"]))
                    )
                # sync-floor counter track (round 14): the per-chunk
                # host-blocked wall next to the frontier curve, so a
                # sync-floor regression is visible as a raised floor
                out.append(
                    dict(ph="C", pid=0, name="host_blocked_ms",
                         ts=us(ev["t1"]),
                         args=dict(ms=round(ev["fetch_sec"] * 1e3, 3)))
                )
            elif kind == "wave":
                args = {k: ev[k] for k in WAVE_LOG_FIELDS}
                args["t_est"] = ev["t_est"]
                out.append(
                    dict(ph="X", pid=0, tid=2,
                         name=f"wave {ev['wave']}",
                         ts=us(ev["t0"]),
                         dur=us(ev["t1"] - ev["t0"]), args=args)
                )
                out.append(
                    dict(ph="C", pid=0, name="frontier_rows",
                         ts=us(ev["t0"]),
                         args=dict(rows=ev["frontier_rows"]))
                )
                out.append(
                    dict(ph="C", pid=0, name="new_states",
                         ts=us(ev["t0"]),
                         args=dict(new=ev["new_states"]))
                )
            elif kind == "verdict":
                # verdicts as global instants on the host track: the
                # per-property settle moments read directly off the
                # timeline (the time-to-verdict markers)
                out.append(
                    dict(ph="i", pid=0, tid=0, s="g",
                         name=f"verdict {ev['property']}",
                         ts=us(ev.get("t", 0.0)),
                         args={k: v for k, v in ev.items()
                               if k not in ("ev", "t")})
                )
            elif kind in ("run_begin", "run_end", "phase_total"):
                out.append(
                    dict(ph="i", pid=0, tid=0, s="g", name=kind,
                         ts=us(ev.get("t", ev.get("dur", 0.0))
                               if kind != "phase_total"
                               else events[0].get("t", 0.0)),
                         args={k: v for k, v in ev.items()
                               if k != "ev"})
                )
            else:  # instant engine events (auto_budget_retry, ...)
                out.append(
                    dict(ph="i", pid=0, tid=1, s="t", name=kind,
                         ts=us(ev.get("t", 0.0)),
                         args={k: v for k, v in ev.items()
                               if k not in ("ev", "t")})
                )
        with open(path, "w") as fh:
            json.dump(dict(traceEvents=out, displayTimeUnit="ms"), fh)
        return path


def write_artifacts(tracer: RunTracer, root: str | None = None,
                    round: int | None = None) -> tuple[str, str]:
    """Write the auto-numbered artifact PAIR (JSONL + Chrome trace)
    into one round slot beside the BENCH/LINT artifacts."""
    from .artifacts import artifact_path, next_round, repo_root

    root = repo_root() if root is None else root
    if round is None:
        round = next_round(root)
    jsonl = tracer.write_jsonl(
        artifact_path("TRACE", "jsonl", root=root, round=round)
    )
    chrome = tracer.write_chrome_trace(
        artifact_path("TRACE", "trace.json", root=root, round=round)
    )
    return jsonl, chrome


# -- trace loading / validation / diff -----------------------------------
#
# The logic behind tools/trace_diff.py lives here so tests import it the
# way the lint tests import stateright_tpu.analysis.

_REQUIRED = {
    "run_begin": ("run", "schema", "level", "provenance", "lane"),
    "run_end": ("run", "t"),
    "span": ("run", "phase", "t0", "t1", "dur"),
    "phase_total": ("run", "phase", "dur", "count"),
    "chunk": ("run", "chunk", "wave0", "t0", "t1", "dispatch_sec",
              "fetch_sec"),
    "wave": ("run", "wave", "chunk", "t0", "t1", "t_est")
    + WAVE_LOG_FIELDS,
    "shard_wave": ("run", "wave", "chunk", "shard")
    + SHARD_LOG_FIELDS,
    # The memory observability layer (round 12, memplan.py). ``chunk``
    # events gained an OPTIONAL ``mem_bytes`` lane (not listed above:
    # pre-round-12 traces must stay valid); these two are whole new
    # event types, so their contracts are required outright.
    "memory_plan": ("run", "engine", "resident", "resident_bytes",
                    "classes", "compiled", "total_bytes"),
    "memory_watermark": ("run", "source", "device_peak_bytes",
                         "headroom", "projection"),
    # The latency observability layer (round 14). ``program_build`` —
    # one compile-cache ledger row per build-or-fetch (checkers/
    # tpu.py); ``verdict`` — one per property settle (device chunk
    # loop, host _discover, and the run-end exhaustion sweep);
    # ``latency_profile`` — the run-end wall attribution the tracer
    # derives itself (RunTracer._derive_latency_profile). All three
    # are whole new event types, so their contracts are required
    # outright; pre-round-14 traces simply don't carry them.
    "program_build": ("run", "program", "tier", "wall_sec"),
    "verdict": ("run", "property", "expectation", "kind", "t"),
    "latency_profile": ("run", "chunks", "waves", "run_wall_sec",
                        "time_to_first_wave_sec", "dispatch_sec",
                        "fetch_sec", "sync_share", "compile"),
    # The durability layer (checkpoint/resume, stateright_tpu/
    # checkpoint.py + faultinject.py): ``checkpoint`` — one atomic
    # snapshot written at the per-chunk sync; ``restore`` — a run
    # began from a snapshot instead of the seed (its wave stream
    # starts at ``wave``, which the resume-aware trace_diff alignment
    # reads); ``fault_injected`` — a deterministic harness fault
    # fired; ``fault_recovery`` — the supervisor retried from a
    # snapshot after a supervised failure.
    "checkpoint": ("run", "path", "chunk", "wave", "depth",
                   "snapshot_bytes"),
    "restore": ("run", "wave", "depth", "from_shards", "to_shards"),
    "fault_injected": ("run", "site", "chunk", "action"),
    "fault_recovery": ("run", "attempt", "error"),
    # The tiered visited set (stateright_tpu/tier.py): one event per
    # hot->cold spill — rows/bytes moved this spill, the cold tier's
    # running totals, the hot rows before the reset, and the worker-
    # side ingest wall (overlapped with the next dispatch). Counts
    # and totals are EXACT exploration facts (trace_diff compares
    # them exactly between two tiered runs); walls are timing lanes.
    "tier_spill": ("run", "rows", "hot_rows_before", "cold_rows_total",
                   "cold_bytes_total", "runs", "spill_index"),
    # The degrade-and-continue layer (checkpoint.FailurePolicy + the
    # hung-dispatch watchdog + the health layer): ``shard_health`` —
    # one per straggler verdict (telemetry.detect_stragglers over the
    # existing per-shard wave log); ``fault_degrade`` — the
    # supervisor dropped a persistently-faulting shard and re-sharded
    # the last snapshot onto the survivors (old -> new shard count,
    # re-routed row total); ``watchdog_timeout`` — a chunk
    # dispatch+sync exceeded its derived deadline (full latency
    # attribution rides the event).
    "shard_health": ("run", "shard", "wave", "kind", "factor"),
    "fault_degrade": ("run", "from_shards", "to_shards", "reason"),
    "watchdog_timeout": ("run", "chunk", "deadline_sec"),
    # The resident checking service (stateright_tpu/serve.py):
    # ``session_begin`` — a query was admitted (kind check/explorer,
    # the admission pricing, the wait from submit to admit);
    # ``session_end`` — the query settled (state, counts, the total
    # device-queue wait, warm-start flag, program-cache key);
    # ``program_evict`` — the compiled-program LRU dropped an entry
    # to stay under its byte budget (keyed like the ``_programs``/XLA
    # cache, priced by the memplan ledger). These land in the
    # service's MERGED trace export (one run index per session), which
    # tools/serve_report.py derives SERVE_r* artifacts from.
    "session_begin": ("run", "session", "kind", "t"),
    "session_end": ("run", "session", "state", "t"),
    "program_evict": ("run", "key", "bytes", "t"),
    # The wave batcher (stateright_tpu/batch.py): ``batch`` — this
    # session's run was a lane of a fused multi-session dispatch
    # (group id, fused size, this session's lane index); its chunk
    # walls carry the 1/N_active amortized shares and its
    # program_build rows are re-emitted 1/N-amortized with a
    # ``batch`` marker. ``snapshot_evict`` — the retained-warm-start
    # snapshot spool dropped an entry to stay under its byte budget
    # (the snapshot analogue of ``program_evict``; the next re-check
    # of that fingerprint runs cold, counts unaffected).
    "batch": ("run", "group", "size", "index", "t"),
    "snapshot_evict": ("run", "key", "bytes", "t"),
    # The live metrics plane (stateright_tpu/metrics.py): one
    # cumulative registry snapshot per ``--metrics-interval`` tick —
    # the headless JSONL export (Rollup). ``families`` is the full
    # JSON-able family dump (counters/gauges/histogram buckets); the
    # file loads and validates exactly like a TRACE artifact, which is
    # what lets tools/slo_report.py gate on it.
    "metrics_rollup": ("t", "families"),
}


def load_trace(path: str) -> list[dict]:
    """Parse a TRACE_r*.jsonl file; raises ValueError on malformed
    lines."""
    events = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError as exc:
                raise ValueError(
                    f"{path}:{lineno}: not JSON: {exc}"
                ) from exc
            if not isinstance(ev, dict) or "ev" not in ev:
                raise ValueError(
                    f"{path}:{lineno}: event without an 'ev' field"
                )
            events.append(ev)
    return events


def validate_events(events: list[dict]) -> None:
    """Schema check: every known event type carries its required
    fields, runs open with run_begin, and wave counters are internally
    consistent (unique_total is the running post-dedup sum). A wave
    index that does NOT advance marks an auto-budget retry restart
    (the resized attempt re-explores from wave 0 inside the same run)
    — the running-sum check resets there instead of rejecting the
    legitimate artifact. Raises ValueError on the first violation."""
    open_runs: set[int] = set()
    last_unique: dict[int, int] = {}
    last_wave: dict[int, int] = {}
    # per (run, shard): the same running-sum check over the per-shard
    # visited counter (visited_total is u_loc AFTER the wave)
    last_visited: dict[tuple, int] = {}
    last_shard_wave: dict[tuple, int] = {}
    for i, ev in enumerate(events):
        kind = ev["ev"]
        for field in _REQUIRED.get(kind, ()):
            if field not in ev:
                raise ValueError(
                    f"event {i} ({kind}): missing field {field!r}"
                )
        if kind == "run_begin":
            if ev["schema"] > SCHEMA_VERSION:
                raise ValueError(
                    f"event {i}: schema {ev['schema']} newer than "
                    f"reader ({SCHEMA_VERSION})"
                )
            open_runs.add(ev["run"])
        elif kind == "restore":
            # an in-process supervised retry restored from a snapshot
            # mid-run: the running sums re-seed — the resumed segment
            # restarts behind the failed attempt's furthest wave, and
            # a DEGRADED restore additionally re-routes rows between
            # shards, so per-shard visited totals are legitimately
            # discontinuous across this point
            run = ev["run"]
            last_unique.pop(run, None)
            last_wave.pop(run, None)
            for key in [k for k in last_visited if k[0] == run]:
                last_visited.pop(key)
            for key in [k for k in last_shard_wave if k[0] == run]:
                last_shard_wave.pop(key)
        elif kind == "wave":
            run = ev["run"]
            if run not in open_runs:
                raise ValueError(
                    f"event {i}: wave outside an open run"
                )
            if run in last_wave and ev["wave"] <= last_wave[run]:
                last_unique.pop(run, None)  # retry restart
            prev = last_unique.get(run)
            if prev is not None and ev["unique_total"] != (
                prev + ev["new_states"]
            ):
                raise ValueError(
                    f"event {i}: wave {ev['wave']} unique_total "
                    f"{ev['unique_total']} != previous {prev} + "
                    f"new_states {ev['new_states']}"
                )
            last_unique[run] = ev["unique_total"]
            last_wave[run] = ev["wave"]
        elif kind == "shard_wave":
            run = ev["run"]
            if run not in open_runs:
                raise ValueError(
                    f"event {i}: shard_wave outside an open run"
                )
            key = (run, ev["shard"])
            if (key in last_shard_wave
                    and ev["wave"] <= last_shard_wave[key]):
                last_visited.pop(key, None)  # retry restart
            prev = last_visited.get(key)
            if prev is not None and ev["visited_total"] != (
                prev + ev["new_states"]
            ):
                raise ValueError(
                    f"event {i}: shard {ev['shard']} wave "
                    f"{ev['wave']} visited_total "
                    f"{ev['visited_total']} != previous {prev} + "
                    f"new_states {ev['new_states']}"
                )
            last_visited[key] = ev["visited_total"]
            last_shard_wave[key] = ev["wave"]
        elif kind == "memory_plan":
            # the ledger's own sum must hold: a plan whose total
            # disagrees with its rows is a hand-edited artifact
            tot = sum(int(e["bytes"]) for e in ev["resident"])
            if int(ev["resident_bytes"]) != tot:
                raise ValueError(
                    f"event {i}: memory_plan resident_bytes "
                    f"{ev['resident_bytes']} != sum of resident "
                    f"entry bytes {tot}"
                )
        elif kind == "program_build":
            if ev["tier"] not in BUILD_TIERS:
                raise ValueError(
                    f"event {i}: program_build tier {ev['tier']!r} "
                    f"not in {BUILD_TIERS}"
                )
        elif kind == "verdict":
            if ev["kind"] not in VERDICT_KINDS:
                raise ValueError(
                    f"event {i}: verdict kind {ev['kind']!r} "
                    f"not in {VERDICT_KINDS}"
                )


def _runs(events: list[dict]) -> list[int]:
    return sorted({ev["run"] for ev in events if ev["ev"] == "run_begin"})


def _run_view(events: list[dict], run: int) -> dict:
    view: dict = dict(run=run, begin=None, end=None, waves=[],
                      chunks=[], spans=[], phase_totals={},
                      shard_waves={}, memory_plan=None,
                      memory_watermark=None, latency_profile=None,
                      builds=[], verdicts=[], restores=[],
                      tier_spills=[], degrades=[], watchdogs=[],
                      health=[])
    seen_shard_pairs: set = set()
    for ev in events:
        if ev.get("run") != run:
            continue
        kind = ev["ev"]
        if kind == "run_begin":
            view["begin"] = ev
        elif kind == "run_end":
            view["end"] = ev
        elif kind in ("memory_plan", "memory_watermark",
                      "latency_profile"):
            view[kind] = ev  # one per run; last occurrence wins
        elif kind == "program_build":
            view["builds"].append(ev)
        elif kind == "verdict":
            view["verdicts"].append(ev)
        elif kind == "restore":
            view["restores"].append(ev)
        elif kind == "tier_spill":
            view["tier_spills"].append(ev)
        elif kind == "fault_degrade":
            view["degrades"].append(ev)
        elif kind == "watchdog_timeout":
            view["watchdogs"].append(ev)
        elif kind == "shard_health":
            view["health"].append(ev)
        elif kind == "wave":
            view["waves"].append(ev)
        elif kind == "shard_wave":
            # keyed (wave, shard), last occurrence wins — the same
            # last-attempt alignment the global wave dict gets from
            # its keyed overwrite. A supervised RETRY re-explores
            # waves it already logged: when a (wave, shard) pair
            # repeats, every stored wave >= it belongs to the dead
            # attempt and is purged, so a DEGRADED retry (fewer
            # shards) can't leave the old attempt's extra shard rows
            # mixed into the re-explored waves.
            key = (ev["wave"], ev["shard"])
            if key in seen_shard_pairs:
                for w in [w for w in view["shard_waves"]
                          if w >= ev["wave"]]:
                    del view["shard_waves"][w]
                seen_shard_pairs = {
                    p for p in seen_shard_pairs if p[0] < ev["wave"]
                }
            seen_shard_pairs.add(key)
            view["shard_waves"].setdefault(
                ev["wave"], {}
            )[ev["shard"]] = ev
        elif kind == "chunk":
            view["chunks"].append(ev)
        elif kind == "span":
            view["spans"].append(ev)
        elif kind == "phase_total":
            view["phase_totals"][ev["phase"]] = ev
    view["waves"].sort(key=lambda w: w["wave"])
    return view


def _phase_durations(view: dict) -> dict[str, float]:
    """Per-phase wall totals for one run: named spans, accumulated
    phase totals, the chunk-level dispatch/fetch split, and the wave
    wall sum."""
    out: dict[str, float] = {}
    for s in view["spans"]:
        out[s["phase"]] = out.get(s["phase"], 0.0) + s["dur"]
    for phase, ev in view["phase_totals"].items():
        out[phase] = out.get(phase, 0.0) + ev["dur"]
    disp = sum(c["dispatch_sec"] for c in view["chunks"])
    fetch = sum(c["fetch_sec"] for c in view["chunks"])
    dev = sum(c["device_sec"] or 0.0 for c in view["chunks"])
    if view["chunks"]:
        out["device_dispatch"] = disp
        out["host_fetch"] = fetch
        if dev:
            out["device_wait"] = dev
    if view["waves"]:
        out["waves_wall"] = sum(
            w["t1"] - w["t0"] for w in view["waves"]
        )
    end = view["end"]
    if end is not None and end.get("duration_sec") is not None:
        out["run_total"] = end["duration_sec"]
    return out


# -- mesh observability: derived balance / routing metrics ----------------


def _skew(xs: list) -> Optional[float]:
    """max/mean over shards (1.0 = perfectly balanced, n_shards =
    one shard carries everything); None for an all-zero wave."""
    tot = sum(xs)
    if tot == 0:
        return None
    return round(max(xs) * len(xs) / tot, 4)


#: a wave whose per-shard work median is below this many rows yields
#: no straggler verdicts: a 1-row seed wave on an 8-shard mesh puts
#: every loaded shard "factor x median" over an empty one, which is
#: startup shape, not shard health.
STRAGGLER_MIN_MEDIAN_ROWS = 16


def detect_stragglers(wave_rows, factor: float,
                      min_median_rows: int = STRAGGLER_MIN_MEDIAN_ROWS,
                      ) -> list[dict]:
    """The health layer's per-wave straggler verdict over ONE wave's
    per-shard log rows (``[n_shards, SHARD_LOG_LANES]`` — the
    existing mesh wave log, telemetry round 11): a shard whose work
    (its ``candidates`` lane, the wave's per-shard cost driver)
    exceeds ``factor`` x the shard MEDIAN is a straggler. On an SPMD
    mesh every shard leaves a wave together, so a persistent work
    imbalance is the host-visible shadow of a slow or failing chip —
    the engines emit one ``shard_health`` event per verdict and feed
    SUSTAINED stragglers to checkpoint.classify_failure as pre-fault
    evidence.

    Pure host math over the log rows (unit-tested in ``pytest -m
    fault``). Returns ``[{shard, value, median, ratio}, ...]``; empty
    when the mesh is a single shard (no median signal), the wave's
    median work is under ``min_median_rows`` (seed/drain waves), or
    nothing exceeds the factor."""
    import numpy as _np

    if factor is None or factor <= 1.0:
        raise ValueError(
            f"straggler factor must be > 1 (got {factor}): at 1.0 "
            "every shard above the median would flag"
        )
    rows = _np.asarray(wave_rows)
    if rows.ndim != 2 or rows.shape[0] < 2:
        return []
    work = rows[:, SHARD_LOG_FIELDS.index("candidates")].astype(
        _np.int64
    )
    median = float(_np.median(work))
    if median < min_median_rows:
        return []
    out = []
    for s in range(work.shape[0]):
        v = int(work[s])
        if v > factor * median:
            out.append(dict(
                shard=s, value=v, median=median,
                ratio=(v / median if median else float("inf")),
            ))
    return out


def shard_balance(events: list[dict], run: int | None = None,
                  ) -> Optional[dict]:
    """Derive the mesh balance/routing summary from one run's
    ``shard_wave`` events — the numbers that decide whether the
    (owner, fp)-sort shuffle scales (ROADMAP direction 1): per-wave
    frontier/candidate skew (max/mean), routed shuffle volume,
    dest-tile fill vs the lossless ``Bd`` cap, and the per-shard
    visited occupancy trajectory. Returns None when the run carries
    no shard events (an unsharded or untraced run).

    ``run`` defaults to the LAST run in the event stream (bench/dryrun
    trace warm-run-last). Worst-skew bookkeeping ignores waves whose
    total is below the shard count — a 1-row seed wave on an 8-shard
    mesh is "maximally imbalanced" by arithmetic, not by scheduling.

    Headroom warnings come from the shared formatter
    (stateright_tpu/occupancy.py): per-shard visited occupancy and
    dest-tile fill past ``HEADROOM_THRESHOLD``, plus a skew warning
    past 2x. The ``per_wave`` list carries the full trajectory for
    tools/shard_report.py."""
    from .occupancy import (
        HEADROOM_THRESHOLD,
        PROBE_PRESSURE_THRESHOLD,
        occupancy_warning,
    )

    runs = _runs(events)
    if not runs:
        return None
    view = _run_view(events, runs[-1] if run is None else run)
    sw = view["shard_waves"]
    if not sw:
        return None
    lane = (view["begin"] or {}).get("lane") or {}
    tile_lanes = lane.get("dest_tile_lanes")
    per_shard_capacity = lane.get("capacity")
    # per-entry byte costs from the lane config (the memory ledger's
    # numbers, round 12): headroom warnings price the fill in bytes
    visited_row_bytes = lane.get("visited_row_bytes")
    tile_row_bytes = int(tile_lanes) * 4 if tile_lanes else None
    # Visited-set semantics come from the lane config: the sort-merge
    # engines' sorted arrays work to exactly 100% (headroom watch),
    # the hash engine's open addressing degrades from ~70% (probe
    # pressure — its own threshold and failure mode).
    visited_exact = bool(lane.get("visited_exact", True))

    per_wave: list[dict] = []
    routed_total = recv_total = 0
    bound_rows_total = 0  # sum of S x dest_cap over waves (static cap)
    worst_frontier = worst_cand = None  # (skew, wave)
    worst_fill = None  # (util, fill, cap, wave)
    skew_wsum = skew_weight = 0.0  # size-weighted frontier skew
    final_visited: dict[int, int] = {}
    n_shards = 0
    for w in sorted(sw):
        rows = [sw[w][s] for s in sorted(sw[w])]
        n_shards = max(n_shards, len(rows))
        fr = [r["frontier_rows"] for r in rows]
        cand = [r["candidates"] for r in rows]
        new = [r["new_states"] for r in rows]
        routed = sum(r["routed_rows"] for r in rows)
        recv = sum(r["recv_rows"] for r in rows)
        fill = max(r["dest_fill_peak"] for r in rows)
        cap = max(r["dest_cap"] for r in rows)
        util = round(fill / cap, 4) if cap else None
        m = dict(
            wave=w,
            shards=len(rows),
            frontier_total=sum(fr),
            frontier_skew=_skew(fr),
            candidates_total=sum(cand),
            candidate_skew=_skew(cand),
            new_total=sum(new),
            routed_rows=routed,
            recv_rows=recv,
            dest_fill_peak=fill,
            dest_cap=cap,
            dest_util=util,
        )
        per_wave.append(m)
        routed_total += routed
        recv_total += recv
        bound_rows_total += len(rows) * cap
        if sum(fr) >= len(rows) and m["frontier_skew"] is not None:
            if worst_frontier is None or m["frontier_skew"] > \
                    worst_frontier[0]:
                worst_frontier = (m["frontier_skew"], w)
            skew_wsum += m["frontier_skew"] * sum(fr)
            skew_weight += sum(fr)
        if sum(cand) >= len(rows) and m["candidate_skew"] is not None:
            if worst_cand is None or m["candidate_skew"] > \
                    worst_cand[0]:
                worst_cand = (m["candidate_skew"], w)
        if util is not None and (worst_fill is None
                                 or util > worst_fill[0]):
            worst_fill = (util, fill, cap, w)
        for r in rows:
            final_visited[r["shard"]] = r["visited_total"]

    visited = [final_visited[s] for s in sorted(final_visited)]
    weighted = (
        round(skew_wsum / skew_weight, 4) if skew_weight else None
    )
    warnings: list[str] = []
    # the imbalance warning keys on the SIZE-WEIGHTED skew: the first
    # BFS waves of any run are a handful of rows and always look
    # maximally skewed, but they carry ~no work — a warning should
    # mean the big waves (where the wall lives) are imbalanced.
    if weighted is not None and weighted > 2.0:
        warnings.append(
            f"frontier imbalance: size-weighted skew {weighted:.2f}x "
            f"(worst wave {worst_frontier[1]}: "
            f"{worst_frontier[0]:.2f}x its fair share on one shard) — "
            "the (owner, fp) partition is not spreading this "
            "workload; sharding buys less than 1/S"
        )
    if worst_fill is not None:
        msg = occupancy_warning(
            worst_fill[0],
            kind=f"dest tile (wave {worst_fill[3]})",
            threshold=HEADROOM_THRESHOLD,
            used=worst_fill[1],
            capacity=worst_fill[2],
            bytes_per_row=tile_row_bytes,
            consequence=(
                "a destination run past the lossless Bd cap trips "
                "c_overflow — raise bucket_capacity before the next "
                "skewed wave does"
            ),
        )
        if msg:
            warnings.append(msg)
    occ_max = None
    if per_shard_capacity and visited:
        occ_max = round(max(visited) / per_shard_capacity, 4)
        if visited_exact:
            occ_threshold = HEADROOM_THRESHOLD
            occ_consequence = (
                "the sorted visited array overflows exactly at "
                "100% — raise the per-shard capacity"
            )
        else:
            occ_threshold = PROBE_PRESSURE_THRESHOLD
            occ_consequence = (
                "open addressing degrades before it fills — probe "
                "failures become likely past ~85%; raise the "
                "per-shard capacity"
            )
        for s in sorted(final_visited):
            msg = occupancy_warning(
                final_visited[s] / per_shard_capacity,
                kind=f"shard {s} visited array",
                threshold=occ_threshold,
                used=final_visited[s],
                capacity=per_shard_capacity,
                bytes_per_row=visited_row_bytes,
                consequence=occ_consequence,
            )
            if msg:
                warnings.append(msg)

    return dict(
        run=view["run"],
        n_shards=n_shards,
        waves=len(per_wave),
        frontier_skew_worst=(
            dict(skew=worst_frontier[0], wave=worst_frontier[1])
            if worst_frontier else None
        ),
        frontier_skew_weighted=weighted,
        candidate_skew_worst=(
            dict(skew=worst_cand[0], wave=worst_cand[1])
            if worst_cand else None
        ),
        routed_rows_total=routed_total,
        recv_rows_total=recv_total,
        routed_bytes_total=(
            routed_total * int(tile_lanes) * 4
            if tile_lanes else None
        ),
        # Static-vs-runtime comms reconciliation (round 13, PERF.md
        # §comms-lint): the static side of the routed-byte accounting.
        # row_bytes is the per-row price comms-lint derives from the
        # compiled all_to_all operand (dest_tile_lanes x 4 — the COMM
        # artifact's all_to_all_row_bytes; tests pin the two equal),
        # so measured routed bytes ARE routed_rows x row_bytes, and
        # bytes_bound_total is the static per-wave ceiling (S x
        # dest_cap rows every wave — what the all_to_all physically
        # exchanges regardless of fill). bound_util says how much of
        # the static exchange carried real rows: the estimate vs
        # measured bound the reconciliation states.
        comms_static=(
            dict(
                row_bytes=tile_row_bytes,
                bound_rows_total=bound_rows_total,
                bytes_bound_total=bound_rows_total * tile_row_bytes,
                measured_routed_bytes=(
                    routed_total * tile_row_bytes
                ),
                bound_util=(
                    round(routed_total / bound_rows_total, 4)
                    if bound_rows_total else None
                ),
            )
            if tile_row_bytes else None
        ),
        dest_fill_worst=(
            dict(util=worst_fill[0], fill=worst_fill[1],
                 cap=worst_fill[2], wave=worst_fill[3])
            if worst_fill else None
        ),
        visited_per_shard=visited,
        visited_skew=_skew(visited) if visited else None,
        shard_capacity=per_shard_capacity,
        occupancy_max=occ_max,
        warnings=warnings,
        per_wave=per_wave,
    )


# -- memory observability: the derived plan/watermark summary -------------


def _strip_ev(ev: Optional[dict]) -> Optional[dict]:
    if ev is None:
        return None
    return {k: v for k, v in ev.items()
            if k not in ("ev", "run", "t")}


def memory_summary(events: list[dict], run: int | None = None,
                   ) -> Optional[dict]:
    """Derive one run's memory view from its ``memory_plan`` /
    ``memory_watermark`` events and the per-chunk ``mem_bytes`` lane —
    the data behind tools/mem_report.py and the ``MEM_r*.json``
    artifacts (memplan.write_memory_artifact). Returns None when the
    run carries no memory events (a pre-round-12 trace, or an engine
    without the ledger) — mem_report exits 2 on that.

    ``run`` defaults to the LAST run in the event stream (bench/CLI
    trace warm-run-last, so the default view is the warm one)."""
    runs = _runs(events)
    if not runs:
        return None
    view = _run_view(events, runs[-1] if run is None else run)
    plan = view["memory_plan"]
    wm = view["memory_watermark"]
    chunk_mem = [
        dict(chunk=c["chunk"], bytes=c["mem_bytes"])
        for c in view["chunks"] if c.get("mem_bytes") is not None
    ]
    if plan is None and wm is None and not chunk_mem:
        return None
    lane = (view["begin"] or {}).get("lane") or {}
    modes = [
        _strip_ev(ev) for ev in events
        if ev.get("ev") == "engine_mode" and ev.get("run") == view["run"]
    ]
    return dict(
        run=view["run"],
        engine=(plan or {}).get("engine") or lane.get("engine"),
        lane={k: lane[k] for k in
              ("engine", "model", "encoding", "capacity",
               "frontier_capacity", "cand_capacity", "n_shards",
               "track_paths", "merge_impl", "tier_hot_rows")
              if k in lane},
        plan=_strip_ev(plan),
        watermark=_strip_ev(wm),
        chunk_mem=chunk_mem,
        engine_modes=modes,
        tier_spills=[_strip_ev(ev) for ev in view["tier_spills"]],
    )


# -- latency observability: the derived ledger/floor/verdict summary -----


def latency_summary(events: list[dict], run: int | None = None,
                    ) -> Optional[dict]:
    """Derive one run's latency view from its ``latency_profile`` /
    ``program_build`` / ``verdict`` events and the host-phase spans —
    the data behind tools/latency_report.py and the ``LAT_r*.json``
    artifacts. Returns None when the run carries no latency events (a
    pre-round-14 trace) — latency_report exits 2 on that.

    ``run`` defaults to the LAST run in the event stream (bench/CLI
    trace warm-run-last, so the default view is the warm one).
    Verdict walls are re-based to the run's own start (``t_since_run``)
    so time-to-verdict reads per run, not per process."""
    runs = _runs(events)
    if not runs:
        return None
    view = _run_view(events, runs[-1] if run is None else run)
    prof = view["latency_profile"]
    builds = view["builds"]
    verdicts = view["verdicts"]
    if prof is None and not builds and not verdicts:
        return None
    lane = (view["begin"] or {}).get("lane") or {}
    t0 = (view["begin"] or {}).get("t", 0.0)
    vrows = [
        dict(
            {k: v for k, v in ev.items()
             if k not in ("ev", "run", "t")},
            t_since_run=round(ev["t"] - t0, 6),
        )
        for ev in verdicts
    ]
    phases = {
        k: round(v, 6) for k, v in _phase_durations(view).items()
    }
    return dict(
        run=view["run"],
        engine=lane.get("engine"),
        lane={k: lane[k] for k in
              ("engine", "model", "encoding", "capacity",
               "frontier_capacity", "cand_capacity", "n_shards",
               "waves_per_sync", "track_paths", "merge_impl")
              if k in lane},
        profile=_strip_ev(prof),
        builds=[_strip_ev(b) for b in builds],
        verdicts=vrows,
        phases=phases,
        # the degrade-and-continue layer's wall-clock events ride the
        # latency view: watchdog breaches carry the full attribution,
        # degrades mark where the run changed shape mid-stream
        watchdogs=[_strip_ev(w) for w in view["watchdogs"]],
        degrades=[_strip_ev(d) for d in view["degrades"]],
        error=(view["end"] or {}).get("error"),
    )


def write_latency_artifact(summary: dict, root: str | None = None,
                           ) -> str:
    """Write one auto-numbered ``LAT_r*.json`` artifact (the latency
    summary of one traced run, tools/latency_report.py's ``--json``
    output). LAT numbers in its OWN round sequence (``LAT_r01`` first)
    like MEM/COMM: a LAT artifact is *derived from* a TRACE and names
    it in its ``trace`` field, so the cross-reference — not a shared
    counter — pairs it with a perf round."""
    from .artifacts import artifact_path, next_round, provenance, \
        repo_root

    root = repo_root() if root is None else root
    path = artifact_path(
        "LAT", "json", root=root,
        round=next_round(root, stems=("LAT",)),
    )
    doc = dict(summary)
    doc.setdefault("provenance", provenance())
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return path


#: wave counters trace_diff requires to MATCH between the two sides —
#: two traces of the same workload must explore the same space.
DIFF_COUNTERS = ("frontier_rows", "candidates", "new_states",
                 "unique_total")

#: per-shard counters trace_diff compares — as a MULTISET of per-shard
#: rows per wave, not positionally: the (owner, fp) partition is
#: deterministic up to shard numbering, so a mesh relabeling (device
#: enumeration order, a different host) permutes the rows without
#: changing the set; positional comparison would false-positive.
#: ``dest_cap`` is excluded: it is CONFIG (the class's Bd tile size),
#: not exploration — a bucket_capacity-only A/B (the tuning diff this
#: tool exists for) must compare on timing, not fail as divergence.
SHARD_DIFF_COUNTERS = tuple(
    f for f in SHARD_LOG_FIELDS if f != "dest_cap"
)


def _resume_wave(view: dict) -> Optional[int]:
    """The wave a resumed run restarted from (its ``restore`` event),
    or None for an uninterrupted run. Waves BELOW this are expected
    absent from the resumed side — they ran in the killed process,
    whose trace died with it — so the diff alignment compares the
    overlap only; every counter in the overlap (including the running
    ``unique_total``, which carries the pre-kill history) must still
    match the baseline exactly."""
    rs = view.get("restores") or []
    if not rs:
        return None
    return min(int(r.get("wave") or 0) for r in rs)


def _missing_ok(i: int, in_a: bool, in_b: bool,
                rw_a: Optional[int], rw_b: Optional[int]) -> bool:
    """Whether wave ``i`` being on one side only is explained by the
    other side's resume point (pre-resume waves are expected absent)."""
    if not in_a and rw_a is not None and i < rw_a:
        return True
    if not in_b and rw_b is not None and i < rw_b:
        return True
    return False


def _reshard_points(view: dict) -> list[tuple]:
    """``[(wave, to_shards), ...]`` where this run legitimately
    changed shard count mid-stream: supervised elastic degrades
    (``fault_degrade`` events) and elastic re-shard resumes (a
    ``restore`` whose from/to shard counts differ)."""
    pts = []
    for ev in view.get("degrades") or []:
        pts.append((int(ev.get("wave") or 0), int(ev["to_shards"])))
    for ev in view.get("restores") or []:
        if ev.get("from_shards") != ev.get("to_shards"):
            pts.append((int(ev.get("wave") or 0),
                        int(ev["to_shards"])))
    return sorted(pts)


def _shard_divergences(va: dict, vb: dict) -> list[dict]:
    """Shard-aware wave alignment (the mesh observability layer): for
    every wave BOTH sides have per-shard rows for, the multisets of
    per-shard counter tuples must match — shard RENUMBERING is fine
    (the multiset is invariant), a different partition of the same
    global counts is not. A wave with shard rows on exactly one side
    also diverges (one run was sharded-traced, the other not — they
    are not comparable as a mesh A/B).

    DEGRADE-aware (the degrade-and-continue layer): a run that
    elastically degraded (``fault_degrade``) or resumed onto a
    different shard count (``restore``) legitimately changes its
    per-wave shard count at the re-shard wave. Shard lanes compare
    within each shard-COUNT segment — waves where the two sides'
    counts differ because one side re-sharded are skipped on the
    shard lanes (the GLOBAL counters stay fully enforced, which is
    exactly the degraded-run bit-exactness proof)."""
    from collections import Counter

    def expected_at(view, pts, wave, default):
        cur = default
        for w, s in pts:
            if wave >= w:
                cur = s
        return cur

    out: list[dict] = []
    sa, sb = va["shard_waves"], vb["shard_waves"]
    if not sa and not sb:
        return out
    rw_a, rw_b = _resume_wave(va), _resume_wave(vb)
    pts_a, pts_b = _reshard_points(va), _reshard_points(vb)
    resharded = bool(pts_a or pts_b)
    # each side's baseline shard count, from its own run_begin lane
    # (falls back to the observed row count on traces without one)
    base_a = ((va["begin"] or {}).get("lane") or {}).get("n_shards")
    base_b = ((vb["begin"] or {}).get("lane") or {}).get("n_shards")
    for i in sorted(set(sa) | set(sb)):
        if (i in sa) != (i in sb):
            if _missing_ok(i, i in sa, i in sb, rw_a, rw_b):
                continue  # pre-resume wave: expected absent
            out.append(
                dict(wave=i, field="shard_present",
                     a=i in sa, b=i in sb)
            )
            continue

        def rows(view_waves):
            return Counter(
                tuple(ev[f] for f in SHARD_DIFF_COUNTERS)
                for ev in view_waves[i].values()
            )

        if len(sa[i]) != len(sb[i]) and resharded:
            # different shard-COUNT segments are incomparable on the
            # shard lanes by design — but ONLY when each side's count
            # is exactly what its own degrade/re-shard history
            # predicts for this wave; a row count the history does
            # NOT explain (a genuinely lost shard row) still diverges
            ea = expected_at(va, pts_a, i,
                             base_a if base_a else len(sa[i]))
            eb = expected_at(vb, pts_b, i,
                             base_b if base_b else len(sb[i]))
            if ea != eb and len(sa[i]) == ea and len(sb[i]) == eb:
                continue  # global counters carry the proof here
        ca, cb = rows(sa), rows(sb)
        if len(sa[i]) != len(sb[i]):
            out.append(
                dict(wave=i, field="shard_count",
                     a=len(sa[i]), b=len(sb[i]))
            )
        if ca != cb:
            only_a = next(iter((ca - cb).elements()), None)
            only_b = next(iter((cb - ca).elements()), None)
            out.append(
                dict(
                    wave=i, field="shard_multiset",
                    a="/".join(map(str, only_a))
                    if only_a else None,
                    b="/".join(map(str, only_b))
                    if only_b else None,
                )
            )
    return out


#: measured-byte lanes smaller than this on the A side are ignored by
#: the memory regression check (the byte analog of ``min_sec``: a
#: few-KB toy trace's live-array noise is not a regression signal).
MEM_DIFF_MIN_BYTES = 1 << 20


def _memory_diff(va: dict, vb: dict, threshold: float) -> dict:
    """Memory-counter alignment between two runs (the round-12 layer):
    the PLAN is config — resident shapes/dtypes/bytes and the
    per-class staging ledger must match EXACTLY (a changed resident
    layout is a different engine, not a perf delta) — while MEASURED
    bytes (compiled temp bytes, the live watermark peak) are compared
    RELATIVE under ``threshold``, so jax-version allocator skew
    doesn't false-positive a counter gate. Byte lanes compare only
    when both sides measured them the same way (equal ``source`` /
    both reported) — and a side with NO memory events at all (a
    pre-round-12 baseline trace) is simply not comparable on this
    axis: the diff skips it rather than failing the gate, so chip
    A/Bs against committed pre-round-12 baselines keep working."""
    divs: list[dict] = []
    lanes: dict = {}
    regressions: list[str] = []
    pa, pb = va["memory_plan"], vb["memory_plan"]
    if pa is not None and pb is not None:
        ra = {e["name"]: (tuple(e["shape"]), e["dtype"], e["bytes"])
              for e in pa["resident"]}
        rb = {e["name"]: (tuple(e["shape"]), e["dtype"], e["bytes"])
              for e in pb["resident"]}
        for name in sorted(set(ra) | set(rb)):
            if ra.get(name) != rb.get(name):
                divs.append(dict(
                    field="memory_plan", name=name,
                    a=("/".join(map(str, ra[name]))
                       if name in ra else None),
                    b=("/".join(map(str, rb[name]))
                       if name in rb else None),
                ))
        if len(pa["classes"]) != len(pb["classes"]):
            divs.append(dict(field="memory_plan_classes",
                             name="ladder depth",
                             a=len(pa["classes"]),
                             b=len(pb["classes"])))
        else:
            # name the class AND the field that moved — bare
            # 'A=5 B=5' class counts would be unactionable
            for i, (ca_c, cb_c) in enumerate(zip(pa["classes"],
                                                 pb["classes"])):
                if ca_c == cb_c:
                    continue
                keys = sorted(
                    k for k in set(ca_c) | set(cb_c)
                    if k != "staging" and ca_c.get(k) != cb_c.get(k)
                ) or ["staging"]
                for k in keys:
                    divs.append(dict(
                        field="memory_plan_classes",
                        name=f"class {i}.{k}",
                        a=(len(ca_c.get("staging", []))
                           if k == "staging" else ca_c.get(k)),
                        b=(len(cb_c.get("staging", []))
                           if k == "staging" else cb_c.get(k)),
                    ))

    def byte_lane(name, a, b):
        if a is None or b is None:
            return
        rel = (b - a) / a if a > 0 else (
            float("inf") if b > 0 else 0.0
        )
        lanes[name] = dict(
            a=int(a), b=int(b), delta=int(b - a),
            rel=round(rel, 4) if rel != float("inf") else None,
        )
        if a >= MEM_DIFF_MIN_BYTES and rel > threshold:
            regressions.append(name)

    if pa is not None and pb is not None:
        ca, cb = pa.get("compiled"), pb.get("compiled")
        if ca is not None and cb is not None:
            byte_lane("compiled_temp_bytes",
                      ca.get("temp_size_in_bytes"),
                      cb.get("temp_size_in_bytes"))
    wa, wb = va["memory_watermark"], vb["memory_watermark"]
    if (wa is not None and wb is not None
            and wa.get("source") == wb.get("source")):
        byte_lane("device_peak_bytes",
                  wa.get("device_peak_bytes"),
                  wb.get("device_peak_bytes"))
    return dict(divergences=divs, bytes=lanes,
                regressions=regressions)


#: latency_profile lanes _latency_diff compares (flat float fields;
#: the compile block gets its own lanes below). ``dispatch_net_sec``
#: — not raw dispatch — is the regression lane: a forced cold compile
#: physically sits inside chunk 0's dispatch, and the ledger
#: subtraction is what lets the diff attribute it to compile instead.
LATENCY_DIFF_LANES = (
    "time_to_first_wave_sec",
    "dispatch_net_sec",
    "fetch_sec",
    "chunk_wall_sec",
    "interchunk_sec",
    "run_wall_sec",
)


def _latency_diff(va: dict, vb: dict, threshold: float,
                  min_sec: float) -> dict:
    """Latency alignment between two runs (the round-14 layer): the
    ``latency_profile`` wall lanes and the compile attribution compare
    RELATIVE under ``threshold``, and per-property time-to-verdict
    lanes ride along — with the verdict KIND (discovery vs exhaustion)
    treated as a counter: two runs of one workload must settle every
    property the same way, so a kind flip is a divergence, not a
    timing delta.

    A side with NO latency events at all (a pre-round-14 baseline
    trace) is simply not comparable on this axis: the diff skips it
    rather than failing the gate, so A/Bs against committed old
    baselines keep working — the memory diff's compatibility contract.

    The regression rule differs from the phase table's on purpose:
    a lane regresses when ``b - a > max(min_sec, threshold * a)`` —
    the relative bar everywhere, but an ABSOLUTE ``min_sec`` growth is
    enough on a near-zero baseline (a 0.3 s injected sync stall on a
    10 ms warm fetch floor, a multi-second cold compile against a
    0-second warm ledger: both must flag, and pure a>=min_sec gating
    would skip exactly those)."""
    pa, pb = va["latency_profile"], vb["latency_profile"]
    lanes: dict = {}
    regressions: list[str] = []
    divergences: list[dict] = []

    def lane(name, a, b):
        if a is None or b is None:
            return
        rel = (b - a) / a if a > 0 else (
            float("inf") if b > 0 else 0.0
        )
        lanes[name] = dict(
            a=round(a, 6), b=round(b, 6), delta=round(b - a, 6),
            rel=round(rel, 4) if rel != float("inf") else None,
        )
        if b - a > max(min_sec, threshold * a):
            regressions.append(name)

    if pa is not None and pb is not None:
        for name in LATENCY_DIFF_LANES:
            lane(name, pa.get(name), pb.get(name))
        ca, cb = pa.get("compile") or {}, pb.get("compile") or {}
        lane("compile_cold_sec", ca.get("cold_sec"),
             cb.get("cold_sec"))
        lane("compile_total_sec",
             (ca.get("span_sec", 0.0) + ca.get("build_wall_sec", 0.0)
              if ca else None),
             (cb.get("span_sec", 0.0) + cb.get("build_wall_sec", 0.0)
              if cb else None))

    # per-property time-to-verdict: last settle per property wins
    # (auto-budget retries re-settle inside one run; the final
    # attempt's verdict is the run's answer)
    def vmap_of(view):
        t0 = (view["begin"] or {}).get("t", 0.0)
        out = {}
        for ev in view["verdicts"]:
            out[ev["property"]] = (ev["kind"],
                                   round(ev["t"] - t0, 6))
        return out

    va_v, vb_v = vmap_of(va), vmap_of(vb)
    if va_v and vb_v:
        for prop in sorted(set(va_v) | set(vb_v)):
            if (prop in va_v) != (prop in vb_v):
                divergences.append(dict(
                    field="verdict_present", property=prop,
                    a=prop in va_v, b=prop in vb_v,
                ))
                continue
            (ka, ta), (kb, tb) = va_v[prop], vb_v[prop]
            if ka != kb:
                divergences.append(dict(
                    field="verdict_kind", property=prop, a=ka, b=kb,
                ))
                continue
            lane(f"verdict:{prop}", ta, tb)

    return dict(divergences=divergences, lanes=lanes,
                regressions=regressions)


def _tier_diff(va: dict, vb: dict, threshold: float,
               min_sec: float) -> dict:
    """Tier-spill alignment between two runs (the tiered-visited-set
    layer, stateright_tpu/tier.py): spill COUNTS and cold-tier
    rows/bytes are exploration facts — two tiered runs of one
    workload at the same hot ceiling spill identically, so any
    mismatch is a divergence — while the spill/ingest WALLS compare
    relative under the ``b - a > max(min_sec, threshold * a)`` bar
    the latency lanes use.

    A side with NO tier events simply skips the block (a forced-spill
    run diffed against the all-resident baseline — the exact A/B this
    layer's acceptance artifact records — must compare on the WAVE
    counters, which stay fully enforced, not fail here; pre-tier
    baseline traces keep diffing the same way)."""
    sa, sb = va["tier_spills"], vb["tier_spills"]
    divergences: list[dict] = []
    lanes: dict = {}
    regressions: list[str] = []
    if not sa or not sb:
        return dict(divergences=divergences, lanes=lanes,
                    regressions=regressions,
                    skipped=(not sa) != (not sb))

    def counter(name, a, b):
        if a != b:
            divergences.append(dict(field=name, a=a, b=b))

    counter("tier_spill_count", len(sa), len(sb))
    counter("tier_rows_spilled",
            sum(int(ev["rows"]) for ev in sa),
            sum(int(ev["rows"]) for ev in sb))
    counter("tier_cold_rows_final",
            int(sa[-1]["cold_rows_total"]),
            int(sb[-1]["cold_rows_total"]))
    counter("tier_cold_bytes_final",
            int(sa[-1]["cold_bytes_total"]),
            int(sb[-1]["cold_bytes_total"]))

    def lane(name, a, b):
        if a is None or b is None:
            return
        rel = (b - a) / a if a > 0 else (
            float("inf") if b > 0 else 0.0
        )
        lanes[name] = dict(
            a=round(a, 6), b=round(b, 6), delta=round(b - a, 6),
            rel=round(rel, 4) if rel != float("inf") else None,
        )
        if b - a > max(min_sec, threshold * a):
            regressions.append(name)

    def wall(evs, field):
        vals = [ev.get(field) for ev in evs]
        if any(v is None for v in vals):
            return None
        return float(sum(vals))

    lane("tier_spill_wall_sec", wall(sa, "wall_sec"),
         wall(sb, "wall_sec"))
    lane("tier_ingest_wall_sec", wall(sa, "ingest_sec"),
         wall(sb, "ingest_sec"))
    return dict(divergences=divergences, lanes=lanes,
                regressions=regressions, skipped=False)


def diff_traces(
    a_events: list[dict],
    b_events: list[dict],
    *,
    run_a: int | None = None,
    run_b: int | None = None,
    threshold: float = 0.10,
    min_sec: float = 0.05,
) -> dict:
    """Align two traces wave-by-wave and price the per-phase deltas.

    Returns a report dict:
      ``divergences`` — per-wave counter mismatches (a traced A/B of
        one workload must have identical exploration; any mismatch
        fails the gate),
      ``phases`` — {phase: {a, b, delta, rel}},
      ``regressions`` — phases where B exceeds A by more than
        ``threshold`` (relative), ignoring phases under ``min_sec``
        on the A side (noise floor),
      ``memory`` — the memory-counter alignment (:func:`_memory_diff`:
        plan shapes exact, measured temp/live bytes under
        ``threshold``),
      ``latency`` — the latency alignment (:func:`_latency_diff`:
        latency_profile wall lanes + per-property time-to-verdict
        under ``threshold``; verdict-kind flips are divergences;
        sides without latency events skip),
      ``ok`` — True iff no divergence and no regression (timing,
        memory, OR latency).

    ``run_a``/``run_b`` default to the LAST run in each file (bench
    traces warm-run-last)."""
    va = _run_view(a_events, _runs(a_events)[-1] if run_a is None
                   else run_a)
    vb = _run_view(b_events, _runs(b_events)[-1] if run_b is None
                   else run_b)

    divergences = []
    # Certificate-status flip (analysis/soundness.py): the run_begin
    # lane config carries soundness_certified on reduction runs. A
    # certified↔refused flip between two traces of one workload means
    # the reductions being compared do NOT carry the same soundness
    # guarantee — that is a divergence, not a timing delta.
    cert_a = ((va["begin"] or {}).get("lane")
              or {}).get("soundness_certified")
    cert_b = ((vb["begin"] or {}).get("lane")
              or {}).get("soundness_certified")
    if cert_a is not None and cert_b is not None and cert_a != cert_b:
        divergences.append(
            dict(wave=None, field="soundness_certified",
                 a=cert_a, b=cert_b)
        )
    wa = {w["wave"]: w for w in va["waves"]}
    wb = {w["wave"]: w for w in vb["waves"]}
    # Resume-aware alignment (the durability layer): a RESUMED run's
    # wave stream legitimately begins at its restore wave — the
    # pre-kill waves died with the killed process's trace. Waves both
    # sides have must still match on EVERY counter, and the running
    # unique_total carries the pre-kill history, so "zero counter
    # divergence over the overlap" is exactly the kill/resume parity
    # proof (tools/crash_matrix.py's CKPT artifact verdict).
    rw_a, rw_b = _resume_wave(va), _resume_wave(vb)
    for i in sorted(set(wa) | set(wb)):
        if i not in wa or i not in wb:
            if _missing_ok(i, i in wa, i in wb, rw_a, rw_b):
                continue  # pre-resume wave: expected absent
            divergences.append(
                dict(wave=i, field="present",
                     a=i in wa, b=i in wb)
            )
            continue
        for field in DIFF_COUNTERS:
            if wa[i][field] != wb[i][field]:
                divergences.append(
                    dict(wave=i, field=field,
                         a=wa[i][field], b=wb[i][field])
                )
    divergences.extend(_shard_divergences(va, vb))

    pa = _phase_durations(va)
    pb = _phase_durations(vb)
    phases = {}
    regressions = []
    for phase in sorted(set(pa) | set(pb)):
        a = pa.get(phase, 0.0)
        b = pb.get(phase, 0.0)
        rel = (b - a) / a if a > 0 else (float("inf") if b > 0 else 0.0)
        phases[phase] = dict(a=round(a, 6), b=round(b, 6),
                             delta=round(b - a, 6),
                             rel=round(rel, 4) if rel != float("inf")
                             else None)
        if a >= min_sec and rel > threshold:
            regressions.append(phase)

    memory = _memory_diff(va, vb, threshold)
    latency = _latency_diff(va, vb, threshold, min_sec)
    tier = _tier_diff(va, vb, threshold, min_sec)
    deg_a = [dict(wave=int(d.get("wave") or 0),
                  from_shards=int(d["from_shards"]),
                  to_shards=int(d["to_shards"]),
                  reason=d.get("reason"))
             for d in va["degrades"]]
    deg_b = [dict(wave=int(d.get("wave") or 0),
                  from_shards=int(d["from_shards"]),
                  to_shards=int(d["to_shards"]),
                  reason=d.get("reason"))
             for d in vb["degrades"]]
    if (rw_a is None) != (rw_b is None) \
            or bool(deg_a) != bool(deg_b):
        # One side resumed (or DEGRADED) mid-run: its walls cover a
        # PARTIAL search (plus a fresh process's compile fetches), so
        # timing/byte lanes are not comparable to the uninterrupted
        # side — only the counters are, and those stay fully enforced
        # above. The lanes still print; the regression flags are
        # cleared.
        regressions = []
        memory["regressions"] = []
        latency["regressions"] = []
        tier["regressions"] = []
        if bool(deg_a) != bool(deg_b):
            # a degraded run legitimately re-declared its resident
            # layout at the surviving shard count — the plan-exact
            # gate compares configs that are SUPPOSED to differ;
            # the global wave counters stay the exactness proof
            memory["divergences"] = []
        # spill-event counts are also not comparable across a resume:
        # the pre-kill spills died with the killed process's trace
        # (the cold-total lanes would match, but the per-event counts
        # legitimately differ) — wave counters stay fully enforced
        tier["divergences"] = []
    return dict(
        run_a=va["run"], run_b=vb["run"],
        waves_a=len(va["waves"]), waves_b=len(vb["waves"]),
        resume_wave_a=rw_a, resume_wave_b=rw_b,
        degrades_a=deg_a, degrades_b=deg_b,
        divergences=divergences,
        phases=phases,
        regressions=regressions,
        memory=memory,
        latency=latency,
        tier=tier,
        threshold=threshold,
        min_sec=min_sec,
        ok=(not divergences and not regressions
            and not memory["divergences"]
            and not memory["regressions"]
            and not latency["divergences"]
            and not latency["regressions"]
            and not tier["divergences"]
            and not tier["regressions"]),
    )


def format_diff(report: dict) -> str:
    lines = [
        f"trace diff: run A#{report['run_a']} "
        f"({report['waves_a']} waves) vs run B#{report['run_b']} "
        f"({report['waves_b']} waves)",
    ]
    for side in ("a", "b"):
        rw = report.get(f"resume_wave_{side}")
        if rw is not None:
            lines.append(
                f"run {side.upper()} RESUMED at wave {rw}: "
                "pre-resume waves excluded from alignment; timing "
                "lanes informational (partial-run walls)"
            )
        for d in report.get(f"degrades_{side}") or ():
            lines.append(
                f"run {side.upper()} DEGRADED at wave {d['wave']}: "
                f"S={d['from_shards']} -> S={d['to_shards']} "
                f"({d.get('reason')}) — shard lanes compare within "
                "each shard-count segment; global counters fully "
                "enforced"
            )
    if report["divergences"]:
        lines.append(
            f"WAVE DIVERGENCE ({len(report['divergences'])} "
            "mismatches) — the two traces did not explore the same "
            "space:"
        )
        for d in report["divergences"][:10]:
            lines.append(
                f"  wave {d['wave']:5d} {d['field']:14s} "
                f"A={d['a']} B={d['b']}"
            )
        if len(report["divergences"]) > 10:
            lines.append(
                f"  ... {len(report['divergences']) - 10} more"
            )
    lines.append(
        f"{'phase':28s} {'A sec':>10s} {'B sec':>10s} "
        f"{'delta':>10s} {'rel':>8s}"
    )
    for phase, p in report["phases"].items():
        rel = "n/a" if p["rel"] is None else f"{p['rel']:+.1%}"
        flag = "  <-- REGRESSION" if phase in report["regressions"] \
            else ""
        lines.append(
            f"{phase:28s} {p['a']:10.4f} {p['b']:10.4f} "
            f"{p['delta']:+10.4f} {rel:>8s}{flag}"
        )
    mem = report.get("memory") or {}
    if mem.get("divergences"):
        lines.append(
            f"MEMORY-PLAN DIVERGENCE ({len(mem['divergences'])} "
            "mismatches) — the two runs declared different resident "
            "layouts:"
        )
        for d in mem["divergences"][:10]:
            lines.append(
                f"  {d['field']:20s} {d.get('name', ''):14s} "
                f"A={d['a']} B={d['b']}"
            )
    for name, p in (mem.get("bytes") or {}).items():
        rel = "n/a" if p["rel"] is None else f"{p['rel']:+.1%}"
        flag = ("  <-- REGRESSION"
                if name in mem.get("regressions", ()) else "")
        lines.append(
            f"{name:28s} {p['a']:10d} {p['b']:10d} "
            f"{p['delta']:+10d} {rel:>8s}{flag}"
        )
    tier = report.get("tier") or {}
    if tier.get("skipped"):
        lines.append(
            "tier: one side has no tier_spill events (an all-resident"
            " baseline) — cold-tier lanes skipped"
        )
    if tier.get("divergences"):
        lines.append(
            f"TIER DIVERGENCE ({len(tier['divergences'])} "
            "mismatches) — the two runs spilled differently:"
        )
        for d in tier["divergences"][:10]:
            lines.append(
                f"  {d['field']:22s} A={d['a']} B={d['b']}"
            )
    for name, p in (tier.get("lanes") or {}).items():
        rel = "n/a" if p["rel"] is None else f"{p['rel']:+.1%}"
        flag = ("  <-- REGRESSION"
                if name in tier.get("regressions", ()) else "")
        lines.append(
            f"{name:28s} {p['a']:10.4f} {p['b']:10.4f} "
            f"{p['delta']:+10.4f} {rel:>8s}{flag}"
        )
    lat = report.get("latency") or {}
    if lat.get("divergences"):
        lines.append(
            f"VERDICT DIVERGENCE ({len(lat['divergences'])} "
            "mismatches) — the two runs settled properties "
            "differently:"
        )
        for d in lat["divergences"][:10]:
            lines.append(
                f"  {d['field']:16s} {d.get('property', ''):24s} "
                f"A={d['a']} B={d['b']}"
            )
    for name, p in (lat.get("lanes") or {}).items():
        rel = "n/a" if p["rel"] is None else f"{p['rel']:+.1%}"
        flag = ("  <-- REGRESSION"
                if name in lat.get("regressions", ()) else "")
        lines.append(
            f"{name:28s} {p['a']:10.4f} {p['b']:10.4f} "
            f"{p['delta']:+10.4f} {rel:>8s}{flag}"
        )
    mem_regs = mem.get("regressions") or []
    lat_regs = lat.get("regressions") or []
    tier_regs = tier.get("regressions") or []
    verdict = "OK" if report["ok"] else (
        "FAIL: wave divergence" if report["divergences"]
        else "FAIL: memory-plan divergence" if mem.get("divergences")
        else "FAIL: verdict divergence" if lat.get("divergences")
        else "FAIL: tier divergence" if tier.get("divergences")
        else f"FAIL: {len(report['regressions']) + len(mem_regs) + len(lat_regs) + len(tier_regs)} "
             f"lane(s) past +{report['threshold']:.0%}"
    )
    lines.append(f"verdict: {verdict}")
    return "\n".join(lines)
