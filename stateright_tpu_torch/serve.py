"""The resident checking service: one process, many check sessions.

The port of the JAX package's ``serve`` module. A cold ``check-gpu``
process pays the card's start and the kernels' library loads before its
first wave; this module keeps one process resident on one device and
serves many concurrent sessions from it:

* **Sessions** (:meth:`CheckService.check`): each query — a CLI lane
  (``paxos check-gpu 2``: the same argv, the same report as a process
  of its own) or an Explorer browse — runs as one :class:`Session` with
  its OWN :class:`~stateright_tpu_torch.telemetry.RunTracer` installed
  for its thread (``activate_thread``), so concurrent sessions trace
  into disjoint event streams. The service meets the checker at the
  CLI's one ``_report`` seam (cli.py ``_SESSION_HOOK``).
* **The device** is the service's (``CheckService(device="cuda")``, the
  daemon's ``--device``): every session runs on it, and a session's argv
  takes no flag. A service on the card never runs a session on the CPU:
  a session that fails on the card ends ``failed`` with its error.
* **The FIFO gate** (:class:`FifoLock`): each chunk's issue and sync
  runs inside the service's gate (the engines' ``dispatch_gate``,
  applied in ``checkers/tpu.py`` ``_guarded_wave``), so concurrent
  sessions take the device a chunk at a time (up to ``waves_per_sync``
  waves, checkers/chunk.py) in arrival order, as JAX's do. Each session's queue
  wait is summed, and the kernel launches made while it held the gate
  are counted as its own (``Session.launches``).
* **Admission** (``memplan.session_resident_bytes``): a session's
  resident bytes are priced from its configuration and held against the
  device budget BEFORE its first kernel or wave: an oversized query is
  refused (:class:`AdmissionRefused`), not found out as an OOM.
* **Programs**: the port builds nothing per session. The kernels'
  CUDA libraries load once a process (``ops/cuda_build.py``) and stay
  loaded, so the service keeps no program cache (JAX's LRU over XLA
  programs and its pre-warm have no counterpart). A session's
  ``program_key`` names the libraries its engine launches (on the card;
  a CPU session runs their plain versions under the same key), and
  :func:`serve_summary` pairs a repeat query with its cold first one by
  it.
* **Warm start**: a finished solo session's final state is written as a
  snapshot (``checkpoint.retain_final_snapshot``, keyed by
  ``checkpoint.encoding_fingerprint``). A re-submitted model with the
  same fingerprint resumes from it and settles with zero new waves; an
  edited model changes the fingerprint and runs cold. The snapshot is
  read inside the warm run (a ``restore_read`` span), so the run's time
  to verdict counts it, and a warm session writes nothing. The spool is
  bounded by ``snapshot_budget_bytes`` (least recently used first out);
  a spool the service made itself is removed by :meth:`CheckService.close`.
* **Batched sessions** (``batch_sessions=N``, batch.py): concurrent
  compatible sessions seat in a ``BatchGroup`` and run as one fused
  hash-engine run, admitted on its fused plan; a group that cannot fuse
  runs each seat solo with a one-line reason.
* **HTTP**: the service mounts on the Explorer's server
  (explorer/server.py ``make_server(registry=...)``): ``POST /.check``
  runs a session (the ``--connect`` client's route), ``GET
  /.serve/sessions`` lists sessions, ``POST /.serve/trace`` writes the
  merged trace, ``GET /.metrics`` renders the live metrics.
* **Metrics** (metrics.py): the service's own seams (admission, queue
  depth and wait, gate hold, warm and cold starts, snapshot evictions) are
  metered directly as JAX's ``stpu_serve_*`` families, and each
  session's events feed the registry through ``bridge_events`` when it
  settles.
* **Reporting**: :meth:`CheckService.write_trace` merges every session's
  events into one TRACE pair (one run index a session, bracketed by
  ``session_begin`` / ``session_end``, with ``snapshot_evict`` rows) in
  JAX's schema; :func:`serve_summary` derives
  the per-session table that :func:`write_serve_artifact` writes as
  ``SERVE_r*.json`` (and the JAX package's ``tools/serve_report.py``
  reads).

Device memory is counted for the process, not the session: a traced
session's chunk ``mem_bytes`` and its ``memory_watermark`` include the
tensors of the sessions beside it, and the watermark says so
(``scope: "process"``).

    python -m stateright_tpu_torch serve 127.0.0.1:3000
    python -m stateright_tpu_torch --connect=127.0.0.1:3000 2pc check-gpu 9
"""

from __future__ import annotations

import hashlib
import io
import itertools
import json
import os
import shutil
import signal
import sys
import tempfile
import threading
import time
import warnings
from collections import OrderedDict, deque
from contextlib import nullcontext
from typing import Optional

from . import checkpoint, memplan, telemetry
from .metrics import MetricsRegistry, Rollup, bridge_events


class AdmissionRefused(RuntimeError):
    """The session's projected resident bytes exceed the service's
    device budget — refused BEFORE any kernel launch or wave."""


#: a session's argv is plain lane argv: the runtime flags are the
#: process's (the per-session tracer replaces --trace, the warm-start
#: retention would race --checkpoint/--resume, and the reductions are
#: armed in-process), and the device is the service's
_FLAG_REFUSAL = (
    "service sessions take plain lane argv (e.g. ['paxos', "
    "'check-gpu', '2']); runtime flags are process-global and are "
    "the service's job — telemetry via the per-session tracer / "
    "write_trace(), durability via warm-start retention, the device "
    "via the service's own --device"
)


#: the settled check sessions the registry keeps (the oldest drop out)
MAX_RETAINED_SESSIONS = 256


# -- FIFO device queue ----------------------------------------------------


class FifoLock:
    """A FIFO-fair mutex: acquirers are served strictly in arrival
    order (``threading.Lock`` promises no order, so one session could
    starve behind another). Release HANDS OFF to the oldest waiter: the
    lock never goes free for a newcomer to steal."""

    def __init__(self):
        self._mu = threading.Lock()
        self._waiters: deque = deque()
        self._locked = False

    def acquire(self) -> None:
        with self._mu:
            if not self._locked and not self._waiters:
                self._locked = True
                return
            ev = threading.Event()
            self._waiters.append(ev)
        ev.wait()

    def release(self) -> None:
        with self._mu:
            if self._waiters:
                self._waiters.popleft().set()  # hand-off: stays locked
            else:
                self._locked = False

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


def _launch_counts() -> dict:
    """The kernels' launch counters (each wrapper's ``launches``)."""
    from .ops import hashset, merge

    return {"member_sorted": merge.member_cuda.launches,
            "merge_sorted": merge.merge_cuda.launches,
            "hash_insert": hashset.insert_cuda.launches}


class _GateHandle:
    """One session's view of the service's device gate, installed as its
    engine's ``dispatch_gate``: acquiring adds to the session's queue
    wait, and the kernel launches made while the gate is held (the gate
    holds the device alone) add to the session's ``launches``."""

    __slots__ = ("_gate", "_session", "_m", "_t_acq", "_n0")

    def __init__(self, gate: FifoLock, session: "Session",
                 m: Optional[dict] = None):
        self._gate = gate
        self._session = session
        self._m = m
        self._t_acq = 0.0
        self._n0 = None

    def __enter__(self):
        m = self._m
        if m is not None:
            m["queue_depth"].inc()
        t0 = time.monotonic()
        self._gate.acquire()
        t1 = time.monotonic()
        self._session.gate_wait_sec += t1 - t0
        if m is not None:
            m["queue_depth"].dec()
            m["queue_wait"].observe(t1 - t0)
            self._t_acq = t1
        self._n0 = _launch_counts()
        return self

    def __exit__(self, *exc):
        launches = self._session.launches
        for k, n in _launch_counts().items():
            launches[k] = launches.get(k, 0) + n - self._n0[k]
        self._gate.release()
        if self._m is not None:
            self._m["gate_hold"].observe(time.monotonic() - self._t_acq)
        return False


class _FusedGateHandle:
    """The fused run's view of the device gate: one acquire a fused wave
    advances N sessions at once, so each member's queue wait gets a 1/N
    share."""

    __slots__ = ("_gate", "_sessions", "_m", "_t_acq")

    def __init__(self, gate: FifoLock, sessions: list,
                 m: Optional[dict] = None):
        self._gate = gate
        self._sessions = sessions
        self._m = m
        self._t_acq = 0.0

    def __enter__(self):
        m = self._m
        if m is not None:
            m["queue_depth"].inc()
        t0 = time.monotonic()
        self._gate.acquire()
        t1 = time.monotonic()
        share = (t1 - t0) / max(1, len(self._sessions))
        for s in self._sessions:
            s.gate_wait_sec += share
        if m is not None:
            m["queue_depth"].dec()
            m["queue_wait"].observe(t1 - t0)
            self._t_acq = t1
        return self

    def __exit__(self, *exc):
        self._gate.release()
        if self._m is not None:
            self._m["gate_hold"].observe(time.monotonic() - self._t_acq)
        return False


# -- per-thread stdout capture --------------------------------------------


class _ThreadLocalStdout:
    """A ``sys.stdout`` proxy with a per-thread target: each session's
    report (the lanes print to ``sys.stdout`` at call time) goes to its
    own buffer, while threads with no target write through to the real
    stream (``contextlib.redirect_stdout`` would swap the process's
    stream and mix concurrent sessions)."""

    def __init__(self, real):
        self._real = real
        self._tls = threading.local()

    def push(self, target) -> None:
        self._tls.target = target

    def pop(self) -> None:
        self._tls.target = None

    def _target(self):
        return getattr(self._tls, "target", None) or self._real

    def write(self, s):
        return self._target().write(s)

    def flush(self):
        t = self._target()
        flush = getattr(t, "flush", None)
        if flush is not None:
            flush()

    def __getattr__(self, name):
        return getattr(self._real, name)


def _stdout_proxy() -> _ThreadLocalStdout:
    """Install (idempotently) the thread-local stdout proxy over the
    CURRENT ``sys.stdout``."""
    cur = sys.stdout
    if isinstance(cur, _ThreadLocalStdout):
        return cur
    proxy = _ThreadLocalStdout(cur)
    sys.stdout = proxy
    return proxy


# -- programs -------------------------------------------------------------


def _program_sources(engine) -> tuple:
    """The CUDA sources an engine launches on the card (its
    ``_kernel_sources`` modules' libraries)."""
    kernels = getattr(engine, "_kernel_sources", None)
    if kernels is None:
        return ()
    return tuple(sorted(mod._SOURCE for mod in kernels()))


def _program_key(sources) -> Optional[str]:
    """A program's key: its libraries' file names, as the
    ``program_build`` events' ``key`` names them."""
    if not sources:
        return None
    from .ops.cuda_build import library_path

    return "+".join(library_path(s).name for s in sources)


# -- sessions -------------------------------------------------------------


class Session:
    """One query's record: identity, lane argv, state (queued → running
    → done / failed / refused; an Explorer mount stays ``serving``), its
    tracer, its timing lanes (admission wait, the summed device-queue
    wait, wall), its counts, and what it used and caused: admitted bytes,
    program key, the snapshot evictions it triggered, the snapshot it
    retained (``retain_sec``, ``snapshot_bytes``) and the kernel launches
    it made while holding the gate."""

    def __init__(self, sid: int, kind: str, argv):
        self.id = sid
        self.kind = kind
        self.argv = tuple(argv)
        self.state = "queued"
        self.error: Optional[str] = None
        self.output: Optional[str] = None
        self.tracer = None
        self.checker = None
        self.device = False
        self.running = False
        self.warm_start = False
        self.encoding_fp: Optional[str] = None
        self.program_key: Optional[str] = None
        self.admitted_bytes: Optional[int] = None
        self.unique: Optional[int] = None
        self.total: Optional[int] = None
        self.snapshot_evictions: list = []
        #: set when this session ran as a lane of a fused batch
        #: dispatch: {group, size, index}
        self.batch: Optional[dict] = None
        self.gate_wait_sec = 0.0
        self.launches: dict = {}
        self.retain_sec: Optional[float] = None
        self.snapshot_bytes: Optional[int] = None
        self.t_submit = time.monotonic()
        self.t_admit: Optional[float] = None
        self.t_start: Optional[float] = None
        self.t_end: Optional[float] = None
        self._group = None

    def describe(self) -> dict:
        return dict(
            session=self.id,
            kind=self.kind,
            lane=" ".join(self.argv),
            state=self.state,
            error=self.error,
            warm_start=self.warm_start,
            admitted_bytes=self.admitted_bytes,
            queue_wait_sec=round(self.gate_wait_sec, 6),
            unique=self.unique,
            total=self.total,
            duration_sec=(
                round(self.t_end - self.t_start, 6)
                if self.t_end is not None and self.t_start is not None
                else None
            ),
        )


class CheckService:
    """The resident service (module docstring). Thread-safe: ``check``
    may be called from any number of threads at once (the HTTP server's
    request threads, a test's workers) — the FIFO gate arbitrates the
    device, the service lock the byte budget, and per-session tracers
    keep telemetry apart.

    ``device`` is where every session runs (``"cuda"`` or ``"cpu"``);
    ``device_budget_bytes`` bounds the admitted sessions' projected
    resident bytes (None: admit everything); ``warm_start=False`` turns
    retention and resume off; ``spool_dir`` holds the warm-start
    snapshots (None: a temporary directory of the service's own, made at
    the first retention and removed by :meth:`close`);
    ``snapshot_budget_bytes`` bounds the spool (None: unbounded);
    ``batch_sessions=N`` fuses up to N concurrent compatible sessions
    (None: every session runs solo), which wait up to
    ``batch_window_sec`` for peers. The registry keeps the
    :data:`MAX_RETAINED_SESSIONS` newest settled check sessions."""

    def __init__(self, *, device: str = "cuda",
                 device_budget_bytes: Optional[int] = None,
                 spool_dir: Optional[str] = None,
                 warm_start: bool = True,
                 batch_sessions: Optional[int] = None,
                 batch_window_sec: float = 0.25,
                 snapshot_budget_bytes: Optional[int] = None):
        if device not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, got {device!r}")
        self.device = device
        self.device_budget_bytes = device_budget_bytes
        self.warm_start = warm_start
        self.batch_sessions = batch_sessions
        self.batch_window_sec = batch_window_sec
        self.snapshot_budget_bytes = snapshot_budget_bytes
        self.spool_dir = spool_dir
        #: the spool the service made itself, which :meth:`close` removes
        self._own_spool: Optional[str] = None
        if spool_dir is not None:
            os.makedirs(spool_dir, exist_ok=True)
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self._gate = FifoLock()
        self._sessions: list[Session] = []
        self._ids = itertools.count()
        #: encoding fingerprint -> {key, path, bytes}: the warm-start
        #: snapshot spool (most recently used last)
        self._warm: "OrderedDict[str, dict]" = OrderedDict()
        #: compatibility class key -> the currently OPEN BatchGroup
        self._groups: dict = {}
        self._group_ids = itertools.count(1)
        #: the fused groups admitted (the service's admission record)
        self._batches: list[dict] = []
        self._explorer = None  # (checker, snapshot, session)
        self.metrics = MetricsRegistry()
        m = self.metrics
        self._m = dict(
            requests=m.counter(
                "stpu_serve_requests_total",
                "check sessions submitted to the service"),
            active=m.gauge(
                "stpu_serve_active_sessions",
                "check sessions currently in flight"),
            queue_depth=m.gauge(
                "stpu_serve_queue_depth",
                "sessions waiting on the FIFO device gate"),
            queue_wait=m.histogram(
                "stpu_serve_queue_wait_seconds",
                "per-acquire FIFO device-gate wait"),
            gate_hold=m.histogram(
                "stpu_serve_gate_hold_seconds",
                "device-gate hold per chunk dispatch+sync"),
            sessions=m.counter(
                "stpu_serve_sessions_total",
                "settled sessions by final state"),
            admission=m.counter(
                "stpu_serve_admission_total",
                "admission decisions (accepted/refused)"),
            admission_bytes=m.counter(
                "stpu_serve_admission_bytes_total",
                "priced resident bytes by admission decision"),
            warm=m.counter(
                "stpu_serve_warm_hits_total",
                "device sessions by warm/cold start"),
            batch_fallbacks=m.counter(
                "stpu_serve_batch_fallbacks_total",
                "fused groups refused admission (fell back solo)"),
            snap_evict=m.counter(
                "stpu_serve_snapshot_evictions_total",
                "warm-start snapshot spool evictions"),
            snap_evict_bytes=m.counter(
                "stpu_serve_snapshot_evicted_bytes_total",
                "warm-start snapshot bytes evicted"),
        )
        # the unlabeled gauges at zero, so a fresh scrape shows them
        self._m["active"].set(0)
        self._m["queue_depth"].set(0)

    # -- check sessions ---------------------------------------------------

    def check(self, argv) -> Session:
        """Run one CLI lane as a session in the CALLING thread (callers
        bring their own concurrency) on the service's device, and return
        the settled Session; the lane's report is ``session.output``.
        Raises ValueError on a flag in ``argv`` or a lane that is not a
        model's check lane; admission refusals and run errors land on the
        session, not as raises."""
        argv = [str(a) for a in argv]
        if any(a.startswith("--") for a in argv):
            raise ValueError(_FLAG_REFUSAL)
        from . import cli

        # only a model's check lanes are sessions: `serve` would nest a
        # daemon, and `explore` and `spawn` would serve forever on this
        # thread
        if not argv or argv[0] not in cli._MODELS:
            raise ValueError(
                f"unknown session lane {argv[:1] or '(empty)'}: "
                "service sessions run model check lanes only "
                f"({' | '.join(sorted(cli._MODELS))})")
        if argv[1:2] == ["explore"]:
            raise ValueError(
                "explore is not a session lane: mount the model on the "
                "service (serve --explore=MODEL[,COUNT])")
        if argv[1:2] == ["spawn"]:
            raise ValueError(
                "spawn is not a session lane: it runs UDP servers until "
                "interrupted (python -m stateright_tpu_torch MODEL spawn)")

        session = Session(next(self._ids), "check", argv)
        session.tracer = telemetry.RunTracer()
        with self._lock:
            self._sessions.append(session)
        self._m["requests"].inc()
        self._m["active"].inc()
        proxy = _stdout_proxy()
        buf = io.StringIO()
        proxy.push(buf)
        session.t_start = time.monotonic()
        try:
            with session.tracer.activate_thread():
                cli._SESSION_HOOK.hook = self._session_hook(session)
                try:
                    cli.main([*argv, f"--device={self.device}"])
                    session.state = "done"
                except AdmissionRefused as exc:
                    session.state = "refused"
                    session.error = str(exc)
                    print(f"REFUSED: {exc}")
                except SystemExit as exc:
                    code = exc.code
                    if code in (None, 0):
                        session.state = "done"
                    else:
                        session.state = "failed"
                        session.error = str(code)
                except Exception as exc:
                    session.state = "failed"
                    session.error = f"{type(exc).__name__}: {exc}"
                finally:
                    cli._SESSION_HOOK.hook = None
                # retention while the session's tracer is still this
                # thread's, so the retained snapshot's checkpoint event
                # lands in THIS trace
                self._finish(session)
        finally:
            proxy.pop()
            session.output = buf.getvalue()
            session.t_end = time.monotonic()
            session.running = False
            self._m["active"].dec()
            self._m["sessions"].inc(state=session.state)
            # the tracer->metrics bridge: every event of this session,
            # folded once, at settle
            with session.tracer._lock:
                settled = list(session.tracer.events)
            bridge_events(settled, self.metrics)
            self._trim_sessions()
        return session

    def _trim_sessions(self) -> None:
        """Drop the oldest settled check sessions past
        :data:`MAX_RETAINED_SESSIONS` (out of ``status_block`` and later
        ``write_trace`` exports); live and Explorer sessions stay."""
        cap = MAX_RETAINED_SESSIONS
        with self._lock:
            settled = [s for s in self._sessions
                       if s.kind == "check" and not s.running
                       and s.t_end is not None]
            excess = len(settled) - cap
            if excess <= 0:
                return
            drop = set(id(s) for s in settled[:excess])
            self._sessions = [s for s in self._sessions
                              if id(s) not in drop]

    def _session_hook(self, session: Session):
        """What ``cli._report`` runs on the freshly spawned checker before
        its first join: admission, warm-start staging, the gate and
        retention (or a seat in a batch group)."""

        def hook(checker) -> None:
            session.checker = checker
            if not hasattr(checker, "_run_attempt"):
                # a host engine: no device work to admit or gate
                session.t_admit = time.monotonic()
                session.running = True
                return
            session.device = True
            fp = checkpoint.encoding_fingerprint(checker)
            session.encoding_fp = fp
            warm_entry = self._warm.get(fp) if self.warm_start else None
            # a warm-startable session settles at once solo: resuming
            # beats fusing, so only sessions without a snapshot seat
            if self.batch_sessions and warm_entry is None:
                from .batch import batch_eligible

                key, _reason = batch_eligible(checker)
                if key is not None and self._join_batch(key, session,
                                                        checker):
                    return
            self._solo_setup(session, checker)

        return hook

    def _solo_setup(self, session: Session, checker,
                    in_run: bool = False) -> None:
        """The solo session: admission, warm-start staging, retention
        and the FIFO gate. Also where a batch seat that falls back lands
        (its ``solo_prepare``, ``in_run``: the run has begun)."""
        self._admit(session, checker)
        entry = (self._warm.get(session.encoding_fp) if self.warm_start
                 else None)
        if entry is not None:
            if in_run:
                self._resume_warm(session, checker, entry)
            else:
                run = checker._run

                def warm_run(reporter=None):
                    # the read inside the run: its time to verdict
                    # counts it
                    self._resume_warm(session, checker, entry)
                    run(reporter)

                checker._run = warm_run
        checker.keep_final_carry = True
        checker.memory_scope = "process"
        checker.dispatch_gate = _GateHandle(self._gate, session, self._m)

    def _resume_warm(self, session: Session, checker, entry: dict) -> None:
        """Stage the spooled snapshot of a finished run of this
        encoding, read in a ``restore_read`` span of the session's run."""
        try:
            with telemetry.span("restore_read"):
                checker.resume_from(entry["path"])
            session.warm_start = True
            with self._lock:
                if session.encoding_fp in self._warm:
                    self._warm.move_to_end(session.encoding_fp)
        except checkpoint.SnapshotError:
            # a stale, incompatible or evicted snapshot: run cold —
            # correctness never rides the cache
            session.warm_start = False

    # -- wave batching -----------------------------------------------------

    def _join_batch(self, key, session: Session, checker) -> bool:
        """Claim a seat in the open batch group of this compatibility
        class (opening a fresh group when none is open or the open one
        froze) and route the checker's run through it. False when no
        seat could be claimed (the session runs solo)."""
        from .batch import BatchGroup

        with self._lock:
            group = self._groups.get(key)
            member = (group.try_join(checker, " ".join(session.argv))
                      if group is not None else None)
            if member is None:
                group = BatchGroup(
                    next(self._group_ids), key,
                    max_sessions=int(self.batch_sessions),
                    window_sec=self.batch_window_sec)
                group.admit = (lambda fused, members, g=group:
                               self._admit_fused(g, fused, members))
                group.make_gate = (lambda g=group: _FusedGateHandle(
                    self._gate, [m.session for m in g.members], self._m))
                self._groups[key] = group
                member = group.try_join(checker, " ".join(session.argv))
            if member is None:
                return False
        member.session = session
        member.notify = print  # the session's thread: its own output

        def solo_prepare():
            session.batch = None  # this session did not batch
            session._group = None
            self._solo_setup(session, checker, in_run=True)

        member.solo_prepare = solo_prepare
        session.batch = dict(group=group.group_id, size=None,
                             index=member.index)
        session._group = group
        checker._run = (lambda reporter=None:
                        group.member_run(member, reporter))
        return True

    def _admit_fused(self, group, fused, members) -> Optional[str]:
        """Admission of a fused plan (called by the group's leader when
        it freezes): the fused engine's configuration priced
        (``memplan.fused_session_bytes``) against the device budget less
        the other sessions in flight. None admits every member with its
        even share; else a one-line reason, and the group falls back to
        solo runs, each facing the solo admission."""
        plan = memplan.fused_session_bytes(fused, len(members))
        sessions = [m.session for m in members]
        with self._lock:
            in_flight = sum(
                s.admitted_bytes or 0 for s in self._sessions
                if s.running and s.device and s not in sessions)
            budget = self.device_budget_bytes
            if (budget is not None
                    and plan["total_bytes"] + in_flight > budget):
                self._m["batch_fallbacks"].inc()
                return (
                    f"batch: fused plan of {len(members)} session(s) "
                    f"projects {plan['total_bytes']:,} resident "
                    f"bytes ({in_flight:,} already in flight, device "
                    f"budget {budget:,}); falling back to solo FIFO")
            now = time.monotonic()
            for s in sessions:
                s.admitted_bytes = plan["per_session_bytes"]
                s.t_admit = now
                s.running = True
                if s.batch is not None:
                    s.batch["size"] = len(members)
                self._m["admission"].inc(decision="accepted")
                self._m["admission_bytes"].inc(
                    plan["per_session_bytes"], decision="accepted")
            self._batches.append(dict(
                group=group.group_id, size=len(members),
                sessions=[s.id for s in sessions],
                class_key=str(group.class_key),
                plan_bytes=plan["total_bytes"],
                per_session_bytes=plan["per_session_bytes"]))
            # this group is running: the next arrival opens a fresh one
            if self._groups.get(group.class_key) is group:
                del self._groups[group.class_key]
        return None

    def _admit(self, session: Session, checker) -> None:
        """The admission check, before any kernel or wave: the session's
        resident bytes priced from its configuration
        (``memplan.session_resident_bytes``) against the device budget
        less the sessions in flight. Refuses loudly."""
        est = memplan.session_resident_bytes(checker)
        with self._lock:
            in_flight = sum(
                s.admitted_bytes or 0 for s in self._sessions
                if s.running and s.device and s is not session)
            budget = self.device_budget_bytes
            if (budget is not None
                    and est["total_bytes"] + in_flight > budget):
                session.error = (
                    f"admission refused: session projects "
                    f"{est['total_bytes']:,} resident bytes "
                    f"(visited {est['visited_bytes']:,} + frontier "
                    f"{est['frontier_bytes']:,} + candidates "
                    f"{est['cand_bytes']:,}), {in_flight:,} already "
                    f"in flight, device budget "
                    f"{budget:,} — shrink the lane's capacity or "
                    "raise the service budget")
                self._m["admission"].inc(decision="refused")
                self._m["admission_bytes"].inc(
                    est["total_bytes"], decision="refused")
                raise AdmissionRefused(session.error)
            session.admitted_bytes = est["total_bytes"]
            session.t_admit = time.monotonic()
            session.running = True
            self._m["admission"].inc(decision="accepted")
            self._m["admission_bytes"].inc(
                est["total_bytes"], decision="accepted")

    def _finish(self, session: Session) -> None:
        """The settled session's counts; for a finished device session,
        its program key, the warm-start retention of a cold run (a warm
        one's snapshot is in the spool already) and the release of its
        device state."""
        checker = session.checker
        if checker is None:
            return
        session.unique = getattr(checker, "_unique_states", None)
        session.total = getattr(checker, "_total_states", None)
        if not session.device or session.state != "done":
            return
        self._m["warm"].inc(result="warm" if session.warm_start else "cold")
        group = session._group
        engine = group.fused if group is not None else checker
        session.program_key = _program_key(_program_sources(engine))
        if (self.warm_start and session.encoding_fp
                and not session.warm_start):
            key = hashlib.sha1(
                session.encoding_fp.encode()).hexdigest()[:16]
            path = os.path.join(self._spool(), f"warm_{key}.ckpt")
            try:
                t0 = time.monotonic()
                manifest = checkpoint.retain_final_snapshot(checker, path)
                if manifest is not None:
                    session.retain_sec = time.monotonic() - t0
                    session.snapshot_bytes = int(
                        manifest.get("snapshot_bytes") or 0)
                    with self._lock:
                        self._warm[session.encoding_fp] = dict(
                            key=key, path=path,
                            bytes=session.snapshot_bytes)
                        self._warm.move_to_end(session.encoding_fp)
                    self._spool_evict(session)
            except Exception as exc:
                # retention is an optimization, never the session's
                # failure: the next re-check of this model runs cold
                warnings.warn(f"warm-start retention failed: "
                              f"{type(exc).__name__}: {exc}",
                              RuntimeWarning, stacklevel=2)
        # the snapshot (or nothing) is the warm state now: the finished
        # run's device tensors go, so settled sessions hold no memory
        checker._final_carry = checker._final = checker._plog = None

    # -- the warm-start snapshot spool ------------------------------------

    def _spool_evict(self, session: Session) -> None:
        """Evict the least recently used snapshots past
        ``snapshot_budget_bytes`` (never the one just retained): the
        evicted fingerprint's next re-check runs cold."""
        budget = self.snapshot_budget_bytes
        if budget is None:
            return
        evicted = []
        with self._lock:
            total = sum(e["bytes"] for e in self._warm.values())
            while total > budget and len(self._warm) > 1:
                fp, entry = next(iter(self._warm.items()))
                if fp == session.encoding_fp:
                    break
                self._warm.pop(fp)
                total -= entry["bytes"]
                evicted.append(entry)
                session.snapshot_evictions.append(
                    (entry["key"], entry["bytes"]))
                self._m["snap_evict"].inc()
                self._m["snap_evict_bytes"].inc(entry["bytes"])
        for entry in evicted:
            try:
                os.remove(entry["path"])
            except OSError:
                pass

    def spool_bytes(self) -> int:
        with self._lock:
            return sum(e["bytes"] for e in self._warm.values())

    def _spool(self) -> str:
        """The spool's directory, made at the first retention when the
        caller named none."""
        with self._lock:
            if self.spool_dir is None:
                self.spool_dir = self._own_spool = tempfile.mkdtemp(
                    prefix="stpu_serve_")
            return self.spool_dir

    def close(self) -> None:
        """Remove the spool the service made itself, with every snapshot
        in it (a ``spool_dir`` the caller named stays): later re-checks
        run cold. The daemon calls it as it exits."""
        with self._lock:
            own, self._own_spool = self._own_spool, None
            if own is not None:
                self.spool_dir = None
                self._warm.clear()
        if own is not None:
            shutil.rmtree(own, ignore_errors=True)

    # -- Explorer mount ---------------------------------------------------

    def mount_explorer(self, builder, name: Optional[str] = None):
        """Attach one Explorer model: spawn its on-demand checker and open
        a long-lived ``explorer`` session whose tracer records every
        request's span (:meth:`request_scope`). Returns ``(checker,
        snapshot)`` for ``explorer.server.make_server``."""
        from .explorer.server import Snapshot

        checker = builder.spawn_on_demand()
        snapshot = Snapshot()
        model = name or type(checker.model).__name__
        session = Session(next(self._ids), "explorer", ("explore", model))
        session.tracer = telemetry.RunTracer()
        session.tracer.begin_run(lane=dict(engine="explorer", model=model))
        session.state = "serving"
        session.t_admit = session.t_start = time.monotonic()
        with self._lock:
            self._sessions.append(session)
            self._explorer = (checker, snapshot, session)
        return checker, snapshot

    def http_server(self, host: str, port: int):
        """The service's HTTP server: the Explorer server (when a model is
        mounted) with the service's routes and session registry on top
        (explorer/server.py ``make_server(registry=...)``)."""
        from .explorer.server import Snapshot, make_server

        if self._explorer is not None:
            checker, snapshot, _ = self._explorer
        else:
            checker, snapshot = None, Snapshot()
        return make_server(checker, snapshot, host, port, registry=self)

    # -- the make_server registry protocol --------------------------------

    def handle_request(self, handler, method: str, path: str) -> bool:
        """The service's routes, tried before the Explorer's: ``POST
        /.check`` runs a session from JSON ``{"argv": [...]}``, ``GET
        /.serve/sessions`` lists the sessions, ``POST /.serve/trace``
        writes the merged TRACE pair, ``GET /.metrics`` renders the
        registry in Prometheus text (its lock is held only for reads, so
        a scrape answers while a session holds the device). True when
        handled."""
        if method == "GET" and path == "/.metrics":
            body = self.metrics.render_prometheus().encode()
            handler.send_response(200)
            handler.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8")
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            handler.wfile.write(body)
            return True
        if method == "POST" and path == "/.check":
            try:
                length = int(handler.headers.get("Content-Length") or 0)
                body = json.loads(handler.rfile.read(length) or b"{}")
                argv = [str(a) for a in (body.get("argv") or [])]
                session = self.check(argv)
            except (ValueError, TypeError) as exc:
                handler._json(dict(ok=False, error=str(exc)), code=400)
                return True
            handler._json(dict(ok=session.state == "done",
                               session=session.describe(),
                               output=session.output))
            return True
        if method == "GET" and path == "/.serve/sessions":
            handler._json(self.status_block())
            return True
        if method == "POST" and path == "/.serve/trace":
            jsonl, chrome = self.write_trace()
            handler._json(dict(jsonl=jsonl, chrome=chrome))
            return True
        return False

    def request_scope(self):
        """Installed around each Explorer request: the explorer session's
        tracer becomes the request thread's, so its spans land there."""
        ex = self._explorer
        if ex is None:
            return nullcontext()
        return ex[2].tracer.activate_thread()

    def status_block(self) -> dict:
        """The service's snapshot for ``/.status`` and
        ``/.serve/sessions``: attribute reads under the service lock,
        never a device wait."""
        with self._lock:
            sessions = [s.describe() for s in self._sessions]
            warm_n = len(self._warm)
            spool = sum(e["bytes"] for e in self._warm.values())
            n_batches = len(self._batches)
        return dict(
            sessions=sessions,
            device_budget_bytes=self.device_budget_bytes,
            warm_models=warm_n,
            snapshots=dict(retained=warm_n, bytes=spool,
                           budget_bytes=self.snapshot_budget_bytes),
            batching=dict(batch_sessions=self.batch_sessions,
                          window_sec=self.batch_window_sec,
                          groups_dispatched=n_batches),
            metrics=dict(
                active_sessions=int(self._m["active"].value()),
                queue_depth=int(self._m["queue_depth"].value()),
                refusals=int(
                    self._m["admission"].value(decision="refused")),
                ttv_p99_sec=self.metrics.histogram_quantile(
                    "stpu_time_to_verdict_seconds", 0.99),
            ),
        )

    # -- merged trace export ----------------------------------------------

    def events(self) -> list:
        """Every session's events in ONE stream: disjoint run indices (in
        submission order), times on the service's clock, each session
        bracketed by ``session_begin`` / ``session_end`` (and the
        ``snapshot_evict`` rows of the evictions it caused). The stream
        validates under ``telemetry.validate_events``. A live Explorer
        session's run stays open: an export is a read."""
        with self._lock:
            sessions = list(self._sessions)
        out: list[dict] = []
        base = 0
        now = time.monotonic()
        for s in sessions:
            tracer = s.tracer
            evs: list[dict] = []
            if tracer is not None:
                with tracer._lock:
                    evs = [dict(e) for e in tracer.events]
            runs = sorted({
                e["run"] for e in evs
                if isinstance(e.get("run"), int) and e["run"] >= 0
            }) or [0]
            run_map = {r: base + i for i, r in enumerate(runs)}
            rb = base
            offset = ((tracer._t_base - self._t0)
                      if tracer is not None else 0.0)
            t_admit = s.t_admit if s.t_admit is not None else s.t_submit
            out.append(dict(
                ev="session_begin", run=rb, session=s.id,
                kind=s.kind, t=round(t_admit - self._t0, 6),
                lane=" ".join(s.argv),
                admitted_bytes=s.admitted_bytes,
                admission_wait_sec=round(t_admit - s.t_submit, 6),
                warm_start=s.warm_start,
            ))
            for e in evs:
                r = e.get("run")
                if isinstance(r, int):
                    e["run"] = run_map.get(r, rb)
                for k in ("t", "t0", "t1"):
                    v = e.get(k)
                    if isinstance(v, (int, float)):
                        e[k] = round(v + offset, 6)
                out.append(e)
            t_end = s.t_end if s.t_end is not None else now
            out.append(dict(
                ev="session_end", run=rb, session=s.id,
                state=s.state, t=round(t_end - self._t0, 6),
                error=s.error, unique=s.unique, total=s.total,
                queue_wait_sec=round(s.gate_wait_sec, 6),
                warm_start=s.warm_start,
                program_key=s.program_key,
                duration_sec=(
                    round(t_end - s.t_start, 6)
                    if s.t_start is not None else None
                ),
            ))
            for key_hash, nbytes in s.snapshot_evictions:
                out.append(dict(
                    ev="snapshot_evict", run=rb, key=key_hash,
                    bytes=int(nbytes), t=round(t_end - self._t0, 6),
                ))
            base += len(runs)
        return out

    def write_trace(self, root: Optional[str] = None,
                    round: Optional[int] = None) -> tuple[str, str]:
        """Write the merged stream as an auto-numbered TRACE pair (JSONL
        and Chrome trace) — the input :func:`serve_summary` derives
        from."""
        tracer = telemetry.RunTracer()
        tracer.events = self.events()
        return telemetry.write_artifacts(tracer, root=root, round=round)


# -- the derived per-session summary ------------------------------------


def serve_summary(events: list) -> Optional[dict]:
    """Derive the per-session latency-per-query view from a service
    trace's ``session_begin``/``session_end`` events and each
    session's run events: time-to-verdict, queue wait, compile-tier
    ledger, cache hits, and the warm-vs-cold pairing (repeat queries
    of one program key vs their cold first query, with the
    time-to-verdict delta attributed between the compile tier and
    dispatch). None when the trace carries no session events (not a
    service trace). The JAX package's function, unchanged: its
    ``tools/serve_report.py`` reads a port service trace."""
    from .telemetry import _run_view

    begins = [e for e in events if e.get("ev") == "session_begin"]
    if not begins:
        return None
    ends = {e["session"]: e for e in events
            if e.get("ev") == "session_end"}
    batch_by_run = {e["run"]: e for e in events
                    if e.get("ev") == "batch"}
    sessions = []
    for sb in sorted(begins, key=lambda e: e["session"]):
        run = sb["run"]
        view = _run_view(events, run)
        se = ends.get(sb["session"], {})
        tiers: dict[str, int] = {}
        for b in view["builds"]:
            tiers[b["tier"]] = tiers.get(b["tier"], 0) + 1
        build_wall = sum(
            b.get("wall_sec") or 0.0 for b in view["builds"]
        )
        cold = sum(b.get("cold_sec") or 0.0 for b in view["builds"])
        t0_run = (view["begin"] or {}).get("t", sb["t"])
        verdicts = [
            dict(
                {k: v for k, v in ev.items()
                 if k not in ("ev", "run", "t")},
                t_since_run=round(ev["t"] - t0_run, 6),
            )
            for ev in view["verdicts"]
        ]
        ttv = max(
            (v["t_since_run"] for v in verdicts), default=None
        )
        prof = view["latency_profile"] or {}
        spans = [s for s in view["spans"]
                 if s.get("phase") == "explorer_request"]
        sessions.append(dict(
            session=sb["session"],
            run=run,
            kind=sb["kind"],
            lane=sb.get("lane"),
            state=se.get("state"),
            error=se.get("error"),
            warm_start=bool(se.get("warm_start",
                                   sb.get("warm_start"))),
            admitted_bytes=sb.get("admitted_bytes"),
            admission_wait_sec=sb.get("admission_wait_sec"),
            queue_wait_sec=se.get("queue_wait_sec"),
            unique=se.get("unique"),
            total=se.get("total"),
            duration_sec=se.get("duration_sec"),
            chunks=prof.get("chunks"),
            waves=prof.get("waves"),
            resumed_from_wave=prof.get("resumed_from_wave"),
            time_to_first_wave_sec=prof.get(
                "time_to_first_wave_sec"
            ),
            dispatch_net_sec=prof.get("dispatch_net_sec"),
            fetch_sec=prof.get("fetch_sec"),
            time_to_verdict_sec=ttv,
            verdicts=verdicts,
            builds=dict(
                tiers=tiers,
                wall_sec=round(build_wall, 6),
                cold_sec=round(cold, 6),
            ),
            program_key=se.get("program_key"),
            batch=(
                {k: batch_by_run[run][k]
                 for k in ("group", "size", "index", "chunks")
                 if k in batch_by_run[run]}
                if run in batch_by_run else None
            ),
            explorer=(dict(
                requests=len(spans),
                cache_hits=sum(
                    1 for s in spans if s.get("cache_hit")
                ),
            ) if spans else None),
        ))
    evictions = [
        {k: v for k, v in e.items() if k != "ev"}
        for e in events if e.get("ev") == "program_evict"
    ]
    snapshot_evictions = [
        {k: v for k, v in e.items() if k != "ev"}
        for e in events if e.get("ev") == "snapshot_evict"
    ]
    return dict(
        sessions=sessions,
        evictions=evictions,
        snapshot_evictions=snapshot_evictions,
        warm_vs_cold=_warm_vs_cold(sessions),
        batches=_batch_groups(sessions),
    )


def _batch_groups(sessions: list) -> list:
    """Aggregate the per-session ``batch`` lanes into per-group rows:
    occupancy (which sessions shared the fused dispatch, how many
    fused chunks they rode) and the amortized floor per query — each
    member's dispatch+sync overhead is already its 1/N_active share
    of the fused walls, so the mean per-query overhead IS the
    amortized sync floor serve_report tables against the solo
    baseline."""
    groups: dict = {}
    for s in sessions:
        b = s.get("batch")
        if not b:
            continue
        g = groups.setdefault(b["group"], dict(
            group=b["group"],
            size=b.get("size"),
            sessions=[],
            chunks=b.get("chunks"),
            members=[],
        ))
        g["sessions"].append(s["session"])
        overhead = ((s.get("dispatch_net_sec") or 0.0)
                    + (s.get("fetch_sec") or 0.0))
        g["members"].append(dict(
            session=s["session"],
            waves=s.get("waves"),
            dispatch_net_sec=s.get("dispatch_net_sec"),
            fetch_sec=s.get("fetch_sec"),
            overhead_sec=round(overhead, 6),
            time_to_verdict_sec=s.get("time_to_verdict_sec"),
        ))
    out = []
    for g in sorted(groups.values(), key=lambda g: g["group"]):
        ov = [m["overhead_sec"] for m in g["members"]]
        g["per_query_overhead_sec"] = (
            round(sum(ov) / len(ov), 6) if ov else None
        )
        out.append(g)
    return out


def _warm_vs_cold(sessions: list) -> list:
    """Pair repeat check queries with their cold first query (same
    program key): per pair, the time-to-verdict delta and where the
    ledger says it went — the compile tier (build walls) vs dispatch
    proper (``dispatch_net_sec``, compile already subtracted). The
    acceptance read: a healthy warm query's ttv sits below the cold
    one with the difference on the compile side."""
    by_key: dict[str, list] = {}
    for s in sessions:
        if s["kind"] == "check" and s.get("program_key"):
            by_key.setdefault(s["program_key"], []).append(s)
    out = []
    for key, group in sorted(by_key.items()):
        if len(group) < 2:
            continue
        cold = group[0]
        for warm in group[1:]:
            c_ttv, w_ttv = (cold.get("time_to_verdict_sec"),
                            warm.get("time_to_verdict_sec"))
            out.append(dict(
                program_key=key,
                cold_session=cold["session"],
                warm_session=warm["session"],
                warm_start=warm.get("warm_start"),
                cold_ttv_sec=c_ttv,
                warm_ttv_sec=w_ttv,
                ttv_delta_sec=(
                    round(c_ttv - w_ttv, 6)
                    if c_ttv is not None and w_ttv is not None
                    else None
                ),
                compile_delta_sec=round(
                    (cold["builds"]["wall_sec"]
                     - warm["builds"]["wall_sec"]), 6
                ),
                dispatch_net_delta_sec=(
                    round((cold.get("dispatch_net_sec") or 0.0)
                          - (warm.get("dispatch_net_sec") or 0.0), 6)
                ),
                waves_cold=cold.get("waves"),
                waves_warm=warm.get("waves"),
            ))
    return out


def write_serve_artifact(summary: dict,
                         root: Optional[str] = None,
                         metrics: Optional[dict] = None) -> str:
    """Write one auto-numbered ``SERVE_r*.json`` (a round sequence of its
    own, as MEM, LAT and SLO; artifacts.py) from :func:`serve_summary`;
    ``metrics`` embeds a registry snapshot
    (:meth:`~stateright_tpu_torch.metrics.MetricsRegistry.snapshot`)
    beside it. :func:`~stateright_tpu_torch.artifacts.latest_serve_summary`
    reads the newest back."""
    from .artifacts import artifact_path, next_round, provenance, repo_root

    root = repo_root() if root is None else root
    path = artifact_path("SERVE", "json", root=root,
                         round=next_round(root, stems=("SERVE",)))
    doc = dict(summary)
    if metrics is not None:
        doc["metrics"] = metrics
    doc.setdefault("provenance", provenance())
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return path


# -- daemon + client (the CLI's `serve` / `--connect` lanes) --------------


def explorer_builder(name: str, count: Optional[int] = None):
    """The CheckerBuilder of the daemon's ``--explore=MODEL[,COUNT]``
    mount (the models the CLI lanes build)."""
    if name == "2pc":
        from .models.two_phase_commit import TwoPhaseSys

        return TwoPhaseSys(rm_count=count or 2).checker()
    if name == "paxos":
        from .models.paxos import PaxosModelCfg, paxos_model

        return paxos_model(
            PaxosModelCfg(client_count=count or 2, server_count=3)).checker()
    if name == "increment":
        from .models.increment import Increment

        return Increment(thread_count=count or 2).checker()
    if name == "single-copy-register":
        from .models.single_copy_register import (
            SingleCopyRegisterCfg,
            single_copy_register_model,
        )

        return single_copy_register_model(
            SingleCopyRegisterCfg(client_count=count or 2)).checker()
    if name == "linearizable-register":
        from .models.linearizable_register import AbdModelCfg, abd_model

        return abd_model(AbdModelCfg(client_count=count or 2)).checker()
    raise SystemExit(
        f"serve --explore: unknown model {name!r} (2pc | paxos | "
        "increment | single-copy-register | linearizable-register)")


def daemon_main(argv: list) -> int:
    """``python -m stateright_tpu_torch serve [HOST:PORT] [--device
    cuda|cpu] [--explore=MODEL[,COUNT]] [--device-budget-bytes=N]
    [--batch-sessions[=N]]
    [--batch-window-sec=S] [--snapshot-budget-bytes=N] [--no-warm-start]
    [--metrics-interval=N [--metrics-path=FILE]]``: run the resident
    service until interrupted, every session on ``--device`` (the CUDA
    device by default). Clients reach it with ``--connect=HOST:PORT`` on
    any check lane, a browser at ``/`` when a model is mounted.
    ``--batch-sessions`` fuses up to N (default 4) concurrent compatible
    sessions (batch.py); ``--metrics-interval`` appends a
    ``metrics_rollup`` JSONL line every N seconds, and ``GET /.metrics``
    serves the same registry in Prometheus text either way. An interrupt
    or SIGTERM stops it and removes its snapshot spool."""
    from .cli import DEFAULT_METRICS_PATH

    addr = "localhost:3000"
    explore = None
    metrics_interval = None
    metrics_path = None
    kw: dict = {}
    it = iter(argv)
    for a in it:
        if a.startswith("--explore="):
            name, _, count = a.split("=", 1)[1].partition(",")
            explore = (name, int(count) if count else None)
        elif a == "--device":
            kw["device"] = next(it, None)
        elif a.startswith("--device="):
            kw["device"] = a.split("=", 1)[1]
        elif a.startswith("--metrics-interval="):
            metrics_interval = float(a.split("=", 1)[1])
            if metrics_interval <= 0:
                raise SystemExit(f"serve: {a}: must be > 0 seconds")
        elif a.startswith("--metrics-path="):
            metrics_path = a.split("=", 1)[1]
        elif a.startswith("--device-budget-bytes="):
            kw["device_budget_bytes"] = int(a.split("=", 1)[1])
        elif a == "--batch-sessions":
            kw["batch_sessions"] = 4
        elif a.startswith("--batch-sessions="):
            kw["batch_sessions"] = int(a.split("=", 1)[1])
        elif a.startswith("--batch-window-sec="):
            kw["batch_window_sec"] = float(a.split("=", 1)[1])
        elif a.startswith("--snapshot-budget-bytes="):
            kw["snapshot_budget_bytes"] = int(a.split("=", 1)[1])
        elif a == "--no-warm-start":
            kw["warm_start"] = False
        elif a.startswith("--"):
            raise SystemExit(f"serve: unknown flag {a}")
        else:
            addr = a
    if kw.get("device", "cuda") not in ("cuda", "cpu"):
        raise SystemExit(
            f"serve: --device must be cuda or cpu, got {kw['device']!r}")
    if metrics_path is not None and metrics_interval is None:
        raise SystemExit("serve: --metrics-path requires --metrics-interval=N")
    service = CheckService(**kw)
    if explore is not None:
        service.mount_explorer(explorer_builder(*explore), explore[0])
    host, _, port = addr.partition(":")
    server = service.http_server(host or "localhost", int(port or 3000))
    rollup = None
    if metrics_interval is not None:
        rollup = Rollup(metrics_path or DEFAULT_METRICS_PATH,
                        metrics_interval,
                        source=lambda: service.metrics).start()
    print(
        f"Resident checking service on http://{addr}, sessions on "
        f"{service.device} (POST /.check, GET /.serve/sessions, POST "
        "/.serve/trace, GET /.metrics"
        + (", Explorer UI at /" if explore is not None else "")
        + "). Connect check lanes with --connect=" + addr, flush=True)
    if threading.current_thread() is threading.main_thread():
        # a terminated daemon exits as an interrupted one does: through
        # the ``finally`` that removes its spool
        signal.signal(signal.SIGTERM, signal.default_int_handler)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if rollup is not None:
            rollup.stop()
        service.close()
    return 0


def client_main(addr: str, argv: list,
                timeout: Optional[float] = None) -> int:
    """``--connect=HOST:PORT``: ship the lane argv to the resident service
    at ``addr`` and print its report verbatim (the same report as a run
    in a process of its own, on the service's device); ``timeout`` bounds
    the request in seconds (None: as long as the check takes). Returns
    the exit status: 0 when the session is done, 1 when it failed or was
    refused, 2 when no service answered."""
    import urllib.error
    import urllib.request

    if any(a.startswith("--") for a in argv):
        print(f"--connect: {_FLAG_REFUSAL}", file=sys.stderr)
        return 2
    body = json.dumps({"argv": argv}).encode()
    req = urllib.request.Request(
        f"http://{addr}/.check", data=body,
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            resp = json.loads(r.read())
    except urllib.error.HTTPError as exc:  # a refused lane: the reason
        resp = json.loads(exc.read() or b"{}")
    except (urllib.error.URLError, OSError) as exc:
        print(f"--connect: no resident service at {addr} ({exc}); start "
              f"one with `python -m stateright_tpu_torch serve {addr}`",
              file=sys.stderr)
        return 2
    sys.stdout.write(resp.get("output") or "")
    err = resp.get("error") or (resp.get("session") or {}).get("error")
    if not resp.get("ok") and err:
        print(f"session failed: {err}", file=sys.stderr)
    return 0 if resp.get("ok") else 1
