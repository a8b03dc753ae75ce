"""Host breadth-first checker — the host correctness oracle.

A copy of the JAX package's ``checkers/bfs.py``, its telemetry
included (a ``property_check`` phase total, discovery verdicts and the
reconstruction span, telemetry.py). It re-implements
the semantics of the reference's parallel BFS
(stateright src/checker/bfs.rs): FIFO frontier, fingerprint-keyed
visited map storing child→parent digests for path reconstruction
(bfs.rs:28-29, 371-400), per-path ``EventuallyBits`` with the documented
revisit false-negative (bfs.rs:285-303), terminal-state eventually
counterexamples (bfs.rs:317-324), and early exit once every property
has a discovery or the state target is reached (bfs.rs:128-145).

``CheckerBuilder.threads(n)`` spawns n worker threads over a shared
pending deque in blocks of 1,500 states — the reference's work-share
granularity (bfs.rs:124, job_market.rs:66-147). The model callbacks
(actions/next_state/properties) run outside the lock; dedup, counter
updates, and discovery recording apply under it, so counts are exact
and the discovered property SET matches the sequential run (which
state discovers a property first can differ between runs — the same
race the reference's worker threads have). CPython's GIL means the
speedup is real only where the model's callbacks release it (C-backed
hashing, numpy); on pure-Python models threads(n) is parity, not
speed — the device wave engines are this framework's parallelism
story (:mod:`stateright_tpu_torch.checkers.tpu`).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from ..checker import Checker, CheckerBuilder
from ..fingerprint import fingerprint
from ..model import Expectation
from ..path import Path
from ..report import ReportData, Reporter
from .common import ParentTraceMixin, symmetry_refusal

#: states handed to a worker per lock acquisition (bfs.rs:124).
JOB_BLOCK = 1500


class BfsChecker(ParentTraceMixin, Checker):
    """``CheckerBuilder.spawn_bfs()``."""

    def __init__(self, builder: CheckerBuilder):
        super().__init__(builder)
        if builder._symmetry is not None:
            raise symmetry_refusal("spawn_bfs")
        #: child fingerprint -> parent fingerprint (None for init states);
        #: the complete parent-pointer forest (bfs.rs:28-29).
        self.generated: dict[int, Optional[int]] = {}

    def _run(self, reporter: Optional[Reporter] = None) -> None:
        from .. import telemetry

        model = self.model
        props = list(model.properties())
        ebits_init = self._eventually_bits_init()
        visitor = self.builder._visitor
        target_states = self.builder._target_state_count
        target_depth = self.builder._target_max_depth
        # property evaluation runs once a popped state, so it accumulates
        # into one phase_total event; the shared no-op keeps the untraced
        # loop cost-free
        tracer = telemetry.current_tracer()
        prop_acc = (tracer.phase_acc("property_check") if tracer
                    else telemetry._NULL_SPAN)

        pending: deque[tuple[object, int, int, int]] = deque()
        for init in model.init_states():
            if not model.within_boundary(init):
                continue
            fp = fingerprint(init)
            self._total_states += 1
            if fp not in self.generated:
                self.generated[fp] = None
                pending.append((init, fp, ebits_init, 1))
        self._unique_states = len(self.generated)

        if self.builder._threads > 1:
            self._run_parallel(pending, reporter)
            return

        last_report = time.monotonic()
        while pending:
            state, fp, ebits, depth = pending.popleft()
            self._max_depth = max(self._max_depth, depth)

            if visitor is not None:
                visitor.visit(
                    model, Path.from_fingerprints(model, self._reconstruct_fps(fp))
                )

            # Property evaluation on the popped state (bfs.rs:223-268).
            # Discoveries are recorded after the timed block: the path
            # reconstruction has its own span.
            hit = []
            with prop_acc:
                for i, prop in enumerate(props):
                    if prop.expectation == Expectation.ALWAYS:
                        if not prop.condition(model, state):
                            hit.append(prop.name)
                    elif prop.expectation == Expectation.SOMETIMES:
                        if prop.condition(model, state):
                            hit.append(prop.name)
                    else:  # EVENTUALLY
                        if ebits & (1 << i) and prop.condition(model, state):
                            ebits &= ~(1 << i)
            for name in hit:
                self._discover(name, fp, depth=depth)

            if self._all_discovered():
                break
            if target_states is not None and self._unique_states >= target_states:
                break

            # Depth bound: do not expand further (bfs.rs:210-215); a
            # depth-cut state is not "terminal" for eventually purposes.
            if target_depth is not None and depth >= target_depth:
                continue

            # Expansion (bfs.rs:275-316).
            is_terminal = True
            for action in model.actions(state):
                next_state = model.next_state(state, action)
                if next_state is None:
                    continue
                if not model.within_boundary(next_state):
                    continue
                is_terminal = False
                next_fp = fingerprint(next_state)
                self._total_states += 1
                if next_fp not in self.generated:
                    self.generated[next_fp] = fp
                    self._unique_states += 1
                    pending.append((next_state, next_fp, ebits, depth + 1))
                # else: ebits dropped on revisit — reproduces the
                # documented false negative (bfs.rs:285-303).

            # Terminal state: surviving eventually-bits are
            # counterexamples (bfs.rs:317-324).
            if is_terminal and ebits:
                for i, prop in enumerate(props):
                    if ebits & (1 << i):
                        self._discover(prop.name, fp, depth=depth)

            if reporter is not None:
                now = time.monotonic()
                if now - last_report >= reporter.delay():
                    last_report = now
                    reporter.report_checking(
                        ReportData(
                            total_states=self._total_states,
                            unique_states=self._unique_states,
                            max_depth=self._max_depth,
                            duration_sec=self.duration_sec(),
                            done=False,
                        )
                    )

    # -- worker-pool variant (threads(n), bfs.rs + job_market.rs) --------

    def _run_parallel(
        self, pending: deque, reporter: Optional[Reporter]
    ) -> None:
        """N workers over the shared pending deque in JOB_BLOCK
        chunks: model callbacks run outside the lock, dedup /
        counters / discovery recording under it. Early exit
        (all-discovered, target_state_count) is approximate by up to
        the blocks in flight — the same slack the reference's
        work-sharing has (checker.rs "approximately", bfs.rs:128-145).
        """
        model = self.model
        props = list(model.properties())
        target_states = self.builder._target_state_count
        target_depth = self.builder._target_max_depth
        visitor = self.builder._visitor

        cv = threading.Condition()
        run = {"active": 0, "stop": False}
        errors: list = []

        def evaluate(job):
            """One job's model callbacks; touches NO shared state
            (reads of self.generated for the visitor are safe: CPython
            dict reads are atomic under the GIL and parents of a
            popped state are never re-written)."""
            state, fp, ebits, depth = job
            discovered = []
            for i, prop in enumerate(props):
                if prop.expectation == Expectation.ALWAYS:
                    if not prop.condition(model, state):
                        discovered.append(prop.name)
                elif prop.expectation == Expectation.SOMETIMES:
                    if prop.condition(model, state):
                        discovered.append(prop.name)
                else:  # EVENTUALLY
                    if ebits & (1 << i) and prop.condition(model, state):
                        ebits &= ~(1 << i)
            if visitor is not None:
                visitor.visit(
                    model,
                    Path.from_fingerprints(
                        model, self._reconstruct_fps(fp)
                    ),
                )
            succs = []
            is_terminal = True
            if target_depth is None or depth < target_depth:
                for action in model.actions(state):
                    next_state = model.next_state(state, action)
                    if next_state is None:
                        continue
                    if not model.within_boundary(next_state):
                        continue
                    is_terminal = False
                    succs.append((next_state, fingerprint(next_state)))
            else:
                is_terminal = False  # depth-cut, not terminal
            term_evt = (
                [
                    prop.name
                    for i, prop in enumerate(props)
                    if ebits & (1 << i)
                ]
                if is_terminal and ebits
                else []
            )
            return fp, ebits, depth, discovered, succs, term_evt

        def worker():
            while True:
                with cv:
                    while (
                        not pending
                        and run["active"] > 0
                        and not run["stop"]
                    ):
                        cv.wait(0.05)
                    if run["stop"] or (
                        not pending and run["active"] == 0
                    ):
                        cv.notify_all()
                        return
                    block = [
                        pending.popleft()
                        for _ in range(min(JOB_BLOCK, len(pending)))
                    ]
                    run["active"] += 1
                try:
                    results = [evaluate(j) for j in block]
                except Exception as exc:  # propagate model panics
                    with cv:
                        errors.append(exc)
                        run["stop"] = True
                        run["active"] -= 1
                        cv.notify_all()
                    return
                with cv:
                    for fp, ebits, depth, disc, succs, term in results:
                        self._max_depth = max(self._max_depth, depth)
                        for name in disc:
                            self._discover(name, fp, depth=depth)
                        for next_state, next_fp in succs:
                            self._total_states += 1
                            if next_fp not in self.generated:
                                self.generated[next_fp] = fp
                                self._unique_states += 1
                                pending.append(
                                    (next_state, next_fp, ebits,
                                     depth + 1)
                                )
                        for name in term:
                            self._discover(name, fp, depth=depth)
                    if self._all_discovered() or (
                        target_states is not None
                        and self._unique_states >= target_states
                    ):
                        run["stop"] = True
                    run["active"] -= 1
                    cv.notify_all()

        workers = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.builder._threads)
        ]
        for t in workers:
            t.start()
        delay = reporter.delay() if reporter is not None else 0.5
        while any(t.is_alive() for t in workers):
            # One deadline per report cycle (joining every worker with
            # the full delay would stretch the cadence to
            # n_threads × delay).
            deadline = time.monotonic() + max(delay, 0.05)
            for t in workers:
                t.join(timeout=max(deadline - time.monotonic(), 0.01))
            if reporter is not None and any(
                t.is_alive() for t in workers
            ):
                with cv:
                    data = ReportData(
                        total_states=self._total_states,
                        unique_states=self._unique_states,
                        max_depth=self._max_depth,
                        duration_sec=self.duration_sec(),
                        done=False,
                    )
                reporter.report_checking(data)
        if errors:
            raise errors[0]
