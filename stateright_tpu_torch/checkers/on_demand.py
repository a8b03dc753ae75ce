"""On-demand checker: expands states only when asked.

A copy of the JAX package's ``checkers/on_demand.py``, with its
telemetry: ``run_to_completion`` opens and closes a trace run
(telemetry.py). It re-implements the semantics of stateright
src/checker/on_demand.rs:
a BFS variant whose frontier sits idle until the Explorer requests a
specific fingerprint (``check_fingerprint``, on_demand.rs:139-159) or
flips it into exhaustive mode (``run_to_completion``,
on_demand.rs:160-165). The reference parks worker threads on a control
channel; here the same contract is a synchronous incremental engine —
requests expand immediately, which is equivalent observable behavior
for the Explorer's HTTP API.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

from ..checker import Checker, CheckerBuilder
from ..fingerprint import fingerprint
from ..model import Expectation
from ..path import Path
from ..report import Reporter
from .common import ParentTraceMixin, symmetry_refusal


class OnDemandChecker(ParentTraceMixin, Checker):
    """``CheckerBuilder.spawn_on_demand()``."""

    def __init__(self, builder: CheckerBuilder):
        super().__init__(builder)
        if builder._symmetry is not None:
            raise symmetry_refusal("spawn_on_demand")
        self.generated: dict[int, Optional[int]] = {}
        #: fp -> (state, ebits, depth), awaiting expansion.
        self.pending: dict[int, tuple[object, int, int]] = {}
        self._order: deque[int] = deque()
        self._exhaustive = False
        self._seed_init()

    def _seed_init(self) -> None:
        ebits_init = self._eventually_bits_init()
        for init in self.model.init_states():
            if not self.model.within_boundary(init):
                continue
            fp = fingerprint(init)
            self._total_states += 1
            if fp not in self.generated:
                self.generated[fp] = None
                self.pending[fp] = (init, ebits_init, 1)
                self._order.append(fp)
        self._unique_states = len(self.generated)

    # -- Checker overrides: accessors reflect current progress ----------

    def _ensure_run(self, reporter: Optional[Reporter] = None) -> None:
        if self._exhaustive:
            self.run_to_completion()

    def is_done(self) -> bool:
        return not self.pending

    def join(self) -> "Checker":
        self.run_to_completion()
        return self

    # -- on-demand control (on_demand.rs:133-175, 403-412) ---------------

    def check_fingerprint(self, fp: int) -> None:
        """Expand the pending state with digest ``fp``, if any."""
        job = self.pending.pop(fp, None)
        if job is not None:
            state, ebits, depth = job
            self._expand(state, fp, ebits, depth)

    def run_to_completion(self) -> None:
        """Switch to exhaustive BFS (on_demand.rs:160-165).

        This engine bypasses the base ``_ensure_run`` (its accessors
        reflect incremental progress), so the trace bracket is here: an
        exhaustive pass with a tracer active opens its own run, unless
        one is open already, and a pass that drains the space sweeps
        the exhaustion verdicts as every other engine does."""
        from .. import telemetry

        self._exhaustive = True
        if self._done and not self._order:
            return  # already drained
        if self._started_at is None:
            self._started_at = time.monotonic()
        tracer = telemetry.current_tracer()
        if tracer is not None and not tracer._run_open:
            tracer.begin_run(lane=self._lane_config())
        else:
            tracer = None  # an enclosing run owns the bracket
        target_states = self.builder._target_state_count
        try:
            while self._order:
                fp = self._order.popleft()
                job = self.pending.pop(fp, None)
                if job is None:
                    continue  # already expanded via check_fingerprint
                state, ebits, depth = job
                self._expand(state, fp, ebits, depth)
                if self._all_discovered():
                    break
                if (target_states is not None
                        and self._unique_states >= target_states):
                    break
        except Exception as exc:
            # close the bracket on a model panic: an open run would take
            # every later event
            self._finished_at = time.monotonic()
            if tracer is not None:
                tracer.end_run(error=f"{type(exc).__name__}: {exc}",
                               **self._run_stats())
            raise
        self._finished_at = time.monotonic()
        self._done = not self.pending
        if tracer is not None:
            if self._done:
                self._emit_settlement_verdicts(tracer)
            tracer.end_run(error=None, **self._run_stats())

    # -- shared expansion (mirrors bfs.rs check_block) -------------------

    def _expand(self, state, fp: int, ebits: int, depth: int) -> None:
        model = self.model
        props = list(model.properties())
        self._max_depth = max(self._max_depth, depth)

        visitor = self.builder._visitor
        if visitor is not None:
            visitor.visit(
                model, Path.from_fingerprints(model, self._reconstruct_fps(fp))
            )

        for i, prop in enumerate(props):
            if prop.expectation == Expectation.ALWAYS:
                if not prop.condition(model, state):
                    self._discover(prop.name, fp, depth=depth)
            elif prop.expectation == Expectation.SOMETIMES:
                if prop.condition(model, state):
                    self._discover(prop.name, fp, depth=depth)
            else:
                if ebits & (1 << i) and prop.condition(model, state):
                    ebits &= ~(1 << i)

        target_depth = self.builder._target_max_depth
        if target_depth is not None and depth >= target_depth:
            return

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
                self.pending[next_fp] = (next_state, ebits, depth + 1)
                self._order.append(next_fp)

        if is_terminal and ebits:
            for i, prop in enumerate(props):
                if ebits & (1 << i):
                    self._discover(prop.name, fp, depth=depth)
