"""Host depth-first checker.

A copy of the JAX package's ``checkers/dfs.py``, its telemetry included
(``property_check`` and ``symmetry_canonicalization`` phase totals,
discovery verdicts and the reconstruction span, telemetry.py). It
re-implements
the reference DFS (stateright src/checker/dfs.rs): LIFO stack, visited
*set* of fingerprints (no parent pointers, dfs.rs:27), each job carrying
its full fingerprint trace for discovery reconstruction (dfs.rs:30),
and the symmetry-reduction hook — insert
``fingerprint(representative(state))`` into the visited set while
continuing the path with the *original* state (dfs.rs:300-311; the
reference's own regression test, dfs.rs:484-510: paths must stay
replayable).
"""

from __future__ import annotations

import time
from typing import Optional

from ..checker import Checker, CheckerBuilder
from ..fingerprint import fingerprint
from ..model import Expectation
from ..path import Path
from ..report import ReportData, Reporter


class DfsChecker(Checker):
    """``CheckerBuilder.spawn_dfs()``."""

    def __init__(self, builder: CheckerBuilder):
        super().__init__(builder)
        self.visited: set[int] = set()
        #: optional threading.Event: when set, _run returns early with
        #: partial results and ``cancelled`` True (the hybrid racer's
        #: losing side; see checkers/hybrid.py).
        self.cancel_event = None
        self.cancelled = False

    def _discover(self, name: str, trace: tuple[int, ...]) -> None:
        if name not in self._discoveries:
            from .. import telemetry

            # the verdict before the reconstruction: the settle moment
            prop = self.model.property_by_name(name)
            telemetry.emit("verdict", property=name,
                           expectation=prop.expectation.name.lower(),
                           kind="discovery", wave=None, depth=len(trace))
            with telemetry.span("counterexample_reconstruction",
                                property=name):
                self._discoveries[name] = Path.from_fingerprints(
                    self.model, list(trace)
                )

    def _run(self, reporter: Optional[Reporter] = None) -> None:
        from .. import telemetry

        model = self.model
        props = list(model.properties())
        ebits_init = self._eventually_bits_init()
        visitor = self.builder._visitor
        symmetry = self.builder._symmetry
        target_states = self.builder._target_state_count
        target_depth = self.builder._target_max_depth
        # per-state costs accumulate into one phase_total event apiece;
        # the shared no-op keeps the untraced loop cost-free
        tracer = telemetry.current_tracer()
        prop_acc = (tracer.phase_acc("property_check") if tracer
                    else telemetry._NULL_SPAN)
        sym_acc = (tracer.phase_acc("symmetry_canonicalization")
                   if tracer is not None and symmetry is not None
                   else telemetry._NULL_SPAN)

        def visited_key(state, fp: int) -> int:
            if symmetry is None:
                return fp
            with sym_acc:
                return fingerprint(symmetry(state))

        pending: list[tuple[object, tuple[int, ...], int]] = []
        for init in model.init_states():
            if not model.within_boundary(init):
                continue
            fp = fingerprint(init)
            self._total_states += 1
            key = visited_key(init, fp)
            if key not in self.visited:
                self.visited.add(key)
                pending.append((init, (fp,), ebits_init))
        self._unique_states = len(self.visited)

        last_report = time.monotonic()
        cancel = self.cancel_event
        while pending:
            if cancel is not None and cancel.is_set():
                self.cancelled = True
                return
            state, trace, ebits = pending.pop()
            depth = len(trace)
            self._max_depth = max(self._max_depth, depth)

            if visitor is not None:
                visitor.visit(model, Path.from_fingerprints(model, list(trace)))

            # discoveries are recorded after the timed block (the path
            # reconstruction has its own span)
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
                self._discover(name, trace)

            if self._all_discovered():
                break
            if target_states is not None and self._unique_states >= target_states:
                break
            if target_depth is not None and depth >= target_depth:
                continue

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
                key = visited_key(next_state, next_fp)
                if key not in self.visited:
                    self.visited.add(key)
                    self._unique_states += 1
                    pending.append((next_state, trace + (next_fp,), ebits))

            if is_terminal and ebits:
                for i, prop in enumerate(props):
                    if ebits & (1 << i):
                        self._discover(prop.name, trace)

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
