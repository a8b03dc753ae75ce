"""Host simulation checker: random deep traces instead of exhaustive search.

A copy of the JAX package's ``checkers/simulation.py``, with its
discovery ``verdict`` event (telemetry.py). It re-implements stateright src/checker/simulation.rs: a pluggable
``Chooser`` picks an init state and then one action per step
(simulation.rs:21-38); ``UniformChooser`` uses a seeded PRNG
(simulation.rs:50-78) with per-trace seeds derived from the base seed
(simulation.rs:114-167). Each trace runs from init until a terminal
state, a cycle (per-trace fingerprint set, simulation.rs:207, 250-261),
or the boundary. ``unique_state_count`` is approximate — it equals
``state_count`` (simulation.rs:380-384).

The device analog of this engine is N random walks in lockstep:
``CheckerBuilder.spawn_device_simulation`` (checkers/tpu_simulation.py).
"""

from __future__ import annotations

import random
import time
from typing import Optional, Protocol, Sequence

from ..checker import Checker, CheckerBuilder
from ..fingerprint import fingerprint, stable_hash
from ..model import Expectation, Model, State
from ..path import Path
from ..report import ReportData, Reporter


class Chooser(Protocol):
    """Picks init states and actions for one trace (simulation.rs:21-38)."""

    def new_trace(self, seed: int) -> "TraceChooser": ...


class TraceChooser(Protocol):
    def choose_init(self, init_states: Sequence[State]) -> State: ...

    def choose_action(self, model: Model, state: State, actions: Sequence) -> object: ...


class _UniformTrace:
    def __init__(self, seed: int):
        self._rng = random.Random(seed)

    def choose_init(self, init_states: Sequence[State]) -> State:
        return init_states[self._rng.randrange(len(init_states))]

    def choose_action(self, model: Model, state: State, actions: Sequence):
        return actions[self._rng.randrange(len(actions))]


class UniformChooser:
    """Uniform random choice with a stable seeded PRNG (simulation.rs:50-78)."""

    def new_trace(self, seed: int) -> _UniformTrace:
        return _UniformTrace(seed)


class SimulationChecker(Checker):
    """``CheckerBuilder.spawn_simulation()``."""

    def __init__(self, builder: CheckerBuilder, chooser: Chooser, seed: int):
        super().__init__(builder)
        self.chooser = chooser
        self.seed = seed

    def _run(self, reporter: Optional[Reporter] = None) -> None:
        model = self.model
        props = list(model.properties())
        ebits_init = self._eventually_bits_init()
        visitor = self.builder._visitor
        symmetry = self.builder._symmetry
        target_states = self.builder._target_state_count or 10_000
        target_depth = self.builder._target_max_depth

        init_states = [
            s for s in model.init_states() if model.within_boundary(s)
        ]
        if not init_states:
            return

        last_report = time.monotonic()
        trace_idx = 0
        while self._total_states < target_states and not self._all_discovered():
            # Per-trace seed: hash-combine of (base seed, trace index) so
            # distinct base seeds never share trace streams
            # (simulation.rs:114-167).
            trace = self.chooser.new_trace(stable_hash((self.seed, trace_idx)))
            trace_idx += 1
            state = trace.choose_init(init_states)
            steps: list[tuple[State, Optional[object]]] = []
            # Cycle detection via per-trace fingerprint set
            # (simulation.rs:207, 250-261); with symmetry enabled the
            # set holds representative digests (simulation.rs:252-256).
            seen: set[int] = set()
            ebits = ebits_init

            while True:
                fp = fingerprint(symmetry(state) if symmetry else state)
                if fp in seen:
                    # Cycle: end trace, not terminal (no eventually
                    # counterexample — same false negative as reference).
                    break
                seen.add(fp)
                self._total_states += 1
                self._max_depth = max(self._max_depth, len(seen))

                for i, prop in enumerate(props):
                    if prop.expectation == Expectation.ALWAYS:
                        if not prop.condition(model, state):
                            self._discover(prop.name, steps, state)
                    elif prop.expectation == Expectation.SOMETIMES:
                        if prop.condition(model, state):
                            self._discover(prop.name, steps, state)
                    else:
                        if ebits & (1 << i) and prop.condition(model, state):
                            ebits &= ~(1 << i)

                if self._all_discovered():
                    break
                if target_depth is not None and len(seen) >= target_depth:
                    break

                candidates = []
                for action in model.actions(state):
                    next_state = model.next_state(state, action)
                    if next_state is None:
                        continue
                    if not model.within_boundary(next_state):
                        continue
                    candidates.append((action, next_state))
                if not candidates:
                    # Terminal: surviving eventually bits are
                    # counterexamples.
                    if ebits:
                        for i, prop in enumerate(props):
                            if ebits & (1 << i):
                                self._discover(prop.name, steps, state)
                    break
                action = trace.choose_action(
                    model, state, [a for a, _ in candidates]
                )
                next_state = next(
                    s for a, s in candidates if a is action or a == action
                )
                steps.append((state, action))
                state = next_state

            if visitor is not None:
                visitor.visit(model, Path(steps + [(state, None)]))

            if reporter is not None:
                now = time.monotonic()
                if now - last_report >= reporter.delay():
                    last_report = now
                    reporter.report_checking(
                        ReportData(
                            total_states=self._total_states,
                            unique_states=self._total_states,
                            max_depth=self._max_depth,
                            duration_sec=self.duration_sec(),
                            done=False,
                        )
                    )
        # Approximate: unique == total (simulation.rs:380-384).
        self._unique_states = self._total_states

    def _discover(
        self, name: str, steps: list, final_state: State
    ) -> None:
        if name not in self._discoveries:
            from .. import telemetry

            prop = self.model.property_by_name(name)
            telemetry.emit("verdict", property=name,
                           expectation=prop.expectation.name.lower(),
                           kind="discovery", wave=None, depth=len(steps))
            self._discoveries[name] = Path(list(steps) + [(final_state, None)])
