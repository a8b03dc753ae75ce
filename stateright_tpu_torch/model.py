"""The core ``Model`` abstraction and temporal properties.

A copy of the JAX package's host ``model`` module (the port imports
nothing of that package), cut to what the sort-merge slice uses. A
model describes a nondeterministic state machine via ``init_states`` /
``actions`` / ``next_state`` plus temporal ``properties``
(stateright src/lib.rs:156-255). The host model is the semantic ground
truth: the device engine replays it to turn discovery fingerprints into
paths.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Optional, Sequence

State = Any
Action = Any


class Expectation(Enum):
    """How a property is expected to hold (src/lib.rs:319-326)."""

    #: Holds in every reachable state; a violating state is a counterexample.
    ALWAYS = "always"
    #: Holds in at least one reachable state; such a state is an example.
    SOMETIMES = "sometimes"
    #: Holds at some point along every path; a terminal path that never
    #: satisfied it is a counterexample.
    EVENTUALLY = "eventually"


@dataclass(frozen=True)
class Property:
    """A named temporal property over model states (src/lib.rs:262-326)."""

    expectation: Expectation
    name: str
    condition: Callable[["Model", State], bool]

    @staticmethod
    def always(name: str, condition: Callable[["Model", State], bool]) -> "Property":
        return Property(Expectation.ALWAYS, name, condition)

    @staticmethod
    def sometimes(name: str, condition: Callable[["Model", State], bool]) -> "Property":
        return Property(Expectation.SOMETIMES, name, condition)

    @staticmethod
    def eventually(name: str, condition: Callable[["Model", State], bool]) -> "Property":
        return Property(Expectation.EVENTUALLY, name, condition)


class Model:
    """A nondeterministic state machine with temporal properties.

    Subclasses implement ``init_states``, ``actions``, ``next_state``
    and ``properties`` (src/lib.rs:156-255).
    """

    def init_states(self) -> Sequence[State]:
        raise NotImplementedError

    def actions(self, state: State) -> Sequence[Action]:
        raise NotImplementedError

    def next_state(self, state: State, action: Action) -> Optional[State]:
        raise NotImplementedError

    def properties(self) -> Sequence[Property]:
        return []

    def within_boundary(self, state: State) -> bool:
        """Bounded-exploration hook (src/lib.rs:243-245)."""
        return True

    def format_action(self, action: Action) -> str:
        return str(action)

    def format_step(self, last_state: State, action: Action) -> Optional[str]:
        """The outcome of ``action`` the Explorer shows: the next state's
        repr, or None where the action is ignored."""
        next_state = self.next_state(last_state, action)
        return None if next_state is None else repr(next_state)

    def as_svg(self, path: Any) -> Optional[str]:
        """Optional visualization of a path for the Explorer."""
        return None

    def next_steps(self, state: State) -> list[tuple[Action, State]]:
        """(action, successor) pairs of ``state`` (src/lib.rs
        next_steps)."""
        steps = []
        for action in self.actions(state):
            next_state = self.next_state(state, action)
            if next_state is not None:
                steps.append((action, next_state))
        return steps

    def next_states(self, state: State) -> list[State]:
        return [s for _, s in self.next_steps(state)]

    def property_by_name(self, name: str) -> Property:
        for prop in self.properties():
            if prop.name == name:
                return prop
        raise KeyError(f"no property named {name!r}")

    def checker(self) -> "CheckerBuilder":
        """Entry point to model checking (src/lib.rs:248-254)."""
        from .checker import CheckerBuilder

        return CheckerBuilder(self)
