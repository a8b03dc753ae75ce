"""Shared toy-model fixtures for tests and docs.

A copy of the JAX package's ``fixtures`` module, with the same class and
field names, so host fingerprints and ``Path.encode()`` agree.
Counterparts of the reference's test fixtures
(stateright src/test_util.rs): ``LinearEquation`` (test_util.rs:140-192,
the standard checker fixture), ``BinaryClock`` (test_util.rs:4-47),
``DGraph`` (test_util.rs:50-116, the eventually-semantics fixture), and
``Panicker`` (test_util.rs:195-228, error-propagation fixture).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from .model import Model, Property


@dataclass
class LinearEquation(Model):
    """Find nonneg u8 solutions to ``a*x + b*y == c`` by brute search.

    States are ``(x, y)`` pairs of wrapping 8-bit counters starting at
    ``(0, 0)``; actions increment x or y. The full space is 256*256 =
    65,536 unique states (pinned by the reference, bfs.rs:443).
    """

    a: int
    b: int
    c: int

    def init_states(self):
        return [(0, 0)]

    def actions(self, state):
        return ["IncX", "IncY"]

    def next_state(self, state, action):
        x, y = state
        if action == "IncX":
            return ((x + 1) % 256, y)
        if action == "IncY":
            return (x, (y + 1) % 256)
        return None

    def properties(self):
        return [
            Property.sometimes(
                "solvable",
                lambda m, s: (m.a * s[0] + m.b * s[1]) % 256 == m.c % 256,
            )
        ]


class BinaryClock(Model):
    """Two-state clock: ticks alternate 0/1 (test_util.rs:4-47)."""

    def init_states(self):
        return [0, 1]

    def actions(self, state):
        return ["Tick"]

    def next_state(self, state, action):
        return 1 - state

    def properties(self):
        return [
            Property.always("in bounds", lambda m, s: s in (0, 1)),
            Property.sometimes("can be zero", lambda m, s: s == 0),
        ]


class DGraph(Model):
    """An arbitrary digraph, the eventually-semantics fixture
    (test_util.rs:50-116).

    Build with ``DGraph.with_path([1, 2, 3])`` etc.; attach properties
    with ``.property(...)``.
    """

    def __init__(self):
        self._inits: list[int] = []
        self._edges: dict[int, list[int]] = {}
        self._props: list[Property] = []

    @staticmethod
    def with_path(path: Sequence[int]) -> "DGraph":
        return DGraph().path(path)

    def path(self, path: Sequence[int]) -> "DGraph":
        if not path:
            return self
        if path[0] not in self._inits:
            self._inits.append(path[0])
        for a, b in zip(path, path[1:]):
            succs = self._edges.setdefault(a, [])
            if b not in succs:
                succs.append(b)
        return self

    def node(self, n: int) -> "DGraph":
        if n not in self._inits:
            self._inits.append(n)
        return self

    def property(self, prop: Property) -> "DGraph":
        self._props.append(prop)
        return self

    def init_states(self):
        return list(self._inits)

    def actions(self, state):
        return list(self._edges.get(state, []))

    def next_state(self, state, action):
        return action if action in self._edges.get(state, []) else None

    def properties(self):
        return list(self._props)


class PanickerError(RuntimeError):
    pass


class Panicker(Model):
    """Raises while expanding state 1 — error-propagation fixture
    (test_util.rs:195-228)."""

    def init_states(self):
        return [0]

    def actions(self, state):
        return ["Step"]

    def next_state(self, state, action):
        if state == 1:
            raise PanickerError("boom")
        return state + 1

    def properties(self):
        return [Property.always("under 10", lambda m, s: s < 10)]
