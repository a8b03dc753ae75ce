"""Checker visitors: callbacks over every evaluated state's path.

A copy of the JAX package's ``visitor`` module (stateright
src/checker/visitor.rs:19-111: ``CheckerVisitor``, ``PathRecorder``,
``StateRecorder``). Plain callables are accepted wherever a visitor is,
matching the reference's closure impl.
"""

from __future__ import annotations

from typing import Callable, Optional, Protocol, runtime_checkable

from .model import Model, State
from .path import Path


@runtime_checkable
class CheckerVisitor(Protocol):
    def visit(self, model: Model, path: Path) -> None: ...


class FnVisitor:
    """Wrap a plain callable as a visitor (visitor.rs:27-31)."""

    def __init__(self, fn: Callable[[Model, Path], None]):
        self._fn = fn

    def visit(self, model: Model, path: Path) -> None:
        self._fn(model, path)


def as_visitor(v) -> Optional[CheckerVisitor]:
    if v is None:
        return None
    if callable(v) and not hasattr(v, "visit"):
        return FnVisitor(v)
    return v


class PathRecorder:
    """Records the set of all visited paths (visitor.rs:47-73).

    Doubles as a replayability oracle in tests: ``Path.from_fingerprints``
    raises on unreplayable traces, which is how symmetry-reduction bugs
    surface (reference dfs.rs:559-563).
    """

    def __init__(self):
        self.paths: set[Path] = set()

    def visit(self, model: Model, path: Path) -> None:
        self.paths.add(path)


class StateRecorder:
    """Records the final state of each visited path (visitor.rs:87-111)."""

    def __init__(self):
        self.states: list[State] = []

    def visit(self, model: Model, path: Path) -> None:
        self.states.append(path.last_state())
