"""Heterogeneous actor composition.

A copy of the JAX package's ``actor.choice``. Counterpart of stateright
src/actor.rs:343-549. The reference needs the ``Choice<A1, A2>``
machinery because Rust's ``ActorModel`` is generic over a single actor
type; this framework's ``ActorModel`` holds a plain list of
:class:`~stateright_tpu_torch.actor.Actor` objects, so heterogeneous
systems work natively. ``Choice`` is still provided for API parity — and
because tagging states as L/R keeps *state types* disjoint the way the
reference's enum does, which matters when two actor kinds share a state
representation.

Also provides :class:`ScriptedActor`, the ``Vec<(Id, Msg)>`` scripted
client (actor.rs:515-549): it sends a fixed message sequence, advancing
on every delivery — useful for driving systems under test.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence, Tuple

from .base import Actor, Cow, Id, Out


@dataclass(frozen=True)
class L:
    """Left-variant state tag (actor.rs Choice::L)."""

    state: Any


@dataclass(frozen=True)
class R:
    """Right-variant state tag (actor.rs Choice::R)."""

    state: Any


class Choice(Actor):
    """One of two actor kinds, with tagged state (actor.rs:402-497)."""

    def __init__(self, actor: Actor, right: bool = False):
        self.actor = actor
        self.right = right

    @staticmethod
    def left(actor: Actor) -> "Choice":
        return Choice(actor, right=False)

    @staticmethod
    def right_of(actor: Actor) -> "Choice":
        return Choice(actor, right=True)

    def _tag(self, state: Any) -> Any:
        return R(state) if self.right else L(state)

    def name(self) -> str:
        return self.actor.name()

    def on_start(self, id: Id, out: Out) -> Any:
        return self._tag(self.actor.on_start(id, out))

    def on_msg(self, id: Id, state: Cow, src: Id, msg: Any, out: Out) -> None:
        inner = Cow(state.value.state)
        self.actor.on_msg(id, inner, src, msg, out)
        if inner.owned:
            state.set(self._tag(inner.value))

    def on_timeout(self, id: Id, state: Cow, timer: Any, out: Out) -> None:
        inner = Cow(state.value.state)
        self.actor.on_timeout(id, inner, timer, out)
        if inner.owned:
            state.set(self._tag(inner.value))


class ScriptedActor(Actor):
    """Sends ``script[i]`` messages in order, one per received message
    (actor.rs:515-549). State = next script index."""

    def __init__(self, script: Sequence[Tuple[Id, Any]]):
        self.script = list(script)

    def name(self) -> str:
        return ""

    def on_start(self, id: Id, out: Out) -> int:
        if self.script:
            dst, msg = self.script[0]
            out.send(dst, msg)
            return 1
        return 0

    def on_msg(self, id: Id, state: Cow, src: Id, msg: Any, out: Out) -> None:
        index = state.value
        if index < len(self.script):
            dst, next_msg = self.script[index]
            out.send(dst, next_msg)
            state.set(index + 1)
