"""The ``Actor`` abstraction: message-driven state machines.

A copy of the JAX package's ``actor.base``. Counterpart of stateright
src/actor.rs:108-341. An actor initializes state in ``on_start`` and
reacts to messages (``on_msg``) and timers (``on_timeout``), reading
its state through a copy-on-write handle and emitting
:class:`Command`s through an :class:`Out` buffer; it is model-checked
by :mod:`stateright_tpu_torch.actor.model`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Tuple

Msg = Any
Timer = Any


class Id(int):
    """An actor identifier (src/actor.rs:108-156).

    In a model it is the actor's index; at runtime it packs an
    IPv4 address + port (``Id.from_addr`` / ``to_addr``) exactly like
    the reference's ``u64`` packing (spawn.rs:10-34).
    """

    def __repr__(self) -> str:
        return f"Id({int(self)})"

    @staticmethod
    def from_addr(ip: str, port: int) -> "Id":
        packed = 0
        for part in ip.split("."):
            packed = (packed << 8) | int(part)
        return Id((packed << 16) | port)

    def to_addr(self) -> Tuple[str, int]:
        port = int(self) & 0xFFFF
        packed = int(self) >> 16
        ip = ".".join(str((packed >> shift) & 0xFF) for shift in (24, 16, 8, 0))
        return ip, port


@dataclass(frozen=True)
class Send:
    """Command: send ``msg`` to ``dst`` (src/actor.rs:159-243)."""

    dst: Id
    msg: Msg


@dataclass(frozen=True)
class SetTimer:
    """Command: arm a named timer. The duration range matters only at
    runtime; model checking abstracts it away (actor/timers.rs:7-44)."""

    timer: Timer
    min_sec: float = 0.0
    max_sec: float = 0.0


@dataclass(frozen=True)
class CancelTimer:
    timer: Timer


Command = Any  # Send | SetTimer | CancelTimer


def model_timeout() -> Tuple[float, float]:
    """Arbitrary timeout range for model checking (model.rs:69-71)."""
    return (0.0, 0.0)


def model_peers(self_ix: int, count: int) -> list[Id]:
    """All other actor ids in a ``count``-actor system (model.rs:75-80)."""
    return [Id(j) for j in range(count) if j != self_ix]


def majority(count: int) -> int:
    """Minimum majority size (src/actor.rs:552-554)."""
    return count // 2 + 1


class Out:
    """Buffer of commands an actor emits while handling an event
    (src/actor.rs:159-243)."""

    __slots__ = ("commands",)

    def __init__(self):
        self.commands: list[Command] = []

    def send(self, dst: Id, msg: Msg) -> None:
        self.commands.append(Send(Id(dst), msg))

    def broadcast(self, dsts: Iterable[Id], msg: Msg) -> None:
        """Send to every id in ``dsts`` (src/actor.rs:208-215)."""
        for dst in dsts:
            self.send(dst, msg)

    def set_timer(self, timer: Timer, duration_range: Tuple[float, float]) -> None:
        lo, hi = duration_range
        self.commands.append(SetTimer(timer, lo, hi))

    def cancel_timer(self, timer: Timer) -> None:
        self.commands.append(CancelTimer(timer))

    def append(self, other: "Out") -> None:
        self.commands.extend(other.commands)
        other.commands.clear()

    def __iter__(self):
        return iter(self.commands)

    def __len__(self) -> int:
        return len(self.commands)


class Cow:
    """Copy-on-write state handle (Rust ``Cow<State>`` analog,
    src/actor.rs:247-264).

    Handlers read ``state.value`` and replace it with ``state.set(new)``.
    Whether ``set`` was called is the "owned" bit used for no-op
    detection — a handler that neither sets state nor emits commands
    produces no transition, pruning the state space (model.rs:317-319).
    """

    __slots__ = ("value", "owned")

    def __init__(self, value: Any):
        self.value = value
        self.owned = False

    def set(self, new_value: Any) -> None:
        self.value = new_value
        self.owned = True


def is_no_op(state: Cow, out: Out) -> bool:
    """True iff the handler neither updated state nor emitted commands
    (src/actor.rs:247-249)."""
    return not state.owned and not out.commands


def is_no_op_with_timer(state: Cow, out: Out, timer: Timer) -> bool:
    """True iff the handler only re-armed the same timer
    (src/actor.rs:254-264)."""
    if state.owned:
        return False
    return len(out.commands) == 1 and (
        isinstance(out.commands[0], SetTimer) and out.commands[0].timer == timer
    )


class Actor:
    """A message-driven state machine (src/actor.rs:270-341)."""

    def on_start(self, id: Id, out: Out) -> Any:
        """Return the initial state, optionally emitting commands."""
        raise NotImplementedError

    def on_msg(self, id: Id, state: Cow, src: Id, msg: Msg, out: Out) -> None:
        pass

    def on_timeout(self, id: Id, state: Cow, timer: Timer, out: Out) -> None:
        pass

    def name(self) -> str:
        return type(self).__name__
