"""Modeling user interaction / external inputs with actors.

A copy of the JAX package's ``models.interaction``. Counterpart of
reference examples/interaction.rs: a heterogeneous system — a ``Client``
that drives inputs through self-armed timers and a ``Counter`` service —
whose states do not evolve autonomously. The client's ``ClientInput``
timer sends an increment request and arms ``ClientQuery``, whose firing
asks the counter to report; a reply at or above the threshold flips
``success``.

The reference wires the two actor types through its ``choice!`` macro
(heterogeneous ``ActorModel``s need a sum type in Rust); Python actor
lists are heterogeneous natively, and
:mod:`stateright_tpu_torch.actor.choice` exists for API parity. The
space is loosely bounded (wait_cycles grows), so checking uses
``target_max_depth(30)`` exactly as interaction.rs:44 does.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..actor import Actor, ActorModel, Cow, Id, Out
from ..actor.base import model_timeout
from ..model import Expectation


@dataclass(frozen=True)
class IncrementRequest:
    n: int


@dataclass(frozen=True)
class ReportRequest:
    pass


@dataclass(frozen=True)
class ReplyCount:
    n: int


@dataclass(frozen=True)
class CounterState:
    addr: Id
    counter: int


class Counter(Actor):
    """interaction.rs Counter: increments on request, reports on ask."""

    def __init__(self, initial_state: CounterState):
        self.initial_state = initial_state

    def on_start(self, id: Id, out: Out) -> CounterState:
        return self.initial_state

    def on_msg(self, id: Id, state: Cow, src: Id, msg, out: Out) -> None:
        if isinstance(msg, IncrementRequest):
            s = state.value
            state.set(CounterState(s.addr, s.counter + msg.n))
        elif isinstance(msg, ReportRequest):
            out.send(src, ReplyCount(state.value.counter))


@dataclass(frozen=True)
class InputState:
    wait_cycles: int
    success: bool


class Client(Actor):
    """interaction.rs Client: timers drive the interaction script."""

    def __init__(self, threshold: int, counter_addr: Id):
        self.threshold = threshold
        self.counter_addr = counter_addr

    def on_start(self, id: Id, out: Out) -> InputState:
        out.set_timer("ClientInput", model_timeout())
        return InputState(wait_cycles=0, success=False)

    def on_msg(self, id: Id, state: Cow, src: Id, msg, out: Out) -> None:
        if isinstance(msg, ReplyCount) and msg.n >= self.threshold:
            s = state.value
            state.set(InputState(s.wait_cycles, True))

    def on_timeout(self, id: Id, state: Cow, timer, out: Out) -> None:
        s = state.value
        if timer == "ClientInput":
            out.set_timer("ClientQuery", model_timeout())
            out.send(self.counter_addr, IncrementRequest(3))
            state.set(InputState(s.wait_cycles + 1, s.success))
        elif timer == "ClientQuery":
            out.send(self.counter_addr, ReportRequest())
            state.set(InputState(s.wait_cycles + 1, s.success))


def interaction_model(threshold: int = 3) -> ActorModel:
    model = ActorModel()
    model.actor(Client(threshold=threshold, counter_addr=Id(1)))
    model.actor(Counter(CounterState(addr=Id(1), counter=0)))
    model.property(
        Expectation.EVENTUALLY,
        "success",
        lambda m, s: any(
            isinstance(a, InputState) and a.success for a in s.actor_states
        ),
    )
    return model
