"""``ActorModel``: compiles a system of actors into a checkable ``Model``.

A copy of the JAX package's ``actor.model``, without the Explorer's
sequence-chart rendering. Counterpart of stateright
src/actor/model.rs:23-649. The model's
actions are message deliveries (plus drops on lossy networks), timer
firings, and crashes; transitions run the actor handlers with
copy-on-write no-op detection, update the network value per its
semantics, maintain the auxiliary history through the
``record_msg_in``/``record_msg_out`` hooks, and apply emitted commands.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Iterable, Optional, Sequence

from ..model import Expectation, Model, Property
from .base import (
    Actor,
    CancelTimer,
    Cow,
    Id,
    Out,
    Send,
    SetTimer,
    is_no_op,
    is_no_op_with_timer,
)
from .model_state import ActorModelState
from .network import Envelope, Network, Ordered

# -- actions (model.rs:43-55) -------------------------------------------


@dataclass(frozen=True)
class Deliver:
    src: Id
    dst: Id
    msg: Any


@dataclass(frozen=True)
class Drop:
    envelope: Envelope


@dataclass(frozen=True)
class Timeout:
    id: Id
    timer: Any


@dataclass(frozen=True)
class Crash:
    id: Id


ActorModelAction = Any  # Deliver | Drop | Timeout | Crash


class ActorModel(Model):
    """Builder + Model implementation (model.rs:23-39, 88-178, 214-649).

    ``record_msg_in``/``record_msg_out`` hooks have signature
    ``(cfg, history, envelope) -> Optional[new_history]`` — returning
    None leaves history unchanged (model.rs:151-169).
    """

    def __init__(self, cfg: Any = None, init_history: Any = ()):
        self.actors: list[Actor] = []
        self.cfg = cfg
        self.init_history = init_history
        self._init_network: Network = Network.new_unordered_duplicating()
        self.lossy_network = False
        self.max_crashes = 0
        self._properties: list[Property] = []
        self._record_msg_in: Callable = lambda cfg, h, env: None
        self._record_msg_out: Callable = lambda cfg, h, env: None
        self._within_boundary: Callable = lambda cfg, state: True

    # -- builder (model.rs:88-178) ---------------------------------------

    def actor(self, actor: Actor) -> "ActorModel":
        self.actors.append(actor)
        return self

    def add_actors(self, actors: Iterable[Actor]) -> "ActorModel":
        self.actors.extend(actors)
        return self

    def init_network(self, network: Network) -> "ActorModel":
        self._init_network = network
        return self

    def set_lossy_network(self, lossy: bool) -> "ActorModel":
        self.lossy_network = lossy
        return self

    def set_max_crashes(self, n: int) -> "ActorModel":
        self.max_crashes = n
        return self

    def property(
        self,
        expectation: Expectation,
        name: str,
        condition: Callable[["ActorModel", ActorModelState], bool],
    ) -> "ActorModel":
        self._properties.append(Property(expectation, name, condition))
        return self

    def record_msg_in(self, hook: Callable) -> "ActorModel":
        self._record_msg_in = hook
        return self

    def record_msg_out(self, hook: Callable) -> "ActorModel":
        self._record_msg_out = hook
        return self

    def within_boundary_fn(self, hook: Callable) -> "ActorModel":
        self._within_boundary = hook
        return self

    # -- Model implementation (model.rs:214-649) -------------------------

    def init_states(self) -> Sequence[ActorModelState]:
        state = ActorModelState(
            actor_states=(),
            network=self._init_network,
            timers_set=tuple(frozenset() for _ in self.actors),
            crashed=tuple(False for _ in self.actors),
            history=self.init_history,
        )
        for index, actor in enumerate(self.actors):
            out = Out()
            actor_state = actor.on_start(Id(index), out)
            state = replace(
                state, actor_states=state.actor_states + (actor_state,)
            )
            state = self._process_commands(Id(index), out, state)
        return [state]

    def actions(self, state: ActorModelState) -> Sequence[ActorModelAction]:
        actions: list[ActorModelAction] = []
        is_ordered = isinstance(self._init_network, Ordered)
        prev_channel = None
        for env in state.network.iter_deliverable():
            # Option 1: message is lost (model.rs:246-249).
            if self.lossy_network:
                actions.append(Drop(env))
            # Option 2: message is delivered; ordered networks deliver
            # only channel heads (model.rs:252-266).
            if int(env.dst) < len(self.actors):
                if is_ordered:
                    channel = (env.src, env.dst)
                    if prev_channel == channel:
                        continue
                    prev_channel = channel
                actions.append(Deliver(env.src, env.dst, env.msg))
        # Option 3: timer fires (model.rs:270-274).
        for index, timers in enumerate(state.timers_set):
            for timer in sorted(timers, key=repr):
                actions.append(Timeout(Id(index), timer))
        # Option 4: crash (model.rs:277-285).
        n_crashed = sum(state.crashed)
        if n_crashed < self.max_crashes:
            for index, crashed in enumerate(state.crashed):
                if not crashed:
                    actions.append(Crash(Id(index)))
        return actions

    def next_state(
        self, state: ActorModelState, action: ActorModelAction
    ) -> Optional[ActorModelState]:
        if isinstance(action, Drop):
            return replace(state, network=state.network.on_drop(action.envelope))

        if isinstance(action, Deliver):
            index = int(action.dst)
            if index >= len(state.actor_states):
                return None
            if state.crashed[index]:
                return None  # model.rs:307-309
            cow = Cow(state.actor_states[index])
            out = Out()
            self.actors[index].on_msg(
                Id(index), cow, action.src, action.msg, out
            )
            is_ordered = isinstance(self._init_network, Ordered)
            if is_no_op(cow, out) and not is_ordered:
                return None  # prune (model.rs:317-319)
            env = Envelope(action.src, action.dst, action.msg)
            history = self._record_msg_in(self.cfg, state.history, env)
            next_state = replace(state, network=state.network.on_deliver(env))
            if cow.owned:
                next_state = next_state.with_actor_state(index, cow.value)
            if history is not None:
                next_state = replace(next_state, history=history)
            return self._process_commands(Id(index), out, next_state)

        if isinstance(action, Timeout):
            index = int(action.id)
            cow = Cow(state.actor_states[index])
            out = Out()
            self.actors[index].on_timeout(Id(index), cow, action.timer, out)
            if is_no_op_with_timer(cow, out, action.timer):
                return None  # model.rs:358-360
            # The fired timer is no longer set (model.rs:364).
            next_state = state.with_timers(
                index, state.timers_set[index] - {action.timer}
            )
            if cow.owned:
                next_state = next_state.with_actor_state(index, cow.value)
            return self._process_commands(Id(index), out, next_state)

        if isinstance(action, Crash):
            index = int(action.id)
            next_state = state.with_timers(index, frozenset())
            crashed = (
                next_state.crashed[:index] + (True,) + next_state.crashed[index + 1:]
            )
            return replace(next_state, crashed=crashed)

        raise TypeError(f"unknown action {action!r}")

    def properties(self) -> Sequence[Property]:
        return list(self._properties)

    def within_boundary(self, state: ActorModelState) -> bool:
        return self._within_boundary(self.cfg, state)

    def format_action(self, action: ActorModelAction) -> str:
        if isinstance(action, Deliver):
            return f"{action.src!r} → {action.msg!r} → {action.dst!r}"
        return repr(action)

    def as_svg(self, path) -> Optional[str]:
        """Render the path as a message sequence chart (the Explorer's
        per-state diagram; counterpart of model.rs:476-640).

        One vertical lifeline per actor; each step row shows its
        action: Deliver as an arrow from the sender's lifeline at the
        step where the envelope first appeared in the network, Timeout
        and Crash as labeled marks on the affected lifeline.
        """
        from html import escape

        steps = path.steps
        states = [s for s, _ in steps]
        actions = [a for _, a in steps if a is not None]
        n_actors = len(states[0].actor_states)
        names = [
            f"{i} {a.name()}".strip() for i, a in enumerate(self.actors)
        ]
        spacing = max(100, 10 * max((len(n) for n in names), default=0))
        row_h = 30

        def x(actor: int) -> int:
            return actor * spacing

        def y(row: int) -> int:
            return row * row_h

        rows = len(actions) + 1
        width = x(n_actors) + 300
        height = y(rows) + 40
        out = [
            f"<svg version='1.1' baseProfile='full' width='{width}' "
            f"height='{height}' viewBox='-20 -20 {width + 20} "
            f"{height + 20}' xmlns='http://www.w3.org/2000/svg'>",
            "<defs><marker class='svg-event-shape' id='arrow' "
            "markerWidth='12' markerHeight='10' refX='12' refY='5' "
            "orient='auto'><polygon points='0 0, 12 5, 0 10' /></marker>"
            "</defs>",
        ]
        for i, name in enumerate(names):
            out.append(
                f"<line x1='{x(i)}' y1='{y(0)}' x2='{x(i)}' "
                f"y2='{y(rows)}' class='svg-actor-timeline' "
                "stroke='#aaa' />"
            )
            out.append(
                f"<text x='{x(i)}' y='{y(0) - 5}' "
                f"class='svg-actor-label'>{escape(name)}</text>"
            )

        def send_row(env: Envelope, deliver_row: int) -> int:
            # The arrow starts where the envelope first existed.
            for row in range(deliver_row, -1, -1):
                if env not in set(states[row].network.iter_all()):
                    return row + 1
            return 0

        for row, action in enumerate(actions, start=1):
            if isinstance(action, Deliver):
                env = Envelope(action.src, action.dst, action.msg)
                src_row = send_row(env, row - 1)
                out.append(
                    f"<line x1='{x(int(action.src))}' y1='{y(src_row)}' "
                    f"x2='{x(int(action.dst))}' y2='{y(row)}' "
                    "marker-end='url(#arrow)' class='svg-event-line' "
                    "stroke='#333' />"
                )
                out.append(
                    f"<text x='{x(int(action.dst)) + 6}' y='{y(row) - 4}' "
                    f"class='svg-event-label'>{escape(repr(action.msg))}"
                    "</text>"
                )
            elif isinstance(action, Timeout):
                out.append(
                    f"<circle cx='{x(int(action.id))}' cy='{y(row)}' "
                    "r='4' class='svg-event-shape' />"
                )
                out.append(
                    f"<text x='{x(int(action.id)) + 6}' y='{y(row) - 4}' "
                    f"class='svg-event-label'>timeout "
                    f"{escape(repr(action.timer))}</text>"
                )
            elif isinstance(action, Crash):
                out.append(
                    f"<text x='{x(int(action.id)) - 5}' y='{y(row)}' "
                    "class='svg-event-shape'>✗</text>"
                )
            elif isinstance(action, Drop):
                env = action.envelope
                out.append(
                    f"<text x='{x(int(env.src)) + 6}' y='{y(row) - 4}' "
                    f"class='svg-event-label'>drop "
                    f"{escape(repr(env.msg))}</text>"
                )
        out.append("</svg>")
        return "".join(out)

    # -- internals -------------------------------------------------------

    def _process_commands(
        self, id: Id, out: Out, state: ActorModelState
    ) -> ActorModelState:
        """Apply emitted commands: sends (with history recording) and
        timer arm/cancel (model.rs:181-211)."""
        index = int(id)
        for command in out.commands:
            if isinstance(command, Send):
                env = Envelope(id, command.dst, command.msg)
                history = self._record_msg_out(self.cfg, state.history, env)
                if history is not None:
                    state = replace(state, history=history)
                state = replace(state, network=state.network.send(env))
            elif isinstance(command, SetTimer):
                state = state.with_timers(
                    index, state.timers_set[index] | {command.timer}
                )
            elif isinstance(command, CancelTimer):
                state = state.with_timers(
                    index, state.timers_set[index] - {command.timer}
                )
            else:
                raise TypeError(f"unknown command {command!r}")
        return state
