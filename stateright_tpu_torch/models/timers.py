"""The pinger/timer workload: the dedicated timer-semantics example.

A copy of the JAX package's ``models.timers``. Counterpart of reference
examples/timers.rs: each of N pingers arms three named timers at start.
``Even``/``Odd`` timers re-arm themselves and ping the even-/odd-indexed
peers (counting sends); ``NoOp`` re-arms itself and does nothing else —
which is exactly the ``is_no_op_with_timer`` pruning case
(actor.rs:254-264): a handler that only re-arms the fired timer produces
no transition.

The state space is unbounded (send/receive counters grow), as in the
reference, whose CLI runs it without a boundary; tests bound it with
``target_max_depth``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..actor import Actor, ActorModel, Cow, Id, Network, Out, model_peers
from ..actor.base import model_timeout
from ..model import Expectation


@dataclass(frozen=True)
class Ping:
    pass


@dataclass(frozen=True)
class Pong:
    pass


@dataclass(frozen=True)
class PingerState:
    sent: int
    received: int


class PingerActor(Actor):
    """timers.rs PingerActor: Even/Odd/NoOp self-re-arming timers."""

    def __init__(self, peer_ids: list[Id]):
        self.peer_ids = peer_ids

    def on_start(self, id: Id, out: Out) -> PingerState:
        out.set_timer("Even", model_timeout())
        out.set_timer("Odd", model_timeout())
        out.set_timer("NoOp", model_timeout())
        return PingerState(sent=0, received=0)

    def on_msg(self, id: Id, state: Cow, src: Id, msg, out: Out) -> None:
        if isinstance(msg, Ping):
            out.send(src, Pong())
        elif isinstance(msg, Pong):
            s = state.value
            state.set(PingerState(s.sent, s.received + 1))

    def on_timeout(self, id: Id, state: Cow, timer, out: Out) -> None:
        if timer == "Even":
            out.set_timer("Even", model_timeout())
            s = state.value
            for dst in self.peer_ids:
                if int(dst) % 2 == 0:
                    s = PingerState(s.sent + 1, s.received)
                    out.send(dst, Ping())
            if s is not state.value:
                state.set(s)
        elif timer == "Odd":
            out.set_timer("Odd", model_timeout())
            s = state.value
            for dst in self.peer_ids:
                if int(dst) % 2 != 0:
                    s = PingerState(s.sent + 1, s.received)
                    out.send(dst, Ping())
            if s is not state.value:
                state.set(s)
        elif timer == "NoOp":
            # Re-arming ONLY the fired timer is a no-op transition
            # (actor.rs:254-264) — pruned by the model.
            out.set_timer("NoOp", model_timeout())


@dataclass(frozen=True)
class PingerModelCfg:
    server_count: int = 3


def pinger_model(
    cfg: PingerModelCfg, network: Network | None = None
) -> ActorModel:
    if network is None:
        network = Network.new_unordered_nonduplicating()
    model = ActorModel(cfg=cfg)
    for i in range(cfg.server_count):
        model.actor(PingerActor(model_peers(i, cfg.server_count)))
    model.init_network(network)
    # timers.rs:112 checks the trivially-true invariant.
    model.property(Expectation.ALWAYS, "true", lambda m, s: True)
    return model


def pinger_compiled(cfg: PingerModelCfg, depth: int):
    """The pinger compiled for the wave engines (actor/compile.py), for a
    run bounded by ``target_max_depth(depth)``: ``(model, encoding)``.

    The space is unbounded, so the component closure is bounded by the
    actor counters: a step raises one pinger's ``sent + received`` by at
    most ``server_count - 1`` (a timer pings every even or every odd
    peer). A run to ``depth`` expands only the first ``depth - 1``
    levels (the last is evaluated, not expanded), and there each
    pinger's sum is at most ``(depth - 2) * (server_count - 1)``: that
    is the bound. The closure still keeps the successors of those
    states, the last level's. A run deeper than the bound covers
    expands a state the closure left unexpanded, and the engines raise
    the truncation error. Not in the JAX package, which compiles the
    pinger in its tests only.
    """
    from ..actor.compile import compile_actor_model

    model = pinger_model(cfg)
    bound = max(0, depth - 2) * max(1, cfg.server_count - 1)
    encoded = compile_actor_model(
        model,
        properties={"true": lambda ctx, xp: True},
        closure_actor_bound=lambda i, s: s.sent + s.received <= bound,
    )
    return model, encoded
