"""Ping-pong actor fixture with all five property flavors.

A copy of the JAX package's ``models.ping_pong``, with its device specs
batched for the port's actor compiler. Counterpart of stateright
src/actor/actor_test_util.rs:4-126: two actors volley an incrementing
counter; the model exercises lossy /
duplicating networks, history recording, boundaries, and properties of
every expectation. Reference-pinned state counts (actor/model.rs:688,
847, 887): lossy-dup max_nat=1 → 14; lossy-dup max_nat=5 → 4,094;
lossless-nondup max_nat=5 → 11.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..model import Expectation
from ..actor import Actor, ActorModel, Cow, Id, Out


@dataclass(frozen=True)
class Ping:
    value: int


@dataclass(frozen=True)
class Pong:
    value: int


class PingPongActor(Actor):
    def __init__(self, serve_to: Id | None):
        self.serve_to = serve_to

    def on_start(self, id: Id, out: Out) -> int:
        if self.serve_to is not None:
            out.send(self.serve_to, Ping(0))
        return 0

    def on_msg(self, id: Id, state: Cow, src: Id, msg, out: Out) -> None:
        count = state.value
        if isinstance(msg, Pong) and count == msg.value:
            out.send(src, Ping(msg.value + 1))
            state.set(count + 1)
        elif isinstance(msg, Ping) and count == msg.value:
            out.send(src, Pong(msg.value))
            state.set(count + 1)
        # else: ignored → no-op → transition pruned


@dataclass(frozen=True)
class PingPongCfg:
    maintains_history: bool = False
    max_nat: int = 5


def ping_pong_model(cfg: PingPongCfg) -> ActorModel:
    """History = (#messages in, #messages out) when maintained."""

    def record_in(c: PingPongCfg, history, env):
        if c.maintains_history:
            msg_in, msg_out = history
            return (msg_in + 1, msg_out)
        return None

    def record_out(c: PingPongCfg, history, env):
        if c.maintains_history:
            msg_in, msg_out = history
            return (msg_in, msg_out + 1)
        return None

    return (
        ActorModel(cfg=cfg, init_history=(0, 0))
        .actor(PingPongActor(serve_to=Id(1)))
        .actor(PingPongActor(serve_to=None))
        .record_msg_in(record_in)
        .record_msg_out(record_out)
        .within_boundary_fn(
            lambda c, state: all(count <= c.max_nat for count in state.actor_states)
        )
        .property(
            Expectation.ALWAYS,
            "delta within 1",
            lambda m, s: max(s.actor_states) - min(s.actor_states) <= 1,
        )
        .property(
            Expectation.SOMETIMES,
            "can reach max",
            lambda m, s: any(c == m.cfg.max_nat for c in s.actor_states),
        )
        .property(
            Expectation.EVENTUALLY,
            "must reach max",
            lambda m, s: any(c == m.cfg.max_nat for c in s.actor_states),
        )
        .property(
            # Falsifiable due to the boundary.
            Expectation.EVENTUALLY,
            "must exceed max",
            lambda m, s: any(c == m.cfg.max_nat + 1 for c in s.actor_states),
        )
        .property(
            Expectation.ALWAYS,
            "#in <= #out",
            lambda m, s: s.history[0] <= s.history[1],
        )
        .property(
            Expectation.EVENTUALLY,
            "#out <= #in + 1",
            lambda m, s: s.history[1] <= s.history[0] + 1,
        )
    )


def ping_pong_device_specs(cfg: PingPongCfg) -> dict:
    """Device property/boundary specs for ``compile_actor_model`` —
    the device counterparts of every host property above, plus the
    boundary and closure bounds. Each spec returns ``bool[N]``; the
    per-actor counts are ``[2, N]`` and reduce over ``dim=0``."""
    counts = lambda ctx: ctx.actor_values(lambda i, s: s)  # noqa: E731

    def delta_within_1(ctx, xp):
        c = counts(ctx)
        return c.max(dim=0).values - c.min(dim=0).values <= 1

    def in_le_out(ctx, xp):
        return ctx.history_value(lambda h: int(h[0] <= h[1])) == 1

    def out_le_in1(ctx, xp):
        return ctx.history_value(lambda h: int(h[1] <= h[0] + 1)) == 1

    return dict(
        properties={
            "delta within 1": delta_within_1,
            "can reach max": lambda ctx, xp: (
                counts(ctx) == cfg.max_nat
            ).any(dim=0),
            "must reach max": lambda ctx, xp: (
                counts(ctx) == cfg.max_nat
            ).any(dim=0),
            "must exceed max": lambda ctx, xp: (
                counts(ctx) == cfg.max_nat + 1
            ).any(dim=0),
            "#in <= #out": in_le_out,
            "#out <= #in + 1": out_le_in1,
        },
        boundary=lambda ctx, xp: (counts(ctx) <= cfg.max_nat).all(dim=0),
        closure_actor_bound=lambda i, s: s <= cfg.max_nat,
        # History counters only advance on non-no-op deliveries, which
        # the actor-state bound caps at max_nat+1 per actor; beyond
        # that the (in, out) pairs only occur outside the boundary.
        closure_history_bound=lambda h: max(h) <= 2 * (cfg.max_nat + 2),
    )
