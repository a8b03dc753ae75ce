"""Actor-model two-phase commit — the COMPILED 2pc encoding's source.

A copy of the JAX package's ``models.two_phase_commit_actors``, with
its device specs batched for the port's actor compiler. The flagship
2pc workload (models/two_phase_commit.py) is a plain ``Model`` with a
hand-written device encoding, which the actor→encoding compiler
(actor/compile.py) can't see. This module reformulates the protocol as
actors so 2pc joins the compiled path:

* each RM arms two timers at start: ``prepare`` (WORKING → PREPARED,
  announce to the TM) and ``abort`` (WORKING → ABORTED silently) — the
  two spontaneous RM actions of the TLA+ original;
* the TM tallies ``Prepared`` announcements and holds two timers:
  ``commit`` fires only when every RM has prepared (broadcast
  ``Commit``), re-arming itself otherwise (the re-arm-only firing is
  pruned by ``is_no_op_with_timer``, so the option stays open at zero
  state-space cost), and ``abort`` (broadcast ``Abort``) while
  undecided;
* RMs obey the decision: ``Commit`` lands only on PREPARED rows,
  ``Abort`` on anything undecided.

``two_phase_actor_model`` is NOT count-comparable to ``TwoPhaseSys``:
message passing is explicit there, so the spaces differ by
construction. ``two_phase_sys_actor_model`` is: over the unordered
duplicating network its space bijects with ``TwoPhaseSys``'s state for
state (288 / 1,568 / 8,832 / 50,816 / 296,448 at rm=3..7). Both models
are history-free (``init_history=None``), which exercises the
compiler's history-table sentinel (a ``None`` history value is a
harvested value, not a missing one).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..actor import Actor, ActorModel, Cow, Id, Network, Out
from ..actor.base import model_timeout
from ..model import Expectation

#: RM local states (int-encoded: actor domains stay tiny and the
#: device property specs compare codes directly).
RM_WORKING, RM_PREPARED, RM_ABORTED, RM_COMMITTED = 0, 1, 2, 3
#: TM phase codes (TM local state is ``(phase, prepared_bitmask)``).
TM_INIT, TM_COMMITTED, TM_ABORTED = 0, 1, 2


@dataclass(frozen=True)
class Prepared:
    rm: int


@dataclass(frozen=True)
class Commit:
    pass


@dataclass(frozen=True)
class Abort:
    pass


class RmActor(Actor):
    """One resource manager: spontaneous prepare/abort via timers,
    decision messages from the TM."""

    def __init__(self, tm_id: Id, index: int):
        self.tm_id = tm_id
        self.index = index

    def on_start(self, id: Id, out: Out) -> int:
        out.set_timer("prepare", model_timeout())
        out.set_timer("abort", model_timeout())
        return RM_WORKING

    def on_timeout(self, id: Id, state: Cow, timer, out: Out) -> None:
        s = state.value
        if timer == "prepare" and s == RM_WORKING:
            out.send(self.tm_id, Prepared(self.index))
            state.set(RM_PREPARED)
        elif timer == "abort" and s == RM_WORKING:
            state.set(RM_ABORTED)
        # decided states: plain no-op, pruned

    def on_msg(self, id: Id, state: Cow, src: Id, msg, out: Out) -> None:
        s = state.value
        if isinstance(msg, Commit) and s == RM_PREPARED:
            state.set(RM_COMMITTED)
        elif isinstance(msg, Abort) and s in (RM_WORKING, RM_PREPARED):
            state.set(RM_ABORTED)


class TmActor(Actor):
    """The transaction manager: tallies Prepared, decides by timer."""

    def __init__(self, rm_ids: list[Id]):
        self.rm_ids = rm_ids

    def on_start(self, id: Id, out: Out):
        out.set_timer("commit", model_timeout())
        out.set_timer("abort", model_timeout())
        return (TM_INIT, 0)

    def on_msg(self, id: Id, state: Cow, src: Id, msg, out: Out) -> None:
        tm, mask = state.value
        if isinstance(msg, Prepared) and tm == TM_INIT:
            state.set((tm, mask | (1 << msg.rm)))

    def on_timeout(self, id: Id, state: Cow, timer, out: Out) -> None:
        tm, mask = state.value
        full = (1 << len(self.rm_ids)) - 1
        if timer == "commit":
            if tm == TM_INIT and mask == full:
                out.broadcast(self.rm_ids, Commit())
                state.set((TM_COMMITTED, mask))
            else:
                # keep the commit option armed; the re-arm-only firing
                # is pruned (is_no_op_with_timer)
                out.set_timer("commit", model_timeout())
        elif timer == "abort" and tm == TM_INIT:
            out.broadcast(self.rm_ids, Abort())
            state.set((TM_ABORTED, mask))


def two_phase_actor_model(rm_count: int) -> ActorModel:
    """``rm_count`` RM actors (ids 0..rm_count-1) + the TM (last id).
    ``cfg`` is the RM count, so host properties can slice
    ``actor_states[:cfg]``."""
    tm = Id(rm_count)
    model = ActorModel(cfg=rm_count, init_history=None)
    model.add_actors(RmActor(tm, i) for i in range(rm_count))
    model = model.actor(TmActor([Id(i) for i in range(rm_count)]))
    return (
        model.init_network(Network.new_unordered_nonduplicating())
        .property(
            Expectation.ALWAYS,
            "consistent",
            lambda m, s: not (
                any(x == RM_ABORTED for x in s.actor_states[: m.cfg])
                and any(
                    x == RM_COMMITTED for x in s.actor_states[: m.cfg]
                )
            ),
        )
        .property(
            Expectation.SOMETIMES,
            "all commit",
            lambda m, s: all(
                x == RM_COMMITTED for x in s.actor_states[: m.cfg]
            ),
        )
        .property(
            Expectation.SOMETIMES,
            "some abort",
            lambda m, s: any(
                x == RM_ABORTED for x in s.actor_states[: m.cfg]
            ),
        )
    )


class SysRmActor(Actor):
    """Resource manager of the COUNT-COMPARABLE reformulation (see
    ``two_phase_sys_actor_model``): the timers are armed exactly while
    WORKING and every transition out of WORKING cancels both, so the
    timer bits are a function of the RM state and add no states."""

    def __init__(self, tm_id: Id, index: int):
        self.tm_id = tm_id
        self.index = index

    def on_start(self, id: Id, out: Out) -> int:
        out.set_timer("prepare", model_timeout())
        out.set_timer("abort", model_timeout())
        return RM_WORKING

    def on_timeout(self, id: Id, state: Cow, timer, out: Out) -> None:
        s = state.value
        if timer == "prepare" and s == RM_WORKING:
            # rm_prepare: the Prepared announcement IS the plain
            # model's ("prepared", rm) bag entry (dup network: the
            # envelope bit is never consumed)
            out.send(self.tm_id, Prepared(self.index))
            out.cancel_timer("abort")
            state.set(RM_PREPARED)
        elif timer == "abort" and s == RM_WORKING:
            # rm_choose_abort: silent
            out.cancel_timer("prepare")
            state.set(RM_ABORTED)

    def on_msg(self, id: Id, state: Cow, src: Id, msg, out: Out) -> None:
        s = state.value
        # rm_rcv_commit / rm_rcv_abort fire from ANY undecided state
        # in the plain model; the self-loops at the target state are
        # pruned no-ops there and here
        if isinstance(msg, Commit) and s != RM_COMMITTED:
            if s == RM_WORKING:
                out.cancel_timer("prepare")
                out.cancel_timer("abort")
            state.set(RM_COMMITTED)
        elif isinstance(msg, Abort) and s != RM_ABORTED:
            if s == RM_WORKING:
                out.cancel_timer("prepare")
                out.cancel_timer("abort")
            state.set(RM_ABORTED)


class SysTmActor(Actor):
    """Transaction manager of the count-comparable reformulation: the
    ``(phase, prepared-mask)`` local state mirrors the plain model's
    ``(tm_state, tm_prepared)`` exactly; decision timers are armed
    exactly while INIT."""

    def __init__(self, rm_ids: list[Id]):
        self.rm_ids = rm_ids

    def on_start(self, id: Id, out: Out):
        out.set_timer("commit", model_timeout())
        out.set_timer("abort", model_timeout())
        return (TM_INIT, 0)

    def on_msg(self, id: Id, state: Cow, src: Id, msg, out: Out) -> None:
        tm, mask = state.value
        if isinstance(msg, Prepared) and tm == TM_INIT:
            # tm_rcv_prepared: unconditional set — when the bit is
            # already up this is the plain model's self-loop (Cow.set
            # marks owned, so the transition exists and dedups away)
            state.set((tm, mask | (1 << msg.rm)))

    def on_timeout(self, id: Id, state: Cow, timer, out: Out) -> None:
        tm, mask = state.value
        full = (1 << len(self.rm_ids)) - 1
        if timer == "commit":
            if tm == TM_INIT and mask == full:
                # tm_commit: the atomic broadcast is the single
                # ("commit",) bag entry — all envelope bits rise
                # together and are never consumed, one bit of info
                out.broadcast(self.rm_ids, Commit())
                out.cancel_timer("abort")
                state.set((TM_COMMITTED, mask))
            else:
                out.set_timer("commit", model_timeout())
        elif timer == "abort" and tm == TM_INIT:
            # tm_abort
            out.broadcast(self.rm_ids, Abort())
            out.cancel_timer("commit")
            state.set((TM_ABORTED, mask))


def two_phase_sys_actor_model(rm_count: int) -> ActorModel:
    """The COUNT-COMPARABLE actor reformulation of ``TwoPhaseSys``:
    over the UNORDERED DUPLICATING
    network the compiled state space bijects with the plain model's —
    ``(rm_state*, tm_state, tm_prepared)`` map to the local states,
    the append-only ``msgs`` bag maps to the never-consumed envelope
    presence bits, and the timer bits are functions of the local
    states — so the pinned counts (288 / 1,568 / 8,832 / 50,816 /
    296,448 at rm=3..7) reproduce bit-identically and the hand
    encoding serves as a differential ORACLE for the compiled path.
    Property names match the plain model's so verdicts compare by
    name."""
    tm = Id(rm_count)
    model = ActorModel(cfg=rm_count, init_history=None)
    model.add_actors(SysRmActor(tm, i) for i in range(rm_count))
    model = model.actor(SysTmActor([Id(i) for i in range(rm_count)]))
    return (
        model.init_network(Network.new_unordered_duplicating())
        .property(
            Expectation.SOMETIMES,
            "abort agreement",
            lambda m, s: all(
                x == RM_ABORTED for x in s.actor_states[: m.cfg]
            ),
        )
        .property(
            Expectation.SOMETIMES,
            "commit agreement",
            lambda m, s: all(
                x == RM_COMMITTED for x in s.actor_states[: m.cfg]
            ),
        )
        .property(
            Expectation.ALWAYS,
            "consistent",
            lambda m, s: not (
                any(x == RM_ABORTED for x in s.actor_states[: m.cfg])
                and any(
                    x == RM_COMMITTED for x in s.actor_states[: m.cfg]
                )
            ),
        )
    )


def two_phase_sys_device_specs(rm_count: int) -> dict:
    """Device property specs for ``two_phase_sys_actor_model`` — same
    predicates as the plain model, evaluated over the RM actor codes
    (``[rm_count, N]``, reduced over ``dim=0``)."""

    def rm_codes(ctx):
        return ctx.actor_values(
            lambda i, s: s if i < rm_count else 0
        )[:rm_count]

    def abort_agreement(ctx, xp):
        return (rm_codes(ctx) == RM_ABORTED).all(dim=0)

    def commit_agreement(ctx, xp):
        return (rm_codes(ctx) == RM_COMMITTED).all(dim=0)

    def consistent(ctx, xp):
        v = rm_codes(ctx)
        return ~(
            (v == RM_ABORTED).any(dim=0) & (v == RM_COMMITTED).any(dim=0)
        )

    return dict(
        properties={
            "abort agreement": abort_agreement,
            "commit agreement": commit_agreement,
            "consistent": consistent,
        }
    )


def two_phase_sys_compiled_encoded(rm_count: int, **kw):
    """One-call compiled encoding of the count-comparable model
    (overapprox closure: the tiny per-actor domains need no host
    exploration at any rm count)."""
    from ..actor.compile import compile_actor_model

    return compile_actor_model(
        two_phase_sys_actor_model(rm_count),
        **two_phase_sys_device_specs(rm_count),
        **kw,
    )


def two_phase_actor_device_specs(rm_count: int) -> dict:
    """Device property specs for ``compile_actor_model`` — the exact
    counterparts of the host properties above (the compiler requires a
    spec per host property), over ``[rm_count, N]`` RM codes."""

    def rm_codes(ctx):
        # per-actor state code; the TM (last actor, tuple-state
        # domain) maps to 0 and is sliced off
        return ctx.actor_values(
            lambda i, s: s if i < rm_count else 0
        )[:rm_count]

    def consistent(ctx, xp):
        v = rm_codes(ctx)
        return ~(
            (v == RM_ABORTED).any(dim=0) & (v == RM_COMMITTED).any(dim=0)
        )

    def all_commit(ctx, xp):
        return (rm_codes(ctx) == RM_COMMITTED).all(dim=0)

    def some_abort(ctx, xp):
        return (rm_codes(ctx) == RM_ABORTED).any(dim=0)

    return dict(
        properties={
            "consistent": consistent,
            "all commit": all_commit,
            "some abort": some_abort,
        }
    )
