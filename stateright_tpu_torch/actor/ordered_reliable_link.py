"""Ordered reliable link: exactly-once in-order delivery over lossy nets.

A copy of the JAX package's ``actor.ordered_reliable_link``.
Counterpart of stateright src/actor/ordered_reliable_link.rs:32-207 —
an ``ActorWrapper`` that wraps any actor with

1. per source/destination-pair ordering,
2. resend of unacknowledged messages on a network timer, and
3. redelivery suppression via per-sender sequence numbers,

loosely based on the "perfect link" of Cachin, Guerraoui & Rodrigues,
with ordering added. Like the reference, it assumes actors do not
restart (ordered_reliable_link.rs:9-10) and does not yet forward the
wrapped actor's own timers (the reference ``todo!``s there too,
ordered_reliable_link.rs:191-196 — ours raises ``NotImplementedError``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

from ..utils import HashableMap
from .base import Actor, CancelTimer, Cow, Id, Out, Send, SetTimer, is_no_op


@dataclass(frozen=True)
class Deliver:
    """Payload carrying its sequence number (MsgWrapper::Deliver)."""

    seq: int
    msg: Any


@dataclass(frozen=True)
class Ack:
    """Acknowledgement of a sequence number (MsgWrapper::Ack)."""

    seq: int


@dataclass(frozen=True)
class NetworkTimer:
    """The resend timer (TimerWrapper::Network)."""


@dataclass(frozen=True)
class LinkState:
    """StateWrapper (ordered_reliable_link.rs:51-60)."""

    next_send_seq: int
    msgs_pending_ack: HashableMap  # seq -> (dst, msg)
    last_delivered_seqs: HashableMap  # src -> seq
    wrapped_state: Any


class OrderedReliableLink(Actor):
    """``ActorWrapper`` (ordered_reliable_link.rs:32-35)."""

    def __init__(
        self,
        wrapped_actor: Actor,
        resend_interval: Tuple[float, float] = (1.0, 2.0),
    ):
        self.wrapped_actor = wrapped_actor
        self.resend_interval = resend_interval

    def name(self) -> str:
        return self.wrapped_actor.name()

    def on_start(self, id: Id, out: Out) -> LinkState:
        out.set_timer(NetworkTimer(), self.resend_interval)
        wrapped_out = Out()
        state = LinkState(
            next_send_seq=1,
            msgs_pending_ack=HashableMap(),
            last_delivered_seqs=HashableMap(),
            wrapped_state=self.wrapped_actor.on_start(id, wrapped_out),
        )
        state, _ = _process_output(state, wrapped_out, out)
        return state

    def on_msg(self, id: Id, state: Cow, src: Id, msg: Any, out: Out) -> None:
        link: LinkState = state.value
        if isinstance(msg, Deliver):
            # Always ack to stop resends; drop if already delivered
            # (ordered_reliable_link.rs:109-121).
            out.send(src, Ack(msg.seq))
            if msg.seq <= link.last_delivered_seqs.get(src, 0):
                return
            wrapped_cow = Cow(link.wrapped_state)
            wrapped_out = Out()
            self.wrapped_actor.on_msg(id, wrapped_cow, src, msg.msg, wrapped_out)
            if is_no_op(wrapped_cow, wrapped_out):
                return
            new_link = LinkState(
                next_send_seq=link.next_send_seq,
                msgs_pending_ack=link.msgs_pending_ack,
                last_delivered_seqs=link.last_delivered_seqs.set(
                    src, msg.seq
                ),
                wrapped_state=wrapped_cow.value,
            )
            new_link, out_cmds = _process_output(new_link, wrapped_out, out)
            state.set(new_link)
        elif isinstance(msg, Ack):
            state.set(
                LinkState(
                    next_send_seq=link.next_send_seq,
                    msgs_pending_ack=link.msgs_pending_ack.remove(msg.seq),
                    last_delivered_seqs=link.last_delivered_seqs,
                    wrapped_state=link.wrapped_state,
                )
            )

    def on_timeout(self, id: Id, state: Cow, timer: Any, out: Out) -> None:
        link: LinkState = state.value
        if isinstance(timer, NetworkTimer):
            # Re-arm and resend everything unacked
            # (ordered_reliable_link.rs:157-163).
            out.set_timer(NetworkTimer(), self.resend_interval)
            for seq in sorted(link.msgs_pending_ack.keys()):
                dst, msg = link.msgs_pending_ack[seq]
                out.send(dst, Deliver(seq, msg))
        else:
            raise NotImplementedError(
                "wrapped-actor timers are not forwarded yet "
                "(ordered_reliable_link.rs:191-196 todo!)"
            )


def _process_output(
    link: LinkState, wrapped_out: Out, out: Out
) -> tuple[LinkState, None]:
    """Assign sequence numbers to the wrapped actor's sends and stage
    them for resend (ordered_reliable_link.rs:183-207)."""
    for command in wrapped_out:
        if isinstance(command, (SetTimer, CancelTimer)):
            raise NotImplementedError(
                "wrapped SetTimer/CancelTimer not supported "
                "(ordered_reliable_link.rs:191-196 todo!)"
            )
        assert isinstance(command, Send)
        seq = link.next_send_seq
        out.send(command.dst, Deliver(seq, command.msg))
        link = LinkState(
            next_send_seq=seq + 1,
            msgs_pending_ack=link.msgs_pending_ack.set(
                seq, (command.dst, command.msg)
            ),
            last_delivered_seqs=link.last_delivered_seqs,
            wrapped_state=link.wrapped_state,
        )
    return link, None
