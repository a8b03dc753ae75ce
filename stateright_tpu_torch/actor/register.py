"""Register protocol adapters: the client/server message protocol shared
by all register examples, plus consistency-history recording hooks.

A copy of the JAX package's ``actor.register``, with its
actor-compiler specs batched (:func:`register_specs`). Counterpart of
stateright
src/actor/register.rs:17-248:
``Put``/``Get`` requests with ``PutOk``/``GetOk`` responses (and
``Internal`` for the server protocol), ``record_invocations``/
``record_returns`` to feed the message stream into a consistency
tester as the model history, and ``RegisterClient`` which performs
``put_count`` puts followed by a get, rotating across servers.

Clients must be added to the model *after* servers so that server ids
can be derived as ``(client_id + k) % server_count``
(register.rs:118-120, 155).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from ..semantics.register import ReadOk, ReadOp, WriteOk, WriteOp
from .base import Actor, Cow, Id, Out
from .network import Envelope

DEFAULT_VALUE = "\x00"  # Rust's char::default()


# -- protocol messages (register.rs:17-31) ------------------------------


@dataclass(frozen=True)
class Internal:
    msg: Any


@dataclass(frozen=True)
class Put:
    req_id: int
    value: Any


@dataclass(frozen=True)
class Get:
    req_id: int


@dataclass(frozen=True)
class PutOk:
    req_id: int


@dataclass(frozen=True)
class GetOk:
    req_id: int
    value: Any


# -- history hooks (register.rs:38-91) ----------------------------------


def record_invocations(cfg: Any, history, env: Envelope):
    """``record_msg_out`` hook: Put → Write invocation, Get → Read
    invocation, keyed by the client id."""
    if isinstance(env.msg, Get):
        return history.on_invoke(env.src, ReadOp())
    if isinstance(env.msg, Put):
        return history.on_invoke(env.src, WriteOp(env.msg.value))
    return None


def record_returns(cfg: Any, history, env: Envelope):
    """``record_msg_in`` hook: GetOk → ReadOk return, PutOk → WriteOk
    return, keyed by the client id."""
    if isinstance(env.msg, GetOk):
        return history.on_return(env.dst, ReadOk(env.msg.value))
    if isinstance(env.msg, PutOk):
        return history.on_return(env.dst, WriteOk())
    return None


# -- model-checking client (register.rs:94-248) -------------------------


@dataclass(frozen=True)
class RegisterClientState:
    awaiting: Optional[int]
    op_count: int


class RegisterClient(Actor):
    """Puts ``put_count`` values then gets, round-robining servers.

    Request ids, values, and server rotation mirror the reference
    exactly (register.rs:144-236): client ``i``'s k-th request id is
    ``k * i``; the first put writes ``chr(ord('A') + i - server_count)``
    and subsequent puts write ``chr(ord('Z') - (i - server_count))``.
    """

    def __init__(self, put_count: int, server_count: int):
        self.put_count = put_count
        self.server_count = server_count

    def name(self) -> str:
        return "Client"

    def on_start(self, id: Id, out: Out) -> RegisterClientState:
        index = int(id)
        if index < self.server_count:
            raise ValueError(
                "register clients must be added to the model after servers"
            )
        if self.put_count == 0:
            return RegisterClientState(awaiting=None, op_count=0)
        req_id = index
        value = chr(ord("A") + index - self.server_count)
        out.send(Id(index % self.server_count), Put(req_id, value))
        return RegisterClientState(awaiting=req_id, op_count=1)

    def on_msg(self, id: Id, state: Cow, src: Id, msg: Any, out: Out) -> None:
        client = state.value
        if client.awaiting is None:
            return
        index = int(id)
        if isinstance(msg, PutOk) and msg.req_id == client.awaiting:
            req_id = (client.op_count + 1) * index
            if client.op_count < self.put_count:
                value = chr(ord("Z") - (index - self.server_count))
                out.send(
                    Id((index + client.op_count) % self.server_count),
                    Put(req_id, value),
                )
            else:
                out.send(
                    Id((index + client.op_count) % self.server_count),
                    Get(req_id),
                )
            state.set(
                RegisterClientState(awaiting=req_id, op_count=client.op_count + 1)
            )
        elif isinstance(msg, GetOk) and msg.req_id == client.awaiting:
            state.set(
                RegisterClientState(awaiting=None, op_count=client.op_count + 1)
            )
        # else: stale/unexpected response → no-op → pruned


@dataclass(frozen=True)
class ServerState:
    """Wrapper marking a server's state (register.rs:107-116)."""

    state: Any


class RegisterServer(Actor):
    """Wraps a server actor, delegating events (register.rs:176-273)."""

    def __init__(self, inner: Actor):
        self.inner = inner

    def name(self) -> str:
        return self.inner.name() or "Server"

    def on_start(self, id: Id, out: Out):
        return ServerState(self.inner.on_start(id, out))

    def on_msg(self, id: Id, state: Cow, src: Id, msg: Any, out: Out) -> None:
        inner_cow = Cow(state.value.state)
        self.inner.on_msg(id, inner_cow, src, msg, out)
        if inner_cow.owned:
            state.set(ServerState(inner_cow.value))

    def on_timeout(self, id: Id, state: Cow, timer: Any, out: Out) -> None:
        inner_cow = Cow(state.value.state)
        self.inner.on_timeout(id, inner_cow, timer, out)
        if inner_cow.owned:
            state.set(ServerState(inner_cow.value))



def register_specs(default_value=DEFAULT_VALUE):
    """Device property specs for the register test-actor family
    (single-copy, ABD): the standard linearizable / value-chosen pair
    every register example checks (single-copy-register.rs:73-91,
    linearizable-register.rs:243-257), as actor-compiler specs
    (actor/compile.py) usable with any register-shaped ActorModel.
    Each returns ``bool[N]`` over the batch."""

    def linearizable(ctx, xp):
        return (
            ctx.history_value(
                lambda h: int(h.serialized_history() is not None)
            )
            == 1
        )

    def value_chosen(ctx, xp):
        return ctx.network_any(
            lambda env: isinstance(env.msg, GetOk)
            and env.msg.value != default_value
        )

    return {"linearizable": linearizable, "value chosen": value_chosen}
