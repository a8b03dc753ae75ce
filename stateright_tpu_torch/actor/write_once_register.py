"""Write-once-register protocol adapters.

A copy of the JAX package's ``actor.write_once_register``. Counterpart
of stateright src/actor/write_once_register.rs:16-331: the register
client/server protocol extended with ``PutFail`` (a rejected write —
write-once semantics), history hooks feeding a ``ConsistencyTester``
over :class:`~stateright_tpu_torch.semantics.WORegister`, and the
model-checking client that puts then gets, treating PutFail like PutOk
for sequencing (write_once_register.rs:246-265).

``Put``/``Get``/``PutOk``/``GetOk``/``Internal`` are shared with the
plain register protocol (actor/register.py); only ``PutFail`` is new.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..semantics.register import ReadOk, ReadOp, WriteOk, WriteOp
from ..semantics.write_once_register import WriteFail
from .base import Actor, Cow, Id, Out
from .network import Envelope
from .register import Get, GetOk, Internal, Put, PutOk, RegisterClientState

__all__ = [
    "Put",
    "Get",
    "PutOk",
    "PutFail",
    "GetOk",
    "Internal",
    "record_invocations",
    "record_returns",
    "WORegisterClient",
    "WORegisterServer",
]


@dataclass(frozen=True)
class PutFail:
    """An unsuccessful Put (write_once_register.rs:27-28)."""

    req_id: int


def record_invocations(cfg: Any, history, env: Envelope):
    """``record_msg_out`` hook (write_once_register.rs:39-62)."""
    if isinstance(env.msg, Get):
        return history.on_invoke(env.src, ReadOp())
    if isinstance(env.msg, Put):
        return history.on_invoke(env.src, WriteOp(env.msg.value))
    return None


def record_returns(cfg: Any, history, env: Envelope):
    """``record_msg_in`` hook, including WriteFail for PutFail
    (write_once_register.rs:68-97)."""
    if isinstance(env.msg, GetOk):
        return history.on_return(env.dst, ReadOk(env.msg.value))
    if isinstance(env.msg, PutOk):
        return history.on_return(env.dst, WriteOk())
    if isinstance(env.msg, PutFail):
        return history.on_return(env.dst, WriteFail())
    return None


class WORegisterClient(Actor):
    """Puts ``put_count`` values then gets; a rejected put (PutFail)
    advances the sequence just like a successful one
    (write_once_register.rs:100-273)."""

    def __init__(self, put_count: int, server_count: int):
        self.put_count = put_count
        self.server_count = server_count

    def name(self) -> str:
        return "Client"

    def on_start(self, id: Id, out: Out) -> RegisterClientState:
        index = int(id)
        if index < self.server_count:
            raise ValueError(
                "WO-register clients must be added to the model after servers"
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
        if (
            isinstance(msg, (PutOk, PutFail))
            and msg.req_id == client.awaiting
        ):
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
                RegisterClientState(
                    awaiting=req_id, op_count=client.op_count + 1
                )
            )
        elif isinstance(msg, GetOk) and msg.req_id == client.awaiting:
            state.set(
                RegisterClientState(
                    awaiting=None, op_count=client.op_count + 1
                )
            )


class WORegisterServer(Actor):
    """Wraps a server actor, delegating events
    (write_once_register.rs:275-296 server arm)."""

    def __init__(self, inner: Actor):
        self.inner = inner

    def name(self) -> str:
        return self.inner.name() or "Server"

    def on_start(self, id: Id, out: Out):
        return self.inner.on_start(id, out)

    def on_msg(self, id: Id, state: Cow, src: Id, msg: Any, out: Out) -> None:
        self.inner.on_msg(id, state, src, msg, out)

    def on_timeout(self, id: Id, state: Cow, timer: Any, out: Out) -> None:
        self.inner.on_timeout(id, state, timer, out)
