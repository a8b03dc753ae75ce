"""Actor framework: model-checkable message-driven state machines.

A copy of the JAX package's ``actor`` package (reference src/actor.rs
and src/actor/*), cut to what the Paxos and compiled lanes use: the
``Actor`` protocol, the ``ActorModel`` bridge into the checkable
``Model`` protocol, the network semantics, the register client/server
(``actor/register.py``) and the actor→encoding compiler
(``actor/compile.py``). Not ported yet: ``choice``,
``ordered_reliable_link``, ``spawn`` (the UDP runtime) and
``write_once_register``.
"""

from .base import (
    Actor,
    CancelTimer,
    Command,
    Cow,
    Id,
    Out,
    Send,
    SetTimer,
    is_no_op,
    is_no_op_with_timer,
    majority,
    model_peers,
    model_timeout,
)
from .network import Envelope, Network, Ordered, UnorderedDuplicating, UnorderedNonDuplicating
from .model import ActorModel, ActorModelAction, Crash, Deliver, Drop, Timeout
from .model_state import ActorModelState

__all__ = [
    "Actor",
    "ActorModel",
    "ActorModelAction",
    "ActorModelState",
    "CancelTimer",
    "Command",
    "Cow",
    "Crash",
    "Deliver",
    "Drop",
    "Envelope",
    "Id",
    "Network",
    "Ordered",
    "Out",
    "Send",
    "SetTimer",
    "Timeout",
    "UnorderedDuplicating",
    "UnorderedNonDuplicating",
    "is_no_op",
    "is_no_op_with_timer",
    "majority",
    "model_peers",
    "model_timeout",
]
