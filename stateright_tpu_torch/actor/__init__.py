"""Actor framework: model-checkable message-driven state machines.

A copy of the JAX package's ``actor`` package (reference src/actor.rs
and src/actor/*): the ``Actor`` protocol, the ``ActorModel`` bridge into
the checkable ``Model`` protocol, the network semantics, timers,
crash/loss fault injection, the register client/server
(``actor/register.py``), the adapters (``choice``,
``ordered_reliable_link``, ``write_once_register``), a real UDP runtime
for the same actor code (``spawn``) and the actor→encoding compiler
(``actor/compile.py``).
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
from .choice import Choice, ScriptedActor
from .ordered_reliable_link import OrderedReliableLink

__all__ = [
    "Actor",
    "ActorModel",
    "ActorModelAction",
    "ActorModelState",
    "CancelTimer",
    "Choice",
    "OrderedReliableLink",
    "ScriptedActor",
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
