"""Single-decree Paxos serving a linearizable register.

A copy of the JAX package's ``models.paxos``; the actor-compiler specs
(``paxos_device_specs``, ``paxos_compiled_encoded``) are batched for
the port's compiler. Counterpart of stateright examples/paxos.rs: each
Put starts a new ballot (phase 1 prepare/prepared, phase 2
accept/accepted, then a decided broadcast); Gets answer only once
decided. Checked against linearizability with 2 clients / 3 servers =
16,668 unique states (reference-pinned, paxos.rs:325, 349).

The vectorized encoding the wave engine runs lives in
:mod:`stateright_tpu_torch.models.paxos_tpu`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional, Tuple

from ..model import Expectation
from ..actor import (
    Actor,
    ActorModel,
    Cow,
    Id,
    Network,
    Out,
    majority,
    model_peers,
)
from ..actor.register import (
    DEFAULT_VALUE,
    Get,
    GetOk,
    Internal,
    Put,
    PutOk,
    RegisterClient,
    RegisterServer,
    record_invocations,
    record_returns,
)
from ..semantics import LinearizabilityTester, Register
from ..utils import HashableMap, HashableSet

# Ballot = (round, leader_id); Proposal = (req_id, requester_id, value).


@dataclass(frozen=True)
class Prepare:
    ballot: Tuple


@dataclass(frozen=True)
class Prepared:
    ballot: Tuple
    last_accepted: Optional[Tuple]  # None | (ballot, proposal)


@dataclass(frozen=True)
class Accept:
    ballot: Tuple
    proposal: Tuple


@dataclass(frozen=True)
class Accepted:
    ballot: Tuple


@dataclass(frozen=True)
class Decided:
    ballot: Tuple
    proposal: Tuple


@dataclass(frozen=True)
class PaxosState:
    ballot: Tuple
    proposal: Optional[Tuple]
    prepares: HashableMap  # Id -> Optional[(ballot, proposal)]
    accepts: HashableSet  # set of Ids
    accepted: Optional[Tuple]  # None | (ballot, proposal)
    is_decided: bool


def _accepted_sort_key(last_accepted: Optional[Tuple]):
    # Rust Option ordering: None < Some; Some by (ballot, proposal).
    return (0,) if last_accepted is None else (1,) + last_accepted


class PaxosActor(Actor):
    def __init__(self, peer_ids: list[Id]):
        self.peer_ids = peer_ids

    def name(self) -> str:
        return "Paxos Server"

    def on_start(self, id: Id, out: Out) -> PaxosState:
        return PaxosState(
            ballot=(0, Id(0)),
            proposal=None,
            prepares=HashableMap(),
            accepts=HashableSet(),
            accepted=None,
            is_decided=False,
        )

    def on_msg(self, id: Id, cow: Cow, src: Id, msg: Any, out: Out) -> None:
        state: PaxosState = cow.value
        if state.is_decided:
            if isinstance(msg, Get):
                # Reply only when decided; stay silent otherwise — a
                # value might have been decided elsewhere
                # (paxos.rs:142-155).
                _ballot, (_req, _src, value) = state.accepted
                out.send(src, GetOk(msg.req_id, value))
            return

        if isinstance(msg, Put) and state.proposal is None:
            ballot = (state.ballot[0] + 1, id)
            # Simulate Prepare + Prepared self-sends (paxos.rs:160-176).
            cow.set(
                replace(
                    state,
                    proposal=(msg.req_id, src, msg.value),
                    prepares=HashableMap({id: state.accepted}),
                    accepts=HashableSet(),
                    ballot=ballot,
                )
            )
            out.broadcast(self.peer_ids, Internal(Prepare(ballot)))

        elif isinstance(msg, Internal) and isinstance(msg.msg, Prepare):
            if state.ballot < msg.msg.ballot:
                cow.set(replace(state, ballot=msg.msg.ballot))
                out.send(
                    src,
                    Internal(Prepared(msg.msg.ballot, state.accepted)),
                )

        elif isinstance(msg, Internal) and isinstance(msg.msg, Prepared):
            if msg.msg.ballot == state.ballot:
                prepares = state.prepares.set(src, msg.msg.last_accepted)
                new_state = replace(state, prepares=prepares)
                if len(prepares) == majority(len(self.peer_ids) + 1):
                    # Leadership handoff: drive the most recently
                    # accepted proposal if any (paxos.rs:188-221).
                    best = max(
                        prepares.values(), key=_accepted_sort_key
                    )
                    proposal = (
                        best[1] if best is not None else state.proposal
                    )
                    ballot = state.ballot
                    new_state = replace(
                        new_state,
                        proposal=proposal,
                        accepted=(ballot, proposal),
                        accepts=HashableSet([id]),
                    )
                    out.broadcast(
                        self.peer_ids, Internal(Accept(ballot, proposal))
                    )
                cow.set(new_state)

        elif isinstance(msg, Internal) and isinstance(msg.msg, Accept):
            if state.ballot <= msg.msg.ballot:
                cow.set(
                    replace(
                        state,
                        ballot=msg.msg.ballot,
                        accepted=(msg.msg.ballot, msg.msg.proposal),
                    )
                )
                out.send(src, Internal(Accepted(msg.msg.ballot)))

        elif isinstance(msg, Internal) and isinstance(msg.msg, Accepted):
            if msg.msg.ballot == state.ballot:
                accepts = state.accepts.add(src)
                new_state = replace(state, accepts=accepts)
                if len(accepts) == majority(len(self.peer_ids) + 1):
                    proposal = state.proposal
                    new_state = replace(new_state, is_decided=True)
                    out.broadcast(
                        self.peer_ids,
                        Internal(Decided(state.ballot, proposal)),
                    )
                    req_id, requester_id, _value = proposal
                    out.send(requester_id, PutOk(req_id))
                cow.set(new_state)

        elif isinstance(msg, Internal) and isinstance(msg.msg, Decided):
            cow.set(
                replace(
                    state,
                    ballot=msg.msg.ballot,
                    accepted=(msg.msg.ballot, msg.msg.proposal),
                    is_decided=True,
                )
            )
        # else: ignored → no-op → pruned


@dataclass(frozen=True)
class PaxosModelCfg:
    client_count: int = 2
    server_count: int = 3
    put_count: int = 1


def paxos_model(cfg: PaxosModelCfg, network: Network | None = None) -> ActorModel:
    if network is None:
        network = Network.new_unordered_nonduplicating()

    def value_chosen(model: ActorModel, state) -> bool:
        for env in state.network.iter_deliverable():
            if isinstance(env.msg, GetOk) and env.msg.value != DEFAULT_VALUE:
                return True
        return False

    model = ActorModel(
        cfg=cfg, init_history=LinearizabilityTester(Register(DEFAULT_VALUE))
    )

    def to_encoded():
        from .paxos_tpu import PaxosEncoded

        return PaxosEncoded(cfg, network)

    model.to_encoded = to_encoded
    model.add_actors(
        RegisterServer(PaxosActor(model_peers(i, cfg.server_count)))
        for i in range(cfg.server_count)
    )
    model.add_actors(
        RegisterClient(put_count=cfg.put_count, server_count=cfg.server_count)
        for _ in range(cfg.client_count)
    )
    return (
        model.init_network(network)
        .property(
            Expectation.ALWAYS,
            "linearizable",
            lambda m, s: s.history.serialized_history() is not None,
        )
        .property(Expectation.SOMETIMES, "value chosen", value_chosen)
        .record_msg_in(record_returns)
        .record_msg_out(record_invocations)
    )


def paxos_device_specs() -> dict:
    """Device property specs for compiling the ACTOR paxos model
    (``compile_actor_model(paxos_model(cfg), **paxos_device_specs(),
    closure="reachable")``) — the same history-table/network-scan
    idiom as ABD's specs (actor/register.py ``register_specs``). The
    hand encoding (models/paxos_tpu.py) stays the production path."""
    from ..actor.register import register_specs

    return dict(properties=register_specs(DEFAULT_VALUE))


def paxos_compiled_encoded(cfg: PaxosModelCfg,
                           network: Network | None = None, **kw):
    """The compiled paxos encoding: the actor model through the
    generic actor→encoding compiler, zero hand-written device code.
    ``closure="reachable"`` (the harvest/bootstrap mode): paxos
    ballots and the linearizability-tester history are bounded only by
    system reachability, so the overapproximating fixpoint has no
    protocol bound to converge on — the host explores the space once
    at compile time."""
    from ..actor.compile import compile_actor_model

    return compile_actor_model(
        paxos_model(cfg, network),
        **paxos_device_specs(),
        closure="reachable",
        **kw,
    )
