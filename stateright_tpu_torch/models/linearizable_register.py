"""ABD replicated atomic register (Attiya, Bar-Noy, Dolev).

A copy of the JAX package's ``models.linearizable_register``; its
encoding comes from the port's actor→encoding compiler. Counterpart of
stateright examples/linearizable-register.rs: a query/record two-phase
quorum protocol providing a linearizable read/write register without
consensus. Reference-pinned: 2 clients / 2 servers = 544 unique states
(linearizable-register.rs:286, 313).
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

# Seq = (logical_clock, writer_id): totally ordered, writer id breaks ties.


@dataclass(frozen=True)
class Query:
    req_id: int


@dataclass(frozen=True)
class AckQuery:
    req_id: int
    seq: Tuple
    value: Any


@dataclass(frozen=True)
class Record:
    req_id: int
    seq: Tuple
    value: Any


@dataclass(frozen=True)
class AckRecord:
    req_id: int


@dataclass(frozen=True)
class Phase1:
    request_id: int
    requester_id: Id
    write: Optional[Any]  # Some(value) for Put, None for Get
    responses: HashableMap  # Id -> (seq, value)


@dataclass(frozen=True)
class Phase2:
    request_id: int
    requester_id: Id
    read: Optional[Any]  # Some(value) for Get, None for Put
    acks: HashableSet


@dataclass(frozen=True)
class AbdState:
    seq: Tuple
    val: Any
    phase: Optional[Any]  # None | Phase1 | Phase2


class AbdActor(Actor):
    def __init__(self, peers: list[Id]):
        self.peers = peers

    def name(self) -> str:
        return "AbdServer"

    def on_start(self, id: Id, out: Out) -> AbdState:
        return AbdState(seq=(0, id), val=DEFAULT_VALUE, phase=None)

    def on_msg(self, id: Id, cow: Cow, src: Id, msg: Any, out: Out) -> None:
        state: AbdState = cow.value

        if isinstance(msg, (Put, Get)) and state.phase is None:
            write = msg.value if isinstance(msg, Put) else None
            out.broadcast(self.peers, Internal(Query(msg.req_id)))
            cow.set(
                replace(
                    state,
                    phase=Phase1(
                        request_id=msg.req_id,
                        requester_id=src,
                        write=write,
                        responses=HashableMap({id: (state.seq, state.val)}),
                    ),
                )
            )

        elif isinstance(msg, Internal) and isinstance(msg.msg, Query):
            out.send(
                src, Internal(AckQuery(msg.msg.req_id, state.seq, state.val))
            )

        elif (
            isinstance(msg, Internal)
            and isinstance(msg.msg, AckQuery)
            and isinstance(state.phase, Phase1)
            and state.phase.request_id == msg.msg.req_id
        ):
            phase = state.phase
            responses = phase.responses.set(src, (msg.msg.seq, msg.msg.value))
            if len(responses) == majority(len(self.peers) + 1):
                # Quorum: adopt the max (seq, value), bump for writes,
                # move to the record phase (linearizable-register.rs:
                # 123-170).
                seq, val = max(responses.values(), key=lambda sv: sv[0])
                read = None
                if phase.write is not None:
                    seq = (seq[0] + 1, id)
                    val = phase.write
                else:
                    read = val
                out.broadcast(
                    self.peers, Internal(Record(phase.request_id, seq, val))
                )
                new_state = state
                if seq > state.seq:
                    new_state = replace(new_state, seq=seq, val=val)
                cow.set(
                    replace(
                        new_state,
                        phase=Phase2(
                            request_id=phase.request_id,
                            requester_id=phase.requester_id,
                            read=read,
                            acks=HashableSet([id]),
                        ),
                    )
                )
            else:
                cow.set(
                    replace(state, phase=replace(phase, responses=responses))
                )

        elif isinstance(msg, Internal) and isinstance(msg.msg, Record):
            out.send(src, Internal(AckRecord(msg.msg.req_id)))
            if msg.msg.seq > state.seq:
                cow.set(replace(state, seq=msg.msg.seq, val=msg.msg.value))

        elif (
            isinstance(msg, Internal)
            and isinstance(msg.msg, AckRecord)
            and isinstance(state.phase, Phase2)
            and state.phase.request_id == msg.msg.req_id
            and src not in state.phase.acks
        ):
            phase = state.phase
            acks = phase.acks.add(src)
            if len(acks) == majority(len(self.peers) + 1):
                if phase.read is not None:
                    out.send(
                        phase.requester_id,
                        GetOk(phase.request_id, phase.read),
                    )
                else:
                    out.send(phase.requester_id, PutOk(phase.request_id))
                cow.set(replace(state, phase=None))
            else:
                cow.set(replace(state, phase=replace(phase, acks=acks)))
        # else: ignored → no-op → pruned


@dataclass(frozen=True)
class AbdModelCfg:
    client_count: int = 2
    server_count: int = 2
    put_count: int = 1


def abd_model(cfg: AbdModelCfg, network: Network | None = None) -> ActorModel:
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
    model.add_actors(
        RegisterServer(AbdActor(model_peers(i, cfg.server_count)))
        for i in range(cfg.server_count)
    )
    model.add_actors(
        RegisterClient(put_count=cfg.put_count, server_count=cfg.server_count)
        for _ in range(cfg.client_count)
    )
    model.init_network(network)
    model.property(
        Expectation.ALWAYS,
        "linearizable",
        lambda m, s: s.history.serialized_history() is not None,
    )
    model.property(Expectation.SOMETIMES, "value chosen", value_chosen)
    model.record_msg_in(record_returns)
    model.record_msg_out(record_invocations)
    model.to_encoded = lambda: abd_encoded(model)
    return model


def abd_queue_bounds(cfg: AbdModelCfg):
    """Declared FIFO queue bounds for ABD over an ordered network
    (closure_queue_bound — lets the ordered encoding compile with NO
    host exploration).

    Protocol reasoning (register.py client loop +
    linearizable-register.rs:123-170 server phases): a client blocks
    awaiting each op's reply, so client↔server channels hold ≤1
    message. A server→server channel (i→j) carries (a) Query+Record
    broadcasts from ops i coordinates — ≤2 per op, and the Phase2
    quorum never requires a PARTICULAR peer, so j can lag i's whole
    op sequence — plus (b) AckQuery+AckRecord replies from i to ops j
    coordinates — ≤2 per op of j. Ops per server are exact from the
    client round-robin (client c's k-th op goes to server (c+k) mod
    server_count, register.py:117-136), giving
    ``2·ops(i) + 2·ops(j)``. The bound only needs to be SAFE, not
    tight: over-declaring costs queue bits (the compiler caps a
    declared bound to what fits the 32-bit lane, with a warning),
    under-declaring raises the engines' truncation flag — never a
    silent truncation.
    """
    S, P = cfg.server_count, cfg.put_count + 1
    ops = [0] * S
    for c in range(S, S + cfg.client_count):
        for k in range(P):
            ops[(c + k) % S] += 1

    def bound(src: int, dst: int) -> int:
        if src >= S or dst >= S:
            return 1  # client↔server: one in-flight op
        return 2 * ops[src] + 2 * ops[dst]

    return bound


def abd_encoded(model: ActorModel, closure: str | None = None,
                queue_bound=None, max_domain: int | None = None):
    """The compiled encoding (actor/compile.py) — ABD has no
    hand-written device code at all. ABD's logical clocks are bounded
    only by system reachability (a write bumps the max quorum clock),
    so the UNBOUNDED overapproximating closure diverges. The default
    mode here is bounded overapproximation: the protocol invariant "a
    logical clock never exceeds the number of writes issued" (each Put
    bumps the adopted quorum max by exactly one,
    linearizable-register.rs:123-170) gives
    ``seq[0] <= client_count * put_count``, and the client loop gives
    ``ops per thread <= put_count + 1`` — with those two bounds the
    component fixpoint converges WITHOUT any host exploration, so the
    device does all the search work and the compile cost does not scale
    with the state space. Ordered networks get declared queue bounds
    (:func:`abd_queue_bounds`). ``closure="reachable"`` remains
    available as the harvest/bootstrap mode.
    """
    from ..actor.compile import compile_actor_model
    from ..actor.network import Ordered
    from ..actor.register import register_specs

    cfg = model.cfg
    ordered = isinstance(model._init_network, Ordered)
    if closure is None:
        closure = "overapprox"
    if ordered and closure == "overapprox" and queue_bound is None:
        queue_bound = abd_queue_bounds(cfg)
    w_max = cfg.client_count * cfg.put_count

    def seq_ok(seq) -> bool:
        return seq[0] <= w_max

    def actor_bound(i: int, s) -> bool:
        if i >= cfg.server_count:
            return True  # clients: op_count is self-bounded
        inner = s.state  # RegisterServer wraps AbdState
        if not seq_ok(inner.seq):
            return False
        ph = inner.phase
        if isinstance(ph, Phase1):
            return all(seq_ok(sv[0]) for sv in ph.responses.values())
        return True

    def history_bound(h) -> bool:
        per_thread = dict(h.history_by_thread)
        in_flight = dict(h.in_flight_by_thread)
        for t, completed in per_thread.items():
            ops = len(completed) + (1 if in_flight.get(t) else 0)
            if ops > cfg.put_count + 1:
                return False
        # Reachable ABD histories are linearizable (the ALWAYS property
        # this model checks). Bounding EXPANSION to linearizable
        # histories is sound for that property: a bounded-out history
        # is kept un-expanded, so the first non-linearizable history —
        # were one ever reachable — still enters the domain and trips
        # the property. This is what tames the overapprox tester-state
        # combinatorics at 3 clients.
        return h.serialized_history() is not None

    if max_domain is None:
        # The bounded history domain (≤ put_count+1 ops per thread,
        # linearizable-expansion) converges but GROWS steeply with
        # client count: 2c fits the 32k default; more clients need a
        # wider divergence guard, not a different bound.
        max_domain = 1 << 15 if cfg.client_count <= 2 else 1 << 22
    return compile_actor_model(
        model,
        properties=register_specs(DEFAULT_VALUE),
        closure=closure,
        closure_actor_bound=actor_bound,
        closure_history_bound=history_bound,
        closure_queue_bound=queue_bound,
        max_domain=max_domain,
    )
