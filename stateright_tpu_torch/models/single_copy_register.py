"""Single-copy register servers (no consensus) + linearizability check.

A copy of the JAX package's ``models.single_copy_register`` (stateright
examples/single-copy-register.rs): each server holds one value; Put
overwrites, Get reads. With one server the system is linearizable
(reference-pinned 93 unique states for 2 clients / 1 server,
single-copy-register.rs:110); with two servers it is not. Class and
field names match the JAX package's, so host fingerprints and encoded
paths are identical.

``to_encoded`` takes the hand encoding
(:mod:`stateright_tpu_torch.models.single_copy_register_tpu`, dense) at
up to 2 clients on an unordered non-duplicating network, and the
actor→encoding compiler otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..model import Expectation
from ..actor import Actor, ActorModel, Cow, Id, Network, Out
from ..actor.register import (
    DEFAULT_VALUE,
    Get,
    GetOk,
    Put,
    PutOk,
    RegisterClient,
    RegisterServer,
    record_invocations,
    record_returns,
)
from ..semantics import LinearizabilityTester, Register


class SingleCopyActor(Actor):
    def on_start(self, id: Id, out: Out) -> str:
        return DEFAULT_VALUE

    def on_msg(self, id: Id, state: Cow, src: Id, msg: Any,
               out: Out) -> None:
        if isinstance(msg, Put):
            state.set(msg.value)
            out.send(src, PutOk(msg.req_id))
        elif isinstance(msg, Get):
            out.send(src, GetOk(msg.req_id, state.value))


@dataclass(frozen=True)
class SingleCopyRegisterCfg:
    client_count: int = 2
    server_count: int = 1
    put_count: int = 1


def single_copy_register_model(
    cfg: SingleCopyRegisterCfg, network: Network | None = None
) -> ActorModel:
    if network is None:
        network = Network.new_unordered_nonduplicating()

    def value_chosen(model: ActorModel, state) -> bool:
        # An observable non-default read exists in flight
        # (single-copy-register.rs:73-82).
        for env in state.network.iter_deliverable():
            if isinstance(env.msg, GetOk) and env.msg.value != DEFAULT_VALUE:
                return True
        return False

    model = ActorModel(
        cfg=cfg, init_history=LinearizabilityTester(Register(DEFAULT_VALUE))
    )

    def to_encoded():
        from ..actor.network import UnorderedNonDuplicating

        if cfg.client_count <= 2 and isinstance(
            model._init_network, UnorderedNonDuplicating
        ):
            from .single_copy_register_tpu import SingleCopyEncoded

            return SingleCopyEncoded(cfg, network)
        # Beyond the hand encoding's envelope (e.g. 3 clients), the
        # actor→encoding compiler with the register specs; the client
        # loop bounds ops per thread at put_count+1, and the history
        # bound (sound for the ALWAYS property: a bounded-out history
        # still enters the domain and trips the property before
        # expansion stops) tames the tester-state combinatorics.
        from ..actor.compile import compile_actor_model
        from ..actor.register import register_specs

        def history_bound(h) -> bool:
            per_thread = dict(h.history_by_thread)
            in_flight = dict(h.in_flight_by_thread)
            for t, completed in per_thread.items():
                ops = len(completed) + (1 if in_flight.get(t) else 0)
                if ops > cfg.put_count + 1:
                    return False
            return h.serialized_history() is not None

        return compile_actor_model(
            model,
            properties=register_specs(DEFAULT_VALUE),
            closure_history_bound=history_bound,
        )

    model.to_encoded = to_encoded
    model.add_actors(
        RegisterServer(SingleCopyActor()) for _ in range(cfg.server_count)
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
