"""The port's actor adapters (``actor/choice.py``,
``actor/ordered_reliable_link.py``, ``actor/write_once_register.py``)
held to the JAX package's: tests/test_actor_parity.py's models, built in
each package, give equal counts, depths, discovered names and
``Path.encode()`` of every discovery."""

import importlib
from typing import Any

import pytest


def _mod(pkg: str, name: str):
    root = "stateright_tpu" if pkg == "jax" else "stateright_tpu_torch"
    return importlib.import_module(f"{root}.{name}")


def _orl_model(pkg: str):
    """The reference's ORL model (ordered_reliable_link.rs:252-281): a
    sender of 42 and 43 and a recorder, each behind the link, over a
    lossy duplicating network, boundary |network| < 4."""
    actor = _mod(pkg, "actor")
    orl = _mod(pkg, "actor.ordered_reliable_link")
    Expectation = _mod(pkg, "model").Expectation
    Id = actor.Id

    class Sender(actor.Actor):
        def on_start(self, id, out) -> tuple:
            out.send(Id(1), 42)
            out.send(Id(1), 43)
            return ()

    class Receiver(actor.Actor):
        def on_start(self, id, out) -> tuple:
            return ()

        def on_msg(self, id, state, src, msg, out) -> None:
            state.set(state.value + (msg,))

    model = actor.ActorModel()
    model.actor(orl.OrderedReliableLink(Sender()))
    model.actor(orl.OrderedReliableLink(Receiver()))
    model.init_network(actor.Network.new_unordered_duplicating())
    model.set_lossy_network(True)

    def received(state) -> tuple:
        return state.actor_states[1].wrapped_state

    model.property(Expectation.ALWAYS, "no redelivery",
                   lambda m, s: received(s).count(42) < 2
                   and received(s).count(43) < 2)
    model.property(Expectation.ALWAYS, "ordered",
                   lambda m, s: list(received(s)) == sorted(received(s)))
    model.property(Expectation.SOMETIMES, "delivered",
                   lambda m, s: received(s) == (42, 43))
    model.within_boundary_fn(lambda cfg, s: len(s.network) < 4)
    return model


def _scripted_model(pkg: str):
    """A ScriptedActor (actor.rs:515-549) driving a SingleCopyActor."""
    actor = _mod(pkg, "actor")
    reg = _mod(pkg, "actor.register")
    Expectation = _mod(pkg, "model").Expectation
    scr = _mod(pkg, "models.single_copy_register")
    Id = actor.Id
    model = actor.ActorModel()
    model.actor(scr.SingleCopyActor())
    model.actor(actor.ScriptedActor(
        [(Id(0), reg.Put(1, "X")), (Id(0), reg.Get(2))]))
    model.init_network(actor.Network.new_unordered_nonduplicating())
    model.property(Expectation.SOMETIMES, "read returns X",
                   lambda m, s: any(isinstance(env.msg, reg.GetOk)
                                    and env.msg.value == "X"
                                    for env in s.network.iter_deliverable()))
    return model


def _choice_model(pkg: str):
    """Choice keeps two actor kinds' states type-disjoint (L / R)."""
    actor = _mod(pkg, "actor")
    reg = _mod(pkg, "actor.register")
    Expectation = _mod(pkg, "model").Expectation
    scr = _mod(pkg, "models.single_copy_register")
    Id = actor.Id
    model = actor.ActorModel()
    model.actor(actor.Choice.left(scr.SingleCopyActor()))
    model.actor(actor.Choice.right_of(
        actor.ScriptedActor([(Id(0), reg.Put(1, "V"))])))
    model.init_network(actor.Network.new_unordered_nonduplicating())
    model.property(Expectation.SOMETIMES, "write acknowledged",
                   lambda m, s: any(isinstance(env.msg, reg.PutOk)
                                    for env in s.network.iter_deliverable()))
    return model


def _wo_model(pkg: str):
    """Two clients racing to write a write-once register: the histories
    stay linearizable against WORegister, and a second write fails."""
    actor = _mod(pkg, "actor")
    reg = _mod(pkg, "actor.register")
    wo = _mod(pkg, "actor.write_once_register")
    sem = _mod(pkg, "semantics")
    Expectation = _mod(pkg, "model").Expectation

    class WOServer(actor.Actor):
        def on_start(self, id, out):
            return None

        def on_msg(self, id, state, src, msg: Any, out) -> None:
            if isinstance(msg, reg.Put):
                if state.value is None:
                    state.set(msg.value)
                    out.send(src, reg.PutOk(msg.req_id))
                else:
                    out.send(src, wo.PutFail(msg.req_id))
            elif isinstance(msg, reg.Get):
                out.send(src, reg.GetOk(msg.req_id, state.value))

    model = actor.ActorModel(
        init_history=sem.LinearizabilityTester(sem.WORegister()))
    model.actor(WOServer())
    model.add_actors(wo.WORegisterClient(put_count=1, server_count=1)
                     for _ in range(2))
    model.init_network(actor.Network.new_unordered_nonduplicating())
    model.property(Expectation.ALWAYS, "linearizable",
                   lambda m, s: s.history.serialized_history() is not None)
    model.property(Expectation.SOMETIMES, "a write fails",
                   lambda m, s: any(isinstance(env.msg, wo.PutFail)
                                    for env in s.network.iter_deliverable()))
    model.record_msg_in(wo.record_returns)
    model.record_msg_out(wo.record_invocations)
    return model


MODELS = {"orl": _orl_model, "scripted": _scripted_model,
          "choice": _choice_model, "write-once": _wo_model}


def _run(model, spawn: str):
    c = getattr(model.checker(), spawn)().join()
    return (c.unique_state_count(), c.state_count(), c.max_depth(),
            {n: p.encode() for n, p in c.discoveries().items()})


@pytest.mark.parametrize("spawn", ["spawn_bfs", "spawn_dfs"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_adapter_models_equal_jax(name, spawn):
    want = _run(MODELS[name]("jax"), spawn)
    got = _run(MODELS[name]("torch"), spawn)
    assert got == want
    assert got[0] > 1


def test_adapter_verdicts():
    """tests/test_actor_parity.py's verdicts on the port's models."""
    orl = _orl_model("torch").checker().spawn_bfs().join()
    orl.assert_no_discovery("no redelivery")
    orl.assert_no_discovery("ordered")
    path = orl.assert_any_discovery("delivered")
    assert path.last_state().actor_states[1].wrapped_state == (42, 43)
    init = list(_orl_model("torch").init_states())[0]
    assert sorted(init.actor_states[0].msgs_pending_ack.keys()) == [1, 2]
    assert init.actor_states[0].next_send_seq == 3
    for name in ("scripted", "choice", "write-once"):
        MODELS[name]("torch").checker().spawn_bfs().join(
        ).assert_properties()
    choice = _mod("torch", "actor.choice")
    init = list(_choice_model("torch").init_states())[0]
    assert isinstance(init.actor_states[0], choice.L)
    assert isinstance(init.actor_states[1], choice.R)


def test_orl_refuses_wrapped_timers():
    """Like the reference's ``todo!`` (ordered_reliable_link.rs:191-196),
    a wrapped actor's own timers are refused."""
    actor = _mod("torch", "actor")
    orl = _mod("torch", "actor.ordered_reliable_link")

    class Timed(actor.Actor):
        def on_start(self, id, out):
            out.set_timer("t", (1.0, 2.0))
            return ()

    with pytest.raises(NotImplementedError, match="wrapped SetTimer"):
        orl.OrderedReliableLink(Timed()).on_start(actor.Id(0), actor.Out())
