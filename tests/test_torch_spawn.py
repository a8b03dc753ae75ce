"""The port's UDP actor runtime (``actor/spawn.py``): the JSON wire
format byte-equal to the JAX package's, ping-pong and a Paxos and a
single-copy register put/get over loopback, and a JAX-spawned actor
volleying with a port-spawned one over UDP.

Every socket read has a timeout and every wait a deadline; ports are
bound at 0 (or probed from the ephemeral range for the clusters, which
take consecutive ports).
"""

import contextlib
import io
import json
import socket
import time

import pytest

import stateright_tpu.actor.spawn as jspawn
import stateright_tpu_torch.actor.spawn as pspawn
from stateright_tpu_torch.actor import Id
from stateright_tpu_torch.actor.register import Get, GetOk, Put, PutOk


def _free_ports(n):
    socks = []
    for _ in range(n):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _await(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


def _stop(handles):
    for h in handles:
        h.stop()
    for h in handles:
        h.join(2)
    assert not any(h.thread.is_alive() for h in handles)


def _messages(pkg):
    """Register, Paxos and ABD messages built in ``pkg``."""
    import importlib

    root = "stateright_tpu" if pkg == "jax" else "stateright_tpu_torch"
    reg = importlib.import_module(f"{root}.actor.register")
    px = importlib.import_module(f"{root}.models.paxos")
    abd = importlib.import_module(f"{root}.models.linearizable_register")
    Id_ = importlib.import_module(f"{root}.actor").Id
    ballot = (1, Id_(0))
    return [
        reg.Put(1, "X"), reg.Get(2), reg.PutOk(1), reg.GetOk(2, "X"),
        reg.GetOk(3, None),
        reg.Internal(px.Prepared(ballot, (ballot, (3, Id_(3), "A")))),
        reg.Internal(px.Prepare(ballot)),
        reg.Internal(px.Accept(ballot, (3, Id_(3), "A"))),
        reg.Internal(px.Accepted(ballot)),
        reg.Internal(px.Decided(ballot, (3, Id_(3), "A"))),
        reg.Internal(abd.Query(7)),
        reg.Internal(abd.AckQuery(5, (2, Id_(1)), "B")),
        reg.Internal(abd.Record(6, (2, Id_(1)), "B")),
        reg.Internal(abd.AckRecord(6)),
    ]


def test_json_serde_bytes_equal_jax():
    import stateright_tpu.models.linearizable_register as jabd
    import stateright_tpu_torch.models.linearizable_register as pabd

    jser, jde = jspawn.json_serde(jspawn.register_msg_types()
                                  + jspawn._abd_msg_types())
    pser, pde = pspawn.json_serde(pspawn.register_msg_types()
                                  + pspawn._abd_msg_types())
    assert [t.__name__ for t in pspawn.register_msg_types()] == [
        t.__name__ for t in jspawn.register_msg_types()]
    assert jabd.Query.__name__ == pabd.Query.__name__
    jm, pm = _messages("jax"), _messages("torch")
    for j, p in zip(jm, pm):
        data = pser(p)
        assert data == jser(j), p
        # each side decodes the other's bytes into its own types
        assert json.loads(pser(jde(data))) == json.loads(data)
        back = pde(jser(j))
        assert back == p or json.loads(pser(back)) == json.loads(data), p
    assert pser(Put(1, "X")) == b'{"Put": [1, "X"]}'


def test_ping_pong_over_udp():
    """The model-checked PingPongActor volleys over real sockets."""
    from stateright_tpu_torch.models.ping_pong import (
        Ping,
        PingPongActor,
        Pong,
    )

    p0, p1 = _free_ports(2)
    id0, id1 = Id.from_addr("127.0.0.1", p0), Id.from_addr("127.0.0.1", p1)
    serialize, deserialize = pspawn.json_serde([Ping, Pong])
    handles = pspawn.spawn(serialize, deserialize, [
        (id0, PingPongActor(serve_to=id1)), (id1, PingPongActor(None))])
    try:
        assert _await(lambda: all(h.state and h.state >= 5
                                  for h in handles))
        assert all(h.events >= 5 for h in handles)
    finally:
        _stop(handles)


def test_jax_and_port_actors_talk_over_udp():
    """A JAX-spawned PingPongActor serves a port-spawned one: the wire
    format is the same, so the volley runs across the two packages."""
    import stateright_tpu.actor as jactor
    import stateright_tpu.models.ping_pong as jpp
    import stateright_tpu_torch.models.ping_pong as ppp

    p0, p1 = _free_ports(2)
    jid = jactor.Id.from_addr("127.0.0.1", p0)
    pid = Id.from_addr("127.0.0.1", p1)
    jh = jspawn.spawn(*jspawn.json_serde([jpp.Ping, jpp.Pong]),
                      [(jid, jpp.PingPongActor(None))])
    ph = pspawn.spawn(*pspawn.json_serde([ppp.Ping, ppp.Pong]),
                      [(pid, ppp.PingPongActor(serve_to=Id(int(jid))))])
    try:
        assert _await(lambda: (jh[0].state or 0) >= 5
                      and (ph[0].state or 0) >= 5)
    finally:
        _stop(jh + ph)


def _cluster(spawn_fn, n_ports: int):
    """Start ``spawn_fn`` on a run of ``n_ports`` free consecutive ports
    (probed; a port taken since is retried); return (base, handles)."""
    for _ in range(50):
        base = _free_ports(1)[0]
        if base + n_ports > 65535:
            continue
        try:
            with contextlib.redirect_stdout(io.StringIO()) as out:
                handles = spawn_fn(base_port=base, block=False)
        except OSError:
            continue
        assert f"$ nc -u localhost {base}" in out.getvalue()
        return base, handles
    raise AssertionError(f"no {n_ports} consecutive free ports in 50 tries")


def _put_get(base: int) -> None:
    serialize, deserialize = pspawn.json_serde(pspawn.register_msg_types())
    client = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    client.bind(("127.0.0.1", 0))
    client.settimeout(8.0)
    try:
        client.sendto(serialize(Put(42, "X")), ("127.0.0.1", base))
        data, _ = client.recvfrom(65507)
        assert deserialize(data) == PutOk(42)
        client.sendto(serialize(Get(43)), ("127.0.0.1", base))
        data, _ = client.recvfrom(65507)
        assert deserialize(data) == GetOk(43, "X")
    finally:
        client.close()


@pytest.mark.parametrize("cluster,n_ports", [
    ("spawn_paxos_cluster", 3), ("spawn_single_copy_cluster", 1),
])
def test_cluster_put_get_round_trip(cluster, n_ports):
    """Real servers decide a value and serve reads, driven by a raw UDP
    client as the reference's ``nc`` workflow (examples/paxos.rs:403-419)."""
    base, handles = _cluster(getattr(pspawn, cluster), n_ports)
    try:
        assert len(handles) == n_ports
        _put_get(base)
    finally:
        _stop(handles)


def test_a_taken_port_releases_the_ports_already_bound():
    """spawn binds every socket before it starts a loop; when a later
    bind fails it closes the sockets it bound (the JAX runtime leaves
    them open), so a caller can retry at another base."""
    from stateright_tpu_torch.models.ping_pong import PingPongActor

    taken = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    taken.bind(("127.0.0.1", 0))
    try:
        free = _free_ports(1)[0]
        ids = [Id.from_addr("127.0.0.1", free),
               Id.from_addr("127.0.0.1", taken.getsockname()[1])]
        with pytest.raises(OSError):
            pspawn.spawn(*pspawn.json_serde([]),
                         [(i, PingPongActor(None)) for i in ids])
        again = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        again.bind(("127.0.0.1", free))
        again.close()
    finally:
        taken.close()
