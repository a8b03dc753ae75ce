"""Real-world actor execution over UDP.

A copy of the JAX package's ``actor.spawn``: the same JSON wire format,
so actors of the two packages talk to each other over UDP. Counterpart
of stateright src/actor/spawn.rs:64-147: the *same*
``Actor`` subclasses the model checker verified run as real network
nodes — one thread per actor, a UDP socket bound to the address packed
in its ``Id`` (spawn.rs:81; packing in base.py mirrors spawn.rs:10-34),
and an event loop that waits for the earliest timer deadline, receives
and deserializes datagrams into ``on_msg``, fires ``on_timeout``, and
applies emitted commands (send / set-timer / cancel-timer,
spawn.rs:92-206).

Serialization is pluggable (``serialize``/``deserialize`` callables,
spawn.rs:64-67); :func:`json_serde` provides the JSON codec the
reference examples use (examples/paxos.rs:426-450), with JSON arrays
decoded as tuples so values round-trip into comparable Python shapes.
"""

from __future__ import annotations

import json
import random
import socket
import threading
import time
from dataclasses import fields, is_dataclass
from typing import Any, Callable, Iterable, Optional, Sequence, Tuple

from .base import Actor, CancelTimer, Cow, Id, Out, Send, SetTimer

#: Cancelled timers are parked ~500 years out (spawn.rs:36-39).
_PRACTICALLY_NEVER = 500 * 365 * 24 * 3600.0
_MAX_DATAGRAM = 65507


# -- serde ---------------------------------------------------------------


def json_serde(
    msg_types: Iterable[type],
) -> Tuple[Callable[[Any], bytes], Callable[[bytes], Any]]:
    """A JSON codec over a closed set of dataclass message types.

    Encoding: ``{"TypeName": [field, values]}`` for dataclasses
    (nested ones too), scalars as themselves, tuples as arrays.
    Decoding inverts it, turning arrays back into tuples — model
    states compare ballots and the like structurally, so tuple-ness
    must survive the round trip.
    """
    registry = {t.__name__: t for t in msg_types}

    def enc(obj: Any):
        if is_dataclass(obj) and type(obj).__name__ in registry:
            return {
                type(obj).__name__: [
                    enc(getattr(obj, f.name)) for f in fields(obj)
                ]
            }
        if isinstance(obj, (list, tuple)):
            return [enc(x) for x in obj]
        if isinstance(obj, Id):
            return int(obj)
        return obj

    def dec(obj: Any):
        if isinstance(obj, dict) and len(obj) == 1:
            (name, args), = obj.items()
            if name in registry:
                return registry[name](*(dec(a) for a in args))
        if isinstance(obj, list):
            return tuple(dec(x) for x in obj)
        return obj

    def serialize(msg: Any) -> bytes:
        return json.dumps(enc(msg)).encode()

    def deserialize(data: bytes) -> Any:
        return dec(json.loads(data.decode()))

    return serialize, deserialize


def register_msg_types() -> list[type]:
    """The register protocol + paxos internals — enough for the
    bundled spawnable examples."""
    from ..models import paxos as px
    from . import register as reg

    return [
        reg.Put,
        reg.Get,
        reg.PutOk,
        reg.GetOk,
        reg.Internal,
        px.Prepare,
        px.Prepared,
        px.Accept,
        px.Accepted,
        px.Decided,
    ]


# -- runtime -------------------------------------------------------------


class ActorHandle:
    """One running actor: its thread, socket, and live state."""

    def __init__(self, id: Id, actor: Actor):
        self.id = id
        self.actor = actor
        self._state_lock = threading.Lock()
        self._state: Any = None
        self._stop = threading.Event()
        self.thread: Optional[threading.Thread] = None
        self.events = 0  # messages + timeouts handled

    @property
    def state(self) -> Any:
        with self._state_lock:
            return self._state

    def _set_state(self, value: Any) -> None:
        with self._state_lock:
            self._state = value

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: Optional[float] = None) -> None:
        if self.thread is not None:
            self.thread.join(timeout)


def spawn(
    serialize: Callable[[Any], bytes],
    deserialize: Callable[[bytes], Any],
    actors: Sequence[Tuple[Id, Actor]],
    daemon: bool = True,
) -> list[ActorHandle]:
    """Run each ``(id, actor)`` on its own thread + UDP socket
    (spawn.rs:64-147). Returns handles; call ``stop()``/``join()`` to
    shut down (the reference blocks forever; handles make the runtime
    testable and embeddable)."""
    handles, socks = [], []
    for id, actor in actors:
        handle = ActorHandle(Id(id), actor)
        # Bind before any event loop starts: on_start sends race
        # sibling binds otherwise, and a dropped hello deadlocks
        # protocols without retry timers.
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            sock.bind(Id(id).to_addr())
        except OSError:
            # a taken port: close what this call bound (the JAX runtime
            # leaves those sockets open) and let the caller retry
            for s in socks + [sock]:
                s.close()
            raise
        socks.append(sock)
        thread = threading.Thread(
            target=_event_loop,
            args=(handle, sock, serialize, deserialize),
            name=f"actor-{int(id)}",
            daemon=daemon,
        )
        handle.thread = thread
        handles.append(handle)
    for handle in handles:
        handle.thread.start()
    return handles


def _event_loop(handle: ActorHandle, sock, serialize, deserialize) -> None:
    id, actor = handle.id, handle.actor
    try:
        timers: dict[Any, float] = {}
        out = Out()
        state = actor.on_start(id, out)
        handle._set_state(state)
        _apply(sock, id, out, timers, serialize)
        while not handle._stop.is_set():
            now = time.monotonic()
            # Earliest timer deadline bounds the socket wait
            # (spawn.rs:95-101); capped so stop() stays responsive.
            deadline = min(timers.values(), default=now + _PRACTICALLY_NEVER)
            sock.settimeout(max(0.0, min(deadline - now, 0.1)))
            fired = None
            try:
                data, addr = sock.recvfrom(_MAX_DATAGRAM)
            except (socket.timeout, BlockingIOError):
                # settimeout(0.0) — a timer already due — makes the
                # socket non-blocking, and recvfrom then raises
                # BlockingIOError rather than socket.timeout.
                data = None
                now = time.monotonic()
                due = [(when, t) for t, when in timers.items() if when <= now]
                if due:
                    # Earliest deadline first (spawn.rs services the
                    # minimum deadline it waited on).
                    fired = min(due, key=lambda d: d[0])[1]
            cow = Cow(state)
            out = Out()
            if data is not None:
                try:
                    msg = deserialize(data)
                except Exception:
                    continue  # garbage datagram (spawn.rs:118-126)
                src = Id.from_addr(addr[0], addr[1])
                actor.on_msg(id, cow, src, msg, out)
                handle.events += 1
            elif fired is not None:
                del timers[fired]  # fired timers are no longer set
                actor.on_timeout(id, cow, fired, out)
                handle.events += 1
            else:
                continue
            if cow.owned:
                state = cow.value
                handle._set_state(state)
            _apply(sock, id, out, timers, serialize)
    finally:
        sock.close()


def _apply(sock, id: Id, out: Out, timers: dict, serialize) -> None:
    """Apply emitted commands (spawn.rs:150-206)."""
    for command in out:
        if isinstance(command, Send):
            try:
                sock.sendto(serialize(command.msg), command.dst.to_addr())
            except OSError:
                pass  # unreachable peer: UDP semantics, drop
        elif isinstance(command, SetTimer):
            duration = random.uniform(command.min_sec, command.max_sec)
            timers[command.timer] = time.monotonic() + duration
        elif isinstance(command, CancelTimer):
            # Parked, not deleted (spawn.rs:199-204 semantics); simply
            # removing it is equivalent here.
            timers.pop(command.timer, None)


# -- CLI spawn entry points (examples/paxos.rs:403-465 etc.) -------------


def _loopback_ids(base_port: int, count: int) -> list[Id]:
    return [Id.from_addr("127.0.0.1", base_port + i) for i in range(count)]


def spawn_paxos_cluster(base_port: int = 3000, block: bool = True):
    from ..models.paxos import PaxosActor
    from .register import RegisterServer

    ids = _loopback_ids(base_port, 3)
    serialize, deserialize = json_serde(register_msg_types())
    print("  A set of servers that implement Single Decree Paxos.")
    print("  You can interact via UDP, e.g. with netcat:")
    print(f"$ nc -u localhost {base_port}")
    print(serialize(_example_put()).decode())
    print(serialize(_example_get()).decode())
    handles = spawn(
        serialize,
        deserialize,
        [
            (
                ids[i],
                RegisterServer(
                    PaxosActor([ids[j] for j in range(3) if j != i])
                ),
            )
            for i in range(3)
        ],
    )
    if block:
        for handle in handles:
            handle.join()
    return handles


def spawn_single_copy_cluster(base_port: int = 3000, block: bool = True):
    from ..models.single_copy_register import SingleCopyActor

    ids = _loopback_ids(base_port, 1)
    serialize, deserialize = json_serde(register_msg_types())
    print("  A single-copy register server.")
    print(f"$ nc -u localhost {base_port}")
    print(serialize(_example_put()).decode())
    print(serialize(_example_get()).decode())
    handles = spawn(serialize, deserialize, [(ids[0], SingleCopyActor())])
    if block:
        for handle in handles:
            handle.join()
    return handles


def spawn_abd_cluster(base_port: int = 3000, block: bool = True):
    from ..models.linearizable_register import AbdActor
    from .register import RegisterServer

    ids = _loopback_ids(base_port, 2)
    serialize, deserialize = json_serde(
        register_msg_types() + _abd_msg_types()
    )
    print("  ABD algorithm servers for a linearizable register.")
    print(f"$ nc -u localhost {base_port}")
    print(serialize(_example_put()).decode())
    print(serialize(_example_get()).decode())
    handles = spawn(
        serialize,
        deserialize,
        [
            (ids[i], RegisterServer(AbdActor([ids[1 - i]])))
            for i in range(2)
        ],
    )
    if block:
        for handle in handles:
            handle.join()
    return handles


def _abd_msg_types() -> list[type]:
    from ..models import linearizable_register as abd

    return [abd.Query, abd.AckQuery, abd.Record, abd.AckRecord]


def _example_put():
    from .register import Put

    return Put(1, "X")


def _example_get():
    from .register import Get

    return Get(2)
