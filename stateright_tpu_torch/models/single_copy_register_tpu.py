"""Vectorized single-copy register: a dense actor-model hand encoding.

The port of ``stateright_tpu.models.single_copy_register_tpu``. The host
half is copied — the envelope universe, ``encode``, the history fields,
``_tester_for`` and the 1,296-entry linearizability truth table, which
the port's own ``semantics/linearizability.py`` computes — and the
device half (``step_cols``, ``property_conditions_cols``) is batched
over lane-major ``[W, N]`` int64 blocks (encoding.py). Dense only, as
in the JAX package.

It encodes the full actor-model state of
:mod:`stateright_tpu_torch.models.single_copy_register` (pinned at 93
states for 2 clients / 1 server) — server value, register clients, the
12-envelope network as a bitmask, and the in-state
``LinearizabilityTester`` — into 3 uint32 lanes. Both clients complete
operations, so each client's read invocation records how many of the
peer's operations had completed: the tester state per client is
(phase, read-value, read-snapshot), 36 combinations, and the
serializer verdict is a truth table precomputed by the REAL serializer
over directly constructed tester states.

Layout (width = 3):
  lane 0: server value (2b) | client actor phases (2b each)
  lane 1: per client 6 bits of tester state: phase(2) rv(2) snapR(2)
  lane 2: network bitmask (12 envelopes)
"""

from __future__ import annotations

import itertools
from collections import Counter
from typing import Optional, Tuple

import numpy as np
import torch

from ..actor import Id
from ..actor.register import Get, GetOk, Put, PutOk
from ..encoding import EncodedModelBase, stack_slots
from ..semantics import LinearizabilityTester, Register
from ..semantics.register import ReadOk, ReadOp, WriteOk, WriteOp
from .single_copy_register import (
    SingleCopyRegisterCfg,
    single_copy_register_model,
)


class SingleCopyEncoded(EncodedModelBase):
    def __init__(self, cfg: SingleCopyRegisterCfg, network=None):
        if cfg.server_count != 1 or cfg.put_count != 1:
            raise ValueError(
                f"SingleCopyEncoded supports 1 server, put_count=1 (got {cfg})"
            )
        if not (1 <= cfg.client_count <= 2):
            raise ValueError("SingleCopyEncoded supports 1-2 clients")
        if network is not None and type(network).__name__ != (
            "UnorderedNonDuplicating"
        ):
            raise ValueError(
                "SingleCopyEncoded models the unordered non-duplicating "
                "network"
            )
        self.cfg = cfg
        self.C = cfg.client_count
        self.clients = list(range(1, 1 + self.C))
        self.values = [chr(ord("A") + i - 1) for i in self.clients]
        self.P = len(self.values)
        self.host_model = single_copy_register_model(cfg)
        self.universe = self._build_universe()
        self.index = {e: k for k, e in enumerate(self.universe)}
        self.K = len(self.universe)
        self.width = 3
        self.max_actions = self.K
        self._lin_table = self._build_lin_table()
        self._lin_dev: dict = {}

    def cache_key(self):
        """The JAX encoding's identity, so that a snapshot's encoding
        fingerprint (checkpoint.py) is equal across the two packages."""
        return (self.C,)

    # -- universe ----------------------------------------------------------
    # Envelope key: (src, dst, kind, arg) with kind put|get|putok|getok.

    def _build_universe(self) -> list:
        u = []
        for j, c in enumerate(self.clients):
            u.append((c, 0, "put", j + 1))
        for c in self.clients:
            u.append((c, 0, "get", 0))
        for j, c in enumerate(self.clients):
            u.append((0, c, "putok", j + 1))
        for c in self.clients:
            for v in range(self.P + 1):  # '\x00' readable before any write
                u.append((0, c, "getok", v))
        return u

    def _value_code(self, value: str) -> int:
        if value == "\x00":
            return 0
        try:
            return 1 + self.values.index(value)
        except ValueError:
            raise ValueError(f"value outside universe: {value!r}")

    def _msg_key(self, src: int, dst: int, msg) -> tuple:
        if isinstance(msg, Put):
            return (src, dst, "put", self._value_code(msg.value))
        if isinstance(msg, Get):
            return (src, dst, "get", 0)
        if isinstance(msg, PutOk):
            j = self.clients.index(msg.req_id)
            return (src, dst, "putok", j + 1)
        if isinstance(msg, GetOk):
            return (src, dst, "getok", self._value_code(msg.value))
        raise ValueError(f"message outside universe: {msg!r}")

    # -- encode ------------------------------------------------------------

    def encode(self, state) -> np.ndarray:
        vec = np.zeros(self.width, dtype=np.uint32)
        server_value = state.actor_states[0].state
        lane0 = self._value_code(server_value)
        for j, c in enumerate(self.clients):
            cs = state.actor_states[c]
            if cs.awaiting == c and cs.op_count == 1:
                phase = 0
            elif cs.awaiting == 2 * c and cs.op_count == 2:
                phase = 1
            elif cs.awaiting is None and cs.op_count == 3:
                phase = 2
            else:
                raise ValueError(f"client state outside universe: {cs!r}")
            lane0 |= phase << (2 + 2 * j)
        vec[0] = lane0
        lane1 = 0
        for j, c in enumerate(self.clients):
            hphase, rv, snap = self._history_fields(state.history, c)
            lane1 |= (hphase | (rv << 2) | (snap << 4)) << (6 * j)
        vec[1] = lane1
        for env, count in Counter(state.network.iter_all()).items():
            if count != 1:
                raise ValueError(
                    f"envelope multiplicity {count} outside universe"
                )
            k = self.index.get(
                self._msg_key(int(env.src), int(env.dst), env.msg)
            )
            if k is None:
                raise ValueError(f"envelope outside universe: {env!r}")
            vec[2] |= np.uint32(1 << k)
        if any(state.crashed) or any(t for t in state.timers_set):
            raise ValueError("crashes/timers outside the universe")
        return vec

    def _history_fields(self, history, c: int) -> Tuple[int, int, int]:
        if not history.is_valid:
            raise ValueError("invalid history outside universe")
        thread = Id(c)
        peer = (Id(self.clients[1 - self.clients.index(c)])
                if self.C == 2 else None)
        completed = dict(history.history_by_thread).get(thread, ())
        in_flight = dict(history.in_flight_by_thread).get(thread)
        j = self.clients.index(c)
        wv = self.values[j]

        def check_w(entry):
            snap, op = entry[0], entry[1]
            if snap != () or not isinstance(op, WriteOp) or op.value != wv:
                raise ValueError(f"history outside universe: {entry!r}")

        def snap_code(snap) -> int:
            if snap == ():
                return 0
            if (
                self.C == 2
                and len(snap) == 1
                and snap[0][0] == peer
                and snap[0][1] in (0, 1)
            ):
                return snap[0][1] + 1
            raise ValueError(f"snapshot outside universe: {snap!r}")

        rv = 0
        snap = 0
        if len(completed) == 0 and in_flight is not None:
            check_w(in_flight)
            phase = 0
        elif len(completed) >= 1:
            check_w(completed[0])
            if not isinstance(completed[0][2], WriteOk):
                raise ValueError(f"history outside universe: {completed!r}")
            if len(completed) == 1 and in_flight is None:
                phase = 1
            elif len(completed) == 1:
                if not isinstance(in_flight[1], ReadOp):
                    raise ValueError(
                        f"history outside universe: {in_flight!r}"
                    )
                snap = snap_code(in_flight[0])
                phase = 2
            elif len(completed) == 2 and in_flight is None:
                s, op, ret = completed[1]
                if not isinstance(op, ReadOp) or not isinstance(ret, ReadOk):
                    raise ValueError(
                        f"history outside universe: {completed!r}"
                    )
                snap = snap_code(s)
                rv = self._value_code(ret.value)
                phase = 3
            else:
                raise ValueError(f"history outside universe: {completed!r}")
        else:
            raise ValueError(f"history outside universe: thread {c}")
        return phase, rv, snap

    def init_vecs(self) -> np.ndarray:
        return np.stack(
            [self.encode(s) for s in self.host_model.init_states()]
        )

    # -- linearizability truth table --------------------------------------

    def _tester_for(self, combos) -> Optional[LinearizabilityTester]:
        """Directly construct the tester state for per-client
        (phase, rv, snap) triples; None if structurally impossible."""
        history = {}
        in_flight = {}
        for j, (phase, rv, snap) in enumerate(combos):
            t = Id(self.clients[j])
            peer = (
                Id(self.clients[1 - j]) if self.C == 2 else None
            )
            wv = self.values[j]
            snap_t = () if snap == 0 else ((peer, snap - 1),)
            if snap != 0 and peer is None:
                return None
            w_done = ((), WriteOp(wv), WriteOk())
            if phase == 0:
                history[t] = ()
                in_flight[t] = ((), WriteOp(wv))
            elif phase == 1:
                if rv or snap:
                    return None
                history[t] = (w_done,)
            elif phase == 2:
                if rv:
                    return None
                history[t] = (w_done,)
                in_flight[t] = (snap_t, ReadOp())
            else:
                if rv > len(self.values):
                    return None  # a read of a value no client wrote
                v = "\x00" if rv == 0 else self.values[rv - 1]
                history[t] = (
                    w_done,
                    (snap_t, ReadOp(), ReadOk(v)),
                )
        return LinearizabilityTester(
            init_ref_obj=Register("\x00"),
            history_by_thread=tuple(sorted(history.items())),
            in_flight_by_thread=tuple(sorted(in_flight.items())),
        )

    def _build_lin_table(self) -> np.ndarray:
        size = 36 ** self.C
        table = np.zeros(size, dtype=bool)
        for combo in itertools.product(
            range(4), range(3), range(3), repeat=self.C
        ):
            triples = [
                (combo[3 * j], combo[3 * j + 1], combo[3 * j + 2])
                for j in range(self.C)
            ]
            idx = 0
            for ph, rv, sn in triples:
                idx = idx * 36 + (ph * 3 + rv) * 3 + sn
            tester = self._tester_for(triples)
            table[idx] = (
                tester is not None
                and tester.serialized_history() is not None
            )
        return table

    # -- device step -------------------------------------------------------

    def _client_fields(self, states_t, j):
        phase = (states_t[0] >> (2 + 2 * j)) & 3
        h = (states_t[1] >> (6 * j)) & 0x3F
        return phase, h & 3, (h >> 2) & 3, h >> 4

    def _net(self, states_t, k):
        return ((states_t[2] >> k) & 1) != 0

    def step_cols(self, states_t: torch.Tensor) -> tuple:
        """The dense step (JAX ``step_vec``): ``[3, N] -> (succ [3, N,
        K], valid bool[N, K], None)``, one slot per envelope of the
        universe (:meth:`_deliver`)."""
        succs, valids = [], []
        for k, env in enumerate(self.universe):
            lanes, valid = self._deliver(states_t, k, env)
            succs.append(lanes)
            valids.append(valid)
        return (*stack_slots(succs, valids), None)

    def _deliver(self, states_t, k, env):
        """The successor lanes of delivering envelope ``k`` to every
        state, and whether it is deliverable and handled there."""
        src, dst, kind, arg = env
        v0, v1, v2 = states_t[0], states_t[1], states_t[2]
        present = self._net(states_t, k)
        net = v2 & ~(1 << k)
        if kind == "put":
            # Server: set value, reply PutOk (always handled).
            ok_bit = self.index[(0, src, "putok", arg)]
            return [(v0 & ~3) | arg, v1, net | (1 << ok_bit)], present
        if kind == "get":
            value = v0 & 3
            reply = net
            for v in range(self.P + 1):
                bit = self.index[(0, src, "getok", v)]
                reply = reply | torch.where(value == v, 1 << bit, 0)
            return [v0, v1, reply], present
        j = self.clients.index(dst)
        phase, _hphase, _rv, snap = self._client_fields(states_t, j)
        if kind == "putok":
            handled = phase == 0
            new0 = (v0 & ~(3 << (2 + 2 * j))) | (1 << (2 + 2 * j))
            # History: W returns, R invoked; the snapshot records the
            # peer's completed-op count right now.
            if self.C == 2:
                _, peer_h, _, _ = self._client_fields(states_t, 1 - j)
                peer_done = torch.where(
                    peer_h == 0, 0, torch.where(peer_h == 3, 2, 1))
            else:
                peer_done = 0
            h = 2 | (peer_done << 4)  # phase 2, rv 0
            new1 = (v1 & ~(0x3F << (6 * j))) | (h << (6 * j))
            # The client follows up with its Get (register.rs:144-236).
            get_bit = self.index[(dst, 0, "get", 0)]
            net = net | torch.where(handled, 1 << get_bit, 0)
            return ([torch.where(handled, new0, v0),
                     torch.where(handled, new1, v1), net],
                    present & handled)
        if kind == "getok":
            handled = phase == 1
            new0 = (v0 & ~(3 << (2 + 2 * j))) | (2 << (2 + 2 * j))
            h = 3 | (arg << 2) | (snap << 4)
            new1 = (v1 & ~(0x3F << (6 * j))) | (h << (6 * j))
            return ([torch.where(handled, new0, v0),
                     torch.where(handled, new1, v1), net],
                    present & handled)
        raise AssertionError(kind)

    # -- properties --------------------------------------------------------

    def property_conditions_cols(self,
                                 states_t: torch.Tensor) -> torch.Tensor:
        """``bool[N, 2]``: [always linearizable (the truth table), sometimes
        value chosen] — order matches the host model's properties()."""
        dev = states_t.device
        if dev not in self._lin_dev:
            self._lin_dev[dev] = torch.from_numpy(self._lin_table).to(dev)
        idx = torch.zeros_like(states_t[0])
        for j in range(self.C):
            _, hphase, rv, snap = self._client_fields(states_t, j)
            idx = idx * 36 + (hphase * 3 + rv) * 3 + snap
        # The envelope universe is closed (held by the exhaustive
        # per-state differential test), so no poison guard is needed.
        table = self._lin_dev[dev]
        linearizable = table[idx.clamp(max=table.numel() - 1)]
        chosen = torch.zeros_like(linearizable)
        for v in range(1, self.P + 1):
            for c in self.clients:
                chosen = chosen | self._net(states_t,
                                            self.index[(0, c, "getok", v)])
        return torch.stack([linearizable, chosen], dim=1)
