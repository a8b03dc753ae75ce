"""Vectorized single-decree Paxos: the Paxos hand encoding in PyTorch.

The port of ``stateright_tpu.models.paxos_tpu``. The host half is
copied: the ballot universe and its coexistence closure, the envelope
universe, ``encode`` / ``init_vecs``, the linearizability truth table
(built by the real serializer) and the sparse-dispatch tables. The
device half is written as batched torch over lane-major ``[W, N]``
int64 blocks (see encoding.py) instead of per-state functions under
``vmap``: :meth:`PaxosEncoded.enabled_bits_cols`,
:meth:`PaxosEncoded.step_slot_cols` and
:meth:`PaxosEncoded.property_conditions_cols` (sparse dispatch), and
the dense :meth:`PaxosEncoded.step_cols` with its per-kind ``_on_*``
handlers.

The encoding packs the full actor-model state of
:mod:`stateright_tpu_torch.models.paxos` (reference examples/paxos.rs +
actor/model_state.rs) — the three servers' ``PaxosState``s, the
register clients, the unordered-nonduplicating network and the
in-state ``LinearizabilityTester`` history — into ``uint32`` lanes:

1. **The envelope universe is finite and small**, and every envelope
   is one bit of the network lanes (the multiset degenerates to a set:
   every multiplicity is 1). Delivering envelope k is action slot k,
   with src, dst and message content host constants.
2. **History phases.** Each client's tester state is one of
   ``W in-flight → W done + R in-flight → W+R done`` plus the value
   read, so two bits of phase and a read-value code per client encode
   the tester exactly.
3. **The linearizability verdict is a truth table** over those
   per-client codes, filled host-side by the real serializer, so the
   device-side ``always linearizable`` condition is one gather.

Unreachable-by-proof code paths (a Put at a round past the leader
count, an out-of-universe ``last_accepted``) set a poison bit
(``_B_POISON``, on client lane 0) that perturbs the fingerprint and
fails "linearizable"; ``encode()`` raises on any host state outside
the bounded universe.

The lanes are uint32 values carried in int64. The JAX version relies
on uint32 wraparound: left shifts past bit 31 drop the high bits, and
subtractions below 0 wrap. Here every lane is masked to 32 bits
(``_M32``) before it leaves a device function, a field write masks its
value to the field's width, and every intermediate that can leave
``[0, 2**32)`` is masked before a ``%``, a right shift or a comparison
(torch's ``%`` on a negative int64 is a floor modulo, not uint32 wrap
followed by a modulo).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..actor import Id
from ..actor.register import Get, GetOk, Internal, Put, PutOk
from ..encoding import EncodedModelBase, stack_slots
from ..ops.bitmask import (
    const_words,
    mask_words,
    or_class_words,
    select_words_host,
    slot_mask_host,
)
from ..semantics.register import ReadOk, ReadOp, WriteOk, WriteOp
from .paxos import (
    Accept,
    Accepted,
    Decided,
    PaxosModelCfg,
    Prepare,
    Prepared,
    paxos_model,
)

# -- lane layout ---------------------------------------------------------
# The layout is COMPUTED per configuration (bit widths grow with the
# client count): each server gets a main lane [ballot enum | proposal
# code | accepted la-code | is_decided | accepts id-mask | prepares]
# and, when the prepares map no longer fits (client_count=4), a second
# per-server lane holding prepares alone. The client/history lane packs
# per client j at bit j*stride:
#   +0 (2b)     actor phase: 0 awaiting PutOk, 1 awaiting GetOk, 2 done
#   +2 (2b)     history phase: 0 W-inflight, 1 W-done, 2 +R-inflight,
#               3 done
#   +4 (W_RV b) read value code (0 '\x00', 1+ value index)
_B_POISON = 30


def _bits(n: int) -> int:
    """Bits to hold values 0..n."""
    return max(1, n.bit_length())


#: uint32 lanes carried in int64: the mask every lane leaves under
_M32 = 0xFFFFFFFF


def _fget(lane, shift, width: int):
    """Field ``width`` bits wide at ``shift`` (an int or a per-pair
    tensor; a shift of 32 or more reads 0, as XLA's uint32 shift)."""
    return (lane >> shift) & ((1 << width) - 1)


def _fset(lane, shift, width: int, value):
    """``lane`` with the field at ``shift`` set to ``value`` masked to
    ``width`` bits, and the result masked to 32 bits: what a uint32
    shift would carry past bit 31 is dropped, and a negative ``value``
    (a uint32 subtraction that wrapped) writes the same low bits."""
    wmask = (1 << width) - 1
    if not torch.is_tensor(value):
        value = torch.full_like(lane, value)
    if torch.is_tensor(shift):
        mask = torch.full_like(shift, wmask) << shift
    else:
        mask = wmask << shift
    return ((lane & ~mask) | ((value & wmask) << shift)) & _M32


def _one_shl(shift: torch.Tensor) -> torch.Tensor:
    """``1 << shift`` per pair."""
    return torch.ones_like(shift) << shift



@dataclass(frozen=True)
class EnvSpec:
    """One envelope of the bounded universe; all fields are host-side
    constants folded into the compiled transition."""

    src: int
    dst: int
    kind: str  # put|get|putok|getok|prepare|prepared|accept|accepted|decided
    ballot: int = 0      # ballot enum
    prop: int = 0        # proposal code
    la: int = 0          # last_accepted la-code (prepared)
    value: int = 0       # value code (getok)


class PaxosEncoded(EncodedModelBase):
    """The Paxos encoding for ``paxos_model(PaxosModelCfg(...))``.

    Supports the reference benchmark shapes: 3 servers, 1 put per
    client, 1-5 clients (``paxos check N``, examples/paxos.rs:352-465;
    2c/3s pinned at 16,668, paxos.rs:325). The lane layout, ballot
    universe, and coexistence closure are computed per configuration —
    client_count=4 puts two proposals on leader 0 and moves the
    prepares maps to dedicated per-server lanes (``two_lane``), and
    client_count=5 spills onto a second client lane.
    """

    def __init__(self, cfg: PaxosModelCfg, network=None):
        if cfg.server_count != 3 or cfg.put_count != 1:
            raise ValueError(
                "PaxosEncoded supports server_count=3, put_count=1 "
                f"(got {cfg})"
            )
        if not (1 <= cfg.client_count <= 5):
            raise ValueError(
                f"PaxosEncoded supports 1-5 clients (got {cfg.client_count})"
            )
        if network is not None and type(network).__name__ != (
            "UnorderedNonDuplicating"
        ):
            raise ValueError(
                "PaxosEncoded models the unordered non-duplicating network"
            )
        self.cfg = cfg
        self.S = cfg.server_count
        self.C = cfg.client_count
        self.clients = list(range(self.S, self.S + self.C))
        self.host_model = paxos_model(cfg)

        # Proposals: client i's single put (req_id=i, requester=i,
        # value chr(ord('A')+i-S)); code = 1 + index (req-id order).
        self.values = [chr(ord("A") + i - self.S) for i in self.clients]
        self.proposals = [
            (i, Id(i), self.values[j]) for j, i in enumerate(self.clients)
        ]
        self.P = len(self.proposals)

        # Ballots. Leaders = put-target servers (client i -> i % S);
        # with 4 clients on 3 servers, leader 0 serves two clients but
        # still Puts at most once (proposal-None guard), so each leader
        # owns exactly one put-ballot and rounds cap at the LEADER
        # count: a Put at round r requires the server to have adopted
        # some round-(r-1) ballot first, and the support chain
        # 1, 2, ..., r needs r distinct leaders.
        self.leaders = sorted({i % self.S for i in self.clients})
        ballots = [(r, l) for r in range(1, len(self.leaders) + 1)
                   for l in self.leaders]
        ballots.sort()
        #: ballot enum: 0 = initial (0, Id(0)); 1.. = sorted reachable
        self.ballots = ballots
        self.ballot_enum = {(0, Id(0)): 0}
        for n, (r, l) in enumerate(ballots):
            self.ballot_enum[(r, Id(l))] = n + 1
        self.NB = len(ballots)

        # Joint feasibility: an assignment round[l] (or None = l never
        # Put) is realizable iff every assigned round r >= 2 is
        # supported by some OTHER leader assigned exactly r-1. Two
        # ballots coexist iff some realizable assignment contains both
        # — computed by brute force over the <= (R+1)^|leaders|
        # assignments instead of a hand-derived pair rule (the round-2
        # rule was specific to two leaders).
        import itertools as _it

        R = len(self.leaders)
        feasible_pairs: set = set()
        for rounds_assign in _it.product(
            [None] + list(range(1, R + 1)), repeat=R
        ):
            ok = True
            for l_idx, r in enumerate(rounds_assign):
                if r is not None and r >= 2 and not any(
                    r2 == r - 1
                    for l2_idx, r2 in enumerate(rounds_assign)
                    if l2_idx != l_idx and r2 is not None
                ):
                    ok = False
                    break
            if not ok:
                continue
            assigned = [
                self.ballot_enum[(r, Id(self.leaders[l_idx]))]
                for l_idx, r in enumerate(rounds_assign)
                if r is not None
            ]
            for b1 in assigned:
                for b2 in assigned:
                    feasible_pairs.add((b1, b2))

        def coexists(b1: int, b2: int) -> bool:
            """May ballot enums b1 < b2 both exist in one run?"""
            return (b1, b2) in feasible_pairs

        # choosable(b): proposals a leader can drive under ballot b —
        # its own put, or any adoptable last_accepted from a lower
        # coexisting ballot (closure).
        own_prop = {}
        for j, i in enumerate(self.clients):
            own_prop.setdefault(i % self.S, []).append(j + 1)
        choosable: dict[int, set] = {}
        la_universe: dict[int, list] = {}
        for b in range(1, self.NB + 1):
            _, l = ballots[b - 1]
            ch = set(own_prop.get(l, []))
            las = [0]
            for b2 in range(1, b):
                if coexists(b2, b):
                    for p in sorted(choosable[b2]):
                        las.append(1 + (b2 - 1) * self.P + (p - 1))
                        ch.add(p)
            choosable[b] = ch
            la_universe[b] = las
        self.choosable = {b: sorted(ch) for b, ch in choosable.items()}
        self.la_universe = la_universe

        # -- computed lane layout (widths scale with NB and P) -----------
        la_max = self.NB * self.P          # la codes 0..la_max
        self.W_BALLOT = _bits(self.NB)
        self.W_PROP = _bits(self.P)
        self.W_ACC = _bits(la_max)
        self.W_ACCEPTS = self.S
        self.W_PREP = _bits(1 + la_max)    # prepares entry: 0 | 1+la
        self.B_BALLOT = 0
        self.B_PROP = self.B_BALLOT + self.W_BALLOT
        self.B_ACC = self.B_PROP + self.W_PROP
        self.B_DEC = self.B_ACC + self.W_ACC
        self.B_ACCEPTS = self.B_DEC + 1
        main_bits = self.B_ACCEPTS + self.W_ACCEPTS
        # prepares ride in the main lane when they fit, else each
        # server gets a dedicated prepares lane (client_count=4).
        self.two_lane = main_bits + self.S * self.W_PREP > 32
        self.B_PREP = 0 if self.two_lane else main_bits
        #: client/history lane stride and read-value width
        self.W_RV = _bits(self.P)
        self.CST = 4 + self.W_RV
        #: clients per client-lane (bit 30 of lane 0 is the poison
        #: bit); 5 clients spill onto a second client lane.
        self.CPL = _B_POISON // self.CST
        self.n_client_lanes = -(-self.C // self.CPL)
        #: linearizability-table radix per client: phase * TBV + rv
        self.TBV = self.P + 1
        self.TB = 4 * self.TBV

        self.universe = self._build_universe()
        self.index = {self._env_key(e): k for k, e in enumerate(self.universe)}
        self.K = len(self.universe)
        self.net_lanes = mask_words(self.K)
        self.n_state_lanes = (
            self.S * (2 if self.two_lane else 1) + self.n_client_lanes
        )
        self.width = self.n_state_lanes + self.net_lanes
        self.max_actions = self.K
        self._lin_table = self._build_lin_table()

    def cache_key(self):
        """The JAX encoding's identity, so that a snapshot's encoding
        fingerprint (checkpoint.py) is equal across the two packages."""
        return (self.C, self.S, self.cfg.put_count)

    # -- computed-layout accessors ----------------------------------------

    def _clane_index(self, j: int = 0) -> int:
        """Lane of client j's fields (j // CPL picks the client lane);
        the poison bit lives on client lane 0."""
        return self.S * (2 if self.two_lane else 1) + j // self.CPL

    def _coff(self, j: int) -> int:
        """Bit offset of client j inside its client lane."""
        return (j % self.CPL) * self.CST

    def _prep_lane(self, server: int) -> int:
        return self.S + server if self.two_lane else server

    # -- universe ----------------------------------------------------------

    def _build_universe(self) -> list:
        u: list[EnvSpec] = []
        S, P = self.S, self.P
        # Puts and Gets (register.rs:144-236 request scheme).
        for j, c in enumerate(self.clients):
            u.append(EnvSpec(c, c % S, "put", prop=j + 1))
        for j, c in enumerate(self.clients):
            u.append(EnvSpec(c, (c + 1) % S, "get"))
        # PutOk from any leader that can drive this client's proposal.
        for l in self.leaders:
            for j, c in enumerate(self.clients):
                if any(j + 1 in self.choosable[b]
                       for b in range(1, self.NB + 1)
                       if self.ballots[b - 1][1] == l):
                    u.append(EnvSpec(l, c, "putok", prop=j + 1))
        # GetOk from the get-target server, any decided value.
        for j, c in enumerate(self.clients):
            for v in range(1, P + 1):
                u.append(EnvSpec((c + 1) % S, c, "getok", value=v))
        # Internal protocol messages.
        for b in range(1, self.NB + 1):
            _, l = self.ballots[b - 1]
            peers = [d for d in range(S) if d != l]
            for d in peers:
                u.append(EnvSpec(l, d, "prepare", ballot=b))
            for d in peers:
                for la in self.la_universe[b]:
                    u.append(EnvSpec(d, l, "prepared", ballot=b, la=la))
            for p in self.choosable[b]:
                for d in peers:
                    u.append(EnvSpec(l, d, "accept", ballot=b, prop=p))
            for d in peers:
                u.append(EnvSpec(d, l, "accepted", ballot=b))
            for p in self.choosable[b]:
                for d in peers:
                    u.append(EnvSpec(l, d, "decided", ballot=b, prop=p))
        return u

    def _env_key(self, e: EnvSpec) -> tuple:
        return (e.src, e.dst, e.kind, e.ballot, e.prop, e.la, e.value)

    # -- host <-> codes ----------------------------------------------------

    def _ballot_code(self, ballot: Tuple) -> int:
        code = self.ballot_enum.get((ballot[0], ballot[1]))
        if code is None:
            raise ValueError(f"ballot outside universe: {ballot!r}")
        return code

    def _prop_code(self, proposal: Optional[Tuple]) -> int:
        if proposal is None:
            return 0
        for j, p in enumerate(self.proposals):
            if p == proposal:
                return j + 1
        raise ValueError(f"proposal outside universe: {proposal!r}")

    def _la_code(self, la: Optional[Tuple]) -> int:
        if la is None:
            return 0
        b = self._ballot_code(la[0])
        p = self._prop_code(la[1])
        if b == 0 or p == 0:
            raise ValueError(f"last_accepted outside universe: {la!r}")
        return 1 + (b - 1) * self.P + (p - 1)

    def _value_code(self, value: str) -> int:
        if value == "\x00":
            return 0
        try:
            return 1 + self.values.index(value)
        except ValueError:
            raise ValueError(f"value outside universe: {value!r}")

    def _msg_env_key(self, src: int, dst: int, msg: Any) -> tuple:
        if isinstance(msg, Put):
            return (src, dst, "put", 0, self._prop_code((msg.req_id, Id(src), msg.value)), 0, 0)
        if isinstance(msg, Get):
            return (src, dst, "get", 0, 0, 0, 0)
        if isinstance(msg, PutOk):
            j = self.clients.index(msg.req_id)  # first-op req_id == client id
            return (src, dst, "putok", 0, j + 1, 0, 0)
        if isinstance(msg, GetOk):
            return (src, dst, "getok", 0, 0, 0, self._value_code(msg.value))
        if isinstance(msg, Internal):
            m = msg.msg
            if isinstance(m, Prepare):
                return (src, dst, "prepare", self._ballot_code(m.ballot), 0, 0, 0)
            if isinstance(m, Prepared):
                return (
                    src, dst, "prepared", self._ballot_code(m.ballot),
                    0, self._la_code(m.last_accepted), 0,
                )
            if isinstance(m, Accept):
                return (
                    src, dst, "accept", self._ballot_code(m.ballot),
                    self._prop_code(m.proposal), 0, 0,
                )
            if isinstance(m, Accepted):
                return (src, dst, "accepted", self._ballot_code(m.ballot), 0, 0, 0)
            if isinstance(m, Decided):
                return (
                    src, dst, "decided", self._ballot_code(m.ballot),
                    self._prop_code(m.proposal), 0, 0,
                )
        raise ValueError(f"message outside universe: {msg!r}")

    # -- encode ------------------------------------------------------------

    def encode(self, state) -> np.ndarray:
        vec = np.zeros(self.width, dtype=np.uint32)
        for i in range(self.S):
            s = state.actor_states[i].state
            lane = 0
            lane |= self._ballot_code(s.ballot) << self.B_BALLOT
            lane |= self._prop_code(s.proposal) << self.B_PROP
            lane |= self._la_code(s.accepted) << self.B_ACC
            lane |= (1 if s.is_decided else 0) << self.B_DEC
            mask = 0
            for sid in s.accepts:
                mask |= 1 << int(sid)
            lane |= mask << self.B_ACCEPTS
            prep = 0
            for sid, la in s.prepares.items():
                prep |= (1 + self._la_code(la)) << (
                    self.B_PREP + self.W_PREP * int(sid)
                )
            if self.two_lane:
                vec[self._prep_lane(i)] = prep
                vec[i] = lane
            else:
                vec[i] = lane | prep
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
            hphase, rval = self._history_phase(state.history, Id(c))
            off = self._coff(j)
            vec[self._clane_index(j)] |= np.uint32(
                (phase << off) | (hphase << (off + 2))
                | (rval << (off + 4))
            )
        for env, count in self._network_items(state.network):
            if count != 1:
                raise ValueError(
                    f"envelope multiplicity {count} outside universe: {env!r}"
                )
            key = self._msg_env_key(int(env.src), int(env.dst), env.msg)
            k = self.index.get(key)
            if k is None:
                raise ValueError(f"envelope outside universe: {env!r}")
            vec[self.n_state_lanes + k // 32] |= np.uint32(1 << (k % 32))
        if any(state.crashed) or any(t for t in state.timers_set):
            raise ValueError("crashes/timers outside the paxos universe")
        return vec

    def _network_items(self, network):
        from collections import Counter

        return Counter(network.iter_all()).items()

    def _history_phase(self, history, thread: Id) -> tuple[int, int]:
        if not history.is_valid:
            raise ValueError("invalid history outside universe")
        completed = dict(history.history_by_thread).get(thread, ())
        in_flight = dict(history.in_flight_by_thread).get(thread)
        j = self.clients.index(int(thread))
        wv = self.values[j]
        rval = 0
        if len(completed) == 0 and in_flight is not None:
            snap, op = in_flight
            if snap != () or not isinstance(op, WriteOp) or op.value != wv:
                raise ValueError(f"history outside universe: {in_flight!r}")
            phase = 0
        elif len(completed) >= 1:
            snap, op, ret = completed[0]
            if (
                snap != ()
                or not isinstance(op, WriteOp)
                or op.value != wv
                or not isinstance(ret, WriteOk)
            ):
                raise ValueError(f"history outside universe: {completed!r}")
            if len(completed) == 1 and in_flight is None:
                phase = 1
            elif len(completed) == 1:
                snap, op = in_flight
                if snap != () or not isinstance(op, ReadOp):
                    raise ValueError(f"history outside universe: {in_flight!r}")
                phase = 2
            elif len(completed) == 2 and in_flight is None:
                snap, op, ret = completed[1]
                if snap != () or not isinstance(op, ReadOp) or not isinstance(ret, ReadOk):
                    raise ValueError(f"history outside universe: {completed!r}")
                phase = 3
                rval = self._value_code(ret.value)
            else:
                raise ValueError(f"history outside universe: {completed!r}")
        else:
            raise ValueError(f"history outside universe: thread {thread!r}")
        return phase, rval

    def init_vecs(self) -> np.ndarray:
        return np.stack(
            [self.encode(s) for s in self.host_model.init_states()]
        )

    # -- linearizability truth table --------------------------------------

    def _build_lin_table(self) -> np.ndarray:
        """Evaluate the REAL serializer on every (phase, rval) combo.

        Reachable states have at most one client past phase 0 (only one
        proposal is ever decided); combos with both clients progressed
        are marked not-linearizable so that, were one ever produced,
        it would surface as a loud counterexample rather than pass
        silently.
        """
        from ..semantics import LinearizabilityTester, Register

        size = self.TB ** self.C
        table = np.zeros(size, dtype=bool)

        def fill(phases, rvals):
            idx = 0
            for ph, rv in zip(phases, rvals):
                idx = idx * self.TB + ph * self.TBV + rv
            tester = LinearizabilityTester(Register("\x00"))
            for j in range(self.C):
                tester = tester.on_invoke(
                    Id(self.clients[j]), WriteOp(self.values[j])
                )
            for j in range(self.C):
                t = Id(self.clients[j])
                ph, rv = phases[j], rvals[j]
                if ph >= 1:
                    tester = tester.on_return(t, WriteOk())
                if ph >= 2:
                    tester = tester.on_invoke(t, ReadOp())
                if ph >= 3:
                    v = "\x00" if rv == 0 else self.values[rv - 1]
                    tester = tester.on_return(t, ReadOk(v))
            table[idx] = tester.serialized_history() is not None

        # Only all-zero and single-progressed combos can be reached
        # (single decree: one proposal is ever decided, so one client
        # ever advances); everything else stays False so it would
        # surface as a loud counterexample — and the fill is C*12
        # serializer runs instead of (4*TBV)^C (8M at 5 clients).
        fill([0] * self.C, [0] * self.C)
        for j in range(self.C):
            for ph in (1, 2, 3):
                for rv in range(self.TBV):
                    phases = [0] * self.C
                    rvals = [0] * self.C
                    phases[j] = ph
                    rvals[j] = rv
                    fill(phases, rvals)
        return table

    # -- sparse action dispatch tables ---------------------------------------
    #
    # The sparse contract gives the engine (a) a cheap per-slot enabled
    # predicate — the envelope's presence bit AND the handler's guard,
    # which for every paxos handler is a small function of the DST
    # actor's fields — and (b) a table-driven per-pair transition where
    # every per-slot constant of the reference handlers becomes a gather
    # by slot index. Send masks unify into one [K*SEL]-row table indexed
    # by (slot, selector): the selector is the single state-dependent
    # value each handler's send depends on (put: dst's ballot enum; get:
    # read value; prepare: acceptor's accepted code; prepared: chosen
    # proposal; accepted: leader's proposal).

    _KINDS = (
        "put", "get", "putok", "getok", "prepare", "prepared", "accept",
        "accepted", "decided",
    )

    def _const_mask(self, keys) -> dict:
        """Per-lane OR mask for a set of universe keys (host consts)."""
        masks: dict[int, int] = {}
        for key in keys:
            k = self.index[key]
            masks[k // 32] = masks.get(k // 32, 0) | (1 << (k % 32))
        return masks

    def _sparse_tables(self) -> dict:
        if hasattr(self, "_sp"):
            return self._sp
        K, S, P, NB = self.K, self.S, self.P, self.NB
        la_max = NB * P
        SEL = max(NB, P, la_max) + 1
        kindno = {k: n for n, k in enumerate(self._KINDS)}
        kind = np.zeros(K, np.uint32)
        dst = np.zeros(K, np.uint32)
        src = np.zeros(K, np.uint32)
        ballot = np.zeros(K, np.uint32)
        prop = np.zeros(K, np.uint32)
        la = np.zeros(K, np.uint32)
        value = np.zeros(K, np.uint32)
        dst_srv = np.zeros(K, np.uint32)
        dst_cli = np.zeros(K, np.uint32)
        prep_lane = np.zeros(K, np.uint32)
        send = np.zeros((K * SEL, self.net_lanes), np.uint32)
        poison = np.zeros(K * SEL, np.uint32)
        aux = np.zeros(K * SEL, np.uint32)

        def orkey(row: int, key: tuple) -> None:
            kk = self.index[key]
            send[row, kk // 32] |= np.uint32(1 << (kk % 32))

        for k, e in enumerate(self.universe):
            kind[k] = kindno[e.kind]
            dst[k], src[k] = e.dst, e.src
            ballot[k], prop[k], la[k], value[k] = (
                e.ballot, e.prop, e.la, e.value,
            )
            dst_srv[k] = min(e.dst, S - 1)
            dst_cli[k] = (
                self.clients.index(e.dst) if e.dst in self.clients else 0
            )
            prep_lane[k] = self._prep_lane(int(dst_srv[k]))
            row0 = k * SEL
            if e.kind == "put":
                rounds = sorted(r for (r, l) in self.ballots if l == e.dst)
                round_of = [0] + [r for (r, _) in self.ballots]
                for sel in range(NB + 1):
                    nr = round_of[sel] + 1
                    if nr in rounds:
                        b = self.ballot_enum[(nr, Id(e.dst))]
                        aux[row0 + sel] = b
                        for d in range(S):
                            if d != e.dst:
                                orkey(
                                    row0 + sel,
                                    (e.dst, d, "prepare", b, 0, 0, 0),
                                )
                    else:
                        poison[row0 + sel] = 1
            elif e.kind == "get":
                for v in range(1, P + 1):
                    key = (e.dst, e.src, "getok", 0, 0, 0, v)
                    if key in self.index:
                        orkey(row0 + v, key)
            elif e.kind == "putok":
                orkey(
                    row0, (e.dst, (e.dst + 1) % S, "get", 0, 0, 0, 0)
                )
            elif e.kind == "prepare":
                las = set(self.la_universe[e.ballot])
                for sel in range(la_max + 1):
                    if sel in las:
                        orkey(
                            row0 + sel,
                            (e.dst, e.src, "prepared", e.ballot, 0, sel, 0),
                        )
                    else:
                        poison[row0 + sel] = 1
            elif e.kind == "prepared":
                ch = set(self.choosable[e.ballot])
                for sel in range(P + 1):
                    if sel in ch:
                        for d in range(S):
                            if d != e.dst:
                                orkey(
                                    row0 + sel,
                                    (e.dst, d, "accept", e.ballot, sel,
                                     0, 0),
                                )
                    else:
                        poison[row0 + sel] = 1
            elif e.kind == "accept":
                orkey(
                    row0, (e.dst, e.src, "accepted", e.ballot, 0, 0, 0)
                )
            elif e.kind == "accepted":
                ch = set(self.choosable[e.ballot])
                for sel in range(P + 1):
                    if sel in ch:
                        for d in range(S):
                            if d != e.dst:
                                orkey(
                                    row0 + sel,
                                    (e.dst, d, "decided", e.ballot, sel,
                                     0, 0),
                                )
                        orkey(
                            row0 + sel,
                            (e.dst, self.clients[sel - 1], "putok", 0,
                             sel, 0, 0),
                        )
                    else:
                        poison[row0 + sel] = 1
        # Pack per-slot params into ONE table row and the (slot, sel)
        # tables into another: a pair's fetches are two row gathers
        # instead of twelve scalar gathers.
        params = np.stack(
            [kind, dst_srv, dst_cli, src, ballot, prop, la, value,
             prep_lane],
            axis=1,
        )
        sendtab = np.concatenate(
            [send, poison[:, None], aux[:, None]], axis=1
        )
        self._sp = dict(SEL=SEL, params=params, sendtab=sendtab)
        return self._sp

    def _bits_word_tables(self) -> dict:
        """Host-constant guard-CLASS masks for the word-native enabled
        predicate (ops/bitmask.py builders): each slot's handler guard
        depends on host constants (kind, dst, ballot) and a SMALL
        state-dependent selector of its destination actor — so slots
        group into classes sharing one enabling condition, and the
        packed mask is an OR of condition-gated class masks instead of
        a per-slot evaluation."""
        if hasattr(self, "_bw"):
            return self._bw
        K, S, NB = self.K, self.S, self.NB
        get_s = {d: [] for d in range(S)}
        put_s = {d: [] for d in range(S)}
        dec_s = {d: [] for d in range(S)}
        bal_s = {d: [[] for _ in range(NB + 1)] for d in range(S)}
        putok_c = {j: [] for j in range(self.C)}
        getok_c = {j: [] for j in range(self.C)}
        for k, e in enumerate(self.universe):
            if e.kind == "put":
                put_s[e.dst].append(k)
            elif e.kind == "get":
                get_s[e.dst].append(k)
            elif e.kind == "putok":
                putok_c[self.clients.index(e.dst)].append(k)
            elif e.kind == "getok":
                getok_c[self.clients.index(e.dst)].append(k)
            elif e.kind == "decided":
                dec_s[e.dst].append(k)
            else:
                # Ballot-relation kinds, all guarded by ~decided[dst]:
                # tabulate, per destination server and per possible
                # adopted-ballot value v, the slots whose relation
                # holds — the runtime then SELECTS one [L]-word row by
                # the server's ballot field.
                bt = e.ballot
                for v in range(NB + 1):
                    if (
                        (e.kind == "prepare" and v < bt)
                        or (e.kind == "prepared" and v == bt)
                        or (e.kind == "accept" and v <= bt)
                        or (e.kind == "accepted" and v == bt)
                    ):
                        bal_s[e.dst][v].append(k)
        self._bw = dict(
            # decided-kind slots merge into every ballot row: both are
            # gated by ~decided[dst], so one select covers them.
            nd={
                d: tuple(
                    slot_mask_host(K, bal_s[d][v] + dec_s[d])
                    for v in range(NB + 1)
                )
                for d in range(S)
            },
            get={d: slot_mask_host(K, get_s[d]) for d in range(S)},
            put={d: slot_mask_host(K, put_s[d]) for d in range(S)},
            putok={j: slot_mask_host(K, putok_c[j])
                   for j in range(self.C)},
            getok={j: slot_mask_host(K, getok_c[j])
                   for j in range(self.C)},
        )
        return self._bw

    def _device_consts(self, device) -> dict:
        """The host tables as tensors on ``device``, made once per
        device: the per-slot params, the (slot, selector) send table,
        the guard-class words, the linearizability truth table and the
        "value chosen" mask. (A table copied to the card inside a wave
        would stall the stream once a copy.)"""
        device = torch.device(device)
        cache = self.__dict__.setdefault("_dev", {})
        if device in cache:
            return cache[device]
        sp, bw = self._sparse_tables(), self._bits_word_tables()

        def words(w):
            return const_words(w, device)

        chosen = [0] * self.net_lanes
        for ln, m in self._const_mask([
            self._env_key(e) for e in self.universe
            if e.kind == "getok" and e.value != 0
        ]).items():
            chosen[ln] = m
        cache[device] = dict(
            params=torch.from_numpy(sp["params"].astype(np.int64)).to(device),
            sendtab=torch.from_numpy(
                sp["sendtab"].astype(np.int64)).to(device),
            nd=[words(bw["nd"][d]) for d in range(self.S)],
            put=[words(bw["put"][d]) for d in range(self.S)],
            get=[words(bw["get"][d]) for d in range(self.S)],
            putok=[words(bw["putok"][j]) for j in range(self.C)],
            getok=[words(bw["getok"][j]) for j in range(self.C)],
            lin=torch.from_numpy(self._lin_table).to(device),
            chosen=words(tuple(chosen)),
        )
        return cache[device]

    # -- device functions (SparseEncodedModel) -------------------------------

    def enabled_bits_cols(self, states_t: torch.Tensor) -> torch.Tensor:
        """``[W, N] -> int64[N, ceil(K/32)]`` packed enabled mask, built
        word-native: the net lanes already hold the envelope presence
        bitmap in the ops/bitmask.py layout (slot k at bit k%32 of word
        k//32), and the handler guard assembles from O(S + C) condition-
        gated host-constant class masks plus one ballot-selected row per
        server. No dense ``bool[K]`` is built."""
        c = self._device_consts(states_t.device)
        handled = None
        for d in range(self.S):
            lane = states_t[d]
            dec = _fget(lane, self.B_DEC, 1) != 0
            bal = _fget(lane, self.B_BALLOT, self.W_BALLOT)
            # Undecided guards: the ballot-relation row selected by
            # this server's adopted ballot (decided-kind bits ride the
            # same rows), plus its put slots when no proposal is open.
            w = select_words_host(c["nd"][d], bal)
            if any(self._bits_word_tables()["put"][d]):
                prp = _fget(lane, self.B_PROP, self.W_PROP)
                w = w | torch.where((prp == 0)[:, None], c["put"][d], 0)
            w = torch.where(dec[:, None], c["get"][d], w)
            handled = w if handled is None else handled | w
        cls = []
        for j in range(self.C):
            ph = _fget(states_t[self._clane_index(j)], self._coff(j), 2)
            cls += [(ph == 0, c["putok"][j]), (ph == 1, c["getok"][j])]
        handled = handled | or_class_words(cls, self.net_lanes)
        return states_t[self.n_state_lanes:].T & handled

    def step_slot_cols(self, states_t: torch.Tensor,
                       slots: torch.Tensor) -> tuple:
        """Successors of (state, enabled slot) pairs, ``[W, N]``, and no
        truncation flags (``None, None``): every
        per-slot constant of the reference handlers is a table gather,
        every branch a select — one straight-line program over the
        batch. The output is a ``torch.stack`` of per-lane selects; no
        lane is written through an index into the input."""
        c = self._device_consts(states_t.device)
        SEL = self._sparse_tables()["SEL"]
        P, S, L = self.P, self.S, self.net_lanes
        vec = states_t
        slot = slots.to(torch.int64)
        kind, dsrv, dcli, src, bt, pt, lat, vt, pl_idx = (
            c["params"][slot].unbind(1))

        is_put = kind == 0
        is_get = kind == 1
        is_putok = kind == 2
        is_getok = kind == 3
        is_prepare = kind == 4
        is_prepared = kind == 5
        is_accept = kind == 6
        is_accepted = kind == 7
        is_decided = kind == 8

        # The dst server's lanes and the dst client's lane, by selects.
        lane = vec[0]
        for j in range(1, S):
            lane = torch.where(dsrv == j, vec[j], lane)
        if self.two_lane:
            plane = vec[S]
            for j in range(S + 1, 2 * S):
                plane = torch.where(pl_idx == j, vec[j], plane)
        else:
            plane = lane  # prepares share the main lane
        cl0 = self._clane_index(0)
        cl_rel = dcli // self.CPL
        clane = vec[cl0]
        for q in range(1, self.n_client_lanes):
            clane = torch.where(cl_rel == q, vec[cl0 + q], clane)
        dec = _fget(lane, self.B_DEC, 1) != 0
        bal = _fget(lane, self.B_BALLOT, self.W_BALLOT)
        prp = _fget(lane, self.B_PROP, self.W_PROP)
        acc = _fget(lane, self.B_ACC, self.W_ACC)
        accepts = _fget(lane, self.B_ACCEPTS, self.W_ACCEPTS)

        # prepared: record prepares[src] = 1 + la, majority fire. (The
        # shift passes bit 31 for a client src; such a pair never has
        # kind prepared, and the field write drops it as uint32 does.)
        new_plane = _fset(plane, self.B_PREP + self.W_PREP * src,
                          self.W_PREP, 1 + lat)
        entries = [_fget(new_plane, self.B_PREP + self.W_PREP * i,
                         self.W_PREP) for i in range(S)]
        pcount = sum((en != 0).to(torch.int64) for en in entries)
        fire = ~dec & (bal == bt) & (pcount == 2)
        best = torch.zeros_like(lane)
        for en in entries:
            best = torch.maximum(best, torch.where(en != 0, en - 1, 0))
        chosen = torch.where(best > 0, ((best - 1) & _M32) % P + 1, prp)

        # accepted: accepts |= 1 << src, majority fire.
        acc2 = accepts | _one_shl(src)
        acount = sum((acc2 >> i) & 1 for i in range(S))
        fire_acc = ~dec & (bal == bt) & (acount == 2)

        # get: value of the accepted proposal.
        val = torch.where(acc > 0, ((acc - 1) & _M32) % P + 1, 0)

        # Unified (slot, selector) tables: sends, poison, put's new
        # ballot. Gate: prepared/accepted send+poison only on fire.
        sel = torch.where(
            is_put, bal,
            torch.where(
                is_get, val,
                torch.where(
                    is_prepare, acc,
                    torch.where(is_prepared, chosen,
                                torch.where(is_accepted, prp, 0)),
                ),
            ),
        )
        gate = torch.where(is_prepared, fire,
                           torch.where(is_accepted, fire_acc, True))
        # an out-of-range row reads the last row, as JAX's clamped gather
        trow = (slot * SEL + sel).clamp(0, self.K * SEL - 1)
        srow = c["sendtab"][trow]
        send_row = torch.where(gate[:, None], srow[:, :L], 0)
        poison = gate & (srow[:, L] != 0)
        nb = srow[:, L + 1]

        # Per-kind server-lane updates (branchless, selected by kind).
        # The acc codes wrap below 0 for kinds without a ballot; only
        # their low bits reach a lane, through _fset's width mask.
        put_prep = ((acc + 1) << (self.W_PREP * dsrv)) & _M32
        put_lane = ((nb << self.B_BALLOT) | (pt << self.B_PROP)
                    | (acc << self.B_ACC)) & _M32
        prepare_lane = _fset(lane, self.B_BALLOT, self.W_BALLOT, bt)
        acc_code_cb = 1 + (bt - 1) * P + (chosen - 1)
        fired_lane = _fset(lane, self.B_PROP, self.W_PROP, chosen)
        fired_lane = _fset(fired_lane, self.B_ACC, self.W_ACC, acc_code_cb)
        fired_lane = _fset(fired_lane, self.B_ACCEPTS, self.W_ACCEPTS,
                           _one_shl(dsrv))
        prepared_lane = torch.where(fire, fired_lane, lane)
        acc_code_bp = 1 + (bt - 1) * P + (pt - 1)
        accept_lane = _fset(lane, self.B_BALLOT, self.W_BALLOT, bt)
        accept_lane = _fset(accept_lane, self.B_ACC, self.W_ACC, acc_code_bp)
        accepted_lane = _fset(lane, self.B_ACCEPTS, self.W_ACCEPTS, acc2)
        accepted_lane = torch.where(
            fire_acc, accepted_lane | (1 << self.B_DEC), accepted_lane)
        decided_lane = _fset(lane, self.B_BALLOT, self.W_BALLOT, bt)
        decided_lane = _fset(decided_lane, self.B_ACC, self.W_ACC,
                             acc_code_bp) | (1 << self.B_DEC)

        if not self.two_lane:
            # Prepares share the main lane: merge field updates.
            pmask = ((1 << (S * self.W_PREP)) - 1) << self.B_PREP
            put_lane = (put_lane | (put_prep << self.B_PREP)) & _M32
            prepared_lane = (prepared_lane & ~pmask) | (new_plane & pmask)
        srv_lane = lane
        srv_lane = torch.where(is_put, put_lane, srv_lane)
        srv_lane = torch.where(is_prepare, prepare_lane, srv_lane)
        srv_lane = torch.where(is_prepared, prepared_lane, srv_lane)
        srv_lane = torch.where(is_accept, accept_lane, srv_lane)
        srv_lane = torch.where(is_accepted, accepted_lane, srv_lane)
        srv_lane = torch.where(is_decided, decided_lane, srv_lane)

        # Client-lane updates (putok/getok) + the poison bit (which
        # always lives on client lane 0).
        cst = self.CST * (dcli % self.CPL)
        putok_clane = _fset(_fset(clane, cst, 2, 1), cst + 2, 2, 2)
        getok_clane = _fset(_fset(clane, cst, 2, 2), cst + 2, 2, 3)
        getok_clane = _fset(getok_clane, cst + 4, self.W_RV, vt)
        clane_upd = torch.where(
            is_putok, putok_clane,
            torch.where(is_getok, getok_clane, clane))
        upd = is_putok | is_getok

        lanes = []
        for j in range(self.n_state_lanes):
            lane_j = vec[j]
            if j < S:
                lane_j = torch.where(dsrv == j, srv_lane, lane_j)
            elif self.two_lane and j < 2 * S:
                plane_new = torch.where(
                    is_put, put_prep,
                    torch.where(is_prepared, new_plane, plane))
                lane_j = torch.where(pl_idx == j, plane_new, lane_j)
            if j >= cl0:
                q = j - cl0
                lane_j = torch.where(upd & (cl_rel == q), clane_upd, lane_j)
                if q == 0:
                    lane_j = torch.where(
                        poison, lane_j | (1 << _B_POISON), lane_j)
            lanes.append(lane_j)
        # Network: clear the delivered bit, OR the (gated) sends in.
        for ln in range(L):
            clear = torch.where((slot >> 5) == ln, _one_shl(slot & 31), 0)
            lanes.append((vec[self.n_state_lanes + ln] & ~clear)
                         | send_row[:, ln])
        return torch.stack(lanes), None, None

    # -- dense step (DenseEncodedModel) ------------------------------------
    #
    # The JAX ``step_vec``: one slot per envelope of the universe, each
    # delivered by its kind's handler with every message field a python
    # constant, batched over the rows. A handler returns the successor
    # lanes (a lane it leaves alone is the input's own tensor) and
    # whether it handled the message.

    def step_cols(self, states_t: torch.Tensor) -> tuple:
        """``[W, N] -> (succ [W, N, K], valid bool[N, K], None)``."""
        lanes = list(states_t)
        succs, valids = [], []
        for k, e in enumerate(self.universe):
            out, valid = self._deliver(lanes, k, e)
            succs.append(out)
            valids.append(valid)
        return (*stack_slots(succs, valids), None)

    def _deliver(self, v, k: int, e: EnvSpec):
        lane = v[self.n_state_lanes + k // 32]
        present = ((lane >> (k % 32)) & 1) != 0
        out, handled = getattr(self, f"_on_{e.kind}")(v, k, e)
        return out, present & handled

    def _net_update(self, v, clear_k: int, send_masks: dict):
        """Clear bit ``clear_k``; OR per-lane ``send_masks`` in."""
        out = list(v)
        for ln in range(self.net_lanes):
            idx = self.n_state_lanes + ln
            lane = v[idx]
            if clear_k // 32 == ln:
                lane = lane & ~(1 << (clear_k % 32))
            m = send_masks.get(ln)
            if m is not None:
                lane = lane | m
            out[idx] = lane
        return out

    def _send_masks(self, masks: dict, keys, hit) -> None:
        """OR the per-lane masks of ``keys`` into ``masks`` where
        ``hit``."""
        for ln, m in self._const_mask(keys).items():
            add = torch.where(hit, m, 0)
            masks[ln] = add if ln not in masks else masks[ln] | add

    def _poison(self, v, cond):
        cl = self._clane_index(0)
        out = list(v)
        out[cl] = torch.where(cond, v[cl] | (1 << _B_POISON), v[cl])
        return out

    def _server_fields(self, lane):
        return (_fget(lane, self.B_DEC, 1) != 0,
                _fget(lane, self.B_BALLOT, self.W_BALLOT),
                _fget(lane, self.B_PROP, self.W_PROP),
                _fget(lane, self.B_ACC, self.W_ACC))

    def _round_of(self, device) -> torch.Tensor:
        cache = self.__dict__.setdefault("_round_dev", {})
        if device not in cache:
            cache[device] = torch.tensor(
                [0] + [r for (r, _) in self.ballots], dtype=torch.int64,
                device=device)
        return cache[device]

    def _on_put(self, v, k, e: EnvSpec):
        lane = v[e.dst]
        decided, ballot, prop, acc = self._server_fields(lane)
        handled = ~decided & (prop == 0)
        # New ballot: (round+1, dst). Rounds for this leader:
        rounds = sorted(r for (r, l) in self.ballots if l == e.dst)
        table = self._round_of(lane.device)
        cur_round = table[ballot.clamp(max=table.numel() - 1)]
        nb = torch.zeros_like(lane)
        poison = handled
        masks: dict = {}
        for r in rounds:
            hit = cur_round == (r - 1)
            b = self.ballot_enum[(r, Id(e.dst))]
            nb = torch.where(hit, b, nb)
            poison = poison & ~hit
            # Sends: Prepare(nb) to both peers — selected by round.
            self._send_masks(masks, [
                (e.dst, d, "prepare", b, 0, 0, 0)
                for d in range(self.S) if d != e.dst
            ], hit)
        new_lane = ((nb << self.B_BALLOT) | (e.prop << self.B_PROP)
                    | (acc << self.B_ACC))
        # Put RESETS prepares to {self: accepted} (paxos.rs:160-176).
        prep = ((acc + 1) << (self.W_PREP * e.dst)) & _M32
        out = list(v)
        if self.two_lane:
            out[e.dst] = torch.where(handled, new_lane & _M32, lane)
            pl = self._prep_lane(e.dst)
            out[pl] = torch.where(handled, prep, v[pl])
        else:
            new_lane = (new_lane | (prep << self.B_PREP)) & _M32
            out[e.dst] = torch.where(handled, new_lane, lane)
        out = self._poison(out, poison)
        return self._net_update(out, k, masks), handled

    def _on_get(self, v, k, e: EnvSpec):
        decided, _, _, acc = self._server_fields(v[e.dst])
        # Reply GetOk(value of accepted proposal).
        val = torch.where(acc > 0, ((acc - 1) % self.P) + 1, 0)
        masks: dict = {}
        for value in range(1, self.P + 1):
            key = (e.dst, e.src, "getok", 0, 0, 0, value)
            if key in self.index:
                self._send_masks(masks, [key], decided & (val == value))
        return self._net_update(v, k, masks), decided

    def _on_putok(self, v, k, e: EnvSpec):
        j = self.clients.index(e.dst)
        cl, off = self._clane_index(j), self._coff(j)
        lane = v[cl]
        handled = _fget(lane, off, 2) == 0
        # History: W returns, R invoked (phases 0 -> 2).
        new_lane = _fset(_fset(lane, off, 2, 1), off + 2, 2, 2)
        out = list(v)
        out[cl] = torch.where(handled, new_lane, lane)
        masks: dict = {}
        self._send_masks(
            masks, [(e.dst, (e.dst + 1) % self.S, "get", 0, 0, 0, 0)],
            handled)
        return self._net_update(out, k, masks), handled

    def _on_getok(self, v, k, e: EnvSpec):
        j = self.clients.index(e.dst)
        cl, off = self._clane_index(j), self._coff(j)
        lane = v[cl]
        handled = _fget(lane, off, 2) == 1
        new_lane = _fset(_fset(lane, off, 2, 2), off + 2, 2, 3)
        new_lane = _fset(new_lane, off + 4, self.W_RV, e.value)
        out = list(v)
        out[cl] = torch.where(handled, new_lane, lane)
        return self._net_update(out, k, {}), handled

    def _on_prepare(self, v, k, e: EnvSpec):
        lane = v[e.dst]
        decided, ballot, _, acc = self._server_fields(lane)
        handled = ~decided & (ballot < e.ballot)
        new_lane = _fset(lane, self.B_BALLOT, self.W_BALLOT, e.ballot)
        # Send Prepared(b, la=accepted) to the leader; select the
        # envelope by the acceptor's current accepted code.
        masks: dict = {}
        covered = torch.zeros_like(handled)
        for la in self.la_universe[e.ballot]:
            hit = handled & (acc == la)
            covered = covered | hit
            self._send_masks(
                masks, [(e.dst, e.src, "prepared", e.ballot, 0, la, 0)],
                hit)
        out = list(v)
        out[e.dst] = torch.where(handled, new_lane, lane)
        out = self._poison(out, handled & ~covered)
        return self._net_update(out, k, masks), handled

    def _on_prepared(self, v, k, e: EnvSpec):
        ld = e.dst
        lane = v[ld]
        plane = v[self._prep_lane(ld)]
        decided, ballot, prop, _ = self._server_fields(lane)
        handled = ~decided & (ballot == e.ballot)
        # prepares[src] = 1 + la.
        new_plane = _fset(plane, self.B_PREP + self.W_PREP * e.src,
                          self.W_PREP, 1 + e.la)
        entries = [
            _fget(new_plane, self.B_PREP + self.W_PREP * i, self.W_PREP)
            for i in range(self.S)
        ]
        count = sum((en != 0).to(torch.int64) for en in entries)
        fire = handled & (count == 2)  # majority(3) (paxos.rs:144)
        # best la among present entries (la codes order by (ballot,
        # proposal), None lowest — matches _accepted_sort_key).
        best = torch.zeros_like(lane)
        for en in entries:
            best = torch.maximum(best, torch.where(en != 0, en - 1, 0))
        chosen = torch.where(best > 0, ((best - 1) % self.P) + 1, prop)
        acc_code = 1 + (e.ballot - 1) * self.P + (chosen - 1)
        fired_lane = _fset(lane, self.B_PROP, self.W_PROP, chosen)
        fired_lane = _fset(fired_lane, self.B_ACC, self.W_ACC, acc_code)
        fired_lane = _fset(fired_lane, self.B_ACCEPTS, self.W_ACCEPTS,
                           1 << ld)
        new_lane = torch.where(fire, fired_lane, lane)
        masks: dict = {}
        covered = torch.zeros_like(fire)
        for p in self.choosable[e.ballot]:
            hit = fire & (chosen == p)
            covered = covered | hit
            self._send_masks(masks, [
                (ld, d, "accept", e.ballot, p, 0, 0)
                for d in range(self.S) if d != ld
            ], hit)
        out = list(v)
        if self.two_lane:
            out[ld] = torch.where(handled, new_lane, lane)
            pl = self._prep_lane(ld)
            out[pl] = torch.where(handled, new_plane, plane)
        else:
            # Main lane and prepares share one lane: merge the updated
            # prepares field range into the (possibly fired) main bits.
            pmask = ((1 << (self.S * self.W_PREP)) - 1) << self.B_PREP
            merged = (new_lane & ~pmask) | (new_plane & pmask)
            out[ld] = torch.where(handled, merged, lane)
        out = self._poison(out, fire & ~covered)
        return self._net_update(out, k, masks), handled

    def _on_accept(self, v, k, e: EnvSpec):
        lane = v[e.dst]
        decided, ballot, _, _ = self._server_fields(lane)
        handled = ~decided & (ballot <= e.ballot)
        acc_code = 1 + (e.ballot - 1) * self.P + (e.prop - 1)
        new_lane = _fset(lane, self.B_BALLOT, self.W_BALLOT, e.ballot)
        new_lane = _fset(new_lane, self.B_ACC, self.W_ACC, acc_code)
        out = list(v)
        out[e.dst] = torch.where(handled, new_lane, lane)
        masks: dict = {}
        self._send_masks(
            masks, [(e.dst, e.src, "accepted", e.ballot, 0, 0, 0)],
            handled)
        return self._net_update(out, k, masks), handled

    def _on_accepted(self, v, k, e: EnvSpec):
        ld = e.dst
        lane = v[ld]
        decided, ballot, prop, _ = self._server_fields(lane)
        handled = ~decided & (ballot == e.ballot)
        accepts = _fget(lane, self.B_ACCEPTS, self.W_ACCEPTS) | (1 << e.src)
        count = sum((accepts >> i) & 1 for i in range(self.S))
        fire = handled & (count == 2)
        new_lane = _fset(lane, self.B_ACCEPTS, self.W_ACCEPTS, accepts)
        new_lane = torch.where(
            fire, (new_lane | (1 << self.B_DEC)) & _M32, new_lane)
        masks: dict = {}
        covered = torch.zeros_like(fire)
        for p in self.choosable[e.ballot]:
            hit = fire & (prop == p)
            covered = covered | hit
            # Decided to the peers, PutOk to the proposal's requester.
            self._send_masks(masks, [
                (ld, d, "decided", e.ballot, p, 0, 0)
                for d in range(self.S) if d != ld
            ] + [(ld, self.clients[p - 1], "putok", 0, p, 0, 0)], hit)
        out = list(v)
        out[ld] = torch.where(handled, new_lane, lane)
        out = self._poison(out, fire & ~covered)
        return self._net_update(out, k, masks), handled

    def _on_decided(self, v, k, e: EnvSpec):
        lane = v[e.dst]
        handled = _fget(lane, self.B_DEC, 1) == 0
        acc_code = 1 + (e.ballot - 1) * self.P + (e.prop - 1)
        new_lane = _fset(lane, self.B_BALLOT, self.W_BALLOT, e.ballot)
        new_lane = _fset(new_lane, self.B_ACC, self.W_ACC, acc_code)
        new_lane = (new_lane | (1 << self.B_DEC)) & _M32
        out = list(v)
        out[e.dst] = torch.where(handled, new_lane, lane)
        return self._net_update(out, k, {}), handled

    def property_conditions_cols(self,
                                 states_t: torch.Tensor) -> torch.Tensor:
        """``bool[N, 2]``: [always linearizable, sometimes value chosen]
        — the order of the host model's properties(). Linearizability
        is one gather from the truth table by the clients' (phase,
        read value) codes, failed by the poison bit; "value chosen" is
        a deliverable GetOk with a non-default value."""
        c = self._device_consts(states_t.device)
        idx = torch.zeros_like(states_t[0])
        for j in range(self.C):
            clane = states_t[self._clane_index(j)]
            off = self._coff(j)
            ph = _fget(clane, off + 2, 2)
            rv = _fget(clane, off + 4, self.W_RV)
            idx = idx * self.TB + ph * self.TBV + rv
        linearizable = c["lin"][idx] & (
            _fget(states_t[self._clane_index(0)], _B_POISON, 1) == 0)
        net = states_t[self.n_state_lanes:].T
        chosen = ((net & c["chosen"]) != 0).any(dim=1)
        return torch.stack([linearizable, chosen], dim=1)


#: The engine sizes per client count: ``capacity`` holds the pinned
#: unique-state counts (265 / 16,668 / 1,194,428 / 2,372,188 /
#: 4,711,569) and ``frontier_capacity`` the widest wave's new states.
#: (The JAX table's tile and budget knobs size static shapes, which the
#: eager engine does not have.) Shared by the CLI, the stage profile
#: and chip_smoke.py.
STRUCTURAL_SIZES = {
    1: dict(capacity=1 << 10, frontier_capacity=1 << 8),
    2: dict(capacity=1 << 15, frontier_capacity=1 << 12),
    3: dict(capacity=5 << 18, frontier_capacity=1 << 18),
    4: dict(capacity=5 << 19, frontier_capacity=1 << 19),
    5: dict(capacity=3 << 21, frontier_capacity=3 << 19),
}

