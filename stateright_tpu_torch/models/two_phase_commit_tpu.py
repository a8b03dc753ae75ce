"""Vectorized two-phase commit: the packed 2pc encoding in PyTorch.

The port of ``stateright_tpu.models.two_phase_commit_tpu``: the host
half (``encode``, ``decode``, ``init_vecs``) is copied, and the device
half is written as batched functions over lane-major ``[W, N]`` int64
blocks (see encoding.py) instead of per-state functions under ``vmap``.

Packed layout (``width = 2`` for up to 10 RMs):
  lane 0: rm_state enum, 2 bits per RM (0=Working 1=Prepared
          2=Committed 3=Aborted)
  lane 1: bits 0-1   tm_state enum (0=Init 1=Committed 2=Aborted)
          bits 2..   tm_prepared bitmask (N bits)
          then       message-set bitmask: commit, abort, prepared(rm)

Actions (``max_actions = 2 + 5*N``), mirroring 2pc.rs actions():
  0: tm_commit        1: tm_abort
  per rm: tm_rcv_prepared, rm_prepare, rm_choose_abort,
          rm_rcv_commit, rm_rcv_abort

The dense step (``step_cols``) builds every slot's successor with the
same bitfield updates as the JAX ``step_vec``. The enabled mask is
word-native: every slot guard is a small function
of one 2-bit RM field or a TM/message bit, so the packed words assemble
from ``4 + 2N`` condition-gated host-constant class masks
(ops/bitmask.py) and no dense ``bool[K]`` row is built by the predicate.

The encoding declares both reductions: the RMs' symmetry
(``device_rewrite_spec``) and a static ample set
(``ample_mask_host``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..encoding import EncodedModelBase, stack_slots
from ..ops.bitmask import (
    mask_words,
    or_class_words,
    pack_bits_host,
    slot_mask_host,
)
from ..ops.canonical import DeviceRewriteSpec, MemberField
from .two_phase_commit import RmState, TmState, TwoPhaseState, TwoPhaseSys

_WORKING, _PREPARED, _COMMITTED, _ABORTED = 0, 1, 2, 3
_INIT, _TM_COMMITTED, _TM_ABORTED = 0, 1, 2


class TwoPhaseSysEncoded(EncodedModelBase):
    def __init__(self, rm_count: int):
        if rm_count > 10:
            raise ValueError(
                f"packed 2pc encoding supports up to 10 RMs (got {rm_count})"
            )
        self.rm_count = rm_count
        self.width = 2
        self.max_actions = 2 + 5 * rm_count
        #: lane-1 bit offsets
        self._prep_shift = 2
        self._msgs_shift = 2 + rm_count
        self.host_model = TwoPhaseSys(rm_count=rm_count)
        n, K = rm_count, self.max_actions
        #: host-constant guard-class masks: slots sharing one enabling
        #: condition share one packed mask
        self._bw = dict(
            tm_commit=slot_mask_host(K, [0]),
            tm_abort=slot_mask_host(K, [1]),
            rcv_commit=slot_mask_host(K, [5 + 5 * rm for rm in range(n)]),
            rcv_abort=slot_mask_host(K, [6 + 5 * rm for rm in range(n)]),
            working=[slot_mask_host(K, [3 + 5 * rm, 4 + 5 * rm])
                     for rm in range(n)],
            rcv_prep=[slot_mask_host(K, [2 + 5 * rm]) for rm in range(n)],
        )

    def cache_key(self):
        """The JAX encoding's identity, so that a snapshot's encoding
        fingerprint (checkpoint.py) is equal across the two packages."""
        return self.rm_count

    # -- device symmetry / reduction hooks -------------------------------

    def device_rewrite_spec(self):
        """RM permutation symmetry as strided bit-fields: member
        ``m``'s tuple is (rm_state lane0 bits [2m, 2m+2),
        tm_prepared lane1 bit _prep_shift+m, prepared-msg lane1 bit
        _msgs_shift+2+m). ALL three fields are sort keys — the FULL
        per-member tuple — so the canonicalizer is constant on orbits
        and the reduced count is search-order-independent (rm=5:
        8,832 → 314). The host oracle is
        ``TwoPhaseState.representative_full``, which sorts the same
        tuple in the same encoded order."""
        if self.rm_count < 2:
            return None
        return DeviceRewriteSpec(
            n_members=self.rm_count,
            fields=(
                MemberField(
                    lane=0, shift=0, stride=2, width=2, sort_key=True
                ),
                MemberField(
                    lane=1, shift=self._prep_shift, stride=1, width=1,
                    sort_key=True,
                ),
                MemberField(
                    lane=1, shift=self._msgs_shift + 2, stride=1,
                    width=1, sort_key=True,
                ),
            ),
        )

    def ample_mask_host(self):
        """Static partial-order ample-set filter: keep
        ``rm_choose_abort`` (slot 4+5·rm) only for rm 0, drop it for
        rm ≥ 1.

        Soundness for THIS property set (all state predicates, no
        EVENTUALLY liveness): spontaneous aborts of distinct RMs
        commute with every other action and with each other, and each
        property's witness states stay reachable with only rm 0's
        spontaneous abort available — "abort agreement" via tm_abort
        + rm_rcv_abort alone, "commit agreement" via the all-prepare
        path (which never needs choose_abort), and the ALWAYS property
        "consistent" is checked on every state the filtered search DOES
        reach, a subset of the full space, so it can produce no false
        violation; a missed violation would need a state whose every
        path uses a choose_abort by rm ≥ 1, and by RM symmetry such a
        path maps to one using rm 0's. The soundness analyzer
        (analysis/soundness.py) certifies this mask: enabledness
        preservation and non-suppression over the traced guard, step
        and property functions."""
        keep = np.ones(self.max_actions, dtype=bool)
        for rm in range(1, self.rm_count):
            keep[4 + 5 * rm] = False
        return pack_bits_host(keep)

    # -- host side -------------------------------------------------------

    def encode(self, state: TwoPhaseState) -> np.ndarray:
        lane0 = 0
        for i, rm in enumerate(state.rm_state):
            lane0 |= rm.value << (2 * i)
        lane1 = state.tm_state.value
        for i, p in enumerate(state.tm_prepared):
            if p:
                lane1 |= 1 << (self._prep_shift + i)
        for m in state.msgs:
            if m == ("commit",):
                lane1 |= 1 << self._msgs_shift
            elif m == ("abort",):
                lane1 |= 1 << (self._msgs_shift + 1)
            else:
                lane1 |= 1 << (self._msgs_shift + 2 + m[1])
        return np.array([lane0, lane1], dtype=np.uint32)

    def decode(self, vec: np.ndarray) -> TwoPhaseState:
        n = self.rm_count
        vec = np.asarray(vec)
        lane0, lane1 = int(vec[0]), int(vec[1])
        msgs = set()
        m = lane1 >> self._msgs_shift
        if m & 1:
            msgs.add(("commit",))
        if m & 2:
            msgs.add(("abort",))
        for i in range(n):
            if m & (1 << (2 + i)):
                msgs.add(("prepared", i))
        return TwoPhaseState(
            rm_state=tuple(
                RmState((lane0 >> (2 * i)) & 3) for i in range(n)
            ),
            tm_state=TmState(lane1 & 3),
            tm_prepared=tuple(
                bool(lane1 & (1 << (self._prep_shift + i)))
                for i in range(n)
            ),
            msgs=frozenset(msgs),
        )

    def init_vecs(self) -> np.ndarray:
        return np.stack(
            [self.encode(s) for s in self.host_model.init_states()]
        )

    # -- device side -----------------------------------------------------

    def step_cols(self, states_t: torch.Tensor) -> tuple:
        """The dense step (JAX ``step_vec``): ``[2, N] -> (succ [2, N,
        K], valid bool[N, K], None)``, every slot's successor by the
        same branchless bitfield updates as 2pc.rs actions() /
        next_state()."""
        n = self.rm_count
        ps, ms = self._prep_shift, self._msgs_shift
        lane0, lane1 = states_t[0], states_t[1]
        tm = lane1 & 3
        prep = (lane1 >> ps) & ((1 << n) - 1)
        commit_bit, abort_bit = 1 << ms, 1 << (ms + 1)
        tm_clear = lane1 & ~3
        tm_init = tm == _INIT
        # (lane 0, lane 1, valid) per slot, in slot order
        slots = [
            (lane0, tm_clear | _TM_COMMITTED | commit_bit,
             tm_init & (prep == (1 << n) - 1)),        # tm_commit
            (lane0, tm_clear | _TM_ABORTED | abort_bit, tm_init),
        ]
        committed = (lane1 & commit_bit) != 0
        aborted = (lane1 & abort_bit) != 0
        for rm in range(n):
            working = ((lane0 >> (2 * rm)) & 3) == _WORKING
            prepared_bit = 1 << (ms + 2 + rm)
            rm_clear = lane0 & ~(3 << (2 * rm))
            slots += [
                (lane0, lane1 | (1 << (ps + rm)),       # tm_rcv_prepared
                 tm_init & ((lane1 & prepared_bit) != 0)),
                (rm_clear | (_PREPARED << (2 * rm)),    # rm_prepare
                 lane1 | prepared_bit, working),
                (rm_clear | (_ABORTED << (2 * rm)), lane1,
                 working),                              # rm_choose_abort
                (rm_clear | (_COMMITTED << (2 * rm)), lane1,
                 committed),                            # rm_rcv_commit
                (rm_clear | (_ABORTED << (2 * rm)), lane1,
                 aborted),                              # rm_rcv_abort
            ]
        return (*stack_slots([s[:2] for s in slots],
                             [s[2] for s in slots]), None)

    def enabled_bits_cols(self, states_t: torch.Tensor) -> torch.Tensor:
        """``[2, N] -> int64[N, ceil(K/32)]`` packed enabled mask: an OR
        of ``4 + 2N`` condition-gated host class masks."""
        t = self._bw
        n = self.rm_count
        ps, ms = self._prep_shift, self._msgs_shift
        lane0, lane1 = states_t[0], states_t[1]
        tm_init = (lane1 & 3) == 0
        prep = (lane1 >> ps) & ((1 << n) - 1)
        classes = [
            (tm_init & (prep == (1 << n) - 1), t["tm_commit"]),
            (tm_init, t["tm_abort"]),
            ((lane1 & (1 << ms)) != 0, t["rcv_commit"]),
            ((lane1 & (1 << (ms + 1))) != 0, t["rcv_abort"]),
        ]
        for rm in range(n):
            working = ((lane0 >> (2 * rm)) & 3) == 0
            prepared_msg = (lane1 & (1 << (ms + 2 + rm))) != 0
            classes.append((working, t["working"][rm]))
            classes.append((tm_init & prepared_msg, t["rcv_prep"][rm]))
        return or_class_words(classes, mask_words(self.max_actions))

    def step_slot_cols(self, states_t: torch.Tensor,
                       slots: torch.Tensor) -> tuple:
        """Successors of (state, enabled slot) pairs, ``[2, N]``, and no
        truncation flags (``None, None``):
        branchless selects over the slot arithmetic (``rm = (slot-2) //
        5``, action kind ``(slot-2) % 5``) — no table is needed."""
        ps, ms = self._prep_shift, self._msgs_shift
        lane0, lane1 = states_t[0], states_t[1]
        slots = slots.to(torch.int64)
        rmslot = (slots - 2).clamp(min=0)
        rm = rmslot // 5
        j = rmslot % 5
        sh2 = 2 * rm
        one = torch.ones_like(lane0)

        # TM verdicts (slots 0/1).
        tm_clear = lane1 & ~3
        l1_commit = tm_clear | _TM_COMMITTED | (1 << ms)
        l1_abort = tm_clear | _TM_ABORTED | (1 << (ms + 1))
        # Per-RM lane updates (slots 2+5rm+j), shift amounts per pair.
        prepared_bit = one << (ms + 2 + rm)
        l1_rcv_prep = lane1 | (one << (ps + rm))
        rm_clear = lane0 & ~(3 << sh2)
        l0_prepared = rm_clear | (_PREPARED << sh2)
        l0_committed = rm_clear | (_COMMITTED << sh2)
        l0_aborted = rm_clear | (_ABORTED << sh2)

        l0_rm = torch.where(
            j == 1,
            l0_prepared,
            torch.where(
                j == 3,
                l0_committed,
                torch.where((j == 2) | (j == 4), l0_aborted, lane0),
            ),
        )
        l1_rm = torch.where(
            j == 0,
            l1_rcv_prep,
            torch.where(j == 1, lane1 | prepared_bit, lane1),
        )
        l0 = torch.where(slots < 2, lane0, l0_rm)
        l1 = torch.where(
            slots == 0,
            l1_commit,
            torch.where(slots == 1, l1_abort, l1_rm),
        )
        return torch.stack([l0, l1]), None, None

    def property_conditions_cols(self,
                                 states_t: torch.Tensor) -> torch.Tensor:
        """``bool[N, 3]``: [sometimes abort agreement, sometimes commit
        agreement, always consistent] — order matches
        TwoPhaseSys.properties()."""
        n = self.rm_count
        shifts = 2 * torch.arange(n, dtype=torch.int64,
                                  device=states_t.device)
        rms = (states_t[0][None, :] >> shifts[:, None]) & 3
        all_aborted = (rms == _ABORTED).all(dim=0)
        all_committed = (rms == _COMMITTED).all(dim=0)
        consistent = ~(
            (rms == _ABORTED).any(dim=0) & (rms == _COMMITTED).any(dim=0)
        )
        return torch.stack([all_aborted, all_committed, consistent], dim=1)
