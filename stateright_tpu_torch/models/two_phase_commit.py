"""Two-phase commit (subset of Gray & Lamport's "Consensus on
Transaction Commit").

A copy of the JAX package's host model (stateright examples/2pc.rs):
resource managers (RMs) prepare/abort, a transaction manager commits
once all are prepared. Reference-pinned counts: 3 RMs → 288 unique
states, 5 RMs → 8,832 (2pc.rs:151-170). Class and field names match the
JAX package's, so host fingerprints — and therefore encoded paths —
are identical. ``representative_full`` is the host oracle of the
device symmetry spec (models/two_phase_commit_tpu.py).

The device encoding is
:mod:`stateright_tpu_torch.models.two_phase_commit_tpu`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from enum import Enum
from typing import Optional, Sequence, Tuple

from ..model import Model, Property
from ..symmetry import RewritePlan


class RmState(Enum):
    WORKING = 0
    PREPARED = 1
    COMMITTED = 2
    ABORTED = 3


class TmState(Enum):
    INIT = 0
    COMMITTED = 1
    ABORTED = 2


# Messages (2pc.rs Message): ("prepared", rm) | ("commit",) | ("abort",)


@dataclass(frozen=True)
class TwoPhaseState:
    rm_state: Tuple[RmState, ...]
    tm_state: TmState
    tm_prepared: Tuple[bool, ...]
    msgs: frozenset

    def representative(self) -> "TwoPhaseState":
        """Canonicalize under RM permutation symmetry (2pc.rs:203-222)."""
        plan = RewritePlan.from_values_to_sort(
            [(s.value,) for s in self.rm_state]
        )
        return TwoPhaseState(
            rm_state=tuple(plan.reindex(self.rm_state)),
            tm_state=self.tm_state,
            tm_prepared=tuple(plan.reindex(self.tm_prepared)),
            msgs=frozenset(
                ("prepared", plan.rewrite(m[1])) if m[0] == "prepared" else m
                for m in self.msgs
            ),
        )

    def representative_full(self) -> "TwoPhaseState":
        """Perfect canonicalizer: stable-sort RMs by their FULL
        per-member tuple ``(rm_state, tm_prepared, prepared-msg)``.

        ``representative()`` above sorts on rm_state alone (like the
        reference), which is not constant on orbits. This variant is,
        so its reduced count is search-order-independent (rm=5: 314
        classes); it is the host oracle of the device
        ``DeviceRewriteSpec`` canonicalization (ops/canonical.py),
        which sorts the same tuple in the same encoded order."""
        prep_bits = [
            int(("prepared", i) in self.msgs)
            for i in range(len(self.rm_state))
        ]
        plan = RewritePlan.from_values_to_sort(
            [
                (s.value, int(p), b)
                for s, p, b in zip(
                    self.rm_state, self.tm_prepared, prep_bits
                )
            ]
        )
        return TwoPhaseState(
            rm_state=tuple(plan.reindex(self.rm_state)),
            tm_state=self.tm_state,
            tm_prepared=tuple(plan.reindex(self.tm_prepared)),
            msgs=frozenset(
                ("prepared", plan.rewrite(m[1])) if m[0] == "prepared" else m
                for m in self.msgs
            ),
        )


@dataclass
class TwoPhaseSys(Model):
    """``rm_count`` resource managers plus one transaction manager."""

    rm_count: int

    def to_encoded(self):
        """The device encoding (the wave engine discovers this hook)."""
        from .two_phase_commit_tpu import TwoPhaseSysEncoded

        return TwoPhaseSysEncoded(self.rm_count)

    def init_states(self) -> Sequence[TwoPhaseState]:
        return [
            TwoPhaseState(
                rm_state=tuple(RmState.WORKING for _ in range(self.rm_count)),
                tm_state=TmState.INIT,
                tm_prepared=tuple(False for _ in range(self.rm_count)),
                msgs=frozenset(),
            )
        ]

    def actions(self, state: TwoPhaseState):
        actions = []
        if state.tm_state == TmState.INIT and all(state.tm_prepared):
            actions.append(("tm_commit",))
        if state.tm_state == TmState.INIT:
            actions.append(("tm_abort",))
        for rm in range(self.rm_count):
            if (
                state.tm_state == TmState.INIT
                and ("prepared", rm) in state.msgs
            ):
                actions.append(("tm_rcv_prepared", rm))
            if state.rm_state[rm] == RmState.WORKING:
                actions.append(("rm_prepare", rm))
                actions.append(("rm_choose_abort", rm))
            if ("commit",) in state.msgs:
                actions.append(("rm_rcv_commit", rm))
            if ("abort",) in state.msgs:
                actions.append(("rm_rcv_abort", rm))
        return actions

    def next_state(
        self, state: TwoPhaseState, action
    ) -> Optional[TwoPhaseState]:
        kind = action[0]
        if kind == "tm_rcv_prepared":
            rm = action[1]
            prepared = (
                state.tm_prepared[:rm] + (True,) + state.tm_prepared[rm + 1:]
            )
            return replace(state, tm_prepared=prepared)
        if kind == "tm_commit":
            return replace(
                state,
                tm_state=TmState.COMMITTED,
                msgs=state.msgs | {("commit",)},
            )
        if kind == "tm_abort":
            return replace(
                state,
                tm_state=TmState.ABORTED,
                msgs=state.msgs | {("abort",)},
            )
        rm = action[1]
        if kind == "rm_prepare":
            return replace(
                state,
                rm_state=self._with_rm(state, rm, RmState.PREPARED),
                msgs=state.msgs | {("prepared", rm)},
            )
        if kind == "rm_choose_abort":
            return replace(state, rm_state=self._with_rm(state, rm, RmState.ABORTED))
        if kind == "rm_rcv_commit":
            return replace(state, rm_state=self._with_rm(state, rm, RmState.COMMITTED))
        if kind == "rm_rcv_abort":
            return replace(state, rm_state=self._with_rm(state, rm, RmState.ABORTED))
        raise ValueError(f"unknown action {action!r}")

    @staticmethod
    def _with_rm(state: TwoPhaseState, rm: int, value: RmState):
        return state.rm_state[:rm] + (value,) + state.rm_state[rm + 1:]

    def properties(self):
        return [
            Property.sometimes(
                "abort agreement",
                lambda m, s: all(x == RmState.ABORTED for x in s.rm_state),
            ),
            Property.sometimes(
                "commit agreement",
                lambda m, s: all(x == RmState.COMMITTED for x in s.rm_state),
            ),
            Property.always(
                "consistent",
                lambda m, s: not (
                    RmState.ABORTED in s.rm_state
                    and RmState.COMMITTED in s.rm_state
                ),
            ),
        ]
