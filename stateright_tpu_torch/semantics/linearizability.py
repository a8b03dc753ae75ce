"""Linearizability tester.

A copy of the JAX package's ``semantics.linearizability``. Counterpart
of stateright src/semantics/linearizability.rs:57-284.
Records a concurrent per-thread operation history; each invocation
snapshots the index of the last completed operation of every *other*
thread, encoding the real-time happens-before order; a history is
linearizable iff some total order consistent with program order, the
snapshots, and the sequential spec explains it.

Immutable: ``on_invoke``/``on_return`` return new testers, because in
actor models the tester is the auxiliary history inside the
fingerprinted model state (reference pattern: the tester *is* the
``ActorModel`` history ``H``, SURVEY.md §2.3).

Protocol errors (double invoke, return without invoke) mark the
history invalid, after which ``is_consistent`` is False — matching the
reference's ``is_valid_history`` flag (linearizability.rs:100-165).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, List, Optional, Tuple

from ..fingerprint import stable_hash
from ._serialize import serialize_history
from .spec import SequentialSpec

# serialized_history is invoked per explored state while identical
# tester values recur across huge regions of the state space; memoize
# by structural digest (same 64-bit collision budget as the checker).
_CACHE: dict = {}
_CACHE_CAP = 1 << 16


@dataclass(frozen=True)
class LinearizabilityTester:
    init_ref_obj: SequentialSpec
    #: sorted ((thread, ((snapshot, op, ret), ...)), ...)
    history_by_thread: Tuple = ()
    #: sorted ((thread, (snapshot, op)), ...)
    in_flight_by_thread: Tuple = ()
    is_valid: bool = True

    # -- recording (ConsistencyTester interface) -------------------------

    def on_invoke(self, thread: Any, op: Any) -> "LinearizabilityTester":
        if not self.is_valid:
            return self
        in_flight = dict(self.in_flight_by_thread)
        if thread in in_flight:
            return replace(self, is_valid=False)
        history = dict(self.history_by_thread)
        snapshot = tuple(
            sorted(
                (peer, len(ops) - 1)
                for peer, ops in history.items()
                if peer != thread and ops
            )
        )
        in_flight[thread] = (snapshot, op)
        history.setdefault(thread, ())
        return replace(
            self,
            history_by_thread=tuple(sorted(history.items())),
            in_flight_by_thread=tuple(sorted(in_flight.items())),
        )

    def on_return(self, thread: Any, ret: Any) -> "LinearizabilityTester":
        if not self.is_valid:
            return self
        in_flight = dict(self.in_flight_by_thread)
        if thread not in in_flight:
            return replace(self, is_valid=False)
        snapshot, op = in_flight.pop(thread)
        history = dict(self.history_by_thread)
        history[thread] = history.get(thread, ()) + ((snapshot, op, ret),)
        return replace(
            self,
            history_by_thread=tuple(sorted(history.items())),
            in_flight_by_thread=tuple(sorted(in_flight.items())),
        )

    def __len__(self) -> int:
        return len(self.in_flight_by_thread) + sum(
            len(ops) for _, ops in self.history_by_thread
        )

    # -- checking --------------------------------------------------------

    def serialized_history(self) -> Optional[List[Tuple[Any, Any]]]:
        if not self.is_valid:
            return None
        key = stable_hash(self)
        if key in _CACHE:
            return _CACHE[key]
        result = serialize_history(
            self.init_ref_obj,
            {t: list(ops) for t, ops in self.history_by_thread},
            dict(self.in_flight_by_thread),
            real_time=True,
        )
        if len(_CACHE) >= _CACHE_CAP:
            _CACHE.clear()
        _CACHE[key] = result
        return result

    def is_consistent(self) -> bool:
        return self.serialized_history() is not None
