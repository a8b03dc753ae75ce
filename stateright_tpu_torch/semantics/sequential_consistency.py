"""Sequential-consistency tester.

A copy of the JAX package's ``semantics.sequential_consistency``, on
the port's ``_serialize.serialize_history``. Counterpart of stateright
src/semantics/sequential_consistency.rs:55-240 — the
:class:`~stateright_tpu_torch.semantics.linearizability.
LinearizabilityTester` skeleton minus the cross-thread real-time
constraints: only per-thread program order and the sequential spec
constrain the total order.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, List, Optional, Tuple

from ..fingerprint import stable_hash
from ._serialize import serialize_history
from .spec import SequentialSpec

_CACHE: dict = {}
_CACHE_CAP = 1 << 16


@dataclass(frozen=True)
class SequentialConsistencyTester:
    init_ref_obj: SequentialSpec
    #: sorted ((thread, ((op, ret), ...)), ...)
    history_by_thread: Tuple = ()
    #: sorted ((thread, op), ...)
    in_flight_by_thread: Tuple = ()
    is_valid: bool = True

    def on_invoke(self, thread: Any, op: Any) -> "SequentialConsistencyTester":
        if not self.is_valid:
            return self
        in_flight = dict(self.in_flight_by_thread)
        if thread in in_flight:
            return replace(self, is_valid=False)
        in_flight[thread] = op
        history = dict(self.history_by_thread)
        history.setdefault(thread, ())
        return replace(
            self,
            history_by_thread=tuple(sorted(history.items())),
            in_flight_by_thread=tuple(sorted(in_flight.items())),
        )

    def on_return(self, thread: Any, ret: Any) -> "SequentialConsistencyTester":
        if not self.is_valid:
            return self
        in_flight = dict(self.in_flight_by_thread)
        if thread not in in_flight:
            return replace(self, is_valid=False)
        op = in_flight.pop(thread)
        history = dict(self.history_by_thread)
        history[thread] = history.get(thread, ()) + ((op, ret),)
        return replace(
            self,
            history_by_thread=tuple(sorted(history.items())),
            in_flight_by_thread=tuple(sorted(in_flight.items())),
        )

    def __len__(self) -> int:
        return len(self.in_flight_by_thread) + sum(
            len(ops) for _, ops in self.history_by_thread
        )

    def serialized_history(self) -> Optional[List[Tuple[Any, Any]]]:
        if not self.is_valid:
            return None
        key = stable_hash(self)
        if key in _CACHE:
            return _CACHE[key]
        result = serialize_history(
            self.init_ref_obj,
            {
                t: [((), op, ret) for op, ret in ops]
                for t, ops in self.history_by_thread
            },
            {t: ((), op) for t, op in self.in_flight_by_thread},
            real_time=False,
        )
        if len(_CACHE) >= _CACHE_CAP:
            _CACHE.clear()
        _CACHE[key] = result
        return result

    def is_consistent(self) -> bool:
        return self.serialized_history() is not None
