"""Vector clocks for causal ordering.

A copy of the JAX package's ``utils.vector_clock``, on the port's own
``fingerprint.stable_hash``, so a clock digests alike in both.
Counterpart of stateright src/util/vector_clock.rs: a grow-on-demand
vector of counters with ``merge_max`` / ``incremented``, a causal
partial order (``partial_cmp`` returning None for concurrent clocks,
vector_clock.rs:84-107), and a digest that ignores trailing zeros
(vector_clock.rs:53-63) so ``[1, 0]`` and ``[1]`` are the same clock.
Immutable: updates return new clocks.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

from ..fingerprint import stable_hash


def _trimmed(values: Iterable[int]) -> tuple:
    vals = list(values)
    while vals and vals[-1] == 0:
        vals.pop()
    return tuple(vals)


class VectorClock:
    __slots__ = ("_values",)

    def __init__(self, values: Iterable[int] = ()):
        self._values = _trimmed(values)

    def get(self, index: int) -> int:
        return self._values[index] if index < len(self._values) else 0

    def incremented(self, index: int) -> "VectorClock":
        """Return a clock with component ``index`` bumped
        (vector_clock.rs:20-39)."""
        n = max(len(self._values), index + 1)
        vals = [self.get(i) for i in range(n)]
        vals[index] += 1
        return VectorClock(vals)

    def merge_max(self, other: "VectorClock") -> "VectorClock":
        """Component-wise max — the receive-side merge."""
        n = max(len(self._values), len(other._values))
        return VectorClock(
            max(self.get(i), other.get(i)) for i in range(n)
        )

    def partial_cmp(self, other: "VectorClock") -> Optional[int]:
        """-1 if self < other, 0 if equal, 1 if self > other, None if
        concurrent (vector_clock.rs:84-107)."""
        n = max(len(self._values), len(other._values))
        lt = gt = False
        for i in range(n):
            a, b = self.get(i), other.get(i)
            if a < b:
                lt = True
            elif a > b:
                gt = True
        if lt and gt:
            return None
        if lt:
            return -1
        if gt:
            return 1
        return 0

    def __le__(self, other: "VectorClock") -> bool:
        cmp = self.partial_cmp(other)
        return cmp is not None and cmp <= 0

    def __lt__(self, other: "VectorClock") -> bool:
        return self.partial_cmp(other) == -1

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, VectorClock):
            return self._values == other._values
        return NotImplemented

    def _stable_hash_(self) -> int:
        return stable_hash(self._values)

    def __hash__(self) -> int:
        return hash(self._values)

    def __repr__(self) -> str:
        return f"VectorClock({list(self._values)!r})"
