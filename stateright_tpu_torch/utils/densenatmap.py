"""Dense natural-number-keyed map.

A copy of the JAX package's ``utils.densenatmap``. Counterpart of
``DenseNatMap<K, V>`` (stateright src/util/densenatmap.rs): a type-safe
vector keyed by values that convert to ``int`` (actor ``Id``s in
practice) with dense keys — inserting past the end leaves no gaps
(densenatmap.rs:98-113 panics on gap insert; we raise). Immutable:
``set`` returns a new map.
"""

from __future__ import annotations

from typing import Any, Generic, Iterable, Iterator, Tuple, TypeVar

V = TypeVar("V")


class DenseNatMap(Generic[V]):
    __slots__ = ("_values",)

    def __init__(self, values: Iterable[V] = ()):
        self._values: tuple = tuple(values)

    @staticmethod
    def from_iter(values: Iterable[V]) -> "DenseNatMap[V]":
        return DenseNatMap(values)

    def set(self, key: Any, value: V) -> "DenseNatMap[V]":
        i = int(key)
        if i == len(self._values):
            return DenseNatMap(self._values + (value,))
        if 0 <= i < len(self._values):
            return DenseNatMap(
                self._values[:i] + (value,) + self._values[i + 1:]
            )
        raise IndexError(
            f"gap insert at key {i} (len={len(self._values)}); "
            "DenseNatMap keys must stay dense"
        )

    def __getitem__(self, key: Any) -> V:
        return self._values[int(key)]

    def get(self, key: Any, default: V | None = None) -> V | None:
        i = int(key)
        if 0 <= i < len(self._values):
            return self._values[i]
        return default

    def items(self) -> Iterator[Tuple[int, V]]:
        return enumerate(self._values)

    def values(self) -> tuple:
        return self._values

    def __iter__(self) -> Iterator[V]:
        return iter(self._values)

    def __len__(self) -> int:
        return len(self._values)

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, DenseNatMap):
            return self._values == other._values
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._values)

    def __repr__(self) -> str:
        return f"DenseNatMap({list(self._values)!r})"
