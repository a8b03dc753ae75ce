"""Stably-hashable immutable set / map collections (a copy of the JAX
package's ``utils.hashable``, so states holding them fingerprint alike).

Counterparts of ``HashableHashSet`` / ``HashableHashMap``
(stateright src/util.rs:64-65, 137-159, 349-372): collections whose
digest is insertion-order independent, computed by sorting element
digests before folding — so two states holding the same multimap of
messages fingerprint identically regardless of construction order.
Python dict/set are unhashable and mutable; these wrappers are the
state-safe versions used throughout the actor layer (e.g. network
message collections, src/actor/network.rs:52-55).

Ordering (``__lt__``) is defined on the digest, like the reference's
``Ord`` impl (util.rs:167-177) — arbitrary but total and stable, which
is what symmetry-reduction sorting needs.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, Mapping, Tuple

from ..fingerprint import stable_hash


class HashableSet:
    """Immutable set with a stable, order-independent digest."""

    __slots__ = ("_items", "_digest")

    def __init__(self, items: Iterable[Any] = ()):
        self._items = frozenset(items)
        self._digest: int | None = None

    def _stable_hash_(self) -> int:
        if self._digest is None:
            self._digest = stable_hash(self._items)
        return self._digest

    def add(self, item: Any) -> "HashableSet":
        if item in self._items:
            return self
        return HashableSet(self._items | {item})

    def remove(self, item: Any) -> "HashableSet":
        if item not in self._items:
            return self
        return HashableSet(self._items - {item})

    def __contains__(self, item: Any) -> bool:
        return item in self._items

    def __iter__(self) -> Iterator[Any]:
        return iter(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, HashableSet):
            return self._items == other._items
        return NotImplemented

    def __lt__(self, other: "HashableSet") -> bool:
        return self._stable_hash_() < other._stable_hash_()

    def __hash__(self) -> int:
        return self._stable_hash_()

    def __repr__(self) -> str:
        return "{" + ", ".join(sorted(repr(i) for i in self._items)) + "}"


class HashableMap:
    """Immutable map with a stable, order-independent digest."""

    __slots__ = ("_d", "_digest")

    def __init__(self, items: Mapping | Iterable[Tuple[Any, Any]] = ()):
        self._d = dict(items)
        self._digest: int | None = None

    def _stable_hash_(self) -> int:
        if self._digest is None:
            self._digest = stable_hash(self._d)
        return self._digest

    def set(self, key: Any, value: Any) -> "HashableMap":
        if key in self._d and self._d[key] == value:
            return self
        d = dict(self._d)
        d[key] = value
        return HashableMap(d)

    def remove(self, key: Any) -> "HashableMap":
        if key not in self._d:
            return self
        d = dict(self._d)
        del d[key]
        return HashableMap(d)

    def get(self, key: Any, default: Any = None) -> Any:
        return self._d.get(key, default)

    def items(self):
        return self._d.items()

    def keys(self):
        return self._d.keys()

    def values(self):
        return self._d.values()

    def __getitem__(self, key: Any) -> Any:
        return self._d[key]

    def __contains__(self, key: Any) -> bool:
        return key in self._d

    def __iter__(self) -> Iterator[Any]:
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, HashableMap):
            return self._d == other._d
        return NotImplemented

    def __lt__(self, other: "HashableMap") -> bool:
        return self._stable_hash_() < other._stable_hash_()

    def __hash__(self) -> int:
        return self._stable_hash_()

    def __repr__(self) -> str:
        inner = ", ".join(
            f"{k!r}: {v!r}" for k, v in sorted(
                self._d.items(), key=lambda kv: repr(kv[0])
            )
        )
        return "{" + inner + "}"
