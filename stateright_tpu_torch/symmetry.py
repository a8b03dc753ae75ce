"""Symmetry reduction: canonical representatives via sort permutations.

A copy of the JAX package's ``symmetry`` module, cut to the
:class:`RewritePlan` the host representatives use (stateright
src/checker/rewrite_plan.rs). A state's ``representative()`` sorts its
interchangeable participants and rewrites every embedded index by the
same permutation ("Symmetric Spin", representative.rs:7-16).

The host models' ``representative_full()`` sorts the FULL per-member
tuple: it is constant on orbits, and it is the host oracle of the
device canonicalizer (ops/canonical.py), which sorts the same tuple in
the same encoded order. A representative that sorts on a strict subset
of the per-member state (2pc's ``representative()``, like the
reference's) is not constant on orbits, so its reduced count depends
on search order.
"""

from __future__ import annotations

from typing import Any, Sequence, TypeVar

T = TypeVar("T")


class RewritePlan:
    """The permutation that sorts a collection, plus its inverse
    (rewrite_plan.rs:19-39, 81-106).

    ``reindex(xs)`` permutes a parallel collection into the sorted
    order (rewrite_plan.rs:110-123); ``rewrite(i)`` maps an old index
    to its new position — use it for indices *embedded inside* state
    (message fields, maps keyed by id, ...).
    """

    __slots__ = ("perm", "inverse")

    def __init__(self, perm: Sequence[int]):
        self.perm = tuple(perm)
        inverse = [0] * len(self.perm)
        for new_index, old_index in enumerate(self.perm):
            inverse[old_index] = new_index
        self.inverse = tuple(inverse)

    @staticmethod
    def from_values_to_sort(values: Sequence[Any]) -> "RewritePlan":
        """Plan that stably sorts ``values`` (rewrite_plan.rs:81-106)."""
        perm = sorted(range(len(values)), key=lambda i: values[i])
        return RewritePlan(perm)

    def reindex(self, values: Sequence[T]) -> list[T]:
        if len(values) != len(self.perm):
            raise ValueError(
                f"reindex length mismatch: {len(values)} != {len(self.perm)}"
            )
        return [values[i] for i in self.perm]

    def rewrite(self, old_index: int) -> int:
        return self.inverse[old_index]
