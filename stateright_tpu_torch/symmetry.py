"""Symmetry reduction: canonical representatives via sort permutations.

A copy of the JAX package's ``symmetry`` module (stateright
src/checker/{representative,rewrite,rewrite_plan}.rs). A state's
``representative()`` sorts its interchangeable participants and
rewrites every embedded index by the same permutation ("Symmetric
Spin", representative.rs:7-16): the :class:`Representative` protocol,
the :class:`RewritePlan`, the recursive id rewrite
(:func:`rewrite_value`, with its ``_rewrite_ids_`` hook and its loud
``TypeError`` on a type it does not understand) and the generic actor
representative (:func:`actor_state_representative`, attached as
``ActorModelState.representative``) over the three network kinds. The
host DFS and simulation checkers take any such callable
(``CheckerBuilder.symmetry()`` / ``symmetry_fn``); the visited key is
the representative's fingerprint while the search continues from the
original state, so counterexample paths stay replayable.

The host models' ``representative_full()`` sorts the FULL per-member
tuple: it is constant on orbits, and it is the host oracle of the
device canonicalizer (ops/canonical.py), which sorts the same tuple in
the same encoded order. A representative that sorts on a strict subset
of the per-member state (2pc's ``representative()``, like the
reference's) is not constant on orbits, so its reduced count depends
on search order: the reference's 665 for 2pc rm=5 is a depth-first
count.
"""

from __future__ import annotations

import enum
from dataclasses import fields, is_dataclass
from dataclasses import replace as dc_replace
from typing import Any, Iterable, Protocol, Sequence, TypeVar, runtime_checkable

#: lazily bound by rewrite_value (import cycle: utils.hashable is free of
#: cycles, actor.base imports nothing from here — but keep symmetry
#: importable without the actor package)
_ID_TYPE = None
_HASHABLE_TYPES = None

T = TypeVar("T")


@runtime_checkable
class Representative(Protocol):
    """States supporting canonicalization (representative.rs:65-68)."""

    def representative(self) -> "Representative": ...


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


def sorted_representative_key(values: Iterable[Any]) -> tuple:
    """Helper: canonical key for fully-interchangeable values with no
    embedded indices — just the sorted tuple."""
    return tuple(sorted(values))


def rewrite_value(value: Any, plan: RewritePlan) -> Any:
    """Recursively rewrite every embedded :class:`~stateright_tpu.actor.Id`
    inside ``value`` — the counterpart of the reference's ``Rewrite``
    trait impls (rewrite.rs:24-163): scalars pass through, containers
    and (frozen) dataclasses recurse, ``Id``s map through the plan.

    Soundness note (shared with the reference): an actor id stored as a
    PLAIN int is indistinguishable from data and passes through
    unrewritten — models must use the ``Id`` type for embedded ids, as
    the reference must use its ``Id`` newtype. Types this function does
    not understand raise rather than silently passing through; give
    them a ``_rewrite_ids_(plan)`` method.
    """
    global _ID_TYPE, _HASHABLE_TYPES
    if _ID_TYPE is None:
        from .actor.base import Id

        _ID_TYPE = Id
    Id = _ID_TYPE

    hook = getattr(value, "_rewrite_ids_", None)
    if hook is not None:
        return hook(plan)
    if isinstance(value, Id):
        return Id(plan.rewrite(int(value)))
    if isinstance(value, enum.Enum) or isinstance(
        value, (bool, int, float, complex, str, bytes, type(None))
    ):
        return value
    if is_dataclass(value) and not isinstance(value, type):
        return dc_replace(
            value,
            **{
                f.name: rewrite_value(getattr(value, f.name), plan)
                for f in fields(value)
            },
        )
    if isinstance(value, tuple):
        return tuple(rewrite_value(v, plan) for v in value)
    if isinstance(value, list):
        return [rewrite_value(v, plan) for v in value]
    if isinstance(value, (set, frozenset)):
        return frozenset(rewrite_value(v, plan) for v in value)
    if isinstance(value, dict):
        return {
            rewrite_value(k, plan): rewrite_value(v, plan)
            for k, v in value.items()
        }
    if _HASHABLE_TYPES is None:
        from .utils.hashable import HashableMap, HashableSet

        globals()["_HASHABLE_TYPES"] = (HashableMap, HashableSet)
    HashableMap, HashableSet = _HASHABLE_TYPES
    if isinstance(value, HashableMap):
        return HashableMap(
            {
                rewrite_value(k, plan): rewrite_value(v, plan)
                for k, v in value.items()
            }
        )
    if isinstance(value, HashableSet):
        return HashableSet(rewrite_value(v, plan) for v in value)
    raise TypeError(
        f"cannot rewrite actor ids inside {type(value).__name__!r}; "
        "generic actor symmetry would silently collapse distinct states "
        "— implement _rewrite_ids_(plan) on the type or use a "
        "model-specific representative"
    )


def actor_state_representative(state):
    """Canonicalize an ``ActorModelState`` by sorting actor states and
    rewriting ids embedded EVERYWHERE — actor states, message payloads,
    network endpoints, timers, and history — mirroring the reference's
    recursive ``Rewrite`` (model_state.rs:115-132, rewrite.rs:146-163,
    network.rs:311-324).

    Requires all actors to be interchangeable; models with distinct
    roles (e.g. servers vs clients) should define their own
    representative over the symmetric sub-range instead.
    """
    from dataclasses import replace

    from .actor.model_state import ActorModelState
    from .actor.network import (
        Envelope,
        Ordered,
        UnorderedDuplicating,
        UnorderedNonDuplicating,
    )
    from .fingerprint import stable_hash

    assert isinstance(state, ActorModelState)
    plan = RewritePlan.from_values_to_sort(
        [stable_hash(s) for s in state.actor_states]
    )

    def rw(value):
        return rewrite_value(value, plan)

    network = state.network
    if isinstance(network, UnorderedDuplicating):
        new_network = UnorderedDuplicating(
            frozenset(
                Envelope(rw(e.src), rw(e.dst), rw(e.msg))
                for e in network.envelopes
            )
        )
    elif isinstance(network, UnorderedNonDuplicating):
        new_network = UnorderedNonDuplicating(
            {
                Envelope(rw(e.src), rw(e.dst), rw(e.msg)): n
                for e, n in network.counts.items()
            }
        )
    elif isinstance(network, Ordered):
        new_network = Ordered(
            {
                (rw(src), rw(dst)): tuple(rw(m) for m in msgs)
                for (src, dst), msgs in network.flows.items()
            }
        )
    else:
        raise TypeError(f"unknown network type {type(network)!r}")

    return replace(
        state,
        actor_states=tuple(rw(s) for s in plan.reindex(state.actor_states)),
        timers_set=tuple(
            frozenset(rw(t) for t in ts)
            for ts in plan.reindex(state.timers_set)
        ),
        crashed=tuple(plan.reindex(state.crashed)),
        network=new_network,
        history=rw(state.history),
    )
