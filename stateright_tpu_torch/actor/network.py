"""Pluggable network semantics for actor systems.

A copy of the JAX package's ``actor.network`` (all three kinds share
one base class, so the module comes whole). Counterpart of stateright
src/actor/network.rs:47-68. A network value
is part of the model state, so all three semantics here are immutable
(operations return new networks) and stably hashable:

* :class:`UnorderedDuplicating` — a *set* of envelopes: delivery leaves
  the envelope in place (redeliverable — models duplication), dropping
  removes it forever (network.rs:51-52, 199-206, 252-254).
* :class:`UnorderedNonDuplicating` — a *multiset* (envelope → count):
  delivery decrements, dropping removes one instance
  (network.rs:55, 188-190, 207-220).
* :class:`Ordered` — per-directed-pair FIFO channels; only channel
  heads are deliverable, and empty flows are canonicalized away
  (network.rs:67, 191-196, 221-244).

Envelope iteration is sorted by a stable key so action enumeration is
deterministic across runs and processes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Iterator, Tuple

from ..fingerprint import stable_hash
from .base import Id

Msg = Any


@dataclass(frozen=True)
class Envelope:
    """A message in flight (network.rs:25-29)."""

    src: Id
    dst: Id
    msg: Msg


def _env_sort_key(env: Envelope) -> tuple:
    return (int(env.src), int(env.dst), stable_hash(env.msg))


class Network:
    """Base class + constructors mirroring ``Network::new_*``
    (network.rs:47-68) and name-based CLI selection
    (network.rs:120-146, 296-309)."""

    @staticmethod
    def new_unordered_duplicating(envelopes: Iterable[Envelope] = ()) -> "UnorderedDuplicating":
        return UnorderedDuplicating(frozenset(envelopes))

    @staticmethod
    def new_unordered_nonduplicating(envelopes: Iterable[Envelope] = ()) -> "UnorderedNonDuplicating":
        counts: dict[Envelope, int] = {}
        for env in envelopes:
            counts[env] = counts.get(env, 0) + 1
        return UnorderedNonDuplicating(counts)

    @staticmethod
    def new_ordered(envelopes: Iterable[Envelope] = ()) -> "Ordered":
        flows: dict[Tuple[Id, Id], tuple] = {}
        for env in envelopes:
            key = (env.src, env.dst)
            flows[key] = flows.get(key, ()) + (env.msg,)
        return Ordered(flows)

    @staticmethod
    def names() -> list[str]:
        return [
            "ordered",
            "unordered_duplicating",
            "unordered_nonduplicating",
        ]

    @staticmethod
    def from_name(name: str) -> "Network":
        if name == "ordered":
            return Network.new_ordered()
        if name in ("unordered_duplicating", "duplicating"):
            return Network.new_unordered_duplicating()
        if name in ("unordered_nonduplicating", "nonduplicating", "unordered"):
            return Network.new_unordered_nonduplicating()
        raise ValueError(
            f"unknown network {name!r}; expected one of {Network.names()}"
        )

    # interface -----------------------------------------------------------

    def send(self, env: Envelope) -> "Network":
        raise NotImplementedError

    def on_deliver(self, env: Envelope) -> "Network":
        raise NotImplementedError

    def on_drop(self, env: Envelope) -> "Network":
        raise NotImplementedError

    def iter_deliverable(self) -> Iterator[Envelope]:
        """Distinct deliverable envelopes (network.rs:160-170)."""
        raise NotImplementedError

    def iter_all(self) -> Iterator[Envelope]:
        """All envelopes, counting duplicates (network.rs:149-157)."""
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class UnorderedDuplicating(Network):
    __slots__ = ("envelopes", "_digest")

    def __init__(self, envelopes: frozenset):
        self.envelopes = envelopes
        self._digest: int | None = None

    def send(self, env: Envelope) -> "UnorderedDuplicating":
        if env in self.envelopes:
            return self
        return UnorderedDuplicating(self.envelopes | {env})

    def on_deliver(self, env: Envelope) -> "UnorderedDuplicating":
        return self  # redeliverable: delivery is a no-op (network.rs:204-206)

    def on_drop(self, env: Envelope) -> "UnorderedDuplicating":
        return UnorderedDuplicating(self.envelopes - {env})

    def iter_deliverable(self) -> Iterator[Envelope]:
        return iter(sorted(self.envelopes, key=_env_sort_key))

    def iter_all(self) -> Iterator[Envelope]:
        return self.iter_deliverable()

    def __len__(self) -> int:
        return len(self.envelopes)

    def _stable_hash_(self) -> int:
        if self._digest is None:
            self._digest = stable_hash(("UnorderedDuplicating", self.envelopes))
        return self._digest

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, UnorderedDuplicating)
            and self.envelopes == other.envelopes
        )

    def __hash__(self) -> int:
        return self._stable_hash_()

    def __repr__(self) -> str:
        return f"UnorderedDuplicating({sorted(self.envelopes, key=_env_sort_key)!r})"


class UnorderedNonDuplicating(Network):
    __slots__ = ("counts", "_digest")

    def __init__(self, counts: dict):
        self.counts = counts
        self._digest: int | None = None

    def send(self, env: Envelope) -> "UnorderedNonDuplicating":
        counts = dict(self.counts)
        counts[env] = counts.get(env, 0) + 1
        return UnorderedNonDuplicating(counts)

    def on_deliver(self, env: Envelope) -> "UnorderedNonDuplicating":
        count = self.counts.get(env)
        if count is None:
            raise KeyError(f"envelope not in network: {env!r}")
        counts = dict(self.counts)
        if count == 1:
            del counts[env]
        else:
            counts[env] = count - 1
        return UnorderedNonDuplicating(counts)

    def on_drop(self, env: Envelope) -> "UnorderedNonDuplicating":
        return self.on_deliver(env)  # same multiset decrement

    def iter_deliverable(self) -> Iterator[Envelope]:
        return iter(sorted(self.counts.keys(), key=_env_sort_key))

    def iter_all(self) -> Iterator[Envelope]:
        for env in sorted(self.counts.keys(), key=_env_sort_key):
            for _ in range(self.counts[env]):
                yield env

    def __len__(self) -> int:
        return sum(self.counts.values())

    def _stable_hash_(self) -> int:
        if self._digest is None:
            self._digest = stable_hash(("UnorderedNonDuplicating", self.counts))
        return self._digest

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, UnorderedNonDuplicating)
            and self.counts == other.counts
        )

    def __hash__(self) -> int:
        return self._stable_hash_()

    def __repr__(self) -> str:
        inner = {env: n for env, n in sorted(self.counts.items(), key=lambda kv: _env_sort_key(kv[0]))}
        return f"UnorderedNonDuplicating({inner!r})"


class Ordered(Network):
    """Per-(src, dst) FIFO flows; flows are never empty (canonical form,
    network.rs:221-244)."""

    __slots__ = ("flows", "_digest")

    def __init__(self, flows: dict):
        self.flows = {k: v for k, v in flows.items() if v}
        self._digest: int | None = None

    def send(self, env: Envelope) -> "Ordered":
        flows = dict(self.flows)
        key = (env.src, env.dst)
        flows[key] = flows.get(key, ()) + (env.msg,)
        return Ordered(flows)

    def on_deliver(self, env: Envelope) -> "Ordered":
        key = (env.src, env.dst)
        flow = self.flows.get(key)
        if flow is None:
            raise KeyError(f"flow not found: {key!r}")
        try:
            i = flow.index(env.msg)
        except ValueError:
            raise KeyError(f"message not in flow {key!r}: {env.msg!r}")
        flows = dict(self.flows)
        remaining = flow[:i] + flow[i + 1:]
        if remaining:
            flows[key] = remaining
        else:
            del flows[key]
        return Ordered(flows)

    def on_drop(self, env: Envelope) -> "Ordered":
        return self.on_deliver(env)

    def iter_deliverable(self) -> Iterator[Envelope]:
        # All messages in flow order; the ActorModel delivers only
        # channel heads (model.rs:244-260 prev_channel logic).
        for (src, dst) in sorted(self.flows.keys()):
            for msg in self.flows[(src, dst)]:
                yield Envelope(src, dst, msg)

    def iter_all(self) -> Iterator[Envelope]:
        return self.iter_deliverable()

    def __len__(self) -> int:
        return sum(len(f) for f in self.flows.values())

    def _stable_hash_(self) -> int:
        if self._digest is None:
            self._digest = stable_hash(("Ordered", self.flows))
        return self._digest

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Ordered) and self.flows == other.flows

    def __hash__(self) -> int:
        return self._stable_hash_()

    def __repr__(self) -> str:
        return f"Ordered({dict(sorted(self.flows.items()))!r})"
