"""Racy and lock-guarded shared-counter models.

A copy of the JAX package's ``models.increment`` (stateright
examples/increment.rs and examples/increment_lock.rs): N threads
perform a non-atomic read-then-write increment of a shared counter.
Without a lock the final count can drop updates (the "fin" invariant
fails — this model is itself a race detector); with a lock both "fin"
and "mutex" hold. Class and field names match the JAX package's, so
host fingerprints and encoded paths are identical. The host
symmetry representative sorts the threads (the host DFS's
``.symmetry()``; the encodings declare no device rewrite spec).

The device encodings are :mod:`stateright_tpu_torch.models.increment_tpu`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple

from ..model import Model, Property


@dataclass(frozen=True)
class ProcState:
    t: int  # thread-local copy
    pc: int  # program counter


@dataclass(frozen=True)
class IncrementState:
    i: int  # shared counter
    lock: bool
    s: Tuple[ProcState, ...]

    def representative(self) -> "IncrementState":
        # Threads are interchangeable: sort them (increment_lock.rs:35-45).
        return replace(self, s=tuple(sorted(self.s, key=lambda p: (p.t, p.pc))))


class IncrementLock(Model):
    """Lock-guarded increment: pc 0 --Lock--> 1 --Read--> 2 --Write-->
    3 --Release--> 4 (increment_lock.rs)."""

    def __init__(self, thread_count: int = 3):
        self.thread_count = thread_count

    def to_encoded(self):
        """The device encoding (the wave engine discovers this hook)."""
        from .increment_tpu import IncrementLockEncoded

        return IncrementLockEncoded(self.thread_count)

    def init_states(self) -> Sequence[IncrementState]:
        return [
            IncrementState(
                i=0,
                lock=False,
                s=tuple(ProcState(0, 0) for _ in range(self.thread_count)),
            )
        ]

    def actions(self, state: IncrementState):
        actions = []
        for tid in range(self.thread_count):
            pc = state.s[tid].pc
            if pc == 0 and not state.lock:
                actions.append(("lock", tid))
            elif pc == 1:
                actions.append(("read", tid))
            elif pc == 2:
                actions.append(("write", tid))
            elif pc == 3 and state.lock:
                actions.append(("release", tid))
        return actions

    def next_state(self, state: IncrementState,
                   action) -> Optional[IncrementState]:
        kind, tid = action
        proc = state.s[tid]
        if kind == "lock":
            return self._set(state, tid, replace(proc, pc=1), lock=True)
        if kind == "read":
            return self._set(state, tid, replace(proc, pc=2, t=state.i))
        if kind == "write":
            return self._set(state, tid, replace(proc, pc=3), i=proc.t + 1)
        if kind == "release":
            return self._set(state, tid, replace(proc, pc=4), lock=False)
        raise ValueError(f"unknown action {action!r}")

    @staticmethod
    def _set(state, tid, proc, **updates):
        s = state.s[:tid] + (proc,) + state.s[tid + 1:]
        return replace(state, s=s, **updates)

    def properties(self):
        return [
            Property.always(
                "fin",
                lambda m, s: sum(1 for p in s.s if p.pc >= 3) == s.i,
            ),
            Property.always(
                "mutex",
                lambda m, s: sum(1 for p in s.s if 1 <= p.pc < 4) <= 1,
            ),
        ]


class Increment(Model):
    """Unguarded racy increment: pc 1 --Read--> 2 --Write--> 3
    (increment.rs); finds the classic lost update."""

    def __init__(self, thread_count: int = 2):
        self.thread_count = thread_count

    def to_encoded(self):
        """The device encoding (the wave engine discovers this hook)."""
        from .increment_tpu import IncrementEncoded

        return IncrementEncoded(self.thread_count)

    def init_states(self) -> Sequence[IncrementState]:
        return [
            IncrementState(
                i=0,
                lock=False,
                s=tuple(ProcState(0, 1) for _ in range(self.thread_count)),
            )
        ]

    def actions(self, state: IncrementState):
        actions = []
        for tid in range(self.thread_count):
            pc = state.s[tid].pc
            if pc == 1:
                actions.append(("read", tid))
            elif pc == 2:
                actions.append(("write", tid))
        return actions

    def next_state(self, state: IncrementState,
                   action) -> Optional[IncrementState]:
        kind, tid = action
        proc = state.s[tid]
        if kind == "read":
            return IncrementLock._set(state, tid,
                                      replace(proc, pc=2, t=state.i))
        if kind == "write":
            return IncrementLock._set(state, tid, replace(proc, pc=3),
                                      i=proc.t + 1)
        raise ValueError(f"unknown action {action!r}")

    def properties(self):
        return [
            Property.always(
                "fin",
                lambda m, s: sum(1 for p in s.s if p.pc >= 3) == s.i,
            ),
        ]
