"""Shared backtracking serializer for consistency testers.

A copy of the JAX package's ``semantics._serialize``. Implements the
search at the heart of the reference's
``LinearizabilityTester::serialize`` (src/semantics/linearizability.rs:
196-284) and its sequential-consistency sibling
(sequential_consistency.rs:179-240): interleave per-thread operation
histories into a total order that the sequential spec accepts,
respecting program order always and (for linearizability) the recorded
happens-before snapshots. In-flight operations may linearize — taking
whatever return the spec produces — or be left out entirely.

Adds memoization over (positions, consumed-in-flight, spec digest)
configurations, a sound pruning absent from the reference (identical
configurations always produce identical outcomes).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..fingerprint import stable_hash
from .spec import SequentialSpec


def serialize_history(
    init_spec: SequentialSpec,
    completed: Dict[Any, List[Tuple[tuple, Any, Any]]],
    in_flight: Dict[Any, Tuple[tuple, Any]],
    real_time: bool,
) -> Optional[List[Tuple[Any, Any]]]:
    """Return a legal total order of (op, ret), or None.

    ``completed[t]`` is thread t's in-order list of
    ``(snapshot, op, ret)``; ``snapshot`` is a tuple of
    ``(peer, last_completed_index)`` pairs captured at invoke time
    (empty and unused when ``real_time`` is False).
    """
    threads = sorted(set(completed) | set(in_flight))
    total = {t: len(completed.get(t, [])) for t in threads}
    failed: set = set()

    def violates(snapshot: tuple, pos: Dict[Any, int]) -> bool:
        # Op cannot linearize until every op it happened-after has
        # (linearizability.rs:225-238, 252-265).
        return any(pos.get(peer, 0) <= min_time for peer, min_time in snapshot)

    def rec(
        pos: Dict[Any, int],
        consumed: frozenset,
        spec: SequentialSpec,
        acc: List[Tuple[Any, Any]],
    ) -> Optional[List[Tuple[Any, Any]]]:
        if all(pos[t] == total[t] for t in threads):
            return acc  # in-flight ops may remain unlinearized
        key = (
            tuple(pos[t] for t in threads),
            consumed,
            stable_hash(spec),
        )
        if key in failed:
            return None
        for t in threads:
            if pos[t] < total[t]:
                snapshot, op, ret = completed[t][pos[t]]
                if real_time and violates(snapshot, pos):
                    continue
                next_spec = spec.is_valid_step(op, ret)
                if next_spec is None:
                    continue
                result = rec(
                    {**pos, t: pos[t] + 1}, consumed, next_spec, acc + [(op, ret)]
                )
                if result is not None:
                    return result
            elif t in in_flight and t not in consumed:
                snapshot, op = in_flight[t]
                if real_time and violates(snapshot, pos):
                    continue
                next_spec, ret = spec.invoke(op)
                result = rec(
                    pos, consumed | {t}, next_spec, acc + [(op, ret)]
                )
                if result is not None:
                    return result
        failed.add(key)
        return None

    return rec({t: 0 for t in threads}, frozenset(), init_spec, [])
