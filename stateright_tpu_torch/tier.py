"""The tiered visited set: a host-DRAM COLD tier behind the device-hot
sorted visited keys of the sort-merge engine.

The port of the JAX package's ``tier`` module. Without it the visited
set lives wholly on the card, so the card's memory caps the reachable
space; with it the visited set is two tiers:

* **HOT** — the engine's sorted int64 ``vkeys`` on the device, capped
  at a ceiling (``tier_hot_rows``; ``"auto"`` asks
  :func:`stateright_tpu_torch.memplan.decide_hot_rows`). Each wave's
  membership and merge still run through the CUDA Merge Path kernels,
  over the HOT keys only.
* **COLD** — sorted immutable runs in host memory (:class:`ColdStore`).
  A spill moves the whole hot prefix here. It is already sorted, so a
  run needs no host sort. Ingest and compaction run on a worker thread,
  overlapped with the next waves; membership joins the worker first
  (:meth:`ColdStore.sync`).

**Exactness.** With a non-empty cold tier a candidate that is new to
the hot tier is only PROVISIONALLY new. The engine downloads those
keys at the sync the wave already makes, tests them against the cold
runs here (:meth:`ColdStore.member`, a batched binary search), and
commits only the survivors: count, frontier, parent log and the
hot-tier merge see exactly the truly new rows, in the key order of a
resident run, so counts, depth and paths are those of a resident run.
A key is spilled at most once (a cold member never re-enters the hot
tier), so the runs are disjoint and ``hot + cold`` is the exact unique
count.

**Keys.** A run holds the port's packed int64 keys
(``ops/fingerprint.py::pack_keys``: ``((hi ^ 0x80000000) << 32) |
lo``), which order as the JAX package's unsigned ``(hi, lo)`` pairs, so
a downloaded ``vkeys`` is a sorted run as it stands. The snapshot
interface (:meth:`ColdStore.snapshot_runs`, :meth:`ColdStore.from_runs`,
:meth:`ColdStore.repartitioned`) keeps the JAX package's per-shard
``(lo, hi)`` uint32 pairs, with owner ``lo % S``.

Numpy and the standard library only: the device side lives in the
engine (checkers/tpu_sortmerge.py), the pricing in memplan.py.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

#: logical bytes per cold-tier key: one packed int64.
COLD_BYTES_PER_ROW = 8

_FLIP = np.uint64(1 << 63)
_M32 = np.uint64(0xFFFFFFFF)


def pack_keys_np(lo, hi) -> np.ndarray:
    """The port's packed int64 key of each ``(lo, hi)`` uint32 pair:
    the unsigned ``hi << 32 | lo`` with its top bit flipped, so signed
    int64 order is unsigned ``(hi, lo)`` order."""
    u = ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
         | np.asarray(lo).astype(np.uint64))
    return (u ^ _FLIP).view(np.int64)


def unpack_keys_np(keys) -> tuple[np.ndarray, np.ndarray]:
    """``(lo, hi)`` uint32 limbs of packed int64 keys."""
    u = np.ascontiguousarray(keys, np.int64).view(np.uint64) ^ _FLIP
    return (u & _M32).astype(np.uint32), (u >> np.uint64(32)).astype(
        np.uint32)


def member_mask(run: np.ndarray, q: np.ndarray) -> np.ndarray:
    """``bool[len(q)]``: which packed query keys appear in the sorted
    packed run (one vectorized binary search)."""
    if run.size == 0 or q.size == 0:
        return np.zeros(q.shape, bool)
    idx = np.searchsorted(run, q)
    idx = np.minimum(idx, run.size - 1)
    return run[idx] == q


class ColdStore:
    """The host-DRAM cold tier: per-shard lists of sorted immutable runs
    of packed int64 keys, with ingest and run compaction on a worker
    thread.

    Per shard because the JAX package's mesh engines spill per shard
    (each shard owns the keys with ``lo % S == shard``); the port's
    single-device engine is the ``n_shards=1`` case."""

    def __init__(self, n_shards: int = 1, max_runs: int = 8):
        self.n_shards = int(n_shards)
        self.max_runs = int(max_runs)
        #: per-shard list of sorted int64 arrays (immutable runs)
        self.runs: list[list[np.ndarray]] = [
            [] for _ in range(self.n_shards)
        ]
        self.spills = 0
        self._lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        #: wall seconds spent in ingest and compaction (on the worker
        #: when asynchronous: the overlapped cost)
        self.ingest_sec = 0.0

    # -- ingest (the spill path) ------------------------------------------

    def ingest(self, per_shard: list, *, asynchronous: bool = True) -> None:
        """Append one spill — per shard one sorted int64 key array — as
        new runs. ``asynchronous=True`` appends and compacts on a worker
        thread, overlapped with the caller's next waves; :meth:`sync`
        joins it. At most one ingest is in flight: a new one joins the
        last first."""
        self.sync()
        keys = [np.ascontiguousarray(k, np.int64) for k in per_shard]
        self.spills += 1
        if not asynchronous:
            self._do_ingest(keys)
            return
        t = threading.Thread(target=self._do_ingest, args=(keys,),
                             name="stpu-torch-tier-ingest", daemon=True)
        self._worker = t
        t.start()

    def _do_ingest(self, per_shard) -> None:
        t0 = time.monotonic()
        for s, run in enumerate(per_shard):
            if run.size == 0:
                continue
            with self._lock:
                self.runs[s].append(run)
                if len(self.runs[s]) > self.max_runs:
                    # compaction: the runs are disjoint, so one sort of
                    # their concatenation is their merge
                    self.runs[s] = [np.sort(np.concatenate(self.runs[s]))]
        self.ingest_sec += time.monotonic() - t0

    def sync(self) -> None:
        """Join any ingest in flight (before membership reads and
        snapshots)."""
        w = self._worker
        if w is not None and w.is_alive():
            w.join()
        self._worker = None

    # -- membership -------------------------------------------------------

    def member(self, shard: int, keys) -> np.ndarray:
        """``bool[len(keys)]``: which packed int64 query keys one
        shard's runs hold — the host half of the tiered dedup. Call
        :meth:`sync` first when an ingest may be in flight."""
        q = np.ascontiguousarray(keys, np.int64)
        out = np.zeros(q.shape, bool)
        with self._lock:
            runs = list(self.runs[shard])
        for run in runs:
            out |= member_mask(run, q)
        return out

    # -- accounting -------------------------------------------------------

    def rows(self) -> int:
        with self._lock:
            return int(sum(r.size for shard in self.runs for r in shard))

    def shard_rows(self) -> list[int]:
        with self._lock:
            return [int(sum(r.size for r in shard)) for shard in self.runs]

    def bytes(self) -> int:
        return self.rows() * COLD_BYTES_PER_ROW

    def run_count(self) -> int:
        with self._lock:
            return sum(len(shard) for shard in self.runs)

    def summary(self) -> dict:
        """The accounting block: shards, spills, runs, rows and bytes
        (in all and per shard) and the ingest wall."""
        return dict(
            n_shards=self.n_shards,
            spills=int(self.spills),
            runs=self.run_count(),
            cold_rows_total=self.rows(),
            cold_bytes_total=self.bytes(),
            rows_per_shard=self.shard_rows(),
            ingest_sec=round(self.ingest_sec, 6),
        )

    # -- snapshot / re-shard (the JAX package's (lo, hi) interface) ------

    def snapshot_runs(self) -> list:
        """Per shard, the ``(lo, hi)`` uint32 limbs of every run, each
        ``(hi, lo)``-sorted — the JAX ``ColdStore.snapshot_runs``
        layout."""
        self.sync()
        with self._lock:
            return [[unpack_keys_np(r) for r in shard]
                    for shard in self.runs]

    @classmethod
    def from_runs(cls, per_shard_runs, max_runs: int = 8,
                  spills: int = 0) -> "ColdStore":
        """A store from snapshot runs: per-shard lists of ``(lo, hi)``
        pairs, each ``(hi, lo)``-sorted (a JAX or port
        :meth:`snapshot_runs`)."""
        store = cls(n_shards=len(per_shard_runs), max_runs=max_runs)
        store.spills = int(spills)
        for s, shard in enumerate(per_shard_runs):
            for lo, hi in shard:
                if np.asarray(lo).size:
                    store.runs[s].append(pack_keys_np(
                        np.asarray(lo, np.uint32),
                        np.asarray(hi, np.uint32)))
        return store

    def repartitioned(self, n_shards_new: int,
                      max_runs: Optional[int] = None) -> "ColdStore":
        """The runs split by the owner function ``lo % n_shards_new``.
        Filtering a sorted run keeps it sorted, and disjoint runs stay
        disjoint."""
        self.sync()
        out = ColdStore(
            n_shards=n_shards_new,
            max_runs=self.max_runs if max_runs is None else max_runs,
        )
        out.spills = self.spills
        S = np.uint64(max(n_shards_new, 1))
        with self._lock:
            for shard in self.runs:
                for run in shard:
                    owner = (run.view(np.uint64) & _M32) % S
                    for d in range(n_shards_new):
                        piece = run[owner == np.uint64(d)]
                        if piece.size:
                            out.runs[d].append(piece)
        return out
