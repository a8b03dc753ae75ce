"""Carry a JAX sort-merge engine's resident state across to the port.

The JAX engine's carry (``stateright_tpu.checkers.tpu_sortmerge``,
built by its ``seed()`` and advanced by its chunk program) holds the
visited keys as ``vkeys uint32[2, C_pad]`` — lo limbs in row 0, hi limbs
in row 1, a sorted prefix of real keys and an all-ones sentinel tail —
the frontier as ``uint32[W, F]`` with ``n_frontier`` live columns, and
per-row eventually-bits ``ebits uint32[F]``. :func:`carry_from_numpy`
turns those arrays (as numpy) into the port's
:class:`~stateright_tpu_torch.checkers.tpu_sortmerge.WaveState`, so a
run can continue on the port from the JAX engine's mid-depth state.

A tiered JAX run keeps the rest of its visited set as cold runs in host
memory (``stateright_tpu.tier.ColdStore``); :func:`cold_store_from_runs`
turns its ``snapshot_runs()`` into the port's
:class:`~stateright_tpu_torch.tier.ColdStore`, which a wave state
carries as ``cold`` (``carry_from_numpy(..., cold=...)``).
"""

from __future__ import annotations

import numpy as np
import torch

from .checkers.tpu_sortmerge import WaveState
from .ops.fingerprint import SENTINEL_KEY, pack_keys
from .tier import ColdStore


def carry_from_numpy(vkeys, frontier, n_frontier: int, ebits, *,
                     depth: int = 1, generated: int = 0,
                     device="cpu", cold: ColdStore | None = None
                     ) -> WaveState:
    """The port's wave state from a JAX carry's arrays.

    ``depth`` and ``generated`` are the carry's ``depth`` and
    ``gen_lo | gen_hi << 32`` (the ``states=`` counter). The parent log
    does not carry over: a continued run reconstructs paths only for
    states it generates itself. ``cold`` is the run's cold tier (see
    :func:`cold_store_from_runs`): a run started from such a state is
    tiered from its first wave."""
    vk = torch.from_numpy(np.asarray(vkeys, np.uint32).astype(np.int64))
    keys = pack_keys(vk[0], vk[1])
    keys = keys[keys != SENTINEL_KEY]
    if keys.numel() > 1 and not bool((keys[1:] > keys[:-1]).all()):
        raise ValueError("vkeys must be a strictly sorted prefix of "
                         "distinct keys followed by sentinels")
    n = int(n_frontier)
    front = np.asarray(frontier, np.uint32)[:, :n].astype(np.int64)
    eb = np.asarray(ebits, np.uint32)[:n].astype(np.int64)
    dev = torch.device(device)
    return WaveState(
        vkeys=keys.to(dev),
        frontier=torch.from_numpy(front).to(dev),
        ebits=torch.from_numpy(eb).to(dev),
        depth=int(depth),
        generated=int(generated),
        cold=cold,
    )


def cold_store_from_runs(per_shard_runs, max_runs: int = 8,
                         spills: int = 0) -> ColdStore:
    """The port's cold store from a JAX ``ColdStore.snapshot_runs()``:
    per shard a list of ``(lo, hi)`` numpy uint32 pairs, each run
    ``(hi, lo)``-sorted. A single-device run takes ``n_shards=1``
    runs; a mesh snapshot re-shards first (the JAX
    ``repartitioned(1)``)."""
    return ColdStore.from_runs(per_shard_runs, max_runs=max_runs,
                               spills=spills)
