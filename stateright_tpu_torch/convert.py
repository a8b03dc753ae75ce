"""Carry a JAX sort-merge engine's resident state across to the port.

The JAX engine's carry (``stateright_tpu.checkers.tpu_sortmerge``,
built by its ``seed()`` and advanced by its chunk program) holds the
visited keys as ``vkeys uint32[2, C_pad]`` — lo limbs in row 0, hi limbs
in row 1, a sorted prefix of real keys and an all-ones sentinel tail —
the frontier as ``uint32[W, F]`` with ``n_frontier`` live columns,
per-row eventually-bits ``ebits uint32[F]``, the parent log as ``plog
uint32[4, L]`` (parent limbs in lanes 0-1, child limbs in lanes 2-3)
with ``pl_n`` live columns, and the discovery lanes ``disc_found`` /
``disc_lo`` / ``disc_hi``, one per property. :func:`carry_from_numpy`
turns those arrays (as numpy) into the port's
:class:`~stateright_tpu_torch.checkers.tpu_sortmerge.WaveState`, so a
run can continue on the port from the JAX engine's mid-depth state. A
snapshot (checkpoint.py) holds the same arrays, whichever package wrote
it.

A tiered JAX run keeps the rest of its visited set as cold runs in host
memory (``stateright_tpu.tier.ColdStore``); :func:`cold_store_from_runs`
turns its ``snapshot_runs()`` into the port's
:class:`~stateright_tpu_torch.tier.ColdStore`, which a wave state
carries as ``cold`` (``carry_from_numpy(..., cold=...)``).

The JAX sharded sort-merge engine's carry holds the same leaves with a
shard's block at a stride of its padded per-shard capacities, and the
per-shard counts ``u_loc``, ``n_loc`` and ``pl_n``;
:func:`mesh_from_numpy` turns it into the port's sharded state, one
wave state a shard, for ``spawn_sharded_sortmerge(...).start_from``.
"""

from __future__ import annotations

import numpy as np
import torch

from .checkers.tpu_sortmerge import WaveState
from .ops.fingerprint import SENTINEL_KEY
from .tier import ColdStore, pack_keys_np


def plog_blocks(plog, n: int | None = None) -> tuple:
    """``(parent keys, child keys)`` int64 numpy arrays of the first
    ``n`` (default: every) columns of a JAX ``plog uint32[4, L]``."""
    p = np.asarray(plog, np.uint32)
    n = p.shape[1] if n is None else int(n)
    return pack_keys_np(p[0, :n], p[1, :n]), pack_keys_np(p[2, :n], p[3, :n])


def carry_from_numpy(vkeys, frontier, n_frontier: int, ebits, *,
                     depth: int = 1, generated: int = 0,
                     device="cpu", cold: ColdStore | None = None,
                     n_visited: int | None = None, plog=None,
                     pl_n: int | None = None, host_plog=(),
                     waves: int = 0, disc=None, props=()) -> WaveState:
    """The port's wave state from a JAX carry's arrays.

    ``depth`` and ``generated`` are the carry's ``depth`` and
    ``gen_lo | gen_hi << 32`` (the ``states=`` counter), ``waves`` its
    ``waves``. ``n_visited`` bounds the visited prefix (default: up to
    the first sentinel). ``cold`` is the run's cold tier (see
    :func:`cold_store_from_runs`): a run started from such a state is
    tiered from its first wave.

    ``plog`` with ``pl_n`` live columns is the parent log, and
    ``host_plog`` a tiered run's parent-log blocks already in host
    memory (``(parent keys, child keys)`` int64 pairs); without them a
    continued run reconstructs paths only for states it generates
    itself. With ``cold`` the log stays in host memory, as a tiered
    run keeps it; otherwise it goes to ``device``. ``disc`` is the
    discovery lanes ``(found, lo, hi)``, indexed like ``props`` (the
    model's properties); each found lane becomes a discovery."""
    vk = np.asarray(vkeys, np.uint32)
    if n_visited is not None:
        vk = vk[:, :int(n_visited)]
    keys = torch.from_numpy(pack_keys_np(vk[0], vk[1]))
    keys = keys[keys != SENTINEL_KEY]
    if keys.numel() > 1 and not bool((keys[1:] > keys[:-1]).all()):
        raise ValueError("vkeys must be a strictly sorted prefix of "
                         "distinct keys followed by sentinels")
    n = int(n_frontier)
    front = np.asarray(frontier, np.uint32)[:, :n].astype(np.int64)
    eb = np.asarray(ebits, np.uint32)[:n].astype(np.int64)
    dev = torch.device(device)
    blocks = [(torch.from_numpy(p), torch.from_numpy(c))
              for p, c in host_plog]
    if plog is not None and (pl_n is None or int(pl_n)):
        blocks.append(tuple(torch.from_numpy(a)
                            for a in plog_blocks(plog, pl_n)))
    if cold is None:
        blocks = [(p.to(dev), c.to(dev)) for p, c in blocks]
    discovered = {}
    if disc is not None:
        found, lo, hi = (np.asarray(a) for a in disc)
        for i, p in enumerate(props):
            if bool(found[i]):
                discovered[p.name] = (int(hi[i]) << 32) | int(lo[i])
    return WaveState(
        vkeys=keys.to(dev),
        frontier=torch.from_numpy(front).to(dev),
        ebits=torch.from_numpy(eb).to(dev),
        depth=int(depth),
        generated=int(generated),
        plog=blocks,
        cold=cold,
        waves=int(waves),
        discovered=discovered,
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


def mesh_from_numpy(carry: dict, *, n_shards: int, capacity: int,
                    frontier_capacity: int, track_paths: bool = True,
                    props=()):
    """The port's sharded state (parallel/engine_sortmerge.py
    ``MeshState``) from a JAX sharded sort-merge carry or mesh snapshot
    (numpy leaves): per shard ``s`` its visited keys ``vkeys[:,
    s*(C+F):][:u_loc[s]]``, frontier block ``frontier[:, s*F:][:n_loc[s]]``
    with its ``ebits``, and parent log ``plog[:, s*(C+F):][:pl_n[s]]``,
    ``C`` and ``F`` the JAX engine's per-shard ``capacity`` and
    ``frontier_capacity``; the counters, the routed-row count and the
    discovery lanes as :func:`carry_from_numpy` reads them. Each shard's
    tensors stay in host memory until a run (``start_from``) uploads
    them to its device."""
    from .checkpoint import (
        _discovered_lanes,
        _sortmerge_blocks,
        _wave_state,
    )
    from .parallel.engine_sortmerge import MeshState

    manifest = dict(n_shards=int(n_shards), kind="sharded",
                    capacity=int(capacity),
                    frontier_capacity=int(frontier_capacity),
                    track_paths=bool(track_paths))
    blocks = _sortmerge_blocks("carry", manifest, carry)

    def scalar(name):
        return int(np.asarray(carry.get(name, 0)).reshape(-1)[0])

    return MeshState(
        shards=[_wave_state(b, track_paths) for b in blocks],
        depth=scalar("depth"),
        generated=scalar("gen_lo") | (scalar("gen_hi") << 32),
        waves=scalar("waves"),
        routed=scalar("sent_lo") | (scalar("sent_hi") << 32),
        discovered=_discovered_lanes(props, carry))
