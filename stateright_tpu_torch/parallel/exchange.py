"""The (owner, fp) route and the exchange between shards.

The counterpart of the JAX sharded engines' routing sort and
``lax.all_to_all`` (``parallel/engine_sortmerge.py`` ``make_wave``; the
hash engine's per-destination scatter in ``parallel/engine.py``). The
JAX engines compile static shapes, so they pack each destination's rows
into a fixed ``Bd``-row tile of a send buffer; the port sizes every
wave exactly and needs no tiles:

1. **the owner** of a key is ``lo % S``, ``lo`` the low 32 bits of the
   packed int64 key — JAX's ``fp_lo % n_shards`` (under symmetry the
   key is the canonical one, so a whole orbit has one owner);
2. **the route** (:func:`route`), per source shard: one stable partition
   of the source's candidate columns by owner, so each destination's
   rows are contiguous and keep the source's own order; rows whose key
   is the sentinel (excluded pairs) are dropped;
3. **the counts**: each source's per-destination counts form one row of
   an S×S matrix, read on the host at the wave's sync (:func:`host_rows`
   gathers such rows from every shard in one transfer);
4. **the exchange** (:func:`exchange`): destination ``d`` receives, in
   source order, the slice of each source's routed block that ``d``
   owns — one copy per (source, destination) pair, a view where both
   shards share a device and a device-to-device copy where they do not
   (never staged through the host).

The received rows are thus ordered by source shard, then by the
source's own candidate order, which is the order JAX's owner-local
stable sort sees after its ``(owner, hi, lo)`` routing sort (a stable
sort keeps equal keys of one source in candidate order). The owner's
stable candidate sort then keeps the same winner among duplicates, the
same parent and the same path as the JAX engine.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops.fingerprint import SENTINEL_KEY

_M32 = 0xFFFFFFFF


def resolve_devices(n_shards: Optional[int] = None,
                    devices: Optional[Sequence] = None) -> list:
    """The devices of a sharded run, one a shard. With ``devices`` given
    (a device may repeat), ``n_shards``, if given too, must equal its
    length. Without, one shard per visible CUDA device, or the first
    ``n_shards`` of them; more shards than cards raise, as the JAX
    engines' ``n_shards > available devices`` does. The CPU is used only
    when the caller lists CPU devices, and a list never mixes CUDA and
    CPU devices."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "no CUDA device: the sharded engines run on the GPUs unless "
                "devices=['cpu'] * n_shards is passed")
        n = count if n_shards is None else int(n_shards)
        if n > count:
            raise ValueError(
                f"n_shards={n} > {count} available devices (pass devices="
                "[...] to place several shards on one card)")
        devices = [f"cuda:{i}" for i in range(n)]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a sharded run needs at least one device")
    if n_shards is not None and int(n_shards) != len(devs):
        raise ValueError(
            f"n_shards={n_shards} but {len(devs)} devices were listed")
    if len({d.type for d in devs}) != 1:
        raise ValueError(
            f"a device list is all CUDA or all CPU, got {[str(d) for d in devs]}")
    # cuda means the current card; a shard names its card
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]


def owner_of(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """The owning shard of each packed key: its low 32 bits mod ``S``."""
    return (keys & _M32) % n_shards


def route(payload: torch.Tensor, keys: torch.Tensor, n_shards: int):
    """One source shard's route: ``(routed, counts)``. ``payload`` is the
    source's ``[lanes, n]`` candidate block and ``keys`` its ``n`` packed
    keys; ``routed`` holds the columns of non-sentinel keys, stably
    partitioned by owner (destination 0's columns first, each run in the
    source's order), and ``counts`` (int64 ``[S]``, on the source's
    device) the columns each destination gets."""
    owner = torch.where(keys == SENTINEL_KEY, n_shards,
                        owner_of(keys, n_shards))
    order = torch.argsort(owner, stable=True)
    counts = torch.bincount(owner, minlength=n_shards + 1)[:n_shards]
    return payload[:, order], counts


def host_rows(rows: Sequence[torch.Tensor]) -> list:
    """Equal-length int64 rows, one a shard, as host lists in one
    transfer: each row is copied to the first row's device (card to card
    where they differ), and the stack is read once."""
    from ..checkers.tpu import host_read

    dev = rows[0].device
    return host_read(torch.stack([r.to(dev) for r in rows]))


def exchange(routed: Sequence[torch.Tensor], counts: Sequence[Sequence[int]],
             devices: Sequence[torch.device]) -> list:
    """Deliver each source's routed block to its destinations:
    ``received[d]`` is ``[lanes, R_d]`` on ``devices[d]``, the columns
    each source ``s`` routed to ``d`` (``counts[s][d]`` of them), in
    source order. A piece on the destination's device is a view; any
    other is one device-to-device copy."""
    S = len(devices)
    starts = []
    for row in counts:
        off, st = 0, []
        for c in row:
            st.append(off)
            off += int(c)
        starts.append(st)
    received = []
    for d in range(S):
        parts = [routed[s][:, starts[s][d]:starts[s][d] + int(counts[s][d])]
                 .to(devices[d]) for s in range(S)]
        received.append(parts[0] if S == 1 else torch.cat(parts, dim=1))
    return received


def routed_off_shard(counts: Sequence[Sequence[int]]) -> int:
    """Rows that left their source shard this wave (JAX ``g_cross``)."""
    return sum(sum(int(c) for c in row) - int(row[s])
               for s, row in enumerate(counts))
