"""Streaming sorted-set ops: the visited-dedup merge family.

The PyTorch counterpart of ``stateright_tpu.ops.merge``. The sort-merge
engine keeps its visited set SORTED, so each wave dedups with two
O(V + B) streaming passes instead of re-sorting the visited rows:

* :func:`member_sorted` — for each of B sorted query keys, is it
  present in the sorted visited prefix (the dedup membership test);
* :func:`merge_sorted` — merge the sorted winner keys into the sorted
  visited prefix (the visited append).

Keys. The public functions keep the JAX signatures: 2-limb ``(lo, hi)``
keys ordered lexicographically by ``(hi, lo)`` (integer tensors holding
uint32 values), all-ones pair as the padding sentinel. Internally —
and in the engine, which calls the ``*_keys`` forms directly — a key is
ONE packed int64 (``ops.fingerprint.pack_keys``) that orders like the
unsigned pair under a signed compare. Both inputs are sorted
ascending; ties order A first; membership is exact multiset membership
(sentinel queries match a sentinel tail, so callers mask them).

Each op has two versions, chosen by the device of its inputs:

* a plain PyTorch version (``*_plain``): a vectorized binary search
  (log2 Na gather steps) for membership, and destinations by binary
  search plus one scatter for the merge — the JAX ``xla`` forms;
* a hand-written CUDA kernel (``csrc/merge_path.cu``, Merge Path tiles
  streamed through shared-memory rings by a persistent grid, one launch
  a call; ``member_cuda``/``merge_cuda``), which replaces the Pallas
  kernels ``_member_kernel`` and ``_merge_kernel``.

A tensor on the CPU takes the plain version; a tensor on a CUDA device
launches the kernel, and the kernel either runs or raises — there is
no fallback. Each CUDA wrapper counts its launches in a plain int
attribute (``member_cuda.launches``), so a run can show that its main
path went through the kernels.

Each op also has a DEVICE-COUNT entry point (:func:`member_keys_dev`,
:func:`merge_keys_dev`): the live lengths are 0-d int64 tensors on the
keys' device, read by the kernel, and the buffers are fixed-capacity
with anything past the live lengths. The engines' chunked waves use
them, so a wave issues no host read and replays as a CUDA graph with
other counts. Both forms launch the same kernel through the same
wrapper (``member_cuda(..., na=, nq=)``), which counts its launches
once; a launch recorded into a CUDA graph is counted at each replay
(``cuda_build.note_launch``).
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import note_launch
from .fingerprint import SENTINEL_KEY, pack_keys, unpack_keys

_SENT = 0xFFFFFFFF

#: the CUDA kernels' tile shapes: merged rows per tile -> (threads per
#: CTA, rows per thread); csrc/merge_path.cu instantiates each. The
#: 32-row tile puts small inputs across many tiles for chip_smoke.py.
TILES = {32: (32, 1), 1664: (128, 13), 2304: (256, 9)}

#: merged rows per Merge Path tile (``block``) of each CUDA kernel: the
#: fastest shape at the main path's sizes on an H100 (chip_smoke.py
#: times every shape, PERF.md §6).
MEMBER_BLOCK = 1664
MERGE_BLOCK = 2304

#: ``impl`` values: "auto" picks by device, "cuda" demands the kernel.
IMPLS = ("auto", "cuda")

_SOURCE = "merge_path.cu"


# -- plain versions ---------------------------------------------------------


def _count_sorted(a: torch.Tensor, q: torch.Tensor, strict: bool):
    """Per query, how many A keys compare {<, <=} it — a vectorized
    binary search over sorted ``a`` (``bit_length(Na)`` gather steps)."""
    na = a.numel()
    lo = torch.zeros(q.numel(), dtype=torch.int64, device=q.device)
    hi = torch.full_like(lo, na)
    for _ in range(max(1, na.bit_length())):
        mid = (lo + hi) >> 1
        am = a[mid.clamp(max=na - 1)]
        go_right = am < q if strict else am <= q
        upd = lo < hi
        lo = torch.where(upd & go_right, mid + 1, lo)
        hi = torch.where(upd & ~go_right, mid, hi)
    return lo


def member_sorted_plain(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``bool[Nq]``: whether each sorted packed query key is in sorted
    packed ``a`` — the plain PyTorch version of the member kernel."""
    na = a.numel()
    if na == 0 or q.numel() == 0:
        return torch.zeros(q.numel(), dtype=torch.bool, device=q.device)
    cnt = _count_sorted(a, q, strict=True)
    return (a[cnt.clamp(max=na - 1)] == q) & (cnt < na)


def merge_sorted_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The stable merge of sorted packed ``a`` and ``b`` (A first on
    ties) — the plain PyTorch version of the merge kernel. B rows land
    at ``j + #(A <= b_j)`` (strictly increasing, so collision-free);
    A rows fill the rest in order."""
    na, nb = a.numel(), b.numel()
    if nb == 0:
        return a.clone()
    if na == 0:
        return b.clone()
    dest_b = torch.arange(nb, device=b.device) + _count_sorted(
        a, b, strict=False
    )
    out = torch.empty(na + nb, dtype=torch.int64, device=a.device)
    from_b = torch.zeros(na + nb, dtype=torch.bool, device=a.device)
    from_b[dest_b] = True
    out[dest_b] = b
    out[~from_b] = a
    return out


def member_sorted_plain_dev(a: torch.Tensor, na: torch.Tensor,
                            q: torch.Tensor, nq: torch.Tensor
                            ) -> torch.Tensor:
    """The plain version of the device-count member entry: ``bool[len(q)]``,
    whether each of the first ``nq`` keys of ``q`` is among the first
    ``na`` keys of sorted ``a`` (False past ``nq``). Rows past the counts
    may hold anything. It runs on host tensors (the CPU path), where
    reading a count costs no device sync, so it searches the live
    prefixes only."""
    na, nq = int(na), int(nq)
    out = torch.zeros(q.numel(), dtype=torch.bool, device=q.device)
    out[:nq] = member_sorted_plain(a[:na], q[:nq])
    return out


def merge_sorted_plain_dev(a: torch.Tensor, na: torch.Tensor,
                           b: torch.Tensor, nb: torch.Tensor,
                           out: torch.Tensor) -> torch.Tensor:
    """The plain version of the device-count merge entry: the stable
    merge of ``a[:na]`` and ``b[:nb]`` into ``out[:na + nb]`` (the rows
    after it are left), ``out`` returned. Rows past the counts may hold
    anything; ``out`` must hold ``na + nb`` rows. Host tensors, as
    :func:`member_sorted_plain_dev`."""
    na, nb = int(na), int(nb)
    out[:na + nb] = merge_sorted_plain(a[:na], b[:nb])
    return out


def merge_path_starts(a_lo, a_hi, b_lo, b_hi, block: int) -> torch.Tensor:
    """``int64[G + 1]`` A-side splits of the merged sequence at every
    ``block``-row output boundary (G = ceil((Na+Nb)/block)), A first on
    ties, in plain PyTorch (tests hold it against the JAX partition). The
    CUDA kernels search these diagonals on the card, each CTA those at
    the two ends of its run of tiles."""
    return merge_path_starts_keys(
        pack_keys(a_lo, a_hi), pack_keys(b_lo, b_hi), block
    )


def merge_path_starts_keys(a: torch.Tensor, b: torch.Tensor,
                           block: int) -> torch.Tensor:
    """:func:`merge_path_starts` on packed keys."""
    na, nb = a.numel(), b.numel()
    m = na + nb
    g = max(1, -(-m // block))
    d = (torch.arange(g + 1, dtype=torch.int64, device=a.device)
         * block).clamp(max=m)
    lo = (d - nb).clamp(min=0)
    hi = d.clamp(max=na)
    if na == 0 or nb == 0:
        return lo  # lo == hi on every diagonal: the split is forced
    for _ in range(na.bit_length() + 1):
        mid = (lo + hi) >> 1
        ai = mid.clamp(0, na - 1)
        bj = (d - mid - 1).clamp(0, nb - 1)
        # the split is <= mid iff b[d - mid - 1] merges before a[mid]
        p = b[bj] < a[ai]
        upd = lo < hi
        hi = torch.where(upd & p, mid, hi)
        lo = torch.where(upd & ~p, mid + 1, lo)
    return lo


# -- CUDA kernels -----------------------------------------------------------


def _lib() -> ctypes.CDLL:
    from .cuda_build import load

    lib = load(_SOURCE)
    if not getattr(lib, "stpu_bound", False):
        # a, its count's pointer (or None) and value; b, the same; out,
        # tile, stream
        args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        for fn in (lib.stpu_merge_sorted, lib.stpu_member_sorted):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.stpu_bound = True
    return lib


def _check_cuda(block: int, *keys: torch.Tensor) -> None:
    dev = keys[0].device
    for k in keys:
        if k.device.type != "cuda" or k.device != dev:
            raise ValueError(
                f"CUDA merge kernels need keys on one CUDA device, got "
                f"{[str(x.device) for x in keys]}"
            )
        if k.dtype != torch.int64 or k.dim() != 1 or not k.is_contiguous():
            raise ValueError(
                "CUDA merge kernels take contiguous 1-D int64 packed "
                f"keys, got {k.dtype} shape {tuple(k.shape)}"
            )
    if block not in TILES:
        raise ValueError(
            f"block must be a tile size of {sorted(TILES)}, got {block}"
        )


def _check_counts(keys: torch.Tensor, *counts: torch.Tensor) -> None:
    for n in counts:
        if (n.device != keys.device or n.dtype != torch.int64
                or n.dim() != 0):
            raise ValueError(
                "device counts must be 0-d int64 tensors on the keys' "
                f"device, got {n.dtype} shape {tuple(n.shape)} on {n.device}"
            )


def _launch(fn, a, na, b, nb, out, block: int) -> None:
    """One kernel launch on the current stream (no scratch, no sync):
    ``na``/``nb`` None for the live lengths ``len(a)``/``len(b)``, or 0-d
    device counts of the live prefixes."""
    dev = na is not None
    if dev:
        _check_counts(a, na, nb)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), na.data_ptr() if dev else None, a.numel(),
                 b.data_ptr(), nb.data_ptr() if dev else None, b.numel(),
                 out.data_ptr(), block, stream)
    if err != 0:
        raise RuntimeError(
            f"{fn.__name__} launch failed: CUDA error {err}"
        )


def member_cuda(a: torch.Tensor, q: torch.Tensor,
                block: int = MEMBER_BLOCK, *, na=None, nq=None
                ) -> torch.Tensor:
    """The member kernel on packed keys (see :func:`member_sorted`).
    With ``na`` and ``nq`` (0-d int64 tensors on the keys' device, see
    :func:`member_keys_dev`) the live lengths are read from device
    memory and only flags ``[0, nq)`` are written; the grid is sized to
    the buffers' capacities."""
    _check_cuda(block, a, q)
    out = torch.empty(q.numel(), dtype=torch.bool, device=q.device)
    if q.numel() == 0 or (na is None and a.numel() == 0):
        return out.fill_(False)
    # the kernel writes every live query's flag
    _launch(_lib().stpu_member_sorted, a, na, q, nq, out, block)
    note_launch(member_cuda)
    return out


member_cuda.launches = 0


def merge_cuda(a: torch.Tensor, b: torch.Tensor,
               block: int = MERGE_BLOCK, *, na=None, nb=None, out=None
               ) -> torch.Tensor:
    """The merge kernel on packed keys (see :func:`merge_sorted`). With
    ``na`` and ``nb`` (0-d device counts, see :func:`merge_keys_dev`)
    the live lengths are read from device memory and rows ``[0, na +
    nb)`` of ``out`` (which must hold them) are written."""
    if na is None:
        _check_cuda(block, a, b)
        if b.numel() == 0:
            return a.clone()
        if a.numel() == 0:
            return b.clone()
        out = torch.empty(a.numel() + b.numel(), dtype=torch.int64,
                          device=a.device)
    else:
        _check_cuda(block, a, b, out)
        if a.numel() + b.numel() == 0:
            return out
    _launch(_lib().stpu_merge_sorted, a, na, b, nb, out, block)
    note_launch(merge_cuda)
    return out


merge_cuda.launches = 0


# -- entry points -----------------------------------------------------------


def _on_cuda(impl: str, t: torch.Tensor) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "cuda" and t.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, got {t.device}")
    return t.device.type == "cuda"


def member_keys(a: torch.Tensor, q: torch.Tensor, *, impl: str = "auto",
                block: int = MEMBER_BLOCK) -> torch.Tensor:
    """Membership on packed int64 keys: the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if _on_cuda(impl, q):
        return member_cuda(a, q, block)
    return member_sorted_plain(a, q)


def merge_keys(a: torch.Tensor, b: torch.Tensor, *, impl: str = "auto",
               block: int = MERGE_BLOCK) -> torch.Tensor:
    """Stable merge on packed int64 keys: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if _on_cuda(impl, a):
        return merge_cuda(a, b, block)
    return merge_sorted_plain(a, b)


def member_keys_dev(a: torch.Tensor, na: torch.Tensor, q: torch.Tensor,
                    nq: torch.Tensor, *, impl: str = "auto",
                    block: int = MEMBER_BLOCK) -> torch.Tensor:
    """Membership with device counts: ``bool[len(q)]`` whose first ``nq``
    rows say whether each of the first ``nq`` keys of ``q`` (sorted) is
    among the first ``na`` keys of sorted ``a``; rows past ``nq`` are
    unspecified. ``na``, ``nq``: 0-d int64 tensors on the keys' device.
    The kernel for CUDA tensors, the plain version for CPU tensors."""
    if _on_cuda(impl, q):
        return member_cuda(a, q, block, na=na, nq=nq)
    return member_sorted_plain_dev(a, na, q, nq)


def merge_keys_dev(a: torch.Tensor, na: torch.Tensor, b: torch.Tensor,
                   nb: torch.Tensor, out: torch.Tensor, *,
                   impl: str = "auto", block: int = MERGE_BLOCK
                   ) -> torch.Tensor:
    """Stable merge with device counts: ``a[:na]`` and ``b[:nb]`` into
    ``out[:na + nb]`` (the caller sees that ``out`` holds ``na + nb``
    rows: the kernel cannot check a count it never reads on the host;
    rows past the live length are unspecified), ``out`` returned. The
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if _on_cuda(impl, a):
        return merge_cuda(a, b, block, na=na, nb=nb, out=out)
    return merge_sorted_plain_dev(a, na, b, nb, out)


def member_sorted(a_lo, a_hi, q_lo, q_hi, *, impl: str = "auto",
                  block: int = MEMBER_BLOCK) -> torch.Tensor:
    """``bool[Nq]``: for each sorted query key, whether it occurs in the
    sorted array A. Exact multiset semantics (sentinel queries match A's
    sentinel tail; callers mask)."""
    return member_keys(
        pack_keys(a_lo, a_hi).contiguous(),
        pack_keys(q_lo, q_hi).contiguous(), impl=impl, block=block,
    )


def merge_sorted(a_lo, a_hi, b_lo, b_hi, *, impl: str = "auto",
                 block: int = MERGE_BLOCK):
    """``(lo[Na+Nb], hi[Na+Nb])``: the sorted merge of two sorted 2-limb
    key arrays, A first on ties; sentinel tails merge to the tail."""
    return unpack_keys(merge_keys(
        pack_keys(a_lo, a_hi).contiguous(),
        pack_keys(b_lo, b_hi).contiguous(), impl=impl, block=block,
    ))


def _rank_scatter(is_new: torch.Tensor, nf: int, lanes: torch.Tensor,
                  fill: int) -> torch.Tensor:
    """Order-preserving compaction of the ``is_new`` columns of
    ``lanes [R, B]`` into ``[R, nf]``: winner ``i`` goes to its inclusive
    rank minus one (unique, increasing); rows past the winner count keep
    ``fill``; winners past ``nf`` drop."""
    rank = torch.cumsum(is_new.to(torch.int64), 0) - 1
    keep = is_new & (rank < nf)
    out = torch.full((lanes.shape[0], nf), fill, dtype=torch.int64,
                     device=lanes.device)
    out[:, rank[keep]] = lanes[:, keep]
    return out


def compact_winners(is_new, pos, lo, hi, nf: int):
    """``(nf_pos[nf], w_lo[nf], w_hi[nf])``: the winner rows of the
    key-sorted candidate arrays, compacted order-preserving to the first
    ``nf`` rows and sentinel-padded (the JAX rank-scatter ``xla``
    form)."""
    lanes = torch.stack([t.to(torch.int64) for t in (pos, lo, hi)])
    out = _rank_scatter(is_new, nf, lanes, _SENT)
    return out[0], out[1], out[2]


#: spare slots a static scatter on the card sends the elements it drops
#: to, spread over so many that no slot takes many writes (millions of
#: writes to one address serialize there); one on the CPU
DUMP = 1 << 16


def dump_size(device) -> int:
    """The spare slots a static scatter's buffer adds on ``device``."""
    return DUMP if torch.device(device).type == "cuda" else 1


def dump_slots(cap: int, n: int, device) -> torch.Tensor:
    """``int64[n]``: for element ``i`` of a static scatter into a buffer
    of ``cap`` live slots and :func:`dump_size` spare ones, the spare
    slot it is sent to when it is dropped."""
    return cap + (torch.arange(n, dtype=torch.int64, device=device)
                  & (dump_size(device) - 1))


def rank_compact(mask: torch.Tensor, cap: int, lanes: torch.Tensor,
                 fill) -> torch.Tensor:
    """Order-preserving compaction of the ``mask`` columns of ``lanes
    [R, B]`` into a fixed ``[R, cap]`` block, with no host read: column
    ``i`` goes to its rank among the masked columns, columns past the
    count hold ``fill`` (an int, or one int a lane), masked columns past
    ``cap`` drop. The static form of :func:`_rank_scatter` (a CUDA
    graph replays it at any count)."""
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    dest = torch.where(mask & (rank < cap), rank,
                       dump_slots(cap, mask.numel(), mask.device))
    fills = fill if isinstance(fill, (list, tuple)) else [fill] * len(lanes)
    out = torch.empty((lanes.shape[0], cap + dump_size(lanes.device)),
                      dtype=lanes.dtype, device=lanes.device)
    for r, f in enumerate(fills):
        out[r].fill_(f)
    out[:, dest] = lanes
    return out[:, :cap]


def compact_winners_keys_dev(is_new, pos, keys, cap: int):
    """:func:`compact_winners_keys` into a fixed ``cap``-row block, with
    the winner count left on the device: ``(nf_pos, w_keys)``, rows past
    the count holding position 0 (a valid gather index) and the sentinel
    key."""
    out = rank_compact(is_new, cap, torch.stack([pos, keys]),
                       [0, SENTINEL_KEY])
    return out[0], out[1]


def compact_winners_keys(is_new, pos, keys, nf: int):
    """:func:`compact_winners` on packed keys: ``(nf_pos, w_keys)``,
    both lanes padded with the sentinel key (the engine passes the
    exact winner count, so it never pads)."""
    out = _rank_scatter(is_new, nf, torch.stack([pos, keys]),
                        SENTINEL_KEY)
    return out[0], out[1]
