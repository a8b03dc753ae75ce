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
"""

from __future__ import annotations

import ctypes

import torch

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
        args = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p]
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


def _launch(fn, a, b, out, block: int) -> None:
    """One kernel launch on the current stream (no scratch, no sync)."""
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), a.numel(), b.data_ptr(), b.numel(),
                 out.data_ptr(), block, stream)
    if err != 0:
        raise RuntimeError(
            f"{fn.__name__} launch failed: CUDA error {err}"
        )


def member_cuda(a: torch.Tensor, q: torch.Tensor,
                block: int = MEMBER_BLOCK) -> torch.Tensor:
    """The member kernel on packed keys (see :func:`member_sorted`)."""
    _check_cuda(block, a, q)
    if a.numel() == 0 or q.numel() == 0:
        return torch.zeros(q.numel(), dtype=torch.bool, device=q.device)
    # the kernel writes every query's flag
    out = torch.empty(q.numel(), dtype=torch.bool, device=q.device)
    _launch(_lib().stpu_member_sorted, a, q, out, block)
    member_cuda.launches += 1
    return out


member_cuda.launches = 0


def merge_cuda(a: torch.Tensor, b: torch.Tensor,
               block: int = MERGE_BLOCK) -> torch.Tensor:
    """The merge kernel on packed keys (see :func:`merge_sorted`)."""
    _check_cuda(block, a, b)
    if b.numel() == 0:
        return a.clone()
    if a.numel() == 0:
        return b.clone()
    out = torch.empty(a.numel() + b.numel(), dtype=torch.int64,
                      device=a.device)
    _launch(_lib().stpu_merge_sorted, a, b, out, block)
    merge_cuda.launches += 1
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


def compact_winners_keys(is_new, pos, keys, nf: int):
    """:func:`compact_winners` on packed keys: ``(nf_pos, w_keys)``,
    both lanes padded with the sentinel key (the engine passes the
    exact winner count, so it never pads)."""
    out = _rank_scatter(is_new, nf, torch.stack([pos, keys]),
                        SENTINEL_KEY)
    return out[0], out[1]
