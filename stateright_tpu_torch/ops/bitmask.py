"""Packed enabled-mask bitmaps: the mask lane of the sparse dispatch.

The PyTorch counterpart of ``stateright_tpu.ops.bitmask``, cut to what
the sparse sort-merge engine and the actor compiler use. Word layout
(everywhere): slot ``k``
lives in word ``k // 32`` at bit ``k % 32``; tail bits of the last word
are zero. Words are int64 tensors holding uint32 values.

Hand encodings build their packed words from host-constant guard-class
masks (:func:`slot_mask_host`) OR-ed under per-state conditions
(:func:`or_class_words`) or picked by a small field value
(:func:`select_words_host`), so no dense ``bool[K]`` row is built by
the predicate itself; the engine unpacks the words once per wave
(:func:`words_to_mask`) for its pair compaction. The actor compiler
(actor/compile.py) adds two builders over host-planned tables:
single-bit presence fields coalesced into word runs (:func:`bit_run_plan`,
:func:`or_bit_runs`) and per-actor-state bits looked up in a packed
host table (:func:`pack_bits_host`, :func:`bit_select`).
"""

from __future__ import annotations

import torch


def mask_words(k: int) -> int:
    """Words per row for a K-slot mask."""
    return (int(k) + 31) // 32


def pack_bits_host(flags) -> tuple:
    """Host-side packing of a bool sequence into this module's word
    layout (bit ``i`` of word ``i // 32``), the format
    :func:`bit_select` reads. Always at least one word."""
    words = [0] * max(1, mask_words(len(flags)))
    for i, f in enumerate(flags):
        if f:
            words[i // 32] |= 1 << (i % 32)
    return tuple(words)


def slot_mask_host(k: int, slots) -> tuple:
    """Host constant: the packed-word mask with exactly the given slot
    indices set (a guard CLASS — the slots sharing one enabling
    condition). Always ``mask_words(k)`` words."""
    words = [0] * mask_words(k)
    for s in slots:
        if not 0 <= s < k:
            raise ValueError(f"slot {s} outside 0..{k - 1}")
        words[s // 32] |= 1 << (s % 32)
    return tuple(words)


def const_words(words, device) -> torch.Tensor:
    """Host word tuple -> device constant ``int64[L]``, which
    broadcasts against ``[N, L]`` rows. (The JAX version turns a
    one-word mask into a scalar to spare the TPU's tile padding; here a
    one-word mask stays ``[1]``, so results are always ``[N, L]``.)
    Made once a (words, device) and shared, so a wave that asks for it
    copies nothing from the host (a CUDA graph cannot capture that
    copy); callers never write to it."""
    key = (_frozen(words), torch.device(device))
    out = _CONST_WORDS.get(key)
    if out is None:
        out = _CONST_WORDS[key] = torch.tensor(key[0], dtype=torch.int64,
                                               device=device)
    return out


#: :func:`const_words`'s tensors, by (words, device)
_CONST_WORDS: dict = {}


def _frozen(words):
    """Nested word sequences as nested tuples of ints (a cache key)."""
    if isinstance(words, (list, tuple)) or hasattr(words, "tolist"):
        seq = words.tolist() if hasattr(words, "tolist") else words
        if isinstance(seq, (list, tuple)):
            return tuple(_frozen(w) for w in seq)
        return int(seq)
    return int(words)


def select_words_host(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row ``idx[i]`` of a host-constant table of packed-word rows, for
    every ``i``: ``int64[N, L]``. ``rows`` is the table as an
    ``int64[V, L]`` tensor on ``idx``'s device (:func:`const_words` of
    the host tuples; row ``v`` holds the words for field value ``v``).
    One gather; an ``idx`` outside ``0..V-1`` picks row 0, as the JAX
    version's where chain does. Callers tabulate guard masks over small
    enums (ballot codes, phases), not state spaces."""
    idx = torch.where((idx >= 0) & (idx < rows.shape[0]), idx, 0)
    return rows[idx]


def or_class_words(classes, L: int) -> torch.Tensor:
    """OR of condition-gated class masks: ``classes`` is a non-empty
    sequence of ``(cond, words)`` with ``cond`` a ``bool[N]`` tensor and
    ``words`` a host tuple from :func:`slot_mask_host` or an ``int64[L]``
    tensor already on ``cond``'s device (a :func:`const_words` result).
    Returns ``int64[N, L]``. All-zero host masks are dropped."""
    cond0 = classes[0][0]
    acc = torch.zeros(cond0.shape + (L,), dtype=torch.int64,
                      device=cond0.device)
    for cond, words in classes:
        if isinstance(words, tuple):
            if not any(words):
                continue
            words = const_words(words, cond.device)
        acc |= torch.where(cond[..., None], words, 0)
    return acc


def bit_run_plan(k: int, sources):
    """Host planner for the compiled-codegen mask: coalesce single-bit
    presence extracts into word-level runs.

    ``sources`` is a sequence of ``(slot, lane, shift)`` triples — slots
    whose enabled-presence is ONE state bit (duplicating-network
    envelope bits, timer armed bits). Wherever consecutive slots read
    consecutive shifts of the same lane, the whole run collapses to a
    single ``(lane >> shift) & mask``. Runs never cross an OUTPUT word
    boundary (slot 32 starts a new word). Returns a list of
    ``(dst_word, dst_pos, lane, shift, nbits)`` covering every source
    exactly once; :func:`or_bit_runs` assembles them."""
    runs = []
    cur = None  # [dst_word, dst_pos, lane, shift, nbits]
    for slot, lane, shift in sources:
        if not 0 <= slot < k:
            raise ValueError(f"slot {slot} outside 0..{k - 1}")
        w, p = slot // 32, slot % 32
        if (
            cur is not None
            and w == cur[0]
            and p == cur[1] + cur[4]
            and lane == cur[2]
            and shift == cur[3] + cur[4]
        ):
            cur[4] += 1
            continue
        if cur is not None:
            runs.append(tuple(cur))
        cur = [w, p, lane, shift, 1]
    if cur is not None:
        runs.append(tuple(cur))
    return runs


def or_bit_runs(states_t: torch.Tensor, runs, L: int) -> list:
    """Batched counterpart of :func:`bit_run_plan` over a ``[W, N]``
    block: OR each run's ``(lane >> shift) & ((1 << nbits) - 1)`` into
    its destination word. Returns a length-``L`` python list of
    ``int64[N]`` word accumulators (``None`` where no run landed), so
    the caller can fold in per-slot leftovers."""
    acc = [None] * L
    for dst_word, dst_pos, lane, shift, nbits in runs:
        term = (states_t[lane] >> shift) & ((1 << nbits) - 1)
        if dst_pos:
            term = term << dst_pos
        acc[dst_word] = (
            term if acc[dst_word] is None else acc[dst_word] | term
        )
    return acc


def bit_select(words, idx: torch.Tensor) -> torch.Tensor:
    """Bit ``idx[i]`` of a host-constant packed bit table, for every
    ``i``: ``int64[N]`` of 0/1. ``words`` is the table as an
    ``int64[V]`` tensor on ``idx``'s device (a :func:`const_words` of a
    :func:`pack_bits_host` tuple). The word is picked by ``idx >> 5``
    (one past the table picks word 0, as the JAX version's where chain
    does) and the bit by ``idx & 31``."""
    wi = idx >> 5
    wi = torch.where((wi >= 0) & (wi < words.shape[0]), wi, 0)
    return (words[wi] >> (idx & 31)) & 1


def words_to_mask(words: torch.Tensor, k: int) -> torch.Tensor:
    """``[..., L] -> bool[..., K]`` — unpack bitmap words to the dense
    mask."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    flat = bits.reshape(words.shape[:-1] + (words.shape[-1] * 32,))
    return flat[..., :k] != 0


def mask_to_words(mask: torch.Tensor) -> torch.Tensor:
    """``bool[..., K] -> int64[..., ceil(K/32)]`` — pack a dense
    enabled mask into bitmap words (the inverse of
    :func:`words_to_mask`)."""
    k = mask.shape[-1]
    L = mask_words(k)
    mp = torch.nn.functional.pad(mask.to(torch.int64), (0, L * 32 - k))
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    return (mp.reshape(mask.shape[:-1] + (L, 32)) << shifts).sum(dim=-1)


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """``[..., L] -> int64[...]`` — set bits per row (the per-row
    enabled-slot count). SWAR popcount: torch has no bit count."""
    x = words
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) >> 24) & 0xFF
    return x.sum(dim=-1)
