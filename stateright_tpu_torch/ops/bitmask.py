"""Packed enabled-mask bitmaps: the mask lane of the sparse dispatch.

The PyTorch counterpart of ``stateright_tpu.ops.bitmask``, cut to what
the sparse sort-merge engine uses. Word layout (everywhere): slot ``k``
lives in word ``k // 32`` at bit ``k % 32``; tail bits of the last word
are zero. Words are int64 tensors holding uint32 values.

Hand encodings build their packed words from host-constant guard-class
masks (:func:`slot_mask_host`) OR-ed under per-state conditions
(:func:`or_class_words`) or picked by a small field value
(:func:`select_words_host`), so no dense ``bool[K]`` row is built by
the predicate itself; the engine unpacks the words once per wave
(:func:`words_to_mask`) for its pair compaction.
"""

from __future__ import annotations

import torch


def mask_words(k: int) -> int:
    """Words per row for a K-slot mask."""
    return (int(k) + 31) // 32


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
    one-word mask stays ``[1]``, so results are always ``[N, L]``.)"""
    return torch.tensor(words, dtype=torch.int64, device=device)


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


def words_to_mask(words: torch.Tensor, k: int) -> torch.Tensor:
    """``[..., L] -> bool[..., K]`` — unpack bitmap words to the dense
    mask."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    flat = bits.reshape(words.shape[:-1] + (words.shape[-1] * 32,))
    return flat[..., :k] != 0


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """``[..., L] -> int64[...]`` — set bits per row (the per-row
    enabled-slot count). SWAR popcount: torch has no bit count."""
    x = words
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) >> 24) & 0xFF
    return x.sum(dim=-1)
