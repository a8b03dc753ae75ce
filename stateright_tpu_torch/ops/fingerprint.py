"""Vectorized 64-bit state fingerprinting over int64 lanes.

The PyTorch counterpart of ``stateright_tpu.ops.fingerprint``: encoded
states are fixed-width vectors of uint32 lanes, and their digest is a
splitmix64-style fold over the lanes with hard-coded keys. The JAX
package builds the 64-bit arithmetic from uint32 limb pairs because the
TPU has no 64-bit integers; here every 64-bit value is carried in ONE
int64 (two's complement wraps exactly like u64 arithmetic under add,
xor and multiply), and the uint32 lanes are int64 tensors holding
values in ``[0, 2**32)``. The fold is bit-identical to the JAX fold
(tests/test_torch_ops.py pins it, zero and all-ones lanes included).

Two rules of the int64 carrier:

* torch's int64 ``>>`` is ARITHMETIC, so every logical right shift
  masks the sign-extended bits off (:func:`_shr`);
* constants at or above ``2**63`` are written as their signed
  equivalents (:func:`_s64`).

Zero is reserved as the empty-slot marker, so a zero digest maps to 1
(the ``NonZeroU64`` convention). The engines additionally keep real
keys off the all-ones sentinel (:func:`clamp_keys`).

**Sort keys.** The visited set and the candidate sort need ONE int64
column that orders like the unsigned pair ``(hi, lo)`` — CPU torch has
no unsigned 64-bit compare or sort. :func:`pack_keys` builds
``((hi ^ 0x80000000) << 32) | lo``, i.e. the u64 digest with its top
bit flipped, read as signed: it orders like unsigned ``(hi, lo)`` and
maps the all-ones sentinel to int64 max (:data:`SENTINEL_KEY`).
"""

from __future__ import annotations

from typing import Tuple

import torch

_SEED = 0x51A7E12D_0BADC0DE
_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB
_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1

#: the packed key of the all-ones ``(hi, lo)`` pair: int64 max.
SENTINEL_KEY = (1 << 63) - 1
#: the packed key real fingerprints that hit the sentinel move to
#: (``hi`` one lower, the JAX engines' ``clamp_keys``).
CLAMPED_KEY = SENTINEL_KEY - (1 << 32)


def _s64(value: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    value &= _M64
    return value - (1 << 64) if value >> 63 else value


def _shr(z: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64-carried u64 values, 0 < n < 64."""
    return (z >> n) & ((1 << (64 - n)) - 1)


def splitmix64(z: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer (Steele et al.), elementwise."""
    z = z ^ _shr(z, 30)
    z = z * _s64(_MIX1)
    z = z ^ _shr(z, 27)
    z = z * _s64(_MIX2)
    return z ^ _shr(z, 31)


def fold_lanes(vec_t: torch.Tensor) -> torch.Tensor:
    """THE fingerprint fold over lane-major ``[W, ...]`` int64 blocks:
    the u64 digest of each column as an int64 bit pattern, never 0."""
    vec_t = vec_t.to(torch.int64)
    h = torch.full(
        vec_t.shape[1:], _s64(_SEED), dtype=torch.int64,
        device=vec_t.device,
    )
    for i in range(vec_t.shape[0]):
        h = splitmix64(h ^ (vec_t[i] + _s64(_GOLDEN * (i + 1))))
    return torch.where(h == 0, torch.ones_like(h), h)


def fingerprint_u32v_t(vec_t: torch.Tensor) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Digest TRANSPOSED (lane-major) state blocks along axis 0:
    ``[W, ...] -> (lo, hi)``, int64 tensors holding uint32 values,
    bit-identical to the JAX ``fingerprint_u32v_t``."""
    h = fold_lanes(vec_t)
    return h & _M32, _shr(h, 32)


def fingerprint_u32v(vec: torch.Tensor) -> Tuple[torch.Tensor,
                                                 torch.Tensor]:
    """Digest row-major state vectors along the last axis."""
    return fingerprint_u32v_t(vec.movedim(-1, 0))


def pack_keys(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``(lo, hi)`` uint32 limbs -> int64 sort keys ordering like the
    unsigned pair (see the module docstring)."""
    return ((hi.to(torch.int64) ^ 0x80000000) << 32) | lo.to(torch.int64)


def unpack_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_keys`."""
    return keys & _M32, _shr(keys, 32) ^ 0x80000000


def clamp_keys(keys: torch.Tensor) -> torch.Tensor:
    """Nudge real keys off the all-ones padding sentinel (the JAX
    engines' ``clamp_keys``: hi becomes 0xFFFFFFFE)."""
    return torch.where(
        keys == SENTINEL_KEY, torch.full_like(keys, CLAMPED_KEY), keys
    )


def key_to_fp(key: int) -> int:
    """A packed key as the unsigned 64-bit fingerprint it encodes."""
    return (key & _M64) ^ (1 << 63)


def fp_to_key(fp: int) -> int:
    """Inverse of :func:`key_to_fp`."""
    return _s64(fp ^ (1 << 63))
