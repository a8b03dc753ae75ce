"""Stable 64-bit structural fingerprinting (a copy of the JAX
package's host ``fingerprint`` module, so paths encode identically).

Host-side analog of the reference's fixed-key stable hasher
(stateright src/lib.rs:329-375): state digests must be identical across
runs, processes, and machines so that unique-state counts and encoded
counterexample paths are reproducible. Python's builtin ``hash`` is
salted per-process, so we implement our own xxhash-style 64-bit mixer
with hard-coded keys.

Two fingerprint domains exist in this framework:

* **Structural fingerprints** (this module): hash arbitrary host state
  objects by canonical traversal. Used by path encoding and replay
  (path.py), mirroring ``fingerprint<T: Hash>`` in the reference
  (src/lib.rs:329-337).
* **Vector fingerprints** (:mod:`stateright_tpu_torch.ops.fingerprint`):
  hash fixed-width uint32-lane state vectors on device. Used by the
  wave engine.

Unordered collections (sets / dicts) are hashed order-independently by
sorting element digests before folding, the same trick the reference
uses for ``HashableHashSet``/``HashableHashMap`` (src/util.rs:137-159).
"""

from __future__ import annotations

import dataclasses
import struct
from enum import Enum
from typing import Any

_M64 = (1 << 64) - 1

# Fixed keys: stability across runs is the whole point
# (reference: const KEY1..KEY4, src/lib.rs:362-374).
_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5
_SEED = 0x5EED_5EED_5EED_5EED

# Type tags keep values of different types from colliding
# (1 vs "1" vs (1,) vs {1}).
_T_NONE = 0x01
_T_BOOL = 0x02
_T_INT = 0x03
_T_FLOAT = 0x04
_T_STR = 0x05
_T_BYTES = 0x06
_T_TUPLE = 0x07
_T_LIST = 0x08
_T_SET = 0x09
_T_DICT = 0x0A
_T_DATACLASS = 0x0B
_T_ENUM = 0x0C
_T_OBJECT = 0x0D
_T_NDARRAY = 0x0E


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, v: int) -> int:
    acc = (acc + v * _P2) & _M64
    acc = _rotl(acc, 31)
    return (acc * _P1) & _M64


def _avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h


def _fold(h: int, tag: int, words: tuple[int, ...] | list[int]) -> int:
    h = _round(h, tag)
    for w in words:
        h = _round(h, w)
    return h


def _hash_value(h: int, obj: Any) -> int:
    """Fold one value into accumulator ``h`` (canonical traversal)."""
    if obj is None:
        return _round(h, _T_NONE)
    if obj is True:
        return _fold(h, _T_BOOL, (1,))
    if obj is False:
        return _fold(h, _T_BOOL, (0,))
    t = type(obj)
    if t is int:
        if 0 <= obj <= _M64:
            return _fold(h, _T_INT, (0, obj))
        sign = 1 if obj < 0 else 0
        mag = -obj if sign else obj
        h = _fold(h, _T_INT, (sign,))
        while mag:
            h = _round(h, mag & _M64)
            mag >>= 64
        return h
    if t is float:
        (bits,) = struct.unpack("<Q", struct.pack("<d", obj))
        return _fold(h, _T_FLOAT, (bits,))
    if t is str:
        data = obj.encode("utf-8")
        h = _fold(h, _T_STR, (len(data),))
        return _fold_bytes(h, data)
    if t is bytes:
        h = _fold(h, _T_BYTES, (len(obj),))
        return _fold_bytes(h, obj)
    if t is tuple or t is list:
        h = _fold(h, _T_TUPLE if t is tuple else _T_LIST, (len(obj),))
        for item in obj:
            h = _hash_value(h, item)
        return h
    if t is frozenset or t is set:
        # Order-independent: sorted element digests (util.rs:137-159).
        digests = sorted(_avalanche(_hash_value(_SEED, item)) for item in obj)
        return _fold(h, _T_SET, (len(obj), *digests))
    if t is dict:
        digests = sorted(
            _avalanche(_hash_value(_hash_value(_SEED, k), v))
            for k, v in obj.items()
        )
        return _fold(h, _T_DICT, (len(obj), *digests))
    if isinstance(obj, Enum):
        h = _fold(h, _T_ENUM, ())
        h = _hash_value(h, type(obj).__qualname__)
        return _hash_value(h, obj.value)
    if dataclasses.is_dataclass(obj):
        h = _fold(h, _T_DATACLASS, ())
        h = _hash_value(h, type(obj).__qualname__)
        for f in dataclasses.fields(obj):
            h = _hash_value(h, getattr(obj, f.name))
        return h
    stable = getattr(obj, "_stable_hash_", None)
    if stable is not None:
        return _fold(h, _T_OBJECT, (stable() & _M64,))
    # Subclass fallbacks (e.g. actor Id subclasses int and must digest
    # identically to the plain int it equals). Conversions bypass
    # overridable __int__/__str__ so the digest matches the value the
    # subclass *equals*, then recurse through the exact-type paths.
    if isinstance(obj, int):
        return _hash_value(h, int.__index__(obj))
    if isinstance(obj, str):
        return _hash_value(h, str.__str__(obj))
    if isinstance(obj, tuple):
        return _hash_value(h, tuple(obj))
    if isinstance(obj, (frozenset, set)):
        return _hash_value(h, frozenset(obj))
    if isinstance(obj, dict):
        import collections

        if isinstance(obj, collections.OrderedDict):
            # OrderedDict equality is order-sensitive; hashing it as an
            # unordered dict would alias unequal states.
            raise TypeError(
                "cannot stably hash OrderedDict (order-sensitive equality); "
                "use a tuple of items or a plain dict"
            )
        return _hash_value(h, dict(obj))
    if hasattr(obj, "__array_interface__") or type(obj).__module__ == "numpy":
        import numpy as np

        arr = np.asarray(obj)
        h = _fold(h, _T_NDARRAY, (len(arr.shape), *arr.shape))
        h = _hash_value(h, str(arr.dtype))
        return _fold_bytes(h, arr.tobytes())
    raise TypeError(
        f"cannot stably hash {type(obj).__qualname__}; implement "
        f"_stable_hash_() or use tuples/frozensets/dataclasses"
    )


def _fold_bytes(h: int, data: bytes) -> int:
    n = len(data)
    full = n - (n % 8)
    for i in range(0, full, 8):
        (w,) = struct.unpack_from("<Q", data, i)
        h = _round(h, w)
    if full < n:
        tail = int.from_bytes(data[full:], "little")
        h = _round(h, tail)
    return h


def stable_hash(obj: Any) -> int:
    """Deterministic 64-bit structural hash of ``obj``."""
    return _avalanche(_hash_value(_SEED, obj))


def fingerprint(obj: Any) -> int:
    """Nonzero stable 64-bit digest of a model state.

    Mirrors ``fingerprint()`` returning ``NonZeroU64`` in the reference
    (src/lib.rs:329-337): zero is reserved as the empty slot marker in
    visited tables, so a zero hash maps to 1.
    """
    return stable_hash(obj) or 1
