"""Device-side symmetry canonicalization over int64 lanes.

The PyTorch counterpart of ``stateright_tpu.ops.canonical``. An
encoding whose interchangeable participants occupy UNIFORMLY STRIDED
bit-fields declares a :class:`DeviceRewriteSpec`; the engine maps every
candidate block to its orbit representatives (:func:`canonicalize_t`)
BEFORE the fingerprint fold, so the visited key is the canonical
fingerprint while the frontier keeps the concrete states (the host
DFS's visited-through-representatives / search-through-originals
split, dfs.rs:300-311).

The canonical form is bit-identical to the JAX package's; the way it is
computed is not. Each member's packed sort key carries its member index
as the final tiebreak, so the keys of one state are distinct and any
sort of them yields the host ``RewritePlan.from_values_to_sort`` stable
permutation. The JAX kernel avoids gathers on the TPU (comparison
ranks, then R² one-hot select-sums per field); here one
``torch.argsort`` over the stacked ``[..., R]`` keys gives the
permutation and one gather per field applies it: O(fields) tensor ops
a block instead of ~R²·(fields + 1).

Lanes are int64 tensors holding uint32 values, as everywhere in the
port: every complement is masked to 32 bits, and no value leaves
``[0, 2**32)``.

:func:`validate_spec` checks the spec's STRUCTURAL invariants with the
JAX package's exact bounds (the packed key must fit 32 bits, although
an int64 would hold more: the port refuses what the reference
refuses). Whether a declared spec is SOUND is the soundness
analyzer's question (analysis/soundness.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class MemberField:
    """One per-member bit-field: member ``m``'s value occupies bits
    ``[shift + m*stride, shift + m*stride + width)`` of ``lane``.

    Fields with ``sort_key=True`` form the stable-sort key, major to
    minor in declaration order; the member index is the final
    tiebreak."""

    lane: int
    shift: int
    stride: int
    width: int
    sort_key: bool = False


@dataclass(frozen=True)
class DeviceRewriteSpec:
    """The declared symmetry of an encoding's interchangeable limb
    group: ``n_members`` participants whose per-member state lives in
    the strided :class:`MemberField` s. Canonicalization permutes ALL
    fields by the stable sort over the key fields."""

    n_members: int
    fields: Tuple[MemberField, ...] = field(default_factory=tuple)

    def __post_init__(self):
        validate_spec(self)


def _idx_bits(n_members: int) -> int:
    bits = 1
    while (1 << bits) < n_members:
        bits += 1
    return bits


def validate_spec(spec: DeviceRewriteSpec,
                  width: Optional[int] = None) -> None:
    """Loud structural validation — a malformed spec must refuse at
    declaration, not mis-canonicalize."""
    R = spec.n_members
    if R < 2:
        raise ValueError(
            f"DeviceRewriteSpec needs >= 2 interchangeable members "
            f"(got {R}); a singleton group has nothing to permute"
        )
    if not spec.fields:
        raise ValueError("DeviceRewriteSpec declares no member fields")
    key_bits = 0
    for f in spec.fields:
        if f.width < 1 or f.stride < f.width:
            raise ValueError(
                f"MemberField(lane={f.lane}): width {f.width} must be "
                f">= 1 and <= stride {f.stride} (members must not "
                "overlap)"
            )
        top = f.shift + (R - 1) * f.stride + f.width
        if top > 32:
            raise ValueError(
                f"MemberField(lane={f.lane}, shift={f.shift}): member "
                f"{R - 1}'s bits end at {top} > 32 — the strided group "
                "must fit one uint32 lane"
            )
        if width is not None and not (0 <= f.lane < width):
            raise ValueError(
                f"MemberField lane {f.lane} outside encoding width "
                f"{width}"
            )
        if f.sort_key:
            key_bits += f.width
    if key_bits == 0:
        raise ValueError(
            "DeviceRewriteSpec has no sort_key fields — the canonical "
            "order would be undefined"
        )
    if key_bits + _idx_bits(R) > 32:
        raise ValueError(
            f"sort key ({key_bits} bits) + member-index tiebreak "
            f"({_idx_bits(R)} bits) exceeds 32 — the packed rank key "
            "must fit one uint32"
        )


def _field_mask(f: MemberField) -> int:
    return (1 << f.width) - 1


def _group_clear_mask(spec: DeviceRewriteSpec, lane: int) -> int:
    """Host constant: every member bit of every field on ``lane``."""
    m = 0
    for f in spec.fields:
        if f.lane != lane:
            continue
        for i in range(spec.n_members):
            m |= _field_mask(f) << (f.shift + i * f.stride)
    return m & 0xFFFFFFFF


@lru_cache(maxsize=64)
def _member_consts(spec: DeviceRewriteSpec, device: torch.device):
    """Per-field ``int64[R]`` bit offsets of the members, and the
    member indices, on ``device`` (built once per spec and device)."""
    R = spec.n_members
    shifts = tuple(
        torch.tensor([f.shift + m * f.stride for m in range(R)],
                     dtype=torch.int64, device=device)
        for f in spec.fields
    )
    return shifts, torch.arange(R, dtype=torch.int64, device=device)


def _canonicalize_lanes(spec: DeviceRewriteSpec, lanes: list) -> list:
    """The canonicalizer over a list of int64 lane tensors of one batch
    shape. Returns the canonical lanes; untouched lanes pass through by
    reference."""
    shifts, members = _member_consts(spec, lanes[0].device)
    # per-member field values, [..., R] each
    vals = [(lanes[f.lane][..., None] >> sh) & _field_mask(f)
            for f, sh in zip(spec.fields, shifts)]
    key = None
    for f, v in zip(spec.fields, vals):
        if f.sort_key:
            key = v if key is None else (key << f.width) | v
    key = (key << _idx_bits(spec.n_members)) | members
    # the keys are distinct, so perm[..., p] is the member the stable
    # sort puts at position p
    perm = torch.argsort(key, dim=-1)
    out = list(lanes)
    for lane in sorted({f.lane for f in spec.fields}):
        acc = out[lane] & (~_group_clear_mask(spec, lane) & 0xFFFFFFFF)
        for f, v, sh in zip(spec.fields, vals, shifts):
            if f.lane == lane:
                # fields are bit-disjoint, so the sum is their OR
                acc = acc | (v.gather(-1, perm) << sh).sum(dim=-1)
        out[lane] = acc
    return out


def canonicalize_t(spec: DeviceRewriteSpec, states_t: torch.Tensor):
    """``int64[W, N] -> int64[W, N]`` — map each column of a lane-major
    block to its orbit representative."""
    return torch.stack(_canonicalize_lanes(spec, list(states_t)))


def canonicalize_rows(spec: DeviceRewriteSpec, rows: torch.Tensor):
    """Row-major variant: ``int64[..., W] -> int64[..., W]`` (the host
    replay canonicalizes encoded rows with the same math, so its keys
    equal the ones the device wrote)."""
    lanes = [rows[..., i] for i in range(rows.shape[-1])]
    return torch.stack(_canonicalize_lanes(spec, lanes), dim=-1)


def canonical_hits(raw_t: torch.Tensor, canon_t: torch.Tensor,
                   valid: Optional[torch.Tensor] = None):
    """The count (an int64 tensor) of columns — of the ``valid`` ones,
    if given — whose canonical form differs from the raw successor: how
    much symmetry folds."""
    changed = (raw_t != canon_t).any(dim=0)
    return (changed if valid is None else changed & valid).sum()


def canonicalize_vec(spec: DeviceRewriteSpec, vec: torch.Tensor):
    """One state: ``int64[W] -> int64[W]``."""
    return canonicalize_rows(spec, vec)
