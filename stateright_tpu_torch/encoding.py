"""Fixed-width state encodings: the bridge from models to the device.

The PyTorch counterpart of ``stateright_tpu.encoding``: the two
contracts the sort-merge engine runs, the dense step
(:class:`DenseEncodedModel`, JAX ``EncodedModel.step_vec``) and sparse
dispatch (:class:`SparseEncodedModel`). An encoding pairs
a host :class:`~stateright_tpu_torch.model.Model` (the semantic ground
truth and replay oracle) with

* a fixed-width state layout of ``width`` uint32 lanes,
* batched device functions over LANE-MAJOR blocks: a block of N states
  is an int64 tensor ``[W, N]`` whose row ``i`` is lane ``i`` of every
  state (the JAX engines' transposed resident layout; the JAX package
  writes per-state functions and ``vmap``s them over axis 1, the port
  writes the batch out), and
* property / boundary predicates aligned index-for-index with the host
  model's ``properties()``.

Two optional declarations arm the reductions (:func:`device_rewrite_spec`,
:func:`ample_mask_host`): an encoding's ``device_rewrite_spec()``
(ops/canonical.py) and its ``ample_mask_host()`` packed slot words.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch

from .model import Model


@runtime_checkable
class DenseEncodedModel(Protocol):
    """The dense contract (JAX ``EncodedModel.step_vec``, batched).

    * ``step_cols(states_t)`` — ``[W, n] -> (succ [W, n, K], valid
      bool[n, K], trunc)``: the successor of every state in every action
      slot (``succ[:, r, k]`` for row ``r``, slot ``k``; either tensor
      may be a strided view, see :func:`stack_slots`), which slots hold
      a real successor, and ``trunc`` — ``bool[n]``, or ``None`` when
      the encoding has no internal bound — marking rows where an
      otherwise-valid successor was pruned by such a bound (the engine
      raises on it);
    * ``property_conditions_cols``, ``within_boundary_cols``,
      ``trivial_boundary``, ``encode`` and ``init_vecs`` as in
      :class:`SparseEncodedModel`.

    The engine applies the boundary to the valid successors itself.
    """

    width: int
    max_actions: int
    host_model: Model
    trivial_boundary: bool

    def init_vecs(self) -> np.ndarray: ...

    def encode(self, state: Any) -> np.ndarray: ...

    def step_cols(self, states_t: torch.Tensor) -> tuple: ...

    def property_conditions_cols(self,
                                 states_t: torch.Tensor) -> torch.Tensor: ...

    def within_boundary_cols(self, states_t: torch.Tensor) -> torch.Tensor: ...


@runtime_checkable
class SparseEncodedModel(Protocol):
    """The contract the sparse sort-merge engine consumes.

    * ``enabled_bits_cols(states_t)`` — ``[W, N] -> int64[N, L]`` packed
      enabled-slot words (ops/bitmask.py layout, L = ceil(K/32));
    * ``step_slot_cols(states_t, slots)`` — ``([W, N], int64[N])``:
      ``(succ_t, trunc, hard)``, the successor ``succ_t [W, N]`` of
      each (state, enabled slot) pair and two ``bool[N]`` flags
      (either may be ``None``: no pair flagged). ``trunc`` marks a pair
      pruned by an internal encoding bound (a compiled envelope count
      reaching 128, a declared FIFO queue bound): the engine excludes
      it, and raises when its successor is within the boundary.
      ``hard`` marks an unrepresentable successor (an un-harvested
      history transition): excluded, and always raised;
    * ``property_conditions_cols(states_t)`` — ``[W, N] -> bool[N, P]``
      in ``host_model.properties()`` order. EVENTUALLY properties must
      sit at indices < 32 (the engine keeps their bits in one word);
    * ``within_boundary_cols(states_t)`` — ``[W, N] -> bool[N]``;
      ``trivial_boundary`` is True when it is all-true, so the engine
      skips it;
    * ``encode(state)`` / ``init_vecs()`` — host numpy ``uint32``
      vectors; encoding must be canonical (equal states encode equal);
    * optional ``unexpanded_rows(states_t)`` — ``[W, N] -> bool[N]``
      or ``None``: rows whose transitions the pair step lacks (a
      compiled closure's unexpanded states). The engine checks each
      wave's frontier with it and raises, as for ``hard``.

    An encoding may offer both contracts; each is held to its JAX twin
    on its own (a compiled encoding's two emissions may count
    ``states=`` differently, as in the JAX package).
    """

    #: uint32 lanes per state
    width: int
    #: action slots per state (static K)
    max_actions: int
    #: the semantic ground truth; also supplies properties() and replay
    host_model: Model
    #: no boundary predicate: the engine skips within_boundary_cols
    trivial_boundary: bool

    def init_vecs(self) -> np.ndarray: ...

    def encode(self, state: Any) -> np.ndarray: ...

    def enabled_bits_cols(self, states_t: torch.Tensor) -> torch.Tensor: ...

    def step_slot_cols(self, states_t: torch.Tensor,
                       slots: torch.Tensor) -> tuple: ...

    def property_conditions_cols(self,
                                 states_t: torch.Tensor) -> torch.Tensor: ...

    def within_boundary_cols(self, states_t: torch.Tensor) -> torch.Tensor: ...


@runtime_checkable
class SymmetricEncodedModel(Protocol):
    """An encoding whose interchangeable participants occupy uniformly
    strided bit-fields declares them (JAX ``SymmetricEncodedModel``):
    with ``CheckerBuilder.symmetry()`` the engine canonicalizes every
    candidate block before the fingerprint fold, so the visited key is
    the canonical fingerprint while the frontier keeps the concrete
    states and paths stay replayable (dfs.rs:300-311).

    The spec MUST be constant on orbits: sort on the FULL per-member
    tuple. A declared spec runs only if the soundness analyzer
    certifies it (analysis/soundness.py), or with ``unsound_ok()``."""

    def device_rewrite_spec(self):
        """``DeviceRewriteSpec`` for this encoding's interchangeable
        limb group, or None when the instance has none (e.g. a
        single-member configuration)."""
        ...


def device_rewrite_spec(enc):
    """The encoding's ``DeviceRewriteSpec``, or None when it declares
    none — the engine's single capability probe."""
    fn = getattr(enc, "device_rewrite_spec", None)
    return fn() if callable(fn) else None


def ample_mask_host(enc):
    """The encoding's host-precomputed ample-set slot mask (a
    ``uint32[ceil(max_actions/32)]`` numpy array in the ops/bitmask.py
    word layout), or None when it declares none. The sparse engine ANDs
    the words into every row's enabled bits — a static
    partial-order-reduction filter, run only if the soundness analyzer
    certifies it (analysis/soundness.py), or with ``unsound_ok()``."""
    fn = getattr(enc, "ample_mask_host", None)
    if not callable(fn):
        return None
    words = fn()
    if words is None:
        return None
    return np.asarray(words, dtype=np.uint32)


def stack_slots(slots: list, valids: list) -> tuple:
    """``(succ [W, N, K], valid bool[N, K])`` of a dense step from its
    ``K`` per-slot lane lists (``W`` tensors ``[N]`` each; a lane a slot
    leaves unchanged may be the input's own tensor) and validity masks.
    Each slot is written whole into a slot-major ``[W, K, N]`` buffer,
    lane by lane (a contiguous copy, and no second copy of the block);
    ``succ`` is a ``[W, N, K]`` view of it and ``valid`` the transpose
    of the ``[K, N]`` stacked masks."""
    W, n = len(slots[0]), slots[0][0].shape[0]
    out = torch.empty((W, len(slots), n), dtype=torch.int64,
                      device=slots[0][0].device)
    for w in range(W):
        torch.stack([s[w] for s in slots], out=out[w])
    return out.permute(0, 2, 1), torch.stack(valids).T


class EncodedModelBase:
    """Convenience defaults: no boundary."""

    def within_boundary_cols(self, states_t: torch.Tensor) -> torch.Tensor:
        return torch.ones(states_t.shape[1], dtype=torch.bool,
                          device=states_t.device)

    @property
    def trivial_boundary(self) -> bool:
        """True unless a subclass replaces ``within_boundary_cols``."""
        return (type(self).within_boundary_cols
                is EncodedModelBase.within_boundary_cols)
