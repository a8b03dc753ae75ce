"""The sort-merge wave engine, eager on a device.

The port of ``stateright_tpu.checkers.tpu_sortmerge`` (its single-device,
untiered path, sparse and dense). The visited set is a SORTED array of
packed int64 fingerprint keys (ops/fingerprint.py ``pack_keys``), kept
sorted by merging each wave's winners into it; the parent forest is an
append-only log of (parent, child) keys that stays on the device and is
searched there, one lookup per step, when a path is reconstructed.

One wave, on the ``[W, n]`` lane-major frontier:

1. frontier fingerprints, property bits and discoveries
   (checkers/tpu.py ``frontier_props_t``, ``wave_hits``);
2. the candidates, in (frontier row, ascending slot) order, by one of
   two expansions:

   * sparse (the default where the encoding offers it): the packed
     enabled-slot words of every row (:func:`frontier_enabled_bits`),
     the enabled (row, slot) pairs (:func:`sparse_pair_candidates`),
     then the pair step, the encoding's truncation flags, the boundary
     and the fingerprint fold of every successor (:func:`eval_pairs`);
   * dense (``sparse=False``, or an encoding with only ``step_cols``):
     the step of every row in every slot, in contiguous row chunks
     whose ``[W, rows*K]`` block stays under a byte budget; each
     chunk's valid, in-boundary successors are compacted (successor
     columns, source row) before the next chunk is stepped, and only
     they are fingerprinted (:func:`dense_candidates`, the JAX
     ``expand_frontier`` and its per-tile path);
3. one STABLE sort of the candidate keys (buffer position breaks ties,
   so the lowest-position duplicate wins) and an adjacent-equal check;
4. membership against the sorted visited set — ``ops.merge.member_keys``,
   the CUDA member kernel on the card;
5. order-preserving winner compaction (``compact_winners_keys``); the
   winners, in KEY order, become the next frontier, their parents' keys
   go to the parent log;
6. the visited append — ``ops.merge.merge_keys``, the CUDA merge kernel
   on the card.

Two reductions ride the wave, each armed by the caller and gated by
soundness.py:

* symmetry (``CheckerBuilder.symmetry()``): every block is mapped to its
  orbit representatives (ops/canonical.py) just before each fingerprint
  fold — the init rows, the frontier, every candidate — so visited keys,
  parent keys and discovery fingerprints are canonical while the
  frontier keeps the concrete states and paths replay;
* the ample set (``ample_set=True``, sparse only): the encoding's
  host-constant ample words are ANDed into every row's enabled words
  before the pair peel and the per-row count.

``target_state_count`` / ``target_max_depth`` stop the loop as in the
JAX engine: after the wave that brings the visited count to the target,
or with a wave at the target depth that evaluates properties but
expands nothing. A set ``cancel_event`` (the hybrid racer's losing
side, checkers/hybrid.py) stops it at the top of the next wave, with
``cancelled`` True, the counts of the waves done and no paths.

The JAX engine compiles static shapes, so it carries class ladders,
``lax.switch`` variants, pair-width and candidate budgets, and a budget
store. PyTorch runs eagerly, so this engine sizes every wave exactly:
one host sync per wave reads the winner count. What the ladders
guaranteed stays: overflow of the configured visited or frontier
capacity RAISES, and nothing is truncated silently.

The orders that decide the output match the JAX engine's, so the
discovery fingerprints and the paths built from them are the same:
candidates in (frontier row, ascending slot) order, a stable key sort,
the frontier in winner key order and the init rows in ``init_vecs``
order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..ops.bitmask import mask_words, popcount_words, words_to_mask
from ..ops.canonical import canonical_hits, canonicalize_t
from ..ops.fingerprint import (
    SENTINEL_KEY,
    clamp_keys,
    fingerprint_u32v_t,
    pack_keys,
)
from ..ops.merge import compact_winners_keys, member_keys, merge_keys
from ..report import ReportData
from .common import symmetry_refusal
from .tpu import (
    DENSE_CHUNK_BYTES,
    REPORT_EVERY_WAVES,
    TpuBfsChecker,
    dense_candidates,
    discovery_update,
    frontier_props_t,
    wave_hits,
)


@dataclass
class WaveState:
    """The engine's resident state between waves (all on one device)."""

    #: int64[U] sorted packed keys of every visited state
    vkeys: torch.Tensor
    #: int64[W, n] the frontier's uint32 lanes, lane-major
    frontier: torch.Tensor
    #: int64[n] eventually-bits per frontier row
    ebits: torch.Tensor
    depth: int = 1
    #: the ``states=`` counter: init rows plus every generated candidate
    generated: int = 0
    #: parent-log blocks: (parent keys, child keys), int64 each
    plog: list = field(default_factory=list)


def frontier_enabled_bits(enc, frontier_t, ample_words=None):
    """Per-row packed enabled words ``int64[n, L]`` and per-row enabled
    counts over the ``[W, n]`` frontier. ``ample_words`` (``int64[L]``,
    or None: no filter) is the ample-set mask, ANDed in before the
    count, so a slot it drops neither reaches the peel nor makes its
    row non-terminal."""
    bits = enc.enabled_bits_cols(frontier_t)
    if ample_words is not None:
        bits = bits & ample_words
    return bits, popcount_words(bits)


def sparse_pair_candidates(bits, k: int):
    """The enabled (row, slot) pairs as ``(rows, slots)`` int64 tensors,
    in (row, ascending slot) order — the order the JAX engine's peel and
    packed-append compaction produce. Unpacking the words and one
    prefix-sum compaction (``nonzero``) replace the peel and the tiled
    sorts."""
    return words_to_mask(bits, k).nonzero(as_tuple=True)


def successor_keys(succ_t, sym_spec=None, valid=None):
    """The clamped packed keys of a ``[W, n]`` successor block and its
    canonical hits: without symmetry ``(keys, None)``; with it, the keys
    of the orbit representatives and the count of ``valid`` columns
    (all, if None) the canonicalizer changed."""
    if sym_spec is None:
        src, hits = succ_t, None
    else:
        src = canonicalize_t(sym_spec, succ_t)
        hits = canonical_hits(succ_t, src, valid)
    return clamp_keys(pack_keys(*fingerprint_u32v_t(src))), hits


def eval_pairs(enc, frontier_t, rows, slots, trivial_boundary: bool,
               sym_spec=None):
    """Successors ``[W, P]``, their clamped keys (the sentinel where a
    pair is excluded), the surviving-pair mask (``None``: every pair
    survives), the encoding-bound overflow flag (``None`` or a ``bool``
    tensor) and the canonical hits (``None`` without symmetry) for a
    block of pairs. The successors stay concrete; under symmetry the
    keys are their representatives'.

    The encoding's flags apply as in the JAX engine: ``hard`` pairs
    first (excluded, and they raise whatever the boundary says), then
    the boundary, then ``trunc`` on the pairs still in it (excluded,
    and they raise)."""
    succ_t, trunc, hard = enc.step_slot_cols(frontier_t[:, rows], slots)
    ok = eov = None
    if hard is not None:
        eov = hard.any()
        ok = ~hard
    if not trivial_boundary:
        inb = enc.within_boundary_cols(succ_t)
        ok = inb if ok is None else ok & inb
    if trunc is not None:
        cut = trunc if ok is None else ok & trunc
        eov = cut.any() if eov is None else eov | cut.any()
        ok = ~trunc if ok is None else ok & ~trunc
    keys, hits = successor_keys(succ_t, sym_spec, ok)
    if ok is None:
        return succ_t, keys, None, eov, hits
    return succ_t, torch.where(ok, keys, SENTINEL_KEY), ok, eov, hits


class SortMergeTpuBfsChecker(TpuBfsChecker):
    """``CheckerBuilder.spawn_sortmerge()``.

    ``capacity`` bounds the visited set and ``frontier_capacity`` the
    states one wave may add (the JAX engine's buffer sizes); crossing
    either raises. ``device`` defaults to the CUDA device; pass
    ``"cpu"`` for the plain-PyTorch path.

    ``sparse`` picks the expansion: ``None`` (default) runs sparse iff
    the encoding has ``enabled_bits_cols`` and ``step_slot_cols`` (the
    JAX engine's rule), ``False`` forces the dense ``step_cols``
    expansion, ``True`` the sparse one. ``dense_chunk_bytes`` bounds the
    ``[W, rows*K]`` int64 successor block of one dense chunk.

    ``ample_set=True`` ANDs the encoding's ``ample_mask_host()`` words
    into the sparse enabled bits (a static partial-order reduction);
    the run refuses, when it starts, on the dense wave, without a mask,
    or with a mask the gate does not certify (unless
    ``CheckerBuilder.unsound_ok()``).
    """

    _engine_name = "spawn_sortmerge"
    _clamps_keys = True

    def __init__(self, builder, encoded=None, capacity: int = 1 << 16,
                 frontier_capacity: Optional[int] = None,
                 track_paths: bool = True, device=None,
                 sparse: Optional[bool] = None,
                 dense_chunk_bytes: int = DENSE_CHUNK_BYTES,
                 ample_set: bool = False):
        super().__init__(builder, encoded, capacity, frontier_capacity,
                         track_paths, device)
        self.sparse = sparse
        self.ample_set = bool(ample_set)
        self.dense_chunk_bytes = dense_chunk_bytes
        need = (("enabled_bits_cols", "step_slot_cols")
                if self._use_sparse() else ("step_cols",))
        missing = [m for m in need if not hasattr(self.encoded, m)]
        if missing:
            raise ValueError(
                f"the {'sparse' if self._use_sparse() else 'dense'} wave "
                f"needs {' and '.join(missing)}, which "
                f"{type(self.encoded).__name__} does not have"
            )
        self._start: Optional[WaveState] = None
        #: optional ``threading.Event``: when set, the run returns at the
        #: top of its next wave with partial counts and ``cancelled``
        #: True (the hybrid racer's losing side; see checkers/hybrid.py)
        self.cancel_event = None
        self.cancelled = False

    def _resolve_symmetry(self):
        """The encoding's ``DeviceRewriteSpec``, through the capability
        refusal and then the gate (soundness.py)."""
        from ..encoding import device_rewrite_spec
        from ..soundness import gate_symmetry

        enc = self.encoded
        spec = device_rewrite_spec(enc)
        if spec is None:
            raise symmetry_refusal(
                self._engine_name,
                missing=(
                    f"encoding {type(enc).__name__} declares no "
                    "device_rewrite_spec() — the vectorized "
                    "canonicalization needs the strided bit-field "
                    "layout of the interchangeable limb group"
                ),
            )
        gate_symmetry(enc, self._engine_name, self.unsound_ok)
        return spec

    def _use_sparse(self) -> bool:
        if self.sparse is not None:
            return self.sparse
        return (hasattr(self.encoded, "enabled_bits_cols")
                and hasattr(self.encoded, "step_slot_cols"))

    def _resolve_ample_words(self):
        """The validated ample mask as a device ``int64[L]``, or None
        when the filter is off (JAX ``_resolve_ample_words``)."""
        if not self.ample_set:
            return None
        from ..encoding import ample_mask_host
        from ..soundness import gate_ample

        enc = self.encoded
        if not self._use_sparse():
            raise ValueError(
                "ample_set requires the sparse dispatch path (the "
                "filter is an AND over the packed enabled bitmap); "
                "this run resolved to the dense wave"
            )
        aw = ample_mask_host(enc)
        if aw is None:
            raise ValueError(
                f"ample_set: encoding {type(enc).__name__} declares "
                "no ample_mask_host() — the engine cannot invent a "
                "sound reduction; declare the mask on the encoding "
                "(it owns the soundness argument) or drop the flag"
            )
        if aw.shape[0] != mask_words(enc.max_actions):
            raise ValueError(
                f"ample_mask_host() returned {aw.shape[0]} words; "
                f"max_actions={enc.max_actions} needs "
                f"{mask_words(enc.max_actions)}"
            )
        gate_ample(enc, self._engine_name, self.unsound_ok)
        return torch.from_numpy(aw.astype(np.int64)).to(self.device)

    def start_from(self, state: WaveState) -> "SortMergeTpuBfsChecker":
        """Run from ``state`` (e.g. ``convert.carry_from_numpy`` of a
        JAX engine's carry) instead of the init states."""
        self._start = state
        return self

    # -- the wave loop ------------------------------------------------------

    def seed_state(self) -> WaveState:
        init = self._init_rows()
        n0 = init.shape[0]
        front = torch.from_numpy(init.astype(np.int64).T.copy()).to(
            self.device)
        keys, _ = successor_keys(front, self.sym_spec)
        ebits = torch.full((n0,), self._eventually_bits_init(),
                           dtype=torch.int64, device=self.device)
        return WaveState(vkeys=torch.sort(keys).values, frontier=front,
                         ebits=ebits, generated=n0)

    def _run(self, reporter=None) -> None:
        self._check_device()
        ample_words = self._resolve_ample_words()
        st = self._start if self._start is not None else self.seed_state()
        self._start = None
        enc = self.encoded
        props = list(self.model.properties())
        evt_idx = self._eventually_indices(props)
        K = enc.max_actions
        trivial = enc.trivial_boundary
        sym = self.sym_spec
        target_states = self.builder._target_state_count
        target_depth = self.builder._target_max_depth
        hits_total = torch.zeros((), dtype=torch.int64, device=self.device)
        waves = max_cand = max_new = 0
        member_shape = merge_shape = (0, 0)
        done = st.frontier.shape[1] == 0
        if st.vkeys.numel() > self.capacity:
            raise RuntimeError(self._overflow_message("visited"))
        self._unique_states = st.vkeys.numel()
        self._total_states = st.generated
        self._max_depth = st.depth
        sparse = self._use_sparse()
        chunk_rows = max(1, self.dense_chunk_bytes // (8 * enc.width * K))
        chunks = max_chunks = 0
        cancel = self.cancel_event
        while not done:
            if cancel is not None and cancel.is_set():
                self.cancelled = True
                break
            front = st.frontier
            cond, eb, f_lo, f_hi = frontier_props_t(
                enc, props, evt_idx, front, st.ebits, sym
            )
            hits = None
            if target_depth is not None and st.depth >= target_depth:
                # the wave at the target depth evaluates its frontier and
                # expands nothing; its rows are not terminal
                succ_t, keys = front[:, :0], st.vkeys[:0]
                rows, n_cand, tripped = keys, 0, False
                has_succ = torch.ones_like(eb, dtype=torch.bool)
            elif sparse:
                succ_t, keys, rows, has_succ, n_cand, tripped, hits = \
                    self._expand_sparse(front, K, trivial, ample_words)
            else:
                succ_t, rows, has_succ, eov, n_chunks = dense_candidates(
                    enc, front, trivial, chunk_rows)
                keys, hits = successor_keys(succ_t, sym)
                n_cand = keys.numel()
                tripped = bool(eov)
                chunks += n_chunks
                max_chunks = max(max_chunks, n_chunks)
            if hits is not None:
                hits_total += hits
            if props:
                disc = wave_hits(props, cond, ~has_succ & (eb != 0), eb,
                                 f_lo, f_hi)
                discovery_update(props, *disc, self._discovered_fps)
            if tripped:
                raise RuntimeError(self._overflow_message("encoding"))

            # -- merge stage: stable candidate sort, membership, winners
            s_key, s_pos = torch.sort(keys, stable=True)
            prev_same = torch.zeros_like(s_key, dtype=torch.bool)
            prev_same[1:] = s_key[1:] == s_key[:-1]
            fresh = (s_key != SENTINEL_KEY) & ~prev_same
            is_new = fresh & ~member_keys(st.vkeys, s_key)
            new_count = int(is_new.sum())
            unique = st.vkeys.numel() + new_count
            if unique > self.capacity:
                raise RuntimeError(self._overflow_message("visited"))
            if new_count > self.frontier_capacity:
                raise RuntimeError(self._overflow_message("frontier"))
            nf_pos, w_key = compact_winners_keys(is_new, s_pos, s_key,
                                                 new_count)
            par_row = rows[nf_pos]
            if self.track_paths and new_count:
                st.plog.append((pack_keys(f_lo, f_hi)[par_row], w_key))
            if new_count:
                st.vkeys = merge_keys(st.vkeys, w_key)
            st.frontier = succ_t[:, nf_pos]
            st.ebits = eb[par_row]
            st.generated += n_cand
            waves += 1
            if keys.numel() > max_cand:
                max_cand = keys.numel()
                member_shape = (unique - new_count, max_cand)
            if new_count > max_new:
                max_new = new_count
                merge_shape = (unique - new_count, new_count)

            all_disc = bool(props) and len(self._discovered_fps) == len(props)
            target_hit = target_states is not None and unique >= target_states
            done = new_count == 0 or all_disc or target_hit
            if not done:
                st.depth += 1
            self._unique_states = unique
            self._total_states = st.generated
            self._max_depth = st.depth
            if (reporter is not None and not done
                    and waves % REPORT_EVERY_WAVES == 0):
                reporter.report_checking(ReportData(
                    total_states=self._total_states,
                    unique_states=self._unique_states,
                    max_depth=self._max_depth,
                    duration_sec=self.duration_sec(),
                    done=False,
                ))
        # the widest waves: the member kernel's query count and the
        # merge kernel's winner count at their largest, each with the
        # visited-set size it met there: (Na, Nq) and (Na, Nb)
        self.metrics = dict(waves=waves, max_wave_candidates=max_cand,
                            max_wave_new=max_new, member_shape=member_shape,
                            merge_shape=merge_shape,
                            expansion="sparse" if sparse else "dense",
                            canonical_hits=int(hits_total))
        if not sparse:
            self.metrics.update(dense_chunks=chunks,
                                max_wave_chunks=max_chunks,
                                chunk_rows=chunk_rows)
        self._final = st
        if self.track_paths and not self.cancelled:
            # the log stays on the device: each path step is one
            # device-side lookup, and nothing of it is downloaded
            empty = st.vkeys.new_zeros(0)
            self._plog = (
                torch.cat([c for _, c in st.plog]) if st.plog else empty,
                torch.cat([p for p, _ in st.plog]) if st.plog else empty,
            )
            for name, fp in self._discovered_fps.items():
                self._discoveries[name] = self._reconstruct(fp)

    def _expand_sparse(self, front, K: int, trivial: bool, ample_words):
        """The sparse expansion of one wave: ``(succ_t, keys, rows,
        has_succ, n_cand, tripped, hits)`` — every enabled pair's
        successor and key (the sentinel where a pair is excluded), its
        source row, which rows keep a successor, the surviving-pair
        count, the encoding-bound overflow and the canonical hits
        (``None`` without symmetry)."""
        enc = self.encoded
        bits, cnt = frontier_enabled_bits(enc, front, ample_words)
        rows, slots = sparse_pair_candidates(bits, K)
        succ_t, keys, ok, eov, hits = eval_pairs(
            enc, front, rows, slots, trivial, self.sym_spec)
        tripped = False
        if ok is None:
            return (succ_t, keys, rows, cnt > 0, rows.numel(), tripped,
                    hits)
        has_succ = torch.zeros(front.shape[1], dtype=torch.bool,
                               device=front.device)
        has_succ[rows[ok]] = True
        if eov is None:
            n_cand = int(ok.sum())
        else:  # one transfer for the count and the flag
            n_cand, tripped = torch.stack([ok.sum(), eov.long()]).tolist()
        return succ_t, keys, rows, has_succ, n_cand, tripped, hits
