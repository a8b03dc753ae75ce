"""The sort-merge wave engine, eager on a device.

The port of ``stateright_tpu.checkers.tpu_sortmerge`` (its single-device
path, sparse and dense, resident or tiered). The visited set is a SORTED
array of packed int64 fingerprint keys (ops/fingerprint.py
``pack_keys``), kept sorted by merging each wave's winners into it; the
parent forest is an append-only log of (parent, child) keys that, in a
resident run, stays on the device and is searched there, one lookup per
step, when a path is reconstructed.

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
the soundness analyzer's certificate (analysis/soundness.py):

* symmetry (``CheckerBuilder.symmetry()``): every block is mapped to its
  orbit representatives (ops/canonical.py) just before each fingerprint
  fold — the init rows, the frontier, every candidate — so visited keys,
  parent keys and discovery fingerprints are canonical while the
  frontier keeps the concrete states and paths replay;
* the ample set (``ample_set=True``, sparse only): the encoding's
  host-constant ample words are ANDed into every row's enabled words
  before the pair peel and the per-row count.

The tiered visited set (``tier_hot_rows``, tier.py) caps the device
keys at a hot ceiling and keeps the rest as sorted runs in host memory.
Once the hot keys pass ``limit = min(ceiling, max(capacity -
frontier_capacity, 1))`` at the top of a wave, the whole hot prefix
spills to the host, and from then on each wave's hot-new winners are
provisional: their keys are downloaded at the wave's sync, tested
against the cold runs on the host, and only the survivors are
committed. The spill test runs on the hot count BEFORE the wave's
survivors merge in (what the JAX engine's deferred commit sees at its
sync), so the spill schedule, ``tier_spills``, ``cold_rows`` and
``hot_rows`` equal the JAX engine's at ``waves_per_sync=1``. A tiered
run's parent log goes to host memory wave by wave; paths are walked
there.

``target_state_count`` / ``target_max_depth`` stop the loop as in the
JAX engine: after the wave that brings the visited count to the target,
or with a wave at the target depth that evaluates properties but
expands nothing. A set ``cancel_event`` (the hybrid racer's losing
side, checkers/hybrid.py) stops it at the top of the next chunk, with
``cancelled`` True, the counts of the waves done and no paths.

With ``waves_per_sync`` N > 1 (the default is 1; JAX's is 64, which the
port takes once it is no slower on the card, PERF.md), a resident run
goes in chunks of up to N waves between two host syncs (checkers/chunk.py,
:meth:`SortMergeTpuBfsChecker._waves_chunked`): every buffer of a chunk
has a power-of-two capacity class chosen at the chunk's start, every
count is a device scalar, the Merge Path kernels read their counts
from device memory (``ops.merge.member_keys_dev``, ``merge_keys_dev``),
the pairs and winners are compacted by rank scatters, the visited keys,
frontier and eventually-bits are ping-pong halves, and a wave that
would cross a class commits nothing and is run again at grown classes.
The chunk ends with one read of its packed stats; on the card its waves
replay as CUDA graphs. A tiered run, ``waves_per_sync=1`` and the deep
trace level run one wave a sync instead, each wave sized exactly to its
live rows (:meth:`SortMergeTpuBfsChecker._waves_each`). The counts do
not depend on the chunk. What the JAX ladders guaranteed stays:
overflow of the configured visited or frontier capacity RAISES, and
nothing is truncated silently.

The orders that decide the output match the JAX engine's, so the
discovery fingerprints and the paths built from them are the same:
candidates in (frontier row, ascending slot) order, a stable key sort,
the frontier in winner key order and the init rows in ``init_vecs``
order.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import checkpoint, faultinject, telemetry
from ..ops.bitmask import mask_words, popcount_words, words_to_mask
from ..ops.canonical import canonical_hits, canonicalize_t
from ..ops.fingerprint import (
    SENTINEL_KEY,
    clamp_keys,
    fingerprint_u32v_t,
    pack_keys,
)
from ..ops.merge import (
    compact_winners_keys,
    compact_winners_keys_dev,
    dump_size,
    dump_slots,
    member_keys,
    member_keys_dev,
    merge_keys,
    merge_keys_dev,
)
from ..report import ReportData
from ..telemetry import WAVE_LOG_LANES
from ..tier import ColdStore
from . import chunk
from .chunk import (
    FLOOR_F,
    FLOOR_P,
    FLOOR_V,
    GROW_F,
    GROW_P,
    GROW_V,
    OVER_ENC,
    OVER_FRONTIER,
    OVER_VISITED,
    ChunkCarry,
    ChunkLoop,
    ChunkSchedule,
    grow_class,
    shrink_classes,
    shrinks,
)
from .common import symmetry_refusal
from .tpu import (
    DENSE_CHUNK_BYTES,
    REPORT_EVERY_WAVES,
    TpuBfsChecker,
    dense_candidates,
    dense_pairs_fixed,
    discovery_update,
    fold_discoveries,
    frontier_props_t,
    host_read,
    rows_with,
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
    #: the cold tier of a tiered run (tier.py): visited keys in host
    #: memory, disjoint from ``vkeys``; None while the visited set is
    #: wholly on the device
    cold: Optional[ColdStore] = None
    #: waves run so far (a resumed run continues the count)
    waves: int = 0
    #: discoveries made before this state (property name -> fingerprint)
    discovered: dict = field(default_factory=dict)


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


def frontier_unexpanded(enc, frontier_t, live=None):
    """Whether a row of the ``[W, n]`` frontier holds a local state the
    compiled closure kept without expanding (``None`` where the encoding
    has no such state, else a ``bool`` tensor): the pair tables lack
    that state's transitions, so the wave raises the truncation error
    rather than expand it short (actor/compile.py
    ``unexpanded_rows``). One check a wave over the frontier, not one a
    pair; the dense step makes it itself."""
    fn = getattr(enc, "unexpanded_rows", None)
    rows = None if fn is None else fn(frontier_t)
    if rows is None:
        return None
    return (rows if live is None else rows & live).any()


def sparse_pair_candidates(bits, k: int):
    """The enabled (row, slot) pairs as ``(rows, slots)`` int64 tensors,
    in (row, ascending slot) order — the order the JAX engine's peel and
    packed-append compaction produce. Unpacking the words and one
    prefix-sum compaction (``nonzero``) replace the peel and the tiled
    sorts."""
    return words_to_mask(bits, k).nonzero(as_tuple=True)


def sparse_pairs_fixed(bits, k: int, cap: int, chunk_rows: int,
                       rows_bound: Optional[int] = None):
    """:func:`sparse_pair_candidates` into a fixed ``cap``-pair block,
    with no host read: ``(rows, slots, pairs)`` — the enabled pairs in
    (row, ascending slot) order, then copies of the first pair (a valid
    step), and the enabled count (0-d; more than ``cap`` means the block
    kept only the first ``cap``). Rank-scatter compaction, ``chunk_rows``
    rows of the ``[F, L]`` words at a time; ``rows_bound`` (a host count
    no live row lies past, or None) skips the chunks past it, as
    ``checkers.tpu.dense_pairs_fixed`` does."""
    F = bits.shape[0]
    dev = bits.device
    pair = torch.zeros(cap + dump_size(dev), dtype=torch.int64, device=dev)
    off = torch.zeros((), dtype=torch.int64, device=dev)
    F_live = F if rows_bound is None else min(F, max(int(rows_bound), 1))
    for r0 in range(0, F_live, chunk_rows):
        m = words_to_mask(bits[r0:min(r0 + chunk_rows, F_live)],
                          k).reshape(-1)
        rank = torch.cumsum(m.to(torch.int64), 0) - 1 + off
        pair[torch.where(m & (rank < cap), rank,
                         dump_slots(cap, m.numel(), dev))] = torch.arange(
            m.numel(), dtype=torch.int64, device=dev) + r0 * k
        off = off + m.sum()
    pair = pair[:cap]
    pair = torch.where(torch.arange(cap, device=dev) < off, pair, pair[0])
    return pair // k, pair % k, off


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
               sym_spec=None, live=None):
    """Successors ``[W, P]``, their clamped keys (the sentinel where a
    pair is excluded), the surviving-pair mask (``None``: every pair
    survives), the encoding-bound overflow flag (``None`` or a ``bool``
    tensor) and the canonical hits (``None`` without symmetry) for a
    block of pairs. The successors stay concrete; under symmetry the
    keys are their representatives'.

    The encoding's flags apply as in the JAX engine: ``hard`` pairs
    first (excluded, and they raise whatever the boundary says), then
    the boundary, then ``trunc`` on the pairs still in it (excluded,
    and they raise). ``live`` (``bool[P]``, or None: every pair) marks
    the pairs of a fixed-capacity block that exist; the others are
    excluded and never trip a flag."""
    succ_t, trunc, hard = enc.step_slot_cols(frontier_t[:, rows], slots)
    ok, eov = live, None
    if hard is not None:
        eov = (hard if live is None else hard & live).any()
        ok = ~hard if ok is None else ok & ~hard
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


def host_parent_log(blocks) -> tuple:
    """``(children, parents)``: a tiered run's host parent-log blocks as
    int64 numpy arrays sorted by child key (each child is logged once),
    so a path step is one binary search."""
    if not blocks:
        empty = np.zeros(0, np.int64)
        return empty, empty
    parents = np.concatenate([p for p, _ in blocks])
    children = np.concatenate([c for _, c in blocks])
    order = np.argsort(children, kind="stable")
    return children[order], parents[order]


class HotColdTier:
    """The host side of a tiered run (tier.py): the cold store, the hot
    count past which the hot prefix spills (``limit``), the host parent
    log, and the walls of the spills, of waiting for the ingest worker
    and of the cold membership searches."""

    def __init__(self, cold: ColdStore, ceiling: Optional[int], limit: int,
                 engine: Optional[str] = None):
        self.cold = cold
        self.ceiling = ceiling
        self.limit = limit
        #: the engine's name, for the ``tier_spill`` events
        self.engine = engine
        #: (parent keys, child keys) int64 numpy blocks, wave by wave
        self.plog: list = []
        self.spill_sec = 0.0
        self.ingest_wait_sec = 0.0
        self.member_sec = 0.0

    def spill(self, *states: WaveState) -> None:
        """Move the whole sorted hot prefix of each state (one a shard of
        the cold store) to the cold store (ingest on the worker thread)
        and leave the device tiers empty; a ``tier_spill`` event records
        it (JAX's fields: the counts are exact, the walls timing)."""
        t0 = time.monotonic()
        self.cold.sync()  # the ingest joins the last one anyway
        prev_rows, prev_runs = self.cold.rows(), self.cold.run_count()
        per_shard = [host_read(st.vkeys, numpy=True) for st in states]
        self.cold.ingest(per_shard)
        for st in states:
            st.vkeys = st.vkeys[:0]
        wall = time.monotonic() - t0
        self.spill_sec += wall
        from ..tier import COLD_BYTES_PER_ROW

        rows = int(sum(k.size for k in per_shard))
        telemetry.emit(
            "tier_spill", engine=self.engine, rows=rows,
            bytes=rows * COLD_BYTES_PER_ROW,
            rows_per_shard=[int(k.size) for k in per_shard],
            hot_rows_before=rows, hot_ceiling_rows=self.ceiling,
            spill_index=int(self.cold.spills),
            runs=int(prev_runs + sum(1 for k in per_shard if k.size)),
            cold_rows_total=int(prev_rows + rows),
            cold_bytes_total=int((prev_rows + rows) * COLD_BYTES_PER_ROW),
            wall_sec=round(wall, 6),
            ingest_sec=round(self.cold.ingest_sec, 6))

    def drop_cold_members(self, is_new: torch.Tensor,
                          s_key: torch.Tensor, shard: int = 0) -> int:
        """Clear, in place, the ``is_new`` rows whose keys the cold runs
        of ``shard`` hold; return the count of rows left (the wave's
        truly new keys). The provisional keys go to the host at the
        wave's one sync."""
        idx = is_new.nonzero().squeeze(1)
        q = host_read(s_key[idx], numpy=True)
        t0 = time.monotonic()
        self.cold.sync()
        t1 = time.monotonic()
        hit = self.cold.member(shard, q)
        self.ingest_wait_sec += t1 - t0
        self.member_sec += time.monotonic() - t1
        n_hit = int(hit.sum())
        if n_hit:
            is_new[idx[torch.from_numpy(hit).to(idx.device)]] = False
        return q.size - n_hit

    def metrics(self, hot_rows: int) -> dict:
        """The JAX engine's tier metrics, with the walls."""
        self.cold.sync()
        s = self.cold.summary()
        return dict(tier_spills=s["spills"], cold_rows=s["cold_rows_total"],
                    cold_bytes=s["cold_bytes_total"], hot_rows=hot_rows,
                    hot_ceiling_rows=self.ceiling, cold_runs=s["runs"],
                    ingest_sec=s["ingest_sec"],
                    spill_wall_sec=round(self.spill_sec, 6),
                    ingest_wait_sec=round(self.ingest_wait_sec, 6),
                    cold_member_sec=round(self.member_sec, 6))


class SortMergeCarry(ChunkCarry):
    """The chunked sort-merge wave's device state (checkers/chunk.py):
    the visited keys ``vk [2, Vc]``, the frontier ``fr [2, W, Fc]`` and
    its eventually-bits ``eb [2, Fc]`` as ping-pong halves (a wave reads
    half ``p`` and writes half ``1 - p``), and the parent log ``plog [2,
    Vc + spare]`` (parent keys, child keys; appended in place, the last
    columns spare slots for the rows a wave does not keep,
    ``ops.merge.dump_size``). The live lengths
    are the scalars ``nv``, ``nf``, ``nl``; columns past them hold
    copies of live ones (the frontier's column 0), never garbage a step
    could choke on."""

    def __init__(self, device, n_props: int, n_waves: int, log: bool,
                 W: int, Fc: int, Pc: int, Vc: int, track_paths: bool):
        super().__init__(device, n_props, n_waves, WAVE_LOG_LANES, log)
        self.Fc, self.Pc, self.Vc = Fc, Pc, Vc
        self.vk = torch.empty((2, Vc), dtype=torch.int64, device=device)
        self.fr = torch.empty((2, W, Fc), dtype=torch.int64, device=device)
        self.eb = torch.empty((2, Fc), dtype=torch.int64, device=device)
        self.plog = (torch.empty((2, Vc + dump_size(device)),
                                 dtype=torch.int64, device=device)
                     if track_paths else None)
        self.ar_f = torch.arange(Fc, dtype=torch.int64, device=device)
        self.ar_p = torch.arange(Pc, dtype=torch.int64, device=device)

    @property
    def key(self) -> tuple:
        return (self.Fc, self.Pc, self.Vc)

    def load(self, vkeys, frontier, ebits, plog_par=None, plog_child=None
             ) -> None:
        """Half 0 holds the live ``vkeys``, ``frontier`` ``[W, n]`` and
        ``ebits``, the frontier's padding copies of its column 0; the
        log holds ``plog_*``. Parity 0."""
        nv, nf = vkeys.numel(), frontier.shape[1]
        self.vk[0, :nv] = vkeys
        if nf:
            self.fr[0, :, :nf] = frontier
            self.fr[0, :, nf:] = frontier[:, :1]
            self.eb[0, :nf] = ebits
            self.eb[0, nf:] = ebits[:1]
        else:
            self.fr[0].zero_()
            self.eb[0].zero_()
        if self.plog is not None and plog_par is not None:
            nl = plog_par.numel()
            self.plog[0, :nl] = plog_par
            self.plog[1, :nl] = plog_child
        self.parity = 0
        self.nf_host = nf

    def view(self, h: dict) -> tuple:
        """``(vkeys, frontier, ebits, plog blocks)``: views of the live
        half at the host counts ``h``."""
        p = self.parity
        nv, nf, nl = h["nv"], h["nf"], h["nl"]
        plog = []
        if self.plog is not None and nl:
            plog = [(self.plog[0, :nl], self.plog[1, :nl])]
        return (self.vk[p, :nv], self.fr[p, :, :nf], self.eb[p, :nf], plog)


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
    into the sparse enabled bits (a static partial-order reduction):
    a mask the gate does not certify refuses at spawn, as an
    uncertified symmetry spec does (unless
    ``CheckerBuilder.unsound_ok()``), and the run refuses, when it
    starts, on the dense wave or without a mask.

    ``tier_hot_rows`` arms the tiered visited set (tier.py): None (the
    default) keeps every visited key on the device; an int ``>= 1`` is
    the hot tier's ceiling in keys; ``"auto"`` takes the ceiling from
    ``memplan.decide_hot_rows`` against ``tier_budget_bytes`` (2 GiB
    when None, the JAX engine's default), priced over the visited
    classes ``v_min`` times powers of ``v_ladder_step`` (the JAX
    engine's ladder; the port sizes its waves exactly and has none).
    ``tier_max_runs`` bounds the cold runs before they are compacted
    into one. Once active, ``capacity`` bounds the hot tier only.
    """

    _engine_name = "spawn_sortmerge"
    _clamps_keys = True

    def __init__(self, builder, encoded=None, capacity: int = 1 << 16,
                 frontier_capacity: Optional[int] = None,
                 track_paths: bool = True, device=None,
                 sparse: Optional[bool] = None,
                 dense_chunk_bytes: int = DENSE_CHUNK_BYTES,
                 ample_set: bool = False, tier_hot_rows=None,
                 tier_budget_bytes: Optional[int] = None,
                 tier_max_runs: int = 8, v_min: int = 1 << 19,
                 v_ladder_step: int = 2, checkpoint_every=None,
                 checkpoint_path: Optional[str] = None,
                 waves_per_sync: int = 1):
        super().__init__(builder, encoded, capacity, frontier_capacity,
                         track_paths, device,
                         checkpoint_every=checkpoint_every,
                         checkpoint_path=checkpoint_path,
                         waves_per_sync=waves_per_sync)
        self.sparse = sparse
        self.ample_set = bool(ample_set)
        self.dense_chunk_bytes = dense_chunk_bytes
        if tier_hot_rows not in (None, "auto") and int(tier_hot_rows) < 1:
            raise ValueError(f"tier_hot_rows must be >= 1: {tier_hot_rows}")
        self.tier_hot_rows = tier_hot_rows
        self.tier_budget_bytes = tier_budget_bytes
        self.tier_max_runs = tier_max_runs
        self.v_min = v_min
        self.v_ladder_step = v_ladder_step
        #: the hot-tier ceiling the last run resolved (None: untiered)
        self._tier_hot_ceiling = None
        need = (("enabled_bits_cols", "step_slot_cols")
                if self._use_sparse() else ("step_cols",))
        missing = [m for m in need if not hasattr(self.encoded, m)]
        if missing:
            raise ValueError(
                f"the {'sparse' if self._use_sparse() else 'dense'} wave "
                f"needs {' and '.join(missing)}, which "
                f"{type(self.encoded).__name__} does not have"
            )
        if self.ample_set:
            self._gate_ample()
        self._start: Optional[WaveState] = None
        #: the state the last run ended in
        self._final: Optional[WaveState] = None
        #: optional ``threading.Event``: when set, the run returns at the
        #: top of its next wave with partial counts and ``cancelled``
        #: True (the hybrid racer's losing side; see checkers/hybrid.py)
        self.cancel_event = None
        self.cancelled = False

    def _resolve_symmetry(self):
        """The encoding's ``DeviceRewriteSpec``, through the capability
        refusal and then the certificate gate (analysis/soundness.py):
        a declared spec runs only once its obligations are discharged,
        an uncertifiable one refuses here, at spawn, with the failed
        obligation, unless waived."""
        from ..analysis.soundness import gate_symmetry
        from ..encoding import device_rewrite_spec

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
        gate_symmetry(enc, self._engine_name, self.unsound_ok, self.device)
        return spec

    def _use_sparse(self) -> bool:
        if self.sparse is not None:
            return self.sparse
        return (hasattr(self.encoded, "enabled_bits_cols")
                and hasattr(self.encoded, "step_slot_cols"))

    def _gate_ample(self) -> None:
        """The certificate gate of a declared mask, at spawn beside the
        symmetry gate, so that no run's clock holds the analyzer: the
        mask filters only once enabledness preservation and
        non-suppression are discharged. A run with no usable mask
        refuses when it starts (:meth:`_resolve_ample_words`)."""
        from ..analysis.soundness import gate_ample
        from ..encoding import ample_mask_host

        aw = ample_mask_host(self.encoded) if self._use_sparse() else None
        if aw is not None and aw.shape[0] == mask_words(
                self.encoded.max_actions):
            gate_ample(self.encoded, self._engine_name, self.unsound_ok,
                       self.device)

    def _resolve_ample_words(self):
        """The validated ample mask as a device ``int64[L]``, or None
        when the filter is off (JAX ``_resolve_ample_words``); the spawn
        ran its certificate gate."""
        if not self.ample_set:
            return None
        from ..encoding import ample_mask_host

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
        return torch.from_numpy(aw.astype(np.int64)).to(self.device)

    def start_from(self, state: WaveState) -> "SortMergeTpuBfsChecker":
        """Run from ``state`` (e.g. ``convert.carry_from_numpy`` of a
        JAX engine's carry) instead of the init states."""
        self._start = state
        return self

    def _checkpoint_family(self) -> str:
        return "sortmerge"

    def _reset_for_resume(self) -> None:
        super()._reset_for_resume()
        self._final = None

    def _degrade_memory_lean(self) -> bool:
        """The supervisor's hook after two OOMs: halve
        ``dense_chunk_bytes`` (down to 1 MiB), so the dense wave steps
        smaller row chunks; the sparse wave has nothing to shrink. True
        when it changed."""
        new = max(self.dense_chunk_bytes // 2, 1 << 20)
        if new >= self.dense_chunk_bytes:
            return False
        warnings.warn(
            f"repeated OOM under supervision: dense_chunk_bytes "
            f"{self.dense_chunk_bytes} -> {new}", RuntimeWarning,
            stacklevel=2)
        self.dense_chunk_bytes = new
        return True

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

    def _tier_ceiling(self) -> Optional[int]:
        """The hot-tier ceiling in keys, None when the tier is off:
        ``"auto"`` through ``memplan.decide_hot_rows`` (the JAX engine's
        ``_tier_ceiling``)."""
        if self.tier_hot_rows is None:
            return None
        if self.tier_hot_rows == "auto":
            from ..memplan import decide_hot_rows

            return decide_hot_rows(
                self.capacity, self.v_min, self.v_ladder_step,
                self.frontier_capacity, self.tier_budget_bytes or (1 << 31))
        return min(int(self.tier_hot_rows), self.capacity)

    def _tier_limit(self, ceiling: Optional[int]) -> int:
        """The hot count past which the hot prefix spills: the ceiling,
        kept a frontier's worth below the capacity."""
        C = self.capacity
        return min(ceiling if ceiling else C,
                   max(C - self.frontier_capacity, 1))

    def _tier_activate(self, st: WaveState,
                       ceiling: Optional[int]) -> HotColdTier:
        """Enter the tiered loop: the parent log so far goes to the host
        and, past the limit, the hot prefix spills (the JAX engine's
        activation)."""
        if st.cold is None:
            st.cold = ColdStore(max_runs=self.tier_max_runs)
        elif st.cold.n_shards != 1:
            raise ValueError(
                f"the single-device engine takes a 1-shard cold store, got "
                f"{st.cold.n_shards} shards: repartitioned(1) it first")
        tier = HotColdTier(st.cold, ceiling, self._tier_limit(ceiling),
                           engine=type(self).__name__)
        tier.plog = [(p.cpu().numpy(), c.cpu().numpy()) for p, c in st.plog]
        st.plog = []
        if st.vkeys.numel() > tier.limit:
            tier.spill(st)
        return tier

    def _start_state(self) -> WaveState:
        """The state the attempt starts from: a staged snapshot (uploaded
        here), a caller's ``start_from`` state, or the init states."""
        resume, self._resume = self._resume, None
        if resume is not None:
            return checkpoint.sortmerge_state(self, resume[1])
        if self._start is not None:
            st, self._start = self._start, None
            self._started_from_state = True
            return st
        return self.seed_state()

    def _run_attempt(self, reporter=None) -> None:
        self._check_device()
        ample_words = self._resolve_ample_words()
        token = self._begin_attempt()
        st = self._traced_start(self._start_state)
        ceiling = self._tier_hot_ceiling = self._tier_ceiling()
        if st.vkeys.numel() > self.capacity:
            raise RuntimeError(self._overflow_message("visited"))
        if st.frontier.shape[1] > self.frontier_capacity:
            raise RuntimeError(self._overflow_message("frontier"))
        self._discovered_fps.update(st.discovered)
        self._unique_states = st.vkeys.numel() + (
            0 if st.cold is None else st.cold.rows())
        self._total_states = st.generated
        self._max_depth = st.depth
        tier = None
        try:
            if st.cold is not None:  # a start state with cold runs
                tier = self._tier_activate(st, ceiling)
            self._waves(st, ceiling, tier, ample_words, reporter, token)
        finally:
            # the ingest worker ends with the run, whatever ends it
            if st.cold is not None:
                st.cold.sync()

    def _waves(self, st: WaveState, ceiling, tier, ample_words,
               reporter, token) -> None:
        """The attempt's waves from ``st``: chunks of ``waves_per_sync``
        waves (:meth:`_waves_chunked`), or one wave a sync (a tiered
        run, as JAX's; ``waves_per_sync=1``; the deep trace level)."""
        if ceiling is None and tier is None and self._sync_waves() > 1:
            return self._waves_chunked(st, ample_words, reporter, token)
        return self._waves_each(st, ceiling, tier, ample_words, reporter,
                                token)

    def _waves_each(self, st: WaveState, ceiling, tier, ample_words,
                    reporter, token) -> None:
        """One wave a sync, each wave sized exactly to its live rows
        (host counts, the kernels called with them)."""
        enc = self.encoded
        props = list(self.model.properties())
        evt_idx = self._eventually_indices(props)
        K = enc.max_actions
        trivial = enc.trivial_boundary
        sym = self.sym_spec
        target_states = self.builder._target_state_count
        target_depth = self.builder._target_max_depth
        hits_total = torch.zeros((), dtype=torch.int64, device=self.device)
        max_cand = max_new = 0
        widest_wave = None
        member_shape = merge_shape = (0, 0)
        done = st.frontier.shape[1] == 0
        sparse = self._use_sparse()
        chunk_rows = max(1, self.dense_chunk_bytes // (8 * enc.width * K))
        chunks = max_chunks = 0
        cancel = self.cancel_event
        # this attempt's discoveries and unique count: a wave writes only
        # these, and the host thread publishes them after it
        fps = dict(self._discovered_fps)
        unique = self._unique_states

        def wave(w: int) -> bool:
            nonlocal max_cand, max_new, member_shape, merge_shape
            nonlocal chunks, max_chunks, widest_wave, unique
            front = st.frontier
            depth_in = st.depth
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
                pairs = 0
            elif sparse:
                succ_t, keys, rows, has_succ, n_cand, tripped, hits = \
                    self._expand_sparse(front, K, trivial, ample_words)
                pairs = rows.numel()
            else:
                succ_t, rows, has_succ, eov, n_chunks = dense_candidates(
                    enc, front, trivial, chunk_rows)
                keys, hits = successor_keys(succ_t, sym)
                n_cand = pairs = keys.numel()  # JAX's dense convention
                tripped = bool(host_read(eov))
                chunks += n_chunks
                max_chunks = max(max_chunks, n_chunks)
            # the fault site between the wave's issue and its sync
            faultinject.fire("mid_chunk", w)
            if self._abandoned(token):
                raise RuntimeError("wave abandoned by the watchdog")
            if hits is not None:
                hits_total.add_(hits)
            if props:
                disc = wave_hits(props, cond, ~has_succ & (eb != 0), eb,
                                 f_lo, f_hi)
                discovery_update(props, *disc, fps)
            if tripped:
                raise RuntimeError(self._overflow_message("encoding", fps))

            # -- merge stage: stable candidate sort, membership, winners
            s_key, s_pos = torch.sort(keys, stable=True)
            prev_same = torch.zeros_like(s_key, dtype=torch.bool)
            prev_same[1:] = s_key[1:] == s_key[:-1]
            fresh = (s_key != SENTINEL_KEY) & ~prev_same
            hot_rows = st.vkeys.numel()
            is_new = fresh & ~member_keys(st.vkeys, s_key)
            wave_hits_n = None
            if tier is None:
                if hits is None:
                    new_count = host_read(is_new.sum())
                else:  # the wave's canonical hits ride the same read
                    new_count, wave_hits_n = host_read(torch.stack(
                        [is_new.sum(), hits.to(torch.int64)]))
                spill = False
                over = hot_rows + new_count
            else:
                # the hot-new rows are provisional until the cold runs
                # clear them; the spill test reads the hot count before
                # this wave's survivors merge in
                new_count = tier.drop_cold_members(is_new, s_key)
                spill = hot_rows > tier.limit
                over = (0 if spill else hot_rows) + new_count
            if over > self.capacity:
                raise RuntimeError(self._overflow_message("visited", fps))
            if new_count > self.frontier_capacity:
                raise RuntimeError(self._overflow_message("frontier", fps))
            nf_pos, w_key = compact_winners_keys(is_new, s_pos, s_key,
                                                 new_count)
            par_row = rows[nf_pos]
            if self.track_paths and new_count:
                block = (pack_keys(f_lo, f_hi)[par_row], w_key)
                if tier is None:
                    st.plog.append(block)
                else:
                    tier.plog.append(tuple(host_read(t, numpy=True)
                                           for t in block))
            if spill:
                tier.spill(st)
            merge_rows = st.vkeys.numel()
            if new_count:
                st.vkeys = merge_keys(st.vkeys, w_key)
            st.frontier = succ_t[:, nf_pos]
            st.ebits = eb[par_row]
            st.generated += n_cand
            st.waves += 1
            # the kernels' widest calls (a call on an empty hot tier
            # launches nothing)
            if hot_rows and keys.numel() > member_shape[1]:
                member_shape = (hot_rows, keys.numel())
            if merge_rows and new_count > merge_shape[1]:
                merge_shape = (merge_rows, new_count)
            if keys.numel() > max_cand:
                widest_wave = st.waves - 1
            max_cand = max(max_cand, keys.numel())
            max_new = max(max_new, new_count)

            unique += new_count
            if self._tracer is not None:
                # the wave's row (telemetry.WAVE_LOG_FIELDS): host values
                # the wave already holds; no ladder, so no classes
                row = [front.shape[1], pairs, n_cand, new_count, unique,
                       depth_in, None, None]
                if wave_hits_n is not None:
                    row.append(wave_hits_n)
                self._trace_row = (st.waves - 1, row, None)
            all_disc = bool(props) and len(fps) == len(props)
            target_hit = target_states is not None and unique >= target_states
            finished = new_count == 0 or all_disc or target_hit
            if not finished:
                st.depth += 1
            return finished

        w = 0
        while not done:
            if cancel is not None and cancel.is_set():
                self.cancelled = True
                break
            if (tier is None and ceiling is not None
                    and st.vkeys.numel() > self._tier_limit(ceiling)):
                tier = self._tier_activate(st, ceiling)
            t0 = time.monotonic()
            try:
                done = self._guarded_wave(lambda: wave(w), w)
            finally:
                self._publish(token, fps, unique, st.generated, st.depth)
            self._wave_done(w, t0, done,
                            lambda: checkpoint.sortmerge_buffers(self, st,
                                                                 tier))
            w += 1
            if (reporter is not None and not done
                    and st.waves % REPORT_EVERY_WAVES == 0):
                reporter.report_checking(ReportData(
                    total_states=self._total_states,
                    unique_states=self._unique_states,
                    max_depth=self._max_depth,
                    duration_sec=self.duration_sec(),
                    done=False,
                ))
        meters = dict(waves=st.waves, max_cand=max_cand,
                      widest=-1 if widest_wave is None else widest_wave,
                      max_new=max_new, mem_na=member_shape[0],
                      mem_nq=member_shape[1], mrg_na=merge_shape[0],
                      mrg_nb=merge_shape[1], hits=int(hits_total),
                      chunks=chunks, max_chunks=max_chunks)
        self._finish_sortmerge(st, tier, sparse, meters,
                               dict(waves_per_sync=1), chunk_rows, ceiling)

    def _finish_sortmerge(self, st: WaveState, tier, sparse: bool,
                          m: Optional[dict], extra: dict, chunk_rows: int,
                          ceiling=None) -> None:
        """The end of a run, either loop: ``metrics`` from the meters
        ``m`` (the chunk's scalar names; None when no wave ran) and
        ``extra``, the final state, the paths and the memory plan."""
        m = m or dict(waves=st.waves, max_cand=0, widest=-1, max_new=0,
                      mem_na=0, mem_nq=0, mrg_na=0, mrg_nb=0, hits=0,
                      chunks=0, max_chunks=0)
        # the widest calls: the member kernel's query count and the
        # merge kernel's winner count at their largest, each with the
        # (hot) visited-set size it met there: (Na, Nq) and (Na, Nb)
        # widest_wave: the index of the wave with the most candidates
        max_cand = m["max_cand"]
        self.metrics = dict(waves=st.waves, max_wave_candidates=max_cand,
                            widest_wave=None if m["widest"] < 0
                            else m["widest"],
                            max_wave_new=m["max_new"],
                            member_shape=(m["mem_na"], m["mem_nq"]),
                            merge_shape=(m["mrg_na"], m["mrg_nb"]),
                            expansion="sparse" if sparse else "dense",
                            canonical_hits=int(m["hits"]))
        if not sparse:
            self.metrics.update(dense_chunks=m["chunks"],
                                max_wave_chunks=m["max_chunks"],
                                chunk_rows=chunk_rows)
        if ceiling is not None:
            self.metrics["hot_ceiling_rows"] = ceiling
        if tier is not None:
            self.metrics.update(tier.metrics(st.vkeys.numel()))
        self.metrics.update(extra)
        self.metrics.update(self._ckpt_metrics())
        self._final = st
        if self.keep_final_carry:
            self._final_carry = (st, tier)
        if self.track_paths and not self.cancelled:
            if tier is None:
                # the log stays on the device: each path step is one
                # device-side lookup, and nothing of it is downloaded
                empty = st.vkeys.new_zeros(0)
                self._plog = (
                    torch.cat([c for _, c in st.plog]) if st.plog else empty,
                    torch.cat([p for p, _ in st.plog]) if st.plog else empty,
                )
            else:
                self._plog = host_parent_log(tier.plog)
            for name, fp in self._discovered_fps.items():
                self._discoveries[name] = self._reconstruct(fp)
        self.memory_plan = self._sortmerge_memory_plan(
            st, max_cand, tier is not None,
            extra.get("classes") if extra else None)

    # -- the chunked waves (checkers/chunk.py) ------------------------------

    def _chunk_context(self, ample_words):
        """What every chunked wave of an attempt reads from the host: the
        encoding, properties, flags and configured capacities."""
        from types import SimpleNamespace

        enc = self.encoded
        K = enc.max_actions
        return SimpleNamespace(
            enc=enc, props=list(self.model.properties()),
            evt_idx=self._eventually_indices(list(self.model.properties())),
            K=K, trivial=enc.trivial_boundary, sym=self.sym_spec,
            sparse=self._use_sparse(), ample_words=ample_words,
            chunk_rows=max(1, self.dense_chunk_bytes
                           // (8 * enc.width * K)),
            pair_rows=max(1, (1 << 24) // K),
            target_states=self.builder._target_state_count,
            target_depth=self.builder._target_max_depth,
            track=self.track_paths)

    def _sm_carry(self, c, n_waves: int, Fc: int, Pc: int, Vc: int,
                  traced: bool) -> SortMergeCarry:
        cx = SortMergeCarry(self.device, len(c.props), n_waves, traced,
                            self.encoded.width, Fc, Pc, Vc, c.track)
        if not c.sparse:
            cx.step_rows = Fc * c.K
        return cx

    def _sm_classes(self, c, h: dict, cur=None) -> tuple:
        """The ``(Fc, Pc, Vc)`` classes for the next wave from the
        polled scalars ``h``: the current classes (``cur``) grown where
        the last wave asked, shrunk where the frontier shrank
        (checkers/chunk.py), or, with no ``cur``, fresh ones."""
        fcap = self.frontier_capacity
        pcap = max(1, fcap * c.K)
        if cur is None:
            Fc = grow_class(h["nf"], fcap, FLOOR_F)
            Pc = grow_class(h["nf"] * c.K, pcap, FLOOR_P)
            Vc = grow_class(h["nv"], self.capacity, FLOOR_V)
            return Fc, Pc, Vc
        Fc, Pc, Vc = cur
        if h["grow"] & GROW_P:
            Pc = grow_class(h["need_p"], pcap, FLOOR_P)
        if h["grow"] & GROW_F:
            # room for the frontier's growth rate r over the next waves,
            # and the pairs and visited keys that scale with it, grown
            # now rather than one wave later
            r = min(max(h["need_f"] / max(h["nf"], 1), 1.0),
                    chunk.GROWTH_CAP)
            ahead = int(h["need_f"] * r)
            per_row = -(-h["need_p"] // max(h["nf"], 1))
            Fc = grow_class(ahead, fcap, FLOOR_F)
            Pc = max(Pc, grow_class(ahead * per_row, pcap, FLOOR_P))
            Vc = max(Vc, grow_class(h["nv"] + h["need_f"] + ahead + int(
                ahead * r), self.capacity, FLOOR_V))
        if h["grow"] & GROW_V:
            Vc = grow_class(h["need_v"], self.capacity, FLOOR_V)
        if shrinks(h, Fc):
            Fc, Pc = shrink_classes(h, Pc, fcap, pcap)
        return Fc, Pc, Vc

    def _sm_wave(self, cx: SortMergeCarry, p: int, c) -> None:
        """One chunked sort-merge wave, reading half ``p`` of ``cx`` and
        writing half ``1 - p``: the steps of :meth:`_waves`'s wave on
        class-sized buffers with the counts in ``cx.sc``, no host read.
        A wave that does not fit its classes, or comes after the chunk's
        stop, commits nothing (see checkers/chunk.py)."""
        enc, props, sym, K = c.enc, c.props, c.sym, c.K
        dev = cx.device
        nv, nf, nl, depth = cx.s("nv"), cx.s("nf"), cx.s("nl"), cx.s("depth")
        live = cx.s("stop") == 0
        Fc, Pc, Vc = cx.Fc, cx.Pc, cx.Vc
        front, ebits_in = cx.fr[p], cx.eb[p]
        fmask = cx.ar_f < nf
        cond, eb, f_lo, f_hi = frontier_props_t(enc, props, c.evt_idx, front,
                                                ebits_in, sym)
        at_target = (torch.zeros((), dtype=torch.bool, device=dev)
                     if c.target_depth is None else depth >= c.target_depth)
        expand = fmask & ~at_target
        n_chunks = None
        if c.sparse:
            cut = frontier_unexpanded(enc, front, expand)
            bits, cnt = frontier_enabled_bits(enc, front, c.ample_words)
            bits = torch.where(expand.unsqueeze(1), bits, 0)
            per_row = torch.where(expand, cnt, 0)
            rows, slots, pairs = sparse_pairs_fixed(bits, K, Pc, c.pair_rows,
                                                    cx.rows_bound())
            pvalid = cx.ar_p < pairs
            succ_t, keys, ok, eov, hits = eval_pairs(
                enc, front, rows, slots, c.trivial, sym, live=pvalid)
            if cut is not None:
                eov = cut if eov is None else eov | cut
            n_cand = ok.sum()
            kn = pairs  # the keys a wave sorts: every enabled pair
        else:
            succ_t, rows, pairs, eov, per_row = dense_pairs_fixed(
                enc, front, expand, c.chunk_rows, Pc, cx.rows_bound())
            ok = cx.ar_p < pairs
            if not c.trivial:
                ok = ok & enc.within_boundary_cols(succ_t)
            keys, hits = successor_keys(succ_t, sym, ok)
            keys = torch.where(ok, keys, SENTINEL_KEY)
            n_cand = kn = ok.sum()  # JAX's dense convention
            n_chunks = torch.where(at_target, 0,
                                   (nf + c.chunk_rows - 1) // c.chunk_rows)
        has_succ = rows_with(per_row, ok) | at_target
        p_over = pairs > Pc

        # -- merge stage, on the class-sized candidate block
        s_key, s_pos = torch.sort(keys, stable=True)
        prev_same = torch.zeros_like(s_key, dtype=torch.bool)
        prev_same[1:] = s_key[1:] == s_key[:-1]
        fresh = (s_key != SENTINEL_KEY) & ~prev_same
        is_new = fresh & ~member_keys_dev(cx.vk[p], nv, s_key, n_cand)
        new = is_new.sum()
        nv_after = nv + new

        # -- the verdicts, in the order the one-wave loop raises them
        fits_p = live & ~p_over
        enc_trip = fits_p & (False if eov is None else eov)
        v_raise = fits_p & ~enc_trip & (nv_after > self.capacity)
        f_raise = (fits_p & ~enc_trip & ~v_raise
                   & (new > self.frontier_capacity))
        raised = enc_trip | v_raise | f_raise
        g_v = fits_p & ~raised & (nv_after > Vc)
        g_f = fits_p & ~raised & (new > Fc)
        commit = fits_p & ~raised & ~g_v & ~g_f
        grow = ((live & p_over).to(torch.int64) * GROW_P
                + g_f.to(torch.int64) * GROW_F + g_v.to(torch.int64) * GROW_V)
        over = (enc_trip.to(torch.int64) * OVER_ENC
                + v_raise.to(torch.int64) * OVER_VISITED
                + f_raise.to(torch.int64) * OVER_FRONTIER)

        all_disc = torch.zeros((), dtype=torch.bool, device=dev)
        if props:
            hit, lo, hi = wave_hits(props, cond, ~has_succ & (eb != 0), eb,
                                    f_lo, f_hi, live=fmask)
            disc = fold_discoveries(cx.disc, hit, lo, hi,
                                    fits_p & ~g_v & ~g_f)
            cx.disc.copy_(disc)
            all_disc = disc[0].all()

        # -- the commit: winners, parent log, visited merge, next frontier
        nf_pos, w_key = compact_winners_keys_dev(is_new, s_pos, s_key, Fc)
        par_row = rows[nf_pos]
        if cx.plog is not None:
            dest = torch.where(commit & (cx.ar_f < new), nl + cx.ar_f,
                               dump_slots(Vc, Fc, dev))
            cx.plog[0][dest] = pack_keys(f_lo, f_hi)[par_row]
            cx.plog[1][dest] = w_key
        merge_keys_dev(cx.vk[p], torch.where(commit, nv, 0), w_key,
                       torch.where(commit, new, 0), cx.vk[1 - p])
        cx.fr[1 - p].copy_(succ_t[:, nf_pos])
        cx.eb[1 - p].copy_(eb[par_row])

        # -- the scalars
        fin = (new == 0) | all_disc
        if c.target_states is not None:
            fin = fin | (nv_after >= c.target_states)
        done = commit & fin
        ci = commit.to(torch.int64)
        z = torch.zeros((), dtype=torch.int64, device=dev)
        hits_n = z if hits is None else hits.to(torch.int64)
        mem = commit & (nv > 0) & (kn > cx.s("mem_nq"))
        mrg = commit & (nv > 0) & (new > cx.s("mrg_nb"))
        wider = commit & (kn > cx.s("max_cand"))
        upd = dict(
            stop=((cx.s("stop") != 0) | done | (grow != 0)
                  | raised).to(torch.int64),
            done=(cx.s("done") != 0).to(torch.int64) | done.to(torch.int64),
            grow=cx.s("grow") | grow, over=cx.s("over") | over,
            depth=depth + (commit & ~fin).to(torch.int64),
            waves=cx.s("waves") + ci,
            nv=torch.where(commit, nv_after, nv),
            nf=torch.where(commit, new, nf),
            nl=nl + (ci * new if cx.plog is not None else z),
            gen=cx.s("gen") + ci * n_cand,
            wchunk=cx.s("wchunk") + ci,
            need_p=torch.where(live & ~commit, pairs, cx.s("need_p")),
            need_f=torch.where(g_f, new, cx.s("need_f")),
            need_v=torch.where(g_v, nv_after, cx.s("need_v")),
            last_p=torch.where(commit, pairs, cx.s("last_p")),
            last_nf=torch.where(commit, nf, cx.s("last_nf")),
            hits=cx.s("hits") + ci * hits_n,
            max_cand=torch.where(wider, kn, cx.s("max_cand")),
            widest=torch.where(wider, cx.s("waves"), cx.s("widest")),
            max_new=torch.where(commit & (new > cx.s("max_new")), new,
                                cx.s("max_new")),
            mem_na=torch.where(mem, nv, cx.s("mem_na")),
            mem_nq=torch.where(mem, kn, cx.s("mem_nq")),
            mrg_na=torch.where(mrg, nv, cx.s("mrg_na")),
            mrg_nb=torch.where(mrg, new, cx.s("mrg_nb")),
        )
        if n_chunks is not None:
            upd["chunks"] = cx.s("chunks") + ci * n_chunks
            upd["max_chunks"] = torch.where(
                commit & (n_chunks > cx.s("max_chunks")), n_chunks,
                cx.s("max_chunks"))
        if cx.log is not None:
            row = torch.stack([nf, kn, n_cand, new, nv_after, depth,
                               z - 1, z - 1,
                               hits_n if hits is not None else z - 1])
            at = torch.where(commit, cx.s("wchunk"), cx.n_waves)
            cx.log.index_copy_(0, at.view(1), row.view(1, -1))
        cx.write(upd)

    def _waves_chunked(self, st: WaveState, ample_words, reporter,
                       token) -> None:
        """The resident run as chunks of up to ``waves_per_sync`` waves
        (checkers/chunk.py): each chunk issues its waves with no host
        read and ends with one read of the packed stats; a wave that did
        not fit its classes runs again, in the same chunk, at grown
        classes. ``st`` is loaded into the carry and, at the end, holds
        the run's final state as :meth:`_waves` leaves it."""
        from .chunk import WaveRunner

        c = self._chunk_context(ample_words)
        N = self._sync_waves()
        traced = self._tracer is not None
        nl0 = sum(int(ch.numel()) for _, ch in st.plog)
        h = dict(nv=st.vkeys.numel(), nf=st.frontier.shape[1], nl=nl0)
        fps = dict(self._discovered_fps)
        props = c.props
        fcap = self.frontier_capacity
        classes = chunk.start_classes(
            self._sm_classes(c, h), self._resume_classes,
            lambda k: (h["nf"] <= k[0] <= fcap
                       and k[1] <= max(1, fcap * c.K)
                       and h["nv"] <= k[2] <= self.capacity))
        self._resume_classes = None
        cx = self._sm_carry(c, N, *classes[-1], traced)
        plog = ((torch.cat([p for p, _ in st.plog]),
                 torch.cat([ch for _, ch in st.plog]))
                if st.plog and cx.plog is not None else (None, None))
        cx.load(st.vkeys, st.frontier, st.ebits, *plog)
        cx.set_scalars(depth=st.depth, waves=st.waves, nv=h["nv"],
                       nf=h["nf"], nl=nl0 if cx.plog is not None else 0,
                       gen=st.generated, widest=-1)
        for i, prop in enumerate(props):
            fp = fps.get(prop.name)
            if fp is not None:
                cx.disc[:, i] = torch.tensor(
                    [1, fp & 0xFFFFFFFF, fp >> 32], dtype=torch.int64)
        runner = WaveRunner(self.device, "sort-merge")
        cancel = self.cancel_event
        chunk_no = 0
        done = h["nf"] == 0
        unique = h["nv"]
        stats = None
        loop = ChunkLoop(
            runner, ChunkSchedule(st.waves, N),
            lambda cx_, par: self._sm_wave(cx_, par, c),
            lambda h_, key: self._sm_classes(c, h_, key),
            lambda cx_, h_, key: self._resized(c, cx_, h_, key, traced),
            len(props), classes, check=lambda: self._check_token(token))
        self._chunk_classes = loop.classes

        def run_chunk() -> dict:
            nonlocal cx
            cx, out = loop.chunk(cx)
            found, lo, hi = out["disc"]
            for i, prop in enumerate(props):
                if found[i] and prop.name not in fps:
                    fps[prop.name] = (hi[i] << 32) | lo[i]
            return out

        def state_view(out):
            vkeys, front, ebits, plog = cx.view(out)
            return WaveState(vkeys=vkeys, frontier=front, ebits=ebits,
                             depth=out["depth"], generated=out["gen"],
                             plog=plog, waves=out["waves"])

        try:
            while not done:
                if cancel is not None and cancel.is_set():
                    self.cancelled = True
                    break
                t0 = time.monotonic()
                try:
                    stats = self._guarded_wave(run_chunk, chunk_no)
                    unique = stats["nv"]
                finally:
                    if stats is not None:
                        self._publish(token, fps, unique, stats["gen"],
                                      stats["depth"])
                over = stats["over"]
                for bit, kind in ((OVER_ENC, "encoding"),
                                  (OVER_VISITED, "visited"),
                                  (OVER_FRONTIER, "frontier")):
                    if over & bit:
                        raise RuntimeError(self._overflow_message(kind, fps))
                done = bool(stats["done"])
                boundary = loop.sched.synced(stats["waves"], done)
                if self._tracer is not None:
                    self._trace_row = (stats["waves"] - stats["wchunk"],
                                       [self._log_row(r, c.sym)
                                        for r in stats["rows"]], None,
                                       stats["wchunk"])
                self._wave_done(chunk_no, t0, done,
                                lambda: checkpoint.sortmerge_buffers(
                                    self, state_view(stats), None), boundary)
                chunk_no += 1
                if done:
                    break
                if reporter is not None and boundary is not None:
                    reporter.report_checking(ReportData(
                        total_states=self._total_states,
                        unique_states=self._unique_states,
                        max_depth=self._max_depth,
                        duration_sec=self.duration_sec(), done=False))
        finally:
            runner.close()
        if stats is not None:
            vkeys, front, ebits, plog = cx.view(stats)
            st.vkeys, st.frontier, st.ebits = (vkeys.clone(), front.clone(),
                                               ebits.clone())
            st.plog = [(a.clone(), b.clone()) for a, b in plog]
            st.depth, st.generated = stats["depth"], stats["gen"]
            st.waves = stats["waves"]
        self._finish_sortmerge(st, None, c.sparse, stats, dict(
            waves_per_sync=N, chunks=chunk_no, resizes=loop.resizes,
            classes=[list(k) for k in loop.classes], **runner.counts()),
            c.chunk_rows)

    def _resized(self, c, cx: SortMergeCarry, h: dict, classes: tuple,
                 traced: bool) -> SortMergeCarry:
        """A carry at ``classes`` holding ``cx``'s live state (at the
        polled counts ``h``), its scalars, discovery lanes and wave log."""
        new = self._sm_carry(c, cx.n_waves, *classes, traced)
        vkeys, front, ebits, plog = cx.view(h)
        par = chi = None
        if plog:
            par, chi = plog[0]
        new.load(vkeys, front, ebits, par, chi)
        new.sc.copy_(cx.sc)
        new.disc.copy_(cx.disc)
        if cx.log is not None:
            new.log.copy_(cx.log)
        return new

    @staticmethod
    def _log_row(row: list, sym) -> list:
        """A device wave-log row as the trace takes it: no ladder classes
        (None) and the canonical hits only with symmetry."""
        out = [None if x < 0 else x for x in row[:6]] + [None, None]
        if sym is not None:
            out.append(row[8])
        return out

    def _kernel_sources(self) -> tuple:
        from ..ops import merge

        return (merge,)

    def _lane_config(self) -> dict:
        lane = super()._lane_config()
        lane.update(expansion="sparse" if self._use_sparse() else "dense",
                    tier_hot_rows=self.tier_hot_rows, visited_exact=True,
                    symmetry=self.sym_spec is not None,
                    ample_set=self.ample_set)
        if self.sym_spec is not None or self.ample_set:
            # certificate provenance rides the lane config, and so every
            # trace's run_begin: True/False when the analyzer ran,
            # absent when no reduction is on (JAX _lane_config)
            from ..analysis.soundness import soundness_status

            lane.update(soundness_certified=soundness_status(
                self.encoded, self.device))
        return lane

    def _visited_bytes_per_row(self) -> int:
        """Device bytes per visited state of a resident run: the key in
        ``vkeys``, and the parent and child keys of the parent log when
        paths are tracked (the JAX engine's 8 + 16)."""
        return 8 + (16 if self.track_paths else 0)

    def _memory_projection(self) -> dict:
        """The keys and merge scratch at the next visited class (``v_min``
        times powers of ``v_ladder_step`` up to ``capacity``, past it the
        next capacity step): the JAX engine's ``next_v_class`` pricing
        over the visited count (the hot count in a tiered run)."""
        rows = (self._final.vkeys.numel() if self._final is not None
                else self._unique_states)
        ladder = [min(self.v_min, self.capacity)]
        while ladder[-1] < self.capacity:
            ladder.append(min(ladder[-1] * self.v_ladder_step,
                              self.capacity))
        idx = sum(1 for v in ladder[:-1] if max(rows, 1) > v)
        nxt = (ladder[idx + 1] if idx + 1 < len(ladder)
               else self.capacity * self.v_ladder_step)
        F = self.frontier_capacity
        return dict(kind="next_v_class", current_rows=int(ladder[idx]),
                    next_rows=int(nxt),
                    next_vkeys_bytes=int((nxt + F) * 8),
                    next_merge_scratch_bytes=int((nxt + F) * 8))

    def _sortmerge_memory_plan(self, st: WaveState, max_cand: int,
                               tiered: bool, classes=None) -> dict:
        """The ledger of the tensors kept between waves, at the end of
        the run (the parent log on the device only in a resident run),
        the widest wave's candidate staging and, chunked, each capacity
        class ``(Fc, Pc, Vc)`` the run used, priced."""
        resident = dict(vkeys=st.vkeys, frontier=st.frontier,
                        ebits=st.ebits)
        host = {}
        if self.track_paths and self._plog is not None:
            names = ("plog_child", "plog_parent")
            (host if tiered else resident).update(zip(names, self._plog))
        if tiered:
            host["cold_keys"] = ((st.cold.rows(),), np.int64)
        W = self.encoded.width
        staging = dict(candidates=((W, max_cand), np.int64),
                       candidate_keys=((max_cand,), np.int64),
                       sorted_keys=((max_cand,), np.int64),
                       sorted_pos=((max_cand,), np.int64))
        from ..memplan import chunk_class_entries

        priced = [chunk_class_entries("sortmerge", W, *k,
                                      track_paths=self.track_paths, index=i)
                  for i, k in enumerate(classes or [])]
        return self._memory_plan_of(resident, staging, host, priced)

    def _expand_sparse(self, front, K: int, trivial: bool, ample_words):
        """The sparse expansion of one wave: ``(succ_t, keys, rows,
        has_succ, n_cand, tripped, hits)`` — every enabled pair's
        successor and key (the sentinel where a pair is excluded), its
        source row, which rows keep a successor, the surviving-pair
        count, the encoding-bound overflow and the canonical hits
        (``None`` without symmetry)."""
        enc = self.encoded
        cut = frontier_unexpanded(enc, front)
        bits, cnt = frontier_enabled_bits(enc, front, ample_words)
        rows, slots = sparse_pair_candidates(bits, K)
        succ_t, keys, ok, eov, hits = eval_pairs(
            enc, front, rows, slots, trivial, self.sym_spec)
        if cut is not None:
            eov = cut if eov is None else eov | cut
        tripped = False
        if ok is None:
            if eov is not None:
                tripped = bool(host_read(eov))
            return (succ_t, keys, rows, cnt > 0, rows.numel(), tripped,
                    hits)
        has_succ = torch.zeros(front.shape[1], dtype=torch.bool,
                               device=front.device)
        has_succ[rows[ok]] = True
        if eov is None:
            n_cand = host_read(ok.sum())
        else:  # one transfer for the count and the flag
            n_cand, tripped = host_read(torch.stack([ok.sum(), eov.long()]))
        return succ_t, keys, rows, has_succ, n_cand, tripped, hits
