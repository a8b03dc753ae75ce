"""The sharded sort-merge wave engine: one controller over S shards.

The port of the JAX package's ``parallel/engine_sortmerge.py``
(``ShardedSortMergeTpuBfsChecker``), with the mesh replaced by a list of
devices (see the package docstring). Shard ``s`` owns the keys whose
low 32 bits are ``s`` mod S: its slice of the visited set (a sorted
int64 key array), the parent-log entries of the states it owns, and the
frontier rows it discovered.

One wave:

1. each shard evaluates its frontier block (fingerprints, properties,
   eventually-bits) and expands it, sparse or dense, exactly as the
   single-device engine does (checkers/tpu_sortmerge.py), giving its
   candidates in (frontier row, ascending slot) order;
2. discoveries fold across shards: the lowest hitting shard wins, then
   its first hitting row (JAX's ``pmin`` fold);
3. each shard routes its candidates by owner (parallel/exchange.py),
   carrying the successor state, the parent's eventually-bits, the key
   and, with paths, the parent's key; the S×S counts are read at the
   wave's host sync and the exchange delivers each owner its rows, in
   source order;
4. each owner runs the single-device merge stage on what it received:
   one stable sort of the keys, the adjacent-equal check,
   ``ops.merge.member_keys`` against its own sorted visited keys (the
   CUDA member kernel on the card), the order-preserving winner
   compaction, its next frontier block in key order and its parent-log
   block, and ``ops.merge.merge_keys`` into its visited keys (the CUDA
   merge kernel): S launches of each kernel a wave.

Capacities are per shard (``total_capacity = capacity * S``, JAX's);
crossing one on any shard raises, naming the shard. The targets, the
EVENTUALLY bits, paths on and off, ``symmetry()`` and ``ample_set``
behave as on one device: under symmetry a key is its orbit
representative's, so an orbit has one owner and the per-shard dedup is
a global one. A counterexample path is walked one parent-log lookup at a
time, each on the shard that owns the step's key.

The tiered visited set (``tier_hot_rows``, tier.py) is JAX's sharded
one: one cold store with a shard a shard; once the fullest shard's hot
keys pass the limit at the top of a wave, every shard's hot prefix
spills, and from then on each owner's hot-new winners are tested
against its own cold runs on the host before they commit. The spill
test reads the hot counts before the wave's survivors merge in, as on
one device, and the parent log goes to host memory.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import checkpoint, faultinject
from ..checkers.tpu import (
    DENSE_CHUNK_BYTES,
    REPORT_EVERY_WAVES,
    dense_candidates,
    frontier_props_t,
    host_read,
    wave_hits,
)
from ..checkers.tpu_sortmerge import (
    HotColdTier,
    SortMergeTpuBfsChecker,
    WaveState,
    host_parent_log,
    successor_keys,
)
from ..ops.fingerprint import fp_to_key, key_to_fp, pack_keys
from ..ops.merge import compact_winners_keys, member_keys, merge_keys
from ..report import ReportData
from ..tier import ColdStore
from .exchange import (
    exchange,
    host_rows,
    owner_of,
    resolve_devices,
    route,
    routed_off_shard,
)
from .shards import ShardedEngine, fold_discoveries, shard_row


@dataclass
class MeshState:
    """A sharded run's state between waves: one :class:`WaveState` a
    shard (its ``vkeys``, ``frontier``, ``ebits`` and ``plog`` on the
    shard's device; its own counters unused) and the run's counters."""

    shards: list
    #: the cold tier of a tiered run (tier.py), one store shard a shard;
    #: None while the visited set is wholly on the devices
    cold: Optional[ColdStore] = None
    depth: int = 1
    #: the ``states=`` counter: init rows plus every generated candidate
    generated: int = 0
    waves: int = 0
    #: rows routed off their source shard so far (JAX ``sent``)
    routed: int = 0
    discovered: dict = field(default_factory=dict)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def hot(self) -> list:
        return [sh.vkeys.numel() for sh in self.shards]

    def unique(self) -> int:
        return sum(self.hot()) + (0 if self.cold is None
                                  else self.cold.rows())


class ShardedSortMergeTpuBfsChecker(ShardedEngine, SortMergeTpuBfsChecker):
    """``CheckerBuilder.spawn_sharded_sortmerge()`` — the sort-merge wave
    engine over S shards, shard ``s`` on ``devices[s]``.

    ``devices`` lists one device a shard and may repeat one (CPU devices
    run the plain PyTorch path); without it, ``n_shards`` shards take one
    visible card each, ``n_shards`` defaulting to every card, and more
    shards than cards raise. ``capacity`` and ``frontier_capacity`` are
    per shard, and so is the hot ceiling of the tiered visited set
    (``tier_hot_rows``). The other options are the single-device
    engine's (checkers/tpu_sortmerge.py)."""

    _engine_name = "spawn_sharded_sortmerge"

    def __init__(self, builder, encoded=None, n_shards: Optional[int] = None,
                 devices=None, capacity: int = 1 << 16,
                 frontier_capacity: Optional[int] = None,
                 track_paths: bool = True, sparse: Optional[bool] = None,
                 dense_chunk_bytes: int = DENSE_CHUNK_BYTES,
                 ample_set: bool = False, tier_hot_rows=None,
                 tier_budget_bytes: Optional[int] = None,
                 tier_max_runs: int = 8, v_min: int = 1 << 19,
                 v_ladder_step: int = 2, checkpoint_every=None,
                 checkpoint_path: Optional[str] = None,
                 waves_per_sync: int = 1):
        devs = resolve_devices(n_shards, devices)
        super().__init__(builder, encoded, capacity, frontier_capacity,
                         track_paths, devs[0], sparse=sparse,
                         dense_chunk_bytes=dense_chunk_bytes,
                         ample_set=ample_set, tier_hot_rows=tier_hot_rows,
                         tier_budget_bytes=tier_budget_bytes,
                         tier_max_runs=tier_max_runs, v_min=v_min,
                         v_ladder_step=v_ladder_step,
                         checkpoint_every=checkpoint_every,
                         checkpoint_path=checkpoint_path,
                         waves_per_sync=waves_per_sync)
        self._set_devices(devs)

    # -- the start state ----------------------------------------------------

    def _checkpoint_family(self) -> str:
        return "sortmerge"

    def seed_state(self) -> MeshState:
        """The init rows, each on the shard that owns its key, in
        ``init_vecs`` order; each shard's visited keys sorted (JAX
        ``seed_local``)."""
        init = self._init_rows()
        n0 = init.shape[0]
        front = torch.from_numpy(init.astype(np.int64).T.copy())
        keys, _ = successor_keys(front, self.sym_spec)
        owner = owner_of(keys, self.n_shards)
        shards = []
        for s, dev in enumerate(self.devices):
            mine = owner == s
            m = int(mine.sum())
            shards.append(WaveState(
                vkeys=torch.sort(keys[mine]).values.to(dev),
                frontier=front[:, mine].to(dev),
                ebits=torch.full((m,), self._eventually_bits_init(),
                                 dtype=torch.int64, device=dev)))
        return MeshState(shards=shards, generated=n0)

    def start_from(self, state: MeshState) -> "ShardedSortMergeTpuBfsChecker":
        """Run from ``state`` (e.g. ``convert.mesh_from_numpy`` of a JAX
        mesh carry) instead of the init states; its shard count must be
        this checker's."""
        if state.n_shards != self.n_shards:
            raise ValueError(
                f"a {state.n_shards}-shard state on a {self.n_shards}-shard "
                "checker: re-shard it through a snapshot")
        self._start = state
        return self

    def _start_state(self) -> MeshState:
        resume, self._resume = self._resume, None
        if resume is not None:
            return checkpoint.sortmerge_mesh_state(self, resume[1])
        if self._start is not None:
            st, self._start = self._start, None
            self._started_from_state = True
            for sh, dev in zip(st.shards, self.devices):
                sh.vkeys, sh.frontier, sh.ebits = (
                    sh.vkeys.to(dev), sh.frontier.to(dev), sh.ebits.to(dev))
                sh.plog = [(p.to(dev), c.to(dev)) for p, c in sh.plog]
            return st
        return self.seed_state()

    # -- the wave loop ------------------------------------------------------

    def _run_attempt(self, reporter=None) -> None:
        self._check_device()
        aw = self._resolve_ample_words()
        ample = [None if aw is None else aw.to(d) for d in self.devices]
        token = self._begin_attempt()
        st = self._traced_start(self._start_state)
        for s, sh in enumerate(st.shards):
            if sh.vkeys.numel() > self.capacity:
                raise RuntimeError(self._overflow_message("visited", shard=s))
            if sh.frontier.shape[1] > self.frontier_capacity:
                raise RuntimeError(self._overflow_message("frontier",
                                                          shard=s))
        self._discovered_fps.update(st.discovered)
        self._unique_states = st.unique()
        self._total_states = st.generated
        self._max_depth = st.depth
        ceiling = self._tier_hot_ceiling = self._tier_ceiling()
        tier = None
        try:
            if st.cold is not None:  # a start state with cold runs
                tier = self._mesh_tier_activate(st, ceiling)
            self._mesh_waves(st, ceiling, tier, ample, reporter, token)
        finally:
            # the ingest worker ends with the run, whatever ends it
            if st.cold is not None:
                st.cold.sync()

    def _mesh_tier_activate(self, st: MeshState, ceiling) -> HotColdTier:
        """Enter the tiered loop (JAX's sharded takeover): one cold-store
        shard a shard, the parent logs to host memory and, when the
        fullest shard's hot keys pass the limit, every shard's hot
        prefix spilled at once."""
        S = self.n_shards
        if st.cold is None:
            st.cold = ColdStore(n_shards=S, max_runs=self.tier_max_runs)
        elif st.cold.n_shards != S:
            raise ValueError(
                f"a {st.cold.n_shards}-shard cold store on {S} shards: "
                f"repartitioned({S}) it first")
        tier = HotColdTier(st.cold, ceiling, self._tier_limit(ceiling),
                           engine=type(self).__name__)
        for sh in st.shards:
            tier.plog += [(p.cpu().numpy(), c.cpu().numpy())
                          for p, c in sh.plog]
            sh.plog = []
        if max(st.hot()) > tier.limit:
            tier.spill(*st.shards)
        return tier

    def _expand(self, sh: WaveState, ample_words, K: int, trivial: bool,
                chunk_rows: int):
        """One shard's expansion: ``(succ_t, keys, rows, has_succ, n_cand,
        tripped, hits, dense chunks)``, as the single-device wave."""
        if self._use_sparse():
            out = self._expand_sparse(sh.frontier, K, trivial, ample_words)
            return (*out, 0)
        succ_t, rows, has_succ, eov, n_chunks = dense_candidates(
            self.encoded, sh.frontier, trivial, chunk_rows)
        keys, hits = successor_keys(succ_t, self.sym_spec)
        return (succ_t, keys, rows, has_succ, keys.numel(),
                bool(host_read(eov)), hits, n_chunks)

    def _mesh_waves(self, st: MeshState, ceiling, tier, ample, reporter,
                    token) -> None:
        enc = self.encoded
        props = list(self.model.properties())
        P = len(props)
        evt_idx = self._eventually_indices(props)
        K, W = enc.max_actions, enc.width
        trivial = enc.trivial_boundary
        sym = self.sym_spec
        S = self.n_shards
        target_states = self.builder._target_state_count
        target_depth = self.builder._target_max_depth
        sparse = self._use_sparse()
        chunk_rows = max(1, self.dense_chunk_bytes // (8 * W * K))
        paths = self.track_paths
        hits_total = 0
        stats = dict(max_cand=0, max_new=0, widest_wave=None, chunks=0,
                     max_chunks=0, member_shape=(0, 0), merge_shape=(0, 0),
                     max_recv=0)
        done = all(sh.frontier.shape[1] == 0 for sh in st.shards)
        fps = dict(self._discovered_fps)
        unique = self._unique_states
        # per-shard visited counts (hot and cold), for the trace's rows
        shard_u = st.hot()
        if st.cold is not None:
            st.cold.sync()
            shard_u = [u + c for u, c in zip(shard_u, st.cold.shard_rows())]

        def wave(w: int) -> bool:
            nonlocal unique, hits_total
            expand = target_depth is None or st.depth < target_depth
            depth_in = st.depth
            routed, counts, rows_out = [], [], []
            n_cands, tripped_any, wave_chunks = [], False, 0
            n_front, n_pairs = [], []
            for s, sh in enumerate(st.shards):
                cond, eb, f_lo, f_hi = frontier_props_t(
                    enc, props, evt_idx, sh.frontier, sh.ebits, sym)
                n = sh.frontier.shape[1]
                if expand and n:
                    (succ_t, keys, rows, has_succ, n_cand, tripped, hits,
                     n_chunks) = self._expand(sh, ample[s], K, trivial,
                                              chunk_rows)
                else:
                    # the wave at the target depth evaluates its frontier
                    # and expands nothing; its rows are not terminal (and
                    # a shard with no frontier has nothing to expand)
                    succ_t, keys = sh.frontier[:, :0], sh.vkeys[:0]
                    rows, n_cand, tripped, hits, n_chunks = keys, 0, False, \
                        None, 0
                    has_succ = torch.ones_like(eb, dtype=torch.bool)
                wave_chunks = max(wave_chunks, n_chunks)
                tripped_any |= bool(tripped)
                n_cands.append(int(n_cand))
                n_front.append(n)
                # the enabled pairs (the candidates on the dense wave)
                n_pairs.append(rows.numel() if sparse else int(n_cand))
                if hits is not None:
                    hits_total += host_read(hits)
                # the routed lanes: state, parent's eventually-bits, key
                # and, with paths, the parent's key
                lanes = [succ_t, eb[rows][None], keys[None]]
                if paths:
                    lanes.append(pack_keys(f_lo, f_hi)[rows][None])
                block, cnt = route(torch.cat(lanes), keys, S)
                routed.append(block)
                row = [cnt]
                if P and n:
                    hit, lo, hi = wave_hits(props, cond,
                                            ~has_succ & (eb != 0), eb,
                                            f_lo, f_hi)
                    row += [hit.to(torch.int64), lo, hi]
                elif P:
                    row.append(cnt.new_zeros(3 * P))
                rows_out.append(torch.cat(row))
            # the fault site between the wave's issue and its sync
            faultinject.fire("mid_chunk", w, shards=self._fault_shards())
            if self._abandoned(token):
                raise RuntimeError("wave abandoned by the watchdog")
            # the wave's sync: the S x S counts and the verdicts, at once
            host = host_rows(rows_out)
            counts = [r[:S] for r in host]
            if P:
                fold_discoveries(props, [r[S:] for r in host], fps)
            if tripped_any:
                raise RuntimeError(self._overflow_message("encoding", fps))
            faultinject.fire("collective_seam", w, shards=self._fault_shards())
            received = exchange(routed, counts, self.devices)
            del routed
            # -- merge stage, owner-local ----------------------------------
            sorted_, news = [], []
            for d, sh in enumerate(st.shards):
                recv = received[d]
                s_key, s_pos = torch.sort(recv[W + 1], stable=True)
                prev_same = torch.zeros_like(s_key, dtype=torch.bool)
                prev_same[1:] = s_key[1:] == s_key[:-1]
                is_new = ~prev_same & ~member_keys(sh.vkeys, s_key)
                sorted_.append((s_key, s_pos, is_new))
                news.append(is_new.sum().reshape(1))
                wide = recv.shape[1] > stats["member_shape"][1]
                if sh.vkeys.numel() and wide:
                    stats["member_shape"] = (sh.vkeys.numel(), recv.shape[1])
                stats["max_recv"] = max(stats["max_recv"], recv.shape[1])
            hot_rows = st.hot()
            if tier is None:
                new_counts = [r[0] for r in host_rows(news)]
                spill = False
            else:
                # each owner's hot-new rows are provisional until its
                # cold runs clear them; the spill test reads the hot
                # counts before this wave's survivors merge in (JAX's
                # deferred commit), and a spill empties every shard
                new_counts = [tier.drop_cold_members(is_new, s_key, d)
                              for d, (s_key, _, is_new) in
                              enumerate(sorted_)]
                spill = max(hot_rows) > tier.limit
            for d, n in enumerate(new_counts):
                if (0 if spill else hot_rows[d]) + n > self.capacity:
                    raise RuntimeError(self._overflow_message("visited", fps,
                                                              shard=d))
                if n > self.frontier_capacity:
                    raise RuntimeError(self._overflow_message("frontier",
                                                              fps, shard=d))
            if spill:
                tier.spill(*st.shards)
            for d, sh in enumerate(st.shards):
                s_key, s_pos, is_new = sorted_[d]
                n = new_counts[d]
                recv = received[d]
                nf_pos, w_key = compact_winners_keys(is_new, s_pos, s_key, n)
                if paths and n:
                    block = (recv[W + 2, nf_pos], w_key)
                    if tier is None:
                        sh.plog.append(block)
                    else:
                        tier.plog.append(tuple(t.cpu().numpy()
                                               for t in block))
                merge_rows = sh.vkeys.numel()
                if n:
                    sh.vkeys = merge_keys(sh.vkeys, w_key)
                if merge_rows and n > stats["merge_shape"][1]:
                    stats["merge_shape"] = (merge_rows, n)
                sh.frontier = recv[:W, nf_pos]
                sh.ebits = recv[W, nf_pos]
            new_total = sum(new_counts)
            if self._tracer is not None:
                peak = max(stats["max_cand"], max(n_cands))
                srows = []
                for d in range(S):
                    shard_u[d] += new_counts[d]
                    srows.append(shard_row(
                        n_front[d], n_pairs[d], n_cands[d], counts[d], d,
                        received[d].shape[1], new_counts[d], shard_u[d],
                        peak))
                row = [sum(n_front), sum(n_pairs), sum(n_cands), new_total,
                       unique + new_total, depth_in, None, None]
                self._trace_row = (st.waves, row, srows)
            st.routed += routed_off_shard(counts)
            st.generated += sum(n_cands)
            st.waves += 1
            stats["chunks"] += wave_chunks
            stats["max_chunks"] = max(stats["max_chunks"], wave_chunks)
            if max(n_cands) > stats["max_cand"]:
                stats["widest_wave"] = st.waves - 1
            stats["max_cand"] = max(stats["max_cand"], max(n_cands))
            stats["max_new"] = max(stats["max_new"], max(new_counts))
            unique += new_total
            all_disc = bool(props) and len(fps) == len(props)
            target_hit = target_states is not None and unique >= target_states
            finished = new_total == 0 or all_disc or target_hit
            if not finished:
                st.depth += 1
            return finished

        w = 0
        while not done:
            if (tier is None and ceiling is not None
                    and max(st.hot()) > self._tier_limit(ceiling)):
                tier = self._mesh_tier_activate(st, ceiling)
            t0 = time.monotonic()
            try:
                done = self._guarded_wave(lambda: wave(w), w)
            finally:
                self._publish(token, fps, unique, st.generated, st.depth)
            self._wave_done(w, t0, done,
                            lambda: checkpoint.mesh_sortmerge_buffers(
                                self, st, tier))
            w += 1
            if (reporter is not None and not done
                    and st.waves % REPORT_EVERY_WAVES == 0):
                reporter.report_checking(ReportData(
                    total_states=self._total_states,
                    unique_states=self._unique_states,
                    max_depth=self._max_depth,
                    duration_sec=self.duration_sec(), done=False))
        # per shard: the widest call of each kernel; max_wave_candidates
        # is the largest shard's candidates in one wave (JAX's per-shard
        # peak), max_wave_received the largest owner's received rows
        self.metrics = dict(
            waves=st.waves, n_shards=S, max_wave_candidates=stats["max_cand"],
            widest_wave=stats["widest_wave"],
            max_wave_new=stats["max_new"],
            max_wave_received=stats["max_recv"],
            member_shape=stats["member_shape"],
            merge_shape=stats["merge_shape"],
            expansion="sparse" if sparse else "dense",
            canonical_hits=hits_total, shuffle_volume=st.routed,
            shard_unique=[sh.vkeys.numel() for sh in st.shards],
            devices=[str(d) for d in self.devices])
        if not sparse:
            self.metrics.update(dense_chunks=stats["chunks"],
                                max_wave_chunks=stats["max_chunks"],
                                chunk_rows=chunk_rows)
        if ceiling is not None:
            self.metrics["hot_ceiling_rows"] = ceiling
        if tier is not None:
            self.metrics.update(tier.metrics(sum(st.hot())))
            self.metrics["cold_rows_per_shard"] = st.cold.shard_rows()
        self.metrics.update(self._ckpt_metrics())
        self._final = st
        if paths and tier is not None:
            # a tiered run's log is in host memory: one binary search a
            # step over every shard's entries
            self._plog = host_parent_log(tier.plog)
        elif paths:
            self._plog = []
            for sh in st.shards:
                empty = sh.vkeys.new_zeros(0)
                self._plog.append((
                    torch.cat([c for _, c in sh.plog]) if sh.plog else empty,
                    torch.cat([p for p, _ in sh.plog]) if sh.plog else empty))
        if paths:
            for name, fp in self._discovered_fps.items():
                self._discoveries[name] = self._reconstruct(fp)
        self.memory_plan = self._mesh_memory_plan(st)

    # -- results ------------------------------------------------------------

    def _parent_of(self, fp: int) -> Optional[int]:
        """One lookup in the parent log of the shard that owns ``fp`` (in
        the host log of a tiered run)."""
        if not isinstance(self._plog, list):
            return super()._parent_of(fp)
        key = fp_to_key(fp)
        children, parents = self._plog[(key & 0xFFFFFFFF) % self.n_shards]
        hit = (children == key).nonzero()
        if hit.numel() == 0:
            return None
        return key_to_fp(int(parents[hit[0, 0]]))

    def _memory_projection(self) -> dict:
        rows = (max(sh.vkeys.numel() for sh in self._final.shards)
                if self._final is not None else self._unique_states)
        F = self.frontier_capacity
        return dict(kind="next_v_class", current_rows=int(rows),
                    per_shard=True, next_rows=int(self.capacity),
                    next_vkeys_bytes=int((self.capacity + F) * 8),
                    next_merge_scratch_bytes=int((self.capacity + F) * 8))

    def _mesh_memory_plan(self, st: MeshState) -> dict:
        """The single-device ledger over every shard's tensors (names
        carry the shard), with the shard count."""
        resident, host = {}, {}
        for s, sh in enumerate(st.shards):
            resident.update({f"vkeys[{s}]": sh.vkeys,
                             f"frontier[{s}]": sh.frontier,
                             f"ebits[{s}]": sh.ebits})
            if isinstance(self._plog, list):
                resident[f"plog_child[{s}]"] = self._plog[s][0]
                resident[f"plog_parent[{s}]"] = self._plog[s][1]
        if self.track_paths and isinstance(self._plog, tuple):
            host.update(zip(("plog_child", "plog_parent"), self._plog))
        if st.cold is not None:
            host["cold_keys"] = ((st.cold.rows(),), np.int64)
        W = self.encoded.width
        m = self.metrics.get("max_wave_candidates", 0)
        r = self.metrics.get("max_wave_received", 0)
        lanes = W + (3 if self.track_paths else 2)
        staging = dict(candidates=((W, m), np.int64),
                       routed=((lanes, m), np.int64),
                       received=((lanes, r), np.int64),
                       sorted_keys=((r,), np.int64))
        plan = self._memory_plan_of(resident, staging, host)
        plan["n_shards"] = self.n_shards
        return plan
