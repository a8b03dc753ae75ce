"""The sharded hash wave engine: one controller over S shards.

The port of the JAX package's ``parallel/engine.py``
(``ShardedTpuBfsChecker``), with the mesh replaced by a list of devices
(see the package docstring). Shard ``s`` owns the keys whose low 32 bits
are ``s`` mod S: its own open-addressing table (ops/hashset.py) with the
parent key of each slot, and the frontier rows it discovered.

One wave:

1. each shard evaluates its frontier block and runs the dense expansion
   (checkers/tpu.py ``dense_candidates``), giving its valid successors in
   (frontier row, ascending slot) order, and folds their keys;
2. discoveries fold across shards: the lowest hitting shard wins, then
   its first hitting row;
3. each shard routes its candidates by owner (parallel/exchange.py) with
   the successor state, the parent's eventually-bits, the key and, with
   paths, the parent's key, and the exchange delivers each owner its
   rows in source order (JAX's per-destination cumsum scatter keeps the
   same order);
4. each owner inserts what it received into its table — one call of
   ``ops.hashset.insert``, the CUDA insert on the card, so S calls a
   wave: duplicates resolve inside it, the highest received row of a new
   key winning — writes each winner's parent key at its slot, and keeps
   the winners, in received order, as its next frontier block.

Capacities are per shard (the table's slot count, the frontier and
candidate bounds); crossing one on any shard raises, naming the shard.
With paths off the discovery fingerprints are JAX's; a path is walked
one lookup at a time in the table of the shard that owns the step's key.
"""

from __future__ import annotations

import time
import warnings
from typing import Optional

import numpy as np
import torch

from .. import checkpoint, faultinject
from ..checkers.tpu import (
    DENSE_CHUNK_BYTES,
    REPORT_EVERY_WAVES,
    TpuBfsChecker,
    dense_candidates,
    frontier_props_t,
    host_read,
    wave_hits,
)
from ..ops.fingerprint import fingerprint_u32v_t, fp_to_key, key_to_fp, pack_keys
from ..occupancy import occupancy_warning
from ..ops.hashset import EMPTY, DeviceHashSet, insert
from ..report import ReportData
from .exchange import (
    exchange,
    host_rows,
    owner_of,
    resolve_devices,
    route,
    routed_off_shard,
)
from .shards import ShardedEngine, fold_discoveries, shard_row


class ShardedTpuBfsChecker(ShardedEngine, TpuBfsChecker):
    """``CheckerBuilder.spawn_sharded_hash()`` — the hash wave engine over
    S shards, shard ``s`` on ``devices[s]``. ``devices`` and
    ``n_shards`` as the sharded sort-merge engine's; ``capacity`` (each
    table's slot count, a power of two), ``frontier_capacity`` and
    ``cand_capacity`` are per shard. The other options are the
    single-device engine's (checkers/tpu.py)."""

    _engine_name = "spawn_sharded_hash"

    def __init__(self, builder, encoded=None, n_shards: Optional[int] = None,
                 devices=None, capacity: int = 1 << 16,
                 frontier_capacity: Optional[int] = None,
                 track_paths: bool = True, *,
                 cand_capacity: Optional[int] = None,
                 probe_rounds: int = 16, checkpoint_every=None,
                 checkpoint_path: Optional[str] = None,
                 waves_per_sync: int = 1):
        devs = resolve_devices(n_shards, devices)
        super().__init__(builder, encoded, capacity, frontier_capacity,
                         track_paths, devs[0], cand_capacity=cand_capacity,
                         probe_rounds=probe_rounds,
                         checkpoint_every=checkpoint_every,
                         checkpoint_path=checkpoint_path,
                         waves_per_sync=waves_per_sync)
        self._set_devices(devs)

    def _visited_bytes_per_row(self) -> int:
        return (8 + (8 if self.track_paths else 0)
                + (8 if self.devices[0].type == "cuda" else 0))

    def _mesh_start(self) -> list:
        """One ``dict(table, parents, frontier, ebits)`` a shard, and the
        run's ``(unique, generated, depth, waves)``: a staged snapshot
        rebuilt (each table through ``DeviceHashSet.from_keys``, which
        keeps the insert kernel's tag rule), or the init states inserted,
        each on the shard that owns it (JAX ``seed_local``)."""
        resume, self._resume = self._resume, None
        if resume is not None:
            t0 = time.monotonic()
            staged = resume[1]
            shards = []
            for sh, dev in zip(staged["shards"], self.devices):
                parents = torch.full((0,), EMPTY, dtype=torch.int64,
                                     device=dev)
                if self.track_paths:
                    parents = torch.from_numpy(sh["parents"]).to(dev)
                shards.append(dict(
                    table=DeviceHashSet.from_keys(
                        torch.from_numpy(sh["keys"]).to(dev)),
                    parents=parents,
                    frontier=torch.from_numpy(sh["frontier"]).to(dev),
                    ebits=torch.from_numpy(sh["ebits"]).to(dev)))
            self._discovered_fps.update(staged["discovered"])
            for dev in set(self.devices):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            self._ckpt_stats["resume_upload_sec"] = round(
                time.monotonic() - t0, 6)
            return shards, (staged["unique"], staged["generated"],
                            staged["depth"], staged["waves"])
        init = self._init_rows()
        n0 = init.shape[0]
        front = torch.from_numpy(init.astype(np.int64).T.copy())
        keys = pack_keys(*fingerprint_u32v_t(front))
        owner = owner_of(keys, self.n_shards)
        shards = []
        for s, dev in enumerate(self.devices):
            mine = owner == s
            table = DeviceHashSet.empty(self.capacity, dev)
            _, _, over, _ = insert(table, keys[mine].to(dev), None,
                                   self.probe_rounds)
            if host_read(over.any()):
                raise RuntimeError(self._overflow_message("visited",
                                                          shard=s))
            shards.append(dict(
                table=table,
                parents=torch.full(
                    (self.capacity if self.track_paths else 0,), EMPTY,
                    dtype=torch.int64, device=dev),
                frontier=front[:, mine].to(dev),
                ebits=torch.full((int(mine.sum()),),
                                 self._eventually_bits_init(),
                                 dtype=torch.int64, device=dev)))
        return shards, (n0, n0, 1, 0)

    def _run_attempt(self, reporter=None) -> None:
        self._check_device()
        if self.builder._visitor is not None:
            raise ValueError(
                "visitors require a host checker (spawn_bfs/spawn_dfs); "
                "the wave engine keeps full states on the device only")
        if not hasattr(self.encoded, "step_cols"):
            raise ValueError(
                "the hash engine needs step_cols, which "
                f"{type(self.encoded).__name__} does not have")
        token = self._begin_attempt()
        enc = self.encoded
        props = list(self.model.properties())
        P = len(props)
        evt_idx = self._eventually_indices(props)
        S, W = self.n_shards, enc.width
        shards, (unique, generated, depth, waves) = self._traced_start(
            self._mesh_start)
        for s, sh in enumerate(shards):
            if sh["frontier"].shape[1] > self.frontier_capacity:
                raise RuntimeError(self._overflow_message("frontier",
                                                          shard=s))
        self._unique_states, self._total_states = unique, generated
        self._max_depth = depth
        fps = dict(self._discovered_fps)
        # each table's occupied slots, kept on the host from here
        used = [int(sh["table"].occupied().sum()) for sh in shards]
        chunk_rows = max(1, DENSE_CHUNK_BYTES
                         // (8 * enc.width * enc.max_actions))
        trivial = enc.trivial_boundary
        target_states = self.builder._target_state_count
        target_depth = self.builder._target_max_depth
        paths = self.track_paths
        stats = dict(max_cand=0, insert_shape=(0, 0, 0), routed=0)
        warned = False
        done = all(sh["frontier"].shape[1] == 0 for sh in shards)

        def wave(w: int) -> bool:
            nonlocal unique, generated, depth, waves
            expand = target_depth is None or depth < target_depth
            routed, rows_out, n_cands, truncs = [], [], [], []
            n_front = [sh["frontier"].shape[1] for sh in shards]
            for s, sh in enumerate(shards):
                front = sh["frontier"]
                cond, eb, f_lo, f_hi = frontier_props_t(
                    enc, props, evt_idx, front, sh["ebits"])
                n = front.shape[1]
                if expand and n:
                    succ_t, rows, has_succ, trunc, _ = dense_candidates(
                        enc, front, trivial, chunk_rows)
                    truncs.append(trunc)
                else:
                    # the wave at the target depth evaluates its frontier
                    # and expands nothing; its rows are not terminal
                    succ_t = front[:, :0]
                    rows = torch.zeros(0, dtype=torch.int64,
                                       device=front.device)
                    has_succ = torch.ones_like(eb, dtype=torch.bool)
                n_cands.append(rows.numel())
                keys = pack_keys(*fingerprint_u32v_t(succ_t))
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
                # the encoding-bound flag rides the same transfer
                trunc = truncs[-1] if expand and n else None
                row.append((cnt.new_zeros(1) if trunc is None
                            else trunc.to(torch.int64).reshape(1)))
                rows_out.append(torch.cat(row))
            faultinject.fire("mid_chunk", w, shards=self._fault_shards())
            if self._abandoned(token):
                raise RuntimeError("wave abandoned by the watchdog")
            host = host_rows(rows_out)
            counts = [r[:S] for r in host]
            if P:
                fold_discoveries(props, [r[S:S + 3 * P] for r in host], fps)
            tripped = any(r[-1] for r in host)
            faultinject.fire("collective_seam", w, shards=self._fault_shards())
            received = exchange(routed, counts, self.devices)
            del routed
            ins, flags = [], []
            for d, sh in enumerate(shards):
                recv = received[d]
                # the kernel takes contiguous keys
                _, is_new, over, slot = insert(
                    sh["table"], recv[W + 1].contiguous(), None,
                    self.probe_rounds)
                ins.append((is_new, slot))
                flags.append(torch.stack([over.any().to(torch.int64),
                                          is_new.sum()]))
            flags = host_rows(flags)
            # the JAX engine's order of verdicts, each naming its shard
            for d, (over, _) in enumerate(flags):
                if over:
                    raise RuntimeError(self._overflow_message(
                        "visited", fps, shard=d))
            for d, (_, new) in enumerate(flags):
                if new > self.frontier_capacity:
                    raise RuntimeError(self._overflow_message(
                        "frontier", fps, shard=d))
            if self.cand_capacity is not None:
                for s, n_cand in enumerate(n_cands):
                    if n_cand > self.cand_capacity:
                        raise RuntimeError(self._overflow_message(
                            "candidates", fps, shard=s))
            if tripped:
                raise RuntimeError(self._overflow_message("encoding", fps))
            new_total = 0
            for d, sh in enumerate(shards):
                is_new, slot = ins[d]
                recv = received[d]
                new = flags[d][1]
                new_total += new
                idx = is_new.nonzero().squeeze(1)  # winners, received order
                if paths and new:
                    sh["parents"][slot[idx]] = recv[W + 2, idx]
                sh["frontier"] = recv[:W, idx]
                sh["ebits"] = recv[W, idx]
                if recv.shape[1] > stats["insert_shape"][1]:
                    stats["insert_shape"] = (used[d], recv.shape[1], new)
                used[d] += new
            if self._tracer is not None:
                # dense waves: the enabled pairs are the candidates
                peak = max(stats["max_cand"], max(n_cands))
                srows = [shard_row(n_front[d], n_cands[d], n_cands[d],
                                   counts[d], d, received[d].shape[1],
                                   flags[d][1], used[d], peak)
                         for d in range(S)]
                row = [sum(n_front), sum(n_cands), sum(n_cands), new_total,
                       unique + new_total, depth, None, None]
                self._trace_row = (waves, row, srows)
            stats["routed"] += routed_off_shard(counts)
            stats["max_cand"] = max(stats["max_cand"], max(n_cands))
            generated += sum(n_cands)
            unique += new_total
            waves += 1
            all_disc = bool(props) and len(fps) == len(props)
            target_hit = target_states is not None and unique >= target_states
            finished = new_total == 0 or all_disc or target_hit
            if not finished:
                depth += 1
            return finished

        def buffers():
            return checkpoint.mesh_hash_buffers(
                self, shards, depth=depth, waves=waves, generated=generated,
                unique=unique), None

        w = 0
        while not done:
            t0 = time.monotonic()
            try:
                done = self._guarded_wave(lambda: wave(w), w)
            finally:
                self._publish(token, fps, unique, generated, depth)
            self._wave_done(w, t0, done, buffers)
            w += 1
            if not done and not warned:  # the fullest table's
                msg = occupancy_warning(
                    max(used) / self.capacity, used=max(used),
                    capacity=self.capacity,
                    bytes_per_row=self._visited_bytes_per_row())
                if msg is not None:
                    warnings.warn(msg, RuntimeWarning, stacklevel=4)
                    warned = True
            if (reporter is not None and not done
                    and waves % REPORT_EVERY_WAVES == 0):
                reporter.report_checking(ReportData(
                    total_states=generated, unique_states=unique,
                    max_depth=depth, duration_sec=self.duration_sec(),
                    done=False))
        self._final = shards
        resident = {}
        for s, sh in enumerate(shards):
            t = sh["table"]
            resident.update({
                f"table[{s}]": t.keys if t.entries is None else t.entries,
                f"parents[{s}]": sh["parents"],
                f"frontier[{s}]": sh["frontier"],
                f"ebits[{s}]": sh["ebits"]})
        m = stats["max_cand"]
        staging = dict(candidates=((W, m), np.int64),
                       routed=((W + (3 if paths else 2), m), np.int64))
        self.memory_plan = self._memory_plan_of(resident, staging)
        self.memory_plan["n_shards"] = S
        self.metrics = dict(
            waves=waves, n_shards=S,
            frontier_size=sum(sh["frontier"].shape[1] for sh in shards),
            occupancy=max(used) / self.capacity,
            dedup_ratio=1.0 - unique / generated if generated else 0.0,
            max_wave_candidates=stats["max_cand"],
            insert_shape=stats["insert_shape"],
            shuffle_volume=stats["routed"], shard_unique=used,
            devices=[str(d) for d in self.devices],
            **self._ckpt_metrics())
        if paths:
            self._plog = []
            for sh in shards:
                t = sh["table"]
                logged = t.occupied() & (sh["parents"] != EMPTY)
                self._plog.append((t.keys[logged], sh["parents"][logged]))
            for name, fp in self._discovered_fps.items():
                self._discoveries[name] = self._reconstruct(fp)

    def _parent_of(self, fp: int) -> Optional[int]:
        """One lookup in the table of the shard that owns ``fp``."""
        key = fp_to_key(fp)
        children, parents = self._plog[(key & 0xFFFFFFFF) % self.n_shards]
        hit = (children == key).nonzero()
        if hit.numel() == 0:
            return None
        return key_to_fp(int(parents[hit[0, 0]]))
