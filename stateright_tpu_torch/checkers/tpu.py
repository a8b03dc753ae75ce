"""The hash wave engine, and what every wave engine of the port shares.

The port of the JAX package's ``checkers/tpu.py``: the dense step's flag
normalization and expansion, frontier property evaluation, per-wave
discovery recording, counterexample path reconstruction, and
:class:`TpuBfsChecker` — ``CheckerBuilder.spawn_hash()``, the JAX
``spawn_tpu``: the reference's ``spawn_bfs`` as device waves over an
open-addressing visited table (ops/hashset.py). The sort-merge engine
(checkers/tpu_sortmerge.py) and the device simulation
(checkers/tpu_simulation.py) subclass it and replace its ``_run``.

One wave of the hash engine, on the ``[W, n]`` lane-major frontier:

1. frontier fingerprints, property bits and discoveries
   (:func:`frontier_props_t`, :func:`wave_hits`);
2. the dense expansion (:func:`dense_candidates`): every valid,
   in-boundary successor in (frontier row, ascending slot) order — the
   order the JAX ``expand_frontier`` flattens into — with its source
   row, in row chunks under a byte budget;
3. the fold of the candidates and ONE insert into the table
   (``ops.hashset.insert``, the CUDA ``hash_insert`` kernel on the
   card): duplicates within the wave resolve inside it, the highest row
   of a new key winning, so there is no sort;
4. each winner's parent key written at its table slot (paths on), and
   the winners, in row order, as the next frontier with their parents'
   eventually-bits.

With ``waves_per_sync`` N > 1 the waves run in chunks of up to N
between two host syncs (checkers/chunk.py): each wave of a chunk works
on capacity-class buffers with its counts on the device, the insert
takes its key count from device memory (``ops.hashset.insert_dev``),
the winners are compacted by a rank scatter, and the chunk ends with
one read of its packed stats; on the card its waves replay as CUDA
graphs. At ``waves_per_sync=1``, the default (JAX's is 64; on the
card the chunk is still slower than one wave a sync, PERF.md), and for
the fused batch (batch.py), each wave is one sync over an exact
``[W, n]`` block. The counts do not
depend on N. What the JAX buffers guaranteed stays: crossing the table,
frontier or candidate capacity RAISES, with the JAX engine's messages.
"""

from __future__ import annotations

import os
import threading
import time
import warnings
from typing import Optional

import numpy as np
import torch

from .. import checkpoint, faultinject, telemetry
from ..checker import Checker, CheckerBuilder
from ..model import Expectation
from ..occupancy import occupancy_warning
from ..ops.canonical import canonicalize_t
from ..ops.fingerprint import (
    clamp_keys,
    fingerprint_u32v_t,
    fp_to_key,
    key_to_fp,
    pack_keys,
)
from ..ops.hashset import EMPTY, DeviceHashSet, insert, insert_dev
from ..ops.merge import dump_size, dump_slots, rank_compact
from ..path import Path
from ..report import ReportData
from . import chunk
from .chunk import (
    FLOOR_F,
    FLOOR_P,
    GROW_F,
    GROW_P,
    OVER_CAND,
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

#: waves between two progress reports (the JAX engine's chunk length)
REPORT_EVERY_WAVES = 64

#: bytes of the ``[W, rows*K]`` int64 successor block one dense chunk
#: may hold (its step's temporaries come on top): a dense step issues
#: its torch ops once a chunk, whatever the chunk's rows, so fewer and
#: larger chunks cost less host time
DENSE_CHUNK_BYTES = 1 << 32


class HostReads:
    """The wave loops' blocking device-to-host reads, counted and timed.

    Every read a wave makes of a device value (``.tolist()``, a count,
    a flag, a download of keys) goes through :func:`host_read`, so the
    sum of their walls is the time the host spent blocked on the device
    in that wave: a traced chunk's ``fetch_sec`` (telemetry.py), the
    rest of the wave its ``dispatch_sec``. Other implicit syncs (a
    ``nonzero`` on the card sizes its output) count as dispatch.

    ``calls``, ``sec`` and ``device_sec`` count every thread's reads.
    A wave's own walls come from its thread's :class:`ReadTally`
    (:meth:`local`), which a watchdog's worker thread shares with the
    wave loop that started it (:meth:`bind`), so runs on concurrent
    threads (a batch group's leader beside a solo seat, batch.py) never
    count each other's reads.

    A tally's ``sync_before`` is the deep trace level's one extra sync:
    set by the wave loop before a wave, it makes the wave's first read
    call ``torch.cuda.synchronize`` on those devices first and add the
    wait to ``device_sec``. Tracing at the default level makes no read
    of its own: ``calls`` is the same with a tracer and without."""

    def __init__(self):
        self.calls = 0
        self.sec = 0.0
        self.device_sec = 0.0
        self._tls = threading.local()

    def local(self) -> "ReadTally":
        """This thread's tally (made on first use)."""
        tally = getattr(self._tls, "tally", None)
        if tally is None:
            tally = self._tls.tally = ReadTally()
        return tally

    def bind(self, tally: "ReadTally") -> None:
        """Make ``tally`` this thread's."""
        self._tls.tally = tally


class ReadTally:
    """One thread's reads: their wall, the deep level's device wait, and
    the devices to sync before the next read (None: no sync)."""

    def __init__(self):
        self.sec = 0.0
        self.device_sec = 0.0
        self.sync_before = None


#: the one counter of the process's wave-loop reads
READS = HostReads()


def host_read(x, numpy: bool = False):
    """``x.tolist()`` (a Python scalar for a 0-d tensor), or with
    ``numpy`` the host copy ``x.cpu().numpy()``: one blocking read,
    counted and timed in :data:`READS` and in this thread's tally."""
    tally = READS.local()
    devs, tally.sync_before = tally.sync_before, None
    if devs:
        t0 = time.monotonic()
        for dev in devs:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        wait = time.monotonic() - t0
        READS.device_sec += wait
        tally.device_sec += wait
    t0 = time.monotonic()
    out = x.cpu().numpy() if numpy else x.tolist()
    dt = time.monotonic() - t0
    READS.sec += dt
    tally.sec += dt
    READS.calls += 1
    return out


def step_with_trunc(enc, states_t):
    """``enc.step_cols`` over a ``[W, n]`` block, with the optional
    truncation flag (see encoding.DenseEncodedModel) normalized to a
    per-row bool: ``(succ [W, n, K], valid bool[n, K], trunc bool[n])``."""
    succ, valid, trunc = enc.step_cols(states_t)
    if trunc is None:
        trunc = torch.zeros(states_t.shape[1], dtype=torch.bool,
                            device=states_t.device)
    return succ, valid, trunc


def _props_and_ebits(cond, ebits, evt_idx):
    """Clear satisfied eventually-bits (checker.rs:559-566)."""
    for i in evt_idx:
        ebits = torch.where(cond[:, i], ebits & ~(1 << i), ebits)
    return ebits


def frontier_props_t(enc, props, evt_idx, frontier_t, ebits,
                     sym_spec=None):
    """The step-free half of a wave over the ``[W, n]`` frontier:
    frontier fingerprints, the property bitmap, and eventually-bit
    clearing. Returns ``(cond[n, P], ebits[n], f_lo[n], f_hi[n])``.

    With ``sym_spec`` (device symmetry) the fingerprints are CANONICAL,
    so the parent keys they seed match the canonical child keys the
    dedup writes, and discovery fingerprints are canonical fingerprints;
    properties still evaluate on the concrete frontier."""
    n = frontier_t.shape[1]
    fp_src = (frontier_t if sym_spec is None
              else canonicalize_t(sym_spec, frontier_t))
    f_lo, f_hi = fingerprint_u32v_t(fp_src)
    if props:
        cond = enc.property_conditions_cols(frontier_t)
    else:
        cond = torch.zeros((n, 0), dtype=torch.bool,
                           device=frontier_t.device)
    return cond, _props_and_ebits(cond, ebits, evt_idx), f_lo, f_hi


def wave_hits(props, cond, evt_cex, ebits, f_lo, f_hi, live=None):
    """This wave's per-property verdicts over the frontier: ``(hit[P],
    lo[P], hi[P])`` device tensors, the fingerprint of the FIRST hitting
    row in frontier order (the JAX engines' ``argmax``). ``live``
    (``bool[n]``, or None: every row) masks a fixed-capacity frontier's
    padding rows."""
    masks = []
    for i, p in enumerate(props):
        if p.expectation == Expectation.ALWAYS:
            masks.append(~cond[:, i])
        elif p.expectation == Expectation.SOMETIMES:
            masks.append(cond[:, i])
        else:
            masks.append(evt_cex & ((ebits & (1 << i)) != 0))
    mask = torch.stack(masks)
    if live is not None:
        mask = mask & live
    mask = mask.to(torch.uint8)
    row = torch.argmax(mask, dim=1)
    return mask.any(dim=1), f_lo[row], f_hi[row]


def discovery_update(props, hits, los, his, found: dict) -> None:
    """Fold this wave's verdicts into ``found`` (property name ->
    fingerprint), keeping the first (shallowest) hit — bfs.rs discovery
    recording. One host transfer per wave."""
    packed = host_read(torch.stack([hits.to(torch.int64), los, his]))
    for i, p in enumerate(props):
        if packed[0][i] and p.name not in found:
            found[p.name] = (packed[2][i] << 32) | packed[1][i]


def fold_discoveries(disc, hits, los, his, commit):
    """The device half of :func:`discovery_update` (JAX's carry update):
    ``disc`` (``int64[3, P]``: found, lo, hi) with this wave's first
    hits of properties not found yet, where ``commit``; a new tensor."""
    fresh = hits.to(torch.bool) & (disc[0] == 0) & commit
    return torch.stack([disc[0] | fresh.to(torch.int64),
                        torch.where(fresh, los, disc[1]),
                        torch.where(fresh, his, disc[2])])


def rows_with(per_row, ok):
    """``bool[F]``: whether each frontier row has an ``ok`` pair, for a
    pair block in row order where row ``r`` holds ``per_row[r]`` pairs
    (the block may hold fewer than their sum: it kept its first rows).
    Two gathers of the pairs' running ``ok`` count at each row's ends —
    a scatter of the rows would pile every padding pair onto one row."""
    okc = torch.cat([ok.new_zeros(1, dtype=torch.int64),
                     torch.cumsum(ok.to(torch.int64), 0)])
    end = torch.cumsum(per_row, 0)
    top = okc.numel() - 1
    return (okc[end.clamp(max=top)] - okc[(end - per_row).clamp(max=top)]
            ) > 0


def dense_pairs_fixed(enc, frontier_t, live_rows, chunk_rows: int,
                      cap: int, rows_bound: Optional[int] = None):
    """The dense expansion of a fixed-capacity ``[W, F]`` frontier into a
    ``cap``-column block, with no host read: ``(succ [W, cap], rows
    int64[cap], pairs, trunc, per_row)`` — the valid successors of the
    ``live_rows`` (``bool[F]``) in (row, ascending slot) order, their
    source rows, their count (0-d; more than ``cap`` means the block
    kept only the first ``cap``), whether a live row was truncated
    (0-d bool), and each row's count of them. Columns past the count
    hold column 0 of the frontier (a valid state) and row 0. Each
    ``chunk_rows`` row chunk is compacted before the next is stepped.
    ``rows_bound`` (a host count no live row lies past, or None: all
    ``F``) skips the row chunks past it: the CPU's eager waves know it,
    a graph replayed at other counts steps every chunk."""
    W, F = frontier_t.shape
    dev = frontier_t.device
    K = enc.max_actions
    spare = dump_size(dev)
    succ_c = frontier_t[:, :1].expand(W, cap + spare).clone()
    rows_c = torch.zeros(cap + spare, dtype=torch.int64, device=dev)
    off = torch.zeros((), dtype=torch.int64, device=dev)
    trunc_any = torch.zeros((), dtype=torch.bool, device=dev)
    per_row = []
    F_live = F
    if rows_bound is not None:  # whole row chunks, so the blocks add up
        F_live = min(F, -(-max(int(rows_bound), 1) // chunk_rows)
                     * chunk_rows)
    for r0 in range(0, F_live, chunk_rows):
        block = frontier_t[:, r0:r0 + chunk_rows]
        m = block.shape[1]
        succ, valid, trunc = step_with_trunc(enc, block)
        live = live_rows[r0:r0 + m]
        valid = valid & live.unsqueeze(1)
        trunc_any = trunc_any | (trunc & live).any()
        per_row.append(valid.sum(dim=1))
        flat = valid.reshape(-1)
        rank = torch.cumsum(flat.to(torch.int64), 0) - 1 + off
        dest = torch.where(flat & (rank < cap), rank,
                           dump_slots(cap, flat.numel(), dev))
        succ_c[:, dest] = succ.reshape(W, m * K)
        rows_c[dest] = torch.arange(m * K, dtype=torch.int64,
                                    device=dev) // K + r0
        off = off + flat.sum()
    if F_live < F:  # the rows never stepped have no pairs
        per_row.append(torch.zeros(F - F_live, dtype=torch.int64,
                                   device=dev))
    return (succ_c[:, :cap], rows_c[:cap], off, trunc_any,
            torch.cat(per_row))


def dense_candidates(enc, frontier_t, trivial_boundary: bool,
                     chunk_rows: int):
    """The dense expansion of a non-empty ``[W, n]`` frontier,
    ``chunk_rows`` rows at a time: ``(succ_t [W, P], rows int64[P],
    has_succ bool[n], trunc, chunks)`` — the valid, in-boundary
    successors in (row, ascending slot) order with their source rows,
    which rows have one, the encoding-bound flag (a ``bool`` tensor: any
    row's ``trunc``, whatever the boundary says, as in the JAX
    ``expand_frontier``) and the number of chunks stepped. Each chunk is
    compacted before the next is stepped, so only one ``[W,
    chunk_rows*K]`` block lives at a time."""
    n = frontier_t.shape[1]
    dev = frontier_t.device
    succs, rows, has, truncs = [], [], [], []
    for r0 in range(0, n, chunk_rows):
        block = frontier_t[:, r0:r0 + chunk_rows]
        m = block.shape[1]
        succ, valid, trunc = step_with_trunc(enc, block)
        row, slot = valid.nonzero(as_tuple=True)  # (row, slot) order
        cols = succ[:, row, slot]
        del succ, valid
        if not trivial_boundary:
            inb = enc.within_boundary_cols(cols)
            row, cols = row[inb], cols[:, inb]
        h = torch.zeros(m, dtype=torch.bool, device=dev)
        h[row] = True
        succs.append(cols)
        rows.append(row + r0)
        has.append(h)
        truncs.append(trunc.any())
    if len(succs) == 1:
        return succs[0], rows[0], has[0], truncs[0], 1
    return (torch.cat(succs, dim=1), torch.cat(rows), torch.cat(has),
            torch.stack(truncs).any(), len(succs))


class HashCarry(ChunkCarry):
    """The chunked hash wave's device state (checkers/chunk.py): the
    frontier ``fr [2, W, Pc]`` and its eventually-bits ``eb [2, Pc]`` as
    ping-pong halves, of which a wave steps the first ``Fc`` columns;
    the table and the parent array are updated in place. Columns past
    the live ``nf`` hold copies of column 0."""

    def __init__(self, device, n_props: int, n_waves: int, log: bool,
                 W: int, Fc: int, Pc: int):
        from ..telemetry import WAVE_LOG_LANES

        super().__init__(device, n_props, n_waves, WAVE_LOG_LANES, False)
        self.Fc, self.Pc = Fc, Pc
        self.fr = torch.empty((2, W, Pc), dtype=torch.int64, device=device)
        self.eb = torch.empty((2, Pc), dtype=torch.int64, device=device)
        self.ar_f = torch.arange(Fc, dtype=torch.int64, device=device)
        self.ar_p = torch.arange(Pc, dtype=torch.int64, device=device)

    @property
    def key(self) -> tuple:
        return (self.Fc, self.Pc)

    def load(self, front, ebits, nf: int) -> None:
        if nf:
            self.fr[0, :, :nf] = front
            self.fr[0, :, nf:] = front[:, :1]
            self.eb[0, :nf] = ebits
            self.eb[0, nf:] = ebits[:1]
        else:
            self.fr[0].zero_()
            self.eb[0].zero_()
        self.parity = 0
        self.nf_host = nf

    def view(self, h: dict) -> tuple:
        """``(frontier, ebits)``: views of the live half at ``h["nf"]``."""
        p, nf = self.parity, h["nf"]
        return self.fr[p, :, :nf], self.eb[p, :nf]


class TpuBfsChecker(Checker):
    """``CheckerBuilder.spawn_hash()`` — the hash wave engine (the JAX
    ``spawn_tpu``), and the result surface every wave engine of the
    port inherits: encoding resolution, discovery accessors, and path
    reconstruction from the device parent log.

    ``capacity`` is the visited table's slot count (a power of two);
    ``frontier_capacity`` (default ``capacity``) bounds the states one
    wave may add and ``cand_capacity`` (default: no bound) the valid
    successors one wave may generate; ``probe_rounds`` is the probe
    depth past which a key overflows the table. Crossing any of them
    raises. ``device`` defaults to the CUDA device; pass ``"cpu"`` for
    the plain-PyTorch path. ``waves_per_sync`` (default 1; the
    JAX engine's is 64) is the chunk: the waves run between two host
    syncs (checkers/chunk.py); 1 syncs every wave. The counts do not depend on
    it. The expansion is dense (``step_cols``), as the JAX engine's is,
    and the engine honours neither symmetry nor a visitor.
    """

    #: the name refusals give the spawn
    _engine_name = "spawn_hash"
    #: whether this engine runs chunks of ``waves_per_sync`` waves
    #: (checkers/chunk.py); the sharded engines, the fused batch and the
    #: device simulation run one wave a chunk
    _chunks_waves = True
    #: whether visited keys are clamped off the all-ones sentinel (the
    #: sort-merge engine's sorted arrays pad with it; the table does not)
    _clamps_keys = False

    def __init__(self, builder: CheckerBuilder, encoded=None,
                 capacity: int = 1 << 16,
                 frontier_capacity: Optional[int] = None,
                 track_paths: bool = True, device=None, *,
                 cand_capacity: Optional[int] = None,
                 probe_rounds: int = 16, checkpoint_every=None,
                 checkpoint_path: Optional[str] = None,
                 waves_per_sync: int = 1):
        super().__init__(builder)
        if encoded is None:
            to_encoded = getattr(builder.model, "to_encoded", None)
            if to_encoded is None:
                raise ValueError(
                    "the wave engine requires an encoding: pass "
                    "encoded=... or implement Model.to_encoded()"
                )
            encoded = to_encoded()
        self.encoded = encoded
        #: the device every wave runs on: the CUDA device unless the
        #: caller asks for the CPU.
        self.device = torch.device(device if device is not None else "cuda")
        #: waive the reduction gate (``CheckerBuilder.unsound_ok()``)
        self.unsound_ok = builder._unsound_ok
        #: the device symmetry spec when the reduction is on: candidates
        #: canonicalize before the fold, so visited keys are canonical
        #: fingerprints while the frontier keeps concrete states
        self.sym_spec = None
        if builder._symmetry is not None:
            self.sym_spec = self._resolve_symmetry()
        if probe_rounds < 1:
            raise ValueError(f"probe_rounds must be >= 1: {probe_rounds}")
        if cand_capacity is not None and cand_capacity < 1:
            raise ValueError(f"cand_capacity must be >= 1: {cand_capacity}")
        self.capacity = capacity
        #: visited slots over every device (the sharded engines: S
        #: times ``capacity``)
        self.total_capacity = capacity
        self.frontier_capacity = frontier_capacity or capacity
        self.cand_capacity = cand_capacity
        self.probe_rounds = probe_rounds
        if int(waves_per_sync) < 1:
            raise ValueError(f"waves_per_sync must be >= 1: {waves_per_sync}")
        #: waves a chunk runs between two host syncs (JAX's default is
        #: 64); 1, the default, runs the one-wave-a-sync loop
        self.waves_per_sync = int(waves_per_sync)
        self.track_paths = track_paths
        #: per-run wave metrics, set as the run goes
        self.metrics: dict = {}
        #: property name -> fingerprint of the discovery state.
        self._discovered_fps: dict[str, int] = {}
        #: the parent log, (child keys, parent keys) as packed int64
        #: tensors on the run's device, once the run has finished — or,
        #: after a tiered run, int64 numpy arrays in host memory sorted
        #: by child key.
        self._plog = None
        #: the resident-buffer ledger of the last run (memplan.py): see
        #: :meth:`_memory_plan_of`
        self.memory_plan: Optional[dict] = None
        #: a context manager every wave's issue and sync run inside (a
        #: batch group's gate, batch.py; the resident service's FIFO
        #: gate, serve.py), or None
        self.dispatch_gate = None
        #: keep what a finished run ends in as ``_final_carry``, for
        #: ``checkpoint.retain_final_snapshot`` (the service's warm start)
        self.keep_final_carry = False
        self._final_carry = None
        #: set by the resident service: other sessions share the device,
        #: so the device bytes this run's trace reads are the process's
        self.memory_scope = None
        self._init_durability(checkpoint_every, checkpoint_path)

    # -- checkpoints and supervision (checkpoint.py) ------------------------

    def _init_durability(self, checkpoint_every, checkpoint_path) -> None:
        """The JAX engines' checkpoint, supervision and watchdog
        settings (JAX ``checkers/tpu.py``), with their defaults."""
        if checkpoint_every not in (None, "auto") and checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1: {checkpoint_every}")
        #: a snapshot every N waves (``"auto"``: the cadence
        #: ``checkpoint.auto_cadence`` derives from the measured snapshot
        #: and wave walls, every wave until both exist); None: off
        self.checkpoint_every = checkpoint_every
        self.checkpoint_path = checkpoint_path or (
            checkpoint.DEFAULT_PATH if checkpoint_every else None)
        #: the supervisor's retry budget and backoff base
        self.max_fault_retries = 3
        self.retry_backoff_sec = 0.5
        #: let the supervisor drop a shard that keeps failing and re-shard
        #: the last snapshot onto the rest (CLI ``--degrade-on-fault``;
        #: harmless on one device)
        self.degrade_on_fault = False
        #: the watchdog: None (off) or the factor of the rolling maximum
        #: wave wall a wave may take, clamped to [floor, cap]; the grace
        #: covers the first wave (kernel builds)
        self.watchdog_factor = None
        self.watchdog_floor_sec = 2.0
        self.watchdog_cap_sec = 600.0
        self.watchdog_grace_sec = 300.0
        self._wd_roll_max = None
        self._ckpt_auto_every = 1
        #: (manifest, staged state) from :meth:`resume_from`, consumed by
        #: the next attempt
        self._resume = None
        self._resume_path = None
        #: a resumed chunked run's classes (the snapshot's), and the
        #: classes of this chunked run so far, which a snapshot records
        self._resume_classes = None
        self._chunk_classes = None
        self._resume_allow_sha = False
        self._last_snapshot = None
        #: the run started from a caller's state (``start_from``), which
        #: a retry without a snapshot cannot return to
        self._started_from_state = False
        #: the checkpoint and recovery counters that ride ``metrics``
        self._ckpt_stats: dict = {}
        #: the current attempt's token: a wave thread the watchdog
        #: abandoned finds it changed and stops before its sync, and the
        #: host thread publishes nothing of an abandoned attempt
        self._attempt_token = None
        #: the tracer of the current attempt (telemetry.py), or None
        self._tracer = None

    def _run(self, reporter=None) -> None:
        """One run, supervised (checkpoint.supervised_run)."""
        checkpoint.supervised_run(self, reporter)
        self._trace_close()

    def resume_from(self, path: str, allow_sha_mismatch: bool = False
                    ) -> dict:
        """Stage the snapshot at ``path`` for the next run, which
        continues from it (checkpoint.resume_from); returns its manifest.
        Raises the named ``Snapshot*`` errors."""
        return checkpoint.resume_from(self, path,
                                      allow_sha_mismatch=allow_sha_mismatch)

    def _checkpoint_family(self) -> str:
        return "hash"

    def _reset_for_resume(self) -> None:
        """Drop a failed attempt's partial results before a retry;
        discoveries come back from the snapshot's lanes."""
        self._discovered_fps = {}
        self._discoveries.clear()
        self._total_states = self._unique_states = self._max_depth = 0
        self.metrics = {}
        self._plog = None
        self.memory_plan = None
        self._final_carry = None

    def _degrade_memory_lean(self) -> bool:
        """The supervisor's hook after two OOMs: the hash engine has no
        leaner mode (False)."""
        return False

    def _fault_shards(self):
        """The live shard ids a persistent shard fault is filtered
        against: None on one device (the sharded engines override)."""
        return None

    def _can_degrade_shards(self) -> bool:
        """One device has no shard to drop (the sharded engines
        override)."""
        return False

    def _sync_waves(self) -> int:
        """The waves a chunk runs: ``waves_per_sync``, or 1 on an engine
        that runs one wave a chunk."""
        return self.waves_per_sync if self._chunks_waves else 1

    def _ckpt_cadence(self) -> int:
        if self.checkpoint_every == "auto":
            return self._ckpt_auto_every
        return int(self.checkpoint_every)

    def _begin_attempt(self) -> object:
        """A new attempt's token (see ``_attempt_token``); attaches the
        run's tracer and builds the attempt's kernels."""
        self._attempt_token = token = object()
        self._ckpt_stats.setdefault("fault_recoveries", 0)
        self._trace_attach()
        return token

    def _abandoned(self, token) -> bool:
        return self._attempt_token is not token

    def _check_token(self, token) -> None:
        """Raise in a chunk the watchdog gave up on (before its read)."""
        if self._abandoned(token):
            raise RuntimeError("chunk abandoned by the watchdog")

    def _publish(self, token, fps: dict, unique: int, total: int,
                 depth: int) -> None:
        """Write an attempt's discoveries and counters to the checker, on
        the host thread after each wave, unless the watchdog abandoned
        the attempt. A wave writes only its attempt's own locals: a wave
        thread the watchdog gave up on may still finish its sync while
        the retry runs, and nothing it finds may reach the retry."""
        if self._abandoned(token):
            return
        self._discovered_fps.update(fps)
        self._unique_states, self._total_states = unique, total
        self._max_depth = depth

    def _guarded_wave(self, thunk, w: int):
        """Run one wave's issue and sync, inside ``dispatch_gate`` when
        one is installed (JAX ``_guarded_dispatch``): inline, or with
        ``watchdog_factor`` set on a daemon worker thread that the host
        waits on at most the derived deadline, raising
        ``checkpoint.WatchdogTimeout`` past it (the thread is abandoned:
        a CUDA sync cannot be cancelled) after a ``watchdog_timeout``
        event."""
        gate = self.dispatch_gate
        if gate is not None:
            with gate:
                return self._supervised_wave(thunk, w)
        return self._supervised_wave(thunk, w)

    def _supervised_wave(self, thunk, w: int):
        tally = READS.local()
        self._wave_reads0 = (tally, tally.sec, tally.device_sec)
        if self._tracer is not None and self._tracer.level == "deep":
            tally.sync_before = self._trace_devices()
        if not self.watchdog_factor:
            return thunk()
        deadline = checkpoint.watchdog_deadline(
            self._wd_roll_max, self.watchdog_factor,
            floor_sec=self.watchdog_floor_sec, cap_sec=self.watchdog_cap_sec,
            first_grace_sec=self.watchdog_grace_sec)
        box: dict = {}
        done = threading.Event()

        def run():
            READS.bind(tally)  # the wave's reads count as this loop's
            try:
                box["out"] = thunk()
            except BaseException as exc:  # raised on the host side
                box["exc"] = exc
            finally:
                done.set()

        t0 = time.monotonic()
        threading.Thread(target=run, daemon=True,
                         name=f"stpu-torch-watchdog-wave{w}").start()
        if not done.wait(deadline):
            self._attempt_token = None  # the wave thread is abandoned
            att = dict(chunk=int(w), deadline_sec=round(deadline, 3),
                       rolling_max_chunk_sec=self._wd_roll_max,
                       factor=float(self.watchdog_factor),
                       waited_sec=round(time.monotonic() - t0, 3))
            telemetry.emit("watchdog_timeout", **att)
            raise checkpoint.WatchdogTimeout(w, deadline, att)
        if "exc" in box:
            raise box["exc"]
        return box["out"]

    def _wave_done(self, w: int, t0: float, done: bool,
                   buffers_fn, boundary=-1) -> float:
        """After sync ``w`` of this attempt (a wave, or a chunk of
        several), begun at ``t0``: record it in the trace, feed the
        watchdog, write the snapshot when the cadence asks (never on the
        last wave), then fire the ``chunk_boundary`` fault site — JAX's
        order, so a kill there leaves the snapshot committed.
        ``boundary`` is the index of the JAX chunk that ends at this sync
        (-1: ``w``; None: no JAX chunk ends here, a sync a capacity class
        added, so neither the snapshot nor the fault site is due).
        ``buffers_fn()`` gives ``(buffers, tier block)``. Returns the
        sync's end."""
        t1 = time.monotonic()
        wave_sec = t1 - t0
        READS.local().sync_before = None
        if self._tracer is not None:
            self._trace_wave(w, t0, t1)
        if self.watchdog_factor and (self._wd_roll_max is None
                                     or wave_sec > self._wd_roll_max):
            self._wd_roll_max = wave_sec
        if boundary is None:
            return t1
        if boundary == -1:
            boundary = w
        if (self.checkpoint_every and not done
                and (boundary + 1) % self._ckpt_cadence() == 0):
            t0 = time.monotonic()
            buffers, tier_block = buffers_fn()
            capture_sec = time.monotonic() - t0
            manifest = checkpoint.write_snapshot(
                self, buffers, self.checkpoint_path, chunk=boundary,
                tier_block=tier_block)
            snap_sec = time.monotonic() - t0
            stats = self._ckpt_stats
            stats["snapshots"] = stats.get("snapshots", 0) + 1
            stats["snapshot_bytes"] = manifest["snapshot_bytes"]
            stats["snapshot_bytes_total"] = (
                stats.get("snapshot_bytes_total", 0)
                + manifest["snapshot_bytes"])
            # the whole write, and of it the download and limb split
            stats["snapshot_write_sec"] = round(
                stats.get("snapshot_write_sec", 0.0) + snap_sec, 6)
            stats["snapshot_capture_sec"] = round(
                stats.get("snapshot_capture_sec", 0.0) + capture_sec, 6)
            stats["snapshot_write_max_sec"] = round(
                max(stats.get("snapshot_write_max_sec", 0.0), snap_sec), 6)
            if self.checkpoint_every == "auto":
                new = checkpoint.auto_cadence(snap_sec, wave_sec)
                if new != self._ckpt_auto_every:
                    telemetry.emit(
                        "checkpoint_cadence",
                        old=int(self._ckpt_auto_every), new=int(new),
                        snapshot_sec=round(snap_sec, 6),
                        chunk_sec=round(wave_sec, 6))
                self._ckpt_auto_every = new
        faultinject.fire("chunk_boundary", boundary,
                         shards=self._fault_shards())
        return t1

    # -- run telemetry (telemetry.py) ---------------------------------------

    def _kernel_sources(self) -> tuple:
        """The CUDA sources this engine launches (built in the attempt's
        ``compile`` span on the card)."""
        from ..ops import hashset

        return (hashset,)

    def _trace_devices(self) -> tuple:
        return (self.device,)

    def _trace_attach(self) -> None:
        """The top of an attempt: resolve the active tracer (None: every
        hook below is a no-op), reset the attempt's trace state, and
        build the attempt's kernels inside a ``compile`` span. A compiled
        encoding's host compile (actor/compile.py), which ran before the
        run, is recorded as a ``compile`` span of the first run that
        traces it. The deep level forces one wave a chunk, as JAX's
        does, with its ``deep_sync_override`` event (and then adds the
        device sync before each wave's first read)."""
        tracer = telemetry.current_tracer()
        self._tracer = tracer
        if (tracer is not None and tracer.level == "deep"
                and self._chunks_waves and self.waves_per_sync != 1):
            tracer.event("deep_sync_override",
                         waves_per_sync_old=self.waves_per_sync,
                         waves_per_sync=1)
            self.waves_per_sync = 1
        self._trace_row = None
        self._verdicts_seen: set = set()
        self._mem_peak = self._mem_src = None
        self._mem_polls = 0
        if tracer is not None:
            stamp = getattr(self.encoded, "host_compile_span", None)
            if (stamp is not None and getattr(
                    self.encoded, "_compile_traced", None) is not tracer):
                self.encoded._compile_traced = tracer
                tracer.record_span("compile", stamp[0], stamp[1],
                                   stage="actor_compile",
                                   engine=type(self).__name__)
        with telemetry.span("compile", engine=type(self).__name__):
            if any(d.type == "cuda" for d in self._trace_devices()):
                for ops in self._kernel_sources():
                    ops._lib()

    def _traced_start(self, start):
        """``start()``, the attempt's start state, in a ``seed_upload``
        span, or, when a snapshot is staged, in a ``restore_upload`` span
        followed by the ``restore`` event (the wave stream then starts at
        the snapshot's wave)."""
        resume = self._resume
        with telemetry.span("seed_upload" if resume is None
                            else "restore_upload"):
            out = start()
        if resume is not None:
            manifest = resume[0]
            telemetry.emit(
                "restore",
                path=os.path.basename(self._resume_path or "") or None,
                wave=int(manifest["wave"]), depth=int(manifest["depth"]),
                unique=int(manifest["unique"]),
                from_shards=int(manifest.get("n_shards", 1)),
                to_shards=int(getattr(self, "n_shards", 1)))
        return out

    def _trace_wave(self, w: int, t0: float, t1: float) -> None:
        """One chunk: the wall split into the timed host reads
        (``fetch_sec``) and the rest (``dispatch_sec``), the deep level's
        device wait, the wave rows and per-shard rows the chunk left in
        ``_trace_row`` — ``(first wave, row, shard rows)`` of a one-wave
        chunk, or ``(first wave, [rows], None, waves)`` of a chunk of
        several (its row list None on the hash engine, which keeps no
        wave log) — the device bytes in use, the straggler verdicts, and
        a ``verdict`` event for each property first discovered in it."""
        from ..memplan import device_bytes_in_use

        tracer = self._tracer
        fetch, dev = self._wave_read_walls()
        if tracer.level != "deep":
            dev = None
        mem_now, src = device_bytes_in_use(self.device)
        if mem_now is not None:
            self._mem_src = src
            self._mem_polls += 1
            self._mem_peak = (mem_now if self._mem_peak is None
                              else max(self._mem_peak, mem_now))
        wave_no, row, srows = self._trace_row[:3]
        if len(self._trace_row) > 3:  # a chunk of several waves
            n_waves, rows = self._trace_row[3], row
        else:
            n_waves, rows = 1, None if row is None else [row]
        self._trace_row = None
        if srows is not None:
            self._note_shard_health(srows, wave_no)
        tracer.record_chunk(
            chunk=w, wave0=wave_no, t0=t0, t1=t1,
            dispatch_sec=max(t1 - t0 - fetch - (dev or 0.0), 0.0),
            fetch_sec=fetch, device_sec=dev, n_waves=n_waves,
            wave_rows=rows,
            shard_rows=None if srows is None else [[r] for r in srows],
            mem_bytes=mem_now)
        for prop in self.model.properties():
            if (prop.name in self._discovered_fps
                    and prop.name not in self._verdicts_seen):
                self._verdicts_seen.add(prop.name)
                tracer.event("verdict", property=prop.name,
                             expectation=prop.expectation.name.lower(),
                             kind="discovery", wave=wave_no + n_waves,
                             depth=self._max_depth, chunk=w)

    def _wave_read_walls(self) -> tuple:
        """``(read wall, device wait)`` of the current wave so far, from
        the tally it started with."""
        tally, r0, d0 = self._wave_reads0
        return tally.sec - r0, tally.device_sec - d0

    def _note_shard_health(self, srows, wave_no: int) -> None:
        """The straggler detector (the sharded engines override)."""

    def _sustained_stragglers(self) -> tuple:
        """The shards held as sustained stragglers, the supervisor's
        evidence for ``checkpoint.classify_failure``: none on one device
        (the sharded engines override)."""
        return ()

    def _memory_headroom(self) -> dict:
        """The watermark's visited accounting: rows against capacity,
        priced per row, and the cold tier of a tiered run."""
        bpr = self._visited_bytes_per_row()
        cap = getattr(self, "total_capacity", self.capacity)
        u = self._unique_states
        return dict(visited_rows=int(u), visited_capacity=int(cap),
                    occupancy=(round(u / cap, 4) if cap else None),
                    bytes_per_row=bpr, visited_used_bytes=int(u * bpr),
                    visited_capacity_bytes=int(cap * bpr), budget=None,
                    tier=self._tier_headroom())

    def _tier_headroom(self) -> Optional[dict]:
        """The cold tier's rows and bytes, None when the run never
        spilled."""
        m = self.metrics
        if not isinstance(m, dict) or "tier_spills" not in m:
            return None
        return dict(spills=m["tier_spills"], cold_rows_total=m["cold_rows"],
                    cold_bytes_total=m["cold_bytes"],
                    hot_rows=m.get("hot_rows"))

    def _trace_close(self) -> None:
        """The end of a traced run: the ``memory_plan`` event (the port
        fills its plan at the end of the run, where JAX declares it
        before the first wave) and the ``memory_watermark``. A
        cancelled run (the hybrid racer's loser) emits neither."""
        tracer = getattr(self, "_tracer", None)
        if tracer is None or getattr(self, "cancelled", False):
            return
        # a run that started settled (a warm start from a finished run's
        # snapshot) ran no wave to report its discoveries at
        for prop in self.model.properties():
            if (prop.name in self._discovered_fps
                    and prop.name not in self._verdicts_seen):
                self._verdicts_seen.add(prop.name)
                tracer.event("verdict", property=prop.name,
                             expectation=prop.expectation.name.lower(),
                             kind="discovery",
                             wave=int(self.metrics.get("waves") or 0),
                             depth=self._max_depth)
        if self.memory_plan is not None:
            tracer.event("memory_plan", **self.memory_plan)
        tier = self._tier_headroom()
        tracer.event(
            "memory_watermark", source=self._mem_src,
            device_peak_bytes=(None if self._mem_peak is None
                               else int(self._mem_peak)),
            polls=int(self._mem_polls),
            cold_tier_bytes=None if tier is None else tier["cold_bytes_total"],
            headroom=self._memory_headroom(),
            projection=self._memory_projection(),
            **({} if self.memory_scope is None
               else dict(scope=self.memory_scope)))

    def _lane_config(self) -> dict:
        lane = super()._lane_config()
        lane.update(encoding=type(self.encoded).__name__,
                    width=self.encoded.width,
                    max_actions=self.encoded.max_actions,
                    capacity=self.capacity,
                    frontier_capacity=self.frontier_capacity,
                    cand_capacity=self.cand_capacity,
                    waves_per_sync=self._sync_waves(),
                    track_paths=self.track_paths,
                    device=str(self.device),
                    merge_impl=("cuda" if self.device.type == "cuda"
                                else "plain"),
                    visited_row_bytes=self._visited_bytes_per_row())
        return lane

    def _ckpt_metrics(self) -> dict:
        """The checkpoint counters for ``metrics``: none on a run that
        neither checkpointed, resumed nor recovered."""
        stats = dict(self._ckpt_stats)
        if not (self.checkpoint_every or self._resume_path
                or stats.get("fault_recoveries")):
            return {}
        if self.checkpoint_every:
            stats["checkpoint_every"] = self._ckpt_cadence()
        return stats

    def _resolve_symmetry(self):
        """The hash engine keys its table on raw-state fingerprints with
        no canonicalization pass (the JAX engine's
        ``_supports_device_symmetry = False``)."""
        raise symmetry_refusal(self._engine_name)

    def _check_device(self) -> None:
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the device engines run on the GPU unless "
                "device='cpu' is passed"
            )

    def _eventually_indices(self, props) -> list:
        """Indices of the eventually properties; they ride bits of an
        int64 lane capped at the JAX engines' 32."""
        evt_idx = [i for i, p in enumerate(props)
                   if p.expectation == Expectation.EVENTUALLY]
        if evt_idx and max(evt_idx) >= 32:
            raise ValueError(
                "the wave engine supports eventually properties only at "
                "property indices < 32; reorder properties() so eventually "
                f"properties come first (got index {max(evt_idx)})"
            )
        return evt_idx

    def _init_rows(self) -> np.ndarray:
        """The init states ``[n0, W]``, deduplicated on the host in
        ``init_vecs`` order (they are few)."""
        W = self.encoded.width
        init = np.asarray(self.encoded.init_vecs(),
                          dtype=np.uint32).reshape(-1, W)
        seen, rows = set(), []
        for row in init:
            fp = self._vec_fp(row)
            if fp not in seen:
                seen.add(fp)
                rows.append(row)
        if len(rows) > self.frontier_capacity:
            raise ValueError(
                f"frontier capacity {self.frontier_capacity} < "
                f"{len(rows)} init states"
            )
        return np.stack(rows) if rows else np.zeros((0, W), np.uint32)

    def _overflow_message(self, kind: str, fps: Optional[dict] = None
                          ) -> str:
        """The JAX engines' overflow messages (``visited``, ``frontier``,
        ``candidates``, ``encoding``), with the discoveries made before
        the raise (``fps``, the attempt's own, default the checker's) —
        they stay readable on the checker."""
        msg = {
            "visited": (
                f"visited table overflow (capacity={self.capacity}); "
                "re-run with a larger capacity"
            ),
            "frontier": (
                f"frontier overflow: a wave produced more than "
                f"{self.frontier_capacity} new states; re-run with a "
                "larger frontier_capacity"
            ),
            "candidates": (
                f"candidate-buffer overflow: a wave generated more than "
                f"{self.cand_capacity} valid successors; re-run with a "
                "larger cand_capacity (or None to disable compaction)"
            ),
            "encoding": (
                "encoding-bound overflow: a successor was pruned by "
                "an internal encoding bound (e.g. a compiled envelope "
                "count reached 128, a declared FIFO queue bound, or "
                "an un-harvested history transition) — the state "
                "space would be silently truncated. Bound the model "
                "(boundary/closure bounds) or use an encoding with "
                "wider fields."
            ),
        }[kind]
        found = self._discovered_fps if fps is None else fps
        if found:
            msg += (
                "  Discoveries recorded before truncation (valid "
                f"counterexamples): {sorted(found)} — "
                "read them via discovered_property_names() / "
                "discovery_fingerprints() after catching this error."
            )
        return msg

    # -- the fused-engine seams (batch.py) ----------------------------------
    #
    # The wave batcher subclasses the hash engine and extends its wave
    # through these seams instead of forking it (JAX ``_seed_extra``,
    # ``_body_extra``, ``_stats_extra``, ``_on_chunk_stats``). Each is a
    # no-op here: the base engine's counts, launches and reads do not
    # change.

    def _seed_extra(self, table, parents, front) -> None:
        """After an attempt's start state is up: its table, parent array
        (updated in place by every wave) and first frontier."""

    def _wave_encoding(self, front):
        """The encoding a wave over the frontier ``front`` evaluates its
        properties and steps through."""
        return self.encoded

    def _body_extra(self, front, rows, is_new) -> list:
        """Extra 1-D int64 device lanes that ride the wave's one host
        read, from its frontier, its candidates' source rows and
        ``is_new``."""
        return []

    def _stats_extra(self, extra: list, new_count: int, fps: dict):
        """The host values of :meth:`_body_extra`'s lanes, after the
        read, with the wave's new count and the attempt's discoveries.
        Returns None (every winner enters the next frontier) or the
        ``(start, stop)`` spans of the winners, in row order, that do."""
        return None

    def _on_chunk_stats(self, w: int, t0: float, t1: float,
                        done: bool) -> None:
        """Host observation of sync ``w`` (from ``t0`` to ``t1``; the
        last when ``done``) after it is recorded: every wave of the
        fused batch, which runs one wave a chunk. What it does is
        outside the sync's wall and the watchdog's."""

    # -- the hash wave loop -------------------------------------------------

    def _visited_bytes_per_row(self) -> int:
        """Device bytes per table slot: the key, the parent key when
        paths are tracked, and the CUDA insert's tag beside each key."""
        return (8 + (8 if self.track_paths else 0)
                + (8 if self.device.type == "cuda" else 0))

    def _memory_projection(self) -> dict:
        """The table at the next capacity step (open addressing degrades
        past probe pressure, and the remedy is doubling): the JAX
        engine's ``capacity_x2`` pricing."""
        nxt = 2 * self.capacity
        return dict(kind="capacity_x2", next_rows=int(nxt),
                    next_visited_bytes=int(nxt * self._visited_bytes_per_row()))

    def _memory_plan_of(self, resident: dict, staging: dict,
                        host: Optional[dict] = None,
                        classes: Optional[list] = None) -> dict:
        """The resident-buffer ledger (memplan.py) of a finished run:
        ``resident`` — the tensors the engine keeps on the device between
        waves, as they are at the end of the run; ``staging`` — the
        widest wave's candidate block and keys, ``(shape, dtype)``
        each; ``host`` — what a tiered run keeps in host memory
        instead; ``classes`` — the capacity classes a chunked run used
        (``memplan.chunk_class_entries``, each priced), or None for a run
        of one wave a sync, which sizes every wave exactly. Priced per
        device (``n_shards`` 1), with the capacity projection."""
        from .. import memplan

        res = memplan.plan_entries(resident)
        stg = memplan.plan_entries(staging)
        resident_bytes = memplan.plan_total(res)
        staging_bytes = memplan.plan_total(stg)
        # ``compiled``: an eager wave or a CUDA graph has no compiled
        # program's memory analysis
        plan = dict(engine=type(self).__name__, device=str(self.device),
                    n_shards=1, resident=res, resident_bytes=resident_bytes,
                    staging=stg, staging_bytes=staging_bytes,
                    classes=list(classes or []), compiled=None,
                    total_bytes=resident_bytes + staging_bytes,
                    projection=self._memory_projection())
        if host:
            plan["host"] = memplan.plan_entries(host)
            plan["host_bytes"] = memplan.plan_total(plan["host"])
        return plan

    def _maybe_warn_occupancy(self, occupancy: float) -> bool:
        """Open addressing degrades before it overflows; warn early, with
        the JAX engine's text (occupancy.py). True when it warned."""
        msg = occupancy_warning(occupancy, used=self._unique_states,
                                capacity=self.capacity,
                                bytes_per_row=self._visited_bytes_per_row())
        if msg is not None:
            # 5 = the caller of join() or of the accessor that ran it
            warnings.warn(msg, RuntimeWarning, stacklevel=5)
        return msg is not None

    def _hash_start(self):
        """``(table, parents, frontier, ebits, unique, generated, depth,
        waves)``: the init states inserted, or a staged snapshot rebuilt
        (the table through ``DeviceHashSet.from_keys``, which keeps the
        insert kernel's tag rule)."""
        dev = self.device
        resume, self._resume = self._resume, None
        if resume is not None:
            t0 = time.monotonic()
            staged = resume[1]
            # the tag rule: a restored table is built whole, never copied
            table = DeviceHashSet.from_keys(
                torch.from_numpy(staged["keys"]).to(dev))
            parents = torch.full((0,), EMPTY, dtype=torch.int64, device=dev)
            if self.track_paths:
                parents = torch.from_numpy(staged["parents"]).to(dev)
            front = torch.from_numpy(staged["frontier"]).to(dev)
            ebits = torch.from_numpy(staged["ebits"]).to(dev)
            self._discovered_fps.update(staged["discovered"])
            if front.shape[1] > self.frontier_capacity:
                raise RuntimeError(self._overflow_message("frontier"))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self._ckpt_stats["resume_upload_sec"] = round(
                time.monotonic() - t0, 6)
            return (table, parents, front, ebits, staged["unique"],
                    staged["generated"], staged["depth"], staged["waves"])
        init = self._init_rows()
        n0 = init.shape[0]
        front = torch.from_numpy(init.astype(np.int64).T.copy()).to(dev)
        table = DeviceHashSet.empty(self.capacity, dev)
        # parent key of each slot's state; EMPTY (the packed (0, 0)) marks
        # a root, as the JAX engine's parent 0 does
        parents = torch.full((self.capacity if self.track_paths else 0,),
                             EMPTY, dtype=torch.int64, device=dev)
        _, _, over, _ = insert(table, pack_keys(*fingerprint_u32v_t(front)),
                               None, self.probe_rounds)
        self._unique_states, self._total_states = n0, n0
        self._max_depth = 1
        if host_read(over.any()):
            raise RuntimeError(self._overflow_message("visited"))
        ebits = torch.full((n0,), self._eventually_bits_init(),
                           dtype=torch.int64, device=dev)
        return table, parents, front, ebits, n0, n0, 1, 0

    def _run_attempt(self, reporter=None) -> None:
        self._check_device()
        if self.builder._visitor is not None:
            raise ValueError(
                "visitors require a host checker (spawn_bfs/spawn_dfs); "
                "the wave engine keeps full states on the device only"
            )
        if not hasattr(self.encoded, "step_cols"):
            raise ValueError(
                "the hash engine needs step_cols, which "
                f"{type(self.encoded).__name__} does not have"
            )
        token = self._begin_attempt()
        if self._sync_waves() > 1:
            return self._run_chunked(reporter, token)
        enc = self.encoded
        props = list(self.model.properties())
        evt_idx = self._eventually_indices(props)
        dev = self.device
        (table, parents, front, ebits, unique, generated, depth,
         waves) = self._traced_start(self._hash_start)
        self._seed_extra(table, parents, front)
        self._unique_states, self._total_states = unique, generated
        self._max_depth = depth
        fps = dict(self._discovered_fps)  # this attempt's discoveries
        chunk_rows = max(1, DENSE_CHUNK_BYTES
                         // (8 * enc.width * enc.max_actions))
        trivial = enc.trivial_boundary
        target_states = self.builder._target_state_count
        target_depth = self.builder._target_max_depth
        max_cand = 0
        insert_shape = (0, 0, 0)
        warned = False
        done = front.shape[1] == 0

        def wave(w: int) -> bool:
            nonlocal front, ebits, unique, generated, depth, waves
            nonlocal max_cand, insert_shape
            wenc = self._wave_encoding(front)
            cond, eb, f_lo, f_hi = frontier_props_t(wenc, props, evt_idx,
                                                    front, ebits)
            if target_depth is not None and depth >= target_depth:
                # the wave at the target depth evaluates its frontier and
                # expands nothing; its rows are not terminal
                succ_t, trunc = front[:, :0], None
                rows = torch.zeros(0, dtype=torch.int64, device=dev)
                has_succ = torch.ones_like(eb, dtype=torch.bool)
            else:
                succ_t, rows, has_succ, trunc, _ = dense_candidates(
                    wenc, front, trivial, chunk_rows)
            # the fault site between the wave's issue and its sync
            faultinject.fire("mid_chunk", w)
            if self._abandoned(token):
                raise RuntimeError("wave abandoned by the watchdog")
            if props:
                disc = wave_hits(props, cond, ~has_succ & (eb != 0), eb,
                                 f_lo, f_hi)
                discovery_update(props, *disc, fps)
            n_cand = rows.numel()
            cand_over = (self.cand_capacity is not None
                         and n_cand > self.cand_capacity)
            if cand_over:  # the JAX buffer keeps the first cand_capacity
                succ_t = succ_t[:, :self.cand_capacity]
                rows = rows[:self.cand_capacity]
            keys = pack_keys(*fingerprint_u32v_t(succ_t))
            _, is_new, over, slot = insert(table, keys, None,
                                           self.probe_rounds)
            # one transfer: table overflow, winner count, truncation, and
            # the lanes of the fused-engine seam
            flags = [over.any(), is_new.sum()]
            if trunc is not None:
                flags.append(trunc)
            head = torch.stack([f.to(torch.int64) for f in flags])
            extra = self._body_extra(front, rows, is_new)
            packed = host_read(torch.cat([head, *extra]) if extra else head)
            flags, extra = packed[:len(flags)], packed[len(flags):]
            new_count = flags[1]
            # the JAX engine's order of verdicts
            if flags[0]:
                raise RuntimeError(self._overflow_message("visited", fps))
            if new_count > self.frontier_capacity:
                raise RuntimeError(self._overflow_message("frontier", fps))
            if cand_over:
                raise RuntimeError(self._overflow_message("candidates", fps))
            if len(flags) > 2 and flags[2]:
                raise RuntimeError(self._overflow_message("encoding", fps))

            spans = self._stats_extra(extra, new_count, fps)
            new_idx = is_new.nonzero().squeeze(1)  # winners in row order
            par_row = rows[new_idx]
            if self.track_paths and new_count:
                parents[slot[new_idx]] = pack_keys(f_lo, f_hi)[par_row]
            kept = new_count
            if spans is not None:  # the winners that go on
                new_idx = torch.cat([new_idx[a:b] for a, b in spans]
                                    or [new_idx[:0]])
                par_row = rows[new_idx]
                kept = sum(b - a for a, b in spans)
            front = succ_t[:, new_idx]
            ebits = eb[par_row]
            generated += n_cand
            unique += new_count
            waves += 1
            if n_cand > max_cand:
                max_cand = n_cand
                insert_shape = (unique - new_count, n_cand, new_count)

            if self._tracer is not None:
                # JAX's hash engine keeps no wave log: its chunks land
                # without wave rows
                self._trace_row = (waves - 1, None, None)
            all_disc = bool(props) and len(fps) == len(props)
            target_hit = target_states is not None and unique >= target_states
            finished = kept == 0 or all_disc or target_hit
            if not finished:
                depth += 1
            return finished

        def buffers():
            return checkpoint.hash_buffers(
                self, table, parents, front, ebits, depth=depth, waves=waves,
                generated=generated, unique=unique), None

        w = 0
        while not done:
            t0 = time.monotonic()
            try:
                done = self._guarded_wave(lambda: wave(w), w)
            finally:
                self._publish(token, fps, unique, generated, depth)
            t1 = self._wave_done(w, t0, done, buffers)
            self._on_chunk_stats(w, t0, t1, done)
            w += 1
            if not done and not warned:  # once a run, where JAX warns a sync
                warned = self._maybe_warn_occupancy(unique / self.capacity)
            if (reporter is not None and not done
                    and waves % REPORT_EVERY_WAVES == 0):
                reporter.report_checking(ReportData(
                    total_states=generated, unique_states=unique,
                    max_depth=depth, duration_sec=self.duration_sec(),
                    done=False,
                ))
        self._finish_hash(table, parents, front, ebits, depth=depth,
                          waves=waves, generated=generated, unique=unique,
                          max_cand=max_cand, insert_shape=insert_shape,
                          extra=dict(waves_per_sync=1))

    def _finish_hash(self, table, parents, front, ebits, *, depth: int,
                     waves: int, generated: int, unique: int, max_cand: int,
                     insert_shape: tuple, extra: dict,
                     classes=None) -> None:
        """The end of a hash run, either loop: the final state, the memory
        plan (with the chunked run's ``classes``, ``(Fc, Pc)`` each),
        ``metrics`` (with ``extra``) and the paths."""
        W = self.encoded.width
        #: the tensors the run kept between waves, as it ended
        self._final = dict(table=table, parents=parents, frontier=front,
                           ebits=ebits)
        if self.keep_final_carry:
            self._final_carry = dict(self._final, depth=depth, waves=waves,
                                     generated=generated, unique=unique)
        from ..memplan import chunk_class_entries

        self.memory_plan = self._memory_plan_of(
            dict(table=table.keys if table.entries is None
                 else table.entries, parents=parents, frontier=front,
                 ebits=ebits),
            dict(candidates=((W, max_cand), np.int64),
                 candidate_keys=((max_cand,), np.int64)), None,
            [chunk_class_entries("hash", W, Fc, Pc, self.capacity, index=i)
             for i, (Fc, Pc) in enumerate(classes or [])])
        # the widest wave's insert: (occupied slots, keys, new keys)
        self.metrics = dict(
            waves=waves, frontier_size=front.shape[1],
            occupancy=unique / self.capacity,
            dedup_ratio=1.0 - unique / generated if generated else 0.0,
            max_wave_candidates=max_cand, insert_shape=insert_shape,
            **extra, **self._ckpt_metrics(),
        )
        if self.track_paths:
            self._decode_paths(table, parents)

    # -- the chunked hash waves (checkers/chunk.py) --------------------------

    def _hash_classes(self, K: int, h: dict, cur=None) -> tuple:
        """The ``(Fc, Pc)`` classes for the next hash wave from the polled
        scalars ``h``: the frontier rows a wave steps and the pairs it
        keeps (the frontier halves hold ``Pc`` columns, so a wave's
        winners always fit them: a frontier past ``Fc`` commits, and
        only the next wave waits for a grown ``Fc``)."""
        fcap = self.frontier_capacity
        pcap = max(1, fcap * K)
        if cur is None:
            Fc = grow_class(h["nf"], fcap, FLOOR_F)
            return Fc, max(Fc, grow_class(h["nf"] * K, pcap, FLOOR_P))
        Fc, Pc = cur
        if h["grow"] & GROW_P:
            Pc = grow_class(h["need_p"], pcap, FLOOR_P)
        if h["grow"] & GROW_F:
            # room for the frontier's growth rate over the next waves
            r = min(max(h["need_f"] / max(h["last_nf"], 1), 1.0),
                    chunk.GROWTH_CAP)
            ahead = int(h["need_f"] * r)
            per_row = -(-h["last_p"] // max(h["last_nf"], 1))
            Fc = grow_class(ahead, fcap, FLOOR_F)
            Pc = max(Pc, grow_class(ahead * per_row, pcap, FLOOR_P))
        if shrinks(h, Fc):
            Fc, Pc = shrink_classes(h, Pc, fcap, pcap)
        return Fc, max(Pc, Fc)

    def _hash_carry(self, n_props: int, N: int, Fc: int, Pc: int,
                    traced: bool, front, ebits, nf: int) -> "HashCarry":
        cx = HashCarry(self.device, n_props, N, traced, self.encoded.width,
                       Fc, Pc)
        cx.step_rows = Fc * self.encoded.max_actions  # a dense wave
        cx.load(front, ebits, nf)
        return cx

    def _hash_wave(self, cx: "HashCarry", p: int, c, table,
                   parents_buf) -> None:
        """One chunked hash wave, reading half ``p`` of ``cx`` and writing
        half ``1 - p``: the steps of the one-wave loop's wave on
        class-sized buffers, the insert with its key count on the device
        (``ops.hashset.insert_dev``), no host read. A wave whose pairs do
        not fit their class inserts nothing and commits nothing."""
        enc, props = c.enc, c.props
        dev = cx.device
        nf, depth, unique = cx.s("nf"), cx.s("depth"), cx.s("nv")
        live = cx.s("stop") == 0
        Fc, Pc = cx.Fc, cx.Pc
        front, ebits_in = cx.fr[p, :, :Fc], cx.eb[p, :Fc]
        fmask = cx.ar_f < nf
        cond, eb, f_lo, f_hi = frontier_props_t(enc, props, c.evt_idx, front,
                                                ebits_in)
        at_target = (torch.zeros((), dtype=torch.bool, device=dev)
                     if c.target_depth is None else depth >= c.target_depth)
        succ_c, rows, pairs, trunc, per_row = dense_pairs_fixed(
            enc, front, fmask & ~at_target, c.chunk_rows, Pc,
            cx.rows_bound())
        ok = cx.ar_p < pairs
        if not c.trivial:
            ok = ok & enc.within_boundary_cols(succ_c)
        n_cand = ok.sum()
        ins = ok
        if self.cand_capacity is not None:  # the JAX buffer keeps the first
            ins = ok & (torch.cumsum(ok.to(torch.int64), 0)
                        <= self.cand_capacity)
        has_succ = rows_with(per_row, ok) | at_target
        p_over = pairs > Pc
        fits = live & ~p_over
        keys = pack_keys(*fingerprint_u32v_t(succ_c))
        n_ins = torch.where(fits, pairs.clamp(max=Pc), 0)
        is_new, over, slot = insert_dev(table, keys, ins, n_ins,
                                        cx.s("epoch"), self.probe_rounds)
        ins = ins & fits
        is_new = is_new & ins
        new = is_new.sum()
        # the one-wave loop's verdicts, in its order; every one after the
        # insert, as there
        v_raise = (over & ins).any()
        f_raise = fits & ~v_raise & (new > self.frontier_capacity)
        c_raise = fits & ~v_raise & ~f_raise & (
            False if self.cand_capacity is None
            else n_cand > self.cand_capacity)
        e_raise = fits & ~v_raise & ~f_raise & ~c_raise & trunc
        raised = v_raise | f_raise | c_raise | e_raise
        commit = fits & ~raised
        all_disc = torch.zeros((), dtype=torch.bool, device=dev)
        if props:
            hit, lo, hi = wave_hits(props, cond, ~has_succ & (eb != 0), eb,
                                    f_lo, f_hi, live=fmask)
            disc = fold_discoveries(cx.disc, hit, lo, hi, fits)
            cx.disc.copy_(disc)
            all_disc = disc[0].all()
        # winners in row order, their parents, the next frontier
        new_idx = rank_compact(is_new, Pc, cx.ar_p.view(1, -1), 0)[0]
        par_row = rows[new_idx]
        if self.track_paths:
            cap = parents_buf.numel() - dump_size(dev)
            parents_buf[torch.where(is_new & commit, slot,
                                    dump_slots(cap, Pc, dev))] = \
                pack_keys(f_lo, f_hi)[rows]
        cx.fr[1 - p].copy_(succ_c[:, new_idx])
        cx.eb[1 - p].copy_(eb[par_row])
        unique_after = unique + new
        fin = (new == 0) | all_disc
        if c.target_states is not None:
            fin = fin | (unique_after >= c.target_states)
        done = commit & fin
        g_f = commit & ~fin & (new > Fc)
        ci = commit.to(torch.int64)
        wider = commit & (n_cand > cx.s("max_cand"))
        grow = ((live & p_over).to(torch.int64) * GROW_P
                + g_f.to(torch.int64) * GROW_F)
        over_bits = (v_raise.to(torch.int64) * OVER_VISITED
                     + f_raise.to(torch.int64) * OVER_FRONTIER
                     + c_raise.to(torch.int64) * OVER_CAND
                     + e_raise.to(torch.int64) * OVER_ENC)
        upd = dict(
            stop=((cx.s("stop") != 0) | done | (grow != 0)
                  | raised).to(torch.int64),
            done=(cx.s("done") != 0).to(torch.int64) | done.to(torch.int64),
            grow=cx.s("grow") | grow, over=cx.s("over") | over_bits,
            depth=depth + (commit & ~fin).to(torch.int64),
            waves=cx.s("waves") + ci, nv=unique + ci * new,
            nf=torch.where(commit, new, nf), gen=cx.s("gen") + ci * n_cand,
            wchunk=cx.s("wchunk") + ci,
            need_p=torch.where(live & ~commit, pairs, cx.s("need_p")),
            need_f=torch.where(g_f, new, cx.s("need_f")),
            last_p=torch.where(commit, pairs, cx.s("last_p")),
            last_nf=torch.where(commit, nf, cx.s("last_nf")),
            max_cand=torch.where(wider, n_cand, cx.s("max_cand")),
            ins_occ=torch.where(wider, unique, cx.s("ins_occ")),
            ins_keys=torch.where(wider, n_cand, cx.s("ins_keys")),
            ins_new=torch.where(wider, new, cx.s("ins_new")),
        )
        cx.write(upd)

    def _run_chunked(self, reporter, token) -> None:
        """The hash run as chunks of up to ``waves_per_sync`` waves
        (checkers/chunk.py): one read of the packed stats a chunk."""
        from types import SimpleNamespace

        from .chunk import WaveRunner

        enc = self.encoded
        props = list(self.model.properties())
        K = enc.max_actions
        c = SimpleNamespace(
            enc=enc, props=props, evt_idx=self._eventually_indices(props),
            trivial=enc.trivial_boundary,
            chunk_rows=max(1, DENSE_CHUNK_BYTES // (8 * enc.width * K)),
            target_states=self.builder._target_state_count,
            target_depth=self.builder._target_max_depth)
        (table, parents, front, ebits, unique, generated, depth,
         waves) = self._traced_start(self._hash_start)
        dev = self.device
        cap = self.capacity
        parents_buf = torch.full(
            (cap + dump_size(dev) if self.track_paths else 0,), EMPTY,
            dtype=torch.int64, device=dev)
        if self.track_paths:
            parents_buf[:cap] = parents
            parents = parents_buf[:cap]
        self._unique_states, self._total_states = unique, generated
        self._max_depth = depth
        fps = dict(self._discovered_fps)
        N = self._sync_waves()
        traced = self._tracer is not None
        nf = front.shape[1]
        h = dict(nf=nf)
        fcap = self.frontier_capacity
        classes = chunk.start_classes(
            self._hash_classes(K, h), self._resume_classes,
            lambda k: k[0] <= fcap and nf <= k[1] <= max(1, fcap * K))
        self._resume_classes = None
        cx = self._hash_carry(len(props), N, *classes[-1], traced, front,
                              ebits, nf)
        cx.set_scalars(depth=depth, waves=waves, nv=unique, nf=nf,
                       gen=generated, epoch=table.epoch)
        for i, prop in enumerate(props):
            fp = fps.get(prop.name)
            if fp is not None:
                cx.disc[:, i] = torch.tensor(
                    [1, fp & 0xFFFFFFFF, fp >> 32], dtype=torch.int64)
        runner = WaveRunner(dev, "hash")
        chunk_no = 0
        warned = False
        done = nf == 0
        stats = None

        def resize(cx_, h_, key):
            f, e = cx_.view(h_)
            new = self._hash_carry(len(props), N, *key, traced, f, e,
                                   h_["nf"])
            new.sc.copy_(cx_.sc)
            new.disc.copy_(cx_.disc)
            return new

        loop = ChunkLoop(
            runner, ChunkSchedule(waves, N),
            lambda cx_, par: self._hash_wave(cx_, par, c, table,
                                             parents_buf),
            lambda h_, key: self._hash_classes(K, h_, key), resize,
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

        def buffers():
            f, e = cx.view(stats)
            return checkpoint.hash_buffers(
                self, table, parents, f, e, depth=stats["depth"],
                waves=stats["waves"], generated=stats["gen"],
                unique=stats["nv"]), None

        try:
            while not done:
                t0 = time.monotonic()
                try:
                    stats = self._guarded_wave(run_chunk, chunk_no)
                finally:
                    if stats is not None:
                        self._publish(token, fps, stats["nv"], stats["gen"],
                                      stats["depth"])
                for bit, kind in ((OVER_VISITED, "visited"),
                                  (OVER_FRONTIER, "frontier"),
                                  (OVER_CAND, "candidates"),
                                  (OVER_ENC, "encoding")):
                    if stats["over"] & bit:
                        raise RuntimeError(self._overflow_message(kind, fps))
                table.epoch = stats["epoch"] if dev.type == "cuda" \
                    else table.epoch
                done = bool(stats["done"])
                boundary = loop.sched.synced(stats["waves"], done)
                if self._tracer is not None:
                    # JAX's hash engine keeps no wave log: its chunks land
                    # without wave rows
                    self._trace_row = (stats["waves"] - stats["wchunk"],
                                       None, None, stats["wchunk"])
                t1 = self._wave_done(chunk_no, t0, done, buffers, boundary)
                self._on_chunk_stats(chunk_no, t0, t1, done)
                chunk_no += 1
                if done:
                    break
                if not warned:  # once a run, where JAX warns a sync
                    warned = self._maybe_warn_occupancy(stats["nv"] / cap)
                if reporter is not None and boundary is not None:
                    reporter.report_checking(ReportData(
                        total_states=stats["gen"], unique_states=stats["nv"],
                        max_depth=stats["depth"],
                        duration_sec=self.duration_sec(), done=False))
        finally:
            runner.close()
        if stats is None:  # a settled start: no wave ran
            stats = dict(depth=depth, waves=waves, gen=generated, nv=unique,
                         nf=nf, max_cand=0, ins_occ=0, ins_keys=0,
                         ins_new=0)
            f, e = front, ebits
        else:
            f, e = (t.clone() for t in cx.view(stats))
        self._finish_hash(
            table, parents, f, e, depth=stats["depth"],
            waves=stats["waves"], generated=stats["gen"],
            unique=stats["nv"], max_cand=stats["max_cand"],
            insert_shape=(stats["ins_occ"], stats["ins_keys"],
                          stats["ins_new"]),
            extra=dict(waves_per_sync=N, chunks=chunk_no,
                       resizes=loop.resizes,
                       classes=[list(k) for k in loop.classes],
                       **runner.counts()),
            classes=loop.classes)

    def _decode_paths(self, table, parents) -> None:
        """Each discovery's path, at the run's end, from the parent log
        compacted out of the table (the fused engine decodes when asked,
        batch.py)."""
        # the log stays on the device: each path step is one device-side
        # lookup
        logged = table.occupied() & (parents != EMPTY)
        self._plog = (table.keys[logged], parents[logged])
        for name, fp in self._discovered_fps.items():
            self._discoveries[name] = self._reconstruct(fp)

    # -- results ----------------------------------------------------------

    def _replayable_discoveries(self) -> None:
        """Run (or replay) the search. Discoveries made before a run
        raised stay readable: the error is suppressed on a REPLAY that
        has them, while a first call still raises, so a caller that
        skipped ``join()`` cannot take a truncated search for a clean
        one (the JAX engine's rule)."""
        already_failed = self._done and self._run_error is not None
        try:
            self._ensure_run()
        except RuntimeError:
            if not (already_failed and self._discovered_fps):
                raise

    def discovered_property_names(self) -> set:
        self._replayable_discoveries()
        return set(self._discovered_fps)

    def discovery_fingerprints(self) -> dict[str, int]:
        self._replayable_discoveries()
        return dict(self._discovered_fps)

    def discoveries(self):
        self._ensure_run()
        if not self.track_paths and self._discovered_fps:
            raise RuntimeError(
                "paths unavailable with track_paths=False; use "
                "discovered_property_names()/discovery_fingerprints(), or "
                "re-run with track_paths=True for counterexample traces"
            )
        return super().discoveries()

    def assert_properties(self) -> None:
        """Works without paths too: existence checks need only the
        discovery fingerprints."""
        self._ensure_run()
        for prop in self.model.properties():
            has = prop.name in self._discovered_fps
            if prop.expectation == Expectation.SOMETIMES and not has:
                raise AssertionError(f"expected a discovery for {prop.name!r}")
            if prop.expectation != Expectation.SOMETIMES and has:
                raise AssertionError(
                    f"unexpected discovery for {prop.name!r}: "
                    f"{self._discovered_fps[prop.name]:#018x}"
                )

    # -- reconstruction ----------------------------------------------------

    def _vec_fps(self, rows) -> list:
        """Host fingerprints of encoded rows ``[N, W]``, as the engine's
        keys hold them: clamped where the engine clamps (the parent log
        stores its child keys). Under symmetry the rows canonicalize
        first, with the device's own math, so replay meets the keys the
        device wrote."""
        block = torch.from_numpy(np.asarray(rows, np.int64).reshape(
            -1, self.encoded.width).T.copy())
        if self.sym_spec is not None:
            block = canonicalize_t(self.sym_spec, block)
        keys = pack_keys(*fingerprint_u32v_t(block))
        if self._clamps_keys:
            keys = clamp_keys(keys)
        return [key_to_fp(k) for k in keys.tolist()]

    def _vec_fp(self, row) -> int:
        return self._vec_fps(row)[0]

    def _parent_of(self, fp: int) -> Optional[int]:
        """One parent-log lookup, on the log's device, or by binary
        search in a tiered run's host log (roots are absent from the
        log)."""
        children, parents = self._plog
        key = fp_to_key(fp)
        if isinstance(children, np.ndarray):
            i = int(np.searchsorted(children, key))
            if i == children.size or children[i] != key:
                return None
            return key_to_fp(int(parents[i]))
        hit = (children == key).nonzero()
        if hit.numel() == 0:
            return None
        return key_to_fp(int(parents[hit[0, 0]]))

    def _reconstruct(self, fp: int) -> Path:
        """Walk the parent log, then replay the HOST model matching
        device fingerprints of encoded successors (bfs.rs:371-400 +
        path.rs:20-97, with the encoder as the bridge). Traced, the walk
        and the replay are the ``cex_parent_drain`` and
        ``cex_host_decode`` spans of a ``counterexample_reconstruction``
        span."""
        with telemetry.span("counterexample_reconstruction",
                            fingerprint=f"{fp:#x}"):
            with telemetry.span("cex_parent_drain"):
                fps = [fp]
                while True:
                    parent = self._parent_of(fps[-1])
                    if parent is None:
                        break
                    fps.append(parent)
                fps.reverse()
            with telemetry.span("cex_host_decode"):
                return self._replay_fps(fps)

    def _replay_fps(self, fps: list) -> Path:
        """Replay a fingerprint trace through the HOST model: the init
        state, then at each step the first successor (in
        ``model.actions`` order) whose encoding has the next
        fingerprint."""
        model = self.model
        enc = self.encoded
        state = None
        for init_state in model.init_states():
            if self._vec_fp(enc.encode(init_state)) == fps[0]:
                state = init_state
                break
        if state is None:
            raise RuntimeError(
                f"no init state encodes to fingerprint {fps[0]:#x}; "
                "encode()/init_vecs() disagree"
            )
        steps = []
        for next_fp in fps[1:]:
            succs = [(a, t) for a in model.actions(state)
                     if (t := model.next_state(state, a)) is not None]
            found = (self._vec_fps([enc.encode(t) for _, t in succs])
                     if succs else [])
            if next_fp not in found:
                raise RuntimeError(
                    f"no host successor encodes to {next_fp:#x}: the "
                    "vectorized step disagrees with the host model"
                )
            action, next_state = succs[found.index(next_fp)]
            steps.append((state, action))
            state = next_state
        steps.append((state, None))
        return Path(steps)
