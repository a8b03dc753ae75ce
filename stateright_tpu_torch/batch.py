"""Multi-session wave batching: N compatible sessions in one device run.

The port of the JAX package's ``batch`` module. A session id (sid)
rides as the last lane of every fused state, so one hash-engine wave
advances the frontiers of N sessions at once. The sid lane is folded
into every fingerprint, so the sessions' visited keys are disjoint: a
fingerprint never crosses sessions. Each session's counts, verdicts and
counterexample paths are therefore its solo run's.

* :class:`FusedModel` / :class:`FusedEncodedModel`: the sid-lane
  product of the members. The fused encoding pads each member's vector
  to ``max(width) + 1`` lanes with the sid last; ``step_cols`` runs each
  member's own ``step_cols`` on its own sid's rows and pads the result
  into the fused ``[Wf, n, Kf]`` block with the sid on every row;
  property conditions are vacuous off-lane (ALWAYS true, SOMETIMES
  false), so the fused property list is the members' lists in order.
* :class:`FusedWaveChecker`: the hash wave engine (checkers/tpu.py)
  through its fused-engine seams. The frontier stays in sid order (the
  init rows are in sid order, the expansion keeps (row, slot) order and
  the winners keep row order), so each session's rows are a span whose
  length the previous wave's read brought to the host: the per-session
  candidate and new counts ride the wave's one host read, and a session
  whose properties are all discovered has its span dropped from the next
  frontier with no further sync.
* :class:`BatchGroup`: the rendezvous. The first member to call
  :meth:`BatchGroup.member_run` leads: it waits out the window, freezes
  the group, builds the fused engine and runs it under a throwaway
  tracer. A member whose lane settles is peeled at that wave: its paths
  are walked on the leader thread in the live table (entries never
  move, so no copy), and its own thread wakes and replays its lane into
  its own tracer while the batch goes on. A group that cannot fuse
  falls back to each member's solo run with a one-line reason.

The fused engine runs one wave a chunk (its chunk of several waves is a
later slice): ``waves_per_sync`` is accepted and recorded, and the peel
happens at a wave.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from .checker import CheckerBuilder
from .checkers.tpu import TpuBfsChecker, host_read
from .checkers.tpu_simulation import TpuSimulationChecker
from .encoding import EncodedModelBase
from .model import Expectation, Model, Property
from .ops.fingerprint import fp_to_key, key_to_fp
from .ops.hashset import EMPTY, find
from .path import Path

#: per-wave per-session lane-log fields: frontier rows, candidates, new
#: states, cumulative unique, depth entering the wave
LANE_LOG_FIELDS = 5


def _pow2ceil(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


# -- the sid-lane product encoding ----------------------------------------


class FusedModel(Model):
    """Host-side product of N member models, disjoint by sid: states
    are ``(sid, member_state)``, actions and successors are the owning
    member's, and the property list concatenates the members' lists
    under ``s{i}:`` name prefixes with off-lane-vacuous conditions. It
    is the replay oracle of the fused engine's paths; a path with the
    sid stripped is the member's own path."""

    def __init__(self, member_models: list):
        self.members = list(member_models)
        self._props = []
        for i, m in enumerate(self.members):
            for p in m.properties():
                self._props.append(Property(
                    p.expectation, f"s{i}:{p.name}",
                    self._lane_condition(i, m, p)))

    @staticmethod
    def _lane_condition(i: int, member, prop):
        vac = prop.expectation == Expectation.ALWAYS

        def cond(model, st):
            if st[0] != i:
                return vac
            return prop.condition(member, st[1])

        return cond

    def init_states(self):
        return [(i, s) for i, m in enumerate(self.members)
                for s in m.init_states()]

    def actions(self, state):
        sid, st = state
        return self.members[sid].actions(st)

    def next_state(self, state, action):
        sid, st = state
        nxt = self.members[sid].next_state(st, action)
        return None if nxt is None else (sid, nxt)

    def properties(self):
        return list(self._props)

    def format_action(self, action):
        return str(action)


def _window(counts: list, a: int, b: int) -> list:
    """Rows of each sid inside ``[a, b)`` of a sid-ordered block whose
    sids hold ``counts`` rows each."""
    out, start = [], 0
    for c in counts:
        out.append(max(0, min(start + c, b) - max(start, a)))
        start += c
    return out


class FusedEncodedModel(EncodedModelBase):
    """Device-side product encoding: member vectors padded to
    ``max(width) + 1`` lanes with the session id in the LAST lane. The
    sid lane is fingerprinted with the rest of the state, so fused
    visited keys are disjoint by sid.

    ``step_cols`` and ``property_conditions_cols`` take ``sid_counts``:
    the rows of each sid in a block sorted by sid, as the fused engine's
    frontier is, so each member's rows are a slice and no split waits on
    the device. Members must have trivial boundaries
    (:func:`batch_eligible` sees to it), so the fused encoding's trivial
    boundary is exact."""

    def __init__(self, member_encs: list, host_model: FusedModel):
        self.members = list(member_encs)
        self.host_model = host_model
        self.width = max(m.width for m in self.members) + 1
        self.max_actions = max(m.max_actions for m in self.members)
        #: each member's columns of the fused property list
        self._prop_cols = []
        #: fused property columns that are true off-lane (ALWAYS)
        self._always_cols = []
        off = 0
        for m in self.members:
            props = m.host_model.properties()
            self._always_cols += [off + j for j, p in enumerate(props)
                                  if p.expectation == Expectation.ALWAYS]
            self._prop_cols.append(slice(off, off + len(props)))
            off += len(props)

    # -- host side ---------------------------------------------------------

    def init_vecs(self) -> np.ndarray:
        rows = []
        for i, m in enumerate(self.members):
            iv = np.asarray(m.init_vecs(), np.uint32).reshape(-1, m.width)
            pad = np.zeros((iv.shape[0], self.width), np.uint32)
            pad[:, :m.width] = iv
            pad[:, self.width - 1] = i
            rows.append(pad)
        return np.concatenate(rows, axis=0)

    def encode(self, state) -> np.ndarray:
        sid, st = state
        m = self.members[sid]
        row = np.zeros(self.width, np.uint32)
        row[:m.width] = np.asarray(m.encode(st), np.uint32)
        row[self.width - 1] = sid
        return row

    def cache_key(self):
        """The fused encoding's identity: every member's identity and
        shape, and the fusion arity."""
        parts = []
        for m in self.members:
            key = m.cache_key() if hasattr(m, "cache_key") else None
            parts.append((type(m).__name__, key, m.width, m.max_actions))
        return ("fused", len(self.members), tuple(parts))

    # -- device side -------------------------------------------------------

    def _parts(self, states_t: torch.Tensor, sid_counts) -> list:
        """``(sid, rows)`` of each member present in the sid-sorted
        block: a slice apiece."""
        if sum(sid_counts) != states_t.shape[1]:
            raise ValueError(f"sid_counts {list(sid_counts)} do not cover "
                             f"{states_t.shape[1]} rows")
        out, start = [], 0
        for i, c in enumerate(sid_counts):
            if c:
                out.append((i, slice(start, start + c)))
            start += c
        return out

    def step_cols(self, states_t: torch.Tensor, sid_counts) -> tuple:
        Wf, Kf = self.width, self.max_actions
        n = states_t.shape[1]
        dev = states_t.device
        out = torch.zeros((Wf, n, Kf), dtype=torch.int64, device=dev)
        out[Wf - 1] = states_t[Wf - 1].unsqueeze(1)
        valid = torch.zeros((n, Kf), dtype=torch.bool, device=dev)
        trunc = None
        for i, rows in self._parts(states_t, sid_counts):
            m = self.members[i]
            succ, val, tr = m.step_cols(states_t[:m.width, rows])
            out[:m.width, rows, :m.max_actions] = succ
            valid[rows, :m.max_actions] = val
            if tr is not None:
                if trunc is None:
                    trunc = torch.zeros(n, dtype=torch.bool, device=dev)
                trunc[rows] = tr
        return out, valid, trunc

    def property_conditions_cols(self, states_t: torch.Tensor,
                                 sid_counts) -> torch.Tensor:
        n = states_t.shape[1]
        out = torch.zeros((n, self._prop_cols[-1].stop), dtype=torch.bool,
                          device=states_t.device)
        for j in self._always_cols:  # vacuous off-lane
            out[:, j] = True
        for i, rows in self._parts(states_t, sid_counts):
            m, cols = self.members[i], self._prop_cols[i]
            if cols.stop > cols.start:
                out[rows, cols] = m.property_conditions_cols(
                    states_t[:m.width, rows])
        return out


class _SidView:
    """The fused encoding over one wave's sid-ordered frontier, whose
    sids hold ``counts`` rows each: property conditions over the whole
    frontier and steps over its consecutive row chunks (the order
    ``dense_candidates`` takes them in) both slice by sid."""

    def __init__(self, enc: FusedEncodedModel, counts: list):
        self._enc = enc
        self._counts = counts
        self._cursor = 0
        self.width = enc.width
        self.max_actions = enc.max_actions
        self.trivial_boundary = True

    def property_conditions_cols(self, states_t):
        return self._enc.property_conditions_cols(states_t, self._counts)

    def step_cols(self, block):
        a = self._cursor
        self._cursor = b = a + block.shape[1]
        return self._enc.step_cols(block, _window(self._counts, a, b))


# -- eligibility / compatibility classes ----------------------------------


def batch_eligible(checker) -> tuple:
    """``(class_key, None)`` when ``checker`` can join a fused batch,
    else ``(None, reason)`` with a one-line reason (the solo fallback's
    message). Two sessions may fuse iff their class keys are equal: the
    class groups sessions whose padded shapes are close (power-of-two
    width and action count), so fusion never pays unbounded padding."""
    if not isinstance(checker, TpuBfsChecker):
        return None, "not a device wave engine"
    # a random walk is no breadth-first search (JAX's check lets the
    # device simulation through, and fuses it into one)
    if isinstance(checker, TpuSimulationChecker):
        return None, "simulation sessions cannot batch"
    if getattr(checker, "n_shards", 1) not in (None, 1):
        return None, "sharded mesh sessions batch per-shard already"
    b = checker.builder
    if b._visitor is not None:
        return None, "visitor sessions cannot batch"
    if b._target_state_count is not None or b._target_max_depth is not None:
        return None, "bounded-target sessions cannot batch"
    if not checker.track_paths:
        return None, "untracked-path sessions cannot batch"
    if checker.checkpoint_every:
        return None, "checkpointing sessions cannot batch"
    if getattr(checker, "_resume", None) is not None:
        return None, "warm-started sessions resume solo"
    if getattr(checker, "tier_hot_rows", None):
        return None, "tiered sessions cannot batch"
    # a reduced session's visited keys are canonical fingerprints and a
    # raw session's plain ones: they cannot share one visited set, and
    # the hash engine has no canonicalization pass
    if getattr(checker, "sym_spec", None) is not None:
        return None, "symmetry-reduced sessions cannot fuse (canonical" \
            " keys are a different compatibility class)"
    if getattr(checker, "ample_set", False):
        return None, "ample-set filtered sessions cannot fuse (reduced" \
            " action sets are a different compatibility class)"
    enc = checker.encoded
    if not hasattr(enc, "cache_key"):
        return None, "encoding lacks a cache_key identity"
    if not getattr(enc, "trivial_boundary", False):
        return None, "bounded-boundary encodings cannot batch"
    for p in checker.model.properties():
        if p.expectation == Expectation.EVENTUALLY:
            return None, "eventually properties cannot batch"
    return ("batch", _pow2ceil(enc.width), _pow2ceil(enc.max_actions)), None


# -- the fused engine ------------------------------------------------------


class FusedWaveChecker(TpuBfsChecker):
    """The hash wave engine over the sid-lane product encoding, with
    per-session lane accounting riding each wave's one host read. Every
    wave appends one record to ``chunk_records``: its walls, the
    ``[1, N, LANE_LOG_FIELDS]`` lane rows (frontier rows, candidates,
    new states, cumulative unique, depth entering the wave), each
    session's unique, depth and generated counts after it, the fused
    discoveries so far and whether the run ended; ``on_chunk(record)``
    is called with it (the group's peel)."""

    #: one wave a chunk (its chunk is a later slice)
    _chunks_waves = False

    def __init__(self, member_checkers: list,
                 waves_per_sync: Optional[int] = None):
        members = list(member_checkers)
        if len(members) < 2:
            raise ValueError("a fused batch needs >= 2 sessions")
        devices = {str(c.device) for c in members}
        if len(devices) > 1:
            raise ValueError(
                f"fused sessions must share one device, got {sorted(devices)}")
        fm = FusedModel([c.model for c in members])
        fe = FusedEncodedModel([c.encoded for c in members], fm)
        super().__init__(
            CheckerBuilder(fm), encoded=fe,
            # 4x the summed member capacities keeps the fused table's
            # occupancy in the flat probe regime even when every member
            # fills its own capacity
            capacity=_pow2ceil(4 * sum(c.capacity for c in members)),
            frontier_capacity=_pow2ceil(
                sum(c.frontier_capacity for c in members)),
            track_paths=True, device=members[0].device, cand_capacity=None)
        self.n_sessions = len(members)
        #: the waves a sync asked for; the port syncs every wave
        self.waves_per_sync = int(waves_per_sync or 1)
        #: per-member slice into the fused property list
        self.lane_slices: list = []
        off = 0
        for c in members:
            n = len(c.model.properties())
            self.lane_slices.append(slice(off, off + n))
            off += n
        self.chunk_records: list = []
        #: optional callable(record) called at every wave's sync
        self.on_chunk: Optional[Callable[[dict], None]] = None
        self._live = None

    # -- the wave seams ----------------------------------------------------

    def _seed_extra(self, table, parents, front) -> None:
        N = self.n_sessions
        init = self._init_rows()
        counts = np.bincount(init[:, self.encoded.width - 1].astype(np.int64),
                             minlength=N)[:N]
        #: the live table and parents, updated in place every wave
        self._live = (table, parents)
        #: rows of each sid in the frontier entering the next wave
        self._f_counts = [int(c) for c in counts]
        self._sid_unique = list(self._f_counts)
        self._sid_gen = list(self._f_counts)
        self._sid_depth = [1] * N
        self._lane_row = None
        self.chunk_records = []

    def _wave_encoding(self, front):
        return _SidView(self.encoded, self._f_counts)

    def _body_extra(self, front, rows, is_new) -> list:
        """Each sid's candidates and new states: the candidates are in
        row order, so their sid lane is sorted and each sid's block
        starts where ``searchsorted`` puts it."""
        dev = front.device
        N = self.n_sessions
        sid = front[self.encoded.width - 1][rows].contiguous()
        bounds = torch.searchsorted(
            sid, torch.arange(N + 1, dtype=torch.int64, device=dev))
        csum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                          torch.cumsum(is_new.to(torch.int64), 0)])
        return [bounds[1:] - bounds[:-1], csum[bounds[1:]] - csum[bounds[:-1]]]

    def _lane_discovered(self, fps: dict) -> list:
        props = self.model.properties()
        return [sl.stop > sl.start
                and all(props[j].name in fps for j in range(sl.start, sl.stop))
                for sl in self.lane_slices]

    def _stats_extra(self, extra: list, new_count: int, fps: dict):
        N = self.n_sessions
        cand, new = extra[:N], extra[N:2 * N]
        lane_disc = self._lane_discovered(fps)
        row = []
        for i in range(N):
            self._sid_unique[i] += new[i]
            self._sid_gen[i] += cand[i]
            row.append([self._f_counts[i], cand[i], new[i],
                        self._sid_unique[i], self._sid_depth[i]])
            # a lane whose properties are all discovered stops where its
            # solo run would: its depth stays, its rows leave the frontier
            if new[i] > 0 and not lane_disc[i]:
                self._sid_depth[i] += 1
        self._lane_row = row
        self._f_counts = [0 if lane_disc[i] else new[i] for i in range(N)]
        if self._f_counts == list(new):
            return None
        spans, start = [], 0
        for i in range(N):
            if self._f_counts[i]:
                spans.append((start, start + new[i]))
            start += new[i]
        return spans

    def _on_chunk_stats(self, w: int, t0: float, t1: float,
                        done: bool) -> None:
        fetch, _ = self._wave_read_walls()
        props = self.model.properties()
        fps = self._discovered_fps
        found = [fps.get(p.name) for p in props]
        record = dict(
            chunk_no=w, wave0=w, n_waves=1, t0=t0, t1=t1,
            dispatch_sec=max(t1 - t0 - fetch, 0.0), fetch_sec=fetch,
            rows=np.array([self._lane_row], np.int64),
            unique=np.array(self._sid_unique, np.int64),
            depth=np.array(self._sid_depth, np.int64),
            gen=np.array(self._sid_gen, np.int64),
            disc=np.array([fp is not None for fp in found], np.int64),
            disc_lo=np.array([(fp or 0) & 0xFFFFFFFF for fp in found],
                             np.uint32),
            disc_hi=np.array([(fp or 0) >> 32 for fp in found], np.uint32),
            done=bool(done))
        self.chunk_records.append(record)
        if self.on_chunk is not None:
            self.on_chunk(record)

    def _run_attempt(self, reporter=None) -> None:
        super()._run_attempt(reporter)
        self.metrics.update(n_sessions=self.n_sessions,
                            waves_per_sync=self.waves_per_sync,
                            lane_unique=list(self._sid_unique),
                            lane_depth=list(self._sid_depth),
                            lane_generated=list(self._sid_gen))

    # -- paths from the live table -------------------------------------------

    def _decode_paths(self, table, parents) -> None:
        """Nothing at the run's end: a group's seats walk their own
        chains at their peel, and the engine run alone walks its paths
        when :meth:`discoveries` is first asked (no parent log is
        compacted over the whole table)."""

    def discoveries(self):
        self._ensure_run()
        names = [n for n in self._discovered_fps if n not in self._discoveries]
        if names:
            if self._live is None:
                raise RuntimeError("the fused table is released: a batch "
                                   "group's seats hold the paths")
            chains = self.fingerprint_chains(
                [self._discovered_fps[n] for n in names])
            for name, chain in zip(names, chains):
                self._discoveries[name] = self._replay_fps(chain)
        return super().discoveries()

    def fingerprint_chains(self, fps: list) -> list:
        """For each fingerprint, the fingerprints from a root to it,
        walked through the live table's parent slots together, one
        counted host read a step (entries never move, so a settled
        lane's chains are complete while the run goes on). Device work:
        call it on the thread that runs the engine."""
        table, parents = self._live
        chains = [[fp] for fp in fps]
        live = list(range(len(fps)))
        while live:
            keys = torch.tensor([fp_to_key(chains[i][-1]) for i in live],
                                dtype=torch.int64, device=self.device)
            slot = find(table, keys, self.probe_rounds)
            slots, pars = host_read(torch.stack(
                [slot, parents[slot.clamp(min=0)]]))
            nxt = []
            for i, s, par in zip(live, slots, pars):
                if s < 0:
                    raise RuntimeError(f"fingerprint {chains[i][-1]:#x} is "
                                       "not in the fused table")
                if par != EMPTY:
                    chains[i].append(key_to_fp(par))
                    nxt.append(i)
            live = nxt
        return [c[::-1] for c in chains]


# -- the rendezvous and the demux -----------------------------------------


class BatchMember:
    """One session's seat in a batch group."""

    def __init__(self, index: int, checker, label: str = ""):
        self.index = index
        self.checker = checker
        self.label = label
        #: the group this seat belongs to
        self.group: Optional["BatchGroup"] = None
        self.done = threading.Event()
        #: set when this member settled inside the fused run
        self.payload: Optional[dict] = None
        #: set when this member must run solo instead (one-line reason)
        self.fallback_reason: Optional[str] = None
        #: called before the solo fallback run, and with the fallback
        #: reason (a service shows it on the session's own output)
        self.solo_prepare: Optional[Callable[[], None]] = None
        self.notify: Optional[Callable[[str], None]] = None


class BatchGroup:
    """A rendezvous of compatible sessions that fuses into one device
    run. The FIRST member to call :meth:`member_run` leads: it waits out
    the batching window, freezes membership, builds the
    :class:`FusedWaveChecker`, prices it through the ``admit`` hook
    (``admit(fused, members)`` returns None or a refusal reason),
    installs ``make_gate()`` as its ``dispatch_gate`` and drives the
    fused run under a throwaway tracer. Every other member blocks on its
    own event and is woken the moment its lane settles (the peel), then
    replays its lane into its own thread's tracer and returns. Any
    failure to fuse degrades to the solo run with a one-line reason:
    fusion is an optimization, never a correctness dependency."""

    def __init__(self, group_id: int, class_key, *,
                 max_sessions: int = 4, window_sec: float = 0.25,
                 waves_per_sync: Optional[int] = None,
                 admit: Optional[Callable] = None,
                 make_gate: Optional[Callable] = None):
        self.group_id = group_id
        self.class_key = class_key
        self.max_sessions = max_sessions
        self.window_sec = window_sec
        self.waves_per_sync = waves_per_sync
        self.admit = admit
        self.make_gate = make_gate
        self.members: list = []
        self.fused: Optional[FusedWaveChecker] = None
        #: member indices in the order they settled
        self.settle_order: list = []
        self._lock = threading.Lock()
        self._full = threading.Event()
        self._frozen = False
        self._alive: list = []
        self._lead_tracer = None

    # -- membership --------------------------------------------------------

    def try_join(self, checker, label: str = "") -> Optional[BatchMember]:
        """Claim a seat; None when the group already froze or filled
        (the caller opens a fresh group)."""
        with self._lock:
            if self._frozen or len(self.members) >= self.max_sessions:
                return None
            m = BatchMember(len(self.members), checker, label)
            m.group = self
            self.members.append(m)
            if len(self.members) >= self.max_sessions:
                self._full.set()
            return m

    # -- per-session entry point ------------------------------------------

    def member_run(self, member: BatchMember, reporter=None) -> None:
        """Runs on the member's own thread, in place of its checker's
        ``_run``. The leader (seat 0) drives the fused run; followers
        wait for their peel."""
        if member.index == 0:
            self._lead()
        else:
            member.done.wait()
        if member.fallback_reason is not None:
            if member.notify is not None:
                member.notify(member.fallback_reason)
            if member.solo_prepare is not None:
                member.solo_prepare()
            type(member.checker)._run(member.checker, reporter)
            return
        self._replay(member)

    # -- the leader --------------------------------------------------------

    def _fallback_all(self, members, reason: str) -> None:
        for m in members:
            if not m.done.is_set():
                m.fallback_reason = reason
                m.done.set()

    def _lead(self) -> None:
        self._full.wait(self.window_sec)
        with self._lock:
            self._frozen = True
            members = list(self.members)
        self._alive = [True] * len(members)
        if len(members) < 2:
            self._fallback_all(
                members,
                "batch: no compatible peers arrived within the "
                "batching window; running solo via the FIFO gate")
            return
        try:
            fused = FusedWaveChecker([m.checker for m in members],
                                     waves_per_sync=self.waves_per_sync)
        except Exception as exc:
            self._fallback_all(
                members, f"batch: fused engine construction failed "
                f"({type(exc).__name__}: {exc}); running solo")
            return
        if self.admit is not None:
            reason = self.admit(fused, members)
            if reason:
                self._fallback_all(members, reason)
                return
        if self.make_gate is not None:
            fused.dispatch_gate = self.make_gate()
        fused.on_chunk = self._on_chunk
        self.fused = fused
        from .telemetry import RunTracer

        tracer = RunTracer()
        self._lead_tracer = tracer
        try:
            with tracer.activate_thread():
                fused._ensure_run(None)
        except Exception as exc:
            # members already peeled keep their exact results; the rest
            # degrade to solo
            self._fallback_all(
                members, f"batch: fused dispatch failed "
                f"({type(exc).__name__}: {exc}); running solo")
            return
        with self._lock:
            last = len(fused.chunk_records) - 1
            for m in members:
                if not m.done.is_set():
                    self._settle(m, last)
            # every seat holds its lane: the fused table and parents are
            # not needed any more
            fused._live = fused._final = None

    # -- the peel ----------------------------------------------------------

    def _on_chunk(self, record: dict) -> None:
        """Called at every fused wave's sync (leader thread): wake every
        member whose lane settled in this wave."""
        with self._lock:
            chunk_idx = len(self.fused.chunk_records) - 1
            for m in self.members:
                if m.done.is_set() or not self._alive[m.index]:
                    continue
                if self._lane_settled(m.index, record):
                    self._alive[m.index] = False
                    self._settle(m, chunk_idx)

    def _lane_settled(self, i: int, record: dict) -> bool:
        if record["done"]:
            return True
        sl = self.fused.lane_slices[i]
        if sl.stop > sl.start and all(record["disc"][sl]):
            return True
        rows = record["rows"][:, i, :]
        live = rows[rows[:, 0] > 0]
        # a live wave that committed nothing drains the lane for good
        return live.size > 0 and int(live[-1][2]) == 0

    def _settle(self, member: BatchMember, chunk_idx: int) -> None:
        """Hand the member its lane: the records so far, the fused
        build rows, and each discovery's fingerprint chain, walked now
        (on the leader thread, the only one that touches the device) in
        the live table, where the lane's entries are complete. The walk's
        wall is the seat's ``batch_peel`` span."""
        t0 = time.monotonic()
        fused = self.fused
        record = fused.chunk_records[chunk_idx]
        sl = fused.lane_slices[member.index]
        found = {}
        for j, prop in enumerate(member.checker.model.properties()):
            if record["disc"][sl.start + j]:
                found[prop.name] = (int(record["disc_hi"][sl.start + j])
                                    << 32) | int(record["disc_lo"][sl.start + j])
        chains = dict(zip(found, fused.fingerprint_chains(list(found.values()))))
        member.payload = dict(
            upto=chunk_idx,
            records=list(fused.chunk_records[:chunk_idx + 1]),
            chains=chains,
            builds=[dict(e) for e in self._lead_tracer.events
                    if e.get("ev") == "program_build"],
            peel=(t0, time.monotonic()))
        self.settle_order.append(member.index)
        member.done.set()

    # -- the member-side demux --------------------------------------------

    def _replay(self, member: BatchMember) -> None:
        """Replay this member's lane of the fused run into its checker,
        on the member's own thread and into its own tracer, so its trace
        holds only its own events: the leader's walk of its paths as the
        ``batch_peel`` span, and this replay as ``batch_replay``. The
        ``batch`` event is what ``metrics.bridge_events`` folds into
        ``stpu_batched_sessions_total`` and ``stpu_batch_occupancy``."""
        from . import telemetry

        tracer = telemetry.current_tracer()
        if tracer is not None:
            tracer.record_span("batch_peel", *member.payload["peel"],
                               seat=member.index)
        with telemetry.span("batch_replay", seat=member.index):
            self._replay_lane(member, tracer)

    def _replay_lane(self, member: BatchMember, tracer) -> None:
        fused = self.fused
        i = member.index
        checker = member.checker
        payload = member.payload
        records = payload["records"]
        n = len(self.members)
        sl = fused.lane_slices[i]
        props = checker.model.properties()

        if tracer is not None:
            tracer.event("batch", group=self.group_id, size=n, index=i,
                         chunks=len(records))
            for b in payload["builds"]:
                row = {k: v for k, v in b.items()
                       if k not in ("ev", "run", "t")}
                for lane in ("wall_sec", "cold_sec"):
                    if row.get(lane):
                        row[lane] = round(row[lane] / n, 6)
                row["batch"] = self.group_id
                tracer.event("program_build", **row)

        lane_waves = 0
        chunk_out = 0
        seen: set = set()
        for r in records:
            rows = r["rows"][:, i, :]
            live = rows[rows[:, 0] > 0]
            # the sessions sharing this wave each take a 1/N_active
            # share of its walls
            n_active = max(1, int(np.sum(np.any(r["rows"][:, :, 0] > 0,
                                                axis=0))))
            if live.size > 0:
                wave_rows = [[int(x[0]), 0, int(x[1]), int(x[2]), int(x[3]),
                              int(x[4]), 0, 0] for x in live]
                if tracer is not None:
                    tracer.record_chunk(
                        chunk=chunk_out, wave0=lane_waves, t0=r["t0"],
                        t1=r["t1"], dispatch_sec=r["dispatch_sec"] / n_active,
                        fetch_sec=r["fetch_sec"] / n_active,
                        n_waves=len(wave_rows), wave_rows=wave_rows,
                        pairs_valid=False)
                lane_waves += len(wave_rows)
                chunk_out += 1
            for j, prop in enumerate(props):
                if r["disc"][sl.start + j] and j not in seen:
                    seen.add(j)
                    if tracer is not None:
                        tracer.event(
                            "verdict", property=prop.name,
                            expectation=prop.expectation.name.lower(),
                            kind="discovery", wave=lane_waves,
                            depth=int(r["depth"][i]),
                            chunk=max(chunk_out - 1, 0))

        final = records[-1]
        checker._total_states = int(final["gen"][i])
        checker._unique_states = int(final["unique"][i])
        checker._max_depth = int(final["depth"][i])
        checker.metrics = dict(
            frontier_size=0,
            occupancy=checker._unique_states / checker.total_capacity,
            dedup_ratio=(1.0 - checker._unique_states / checker._total_states
                         if checker._total_states else 0.0),
            waves=lane_waves, batch_size=n)
        checker.memory_plan = fused.memory_plan

        # paths: each chain replayed on the fused model, the sid
        # stripped; the discovery's fingerprint is the member's own
        for name, chain in payload["chains"].items():
            fused_path = fused._replay_fps(chain)
            path = Path([(st[1], act) for st, act in fused_path.steps])
            checker._discoveries[name] = path
            checker._discovered_fps[name] = checker._vec_fp(
                checker.encoded.encode(path.last_state()))


def seat_sessions(checkers: list, labels: Optional[list] = None, *,
                  max_sessions: int = 4, window_sec: float = 0.25,
                  waves_per_sync: Optional[int] = None,
                  admit: Optional[Callable] = None,
                  notify: Optional[Callable[[str], None]] = print) -> list:
    """Seat each checker in a batch group of its compatibility class,
    in order, as a service admits sessions: a checker joins the open
    group of its class (a fresh group once that one is full), and its
    ``join``, ``report`` and accessors then go through
    :meth:`BatchGroup.member_run`. Returns one
    ``(member, reason)`` a checker: the seat, or None with the
    :func:`batch_eligible` reason when it cannot batch (its run stays
    solo). Each checker is then run on a thread of its own; ``notify``
    gets a seat's fallback reason."""
    open_groups: dict = {}
    n_groups = 0
    out = []
    for k, checker in enumerate(checkers):
        key, reason = batch_eligible(checker)
        if key is None:
            out.append((None, reason))
            continue
        label = labels[k] if labels else ""
        group = open_groups.get(key)
        member = group.try_join(checker, label) if group is not None else None
        if member is None:
            group = BatchGroup(n_groups, key,
                               max_sessions=max_sessions,
                               window_sec=window_sec,
                               waves_per_sync=waves_per_sync, admit=admit)
            open_groups[key] = group
            n_groups += 1
            member = group.try_join(checker, label)
        member.notify = notify
        checker._run = (lambda reporter=None, g=group, m=member:
                        g.member_run(m, reporter))
        out.append((member, None))
    return out
