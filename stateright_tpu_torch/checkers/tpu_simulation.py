"""Device simulation: N random walks advancing in lockstep on a device.

The port of ``stateright_tpu.checkers.tpu_simulation`` — the
accelerator re-design of the reference's simulation checker
(src/checker/simulation.rs). Where one host thread walks one trace at a
time from init to terminal/cycle/boundary, the device advances N walks
per step in lockstep: the encoding's dense ``step_cols`` over the
``[W, N]`` walk block, a per-walk uniform choice among the valid,
in-boundary successors, and property bitmaps folded into per-property
discovery flags. Every counter, flag, discovery and trace ring stays on
the device across steps; the host reads one packed stats vector per run.

Semantics relative to the reference (as in the JAX package):

* Walks that reach a terminal state (no valid successor) check
  surviving EventuallyBits (an eventually-counterexample,
  checker.rs:559-566) and then RESTART from an init state with a fresh
  ebits mask — the device analog of simulation.rs:180-364's
  trace-per-iteration loop.
* Per-trace cycle detection (simulation.rs:207, 250-261) is replaced by
  the ``max_steps`` walk bound: cycles burn steps until the bound
  restarts the walk, so they count as non-terminal for eventually
  properties (the reference's revisit class, bfs.rs:285-303).
* ``unique_state_count`` is approximate and equals ``state_count``,
  as in the reference (simulation.rs:380-384). The count is exact
  here: the JAX package keeps it in a uint32, which wraps past 2**32
  generated states.

Randomness is counter-based: the bits of walk ``i`` at in-round step
``s`` of round ``salt`` are the low word of the state fingerprint fold
(ops/fingerprint.py) over the two lanes ``[seed ^ s*0x9E3779B9 ^
salt*0x85EBCA6B, i]`` (all mod 2**32). Every dense step equals the JAX
``step_vec`` bit for bit, so a run equals the JAX run with the same
``seed``, ``n_walks``, ``max_steps`` and ``rounds``: counts, depth,
discoveries, their fingerprints and their traces.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..checker import CheckerBuilder
from ..model import Expectation
from ..ops.fingerprint import fingerprint_u32v_t
from ..report import Reporter
from .tpu import (
    DENSE_CHUNK_BYTES,
    TpuBfsChecker,
    _props_and_ebits,
    step_with_trunc,
)

_M32 = 0xFFFFFFFF


def rand_bits(seed: int, step: int, salt: int, n: int,
              device=None) -> torch.Tensor:
    """Uniform uint32 bits of walks ``0..n-1`` at in-round step
    ``step`` of round ``salt`` (int64 ``[n]``): the low word of the
    fingerprint fold over ``[seed ^ step*0x9E3779B9 ^ salt*0x85EBCA6B,
    walk index]``, each term of the first lane mod 2**32."""
    walk = torch.arange(n, dtype=torch.int64, device=device)
    base = torch.full_like(walk, (seed ^ ((step * 0x9E3779B9) & _M32)
                                  ^ ((salt * 0x85EBCA6B) & _M32)))
    lo, _ = fingerprint_u32v_t(torch.stack([base, walk]))
    return lo


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """The first true index along the last axis, 0 where none is —
    ``jnp.argmax`` over bool (torch's ``argmax`` takes no bool, and
    returns the first of equal maxima)."""
    return mask.to(torch.uint8).argmax(dim=-1)


def uniform_choice(valid: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Each row's ``r % max(n_valid, 1)``-th valid slot (slot 0 when a
    row has none): ``valid bool[n, K]``, ``r`` int64 uint32 bits. The
    running count goes slot-major: a scan along the short innermost
    axis took 1.7 ms a call at 262,144 x 47 on an H100, the outer-axis
    scan a few passes of elementwise work."""
    csum = valid.T.cumsum(dim=0)
    pick = r % csum[-1].clamp(min=1)
    return (csum > pick).to(torch.uint8).argmax(dim=0)


@dataclass
class WalkState:
    """The walks' resident state between steps (all on one device)."""

    #: int64[W, N] the walks' current states, lane-major
    walks: torch.Tensor
    #: int64[N] eventually-bits per walk
    ebits: torch.Tensor
    #: int64[N] states on each walk's trace (1 at an init state)
    walk_depth: torch.Tensor
    #: int64 scalar, the deepest trace
    depth: torch.Tensor
    #: bool scalar, any encoding-bound truncation seen
    e_ovf: torch.Tensor
    #: per property: found (bool[P]), fingerprint limbs (int64[P])
    found: torch.Tensor
    disc_lo: torch.Tensor
    disc_hi: torch.Tensor
    #: int64[N, LT] each walk's fingerprint trace ring (LT = 1 with
    #: paths off: never written)
    trace_lo: torch.Tensor
    trace_hi: torch.Tensor
    #: per property, the hitting walk's ring at first discovery and its
    #: length: int64[P, LT], int64[P]
    dt_lo: torch.Tensor
    dt_hi: torch.Tensor
    dt_len: torch.Tensor


class TpuSimulationChecker(TpuBfsChecker):
    """``CheckerBuilder.spawn_device_simulation()`` — ``n_walks`` random
    walks of up to ``max_steps`` transitions, ``rounds`` times from the
    init states. With ``track_paths=True`` (default) the device keeps a
    per-walk fingerprint trace ring; on each property's FIRST discovery
    the hitting walk's trace is frozen, and ``discoveries()`` gives it
    replayed through the host model as a :class:`Path`.

    ``device`` defaults to the CUDA device; pass ``"cpu"`` for the
    plain-PyTorch path. One step's ``[W, rows*K]`` successor block stays
    under the sort-merge engine's ``DENSE_CHUNK_BYTES`` (row chunks,
    which change no result).
    """

    #: walk steps, not chunked waves (device simulation's chunk is a
    #: later slice)
    _chunks_waves = False

    _engine_name = "spawn_device_simulation"

    def __init__(self, builder: CheckerBuilder, encoded=None,
                 n_walks: int = 1024, max_steps: int = 64,
                 rounds: int = 4, seed: int = 0,
                 track_paths: bool = True, device=None):
        super().__init__(builder, encoded, capacity=1,
                         frontier_capacity=1, track_paths=track_paths,
                         device=device)
        if not hasattr(self.encoded, "step_cols"):
            raise ValueError(
                "the device simulation needs step_cols, which "
                f"{type(self.encoded).__name__} does not have"
            )
        if not 0 <= seed <= _M32:
            raise ValueError(f"seed must be a uint32, got {seed}")
        self.n_walks = n_walks
        self.max_steps = max_steps
        self.rounds = rounds
        self.seed = seed

    # -- the walk ----------------------------------------------------------

    def _step(self, walks: torch.Tensor, r: Optional[torch.Tensor]):
        """The dense step of every walk, in row chunks: ``(nxt, n_valid,
        trunc_any)`` — each walk's chosen successor ``[W, N]`` (None
        when ``r`` is None), its count of valid in-boundary successors
        and whether any row was truncated by an encoding bound."""
        enc = self.encoded
        W, K = enc.width, enc.max_actions
        n = walks.shape[1]
        chunk = max(1, DENSE_CHUNK_BYTES // (8 * W * K))
        nxts, counts, truncs = [], [], []
        for r0 in range(0, n, chunk):
            block = walks[:, r0:r0 + chunk]
            m = block.shape[1]
            succ, valid, trunc = step_with_trunc(enc, block)
            if not enc.trivial_boundary:
                valid = valid & enc.within_boundary_cols(
                    succ.reshape(W, m * K)).reshape(m, K)
            counts.append(valid.sum(dim=1))
            truncs.append(trunc.any())
            if r is not None:
                choice = uniform_choice(valid, r[r0:r0 + m])
                rows = torch.arange(m, device=walks.device)
                nxts.append(succ[:, rows, choice])
            del succ, valid
        nxt = None
        if r is not None:
            nxt = nxts[0] if len(nxts) == 1 else torch.cat(nxts, dim=1)
        n_valid = counts[0] if len(counts) == 1 else torch.cat(counts)
        return nxt, n_valid, torch.stack(truncs).any()

    def _eval(self, c: WalkState, props, evt_idx,
              r: Optional[torch.Tensor]):
        """Trace ring write, property bitmap, ebits, the step, and
        per-property first discovery (freezing the hitting walk's
        trace) over the walk block. Returns ``(nxt, terminal,
        ebits)``; ``c``'s rings, discoveries and flag are updated."""
        walks = c.walks
        n = walks.shape[1]
        f_lo, f_hi = fingerprint_u32v_t(walks)
        rows = torch.arange(n, device=walks.device)
        if self.track_paths:
            # Record each walk's CURRENT state at its depth slot —
            # idempotent, so the end-of-round re-evaluation is safe.
            pos = (c.walk_depth - 1).clamp(max=c.trace_lo.shape[1] - 1)
            c.trace_lo[rows, pos] = f_lo
            c.trace_hi[rows, pos] = f_hi
        if props:
            cond = self.encoded.property_conditions_cols(walks)
        else:
            cond = torch.zeros((n, 0), dtype=torch.bool,
                               device=walks.device)
        ebits = _props_and_ebits(cond, c.ebits, evt_idx)
        nxt, n_valid, trunc_any = self._step(walks, r)
        terminal = n_valid == 0
        c.e_ovf |= trunc_any
        if props:
            masks = []
            for i, p in enumerate(props):
                if p.expectation == Expectation.ALWAYS:
                    masks.append(~cond[:, i])
                elif p.expectation == Expectation.SOMETIMES:
                    masks.append(cond[:, i])
                else:
                    masks.append(terminal & ((ebits & (1 << i)) != 0))
            mask = torch.stack(masks)
            hit = mask.any(dim=1)
            row = first_true(mask)
            fresh = hit & ~c.found
            c.found |= hit
            c.disc_lo = torch.where(fresh, f_lo[row], c.disc_lo)
            c.disc_hi = torch.where(fresh, f_hi[row], c.disc_hi)
            if self.track_paths:
                # freeze the hitting walk's trace before a restart
                # recycles its ring slots
                c.dt_lo = torch.where(fresh[:, None], c.trace_lo[row],
                                      c.dt_lo)
                c.dt_hi = torch.where(fresh[:, None], c.trace_hi[row],
                                      c.dt_hi)
                c.dt_len = torch.where(fresh, c.walk_depth[row], c.dt_len)
        return nxt, terminal, ebits

    def _seed(self, init_t: torch.Tensor, n_props: int) -> WalkState:
        """Each walk starts at a (cyclically assigned) init state."""
        dev = init_t.device
        N, n0 = self.n_walks, init_t.shape[1]
        LT = self.max_steps + 1 if self.track_paths else 1
        idx = torch.arange(N, device=dev) % n0

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return WalkState(
            walks=init_t[:, idx],
            ebits=torch.full((N,), self._eventually_bits_init(),
                             dtype=torch.int64, device=dev),
            walk_depth=torch.ones(N, dtype=torch.int64, device=dev),
            depth=torch.ones((), dtype=torch.int64, device=dev),
            e_ovf=zeros(dtype=torch.bool),
            found=zeros(n_props, dtype=torch.bool),
            disc_lo=zeros(n_props), disc_hi=zeros(n_props),
            trace_lo=zeros(N, LT), trace_hi=zeros(N, LT),
            dt_lo=zeros(n_props, LT), dt_hi=zeros(n_props, LT),
            dt_len=zeros(n_props),
        )

    def _walk(self, init_t: torch.Tensor, props, evt_idx) -> WalkState:
        """Every round: ``max_steps`` steps, then the evaluation of the
        round's final states (which discovers and records, and counts
        no state), then a restart of every walk."""
        dev = init_t.device
        N, n0 = self.n_walks, init_t.shape[1]
        ebits_init = self._eventually_bits_init()
        c = self._seed(init_t, len(props))
        walk = torch.arange(N, device=dev)
        for salt in range(self.rounds):
            for step in range(self.max_steps):
                r = rand_bits(self.seed, step, salt, N, dev)
                nxt, terminal, ebits = self._eval(c, props, evt_idx, r)
                # Terminal walks restart from a (rotating) init state
                # with fresh ebits (simulation.rs trace-per-iteration).
                restart = init_t[:, (walk + step) % n0]
                c.walks = torch.where(terminal, restart, nxt)
                c.ebits = torch.where(terminal, ebits_init, ebits)
                # +1 per transition, reset on restart: max_depth is the
                # deepest TRACE, not the loop's step counter
                c.walk_depth = torch.where(terminal, 1, c.walk_depth + 1)
                c.depth = torch.maximum(c.depth, c.walk_depth.max())
            self._eval(c, props, evt_idx, None)
            c.walks = init_t[:, (walk + salt) % n0]
            c.ebits = torch.full_like(c.ebits, ebits_init)
            c.walk_depth = torch.ones_like(c.walk_depth)
        return c

    def resume_from(self, path: str, allow_sha_mismatch: bool = False):
        raise NotImplementedError(
            "the device simulation keeps no visited set to snapshot: "
            "checkpoints are the breadth-first engines' (spawn_sortmerge, "
            "spawn_hash; checkpoint.py)")

    def _run(self, reporter: Optional[Reporter] = None) -> None:
        self._check_device()
        enc = self.encoded
        props = list(self.model.properties())
        n_props = len(props)
        evt_idx = [i for i, p in enumerate(props)
                   if p.expectation == Expectation.EVENTUALLY]
        if evt_idx and max(evt_idx) >= 32:
            raise ValueError(
                "the device simulation supports eventually properties "
                "only at property indices < 32; reorder properties() so "
                "eventually properties come first (got index "
                f"{max(evt_idx)})"
            )
        init = np.asarray(enc.init_vecs(), dtype=np.uint32).reshape(
            -1, enc.width)
        if init.shape[0] == 0:
            return
        init_t = torch.from_numpy(
            init.astype(np.int64).T.copy()).to(self.device)
        c = self._walk(init_t, props, evt_idx)
        # the run's one readback
        stats = torch.cat([
            c.depth.reshape(1), c.e_ovf.reshape(1).long(), c.found.long(),
            c.disc_lo, c.disc_hi, c.dt_len, c.dt_lo.reshape(-1),
            c.dt_hi.reshape(-1),
        ]).cpu().tolist()
        self._total_states = self.n_walks * (1 + self.rounds
                                             * self.max_steps)
        self._unique_states = self._total_states  # approximate
        self._max_depth = stats[0]
        if stats[1]:
            raise RuntimeError(
                "encoding-bound overflow: a walk hit a successor pruned "
                "by an internal encoding bound (e.g. a compiled envelope "
                "count reached 128); walk coverage would be silently "
                "truncated"
            )
        P = n_props
        found, lo, hi, dt_len = (stats[2 + k * P:2 + (k + 1) * P]
                                 for k in range(4))
        LT = c.dt_lo.shape[1]
        off = 2 + 4 * P
        dt_lo = stats[off:off + P * LT]
        dt_hi = stats[off + P * LT:]
        from .. import telemetry

        for i, prop in enumerate(props):
            if not found[i]:
                continue
            if prop.name not in self._discovered_fps:
                telemetry.emit("verdict", property=prop.name,
                               expectation=prop.expectation.name.lower(),
                               kind="discovery", wave=None,
                               depth=self._max_depth)
            self._discovered_fps[prop.name] = (hi[i] << 32) | lo[i]
            if self.track_paths:
                # the frozen trace, replayed through the HOST model
                self._discoveries[prop.name] = self._replay_fps([
                    (dt_hi[i * LT + j] << 32) | dt_lo[i * LT + j]
                    for j in range(dt_len[i])
                ])
