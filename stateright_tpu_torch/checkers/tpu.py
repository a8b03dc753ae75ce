"""What the sort-merge wave engine inherits from the JAX package's
``checkers/tpu.py``: the dense step's flag normalization, frontier
property evaluation, per-wave discovery recording, the symmetry spec's
resolution at spawn, and counterexample path reconstruction.

The frontier is an exact ``[W, n]`` lane-major block (the port sizes
every wave to its live rows), so there is no row-validity mask here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..checker import Checker, CheckerBuilder
from ..model import Expectation
from ..ops.canonical import canonicalize_t
from ..ops.fingerprint import (
    clamp_keys,
    fingerprint_u32v_t,
    fp_to_key,
    key_to_fp,
    pack_keys,
)
from ..path import Path
from .common import symmetry_refusal


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


def wave_hits(props, cond, evt_cex, ebits, f_lo, f_hi):
    """This wave's per-property verdicts over the frontier: ``(hit[P],
    lo[P], hi[P])`` device tensors, the fingerprint of the FIRST hitting
    row in frontier order (the JAX engines' ``argmax``)."""
    masks = []
    for i, p in enumerate(props):
        if p.expectation == Expectation.ALWAYS:
            masks.append(~cond[:, i])
        elif p.expectation == Expectation.SOMETIMES:
            masks.append(cond[:, i])
        else:
            masks.append(evt_cex & ((ebits & (1 << i)) != 0))
    mask = torch.stack(masks).to(torch.uint8)
    row = torch.argmax(mask, dim=1)
    return mask.any(dim=1), f_lo[row], f_hi[row]


def discovery_update(props, hits, los, his, found: dict) -> None:
    """Fold this wave's verdicts into ``found`` (property name ->
    fingerprint), keeping the first (shallowest) hit — bfs.rs discovery
    recording. One host transfer per wave."""
    packed = torch.stack([hits.to(torch.int64), los, his]).cpu().tolist()
    for i, p in enumerate(props):
        if packed[0][i] and p.name not in found:
            found[p.name] = (packed[2][i] << 32) | packed[1][i]


class TpuBfsChecker(Checker):
    """The result surface the JAX ``TpuBfsChecker`` gives the sort-merge
    engine: encoding resolution, discovery accessors, and path
    reconstruction from the device parent log."""

    #: the name refusals give the spawn
    _engine_name = "spawn_sortmerge"

    def __init__(self, builder: CheckerBuilder, encoded=None,
                 capacity: int = 1 << 16,
                 frontier_capacity: Optional[int] = None,
                 track_paths: bool = True, device=None):
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
        #: waive the reduction gate (``CheckerBuilder.unsound_ok()``)
        self.unsound_ok = builder._unsound_ok
        #: the device symmetry spec when the reduction is on: candidates
        #: canonicalize before the fold, so visited keys are canonical
        #: fingerprints while the frontier keeps concrete states
        self.sym_spec = None
        if builder._symmetry is not None:
            self.sym_spec = self._resolve_symmetry()
        self.capacity = capacity
        self.frontier_capacity = frontier_capacity or capacity
        self.track_paths = track_paths
        #: the device every wave runs on: the CUDA device unless the
        #: caller asks for the CPU.
        self.device = torch.device(device if device is not None else "cuda")
        #: property name -> fingerprint of the discovery state.
        self._discovered_fps: dict[str, int] = {}
        #: the parent log, (child keys, parent keys) as packed int64
        #: tensors on the run's device, once the run has finished.
        self._plog = None

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

    def _check_device(self) -> None:
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the device engines run on the GPU unless "
                "device='cpu' is passed"
            )

    # -- results ----------------------------------------------------------

    def discovered_property_names(self) -> set:
        self._ensure_run()
        return set(self._discovered_fps)

    def discovery_fingerprints(self) -> dict[str, int]:
        self._ensure_run()
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
        """Host fingerprints of encoded rows ``[N, W]``, with the device
        keys' all-ones clamp (the parent log stores clamped child
        keys). Under symmetry the rows canonicalize first, with the
        device's own math, so replay meets the keys the device wrote."""
        block = torch.from_numpy(np.asarray(rows, np.int64).reshape(
            -1, self.encoded.width).T.copy())
        if self.sym_spec is not None:
            block = canonicalize_t(self.sym_spec, block)
        keys = clamp_keys(pack_keys(*fingerprint_u32v_t(block)))
        return [key_to_fp(k) for k in keys.tolist()]

    def _vec_fp(self, row) -> int:
        return self._vec_fps(row)[0]

    def _parent_of(self, fp: int) -> Optional[int]:
        """One parent-log lookup, on the log's device (roots are absent
        from the log)."""
        children, parents = self._plog
        hit = (children == fp_to_key(fp)).nonzero()
        if hit.numel() == 0:
            return None
        return key_to_fp(int(parents[hit[0, 0]]))

    def _reconstruct(self, fp: int) -> Path:
        """Walk the parent log, then replay the HOST model matching
        device fingerprints of encoded successors (bfs.rs:371-400 +
        path.rs:20-97, with the encoder as the bridge)."""
        fps = [fp]
        while True:
            parent = self._parent_of(fps[-1])
            if parent is None:
                break
            fps.append(parent)
        fps.reverse()
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
