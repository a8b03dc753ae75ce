"""The resident-buffer ledger and the pricing of the tiered visited set.

A copy of the JAX package's ``memplan`` module, cut to what the port
uses: the ledger rows (:func:`buffer_entry`, :func:`plan_entries`,
:func:`plan_total`), the per-visited-class merge scratch
(:func:`v_class_entries`), the hot/cold split of the tiered visited set
(:func:`decide_hot_rows`, the ``tier_hot_rows="auto"`` policy), the
tiered frontier-headroom bound (:func:`tier_frontier_headroom`), the
admission floor (:func:`session_resident_bytes`), the live device
watermark (:func:`device_bytes_in_use`), the byte formatter and the
``MEM_r*.json`` writer (:func:`write_memory_artifact`).

The JAX module's compiled-program analysis (``compiled_memory``,
``compiled_memory_analysis``) is XLA's own accounting of a compiled
wave program; an eager PyTorch wave has no compiled program, so it has
no counterpart here. The engines build their ledger from the tensors
they really hold after a run (``checker.memory_plan``,
checkers/tpu.py).

Numpy only, but for :func:`device_bytes_in_use`, which imports torch
when it is called.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

#: device bytes of one state lane: the port carries uint32 values in
#: int64 (``torch.uint32`` has no shifts or compares on the CPU)
LANE_BYTES = 8

# -- the ledger -----------------------------------------------------------


def buffer_entry(name: str, shape, dtype) -> dict:
    """One ledger row: ``{name, shape, dtype, bytes}``. ``bytes`` is
    ``prod(shape) * itemsize`` — what a tensor's ``nbytes`` reports.
    ``dtype`` is a numpy dtype or anything numpy reads as one (a torch
    dtype goes through its name: ``torch.int64`` -> ``"int64"``)."""
    shape = tuple(int(s) for s in shape)
    name_of = str(dtype)
    dt = np.dtype(name_of[6:] if name_of.startswith("torch.") else dtype)
    n = 1
    for s in shape:
        n *= s
    return dict(name=name, shape=list(shape), dtype=str(dt),
                bytes=int(n * dt.itemsize))


def plan_entries(spec: dict) -> list:
    """Ledger rows, sorted by name, for a dict of tensors (anything with
    ``shape`` and ``dtype``) or of ``(shape, dtype)`` pairs. (The JAX
    function's per-shard bytes wait for a sharded engine.)"""
    out = []
    for name in sorted(spec):
        leaf = spec[name]
        shape, dtype = ((leaf.shape, leaf.dtype) if hasattr(leaf, "shape")
                        else leaf)
        out.append(buffer_entry(name, shape, dtype))
    return out


def plan_total(entries) -> int:
    return int(sum(e["bytes"] for e in entries))


def chunk_class_entries(kind: str, W: int, Fc: int, Pc: int, Vc: int = 0,
                        track_paths: bool = True, index: int = 0) -> dict:
    """One capacity class of a chunked wave (checkers/chunk.py), priced,
    under the keys of JAX's ladder classes: ``{f_class, v_class, mode,
    frontier_rows, visited_rows, pair_rows, staging, staging_bytes}``
    (``f_class`` and ``v_class`` the class's ``index`` in the run). The
    staging is what the class holds on the device for the chunk: the
    ping-pong carry halves and the class-sized wave blocks — for the
    sort-merge engine (``kind="sortmerge"``) the visited keys ``[2,
    Vc]``, the frontier ``[2, W, Fc]`` and its eventually-bits, the
    parent log ``[2, Vc + 1]``, the candidates ``[W, Pc]`` with their
    keys, sorted keys and positions, and the compacted winners; for the
    hash engine (``kind="hash"``) the frontier halves at ``Pc`` columns
    (the winners of a wave always fit its candidates), the candidates,
    their keys and the insert's outputs."""
    lane = "int64"  # LANE_BYTES a lane
    if kind == "sortmerge":
        rows = [buffer_entry("vkeys_pingpong", (2, Vc), lane),
                buffer_entry("frontier_pingpong", (2, W, Fc), lane),
                buffer_entry("ebits_pingpong", (2, Fc), lane),
                buffer_entry("candidates", (W, Pc), lane),
                buffer_entry("candidate_keys", (Pc,), lane),
                buffer_entry("sorted_keys", (Pc,), lane),
                buffer_entry("sorted_pos", (Pc,), lane),
                buffer_entry("winners", (2, Fc), lane)]
        if track_paths:
            rows.append(buffer_entry("plog", (2, Vc + 1), lane))
    else:
        rows = [buffer_entry("frontier_pingpong", (2, W, Pc), lane),
                buffer_entry("ebits_pingpong", (2, Pc), lane),
                buffer_entry("candidates", (W, Pc), lane),
                buffer_entry("candidate_keys", (Pc,), lane),
                buffer_entry("insert_slot", (Pc,), lane),
                buffer_entry("winners", (Pc,), lane)]
    rows.sort(key=lambda e: e["name"])
    return dict(f_class=int(index), v_class=int(index), mode=kind,
                frontier_rows=int(Fc), visited_rows=int(Vc),
                pair_rows=int(Pc), staging=rows,
                staging_bytes=plan_total(rows))


def session_resident_bytes(checker) -> dict:
    """The dominant resident bytes of a device checker from its
    configuration alone — a floor for admission, before any device
    work: the visited rows at capacity (``_visited_bytes_per_row``),
    the frontier block and the candidate block, on one device (the JAX
    function multiplies the blocks by its mesh's shards). It prices
    a lane at 4 bytes; the port carries each uint32 lane in an int64,
    so a lane is :data:`LANE_BYTES` here.
    ``{visited_bytes, frontier_bytes, cand_bytes, total_bytes}``."""
    bpr = int(checker._visited_bytes_per_row())
    W = int(checker.encoded.width)
    K = int(checker.encoded.max_actions)
    F = int(checker.frontier_capacity)
    visited = int(checker.capacity) * bpr
    frontier = F * W * LANE_BYTES
    cand = getattr(checker, "cand_capacity", None)
    if cand in (None, "auto"):
        cand = F * K  # the no-compaction static bound
    cand_bytes = int(cand) * W * LANE_BYTES
    return dict(
        visited_bytes=int(visited),
        frontier_bytes=int(frontier),
        cand_bytes=int(cand_bytes),
        total_bytes=int(visited + frontier + cand_bytes),
    )



def fused_session_bytes(fused, n_sessions: int) -> dict:
    """The admission floor of a fused batch of ``n_sessions`` sessions
    (batch.py): :func:`session_resident_bytes` over the fused engine's
    configuration, plus ``n_sessions`` and ``per_session_bytes``, each
    session's even share. Configuration only, as the solo floor. A lane
    is :data:`LANE_BYTES` here, where the JAX function prices it at 4
    bytes (see :func:`session_resident_bytes`)."""
    plan = session_resident_bytes(fused)
    plan["n_sessions"] = int(n_sessions)
    plan["per_session_bytes"] = plan["total_bytes"] // max(1, int(n_sessions))
    return plan

def v_class_entries(v_ladder, nf_max: int) -> list:
    """Per-visited-class merge-scratch rows: the member and merge
    passes read ``[0, V_v)`` and write the merged ``[0, V_v + NF)``
    block, two uint32 key limbs (8 bytes) a row."""
    return [
        dict(v_class=vc, visited_rows=int(v),
             merge_scratch_bytes=int((v + nf_max) * 8))
        for vc, v in enumerate(v_ladder)
    ]


def decide_hot_rows(capacity: int, v_min: int, v_ladder_step: int,
                    frontier_capacity: int, budget_bytes: int) -> int:
    """The hot/cold split of the tiered visited set (tier.py): the
    largest visited class (``v_min`` times powers of ``v_ladder_step``,
    up to ``capacity``) whose resident keys and merge scratch, ``2 * (V
    + F) * 8`` bytes, fit ``budget_bytes`` becomes the hot-tier
    ceiling. ``capacity`` when the whole ladder fits (the tier stays
    dormant); ``v_min`` when even that class does not fit."""
    F = int(frontier_capacity)
    hot = int(min(v_min, capacity))
    v = hot
    while v < capacity:
        v = min(v * v_ladder_step, capacity)
        if 2 * (v + F) * 8 > budget_bytes:
            break
        hot = v
    return hot


def tier_frontier_headroom(capacity: int, frontier_capacity: int,
                           cand_capacity) -> dict:
    """The tiered frontier-headroom bound of an engine that bounds a
    wave's PROVISIONAL winners (hot-new rows before the cold membership
    pass) by its frontier: only the candidate budget ``B`` bounds them,
    so ``B <= F`` proves the bound and ``B > F`` leaves it to the load.

    ``{holds, capacity, frontier_capacity, cand_capacity,
    required_frontier, message}``: ``holds`` True, False (``message``
    says why, ``required_frontier`` is ``B``) or None with no message
    while the budget is unresolved (``None`` or ``"auto"``).

    The port's engine does not need it: it tests cold membership before
    the commit, so its frontier bounds only truly new rows, as in a
    resident run."""
    C = int(capacity)
    F = int(frontier_capacity)
    if cand_capacity in (None, "auto"):
        return dict(holds=None, capacity=C, frontier_capacity=F,
                    cand_capacity=cand_capacity, required_frontier=None,
                    message=None)
    B = int(cand_capacity)
    holds = B <= F
    message = None
    if not holds:
        message = (
            "tiered-mode frontier-headroom bound: provisional "
            "winners (hot-tier-new rows before the cold membership "
            "pass) are bounded only by the candidate budget "
            f"cand_capacity={B}, which exceeds "
            f"frontier_capacity={F} — a frontier that fits the "
            "all-resident run may overflow once the hot tier "
            f"spills. Raise frontier_capacity to {B} "
            "(tier_headroom_policy='bump' does this before device "
            "work), or accept the mid-run f_overflow risk "
            "(tier_headroom_policy='warn', the default)."
        )
    return dict(holds=holds, capacity=C, frontier_capacity=F,
                cand_capacity=cand_capacity, required_frontier=B,
                message=message)


# -- live watermarks ------------------------------------------------------


def device_bytes_in_use(device=None) -> tuple[Optional[int], Optional[str]]:
    """``(bytes, source)``: on a CUDA device, the caching allocator's
    allocated bytes (what ``torch.cuda.memory_allocated(device)``
    returns) as ``"memory_stats"``; on the CPU ``(None, None)`` — torch
    keeps no registry of live CPU tensors, so there is nothing to read.
    It never blocks on device work. It reads the nested statistics
    directly: ``memory_allocated`` flattens and sorts all of them first,
    several times the cost, and a traced run polls once a wave."""
    import torch

    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None, None
    stats = torch.cuda.memory_stats_as_nested_dict(dev)
    return int(stats["allocated_bytes"]["all"]["current"]), "memory_stats"


# -- rendering ------------------------------------------------------------


def format_bytes(n) -> str:
    """Human-readable byte count ('-' for None)."""
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024.0 or unit == "GB":
            return (f"{n:,.0f} {unit}" if unit == "B"
                    else f"{n:,.2f} {unit}")
        n /= 1024.0
    return f"{n:,.2f} GB"


def write_memory_artifact(summary: dict, root: Optional[str] = None) -> str:
    """Write one ``MEM_r*.json`` artifact: the memory summary of a traced
    run (``telemetry.memory_summary``, ``tools/mem_report.py --json``),
    numbered in its own round sequence (``MEM_r01`` first) since it is
    derived from a TRACE and names it in its ``trace`` field. The root
    is artifacts.py's unless given."""
    from .artifacts import artifact_path, next_round, provenance, repo_root

    root = repo_root() if root is None else root
    path = artifact_path("MEM", "json", root=root,
                         round=next_round(root, stems=("MEM",)))
    doc = dict(summary)
    doc.setdefault("provenance", provenance())
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return path
