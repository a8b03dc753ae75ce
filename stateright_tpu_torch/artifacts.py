"""Run-artifact conventions: round numbering and provenance.

A copy of the parts of the JAX package's ``artifacts`` module that the
port's run telemetry needs (telemetry.py): the round numbering of the
``<STEM>_rNN.<ext>`` artifacts (:func:`next_round`,
:func:`artifact_path`, :func:`latest_artifact`) and the provenance block
every artifact embeds (:func:`provenance`). ``TRACE_r*`` pairs share
one round sequence with the ``BENCH``/``LINT``/``MULTICHIP`` artifacts;
``MEM_r*``, ``LAT_r*``, ``SLO_r*``, ``SOUND_r*`` and ``CKPT_r*`` each
number in a sequence of their own (``next_round(root, stems=("MEM",))``);
:func:`latest_slo_summary` cross-references the newest SLO gate,
:func:`latest_serve_summary` the newest service report (``SERVE_r*``),
:func:`latest_soundness_summary` the newest soundness certificate and
:func:`latest_ckpt_summary` the newest crash matrix
(tools/crash_matrix.py).

The artifacts' root is :func:`repo_root` unless the caller names one,
or the ``STPU_TORCH_ARTIFACT_ROOT`` environment variable does.

Where the JAX block names jax, jaxlib and the XLA backend, this one
names ``torch``, its CUDA version, and the card: its name and power
limit as ``nvidia-smi --query-gpu=name,power.limit`` reports them (a
card set below its maximum power runs slower under load, so a number
is comparable only beside its limit).
"""

from __future__ import annotations

import functools
import glob
import json
import os
import re
import subprocess
import sys

#: every artifact family that shares the one round sequence (stem of
#: ``<STEM>_rNN.<ext>``)
ARTIFACT_STEMS = ("BENCH", "LINT", "MULTICHIP", "TRACE")

#: the environment variable that moves the default artifacts' root
ROOT_ENV = "STPU_TORCH_ARTIFACT_ROOT"


def repo_root() -> str:
    """Where artifacts land by default: ``$STPU_TORCH_ARTIFACT_ROOT``
    when set, else the repo root this package sits in."""
    env = os.environ.get(ROOT_ENV)
    if env:
        return env
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def next_round(root: str | None = None,
               stems: tuple = ARTIFACT_STEMS) -> int:
    """The next free round number: one past the highest ``_rNN`` of any
    listed artifact family (any extension)."""
    root = repo_root() if root is None else root
    best = 0
    for stem in stems:
        for p in glob.glob(os.path.join(root, f"{stem}_r*.*")):
            m = re.search(r"_r(\d+)\.", os.path.basename(p))
            if m:
                best = max(best, int(m.group(1)))
    return best + 1


def artifact_path(stem: str, ext: str = "json",
                  root: str | None = None,
                  round: int | None = None) -> str:
    """``<root>/<stem>_rNN.<ext>``, auto-numbered unless ``round`` is
    pinned (pin it to write a pair, ``TRACE_rNN.jsonl`` and
    ``TRACE_rNN.trace.json``, into one round)."""
    root = repo_root() if root is None else root
    if round is None:
        round = next_round(root)
    return os.path.join(root, f"{stem}_r{round:02d}.{ext}")


def latest_artifact(stem: str, root: str | None = None) -> str | None:
    """The highest-round artifact of one family, or None. Ties within a
    round break to the first basename (the JSONL over the Chrome
    export)."""
    root = repo_root() if root is None else root
    best, path = -1, None
    for p in sorted(glob.glob(os.path.join(root, f"{stem}_r*.*")),
                    key=os.path.basename):
        m = re.search(r"_r(\d+)\.", os.path.basename(p))
        if m and int(m.group(1)) > best:
            best, path = int(m.group(1)), p
    return path


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _git_dirty(root: str) -> bool | None:
    """True when the working tree has uncommitted changes, False when
    clean, None when git cannot answer."""
    try:
        out = subprocess.run(["git", "status", "--porcelain"], cwd=root,
                             capture_output=True, text=True, timeout=10)
        if out.returncode == 0:
            return bool(out.stdout.strip())
    except (OSError, subprocess.SubprocessError):
        pass
    return None


@functools.lru_cache(maxsize=4)
def _git_sha(root: str) -> str | None:
    """HEAD's SHA, read once a process for each root (the tree does not
    move under a run), or None when git cannot answer."""
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=root,
                             capture_output=True, text=True, timeout=10)
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return None


@functools.lru_cache(maxsize=1)
def _card() -> tuple:
    """``(name, power limit)`` of the first card from ``nvidia-smi``, or
    ``(None, None)`` where it cannot answer. Read once a process: the
    card does not change under a run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None, None
    if out.returncode != 0 or not out.stdout.strip():
        return None, None
    first = out.stdout.strip().splitlines()[0]
    name, _, limit = first.rpartition(",")
    return (name.strip() or None), (limit.strip() or None)


def provenance(lane: dict | None = None) -> dict:
    """The context block every artifact embeds: Python, torch and its
    CUDA version, the device the numbers were measured on (the card's
    name and power limit), the git SHA of the code, and the lane
    config. Best effort: a field the environment cannot answer is None,
    never a raise."""
    out: dict = {
        "python": sys.version.split()[0],
        "torch": None,
        "cuda": None,
        "backend": None,
        "device_kind": None,
        "device_count": None,
        "power_limit": None,
        "git_sha": _git_sha(_package_root()),
    }
    try:
        import torch

        out["torch"] = torch.__version__
        out["cuda"] = torch.version.cuda
        if torch.cuda.is_available():
            out["backend"] = "cuda"
            out["device_count"] = torch.cuda.device_count()
            out["device_kind"] = torch.cuda.get_device_name(0)
            name, limit = _card()
            out["power_limit"] = limit
            out["device_kind"] = out["device_kind"] or name
        else:
            out["backend"] = "cpu"
            out["device_count"] = 0
    except Exception:  # a stripped environment: still writable
        pass
    if lane is not None:
        out["lane"] = lane
    return out


def latest_serve_summary(root: str | None = None) -> dict | None:
    """Cross-reference block of the newest ``SERVE_r*.json`` (the
    resident service's session report, serve.py
    ``write_serve_artifact``): artifact name, the SHA that produced it,
    whether that is HEAD of a clean tree, the session count, the first
    warm-vs-cold pairing (cold and warm time to verdict, the compile and
    dispatch deltas). Best effort: a missing, hand-edited or truncated artifact
    gives None, never a raise."""
    path = latest_artifact("SERVE", root)
    if path is None:
        return None
    try:
        with open(path) as fh:
            report = json.load(fh)
        sessions = report.get("sessions")
        if not isinstance(sessions, list) or not sessions:
            return None
        prov = report.get("provenance")
        serve_sha = (prov.get("git_sha")
                     if isinstance(prov, dict) else None)
        wvc = report.get("warm_vs_cold")
        warm_block = None
        if isinstance(wvc, list) and wvc:
            wvc = wvc[0]
        if isinstance(wvc, dict):
            warm_block = {
                k: wvc.get(k)
                for k in ("cold_ttv_sec", "warm_ttv_sec",
                          "ttv_delta_sec", "compile_delta_sec",
                          "dispatch_net_delta_sec", "warm_start")
            }
    except (OSError, ValueError, TypeError, AttributeError, KeyError):
        return None
    repo = repo_root() if root is None else root
    head = _git_sha(repo)
    dirty = _git_dirty(repo)
    return {
        "artifact": os.path.basename(path),
        "git_sha": serve_sha,
        "sha_matches_head": (
            serve_sha == head
            if serve_sha is not None and head is not None
            and dirty is False
            else None
        ),
        "sessions": len(sessions),
        "warm_vs_cold": warm_block,
    }


def latest_slo_summary(root: str | None = None) -> dict | None:
    """Cross-reference block of the newest ``SLO_r*.json`` (the SLO gate
    evaluation, metrics.py ``evaluate_slo``): artifact name, the SHA that
    produced it, whether that is HEAD of a clean tree, the overall
    verdict and each objective's status. Best effort: a missing,
    hand-edited or truncated artifact gives None, never a raise."""
    path = latest_artifact("SLO", root)
    if path is None:
        return None
    try:
        with open(path) as fh:
            report = json.load(fh)
        evaluation = report.get("evaluation")
        if not isinstance(evaluation, dict):
            return None
        objectives = {
            o["objective"]: o["status"]
            for o in evaluation.get("objectives") or []
            if isinstance(o, dict)
        }
        prov = report.get("provenance")
        slo_sha = prov.get("git_sha") if isinstance(prov, dict) else None
    except (OSError, ValueError, TypeError, AttributeError, KeyError):
        return None
    repo = repo_root() if root is None else root
    head = _git_sha(repo)
    dirty = _git_dirty(repo)
    return {
        "artifact": os.path.basename(path),
        "git_sha": slo_sha,
        "sha_matches_head": (
            slo_sha == head
            if slo_sha is not None and head is not None and dirty is False
            else None
        ),
        "ok": bool(evaluation.get("ok")),
        "objectives": dict(sorted(objectives.items())),
    }


def latest_soundness_summary(root: str | None = None) -> dict | None:
    """Cross-reference block of the newest ``SOUND_r*.json`` (reduction
    soundness certificates, analysis/soundness.py): artifact name, clean
    flag (every checked spec certified), the SHA that produced it,
    whether that is HEAD of a clean tree, and the per-spec status map.
    Best effort: a missing, hand-edited or truncated artifact gives
    None, never a raise."""
    path = latest_artifact("SOUND", root)
    if path is None:
        return None
    try:
        with open(path) as fh:
            report = json.load(fh)
        specs_block = report.get("specs")
        if not isinstance(specs_block, dict) or not specs_block:
            return None
        specs = {
            str(name): str(s["status"])
            for name, s in specs_block.items()
            if isinstance(s, dict) and "status" in s
        }
        prov = report.get("provenance")
        sound_sha = prov.get("git_sha") if isinstance(prov, dict) else None
    except (OSError, ValueError, TypeError, AttributeError, KeyError):
        return None
    if not specs:
        return None
    repo = repo_root() if root is None else root
    head = _git_sha(repo)
    dirty = _git_dirty(repo)
    return {
        "artifact": os.path.basename(path),
        "clean": bool(report.get("clean")),
        "git_sha": sound_sha,
        "sha_matches_head": (
            sound_sha == head
            if sound_sha is not None and head is not None and dirty is False
            else None
        ),
        "specs": dict(sorted(specs.items())),
    }


def latest_ckpt_summary(root: str | None = None) -> dict | None:
    """Cross-reference block of the newest ``CKPT_r*.json`` (the crash
    matrix, tools/crash_matrix.py): artifact name, clean flag (every
    cell recovered, refused or continue-degraded), the SHA that produced
    it, whether that is HEAD of a clean tree, each cell's verdict and,
    where cells landed on continue-degraded, their shard counts before
    and after. Best effort: a missing, hand-edited or truncated artifact
    gives None, never a raise."""
    path = latest_artifact("CKPT", root)
    if path is None:
        return None
    try:
        with open(path) as fh:
            report = json.load(fh)
        cells = report.get("cells")
        if not isinstance(cells, dict) or not cells:
            return None
        cell_verdicts = {
            str(name): str(c.get("verdict"))
            for name, c in cells.items() if isinstance(c, dict)
        }
        prov = report.get("provenance")
        ckpt_sha = prov.get("git_sha") if isinstance(prov, dict) else None
    except (OSError, ValueError, TypeError, AttributeError, KeyError):
        return None
    if not cell_verdicts:
        return None
    repo = repo_root() if root is None else root
    head = _git_sha(repo)
    dirty = _git_dirty(repo)
    out = {
        "artifact": os.path.basename(path),
        "clean": bool(report.get("clean")),
        "git_sha": ckpt_sha,
        "sha_matches_head": (
            ckpt_sha == head
            if ckpt_sha is not None and head is not None and dirty is False
            else None
        ),
        "cells": dict(sorted(cell_verdicts.items())),
    }
    deg = report.get("degrade_cells")
    if isinstance(deg, dict) and deg:
        out["degrade_cells"] = {
            str(k): v for k, v in sorted(deg.items())
            if isinstance(v, dict)
        }
    return out
