"""Deterministic fault injection: the harness that proves the
checkpoint and resume path (checkpoint.py) recovers.

The port of the JAX package's ``faultinject`` module, standard library
only. A chunk is what the engine runs between two host syncs: up to
``waves_per_sync`` waves on the single-device engines
(checkers/chunk.py), one wave on the sharded engines, the tiered run and
the fused batch. A fault's ``chunk`` is the 0-based index of a chunk
among the chunks the current attempt has run (a supervised retry, or a
resumed run, counts from 0 again, so a fault armed once cannot trip
itself twice).

* **process kill at a chunk boundary**: the engines call :func:`fire`
  at the two seams a real preemption lands on, JAX's: the chunk
  boundary (after the chunk's snapshot write) and mid-chunk (after the
  chunk's waves are issued, before its host sync); an armed ``kill``
  fault
  ``os._exit``\\ s there, as a preempted machine or an OOM killer does
  (no atexit, nothing flushed);
* **mid-chunk device exception**: an armed ``raise`` fault throws
  :class:`InjectedFault` at the same seams, the model of a device error
  surfacing at a sync; the supervisor (``checkpoint.supervised_run``)
  retries from the last snapshot;
* **torn or corrupt snapshot**: :func:`corrupt_snapshot` truncates or
  bit-flips a written snapshot, which resume must detect and refuse
  with ``SnapshotCorruptError``;
* **stale manifest**: :func:`stale_manifest` rewrites the manifest
  (wrong git SHA, wrong encoding fingerprint) with VALID checksums,
  which resume must refuse with ``SnapshotStaleError``;
* **chunk hang**: a ``hang`` sleeps ``hang_sec`` (default 30 s) at its
  site instead of raising; only the watchdog (the engines'
  ``watchdog_factor``) sees it;
* **per-shard faults and the collective seam**: the sharded engines
  (parallel/) fire the ``collective_seam`` site at each wave's exchange,
  after its host sync and before any row moves between shards, and pass
  their live shard ids to every site, so a ``shard_fault`` (one dead
  device of the list, persistent) fires until a degrade drops its shard.
  A single-device engine never reaches the collective seam, and its
  shard is 0.

Faults arm programmatically (:func:`arm`) or through the ``STPU_FAULTS``
environment variable, the JAX package's: a comma-separated list of
``<action>@<site>:<chunk>[:<arg>]`` specs, e.g.
``STPU_FAULTS="kill@chunk_boundary:2"`` or ``"hang@mid_chunk:1:20"``
(arg: seconds). Each armed fault fires once, except ``shard_fault``.

Each firing emits a ``fault_injected`` telemetry event (telemetry.py;
a no-op without a tracer), before the fault acts: a kill's event dies
with the process, as a real kill's would.
"""

from __future__ import annotations

import os
import time
from typing import Optional

SITES = ("chunk_boundary", "mid_chunk", "collective_seam")
ACTIONS = ("raise", "kill", "hang", "shard_fault")

#: exit code of an injected process kill (SIGKILL's 128 + 9, so a driver
#: tells the injected death from an assertion failure)
KILL_EXIT_CODE = 137

#: default sleep of an injected hang: long enough that any derived
#: watchdog deadline expires first
DEFAULT_HANG_SEC = 30.0


class InjectedFault(RuntimeError):
    """A deterministically injected fault (the ``raise`` action),
    carrying its site and wave so the supervisor's recovery warning
    names what fired."""

    def __init__(self, site: str, chunk: int):
        super().__init__(
            f"injected fault at {site} (chunk {chunk}) — "
            "stateright_tpu_torch/faultinject.py"
        )
        self.site = site
        self.chunk = chunk


class InjectedShardFault(InjectedFault):
    """A persistent per-shard device fault (``shard_fault``): one dead
    chip of a mesh, carrying its shard id."""

    def __init__(self, site: str, chunk: int, shard: int):
        RuntimeError.__init__(
            self,
            f"injected persistent device fault on shard {shard} at "
            f"{site} (chunk {chunk}) — stateright_tpu_torch/faultinject.py"
        )
        self.site = site
        self.chunk = chunk
        self.shard = int(shard)


_ARMED: list[dict] = []
_ENV_PARSED = False


def parse_spec(spec: str) -> dict:
    """One ``<action>@<site>:<chunk>[:<arg>]`` spec -> an armed-fault
    dict. The trailing arg is the hang's seconds (``hang``) or the shard
    id (``shard_fault``)."""
    try:
        action, rest = spec.split("@", 1)
        parts = rest.split(":")
        site = parts[0]
        chunk_i = int(parts[1])
        arg = parts[2] if len(parts) > 2 else None
        if len(parts) > 3:
            raise ValueError("too many fields")
    except (ValueError, IndexError) as exc:
        raise ValueError(
            f"bad fault spec {spec!r} (want "
            "<action>@<site>:<chunk>[:<arg>], e.g. "
            "kill@chunk_boundary:2, hang@mid_chunk:1:20, "
            "shard_fault@mid_chunk:1:0)"
        ) from exc
    if action not in ACTIONS:
        raise ValueError(f"unknown fault action {action!r} (use one of "
                         f"{ACTIONS})")
    if site not in SITES:
        raise ValueError(f"unknown fault site {site!r} (use one of "
                         f"{SITES})")
    f = dict(action=action, site=site, chunk=chunk_i, once=True)
    if action == "hang":
        f["hang_sec"] = (float(arg) if arg is not None
                         else DEFAULT_HANG_SEC)
    elif action == "shard_fault":
        # persistent: a dead chip stays dead
        f["shard"] = int(arg) if arg is not None else 0
        f["once"] = False
    elif arg is not None:
        raise ValueError(
            f"fault spec {spec!r}: trailing arg is only meaningful "
            "for hang (seconds) and shard_fault (shard id)"
        )
    return f


def arm(action: str, site: str, chunk: int, once: bool = True,
        shard: Optional[int] = None,
        hang_sec: Optional[float] = None) -> None:
    """Arm one fault programmatically. ``shard_fault`` is always
    persistent (``once`` is ignored)."""
    if action not in ACTIONS:
        raise ValueError(f"unknown fault action {action!r}")
    if site not in SITES:
        raise ValueError(f"unknown fault site {site!r}")
    f = dict(action=action, site=site, chunk=int(chunk), once=once)
    if action == "shard_fault":
        f["shard"] = int(shard or 0)
        f["once"] = False
    if action == "hang":
        f["hang_sec"] = float(
            hang_sec if hang_sec is not None else DEFAULT_HANG_SEC
        )
    _ARMED.append(f)


def disarm_all() -> None:
    """Clear every armed fault (test teardown)."""
    _ARMED.clear()


def armed() -> list[dict]:
    """The currently armed faults (copies)."""
    _parse_env()
    return [dict(f) for f in _ARMED]


def _parse_env() -> None:
    global _ENV_PARSED
    if _ENV_PARSED:
        return
    _ENV_PARSED = True
    env = os.environ.get("STPU_FAULTS", "").strip()
    if not env:
        return
    for spec in env.split(","):
        spec = spec.strip()
        if spec:
            _ARMED.append(parse_spec(spec))


def chunk_for_seed(seed: int, n_chunks: int) -> int:
    """A seeded wave pick in ``[0, n_chunks)``: one LCG step, the same on
    every platform."""
    if n_chunks <= 0:
        return 0
    return (seed * 1103515245 + 12345) % n_chunks


def fire(site: str, chunk: int, shards=None) -> None:
    """The engine-side hook: fire the first armed fault matching
    ``(site, chunk)``, after its ``fault_injected`` event. ``raise``
    throws :class:`InjectedFault`; ``kill`` ``os._exit``\\ s with
    :data:`KILL_EXIT_CODE`; ``hang`` sleeps its armed seconds;
    ``shard_fault`` raises :class:`InjectedShardFault` at
    every chunk at or past its armed one while its shard is in
    ``shards`` (None: one device, shard 0). With nothing armed this is a
    list check."""
    _parse_env()
    if not _ARMED:
        return
    for f in _ARMED:
        if f["site"] != site:
            continue
        if f["action"] == "shard_fault":
            if chunk < f["chunk"]:
                continue
            if shards is not None and f["shard"] not in shards:
                continue
            if shards is None and f["shard"] != 0:
                continue
        elif f["chunk"] != chunk:
            continue
        if f["once"]:
            _ARMED.remove(f)
        from . import telemetry

        telemetry.emit(
            "fault_injected", site=site, chunk=int(chunk),
            action=f["action"],
            **({"shard": f["shard"]}
               if f["action"] == "shard_fault" else {}))
        if f["action"] == "kill":
            # a real preemption: no cleanup, no atexit, nothing flushed
            os._exit(KILL_EXIT_CODE)
        if f["action"] == "hang":
            time.sleep(f["hang_sec"])
            return
        if f["action"] == "shard_fault":
            raise InjectedShardFault(site, chunk, f["shard"])
        raise InjectedFault(site, chunk)


# -- snapshot damage ----------------------------------------------------------


def corrupt_snapshot(path: str, mode: str = "truncate",
                     seed: int = 0) -> None:
    """Damage a written snapshot in place, deterministically:
    ``truncate`` keeps the first half of the file; ``flip`` flips bits
    at 8 seed-jittered offsets across the middle half (where the
    checksummed buffers lie). Resume must refuse either with
    ``SnapshotCorruptError``."""
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "r+b") as fh:
            fh.truncate(max(size // 2, 1))
        return
    if mode == "flip":
        base = size // 4 + (seed * 2654435761) % max(size // 16, 1)
        step = max(size // 16, 1)
        with open(path, "r+b") as fh:
            for k in range(8):
                off = min(base + k * step, size - 1)
                fh.seek(off)
                b = fh.read(1)
                fh.seek(off)
                fh.write(bytes([b[0] ^ 0x10]))
        return
    raise ValueError(f"unknown corruption mode {mode!r} "
                     "(use truncate|flip)")


def stale_manifest(path: str, field: str = "git_sha",
                   value: Optional[str] = None) -> None:
    """Rewrite one manifest field with the buffer checksums left valid:
    ``git_sha`` (a different commit) or ``encoding`` (a different
    model). Resume must refuse with ``SnapshotStaleError``."""
    from . import checkpoint

    manifest, buffers = checkpoint._read_raw(path)
    if field == "git_sha":
        manifest["git_sha"] = value or "0" * 40
    elif field == "encoding":
        manifest["encoding"] = value or "bogus-encoding/W0/K0"
    else:
        raise ValueError(f"unknown stale field {field!r} "
                         "(use git_sha|encoding)")
    checkpoint._write_file(path, manifest, buffers)
