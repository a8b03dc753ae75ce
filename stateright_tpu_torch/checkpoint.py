"""Checkpoints, resume and supervised fault recovery for the wave engines.

The port of the single-device half of the JAX package's ``checkpoint``
module. A snapshot is taken at a wave's one host sync, every
``checkpoint_every`` waves, and a preempted, OOM-killed or crashed run
resumes from it instead of from the init states.

**Snapshot format: the JAX package's.** One ``.npz`` file holds every
leaf of the JAX engine's chunk carry, under the JAX leaf names, plus a
JSON manifest under the reserved ``__manifest__`` entry: version, git
SHA, encoding fingerprint, engine family, shard count, capacities,
wave, depth and unique count at capture, and a CRC-32 of every buffer
and of the manifest itself. A write is atomic (temp file, fsync,
``os.replace``), so a crash mid-write leaves the previous snapshot
whole; a torn or bit-flipped file fails the zip or CRC checks and is
refused with :class:`SnapshotCorruptError`. Nothing is pickled.

* the sort-merge family (``vkeys``, ``plog``, ``pl_n``, ``frontier``,
  ``fval``, ``ebits``, ``n_frontier``, ``depth``, ``waves``,
  ``gen_lo``/``gen_hi``, ``new``, ``disc_found``/``disc_lo``/
  ``disc_hi``) — visited keys as ``(lo, hi)`` uint32 limbs, the
  frontier lane-major ``[W, n]``, the parent log with parent limbs in
  lanes 0-1 and child limbs in lanes 2-3; a tiered run adds its cold
  runs (``tier_run0_{i}_lo/hi``), its host parent log (``tier_plog``),
  ``n_hot`` and the manifest's ``tier`` block;
* the hash family (``t_lo``/``t_hi`` and ``p_lo_t``/``p_hi_t`` in slot
  order, the frontier ROW-major ``[n, W]``, and the same counters).

What the port writes differs from the JAX engine's by design, and JAX's
``load_snapshot`` reads either:

* **A chunk is one wave.** Both port engines sync once a wave, so
  ``waves_per_sync`` is 1 in the manifest, the cadence counts waves, and
  a fault site's chunk is a wave index. A JAX snapshot taken at more
  waves a sync resumes from the wave boundary it is.
* **Buffers are sized to fit.** The port sizes its waves exactly, so
  each leaf is written at its live size (``vkeys uint32[2, U]``,
  ``frontier [W, n]``, ``plog [4, pl_n]``), not at JAX's padded
  capacities. The manifest's ``capacity`` and ``frontier_capacity`` are
  the checker's; on resume a state the target's capacities cannot hold
  raises the engine's overflow error, and any other capacity
  difference is no re-layout on one device. (A hash table's slot count
  is its layout: it must match.)
* **Resume goes one way across packages.** A JAX snapshot resumes on
  the port to JAX's counts, discoveries and paths; a port snapshot
  passes JAX's ``load_snapshot``, but JAX's ``build_resume_carry``
  wants its own padded shapes, so a port snapshot does not resume on
  the JAX engine. Across packages only hand encodings resume: a
  compiled encoding's identity hashes its spec functions, and the
  port's specs are not JAX's (:func:`encoding_fingerprint`).
* **One device.** A snapshot of a mesh run (``n_shards > 1``) is
  refused; the re-shard comes with the multi-GPU engines (ROADMAP item
  15).
* **No telemetry yet** (ROADMAP item 17): what the JAX module emits as
  ``checkpoint``, ``fault_recovery`` and ``watchdog_timeout`` events
  lands in ``checker.metrics`` (``snapshots``, ``snapshot_bytes``,
  ``snapshot_write_sec`` and of it ``snapshot_capture_sec``,
  ``resume_load_sec`` and of it ``resume_read_sec`` and
  ``resume_host_sec``, then the run's ``resume_upload_sec``,
  ``fault_recoveries``) and in a ``RuntimeWarning`` where JAX warns.

**Resume** (:func:`resume_from`) validates the snapshot (staleness is
refused, never guessed around: an encoding fingerprint that differs, or
a git SHA that differs from HEAD unless ``allow_sha_mismatch``) and
stages it in host memory; the engine's next attempt uploads it. A
sort-merge state goes through :func:`~stateright_tpu_torch.convert.
carry_from_numpy`, which packs and checks the visited keys once; a JAX tiered snapshot's pending wave is committed on
the host first through the port's ``ColdStore.member``, as JAX's fold
commits it (:func:`_fold_tier_snapshot`). A hash table is rebuilt with
``DeviceHashSet.from_keys``, never copied raw: an empty slot's tag must
be 0 for the CUDA insert to pick its winner (csrc/hashset.cu).

**Supervision** (:func:`supervised_run`): the engines' ``_run`` goes
through it. A supervised failure — an injected fault, an OOM, a
watchdog timeout — retries from the last snapshot (or from the init
states when none was written yet) with bounded exponential backoff;
anything else raises through. Where the port differs from JAX:

* **A sticky CUDA error is not retried.** An illegal address or a
  device-side assert poisons the CUDA context, so an in-process retry
  cannot succeed; it raises through, unsupervised, and the run resumes
  in a new process from its last snapshot. Engine overflow errors are
  not supervised either (JAX's rule): re-running them would loop.
* **The OOM degrade** has no class ladder to fall back to: after two
  OOMs the sort-merge engine halves ``dense_chunk_bytes`` (the dense
  wave's step block; the sparse wave has no such knob), and every OOM
  retry first empties the CUDA allocator's cache.
* **The watchdog** (``watchdog_factor``) runs each wave's issue and
  sync on a daemon worker thread and waits at most the derived deadline
  (:func:`watchdog_deadline`). A CUDA sync cannot be cancelled, so the
  hung thread is abandoned: a truly wedged card exhausts the retries
  and raises :class:`WatchdogTimeout`. A wave writes only its attempt's
  own locals, which the host thread publishes after the wave, so a hung
  sync that returns later changes nothing of the retry.
* **No shard degrade.** :func:`classify_failure` is JAX's table without
  the straggler attribution, and there are no per-shard strikes: both
  come with the multi-GPU engines (ROADMAP item 15).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import time
import warnings
import zlib
from typing import Optional

import numpy as np

from .tier import ColdStore, pack_keys_np, unpack_keys_np

SNAPSHOT_VERSION = 1

#: the snapshot a checker writes when checkpointing is on and no path is
#: given (the JAX package's is ``stateright_tpu.ckpt``; a port run never
#: overwrites it)
DEFAULT_PATH = "stateright_tpu_torch.ckpt"

_M32 = 0xFFFFFFFF

#: a JAX tiered snapshot's deferred-commit leaves (its ``tier`` module),
#: folded on the host at resume
_TIER_LEAVES = ("pend_keys", "pend_par", "pend_n", "pend_valid",
                "n_hot", "h_loc", "pstash")

#: slots a host download copies at once: a snapshot takes no device
#: memory beyond a block
_BLOCK = 1 << 22


def auto_cadence(snapshot_sec: float, chunk_sec: float,
                 target: float = 0.05, lo: int = 1,
                 hi: int = 256) -> int:
    """``--checkpoint-every=auto``: the waves per snapshot that keep the
    snapshot overhead under ``target`` of the run's wall, from the two
    walls the run measures, ``ceil(snapshot_sec / (target *
    chunk_sec))`` clamped to ``[lo, hi]`` (JAX's rule). An unmeasured
    snapshot wall checkpoints every wave, an unmeasured wave wall at the
    cap."""
    if not snapshot_sec or snapshot_sec <= 0:
        return lo
    if not chunk_sec or chunk_sec <= 0:
        return hi
    n = math.ceil(snapshot_sec / (target * chunk_sec))
    return max(lo, min(hi, int(n)))


class SnapshotError(RuntimeError):
    """Base of every named checkpoint/resume refusal."""


class SnapshotCorruptError(SnapshotError):
    """The snapshot file is torn or corrupt (failed zip read, missing
    buffer, a CRC-32 mismatch, or contents that contradict the
    manifest)."""


class SnapshotStaleError(SnapshotError):
    """The manifest does not match the resuming checker (another
    encoding fingerprint or git SHA)."""


class SnapshotIncompatibleError(SnapshotError):
    """The snapshot cannot be restored into this engine (another family,
    ``track_paths`` flipped, a mesh snapshot, or a hash table of another
    slot count)."""


# -- identity -----------------------------------------------------------------


def encoding_fingerprint(checker) -> str:
    """What a snapshot's state MEANS, JAX's string: the encoding's class
    name, ``cache_key()``, width and action count, the property list and
    the eventually-bits seed. Equal for a hand encoding of the JAX
    package and its port (their cache keys are equal); a compiled
    encoding's differ (actor/compile.py)."""
    enc = checker.encoded
    key_fn = getattr(enc, "cache_key", None)
    ident = repr(key_fn()) if key_fn is not None else ""
    props = tuple((p.name, p.expectation.name)
                  for p in checker.model.properties())
    return (
        f"{type(enc).__name__}/{ident}/W{enc.width}/K{enc.max_actions}"
        f"/props{props!r}/ebits{checker._eventually_bits_init()}"
    )


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _git_sha() -> Optional[str]:
    """HEAD of the checkout this package sits in, or None outside a git
    checkout (a ``git archive`` copy has no ``.git``)."""
    root = _repo_root()
    if not os.path.exists(os.path.join(root, ".git")):
        return None
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=root,
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def _engine_kind(checker) -> str:
    return ("sharded" if getattr(checker, "mesh", None) is not None
            else "single")


# -- file format --------------------------------------------------------------


def _manifest_crc(manifest: dict) -> int:
    return zlib.crc32(json.dumps(manifest, sort_keys=True).encode()) & _M32


def _write_file(path: str, manifest: dict, buffers: dict) -> None:
    """Atomic snapshot write: temp file, fsync, rename. The manifest
    rides the same npz as a reserved uint8 entry, so one rename commits
    both, with its own CRC-32 (``manifest_crc32``)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    manifest = dict(manifest)
    manifest.pop("manifest_crc32", None)
    manifest["manifest_crc32"] = _manifest_crc(manifest)
    m = json.dumps(manifest, sort_keys=True).encode()
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, __manifest__=np.frombuffer(m, dtype=np.uint8),
                     **buffers)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def _read_raw(path: str) -> tuple[dict, dict]:
    """Parse the container WITHOUT the checksum checks (the stale-manifest
    helper rewrites manifests through this; everything else reads through
    :func:`load_snapshot`)."""
    if not os.path.exists(path):
        raise SnapshotError(f"no snapshot at {path}")
    try:
        with np.load(path, allow_pickle=False) as z:
            if "__manifest__" not in z.files:
                raise SnapshotCorruptError(
                    f"{path}: no manifest entry — not a snapshot, or "
                    "torn before the manifest landed")
            manifest = json.loads(bytes(z["__manifest__"].tobytes()))
            buffers = {k: np.array(z[k]) for k in z.files
                       if k != "__manifest__"}
    except SnapshotError:
        raise
    except Exception as exc:
        # BadZipFile, ValueError, OSError, EOFError, a JSON decode error:
        # every torn-file shape lands here, named
        raise SnapshotCorruptError(
            f"{path}: torn or corrupt snapshot ({type(exc).__name__}: "
            f"{exc})") from exc
    return manifest, buffers


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & _M32


def load_snapshot(path: str) -> tuple[dict, dict]:
    """Read and verify a snapshot: container, version, the manifest's
    CRC-32 and every buffer's. Raises the named errors; never returns
    partly verified data."""
    manifest, buffers = _read_raw(path)
    declared_crc = manifest.pop("manifest_crc32", None)
    if declared_crc != _manifest_crc(manifest):
        raise SnapshotCorruptError(
            f"{path}: manifest failed its CRC-32 check (bit rot or a hand "
            "edit — the metadata region is checksummed too)")
    version = manifest.get("version")
    if version != SNAPSHOT_VERSION:
        raise SnapshotIncompatibleError(
            f"{path}: snapshot version {version} != reader "
            f"{SNAPSHOT_VERSION}")
    declared = manifest.get("buffers") or {}
    for name, meta in declared.items():
        if name not in buffers:
            raise SnapshotCorruptError(
                f"{path}: buffer {name!r} declared in manifest but missing "
                "from the container")
        arr = buffers[name]
        if (list(arr.shape) != list(meta["shape"])
                or str(arr.dtype) != meta["dtype"]):
            raise SnapshotCorruptError(
                f"{path}: buffer {name!r} is {arr.dtype}{list(arr.shape)}, "
                f"manifest declares {meta['dtype']}{meta['shape']}")
        if _crc(arr) != int(meta["crc32"]):
            raise SnapshotCorruptError(
                f"{path}: buffer {name!r} failed its CRC-32 check (bit rot "
                "or a torn write)")
    for name in buffers:
        if name not in declared:
            raise SnapshotCorruptError(
                f"{path}: undeclared buffer {name!r} in the container")
    return manifest, buffers


# -- capture ------------------------------------------------------------------


def _host(t) -> np.ndarray:
    """A tensor's values in host memory, copied ``_BLOCK`` elements of
    its first dimension at a time: a strided or large device tensor is
    never made contiguous on the device."""
    if isinstance(t, np.ndarray):
        return t
    if t.device.type == "cpu":
        return t.numpy()
    out = np.empty(tuple(t.shape), np.int64)
    for i in range(0, t.shape[0], _BLOCK):
        out[i:i + _BLOCK] = t[i:i + _BLOCK].cpu().numpy()
    return out


def _u32(a: np.ndarray) -> np.ndarray:
    """uint32 lanes held in int64, as the JAX package's uint32."""
    return (np.asarray(a, np.int64) & _M32).astype(np.uint32)


def _limbs(keys) -> np.ndarray:
    """``uint32[2, n]`` (lo, hi) limbs of packed int64 keys."""
    lo, hi = unpack_keys_np(_host(keys))
    return np.stack([lo, hi]) if lo.size else np.zeros((2, 0), np.uint32)


def _plog_limbs(blocks) -> np.ndarray:
    """A parent log's ``(parent keys, child keys)`` blocks as JAX's
    ``plog uint32[4, n]``, block by block."""
    n = sum(int(c.shape[0]) for _, c in blocks)
    out = np.empty((4, n), np.uint32)
    off = 0
    for p, c in blocks:
        m = int(c.shape[0])
        out[0:2, off:off + m] = _limbs(p)
        out[2:4, off:off + m] = _limbs(c)
        off += m
    return out


def _counters(checker, *, depth: int, waves: int, generated: int,
              unique: int) -> dict:
    """The JAX carry's scalar counters and discovery lanes (indexed by
    the order of ``model.properties()``)."""
    if unique > _M32 or waves > _M32:
        raise SnapshotIncompatibleError(
            f"{unique:,} unique states or {waves:,} waves do not fit the "
            "snapshot format's uint32 counters")
    props = list(checker.model.properties())
    fps = checker._discovered_fps
    found = np.array([p.name in fps for p in props], bool)
    fp = [fps.get(p.name, 0) for p in props]
    return dict(
        depth=np.int32(depth), waves=np.uint32(waves),
        gen_lo=np.uint32(generated & _M32),
        gen_hi=np.uint32(generated >> 32), new=np.uint32(unique),
        disc_found=found,
        disc_lo=np.array([f & _M32 for f in fp], np.uint32),
        disc_hi=np.array([f >> 32 for f in fp], np.uint32),
    )


def sortmerge_buffers(checker, st, tier=None) -> tuple[dict, Optional[dict]]:
    """``(buffers, tier block)`` of a sort-merge wave state ``st``
    (checkers/tpu_sortmerge.py ``WaveState``; ``tier`` its
    ``HotColdTier`` in a tiered run), under the JAX leaf names."""
    front = _u32(_host(st.frontier))
    n = front.shape[1]
    buffers = dict(
        vkeys=_limbs(st.vkeys), frontier=front, fval=np.ones(n, bool),
        ebits=_u32(_host(st.ebits)), n_frontier=np.uint32(n),
        **_counters(checker, depth=st.depth, waves=st.waves,
                    generated=st.generated,
                    unique=checker._unique_states))
    plog = np.zeros((4, 0), np.uint32)
    if checker.track_paths and tier is None:
        plog = _plog_limbs(st.plog)
    buffers.update(plog=plog, pl_n=np.uint32(plog.shape[1]))
    if tier is None:
        return buffers, None
    cold = tier.cold
    cold.sync()  # the ingest worker is joined before the runs are read
    run_rows = []
    for s, shard in enumerate(cold.snapshot_runs()):
        rows = []
        for i, (lo, hi) in enumerate(shard):
            buffers[f"tier_run{s}_{i}_lo"] = lo
            buffers[f"tier_run{s}_{i}_hi"] = hi
            rows.append(int(lo.size))
        run_rows.append(rows)
    buffers["n_hot"] = np.uint32(st.vkeys.shape[0])
    plog_host = 0
    if checker.track_paths and tier.plog:
        buffers["tier_plog"] = _plog_limbs(tier.plog)
        plog_host = int(buffers["tier_plog"].shape[1])
    block = dict(hot_rows=tier.ceiling, max_runs=int(cold.max_runs),
                 spills=int(cold.spills), run_rows=run_rows,
                 plog_host_rows=plog_host,
                 cold_rows_total=int(cold.rows()),
                 cold_bytes_total=int(cold.bytes()))
    return buffers, block


def hash_buffers(checker, table, parents, front, ebits, *, depth: int,
                 waves: int, generated: int, unique: int) -> dict:
    """The buffers of a hash wave state (checkers/tpu.py), under the JAX
    leaf names: the table and parent keys as limbs in slot order (an
    empty slot and a root parent are ``(0, 0)``), the frontier
    row-major ``[n, W]``."""
    t = _limbs(table.keys)
    p = (_limbs(parents) if checker.track_paths
         else np.zeros((2, 0), np.uint32))
    fr = np.ascontiguousarray(_u32(_host(front)).T)
    return dict(
        t_lo=t[0], t_hi=t[1], p_lo_t=p[0], p_hi_t=p[1], frontier=fr,
        fval=np.ones(fr.shape[0], bool), ebits=_u32(_host(ebits)),
        **_counters(checker, depth=depth, waves=waves, generated=generated,
                    unique=unique))


def write_snapshot(checker, buffers: dict, path: str, *, chunk: int,
                   tier_block: Optional[dict] = None) -> dict:
    """Write one snapshot of ``buffers`` (:func:`sortmerge_buffers` or
    :func:`hash_buffers`) atomically to ``path`` with JAX's manifest, and
    return the manifest. ``chunk`` is the wave index in this attempt."""
    total = int(sum(b.nbytes for b in buffers.values()))
    manifest = dict(
        version=SNAPSHOT_VERSION,
        created_at=time.time(),
        git_sha=_git_sha(),
        engine=type(checker).__name__,
        family=checker._checkpoint_family(),
        kind=_engine_kind(checker),
        encoding=encoding_fingerprint(checker),
        width=int(checker.encoded.width),
        n_shards=1,
        capacity=int(checker.capacity),
        frontier_capacity=int(checker.frontier_capacity),
        track_paths=bool(checker.track_paths),
        waves_per_sync=1,
        chunk=int(chunk),
        wave=int(buffers["waves"]),
        depth=int(buffers["depth"]),
        unique=int(buffers["new"]),
        budget=dict(cand_capacity=checker.cand_capacity, pair_width=None,
                    auto_budget=False),
        merge_impl=("cuda" if checker.device.type == "cuda" else "plain"),
        tier=tier_block,
        snapshot_bytes=total,
        buffers={k: dict(shape=list(b.shape), dtype=str(b.dtype),
                         crc32=_crc(b))
                 for k, b in buffers.items()},
    )
    _write_file(path, manifest, buffers)
    checker._last_snapshot = path
    return manifest


# -- resume -------------------------------------------------------------------


def _refuse_stale(checker, path: str, manifest: dict,
                  allow_sha_mismatch: bool) -> None:
    enc_fp = encoding_fingerprint(checker)
    snap_fp = manifest.get("encoding")
    if snap_fp != enc_fp:
        why = ""
        if "actor-compile" in str(snap_fp) or "actor-compile" in enc_fp:
            why = (" (a compiled encoding's identity hashes its property "
                   "and boundary spec functions, and the JAX package's "
                   "specs are not the port's: across packages only hand "
                   "encodings resume)")
        raise SnapshotStaleError(
            f"{path}: snapshot encodes {snap_fp!r}, this checker expects "
            f"{enc_fp!r} — a snapshot is only resumable into the same "
            f"model/encoding{why}")
    head = _git_sha()
    snap_sha = manifest.get("git_sha")
    if (snap_sha is not None and head is not None and snap_sha != head
            and not allow_sha_mismatch):
        raise SnapshotStaleError(
            f"{path}: snapshot was written at git {snap_sha[:12]}, HEAD is "
            f"{head[:12]} — the carry layout may have changed; pass "
            "allow_sha_mismatch=True (CLI: --resume-any-sha) to resume "
            "anyway")


def _refuse_incompatible(checker, path: str, manifest: dict) -> None:
    family = checker._checkpoint_family()
    if manifest.get("family") != family:
        raise SnapshotIncompatibleError(
            f"{path}: snapshot is from the {manifest.get('family')!r} "
            f"engine family, this checker is {family!r} — the visited "
            "structures are not interconvertible")
    if bool(manifest.get("track_paths")) != bool(checker.track_paths):
        raise SnapshotIncompatibleError(
            f"{path}: snapshot track_paths={manifest.get('track_paths')}, "
            f"checker track_paths={checker.track_paths} — the parent log "
            "exists on one side only")
    if (int(manifest.get("n_shards", 1)) > 1
            or manifest.get("kind") == "sharded"):
        raise SnapshotIncompatibleError(
            f"{path}: a mesh snapshot ({manifest.get('n_shards')} shards) "
            "resumes on one device only through the re-shard, which comes "
            "with the multi-GPU engines (ROADMAP item 15)")


def resume_from(checker, path: str, *,
                allow_sha_mismatch: bool = False) -> dict:
    """Validate a snapshot against ``checker`` and stage it for the next
    run, whose state is built from it instead of the init states.
    Refuses with the named errors; returns the manifest. Does no device
    work: the upload is the run's."""
    t0 = time.monotonic()
    manifest, buffers = load_snapshot(path)
    read_sec = time.monotonic() - t0
    _refuse_stale(checker, path, manifest, allow_sha_mismatch)
    _refuse_incompatible(checker, path, manifest)
    if checker._checkpoint_family() == "sortmerge":
        staged = _stage_sortmerge(checker, path, manifest, buffers)
    else:
        staged = _stage_hash(checker, path, manifest, buffers)
    checker._resume = (manifest, staged)
    checker._resume_path = path
    # the supervisor's retry re-stages under the same staleness policy
    checker._resume_allow_sha = allow_sha_mismatch
    # the read and CRC checks, and with them the staging
    checker._ckpt_stats.update(
        resume_read_sec=round(read_sec, 6),
        resume_load_sec=round(time.monotonic() - t0, 6))
    return manifest


def _scalar(buffers: dict, name: str) -> int:
    return int(np.asarray(buffers[name]).reshape(-1)[0])


def _fold_tier_snapshot(checker, manifest: dict, buffers: dict,
                        tier_m: dict):
    """A tiered snapshot's host state, its pending wave committed: the
    cold store from the serialized runs; a JAX snapshot's provisional
    winners (``pend_*``) tested against the cold runs with
    ``ColdStore.member`` and the survivors folded into the hot prefix,
    frontier, parent log and counters, as JAX's ``_fold_tier_snapshot``
    does. A port snapshot has nothing pending. Returns ``(buffers,
    cold store, hot count, host parent-log limbs or None)``."""
    run_rows = tier_m.get("run_rows") or [[]]
    shard = []
    for i, n in enumerate(run_rows[0] if run_rows else []):
        lo = buffers.pop(f"tier_run0_{i}_lo")
        hi = buffers.pop(f"tier_run0_{i}_hi")
        if int(n) != int(lo.size):
            raise SnapshotCorruptError(
                f"tier run 0/{i}: manifest declares {n} rows, buffer has "
                f"{lo.size}")
        shard.append((lo, hi))
    cold = ColdStore.from_runs([shard], max_runs=int(
        tier_m.get("max_runs") or 8), spills=int(tier_m.get("spills") or 0))
    plog_host = buffers.pop("tier_plog", None)
    staged = {k: buffers.pop(k) for k in _TIER_LEAVES if k in buffers}
    hot = int(np.asarray(staged.get("n_hot", buffers["new"])).reshape(-1)[0])
    if not bool(staged.get("pend_valid", False)):
        return buffers, cold, hot, plog_host
    track_paths = bool(manifest["track_paths"])
    n_p = int(np.asarray(staged["pend_n"]).reshape(-1)[0])
    pend_keys = np.asarray(staged["pend_keys"], np.uint32)
    klo, khi = pend_keys[0, :n_p], pend_keys[1, :n_p]
    keep = ~cold.member(0, pack_keys_np(klo, khi))
    conf = int(keep.sum())
    vkeys = np.asarray(buffers["vkeys"], np.uint32)
    mlo = np.concatenate([vkeys[0, :hot], klo[keep]])
    mhi = np.concatenate([vkeys[1, :hot], khi[keep]])
    order = np.lexsort((mlo, mhi))
    buffers["vkeys"] = np.stack([mlo[order], mhi[order]])
    hot += conf
    frontier = np.asarray(buffers["frontier"], np.uint32)
    buffers["frontier"] = frontier[:, :n_p][:, keep]
    buffers["ebits"] = np.asarray(buffers["ebits"], np.uint32)[:n_p][keep]
    buffers["n_frontier"] = np.uint32(conf)
    if track_paths and "pend_par" in staged:
        pl = _scalar(buffers, "pl_n")
        par = np.asarray(staged["pend_par"], np.uint32)[:, :n_p][:, keep]
        buffers["plog"] = np.concatenate(
            [np.asarray(buffers["plog"], np.uint32)[:, :pl],
             np.stack([par[0], par[1], klo[keep], khi[keep]])], axis=1)
        buffers["pl_n"] = np.uint32(pl + conf)
    new_after = _scalar(buffers, "new") + conf
    found = np.asarray(buffers["disc_found"], bool)
    all_disc = bool(found.all()) if found.size else False
    target = checker.builder._target_state_count
    target_hit = target is not None and new_after >= int(target)
    cont = conf > 0 and not all_disc and not target_hit
    buffers["new"] = np.uint32(new_after)
    buffers["waves"] = np.uint32(_scalar(buffers, "waves") + 1)
    if cont:
        buffers["depth"] = np.int32(_scalar(buffers, "depth") + 1)
    else:  # the folded wave ended the search: nothing left to expand
        buffers["frontier"] = buffers["frontier"][:, :0]
        buffers["ebits"] = buffers["ebits"][:0]
        buffers["n_frontier"] = np.uint32(0)
    # the capture point moves past the folded commit
    manifest["wave"] = int(buffers["waves"])
    manifest["depth"] = int(buffers["depth"])
    manifest["unique"] = new_after
    return buffers, cold, hot, plog_host


def _untier(checker, path: str, buffers: dict, cold: ColdStore, hot: int,
            plog_host):
    """Merge a tiered snapshot's cold runs back into the visited prefix
    for a target that does not tier (JAX's un-tier), refusing when the
    whole set passes the target's capacity."""
    total = hot + cold.rows()
    if total > int(checker.capacity):
        raise SnapshotIncompatibleError(
            f"{path}: tiered snapshot holds {total:,} visited keys "
            f"({cold.rows():,} cold) but the target's capacity is "
            f"{int(checker.capacity):,} and tiering is off — raise the "
            "capacity, or resume with tier_hot_rows set to keep the cold "
            "tier")
    vk = np.asarray(buffers["vkeys"], np.uint32)[:, :hot]
    merged = np.sort(np.concatenate(
        [pack_keys_np(vk[0], vk[1])] + list(cold.runs[0])))
    lo, hi = unpack_keys_np(merged)
    buffers["vkeys"] = np.stack([lo, hi])
    if plog_host is not None and plog_host.shape[1]:
        pl = _scalar(buffers, "pl_n")
        buffers["plog"] = np.concatenate(
            [plog_host, np.asarray(buffers["plog"], np.uint32)[:, :pl]],
            axis=1)
        buffers["pl_n"] = np.uint32(buffers["plog"].shape[1])
    return buffers, total


def _stage_sortmerge(checker, path: str, manifest: dict, buffers: dict):
    """A sort-merge snapshot's ``WaveState`` in host memory, checked: a
    tiered snapshot folded (and un-tiered for a target without a tier),
    the hot prefix packed once into int64 keys and found strictly sorted
    (``convert.carry_from_numpy``), and hot plus cold rows equal to the
    unique count. ``checker._ckpt_stats`` gets the wall of the packing
    and checks."""
    from .convert import carry_from_numpy, plog_blocks

    tier_m = manifest.get("tier")
    cold = None
    plog_host = None
    if tier_m:
        buffers, cold, hot, plog_host = _fold_tier_snapshot(
            checker, manifest, buffers, tier_m)
        if getattr(checker, "tier_hot_rows", None) is None:
            buffers, hot = _untier(checker, path, buffers, cold, hot,
                                   plog_host)
            cold = plog_host = None
    else:
        hot = _scalar(buffers, "new")
    unique = _scalar(buffers, "new")
    vkeys = np.asarray(buffers["vkeys"], np.uint32)
    n_front = _scalar(buffers, "n_frontier")
    pl_n = _scalar(buffers, "pl_n") if "pl_n" in buffers else 0
    cold_rows = cold.rows() if cold is not None else 0
    if (hot > vkeys.shape[1] or n_front > buffers["frontier"].shape[1]
            or pl_n > np.asarray(buffers["plog"]).shape[1]
            or hot + cold_rows != unique):
        raise SnapshotCorruptError(
            f"{path}: counters contradict the buffers ({hot:,} hot + "
            f"{cold_rows:,} cold visited keys against {unique:,} unique, "
            f"{n_front:,} frontier rows, {pl_n:,} parent-log rows)")
    host_plog = []
    if plog_host is not None and plog_host.shape[1]:
        host_plog.append(plog_blocks(plog_host))
    gen = _scalar(buffers, "gen_lo") | (_scalar(buffers, "gen_hi") << 32)
    t0 = time.monotonic()
    try:
        st = carry_from_numpy(
            vkeys, buffers["frontier"], n_front, buffers["ebits"],
            depth=_scalar(buffers, "depth"), generated=gen, device="cpu",
            cold=cold, n_visited=hot,
            plog=buffers["plog"] if checker.track_paths else None,
            pl_n=pl_n, host_plog=host_plog, waves=_scalar(buffers, "waves"),
            disc=(buffers["disc_found"], buffers["disc_lo"],
                  buffers["disc_hi"]),
            props=list(checker.model.properties()))
    except ValueError as exc:
        raise SnapshotCorruptError(f"{path}: the visited prefix: {exc}")
    if st.vkeys.numel() != hot:  # a sentinel inside the live prefix
        raise SnapshotCorruptError(
            f"{path}: the visited prefix holds {st.vkeys.numel():,} keys "
            f"before its sentinels, the counters {hot:,}")
    checker._ckpt_stats["resume_host_sec"] = round(time.monotonic() - t0, 6)
    return st


def sortmerge_state(checker, st):
    """A staged sort-merge ``WaveState`` uploaded to the checker's
    device (a tiered run keeps its parent log on the host);
    ``checker._ckpt_stats`` gets the upload's wall."""
    t0 = time.monotonic()
    dev = checker.device
    st.vkeys, st.frontier, st.ebits = (
        st.vkeys.to(dev), st.frontier.to(dev), st.ebits.to(dev))
    if st.cold is None:
        st.plog = [(p.to(dev), c.to(dev)) for p, c in st.plog]
    if dev.type == "cuda":
        _torch().cuda.synchronize(dev)
    checker._ckpt_stats["resume_upload_sec"] = round(time.monotonic() - t0, 6)
    return st


def _stage_hash(checker, path: str, manifest: dict, buffers: dict) -> dict:
    """A hash snapshot's state in host memory: packed slot keys, parent
    keys (:data:`~stateright_tpu_torch.ops.hashset.EMPTY` where JAX has
    parent 0, a root), the live frontier rows lane-major, counters and
    discoveries."""
    C = int(np.asarray(buffers["t_lo"]).size)
    if C != int(checker.capacity):
        raise SnapshotIncompatibleError(
            f"{path}: the snapshot's table has {C:,} slots, this checker's "
            f"{int(checker.capacity):,} — a hash table's slot layout is its "
            "capacity; resume at the snapshot's capacity")
    keys = pack_keys_np(buffers["t_lo"], buffers["t_hi"])
    parents = None
    if checker.track_paths:
        parents = pack_keys_np(buffers["p_lo_t"], buffers["p_hi_t"])
    fval = np.asarray(buffers["fval"], bool).reshape(-1)
    front = np.asarray(buffers["frontier"], np.uint32)[fval]
    ebits = np.asarray(buffers["ebits"], np.uint32).reshape(-1)[fval]
    unique = _scalar(buffers, "new")
    occupied = int(((np.asarray(buffers["t_lo"]) != 0)
                    | (np.asarray(buffers["t_hi"]) != 0)).sum())
    if occupied != unique:
        raise SnapshotCorruptError(
            f"{path}: the table holds {occupied:,} keys against {unique:,} "
            "unique")
    props = list(checker.model.properties())
    found, lo, hi = (np.asarray(buffers[k]) for k in
                     ("disc_found", "disc_lo", "disc_hi"))
    discovered = {p.name: (int(hi[i]) << 32) | int(lo[i])
                  for i, p in enumerate(props) if bool(found[i])}
    return dict(
        keys=keys, parents=parents,
        frontier=np.ascontiguousarray(front.T).astype(np.int64),
        ebits=ebits.astype(np.int64), depth=_scalar(buffers, "depth"),
        waves=_scalar(buffers, "waves"),
        generated=(_scalar(buffers, "gen_lo")
                   | (_scalar(buffers, "gen_hi") << 32)),
        unique=unique, discovered=discovered,
    )


# -- failure policy -----------------------------------------------------------

#: messages of CUDA errors that poison the context: no in-process retry
#: can succeed after one
_STICKY_CUDA = ("illegal memory access", "an illegal instruction",
                "device-side assert", "unspecified launch failure",
                "misaligned address", "illegal address")


class WatchdogTimeout(RuntimeError):
    """A wave's issue and sync passed its derived watchdog deadline
    (``watchdog_factor``). Supervised: it classifies as ``hang`` and
    retries from the last snapshot; a CUDA sync cannot be cancelled, so
    the hung worker thread is abandoned, and a truly wedged card
    exhausts the retries and raises this. ``attribution`` carries the
    deadline, the rolling wave wall and the wait."""

    def __init__(self, chunk: int, deadline_sec: float,
                 attribution: Optional[dict] = None):
        super().__init__(
            f"watchdog: chunk {chunk} exceeded its derived deadline of "
            f"{deadline_sec:.2f}s with no sync — a hung wave. Its thread "
            "is abandoned (a CUDA sync cannot be cancelled); recover from "
            "the last snapshot or investigate the attribution.")
        self.chunk = int(chunk)
        self.deadline_sec = float(deadline_sec)
        self.attribution = attribution or {}


def watchdog_deadline(rolling_max_sec: Optional[float],
                      factor: float = 8.0, *, floor_sec: float = 2.0,
                      cap_sec: float = 600.0,
                      first_grace_sec: float = 300.0) -> float:
    """A wave's watchdog deadline, ``factor`` times the run's rolling
    maximum wave wall clamped to ``[floor_sec, cap_sec]``;
    ``first_grace_sec`` before any wave was measured (the first wave
    builds the kernels). JAX's rule."""
    if not factor or factor <= 0:
        raise ValueError(f"watchdog factor must be > 0: {factor}")
    if rolling_max_sec is None:
        return float(first_grace_sec)
    return float(min(cap_sec, max(floor_sec,
                                  factor * max(rolling_max_sec, 0.0))))


def _is_oom(exc: BaseException) -> bool:
    if isinstance(exc, MemoryError):
        return True
    oom = getattr(getattr(_torch(), "cuda", None), "OutOfMemoryError", None)
    if oom is not None and isinstance(exc, oom):
        return True
    s = str(exc)
    return ("RESOURCE_EXHAUSTED" in s or "Out of memory" in s
            or "out of memory" in s)


def _torch():
    import torch

    return torch


def is_sticky_cuda_error(exc: BaseException) -> bool:
    """Whether ``exc`` is a CUDA error that poisons the context (an
    illegal address, a device-side assert): never retried in-process."""
    s = str(exc)
    return any(m in s for m in _STICKY_CUDA)


def is_supervised_fault(exc: BaseException) -> bool:
    """Whether the supervisor may retry ``exc`` from a snapshot: an
    injected fault, a watchdog timeout or an OOM. A sticky CUDA error and
    the engines' overflow errors are not."""
    from .faultinject import InjectedFault

    if is_sticky_cuda_error(exc):
        return False
    if isinstance(exc, (InjectedFault, WatchdogTimeout)):
        return True
    return _is_oom(exc)


def classify_failure(exc: BaseException) -> tuple:
    """``(class, shard or None)`` of one failure, JAX's table without its
    straggler attribution (which needs the multi-GPU engines):
    :class:`WatchdogTimeout` -> ``hang``; an injected shard fault ->
    ``shard_fault`` with its shard; an OOM -> ``oom``; another supervised
    fault -> ``transient``; anything else -> ``unsupervised``."""
    from .faultinject import InjectedShardFault

    if isinstance(exc, WatchdogTimeout):
        return "hang", None
    if isinstance(exc, InjectedShardFault):
        return "shard_fault", exc.shard
    if _is_oom(exc):
        return "oom", None
    if is_supervised_fault(exc):
        return "transient", None
    return "unsupervised", None


# -- supervision --------------------------------------------------------------


def _interruptible_backoff(delay: float, checker) -> None:
    """The backoff sleep, in slices, ended early by a set
    ``cancel_event`` (the hybrid racer's loser)."""
    deadline = time.monotonic() + delay
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return
        ev = getattr(checker, "cancel_event", None)
        if ev is not None and ev.is_set():
            return
        time.sleep(min(remaining, 0.05))


def supervised_run(checker, reporter=None) -> None:
    """The retry loop around one engine run (``checker._run``): a
    supervised failure retries from the last snapshot — or from the
    init states when the run checkpoints and none was written yet —
    after a backoff of ``retry_backoff_sec * 2**(attempt - 1)`` (at most
    30 s), up to ``max_fault_retries`` times, with a ``RuntimeWarning``
    each time; the retries count in ``metrics["fault_recoveries"]``.
    After two OOMs the engine degrades (``_degrade_memory_lean``).
    Anything else, and a supervised failure past the retries, raises
    through."""
    attempts = ooms = 0
    while True:
        try:
            return checker._run_attempt(reporter)
        except Exception as exc:
            if not is_supervised_fault(exc):
                raise
            kind, _ = classify_failure(exc)
            snap = checker._last_snapshot or checker._resume_path
            if ((not checker.checkpoint_every and snap is None)
                    or (snap is None and checker._started_from_state)
                    or attempts >= checker.max_fault_retries):
                raise
            attempts += 1
            delay = min(checker.retry_backoff_sec * 2 ** (attempts - 1),
                        30.0)
            warnings.warn(
                f"supervised recovery [{kind}]: {type(exc).__name__} on "
                f"wave execution ({exc}); retry {attempts}/"
                f"{checker.max_fault_retries} from "
                + (f"snapshot {os.path.basename(snap)}" if snap
                   else "the init states")
                + f" after {delay:.2f}s backoff",
                RuntimeWarning, stacklevel=2)
            checker._ckpt_stats["fault_recoveries"] = attempts
            if kind == "oom":
                ooms += 1
                torch = _torch()
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
                if ooms >= 2:
                    checker._degrade_memory_lean()
            _interruptible_backoff(delay, checker)
            checker._reset_for_resume()
            if snap is not None:
                resume_from(checker, snap,
                            allow_sha_mismatch=checker._resume_allow_sha)
