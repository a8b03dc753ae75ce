"""Checkpoints, resume and supervised fault recovery for the wave engines.

The port of the JAX package's ``checkpoint`` module, for the
single-device and the sharded engines. A snapshot is taken at a chunk's
one host sync, every ``checkpoint_every`` chunks, and a preempted,
OOM-killed or crashed run resumes from it instead of from the init
states.

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

* **Chunks.** The single-device engines run chunks of up to
  ``waves_per_sync`` waves between host syncs (checkers/chunk.py), as
  JAX's do: a snapshot lands at a chunk's end, the cadence counts
  chunks, the manifest records the run's ``waves_per_sync``, and a fault
  site's chunk is a chunk index. A chunk a wave of the host's choice
  cuts short (a capacity class grown or shrunk) ends where the next
  starts, so the snapshot is at a wave boundary all the same. The
  sharded engines, the tiered run and the fused batch run one wave a
  chunk. A JAX snapshot taken at any ``waves_per_sync`` resumes from the
  wave boundary it is.
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
* **Mesh snapshots are packed too.** A sharded engine (parallel/) writes
  JAX's mesh leaves (``u_loc``, ``n_loc``, ``pl_n`` per shard; the hash
  tables at JAX's ``S * C`` slots), each shard's live block back to
  back, and marks the manifest ``shard_layout: packed``; a JAX mesh
  snapshot, its blocks at the padded strides, is read as it is.
* **The re-shard** (:func:`reshard_sortmerge`, :func:`reshard_hash`,
  JAX's host functions over the port's blocks) moves a snapshot between
  shard counts, single ⇄ sharded included, through the (owner, fp)
  route. Unlike JAX, a hash snapshot re-shards single ⇄ sharded too (by
  re-insertion; a single-device table of another slot count is still
  refused). A tiered mesh snapshot of the port's (packed) resumes and
  re-shards like any other; a JAX tiered mesh snapshot (its blocks at
  the padded strides, maybe a pending wave) is refused
  (:func:`_mesh_tier_runs`): the fold of its pending wave is ported for
  one device only (ROADMAP item 15).
* **Telemetry** (telemetry.py): a traced run gets JAX's ``checkpoint``
  event for each snapshot written, ``fault_recovery`` and
  ``fault_degrade`` from the supervisor, and from the engines
  ``restore``, ``checkpoint_cadence`` and ``watchdog_timeout``. The
  same facts land, traced or not, in ``checker.metrics``
  (``snapshots``, ``snapshot_bytes``, ``snapshot_write_sec`` and of it
  ``snapshot_capture_sec``, ``resume_load_sec`` and of it
  ``resume_read_sec`` and ``resume_host_sec``, then the run's
  ``resume_upload_sec``, ``fault_recoveries``) and in a
  ``RuntimeWarning`` where JAX warns.

**Resume** (:func:`resume_from`) validates the snapshot (staleness is
refused, never guessed around: an encoding fingerprint that differs, or
a git SHA that differs from HEAD, or outside a git checkout from
the hash of the package's sources, unless ``allow_sha_mismatch``) and
stages it in host memory; the engine's next attempt uploads it. A
sort-merge snapshot's visited keys are packed and checked once, shard
by shard, and re-sharded when the target's layout differs; a JAX tiered
snapshot's pending wave is committed on the host first through the
port's ``ColdStore.member``, as JAX's fold commits it
(:func:`_fold_tier_snapshot`). A hash table is rebuilt with
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
* **The shard degrade** (``degrade_on_fault``, the sharded engines of
  parallel/) follows JAX's :class:`FailurePolicy`: a fault that strikes
  one shard twice drops that shard's device
  from the list, and the retry re-shards the last snapshot onto the
  survivors. :func:`classify_failure` attributes a shard from an
  injected shard fault, or from the straggler detector's evidence
  (``_sustained_stragglers``: a traced sharded run with
  ``straggler_factor`` set, telemetry.detect_stragglers), as JAX's.
"""

from __future__ import annotations

import copy
import functools
import hashlib
import json
import math
import os
import subprocess
import threading
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

#: the manifest's ``shard_layout`` of a port mesh snapshot: each shard's
#: live block back to back (a JAX mesh snapshot has no such key: its
#: shard blocks sit at a stride of the padded capacities)
PACKED = "packed"


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
    """The identity of the code a snapshot is written and resumed with:
    HEAD of the git checkout this package sits in, or, outside one (a
    ``git archive`` copy has no ``.git``), :func:`source_tree_sha` of
    the package, so a snapshot from other code is refused there too
    (JAX's check is off outside a checkout). None when git cannot
    answer."""
    root = _repo_root()
    if not os.path.exists(os.path.join(root, ".git")):
        return source_tree_sha(os.path.dirname(os.path.abspath(__file__)))
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=root,
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


@functools.lru_cache(maxsize=4)
def source_tree_sha(package_dir: str) -> str:
    """``tree-`` and the SHA-1 of every ``.py`` and ``.cu`` file under
    ``package_dir``, by relative path: the code's identity where git
    cannot give one. Read once a process (the sources do not move under
    a run)."""
    h = hashlib.sha1()
    for dirpath, dirnames, filenames in os.walk(package_dir):
        dirnames.sort()
        for name in sorted(filenames):
            if name.endswith((".py", ".cu")):
                path = os.path.join(dirpath, name)
                h.update(os.path.relpath(path, package_dir).encode())
                with open(path, "rb") as fh:
                    h.update(fh.read())
    return "tree-" + h.hexdigest()


def _engine_kind(checker) -> str:
    """``sharded`` for an engine over a device list (parallel/), even
    at one shard, as JAX's kind is ``sharded`` for any mesh engine."""
    return ("sharded" if getattr(checker, "devices", None) is not None
            else "single")


# -- file format --------------------------------------------------------------


def _manifest_crc(manifest: dict) -> int:
    return zlib.crc32(json.dumps(manifest, sort_keys=True).encode()) & _M32


def _write_file(path: str, manifest: dict, buffers: dict) -> None:
    """Atomic snapshot write: temp file, fsync, rename. The manifest
    rides the same npz as a reserved uint8 entry, so one rename commits
    both, with its own CRC-32 (``manifest_crc32``). The temp file is the
    writing thread's own: two threads of a process writing one path (the
    service retaining two concurrent sessions of one model) each commit
    a whole file, the last rename winning."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
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
    buffers["n_hot"] = np.uint32(st.vkeys.shape[0])
    return buffers, _tier_block(checker, tier.cold, tier.plog, buffers)


def hash_buffers(checker, table, parents, front, ebits, **counters) -> dict:
    """The buffers of a hash wave state (checkers/tpu.py), under the JAX
    leaf names: the one-shard case of :func:`mesh_hash_buffers`, without
    its per-shard count (``counters``: ``depth``, ``waves``,
    ``generated``, ``unique``)."""
    out = mesh_hash_buffers(checker, [dict(
        table=table, parents=parents, frontier=front, ebits=ebits)],
        **counters)
    del out["n_loc"]
    return out


def _cat(blocks, axis: int, empty) -> np.ndarray:
    return np.concatenate(blocks, axis=axis) if blocks else empty


def _tier_block(checker, cold, plog_blocks, buffers: dict) -> dict:
    """A tiered run's cold runs (``tier_run{s}_{i}_lo/hi``) and host
    parent log (``tier_plog``) into ``buffers``; returns the manifest's
    ``tier`` block (JAX's)."""
    cold.sync()  # the ingest worker is joined before the runs are read
    run_rows = []
    for s, shard in enumerate(cold.snapshot_runs()):
        rows = []
        for i, (lo, hi) in enumerate(shard):
            buffers[f"tier_run{s}_{i}_lo"] = lo
            buffers[f"tier_run{s}_{i}_hi"] = hi
            rows.append(int(lo.size))
        run_rows.append(rows)
    plog_host = 0
    if checker.track_paths and plog_blocks:
        buffers["tier_plog"] = _plog_limbs(plog_blocks)
        plog_host = int(buffers["tier_plog"].shape[1])
    return dict(hot_rows=checker._tier_hot_ceiling,
                max_runs=int(cold.max_runs), spills=int(cold.spills),
                run_rows=run_rows, plog_host_rows=plog_host,
                cold_rows_total=int(cold.rows()),
                cold_bytes_total=int(cold.bytes()))


def mesh_sortmerge_buffers(checker, st, tier=None) -> tuple:
    """``(buffers, tier block)`` of a sharded sort-merge state ``st``
    (parallel/engine_sortmerge.py ``MeshState``; ``tier`` its
    ``HotColdTier`` in a tiered run) under JAX's mesh leaf names, each
    shard's live block back to back: ``vkeys uint32[2, U]`` with
    ``u_loc[S]``, ``frontier [W, N]`` and ``ebits`` with ``n_loc[S]``,
    ``plog [4, P]`` with ``pl_n[S]``, and the routed-row counter
    ``sent_lo``/``sent_hi``. A tiered state adds ``h_loc[S]``, each
    shard's hot keys (the block sizes), with ``u_loc`` each shard's hot
    and cold keys (JAX's), and the cold runs and host log."""
    W = int(checker.encoded.width)
    vk = [_limbs(sh.vkeys) for sh in st.shards]
    fr = [_u32(_host(sh.frontier)) for sh in st.shards]
    eb = [_u32(_host(sh.ebits)) for sh in st.shards]
    pl = [(_plog_limbs(sh.plog) if checker.track_paths
           else np.zeros((4, 0), np.uint32)) for sh in st.shards]
    n = sum(f.shape[1] for f in fr)
    hot = np.array([v.shape[1] for v in vk], np.uint32)
    buffers = dict(
        vkeys=_cat(vk, 1, np.zeros((2, 0), np.uint32)),
        u_loc=hot,
        frontier=_cat(fr, 1, np.zeros((W, 0), np.uint32)),
        fval=np.ones(n, bool), ebits=_cat(eb, 0, np.zeros(0, np.uint32)),
        n_loc=np.array([f.shape[1] for f in fr], np.uint32),
        plog=_cat(pl, 1, np.zeros((4, 0), np.uint32)),
        pl_n=np.array([p.shape[1] for p in pl], np.uint32),
        sent_lo=np.uint32(st.routed & _M32),
        sent_hi=np.uint32(st.routed >> 32),
        **_counters(checker, depth=st.depth, waves=st.waves,
                    generated=st.generated,
                    unique=checker._unique_states))
    if tier is None:
        return buffers, None
    buffers["h_loc"] = hot
    buffers["u_loc"] = hot + np.array(st.cold.shard_rows(), np.uint32)
    return buffers, _tier_block(checker, st.cold, tier.plog, buffers)


def mesh_hash_buffers(checker, shards, *, depth: int, waves: int,
                      generated: int, unique: int) -> dict:
    """The buffers of a sharded hash state (parallel/engine.py: one
    ``dict(table, parents, frontier, ebits)`` a shard) under JAX's leaf
    names: the tables and parent keys in slot order, shard after shard
    (``t_lo uint32[S * C]``, JAX's layout), and each shard's live
    frontier rows back to back (``frontier [N, W]`` with ``n_loc[S]``)."""
    t = [_limbs(sh["table"].keys) for sh in shards]
    p = [(_limbs(sh["parents"]) if checker.track_paths
          else np.zeros((2, 0), np.uint32)) for sh in shards]
    fr = [np.ascontiguousarray(_u32(_host(sh["frontier"])).T)
          for sh in shards]
    W = int(checker.encoded.width)
    n = sum(f.shape[0] for f in fr)
    return dict(
        t_lo=_cat([x[0] for x in t], 0, np.zeros(0, np.uint32)),
        t_hi=_cat([x[1] for x in t], 0, np.zeros(0, np.uint32)),
        p_lo_t=_cat([x[0] for x in p], 0, np.zeros(0, np.uint32)),
        p_hi_t=_cat([x[1] for x in p], 0, np.zeros(0, np.uint32)),
        frontier=_cat(fr, 0, np.zeros((0, W), np.uint32)),
        n_loc=np.array([f.shape[0] for f in fr], np.uint32),
        fval=np.ones(n, bool),
        ebits=_cat([_u32(_host(sh["ebits"])) for sh in shards], 0,
                   np.zeros(0, np.uint32)),
        **_counters(checker, depth=depth, waves=waves, generated=generated,
                    unique=unique))


def write_snapshot(checker, buffers: dict, path: str, *, chunk: int,
                   tier_block: Optional[dict] = None) -> dict:
    """Write one snapshot of ``buffers`` (:func:`sortmerge_buffers` or
    :func:`hash_buffers`) atomically to ``path`` with JAX's manifest, and
    return the manifest. ``chunk`` is the chunk index in this attempt. A
    ``checkpoint`` event records it (its wall: the file write; the
    engine's ``snapshot_write_sec`` adds the download)."""
    t0 = time.monotonic()
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
        n_shards=int(getattr(checker, "n_shards", 1)),
        capacity=int(checker.capacity),
        frontier_capacity=int(checker.frontier_capacity),
        track_paths=bool(checker.track_paths),
        waves_per_sync=int(checker._sync_waves()),
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
    classes = getattr(checker, "_chunk_classes", None)
    if classes:
        # the capacity classes the chunked run used, the last the one it
        # goes on in (resume_from)
        manifest["chunk_classes"] = [list(k) for k in classes]
    if manifest["kind"] == "sharded":
        # the port's mesh leaves hold each shard's live block back to
        # back (per-shard counts u_loc, n_loc, pl_n), not JAX's blocks
        # at a stride of the padded capacities
        manifest["shard_layout"] = PACKED
    _write_file(path, manifest, buffers)
    checker._last_snapshot = path
    from . import telemetry

    telemetry.emit(
        "checkpoint", path=os.path.basename(path), chunk=int(chunk),
        wave=manifest["wave"], depth=manifest["depth"],
        unique=manifest["unique"], snapshot_bytes=total,
        wall_sec=round(time.monotonic() - t0, 6))
    return manifest


def retain_final_snapshot(checker, path: str) -> Optional[dict]:
    """The warm start of the resident service (serve.py): write a
    FINISHED run's state as an ordinary snapshot at ``path``, so a later
    checker whose :func:`encoding_fingerprint` matches can
    :func:`resume_from` it and settle with zero new waves, with the cold
    run's counts, depth, discovery fingerprints and paths (an edited
    model changes the fingerprint and is refused: the service then runs
    cold). The run must have kept its final state
    (``checker.keep_final_carry = True`` before its join). The search is
    over, so the snapshot holds no frontier (JAX keeps the frontier and
    a ``done`` flag; the port's format has no flag). A tiered run keeps
    both tiers: the cold runs and the host parent log are in the format.
    Returns the manifest, or None when there is nothing to retain: no
    final state, a run that raised or was cancelled, or a tiered run
    whose cold store is gone (the device tier alone would warm-start
    from a subset and explore again)."""
    carry = getattr(checker, "_final_carry", None)
    if (carry is None or checker._run_error is not None
            or getattr(checker, "cancelled", False)):
        return None
    counters = dict(depth=int(checker._max_depth),
                    waves=int(checker.metrics.get("waves") or 0))
    if checker._checkpoint_family() == "sortmerge":
        st, tier = carry
        if checker.metrics.get("tier_spills") and (
                tier is None or st.cold is None):
            return None
        settled = copy.copy(st)
        settled.frontier, settled.ebits = st.frontier[:, :0], st.ebits[:0]
        buffers, tier_block = sortmerge_buffers(checker, settled, tier)
    else:
        counters.update(generated=int(carry["generated"]),
                        unique=int(carry["unique"]))
        buffers = hash_buffers(
            checker, carry["table"], carry["parents"],
            carry["frontier"][:, :0], carry["ebits"][:0], **counters)
        tier_block = None
    return write_snapshot(checker, buffers, path, chunk=counters["waves"],
                          tier_block=tier_block)


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
    # a chunked run's capacity classes so far (checkers/chunk.py): the
    # resumed run starts in the last and goes on from them, so it makes
    # the class changes the killed run made
    checker._resume_classes = manifest.get("chunk_classes")
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


# -- mesh snapshots and the re-shard ------------------------------------------


def _is_mesh(manifest: dict) -> bool:
    return (int(manifest.get("n_shards", 1)) > 1
            or manifest.get("kind") == "sharded")


def _need(buffers: dict, path: str, *names) -> None:
    missing = [n for n in names if n not in buffers]
    if missing:
        raise SnapshotCorruptError(
            f"{path}: a mesh snapshot without its per-shard leaves "
            f"{missing}")


def _counts(buffers: dict, name: str, n: int) -> np.ndarray:
    return np.asarray(buffers[name], np.int64).reshape(-1)[:n]


def _block_slices(path: str, manifest: dict, widths: dict, counts: dict,
                  strides: dict) -> list:
    """Per source shard, ``{leaf: (start, stop)}`` of its live columns:
    back to back in a port mesh snapshot (``shard_layout`` packed), at
    ``strides[leaf]`` in a JAX one; each is checked against the leaf's
    ``widths[leaf]`` columns."""
    S = int(manifest.get("n_shards", 1))
    packed = manifest.get("shard_layout") == PACKED
    out = [dict() for _ in range(S)]
    for leaf, n in counts.items():
        width = widths[leaf]
        off = 0
        for s in range(S):
            start = off if packed else s * strides[leaf]
            stop = start + int(n[s])
            if stop > width or (not packed and int(n[s]) > strides[leaf]):
                raise SnapshotCorruptError(
                    f"{path}: shard {s}'s {leaf} block [{start}, {stop}) "
                    f"passes the leaf's {width} columns")
            out[s][leaf] = (start, stop)
            off = stop
    return out


def _sortmerge_blocks(path: str, manifest: dict, buffers: dict,
                      hot: Optional[int] = None) -> list:
    """A sort-merge snapshot's live state as one block a source shard:
    ``dict(keys int64[u] (packed, as stored), frontier uint32[W, n],
    ebits uint32[n], plog uint32[4, p])``, from a single-device
    snapshot (``hot`` bounds its visited prefix), a JAX mesh snapshot
    (blocks at the padded strides) or a port one (back to back)."""
    track_paths = bool(manifest["track_paths"])
    vk = np.asarray(buffers["vkeys"], np.uint32)
    fr = np.asarray(buffers["frontier"], np.uint32)
    eb = np.asarray(buffers["ebits"], np.uint32).reshape(-1)
    plog = np.asarray(buffers.get("plog", np.zeros((4, 0), np.uint32)),
                      np.uint32)
    if not _is_mesh(manifest):
        u = _scalar(buffers, "new") if hot is None else int(hot)
        n = _scalar(buffers, "n_frontier")
        p = _scalar(buffers, "pl_n") if track_paths else 0
        if u > vk.shape[1] or n > fr.shape[1] or p > plog.shape[1]:
            raise SnapshotCorruptError(
                f"{path}: counters contradict the buffers ({u:,} visited "
                f"keys, {n:,} frontier rows, {p:,} parent-log rows)")
        sl = [dict(vkeys=(0, u), frontier=(0, n), ebits=(0, n),
                   plog=(0, p))]
    else:
        _need(buffers, path, "u_loc", "n_loc", "pl_n")
        S = int(manifest["n_shards"])
        C, F = int(manifest["capacity"]), int(manifest["frontier_capacity"])
        n_loc = _counts(buffers, "n_loc", S)
        pl = (_counts(buffers, "pl_n", S) if track_paths
              else np.zeros(S, np.int64))
        # a tiered run's blocks hold its hot keys (h_loc); u_loc counts
        # the cold ones too
        hot_loc = _counts(buffers, "h_loc" if "h_loc" in buffers
                          else "u_loc", S)
        sl = _block_slices(
            path, manifest, dict(vkeys=vk.shape[1], frontier=fr.shape[1],
                                 ebits=eb.size, plog=plog.shape[1]),
            dict(vkeys=hot_loc, frontier=n_loc, ebits=n_loc, plog=pl),
            dict(vkeys=C + F, frontier=F, ebits=F,
                 plog=(C + F) if track_paths else 0))
    blocks = []
    for b in sl:
        (u0, u1), (n0, n1), (p0, p1) = b["vkeys"], b["frontier"], b["plog"]
        blocks.append(dict(
            keys=pack_keys_np(vk[0, u0:u1], vk[1, u0:u1]),
            frontier=fr[:, n0:n1], ebits=eb[n0:n1], plog=plog[:, p0:p1]))
    return blocks


def _frontier_fps(cols: np.ndarray) -> tuple:
    """``(lo, hi)`` uint32 fingerprints of ``[W, n]`` frontier columns
    (the raw fold, as JAX's re-shard routes frontier rows)."""
    import torch

    from .ops.fingerprint import fingerprint_u32v_t

    lo, hi = fingerprint_u32v_t(torch.from_numpy(cols.astype(np.int64)))
    return lo.numpy().astype(np.uint32), hi.numpy().astype(np.uint32)


def reshard_sortmerge(blocks: list, checker) -> list:
    """The elastic re-shard of a sort-merge state (JAX
    ``reshard_sortmerge``): every row re-routed through the (owner, fp)
    seam onto ``checker``'s shard count — a visited key to ``lo % S``,
    each shard's keys sorted; a frontier row to the owner of its raw
    fingerprint, each shard's rows in fingerprint ``(hi, lo)`` order; a
    parent-log entry to the owner of its child. Single-device is the
    one-shard layout, so this covers single ⇄ sharded and S_a -> S_b.
    Refuses with :class:`SnapshotIncompatibleError`, JAX's messages,
    when a shard's share passes the per-shard capacities."""
    S = int(getattr(checker, "n_shards", 1))
    C, F = int(checker.capacity), int(checker.frontier_capacity)
    keys = np.concatenate([b["keys"] for b in blocks])
    cols = np.concatenate([b["frontier"] for b in blocks], axis=1)
    ebits = np.concatenate([b["ebits"] for b in blocks])
    plog = np.concatenate([b["plog"] for b in blocks], axis=1)
    key_owner = (keys & _M32) % S
    fr_lo, fr_hi = _frontier_fps(cols)
    fr_owner = fr_lo % np.uint32(S)
    pl_owner = plog[2] % np.uint32(S)
    out = []
    for d in range(S):
        k = np.sort(keys[key_owner == d])
        if k.size > C:
            raise SnapshotIncompatibleError(
                f"re-shard: shard {d} of {S} would own {k.size:,} visited "
                f"keys but per-shard capacity is {C:,} — raise the target "
                "capacity")
        fsel = fr_owner == d
        if int(fsel.sum()) > F:
            raise SnapshotIncompatibleError(
                f"re-shard: shard {d} of {S} would own {int(fsel.sum()):,} "
                f"frontier rows but frontier_capacity is {F:,} — raise the "
                "target frontier_capacity")
        order = np.lexsort((fr_lo[fsel], fr_hi[fsel]))
        out.append(dict(keys=k, frontier=cols[:, fsel][:, order],
                        ebits=ebits[fsel][order],
                        plog=plog[:, pl_owner == d]))
    return out


def _wave_state(block: dict, track_paths: bool):
    """A shard's ``WaveState`` in host memory from its block, the visited
    keys checked to be strictly sorted and free of the sentinel."""
    import torch

    from .checkers.tpu_sortmerge import WaveState
    from .convert import plog_blocks
    from .ops.fingerprint import SENTINEL_KEY

    keys = block["keys"]
    if keys.size > 1 and not bool((keys[1:] > keys[:-1]).all()):
        raise ValueError("vkeys must be a strictly sorted prefix of "
                         "distinct keys")
    if keys.size and int(keys[-1]) == SENTINEL_KEY:
        raise ValueError("a sentinel inside the live prefix")
    plog = []
    if track_paths and block["plog"].shape[1]:
        plog.append(tuple(torch.from_numpy(a)
                          for a in plog_blocks(block["plog"])))
    return WaveState(
        vkeys=torch.from_numpy(keys),
        frontier=torch.from_numpy(block["frontier"].astype(np.int64)),
        ebits=torch.from_numpy(block["ebits"].astype(np.int64)), plog=plog)


def _discovered_lanes(props, buffers: dict) -> dict:
    """The discovery lanes as ``{property name: fingerprint}``."""
    found, lo, hi = (np.asarray(buffers[k]).reshape(-1) for k in
                     ("disc_found", "disc_lo", "disc_hi"))
    return {p.name: (int(hi[i]) << 32) | int(lo[i])
            for i, p in enumerate(props) if bool(found[i])}


def _discovered(checker, buffers: dict) -> dict:
    return _discovered_lanes(list(checker.model.properties()), buffers)


def _mesh_tier_runs(path: str, manifest: dict, buffers: dict,
                    tier_m: dict) -> tuple:
    """A port tiered mesh snapshot's host state: ``(cold store, host
    parent-log limbs or None)``, one store shard a source shard. A JAX
    tiered mesh snapshot (its blocks at the padded strides, maybe a
    pending wave) is refused: its fold is ported for one device."""
    if manifest.get("shard_layout") != PACKED:
        raise SnapshotIncompatibleError(
            f"{path}: a JAX tiered mesh snapshot: the fold of its pending "
            "wave is ported for one device only (ROADMAP item 15)")
    S = int(manifest["n_shards"])
    run_rows = tier_m.get("run_rows") or [[] for _ in range(S)]
    per_shard = []
    for s in range(S):
        shard = []
        for i, n in enumerate(run_rows[s] if s < len(run_rows) else []):
            lo = buffers.pop(f"tier_run{s}_{i}_lo")
            hi = buffers.pop(f"tier_run{s}_{i}_hi")
            if int(n) != int(lo.size):
                raise SnapshotCorruptError(
                    f"tier run {s}/{i}: manifest declares {n} rows, buffer "
                    f"has {lo.size}")
            shard.append((lo, hi))
        per_shard.append(shard)
    cold = ColdStore.from_runs(per_shard, max_runs=int(
        tier_m.get("max_runs") or 8), spills=int(tier_m.get("spills") or 0))
    return cold, buffers.pop("tier_plog", None)


def _stage_sortmerge(checker, path: str, manifest: dict, buffers: dict):
    """A sort-merge snapshot staged in host memory, checked: each source
    shard's live block (one for a single-device snapshot), re-sharded
    onto the target's shard count when the counts or kinds differ
    (:func:`reshard_sortmerge`), as one ``WaveState`` a shard in a
    ``MeshState`` — or one ``WaveState`` for a single-device target. A
    tiered snapshot is folded first (a JAX one's pending wave commits
    through the cold store); its cold runs stay cold for a tiered target
    (repartitioned to its shard count, JAX's ``_route_tier_target``) and
    join each shard's hot keys for any other (the un-tier, refused where
    a shard's keys then pass the capacity); its host parent log joins
    the log of the shard that owns each entry. Each shard's keys must be
    strictly sorted, with no sentinel, and hot plus cold keys must equal
    the unique count. ``checker._ckpt_stats`` gets the wall of the
    packing and checks."""
    from .parallel.engine_sortmerge import MeshState

    tier_m = manifest.get("tier")
    cold = plog_host = hot = None
    if tier_m and _is_mesh(manifest):
        cold, plog_host = _mesh_tier_runs(path, manifest, buffers, tier_m)
    elif tier_m:
        buffers, cold, hot, plog_host = _fold_tier_snapshot(
            checker, manifest, buffers, tier_m)
    t0 = time.monotonic()
    blocks = _sortmerge_blocks(path, manifest, buffers, hot)
    unique = _scalar(buffers, "new")
    held = sum(b["keys"].size for b in blocks) + (
        0 if cold is None else cold.rows())
    if held != unique:
        raise SnapshotCorruptError(
            f"{path}: the shards hold {held:,} visited keys against "
            f"{unique:,} unique")
    if plog_host is not None and plog_host.shape[1]:
        owner = plog_host[2] % np.uint32(len(blocks))
        for s, b in enumerate(blocks):
            b["plog"] = np.concatenate([plog_host[:, owner == s], b["plog"]],
                                       axis=1)
    untier = cold is not None and getattr(checker, "tier_hot_rows",
                                          None) is None
    if untier:
        # each source shard's cold runs rejoin its hot keys
        for s, b in enumerate(blocks):
            b["keys"] = np.sort(np.concatenate([b["keys"]] + cold.runs[s]))
        cold = None
    S_b = int(getattr(checker, "n_shards", 1))
    if (len(blocks) != S_b
            or _engine_kind(checker) != manifest.get("kind", "single")):
        blocks = reshard_sortmerge(blocks, checker)
        if cold is not None:
            cold = cold.repartitioned(S_b)
    C = int(checker.capacity)
    if untier and max(b["keys"].size for b in blocks) > C:
        raise SnapshotIncompatibleError(
            f"{path}: tiered snapshot holds {unique:,} visited keys, more "
            f"than a shard's capacity of {C:,} once un-tiered, and tiering "
            "is off — raise the capacity, or resume with tier_hot_rows set "
            "to keep the cold tier")
    if cold is not None:
        cold.max_runs = int(checker.tier_max_runs)
    try:
        shards = [_wave_state(b, checker.track_paths) for b in blocks]
    except ValueError as exc:
        raise SnapshotCorruptError(f"{path}: the visited prefix: {exc}")
    gen = _scalar(buffers, "gen_lo") | (_scalar(buffers, "gen_hi") << 32)
    counters = dict(depth=_scalar(buffers, "depth"), generated=gen,
                    waves=_scalar(buffers, "waves"),
                    discovered=_discovered(checker, buffers))
    checker._ckpt_stats["resume_host_sec"] = round(time.monotonic() - t0, 6)
    if _engine_kind(checker) != "sharded":
        st = shards[0]
        for k, v in counters.items():
            setattr(st, k, v)
        st.cold = cold
        return st
    routed = (_scalar(buffers, "sent_lo") | (_scalar(buffers, "sent_hi") << 32)
              if "sent_lo" in buffers else 0)
    return MeshState(shards=shards, cold=cold, routed=routed, **counters)


def sortmerge_mesh_state(checker, st):
    """A staged ``MeshState`` uploaded, each shard to its device;
    ``checker._ckpt_stats`` gets the upload's wall."""
    import torch

    t0 = time.monotonic()
    for sh, dev in zip(st.shards, checker.devices):
        sh.vkeys, sh.frontier, sh.ebits = (
            sh.vkeys.to(dev), sh.frontier.to(dev), sh.ebits.to(dev))
        sh.plog = [(p.to(dev), c.to(dev)) for p, c in sh.plog]
    for dev in set(checker.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    checker._ckpt_stats["resume_upload_sec"] = round(time.monotonic() - t0, 6)
    return st


def _hash_blocks(path: str, manifest: dict, buffers: dict) -> list:
    """A hash snapshot's state as one block a source shard: ``dict(keys,
    parents, frontier, ebits)`` — the slot keys and parent keys, packed
    int64 ``[C]`` in slot order (EMPTY, the (0, 0) pair, is JAX's empty
    slot and root parent), the live frontier rows ``uint32[n, W]`` and
    their eventually-bits."""
    track_paths = bool(manifest["track_paths"])
    S = int(manifest.get("n_shards", 1))
    W = int(manifest["width"])
    t = pack_keys_np(buffers["t_lo"], buffers["t_hi"]).reshape(-1)
    par = (pack_keys_np(buffers["p_lo_t"], buffers["p_hi_t"]).reshape(-1)
           if track_paths else None)
    fr = np.asarray(buffers["frontier"], np.uint32).reshape(-1, W)
    eb = np.asarray(buffers["ebits"], np.uint32).reshape(-1)
    fval = np.asarray(buffers["fval"], bool).reshape(-1)
    if t.size % S:
        raise SnapshotCorruptError(
            f"{path}: {t.size:,} table slots do not split into {S} shards")
    C = t.size // S
    if manifest.get("shard_layout") == PACKED:
        _need(buffers, path, "n_loc")
        n = _counts(buffers, "n_loc", S)
        starts = np.concatenate([[0], np.cumsum(n)[:-1]]).astype(np.int64)
    else:  # JAX: one frontier block of frontier_capacity rows a shard
        F = fr.shape[0] // S
        starts = np.arange(S, dtype=np.int64) * F
        n = np.full(S, F, np.int64)
    blocks = []
    for s in range(S):
        rows = slice(int(starts[s]), int(starts[s] + n[s]))
        live = fval[rows]
        blocks.append(dict(
            keys=t[s * C:(s + 1) * C],
            parents=None if par is None else par[s * C:(s + 1) * C],
            frontier=fr[rows][live], ebits=eb[rows][live]))
    return blocks


def reshard_hash(blocks: list, checker) -> list:
    """The hash re-shard (JAX ``reshard_hash``): each target shard's table
    rebuilt on the host by re-inserting, in source slot order, the
    occupied keys it owns (``lo % S``) through the plain insert, whose
    probe sequence is the CUDA kernel's and JAX's; each parent key moves
    with its key; frontier rows re-route by their fingerprints, each
    shard's rows in ``(hi, lo)`` order. Refuses before any device work
    when a table cannot absorb its keys or a frontier share overflows.
    Unlike JAX, single ⇄ sharded goes this way too (a single-device
    table is the one-shard layout)."""
    import torch

    from .ops.hashset import EMPTY, DeviceHashSet, insert_plain

    S = int(getattr(checker, "n_shards", 1))
    C, F = int(checker.capacity), int(checker.frontier_capacity)
    keys = np.concatenate([b["keys"] for b in blocks])
    occupied = keys != EMPTY
    keys = keys[occupied]
    parents = (None if blocks[0]["parents"] is None else
               np.concatenate([b["parents"] for b in blocks])[occupied])
    rows = np.concatenate([b["frontier"] for b in blocks])
    ebits = np.concatenate([b["ebits"] for b in blocks])
    key_owner = (keys & _M32) % S
    fr_lo, fr_hi = _frontier_fps(np.ascontiguousarray(rows.T))
    fr_owner = fr_lo % np.uint32(S)
    out = []
    for d in range(S):
        sel = key_owner == d
        k = keys[sel]
        if k.size > C:
            raise SnapshotIncompatibleError(
                f"hash re-shard: shard {d} of {S} would own {k.size:,} "
                f"visited keys but per-shard capacity is {C:,} — raise the "
                "target capacity")
        table = DeviceHashSet.empty(C, "cpu")
        _, ovf, slot = insert_plain(table, torch.from_numpy(k), None,
                                    int(checker.probe_rounds))
        if bool(ovf.any()):
            raise SnapshotIncompatibleError(
                f"hash re-shard: shard {d} of {S} exhausted "
                f"{checker.probe_rounds} probe rounds re-inserting "
                f"{k.size:,} keys at capacity {C:,} — raise the target "
                "capacity or probe_rounds")
        par = None
        if parents is not None:
            par = np.full(C, EMPTY, np.int64)
            par[slot.numpy()] = parents[sel]
        fsel = fr_owner == d
        if int(fsel.sum()) > F:
            raise SnapshotIncompatibleError(
                f"hash re-shard: shard {d} of {S} would own "
                f"{int(fsel.sum()):,} frontier rows but frontier_capacity "
                f"is {F:,} — raise the target frontier_capacity")
        order = np.lexsort((fr_lo[fsel], fr_hi[fsel]))
        out.append(dict(keys=table.keys.numpy(), parents=par,
                        frontier=rows[fsel][order],
                        ebits=ebits[fsel][order]))
    return out


def _stage_hash(checker, path: str, manifest: dict, buffers: dict) -> dict:
    """A hash snapshot staged in host memory: each source shard's packed
    slot keys and parent keys (EMPTY where JAX has the (0, 0) pair: an
    empty slot, a root), its live frontier rows lane-major, re-sharded
    (:func:`reshard_hash`) unless the shard count, kind and slot count
    all match (one device to one device must keep the slot count: a
    table's layout is its capacity); the counters and discoveries; for a
    sharded target the shards under ``shards``. Each table's occupied
    slots must sum to the unique count."""
    from .ops.hashset import EMPTY

    blocks = _hash_blocks(path, manifest, buffers)
    unique = _scalar(buffers, "new")
    occupied = sum(int((b["keys"] != EMPTY).sum()) for b in blocks)
    if occupied != unique:
        raise SnapshotCorruptError(
            f"{path}: the tables hold {occupied:,} keys against {unique:,} "
            "unique")
    S_b = int(getattr(checker, "n_shards", 1))
    C = int(checker.capacity)
    same_kind = _engine_kind(checker) == manifest.get("kind", "single")
    if (same_kind and _engine_kind(checker) == "single"
            and blocks[0]["keys"].size != C):
        raise SnapshotIncompatibleError(
            f"{path}: the snapshot's table has {blocks[0]['keys'].size:,} "
            f"slots, this checker's {C:,} — a hash table's slot layout is "
            "its capacity; resume at the snapshot's capacity")
    if len(blocks) != S_b or not same_kind or blocks[0]["keys"].size != C:
        blocks = reshard_hash(blocks, checker)
    shards = [dict(keys=b["keys"], parents=b["parents"],
                   frontier=np.ascontiguousarray(b["frontier"].T)
                   .astype(np.int64),
                   ebits=b["ebits"].astype(np.int64)) for b in blocks]
    counters = dict(
        depth=_scalar(buffers, "depth"), waves=_scalar(buffers, "waves"),
        generated=(_scalar(buffers, "gen_lo")
                   | (_scalar(buffers, "gen_hi") << 32)),
        unique=unique, discovered=_discovered(checker, buffers))
    if _engine_kind(checker) != "sharded":
        return dict(shards[0], **counters)
    return dict(shards=shards, **counters)


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


def classify_failure(exc: BaseException, straggler_shards=()) -> tuple:
    """``(class, shard or None)`` of one failure, JAX's table:
    :class:`WatchdogTimeout` -> ``hang``; an injected shard fault ->
    ``shard_fault`` with its shard; an OOM -> ``oom``; another supervised
    fault -> ``transient``, attributed to a shard only when
    ``straggler_shards`` names exactly one; anything else ->
    ``unsupervised``. The engines pass the shards their straggler
    detector holds as sustained stragglers (none unless a sharded run
    is traced with ``straggler_factor`` set)."""
    from .faultinject import InjectedShardFault

    if isinstance(exc, WatchdogTimeout):
        return "hang", None
    if isinstance(exc, InjectedShardFault):
        return "shard_fault", exc.shard
    if _is_oom(exc):
        return "oom", None
    if is_supervised_fault(exc):
        shard = (int(straggler_shards[0])
                 if len(straggler_shards) == 1 else None)
        return "transient", shard
    return "unsupervised", None


class FailurePolicy:
    """Per-run failure bookkeeping for the supervisor (JAX's): classify
    each failure, count shard-attributed strikes, and call a fault
    PERSISTENT once one shard has failed ``persist_threshold`` times —
    the point at which :func:`supervised_run` degrades onto the
    surviving shards."""

    def __init__(self, persist_threshold: int = 2):
        if persist_threshold < 1:
            raise ValueError(
                f"persist_threshold must be >= 1: {persist_threshold}")
        self.persist_threshold = int(persist_threshold)
        #: (class, shard) per classified failure, in order
        self.history: list = []
        #: shard id -> attributed failures
        self.strikes: dict = {}

    def classify(self, exc: BaseException, straggler_shards=()) -> tuple:
        """Classify and record one failure; a shard-attributed one strikes
        its shard (one attributed to none resets nothing)."""
        kind, shard = classify_failure(exc, straggler_shards)
        self.history.append((kind, shard))
        if shard is not None:
            self.strikes[shard] = self.strikes.get(shard, 0) + 1
        return kind, shard

    def should_degrade(self) -> Optional[int]:
        """The shard to drop (most strikes first), or None while no shard
        has reached the threshold."""
        over = [(n, s) for s, n in self.strikes.items()
                if n >= self.persist_threshold]
        return max(over)[1] if over else None

    def degraded(self, shard: int) -> None:
        """The run dropped this shard: its strikes go with it."""
        self.strikes.pop(shard, None)


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
    """The retry loop around one engine run (``checker._run``): each
    supervised failure is classified by a :class:`FailurePolicy` and
    retried from the last snapshot — or from the init states when the
    run checkpoints and none was written yet — after a backoff of
    ``retry_backoff_sec * 2**(attempt - 1)`` (at most 30 s), up to
    ``max_fault_retries`` times, with a ``RuntimeWarning`` each time; the
    retries count in ``metrics["fault_recoveries"]``. After two OOMs the
    engine degrades (``_degrade_memory_lean``). With ``degrade_on_fault``
    set on a sharded engine of more than one shard, a fault that strikes
    the same shard twice (the policy's threshold) drops that shard
    (``_degrade_shards``), and the retry re-shards the last snapshot
    onto the survivors; the warning says so (``DEGRADING``). Anything
    else, and a supervised failure past the retries, raises through."""
    policy = FailurePolicy()
    attempts = ooms = 0
    while True:
        try:
            return checker._run_attempt(reporter)
        except Exception as exc:
            if not is_supervised_fault(exc):
                raise
            kind, shard = policy.classify(
                exc, straggler_shards=checker._sustained_stragglers())
            snap = checker._last_snapshot or checker._resume_path
            if ((not checker.checkpoint_every and snap is None)
                    or (snap is None and checker._started_from_state)
                    or attempts >= checker.max_fault_retries):
                raise
            attempts += 1
            victim = None
            if (getattr(checker, "degrade_on_fault", False)
                    and checker._can_degrade_shards()):
                victim = policy.should_degrade()
            delay = min(checker.retry_backoff_sec * 2 ** (attempts - 1),
                        30.0)
            S = int(getattr(checker, "n_shards", 1))
            warnings.warn(
                f"supervised recovery [{kind}"
                + (f", shard {shard}" if shard is not None else "")
                + f"]: {type(exc).__name__} on wave execution ({exc}); "
                + (f"DEGRADING: dropping shard {victim} ({S} -> {S - 1} "
                   "shards) and " if victim is not None else "")
                + f"retry {attempts}/{checker.max_fault_retries} from "
                + (f"snapshot {os.path.basename(snap)}" if snap
                   else "the init states")
                + f" after {delay:.2f}s backoff",
                RuntimeWarning, stacklevel=2)
            checker._ckpt_stats["fault_recoveries"] = attempts
            from . import telemetry

            telemetry.emit(
                "fault_recovery", attempt=attempts,
                error=f"{type(exc).__name__}: {exc}",
                snapshot=(os.path.basename(snap) if snap else None),
                backoff_sec=round(delay, 3), oom=(kind == "oom"),
                failure_class=kind, shard=shard)
            if kind == "oom":
                ooms += 1
                torch = _torch()
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
                if ooms >= 2:
                    checker._degrade_memory_lean()
            _interruptible_backoff(delay, checker)
            checker._reset_for_resume()
            if victim is not None:
                checker._degrade_shards(exclude_shard=victim)
                policy.degraded(victim)
                checker._ckpt_stats["shard_degrades"] = (
                    checker._ckpt_stats.get("shard_degrades", 0) + 1)
            manifest = None
            if snap is not None:
                manifest = resume_from(
                    checker, snap,
                    allow_sha_mismatch=checker._resume_allow_sha)
            if victim is not None:
                telemetry.emit(
                    "fault_degrade", from_shards=S,
                    to_shards=int(checker.n_shards),
                    excluded_shard=int(victim), reason=kind,
                    wave=(int(manifest["wave"]) if manifest else 0),
                    rerouted_rows=(int(manifest["unique"]) if manifest
                                   else 0),
                    snapshot=(os.path.basename(snap) if snap else None))
