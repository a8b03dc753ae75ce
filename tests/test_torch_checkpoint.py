"""Checkpoints and resume of the PyTorch port (``ckpt`` marker), held to
the JAX package on the CPU.

The port reads and writes the JAX snapshot format
(stateright_tpu_torch/checkpoint.py): a port snapshot passes JAX's
``load_snapshot`` and declares JAX's leaves; snapshots the JAX engines
write (sort-merge, tiered with a pending wave at ``waves_per_sync > 1``,
hash, paxos) resume on the port to JAX's counts, discovery fingerprints
and ``Path.encode()``; the port's own kill and resume reproduce the
uninterrupted run at every wave boundary (sparse, dense, symmetry,
tiered after a spill, hash, paths off at 2pc rm=7); torn, stale and
incompatible snapshots are refused by name; the hybrid resumes its device
side; and a CLI run killed by ``STPU_FAULTS`` resumes with ``--resume``.
"""

import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from stateright_tpu_torch import checkpoint, faultinject
from stateright_tpu_torch.checkpoint import (
    SnapshotCorruptError,
    SnapshotIncompatibleError,
    SnapshotStaleError,
    encoding_fingerprint,
    load_snapshot,
)
from stateright_tpu_torch.models.paxos import PaxosModelCfg, paxos_model
from stateright_tpu_torch.models.paxos_tpu import STRUCTURAL_SIZES
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

pytestmark = pytest.mark.ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the sort-merge leaves JAX's own test pins (tests/test_checkpoint.py)
SORTMERGE_LEAVES = ("vkeys", "plog", "pl_n", "frontier", "fval", "ebits",
                    "n_frontier", "depth", "waves", "gen_lo", "gen_hi",
                    "new", "disc_found", "disc_lo", "disc_hi")
#: the JAX hash carry's leaves (stateright_tpu/checkers/tpu.py seed)
HASH_LEAVES = ("t_lo", "t_hi", "p_lo_t", "p_hi_t", "frontier", "fval",
               "ebits", "depth", "waves", "gen_lo", "gen_hi", "new",
               "disc_found", "disc_lo", "disc_hi")


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    faultinject.disarm_all()


def _sm(rm, **kw):
    kw.setdefault("capacity", 1 << 12)
    return TwoPhaseSys(rm_count=rm).checker().spawn_sortmerge(
        device="cpu", **kw)


def _hash(rm, **kw):
    return TwoPhaseSys(rm_count=rm).checker().spawn_hash(
        capacity=1 << 12, frontier_capacity=1024, device="cpu", **kw)


def _paxos(**kw):
    return paxos_model(PaxosModelCfg(client_count=2, server_count=3)) \
        .checker().spawn_sortmerge(**STRUCTURAL_SIZES[2], device="cpu", **kw)


def _kill_at(spawn, snap, wave, **kw):
    """A run of ``spawn(...)`` with a snapshot every wave that dies at
    wave ``wave``'s boundary, after its snapshot (retries off): the
    in-process model of a kill."""
    c = spawn(checkpoint_every=1, checkpoint_path=snap, **kw)
    c.max_fault_retries = 0
    faultinject.arm("raise", "chunk_boundary", wave)
    with pytest.raises(faultinject.InjectedFault):
        c.join()
    faultinject.disarm_all()
    assert os.path.exists(snap)
    return c


def _resume(spawn, snap, **kw):
    c = spawn(**kw)
    c.resume_from(snap)
    return c.join()


def _fields(c) -> tuple:
    return (c.unique_state_count(), c.state_count(), c.max_depth(),
            c.discovery_fingerprints())


def _paths(c) -> dict:
    return {name: path.encode() for name, path in c.discoveries().items()}


def _replays(c) -> None:
    for name, path in c.discoveries().items():
        prop = c.model.property_by_name(name)
        assert prop.condition(c.model, path.last_state()), name


# -- the format, read by the JAX package --------------------------------------


def test_port_snapshots_pass_jax_load_snapshot(tmp_path):
    """A port snapshot of either family passes JAX's ``load_snapshot``,
    declares JAX's leaves at their live sizes and the manifest the JAX
    engines write (family, kind, one shard, one wave a sync)."""
    from stateright_tpu.checkpoint import load_snapshot as jax_load

    for family, spawn, leaves in (("sortmerge", _sm, SORTMERGE_LEAVES),
                                  ("hash", _hash, HASH_LEAVES)):
        snap = str(tmp_path / f"{family}.ckpt")
        c = _kill_at(lambda **kw: spawn(3, **kw), snap, 3)
        manifest, buffers = jax_load(snap)
        assert (manifest["family"], manifest["kind"], manifest["n_shards"],
                manifest["waves_per_sync"], manifest["version"]) == (
            family, "single", 1, 1, 1)
        assert manifest["capacity"] == c.capacity
        assert manifest["encoding"] == encoding_fingerprint(c)
        for leaf in leaves:
            assert leaf in buffers and leaf in manifest["buffers"], leaf
        assert manifest["snapshot_bytes"] == sum(
            b.nbytes for b in buffers.values())
        unique = manifest["unique"]
        assert int(buffers["new"]) == unique == c._unique_states
        if family == "sortmerge":
            assert buffers["vkeys"].shape == (2, unique)
            W, n = buffers["frontier"].shape
            assert (W, int(buffers["n_frontier"])) == (c.encoded.width, n)
        else:
            assert buffers["t_lo"].shape == (c.capacity,)
            assert buffers["frontier"].shape[1] == c.encoded.width
            occupied = (buffers["t_lo"] != 0) | (buffers["t_hi"] != 0)
            assert int(occupied.sum()) == unique
        assert c.metrics == {} and c._ckpt_stats["snapshots"] == 4


def test_encoding_fingerprint_equal_across_packages():
    """Hand encodings have JAX's identity, so JAX snapshots are not
    stale on the port."""
    from stateright_tpu.checkpoint import encoding_fingerprint as jax_fp
    from stateright_tpu.models.paxos import PaxosModelCfg as JaxPaxosCfg
    from stateright_tpu.models.paxos import paxos_model as jax_paxos
    from stateright_tpu.models.two_phase_commit import (
        TwoPhaseSys as JaxTwoPhase,
    )

    jax_2pc = JaxTwoPhase(rm_count=3).checker().spawn_tpu_sortmerge(
        capacity=1 << 10, frontier_capacity=128)
    assert jax_fp(jax_2pc) == encoding_fingerprint(_sm(3))
    jax_px = jax_paxos(JaxPaxosCfg(client_count=2, server_count=3)) \
        .checker().spawn_tpu_sortmerge(capacity=1 << 15,
                                       frontier_capacity=1 << 12)
    assert jax_fp(jax_px) == encoding_fingerprint(_paxos())


# -- snapshots written by the JAX engines, resumed on the port ----------------


@pytest.fixture(scope="module")
def jax_snapshots(tmp_path_factory):
    """JAX runs and the snapshots of JAX runs killed at a chunk boundary:
    2pc rm=4 on ``spawn_tpu_sortmerge`` and ``spawn_tpu``, 2pc rm=5
    tiered at a 1,024-key hot tier and 2 waves a sync (killed where a
    provisional wave is pending)."""
    from stateright_tpu import faultinject as jax_faults
    from stateright_tpu.checkpoint import load_snapshot as jax_load
    from stateright_tpu.models.two_phase_commit import (
        TwoPhaseSys as JaxTwoPhase,
    )

    d = tmp_path_factory.mktemp("jax_snapshots")

    def kill(spawn, name, chunk):
        snap = str(d / f"{name}.ckpt")
        c = spawn(checkpoint_every=1, checkpoint_path=snap)
        c.max_fault_retries = 0
        jax_faults.arm("raise", "chunk_boundary", chunk)
        try:
            with pytest.raises(jax_faults.InjectedFault):
                c.join()
        finally:
            jax_faults.disarm_all()
        return snap

    specs = dict(
        sortmerge=(lambda **kw: JaxTwoPhase(rm_count=4).checker()
                   .spawn_tpu_sortmerge(capacity=1 << 11,
                                        frontier_capacity=512,
                                        cand_capacity=4096,
                                        waves_per_sync=4, **kw), 1),
        hash=(lambda **kw: JaxTwoPhase(rm_count=4).checker().spawn_tpu(
            capacity=1 << 12, frontier_capacity=1024, waves_per_sync=2,
            **kw), 2),
        tiered=(lambda **kw: JaxTwoPhase(rm_count=5).checker()
                .spawn_tpu_sortmerge(capacity=1 << 15,
                                     frontier_capacity=1 << 13,
                                     waves_per_sync=2, tier_hot_rows=1024,
                                     **kw), 3),
    )
    out = {}
    for name, (spawn, chunk) in specs.items():
        out[name] = spawn().join()
        out[name + "_snap"] = kill(spawn, name, chunk)
    _, buffers = jax_load(out["tiered_snap"])
    assert bool(buffers["pend_valid"])  # a provisional wave is pending
    return out


def test_jax_sortmerge_snapshot_resumes_on_port(jax_snapshots):
    """A JAX ``spawn_tpu_sortmerge`` snapshot of 2pc rm=4 (4 waves a
    sync, killed at chunk 1) resumes on the port to JAX's 1,568, its
    ``states=``, depth, discovery fingerprints and paths."""
    jax = jax_snapshots["sortmerge"]
    c = _sm(4)
    manifest = c.resume_from(jax_snapshots["sortmerge_snap"])
    assert manifest["waves_per_sync"] == 4 and manifest["wave"] == 8
    c.join()
    assert c.unique_state_count() == 1568
    assert _fields(c) == (jax.unique_state_count(), jax.state_count(),
                          jax.max_depth(), jax.discovery_fingerprints())
    assert _paths(c) == _paths(jax)
    assert c.metrics["waves"] == 14 and c.metrics["resume_upload_sec"] >= 0


def test_jax_tiered_snapshot_with_pending_wave_resumes_on_port(
        jax_snapshots):
    """A JAX tiered snapshot holding a pending provisional wave (its
    ``pend_*`` leaves) is folded through the port's cold store: 8,832,
    JAX's fingerprints and paths, tiered or un-tiered."""
    jax = jax_snapshots["tiered"]
    snap = jax_snapshots["tiered_snap"]
    for tier in (1024, None):
        c = _sm(5, capacity=1 << 15, frontier_capacity=1 << 13,
                tier_hot_rows=tier)
        c.resume_from(snap)
        c.join()
        assert c.unique_state_count() == 8832, tier
        assert _fields(c) == (jax.unique_state_count(), jax.state_count(),
                              jax.max_depth(),
                              jax.discovery_fingerprints()), tier
        assert _paths(c) == _paths(jax), tier
        if tier:
            assert c.metrics["cold_rows"] + c.metrics["hot_rows"] == 8832


def test_jax_hash_snapshot_resumes_on_spawn_hash(jax_snapshots):
    """A JAX ``spawn_tpu`` snapshot resumes on ``spawn_hash`` to 1,568:
    the table rebuilt by ``from_keys`` in JAX's slots, parents with their
    slots, JAX's fingerprints and paths."""
    jax = jax_snapshots["hash"]
    c = _resume(lambda: _hash(4), jax_snapshots["hash_snap"])
    assert c.unique_state_count() == 1568
    assert _fields(c) == (jax.unique_state_count(), jax.state_count(),
                          jax.max_depth(), jax.discovery_fingerprints())
    assert _paths(c) == _paths(jax)


def test_jax_paxos_snapshot_resumes_on_port(tmp_path):
    """A JAX paxos 2c/3s snapshot (8 waves a sync) gives 16,668 on the
    port with a "value chosen" path that replays."""
    from stateright_tpu import faultinject as jax_faults
    from stateright_tpu.models.paxos import PaxosModelCfg as JaxPaxosCfg
    from stateright_tpu.models.paxos import paxos_model as jax_paxos

    snap = str(tmp_path / "jax_paxos.ckpt")
    c = jax_paxos(JaxPaxosCfg(client_count=2, server_count=3)).checker() \
        .spawn_tpu_sortmerge(capacity=1 << 15, frontier_capacity=1 << 12,
                             cand_capacity=1 << 14, waves_per_sync=8,
                             checkpoint_every=1, checkpoint_path=snap)
    c.max_fault_retries = 0
    jax_faults.arm("raise", "chunk_boundary", 1)
    try:
        with pytest.raises(jax_faults.InjectedFault):
            c.join()
    finally:
        jax_faults.disarm_all()
    r = _resume(_paxos, snap)
    assert r.unique_state_count() == 16668
    assert sorted(r.discoveries()) == ["value chosen"]
    _replays(r)


# -- the port's own kill and resume -------------------------------------------


def test_2pc4_killed_at_every_wave_boundary(tmp_path):
    """2pc rm=4, sparse, killed at every wave boundary: every resume gives
    the uninterrupted run's count, ``states=``, depth, fingerprints and
    paths."""
    base = _sm(4).join()
    assert base.unique_state_count() == 1568
    n = base.metrics["waves"]
    for w in range(n - 1):
        snap = str(tmp_path / f"rm4_{w}.ckpt")
        _kill_at(lambda **kw: _sm(4, **kw), snap, w)
        r = _resume(lambda: _sm(4), snap)
        assert _fields(r) == _fields(base), w
        assert _paths(r) == _paths(base), w
        assert r.metrics["waves"] == n, w


@pytest.mark.parametrize("mode", ["dense", "symmetry"])
def test_2pc4_dense_and_symmetry_kill_and_resume(tmp_path, mode):
    """The dense wave and the symmetry reduction, killed at one wave
    boundary: the uninterrupted run's fields and paths."""
    def spawn(**kw):
        builder = TwoPhaseSys(rm_count=4).checker()
        if mode == "symmetry":
            builder = builder.symmetry()
            kw["sparse"] = True
        else:
            kw["sparse"] = False
        return builder.spawn_sortmerge(capacity=1 << 12, device="cpu", **kw)

    base = spawn().join()
    snap = str(tmp_path / f"{mode}.ckpt")
    _kill_at(spawn, snap, 4)
    r = _resume(spawn, snap)
    assert _fields(r) == _fields(base)
    assert _paths(r) == _paths(base)
    _replays(r)


def _paxos_boundaries(tmp_path, waves):
    base = _paxos().join()
    assert base.unique_state_count() == 16668
    n = base.metrics["waves"]
    for w in waves(n):
        snap = str(tmp_path / f"px_{w}.ckpt")
        _kill_at(_paxos, snap, w)
        r = _resume(_paxos, snap)
        assert r.unique_state_count() == 16668, w
        assert _fields(r) == _fields(base), w
        assert _paths(r) == _paths(base), w
    _replays(r)


def test_paxos_2c3s_killed_first_middle_last(tmp_path):
    """paxos 2c/3s killed at the first, a middle and the last wave
    boundary: 16,668 with the uninterrupted run's path."""
    _paxos_boundaries(tmp_path, lambda n: (0, n // 2, n - 2))


@pytest.mark.slow
def test_paxos_2c3s_killed_at_every_boundary(tmp_path):
    _paxos_boundaries(tmp_path, lambda n: range(n - 1))


def test_2pc7_paths_off_kill_and_resume(tmp_path):
    """2pc rm=7, paths off, killed at one boundary: 296,448."""
    def spawn(**kw):
        return _sm(7, capacity=1 << 19, frontier_capacity=1 << 16,
                   track_paths=False, **kw)

    snap = str(tmp_path / "rm7.ckpt")
    _kill_at(spawn, snap, 8)
    r = _resume(spawn, snap)
    assert r.unique_state_count() == 296448
    assert (r.state_count(), r.max_depth()) == (2_744_706, 23)
    r.assert_properties()


def test_tiered_2pc5_killed_after_a_spill(tmp_path):
    """2pc rm=5 at a 1,024-key hot tier, killed after its second spill:
    the snapshot carries the cold runs, the host parent log and the
    ``tier`` block (JAX reads it); the resume gives the uninterrupted
    tiered run's fields, paths, spills and cold and hot rows, and cold
    plus hot rows equal unique."""
    from stateright_tpu.checkpoint import load_snapshot as jax_load

    def spawn(**kw):
        return _sm(5, capacity=1 << 15, frontier_capacity=1 << 13,
                   tier_hot_rows=1024, **kw)

    base = spawn().join()
    snap = str(tmp_path / "tier.ckpt")
    _kill_at(spawn, snap, 9)
    manifest, buffers = jax_load(snap)
    tier = manifest["tier"]
    assert tier["spills"] >= 2 and tier["hot_rows"] == 1024
    assert "tier_plog" in buffers and "tier_run0_0_lo" in buffers
    assert int(buffers["n_hot"]) + tier["cold_rows_total"] == \
        manifest["unique"]
    r = _resume(spawn, snap)
    assert _fields(r) == _fields(base)
    assert _paths(r) == _paths(base)
    for k in ("tier_spills", "cold_rows", "hot_rows"):
        assert r.metrics[k] == base.metrics[k], k
    assert r.metrics["cold_rows"] + r.metrics["hot_rows"] == 8832


def test_hash_2pc4_kill_and_resume(tmp_path):
    """The hash engine killed at one boundary resumes to the
    uninterrupted run's fields and paths."""
    base = _hash(4).join()
    snap = str(tmp_path / "hash.ckpt")
    _kill_at(lambda **kw: _hash(4, **kw), snap, 5)
    r = _resume(lambda: _hash(4), snap)
    assert _fields(r) == _fields(base)
    assert _paths(r) == _paths(base)


# -- refusals -----------------------------------------------------------------


@pytest.fixture()
def twopc3_snapshot(tmp_path):
    snap = str(tmp_path / "cell.ckpt")
    _kill_at(lambda **kw: _sm(3, **kw), snap, 3)
    return snap


def test_torn_snapshot_refused(tmp_path, twopc3_snapshot):
    for mode in ("truncate", "flip"):
        bad = str(tmp_path / f"bad_{mode}.ckpt")
        shutil.copy(twopc3_snapshot, bad)
        faultinject.corrupt_snapshot(bad, mode)
        with pytest.raises(SnapshotCorruptError):
            _sm(3).resume_from(bad)


def test_stale_snapshot_refused(tmp_path, twopc3_snapshot, monkeypatch):
    # a HEAD to compare against, whether or not the tree is a checkout
    monkeypatch.setattr(checkpoint, "_git_sha", lambda: "a" * 40)
    shutil.copy(twopc3_snapshot, str(tmp_path / "fresh.ckpt"))
    faultinject.stale_manifest(str(tmp_path / "fresh.ckpt"), "git_sha",
                               "a" * 40)
    _sm(3).resume_from(str(tmp_path / "fresh.ckpt"))  # same HEAD: fine
    for field in ("git_sha", "encoding"):
        bad = str(tmp_path / f"stale_{field}.ckpt")
        shutil.copy(twopc3_snapshot, bad)
        faultinject.stale_manifest(bad, field)
        with pytest.raises(SnapshotStaleError):
            _sm(3).resume_from(bad)
    bad = str(tmp_path / "stale_git_sha.ckpt")
    _sm(3).resume_from(bad, allow_sha_mismatch=True)
    # another model's checker is stale by its encoding fingerprint
    with pytest.raises(SnapshotStaleError):
        _paxos().resume_from(twopc3_snapshot)
    # a JAX compiled encoding's identity is not the port's: stale, saying
    # why
    bad = str(tmp_path / "compiled.ckpt")
    shutil.copy(twopc3_snapshot, bad)
    faultinject.stale_manifest(bad, "encoding",
                               "CompiledActorEncoding/('actor-compile', 3)")
    with pytest.raises(SnapshotStaleError, match="only hand encodings"):
        _sm(3).resume_from(bad)


def test_incompatible_snapshot_refused(tmp_path, twopc3_snapshot):
    with pytest.raises(SnapshotIncompatibleError, match="family"):
        _hash(3).resume_from(twopc3_snapshot)
    with pytest.raises(SnapshotIncompatibleError, match="track_paths"):
        _sm(3, track_paths=False).resume_from(twopc3_snapshot)
    # a mesh manifest over one device's leaves: no per-shard counters
    mesh = str(tmp_path / "mesh.ckpt")
    manifest, buffers = checkpoint._read_raw(twopc3_snapshot)
    manifest.update(n_shards=2, kind="sharded")
    checkpoint._write_file(mesh, manifest, buffers)
    with pytest.raises(SnapshotCorruptError, match="per-shard leaves"):
        _sm(3).resume_from(mesh)
    # a hash table's slot count is its layout
    snap = str(tmp_path / "h.ckpt")
    _kill_at(lambda **kw: _hash(3, **kw), snap, 2)
    wider = TwoPhaseSys(rm_count=3).checker().spawn_hash(
        capacity=1 << 13, device="cpu")
    with pytest.raises(SnapshotIncompatibleError, match="slots"):
        wider.resume_from(snap)
    # a visited capacity the restored state overflows: the engine's error
    small = _sm(3, capacity=64, frontier_capacity=64)
    small.resume_from(twopc3_snapshot)
    with pytest.raises(RuntimeError, match="visited table overflow"):
        small.join()


def test_snapshot_contents_checked(tmp_path, twopc3_snapshot):
    """A snapshot whose counters contradict its buffers (CRCs valid) is
    corrupt, not resumable."""
    bad = str(tmp_path / "lies.ckpt")
    manifest, buffers = checkpoint._read_raw(twopc3_snapshot)
    buffers["new"] = np.uint32(int(buffers["new"]) + 1)
    manifest["buffers"]["new"]["crc32"] = checkpoint._crc(buffers["new"])
    checkpoint._write_file(bad, manifest, buffers)
    load_snapshot(bad)
    with pytest.raises(SnapshotCorruptError, match="contradict"):
        _sm(3).resume_from(bad)


@pytest.mark.parametrize("damage", ["swap", "sentinel"])
def test_visited_prefix_checked(tmp_path, twopc3_snapshot, damage):
    """A visited prefix out of order, or with a sentinel inside its live
    rows (CRCs valid), is refused by ``resume_from`` as corrupt."""
    bad = str(tmp_path / f"{damage}.ckpt")
    manifest, buffers = checkpoint._read_raw(twopc3_snapshot)
    vk = np.array(buffers["vkeys"])
    if damage == "swap":
        vk[:, [0, 1]] = vk[:, [1, 0]]
    else:
        vk[:, int(buffers["new"]) - 1] = 0xFFFFFFFF
    buffers["vkeys"] = vk
    manifest["buffers"]["vkeys"]["crc32"] = checkpoint._crc(vk)
    checkpoint._write_file(bad, manifest, buffers)
    load_snapshot(bad)
    with pytest.raises(SnapshotCorruptError, match="visited prefix"):
        _sm(3).resume_from(bad)


# -- the hybrid ---------------------------------------------------------------


class _SlowHostTwoPhase(TwoPhaseSys):
    """Host enumeration slowed, so the device side wins the race (the
    device engine calls actions() only to replay paths)."""

    def actions(self, state):
        time.sleep(0.002)
        return super().actions(state)


def test_hybrid_resumes_its_device_side(twopc3_snapshot):
    """The hybrid's device side resumes from the snapshot, its host side
    starts fresh; the loser is cancelled and joined."""
    before = threading.active_count()
    hy = _SlowHostTwoPhase(rm_count=3).checker().spawn_hybrid(
        capacity=1 << 12, device="cpu")
    hy.resume_from(twopc3_snapshot)
    hy.join()
    assert hy.winner == "device"
    assert hy.unique_state_count() == 288
    device = hy.engines["device"]
    assert device.metrics["resume_load_sec"] >= 0
    assert threading.active_count() == before


# -- the CLI, a real process kill ---------------------------------------------


def test_cli_killed_and_resumed(tmp_path):
    """``2pc check-gpu 4 --device cpu`` killed by ``STPU_FAULTS`` at a
    wave boundary exits 137 with its snapshot on disk; ``--resume``
    continues it to 1,568."""
    snap = str(tmp_path / "cli.ckpt")
    env = dict(os.environ, PYTHONPATH=ROOT,
               STPU_FAULTS="kill@chunk_boundary:5")
    args = [sys.executable, "-m", "stateright_tpu_torch", "2pc",
            "check-gpu", "4", "--device", "cpu", "--checkpoint-every=2",
            f"--checkpoint-path={snap}"]
    p = subprocess.run(args, capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=120)
    assert p.returncode == faultinject.KILL_EXIT_CODE, p.stderr
    assert os.path.exists(snap)
    assert load_snapshot(snap)[0]["wave"] == 6
    env.pop("STPU_FAULTS")
    p = subprocess.run(args[:-2] + ["--resume", f"--checkpoint-path={snap}"],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=120)
    assert p.returncode == 0, p.stderr
    assert "resuming from" in p.stdout and "wave 6" in p.stdout
    assert "Done. states=8258, unique=1568, depth=14" in p.stdout


# -- mesh snapshots and the re-shard (the sharded engines, parallel/) ---------


def _mesh(S, rm=4, **kw):
    kw.setdefault("capacity", 1 << 11)
    kw.setdefault("frontier_capacity", 512)
    return TwoPhaseSys(rm_count=rm).checker().spawn_sharded_sortmerge(
        devices=["cpu"] * S, **kw)


def _mesh_hash(S, rm=4, **kw):
    kw.setdefault("capacity", 1 << 12)
    return TwoPhaseSys(rm_count=rm).checker().spawn_sharded_hash(
        devices=["cpu"] * S, frontier_capacity=512, **kw)


def _counts(c) -> tuple:
    return (c.unique_state_count(), c.state_count(), c.max_depth(),
            c.discovered_property_names())


def test_mesh_2pc4_every_boundary_same_shard_and_2_to_4(tmp_path):
    """2pc rm=4 at S = 2, killed at every wave boundary, resumes at S = 2
    to the uninterrupted run's every field and path, and re-sharded at
    S = 4 and on the one-device engine to its counts, with paths that
    replay (JAX ``tests/test_checkpoint.py:181``)."""
    base = _mesh(2).join()
    assert base.unique_state_count() == 1568
    for wave in range(base.metrics["waves"] - 1):
        snap = str(tmp_path / f"mesh{wave}.ckpt")
        _kill_at(lambda **kw: _mesh(2, **kw), snap, wave)
        same = _resume(lambda: _mesh(2), snap)
        assert _fields(same) == _fields(base), wave
        assert _paths(same) == _paths(base), wave
        for target in (_mesh(4), _sm(4)):
            manifest = target.resume_from(snap)
            assert (manifest["n_shards"], manifest["kind"],
                    manifest["shard_layout"]) == (2, "sharded", "packed")
            target.join()
            assert _counts(target) == _counts(base), wave
    _replays(target)


def test_single_snapshot_resumes_sharded(tmp_path):
    """A one-device snapshot re-shards onto S = 2 and 3, a tiered one
    un-tiered on the way (the sharded engines keep their keys on the
    device)."""
    base = _sm(5, capacity=1 << 15, frontier_capacity=1 << 13).join()
    snap = str(tmp_path / "single.ckpt")
    _kill_at(lambda **kw: _sm(5, capacity=1 << 15,
                              frontier_capacity=1 << 13, **kw), snap, 6)
    tiered = str(tmp_path / "tiered.ckpt")
    _kill_at(lambda **kw: _sm(5, capacity=1 << 15,
                              frontier_capacity=1 << 13,
                              tier_hot_rows=1024, **kw), tiered, 12)
    assert load_snapshot(tiered)[0]["tier"]["spills"] >= 1
    for path, S in ((snap, 2), (snap, 3), (tiered, 2)):
        c = _resume(lambda: _mesh(S, rm=5, capacity=1 << 14,
                                  frontier_capacity=1 << 12), path)
        assert _counts(c) == _counts(base), (path, S)
        _replays(c)


def test_reshard_refuses_a_small_target(tmp_path, twopc3_snapshot):
    with pytest.raises(SnapshotIncompatibleError,
                       match=r"re-shard: shard \d of 2 would own"):
        _mesh(2, rm=3, capacity=2).resume_from(twopc3_snapshot)


def test_hash_reshard_directions(tmp_path):
    """The sharded hash snapshot re-shards by re-insertion S_a -> S_b in
    both directions, and, beyond JAX (which refuses it), single ⇄
    sharded; the same layout uploads directly
    (JAX ``tests/test_checkpoint.py:270``)."""
    base = _mesh_hash(2).join()
    assert base.unique_state_count() == 1568
    snap2, snap4, one = (str(tmp_path / f"{n}.ckpt")
                         for n in ("h2", "h4", "h1"))
    _kill_at(lambda **kw: _mesh_hash(2, **kw), snap2, 5)
    _kill_at(lambda **kw: _mesh_hash(4, **kw), snap4, 7)
    _kill_at(lambda **kw: _hash(4, **kw), one, 6)
    same = _resume(lambda: _mesh_hash(2), snap2)
    assert _fields(same) == _fields(base) and _paths(same) == _paths(base)
    for path, spawn in ((snap2, lambda: _mesh_hash(4)),
                        (snap4, lambda: _mesh_hash(2)),
                        (one, lambda: _mesh_hash(3)),
                        (snap2, lambda: _hash(4))):
        c = _resume(spawn, path)
        assert _counts(c) == _counts(base), path
        _replays(c)
    with pytest.raises(SnapshotIncompatibleError,
                       match="hash re-shard: shard 1 of 2 exhausted"):
        _mesh_hash(2, capacity=1 << 9).resume_from(snap2)


@pytest.fixture(scope="module")
def jax_mesh_snapshot(tmp_path_factory):
    """JAX's sharded sort-merge 2pc rm=4 at S = 2, one wave a sync: the
    run resumed from its snapshot at wave 5, and that snapshot."""
    from stateright_tpu import faultinject as jax_faults
    from stateright_tpu.models.two_phase_commit import (
        TwoPhaseSys as JaxTwoPhase,
    )

    snap = str(tmp_path_factory.mktemp("jax_mesh") / "mesh.ckpt")

    def spawn(**kw):
        return JaxTwoPhase(rm_count=4).checker().spawn_tpu_sharded_sortmerge(
            n_shards=2, capacity=1 << 11, frontier_capacity=256,
            cand_capacity=4096, bucket_capacity=2048, waves_per_sync=1,
            **kw)

    c = spawn(checkpoint_every=1, checkpoint_path=snap)
    c.max_fault_retries = 0
    jax_faults.arm("raise", "chunk_boundary", 5)
    try:
        with pytest.raises(jax_faults.InjectedFault):
            c.join()
    finally:
        jax_faults.disarm_all()
    resumed = spawn()
    resumed.resume_from(snap)
    return resumed.join(), snap


def test_jax_mesh_snapshot_resumes_on_port(jax_mesh_snapshot):
    """A JAX mesh snapshot resumes on the port at S = 2 to JAX's resumed
    run in every field and path, and re-shards onto S = 4 and one device
    to its counts; its carry, converted (``convert.mesh_from_numpy``),
    continues to the same fields as the JAX engine does."""
    from stateright_tpu.checkpoint import load_snapshot as jax_load
    from stateright_tpu_torch.convert import mesh_from_numpy

    jax_run, snap = jax_mesh_snapshot
    same = _resume(lambda: _mesh(2), snap)
    assert _fields(same) == _fields(jax_run)
    assert _paths(same) == _paths(jax_run)
    for spawn in (lambda: _mesh(4), lambda: _sm(4)):
        c = _resume(spawn, snap)
        assert _counts(c) == _counts(jax_run)
        _replays(c)
    manifest, carry = jax_load(snap)
    st = mesh_from_numpy(carry, n_shards=2, capacity=manifest["capacity"],
                         frontier_capacity=manifest["frontier_capacity"],
                         props=list(TwoPhaseSys(rm_count=4).properties()))
    c = _mesh(2).start_from(st).join()
    assert _fields(c) == _fields(jax_run) and _paths(c) == _paths(jax_run)


def test_port_mesh_snapshots_pass_jax_load_snapshot(tmp_path):
    """A port mesh snapshot of either family passes JAX's
    ``load_snapshot`` with JAX's mesh leaves and manifest."""
    from stateright_tpu.checkpoint import load_snapshot as jax_load

    for family, spawn in (("sortmerge", _mesh), ("hash", _mesh_hash)):
        snap = str(tmp_path / f"{family}.ckpt")
        c = _kill_at(lambda **kw: spawn(3, **kw), snap, 4)
        manifest, buffers = jax_load(snap)
        assert (manifest["family"], manifest["kind"], manifest["n_shards"],
                manifest["shard_layout"]) == (family, "sharded", 3, "packed")
        assert int(buffers["new"]) == manifest["unique"] == \
            c._unique_states
        if family == "sortmerge":
            assert int(buffers["u_loc"].sum()) == manifest["unique"]
            assert buffers["vkeys"].shape == (2, manifest["unique"])
            assert buffers["n_loc"].shape == buffers["pl_n"].shape == (3,)
        else:
            assert buffers["t_lo"].shape == (3 * c.capacity,)
            assert int(buffers["n_loc"].sum()) == buffers["frontier"].shape[0]


def test_reshard_equals_jax_reshard(jax_mesh_snapshot):
    """The port's re-shard of JAX's mesh snapshot onto S = 3 places
    every key, frontier row and parent-log entry where JAX's does."""
    from stateright_tpu.checkpoint import load_snapshot as jax_load
    from stateright_tpu.checkpoint import reshard_sortmerge as jax_reshard
    from stateright_tpu.models.two_phase_commit import (
        TwoPhaseSys as JaxTwoPhase,
    )

    _, snap = jax_mesh_snapshot
    manifest, buffers = jax_load(snap)
    target = JaxTwoPhase(rm_count=4).checker().spawn_tpu_sharded_sortmerge(
        n_shards=3, capacity=1 << 11, frontier_capacity=256,
        cand_capacity=4096, bucket_capacity=2048)
    out = jax_reshard(dict(manifest), dict(buffers), target)
    want = checkpoint._sortmerge_blocks(
        snap, dict(manifest, n_shards=3), out)
    got = checkpoint.reshard_sortmerge(
        checkpoint._sortmerge_blocks(snap, manifest, buffers), _mesh(3))
    for w, g in zip(want, got):
        for leaf in ("keys", "frontier", "ebits", "plog"):
            np.testing.assert_array_equal(w[leaf], g[leaf], leaf)
