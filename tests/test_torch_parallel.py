"""The PyTorch port's sharded engines (stateright_tpu_torch/parallel/) on
the CPU, one controller over ``["cpu"] * S``, held against the JAX
package's sharded engines on its virtual 8-device mesh and against the
port's one-device engines.

* ``2pc`` rm=3 at S = 1/2/8 with paths: 288, the host's property set,
  paths that replay (JAX ``tests/test_parallel.py`` :23, :209);
* at S = 2 and 8, equal to JAX's sharded sort-merge run: discovery
  fingerprints, ``Path.encode()`` and each shard's visited set at the
  end; at S = 2 each shard's visited keys, frontier block, eventually
  bits and parent log at three wave boundaries (snapshots of both);
* Paxos 1c/3s sparse with paths at S = 1/2: 265 (:243), and the dense
  wave in row chunks at S = 2 (the port's memory-lean path, :276);
* the max-depth target (:162), EVENTUALLY (:108), ``symmetry()`` and
  ``ample_set`` at S = 2 equal to the one-device port; S = 1 equal to
  ``spawn_sortmerge`` in every field;
* the hash family at S = 1/2/8 (288), with JAX's fast-mode discovery
  fingerprints (:187) and, with paths, JAX's paths;
* a per-shard overflow names its shard.

Every check is exact. The JAX runs share module-scoped fixtures.
JAX's own slow pin, rm=5 at S = 8 (:48), is ``slow`` here too."""

import numpy as np
import pytest
import torch

from stateright_tpu_torch.models.paxos import PaxosModelCfg, paxos_model
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

SM = dict(capacity=512, frontier_capacity=128)


def _sm(S, rm=3, **kw):
    return TwoPhaseSys(rm_count=rm).checker().spawn_sharded_sortmerge(
        devices=["cpu"] * S, **{**SM, **kw})


def _fields(c) -> tuple:
    return (c.unique_state_count(), c.state_count(), c.max_depth(),
            c.discovery_fingerprints())


def _paths(c) -> dict:
    return {name: path.encode() for name, path in c.discoveries().items()}


def _replays(c) -> None:
    for name, path in c.discoveries().items():
        prop = c.model.property_by_name(name)
        assert prop.condition(c.model, path.last_state()), name


@pytest.fixture(scope="module")
def host_2pc3():
    return TwoPhaseSys(rm_count=3).checker().spawn_bfs().join()


@pytest.fixture(scope="module")
def jax_sm():
    """JAX's sharded sort-merge 2pc rm=3 at S = 2 and 8 (final tables
    kept)."""
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as J

    out = {}
    for S in (2, 8):
        c = J(rm_count=3).checker().spawn_tpu_sharded_sortmerge(
            n_shards=S, cand_capacity=1024, bucket_capacity=512, **SM)
        c.keep_final_carry = True
        out[S] = c.join()
    return out


@pytest.mark.parametrize("S", [1, 2, 8])
def test_sharded_2pc_matches_host(S, host_2pc3):
    c = _sm(S).join()
    assert c.unique_state_count() == host_2pc3.unique_state_count() == 288
    assert sorted(c.discoveries()) == sorted(host_2pc3.discoveries())
    c.assert_properties()
    _replays(c)
    assert c.metrics["n_shards"] == S
    assert sum(c.metrics["shard_unique"]) == 288
    assert (c.metrics["shuffle_volume"] == 0) == (S == 1)


@pytest.mark.parametrize("S", [2, 8])
def test_sharded_sortmerge_equals_jax(S, jax_sm):
    from stateright_tpu_torch.tier import pack_keys_np

    j, c = jax_sm[S], _sm(S).join()
    assert _fields(c) == (j.unique_state_count(), j.state_count(),
                          j.max_depth(), j.discovery_fingerprints())
    assert _paths(c) == _paths(j)
    assert c.metrics["shuffle_volume"] == j.metrics["shuffle_volume"]
    vk, _plog, _pl_n, u_loc = (np.asarray(a) for a in j._final_tables)
    stride = vk.shape[1] // S
    for s in range(S):
        blk = vk[:, s * stride:s * stride + int(u_loc[s])]
        np.testing.assert_array_equal(
            c._final.shards[s].vkeys.numpy(), pack_keys_np(blk[0], blk[1]))


def test_sharded_blocks_equal_jax_at_wave_boundaries(tmp_path):
    """Each shard's visited keys, frontier block, eventually bits and
    parent log, snapshot by snapshot, equal JAX's at S = 2."""
    from stateright_tpu import faultinject as jf
    from stateright_tpu.checkpoint import load_snapshot as jax_load
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as J
    from stateright_tpu_torch import faultinject
    from stateright_tpu_torch.checkpoint import _sortmerge_blocks, load_snapshot

    for wave in (1, 4, 7):
        js, ps = str(tmp_path / f"j{wave}.ckpt"), str(tmp_path / f"p{wave}")
        j = J(rm_count=3).checker().spawn_tpu_sharded_sortmerge(
            n_shards=2, cand_capacity=1024, bucket_capacity=512,
            waves_per_sync=1, checkpoint_every=1, checkpoint_path=js, **SM)
        p = _sm(2, checkpoint_every=1, checkpoint_path=ps)
        for c, fi in ((j, jf), (p, faultinject)):
            c.max_fault_retries = 0
            fi.arm("raise", "chunk_boundary", wave)
            with pytest.raises(fi.InjectedFault):
                c.join()
            fi.disarm_all()
        blocks = [_sortmerge_blocks(path, *load(path)) for path, load in
                  ((js, jax_load), (ps, load_snapshot))]
        assert len(blocks[0]) == len(blocks[1]) == 2
        for jb, pb in zip(*blocks):
            for leaf in ("keys", "frontier", "ebits", "plog"):
                np.testing.assert_array_equal(jb[leaf], pb[leaf], leaf)


def _paxos(**kw):
    return paxos_model(PaxosModelCfg(client_count=1, server_count=3)) \
        .checker().spawn_sharded_sortmerge(
            capacity=1 << 10, frontier_capacity=1 << 7, **kw)


@pytest.fixture(scope="module")
def host_paxos1():
    return paxos_model(PaxosModelCfg(client_count=1, server_count=3)) \
        .checker().spawn_bfs().join()


@pytest.mark.parametrize("S", [1, 2])
def test_sharded_sparse_paxos_with_paths(S, host_paxos1):
    c = _paxos(devices=["cpu"] * S).join()
    assert c.metrics["expansion"] == "sparse"
    assert c.unique_state_count() == 265
    assert sorted(c.discoveries()) == sorted(host_paxos1.discoveries())
    assert len(c.discovery("value chosen").actions()) >= 1
    _replays(c)


def test_sharded_dense_chunked_paxos(host_paxos1):
    c = _paxos(devices=["cpu"] * 2, sparse=False,
               dense_chunk_bytes=1 << 12).join()
    assert c.metrics["expansion"] == "dense"
    assert c.metrics["max_wave_chunks"] > 1
    assert c.unique_state_count() == 265
    assert sorted(c.discoveries()) == sorted(host_paxos1.discoveries())
    _replays(c)


def test_single_shard_equals_one_device_engine():
    one = TwoPhaseSys(rm_count=3).checker().spawn_sortmerge(
        device="cpu", **SM).join()
    c = _sm(1).join()
    assert _fields(c) == _fields(one)
    assert _paths(c) == _paths(one)
    for k in ("waves", "max_wave_candidates", "max_wave_new",
              "member_shape", "merge_shape", "widest_wave"):
        assert c.metrics[k] == one.metrics[k], k
    assert torch.equal(c._final.shards[0].vkeys, one._final.vkeys)


@pytest.mark.parametrize("case", ["target_max_depth", "symmetry",
                                  "ample_set", "symmetry+ample_set"])
def test_options_equal_one_device(case):
    def builder():
        b = TwoPhaseSys(rm_count=4).checker()
        if case == "target_max_depth":
            b = b.target_max_depth(5)
        if "symmetry" in case:
            b = b.symmetry()
        return b

    kw = dict(ample_set="ample_set" in case, capacity=1 << 11,
              frontier_capacity=512)
    one = builder().spawn_sortmerge(device="cpu", **kw).join()
    c = builder().spawn_sharded_sortmerge(devices=["cpu"] * 2, **kw).join()
    assert (c.unique_state_count(), c.state_count(), c.max_depth()) == (
        one.unique_state_count(), one.state_count(), one.max_depth())
    assert c.discovered_property_names() == one.discovered_property_names()
    if case == "target_max_depth":
        assert c.max_depth() == 5 and c.unique_state_count() < 1568
    if "symmetry" in case:
        assert c.metrics["canonical_hits"] > 0
    _replays(c)


def _dgraph():
    from stateright_tpu_torch.encoding import EncodedModelBase
    from stateright_tpu_torch.fixtures import DGraph
    from stateright_tpu_torch.model import Property

    class DGraphEncoded(EncodedModelBase):
        """1 -> {2, 4}, 2 -> {3}, in the port's column contract."""

        width = 1
        max_actions = 2

        def __init__(self, model):
            self.host_model = model

        def init_vecs(self):
            return np.array([[1]], dtype=np.uint32)

        def encode(self, state):
            return np.array([state], dtype=np.uint32)

        def step_cols(self, states_t):
            node = states_t[0]
            s1 = torch.where(node == 1, 2, 3)
            succ = torch.stack([s1, torch.full_like(node, 4)], dim=1)
            valid = torch.stack([(node == 1) | (node == 2), node == 1],
                                dim=1)
            return succ[None], valid, None

        def property_conditions_cols(self, states_t):
            return (states_t[0] == 3)[:, None]

    model = (DGraph.with_path([1, 2, 3]).path([1, 4])
             .property(Property.eventually("reaches 3",
                                           lambda m, s: s == 3)))
    return model, DGraphEncoded(model)


@pytest.mark.parametrize("family", ["sortmerge", "hash"])
def test_sharded_eventually_property(family):
    model, enc = _dgraph()
    spawn = getattr(model.checker(), f"spawn_sharded_{family}")
    c = spawn(encoded=enc, devices=["cpu"] * 4, capacity=64,
              frontier_capacity=8).join()
    assert c.assert_any_discovery("reaches 3").states() == [1, 4]


def _hash(S, rm=3, **kw):
    kw = {"capacity": 1 << 10, "frontier_capacity": 128, **kw}
    return TwoPhaseSys(rm_count=rm).checker().spawn_sharded_hash(
        devices=["cpu"] * S, **kw)


@pytest.fixture(scope="module")
def jax_hash():
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as J

    return {paths: J(rm_count=3).checker().spawn_tpu_sharded(
        n_shards=2, capacity=1 << 10, frontier_capacity=128,
        cand_capacity=512, bucket_capacity=256, track_paths=paths).join()
        for paths in (True, False)}


@pytest.mark.parametrize("S", [1, 2, 8])
def test_sharded_hash_matches_host(S, host_2pc3):
    c = _hash(S).join()
    assert (c.unique_state_count(), c.state_count(), c.max_depth()) == (
        288, 1146, 11)
    assert sorted(c.discoveries()) == sorted(host_2pc3.discoveries())
    _replays(c)
    assert sum(c.metrics["shard_unique"]) == 288


@pytest.mark.parametrize("paths", [True, False], ids=["paths", "fast"])
def test_sharded_hash_equals_jax(paths, jax_hash):
    j, c = jax_hash[paths], _hash(2, track_paths=paths).join()
    assert _fields(c) == (j.unique_state_count(), j.state_count(),
                          j.max_depth(), j.discovery_fingerprints())
    assert c.metrics["shuffle_volume"] == j.metrics["shuffle_volume"]
    if paths:
        assert _paths(c) == _paths(j)
    else:
        assert c.discovered_property_names() == {"abort agreement",
                                                 "commit agreement"}
        with pytest.raises(RuntimeError, match="track_paths=False"):
            c.discoveries()


@pytest.mark.parametrize("family", ["sortmerge", "hash"])
def test_per_shard_overflow_names_the_shard(family):
    spawn = _sm if family == "sortmerge" else _hash
    c = spawn(2, rm=4, frontier_capacity=16)
    with pytest.raises(RuntimeError, match=r"shard \d of 2: frontier "
                                           "overflow"):
        c.join()


def test_spawn_without_devices_never_picks_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("the refusal is for a host without a card")
    for spawn in ("spawn_sharded_sortmerge", "spawn_sharded_hash"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(TwoPhaseSys(rm_count=3).checker(), spawn)(n_shards=2)


@pytest.mark.slow
def test_sharded_2pc_5rms_8832():
    c = _sm(8, rm=5, capacity=1 << 12, frontier_capacity=512,
            track_paths=False).join()
    assert c.unique_state_count() == 8832
    c.assert_properties()
    assert c.metrics["shuffle_volume"] > 0
