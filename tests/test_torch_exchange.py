"""The shard route and exchange of the PyTorch port's sharded engines
(stateright_tpu_torch/parallel/exchange.py), against a numpy oracle: the
owner of a key is its low 32 bits mod S; a destination receives, in
source-shard order and within a source in the source's own order, every
non-sentinel row it owns; the rows routed off their source are counted.
Keys with the hi limb at and above 2^31 (negative packed int64), the
sentinel and empty sources are included, at S = 1, 2, 3 and 8. Also the
device-list rules, and the discovery fold's lowest-shard-wins rule."""

import numpy as np
import pytest
import torch

from stateright_tpu_torch.ops.fingerprint import SENTINEL_KEY, pack_keys
from stateright_tpu_torch.parallel import exchange as ex
from stateright_tpu_torch.parallel.shards import fold_discoveries


def _sources(S: int, seed: int) -> list:
    """Per source shard: packed keys (a few sentinels, hi limbs over the
    whole u32 range, so half the packed keys are negative), one source
    empty when S > 1."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(S):
        n = 0 if (S > 1 and s == 1) else int(rng.integers(1, 300))
        lo = torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.int64))
        hi = torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.int64))
        keys = pack_keys(lo, hi)
        if n:
            keys[rng.integers(0, n, max(1, n // 10))] = SENTINEL_KEY
            # duplicates within a source keep their order
            keys[-1] = keys[0]
        out.append(keys)
    return out


def _oracle(sources, S):
    """``received[d]`` as (source, index) pairs, and the off-shard count."""
    recv = [[] for _ in range(S)]
    off = 0
    for s, keys in enumerate(sources):
        for i, k in enumerate(keys.tolist()):
            if k == SENTINEL_KEY:
                continue
            d = (k & 0xFFFFFFFF) % S
            recv[d].append((s, i))
            off += d != s
    return recv, off


@pytest.mark.parametrize("S", [1, 2, 3, 8])
def test_exchange_matches_numpy_oracle(S):
    sources = _sources(S, seed=100 + S)
    devices = ex.resolve_devices(devices=["cpu"] * S)
    routed, counts = [], []
    for s, keys in enumerate(sources):
        # payload lanes: the key, its source and its index there
        payload = torch.stack([keys, torch.full_like(keys, s),
                               torch.arange(keys.numel())])
        block, cnt = ex.route(payload, keys, S)
        routed.append(block)
        counts.append(cnt)
    host = ex.host_rows(counts)
    received = ex.exchange(routed, host, devices)
    want, off = _oracle(sources, S)
    assert ex.routed_off_shard(host) == off
    for d in range(S):
        got = received[d]
        assert got.shape == (3, len(want[d]))
        assert [tuple(p) for p in got[1:].T.tolist()] == want[d]
        assert bool((ex.owner_of(got[0], S) == d).all())
        assert SENTINEL_KEY not in got[0].tolist()
        assert host[d] == [sum(1 for s, _ in want[e] if s == d)
                           for e in range(S)]


def test_owner_is_low_limb_mod_s():
    lo = torch.tensor([0, 1, 7, 0xFFFFFFFF, 0x80000000], dtype=torch.int64)
    hi = torch.tensor([0, 0xFFFFFFFF, 0x80000000, 5, 0x7FFFFFFF],
                      dtype=torch.int64)
    keys = pack_keys(lo, hi)
    for S in (1, 2, 3, 8):
        assert ex.owner_of(keys, S).tolist() == [v % S for v in lo.tolist()]


def test_device_list_rules(monkeypatch):
    assert ex.resolve_devices(devices=["cpu"] * 3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="n_shards=2 but 3"):
        ex.resolve_devices(2, ["cpu"] * 3)
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        ex.resolve_devices(devices=["cpu", "cuda:0"])
    if not torch.cuda.is_available():
        # the CPU is never picked for the caller
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ex.resolve_devices(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert ex.resolve_devices() == [torch.device("cuda", 0),
                                    torch.device("cuda", 1)]
    assert ex.resolve_devices(1) == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="n_shards=3 > 2 available"):
        ex.resolve_devices(3)
    # repeats name one card several times
    assert ex.resolve_devices(devices=["cuda:1"] * 4) == [
        torch.device("cuda", 1)] * 4


def test_discovery_fold_lowest_shard_wins():
    class P:
        def __init__(self, name):
            self.name = name

    props = [P("a"), P("b"), P("c")]
    # per shard [hits a b c, lo a b c, hi a b c]
    rows = [[0, 1, 0, 0, 11, 0, 0, 21, 0],
            [1, 1, 0, 12, 13, 0, 22, 23, 0],
            [1, 0, 0, 14, 0, 0, 24, 0, 0]]
    found = {"b": 99}
    fold_discoveries(props, rows, found)
    assert found == {"a": (22 << 32) | 12, "b": 99}
