"""The PyTorch port's open-addressing visited set (ops/hashset.py), on
the CPU, held against the JAX package's ``ops/hashset.py``: the plain
``insert`` equals the JAX ``insert`` (its ``jnp`` while-loop, as
tests/test_tpu_engine.py runs it) and its numpy path array for array —
table limbs, ``is_new``, ``overflow`` and ``slot`` — on batches with
in-batch duplicates, a second batch into the filled table, a tight
table where keys overflow, and the edges (no rows, inactive rows, a
batch of all-ones keys); the highest row of a duplicated new key wins;
``_slot_hash``, ``sort_unique`` and ``contains`` are bit-equal to JAX.
The CUDA kernel is held to the plain version on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

from stateright_tpu.ops import hashset as jhs
from stateright_tpu_torch.ops import hashset as phs
from stateright_tpu_torch.ops.fingerprint import pack_keys


def _keys(lo, hi):
    return pack_keys(torch.from_numpy(lo.astype(np.int64)),
                     torch.from_numpy(hi.astype(np.int64)))


def _pool_batch(rng, n, pool):
    """n keys drawn from ``pool`` (so with in-batch duplicates), random
    64-bit fingerprints never (0, 0)."""
    pick = rng.integers(0, len(pool), size=n)
    return pool[pick, 0].copy(), pool[pick, 1].copy()


def _jax_insert(table, lo, hi, active, rounds):
    import jax.numpy as jnp

    t, new, over, slot = jhs.insert(
        table, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(active), jnp,
        rounds=rounds)
    return t, np.asarray(new), np.asarray(over), np.asarray(slot)


def _np_insert(table, lo, hi, active, rounds):
    return jhs.insert(table, lo, hi, active, np, rounds=rounds)


def _port_insert(table, lo, hi, active, rounds):
    t, new, over, slot = phs.insert(table, _keys(lo, hi),
                                    torch.from_numpy(active), rounds)
    return t, new.numpy(), over.numpy(), slot.numpy()


def _same(port, ref):
    """Port result equals a JAX-side result array for array."""
    pt, pn, po, ps = port
    rt, rn, ro, rs = ref
    assert np.array_equal(pt.lo.numpy(), np.asarray(rt.lo, np.int64))
    assert np.array_equal(pt.hi.numpy(), np.asarray(rt.hi, np.int64))
    assert np.array_equal(pn, np.asarray(rn))
    assert np.array_equal(po, np.asarray(ro))
    assert np.array_equal(ps, np.asarray(rs, np.int64))


#: (label, capacity, rounds, batches of (n keys, pool size), share active)
CASES = [
    ("duplicates then a second batch", 1024, 24, [(600, 150), (600, 300)],
     0.9),
    ("tight table overflows", 256, 2, [(400, 1000)], 1.0),
    ("no rows", 64, 24, [(0, 10)], 1.0),
    ("all inactive", 64, 24, [(50, 10)], 0.0),
]


@pytest.mark.parametrize("label,capacity,rounds,batches,share", CASES,
                         ids=[c[0] for c in CASES])
def test_insert_matches_jax(label, capacity, rounds, batches, share):
    import jax.numpy as jnp

    rng = np.random.default_rng(20261017)
    pool = rng.integers(1, 2**32, size=(1000, 2), dtype=np.uint32)
    tables = {"jax": jhs.DeviceHashSet.empty(capacity, jnp),
              "np": jhs.DeviceHashSet.empty(capacity, np),
              "port": phs.DeviceHashSet.empty(capacity)}
    overflowed = 0
    for n, pool_n in batches:
        lo, hi = _pool_batch(rng, n, pool[:pool_n])
        active = rng.random(n) < share
        out = {"jax": _jax_insert(tables["jax"], lo, hi, active, rounds),
               "np": _np_insert(tables["np"], lo, hi, active, rounds),
               "port": _port_insert(tables["port"], lo, hi, active,
                                    rounds)}
        _same(out["port"], out["jax"])
        _same(out["port"], out["np"])
        tables = {k: v[0] for k, v in out.items()}
        overflowed += int(out["port"][2].sum())
        assert not (out["port"][1] & ~active).any()
    assert (overflowed > 0) == (label == "tight table overflows")


def test_all_ones_keys_match_jax():
    """A batch of the all-ones fingerprint (the sort-merge engines'
    padding sentinel; a plain key here) inserts once, its last row
    winning."""
    import jax.numpy as jnp

    lo = hi = np.full(7, 0xFFFFFFFF, np.uint32)
    active = np.ones(7, bool)
    port = _port_insert(phs.DeviceHashSet.empty(16), lo, hi, active, 24)
    ref = _jax_insert(jhs.DeviceHashSet.empty(16, jnp), lo, hi, active, 24)
    _same(port, ref)
    assert port[1].nonzero()[0].tolist() == [6]


def test_duplicate_winner_is_the_highest_row():
    """Of the rows holding one absent key, the highest reports is_new:
    the JAX scatter-max of row + 1. Keys [5, 7, 5, 9, 5, 7] mark rows 3,
    4 and 5 in both."""
    import jax.numpy as jnp

    lo = np.array([5, 7, 5, 9, 5, 7], np.uint32)
    hi = np.zeros(6, np.uint32)
    active = np.ones(6, bool)
    port = _port_insert(phs.DeviceHashSet.empty(64), lo, hi, active, 24)
    ref = _jax_insert(jhs.DeviceHashSet.empty(64, jnp), lo, hi, active, 24)
    _same(port, ref)
    assert port[1].nonzero()[0].tolist() == [3, 4, 5]
    # every row's slot holds its key
    t = port[0]
    assert (t.keys[torch.from_numpy(port[3])] == _keys(lo, hi)).all()


def test_slot_hash_bit_equal():
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    k = rng.integers(0, 2**32, size=(4096, 2), dtype=np.uint32)
    k[:16] = 0xFFFFFFFF
    k[16:32, 0] = 0xFFFFFFFF
    k[32:48, 1] = 0xFFFFFFFF
    k[48:64, 1] = 0x80000000
    for cap in (2, 1 << 10, 1 << 25, 1 << 32):
        mask = cap - 1
        port = phs._slot_hash(_keys(k[:, 0], k[:, 1]), mask).numpy()
        ref = jhs._slot_hash(jnp.asarray(k[:, 0]), jnp.asarray(k[:, 1]),
                             jnp.uint32(mask), jnp)
        assert np.array_equal(port, np.asarray(ref, np.int64)), cap


def test_sort_unique_and_contains_match_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    pool = rng.integers(1, 2**32, size=(200, 2), dtype=np.uint32)
    pool[:3] = [[0xFFFFFFFF, 0xFFFFFFFF], [0, 0x80000000],
                [0xFFFFFFFF, 0x7FFFFFFF]]
    lo, hi = _pool_batch(rng, 700, pool)
    (s_keys, order), first = phs.sort_unique(_keys(lo, hi))
    (j_lo, j_hi, j_order), j_first = jhs.sort_unique(
        jnp.asarray(lo), jnp.asarray(hi), jnp)
    assert torch.equal(s_keys, _keys(np.asarray(j_lo), np.asarray(j_hi)))
    assert np.array_equal(first.numpy(), np.asarray(j_first))
    # equal keys keep their input order in both (stable)
    assert np.array_equal(order.numpy(), np.asarray(j_order, np.int64))

    table = phs.DeviceHashSet.empty(512)
    j_table = jhs.DeviceHashSet.empty(512, jnp)
    half = rng.random(700) < 0.5
    phs.insert(table, _keys(lo, hi), torch.from_numpy(half))
    j_table, *_ = jhs.insert(j_table, jnp.asarray(lo), jnp.asarray(hi),
                             jnp.asarray(half), jnp)
    probe_lo, probe_hi = _pool_batch(rng, 500, pool)
    found = phs.contains(table, _keys(probe_lo, probe_hi)).numpy()
    j_found = np.asarray(jhs.contains(
        j_table, jnp.asarray(probe_lo), jnp.asarray(probe_hi), jnp))
    assert np.array_equal(found, j_found)
    assert found.any() and not found.all()


def test_non_power_of_two_capacity_raises():
    with pytest.raises(ValueError, match="power of two"):
        phs.DeviceHashSet.empty(1000)


def test_cuda_impl_on_cpu_tensors_raises():
    """``impl="cuda"`` never takes the plain version, and the kernel's
    wrapper refuses CPU tensors: no fallback."""
    table = phs.DeviceHashSet.empty(64)
    keys = _keys(np.array([5], np.uint32), np.array([1], np.uint32))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        phs.insert(table, keys, impl="cuda")
    with pytest.raises(ValueError, match="one CUDA device"):
        phs.insert_cuda(table, keys)
    assert phs.insert_cuda.launches == 0
    assert not table.occupied().any()
