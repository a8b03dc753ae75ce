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
chip_smoke.py; here its two kernels are emulated line for line over
random interleavings of the rows' memory actions and held to the plain
version, and ``from_keys`` / ``reset`` to the tag rule they need."""

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


# -- the CUDA kernel's protocol, emulated on the CPU -------------------------
#
# csrc/hashset.cu runs only on the card; these emulate its two kernels
# line for line, each row a generator that yields before every action on
# device memory (the entry's two words read at two moments, the CAS of
# the key, the atomicMax of the tag, and the winner's tag read), stepped
# in a random interleaving, so that rows read a slot between its
# inserter's CAS and the inserter's atomicMax.


def _probe_claim_row(i, key, idx, live, entries, mask, rounds, epoch, out,
                     seen):
    """``probe_claim_kernel`` for row ``i``; ``entries`` a list of
    ``[key, tag]`` (the table's 16-byte entries), ``idx`` its slot hash."""
    at, over, candidate = 0, False, False
    if live:
        mine = (epoch << 32) | (i + 1)
        probe = 0
        while True:
            yield  # the entry's key word (its tag word below)
            cur = entries[idx][0]
            yield
            tag = entries[idx][1]
            if cur == phs.EMPTY:
                yield  # atomicCAS of the key word
                cur = entries[idx][0]
                if cur == phs.EMPTY:
                    entries[idx][0] = key
                    cur = key  # this row inserted it
                tag = 0  # empty at this call's read: filled in this call
            elif cur == key and tag == 0:
                seen["untagged"] += 1  # read before the inserter's atomicMax
            if cur == key:
                at = idx
                candidate = (tag == 0 or tag >> 32 == epoch) and tag < mine
                if candidate:
                    yield  # atomicMax of the tag
                    entries[idx][1] = max(entries[idx][1], mine)
                break
            probe += 1
            if probe >= rounds:
                over = True
                break
            idx = (idx + probe) & mask
    out["slot"][i], out["overflow"][i], out["is_new"][i] = at, over, candidate


def _winner_row(i, entries, epoch, out):
    """``winner_kernel`` for row ``i``."""
    if not out["is_new"][i]:
        return
    yield  # the tag read
    out["is_new"][i] = entries[out["slot"][i]][1] == (epoch << 32) | (i + 1)


def _interleave(rows, rng):
    """Step the row generators to their ends, one action of a random
    row at a time (a kernel: no row waits for another)."""
    live = list(rows)
    while live:
        j = int(rng.integers(len(live)))
        try:
            next(live[j])
        except StopIteration:
            live[j] = live[-1]
            live.pop()


def _emulated_insert(table, keys, active, rounds, rng, seen):
    """``stpu_hash_insert`` on a tagged table: the two launches, each
    interleaved; ``(is_new, overflow, slot)``, the table updated."""
    n = keys.shape[0]
    epoch = phs._next_epoch(table)
    mask = table.capacity - 1
    entries = table.entries.tolist()
    out = {"slot": [0] * n, "overflow": [False] * n, "is_new": [False] * n}
    idx = phs._slot_hash(keys, mask).tolist()
    live = [True] * n if active is None else active.tolist()
    _interleave([_probe_claim_row(i, k, idx[i], live[i], entries, mask,
                                  rounds, epoch, out, seen)
                 for i, k in enumerate(keys.tolist())], rng)
    _interleave([_winner_row(i, entries, epoch, out) for i in range(n)], rng)
    table.entries.copy_(torch.tensor(entries, dtype=torch.int64))
    return (torch.tensor(out["is_new"]), torch.tensor(out["overflow"]),
            torch.tensor(out["slot"], dtype=torch.int64))


def _highest_rows(before, table, keys, active):
    """is_new as rule (a) has it: for each key the call put in the table,
    its highest active row."""
    added = set(table.keys.tolist()) - set(before.tolist())
    want = torch.zeros(keys.shape[0], dtype=torch.bool)
    last = {}
    for i, (k, a) in enumerate(zip(keys.tolist(), active.tolist())):
        if a and k in added:
            last[k] = i
    want[list(last.values())] = True
    return want


def _tagged_table(keys):
    """A tagged table holding ``keys`` on the CPU, built as
    ``DeviceHashSet.from_keys`` builds one on a CUDA device: the entry
    array, then :meth:`DeviceHashSet.reset`."""
    entries = torch.empty((keys.shape[0], 2), dtype=torch.int64)
    table = phs.DeviceHashSet(entries[:, 0], entries)
    table.reset(keys)
    return table


def _entry_set(table):
    return sorted(map(tuple, table.entries.tolist()))


#: (label, capacity, rounds, pre-filled keys, batches of (n, pool), share
#: active): the pool's first ``pre`` keys are in the table before the call
PROTOCOL_CASES = [
    ("empty table", 256, 24, 0, [(240, 60)], 1.0),
    ("from_keys table", 512, 24, 120, [(240, 200)], 1.0),
    ("second call, epoch 2", 256, 24, 0, [(160, 70), (160, 120)], 1.0),
    ("inactive rows", 256, 24, 40, [(240, 100)], 0.6),
    ("tight table overflows", 64, 2, 0, [(150, 120)], 1.0),
]


@pytest.mark.parametrize("label,capacity,rounds,pre,batches,share",
                         PROTOCOL_CASES, ids=[c[0] for c in PROTOCOL_CASES])
def test_kernel_protocol_matches_insert_plain(label, capacity, rounds, pre,
                                              batches, share):
    """The emulated kernel over 20 interleavings: ``is_new`` bit for bit
    ``insert_plain``'s and the highest row of each key the call added,
    the tables equal as sets of ``{key, tag}`` entries, and every live
    row's slot holding its key; in the tight table both report overflow
    instead, and only placements differ."""
    rng = np.random.default_rng(20261017)
    pool = rng.integers(1, 2**32, size=(max(b[1] for b in batches), 2),
                        dtype=np.uint32)
    start = phs.DeviceHashSet.empty(capacity)
    phs.insert(start, _keys(pool[:pre, 0], pool[:pre, 1]))
    calls = []
    for n, pool_n in batches:
        lo, hi = _pool_batch(rng, n, pool[:pool_n])
        calls.append((_keys(lo, hi), torch.from_numpy(rng.random(n) < share)))
    fits = label != "tight table overflows"
    seen = {"untagged": 0}
    for _ in range(20):
        plain = _tagged_table(start.keys)
        kernel = _tagged_table(start.keys)
        for keys, active in calls:
            before = kernel.keys.clone()
            new_p, over_p, _ = phs.insert_plain(plain, keys, active, rounds)
            new_k, over_k, slot_k = _emulated_insert(kernel, keys, active,
                                                     rounds, rng, seen)
            live = active & ~over_k
            assert torch.equal(kernel.keys[slot_k[live]], keys[live])
            assert not (slot_k[~live].any() or new_k[~active].any()
                        or over_k[~active].any())
            assert torch.equal(new_k, _highest_rows(before, kernel, keys,
                                                    active))
            if fits:
                assert not (over_k.any() or over_p.any())
                assert torch.equal(new_k, new_p)
                assert _entry_set(kernel) == _entry_set(plain)
            else:
                assert over_k.any() and over_p.any()
            assert kernel.epoch == plain.epoch
    # the interleavings did read tags before their inserters' atomicMax
    assert seen["untagged"] > 0


def test_from_keys_and_reset_keep_the_tag_rule():
    """Tag 0 on every empty slot and a non-zero epoch-0 tag on every full
    one, from a tagged table's construction (``reset`` into a fresh entry
    array, as ``from_keys`` does on a CUDA device) and from ``reset``
    after calls tagged slots with later epochs; a CPU table, from
    ``empty`` or ``from_keys``, is its key array alone."""
    rng = np.random.default_rng(5)
    table = phs.DeviceHashSet.empty(128)
    lo, hi = _pool_batch(rng, 60, rng.integers(1, 2**32, size=(50, 2),
                                               dtype=np.uint32))
    phs.insert(table, _keys(lo, hi))
    pre = table.keys.clone()
    assert table.entries is None and table.keys.is_contiguous()
    copy = phs.DeviceHashSet.from_keys(pre)
    assert copy.entries is None and torch.equal(copy.keys, pre)
    assert copy.keys.data_ptr() != pre.data_ptr()

    def rule_holds(t):
        full = t.keys != phs.EMPTY
        tag = t.entries[:, 1]
        return (t.epoch == 0 and bool((tag[~full] == 0).all())
                and bool((tag[full] != 0).all())
                and bool(((tag[full] >> 32) == 0).all()))

    tagged = _tagged_table(pre)
    assert torch.equal(tagged.keys, pre) and rule_holds(tagged)
    assert tagged.entries.shape == (128, 2) and tagged.entries.is_contiguous()
    lo2, hi2 = _pool_batch(rng, 80, rng.integers(1, 2**32, size=(40, 2),
                                                 dtype=np.uint32))
    for _ in range(2):  # the second call finds every key old
        phs.insert(tagged, _keys(lo2, hi2))
    assert tagged.epoch == 2 and (tagged.entries[:, 1] >> 32 == 1).any()
    tagged.reset(pre)
    assert torch.equal(tagged.keys, pre) and rule_holds(tagged)
