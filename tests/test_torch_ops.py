"""The PyTorch port's device ops held against the JAX package: the
fingerprint fold, the packed sort keys, the bitmask word helpers, and
the batched 2pc encoding on every reachable state of rm=3 and rm=4.

Inputs come from numpy seeds and go through both packages; every
comparison is exact (integer ops)."""

import numpy as np
import pytest
import torch

M32 = 0xFFFFFFFF


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _np(t):
    return t.numpy().astype(np.uint64)


def _lane_block(rng, w, n):
    """uint32 ``[W, N]`` with random lanes plus columns of zeros, of
    all-ones, and lanes at or above 2**31."""
    block = rng.integers(0, 2 ** 32, size=(w, n), dtype=np.uint32)
    block[:, 0] = 0
    block[:, 1] = M32
    block[:, 2:40] |= np.uint32(0x80000000)
    return block


@pytest.mark.parametrize("w", [1, 2, 19])
def test_fold_bit_equal_to_jax(w):
    import jax.numpy as jnp

    from stateright_tpu.ops.fingerprint import (
        fingerprint_u32v,
        fingerprint_u32v_t,
    )
    from stateright_tpu_torch.ops import fingerprint as tfp

    rng = np.random.default_rng(100 + w)
    block = _lane_block(rng, w, 4096)
    j_lo, j_hi = fingerprint_u32v_t(jnp.asarray(block), jnp)
    t_lo, t_hi = tfp.fingerprint_u32v_t(_t(block))
    assert (_np(t_lo) == np.asarray(j_lo)).all()
    assert (_np(t_hi) == np.asarray(j_hi)).all()
    # row-major entry point against the numpy host fold
    n_lo, n_hi = fingerprint_u32v(block.T, np)
    r_lo, r_hi = tfp.fingerprint_u32v(_t(block.T))
    assert (_np(r_lo) == n_lo).all() and (_np(r_hi) == n_hi).all()
    # never both zero (the NonZeroU64 rule)
    assert not ((_np(t_lo) == 0) & (_np(t_hi) == 0)).any()


def test_pack_keys_orders_like_unsigned_pair():
    from stateright_tpu_torch.ops import fingerprint as tfp

    rng = np.random.default_rng(5)
    lo = rng.integers(0, 2 ** 32, size=5000, dtype=np.uint64)
    hi = rng.integers(0, 2 ** 32, size=5000, dtype=np.uint64)
    hi[:100] = 0x80000000
    hi[100:200] = 0x7FFFFFFF
    hi[200:210] = M32
    lo[200:205] = M32
    keys = tfp.pack_keys(_t(lo), _t(hi))
    order = torch.argsort(keys, stable=True).numpy()
    want = np.lexsort((lo, hi))
    u64 = (hi << np.uint64(32)) | lo
    assert (u64[order] == u64[want]).all()
    back_lo, back_hi = tfp.unpack_keys(keys)
    assert (_np(back_lo) == lo).all() and (_np(back_hi) == hi).all()
    sent = tfp.pack_keys(_t([M32]), _t([M32]))
    assert int(sent[0]) == tfp.SENTINEL_KEY == torch.iinfo(torch.int64).max
    clamped = tfp.clamp_keys(sent)
    c_lo, c_hi = tfp.unpack_keys(clamped)
    assert (int(c_lo[0]), int(c_hi[0])) == (M32, M32 - 1)
    assert tfp.key_to_fp(int(keys[7])) == int(u64[7])


def test_bitmask_helpers_equal_jax():
    import jax
    import jax.numpy as jnp

    from stateright_tpu.ops import bitmask as jb
    from stateright_tpu_torch.ops import bitmask as tb

    rng = np.random.default_rng(9)
    for k in (1, 31, 32, 33, 47, 64, 95):
        assert tb.mask_words(k) == jb.mask_words(k)
        slots = sorted(set(rng.integers(0, k, size=5).tolist()))
        assert tb.slot_mask_host(k, slots) == jb.slot_mask_host(k, slots)
        L = jb.mask_words(k)
        words = rng.integers(0, 2 ** 32, size=(64, L), dtype=np.uint32)
        if k % 32:
            words[:, -1] &= np.uint32((1 << (k % 32)) - 1)
        j_mask = np.asarray(jb.words_to_mask(jnp, jnp.asarray(words), k))
        assert (tb.words_to_mask(_t(words), k).numpy() == j_mask).all()
        j_pop = np.asarray(jb.popcount_words(jnp, jnp.asarray(words)))
        assert (tb.popcount_words(_t(words)).numpy() == j_pop).all()
        classes = [jb.slot_mask_host(k, [s]) for s in slots]
        classes.append(tuple([0] * L))
        conds = rng.random((64, len(classes))) < 0.5

        def jax_row(c):
            return jb.or_class_words(
                jnp, [(c[i], w) for i, w in enumerate(classes)], L
            )

        j_or = np.asarray(jax.vmap(jax_row)(jnp.asarray(conds)))
        t_or = tb.or_class_words(
            [(torch.from_numpy(conds[:, i]), w)
             for i, w in enumerate(classes)], L,
        )
        assert (t_or.numpy() == j_or).all()


def _reachable_vecs(rm):
    """Every reachable 2pc state of the JAX host model, encoded by the
    JAX encoding (host BFS)."""
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu.models.two_phase_commit_tpu import (
        TwoPhaseSysEncoded,
    )

    model = TwoPhaseSys(rm_count=rm)
    enc = TwoPhaseSysEncoded(rm)
    seen = set()
    frontier = list(model.init_states())
    for s in frontier:
        seen.add(s)
    while frontier:
        nxt = []
        for s in frontier:
            for a in model.actions(s):
                t = model.next_state(s, a)
                if t not in seen:
                    seen.add(t)
                    nxt.append(t)
        frontier = nxt
    return np.stack([enc.encode(s) for s in seen]), enc


@pytest.mark.parametrize("rm,count", [(3, 288), (4, 1568)])
def test_2pc_encoding_equal_on_reachable_space(rm, count):
    import jax
    import jax.numpy as jnp

    from stateright_tpu.ops.bitmask import words_to_mask
    from stateright_tpu_torch.models.two_phase_commit_tpu import (
        TwoPhaseSysEncoded,
    )

    vecs, jenc = _reachable_vecs(rm)
    assert len(vecs) == count
    tenc = TwoPhaseSysEncoded(rm)
    states_t = _t(vecs.T)
    K = jenc.max_actions

    j_bits = np.asarray(jax.vmap(jenc.enabled_bits_vec)(jnp.asarray(vecs)))
    t_bits = tenc.enabled_bits_cols(states_t)
    assert (t_bits.numpy() == j_bits).all()

    j_props = np.asarray(
        jax.vmap(jenc.property_conditions_vec)(jnp.asarray(vecs))
    )
    assert (tenc.property_conditions_cols(states_t).numpy() == j_props).all()

    mask = np.asarray(words_to_mask(jnp, jnp.asarray(j_bits), K))
    rows, slots = np.nonzero(mask)
    j_succ = np.asarray(
        jax.vmap(jenc.step_slot_vec)(
            jnp.asarray(vecs[rows]), jnp.asarray(slots.astype(np.uint32))
        )
    )
    t_succ, trunc, hard = tenc.step_slot_cols(states_t[:, rows], _t(slots))
    assert trunc is None and hard is None
    assert (t_succ.numpy().T == j_succ).all()

    # host halves agree: same encodings of the same states
    for row in vecs[:50]:
        state = tenc.decode(row)
        assert (tenc.encode(state) == row).all()
    assert (tenc.init_vecs() == jenc.init_vecs()).all()
