"""The PyTorch port's sorted-set ops (stateright_tpu_torch/ops/merge.py)
held against the JAX package's ``xla`` and ``pallas_interpret``
implementations and a numpy oracle, on the case shapes of
tests/test_merge.py with the tie pool widened to ``hi >= 2**31``.

On the CPU every op takes its plain-PyTorch version (the CUDA kernels
run only on the card, where chip_smoke.py holds them against these
same plain versions). Comparisons are exact."""

import numpy as np
import pytest
import torch

SENT = 0xFFFFFFFF
SENT64 = np.uint64(0xFFFFFFFFFFFFFFFF)
JAX_IMPLS = ("xla", "pallas_interpret")


def _keys(vals64):
    vals64 = np.asarray(vals64, np.uint64)
    return (
        (vals64 & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        (vals64 >> np.uint64(32)).astype(np.uint32),
    )


def _u64(lo, hi):
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(
        lo, np.uint64
    )


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _sorted_with_tail(rng, n_real, total, pool):
    vals = np.sort(rng.choice(pool, size=n_real, replace=True))
    vals = np.concatenate([vals, np.full(total - n_real, SENT64)])
    return _keys(vals)


def _jax_trials(jax_impl):
    """Trials also run through the JAX impl: every one for ``xla``, the
    first three for the (slow) Pallas interpreter."""
    return 3 if jax_impl == "pallas_interpret" else 8


def _tie_pool(rng, n):
    """Keys colliding per limb, with hi limbs on both sides of 2**31 (a
    sign-bit slip in the packed int64 key would misorder them)."""
    hi = rng.integers(0, 4, size=n, dtype=np.uint64) + np.uint64(
        0x7FFFFFFE
    )
    hi[: n // 4] = np.uint64(0xFFFFFFFE)
    lo = rng.integers(0, 4, size=n, dtype=np.uint64)
    lo[: n // 8] = np.uint64(0xFFFFFFFF)
    return (hi << np.uint64(32)) | lo


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
@pytest.mark.parametrize("block", [32, 512])
def test_merge_sorted_randomized(jax_impl, block):
    import jax.numpy as jnp

    from stateright_tpu.ops import merge as jm
    from stateright_tpu_torch.ops.merge import merge_sorted

    rng = np.random.default_rng(7)
    for trial in range(8):
        pool = _tie_pool(rng, 64)
        na, nb = int(rng.integers(0, 300)), int(rng.integers(0, 120))
        a_lo, a_hi = _sorted_with_tail(rng, na, 320, pool)
        b_lo, b_hi = _sorted_with_tail(rng, nb, 140, pool)
        m_lo, m_hi = merge_sorted(_t(a_lo), _t(a_hi), _t(b_lo), _t(b_hi),
                                  block=block)
        got = _u64(m_lo.numpy(), m_hi.numpy())
        want = np.sort(np.concatenate([_u64(a_lo, a_hi), _u64(b_lo, b_hi)]),
                       kind="stable")
        assert (got == want).all(), trial
        if trial >= _jax_trials(jax_impl):
            continue
        j_lo, j_hi = jm.merge_sorted(
            jnp.asarray(a_lo), jnp.asarray(a_hi), jnp.asarray(b_lo),
            jnp.asarray(b_hi), impl=jax_impl, block=block,
        )
        assert (got == _u64(np.asarray(j_lo), np.asarray(j_hi))).all()


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
@pytest.mark.parametrize("block", [32, 512])
def test_member_sorted_randomized(jax_impl, block):
    import jax.numpy as jnp

    from stateright_tpu.ops import merge as jm
    from stateright_tpu_torch.ops.merge import member_sorted

    rng = np.random.default_rng(11)
    for trial in range(8):
        pool = _tie_pool(rng, 48)
        na, nq = int(rng.integers(0, 300)), int(rng.integers(0, 200))
        a_lo, a_hi = _sorted_with_tail(rng, na, 320, pool)
        q_lo, q_hi = _sorted_with_tail(rng, nq, 220, pool)
        got = member_sorted(_t(a_lo), _t(a_hi), _t(q_lo), _t(q_hi),
                            block=block).numpy()
        want = np.isin(_u64(q_lo, q_hi), _u64(a_lo, a_hi))
        assert (got == want).all(), trial
        if trial >= _jax_trials(jax_impl):
            continue
        j = np.asarray(jm.member_sorted(
            jnp.asarray(a_lo), jnp.asarray(a_hi), jnp.asarray(q_lo),
            jnp.asarray(q_hi), impl=jax_impl, block=block,
        ))
        assert (got == j).all(), trial


@pytest.mark.parametrize("block", [32, 512])
def test_merge_path_starts_equal_jax(block):
    import jax.numpy as jnp

    from stateright_tpu.ops import merge as jm
    from stateright_tpu_torch.ops.merge import merge_path_starts

    rng = np.random.default_rng(13)
    for trial in range(8):
        pool = _tie_pool(rng, 40)
        na, nb = int(rng.integers(0, 300)), int(rng.integers(0, 200))
        a_lo, a_hi = _sorted_with_tail(rng, na, 300, pool)
        b_lo, b_hi = _sorted_with_tail(rng, nb, 200, pool)
        got = merge_path_starts(_t(a_lo), _t(a_hi), _t(b_lo), _t(b_hi),
                                block).numpy()
        want = np.asarray(jm.merge_path_starts(
            jnp.asarray(a_lo), jnp.asarray(a_hi), jnp.asarray(b_lo),
            jnp.asarray(b_hi), block,
        ))
        assert (got == want).all(), trial


def test_all_sentinel_and_empty_edges():
    from stateright_tpu_torch.ops.merge import member_sorted, merge_sorted

    s = torch.full((8,), SENT, dtype=torch.int64)
    e = torch.zeros(0, dtype=torch.int64)
    m_lo, m_hi = merge_sorted(s, s, s, s, block=16)
    assert (m_lo == SENT).all() and (m_hi == SENT).all()
    assert member_sorted(s, s, s, s, block=16).all()
    assert merge_sorted(e, e, s, s)[0].shape == (8,)
    assert merge_sorted(s, s, e, e)[0].shape == (8,)
    assert member_sorted(e, e, s, s).shape == (8,)
    assert not member_sorted(e, e, s, s).any()
    assert member_sorted(s, s, e, e).shape == (0,)


def test_cuda_impl_refuses_cpu_tensors():
    """No fallback: asking for the kernel on CPU tensors raises."""
    from stateright_tpu_torch.ops.merge import member_sorted, merge_sorted

    s = torch.full((8,), SENT, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        member_sorted(s, s, s, s, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        merge_sorted(s, s, s, s, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        merge_sorted(s, s, s, s, impl="xla")


def test_dedup_parity_vs_rebuild_sort_oracle():
    """The port's wave dedup (stable candidate sort -> adjacent-equal ->
    membership -> winner compaction -> visited merge) picks the winners
    the retired (V+B)-row stable rebuild sort picked, with the same
    winning candidate per duplicated key, and the same next visited
    set."""
    from stateright_tpu_torch.ops.fingerprint import SENTINEL_KEY, pack_keys
    from stateright_tpu_torch.ops.merge import (
        compact_winners_keys,
        member_keys,
        merge_keys,
    )

    rng = np.random.default_rng(23)
    B = 90
    for trial in range(6):
        pool = _tie_pool(rng, 40)
        vis = np.unique(rng.choice(pool, size=int(rng.integers(1, 120)),
                                   replace=True))
        cand = rng.choice(pool, size=B, replace=True)
        cand[rng.random(B) < 0.2] = SENT64

        m = np.concatenate([vis, cand])
        pos = np.concatenate([np.zeros(len(vis), np.int64),
                              np.arange(1, B + 1)])
        order = np.argsort(m, kind="stable")
        ms, ps = m[order], pos[order]
        prev_same = np.concatenate([[False], ms[1:] == ms[:-1]])
        o_new = (ms != SENT64) & ~prev_same & (ps > 0)
        oracle_pos = set((ps[o_new] - 1).tolist())
        oracle_vis = np.sort(np.concatenate([vis, ms[o_new]]))

        v_key = pack_keys(*map(_t, _keys(vis)))
        c_key = pack_keys(*map(_t, _keys(cand)))
        s_key, s_pos = torch.sort(c_key, stable=True)
        prev = torch.zeros_like(s_key, dtype=torch.bool)
        prev[1:] = s_key[1:] == s_key[:-1]
        is_new = (s_key != SENTINEL_KEY) & ~prev & ~member_keys(v_key, s_key)
        n = int(is_new.sum())
        nf_pos, w_key = compact_winners_keys(is_new, s_pos, s_key, n)
        assert set(nf_pos.tolist()) == oracle_pos, trial
        assert (torch.diff(w_key) > 0).all()
        got = merge_keys(v_key, w_key)
        want = pack_keys(*map(_t, _keys(oracle_vis)))
        assert torch.equal(got, want), trial


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
def test_compact_winners_property(jax_impl):
    import jax.numpy as jnp

    from stateright_tpu.ops import merge as jm
    from stateright_tpu_torch.ops.merge import compact_winners

    rng = np.random.default_rng(7)
    B = 96
    for trial, (nf, p) in enumerate(
        [(96, 0.3), (40, 0.7), (7, 1.0), (5, 0.0), (1, 0.5)]
    ):
        is_new = rng.random(B) < p
        pos = rng.integers(1, B + 1, size=B).astype(np.uint32)
        lo = rng.integers(0, 2 ** 32, size=B, dtype=np.uint32)
        hi = rng.integers(0, 2 ** 32, size=B, dtype=np.uint32)
        got = compact_winners(torch.from_numpy(is_new), _t(pos), _t(lo),
                              _t(hi), nf)
        idx = np.nonzero(is_new)[0][:nf]
        exp = np.full((3, nf), SENT, np.uint32)
        exp[0, :len(idx)] = pos[idx]
        exp[1, :len(idx)] = lo[idx]
        exp[2, :len(idx)] = hi[idx]
        want = jm.compact_winners(
            jnp.asarray(is_new), jnp.asarray(pos), jnp.asarray(lo),
            jnp.asarray(hi), nf, impl=jax_impl,
        )
        for lane in range(3):
            assert (got[lane].numpy() == exp[lane]).all(), (trial, lane)
            assert (got[lane].numpy() == np.asarray(want[lane])).all()
