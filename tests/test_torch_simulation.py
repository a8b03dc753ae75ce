"""The PyTorch port's device simulation (checkers/tpu_simulation.py), on
the CPU, held bit for bit against the JAX package's
``spawn_tpu_simulation`` at the same ``seed``, ``n_walks``,
``max_steps`` and ``rounds``: ``state_count``, ``max_depth``, the
discovered names, the discovery fingerprints and ``Path.encode()`` of
every frozen trace. The configurations are the JAX pins of
tests/test_tpu_simulation.py, one Paxos and one compiled encoding.
Also: the RNG against the JAX fold, first-index ties, the refusals,
row chunking and reproducibility."""

import numpy as np
import pytest
import torch


def _port(name):
    from stateright_tpu_torch.models.increment import Increment, IncrementLock
    from stateright_tpu_torch.models.paxos import PaxosModelCfg, paxos_model
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.models.two_phase_commit_actors import (
        two_phase_sys_actor_model,
        two_phase_sys_compiled_encoded,
    )

    return {
        "increment 3": lambda: (Increment(3), {}),
        "increment-lock 2": lambda: (IncrementLock(2), {}),
        "2pc rm=3": lambda: (TwoPhaseSys(rm_count=3), {}),
        "paxos 1c": lambda: (paxos_model(PaxosModelCfg(1, 3)), {}),
        "2pc-actors rm=3": lambda: (
            two_phase_sys_actor_model(3),
            dict(encoded=two_phase_sys_compiled_encoded(3))),
    }[name]()


def _jax(name):
    from stateright_tpu.models.increment import Increment, IncrementLock
    from stateright_tpu.models.paxos import PaxosModelCfg, paxos_model
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu.models.two_phase_commit_actors import (
        two_phase_sys_actor_model,
        two_phase_sys_compiled_encoded,
    )

    return {
        "increment 3": lambda: (Increment(3), {}),
        "increment-lock 2": lambda: (IncrementLock(2), {}),
        "2pc rm=3": lambda: (TwoPhaseSys(rm_count=3), {}),
        "paxos 1c": lambda: (paxos_model(PaxosModelCfg(1, 3)), {}),
        "2pc-actors rm=3": lambda: (
            two_phase_sys_actor_model(3),
            dict(encoded=two_phase_sys_compiled_encoded(3))),
    }[name]()


#: (model, n_walks, max_steps, rounds, seed, the names it must find:
#: None = the host DFS's set)
CASES = [
    ("increment 3", 256, 16, 2, 0, {"fin"}),
    ("increment 3", 128, 12, 4, 7, {"fin"}),
    ("increment-lock 2", 128, 24, 2, 0, set()),
    ("2pc rm=3", 512, 24, 4, 0, None),
    ("paxos 1c", 64, 16, 1, 0, {"value chosen"}),
    ("2pc-actors rm=3", 1024, 16, 1, 0, None),
]


def _sim(model, enc_kw, walks, steps, rounds, seed, spawn, **kw):
    return getattr(model.checker(), spawn)(
        n_walks=walks, max_steps=steps, rounds=rounds, seed=seed,
        **enc_kw, **kw).join()


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-seed{c[4]}")
def test_simulation_matches_jax(case):
    name, walks, steps, rounds, seed, want = case
    jm, jkw = _jax(name)
    pm, pkw = _port(name)
    j = _sim(jm, jkw, walks, steps, rounds, seed, "spawn_tpu_simulation")
    p = _sim(pm, pkw, walks, steps, rounds, seed, "spawn_device_simulation",
             device="cpu")
    assert p.state_count() == j.state_count() == walks * (1 + rounds * steps)
    assert p.unique_state_count() == p.state_count()
    assert p.max_depth() == j.max_depth()
    assert p.discovered_property_names() == j.discovered_property_names()
    if want is None:
        want = set(pm.checker().spawn_dfs().join().discoveries())
    assert p.discovered_property_names() == want
    assert p.discovery_fingerprints() == j.discovery_fingerprints()
    jd, pd = j.discoveries(), p.discoveries()
    assert set(pd) == set(jd)
    for prop, path in pd.items():
        assert path.encode() == jd[prop].encode(), prop
        # the frozen trace ends at the discovering state
        cond = pm.property_by_name(prop).condition(pm, path.last_state())
        assert cond == (prop != "fin")


def test_rand_bits_match_jax_fold():
    """The RNG is the JAX ``rand_bits``: the low word of
    ``fingerprint_u32v`` over rows ``[base, walk]``, with every product
    of the base wrapped mod 2**32."""
    from stateright_tpu.ops.fingerprint import fingerprint_u32v
    from stateright_tpu_torch.checkers.tpu_simulation import rand_bits

    n = 97
    for seed in (0, 7, 0xFFFFFFFF, 123456789):
        for step in (0, 1, 5, 63, 1 << 20):
            for salt in (0, 1, 3, 1 << 30):
                with np.errstate(over="ignore"):
                    base = (np.uint32(seed)
                            ^ (np.uint32(step) * np.uint32(0x9E3779B9))
                            ^ np.uint32((salt * 0x85EBCA6B) & 0xFFFFFFFF))
                    rows = np.stack([np.full(n, base, np.uint32),
                                     np.arange(n, dtype=np.uint32)], axis=1)
                    lo, _ = fingerprint_u32v(rows, np)
                got = rand_bits(seed, step, salt, n).numpy()
                assert np.array_equal(got, lo.astype(np.int64)), (
                    seed, step, salt)


def test_ties_go_to_the_first_index():
    """``first_true`` and the uniform choice pick the FIRST true index,
    as ``jnp.argmax`` does, with rows of no valid slot at 0."""
    import jax.numpy as jnp

    from stateright_tpu_torch.checkers.tpu_simulation import (
        first_true,
        uniform_choice,
    )

    rng = np.random.default_rng(3)
    valid = rng.random((300, 9)) < 0.4
    valid[:5] = False  # terminal rows
    valid[5:10] = True
    r = rng.integers(0, 1 << 32, 300, dtype=np.int64)
    pick = (r.astype(np.uint32)
            % np.maximum(valid.sum(1), 1).astype(np.uint32))
    want = np.asarray(jnp.argmax(jnp.cumsum(valid, axis=1)
                                 > jnp.asarray(pick)[:, None], axis=1))
    got = uniform_choice(torch.from_numpy(valid), torch.from_numpy(r))
    assert np.array_equal(got.numpy(), want)
    mask = rng.random((4, 50)) < 0.1
    mask[0] = False
    mask[1] = True
    assert np.array_equal(first_true(torch.from_numpy(mask)).numpy(),
                          np.asarray(jnp.argmax(mask, axis=1)))


def test_refusals():
    from stateright_tpu_torch.models.increment import Increment
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    fast = Increment(3).checker().spawn_device_simulation(
        n_walks=256, max_steps=16, rounds=2, track_paths=False,
        device="cpu")
    assert fast.discovered_property_names() == {"fin"}
    with pytest.raises(RuntimeError, match="track_paths"):
        fast.discoveries()
    with pytest.raises(ValueError, match="symmetry reduction: "
                       "spawn_device_simulation cannot honor it"):
        TwoPhaseSys(3).checker().symmetry().spawn_device_simulation(
            device="cpu")

    class SparseOnly:
        """2pc's sparse contract without its dense ``step_cols``."""

        def __init__(self, enc):
            self._enc = enc

        def __getattr__(self, name):
            if name == "step_cols":
                raise AttributeError(name)
            return getattr(self._enc, name)

    model = TwoPhaseSys(3)
    with pytest.raises(ValueError, match="needs step_cols"):
        model.checker().spawn_device_simulation(
            encoded=SparseOnly(model.to_encoded()), device="cpu")
    # the card unless the caller asks for the CPU: no silent fallback
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model.checker().spawn_device_simulation().join()


def test_reproducible_and_chunking_changes_nothing(monkeypatch):
    """Same seed, same run; a chunk budget of a few rows (many row
    chunks a step) gives the same run; another seed takes other
    paths."""
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    model = TwoPhaseSys(3)
    enc = model.to_encoded()

    def run(**kw):
        c = model.checker().spawn_device_simulation(
            n_walks=200, max_steps=12, rounds=2, device="cpu", **kw).join()
        return (c.state_count(), c.max_depth(), c.discovery_fingerprints(),
                {k: v.encode() for k, v in c.discoveries().items()})

    a = run(seed=7)
    assert run(seed=7) == a
    from stateright_tpu_torch.checkers import tpu_simulation

    monkeypatch.setattr(tpu_simulation, "DENSE_CHUNK_BYTES",
                        8 * enc.width * enc.max_actions * 7)  # 7 rows
    assert run(seed=7) == a
    assert run(seed=8)[3] != a[3]
