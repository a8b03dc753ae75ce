"""The PyTorch port's sort-merge wave engine, on the CPU, held against
the JAX package's ``spawn_tpu_sortmerge(merge_impl="xla")`` at 2pc
rm=3 and rm=4: unique count, ``states=``, depth, discovered set,
discovery fingerprints and path fingerprints, all exact; the same
where ``target_state_count`` / ``target_max_depth`` stop the run. Also
the CLI
report against the JAX lane's, a run continued from a JAX mid-depth
carry (convert.carry_from_numpy), and the loud overflows."""

import contextlib
import io
import re

import numpy as np
import pytest

# the small single-class JAX spawn shapes of tests/test_merge.py
JAX_SHAPES = dict(capacity=1 << 11, frontier_capacity=1 << 9,
                  cand_capacity=1 << 11, waves_per_sync=4,
                  merge_impl="xla")


def _jax_checker(rm, **kw):
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys

    return TwoPhaseSys(rm_count=rm).checker().spawn_tpu_sortmerge(
        **JAX_SHAPES, **kw
    )


def _port_checker(rm, **kw):
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    kw.setdefault("capacity", 1 << 11)
    return TwoPhaseSys(rm_count=rm).checker().spawn_sortmerge(
        device="cpu", **kw
    )


@pytest.fixture(scope="module")
def jax_runs():
    runs = {}
    for rm in (3, 4):
        c = _jax_checker(rm)
        c.join()
        runs[rm] = c
    return runs


@pytest.mark.parametrize("rm,unique", [(3, 288), (4, 1568)])
def test_engine_matches_jax(jax_runs, rm, unique):
    j = jax_runs[rm]
    p = _port_checker(rm).join()
    assert p.unique_state_count() == j.unique_state_count() == unique
    assert p.state_count() == j.state_count()
    assert p.max_depth() == j.max_depth()
    assert p.discovered_property_names() == j.discovered_property_names()
    assert p.discovery_fingerprints() == j.discovery_fingerprints()
    assert "consistent" not in p.discovered_property_names()
    jd, pd = j.discoveries(), p.discoveries()
    assert set(jd) == set(pd)
    for name in jd:
        assert pd[name].fingerprints() == jd[name].fingerprints(), name
        assert pd[name].actions() == jd[name].actions(), name
    p.assert_properties()


def test_boundary_matches_jax():
    """A non-trivial boundary (RM 0 never aborts) prunes successors the
    same way in both engines: counts, `states=` (in-boundary candidates
    only), depth, discoveries and paths."""
    from stateright_tpu.models.two_phase_commit_tpu import (
        TwoPhaseSysEncoded as JaxEnc,
    )
    from stateright_tpu_torch.models.two_phase_commit_tpu import (
        TwoPhaseSysEncoded as PortEnc,
    )

    class JaxBounded(JaxEnc):
        def within_boundary_vec(self, vec):
            return (vec[0] & 3) != 3

    class PortBounded(PortEnc):
        def within_boundary_cols(self, states_t):
            return (states_t[0] & 3) != 3

    j = _jax_checker(3, encoded=JaxBounded(3)).join()
    p = _port_checker(3, encoded=PortBounded(3)).join()
    assert p.unique_state_count() == j.unique_state_count() < 288
    assert p.state_count() == j.state_count()
    assert p.max_depth() == j.max_depth()
    assert p.discovery_fingerprints() == j.discovery_fingerprints()
    assert p.discovered_property_names() == {"commit agreement"}
    for name, path in j.discoveries().items():
        assert p.discovery(name).fingerprints() == path.fingerprints()


def test_paths_off_same_counts():
    on = _port_checker(3).join()
    off = _port_checker(3, track_paths=False).join()
    assert (off.unique_state_count(), off.state_count(), off.max_depth()) \
        == (on.unique_state_count(), on.state_count(), on.max_depth())
    assert off.discovery_fingerprints() == on.discovery_fingerprints()
    with pytest.raises(RuntimeError, match="track_paths=False"):
        off.discoveries()


def test_overflow_raises():
    with pytest.raises(RuntimeError, match="visited table overflow"):
        _port_checker(3, capacity=100).join()
    with pytest.raises(RuntimeError, match="frontier overflow"):
        _port_checker(3, frontier_capacity=8).join()


@pytest.mark.parametrize("target,value", [("state_count", 100),
                                          ("max_depth", 5)])
def test_targets_stop_where_jax_stops(target, value):
    """``target_state_count`` stops after the wave that reaches it and
    ``target_max_depth`` expands no state at that depth, in the port as
    in the JAX engine run one wave a chunk: the same counts, depth,
    discovery fingerprints and paths."""
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as Jax
    from stateright_tpu_torch.models.two_phase_commit import (
        TwoPhaseSys as Port,
    )

    jb = getattr(Jax(rm_count=3).checker(), f"target_{target}")(value)
    pb = getattr(Port(rm_count=3).checker(), f"target_{target}")(value)
    j = jb.spawn_tpu_sortmerge(**dict(JAX_SHAPES, waves_per_sync=1)).join()
    p = pb.spawn_sortmerge(capacity=1 << 11, device="cpu").join()
    assert 0 < p.unique_state_count() == j.unique_state_count() < 288
    assert p.state_count() == j.state_count()
    assert p.max_depth() == j.max_depth()
    assert p.discovery_fingerprints() == j.discovery_fingerprints()
    jd, pd = j.discoveries(), p.discoveries()
    assert set(pd) == set(jd)
    for name in jd:
        assert pd[name].encode() == jd[name].encode(), name


def _mask_sec(text):
    return re.sub(r"sec=[0-9.]+", "sec=X", text)


def test_cli_report_matches_jax_lane():
    """Both lanes in ONE process, so frozenset reprs iterate alike; the
    header line names the engine and differs by design."""
    from stateright_tpu.cli import main as jax_main
    from stateright_tpu_torch.cli import main as port_main

    out_j, out_p = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out_j):
        jax_main(["2pc", "check-tpu", "3"])
    with contextlib.redirect_stdout(out_p):
        port_main(["2pc", "check-gpu", "3", "--device", "cpu"])
    j_lines = _mask_sec(out_j.getvalue()).splitlines()
    p_lines = _mask_sec(out_p.getvalue()).splitlines()
    assert p_lines[0] == (
        "Checking two phase commit with 3 resource managers on the CPU "
        "wave engine."
    )
    assert p_lines[1].startswith("Done. states=1146, unique=288, depth=11")
    assert p_lines[1:] == j_lines[1:]


def test_continue_from_jax_mid_depth_carry(jax_runs):
    """Seed the JAX engine, run one chunk (4 waves), carry its visited
    set and frontier across, and finish on the port: the same final
    visited set and counts as the JAX run to completion."""
    import jax.numpy as jnp

    from stateright_tpu_torch.convert import carry_from_numpy
    from stateright_tpu_torch.ops.fingerprint import unpack_keys

    j = _jax_checker(4)
    init = np.asarray(j.encoded.init_vecs(), np.uint32)
    seed_fn, chunk_fn = j._lookup_programs(init.shape[0])
    carry, _ = chunk_fn(seed_fn(jnp.asarray(init)))
    c = {k: np.asarray(v) for k, v in carry.items()}
    assert not c["done"] and int(c["depth"]) == 5
    state = carry_from_numpy(
        c["vkeys"], c["frontier"], int(c["n_frontier"]), c["ebits"],
        depth=int(c["depth"]),
        generated=int(c["gen_lo"]) | (int(c["gen_hi"]) << 32),
    )
    assert state.vkeys.numel() == int(c["new"])
    p = _port_checker(4, track_paths=False).start_from(state).join()
    full = jax_runs[4]
    assert p.unique_state_count() == full.unique_state_count() == 1568
    assert p.state_count() == full.state_count()
    assert p.max_depth() == full.max_depth()
    lo, hi = unpack_keys(p._final.vkeys)
    j_vkeys = np.asarray(full._final_tables[0])[:, :1568]
    assert (lo.numpy() == j_vkeys[0]).all()
    assert (hi.numpy() == j_vkeys[1]).all()
