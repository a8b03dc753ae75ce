"""The PyTorch port's hash wave engine (``spawn_hash``, checkers/tpu.py),
on the CPU, held against the JAX package's ``spawn_tpu``: unique count,
``states=``, depth, discovered names, discovery fingerprints and
``Path.encode()`` of every discovery, at 2pc rm=3 (288 unique, 1,146
states, depth 11) and rm=5 (8,832, 58,146, depth 17), paxos 1c/3s
(265), the compiled ``2pc-actors`` rm=3 through its dense step, the
DGraph eventually case (both engines report the path [1, 4]), and runs
stopped by ``target_max_depth`` / ``target_state_count``. Also: every
overflow raises with the JAX engine's message and leaves the
discoveries made before it readable, symmetry and a visitor are
refused, and the 70% occupancy warning fires once with the JAX text."""

import re
import warnings

import numpy as np
import pytest
import torch


def _port(name):
    from stateright_tpu_torch.models.paxos import PaxosModelCfg, paxos_model
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.models.two_phase_commit_actors import (
        two_phase_sys_actor_model,
        two_phase_sys_compiled_encoded,
    )

    if name.startswith("2pc rm="):
        return TwoPhaseSys(rm_count=int(name[-1])).checker(), None
    if name == "2pc-actors rm=3":
        return (two_phase_sys_actor_model(3).checker(),
                two_phase_sys_compiled_encoded(3))
    c = int(name[6])
    return paxos_model(PaxosModelCfg(c, 3)).checker(), None


def _jax(name):
    from stateright_tpu.models.paxos import PaxosModelCfg, paxos_model
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu.models.two_phase_commit_actors import (
        two_phase_sys_actor_model,
        two_phase_sys_compiled_encoded,
    )

    if name.startswith("2pc rm="):
        return TwoPhaseSys(rm_count=int(name[-1])).checker(), None
    if name == "2pc-actors rm=3":
        return (two_phase_sys_actor_model(3).checker(),
                two_phase_sys_compiled_encoded(3))
    c = int(name[6])
    return paxos_model(PaxosModelCfg(c, 3)).checker(), None


SIZES = dict(capacity=1 << 15, frontier_capacity=1 << 12)


def _pair(name, **targets):
    """(JAX run, port run) of one configuration, both joined."""
    runs = []
    for make, spawn in ((_jax, "spawn_tpu"), (_port, "spawn_hash")):
        builder, enc = make(name)
        for key, value in targets.items():
            builder = getattr(builder, key)(value)
        kw = dict(SIZES, device="cpu") if spawn == "spawn_hash" else SIZES
        if enc is not None:
            kw = dict(kw, encoded=enc)
        runs.append(getattr(builder, spawn)(**kw).join())
    return runs


def _same(j, p):
    assert p.unique_state_count() == j.unique_state_count()
    assert p.state_count() == j.state_count()
    assert p.max_depth() == j.max_depth()
    assert p.discovered_property_names() == j.discovered_property_names()
    assert p.discovery_fingerprints() == j.discovery_fingerprints()
    jd, pd = j.discoveries(), p.discoveries()
    assert set(pd) == set(jd)
    for name in jd:
        assert pd[name].encode() == jd[name].encode(), name


#: (configuration, unique, states, depth)
CASES = [("2pc rm=3", 288, 1146, 11), ("2pc rm=5", 8832, 58146, 17),
         ("paxos 1c", 265, 482, 14), ("2pc-actors rm=3", 288, None, 11)]


@pytest.mark.parametrize("name,unique,states,depth", CASES,
                         ids=[c[0] for c in CASES])
def test_hash_engine_matches_jax(name, unique, states, depth):
    j, p = _pair(name)
    _same(j, p)
    assert p.unique_state_count() == unique
    assert p.max_depth() == depth
    if states is not None:
        assert p.state_count() == states
    assert p.discoveries()
    assert p.metrics["waves"] == depth
    assert 0 < p.metrics["occupancy"] < 0.7


@pytest.mark.slow
def test_paxos_2c_matches_jax():
    j, p = _pair("paxos 2c")
    _same(j, p)
    assert p.unique_state_count() == 16668


@pytest.mark.parametrize("target", [("target_max_depth", 5),
                                    ("target_state_count", 100)],
                         ids=lambda t: f"{t[0]}={t[1]}")
def test_targets_match_jax(target):
    j, p = _pair("2pc rm=3", **dict([target]))
    _same(j, p)
    assert p.unique_state_count() < 288


def _dgraph_port():
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


def _dgraph_jax():
    import jax.numpy as jnp

    from stateright_tpu.fixtures import DGraph
    from stateright_tpu.model import Property

    class DGraphEncoded:
        """tests/test_tpu_engine.py's encoding."""

        width = 1
        max_actions = 2

        def __init__(self, model):
            self.host_model = model

        def init_vecs(self):
            return np.array([[1]], dtype=np.uint32)

        def encode(self, state):
            return np.array([state], dtype=np.uint32)

        def step_vec(self, vec):
            node = vec[0]
            s1 = jnp.where(node == 1, jnp.uint32(2), jnp.uint32(3))
            v1 = (node == 1) | (node == 2)
            return (jnp.stack([vec.at[0].set(s1),
                               vec.at[0].set(jnp.uint32(4))]),
                    jnp.stack([v1, node == 1]))

        def property_conditions_vec(self, vec):
            return jnp.stack([vec[0] == 3])

        def within_boundary_vec(self, vec):
            return True

    model = (DGraph.with_path([1, 2, 3]).path([1, 4])
             .property(Property.eventually("reaches 3",
                                           lambda m, s: s == 3)))
    return model, DGraphEncoded(model)


def test_eventually_counterexample_matches_jax():
    jm, je = _dgraph_jax()
    pm, pe = _dgraph_port()
    j = jm.checker().spawn_tpu(encoded=je, capacity=64,
                               frontier_capacity=8).join()
    p = pm.checker().spawn_hash(encoded=pe, capacity=64, frontier_capacity=8,
                                device="cpu").join()
    _same(j, p)
    assert p.assert_any_discovery("reaches 3").states() == [1, 4]
    assert j.assert_any_discovery("reaches 3").states() == [1, 4]


def _jax_message(kind, **caps):
    """The JAX engine's own overflow text (its ``_overflow_message`` over
    packed stats with one flag set)."""
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys

    c = TwoPhaseSys(rm_count=3).checker().spawn_tpu(**caps)
    s = np.zeros(11, np.uint32)
    s[{"visited": 1, "frontier": 2, "candidates": 9, "encoding": 10}[kind]] = 1
    return c._overflow_message(s)


@pytest.mark.parametrize("kind,caps", [
    ("visited", dict(capacity=64)),
    ("frontier", dict(frontier_capacity=8)),
    ("candidates", dict(cand_capacity=8)),
], ids=lambda x: x if isinstance(x, str) else "")
def test_overflow_raises_with_jax_text(kind, caps):
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    caps = dict(dict(capacity=1 << 12), **caps)
    c = TwoPhaseSys(rm_count=3).checker().spawn_hash(device="cpu", **caps)
    with pytest.raises(RuntimeError) as e:
        c.join()
    head = _jax_message(kind, **caps)
    assert str(e.value).split("  Discoveries recorded")[0] == head


def test_encoding_overflow_keeps_earlier_discoveries():
    """An encoding whose step truncates the successors of every "commit
    agreement" state raises in the wave that discovers it, with the JAX
    text; the discoveries stay readable on a replay."""
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.models.two_phase_commit_tpu import (
        TwoPhaseSysEncoded,
    )

    class Truncating(TwoPhaseSysEncoded):
        def step_cols(self, states_t):
            succ, valid, _ = super().step_cols(states_t)
            return succ, valid, self.property_conditions_cols(states_t)[:, 1]

    c = TwoPhaseSys(rm_count=3).checker().spawn_hash(
        encoded=Truncating(3), capacity=1 << 12, device="cpu")
    with pytest.raises(RuntimeError) as e:
        c.join()
    names = ["abort agreement", "commit agreement"]
    assert str(e.value) == (
        _jax_message("encoding")
        + "  Discoveries recorded before truncation (valid "
        f"counterexamples): {names} — read them via "
        "discovered_property_names() / discovery_fingerprints() after "
        "catching this error.")
    assert sorted(c.discovered_property_names()) == names
    assert set(c.discovery_fingerprints()) == set(names)
    with pytest.raises(RuntimeError, match="encoding-bound overflow"):
        c.unique_state_count()


def test_symmetry_and_visitor_are_refused():
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    with pytest.raises(ValueError, match=r"^symmetry reduction: spawn_hash "
                       "cannot honor it; supported: spawn_dfs"):
        TwoPhaseSys(rm_count=3).checker().symmetry().spawn_hash(
            device="cpu")
    c = TwoPhaseSys(rm_count=3).checker().visitor(
        lambda m, p: None).spawn_hash(device="cpu")
    with pytest.raises(ValueError, match="visitors require a host checker"):
        c.join()


def test_occupancy_warning_fires_once_with_jax_text():
    """2pc rm=4 (1,568 unique) in 2,048 slots crosses 70% before its
    last wave: one warning, the JAX formatter's text (16 bytes a slot:
    the key and, with paths, its parent)."""
    from stateright_tpu.occupancy import occupancy_warning
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        c = TwoPhaseSys(rm_count=4).checker().spawn_hash(
            capacity=2048, probe_rounds=64, device="cpu").join()
    assert c.unique_state_count() == 1568
    msgs = [str(w.message) for w in caught
            if issubclass(w.category, RuntimeWarning)]
    assert len(msgs) == 1, msgs
    used = int(re.search(r"\((\d+)/2048\)", msgs[0]).group(1))
    assert 0.7 * 2048 < used < 1568
    assert msgs[0] == occupancy_warning(used / 2048, used=used,
                                        capacity=2048, bytes_per_row=16)
