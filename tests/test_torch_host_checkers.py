"""The PyTorch port's host checkers — ``spawn_bfs`` (sequential and with
``threads(n)``), ``spawn_on_demand`` and ``spawn_simulation`` — held
against the JAX package's on tests/test_checkers.py's models
(``fixtures.py``: LinearEquation, BinaryClock, DGraph, Panicker): counts,
depth, discovered names and ``Path.encode()`` of every discovery, the
visitor's calls, and the simulation at the same seed."""

import pytest

import stateright_tpu.fixtures as jfx
import stateright_tpu_torch.fixtures as pfx
from stateright_tpu.model import Property as JProperty
from stateright_tpu_torch.model import Property as PProperty


def _models(fx, prop):
    """The test_checkers.py models, by name, built from one package."""
    return {
        "linear 2,10,28": lambda: fx.LinearEquation(2, 10, 28),
        "linear 2,4,33 (full space)": lambda: fx.LinearEquation(2, 4, 33),
        "linear 1,1,3": lambda: fx.LinearEquation(1, 1, 3),
        "dgraph always": lambda: fx.DGraph.with_path([1, 2, 3]).property(
            prop.always("under 3", lambda m, s: s < 3)),
        "dgraph eventually satisfied": lambda: fx.DGraph.with_path(
            [1, 2, 3]).property(
            prop.eventually("reaches 3", lambda m, s: s == 3)),
        "dgraph eventually at terminal": lambda: fx.DGraph.with_path(
            [1, 2, 3]).path([1, 4]).property(
            prop.eventually("reaches 3", lambda m, s: s == 3)),
        "dgraph eventually revisit": lambda: fx.DGraph.with_path(
            [1, 2, 3]).path([4, 2]).property(
            prop.eventually("reaches 3", lambda m, s: s == 3)),
        "binary clock": lambda: fx.BinaryClock(),
        "dgraph sees 3": lambda: fx.DGraph.with_path([1, 2, 3]).property(
            prop.sometimes("sees 3", lambda m, s: s == 3)),
    }


def _pair(name):
    return (_models(jfx, JProperty)[name](),
            _models(pfx, PProperty)[name]())


def _same(j, p):
    assert p.unique_state_count() == j.unique_state_count()
    assert p.state_count() == j.state_count()
    assert p.max_depth() == j.max_depth()
    jd, pd = j.discoveries(), p.discoveries()
    assert set(pd) == set(jd)
    for name in jd:
        assert pd[name].encode() == jd[name].encode(), name


#: (model, builder targets, whether the visitor's calls are compared:
#: it replays a path a state, so the full space skips it)
BFS_CASES = [
    ("linear 2,10,28", {}, True),
    ("linear 2,4,33 (full space)", {}, False),
    ("linear 1,1,3", {}, True),
    ("dgraph always", {}, True),
    ("dgraph eventually satisfied", {}, True),
    ("dgraph eventually at terminal", {}, True),
    ("dgraph eventually revisit", {}, True),
    ("binary clock", {}, True),
    ("linear 2,4,33 (full space)", {"target_max_depth": 3}, True),
    ("linear 2,4,33 (full space)", {"target_state_count": 100}, True),
]


@pytest.mark.parametrize("name,targets,visit", BFS_CASES,
                         ids=[f"{n} {t}" if t else n
                              for n, t, _ in BFS_CASES])
def test_bfs_matches_jax(name, targets, visit):
    logs = {"jax": [], "port": []}
    runs = []
    for side, model in zip(("jax", "port"), _pair(name)):
        b = model.checker()
        for key, value in targets.items():
            b = getattr(b, key)(value)
        if visit:
            log = logs[side]
            b = b.visitor(lambda m, path, log=log:
                          log.append(path.encode()))
        runs.append(b.spawn_bfs().join())
    _same(*runs)
    assert logs["port"] == logs["jax"]
    assert (len(logs["port"]) > 0) == visit
    if name == "linear 2,4,33 (full space)" and not targets:
        assert runs[1].unique_state_count() == 65536
    if targets.get("target_max_depth"):
        assert runs[1].unique_state_count() == 6


@pytest.mark.parametrize("name,threads", [("linear 2,4,33 (full space)", 4),
                                          ("linear 2,10,28", 3)])
def test_bfs_threads_matches_jax(name, threads):
    """With worker threads the counts of a full run and the discovered
    SET match the JAX run's; the path that discovers a property can
    differ between runs (the threads race), so it is held to its own
    condition and replays through the port's model."""
    from stateright_tpu_torch.path import Path

    jm, pm = _pair(name)
    j = jm.checker().threads(threads).spawn_bfs().join()
    p = pm.checker().threads(threads).spawn_bfs().join()
    assert set(p.discoveries()) == set(j.discoveries())
    if not p.discoveries():
        assert p.unique_state_count() == j.unique_state_count() == 65536
        assert p.state_count() == j.state_count()
    for prop, path in p.discoveries().items():
        assert pm.property_by_name(prop).condition(pm, path.last_state())
        assert Path.from_fingerprints(pm, path.fingerprints()).encode() \
            == path.encode()


@pytest.mark.parametrize("threads", [1, 4])
def test_bfs_propagates_model_panic(threads):
    with pytest.raises(pfx.PanickerError):
        pfx.Panicker().checker().threads(threads).spawn_bfs().join()


def test_bfs_refuses_symmetry():
    with pytest.raises(ValueError, match="spawn_bfs cannot honor it"):
        pfx.LinearEquation(1, 1, 1).checker().symmetry_fn(
            lambda s: s).spawn_bfs()


SIM_CASES = [("linear 1,1,3", 50_000, 0), ("linear 2,4,33 (full space)",
                                           5_000, 7),
             ("binary clock", 100, 1)]


@pytest.mark.parametrize("name,target,seed", SIM_CASES,
                         ids=[c[0] for c in SIM_CASES])
def test_simulation_matches_jax(name, target, seed):
    """The same seed draws the same traces (a seeded ``random.Random``
    per trace, seeded by the stable hash of (seed, trace index))."""
    runs = [m.checker().target_state_count(target).spawn_simulation(
        seed=seed).join() for m in _pair(name)]
    _same(*runs)
    assert runs[1].state_count() >= target or runs[1].discoveries()


def test_on_demand_matches_jax():
    """Step by step: each requested fingerprint expands the same state,
    with the same counts and discoveries, then the run to completion."""
    from stateright_tpu.fingerprint import fingerprint as jfp
    from stateright_tpu_torch.fingerprint import fingerprint as pfp

    jm, pm = _pair("dgraph sees 3")
    j, p = jm.checker().spawn_on_demand(), pm.checker().spawn_on_demand()
    assert p.unique_state_count() == j.unique_state_count() == 1
    assert not p.is_done() and not j.is_done()
    for node in (1, 2, 3):
        assert pfp(node) == jfp(node)
        j.check_fingerprint(jfp(node))
        p.check_fingerprint(pfp(node))
        assert p.unique_state_count() == j.unique_state_count()
        assert set(p.discoveries()) == set(j.discoveries())
    assert p.is_done() and j.is_done()
    _same(j, p)

    jm, pm = _pair("dgraph eventually at terminal")
    j, p = jm.checker().spawn_on_demand(), pm.checker().spawn_on_demand()
    j.run_to_completion()
    p.run_to_completion()
    # every property is discovered, so the run stops with work pending
    assert p.is_done() == j.is_done() is False
    _same(j, p)
    assert p.assert_any_discovery("reaches 3").states() == [1, 4]
