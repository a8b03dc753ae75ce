"""The PyTorch port's host depth-first search (checkers/dfs.py) and the
CLI's ``check`` subcommand, held against the JAX package's
``spawn_dfs`` and ``check`` lanes: ``state_count``, unique count,
depth, ``Path.encode()`` of every discovery and the visitor's call
order, on 2pc rm=3/4, increment 3, paxos 1c, the register n=3 under
``.symmetry()`` and ABD 1c ordered."""

import contextlib
import io
import re

import pytest


def _port(name):
    from stateright_tpu_torch.actor import Network
    from stateright_tpu_torch.models.increment import Increment
    from stateright_tpu_torch.models.linearizable_register import (
        AbdModelCfg,
        abd_model,
    )
    from stateright_tpu_torch.models.nclient_register import NClientRegSys
    from stateright_tpu_torch.models.paxos import PaxosModelCfg, paxos_model
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    return {
        "2pc rm=3": lambda: TwoPhaseSys(rm_count=3).checker(),
        "2pc rm=4": lambda: TwoPhaseSys(rm_count=4).checker(),
        "increment 3": lambda: Increment(3).checker(),
        "paxos 1c": lambda: paxos_model(PaxosModelCfg(1, 3)).checker(),
        "register 3 sym": lambda: NClientRegSys(3).checker().symmetry(),
        "abd 1c ordered": lambda: abd_model(
            AbdModelCfg(1, 2), Network.new_ordered()).checker(),
    }[name]()


def _jax(name):
    from stateright_tpu.actor import Network
    from stateright_tpu.models.increment import Increment
    from stateright_tpu.models.linearizable_register import (
        AbdModelCfg,
        abd_model,
    )
    from stateright_tpu.models.nclient_register import NClientRegSys
    from stateright_tpu.models.paxos import PaxosModelCfg, paxos_model
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys

    return {
        "2pc rm=3": lambda: TwoPhaseSys(rm_count=3).checker(),
        "2pc rm=4": lambda: TwoPhaseSys(rm_count=4).checker(),
        "increment 3": lambda: Increment(3).checker(),
        "paxos 1c": lambda: paxos_model(PaxosModelCfg(1, 3)).checker(),
        "register 3 sym": lambda: NClientRegSys(3).checker().symmetry(),
        "abd 1c ordered": lambda: abd_model(
            AbdModelCfg(1, 2), Network.new_ordered()).checker(),
    }[name]()


#: (configuration, unique count, whether the visitor's calls are
#: compared: one host replay a state, so the largest space skips it)
CASES = [
    ("2pc rm=3", 288, True),
    ("2pc rm=4", 1568, False),
    ("increment 3", None, True),
    ("paxos 1c", 265, False),
    ("register 3 sym", None, True),
    ("abd 1c ordered", None, True),
]


@pytest.mark.parametrize("name,unique,visit", CASES,
                         ids=[c[0] for c in CASES])
def test_dfs_matches_jax(name, unique, visit):
    logs = {"jax": [], "port": []}
    runs = {}
    for side, builder in (("jax", _jax(name)), ("port", _port(name))):
        if visit:
            log = logs[side]
            builder = builder.visitor(lambda m, p, log=log:
                                      log.append(p.encode()))
        runs[side] = builder.spawn_dfs().join()
    j, p = runs["jax"], runs["port"]
    assert p.unique_state_count() == j.unique_state_count()
    if unique is not None:
        assert p.unique_state_count() == unique
    assert p.state_count() == j.state_count()
    assert p.max_depth() == j.max_depth()
    jd, pd = j.discoveries(), p.discoveries()
    assert set(pd) == set(jd)
    for prop in jd:
        assert pd[prop].encode() == jd[prop].encode(), prop
    assert logs["port"] == logs["jax"]
    if visit:
        assert len(logs["port"]) > 1


def test_dfs_cancel_event_stops_it():
    """A set cancel event stops the search at its next pop, with the
    partial counts so far."""
    import threading

    from stateright_tpu_torch.checkers.dfs import DfsChecker
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    c = DfsChecker(TwoPhaseSys(rm_count=3).checker())
    c.cancel_event = threading.Event()
    c.cancel_event.set()
    c.join()
    assert c.cancelled
    assert c.unique_state_count() == 1 and c.discoveries() == {}


def _mask_sec(text):
    return re.sub(r"sec=[0-9.]+", "sec=X", text)


@pytest.mark.parametrize("args", [["2pc", "check", "3"],
                                  ["increment", "check", "3"]],
                         ids=lambda a: " ".join(a))
def test_cli_check_matches_jax_lane(args):
    """``check`` prints the JAX lane's header, report and paths (both in
    ONE process, so frozenset reprs iterate alike)."""
    from stateright_tpu.cli import main as jax_main
    from stateright_tpu_torch.cli import main as port_main

    out_j, out_p = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out_j):
        jax_main(list(args))
    with contextlib.redirect_stdout(out_p):
        port_main(list(args))
    assert "Done. states=" in out_p.getvalue()
    assert _mask_sec(out_p.getvalue()) == _mask_sec(out_j.getvalue())


def test_cli_check_refuses_reduction_flags():
    from stateright_tpu_torch.cli import main as port_main

    with pytest.raises(SystemExit, match="apply to check-gpu"):
        port_main(["2pc", "check", "3", "--symmetry"])
