"""The rest of the host layer of the PyTorch port, held to the JAX
package on the same inputs, with exact equality everywhere:

* ``utils`` (``DenseNatMap``, ``VectorClock``) and the top-level exports;
* ``semantics`` (the write-once register and vector specs, the
  sequential-consistency tester) on tests/test_semantics.py's histories;
* the generic actor symmetry (``symmetry.rewrite_value``,
  ``actor_state_representative``, ``ActorModelState.representative``)
  over the whole of the claim protocol's space (tests/test_symmetry_
  rewrite.py), and ``check-sym`` (2pc rm=5: 665);
* the ``timers``, ``interaction`` and ``panic`` lanes, and the pinger
  compiled (``models.timers.pinger_compiled``) on the sort-merge and hash
  engines on the CPU, equal to the JAX host BFS and JAX's compiled run;
  an under-declared closure bound raises where JAX undercounts;
* the CLI's lanes and subcommands against JAX's ``_MODELS``.
"""

import contextlib
import importlib
import io
import re
from collections import deque

import pytest

import stateright_tpu_torch as port
from stateright_tpu_torch import cli as pcli


def _mod(pkg: str, name: str):
    root = "stateright_tpu" if pkg == "jax" else "stateright_tpu_torch"
    return importlib.import_module(f"{root}.{name}" if name else root)


def _stdout(fn, *args) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


def _no_sec(report: str) -> str:
    """A report without ``sec=`` and the timed progress lines."""
    report = re.sub(r"Checking\. states=.*\n", "", report)
    return re.sub(r", sec=[0-9.]+", "", report)


# -- utils -----------------------------------------------------------------


def test_top_level_exports_match_jax():
    jax_pkg = _mod("jax", "")
    assert set(jax_pkg.__all__) <= set(port.__all__)
    for name in jax_pkg.__all__:
        assert getattr(port, name).__name__ == getattr(jax_pkg,
                                                       name).__name__


def test_dense_nat_map_matches_jax():
    results = {}
    for pkg in ("jax", "torch"):
        DenseNatMap = _mod(pkg, "utils").DenseNatMap
        m = DenseNatMap([10, 20])
        m2 = m.set(2, 30)
        m3 = m2.set(0, 99)
        with pytest.raises(IndexError, match="gap insert at key 5"):
            m.set(5, 1)
        # neither package can stably hash it: states hold it as a tuple
        with pytest.raises(TypeError, match="cannot stably hash"):
            _mod(pkg, "fingerprint").stable_hash(m)
        results[pkg] = (list(m2.items()), m3.values(), m3.get(7, -1),
                        len(m2), repr(m3), m3 == DenseNatMap([99, 20, 30]),
                        hash(m3) == hash(DenseNatMap([99, 20, 30])))
    assert results["torch"] == results["jax"]


def test_vector_clock_matches_jax():
    results = {}
    for pkg in ("jax", "torch"):
        VectorClock = _mod(pkg, "utils").VectorClock
        stable_hash = _mod(pkg, "fingerprint").stable_hash
        a = VectorClock().incremented(0)
        b = a.incremented(1)
        c = VectorClock().incremented(1)
        clocks = [a, b, c, a.merge_max(c), VectorClock([1, 0, 0]),
                  VectorClock([3, 0, 2]).incremented(5)]
        results[pkg] = (
            [repr(x) for x in clocks],
            [stable_hash(x) for x in clocks],
            [[x.partial_cmp(y) for y in clocks] for x in clocks],
            [[(x < y, x <= y, x == y) for y in clocks] for x in clocks],
            VectorClock([1]).get(5),
        )
    assert results["torch"] == results["jax"]


# -- semantics -------------------------------------------------------------


def _histories(pkg: str) -> dict:
    """tests/test_semantics.py's testers and specs, built in ``pkg``."""
    s = _mod(pkg, "semantics")
    Reg, W, WOk, R, ROk = (s.Register, s.WriteOp, s.WriteOk, s.ReadOp,
                           s.ReadOk)
    lin, seq = s.LinearizabilityTester, s.SequentialConsistencyTester
    testers = {}
    for name, tester in (("lin", lin), ("seq", seq)):
        t = tester(Reg(0))
        testers[f"{name} sequential"] = t.on_invoke(1, W(5)).on_return(
            1, WOk()).on_invoke(2, R()).on_return(2, ROk(5))
        testers[f"{name} stale read"] = t.on_invoke(1, W(5)).on_return(
            1, WOk()).on_invoke(2, R()).on_return(2, ROk(0))
        testers[f"{name} concurrent sees"] = t.on_invoke(1, W(5)).on_invoke(
            2, R()).on_return(2, ROk(5))
        testers[f"{name} concurrent misses"] = t.on_invoke(
            1, W(5)).on_invoke(2, R()).on_return(2, ROk(0))
        testers[f"{name} double invoke"] = t.on_invoke(1, W(1)).on_invoke(
            1, W(2))
        testers[f"{name} return first"] = t.on_return(9, WOk())
        testers[f"{name} program order"] = t.on_invoke(1, W(1)).on_return(
            1, WOk()).on_invoke(1, W(2)).on_return(1, WOk()).on_invoke(
            1, R()).on_return(1, ROk(1))
        testers[f"{name} write-once"] = tester(s.WORegister()).on_invoke(
            1, W("a")).on_invoke(2, W("b")).on_return(
            2, s.WriteFail()).on_return(1, WOk()).on_invoke(
            2, R()).on_return(2, ROk("a"))
        testers[f"{name} vec"] = tester(s.Vec()).on_invoke(
            1, s.Push(1)).on_invoke(2, s.Pop()).on_return(
            2, s.PopOk(1)).on_return(1, s.PushOk()).on_invoke(
            1, s.Len()).on_return(1, s.LenOk(0))
    specs = {
        "register": Reg(0).is_valid_history(
            [(W(1), WOk()), (R(), ROk(2))]),
        "wo": [s.WORegister().invoke(W("a")),
               s.WORegister("a", True).invoke(W("b")),
               s.WORegister("a", True).invoke(R())],
        "vec": s.Vec().is_valid_history(
            [(s.Push(1), s.PushOk()), (s.Push(2), s.PushOk()),
             (s.Len(), s.LenOk(2)), (s.Pop(), s.PopOk(2)),
             (s.Pop(), s.PopOk(1)), (s.Pop(), s.PopOk(None))]),
        "vec bad": s.Vec().is_valid_history([(s.Pop(), s.PopOk(7))]),
    }
    return testers, specs


def test_semantics_testers_match_jax():
    jt, js = _histories("jax")
    pt, ps = _histories("torch")
    assert set(pt) == set(jt) and len(pt) == 18
    jh = _mod("jax", "fingerprint").stable_hash
    ph = port.stable_hash
    for name in jt:
        assert pt[name].is_consistent() == jt[name].is_consistent(), name
        assert len(pt[name]) == len(jt[name]), name
        assert ph(pt[name]) == jh(jt[name]), name
        assert repr(pt[name].serialized_history()) == repr(
            jt[name].serialized_history()), name
    # the verdicts test_semantics.py pins
    assert [pt[n].is_consistent() for n in (
        "lin stale read", "seq stale read", "lin double invoke",
        "lin program order", "lin write-once", "seq vec")] == [
        False, True, False, False, True, True]
    assert repr(ps) == repr(js)
    assert ps["vec"] and not ps["vec bad"] and not ps["register"]


def test_single_copy_register_93_states_matches_jax():
    counts = []
    for pkg in ("jax", "torch"):
        scr = _mod(pkg, "models.single_copy_register")
        c = scr.single_copy_register_model(scr.SingleCopyRegisterCfg(
            client_count=2, server_count=1)).checker().spawn_dfs().join()
        c.assert_properties()
        counts.append((c.unique_state_count(), c.state_count(),
                       c.max_depth()))
    assert counts[0] == counts[1] and counts[1][0] == 93


# -- actor symmetry --------------------------------------------------------


def _claim_model(pkg: str, n: int):
    """tests/test_symmetry_rewrite.py's claim protocol in ``pkg``: each
    actor broadcasts ('claim', own id) and keeps the ids it saw, so ids
    sit in payloads and in actor states."""
    actor = _mod(pkg, "actor")
    Expectation = _mod(pkg, "model").Expectation
    Id = actor.Id

    class Claimer(actor.Actor):
        def on_start(self, id, out):
            for peer in range(n):
                if peer != int(id):
                    out.send(Id(peer), ("claim", id))
            return frozenset()

        def on_msg(self, id, state, src, msg, out):
            if isinstance(msg, tuple) and msg[0] == "claim":
                if msg[1] not in state.value:
                    state.set(state.value | {msg[1]})

    model = actor.ActorModel()
    for _ in range(n):
        model.actor(Claimer())
    model.init_network(actor.Network.new_unordered_nonduplicating())
    model.property(Expectation.SOMETIMES, "someone saw everyone",
                   lambda m, s: any(len(a) == n - 1 for a in s.actor_states))
    model.property(Expectation.ALWAYS, "never sees self",
                   lambda m, s: all(Id(i) not in a
                                    for i, a in enumerate(s.actor_states)))
    return model


def _space(model) -> list:
    """Every reachable state of ``model``, breadth first."""
    init = list(model.init_states())
    seen, queue, states = set(init), deque(init), list(init)
    while queue:
        state = queue.popleft()
        for action in model.actions(state):
            nxt = model.next_state(state, action)
            if nxt is not None and nxt not in seen:
                seen.add(nxt)
                queue.append(nxt)
                states.append(nxt)
    return states


def test_claim_representatives_hash_equal_to_jax():
    reps = {}
    for pkg in ("jax", "torch"):
        rep = _mod(pkg, "symmetry").actor_state_representative
        stable_hash = _mod(pkg, "fingerprint").stable_hash
        states = _space(_claim_model(pkg, 3))
        reps[pkg] = {stable_hash(s): stable_hash(rep(s)) for s in states}
        # the method the checkers call is the same function
        assert all(s.representative() == rep(s) for s in states[:50])
    assert len(reps["torch"]) == 64
    assert reps["torch"] == reps["jax"]
    assert len(set(reps["torch"].values())) < len(reps["torch"])


def test_claim_symmetry_dfs_matches_jax():
    runs = {}
    for pkg in ("jax", "torch"):
        rep = _mod(pkg, "symmetry").actor_state_representative
        host = _claim_model(pkg, 3).checker().spawn_dfs().join()
        sym = _claim_model(pkg, 3).checker().symmetry_fn(
            rep).spawn_dfs().join()
        sym.assert_properties()
        assert sorted(sym.discoveries()) == sorted(host.discoveries())
        assert sym.unique_state_count() < host.unique_state_count()
        runs[pkg] = (sym.unique_state_count(), sym.state_count(),
                     {n: p.encode() for n, p in sym.discoveries().items()})
    assert runs["torch"] == runs["jax"]


def test_rewrite_value_matches_jax_and_refuses_unknown_types():
    for pkg in ("jax", "torch"):
        sym = _mod(pkg, "symmetry")
        Id = _mod(pkg, "actor").Id
        HashableMap = _mod(pkg, "utils").HashableMap
        plan = sym.RewritePlan([2, 0, 1])
        assert sym.rewrite_value(("claim", Id(2)), plan) == ("claim", Id(0))
        assert sym.rewrite_value(HashableMap({Id(1): (Id(0),)}), plan) == \
            HashableMap({Id(2): (Id(1),)})
        assert sym.rewrite_value(("data", 7, "s"), plan) == ("data", 7, "s")
        assert sym.sorted_representative_key([3, 1, 2]) == (1, 2, 3)

        class Opaque:
            pass

        class Hooked:
            def _rewrite_ids_(self, plan):
                return "hooked"

        with pytest.raises(TypeError, match="cannot rewrite actor ids "
                           "inside 'Opaque'"):
            sym.rewrite_value((Id(0), Opaque()), plan)
        assert sym.rewrite_value([Hooked()], plan) == ["hooked"]
        assert isinstance(list(_claim_model(pkg, 2).init_states())[0],
                          sym.Representative)


@pytest.mark.parametrize("lane,count", [
    ("2pc", "5"), ("increment", "2"), ("increment-lock", "3"),
    ("register", "3"),
])
def test_check_sym_report_equals_jax(lane, count):
    """The port's ``check-sym`` prints the JAX lane's report (header,
    counts, every discovery's path and states) but for ``sec=``; both run
    in this process, so message sets print in one order."""
    jcli = _mod("jax", "cli")
    want = _no_sec(_stdout(jcli.main, [lane, "check-sym", count]))
    got = _no_sec(_stdout(pcli.main, [lane, "check-sym", count]))
    assert got == want
    assert "using symmetry reduction." in got
    if lane == "2pc":
        assert "Done. states=4091, unique=665, depth=17" in got
    if lane == "increment":
        assert "fin" in got


# -- timers, interaction, panic -------------------------------------------


def test_pinger_and_interaction_host_bfs_match_jax():
    runs = {}
    for pkg in ("jax", "torch"):
        timers = _mod(pkg, "models.timers")
        interaction = _mod(pkg, "models.interaction")
        pinger = timers.pinger_model(timers.PingerModelCfg(server_count=3))
        a = pinger.checker().target_max_depth(5).spawn_bfs().join()
        a.assert_properties()
        b = interaction.interaction_model().checker().target_max_depth(
            12).spawn_bfs().join()
        b.assert_properties()
        [init] = timers.pinger_model(timers.PingerModelCfg(2)).init_states()
        model = timers.pinger_model(timers.PingerModelCfg(2))
        Timeout, Id = _mod(pkg, "actor.model").Timeout, _mod(pkg, "actor").Id
        noop = model.next_state(init, Timeout(Id(0), "NoOp"))
        odd = model.next_state(init, Timeout(Id(0), "Odd"))
        runs[pkg] = (a.unique_state_count(), a.state_count(), a.max_depth(),
                     b.unique_state_count(), b.state_count(), b.max_depth(),
                     noop is None, odd is not None)
    assert runs["torch"] == runs["jax"]
    assert runs["torch"][0] == 304 and runs["torch"][3] == 368


def test_timers_and_interaction_lanes_equal_jax():
    """``interaction check 12`` (the BFS, properties asserted) and
    ``timers check`` headers, as the JAX lanes print them."""
    jcli = _mod("jax", "cli")
    want = _no_sec(_stdout(jcli.main, ["interaction", "check", "12"]))
    got = _no_sec(_stdout(pcli.main, ["interaction", "check", "12"]))
    assert got == want == "Done. states=787, unique=368, depth=12\n"


def test_panic_lane_propagates(monkeypatch):
    out = _stdout(pcli.main, ["panic", "check"])
    assert "Checker propagated the panic: panic! (the examples/panic.rs " \
        "trigger: action enumeration raised at state 5000)" in out
    # a checker that swallows the error makes the lane exit non-zero
    from stateright_tpu_torch.checker import CheckerBuilder

    class Quiet:
        def join(self):
            return self

    monkeypatch.setattr(CheckerBuilder, "spawn_dfs", lambda self: Quiet())
    with pytest.raises(SystemExit, match="the panic did not propagate"):
        _stdout(pcli.main, ["panic", "check"])


@pytest.fixture(scope="module")
def jax_pinger_depth3():
    """JAX's compiled pinger at depth 3 on its sort-merge engine, with the
    closure bound of tests/test_timers_interaction.py, and with a bound
    of 2 at depth 5, which JAX undercounts."""
    timers = _mod("jax", "models.timers")
    compile_actor_model = _mod("jax", "actor.compile").compile_actor_model
    runs = {}
    for bound, depth in ((4, 3), (2, 5)):
        model = timers.pinger_model(timers.PingerModelCfg(server_count=3))
        enc = compile_actor_model(
            model, properties={"true": lambda ctx, jnp: jnp.bool_(True)},
            closure_actor_bound=lambda i, s, b=bound: s.sent + s.received
            <= b)
        c = model.checker().target_max_depth(depth).spawn_tpu_sortmerge(
            encoded=enc, capacity=1 << 12, frontier_capacity=1 << 10,
            cand_capacity=1 << 12).join()
        runs[(bound, depth)] = (c.unique_state_count(), c.state_count(),
                                c.max_depth())
    return runs


def _port_compiled(depth: int, engine: str, enc_depth=None, **kw):
    timers = _mod("torch", "models.timers")
    model, enc = timers.pinger_compiled(timers.PingerModelCfg(3),
                                        enc_depth or depth)
    c = getattr(model.checker().target_max_depth(depth), engine)(
        encoded=enc, capacity=1 << 12, device="cpu", **kw).join()
    return c.unique_state_count(), c.state_count(), c.max_depth()


@pytest.mark.parametrize("engine", ["spawn_sortmerge", "spawn_hash"])
def test_compiled_pinger_equals_jax(engine, jax_pinger_depth3):
    """The compiled pinger at depths 3 and 4 on the CPU equals the JAX
    host BFS, and at depth 3 JAX's compiled run."""
    timers = _mod("jax", "models.timers")
    for depth in (3, 4):
        host = timers.pinger_model(timers.PingerModelCfg(3)).checker(
        ).target_max_depth(depth).spawn_bfs().join()
        want = (host.unique_state_count(), host.state_count(),
                host.max_depth())
        assert _port_compiled(depth, engine) == want
    assert _port_compiled(3, engine) == jax_pinger_depth3[(4, 3)] == \
        (27, 37, 3)


@pytest.mark.parametrize("engine,kw", [
    ("spawn_sortmerge", {}), ("spawn_sortmerge", {"sparse": False}),
    ("spawn_hash", {}),
], ids=["spawn_sortmerge", "spawn_sortmerge-dense", "spawn_hash"])
def test_under_declared_closure_bound_raises(engine, kw, jax_pinger_depth3):
    """The encoding compiled for depth 4 (bound 4) covers exactly a run to
    depth 4, which expands levels 1-3. Run to depth 5, it expands
    pinger states the closure kept unexpanded (sums reach 6 at level
    4): the port raises the truncation error, on the sparse wave, the
    dense wave and the hash engine. JAX leaves their transitions out
    silently (bound 2 at depth 5: 284 of the host BFS's 304)."""
    assert jax_pinger_depth3[(2, 5)] == (284, 662, 5)
    assert _port_compiled(4, engine, enc_depth=4, **kw) == (97, 180, 4)
    with pytest.raises(RuntimeError, match="encoding-bound overflow"):
        _port_compiled(5, engine, enc_depth=4, **kw)


# -- the CLI's lanes -------------------------------------------------------


def test_lanes_and_subcommands_cover_jax():
    jcli = _mod("jax", "cli")
    want = {lane: tuple("check-gpu" if s == "check-tpu" else s
                        for s in subs)
            for lane, (_, subs) in jcli._MODELS.items()}
    assert pcli.SUBCOMMANDS == want
    assert set(pcli._MODELS) == set(want)
    usage = _stdout(pcli._usage)
    for lane, subs in want.items():
        assert lane in usage
        for sub in subs:
            assert f" {sub}" in usage, (lane, sub)


_ARGS = {"interaction": {"check": ["3"], "explore": ["127.0.0.1:0"]},
         "timers": {"check": ["2"]}}


@pytest.mark.parametrize("lane,sub", [
    (lane, sub) for lane, subs in pcli.SUBCOMMANDS.items() for sub in subs
])
def test_every_subcommand_dispatches(lane, sub, monkeypatch):
    """Each lane handles each of its subcommands (never the usage): the
    checkers are spawned but not run, the Explorer and the UDP clusters
    are stubbed."""
    from stateright_tpu_torch.actor import spawn
    from stateright_tpu_torch.checker import CheckerBuilder

    seen = []

    def refuse():
        raise AssertionError(f"{lane} {sub} printed the usage")

    monkeypatch.setattr(pcli, "_usage", refuse)
    monkeypatch.setattr(pcli, "_report", lambda c: seen.append("report"))
    monkeypatch.setattr(CheckerBuilder, "serve",
                        lambda self, addr: seen.append("serve"))
    for name in ("spawn_paxos_cluster", "spawn_single_copy_cluster",
                 "spawn_abd_cluster"):
        monkeypatch.setattr(spawn, name, lambda: seen.append("spawn"))
    args = _ARGS.get(lane, {}).get(sub, ["1"])
    if sub == "check-gpu":
        args = args + ["--device", "cpu"]
    out = _stdout(pcli.main, [lane, sub] + args)
    if lane == "panic":
        assert "propagated the panic" in out
    else:
        want = {"explore": "serve", "spawn": "spawn"}.get(sub, "report")
        assert seen == [want], (seen, out)


@pytest.mark.parametrize("lane", ["paxos", "single-copy-register",
                                  "linearizable-register"])
def test_spawn_is_not_a_session_lane(lane):
    """A resident service refuses ``spawn`` as it refuses ``explore``:
    the UDP servers would run forever on the session's thread (the JAX
    service would start them)."""
    from stateright_tpu_torch.serve import CheckService

    with pytest.raises(ValueError, match="spawn is not a session lane"):
        CheckService(device="cpu").check([lane, "spawn"])
