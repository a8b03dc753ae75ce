"""The PyTorch port's actor→encoding compiler held against the JAX
package, exactly (every comparison is integer equality: tolerance 0).

* ``ops/bitmask.py``'s compiler helpers against the JAX functions;
* the host tables of both packages' compilations of the same models —
  the lane layout, the component domains, the effect and history
  tables, the sparse params/flat/crash tables, every array of the
  codegen plan and ``codegen_opt`` — and ``encode`` / ``decode`` /
  ``init_vecs`` on reached states;
* ``enabled_bits_cols`` / ``step_slot_cols`` (successor, ``trunc`` and
  ``hard``) / ``property_conditions_cols`` / ``within_boundary_cols``
  against JAX ``jax.vmap`` of the ``*_vec`` functions, on batches of
  many states (every state of a space, or a host-BFS prefix) and every
  enabled (state, slot) pair, including pairs that trip the queue and
  count bounds and a count that wraps past bit 31;
* the engine and the CLI report against the JAX engine and lane, a
  run continued from a JAX mid-run carry, the loud truncation of a
  model that overflows an encoding bound, the part left out
  (``NotImplementedError``) and the validation of the symmetry spec and
  ample mask a compilation may declare.
"""

import contextlib
import io
import re
import warnings
from collections import deque

import numpy as np
import pytest
import torch

#: compiled configurations held against JAX: name -> description
CONFIGS = (
    "pp-lossy-1", "pp-lossy-5", "pp-nondup-5", "pp-crash", "abd-2c2s",
    "abd-2c2s-ordered", "2pc-sys-3", "2pc-actor-2", "paxos-1c2s",
    "paxos-1c3s", "abd-2c3s-ordered",
)


def _build(pkg: str, name: str):
    """``(model, encoding)`` of configuration ``name`` in package
    ``pkg`` ("jax" or "torch"), built the same way in both."""
    import importlib

    root = "stateright_tpu" if pkg == "jax" else "stateright_tpu_torch"

    def mod(path):
        return importlib.import_module(f"{root}.{path}")

    compile_actor_model = mod("actor.compile").compile_actor_model
    Network = mod("actor").Network
    with warnings.catch_warnings():
        # the declared ABD queue bounds are capped to one lane (a
        # RuntimeWarning in both packages, expected)
        warnings.simplefilter("ignore", RuntimeWarning)
        if name.startswith("pp-"):
            pp = mod("models.ping_pong")
            max_nat = {"pp-lossy-1": 1, "pp-crash": 2,
                       "pp-lossy-nondup-2": 2}.get(name, 5)
            cfg = pp.PingPongCfg(maintains_history=True, max_nat=max_nat)
            model = pp.ping_pong_model(cfg)
            if name.startswith("pp-lossy"):
                model.set_lossy_network(True)
            if not name.startswith("pp-lossy") or "nondup" in name:
                model.init_network(Network.new_unordered_nonduplicating())
            if name == "pp-crash":
                model.set_max_crashes(1)
            return model, compile_actor_model(
                model, **pp.ping_pong_device_specs(cfg))
        if name.startswith("abd-"):
            lr = mod("models.linearizable_register")
            servers = 3 if "2c3s" in name else 2
            network = (Network.new_ordered() if name.endswith("ordered")
                       else None)
            model = lr.abd_model(lr.AbdModelCfg(2, servers), network)
            return model, model.to_encoded()
        if name == "2pc-sys-3":
            t = mod("models.two_phase_commit_actors")
            return (t.two_phase_sys_actor_model(3),
                    t.two_phase_sys_compiled_encoded(3))
        if name == "2pc-actor-2":
            t = mod("models.two_phase_commit_actors")
            model = t.two_phase_actor_model(2)
            return model, compile_actor_model(
                model, **t.two_phase_actor_device_specs(2))
        if name.startswith("paxos-"):
            px = mod("models.paxos")
            cfg = px.PaxosModelCfg(client_count=1,
                                   server_count=int(name[-2]), put_count=1)
            return px.paxos_model(cfg), px.paxos_compiled_encoded(cfg)
    raise KeyError(name)


@pytest.fixture(scope="module")
def encs():
    """Both packages' compilations, built once per configuration."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = (_build("jax", name), _build("torch", name))
        return cache[name]

    return get


def _bfs(model, max_depth=None, max_states=None):
    """Host states in BFS order, to ``max_depth`` (None: all), at most
    ``max_states``; successors outside the boundary are not kept."""
    [init] = model.init_states()
    seen = {init: 0}
    order = [init]
    q = deque([init])
    while q and (max_states is None or len(order) < max_states):
        s = q.popleft()
        d = seen[s]
        if max_depth is not None and d >= max_depth:
            continue
        for n in model.next_states(s):
            if n not in seen and model.within_boundary(n):
                seen[n] = d + 1
                order.append(n)
                q.append(n)
    return order if max_states is None else order[:max_states]


def _t(vecs):
    """``[N, W]`` uint32 rows -> the port's ``[W, N]`` int64 block."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(vecs, np.uint32).astype(np.int64).T))


def _mask_sec(text):
    return re.sub(r"sec=[0-9.]+", "sec=X", text)


# -- 1. bitmask helpers ----------------------------------------------------


def test_bitmask_helpers_match_jax():
    import jax.numpy as jnp

    from stateright_tpu.ops import bitmask as jb
    from stateright_tpu_torch.ops import bitmask as pb

    rng = np.random.default_rng(20261017)
    for n in (0, 1, 31, 32, 33, 95):
        flags = rng.random(n) < 0.5
        assert pb.pack_bits_host(flags) == jb.pack_bits_host(flags)
    # runs: consecutive slots on consecutive shifts coalesce, and a run
    # never crosses an output word
    sources = [(a, 0, a) for a in range(20)] + [(a, 1, a - 20)
                                                for a in range(20, 40)]
    sources += [(41, 2, 5), (42, 2, 6), (44, 2, 7), (63, 3, 0), (64, 3, 1)]
    runs = pb.bit_run_plan(70, sources)
    assert runs == jb.bit_run_plan(70, sources)
    vecs = rng.integers(0, 1 << 32, size=(4, 300), dtype=np.uint64)
    vecs = vecs.astype(np.uint32)
    got = pb.or_bit_runs(_t(vecs.T), runs, 3)
    want = jb.or_bit_runs(jnp, jnp.asarray(vecs), runs, 3)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert np.array_equal(g.numpy(), np.asarray(w))
    words = tuple(int(x) for x in rng.integers(0, 1 << 32, 3))
    idx = np.arange(0, 130, dtype=np.uint32)  # past the table too
    got = pb.bit_select(pb.const_words(words, "cpu"),
                        torch.from_numpy(idx.astype(np.int64)))
    want = jb.bit_select(jnp, words, jnp.asarray(idx))
    assert np.array_equal(got.numpy(), np.asarray(want))


# -- 2. host tables --------------------------------------------------------


def _fields(enc):
    def f(x):
        return (x.lane, x.shift, x.bits)

    return dict(
        actor=[f(x) for x in enc.f_actor],
        history=f(enc.f_history),
        crashed=[f(x) for x in enc.f_crashed],
        timer=[[f(x) for x in t] for t in enc.f_timer],
        net=[f(x) for x in enc.f_net],
        ch=[f(x) for x in getattr(enc, "f_ch", [])],
    )


def _plan_equal(jp, pp):
    assert set(jp) == set(pp)
    for key, jv in jp.items():
        pv = pp[key]
        if isinstance(jv, np.ndarray) or isinstance(pv, np.ndarray):
            assert (jv is None) == (pv is None), key
            assert jv.dtype == pv.dtype and np.array_equal(jv, pv), key
        elif isinstance(jv, dict):
            _plan_equal(jv, pv)
        else:
            assert jv == pv, key


@pytest.mark.parametrize("name", CONFIGS)
def test_host_tables_match_jax(encs, name):
    (jm, j), (pm, p) = encs(name)
    for attr in ("width", "max_actions", "n", "dup", "lossy", "ordered",
                 "max_crashes", "_smax", "n_cls", "deliver_slots",
                 "drop_slots", "timeout_slots", "crash_slots",
                 "trivial_boundary", "codegen_opt",
                 "_mask_slots"):
        assert getattr(p, attr) == getattr(j, attr), attr
    assert _fields(p) == _fields(j)
    for attr in ("S", "T"):
        assert repr(getattr(p, attr)) == repr(getattr(j, attr)), attr
    assert repr(p.E) == repr(j.E) and repr(p.H) == repr(j.H)
    if j.ordered:
        assert repr(p.channels) == repr(j.channels)
        assert [p.ch_q[c] for c in p.channels] == \
            [j.ch_q[c] for c in j.channels]
        assert [p.ch_base[c] for c in p.channels] == \
            [j.ch_base[c] for c in j.channels]
    for attr in ("tbl_history_packed", "_sp_params", "_sp_flat",
                 "_sp_hist_flat", "_sp_crash_and", "_net_top_mask"):
        a, b = getattr(p, attr), getattr(j, attr)
        assert a.dtype == b.dtype and np.array_equal(a, b), attr
    _plan_equal(j._opt, p._opt)

    assert np.array_equal(p.init_vecs(), j.init_vecs())
    j_states = _bfs(jm, max_states=300)
    p_states = _bfs(pm, max_states=300)
    assert len(p_states) == len(j_states) > 1
    for js, ps in zip(j_states, p_states):
        vec = p.encode(ps)
        assert np.array_equal(vec, j.encode(js))
        assert p.decode(vec) == ps


# -- 3. device functions ---------------------------------------------------


def _port_engine_states(p, **kw):
    """Every state the port engine visits, from the frontiers its wave
    loop hands ``enabled_bits_cols``, as ``[N, W]`` uint32 rows."""
    frontiers = []
    real = p.enabled_bits_cols

    def recording(states_t):
        frontiers.append(states_t.T.numpy().astype(np.uint32))
        return real(states_t)

    p.enabled_bits_cols = recording
    try:
        c = p.host_model.checker().spawn_sortmerge(
            encoded=p, capacity=1 << 16, track_paths=False, device="cpu",
            **kw).join()
    finally:
        del p.enabled_bits_cols
    vecs = np.concatenate(frontiers)
    assert len(vecs) == c.unique_state_count()
    return vecs


def _jax_device_fns(j, vecs, pair_vecs, slots):
    """JAX ``vmap`` of the ``*_vec`` functions in one program:
    ``(bits, (succ, trunc, hard), conds, in_boundary)`` as numpy, the
    boundary taken on the successors."""
    import jax
    import jax.numpy as jnp

    def run(v, pv, sl):
        step = jax.vmap(j.step_slot_vec)(pv, sl)
        return (jax.vmap(j.enabled_bits_vec)(v), step,
                jax.vmap(j.property_conditions_vec)(v),
                jax.vmap(lambda x: jnp.asarray(j.within_boundary_vec(x),
                                               bool))(step[0]))

    out = jax.jit(run)(jnp.asarray(vecs), jnp.asarray(pair_vecs),
                       jnp.asarray(slots.astype(np.uint32)))
    bits, step, cond, inb = out
    return (np.asarray(bits), tuple(np.asarray(x) for x in step),
            np.asarray(cond), np.asarray(inb))


def _flag(x, n):
    return np.zeros(n, bool) if x is None else x.numpy()


def _compare_device_fns(j, p, vecs):
    """Port device functions == JAX ``vmap`` on every state of ``vecs``
    and every enabled (state, slot) pair; returns the port's flags."""
    from stateright_tpu_torch.ops.bitmask import words_to_mask

    n = len(vecs)
    block = _t(vecs)
    bits = p.enabled_bits_cols(block)
    assert bits.shape == (n, (p.max_actions + 31) // 32)
    assert bits.dtype == torch.int64
    rows, slots = words_to_mask(bits, p.max_actions).nonzero(as_tuple=True)
    assert rows.numel() > 0
    succ, trunc, hard = p.step_slot_cols(block[:, rows], slots)
    assert succ.shape == (p.width, rows.numel())
    assert int(succ.min()) >= 0 and int(succ.max()) < 1 << 32
    cond = p.property_conditions_cols(block)
    assert cond.shape == (n, len(p.host_model.properties()))
    inb = p.within_boundary_cols(succ)

    j_bits, (j_succ, j_trunc, j_hard), j_cond, j_inb = _jax_device_fns(
        j, vecs, vecs[rows.numpy()], slots.numpy())
    m = rows.numel()
    assert np.array_equal(bits.numpy(), j_bits)
    assert np.array_equal(succ.T.numpy(), j_succ)
    assert np.array_equal(_flag(trunc, m), j_trunc)
    assert np.array_equal(_flag(hard, m), j_hard)
    assert np.array_equal(cond.numpy(), j_cond)
    assert np.array_equal(inb.numpy(), j_inb)
    return _flag(trunc, m), _flag(hard, m)


def _ticker(pkg):
    """A two-actor timer loop with one allowed crash (timeout and crash
    slots), in package ``pkg``."""
    import importlib

    root = "stateright_tpu" if pkg == "jax" else "stateright_tpu_torch"
    actor = importlib.import_module(f"{root}.actor")
    Expectation = importlib.import_module(f"{root}.model").Expectation
    compile_actor_model = importlib.import_module(
        f"{root}.actor.compile").compile_actor_model

    class Ticker(actor.Actor):
        def on_start(self, id, out):
            out.set_timer("tick", (1.0, 2.0))
            return 0

        def on_msg(self, id, state, src, msg, out):
            pass

        def on_timeout(self, id, state, timer, out):
            if state.value < 3:
                state.set(state.value + 1)
                out.set_timer("tick", (1.0, 2.0))

    model = (
        actor.ActorModel(cfg=None).actor(Ticker()).actor(Ticker())
        .set_max_crashes(1)
        .property(Expectation.ALWAYS, "counts bounded",
                  lambda cfg, s: all(a <= 3 for a in s.actor_states))
    )
    if pkg == "jax":
        spec = lambda ctx, jnp: jnp.all(  # noqa: E731
            ctx.actor_values(lambda i, s: s) <= 3)
    else:
        spec = lambda ctx, xp: (  # noqa: E731
            ctx.actor_values(lambda i, s: s) <= 3).all(dim=0)
    return model, compile_actor_model(
        model, properties={"counts bounded": spec})


def _queue_bound_1(pkg):
    """ABD 2c/2s over FIFO channels with an under-declared queue bound
    of 1 (a server-to-server channel holds two messages at times)."""
    import importlib

    root = "stateright_tpu" if pkg == "jax" else "stateright_tpu_torch"
    lr = importlib.import_module(f"{root}.models.linearizable_register")
    Network = importlib.import_module(f"{root}.actor").Network
    model = lr.abd_model(lr.AbdModelCfg(2, 2), Network.new_ordered())
    return model, lr.abd_encoded(model, queue_bound=1)


def _beacon(pkg):
    """Timers over FIFO channels: actor 0's timer sends a ping down its
    channel, actor 1 counts them (ordered pushes from timeout rows,
    whose channel params are zero in the fused table path)."""
    import importlib

    root = "stateright_tpu" if pkg == "jax" else "stateright_tpu_torch"
    actor = importlib.import_module(f"{root}.actor")
    compile_actor_model = importlib.import_module(
        f"{root}.actor.compile").compile_actor_model

    class Beacon(actor.Actor):
        def on_start(self, id, out):
            if int(id) == 0:
                out.set_timer("tick", (1.0, 2.0))
            return 0

        def on_msg(self, id, state, src, msg, out):
            state.set(state.value + 1)

        def on_timeout(self, id, state, timer, out):
            if state.value < 3:
                out.send(actor.Id(1), ("ping", state.value))
                state.set(state.value + 1)
                out.set_timer("tick", (1.0, 2.0))

    model = (actor.ActorModel(cfg=None).actor(Beacon()).actor(Beacon())
             .init_network(actor.Network.new_ordered()))
    return model, compile_actor_model(model, closure="reachable")


def _history_cut(pkg):
    """Ping-pong whose history closure is cut below the boundary: the
    (history, effect) transitions past the cut are un-harvested, so
    their pairs set ``hard``."""
    import importlib

    root = "stateright_tpu" if pkg == "jax" else "stateright_tpu_torch"
    pp = importlib.import_module(f"{root}.models.ping_pong")
    compile_actor_model = importlib.import_module(
        f"{root}.actor.compile").compile_actor_model
    cfg = pp.PingPongCfg(maintains_history=True, max_nat=5)
    model = pp.ping_pong_model(cfg).set_lossy_network(True)
    specs = pp.ping_pong_device_specs(cfg)
    specs["closure_history_bound"] = lambda h: max(h) <= 3
    return model, compile_actor_model(model, **specs)


def _wrap(pkg):
    """One actor that re-sends each of three self-messages twice, over a
    non-duplicating network: the third count field sits at bits 24-31
    of its lane, so a sum past 255 carries out of the lane."""
    import importlib

    root = "stateright_tpu" if pkg == "jax" else "stateright_tpu_torch"
    actor = importlib.import_module(f"{root}.actor")
    compile_actor_model = importlib.import_module(
        f"{root}.actor.compile").compile_actor_model

    class Wrap(actor.Actor):
        def on_start(self, id, out):
            for m in ("a", "b", "c"):
                out.send(id, m)
            return 0

        def on_msg(self, id, state, src, msg, out):
            state.set((state.value + 1) % 64)  # 6 bits of actor state
            out.send(id, msg)
            out.send(id, msg)

    model = (actor.ActorModel(cfg=None).actor(Wrap())
             .init_network(actor.Network.new_unordered_nonduplicating()))
    return model, compile_actor_model(model, properties={})


def _wrap_states(p):
    """Synthetic states of ``_wrap``: every count field at values that
    reach the 128 bound and carry out of 8 bits."""
    [init] = p.init_vecs()
    counts = [0, 1, 2, 126, 127, 200, 254, 255]
    rows = []
    for s in (0, 5, 63):
        for c in counts:
            for k, f in enumerate(p.f_net):
                v = init.copy()
                for f2 in p.f_net:
                    v[f2.lane] &= np.uint32(~f2.mask & 0xFFFFFFFF)
                v[f.lane] |= np.uint32(c << f.shift)
                other = p.f_net[(k + 1) % len(p.f_net)]
                v[other.lane] |= np.uint32(1 << other.shift)
                fa = p.f_actor[0]
                v[fa.lane] = (v[fa.lane] & np.uint32(~fa.mask & 0xFFFFFFFF)
                              ) | np.uint32(s << fa.shift)
                rows.append(v)
    return np.unique(np.stack(rows), axis=0)


def test_device_functions_match_jax_abd_ordered(encs):
    """Every state of the ABD 2c/2s ordered space (620)."""
    (_, j), (_, p) = encs("abd-2c2s-ordered")
    vecs = _port_engine_states(p)
    assert len(vecs) == 620
    trunc, hard = _compare_device_fns(j, p, vecs)
    assert not trunc.any() and not hard.any()


@pytest.mark.parametrize("name,unique", [("pp-lossy-5", 4094),
                                         ("pp-crash", None)])
def test_device_functions_match_jax_ping_pong(encs, name, unique):
    """The ping-pong space with the boundary (4,094: drop slots, a
    boundary that prunes successors) and with one crash (crash slots,
    crash-gated delivers)."""
    (_, j), (_, p) = encs(name)
    vecs = _port_engine_states(p)
    if unique is not None:
        assert len(vecs) == unique
    _compare_device_fns(j, p, vecs)


@pytest.mark.parametrize("name", ["pp-lossy-nondup-2", "2pc-sys-3"])
def test_device_functions_match_jax_drop_and_dup(encs, name):
    """Drops over a non-duplicating network (the count decrement on the
    drop path), and timers over a duplicating one without drops (bit
    runs, guard-row selects): every state of each space."""
    (_, j), (_, p) = encs(name)
    _compare_device_fns(j, p, _port_engine_states(p))


def test_device_functions_match_jax_timers_and_crashes():
    (jm, j), (pm, p) = _ticker("jax"), _ticker("torch")
    vecs = _port_engine_states(p)
    assert len(vecs) == jm.checker().spawn_bfs().join().unique_state_count()
    _compare_device_fns(j, p, vecs)


def test_device_functions_match_jax_abd_2c3s_prefix(encs):
    """ABD 2c/3s ordered (W = 7, K = 110, queue fields capped to one
    lane) on its host-BFS prefix to depth 8."""
    (jm, j), (_, p) = encs("abd-2c3s-ordered")
    assert (p.width, p.max_actions) == (7, 110)
    vecs = np.unique(np.stack([j.encode(s) for s in _bfs(jm, 8)]), axis=0)
    assert len(vecs) == 596
    _compare_device_fns(j, p, vecs)


def test_device_functions_match_jax_queue_bound_flags():
    """A declared queue bound of 1: pairs that push onto a full queue
    set ``trunc`` in both packages, on the same pairs."""
    (jm, j), (_, p) = _queue_bound_1("jax"), _queue_bound_1("torch")
    vecs = []
    for s in _bfs(jm, 10):
        try:
            vecs.append(j.encode(s))
        except ValueError:  # a queue deeper than the declared bound
            continue
    trunc, _ = _compare_device_fns(j, p, np.unique(np.stack(vecs), axis=0))
    assert trunc.any()


def test_device_functions_match_jax_ordered_timers():
    (jm, j), (_, p) = _beacon("jax"), _beacon("torch")
    vecs = _port_engine_states(p)
    assert len(vecs) == jm.checker().spawn_bfs().join().unique_state_count()
    _compare_device_fns(j, p, vecs)


def test_device_functions_match_jax_history_cut():
    """Un-harvested history transitions set ``hard`` on the same pairs
    in both packages, and the engine raises on them."""
    (jm, j), (pm, p) = _history_cut("jax"), _history_cut("torch")
    vecs = []
    for s in _bfs(jm, 8):
        try:
            vecs.append(j.encode(s))
        except KeyError:  # a history outside the cut domain
            continue
    _, hard = _compare_device_fns(j, p, np.unique(np.stack(vecs), axis=0))
    assert hard.any()
    c = pm.checker().spawn_sortmerge(encoded=p, capacity=1 << 13,
                                     device="cpu")
    with pytest.raises(RuntimeError, match="encoding-bound overflow"):
        c.join()


def test_device_functions_match_jax_count_wrap():
    """Counts at and past the 128 bound, and a count field at the top of
    its lane whose sum carries past bit 31: the port's int64 lanes wrap
    as uint32 lanes do, and ``trunc`` marks the same pairs."""
    (_, j), (_, p) = _wrap("jax"), _wrap("torch")
    assert [(f.lane, f.shift) for f in p.f_net][-1] == (0, 24)
    vecs = _wrap_states(p)
    trunc, _ = _compare_device_fns(j, p, vecs)
    assert trunc.any() and not trunc.all()


def test_specs_reduce_per_state(encs):
    """A batched spec reduces over actors, never over the batch: each
    state's conditions are the same alone as in a batch."""
    (_, _), (_, p) = encs("2pc-sys-3")
    vecs = _port_engine_states(p)
    batch = p.property_conditions_cols(_t(vecs))
    one = torch.cat([p.property_conditions_cols(_t(v[None]))
                     for v in vecs[::17]])
    assert torch.equal(batch[::17], one)
    assert batch.any(dim=0).all() and not batch.all(dim=0).all()


def test_spec_tables_keyed_by_default_arguments(encs):
    """Spec callbacks built in a loop share one code object and differ
    only in a default argument: each gets its own table."""
    from stateright_tpu_torch.actor.compile import _SpecCtx

    (_, _), (_, p) = encs("2pc-sys-3")
    ctx = _SpecCtx(p, _t(_port_engine_states(p)))
    n = ctx._states.shape[1]
    by_default = [lambda i, s, k=k: (i + k) % 3 for k in range(3)]
    by_kwdefault = [lambda i, s, *, k=k: (i * k) % 4 for k in range(3)]
    for k, fn in enumerate(by_default):
        want = torch.tensor([(i + k) % 3 for i in range(p.n)])
        assert torch.equal(ctx.actor_values(fn), want[:, None].expand(-1, n))
    for k, fn in enumerate(by_kwdefault):
        want = torch.tensor([(i * k) % 4 for i in range(p.n)])
        assert torch.equal(ctx.actor_values(fn), want[:, None].expand(-1, n))
    for k, fn in enumerate([lambda h, k=k: k for k in range(3)]):
        assert torch.equal(ctx.history_value(fn), torch.full((n,), k))


# -- 4. engine -------------------------------------------------------------


#: JAX engine sizes of the engine comparisons (the CLI lane's where one
#: exists); waves_per_sync=4 leaves programs the carry test reuses
ENGINE_CONFIGS = ("abd-2c2s-ordered", "pp-lossy-5", "paxos-1c3s")


def _jax_run(j, jm):
    return jm.checker().spawn_tpu_sortmerge(
        encoded=j, capacity=1 << 13, frontier_capacity=1 << 11,
        cand_capacity=1 << 14, waves_per_sync=4).join()


def _port_run(p, pm, **kw):
    kw.setdefault("device", "cpu")
    return pm.checker().spawn_sortmerge(
        encoded=p, capacity=1 << 13, frontier_capacity=1 << 11, **kw)


@pytest.fixture(scope="module")
def jax_runs(encs):
    return {name: _jax_run(encs(name)[0][1], encs(name)[0][0])
            for name in ENGINE_CONFIGS}


def _replays(model, path, prop) -> bool:
    from stateright_tpu_torch.model import Expectation
    from stateright_tpu_torch.path import Path

    replayed = Path.from_fingerprints(model, path.fingerprints())
    if replayed.fingerprints() != path.fingerprints():
        return False
    last = replayed.last_state()
    if prop.expectation == Expectation.SOMETIMES:
        return prop.condition(model, last)
    if prop.expectation == Expectation.ALWAYS:
        return not prop.condition(model, last)
    return all(not prop.condition(model, s) for s, _ in replayed.steps)


@pytest.mark.parametrize("name,unique", [("abd-2c2s-ordered", 620),
                                         ("pp-lossy-5", 4094),
                                         ("paxos-1c3s", 265)])
def test_engine_matches_jax(encs, jax_runs, name, unique):
    (_, _), (pm, p) = encs(name)
    jr = jax_runs[name]
    pr = _port_run(p, pm).join()
    assert pr.unique_state_count() == jr.unique_state_count() == unique
    assert pr.state_count() == jr.state_count()
    assert pr.max_depth() == jr.max_depth()
    assert pr.discovered_property_names() == jr.discovered_property_names()
    assert pr.discovery_fingerprints() == jr.discovery_fingerprints()
    jd, pd = jr.discoveries(), pr.discoveries()
    assert set(pd) == set(jd) and pd
    for prop_name, path in pd.items():
        assert path.encode() == jd[prop_name].encode(), prop_name
        assert _replays(pm, path, pm.property_by_name(prop_name)), prop_name
    if name == "abd-2c2s-ordered":
        assert (pr.state_count(), pr.max_depth()) == (883, 25)


def test_abd_unordered_544_matches_host(encs):
    """ABD 2c/2s over the default unordered network: the reference's
    544 and the JAX host BFS's discovery set."""
    (jm, _), (pm, p) = encs("abd-2c2s")
    pr = _port_run(p, pm).join()
    assert pr.unique_state_count() == 544
    host = jm.checker().spawn_bfs().join()
    assert pr.discovered_property_names() == set(host.discoveries())
    path = pr.discovery("value chosen")
    assert _replays(pm, path, pm.property_by_name("value chosen"))


def test_continue_from_jax_carry(encs, jax_runs):
    """Seed the JAX engine on ABD 2c/2s ordered, run one chunk (4
    waves), carry its visited set and frontier across, and finish on
    the port: the same counts and discoveries as the JAX run to the
    end. The compiled tables are the port's own."""
    import jax.numpy as jnp

    from stateright_tpu_torch.convert import carry_from_numpy

    (jm, j), (pm, p) = encs("abd-2c2s-ordered")
    # the fixture run's configuration: its compiled programs serve here
    jc = jm.checker().spawn_tpu_sortmerge(
        encoded=j, capacity=1 << 13, frontier_capacity=1 << 11,
        cand_capacity=1 << 14, waves_per_sync=4)
    init = np.asarray(j.init_vecs(), np.uint32)
    seed_fn, chunk_fn = jc._lookup_programs(init.shape[0])
    carry, _ = chunk_fn(seed_fn(jnp.asarray(init)))
    c = {k: np.asarray(v) for k, v in carry.items()}
    assert not c["done"] and int(c["depth"]) == 5
    state = carry_from_numpy(
        c["vkeys"], c["frontier"], int(c["n_frontier"]), c["ebits"],
        depth=int(c["depth"]),
        generated=int(c["gen_lo"]) | (int(c["gen_hi"]) << 32),
    )
    pr = _port_run(p, pm, track_paths=False).start_from(state).join()
    full = jax_runs["abd-2c2s-ordered"]
    assert pr.unique_state_count() == full.unique_state_count() == 620
    assert pr.state_count() == full.state_count()
    assert pr.max_depth() == full.max_depth()
    assert pr.discovery_fingerprints() == full.discovery_fingerprints()


def test_cli_2pc_actors_report_matches_jax_lane(encs):
    """`2pc-actors check-gpu 3 --device cpu` prints the JAX lane's report
    (both in ONE process: frozenset reprs iterate alike); the header
    names the engine and differs by design."""
    from stateright_tpu.cli import main as jax_main
    from stateright_tpu_torch.cli import main as port_main

    out_j, out_p = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out_j):
        jax_main(["2pc-actors", "check-tpu", "3"])
    with contextlib.redirect_stdout(out_p):
        port_main(["2pc-actors", "check-gpu", "3", "--device", "cpu"])
    j_lines = _mask_sec(out_j.getvalue()).splitlines()
    p_lines = _mask_sec(out_p.getvalue()).splitlines()
    assert p_lines[0] == (
        "Checking two phase commit (compiled actor model) with 3 resource "
        "managers on the CPU wave engine."
    )
    assert p_lines[1] == "Done. states=810, unique=288, depth=11, sec=X"
    assert p_lines[1:] == j_lines[1:]
    assert len(p_lines) > 4
    # each discovery path replays through the port's host model
    (_, _), (pm, p) = encs("2pc-sys-3")
    pr = _port_run(p, pm).join()
    assert pr.discovered_property_names() == {"abort agreement",
                                              "commit agreement"}
    for name, path in pr.discoveries().items():
        assert _replays(pm, path, pm.property_by_name(name)), name


def test_cli_lanes_on_cpu():
    from stateright_tpu_torch.cli import main as port_main

    runs = {
        ("linearizable-register", "2", "ordered"):
            "Done. states=883, unique=620, depth=25",
        ("linearizable-register", "2"):
            "Done. states=875, unique=544, depth=25",
        ("paxos-compiled", "1"): "Done. states=482, unique=265, depth=14",
    }
    for args, done in runs.items():
        out = io.StringIO()
        with contextlib.redirect_stdout(out), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            port_main([args[0], "check-gpu", *args[1:], "--device", "cpu"])
        lines = out.getvalue().splitlines()
        assert lines[1].startswith(done), (args, lines[1])
        assert 'Discovered "value chosen" example' in lines[2]
    with pytest.raises(SystemExit, match="1-2 clients"):
        port_main(["paxos-compiled", "check-gpu", "3", "--device", "cpu"])


def test_compiled_lanes_refuse_without_cuda():
    from stateright_tpu_torch.cli import main as port_main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for args in (["2pc-actors", "check-gpu", "2"],
                 ["paxos-compiled", "check-gpu", "1"],
                 ["linearizable-register", "check-gpu", "2"]):
        with contextlib.redirect_stdout(io.StringIO()), \
                pytest.raises(RuntimeError, match="no CUDA device"):
            port_main(args)


# -- 5. loud truncation and what is left out --------------------------------


def test_count_bound_overflow_raises():
    """A model with finite component domains but unbounded envelope
    multiplicity fails loudly at the 128-count bound, naming what it
    discovered before."""
    from stateright_tpu_torch.actor import Actor, ActorModel, Network
    from stateright_tpu_torch.actor.compile import compile_actor_model
    from stateright_tpu_torch.model import Expectation

    class Flooder(Actor):
        def on_start(self, id, out):
            out.send(id, "go")
            return 0

        def on_msg(self, id, state, src, msg, out):
            # Consume one "go", emit two: multiplicity diverges while
            # the local state and envelope universe stay singletons.
            out.send(id, "go")
            out.send(id, "go")

    model = (
        ActorModel(cfg=None).actor(Flooder())
        .init_network(Network.new_unordered_nonduplicating())
        .property(Expectation.SOMETIMES, "go in flight",
                  lambda m, s: any(True for _ in
                                   s.network.iter_deliverable()))
        .property(Expectation.ALWAYS, "state stays 0",
                  lambda m, s: s.actor_states[0] == 0)
    )
    enc = compile_actor_model(model, properties={
        "go in flight": lambda ctx, xp: ctx.network_any(lambda e: True),
        "state stays 0": lambda ctx, xp: (
            ctx.actor_values(lambda i, s: s) == 0).all(dim=0),
    })
    c = model.checker().spawn_sortmerge(
        encoded=enc, capacity=1 << 9, frontier_capacity=1 << 5,
        device="cpu")
    with pytest.raises(RuntimeError, match="encoding-bound overflow") as e:
        c.join()
    assert "before truncation (valid counterexamples): ['go in flight']" \
        in str(e.value)


def test_underdeclared_queue_bound_raises():
    pm, p = _queue_bound_1("torch")
    c = pm.checker().spawn_sortmerge(encoded=p, capacity=1 << 13,
                                     device="cpu")
    with pytest.raises(RuntimeError, match="encoding-bound overflow"):
        c.join()


def test_left_out_parts_raise():
    from stateright_tpu_torch.actor.compile import compile_actor_model
    from stateright_tpu_torch.models.ping_pong import (
        PingPongCfg,
        ping_pong_device_specs,
        ping_pong_model,
    )

    cfg = PingPongCfg(max_nat=1)
    specs = ping_pong_device_specs(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        compile_actor_model(ping_pong_model(cfg), optimize=False, **specs)
    # the reductions' declarations are accepted and validated
    # as in the JAX compiler: a spec against the compiled width, a mask
    # against the slot count
    from stateright_tpu_torch.ops.canonical import (
        DeviceRewriteSpec,
        MemberField,
    )

    off_width = DeviceRewriteSpec(2, (MemberField(99, 0, 2, 2, True),))
    with pytest.raises(ValueError, match="outside encoding width"):
        compile_actor_model(ping_pong_model(cfg),
                            device_rewrite_spec=off_width, **specs)
    with pytest.raises(ValueError, match="ample_mask has 2 words"):
        compile_actor_model(ping_pong_model(cfg), ample_mask=(1, 1),
                            **specs)
    enc = compile_actor_model(ping_pong_model(cfg), ample_mask=(1,),
                              **specs)
    assert enc.ample_mask_host() == (1,)
    assert enc.device_rewrite_spec() is None


# -- 6. slow ---------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("rm,unique", [(5, 8832), (6, 50816)])
def test_2pc_sys_counts_slow(rm, unique):
    from stateright_tpu_torch.cli import twopc_sizes
    from stateright_tpu_torch.models.two_phase_commit_actors import (
        two_phase_sys_actor_model,
        two_phase_sys_compiled_encoded,
    )

    c = two_phase_sys_actor_model(rm).checker().spawn_sortmerge(
        encoded=two_phase_sys_compiled_encoded(rm), **twopc_sizes(rm),
        device="cpu").join()
    assert c.unique_state_count() == unique
    assert c.discovered_property_names() == {"abort agreement",
                                             "commit agreement"}


@pytest.mark.slow
def test_abd_2c3s_depth_prefix_matches_jax_engine(encs):
    """ABD 2c/3s ordered: the port engine's run to depth 10
    (``target_max_depth``) equals the JAX engine's (1,066 states), and
    its visited set is the JAX host BFS's set to that depth, encoded."""
    (jm, j), (_, p) = encs("abd-2c3s-ordered")
    jr = jm.checker().target_max_depth(10).spawn_tpu_sortmerge(
        encoded=j, capacity=1 << 13, frontier_capacity=1 << 11,
        cand_capacity=1 << 13, track_paths=False).join()
    assert jr.unique_state_count() == 1066
    pr = p.host_model.checker().target_max_depth(10).spawn_sortmerge(
        encoded=p, capacity=1 << 21, track_paths=False,
        device="cpu").join()
    assert pr.unique_state_count() == jr.unique_state_count()
    assert pr.state_count() == jr.state_count()
    assert pr.max_depth() == jr.max_depth() == 10
    # the visited keys are the keys of the host BFS's states, encoded
    from stateright_tpu_torch.ops.fingerprint import (
        clamp_keys,
        fingerprint_u32v_t,
        pack_keys,
    )

    host = np.stack([j.encode(s) for s in _bfs(jm, 9)])
    keys = clamp_keys(pack_keys(*fingerprint_u32v_t(_t(host))))
    assert torch.equal(pr._final.vkeys, torch.sort(keys).values)
