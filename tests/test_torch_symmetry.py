"""The PyTorch port's device symmetry reduction and ample-set filter,
held against the JAX package.

* the canonicalizer (ops/canonical.py) is bit-equal to JAX
  ``canonicalize_rows(spec, rows, np)`` on 10,000 seeded random rows
  and on every reachable encoded state of 2pc rm=3/5 and the register
  n=4, and ``decode`` of it is ``representative_full``;
* ``validate_spec`` refuses what the JAX one refuses, with its words;
* engine counts on the CPU, sparse and dense: 2pc ``--symmetry`` 80 /
  314 at rm=3/5, ample 260, both 76, register n=4 ``--symmetry`` 21
  (raw 217); ``slow``: 553 / 920 at rm=6/7;
* at 2pc rm=3 and the register n=4, counts, ``states=``, depth,
  discovery fingerprints and ``Path.encode()`` equal a JAX
  ``spawn_tpu_sortmerge`` CPU run (four JAX runs, shared through one
  module fixture; the ample runs with ``unsound_ok``, see below);
* the refusals speak the JAX wording: a missing capability, no ample
  mask, the dense wave with ``ample_set``, and a spec or mask the
  port's soundness analyzer (analysis/soundness.py) refuses, which
  names the failed obligation and runs with ``unsound_ok``;
* the port's gate certifies what the JAX analyzer certifies: the 2pc
  and register symmetry specs, whose fields equal the port's. The JAX
  analyzer does not certify 2pc's ample mask under JAX 0.9 (its walker
  names only ``pjit``), so the ample verdict is held to the committed
  ``SOUND_r01.json`` and to verdict parity with the JAX engine run
  with ``unsound_ok``. tests/test_torch_analysis.py holds the analyzer
  to JAX's rule by rule.
"""

import json
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SEED = 20261017

# the small single-class JAX spawn shapes of tests/test_torch_engine.py
JAX_SHAPES = dict(capacity=1 << 11, frontier_capacity=1 << 9,
                  cand_capacity=1 << 11, waves_per_sync=4,
                  merge_impl="xla")

#: run name -> (model kind, size, symmetry, ample_set)
RUNS = {
    "2pc-sym-3": ("2pc", 3, True, False),
    "2pc-sym-5": ("2pc", 5, True, False),
    "2pc-ample-3": ("2pc", 3, False, True),
    "2pc-both-3": ("2pc", 3, True, True),
    "register-sym-4": ("register", 4, True, False),
    "register-4": ("register", 4, False, False),
}


def _model(pkg: str, kind: str, n: int):
    import importlib

    root = "stateright_tpu" if pkg == "jax" else "stateright_tpu_torch"
    if kind == "2pc":
        return importlib.import_module(
            f"{root}.models.two_phase_commit").TwoPhaseSys(rm_count=n)
    return importlib.import_module(
        f"{root}.models.nclient_register").NClientRegSys(n_clients=n)


def _builder(pkg: str, name: str):
    kind, n, sym, ample = RUNS[name]
    b = _model(pkg, kind, n).checker()
    if sym:
        b = b.symmetry()
    if ample:
        # the JAX analyzer does not certify the 2pc mask under JAX 0.9
        # (see the module docstring); the port's analyzer does, so its
        # runs need no waiver
        b = b.unsound_ok() if pkg == "jax" else b
    return b, ample


def _port(name: str, sparse: bool = True):
    b, ample = _builder("torch", name)
    return b.spawn_sortmerge(capacity=1 << 12, device="cpu",
                             sparse=sparse, ample_set=ample).join()


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine's runs, each made once, on first use."""
    runs = {}

    def get(name):
        if name not in runs:
            b, ample = _builder("jax", name)
            runs[name] = b.spawn_tpu_sortmerge(
                ample_set=ample, **JAX_SHAPES).join()
        return runs[name]

    return get


def _reachable(model):
    [init] = model.init_states()
    seen, q = {init}, deque([init])
    while q:
        for n in model.next_states(q.popleft()):
            if n not in seen:
                seen.add(n)
                q.append(n)
    return list(seen)


def _specs(kind: str, n: int):
    """(JAX encoding, port encoding) of one configuration."""
    return (_model("jax", kind, n).to_encoded(),
            _model("torch", kind, n).to_encoded())


def _fields(spec):
    return (spec.n_members, tuple(
        (f.lane, f.shift, f.stride, f.width, f.sort_key)
        for f in spec.fields))


# -- the canonicalizer -----------------------------------------------------


@pytest.mark.parametrize("kind,n,raw", [("2pc", 3, 288), ("2pc", 5, 8832),
                                        ("register", 4, 217)])
def test_canonical_form_is_jax_bit_for_bit(kind, n, raw):
    from stateright_tpu.ops.canonical import canonicalize_rows as jax_canon
    from stateright_tpu_torch.ops.canonical import canonicalize_rows

    j, p = _specs(kind, n)
    js, ps = j.device_rewrite_spec(), p.device_rewrite_spec()
    assert _fields(ps) == _fields(js)
    states = _reachable(p.host_model)
    assert len(states) == raw
    rows = np.stack([p.encode(s) for s in states])
    rng = np.random.default_rng(SEED)
    rand = rng.integers(0, 1 << 32, size=(10_000, p.width), dtype=np.uint64)
    for block in (rows, rand.astype(np.uint32)):
        want = jax_canon(js, block.astype(np.uint32), np)
        got = canonicalize_rows(ps, torch.from_numpy(block.astype(np.int64)))
        assert np.array_equal(got.numpy(), want.astype(np.int64))
    canon = canonicalize_rows(ps, torch.from_numpy(rows.astype(np.int64)))
    for s, c in zip(states, canon.numpy()):
        assert p.decode(c) == s.representative_full()
    # canonical forms are fixed points, and the lane-major form agrees
    assert torch.equal(canonicalize_rows(ps, canon), canon)
    from stateright_tpu_torch.ops.canonical import canonicalize_t

    assert torch.equal(canonicalize_t(ps, canon.T.contiguous()).T, canon)


def _malformed(ns):
    f = ns.MemberField(lane=0, shift=0, stride=2, width=2, sort_key=True)
    return [
        lambda: ns.DeviceRewriteSpec(n_members=1, fields=(f,)),
        lambda: ns.DeviceRewriteSpec(n_members=3, fields=()),
        lambda: ns.DeviceRewriteSpec(n_members=3, fields=(
            ns.MemberField(0, 0, stride=1, width=2, sort_key=True),)),
        lambda: ns.DeviceRewriteSpec(n_members=8, fields=(
            ns.MemberField(0, 8, stride=4, width=4, sort_key=True),)),
        lambda: ns.DeviceRewriteSpec(n_members=3, fields=(
            ns.MemberField(0, 0, stride=2, width=2, sort_key=False),)),
        lambda: ns.validate_spec(ns.DeviceRewriteSpec(n_members=3, fields=(
            ns.MemberField(5, 0, stride=2, width=2, sort_key=True),)),
            width=2),
        # 32 key bits + 1 tiebreak bit: an int64 key would hold it, the
        # JAX uint32 key does not, so neither package admits it
        lambda: ns.DeviceRewriteSpec(n_members=2, fields=(
            ns.MemberField(0, 0, stride=16, width=16, sort_key=True),
            ns.MemberField(1, 0, stride=16, width=16, sort_key=True))),
    ]


@pytest.mark.parametrize("case", range(7))
def test_validate_spec_refuses_what_jax_refuses(case):
    from stateright_tpu.ops import canonical as jax_ns
    from stateright_tpu_torch.ops import canonical as port_ns

    with pytest.raises(ValueError) as je:
        _malformed(jax_ns)[case]()
    with pytest.raises(ValueError) as pe:
        _malformed(port_ns)[case]()
    assert str(pe.value) == str(je.value)


def test_mask_to_words_matches_jax():
    from stateright_tpu.ops.bitmask import mask_to_words as jax_words
    from stateright_tpu_torch.ops.bitmask import mask_to_words, words_to_mask

    rng = np.random.default_rng(SEED)
    for k in (1, 17, 32, 47, 65):
        mask = rng.random((50, k)) < 0.5
        got = mask_to_words(torch.from_numpy(mask))
        assert np.array_equal(got.numpy(), jax_words(np, mask))
        assert torch.equal(words_to_mask(got, k), torch.from_numpy(mask))


# -- the engine ------------------------------------------------------------


@pytest.mark.parametrize("name,sparse,unique", [
    ("2pc-sym-3", True, 80), ("2pc-sym-3", False, 80),
    ("2pc-sym-5", True, 314), ("2pc-sym-5", False, 314),
    ("2pc-ample-3", True, 260), ("2pc-both-3", True, 76),
    ("register-sym-4", True, 21), ("register-sym-4", False, 21),
    ("register-4", True, 217),
])
def test_reduced_counts_on_cpu(name, sparse, unique):
    c = _port(name, sparse)
    assert c.unique_state_count() == unique
    sym = RUNS[name][2]
    assert (c.metrics["canonical_hits"] > 0) == sym
    for prop, path in c.discoveries().items():
        assert c.model.property_by_name(prop).condition(
            c.model, path.last_state())


@pytest.mark.slow
@pytest.mark.parametrize("rm,unique", [(6, 553), (7, 920)])
@pytest.mark.parametrize("sparse", [True, False])
def test_2pc_symmetry_counts_slow(rm, unique, sparse):
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    c = TwoPhaseSys(rm_count=rm).checker().symmetry().spawn_sortmerge(
        capacity=1 << 12, device="cpu", sparse=sparse).join()
    assert c.unique_state_count() == unique


@pytest.mark.parametrize("name,sparse", [
    ("2pc-sym-3", True), ("2pc-sym-3", False), ("2pc-ample-3", True),
    ("2pc-both-3", True), ("register-sym-4", True),
    ("register-sym-4", False),
])
def test_matches_jax_engine(jax_runs, name, sparse):
    j, p = jax_runs(name), _port(name, sparse)
    assert p.unique_state_count() == j.unique_state_count()
    assert p.state_count() == j.state_count()
    assert p.max_depth() == j.max_depth()
    assert p.discovery_fingerprints() == j.discovery_fingerprints()
    jd, pd = j.discoveries(), p.discoveries()
    assert set(pd) == set(jd) and pd
    for prop in jd:
        assert pd[prop].encode() == jd[prop].encode(), prop


# -- refusals --------------------------------------------------------------


def _paxos(pkg: str):
    import importlib

    px = importlib.import_module(
        "stateright_tpu.models.paxos" if pkg == "jax"
        else "stateright_tpu_torch.models.paxos")
    return px.paxos_model(px.PaxosModelCfg(client_count=1, server_count=3))


def test_refusal_wording_is_jax(jax_runs):
    from stateright_tpu.checkers import common as jc
    from stateright_tpu_torch.checkers import common as pc

    assert str(pc.reduction_refusal("symmetry", "E", ["a", "b"])) == str(
        jc.reduction_refusal("symmetry", "E", ["a", "b"]))
    js = str(jc.soundness_refusal("E", "ample-set", "rule", "why"))
    ps = str(pc.soundness_refusal("E", "ample-set", "rule", "why"))
    assert ps == js.replace("stateright_tpu/analysis/soundness.py",
                            "stateright_tpu_torch/analysis/soundness.py")
    # the capability refusal: the same head and missing capability
    with pytest.raises(ValueError) as je:
        _paxos("jax").checker().symmetry().spawn_tpu_sortmerge(
            capacity=1 << 12)
    with pytest.raises(ValueError) as pe:
        _paxos("torch").checker().symmetry().spawn_sortmerge(device="cpu")
    jparts = str(je.value).replace("spawn_tpu_sortmerge",
                                   "spawn_sortmerge").split("; ")
    pparts = str(pe.value).split("; ")
    assert pparts[:2] == jparts[:2]
    assert pparts[1].startswith("missing capability: encoding "
                                "PaxosEncoded declares no")
    # no ample mask: the JAX message, word for word
    with pytest.raises(ValueError, match="sound reduction") as pe:
        _paxos("torch").checker().spawn_sortmerge(
            device="cpu", ample_set=True).join()
    with pytest.raises(ValueError) as je:
        _paxos("jax").checker().spawn_tpu_sortmerge(
            capacity=1 << 12, frontier_capacity=512, cand_capacity=2048,
            ample_set=True).join()
    assert str(pe.value) == str(je.value)


def test_dense_ample_set_refuses():
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    c = TwoPhaseSys(rm_count=3).checker().spawn_sortmerge(
        device="cpu", sparse=False, ample_set=True)
    with pytest.raises(ValueError, match="^ample_set requires the sparse "
                       "dispatch path .*resolved to the dense wave$"):
        c.join()


def test_unlisted_spec_and_mask_refuse_unless_waived():
    """A subclass declaring 2pc's own spec and mask certifies and runs; a
    spec or mask the analyzer refuses raises at spawn naming the failed
    obligation, with the JAX wording, unless ``unsound_ok()`` waives it.
    The certificate is keyed on the declared spec and mask, so an
    instance declaring another mask than its type's is analyzed anew."""
    from stateright_tpu_torch.analysis.soundness import certify_encoding
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.models.two_phase_commit_tpu import (
        TwoPhaseSysEncoded,
    )
    from stateright_tpu_torch.ops.bitmask import pack_bits_host
    from stateright_tpu_torch.ops.canonical import (
        DeviceRewriteSpec,
        MemberField,
    )

    class Same(TwoPhaseSysEncoded):
        """The type's spec and mask on another type."""

    class Overlap(TwoPhaseSysEncoded):
        """Two lane-0 member fields that share a bit."""

        def device_rewrite_spec(self):
            return DeviceRewriteSpec(self.rm_count, (
                MemberField(0, 0, 2, 2, sort_key=True),
                MemberField(0, 1, 2, 1, sort_key=True)))

    def drop_every_abort(enc):
        keep = np.ones(enc.max_actions, dtype=bool)
        keep[[4 + 5 * rm for rm in range(enc.rm_count)]] = False
        return pack_bits_host(keep)

    same = Same(3)
    res = certify_encoding(same, device="cpu")
    assert res.sym_certified is True and res.ample_certified is True
    c = TwoPhaseSys(rm_count=3).checker().symmetry().spawn_sortmerge(
        encoded=same, device="cpu", ample_set=True).join()
    assert c.unique_state_count() == 76

    bad_mask = TwoPhaseSysEncoded(3)
    bad_mask.ample_mask_host = lambda: drop_every_abort(bad_mask)
    for enc, sym, ample, head, rule in (
            (Overlap(3), True, False, "symmetry", "group-closure"),
            (bad_mask, False, True, "ample-set", "ample-non-suppression")):
        b = TwoPhaseSys(rm_count=3).checker()
        b = b.symmetry() if sym else b
        with pytest.raises(ValueError) as e:
            b.spawn_sortmerge(encoded=enc, device="cpu",
                              ample_set=ample).join()
        msg = str(e.value)
        assert msg.startswith(
            f"{head} reduction: spawn_sortmerge cannot honor it; "
            f"soundness certificate refused: obligation {rule!r} "
            "failed — "), msg
        assert "pass --unsound-ok (CheckerBuilder.unsound_ok())" in msg
        assert "stateright_tpu_torch/analysis/soundness.py" in msg
    waived = TwoPhaseSys(rm_count=3).checker().symmetry().unsound_ok()
    c = waived.spawn_sortmerge(encoded=Overlap(3), device="cpu").join()
    assert c.sym_spec is not None and c.unique_state_count() > 0
    c = TwoPhaseSys(rm_count=3).checker().unsound_ok().spawn_sortmerge(
        encoded=bad_mask, device="cpu", ample_set=True).join()
    assert 0 < c.unique_state_count() < 260


def test_compiled_encoding_spec_is_gated():
    """A spec passed to the actor compiler is validated against the
    compiled width and analyzed like any other: this one's successor
    sets do not commute with the RM swap, and its one-slot mask drops
    enabled slots, so each refuses with its obligation and runs only
    waived."""
    from stateright_tpu_torch.analysis.soundness import certify_encoding
    from stateright_tpu_torch.ops.canonical import (
        DeviceRewriteSpec,
        MemberField,
    )
    from stateright_tpu_torch.models.two_phase_commit_actors import (
        two_phase_sys_actor_model,
        two_phase_sys_compiled_encoded,
    )

    spec = DeviceRewriteSpec(2, (MemberField(0, 0, 2, 2, sort_key=True),))
    enc = two_phase_sys_compiled_encoded(2, device_rewrite_spec=spec,
                                         ample_mask=(1,))
    assert enc.device_rewrite_spec() is spec
    assert enc.ample_mask_host() == (1,)
    res = certify_encoding(enc, device="cpu")
    assert res.failed("symmetry").rule == "transition-equivariance"
    assert res.failed("ample").rule == "ample-enabledness"
    model = two_phase_sys_actor_model(2)
    with pytest.raises(ValueError, match="'transition-equivariance'"):
        model.checker().symmetry().spawn_sortmerge(encoded=enc,
                                                   device="cpu")
    with pytest.raises(ValueError, match="'ample-enabledness'"):
        model.checker().spawn_sortmerge(encoded=enc, device="cpu",
                                        ample_set=True).join()
    c = model.checker().symmetry().unsound_ok().spawn_sortmerge(
        encoded=enc, device="cpu")
    assert c.sym_spec is spec


def test_certified_list_is_the_jax_analyzers():
    """The port's analyzer certifies exactly what the JAX analyzer
    certifies: the 2pc and register symmetry specs (live JAX
    ``certify_encoding``) and 2pc's ample mask (``SOUND_r01.json``,
    written by JAX 0.4.37: JAX 0.9's analyzer refuses it)."""
    from stateright_tpu.analysis.soundness import certify_encoding
    from stateright_tpu_torch.analysis.soundness import (
        certify_encoding as port_certify,
    )

    for kind, n in (("2pc", 3), ("register", 4)):
        j, p = _specs(kind, n)
        assert certify_encoding(j).sym_certified is True
        assert _fields(p.device_rewrite_spec()) == _fields(
            j.device_rewrite_spec())
        assert port_certify(p, device="cpu").sym_certified is True
    sound = json.loads((ROOT / "SOUND_r01.json").read_text())
    assert sound["clean"]
    assert sound["specs"]["TwoPhaseSysEncoded(4)"]["ample"] is True
    assert sound["specs"]["TwoPhaseSysEncoded(4)"]["symmetry"] is True
    assert sound["specs"]["NClientRegEncoded(4)"]["symmetry"] is True
    for n in (3, 4):
        j, p = _specs("2pc", n)
        assert np.array_equal(np.asarray(p.ample_mask_host(), np.uint32),
                              np.asarray(j.ample_mask_host(), np.uint32))
        assert port_certify(p, device="cpu").ample_certified is True
    _, reg = _specs("register", 4)
    assert port_certify(reg, device="cpu").ample_certified is None
    assert _specs("register", 1)[1].device_rewrite_spec() is None
