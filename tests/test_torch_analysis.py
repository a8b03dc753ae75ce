"""The PyTorch port's reduction soundness analyzer
(``stateright_tpu_torch/analysis/``), held against the JAX analyzer.

* verdicts equal the JAX analyzer's rule by rule (rule name, severity,
  scope, ``battery_rows``) for 2pc rm=3, the register n=3, the three
  JAX mutants (an overlapping spec fails only ``group-closure``, an
  asymmetric property ``property-invariance``, a mask dropping every
  RM's abort only ``ample-non-suppression``) and the compiled
  2pc-actors encoding with a declared spec and mask. JAX 0.9's analyzer
  refuses 2pc's ample mask (its walker names only ``pjit``, ROADMAP
  §3), so 2pc's ample verdicts are held to the committed
  ``SOUND_r01.json`` (JAX 0.4.37) instead, and the mutants' to what the
  JAX tests assert;
* the bit footprints, the battery and the member permutation equal
  JAX's where the JAX interpreter is exact;
* the int64 carrier: a property that reads a member's field only
  through bits 32-63 (a shift up past bit 31 and an arithmetic shift
  back) keeps its footprint, and a mask that suppresses its witnesses
  refuses; a device function with a data-dependent branch refuses
  rather than certify;
* certificates are deterministic; ``SOUND_r*.json`` round-trips
  through ``artifacts.latest_soundness_summary``; ``analyze`` exits 0,
  1 and 2 as JAX's does; a reduced run's ``run_begin`` lane carries
  ``symmetry``, ``ample_set`` and ``soundness_certified``, and the
  port's trace diff flags a certified/refused flip between two port
  traces.

Every JAX certificate is made once, in one module fixture.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stateright_tpu_torch import telemetry
from stateright_tpu_torch.analysis import soundness as ps
from stateright_tpu_torch.analysis.walker import (
    TraceRefused,
    source_of,
    trace_cols,
)
from stateright_tpu_torch.artifacts import latest_soundness_summary
from stateright_tpu_torch.models.nclient_register_tpu import (
    NClientRegEncoded,
)
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
from stateright_tpu_torch.models.two_phase_commit_tpu import (
    TwoPhaseSysEncoded,
)
from stateright_tpu_torch.ops.bitmask import pack_bits_host
from stateright_tpu_torch.ops.canonical import DeviceRewriteSpec, MemberField

ROOT = Path(__file__).resolve().parents[1]
SYM = ("group-closure", "orbit-structure", "fingerprint-invariance",
       "property-invariance", "transition-equivariance")
AMPLE = ("ample-enabledness", "ample-non-suppression")


# -- the port mutants (JAX tests/test_soundness.py :105, :125, :135) -------


class Overlap2pc(TwoPhaseSysEncoded):
    """Two lane-0 member fields whose bit ranges overlap (member m's
    width-2 field at bit 2m and width-1 field at bit 2m+1)."""

    def device_rewrite_spec(self):
        return DeviceRewriteSpec(self.rm_count, (
            MemberField(0, 0, 2, 2, sort_key=True),
            MemberField(0, 1, 2, 1, sort_key=True)))


class AsymProp(NClientRegEncoded):
    """The first property reads only client 0's pc, written into the
    result through a view (functionalized to a ``select_scatter``)."""

    def property_conditions_cols(self, states_t):
        base = super().property_conditions_cols(states_t)
        base[:, 0] = (states_t[1] & 3) == 2
        return base


def _drop_every_abort(enc):
    keep = np.ones(enc.max_actions, dtype=bool)
    for rm in range(enc.rm_count):
        keep[4 + 5 * rm] = False
    return pack_bits_host(keep)


class BadAmple(TwoPhaseSysEncoded):
    """Drops slot ``4 + 5*rm`` (rm_choose_abort) for EVERY member: the
    dropped transitions have no symmetric kept image."""

    def ample_mask_host(self):
        return _drop_every_abort(self)


class HighBitBadAmple(BadAmple):
    """BadAmple whose properties read lane 0 only after a round trip
    through bits 32-63: ``(lane0 << 32) >> 32``. The RM fields sit in
    bits 0-19 and survive it, so the predicates are 2pc's; an analyzer
    with 32 bits an element would lose lane 0 at the ``<< 32``, see no
    property read of it, and certify the mask."""

    def property_conditions_cols(self, states_t):
        lane0 = (states_t[0] << 32) >> 32
        return super().property_conditions_cols(
            torch.stack([lane0, states_t[1]]))


class HighBitAsym(NClientRegEncoded):
    """The first property reads the LAST client's pc, and reaches it
    only through bits 32-63."""

    def property_conditions_cols(self, states_t):
        base = super().property_conditions_cols(states_t)
        hi = (states_t[1] << 32) >> (32 + 4 * (self.n_clients - 1))
        return torch.cat([((hi & 3) == 2)[:, None], base[:, 1:]], dim=1)


class BranchyProp(NClientRegEncoded):
    """A property function that branches on a value."""

    def property_conditions_cols(self, states_t):
        base = super().property_conditions_cols(states_t)
        if bool((states_t[0] != 0).any()):
            return base
        return ~base


class ItemGuard(TwoPhaseSysEncoded):
    """An enabled-bits function that reads a value to the host."""

    def enabled_bits_cols(self, states_t):
        words = super().enabled_bits_cols(states_t)
        return words | int(states_t[1, 0].item() & 1)


def _compiled(pkg: str):
    import importlib

    root = "stateright_tpu" if pkg == "jax" else "stateright_tpu_torch"
    can = importlib.import_module(f"{root}.ops.canonical")
    tpa = importlib.import_module(f"{root}.models.two_phase_commit_actors")
    spec = can.DeviceRewriteSpec(2, (can.MemberField(0, 0, 2, 2,
                                                     sort_key=True),))
    return tpa.two_phase_sys_compiled_encoded(2, device_rewrite_spec=spec,
                                              ample_mask=(1,))


def _jax_encodings():
    import jax.numpy as jnp

    from stateright_tpu.models.nclient_register_tpu import (
        NClientRegEncoded as JReg,
    )
    from stateright_tpu.models.two_phase_commit_tpu import (
        TwoPhaseSysEncoded as J2pc,
    )
    from stateright_tpu.ops.bitmask import pack_bits_host as jpack
    from stateright_tpu.ops.canonical import (
        DeviceRewriteSpec as JSpec,
        MemberField as JField,
    )

    class JOverlap(J2pc):
        def device_rewrite_spec(self):
            return JSpec(self.rm_count, (
                JField(0, 0, 2, 2, sort_key=True),
                JField(0, 1, 2, 1, sort_key=True)))

    class JAsym(JReg):
        def property_conditions_vec(self, vec):
            base = super().property_conditions_vec(vec)
            return base.at[0].set((vec[1] & jnp.uint32(3)) == 2)

    class JBadAmple(J2pc):
        def ample_mask_host(self):
            keep = np.ones(self.max_actions, dtype=bool)
            for rm in range(self.rm_count):
                keep[4 + 5 * rm] = False
            return jpack(keep)

    return {"2pc": lambda: J2pc(3), "register": lambda: JReg(3),
            "overlap": lambda: JOverlap(3), "asym": lambda: JAsym(3),
            "bad_ample": lambda: JBadAmple(3),
            "compiled": lambda: _compiled("jax")}


@pytest.fixture(scope="module")
def jax_cert():
    """The JAX analyzer's certificate of each case, made once, on first
    use."""
    from stateright_tpu.analysis.soundness import certify_encoding

    made, factories = {}, _jax_encodings()

    def get(name):
        if name not in made:
            made[name] = certify_encoding(factories[name](),
                                          use_cache=False)
        return made[name]

    return get


PORT = {"2pc": lambda: TwoPhaseSysEncoded(3),
        "register": lambda: NClientRegEncoded(3),
        "overlap": lambda: Overlap2pc(3), "asym": lambda: AsymProp(3),
        "bad_ample": lambda: BadAmple(3),
        "compiled": lambda: _compiled("torch")}


def _port(name):
    return ps.certify_encoding(PORT[name](), use_cache=False, device="cpu")


def _verdicts(res, scope=None):
    return [(f.rule, f.severity, f.data.get("scope"),
             f.data.get("battery_rows"))
            for f in res.obligations
            if scope is None or f.data.get("scope") == scope]


def _failed(res, scope=None):
    return [f.rule for f in res.obligations
            if f.severity == "error"
            and (scope is None or f.data.get("scope") == scope)]


# -- verdicts, rule by rule -------------------------------------------------


@pytest.mark.parametrize("name", ["2pc", "register", "overlap", "asym",
                                  "bad_ample", "compiled"])
def test_symmetry_verdicts_equal_jax(jax_cert, name):
    j, p = jax_cert(name), _port(name)
    assert _verdicts(p, "symmetry") == _verdicts(j, "symmetry")
    assert p.sym_certified is j.sym_certified
    if name in ("2pc", "register"):
        assert p.encoding == j.encoding


def test_the_shipping_specs_certify_exactly():
    p2, pr = _port("2pc"), _port("register")
    assert p2.certified and p2.sym_certified and p2.ample_certified
    assert [f.rule for f in p2.obligations] == list(SYM + AMPLE)
    assert all(f.severity == "info" for f in p2.obligations)
    assert pr.certified and pr.ample_certified is None
    assert [f.rule for f in pr.obligations] == list(SYM)
    # the interpreter is exact on both: nothing over-approximated
    assert p2.collapsed == [] and pr.collapsed == []
    assert p2.encoding == "TwoPhaseSysEncoded(3)"
    assert pr.encoding == "NClientRegEncoded(3)"


def test_verdicts_equal_the_committed_certificate():
    """SOUND_r01.json (JAX 0.4.37): every obligation of 2pc rm=4 and
    the register n=4, the ample ones with their dropped and relevant
    slots and enumeration method."""
    sound = json.loads((ROOT / "SOUND_r01.json").read_text())
    for enc in (TwoPhaseSysEncoded(4), NClientRegEncoded(4)):
        p = ps.certify_encoding(enc, use_cache=False, device="cpu")
        want = sound["specs"][p.encoding]
        got = p.as_dict()
        assert (got["status"], got["symmetry"], got["ample"],
                got["collapsed_primitives"]) == (
            want["status"], want["symmetry"], want["ample"],
            want["collapsed_primitives"])
        assert [(o["rule"], o["severity"], o.get("data"))
                for o in got["obligations"]] == [
            (o["rule"], o["severity"], o.get("data"))
            for o in want["obligations"]]


def test_ample_verdicts_of_the_2pc_cases(jax_cert):
    """2pc rm=3 certifies its mask as JAX 0.4.37 did; the mutants refuse
    it as the JAX tests assert: BadAmple only on non-suppression (its
    dropped guards are member-symmetric, so enabledness holds), and the
    overlap spec loses the symmetric-image argument."""
    p2 = _port("2pc")
    assert _verdicts(p2, "ample") == [
        ("ample-enabledness", "info", "ample", None),
        ("ample-non-suppression", "info", "ample", None)]
    assert p2.failed("ample") is None
    ba = _port("bad_ample")
    assert ba.sym_certified is True and ba.ample_certified is False
    assert _failed(ba) == ["ample-non-suppression"]
    ov = _port("overlap")
    assert _failed(ov, "symmetry") == ["group-closure"]
    assert ov.ample_certified is False
    assert _failed(ov, "ample") == ["ample-non-suppression"]
    # the JAX analyzer refuses both masks too
    assert jax_cert("bad_ample").ample_certified is False
    assert jax_cert("overlap").ample_certified is False


def test_mutants_fail_their_obligation_only(jax_cert):
    assert _failed(_port("asym")) == ["property-invariance"]
    assert _failed(jax_cert("asym")) == ["property-invariance"]
    # the compiled encoding: the JAX analyzer's verdict in both scopes
    p, j = _port("compiled"), jax_cert("compiled")
    assert _verdicts(p) == _verdicts(j)
    assert _failed(p) == ["transition-equivariance", "ample-enabledness",
                          "ample-non-suppression"]
    assert p.failed("symmetry").data["row"] == j.failed(
        "symmetry").data["row"]
    # its table gathers at state-dependent indices over-approximate
    assert p.collapsed == ["index"]


def test_refusals_are_distinct_and_name_the_obligation():
    msgs = {}
    for name, scope in (("overlap", "symmetry"), ("asym", "symmetry"),
                        ("bad_ample", "ample")):
        f = _port(name).failed(scope)
        msgs[f.rule] = f.message
    assert set(msgs) == {"group-closure", "property-invariance",
                         "ample-non-suppression"}
    assert len(set(msgs.values())) == 3


# -- footprints, battery, permutation against JAX --------------------------


def test_footprints_and_battery_equal_jax():
    from stateright_tpu.analysis import soundness as js
    from stateright_tpu.models.nclient_register_tpu import (
        NClientRegEncoded as JReg,
    )
    from stateright_tpu.models.two_phase_commit_tpu import (
        TwoPhaseSysEncoded as J2pc,
    )

    for jenc, penc in ((J2pc(3), TwoPhaseSysEncoded(3)),
                       (JReg(3), NClientRegEncoded(3))):
        jn, jf, jinterp, _ = js.property_footprints(jenc)
        pn, pf, pinterp, _ = ps.property_footprints(penc)
        assert jinterp.collapsed == [] and pinterp.collapsed == []
        assert pn == jn
        assert np.array_equal(np.stack(pf), np.stack(jf))
        jspec = jenc.device_rewrite_spec()
        assert np.array_equal(
            ps.battery_rows(penc, penc.device_rewrite_spec(), pf),
            js.battery_rows(jenc, jspec, jf))

    # the guards and pair-step writes, which JAX 0.9's interpreter
    # over-approximates (``jit``): each is exactly what the step does
    g, interp, _ = ps.guard_footprints(NClientRegEncoded(3))
    assert interp.collapsed == []
    # slots 2c and 2c+1 read client c's pc (lane 1 bits 4c, 4c+1)
    assert [list(m) for m in g] == [[0, 3 << (4 * (k // 2))]
                                    for k in range(6)]
    enc = NClientRegEncoded(3)
    graph = ps._step_slot_graph(enc)
    writes = [list(ps.step_slot_footprints(enc, k, graph)[0])
              for k in range(6)]
    # write(c): the register, pc and won; read(c): pc and rv
    assert writes == [[1, 0x7 << (4 * c)] if k % 2 == 0
                      else [0, 0xB << (4 * c)]
                      for k, c in ((k, k // 2) for k in range(6))]
    enc = TwoPhaseSysEncoded(3)
    graph = ps._step_slot_graph(enc)
    # tm_commit: tm_state and the commit message; rm_prepare(0): rm 0's
    # state and its prepared message; rm_choose_abort(0) and (1)
    for slot, want in ((0, [0, 0x23]), (3, [0x3, 0x80]), (4, [0x3, 0]),
                       (9, [0xC, 0])):
        got = ps.step_slot_footprints(enc, slot, graph)[0]
        assert list(got) == want, slot


def test_member_permutation_equals_jax_and_encode():
    from dataclasses import replace

    from stateright_tpu.analysis.soundness import (
        apply_member_permutation as japply,
    )
    from stateright_tpu_torch.models.nclient_register import NClientRegSys

    enc = NClientRegEncoded(3)
    spec = enc.device_rewrite_spec()
    rows = np.random.default_rng(20261018).integers(
        0, 1 << 32, size=(64, 2), dtype=np.uint64).astype(np.uint32)
    for perm in ((1, 0, 2), (2, 0, 1)):
        assert np.array_equal(ps.apply_member_permutation(spec, rows, perm),
                              japply(spec, rows, perm))
    model = NClientRegSys(3)
    s = next(iter(model.next_states(model.init_states()[0])))
    perm = (2, 0, 1)  # output member p takes input member perm[p]
    got = ps.apply_member_permutation(spec, enc.encode(s)[None, :], perm)[0]
    want = enc.encode(replace(s, clients=tuple(s.clients[p] for p in perm)))
    assert np.array_equal(got, want)
    mask = np.array([0, 0xF], np.uint32)
    assert np.array_equal(ps.permute_mask(spec, mask, perm), [0, 0xF0])


# -- the int64 carrier and what cannot be traced ---------------------------


def _interp(fn, width=2):
    gm = trace_cols(fn, width)
    out = ps._BitInterp(width).run(gm, [ps._seed(width)])
    return out, gm


def test_int64_shifts_are_modelled():
    # a bit pushed past 31 and shifted back is still tracked
    out, _ = _interp(lambda s: ((s[1] << 8) >> 36) & 1)
    assert out.codes.shape == (1, 64)
    assert out.codes[0, 0] == 32 + 28  # lane 1 bit 28
    assert (out.codes[0, 1:] == ps._CONST0).all()
    # ~x sets bits 32-63; >> is arithmetic, so they come back down
    out, _ = _interp(lambda s: (~s[0]) >> 40)
    assert (out.codes[0, :24] == ps._CONST1).all()
    assert (out.codes[0, 24:] == ps._CONST1).all()
    out, _ = _interp(lambda s: ((~s[0]) >> 28) & 0xFF)
    # bits 28-31 negated (DEP on exactly those), then bits 32-35 of ~x
    assert (out.codes[0, :4] == ps._DEP).all()
    assert list(out.deps[0, :4, 0]) == [1 << b for b in range(28, 32)]
    assert (out.codes[0, 4:8] == ps._CONST1).all()
    assert (out.codes[0, 8:] == ps._CONST0).all()
    # an in-range uint32 lane masked after ~ stays exact
    out, _ = _interp(lambda s: s[1] & ~3)
    assert list(out.codes[0, :4]) == [ps._CONST0, ps._CONST0, 34, 35]
    assert (out.codes[0, 32:] == ps._CONST0).all()


def test_high_bit_reads_keep_their_footprint():
    names, fps, interp, _ = ps.property_footprints(HighBitAsym(3))
    assert interp.collapsed == []
    # the first property reads client 2's pc (lane 1 bits 8-9) only
    assert list(fps[0]) == [0, 0x300]
    res = ps.certify_encoding(HighBitAsym(3), use_cache=False,
                              device="cpu")
    f = res.failed("symmetry")
    assert f.rule == "property-invariance"
    # refused by the static footprint check, before the battery
    assert f.data["members"] == [2]
    _, fps, _, _ = ps.property_footprints(HighBitBadAmple(3))
    assert fps[0][0] == (1 << 6) - 1  # every RM field of lane 0
    res = ps.certify_encoding(HighBitBadAmple(3), use_cache=False,
                              device="cpu")
    assert res.sym_certified is True
    assert _failed(res) == ["ample-non-suppression"]


def test_untraceable_functions_refuse():
    with pytest.raises(TraceRefused) as e:
        trace_cols(BranchyProp(3).property_conditions_cols, 2)
    assert "test_torch_analysis.py" in e.value.source
    res = ps.certify_encoding(BranchyProp(3), use_cache=False,
                              device="cpu")
    assert not res.certified and res.sym_certified is False
    f = res.failed("symmetry")
    assert f.rule == "property-invariance"
    assert "cannot be traced" in f.message
    assert f.data["function"] == "property_conditions_cols"
    assert "test_torch_analysis.py" in f.source
    res = ps.certify_encoding(ItemGuard(3), use_cache=False, device="cpu")
    assert res.sym_certified is True and res.ample_certified is False
    assert res.failed("ample").rule == "ample-enabledness"
    assert ps.soundness_status(BranchyProp(3), "cpu") is False
    with pytest.raises(ValueError, match="'property-invariance'"):
        from stateright_tpu_torch.models.nclient_register import (
            NClientRegSys,
        )

        NClientRegSys(3).checker().symmetry().spawn_sortmerge(
            encoded=BranchyProp(3), device="cpu")


def test_trace_is_functional_and_attributed():
    enc = TwoPhaseSysEncoded(3)
    gm = trace_cols(enc.enabled_bits_cols, enc.width)
    calls = [n.target for n in gm.graph.nodes if n.op == "call_function"]
    # or_class_words's ``acc |=`` is functionalized away
    assert not any(t._schema.is_mutable for t in calls
                   if hasattr(t, "_schema"))
    assert "aten.bitwise_or.Tensor" in [str(t) for t in calls]
    where = [n for n in gm.graph.nodes if str(n.target) == "aten.where.self"]
    assert where and "bitmask.py" in source_of(where[0])
    # the view write of AsymProp becomes a scatter, read exactly
    gm = trace_cols(AsymProp(3).property_conditions_cols, 2)
    assert any("select_scatter" in str(n.target) for n in gm.graph.nodes)
    _, fps, interp, _ = ps.property_footprints(AsymProp(3))
    assert interp.collapsed == [] and list(fps[0]) == [0, 0x3]


def test_writes_through_views_are_functional():
    """In-place writes into a tensor made in the function, through
    ``select`` and ``t`` views, become scatters the interpreter reads
    exactly."""

    def fn(s):
        t = torch.zeros((2, 1), dtype=torch.int64)
        t[1] = s[0]
        t[0] |= s[1] & 1
        u = t.t()
        u[0, 1] = u[0, 1] >> 4
        return t.permute(1, 0)

    gm = trace_cols(fn, 2)
    calls = [n.target for n in gm.graph.nodes if n.op == "call_function"]
    assert not any(t._schema.is_mutable for t in calls)
    out = ps._BitInterp(2).run(gm, [ps._seed(2)])
    # column 0: lane 1's bit 0; column 1: lane 0 shifted down by 4
    assert list(out.codes[0, 0, :2]) == [32, ps._CONST0]
    assert list(out.codes[0, 1, :3]) == [4, 5, 6]
    assert (out.codes[0, 1, 28:] == ps._CONST0).all()


_OUTSIDE = torch.zeros((2, 1), dtype=torch.int64)


def _stale_view(s):
    t = s.clone()
    row = t[0]
    t += 1
    return row + 1


def _write_through_expand(s):
    t = s.expand(2, 3)
    t[:, 0] = 1
    return t


@pytest.mark.parametrize("fn, why", [
    (lambda s: s + s[0, 0].item(), "_local_scalar_dense"),
    (lambda s: s + (1 if s.tolist()[0][0] else 0), "tolist"),
    (lambda s: s + int(s.numpy().sum()), "numpy"),
    (lambda s: s + torch.equal(s, s), "equal"),
    (lambda s: torch.nonzero(s), "nonzero"),
    (lambda s: s[s > 0], "index.Tensor"),
    (lambda s: _OUTSIDE.copy_(s), "made outside"),
    (_stale_view, "read after a write"),
    (_write_through_expand, "cannot invert"),
], ids=["item", "tolist", "numpy", "equal", "nonzero", "mask-index",
        "outside-write", "stale-view", "expand-write"])
def test_untraceable_forms_refuse(fn, why):
    with pytest.raises(TraceRefused, match=why) as e:
        trace_cols(fn, 2)
    assert "test_torch_analysis.py" in e.value.source


def test_certificate_needs_no_compiler_stack():
    """The recorder uses neither ``make_fx`` nor fake tensors: a fresh
    process certifies 2pc without importing ``torch._dynamo`` or sympy,
    which would cost the first gated spawn seconds."""
    code = (
        "import sys\n"
        "from stateright_tpu_torch.analysis.soundness import "
        "certify_encoding\n"
        "from stateright_tpu_torch.models.two_phase_commit_tpu import "
        "TwoPhaseSysEncoded\n"
        "assert certify_encoding(TwoPhaseSysEncoded(3), "
        "device='cpu').certified\n"
        "print(sorted(m for m in ('torch._dynamo', 'sympy') "
        "if m in sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


# -- certificates, artifact, CLI, gates ------------------------------------


def test_certificates_are_deterministic():
    for enc in (TwoPhaseSysEncoded(3), BadAmple(3)):
        a = ps.certify_encoding(enc, use_cache=False, device="cpu").as_dict()
        b = ps.certify_encoding(enc, use_cache=False, device="cpu").as_dict()
        a.pop("analyzer_sec")
        b.pop("analyzer_sec")
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_gates_and_status_views():
    assert ps.gate_symmetry(NClientRegEncoded(3), "spawn_x",
                            device="cpu") is True
    assert ps.gate_symmetry(Overlap2pc(3), "spawn_x", unsound_ok=True,
                            device="cpu") is False
    assert ps.gate_ample(BadAmple(3), "spawn_x", unsound_ok=True,
                         device="cpu") is False
    with pytest.raises(ValueError, match="^ample-set reduction: spawn_x "
                       "cannot honor it; soundness certificate refused: "
                       "obligation 'ample-non-suppression'"):
        ps.gate_ample(BadAmple(3), "spawn_x", device="cpu")
    assert ps.soundness_status(NClientRegEncoded(3), "cpu") is True
    assert ps.soundness_status(Overlap2pc(3), "cpu") is False

    class NoReductions:
        width, max_actions = 1, 1

    assert ps.soundness_status(NoReductions(), "cpu") is None
    if not torch.cuda.is_available():
        # the card by default, and no fallback to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ps.certify_encoding(NClientRegEncoded(5), use_cache=False)


def test_artifact_round_trips(tmp_path):
    root = str(tmp_path)
    res = ps.certify_encoding(NClientRegEncoded(4), device="cpu")
    path = ps.write_soundness_artifact([res], root=root)
    assert os.path.basename(path) == "SOUND_r01.json"
    report = json.loads(Path(path).read_text())
    assert report["schema"] == "soundness-cert/v1"
    assert report["clean"] is True
    assert report["provenance"]["lane"] == {
        "analyzer": "stateright_tpu_torch/analysis/soundness.py"}
    (spec,) = report["specs"].values()
    assert spec["status"] == "certified"
    assert spec["collapsed_primitives"] == []
    summary = latest_soundness_summary(root)
    assert summary["clean"] is True
    assert summary["specs"] == {"NClientRegEncoded(4)": "certified"}
    # own round sequence; a refused spec marks the artifact unclean
    bad = ps.certify_encoding(Overlap2pc(3), device="cpu")
    path2 = ps.write_soundness_artifact([res, bad], root=root)
    assert os.path.basename(path2) == "SOUND_r02.json"
    summary = latest_soundness_summary(root)
    assert summary["artifact"] == "SOUND_r02.json"
    assert summary["clean"] is False
    assert summary["specs"]["Overlap2pc(3)"] == "refused"
    Path(path2).write_text("{not json")
    assert latest_soundness_summary(root) is None


def test_analyze_exit_codes(capsys, monkeypatch, tmp_path):
    from stateright_tpu_torch.analysis import registry

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("STPU_TORCH_ARTIFACT_ROOT", str(tmp_path))
    assert ps.analyze_main(["soundness", "register", "3", "--device",
                            "cpu"]) == 0
    out = capsys.readouterr().out
    assert "register (NClientRegEncoded(3)): certified" in out
    assert "ok  group-closure" in out
    assert "wrote SOUND_r01.json" in out
    assert (tmp_path / "SOUND_r01.json").exists()
    assert ps.analyze_main(["soundness", "no-such-model",
                            "--device=cpu"]) == 2
    assert ps.analyze_main([]) == 2
    assert ps.analyze_main(["soundness", "--device", "tpu"]) == 2
    monkeypatch.setattr(registry, "SOUNDNESS_TARGETS", (
        ("register", lambda n: NClientRegEncoded(n or 3)),
        ("asym", lambda n: AsymProp(n or 3))))
    assert ps.analyze_main(["soundness", "--no-artifact",
                            "--device=cpu"]) == 1
    out = capsys.readouterr().out
    assert "asym (AsymProp(3)): REFUSED" in out
    assert "FAIL property-invariance" in out
    # through the package entry point, in a process of its own
    r = subprocess.run(
        [sys.executable, "-m", "stateright_tpu_torch", "analyze",
         "soundness", "register", "3", "--no-artifact", "--device",
         "cpu"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "register (NClientRegEncoded(3)): certified" in r.stdout


def test_ample_gate_runs_at_spawn(monkeypatch):
    """The ample certificate is made when the checker is spawned, as the
    symmetry one is, so no run's clock (``sec=``) holds the analyzer; a
    refused mask raises at spawn."""
    monkeypatch.setattr(ps, "_CERT_CACHE", {})
    c = TwoPhaseSys(rm_count=3).checker().spawn_sortmerge(
        capacity=1 << 10, device="cpu", ample_set=True)
    enc = c.encoded
    assert list(ps._CERT_CACHE) == [ps._cache_key(
        enc, enc.device_rewrite_spec(), enc.ample_mask_host())]

    def no_analyzer(*args, **kwargs):
        raise AssertionError("the analyzer ran inside the run")

    monkeypatch.setattr(ps, "trace_cols", no_analyzer)
    monkeypatch.setattr(ps, "gate_ample", no_analyzer)
    c.join()
    assert 0 < c.unique_state_count() < 288
    assert c._lane_config()["soundness_certified"] is True
    monkeypatch.undo()
    with pytest.raises(ValueError, match="'ample-non-suppression'"):
        TwoPhaseSys(rm_count=3).checker().spawn_sortmerge(
            capacity=1 << 10, device="cpu", encoded=BadAmple(3),
            ample_set=True)


def _traced(builder, **kw):
    tr = telemetry.RunTracer()
    with tr.activate():
        c = builder.spawn_sortmerge(capacity=1 << 10, device="cpu",
                                    **kw).join()
    return tr.events, c


def test_reduced_runs_carry_the_certificate(tmp_path):
    ev, c = _traced(TwoPhaseSys(rm_count=3).checker().symmetry(),
                    ample_set=True)
    assert c.unique_state_count() == 76
    [begin] = [e for e in ev if e["ev"] == "run_begin"]
    lane = begin["lane"]
    assert (lane["symmetry"], lane["ample_set"],
            lane["soundness_certified"]) == (True, True, True)
    ev_plain, _ = _traced(TwoPhaseSys(rm_count=3).checker())
    [plain] = [e for e in ev_plain if e["ev"] == "run_begin"]
    assert (plain["lane"]["symmetry"], plain["lane"]["ample_set"]) == (
        False, False)
    assert "soundness_certified" not in plain["lane"]
    # a waived refused spec says so; the trace diff flags the flip
    ev_bad, _ = _traced(TwoPhaseSys(rm_count=3).checker().symmetry()
                        .unsound_ok(), encoded=Overlap2pc(3),
                        ample_set=True)
    [bad] = [e for e in ev_bad if e["ev"] == "run_begin"]
    assert bad["lane"]["soundness_certified"] is False
    rep = telemetry.diff_traces(ev, ev_bad)
    flips = [d for d in rep["divergences"]
             if d["field"] == "soundness_certified"]
    assert flips == [dict(wave=None, field="soundness_certified",
                          a=True, b=False)]
    assert not rep["ok"]
    again, _ = _traced(TwoPhaseSys(rm_count=3).checker().symmetry(),
                       ample_set=True)
    assert not [d for d in telemetry.diff_traces(ev, again)["divergences"]
                if d["field"] == "soundness_certified"]
