"""Reduction soundness analyzer: certify symmetry specs and ample masks
before the engines trust them.

The port of the JAX package's ``analysis/soundness.py``, over aten
graphs of the port's batched ``*_cols`` device functions
(analysis/walker.py) where the JAX analyzer walks jaxprs. It
discharges the same sufficient obligations — no state-space
enumeration — and emits the same machine-readable certificate
(``SOUND_r*.json``, schema ``soundness-cert/v1``). The engines consult
it at spawn: a certified spec runs, an uncertifiable one refuses with
the failed obligation (checkers/common.soundness_refusal), and
``--unsound-ok`` / ``CheckerBuilder.unsound_ok()`` waives the refusal.

Obligations (each is one certificate record; the names are the JAX
analyzer's, and the refusal message and the tests key on them):

symmetry scope (a declared ``DeviceRewriteSpec``):
  ``group-closure``           the rewrite set is a permutation-group
                              action on the limb layout: structural
                              bounds (ops/canonical.validate_spec) and
                              per-lane bit disjointness of the fields;
  ``orbit-structure``         canonicalization is idempotent and maps
                              each row to a member permutation of
                              itself, with every field in the sort key;
  ``fingerprint-invariance``  the canonical form is invariant under
                              every generator transposition;
  ``property-invariance``     every property predicate is
                              group-invariant: a static member-uniform
                              bit-footprint check over the traced
                              ``property_conditions_cols`` and a
                              semantic P(τ·v) == P(v) battery;
  ``transition-equivariance`` multiset{τ·succ(v)} == multiset{succ(τ·v)}
                              per battery row.

ample scope (a declared ``ample_mask_host``):
  ``ample-enabledness``       whenever a dropped slot is enabled, some
                              kept slot is: enumerated over the union
                              guard-footprint cone (sampled when large);
  ``ample-non-suppression``   every dropped slot whose write footprint
                              meets a property read footprint has a
                              symmetric kept image on the battery.

The abstract domain. Port lanes hold uint32 values in int64, and the
device functions compute in int64: ``~x`` sets bits 32-63, a ``<<`` can
carry a bit past 31, and aten's ``>>`` on int64 is an ARITHMETIC shift
that copies bit 63 down. So an abstract value has 64 per-bit codes per
element (CONST0 / CONST1, "equals input bit lane*32+b", or "depends on
the mask D"), and every op is modelled with int64 semantics, narrower
integer types by truncation and sign or zero extension. A high bit that
flows back into bits 0-31 is tracked like any other. Ops that only move
elements (views, ``cat``/``stack``, scatters into a view, gathers at
constant indices) are interpreted exactly by running the op on tensors
of element ids; elementwise arithmetic and comparisons depend on the
whole element; an op with no abstract input is run on its concrete
values (so a constant slot's arithmetic folds away). Anything else —
a table gather at a state-dependent index, an unknown op — collapses
to depends-on-everything and is recorded, which can only refuse a
sound spec, never certify an unsound one. A function that cannot be
traced (a branch on a value) fails the obligation that needs it.

The semantic battery runs the encoding's batched functions, with the
port's canonicalizer (ops/canonical.py), on ``device``.
"""

from __future__ import annotations

import json
import operator
import os
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..encoding import ample_mask_host as _probe_ample
from ..encoding import device_rewrite_spec as _probe_spec
from .rules import Finding
from .walker import TraceRefused, trace_cols

#: per-bit abstract codes: >= 0 is "provably equals input bit
#: lane*32+bit"; the negatives are unknown-but-bounded.
_DEP, _CONST0, _CONST1 = -1, -2, -3

#: bits of the int64 carrier an abstract element models
_NB = 64

#: ample-enabledness cones up to this many bits enumerate
#: exhaustively (2^bits rows); larger cones fall back to sampling and
#: the certificate records method="sampled".
_EXHAUSTIVE_CONE_BITS = 12
_SAMPLE_ROWS = 2048

#: memoized certificates — the engines' spawn gates run per checker
#: construction, and the tests construct hundreds.
_CERT_CACHE: dict = {}


class _Abs:
    """One abstract array: ``codes`` int64[S + (64,)] per-bit codes,
    ``deps`` uint32[S + (64, W)] per-bit input-bit dependency masks
    (an over-approximation; CONST bits carry empty masks)."""

    __slots__ = ("codes", "deps")

    def __init__(self, codes, deps):
        self.codes = codes
        self.deps = deps


def _seed(W: int) -> _Abs:
    """The input block ``[W, 1]``: lane ``l``'s bits 0-31 are the input
    bits ``l*32 + b``, and bits 32-63 are 0 (lanes hold uint32 values)."""
    codes = np.full((W, 1, _NB), _CONST0, np.int64)
    codes[:, 0, :32] = (np.arange(W, dtype=np.int64)[:, None] * 32
                        + np.arange(32, dtype=np.int64)[None, :])
    deps = np.zeros((W, 1, _NB, W), np.uint32)
    for lane in range(W):
        deps[lane, 0, np.arange(32), lane] = (
            np.uint32(1) << np.arange(32, dtype=np.uint32))
    return _Abs(codes, deps)


_INT_BITS = {torch.bool: 1, torch.uint8: 8, torch.int8: 8, torch.int16: 16,
             torch.int32: 32, torch.int64: 64}
_SIGNED = (torch.int8, torch.int16, torch.int32, torch.int64)


def _const_abs(val, W: int) -> _Abs:
    """A concrete value (tensor or Python number) as an abstract one:
    the 64 bits of its int64 value (a bool is 0 or 1); a floating value
    is an unknown constant (DEP with no dependency)."""
    if isinstance(val, torch.Tensor):
        t = val.detach().cpu()
        if t.dtype not in _INT_BITS:
            shape = tuple(t.shape)
            return _Abs(np.full(shape + (_NB,), _DEP, np.int64),
                        np.zeros(shape + (_NB, W), np.uint32))
        v = t.to(torch.int64).numpy()
    elif isinstance(val, float):
        return _Abs(np.full((_NB,), _DEP, np.int64),
                    np.zeros((_NB, W), np.uint32))
    else:
        v = np.asarray(int(val), np.int64)
    bits = (v[..., None] >> np.arange(_NB, dtype=np.int64)) & 1
    codes = np.where(bits == 1, _CONST1, _CONST0).astype(np.int64)
    deps = np.zeros(v.shape + (_NB, W), np.uint32)
    return _Abs(codes, deps)


#: aten ops interpreted per element (the result depends on the whole
#: element, never on individual bit structure) — the JAX _ELEMWISE
_ELEMWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "floor_divide", "remainder",
    "fmod", "pow", "neg", "sign", "abs", "maximum", "minimum", "eq",
    "ne", "lt", "le", "gt", "ge", "clamp", "clamp_min",
    "clamp_max", "floor", "ceil", "round", "trunc",
})

#: reductions over dims — the JAX _REDUCE
_REDUCE = frozenset({
    "all", "any", "sum", "prod", "amax", "amin", "argmax", "argmin",
    "count_nonzero", "mean",
})

#: ops that only move elements — the JAX structural set, the writes
#: into a view that the recorder leaves, and gathers at constant
#: indices: interpreted exactly by running the op on tensors of element
#: ids; the value lists the argument positions that hold indices (which
#: must be concrete), not data
_MOVE = {
    "select": (), "slice": (), "unsqueeze": (), "squeeze": (),
    "view": (), "_unsafe_view": (), "reshape": (), "expand": (),
    "permute": (), "transpose": (), "t": (), "flip": (), "clone": (),
    "alias": (), "detach": (), "lift_fresh_copy": (), "cat": (),
    "stack": (), "select_scatter": (), "slice_scatter": (), "copy": (),
    "index_select": (2,), "gather": (2,), "index": (1,),
}

#: ops whose result does not depend on the VALUES of their first
#: argument (only its shape and dtype)
_VALUE_FREE = frozenset({
    "zeros_like", "ones_like", "full_like", "new_zeros", "new_ones",
    "new_full", "fill",
})

#: uninitialized memory: an unknown value that depends on no input
_EMPTY = frozenset({"empty", "empty_like", "new_empty", "empty_strided"})

_BITWISE = {"bitwise_and": "and", "__and__": "and",
            "bitwise_or": "or", "__or__": "or",
            "bitwise_xor": "xor", "__xor__": "xor"}
_SHIFTS = {"__lshift__": True, "bitwise_left_shift": True,
           "__rshift__": False, "bitwise_right_shift": False}


def _op_name(target) -> str:
    packet = getattr(target, "overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(target, "__name__", str(target))


def _metas(node) -> tuple:
    """``(shape, dtype)`` of each tensor output of ``node`` (its recorded
    tensor meta), and whether the node has exactly one output."""
    val = node.meta.get("val")
    if isinstance(val, (tuple, list)):
        return [(tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor)
                else None for v in val], False
    if isinstance(val, torch.Tensor):
        return [(tuple(val.shape), val.dtype)], True
    return [], False


class _BitInterp:
    """Abstract interpreter over one encoding's traced aten graphs."""

    def __init__(self, W: int):
        self.W = W
        #: aten ops we collapsed on (recorded in the certificate so
        #: "certified via over-approximation" is visible)
        self.collapsed: list = []

    # -- plumbing --------------------------------------------------------

    def lift(self, x) -> _Abs:
        return x if isinstance(x, _Abs) else _const_abs(x, self.W)

    def _bcast(self, vals, shape):
        out = []
        for v in vals:
            a = self.lift(v)
            out.append(_Abs(
                np.broadcast_to(a.codes, tuple(shape) + (_NB,)),
                np.broadcast_to(a.deps, tuple(shape) + (_NB, self.W)),
            ))
        return out

    def _elem_deps(self, a) -> np.ndarray:
        """Per-element dependency mask: OR over the 64 bit slots —
        shape S + (W,)."""
        if not isinstance(a, _Abs):
            shape = tuple(a.shape) if isinstance(a, torch.Tensor) else ()
            return np.zeros(shape + (self.W,), np.uint32)
        return np.bitwise_or.reduce(a.deps, axis=-2)

    def _all_deps(self, vals) -> np.ndarray:
        acc = np.zeros(self.W, np.uint32)
        for v in torch.utils._pytree.tree_leaves(vals):
            if isinstance(v, _Abs) and v.deps.size:
                acc |= np.bitwise_or.reduce(
                    v.deps.reshape(-1, self.W), axis=0)
        return acc

    def _dep_abs(self, shape, elem_deps, dtype=None) -> _Abs:
        """All-bits-DEP output with one dependency mask per element
        (``elem_deps`` broadcastable to S + (W,)); a bool keeps bits
        1..63 CONST0 — its value is 0 or 1."""
        shape = tuple(shape)
        codes = np.full(shape + (_NB,), _DEP, np.int64)
        ed = np.broadcast_to(elem_deps, shape + (self.W,))
        deps = np.broadcast_to(ed[..., None, :],
                               shape + (_NB, self.W)).copy()
        if dtype is torch.bool:
            codes[..., 1:] = _CONST0
            deps[..., 1:, :] = 0
        return _Abs(codes, deps)

    def _renorm(self, a: _Abs, dtype) -> _Abs:
        """``a`` as a value of ``dtype``: a bool is ``a != 0``; a
        narrower integer is truncated to its width and sign- or
        zero-extended back to 64 bits; a floating value is DEP."""
        if dtype is torch.int64:
            return a
        shape = a.codes.shape[:-1]
        if dtype not in _INT_BITS:
            return self._dep_abs(shape, self._elem_deps(a), dtype)
        codes, deps = a.codes.copy(), a.deps.copy()
        if dtype is torch.bool:
            high0 = (codes[..., 1:] == _CONST0).all(-1)
            one = (codes == _CONST1).any(-1)
            ed = self._elem_deps(a)
            codes[..., 0] = np.where(one, _CONST1,
                                     np.where(high0, codes[..., 0], _DEP))
            deps[..., 0, :] = np.where(
                one[..., None], 0,
                np.where(high0[..., None], deps[..., 0, :], ed))
            codes[..., 1:] = _CONST0
            deps[..., 1:, :] = 0
            return _Abs(codes, deps)
        n = _INT_BITS[dtype]
        if dtype in _SIGNED:
            codes[..., n:] = codes[..., n - 1:n]
            deps[..., n:, :] = deps[..., n - 1:n, :]
        else:
            codes[..., n:] = _CONST0
            deps[..., n:, :] = 0
        return _Abs(codes, deps)

    def _unknown(self, metas, single, deps=None):
        outs = [
            None if m is None else self._dep_abs(
                m[0], np.zeros(self.W, np.uint32) if deps is None else deps,
                m[1])
            for m in metas
        ]
        return outs[0] if single else tuple(outs)

    def collapse(self, node, args, kwargs):
        self.collapsed.append(_op_name(node.target))
        metas, single = _metas(node)
        return self._unknown(metas, single, self._all_deps((args, kwargs)))

    # -- evaluation ------------------------------------------------------

    def run(self, gm, args) -> Any:
        """Interpret ``gm``'s graph on ``args`` (one per placeholder,
        abstract or concrete); returns its output structure."""
        from torch.fx.node import map_arg

        env: dict = {}
        it = iter(args)
        out = None
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                env[node] = next(it)
            elif node.op == "get_attr":
                obj = gm
                for part in node.target.split("."):
                    obj = getattr(obj, part)
                env[node] = obj
            elif node.op == "output":
                out = map_arg(node.args[0], lambda n: env[n])
            else:
                a = map_arg(node.args, lambda n: env[n])
                k = map_arg(node.kwargs, lambda n: env[n])
                env[node] = self.eval_node(node, a, k)
        return out

    def eval_node(self, node, a, k) -> Any:
        target = node.target
        if target is operator.getitem:
            return a[0][a[1]]
        name = _op_name(target)
        metas, single = _metas(node)
        if name in _EMPTY:
            return self._unknown(metas, single)
        leaves = torch.utils._pytree.tree_leaves((a, k))
        if not any(isinstance(v, _Abs) for v in leaves):
            # constant folding: run the op (this is how a constant
            # slot's arithmetic folds away)
            try:
                return target(*a, **k)
            except Exception:  # noqa: BLE001
                return self.collapse(node, a, k)
        if node.op != "call_function" or not metas or any(
                m is None for m in metas):
            return self.collapse(node, a, k)
        shape, dtype = metas[0]

        if name in _BITWISE:
            return self._renorm(
                self._bitwise(_BITWISE[name], a[0], a[1], shape), dtype)
        if name == "bitwise_not":
            return self._not(a[0], dtype)
        if name in _SHIFTS:
            return self._shift(_SHIFTS[name], a[0], a[1], shape, dtype)
        if name == "where" and len(a) == 3:
            return self._select(a[0], a[1], a[2], shape, dtype)
        if name in _ELEMWISE and single:
            ed = np.zeros(shape + (self.W,), np.uint32)
            for v in leaves:
                if isinstance(v, _Abs):
                    ed = ed | np.broadcast_to(self._elem_deps(v),
                                              shape + (self.W,))
            return self._dep_abs(shape, ed, dtype)
        if name in _REDUCE:
            return self._reduce(a, k, metas, single)
        if name == "_to_copy":
            return self._renorm(self.lift(a[0]), dtype)
        if name in _VALUE_FREE:
            return self._value_free(node, a, k)
        if name in _MOVE:
            return self._move(node, name, a, k, metas, single)
        return self.collapse(node, a, k)

    def _bitwise(self, name, a, b, shape) -> _Abs:
        a, b = self._bcast([a, b], shape)
        ca, cb, da, db = a.codes, b.codes, a.deps, b.deps
        both = da | db
        if name == "and":
            zero = (ca == _CONST0) | (cb == _CONST0)
            codes = np.where(
                zero, _CONST0,
                np.where(cb == _CONST1, ca,
                         np.where(ca == _CONST1, cb,
                                  np.where((ca == cb) & (ca >= 0),
                                           ca, _DEP))))
            deps = np.where(
                zero[..., None], 0,
                np.where((cb == _CONST1)[..., None], da,
                         np.where((ca == _CONST1)[..., None], db,
                                  np.where(((ca == cb)
                                            & (ca >= 0))[..., None],
                                           da, both))))
        elif name == "or":
            one = (ca == _CONST1) | (cb == _CONST1)
            codes = np.where(
                one, _CONST1,
                np.where(cb == _CONST0, ca,
                         np.where(ca == _CONST0, cb,
                                  np.where((ca == cb) & (ca >= 0),
                                           ca, _DEP))))
            deps = np.where(
                one[..., None], 0,
                np.where((cb == _CONST0)[..., None], da,
                         np.where((ca == _CONST0)[..., None], db,
                                  np.where(((ca == cb)
                                            & (ca >= 0))[..., None],
                                           da, both))))
        else:  # xor
            same_id = (ca == cb) & (ca >= 0)
            both_const = ((ca == _CONST0) | (ca == _CONST1)) & (
                (cb == _CONST0) | (cb == _CONST1)
            )
            codes = np.where(
                same_id, _CONST0,
                np.where(both_const,
                         np.where(ca == cb, _CONST0, _CONST1),
                         np.where(cb == _CONST0, ca,
                                  np.where(ca == _CONST0, cb,
                                           _DEP))))
            deps = np.where(
                (same_id | both_const)[..., None], 0,
                np.where((cb == _CONST0)[..., None], da,
                         np.where((ca == _CONST0)[..., None], db,
                                  both)))
        return _Abs(codes.astype(np.int64), deps.astype(np.uint32))

    def _not(self, a, dtype) -> _Abs:
        """``bitwise_not``: all 64 bits of an integer flip (a uint32
        lane's bits 32-63 become 1); a bool flips bit 0 only."""
        a = self.lift(a)
        flip = (slice(None),) * (a.codes.ndim - 1) + (
            slice(0, 1) if dtype is torch.bool else slice(None),)
        codes, deps = a.codes.copy(), a.deps.copy()
        c = codes[flip]
        codes[flip] = np.where(c == _CONST0, _CONST1,
                               np.where(c == _CONST1, _CONST0, _DEP))
        deps[flip] = np.where((codes[flip] == _DEP)[..., None],
                              deps[flip], 0)
        return self._renorm(_Abs(codes, deps), dtype)

    def _shift(self, left, a, s, shape, dtype) -> _Abs:
        """``a << s`` / ``a >> s`` in int64 (aten's right shift of a
        signed value is arithmetic: bit 63 fills from the top), at
        concrete per-element amounts; an abstract amount, or one outside
        ``[0, bits)``, is DEP over the element."""
        ed = (np.broadcast_to(self._elem_deps(a), shape + (self.W,))
              | np.broadcast_to(self._elem_deps(s), shape + (self.W,)))
        if isinstance(s, _Abs):
            return self._dep_abs(shape, ed, dtype)
        (a,) = self._bcast([a], shape)
        amt = np.broadcast_to(
            np.asarray(s.cpu() if isinstance(s, torch.Tensor) else s)
            .astype(np.int64), shape)
        width = _INT_BITS.get(dtype, 0)
        out = self._dep_abs(shape, ed, dtype)
        codes, deps = out.codes, out.deps
        for v in np.unique(amt):
            v = int(v)
            if not 0 <= v < width:
                continue
            m = amt == v
            c = np.full(a.codes.shape, _CONST0, np.int64)
            d = np.zeros(a.deps.shape, np.uint32)
            if left:
                c[..., v:] = a.codes[..., :_NB - v]
                d[..., v:, :] = a.deps[..., :_NB - v, :]
            else:
                c[..., :_NB - v] = a.codes[..., v:]
                d[..., :_NB - v, :] = a.deps[..., v:, :]
                c[..., _NB - v:] = a.codes[..., _NB - 1:]
                d[..., _NB - v:, :] = a.deps[..., _NB - 1:, :]
            codes[m] = c[m]
            deps[m] = d[m]
        return self._renorm(_Abs(codes, deps), dtype)

    def _select(self, pred, x, y, shape, dtype) -> _Abs:
        """``where(pred, x, y)``: a concrete predicate picks per
        element; an abstract one joins the cases — bits whose codes
        agree keep them, the others go DEP with the predicate's
        dependency."""
        xa, ya = self._bcast([x, y], shape)
        if not isinstance(pred, _Abs):
            p = torch.as_tensor(pred).cpu().to(torch.bool).numpy()
            p = np.broadcast_to(p, shape)
            codes = np.where(p[..., None], xa.codes, ya.codes)
            deps = np.where(p[..., None, None], xa.deps, ya.deps)
            return self._renorm(_Abs(codes, deps), dtype)
        pd = np.broadcast_to(self._elem_deps(pred), shape + (self.W,))
        same = xa.codes == ya.codes
        codes = np.where(same, xa.codes, _DEP)
        deps = xa.deps | ya.deps
        deps = np.where((codes == _DEP)[..., None],
                        deps | pd[..., None, :], deps)
        deps[(codes == _CONST0) | (codes == _CONST1)] = 0
        return self._renorm(_Abs(codes.astype(np.int64),
                                 deps.astype(np.uint32)), dtype)

    def _reduce(self, a, k, metas, single):
        x = a[0]
        ed = self._elem_deps(x)
        nd = ed.ndim - 1
        dims = a[1] if len(a) > 1 else k.get("dim")
        keep = (a[2] if len(a) > 2 and isinstance(a[2], bool)
                else bool(k.get("keepdim", False)))
        if dims is None or (isinstance(dims, (list, tuple)) and not dims):
            axes = tuple(range(nd))
        elif isinstance(dims, int):
            axes = (dims % nd,) if nd else ()
        else:
            axes = tuple(int(d) % nd for d in dims)
        r = np.bitwise_or.reduce(ed, axis=axes, keepdims=keep) if axes \
            else ed
        outs = []
        for shape, dtype in metas:
            n = int(np.prod(shape, dtype=np.int64))
            if r.size == n * self.W:
                e = r.reshape(shape + (self.W,))
            else:
                e = np.broadcast_to(
                    np.bitwise_or.reduce(ed.reshape(-1, self.W), axis=0),
                    shape + (self.W,))
            outs.append(self._dep_abs(shape, e, dtype))
        return outs[0] if single else tuple(outs)

    def _value_free(self, node, a, k):
        """``zeros_like(x)`` and the like: only ``x``'s shape and dtype
        matter, so ``x`` is replaced by zeros; any other abstract
        argument (a fill value) collapses."""
        first = a[0]
        rest = torch.utils._pytree.tree_leaves((a[1:], k))
        if any(isinstance(v, _Abs) for v in rest):
            return self.collapse(node, a, k)
        src = node.args[0].meta.get("val")
        zeros = torch.zeros(tuple(src.shape), dtype=src.dtype) \
            if isinstance(first, _Abs) else first
        try:
            return node.target(zeros, *a[1:], **k)
        except Exception:  # noqa: BLE001
            return self.collapse(node, a, k)

    def _move(self, node, name, a, k, metas, single):
        """An op that only moves elements, run on tensors of element
        ids: each output element is the input element its id names."""
        index_pos = _MOVE[name]
        for i in index_pos:
            if i < len(a) and any(isinstance(v, _Abs) for v in
                                  torch.utils._pytree.tree_leaves(a[i])):
                return self.collapse(node, a, k)
        codes, deps = [], []
        count = [0]

        def ids(v):
            if not isinstance(v, (_Abs, torch.Tensor)):
                return v
            ab = self.lift(v)
            n = ab.codes.size // _NB
            codes.append(ab.codes.reshape(n, _NB))
            deps.append(ab.deps.reshape(n, _NB, self.W))
            out = torch.arange(count[0], count[0] + n,
                               dtype=torch.int64).reshape(
                                   ab.codes.shape[:-1])
            count[0] += n
            return out

        new_a = [v if i in index_pos
                 else torch.utils._pytree.tree_map(ids, v)
                 for i, v in enumerate(a)]
        try:
            res = node.target(*new_a, **k)
        except Exception:  # noqa: BLE001
            return self.collapse(node, a, k)
        table_c = np.concatenate(codes) if codes else np.zeros(
            (0, _NB), np.int64)
        table_d = np.concatenate(deps) if deps else np.zeros(
            (0, _NB, self.W), np.uint32)
        res = [res] if single else list(res)
        outs = []
        for r, (shape, dtype) in zip(res, metas):
            idx = r.numpy()
            outs.append(self._renorm(_Abs(table_c[idx], table_d[idx]),
                                     dtype))
        return outs[0] if single else tuple(outs)


# -- footprint extraction ---------------------------------------------------

def _abs_eval(enc, fn, *concrete):
    """Trace ``fn`` (analysis/walker.py), then abstract-interpret its
    graph from the input-bit seed, with ``concrete`` tensors for any
    further inputs. Returns ``(outputs, interp, graph)``; raises
    :class:`~.walker.TraceRefused` when ``fn`` cannot be traced."""
    gm = trace_cols(fn, enc.width, *concrete)
    interp = _BitInterp(enc.width)
    out = interp.run(gm, [_seed(enc.width), *concrete])
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    return outs, interp, gm


def guard_footprints(enc) -> tuple:
    """Per-slot guard read-footprints (uint32[W] masks) from the
    packed ``enabled_bits_cols`` words, plus the interpreter (for its
    collapse record)."""
    outs, interp, gm = _abs_eval(enc, enc.enabled_bits_cols)
    words = outs[0]
    W, K = enc.width, enc.max_actions
    fps = []
    for k in range(K):
        if isinstance(words, _Abs):
            fps.append(np.bitwise_or.reduce(
                words.deps[..., k // 32, k % 32, :].reshape(-1, W),
                axis=0).astype(np.uint32))
        else:
            fps.append(np.zeros(W, np.uint32))
    return fps, interp, gm


def property_footprints(enc) -> tuple:
    """Per-property read-footprints over
    ``property_conditions_cols``."""
    outs, interp, gm = _abs_eval(enc, enc.property_conditions_cols)
    props = outs[0]
    names = [p.name for p in enc.host_model.properties()]
    fps = []
    for p in range(len(names)):
        if isinstance(props, _Abs):
            fps.append(np.bitwise_or.reduce(
                props.deps[..., p, :, :].reshape(-1, enc.width), axis=0))
        else:
            fps.append(np.zeros(enc.width, np.uint32))
    return names, fps, interp, gm


def _step_slot_graph(enc):
    """``step_slot_cols`` traced once with the slot block as a second
    input; :func:`step_slot_footprints` interprets it at a concrete
    slot, so the slot arithmetic folds as if the slot were a constant
    of the trace."""
    return trace_cols(lambda s, k: enc.step_slot_cols(s, k), enc.width,
                      torch.zeros(1, dtype=torch.int64))


def step_slot_footprints(enc, slot: int, graph=None) -> tuple:
    """``(write_mask, read_mask)`` uint32[W] for one concrete slot:
    bits the transition may CHANGE (abstract code differs from the
    identity) and bits it may READ. A successor bit above 31 that is
    not provably 0 counts as a write of its whole lane."""
    gm = _step_slot_graph(enc) if graph is None else graph
    interp = _BitInterp(enc.width)
    out = interp.run(gm, [_seed(enc.width),
                          torch.full((1,), slot, dtype=torch.int64)])
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    succ = outs[0]
    W = enc.width
    write = np.zeros(W, np.uint32)
    read = np.zeros(W, np.uint32)
    ident = _seed(W).codes[:, 0]
    if isinstance(succ, _Abs):
        codes = succ.codes.reshape(W, _NB)
        changed = codes != ident
        shifts = np.arange(32, dtype=np.uint64)
        for lane in range(W):
            if changed[lane, 32:].any():
                write[lane] = np.uint32(0xFFFFFFFF)
            else:
                write[lane] = np.uint32(
                    (changed[lane, :32].astype(np.uint64) << shifts).sum()
                    & 0xFFFFFFFF)
        read = np.bitwise_or.reduce(succ.deps.reshape(-1, W), axis=0)
    else:
        # a constant successor: unknowable statically — treat all
        # bits written
        write[:] = np.uint32(0xFFFFFFFF)
    for extra in outs[1:]:
        if isinstance(extra, _Abs):
            read = read | np.bitwise_or.reduce(
                extra.deps.reshape(-1, W), axis=0)
    return write, read


# -- permutations -----------------------------------------------------------

def apply_member_permutation(spec, rows, perm) -> np.ndarray:
    """Relabel members of encoded rows: output member ``p`` takes
    input member ``perm[p]``'s field values; non-group bits pass
    through. Pure numpy, any leading batch shape."""
    rows = np.asarray(rows, np.uint32)
    out = rows.copy()
    R = spec.n_members
    for f in spec.fields:
        fm = (1 << f.width) - 1
        fieldmask = 0
        for m in range(R):
            fieldmask |= fm << (f.shift + m * f.stride)
        lane = rows[..., f.lane]
        acc = out[..., f.lane] & np.uint32(~fieldmask & 0xFFFFFFFF)
        for p in range(R):
            src = perm[p]
            v = (lane >> np.uint32(f.shift + src * f.stride)) \
                & np.uint32(fm)
            acc = acc | (v << np.uint32(f.shift + p * f.stride))
        out[..., f.lane] = acc
    return out


def permute_mask(spec, mask, perm) -> np.ndarray:
    """Relabel a uint32[W] bit-mask the same way a state row would
    be (footprints live in the state's bit layout)."""
    return apply_member_permutation(
        spec, np.asarray(mask, np.uint32)[None, :], perm
    )[0]


def _transpositions(R: int) -> list:
    perms = []
    for a in range(R):
        for b in range(a + 1, R):
            p = list(range(R))
            p[a], p[b] = p[b], p[a]
            perms.append(tuple(p))
    return perms


def _generators(R: int) -> list:
    """Adjacent transpositions — they generate S_R, and invariance
    under generators composes to the whole group."""
    gens = []
    for a in range(R - 1):
        p = list(range(R))
        p[a], p[a + 1] = p[a + 1], p[a]
        gens.append(tuple(p))
    return gens


def _member_tuples(spec, row) -> list:
    out = []
    for m in range(spec.n_members):
        t = []
        for f in spec.fields:
            fm = (1 << f.width) - 1
            t.append(
                (int(row[f.lane]) >> (f.shift + m * f.stride)) & fm
            )
        out.append(tuple(t))
    return out


def _group_mask(spec, W: int) -> np.ndarray:
    gm = np.zeros(W, np.uint32)
    for f in spec.fields:
        fm = (1 << f.width) - 1
        for m in range(spec.n_members):
            gm[f.lane] |= np.uint32(
                fm << (f.shift + m * f.stride)
            )
    return gm


# -- the battery ------------------------------------------------------------

def battery_rows(enc, spec, extra_masks=()) -> np.ndarray:
    """Deterministic semantic-check battery: zeros, single-bit rows
    for every group-field and footprint bit, distinct-value member
    sweeps, and fixed-seed pseudorandom rows. Semantic obligations
    hold on EVERY uint32 state (the encodings are branchless total
    functions), so unreachable rows only make the check stronger."""
    W = enc.width
    rows = [np.zeros(W, np.uint32)]
    bits = set()
    if spec is not None:
        for f in spec.fields:
            for m in range(spec.n_members):
                for b in range(f.width):
                    bits.add((f.lane, f.shift + m * f.stride + b))
    for mask in extra_masks:
        for lane in range(W):
            mm = int(mask[lane])
            for j in range(32):
                if (mm >> j) & 1:
                    bits.add((lane, j))
    for lane, b in sorted(bits):
        r = np.zeros(W, np.uint32)
        r[lane] = np.uint32(1) << np.uint32(b)
        rows.append(r)
    if spec is not None:
        for salt in (1, 2):
            r = np.zeros(W, np.uint32)
            for f in spec.fields:
                fm = (1 << f.width) - 1
                for m in range(spec.n_members):
                    v = (m * salt + salt) & fm
                    r[f.lane] |= np.uint32(
                        v << (f.shift + m * f.stride)
                    )
            rows.append(r)
    rng = np.random.default_rng(0xC0FFEE)
    rows.extend(list(
        rng.integers(0, 1 << 32, size=(24, W), dtype=np.uint64)
        .astype(np.uint32)
    ))
    uniq, seen = [], set()
    for r in rows:
        key = tuple(int(x) for x in r)
        if key not in seen:
            seen.add(key)
            uniq.append(r)
    return np.stack(uniq)


def _cols(rows, device) -> torch.Tensor:
    """uint32 ``[N, W]`` rows as the lane-major int64 ``[W, N]`` block
    the device functions take."""
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(rows, np.uint32).astype(np.int64).T)
    ).to(device)


def _canon(spec, rows, device) -> np.ndarray:
    from ..ops.canonical import canonicalize_rows

    t = torch.from_numpy(np.asarray(rows, np.uint32).astype(np.int64))
    return canonicalize_rows(spec, t.to(device)).cpu().numpy().astype(
        np.uint32)


def _props(enc, rows, device) -> np.ndarray:
    return enc.property_conditions_cols(_cols(rows, device)).cpu().numpy()


# -- obligation checks ------------------------------------------------------

def _finding(enc_name, rule, ok, message, source=None, **data) -> Finding:
    return Finding(
        rule=rule,
        severity="info" if ok else "error",
        encoding=enc_name,
        path="soundness",
        message=message,
        source=source,
        data=data,
    )


def _untraceable(name, rule, fn_name, refused, scope) -> Finding:
    """The obligation a device function that cannot be traced fails."""
    return _finding(
        name, rule, False,
        f"{fn_name} cannot be traced to a fixed graph ({refused}) — "
        "data-dependent control flow or shapes, so its bit footprint "
        "cannot be stated, let alone proven",
        source=refused.source, scope=scope, function=fn_name,
    )


def _enc_name(enc) -> str:
    key = getattr(enc, "cache_key", None)
    suffix = f"({key()})" if callable(key) else ""
    return type(enc).__qualname__ + suffix


def _check_group_closure(name, enc, spec) -> Finding:
    from ..ops.canonical import validate_spec

    try:
        validate_spec(spec, width=enc.width)
    except ValueError as e:
        return _finding(
            name, "group-closure", False,
            f"structural validation failed: {e}",
            scope="symmetry",
        )
    # cross-field bit disjointness per lane: overlapping fields make
    # the member relabeling non-bijective (two fields write one bit),
    # so the rewrite set is not a group action on the layout.
    R = spec.n_members
    for lane in sorted({f.lane for f in spec.fields}):
        occupied = 0
        for fi, f in enumerate(spec.fields):
            if f.lane != lane:
                continue
            fmask = 0
            fm = (1 << f.width) - 1
            for m in range(R):
                fmask |= fm << (f.shift + m * f.stride)
            if occupied & fmask:
                return _finding(
                    name, "group-closure", False,
                    f"fields overlap on lane {lane} (field {fi}: "
                    f"shift={f.shift} stride={f.stride} "
                    f"width={f.width} collides with an earlier "
                    "field's member bits) — the member relabeling "
                    "is not a bijection, so the rewrite set is not "
                    "a permutation-group action on the limb layout",
                    scope="symmetry", lane=lane,
                )
            occupied |= fmask
    return _finding(
        name, "group-closure", True,
        f"permutation-group action over {R} members proven: "
        "structural bounds hold and all member fields are pairwise "
        "bit-disjoint (bijective relabeling)",
        scope="symmetry",
    )


def _check_orbit_structure(name, enc, spec, rows, device) -> Finding:
    non_keys = [i for i, f in enumerate(spec.fields)
                if not f.sort_key]
    if non_keys:
        return _finding(
            name, "orbit-structure", False,
            f"fields {non_keys} are not in the sort key — a partial "
            "key is not constant on orbits, so the visited count "
            "becomes search-order-dependent (symmetry.py); declare "
            "the FULL per-member tuple as the key",
            scope="symmetry",
        )
    canon = _canon(spec, rows, device)
    again = _canon(spec, canon, device)
    if not np.array_equal(canon, again):
        bad = int(np.nonzero(
            (canon != again).any(axis=-1)
        )[0][0])
        return _finding(
            name, "orbit-structure", False,
            "canonicalization is not idempotent (battery row "
            f"{bad}: canon(canon(v)) != canon(v)) — the orbit map "
            "has no well-defined representatives",
            scope="symmetry", row=bad,
        )
    gm = _group_mask(spec, enc.width)
    for i in range(rows.shape[0]):
        if not np.array_equal(rows[i] & ~gm, canon[i] & ~gm):
            return _finding(
                name, "orbit-structure", False,
                f"canonicalization changed non-group bits on "
                f"battery row {i} — the rewrite leaks outside the "
                "declared member fields",
                scope="symmetry", row=i,
            )
        if sorted(_member_tuples(spec, rows[i])) != sorted(
            _member_tuples(spec, canon[i])
        ):
            return _finding(
                name, "orbit-structure", False,
                f"canonical form of battery row {i} is not a member "
                "permutation of the row (member-tuple multiset "
                "changed) — orbits are malformed over the declared "
                "field table",
                scope="symmetry", row=i,
            )
    return _finding(
        name, "orbit-structure", True,
        "well-formed orbit structure proven on the battery: full "
        "sort key, idempotent canonicalization, member-tuple "
        "multiset preserved, non-group bits untouched",
        scope="symmetry", battery_rows=int(rows.shape[0]),
    )


def _check_fingerprint_invariance(name, enc, spec, rows,
                                  device) -> Finding:
    base = _canon(spec, rows, device)
    for g in _generators(spec.n_members):
        permuted = _canon(
            spec, apply_member_permutation(spec, rows, g), device
        )
        if not np.array_equal(base, permuted):
            bad = int(np.nonzero(
                (base != permuted).any(axis=-1)
            )[0][0])
            return _finding(
                name, "fingerprint-invariance", False,
                f"canonical form (the fingerprint field-selection) "
                f"is NOT invariant under member transposition "
                f"{g} (battery row {bad}) — two states of one orbit "
                "fingerprint differently and the visited set "
                "under-merges",
                scope="symmetry", generator=list(g), row=bad,
            )
    return _finding(
        name, "fingerprint-invariance", True,
        "canonical form invariant under every generator "
        "transposition — orbit members share one fingerprint",
        scope="symmetry",
    )


def _check_property_invariance(name, enc, spec, rows,
                               prop_names, prop_fps, device) -> Finding:
    # static: each property's read footprint must be member-uniform
    # over every spec field — reading member 0's sub-field without
    # the others' is the asymmetric-predicate defect.
    for p, fp in zip(prop_names, prop_fps):
        for fi, f in enumerate(spec.fields):
            fm = (1 << f.width) - 1
            subs = [
                (int(fp[f.lane]) >> (f.shift + m * f.stride)) & fm
                for m in range(spec.n_members)
            ]
            if len(set(subs)) > 1:
                readers = [m for m, s in enumerate(subs) if s]
                return _finding(
                    name, "property-invariance", False,
                    f"property {p!r} reads member field {fi} "
                    f"asymmetrically (members {readers} of "
                    f"{spec.n_members} in its bit footprint) — the "
                    "predicate is not group-invariant, so quotient "
                    "counts would silently drop its witnesses",
                    scope="symmetry", property=p, field=fi,
                    members=readers,
                )
    # semantic: P(tau . v) == P(v) on the battery
    ref = _props(enc, rows, device)
    for g in _generators(spec.n_members):
        got = _props(enc, apply_member_permutation(spec, rows, g),
                     device)
        if not np.array_equal(ref, got):
            bad = np.nonzero((ref != got).any(axis=-1))[0]
            pidx = int(np.nonzero(
                (ref[bad[0]] != got[bad[0]])
            )[0][0])
            return _finding(
                name, "property-invariance", False,
                f"property {prop_names[pidx]!r} changes truth "
                f"value under member transposition {g} (battery "
                f"row {int(bad[0])}) — not group-invariant",
                scope="symmetry", property=prop_names[pidx],
                generator=list(g),
            )
    return _finding(
        name, "property-invariance", True,
        f"all {len(prop_names)} properties group-invariant: "
        "member-uniform static footprints and semantic agreement "
        "under every generator",
        scope="symmetry", properties=list(prop_names),
    )


def _step_all(enc, rows, device):
    """``(succs [N, K, W], valids bool[N, K])``: the dense ``step_cols``
    of every row."""
    succ, valid = enc.step_cols(_cols(rows, device))[:2]
    return (succ.permute(1, 2, 0).cpu().numpy().astype(np.uint32),
            valid.cpu().numpy().astype(bool))


def _check_transition_equivariance(name, enc, spec, rows,
                                   device) -> Finding:
    succs, valids = _step_all(enc, rows, device)
    for g in _generators(spec.n_members):
        prows = apply_member_permutation(spec, rows, g)
        psuccs, pvalids = _step_all(enc, prows, device)
        for i in range(rows.shape[0]):
            a = apply_member_permutation(
                spec, succs[i][valids[i]], g
            )
            b = psuccs[i][pvalids[i]]
            a_sorted = sorted(map(tuple, a.tolist()))
            b_sorted = sorted(map(tuple, b.tolist()))
            if a_sorted != b_sorted:
                return _finding(
                    name, "transition-equivariance", False,
                    f"successor set does not commute with member "
                    f"transposition {g} on battery row {i}: "
                    "tau(succ(v)) != succ(tau(v)) as multisets — "
                    "the quotient graph is not the graph of the "
                    "quotient",
                    scope="symmetry", generator=list(g), row=i,
                )
    return _finding(
        name, "transition-equivariance", True,
        "successor sets commute with every generator transposition "
        "on the battery",
        scope="symmetry", battery_rows=int(rows.shape[0]),
    )


def _mask_bits(mask) -> list:
    out = []
    for lane in range(len(mask)):
        mm = int(mask[lane])
        for j in range(32):
            if (mm >> j) & 1:
                out.append((lane, j))
    return out


def _guard_values(enc, rows, slots, device) -> np.ndarray:
    """bool[rows, slots] — the packed guard words evaluated on each
    row, extracted at the listed slots."""
    words = enc.enabled_bits_cols(_cols(rows, device)).cpu().numpy()
    out = np.zeros((rows.shape[0], len(slots)), bool)
    for i, s in enumerate(slots):
        out[:, i] = (words[:, s // 32] >> (s % 32)) & 1
    return out


def _cone_rows(enc, cone_bits, rng) -> tuple:
    """Assignment rows over a footprint cone: exhaustive when small
    (the guards provably depend on no other bits, so one zero
    background decides the implication), sampled otherwise."""
    W = enc.width
    if len(cone_bits) <= _EXHAUSTIVE_CONE_BITS:
        n = 1 << len(cone_bits)
        rows = np.zeros((n, W), np.uint32)
        for i in range(n):
            for j, (lane, b) in enumerate(cone_bits):
                if (i >> j) & 1:
                    rows[i, lane] |= np.uint32(1) << np.uint32(b)
        return rows, "exhaustive"
    rows = np.zeros((_SAMPLE_ROWS, W), np.uint32)
    picks = rng.integers(
        0, 2, size=(_SAMPLE_ROWS, len(cone_bits)), dtype=np.uint64
    )
    for j, (lane, b) in enumerate(cone_bits):
        rows[:, lane] |= (
            picks[:, j].astype(np.uint32) << np.uint32(b)
        )
    return rows, "sampled"


def _check_ample_enabledness(name, enc, mask_words,
                             guard_fps, device) -> Finding:
    K = enc.max_actions
    dropped = [
        k for k in range(K)
        if not (int(mask_words[k // 32]) >> (k % 32)) & 1
    ]
    kept = [
        k for k in range(K)
        if (int(mask_words[k // 32]) >> (k % 32)) & 1
    ]
    rng = np.random.default_rng(0xA3B1E)
    methods = set()
    for d in dropped:
        fpd = guard_fps[d]
        # candidates ordered by guard-footprint overlap with the
        # dropped slot (identical footprints first: 2pc's
        # rm_prepare shares choose_abort's guard exactly)
        ranked = sorted(
            kept,
            key=lambda k: (
                not np.array_equal(guard_fps[k], fpd),
                -int(sum(
                    bin(int(guard_fps[k][w] & fpd[w])).count("1")
                    for w in range(enc.width)
                )),
                k,
            ),
        )
        proven = False
        for k in ranked[:8]:
            cone = _mask_bits(fpd | guard_fps[k])
            rows, method = _cone_rows(enc, cone, rng)
            g = _guard_values(enc, rows, [d, k], device)
            if not np.any(g[:, 0] & ~g[:, 1]):
                methods.add(method)
                proven = True
                break
        if not proven:
            return _finding(
                name, "ample-enabledness", False,
                f"dropped slot {d} can be enabled while NO kept "
                "slot implied by its guard is (no kept slot k with "
                "g_d => g_k over the guard footprint cone) — the "
                "filtered search can stall in a state the full "
                "search would leave (enabledness preservation "
                "fails)",
                scope="ample", slot=d,
            )
    return _finding(
        name, "ample-enabledness", True,
        f"enabledness preserved: each of the {len(dropped)} "
        "dropped slots implies a kept slot's guard over its "
        "footprint cone",
        scope="ample", dropped=dropped,
        method=sorted(methods) or ["exhaustive"],
    )


def _step_slot_batch(enc, rows, slot: int, device) -> np.ndarray:
    states = _cols(rows, device)
    slots = torch.full((rows.shape[0],), slot, dtype=torch.int64,
                       device=states.device)
    succ = enc.step_slot_cols(states, slots)[0]
    return succ.T.cpu().numpy().astype(np.uint32)


def _check_ample_non_suppression(name, enc, spec, mask_words,
                                 guard_fps, prop_fps,
                                 rows, device) -> Finding:
    K = enc.max_actions
    dropped = [
        k for k in range(K)
        if not (int(mask_words[k // 32]) >> (k % 32)) & 1
    ]
    kept = [
        k for k in range(K)
        if (int(mask_words[k // 32]) >> (k % 32)) & 1
    ]
    prop_read = np.zeros(enc.width, np.uint32)
    for fp in prop_fps:
        prop_read |= fp
    perms = [tuple(range(spec.n_members))] + _transpositions(
        spec.n_members
    ) if spec is not None else [()]
    write_fps: dict = {}
    try:
        graph = _step_slot_graph(enc)
    except TraceRefused as e:
        return _untraceable(name, "ample-non-suppression",
                            "step_slot_cols", e, "ample")

    def wfp(slot):
        if slot not in write_fps:
            write_fps[slot] = step_slot_footprints(enc, slot, graph)[0]
        return write_fps[slot]

    guards_b = _guard_values(enc, rows, list(range(K)), device)
    relevant = [
        d for d in dropped if np.any(wfp(d) & prop_read)
    ]
    for d in relevant:
        ok = False
        ranked = sorted(
            kept,
            key=lambda k: (
                not np.array_equal(guard_fps[k], guard_fps[d]), k
            ),
        )
        succ_d = None
        for k in ranked:
            for pi in perms:
                if spec is not None and not np.array_equal(
                    permute_mask(spec, wfp(k), pi), wfp(d)
                ):
                    continue
                if spec is None and not np.array_equal(
                    wfp(k), wfp(d)
                ):
                    continue
                prows = (
                    apply_member_permutation(spec, rows, pi)
                    if spec is not None else rows
                )
                g_k = _guard_values(enc, prows, [k], device)[:, 0]
                if not np.array_equal(guards_b[:, d], g_k):
                    continue
                en = np.nonzero(guards_b[:, d])[0]
                if en.size == 0:
                    ok = True
                    break
                if succ_d is None:
                    succ_d = _step_slot_batch(enc, rows[en], d, device)
                succ_k = _step_slot_batch(enc, prows[en], k, device)
                mapped = (
                    apply_member_permutation(spec, succ_k, pi)
                    if spec is not None else succ_k
                )
                if np.array_equal(succ_d, mapped):
                    ok = True
                    break
            if ok:
                break
        if not ok:
            return _finding(
                name, "ample-non-suppression", False,
                f"dropped slot {d} is property-relevant (its write "
                "footprint meets a property read footprint) and has "
                "NO symmetric kept image — no kept slot k and group "
                "element pi with g_d(v) == g_k(pi.v) and succ_d(v) "
                "== pi.succ_k(pi.v) on the battery — the mask "
                "suppresses an enabled property-relevant transition",
                scope="ample", slot=d,
            )
    return _finding(
        name, "ample-non-suppression", True,
        f"{len(relevant)} property-relevant dropped slots each have "
        "a symmetric kept image (guard and successor agree under a "
        "group element on the battery)",
        scope="ample", relevant=relevant, dropped=dropped,
    )


# -- certification ----------------------------------------------------------

@dataclass
class SoundnessResult:
    """The certificate for one encoding's declared reductions."""

    encoding: str
    #: None when the encoding declares no DeviceRewriteSpec
    sym_certified: Optional[bool]
    #: None when the encoding declares no ample mask
    ample_certified: Optional[bool]
    obligations: list = field(default_factory=list)
    #: aten ops the abstract interpreter over-approximated
    collapsed: list = field(default_factory=list)
    analyzer_sec: float = 0.0

    @property
    def certified(self) -> bool:
        return (self.sym_certified is not False
                and self.ample_certified is not False)

    def failed(self, scope: Optional[str] = None):
        """The first failed obligation Finding (optionally within one
        scope), or None."""
        for f in self.obligations:
            if f.severity != "error":
                continue
            if scope is None or f.data.get("scope") == scope:
                return f
        return None

    def as_dict(self) -> dict:
        return dict(
            encoding=self.encoding,
            status="certified" if self.certified else "refused",
            symmetry=self.sym_certified,
            ample=self.ample_certified,
            analyzer_sec=round(self.analyzer_sec, 4),
            collapsed_primitives=sorted(set(self.collapsed)),
            obligations=[f.as_dict() for f in self.obligations],
        )


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the analyzer's battery runs on the GPU "
            "unless device='cpu' is passed"
        )
    return device


def _cache_key(enc, spec, mask) -> tuple:
    cls = type(enc)
    ck = getattr(enc, "cache_key", None)
    return (
        cls.__module__, cls.__qualname__,
        ck() if callable(ck) else (enc.width, enc.max_actions),
        repr(spec), None if mask is None else tuple(int(w) for w in mask),
    )


def certify_encoding(enc, use_cache: bool = True,
                     device="cuda") -> SoundnessResult:
    """Run every applicable obligation over one encoding, the battery
    on ``device`` (the card unless ``"cpu"`` is passed). Memoized on the
    encoding class, its ``cache_key()`` and the declared spec and mask
    (the engines' spawn gates run per checker construction; a
    certificate does not depend on the device it was computed on);
    pass ``use_cache=False`` to re-measure ``analyzer_sec``."""
    try:
        spec = _probe_spec(enc)
        spec_error = None
    except ValueError as e:
        spec, spec_error = None, e
    mask = _probe_ample(enc)
    key = _cache_key(enc, spec, mask)
    if use_cache and key in _CERT_CACHE:
        return _CERT_CACHE[key]
    device = _resolve_device(device)
    t0 = time.perf_counter()
    name = _enc_name(enc)
    obligations: list = []
    collapsed: list = []

    def props():
        try:
            pnames, pfps, pinterp, _ = property_footprints(enc)
        except TraceRefused as e:
            return None, e
        collapsed.extend(pinterp.collapsed)
        return (pnames, pfps), None

    sym_certified: Optional[bool] = None
    if spec_error is not None:
        obligations.append(_finding(
            name, "group-closure", False,
            f"structural validation failed: {spec_error}",
            scope="symmetry",
        ))
        sym_certified = False
    elif spec is not None:
        f = _check_group_closure(name, enc, spec)
        obligations.append(f)
        if f.severity == "error":
            sym_certified = False
        else:
            pr, refused = props()
            rows = battery_rows(enc, spec, pr[1] if pr else ())
            checks = [
                _check_orbit_structure(name, enc, spec, rows, device),
                _check_fingerprint_invariance(
                    name, enc, spec, rows, device
                ),
                _check_property_invariance(
                    name, enc, spec, rows, pr[0], pr[1], device
                ) if pr else _untraceable(
                    name, "property-invariance",
                    "property_conditions_cols", refused, "symmetry"),
                _check_transition_equivariance(
                    name, enc, spec, rows, device
                ),
            ]
            obligations += checks
            sym_certified = all(
                c.severity != "error" for c in checks
            )

    ample_certified: Optional[bool] = None
    if mask is not None:
        if not hasattr(enc, "enabled_bits_cols") or not hasattr(
            enc, "step_slot_cols"
        ):
            obligations.append(_finding(
                name, "ample-enabledness", False,
                "ample mask declared but the encoding has no sparse "
                "dispatch path (enabled_bits_cols/step_slot_cols) — "
                "the guard obligations cannot be stated, let alone "
                "proven",
                scope="ample",
            ))
            ample_certified = False
        else:
            try:
                gfps, ginterp, _ = guard_footprints(enc)
                collapsed.extend(ginterp.collapsed)
                f1 = None
            except TraceRefused as e:
                gfps = [np.zeros(enc.width, np.uint32)] * enc.max_actions
                f1 = _untraceable(name, "ample-enabledness",
                                  "enabled_bits_cols", e, "ample")
            pr, refused = props()
            rows = battery_rows(
                enc, spec if sym_certified else None,
                (list(pr[1]) if pr else []) + list(gfps),
            )
            if f1 is None:
                f1 = _check_ample_enabledness(name, enc, mask, gfps,
                                              device)
            obligations.append(f1)
            f2 = _check_ample_non_suppression(
                name, enc, spec if sym_certified else None, mask,
                gfps, pr[1], rows, device,
            ) if pr else _untraceable(
                name, "ample-non-suppression",
                "property_conditions_cols", refused, "ample")
            obligations.append(f2)
            ample_certified = (
                f1.severity != "error" and f2.severity != "error"
            )

    res = SoundnessResult(
        encoding=name,
        sym_certified=sym_certified,
        ample_certified=ample_certified,
        obligations=obligations,
        collapsed=sorted(set(collapsed)),
        analyzer_sec=time.perf_counter() - t0,
    )
    if use_cache:
        _CERT_CACHE[key] = res
    return res


def soundness_status(enc, device="cuda") -> Optional[bool]:
    """Best-effort certificate status for telemetry lane configs:
    True/False when the analyzer ran, None when it cannot (no
    declared reductions, or the analysis itself raised — telemetry
    must never take an engine down)."""
    try:
        res = certify_encoding(enc, device=device)
    except Exception:  # noqa: BLE001
        return None
    if res.sym_certified is None and res.ample_certified is None:
        return None
    return res.certified


# -- the engine gates -------------------------------------------------------

def gate_symmetry(enc, engine: str, unsound_ok: bool = False,
                  device="cuda") -> bool:
    """Spawn-time certificate gate for ``--symmetry``: returns True
    when the declared ``DeviceRewriteSpec`` is certified, False when
    uncertified but ``unsound_ok`` waives the refusal, and raises the
    unified :func:`checkers.common.soundness_refusal` otherwise."""
    from ..checkers.common import soundness_refusal

    res = certify_encoding(enc, device=device)
    if res.sym_certified is not False:
        return True
    if unsound_ok:
        return False
    f = res.failed("symmetry")
    raise soundness_refusal(
        engine, "symmetry", f.rule if f else "group-closure",
        f.message if f else "uncertified spec",
    )


def gate_ample(enc, engine: str, unsound_ok: bool = False,
               device="cuda") -> bool:
    """Spawn-time certificate gate for ``--ample-set`` (same contract
    as :func:`gate_symmetry`, ample scope)."""
    from ..checkers.common import soundness_refusal

    res = certify_encoding(enc, device=device)
    if res.ample_certified is not False:
        return True
    if unsound_ok:
        return False
    f = res.failed("ample")
    raise soundness_refusal(
        engine, "ample-set", f.rule if f else "ample-enabledness",
        f.message if f else "uncertified mask",
    )


# -- the artifact + CLI -----------------------------------------------------

def write_soundness_artifact(results, root=None) -> str:
    """``SOUND_rNN.json`` in the JAX schema (``soundness-cert/v1``): own
    round sequence, clean flag, provenance block, per-spec
    certificates."""
    from ..artifacts import artifact_path, next_round, provenance

    path = artifact_path(
        "SOUND", root=root,
        round=next_round(root, stems=("SOUND",)),
    )
    report = {
        "schema": "soundness-cert/v1",
        "clean": all(r.certified for r in results),
        "specs": {r.encoding: r.as_dict() for r in results},
        "provenance": provenance(
            lane={"analyzer": "stateright_tpu_torch/analysis/soundness.py"}
        ),
    }
    with open(path, "w") as fh:
        json.dump(report, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return path


USAGE = (
    "usage: stateright_tpu_torch analyze soundness "
    "[MODEL] [COUNT] [--no-artifact] [--device cuda|cpu]\n"
    "  MODEL: one of the registered soundness targets "
    "(analysis/registry.SOUNDNESS_TARGETS); default all"
)


def analyze_main(argv) -> int:
    """``stateright_tpu_torch analyze soundness [MODEL] [COUNT]
    [--no-artifact] [--device cuda|cpu]`` — certify the registered
    soundness targets (or one model) with the battery on the device
    (the card unless ``--device cpu``) and write ``SOUND_rNN.json``.
    Exit 0 when every checked spec certifies, 1 otherwise, 2 on a
    usage error."""
    argv = list(argv)
    if not argv or argv[0] != "soundness":
        print(USAGE)
        return 2
    rest = argv[1:]
    no_artifact = "--no-artifact" in rest
    rest = [a for a in rest if a != "--no-artifact"]
    device = "cuda"
    args = []
    it = iter(rest)
    for a in it:
        if a == "--device":
            device = next(it, None)
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            args.append(a)
    if device not in ("cuda", "cpu") or len(args) > 2 or any(
            a.startswith("--") for a in args):
        print(USAGE)
        return 2
    model = args[0] if args else None
    count = int(args[1]) if len(args) > 1 else None

    from .registry import SOUNDNESS_TARGETS

    targets = [
        (tname, factory) for tname, factory in SOUNDNESS_TARGETS
        if model is None or tname == model
    ]
    if not targets:
        known = [t for t, _ in SOUNDNESS_TARGETS]
        print(f"unknown model {model!r}; targets: {known}")
        return 2
    results = []
    for tname, factory in targets:
        enc = factory(count)
        res = certify_encoding(enc, use_cache=False, device=device)
        results.append(res)
        status = "certified" if res.certified else "REFUSED"
        print(
            f"{tname} ({res.encoding}): {status} "
            f"[{res.analyzer_sec:.2f}s]"
        )
        for f in res.obligations:
            mark = "ok " if f.severity == "info" else "FAIL"
            print(f"  {mark} {f.rule}: {f.message}")
        if res.collapsed:
            print(
                "  over-approximated primitives: "
                f"{res.collapsed}"
            )
    if not no_artifact:
        path = write_soundness_artifact(results)
        print(f"wrote {os.path.basename(path)}")
    return 0 if all(r.certified for r in results) else 1
