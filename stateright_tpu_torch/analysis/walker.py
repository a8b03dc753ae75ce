"""Aten traces of the encodings' device functions, for the analyzer.

The port's counterpart of the JAX package's ``analysis.walker``. Where
the JAX analyzer walks the jaxpr of a per-state function, this one
walks the aten graph of a batched ``*_cols`` function:
:func:`trace_cols` runs it on one int64 ``[W, 1]`` block under a
``TorchDispatchMode`` that records every aten call into an FX graph.
The function sees :class:`_Traced` tensors: each holds its graph node
and a real CPU tensor of its shape and dtype (its shadow) that the
recorded op runs on, so that shapes propagate; the shadow's values are
never shown to the function. The recorder functionalizes as it goes:
an in-place op is recorded as its functional twin (``acc |= x``
becomes ``bitwise_or``), and a write through a view as a scatter into
its base (``t[:, 0] = x`` becomes ``select_scatter``), so that a node's
value is a function of its arguments alone — what an abstract
interpreter needs. :func:`source_of` renders a node's ``file:line``.

The recorder uses neither ``make_fx`` nor fake tensors: both import
``torch._dynamo`` (or sympy) on first use, which costs seconds in a
fresh process, and the gate runs at every reduced spawn.

A function that branches on a value (``bool(t)``, ``t.item()``,
``t.tolist()``) or makes a data-dependent shape (``nonzero``, a mask
index) cannot be traced: a traced tensor has no values to give. That
raises :class:`TraceRefused`, which the analyzer turns into a failed
obligation — never into a certificate. So does a write the recorder
cannot express functionally: into a tensor made outside the function,
through a view it cannot invert, or into a tensor whose view is read
after the write.
"""

from __future__ import annotations

import operator
import os
import sys
import traceback
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

_TORCH_DIR = os.path.dirname(torch.__file__)
_HERE = os.path.abspath(__file__)

_aten = torch.ops.aten

#: ops that read only a tensor's metadata, which a traced tensor has
_METADATA = {torch.ops.prim.device.default, _aten.sym_size.int,
             _aten.sym_stride.int, _aten.sym_numel.default,
             _aten.sym_storage_offset.default, _aten.is_contiguous.default,
             _aten.is_same_size.default, _aten.dim.default}

#: Python's in-place operators, by the functional op each is recorded as
_DUNDER_TWINS = {"__ior__": "bitwise_or", "__iand__": "bitwise_and",
                 "__ixor__": "bitwise_xor", "__ilshift__": "__lshift__",
                 "__irshift__": "__rshift__"}


class TraceRefused(Exception):
    """A device function that cannot be traced to a fixed graph:
    ``source`` is the ``file:line`` of the user frame that raised."""

    def __init__(self, message: str, source: str):
        super().__init__(message)
        self.source = source


class _Traced(torch.Tensor):
    """A value of the trace: its graph ``node``, its ``shadow`` (a real
    tensor of its shape and dtype that ops run on), and, for a view,
    its ``base`` and the ``inverse`` that writes it back. Views share
    their base's ``store``; a write bumps the store's generation, and a
    tensor whose ``gen`` lags behind it is stale."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @staticmethod
    def __new__(cls, shadow, node, store, base=None, inverse=None):
        t = torch.Tensor._make_wrapper_subclass(
            cls, shadow.shape, strides=shadow.stride(),
            storage_offset=shadow.storage_offset(), dtype=shadow.dtype,
            device=shadow.device)
        t.shadow, t.node, t.store = shadow, node, store
        t.base, t.inverse, t.gen = base, inverse, store[0]
        return t

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} on a traced tensor outside its trace")


def _inverse(func, args, kwargs):
    """How a view made by ``func`` writes back into its base: a function
    of (the base's node, the view's new node, the base) that gives the
    ``(target, args)`` of the base's new value; None where the recorder
    cannot invert the view."""
    rest = tuple(args[1:])
    if kwargs:
        return None
    if func is _aten.select.int:
        return lambda b, v, base: (_aten.select_scatter.default,
                                   (b, v, *rest))
    if func is _aten.slice.Tensor:
        return lambda b, v, base: (_aten.slice_scatter.default,
                                   (b, v, *rest))
    if func is _aten.permute.default:
        dims = [d % args[0].dim() for d in rest[0]]
        back = sorted(range(len(dims)), key=dims.__getitem__)
        return lambda b, v, base: (func, (v, back))
    if func in (_aten.transpose.int, _aten.t.default):
        return lambda b, v, base: (func, (v, *rest))
    if func in (_aten.view.default, _aten._unsafe_view.default,
                _aten.unsqueeze.default, _aten.squeeze.default,
                _aten.squeeze.dim, _aten.squeeze.dims, _aten.alias.default):
        return lambda b, v, base: (_aten.reshape.default,
                                   (v, list(base.shape)))
    return None


def _functional(func):
    """The functional twin of an in-place aten op, or None."""
    name = func._schema.name.split("::", 1)[1]
    if name in _DUNDER_TWINS:
        name = _DUNDER_TWINS[name]
    elif name.endswith("_") and not name.startswith("_"):
        name = name[:-1]
    else:
        return None
    return getattr(getattr(_aten, name, None), func._overloadname, None)


def _user_stack(depth: int = 4) -> list:
    """The innermost ``depth`` frames outside torch and this module, in
    traceback format, outermost first."""
    f = sys._getframe(2)
    lines: list = []
    while f is not None and len(lines) < depth:
        fn = f.f_code.co_filename
        if not (os.path.abspath(fn).startswith(_TORCH_DIR)
                or os.path.abspath(fn) == _HERE):
            lines.append(f'  File "{fn}", line {f.f_lineno}, '
                         f"in {f.f_code.co_name}\n")
        f = f.f_back
    return lines[::-1]


class _Recorder(TorchDispatchMode):
    """Records every aten call of the function into ``graph``; tensors
    made outside the function become constants of ``root``."""

    def __init__(self):
        super().__init__()
        self.graph = torch.fx.Graph()
        self.root = torch.nn.Module()
        self._consts: dict = {}
        #: the constants, held so that their ids stay theirs
        self._held: list = []

    def placeholder(self, name: str, example: torch.Tensor) -> _Traced:
        node = self.graph.placeholder(name)
        node.meta["val"] = example
        return _Traced(example, node, [0])

    def node_of(self, v):
        """The graph argument that stands for ``v``."""
        if isinstance(v, _Traced):
            if v.gen != v.store[0]:
                raise RuntimeError(
                    "a view is read after a write into the tensor it "
                    "views; the recorder does not regenerate views")
            return v.node
        if isinstance(v, torch.Tensor):
            node = self._consts.get(id(v))
            if node is None:
                name = f"_const{len(self._held)}"
                setattr(self.root, name, v)
                node = self.graph.get_attr(name)
                node.meta["val"] = v
                self._consts[id(v)] = node
                self._held.append(v)
            return node
        return v

    def _node(self, target, args, kwargs, val):
        node = self.graph.call_function(target, args, kwargs)
        node.meta["val"] = val
        node.meta["stack_trace"] = "".join(_user_stack())
        return node

    def _dispatch(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return func(*tree_map(_shadow, args), **tree_map(_shadow, kwargs))
        if torch.Tag.data_dependent_output in func.tags:
            raise RuntimeError(f"{func} reads a value of the trace")
        if torch.Tag.dynamic_output_shape in func.tags and not (
                func is _aten.index.Tensor and not any(
                    isinstance(i, torch.Tensor)
                    and i.dtype in (torch.bool, torch.uint8)
                    for i in args[1])):
            raise RuntimeError(f"{func} makes a shape that depends on "
                               "values of the trace")
        schema = func._schema
        written = [i for i, a in enumerate(schema.arguments)
                   if a.alias_info is not None and a.alias_info.is_write]
        if written:
            return self._write(func, written, args, kwargs)
        out = self._call(func, args, kwargs)
        ret = schema.returns[0].alias_info if schema.returns else None
        if func is _aten.lift_fresh.default:
            ret = None  # ``torch.tensor(...)``'s data is its own
        if ret is not None and isinstance(args[0], _Traced):
            # a view: it shares its base's store
            src = args[0]
            inv = _inverse(func, args, kwargs)
            outs = out if isinstance(out, (tuple, list)) else [out]
            for o in outs:
                o.store, o.gen = src.store, src.store[0]
                o.base, o.inverse = src, (inv if len(outs) == 1 else None)
        elif ret is not None:
            # a view of a constant: no inverse, so a write refuses
            outs = out if isinstance(out, (tuple, list)) else [out]
            for o in outs:
                o.base, o.inverse = o, None
        return out

    def _call(self, func, args, kwargs):
        res = func(*tree_map(_shadow, args), **tree_map(_shadow, kwargs))
        node = self._node(func, tree_map(self.node_of, args),
                          tree_map(self.node_of, kwargs), res)
        if isinstance(res, torch.Tensor):
            return _Traced(res, node, [0])
        if isinstance(res, (tuple, list)) and all(
                isinstance(r, torch.Tensor) for r in res):
            return type(res)(
                _Traced(r, self._node(operator.getitem, (node, i), {}, r),
                        [0])
                for i, r in enumerate(res))
        raise RuntimeError(f"{func} returns {type(res).__name__}, which "
                           "the recorder cannot trace")

    def _write(self, func, written, args, kwargs):
        """An in-place op: record its functional twin, rebind the
        written tensor to the result, and scatter it into every base."""
        dst = args[0]
        twin = _functional(func)
        if written != [0] or twin is None:
            raise RuntimeError(f"{func} writes in place and has no "
                               "functional twin")
        if not isinstance(dst, _Traced):
            raise RuntimeError(f"{func} writes into a tensor made outside "
                               "the traced function")
        new = self._call(twin, args, kwargs)
        if new.dtype != dst.dtype:
            new = self._call(_aten._to_copy.default, (new,),
                             {"dtype": dst.dtype})
        chain = [dst]
        while chain[-1].base is not None:
            if chain[-1].inverse is None:
                raise RuntimeError(f"{func} writes through a view the "
                                   "recorder cannot invert")
            chain.append(chain[-1].base)
        for t in chain:
            self.node_of(t)  # refuses a stale tensor
        node = new.node
        for view, base in zip(chain, chain[1:]):
            view.node = node
            target, args_ = view.inverse(base.node, node, base)
            node = self._node(target, args_, {}, base.shadow)
        chain[-1].node = node
        dst.store[0] += 1
        for t in chain:
            t.gen = dst.store[0]
        return dst


# bound after the class statement: TorchDispatchMode wraps a subclass's
# own ``__torch_dispatch__`` in ``torch._disable_dynamo``, whose first
# call imports ``torch._dynamo``; nothing compiles inside a trace
_Recorder.__torch_dispatch__ = _Recorder._dispatch


def _shadow(v):
    return v.shadow if isinstance(v, _Traced) else v


def _user_frame(tb) -> str:
    """``file:line (function)`` of the innermost frame outside torch."""
    best = "<unknown>"
    for fr in traceback.extract_tb(tb):
        fn = os.path.abspath(fr.filename)
        if fn.startswith(_TORCH_DIR) or fn == _HERE:
            continue
        best = f"{fr.filename}:{fr.lineno} ({fr.name})"
    return best


def trace_cols(fn: Callable, width: int,
               *extra: torch.Tensor) -> torch.fx.GraphModule:
    """The functional aten graph of ``fn`` on an int64 ``[width, 1]``
    block and the ``extra`` example tensors (the graph's placeholders,
    in that order; its outputs are ``fn``'s). ``fn`` runs once eagerly on
    a zero block first, so that a per-device table cache fills with real
    tensors rather than traced ones. Raises :class:`TraceRefused` when
    ``fn`` cannot be traced."""
    example = torch.zeros((width, 1), dtype=torch.int64)
    fn(example, *extra)
    rec = _Recorder()
    inputs = [rec.placeholder("states_t", example)] + [
        rec.placeholder(f"arg{i}", e.clone()) for i, e in enumerate(extra)]
    try:
        with rec:
            out = fn(*inputs)
        rec.graph.output(tree_map(rec.node_of, out))
    except Exception as e:  # noqa: BLE001 — any trace fault refuses
        raise TraceRefused(
            f"{type(e).__name__}: {str(e).splitlines()[0] if str(e) else ''}",
            _user_frame(e.__traceback__),
        ) from e
    return torch.fx.GraphModule(rec.root, rec.graph)


def source_of(node) -> str:
    """``file:line (function)`` of the innermost user frame that traced
    ``node`` (its ``stack_trace`` meta), or ``<unknown>``."""
    st = getattr(node, "meta", {}).get("stack_trace")
    if not st:
        return "<unknown>"
    best = "<unknown>"
    for line in st.strip().splitlines():
        line = line.strip()
        if not line.startswith('File "'):
            continue
        try:
            path, rest = line[6:].split('", line ', 1)
            lineno, _, func = rest.partition(", in ")
        except ValueError:
            continue
        ap = os.path.abspath(path)
        if ap.startswith(_TORCH_DIR) or ap == _HERE:
            continue
        best = f"{path}:{lineno.strip()} ({func.strip()})"
    return best
