"""The actor→encoding compiler: generic ``ActorModel`` → device encoding.

The port of ``stateright_tpu.actor.compile``. Given an
:class:`~stateright_tpu_torch.actor.ActorModel`,
:func:`compile_actor_model` produces a sparse encoding for the
sort-merge engine — lane layout, ``encode``, enabled bits, the pair
step and the property lanes — with no hand-written device code.

**Host half, copied.** Actor systems factorize: a system state is
(per-actor local states, network, timer sets, crashed bits, history).
The compiler computes a **component closure** — the local states each
actor can reach, the envelope universe, the timer universe and the
history domain — by running the REAL actor handlers and history hooks
on the host, over all (state, envelope) pairs to a fixpoint
(``closure="overapprox"``) or over a host exploration
(``closure="reachable"``). Transitions become per-(slot, actor-state)
table rows; ``_optimize_codegen`` interns the rows, prunes the table
columns that are constant into immediates and plans the enabled mask
as condition-gated word classes. All of it is the JAX package's code,
so the tables are equal element for element.

**Device half, written as batched torch.** The JAX package traces its
per-state functions and ``vmap``s them. Here every function takes a
lane-major ``[W, N]`` int64 block of uint32 lanes (encoding.py) and
runs the plan's emission over the whole batch:
:meth:`CompiledActorEncoding.enabled_bits_cols`,
:meth:`~CompiledActorEncoding.step_slot_cols` (returning the successor
block and the two truncation flags),
:meth:`~CompiledActorEncoding.property_conditions_cols` and
:meth:`~CompiledActorEncoding.within_boundary_cols`. A table column
folded into a constant stays a python ``int`` and decides which lanes
are written, as in the JAX emission; the tables themselves are copied
to a device once and kept (``_device_consts``).

The lanes are uint32 values carried in int64. The JAX emission relies
on uint32 wraparound in one place a value can leave 32 bits — the
non-duplicating count add, whose top field may carry past bit 31 —
and that sum is masked to 32 bits (``_M32``); every other write stays
inside its field by construction. Out-of-range table indices clamp, as
a JAX gather does.

**Properties and boundaries** are *specs*: ``spec(ctx, torch) ->
bool[N]``, where ``ctx`` (:class:`_SpecCtx`) offers component-tabulated
values over the batch — ``actor_values`` is ``[n_actors, N]`` and a
spec reduces it over ``dim=0``. The host functions a spec names run
only over component domains, once per device.

Two emissions are ported: the optimized sparse emission above and the
dense step (:meth:`~CompiledActorEncoding.step_cols`, the JAX
``step_vec``: every slot of every state from the per-slot transition
tables, with its count- and queue-bound ``trunc`` flag). The engine
runs the sparse one unless asked for ``sparse=False``. ``optimize=False``
(the naive sparse emission, an ablation baseline) raises
``NotImplementedError``. The symmetry and ample-set declarations
(``device_rewrite_spec``, ``ample_mask``) are taken, with the JAX
package's validation, and the engines gate them on the soundness
analyzer's certificate (analysis/soundness.py).

The encoding's identity (:meth:`CompiledActorEncoding.cache_key`, which
a snapshot's encoding fingerprint reads, checkpoint.py) is the port's
own: it hashes the spec functions, and the port's are not the JAX
package's, so a compiled snapshot resumes only in the package that
wrote it.

**Limits** (checked, as in the JAX package): ordered (FIFO) networks
need per-channel queue bounds — harvested (``closure="reachable"``) or
declared (``closure_queue_bound``); a queue pushed past its bound sets
the truncation flag, and the engine raises. Lossy ordered networks are
rejected. Non-duplicating envelope counts ride in 8-bit fields; a
successor whose count reaches 128 is pruned and raises unless the
boundary would prune it anyway. Component domains must close within
``max_domain``. A local state outside ``closure_actor_bound`` is kept
but not expanded, so its transitions are not in the tables: a run that
expands a state holding one raises the truncation error (the JAX
compiler leaves those transitions out silently, and undercounts).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..encoding import EncodedModelBase, stack_slots
from ..fingerprint import stable_hash
from ..ops.bitmask import (
    bit_run_plan,
    bit_select,
    const_words,
    mask_words,
    or_bit_runs,
    or_class_words,
    pack_bits_host,
    select_words_host,
    slot_mask_host,
)
from .base import CancelTimer, Cow, Id, Out, Send, SetTimer, is_no_op, \
    is_no_op_with_timer
from .model import ActorModel
from .network import Envelope, Ordered, UnorderedDuplicating, \
    UnorderedNonDuplicating

#: uint32 lanes carried in int64: the mask a wrapping sum leaves under
_M32 = 0xFFFFFFFF


def _fn_key(fn):
    """Cache key of a spec callback: its code, the values it closes
    over and its default arguments (``lambda i, s, k=k: ...`` built in
    a loop shares one code object), or None when one of those values
    is unhashable (such a callback is tabulated again on every call)."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return None
    cells = tuple(c.cell_contents for c in fn.__closure__ or ())
    kwdefaults = tuple(sorted((fn.__kwdefaults__ or {}).items()))
    key = (code, cells, fn.__defaults__, kwdefaults)
    try:
        hash(key)
    except TypeError:
        return None
    return key


def _bool_cols(value, n: int, device) -> torch.Tensor:
    """A spec's verdict as ``bool[n]``: a tensor broadcast, or a Python
    constant filled on the device (no copy from host memory, which a
    CUDA graph cannot capture)."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype=torch.bool, device=device).expand(n)
    return torch.full((n,), bool(value), dtype=torch.bool, device=device)


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with the index clamped into range (a JAX gather
    clamps; an index past the table only comes from a state no run
    reaches)."""
    return table[idx.clamp(0, table.shape[0] - 1)]


def _field(states_t: torch.Tensor, f) -> torch.Tensor:
    """Field ``f`` of every state of a ``[W, N]`` block."""
    return (states_t[f.lane] >> f.shift) & ((1 << f.bits) - 1)


# -- spec context --------------------------------------------------------


class _SpecCtx:
    """What a property/boundary spec can read over a ``[W, N]`` batch,
    all component-tabulated: each host callback runs once per element
    of its component domain, and its table is kept per device."""

    def __init__(self, enc: "CompiledActorEncoding",
                 states_t: torch.Tensor):
        self._enc = enc
        self._states = states_t

    def _table(self, kind: str, fn, build) -> Any:
        enc = self._enc
        key = _fn_key(fn)
        dev = self._states.device
        cache = enc.__dict__.setdefault("_spec_tables", {})
        if key is not None and (kind, key, dev) in cache:
            return cache[(kind, key, dev)]
        table = build()
        if key is not None:
            cache[(kind, key, dev)] = table
        return table

    def actor_values(self, fn: Callable[[int, Any], Any]) -> torch.Tensor:
        """``int64[n_actors, N]`` — fn(i, local_state) per actor,
        tabulated over each actor's closure domain."""
        enc = self._enc
        dev = self._states.device
        tables = self._table("actor", fn, lambda: [
            torch.tensor([int(fn(i, s)) for s in enc.S[i]],
                         dtype=torch.int64, device=dev)
            for i in range(enc.n)
        ])
        return torch.stack([
            _take(tables[i], _field(self._states, enc.f_actor[i]))
            for i in range(enc.n)
        ])

    def history_value(self, fn: Callable[[Any], Any]) -> torch.Tensor:
        """``int64[N]`` — fn(history), tabulated over the history
        domain."""
        enc = self._enc
        table = self._table("history", fn, lambda: torch.tensor(
            [int(fn(h)) for h in enc.H], dtype=torch.int64,
            device=self._states.device))
        return _take(table, _field(self._states, enc.f_history))

    def network_any(self, fn: Callable[[Envelope], bool]) -> torch.Tensor:
        """``bool[N]`` — True iff any envelope matching ``fn`` is in
        flight. Unordered: one AND per lane against the union of the
        matching envelopes' fields (a count is non-zero iff its field
        bits are). Ordered: an envelope is in flight iff its code is a
        digit of its channel's queue, at any position."""
        enc = self._enc
        plan = self._table("network", fn, lambda: enc._network_plan(fn))
        hit = torch.zeros(self._states.shape[1], dtype=torch.bool,
                          device=self._states.device)
        if enc.ordered:
            for ci, codes in plan:
                ch = enc.channels[ci]
                base = enc.ch_base[ch]
                q = _field(self._states, enc.f_ch[ci])
                for p in range(enc.ch_q[ch]):
                    digit = (q // base**p) % base
                    for code in codes:
                        hit = hit | (digit == code)
        else:
            for lane, mask in plan:
                hit = hit | ((self._states[lane] & mask) != 0)
        return hit

    def crashed_count(self) -> torch.Tensor:
        """``int64[N]`` — the number of crashed actors."""
        enc = self._enc
        total = torch.zeros(self._states.shape[1], dtype=torch.int64,
                            device=self._states.device)
        for i in range(enc.n):
            total = total + _field(self._states, enc.f_crashed[i])
        return total


PropertySpec = Callable[[_SpecCtx, Any], Any]


# -- layout helpers ------------------------------------------------------


class _Field:
    """A bit field at (lane, shift, bits) in the uint32 state vector."""

    __slots__ = ("lane", "shift", "bits")

    def __init__(self, lane: int, shift: int, bits: int):
        self.lane, self.shift, self.bits = lane, shift, bits

    @property
    def mask(self) -> int:
        return ((1 << self.bits) - 1) << self.shift


class _LayoutBuilder:
    def __init__(self):
        self.lane = 0
        self.shift = 0

    def add(self, bits: int) -> _Field:
        if bits > 32:
            raise ValueError(f"field too wide: {bits} bits")
        if self.shift + bits > 32:  # fields never straddle lanes
            self.lane += 1
            self.shift = 0
        f = _Field(self.lane, self.shift, bits)
        self.shift += bits
        if self.shift == 32:
            self.lane += 1
            self.shift = 0
        return f

    @property
    def width(self) -> int:
        return self.lane + (1 if self.shift else 0)


def _bits_for(n: int) -> int:
    return max(1, (n - 1).bit_length()) if n > 1 else 1




def _domain_sort_key(value: Any):
    return (stable_hash(value), repr(value))


# -- the compiler --------------------------------------------------------


def compile_actor_model(
    model: ActorModel,
    properties: Optional[dict[str, PropertySpec]] = None,
    boundary: Optional[PropertySpec] = None,
    closure: str = "overapprox",
    closure_actor_bound: Optional[Callable[[int, Any], bool]] = None,
    closure_history_bound: Optional[Callable[[Any], bool]] = None,
    closure_queue_bound=None,
    max_domain: int = 1 << 15,
    closure_max_states: int = 1 << 21,
    device_rewrite_spec=None,
    ample_mask=None,
    optimize: bool = True,
) -> "CompiledActorEncoding":
    """Compile ``model`` into a sparse encoding for the sort-merge
    engine (encoding.py ``SparseEncodedModel``).

    ``properties`` maps each host property name to its device spec;
    every host property must have one (the encoding must discover the
    identical property set). ``boundary`` is the device counterpart of
    ``within_boundary_fn``. ``closure_*_bound`` stop the component
    closure from expanding values that only occur beyond the boundary
    (they are kept, unexpanded, so boundary evaluation still sees
    them — mirroring bfs.rs:279-281, where out-of-boundary successors
    are pruned before expansion in this engine and the host BFS alike).

    ``closure`` selects how component domains are discovered:

    * ``"overapprox"`` (default) — the fixpoint over all (state,
      envelope) pairs. No host exploration: the device does ALL the
      search work. Requires the per-component closure to converge
      (pass ``closure_*_bound`` for components only bounded by the
      boundary).
    * ``"reachable"`` — harvest domains and co-occurring pairs from a
      host breadth-first exploration at compile time. Always
      converges when the model does, with minimal domains — the right
      mode for protocols whose local closure diverges under
      overapproximation (e.g. ABD timestamps, which are bounded only
      by system-level reachability). The host explores once; use it
      as the bootstrap / differential mode, not the scale mode.

    ``closure_queue_bound`` makes ordered (FIFO) networks compile in
    overapprox mode: a declared per-channel
    queue-length bound — an ``int`` (uniform), a ``dict``
    ``{(src, dst): depth}`` with int actor ids, or a callable
    ``(src, dst) -> depth`` — replaces the queue bounds that
    ``closure="reachable"`` harvests from its host exploration. A
    protocol bound in the same family as ABD's clock/ops bounds: the
    device prunes a push past the declared depth and raises the
    truncation flag when the successor is in boundary, so an
    under-declared bound fails loudly rather than silently
    truncating. Ignored for unordered networks.

    ``device_rewrite_spec`` (an ``ops.canonical.DeviceRewriteSpec``)
    declares the encoding's interchangeable limb group for device
    symmetry reduction — validated against the compiled lane layout.
    ``ample_mask`` is a packed slot-word tuple (ops/bitmask.py layout)
    for the static ample-set filter. The engine runs each only once the
    soundness analyzer certifies it (analysis/soundness.py) — it names
    the obligation that fails otherwise — or with
    ``CheckerBuilder.unsound_ok()``.

    ``optimize`` (default True) runs the post-``_build_tables`` codegen
    optimizer: effect-class fusion
    (the deliver/timeout switch ladder collapses when the transition
    tables subsume it), flat-table interning + constant-column pruning
    (duplicate effect blocks share storage; host-constant table columns
    become immediates instead of gather lanes), history/crash gather
    elision, and word-level enabled-mask assembly from condition-gated
    host class masks (ops/bitmask.py builders — the hand encodings'
    predicate idiom). The applied rewrites are reported in
    ``encoding.codegen_opt``. Only this emission is ported:
    ``optimize=False`` raises ``NotImplementedError``.

    The compile's host wall is stamped on the encoding
    (``host_compile_span``, monotonic seconds): the first traced run
    that uses the encoding records it as a ``compile`` span
    (telemetry.py), since the compile runs before that run begins.
    """
    t0 = time.monotonic()
    enc = CompiledActorEncoding(
        model,
        properties or {},
        boundary,
        closure,
        closure_actor_bound,
        closure_history_bound,
        max_domain,
        closure_max_states,
        closure_queue_bound=closure_queue_bound,
        device_rewrite_spec=device_rewrite_spec,
        ample_mask=ample_mask,
        optimize=optimize,
    )
    enc.host_compile_span = (t0, time.monotonic())
    return enc



class CompiledActorEncoding(EncodedModelBase):
    def __init__(
        self,
        model: ActorModel,
        property_specs: dict[str, PropertySpec],
        boundary_spec: Optional[PropertySpec],
        closure_mode: str,
        closure_actor_bound,
        closure_history_bound,
        max_domain: int,
        closure_max_states: int,
        closure_queue_bound=None,
        device_rewrite_spec=None,
        ample_mask=None,
        optimize: bool = True,
    ):
        if closure_mode not in ("overapprox", "reachable"):
            raise ValueError(f"unknown closure mode {closure_mode!r}")
        if not optimize:
            raise NotImplementedError(
                "only the optimized sparse emission and the dense step "
                "are ported; the naive optimize=False emission (an "
                "ablation baseline) is not (ROADMAP item 9)"
            )
        self.ordered = isinstance(model._init_network, Ordered)
        self._queue_bound_decl = closure_queue_bound
        if self.ordered:
            # FIFO queue lengths are bounded only by system-level
            # reachability (like ABD timestamps): either harvest the
            # bound from a reachable-mode host exploration, or accept
            # it as a DECLARED protocol bound so overapprox mode needs
            # no host search at all.
            if closure_mode != "reachable" and closure_queue_bound is None:
                raise ValueError(
                    "ordered (FIFO) networks need queue-length bounds: "
                    'use closure="reachable" (harvested bounds) or pass '
                    "closure_queue_bound (declared protocol bounds; "
                    "under-declared bounds raise the truncation flag)"
                )
            if model.lossy_network:
                raise ValueError(
                    "lossy ordered networks are not compiled yet (the "
                    "reference drops arbitrary flow positions, which "
                    "breaks the head-only queue encoding); use the host "
                    "checkers"
                )
        self.model = model
        self.host_model = model
        self.n = len(model.actors)
        self.dup = isinstance(model._init_network, UnorderedDuplicating)
        self.lossy = model.lossy_network
        self.max_crashes = model.max_crashes
        self.max_domain = max_domain
        self.closure_mode = closure_mode
        self.closure_max_states = closure_max_states
        self._actor_bound = closure_actor_bound or (lambda i, s: True)
        self._history_bound = closure_history_bound or (lambda h: True)
        self.property_specs = property_specs
        self.boundary_spec = boundary_spec

        host_props = [p.name for p in model.properties()]
        missing = [p for p in host_props if p not in property_specs]
        if missing:
            raise ValueError(
                f"no device spec for host properties {missing}; "
                "compile_actor_model needs a spec per property"
            )

        self._close()
        self._build_layout()
        self._build_tables()
        self._opt = None
        self.codegen_opt = None
        self._optimize_codegen()
        if self._opt is None:
            raise NotImplementedError(
                "this model compiles to no deliver or timeout slot, so the "
                "codegen optimizer has no plan; the naive emission is not "
                "ported (ROADMAP item 9)"
            )
        self._spec = device_rewrite_spec
        self._ample_mask = ample_mask
        if device_rewrite_spec is not None:
            from ..ops.canonical import validate_spec

            validate_spec(device_rewrite_spec, width=self.width)
        if ample_mask is not None:
            from ..ops.bitmask import mask_words

            if len(ample_mask) != mask_words(self.max_actions):
                raise ValueError(
                    f"ample_mask has {len(ample_mask)} words; this "
                    f"encoding's {self.max_actions}-slot mask needs "
                    f"{mask_words(self.max_actions)}"
                )

    def cache_key(self):
        """This compilation's identity: the JAX ``cache_key``'s fields
        under a tag of its own (``"torch-actor-compile"``). The property
        and boundary specs enter by their bytecode and captured values
        (a captured function by its own), so two compilations with
        different specs never share an identity;
        a JAX compilation's specs are other functions, so its identity is
        another (a JAX compiled snapshot is stale here)."""
        def code_fp(code):
            # a nested code object enters by its bytecode, not its repr
            # (which holds an address)
            return (code.co_code, tuple(
                code_fp(c) if hasattr(c, "co_code") else repr(c)
                for c in code.co_consts))

        def spec_fp(fn, depth=0):
            # a captured function enters by its own code, so the identity
            # is the same in every process
            if fn is None:
                return None
            code = getattr(fn, "__code__", None)
            if code is None or depth > 4:
                return repr(fn)
            cells = tuple(
                spec_fp(c.cell_contents, depth + 1)
                if callable(c.cell_contents) else repr(c.cell_contents)
                for c in (fn.__closure__ or ()))
            return (code_fp(code), cells)

        return (
            "torch-actor-compile", self.n, self.dup, self.lossy,
            self.max_crashes,
            tuple(tuple(stable_hash(s) for s in S) for S in self.S),
            tuple(stable_hash(e) for e in self.E),
            tuple(stable_hash(h) for h in self.H),
            tuple((name, spec_fp(fn))
                  for name, fn in sorted(self.property_specs.items())),
            spec_fp(self.boundary_spec),
            repr(self._spec) if self._spec is not None else None,
            tuple(self._ample_mask) if self._ample_mask else None,
            tuple(sorted((int(c[0]), int(c[1]), self.ch_q[c])
                         for c in self.channels)) if self.ordered else None,
        )

    def device_rewrite_spec(self):
        """The declared symmetry spec (compile_actor_model's
        ``device_rewrite_spec``), or None."""
        return self._spec

    def ample_mask_host(self):
        """The declared ample-set slot words, or None."""
        return self._ample_mask

    # -- closure ---------------------------------------------------------

    def _close(self) -> None:
        model = self.model
        init_states = list(model.init_states())
        if len(init_states) != 1:
            raise ValueError("ActorModel must have exactly one init state")
        init = init_states[0]
        self._init_state = init

        # Domains under construction (dict preserves insertion order;
        # sorted canonically after the fixpoint).
        S: list[dict] = [dict() for _ in range(self.n)]
        E: dict = {}
        T: list[dict] = [dict() for _ in range(self.n)]
        H: dict = {}
        expandable_s: list[dict] = [dict() for _ in range(self.n)]
        expandable_h: dict = {}
        work: deque = deque()

        def add_actor_state(i: int, s: Any) -> None:
            if s not in S[i]:
                if len(S[i]) >= self.max_domain:
                    raise RuntimeError(
                        f"actor {i} local-state closure exceeded "
                        f"{self.max_domain} values — the component closure "
                        "diverges (overapproximation pairs states with "
                        "envelopes that never co-occur; see module "
                        "docstring). Pass closure_actor_bound, use "
                        'closure="reachable", raise max_domain, or use '
                        "a hand encoding."
                    )
                S[i][s] = len(S[i])
                expandable_s[i][s] = bool(self._actor_bound(i, s))
                work.append(("s", i, s))

        def add_envelope(env: Envelope) -> None:
            if env not in E:
                if len(E) >= self.max_domain:
                    raise RuntimeError(
                        f"envelope-universe closure exceeded "
                        f"{self.max_domain} values — see the actor-state "
                        "divergence notes in the module docstring"
                    )
                E[env] = len(E)
                work.append(("e", env))

        def add_timer(i: int, t: Any) -> None:
            if t not in T[i]:
                T[i][t] = len(T[i])
                work.append(("t", i, t))

        def add_history(h: Any) -> None:
            if h not in H:
                if len(H) >= self.max_domain:
                    raise RuntimeError(
                        f"history closure exceeded {self.max_domain} values "
                        "— pass closure_history_bound (mirroring the "
                        "boundary) or use a hand encoding"
                    )
                H[h] = len(H)
                expandable_h[h] = bool(self._history_bound(h))
                work.append(("h", h))

        for i, s in enumerate(init.actor_states):
            add_actor_state(i, s)
        for env in init.network.iter_deliverable():
            add_envelope(env)
        for i, timers in enumerate(init.timers_set):
            for t in timers:
                add_timer(i, t)
        add_history(init.history)

        # Memoized handler transitions, filled during the fixpoint.
        self._msg_tr: dict = {}    # (i, s, env) -> (s2, noop, sends, tmap)
        self._tmo_tr: dict = {}    # (i, s, t)  -> (s2, noop, sends, tmap)
        self._hist_tr: dict = {}   # (h, env|None, sends) -> h2
        #: (i, s, env) pairs whose handler RAISED under overapprox
        #: (possibly system-unreachable). Ordered networks must keep
        #: these UNDELIVERABLE rather than forcing the usual noop-pop
        #: (a raising handler is not a pop): if such a pair is
        #: reachable, the host model raises there and the differential
        #: replay flags the divergence — same contract as unordered.
        self._raised_msg: set = set()

        def run_msg(i: int, s: Any, env: Envelope):
            key = (i, s, env)
            if key in self._msg_tr:
                return
            cow = Cow(s)
            out = Out()
            try:
                model.actors[i].on_msg(Id(i), cow, env.src, env.msg, out)
            except Exception as exc:
                if self.closure_mode == "reachable":
                    # Every harvested pair comes from a reachable system
                    # state: a raising handler is a genuine model bug
                    # (the reference propagates handler panics), not an
                    # overapproximation artifact — fail the compile.
                    raise RuntimeError(
                        f"actor {i} on_msg raised on a reachable "
                        f"(state, envelope) pair: state={s!r}, "
                        f"envelope={env!r}"
                    ) from exc
                # The closure overapproximates: this (state, envelope)
                # pair can be system-unreachable, in which case the
                # handler may legitimately reject it. Record a no-op
                # row; if the pair IS reachable the host model crashes
                # identically and the differential replay flags it.
                self._msg_tr[key] = (s, True, (), {})
                self._raised_msg.add(key)
                return
            noop = is_no_op(cow, out)
            sends, tmap = self._fold_commands(Id(i), out)
            self._msg_tr[key] = (cow.value, noop, sends, tmap)
            if not noop:
                add_actor_state(i, cow.value)
                for send in sends:
                    add_envelope(send)
                for t, armed in tmap.items():
                    if armed:
                        add_timer(i, t)

        def run_timeout(i: int, s: Any, t: Any):
            key = (i, s, t)
            if key in self._tmo_tr:
                return
            cow = Cow(s)
            out = Out()
            try:
                model.actors[i].on_timeout(Id(i), cow, t, out)
            except Exception as exc:
                if self.closure_mode == "reachable":
                    raise RuntimeError(
                        f"actor {i} on_timeout raised on a reachable "
                        f"(state, timer) pair: state={s!r}, timer={t!r}"
                    ) from exc
                self._tmo_tr[key] = (s, True, (), {})
                return
            noop = is_no_op_with_timer(cow, out, t)
            sends, tmap = self._fold_commands(Id(i), out)
            self._tmo_tr[key] = (cow.value, noop, sends, tmap)
            if not noop:
                add_actor_state(i, cow.value)
                for send in sends:
                    add_envelope(send)
                for t2, armed in tmap.items():
                    if armed:
                        add_timer(i, t2)

        def run_history(h: Any, env: Optional[Envelope],
                        sends: tuple) -> None:
            key = (h, env, sends)
            if key in self._hist_tr:
                return
            h2 = h
            try:
                if env is not None:
                    nh = model._record_msg_in(model.cfg, h2, env)
                    if nh is not None:
                        h2 = nh
                for send in sends:
                    nh = model._record_msg_out(model.cfg, h2, send)
                    if nh is not None:
                        h2 = nh
            except Exception:
                # Overapproximated (history, event) pair — e.g. a
                # double-invoke the real system cannot produce. Self-
                # loop; unreachable rows are never gathered.
                h2 = h
            self._hist_tr[key] = h2
            add_history(h2)

        if self.closure_mode == "reachable":
            self._harvest_reachable(
                model, init, add_actor_state, add_envelope, add_timer,
                add_history, run_msg, run_timeout, run_history,
            )
            work.clear()
        # Fixpoint: drain the worklist (actor-state / envelope / timer
        # cross-products), then close the history domain against the
        # current effect classes; repeat until neither grows.
        while self.closure_mode == "overapprox":
            while work:
                kind, *rest = work.popleft()
                if kind == "s":
                    i, s = rest
                    if not expandable_s[i][s]:
                        continue
                    for env in list(E):
                        if int(env.dst) == i:
                            run_msg(i, s, env)
                    for t in list(T[i]):
                        run_timeout(i, s, t)
                elif kind == "e":
                    (env,) = rest
                    i = int(env.dst)
                    if i < self.n:
                        for s in list(S[i]):
                            if expandable_s[i][s]:
                                run_msg(i, s, env)
                elif kind == "t":
                    i, t = rest
                    for s in list(S[i]):
                        if expandable_s[i][s]:
                            run_timeout(i, s, t)
                # "h" items just mark domain growth; the history
                # cross-product runs against effect classes below.
            classes = self._effect_classes()
            grew = False
            for h in list(H):
                if not expandable_h[h]:
                    continue
                for cls in classes:
                    if (h, cls[0], cls[1]) not in self._hist_tr:
                        run_history(h, cls[0], cls[1])
                        grew = True
            if not work and not grew:
                break

        self.S = [
            sorted(S[i], key=_domain_sort_key) for i in range(self.n)
        ]
        self.sidx = [
            {s: k for k, s in enumerate(self.S[i])} for i in range(self.n)
        ]
        self.E = sorted(E, key=lambda e: (_domain_sort_key(e)))
        self.eidx = {e: k for k, e in enumerate(self.E)}
        self.T = [sorted(T[i], key=_domain_sort_key) for i in range(self.n)]
        self.tidx = [
            {t: k for k, t in enumerate(self.T[i])} for i in range(self.n)
        ]
        self.H = sorted(H, key=_domain_sort_key)
        self.hidx = {h: k for k, h in enumerate(self.H)}
        self._expandable_s = expandable_s
        self._expandable_h = expandable_h
        #: per actor, over ``S[i]``: the local states the overapprox
        #: closure kept without expanding (outside closure_actor_bound).
        #: Their deliver and timeout transitions are not in the tables,
        #: so a run that expands a state holding one raises
        #: (:meth:`unexpanded_rows`) instead of undercounting.
        self._unexpanded = [
            np.array([self.closure_mode == "overapprox"
                      and not expandable_s[i][s] for s in self.S[i]], bool)
            for i in range(self.n)
        ]

    def _harvest_reachable(self, model, init, add_actor_state,
                           add_envelope, add_timer, add_history,
                           run_msg, run_timeout, run_history) -> None:
        """Breadth-first host exploration; harvest component domains
        and exactly the (state, event) pairs that co-occur in reachable
        system states. Sound for the device engine because it explores
        the same space: only harvested pairs are ever gathered."""
        seen = {init}
        queue = deque([init])
        #: ordered only: per-channel max observed queue length
        self._q_bound: dict = {}
        while queue:
            st = queue.popleft()
            for i, s in enumerate(st.actor_states):
                add_actor_state(i, s)
            present = set(st.network.iter_all())
            for env in present:
                add_envelope(env)
            if self.ordered:
                for ch, flow in st.network.flows.items():
                    self._q_bound[ch] = max(
                        self._q_bound.get(ch, 0), len(flow)
                    )
            for i, timers in enumerate(st.timers_set):
                for t in timers:
                    add_timer(i, t)
            add_history(st.history)
            prev_channel = None
            for env in st.network.iter_deliverable():
                i = int(env.dst)
                if i >= self.n or st.crashed[i]:
                    continue
                if self.ordered:
                    # FIFO: only channel heads are deliverable, and a
                    # no-op handler still pops the queue and records
                    # history (model.rs:252-266, 317-319 exception).
                    channel = (env.src, env.dst)
                    if prev_channel == channel:
                        continue
                    prev_channel = channel
                run_msg(i, st.actor_states[i], env)
                tr = self._msg_tr[(i, st.actor_states[i], env)]
                if self.ordered or not tr[1]:
                    run_history(st.history, env, tr[2])
            for i, timers in enumerate(st.timers_set):
                for t in timers:
                    run_timeout(i, st.actor_states[i], t)
                    tr = self._tmo_tr[(i, st.actor_states[i], t)]
                    if not tr[1]:
                        run_history(st.history, None, tr[2])
            for action in model.actions(st):
                ns = model.next_state(st, action)
                if ns is None or not model.within_boundary(ns):
                    continue
                if ns not in seen:
                    if len(seen) >= self.closure_max_states:
                        raise RuntimeError(
                            f"reachable closure exceeded "
                            f"{self.closure_max_states} system states; "
                            "raise closure_max_states or use overapprox "
                            "mode with bounds"
                        )
                    seen.add(ns)
                    queue.append(ns)

    def _declared_queue_bound(self, ch) -> int:
        """Resolve ``closure_queue_bound`` for channel ``ch`` =
        (src, dst): int (uniform), {(src, dst): depth} (int actor
        ids), or callable (src, dst) -> depth. 0 when undeclared."""
        decl = self._queue_bound_decl
        if decl is None:
            return 0
        if isinstance(decl, int):
            return decl
        key = (int(ch[0]), int(ch[1]))
        if isinstance(decl, dict):
            return int(decl.get(key, decl.get(ch, 0)))
        return int(decl(*key))

    def _fold_commands(self, id: Id, out: Out):
        """Sends in emission order + net timer effect (last op wins,
        mirroring _process_commands's sequential set algebra)."""
        sends: list[Envelope] = []
        tmap: dict[Any, bool] = {}
        for cmd in out.commands:
            if isinstance(cmd, Send):
                sends.append(Envelope(id, cmd.dst, cmd.msg))
            elif isinstance(cmd, SetTimer):
                tmap[cmd.timer] = True
            elif isinstance(cmd, CancelTimer):
                tmap[cmd.timer] = False
            else:
                raise TypeError(f"unknown command {cmd!r}")
        return tuple(sends), tmap

    def _effect_classes(self) -> list:
        """Distinct (env_in | None, sends) history-event signatures.
        Ordered networks record history on NO-OP deliveries too (the
        pop itself is the transition; model.rs:317-319 exception)."""
        seen = {}
        for (i, s, env), (s2, noop, sends, tmap) in self._msg_tr.items():
            if self.ordered or not noop:
                seen.setdefault((env, sends), None)
        for (i, s, t), (s2, noop, sends, tmap) in self._tmo_tr.items():
            if not noop:
                seen.setdefault((None, sends), None)
        return list(seen)

    # -- layout ----------------------------------------------------------

    def _build_layout(self) -> None:
        lb = _LayoutBuilder()
        self.f_actor = [lb.add(_bits_for(len(self.S[i]))) for i in
                        range(self.n)]
        self.f_history = lb.add(_bits_for(len(self.H)))
        self.f_crashed = [lb.add(1) for _ in range(self.n)]
        self.f_timer = [
            [lb.add(1) for _ in self.T[i]] for i in range(self.n)
        ]
        if self.ordered:
            # FIFO channels as INTEGER QUEUES: channel (src, dst) with
            # message alphabet A holds its queue as a base-(|A|+1)
            # number, head = least-significant digit (digit 0 = empty
            # slot, codes 1..|A|). Canonical by construction (one
            # integer per queue content), pop = divide by base, push =
            # add code*base^len — no ring pointers, no shifting
            # (encoding.py's "FIFO channels become fixed rings" design,
            # realized arithmetically).
            chans: dict = {}
            for env in self.E:
                chans.setdefault((env.src, env.dst), []).append(env)
            self.channels = sorted(chans, key=lambda c: (int(c[0]),
                                                         int(c[1])))
            self.chidx = {c: k for k, c in enumerate(self.channels)}
            #: per channel: sorted message list and msg -> 1-based code
            self.ch_msgs = {}
            self.ch_code = {}
            for ch, envs in chans.items():
                msgs = sorted(
                    {e.msg for e in envs}, key=_domain_sort_key
                )
                self.ch_msgs[ch] = msgs
                self.ch_code[ch] = {m: j + 1 for j, m in enumerate(msgs)}
            #: per channel: queue-length bound (harvested in reachable
            #: mode, declared via closure_queue_bound in overapprox
            #: mode; with both, the max wins so a declared bound can
            #: never shrink below what the host exploration observed)
            #: and base
            harvested = getattr(self, "_q_bound", {})
            self.ch_q = {}
            for ch in self.channels:
                q = max(
                    1,
                    harvested.get(ch, 0),
                    self._declared_queue_bound(ch),
                )
                # A DECLARED (not harvested) bound is a safety
                # ceiling, not an observed depth: cap it to the
                # deepest queue the 32-bit lane can hold at this
                # channel's alphabet. If the cap ever truncates a
                # reachable queue, the engines' truncation flag
                # raises — loud, never silent.
                if q > harvested.get(ch, 0):
                    base = len(self.ch_msgs[ch]) + 1
                    fit = q
                    while fit > 1 and (base**fit - 1).bit_length() > 32:
                        fit -= 1
                    if fit < q and fit > harvested.get(ch, 0):
                        import warnings

                        warnings.warn(
                            f"ordered channel {ch}: declared queue "
                            f"bound {q} needs more than one uint32 "
                            f"lane at alphabet {base - 1}; capped to "
                            f"{fit} (a reachable queue beyond the cap "
                            "raises the truncation error)",
                            RuntimeWarning,
                            stacklevel=2,
                        )
                        q = fit
                self.ch_q[ch] = q
            self.ch_base = {
                ch: len(self.ch_msgs[ch]) + 1 for ch in self.channels
            }
            self.f_ch = []
            for ch in self.channels:
                span = self.ch_base[ch] ** self.ch_q[ch]
                bits = max(1, (span - 1).bit_length())
                if bits > 32:
                    raise ValueError(
                        f"ordered channel {ch} needs {bits} queue bits "
                        f"(alphabet {len(self.ch_msgs[ch])}, max depth "
                        f"{self.ch_q[ch]}) — exceeds one uint32 lane; "
                        "bound the model or use the host checkers"
                    )
                self.f_ch.append(lb.add(bits))
            self.f_net = []
            self.width = lb.width
            self._net_top_mask = np.zeros(self.width, np.uint32)
        else:
            # Network: 1 bit per envelope (duplicating set) or an 8-bit
            # count per envelope (non-duplicating multiset).
            bits = 1 if self.dup else 8
            self.f_net = [lb.add(bits) for _ in self.E]
            self.width = lb.width
            # Per-lane mask of every count field's TOP bit: a successor
            # with any count ≥ 128 is treated as beyond an implicit
            # bound and pruned (valid=False) rather than risking a
            # carry into the neighboring field — the device-side
            # counterpart of encode()'s loud 8-bit check.
            # Closure-bounded systems stay far below this.
            self._net_top_mask = np.zeros(self.width, np.uint32)
            if not self.dup:
                for f in self.f_net:
                    self._net_top_mask[f.lane] |= np.uint32(
                        1 << (f.shift + bits - 1)
                    )

        # Action slots: delivers, drops, timeouts, crashes.
        self.deliver_slots = [
            k for k, e in enumerate(self.E) if int(e.dst) < self.n
        ]
        self.drop_slots = list(range(len(self.E))) if self.lossy else []
        self.timeout_slots = [
            (i, j) for i in range(self.n) for j in range(len(self.T[i]))
        ]
        self.crash_slots = (
            list(range(self.n)) if self.max_crashes > 0 else []
        )
        self.max_actions = (
            len(self.deliver_slots)
            + len(self.drop_slots)
            + len(self.timeout_slots)
            + len(self.crash_slots)
        )
        if self.max_actions == 0:
            self.max_actions = 1  # engines require K >= 1

    # -- tables ----------------------------------------------------------

    def _tr_effects(self, i: int, tr, fired_timer=None, force=False):
        """(next_state_idx, noop, net_delta[W], timer_and[W], timer_or[W],
        snd_ch[SMAX], snd_code[SMAX]) for one transition record.
        ``force`` applies the effects even for a no-op (ordered
        deliveries: the queue pop is a transition regardless)."""
        s2, noop, sends, tmap = tr
        apply = force or not noop
        next_idx = self.sidx[i][s2] if apply else 0
        net_delta = np.zeros(self.width, np.uint32)
        snd_ch = np.zeros(self._smax, np.uint32)
        snd_code = np.zeros(self._smax, np.uint32)
        if apply:
            for j, env in enumerate(sends):
                if self.ordered:
                    ch = (env.src, env.dst)
                    snd_ch[j] = self.chidx[ch]
                    snd_code[j] = self.ch_code[ch][env.msg]
                else:
                    f = self.f_net[self.eidx[env]]
                    if self.dup:
                        net_delta[f.lane] |= np.uint32(1 << f.shift)
                    else:
                        net_delta[f.lane] += np.uint32(1 << f.shift)
        t_and = np.full(self.width, 0xFFFFFFFF, np.uint32)
        t_or = np.zeros(self.width, np.uint32)
        if fired_timer is not None:
            f = self.f_timer[i][self.tidx[i][fired_timer]]
            t_and[f.lane] &= ~np.uint32(1 << f.shift)
        if apply:
            for t, armed in tmap.items():
                f = self.f_timer[i][self.tidx[i][t]]
                if armed:
                    t_or[f.lane] |= np.uint32(1 << f.shift)
                    t_and[f.lane] |= np.uint32(1 << f.shift)
                else:
                    t_and[f.lane] &= ~np.uint32(1 << f.shift)
                    t_or[f.lane] &= ~np.uint32(1 << f.shift)
        return next_idx, noop, net_delta, t_and, t_or, snd_ch, snd_code

    def _build_tables(self) -> None:
        classes = self._effect_classes()
        cls_idx = {c: k for k, c in enumerate(classes)}
        n_cls = max(1, len(classes))
        #: max sends per applied transition (send-sequence columns)
        self._smax = max(
            [1]
            + [
                len(tr[2])
                for tr in self._msg_tr.values()
                if self.ordered or not tr[1]
            ]
            + [len(tr[2]) for tr in self._tmo_tr.values() if not tr[1]]
        )

        # Per deliver slot: tables indexed by the dst actor's state idx.
        self.tbl_deliver = []
        for k in self.deliver_slots:
            env = self.E[k]
            i = int(env.dst)
            ns = len(self.S[i])
            nxt = np.zeros(ns, np.uint32)
            noop = np.ones(ns, bool)
            ndl = np.zeros((ns, self.width), np.uint32)
            tan = np.full((ns, self.width), 0xFFFFFFFF, np.uint32)
            tor = np.zeros((ns, self.width), np.uint32)
            hcl = np.zeros(ns, np.uint32)
            sch = np.zeros((ns, self._smax), np.uint32)
            scd = np.zeros((ns, self._smax), np.uint32)
            for si, s in enumerate(self.S[i]):
                tr = self._msg_tr.get((i, s, env))
                if tr is None:
                    continue  # unexpandable state: row never used
                (nxt[si], noop[si], ndl[si], tan[si], tor[si],
                 sch[si], scd[si]) = self._tr_effects(
                    i, tr, force=self.ordered
                )
                if self.ordered:
                    if (i, s, env) in self._raised_msg:
                        # A raising handler is NOT a pop: keep the
                        # row undeliverable (see _raised_msg notes).
                        noop[si] = True
                    else:
                        # Ordered records history on no-op pops too.
                        noop[si] = False
                        hcl[si] = cls_idx[(env, tr[2])]
                elif not noop[si]:
                    hcl[si] = cls_idx[(env, tr[2])]
            self.tbl_deliver.append(
                (i, k, nxt, noop, ndl, tan, tor, hcl, sch, scd)
            )

        self.tbl_timeout = []
        for (i, j) in self.timeout_slots:
            t = self.T[i][j]
            ns = len(self.S[i])
            nxt = np.zeros(ns, np.uint32)
            noop = np.ones(ns, bool)
            ndl = np.zeros((ns, self.width), np.uint32)
            tan = np.full((ns, self.width), 0xFFFFFFFF, np.uint32)
            tor = np.zeros((ns, self.width), np.uint32)
            hcl = np.zeros(ns, np.uint32)
            sch = np.zeros((ns, self._smax), np.uint32)
            scd = np.zeros((ns, self._smax), np.uint32)
            for si, s in enumerate(self.S[i]):
                tr = self._tmo_tr.get((i, s, t))
                if tr is None:
                    continue
                (nxt[si], noop[si], ndl[si], tan[si], tor[si],
                 sch[si], scd[si]) = self._tr_effects(
                    i, tr, fired_timer=t
                )
                if not noop[si]:
                    hcl[si] = cls_idx[(None, tr[2])]
            self.tbl_timeout.append(
                (i, j, nxt, noop, ndl, tan, tor, hcl, sch, scd)
            )

        # History table: H × effect classes. Un-harvested (h, class)
        # transitions (h beyond closure_history_bound — reachable only
        # when a search continues past a violating state, or when the
        # bound is tighter than the model boundary) are tracked in a
        # parallel missing-mask and surfaced through the engines'
        # truncation flag; defaulting them to history 0 silently
        # corrupted post-violation successors.
        # Only the PACKED form is kept: history index in bits 0-30
        # (bounded far below 2^31 by max_domain), missing flag in bit
        # 31 — one gather serves both in the per-pair/per-slot step.
        hist = np.zeros((len(self.H), n_cls), np.uint32)
        missing = np.ones((len(self.H), n_cls), bool)
        # Sentinel lookup, NOT .get(key) is-None: a history-free model
        # (init_history=None) legitimately stores None as the harvested
        # next-history value, and conflating that with "key absent"
        # marked EVERY deliver/timeout missing — hard-truncating the
        # whole model on its first wave.
        _absent = object()
        for hi, h in enumerate(self.H):
            for ci, cls in enumerate(classes):
                h2 = self._hist_tr.get((h, cls[0], cls[1]), _absent)
                if h2 is not _absent:
                    hist[hi, ci] = self.hidx[h2]
                    missing[hi, ci] = False
        self.tbl_history_packed = hist | (
            missing.astype(np.uint32) << 31
        )
        self.n_cls = n_cls
        self._build_sparse_tables()

    # -- sparse dispatch tables (SparseEncodedModel) ----------------------
    #
    # The per-slot tables re-laid-out for slot indices that vary per
    # pair, so the sort-merge engine (checkers/tpu_sortmerge.py) runs
    # the transition on compacted (row, slot) pairs only. Layout is
    # gather-lean: all per-slot constants pack into ONE [A, 14] params
    # row, all per-(slot, actor-state) transition effects into ONE
    # [R, 3W+3+2*SMAX] flat row, and every lane read/write is a
    # per-lane select — never a dynamic-index scatter.
    #
    # Params row layout (uint32):
    #   0 kind (0=deliver, 1=drop, 2=timeout, 3=crash, 4=pad)
    #   1 actor index (deliver dst / timeout owner / crash target)
    #   2 flat-table row offset (deliver/timeout)
    #   3 actor-state field lane   4 shift   5 mask
    #   6 net/queue field lane     7 shift   8 mask   (deliver/drop)
    #   9 timer/crashed field lane 10 shift
    #   11 channel base (ordered deliver; 0 otherwise)
    #   12 head code (ordered deliver)
    #   13 channel index (ordered deliver)
    # Flat transition row layout: [nxt, noop, hcl] + ndl[W] + tan[W]
    # + tor[W] + snd_ch[SMAX] + snd_code[SMAX].

    _SK_DELIVER, _SK_DROP, _SK_TIMEOUT, _SK_CRASH, _SK_PAD = range(5)

    def _build_sparse_tables(self) -> None:
        W = self.width
        A = self.max_actions
        params = np.zeros((A, 14), np.uint32)
        params[:, 0] = self._SK_PAD
        flat_rows: list = []

        def flat_of(tbl) -> int:
            """Append one per-state transition block; return its base
            row. tbl = (nxt, noop, ndl, tan, tor, hcl, sch, scd) arrays
            over the dst actor's state domain."""
            nxt, noop, ndl, tan, tor, hcl, sch, scd = tbl
            base = len(flat_rows)
            for si in range(len(nxt)):
                flat_rows.append(
                    np.concatenate(
                        [
                            np.array(
                                [nxt[si], np.uint32(bool(noop[si])),
                                 hcl[si]],
                                np.uint32,
                            ),
                            ndl[si], tan[si], tor[si],
                            sch[si], scd[si],
                        ]
                    )
                )
            return base

        a = 0
        for (i, k, nxt, noop, ndl, tan, tor, hcl, sch, scd) in (
            self.tbl_deliver
        ):
            f = self.f_actor[i]
            row = [
                self._SK_DELIVER, i,
                flat_of((nxt, noop, ndl, tan, tor, hcl, sch, scd)),
                f.lane, f.shift, (1 << f.bits) - 1,
                0, 0, 0, 0, 0, 0, 0, 0,
            ]
            if self.ordered:
                env = self.E[k]
                ch = (env.src, env.dst)
                ci = self.chidx[ch]
                fq = self.f_ch[ci]
                row[6:9] = [fq.lane, fq.shift, (1 << fq.bits) - 1]
                row[11] = self.ch_base[ch]
                row[12] = self.ch_code[ch][env.msg]
                row[13] = ci
            else:
                fn = self.f_net[k]
                row[6:9] = [fn.lane, fn.shift, (1 << fn.bits) - 1]
            params[a] = row
            a += 1
        for k in self.drop_slots:
            fn = self.f_net[k]
            params[a] = [
                self._SK_DROP, 0, 0, 0, 0, 0,
                fn.lane, fn.shift, (1 << fn.bits) - 1, 0, 0, 0, 0, 0,
            ]
            a += 1
        for (i, j, nxt, noop, ndl, tan, tor, hcl, sch, scd) in (
            self.tbl_timeout
        ):
            f, ft = self.f_actor[i], self.f_timer[i][j]
            params[a] = [
                self._SK_TIMEOUT, i,
                flat_of((nxt, noop, ndl, tan, tor, hcl, sch, scd)),
                f.lane, f.shift, (1 << f.bits) - 1,
                0, 0, 0, ft.lane, ft.shift, 0, 0, 0,
            ]
            a += 1
        for i in self.crash_slots:
            fc = self.f_crashed[i]
            params[a] = [
                self._SK_CRASH, i, 0, 0, 0, 0, 0, 0, 0,
                fc.lane, fc.shift, 0, 0, 0,
            ]
            a += 1

        self._sp_params = params
        self._sp_flat = (
            np.stack(flat_rows)
            if flat_rows
            else np.zeros((1, 3 + 3 * W + 2 * self._smax), np.uint32)
        )
        self._sp_hist_flat = self.tbl_history_packed.reshape(-1)
        # Crash: per-actor [W] AND-mask clearing every timer bit.
        cr = np.full((max(1, self.n), W), 0xFFFFFFFF, np.uint32)
        for i in range(self.n):
            for ftm in self.f_timer[i]:
                cr[i, ftm.lane] &= ~np.uint32(1 << ftm.shift)
        self._sp_crash_and = cr

        # Per-slot specs for the PACKED bitmap mask (enabled_bits_cols):
        # the same slot order as params, but with each slot's
        # (state-indexed) not-noop table pre-packed into host-constant
        # bit words, so the device mask is pure shift-mask ALU — no
        # per-slot table gathers, no dense [F, K] bool.
        mask_slots: list = []
        for (i, k, nxt, noop, ndl, tan, tor, hcl, sch, scd) in (
            self.tbl_deliver
        ):
            mask_slots.append(("deliver", i, k, pack_bits_host(~noop)))
        for k in self.drop_slots:
            mask_slots.append(("drop", k))
        for (i, j, nxt, noop, ndl, tan, tor, hcl, sch, scd) in (
            self.tbl_timeout
        ):
            mask_slots.append(("timeout", i, j, pack_bits_host(~noop)))
        for i in self.crash_slots:
            mask_slots.append(("crash", i))
        self._mask_slots = mask_slots

    # -- codegen optimizer -------------------------------------------------

    def _optimize_codegen(self) -> None:
        """Post-``_build_tables`` table/emission rewrite: computes the
        host-side plan that :meth:`enabled_bits_cols` /
        :meth:`step_slot_cols` run from (the JAX package's optimized
        emission), leaving the naive tables intact.

        * **Effect-class fusion** — deliver and timeout collapse into
          ONE table class: timeout rows carry all-zero channel/envelope
          params, so the deliver formula (nondup decrement, ordered
          head pop) degenerates to the identity on them and the kind
          switch disappears. The drop and crash branches are emitted
          only when such slots exist; with neither, the 4-way select
          ladder and the kind column vanish entirely.
        * **Table interning + constant-column pruning** — duplicate
          per-state effect blocks share one flat base (host interning
          by block bytes); table columns that are constant over every
          row become immediates, shrinking the two row gathers to the
          columns that actually vary. A params/flat gather whose every
          read column is constant is dropped altogether.
        * **History / crash elision** — a single-valued, fully
          harvested history domain drops the packed history gather,
          the history field write, and the hard-truncation flag; a
          crash-free model drops the crash AND-mask gather and the
          per-actor crashed gating on deliver guards.
        * **Word-level mask plan** — the enabled mask is rebuilt from
          condition-gated host class masks (ops/bitmask.py:
          ``slot_mask_host`` / ``or_class_words`` /
          ``select_words_host`` — the hand encodings' idiom) with
          single-bit presence extracts coalesced into word runs
          (``bit_run_plan``), instead of per-slot lane predicates.
        """
        W = self.width
        A = self.max_actions
        real = [
            a for a in range(A)
            if self._sp_params[a, 0] != self._SK_PAD
        ]
        table_slots = [
            a for a in real
            if self._sp_params[a, 0]
            in (self._SK_DELIVER, self._SK_TIMEOUT)
        ]
        if not table_slots:
            return  # degenerate encoding: nothing to rewrite
        hist = self._sp_hist_flat
        trivial_history = (
            len(self.H) == 1
            and not (hist >> np.uint32(31)).any()
            and not (hist & np.uint32(0x7FFFFFFF)).any()
        )
        has_drop = any(
            self._sp_params[a, 0] == self._SK_DROP for a in real
        )
        has_crash = any(
            self._sp_params[a, 0] == self._SK_CRASH for a in real
        )

        # (a) flat-block interning: duplicate effect blocks share one
        # base row (paxos-style identical-effect envelopes); a dead
        # history-class column is zeroed first so it can't defeat
        # sharing.
        params = self._sp_params.copy()
        fw = self._sp_flat.shape[1]
        blocks: dict = {}
        new_rows: list = []
        for a in table_slots:
            i = int(params[a, 1])
            ns = len(self.S[i])
            base = int(params[a, 2])
            blk = self._sp_flat[base : base + ns].copy()
            if trivial_history:
                blk[:, 2] = 0
            key = blk.tobytes()
            if key not in blocks:
                blocks[key] = len(new_rows)
                new_rows.extend(blk)
            params[a, 2] = blocks[key]
        flat2 = (
            np.stack(new_rows).astype(np.uint32)
            if new_rows
            else np.zeros((1, fw), np.uint32)
        )

        # Constant-column pruning over the columns the emission READS
        # (the noop column is never read by the sparse step; send
        # columns only exist for ordered networks). Pad params rows are
        # rewritten to copies of a real row first — they are never
        # enabled, never stepped, and must not defeat constancy.
        for a in range(A):
            if self._sp_params[a, 0] == self._SK_PAD:
                params[a] = params[real[0]]

        read_f = [0]
        if not trivial_history:
            read_f.append(2)
        read_f += [3 + j for j in range(3 * W)]
        if self.ordered:
            read_f += [3 + 3 * W + j for j in range(2 * self._smax)]
        keep_f: list = []
        fcol: dict = {}
        for c in read_f:
            col = flat2[:, c]
            if (col == col[0]).all():
                fcol[c] = ("c", int(col[0]))
            else:
                fcol[c] = ("v", len(keep_f))
                keep_f.append(c)
        flat_opt = flat2[:, keep_f] if keep_f else None

        read_p = [2, 3, 4, 5]
        if has_drop or has_crash:
            read_p.insert(0, 0)
        if has_crash:
            read_p += [1, 9, 10]
        if self.ordered:
            read_p += [6, 7, 8, 11]
        elif (not self.dup) or has_drop:
            read_p += [6, 7, 8]
        if flat_opt is None:
            read_p.remove(2)  # no flat gather left to base-index
        keep_p: list = []
        pcol: dict = {}
        for c in sorted(read_p):
            col = params[:, c]
            if (col == col[0]).all():
                pcol[c] = ("c", int(col[0]))
            else:
                pcol[c] = ("v", len(keep_p))
                keep_p.append(c)
        params_opt = params[:, keep_p] if keep_p else None

        # (b) the word-level mask plan: guard groups keyed by (actor,
        # packed not-noop table, crash gating) — every slot of a group
        # shares ONE device condition; single-bit presence sources
        # (dup envelope bits, timer armed bits) coalesce into runs.
        L = mask_words(A)
        groups: dict = {}
        run_sources: list = []
        slot_pres: list = []
        pres_const_slots: list = []
        guardless: list = []
        crash_conds: list = []
        gate = self.max_crashes > 0
        for a, spec in enumerate(self._mask_slots):
            kind = spec[0]
            if kind == "deliver":
                _, i, k, nn = spec
                groups.setdefault((i, nn, gate), []).append(a)
                if self.ordered:
                    slot_pres.append((a, ("ord", k)))
                elif self.dup and self.f_net[k].bits == 1:
                    f = self.f_net[k]
                    run_sources.append((a, f.lane, f.shift))
                else:
                    slot_pres.append((a, ("net", k)))
            elif kind == "timeout":
                _, i, j, nn = spec
                groups.setdefault((i, nn, False), []).append(a)
                ft = self.f_timer[i][j]
                run_sources.append((a, ft.lane, ft.shift))
            elif kind == "drop":
                k = spec[1]
                guardless.append(a)
                if self.dup and self.f_net[k].bits == 1:
                    f = self.f_net[k]
                    run_sources.append((a, f.lane, f.shift))
                else:
                    slot_pres.append((a, ("net", k)))
            else:  # crash
                i = spec[1]
                pres_const_slots.append(a)
                crash_conds.append((i, slot_mask_host(A, [a])))

        # Small-domain actors with several ungated guard groups fold
        # into ONE select_words_host row table (one where-chain over
        # the domain replaces all that actor's bit_selects); everyone
        # else stays a bit_select-gated class.
        by_actor: dict = {}
        for (i, nn, g), slots in sorted(groups.items()):
            by_actor.setdefault(i, []).append((nn, g, slots))
        sel_actors: dict = {}
        bitsel: list = []
        for i, gs in sorted(by_actor.items()):
            ns = len(self.S[i])
            if ns <= 16 and len(gs) >= 2 and not any(g for _, g, _ in gs):
                rows = []
                for v in range(ns):
                    w = [0] * L
                    for nn, _, slots in gs:
                        if (nn[v // 32] >> (v % 32)) & 1:
                            sw = slot_mask_host(A, slots)
                            for x in range(L):
                                w[x] |= sw[x]
                    rows.append(tuple(w))
                sel_actors[i] = rows
            else:
                for nn, g, slots in gs:
                    bitsel.append((i, nn, g, slot_mask_host(A, slots)))

        runs = bit_run_plan(A, run_sources)
        self._opt = dict(
            trivial_history=trivial_history,
            has_drop=has_drop,
            has_crash=has_crash,
            params=params_opt,
            pcol=pcol,
            flat=flat_opt,
            fcol=fcol,
            mask=dict(
                runs=runs,
                slot_pres=slot_pres,
                pres_const=slot_mask_host(A, pres_const_slots),
                guardless=slot_mask_host(A, guardless),
                sel_actors=sel_actors,
                bitsel=bitsel,
                crash_conds=crash_conds,
            ),
        )
        self.codegen_opt = {
            "fused_switch": not (has_drop or has_crash),
            "history_gather_elided": trivial_history,
            "crash_gather_elided": not has_crash,
            "flat_rows": [int(self._sp_flat.shape[0]),
                          int(flat2.shape[0])],
            "flat_cols": [int(fw), len(keep_f)],
            "params_cols": [14, len(keep_p)],
            "step_gathers": (
                int(params_opt is not None)
                + int(flat_opt is not None)
                + int(not trivial_history)
                + int(has_crash)
            ),
            "mask_guard_selects": len(sel_actors),
            "mask_guard_classes": len(bitsel),
            "mask_bit_runs": len(runs),
            "mask_per_slot": len(slot_pres),
            "k": int(A),
        }

    # -- device side ------------------------------------------------------

    def _network_plan(self, fn) -> list:
        """Host plan of ``_SpecCtx.network_any(fn)``: per channel, the
        codes of the matching envelopes (ordered), or per lane, the
        union of their count fields (unordered)."""
        if self.ordered:
            codes: dict = {}
            for env in self.E:
                if fn(env):
                    ch = (env.src, env.dst)
                    codes.setdefault(self.chidx[ch], []).append(
                        self.ch_code[ch][env.msg])
            return sorted(codes.items())
        masks: dict = {}
        for k, env in enumerate(self.E):
            if fn(env):
                f = self.f_net[k]
                masks[f.lane] = masks.get(f.lane, 0) | f.mask
        return sorted(masks.items())

    def _device_consts(self, device) -> dict:
        """The plan's tables as int64 tensors on ``device``, made once
        per device: the pruned params and flat transition tables, the
        packed history table, the crash AND-masks, and the mask plan's
        row tables and class words (a table copied to the card inside a
        wave would stall the stream once a copy)."""
        device = torch.device(device)
        cache = self.__dict__.setdefault("_dev", {})
        if device in cache:
            return cache[device]
        plan = self._opt
        mp = plan["mask"]

        def table(a):
            if a is None:
                return None
            return torch.from_numpy(
                np.asarray(a, np.uint32).astype(np.int64)).to(device)

        cache[device] = dict(
            params=table(plan["params"]),
            flat=table(plan["flat"]),
            hist=table(self._sp_hist_flat),
            crash_and=table(self._sp_crash_and),
            sel_rows={i: const_words(rows, device)
                      for i, rows in mp["sel_actors"].items()},
            bitsel=[(const_words(nn, device), const_words(words, device))
                    for _, nn, _, words in mp["bitsel"]],
            crash_words=[const_words(words, device)
                         for _, words in mp["crash_conds"]],
            guardless=const_words(mp["guardless"], device),
        )
        return cache[device]

    def unexpanded_rows(self, states_t: torch.Tensor):
        """``bool[N]``: the rows of a ``[W, N]`` block holding a local
        state the closure kept without expanding, or None when it
        expanded every state. Such a row's deliver and timeout
        transitions are missing from the tables, so expanding it would
        undercount: the dense step ORs this into its ``trunc``, and the
        sort-merge engine's sparse wave checks its frontier with it
        once a wave (checkers/tpu_sortmerge.py); either way the engine
        raises the truncation error. The JAX compiler does not flag
        them."""
        dev = states_t.device
        cache = self.__dict__.setdefault("_unexpanded_dev", {})
        if dev not in cache:
            cache[dev] = [(i, torch.from_numpy(u).to(dev))
                          for i, u in enumerate(self._unexpanded) if u.any()]
        rows = None
        for i, u in cache[dev]:
            hit = _take(u, _field(states_t, self.f_actor[i]))
            rows = hit if rows is None else rows | hit
        return rows

    def enabled_bits_cols(self, states_t: torch.Tensor) -> torch.Tensor:
        """``int64[N, L]`` packed enabled words (ops/bitmask.py layout)
        over a ``[W, N]`` block: presence words (coalesced bit runs,
        per-slot leftovers, crash constants) AND guard words (per
        small-domain-actor row selects, condition-gated classes) — the
        JAX ``_enabled_bits_opt`` plan, batched.

        Semantics are the dense successor validity except the
        count-bound and queue-bound pruning, which
        :meth:`step_slot_cols` reports as its truncation flag."""
        c = self._device_consts(states_t.device)
        mp = self._opt["mask"]
        L = mask_words(self.max_actions)
        n = states_t.shape[1]

        def fx(f):
            return _field(states_t, f)

        need_idx = set(mp["sel_actors"]) | {b[0] for b in mp["bitsel"]}
        s_idx = {i: fx(self.f_actor[i]) for i in sorted(need_idx)}
        need_cr = {b[0] for b in mp["bitsel"] if b[2]} | {
            i for i, _ in mp["crash_conds"]
        }
        crashed = {i: fx(self.f_crashed[i]) != 0 for i in sorted(need_cr)}
        if mp["crash_conds"]:
            ncr = sum(fx(self.f_crashed[i]) for i in range(self.n))
            can_crash = ncr < self.max_crashes

        pres = or_bit_runs(states_t, mp["runs"], L)
        for a, spec in mp["slot_pres"]:
            if spec[0] == "ord":
                env = self.E[spec[1]]
                ch = (env.src, env.dst)
                b = (fx(self.f_ch[self.chidx[ch]]) % self.ch_base[ch]) \
                    == self.ch_code[ch][env.msg]
            else:
                b = fx(self.f_net[spec[1]]) != 0
            w, p = a // 32, a % 32
            t = b.to(torch.int64) << p
            pres[w] = t if pres[w] is None else pres[w] | t
        for w in range(L):
            cw = mp["pres_const"][w]
            if cw:
                pres[w] = (
                    torch.full((n,), cw, dtype=torch.int64,
                               device=states_t.device)
                    if pres[w] is None else pres[w] | cw
                )

        guard = None
        for i in sorted(mp["sel_actors"]):
            term = select_words_host(c["sel_rows"][i], s_idx[i])
            guard = term if guard is None else guard | term
        classes = []
        for (i, _nn, g, _w), (nn_t, words_t) in zip(mp["bitsel"],
                                                    c["bitsel"]):
            cond = bit_select(nn_t, s_idx[i]) != 0
            if g:
                cond = cond & ~crashed[i]
            classes.append((cond, words_t))
        for (i, _w), words_t in zip(mp["crash_conds"], c["crash_words"]):
            classes.append((~crashed[i] & can_crash, words_t))
        if classes:
            cls = or_class_words(classes, L)
            guard = cls if guard is None else guard | cls
        if any(mp["guardless"]):
            gw = c["guardless"]
            guard = gw if guard is None else guard | gw

        zero = torch.zeros(n, dtype=torch.int64, device=states_t.device)
        cols = []
        for w in range(L):
            word = pres[w]
            if word is None:
                cols.append(zero)
                continue
            if guard is not None:
                word = word & guard[..., w]
            cols.append(word)
        return torch.stack(cols, dim=1)

    def step_slot_cols(self, states_t: torch.Tensor, slots: torch.Tensor):
        """``(succ_t [W, N], trunc, hard)`` for the (state, enabled slot)
        pairs of a ``[W, N]`` block: the JAX ``_step_slot_opt`` plan,
        batched — the surviving row gathers (pruned params/flat
        columns), the fused deliver/timeout table path, the select
        ladder only over the effect classes that exist, and writes only
        on lanes some effect can touch (an untouched lane is the
        input's). ``trunc`` (count or queue bound) and ``hard``
        (un-harvested history transition) are ``bool[N]``, or ``None``
        where the plan can never set them. A source state holding an
        actor state the closure did not expand is not flagged here: the
        engine checks its frontier (:meth:`unexpanded_rows`)."""
        c = self._device_consts(states_t.device)
        plan = self._opt
        W = self.width
        prow = c["params"][slots] if c["params"] is not None else None

        def pc(col):
            tag, v = plan["pcol"][col]
            return v if tag == "c" else prow[:, v]

        lanes = [states_t[j] for j in range(W)]

        def lane_sel(vals, idx):
            if isinstance(idx, int):
                return vals[idx]
            v = vals[0]
            for j in range(1, W):
                v = torch.where(idx == j, vals[j], v)
            return v

        def shl(x, s):
            if isinstance(x, int) and not isinstance(s, int):
                x = torch.full_like(s, x)
            return x << s

        al, ash, am = pc(3), pc(4), pc(5)
        s_idx = (lane_sel(lanes, al) >> ash) & am
        if c["flat"] is not None:
            F = c["flat"]
            frow = F[(pc(2) + s_idx).clamp(max=F.shape[0] - 1)]

        def fc(col):
            tag, v = plan["fcol"][col]
            return v if tag == "c" else frow[:, v]

        def fconst(col):
            tag, v = plan["fcol"][col]
            return v if tag == "c" else None

        nxt = fc(0)
        trivial_h = plan["trivial_history"]
        if not trivial_h:
            h_idx = _field(states_t, self.f_history)
            hg = _take(c["hist"], h_idx * self.n_cls + fc(2))
            h2 = hg & 0x7FFFFFFF
            h_missing = (hg >> 31) != 0
        hf = self.f_history
        amask = shl(am, ash) & _M32
        aval = shl(nxt & am, ash) & _M32

        app = []
        for j in range(W):
            v = lanes[j]
            if isinstance(al, int):
                if al == j:
                    v = (v & ~amask) | aval
            else:
                v = torch.where(al == j, (v & ~amask) | aval, v)
            if fconst(3 + j) != 0:
                d = fc(3 + j)
                v = (v | d) if self.dup else (v + d) & _M32
            if not (
                fconst(3 + W + j) == 0xFFFFFFFF
                and fconst(3 + 2 * W + j) == 0
            ):
                v = (v & fc(3 + W + j)) | fc(3 + 2 * W + j)
            if not trivial_h and j == hf.lane:
                v = (v & ~hf.mask) | (
                    (h2 & ((1 << hf.bits) - 1)) << hf.shift
                )
            app.append(v)

        ord_over = None
        if self.ordered:
            # FUSED deliver/timeout: timeout rows carry zero channel
            # params, so the pop amount is zero there by construction.
            base = pc(11)
            base = max(base, 1) if isinstance(base, int) \
                else base.clamp(min=1)
            nl, nsh, nm = pc(6), pc(7), pc(8)
            qv = (lane_sel(app, nl) >> nsh) & nm
            pop_amt = shl(qv - qv // base, nsh)
            if isinstance(nl, int):
                s_table = list(app)
                s_table[nl] = app[nl] - pop_amt
            else:
                s_table = [
                    app[j] - torch.where(nl == j, pop_amt, 0)
                    for j in range(W)
                ]
            for j in range(self._smax):
                if fconst(3 + 3 * W + self._smax + j) == 0:
                    continue  # no row ever sends in this emission slot
                chj = fc(3 + 3 * W + j)
                cdj = fc(3 + 3 * W + self._smax + j)
                do = cdj > 0
                adds: dict = {}
                for cc in range(len(self.channels)):
                    if isinstance(chj, int) and chj != cc:
                        continue
                    cch = self.channels[cc]
                    cbase = self.ch_base[cch]
                    Q = self.ch_q[cch]
                    f = self.f_ch[cc]
                    q = (s_table[f.lane] >> f.shift) & ((1 << f.bits) - 1)
                    ln = sum((q >= cbase**p).to(torch.int64)
                             for p in range(Q))
                    powv = torch.zeros_like(q)
                    for pp in range(Q):
                        powv = torch.where(ln == pp, cbase**pp, powv)
                    if isinstance(chj, int):
                        sel = do
                    else:
                        sel = (chj == cc) if do is True else do & (chj == cc)
                    full = ln >= Q
                    put = ~full if sel is True else sel & ~full
                    over = full if sel is True else sel & full
                    add = torch.where(put, cdj * powv, 0) << f.shift
                    adds[f.lane] = (
                        add if f.lane not in adds else adds[f.lane] + add
                    )
                    ord_over = over if ord_over is None else ord_over | over
                for lj, add in adds.items():
                    s_table[lj] = s_table[lj] + add
            s_drop = lanes
        elif self.dup:
            s_table = app
            if plan["has_drop"]:
                nl, nsh, nm = pc(6), pc(7), pc(8)
                nmask = shl(nm, nsh) & _M32
                if isinstance(nl, int):
                    s_drop = list(lanes)
                    s_drop[nl] = lanes[nl] & ~nmask
                else:
                    s_drop = [
                        torch.where(nl == j, lanes[j] & ~nmask, lanes[j])
                        for j in range(W)
                    ]
        else:
            # FUSED deliver/timeout: timeout rows carry zero envelope
            # params, so the post-delta decrement is the identity there.
            nl, nsh, nm = pc(6), pc(7), pc(8)
            nmask = shl(nm, nsh) & _M32
            ac = (lane_sel(app, nl) >> nsh) & nm
            dec = shl((ac - 1) & nm, nsh)
            if isinstance(nl, int):
                s_table = list(app)
                s_table[nl] = (app[nl] & ~nmask) | dec
            else:
                s_table = [
                    torch.where(nl == j, (app[j] & ~nmask) | dec, app[j])
                    for j in range(W)
                ]
            if plan["has_drop"]:
                vc = (lane_sel(lanes, nl) >> nsh) & nm
                dc = shl((vc - 1) & nm, nsh)
                if isinstance(nl, int):
                    s_drop = list(lanes)
                    s_drop[nl] = (lanes[nl] & ~nmask) | dc
                else:
                    s_drop = [
                        torch.where(nl == j, (lanes[j] & ~nmask) | dc,
                                    lanes[j])
                        for j in range(W)
                    ]

        if plan["has_crash"]:
            ai = pc(1)
            top = max(0, self.n - 1)
            ai = min(ai, top) if isinstance(ai, int) else ai.clamp(max=top)
            crow = c["crash_and"][ai]  # [W] or [N, W]
            cl, csh = pc(9), pc(10)
            bit = shl(1, csh)
            if isinstance(cl, int):
                s_crash = [lanes[j] & crow[..., j] for j in range(W)]
                s_crash[cl] = (lanes[cl] | bit) & crow[..., cl]
            else:
                s_crash = [
                    torch.where(cl == j, lanes[j] | bit, lanes[j])
                    & crow[..., j]
                    for j in range(W)
                ]

        succ_lanes = list(s_table)
        table_gate = None
        if plan["has_drop"] or plan["has_crash"]:
            kind = pc(0)
            if plan["has_drop"]:
                is_drop = kind == self._SK_DROP
                succ_lanes = [
                    succ_lanes[j]
                    if (s_drop[j] is lanes[j] and succ_lanes[j] is lanes[j])
                    else torch.where(is_drop, s_drop[j], succ_lanes[j])
                    for j in range(W)
                ]
                table_gate = ~is_drop
            if plan["has_crash"]:
                is_crash = kind == self._SK_CRASH
                succ_lanes = [
                    torch.where(is_crash, s_crash[j], succ_lanes[j])
                    for j in range(W)
                ]
                table_gate = (
                    ~is_crash if table_gate is None
                    else table_gate & ~is_crash
                )

        succ = torch.stack(succ_lanes)

        def gated(flag):
            if flag is None or table_gate is None:
                return flag
            return table_gate & flag

        if self.ordered:
            trunc = gated(ord_over)
        elif self.dup:
            trunc = None
        else:
            tops = [
                (succ_lanes[j] & int(self._net_top_mask[j])) != 0
                for j in range(W) if int(self._net_top_mask[j])
            ]
            trunc = None
            for t in tops:
                trunc = t if trunc is None else trunc | t
            trunc = gated(trunc)
        hard = None if trivial_h else gated(h_missing)
        return succ, trunc, hard

    def _dense_consts(self, device) -> dict:
        """The dense emission's per-slot tables (``tbl_deliver``,
        ``tbl_timeout``) and the packed history table as int64 tensors
        on ``device``, made once per device."""
        device = torch.device(device)
        cache = self.__dict__.setdefault("_dense_dev", {})
        if device not in cache:
            def rows(tbl):
                return [
                    (i, k) + tuple(
                        torch.from_numpy(np.asarray(a).astype(np.int64))
                        .to(device) for a in t)
                    for (i, k, *t) in tbl
                ]

            cache[device] = dict(
                deliver=rows(self.tbl_deliver),
                timeout=rows(self.tbl_timeout),
                hist=torch.from_numpy(self.tbl_history_packed.astype(
                    np.int64)).to(device),
            )
        return cache[device]

    def step_cols(self, states_t: torch.Tensor) -> tuple:
        """The dense emission (JAX ``step_vec``): ``[W, N] -> (succ [W, N,
        K], valid bool[N, K], trunc bool[N])`` — every slot's successor
        (deliver slots, then drops, timeouts and crashes, the JAX slot
        order) from the per-(slot, actor-state) transition tables.

        ``trunc`` marks rows where an otherwise-valid, in-boundary
        successor was pruned by the implicit count bound (the top bit
        of an 8-bit envelope field) or a FIFO queue bound, or where an
        un-harvested history transition made it unrepresentable, and
        rows holding an actor state the closure did not expand; the
        engine raises on it. The lanes are uint32 values in int64: every
        lane write is masked to 32 bits, as a uint32 store wraps."""
        c = self._dense_consts(states_t.device)
        W = self.width
        n = states_t.shape[1]
        dev = states_t.device
        vec = [states_t[j] for j in range(W)]
        hist = c["hist"]
        false = torch.zeros(n, dtype=torch.bool, device=dev)
        trunc = false

        def getf(ls, f):
            return (ls[f.lane] >> f.shift) & ((1 << f.bits) - 1)

        def setf(ls, f, value):
            out = list(ls)
            out[f.lane] = ((ls[f.lane] & ~f.mask)
                           | (value << f.shift)) & _M32
            return out

        def in_bound(ls):
            if self.boundary_spec is None:
                return True
            return self.within_boundary_cols(torch.stack(ls))

        n_crashed = sum(getf(vec, self.f_crashed[i]) for i in range(self.n))
        h_idx = getf(vec, self.f_history).clamp(max=hist.shape[0] - 1)
        top = [int(m) for m in self._net_top_mask]

        def apply_transition(i, nxt, noop, ndl, tan, tor, hcl,
                             extra_net=None):
            s_idx = getf(vec, self.f_actor[i])
            t_noop = _take(noop, s_idx) != 0
            s = setf(vec, self.f_actor[i], _take(nxt, s_idx))
            delta, t_and, t_or = (_take(ndl, s_idx), _take(tan, s_idx),
                                  _take(tor, s_idx))
            s = [((s[j] | delta[:, j]) if self.dup
                  else (s[j] + delta[:, j]) & _M32) & t_and[:, j]
                 | t_or[:, j] for j in range(W)]
            hg = hist[h_idx, _take(hcl, s_idx).clamp(
                max=hist.shape[1] - 1)]
            s = setf(s, self.f_history, hg & 0x7FFFFFFF)
            if extra_net is not None:
                s = extra_net(s)
            poisoned = false
            if not self.dup and not self.ordered:
                for j in range(W):
                    if top[j]:
                        poisoned = poisoned | ((s[j] & top[j]) != 0)
            # an un-harvested (h, class) transition: the history field
            # is garbage, so the boundary cannot be trusted and the
            # truncation is raised whatever it says
            hmiss = (hg >> 31) != 0
            return s, t_noop, poisoned, hmiss

        def ord_sends(s, i, sch, scd):
            """Append the transition's sends to their FIFO queues in
            emission order (q += code*base^len); a full queue sets the
            overflow flag."""
            s_idx = getf(vec, self.f_actor[i])
            over = false
            for j in range(self._smax):
                chj = _take(sch, s_idx)[:, j]
                cdj = _take(scd, s_idx)[:, j]
                do = cdj > 0
                for cc, ch in enumerate(self.channels):
                    base, Q, f = self.ch_base[ch], self.ch_q[ch], \
                        self.f_ch[cc]
                    q = getf(s, f)
                    ln = sum((q >= base**p).to(torch.int64)
                             for p in range(Q))
                    powv = torch.zeros_like(q)
                    for p in range(Q):
                        powv = torch.where(ln == p, base**p, powv)
                    sel = do & (chj == cc)
                    full = ln >= Q
                    s = setf(s, f, torch.where(sel & ~full,
                                               q + cdj * powv, q))
                    over = over | (sel & full)
            return s, over

        succs, valids = [], []

        def emit(s, valid):
            succs.append(s)
            valids.append(valid)

        # Deliver slots (model.rs:299-351).
        for (i, k, nxt, noop, ndl, tan, tor, hcl, sch, scd) in c["deliver"]:
            crashed = getf(vec, self.f_crashed[i]) != 0
            if self.ordered:
                env = self.E[k]
                ch = (env.src, env.dst)
                base = self.ch_base[ch]
                fq = self.f_ch[self.chidx[ch]]
                # deliverable iff this message is the channel HEAD
                # (model.rs:252-266); a no-op handler still pops
                present = (getf(vec, fq) % base) == self.ch_code[ch][env.msg]

                def pop_net(s, fq=fq, base=base):
                    return setf(s, fq, getf(s, fq) // base)

                s, t_noop, app_poison, hmiss = apply_transition(
                    i, nxt, noop, ndl, tan, tor, hcl, extra_net=pop_net)
                s, poisoned = ord_sends(s, i, sch, scd)
                poisoned = poisoned | app_poison
            else:
                f = self.f_net[k]
                present = getf(vec, f) > 0

                def dec_net(s, f=f):
                    if self.dup:
                        return s  # redeliverable (network.rs:204-206)
                    return setf(s, f, getf(s, f) - 1)

                s, t_noop, poisoned, hmiss = apply_transition(
                    i, nxt, noop, ndl, tan, tor, hcl, extra_net=dec_net)
            enabled = present & ~crashed & ~t_noop
            trunc = trunc | (enabled & ((poisoned & in_bound(s)) | hmiss))
            emit(s, enabled & ~poisoned & ~hmiss)

        # Drop slots — lossy networks only (model.rs:246-249).
        for k in self.drop_slots:
            f = self.f_net[k]
            present = getf(vec, f) > 0
            if self.dup:
                s = list(vec)
                s[f.lane] = vec[f.lane] & ~f.mask
            else:
                s = setf(vec, f, getf(vec, f) - 1)
            emit(s, present)

        # Timeout slots (model.rs:352-371).
        for (i, j, nxt, noop, ndl, tan, tor, hcl, sch, scd) in (
                c["timeout"]):
            armed = getf(vec, self.f_timer[i][j]) != 0
            s, t_noop, poisoned, hmiss = apply_transition(
                i, nxt, noop, ndl, tan, tor, hcl)
            if self.ordered:
                s, over = ord_sends(s, i, sch, scd)
                poisoned = poisoned | over
            enabled = armed & ~t_noop
            trunc = trunc | (enabled & ((poisoned & in_bound(s)) | hmiss))
            emit(s, enabled & ~poisoned & ~hmiss)

        # Crash slots (model.rs:372-380).
        for i in self.crash_slots:
            crashed = getf(vec, self.f_crashed[i]) != 0
            s = setf(vec, self.f_crashed[i], torch.ones_like(vec[0]))
            for f in self.f_timer[i]:
                s[f.lane] = s[f.lane] & ~f.mask
            emit(s, ~crashed & (n_crashed < self.max_crashes))

        unexpanded = self.unexpanded_rows(states_t)
        if unexpanded is not None:
            trunc = trunc | unexpanded
        return (*stack_slots(succs, valids), trunc)

    def property_conditions_cols(self,
                                 states_t: torch.Tensor) -> torch.Tensor:
        """``bool[N, P]`` in ``host_model.properties()`` order."""
        ctx = _SpecCtx(self, states_t)
        n = states_t.shape[1]
        conds = [
            _bool_cols(self.property_specs[p.name](ctx, torch), n,
                       states_t.device)
            for p in self.model.properties()
        ]
        if not conds:
            return torch.zeros((n, 0), dtype=torch.bool,
                               device=states_t.device)
        return torch.stack(conds, dim=1)

    def within_boundary_cols(self, states_t: torch.Tensor) -> torch.Tensor:
        """``bool[N]``: the boundary spec (all True without one)."""
        n = states_t.shape[1]
        if self.boundary_spec is None:
            return torch.ones(n, dtype=torch.bool, device=states_t.device)
        ctx = _SpecCtx(self, states_t)
        return _bool_cols(self.boundary_spec(ctx, torch), n,
                          states_t.device)

    @property
    def trivial_boundary(self) -> bool:
        """Lets the sparse engine skip the per-pair boundary pass and
        the terminal scatter-back when no boundary spec exists."""
        return self.boundary_spec is None

    # -- field access (host) ----------------------------------------------

    def _get_field(self, vec, f: _Field) -> int:
        return (int(vec[f.lane]) >> f.shift) & ((1 << f.bits) - 1)

    def _get_actor_idx(self, vec, i: int) -> int:
        return self._get_field(vec, self.f_actor[i])

    def _net_count(self, vec, k: int) -> int:
        if self.ordered:
            # Envelope k is "in flight" iff its code appears at any
            # position of its channel's queue (iter_deliverable yields
            # every flow position, not just heads — network.rs:149-170).
            env = self.E[k]
            ch = (env.src, env.dst)
            base = self.ch_base[ch]
            code = self.ch_code[ch][env.msg]
            q = self._get_field(vec, self.f_ch[self.chidx[ch]])
            return sum(
                (q // base**p) % base == code
                for p in range(self.ch_q[ch])
            )
        return self._get_field(vec, self.f_net[k])

    # -- host side --------------------------------------------------------

    def encode(self, state) -> np.ndarray:
        vec = np.zeros(self.width, np.uint32)

        def put(f: _Field, value: int):
            if value >= (1 << f.bits):
                raise ValueError(
                    f"field overflow: {value} in {f.bits} bits (an envelope "
                    "count above 255 means the closure bounds are wrong)"
                )
            vec[f.lane] |= np.uint32(value << f.shift)

        for i, s in enumerate(state.actor_states):
            try:
                put(self.f_actor[i], self.sidx[i][s])
            except KeyError:
                raise KeyError(
                    f"actor {i} state outside closure: {s!r}"
                ) from None
        put(self.f_history, self.hidx[state.history])
        for i, crashed in enumerate(state.crashed):
            put(self.f_crashed[i], int(crashed))
        for i, timers in enumerate(state.timers_set):
            for t in timers:
                put(self.f_timer[i][self.tidx[i][t]], 1)
        if self.ordered:
            for ci, ch in enumerate(self.channels):
                flow = state.network.flows.get(ch, ())
                if len(flow) > self.ch_q[ch]:
                    raise ValueError(
                        f"channel {ch} queue depth {len(flow)} exceeds "
                        f"the queue bound {self.ch_q[ch]} (harvested or "
                        "declared via closure_queue_bound)"
                    )
                base = self.ch_base[ch]
                q = 0
                for pos, msg in enumerate(flow):
                    code = self.ch_code[ch].get(msg)
                    if code is None:
                        raise KeyError(
                            f"message outside channel {ch} alphabet: "
                            f"{msg!r}"
                        )
                    q += code * base**pos
                put(self.f_ch[ci], q)
        elif self.dup:
            for env in state.network.envelopes:
                put(self.f_net[self.eidx[env]], 1)
        else:
            for env, count in state.network.counts.items():
                if count >= 128:
                    raise ValueError(
                        f"envelope count {count} for {env!r} exceeds the "
                        "compiled encoding's implicit bound of 127 (the "
                        "device prunes successors past it)"
                    )
                put(self.f_net[self.eidx[env]], count)
        return vec

    def decode(self, vec):
        from dataclasses import replace

        vec = np.asarray(vec, dtype=np.uint32)
        actor_states = tuple(
            self.S[i][self._get_actor_idx(vec, i)]
            for i in range(self.n)
        )
        history = self.H[self._get_field(vec, self.f_history)]
        crashed = tuple(
            bool(self._get_field(vec, self.f_crashed[i]))
            for i in range(self.n)
        )
        timers = tuple(
            frozenset(
                t for j, t in enumerate(self.T[i])
                if self._get_field(vec, self.f_timer[i][j])
            )
            for i in range(self.n)
        )
        if self.ordered:
            flows = {}
            for ci, ch in enumerate(self.channels):
                q = self._get_field(vec, self.f_ch[ci])
                base = self.ch_base[ch]
                flow = []
                while q:
                    flow.append(self.ch_msgs[ch][q % base - 1])
                    q //= base
                if flow:
                    flows[ch] = tuple(flow)
            net = Ordered(flows)
        elif self.dup:
            net = UnorderedDuplicating(frozenset(
                e for k, e in enumerate(self.E)
                if self._net_count(vec, k)
            ))
        else:
            net = UnorderedNonDuplicating({
                e: self._net_count(vec, k)
                for k, e in enumerate(self.E)
                if self._net_count(vec, k)
            })
        return replace(
            self._init_state,
            actor_states=actor_states,
            network=net,
            timers_set=timers,
            crashed=crashed,
            history=history,
        )

    def init_vecs(self) -> np.ndarray:
        return np.stack(
            [self.encode(s) for s in self.model.init_states()]
        )
