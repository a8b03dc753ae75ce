"""Checker configuration and the common checker interface.

A copy of the JAX package's ``checker`` module, cut to what the
ported engines use. ``CheckerBuilder`` mirrors the reference's
fluent builder (stateright src/checker.rs:64-267) and ``Checker`` its
result interface (src/checker.rs:273-557): counts, discoveries as
replayable :class:`~stateright_tpu_torch.path.Path` objects,
reporting and the assertion helpers. The search runs synchronously on
first demand (``join`` or any accessor); the hybrid racer runs its host
side in a thread of its own (checkers/hybrid.py), and ``threads(n)``
gives the host BFS n worker threads.
"""

from __future__ import annotations

import time
from enum import Enum
from typing import Any, Callable, Optional, Sequence

from .model import Expectation, Model, State
from .path import Path
from .report import ReportData, Reporter
from .visitor import CheckerVisitor, as_visitor


class DiscoveryClassification(str, Enum):
    """Whether a discovery proves or refutes a property (checker.rs:38-52)."""

    EXAMPLE = "example"
    COUNTEREXAMPLE = "counterexample"


class CheckerBuilder:
    """Fluent checker configuration (checker.rs:64-267)."""

    def __init__(self, model: Model):
        self.model = model
        self._symmetry: Optional[Callable[[State], State]] = None
        self._target_state_count: Optional[int] = None
        self._target_max_depth: Optional[int] = None
        self._threads: int = 1
        self._unsound_ok: bool = False
        self._visitor: Optional[CheckerVisitor] = None

    def unsound_ok(self) -> "CheckerBuilder":
        """Waive the reduction gate (analysis/soundness.py): a declared
        ``DeviceRewriteSpec`` or ample mask that is not certified runs
        anyway instead of refusing at spawn (``--unsound-ok`` on the
        CLI) — the run's counts carry no soundness guarantee."""
        self._unsound_ok = True
        return self

    def symmetry(self) -> "CheckerBuilder":
        """Enable symmetry reduction via the state's own
        ``representative`` method (checker.rs:217-222). The wave engine
        canonicalizes through the encoding's ``device_rewrite_spec()``
        instead, and refuses an encoding that declares none."""
        return self.symmetry_fn(lambda state: state.representative())

    def symmetry_fn(self, f: Callable[[State], State]) -> "CheckerBuilder":
        """Enable symmetry reduction with an explicit representative
        function (checker.rs:225-232); the host DFS and simulation
        honour it."""
        self._symmetry = f
        return self

    def target_state_count(self, count: int) -> "CheckerBuilder":
        """Stop after visiting approximately ``count`` unique states
        (checker.rs:236-241): the wave engine stops after the wave that
        reaches it."""
        self._target_state_count = count
        return self

    def target_max_depth(self, depth: int) -> "CheckerBuilder":
        """Do not expand states deeper than ``depth``
        (checker.rs:244-249)."""
        self._target_max_depth = depth
        return self

    def threads(self, n: int) -> "CheckerBuilder":
        """Worker threads for the host BFS (checker.rs:253-258):
        ``spawn_bfs`` runs n workers over the shared pending deque in
        1,500-state blocks. Counts and the discovered property SET match
        the sequential run; which state discovers a property can differ
        from run to run. CPython's GIL serializes pure-Python model
        callbacks, so this is parity, not speed."""
        self._threads = n
        return self

    def visitor(self, v) -> "CheckerBuilder":
        """Attach a visitor called with every evaluated state's path
        (checker.rs:261-266); the host checkers call it."""
        self._visitor = as_visitor(v)
        return self

    def spawn_bfs(self) -> "Checker":
        """Spawn the host breadth-first search (checkers/bfs.py), the
        wave engines' oracle."""
        from .checkers.bfs import BfsChecker

        return BfsChecker(self)

    def spawn_dfs(self) -> "Checker":
        """Spawn the host depth-first search (checkers/dfs.py)."""
        from .checkers.dfs import DfsChecker

        return DfsChecker(self)

    def spawn_on_demand(self) -> "Checker":
        """Spawn the on-demand checker: a BFS that expands a state only
        when asked (checkers/on_demand.py)."""
        from .checkers.on_demand import OnDemandChecker

        return OnDemandChecker(self)

    def spawn_simulation(self, seed: int = 0, chooser=None) -> "Checker":
        """Spawn the host simulation: seeded random traces
        (checkers/simulation.py)."""
        from .checkers.simulation import SimulationChecker, UniformChooser

        return SimulationChecker(self, chooser or UniformChooser(), seed)

    def spawn_hash(self, **kwargs) -> "Checker":
        """Spawn the hash wave engine on a device — the port of the JAX
        package's ``spawn_tpu``: the visited set is an open-addressing
        table, inserted into by the CUDA ``hash_insert`` kernel. It runs
        on the CUDA device unless ``device="cpu"`` is passed (see
        checkers/tpu.py)."""
        from .checkers.tpu import TpuBfsChecker

        return TpuBfsChecker(self, **kwargs)

    def spawn_device_simulation(self, **kwargs) -> "Checker":
        """Spawn the device simulation checker — the port of the JAX
        package's ``spawn_tpu_simulation``: N random walks advancing in
        lockstep on the CUDA device unless ``device="cpu"`` is passed
        (see checkers/tpu_simulation.py)."""
        from .checkers.tpu_simulation import TpuSimulationChecker

        return TpuSimulationChecker(self, **kwargs)

    def spawn_hybrid(self, **kwargs) -> "Checker":
        """Spawn the hybrid racer: the host DFS in a thread against the
        sort-merge engine in the calling thread; the first to finish
        wins and the loser is cancelled (see checkers/hybrid.py).
        ``kwargs`` go to the sort-merge engine."""
        from .checkers.hybrid import HybridChecker

        return HybridChecker(self, **kwargs)

    def spawn_sortmerge(self, **kwargs) -> "Checker":
        """Spawn the sort-merge wave engine on a device — the port of the
        JAX package's ``spawn_tpu_sortmerge``. It runs on the CUDA device
        unless ``device="cpu"`` is passed (see
        checkers/tpu_sortmerge.py)."""
        from .checkers.tpu_sortmerge import SortMergeTpuBfsChecker

        return SortMergeTpuBfsChecker(self, **kwargs)

    def spawn_sharded_sortmerge(self, n_shards=None, devices=None,
                                **kwargs) -> "Checker":
        """Spawn the sort-merge wave engine over S shards — the port of
        the JAX package's ``spawn_tpu_sharded_sortmerge``. Shard ``s``
        runs on ``devices[s]`` (a device may repeat); without
        ``devices``, one shard per visible card, and ``n_shards`` above
        the card count raises. Capacities are per shard (see
        parallel/engine_sortmerge.py)."""
        from .parallel.engine_sortmerge import ShardedSortMergeTpuBfsChecker

        return ShardedSortMergeTpuBfsChecker(
            self, n_shards=n_shards, devices=devices, **kwargs)

    def spawn_sharded_hash(self, n_shards=None, devices=None,
                           **kwargs) -> "Checker":
        """Spawn the hash wave engine over S shards — the port of the JAX
        package's ``spawn_tpu_sharded``: one open-addressing table a
        shard, each fed by the CUDA insert. Devices and capacities as
        :meth:`spawn_sharded_sortmerge` (see parallel/engine.py)."""
        from .parallel.engine import ShardedTpuBfsChecker

        return ShardedTpuBfsChecker(
            self, n_shards=n_shards, devices=devices, **kwargs)

    def serve(self, addr: str):
        """Serve the Explorer web UI for this model (checker.rs:139-146,
        explorer/server.py): blocks until interrupted and returns the
        on-demand checker."""
        from .explorer.server import serve

        return serve(self, addr)


class Checker:
    """Common checker result interface (checker.rs:273-557)."""

    def __init__(self, builder: CheckerBuilder):
        self.builder = builder
        self.model = builder.model
        self._discoveries: dict[str, Path] = {}
        self._total_states = 0
        self._unique_states = 0
        self._max_depth = 0
        self._done = False
        self._run_error: Optional[Exception] = None
        self._started_at: Optional[float] = None
        self._finished_at: Optional[float] = None

    def _run(self, reporter: Optional[Reporter] = None) -> None:
        """Run the search to completion. Implemented by engines."""
        raise NotImplementedError

    def _ensure_run(self, reporter: Optional[Reporter] = None) -> None:
        if self._done:
            if self._run_error is not None:
                raise self._run_error
            return
        # Run telemetry (telemetry.py): with a tracer active, every
        # engine's run is bracketed here, the one place all engines pass
        # through, so host and device checkers trace alike. A checker
        # run inside another's run (the hybrid racer's two sides) records
        # into the enclosing run, which owns the bracket.
        from . import telemetry

        tracer = telemetry.current_tracer()
        if tracer is not None and tracer._run_open:
            tracer = None
        if tracer is not None:
            tracer.begin_run(lane=self._lane_config())
        self._started_at = time.monotonic()
        try:
            self._run(reporter)
        except Exception as exc:
            # A failed run is terminal: replay the error on every later
            # accessor instead of re-running the whole search.
            self._finished_at = time.monotonic()
            self._done = True
            self._run_error = exc
            if tracer is not None:
                tracer.end_run(error=f"{type(exc).__name__}: {exc}",
                               **self._run_stats())
            raise
        self._finished_at = time.monotonic()
        self._done = True
        if tracer is not None:
            self._emit_settlement_verdicts(tracer)
            tracer.end_run(error=None, **self._run_stats())

    def _emit_settlement_verdicts(self, tracer) -> None:
        """The exhaustion half of the verdict timeline: a property with
        no discovery settles when the search completes, so a clean run
        gives each property exactly one ``verdict`` event (discoveries
        land earlier, where the engines find them). A cancelled run (the
        hybrid racer's loser) has exhausted nothing and emits none."""
        if getattr(self, "cancelled", False):
            return
        discovered = set(self._discoveries) | set(
            getattr(self, "_discovered_fps", None) or {})
        metrics = getattr(self, "metrics", None)
        waves = metrics.get("waves") if isinstance(metrics, dict) else None
        for prop in self.model.properties():
            if prop.name in discovered:
                continue
            tracer.event("verdict", property=prop.name,
                         expectation=prop.expectation.name.lower(),
                         kind="exhaustion",
                         wave=(int(waves) if waves is not None else None),
                         depth=self._max_depth)

    def _lane_config(self) -> dict:
        """The run's lane, embedded in the trace's ``run_begin`` event
        (engines add their shapes)."""
        return dict(engine=type(self).__name__,
                    model=type(self.model).__name__,
                    target_state_count=self.builder._target_state_count,
                    target_max_depth=self.builder._target_max_depth)

    def _run_stats(self) -> dict:
        """The run's outcome for the trace's ``run_end`` event."""
        return dict(total_states=self._total_states,
                    unique_states=self._unique_states,
                    max_depth=self._max_depth,
                    duration_sec=round(self.duration_sec(), 6))

    # -- status (checker.rs:287-314) -------------------------------------

    def state_count(self) -> int:
        self._ensure_run()
        return self._total_states

    def unique_state_count(self) -> int:
        self._ensure_run()
        return self._unique_states

    def max_depth(self) -> int:
        self._ensure_run()
        return self._max_depth

    def is_done(self) -> bool:
        return self._done

    def join(self) -> "Checker":
        self._ensure_run()
        return self

    def duration_sec(self) -> float:
        if self._started_at is None:
            return 0.0
        end = self._finished_at if self._finished_at is not None else time.monotonic()
        return end - self._started_at

    # -- on-demand hooks (checker.rs:278-285); overridden by OnDemand ----

    def check_fingerprint(self, fp: int) -> None:
        pass

    def run_to_completion(self) -> None:
        self._ensure_run()

    # -- discoveries (checker.rs:287-300) --------------------------------

    def discoveries(self) -> dict[str, Path]:
        self._ensure_run()
        return dict(self._discoveries)

    def discovery(self, name: str) -> Optional[Path]:
        return self.discoveries().get(name)

    def discovery_classification(self, name: str) -> DiscoveryClassification:
        prop = self.model.property_by_name(name)
        if prop.expectation == Expectation.SOMETIMES:
            return DiscoveryClassification.EXAMPLE
        return DiscoveryClassification.COUNTEREXAMPLE

    # -- reporting (checker.rs:330-431) ----------------------------------

    def report(self, reporter: Reporter) -> "Checker":
        self._ensure_run(reporter)
        reporter.report_checking(
            ReportData(
                total_states=self._total_states,
                unique_states=self._unique_states,
                max_depth=self._max_depth,
                duration_sec=self.duration_sec(),
                done=self.is_done(),
            )
        )
        reporter.report_discoveries(self)
        return self

    def join_and_report(self, reporter: Reporter) -> "Checker":
        return self.report(reporter)

    # -- assertion helpers (checker.rs:447-556) --------------------------

    def assert_properties(self) -> None:
        """Assert no always/eventually counterexamples and an example for
        every sometimes property (checker.rs:447-473)."""
        for prop in self.model.properties():
            if prop.expectation == Expectation.SOMETIMES:
                self.assert_any_discovery(prop.name)
            else:
                self.assert_no_discovery(prop.name)

    def assert_any_discovery(self, name: str) -> Path:
        path = self.discovery(name)
        if path is None:
            raise AssertionError(f"expected a discovery for {name!r}")
        return path

    def assert_no_discovery(self, name: str) -> None:
        path = self.discovery(name)
        if path is not None:
            raise AssertionError(
                f"unexpected discovery for {name!r}: {path.encode()}\n{path!r}"
            )

    def assert_discovery(self, name: str, actions: Sequence[Any]) -> None:
        """Assert a discovery exists and matches the given action sequence
        (checker.rs:506-556)."""
        path = self.assert_any_discovery(name)
        if list(path.actions()) != list(actions):
            raise AssertionError(
                f"discovery for {name!r} has actions {path.actions()!r}, "
                f"expected {list(actions)!r}"
            )

    # -- shared engine internals ----------------------------------------

    def _eventually_bits_init(self) -> int:
        """Bitmask with one bit per eventually property, all set
        (checker.rs:559-566, bfs.rs:61-73)."""
        bits = 0
        for i, prop in enumerate(self.model.properties()):
            if prop.expectation == Expectation.EVENTUALLY:
                bits |= 1 << i
        return bits

    def _all_discovered(self) -> bool:
        """Early-exit condition: every property has a discovery
        (bfs.rs:128-135)."""
        props = self.model.properties()
        return len(props) > 0 and all(
            p.name in self._discoveries for p in props
        )
