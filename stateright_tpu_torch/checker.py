"""Checker configuration and the common checker interface.

A copy of the JAX package's ``checker`` module, cut to what the
sort-merge slice uses. ``CheckerBuilder`` mirrors the reference's
fluent builder (stateright src/checker.rs:64-267) and ``Checker`` its
result interface (src/checker.rs:273-557): counts, discoveries as
replayable :class:`~stateright_tpu_torch.path.Path` objects and
reporting. The search runs synchronously on first demand
(``join`` or any accessor).
"""

from __future__ import annotations

import time
from enum import Enum
from typing import Callable, Optional

from .model import Expectation, Model, State
from .path import Path
from .report import ReportData, Reporter


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
        self._unsound_ok: bool = False

    def unsound_ok(self) -> "CheckerBuilder":
        """Waive the reduction gate (soundness.py): a declared
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
        self._symmetry = lambda state: state.representative()
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

    def spawn_sortmerge(self, **kwargs) -> "Checker":
        """Spawn the sort-merge wave engine on a device — the port of the
        JAX package's ``spawn_tpu_sortmerge``. It runs on the CUDA device
        unless ``device="cpu"`` is passed (see
        checkers/tpu_sortmerge.py)."""
        from .checkers.tpu_sortmerge import SortMergeTpuBfsChecker

        return SortMergeTpuBfsChecker(self, **kwargs)


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
        self._started_at = time.monotonic()
        try:
            self._run(reporter)
        except Exception as exc:
            # A failed run is terminal: replay the error on every later
            # accessor instead of re-running the whole search.
            self._finished_at = time.monotonic()
            self._done = True
            self._run_error = exc
            raise
        self._finished_at = time.monotonic()
        self._done = True

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

    # -- shared engine internals ----------------------------------------

    def _eventually_bits_init(self) -> int:
        """Bitmask with one bit per eventually property, all set
        (checker.rs:559-566, bfs.rs:61-73)."""
        bits = 0
        for i, prop in enumerate(self.model.properties()):
            if prop.expectation == Expectation.EVENTUALLY:
                bits |= 1 << i
        return bits
