"""Progress reporting for checkers.

Mirrors stateright src/report.rs:10-98: a ``Reporter`` receives periodic
``ReportData`` snapshots while a checker runs, then the final snapshot
and the discovery set. ``WriteReporter`` reproduces the reference's text
protocol (``Checking. states=… unique=… depth=…`` / ``Done. … sec=…``,
then each discovery with its encoded fingerprint path) so CLI output is
drop-in familiar.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import IO, TYPE_CHECKING

if TYPE_CHECKING:
    from .checker import Checker


@dataclass
class ReportData:
    """Snapshot of checker progress (report.rs:10-21)."""

    total_states: int
    unique_states: int
    max_depth: int
    duration_sec: float
    done: bool


class Reporter:
    """Periodic progress sink (report.rs:35-48)."""

    def delay(self) -> float:
        """Seconds between ``report_checking`` calls (report.rs:45-48)."""
        return 1.0

    def report_checking(self, data: ReportData) -> None:
        pass

    def report_discoveries(self, checker: "Checker") -> None:
        pass


class WriteReporter(Reporter):
    """Text reporter matching the reference format (report.rs:60-98)."""

    def __init__(self, out: IO[str] | None = None):
        self.out = out if out is not None else sys.stdout

    def report_checking(self, data: ReportData) -> None:
        if data.done:
            self.out.write(
                f"Done. states={data.total_states}, "
                f"unique={data.unique_states}, depth={data.max_depth}, "
                f"sec={data.duration_sec:.3f}\n"
            )
        else:
            self.out.write(
                f"Checking. states={data.total_states}, "
                f"unique={data.unique_states}, depth={data.max_depth}\n"
            )
        self.out.flush()

    def report_discoveries(self, checker: "Checker") -> None:
        # Fingerprint-only engines (track_paths=False, simulation)
        # report the discovery fingerprint instead of a replayable
        # path; full-path checkers keep the reference format.
        fp_only = getattr(checker, "discovery_fingerprints", None)
        track_paths = getattr(checker, "track_paths", True)
        if fp_only is not None and not track_paths:
            for name, fp in sorted(fp_only().items()):
                classification = checker.discovery_classification(name)
                self.out.write(
                    f"Discovered \"{name}\" {classification.value} "
                    f"{fp:#018x} (fingerprint only; re-run with "
                    "track_paths=True for the trace)\n"
                )
            self.out.flush()
            return
        for name, path in sorted(checker.discoveries().items()):
            classification = checker.discovery_classification(name)
            self.out.write(
                f"Discovered \"{name}\" {classification.value} {path.encode()}\n"
            )
            for state, action in path.steps:
                if action is not None:
                    self.out.write(f"{state!r}\n")
                    self.out.write(
                        f"-- {checker.model.format_action(action)} -->\n"
                    )
                else:
                    self.out.write(f"{state!r}\n")
        self.out.flush()
