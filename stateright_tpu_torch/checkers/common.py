"""What the port's checkers share: the reduction refusals and the
parent-trace walk.

A copy of the JAX package's ``checkers/common.py``: the refusals
(:func:`reduction_refusal`, :func:`symmetry_refusal`,
:func:`soundness_refusal`) with its wording, the supported engines and
modules named being the port's own; and :class:`ParentTraceMixin`, the
child→parent fingerprint forest walk of the host BFS and on-demand
checkers (bfs.rs:28-29, 371-400), with its discovery ``verdict`` event
and ``counterexample_reconstruction`` span (telemetry.py).
"""

from __future__ import annotations

from typing import Optional

from ..path import Path


def reduction_refusal(reduction: str, engine: str,
                      parts: list[str]) -> ValueError:
    """The shared formatter behind EVERY reduction refusal: a
    ``"{reduction} reduction: {engine} cannot honor it"`` head followed
    by the caller's detail parts, joined by ``"; "``."""
    head = [f"{reduction} reduction: {engine} cannot honor it"]
    return ValueError("; ".join(head + list(parts)))


def symmetry_refusal(engine: str,
                     missing: Optional[str] = None) -> ValueError:
    """The ONE symmetry-refusal error: ``engine`` names the refusing
    spawn; ``missing`` names the absent capability, if the engine
    could otherwise honor the reduction."""
    parts = []
    if missing:
        parts.append(f"missing capability: {missing}")
    parts.append(
        "supported: spawn_dfs / spawn_simulation on the host (as in "
        "the reference: dfs.rs:300-311, simulation.rs:252-256), and "
        "the sort-merge engine (spawn_sortmerge) when the encoding "
        "declares device_rewrite_spec() "
        "(stateright_tpu_torch/ops/canonical.py)"
    )
    return reduction_refusal("symmetry", engine, parts)


def soundness_refusal(engine: str, reduction: str, obligation: str,
                      detail: str) -> ValueError:
    """The certificate refusal: a declared spec or mask is not
    certified (analysis/soundness.py), so the engine refuses to trust it.
    ``reduction`` is ``"symmetry"`` or ``"ample-set"``; ``obligation``
    names what could not be shown."""
    parts = [
        f"soundness certificate refused: obligation {obligation!r} "
        f"failed — {detail}",
        "pass --unsound-ok (CheckerBuilder.unsound_ok()) to run the "
        "uncertified reduction anyway "
        "(stateright_tpu_torch/analysis/soundness.py)",
    ]
    return reduction_refusal(reduction, engine, parts)


class ParentTraceMixin:
    """Requires ``self.generated: dict[int, Optional[int]]``,
    ``self.model`` and ``self._discoveries``."""

    generated: dict[int, Optional[int]]

    def _reconstruct_fps(self, fp: int) -> list[int]:
        """Walk parent pointers back to an init state (bfs.rs:371-400)."""
        fps = [fp]
        while True:
            parent = self.generated[fps[-1]]
            if parent is None:
                break
            fps.append(parent)
        fps.reverse()
        return fps

    def _discover(self, name: str, fp: int,
                  depth: Optional[int] = None) -> None:
        if name not in self._discoveries:
            from .. import telemetry

            # the verdict lands before the reconstruction: time to verdict
            # is when the search settled the property, and the path has
            # its own span
            prop = self.model.property_by_name(name)
            telemetry.emit("verdict", property=name,
                           expectation=prop.expectation.name.lower(),
                           kind="discovery", wave=None, depth=depth)
            with telemetry.span("counterexample_reconstruction",
                                property=name):
                self._discoveries[name] = Path.from_fingerprints(
                    self.model, self._reconstruct_fps(fp)
                )
