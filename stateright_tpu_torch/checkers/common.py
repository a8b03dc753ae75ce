"""The reduction refusals every checker of the port raises.

A copy of the refusal half of the JAX package's ``checkers/common.py``
(:func:`reduction_refusal`, :func:`symmetry_refusal`,
:func:`soundness_refusal`), with its wording; the supported engines
and modules named are the port's own.
"""

from __future__ import annotations

from typing import Optional


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
        "supported: the sort-merge engine (spawn_sortmerge) when the "
        "encoding declares device_rewrite_spec() "
        "(stateright_tpu_torch/ops/canonical.py)"
    )
    return reduction_refusal("symmetry", engine, parts)


def soundness_refusal(engine: str, reduction: str, obligation: str,
                      detail: str) -> ValueError:
    """The certificate refusal: a declared spec or mask is not
    certified (soundness.py), so the engine refuses to trust it.
    ``reduction`` is ``"symmetry"`` or ``"ample-set"``; ``obligation``
    names what could not be shown."""
    parts = [
        f"soundness certificate refused: obligation {obligation!r} "
        f"failed — {detail}",
        "pass --unsound-ok (CheckerBuilder.unsound_ok()) to run the "
        "uncertified reduction anyway "
        "(stateright_tpu_torch/soundness.py)",
    ]
    return reduction_refusal(reduction, engine, parts)
