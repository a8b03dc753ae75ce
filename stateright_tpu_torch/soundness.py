"""The reduction gate: which symmetry specs and ample masks may run.

The JAX package gates every declared ``DeviceRewriteSpec`` and ample
mask behind its soundness analyzer (``analysis/soundness.py``
``gate_symmetry`` / ``gate_ample``), which proves each obligation
(group action, orbit structure, property and transition invariance,
ample enabledness) by walking the jaxprs of the encoding's device
functions. The port has no jaxprs, and it imports nothing of the JAX
package, so it cannot run that analyzer. Its gate is a LIST of the
specs and masks the analyzer certified: an encoding is certified for a
reduction when its exact type is listed for it and the spec or mask it
declares is the one that type itself declares. Cross-package tests
hold the list to the JAX analyzer's verdicts and each listed spec's
canonical form bit for bit to the JAX canonicalizer. A torch-side
analyzer would come, if at all, with ROADMAP item 17.

Anything else — another encoding, a subclass, a spec passed to the
actor compiler — refuses with the obligation ``certified-list``
unless ``CheckerBuilder.unsound_ok()`` (``--unsound-ok``) waives it.
"""

from __future__ import annotations

import numpy as np

from .checkers.common import soundness_refusal
from .encoding import ample_mask_host, device_rewrite_spec

#: the obligation a refusal names
OBLIGATION = "certified-list"


def _listed(scope: str) -> tuple:
    """The encoding types certified for ``scope`` (``"symmetry"`` or
    ``"ample"``): the JAX analyzer's certificates of the same encodings
    (``SOUND_r01.json``: 2pc symmetry and ample, the register's
    symmetry)."""
    from .models.nclient_register_tpu import NClientRegEncoded
    from .models.two_phase_commit_tpu import TwoPhaseSysEncoded

    if scope == "symmetry":
        return (TwoPhaseSysEncoded, NClientRegEncoded)
    return (TwoPhaseSysEncoded,)


def certified(enc, scope: str) -> bool:
    """Whether ``enc``'s declared spec (``scope="symmetry"``) or ample
    mask (``scope="ample"``) is on the port's certified list."""
    cls = type(enc)
    if cls not in _listed(scope):
        return False
    if scope == "symmetry":
        return device_rewrite_spec(enc) == cls.device_rewrite_spec(enc)
    return np.array_equal(ample_mask_host(enc),
                          np.asarray(cls.ample_mask_host(enc), np.uint32))


def _gate(enc, engine: str, unsound_ok: bool, scope: str,
          reduction: str, what: str) -> bool:
    if certified(enc, scope):
        return True
    if unsound_ok:
        return False
    names = ", ".join(c.__name__ for c in _listed(scope))
    raise soundness_refusal(
        engine, reduction, OBLIGATION,
        f"{type(enc).__name__}'s {what} is not on the port's certified "
        f"list ({names}); the JAX analyzer that certifies new specs "
        "walks jaxprs and has no port yet",
    )


def gate_symmetry(enc, engine: str, unsound_ok: bool = False) -> bool:
    """Spawn-time gate for ``--symmetry``: True when the declared
    ``DeviceRewriteSpec`` is certified, False when it is not but
    ``unsound_ok`` waives the refusal; raises
    :func:`checkers.common.soundness_refusal` otherwise."""
    return _gate(enc, engine, unsound_ok, "symmetry", "symmetry",
                 "device_rewrite_spec()")


def gate_ample(enc, engine: str, unsound_ok: bool = False) -> bool:
    """The gate for ``--ample-set`` (same contract as
    :func:`gate_symmetry`, ample scope)."""
    return _gate(enc, engine, unsound_ok, "ample", "ample-set",
                 "ample_mask_host()")
