"""The ``analyze soundness`` targets.

The port's counterpart of the JAX package's
``analysis.registry.SOUNDNESS_TARGETS``: every reduction-declaring hand
encoding the analyzer certifies into ``SOUND_r*.json``
(analysis/soundness.py), with the JAX defaults. The JAX registry's
kernel-lint ``ENCODINGS`` table has no counterpart here
(analysis/__init__.py).
"""

from __future__ import annotations


def _soundness_2pc(count):
    from ..models.two_phase_commit_tpu import TwoPhaseSysEncoded

    return TwoPhaseSysEncoded(count if count is not None else 4)


def _soundness_register(count):
    from ..models.nclient_register_tpu import NClientRegEncoded

    return NClientRegEncoded(count if count is not None else 4)


#: ``(name, factory)`` per target. Each factory takes the optional CLI
#: member count (rm_count / n_clients; None = the default, 4).
SOUNDNESS_TARGETS: tuple = (
    ("2pc", _soundness_2pc),
    ("register", _soundness_register),
)
