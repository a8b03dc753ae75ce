"""Static analysis of the port's encodings: the reduction soundness
analyzer.

The counterparts of the JAX package's ``analysis`` modules:

* :mod:`.soundness` — the reduction soundness analyzer (JAX
  ``analysis/soundness.py``), abstract bit-level interpretation of the
  encodings' traced ``*_cols`` functions plus a semantic battery; the
  engines' spawn gates consult its certificate;
* :mod:`.walker` — aten traces of those functions and source
  attribution (JAX ``walker.py`` walks jaxprs);
* :mod:`.rules` — only :class:`~.rules.Finding`;
* :mod:`.registry` — only ``SOUNDNESS_TARGETS``.

The JAX kernel lint (``lint.py``, the ``RULES`` of ``rules.py``, the
``ENCODINGS`` of ``registry.py``, ``tables.py``) and the comms lint
(``comms.py``) have no counterpart: each checks an XLA codegen or HLO
contract — dense ``[F, K]`` masks, ``lax.switch`` carries, collectives
under ``shard_map``, HLO categories — and eager PyTorch has nothing
that corresponds.
"""
