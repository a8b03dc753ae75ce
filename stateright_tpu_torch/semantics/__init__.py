"""Consistency semantics: sequential specs and concurrent-history testers.

A copy of the JAX package's ``semantics`` package (reference
src/semantics.rs and src/semantics/*), cut to what the register actor
models use: :class:`SequentialSpec`, the read/write
:class:`~stateright_tpu_torch.semantics.register.Register` and the
:class:`LinearizabilityTester`. The sequential-consistency tester and
the write-once register and vector specs are not ported yet.

The testers are **immutable**: in actor models the tester is the
auxiliary history and therefore part of the fingerprinted model state,
so recording returns a new tester value.
"""

from .spec import SequentialSpec
from .linearizability import LinearizabilityTester
from .register import Register, ReadOp, ReadOk, WriteOp, WriteOk

__all__ = [
    "SequentialSpec",
    "LinearizabilityTester",
    "Register",
    "ReadOp",
    "ReadOk",
    "WriteOp",
    "WriteOk",
]
