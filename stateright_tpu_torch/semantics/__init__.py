"""Consistency semantics: sequential specs and concurrent-history testers.

A copy of the JAX package's ``semantics`` package (reference
src/semantics.rs and src/semantics/*): reference objects (the
read/write :class:`~stateright_tpu_torch.semantics.register.Register`,
the write-once register, the vector) define *sequential* semantics via
:class:`SequentialSpec`; the linearizability and sequential-consistency
testers record a concurrent operation history and decide whether some
legal total order explains it.

The testers are **immutable**: in actor models the tester is the
auxiliary history and therefore part of the fingerprinted model state,
so recording returns a new tester value.
"""

from .spec import SequentialSpec
from .linearizability import LinearizabilityTester
from .sequential_consistency import SequentialConsistencyTester
from .register import Register, ReadOp, ReadOk, WriteOp, WriteOk
from .write_once_register import WORegister, WriteFail
from .vec import Vec, Push, Pop, Len, PushOk, PopOk, LenOk

__all__ = [
    "SequentialSpec",
    "LinearizabilityTester",
    "SequentialConsistencyTester",
    "Register",
    "ReadOp",
    "ReadOk",
    "WriteOp",
    "WriteOk",
    "WORegister",
    "WriteFail",
    "Vec",
    "Push",
    "Pop",
    "Len",
    "PushOk",
    "PopOk",
    "LenOk",
]
