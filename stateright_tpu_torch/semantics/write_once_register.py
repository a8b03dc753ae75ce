"""Write-once register reference object.

A copy of the JAX package's ``semantics.write_once_register``.
Counterpart of stateright src/semantics/write_once_register.rs:9-57:
the first write wins; later writes return ``WriteFail``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

from .spec import SequentialSpec
from .register import ReadOk, ReadOp, WriteOk, WriteOp


@dataclass(frozen=True)
class WriteFail:
    pass


@dataclass(frozen=True)
class WORegister(SequentialSpec):
    value: Optional[Any] = None
    written: bool = False

    def invoke(self, op: Any) -> Tuple["WORegister", Any]:
        if isinstance(op, WriteOp):
            if self.written:
                return self, WriteFail()
            return WORegister(op.value, True), WriteOk()
        if isinstance(op, ReadOp):
            return self, ReadOk(self.value)
        raise TypeError(f"unknown write-once register op {op!r}")
