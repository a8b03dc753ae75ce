"""Read/write register reference object.

A copy of the JAX package's ``semantics.register``. Counterpart of
stateright src/semantics/register.rs:9-49:
``Register(value)`` with ``WriteOp``/``ReadOp`` returning
``WriteOk``/``ReadOk(value)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

from .spec import SequentialSpec


@dataclass(frozen=True)
class WriteOp:
    value: Any


@dataclass(frozen=True)
class ReadOp:
    pass


@dataclass(frozen=True)
class WriteOk:
    pass


@dataclass(frozen=True)
class ReadOk:
    value: Any


@dataclass(frozen=True)
class Register(SequentialSpec):
    value: Any

    def invoke(self, op: Any) -> Tuple["Register", Any]:
        if isinstance(op, WriteOp):
            return Register(op.value), WriteOk()
        if isinstance(op, ReadOp):
            return self, ReadOk(self.value)
        raise TypeError(f"unknown register op {op!r}")
