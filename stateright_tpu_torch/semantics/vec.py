"""Stack/vector reference object.

A copy of the JAX package's ``semantics.vec``. Counterpart of stateright
src/semantics/vec.rs:22-50: push/pop/len with stack semantics.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

from .spec import SequentialSpec


@dataclass(frozen=True)
class Push:
    value: Any


@dataclass(frozen=True)
class Pop:
    pass


@dataclass(frozen=True)
class Len:
    pass


@dataclass(frozen=True)
class PushOk:
    pass


@dataclass(frozen=True)
class PopOk:
    value: Optional[Any]


@dataclass(frozen=True)
class LenOk:
    length: int


@dataclass(frozen=True)
class Vec(SequentialSpec):
    values: Tuple[Any, ...] = ()

    def invoke(self, op: Any) -> Tuple["Vec", Any]:
        if isinstance(op, Push):
            return Vec(self.values + (op.value,)), PushOk()
        if isinstance(op, Pop):
            if not self.values:
                return self, PopOk(None)
            return Vec(self.values[:-1]), PopOk(self.values[-1])
        if isinstance(op, Len):
            return self, LenOk(len(self.values))
        raise TypeError(f"unknown vec op {op!r}")
