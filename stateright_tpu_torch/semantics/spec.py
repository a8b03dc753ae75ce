"""``SequentialSpec``: operational semantics of a reference object.

A copy of the JAX package's ``semantics.spec``. Counterpart of
stateright src/semantics.rs:73-98, immutably: a spec
value is a snapshot of the reference object's state; ``invoke``
returns ``(next_spec, ret)`` instead of mutating.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple


class SequentialSpec:
    """Subclasses implement ``invoke``; ``is_valid_step`` defaults to
    invoke-and-compare (semantics.rs:84-98)."""

    def invoke(self, op: Any) -> Tuple["SequentialSpec", Any]:
        raise NotImplementedError

    def is_valid_step(self, op: Any, ret: Any) -> Optional["SequentialSpec"]:
        """Return the successor spec if ``op`` may return ``ret`` here,
        else None."""
        next_spec, actual = self.invoke(op)
        return next_spec if actual == ret else None

    def is_valid_history(self, history: Sequence[Tuple[Any, Any]]) -> bool:
        """Whether a sequential (op, ret) history is legal
        (semantics.rs:90-98)."""
        spec: Optional[SequentialSpec] = self
        for op, ret in history:
            spec = spec.is_valid_step(op, ret)
            if spec is None:
                return False
        return True
