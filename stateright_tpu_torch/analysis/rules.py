"""The one record the analyzer reports: :class:`Finding`.

A copy of the JAX package's ``analysis.rules.Finding`` with the same
fields and serialization, so that a port certificate
(``SOUND_r*.json``) reads like a JAX one. The JAX module's rule
registries (the kernel-lint ``RULES`` and ``COMMS_RULES``) check XLA
codegen contracts and have no counterpart here (analysis/__init__.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class Finding:
    """One obligation's outcome, attributed to the source line that
    traced it where there is one."""

    rule: str
    severity: str  # "error" | "info"
    encoding: str
    path: str
    message: str
    primitive: Optional[str] = None
    source: Optional[str] = None
    data: dict = field(default_factory=dict)

    def format(self) -> str:
        loc = f" @ {self.source}" if self.source else ""
        return (
            f"[{self.rule}] {self.encoding} / {self.path}: "
            f"{self.message}{loc}"
        )

    def as_dict(self) -> dict:
        """The JSON-artifact record of one finding."""
        return dict(
            rule=self.rule,
            severity=self.severity,
            encoding=self.encoding,
            path=self.path,
            message=self.message,
            primitive=self.primitive,
            source=self.source,
            **({"data": self.data} if self.data else {}),
        )
