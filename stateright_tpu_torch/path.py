"""Counterexample / example paths through a model's state graph.

A copy of the JAX package's ``path`` module, cut to what the slice
uses. Mirrors the reference's ``Path<State, Action>`` (stateright
src/checker/path.rs:16-198): a path is a sequence of states joined by
actions. The device engine stores only fingerprints; a ``Path`` is
rebuilt afterwards by replaying the model.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

from .fingerprint import fingerprint
from .model import Action, Model, State


class Path:
    """A sequence ``[(state, action_to_next), ..., (final_state, None)]``.

    Matches path.rs:16's ``Vec<(State, Option<Action>)>`` layout.
    """

    def __init__(self, steps: list[tuple[State, Optional[Action]]]):
        if not steps:
            raise ValueError("path cannot be empty")
        self.steps = steps

    @staticmethod
    def from_fingerprints(model: Model, fps: Sequence[int]) -> "Path":
        """Replay ``model`` to recover states/actions from a digest trace
        (path.rs:20-97), raising on an unreplayable trace."""
        if not fps:
            raise ValueError("empty fingerprint trace")
        state = None
        for init in model.init_states():
            if fingerprint(init) == fps[0]:
                state = init
                break
        if state is None:
            raise RuntimeError(
                f"no init state matches fingerprint {fps[0]:#x}; "
                "is the model deterministic?"
            )
        steps: list[tuple[State, Optional[Action]]] = []
        for next_fp in fps[1:]:
            found = False
            for action in model.actions(state):
                next_state = model.next_state(state, action)
                if next_state is not None and fingerprint(next_state) == next_fp:
                    steps.append((state, action))
                    state = next_state
                    found = True
                    break
            if not found:
                raise RuntimeError(
                    f"no successor of state with fingerprint "
                    f"{fingerprint(state):#x} matches {next_fp:#x}; "
                    "is the model deterministic?"
                )
        steps.append((state, None))
        return Path(steps)

    @staticmethod
    def final_state_of(model: Model, fps: Sequence[int]) -> Optional[State]:
        """Replay just far enough to return the last state (path.rs:134-165),
        or None where the trace does not replay."""
        try:
            return Path.from_fingerprints(model, fps).last_state()
        except RuntimeError:
            return None

    def last_state(self) -> State:
        return self.steps[-1][0]

    def states(self) -> list[State]:
        return [s for s, _ in self.steps]

    def actions(self) -> list[Action]:
        return [a for _, a in self.steps if a is not None]

    def fingerprints(self) -> list[int]:
        return [fingerprint(s) for s, _ in self.steps]

    def encode(self) -> str:
        """Serialize as ``fp/fp/fp`` for Explorer URLs (path.rs:189-198)."""
        return "/".join(str(fp) for fp in self.fingerprints())

    @staticmethod
    def decode(encoded: str) -> list[int]:
        return [int(part) for part in encoded.split("/") if part]

    def __len__(self) -> int:
        return len(self.steps)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Path) and self.steps == other.steps

    def __hash__(self) -> int:
        return hash(self.encode())

    def __repr__(self) -> str:
        parts = []
        for state, action in self.steps:
            if action is not None:
                parts.append(f"{state!r} --{action!r}-->")
            else:
                parts.append(repr(state))
        return "Path(" + " ".join(parts) + ")"
