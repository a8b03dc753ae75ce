"""The system state of a checked actor model.

A copy of the JAX package's ``actor.model_state``. Counterpart of stateright src/actor/model_state.rs:12-18: per-actor
states, the network value, per-actor timer sets, crash flags, and the
auxiliary history. Immutable (functional updates via ``replace``);
unchanged actor states are shared by reference across system states,
matching the reference's ``Vec<Arc<A::State>>`` sharing.

The symmetry-reduction ``representative`` (model_state.rs:115-132)
lives in :mod:`stateright_tpu_torch.symmetry` and is attached here.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Tuple

from .network import Network


@dataclass(frozen=True)
class ActorModelState:
    actor_states: Tuple[Any, ...]
    network: Network
    timers_set: Tuple[frozenset, ...]
    crashed: Tuple[bool, ...]
    history: Any = ()

    def with_actor_state(self, index: int, state: Any) -> "ActorModelState":
        states = (
            self.actor_states[:index] + (state,) + self.actor_states[index + 1:]
        )
        return replace(self, actor_states=states)

    def with_timers(self, index: int, timers: frozenset) -> "ActorModelState":
        ts = self.timers_set[:index] + (timers,) + self.timers_set[index + 1:]
        return replace(self, timers_set=ts)


    def representative(self) -> "ActorModelState":
        """Canonical member of this state's symmetry class
        (model_state.rs:115-132). Requires the symmetry module."""
        from ..symmetry import actor_state_representative

        return actor_state_representative(self)
