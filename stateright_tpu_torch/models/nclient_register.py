"""N-client write-once register.

A copy of the JAX package's ``models.nclient_register``:
``n_clients`` interchangeable clients race to write one write-once
register, then read it back. Each client runs a three-step program —
idle → wrote → done — recording whether its write WON (the register
was still empty) and the value its read observed. All clients write
the same value, so the only interesting state is the race outcome:
exactly one client wins, every read after a write observes it. Class
and field names match the JAX package's, so host fingerprints and
encoded paths are identical. ``representative_full`` is the host
oracle of the device symmetry spec (models/nclient_register_tpu.py).

Closed-form counts:
  raw unique states   = 1 + 2n·3^(n-1)   (n=2: 13, n=3: 55, n=4: 217,
                                          n=8: 34,993)
  canonical orbits    = 1 + n(n+1)       (n=2: 7,  n=3: 13, n=4: 21,
                                          n=8: 73)

The device encoding is
:mod:`stateright_tpu_torch.models.nclient_register_tpu`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple

from ..model import Model, Property
from ..symmetry import RewritePlan

#: per-client program counter
_IDLE, _WROTE, _DONE = 0, 1, 2


@dataclass(frozen=True)
class NClientRegState:
    #: per-client (pc, won, rv) — program counter, did-my-write-win,
    #: read value; the register itself is ``reg``
    clients: Tuple[Tuple[int, int, int], ...]
    reg: int

    def representative(self) -> "NClientRegState":
        """Canonicalize under client permutation: stable-sort the
        FULL per-client tuple, so the canonicalizer is constant on
        orbits."""
        plan = RewritePlan.from_values_to_sort(list(self.clients))
        return NClientRegState(
            clients=tuple(plan.reindex(self.clients)), reg=self.reg
        )

    def representative_full(self) -> "NClientRegState":
        """Already the full-tuple sort: the host oracle of the device
        canonicalization coincides with ``representative()``."""
        return self.representative()


@dataclass
class NClientRegSys(Model):
    """``n_clients`` clients, one write-once register."""

    n_clients: int

    def to_encoded(self):
        """The device encoding (the wave engine discovers this hook)."""
        from .nclient_register_tpu import NClientRegEncoded

        return NClientRegEncoded(self.n_clients)

    def init_states(self) -> Sequence[NClientRegState]:
        return [
            NClientRegState(
                clients=tuple((_IDLE, 0, 0) for _ in range(self.n_clients)),
                reg=0,
            )
        ]

    def actions(self, state: NClientRegState):
        actions = []
        for c, (pc, _won, _rv) in enumerate(state.clients):
            if pc == _IDLE:
                actions.append(("write", c))
            elif pc == _WROTE:
                actions.append(("read", c))
        return actions

    def next_state(
        self, state: NClientRegState, action
    ) -> Optional[NClientRegState]:
        kind, c = action
        pc, won, rv = state.clients[c]
        if kind == "write":
            client = (_WROTE, int(state.reg == 0), rv)
            return replace(
                state, clients=self._with(state, c, client), reg=1
            )
        if kind == "read":
            client = (_DONE, won, state.reg)
            return replace(state, clients=self._with(state, c, client))
        raise ValueError(f"unknown action {action!r}")

    @staticmethod
    def _with(state: NClientRegState, c: int, client):
        return state.clients[:c] + (client,) + state.clients[c + 1:]

    def properties(self):
        return [
            Property.sometimes(
                "all done",
                lambda m, s: all(pc == _DONE for pc, _, _ in s.clients),
            ),
            Property.sometimes(
                "lost write",
                lambda m, s: any(
                    pc != _IDLE and won == 0 for pc, won, _ in s.clients
                ),
            ),
            Property.always(
                "at most one winner",
                lambda m, s: sum(won for _, won, _ in s.clients) <= 1,
            ),
            Property.always(
                "reads see the write",
                lambda m, s: all(
                    rv == 1 for pc, _, rv in s.clients if pc == _DONE
                ),
            ),
        ]
