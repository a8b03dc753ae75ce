"""Vectorized shared-counter models (increment / increment_lock).

The port of ``stateright_tpu.models.increment_tpu``: the host half
(``encode``, ``decode``, ``init_vecs``) is copied, and the dense step
and the property lanes are batched functions over lane-major ``[W, N]``
int64 blocks (encoding.py). Dense only, as in the JAX package: there is
no sparse dispatch, so the engine always runs the dense wave.

Layout (``width = 1 + ceil(N/4)`` lanes, at most 8 threads):

  lane 0:       bits 0-3 shared counter i, bit 4 lock flag
  lanes 1..:    threads packed 8 bits each: t (4b) | pc (3b)

Each thread has at most one enabled action at any pc, so
``max_actions = thread_count`` — action k is "thread k takes its
enabled step". Every field stays below 16, so no lane leaves its 32
bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..encoding import EncodedModelBase, stack_slots
from .increment import Increment, IncrementLock, IncrementState, ProcState


class _IncrementEncodedBase(EncodedModelBase):
    #: lock-guarded program or racy program
    locked: bool

    def __init__(self, host_model, thread_count: int):
        if thread_count > 8:
            raise ValueError("encoding supports at most 8 threads")
        self.n = thread_count
        self.width = 1 + (thread_count + 3) // 4
        self.max_actions = thread_count
        self.host_model = host_model

    def cache_key(self):
        """The JAX encoding's identity, so that a snapshot's encoding
        fingerprint (checkpoint.py) is equal across the two packages."""
        return (type(self).__name__, self.n)

    # -- host side -------------------------------------------------------

    def encode(self, state: IncrementState) -> np.ndarray:
        vec = np.zeros(self.width, dtype=np.uint32)
        vec[0] = state.i | (int(state.lock) << 4)
        for tid, proc in enumerate(state.s):
            lane, shift = 1 + tid // 4, (tid % 4) * 8
            vec[lane] |= (proc.t | (proc.pc << 4)) << shift
        return vec

    def decode(self, vec: np.ndarray) -> IncrementState:
        vec = np.asarray(vec)
        procs = []
        for tid in range(self.n):
            lane, shift = 1 + tid // 4, (tid % 4) * 8
            raw = (int(vec[lane]) >> shift) & 0xFF
            procs.append(ProcState(t=raw & 0xF, pc=raw >> 4))
        return IncrementState(
            i=int(vec[0]) & 0xF,
            lock=bool(int(vec[0]) & 0x10),
            s=tuple(procs),
        )

    def init_vecs(self) -> np.ndarray:
        return np.stack(
            [self.encode(s) for s in self.host_model.init_states()]
        )

    # -- device side -----------------------------------------------------

    def _thread_fields(self, states_t, tid):
        lane, shift = 1 + tid // 4, (tid % 4) * 8
        raw = (states_t[lane] >> shift) & 0xFF
        return raw & 0xF, raw >> 4

    def step_cols(self, states_t: torch.Tensor) -> tuple:
        """The dense step (JAX ``step_vec``): ``[W, N] -> (succ [W, N,
        K], valid bool[N, K], None)``; slot ``tid`` is thread ``tid``'s
        one step, its next state computed branchlessly per pc."""
        i = states_t[0] & 0xF
        lock = (states_t[0] & 0x10) != 0
        succs, valids = [], []
        for tid in range(self.n):
            t, pc = self._thread_fields(states_t, tid)
            if self.locked:
                # pc 0 -lock-> 1 -read-> 2 -write-> 3 -release-> 4
                valid = (((pc == 0) & ~lock) | (pc == 1) | (pc == 2)
                         | ((pc == 3) & lock))
            else:
                # pc 1 -read-> 2 -write-> 3
                valid = (pc == 1) | (pc == 2)
            lane, shift = 1 + tid // 4, (tid % 4) * 8
            new_t = torch.where(pc == 1, i, t)
            raw = (new_t | ((pc + 1) << 4)) << shift
            lanes = list(states_t)
            lanes[lane] = (states_t[lane] & ~(0xFF << shift)) | raw
            new_i = torch.where(pc == 2, t + 1, i)
            new_lock = torch.where(pc == 0, True,
                                   torch.where(pc == 3, False, lock))
            lanes[0] = new_i | (new_lock.to(torch.int64) << 4)
            succs.append(lanes)
            valids.append(valid)
        return (*stack_slots(succs, valids), None)

    def _counts(self, states_t):
        i = states_t[0] & 0xF
        done = torch.zeros_like(i)
        critical = torch.zeros_like(i)
        for tid in range(self.n):
            _, pc = self._thread_fields(states_t, tid)
            done = done + (pc >= 3).to(torch.int64)
            critical = critical + ((pc >= 1) & (pc < 4)).to(torch.int64)
        return i, done, critical


class IncrementLockEncoded(_IncrementEncodedBase):
    locked = True

    def __init__(self, thread_count: int):
        super().__init__(IncrementLock(thread_count), thread_count)

    def property_conditions_cols(self,
                                 states_t: torch.Tensor) -> torch.Tensor:
        """``bool[N, 2]``: [always fin, always mutex]."""
        i, done, critical = self._counts(states_t)
        return torch.stack([done == i, critical <= 1], dim=1)


class IncrementEncoded(_IncrementEncodedBase):
    locked = False

    def __init__(self, thread_count: int):
        super().__init__(Increment(thread_count), thread_count)

    def property_conditions_cols(self,
                                 states_t: torch.Tensor) -> torch.Tensor:
        """``bool[N, 1]``: [always fin]."""
        i, done, _ = self._counts(states_t)
        return torch.stack([done == i], dim=1)
