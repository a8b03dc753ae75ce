"""Vectorized N-client write-once register.

The port of ``stateright_tpu.models.nclient_register_tpu``: the host
half (``encode``, ``decode``, ``init_vecs``, the guard-class words) is
copied, and the device half is batched over lane-major ``[W, N]`` int64
blocks (encoding.py). The encoding offers both contracts — the dense
``step_cols`` and sparse dispatch — and the engine runs it sparse by
default, as the JAX engine does.

Packed layout (``width = 2`` for up to 8 clients):
  lane 0: bit 0 — the write-once register
  lane 1: per-client 4-bit block at shift ``4c``:
          bits 0-1 pc (0=idle 1=wrote 2=done), bit 2 won, bit 3 rv

Actions (``max_actions = 2n``): slot ``2c`` = write(c), slot
``2c + 1`` = read(c). Every slot guard is a 2-bit field compare, so
the packed enabled words assemble from ``2n`` condition-gated host
class masks (the 2pc idiom, ops/bitmask.py).

The encoding declares the clients' permutation symmetry
(``device_rewrite_spec``, ops/canonical.py): with it the n-client space
of 1 + 2n·3^(n-1) states reduces to 1 + n(n+1) orbits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..encoding import EncodedModelBase, stack_slots
from ..ops.bitmask import mask_words, or_class_words, slot_mask_host
from ..ops.canonical import DeviceRewriteSpec, MemberField
from .nclient_register import NClientRegState, NClientRegSys

_IDLE, _WROTE, _DONE = 0, 1, 2


class NClientRegEncoded(EncodedModelBase):
    def __init__(self, n_clients: int):
        if n_clients > 8:
            raise ValueError(
                "packed register encoding supports up to 8 clients "
                f"(got {n_clients})"
            )
        self.n_clients = n_clients
        self.width = 2
        self.max_actions = 2 * n_clients
        self.host_model = NClientRegSys(n_clients=n_clients)
        K = self.max_actions
        #: host-constant guard-class masks: slot 2c gated on pc==idle,
        #: slot 2c+1 on pc==wrote
        self._bw = dict(
            write=[slot_mask_host(K, [2 * c]) for c in range(n_clients)],
            read=[slot_mask_host(K, [2 * c + 1]) for c in range(n_clients)],
        )

    def cache_key(self):
        """The JAX encoding's identity, so that a snapshot's encoding
        fingerprint (checkpoint.py) is equal across the two packages."""
        return self.n_clients

    # -- device symmetry -------------------------------------------------

    def device_rewrite_spec(self):
        """Client permutation symmetry: one strided 4-bit field on
        lane 1 holding the FULL per-client tuple (pc, won, rv), all
        of it in the sort key — a perfect canonicalizer, certified by
        the soundness analyzer (analysis/soundness.py)."""
        if self.n_clients < 2:
            return None
        return DeviceRewriteSpec(
            n_members=self.n_clients,
            fields=(
                MemberField(
                    lane=1, shift=0, stride=4, width=4, sort_key=True
                ),
            ),
        )

    # -- host side -------------------------------------------------------

    def encode(self, state: NClientRegState) -> np.ndarray:
        lane1 = 0
        for c, (pc, won, rv) in enumerate(state.clients):
            lane1 |= (pc | (won << 2) | (rv << 3)) << (4 * c)
        return np.array([state.reg, lane1], dtype=np.uint32)

    def decode(self, vec: np.ndarray) -> NClientRegState:
        vec = np.asarray(vec)
        lane0, lane1 = int(vec[0]), int(vec[1])
        clients = []
        for c in range(self.n_clients):
            block = (lane1 >> (4 * c)) & 0xF
            clients.append((block & 3, (block >> 2) & 1, (block >> 3) & 1))
        return NClientRegState(clients=tuple(clients), reg=lane0 & 1)

    def init_vecs(self) -> np.ndarray:
        return np.stack(
            [self.encode(s) for s in self.host_model.init_states()]
        )

    # -- device side -----------------------------------------------------

    def _blocks(self, lane0, lane1, sh):
        """The write and read successors' lane-1 blocks of the client at
        shift ``sh`` (a python int or a per-pair tensor), and its
        cleared lane 1."""
        reg = lane0 & 1
        won_new = (1 - reg) & 1
        block = (lane1 >> sh) & 0xF
        clear = lane1 & ~(0xF << sh)
        # write(c): pc 0→1, won := (reg was 0), register set.
        wr_block = (block & ~0x7) | _WROTE | (won_new << 2)
        # read(c): pc 1→2, rv := reg, won kept.
        rd_block = (block & ~0xB) | _DONE | (reg << 3)
        return block, clear, wr_block, rd_block

    def step_cols(self, states_t: torch.Tensor) -> tuple:
        """The dense step (JAX ``step_vec``): ``[2, N] -> (succ [2, N,
        K], valid bool[N, K], None)`` — branchless bitfield updates
        mirroring NClientRegSys.next_state()."""
        lane0, lane1 = states_t[0], states_t[1]
        succs, valids = [], []
        for c in range(self.n_clients):
            sh = 4 * c
            block, clear, wr_block, rd_block = self._blocks(lane0, lane1,
                                                            sh)
            pc = block & 3
            succs += [[lane0 | 1, clear | (wr_block << sh)],
                      [lane0, clear | (rd_block << sh)]]
            valids += [pc == _IDLE, pc == _WROTE]
        return (*stack_slots(succs, valids), None)

    def enabled_bits_cols(self, states_t: torch.Tensor) -> torch.Tensor:
        """``[2, N] -> int64[N, ceil(K/32)]`` packed enabled mask from
        ``2n`` condition-gated host class masks."""
        lane1 = states_t[1]
        classes = []
        for c in range(self.n_clients):
            pc = (lane1 >> (4 * c)) & 3
            classes.append((pc == _IDLE, self._bw["write"][c]))
            classes.append((pc == _WROTE, self._bw["read"][c]))
        return or_class_words(classes, mask_words(self.max_actions))

    def step_slot_cols(self, states_t: torch.Tensor,
                       slots: torch.Tensor) -> tuple:
        """Successors of (state, enabled slot) pairs, ``[2, N]``, and no
        truncation flags: selects over the slot arithmetic (``c = slot
        >> 1``, action kind ``slot & 1``)."""
        lane0, lane1 = states_t[0], states_t[1]
        slots = slots.to(torch.int64)
        j = slots & 1
        sh = 4 * (slots >> 1)
        _, clear, wr_block, rd_block = self._blocks(lane0, lane1, sh)
        nb = torch.where(j == 0, wr_block, rd_block)
        l0 = torch.where(j == 0, lane0 | 1, lane0)
        return torch.stack([l0, clear | (nb << sh)]), None, None

    def property_conditions_cols(self,
                                 states_t: torch.Tensor) -> torch.Tensor:
        """``bool[N, 4]``: [sometimes all done, sometimes lost write,
        always at most one winner, always reads see the write] — order
        matches NClientRegSys.properties()."""
        n = self.n_clients
        shifts = 4 * torch.arange(n, dtype=torch.int64,
                                  device=states_t.device)
        blocks = (states_t[1][None, :] >> shifts[:, None]) & 0xF
        pc = blocks & 3
        won = (blocks >> 2) & 1
        rv = (blocks >> 3) & 1
        all_done = (pc == _DONE).all(dim=0)
        lost = ((pc != _IDLE) & (won == 0)).any(dim=0)
        at_most_one = won.sum(dim=0) <= 1
        reads_ok = ((pc != _DONE) | (rv == 1)).all(dim=0)
        return torch.stack([all_done, lost, at_most_one, reads_ok], dim=1)
