"""Device-resident visited set: open addressing over packed int64 keys.

The PyTorch counterpart of ``stateright_tpu.ops.hashset``: a
fixed-capacity power-of-two table of 64-bit fingerprints with batched
insert-if-absent, the visited set of the hash wave engine
(checkers/tpu.py ``TpuBfsChecker``). The JAX table is two ``uint32``
limb arrays with ``(0, 0)`` as the empty slot; here a slot is ONE
packed int64 key (``ops.fingerprint.pack_keys``, the form the engines
carry) and the empty slot is :data:`EMPTY`, the packed ``(0, 0)`` —
fingerprints are never 0, so no key is ever :data:`EMPTY`.

:func:`insert` has two versions, chosen by the device of its inputs:

* the plain version (:func:`insert_plain`): the JAX algorithm round by
  round. Every pending row reads its slot; rows that want an empty slot
  claim it with a scatter-max of ``row + 1`` into a claim array, the
  highest row wins and writes its key, claim losers re-read their slot
  the next round (the winner may hold their own key), and rows that
  meet another key advance their own triangular probe sequence. It
  gives the JAX ``insert``'s ``table``, ``is_new``, ``overflow`` and
  ``slot`` array for array;
* a hand-written CUDA kernel (``csrc/hashset.cu``, :func:`insert_cuda`),
  two launches: one thread a row walks the same probe sequence with a
  64-bit ``atomicCAS`` and claims the slot of a key new in this call
  with an ``atomicMax`` on the slot's tag, then the rows of new keys
  read the tag back, which keeps the JAX winner: of the rows holding
  one key that was absent, the highest reports ``is_new``. Which slot a
  key lands in may differ from the plain version's (it depends on the
  order in which DIFFERENT keys claim slots); nothing the engine reports
  depends on it but overflow in a nearly full table.

A tensor on the CPU takes the plain version; a tensor on a CUDA device
launches the kernel, and the kernel either runs or raises — there is no
fallback. ``insert_cuda.launches`` counts the kernel's calls.

:func:`insert_dev` is the DEVICE-COUNT entry point the hash engine's
chunked wave calls: the key count is a 0-d int64 tensor on the device,
read by the kernels, the key buffer is fixed-capacity with anything
past the count, and the call's epoch is a device counter the call
advances itself, so the launch replays in a CUDA graph (where a host
epoch would be frozen at capture). It launches the same kernels
through the same wrapper (``insert_cuda(..., n=, epoch=)``), whose
count takes a replayed launch at each replay
(``cuda_build.note_launch``).

The table is updated IN PLACE (the JAX op returns a new table): a
wave's insert into a 2^25-slot table would otherwise copy 268 MB of
keys (537 MB of entries on the card).
:func:`insert` still returns the table, so callers read like the JAX
ones.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .cuda_build import note_launch
from .fingerprint import unpack_keys

#: the JAX probe bound (``ops/hashset.py`` ``PROBE_ROUNDS``)
PROBE_ROUNDS = 24

#: the empty slot: the packed key of the ``(0, 0)`` limb pair, int64 min
EMPTY = -(1 << 63)

_M32 = 0xFFFFFFFF
_SOURCE = "hashset.cu"


@dataclass
class DeviceHashSet:
    """Table state: ``keys`` holds one packed key a slot (:data:`EMPTY`
    where free).

    A tagged table (every table on a CUDA device) is ``entries``, an
    int64 ``[capacity, 2]`` array of 16-byte ``{key, tag}`` slots, and
    ``keys`` is its strided view ``entries[:, 0]``. A tag is the CUDA
    kernel's claim, ``epoch << 32 | row + 1`` of the highest row of the
    call ``epoch`` that filled the slot; an empty slot's tag is 0, and
    must be (csrc/hashset.cu). ``epoch`` counts the calls on the table.
    On the CPU a table is its key array alone, as JAX's is. Make tables
    with :meth:`empty` or :meth:`from_keys`, and restore one with
    :meth:`reset`: each writes every entry whole."""

    keys: torch.Tensor
    entries: Optional[torch.Tensor] = None
    epoch: int = 0

    @staticmethod
    def empty(capacity: int, device=None) -> "DeviceHashSet":
        return DeviceHashSet.from_keys(torch.full(
            (capacity,), EMPTY, dtype=torch.int64, device=device))

    @staticmethod
    def from_keys(keys: torch.Tensor) -> "DeviceHashSet":
        """A table holding a copy of ``keys``, one packed key a slot
        (:data:`EMPTY` where free), tagged by :meth:`reset`'s rule when
        ``keys`` lie on a CUDA device."""
        capacity = keys.shape[0]
        if capacity & (capacity - 1):
            raise ValueError(f"capacity must be a power of two: {capacity}")
        if keys.device.type != "cuda":
            return DeviceHashSet(keys.clone())
        entries = torch.empty((capacity, 2), dtype=torch.int64,
                              device=keys.device)
        table = DeviceHashSet(entries[:, 0], entries)
        table.reset(keys)
        return table

    def reset(self, keys: torch.Tensor) -> None:
        """Make the table hold ``keys`` again, whole: the keys, then on a
        tagged table every full slot's tag 1 (epoch 0, row 0) and every
        empty slot's 0, and the epoch 0, so every call's claims beat the
        tags."""
        self.keys.copy_(keys)
        if self.entries is not None:
            self.entries[:, 1].copy_(keys != EMPTY)
        self.epoch = 0

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def lo(self) -> torch.Tensor:
        """The JAX table's ``lo`` limb array (0 where empty)."""
        return unpack_keys(self.keys)[0]

    @property
    def hi(self) -> torch.Tensor:
        """The JAX table's ``hi`` limb array (0 where empty)."""
        return unpack_keys(self.keys)[1]

    def occupied(self) -> torch.Tensor:
        return self.keys != EMPTY


def _slot_hash(keys: torch.Tensor, mask: int) -> torch.Tensor:
    """The JAX ``_slot_hash`` of packed keys, bit for bit: the product
    ``hi * 0x9E3779B9`` keeps its low 32 bits (int64 wrap-around leaves
    them exact), and ``>> 16`` shifts a value below 2^32."""
    lo, hi = unpack_keys(keys)
    x = lo ^ ((hi * 0x9E3779B9) & _M32)
    x = x ^ (x >> 16)
    return x & mask


def sort_unique(keys: torch.Tensor):
    """Sort packed keys (by ``(hi, lo)``) and mark the first of each run:
    ``((sorted_keys, order), first)`` — the stable sort, the permutation
    that produced it, and ``first[i]`` True iff sorted position i is the
    first of its key (the JAX ``sort_unique``)."""
    sorted_keys, order = torch.sort(keys, stable=True)
    first = torch.ones_like(sorted_keys, dtype=torch.bool)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    return (sorted_keys, order), first


def insert_plain(table: DeviceHashSet, keys: torch.Tensor,
                 active: Optional[torch.Tensor] = None,
                 rounds: int = PROBE_ROUNDS
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX insert, round-synchronous (``stateright_tpu/ops/hashset.py``
    ``_insert_jax``): ``(is_new, overflow, slot)``, the table updated in
    place. ``active=None`` means every row. The loop ends when no row is
    pending, after at most ``rounds + n`` rounds: every round with a
    pending row inserts, matches or advances one; a key overflows when
    its probe DEPTH reaches ``rounds``."""
    n = keys.shape[0]
    dev = keys.device
    cap = table.capacity
    mask = cap - 1
    tkeys = table.keys
    row1 = torch.arange(1, n + 1, dtype=torch.int64, device=dev)
    idx = _slot_hash(keys, mask)
    probe = torch.zeros(n, dtype=torch.int64, device=dev)
    pending = (torch.ones(n, dtype=torch.bool, device=dev)
               if active is None else active.clone())
    inserted = torch.zeros(n, dtype=torch.bool, device=dev)
    overflow = torch.zeros(n, dtype=torch.bool, device=dev)
    slot = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(rounds + n):
        if not bool(pending.any()):
            break
        cur = tkeys[idx]
        is_empty = cur == EMPTY
        is_match = cur == keys
        slot = torch.where(pending & is_match, idx, slot)
        pending = pending & ~is_match
        # claim empty slots: scatter-max of row ids, the winner writes
        want = pending & is_empty
        claims = torch.zeros(cap, dtype=torch.int64, device=dev)
        claims.scatter_reduce_(0, idx, torch.where(want, row1, 0), "amax")
        won = want & (claims[idx] == row1)
        tkeys[idx[won]] = keys[won]
        inserted |= won
        slot = torch.where(won, idx, slot)
        pending = pending & ~won
        # advance only rows that saw a different key; claim losers
        # re-read their slot
        advance = pending & ~is_empty & ~is_match
        probe = torch.where(advance, probe + 1, probe)
        idx = torch.where(advance, (idx + probe) & mask, idx)
        exhausted = pending & (probe >= rounds)
        overflow |= exhausted
        pending = pending & ~exhausted
    if table.entries is not None:  # tag as the kernel does: the winner
        epoch = _next_epoch(table)
        table.entries[slot[inserted], 1] = (epoch << 32) | row1[inserted]
    return inserted, overflow | pending, slot


def _next_epoch(table: DeviceHashSet) -> int:
    """Count one more call on ``table`` (tags pack the epoch in 31 bits)."""
    if table.epoch >= (1 << 31) - 1:
        raise RuntimeError("hash table epoch exhausted (2^31 - 1 calls)")
    table.epoch += 1
    return table.epoch


# -- the CUDA kernel ---------------------------------------------------------


def _lib() -> ctypes.CDLL:
    from .cuda_build import load

    lib = load(_SOURCE)
    if not getattr(lib, "stpu_bound", False):
        fn = lib.stpu_hash_insert
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # keys, active, n
            ctypes.c_void_p,  # entries
            ctypes.c_int64, ctypes.c_int, ctypes.c_int,  # mask, rounds, epoch
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # slot, is_new, overflow
            ctypes.c_void_p, ctypes.c_void_p,  # n, epoch on the device (or None)
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        lib.stpu_bound = True
    return lib


def _check_cuda(table: DeviceHashSet, keys: torch.Tensor,
                active: Optional[torch.Tensor], rounds: int) -> None:
    dev = table.keys.device
    tensors = [table.keys, keys] + ([] if active is None else [active])
    if any(t.device.type != "cuda" or t.device != dev for t in tensors):
        raise ValueError(
            "the CUDA hash insert needs the table and keys on one CUDA "
            f"device, got {[str(t.device) for t in tensors]}"
        )
    ent = table.entries
    if (ent is None or ent.dtype != torch.int64
            or ent.shape != (table.capacity, 2) or not ent.is_contiguous()
            or table.keys.data_ptr() != ent.data_ptr()):
        raise ValueError(
            "the CUDA hash insert takes a tagged table (DeviceHashSet.empty "
            "or from_keys on the device): contiguous int64 {key, tag} "
            "entries of shape [capacity, 2] under its keys"
        )
    if ent.data_ptr() % 16:
        raise ValueError(
            f"the table's entries must be 16-byte aligned, got address "
            f"{ent.data_ptr():#x}"
        )
    if (keys.dtype != torch.int64 or keys.dim() != 1
            or not keys.is_contiguous()):
        raise ValueError(
            "the CUDA hash insert takes contiguous 1-D int64 packed keys, "
            f"got {keys.dtype} shape {tuple(keys.shape)}"
        )
    if active is not None and (active.dtype != torch.bool
                               or active.shape != keys.shape
                               or not active.is_contiguous()):
        raise ValueError(
            "active must be a contiguous bool tensor shaped like keys, "
            f"got {active.dtype} shape {tuple(active.shape)}"
        )
    if keys.numel() >= _M32:
        raise ValueError(
            f"at most 2^32 - 2 keys a call (claims pack row + 1 in 32 "
            f"bits), got {keys.numel()}"
        )
    if not 1 <= rounds < (1 << 31):
        raise ValueError(f"rounds must be >= 1: {rounds}")


def insert_cuda(table: DeviceHashSet, keys: torch.Tensor,
                active: Optional[torch.Tensor] = None,
                rounds: int = PROBE_ROUNDS, *, n: torch.Tensor = None,
                epoch: torch.Tensor = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA insert (see the module docstring): ``(is_new, overflow,
    slot)``, the table updated in place, two kernels on the current
    stream and no sync.

    With ``n`` and ``epoch`` (0-d int64 tensors on the keys' device; see
    :func:`insert_dev`) the key count is the first ``n`` rows of
    ``keys``, read by the kernels over a grid of ``len(keys)`` rows, and
    the call's epoch is taken from the device counter ``epoch``, which
    this call advances on the device first (``table.epoch`` is left
    alone: a table is driven by device epochs or host ones, not both);
    only rows ``[0, n)`` of the outputs are written."""
    _check_cuda(table, keys, active, rounds)
    if (n is None) != (epoch is None):
        raise ValueError("pass both n and epoch, or neither")
    for t in (n, epoch):
        if t is not None and (t.device != keys.device
                              or t.dtype != torch.int64 or t.dim()):
            raise ValueError(
                "n and epoch must be 0-d int64 tensors on the keys' device")
    cap = keys.numel()
    dev = keys.device
    # the kernels write every (live) row of all three
    is_new = torch.empty(cap, dtype=torch.bool, device=dev)
    overflow = torch.empty(cap, dtype=torch.bool, device=dev)
    slot = torch.empty(cap, dtype=torch.int64, device=dev)
    if cap == 0:
        return is_new, overflow, slot
    if epoch is None:
        host_epoch = _next_epoch(table)
    else:
        host_epoch = 0
        epoch.add_(1)
    fn = _lib().stpu_hash_insert
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(keys.data_ptr(),
                 None if active is None else active.data_ptr(), cap,
                 table.entries.data_ptr(), table.capacity - 1, rounds,
                 host_epoch, slot.data_ptr(), is_new.data_ptr(),
                 overflow.data_ptr(), None if n is None else n.data_ptr(),
                 None if epoch is None else epoch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"stpu_hash_insert launch failed: CUDA error {err}")
    note_launch(insert_cuda)
    return is_new, overflow, slot


insert_cuda.launches = 0


def insert_plain_dev(table: DeviceHashSet, keys: torch.Tensor,
                     active: Optional[torch.Tensor], n: torch.Tensor,
                     rounds: int = PROBE_ROUNDS
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the device-count insert: :func:`insert_plain`
    of the first ``n`` rows where ``active`` (rows past ``n`` report no
    insert, no overflow, slot 0). Host tensors, where reading ``n``
    costs no device sync, so it probes the live rows only."""
    n = int(n)
    cap = keys.numel()
    is_new = torch.zeros(cap, dtype=torch.bool, device=keys.device)
    overflow = torch.zeros_like(is_new)
    slot = torch.zeros(cap, dtype=torch.int64, device=keys.device)
    is_new[:n], overflow[:n], slot[:n] = insert_plain(
        table, keys[:n], None if active is None else active[:n], rounds)
    return is_new, overflow, slot


# -- entry points ------------------------------------------------------------


def insert(table: DeviceHashSet, keys: torch.Tensor,
           active: Optional[torch.Tensor] = None,
           rounds: int = PROBE_ROUNDS, *, impl: str = "auto"
           ) -> Tuple[DeviceHashSet, torch.Tensor, torch.Tensor,
                      torch.Tensor]:
    """Insert the packed ``keys`` where ``active`` (every row when None);
    return ``(table, is_new, overflow, slot)`` as the JAX ``insert``
    does, the table updated in place.

    ``is_new[i]``: key i was absent and row i is the highest row holding
    it; ``overflow[i]``: probing exhausted ``rounds`` slots of other
    keys; ``slot[i]``: the slot key i is at (0 for inactive and
    overflowed rows). The kernel for CUDA tensors (``impl="cuda"``
    demands it), the plain version for CPU tensors."""
    if impl not in ("auto", "cuda"):
        raise ValueError(f"impl must be 'auto' or 'cuda', got {impl!r}")
    if impl == "cuda" and keys.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, got {keys.device}")
    if keys.device.type == "cuda":
        return (table, *insert_cuda(table, keys, active, rounds))
    return (table, *insert_plain(table, keys, active, rounds))


def insert_dev(table: DeviceHashSet, keys: torch.Tensor,
               active: Optional[torch.Tensor], n: torch.Tensor,
               epoch: torch.Tensor, rounds: int = PROBE_ROUNDS
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Insert the first ``n`` packed ``keys`` where ``active``, with the
    count ``n`` and the epoch counter ``epoch`` (see
    :func:`insert_cuda`) as 0-d int64 tensors on the keys' device:
    ``(is_new, overflow, slot)``, rows past ``n`` unspecified. The
    kernel for CUDA tensors, the plain version for CPU tensors (which
    keep no tags, so the epoch is not used)."""
    if keys.device.type == "cuda":
        return insert_cuda(table, keys, active, rounds, n=n, epoch=epoch)
    return insert_plain_dev(table, keys, active, n, rounds)


def contains(table: DeviceHashSet, keys: torch.Tensor,
             rounds: int = PROBE_ROUNDS) -> torch.Tensor:
    """Membership probe (no mutation), the JAX ``contains``: ``rounds``
    steps of the insert's probe sequence."""
    mask = table.capacity - 1
    idx = _slot_hash(keys, mask)
    found = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    done = torch.zeros_like(found)
    for r in range(rounds):
        cur = table.keys[idx]
        is_match = cur == keys
        found |= ~done & is_match
        done |= is_match | (cur == EMPTY)
        idx = (idx + r + 1) & mask
    return found


def find(table: DeviceHashSet, keys: torch.Tensor,
         rounds: int = PROBE_ROUNDS) -> torch.Tensor:
    """The slot of each key, -1 where it is absent: :func:`contains`'s
    probe, keeping the slot where it met the key. Every round's slot is
    gathered at once (round ``r`` probes ``hash + r(r+1)/2``), so a
    lookup of a few keys from the host is a handful of launches and no
    read back."""
    mask = table.capacity - 1
    r = torch.arange(rounds, dtype=torch.int64, device=keys.device)
    idx = (_slot_hash(keys, mask).unsqueeze(-1) + r * (r + 1) // 2) & mask
    cur = table.keys[idx]
    hit = cur == keys.unsqueeze(-1)
    # the first round that met the key or an empty slot ends the probe
    first = (hit | (cur == EMPTY)).to(torch.int32).argmax(-1, keepdim=True)
    return torch.where(hit.gather(-1, first), idx.gather(-1, first),
                       torch.full_like(first, -1)).squeeze(-1)
