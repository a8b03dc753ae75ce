#!/usr/bin/env python3
"""Time each kernel of the hash insert apart, on one CUDA card.

    python3 tools/hash_insert_passes.py [--source PATH] [--reps N]
                                        [--json PATH]

It builds a shim that ``#include``s a ``hashset.cu`` source (the
package's ``stateright_tpu_torch/csrc/hashset.cu`` by default, or the
earlier three-pass one, unpacked into the git-ignored ``build/``::

    mkdir -p build/three_pass && git archive 1348950 \
        stateright_tpu_torch/csrc/hashset.cu | tar -x -C build/three_pass
    python3 tools/hash_insert_passes.py \
        --source build/three_pass/stateright_tpu_torch/csrc/hashset.cu

), and launches each of its kernels on its own, with a CUDA event after
each. Two designs are known by their kernels:

* three passes (``probe_kernel``, ``claim_kernel``, ``winner_kernel``
  over a key table and the ``fresh`` / ``claim`` side arrays);
* two passes (``probe_claim_kernel``, ``winner_kernel`` over one
  ``{key, tag}`` entry array, made by ``DeviceHashSet.from_keys``).

Every repetition starts from the same table, restored by a whole-table
copy outside the timed events (it also leaves L2 cold), with all
launches queued behind a device sleep. Shapes:

* ``chip_smoke.py``'s ``hash insert kernel`` inputs: 16,395,948 keys
  drawn from a pool of a quarter as many into an empty 2^25 table, and
  into a half-full one with a tenth of the rows inactive;
* the widest waves of ``hash 2pc rm=9`` and ``hash paxos check 4``, from
  ``spawn_hash`` runs of this call (``metrics["insert_shape"]``), built
  as ``chip_smoke.py`` builds them;
* a contention sweep into an empty 2^25 table: 16,395,948 distinct keys,
  then keys drawn from pools of 1/4 and 1/16 as many.

Each shape's ``is_new`` is held to the plain version's (exactly, where
nothing overflows). It prints one JSON object a shape: the mean device
ms of each kernel and of the call, the rows, the new keys, the byte
bound of ``chip_smoke._hash_bound`` and the share of rows whose key
another row of its warp (32 consecutive rows) also holds, then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

SHIM = {
    "three-pass": r'''
#include "{source}"
extern "C" int pass_probe(const void* keys, const void* active, i64 n,
                          void* table, void* fresh, i64 mask, int rounds,
                          int epoch, void* slot, void* overflow,
                          void* stream) {
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  probe_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(keys), static_cast<const bool*>(active), n,
      static_cast<u64*>(table), static_cast<int*>(fresh),
      static_cast<u64>(mask), rounds, epoch, static_cast<i64*>(slot),
      static_cast<bool*>(overflow));
  return static_cast<int>(cudaGetLastError());
}
extern "C" int pass_claim(const void* active, const void* overflow,
                          const void* slot, i64 n, const void* fresh,
                          void* claim, int epoch, void* stream) {
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  claim_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bool*>(active), static_cast<const bool*>(overflow),
      static_cast<const i64*>(slot), n, static_cast<const int*>(fresh),
      static_cast<u64*>(claim), epoch);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int pass_winner(const void* active, const void* overflow,
                           const void* slot, i64 n, const void* fresh,
                           const void* claim, int epoch, void* is_new,
                           void* stream) {
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  winner_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bool*>(active), static_cast<const bool*>(overflow),
      static_cast<const i64*>(slot), n, static_cast<const int*>(fresh),
      static_cast<const u64*>(claim), epoch, static_cast<bool*>(is_new));
  return static_cast<int>(cudaGetLastError());
}
''',
    "two-pass": r'''
#include "{source}"
extern "C" int pass_probe_claim(const void* keys, const void* active, i64 n,
                                void* entries, i64 mask, int rounds,
                                int epoch, void* slot, void* is_new,
                                void* overflow, void* stream) {
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  probe_claim_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(keys), static_cast<const bool*>(active), n,
      static_cast<Entry*>(entries), static_cast<u64>(mask), rounds, epoch,
      static_cast<i64*>(slot),
      static_cast<bool*>(is_new), static_cast<bool*>(overflow));
  return static_cast<int>(cudaGetLastError());
}
extern "C" int pass_winner(i64 n, const void* entries, int epoch,
                           const void* slot, void* is_new, void* stream) {
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  winner_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const Entry*>(entries), epoch,
      static_cast<const i64*>(slot), static_cast<bool*>(is_new));
  return static_cast<int>(cudaGetLastError());
}
''',
}

P = ctypes.c_void_p
I64 = ctypes.c_int64
INT = ctypes.c_int
ARGTYPES = {
    "pass_probe": [P, P, I64, P, P, I64, INT, INT, P, P, P],
    "pass_claim": [P, P, P, I64, P, P, INT, P],
    "pass_probe_claim": [P, P, I64, P, I64, INT, INT, P, P, P, P],
}


def design_of(source: Path) -> str:
    text = source.read_text()
    return "two-pass" if "probe_claim_kernel" in text else "three-pass"


def build(source: Path, design: str) -> ctypes.CDLL:
    from stateright_tpu_torch.ops import cuda_build

    out_dir = cuda_build.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    shim = out_dir / f"hash_passes-{os.getpid()}.cu"
    shim.write_text(SHIM[design].replace("{source}", str(source.resolve())))
    lib_path = shim.with_suffix(".so")
    t0 = time.monotonic()
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                           "-o", str(lib_path), str(shim)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the shim:\n{proc.stderr}")
    print(f"shim build ({design}): {time.monotonic() - t0:.1f}s",
          flush=True)
    lib = ctypes.CDLL(str(lib_path))
    shim.unlink()
    lib_path.unlink()
    for name, types in ARGTYPES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = types
            getattr(lib, name).restype = INT
    lib.pass_winner.restype = INT
    lib.pass_winner.argtypes = (
        [P, P, P, I64, P, P, INT, P, P] if design == "three-pass"
        else [I64, P, INT, P, P, P])
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


class Kernels:
    """One design's table, outputs and passes for one shape; ``passes``
    launches every kernel of one call, an event after each."""

    def __init__(self, lib, design, pre, keys, active, rounds):
        import torch

        from stateright_tpu_torch.ops import hashset

        self.lib, self.design = lib, design
        self.keys, self.active, self.rounds = keys, active, rounds
        self.n = keys.numel()
        self.mask = pre.numel() - 1
        self.pre = pre
        dev = keys.device
        if design == "three-pass":
            self.table = pre.clone()
            self.fresh = torch.zeros(pre.numel(), dtype=torch.int32,
                                     device=dev)
            self.claim = torch.zeros(pre.numel(), dtype=torch.int64,
                                     device=dev)
        else:
            self.table = hashset.DeviceHashSet.from_keys(pre).entries
            self.pre_entries = self.table.clone()
        self.slot = torch.empty(self.n, dtype=torch.int64, device=dev)
        self.is_new = torch.empty(self.n, dtype=torch.bool, device=dev)
        self.overflow = torch.empty(self.n, dtype=torch.bool, device=dev)
        self.epoch = 0

    def reset(self):
        if self.design == "three-pass":
            self.table.copy_(self.pre)  # side arrays: the epoch orders them
            self.epoch += 1
        else:
            self.table.copy_(self.pre_entries)
            self.epoch = 1

    def passes(self, events):
        import torch

        stream = torch.cuda.current_stream().cuda_stream
        lib, n, e = self.lib, self.n, self.epoch
        act = _ptr(self.active)
        if self.design == "three-pass":
            calls = [
                lambda: lib.pass_probe(
                    _ptr(self.keys), act, n, _ptr(self.table),
                    _ptr(self.fresh), self.mask, self.rounds, e,
                    _ptr(self.slot), _ptr(self.overflow), stream),
                lambda: lib.pass_claim(
                    act, _ptr(self.overflow), _ptr(self.slot), n,
                    _ptr(self.fresh), _ptr(self.claim), e, stream),
                lambda: lib.pass_winner(
                    act, _ptr(self.overflow), _ptr(self.slot), n,
                    _ptr(self.fresh), _ptr(self.claim), e,
                    _ptr(self.is_new), stream),
            ]
        else:
            calls = [
                lambda: lib.pass_probe_claim(
                    _ptr(self.keys), act, n, _ptr(self.table), self.mask,
                    self.rounds, e, _ptr(self.slot), _ptr(self.is_new),
                    _ptr(self.overflow), stream),
                lambda: lib.pass_winner(
                    n, _ptr(self.table), e, _ptr(self.slot),
                    _ptr(self.is_new), stream),
            ]
        events[0].record()
        for call, ev in zip(calls, events[1:]):
            err = call()
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            ev.record()

    @property
    def names(self):
        return (["probe_kernel", "claim_kernel", "winner_kernel"]
                if self.design == "three-pass"
                else ["probe_claim_kernel", "winner_kernel"])


def time_passes(k: Kernels, reps: int) -> dict:
    import torch

    events = [[torch.cuda.Event(enable_timing=True)
               for _ in range(len(k.names) + 1)] for _ in range(reps)]
    k.reset()
    k.passes(events[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda._sleep(chip_smoke.QUEUE_AHEAD_CYCLES)
    for evs in events:
        k.reset()
        k.passes(evs)
    torch.cuda.synchronize()
    out = {name: sum(evs[i].elapsed_time(evs[i + 1]) for evs in events)
           / reps for i, name in enumerate(k.names)}
    out["call"] = sum(evs[0].elapsed_time(evs[-1]) for evs in events) / reps
    return out


def warp_duplicate_share(keys, active) -> float:
    """Share of active rows whose key another active row of the same
    warp (32 consecutive rows) holds too."""
    import torch

    from stateright_tpu_torch.ops import hashset

    n = keys.numel()
    pad = -n % 32
    k = keys if active is None else torch.where(active, keys, hashset.EMPTY)
    k = torch.cat([k, torch.full((pad,), hashset.EMPTY, dtype=k.dtype,
                                 device=k.device)]).view(-1, 32)
    s = torch.sort(k, dim=1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    same = s[:, 1:] == s[:, :-1]
    dup[:, 1:] |= same
    dup[:, :-1] |= same
    dup &= s != hashset.EMPTY
    live = n if active is None else int(active.sum())
    return int(dup.sum()) / max(live, 1)


def shapes(reps_seed: int = 20261020):
    """{label: (pre, keys, rounds, active)} for every shape timed."""
    import torch

    from stateright_tpu_torch.models.paxos import PaxosModelCfg, paxos_model
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.ops import hashset

    dev = torch.device("cuda")
    inputs, _ = chip_smoke._kernel_inputs(dev)
    out = dict(inputs)
    runs = {
        "hash 2pc rm=9": (TwoPhaseSys(rm_count=9), chip_smoke.HASH_SLOTS,
                          True),
        "hash paxos 4": (paxos_model(PaxosModelCfg(client_count=4,
                                                   server_count=3)),
                         1 << 23, False),
    }
    for label, (model, cap, paths) in runs.items():
        t0 = time.monotonic()
        c = model.checker().spawn_hash(capacity=cap, track_paths=paths,
                                       device="cuda").join()
        shape = c.metrics["insert_shape"]
        print(f"{label}: {c.unique_state_count()} unique in "
              f"{time.monotonic() - t0:.1f}s, widest wave {shape}",
              flush=True)
        out[label] = (*chip_smoke._wave_inputs(shape, cap), 16, None)
        del c
    gen = torch.Generator(device=dev)
    gen.manual_seed(reps_seed)
    empty = torch.full((chip_smoke.HASH_SLOTS,), hashset.EMPTY,
                       dtype=torch.int64, device=dev)
    n = chip_smoke.HASH_KEYS
    distinct = chip_smoke._distinct_keys(n, gen, dev)
    out["sweep: all distinct"] = (empty, distinct, 32, None)
    for frac in (4, 16):
        out[f"sweep: pool 1/{frac}"] = (
            empty, chip_smoke._draw(distinct[:n // frac], n, gen), 32, None)
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", type=Path,
                    default=ROOT / "stateright_tpu_torch/csrc/hashset.cu")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hash_insert_passes: no CUDA device", file=sys.stderr)
        return 2
    from stateright_tpu_torch.ops import hashset

    card = chip_smoke.card_line()
    design = design_of(args.source)
    lib = build(args.source, design)
    records = []
    for label, (pre, keys, rounds, active) in shapes().items():
        k = Kernels(lib, design, pre, keys, active, rounds)
        k.reset()
        k.passes([torch.cuda.Event() for _ in range(len(k.names) + 1)])
        plain = hashset.DeviceHashSet(pre.clone())
        new_p, over_p, _ = hashset.insert_plain(plain, keys, active, rounds)
        del plain
        torch.cuda.synchronize()
        over = int(k.overflow.sum())
        if not over and not int(over_p.sum()):
            assert torch.equal(k.is_new, new_p), f"{label}: is_new differs"
        bound = chip_smoke._hash_bound(keys, k.slot, k.is_new, k.overflow,
                                       active, k.mask, rounds)
        rec = dict(label=label, design=design, source=str(args.source),
                   keys=k.n, slots=pre.numel(),
                   occupied_before=int((pre != hashset.EMPTY).sum()),
                   new=int(k.is_new.sum()), overflow=over,
                   warp_duplicate_share=warp_duplicate_share(keys, active),
                   ms=time_passes(k, args.reps), **bound)
        rec["pct_of_bound"] = 100 * rec["bound_ms"] / rec["ms"]["call"]
        print(json.dumps(rec), flush=True)
        records.append(rec)
        del k
        torch.cuda.empty_cache()
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "shapes": records},
                                        indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
