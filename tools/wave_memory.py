#!/usr/bin/env python3
"""Device memory at each wave of one ``2pc check-gpu N`` run, on one CUDA card.

    python3 tools/wave_memory.py [--root DIR] [--rm N] [--json PATH]

It runs the sort-merge engine at the sizes ``2pc check-gpu N`` uses (at
N=9 the run of ``chip_smoke.py``'s phase 4), importing
``stateright_tpu_torch`` from ``--root`` (default: this checkout). To
compare two commits in one call, unpack the other into the git-ignored
``build/`` and run both::

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python3 tools/wave_memory.py --root build/parent

At the start of each wave (the engine's first call there,
``frontier_props_t``) it reads the bytes the caching allocator holds in
live tensors, and of them the bytes of the state the run keeps between
waves (visited keys, parent-log blocks, frontier, eventually bits); the
rest (``carried``) is what the run still holds of earlier waves. It
also reads each wave's peak. It prints one JSON object: the run's peak
above its start (as ``chip_smoke.run_main`` reads it), the row of the
wave with the highest peak, every wave's row, the unique count and the
card's name and power limit from ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def _state_bytes(cls) -> int:
    """Bytes of the device tensors of every live wave state."""
    total = 0
    for st in (o for o in gc.get_objects() if type(o) is cls):
        tensors = [st.vkeys, st.frontier, st.ebits]
        tensors += [t for block in st.plog for t in block]
        total += sum(t.numel() * t.element_size() for t in tensors
                     if getattr(t, "is_cuda", False))
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--rm", type=int, default=9)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import stateright_tpu_torch
    from stateright_tpu_torch.checkers import tpu_sortmerge
    from stateright_tpu_torch.cli import twopc_sizes
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    pkg = Path(stateright_tpu_torch.__file__).resolve()
    assert root in pkg.parents, (root, pkg)
    waves = []
    real = tpu_sortmerge.frontier_props_t

    def at_wave_start(*a, **kw):
        torch.cuda.synchronize()
        now = torch.cuda.memory_allocated()
        state = _state_bytes(tpu_sortmerge.WaveState)
        if waves:  # the peak of the wave that just ended
            waves[-1]["peak"] = torch.cuda.max_memory_allocated() - base
        waves.append(dict(wave=len(waves), allocated=now - base,
                          state=state, carried=now - base - state))
        torch.cuda.reset_peak_memory_stats()
        return real(*a, **kw)

    tpu_sortmerge.frontier_props_t = at_wave_start
    checker = TwoPhaseSys(rm_count=args.rm).checker().spawn_sortmerge(
        **twopc_sizes(args.rm))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    checker.join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    if waves:
        waves[-1]["peak"] = torch.cuda.max_memory_allocated() - base
    run_peak = max(w.get("peak", 0) for w in waves) if waves else 0
    top = max(waves, key=lambda w: w.get("peak", 0)) if waves else None
    out = dict(root=str(root), rm=args.rm,
               unique=checker.unique_state_count(),
               peak_above_start=run_peak, peak_wave=top, sec=sec,
               waves=waves, card=_card())
    line = json.dumps(out)
    if args.json:
        Path(args.json).write_text(line + "\n")
    print(json.dumps({k: v for k, v in out.items() if k != "waves"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
