"""Where the time of one ``2pc check-gpu N`` or ``paxos check-gpu N``
run goes on the card.

    python -m stateright_tpu_torch.stage_profile 9
    python -m stateright_tpu_torch.stage_profile paxos 4

Needs a CUDA device. After a warm-up run (kernel build, CUDA context,
caching allocator), it times one untraced run with a host clock ending
in ``torch.cuda.synchronize()``, then repeats the run under
``torch.profiler`` and sums the device time of every kernel, grouped
into stages by kernel name. It prints one JSON object: the card's name
and power limit, the untraced and traced walls, the device busy time
and the idle share of the traced wall, the per-stage and top
per-kernel device times, and the Merge Path kernels' share of the
device time.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import torch

#: kernel-name patterns -> stage, first match wins
STAGES = (
    ("member kernel", r"member_tile_kernel"),
    ("merge kernel", r"merge_tile_kernel"),
    ("sort", r"[Ss]ort|[Rr]adix"),
    ("compaction (nonzero, scan)", r"nonzero|[Ss]can|[Ss]elect|flag|write_indices"),
    ("gather / scatter / index", r"index|[Gg]ather|[Ss]catter|take"),
    ("reduction", r"reduce|[Rr]educe"),
    ("elementwise", r"elementwise|[Ff]ill|copy"),
    ("memcpy / memset", r"Memcpy|Memset"),
)


def _stage(name: str) -> str:
    for stage, pat in STAGES:
        if re.search(pat, name):
            return stage
    return "other"


def _check(model: str, n: int):
    """One ``<model> check-gpu n`` run, timed to the device's end."""
    from .cli import paxos_checker, twopc_sizes
    from .models.two_phase_commit import TwoPhaseSys

    if model == "paxos":
        c = paxos_checker(n)
    else:
        c = TwoPhaseSys(rm_count=n).checker().spawn_sortmerge(
            **twopc_sizes(n), device="cuda")
    t0 = time.monotonic()
    c.join()
    torch.cuda.synchronize()
    return c, time.monotonic() - t0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    model = argv.pop(0) if argv and argv[0] in ("2pc", "paxos") else "2pc"
    n = int(argv[0]) if argv else (4 if model == "paxos" else 9)
    if not torch.cuda.is_available():
        print("stage_profile: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    _check(model, min(n, 2 if model == "paxos" else 5))
    checker, wall = _check(model, n)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced, traced_wall = _check(model, n)
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue  # host ops; their kernels are listed on their own
        kernels[ev.key] = kernels.get(ev.key, 0.0) + (
            ev.self_device_time_total / 1e3
        )
    stages = {}
    for name, ms in kernels.items():
        stage = _stage(name)
        stages[stage] = stages.get(stage, 0.0) + ms
    busy_ms = sum(kernels.values())
    merge_path_ms = stages.get("member kernel", 0.0) + stages.get(
        "merge kernel", 0.0)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({
        "card": card,
        "model": model,
        "n": n,
        "unique": checker.unique_state_count(),
        "states": checker.state_count(),
        "waves": checker.metrics["waves"],
        "wall_s": wall,
        "traced_wall_s": traced_wall,
        "device_busy_ms": busy_ms,
        "idle_share_of_traced_wall": 1 - busy_ms / (traced_wall * 1e3),
        "merge_path_kernels_ms": merge_path_ms,
        "merge_path_share_of_device_time": merge_path_ms / busy_ms,
        "metrics": traced.metrics,
        "stages_ms": dict(sorted(stages.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": dict(top),
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
