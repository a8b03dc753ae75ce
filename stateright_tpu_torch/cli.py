"""Command-line entry point of the PyTorch port.

    python -m stateright_tpu_torch 2pc check-gpu 9
    python -m stateright_tpu_torch 2pc check-gpu 3 --device cpu

``check-gpu`` runs the sort-merge wave engine on the CUDA device (on
the CPU only with ``--device cpu``) and prints the same report as the
JAX package's ``2pc check-tpu`` lane: ``Done. states=… unique=…
depth=… sec=…`` and every discovery with its encoded path and replayed
states.
"""

from __future__ import annotations

import math
import sys

from .report import WriteReporter


def _pop_device(argv: list[str]):
    device, rest = "cuda", []
    it = iter(argv)
    for arg in it:
        if arg == "--device":
            device = next(it, None)
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            rest.append(arg)
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"--device must be cuda or cpu, got {device!r}")
    return device, rest


def twopc_sizes(rm_count: int) -> dict:
    """The engine capacities of the 2pc lane (the JAX lane's sizing: the
    2pc space grows ~2.53 bits/RM, and a sorted visited array has no
    load-factor pressure)."""
    capacity = 1 << max(10, math.ceil(2.6 * rm_count + 1.5))
    return dict(capacity=capacity,
                frontier_capacity=max(256, capacity // 4))


def _2pc(sub: str, args: list[str], device: str) -> None:
    from .models.two_phase_commit import TwoPhaseSys

    rm_count = int(args[0]) if args else 2
    if sub != "check-gpu":
        _usage()
        return
    where = "GPU" if device == "cuda" else "CPU"
    print(
        f"Checking two phase commit with {rm_count} resource managers "
        f"on the {where} wave engine."
    )
    checker = TwoPhaseSys(rm_count=rm_count).checker().spawn_sortmerge(
        **twopc_sizes(rm_count), device=device
    )
    # the reference-format reporter (report.rs:60-98), as the JAX lane
    checker.report(WriteReporter(sys.stdout))


def _usage() -> None:
    print("USAGE:")
    print("  python -m stateright_tpu_torch 2pc check-gpu [COUNT] "
          "[--device cuda|cpu]")


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    device, argv = _pop_device(argv)
    if len(argv) < 2 or argv[0] != "2pc":
        _usage()
        return
    _2pc(argv[1], argv[2:], device)
