"""Command-line entry point of the PyTorch port.

    python -m stateright_tpu_torch 2pc check-gpu 9
    python -m stateright_tpu_torch 2pc check-gpu 3 --device cpu
    python -m stateright_tpu_torch paxos check-gpu 4
    python -m stateright_tpu_torch paxos check-gpu 2 --device cpu

``check-gpu`` runs the sort-merge wave engine on the CUDA device (on
the CPU only with ``--device cpu``) and prints the same report as the
JAX package's ``check-tpu`` lane of the same model: ``Done. states=…
unique=… depth=… sec=…`` and every discovery with its encoded path and
replayed states (for Paxos with 3 or more clients, as there, the
discovery fingerprint only: paths are off).
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


def paxos_checker(client_count: int, device: str = "cuda"):
    """The checker ``paxos check-gpu N`` runs: the encoding's structural
    sizes, and paths only up to 2 clients (the JAX lane's rule: beyond
    that the report gives the discovery fingerprint)."""
    from .models.paxos import PaxosModelCfg, paxos_model
    from .models.paxos_tpu import STRUCTURAL_SIZES

    if client_count not in STRUCTURAL_SIZES:
        raise SystemExit(
            f"paxos check-gpu supports 1-5 clients (got {client_count}): "
            "the encoding's client-lane packing caps at 5 "
            "(models/paxos_tpu.py)"
        )
    cfg = PaxosModelCfg(client_count=client_count, server_count=3)
    return paxos_model(cfg).checker().spawn_sortmerge(
        track_paths=client_count <= 2, device=device,
        **STRUCTURAL_SIZES[client_count],
    )


def _paxos(sub: str, args: list[str], device: str) -> None:
    client_count = int(args[0]) if args else 2
    if sub != "check-gpu":
        _usage()
        return
    checker = paxos_checker(client_count, device)
    where = "GPU" if device == "cuda" else "CPU"
    print(
        f"Model checking Single Decree Paxos with {client_count} "
        f"clients on the {where} wave engine."
    )
    checker.report(WriteReporter(sys.stdout))


_MODELS = {"2pc": _2pc, "paxos": _paxos}


def _usage() -> None:
    print("USAGE:")
    print("  python -m stateright_tpu_torch 2pc check-gpu [COUNT] "
          "[--device cuda|cpu]")
    print("  python -m stateright_tpu_torch paxos check-gpu [CLIENTS 1-5] "
          "[--device cuda|cpu]")


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    device, argv = _pop_device(argv)
    if len(argv) < 2 or argv[0] not in _MODELS:
        _usage()
        return
    _MODELS[argv[0]](argv[1], argv[2:], device)
