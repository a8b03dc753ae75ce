"""stateright_tpu_torch — the PyTorch + CUDA port of stateright_tpu.

A second package beside the JAX one, which stays the reference. It
imports torch and numpy, never jax and nothing of ``stateright_tpu``:
what it needs of the host layer (model, path, checker, report, the host
fingerprint) it keeps as its own copy. Its wave engine runs on the CUDA
device unless the caller asks for the CPU, where every kernel takes its
plain-PyTorch version.

Ported so far: the sparse sort-merge wave engine
(``CheckerBuilder.spawn_sortmerge``) on the packed 2pc encoding and the
Paxos hand encoding (with the actor framework and the linearizability
tester it runs on), with the visited-set membership and merge as CUDA
kernels (``csrc/merge_path.cu``). ``python -m stateright_tpu_torch 2pc
check-gpu N`` and ``paxos check-gpu N`` run it.
"""

from .checker import Checker, CheckerBuilder, DiscoveryClassification
from .model import Expectation, Model, Property
from .path import Path
from .report import ReportData, Reporter, WriteReporter

__all__ = [
    "Checker",
    "CheckerBuilder",
    "DiscoveryClassification",
    "Expectation",
    "Model",
    "Path",
    "Property",
    "ReportData",
    "Reporter",
    "WriteReporter",
]
