"""stateright_tpu_torch — the PyTorch + CUDA port of stateright_tpu.

A second package beside the JAX one, which stays the reference. It
imports torch and numpy, never jax and nothing of ``stateright_tpu``:
what it needs of the host layer (model, path, checker, report, the host
fingerprint) it keeps as its own copy. Its wave engine runs on the CUDA
device unless the caller asks for the CPU, where every kernel takes its
plain-PyTorch version.

Ported so far: the sort-merge wave engine
(``CheckerBuilder.spawn_sortmerge``), sparse and dense, with the
visited-set membership and merge as CUDA kernels
(``csrc/merge_path.cu``); the hand encodings of 2pc, Paxos, increment,
the write-once register and the single-copy register; the actor
framework, the linearizability tester and the actor→encoding compiler;
device symmetry reduction and the static ample-set filter
(``ops/canonical.py``, gated by ``soundness.py``); the hash wave engine
(``spawn_hash``, the JAX ``spawn_tpu``), its open-addressing insert a
CUDA kernel (``csrc/hashset.cu``); the host checkers (``spawn_bfs``,
``spawn_dfs``, ``spawn_on_demand``, ``spawn_simulation``), the device
simulation (``spawn_device_simulation``) and the hybrid racer of the
DFS and the sort-merge engine (``spawn_hybrid``). ``python -m stateright_tpu_torch`` runs them
(``2pc``, ``paxos``, ``increment``, ``increment-lock``, ``register``,
``single-copy-register``, ``2pc-actors``, ``paxos-compiled``,
``linearizable-register``, each ``check-gpu N`` on the device or
``check N`` on the host).
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
