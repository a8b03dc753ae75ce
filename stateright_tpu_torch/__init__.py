"""stateright_tpu_torch — the PyTorch + CUDA port of stateright_tpu.

A second package beside the JAX one, which stays the reference. It
imports torch and numpy, never jax and nothing of ``stateright_tpu``:
what it needs of the host layer (model, path, checker, report, the host
fingerprint) it keeps as its own copy. Its wave engine runs on the CUDA
device unless the caller asks for the CPU, where every kernel takes its
plain-PyTorch version.

Ported so far: the whole host layer and every engine. The sort-merge
wave engine (``CheckerBuilder.spawn_sortmerge``), sparse and dense, with
the visited-set membership and merge as CUDA kernels
(``csrc/merge_path.cu``); the hand encodings of 2pc, Paxos, increment,
the write-once register and the single-copy register; the actor
framework with its adapters (``choice``, ``ordered_reliable_link``,
``write_once_register``) and its UDP runtime (``actor/spawn.py``), the
linearizability and sequential-consistency testers and the
actor→encoding compiler; host symmetry (``symmetry.py``, the generic
actor representative included), device symmetry reduction and the
static ample-set filter (``ops/canonical.py``), gated by the
reduction soundness analyzer (``analysis/``); the hash wave engine
(``spawn_hash``, the JAX ``spawn_tpu``), its open-addressing insert a
CUDA kernel
(``csrc/hashset.cu``); the host checkers (``spawn_bfs``, ``spawn_dfs``,
``spawn_on_demand``, ``spawn_simulation``), the device simulation
(``spawn_device_simulation``), the hybrid racer of the DFS and the
sort-merge engine (``spawn_hybrid``) and the sharded engines
(``parallel/``); the tiered visited set (``tier.py``), checkpoints and
supervised recovery (``checkpoint.py``), run telemetry
(``telemetry.py``), wave batching (``batch.py``) and the metrics plane
(``metrics.py``); the resident checking service (``serve.py``) and the
Explorer (``explorer/``). ``python -m stateright_tpu_torch`` runs them:
the lanes ``2pc``, ``paxos``, ``increment``, ``increment-lock``,
``register``, ``single-copy-register``, ``2pc-actors``,
``paxos-compiled`` and ``linearizable-register``, each ``check-gpu N``
on the device or ``check N`` on the host, ``check-sym`` on ``2pc``,
``increment``, ``increment-lock`` and ``register``, ``explore``, and
``spawn`` on ``paxos``, ``single-copy-register`` and
``linearizable-register``; the ``timers``, ``interaction`` and
``panic`` lanes; ``serve`` and ``--connect``; ``analyze soundness``.
The operator tools (``tools/``: the crash matrix, the service load test,
``trace_diff`` and the artifact readers) run as ``python -m
stateright_tpu_torch.tools.<name>``.
"""

from .checker import Checker, CheckerBuilder, DiscoveryClassification
from .fingerprint import fingerprint, stable_hash
from .model import Expectation, Model, Property
from .path import Path
from .report import ReportData, Reporter, WriteReporter
from .utils import DenseNatMap, HashableMap, HashableSet, VectorClock
from .visitor import CheckerVisitor, PathRecorder, StateRecorder

__all__ = [
    "Checker",
    "CheckerBuilder",
    "CheckerVisitor",
    "DenseNatMap",
    "DiscoveryClassification",
    "Expectation",
    "HashableMap",
    "HashableSet",
    "Model",
    "Path",
    "PathRecorder",
    "Property",
    "ReportData",
    "Reporter",
    "StateRecorder",
    "VectorClock",
    "WriteReporter",
    "fingerprint",
    "stable_hash",
]
