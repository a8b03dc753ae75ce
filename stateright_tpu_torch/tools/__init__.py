"""The operator tools of the port: the counterparts of the repository's
``tools/`` scripts, each under the same name, over the port's own
modules (no JAX, nothing of the JAX package).

    python -m stateright_tpu_torch.tools.crash_matrix --device cpu --count 4
    python -m stateright_tpu_torch.tools.serve_loadtest --lane "2pc check-gpu 9"
    python -m stateright_tpu_torch.tools.serve_loadtest --sustained --json
    python -m stateright_tpu_torch.tools.trace_diff A.jsonl B.jsonl
    python -m stateright_tpu_torch.tools.slo_report --url http://127.0.0.1:PORT --max-ttv-p99 120
    python -m stateright_tpu_torch.tools.serve_report TRACE_rNN.jsonl
    python -m stateright_tpu_torch.tools.latency_report TRACE_rNN.jsonl
    python -m stateright_tpu_torch.tools.shard_report TRACE_rNN.jsonl
    python -m stateright_tpu_torch.tools.mem_report TRACE_rNN.jsonl

* :mod:`.crash_matrix` — the checkpoint/recovery proof: every cell of
  the fault-injection matrix, each recovered, refused or
  continue-degraded (``CKPT_r*.json``);
* :mod:`.serve_loadtest` — the resident service's batched-vs-FIFO A/B
  and the sustained ramp→spike→drain SLO run (``SERVE_r*``, ``SLO_r*``);
* :mod:`.trace_diff` — two TRACE artifacts aligned wave by wave;
* the readers :mod:`.slo_report`, :mod:`.serve_report`,
  :mod:`.latency_report`, :mod:`.shard_report`, :mod:`.mem_report` —
  the JAX tools' tables over the port's artifacts.

Each takes the JAX tool's arguments, prints what it prints on the same
artifact and exits with the same codes. A tool that runs a check does
so on the CUDA device unless given ``--device cpu``; without a card it
raises, never falling back to the CPU. Artifacts land under ``--root``
(default: the artifacts' root, artifacts.py ``repo_root``). The JAX
package's ``tools/lint_kernels.py`` and ``lint_comms.py`` check XLA
codegen and collectives and ``profile_stages.py`` is the port's
``stage_profile``: they have no counterpart here.
"""
