#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py          (from the repository root)

It needs one CUDA device and the CUDA toolkit (nvcc); without a device
it exits non-zero and prints no result. Phases, each ending in
``torch.cuda.synchronize()``:

1. the card's name and power limit (nvidia-smi) and the kernel build
   from ``stateright_tpu_torch/csrc/`` (seconds);
2. each CUDA kernel against its plain PyTorch version on the card, on
   tensors at the main path's shapes (visited A ~10M keys, queries Q
   ~16M, winners B ~1.5M) and on edge cases (a tie pool with hi limbs
   at and above 2**31, sentinel tails, empty inputs, sizes that are not
   multiples of the tile, every tile shape, windows at odd offsets,
   tiles that are all A and then all B or Q, a run of equal keys across
   tile boundaries, inputs below one tile, one key). Results must be
   exactly equal. It times every tile shape, then at the default tile
   the kernel, the plain version and one PyTorch call computing the
   same function (``torch.searchsorted`` for membership, a stable
   ``torch.sort`` of the concatenation for the merge; the port calls
   neither), and computes each kernel's bound and its share;
3. ``2pc`` rm=5 on the card with paths: 8,832 unique states, both
   SOMETIMES discoveries with paths that replay through the host model,
   no counterexample to "consistent", and the same discoveries and
   paths as the same run on the CPU;
4. the main path, ``2pc`` rm=9 through the library entry point the CLI
   uses: 10,340,352 unique states, with every kernel launched (launch
   counts are zeroed just before this run and read just after);
5. ``paxos 2c`` on the card and on the CPU with paths: 16,668 unique
   states, "value chosen" discovered with the same discovery
   fingerprints and paths on both, the path replayed through the host
   model, no counterexample to "linearizable";
6. the Paxos main path, ``paxos check 4`` and ``paxos check 5`` through
   the library entry point and sizes ``paxos check-gpu N`` uses (paths
   off, as the CLI): 2,372,188 and 4,711,569 unique states, "value
   chosen" discovered, both kernels launched on each path (counts
   zeroed just before each run and read just after);
7. the compiled main path, ``abd 2c/3s ordered``: ABD over FIFO
   channels with 2 clients and 3 servers, its encoding made by the
   actor→encoding compiler (host compile time printed apart), paths
   off as the bench runs it: 1,212,979 unique states, "value chosen"
   discovered, both kernels launched;
8. ``2pc-actors rm=9 (compiled)``, through the library entry point and
   sizes ``2pc-actors check-gpu 9`` uses: 10,340,352 unique states,
   equal to the hand ``2pc`` rm=9 count of phase 4, with the same
   discovered names;
9. ``paxos-compiled 2c`` on the card with paths, as the CLI lane runs
   it (the reachable-mode host compile printed apart): 16,668 unique
   states, equal to phase 5, and a "value chosen" path that replays;
10. compiled encodings on the card and on the CPU with paths (ABD 2c/2s
   ordered, 620; ``paxos-compiled`` 1c/3s, 265): the same counts,
   discovery fingerprints and paths, each path replayed;
11. the dense wave (``spawn_sortmerge(sparse=False)``, every slot of
   every frontier row stepped in row chunks under a byte budget):
   ``2pc rm=9 dense`` (10,340,352 unique, the same ``states=`` and
   names as phase 4), ``paxos check 4 dense`` (paths off, 2,372,188,
   the discovery fingerprints of phase 6's run) and ``2pc-actors rm=9
   dense`` (compiled, 10,340,352);
12. the last hand encodings through the library entry points and sizes
   of their ``check-gpu`` lanes: ``increment-lock 8`` (dense, 438,401
   unique, depth 33), ``increment 8`` (dense; discovers exactly "fin",
   with a path that replays), ``register 8`` (sparse, 34,993 =
   1 + 2·8·3⁷), ``single-copy-register 2`` (dense, 93, a "value chosen"
   path that replays) and ``single-copy-register 3`` (compiled, sparse,
   4,243);
13. dense runs on the card and on the CPU with paths (``2pc`` rm=5,
   ``paxos 2c``, ``increment-lock 4``): the same counts, discovery
   fingerprints and paths;
14. the reductions, through the CLI's entry points (``RunFlags``):
   ``2pc rm=9 --symmetry`` sparse and dense, ``2pc rm=9 --ample-set``
   (fewer than the raw 10,340,352 states, the same names as phase 4),
   ``2pc rm=9 --symmetry --ample-set`` and ``register 8 --symmetry``
   (1 + 8·9 = 73 orbits); every ``--symmetry`` run is held to the same
   run on the CPU (counts, ``states=``, depth, canonical hits,
   discovery fingerprints and paths, each path replayed). Each passed
   the soundness analyzer's gate at spawn (analysis/soundness.py): the
   analyzer's memo is emptied before each spawn, and the spawn, not the
   run, must have made the certificate (its seconds printed); its lane
   config — the trace's ``run_begin`` lane — carries
   ``symmetry``, ``ample_set`` and ``soundness_certified: true``;
15. for every run of phases 4, 6-9, 11, 14, 20, 23 and 24, each kernel against its
   plain version (exactly) and timed at that run's widest wave's
   shapes, each launch with L2 cold as the engine's calls find it;
16. the device operations of one call of each kernel, counted in one
   ``torch.profiler`` session after every timing;
17. ``simulation 2pc rm=5`` (``spawn_device_simulation``: 4,096 walks,
   32 steps, 2 rounds, seed 0, paths on) on the card and on the CPU:
   the same ``states=``, depth, discovered names, discovery
   fingerprints and ``Path.encode()`` of every frozen trace;
18. the simulation main path, ``simulation 2pc rm=9``: 262,144 walks of
   64 steps, 4 rounds, paths on — 67,371,008 states, depth ≤ 65,
   discoveries among the host's with paths that replay, and no Merge
   Path launch (a simulation has no visited set);
19. ``simulation paxos check 4`` (16,384 walks, paths off): the dense
   Paxos step, host-bound; it prints the device operations a walk step
   (a 2-step run's less a 1-step run's, each profiled in a process of
   its own, ``chip_smoke.py --paxos-simulation-device-ops N``);
20. the hybrid racer (``spawn_hybrid``: the host DFS in a thread against
   the sort-merge engine on the card): ``increment 6`` (the shallow
   bug: the engine's own names), ``paxos 2c/3s`` (16,668, "value
   chosen") and ``paxos check 4`` (2,372,188), each printing its
   winner; the last is followed by the engine alone, and both walls are
   printed. When the device wins, both kernels must have launched.

21. the hash insert kernel (``hash_insert``, ``csrc/hashset.cu``: two
   launches over one ``{key, tag}`` entry array), its registers and
   spills (``nvcc -Xptxas -v``), and its refusal of an untagged or
   misaligned table; then against its plain version on the card, at 2pc
   rm=9's widest wave (16,395,948 keys with in-batch duplicates drawn
   from a pool) into an empty 2^25-slot table and into a half-full one:
   ``is_new`` bit-equal, every ``table[slot[i]] == key[i]``, the
   ``{key, tag}`` entries set-equal, two kernel runs equal; and a table
   too small for its batch, where both report overflow. Every table is
   made by ``DeviceHashSet.from_keys`` (its tags held to the tag rule).
   Then its time (each launch from the same table, restored whole by
   ``reset``, L2 cold) beside the earlier three-pass kernel's, its byte
   bound (8-byte probes, and 32-byte sectors beside it) and the plain
   version's time; no PyTorch call inserts into a hash table, so it has
   no library time;
22. the hash wave engine (``spawn_hash``): ``hash 2pc rm=5`` and ``hash
   paxos 2c/3s`` with paths on the card and on the CPU (every field
   equal, paths replayed), the main path ``hash 2pc rm=9`` (paths on,
   2^25 slots: 10,340,352 unique, its ``states=``, depth and names
   equal to phase 4's sort-merge run, paths replayed), ``hash paxos
   check 4`` (paths off, 2^23 slots: 2,372,188) and ``host bfs 2pc
   rm=5`` (``spawn_bfs``, the hash engine's oracle: 8,832 and the same
   names); then the insert kernel against its plain version and timed
   at each hash path's widest wave (``metrics["insert_shape"]``);
23. the tiered visited set (``tier_hot_rows``, tier.py: at most N keys
   on the card, the rest in sorted runs in host memory): ``2pc rm=9
   tiered`` (paths on, N = 2^20, about a tenth of the space, at most 2
   cold runs before a compaction: 10,340,352 unique with phase 4's
   ``states=``, depth, names and discovery fingerprints, paths
   replayed, at least two spills, runs compacted, cold + hot rows =
   unique, both kernels launched — member and merge launch nothing on
   an empty hot tier), then twice more with paths off, the cold store's
   ingest on its worker thread and on the wave loop's thread (both
   walls); ``paxos check 4 tiered`` (the CLI's checker, paths off, N =
   2^18: 2,372,188 with phase 6's discovery fingerprints); ``2pc rm=5
   tiered`` (N = 1,024) on the card and on the CPU, every field equal,
   the tier's too; ``2pc check-gpu 9 --tier-hot-rows=auto`` through the
   CLI's flags (JAX's 2 GiB budget: dormant, no spill). Each prints
   ``sec=`` and peak memory beside the resident run's, the memory plan's
   ``resident_bytes``, the spill and ingest walls and the host time of
   the cold membership;
24. checkpoints, resume and supervised recovery (checkpoint.py,
   faultinject.py), the snapshots in a temporary directory deleted at
   the end: ``2pc rm=9`` with paths and a snapshot every 4 waves, killed
   (an injected raise, retries off) at the first snapshot wave past its
   widest wave and resumed on the card — phase 4's counts, depth,
   discovery fingerprints and replayed paths, both Merge Path kernels
   launched, the snapshot bytes and write walls, the resume walls (read
   and CRC, host, upload), ``sec=`` and peak memory beside phase 4's;
   ``2pc rm=9`` with a raise mid-wave, recovered in one join (one
   warning, phase 4's counts); ``--checkpoint-every=auto`` through the
   CLI's flags (the cadence it picks, ``sec=`` beside phase 4's); ``2pc
   rm=9`` tiered at phase 23's hot tier, a snapshot every wave, killed
   at the wave of its second spill and resumed tiered (phase 4's counts,
   phase 23's spills, cold plus hot rows equal to unique); ``hash 2pc
   rm=9`` (2^25 slots, paths on) killed at wave 15 and resumed (phase
   4's counts, the restored table holding the tag rule, the insert
   kernel launched); ``2pc rm=5`` killed at wave 7 on the card and on
   the CPU (the two snapshots' buffers equal; each resumed on the other
   device to the uninterrupted run's fields and paths); and ``2pc
   check-gpu 9`` in a process of its own killed by ``STPU_FAULTS`` at
   the same wave (exit 137), then ``--resume`` in another (10,340,352).
   The resumed sort-merge and hash runs join phases 15 and 22's kernel
   checks at their widest waves.
25. the sharded engines (parallel/), every shard on this card
   (``devices=["cuda:0"] * S``; whether peer access is on is printed
   where there is more than one card): ``2pc rm=9`` sort-merge at S = 4
   with paths (10,340,352 unique, ``states=`` 123,558,402, depth 29,
   phase 4's names, each discovery meeting its property; the per-shard
   unique counts, the rows routed off-shard and the Merge Path
   launches); ``paxos check 4`` at S = 4, paths off (2,372,188, phase
   6's names); ``2pc rm=5`` at S = 2 on the card and on the CPU (equal
   per-shard visited keys, fingerprints and paths); ``hash 2pc rm=9`` at
   S = 2 (10,340,352, the insert launched); ``2pc rm=9`` at S = 4 with a
   snapshot every 4 waves, killed past its widest wave and resumed at
   S = 2 and on the one-device engine (the sharded run's counts); and a
   persistent fault on shard 1 of ``2pc rm=5`` at S = 4 under
   ``degrade_on_fault``, finished at S = 3 with 8,832. Each run prints
   ``sec=`` and peak memory; S shards on one card measure the route,
   the exchange and S times the launches, not multi-card scaling. The
   sort-merge runs join the kernel checks at their widest per-shard
   calls, the hash run the insert's.
26. traced runs (telemetry.py), each trace validated
   (``validate_events``) and each run launching every kernel exactly as
   often as its untraced twin: ``2pc rm=9`` and ``paxos check 4``
   untraced, traced (default) and traced (deep), three times each,
   interleaved in a rotating order (phase 4's and phase 6's counts every
   time; the median
   ``sec=`` of each level, the traced overheads in %, the event counts
   and the ``latency_profile``: time to first wave, dispatch and fetch
   shares, compile attribution); ``paxos check-gpu 4 --trace`` through
   the CLI (a trace pair in a temporary directory, "value chosen");
   ``hash 2pc rm=9`` traced; the S = 4 ``2pc rm=9`` run of phase 25
   traced with ``straggler_factor`` set (its ``shard_balance``
   summary); phase 24's checkpointing run traced (one ``checkpoint``
   event a snapshot written) and its resume traced, diffed against an
   uninterrupted trace with no divergence; and ``2pc check-gpu 9
   --trace=deep`` in a process of its own (the ``program_build`` tiers
   of the kernels' libraries and the compile spans).
27. wave batching and the metrics plane (batch.py, metrics.py): the
   main path ``batch 2pc rm=7+8+9``, the ``2pc check-gpu 7/8/9`` lanes'
   checkers in one ``BatchGroup`` of three seats on three threads (one
   fused hash-engine run, 2^28 slots), twice, each seat giving its
   solo count (296,448, 1,745,408, 10,340,352) with no fallback, peeling
   in the order rm=7, rm=8, rm=9, its trace valid and without counter
   divergence from that lane's solo traced run on the card, and the
   insert launched once a fused wave plus once for the init states;
   printed beside the median of two solo hash runs of each lane, with
   each seat's ``batch_peel`` and ``batch_replay`` spans, peak memory
   and the fused engine's wall alone and idle share (``stage_profile
   --batch 7 8 9`` in a process of its own); ``batch paxos 2c/3s x2 + 2pc rm=4 x2``
   (two groups, 16,668 and 1,568, each seat's trace naming only its own
   encoding, the same batch on the CPU with equal wave rows); ``batch
   fallback`` (``increment 2`` with ``2pc rm=3``: JAX's one-line reason,
   each run solo on the card, the 2pc run launching both Merge Path
   kernels); and ``2pc check-gpu 9 --metrics-interval=0.5`` in processes
   of its own, twice between two unmetered ones (its rollup through
   ``metrics.load_rollup``: 29 waves, 10,340,351 new states). The fused
   run joins the insert's checks at its widest wave, the fallback's 2pc
   run the Merge Path kernels' at its shapes.
28. the resident checking service (serve.py), in this process and then
   in processes of its own: ``CheckService(device="cuda")`` with its
   HTTP server on an ephemeral port and the ``2pc,3`` Explorer mounted;
   ``2pc check-gpu 9`` and ``paxos check-gpu 4`` as two concurrent
   ``--connect`` clients (``client_main`` on two threads): phase 4 and
   6's counts, each session's launches while it held the FIFO gate equal
   to its solo run's and the two together equal to the process's, the
   same widest kernel shapes (so phases 4 and 6's kernel checks cover
   them); the ``2pc check-gpu 9`` re-check, a warm start with zero waves
   and the same report and discoveries (its snapshot read inside its
   run, nothing written), then once more with the warm start off (a cold
   run in the resident process); ``2pc check-gpu 7``, ``8`` and ``9``
   batched three to a group (each its solo count, the insert once a
   fused wave plus once); an admission refusal at a 1,024-byte budget
   (no launch, no wave); ``GET /.status``, one ``GET /.states/...`` and
   ``POST /.runtocompletion`` (288); and ``POST /.serve/trace`` (valid,
   its ``serve_summary`` printed). Then ``python -m stateright_tpu_torch
   serve 127.0.0.1:PORT`` and ``--connect=127.0.0.1:PORT 2pc check-gpu
   9`` twice from processes of their own (cold, then warm, 10,340,352),
   the daemon stopped in a ``finally`` (exit 0, its spool removed). Each session prints its time to
   verdict, queue wait, warm or cold, run and session walls, retention
   wall and snapshot bytes; then the group's wall against phase 27's
   solo sum, the daemon's time to first wave against phase 26's fresh
   process's, and peak memory. Every request, thread and process has a
   timeout.
29. the host layer and the compiled pinger (models/timers.py
   ``pinger_compiled``: the pinger of timers.rs at its full width, 3
   servers, through the actor→encoding compiler, its closure bound
   covering the run's ``target_max_depth``): at depth 8 on the
   sort-merge and the hash engine, paths on, each equal to the port's
   host BFS of the same model (5,323 unique, its ``states=`` and
   depth); the main path, the sort-merge engine at depths 22, 23 and 24
   (25,726,524, 40,167,523 and 61,872,524 unique; memory, not time,
   bounds the depth) and the hash engine at depth 24 (2^28 slots), the
   two equal in unique, ``states=`` and depth, each printing ``sec=``,
   the launches of the four kernels, the widest wave's shapes and peak
   memory; then ``2pc check-sym 5`` (665), ``register check-sym 3``
   (13), ``interaction check 12`` (368) and ``panic check`` (the panic
   propagates) through the CLI's ``main``. The pinger runs join the
   kernel checks at their widest waves. The UDP runtime is not started
   here: it touches no device.
30. ``analyze soundness``: ``python -m stateright_tpu_torch analyze
   soundness --no-artifact`` in a process of its own on the card (2pc
   rm=4 and the register n=4 certified, every obligation ok), and with
   ``--device cpu`` (the same lines); then each target's certificate
   made on the card and on the CPU in this process, equal obligation by
   obligation (``battery_rows`` included), with the analyzer's seconds
   on each beside the card's name and power limit; then, in a fresh
   process, the seconds of ``import torch``, of the package's import
   and of 2pc rm=9's first certificate on the card, with no
   ``torch._dynamo`` and no sympy imported; and the time to verdict of
   ``2pc check-gpu 9 --symmetry`` and ``--ample-set``, each in a fresh
   process: its wall, its ``sec=`` and the rest (``chip_smoke.py
   --cold-gate TREE ...`` times the same for the checkouts given, in
   that order, e.g. a parent commit unpacked beside this one:
   ``--cold-gate PARENT . . PARENT``);
31. the reduction gate on the card: a 2pc rm=9 encoding whose ample
   mask drops every RM's spontaneous abort (the JAX analyzer's
   ``BadAmple`` mutant) refuses at its spawn naming
   ``ample-non-suppression``; with ``unsound_ok()`` it runs, launching
   both Merge Path kernels, its lane saying ``soundness_certified:
   false``; the compiled ``two_phase_sys_compiled_encoded(2,
   device_rewrite_spec=…, ample_mask=(1,))`` gets the JAX analyzer's
   verdict (``JAX_COMPILED_VERDICT``) and its spawn refuses naming
   ``transition-equivariance``;
32. the crash matrix (``stateright_tpu_torch.tools.crash_matrix``) on
   the card at full width, ``2pc`` rm=9 (10,340,352 unique), a snapshot
   every 4 waves, the seeded kill at wave 11: every cell recovered,
   refused or continue-degraded at 10,340,352 (the ``kill`` cell in two
   CLI processes of its own, killed by ``STPU_FAULTS`` and resumed;
   the mesh cells with both shards on the card; the hang at 25 s under
   a 1 s watchdog floor); ``--mesh-degrade`` (2pc rm=5, 8 shards on the
   card) reaching 8,832 on 7 shards with no counter divergence; the
   ``--trace`` diff of the baseline against the resumed run clean; each
   cell's wall and the snapshot bytes beside the memory plan's
   ``resident_bytes``;
33. the load test (``tools.serve_loadtest``) with ``2pc check-gpu 9``:
   the A/B at 4 clients (the batched arm the fused hash engine, the FIFO
   arm the lane's own engine; every session 10,340,352 in both arms,
   each arm's per-query dispatch+sync and p50/p99 time to verdict);
   then ``--sustained`` ramp 2 / spike 4 / drain 2 over the HTTP server
   on an ephemeral port (the families scraped mid-spike, every session
   10,340,352, per-phase p50/p99 exact and bucketed, the SLO gate at
   ``SLO_r01.json``'s spec: p99 time to verdict and queue wait at most
   120 s, no refusal, cache hits at least 0.5); then ``tools.trace_diff``
   and each reader (``slo_report`` on a ``2pc check-gpu 9
   --metrics-interval`` rollup, ``serve_report``, ``latency_report``,
   ``shard_report``, ``mem_report``) on the artifacts of phases 32-33,
   each exiting 0. The artifacts go to a temporary directory that is
   deleted.
34. (after phase 2) the kernels called with device counts
   (``member_cuda(..., na=, nq=)``, ``merge_cuda(..., na=, nb=,
   out=)``, ``insert_cuda(..., n=, epoch=)``: the counts read from
   device memory) against their plain versions, exactly, at the main
   shapes in power-of-two buffers with noise past the counts, and at
   counts 0 and full; each timed with its bound;
35. (after phase 7) the device-resident chunk (checkers/chunk.py): ``2pc
   check-gpu 9``, ``paxos check-gpu 4``, ``abd 2c/3s ordered`` and the
   hash engine's ``2pc check-gpu 9`` and ``paxos check 4`` at
   ``waves_per_sync`` 64 and 1, several runs of each interleaved,
   equal counts, ``states=``, depth and fingerprints; each run's host
   reads and waits, graph captures and replays, eager waves, class
   changes, launches and ``sec=``, and each path's median, least and
   most ``sec=`` at each N; at 64 the captures and replays non-zero, at
   most one read a chunk and one a class change, one wait a wave run;
   then the idle share of each under ``torch.profiler``, in a child
   process.

Every other phase runs the engines' default, one wave a sync. A
kernel's record in the result line carries, under ``device_counts``,
phase 34's figures for the same kernel called with device counts.

Every run of a main path (phases 4, 6-9, 11, 12, 14, 18, 20, 22-29) prints
its ``sec=``, states/s, waves, peak device memory above its start, the
engine's ``metrics`` (with the dense chunk count of a dense run, the
canonical hits: candidates whose canonical form differed, and a hash
run's table occupancy) and the launch count of each kernel in that
run.

It prints one JSON line of kernel records (``launches`` and the
comparison at each path's shapes, ``at_path_shapes``, per path — the
hybrid paths' at their device side's widest wave, where it ran one), then
the card's name and power limit, and last ``{"ok": true, "device":
{...}}``. Any failed phase makes it exit 1 without that last line.
"""

from __future__ import annotations

import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

#: device-memory rate and scalar peak of an H100 SXM (NVIDIA data
#: sheet): the bound of a kernel is the larger of bytes / rate and
#: operations / peak.
HBM_BYTES_PER_SEC = 3.35e12
SCALAR_OPS_PER_SEC = 67e12
SOURCE = "stateright_tpu_torch/csrc/merge_path.cu"
HASH_SOURCE = "stateright_tpu_torch/csrc/hashset.cu"
#: the earlier three-pass insert kernel's time at each ``hash insert``
#: shape, ms (PERF.md §6, H100 80GB HBM3 at 700 W), printed beside the
#: time measured here
HASH_THREE_PASS_MS = {"empty table": 3.698, "half-full table": 1.713,
               "hash 2pc rm=9": 2.179, "hash paxos 4": 0.137}
#: the JAX analyzer's verdict (on the CPU, held to the port's by
#: tests/test_torch_analysis.py) on the compiled 2pc-actors encoding at
#: 2 RMs with the spec swapping the RMs' 2-bit fields and the one-slot
#: ample mask (1,): (rule, severity) of each obligation, and the battery
#: row its transition-equivariance failure names
JAX_COMPILED_VERDICT = (
    [("group-closure", "info"), ("orbit-structure", "info"),
     ("fingerprint-invariance", "info"), ("property-invariance", "info"),
     ("transition-equivariance", "error"), ("ample-enabledness", "error"),
     ("ample-non-suppression", "error")],
    6,
)
#: the kernels each engine's main path must launch
MERGE_KERNELS = ("member_sorted", "merge_sorted")
HASH_KERNELS = ("hash_insert",)
FAILED: list = []
#: unique count and discovered names of the hand-encoded runs, which the
#: compiled runs of the same spaces are held to
HAND: dict = {}


def phase(name):
    def wrap(fn):
        def run(*args, **kw):
            import torch

            t0 = time.monotonic()
            try:
                out = fn(*args, **kw)
                torch.cuda.synchronize()
            except Exception:  # report the phase, keep the others going
                FAILED.append(name)
                print(f"[{name}] FAILED", flush=True)
                traceback.print_exc()
                _memory_line()
                return None
            print(f"[{name}] ok in {time.monotonic() - t0:.3f}s", flush=True)
            _memory_line()
            return out
        return run
    return wrap


def _memory_line() -> None:
    """After a phase: garbage collected (a finished run's objects in a
    reference cycle would hold their device memory until then), the
    device memory still allocated and of it what graph pools hold."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()  # a child process of a later phase needs it
    segs = torch.cuda.memory._snapshot()["segments"]
    pooled = sum(s["allocated_size"] for s in segs
                 if tuple(s.get("segment_pool_id", (0, 0))) != (0, 0))
    print(f"  device memory after the phase: "
          f"{torch.cuda.memory_allocated()} B allocated, {pooled} B of it "
          f"in graph pools", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


@phase("build")
def build():
    from stateright_tpu_torch.ops import cuda_build, hashset, merge

    t0 = time.monotonic()
    # one nvcc per source, all started together
    names = sorted(p.name for p in cuda_build.CSRC.glob("*.cu"))
    pending = {name: cuda_build.start_build(name) for name in names}
    for name, job in pending.items():
        cuda_build.finish_build(name, job)
    merge._lib()
    hashset._lib()
    print(f"kernel build: {time.monotonic() - t0:.3f}s "
          f"(nvcc {cuda_build.BUILD_SECONDS})", flush=True)


def _rand_keys(n, gen, device, pool=None):
    """n sorted packed keys: uniform 64-bit, or drawn from ``pool``."""
    import torch

    from stateright_tpu_torch.ops.fingerprint import clamp_keys, pack_keys

    if pool is not None:
        idx = torch.randint(0, pool.numel(), (n,), generator=gen,
                            device=device)
        return torch.sort(pool[idx]).values
    lo = torch.randint(0, 1 << 32, (n,), generator=gen, device=device)
    hi = torch.randint(0, 1 << 32, (n,), generator=gen, device=device)
    return torch.sort(clamp_keys(pack_keys(lo, hi))).values


def _with_tail(keys, tail):
    import torch

    from stateright_tpu_torch.ops.fingerprint import SENTINEL_KEY

    return torch.cat([keys, torch.full((tail,), SENTINEL_KEY,
                                       dtype=torch.int64,
                                       device=keys.device)])


def _tie_pool(gen, device):
    import torch

    from stateright_tpu_torch.ops.fingerprint import pack_keys

    hi = torch.tensor([0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE,
                       0xFFFFFFFF], device=device)
    lo = torch.tensor([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                      device=device)
    pool = pack_keys(lo.repeat_interleave(5), hi.repeat(5))
    # drop the sentinel itself: tails add it explicitly
    return pool[pool != torch.iinfo(torch.int64).max]


def _err(a, b) -> float:
    """max |a - b| over the elements, as unsigned fingerprints for
    packed keys (0 when equal)."""
    import torch

    from stateright_tpu_torch.ops.fingerprint import key_to_fp

    if a.shape != b.shape:
        return math.inf
    diff = (a != b).nonzero().flatten()
    if diff.numel() == 0:
        return 0
    if a.dtype == torch.bool:
        return 1
    pairs = zip(a[diff].tolist(), b[diff].tolist())
    return float(max(abs(key_to_fp(x) - key_to_fp(y)) for x, y in pairs))


#: GPU cycles the stream sleeps before a timed run (~10 ms), so the
#: host has queued every launch before the first one starts: a call
#: shorter than its host-side launch cost is then timed on the device,
#: not at the rate the host issues it
QUEUE_AHEAD_CYCLES = 20_000_000


def _time_ms(fn, reps=10) -> float:
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: bytes written between two cold-L2 launches: twice the H100's 50 MB
#: L2, so a launch finds none of its inputs there
L2_FLUSH_BYTES = 100 << 20


def _time_cold_ms(fn, reps=10) -> float:
    """Mean device time of one call that finds the L2 cache cold: each
    launch follows a write of ``L2_FLUSH_BYTES`` (as the rest of a wave
    evicts the visited keys between two calls of the engine) and sits
    between its own pair of events, all queued ahead."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES // 8, dtype=torch.int64,
                        device="cuda")
    fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    for start, end in pairs:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def _bound_ms(bytes_moved: float, ops: float) -> tuple:
    b_ms = bytes_moved / HBM_BYTES_PER_SEC * 1e3
    o_ms = ops / SCALAR_OPS_PER_SEC * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def _per_row(tile) -> float:
    """Compares a row: one a merged row, plus each thread's diagonal
    search (log2 T probes for R rows); the two run diagonals a CTA
    searches (~6 ballot steps) are a few hundred thousand more."""
    from stateright_tpu_torch.ops import merge

    return 1 + math.ceil(math.log2(tile + 1)) / merge.TILES[tile][1]


def _member_bound(na, nq) -> tuple:
    """Read A and Q once (int64 keys), write one bool a query."""
    from stateright_tpu_torch.ops import merge

    return _bound_ms(8 * na + 8 * nq + nq,
                     (na + nq) * _per_row(merge.MEMBER_BLOCK))


def _merge_bound(na, nb) -> tuple:
    """Read A and B once, write A + B keys."""
    from stateright_tpu_torch.ops import merge

    return _bound_ms(16 * (na + nb), (na + nb) * _per_row(merge.MERGE_BLOCK))


@phase("kernels")
def kernels():
    import torch

    from stateright_tpu_torch.ops import merge

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)
    pool = _tie_pool(gen, dev)
    empty = torch.zeros(0, dtype=torch.int64, device=dev)

    # -- equality cases: (label, A, Q or B, block); block None: each
    # kernel's default tile ---------------------------------------------
    big_a = _with_tail(_rand_keys(10_000_003, gen, dev), 517)
    hits = big_a[torch.randint(0, big_a.numel(), (8_000_000,),
                               generator=gen, device=dev)]
    big_q = torch.sort(torch.cat([hits, _rand_keys(8_000_001, gen,
                                                   dev)])).values
    big_b = _rand_keys(1_500_007, gen, dev)
    tiny, big = min(merge.TILES), max(merge.TILES)
    cases = [("main", big_a, big_q, big_b, None)]
    for block in sorted(merge.TILES):
        cases.append((
            f"ties/block={block}",
            _with_tail(_rand_keys(100_003, gen, dev, pool), 33),
            _with_tail(_rand_keys(70_001, gen, dev, pool), 7),
            _with_tail(_rand_keys(30_011, gen, dev, pool), 5),
            block,
        ))
    small = _rand_keys(1_001, gen, dev)
    cases += [("empty A", empty, small, small, None),
              ("empty Q/B", small, empty, empty, None),
              ("sentinels only", _with_tail(empty, 700),
               _with_tail(empty, 300), _with_tail(empty, 300), None)]
    # the kernels' own edges: windows at odd offsets (a view from row 1
    # starts 8 bytes past a 16-byte boundary), tiles that are all A and
    # then all B or Q, a run of equal keys across tile boundaries (the
    # member halo), inputs smaller than one tile, one key
    mid_a, mid_q = big_a[:400_001], big_q[:600_003]
    split = _rand_keys(60_001, gen, dev)
    lower, upper = split[:30_000], split[30_000:]
    run_a = _rand_keys(10_001, gen, dev)
    same = run_a[5_000].repeat(5 * big + 3)
    run_q = torch.sort(torch.cat([_rand_keys(3, gen, dev), same,
                                  run_a[7_000:]])).values
    one, other = run_a[:1], run_a[1:2]
    for block in (tiny, None):
        cases += [
            (f"odd offsets A/block={block}", mid_a[1:], mid_q, big_b[1:],
             block),
            (f"odd offsets Q,B/block={block}", mid_a, mid_q[1:],
             big_b[3:200_000], block),
            (f"all A then all B/block={block}", lower, upper, upper, block),
            (f"all B then all A/block={block}", upper, lower, lower, block),
            (f"equal-key run/block={block}", run_a, run_q, same, block),
            (f"below one tile/block={block}", run_a[:100], run_q[:57],
             split[:31], block),
            (f"one key, equal/block={block}", one, one, one, block),
            (f"one key, other/block={block}", one, other, other, block),
        ]
    err = {"member": 0, "merge": 0}
    for label, a, q, b, block in cases:
        tiles = {} if block is None else {"block": block}
        m_k = merge.member_cuda(a, q, **tiles)
        m_p = merge.member_sorted_plain(a, q)
        g_k = merge.merge_cuda(a, b, **tiles)
        g_p = merge.merge_sorted_plain(a, b)
        torch.cuda.synchronize()
        e_m, e_g = _err(m_k, m_p), _err(g_k, g_p)
        print(f"  {label}: Na={a.numel()} Nq={q.numel()} Nb={b.numel()} "
              f"member_err={e_m} merge_err={e_g} "
              f"members={int(m_k.sum())}", flush=True)
        err["member"] = max(err["member"], e_m)
        err["merge"] = max(err["merge"], e_g)
    if err["member"] or err["merge"]:
        raise AssertionError(f"kernel != plain version: {err}")

    # -- timing at the main path's shapes --------------------------------
    na, nq, nb = big_a.numel(), big_q.numel(), big_b.numel()
    cat = torch.cat([big_a, big_b])
    for block in sorted(merge.TILES):  # every tile shape, same inputs
        print(f"  tile {block} rows {merge.TILES[block]}: member "
              f"{_time_ms(lambda: merge.member_cuda(big_a, big_q, block)):.4f}"
              f" ms, merge "
              f"{_time_ms(lambda: merge.merge_cuda(big_a, big_b, block)):.4f}"
              " ms", flush=True)

    m_bound = _member_bound(na, nq)
    g_bound = _merge_bound(na, nb)
    rec = {
        "member_sorted": dict(
            replaces="stateright_tpu/ops/merge.py:282",
            max_abs_err=err["member"],
            ms=_time_ms(lambda: merge.member_cuda(big_a, big_q)),
            plain_ms=_time_ms(
                lambda: merge.member_sorted_plain(big_a, big_q), reps=3),
            library_ms=_time_ms(
                lambda: torch.searchsorted(big_a, big_q)),
            bound_ms=m_bound[0], bound_by=m_bound[1],
            shapes=dict(Na=na, Nq=nq, tile=merge.MEMBER_BLOCK),
        ),
        "merge_sorted": dict(
            replaces="stateright_tpu/ops/merge.py:232",
            max_abs_err=err["merge"],
            ms=_time_ms(lambda: merge.merge_cuda(big_a, big_b)),
            plain_ms=_time_ms(
                lambda: merge.merge_sorted_plain(big_a, big_b), reps=3),
            library_ms=_time_ms(lambda: torch.sort(cat, stable=True)),
            bound_ms=g_bound[0], bound_by=g_bound[1],
            shapes=dict(Na=na, Nb=nb, tile=merge.MERGE_BLOCK),
        ),
    }
    for name, r in rec.items():
        r["pct_of_bound"] = 100 * r["bound_ms"] / r["ms"]
        print(f"  {name}: kernel {r['ms']:.4f} ms "
              f"({r['pct_of_bound']:.1f}% of bound), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms "
              f"(kernel/library {r['ms'] / r['library_ms']:.3f}), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}) at {r['shapes']}",
              flush=True)
    # one call of each, for the device-op count the last phase takes
    calls = {"member_sorted": lambda: merge.member_cuda(big_a, big_q),
             "merge_sorted": lambda: merge.merge_cuda(big_a, big_b)}
    return rec, calls


def _garbage_keys(cap, gen, device):
    """``cap`` packed keys of noise: what a fixed-capacity buffer holds
    past its live count."""
    import torch

    return torch.randint(-(1 << 62), 1 << 62, (cap,), generator=gen,
                         device=device)


def _padded(live, cap, gen):
    """``live`` (sorted keys) in a ``cap``-row buffer, noise after it."""
    buf = _garbage_keys(cap, gen, live.device)
    buf[:live.numel()] = live
    return buf


@phase("device-count kernels")
def dev_kernels():
    """Each kernel called with device counts (``member_cuda(...,
    na=, nq=)``, ``merge_cuda(..., na=, nb=, out=)``, ``insert_cuda(...,
    n=, epoch=)``: the counts read from device memory, the grid sized to
    the buffers' capacities) against its plain version on the same
    buffers, exactly: at the main path's shapes in
    buffers of the power-of-two capacities the chunked waves use, with
    noise past the counts, and at counts 0 and at the full capacity.
    Then each timed with its bound (from the live counts), its plain
    version and the library call, as the ``kernels`` phase times the
    kernels with host counts. Records by kernel name, which the result
    line adds to each kernel's record as ``device_counts``."""
    import torch

    from stateright_tpu_torch.ops import hashset, merge

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261019)
    na, nq, nb = 10_000_003, 16_000_001, 1_500_007
    cap_a, cap_q, cap_b = 1 << 24, 1 << 25, 1 << 21
    a_live = torch.sort(_rand_keys(na, gen, dev)).values
    hits = a_live[torch.randint(0, na, (nq // 2,), generator=gen,
                                device=dev)]
    q_live = torch.sort(torch.cat([hits, _rand_keys(nq - nq // 2, gen,
                                                    dev)])).values
    b_live = torch.sort(_rand_keys(nb, gen, dev)).values
    A, Q, B = (_padded(a_live, cap_a, gen), _padded(q_live, cap_q, gen),
               _padded(b_live, cap_b, gen))
    full = [torch.sort(_rand_keys(n, gen, dev)).values
            for n in (1 << 16, 1 << 15, 1 << 14)]

    def count(n):
        return torch.tensor(n, dtype=torch.int64, device=dev)

    cases = [("main", A, na, Q, nq, B, nb),
             ("counts 0", A, 0, Q, 0, B, 0),
             ("A 0", A, 0, Q, nq, B, nb),
             ("Q, B 0", A, na, Q, 0, B, 0),
             ("full", full[0], 1 << 16, full[1], 1 << 15, full[2], 1 << 14)]
    err = {"member_sorted": 0, "merge_sorted": 0}
    out_k = torch.empty(cap_a + cap_b, dtype=torch.int64, device=dev)
    out_p = torch.empty_like(out_k)
    for label, a, n_a, q, n_q, b, n_b in cases:
        ta, tq, tb = count(n_a), count(n_q), count(n_b)
        m_k = merge.member_cuda(a, q, na=ta, nq=tq)
        m_p = merge.member_sorted_plain_dev(a, ta, q, tq)
        merge.merge_cuda(a, b, na=ta, nb=tb, out=out_k)
        merge.merge_sorted_plain_dev(a, ta, b, tb, out_p)
        torch.cuda.synchronize()
        e_m = _err(m_k[:n_q], m_p[:n_q])
        e_g = _err(out_k[:n_a + n_b], out_p[:n_a + n_b])
        print(f"  {label}: Na={n_a}/{a.numel()} Nq={n_q}/{q.numel()} "
              f"Nb={n_b}/{b.numel()} member_err={e_m} merge_err={e_g}",
              flush=True)
        err["member_sorted"] = max(err["member_sorted"], e_m)
        err["merge_sorted"] = max(err["merge_sorted"], e_g)
    if any(err.values()):
        raise AssertionError(f"device-count kernel != plain version: {err}")
    ta, tq, tb = count(na), count(nq), count(nb)
    m_bound, g_bound = _member_bound(na, nq), _merge_bound(na, nb)
    cat = torch.cat([a_live, b_live])
    rec = {
        "member_sorted": dict(
            max_abs_err=err["member_sorted"],
            ms=_time_ms(lambda: merge.member_cuda(A, Q, na=ta, nq=tq)),
            plain_ms=_time_ms(
                lambda: merge.member_sorted_plain_dev(A, ta, Q, tq), reps=3),
            library_ms=_time_ms(lambda: torch.searchsorted(a_live, q_live)),
            bound_ms=m_bound[0], bound_by=m_bound[1],
            shapes=dict(Na=na, Nq=nq, cap_a=cap_a, cap_q=cap_q)),
        "merge_sorted": dict(
            max_abs_err=err["merge_sorted"],
            ms=_time_ms(lambda: merge.merge_cuda(A, B, na=ta, nb=tb,
                                                 out=out_k)),
            plain_ms=_time_ms(lambda: merge.merge_sorted_plain_dev(
                A, ta, B, tb, out_p), reps=3),
            library_ms=_time_ms(lambda: torch.sort(cat, stable=True)),
            bound_ms=g_bound[0], bound_by=g_bound[1],
            shapes=dict(Na=na, Nb=nb, cap_a=cap_a, cap_b=cap_b)),
    }
    # the insert: 2pc rm=9's widest wave into an empty table, its keys in
    # a 2^25-row buffer with noise past the count
    inputs, gen2 = _kernel_inputs(dev)
    pre, keys, rounds, _ = inputs["empty table"]
    n = keys.numel()
    kbuf = _padded(keys, 1 << 25, gen2)
    tn = count(n)

    tk = hashset.DeviceHashSet.from_keys(pre)
    new_k, over_k, slot_k = hashset.insert_cuda(tk, kbuf, None, rounds,
                                                n=tn, epoch=count(0))
    tp = hashset.DeviceHashSet.from_keys(pre)
    new_p, over_p, _ = hashset.insert_plain_dev(tp, kbuf, None, tn, rounds)
    th = hashset.DeviceHashSet.from_keys(pre)
    new_h, _, _ = hashset.insert_cuda(th, keys, None, rounds)
    torch.cuda.synchronize()
    e_i = max(_err(new_k[:n], new_p[:n]), _err(new_k[:n], new_h),
              _err(over_k[:n], over_p[:n]))
    same = torch.equal(torch.sort(tk.keys).values, torch.sort(tp.keys).values)
    assert e_i == 0 and same, ("device-count insert != plain", e_i, same)
    # count 0 writes nothing; the full buffer is every row
    t0_ = hashset.DeviceHashSet.from_keys(pre)
    hashset.insert_cuda(t0_, kbuf, None, rounds, n=count(0), epoch=count(0))
    assert not bool(t0_.occupied().any()), "a count of 0 inserted"
    small_pre = torch.full((1 << 16,), hashset.EMPTY, dtype=torch.int64,
                           device=dev)
    fk = _draw(_distinct_keys(1 << 13, gen2, dev), 1 << 14, gen2)
    tf = hashset.DeviceHashSet.from_keys(small_pre)
    tpf = hashset.DeviceHashSet.from_keys(small_pre)
    nf_k, _, _ = hashset.insert_cuda(tf, fk, None, 32, n=count(fk.numel()),
                                     epoch=count(0))
    nf_p, _, _ = hashset.insert_plain_dev(tpf, fk, None, count(fk.numel()),
                                          32)
    e_i = max(e_i, _err(nf_k, nf_p))
    assert e_i == 0, "device-count insert != plain at the full count"
    table = hashset.DeviceHashSet.from_keys(pre)
    ep = count(0)
    reset = lambda: table.reset(pre)  # noqa: E731
    ms = _time_reset_ms(lambda: hashset.insert_cuda(
        table, kbuf, None, rounds, n=tn, epoch=ep), reset)
    plain_ms = _time_reset_ms(lambda: hashset.insert_plain_dev(
        table, kbuf, None, tn, rounds), reset, 3)
    bound = _hash_bound(keys, slot_k[:n], new_k[:n], over_k[:n], None,
                        pre.numel() - 1, rounds)
    rec["hash_insert"] = dict(
        max_abs_err=e_i,
        ms=ms, plain_ms=plain_ms, library_ms=None,
        bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
        shapes=dict(keys=n, cap=kbuf.numel(), slots=pre.numel()))
    for name, r in rec.items():
        r["pct_of_bound"] = 100 * r["bound_ms"] / r["ms"]
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"  {name} (device counts): kernel {r['ms']:.4f} ms "
              f"({r['pct_of_bound']:.1f}% "
              f"of bound), plain {r['plain_ms']:.4f} ms, library {lib}, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) at "
              f"{r['shapes']}", flush=True)
    return rec


#: kernel-name parts of each wrapper's kernels
KERNEL_NAMES = {"member_sorted": ("member_tile_kernel",),
                "merge_sorted": ("merge_tile_kernel",),
                "hash_insert": ("probe_claim_kernel", "winner_kernel")}


@phase("device ops a call")
def device_ops(calls) -> dict:
    """Device operations of one call of each wrapper, from ONE
    ``torch.profiler`` session taken after every timing of the script
    (a second session in one process can come back empty, and a
    session can slow the kernels timed after it). Its first step runs
    every call once unrecorded (the tracer's start can miss the first
    kernel), its second records them. The kernels are told apart by
    name; any other device operation (a memset, a copy) is printed and
    counted against every call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for fn in calls.values():
                fn()
                torch.cuda.synchronize()
            prof.step()
    ops = {ev.key: ev.count for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA}
    print(f"  device ops of one call each: {ops}", flush=True)
    other = sum(n for key, n in ops.items()
                if not any(k in key for parts in KERNEL_NAMES.values()
                           for k in parts))
    out = {name: other + sum(n for key, n in ops.items()
                             if any(part in key for part in parts))
           for name, parts in KERNEL_NAMES.items() if name in calls}
    assert all(n >= 1 for n in out.values()), out
    print(f"  device ops a call: {out}", flush=True)
    return out


def _replays(model, path, prop) -> bool:
    from stateright_tpu_torch.path import Path

    replayed = Path.from_fingerprints(model, path.fingerprints())
    return (replayed.fingerprints() == path.fingerprints()
            and prop.condition(model, replayed.last_state()))


@phase("2pc rm=5")
def rm5():
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    model = TwoPhaseSys(rm_count=5)
    runs = {}
    for device in ("cuda", "cpu"):
        c = model.checker().spawn_sortmerge(
            capacity=1 << 15, frontier_capacity=1 << 13, device=device
        ).join()
        runs[device] = c
        print(f"  {device}: states={c.state_count()} "
              f"unique={c.unique_state_count()} depth={c.max_depth()} "
              f"discovered={sorted(c.discovered_property_names())}",
              flush=True)
    gpu, cpu = runs["cuda"], runs["cpu"]
    assert gpu.unique_state_count() == 8832, gpu.unique_state_count()
    want = {"abort agreement", "commit agreement"}
    assert gpu.discovered_property_names() == want
    for name, path in gpu.discoveries().items():
        assert _replays(model, path, model.property_by_name(name)), name
        assert path.encode() == cpu.discovery(name).encode(), name
    assert gpu.discovery_fingerprints() == cpu.discovery_fingerprints()
    assert (gpu.state_count(), gpu.max_depth()) == (
        cpu.state_count(), cpu.max_depth())


@phase("2pc rm=9 (main path)")
def rm9():
    from stateright_tpu_torch.cli import twopc_sizes
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    model = TwoPhaseSys(rm_count=9)
    # the engine and sizes `2pc check-gpu 9` runs
    checker = model.checker().spawn_sortmerge(**twopc_sizes(9))
    run = run_main(checker, print_lines=1)
    assert run["unique"] == 10_340_352, run["unique"]
    assert run["names"] == {"abort agreement", "commit agreement"}
    HAND["2pc rm=9"] = (run["unique"], run["names"])
    HAND["2pc rm=9 states"] = run["states"]
    HAND["2pc rm=9 depth"] = run["depth"]
    HAND["2pc rm=9 fps"] = run["fps"]
    for name, path in checker.discoveries().items():
        assert _replays(model, path, model.property_by_name(name)), name
    return run


def _mem_base() -> int:
    """Reset the peak-memory count; return the bytes allocated now
    (tensors an earlier phase still holds), which a run's peak is read
    above."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _zero_launches():
    from stateright_tpu_torch.ops import hashset, merge

    merge.member_cuda.launches = 0
    merge.merge_cuda.launches = 0
    hashset.insert_cuda.launches = 0


def _read_launches() -> dict:
    """Each kernel's launches (by host or device counts; a launch in a
    CUDA graph counts at each replay)."""
    from stateright_tpu_torch.ops import hashset, merge

    return {"member_sorted": merge.member_cuda.launches,
            "merge_sorted": merge.merge_cuda.launches,
            "hash_insert": hashset.insert_cuda.launches}


@phase("paxos 2c")
def paxos2():
    from stateright_tpu_torch.models.paxos import PaxosModelCfg, paxos_model
    from stateright_tpu_torch.models.paxos_tpu import STRUCTURAL_SIZES

    model = paxos_model(PaxosModelCfg(client_count=2, server_count=3))
    runs = {}
    for device in ("cuda", "cpu"):
        c = model.checker().spawn_sortmerge(
            **STRUCTURAL_SIZES[2], device=device).join()
        runs[device] = c
        print(f"  {device}: states={c.state_count()} "
              f"unique={c.unique_state_count()} depth={c.max_depth()} "
              f"discovered={sorted(c.discovered_property_names())}",
              flush=True)
    gpu, cpu = runs["cuda"], runs["cpu"]
    assert gpu.unique_state_count() == 16668, gpu.unique_state_count()
    assert gpu.discovered_property_names() == {"value chosen"}
    assert "linearizable" not in gpu.discovered_property_names()
    HAND["paxos 2c"] = (gpu.unique_state_count(),
                        gpu.discovered_property_names())
    assert (gpu.state_count(), gpu.max_depth()) == (
        cpu.state_count(), cpu.max_depth())
    assert gpu.discovery_fingerprints() == cpu.discovery_fingerprints()
    for name, path in gpu.discoveries().items():
        assert _replays(model, path, model.property_by_name(name)), name
        assert path.encode() == cpu.discovery(name).encode(), name


def run_main(checker, print_lines: int | None = None,
             kernels=MERGE_KERNELS) -> dict:
    """Run ``checker`` once with the report a user sees, the launch
    counts zeroed just before and read just after; print the report
    (its first ``print_lines`` lines), ``sec=``, rates, waves, the peak
    device memory above the run's start, the engine's ``metrics`` and
    the launches. Each of ``kernels`` must have launched."""
    import torch

    from stateright_tpu_torch import WriteReporter

    base = _mem_base()
    _zero_launches()
    t0 = time.monotonic()
    out = io.StringIO()
    checker.report(WriteReporter(out))
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = _read_launches()
    unique = checker.unique_state_count()
    for line in out.getvalue().splitlines()[:print_lines]:
        print(f"  {line[:400]}", flush=True)
    peak = torch.cuda.max_memory_allocated() - base
    print(f"  {checker.metrics} sec={sec:.3f} "
          f"states/s={checker.state_count() / sec:.0f} "
          f"unique/s={unique / sec:.0f} waves={checker.metrics['waves']} "
          f"launches={launches} peak_mem_bytes={peak}", flush=True)
    assert all(launches[k] > 0 for k in kernels), launches
    return dict(launches=launches, metrics=checker.metrics, unique=unique,
                sec=sec, names=checker.discovered_property_names(),
                states=checker.state_count(), depth=checker.max_depth(),
                fps=checker.discovery_fingerprints(),
                capacity=checker.capacity, peak_mem_bytes=peak,
                plan_resident_bytes=(checker.memory_plan or {}).get(
                    "resident_bytes"))


def _chunk_paths() -> dict:
    """The main paths the chunk phase runs at both chunk lengths: label ->
    (a function of ``waves_per_sync`` that spawns the checker; unique
    states)."""
    from stateright_tpu_torch.actor import Network
    from stateright_tpu_torch.cli import paxos_checker, twopc_sizes
    from stateright_tpu_torch.models.linearizable_register import (
        AbdModelCfg,
        abd_model,
    )
    from stateright_tpu_torch.models.paxos import PaxosModelCfg, paxos_model
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    abd = abd_model(AbdModelCfg(client_count=2, server_count=3),
                    Network.new_ordered())
    enc = _compiled(abd.to_encoded)

    def paxos(n):
        c = paxos_checker(4)
        c.waves_per_sync = n
        return c

    return {
        "2pc check-gpu 9": (lambda n: TwoPhaseSys(rm_count=9).checker()
                            .spawn_sortmerge(waves_per_sync=n,
                                             **twopc_sizes(9)), 10_340_352),
        "paxos check-gpu 4": (paxos, 2_372_188),
        "abd 2c/3s ordered": (lambda n: abd.checker().spawn_sortmerge(
            encoded=enc, capacity=1 << 21, frontier_capacity=1 << 18,
            track_paths=False, waves_per_sync=n), 1_212_979),
        "hash 2pc check-gpu 9": (lambda n: _hash(
            TwoPhaseSys(rm_count=9), capacity=HASH_SLOTS,
            waves_per_sync=n), 10_340_352),
        "hash paxos check 4": (lambda n: _hash(
            paxos_model(PaxosModelCfg(client_count=4, server_count=3)),
            capacity=1 << 23, track_paths=False, waves_per_sync=n),
            2_372_188),
    }


#: the flag of the child process that profiles the chunk phase's runs
CHUNK_IDLE_FLAG = "--chunk-idle-shares"
#: host idle time between two of those runs, which splits the one
#: profiler session's kernels among them
IDLE_GAP_SEC = 1.0


def chunk_idle_shares() -> dict:
    """In a child process: each chunk-phase path at N = 64 and N = 1,
    all in ONE ``torch.profiler`` session (device activity only; a
    second session in a process can come back empty, and the last phase
    takes the parent's one session), each run followed by
    ``IDLE_GAP_SEC`` of host sleep. The kernels split into runs at those
    gaps: ``{"label N": [idle share of the wall, busy ms, wall s]}``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    TwoPhaseSys(rm_count=5).checker().spawn_sortmerge().join()
    # the sort-merge paths (the hash engine's paxos run is host-bound
    # for ~20 s, and its kernel trace does not split cleanly)
    runs = [(f"{label} N={n}", make, n)
            for label, (make, _) in _chunk_paths().items()
            if not label.startswith("hash") for n in (64, 1)]
    walls = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _, make, n in runs:
            checker = make(n)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            checker.join()
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
            time.sleep(IDLE_GAP_SEC)
    # the raw device events, in ns (``prof.events()`` would build a
    # Python object tree of every one of them first: minutes for these
    # runs' hundreds of thousands of kernels)
    spans = sorted((e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    groups, last = [[]], None
    for t0, t1 in spans:
        if last is not None and t0 - last > IDLE_GAP_SEC * 0.8e9:
            groups.append([])
        groups[-1].append(t1 - t0)
        last = t1 if last is None else max(last, t1)
    assert len(groups) == len(runs), (len(groups), len(runs))
    out = {}
    for (key, _, _), wall, durs in zip(runs, walls, groups):
        busy = sum(durs) / 1e6
        out[key] = [1 - busy / (wall * 1e3), busy, wall]
    return out


def _chunk_idle_child() -> dict:
    """:func:`chunk_idle_shares` in a process of its own."""
    proc = subprocess.run([sys.executable, __file__, CHUNK_IDLE_FLAG],
                          capture_output=True, text=True, timeout=900,
                          cwd=ROOT)
    if proc.returncode != 0:
        raise RuntimeError(f"the idle-share child failed: "
                           f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


#: runs of each chunk-phase path at each N, the two N interleaved in one
#: process: a single wall on the host's clock spreads too far to say
#: what the chunk costs, so each is given as its median, least and most
CHUNK_REPEATS = {"2pc check-gpu 9": 5, "paxos check-gpu 4": 3,
                 "abd 2c/3s ordered": 3, "hash 2pc check-gpu 9": 1,
                 "hash paxos check 4": 1}


def _chunk_run(label: str, make, n: int) -> dict:
    """One run of a chunk-phase path at ``waves_per_sync`` ``n``, the
    launch counts zeroed just before it and read just after."""
    import torch

    from stateright_tpu_torch.checkers.tpu import READS

    checker = make(n)
    base = _mem_base()
    _zero_launches()
    r0 = READS.calls
    t0 = time.monotonic()
    checker.join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    reads = READS.calls - r0
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated() - base
    m = checker.metrics
    result = (checker.unique_state_count(), checker.state_count(),
              checker.max_depth(), checker.discovery_fingerprints())
    print(f"  {label} N={n}: unique={result[0]} states={result[1]} "
          f"depth={result[2]} sec={sec} waves={m['waves']} "
          f"host_reads={reads} host_waits={m.get('host_waits', 0)} "
          f"chunks={m.get('chunks')} resizes={m.get('resizes')} "
          f"graph_captures={m.get('graph_captures')} "
          f"graph_replays={m.get('graph_replays')} "
          f"eager_waves={m.get('eager_waves')} "
          f"poll_sec={m.get('poll_sec')} classes={m.get('classes')} "
          f"launches={launches} peak_mem_bytes={peak}", flush=True)
    return dict(result=result, launches=launches, metrics=m, sec=sec,
                reads=reads, peak_mem_bytes=peak)


@phase("chunk: N = 64 against N = 1 on the main paths")
def chunk_phase() -> dict:
    """The device-resident chunk (checkers/chunk.py) on the main paths:
    each at ``waves_per_sync`` 64 and 1, :data:`CHUNK_REPEATS` times
    each, interleaved. The counts, ``states=``, depth and discovery
    fingerprints must be equal at both; at 64 the waves run as CUDA-graph
    replays (captures > 0, replays > 0; not asked of the hash engine's
    2pc rm=9, whose classes change too often for a capture), the
    engine's kernels launch, the
    blocking host reads are at most one a chunk plus one a resize, and
    the host waits once a wave run on its polled scalars
    (``host_waits``); at 1 nothing is captured. For each run: host reads
    and waits, graph captures and replays, eager waves, resizes, the
    launches of each kernel and ``sec=``; for each path and N the
    median, least and most ``sec=``; and, from one more run under
    ``torch.profiler``, the idle share of the wall
    (:func:`chunk_idle_shares`, in a child process)."""
    runs = {}
    for label, (make, want) in _chunk_paths().items():
        got, secs = {}, {64: [], 1: []}
        for rep in range(CHUNK_REPEATS[label]):
            for n in ((64, 1) if rep % 2 == 0 else (1, 64)):
                run = _chunk_run(label, make, n)
                m, reads = run["metrics"], run["reads"]
                assert run["result"][0] == want, (label, n, run["result"])
                assert got.setdefault(n, run["result"]) == run["result"]
                secs[n].append(run["sec"])
                # the launches of the first run of each N go in the result
                runs.setdefault(f"chunk N={n} {label}", run)
                if n == 64:
                    # a class is captured at its third wave: the hash
                    # engine's classes at 2pc rm=9 change too often for
                    # one, so replays are asked of its paxos run
                    if label != "hash 2pc check-gpu 9":
                        assert m["graph_replays"] > 0, m
                        assert m["graph_captures"] > 0, m
                    for k in (HASH_KERNELS if label.startswith("hash")
                              else MERGE_KERNELS):
                        assert run["launches"][k] > 0, (k, run)
                    assert reads <= math.ceil(m["waves"] / 64) \
                        + m["resizes"] + 1, (reads, m)
                    assert m["waves"] <= m["host_waits"] <= m["waves"] \
                        + m["resizes"], m
                else:
                    assert not m.get("graph_captures"), m
        assert got[64] == got[1], (label, got)
        for n in (64, 1):
            xs = sorted(secs[n])
            print(f"  {label} N={n}: sec median {xs[len(xs) // 2]} least "
                  f"{xs[0]} most {xs[-1]} over {len(xs)} runs: {secs[n]}",
                  flush=True)
            runs[f"chunk N={n} {label}"]["sec_runs"] = secs[n]
    t0 = time.monotonic()
    for key, (idle, busy, wall) in _chunk_idle_child().items():
        print(f"  profiled {key}: wall {wall:.4f}s busy {busy:.3f} ms "
              f"idle {idle:.4f}", flush=True)
    print(f"  the profiling child process: {time.monotonic() - t0:.3f}s",
          flush=True)
    return runs


def paxos_main(clients: int, unique_want: int):
    """``paxos check N`` through the library entry point and the sizes
    ``paxos check-gpu N`` uses, paths off as the CLI runs it."""
    from stateright_tpu_torch.cli import paxos_checker

    run = run_main(paxos_checker(clients))
    assert run["unique"] == unique_want, run["unique"]
    assert run["names"] == {"value chosen"}
    return run


@phase("paxos check 4 (main path)")
def paxos4():
    run = paxos_main(4, 2_372_188)
    HAND["paxos 4c fps"] = run["fps"]
    return run


@phase("paxos check 5")
def paxos5():
    return paxos_main(5, 4_711_569)


def kernels_at(label: str, metrics: dict):
    """The phase ``kernels at <label> shapes``: each kernel against its
    plain version (exactly) and timed at the widest wave's shapes of
    the run ``label``, from its engine ``metrics``."""
    return phase(f"kernels at {label} shapes")(_kernels_at)(metrics)


def _kernels_at(metrics):
    """Member at the wave with the most candidate keys (Na visited, Nq
    queries), merge at the wave with the most winners (Na, Nb). The
    keys are uniform 64-bit draws, the queries one part visited keys
    and one part fresh, as in a wave. Inputs that fit in L2 find it
    evicted by the rest of the wave in the engine, so each launch is
    timed with L2 cold."""
    import torch

    from stateright_tpu_torch.ops import merge

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261017)
    out = {}
    (na_m, nq), (na_g, nb) = metrics["member_shape"], metrics["merge_shape"]
    a_m = _rand_keys(na_m, gen, dev)
    fresh = _rand_keys(nq // 2, gen, dev)
    hits = a_m[torch.randint(0, na_m, (nq - fresh.numel(),), generator=gen,
                             device=dev)]
    q = torch.sort(torch.cat([hits, fresh])).values
    a_g, b = _rand_keys(na_g, gen, dev), _rand_keys(nb, gen, dev)
    cat = torch.cat([a_g, b])
    e_m = _err(merge.member_cuda(a_m, q), merge.member_sorted_plain(a_m, q))
    e_g = _err(merge.merge_cuda(a_g, b), merge.merge_sorted_plain(a_g, b))
    m_bound = _member_bound(na_m, nq)
    g_bound = _merge_bound(na_g, nb)
    out["member_sorted"] = dict(
        shapes=dict(Na=na_m, Nq=nq), max_abs_err=e_m,
        ms=_time_cold_ms(lambda: merge.member_cuda(a_m, q)),
        plain_ms=_time_cold_ms(
            lambda: merge.member_sorted_plain(a_m, q), 3),
        library_ms=_time_cold_ms(lambda: torch.searchsorted(a_m, q)),
        bound_ms=m_bound[0], bound_by=m_bound[1])
    out["merge_sorted"] = dict(
        shapes=dict(Na=na_g, Nb=nb), max_abs_err=e_g,
        ms=_time_cold_ms(lambda: merge.merge_cuda(a_g, b)),
        plain_ms=_time_cold_ms(
            lambda: merge.merge_sorted_plain(a_g, b), 3),
        library_ms=_time_cold_ms(lambda: torch.sort(cat, stable=True)),
        bound_ms=g_bound[0], bound_by=g_bound[1])
    for name, r in out.items():
        r["pct_of_bound"] = 100 * r["bound_ms"] / r["ms"]
        print(f"  {name} at {r['shapes']}: kernel {r['ms']:.4f} ms "
              f"({r['pct_of_bound']:.1f}% of bound), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"err {r['max_abs_err']}", flush=True)
    if e_m or e_g:
        raise AssertionError(f"kernel != plain version: {e_m}, {e_g}")
    return out


def _compiled(build):
    """Build a compiled encoding, printing the host compile time apart
    from any run's ``sec=``; the compiler's queue-bound caps are
    expected warnings."""
    import warnings

    t0 = time.monotonic()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        enc = build()
    print(f"  host compile {time.monotonic() - t0:.3f}s: W={enc.width} "
          f"K={enc.max_actions} {enc.codegen_opt}", flush=True)
    return enc


@phase("abd 2c/3s ordered (compiled, main path)")
def abd_main():
    """ABD over FIFO channels, 2 clients and 3 servers, as the bench
    runs it: the compiled encoding, paths off."""
    from stateright_tpu_torch.actor import Network
    from stateright_tpu_torch.models.linearizable_register import (
        AbdModelCfg,
        abd_model,
    )

    model = abd_model(AbdModelCfg(client_count=2, server_count=3),
                      Network.new_ordered())
    enc = _compiled(model.to_encoded)
    run = run_main(model.checker().spawn_sortmerge(
        encoded=enc, capacity=1 << 21, frontier_capacity=1 << 18,
        track_paths=False))
    assert run["unique"] == 1_212_979, run["unique"]
    assert run["names"] == {"value chosen"}, run["names"]
    return run


@phase("2pc-actors rm=9 (compiled)")
def twopc_actors9():
    """The compiled 2pc at rm=9, through the library entry point and
    sizes ``2pc-actors check-gpu 9`` uses; held to the hand rm=9 run of
    this call."""
    from stateright_tpu_torch.cli import twopc_sizes
    from stateright_tpu_torch.model import Expectation
    from stateright_tpu_torch.models.two_phase_commit_actors import (
        two_phase_sys_actor_model,
        two_phase_sys_compiled_encoded,
    )

    model = two_phase_sys_actor_model(9)
    enc = _compiled(lambda: two_phase_sys_compiled_encoded(9))
    run = run_main(model.checker().spawn_sortmerge(
        encoded=enc, **twopc_sizes(9)), print_lines=1)
    assert run["unique"] == 10_340_352, run["unique"]
    hand = HAND.get("2pc rm=9")
    assert hand is not None, "the hand 2pc rm=9 phase did not pass"
    assert run["unique"] == hand[0], (run["unique"], hand[0])
    sometimes = {p.name for p in model.properties()
                 if p.expectation == Expectation.SOMETIMES}
    assert run["names"] == hand[1] == sometimes, (run["names"], hand[1])
    return run


@phase("paxos-compiled 2c")
def paxos_compiled2():
    """The compiled paxos at 2 clients on the card with paths, as
    ``paxos-compiled check-gpu 2`` runs it; held to the hand paxos 2c
    run of this call."""
    from stateright_tpu_torch.models.paxos import (
        PaxosModelCfg,
        paxos_compiled_encoded,
        paxos_model,
    )

    cfg = PaxosModelCfg(client_count=2, server_count=3)
    model = paxos_model(cfg)
    enc = _compiled(lambda: paxos_compiled_encoded(cfg))
    checker = model.checker().spawn_sortmerge(
        encoded=enc, track_paths=True, capacity=1 << 15,
        frontier_capacity=1 << 13)
    run = run_main(checker, print_lines=3)
    hand = HAND.get("paxos 2c")
    assert hand is not None, "the hand paxos 2c phase did not pass"
    assert run["unique"] == hand[0] == 16668, (run["unique"], hand)
    assert run["names"] == hand[1] == {"value chosen"}, run["names"]
    path = checker.discovery("value chosen")
    assert _replays(model, path, model.property_by_name("value chosen"))
    return run


@phase("compiled, card vs CPU")
def compiled_card_vs_cpu():
    """Compiled encodings on the card and on the CPU, with paths: the
    same counts, discovery fingerprints and paths, each path replayed
    through the host model."""
    from stateright_tpu_torch.actor import Network
    from stateright_tpu_torch.models.linearizable_register import (
        AbdModelCfg,
        abd_model,
    )
    from stateright_tpu_torch.models.paxos import (
        PaxosModelCfg,
        paxos_compiled_encoded,
        paxos_model,
    )

    abd = abd_model(AbdModelCfg(2, 2), Network.new_ordered())
    pcfg = PaxosModelCfg(client_count=1, server_count=3)
    cases = [("abd 2c/2s ordered", abd, _compiled(abd.to_encoded), 620),
             ("paxos-compiled 1c/3s", paxos_model(pcfg),
              _compiled(lambda: paxos_compiled_encoded(pcfg)), 265)]
    for label, model, enc, want in cases:
        runs = {}
        for device in ("cuda", "cpu"):
            c = model.checker().spawn_sortmerge(
                encoded=enc, capacity=1 << 13, frontier_capacity=1 << 11,
                device=device).join()
            runs[device] = c
            print(f"  {label} {device}: states={c.state_count()} "
                  f"unique={c.unique_state_count()} depth={c.max_depth()} "
                  f"discovered={sorted(c.discovered_property_names())}",
                  flush=True)
        gpu, cpu = runs["cuda"], runs["cpu"]
        assert gpu.unique_state_count() == want, gpu.unique_state_count()
        assert (gpu.state_count(), gpu.max_depth()) == (
            cpu.state_count(), cpu.max_depth())
        assert gpu.discovery_fingerprints() == cpu.discovery_fingerprints()
        assert gpu.discovered_property_names() == {"value chosen"}
        for name, path in gpu.discoveries().items():
            assert _replays(model, path, model.property_by_name(name)), name
            assert path.encode() == cpu.discovery(name).encode(), name


def _dense_metrics(run):
    m = run["metrics"]
    assert m["expansion"] == "dense", m
    assert m["dense_chunks"] >= m["waves"], m
    return run


@phase("2pc rm=9 dense")
def rm9_dense():
    """The dense wave of 2pc rm=9, held to the sparse run of this call:
    the 2pc slots prune nothing, so ``states=`` is equal too."""
    from stateright_tpu_torch.cli import twopc_sizes
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    run = _dense_metrics(run_main(
        TwoPhaseSys(rm_count=9).checker().spawn_sortmerge(
            **twopc_sizes(9), sparse=False), print_lines=1))
    assert "2pc rm=9" in HAND, "the sparse 2pc rm=9 phase did not pass"
    assert (run["unique"], run["names"]) == HAND["2pc rm=9"], run
    assert run["states"] == HAND["2pc rm=9 states"], run["states"]
    return run


@phase("paxos check 4 dense")
def paxos4_dense():
    """The dense wave of ``paxos check 4``, paths off; the discovery
    fingerprints of the sparse run of this call."""
    from stateright_tpu_torch.cli import paxos_checker

    run = _dense_metrics(run_main(paxos_checker(4, sparse=False)))
    assert run["unique"] == 2_372_188, run["unique"]
    assert "paxos 4c fps" in HAND, "the sparse paxos 4 phase did not pass"
    assert run["fps"] == HAND["paxos 4c fps"], (run["fps"],
                                                HAND["paxos 4c fps"])
    return run


@phase("2pc-actors rm=9 dense (compiled)")
def twopc_actors9_dense():
    from stateright_tpu_torch.cli import twopc_sizes
    from stateright_tpu_torch.models.two_phase_commit_actors import (
        two_phase_sys_actor_model,
        two_phase_sys_compiled_encoded,
    )

    enc = _compiled(lambda: two_phase_sys_compiled_encoded(9))
    run = _dense_metrics(run_main(two_phase_sys_actor_model(9).checker()
                                  .spawn_sortmerge(encoded=enc, sparse=False,
                                                   **twopc_sizes(9)),
                                  print_lines=1))
    assert run["unique"] == 10_340_352, run["unique"]
    assert run["names"] == HAND["2pc rm=9"][1], run["names"]
    return run


def _lane_run(checker, expansion: str, print_lines: int = 1) -> dict:
    run = run_main(checker, print_lines=print_lines)
    assert run["metrics"]["expansion"] == expansion, run["metrics"]
    return run


@phase("increment-lock 8")
def increment_lock8():
    from stateright_tpu_torch.cli import increment_checker

    run = _lane_run(increment_checker(8, locked=True), "dense")
    assert (run["unique"], run["depth"]) == (438_401, 33), run
    assert run["names"] == set(), run["names"]
    return run


@phase("increment 8")
def increment8():
    from stateright_tpu_torch.cli import increment_checker
    from stateright_tpu_torch.path import Path

    checker = increment_checker(8, locked=False)
    run = _lane_run(checker, "dense", print_lines=3)
    assert run["names"] == {"fin"}, run["names"]
    model = checker.model
    path = checker.discovery("fin")
    replayed = Path.from_fingerprints(model, path.fingerprints())
    assert replayed.fingerprints() == path.fingerprints()
    assert not model.property_by_name("fin").condition(
        model, replayed.last_state())
    return run


@phase("register 8")
def register8():
    from stateright_tpu_torch.cli import register_checker

    run = _lane_run(register_checker(8), "sparse")
    assert run["unique"] == 1 + 2 * 8 * 3 ** 7 == 34_993, run["unique"]
    assert run["names"] == {"all done", "lost write"}, run["names"]
    return run


@phase("single-copy-register 2")
def single_copy2():
    from stateright_tpu_torch.cli import single_copy_checker

    checker = single_copy_checker(2)
    run = _lane_run(checker, "dense", print_lines=3)
    assert run["unique"] == 93, run["unique"]
    assert run["names"] == {"value chosen"}, run["names"]
    model = checker.model
    assert _replays(model, checker.discovery("value chosen"),
                    model.property_by_name("value chosen"))
    return run


@phase("single-copy-register 3 (compiled)")
def single_copy3():
    import warnings

    from stateright_tpu_torch.cli import single_copy_checker

    t0 = time.monotonic()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        checker = single_copy_checker(3)
    print(f"  host compile {time.monotonic() - t0:.3f}s", flush=True)
    run = _lane_run(checker, "sparse")
    assert run["unique"] == 4_243, run["unique"]
    assert run["names"] == {"value chosen"}, run["names"]
    return run


@phase("dense, card vs CPU")
def dense_card_vs_cpu():
    """Dense runs on the card and on the CPU with paths: the same
    counts, discovery fingerprints and paths."""
    from stateright_tpu_torch.models.increment import IncrementLock
    from stateright_tpu_torch.models.paxos import PaxosModelCfg, paxos_model
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    cases = [("2pc rm=5", TwoPhaseSys(rm_count=5), 8832),
             ("paxos 2c", paxos_model(PaxosModelCfg(client_count=2,
                                                    server_count=3)), 16668),
             ("increment-lock 4", IncrementLock(4), 257)]
    for label, model, want in cases:
        runs = {}
        for device in ("cuda", "cpu"):
            c = model.checker().spawn_sortmerge(
                capacity=1 << 15, frontier_capacity=1 << 13, sparse=False,
                device=device).join()
            runs[device] = c
            print(f"  {label} {device}: states={c.state_count()} "
                  f"unique={c.unique_state_count()} depth={c.max_depth()} "
                  f"discovered={sorted(c.discovered_property_names())} "
                  f"chunks={c.metrics['dense_chunks']}", flush=True)
        gpu, cpu = runs["cuda"], runs["cpu"]
        assert gpu.metrics["expansion"] == "dense"
        assert gpu.unique_state_count() == want, gpu.unique_state_count()
        assert (gpu.state_count(), gpu.max_depth()) == (
            cpu.state_count(), cpu.max_depth())
        assert gpu.discovery_fingerprints() == cpu.discovery_fingerprints()
        for name, path in gpu.discoveries().items():
            assert _replays(model, path, model.property_by_name(name)), name
            assert path.encode() == cpu.discovery(name).encode(), name


def _reduced_checker(flags, lane: str, n: int, sparse=None):
    """The checker ``<lane> check-gpu N`` runs with ``flags`` (a
    ``RunFlags``); ``sparse=False`` its dense wave."""
    from stateright_tpu_torch.cli import register_checker, twopc_sizes
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    if lane == "register":
        return register_checker(n, flags)
    return flags.spawn(TwoPhaseSys(rm_count=n), symmetric=True,
                       sparse=sparse, **twopc_sizes(n))


def reduced_run(lane: str, n: int, sparse=None, **reductions) -> dict:
    """One reduced run on the card (``run_main``); a ``--symmetry``
    run is held to the same run on the CPU."""
    from stateright_tpu_torch.analysis import soundness
    from stateright_tpu_torch.cli import RunFlags

    # each spawn makes its own certificate, so that every reduction's
    # gate is seen to run at spawn, outside the run's clock
    soundness._CERT_CACHE.clear()
    t0 = time.monotonic()
    checker = _reduced_checker(RunFlags(**reductions), lane, n, sparse)
    print(f"  spawn with its soundness gate {time.monotonic() - t0:.3f}s",
          flush=True)
    assert len(soundness._CERT_CACHE) == 1, "the spawn ran no gate"
    run = run_main(checker, print_lines=1)
    # the lane config every trace's run_begin embeds: the spawn gate
    # certified the reduction
    cfg = checker._lane_config()
    assert (cfg["symmetry"], cfg["ample_set"], cfg["soundness_certified"]
            ) == (bool(reductions.get("symmetry")),
                  bool(reductions.get("ample_set")), True), cfg
    print(f"  lane: symmetry={cfg['symmetry']} ample_set={cfg['ample_set']}"
          f" soundness_certified={cfg['soundness_certified']}", flush=True)
    if not reductions.get("symmetry"):
        return run
    t0 = time.monotonic()
    cpu = _reduced_checker(RunFlags("cpu", **reductions), lane, n,
                           sparse).join()
    print(f"  cpu: states={cpu.state_count()} "
          f"unique={cpu.unique_state_count()} depth={cpu.max_depth()} "
          f"canonical_hits={cpu.metrics['canonical_hits']} "
          f"in {time.monotonic() - t0:.3f}s", flush=True)
    assert (run["unique"], run["states"], run["depth"]) == (
        cpu.unique_state_count(), cpu.state_count(), cpu.max_depth())
    assert run["metrics"]["canonical_hits"] == cpu.metrics[
        "canonical_hits"] > 0
    assert run["fps"] == cpu.discovery_fingerprints(), run["fps"]
    model = checker.model
    for name, path in checker.discoveries().items():
        assert _replays(model, path, model.property_by_name(name)), name
        assert path.encode() == cpu.discovery(name).encode(), name
    return run


@phase("2pc rm=9 --symmetry")
def rm9_sym():
    run = reduced_run("2pc", 9, symmetry=True)
    assert 0 < run["unique"] < 10_340_352, run["unique"]
    assert run["names"] == {"abort agreement", "commit agreement"}
    HAND["2pc rm=9 sym"] = (run["unique"], run["states"], run["fps"])
    return run


@phase("2pc rm=9 --symmetry dense")
def rm9_sym_dense():
    run = _dense_metrics(reduced_run("2pc", 9, sparse=False,
                                     symmetry=True))
    assert "2pc rm=9 sym" in HAND, "the sparse symmetry phase did not pass"
    assert (run["unique"], run["states"], run["fps"]) == HAND[
        "2pc rm=9 sym"], run
    return run


@phase("2pc rm=9 --ample-set")
def rm9_ample():
    run = reduced_run("2pc", 9, ample_set=True)
    assert 0 < run["unique"] < 10_340_352, run["unique"]
    assert run["names"] == {"abort agreement", "commit agreement"}
    return run


@phase("2pc rm=9 --symmetry --ample-set")
def rm9_sym_ample():
    run = reduced_run("2pc", 9, symmetry=True, ample_set=True)
    assert "2pc rm=9 sym" in HAND, "the sparse symmetry phase did not pass"
    assert 0 < run["unique"] < HAND["2pc rm=9 sym"][0], run["unique"]
    assert run["names"] == {"abort agreement", "commit agreement"}
    return run


@phase("register 8 --symmetry")
def register8_sym():
    run = reduced_run("register", 8, symmetry=True)
    assert run["unique"] == 1 + 8 * 9 == 73, run["unique"]
    assert run["names"] == {"all done", "lost write"}, run["names"]
    return run


# -- the reduction soundness analyzer and its gate --------------------------


def _analyze_cli(*extra) -> list:
    """``analyze soundness --no-artifact`` in a process of its own: its
    lines, each target's timing bracket dropped."""
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "stateright_tpu_torch", "analyze",
         "soundness", "--no-artifact", *extra],
        capture_output=True, text=True, timeout=300)
    wall = time.monotonic() - t0
    for line in out.stdout.splitlines():
        print(f"  {line[:160]}", flush=True)
    assert out.returncode == 0, out.stderr[-3000:]
    print(f"  process wall {wall:.3f}s {' '.join(extra) or '(the card)'}",
          flush=True)
    lines = out.stdout.splitlines()
    for name, enc in (("2pc", "TwoPhaseSysEncoded(4)"),
                      ("register", "NClientRegEncoded(4)")):
        assert any(ln.startswith(f"{name} ({enc}): certified [")
                   for ln in lines), name
    assert not any(ln.strip().startswith("FAIL") for ln in lines)
    return [ln.split(" [")[0] if "): " in ln else ln for ln in lines]


COLD_GATE_FLAG = "--cold-gate"


def cold_certificate() -> None:
    """In a fresh process: the seconds of ``import torch``, of the
    package's import and of 2pc rm=9's first certificate on the card;
    neither ``torch._dynamo`` nor sympy may be imported on the way."""
    code = (
        "import sys, time\n"
        "t0 = time.monotonic()\n"
        "import torch\n"
        "t1 = time.monotonic()\n"
        "from stateright_tpu_torch.analysis.soundness import "
        "certify_encoding\n"
        "from stateright_tpu_torch.models.two_phase_commit_tpu import "
        "TwoPhaseSysEncoded\n"
        "t2 = time.monotonic()\n"
        "assert certify_encoding(TwoPhaseSysEncoded(9)).certified\n"
        "torch.cuda.synchronize()\n"
        "t3 = time.monotonic()\n"
        "print(t1 - t0, t2 - t1, t3 - t2, sorted(\n"
        "    m for m in ('torch._dynamo', 'sympy') if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    imp, pkg, cert, heavy = out.stdout.strip().split(" ", 3)
    print(f"  fresh process: import torch {float(imp):.3f}s, the package "
          f"{float(pkg):.3f}s, 2pc rm=9's first certificate on the card "
          f"{float(cert):.3f}s; compiler modules imported: {heavy}",
          flush=True)
    assert heavy == "[]", heavy


def cold_gate(trees, build: bool = True) -> list:
    """Time to verdict of a gated run in a fresh process: ``python -m
    stateright_tpu_torch 2pc check-gpu 9 --symmetry``, then
    ``--ample-set``, from each checkout in ``trees`` in the order given
    (with ``build``, each first builds its kernels in an untimed ``2pc
    check-gpu 3``). Prints each process's wall, the run's ``sec=`` and
    the rest (Python's and torch's start, CUDA's, the spawn and its
    gate)."""
    for tree in dict.fromkeys(trees) if build else ():
        subprocess.run([sys.executable, "-m", "stateright_tpu_torch", "2pc",
                        "check-gpu", "3"], cwd=tree, capture_output=True,
                       timeout=900, check=True)
    recs = []
    for flag in ("--symmetry", "--ample-set"):
        for tree in trees:
            t0 = time.monotonic()
            out = subprocess.run(
                [sys.executable, "-m", "stateright_tpu_torch", "2pc",
                 "check-gpu", "9", flag], cwd=tree, capture_output=True,
                text=True, timeout=600)
            wall = time.monotonic() - t0
            assert out.returncode == 0, out.stderr[-3000:]
            done = [ln for ln in out.stdout.splitlines()
                    if ln.startswith("Done.")][-1]
            sec = float(done.rsplit("sec=", 1)[1].split()[0])
            print(f"  2pc check-gpu 9 {flag} in a fresh process ({tree}): "
                  f"wall {wall:.3f}s, sec={sec:.3f}, outside the run "
                  f"{wall - sec:.3f}s; {done}", flush=True)
            recs.append((tree, flag, wall, sec))
    return recs


@phase("analyze soundness")
def analyze_soundness(card: str) -> dict:
    from stateright_tpu_torch.analysis.registry import SOUNDNESS_TARGETS
    from stateright_tpu_torch.analysis.soundness import certify_encoding

    assert _analyze_cli() == _analyze_cli("--device", "cpu")
    secs = {}
    for name, factory in SOUNDNESS_TARGETS:
        certs = {}
        for device in ("cuda", "cpu"):
            # the second of two: the first pays each device's warm-up
            certify_encoding(factory(None), use_cache=False, device=device)
            certs[device] = certify_encoding(factory(None), use_cache=False,
                                             device=device)
        card_d, cpu_d = (certs[d].as_dict() for d in ("cuda", "cpu"))
        secs[name] = (card_d.pop("analyzer_sec"), cpu_d.pop("analyzer_sec"))
        assert certs["cuda"].certified, card_d
        assert all(f.severity == "info" for f in certs["cuda"].obligations)
        assert certs["cuda"].collapsed == []
        assert card_d == cpu_d, (card_d, cpu_d)
        rows = sorted({f.data["battery_rows"] for f in certs["cuda"].obligations
                       if "battery_rows" in f.data})
        print(f"  {name} ({certs['cuda'].encoding}): analyzer "
              f"{secs[name][0]:.4f}s on the card, {secs[name][1]:.4f}s on "
              f"the host, equal certificates, battery_rows={rows} "
              f"({card})", flush=True)
    cold_certificate()
    cold_gate(["."], build=False)  # the build phase built the kernels
    return secs


@phase("reduction gate")
def reduction_gate() -> dict:
    import numpy as np

    from stateright_tpu_torch.analysis.soundness import certify_encoding
    from stateright_tpu_torch.cli import twopc_sizes
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.models.two_phase_commit_actors import (
        two_phase_sys_actor_model,
        two_phase_sys_compiled_encoded,
    )
    from stateright_tpu_torch.models.two_phase_commit_tpu import (
        TwoPhaseSysEncoded,
    )
    from stateright_tpu_torch.ops.bitmask import pack_bits_host
    from stateright_tpu_torch.ops.canonical import (
        DeviceRewriteSpec,
        MemberField,
    )

    class BadAmple(TwoPhaseSysEncoded):
        """The JAX analyzer's mutant: every RM's spontaneous abort
        dropped, so no dropped slot has a symmetric kept image."""

        def ample_mask_host(self):
            keep = np.ones(self.max_actions, dtype=bool)
            keep[[4 + 5 * rm for rm in range(self.rm_count)]] = False
            return pack_bits_host(keep)

    n = 9
    res = certify_encoding(BadAmple(n), use_cache=False, device="cuda")
    assert [f.rule for f in res.obligations if f.severity == "error"] == [
        "ample-non-suppression"], res.as_dict()
    try:
        TwoPhaseSys(rm_count=n).checker().spawn_sortmerge(
            encoded=BadAmple(n), ample_set=True, **twopc_sizes(n))
    except ValueError as e:
        assert "obligation 'ample-non-suppression' failed" in str(e), e
        print(f"  refused: {str(e)[:150]}...", flush=True)
    else:
        raise AssertionError("the uncertified mask ran without a waiver")
    waived = TwoPhaseSys(rm_count=n).checker().unsound_ok().spawn_sortmerge(
        encoded=BadAmple(n), ample_set=True, **twopc_sizes(n))
    run = run_main(waived, print_lines=1)
    assert 0 < run["unique"] < 10_340_352, run["unique"]
    assert waived._lane_config()["soundness_certified"] is False

    spec = DeviceRewriteSpec(2, (MemberField(0, 0, 2, 2, sort_key=True),))
    enc = two_phase_sys_compiled_encoded(2, device_rewrite_spec=spec,
                                         ample_mask=(1,))
    res = certify_encoding(enc, use_cache=False, device="cuda")
    want, row = JAX_COMPILED_VERDICT
    assert [(f.rule, f.severity) for f in res.obligations] == want, \
        res.as_dict()
    assert res.failed("symmetry").data["row"] == row
    print(f"  compiled 2pc-actors rm=2: the JAX verdict, failed "
          f"{[r for r, sev in want if sev == 'error']}, row {row}",
          flush=True)
    try:
        two_phase_sys_actor_model(2).checker().symmetry().spawn_sortmerge(
            encoded=enc)
    except ValueError as e:
        assert "obligation 'transition-equivariance' failed" in str(e), e
    else:
        raise AssertionError("the compiled spec spawned without a waiver")
    return run


# -- device simulation and the hybrid racer ---------------------------------


def sim_run(checker) -> dict:
    """Run a device simulation once, the launch counts zeroed just
    before and read just after: it runs no Merge Path kernel (it has no
    visited set), so both counts must stay 0. Prints ``sec=``,
    walk-steps/s, the peak device memory above the run's start and the
    launches."""
    import torch

    base = _mem_base()
    _zero_launches()
    t0 = time.monotonic()
    checker.join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = _read_launches()
    steps = checker.n_walks * checker.rounds * checker.max_steps
    names = checker.discovered_property_names()
    print(f"  walks={checker.n_walks} max_steps={checker.max_steps} "
          f"rounds={checker.rounds} states={checker.state_count()} "
          f"depth={checker.max_depth()} discovered={sorted(names)} "
          f"sec={sec:.3f} walk-steps/s={steps / sec:.0f} "
          f"launches={launches} "
          f"peak_mem_bytes={torch.cuda.max_memory_allocated() - base}",
          flush=True)
    assert all(n == 0 for n in launches.values()), launches
    return dict(launches=launches, sec=sec, names=names,
                states=checker.state_count(), depth=checker.max_depth(),
                fps=checker.discovery_fingerprints())


def _sim(model, device="cuda", **kw):
    return model.checker().spawn_device_simulation(device=device, **kw)


@phase("simulation 2pc rm=5, card vs CPU")
def sim_rm5():
    """The same walks on the card and on the CPU: every stats field,
    the discovery fingerprints and the frozen traces' paths equal."""
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    model = TwoPhaseSys(rm_count=5)
    cfg = dict(n_walks=4_096, max_steps=32, rounds=2, seed=0)
    gpu = _sim(model, **cfg)
    run = sim_run(gpu)
    t0 = time.monotonic()
    cpu = _sim(model, "cpu", **cfg).join()
    print(f"  cpu: states={cpu.state_count()} depth={cpu.max_depth()} "
          f"in {time.monotonic() - t0:.3f}s", flush=True)
    assert run["states"] == cpu.state_count() == 4_096 * (1 + 2 * 32)
    assert run["depth"] == cpu.max_depth(), (run["depth"], cpu.max_depth())
    assert run["names"] == cpu.discovered_property_names(), run["names"]
    assert run["fps"] == cpu.discovery_fingerprints(), run["fps"]
    assert run["names"], "no discovery to hold the traces to"
    for name, path in gpu.discoveries().items():
        assert _replays(model, path, model.property_by_name(name)), name
        assert path.encode() == cpu.discovery(name).encode(), name
    return run


@phase("simulation 2pc rm=9 (main path)")
def sim_rm9():
    """262,144 walks of 64 steps, 4 rounds, paths on: 67,371,008
    generated states, traces no deeper than a round, discoveries among
    the host's, each path replayed."""
    from stateright_tpu_torch.model import Expectation
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    model = TwoPhaseSys(rm_count=9)
    checker = _sim(model, n_walks=262_144, max_steps=64, rounds=4, seed=0)
    run = sim_run(checker)
    assert run["states"] == 262_144 * (1 + 4 * 64) == 67_371_008
    assert 1 < run["depth"] <= 65, run["depth"]
    host = HAND.get("2pc rm=9", (None, {
        p.name for p in model.properties()
        if p.expectation == Expectation.SOMETIMES}))[1]
    assert run["names"] <= host, (run["names"], host)
    for name, path in checker.discoveries().items():
        assert _replays(model, path, model.property_by_name(name)), name
    return run


#: the option that makes the script print the device operations of one
#: ``simulation paxos check 4`` run of N steps, and nothing else
SIM_OPS_FLAG = "--paxos-simulation-device-ops"


def _paxos_sim(max_steps: int):
    from stateright_tpu_torch.models.paxos import PaxosModelCfg, paxos_model

    model = paxos_model(PaxosModelCfg(client_count=4, server_count=3))
    return _sim(model, n_walks=16_384, max_steps=max_steps, rounds=1,
                seed=0, track_paths=False)


def sim_device_ops(max_steps: int) -> int:
    """Device operations of one Paxos 4 simulation run of ``max_steps``
    steps, counted by ``torch.profiler`` (device activity only)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    checker = _paxos_sim(max_steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        checker.join()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA)


def _device_kernels(*max_steps: int) -> list:
    """``sim_device_ops`` for each of ``max_steps``, each in a process
    of its own, all started together: a second profiler session in one
    process can come back empty, and the last phase takes this
    process's one session."""
    procs = [subprocess.Popen([sys.executable, __file__, SIM_OPS_FLAG,
                               str(n)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for n in max_steps]
    counts = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"device-op count failed: {err[-2000:]}")
            counts.append(int(out.split()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return counts


@phase("simulation paxos check 4")
def sim_paxos4():
    """16,384 walks of the Paxos 4 encoding's dense step, paths off: a
    host-bound run. Kernels a walk step: a 2-step run's device
    operations less a 1-step run's."""
    run = sim_run(_paxos_sim(SIM_PAXOS_STEPS))
    assert run["states"] == 16_384 * (1 + SIM_PAXOS_STEPS)
    assert run["names"] <= {"value chosen"}, run["names"]
    one, two = _device_kernels(1, 2)
    run["kernels_a_step"] = two - one
    print(f"  kernels a walk step: {two - one} (1-step run {one}, 2-step "
          f"run {two})", flush=True)
    return run


#: the walk length of the Paxos 4 simulation phase
SIM_PAXOS_STEPS = 32


def hybrid_run(builder, **kw) -> dict:
    """One hybrid race on the card, the launch counts zeroed just before
    and read just after. Prints the winner, ``sec=``, the counts and
    each side's progress; when the device wins, both kernels must have
    launched."""
    import torch

    base = _mem_base()
    _zero_launches()
    t0 = time.monotonic()
    hy = builder.spawn_hybrid(**kw).join()
    torch.cuda.synchronize()
    sec = time.monotonic() - t0
    launches = _read_launches()
    host, dev = hy.engines["host"], hy.engines["device"]
    names = hy.discovered_property_names()
    print(f"  winner={hy.winner} states={hy.state_count()} "
          f"unique={hy.unique_state_count()} depth={hy.max_depth()} "
          f"discovered={sorted(names)} sec={sec:.3f} launches={launches} "
          f"device: waves={dev.metrics.get('waves')} "
          f"cancelled={dev.cancelled}; host: unique="
          f"{host._unique_states} cancelled={host.cancelled} "
          f"peak_mem_bytes={torch.cuda.max_memory_allocated() - base}",
          flush=True)
    if hy.winner == "device":
        assert all(launches[k] > 0 for k in MERGE_KERNELS), launches
    return dict(launches=launches, metrics=dev.metrics, sec=sec,
                unique=hy.unique_state_count(), names=names,
                winner=hy.winner)


@phase("hybrid increment 6")
def hybrid_increment6():
    """The shallow bug: the names the engine alone discovers."""
    from stateright_tpu_torch.cli import INCREMENT_SIZES, increment_checker
    from stateright_tpu_torch.models.increment import Increment

    alone = increment_checker(6, locked=False).join()
    run = hybrid_run(Increment(6).checker(), **INCREMENT_SIZES)
    assert run["names"] == alone.discovered_property_names() == {"fin"}
    return run


@phase("hybrid paxos 2c/3s")
def hybrid_paxos2():
    """The full check, paths on as ``paxos check-gpu 2``: 16,668 unique
    states and "value chosen", whichever side wins."""
    from stateright_tpu_torch.models.paxos import PaxosModelCfg, paxos_model
    from stateright_tpu_torch.models.paxos_tpu import STRUCTURAL_SIZES

    model = paxos_model(PaxosModelCfg(client_count=2, server_count=3))
    run = hybrid_run(model.checker(), **STRUCTURAL_SIZES[2])
    assert run["unique"] == 16_668, run["unique"]
    assert "value chosen" in run["names"], run["names"]
    return run


@phase("hybrid paxos check 4 (main path)")
def hybrid_paxos4():
    """``paxos check 4`` raced, at the sizes of ``paxos check-gpu 4``
    (paths off), then the engine alone in the same call: 2,372,188
    unique states either way, and the two walls."""
    from stateright_tpu_torch.cli import paxos_checker
    from stateright_tpu_torch.models.paxos import PaxosModelCfg, paxos_model
    from stateright_tpu_torch.models.paxos_tpu import STRUCTURAL_SIZES

    model = paxos_model(PaxosModelCfg(client_count=4, server_count=3))
    run = hybrid_run(model.checker(), track_paths=False,
                     **STRUCTURAL_SIZES[4])
    assert run["unique"] == 2_372_188, run["unique"]
    assert "value chosen" in run["names"], run["names"]
    alone = run_main(paxos_checker(4))
    assert alone["unique"] == 2_372_188, alone["unique"]
    run["alone_sec"] = alone["sec"]
    print(f"  raced sec={run['sec']:.3f} against alone sec="
          f"{alone['sec']:.3f}: {run['sec'] / alone['sec']:.1f}x",
          flush=True)
    return run


# -- the hash wave engine and its insert kernel ------------------------------

#: 2pc rm=9's widest wave under the hash engine: the keys one insert
#: takes (the engine's ``metrics["insert_shape"]``), into 2^25 slots
HASH_KEYS = 16_395_948
HASH_SLOTS = 1 << 25


def _probe_reads(keys, slot, over, active, mask: int, rounds: int) -> int:
    """Table reads the insert's probes take: the depth at which each
    active row met its slot plus one (``rounds`` for a row that
    overflowed)."""
    import torch

    from stateright_tpu_torch.ops import hashset

    idx = hashset._slot_hash(keys, mask)
    found = idx == slot
    reads = torch.ones_like(idx)
    for d in range(1, rounds):
        idx = (idx + d) & mask
        reads += ~found
        found |= idx == slot
    reads = torch.where(over, rounds, reads)
    return int(reads.sum() if active is None else reads[active].sum())


def _hash_bound(keys, slot, is_new, over, active, mask: int,
                rounds: int) -> dict:
    """The insert's bound from this call's data: each active row's key
    read once (8 B) and ``active`` (1 B a row, when given), ``slot`` (8
    B), ``is_new`` and ``overflow`` (1 B each) written once, one 8-byte
    table read a probe and one 8-byte write a new key; the same with
    each random access a 32-byte sector beside it."""
    n = keys.numel()
    live = n if active is None else int(active.sum())
    reads = _probe_reads(keys, slot, over, active, mask, rounds)
    inserts = int(is_new.sum())
    ops = 8 * live + 4 * reads
    rows = 8 * live + 10 * n + (0 if active is None else n)
    b8 = _bound_ms(rows + 8 * (reads + inserts), ops)
    b32 = _bound_ms(rows + 32 * (reads + inserts), ops)
    return dict(bound_ms=b8[0], bound_by=b8[1], bound_ms_32b_sectors=b32[0],
                probe_reads=reads, inserts=inserts)


def _time_reset_ms(fn, reset, reps=10) -> float:
    """Mean device time of ``fn`` with ``reset()`` before each launch,
    outside the timed events: it restores the table the call starts
    from, and its write (a whole table, past L2's 50 MB) leaves L2 cold."""
    import torch

    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    reset()
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    for start, end in pairs:
        reset()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def _sorted_entries(table):
    """A tagged table's ``{key, tag}`` entries in lexicographic order."""
    import torch

    e = table.entries
    order = torch.argsort(e[:, 1], stable=True)
    return e[order[torch.argsort(e[order, 0], stable=True)]]


def _tag_rule_holds(table) -> bool:
    """Every full slot's tag 1 (epoch 0) and every empty slot's 0, as
    ``from_keys`` and ``reset`` leave a table."""
    return bool((table.entries[:, 1] == table.occupied().long()).all())


def _hash_case(label, pre, keys, rounds, fits=True, active=None) -> dict:
    """The kernel and the plain version, each from a copy of the table
    ``pre`` (packed keys), on ``keys`` where ``active`` (every row when
    None); held to each other, and timed when ``fits``. Returns the
    comparison (and the times)."""
    import torch

    from stateright_tpu_torch.ops import hashset

    def run(insert):
        table = hashset.DeviceHashSet.from_keys(pre)
        return (table, *insert(table, keys, active, rounds))

    tk, new_k, over_k, slot_k = run(hashset.insert_cuda)
    tp, new_p, over_p, slot_p = run(hashset.insert_plain)
    _, new_k2, _, _ = run(hashset.insert_cuda)
    torch.cuda.synchronize()
    ok = ~over_k if active is None else ~over_k & active
    slot_err = int((tk.keys[slot_k[ok]] != keys[ok]).sum())
    if active is not None:  # inactive rows: slot 0, never new or overflowed
        slot_err += int((slot_k[~active] != 0).sum()
                        + (new_k | over_k)[~active].sum())
    out = dict(label=label, keys=keys.numel(), slots=pre.numel(),
               occupied_before=int((pre != hashset.EMPTY).sum()),
               new=int(new_k.sum()), overflow=int(over_k.sum()),
               plain_overflow=int(over_p.sum()), slot_err=slot_err)
    print(f"  {label}: {out}", flush=True)
    assert slot_err == 0, out
    if not fits:  # placements differ where keys overflow; both report it
        assert out["overflow"] and out["plain_overflow"], out
        return out
    assert not out["overflow"] and not out["plain_overflow"], out
    out["max_abs_err"] = max(_err(new_k, new_p), _err(new_k, new_k2))
    assert out["max_abs_err"] == 0, "is_new differs"
    assert torch.equal(_sorted_entries(tk), _sorted_entries(tp)), \
        "tables differ as sets of {key, tag} entries"
    table = hashset.DeviceHashSet.from_keys(pre)
    assert _tag_rule_holds(table), "from_keys broke the tag rule"
    reset = lambda: table.reset(pre)  # noqa: E731
    out["ms"] = _time_reset_ms(
        lambda: hashset.insert_cuda(table, keys, active, rounds), reset)
    reset()
    assert _tag_rule_holds(table), "reset broke the tag rule"
    out["plain_ms"] = _time_reset_ms(
        lambda: hashset.insert_plain(table, keys, active, rounds), reset, 3)
    out.update(_hash_bound(keys, slot_k, new_k, over_k, active,
                           pre.numel() - 1, rounds))
    out["library_ms"] = None  # no PyTorch call inserts into a hash table
    out["pct_of_bound"] = 100 * out["bound_ms"] / out["ms"]
    was = HASH_THREE_PASS_MS.get(label)
    was = f"; three-pass kernel {was} ms" if was is not None else ""
    print(f"  {label}: kernel {out['ms']:.4f} ms ({out['pct_of_bound']:.1f}%"
          f" of bound{was}), plain {out['plain_ms']:.4f} ms, bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']}; 32-byte sectors "
          f"{out['bound_ms_32b_sectors']:.4f} ms), {out['probe_reads']} "
          f"probe reads", flush=True)
    return out


def _distinct_keys(n, gen, device):
    """n distinct random packed keys (64-bit draws, never the empty
    slot; a repeat is dropped and redrawn)."""
    import torch

    from stateright_tpu_torch.ops import hashset
    from stateright_tpu_torch.ops.fingerprint import pack_keys

    out = torch.zeros(0, dtype=torch.int64, device=device)
    while out.numel() < n:
        m = n - out.numel()
        lo = torch.randint(0, 1 << 32, (m,), generator=gen, device=device)
        hi = torch.randint(0, 1 << 32, (m,), generator=gen, device=device)
        out = torch.unique(torch.cat([out, pack_keys(lo, hi)]))
        out = out[out != hashset.EMPTY]
    perm = torch.randperm(out.numel(), generator=gen, device=device)
    return out[perm[:n]]


def _draw(pool, n, gen):
    import torch

    idx = torch.randint(0, pool.numel(), (n,), generator=gen,
                        device=pool.device)
    return pool[idx]


def _filled(keys, slots: int):
    """A table of ``slots`` holding ``keys`` (placed by the kernel)."""
    from stateright_tpu_torch.ops import hashset

    table = hashset.DeviceHashSet.empty(slots, keys.device)
    _, over, _ = hashset.insert_cuda(table, keys, None, 32)
    assert not bool(over.any()), "prefill overflowed"
    return table.keys.clone()


def _kernel_inputs(dev):
    """The ``hash insert kernel`` phase's inputs at 2pc rm=9's widest
    wave: ``({label: (pre, keys, rounds, active)}, gen)`` — keys with
    in-batch duplicates (drawn from a pool of a quarter as many keys)
    into an empty table, and a batch drawn from the table's own keys and
    2^20 fresh ones into a half-full table (a tenth of its rows
    inactive); ``pre`` is the table's packed keys, ``gen`` the generator
    the phase goes on drawing from."""
    import torch

    from stateright_tpu_torch.ops import hashset

    gen = torch.Generator(device=dev)
    gen.manual_seed(20261018)
    empty = torch.full((HASH_SLOTS,), hashset.EMPTY, dtype=torch.int64,
                       device=dev)
    pool = _distinct_keys(HASH_KEYS // 4, gen, dev)
    keys = _draw(pool, HASH_KEYS, gen)
    keys[:5] = torch.iinfo(torch.int64).max  # the all-ones fingerprint
    half = _distinct_keys(HASH_SLOTS // 2 + HASH_SLOTS // 32, gen, dev)
    pre = _filled(half[:HASH_SLOTS // 2], HASH_SLOTS)
    active = torch.rand(HASH_KEYS, generator=gen, device=dev) < 0.9
    return {"empty table": (empty, keys, 16, None),
            "half-full table": (pre, _draw(half, HASH_KEYS, gen), 32,
                                active)}, gen


@phase("hash insert kernel")
def hash_kernel():
    """The insert kernel's registers and spills and its refusals; then
    the kernel against its plain version at the inputs of
    :func:`_kernel_inputs`, a table too small for its batch, and an
    empty batch (no launch)."""
    import torch

    from stateright_tpu_torch.ops import cuda_build, hashset

    print(cuda_build.ptxas_report("hashset.cu"), flush=True)
    dev = torch.device("cuda")
    one = torch.ones(1, dtype=torch.int64, device=dev)
    buf = torch.full((2 * 64 + 1,), hashset.EMPTY, dtype=torch.int64,
                     device=dev)
    bad = {"untagged": hashset.DeviceHashSet(buf[:64]),
           "misaligned": hashset.DeviceHashSet(buf[1::2], buf[1:].view(64, 2))}
    for what, table in bad.items():
        try:
            hashset.insert_cuda(table, one)
        except ValueError as exc:
            print(f"  {what} table refused: {exc}", flush=True)
        else:
            raise AssertionError(f"an {what} table was taken")
    inputs, gen = _kernel_inputs(dev)
    cases = {label: _hash_case(label, pre, keys, rounds, active=active)
             for label, (pre, keys, rounds, active) in inputs.items()}
    small = torch.full((256,), hashset.EMPTY, dtype=torch.int64, device=dev)
    _hash_case("overflow", small, _draw(_distinct_keys(1000, gen, dev), 400,
                                        gen), 2, fits=False)
    launched = hashset.insert_cuda.launches
    none = hashset.insert_cuda(hashset.DeviceHashSet.from_keys(small),
                               inputs["empty table"][1][:0])
    assert all(t.numel() == 0 for t in none), "an empty batch returned rows"
    assert hashset.insert_cuda.launches == launched, "an empty batch launched"
    rec = dict(cases["empty table"],
               max_abs_err=max(c["max_abs_err"] for c in cases.values()),
               half_full=cases["half-full table"])
    empty, keys = inputs["empty table"][:2]
    table = hashset.DeviceHashSet.from_keys(empty)
    return rec, lambda: hashset.insert_cuda(table, keys, None, 16)


def hash_at(label: str, run: dict):
    """The phase ``hash insert at <label> shapes``: the kernel against its
    plain version, and timed, at the widest wave of the hash run
    ``label``: ``occupied`` keys in the table, a batch of ``keys`` of
    which ``new`` are fresh and the rest draws from the table and the
    fresh ones."""
    return phase(f"hash insert at {label} shapes")(_hash_at)(label, run)


def _wave_inputs(shape, capacity: int):
    """``(pre, batch)`` at a hash run's widest wave ``shape`` (occupied,
    keys, new; its ``metrics["insert_shape"]``): a table of ``capacity``
    slots holding ``occupied`` keys, and a batch of ``keys`` rows of
    which ``new`` are fresh and the rest draws from the table and the
    fresh ones, in random order."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261019)
    occ, n, new = shape
    keys = _distinct_keys(occ + new, gen, dev)
    pre = _filled(keys[new:], capacity)
    batch = torch.cat([keys[:new], _draw(keys, n - new, gen)])
    return pre, batch[torch.randperm(n, generator=gen, device=dev)]


def _hash_at(label, run):
    pre, batch = _wave_inputs(run["metrics"]["insert_shape"],
                              run["capacity"])
    return _hash_case(label, pre, batch, 16)


def _hash(model, device="cuda", **kw):
    return model.checker().spawn_hash(device=device, **kw)


def hash_card_vs_cpu(model, want: int, **kw) -> dict:
    """A hash run with paths on the card (``run_main``) and on the CPU:
    the same counts, depth, discovery fingerprints and paths, each path
    replayed through the host model."""
    checker = _hash(model, **kw)
    run = run_main(checker, print_lines=3, kernels=HASH_KERNELS)
    t0 = time.monotonic()
    cpu = _hash(model, "cpu", **kw).join()
    print(f"  cpu: states={cpu.state_count()} "
          f"unique={cpu.unique_state_count()} depth={cpu.max_depth()} "
          f"in {time.monotonic() - t0:.3f}s", flush=True)
    assert run["unique"] == cpu.unique_state_count() == want, run["unique"]
    assert (run["states"], run["depth"]) == (cpu.state_count(),
                                             cpu.max_depth())
    assert run["names"] == cpu.discovered_property_names(), run["names"]
    assert run["fps"] == cpu.discovery_fingerprints(), run["fps"]
    assert run["names"], "no discovery to hold the paths to"
    for name, path in checker.discoveries().items():
        assert _replays(model, path, model.property_by_name(name)), name
        assert path.encode() == cpu.discovery(name).encode(), name
    return run


@phase("hash 2pc rm=5, card vs CPU")
def hash_rm5():
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    run = hash_card_vs_cpu(TwoPhaseSys(rm_count=5), 8832, capacity=1 << 15)
    HAND["hash 2pc rm=5"] = run["names"]
    return run


@phase("hash paxos 2c/3s, card vs CPU")
def hash_paxos2():
    from stateright_tpu_torch.models.paxos import PaxosModelCfg, paxos_model

    model = paxos_model(PaxosModelCfg(client_count=2, server_count=3))
    return hash_card_vs_cpu(model, 16668, capacity=1 << 16)


@phase("hash 2pc rm=9 (main path)")
def hash_rm9():
    """The library entry point ``spawn_hash`` at 2pc rm=9, paths on,
    2^25 slots: held to the sort-merge run of this call."""
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    model = TwoPhaseSys(rm_count=9)
    checker = _hash(model, capacity=HASH_SLOTS)
    run = run_main(checker, print_lines=1, kernels=HASH_KERNELS)
    assert run["unique"] == 10_340_352, run["unique"]
    assert "2pc rm=9" in HAND, "the sort-merge 2pc rm=9 phase did not pass"
    assert (run["unique"], run["names"]) == HAND["2pc rm=9"], run
    assert (run["states"], run["depth"]) == (
        HAND["2pc rm=9 states"], HAND["2pc rm=9 depth"]), run
    for name, path in checker.discoveries().items():
        assert _replays(model, path, model.property_by_name(name)), name
    return run


@phase("hash paxos check 4")
def hash_paxos4():
    """``paxos check 4`` through ``spawn_hash``, paths off, 2^23 slots:
    the dense Paxos step, host-bound."""
    from stateright_tpu_torch.models.paxos import PaxosModelCfg, paxos_model

    model = paxos_model(PaxosModelCfg(client_count=4, server_count=3))
    run = run_main(_hash(model, capacity=1 << 23, track_paths=False),
                   kernels=HASH_KERNELS)
    assert run["unique"] == 2_372_188, run["unique"]
    assert run["names"] == {"value chosen"}, run["names"]
    return run


@phase("host bfs 2pc rm=5")
def host_bfs_rm5():
    """The host BFS, the hash engine's oracle: 8,832 unique and the
    names of the hash run of this call."""
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    t0 = time.monotonic()
    c = TwoPhaseSys(rm_count=5).checker().spawn_bfs().join()
    sec = time.monotonic() - t0
    names = set(c.discoveries())
    print(f"  states={c.state_count()} unique={c.unique_state_count()} "
          f"depth={c.max_depth()} discovered={sorted(names)} "
          f"sec={sec:.3f} states/s={c.state_count() / sec:.0f}", flush=True)
    assert c.unique_state_count() == 8832, c.unique_state_count()
    assert names == HAND.get("hash 2pc rm=5"), names


# -- the tiered visited set (tier.py) ----------------------------------------

#: hot-tier ceilings of the tiered runs: about a tenth of each space, so
#: the runs spill often
TIER_HOT_2PC9 = 1 << 20
TIER_HOT_PAXOS4 = 1 << 18
#: cold runs kept before a compaction in the 2pc rm=9 tiered runs: it
#: spills 6 times at 2^20 (an H100 run), so a fan-in of 2 compacts twice
#: (the default 8 never would)
TIER_MAX_RUNS_2PC9 = 2


def tier_report(run: dict, resident: dict | None) -> None:
    """Print a tiered run's tier metrics beside the resident run of the
    same configuration in this call: ``sec=``, peak device memory above
    the run's start, the resident-buffer plan beside it, the launches,
    the spill and ingest walls and the host time of the cold
    membership."""
    m = run["metrics"]
    tier = {k: m.get(k) for k in (
        "tier_spills", "cold_rows", "hot_rows", "hot_ceiling_rows",
        "cold_runs", "spill_wall_sec", "ingest_sec", "ingest_wait_sec",
        "cold_member_sec")}
    print(f"  tier: {tier}", flush=True)
    print(f"  tiered: sec={run['sec']:.3f} peak_mem_bytes="
          f"{run['peak_mem_bytes']} plan resident_bytes="
          f"{run['plan_resident_bytes']} launches={run['launches']}",
          flush=True)
    if resident:
        print(f"  resident: sec={resident['sec']:.3f} peak_mem_bytes="
              f"{resident['peak_mem_bytes']} plan resident_bytes="
              f"{resident['plan_resident_bytes']} "
              f"launches={resident['launches']}", flush=True)


@phase("2pc rm=9 tiered (main path)")
def rm9_tiered(resident: dict | None):
    """``2pc rm=9`` with paths through ``spawn_sortmerge(...,
    tier_hot_rows=2**20, tier_max_runs=2)`` at the CLI's sizes: the
    resident run's counts, names and discovery fingerprints (phase 4),
    paths that replay, at least two spills, compaction, the tiers
    partitioning the visited set, both Merge Path kernels launched;
    then :func:`ingest_walls`."""
    from stateright_tpu_torch.cli import twopc_sizes
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    model = TwoPhaseSys(rm_count=9)
    checker = model.checker().spawn_sortmerge(
        tier_hot_rows=TIER_HOT_2PC9, tier_max_runs=TIER_MAX_RUNS_2PC9,
        **twopc_sizes(9))
    run = run_main(checker, print_lines=1)
    m = run["metrics"]
    assert run["unique"] == 10_340_352, run["unique"]
    assert "2pc rm=9" in HAND, "the resident 2pc rm=9 phase did not pass"
    assert (run["unique"], run["names"]) == HAND["2pc rm=9"], run
    assert (run["states"], run["depth"], run["fps"]) == (
        HAND["2pc rm=9 states"], HAND["2pc rm=9 depth"],
        HAND["2pc rm=9 fps"]), run
    assert m["tier_spills"] >= 2, m
    assert m["cold_runs"] < m["tier_spills"], m  # compacted
    assert m["cold_rows"] + m["hot_rows"] == run["unique"], m
    for name, path in checker.discoveries().items():
        assert _replays(model, path, model.property_by_name(name)), name
    tier_report(run, resident)
    run["ingest_walls"] = ingest_walls(model, m)
    return run


def ingest_walls(model, m: dict) -> dict:
    """The tiered 2pc rm=9 run twice more, paths off: the cold store's
    ingest on its worker thread (as the engine runs it), then on the
    wave loop's own thread; each run's wall and tier walls. The worker
    shares the interpreter lock with the wave loop."""
    import functools

    import torch

    from stateright_tpu_torch.cli import twopc_sizes
    from stateright_tpu_torch.tier import ColdStore

    out = {}
    for mode in ("worker thread", "wave loop's thread"):
        patched = ColdStore.ingest
        if mode != "worker thread":
            ColdStore.ingest = functools.partialmethod(patched,
                                                       asynchronous=False)
        try:
            c = model.checker().spawn_sortmerge(
                tier_hot_rows=TIER_HOT_2PC9,
                tier_max_runs=TIER_MAX_RUNS_2PC9, track_paths=False,
                **twopc_sizes(9))
            t0 = time.monotonic()
            c.join()
            torch.cuda.synchronize()
            sec = time.monotonic() - t0
        finally:
            ColdStore.ingest = patched
        cm = c.metrics
        assert c.unique_state_count() == 10_340_352
        assert (cm["tier_spills"], cm["cold_rows"]) == (
            m["tier_spills"], m["cold_rows"]), cm
        out[mode] = dict(sec=sec, **{k: cm[k] for k in (
            "ingest_sec", "ingest_wait_sec", "spill_wall_sec",
            "cold_member_sec")})
        print(f"  ingest on the {mode} (paths off): {out[mode]}",
              flush=True)
    return out


@phase("paxos check 4 tiered (main path)")
def paxos4_tiered(resident: dict | None):
    """``paxos check 4`` through the CLI's checker and sizes with
    ``--tier-hot-rows=2**18``, paths off: 2,372,188 with phase 6's
    discovery fingerprints."""
    from stateright_tpu_torch.cli import RunFlags, paxos_checker

    run = run_main(paxos_checker(4, RunFlags(tier_hot_rows=TIER_HOT_PAXOS4)))
    m = run["metrics"]
    assert run["unique"] == 2_372_188, run["unique"]
    assert run["names"] == {"value chosen"}, run["names"]
    assert run["fps"] == HAND.get("paxos 4c fps"), run["fps"]
    assert m["tier_spills"] >= 2, m
    assert m["cold_rows"] + m["hot_rows"] == run["unique"], m
    tier_report(run, resident)
    return run


@phase("2pc rm=5 tiered, card vs CPU")
def rm5_tiered():
    """``2pc rm=5`` with paths at a 1,024-key hot tier on the card and on
    the CPU: every field equal, the tier's too."""
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    model = TwoPhaseSys(rm_count=5)
    runs = {}
    for device in ("cuda", "cpu"):
        c = model.checker().spawn_sortmerge(
            capacity=1 << 15, frontier_capacity=1 << 13, device=device,
            tier_hot_rows=1024).join()
        runs[device] = c
        print(f"  {device}: states={c.state_count()} "
              f"unique={c.unique_state_count()} depth={c.max_depth()} "
              f"tier_spills={c.metrics['tier_spills']} "
              f"cold_rows={c.metrics['cold_rows']} "
              f"hot_rows={c.metrics['hot_rows']}", flush=True)
    gpu, cpu = runs["cuda"], runs["cpu"]
    assert gpu.unique_state_count() == 8832, gpu.unique_state_count()
    assert gpu.metrics["tier_spills"] >= 2, gpu.metrics
    for f in ("tier_spills", "cold_rows", "hot_rows", "waves",
              "member_shape", "merge_shape"):
        assert gpu.metrics[f] == cpu.metrics[f], f
    assert (gpu.state_count(), gpu.max_depth()) == (
        cpu.state_count(), cpu.max_depth())
    assert gpu.discovery_fingerprints() == cpu.discovery_fingerprints()
    for name, path in gpu.discoveries().items():
        assert _replays(model, path, model.property_by_name(name)), name
        assert path.encode() == cpu.discovery(name).encode(), name


@phase("2pc check-gpu 9 --tier-hot-rows=auto")
def rm9_tier_auto():
    """The CLI's flags (``--tier-hot-rows=auto``) at 2pc rm=9: JAX's 2 GiB
    budget fits the whole visited ladder at these sizes, so the tier
    stays dormant — no spill, the resident count."""
    from stateright_tpu_torch.cli import _pop_flags, twopc_sizes
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    flags, rest = _pop_flags(["--tier-hot-rows=auto"])
    assert rest == [] and flags.tier_hot_rows == "auto", flags
    sizes = twopc_sizes(9)
    c = flags.spawn(TwoPhaseSys(rm_count=9), symmetric=True, **sizes)
    run = run_main(c, print_lines=1)
    assert run["unique"] == 10_340_352, run["unique"]
    assert run["metrics"]["hot_ceiling_rows"] == sizes["capacity"]
    assert "tier_spills" not in run["metrics"], run["metrics"]
    return run


# -- checkpoints, resume and fault recovery (checkpoint.py) ----------------

#: waves between two snapshots of the 2pc rm=9 runs
CKPT_EVERY_2PC9 = 4
#: waves between two snapshots of the hash 2pc rm=9 run (a snapshot holds
#: the 2^25-slot table: 512 MB of limbs), and the wave it is killed at
CKPT_EVERY_HASH9 = 8
CKPT_KILL_HASH9 = 15
#: the wave of the supervised 2pc rm=9 run that raises mid-wave
CKPT_FAULT_2PC9 = 21
ROOT = os.path.dirname(os.path.abspath(__file__))


def _ckpt_kill(checker, wave=None) -> dict:
    """Run the checkpointing ``checker`` with retries off until a raise
    armed at wave ``wave``'s boundary (after its snapshot) kills it, or
    one the caller armed; return its snapshot counters, wall and peak
    device memory above its start."""
    import torch

    from stateright_tpu_torch import faultinject

    checker.max_fault_retries = 0
    base = _mem_base()
    if wave is not None:
        faultinject.arm("raise", "chunk_boundary", wave)
    t0 = time.monotonic()
    try:
        checker.join()
    except faultinject.InjectedFault as exc:
        print(f"  killed: {exc}", flush=True)
    else:
        raise AssertionError("the armed fault did not fire")
    finally:
        faultinject.disarm_all()
    torch.cuda.synchronize()
    stats = dict(checker._ckpt_stats, sec=time.monotonic() - t0,
                 peak_mem_bytes=torch.cuda.max_memory_allocated() - base)
    n = stats.get("snapshots", 0)
    assert n, stats
    stats["write_sec_per_snapshot"] = stats["snapshot_write_sec"] / n
    print(f"  killed run: {stats}", flush=True)
    return stats


def _resumed(checker, snap, kernels=MERGE_KERNELS) -> dict:
    """``checker`` resumed from ``snap`` and run through ``run_main``: the
    resume's walls (read, CRC, checks and the host work in
    ``resume_from``; the upload in the run) beside the run's."""
    t0 = time.monotonic()
    manifest = checker.resume_from(snap)
    load = time.monotonic() - t0
    run = run_main(checker, print_lines=1, kernels=kernels)
    run["resume"] = dict(
        wave=manifest["wave"], depth=manifest["depth"],
        unique=manifest["unique"], snapshot_bytes=manifest["snapshot_bytes"],
        load_sec=load, host_sec=run["metrics"].get("resume_host_sec"),
        upload_sec=run["metrics"].get("resume_upload_sec"))
    print(f"  resume: {run['resume']}", flush=True)
    return run


def _held_to_rm9(model, checker, run: dict) -> None:
    """A 2pc rm=9 run's counts, depth, names and discovery fingerprints
    equal phase 4's, and its paths replay."""
    assert "2pc rm=9" in HAND, "the resident 2pc rm=9 phase did not pass"
    assert run["unique"] == 10_340_352, run["unique"]
    assert (run["unique"], run["names"]) == HAND["2pc rm=9"], run
    assert (run["states"], run["depth"], run["fps"]) == (
        HAND["2pc rm=9 states"], HAND["2pc rm=9 depth"],
        HAND["2pc rm=9 fps"]), run
    for name, path in checker.discoveries().items():
        assert _replays(model, path, model.property_by_name(name)), name


@phase("2pc rm=9 killed and resumed (main path)")
def rm9_resumed(resident: dict, tmp: str):
    """``2pc rm=9`` with paths and a snapshot every 4 waves, killed at the
    first snapshot wave past its widest wave and resumed on the card:
    phase 4's counts, fingerprints and paths; the snapshot bytes and
    walls, the resume walls, and ``sec=`` and peak memory beside phase
    4's."""
    from stateright_tpu_torch.cli import twopc_sizes
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    model = TwoPhaseSys(rm_count=9)
    sizes = twopc_sizes(9)
    widest = resident["metrics"]["widest_wave"]
    kill = next(w for w in range(CKPT_EVERY_2PC9 - 1, 1 << 20,
                                 CKPT_EVERY_2PC9) if w > widest)
    print(f"  widest wave {widest}, killed at wave {kill}", flush=True)
    snap = os.path.join(tmp, "rm9.ckpt")
    killed = _ckpt_kill(model.checker().spawn_sortmerge(
        checkpoint_every=CKPT_EVERY_2PC9, checkpoint_path=snap, **sizes),
        kill)
    checker = model.checker().spawn_sortmerge(**sizes)
    run = _resumed(checker, snap)
    _held_to_rm9(model, checker, run)
    assert run["resume"]["wave"] == kill + 1, run["resume"]
    print(f"  resumed sec={run['sec']:.3f} against phase 4's "
          f"{resident['sec']:.3f}; peak_mem_bytes {run['peak_mem_bytes']} "
          f"(killed run {killed['peak_mem_bytes']}) against phase 4's "
          f"{resident['peak_mem_bytes']}", flush=True)
    run.update(killed=killed, kill_wave=kill, widest_wave=widest)
    return run


@phase("2pc rm=9 supervised recovery")
def rm9_recovery(tmp: str):
    """``2pc rm=9`` with a snapshot every 4 waves and a raise mid-wave:
    one recovery warning, phase 4's counts and fingerprints in one
    join."""
    from stateright_tpu_torch import faultinject
    from stateright_tpu_torch.cli import twopc_sizes
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    model = TwoPhaseSys(rm_count=9)
    checker = model.checker().spawn_sortmerge(
        checkpoint_every=CKPT_EVERY_2PC9,
        checkpoint_path=os.path.join(tmp, "recovery.ckpt"), **twopc_sizes(9))
    checker.retry_backoff_sec = 0.01
    faultinject.arm("raise", "mid_chunk", CKPT_FAULT_2PC9)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run = run_main(checker, print_lines=1)
    finally:
        faultinject.disarm_all()
    rec = [str(w.message) for w in caught
           if "supervised recovery" in str(w.message)]
    print(f"  {rec}", flush=True)
    assert len(rec) == 1, rec
    assert run["metrics"]["fault_recoveries"] == 1, run["metrics"]
    _held_to_rm9(model, checker, run)
    return run


@phase("2pc check-gpu 9 --checkpoint-every=auto")
def rm9_auto(resident: dict, tmp: str):
    """The CLI's ``--checkpoint-every=auto`` at 2pc rm=9: the cadence
    ``auto_cadence`` picks from the measured walls, and ``sec=`` beside
    phase 4's (the snapshots' overhead)."""
    from stateright_tpu_torch.cli import _pop_flags, twopc_sizes
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    flags, rest = _pop_flags(["--checkpoint-every=auto",
                              f"--checkpoint-path={tmp}/auto.ckpt"])
    assert rest == [] and flags.checkpoint_every == "auto", flags
    model = TwoPhaseSys(rm_count=9)
    checker = flags.spawn(model, symmetric=True, **twopc_sizes(9))
    run = run_main(checker, print_lines=1)
    m = run["metrics"]
    print(f"  auto cadence: every {m['checkpoint_every']} waves, "
          f"{m.get('snapshots', 0)} snapshots, write "
          f"{m.get('snapshot_write_sec', 0.0):.3f}s; sec={run['sec']:.3f} "
          f"against phase 4's {resident['sec']:.3f}", flush=True)
    _held_to_rm9(model, checker, run)
    return run


@phase("2pc rm=9 tiered killed and resumed")
def rm9_tiered_resumed(tiered: dict | None, tmp: str):
    """``2pc rm=9`` at phase 23's 2^20-key hot tier with a snapshot every
    wave, killed at the boundary of the wave of its second spill, resumed
    tiered: phase 4's counts and fingerprints, phase 23's spills, and
    cold plus hot rows equal to unique."""
    from stateright_tpu_torch import faultinject
    from stateright_tpu_torch.checkers.tpu_sortmerge import HotColdTier
    from stateright_tpu_torch.cli import twopc_sizes
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    model = TwoPhaseSys(rm_count=9)
    sizes = twopc_sizes(9)
    snap = os.path.join(tmp, "tiered.ckpt")
    spilled = []
    real = HotColdTier.spill

    def spill(self, st):
        spilled.append(st.waves)
        if len(spilled) == 2:  # killed at this wave's boundary
            faultinject.arm("raise", "chunk_boundary", st.waves)
        real(self, st)

    HotColdTier.spill = spill
    try:
        killed = _ckpt_kill(model.checker().spawn_sortmerge(
            tier_hot_rows=TIER_HOT_2PC9, tier_max_runs=TIER_MAX_RUNS_2PC9,
            checkpoint_every=1, checkpoint_path=snap, **sizes))
    finally:
        HotColdTier.spill = real
    print(f"  spills at waves {spilled}", flush=True)
    checker = model.checker().spawn_sortmerge(
        tier_hot_rows=TIER_HOT_2PC9, tier_max_runs=TIER_MAX_RUNS_2PC9,
        **sizes)
    run = _resumed(checker, snap)
    m = run["metrics"]
    _held_to_rm9(model, checker, run)
    assert m["cold_rows"] + m["hot_rows"] == run["unique"], m
    if tiered:
        assert m["tier_spills"] == tiered["metrics"]["tier_spills"], m
    run.update(killed=killed, spill_waves=spilled)
    tier_report(run, tiered)
    return run


@phase("hash 2pc rm=9 killed and resumed (main path)")
def hash_rm9_resumed(tmp: str):
    """``hash 2pc rm=9`` (paths on, 2^25 slots) with a snapshot every 8
    waves, killed at wave 15 and resumed: 10,340,352 with phase 4's
    ``states=``, depth and names; the table the resume builds holds the
    tag rule (``DeviceHashSet.from_keys``), and the insert kernel
    launches in the resumed run."""
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.ops.hashset import DeviceHashSet

    model = TwoPhaseSys(rm_count=9)
    snap = os.path.join(tmp, "hash9.ckpt")
    killed = _ckpt_kill(_hash(model, capacity=HASH_SLOTS,
                              checkpoint_every=CKPT_EVERY_HASH9,
                              checkpoint_path=snap), CKPT_KILL_HASH9)
    built = []
    real = DeviceHashSet.from_keys

    def from_keys(keys):
        table = real(keys)
        built.append(_tag_rule_holds(table))
        return table

    DeviceHashSet.from_keys = staticmethod(from_keys)
    try:
        checker = _hash(model, capacity=HASH_SLOTS)
        run = _resumed(checker, snap, kernels=HASH_KERNELS)
    finally:
        DeviceHashSet.from_keys = staticmethod(real)
    print(f"  restored table holds the tag rule: {built}", flush=True)
    assert built == [True], built
    assert run["unique"] == 10_340_352, run["unique"]
    assert (run["unique"], run["names"]) == HAND["2pc rm=9"], run
    assert (run["states"], run["depth"]) == (
        HAND["2pc rm=9 states"], HAND["2pc rm=9 depth"]), run
    for name, path in checker.discoveries().items():
        assert _replays(model, path, model.property_by_name(name)), name
    run["killed"] = killed
    return run


@phase("checkpoints, card vs CPU")
def ckpt_card_vs_cpu(tmp: str):
    """``2pc rm=5`` with paths killed at wave 7 on the card and on the
    CPU: the two snapshots hold equal buffers; the card's resumes on the
    CPU and the CPU's on the card, each to the uninterrupted run's
    counts, fingerprints and paths."""
    import numpy as np

    from stateright_tpu_torch.checkpoint import load_snapshot
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    model = TwoPhaseSys(rm_count=5)

    def spawn(device, **kw):
        return model.checker().spawn_sortmerge(
            capacity=1 << 15, frontier_capacity=1 << 13, device=device, **kw)

    base = spawn("cpu").join()
    snaps = {}
    for device in ("cuda", "cpu"):
        snaps[device] = os.path.join(tmp, f"rm5_{device}.ckpt")
        _ckpt_kill(spawn(device, checkpoint_every=1,
                         checkpoint_path=snaps[device]), 7)
    a, b = (load_snapshot(snaps[d])[1] for d in ("cuda", "cpu"))
    assert sorted(a) == sorted(b), (sorted(a), sorted(b))
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    for src, dst in (("cuda", "cpu"), ("cpu", "cuda")):
        c = spawn(dst)
        c.resume_from(snaps[src])
        c.join()
        print(f"  {src} snapshot on {dst}: states={c.state_count()} "
              f"unique={c.unique_state_count()} depth={c.max_depth()}",
              flush=True)
        assert (c.unique_state_count(), c.state_count(), c.max_depth(),
                c.discovery_fingerprints()) == (
            base.unique_state_count(), base.state_count(),
            base.max_depth(), base.discovery_fingerprints()), (src, dst)
        for name, path in c.discoveries().items():
            assert path.encode() == base.discovery(name).encode(), name
            assert _replays(model, path, model.property_by_name(name)), name
    assert base.unique_state_count() == 8832


@phase("2pc check-gpu 9 killed by STPU_FAULTS, then --resume")
def rm9_cli_kill(kill_wave: int, tmp: str):
    """The CLI in a process of its own, killed by ``STPU_FAULTS`` at a
    snapshot wave's boundary (exit 137), then ``--resume`` in another:
    10,340,352."""
    snap = os.path.join(tmp, "cli.ckpt")
    args = [sys.executable, "-m", "stateright_tpu_torch", "2pc",
            "check-gpu", "9", f"--checkpoint-every={CKPT_EVERY_2PC9}",
            f"--checkpoint-path={snap}"]
    env = dict(os.environ, STPU_FAULTS=f"kill@chunk_boundary:{kill_wave}")
    t0 = time.monotonic()
    p = subprocess.run(args, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    print(f"  killed process: exit {p.returncode} in "
          f"{time.monotonic() - t0:.3f}s", flush=True)
    assert p.returncode == 137, (p.returncode, p.stderr[-2000:])
    env.pop("STPU_FAULTS")
    t0 = time.monotonic()
    p = subprocess.run(args[:-2] + ["--resume", f"--checkpoint-path={snap}"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    lines = [ln for ln in p.stdout.splitlines()
             if ln.startswith(("resuming from", "Done."))]
    print(f"  resumed process: exit {p.returncode} in "
          f"{time.monotonic() - t0:.3f}s: {lines}", flush=True)
    assert p.returncode == 0, p.stderr[-2000:]
    assert lines and lines[0].startswith("resuming from"), lines
    assert any("unique=10340352," in ln for ln in lines), lines


def checkpoint_phases(resident, tiered) -> tuple:
    """Phase 24: ``(runs, hashes, others)`` of the checkpoint paths, their
    snapshots in a temporary directory deleted at the end."""
    with tempfile.TemporaryDirectory(prefix="stpu-torch-ckpt-") as tmp:
        main_run = rm9_resumed(resident, tmp) if resident else None
        runs = {"2pc rm=9 resumed": main_run}
        others = {"2pc rm=9 supervised recovery": rm9_recovery(tmp),
                  "2pc rm=9 --checkpoint-every=auto": rm9_auto(resident,
                                                               tmp),
                  "2pc rm=9 tiered resumed": rm9_tiered_resumed(tiered, tmp)}
        hashes = {"hash 2pc rm=9 resumed": hash_rm9_resumed(tmp)}
        ckpt_card_vs_cpu(tmp)
        if main_run:
            rm9_cli_kill(main_run["kill_wave"], tmp)
        else:
            FAILED.append("2pc check-gpu 9 killed by STPU_FAULTS, then "
                          "--resume")
    return runs, hashes, others


# -- phase 25: the sharded engines on one card --------------------------------

#: shards of the sharded main paths, all on the card (``["cuda:0"] * S``)
SHARDS = 4
#: waves between two snapshots of the sharded 2pc rm=9 durability run
CKPT_EVERY_MESH9 = 4


def _on_card(S: int) -> list:
    return ["cuda:0"] * S


def peer_access_line() -> str:
    """Whether each pair of cards reaches the other's memory directly
    (the exchange copies card to card); one card has no pair."""
    import torch

    n = torch.cuda.device_count()
    if n < 2:
        return "peer access: one card, no pair"
    pairs = {f"{a}->{b}": torch.cuda.can_device_access_peer(a, b)
             for a in range(n) for b in range(n) if a != b}
    return f"peer access: {pairs}"


def _mesh_report(run: dict, one: dict | None) -> None:
    """The sharded run's per-shard unique counts, rows routed off-shard
    and Merge Path launches, and ``sec=`` and peak memory beside the
    one-device run's."""
    m = run["metrics"]
    print(f"  shards={m['n_shards']} shard_unique={m['shard_unique']} "
          f"routed_off_shard={m['shuffle_volume']} launches="
          f"{run['launches']}", flush=True)
    if one:
        print(f"  sec={run['sec']:.3f} against the one-device run's "
              f"{one['sec']:.3f}; peak_mem_bytes {run['peak_mem_bytes']} "
              f"against {one['peak_mem_bytes']}", flush=True)


@phase("2pc rm=9 sharded, S=4 on one card (main path)")
def rm9_sharded(one: dict | None):
    """``spawn_sharded_sortmerge`` at 2pc rm=9 with paths, four shards on
    the card, each a quarter of the CLI's capacities: phase 4's counts,
    depth and names (the lowest hitting shard wins, so the discovery
    fingerprints may differ, as in JAX's test), each discovery's state
    meeting its property."""
    from stateright_tpu_torch.cli import twopc_sizes
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.stage_profile import sharded_sizes

    model = TwoPhaseSys(rm_count=9)
    checker = model.checker().spawn_sharded_sortmerge(
        devices=_on_card(SHARDS), **sharded_sizes(twopc_sizes(9), SHARDS))
    run = run_main(checker, print_lines=1)
    _mesh_report(run, one)
    assert (run["unique"], run["states"], run["depth"]) == (
        10_340_352, 123_558_402, 29), run
    assert "2pc rm=9" in HAND, "the one-device 2pc rm=9 phase did not pass"
    assert (run["unique"], run["names"]) == HAND["2pc rm=9"], run
    assert sum(run["metrics"]["shard_unique"]) == run["unique"]
    assert run["metrics"]["shuffle_volume"] > 0
    for name, path in checker.discoveries().items():
        assert _replays(model, path, model.property_by_name(name)), name
    HAND["2pc rm=9 sharded"] = run
    return run


@phase("paxos check 4 sharded, S=4 on one card (main path)")
def paxos4_sharded(one: dict | None):
    """``paxos check 4`` through ``spawn_sharded_sortmerge``, four shards
    on the card, paths off as the CLI runs it: 2,372,188 and phase 6's
    names."""
    from stateright_tpu_torch.models.paxos import PaxosModelCfg, paxos_model
    from stateright_tpu_torch.models.paxos_tpu import STRUCTURAL_SIZES
    from stateright_tpu_torch.stage_profile import sharded_sizes

    model = paxos_model(PaxosModelCfg(client_count=4, server_count=3))
    checker = model.checker().spawn_sharded_sortmerge(
        devices=_on_card(SHARDS), track_paths=False,
        **sharded_sizes(STRUCTURAL_SIZES[4], SHARDS))
    run = run_main(checker)
    _mesh_report(run, one)
    assert run["unique"] == 2_372_188, run["unique"]
    assert run["names"] == {"value chosen"}, run["names"]
    return run


@phase("2pc rm=5 sharded S=2, card vs CPU")
def rm5_sharded_card_vs_cpu():
    """``2pc rm=5`` with paths at S = 2 on the card and on the CPU: each
    shard's visited keys, the discovery fingerprints and the paths
    equal, every path replayed."""
    import torch

    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    model = TwoPhaseSys(rm_count=5)
    sizes = dict(capacity=1 << 14, frontier_capacity=1 << 12)
    gpu = model.checker().spawn_sharded_sortmerge(devices=_on_card(2),
                                                  **sizes)
    run = run_main(gpu, print_lines=1)
    cpu = model.checker().spawn_sharded_sortmerge(devices=["cpu"] * 2,
                                                  **sizes).join()
    assert run["unique"] == 8832, run["unique"]
    assert (run["states"], run["depth"], run["fps"]) == (
        cpu.state_count(), cpu.max_depth(), cpu.discovery_fingerprints())
    for a, b in zip(gpu._final.shards, cpu._final.shards):
        assert torch.equal(a.vkeys.cpu(), b.vkeys), "visited keys differ"
    for name, path in gpu.discoveries().items():
        assert path.encode() == cpu.discovery(name).encode(), name
        assert _replays(model, path, model.property_by_name(name)), name
    print(f"  shard_unique={run['metrics']['shard_unique']} equal on both",
          flush=True)
    return run


@phase("hash 2pc rm=9 sharded, S=2 on one card")
def hash_rm9_sharded(one: dict | None):
    """``spawn_sharded_hash`` at 2pc rm=9 with paths, two shards of 2^24
    slots on the card: 10,340,352 with phase 4's ``states=``, depth and
    names, the insert kernel launched."""
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    model = TwoPhaseSys(rm_count=9)
    checker = model.checker().spawn_sharded_hash(
        devices=_on_card(2), capacity=HASH_SLOTS // 2)
    run = run_main(checker, print_lines=1, kernels=HASH_KERNELS)
    _mesh_report(run, one)
    assert run["unique"] == 10_340_352, run["unique"]
    assert "2pc rm=9" in HAND, "the one-device 2pc rm=9 phase did not pass"
    assert (run["states"], run["depth"], run["names"]) == (
        HAND["2pc rm=9 states"], HAND["2pc rm=9 depth"],
        HAND["2pc rm=9"][1]), run
    for name, path in checker.discoveries().items():
        assert _replays(model, path, model.property_by_name(name)), name
    return run


def _held_to_mesh9(model, checker, run: dict) -> None:
    """A 2pc rm=9 run's counts, depth and names equal the sharded main
    path's, and its paths replay."""
    mesh = HAND.get("2pc rm=9 sharded")
    assert mesh, "the sharded 2pc rm=9 phase did not pass"
    assert (run["unique"], run["states"], run["depth"], run["names"]) == (
        mesh["unique"], mesh["states"], mesh["depth"], mesh["names"]), run
    for name, path in checker.discoveries().items():
        assert _replays(model, path, model.property_by_name(name)), name


@phase("2pc rm=9 S=4 killed, resumed at S=2 and on one device")
def rm9_mesh_resumed(mesh: dict, tmp: str) -> dict:
    """The durability half of the JAX package's ``dryrun_multichip``:
    ``2pc rm=9`` at S = 4 with a snapshot every 4 waves, killed at the
    first snapshot wave past its widest wave, resumed at S = 2 and on
    the one-device engine (each a re-shard through the (owner, fp)
    route) to the sharded run's counts, depth and names."""
    from stateright_tpu_torch.cli import twopc_sizes
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.stage_profile import sharded_sizes

    model = TwoPhaseSys(rm_count=9)
    widest = mesh["metrics"]["widest_wave"]
    kill = next(w for w in range(CKPT_EVERY_MESH9 - 1, 1 << 20,
                                 CKPT_EVERY_MESH9) if w > widest)
    print(f"  widest wave {widest}, killed at wave {kill}", flush=True)
    snap = os.path.join(tmp, "mesh9.ckpt")
    killed = _ckpt_kill(model.checker().spawn_sharded_sortmerge(
        devices=_on_card(SHARDS), checkpoint_every=CKPT_EVERY_MESH9,
        checkpoint_path=snap, **sharded_sizes(twopc_sizes(9), SHARDS)),
        kill)
    runs = {"killed": killed}
    for label, checker in (
            ("S=2", model.checker().spawn_sharded_sortmerge(
                devices=_on_card(2), **sharded_sizes(twopc_sizes(9), 2))),
            ("one device", model.checker().spawn_sortmerge(
                **twopc_sizes(9)))):
        run = _resumed(checker, snap)
        assert run["resume"]["wave"] == kill + 1, run["resume"]
        _held_to_mesh9(model, checker, run)
        print(f"  resumed {label}: sec={run['sec']:.3f} peak_mem_bytes "
              f"{run['peak_mem_bytes']}", flush=True)
        runs[label] = run
    return runs


@phase("2pc rm=5 S=4 persistent shard fault, degraded to S=3")
def rm5_mesh_degrade(tmp: str) -> dict:
    """A persistent fault on shard 1 of ``2pc rm=5`` at S = 4, a snapshot
    every wave, under ``degrade_on_fault``: the shard is dropped, the
    snapshot re-shards onto the other three, and the run finishes there
    with 8,832 (one ``DEGRADING`` warning)."""
    from stateright_tpu_torch import faultinject
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    model = TwoPhaseSys(rm_count=5)
    checker = model.checker().spawn_sharded_sortmerge(
        devices=_on_card(SHARDS), capacity=1 << 13, frontier_capacity=1 << 11,
        checkpoint_every=1, checkpoint_path=os.path.join(tmp, "deg.ckpt"))
    checker.degrade_on_fault = True
    checker.retry_backoff_sec = 0.01
    faultinject.arm("shard_fault", "mid_chunk", 3, shard=1)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run = run_main(checker, print_lines=1)
    finally:
        faultinject.disarm_all()
    deg = [str(w.message) for w in caught if "DEGRADING" in str(w.message)]
    print(f"  {deg}", flush=True)
    assert len(deg) == 1 and "(4 -> 3 shards)" in deg[0], deg
    assert (checker.n_shards, checker._shard_ids) == (3, (0, 2, 3))
    assert run["unique"] == 8832, run["unique"]
    for name, path in checker.discoveries().items():
        assert _replays(model, path, model.property_by_name(name)), name
    return run


def sharded_phases(one_rm9, one_paxos4) -> tuple:
    """Phase 25: ``(runs, hashes, others)`` of the sharded engines on the
    card, the snapshots in a temporary directory deleted at the end."""
    print(peer_access_line(), flush=True)
    runs = {"2pc rm=9 sharded S=4": rm9_sharded(one_rm9),
            "paxos 4c sharded S=4": paxos4_sharded(one_paxos4),
            "2pc rm=5 sharded S=2": rm5_sharded_card_vs_cpu()}
    hashes = {"hash 2pc rm=9 sharded S=2": hash_rm9_sharded(one_rm9)}
    others = {}
    with tempfile.TemporaryDirectory(prefix="stpu-torch-mesh-") as tmp:
        mesh = runs["2pc rm=9 sharded S=4"]
        resumed = rm9_mesh_resumed(mesh, tmp) if mesh else None
        if resumed:
            runs["2pc rm=9 S=4 resumed at S=2"] = resumed["S=2"]
            runs["2pc rm=9 S=4 resumed on one device"] = resumed["one device"]
        else:
            FAILED.append("2pc rm=9 S=4 killed, resumed at S=2 and on one "
                          "device")
        others["2pc rm=5 S=4 degraded to S=3"] = rm5_mesh_degrade(tmp)
    return runs, hashes, others


# -- phase 26: traced runs (telemetry.py) -------------------------------------

#: repetitions of each trace level in the overhead measurement (the
#: untraced walls of one call spread by a quarter, so even seven runs a
#: level left the overhead unresolved; three keep the script in its
#: time limit)
TRACE_REPS = 3
#: the straggler factor of the traced S = 4 run
STRAGGLER_FACTOR = 4.0


def _traced(checker, level, print_lines=None, kernels=MERGE_KERNELS):
    """``(run, events)``: ``checker`` through ``run_main`` under a tracer
    at ``level`` (None: untraced, no events), each trace validated."""
    from stateright_tpu_torch import telemetry

    if level is None:
        return run_main(checker, print_lines, kernels), None
    tr = telemetry.RunTracer(level=level)
    with tr.activate():
        run = run_main(checker, print_lines, kernels)
    telemetry.validate_events(tr.events)
    return run, tr.events


def _same_launches(label: str, run: dict, twin: dict | None) -> None:
    """A traced run launched each kernel as many times as its untraced
    twin."""
    assert twin is not None, f"{label}: the untraced twin did not pass"
    assert run["launches"] == twin["launches"], (
        label, run["launches"], twin["launches"])


def _event_counts(events) -> dict:
    from collections import Counter

    return dict(sorted(Counter(e["ev"] for e in events).items()))


def _profile_line(events) -> str:
    """The run's ``latency_profile``: time to first wave, the dispatch and
    fetch shares, and the compile attribution."""
    prof = next(e for e in events if e["ev"] == "latency_profile")
    keys = ("run_wall_sec", "time_to_first_wave_sec", "dispatch_sec",
            "fetch_sec", "device_sec", "dispatch_share", "sync_share",
            "interchunk_sec", "compile")
    return json.dumps({k: prof.get(k) for k in keys})


def _levels(make, twin: dict, held, kernels=MERGE_KERNELS) -> dict:
    """``make()``'s checker run untraced, traced (default) and traced
    (deep), ``TRACE_REPS`` times each, interleaved in a rotating order:
    the median ``sec=``
    of each level, the traced overheads, each traced run's event counts
    and latency profile, each run held by ``held(run)`` and to ``twin``'s
    launches."""
    import statistics

    secs = {None: [], "default": [], "deep": []}
    order = list(secs)
    last = {}
    for rep in range(TRACE_REPS):
        # each rep starts with another level, so no level always runs
        # first
        for level in order[rep % 3:] + order[:rep % 3]:
            run, events = _traced(make(), level, print_lines=0,
                                  kernels=kernels)
            held(run)
            _same_launches(f"{level} trace", run, twin)
            secs[level].append(run["sec"])
            last[level] = (run, events)
    med = {level: statistics.median(v) for level, v in secs.items()}
    out = dict(untraced=last[None][0])
    for level in ("default", "deep"):
        run, events = last[level]
        over = 100.0 * (med[level] / med[None] - 1.0)
        print(f"  {level}: median sec={med[level]:.4f} against untraced "
              f"{med[None]:.4f} ({over:+.2f}%), all {secs[level]} "
              f"against {secs[None]}", flush=True)
        print(f"  {level} events: {_event_counts(events)}", flush=True)
        print(f"  {level} latency_profile: {_profile_line(events)}",
              flush=True)
        out[level] = run
        out[f"{level}_overhead_pct"] = over
    return out


@phase("2pc rm=9 traced: untraced, default, deep (main path)")
def rm9_traced(one: dict | None):
    """``2pc check-gpu 9``'s checker untraced, traced and traced deep,
    ``TRACE_REPS`` times each: phase 4's counts and names every time,
    phase 4's launches, the median ``sec=`` and the overheads."""
    import torch

    from stateright_tpu_torch.cli import twopc_sizes
    from stateright_tpu_torch.memplan import device_bytes_in_use
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    # the traced runs' memory poll reads what memory_allocated returns
    dev = torch.device("cuda")
    assert device_bytes_in_use(dev) == (torch.cuda.memory_allocated(dev),
                                        "memory_stats")
    model = TwoPhaseSys(rm_count=9)

    def held(run):
        assert (run["unique"], run["names"]) == HAND["2pc rm=9"], run
        assert (run["states"], run["depth"]) == (
            HAND["2pc rm=9 states"], HAND["2pc rm=9 depth"]), run

    return _levels(lambda: model.checker().spawn_sortmerge(**twopc_sizes(9)),
                   one, held)


@phase("paxos check 4 traced: untraced, default, deep (main path)")
def paxos4_traced(one: dict | None):
    """``paxos check-gpu 4``'s checker at each level, ``TRACE_REPS``
    times each: phase 6's counts, names and launches."""
    from stateright_tpu_torch.cli import paxos_checker

    def held(run):
        assert run["unique"] == 2_372_188 and run["names"] == {
            "value chosen"}, run

    return _levels(lambda: paxos_checker(4), one, held)


@phase("paxos check-gpu 4 --trace (the CLI)")
def paxos4_cli_traced(one: dict | None, tmp: str):
    """The CLI lane in this process with ``--trace``: its report, a trace
    pair in a temporary directory that validates, "value chosen", and
    phase 6's launches."""
    import contextlib

    from stateright_tpu_torch import telemetry
    from stateright_tpu_torch.cli import main as cli_main

    out = io.StringIO()
    _zero_launches()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        cli_main(["paxos", "check-gpu", "4", "--trace",
                  f"--trace-root={tmp}"])
    sec = time.monotonic() - t0
    run = dict(launches=_read_launches(), sec=sec)
    text = out.getvalue()
    print(f"  {text.splitlines()[-2][:200]}", flush=True)
    assert "Done. states=" in text and "unique=2372188," in text, text[-500:]
    assert "value chosen" in text, text[-500:]
    events = telemetry.load_trace(os.path.join(tmp, "TRACE_r01.jsonl"))
    telemetry.validate_events(events)
    assert os.path.exists(os.path.join(tmp, "TRACE_r01.trace.json"))
    verdicts = {e["property"]: e["kind"] for e in events
                if e["ev"] == "verdict"}
    assert verdicts == {"value chosen": "discovery",
                        "linearizable": "exhaustion"}, verdicts
    _same_launches("paxos check-gpu 4 --trace", run, one)
    print(f"  wall {sec:.3f}s, events: {_event_counts(events)}", flush=True)
    return run


@phase("hash 2pc rm=9 traced")
def hash_rm9_traced(one: dict | None):
    """``spawn_hash`` at 2pc rm=9 traced: phase 22's counts and insert
    launches, one chunk event a wave (the hash engines keep no wave
    log)."""
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    model = TwoPhaseSys(rm_count=9)
    run, events = _traced(_hash(model, capacity=HASH_SLOTS), "default",
                          print_lines=0, kernels=HASH_KERNELS)
    assert (run["unique"], run["names"]) == HAND["2pc rm=9"], run
    _same_launches("hash 2pc rm=9 traced", run, one)
    counts = _event_counts(events)
    assert counts["chunk"] == run["metrics"]["waves"], counts
    print(f"  events: {counts}", flush=True)
    print(f"  latency_profile: {_profile_line(events)}", flush=True)
    return run


@phase("2pc rm=9 sharded S=4 traced, --straggler-factor")
def rm9_sharded_traced(one: dict | None):
    """The S = 4 run of phase 25 traced, the straggler detector armed:
    its counts and launches, a ``shard_wave`` row a (wave, shard), and
    the ``shard_balance`` summary."""
    from stateright_tpu_torch import telemetry
    from stateright_tpu_torch.cli import twopc_sizes
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys
    from stateright_tpu_torch.stage_profile import sharded_sizes

    model = TwoPhaseSys(rm_count=9)
    checker = model.checker().spawn_sharded_sortmerge(
        devices=_on_card(SHARDS), **sharded_sizes(twopc_sizes(9), SHARDS))
    checker.straggler_factor = STRAGGLER_FACTOR
    run, events = _traced(checker, "default", print_lines=0)
    assert (run["unique"], run["names"]) == HAND["2pc rm=9"], run
    _same_launches("2pc rm=9 S=4 traced", run, one)
    counts = _event_counts(events)
    assert counts["shard_wave"] == SHARDS * counts["wave"], counts
    bal = telemetry.shard_balance(events)
    keys = ("n_shards", "waves", "frontier_skew_worst",
            "frontier_skew_weighted", "candidate_skew_worst",
            "routed_rows_total", "recv_rows_total", "routed_bytes_total",
            "dest_fill_worst", "visited_per_shard", "visited_skew",
            "occupancy_max", "warnings")
    print(f"  shard_balance: {json.dumps({k: bal[k] for k in keys})}",
          flush=True)
    print(f"  events: {counts}", flush=True)
    assert bal["routed_rows_total"] == run["metrics"]["shuffle_volume"], bal
    # a balanced run: no occupancy, tile or imbalance warning
    assert not bal["warnings"], bal["warnings"]
    assert sum(bal["visited_per_shard"]) == run["unique"], bal
    return run


@phase("2pc rm=9 checkpointed, killed and resumed, traced")
def rm9_ckpt_traced(resumed: dict | None, tmp: str):
    """Phase 24's checkpointing run traced: one ``checkpoint`` event a
    snapshot written, then its resume traced (a ``restore`` event,
    phase 24's resumed launches), diffed against an uninterrupted traced
    run: no divergence."""
    from stateright_tpu_torch import faultinject, telemetry
    from stateright_tpu_torch.cli import twopc_sizes
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    assert resumed is not None, "phase 24's killed run did not pass"
    kill = resumed["kill_wave"]
    model = TwoPhaseSys(rm_count=9)
    snap = os.path.join(tmp, "traced.ckpt")
    killed = model.checker().spawn_sortmerge(
        checkpoint_every=CKPT_EVERY_2PC9, checkpoint_path=snap,
        **twopc_sizes(9))
    tr = telemetry.RunTracer()
    with tr.activate():
        _ckpt_kill(killed, kill)
    telemetry.validate_events(tr.events)
    written = killed._ckpt_stats["snapshots"]
    ckpts = [e for e in tr.events if e["ev"] == "checkpoint"]
    assert len(ckpts) == written, (len(ckpts), written)
    assert tr.events[-1]["ev"] == "run_end" and tr.events[-1]["error"]
    checker = model.checker().spawn_sortmerge(**twopc_sizes(9))
    checker.resume_from(snap)
    run, events = _traced(checker, "default", print_lines=0)
    _same_launches("2pc rm=9 resumed traced", run, resumed)
    restore = [e for e in events if e["ev"] == "restore"]
    assert len(restore) == 1 and restore[0]["wave"] == kill + 1, restore
    _, full = _traced(model.checker().spawn_sortmerge(**twopc_sizes(9)),
                      "default", print_lines=0)
    rep = telemetry.diff_traces(full, events)
    assert rep["divergences"] == [] and rep["resume_wave_b"] == kill + 1, rep
    print(f"  {written} snapshots, {len(ckpts)} checkpoint events "
          f"({[e['snapshot_bytes'] for e in ckpts]} bytes); resumed at wave "
          f"{kill + 1}, no divergence against the uninterrupted trace",
          flush=True)
    return run


@phase("2pc check-gpu 9 --trace=deep in a process of its own")
def rm9_cli_traced_process(tmp: str):
    """The CLI in a fresh process (the kernels' libraries on disk from the
    build phase): its ``program_build`` events' tiers and walls, its
    compile spans and its trace's latency profile."""
    from stateright_tpu_torch import telemetry

    root = os.path.join(tmp, "process")
    os.makedirs(root)
    t0 = time.monotonic()
    p = subprocess.run(
        [sys.executable, "-m", "stateright_tpu_torch", "2pc", "check-gpu",
         "9", "--trace=deep", f"--trace-root={root}"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    print(f"  exit {p.returncode} in {time.monotonic() - t0:.3f}s", flush=True)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "unique=10340352," in p.stdout, p.stdout[-500:]
    events = telemetry.load_trace(os.path.join(root, "TRACE_r01.jsonl"))
    telemetry.validate_events(events)
    builds = [{k: e.get(k) for k in ("program", "tier", "wall_sec")}
              for e in events if e["ev"] == "program_build"]
    compiles = [e["dur"] for e in events
                if e["ev"] == "span" and e["phase"] == "compile"]
    print(f"  program_build: {builds}; compile spans {compiles}", flush=True)
    print(f"  latency_profile: {_profile_line(events)}", flush=True)
    HAND["fresh process ttfw"] = next(
        e for e in events
        if e["ev"] == "latency_profile")["time_to_first_wave_sec"]
    assert any(b["program"] == "merge_path" for b in builds), builds
    assert all(b["tier"] in ("disk", "in_process", "cold") for b in builds)


def traced_phases(runs: dict, hashes: dict) -> dict:
    """Phase 26: the traced runs, each held to its untraced twin; the
    traces in a temporary directory deleted at the end."""
    from stateright_tpu_torch.ops import cuda_build

    print(f"  this process's kernel builds (tier cold where nvcc ran): "
          f"{cuda_build.BUILD_SECONDS}", flush=True)
    out = {}
    rm9 = rm9_traced(runs.get("2pc rm=9"))
    pax = paxos4_traced(runs.get("paxos 4c"))
    for label, levels in (("2pc rm=9", rm9), ("paxos 4c", pax)):
        if levels:
            out[f"{label} traced"] = levels["default"]
            out[f"{label} traced deep"] = levels["deep"]
        else:
            FAILED.append(f"{label} traced")
    with tempfile.TemporaryDirectory(prefix="stpu-torch-trace-") as tmp:
        out["paxos check-gpu 4 --trace"] = paxos4_cli_traced(
            runs.get("paxos 4c"), tmp)
        out["hash 2pc rm=9 traced"] = hash_rm9_traced(
            hashes.get("hash 2pc rm=9"))
        out["2pc rm=9 sharded S=4 traced"] = rm9_sharded_traced(
            runs.get("2pc rm=9 sharded S=4"))
        out["2pc rm=9 resumed traced"] = rm9_ckpt_traced(
            runs.get("2pc rm=9 resumed"), tmp)
        rm9_cli_traced_process(tmp)
    return out


# -- phase 27: batching and the metrics plane (batch.py, metrics.py) ---------

#: the 2pc lanes of the fused main path and each one's solo unique count
BATCH_LANES = {7: 296_448, 8: 1_745_408, 9: 10_340_352}


def _lane_checker(n: int, device: str = "cuda"):
    """The checker ``2pc check-gpu n`` runs (the sort-merge engine)."""
    from stateright_tpu_torch.cli import twopc_sizes
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    return TwoPhaseSys(rm_count=n).checker().spawn_sortmerge(
        device=device, **twopc_sizes(n))


def _run_seats(checkers, **kw) -> dict:
    """Seat ``checkers`` in batch groups of their classes
    (``batch.seat_sessions``) and join each on a thread of its own under
    a tracer of its own, as a service runs its sessions. Returns the
    seats, the tracers, the fallback reasons the seats gave, the wall
    from the threads' start to the last join (ending in
    ``torch.cuda.synchronize()``) and the launches in it (counts zeroed
    just before the threads start)."""
    import threading

    import torch

    from stateright_tpu_torch import telemetry
    from stateright_tpu_torch.batch import seat_sessions

    notes: list = []
    seats = seat_sessions(checkers, notify=notes.append, **kw)
    tracers = [telemetry.RunTracer() for _ in checkers]
    errors: list = []

    done_at = [None] * len(checkers)

    def run(k, c, tr):
        try:
            with tr.activate_thread():
                c.join()
            done_at[k] = time.monotonic()
        except Exception as exc:  # raised again below, on the phase
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(k, c, tr))
               for k, (c, tr) in enumerate(zip(checkers, tracers))]
    _zero_launches()
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive(), "a seat's thread did not finish"
    if errors:
        raise errors[0]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    for note in notes:
        print(f"  {note}", flush=True)
    for tr in tracers:
        telemetry.validate_events(tr.events)
    return dict(seats=seats, tracers=tracers, notes=notes, wall=wall,
                launches=_read_launches(),
                seat_secs=[d - t0 for d in done_at])


def _wave_counters(events) -> list:
    """Each wave's ``DIFF_COUNTERS`` of a trace."""
    from stateright_tpu_torch.telemetry import DIFF_COUNTERS

    return [[e[k] for k in DIFF_COUNTERS] for e in events
            if e["ev"] == "wave"]


@phase("batch 2pc rm=7+8+9 fused (main path)")
def batch_main():
    """The ``2pc check-gpu 7/8/9`` lanes' checkers in one
    ``BatchGroup(max_sessions=3)`` on three threads: one fused hash-engine
    run over a 2^28-slot table. Each seat gives its solo count, none
    falls back, they peel rm=7, rm=8, rm=9, each seat's trace validates
    and diffs against that lane's solo traced run with no counter
    divergence, and the insert launches once a fused wave (and once for
    the init states). Prints the fused wall against the sum of the three
    solo hash-engine walls (each at its lane's capacity), peak memory,
    and the fused run's idle share from ``stage_profile --batch``."""
    import torch

    run = _batch_main_run()
    torch.cuda.empty_cache()  # the fused table went with the run's locals
    p = subprocess.run(
        [sys.executable, "-m", "stateright_tpu_torch.stage_profile",
         "--batch", *map(str, BATCH_LANES)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    prof = json.loads(p.stdout)
    print(f"  stage_profile --batch: wall {prof['wall_s']:.4f}s, traced "
          f"{prof['traced_wall_s']:.4f}s, device busy "
          f"{prof['device_busy_ms']:.2f} ms, idle "
          f"{prof['idle_share_of_traced_wall']:.4f}, insert share "
          f"{prof['hash_insert_share_of_device_time']:.4f}, stages "
          f"{json.dumps(prof['stages_ms'])}", flush=True)
    return run


#: repetitions of the solo hash runs and of the fused group in phase 27
BATCH_REPS = 2


def _batch_main_run() -> dict:
    """The runs of :func:`batch_main`, ``BATCH_REPS`` times each: the
    solo hash runs of the three lanes (interleaved), each lane's solo
    traced sort-merge run once, then the group (every repetition held to
    the same counts, order, traces and launches)."""
    import statistics

    import torch

    from stateright_tpu_torch import telemetry

    solo, solo_traces = {n: [] for n in BATCH_LANES}, {}
    for _ in range(BATCH_REPS):
        for n in BATCH_LANES:
            run = run_main(_hash(_models_2pc(n),
                                 capacity=_lane_checker(n).capacity),
                           print_lines=0, kernels=HASH_KERNELS)
            assert run["unique"] == BATCH_LANES[n], run["unique"]
            solo[n].append(run["sec"])
    for n in BATCH_LANES:
        run, solo_traces[n] = _traced(_lane_checker(n), "default",
                                      print_lines=0)
        assert run["unique"] == BATCH_LANES[n], run["unique"]
    walls, engine_walls, first = [], [], None
    for rep in range(BATCH_REPS):
        checkers = [_lane_checker(n) for n in BATCH_LANES]
        base = _mem_base()
        out = _run_seats(checkers, max_sessions=3, window_sec=30.0)
        peak = torch.cuda.max_memory_allocated() - base
        group = out["seats"][0][0].group
        fused = group.fused
        assert not out["notes"], out["notes"]
        assert fused is not None, "the group did not fuse"
        waves = fused.metrics["waves"]
        for (n, want), c, tr, m, sec in zip(
                BATCH_LANES.items(), checkers, out["tracers"],
                group.members, out["seat_secs"]):
            prof = [e for e in tr.events if e["ev"] == "latency_profile"][-1]
            spans = {e["phase"]: e["dur"] for e in tr.events
                     if e["ev"] == "span" and e["phase"].startswith("batch_")}
            print(f"  rep {rep} seat rm={n}: unique={c.unique_state_count()}"
                  f" states={c.state_count()} depth={c.max_depth()} "
                  f"waves={c.metrics['waves']} peeled after fused wave "
                  f"{m.payload['upto']}, verdicts at {sec:.4f}s, its share "
                  f"of the waves' walls {prof['dispatch_sec']:.4f} + "
                  f"{prof['fetch_sec']:.4f}s, the leader's walk of its "
                  f"paths {spans['batch_peel']:.4f}s, its replay "
                  f"{spans['batch_replay']:.4f}s", flush=True)
            assert c.unique_state_count() == want
            assert c.metrics["batch_size"] == 3, c.metrics
            rep_diff = telemetry.diff_traces(tr.events, solo_traces[n])
            assert rep_diff["divergences"] == [], rep_diff["divergences"][:5]
            assert c.discovered_property_names() == {"abort agreement",
                                                     "commit agreement"}
            for name, path in c.discoveries().items():
                assert _replays(c.model, path, c.model.property_by_name(name))
        assert group.settle_order == [0, 1, 2], group.settle_order
        # the init states' insert, then one a wave
        assert out["launches"]["hash_insert"] == waves + 1, (
            out["launches"], waves)
        assert out["launches"]["member_sorted"] == 0, out["launches"]
        walls.append(out["wall"])
        engine_walls.append(fused.duration_sec())
        if first is None:
            first = dict(launches=out["launches"],
                         metrics=dict(fused.metrics),
                         capacity=fused.capacity, peak_mem_bytes=peak)
            print(f"  fused run: capacity {fused.capacity}, launches "
                  f"{out['launches']}, peak memory {peak} B, metrics "
                  f"{fused.metrics}", flush=True)
    med = {n: statistics.median(v) for n, v in solo.items()}
    solo_sum = sum(med.values())
    wall = statistics.median(walls)
    print(f"  group wall (threads started to last verdict) median "
          f"{wall:.4f}s of {[round(w, 4) for w in walls]}, the fused "
          f"engine's own {[round(w, 4) for w in engine_walls]}; solo hash "
          f"walls median {[round(v, 4) for v in med.values()]} of "
          f"{ {n: [round(x, 4) for x in v] for n, v in solo.items()} }, "
          f"sum {solo_sum:.4f}s: group / sum = {wall / solo_sum:.3f}",
          flush=True)
    return dict(first, sec=wall, solo_sum_sec=solo_sum)


def _models_2pc(n: int):
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    return TwoPhaseSys(rm_count=n)


@phase("batch paxos 2c/3s x2 + 2pc rm=4 x2")
def batch_pairs():
    """JAX ``tests/test_serve.py:481`` without the service: two groups of
    two (16,668 and 1,568), each seat's trace naming only its own
    encoding; then the same batch with ``device="cpu"`` members, each
    seat's wave rows equal to the card's."""
    from stateright_tpu_torch.cli import paxos_checker

    rows = {}
    for device in ("cuda", "cpu"):
        checkers = [paxos_checker(2, device), paxos_checker(2, device),
                    _lane_checker(4, device), _lane_checker(4, device)]
        out = _run_seats(checkers, max_sessions=2, window_sec=30.0)
        assert not out["notes"], out["notes"]
        groups = [m.group for m, _ in out["seats"]]
        assert groups[0] is groups[1] and groups[2] is groups[3]
        assert groups[0] is not groups[2]
        for c, tr, want, enc in zip(
                checkers, out["tracers"], (16668, 16668, 1568, 1568),
                ["PaxosEncoded"] * 2 + ["TwoPhaseSysEncoded"] * 2):
            assert c.unique_state_count() == want
            assert c.metrics["batch_size"] == 2
            begins = [e for e in tr.events if e["ev"] == "run_begin"]
            assert [b["lane"]["encoding"] for b in begins] == [enc]
        rows[device] = [_wave_counters(tr.events) for tr in out["tracers"]]
        print(f"  {device}: wall {out['wall']:.4f}s, launches "
              f"{out['launches']}, seat waves "
              f"{[c.metrics['waves'] for c in checkers]}", flush=True)
        if device == "cuda":
            launches = out["launches"]
            assert launches["hash_insert"] > 0, launches
    assert rows["cuda"] == rows["cpu"], "card and CPU lane rows differ"
    return dict(launches=launches)


@phase("batch fallback")
def batch_fallback():
    """``increment 2`` and ``2pc rm=3`` land in different classes: each
    seat gives JAX's one-line reason and runs solo on the card, the 2pc
    seat's sort-merge run launching both Merge Path kernels (held to
    their plain versions at its shapes with the other runs)."""
    from stateright_tpu_torch.cli import increment_checker

    inc, twopc = increment_checker(2, False, "cuda"), _lane_checker(3)
    out = _run_seats([inc, twopc], max_sessions=2, window_sec=0.5)
    assert out["notes"] == [
        "batch: no compatible peers arrived within the batching window; "
        "running solo via the FIFO gate"] * 2, out["notes"]
    assert all(m.group.fused is None for m, _ in out["seats"])
    assert twopc.unique_state_count() == 288
    assert inc.discovered_property_names() == {"fin"}
    assert "batch_size" not in twopc.metrics
    print(f"  launches {out['launches']}; 2pc rm=3 metrics "
          f"{twopc.metrics}", flush=True)
    assert all(out["launches"][k] > 0 for k in MERGE_KERNELS), out
    return dict(launches=out["launches"], metrics=twopc.metrics)


def _sec_of(stdout: str) -> float:
    line = next(ln for ln in stdout.splitlines() if ln.startswith("Done."))
    return float(line.split("sec=")[1].split(",")[0].split()[0])


@phase("2pc check-gpu 9 --metrics-interval=0.5")
def metered_cli(tmp: str):
    """The CLI metered in a process of its own, twice, between two
    unmetered ones:
    the rollup loads through ``metrics.load_rollup``, its
    ``stpu_waves_total`` is the run's 29 waves and its
    ``stpu_new_states_total`` the unique states less the one initial
    state; both ``sec=`` printed."""
    from stateright_tpu_torch.metrics import load_rollup

    secs = {"unmetered": [], "metered": []}
    for k, label in enumerate(("unmetered", "metered", "metered",
                               "unmetered")):
        path = os.path.join(tmp, f"metrics{k}.jsonl")
        extra = ([] if label == "unmetered" else
                 ["--metrics-interval=0.5", f"--metrics-path={path}"])
        p = subprocess.run(
            [sys.executable, "-m", "stateright_tpu_torch", "2pc",
             "check-gpu", "9", *extra],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-2000:]
        assert "unique=10340352," in p.stdout, p.stdout[-500:]
        secs[label].append(_sec_of(p.stdout))
        if label == "metered":
            fams = load_rollup(path)["families"]
            with open(path) as fh:
                lines = sum(1 for _ in fh)

    def total(name):
        return sum(v["value"] for v in fams[name]["values"])

    print(f"  sec= metered {secs['metered']} against unmetered "
          f"{secs['unmetered']} (each in a fresh process, the card's "
          f"start in it); {lines} rollup lines; waves "
          f"{total('stpu_waves_total')}, new states "
          f"{total('stpu_new_states_total')}, chunks "
          f"{total('stpu_chunks_total')}", flush=True)
    assert total("stpu_waves_total") == 29
    assert total("stpu_new_states_total") == 10_340_352 - 1


def batch_phases() -> tuple:
    """Phase 27: ``(hash paths, launch-only paths)`` of the batch and
    metrics phases."""
    hashes = {"batch 2pc rm=7+8+9 fused": batch_main()}
    extra = {"batch paxos 2c/3s x2 + 2pc rm=4 x2": batch_pairs()}
    runs = {"batch fallback 2pc rm=3": batch_fallback()}
    with tempfile.TemporaryDirectory(prefix="stpu-torch-metrics-") as tmp:
        metered_cli(tmp)
    return runs, hashes, extra


# -- phase 28: the resident service (serve.py) -------------------------------

#: seconds any one request, thread or process of phase 28 may take
SERVE_TIMEOUT = 600
#: the lanes of the concurrent sessions and what each must report
SERVE_LANES = {("2pc", "check-gpu", "9"): ("2pc rm=9", 10_340_352),
               ("paxos", "check-gpu", "4"): ("paxos 4c", 2_372_188)}


def _http(port: int, path: str, body=None) -> dict:
    """``GET`` (or, with ``body``, ``POST`` of JSON) on the service at
    ``port``, bounded by ``SERVE_TIMEOUT``."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=SERVE_TIMEOUT) as r:
        raw = r.read()
    return json.loads(raw) if raw else {}


def _clients(port: int, lanes: list) -> list:
    """Each lane through ``client_main`` (``--connect``) on a thread of
    its own, all started together: ``[(exit code, report, seconds)]``,
    each report captured on its own thread."""
    import threading

    from stateright_tpu_torch.serve import _stdout_proxy, client_main

    out = [None] * len(lanes)

    def run(i, argv):
        proxy = _stdout_proxy()
        buf = io.StringIO()
        proxy.push(buf)
        t0 = time.monotonic()
        try:
            rc = client_main(f"127.0.0.1:{port}", list(argv),
                             timeout=SERVE_TIMEOUT)
        finally:
            proxy.pop()
        out[i] = (rc, buf.getvalue(), time.monotonic() - t0)

    threads = [threading.Thread(target=run, args=(i, a))
               for i, a in enumerate(lanes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=SERVE_TIMEOUT)
        assert not t.is_alive(), "a --connect client did not return"
    return out


def _done_fields(report: str) -> str:
    """The ``Done.`` line of a report, ``sec=`` cut."""
    line = next(ln for ln in report.splitlines() if ln.startswith("Done."))
    return line.split(", sec=")[0]


def _session_line(s) -> str:
    """One session's figures: time to verdict (the last verdict event
    after its run began), queue wait, warm or cold, the run's wall, the
    retention write and snapshot bytes, and its launches."""
    evs = s.tracer.events
    t_run = next(e["t"] for e in evs if e["ev"] == "run_begin")
    ttv = max((e["t"] - t_run for e in evs if e["ev"] == "verdict"),
              default=None)
    ttv_text = "none" if ttv is None else f"{ttv:.4f}s"
    retain = ("none" if s.retain_sec is None
              else f"{s.retain_sec:.4f}s for {s.snapshot_bytes} B")
    return (f"{' '.join(s.argv)}: {'warm' if s.warm_start else 'cold'}, "
            f"time to verdict {ttv_text}, queue wait "
            f"{s.gate_wait_sec:.4f}s, run {s.checker.duration_sec():.4f}s, "
            f"session {s.t_end - s.t_start:.4f}s, retention {retain}, "
            f"launches {s.launches}")


def _new_sessions(service, n_before: int) -> dict:
    """The check sessions submitted since the service held ``n_before``
    sessions, by argv (concurrent sessions register in any order)."""
    return {s.argv: s for s in service._sessions[n_before:]
            if s.kind == "check"}


def _serve_launches(s) -> dict:
    return {k: s.launches.get(k, 0) for k in (*MERGE_KERNELS,
                                              *HASH_KERNELS)}


@phase("resident service (main path)")
def serve_main(runs: dict, batched: dict | None, tmp: str) -> dict:
    """``CheckService(device="cuda")`` with its HTTP server on an
    ephemeral port: ``2pc check-gpu 9`` and ``paxos check-gpu 4`` as two
    concurrent ``--connect`` clients (phases 4 and 6's counts, each
    session's gate-held launches equal to its solo run's, the same
    widest kernel shapes); the ``2pc check-gpu 9`` re-check, a warm start
    with zero waves and equal report, its snapshot read inside its run
    and nothing written, and again with the warm start off; ``2pc
    check-gpu 7/8/9`` batched three to a group (each its solo count, the
    insert once a fused wave plus once); an admission refusal at a 1 KiB
    budget (no launch, no wave); the ``2pc,3`` Explorer mount
    (``/.status``, one ``/.states/...``, ``POST /.runtocompletion`` to
    288); and ``POST /.serve/trace`` (valid, with the serve summary
    printed)."""
    import threading

    import torch

    from stateright_tpu_torch import telemetry
    from stateright_tpu_torch.serve import (
        CheckService,
        explorer_builder,
        serve_summary,
    )

    service = CheckService(device="cuda",
                           spool_dir=os.path.join(tmp, "spool"),
                           batch_window_sec=30.0)
    service.mount_explorer(explorer_builder("2pc", 3), "2pc")
    server = service.http_server("127.0.0.1", 0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    paths: dict = {}
    try:
        base = _mem_base()
        _zero_launches()
        n0 = len(service._sessions)
        t0 = time.monotonic()
        outs = _clients(port, list(SERVE_LANES))
        wall = time.monotonic() - t0
        together = _read_launches()
        by_argv = _new_sessions(service, n0)
        sessions = [by_argv[argv] for argv in SERVE_LANES]
        for (argv, (label, want)), (rc, report, sec), s in zip(
                SERVE_LANES.items(), outs, sessions):
            solo = runs[label]
            assert rc == 0 and s.state == "done", (rc, s.error, report[-500:])
            assert f"unique={want}," in report, report[-500:]
            assert s.checker.state_count() == solo["states"]
            assert _serve_launches(s) == solo["launches"], (
                label, s.launches, solo["launches"])
            for k in ("member_shape", "merge_shape"):
                assert s.checker.metrics[k] == solo["metrics"][k], k
            print(f"  {_session_line(s)}; client {sec:.4f}s", flush=True)
            paths[f"serve {' '.join(argv)}"] = dict(
                launches=_serve_launches(s))
        assert together == {k: sum(runs[lab]["launches"][k]
                                   for lab, _ in SERVE_LANES.values())
                            for k in together}, together
        print(f"  concurrent: wall {wall:.4f}s against the solo runs' "
              f"sec= {runs['2pc rm=9']['sec']:.4f} + "
              f"{runs['paxos 4c']['sec']:.4f}; peak memory above the start "
              f"{torch.cuda.max_memory_allocated() - base} B", flush=True)

        cold = sessions[0]
        _zero_launches()
        (rc, report, sec), = _clients(port, [cold.argv])
        warm = service._sessions[-1]
        assert rc == 0 and warm.warm_start, (rc, warm.error)
        assert _done_fields(report) == _done_fields(outs[0][1])
        assert not [e for e in warm.tracer.events if e["ev"] == "wave"]
        assert warm.checker.discovery_fingerprints() == \
            cold.checker.discovery_fingerprints()
        # the read is inside the run (its time to verdict counts it), and
        # the warm session writes nothing
        t_run = next(e["t"] for e in warm.tracer.events
                     if e["ev"] == "run_begin")
        read, = [e for e in warm.tracer.events
                 if e["ev"] == "span" and e["phase"] == "restore_read"]
        assert read["t0"] >= t_run and warm.retain_sec is None, warm.retain_sec
        load = warm.checker._ckpt_stats
        print(f"  {_session_line(warm)}; client {sec:.4f}s; warm against "
              f"cold run {warm.checker.duration_sec():.4f}s / "
              f"{cold.checker.duration_sec():.4f}s, session "
              f"{warm.t_end - warm.t_start:.4f}s / "
              f"{cold.t_end - cold.t_start:.4f}s (restore_read span "
              f"{read['dur']:.4f}s: snapshot read "
              f"{load.get('resume_load_sec')}s; upload "
              f"{load.get('resume_upload_sec')}s)", flush=True)
        paths["serve 2pc check-gpu 9 (warm)"] = dict(
            launches=_read_launches())
        # the same re-check with the warm start off: a cold run in the
        # resident process, no snapshot read or written
        service.warm_start = False
        _zero_launches()
        (rc, report, sec), = _clients(port, [cold.argv])
        service.warm_start = True
        again = service._sessions[-1]
        assert rc == 0 and not again.warm_start, (rc, again.error)
        assert _done_fields(report) == _done_fields(outs[0][1])
        assert _serve_launches(again) == _serve_launches(cold)
        print(f"  {_session_line(again)}; client {sec:.4f}s (the warm start "
              f"off)", flush=True)
        paths["serve 2pc check-gpu 9 (no warm start)"] = dict(
            launches=_read_launches())

        # the batch: 2pc 9's snapshot would warm-start it solo, so
        # retention is off for the group
        service.warm_start, service.batch_sessions = False, 3
        _zero_launches()
        n0 = len(service._sessions)
        lanes = [("2pc", "check-gpu", str(n)) for n in BATCH_LANES]
        t0 = time.monotonic()
        outs = _clients(port, lanes)
        wall = time.monotonic() - t0
        service.warm_start, service.batch_sessions = True, None
        launches = _read_launches()
        by_argv = _new_sessions(service, n0)
        seats = [by_argv[argv] for argv in lanes]
        fused = seats[0]._group.fused
        for (n, want), (rc, report, sec), s in zip(BATCH_LANES.items(),
                                                   outs, seats):
            assert rc == 0 and s.state == "done", (rc, s.error)
            assert f"unique={want}," in report, report[-500:]
            assert s.batch["size"] == 3, s.batch
            print(f"  {_session_line(s)}; client {sec:.4f}s", flush=True)
        assert launches["hash_insert"] == fused.metrics["waves"] + 1, (
            launches, fused.metrics["waves"])
        solo_sum = (batched or {}).get("solo_sum_sec")
        print(f"  batch 2pc 7/8/9: wall {wall:.4f}s against phase 27's solo "
              f"hash runs' sum {solo_sum}; fused waves "
              f"{fused.metrics['waves']}, launches {launches}", flush=True)
        paths["serve batch 2pc 7+8+9"] = dict(launches=launches)

        service.device_budget_bytes = 1024
        _zero_launches()
        (rc, report, _), = _clients(port, [("2pc", "check-gpu", "5")])
        refused = service._sessions[-1]
        service.device_budget_bytes = None
        assert rc == 1 and refused.state == "refused", (rc, refused.state)
        assert "REFUSED: admission refused" in report
        assert _read_launches() == {k: 0 for k in launches}
        assert not [e for e in refused.tracer.events
                    if e["ev"] in ("chunk", "wave")]
        print(f"  refused: {refused.error[:160]}", flush=True)

        status = _http(port, "/.status")
        views = _http(port, "/.states/")
        step = _http(port, f"/.states/{views[0]['fingerprint']}")
        _http(port, "/.runtocompletion", body={})
        done = _http(port, "/.status")
        print(f"  explorer: {status['model']}, {len(views)} init and "
              f"{len(step)} next views, after run to completion "
              f"unique={done['unique_state_count']} done={done['done']}",
              flush=True)
        assert done["done"] and done["unique_state_count"] == 288

        os.environ["STPU_TORCH_ARTIFACT_ROOT"] = tmp
        try:
            written = _http(port, "/.serve/trace", body={})
        finally:
            del os.environ["STPU_TORCH_ARTIFACT_ROOT"]
        events = telemetry.load_trace(written["jsonl"])
        telemetry.validate_events(events)
        summary = serve_summary(events)
        for row in summary["sessions"]:
            print(f"  summary: {row['lane']} {row['state']} warm="
                  f"{row['warm_start']} ttv={row['time_to_verdict_sec']} "
                  f"ttfw={row['time_to_first_wave_sec']} queue="
                  f"{row['queue_wait_sec']} waves={row['waves']}",
                  flush=True)
    finally:
        server.shutdown()
        server.server_close()
    return paths


@phase("serve and --connect in processes of their own")
def serve_processes(tmp: str) -> dict:
    """``python -m stateright_tpu_torch serve 127.0.0.1:PORT`` on the
    card, and ``--connect=127.0.0.1:PORT 2pc check-gpu 9`` from two
    processes in turn: cold, then warm, both 10,340,352. The daemon's
    time to first wave against phase 26's fresh process's; the daemon
    is stopped whatever happens, and a terminated daemon exits 0 with
    its snapshot spool removed."""
    import socket

    from stateright_tpu_torch import telemetry
    from stateright_tpu_torch.serve import serve_summary

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.join(tmp, "daemon")
    daemon_tmp = os.path.join(tmp, "daemon_tmp")
    os.makedirs(root)
    os.makedirs(daemon_tmp)
    env = dict(os.environ, STPU_TORCH_ARTIFACT_ROOT=root, TMPDIR=daemon_tmp)
    log = open(os.path.join(tmp, "daemon.log"), "w+")
    t0 = time.monotonic()
    daemon = subprocess.Popen(
        [sys.executable, "-m", "stateright_tpu_torch", "serve",
         f"127.0.0.1:{port}"], cwd=ROOT, env=env, stdout=log,
        stderr=subprocess.STDOUT, text=True)
    try:
        while True:
            try:
                _http(port, "/.serve/sessions")
                break
            except OSError:
                assert daemon.poll() is None, "the daemon exited"
                assert time.monotonic() - t0 < 120, "the daemon never served"
                time.sleep(0.2)
        print(f"  daemon serving after {time.monotonic() - t0:.3f}s",
              flush=True)
        reports = []
        for _ in range(2):
            t1 = time.monotonic()
            p = subprocess.run(
                [sys.executable, "-m", "stateright_tpu_torch",
                 f"--connect=127.0.0.1:{port}", "2pc", "check-gpu", "9"],
                cwd=ROOT, capture_output=True, text=True,
                timeout=SERVE_TIMEOUT)
            assert p.returncode == 0, p.stderr[-2000:]
            assert "unique=10340352," in p.stdout, p.stdout[-500:]
            reports.append(p.stdout)
            print(f"  client process: exit 0 in {time.monotonic() - t1:.3f}s"
                  f", {_done_fields(p.stdout)} sec={_sec_of(p.stdout)}",
                  flush=True)
        assert _done_fields(reports[0]) == _done_fields(reports[1])
        sessions = _http(port, "/.serve/sessions")["sessions"]
        assert [s["warm_start"] for s in sessions] == [False, True]
        written = _http(port, "/.serve/trace", body={})
        events = telemetry.load_trace(written["jsonl"])
        telemetry.validate_events(events)
        rows = serve_summary(events)["sessions"]
        # the warm re-check ran no wave: its trace has no chunk
        assert rows[1]["warm_start"] and rows[1]["waves"] is None, rows[1]
        assert rows[0]["waves"] == 29, rows[0]
        for row in rows:
            print(f"  daemon session {row['session']}: warm="
                  f"{row['warm_start']} ttv={row['time_to_verdict_sec']} "
                  f"ttfw={row['time_to_first_wave_sec']} duration="
                  f"{row['duration_sec']} builds={row['builds']}",
                  flush=True)
        print(f"  daemon's cold time to first wave "
              f"{rows[0]['time_to_first_wave_sec']}s against phase 26's "
              f"fresh process {HAND.get('fresh process ttfw')}s", flush=True)
    finally:
        daemon.terminate()
        try:
            daemon.wait(timeout=30)
        except subprocess.TimeoutExpired:
            daemon.kill()
            daemon.wait(timeout=30)
        log.seek(0)
        tail = log.read()[-1500:]
        log.close()
        if tail.strip():
            print(f"  daemon output: {tail}", flush=True)
    left = os.listdir(daemon_tmp)
    print(f"  daemon exit {daemon.returncode}, left in its TMPDIR {left}",
          flush=True)
    assert daemon.returncode == 0 and not left, (daemon.returncode, left)
    return {}


def serve_phases(runs: dict, batched: dict | None) -> dict:
    """Phase 28: the service in this process, then in processes of its
    own; its files in a temporary directory deleted at the end."""
    with tempfile.TemporaryDirectory(prefix="stpu-torch-serve-") as tmp:
        paths = serve_main(runs, batched, tmp)
        serve_processes(tmp)
    if paths is None:
        FAILED.append("resident service paths")
    return paths or {}


# -- phase 29: the host layer and the compiled pinger -----------------------

#: the pinger's width: 3 servers, the CLI's default and timers.rs's
PINGER_SERVERS = 3
#: the depth at which the card is held to the port's host BFS: 5,323
#: unique states (the JAX host BFS's count too)
PINGER_BFS_DEPTH = 8
PINGER_BFS_UNIQUE = 5323
#: the depths the sort-merge engine runs, each with its unique states;
#: the last is the deepest both engines run. Memory bounds it, not time:
#: a sort-merge wave holds all its candidates at once (~360 B each), and
#: on an H100 80GB depth 24 peaks near 62 GB in about a second, where
#: depth 25 would need ~1.5 times that (PERF.md §6). These run one wave
#: a sync, the default: a chunk's wave holds its class, up to 1.25
#: times its candidates (checkers/chunk.py), and at N = 64 depth 23 ran
#: out of memory
PINGER_LADDER = {22: 25_726_524, 23: 40_167_523, 24: 61_872_524}
PINGER_DEPTH = max(PINGER_LADDER)
#: bounds of the sort-merge runs (the engine sizes each wave exactly;
#: these only bound it) and the hash engine's slots (2^28: a load of 0.23
#: at depth 24)
PINGER_SIZES = dict(capacity=1 << 30, frontier_capacity=1 << 28)
PINGER_SLOTS = 1 << 28


def _pinger(depth: int):
    """``(model, encoding)``: the pinger compiled for a run to ``depth``
    (models/timers.py ``pinger_compiled``), its host compile wall printed
    apart."""
    from stateright_tpu_torch.models.timers import (
        PingerModelCfg,
        pinger_compiled,
    )

    t0 = time.monotonic()
    model, enc = pinger_compiled(PingerModelCfg(PINGER_SERVERS), depth)
    print(f"  host compile {time.monotonic() - t0:.3f}s: width {enc.width} "
          f"lanes, {enc.max_actions} slots", flush=True)
    return model, enc


def _four_kernels(run: dict) -> dict:
    """The launches of the path's four CUDA kernels: the Merge Path pair
    (one a wrapper call) and the insert's two kernels (both in every
    ``hash_insert`` call)."""
    n = run["launches"]
    return {"member_tile_kernel": n["member_sorted"],
            "merge_tile_kernel": n["merge_sorted"],
            "probe_claim_kernel": n["hash_insert"],
            "winner_kernel": n["hash_insert"]}


def _pinger_line(label: str, run: dict) -> None:
    m = run["metrics"]
    print(f"  {label}: sec={run['sec']:.3f} unique={run['unique']} "
          f"states={run['states']} depth={run['depth']} "
          f"waves={m.get('waves')} kernels={_four_kernels(run)} widest "
          f"member={m.get('member_shape')} merge={m.get('merge_shape')} "
          f"insert={m.get('insert_shape')} "
          f"peak_mem_bytes={run['peak_mem_bytes']}", flush=True)


@phase("pinger depth 8, card vs host BFS")
def pinger_bfs() -> tuple:
    """The compiled pinger on both engines to depth 8, paths on, held to
    the port's host BFS of the same model: unique, states and depth."""
    D = PINGER_BFS_DEPTH
    model, enc = _pinger(D)
    sm = run_main(model.checker().target_max_depth(D).spawn_sortmerge(
        encoded=enc, capacity=1 << 16, frontier_capacity=1 << 14),
        print_lines=1)
    hs = run_main(model.checker().target_max_depth(D).spawn_hash(
        encoded=enc, capacity=1 << 16), print_lines=1, kernels=HASH_KERNELS)
    t0 = time.monotonic()
    host = model.checker().target_max_depth(D).spawn_bfs().join()
    print(f"  host bfs: states={host.state_count()} "
          f"unique={host.unique_state_count()} depth={host.max_depth()} "
          f"sec={time.monotonic() - t0:.3f}", flush=True)
    assert host.unique_state_count() == PINGER_BFS_UNIQUE
    for label, run in (("sort-merge", sm), ("hash", hs)):
        _pinger_line(label, run)
        assert (run["unique"], run["states"], run["depth"]) == (
            host.unique_state_count(), host.state_count(),
            host.max_depth()), (label, run["unique"])
    return sm, hs


@phase(f"pinger depth {PINGER_DEPTH}, sort-merge vs hash (main path)")
def pinger_deep() -> tuple:
    """The compiled pinger, paths off, on the sort-merge engine at each
    depth of the ladder, then on the hash engine at the deepest: the
    same unique count, states and depth. Each prints its wall and peak
    memory, so the ladder shows what bounds the depth."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"  device memory: {torch.cuda.memory_allocated()} B allocated, "
          f"{free} of {total} B free", flush=True)
    for D, unique in PINGER_LADDER.items():
        model, enc = _pinger(D)
        sm = run_main(model.checker().target_max_depth(D).spawn_sortmerge(
            encoded=enc, track_paths=False, **PINGER_SIZES), print_lines=1)
        _pinger_line(f"sort-merge depth {D}", sm)
        assert (sm["unique"], sm["depth"]) == (unique, D), sm["unique"]
        if D < PINGER_DEPTH:
            sm = None
            gc.collect()
            torch.cuda.empty_cache()
    hs = run_main(model.checker().target_max_depth(D).spawn_hash(
        encoded=enc, track_paths=False, capacity=PINGER_SLOTS),
        print_lines=1, kernels=HASH_KERNELS)
    _pinger_line(f"hash depth {D}", hs)
    assert (sm["unique"], sm["states"], sm["depth"]) == (
        hs["unique"], hs["states"], hs["depth"]), (sm["unique"], hs["unique"])
    return sm, hs


#: the host lanes phase 29 runs through the CLI, and the report line each
#: must print (the JAX lanes' counts)
HOST_LANES = (
    (["2pc", "check-sym", "5"], "Done. states=4091, unique=665, depth=17"),
    (["register", "check-sym", "3"], "Done. states=26, unique=13, depth=7"),
    (["interaction", "check", "12"], "Done. states=787, unique=368, depth=12"),
    (["panic", "check"], "Checker propagated the panic: panic!"),
)


@phase("host lanes through the CLI")
def host_lanes() -> None:
    """``check-sym``, ``interaction check`` and ``panic check`` through the
    CLI's ``main`` in this process (host-only lanes: no kernel runs)."""
    import contextlib

    from stateright_tpu_torch import cli

    for argv, want in HOST_LANES:
        out = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(out):
            cli.main(argv)
        text = out.getvalue()
        last = [line for line in text.splitlines()
                if line.startswith(("Done.", "Checker"))]
        print(f"  {' '.join(argv)}: {last[-1][:160] if last else text[:160]} "
              f"({time.monotonic() - t0:.3f}s)", flush=True)
        assert want in text, (argv, text[-400:])


def pinger_phases() -> tuple:
    """Phase 29: ``(runs, hashes)`` of the compiled pinger's paths, whose
    kernels join the checks at their widest waves; then the host lanes."""
    bfs = pinger_bfs() or (None, None)
    deep = pinger_deep() or (None, None)
    host_lanes()
    D = PINGER_DEPTH
    runs = {f"pinger depth {PINGER_BFS_DEPTH}": bfs[0],
            f"pinger depth {D}": deep[0]}
    hashes = {f"hash pinger depth {PINGER_BFS_DEPTH}": bfs[1],
              f"hash pinger depth {D}": deep[1]}
    return runs, hashes


# -- phases 32-33: the operator tools (stateright_tpu_torch/tools/) ---------

#: SLO_r01.json's spec, the gate of the sustained load test
LOADTEST_SLO = dict(max_ttv_p99_sec=120.0, max_refusal_rate=0.0,
                    max_queue_wait_p99_sec=120.0, min_cache_hit_rate=0.5)


def _tool_launches(fn):
    """``(fn(), launches)``: the kernel launches ``fn`` made in this
    process, the counts zeroed just before it and read just after."""
    import torch

    _zero_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, _read_launches()


@phase("crash matrix 2pc rm=9 (tools.crash_matrix)")
def crash_matrix_phase(tmp: str) -> dict:
    """Phase 32: every cell of the matrix at 2pc rm=9 on the card,
    ``--mesh-degrade`` and ``--trace``; returns the path's run and the
    CKPT document."""
    from stateright_tpu_torch.tools import crash_matrix

    args = crash_matrix.parse_args(
        ["--count", "9", "--waves-per-sync", "1", "--checkpoint-every",
         "4", "--trace", "--mesh-degrade", "--json", "--root", tmp])
    t0 = time.monotonic()
    (code, doc), launches = _tool_launches(
        lambda: crash_matrix.run_matrix(args))
    wall = time.monotonic() - t0
    assert code == 0 and doc["clean"], doc.get("cells")
    cells = doc["cells"]
    assert set(cells) == set(crash_matrix.CELLS) | {"mesh_degrade"}, cells
    want = HAND.get("2pc rm=9", (10_340_352,))[0]
    assert doc["baseline_unique"] == want == 10_340_352, doc
    for name, c in cells.items():
        assert c["verdict"] in crash_matrix.GOOD_VERDICTS, (name, c)
        n = c.get("resumed", c.get("count"))
        if name == "mesh_degrade":
            assert (n, c["to_shards"], c["counter_divergences"]) == (
                8_832, 7, 0), c
        elif n is not None:
            assert n == want, (name, c)
        print(f"  {name}: {c['verdict']} wall {c['wall_sec']:.3f}s",
              flush=True)
    assert cells["kill"]["kill_wave"] == 11, cells["kill"]
    assert cells["kill"]["trace_diff"]["counter_divergences"] == 0
    print(f"  snapshot bytes {doc['snapshot_bytes']:,} against the memory "
          f"plan's resident_bytes {doc['memplan_resident_bytes']:,}; the "
          f"matrix {wall:.3f}s; launches in this process {launches}",
          flush=True)
    assert launches["member_sorted"] > 0 and launches["merge_sorted"] > 0
    return dict(run=dict(launches=launches, sec=wall), doc=doc)


@phase("load test A/B 2pc check-gpu 9 (tools.serve_loadtest)")
def loadtest_ab(tmp: str) -> dict:
    """Phase 33, the A/B: 4 clients batched (the fused hash engine)
    against FIFO-serial (the sort-merge engine), every session
    10,340,352."""
    from stateright_tpu_torch.tools import serve_loadtest

    t0 = time.monotonic()
    (code, summary), launches = _tool_launches(
        lambda: serve_loadtest.run_ab(["2pc", "check-gpu", "9"], 4,
                                      json_out=True, root=tmp))
    wall = time.monotonic() - t0
    assert code == 0, "the A/B failed"
    for arm in (summary["sessions"], summary["fifo_baseline"]["sessions"]):
        assert [s["unique"] for s in arm] == [10_340_352] * 4, arm
    lt = summary["loadtest"]
    for label, arm in (("batched", serve_loadtest._arm_stats(summary)),
                       ("fifo", summary["fifo_baseline"])):
        rows = arm["sessions"]
        print(f"  {label}: " + ", ".join(
            f"#{r['session']} ttv {r['time_to_verdict_sec']:.4f}s "
            f"overhead {r['overhead_sec']:.4f}s" for r in rows), flush=True)
    print(f"  per-query dispatch+sync: batched "
          f"{lt['batched_per_query_overhead_sec']} s, fifo "
          f"{lt['fifo_per_query_overhead_sec']} s; the A/B {wall:.3f}s; "
          f"launches {launches}", flush=True)
    assert all(n > 0 for n in launches.values()), launches
    return dict(launches=launches, sec=wall)


@phase("load test --sustained 2pc check-gpu 9 (tools.serve_loadtest)")
def loadtest_sustained(tmp: str) -> dict:
    """Phase 33, sustained: ramp 2 / spike 4 / drain 2 over HTTP, every
    session 10,340,352, the SLO gate at ``SLO_r01.json``'s spec."""
    from stateright_tpu_torch.tools import serve_loadtest

    t0 = time.monotonic()
    (code, doc), launches = _tool_launches(
        lambda: serve_loadtest.run_sustained(
            ["2pc", "check-gpu", "9"],
            [("ramp", 2), ("spike", 4), ("drain", 2)], LOADTEST_SLO,
            json_out=True, root=tmp))
    wall = time.monotonic() - t0
    assert code == 0 and doc["evaluation"]["ok"], doc
    assert doc["solo_unique"] == 10_340_352, doc
    print(f"  observed {json.dumps(doc['observed'])}; the run {wall:.3f}s; "
          f"launches {launches}", flush=True)
    assert launches["member_sorted"] > 0 and launches["merge_sorted"] > 0
    return dict(run=dict(launches=launches, sec=wall), doc=doc)


@phase("the readers and trace_diff on phases 32-33's artifacts")
def tool_readers(matrix: dict | None, sustained: dict | None,
                 tmp: str) -> None:
    """Each reader and ``trace_diff`` on the artifacts of phases 32-33,
    each exiting 0; ``slo_report`` on a ``2pc check-gpu 9
    --metrics-interval`` rollup."""
    import contextlib

    from stateright_tpu_torch.cli import main as cli_main
    from stateright_tpu_torch.tools import latency_report, mem_report, \
        serve_report, shard_report, slo_report, trace_diff

    assert matrix and sustained, "phases 32-33 did not pass"
    kill = matrix["doc"]["cells"]["kill"]["trace_diff"]
    mesh = matrix["doc"]["mesh_degrade"]
    serve_trace = next(a for a in sustained["doc"]["artifacts"]
                       if a.endswith(".jsonl"))
    rollup = os.path.join(tmp, "m.jsonl")
    with contextlib.redirect_stdout(io.StringIO()):
        cli_main(["2pc", "check-gpu", "9", "--metrics-interval=60",
                  f"--metrics-path={rollup}"])

    def at(name):
        return os.path.join(tmp, name)

    calls = (
        (trace_diff, [at(kill["baseline"]), at(kill["resumed"])]),
        (trace_diff, [at(mesh["baseline_trace"]),
                      at(mesh["degraded_trace"])]),
        (latency_report, [at(kill["baseline"])]),
        (mem_report, [at(kill["resumed"])]),
        (shard_report, [at(mesh["degraded_trace"])]),
        (serve_report, [serve_trace]),
        (slo_report, ["--rollup", rollup, "--max-ttv-p99", "120"]),
    )
    for tool, argv in calls:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = tool.main(argv)
        name = tool.__name__.rsplit(".", 1)[-1]
        lines = out.getvalue().splitlines()
        print(f"  {name} {' '.join(os.path.basename(a) for a in argv)}: "
              f"exit {code}; {lines[0] if lines else ''} ... "
              f"{lines[-1] if lines else ''}", flush=True)
        assert code == 0, (name, argv, out.getvalue()[-2000:])


def tool_phases() -> dict:
    """Phases 32-33: the paths' runs, keyed for the kernels line."""
    with tempfile.TemporaryDirectory(prefix="stpu-torch-tools-") as tmp:
        matrix = crash_matrix_phase(tmp)
        ab = loadtest_ab(tmp)
        sustained = loadtest_sustained(tmp)
        tool_readers(matrix, sustained, tmp)
    return {"crash matrix 2pc rm=9": matrix and matrix["run"],
            "load test A/B 2pc check-gpu 9": ab,
            "load test --sustained 2pc check-gpu 9":
                sustained and sustained["run"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import stateright_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    build()
    rec, calls = (kernels() if not FAILED else None) or (None, None)
    dev_rec = dev_kernels() if not FAILED else None
    hash_rec, hash_call = (hash_kernel() if not FAILED else None) or (
        None, None)
    rm5()
    runs = {"2pc rm=9": rm9()}
    paxos2()
    runs["paxos 4c"] = paxos4()
    runs["paxos 5c"] = paxos5()
    runs["abd 2c/3s ordered"] = abd_main()
    chunked = chunk_phase() or {}
    runs["2pc-actors rm=9"] = twopc_actors9()
    runs["paxos-compiled 2c"] = paxos_compiled2()
    compiled_card_vs_cpu()
    runs["2pc rm=9 dense"] = rm9_dense()
    runs["paxos 4c dense"] = paxos4_dense()
    runs["2pc-actors rm=9 dense"] = twopc_actors9_dense()
    lanes = {"increment-lock 8": increment_lock8(),
             "increment 8": increment8(), "register 8": register8(),
             "single-copy-register 2": single_copy2(),
             "single-copy-register 3": single_copy3()}
    dense_card_vs_cpu()
    runs["2pc rm=9 --symmetry"] = rm9_sym()
    runs["2pc rm=9 --symmetry dense"] = rm9_sym_dense()
    runs["2pc rm=9 --ample-set"] = rm9_ample()
    runs["2pc rm=9 --symmetry --ample-set"] = rm9_sym_ample()
    runs["register 8 --symmetry"] = register8_sym()
    analyze_soundness(card)
    gated = {"2pc rm=9 --ample-set waived (BadAmple)": reduction_gate()}
    hashes = {"hash 2pc rm=5": hash_rm5(), "hash paxos 2c/3s": hash_paxos2(),
              "hash 2pc rm=9": hash_rm9(), "hash paxos 4": hash_paxos4()}
    host_bfs_rm5()
    tiered = {"2pc rm=9 tiered": rm9_tiered(runs["2pc rm=9"]),
              "paxos 4c tiered": paxos4_tiered(runs["paxos 4c"])}
    rm5_tiered()
    tiered["2pc rm=9 --tier-hot-rows=auto"] = rm9_tier_auto()
    runs.update(tiered)
    ckpt_runs, ckpt_hashes, ckpts = checkpoint_phases(
        runs["2pc rm=9"], tiered["2pc rm=9 tiered"])
    runs.update(ckpt_runs)
    hashes.update(ckpt_hashes)
    mesh_runs, mesh_hashes, meshes = sharded_phases(runs["2pc rm=9"],
                                                    runs["paxos 4c"])
    runs.update(mesh_runs)
    hashes.update(mesh_hashes)
    traced = traced_phases(runs, hashes)
    batch_runs, batch_hashes, batched = batch_phases()
    runs.update(batch_runs)
    hashes.update(batch_hashes)
    served = serve_phases(runs, batch_hashes.get(
        "batch 2pc rm=7+8+9 fused"))
    sims = {"simulation 2pc rm=5": sim_rm5(),
            "simulation 2pc rm=9": sim_rm9(),
            "simulation paxos 4": sim_paxos4()}
    hybrids = {"hybrid increment 6": hybrid_increment6(),
               "hybrid paxos 2c/3s": hybrid_paxos2(),
               "hybrid paxos 4": hybrid_paxos4()}
    # the hybrids' device sides, at their widest waves, where they ran
    # one (a side cancelled before its first wave has no shapes)
    runs.update({path: run for path, run in hybrids.items()
                 if run is None or run["metrics"].get("waves")})
    pinger_runs, pinger_hashes = pinger_phases()
    runs.update(pinger_runs)
    hashes.update(pinger_hashes)
    tools = tool_phases()
    # each kernel held to its plain version at every path's own shapes
    # (the lanes' waves are far narrower than these)
    at = {path: run and kernels_at(path, run["metrics"])
          for path, run in runs.items()}
    hash_at_paths = {path: run and hash_at(path, run)
                     for path, run in hashes.items()}
    launches = {path: run and run["launches"]
                for path, run in {**runs, **lanes, **sims, **hybrids,
                                  **hashes, **ckpts, **meshes,
                                  **traced, **batched,
                                  **served, **gated, **tools,
                                  **chunked}.items()}
    per_call = (device_ops({**calls, "hash_insert": hash_call})
                if calls and hash_call else None)
    if (FAILED or rec is None or hash_rec is None or dev_rec is None
            or not chunked or not all(at.values())
            or not all(hash_at_paths.values()) or per_call is None
            or not all(launches.values())):
        print(f"chip_smoke: failed phases: {FAILED}", file=sys.stderr)
        return 1
    records = []
    for name, r in rec.items():
        records.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": r["replaces"],
            "launches": {path: n[name] for path, n in launches.items()},
            "max_abs_err": max([r["max_abs_err"]]
                               + [a[name]["max_abs_err"]
                                  for a in at.values()]),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "pct_of_bound": r["pct_of_bound"],
            "launches_per_call": per_call[name],
            "at_path_shapes": {path: a[name] for path, a in at.items()},
        })
    records.append({
        "name": "hash_insert", "route": "cuda", "source": HASH_SOURCE,
        # not a Pallas kernel: the XLA while_loop of _insert_jax
        "replaces": "stateright_tpu/ops/hashset.py:197",
        "launches": {path: n["hash_insert"] for path, n in launches.items()},
        "max_abs_err": max([hash_rec["max_abs_err"]]
                           + [a["max_abs_err"]
                              for a in hash_at_paths.values()]),
        **{k: hash_rec[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "pct_of_bound", "bound_ms_32b_sectors", "keys", "slots",
            "half_full")},
        "launches_per_call": per_call["hash_insert"],
        "at_path_shapes": hash_at_paths,
    })
    for r in records:
        # the same kernel called with device counts, padded buffers
        r["device_counts"] = dev_rec[r["name"]]
        r["max_abs_err"] = max(r["max_abs_err"],
                               dev_rec[r["name"]]["max_abs_err"])
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [CHUNK_IDLE_FLAG]:
        print(json.dumps(chunk_idle_shares()))
        sys.exit(0)
    if sys.argv[1:2] == [SIM_OPS_FLAG]:
        print(sim_device_ops(int(sys.argv[2])))
        sys.exit(0)
    if sys.argv[1:2] == [COLD_GATE_FLAG] and sys.argv[2:]:
        print(f"card: {card_line()}", flush=True)
        cold_gate(sys.argv[2:])
        sys.exit(0)
    sys.exit(main())
