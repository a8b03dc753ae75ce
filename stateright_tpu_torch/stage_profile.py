"""Where the time of one wave-engine run goes on the card.

    python -m stateright_tpu_torch.stage_profile 9
    python -m stateright_tpu_torch.stage_profile paxos 4
    python -m stateright_tpu_torch.stage_profile 2pc-actors 9
    python -m stateright_tpu_torch.stage_profile abd 2 3 ordered
    python -m stateright_tpu_torch.stage_profile --dense paxos 4
    python -m stateright_tpu_torch.stage_profile --symmetry 9
    python -m stateright_tpu_torch.stage_profile --simulation 9
    python -m stateright_tpu_torch.stage_profile --simulation paxos 4
    python -m stateright_tpu_torch.stage_profile --hash 9
    python -m stateright_tpu_torch.stage_profile --hash paxos 4
    python -m stateright_tpu_torch.stage_profile --tier 1048576 9
    python -m stateright_tpu_torch.stage_profile --tier 262144 paxos 4
    python -m stateright_tpu_torch.stage_profile --shards 4 9
    python -m stateright_tpu_torch.stage_profile --shards 4 paxos 4
    python -m stateright_tpu_torch.stage_profile --shards 2 --hash 9
    python -m stateright_tpu_torch.stage_profile --shards 4 --devices cuda:0,cuda:1,cuda:2,cuda:3 9
    python -m stateright_tpu_torch.stage_profile --batch 7 8 9

The runs are ``2pc check-gpu N``, ``paxos check-gpu N`` and
``2pc-actors check-gpu N`` as the CLI runs them, and ABD with C
clients and S servers over the named network (paths off, the sizes of
the bench's ``abd 2c/3s ordered``); the compiled encodings are built
before the clock starts. ``--dense`` runs the same checker on the dense
wave (``spawn_sortmerge(sparse=False)``). ``--symmetry`` and
``--ample-set`` arm the reductions of the 2pc run, as the CLI flags do;
with ``--symmetry`` it also reports the canonicalizer's own cost (see
:func:`_canonicalizer_cost`). ``--simulation`` profiles the device
simulation instead, at ``chip_smoke.py``'s configurations
(:data:`SIM_CFG`: 2pc rm=9, 262,144 walks of 64 steps, 4 rounds, paths
on; paxos 4, 16,384 walks of 32 steps, 1 round, paths off), and adds
the device operations a walk step. ``--hash`` profiles the hash wave
engine (``spawn_hash``) at ``chip_smoke.py``'s configurations
(:data:`HASH_CFG`: 2pc rm=9 in 2^25 slots, paths on; paxos 4 in 2^23
slots, paths off) and adds the insert kernel's share. ``--tier N``
runs the sort-merge checker with the tiered visited set at a hot
ceiling of N keys (``--tier-hot-rows=N``) and adds the engine's own
host walls of the tier: the spills, the ingest on the worker thread,
the waits for it and the cold membership searches (:func:`_tier_split`).
``--shards S`` runs the sharded engine of the same run instead
(``spawn_sharded_sortmerge``, or ``spawn_sharded_hash`` with ``--hash``)
over S shards, each with the per-shard sizes of :func:`sharded_sizes`,
all on ``cuda:0`` unless ``--devices`` lists one device a shard, and
adds the shard route's and the exchange's device time and the host
wall of the engine's per-wave syncs (:func:`_shard_split`). ``--batch
N1 N2 ...`` profiles the fused run of the ``2pc check-gpu N1``, ``N2``,
... lanes' checkers (batch.py ``FusedWaveChecker``, one session a lane).

Needs a CUDA device. After a warm-up run (kernel build, CUDA context,
caching allocator), it times one untraced run with a host clock ending
in ``torch.cuda.synchronize()``, then repeats the run under
``torch.profiler`` (device activity only) and sums the device time of
every kernel, grouped into stages by kernel name. It prints one JSON
object: the card's name and power limit, the untraced and traced walls,
the device busy time and the idle share of the traced wall, the
per-stage and top per-kernel device times, and the shares of the Merge
Path and hash insert kernels in the device time.
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
    ("hash insert kernels", r"probe_claim_kernel|winner_kernel"),
    ("member kernel", r"member_tile_kernel"),
    ("merge kernel", r"merge_tile_kernel"),
    ("sort", r"[Ss]ort|[Rr]adix"),
    ("compaction (nonzero, scan)", r"nonzero|[Ss]can|[Ss]elect|flag|write_indices"),
    ("gather / scatter / index", r"index|[Gg]ather|[Ss]catter|take"),
    ("reduction", r"reduce|[Rr]educe"),
    ("stack / cat (dense successor block)", r"CatArray|[Cc]at_"),
    ("elementwise", r"elementwise|[Ff]ill|copy"),
    ("memcpy / memset", r"Memcpy|Memset"),
)


def _stage(name: str) -> str:
    for stage, pat in STAGES:
        if re.search(pat, name):
            return stage
    return "other"


def _checker(model: str, n: int, extra: list, sparse=None, flags=None):
    """The checker of one run (its encoding compiled); ``sparse=False``
    forces the dense wave; ``flags`` (a ``cli.RunFlags``) arms the 2pc
    run's reductions."""
    import warnings

    from .cli import RunFlags, paxos_checker, twopc_sizes

    flags = flags or RunFlags()
    if model == "paxos":
        return paxos_checker(n, flags, sparse=sparse)
    if model == "2pc-actors":
        from .models.two_phase_commit_actors import (
            two_phase_sys_actor_model,
            two_phase_sys_compiled_encoded,
        )

        return two_phase_sys_actor_model(n).checker().spawn_sortmerge(
            encoded=two_phase_sys_compiled_encoded(n), **twopc_sizes(n),
            device="cuda", sparse=sparse, tier_hot_rows=flags.tier_hot_rows)
    if model == "abd":
        from .actor import Network
        from .models.linearizable_register import AbdModelCfg, abd_model

        servers = int(extra[0]) if extra else 2
        network = Network.from_name(extra[1] if len(extra) > 1
                                    else "unordered")
        m = abd_model(AbdModelCfg(client_count=n, server_count=servers),
                      network)
        with warnings.catch_warnings():  # the declared queue-bound caps
            warnings.simplefilter("ignore", RuntimeWarning)
            enc = m.to_encoded()
        return m.checker().spawn_sortmerge(
            encoded=enc, capacity=1 << 21, frontier_capacity=1 << 18,
            track_paths=False, device="cuda", sparse=sparse,
            tier_hot_rows=flags.tier_hot_rows)
    from .models.two_phase_commit import TwoPhaseSys

    return flags.spawn(
        TwoPhaseSys(rm_count=n), symmetric=True, **twopc_sizes(n),
        sparse=sparse)


def sharded_sizes(sizes: dict, n_shards: int) -> dict:
    """Per-shard sort-merge sizes for ``n_shards`` shards from one
    device's: twice an even share of the capacity and the frontier (a
    bound the shards may cross unevenly; the port allocates to the live
    size, not the bound)."""
    if n_shards == 1:
        return dict(sizes)
    return {k: -(-2 * v // n_shards) if k in ("capacity",
                                              "frontier_capacity") else v
            for k, v in sizes.items()}


def _sharded_checker(model: str, n: int, devices: list, hashed: bool):
    """The sharded engine of 2pc rm=``n`` or Paxos with ``n`` clients, at
    the one-device run's sizes split over the shards."""
    from .cli import twopc_sizes

    S = len(devices)
    if model == "paxos":
        from .models.paxos import PaxosModelCfg, paxos_model
        from .models.paxos_tpu import STRUCTURAL_SIZES

        m = paxos_model(PaxosModelCfg(client_count=n, server_count=3))
        sizes = dict(sharded_sizes(STRUCTURAL_SIZES[n], S),
                     track_paths=n <= 2)
    else:
        from .models.two_phase_commit import TwoPhaseSys

        m = TwoPhaseSys(rm_count=n)
        sizes = sharded_sizes(twopc_sizes(n), S)
    if hashed:
        cfg = dict(HASH_CFG[model])
        # the table is allocated: an even share, a power of two
        cfg["capacity"] = max(1 << 10, cfg["capacity"] // S)
        return m.checker().spawn_sharded_hash(devices=devices, **cfg)
    return m.checker().spawn_sharded_sortmerge(devices=devices, **sizes)


def _shard_split(syncs: dict, ranges: dict, waves: int, wall: float) -> dict:
    """The sharded run's route and exchange on the device (the
    profiler's ranges around ``exchange.route`` and ``exchange.exchange``:
    their kernels' summed time, and the span each range covers on the
    device timeline) and the host wall of its per-wave syncs
    (``exchange.host_rows``, the counts and verdicts read on the host),
    beside the untraced wall."""
    return dict(
        **ranges,
        host_sync_calls=syncs["calls"],
        host_sync_sec=syncs["sec"],
        host_sync_sec_per_wave=syncs["sec"] / max(waves, 1),
        host_sync_share_of_untraced_wall=syncs["sec"] / wall)


def _instrument_shards(syncs: dict) -> None:
    """Wrap the sharded engines' route and exchange in profiler ranges
    and time their host syncs (this tool's patch of the names the engine
    modules call, for this process only)."""
    from torch.profiler import record_function

    from .parallel import engine, engine_sortmerge, exchange

    def ranged(name, fn):
        def run(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return run

    def timed_rows(rows):
        t0 = time.monotonic()
        out = exchange.host_rows(rows)
        syncs["sec"] += time.monotonic() - t0
        syncs["calls"] += 1
        return out

    for mod in (engine, engine_sortmerge):
        mod.route = ranged("shard route", exchange.route)
        mod.exchange = ranged("shard exchange", exchange.exchange)
        mod.host_rows = timed_rows


#: the warm-up size of each model (a smaller run of the same code)
WARM = {"2pc": 5, "2pc-actors": 5, "paxos": 2, "abd": 1}


#: the simulation runs of chip_smoke.py: model -> walk configuration
SIM_CFG = {
    "2pc": dict(n_walks=262_144, max_steps=64, rounds=4),
    "paxos": dict(n_walks=16_384, max_steps=32, rounds=1,
                  track_paths=False),
}


def _sim_checker(model: str, n: int, cfg: dict):
    """The device simulation of 2pc rm=``n`` or Paxos with ``n``
    clients, seed 0, on the card."""
    if model == "paxos":
        from .models.paxos import PaxosModelCfg, paxos_model

        m = paxos_model(PaxosModelCfg(client_count=n, server_count=3))
    else:
        from .models.two_phase_commit import TwoPhaseSys

        m = TwoPhaseSys(rm_count=n)
    return m.checker().spawn_device_simulation(seed=0, device="cuda",
                                                **cfg)


#: the hash engine's runs of chip_smoke.py: model -> spawn_hash sizes
HASH_CFG = {"2pc": dict(capacity=1 << 25),
            "paxos": dict(capacity=1 << 23, track_paths=False)}


def _hash_checker(model: str, n: int, cfg: dict):
    """The hash engine on 2pc rm=``n`` or Paxos with ``n`` clients."""
    if model == "paxos":
        from .models.paxos import PaxosModelCfg, paxos_model

        m = paxos_model(PaxosModelCfg(client_count=n, server_count=3))
    else:
        from .models.two_phase_commit import TwoPhaseSys

        m = TwoPhaseSys(rm_count=n)
    return m.checker().spawn_hash(device="cuda", **cfg)


def _batch_checker(rms: list):
    """The fused engine over the ``2pc check-gpu N`` lanes' checkers."""
    from .batch import FusedWaveChecker
    from .cli import twopc_sizes
    from .models.two_phase_commit import TwoPhaseSys

    return FusedWaveChecker([
        TwoPhaseSys(rm_count=n).checker().spawn_sortmerge(**twopc_sizes(n))
        for n in rms])


def _check(model: str, n: int, extra: list, sparse=None, flags=None,
           make=None):
    """One run, timed to the device's end (the encoding is built
    before the clock starts); ``make()`` builds the checker instead of
    the CLI's."""
    c = make() if make else _checker(model, n, extra, sparse, flags)
    t0 = time.monotonic()
    c.join()
    torch.cuda.synchronize()
    return c, time.monotonic() - t0


def _canonicalizer_cost(run) -> dict:
    """The symmetry canonicalizer's share of one run: ``run()`` is made
    with every device call of ``canonicalize_t`` recorded (its input
    block kept), then the recorded calls are replayed alone under the
    profiler — the same ops on the same blocks — and their kernels
    counted and summed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .checkers import tpu, tpu_sortmerge
    from .ops.canonical import canonicalize_t

    calls = []

    def recording(spec, block):
        if block.is_cuda:
            calls.append((spec, block.clone()))
        return canonicalize_t(spec, block)

    tpu.canonicalize_t = tpu_sortmerge.canonicalize_t = recording
    try:
        checker = run()
    finally:
        tpu.canonicalize_t = tpu_sortmerge.canonicalize_t = canonicalize_t
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for spec, block in calls:
            canonicalize_t(spec, block)
        torch.cuda.synchronize()
    kernels = {ev.key: (ev.count, ev.self_device_time_total / 1e3)
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA}
    waves = checker.metrics["waves"]
    launches = sum(n for n, _ in kernels.values())
    return dict(
        calls=len(calls), columns=sum(b.shape[1] for _, b in calls),
        launches=launches, launches_per_wave=launches / waves,
        device_ms=sum(ms for _, ms in kernels.values()),
        kernels_ms={k: ms for k, (_, ms) in sorted(
            kernels.items(), key=lambda kv: -kv[1][1])})


def _tier_split(metrics: dict, wall: float, busy_ms: float) -> dict:
    """A tiered run's host walls (the engine's ``metrics``, seconds) and
    their shares of the traced wall, beside the device busy share."""
    keys = ("spill_wall_sec", "ingest_sec", "ingest_wait_sec",
            "cold_member_sec")
    out = {k: metrics.get(k) for k in ("tier_spills", "cold_rows",
                                       "hot_rows", "hot_ceiling_rows",
                                       "cold_runs", *keys)}
    out["shares_of_traced_wall"] = dict(
        device_busy=busy_ms / (wall * 1e3),
        **{k: (metrics[k] / wall if metrics.get(k) is not None else None)
           for k in keys})
    return out


def main(argv=None) -> int:
    from .cli import RunFlags

    argv = list(sys.argv[1:] if argv is None else argv)
    sim = "--simulation" in argv
    if sim:
        argv.remove("--simulation")
    hashed = "--hash" in argv
    if hashed:
        argv.remove("--hash")
    batch = "--batch" in argv
    if batch:
        argv.remove("--batch")
    devices = None
    if "--devices" in argv:
        i = argv.index("--devices")
        devices = argv[i + 1].split(",")
        del argv[i:i + 2]
    if "--shards" in argv:
        i = argv.index("--shards")
        S = int(argv[i + 1])
        del argv[i:i + 2]
        devices = devices or ["cuda:0"] * S
        if len(devices) != S:
            raise SystemExit(f"--shards {S} but --devices lists "
                             f"{len(devices)}")
    sparse = None
    if "--dense" in argv:
        argv.remove("--dense")
        sparse = False
    on = {}
    if "--tier" in argv:
        i = argv.index("--tier")
        on["tier_hot_rows"] = int(argv[i + 1])
        del argv[i:i + 2]
    for flag, name in (("--symmetry", "symmetry"),
                       ("--ample-set", "ample_set")):
        if flag in argv:
            argv.remove(flag)
            on[name] = True
    flags = RunFlags(**on)
    model = argv.pop(0) if argv and argv[0] in WARM else "2pc"
    n = int(argv[0]) if argv else {"paxos": 4, "abd": 2}.get(model, 9)
    extra = argv[1:]
    if not torch.cuda.is_available():
        print("stage_profile: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    make = warm = None
    syncs = dict(sec=0.0, calls=0)
    if devices is not None:
        _instrument_shards(syncs)
        make = lambda: _sharded_checker(  # noqa: E731
            model, n, devices, hashed)
        warm = lambda: _sharded_checker(  # noqa: E731
            model, min(n, WARM[model]), devices, hashed)
    elif sim:
        cfg = SIM_CFG[model]
        make = lambda: _sim_checker(model, n, cfg)  # noqa: E731
        warm = lambda: _sim_checker(  # noqa: E731
            model, min(n, WARM[model]), dict(cfg, n_walks=1024))
    elif batch:
        rms = [n, *map(int, extra)]
        make = lambda: _batch_checker(rms)  # noqa: E731
        warm = lambda: _batch_checker([3, 4])  # noqa: E731
    elif hashed:
        cfg = HASH_CFG[model]
        make = lambda: _hash_checker(model, n, cfg)  # noqa: E731
        warm = lambda: _hash_checker(  # noqa: E731
            model, min(n, WARM[model]), dict(cfg, capacity=1 << 16))
    _check(model, min(n, WARM[model]), extra, sparse, flags, warm)
    syncs.update(sec=0.0, calls=0)
    checker, wall = _check(model, n, extra, sparse, flags, make)
    untraced_syncs = dict(syncs)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # device activity only: the host ops of a dense Paxos run are
    # millions of events, more than the profiler digests in minutes (a
    # sharded run records its host ranges too: its route and exchange
    # are read off them)
    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if devices is not None else [])
    with profile(activities=activities) as prof:
        traced, traced_wall = _check(model, n, extra, sparse, flags, make)
    kernels = {}
    ranges = {}
    launches = 0
    for ev in prof.key_averages():
        if ev.key in ("shard route", "shard exchange"):
            # the host range sums its kernels' device time; its copy on
            # the device timeline spans first kernel to last, gaps too
            name = ev.key.replace(" ", "_")
            if ev.device_type == DeviceType.CUDA:
                ranges[f"{name}_device_span_ms"] = (
                    ev.self_device_time_total / 1e3)
            else:
                ranges[f"{name}_kernels_ms"] = getattr(
                    ev, "device_time_total",
                    getattr(ev, "cuda_time_total", 0)) / 1e3
            continue
        if ev.device_type != DeviceType.CUDA:
            continue  # host ops; their kernels are listed on their own
        kernels[ev.key] = kernels.get(ev.key, 0.0) + (
            ev.self_device_time_total / 1e3
        )
        launches += ev.count
    stages = {}
    for name, ms in kernels.items():
        stage = _stage(name)
        stages[stage] = stages.get(stage, 0.0) + ms
    busy_ms = sum(kernels.values())
    merge_path_ms = stages.get("member kernel", 0.0) + stages.get(
        "merge kernel", 0.0)
    hash_ms = stages.get("hash insert kernels", 0.0)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    canon = (_canonicalizer_cost(
        lambda: _check(model, n, extra, sparse, flags)[0])
        if flags.symmetry else None)
    if sim:
        steps = traced.rounds * traced.max_steps
        print(json.dumps({
            "card": card,
            "model": f"simulation {model} {n}",
            "walks": traced.n_walks, "max_steps": traced.max_steps,
            "rounds": traced.rounds, "track_paths": traced.track_paths,
            "states": checker.state_count(),
            "depth": checker.max_depth(),
            "discovered": sorted(checker.discovered_property_names()),
            "wall_s": wall,
            "traced_wall_s": traced_wall,
            "device_busy_ms": busy_ms,
            "idle_share_of_traced_wall": 1 - busy_ms / (traced_wall * 1e3),
            "device_ops": launches,
            # each round evaluates its final states once more
            "device_ops_per_walk_step": launches / steps,
            "walk_steps_per_s": traced.n_walks * steps / wall,
            "stages_ms": dict(sorted(stages.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": dict(top),
        }, indent=1))
        return 0
    print(json.dumps({
        "card": card,
        "model": " ".join((["hash"] if hashed else [])
                          + (["batch"] if batch else [])
                          + [model, str(n), *extra]
                          + ([f"--shards={len(devices)}"]
                             if devices is not None else [])
                          + (["dense"] if sparse is False else [])
                          + [f"--{k.replace('_', '-')}={v}"
                             if v is not True else
                             f"--{k.replace('_', '-')}"
                             for k, v in on.items()]),
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
        "hash_insert_kernels_ms": hash_ms,
        "hash_insert_share_of_device_time": hash_ms / busy_ms,
        "metrics": traced.metrics,
        "stages_ms": dict(sorted(stages.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": dict(top),
        "canonicalizer": canon,
        "tier": (_tier_split(traced.metrics, traced_wall, busy_ms)
                 if flags.tier_hot_rows else None),
        "devices": devices,
        "shards": (_shard_split(untraced_syncs, ranges,
                                checker.metrics["waves"], wall)
                   if devices is not None else None),
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
