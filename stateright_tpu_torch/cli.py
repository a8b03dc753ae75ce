"""Command-line entry point of the PyTorch port.

    python -m stateright_tpu_torch 2pc check-gpu 9
    python -m stateright_tpu_torch 2pc check-gpu 3 --device cpu
    python -m stateright_tpu_torch paxos check-gpu 4
    python -m stateright_tpu_torch paxos check-gpu 2 --device cpu
    python -m stateright_tpu_torch 2pc-actors check-gpu 9
    python -m stateright_tpu_torch paxos-compiled check-gpu 2
    python -m stateright_tpu_torch linearizable-register check-gpu 2 ordered
    python -m stateright_tpu_torch increment check-gpu 8
    python -m stateright_tpu_torch increment-lock check-gpu 3 --device cpu
    python -m stateright_tpu_torch register check-gpu 8
    python -m stateright_tpu_torch single-copy-register check-gpu 2
    python -m stateright_tpu_torch 2pc check-gpu 9 --symmetry --ample-set
    python -m stateright_tpu_torch register check-gpu 8 --symmetry
    python -m stateright_tpu_torch 2pc check 3
    python -m stateright_tpu_torch paxos check 2 ordered

``check`` runs the host depth-first search (checkers/dfs.py) and prints
what the JAX lane's ``check`` prints: the same header and the
``Done. states=… unique=… depth=… sec=…`` report with every discovery's
path. It runs on the host, so ``--device`` does not apply to it, and
the reduction flags belong to ``check-gpu``.

``check-gpu`` runs the sort-merge wave engine on the CUDA device (on
the CPU only with ``--device cpu``) and prints the same report as the
JAX package's ``check-tpu`` lane of the same model: ``Done. states=…
unique=… depth=… sec=…`` and every discovery with its encoded path and
replayed states (for Paxos with 3 or more clients, as there, the
discovery fingerprint only: paths are off). The ``2pc-actors``,
``paxos-compiled`` and ``linearizable-register`` lanes run encodings
made by the actor→encoding compiler (actor/compile.py), as does
``single-copy-register`` beyond 2 clients. ``increment``,
``increment-lock`` and ``single-copy-register`` (up to 2 clients) run
dense-only encodings, so the engine runs its dense wave there; every
other lane runs the sparse wave (the dense wave of 2pc, Paxos and the
compiled encodings is ``spawn_sortmerge(sparse=False)``, as in the JAX
package, which has no flag for it either).

Three flags arm the reductions, as in the JAX lanes: ``--symmetry`` (the
``2pc`` and ``register`` lanes: canonical fingerprints before dedup,
ops/canonical.py), ``--ample-set`` (any sparse lane whose encoding
declares an ample mask) and ``--unsound-ok`` (run a spec or mask the
reduction soundness analyzer, analysis/soundness.py, does not certify).
``analyze soundness [MODEL] [COUNT] [--no-artifact] [--device cpu]``
runs that analyzer over the registered targets (2pc, register) and
writes the ``SOUND_r*.json`` certificate. ``--tier-hot-rows=N``
(or ``=auto``) tiers the visited set of any ``check-gpu`` lane: at most
N keys stay on the device and the rest spill to sorted runs in host
memory (tier.py); ``auto`` takes N from ``memplan.decide_hot_rows``
against the JAX lane's 2 GiB budget.

    python -m stateright_tpu_torch 2pc check-gpu 3 --device cpu --tier-hot-rows=32

Every ``check-gpu`` lane checkpoints and resumes as the JAX lanes do
(checkpoint.py): ``--checkpoint-every=N`` writes a snapshot every N
chunks (``auto``: the cadence that keeps the snapshot walls under 5% of
the run's) and retries a failed chunk from it; ``--checkpoint-path=P``
names the file (default ``stateright_tpu_torch.ckpt``); ``--resume``
continues from it (``--resume-any-sha`` also from another commit);
``--watchdog[=factor]`` bounds each chunk's wall at ``factor`` (default
8) times the slowest chunk so far; ``--degrade-on-fault`` is accepted as
the JAX lanes accept it: it lets the supervisor drop a shard that keeps
failing, which engages only on a sharded engine (the CLI's lanes run one
device; the sharded engines are a library entry, parallel/).
``--waves-per-sync=N`` sets the chunk: up to N waves between two host
syncs (default 1; JAX's is 64), each chunk's waves replayed as CUDA graphs
on the card; ``--checkpoint-every=K`` counts chunks, as JAX's does, and
the manifest records N. The host lanes refuse it, as JAX's do. A run
killed mid-way resumes from its last snapshot:

    python -m stateright_tpu_torch 2pc check-gpu 9 --checkpoint-every=4
    python -m stateright_tpu_torch 2pc check-gpu 9 --resume

``--trace`` (or ``--trace=deep``) anywhere on the line traces the run of
any ``check-gpu`` or ``check`` lane (telemetry.py) and writes the pair
``TRACE_rNN.jsonl`` / ``TRACE_rNN.trace.json``, on failure too, into
the artifacts' root: the repository root, or ``--trace-root=DIR``, or
``$STPU_TORCH_ARTIFACT_ROOT`` (artifacts.py). The JAX package's
``tools/trace_diff.py``, ``shard_report.py``, ``latency_report.py`` and
``mem_report.py`` read it. ``--trace=deep`` syncs the device before each
wave's first read, so the wave walls split into device and host time.
``--straggler-factor=F`` arms the straggler detector of a traced
sharded run (a no-op on the CLI's one-device lanes).

``--metrics-interval=N`` (seconds) on any lane runs a tracer for it
(trace artifacts only with ``--trace``) and every N seconds folds its
events through the tracer->metrics bridge (metrics.py
``bridge_events``) into one cumulative ``metrics_rollup`` JSONL line,
plus a final line at exit, failed runs included: into
``--metrics-path=FILE``, by default ``stateright_tpu_torch.metrics.jsonl``
in the working directory. ``metrics.load_rollup`` reads it back.

    python -m stateright_tpu_torch 2pc check-gpu 9 --trace=deep
    python -m stateright_tpu_torch paxos check 2 --trace --trace-root=/tmp/t
    python -m stateright_tpu_torch 2pc check-gpu 9 --metrics-interval=0.5

``explore [COUNT] [ADDRESS]`` serves the Explorer web UI over the
model's on-demand checker (explorer/server.py). ``serve [HOST:PORT]``
runs the resident checking service (serve.py) until interrupted, every
session on its ``--device``; ``--connect=HOST:PORT`` on any lane ships
the lane to it and prints its report. Every lane reaches the service
through one seam, :func:`_report`, where the service's per-thread
session hook meets the freshly spawned checker before its first join.

    python -m stateright_tpu_torch 2pc explore 3 localhost:3000
    python -m stateright_tpu_torch serve 127.0.0.1:3000
    python -m stateright_tpu_torch --connect=127.0.0.1:3000 2pc check-gpu 9

The host lanes of the JAX CLI are here too: ``check-sym [COUNT]`` on
``2pc``, ``increment``, ``increment-lock`` and ``register`` (the host DFS
over each state's ``representative()``); ``timers check`` (the pinger's
unbounded DFS), ``interaction check [DEPTH]`` and ``panic check``; and
``spawn`` on ``paxos``, ``single-copy-register`` and
``linearizable-register``, the verified actors as UDP servers
(actor/spawn.py). :data:`SUBCOMMANDS` lists every lane's subcommands.

    python -m stateright_tpu_torch 2pc check-sym 5
    python -m stateright_tpu_torch interaction check 12
    python -m stateright_tpu_torch paxos spawn
"""

from __future__ import annotations

import math
import sys
import threading
from dataclasses import dataclass

from .report import WriteReporter


@dataclass(frozen=True)
class RunFlags:
    """The options of a ``check-gpu`` run."""

    device: str = "cuda"
    symmetry: bool = False
    ample_set: bool = False
    unsound_ok: bool = False
    #: the hot-tier ceiling of the tiered visited set: None (off), an
    #: int >= 1, or "auto"
    tier_hot_rows: int | str | None = None
    #: a snapshot every N waves, or "auto"; None: off
    checkpoint_every: int | str | None = None
    #: the snapshot file (None: checkpoint.DEFAULT_PATH)
    checkpoint_path: str | None = None
    #: continue from the snapshot at the checkpoint path
    resume: bool = False
    #: resume a snapshot written at another git commit
    resume_any_sha: bool = False
    #: the watchdog's factor of the slowest wave so far; None: off
    watchdog: float | None = None
    #: let the supervisor drop a persistently failing shard (a no-op on
    #: one device, JAX ``--degrade-on-fault``)
    degrade_on_fault: bool = False
    #: the straggler detector's factor of the shard median (a traced
    #: sharded run's; a no-op on one device); None: off
    straggler_factor: float | None = None
    #: JAX ``--waves-per-sync=N``: the waves of a chunk between two host
    #: syncs; None: the engine's default (1)
    waves_per_sync: int | None = None

    def durable(self) -> bool:
        return bool(self.checkpoint_every or self.resume or self.watchdog
                    or self.degrade_on_fault or self.straggler_factor)

    def apply(self, checker):
        """Arm ``checker`` with the checkpoint, resume and watchdog flags
        (JAX ``cli._apply_runtime``) before its first join; on
        ``--resume``, stage the snapshot and print where it resumes."""
        from .checkpoint import DEFAULT_PATH

        path = self.checkpoint_path or DEFAULT_PATH
        if self.watchdog:
            checker.watchdog_factor = float(self.watchdog)
        if self.degrade_on_fault:
            checker.degrade_on_fault = True
        if self.straggler_factor:
            checker.straggler_factor = float(self.straggler_factor)
        if self.waves_per_sync:
            checker.waves_per_sync = int(self.waves_per_sync)
        if self.checkpoint_every:
            checker.checkpoint_every = self.checkpoint_every
            checker.checkpoint_path = path
        if self.resume:
            m = checker.resume_from(path,
                                    allow_sha_mismatch=self.resume_any_sha)
            print(f"resuming from {path}: wave {m['wave']}, depth "
                  f"{m['depth']}, {m['unique']:,} unique states (snapshot "
                  f"S={m['n_shards']})")
        return checker

    def spawn(self, model, symmetric: bool = False, **kw):
        """``model.checker()`` armed with these flags, spawned on the
        sort-merge engine with ``kw``. ``symmetric``: the lane may arm
        the symmetry reduction."""
        builder = model.checker()
        if self.symmetry:
            if not symmetric:
                raise SystemExit(
                    "--symmetry: this lane does not arm the symmetry "
                    "reduction (supported: 2pc check-gpu and register "
                    "check-gpu — the device canonicalization lanes)"
                )
            builder = builder.symmetry()
        if self.unsound_ok:
            builder = builder.unsound_ok()
        return self.apply(builder.spawn_sortmerge(
            device=self.device, ample_set=self.ample_set,
            tier_hot_rows=self.tier_hot_rows, **kw))


def _flags(flags) -> RunFlags:
    """A device name is the flags of a plain run on that device."""
    return flags if isinstance(flags, RunFlags) else RunFlags(flags)


def _pop_flags(argv: list[str]):
    """``(RunFlags, the other arguments)``."""
    device, rest, on, tier = "cuda", [], set(), None
    durable: dict = {}
    names = {"--symmetry": "symmetry", "--ample-set": "ample_set",
             "--unsound-ok": "unsound_ok", "--resume": "resume"}
    it = iter(argv)
    for arg in it:
        if arg.startswith("--checkpoint-every="):
            val = arg.split("=", 1)[1]
            if val != "auto" and int(val) < 1:
                raise SystemExit(
                    f"--checkpoint-every={val}: must be >= 1 (or 'auto')")
            durable["checkpoint_every"] = "auto" if val == "auto" else int(val)
        elif arg.startswith("--checkpoint-path="):
            durable["checkpoint_path"] = arg.split("=", 1)[1]
        elif arg == "--resume-any-sha":
            on.update(("resume", "resume_any_sha"))
        elif arg == "--watchdog" or arg.startswith("--watchdog="):
            val = arg.split("=", 1)[1] if "=" in arg else "8"
            if float(val) <= 0:
                raise SystemExit(f"--watchdog={val}: the factor must be > 0")
            durable["watchdog"] = float(val)
        elif arg.startswith("--waves-per-sync="):
            val = arg.split("=", 1)[1]
            if int(val) < 1:
                raise SystemExit(f"--waves-per-sync={val}: must be >= 1")
            durable["waves_per_sync"] = int(val)
        elif arg == "--degrade-on-fault":
            on.add("degrade_on_fault")
        elif arg.startswith("--straggler-factor="):
            val = float(arg.split("=", 1)[1])
            if val <= 1.0:
                raise SystemExit(
                    f"--straggler-factor={val}: must be > 1 (a shard "
                    "above the median would flag at 1)")
            durable["straggler_factor"] = val
        elif arg == "--device":
            device = next(it, None)
        elif arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        elif arg in names:
            on.add(names[arg])
        elif arg.startswith("--tier-hot-rows="):
            val = arg.split("=", 1)[1]
            # the JAX lane's check: a ceiling below one row is refused
            if val != "auto" and int(val) < 1:
                raise SystemExit(
                    f"--tier-hot-rows={val}: the hot ceiling must "
                    "be >= 1 row (or 'auto')"
                )
            tier = "auto" if val == "auto" else int(val)
        else:
            rest.append(arg)
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"--device must be cuda or cpu, got {device!r}")
    return RunFlags(device, tier_hot_rows=tier, **durable,
                    **{n: True for n in on}), rest


#: the resident service's per-thread session hook (serve.py): the service
#: sets ``hook`` around each session's call of :func:`main`, and
#: :func:`_report` runs it on the freshly spawned checker before its first
#: join (admission, warm start, the FIFO gate, retention). Thread-local,
#: so concurrent sessions never see each other's hook.
_SESSION_HOOK = threading.local()


def _report(checker) -> None:
    """The one reporting path of every check lane: the session hook, if
    one is set, then the reference-format report (report.rs:60-98) to
    ``sys.stdout``, read at call time (the service's per-thread capture
    replaces it)."""
    hook = getattr(_SESSION_HOOK, "hook", None)
    if hook is not None:
        hook(checker)
    checker.report(WriteReporter(sys.stdout))


def _host_only(flags: RunFlags, sub: str) -> None:
    """Refuse the device flags on a host subcommand."""
    if flags.waves_per_sync:
        # the JAX lanes' refusal of a runtime flag on a host engine
        raise SystemExit(
            "--checkpoint-every/--resume/--waves-per-sync/"
            "--tier-hot-rows/--degrade-on-fault/--watchdog/"
            "--straggler-factor need a device engine: use a "
            "check-gpu lane"
        )
    if (flags.symmetry or flags.ample_set or flags.unsound_ok
            or flags.tier_hot_rows is not None):
        raise SystemExit(
            "--symmetry, --ample-set, --unsound-ok and --tier-hot-rows "
            f"apply to check-gpu; {sub} runs on the host"
        )
    if flags.durable():
        raise SystemExit(
            "--checkpoint-every, --resume, --watchdog, --degrade-on-fault "
            f"and --straggler-factor apply to check-gpu; {sub} runs on the "
            "host"
        )


def _check(header: str, model, flags: RunFlags) -> None:
    """The ``check`` subcommand: ``header``, then the host DFS of
    ``model`` with the reference-format report."""
    _host_only(flags, "check")
    print(header)
    _report(model.checker().spawn_dfs())


def _check_sym(header: str, model, flags: RunFlags) -> None:
    """The ``check-sym`` subcommand: ``header``, then the host DFS of
    ``model`` with symmetry reduction (each visited key the fingerprint
    of the state's ``representative()``), as the JAX lane runs it."""
    _host_only(flags, "check-sym")
    print(header)
    _report(model.checker().symmetry().spawn_dfs())


def _spawn(flags: RunFlags, cluster) -> None:
    """The ``spawn`` subcommand: ``cluster()`` runs the lane's actors as
    UDP servers on 127.0.0.1 from port 3000 (actor/spawn.py), until
    interrupted."""
    _host_only(flags, "spawn")
    cluster()


def _explore(model, args: list[str], flags: RunFlags,
             what: str | None = None) -> None:
    """The ``explore [COUNT] [ADDRESS]`` subcommand: the Explorer web UI
    over ``model``'s on-demand checker (explorer/server.py) at ADDRESS
    (default ``localhost:3000``), until interrupted. ``what`` names the
    model in the JAX lane's header line."""
    _host_only(flags, "explore")
    address = args[1] if len(args) > 1 else "localhost:3000"
    if what is not None:
        print(f"Exploring state space for {what} on {address}.")
    model.checker().serve(address)


def _network(args: list[str], index: int):
    """The network named by ``args[index]`` (default unordered
    non-duplicating), as the JAX lanes read it."""
    from .actor import Network

    if len(args) > index:
        return Network.from_name(args[index])
    return Network.new_unordered_nonduplicating()


def twopc_sizes(rm_count: int) -> dict:
    """The engine capacities of the 2pc lane (the JAX lane's sizing: the
    2pc space grows ~2.53 bits/RM, and a sorted visited array has no
    load-factor pressure)."""
    capacity = 1 << max(10, math.ceil(2.6 * rm_count + 1.5))
    return dict(capacity=capacity,
                frontier_capacity=max(256, capacity // 4))


def _2pc(sub: str, args: list[str], flags: RunFlags) -> None:
    from .models.two_phase_commit import TwoPhaseSys

    rm_count = int(args[0]) if args else 2
    if sub == "check":
        _check(f"Checking two phase commit with {rm_count} resource "
               "managers.", TwoPhaseSys(rm_count=rm_count), flags)
        return
    if sub == "check-sym":
        _check_sym(f"Checking two phase commit with {rm_count} resource "
                   "managers using symmetry reduction.",
                   TwoPhaseSys(rm_count=rm_count), flags)
        return
    if sub == "explore":
        _explore(TwoPhaseSys(rm_count=rm_count), args, flags,
                 f"two phase commit with {rm_count} resource managers")
        return
    if sub != "check-gpu":
        _usage()
        return
    print(
        f"Checking two phase commit with {rm_count} resource managers "
        f"on the {_where(flags)} wave engine."
    )
    checker = flags.spawn(TwoPhaseSys(rm_count=rm_count), symmetric=True,
                          **twopc_sizes(rm_count))
    _report(checker)


def paxos_checker(client_count: int, flags="cuda", sparse=None):
    """The checker ``paxos check-gpu N`` runs: the encoding's structural
    sizes, and paths only up to 2 clients (the JAX lane's rule: beyond
    that the report gives the discovery fingerprint). ``sparse=False``
    runs it on the dense wave (the CLI has no flag for it). ``flags``:
    a :class:`RunFlags`, or a device name."""
    from .models.paxos import PaxosModelCfg, paxos_model
    from .models.paxos_tpu import STRUCTURAL_SIZES

    if client_count not in STRUCTURAL_SIZES:
        raise SystemExit(
            f"paxos check-gpu supports 1-5 clients (got {client_count}): "
            "the encoding's client-lane packing caps at 5 "
            "(models/paxos_tpu.py)"
        )
    cfg = PaxosModelCfg(client_count=client_count, server_count=3)
    return _flags(flags).spawn(
        paxos_model(cfg), track_paths=client_count <= 2, sparse=sparse,
        **STRUCTURAL_SIZES[client_count],
    )


def _paxos(sub: str, args: list[str], flags: RunFlags) -> None:
    client_count = int(args[0]) if args else 2
    if sub == "check":
        from .models.paxos import PaxosModelCfg, paxos_model

        cfg = PaxosModelCfg(client_count=client_count, server_count=3)
        _check(f"Model checking Single Decree Paxos with {client_count} "
               "clients.", paxos_model(cfg, _network(args, 1)), flags)
        return
    if sub == "explore":
        from .models.paxos import PaxosModelCfg, paxos_model

        cfg = PaxosModelCfg(client_count=client_count, server_count=3)
        _explore(paxos_model(cfg, _network(args, 2)), args, flags,
                 f"Single Decree Paxos with {client_count} clients")
        return
    if sub == "spawn":
        from .actor.spawn import spawn_paxos_cluster

        _spawn(flags, spawn_paxos_cluster)
        return
    if sub != "check-gpu":
        _usage()
        return
    checker = paxos_checker(client_count, flags)
    print(
        f"Model checking Single Decree Paxos with {client_count} "
        f"clients on the {_where(flags)} wave engine."
    )
    _report(checker)


def _where(flags: RunFlags) -> str:
    return "GPU" if flags.device == "cuda" else "CPU"


def _2pc_actors(sub: str, args: list[str], flags: RunFlags) -> None:
    """The compiled 2pc family: the count-comparable system actor model
    (models/two_phase_commit_actors.py) through the actor→encoding
    compiler, at the hand lane's sizes (the same pinned counts)."""
    from .models.two_phase_commit_actors import (
        two_phase_sys_actor_model,
        two_phase_sys_compiled_encoded,
    )

    rm_count = int(args[0]) if args else 2
    if sub == "check":
        _check(f"Checking two phase commit (compiled actor model) with "
               f"{rm_count} resource managers.",
               two_phase_sys_actor_model(rm_count), flags)
        return
    if sub == "explore":
        _explore(two_phase_sys_actor_model(rm_count), args, flags,
                 f"two phase commit (compiled actor model) with "
                 f"{rm_count} resource managers")
        return
    if sub != "check-gpu":
        _usage()
        return
    print(
        f"Checking two phase commit (compiled actor model) with "
        f"{rm_count} resource managers on the {_where(flags)} wave "
        "engine."
    )
    checker = flags.spawn(
        two_phase_sys_actor_model(rm_count),
        encoded=two_phase_sys_compiled_encoded(rm_count),
        **twopc_sizes(rm_count),
    )
    _report(checker)


def _paxos_compiled(sub: str, args: list[str], flags: RunFlags) -> None:
    """Compiled paxos: the actor paxos model through the compiler in
    reachable mode — the compile explores the space once on the host to
    harvest bounds, so this lane caps at 2 clients (16,668 states)."""
    from .models.paxos import (
        PaxosModelCfg,
        paxos_compiled_encoded,
        paxos_model,
    )

    client_count = int(args[0]) if args else 2
    if sub == "check":
        cfg = PaxosModelCfg(client_count=client_count, server_count=3)
        _check("Model checking Single Decree Paxos (compiled) with "
               f"{client_count} clients.", paxos_model(cfg), flags)
        return
    if sub != "check-gpu":
        _usage()
        return
    if client_count > 2:
        raise SystemExit(
            f"paxos-compiled check-gpu supports 1-2 clients (got "
            f"{client_count}): reachable-mode compilation "
            "explores the space once on the host to harvest "
            "bounds (models/paxos.py paxos_compiled_encoded), "
            "which is impractical beyond the 16,668-state "
            "2-client config"
        )
    cfg = PaxosModelCfg(client_count=client_count, server_count=3)
    print(
        f"Model checking Single Decree Paxos (compiled) with "
        f"{client_count} clients on the {_where(flags)} wave engine."
    )
    checker = flags.spawn(
        paxos_model(cfg), encoded=paxos_compiled_encoded(cfg),
        capacity=1 << 15, frontier_capacity=1 << 13,
    )
    _report(checker)


def _linearizable(sub: str, args: list[str], flags: RunFlags) -> None:
    """ABD (models/linearizable_register.py) over the network named by
    the second argument (default unordered non-duplicating), through
    its compiled encoding."""
    from .models.linearizable_register import AbdModelCfg, abd_model

    client_count = int(args[0]) if args else 2
    cfg = AbdModelCfg(client_count=client_count)
    if sub == "check":
        _check("Model checking a linearizable register with "
               f"{client_count} clients.", abd_model(cfg, _network(args, 1)),
               flags)
        return
    if sub == "explore":
        _explore(abd_model(cfg, _network(args, 2)), args, flags,
                 f"a linearizable register with {client_count} clients")
        return
    if sub == "spawn":
        from .actor.spawn import spawn_abd_cluster

        _spawn(flags, spawn_abd_cluster)
        return
    if sub != "check-gpu":
        _usage()
        return
    print(
        f"Model checking a linearizable register with {client_count} "
        f"clients on the {_where(flags)} wave engine (compiled actor "
        "encoding)."
    )
    checker = flags.spawn(
        abd_model(cfg, _network(args, 1)),
        capacity=1 << (9 + 2 * client_count),
        frontier_capacity=1 << (7 + client_count),
    )
    _report(checker)


#: engine sizes of the increment lanes: the largest space the encoding
#: takes (8 threads: increment_lock 438,401 states, 40,320 in its widest
#: wave) fits, so no thread count overflows (the engine sizes each wave
#: exactly; a capacity only bounds it)
INCREMENT_SIZES = dict(capacity=1 << 19, frontier_capacity=1 << 16)


def increment_checker(thread_count: int, locked: bool, flags="cuda"):
    """The checker ``increment[-lock] check-gpu N`` runs."""
    from .models.increment import Increment, IncrementLock

    model = (IncrementLock if locked else Increment)(thread_count)
    return _flags(flags).spawn(model, **INCREMENT_SIZES)


def _increment(sub: str, args: list[str], flags: RunFlags,
               locked: bool = False) -> None:
    from .models.increment import Increment, IncrementLock

    thread_count = int(args[0]) if args else (3 if locked else 2)
    name = "increment_lock" if locked else "increment"
    if sub == "check":
        model = (IncrementLock if locked else Increment)(thread_count)
        _check(f"Model checking {name} with {thread_count} threads.",
               model, flags)
        return
    if sub == "check-sym":
        model = (IncrementLock if locked else Increment)(thread_count)
        _check_sym(f"Model checking {name} with {thread_count} threads "
                   "using symmetry reduction.", model, flags)
        return
    if sub == "explore":
        _explore((IncrementLock if locked else Increment)(thread_count),
                 args, flags)
        return
    if sub != "check-gpu":
        _usage()
        return
    print(
        f"Model checking {name} with {thread_count} threads on the "
        f"{_where(flags)} wave engine."
    )
    _report(increment_checker(thread_count, locked, flags))


def _increment_lock(sub: str, args: list[str], flags: RunFlags) -> None:
    _increment(sub, args, flags, locked=True)


def register_checker(n_clients: int, flags="cuda"):
    """The checker ``register check-gpu N`` runs, at the JAX lane's
    sizes: the raw space is 1 + 2n·3^(n-1) states
    (models/nclient_register.py). The lane arms ``--symmetry``."""
    from .models.nclient_register import NClientRegSys

    raw = 1 + 2 * n_clients * 3 ** max(0, n_clients - 1)
    capacity = max(1 << 10, 1 << (raw - 1).bit_length())
    return _flags(flags).spawn(
        NClientRegSys(n_clients=n_clients), symmetric=True,
        capacity=capacity, frontier_capacity=max(256, capacity // 4),
    )


def _register(sub: str, args: list[str], flags: RunFlags) -> None:
    n_clients = int(args[0]) if args else 3
    if sub == "check":
        from .models.nclient_register import NClientRegSys

        _check(f"Checking the write-once register with {n_clients} "
               "clients.", NClientRegSys(n_clients=n_clients), flags)
        return
    if sub == "check-sym":
        from .models.nclient_register import NClientRegSys

        _check_sym(f"Checking the write-once register with {n_clients} "
                   "clients using symmetry reduction.",
                   NClientRegSys(n_clients=n_clients), flags)
        return
    if sub == "explore":
        from .models.nclient_register import NClientRegSys

        _explore(NClientRegSys(n_clients=n_clients), args, flags,
                 f"the write-once register with {n_clients} clients")
        return
    if sub != "check-gpu":
        _usage()
        return
    print(
        f"Checking the write-once register with {n_clients} clients on "
        f"the {_where(flags)} wave engine."
    )
    _report(register_checker(n_clients, flags))


def single_copy_checker(client_count: int, flags="cuda"):
    """The checker ``single-copy-register check-gpu N`` runs: the JAX
    lane's sizes for the hand encoding (up to 2 clients; 93 states),
    room for the compiled 3-client space (4,243) beyond."""
    from .models.single_copy_register import (
        SingleCopyRegisterCfg,
        single_copy_register_model,
    )

    cfg = SingleCopyRegisterCfg(client_count=client_count)
    sizes = (dict(capacity=256, frontier_capacity=64) if client_count <= 2
             else dict(capacity=1 << 16, frontier_capacity=1 << 14))
    return _flags(flags).spawn(single_copy_register_model(cfg), **sizes)


def _single_copy(sub: str, args: list[str], flags: RunFlags) -> None:
    client_count = int(args[0]) if args else 2
    if sub == "check":
        from .models.single_copy_register import (
            SingleCopyRegisterCfg,
            single_copy_register_model,
        )

        _check(f"Model checking a single-copy register with {client_count} "
               "clients.", single_copy_register_model(
                   SingleCopyRegisterCfg(client_count=client_count),
                   _network(args, 1)), flags)
        return
    if sub == "explore":
        from .models.single_copy_register import (
            SingleCopyRegisterCfg,
            single_copy_register_model,
        )

        _explore(single_copy_register_model(
            SingleCopyRegisterCfg(client_count=client_count),
            _network(args, 2)), args, flags,
            f"a single-copy register with {client_count} clients")
        return
    if sub == "spawn":
        from .actor.spawn import spawn_single_copy_cluster

        _spawn(flags, spawn_single_copy_cluster)
        return
    if sub != "check-gpu":
        _usage()
        return
    print(
        f"Model checking a single-copy register with {client_count} "
        f"clients on the {_where(flags)} wave engine."
    )
    _report(single_copy_checker(client_count, flags))


def _timers(sub: str, args: list[str], flags: RunFlags) -> None:
    """The pinger workload (models/timers.py, reference
    examples/timers.rs). ``check`` is the unbounded host DFS, as the
    reference runs it; on the card the pinger runs compiled and
    depth-bounded (``timers.pinger_compiled``), a library entry."""
    from .models.timers import PingerModelCfg, pinger_model

    cfg = PingerModelCfg(server_count=int(args[0]) if args else 3)
    if sub == "check":
        _check("Model checking Pingers", pinger_model(cfg, _network(args, 1)),
               flags)
        return
    if sub == "explore":
        _explore(pinger_model(cfg, _network(args, 2)), args, flags,
                 "Pingers")
        return
    _usage()


def _interaction(sub: str, args: list[str], flags: RunFlags) -> None:
    """The user-interaction model (models/interaction.py, reference
    examples/interaction.rs): ``check [DEPTH]`` is the host BFS bounded
    at DEPTH (default 30, interaction.rs:44), its properties asserted;
    ``explore [ADDRESS]`` serves the Explorer at depth 30."""
    from .models.interaction import interaction_model

    if sub == "check":
        _host_only(flags, "check")
        depth = int(args[0]) if args else 30
        checker = (
            interaction_model().checker().target_max_depth(depth).spawn_bfs()
        )
        _report(checker)
        checker.assert_properties()
        return
    if sub == "explore":
        _host_only(flags, "explore")
        address = args[0] if args else "localhost:3000"
        print(f"Exploring the interaction model on {address}.")
        interaction_model().checker().target_max_depth(30).serve(address)
        return
    _usage()


def _panic(sub: str, args: list[str], flags: RunFlags) -> None:
    """Counterpart of reference examples/panic.rs: a model whose action
    enumeration raises mid-search. The checker must surface the error to
    the caller unchanged, not hang; the lane exits non-zero if it does
    not."""
    from .model import Model, Property

    class Adder(Model):
        def init_states(self):
            return [0]

        def actions(self, state):
            if state >= 5000:
                raise RuntimeError(
                    "panic! (the examples/panic.rs trigger: action "
                    f"enumeration raised at state {state})"
                )
            return [1, 2, 3, 4, 5]

        def next_state(self, state, action):
            return state + action

        def properties(self):
            return [Property.always("true", lambda m, s: True)]

    if sub != "check":
        _usage()
        return
    _host_only(flags, "check")
    print(
        "Checking the panicking adder (examples/panic.rs): the "
        "search must fail loudly, not hang."
    )
    try:
        Adder().checker().spawn_dfs().join()
    except RuntimeError as e:
        if "panic!" not in str(e):
            raise  # an unrelated checker failure, not the trigger
        print(f"Checker propagated the panic: {e}")
        return
    raise SystemExit("ERROR: the panic did not propagate")


_MODELS = {"2pc": _2pc, "paxos": _paxos, "2pc-actors": _2pc_actors,
           "paxos-compiled": _paxos_compiled,
           "linearizable-register": _linearizable,
           "increment": _increment, "increment-lock": _increment_lock,
           "register": _register, "single-copy-register": _single_copy,
           "timers": _timers, "interaction": _interaction, "panic": _panic}


#: the subcommands of each lane, JAX's ``_MODELS`` with ``check-tpu``
#: named ``check-gpu``
SUBCOMMANDS = {
    "2pc": ("check", "check-sym", "check-gpu", "explore"),
    "2pc-actors": ("check", "check-gpu", "explore"),
    "register": ("check", "check-sym", "check-gpu", "explore"),
    "paxos": ("check", "check-gpu", "explore", "spawn"),
    "paxos-compiled": ("check", "check-gpu"),
    "increment": ("check", "check-sym", "check-gpu", "explore"),
    "increment-lock": ("check", "check-sym", "check-gpu", "explore"),
    "single-copy-register": ("check", "check-gpu", "explore", "spawn"),
    "linearizable-register": ("check", "check-gpu", "explore", "spawn"),
    "timers": ("check", "explore"),
    "interaction": ("check", "explore"),
    "panic": ("check",),
}

#: the lanes with an ``explore`` subcommand
_EXPLORE = tuple(m for m, subs in SUBCOMMANDS.items() if "explore" in subs)


def _usage() -> None:
    print("USAGE:")
    print("  python -m stateright_tpu_torch 2pc check-gpu [COUNT] "
          "[--symmetry] [--ample-set] [--unsound-ok] [--device cuda|cpu]")
    print("  python -m stateright_tpu_torch paxos check-gpu [CLIENTS 1-5] "
          "[--device cuda|cpu]")
    print("  python -m stateright_tpu_torch 2pc-actors check-gpu [COUNT] "
          "[--device cuda|cpu]")
    print("  python -m stateright_tpu_torch paxos-compiled check-gpu "
          "[CLIENTS 1-2] [--device cuda|cpu]")
    print("  python -m stateright_tpu_torch linearizable-register check-gpu "
          "[CLIENTS] [NETWORK] [--device cuda|cpu]")
    print("  python -m stateright_tpu_torch increment check-gpu "
          "[THREADS 1-8] [--device cuda|cpu]")
    print("  python -m stateright_tpu_torch increment-lock check-gpu "
          "[THREADS 1-8] [--device cuda|cpu]")
    print("  python -m stateright_tpu_torch register check-gpu "
          "[CLIENTS 1-8] [--symmetry] [--device cuda|cpu]")
    print("  python -m stateright_tpu_torch single-copy-register check-gpu "
          "[CLIENTS] [--device cuda|cpu]")
    print("       every check-gpu lane takes [--tier-hot-rows=N|auto]: at "
          "most N visited keys stay on the device, the rest spill to "
          "sorted runs in host memory (tier.py); auto sizes N by the "
          "memory plan (memplan.decide_hot_rows, 2 GiB budget)")
    print("       every check-gpu lane takes [--checkpoint-every=N|auto] "
          "[--checkpoint-path=P] [--resume] [--resume-any-sha] "
          "[--watchdog[=FACTOR]] [--degrade-on-fault] "
          "[--waves-per-sync=M]: chunks of up to M waves between host "
          "syncs (default 1), a snapshot every N chunks (checkpoint.py; "
          "default path stateright_tpu_torch.ckpt), a failed chunk "
          "retried from it, --resume continues from it")
    print("       every lane takes [--trace[=deep]] [--trace-root=DIR] "
          "[--metrics-interval=N [--metrics-path=FILE]]: a metrics_rollup "
          "JSONL line every N seconds and at exit (metrics.py; default "
          "path " + DEFAULT_METRICS_PATH + ")")
    print("  python -m stateright_tpu_torch {" + "|".join(
        m for m in _MODELS if m not in ("interaction", "panic"))
          + "} check [COUNT] [NETWORK]")
    print("       check runs the host depth-first search (NETWORK: paxos, "
          "single-copy-register, linearizable-register and timers; timers "
          "check is unbounded, as the reference runs it)")
    print("  python -m stateright_tpu_torch {" + "|".join(
        m for m, subs in SUBCOMMANDS.items() if "check-sym" in subs)
          + "} check-sym [COUNT]")
    print("       check-sym runs the host depth-first search with symmetry "
          "reduction (each state's representative(); 2pc rm=5: 665)")
    print("  python -m stateright_tpu_torch interaction check [DEPTH]")
    print("       the host breadth-first search to DEPTH (default 30), "
          "its properties asserted")
    print("  python -m stateright_tpu_torch panic check")
    print("       a model that raises mid-search: the error must "
          "propagate (exit 1 if it does not)")
    print("  python -m stateright_tpu_torch {" + "|".join(
        m for m in _EXPLORE if m != "interaction")
          + "} explore [COUNT] [ADDRESS] [NETWORK]")
    print("  python -m stateright_tpu_torch interaction explore [ADDRESS]")
    print("       explore serves the Explorer web UI over the on-demand "
          "checker (explorer/server.py; default localhost:3000)")
    print("  python -m stateright_tpu_torch {" + "|".join(
        m for m, subs in SUBCOMMANDS.items() if "spawn" in subs)
          + "} spawn")
    print("       spawn runs the lane's actors as UDP servers on "
          "127.0.0.1 from port 3000 (actor/spawn.py) until interrupted")
    print("  python -m stateright_tpu_torch serve [HOST:PORT] "
          "[--device cuda|cpu] [--explore=MODEL[,COUNT]] "
          "[--device-budget-bytes=N] "
          "[--no-warm-start] [--batch-sessions[=N]] [--batch-window-sec=S] "
          "[--snapshot-budget-bytes=N] [--metrics-interval=N "
          "[--metrics-path=FILE]]")
    print("       serve runs the resident checking service (serve.py): one "
          "process on one device, a FIFO gate over the sessions' waves, "
          "admission against a byte budget, warm start of a re-check from "
          "the finished run's snapshot, batched sessions, an optional "
          "Explorer mount; --connect=HOST:PORT on any check-gpu or check "
          "lane ships it to a running service (the service's device)")
    print("       --symmetry on 2pc/register check-gpu runs the device "
          "symmetry reduction (canonical-form fingerprints before dedup, "
          "ops/canonical.py; 2pc rm=5: 8,832 -> 314 states); --ample-set "
          "on a sparse check-gpu lane ANDs the encoding's partial-order "
          "ample mask into the enabled-bits pass (fewer interleavings, "
          "same verdicts). Both consult the reduction soundness "
          "certificate (analysis/soundness.py): uncertifiable specs "
          "refuse at spawn with the failed obligation; --unsound-ok "
          "waives the gate (no soundness guarantee)")
    print("  python -m stateright_tpu_torch analyze soundness [MODEL] "
          "[COUNT] [--no-artifact] [--device cuda|cpu]")
    print("       runs the reduction soundness analyzer over the "
          "registered targets (2pc, register), its battery on the card "
          "unless --device cpu, and writes the SOUND_r*.json certificate "
          "the engine gates consult")


def _pop_trace_flags(argv: list[str]):
    """``(level or None, artifacts' root or None, the other arguments)``:
    ``--trace`` / ``--trace=LEVEL`` and ``--trace-root=DIR`` from
    anywhere on the line. An unknown level is refused."""
    level = root = None
    rest = []
    for a in argv:
        if a == "--trace":
            level = "default"
        elif a.startswith("--trace="):
            level = a.split("=", 1)[1]
            if level not in ("default", "deep"):
                raise SystemExit(
                    f"--trace={level}: unknown level (use --trace or "
                    "--trace=deep)")
        elif a.startswith("--trace-root="):
            root = a.split("=", 1)[1]
        else:
            rest.append(a)
    return level, root, rest


#: where ``--metrics-interval`` writes its rollup lines without
#: ``--metrics-path`` (relative to the working directory)
DEFAULT_METRICS_PATH = "stateright_tpu_torch.metrics.jsonl"


def _pop_metrics_flags(argv: list[str]):
    """``(interval or None, path or None, the other arguments)``:
    ``--metrics-interval=N`` and ``--metrics-path=FILE`` from anywhere on
    the line, with the JAX CLI's refusals of a cadence that is not > 0,
    a bare ``--metrics-interval`` and a path without an interval."""
    interval = path = None
    rest = []
    for a in argv:
        if a.startswith("--metrics-interval="):
            val = a.split("=", 1)[1]
            interval = float(val)
            if interval <= 0:
                raise SystemExit(
                    f"--metrics-interval={val}: must be > 0 seconds")
        elif a == "--metrics-interval":
            raise SystemExit(
                "--metrics-interval needs a cadence: "
                "--metrics-interval=N (seconds)")
        elif a.startswith("--metrics-path="):
            path = a.split("=", 1)[1]
        else:
            rest.append(a)
    if interval is None and path is not None:
        raise SystemExit("--metrics-path requires --metrics-interval=N")
    return interval, path, rest


def _pop_connect_flag(argv: list[str]):
    """``(HOST:PORT or None, the other arguments)``: ``--connect=HOST:PORT``
    from anywhere on the line, the client mode that ships the lane to a
    resident service (serve.py) instead of running it here."""
    addr, rest = None, []
    for a in argv:
        if a.startswith("--connect="):
            addr = a.split("=", 1)[1]
        elif a == "--connect":
            raise SystemExit("--connect needs an address: --connect=HOST:PORT")
        else:
            rest.append(a)
    return addr, rest


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    connect, argv = _pop_connect_flag(argv)
    if argv and argv[0] == "serve":
        from .serve import daemon_main

        raise SystemExit(daemon_main(argv[1:]))
    if connect is not None:
        from .serve import client_main

        raise SystemExit(client_main(connect, argv))
    # the static-analysis lane: `analyze soundness [MODEL]` runs the
    # reduction soundness analyzer and writes SOUND_r*.json
    if argv and argv[0] == "analyze":
        from .analysis.soundness import analyze_main

        raise SystemExit(analyze_main(argv[1:]))
    level, root, argv = _pop_trace_flags(argv)
    interval, metrics_path, argv = _pop_metrics_flags(argv)
    flags, argv = _pop_flags(argv)
    if len(argv) < 2 or argv[0] not in _MODELS:
        _usage()
        return
    if level is None and interval is None:
        _MODELS[argv[0]](argv[1], argv[2:], flags)
        return
    from .telemetry import RunTracer, write_artifacts

    # --metrics-interval runs a tracer (the rollup is bridged from its
    # events) but writes trace artifacts only with --trace
    tracer = RunTracer(level=level or "default")
    rollup = None
    if interval is not None:
        from .metrics import Rollup, bridge_events

        def registry_now():
            with tracer._lock:
                events = list(tracer.events)
            return bridge_events(events)

        rollup = Rollup(metrics_path or DEFAULT_METRICS_PATH, interval,
                        source=registry_now).start()
    try:
        with tracer.activate():
            _MODELS[argv[0]](argv[1], argv[2:], flags)
    finally:
        if rollup is not None:
            # the final line: a run shorter than one interval leaves
            # its totals too
            rollup.stop()
        # a failed run's partial trace is the one a diagnosis needs
        if level is not None and tracer.events:
            jsonl, chrome = write_artifacts(tracer, root=root)
            print(f"trace: wrote {jsonl} + {chrome}", file=sys.stderr)
