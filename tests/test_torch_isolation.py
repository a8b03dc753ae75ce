"""The PyTorch port stands alone: importing it and running its CLI
(the 2pc and Paxos lanes, the three compiled lanes, and the increment,
increment-lock, register and single-copy-register lanes, at their
smallest size, the 2pc and register lanes with the reductions on, and
the host DFS's ``2pc check 2``, and ``2pc check-gpu 3`` with a tiered
visited set, and checkpointed and resumed, and traced with its artifacts
written, and metered with its rollup read back), a device simulation, a
hybrid race, a hash engine run, both sharded engines (parallel/) at two
shards, a batched pair of sessions (batch.py), a host BFS, a resident
service's cold and warm session (serve.py), the Explorer's views
(explorer/) and the operator tools (tools/) on the CPU loads neither jax
nor anything
of the JAX package; nor do the host layer's lanes (``check-sym``,
``interaction``, ``panic``), the compiled pinger and the UDP runtime;
and no source file of the port (nor chip_smoke.py) imports either."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "stateright_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_and_cli_load_no_jax():
    code = (
        "import sys\n"
        "import stateright_tpu_torch\n"
        "from stateright_tpu_torch.cli import main\n"
        "main(['2pc', 'check-gpu', '2', '--device', 'cpu'])\n"
        "main(['paxos', 'check-gpu', '1', '--device', 'cpu'])\n"
        "main(['2pc-actors', 'check-gpu', '2', '--device', 'cpu'])\n"
        "main(['paxos-compiled', 'check-gpu', '1', '--device', 'cpu'])\n"
        "main(['linearizable-register', 'check-gpu', '1', 'ordered',"
        " '--device', 'cpu'])\n"
        "main(['increment', 'check-gpu', '2', '--device', 'cpu'])\n"
        "main(['increment-lock', 'check-gpu', '2', '--device', 'cpu'])\n"
        "main(['register', 'check-gpu', '2', '--device', 'cpu'])\n"
        "main(['single-copy-register', 'check-gpu', '2', '--device',"
        " 'cpu'])\n"
        "main(['2pc', 'check-gpu', '3', '--symmetry', '--ample-set',"
        " '--device', 'cpu'])\n"
        "main(['register', 'check-gpu', '3', '--symmetry', '--device',"
        " 'cpu'])\n"
        "main(['2pc', 'check', '2'])\n"
        "main(['2pc', 'check-gpu', '3', '--device', 'cpu',"
        " '--tier-hot-rows=32'])\n"
        "import os, tempfile\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    p = '--checkpoint-path=' + os.path.join(d, 'iso.ckpt')\n"
        "    main(['2pc', 'check-gpu', '3', '--device', 'cpu',"
        " '--checkpoint-every=4', p])\n"
        "    main(['2pc', 'check-gpu', '3', '--device', 'cpu', '--resume',"
        " p])\n"
        "    main(['2pc', 'check-gpu', '2', '--device', 'cpu', '--trace',"
        " '--trace-root=' + d])\n"
        "    print('TRACES', sorted(f for f in os.listdir(d)"
        " if f.startswith('TRACE')))\n"
        "    m = os.path.join(d, 'm.jsonl')\n"
        "    main(['2pc', 'check-gpu', '2', '--device', 'cpu',"
        " '--metrics-interval=5', '--metrics-path=' + m])\n"
        "    from stateright_tpu_torch.metrics import load_rollup\n"
        "    f = load_rollup(m)['families']\n"
        "    print('ROLLUP', f['stpu_waves_total']['values'][0]['value'])\n"
        "from stateright_tpu_torch.models.two_phase_commit import"
        " TwoPhaseSys\n"
        "sim = TwoPhaseSys(2).checker().spawn_device_simulation("
        "n_walks=64, max_steps=8, rounds=2, device='cpu').join()\n"
        "print('SIM', sim.state_count(),"
        " sorted(sim.discovered_property_names()))\n"
        "hy = TwoPhaseSys(2).checker().spawn_hybrid(device='cpu').join()\n"
        "print('HYBRID', hy.unique_state_count(),"
        " sorted(hy.discovered_property_names()))\n"
        "h = TwoPhaseSys(3).checker().spawn_hash(capacity=1 << 10,"
        " device='cpu').join()\n"
        "print('HASH', h.unique_state_count(), h.state_count(),"
        " sorted(h.discovered_property_names()))\n"
        "ms = TwoPhaseSys(3).checker().spawn_sharded_sortmerge("
        "devices=['cpu'] * 2, capacity=1 << 10).join()\n"
        "mh = TwoPhaseSys(3).checker().spawn_sharded_hash("
        "devices=['cpu'] * 2, capacity=1 << 10).join()\n"
        "print('MESH', ms.unique_state_count(), mh.unique_state_count(),"
        " ms.metrics['shard_unique'])\n"
        "import threading\n"
        "from stateright_tpu_torch.batch import seat_sessions\n"
        "pair = [TwoPhaseSys(n).checker().spawn_sortmerge(capacity=1 << 12,"
        " device='cpu') for n in (4, 3)]\n"
        "seat_sessions(pair, max_sessions=2, window_sec=30)\n"
        "ts = [threading.Thread(target=c.join) for c in pair]\n"
        "[t.start() for t in ts]\n"
        "[t.join() for t in ts]\n"
        "print('BATCH', [c.unique_state_count() for c in pair],"
        " [c.metrics['batch_size'] for c in pair])\n"
        "b = TwoPhaseSys(3).checker().spawn_bfs().join()\n"
        "from stateright_tpu_torch.serve import CheckService\n"
        "svc = CheckService(device='cpu')\n"
        "ss = [svc.check(['2pc', 'check-gpu', '2']) for _ in range(2)]\n"
        "print('SERVE', [(x.state, x.unique, x.warm_start) for x in ss])\n"
        "from stateright_tpu_torch.explorer.server import state_views\n"
        "v, _ = state_views(TwoPhaseSys(2).checker().spawn_on_demand(),"
        " '/')\n"
        "print('EXPLORER', len(v))\n"
        "print('BFS', b.unique_state_count(), b.state_count(),"
        " sorted(b.discoveries()))\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib',"
        " 'stateright_tpu') or m.startswith(('jax.', 'jaxlib.',"
        " 'stateright_tpu.')))\n"
        "print('LOADED', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "Done. states=" in out.stdout and "unique=" in out.stdout
    assert out.stdout.count("Done. states=482, unique=265, depth=14") == 2
    assert "Done. states=114, unique=56, depth=8" in out.stdout
    assert "(compiled actor encoding)" in out.stdout
    for done in ("Done. states=15, unique=13, depth=5",
                 "Done. states=17, unique=17, depth=9",
                 "Done. states=17, unique=13, depth=5",
                 "Done. states=121, unique=93, depth=9",
                 "Done. states=270, unique=76, depth=11",
                 "Done. states=26, unique=13, depth=7"):
        assert done in out.stdout, done
    # the tiered run, the checkpointed run and its resume
    assert out.stdout.count("Done. states=1146, unique=288, depth=11") == 3
    assert "resuming from" in out.stdout and ": wave 8, depth 9" in out.stdout
    assert "TRACES ['TRACE_r01.jsonl', 'TRACE_r01.trace.json']" \
        in out.stdout
    assert "Checking two phase commit with 2 resource managers.\n" \
        "Done. states=" in out.stdout
    assert "SIM 1088 ['abort agreement', 'commit agreement']" in out.stdout
    assert "HYBRID 56 ['abort agreement', 'commit agreement']" in out.stdout
    assert "HASH 288 1146 ['abort agreement', 'commit agreement']" \
        in out.stdout
    assert "BFS 288 1146 ['abort agreement', 'commit agreement']" \
        in out.stdout
    assert "MESH 288 288 [141, 147]" in out.stdout
    assert "ROLLUP 8.0" in out.stdout
    assert "BATCH [1568, 288] [2, 2]" in out.stdout
    assert "SERVE [('done', 56, False), ('done', 56, True)]" in out.stdout
    assert "EXPLORER 1" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "LOADED []"


def test_host_layer_lanes_load_no_jax():
    """``2pc check-sym 3``, ``interaction check 6``, ``panic check``, the
    compiled pinger on both engines and a UDP ping-pong round trip in
    one process load neither jax nor the JAX package."""
    code = (
        "import sys, socket, time\n"
        "from stateright_tpu_torch.cli import main\n"
        "main(['2pc', 'check-sym', '3'])\n"
        "main(['interaction', 'check', '6'])\n"
        "main(['panic', 'check'])\n"
        "from stateright_tpu_torch.models.timers import PingerModelCfg,"
        " pinger_compiled\n"
        "m, e = pinger_compiled(PingerModelCfg(3), 4)\n"
        "runs = [getattr(m.checker().target_max_depth(4), s)(encoded=e,"
        " capacity=1 << 10, device='cpu').join().unique_state_count()"
        " for s in ('spawn_sortmerge', 'spawn_hash')]\n"
        "print('PINGER', runs)\n"
        "from stateright_tpu_torch.actor import Id\n"
        "from stateright_tpu_torch.actor.spawn import json_serde, spawn\n"
        "from stateright_tpu_torch.models.ping_pong import Ping, Pong,"
        " PingPongActor\n"
        "socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)"
        " for _ in range(2)]\n"
        "[s.bind(('127.0.0.1', 0)) for s in socks]\n"
        "ids = [Id.from_addr('127.0.0.1', s.getsockname()[1])"
        " for s in socks]\n"
        "[s.close() for s in socks]\n"
        "hs = spawn(*json_serde([Ping, Pong]), [(ids[0],"
        " PingPongActor(serve_to=ids[1])), (ids[1], PingPongActor(None))])\n"
        "end = time.monotonic() + 10\n"
        "while time.monotonic() < end and not all((h.state or 0) >= 3"
        " for h in hs):\n"
        "    time.sleep(0.02)\n"
        "[h.stop() for h in hs]\n"
        "[h.join(2) for h in hs]\n"
        "print('SPAWN', [(h.state or 0) >= 3 for h in hs])\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib',"
        " 'stateright_tpu') or m.startswith(('jax.', 'jaxlib.',"
        " 'stateright_tpu.')))\n"
        "print('LOADED', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "using symmetry reduction.\nDone. states=411, unique=107, " \
        "depth=11" in out.stdout
    assert "Done. states=23, unique=18, depth=6" in out.stdout
    assert "Checker propagated the panic: panic!" in out.stdout
    assert "PINGER [97, 97]" in out.stdout
    assert "SPAWN [True, True]" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "LOADED []"


def test_analyzer_and_gated_runs_load_no_jax():
    """``analyze soundness`` on both targets and a gated ``--symmetry
    --ample-set`` run in one process load neither jax nor the JAX
    package."""
    code = (
        "import sys\n"
        "from stateright_tpu_torch.analysis.soundness import analyze_main\n"
        "print('RC', analyze_main(['soundness', '--no-artifact',"
        " '--device', 'cpu']))\n"
        "from stateright_tpu_torch.cli import main\n"
        "main(['2pc', 'check-gpu', '3', '--symmetry', '--ample-set',"
        " '--device', 'cpu'])\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib',"
        " 'stateright_tpu') or m.startswith(('jax.', 'jaxlib.',"
        " 'stateright_tpu.')))\n"
        "print('LOADED', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "2pc (TwoPhaseSysEncoded(4)): certified" in out.stdout
    assert "register (NClientRegEncoded(4)): certified" in out.stdout
    assert "RC 0" in out.stdout
    assert "Done. states=270, unique=76, depth=11" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "LOADED []"


def test_tools_load_no_jax(tmp_path):
    """The operator tools (stateright_tpu_torch/tools/) in one process:
    a traced run, then ``tools.trace_diff`` and ``tools.latency_report``
    over its trace, load neither jax nor the JAX package."""
    code = (
        "import sys\n"
        "from stateright_tpu_torch.cli import main\n"
        f"main(['2pc', 'check-gpu', '2', '--device', 'cpu', '--trace',"
        f" '--trace-root={tmp_path}'])\n"
        "from stateright_tpu_torch.tools import latency_report, trace_diff\n"
        f"t = '{tmp_path / 'TRACE_r01.jsonl'}'\n"
        "print('DIFF', trace_diff.main([t, t]))\n"
        "print('LATENCY', latency_report.main([t]))\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib',"
        " 'stateright_tpu') or m.startswith(('jax.', 'jaxlib.',"
        " 'stateright_tpu.')))\n"
        "print('LOADED', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "verdict: OK" in out.stdout and "DIFF 0" in out.stdout
    assert "time to verdict" in out.stdout and "LATENCY 0" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "LOADED []"


def test_no_jax_imports_in_port_sources():
    files = sorted((ROOT / "stateright_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    names = {p.relative_to(ROOT).as_posix() for p in files}
    for module in ("checkers/dfs.py", "checkers/hybrid.py",
                   "checkers/tpu_simulation.py", "visitor.py",
                   "checkers/bfs.py", "checkers/on_demand.py",
                   "checkers/simulation.py", "fixtures.py",
                   "occupancy.py", "ops/hashset.py", "memplan.py",
                   "tier.py", "checkpoint.py", "faultinject.py",
                   "parallel/__init__.py", "parallel/exchange.py",
                   "parallel/shards.py", "parallel/engine_sortmerge.py",
                   "parallel/engine.py", "telemetry.py", "artifacts.py",
                   "batch.py", "metrics.py", "serve.py",
                   "explorer/__init__.py", "explorer/server.py",
                   "symmetry.py", "utils/densenatmap.py",
                   "utils/vector_clock.py", "semantics/vec.py",
                   "semantics/write_once_register.py",
                   "semantics/sequential_consistency.py",
                   "models/timers.py", "models/interaction.py",
                   "actor/choice.py", "actor/ordered_reliable_link.py",
                   "actor/write_once_register.py", "actor/spawn.py",
                   "analysis/__init__.py", "analysis/rules.py",
                   "analysis/walker.py", "analysis/soundness.py",
                   "analysis/registry.py", "tools/__init__.py",
                   "tools/crash_matrix.py", "tools/serve_loadtest.py",
                   "tools/trace_diff.py", "tools/slo_report.py",
                   "tools/serve_report.py", "tools/latency_report.py",
                   "tools/shard_report.py", "tools/mem_report.py"):
        assert f"stateright_tpu_torch/{module}" in names, module
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} {bad}"
