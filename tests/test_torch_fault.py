"""Supervised fault recovery of the PyTorch port (``fault`` marker).

The policy functions of stateright_tpu_torch/checkpoint.py and
faultinject.py give the JAX package's outputs over the inputs of the JAX
``tests/test_fault.py`` (the classification table, the watchdog
deadline, the auto cadence, the fault specs); on the CPU a mid-wave
fault recovers in one join, the watchdog sees an injected hang and
recovers from the snapshot or refuses loudly without one, a wave it
abandoned writes nothing to the retry when it finishes late, repeated
OOMs degrade the dense wave, and neither an engine overflow nor a
sticky CUDA error is retried. On the sharded engines (parallel/, S = 2
on ``["cpu"] * 2``): a persistent shard fault under
``degrade_on_fault`` drops its shard and finishes at S = 1 with the
host count (JAX ``tests/test_fault.py:259``: counts, warning, the
``fault_degrade`` event and no divergence of its trace from the
uninterrupted run's), the degrade
needs opt-in (:305), and a ``collective_seam`` raise recovers (:323).
"""

import threading
import warnings

import pytest
import torch

from stateright_tpu_torch import checkpoint, faultinject
from stateright_tpu_torch.checkpoint import (
    WatchdogTimeout,
    auto_cadence,
    classify_failure,
    is_supervised_fault,
    watchdog_deadline,
)
from stateright_tpu_torch.checkers.tpu_sortmerge import SortMergeTpuBfsChecker
from stateright_tpu_torch.faultinject import InjectedFault, InjectedShardFault
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

pytestmark = pytest.mark.fault


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    faultinject.disarm_all()


def _twopc3(**kw):
    return TwoPhaseSys(rm_count=3).checker().spawn_sortmerge(
        capacity=1 << 10, device="cpu", **kw)


# -- the policy functions equal JAX's -----------------------------------------


def _failures(faults):
    """The JAX test's failure inputs, built from ``faults`` (either
    package's faultinject) and its watchdog class."""
    return [
        ("watchdog", lambda m: m.WatchdogTimeout(3, 5.0)),
        ("memory", lambda m: MemoryError()),
        ("exhausted", lambda m: RuntimeError("RESOURCE_EXHAUSTED: hbm")),
        ("shard", lambda m: faults.InjectedShardFault("mid_chunk", 2, 5)),
        ("injected", lambda m: faults.InjectedFault("mid_chunk", 2)),
        ("value error", lambda m: ValueError("no")),
        ("overflow", lambda m: RuntimeError(
            "visited table overflow (capacity=64); re-run with a larger "
            "capacity")),
    ]


def test_classification_table_equals_jax():
    from stateright_tpu import checkpoint as jax_ckpt
    from stateright_tpu import faultinject as jax_faults

    port = {name: make(checkpoint) for name, make in _failures(faultinject)}
    jax = {name: make(jax_ckpt) for name, make in _failures(jax_faults)}
    for name, exc in port.items():
        jexc = jax[name]
        assert classify_failure(exc) == jax_ckpt.classify_failure(jexc), name
        assert is_supervised_fault(exc) == \
            jax_ckpt.is_supervised_fault(jexc), name
    assert classify_failure(WatchdogTimeout(3, 5.0)) == ("hang", None)
    assert classify_failure(InjectedShardFault("mid_chunk", 2, 5)) == (
        "shard_fault", 5)
    assert classify_failure(ValueError("no")) == ("unsupervised", None)


def test_torch_failures_classify():
    """A CUDA OOM is ``oom`` and supervised; a sticky CUDA error (the
    context is poisoned) and an engine overflow are not supervised."""
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")
    assert classify_failure(oom) == ("oom", None)
    assert is_supervised_fault(oom)
    for msg in ("CUDA error: an illegal memory access was encountered",
                "CUDA error: device-side assert triggered"):
        assert not is_supervised_fault(RuntimeError(msg)), msg
        assert classify_failure(RuntimeError(msg)) == ("unsupervised", None)


@pytest.mark.parametrize("args,kw", [
    ((None, 8.0), {}),
    ((None, 8.0), dict(first_grace_sec=42.0)),
    ((0.0, 8.0), {}),
    ((1.0, 8.0), {}),
    ((0.01, 8.0), {}),
    ((1000.0, 8.0), {}),
    ((0.01, 8.0), dict(floor_sec=0.25, cap_sec=10.0)),
])
def test_watchdog_deadline_equals_jax(args, kw):
    from stateright_tpu import checkpoint as jax_ckpt

    assert watchdog_deadline(*args, **kw) == \
        jax_ckpt.watchdog_deadline(*args, **kw)


def test_watchdog_deadline_refuses_a_zero_factor():
    with pytest.raises(ValueError):
        watchdog_deadline(1.0, 0)


def test_auto_cadence_equals_jax():
    from stateright_tpu import checkpoint as jax_ckpt

    for snap, wave in ((0.0, 1.0), (None, 1.0), (1.0, 0.0), (0.01, 0.1),
                       (0.5, 0.01), (2.0, 0.001), (0.001, 1.0),
                       (0.25, 0.0101)):
        assert auto_cadence(snap, wave) == jax_ckpt.auto_cadence(snap, wave)


def test_parse_spec_equals_jax():
    from stateright_tpu import faultinject as jax_faults

    for spec in ("kill@chunk_boundary:2", "raise@mid_chunk:1",
                 "hang@mid_chunk:1:20", "hang@mid_chunk:1",
                 "shard_fault@mid_chunk:2:3", "raise@collective_seam:0"):
        assert faultinject.parse_spec(spec) == jax_faults.parse_spec(spec)
    for bad in ("raise@mid_chunk:1:9", "hang@bogus_site:1", "nope@mid_chunk:1",
                "raise@mid_chunk", "raise@mid_chunk:1:2:3"):
        with pytest.raises(ValueError):
            faultinject.parse_spec(bad)
        with pytest.raises(ValueError):
            jax_faults.parse_spec(bad)
    assert faultinject.chunk_for_seed(7, 13) == jax_faults.chunk_for_seed(
        7, 13)
    assert faultinject.KILL_EXIT_CODE == jax_faults.KILL_EXIT_CODE


# -- supervision on the engines -----------------------------------------------


@pytest.mark.parametrize("engine", ["sortmerge", "hash"])
def test_mid_wave_fault_recovers_in_one_join(tmp_path, engine):
    """A mid-wave fault retries from the last snapshot in the same join:
    one recovery warning, the uninterrupted count and fingerprints."""
    def spawn(**kw):
        builder = TwoPhaseSys(rm_count=4).checker()
        if engine == "hash":
            return builder.spawn_hash(capacity=1 << 12, device="cpu", **kw)
        return builder.spawn_sortmerge(capacity=1 << 12, device="cpu", **kw)

    base = spawn().join()
    c = spawn(checkpoint_every=1, checkpoint_path=str(tmp_path / "m.ckpt"))
    c.retry_backoff_sec = 0.01
    faultinject.arm("raise", "mid_chunk", 4)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        c.join()
    assert c.unique_state_count() == 1568
    assert c.discovery_fingerprints() == base.discovery_fingerprints()
    assert c.state_count() == base.state_count()
    rec = [x for x in w if "supervised recovery" in str(x.message)]
    assert len(rec) == 1 and "snapshot m.ckpt" in str(rec[0].message)
    assert c.metrics["fault_recoveries"] == 1


def test_fault_before_the_first_snapshot_retries_from_init(tmp_path):
    c = _twopc3(checkpoint_every=4, checkpoint_path=str(tmp_path / "s.ckpt"))
    c.retry_backoff_sec = 0.01
    faultinject.arm("raise", "mid_chunk", 1)
    with pytest.warns(RuntimeWarning, match="from the init states"):
        c.join()
    assert c.unique_state_count() == 288


def test_unsupervised_without_checkpoints():
    """No snapshot and no checkpointing: the fault raises through."""
    c = _twopc3()
    faultinject.arm("raise", "mid_chunk", 1)
    with pytest.raises(InjectedFault):
        c.join()


def test_engine_overflow_is_not_supervised(tmp_path):
    c = TwoPhaseSys(rm_count=4).checker().spawn_sortmerge(
        capacity=1 << 11, frontier_capacity=64, device="cpu",
        checkpoint_every=1, checkpoint_path=str(tmp_path / "ovf.ckpt"))
    c.retry_backoff_sec = 0.01
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with pytest.raises(RuntimeError, match="frontier overflow"):
            c.join()
    assert not [x for x in w if "supervised" in str(x.message)]


def test_sticky_cuda_error_is_not_retried(tmp_path, monkeypatch):
    calls = []

    def poisoned(self, *a, **kw):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(SortMergeTpuBfsChecker, "_waves", poisoned)
    c = _twopc3(checkpoint_every=1, checkpoint_path=str(tmp_path / "x.ckpt"))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        c.join()
    assert calls == [1]


def test_repeated_oom_degrades_the_dense_wave(tmp_path, monkeypatch):
    """Two OOMs: each retried, the allocator cache emptied, then the dense
    chunk budget halved; the third attempt completes."""
    real = SortMergeTpuBfsChecker._waves
    calls = []

    def flaky(self, *a, **kw):
        calls.append(self.dense_chunk_bytes)
        if len(calls) <= 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return real(self, *a, **kw)

    monkeypatch.setattr(SortMergeTpuBfsChecker, "_waves", flaky)
    c = _twopc3(sparse=False, checkpoint_every=1,
                checkpoint_path=str(tmp_path / "o.ckpt"))
    c.retry_backoff_sec = 0.01
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        c.join()
    assert c.unique_state_count() == 288
    assert calls == [1 << 32, 1 << 32, 1 << 31]
    msgs = [str(x.message) for x in w]
    assert sum("supervised recovery [oom]" in m for m in msgs) == 2
    assert any("dense_chunk_bytes" in m for m in msgs)


def _hang(c, hang_sec=3.0):
    c.retry_backoff_sec = 0.01
    c.watchdog_factor = 2.0
    c.watchdog_floor_sec = 0.3
    c.watchdog_grace_sec = 15.0
    faultinject.arm("hang", "mid_chunk", 2, hang_sec=hang_sec)


@pytest.mark.parametrize("engine", ["sortmerge", "hash"])
def test_watchdog_hang_recovers_from_snapshot(tmp_path, engine):
    """An injected hang (nothing raises; only the watchdog sees it) passes
    the derived deadline and the run recovers from its snapshot."""
    builder = TwoPhaseSys(rm_count=3).checker()
    spawn = builder.spawn_hash if engine == "hash" else builder.spawn_sortmerge
    c = spawn(capacity=1 << 10, device="cpu", checkpoint_every=1,
              checkpoint_path=str(tmp_path / "wd.ckpt"))
    _hang(c)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        c.join()
    assert c.unique_state_count() == 288
    assert any("supervised recovery [hang]" in str(x.message) for x in w)


@pytest.mark.parametrize("release", ["during_the_retry", "after_the_join"])
@pytest.mark.parametrize("engine", ["sortmerge", "hash"])
def test_abandoned_wave_writes_nothing_to_the_retry(tmp_path, monkeypatch,
                                                    engine, release):
    """A wave that stalls inside its sync (after its attempt-token check)
    past the watchdog's deadline, and then finishes — while the retry
    runs, or after the run ended — changes none of the retry's counts or
    discoveries."""
    from stateright_tpu_torch.checkers import tpu, tpu_sortmerge

    builder = TwoPhaseSys(rm_count=3).checker()
    spawn = builder.spawn_hash if engine == "hash" else builder.spawn_sortmerge
    base = spawn(capacity=1 << 10, device="cpu").join()
    # the wave's sync: the member test (one a wave), or the insert (one for
    # the init states, then one a wave); the stall is in wave 2
    module, name, stall_at = ((tpu, "insert", 4) if engine == "hash"
                              else (tpu_sortmerge, "member_keys", 3))
    real = getattr(module, name)
    calls = []
    stalled = {}
    go = threading.Event()

    def sync(*a, **kw):
        calls.append(1)
        if len(calls) == stall_at:
            stalled["thread"] = threading.current_thread()
            assert go.wait(30)
        elif (len(calls) == stall_at + 1 and release == "during_the_retry"):
            # the retry's first wave: the abandoned one finishes first
            go.set()
            stalled["thread"].join(30)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, sync)
    c = spawn(capacity=1 << 10, device="cpu", checkpoint_every=1,
              checkpoint_path=str(tmp_path / "ab.ckpt"))
    c.retry_backoff_sec = 0.01
    c.watchdog_factor = 2.0
    c.watchdog_floor_sec = 0.5
    c.watchdog_grace_sec = 15.0
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        c.join()
    go.set()
    stalled["thread"].join(30)
    assert not stalled["thread"].is_alive()
    assert [str(x.message) for x in w
            if "supervised recovery" in str(x.message)] != []
    assert c.metrics["fault_recoveries"] == 1
    assert (c.unique_state_count(), c.state_count(), c.max_depth()) == (
        base.unique_state_count(), base.state_count(), base.max_depth())
    assert c.discovery_fingerprints() == base.discovery_fingerprints()


def test_watchdog_refuses_loudly_without_a_snapshot():
    c = _twopc3()
    _hang(c)
    with pytest.raises(WatchdogTimeout) as ei:
        c.join()
    assert ei.value.chunk == 2
    assert 0.3 <= ei.value.deadline_sec <= 15.0
    assert ei.value.attribution["factor"] == 2.0


# -- the CLI's flags -------------------------------------------------------


def test_cli_runtime_flags():
    """The checkpoint, watchdog, shard-degrade and straggler flags parse
    as JAX's do and land on a spawned engine (the degrade and the
    straggler detector are harmless on one device); a straggler factor
    of 1 or less refuses; ``check`` refuses them all."""
    from stateright_tpu_torch.cli import _pop_flags, main

    flags, rest = _pop_flags(["2pc", "check-gpu", "3", "--watchdog=6",
                              "--checkpoint-every=auto",
                              "--checkpoint-path=/tmp/x.ckpt"])
    assert rest == ["2pc", "check-gpu", "3"]
    assert (flags.watchdog, flags.checkpoint_every, flags.checkpoint_path,
            flags.resume) == (6.0, "auto", "/tmp/x.ckpt", False)
    c = flags.spawn(TwoPhaseSys(rm_count=3), capacity=1 << 10)
    assert (c.watchdog_factor, c.checkpoint_every, c.checkpoint_path) == (
        6.0, "auto", "/tmp/x.ckpt")
    assert _pop_flags(["--watchdog"])[0].watchdog == 8.0
    flags = _pop_flags(["--degrade-on-fault", "--device", "cpu"])[0]
    c = flags.spawn(TwoPhaseSys(rm_count=3), capacity=1 << 10)
    assert c.degrade_on_fault and not c._can_degrade_shards()
    assert c.join().unique_state_count() == 288
    flags = _pop_flags(["--resume-any-sha"])[0]
    assert flags.resume and flags.resume_any_sha
    flags = _pop_flags(["--straggler-factor=4", "--device", "cpu"])[0]
    c = flags.spawn(TwoPhaseSys(rm_count=3), capacity=1 << 10)
    assert c.straggler_factor == 4.0
    assert c.join().unique_state_count() == 288
    with pytest.raises(SystemExit, match="apply to check-gpu"):
        main(["2pc", "check", "3", "--straggler-factor=4"])
    for bad, match in (("--watchdog=0", "must be > 0"),
                       ("--checkpoint-every=0", "must be >= 1"),
                       ("--straggler-factor=1", "must be > 1")):
        with pytest.raises(SystemExit, match=match):
            _pop_flags([bad])
    with pytest.raises(SystemExit, match="apply to check-gpu"):
        main(["2pc", "check", "3", "--resume"])


# -- the shard degrade (the sharded engines) ----------------------------------

HOST_2PC4 = 1568


def _mesh2pc4(S, **kw):
    return TwoPhaseSys(rm_count=4).checker().spawn_sharded_sortmerge(
        devices=["cpu"] * S, capacity=1 << 11, frontier_capacity=512, **kw)


def test_failure_policy_equals_jax():
    """Strikes, the persistence threshold and the victim pick equal
    JAX's ``FailurePolicy`` over one failure sequence, and the
    straggler attribution of ``classify_failure`` equals JAX's."""
    from stateright_tpu import checkpoint as jax_ckpt
    from stateright_tpu import faultinject as jax_faults

    seq = [(lambda f: f.InjectedShardFault("mid_chunk", 1, 1), ()),
           (lambda f: f.InjectedFault("mid_chunk", 2), (3,)),
           (lambda f: f.InjectedFault("mid_chunk", 2), (0, 3)),
           (lambda f: f.InjectedShardFault("mid_chunk", 3, 3), ()),
           (lambda f: MemoryError(), (1,))]
    port, jax = checkpoint.FailurePolicy(2), jax_ckpt.FailurePolicy(2)
    for make, stragglers in seq:
        assert port.classify(make(faultinject), stragglers) == \
            jax.classify(make(jax_faults), stragglers)
        assert port.should_degrade() == jax.should_degrade()
        assert port.strikes == jax.strikes
    port.degraded(3)
    jax.degraded(3)
    assert (port.history, port.strikes, port.should_degrade()) == (
        jax.history, jax.strikes, jax.should_degrade())
    with pytest.raises(ValueError):
        checkpoint.FailurePolicy(0)


def test_persistent_shard_fault_degrades_and_continues(tmp_path):
    from stateright_tpu_torch import telemetry

    tr_base = telemetry.RunTracer()
    with tr_base.activate():
        base = _mesh2pc4(2).join()
    assert base.unique_state_count() == HOST_2PC4
    telemetry.validate_events(tr_base.events)
    c = _mesh2pc4(2, checkpoint_every=1,
                  checkpoint_path=str(tmp_path / "deg.ckpt"))
    c.degrade_on_fault = True
    c.retry_backoff_sec = 0.01
    faultinject.arm("shard_fault", "mid_chunk", 1, shard=1)
    tr = telemetry.RunTracer()
    with tr.activate(), warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        c.join()
    telemetry.validate_events(tr.events)
    deg = [e for e in tr.events if e["ev"] == "fault_degrade"]
    assert len(deg) == 1 and (deg[0]["from_shards"], deg[0]["to_shards"],
                              deg[0]["excluded_shard"],
                              deg[0]["reason"]) == (2, 1, 1, "shard_fault")
    # the degrade-aware alignment: the global counters exact
    rep = telemetry.diff_traces(tr_base.events, tr.events)
    assert rep["degrades_b"] and not rep["degrades_a"]
    assert not rep["divergences"], rep["divergences"]
    assert rep["ok"]
    assert (c.unique_state_count(), c.state_count(), c.max_depth()) == (
        base.unique_state_count(), base.state_count(), base.max_depth())
    assert c.discovered_property_names() == base.discovered_property_names()
    assert c.n_shards == 1 and c._shard_ids == (0,)
    assert len(c.devices) == 1 and c.metrics["n_shards"] == 1
    msgs = [str(x.message) for x in w]
    assert any("DEGRADING: dropping shard 1 (2 -> 1 shards)" in m
               for m in msgs), msgs
    assert c.metrics["shard_degrades"] == 1
    for name, path in c.discoveries().items():
        prop = c.model.property_by_name(name)
        assert prop.condition(c.model, path.last_state())


def test_degrade_needs_opt_in(tmp_path):
    c = _mesh2pc4(2, checkpoint_every=1,
                  checkpoint_path=str(tmp_path / "nodeg.ckpt"))
    c.retry_backoff_sec = 0.01
    c.max_fault_retries = 2
    faultinject.arm("shard_fault", "mid_chunk", 1, shard=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(InjectedShardFault):
            c.join()
    assert c.n_shards == 2


def test_collective_seam_raise_recovers(tmp_path):
    c = _mesh2pc4(2, checkpoint_every=1,
                  checkpoint_path=str(tmp_path / "coll.ckpt"))
    c.retry_backoff_sec = 0.01
    faultinject.arm("raise", "collective_seam", 1, once=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        c.join()
    assert c.unique_state_count() == HOST_2PC4
    assert c.metrics["fault_recoveries"] == 1
    # the site is the exchange's: a one-device run never reaches it
    faultinject.arm("raise", "collective_seam", 0, once=True)
    assert _twopc3().join().unique_state_count() == 288
    assert faultinject.armed()
