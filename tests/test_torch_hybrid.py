"""The PyTorch port's hybrid racer (checkers/hybrid.py) on the CPU: the
four JAX hybrid pins (tests/test_hybrid.py) with the port engine's
kwargs, the sort-merge engine's cancel point, and the port's stricter
device rules — the device is checked before the race starts, and a
device error during the race is raised even when the host won."""

import threading
import warnings

import pytest
import torch

KW = dict(capacity=1 << 16, frontier_capacity=1 << 12, track_paths=False,
          device="cpu")


def test_hybrid_shallow_bug_matches_jax_dfs():
    from stateright_tpu.models.increment import Increment as JaxIncrement
    from stateright_tpu_torch.models.increment import Increment

    host = JaxIncrement(thread_count=4).checker().spawn_dfs().join()
    hy = Increment(thread_count=4).checker().spawn_hybrid(**KW).join()
    assert hy.winner in ("host", "device")
    assert hy.discovered_property_names() == set(host.discoveries())
    if hy.winner == "host":
        # a host win gives the replayable path, the JAX DFS's own
        assert hy.discovery("fin").encode() == host.discovery("fin").encode()


class _Panicking:
    def actions(self, state):
        raise RuntimeError("panic! (host-only model error)")


class _OutOfMemory:
    def actions(self, state):
        raise MemoryError("host trace tuples exhausted RAM")


def _increment(mixin):
    from stateright_tpu_torch.models.increment import Increment

    return type("Model", (mixin, Increment), {})(thread_count=4)


def test_hybrid_does_not_mask_host_panic():
    with pytest.raises(RuntimeError, match="refusing to mask") as err:
        _increment(_Panicking).checker().spawn_hybrid(**KW).join()
    assert "panic!" in str(err.value.__cause__)


def test_hybrid_host_oom_adopts_the_device_result():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        hy = _increment(_OutOfMemory).checker().spawn_hybrid(**KW).join()
    assert hy.winner == "device"
    assert any("ran out of memory" in str(x.message)
               and x.category is RuntimeWarning for x in w)
    assert hy.discovered_property_names() == {"fin"}


def test_hybrid_full_verification_matches_jax():
    """Whichever side wins, 2pc rm=5 gives the pinned 8,832 and the JAX
    DFS's property set, with paths that replay."""
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as Jax2pc
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    host = Jax2pc(rm_count=5).checker().spawn_dfs().join()
    hy = TwoPhaseSys(rm_count=5).checker().spawn_hybrid(
        capacity=1 << 14, frontier_capacity=1 << 11, device="cpu").join()
    assert hy.unique_state_count() == host.unique_state_count() == 8832
    assert sorted(hy.discoveries()) == sorted(host.discoveries())
    hy.assert_properties()


def test_sortmerge_cancel_point():
    """A cancel event set before the run stops the engine at the top of
    its first wave: ``cancelled``, no wave, the init counts, no paths."""
    from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

    c = TwoPhaseSys(rm_count=3).checker().spawn_sortmerge(device="cpu")
    c.cancel_event = threading.Event()
    c.cancel_event.set()
    c.join()
    assert c.cancelled and c.metrics["waves"] == 0
    assert c.unique_state_count() == c.state_count() == 1
    assert c.discoveries() == {}
    # unset, the same engine runs to the end as before
    plain = TwoPhaseSys(rm_count=3).checker().spawn_sortmerge(device="cpu")
    plain.cancel_event = threading.Event()
    assert plain.unique_state_count() == 288 and not plain.cancelled


def test_device_error_is_raised_even_when_the_host_wins(monkeypatch):
    """The device side waits for the host to claim the win, then
    raises: the hybrid raises the device's error, never the host's
    result."""
    from stateright_tpu_torch.checkers import tpu_sortmerge
    from stateright_tpu_torch.models.increment import Increment

    def failing_run(self, reporter=None):
        assert self.cancel_event.wait(60), "the host never won"
        raise RuntimeError("device kernel failed")

    monkeypatch.setattr(tpu_sortmerge.SortMergeTpuBfsChecker, "_run",
                        failing_run)
    hy = Increment(thread_count=3).checker().spawn_hybrid(**KW)
    with pytest.raises(RuntimeError, match="device kernel failed"):
        hy.join()
    assert hy.winner == "host"


def test_no_device_raises_before_the_race():
    """Without a CUDA device the default device side raises before the
    host thread starts: no host result stands in for the card."""
    from stateright_tpu_torch.models.increment import Increment

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    visits = []
    builder = Increment(thread_count=3).checker().visitor(
        lambda m, p: visits.append(p))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        builder.spawn_hybrid(capacity=1 << 12).join()
    assert visits == []
    # a staged snapshot is read only when the race builds its device
    # side, after the device check: no card, no read, no host run
    hy = builder.spawn_hybrid()
    hy.resume_from("snapshot")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hy.join()
    assert visits == []
