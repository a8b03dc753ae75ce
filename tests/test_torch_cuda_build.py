"""The build and load of the port's CUDA libraries (ops/cuda_build.py) on
the CPU, with no nvcc and no card needed.

One lock serializes each source's build and load: threads whose first
launch lands together get one consistent error where nvcc is missing,
and where a build runs, exactly one of them runs it while the others
find its library loaded. The load tiers a ``program_build`` event
carries (``disk``, then ``in_process``), and one event a source a run for each of two concurrent
sessions' tracers — the port's counterpart of JAX
``tests/test_serve.py:315``, where a second in-process check finds its
programs ``in_process``. A shared library of the system stands in for a
built kernel library."""

import ctypes.util
import os
import threading
from pathlib import Path

import pytest

from stateright_tpu_torch import telemetry
from stateright_tpu_torch.ops import cuda_build

#: seconds a thread may take
TIMEOUT = 60
THREADS = 8


@pytest.fixture
def clean_table(monkeypatch, tmp_path):
    """An empty table of loaded libraries and an empty build directory,
    restored afterwards."""
    saved = dict(cuda_build._LOADED)
    cuda_build._LOADED.clear()
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    yield tmp_path
    cuda_build._LOADED.clear()
    cuda_build._LOADED.update(saved)


def _on_threads(fn, n=THREADS):
    """``fn()`` on ``n`` threads released together by a barrier: each
    thread's result or exception, in thread order."""
    barrier = threading.Barrier(n, timeout=TIMEOUT)
    out = [None] * n

    def run(i):
        barrier.wait()
        try:
            out[i] = ("ok", fn())
        except Exception as exc:
            out[i] = ("raised", exc)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    return out


def test_concurrent_first_loads_without_nvcc_fail_alike(clean_table,
                                                        monkeypatch):
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed at /usr/local/cuda")
    out = _on_threads(lambda: cuda_build.load("merge_path.cu"))
    assert [kind for kind, _ in out] == ["raised"] * THREADS
    msgs = {str(exc) for _, exc in out}
    assert len(msgs) == 1 and "nvcc not found" in msgs.pop()
    assert "merge_path.cu" not in cuda_build._LOADED
    assert not list(clean_table.glob("kernels/*"))


def test_one_thread_builds_the_rest_load_it(clean_table, monkeypatch):
    """The build (a stand-in that writes the library) runs once under
    the lock; every thread gets the one loaded library."""
    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no C library to stand in for a kernel library")
    built = []

    def fake_start(name):
        built.append(name)
        return "pending"

    def fake_finish(name, pending):
        assert pending == "pending"
        cuda_build.BUILD_SECONDS[name] = 0.5

    monkeypatch.setattr(cuda_build, "start_build", fake_start)
    monkeypatch.setattr(cuda_build, "finish_build", fake_finish)
    monkeypatch.setattr(cuda_build, "library_path",
                        lambda name: Path(libc))
    out = _on_threads(lambda: cuda_build.load_timed("merge_path.cu"))
    assert built == ["merge_path.cu"]
    libs = {id(res[0]) for kind, res in out}
    assert [kind for kind, _ in out] == ["ok"] * THREADS and len(libs) == 1
    tiers = sorted(res[1] for _, res in out)
    assert tiers == ["cold"] + ["in_process"] * (THREADS - 1)


def test_load_tiers_and_eviction(clean_table, monkeypatch):
    """``disk`` on the first load of a built library, ``in_process``
    after: nothing evicts a loaded library, which stays loaded for the
    life of the process."""
    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no C library to stand in for a kernel library")
    monkeypatch.setattr(cuda_build, "start_build", lambda name: None)
    monkeypatch.setattr(cuda_build, "library_path",
                        lambda name: Path(libc))
    tiers = [cuda_build.load_timed("merge_path.cu")[1] for _ in range(3)]
    assert tiers == ["disk", "in_process", "in_process"]


def test_one_build_event_a_source_a_run_for_each_tracer(clean_table,
                                                        monkeypatch):
    """Two sessions' tracers, their loads interleaved as concurrent
    waves interleave: each run records one ``program_build`` of the
    source (its tier the first load's), however often the other run
    loaded it in between; a second run of one tracer records its own."""
    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no C library to stand in for a kernel library")
    monkeypatch.setattr(cuda_build, "start_build", lambda name: None)
    monkeypatch.setattr(cuda_build, "library_path",
                        lambda name: Path(libc))
    a, b = telemetry.RunTracer(), telemetry.RunTracer()
    a.begin_run()
    b.begin_run()
    for _ in range(3):
        for tr in (a, b):
            with tr.activate_thread():
                cuda_build.load("merge_path.cu")
    a.end_run()
    a.begin_run()
    with a.activate_thread():
        cuda_build.load("merge_path.cu")

    def builds(tr):
        return [(e["run"], e["tier"]) for e in tr.events
                if e["ev"] == "program_build"]

    assert builds(a) == [(0, "disk"), (1, "in_process")]
    assert builds(b) == [(0, "in_process")]
