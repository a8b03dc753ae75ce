"""Build the hand-written CUDA sources under ``csrc/`` and load them.

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, bound with :mod:`ctypes` (no PyTorch headers, so a build
takes seconds). Libraries land in ``build/kernels/`` at the repository
root (listed in ``.gitignore``), named by a hash of the source and the
flags, so an edited source rebuilds and an unchanged one loads. The
build runs on first use, never at import: machines without ``nvcc``
(CPU-only test runs) import every module of the package.

    python -m stateright_tpu_torch.ops.cuda_build [merge_path.cu ...]

compiles the sources once more with ``-Xptxas -v`` and prints each
kernel's registers, shared memory and spills.

A traced run (telemetry.py) records one ``program_build`` event per
source the first time the run loads it, in place of the JAX package's
XLA compile-cache ledger: tier ``cold`` where nvcc ran (``wall_sec`` and
``cold_sec`` are its seconds, :data:`BUILD_SECONDS`), ``disk`` where a
built library was loaded from ``build/kernels/``, ``in_process`` where
the process had it loaded already.

One lock serializes the build and the load of every source, so two
threads whose first launch lands together (two sessions of the resident
service, serve.py) neither both run nvcc nor load a library another is
still writing; a thread that finds the library loaded takes no lock.
A loaded library stays loaded for the life of the process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
import weakref
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: dict = {}
#: held around each source's build and load (see the module docstring)
_LOAD_LOCK = threading.Lock()
#: seconds spent in nvcc per source name, for the smoke report.
BUILD_SECONDS: dict = {}
#: tracer -> {source name: the run index its last ``program_build`` of
#: that source went to}: one event a source a run, for each of the
#: tracers of concurrent sessions (serve.py) alike
_TRACED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


#: the launches recorded into the CUDA graph being captured on this
#: thread (wrapper -> count), or None when nothing is being captured
_CAPTURE = threading.local()


def note_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel: at once when it ran,
    or, while a CUDA graph is being captured (:func:`capturing`), into
    the capture's tally, which :func:`replayed` adds at each replay —
    a captured launch runs only when its graph is replayed."""
    tally = getattr(_CAPTURE, "tally", None)
    if tally is None:
        wrapper.launches += 1
    else:
        tally[wrapper] = tally.get(wrapper, 0) + 1


class capturing:
    """``with capturing() as tally:`` — launches noted inside are the
    graph's (``tally``: wrapper -> launches a replay)."""

    def __enter__(self) -> dict:
        self.tally = _CAPTURE.tally = {}
        return self.tally

    def __exit__(self, *exc) -> None:
        _CAPTURE.tally = None


def replayed(tally: dict) -> None:
    """One replay of a graph whose capture noted ``tally``."""
    for wrapper, n in tally.items():
        wrapper.launches += n


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build with the CUDA toolkit "
        "(put nvcc on PATH)"
    )


def library_path(name: str) -> Path:
    src = (CSRC / name).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(name).stem}-{digest.hexdigest()[:16]}.so"


def start_build(name: str):
    """Start ``nvcc`` on ``csrc/<name>`` unless its library exists, and
    return the pending build for :func:`finish_build` (None when there is
    nothing to build). Lets a caller build several sources in parallel."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / name)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out, time.monotonic()


def finish_build(name: str, pending) -> None:
    """Wait for a build from :func:`start_build` and install its library
    (atomically, so a concurrent loader never sees half a file)."""
    if pending is None:
        return
    proc, tmp, out, t0 = pending
    log, _ = proc.communicate()
    BUILD_SECONDS[name] = time.monotonic() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}:\n{log}")
    os.replace(tmp, out)


def load(name: str) -> ctypes.CDLL:
    """The ctypes library built from ``csrc/<name>``, built on first
    use and cached for the process."""
    lib, tier, wall = load_timed(name)
    _trace_build(name, tier, wall)
    return lib


def load_timed(name: str) -> tuple:
    """``(library, tier, seconds)``: :func:`load` without its trace
    event. The tier is ``in_process``, ``disk`` or ``cold`` (nvcc ran);
    the seconds are the load's wall, nvcc's at the ``cold`` tier."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib, "in_process", 0.0
    with _LOAD_LOCK:
        lib = _LOADED.get(name)
        if lib is not None:  # another thread loaded it meanwhile
            return lib, "in_process", 0.0
        t0 = time.monotonic()
        pending = start_build(name)
        finish_build(name, pending)
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    if pending is None:
        return lib, "disk", time.monotonic() - t0
    return lib, "cold", BUILD_SECONDS[name]


def _trace_build(name: str, tier: str, wall: float) -> None:
    """The ``program_build`` event of ``name``, once a traced run."""
    from .. import telemetry

    tracer = telemetry.current_tracer()
    if tracer is None:
        return
    seen = _TRACED.setdefault(tracer, {})
    if seen.get(name) == tracer._run_idx:
        return
    seen[name] = tracer._run_idx
    tracer.event("program_build", program=Path(name).stem, tier=tier,
                 key=library_path(name).name, wall_sec=round(wall, 6),
                 cold_sec=round(wall if tier == "cold" else 0.0, 6))


def ptxas_report(name: str) -> str:
    """nvcc's ``-Xptxas -v`` report for ``csrc/<name>`` (a separate
    build; the cached library is left alone)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{Path(name).stem}-ptxas.{os.getpid()}.so"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
           str(CSRC / name)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}:\n{proc.stderr}")
    return proc.stdout + proc.stderr


if __name__ == "__main__":
    for src in sys.argv[1:] or sorted(p.name for p in CSRC.glob("*.cu")):
        print(f"== csrc/{src}")
        print(ptxas_report(src), flush=True)
