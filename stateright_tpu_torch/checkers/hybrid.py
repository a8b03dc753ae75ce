"""The hybrid racer: host DFS against the device wave engine, first done wins.

The port of ``stateright_tpu.checkers.hybrid``. Shallow bugs favour the
host (a depth-first search finds the increment lost update in
milliseconds), deep verification favours the device, so
``spawn_hybrid()`` runs BOTH — the host depth-first search
(checkers/dfs.py) in a daemon thread, the sort-merge engine
(checkers/tpu_sortmerge.py) in the calling thread — and adopts
whichever completes first, cancelling the loser at its next check point
(per DFS pop / per device wave).

Both sides share the fingerprint and path plumbing, so discoveries
replay identically whichever side wins.

Where the port differs from the JAX racer, on purpose:

* The device is checked, and its kernels built, in the calling thread
  BEFORE the race starts, and a device exception during the race is
  re-raised even when the host won. The JAX racer adopts the host's
  result when the device raised; here that would let a machine with no
  card, or a kernel that fails to build or launch, quietly report host
  results.
* The device side is an eager Python loop that holds the GIL while it
  issues its kernels, so the host thread takes turns with it in slices
  of ``sys.getswitchinterval()``: a raced device run can be slower than
  the engine alone (the JAX device side spends its time in XLA dispatch
  with the GIL released).
"""

from __future__ import annotations

import threading
import warnings
from typing import Optional

from ..checker import Checker, CheckerBuilder
from ..report import Reporter
from .dfs import DfsChecker


class HybridChecker(Checker):
    """``CheckerBuilder.spawn_hybrid()``.

    ``device_kwargs`` go to :meth:`CheckerBuilder.spawn_sortmerge`
    (``encoded``, ``capacity``, ``frontier_capacity``, ``track_paths``,
    ``sparse``, ``device``, ``dense_chunk_bytes``, ``ample_set``). After
    ``join()``, :attr:`winner` is ``"host"`` or ``"device"`` and every
    ``Checker`` accessor reflects the winning engine's run.
    """

    def __init__(self, builder: CheckerBuilder, **device_kwargs):
        super().__init__(builder)
        self._device_kwargs = device_kwargs
        #: which engine completed first ("host" | "device")
        self.winner: Optional[str] = None
        self._winner_checker: Optional[Checker] = None
        #: both sides of the last race, ``{"host": ..., "device": ...}``
        #: (the loser with its partial counts and ``cancelled`` set)
        self.engines: dict = {}
        #: the staged snapshot (:meth:`resume_from`): the DEVICE side
        #: resumes from it and the host DFS starts fresh (it has no
        #: snapshot), so both sides still explore the same space
        self._resume_path = None
        self._resume_kw: dict = {}

    def resume_from(self, path: str, **kw) -> None:
        """Stage a sort-merge snapshot for the next run's device side
        (checkpoint.resume_from; it is validated when the race builds
        its device checker)."""
        self._resume_path = path
        self._resume_kw = kw

    def _device(self):
        """The device side, its device checked and its kernels built."""
        from ..ops import merge
        from .tpu_sortmerge import SortMergeTpuBfsChecker

        device = SortMergeTpuBfsChecker(self.builder, **self._device_kwargs)
        device._check_device()
        if self._resume_path is not None:
            device.resume_from(self._resume_path, **self._resume_kw)
        if device.device.type == "cuda":
            merge._lib()
        return device

    def _run(self, reporter: Optional[Reporter] = None) -> None:
        device = self._device()
        host = DfsChecker(self.builder)
        self.engines = {"host": host, "device": device}
        stop_host = threading.Event()
        stop_device = threading.Event()
        host.cancel_event = stop_host
        device.cancel_event = stop_device
        lock = threading.Lock()
        host_error: list = []

        def claim(name: str) -> bool:
            with lock:
                if self.winner is None:
                    self.winner = name
                    return True
                return False

        def run_host():
            try:
                host._ensure_run()
            except Exception as exc:  # judged after the race
                host_error.append(exc)
                return
            if not host.cancelled and claim("host"):
                stop_device.set()

        t = threading.Thread(target=run_host, daemon=True)
        t.start()
        device_error = None
        try:
            try:
                device._ensure_run(reporter)
            except Exception as exc:
                device_error = exc
            if (device_error is None and not device.cancelled
                    and claim("device")):
                stop_host.set()
            elif device_error is not None:
                stop_host.set()
            t.join()
        finally:
            # The loser is cancelled AND joined on every exit path,
            # a BaseException out of the device side included: a host
            # thread that outlived _run could race the winner
            # bookkeeping. It checks its cancel event per DFS pop.
            if t.is_alive():
                stop_host.set()
                t.join()
        if device_error is not None:
            # never swallowed, whichever side won: a device that
            # fails must not pass for a host result
            raise device_error
        if host_error and self.winner == "device":
            if not isinstance(host_error[0], MemoryError):
                # A model error that manifests only on the host (hand
                # encodings never run the host enumeration): racing past
                # it would report a clean verification for a panicking
                # model.
                raise RuntimeError(
                    "hybrid race: the device engine completed but the "
                    "host engine raised a model error (not a "
                    "cancellation) — refusing to mask it"
                ) from host_error[0]
            # Host memory exhaustion is the race LOST, not a model
            # error: the host DFS holds O(states x depth) trace tuples.
            # A traced run records it as an event too (a memory datum).
            from .. import telemetry

            msg = ("hybrid race: host engine ran out of memory; adopting "
                   "the device engine's completed result")
            telemetry.emit(
                "hybrid_host_oom", phase="host_dfs", message=msg,
                winner=self.winner,
                error=f"{type(host_error[0]).__name__}: {host_error[0]}")
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        win = host if self.winner == "host" else device
        # Adopt the winner's result surface wholesale.
        self._winner_checker = win
        self._discoveries = win._discoveries
        self._discovered_fps = dict(getattr(win, "_discovered_fps", {}))
        self._total_states = win._total_states
        self._unique_states = win._unique_states
        self._max_depth = win._max_depth

    def discovered_property_names(self) -> set:
        self._ensure_run()
        w = self._winner_checker
        if hasattr(w, "discovered_property_names"):
            return w.discovered_property_names()
        return set(w._discoveries)

    def discoveries(self):
        self._ensure_run()
        return self._winner_checker.discoveries()

    def assert_properties(self) -> None:
        self._ensure_run()
        self._winner_checker.assert_properties()
