"""The device-resident chunk: up to N waves between two host syncs.

The port of the JAX engines' chunk (JAX ``checkers/tpu.py``
``waves_per_sync``, ``chunk`` and its ``lax.while_loop``): the
single-device wave engines (checkers/tpu.py, checkers/tpu_sortmerge.py)
run a chunk of up to ``waves_per_sync`` waves with no read of a device
value but the class changes', and end it with ONE read of a packed
stats tensor: the stop
reasons, depth, the counts, the discovery lanes, the widest-wave meters
and, traced, the ``[N, WAVE_LOG_LANES]`` wave log (telemetry.py).

What makes that possible:

* **A fixed-capacity wave.** Within a chunk every buffer has a capacity
  class (a power of two, at most the configured capacity) chosen at the
  chunk's start from the counts of the last sync, and every count is a
  0-d int64 tensor in :class:`ChunkCarry`'s scalar row ``sc``. The
  kernels take their counts from device memory (``ops.merge.*_dev``,
  ``ops.hashset.insert_dev``); compactions are rank scatters into
  class-sized buffers (``ops.merge.rank_compact``).
* **Waves that cannot fit commit nothing.** A wave that would cross a
  class sets a grow bit (:data:`GROW_P`, :data:`GROW_F`,
  :data:`GROW_V`) and the count it needed, leaves the carry as it was
  and stops; the host grows the class (:func:`grow_class`) and runs the
  wave again, in the same chunk. Only crossing a configured capacity
  (or an encoding bound) is an overflow (:data:`OVER_VISITED` …), which
  ends the chunk and which the host raises with the engines' messages.
  A frontier that shrank to a small part of its class takes smaller
  classes (:func:`shrink_classes`) before the next wave.
* **Poll, not read, but still a wait.** :class:`WaveRunner` runs the
  waves; each wave copies the scalar row into pinned host memory, and
  the host waits for the wave's event and reads the copy: it issues no
  wave past a stop (a wave past ``done`` never runs) and picks the next
  wave's classes from it. That wait blocks the host once a wave, as a
  read would (the device idles while the host issues the next wave),
  so it is counted: ``host_waits`` in the run's metrics, one a wave run
  (re-runs included). The chunk's one read (:class:`ChunkLoop`) is its
  packed stats. On the CPU the scalars are read directly, and counted
  the same way. Issuing a chunk's waves ahead of their polls, each
  guarded on the device's ``stop``, is not done: a wave past ``done``
  would then run its class's kernels in full.
* **CUDA graphs (card only).** The first waves of a class run eagerly
  (the kernels' first-launch set-up happens there), and so does every
  wave of a class wider than :data:`GRAPH_MAX_PAIRS`; later waves of the
  class replay one ``torch.cuda.CUDAGraph`` a (class, ping-pong parity),
  captured on a side stream into the run's one memory pool. A capture that
  fails raises, naming the op where it failed; nothing falls back to
  eager waves. Kernel launches recorded into a graph count at each
  replay (``ops.cuda_build.note_launch``).

Counts, depth, discovery fingerprints and paths do not depend on N:
the waves are the same waves, only the syncs between them move.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Optional

import torch

from ..ops.cuda_build import capturing, replayed

#: the scalar row every chunked wave reads and rewrites (one int64 each)
SC_NAMES = (
    "stop",      # waves stopped: done, a grow or an overflow
    "done",      # the search finished (a committed wave's verdict)
    "grow",      # GROW_* bits of the wave that could not fit
    "over",      # OVER_* bits: a configured capacity or bound crossed
    "depth",     # depth entering the next wave
    "waves",     # waves committed so far
    "nv",        # visited keys (sort-merge) / unique states (hash)
    "nf",        # frontier rows entering the next wave
    "nl",        # parent-log rows (sort-merge)
    "gen",       # the states= counter
    "wchunk",    # waves committed in this chunk
    "need_p",    # pairs the wave that set GROW_P needed
    "need_f",    # frontier rows the wave that set GROW_F needed
    "need_v",    # visited rows the wave that set GROW_V needed
    "last_p",    # pairs of the last committed wave (the shrink sizes by it)
    "last_nf",   # frontier rows entering it
    "hits",      # canonical hits, summed
    "max_cand",  # the widest wave's candidates
    "widest",    # its index
    "max_new",   # the most new states one wave added
    "mem_na", "mem_nq",  # the member kernel's widest call
    "mrg_na", "mrg_nb",  # the merge kernel's widest call
    "chunks", "max_chunks",  # dense row chunks stepped, and a wave's most
    "epoch",     # the hash insert's epoch counter (card)
    "ins_occ", "ins_keys", "ins_new",  # the widest insert (hash)
)
SC = {name: i for i, name in enumerate(SC_NAMES)}

#: grow bits: the wave's pairs, new frontier rows or visited keys did
#: not fit their classes
GROW_P, GROW_F, GROW_V = 1, 2, 4
#: overflow bits: the configured visited capacity, frontier capacity,
#: candidate capacity or an encoding bound was crossed (they raise)
OVER_VISITED, OVER_FRONTIER, OVER_CAND, OVER_ENC = 1, 2, 4, 8

#: the smallest classes: frontier rows, pairs, visited keys
FLOOR_F, FLOOR_P, FLOOR_V = 16, 64, 256

#: waves of a class that run eagerly before its graphs are captured (a
#: capture costs about what an eager wave's issue costs, so a class
#: that lives two waves is not worth one)
EAGER_WAVES = 2

#: the widest pair class that is captured: a graph keeps every block its
#: wave allocates for its replays (graphs of 2pc rm=9's widest classes
#: held tens of GiB on an H100), and a wave this wide is bound by its
#: device time, not by the host's issue that a graph saves, so wider
#: classes run eagerly (and step only their live rows,
#: ``ChunkCarry.rows_bound``)
GRAPH_MAX_PAIRS = 1 << 22

#: after a committed wave whose new frontier is smaller than the one it
#: expanded and uses at most 1/SHRINK of the frontier class, the
#: frontier and pair classes shrink
SHRINK = 4


def pow2ceil(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


#: a grown class holds this many times the rows that did not fit ...
HEADROOM = 4
#: ... below this many rows; from it on (no class this wide is captured,
#: and the device's memory, not the host, bounds it) a class holds
#: BIG_HEADROOM times them, rounded up to a sixteenth of a power of two
BIG_CLASS = 1 << 22
BIG_HEADROOM = 1.25

#: the most waves of the frontier's growth a grown frontier class makes
#: room for ahead: the growth rate, capped at this
GROWTH_CAP = 2.0


def grow_class(need: int, cap: int, floor: int) -> int:
    """The class for ``need`` rows: :data:`HEADROOM` times the need as a
    power of two (past :data:`BIG_CLASS`, :data:`BIG_HEADROOM` times it
    in sixteenths of one), at least ``floor`` and at most the configured
    ``cap``."""
    need = max(int(need), 1)
    want = pow2ceil(HEADROOM * need)
    if want > BIG_CLASS:
        big = int(BIG_HEADROOM * need)
        step = max(pow2ceil(big) // 16, 1)
        want = max(BIG_CLASS, -(-big // step) * step)
    return max(1, min(int(cap), max(floor, want)))


def shrinks(h: dict, Fc: int) -> bool:
    """Whether the frontier, after a committed wave (the polled scalars
    ``h``), shrank to at most 1/:data:`SHRINK` of its class ``Fc``."""
    return (not h["grow"] and h["nf"] * SHRINK <= Fc
            and h["nf"] < h["last_nf"] and Fc > FLOOR_F)


def shrink_classes(h: dict, Pc: int, fcap: int, pcap: int) -> tuple:
    """The frontier and pair classes once it :func:`shrinks`: the
    frontier's class for its rows now, and the pairs' for as many pairs
    a row as the last wave had (never larger than they were)."""
    per_row = -(-h["last_p"] // max(h["last_nf"], 1))
    return (grow_class(h["nf"], fcap, FLOOR_F),
            min(Pc, grow_class(h["nf"] * per_row, pcap, FLOOR_P)))


#: the device index vector of each set of scalar names a wave writes, by
#: (names, device): made once, by an eager wave
_WRITE_IDX: dict = {}


class ChunkCarry:
    """What every chunked wave carries on its device: the scalar row
    ``sc`` (:data:`SC_NAMES`), the discovery lanes ``disc`` (``[3, P]``:
    found, lo, hi of each property's fingerprint) and, when the run is
    traced, the wave log ``log`` (``[N + 1, WAVE_LOG_LANES]``; a wave
    writes row ``wchunk``, an uncommitted one the spare last row). The
    engines' carries add their class-sized ping-pong buffers; ``parity``
    is the host's index of the live half, which flips with every
    committed wave."""

    def __init__(self, device, n_props: int, n_waves: int, lanes: int,
                 log: bool):
        self.device = device
        self.sc = torch.zeros(len(SC_NAMES), dtype=torch.int64,
                              device=device)
        #: a 0-d view of each scalar, made once (a wave reads them as
        #: plain attributes: every torch call gives up the interpreter
        #: lock, which a host thread beside the run may hold for a while)
        self._views = {name: self.sc[i] for name, i in SC.items()}
        self.disc = torch.zeros((3, n_props), dtype=torch.int64,
                                device=device)
        self.n_waves = n_waves
        self.log = (torch.full((n_waves + 1, lanes), -1, dtype=torch.int64,
                               device=device) if log else None)
        self.parity = 0
        #: the frontier rows entering the next wave, as the host last
        #: read them (the polled scalars)
        self.nf_host = None
        #: whether the next wave runs eagerly (set by the chunk loop)
        self.eager = True
        #: the rows times slots a dense wave steps (0: a sparse wave)
        self.step_rows = 0

    def graphable(self) -> bool:
        """Whether this class's waves may be captured: their widest
        block (the pairs, or a dense wave's every slot of every frontier
        row, ``step_rows``) within :data:`GRAPH_MAX_PAIRS`. A wider
        wave runs eagerly, stepping only its live rows."""
        return max(self.Pc, self.step_rows) <= GRAPH_MAX_PAIRS

    def rows_bound(self):
        """A host bound on the next wave's live frontier rows, for an
        eager wave (None for a wave a graph captures or replays, which
        must step every row of its class)."""
        return self.nf_host if self.eager else None

    def s(self, name: str) -> torch.Tensor:
        """A 0-d view of one scalar."""
        return self._views[name]

    def set_scalars(self, **values) -> None:
        """Host-side set-up (before a chunk): write named scalars."""
        for name, v in values.items():
            self.sc[SC[name]] = int(v)

    def write(self, upd: dict) -> None:
        """The end of a wave: the scalars named in ``upd`` (0-d int64
        tensors) written in place, in one scatter. The index vector of
        a set of names is made at its first wave, which runs eagerly."""
        names = tuple(upd)
        key = (names, torch.device(self.device))
        idx = _WRITE_IDX.get(key)
        if idx is None:
            idx = _WRITE_IDX[key] = torch.tensor(
                [SC[n] for n in names], dtype=torch.int64, device=self.device)
        self.sc.index_copy_(0, idx, torch.stack([upd[n] for n in names]))

    def begin_chunk(self) -> None:
        """Clear the per-chunk scalars (stop reasons, the chunk's wave
        count) before a chunk's first wave."""
        for name in ("stop", "grow", "wchunk"):
            self.sc[SC[name]] = 0

    def clear_stop(self) -> None:
        """Let waves run again after a grow stop (the classes grew)."""
        for name in ("stop", "grow"):
            self.sc[SC[name]] = 0

    def packed(self) -> torch.Tensor:
        """The chunk's one read: scalars, discovery lanes, wave log."""
        parts = [self.sc, self.disc.reshape(-1)]
        if self.log is not None:
            parts.append(self.log[:self.n_waves].reshape(-1))
        return torch.cat(parts)

    def unpack(self, flat: list, n_props: int) -> dict:
        """The host values of :meth:`packed`'s read: the scalars by name,
        ``disc`` (three lists) and ``rows`` (the committed waves' log
        rows, traced)."""
        n = len(SC_NAMES)
        out = dict(zip(SC_NAMES, flat[:n]))
        d = flat[n:n + 3 * n_props]
        out["disc"] = (d[:n_props], d[n_props:2 * n_props], d[2 * n_props:])
        if self.log is not None:
            lanes = self.log.shape[1]
            log = flat[n + 3 * n_props:]
            out["rows"] = [log[i * lanes:(i + 1) * lanes]
                           for i in range(out["wchunk"])]
        return out


class ChunkSchedule:
    """Where JAX's chunks end. JAX syncs after every ``N`` waves of an
    attempt (counted from the wave it started at) and at ``done``; the
    port syncs there too, and also where a wave asks for other classes.
    So a port chunk runs at most up to the next of JAX's boundaries
    (:meth:`limit`), and a sync that lands on one (:meth:`synced`) is
    JAX's chunk boundary: its snapshot cadence, its ``chunk_boundary``
    fault site and its progress report, each with JAX's chunk index.
    ``mid_chunk`` fires once a JAX chunk, with its index, between the
    issue of its first port chunk and that chunk's sync."""

    def __init__(self, waves0: int, n: int):
        self.waves0 = int(waves0)
        self.n = int(n)
        self.waves = int(waves0)
        self._mid_fired = -1

    def limit(self) -> int:
        """The waves the next port chunk may run."""
        return self.n - (self.waves - self.waves0) % self.n

    def mid_chunk(self) -> None:
        from .. import faultinject

        k = (self.waves - self.waves0) // self.n
        if k != self._mid_fired:
            self._mid_fired = k
            faultinject.fire("mid_chunk", k)

    def synced(self, waves: int, done: bool) -> Optional[int]:
        """After a sync at ``waves`` committed waves: the index of the
        JAX chunk that ends here, or None."""
        self.waves = int(waves)
        rel = self.waves - self.waves0
        if rel > 0 and (done or rel % self.n == 0):
            return (rel - 1) // self.n
        return None


class ChunkLoop:
    """An engine's chunks: up to the next of JAX's boundaries
    (:class:`ChunkSchedule`) of committed waves, each wave through the
    :class:`WaveRunner`, classes grown or shrunk between waves from the
    polled scalars (``reclass(h, key)``, then ``resize(cx, h, key)`` to
    a carry of the new classes), and one blocking read of the packed
    stats at the end. ``wave(cx, parity)`` issues one wave; ``resizes``
    and ``classes`` record the class changes."""

    def __init__(self, runner: "WaveRunner", sched: ChunkSchedule, wave,
                 reclass, resize, n_props: int, classes: list, check=None):
        self.runner, self.sched = runner, sched
        self.wave, self.reclass, self.resize = wave, reclass, resize
        self.n_props = n_props
        #: called before the read (the watchdog's abandonment test)
        self.check = check
        self.resizes = 0
        #: the classes used so far, the current one last (a resumed run's
        #: start with the killed run's: :func:`start_classes`)
        self.classes = list(classes)

    def chunk(self, cx: "ChunkCarry") -> tuple:
        """``(carry, stats)``: one chunk from ``cx``; the carry it ends
        in (another after a class change) and :meth:`ChunkCarry.unpack`
        of its read."""
        from .tpu import host_read

        cx.begin_chunk()
        committed, limit = 0, self.sched.limit()
        while committed < limit:
            par = cx.parity
            graph = cx.graphable()
            cx.eager = self.runner.mode(cx.key, par, graph) == "eager"
            h = self.runner.run(cx.key, par,
                                lambda cx=cx, par=par: self.wave(cx, par),
                                cx.sc, graph=graph)
            if h["wchunk"] > committed:
                committed = h["wchunk"]
                cx.parity ^= 1
            cx.nf_host = h["nf"]
            if h["done"] or h["over"]:
                break
            key = self.reclass(h, cx.key)
            if key != cx.key:
                cx = self.resize(cx, h, key)
                cx.nf_host = h["nf"]
                self.runner.forget()
                self.resizes += 1
                self.classes.append(key)
            elif h["grow"]:
                raise RuntimeError(
                    f"a wave needs classes past {key}, which the "
                    "configured capacities allow, but none was chosen")
            if h["grow"]:
                cx.clear_stop()
        # the fault site between the chunk's issue and its sync
        self.sched.mid_chunk()
        if self.check is not None:
            self.check()
        return cx, cx.unpack(host_read(cx.packed()), self.n_props)


def start_classes(fresh: tuple, resumed, fits) -> list:
    """The classes a chunked run starts from: ``[fresh]`` (the classes
    for its start counts), or, resumed from a snapshot of a chunked run,
    the classes that run used (``resumed``, from the snapshot's
    manifest), whose last it goes on in, when ``fits(key)`` says that
    class holds the start state within the configured capacities. A
    resumed run then makes the killed run's class changes, and its
    memory plan lists the same classes."""
    if resumed:
        hist = [tuple(int(x) for x in k) for k in resumed]
        if len(hist[-1]) == len(fresh) and fits(hist[-1]):
            return hist
    return [fresh]


def _failing_site(exc: BaseException) -> str:
    """The innermost frame of this package in ``exc``'s traceback, as
    ``file:line (function): source``: the op a capture failed at."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if os.path.abspath(f.filename).startswith(pkg)]
    if not frames:
        return "an op outside the package"
    f = frames[-1]
    rel = os.path.relpath(f.filename, os.path.dirname(pkg))
    return f"{rel}:{f.lineno} ({f.name}): {(f.line or '').strip()}"


class WaveRunner:
    """Runs one engine's waves: eagerly on the CPU, and on the card the
    first :data:`EAGER_WAVES` waves of a class eagerly and the later ones
    as replays of a CUDA graph a (class, parity), captured on a side
    stream into the run's one memory pool. After each wave it polls the
    scalar row (a pinned copy on the card, read once the wave's event
    has completed; the row itself on the CPU) and returns it.

    ``captures``, ``replays`` and ``eager`` count the waves of each
    kind over the runner's life; ``waits`` the polls, one a wave, each
    of which blocks the host until its wave has ended (on the card);
    ``poll_sec`` is the host's wall spent in them."""

    def __init__(self, device, name: str):
        self.device = torch.device(device)
        self.name = name
        self.cuda = self.device.type == "cuda"
        self.graphs: dict = {}
        #: eager waves run a class
        self.seen: dict = {}
        self.captures = self.replays = self.eager = self.waits = 0
        self.poll_sec = 0.0
        self._pool = self._keeper = None
        if self.cuda:
            self._flag = torch.zeros(len(SC_NAMES), dtype=torch.int64,
                                     pin_memory=True)
            self._event = torch.cuda.Event()
            self._stream = torch.cuda.Stream(self.device)
            self._keep_buf = torch.zeros(1, dtype=torch.int64,
                                         device=self.device)

    def forget(self) -> None:
        """Drop the graphs (the classes changed): their memory goes back
        to the run's pool, where the next class's captures reuse it. Each
        is reset, so nothing that still refers to one keeps its memory."""
        for graph, _ in self.graphs.values():
            graph.reset()
        self.graphs.clear()
        self.seen.clear()

    def close(self) -> None:
        """Drop the graphs and the run's memory pool (the run ended)."""
        self.forget()
        if self._keeper is not None:
            self._keeper.reset()
        self._pool = self._keeper = None

    def _pool_handle(self):
        """The run's graph memory pool. A pool lives as long as a graph
        captured into it, so a one-op keeper graph holds it across class
        changes: without it each class would take a new pool, and the
        memory of the old ones would stay reserved to them."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._keeper = torch.cuda.CUDAGraph()
            with torch.cuda.stream(self._stream):
                self._keeper.capture_begin(pool=self._pool,
                                           capture_error_mode="thread_local")
                self._keep_buf.add_(0)
                self._keeper.capture_end()
        return self._pool

    def mode(self, key, parity: int, graph: bool = True) -> str:
        """How :meth:`run` will run the next wave of class ``key`` at
        ``parity``: ``"eager"``, ``"capture"`` (then replay) or
        ``"replay"``."""
        if not self.cuda:
            return "eager"
        if (key, parity) in self.graphs:
            return "replay"
        if graph and self.seen.get(key, 0) >= EAGER_WAVES:
            return "capture"
        return "eager"

    def run(self, key, parity: int, wave, sc: torch.Tensor,
            graph: bool = True) -> dict:
        """One wave of class ``key`` reading ping-pong half ``parity``
        (``wave()`` issues it; ``graph``: whether the class may be
        captured): the scalar row ``sc`` after it, by name, from the
        pinned copy the wave made."""
        self.waits += 1
        if not self.cuda:
            wave()
            self.eager += 1
            return dict(zip(SC_NAMES, sc.tolist()))  # a host tensor

        def body():
            wave()
            self._flag.copy_(sc, non_blocking=True)

        entry = self.graphs.get((key, parity))
        if entry is None and self.mode(key, parity, graph) == "capture":
            entry = self.graphs[(key, parity)] = self._capture(body)
        if entry is None:
            self.seen[key] = self.seen.get(key, 0) + 1
            body()
            self.eager += 1
        else:
            graph, tally = entry
            graph.replay()
            replayed(tally)
            self.replays += 1
        self._event.record()
        t0 = time.monotonic()
        # the wave's end: the pinned scalars have landed (the wait gives
        # up the interpreter lock, so other threads run meanwhile)
        self._event.synchronize()
        self.poll_sec += time.monotonic() - t0
        return dict(zip(SC_NAMES, self._flag.tolist()))

    def _capture(self, body) -> tuple:
        """Capture ``body`` into a new graph (not run): ``(graph,
        launches a replay)``. Raises naming the op a failed capture
        stopped at."""
        pool = self._pool_handle()
        graph = torch.cuda.CUDAGraph()
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream), capturing() as tally:
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                body()
            except Exception as exc:
                try:
                    graph.capture_end()
                except Exception:  # the capture is invalid already
                    self._end_routing(pool)
                raise RuntimeError(
                    f"CUDA graph capture of the {self.name} wave failed at "
                    f"{_failing_site(exc)}: {type(exc).__name__}: {exc}"
                ) from exc
            try:
                graph.capture_end()
            except Exception as exc:
                self._end_routing(pool)
                raise RuntimeError(
                    f"CUDA graph capture of the {self.name} wave failed "
                    f"when it ended (an op of the wave synced or left the "
                    f"stream): {type(exc).__name__}: {exc}") from exc
        cur.wait_stream(self._stream)
        self.captures += 1
        return graph, tally

    def _end_routing(self, pool) -> None:
        """After a capture whose end failed: stop routing the side
        stream's allocations to the graph pool (``capture_end`` does it
        only when it succeeds), so the process's later work on that
        pooled stream allocates as usual."""
        try:
            torch._C._cuda_endAllocateToPool(self.device.index or 0, pool)
        except Exception:  # already ended
            pass

    def counts(self) -> dict:
        return dict(graph_captures=self.captures, graph_replays=self.replays,
                    eager_waves=self.eager, host_waits=self.waits,
                    poll_sec=round(self.poll_sec, 6))
