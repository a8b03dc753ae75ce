"""Explorer HTTP server and view builders.

Mirrors stateright src/checker/explorer.rs:

* ``serve`` (explorer.rs:79-99): attach a 4-second recent-path
  snapshot visitor, spawn the on-demand checker, serve HTTP.
* ``GET /.status`` → ``StatusView`` JSON (explorer.rs:16-24, 171-190).
* ``GET /.states/{fp[/fp...]}`` → a ``StateView`` per enumerated
  action of the state reached by replaying the fingerprint path
  (explorer.rs:224-320); each visited fingerprint is also fed to
  ``check_fingerprint`` so browsing steers the on-demand search.
* ``POST /.runtocompletion`` → flips to exhaustive search
  (explorer.rs:144, 192-202).

Views are plain functions over ``(checker, snapshot)`` so tests can
call them without HTTP, exactly as explorer.rs:322-593 does.

A copy of the JAX package's ``explorer/server.py``: the same views, the
same JSON, and the same ``make_server(..., registry=)`` protocol, which
the resident service (serve.py) mounts on. The UI files are the port's
own copy under ``ui/``.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path as FsPath
from typing import Optional

from .. import telemetry
from ..checker import CheckerBuilder
from ..fingerprint import fingerprint
from ..model import Expectation
from ..path import Path

_EXPECTATION = {
    Expectation.ALWAYS: "Always",
    Expectation.SOMETIMES: "Sometimes",
    Expectation.EVENTUALLY: "Eventually",
}

_UI_DIR = FsPath(__file__).parent / "ui"
_UI_FILES = {
    "/": ("index.htm", "text/html"),
    "/app.css": ("app.css", "text/css"),
    "/app.js": ("app.js", "text/javascript"),
}


class Snapshot:
    """Samples one recently-visited path every ``refresh_sec`` seconds
    (explorer.rs:61-77, 88-94) to display search progress."""

    def __init__(self, refresh_sec: float = 4.0):
        self.refresh_sec = refresh_sec
        self._armed = True
        self._last_arm = time.monotonic()
        self._recent: Optional[str] = None
        self._lock = threading.Lock()

    def visit(self, model, path: Path) -> None:
        with self._lock:
            now = time.monotonic()
            if not self._armed and now - self._last_arm >= self.refresh_sec:
                self._armed = True
                self._last_arm = now
            if not self._armed:
                return
            self._armed = False
            self._recent = repr([model.format_action(a) for a in path.actions()])

    def recent_path(self) -> Optional[str]:
        with self._lock:
            return self._recent


def get_properties(checker) -> list:
    """``[expectation, name, encoded discovery path | null]`` triples
    (explorer.rs:13, 206-222) — the UI's property contract."""
    out = []
    for prop in checker.model.properties():
        disc = checker.discovery(prop.name)
        out.append(
            [
                _EXPECTATION[prop.expectation],
                prop.name,
                disc.encode() if disc is not None else None,
            ]
        )
    return out


def status_view(checker, snapshot: Optional[Snapshot] = None) -> dict:
    """``StatusView`` (explorer.rs:16-24, 171-190)."""
    return {
        "done": checker.is_done(),
        "model": type(checker.model).__name__,
        "state_count": checker.state_count(),
        "unique_state_count": checker.unique_state_count(),
        "max_depth": checker.max_depth(),
        "properties": get_properties(checker),
        "recent_path": snapshot.recent_path() if snapshot else None,
    }


def _live_status_view(checker, snapshot: Optional[Snapshot]) -> dict:
    """The HTTP handler's status snapshot: live counter/discovery
    attributes only — no accessor, so no ``_ensure_run`` trigger and
    no need for the checker lock. A status poll during an in-flight
    ``run_to_completion`` must show incremental progress instead of
    queueing behind the whole exhaustive search (and before the
    handler lock existed, the accessor path could re-enter the
    running search from another thread). Reads of live attributes
    are GIL-atomic; the values are a consistent-enough snapshot for
    a progress display.

    This view covers ONE checker (the mounted Explorer model). It
    used to be the server's whole status; under the resident service
    (serve.py) the same lock-free-snapshot rule
    extends to the multi-session registry — ``make_server`` appends
    ``registry.status_block()`` (every session's live state, the
    program-LRU bytes) as the ``service`` field, so the single-
    checker assumption lives only here, not in the HTTP surface."""
    props = []
    for prop in checker.model.properties():
        disc = checker._discoveries.get(prop.name)
        props.append([
            _EXPECTATION[prop.expectation],
            prop.name,
            disc.encode() if disc is not None else None,
        ])
    return {
        "done": checker.is_done(),
        "model": type(checker.model).__name__,
        "state_count": checker._total_states,
        "unique_state_count": checker._unique_states,
        "max_depth": checker._max_depth,
        "properties": props,
        "recent_path": snapshot.recent_path() if snapshot else None,
    }


def state_views(checker, fp_path: str):
    """``GET /.states{fp_path}`` (explorer.rs:224-320).

    Returns ``(views, None)`` or ``(None, error_message)``.
    """
    model = checker.model
    fps_str = fp_path.strip("/")
    fps: list[int] = []
    if fps_str:
        for part in fps_str.split("/"):
            try:
                fps.append(int(part))
            except ValueError:
                return None, f"Unable to parse fingerprints {fps_str}"

    views = []
    if not fps:
        for state in model.init_states():
            fp = fingerprint(state)
            checker.check_fingerprint(fp)
            views.append(_state_view(model, None, None, state, fp, checker, [fp]))
        return views, None

    last_state = Path.final_state_of(model, fps)
    if last_state is None:
        return None, f"Unable to find state following fingerprints {fps_str}"
    for action in model.actions(last_state):
        outcome = model.format_step(last_state, action)
        next_state = model.next_state(last_state, action)
        if next_state is None:
            # "Action ignored" still returned for debugging
            # (explorer.rs:303-311).
            views.append(
                {
                    "action": model.format_action(action),
                    "properties": get_properties(checker),
                }
            )
            continue
        fp = fingerprint(next_state)
        checker.check_fingerprint(fp)
        views.append(
            _state_view(
                model,
                model.format_action(action),
                outcome,
                next_state,
                fp,
                checker,
                fps + [fp],
            )
        )
    return views, None


def _state_view(model, action, outcome, state, fp, checker, fps) -> dict:
    view = {
        "state": repr(state),
        "fingerprint": str(fp),
        "properties": get_properties(checker),
    }
    if action is not None:
        view["action"] = action
    if outcome is not None:
        view["outcome"] = outcome
    svg = model.as_svg(Path.from_fingerprints(model, fps))
    if svg is not None:
        view["svg"] = svg
    return view


def serve(builder: CheckerBuilder, addr: str):
    """``CheckerBuilder.serve`` (checker.rs:139-146, explorer.rs:79-99).

    Blocks serving the Explorer; returns the checker on shutdown.
    """
    snapshot = Snapshot()
    checker = builder.visitor(snapshot.visit).spawn_on_demand()
    host, _, port = addr.partition(":")
    server = make_server(checker, snapshot, host or "localhost", int(port or 3000))
    print(f"Exploring. Navigate to http://{addr}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return checker


def make_server(checker, snapshot, host: str, port: int,
                registry=None) -> ThreadingHTTPServer:
    """Build (without starting) the HTTP server — separable for tests.

    Single-checker by default (``registry=None``: the historical
    Explorer server, byte-identical behavior — the smoke tests pin
    it). The resident service (serve.py) passes itself
    as ``registry`` to mount BOTH tenancies on one server; the
    protocol is three methods:

    * ``handle_request(handler, method, path) -> bool`` — service
      routes (``POST /.check``, ``GET /.serve/sessions``, ...), tried
      BEFORE the Explorer's; True means handled.
    * ``request_scope() -> context manager`` — installed around each
      Explorer request, so the service's explorer-session tracer
      meters the per-request spans instead of the process tracer.
    * ``status_block() -> dict`` — appended to ``/.status`` as
      ``sessions``: the lock-free snapshot rule that view documents
      generalizes from one checker's live counters to the service's
      whole session registry (GIL-atomic attribute reads on both
      sides, so progress polls keep answering mid-run).

    ``checker`` may be None only with a registry (a service with no
    Explorer mounted): explorer routes then 404 while service routes
    still answer."""
    if checker is None and registry is None:
        raise ValueError(
            "make_server needs a checker, a registry, or both"
        )

    # One lock serializes every handler section that touches checker
    # state: the on-demand checker's dicts are not thread-safe under
    # ThreadingHTTPServer's per-request threads, and the
    # cache-hit derivation (unique-count before/after) would misread
    # a concurrent request's exploration as its own cache miss.
    checker_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _err(self, msg, code=404):
            body = msg.encode()
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        # Request telemetry: every handler runs
        # inside an ``explorer_request`` span — per-request wall plus
        # the cache-hit state (whether the request was served entirely
        # from already-explored states or pulled new ones into the
        # on-demand search). The span API's no-op path keeps untraced
        # serving cost-free; with a tracer active each request lands
        # as one span event in the TRACE artifact — the service's
        # request_scope routes them into its explorer session.

        def _dispatch(self, method):
            if registry is not None:
                if registry.handle_request(self, method, self.path):
                    return
                scope = registry.request_scope()
            else:
                scope = None
            if checker is None:
                self._err("not found")
                return
            if scope is None:
                self._explorer_request(method)
            else:
                with scope:
                    self._explorer_request(method)

        def _explorer_request(self, method):
            with telemetry.span(
                "explorer_request", method=method,
                path=self.path.split("?", 1)[0],
            ) as meta:
                if method == "GET":
                    self._get(meta)
                else:
                    self._post(meta)

        def do_GET(self):
            self._dispatch("GET")

        def do_POST(self):
            self._dispatch("POST")

        def _get(self, meta):
            if self.path in _UI_FILES:
                meta["kind"] = "ui"
                name, ctype = _UI_FILES[self.path]
                data = (_UI_DIR / name).read_bytes()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif self.path == "/.status":
                # a status poll never explores: always a cache hit —
                # and deliberately LOCK-FREE (live attributes only,
                # and the registry's own lock-free snapshot), so
                # progress polls keep answering while a
                # run_to_completion holds the checker lock or a
                # service session holds the device
                meta["kind"], meta["cache_hit"] = "status", True
                view = _live_status_view(checker, snapshot)
                if registry is not None:
                    view["service"] = registry.status_block()
                self._json(view)
            elif self.path == "/.metrics":
                # plain Explorer servers (no service registry — the
                # registry's own /.metrics is tried first in
                # _dispatch): render the PROCESS-active registry
                # (metrics.py activate()), or an empty
                # exposition — a scraper sees 200 either way, the
                # same lock-free answer-while-busy rule as /.status
                meta["kind"], meta["cache_hit"] = "metrics", True
                from ..metrics import active_registry

                reg = active_registry()
                body = (reg.render_prometheus() if reg is not None
                        else "").encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8",
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path.startswith("/.states"):
                meta["kind"] = "states"
                # ``_unique_states`` is a live attribute (no run
                # trigger): unchanged across the handler means every
                # browsed fingerprint was already explored (the lock
                # keeps a concurrent request's exploration out of
                # this request's delta)
                with checker_lock:
                    before = checker._unique_states
                    views, err = state_views(
                        checker, self.path[len("/.states"):]
                    )
                    meta["cache_hit"] = (
                        checker._unique_states == before
                    )
                if err is not None:
                    meta["error"] = err
                    self._err(err)
                else:
                    meta["states"] = len(views)
                    self._json(views)
            else:
                meta["error"] = "not found"
                self._err("not found")

        def _post(self, meta):
            if self.path == "/.runtocompletion":
                meta["kind"] = "run_to_completion"
                with checker_lock:
                    before = checker._unique_states
                    checker.run_to_completion()
                    meta["cache_hit"] = (
                        checker._unique_states == before
                    )
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()
            else:
                meta["error"] = "not found"
                self._err("not found")

    return ThreadingHTTPServer((host, port), Handler)
