"""The PyTorch port's Explorer (explorer/server.py) held against the JAX
package's: the counterparts of JAX ``tests/test_explorer.py``'s nine
tests, and the views' JSON equal to JAX's on the same model and
fingerprint path (2pc rm=3 browsed two steps deep and run to completion,
and the ping-pong actor model's sequence-diagram SVG), then one HTTP
round trip against each package's server on an ephemeral port. Every
request and thread join is bounded by a timeout."""

import json
import threading
import urllib.request

import pytest

from stateright_tpu_torch.explorer.server import (
    Snapshot,
    get_properties,
    make_server,
    state_views,
    status_view,
)
from stateright_tpu_torch.fingerprint import fingerprint
from stateright_tpu_torch.fixtures import BinaryClock
from stateright_tpu_torch.models.two_phase_commit import TwoPhaseSys

#: seconds a request may take
TIMEOUT = 60


def _checker(model):
    return model.checker().spawn_on_demand()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=TIMEOUT) as r:
        return r.read()


def _serving(checker):
    server = make_server(checker, Snapshot(), "127.0.0.1", 0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, t, server.server_address[1]


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=TIMEOUT)


def test_can_init():
    checker = _checker(BinaryClock())
    views, err = state_views(checker, "/")
    assert err is None
    assert len(views) == len(list(BinaryClock().init_states()))
    for v in views:
        assert "action" not in v
        assert "state" in v and "fingerprint" in v
        assert v["properties"]


def test_can_next():
    model = BinaryClock()
    checker = _checker(model)
    init = list(model.init_states())[0]
    views, err = state_views(checker, f"/{fingerprint(init)}")
    assert err is None and len(views) >= 1
    for v in views:
        assert "action" in v and "fingerprint" in v
        assert v["state"] in {repr(s) for s in model.next_states(init)}


def test_bad_fingerprints_404():
    checker = _checker(BinaryClock())
    views, err = state_views(checker, "/one/two")
    assert views is None and "Unable to parse" in err
    views, err = state_views(checker, "/12345678")
    assert views is None and "Unable to find state" in err


def test_smoke_status():
    checker = _checker(BinaryClock())
    s = status_view(checker)
    assert s["model"] == "BinaryClock" and s["done"] is False
    assert [p[0] for p in s["properties"]] == ["Always", "Sometimes"]
    checker.run_to_completion()
    s = status_view(checker)
    assert s["done"] is True
    assert s["properties"][0][2] is None
    assert s["properties"][1][2]


def test_browsing_steers_on_demand_search():
    checker = _checker(TwoPhaseSys(rm_count=2))
    before = checker.unique_state_count()
    views, err = state_views(checker, "/")
    assert err is None
    state_views(checker, f"/{views[0]['fingerprint']}")
    assert checker.unique_state_count() > before


def test_discovery_encoded_in_properties():
    checker = _checker(TwoPhaseSys(rm_count=2))
    checker.run_to_completion()
    props = {p[1]: p for p in status_view(checker)["properties"]}
    assert props["commit agreement"][2]
    assert all(part.isdigit()
               for part in props["commit agreement"][2].split("/"))


def test_http_round_trip():
    server, t, port = _serving(_checker(TwoPhaseSys(rm_count=2)))
    try:
        assert json.loads(_get(port, "/.status"))["model"] == "TwoPhaseSys"
        views = json.loads(_get(port, "/.states/"))
        assert views and "fingerprint" in views[0]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/.runtocompletion", method="POST")
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            assert r.status == 200
        assert json.loads(_get(port, "/.status"))["done"] is True
        assert b"Explorer" in _get(port, "/")
        assert _get(port, "/app.js") and _get(port, "/app.css")
    finally:
        _stop(server, t)


def test_request_telemetry_spans():
    from stateright_tpu_torch.telemetry import RunTracer, validate_events

    server, t, port = _serving(_checker(TwoPhaseSys(rm_count=2)))
    tr = RunTracer()
    try:
        with tr.activate():
            tr.begin_run(lane=dict(engine="explorer"))
            _get(port, "/.status")
            fp = json.loads(_get(port, "/.states/"))[0]["fingerprint"]
            _get(port, f"/.states/{fp}")
            _get(port, f"/.states/{fp}")
            tr.end_run()
    finally:
        _stop(server, t)
    validate_events(tr.events)
    spans = [e for e in tr.events
             if e["ev"] == "span" and e["phase"] == "explorer_request"]
    assert len(spans) == 4
    assert all(s["dur"] >= 0 and s["method"] == "GET" for s in spans)
    by_path: dict = {}
    for s in spans:
        by_path.setdefault(s["path"], []).append(s)
    assert by_path["/.status"][0]["kind"] == "status"
    assert by_path["/.status"][0]["cache_hit"] is True
    browse = by_path[f"/.states/{fp}"]
    assert [s["cache_hit"] for s in browse] == [False, True]
    assert all("states" in s for s in browse)


def test_actor_model_svg_in_state_views():
    from stateright_tpu_torch.models.ping_pong import (
        PingPongCfg,
        ping_pong_model,
    )

    checker = ping_pong_model(PingPongCfg(max_nat=1)).checker() \
        .spawn_on_demand()
    views, err = state_views(checker, "/")
    assert err is None
    assert all(v.get("svg", "").startswith("<svg") for v in views)
    views, err = state_views(checker, f"/{views[0]['fingerprint']}")
    assert err is None
    delivered = [v for v in views if "fingerprint" in v]
    assert delivered and all("svg" in v for v in delivered)
    assert any("marker-end" in v["svg"] for v in delivered)


# -- the views' JSON equal to the JAX package's -----------------------------


def _json(x):
    return json.loads(json.dumps(x))


def _browse(pkg_views, checker, depth=2):
    """The views along a path: the init states, then each step's
    successors of the first view, ``depth`` steps deep."""
    out = []
    path = ""
    for _ in range(depth + 1):
        views, err = pkg_views.state_views(checker, path or "/")
        assert err is None
        out.append(_json(views))
        nxt = next(v for v in views if "fingerprint" in v)
        path += f"/{nxt['fingerprint']}"
    return out


def _models(name):
    if name == "2pc":
        from stateright_tpu.models.two_phase_commit import TwoPhaseSys as J

        return J(rm_count=3), TwoPhaseSys(rm_count=3)
    from stateright_tpu.models.ping_pong import PingPongCfg as JC
    from stateright_tpu.models.ping_pong import ping_pong_model as jm
    from stateright_tpu_torch.models.ping_pong import (
        PingPongCfg,
        ping_pong_model,
    )

    return jm(JC(max_nat=2)), ping_pong_model(PingPongCfg(max_nat=2))


@pytest.mark.parametrize("name", ["2pc", "ping-pong"])
def test_views_equal_jax(name):
    """``state_views`` along one path, ``get_properties`` and
    ``status_view`` (before and after ``run_to_completion``) give JSON
    equal to JAX's on the same model; the actor model's views carry its
    SVG, equal to JAX's."""
    from stateright_tpu.explorer import server as jax_server
    from stateright_tpu_torch.explorer import server as port_server

    jm, pm = _models(name)
    jc, pc = jm.checker().spawn_on_demand(), pm.checker().spawn_on_demand()
    jv, pv = _browse(jax_server, jc), _browse(port_server, pc)
    assert jv == pv
    if name == "ping-pong":
        assert all("svg" in v for step in pv for v in step
                   if "fingerprint" in v)
    assert _json(jax_server.status_view(jc)) == _json(status_view(pc))
    jc.run_to_completion()
    pc.run_to_completion()
    assert _json(jax_server.get_properties(jc)) == _json(get_properties(pc))
    assert _json(jax_server.status_view(jc)) == _json(status_view(pc))


def test_http_answers_equal_jax():
    """The same requests to each package's server give the same JSON."""
    from stateright_tpu.explorer import server as jax_server
    from stateright_tpu.models.two_phase_commit import TwoPhaseSys as J

    answers = []
    for pkg, model in ((jax_server, J(rm_count=3)),
                       (None, TwoPhaseSys(rm_count=3))):
        make, snap = ((pkg.make_server, pkg.Snapshot) if pkg is not None
                      else (make_server, Snapshot))
        server = make(model.checker().spawn_on_demand(), snap(),
                      "127.0.0.1", 0)
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        port = server.server_address[1]
        try:
            init = json.loads(_get(port, "/.states/"))
            fp = init[0]["fingerprint"]
            answers.append(dict(
                init=init, step=json.loads(_get(port, f"/.states/{fp}")),
                status=json.loads(_get(port, "/.status"))))
        finally:
            _stop(server, t)
    assert answers[0] == answers[1]


@pytest.mark.parametrize("argv,model,header", [
    (["2pc", "explore", "2"], "TwoPhaseSys",
     "Exploring state space for two phase commit with 2 resource "
     "managers on "),
    (["linearizable-register", "explore", "1"], "ActorModel",
     "Exploring state space for a linearizable register with 1 clients "
     "on "),
])
def test_cli_explore_lane(argv, model, header, tmp_path):
    """``explore [COUNT] [ADDRESS]`` in a process of its own: the JAX
    lane's header, then the Explorer answering at ADDRESS until the
    process is stopped."""
    import os
    import socket
    import subprocess
    import sys
    import time

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    addr = f"127.0.0.1:{port}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "stateright_tpu_torch", *argv, addr],
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=root),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + TIMEOUT
        while True:
            try:
                status = json.loads(_get(port, "/.status"))
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read()
                assert time.monotonic() < deadline
                time.sleep(0.1)
        assert status["model"] == model and status["done"] is False
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=TIMEOUT)
    assert out.startswith(header + addr + ".\n"), out
    assert f"Exploring. Navigate to http://{addr}" in out
