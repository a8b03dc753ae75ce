"""The PyTorch port's live metrics plane (metrics.py) on the CPU, held
against the JAX package's ``metrics`` module: JAX
``tests/test_metrics.py``'s registry, histogram, quantile, Prometheus,
null-path and rollup cases (:58-:251) on the port's module; the
tracer->metrics bridge over the committed ``TRACE_r30.jsonl`` /
``TRACE_r31.jsonl`` and over a port ``2pc check-gpu 4 --device cpu``
trace, snapshot and Prometheus text equal to JAX's bridge over the same
events; the SLO evaluation and artifact summary equal to JAX's; and the
CLI's ``--metrics-interval`` rollup, read back by JAX's ``load_rollup``,
with JAX's three flag refusals."""

import json
import os
import time

import pytest

from stateright_tpu_torch import metrics as M
from stateright_tpu_torch.metrics import (
    BRIDGE_FAMILIES,
    SECONDS_BUCKETS,
    MetricsRegistry,
    Rollup,
    bridge_events,
    bucket_quantile,
    evaluate_slo,
    load_rollup,
    parse_prometheus,
    quantile,
    slo_observed,
)

pytestmark = pytest.mark.metrics

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- JAX tests/test_metrics.py:58-251 on the port's module -------------------


def test_registry_counter_gauge_semantics():
    r = MetricsRegistry()
    c = r.counter("stpu_things_total", "things")
    c.inc()
    c.inc(2.5, lane="a")
    c.inc(lane="a")
    assert r.counter_value("stpu_things_total") == 1.0
    assert r.counter_value("stpu_things_total", lane="a") == 3.5
    assert c.total() == 4.5
    assert r.counter("stpu_things_total") is c
    g = r.gauge("stpu_depth")
    g.set(3)
    g.inc()
    g.dec(2)
    assert r.gauge_value("stpu_depth") == 2.0
    assert r.counter_value("stpu_things_total", lane="ghost") == 0.0
    assert r.gauge_value("stpu_missing") == 0.0


def test_registry_kind_conflict_raises():
    r = MetricsRegistry()
    r.counter("stpu_x")
    with pytest.raises(ValueError):
        r.gauge("stpu_x")
    with pytest.raises(ValueError):
        r.histogram("stpu_x")


def test_histogram_bucket_edges_sub_ms_and_tail():
    assert SECONDS_BUCKETS[0] <= 0.0001
    assert SECONDS_BUCKETS[-1] >= 120.0
    r = MetricsRegistry()
    h = r.histogram("stpu_t_seconds", "t")
    for v in (0.00005, 0.0002, 70.0, 400.0):
        h.observe(v)
    h.observe(None)
    h.observe(float("nan"))
    snap = r.snapshot()["stpu_t_seconds"]["values"][0]
    assert snap["count"] == 4
    counts = snap["counts"]
    assert len(counts) == len(SECONDS_BUCKETS) + 1
    assert counts[0] == 1
    assert counts[1] == 1
    assert counts[SECONDS_BUCKETS.index(120.0)] == 1
    assert counts[-1] == 1
    assert snap["min"] == pytest.approx(0.00005)
    assert snap["max"] == pytest.approx(400.0)


def test_quantile_exact_small_n():
    assert quantile([], 0.5) is None
    assert quantile([7.0], 0.99) == 7.0
    assert quantile([1.0, 2.0, 3.0, 4.0], 0.5) == 2.5
    assert quantile([4.0, 1.0, 3.0, 2.0], 0.0) == 1.0
    assert quantile([4.0, 1.0, 3.0, 2.0], 1.0) == 4.0


def test_quantile_pin_exact_vs_bucket_interpolated():
    sample = [0.0008, 0.0012, 0.003, 0.004, 0.0041, 0.009, 0.02,
              0.024, 0.09, 0.4]
    r = MetricsRegistry()
    h = r.histogram("stpu_pin_seconds", "pin")
    for v in sample:
        h.observe(v)
    for q in (0.50, 0.90, 0.99):
        exact = quantile(sample, q)
        streamed = h.quantile(q)
        edges = (0.0,) + SECONDS_BUCKETS
        lo = max(e for e in edges if e <= exact)
        hi = min(e for e in SECONDS_BUCKETS if e >= exact)
        assert lo <= streamed <= hi, (q, exact, streamed)
    counts = r.snapshot()["stpu_pin_seconds"]["values"][0]["counts"]
    assert bucket_quantile(SECONDS_BUCKETS, counts, 0.0,
                           vmin=min(sample), vmax=max(sample)) \
        == pytest.approx(min(sample))
    assert bucket_quantile(SECONDS_BUCKETS, counts, 1.0,
                           vmin=min(sample), vmax=max(sample)) \
        == pytest.approx(max(sample))


def test_prometheus_escaping_and_roundtrip():
    from stateright_tpu.metrics import parse_prometheus as jax_parse

    r = MetricsRegistry()
    c = r.counter("stpu_esc_total", 'help with "quotes" and \\slash')
    c.inc(3, lane='say "hi"\nback\\slash')
    h = r.histogram("stpu_esc_seconds", "hist")
    h.observe(0.002, lane="a")
    h.observe(7.0, lane="a")
    text = r.render_prometheus()
    assert 'lane="say \\"hi\\"\\nback\\\\slash"' in text
    assert 'le="+Inf"' in text
    assert "stpu_esc_seconds_sum" in text
    assert "stpu_esc_seconds_count" in text
    back = parse_prometheus(text)
    assert back == jax_parse(text)
    assert back["stpu_esc_total"]["values"][0]["value"] == 3.0
    assert (back["stpu_esc_total"]["values"][0]["labels"]["lane"]
            == 'say "hi"\nback\\slash')
    hv = back["stpu_esc_seconds"]["values"][0]
    snap = r.snapshot()["stpu_esc_seconds"]["values"][0]
    assert hv["counts"] == snap["counts"]
    assert hv["count"] == 2
    assert hv["sum"] == pytest.approx(7.002)


def test_null_path_is_one_shared_singleton():
    assert M.active_registry() is None
    assert M.counter("stpu_anything_total") is M._NULL
    assert M.gauge("stpu_anything") is M._NULL
    assert M.histogram("stpu_anything_seconds") is M._NULL
    assert M.counter("stpu_other_total") is M._NULL
    assert type(M._NULL).__slots__ == ()
    assert M._NULL.inc(1.0, lane="x") is None
    assert M._NULL.observe(0.5) is None
    assert M._NULL.set(1) is None
    assert M._NULL.value() == 0.0
    assert M._NULL.quantile(0.99) is None


def test_activate_scopes_the_module_hooks():
    r = MetricsRegistry()
    with M.activate(r):
        assert M.active_registry() is r
        M.counter("stpu_live_total").inc()
        with pytest.raises(RuntimeError):
            with M.activate(MetricsRegistry()):
                pass
    assert M.active_registry() is None
    assert r.counter_value("stpu_live_total") == 1.0


def test_rollup_jsonl_validates_and_loads(tmp_path):
    from stateright_tpu_torch.telemetry import load_trace, validate_events

    r = MetricsRegistry()
    r.counter("stpu_ticks_total").inc(5)
    r.histogram("stpu_tick_seconds").observe(0.01)
    path = str(tmp_path / "metrics.jsonl")
    roll = Rollup(path, 0.05, source=lambda: r).start()
    time.sleep(0.18)
    roll.stop()
    events = load_trace(path)
    validate_events(events)
    assert all(ev["ev"] == "metrics_rollup" for ev in events)
    assert len(events) >= 2
    last = load_rollup(path)
    assert (last["families"]["stpu_ticks_total"]["values"][0]["value"]
            == 5.0)
    ts = [ev["t"] for ev in events]
    assert ts == sorted(ts)


def test_rollup_rejects_nonpositive_interval(tmp_path):
    with pytest.raises(ValueError):
        Rollup(str(tmp_path / "m.jsonl"), 0.0, source=MetricsRegistry)


def test_load_rollup_requires_a_rollup_event(tmp_path):
    p = tmp_path / "t.jsonl"
    p.write_text(json.dumps(
        dict(ev="run_begin", run=0, t=0.0, lane={}, schema=1)) + "\n")
    with pytest.raises(ValueError):
        load_rollup(str(p))


# -- the bridge, held to JAX's -----------------------------------------------


def _same_bridge(events):
    """The port's bridge and JAX's over ``events``: equal snapshots,
    equal Prometheus text, and the port's text parsed alike by both."""
    from stateright_tpu import metrics as jm

    port = bridge_events(events)
    jax_reg = jm.bridge_events(events)
    assert port.snapshot() == jax_reg.snapshot()
    text = port.render_prometheus()
    assert text == jax_reg.render_prometheus()
    assert jm.parse_prometheus(text) == parse_prometheus(text)
    return port


@pytest.mark.parametrize("trace", ["TRACE_r30.jsonl", "TRACE_r31.jsonl"])
def test_bridge_over_committed_traces_equals_jax(trace):
    from stateright_tpu_torch.telemetry import load_trace, validate_events

    events = load_trace(os.path.join(REPO_ROOT, trace))
    validate_events(events)
    reg = _same_bridge(events)
    for fam in reg.snapshot():
        assert fam in BRIDGE_FAMILIES

    def n(ev):
        return sum(1 for e in events if e.get("ev") == ev)

    assert reg.counter("stpu_waves_total").total() == n("wave")
    assert reg.counter("stpu_chunks_total").total() == n("chunk")
    assert reg.counter("stpu_verdicts_total").total() == n("verdict")
    assert (reg.counter("stpu_program_builds_total").total()
            == n("program_build"))
    assert reg.counter("stpu_batched_sessions_total").total() == n("batch")


def test_bridge_over_a_port_trace_equals_jax(tmp_path, capsys):
    from stateright_tpu_torch.cli import main
    from stateright_tpu_torch.telemetry import load_trace

    main(["2pc", "check-gpu", "4", "--device", "cpu", "--trace",
          f"--trace-root={tmp_path}"])
    assert "unique=1568" in capsys.readouterr().out
    events = load_trace(str(tmp_path / "TRACE_r01.jsonl"))
    reg = _same_bridge(events)
    assert reg.counter("stpu_waves_total").total() == 14
    assert reg.counter("stpu_new_states_total").total() == 1568 - 1
    assert reg.counter_value("stpu_verdicts_total", kind="discovery") == 2


# -- SLO ----------------------------------------------------------------------


def _rollup_families():
    r = MetricsRegistry()
    h = r.histogram("stpu_time_to_verdict_seconds")
    for v in (0.5, 1.0, 2.0):
        h.observe(v)
    q = r.histogram("stpu_queue_wait_seconds")
    q.observe(0.01)
    adm = r.counter("stpu_serve_admission_total")
    adm.inc(9, decision="accepted")
    adm.inc(1, decision="refused")
    warm = r.counter("stpu_serve_warm_hits_total")
    warm.inc(3, result="warm")
    warm.inc(1, result="cold")
    return r.snapshot()


def test_slo_evaluation_equals_jax(tmp_path):
    from stateright_tpu import artifacts as ja
    from stateright_tpu import metrics as jm
    from stateright_tpu_torch import artifacts

    families = _rollup_families()
    obs = slo_observed(families)
    assert obs == jm.slo_observed(families)
    assert obs["refusal_rate"] == pytest.approx(0.1)
    assert obs["cache_hit_rate"] == pytest.approx(0.75)
    for spec in (dict(max_ttv_p99_sec=60.0, max_refusal_rate=0.2,
                      min_cache_hit_rate=0.5),
                 dict(max_refusal_rate=0.05),
                 dict(max_queue_wait_p99_sec=1.0)):
        assert evaluate_slo(spec, obs) == jm.evaluate_slo(spec, obs)
    assert evaluate_slo(dict(max_refusal_rate=0.05), obs)["ok"] is False
    unmeasured = evaluate_slo(dict(max_queue_wait_p99_sec=1.0),
                              slo_observed({}))
    assert unmeasured["objectives"][0]["status"] == "unmeasured"
    with pytest.raises(ValueError):
        evaluate_slo(dict(max_bogus=1.0), obs)
    ev = evaluate_slo(dict(max_ttv_p99_sec=60.0), obs)
    path = M.write_slo_artifact(dict(evaluation=ev, observed=obs),
                                root=str(tmp_path))
    assert os.path.basename(path) == "SLO_r01.json"
    summary = artifacts.latest_slo_summary(str(tmp_path))
    want = ja.latest_slo_summary(str(tmp_path))
    for k in ("artifact", "ok", "objectives"):
        assert summary[k] == want[k], k
    assert summary["ok"] is True


# -- the CLI ------------------------------------------------------------------


def test_cli_rollup_and_flag_refusals(tmp_path, capsys):
    from stateright_tpu import cli as jax_cli
    from stateright_tpu import metrics as jm
    from stateright_tpu_torch.cli import _pop_metrics_flags, main

    path = tmp_path / "m.jsonl"
    main(["2pc", "check-gpu", "3", "--device", "cpu",
          "--metrics-interval=60", f"--metrics-path={path}"])
    assert "unique=288" in capsys.readouterr().out
    last = jm.load_rollup(str(path))  # JAX's reader validates it
    assert last == load_rollup(str(path))
    fam = last["families"]
    assert fam["stpu_waves_total"]["values"][0]["value"] == 11
    assert fam["stpu_new_states_total"]["values"][0]["value"] == 288 - 1
    assert not list(tmp_path.glob("TRACE_*"))
    assert _pop_metrics_flags(
        ["2pc", "check", "3", "--metrics-interval=2.5",
         "--metrics-path=m.jsonl"]) == (2.5, "m.jsonl", ["2pc", "check", "3"])
    for bad in (["--metrics-interval=0"], ["--metrics-interval"],
                ["x", "--metrics-path=m.jsonl"]):
        with pytest.raises(SystemExit) as port_exc:
            _pop_metrics_flags(bad)
        with pytest.raises(SystemExit) as jax_exc:
            jax_cli._pop_metrics_flags(bad)
        assert str(port_exc.value) == str(jax_exc.value)
    # a failed run still leaves its final line
    from stateright_tpu_torch import faultinject

    failed = tmp_path / "failed.jsonl"
    faultinject.arm("raise", "mid_chunk", 2)
    try:
        with pytest.raises(faultinject.InjectedFault):
            main(["2pc", "check-gpu", "3", "--device", "cpu",
                  "--metrics-interval=60", f"--metrics-path={failed}"])
    finally:
        faultinject.disarm_all()
    assert load_rollup(str(failed))["families"]["stpu_waves_total"][
        "values"][0]["value"] == 2
