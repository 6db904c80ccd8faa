"""The port's observability layer (counterpart of the pure parts of
``tests/test_obs.py``): tracing spans and their Chrome-trace export, the
metrics registry's bounded reservoirs and its v2 snapshot, the flight
recorder, the batcher's auto-dump on a typed poison failure, the
calibration and compression spans, and ``device_trace`` through
``torch.profiler``. The reservoirs are also held sample for sample against
the JAX package's, since both seed them the same way."""
import json

import numpy as np
import pytest
import torch

from repro.obs import metrics as jmetrics
from repro_torch.configs import get_config
from repro_torch.core import compress as CC
from repro_torch.dist import faultinject as FI
from repro_torch.models import transformer as T
from repro_torch.obs import flightrec, metrics, trace
from repro_torch.serve import admission as adm
from repro_torch.serve.engine import ContinuousBatcher, Request, ServeConfig
from torch_threads import one_blas_thread  # noqa: F401 (autouse)

torch.set_num_threads(1)

CFG = get_config("llama-mini").replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, rank_multiple=1)
SCFG = ServeConfig(batch=4, max_len=64)


@pytest.fixture(scope="module")
def params():
    return T.init_model(CFG, seed=0, device="cpu")[0]


def make_requests(n=6, n_new=5, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, n_new=n_new,
                    tokens=rng.integers(0, CFG.vocab_size, size=(7,),
                                        dtype=np.int32))
            for i in range(n)]


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------
def test_disabled_span_is_the_shared_singleton():
    assert not trace.enabled()
    s1 = trace.span("decode_step", step=1)
    assert s1 is trace.NULL_SPAN and trace.span("x") is trace.NULL_SPAN
    with s1:
        pass
    trace.instant("x")
    trace.counter("x", v=1)
    trace.async_begin("x", 1)
    trace.async_end("x", 1)
    assert trace.current() is None
    t = trace.enable()
    try:
        assert trace.span("s") is not trace.NULL_SPAN
    finally:
        assert trace.disable() is t
    assert trace.span("s") is trace.NULL_SPAN


def test_chrome_trace_export_is_schema_valid(tmp_path):
    out = tmp_path / "t.json"
    with trace.tracing(out=str(out)) as t:
        with trace.span("outer", a=1):
            with trace.span("inner"):
                pass
        trace.instant("blip", why="test")
        trace.counter("serve", queue_depth=3)
        trace.async_begin("request", 7, n_new=5)
        trace.async_end("request", 7, status="done")
    obj = json.loads(out.read_text())
    assert trace.validate_chrome_trace(obj) == []
    assert obj["otherData"]["schema"] == trace.SCHEMA
    evs = {e["name"]: e for e in obj["traceEvents"]}
    assert {"outer", "inner", "blip", "serve", "request"} <= set(evs)
    inner, outer = evs["inner"], evs["outer"]
    assert inner["ph"] == outer["ph"] == "X"
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert t.dropped == 0
    bad = {"traceEvents": [{"name": "x", "ph": "Z", "pid": 1, "tid": 1},
                           {"name": "x", "ph": "X", "pid": 1, "tid": 1,
                            "ts": 0.0, "dur": -5}]}
    assert len(trace.validate_chrome_trace(bad)) == 2


def test_tracer_bounds_memory_and_counts_drops():
    t = trace.Tracer(max_events=4)
    trace.enable(t)
    try:
        for i in range(10):
            with trace.span("s", i=i):
                pass
    finally:
        trace.disable()
    assert len(t.events) <= 4 and t.dropped > 0
    assert t.to_chrome()["otherData"]["dropped_events"] == t.dropped


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with trace.device_trace(str(tmp_path / "dev")) as d:
        torch.ones(8) @ torch.ones(8)
    assert d == str(tmp_path / "dev")
    obj = json.loads((tmp_path / "dev" / "device_trace.json").read_text())
    assert obj["traceEvents"]
    with trace.device_trace(None) as d:
        assert d is None


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def test_histogram_zero_one_sample_and_bounds():
    h = metrics.Histogram("h")
    assert h.summary() == {"p50": 0.0, "p95": 0.0, "mean": 0.0, "n": 0,
                           "min": 0.0, "max": 0.0}
    h.observe(42.0)
    s = h.summary()
    assert s["p50"] == s["p95"] == s["mean"] == 42.0 and s["n"] == 1
    h = metrics.Histogram("ttft_ms", capacity=64)
    for i in range(10_000):
        h.observe(float(i))
    assert len(h.samples) == 64 and h.n == 10_000
    assert h.sum == sum(range(10_000)) and (h.min, h.max) == (0.0, 9999.0)


def test_histogram_reservoir_is_deterministic_and_matches_jax():
    def fill(mod, name):
        h = mod.Histogram(name, capacity=16)
        for i in range(1000):
            h.observe(float(i))
        return list(h.samples)
    assert fill(metrics, "a") == fill(metrics, "a") == fill(jmetrics, "a")
    assert fill(metrics, "a") != fill(metrics, "b")


def test_servemetrics_bounded_and_snapshot_v2_schema():
    m = adm.ServeMetrics()
    for _ in range(100_000):
        m.observe_ttft(0.01)
    assert len(m._ttft.samples) <= metrics.DEFAULT_RESERVOIR
    m = adm.ServeMetrics()
    m.bump("submitted", 3)
    m.observe_ttft(0.002)
    m.step_at_level(1)
    snap = m.snapshot(queue_depth=2, rank_level=1,
                      engine_stats={"prefill_retraces": 4})
    json.dumps(snap)
    assert snap["schema"] == metrics.SCHEMA == jmetrics.SCHEMA
    assert snap["counters"]["submitted"] == 3
    assert snap["counters"]["prefill_retraces"] == 4
    assert snap["gauges"]["queue_depth"] == 2
    assert snap["histograms"]["ttft_ms"]["n"] == 1
    assert snap["rank_residency"] == {"1": 1}
    assert snap["submitted"] == 3 and snap["rank_level"] == 1
    assert snap["ttft"] == {"p50_ms": 2.0, "p95_ms": 2.0, "mean_ms": 2.0,
                            "n": 1}
    assert snap["engine"] == {"prefill_retraces": 4}


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------
def test_flightrec_ring_is_bounded_and_dump_validates(tmp_path):
    fr = flightrec.FlightRecorder(dump_dir=str(tmp_path), max_events=8,
                                  max_timings=4)
    for i in range(50):
        fr.note("tick", i=i)
        fr.step_timing(i, 1.5, live=2)
    assert len(fr.events) == 8 and len(fr.step_timings) == 4
    obj = json.loads(open(fr.dump("stalled", {"queue_depth": 3})).read())
    assert flightrec.validate_dump(obj) == []
    assert obj["reason"] == "stalled"
    assert [e["i"] for e in obj["events"]] == list(range(42, 50))
    assert flightrec.FlightRecorder().dump("stalled") is None


def test_poison_failure_autodumps_identifying_rid_and_rung(params,
                                                           tmp_path):
    plan = FI.FaultPlan.from_json(json.dumps({"seed": 5,
                                              "poison_rids": [2]}))
    cb = ContinuousBatcher(
        params, CFG, SCFG, admission=adm.AdmissionConfig(max_retries=1),
        faults=plan, flight=flightrec.FlightRecorder(dump_dir=str(tmp_path)),
        device="cpu")
    for r in make_requests():
        cb.submit(r)
    res = cb.run_until_drained()
    assert res.status == "drained" and [r.rid for r in res.failed] == [2]
    assert len(cb.flight.dumps) == 1
    obj = json.loads(open(cb.flight.dumps[0]).read())
    assert flightrec.validate_dump(obj) == []
    assert obj["reason"] == "failed_poison"
    assert obj["context"]["rid"] == 2 and obj["context"]["rank_level"] == 0
    assert obj["context"]["fault_plan"]["poison_rids"] == [2]
    assert any(e["kind"] == "poison" and 2 in e["rids"]
               for e in obj["events"])
    assert obj["step_timings"]


def _traced_run(params, plan_json):
    faults = FI.FaultPlan.from_json(plan_json) if plan_json else None
    with trace.tracing() as t:
        cb = ContinuousBatcher(params, CFG, SCFG, faults=faults,
                               admission=adm.AdmissionConfig(max_retries=1),
                               device="cpu")
        for r in make_requests():
            cb.submit(r)
        res = cb.run_until_drained()
    evs = sorted((e for e in t.events if e["seq"] >= 0),
                 key=lambda e: e["seq"])
    return [(e["name"], e["ph"], json.dumps(e.get("args", {}),
                                            sort_keys=True))
            for e in evs], res.status


def test_batcher_event_order_is_deterministic_under_a_seeded_plan(params):
    plan = json.dumps({"seed": 11, "nan_decode_step": 2,
                       "poison_rids": [3]})
    sig1, st1 = _traced_run(params, plan)
    sig2, st2 = _traced_run(params, plan)
    assert st1 == st2 == "drained" and sig1 == sig2
    names = {s[0] for s in sig1}
    assert {"engine_step", "admit", "prefill", "decode_step", "purge",
            "request", "serve"} <= names
    assert _traced_run(params, "")[0] != sig1


# ---------------------------------------------------------------------------
# calibration and compression spans
# ---------------------------------------------------------------------------
def test_calibration_and_compression_spans(params):
    rng = np.random.default_rng(1)
    calib = [{"tokens": torch.as_tensor(rng.integers(
        0, CFG.vocab_size, (2, 16), dtype=np.int32))} for _ in range(2)]
    with trace.tracing() as t:
        CC.build_plan_and_params(params, CFG,
                                 CC.CompressionConfig(ratio=0.4), calib)
        CC.build_plan_and_params(params, CFG,
                                 CC.CompressionConfig(ratio=0.4,
                                                      refine=True),
                                 calib, device=True)
    spans = [e for e in t.events if e["ph"] == "X"]
    names = [e["name"] for e in spans]
    for name in ("calibrate", "calib_ingest", "calib_flush",
                 "calib_finalize", "decompose_host", "decompose_bucket",
                 "refine"):
        assert name in names, name
    ingest = next(e for e in spans if e["name"] == "calib_ingest")
    assert set(ingest["args"]) == {"since_flush"}
    bucket = next(e for e in spans if e["name"] == "decompose_bucket")
    assert set(bucket["args"]) == {"d1", "nd2", "kmax", "n_groups"}
