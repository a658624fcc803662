"""The port's observability package (``repro_torch.obs``) against the JAX
package's ``repro.obs``.

* ``tests/test_obs.py``'s registry, tracer and event-log cases (the
  router telemetry and serve-loop cases wait for the router-telemetry
  slice);
* the same sequence of registry calls renders byte-equal Prometheus text
  in both packages (names, help, label order, bucket edges, ``_fmt``),
  and the same spans on the same clock give the same Chrome trace;
* the instrumented places: ``PlanCache`` / ``PipelineSharedCache`` /
  ``PagePool`` / ``PrefixIndex`` snapshots, ``autotune._record_mode``'s
  counter and gauge and the fired-faults counter publish the series the
  JAX package's publish.
"""
import json

import numpy as np
import pytest

from repro_torch import obs
from repro_torch.obs.metrics import _NOOP_FAMILY, MetricsRegistry, log_buckets
from repro_torch.obs.tracing import (
    Tracer,
    derive_request_latencies,
    span_coverage,
)


@pytest.fixture(autouse=True)
def _obs_clean():
    """Every test starts from and returns to the disabled baseline."""
    from repro import obs as jobs

    for o in (obs, jobs):
        o.configure(metrics=False, tracing=False, event_log=False,
                    reset=True)
    yield
    for o in (obs, jobs):
        o.configure(metrics=False, tracing=False, event_log=False,
                    reset=True)


def test_counter_gauge_histogram_semantics():
    reg = MetricsRegistry(enabled=True)
    c = reg.counter("repro_test_ops_total", "ops", labels=("kind",))
    c.labels("read").inc()
    c.labels("read").inc(2)
    c.labels("write").inc()
    assert reg.value("repro_test_ops_total", "read") == 3
    assert reg.value("repro_test_ops_total", "write") == 1
    with pytest.raises(ValueError):
        c.labels("read").inc(-1)
    g = reg.gauge("repro_test_depth", "queue depth")
    g.set(7)
    g.set(3.5)
    assert reg.value("repro_test_depth") == 3.5
    h = reg.histogram("repro_test_latency_seconds", "lat",
                      buckets=[0.01, 0.1, 1.0])
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    text = reg.render_prometheus()
    assert '# TYPE repro_test_latency_seconds histogram' in text
    assert 'repro_test_latency_seconds_bucket{le="0.01"} 1' in text
    assert 'repro_test_latency_seconds_bucket{le="1"} 3' in text
    assert 'repro_test_latency_seconds_bucket{le="+Inf"} 4' in text
    assert 'repro_test_latency_seconds_count 4' in text
    assert 'repro_test_ops_total{kind="read"} 3' in text


def test_kind_and_label_arity_mismatch_raise():
    reg = MetricsRegistry(enabled=True)
    reg.counter("repro_test_x", "x")
    with pytest.raises(ValueError):
        reg.gauge("repro_test_x", "x")
    fam = reg.counter("repro_test_y", "y", labels=("a", "b"))
    with pytest.raises(ValueError):
        fam.labels("only-one")


def test_disabled_registry_is_noop_singleton():
    reg = MetricsRegistry(enabled=False)
    fam = reg.counter("repro_test_never", "never")
    assert fam is _NOOP_FAMILY
    fam.inc()
    fam.labels("x").inc(10)
    reg.gauge("repro_test_g").set(1)
    reg.histogram("repro_test_h").observe(1)
    assert reg.families == {}
    assert reg.render_prometheus() == ""


def test_collect_polls_registered_objects():
    class Pool:
        def obs_metrics(self):
            return {"repro_test_free": 12, "repro_test_used": 4}

    reg = MetricsRegistry(enabled=True)
    p = Pool()
    reg.register_object(p)
    reg.collect()
    assert reg.value("repro_test_free", "pool", "0") == 12
    assert reg.value("repro_test_used", "pool", "0") == 4
    del p
    reg.collect()


def test_log_buckets_are_sorted_decades():
    from repro.obs.metrics import log_buckets as jlog_buckets

    b = log_buckets(1e-3, 1.0, 3)
    assert list(b) == sorted(b)
    assert b[0] == pytest.approx(1e-3) and b[-1] == pytest.approx(1.0)
    assert len(b) == 10
    assert b == jlog_buckets(1e-3, 1.0, 3)


def test_span_nesting_and_chrome_schema():
    clock_vals = iter([1.0, 1.1, 1.2, 1.6, 2.0])
    tr = Tracer(enabled=True, clock=lambda: next(clock_vals))
    with tr.span("outer", n=1):
        with tr.span("inner"):
            pass
        tr.instant("tick", rid=7)
    inner, outer = tr.events[0], tr.events[2]
    assert (inner["name"], inner["depth"]) == ("inner", 1)
    assert (outer["name"], outer["depth"]) == ("outer", 0)
    trace = tr.chrome_trace()
    json.dumps(trace)
    evs = trace["traceEvents"]
    assert {e["ph"] for e in evs} == {"X", "i"}
    for e in evs:
        assert e["ts"] >= 0 and "pid" in e and "tid" in e
        if e["ph"] == "X":
            assert e["dur"] >= 0
        else:
            assert e["s"] == "p"
    assert next(e for e in evs if e["ph"] == "i")["args"]["rid"] == 7


def test_disabled_tracer_records_nothing():
    tr = Tracer(enabled=False)
    with tr.span("x"):
        tr.instant("y")
    assert tr.events == []
    assert tr.chrome_trace() == {"traceEvents": []}


def test_span_coverage_union():
    evs = [{"ph": "X", "t": 0.0, "dur": 1.0},
           {"ph": "X", "t": 0.5, "dur": 1.0},
           {"ph": "X", "t": 3.0, "dur": 1.0},
           {"ph": "i", "t": 9.0}]
    assert span_coverage(evs) == pytest.approx(2.5 / 4.0)
    assert span_coverage([]) == 1.0


def test_derive_request_latencies_bitwise():
    t0 = 100.0
    t_first = {1: 100.75, 2: 101.5}
    events = [{"name": "serve.run", "ph": "X", "t": t0, "dur": 10.0,
               "args": {}}]
    for rid, t in t_first.items():
        events.append({"name": "serve.first_token", "ph": "i", "t": t,
                       "args": {"rid": rid}})
    for t in (101.0, 101.5):
        events.append({"name": "serve.token", "ph": "i", "t": t,
                       "args": {"rid": 1}})
    ttft, tpot = derive_request_latencies(events)
    assert ttft[1] == t_first[1] - t0 and ttft[2] == t_first[2] - t0
    assert tpot == {1: pytest.approx((101.5 - 100.75) / 2)}


def test_event_log_records_and_jsonl(tmp_path):
    clock_vals = iter([5.0, 6.0])
    log = obs.EventLog(enabled=True, clock=lambda: next(clock_vals))
    log.emit("train.replan", reason="straggler", shares=[3, 1])
    log.emit("serve.recover", reason="engine step failure")
    assert [r["kind"] for r in log.records] == ["train.replan",
                                                "serve.recover"]
    assert log.records[0]["t"] == 5.0
    assert log.records[0]["reason"] == "straggler"
    path = tmp_path / "events.jsonl"
    log.write_jsonl(str(path))
    assert [json.loads(x) for x in path.read_text().splitlines()] == \
        log.records
    off = obs.EventLog(enabled=False)
    off.emit("x")
    assert off.records == []


# ---------------------------------------------------------------------------
# the same text as the JAX package's
# ---------------------------------------------------------------------------

def _drive(pkg):
    """One sequence of registry calls, made on ``pkg``'s classes."""
    reg = pkg.MetricsRegistry(enabled=True)
    rng = np.random.default_rng(0)
    c = reg.counter("repro_t_ops_total", "ops by kind", labels=("kind", "x"))
    for v in rng.integers(0, 5, size=12):
        c.labels(f"k{v % 3}", v % 2).inc(float(v))
    reg.gauge("repro_t_depth", "depth").set(float(rng.normal()))
    reg.gauge("repro_t_int", "").set(3)
    h = reg.histogram("repro_t_step_seconds", "Wall time per step",
                      labels=("phase",))
    for v in rng.lognormal(-3, 2, size=40):
        h.labels("train" if v < 0.1 else "serve").observe(float(v))
    reg.histogram("repro_t_b", "custom",
                  buckets=pkg.log_buckets(1e-3, 10.0, 4)).observe(0.02)

    class Snap:
        def obs_metrics(self):
            return {"repro_t_free": 12, "repro_t_ratio": 0.375}

    keep = Snap()
    reg.register_object(keep)
    text = reg.render_prometheus()
    clock = iter(np.cumsum(rng.random(8)).tolist())
    tr = pkg.Tracer(enabled=True, clock=lambda: next(clock))
    with tr.span("train.run", steps=2):
        with tr.span("train.step", step=0):
            tr.instant("tick", rid=3, shares=(1, 2))
        tr.complete("train.data", 0.5, 0.75, step=1)
    return text, tr.chrome_trace(), pkg.span_coverage(tr.events)


def test_prometheus_text_and_chrome_trace_equal_the_jax_package():
    from repro import obs as jobs

    text, trace, cov = _drive(obs)
    jtext, jtrace, jcov = _drive(jobs)
    assert text == jtext
    assert "repro_t_step_seconds_bucket{phase=\"serve\",le=\"+Inf\"}" in text
    assert trace == jtrace
    assert cov == jcov


def test_instrumented_sites_publish_the_jax_series():
    """PlanCache / cache snapshots, the autotune decision counter and the
    fired-faults counter, driven alike in both packages."""
    from repro import obs as jobs
    from repro.parallel import autotune as jautotune
    from repro.parallel import cache as jcache
    from repro.parallel.sharding import ParallelConfig as JPC
    from repro.runtime import faults as jfaults
    from repro_torch.parallel import autotune, cache
    from repro_torch.parallel.sharding import ParallelConfig
    from repro_torch.runtime import faults

    out = []
    for o, cache_m, at, pc, fl in (
            (obs, cache, autotune, ParallelConfig, faults),
            (jobs, jcache, jautotune, JPC, jfaults)):
        o.configure(metrics=True, tracing=False, event_log=False,
                    reset=True)
        reg = o.MetricsRegistry(enabled=True)
        pcache = cache_m.PlanCache(4)
        pcache.fetch(("a",), lambda: {})
        pcache.fetch(("a",), lambda: {})
        pool = cache_m.PagePool(9, page_bytes=64)
        index = cache_m.PrefixIndex(4)
        for x in (pcache, pool, index):
            reg.register_object(x)
        text = reg.render_prometheus()
        for mode in ("data_centric", "model_centric", "data_centric"):
            at.resolve_layer_mode(64, d=32, f=64, e=4, k=2,
                                  cfg=pc(forced_layer_mode=mode), mesh=None)
        plan = fl.FaultPlan([fl.Fault(site="train.step", kind="delay",
                                      at=0, payload={"delay_s": 0.0}),
                             fl.Fault(site="train.loss", kind="nan",
                                      every=2, times=3)])
        with fl.scope(plan):
            for _ in range(6):
                fl.inject("train.step")
                fl.inject("train.loss")
        series = {
            "decisions": [o.registry.value("repro_autotune_mode_total", m,
                                           "forced")
                          for m in ("data_centric", "model_centric")],
            "fired": [o.registry.value("repro_faults_fired_total", s, k)
                      for s, k in (("train.step", "delay"),
                                   ("train.loss", "nan"))],
        }
        out.append((text, series, plan.fired))
        o.configure(metrics=False, tracing=False, event_log=False,
                    reset=True)
    assert out[0] == out[1]
    assert out[0][1] == {"decisions": [2.0, 1.0], "fired": [1.0, 2.0]}
    assert 'repro_cache_hits{kind="plancache",instance="0"} 1' in out[0][0]
    assert 'repro_cache_free_pages{kind="pagepool",instance="1"}' in \
        out[0][0]
