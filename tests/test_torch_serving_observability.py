"""The port's serving observability against the reference's.

- one routed request is one trace: ``serve.route`` (router) →
  ``serve.generate`` (replica) → ``serve.queue_wait`` →
  ``serve.prefill_compute`` → ``serve.first_step`` → ``serve.decode``,
  whose first three segments sum to the response's ``ttft_s`` within the
  reference's ``abs=0.25``, and the chrome waterfall of the serving track
  equals the reference builder's for the same spans;
- a re-route is a span event on the route span, and the replica sees the
  request as re-routed;
- ``classify`` over the reference's decision table, and over a seeded
  sweep of segment dicts, equals ``dlrover_tpu.serving.tail.classify``;
- the ``TailAttributor``'s counts, journal and worst requests equal the
  reference's on the same completions;
- exemplar rendering is the reference registry's text;
- the replica's ``/metrics``, ``/events`` and ``/debug/bundle``, the
  prefix cache's journal events, and a replica under a JAX router.
"""

import json
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")

from dlrover_tpu.observability import tracing as jtracing  # noqa: E402
from dlrover_tpu.observability import timeline as jtimeline  # noqa: E402
from dlrover_tpu.observability.registry import (  # noqa: E402
    MetricsRegistry as JaxRegistry,
)
from dlrover_tpu.serving import tail as jtail  # noqa: E402

from dlrover_tpu_torch.common.constants import (  # noqa: E402
    ConfigKey,
    MetricLabel,
    SpanName,
)
from dlrover_tpu_torch.master.master import LocalJobMaster  # noqa: E402
from dlrover_tpu_torch.observability import timeline  # noqa: E402
from dlrover_tpu_torch.observability import tracing  # noqa: E402
from dlrover_tpu_torch.observability.journal import JournalEvent  # noqa: E402
from dlrover_tpu_torch.observability.registry import (  # noqa: E402
    MetricsRegistry,
)
from dlrover_tpu_torch.serving import tail  # noqa: E402
from dlrover_tpu_torch.serving.engine import ToyEngine  # noqa: E402
from dlrover_tpu_torch.serving.prefix_cache import (  # noqa: E402
    PrefixCachingEngine,
    RadixPrefixCache,
)
from dlrover_tpu_torch.serving.replica import DecodeReplica  # noqa: E402
from dlrover_tpu_torch.serving.router import RequestRouter  # noqa: E402

WATERFALL = (SpanName.SERVE_ROUTE, SpanName.SERVE_GENERATE,
             SpanName.SERVE_QUEUE_WAIT, SpanName.SERVE_PREFILL_COMPUTE,
             SpanName.SERVE_FIRST_STEP, SpanName.SERVE_DECODE)


@pytest.fixture(autouse=True)
def fresh_tracers(tmp_path, monkeypatch):
    monkeypatch.setenv(ConfigKey.TRACE_DIR, str(tmp_path / "bundles"))
    tracing.reset_tracer()
    jtracing.reset_tracer()
    yield
    tracing.reset_tracer()
    jtracing.reset_tracer()


def _serving_stack(node_id, engine=None, registry=None):
    """An in-process port master, replica and router sharing one tracer
    ring, so a test reads both sides of the RPC hop."""
    master = LocalJobMaster(job_name="serve-obs", node_num=1, min_nodes=1)
    master.prepare()
    replica = DecodeReplica(
        master.addr, node_id=node_id,
        engine=engine or ToyEngine(slots=2, step_delay_s=0.002),
        buckets=(8,), heartbeat_interval_s=0.05, registry=registry)
    replica.start()
    router = RequestRouter(replicas_fn=master.serve_registry.live,
                           registry=MetricsRegistry(),
                           request_timeout_s=30.0)
    return master, replica, router


def _http_get(addr, path):
    with urllib.request.urlopen(f"http://{addr}{path}", timeout=10) as r:
        return r.status, r.read().decode()


# -- the waterfall -------------------------------------------------------------


def test_one_request_one_trace_with_ttft_decomposition():
    master, replica, router = _serving_stack(310)
    try:
        resp = router.submit([1, 2, 3], max_new_tokens=4,
                             request_id="obs-0001")
    finally:
        replica.stop()
        master.stop()
    assert resp.success, resp.message
    assert resp.trace_id
    spans = tracing.get_tracer().spans_for_trace(resp.trace_id)
    # exactly the six serve.* spans, one each, all of this trace
    assert sorted(sp.name for sp in spans) == sorted(WATERFALL)
    by = {sp.name: sp for sp in spans}
    route, gen = by[SpanName.SERVE_ROUTE], by[SpanName.SERVE_GENERATE]
    assert route.parent_id is None and route.source == "router"
    assert gen.parent_id == route.span_id
    for name in WATERFALL[2:]:
        assert by[name].parent_id == gen.span_id, name
        assert by[name].source == "replica_310"
    queue, prefill, first, decode = (by[n] for n in WATERFALL[2:])
    assert (queue.start_t <= prefill.start_t <= first.start_t
            <= decode.start_t)
    segments_s = sum(sp.end_t - sp.start_t for sp in (queue, prefill, first))
    assert segments_s == pytest.approx(resp.ttft_s, abs=0.25)
    assert decode.attrs["rounds"] == len(resp.tokens) - 1
    # the serving track: equal to the reference builder's on the same
    # spans, and a non-serving span stays off it
    events = timeline.serving_request_events(spans, t0=route.start_t,
                                             now_t=decode.end_t)
    assert events == jtimeline.serving_request_events(
        spans, t0=route.start_t, now_t=decode.end_t)
    assert {e["pid"] for e in events} == {9996}
    with tracing.span("train.step", source="elsewhere"):
        pass
    assert all(e["name"] != "train.step" for e in
               timeline.serving_request_events(
                   tracing.get_tracer().finished_spans()))


def test_reroute_rides_the_route_span_as_an_event():
    master, replica, router = _serving_stack(311)
    live = master.serve_registry.live
    # a refusing address tops the load order: the first attempt fails
    router._replicas_fn = lambda: (
        [{"node_id": 1, "addr": "127.0.0.1:1", "slots": 64}] + live())
    try:
        resp = router.submit([4, 5, 6], max_new_tokens=3,
                             request_id="obs-rr")
    finally:
        replica.stop()
        master.stop()
    assert resp.success, resp.message
    route = [sp for sp in tracing.get_tracer().finished_spans()
             if sp.name == SpanName.SERVE_ROUTE]
    assert len(route) == 1
    evs = [(e["name"], e["attrs"]) for e in route[0].events]
    assert evs == [(SpanName.EVT_SERVE_REROUTED,
                    {"from_node": 1, "reason": "transport"})]
    assert router.rerouted == 1
    # the replica saw the request as re-routed: its waterfall says so
    gen = [sp for sp in tracing.get_tracer().spans_for_trace(resp.trace_id)
           if sp.name == SpanName.SERVE_GENERATE]
    assert len(gen) == 1 and gen[0].trace_id == route[0].trace_id


# -- tail attribution ----------------------------------------------------------


@pytest.mark.parametrize("segments,expected", [
    ({"rerouted": True, "queue_s": 0.1, "decode_s": 2.0},
     MetricLabel.TAIL_REROUTE),
    ({"queue_s": 1.0, "prefill_s": 0.1, "decode_s": 0.2},
     MetricLabel.TAIL_QUEUE),
    ({"queue_s": 0.1, "prefill_s": 0.4, "first_step_s": 0.3,
      "decode_s": 0.5}, MetricLabel.TAIL_PREFILL),
    ({"queue_s": 0.1, "prefill_s": 0.8, "decode_s": 0.2,
      "prefix_enabled": True, "prefix_hit": False},
     MetricLabel.TAIL_PREFIX_MISS),
    ({"queue_s": 0.1, "prefill_s": 0.8, "decode_s": 0.2,
      "prefix_enabled": True, "prefix_hit": True},
     MetricLabel.TAIL_PREFILL),
    ({"queue_s": 0.1, "prefill_s": 0.2, "decode_s": 0.9},
     MetricLabel.TAIL_BATCH_INTERFERENCE),
    ({"queue_s": 0.1, "prefill_s": 0.2, "decode_s": 0.9,
      "spec_rounds": 4, "spec_accept_rate": 0.2},
     MetricLabel.TAIL_SPECULATIVE_MISS),
    ({"queue_s": 0.1, "prefill_s": 0.2, "decode_s": 0.9,
      "spec_rounds": 4, "spec_accept_rate": 0.9},
     MetricLabel.TAIL_BATCH_INTERFERENCE),
    ({}, MetricLabel.TAIL_QUEUE),
])
def test_classify_decision_table(segments, expected):
    assert tail.classify(segments) == expected == jtail.classify(segments)
    assert tail.classify(segments) in MetricLabel.TAIL_CAUSES


def test_classify_equals_the_reference_on_a_seeded_sweep():
    rng = np.random.default_rng(11)
    for _ in range(500):
        seg = {k: float(rng.exponential()) for k in
               ("queue_s", "prefill_s", "first_step_s", "decode_s")
               if rng.random() < 0.8}
        for k in ("rerouted", "prefix_enabled", "prefix_hit"):
            if rng.random() < 0.3:
                seg[k] = bool(rng.random() < 0.5)
        if rng.random() < 0.3:
            seg["spec_rounds"] = int(rng.integers(0, 3))
            seg["spec_accept_rate"] = float(rng.random())
        assert tail.classify(seg) == jtail.classify(seg), seg


def _completions():
    rng = np.random.default_rng(5)
    out = []
    for i in range(60):
        q, p, f, d = (float(x) for x in rng.exponential(0.05, 4))
        out.append({"request_id": f"r{i}", "trace_id": f"t{i:04d}",
                    "latency_s": q + p + f + d, "queue_s": q,
                    "prefill_s": p, "first_step_s": f, "decode_s": d,
                    "prefix_enabled": bool(i % 3 == 0),
                    "prefix_hit": bool(i % 6 == 0),
                    "rerouted": bool(i % 17 == 0)})
    return out


def test_tail_attributor_matches_the_reference():
    kw = dict(slow_pctl=80.0, min_window=10, worst_n=4, window_size=32)
    ours_j, ref_j = [], []
    ours = tail.TailAttributor(
        journal_fn=lambda kind, **d: ours_j.append((kind, d)),
        registry=MetricsRegistry(), **kw)
    ref = jtail.TailAttributor(
        journal_fn=lambda kind, **d: ref_j.append((kind, d)),
        registry=JaxRegistry(), **kw)
    for seg in _completions():
        assert ours.observe(seg) == ref.observe(seg)
    assert ours.attributed == ref.attributed > 0
    assert ours.cause_counts == ref.cause_counts
    assert ours_j == ref_j
    assert all(k == JournalEvent.REQUEST_TAIL_ATTRIBUTED for k, _ in ours_j)
    assert ours.worst_requests() == ref.worst_requests()
    assert len(ours.worst_requests()) == 4
    text = ours._m_causes
    assert sum(text.labels(cause=c).value
               for c in MetricLabel.TAIL_CAUSES) == ours.attributed


# -- exemplars -----------------------------------------------------------------


def test_exemplar_text_equals_the_references():
    rng = np.random.default_rng(3)
    obs = [(float(v), f"tr{i}" if i % 3 else None)
           for i, v in enumerate(rng.exponential(0.5, 40))]
    texts = []
    for reg in (MetricsRegistry(), JaxRegistry()):
        ttft = reg.histogram(
            "dlrover_serving_ttft_seconds", "request enqueue → first token",
            buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30))
        by = reg.histogram("dlrover_incident_mttr_seconds", "mttr",
                           labelnames=("kind",))
        for v, ex in obs:
            ttft.observe(v, exemplar=ex)
            by.labels(kind="a" if v < 0.5 else "b").observe(v, exemplar=ex)
        texts.append(reg.render())
    assert texts[0] == texts[1]
    assert '# {trace_id="tr' in texts[0]
    # the last observation of a bucket that carried one is its exemplar
    ours = MetricsRegistry().histogram("x", buckets=(1.0,))
    ours.observe(0.5, exemplar="a")
    ours.observe(0.7)
    ours.observe(0.6, exemplar="b")
    assert ours.exemplars() == {1.0: ("b", 0.6)}
    assert ours.count == 3


# -- the replica's own plane ---------------------------------------------------


def test_replica_http_endpoints_and_worst_trace_bundle(monkeypatch):
    monkeypatch.setenv(ConfigKey.SERVE_TAIL_MIN_WINDOW, "1")
    reg = MetricsRegistry()
    master, replica, router = _serving_stack(312, registry=reg)
    try:
        resps = [router.submit([1 + i, 2, 3], max_new_tokens=3,
                               request_id=f"obs-http-{i}")
                 for i in range(3)]
        assert all(r.success for r in resps)
        status, metrics = _http_get(replica.http_addr, "/metrics")
        assert status == 200
        assert "dlrover_serving_tail_cause_total" in metrics
        assert "dlrover_serving_decode_steps" in metrics
        count = [ln for ln in metrics.splitlines()
                 if ln.startswith("dlrover_serving_ttft_seconds_count")]
        assert count == ["dlrover_serving_ttft_seconds_count 3"]
        # every exemplar on the replica's TTFT names a request's trace
        traces = {r.trace_id for r in resps}
        exemplars = [ln.split('trace_id="')[1].split('"')[0]
                     for ln in metrics.splitlines()
                     if ln.startswith("dlrover_serving_ttft_seconds_bucket")
                     and "trace_id" in ln]
        assert exemplars and set(exemplars) <= traces
        status, events = _http_get(replica.http_addr, "/events")
        kinds = {e["kind"] for e in json.loads(events)["events"]}
        assert JournalEvent.REQUEST_TAIL_ATTRIBUTED in kinds
        status, body = _http_get(replica.http_addr, "/debug/bundle")
        bundle = json.loads(body)
        assert bundle["ok"], bundle
        assert sorted(bundle["files"]) == [
            "config.json", "incidents.json", "journal.json",
            "manifest.json", "metrics.prom", "stacks.txt", "traces.json",
            "worst_requests.json"]
        with open(f"{bundle['path']}/worst_requests.json") as f:
            worst = json.load(f)
        assert worst and worst[0]["cause"] in MetricLabel.TAIL_CAUSES
        assert worst[0]["trace_id"] in traces
        names = {sp["name"] for sp in worst[0]["spans"]}
        assert set(WATERFALL) <= names
        assert _http_get(replica.http_addr, "/healthz") == (200, "ok")
    finally:
        replica.stop()
        master.stop()
    assert replica.recorder._collect is None


def test_prefix_cache_journals_hits_and_drops(monkeypatch):
    from dlrover_tpu_torch import chaos

    engine = PrefixCachingEngine(ToyEngine(slots=2, cache_len=64),
                                 cache=RadixPrefixCache(block=4),
                                 registry=MetricsRegistry())
    master, replica, router = _serving_stack(313, engine=engine,
                                             registry=MetricsRegistry())
    try:
        base = list(range(1, 7))
        for i in range(2):
            assert router.submit(base + [20 + i], max_new_tokens=2).success
        monkeypatch.setenv("DLROVER_FAULT_SCHEDULE",
                           "serve.prefix:error@nth=1")
        chaos.reset_injector()
        assert router.submit(base + [30], max_new_tokens=2).success
    finally:
        chaos.reset_injector()
        replica.stop()
        master.stop()
    got = [(e["kind"], e["source"], e["data"]) for e in
           replica.journal.events()
           if e["kind"].startswith("serve_prefix")]
    assert got[0] == (JournalEvent.SERVE_PREFIX_HIT, "replica_313",
                      {"matched": 4, "prompt_len": 7, "saved_tokens": 4})
    assert got[1][0] == JournalEvent.SERVE_PREFIX_DROPPED
    assert got[1][2]["matched"] == 4


def test_port_replica_joins_a_jax_routers_trace():
    """A JAX router's serve.route context reaches the port replica over
    the wire: the port replica's waterfall has the JAX trace_id."""
    from dlrover_tpu.serving.router import RequestRouter as JaxRouter

    master = LocalJobMaster(job_name="serve-x", node_num=1, min_nodes=1)
    master.prepare()
    replica = DecodeReplica(master.addr, node_id=314,
                            engine=ToyEngine(slots=2), buckets=(8,),
                            heartbeat_interval_s=0.05,
                            registry=MetricsRegistry())
    replica.start()
    try:
        router = JaxRouter(replicas_fn=master.serve_registry.live,
                           registry=JaxRegistry(), request_timeout_s=30.0)
        resp = router.submit([1, 2, 3], max_new_tokens=3,
                             request_id="x-1")
    finally:
        replica.stop()
        master.stop()
    assert resp.success
    route = [sp for sp in jtracing.get_tracer().finished_spans()
             if sp.name == SpanName.SERVE_ROUTE]
    assert [sp.trace_id for sp in route] == [resp.trace_id]
    ours = tracing.get_tracer().spans_for_trace(resp.trace_id)
    assert sorted(sp.name for sp in ours) == sorted(WATERFALL[1:])
    gen = next(sp for sp in ours if sp.name == SpanName.SERVE_GENERATE)
    assert gen.parent_id == route[0].span_id
