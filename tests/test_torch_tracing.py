"""The port's tracing and flight recorder against the reference's.

- span mechanics: nesting, ring eviction, the shared no-op span when
  ``DLROVER_TPU_TRACE=0``;
- ``to_chrome_events`` of the same spans (ids and stamps fixed) equal to
  ``dlrover_tpu.observability.tracing``'s;
- the ``tc`` frame key in both wire directions over the binary transport:
  a JAX ``RPCClient`` inside a JAX span calls a port ``RPCServer`` whose
  handler sees that ``trace_id``, and the reverse;
- one rendezvous round under one trace (the port's master and client),
  and a node fault's ``fault.relaunch`` context riding down to a
  survivor's heartbeat action;
- the checkpoint save → persist → commit arc sharing one ``trace_id``
  across the port's worker engine and the agent's saver, over the IPC
  queue;
- the flight recorder's file set, cooldown and ``force``, chaos capture
  and HTTP handler, as the reference's ``tests/test_tracing.py`` holds
  them, and a closed recorder leaving no collect hook behind.
"""

import json
import os
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from dlrover_tpu.common.rpc import RPCClient as JaxRPCClient  # noqa: E402
from dlrover_tpu.common.rpc import RPCServer as JaxRPCServer  # noqa: E402
from dlrover_tpu.observability import tracing as jtracing  # noqa: E402

from dlrover_tpu_torch.agent.master_client import MasterClient  # noqa: E402
from dlrover_tpu_torch.chaos.injector import (  # noqa: E402
    FaultInjector,
    InjectedError,
    parse_rule,
)
from dlrover_tpu_torch.common.constants import (  # noqa: E402
    ConfigKey,
    NodeStatus,
    RendezvousName,
    SpanName,
)
from dlrover_tpu_torch.common.multi_process import (  # noqa: E402
    LocalIPCServer,
    unlink_shared_memory,
)
from dlrover_tpu_torch.common.rpc import (  # noqa: E402
    RPCClient,
    RPCError,
    RPCServer,
)
from dlrover_tpu_torch.master.master import LocalJobMaster  # noqa: E402
from dlrover_tpu_torch.observability import tracing  # noqa: E402
from dlrover_tpu_torch.observability.flight_recorder import (  # noqa: E402
    REASON_CHAOS,
    REASON_CRASH,
    FlightRecorder,
)
from dlrover_tpu_torch.observability.journal import (  # noqa: E402
    EventJournal,
    JournalEvent,
)
from dlrover_tpu_torch.observability.registry import (  # noqa: E402
    MetricsRegistry,
)


@pytest.fixture(autouse=True)
def fresh_tracers(tmp_path, monkeypatch):
    """Every test gets fresh tracer rings (both packages') and its own
    bundle directory."""
    monkeypatch.setenv(ConfigKey.TRACE_DIR, str(tmp_path / "bundles"))
    tracing.reset_tracer()
    jtracing.reset_tracer()
    yield
    tracing.reset_tracer()
    jtracing.reset_tracer()


def spans_named(name, source=None):
    return [sp for sp in tracing.get_tracer().finished_spans()
            if sp.name == name and (source is None or sp.source == source)]


# -- span mechanics ----------------------------------------------------------


def test_span_nesting_and_ring():
    with tracing.span(SpanName.RDZV_CLIENT_ROUND, source="agent_0") as outer:
        assert tracing.current_context() == outer.context
        with tracing.span(SpanName.RDZV_JOIN, source="agent_0") as inner:
            assert inner.trace_id == outer.trace_id
            assert inner.parent_id == outer.span_id
            inner.add_event("attempt", n=1)
        assert tracing.current_context() == outer.context
    assert tracing.current_context() is None
    ring = tracing.get_tracer().finished_spans()
    assert [sp.name for sp in ring] == [SpanName.RDZV_JOIN,
                                        SpanName.RDZV_CLIENT_ROUND]
    assert ring[0].events[0]["name"] == "attempt"


def test_ring_eviction_keeps_the_newest(monkeypatch):
    monkeypatch.setenv(ConfigKey.TRACE_RING, "4")
    tracing.reset_tracer()
    for i in range(10):
        with tracing.span(SpanName.RDZV_JOIN, source="agent_0", i=i):
            pass
    tr = tracing.get_tracer()
    assert tr.counts() == {"started": 10, "finished": 10, "live": 0,
                           "ring": 4, "dropped": 6}
    assert tr.dropped() == 6
    assert [sp.attrs["i"] for sp in tr.finished_spans()] == [6, 7, 8, 9]


def test_disabled_path_is_one_shared_noop(monkeypatch):
    monkeypatch.setenv(ConfigKey.TRACE, "0")
    tracing.reset_tracer()
    assert not tracing.enabled()
    s1 = tracing.span(SpanName.RDZV_JOIN, source="agent_0")
    s2 = tracing.span(SpanName.RDZV_WORLD_CUT, source="master")
    assert s1 is s2
    with s1:
        assert tracing.inject_wire() is None
        tracing.add_span_event("ignored")
    assert tracing.get_tracer().counts() == {
        "started": 0, "finished": 0, "live": 0, "ring": 0, "dropped": 0}


def _fixed_spans(mod):
    """The same three spans (one live, one with an event) in ``mod``'s
    tracer, ids and monotonic stamps overwritten with fixed values."""
    tr = mod.Tracer(enabled=True, ring_size=16)
    root = tr.span(SpanName.SERVE_ROUTE, source="router", request_id="q0")
    child = tr.span(SpanName.SERVE_GENERATE, source="replica_1",
                    parent=root.context, request_id="q0")
    child.add_event(SpanName.EVT_SERVE_REROUTED, from_node=3,
                    reason="draining")
    live = tr.span(SpanName.SERVE_DECODE, source="replica_1",
                   parent=root.context, rounds=4)
    for i, (sp, start, end) in enumerate(((root, 10.0, 10.5),
                                          (child, 10.1, 10.4),
                                          (live, 10.2, None))):
        sp.trace_id = "t" * 16
        sp.span_id = f"s{i:015d}"
        sp.start_t = start
        sp.end_t = end
    child.parent_id = live.parent_id = root.span_id
    child.events[0]["t"] = 10.25
    return [root, child, live]


def test_chrome_events_equal_the_references():
    for t0 in (None, 9.5):
        ours = tracing.to_chrome_events(_fixed_spans(tracing), t0=t0,
                                        now_t=11.0)
        ref = jtracing.to_chrome_events(_fixed_spans(jtracing), t0=t0,
                                        now_t=11.0)
        assert ours == ref
    assert any(e.get("args", {}).get("incomplete") for e in ours)
    json.loads(json.dumps({"traceEvents": ours}))


# -- the tc key on the binary transport, both directions ---------------------


def _echo(server_cls, tracing_mod):
    server = server_cls(host="127.0.0.1")
    seen = []

    def handler(request):
        ctx = tracing_mod.current_context()
        seen.append(ctx)
        return {"trace_id": ctx.trace_id if ctx else None,
                "span_id": ctx.span_id if ctx else None}

    server.register("echo_ctx", handler)
    server.register("boom", lambda req: 1 / 0)
    server.start()
    return server, seen


@pytest.mark.parametrize("direction", ["jax_client_port_server",
                                       "port_client_jax_server"])
def test_tc_crosses_the_binary_transport(direction):
    if direction == "jax_client_port_server":
        server, seen = _echo(RPCServer, tracing)
        client = JaxRPCClient(f"127.0.0.1:{server.port}")
        caller = jtracing
    else:
        server, seen = _echo(JaxRPCServer, jtracing)
        client = RPCClient(f"127.0.0.1:{server.port}")
        caller = tracing
    try:
        with caller.span(SpanName.RDZV_CLIENT_ROUND, source="agent_0") as sp:
            resp = client.call("echo_ctx")
        assert resp == {"trace_id": sp.trace_id, "span_id": sp.span_id}
        assert tuple(seen[-1]) == (sp.trace_id, sp.span_id)
        # no active span: no key on the wire, no context in the handler
        assert client.call("echo_ctx") == {"trace_id": None,
                                           "span_id": None}
    finally:
        server.stop()


def test_rpc_error_names_method_and_trace():
    server, _ = _echo(RPCServer, tracing)
    try:
        client = RPCClient(f"127.0.0.1:{server.port}")
        with tracing.span(SpanName.RDZV_CLIENT_ROUND, source="agent_0") as sp:
            with pytest.raises(RPCError) as err:
                client.call("boom")
        assert "rpc boom" in str(err.value)
        assert f"trace_id={sp.trace_id}" in str(err.value)
    finally:
        server.stop()


# -- arcs across the port's master and agents --------------------------------


@pytest.fixture()
def master():
    # min_nodes 1: a failed node shrinks the job instead of aborting it
    m = LocalJobMaster(job_name="trace-test", node_num=2, min_nodes=1)
    for mgr in m.rdzv_managers.values():
        mgr.update_rdzv_params(2, 2, waiting_timeout=0.05)
    m.prepare()
    yield m
    m.stop()


def test_rendezvous_round_shares_one_trace_id(master):
    c0 = MasterClient(master.addr, 0)
    c1 = MasterClient(master.addr, 1)
    c1.join_rendezvous(RendezvousName.TRAINING, 1, 1, host="127.0.0.1",
                       free_port=2222)
    with tracing.span(SpanName.RDZV_CLIENT_ROUND, source="agent_0") as rsp:
        c0.join_rendezvous(RendezvousName.TRAINING, 0, 1, host="127.0.0.1",
                           free_port=1111)
        rnd, _, world, _ = c0.get_comm_world(RendezvousName.TRAINING, 0)
    assert rnd == 1 and sorted(world) == [0, 1]
    tid = rsp.trace_id
    assert [sp.trace_id for sp in
            spans_named(SpanName.RDZV_JOIN, "agent_0")] == [tid]
    assert {sp.trace_id for sp in
            spans_named(SpanName.RDZV_WORLD_WAIT, "agent_0")} == {tid}
    master_joins = spans_named(SpanName.RDZV_JOIN, "master")
    assert tid in {sp.trace_id for sp in master_joins}
    assert [sp.trace_id for sp in
            spans_named(SpanName.RDZV_WORLD_CUT, "master")] == [tid]
    # agent 1's join is another trace: no accidental merge
    assert len({sp.trace_id for sp in master_joins} - {tid}) == 1


def test_node_fault_trace_rides_down_to_survivors(master):
    c0 = MasterClient(master.addr, 0)
    c1 = MasterClient(master.addr, 1)
    c0.update_node_status(NodeStatus.RUNNING)
    c1.update_node_status(NodeStatus.RUNNING)
    with tracing.span(SpanName.RDZV_CLIENT_ROUND, source="agent_0") as sp:
        c0.update_node_status(NodeStatus.FAILED)
    tid = sp.trace_id
    assert [s.trace_id for s in
            spans_named(SpanName.FAULT_RELAUNCH, "master")] == [tid]
    fault = [e for e in master.event_journal.events()
             if e["kind"] == JournalEvent.FAULT_DETECTED]
    assert [e["data"]["trace_id"] for e in fault] == [tid]
    resp = c1.heartbeat()
    assert resp.action_type == "restart_worker"
    carried = tracing.extract_wire(resp.action_data.get(tracing.WIRE_KEY))
    assert carried is not None and carried.trace_id == tid
    # the master's node_fault bundle, written after the fault was handled
    bundles = os.listdir(master.flight_recorder.out_dir)
    assert any("node_fault" in b for b in bundles)


def test_checkpoint_arc_shares_one_trace_across_worker_and_saver(tmp_path):
    """save_to_storage → SAVE event over the agent's IPC queue → the
    saver's persist and commit: one trace_id."""
    from dlrover_tpu_torch.ckpt import ckpt_saver
    from dlrover_tpu_torch.ckpt.ckpt_saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.ckpt.engine import CheckpointEngine

    job = f"tt{os.getpid()}{threading.get_ident() % 1000}"
    ckpt_dir = str(tmp_path / "ckpt")
    server = LocalIPCServer(str(tmp_path / "ipc.sock"))
    server.start()
    saver = AsyncCheckpointSaver(ckpt_dir=ckpt_dir, node_rank=0,
                                 local_world_size=1, expected_frames=1)
    saver.start(server)
    engine = CheckpointEngine(ckpt_dir, job_name=job, node_rank=0,
                              local_rank=0, ipc_socket=server.path,
                              world_size=1, rank=0)
    try:
        assert engine.save_to_storage(3, {"w": torch.ones(4, 4),
                                          "step": torch.tensor(3)})
        deadline = time.time() + 20
        while (ckpt_saver.latest_step(ckpt_dir) != 3
               and time.time() < deadline):
            time.sleep(0.05)
        assert ckpt_saver.latest_step(ckpt_dir) == 3
        deadline = time.time() + 10
        while (not spans_named(SpanName.CKPT_COMMIT)
               and time.time() < deadline):
            time.sleep(0.05)
        _, step = engine.load({"w": torch.zeros(4, 4),
                               "step": torch.tensor(0)})
        assert step == 3
    finally:
        saver.stop()
        server.stop()
        for name in os.listdir("/dev/shm"):
            if name.startswith(f"dlrtpu_{job}_"):
                unlink_shared_memory(name)
    request = spans_named(SpanName.CKPT_PERSIST_REQUEST, "worker_0")
    assert len(request) == 1
    tid = request[0].trace_id
    for name, source in ((SpanName.CKPT_SAVE_MEMORY, "worker_0"),
                         (SpanName.CKPT_DRAIN, "worker_0"),
                         (SpanName.CKPT_PERSIST, "saver_0"),
                         (SpanName.CKPT_COMMIT, "saver_0")):
        assert [sp.trace_id for sp in spans_named(name, source)] == [tid], (
            name)
    persist = spans_named(SpanName.CKPT_PERSIST, "saver_0")[0]
    commit = spans_named(SpanName.CKPT_COMMIT, "saver_0")[0]
    assert persist.parent_id == request[0].span_id
    assert commit.parent_id == persist.span_id
    restore = spans_named(SpanName.CKPT_RESTORE, "worker_0")
    assert len(restore) == 1 and restore[0].attrs["step"] == 3


# -- the flight recorder ------------------------------------------------------


def test_flight_recorder_bundle_contents(tmp_path):
    journal = EventJournal()
    registry = MetricsRegistry()
    journal.record(JournalEvent.RDZV_START, source="master", round=1)
    with tracing.span(SpanName.RDZV_JOIN, source="agent_0"):
        pass
    fr = FlightRecorder("master", out_dir=str(tmp_path / "fr"),
                        journal=journal, registry=registry, cooldown_s=0.0)
    path = fr.capture(REASON_CRASH, extra={"error": "boom"})
    assert path is not None and fr.bundles == [path]
    assert sorted(os.listdir(path)) == [
        "config.json", "incidents.json", "journal.json", "manifest.json",
        "metrics.prom", "stacks.txt", "traces.json"]
    with open(os.path.join(path, "traces.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert SpanName.RDZV_JOIN in names and "rdzv_start" in names
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["reason"] == REASON_CRASH
    assert manifest["error"] == "boom"
    assert manifest["spans_finished"] >= 1
    assert sorted(manifest["files"]) == sorted(os.listdir(path))
    assert any(e["kind"] == JournalEvent.TRACE_BUNDLE_CAPTURED
               for e in journal.events())
    assert ('dlrover_trace_bundles_total{reason="unhandled_exception"} 1'
            in registry.render())
    with open(os.path.join(path, "stacks.txt")) as f:
        assert "MainThread" in f.read()


def test_flight_recorder_with_worst_requests_writes_the_eight_files(
        tmp_path):
    journal = EventJournal()
    with tracing.span(SpanName.SERVE_GENERATE, source="replica_1") as sp:
        pass
    fr = FlightRecorder(
        "replica_1", out_dir=str(tmp_path / "fr"), journal=journal,
        registry=MetricsRegistry(), cooldown_s=0.0,
        worst_traces_fn=lambda: [{"trace_id": sp.trace_id,
                                  "latency_s": 1.0}])
    path = fr.capture(REASON_CRASH)
    with open(os.path.join(path, "manifest.json")) as f:
        assert sorted(json.load(f)["files"]) == [
            "config.json", "incidents.json", "journal.json",
            "manifest.json", "metrics.prom", "stacks.txt", "traces.json",
            "worst_requests.json"]
    with open(os.path.join(path, "worst_requests.json")) as f:
        worst = json.load(f)
    assert [s["span_id"] for s in worst[0]["spans"]] == [sp.span_id]


def test_flight_recorder_cooldown_and_force(tmp_path):
    fr = FlightRecorder("agent_0", out_dir=str(tmp_path / "fr"),
                        cooldown_s=60.0)
    assert fr.capture(REASON_CRASH) is not None
    assert fr.capture(REASON_CRASH) is None
    assert fr.capture(REASON_CRASH, force=True) is not None
    # the limit is per reason
    assert fr.capture(REASON_CHAOS) is not None


def test_injected_fault_triggers_a_bundle(tmp_path):
    journal = EventJournal()
    fr = FlightRecorder("master", out_dir=str(tmp_path / "fr"),
                        journal=journal, cooldown_s=0.0)
    inj = FaultInjector([parse_rule("rpc.send:error@times=1")])
    reported = []
    inj.set_reporter(fr.wrap_fault_reporter(reported.append))
    with pytest.raises(InjectedError):
        inj.fire("rpc.send", method="heartbeat")
    assert reported and reported[0]["fault"] == "error"
    bundles = os.listdir(str(tmp_path / "fr"))
    assert len(bundles) == 1 and REASON_CHAOS in bundles[0]
    with open(os.path.join(str(tmp_path / "fr"), bundles[0],
                           "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["fault_site"] == "rpc.send"
    assert manifest["fault_kind"] == "error"


def test_http_bundle_handler_always_captures(tmp_path):
    fr = FlightRecorder("master", out_dir=str(tmp_path / "fr"),
                        cooldown_s=60.0)
    handle = fr.http_handler()
    ctype, body = handle()
    assert ctype == "application/json"
    payload = json.loads(body)
    assert payload["ok"] and os.path.isdir(payload["path"])
    assert "manifest.json" in payload["files"]
    assert json.loads(handle()[1])["ok"]


def test_a_closed_recorder_leaves_no_collect_hook(tmp_path):
    registry = MetricsRegistry()
    fr = FlightRecorder("replica_7", out_dir=str(tmp_path / "fr"),
                        registry=registry)
    assert "dlrover_trace_ring_spans" in registry.render()
    assert len(registry._hooks) == 1
    fr.close()
    assert registry._hooks == []
    fr.close()  # idempotent
