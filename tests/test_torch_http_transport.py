"""The port's HTTP transport against the reference's.

As the reference's ``tests/test_http_transport.py`` holds its own:
scheme dispatch, a round trip and its errors, and the port's master
driven over HTTP by the port's ``MasterClient``; then across packages,
both ways: a JAX ``HttpRPCClient`` calls a port ``HTTPTransportServer``
and a port ``HttpRPCClient`` a JAX one, each inside a span whose
``trace_id`` the handler on the other side sees; and the port master's
scrape routes (``/metrics``, ``/events``, ``/debug/bundle``,
``/incidents``). Every server binds port 0.
"""

import json
import urllib.request

import pytest

pytest.importorskip("torch")

from dlrover_tpu.common import http_server as jhttp  # noqa: E402
from dlrover_tpu.observability import tracing as jtracing  # noqa: E402

from dlrover_tpu_torch.agent.master_client import MasterClient  # noqa: E402
from dlrover_tpu_torch.common.constants import (  # noqa: E402
    ConfigKey,
    RendezvousName,
    SpanName,
)
from dlrover_tpu_torch.common.http_server import (  # noqa: E402
    HTTPTransportServer,
    HttpRPCClient,
    make_rpc_client,
)
from dlrover_tpu_torch.common.rpc import RPCClient, RPCError  # noqa: E402
from dlrover_tpu_torch.master.master import LocalJobMaster  # noqa: E402
from dlrover_tpu_torch.observability import tracing  # noqa: E402


@pytest.fixture(autouse=True)
def fresh_tracers(tmp_path, monkeypatch):
    monkeypatch.setenv(ConfigKey.TRACE_DIR, str(tmp_path / "bundles"))
    tracing.reset_tracer()
    jtracing.reset_tracer()
    yield
    tracing.reset_tracer()
    jtracing.reset_tracer()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.headers.get("Content-Type"), r.read()


def test_make_rpc_client_scheme_dispatch():
    assert isinstance(make_rpc_client("http://1.2.3.4:80"), HttpRPCClient)
    assert isinstance(make_rpc_client("1.2.3.4:80"), RPCClient)
    assert make_rpc_client("http://1.2.3.4:80/").addr == "http://1.2.3.4:80"


def test_http_rpc_roundtrip_and_errors():
    server = HTTPTransportServer(host="127.0.0.1")
    server.register("echo", lambda req: {"got": req})
    server.register("boom", lambda req: 1 / 0)
    server.add_get_route("/hello", lambda: ("text/plain", "hi"))
    server.start()
    try:
        client = HttpRPCClient(f"http://127.0.0.1:{server.port}",
                               retries=2, timeout_s=5)
        assert client.call("echo", {"x": 1}) == {"got": {"x": 1}}
        with pytest.raises(RPCError, match="ZeroDivisionError"):
            client.call("boom")
        with pytest.raises(RPCError, match="unknown rpc method"):
            client.call("nope")
        assert client.try_call("nope") is None
        assert _get(server.port, "/healthz")[1] == b"ok"
        assert _get(server.port, "/hello") == ("text/plain", b"hi")
        with pytest.raises(urllib.error.HTTPError, match="404"):
            _get(server.port, "/missing")
    finally:
        server.stop()
    # a dead server: ConnectionError after the retries
    dead = HttpRPCClient("http://127.0.0.1:9", retries=2, timeout_s=1)
    with pytest.raises(ConnectionError):
        dead.call("echo")


def test_port_master_over_the_http_transport(monkeypatch):
    monkeypatch.setenv(ConfigKey.HTTP_PORT, "0")
    master = LocalJobMaster(job_name="httpjob", node_num=1)
    master.prepare()
    try:
        client = MasterClient(f"http://127.0.0.1:{master.http_port}",
                              node_id=0)
        assert isinstance(client._client, HttpRPCClient)
        with tracing.span(SpanName.RDZV_CLIENT_ROUND, source="agent_0") as sp:
            rnd = client.join_rendezvous(
                RendezvousName.TRAINING, node_rank=0, local_world_size=2,
                host="127.0.0.1", free_port=12345)
        assert rnd >= 0
        _, _, world, coord = client.get_comm_world(RendezvousName.TRAINING,
                                                   0)
        assert world[0].local_world_size == 2
        assert coord == "127.0.0.1:12345"
        client.kv_set("k", b"v")
        assert client.kv_get("k") == b"v"
        # the master's join ran under the agent's trace, over HTTP
        joins = [s for s in tracing.get_tracer().finished_spans()
                 if s.name == SpanName.RDZV_JOIN and s.source == "master"]
        assert [s.trace_id for s in joins] == [sp.trace_id]
        # the scrape routes
        ctype, body = _get(master.http_port, "/metrics")
        assert ctype.startswith("text/plain")
        assert "dlrover_goodput_wall_seconds" in body.decode()
        assert "dlrover_trace_ring_spans" in body.decode()
        journal = json.loads(_get(master.http_port, "/events")[1])
        assert {"start_wall_ts", "now_t", "dropped", "events"} <= set(
            journal)
        incidents = json.loads(_get(master.http_port, "/incidents")[1])
        assert incidents["incidents"] == [] and incidents["resolved"] == 0
        bundle = json.loads(_get(master.http_port, "/debug/bundle")[1])
        assert bundle["ok"] and "incidents.json" in bundle["files"]
    finally:
        master.stop()
    # a stopped master leaves none of its collect hooks behind
    hooks = master.metrics_registry._hooks
    assert master._gauge_hook not in hooks
    assert master._incident_hook not in hooks
    assert master.flight_recorder._collect is None


def test_http_transport_off_without_the_env(monkeypatch):
    monkeypatch.delenv(ConfigKey.HTTP_PORT, raising=False)
    master = LocalJobMaster(job_name="nohttp", node_num=1)
    master.prepare()
    try:
        assert master.http_port is None
    finally:
        master.stop()


def _echo_server(server_cls, tracing_mod):
    server = server_cls(host="127.0.0.1")
    seen = []

    def handler(request):
        ctx = tracing_mod.current_context()
        seen.append(ctx)
        return {"req": request, "trace_id": ctx.trace_id if ctx else None}

    server.register("echo_ctx", handler)
    server.start()
    return server, seen


@pytest.mark.parametrize("direction", ["jax_client_port_server",
                                       "port_client_jax_server"])
def test_http_transport_across_packages(direction):
    if direction == "jax_client_port_server":
        server, seen = _echo_server(HTTPTransportServer, tracing)
        client = jhttp.HttpRPCClient(f"http://127.0.0.1:{server.port}",
                                     retries=2, timeout_s=5)
        caller = jtracing
    else:
        server, seen = _echo_server(jhttp.HTTPTransportServer, jtracing)
        client = HttpRPCClient(f"http://127.0.0.1:{server.port}",
                               retries=2, timeout_s=5)
        caller = tracing
    try:
        with caller.span(SpanName.SERVE_ROUTE, source="router") as sp:
            resp = client.call("echo_ctx", {"n": [1, 2, 3]})
        assert resp == {"req": {"n": [1, 2, 3]}, "trace_id": sp.trace_id}
        assert tuple(seen[-1]) == (sp.trace_id, sp.span_id)
        assert client.call("echo_ctx", 7) == {"req": 7, "trace_id": None}
    finally:
        server.stop()


def test_jax_master_client_over_http_to_the_port_master(monkeypatch):
    """The JAX package's MasterClient drives the port's master over the
    HTTP transport."""
    from dlrover_tpu.agent.master_client import MasterClient as JaxClient
    from dlrover_tpu.common.constants import RendezvousName as JaxRdzv

    monkeypatch.setenv(ConfigKey.HTTP_PORT, "0")
    master = LocalJobMaster(job_name="httpjax", node_num=1)
    master.prepare()
    try:
        client = JaxClient(f"http://127.0.0.1:{master.http_port}",
                           node_id=0)
        assert client.join_rendezvous(
            JaxRdzv.TRAINING, node_rank=0, local_world_size=1,
            host="127.0.0.1", free_port=4321) >= 0
        _, _, world, coord = client.get_comm_world(JaxRdzv.TRAINING, 0)
        assert sorted(world) == [0] and coord == "127.0.0.1:4321"
        client.kv_set("j", b"x")
        assert client.kv_get("j") == b"x"
    finally:
        master.stop()
