"""The HTTP transport of the master RPC, and the scrape routes.

The port's copy of ``dlrover_tpu/common/http_server.py``. The method
registry an :class:`~dlrover_tpu_torch.common.rpc.RPCServer` serves, over
``POST /rpc`` with a msgpack frame as the body (the same ``{"m", "p",
"tc"}`` frame, so the caller's trace context crosses it too), plus
``GET`` routes: ``/healthz`` built in, and whatever a process mounts with
:meth:`HTTPTransportServer.add_get_route` (``/metrics``, ``/events``,
``/debug/bundle``, ``/incidents``). It runs on the standard library's
``ThreadingHTTPServer`` and the port's own msgpack codec.

:class:`HttpRPCClient` is a drop-in for ``RPCClient`` over this transport,
one request a call under a :class:`~dlrover_tpu_torch.common.retry.
RetryPolicy` and a circuit breaker; :func:`make_rpc_client` picks the
transport from the address: ``http://host:port`` → HTTP, a bare
``host:port`` → the binary one. A JAX peer's client calls a port server
over either, and the reverse.
"""

import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from dlrover_tpu_torch.chaos import get_injector
from dlrover_tpu_torch.common import comm, msgpack, retry
from dlrover_tpu_torch.common.constants import ChaosSite
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.rpc import RPCError
from dlrover_tpu_torch.observability import tracing


class HTTPTransportServer:
    """Serves an RPC method registry over HTTP. Share a registry with an
    RPCServer to expose both transports at once."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self.registry: Dict[str, Callable[[Any], Any]] = {}
        # GET routes: path → () -> (content_type, body_bytes). /metrics and
        # /events mount here; /healthz is built in.
        self.get_routes: Dict[str, Callable[[], Any]] = {}
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                route = outer.get_routes.get(path)
                if path == "/healthz":
                    ctype, body, code = "text/plain", b"ok", 200
                elif route is not None:
                    try:
                        ctype, body = route()
                        if isinstance(body, str):
                            body = body.encode("utf-8")
                        code = 200
                    except Exception as e:  # noqa: BLE001 — report, don't die
                        logger.exception("GET %s handler failed", path)
                        ctype, body, code = "text/plain", repr(e).encode(), 500
                else:
                    ctype, body, code = "text/plain", b"not found", 404
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path != "/rpc":
                    self.send_response(404)
                    self.end_headers()
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    frame = msgpack.unpackb(self.rfile.read(n))
                    method = frame.get("m", "")
                    handler = outer.registry.get(method)
                    if handler is None:
                        resp = {"ok": False,
                                "err": f"unknown rpc method {method!r}"}
                    else:
                        # same trace-context restore as the TCP transport
                        trace_ctx = tracing.extract_wire(
                            frame.get(tracing.WIRE_KEY)
                        )
                        request = comm.deserialize(frame.get("p", b""))
                        if trace_ctx is not None:
                            with tracing.activate(trace_ctx):
                                result = handler(request)
                        else:
                            result = handler(request)
                        resp = {"ok": True, "p": comm.serialize(result)}
                except Exception as e:  # noqa: BLE001 — report to caller
                    logger.exception("http rpc failed")
                    resp = {"ok": False, "err": repr(e)}
                body = msgpack.packb(resp)
                self.send_response(200)
                self.send_header("Content-Type", "application/msgpack")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def register(self, method: str, handler: Callable[[Any], Any]) -> None:
        self.registry[method] = handler

    def add_get_route(self, path: str,
                      handler: Callable[[], Any]) -> None:
        """Mount a GET endpoint. ``handler`` returns ``(content_type,
        body)`` where body is bytes or str."""
        self.get_routes[path] = handler

    def register_object(self, obj: Any, prefix: str = "rpc_") -> None:
        """Mount every ``rpc_*`` method like RPCServer.register_object."""
        for name in dir(obj):
            if name.startswith(prefix):
                self.registry[name[len(prefix):]] = getattr(obj, name)

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="http-rpc", daemon=True
        )
        self._thread.start()
        logger.info("http rpc transport on :%s", self.port)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


class HttpRPCClient:
    """Drop-in for rpc.RPCClient over the HTTP transport."""

    def __init__(self, addr: str, timeout_s: float = 330.0,
                 retries: int = 30,
                 policy: Optional[retry.RetryPolicy] = None):
        if addr.startswith("http://"):
            addr = addr[len("http://"):]
        self._addr = addr.rstrip("/")
        self._timeout_s = timeout_s
        self._policy = policy or retry.RetryPolicy.from_retries(retries)
        self._breaker = retry.CircuitBreaker()

    @property
    def addr(self) -> str:
        return f"http://{self._addr}"

    @property
    def breaker(self) -> retry.CircuitBreaker:
        return self._breaker

    def call(self, method: str, request: Any = None,
             retries: Optional[int] = None,
             policy: Optional[retry.RetryPolicy] = None) -> Any:
        if policy is None:
            policy = (retry.RetryPolicy.from_retries(retries)
                      if retries is not None else self._policy)
        envelope = {"m": method, "p": comm.serialize(request)}
        trace_ctx = tracing.inject_wire()
        if trace_ctx is not None:
            envelope[tracing.WIRE_KEY] = trace_ctx
        frame = msgpack.packb(envelope)
        inj = get_injector()

        def attempt() -> Any:
            if inj is not None:
                inj.fire(ChaosSite.RPC_SEND, method=method)
            req = urllib.request.Request(
                f"http://{self._addr}/rpc", data=frame,
                headers={"Content-Type": "application/msgpack"},
            )
            with urllib.request.urlopen(req, timeout=self._timeout_s) as r:
                resp = msgpack.unpackb(r.read())
            if inj is not None:
                inj.fire(ChaosSite.RPC_RECV, method=method)
            if not resp.get("ok"):
                ctx = tracing.current_context()
                trace_id = ctx.trace_id if ctx is not None else "-"
                raise RPCError(
                    f"http rpc {method} to {self._addr} failed "
                    f"(trace_id={trace_id}): "
                    f"{resp.get('err', 'unknown error')}"
                )
            return comm.deserialize(resp.get("p", b""))

        return retry.retry_call(
            attempt, policy, breaker=self._breaker,
            retry_on=(urllib.error.URLError, ConnectionError, OSError),
            describe=f"http rpc {method} to {self._addr}",
        )

    def try_call(self, method: str, request: Any = None) -> Any:
        try:
            return self.call(method, request, policy=retry.PROBE)
        except (ConnectionError, RPCError):
            return None


def make_rpc_client(addr: str, **kwargs):
    """Transport from the address scheme: ``http://host:port`` → HTTP,
    bare ``host:port`` → the binary TCP transport."""
    if addr.startswith("http://"):
        return HttpRPCClient(addr, **kwargs)
    from dlrover_tpu_torch.common.rpc import RPCClient

    return RPCClient(addr, **kwargs)
