"""The master, agent and serving RPC: client and threaded server.

The port's copy of the framing of ``dlrover_tpu/common/rpc.py``: a TCP
stream of 4-byte big-endian lengths and msgpack maps. A request is
``{"m": method, "p": <serialized message>, "id": seq, "c": client id}``;
the reply is ``{"ok": bool, "p": <serialized message>, "err": str}``. The
master drops a retried frame it already ran (same client id and seq) and
replays its answer, so a retry after a lost connection is exactly-once.
:class:`RPCServer` routes frames by method name to registered handlers,
with the same replay cache, so the JAX package's clients (its agent, its
router, its fabric fetcher, its replica's master client) call a port
server unchanged. A handler that learns who is on the other end stamps it
into :func:`connection_ctx`; when that connection closes (the peer's
process died), the server's ``on_disconnect`` hook receives the stamp,
which is how the master notices a killed agent within the connection-drop
grace instead of the heartbeat timeout.

When a trace context is active (``observability/tracing.py``) a request
frame also carries ``{"tc": {"t": trace_id, "s": span_id}}``, and the
server activates it around the handler, so the handler's spans join the
caller's trace; a JAX peer sends and reads the same key. An RPC error
names the method and the caller's ``trace_id``.
"""

import socket
import socketserver
import threading
import time
import uuid
from typing import Any, Callable, Dict, Optional

from dlrover_tpu_torch.chaos import get_injector
from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import ChaosSite
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.multi_process import recv_msg, send_msg
from dlrover_tpu_torch.observability import tracing


class RPCError(RuntimeError):
    pass


# responses larger than this are not kept for replay (bulk fabric stripes
# come from idempotent methods, so a retried frame may run again)
_DEDUP_MAX_BYTES = 1024 * 1024
_DEDUP_ENTRIES = 8192


_conn_ctx = threading.local()


def connection_ctx() -> Dict[str, Any]:
    """The current RPC connection's context dict (empty off-connection)."""
    ctx = getattr(_conn_ctx, "ctx", None)
    if ctx is None:
        ctx = {}
        _conn_ctx.ctx = ctx
    return ctx


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        try:
            self._serve()
        finally:
            ctx = connection_ctx()
            hook = self.server.on_disconnect
            if ctx and hook is not None:
                try:
                    hook(dict(ctx))
                except Exception:  # noqa: BLE001 — keep the server alive
                    logger.exception("rpc on_disconnect hook failed")
            _conn_ctx.ctx = None

    def _serve(self) -> None:
        self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        server = self.server
        while True:
            try:
                frame = recv_msg(self.request)
            except (ConnectionError, OSError, ValueError):
                return
            key = (frame.get("c"), frame.get("id"))
            cached = None
            if key[0] is not None:
                with server.dedup_lock:
                    cached = server.dedup.get(key)
            if cached is not None:
                resp, cached_ctx = cached
                if cached_ctx:
                    # a replay is still contact from that peer: rebind its
                    # identity to this connection and tell the liveness hook
                    connection_ctx().update(cached_ctx)
                    if server.on_contact is not None:
                        try:
                            server.on_contact(dict(cached_ctx))
                        except Exception:  # noqa: BLE001
                            logger.exception("rpc on_contact hook failed")
            else:
                resp = self._dispatch(frame)
                if key[0] is not None and len(
                        resp.get("p", b"") or b"") <= _DEDUP_MAX_BYTES:
                    with server.dedup_lock:
                        server.dedup[key] = (resp, dict(connection_ctx()))
                        while len(server.dedup) > _DEDUP_ENTRIES:
                            server.dedup.pop(next(iter(server.dedup)))
            try:
                send_msg(self.request, resp)
            except (ConnectionError, OSError):
                return

    def _dispatch(self, frame) -> Dict[str, Any]:
        method = frame.get("m", "")
        handler = self.server.registry.get(method)
        if handler is None:
            return {"ok": False, "err": f"unknown rpc method {method!r}"}
        try:
            request = comm.deserialize(frame.get("p", b""))
            # the caller's trace context, if it sent one, for the handler
            with tracing.activate(
                    tracing.extract_wire(frame.get(tracing.WIRE_KEY))):
                result = handler(request)
            return {"ok": True, "p": comm.serialize(result)}
        except Exception as e:  # noqa: BLE001 — reported to the caller
            logger.exception("rpc handler %s failed", method)
            return {"ok": False, "err": repr(e)}


class _ThreadedTCPServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True
    request_queue_size = 512


class RPCServer:
    """Threaded TCP server with a method registry."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self._server = _ThreadedTCPServer((host, port), _Handler)
        self._server.registry = {}
        self._server.dedup = {}
        self._server.dedup_lock = threading.Lock()
        self._server.on_disconnect = None
        self._server.on_contact = None
        self._thread: Optional[threading.Thread] = None

    def set_on_disconnect(self, hook: Callable[[Dict[str, Any]], None]
                          ) -> None:
        """``hook(ctx)`` runs when a connection whose handlers stamped
        :func:`connection_ctx` closes, for any reason."""
        self._server.on_disconnect = hook

    def set_on_contact(self, hook: Callable[[Dict[str, Any]], None]) -> None:
        """``hook(ctx)`` runs when a replayed frame arrives from an
        identified peer (the handler does not run on a replay)."""
        self._server.on_contact = hook

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def register(self, method: str, handler: Callable[[Any], Any]) -> None:
        self._server.registry[method] = handler

    def register_object(self, obj: Any) -> None:
        """Register every public ``rpc_*`` method of ``obj``."""
        for name in dir(obj):
            if name.startswith("rpc_"):
                self.register(name[len("rpc_"):], getattr(obj, name))

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="rpc-server", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class RPCClient:
    """Persistent-connection client (one socket per thread) that retries
    transport errors with a capped exponential backoff."""

    def __init__(self, addr: str, timeout_s: float = 330.0,
                 retries: int = 30):
        host, port = addr.rsplit(":", 1)
        self._host, self._port = host, int(port)
        self._timeout_s = timeout_s
        self._retries = retries
        self._tls = threading.local()
        self._client_id = uuid.uuid4().hex
        self._seq = 0
        self._seq_lock = threading.Lock()

    @property
    def addr(self) -> str:
        return f"{self._host}:{self._port}"

    def _conn(self) -> socket.socket:
        conn = getattr(self._tls, "conn", None)
        if conn is None:
            conn = socket.create_connection(
                (self._host, self._port), timeout=min(5.0, self._timeout_s))
            conn.settimeout(self._timeout_s)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._tls.conn = conn
        return conn

    def _close(self) -> None:
        conn = getattr(self._tls, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
            self._tls.conn = None

    def call(self, method: str, request: Any = None, retries=None) -> Any:
        with self._seq_lock:
            self._seq += 1
            seq = self._seq
        frame = {"m": method, "p": comm.serialize(request), "id": seq,
                 "c": self._client_id}
        trace_ctx = tracing.inject_wire()
        if trace_ctx is not None:
            frame[tracing.WIRE_KEY] = trace_ctx
        attempts = max(1, self._retries if retries is None else retries)
        inj = get_injector()
        for attempt in range(attempts):
            try:
                if inj is not None:
                    inj.fire(ChaosSite.RPC_SEND, method=method)
                conn = self._conn()
                send_msg(conn, frame)
                resp = recv_msg(conn)
                if inj is not None:
                    inj.fire(ChaosSite.RPC_RECV, method=method)
                break
            except (ConnectionError, OSError):
                self._close()
                if attempt + 1 == attempts:
                    raise
                time.sleep(min(0.1 * 1.6 ** attempt, 5.0))
        if not resp.get("ok"):
            raise RPCError(f"rpc {method} to {self.addr} failed "
                           f"(trace_id={_trace_id()}): "
                           f"{resp.get('err', 'unknown rpc error')}")
        return comm.deserialize(resp.get("p", b""))


def _trace_id() -> str:
    ctx = tracing.current_context()
    return ctx.trace_id if ctx is not None else "-"


def find_free_port(host: str = "") -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]
