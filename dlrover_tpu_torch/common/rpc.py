"""Client side of the master RPC.

The port's copy of the framing of ``dlrover_tpu/common/rpc.py``: a TCP
stream of 4-byte big-endian lengths and msgpack maps. A request is
``{"m": method, "p": <serialized message>, "id": seq, "c": client id}``;
the reply is ``{"ok": bool, "p": <serialized message>, "err": str}``. The
master drops a retried frame it already ran (same client id and seq) and
replays its answer, so a retry after a lost connection is exactly-once.
"""

import socket
import threading
import time
import uuid
from typing import Any

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.multi_process import recv_msg, send_msg


class RPCError(RuntimeError):
    pass


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
        attempts = max(1, self._retries if retries is None else retries)
        for attempt in range(attempts):
            try:
                conn = self._conn()
                send_msg(conn, frame)
                resp = recv_msg(conn)
                break
            except (ConnectionError, OSError):
                self._close()
                if attempt + 1 == attempts:
                    raise
                time.sleep(min(0.1 * 1.6 ** attempt, 5.0))
        if not resp.get("ok"):
            raise RPCError(f"rpc {method} to {self.addr} failed: "
                           f"{resp.get('err', 'unknown rpc error')}")
        return comm.deserialize(resp.get("p", b""))
