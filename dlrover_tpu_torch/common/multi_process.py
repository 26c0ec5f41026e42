"""Worker side of the agent's local IPC, and shm that outlives the worker.

The port's copy of the client half of ``dlrover_tpu/common/multi_process.py``:
the agent (the JAX package's, unchanged) serves named locks, queues and
dicts on one unix socket (``LocalIPCServer``); a worker reaches them
through :class:`SharedLock`, :class:`SharedQueue` and :class:`SharedDict`.
The wire is the reference's: a 4-byte big-endian length, then one msgpack
map ``{"kind", "name", "method", "args"}``, answered by ``{"ok", "result"}``
or ``{"ok": False, "error"}``.

:func:`create_shared_memory` opens a POSIX segment without the resource
tracker's ownership, so a checkpoint frame survives the worker that wrote
it and the agent (or the worker's next incarnation) can still read it.
"""

import os
import queue
import socket
import struct
import threading
import time
from multiprocessing import shared_memory
from typing import Any, Dict, Optional

from dlrover_tpu_torch.common import msgpack
from dlrover_tpu_torch.common.log import logger

_LEN = struct.Struct(">I")
# below this, header and payload go out in one send
_SEND_SPLIT_BYTES = 64 * 1024


def send_msg(sock: socket.socket, obj: Any) -> None:
    data = msgpack.packb(obj)
    if len(data) <= _SEND_SPLIT_BYTES:
        sock.sendall(_LEN.pack(len(data)) + data)
    else:
        sock.sendall(_LEN.pack(len(data)))
        sock.sendall(data)


def recv_msg(sock: socket.socket) -> Any:
    (size,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return msgpack.unpackb(_recv_exact(sock, size))


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        nread = sock.recv_into(view[got:], n - got)
        if not nread:
            raise ConnectionError("socket closed")
        got += nread
    return buf


class _IPCClient:
    """One lazily-connected client socket per (object, thread)."""

    def __init__(self, socket_path: str):
        self._path = socket_path
        self._tls = threading.local()

    def _conn(self) -> socket.socket:
        conn = getattr(self._tls, "conn", None)
        if conn is None:
            conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            conn.connect(self._path)
            self._tls.conn = conn
        return conn

    def call(self, kind: str, name: str, method: str, **args) -> Any:
        last_err: Optional[Exception] = None
        for _ in range(3):
            try:
                conn = self._conn()
                send_msg(conn, {"kind": kind, "name": name,
                                "method": method, "args": args})
                resp = recv_msg(conn)
                if not resp["ok"]:
                    raise RuntimeError(resp["error"])
                return resp["result"]
            except (ConnectionError, OSError) as e:
                last_err = e
                self._close()
                time.sleep(0.1)
        raise ConnectionError(f"ipc call failed: {last_err}")

    def _close(self) -> None:
        conn = getattr(self._tls, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
            self._tls.conn = None


class SharedLock:
    """Cross-process lock served by the agent."""

    def __init__(self, name: str, socket_path: str):
        self._name = name
        self._client = _IPCClient(socket_path)
        self._owner = f"{os.getpid()}"

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        return self._client.call("lock", self._name, "acquire",
                                 blocking=blocking, timeout=timeout,
                                 owner=self._owner)

    def release(self) -> bool:
        return self._client.call("lock", self._name, "release",
                                 owner=self._owner)

    def locked(self) -> bool:
        return self._client.call("lock", self._name, "locked")

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class SharedQueue:
    """Cross-process FIFO served by the agent."""

    def __init__(self, name: str, socket_path: str):
        self._name = name
        self._client = _IPCClient(socket_path)

    def put(self, item: Any) -> None:
        self._client.call("queue", self._name, "put", item=item)

    def get(self, timeout: Optional[float] = None) -> Any:
        r = self._client.call("queue", self._name, "get", timeout=timeout)
        if not r["found"]:
            raise queue.Empty
        return r["item"]

    def qsize(self) -> int:
        return self._client.call("queue", self._name, "qsize")

    def empty(self) -> bool:
        return self._client.call("queue", self._name, "empty")


class SharedDict:
    """Cross-process dict served by the agent."""

    def __init__(self, name: str, socket_path: str):
        self._name = name
        self._client = _IPCClient(socket_path)

    def set(self, key: str, value: Any) -> None:
        self._client.call("dict", self._name, "set", key=key, value=value)

    def get(self, key: str, default: Any = None) -> Any:
        r = self._client.call("dict", self._name, "get", key=key)
        return r["value"] if r["found"] else default

    def update(self, items: Dict) -> None:
        self._client.call("dict", self._name, "update", items=items)

    def snapshot(self) -> Dict:
        return self._client.call("dict", self._name, "snapshot")

    def delete(self, key: str) -> None:
        self._client.call("dict", self._name, "delete", key=key)


def create_shared_memory(
    name: str, create: bool, size: int = 0
) -> Optional[shared_memory.SharedMemory]:
    """Open or create a POSIX shm segment without resource-tracker
    ownership (the tracker would unlink it when this process exits)."""
    from multiprocessing import resource_tracker

    try:
        shm = shared_memory.SharedMemory(name=name, create=create, size=size)
    except FileNotFoundError:
        return None
    except FileExistsError:
        shm = shared_memory.SharedMemory(name=name, create=False)
        if size and shm.size < size:
            shm.close()
            unlink_shared_memory(name)
            shm = shared_memory.SharedMemory(name=name, create=True,
                                             size=size)
    try:
        resource_tracker.unregister(shm._name, "shared_memory")  # noqa: SLF001
    except Exception as e:  # noqa: BLE001 — best effort, tracker is private
        logger.debug("resource_tracker unregister skipped: %r", e)
    return shm


def unlink_shared_memory(name: str) -> None:
    try:
        shm = shared_memory.SharedMemory(name=name, create=False)
        shm.close()
        shm.unlink()
    except FileNotFoundError:
        pass
    except Exception as e:  # noqa: BLE001
        logger.warning("unlink shm %s failed: %s", name, e)
