"""The agent's local IPC, and shm that outlives the worker.

The port's copy of ``dlrover_tpu/common/multi_process.py``: the agent
serves named locks, queues and dicts on one unix socket
(:class:`LocalIPCServer`, at :func:`ipc_socket_path`); a worker reaches
them through :class:`SharedLock`, :class:`SharedQueue` and
:class:`SharedDict`. A lock whose holder died (a worker SIGKILLed while
writing a frame) is freed when its connection drops or when a waiter finds
the holder's pid gone, so the next incarnation does not deadlock. Either
package's agent serves either package's workers.
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


def _owner_alive(owner: Any) -> Optional[bool]:
    """Liveness of a lock owner recorded as a pid string: True/False, or
    None when the owner field isn't a verifiable pid."""
    try:
        pid = int(owner)
    except (TypeError, ValueError):
        return None
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        pass
    try:
        # a SIGKILLed-but-unreaped holder is a zombie: kill(pid, 0) still
        # succeeds, but its lock must be treated as abandoned
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read()
        return stat.rsplit(b")", 1)[1].split()[0] != b"Z"
    except (OSError, IndexError):
        return True

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
    # a blocking socket waits in one call for the whole message, out of
    # the GIL (a large frame in small reads contends with busy threads)
    flags = socket.MSG_WAITALL if sock.gettimeout() is None else 0
    while got < n:
        nread = sock.recv_into(view[got:], n - got, flags)
        if not nread:
            raise ConnectionError("socket closed")
        got += nread
    return buf


def ipc_socket_dir(job_name: str, node_rank: int = 0) -> str:
    """Per-(job, node) socket directory. The node_rank suffix keeps
    multiple agents of one job apart when they share a host (the
    dev-loop/chaos-sim case — on a real pod each host has its own /tmp):
    without it a second agent's server would rebind and steal the first
    agent's socket mid-run."""
    uid = os.getuid()
    return f"/tmp/dlrover_tpu_{uid}_{job_name}_n{node_rank}"


def ipc_socket_path(job_name: str, node_rank: int = 0) -> str:
    return os.path.join(ipc_socket_dir(job_name, node_rank), "ipc.sock")


class LocalIPCServer:
    """Threaded unix-socket server in the agent process hosting named locks,
    queues and dicts for worker processes."""

    def __init__(self, socket_path: str):
        self._path = socket_path
        os.makedirs(os.path.dirname(socket_path), exist_ok=True)
        if os.path.exists(socket_path):
            os.unlink(socket_path)
        self._locks: Dict[str, Dict[str, Any]] = {}
        self._queues: Dict[str, queue.Queue] = {}
        self._dicts: Dict[str, Dict] = {}
        self._meta_lock = threading.Lock()
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(socket_path)
        self._sock.listen(128)
        self._stopped = False
        self._thread = threading.Thread(
            target=self._accept_loop, name="ipc-server", daemon=True
        )

    @property
    def path(self) -> str:
        return self._path

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stopped = True
        try:
            self._sock.close()
        except OSError:
            logger.debug("ipc server socket close failed", exc_info=True)
        try:
            os.unlink(self._path)
        except OSError:
            logger.debug("ipc socket unlink failed: %s", self._path,
                         exc_info=True)

    # -- server internals --------------------------------------------------

    def _accept_loop(self) -> None:
        conn_seq = 0
        while not self._stopped:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn_seq += 1
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True,
                name=f"ipc-conn-{conn_seq}",
            )
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        # each client connection gets a token; locks record the acquiring
        # token so a client that dies HOLDING a lock (e.g. a worker
        # SIGKILLed mid checkpoint write) releases it on disconnect instead
        # of leaking it — otherwise every later persist of that frame would
        # burn its full lock timeout (the frame-seal write order in
        # shm_handler makes reading after such a death safe)
        token = object()
        try:
            while True:
                req = recv_msg(conn)
                try:
                    result = self._dispatch(req, token)
                    send_msg(conn, {"ok": True, "result": result})
                except Exception as e:  # noqa: BLE001 — report to client
                    logger.debug("ipc dispatch error reported to "
                                 "client: %r", e)
                    send_msg(conn, {"ok": False, "error": repr(e)})
        except (ConnectionError, OSError):
            # normal peer disconnect; worth a trace when debugging hangs
            logger.debug("ipc peer disconnected", exc_info=True)
        except Exception as e:  # noqa: BLE001 — undecodable frame: drop conn
            logger.warning("ipc connection dropped on bad frame: %r", e)
        finally:
            conn.close()
            self._release_locks_of(token)

    def _release_locks_of(self, token: object) -> None:
        # Each check-then-release runs under _meta_lock, serialized against
        # _lock_op's state updates: without that, an interleaved explicit
        # release + fresh acquire could make this cleanup release a lock now
        # held by a live client. A connection can also die while its holder
        # lives on (_IPCClient reconnects on transient OSError; the server
        # drops conns on undecodable frames) — so only a verifiably-DEAD
        # owner loses its lock. The kernel closes a dying process's fds
        # before it turns zombie, so "alive" right after a disconnect may be
        # exit-in-progress: re-check briefly before trusting it.
        for _attempt in range(4):
            holder_looks_alive = False
            with self._meta_lock:
                for name, state in self._locks.items():
                    if not state["lock"].locked():
                        continue
                    owner = state.get("owner")
                    if state.get("conn_token") is token:
                        if _owner_alive(owner) is True:
                            holder_looks_alive = True
                            continue
                    elif not (
                        state.get("conn_token") is None
                        and _owner_alive(owner) is False
                    ):
                        # sweep orphans from earlier live-at-disconnect
                        # holders that have since died; leave the rest alone
                        continue
                    state["owner"] = None
                    state["conn_token"] = None
                    try:
                        state["lock"].release()
                    except RuntimeError:
                        continue
                    logger.warning(
                        "ipc lock %r auto-released: holder (pid %s) gone",
                        name, owner,
                    )
            if not holder_looks_alive:
                return
            time.sleep(0.05)
        # the holder really is alive: its conn is gone, so detach the token
        # — a later disconnect sweep or acquire-time reclaim frees the lock
        # if the holder dies without releasing
        with self._meta_lock:
            for name, state in self._locks.items():
                if state.get("conn_token") is token and state["lock"].locked():
                    state["conn_token"] = None
                    logger.warning(
                        "ipc lock %r: holder conn dropped but pid %s is "
                        "alive — keeping the lock", name, state.get("owner"),
                    )

    def _dispatch(self, req: Dict, token: object = None) -> Any:
        kind, name, method = req["kind"], req["name"], req["method"]
        args = req.get("args", {})
        if kind == "lock":
            return self._lock_op(name, method, args, token)
        if kind == "queue":
            return self._queue_op(name, method, args)
        if kind == "dict":
            return self._dict_op(name, method, args)
        raise ValueError(f"unknown ipc kind {kind}")

    def _lock_state(self, name: str) -> Dict[str, Any]:
        with self._meta_lock:
            if name not in self._locks:
                self._locks[name] = {"lock": threading.Lock(), "owner": None}
            return self._locks[name]

    def _lock_op(self, name: str, method: str, args: Dict,
                 token: object = None) -> Any:
        state = self._lock_state(name)
        owner = args.get("owner")
        if method == "acquire":
            blocking = args.get("blocking", True)
            timeout = args.get("timeout", -1)

            def _reclaim_if_holder_dead() -> None:
                # the blocker may be a dead holder whose conn never
                # dropped (or dropped while it was still alive, detaching
                # the conn token)
                with self._meta_lock:
                    holder = state.get("owner")
                    if (state["lock"].locked()
                            and _owner_alive(holder) is False):
                        state["owner"] = None
                        state["conn_token"] = None
                        try:
                            state["lock"].release()
                        except RuntimeError:
                            pass
                        logger.warning(
                            "ipc lock %r reclaimed from dead pid %s",
                            name, holder,
                        )

            if not blocking:
                acquired = state["lock"].acquire(blocking=False)
                if not acquired:
                    _reclaim_if_holder_dead()
                    acquired = state["lock"].acquire(blocking=False)
            else:
                # blocking waits run in bounded slices with a dead-holder
                # check between them — a holder that dies while we block
                # (its conn already detached) must not deadlock us
                deadline = (
                    time.monotonic() + timeout
                    if timeout and timeout > 0 else None
                )
                acquired = False
                while not acquired:
                    remain = (
                        deadline - time.monotonic()
                        if deadline is not None else 2.0
                    )
                    if deadline is not None and remain <= 0:
                        break
                    acquired = state["lock"].acquire(
                        timeout=min(2.0, remain)
                    )
                    if not acquired:
                        _reclaim_if_holder_dead()
            if acquired:
                with self._meta_lock:
                    state["owner"] = owner
                    state["conn_token"] = token
            return acquired
        if method == "release":
            with self._meta_lock:
                if state["lock"].locked():
                    state["owner"] = None
                    state["conn_token"] = None
                    try:
                        state["lock"].release()
                    except RuntimeError:
                        pass
                    return True
                return False
        if method == "locked":
            return state["lock"].locked()
        raise ValueError(f"unknown lock method {method}")

    def _queue(self, name: str) -> queue.Queue:
        with self._meta_lock:
            if name not in self._queues:
                self._queues[name] = queue.Queue()
            return self._queues[name]

    def _queue_op(self, name: str, method: str, args: Dict) -> Any:
        q = self._queue(name)
        if method == "put":
            q.put(args["item"])
            return True
        if method == "get":
            timeout = args.get("timeout")
            try:
                return {"found": True, "item": q.get(timeout=timeout)}
            except queue.Empty:
                return {"found": False, "item": None}
        if method == "qsize":
            return q.qsize()
        if method == "empty":
            return q.empty()
        raise ValueError(f"unknown queue method {method}")

    def _dict(self, name: str) -> Dict:
        with self._meta_lock:
            if name not in self._dicts:
                self._dicts[name] = {}
            return self._dicts[name]

    def _dict_op(self, name: str, method: str, args: Dict) -> Any:
        d = self._dict(name)
        if method == "set":
            d[args["key"]] = args["value"]
            return True
        if method == "get":
            key = args["key"]
            return {"found": key in d, "value": d.get(key)}
        if method == "update":
            d.update(args["items"])
            return True
        if method == "snapshot":
            return dict(d)
        if method == "delete":
            d.pop(args["key"], None)
            return True
        raise ValueError(f"unknown dict method {method}")

    # -- in-process accessors (agent side reads directly, no socket) -------

    def local_queue(self, name: str) -> queue.Queue:
        return self._queue(name)

    def local_dict(self, name: str) -> Dict:
        return self._dict(name)


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
