"""Checkpoint replicas held by peer agents.

The port's copy of ``dlrover_tpu/ckpt/replica.py``, on the same wire (the
``replica_put`` / ``replica_list`` methods and the fabric's
``frame/{owner}/{local}`` key), so either package's store serves either
package's workers. Each worker pushes every sealed shm frame, on its
drain thread, to its own agent's :class:`ReplicaService` and to the
stores of its backup group (``group_size`` consecutive node ranks); the
stores keep the newest frame of each owner in the agent's memory, so a
frame outlives its worker's segment and its node.

A worker restarted under a live agent writes its own frame back from the
agent's store (:meth:`ReplicaManager.try_restore_shm`); a relaunched or
shrunk world assembles from any owner's frames the stores hold
(:meth:`ReplicaManager.list_entries`, :meth:`ReplicaManager.fetch_frame`).
Downloads ride the striped fabric (``common/fabric.py``): every store
holding a copy serves stripes, and the content CRC guards against mixing
the bytes of a same-step overwrite. Unlike the reference, a worker pushes
to its own agent's store on a single node too: a one-node job's restarted
worker then finds its frame after its segment is gone.

A frame is large (6.2 GB for phase 8's twin), and a worker that copies
and sends it over TCP holds its GIL through each chunk's copy, which
stalls its training loop. So a port worker hands its frame to its own
agent's port store by name (``replica_put_local``, on the engine's drain
thread, which holds the frame's save lock until it returns, so saves
skip meanwhile): the store copies the sealed frame out of the segment in
the agent's process and pushes it to the group's peers itself, over the
reference's wire, before it answers; a restarted worker has its frame
written back into its segment the same way (``replica_write_local``),
the store checking its CRCs first. A store takes these two methods only
for its own job's and node's segments. The agent's forwarder speaks the
reference's byte push to any store, a JAX one too; a worker fetches a
frame its own store does not hold over the fabric.
"""

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from dlrover_tpu_torch.ckpt.shm_handler import (
    SharedMemoryHandler,
    shm_name,
    verify_frame_blob,
)
from dlrover_tpu_torch.common import comm, fabric
from dlrover_tpu_torch.common.constants import ConfigKey, env_int
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.rpc import (
    RPCClient,
    RPCError,
    RPCServer,
    local_host_ip,
)

# one bad peer (dead, address reused, handler error) never ends the loop
# over the others
_PEER_ERRORS = (ConnectionError, OSError, RPCError)


def frame_key(owner_rank: int, local_rank: int) -> str:
    """The fabric key one stored frame is served under."""
    return f"frame/{int(owner_rank)}/{int(local_rank)}"


def addr_key(job_name: str, node_rank: int) -> str:
    """The master KV key of a node's replica store address."""
    return f"replica/{job_name}/addr/{int(node_rank)}"


def _join(chunks) -> memoryview:
    """One frame from its received parts, copied by numpy with the GIL
    released (``b"".join`` holds it through the whole copy, stalling the
    agent's other threads)."""
    out = np.empty(sum(len(c) for c in chunks), np.uint8)
    pos = 0
    for c in chunks:
        part = np.frombuffer(c, np.uint8)
        out[pos:pos + part.size] = part
        pos += part.size
    return memoryview(out)


def backup_peers(node_rank: int, node_num: int,
                 group_size: int = 2) -> List[int]:
    """The other members of this node's backup group: blocks of
    ``group_size`` consecutive node ranks, the last one possibly
    smaller."""
    if group_size <= 1 or node_num <= 1:
        return []
    start = (node_rank // group_size) * group_size
    end = min(start + group_size, node_num)
    return [r for r in range(start, end) if r != node_rank]


class ReplicaService:
    """The agent's store of frames (its node's and its group peers'),
    served over TCP; it lives in the agent, so it survives its workers.

    It keeps the newest ``KEEP_STEPS`` frames of each owner (the
    reference keeps one): a save that sealed on one node but never reached
    the store from another (its node died mid-push) leaves the step
    before it whole. ``frame/{owner}/{local}`` serves the newest, as in
    the reference; ``frame/{owner}/{local}/{step}`` a kept step."""

    PARTIAL_TTL_S = 3600.0
    KEEP_STEPS = 2

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        # (owner, local) -> [(step, blob, version)], newest first; the
        # version changes on every overwrite, same step too, so a download
        # spanning one fails
        self._store: Dict[Tuple[int, int],
                          List[Tuple[int, bytes, int]]] = {}
        self._version_seq = 0
        # chunked uploads in flight: (owner, local, step) -> {idx: bytes}
        self._partial: Dict[Tuple[int, int, int], Dict[int, bytes]] = {}
        self._partial_ts: Dict[Tuple[int, int, int], float] = {}
        self._lock = threading.Lock()
        self._server = RPCServer(host, port)
        # a pushed chunk stays a view of its received frame until joined
        self._server.register("replica_put", self._on_put, views=True)
        self._server.register("replica_list", self._on_list)
        self._server.register("replica_put_local", self._on_put_local)
        self._server.register("replica_write_local", self._on_write_local)
        # pushes a local put to the group's peers (set by the agent)
        self.forwarder: Optional["ReplicaManager"] = None
        # (job, node rank) once registered: the only segments the local
        # methods open
        self._owner: Optional[Tuple[str, int]] = None
        # downloads ride the fabric; the store version is the etag, so its
        # content-CRC memo never outlives an overwrite
        self.fabric = fabric.FabricServer(server=self._server)
        self.fabric.register_provider("frame", self._provide_frame)

    @property
    def port(self) -> int:
        return self._server.port

    def register(self, master_client, job_name: str, node_rank: int,
                 host: Optional[str] = None) -> str:
        """Publish this store's address in the master KV, where workers
        (pushes) and peers (fetches) find it."""
        addr = f"{host or local_host_ip()}:{self.port}"
        self._owner = (job_name, int(node_rank))
        master_client.kv_set(addr_key(job_name, node_rank), addr.encode())
        return addr

    def start(self) -> None:
        self._server.start()

    def stop(self) -> None:
        self._server.stop()

    # -- the store -----------------------------------------------------------

    def put(self, owner_rank: int, local_rank: int, step: int,
            blob: bytes) -> None:
        with self._lock:
            key = (owner_rank, local_rank)
            kept = [e for e in self._store.get(key, []) if e[0] != step]
            self._version_seq += 1
            kept.append((step, blob, self._version_seq))
            kept.sort(key=lambda e: e[0], reverse=True)
            self._store[key] = kept[:self.KEEP_STEPS]
            # an upload at or below this step is moot; an abandoned one
            # (its uploader died) expires
            now = time.monotonic()
            for k in list(self._partial):
                stale = k[:2] == key and k[2] <= step
                expired = (now - self._partial_ts.get(k, now)
                           > self.PARTIAL_TTL_S)
                if stale or expired:
                    self._partial.pop(k, None)
                    self._partial_ts.pop(k, None)

    def get(self, owner_rank: int, local_rank: int,
            step: Optional[int] = None) -> Optional[Tuple[int, bytes]]:
        """The newest frame of an owner, or its frame of ``step``."""
        held = self._get_versioned(owner_rank, local_rank, step)
        return None if held is None else (held[0], held[1])

    def _get_versioned(self, owner_rank: int, local_rank: int,
                       step: Optional[int] = None
                       ) -> Optional[Tuple[int, bytes, int]]:
        with self._lock:
            kept = self._store.get((owner_rank, local_rank), [])
        return next((e for e in kept if step is None or e[0] == step), None)

    def entries(self) -> List[List[int]]:
        with self._lock:
            return [[o, lr, e[0]] for (o, lr), kept in self._store.items()
                    for e in kept]

    # -- rpc handlers --------------------------------------------------------

    def _on_put(self, req: comm.ReplicaPutRequest) -> comm.BoolResponse:
        if req.chunk_count <= 1:
            self.put(req.owner_rank, req.local_rank, req.step,
                     _join([req.blob]))
            return comm.BoolResponse(value=True)
        key = (req.owner_rank, req.local_rank, req.step)
        with self._lock:
            chunks = self._partial.setdefault(key, {})
            self._partial_ts.setdefault(key, time.monotonic())
            chunks[req.chunk_index] = req.blob
            done = len(chunks) == req.chunk_count
            if done:
                parts = [chunks[i] for i in range(req.chunk_count)]
                del self._partial[key]
                self._partial_ts.pop(key, None)
        if done:
            # put also sweeps this owner's older and expired uploads
            self.put(req.owner_rank, req.local_rank, req.step,
                     _join(parts))
        return comm.BoolResponse(value=True)

    def _refuse_local(self, req: comm.ReplicaLocalRequest
                      ) -> Optional[comm.BaseResponse]:
        """A refusal unless ``req`` names a worker segment of this store's
        own job and node (the server listens on every interface)."""
        if self._owner is not None:
            job, node = self._owner
            base = shm_name(job, node, req.local_rank, incarnation="")
            name = req.shm_name
            if req.owner_rank == node and (
                    name == base or (name.startswith(base + "_i")
                                     and "/" not in name)):
                return None
        return comm.BaseResponse(
            success=False, message=f"refused: {req.shm_name!r} of node "
            f"{req.owner_rank} is not a segment of this store's node")

    def _on_put_local(self, req: comm.ReplicaLocalRequest
                      ) -> comm.BaseResponse:
        """Copy the worker's sealed frame of ``req.step`` out of its
        segment (the worker holds its save lock meanwhile), store it and
        push it to ``req.peers``; ``data`` is the number of stores that
        took it, the bytes and the copy's seconds."""
        refused = self._refuse_local(req)
        if refused is not None:
            return refused
        t0 = time.monotonic()
        shm = SharedMemoryHandler(req.shm_name)
        try:
            meta = shm.read_meta()
            if meta is None or int(meta["step"]) != req.step:
                return comm.BaseResponse(
                    success=False, message=f"{req.shm_name} holds no sealed "
                    f"frame of step {req.step}")
            blob = shm.read_frame_bytes()
        finally:
            shm.close()
        copy_s = time.monotonic() - t0
        self.put(req.owner_rank, req.local_rank, req.step, blob)
        stores = 1
        if req.peers and self.forwarder is not None:
            stores += self.forwarder.push_to(req.peers, blob, req.step,
                                             req.local_rank)
        return comm.BaseResponse(success=True, data={
            "stores": stores, "bytes": len(blob), "copy_s": copy_s})

    def _on_write_local(self, req: comm.ReplicaLocalRequest
                        ) -> comm.BaseResponse:
        """Write the stored frame of ``(owner, local)`` at ``req.step``
        into the segment ``shm_name``, unless it fails its CRCs (``data``
        then names the corrupt shards)."""
        refused = self._refuse_local(req)
        if refused is not None:
            return refused
        held = self.get(req.owner_rank, req.local_rank, req.step)
        if held is None:
            return comm.BaseResponse(success=False, message="not held")
        bad = verify_frame_blob(held[1])
        if bad:
            return comm.BaseResponse(success=False, message="corrupt",
                                     data=bad)
        shm = SharedMemoryHandler(req.shm_name)
        try:
            shm.write_raw(held[1])
        finally:
            shm.close()
        return comm.BaseResponse(success=True)

    def _provide_frame(self, rest: str):
        """The fabric provider of ``frame/{owner}/{local}[/{step}]``: the
        captured blob is immutable, so one resolution's stripes stay
        consistent while a newer push replaces the entry."""
        parts = [int(x) for x in rest.split("/")]
        held = self._get_versioned(parts[0], parts[1],
                                   parts[2] if len(parts) > 2 else None)
        if held is None:
            return None
        step, blob, version = held
        view = memoryview(blob)
        return step, len(blob), version, lambda off, n: view[off:off + n]

    def _on_list(self, req) -> comm.ReplicaListResponse:
        return comm.ReplicaListResponse(entries=self.entries())


class ReplicaManager:
    """The client side: pushes this node's frames to its stores and
    fetches frames back. A worker's manager (``service`` None) hands its
    frame to its own agent's port store by name; an agent's manager puts
    into its own store directly and pushes the bytes to the peers. Store
    addresses come from the master KV (:func:`addr_key`)."""

    # a frame may pass the transport's 4 GiB frame limit: pushes go in
    # chunks well below it, which also caps the fabric stripe
    CHUNK_BYTES = 256 * 1024 * 1024

    def __init__(self, job_name: str, node_rank: int, node_num: int,
                 master_client, service: Optional[ReplicaService] = None,
                 group_size: int = 2, host: Optional[str] = None,
                 reporter=None):
        self.job_name = job_name
        self.node_rank = node_rank
        self.node_num = node_num
        self.group_size = group_size
        self._master = master_client
        self._service = service
        # the fabric's journal events go here (the engine's reporter)
        self._reporter = reporter
        self._host = host or local_host_ip()
        self._addrs: Dict[int, str] = {}
        self._clients: Dict[int, RPCClient] = {}
        # the last push: its step, bytes, seconds, the stores that took
        # it and (a local put) the store's copy seconds
        self.last_push: Dict[str, float] = {}
        if service is not None and master_client is not None:
            service.register(master_client, job_name, node_rank,
                             host=self._host)

    @property
    def peers(self) -> List[int]:
        return backup_peers(self.node_rank, self.node_num, self.group_size)

    def _peer_addr(self, rank: int) -> Optional[str]:
        addr = self._addrs.get(rank)
        if addr:
            return addr
        if self._master is None:
            return None
        raw = self._master.kv_get(addr_key(self.job_name, rank))
        if not raw:
            return None
        addr = bytes(raw).decode()
        self._addrs[rank] = addr
        return addr

    def _peer_client(self, rank: int) -> Optional[RPCClient]:
        client = self._clients.get(rank)
        if client is not None:
            return client
        addr = self._peer_addr(rank)
        if addr is None:
            return None
        client = RPCClient(addr, timeout_s=60.0, retries=3)
        self._clients[rank] = client
        return client

    def _drop_peer(self, rank: int) -> None:
        # a relaunched peer may come back at another address
        self._clients.pop(rank, None)
        self._addrs.pop(rank, None)

    # -- backup --------------------------------------------------------------


    def push_to(self, ranks, blob, step: int, local_rank: int) -> int:
        """One frame, in chunks, to the stores of node ``ranks``; returns
        the number that took it."""
        acked = 0
        n_chunks = max(1, -(-len(blob) // self.CHUNK_BYTES))
        view = memoryview(blob)
        for rank in ranks:
            client = self._peer_client(rank)
            if client is None:
                continue
            try:
                for i in range(n_chunks):
                    lo = i * self.CHUNK_BYTES
                    client.call("replica_put", comm.ReplicaPutRequest(
                        owner_rank=self.node_rank, local_rank=local_rank,
                        step=step,
                        blob=view[lo:lo + self.CHUNK_BYTES],
                        chunk_index=i, chunk_count=n_chunks))
                acked += 1
            except _PEER_ERRORS as e:
                logger.warning("replica push to node %s failed: %r", rank, e)
                self._drop_peer(rank)
        return acked

    def _note_push(self, step: int, nbytes: int, stores: int,
                   t0: float, **extra) -> None:
        self.last_push = {"step": step, "bytes": nbytes, "stores": stores,
                          "seconds": time.monotonic() - t0,
                          "ts": time.time(), **extra}

    def _local_call(self, method: str, shm: SharedMemoryHandler, step: int,
                    local_rank: int, peers=()):
        """``method`` on this node's port store for the segment of
        ``shm``; None when the store cannot be reached or fails."""
        client = self._peer_client(self.node_rank)
        if client is None:
            logger.warning("no replica store address for node %s",
                           self.node_rank)
            return None
        try:
            return client.call(method, comm.ReplicaLocalRequest(
                owner_rank=self.node_rank, local_rank=local_rank, step=step,
                shm_name=shm.name, peers=list(peers)))
        except _PEER_ERRORS as e:
            logger.warning("replica store of node %s: %s failed: %r",
                           self.node_rank, method, e)
            self._drop_peer(self.node_rank)
            return None

    def backup(self, shm: SharedMemoryHandler, local_rank: int = 0) -> int:
        """An agent's manager: copy the frame in ``shm`` into this node's
        store and push it to the group's peers now; returns the number of
        stores that took it."""
        blob = shm.read_frame_bytes()
        if blob is None:
            return 0
        t0 = time.monotonic()
        step = shm.step
        self._service.put(self.node_rank, local_rank, step, blob)
        acked = 1 + self.push_to(self.peers, blob, step, local_rank)
        self._note_push(step, len(blob), acked, t0)
        return acked

    def backup_async(self, shm: SharedMemoryHandler,
                     local_rank: int = 0) -> bool:
        """A worker's manager, on the drain thread right after the seal
        (it holds the frame's save lock, so training goes on and its saves
        skip): this node's port store copies the frame out of the segment
        and pushes it to the group's peers before this returns. False when
        the store refused it or could not be reached (logged)."""
        t0 = time.monotonic()
        step = shm.step
        resp = self._local_call("replica_put_local", shm, step, local_rank,
                                self.peers)
        if resp is None:
            return False
        if not resp.success:
            logger.warning("replica put of step %s refused: %s", step,
                           resp.message)
            return False
        self._note_push(step, int(resp.data["bytes"]),
                        int(resp.data["stores"]), t0,
                        copy_s=resp.data.get("copy_s"))
        return True

    # -- restore -------------------------------------------------------------

    def _remote_ranks(self) -> List[int]:
        return (self.peers if self._service is not None
                else [self.node_rank, *self.peers])

    def _fetch_via_fabric(self, owner_rank: int, local_rank: int,
                          step: Optional[int] = None
                          ) -> Optional[Tuple[int, bytes]]:
        """One owner's frame (its newest, or ``step``), striped over every
        store holding a copy; fetched again once after a content mismatch
        (a same-step overwrite landed mid-transfer). A store that keeps
        one step (the JAX package's) serves ``step`` only as its newest."""
        sources, ranks = [], self._remote_ranks()
        for rank in ranks:
            addr = self._peer_addr(rank)
            if addr:
                sources.append(fabric.FabricSource(addr=addr, rank=rank))
        if not sources:
            return None
        key = frame_key(owner_rank, local_rank)
        keys = [f"{key}/{step}", key] if step is not None else [key]
        stripe = min(self.CHUNK_BYTES,
                     env_int(ConfigKey.FABRIC_STRIPE_BYTES,
                             fabric.DEFAULT_STRIPE_BYTES))
        for attempt in range(2 * len(keys)):
            try:
                got, blob, _ = fabric.fetch(
                    sources, keys[0],
                    expect_step=-1 if step is None else step,
                    stripe_bytes=stripe, timeout_s=60.0,
                    reporter=self._reporter)
                return got, blob
            except fabric.FabricAbort as e:
                if e.reason == "content_mismatch" and attempt == 0:
                    continue
                if e.reason == "no_sources" and len(keys) > 1:
                    keys.pop(0)  # no store kept the step under its key
                    continue
                logger.info("replica fabric fetch of %s aborted (%s): %s",
                            keys[0], e.reason, e)
                return None
        return None

    def fetch(self, local_rank: int = 0) -> Optional[Tuple[int, bytes]]:
        """This node's newest frame: the agent's own store first, then
        the group's stores over the fabric."""
        return self.fetch_frame(self.node_rank, local_rank)

    def list_entries(self) -> List[Tuple[int, int, int]]:
        """Every ``(owner_rank, local_rank, step)`` this node's store and
        its group peers' hold: the peer-frame rung looks here for a step
        the stores cover."""
        entries: List[Tuple[int, int, int]] = []
        if self._service is not None:
            entries.extend(tuple(e) for e in self._service.entries())
        for rank in self._remote_ranks():
            client = self._peer_client(rank)
            if client is None:
                continue
            try:
                resp = client.call("replica_list", comm.BaseRequest())
            except _PEER_ERRORS:
                self._drop_peer(rank)
                continue
            entries.extend((int(o), int(lr), int(s))
                           for o, lr, s in resp.entries)
        return sorted(set(entries))

    def newest_step(self) -> int:
        """The newest step any reachable store holds (-1: none)."""
        try:
            entries = self.list_entries()
        except (ConnectionError, OSError, RuntimeError):
            return -1
        return max((int(s) for _, _, s in entries), default=-1)

    def fetch_frame(self, owner_rank: int, local_rank: int = 0,
                    step: Optional[int] = None
                    ) -> Optional[Tuple[int, bytes]]:
        """Any owner's frame (its newest, or ``step``) from whichever store
        holds the newest copy: this agent's own store first, then the
        group's over the fabric."""
        best: Optional[Tuple[int, bytes]] = None
        if self._service is not None:
            best = self._service.get(owner_rank, local_rank, step)
            if best is not None and step is not None:
                return best
        held = self._fetch_via_fabric(owner_rank, local_rank, step)
        if held is not None and (best is None or held[0] > best[0]):
            best = held
        return best

    def write_local(self, shm: SharedMemoryHandler, step: int,
                    local_rank: int = 0):
        """Have this node's port store write this worker's stored frame of
        ``step`` into ``shm``: ``(True, [])``, ``(False, corrupt shard
        names)`` when the copy failed its CRCs, or None when the store
        cannot (unreachable, or not holding that step)."""
        resp = self._local_call("replica_write_local", shm, step,
                                local_rank)
        if resp is None or (not resp.success and resp.message != "corrupt"):
            return None
        return resp.success, list(resp.data or [])

    def try_restore_shm(self, shm: SharedMemoryHandler, local_rank: int = 0,
                        force: bool = False) -> int:
        """Write this node's frame back into ``shm`` when a store holds a
        newer one; returns the step written (-1: nothing; the shm step
        when it was not older). ``force`` writes even a step that is not
        newer: the repair of a frame that failed its CRCs. A fetched blob
        that fails its own CRCs is never written."""
        held = self.fetch(local_rank)
        if held is None:
            return -1
        step, blob = held
        if not force and step <= shm.step:
            return shm.step
        bad = verify_frame_blob(blob)
        if bad:
            logger.error("replica frame of node %s local %s (step %s) "
                         "fails its integrity check (%s) — not restored "
                         "from it", self.node_rank, local_rank, step, bad)
            return -1
        shm.write_raw(blob)
        logger.info("restored node %s local %s shm frame (step %s) from a "
                    "replica store%s", self.node_rank, local_rank, step,
                    " [forced repair]" if force else "")
        return step
