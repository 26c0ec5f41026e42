"""Worker-side checkpoint engine: torch train state ↔ host shared memory.

The port's counterpart of ``dlrover_tpu/ckpt/engine.py``. It writes the
reference's frame (``ckpt/shm_handler.py``) under the reference's leaf
names (``convert.jax_leaf_name``), so either package's agent persists a
port worker's frames (its ``AsyncCheckpointSaver`` takes the save events
from the IPC queue) and the two engines restore each other's states.

- **Which shards.** Each leaf's local shard is saved only by the rank whose
  mesh coordinate is 0 on every axis that replicates the leaf (the
  reference's ``replica_id == 0``); a plain tensor counts as replicated
  over the whole world, so rank 0 saves it. ``start`` is the shard's
  global index (``parallel.sharding.region_for``), so a restore can cut
  any other layout out of the saved shards.
- **All ranks or none.** A save goes ahead only if every rank is ready: an
  all-reduce of the ready flags on the gloo host group (upstream DLRover's
  ``check_all_rank_ready``; the reference exchanges them through the
  master KV).
- **Device to host.** The save records an event on the training stream
  and returns. The drain thread copies the shards on a side stream into a
  bounded ring of pinned staging slots and streams the ring into the shm
  frame, then seals it. The trainer updates the state in place, so the
  save registers a reader in ``common.state_fence``: the next step's
  optimizer waits for the last device-to-host copy, while its forward and
  backward, which only read the state, overlap the drain. CPU tensors are
  copied before ``save_to_memory`` returns.
- **Replicas.** Under an agent with ``--ckpt-replica N`` (N > 1) the
  drain thread hands each sealed frame to its agent's replica store by
  segment name: the store copies it and pushes it to its backup group's
  stores (``ckpt/replica.py``) while the drain thread waits, holding the
  save lock, so training goes on and its saves skip meanwhile.
- **Restore.** The reference's ladder, each rung agreed by every rank (a
  MIN and a MAX all-reduce of the step on the gloo host group), so all
  ranks restore one step from one rung:

  1. live reshard (``ckpt/reshard.py``), when the master published a cut
     record for this rendezvous round: the survivors' sealed frames,
     pulled over the fabric;
  2. this worker's own frame written back into its segment from a
     replica store that holds a newer step (``last_restore`` then names
     it: ``written_back``);
  3. shm: every rank holds a sealed, intact frame of one step and its
     node's frames cover every region it needs (a replicated leaf may
     live in another local rank's frame); a frame that fails its CRCs is
     first repaired from a replica store's copy of the same step;
  4. peer frames: any owner's frames the replica stores hold, at the
     newest step past storage's tracked one that they cover;
  5. storage's tracked step; when its frames do not cover the state,
     peer frames at that step or an older one.

  The reference's peer-frame rung takes the newest step the stores
  cover, storage's tracked one too; the port's stores keep two steps an
  owner (the reference's one), so at a tie the port reads storage first.

  Each rung fills the target's tensors in place, cast to the target's
  dtype (optax starts its moments in the param dtype, the port in f32:
  the cast is exact); a card tensor that one saved shard covers exactly
  streams through the pinned staging ring. The manifest-chain rung
  between shm and peer frames is the storage read.

Tracing: a save is a ``ckpt.save_to_memory`` span whose context the
drain thread carries into ``ckpt.drain``; ``save_to_storage`` is a
``ckpt.persist_request`` span, and the SAVE event it puts on the agent's
queue carries that context under ``tc``, so the saver's ``ckpt.persist``
and ``ckpt.commit`` join the worker's trace; a restore is a
``ckpt.restore`` span. The reshard rung reports ``reshard_start``,
``reshard_complete`` and ``reshard_aborted`` (with its reason) to the
master's journal and feeds ``dlrover_reshard_seconds``,
``dlrover_reshard_bytes_total{locality}`` and
``dlrover_reshard_aborts_total{reason}``; a corrupt frame reports
``ckpt_corrupt``, its repair ``ckpt_repaired``. Not ported (ROADMAP): the
data-state sidecar and the manifest chain's delta writer.
"""

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from dlrover_tpu_torch.ckpt.ckpt_saver import (
    commit_step,
    latest_step,
    load_frames_for_step,
    merge_frame_leaves,
    persist_shm_frame,
)
from dlrover_tpu_torch.ckpt.shm_handler import (
    SharedMemoryHandler,
    frame_shard_bytes,
    parse_frame,
    shm_name,
    verify_frame_blob,
    verify_parsed_frame,
)
from dlrover_tpu_torch.common import state_fence
from dlrover_tpu_torch.common.constants import (
    ConfigKey,
    EnvKey,
    SharedResourceName,
    SpanName,
    env_flag,
    env_float,
    env_int,
    env_str,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.multi_process import (
    SharedDict,
    SharedLock,
    SharedQueue,
)
from dlrover_tpu_torch.convert import map_named, named_leaves
from dlrover_tpu_torch.observability import tracing
from dlrover_tpu_torch.observability.journal import JournalEvent
from dlrover_tpu_torch.observability.registry import get_registry
from dlrover_tpu_torch.parallel import sharding

# frame dtype name → (numpy storage dtype, torch dtype); bf16 travels as its
# 16-bit patterns (numpy has no bfloat16)
_DTYPES = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float16": (np.float16, torch.float16),
    "float32": (np.float32, torch.float32),
    "float64": (np.float64, torch.float64),
    "int8": (np.int8, torch.int8),
    "uint8": (np.uint8, torch.uint8),
    "int16": (np.int16, torch.int16),
    "int32": (np.int32, torch.int32),
    "int64": (np.int64, torch.int64),
    "bool": (np.bool_, torch.bool),
}
_RESTORE_THREADS = 8
# the pinned staging ring: SLOTS slots of SLOT_BYTES each
STAGING_SLOTS = 4
STAGING_SLOT_BYTES = 256 << 20


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class CheckpointEvent:
    SAVE = "save"

    @staticmethod
    def save(step: int, path: str) -> Dict:
        return {"type": CheckpointEvent.SAVE, "step": step, "path": path}


class _StagedCopies:
    """Device shards streamed to the host through a ring of pinned slots.

    ``buffers()`` are the frame writer's inputs, one per shard, each
    yielding numpy views of a slot in order. A slot is refilled (on the
    side stream) only once the writer has consumed what it held, so at
    most ``len(slots)`` copies are in flight. ``copied`` is set once the
    last device-to-host copy has landed, or the stream has failed."""

    def __init__(self, sources: List[torch.Tensor], slots, stream, after):
        self._sources = sources
        self._slots = slots
        self._stream = stream
        self._after = after  # event on the training stream at save time
        size = slots[0].numel()
        self._chunks = [(i, lo, min(lo + size, s.numel()))
                        for i, s in enumerate(sources)
                        for lo in range(0, s.numel(), size)]
        self._events: Dict[int, torch.cuda.Event] = {}
        self._issued = 0
        self._consumed = 0
        self.copied = threading.Event()
        if not self._chunks:
            self.copied.set()

    def _issue_until(self, end: int) -> None:
        with torch.cuda.stream(self._stream):
            if self._issued == 0:
                self._stream.wait_event(self._after)
            while self._issued < min(end, len(self._chunks)):
                c = self._issued
                i, lo, hi = self._chunks[c]
                slot = self._slots[c % len(self._slots)]
                slot[:hi - lo].copy_(self._sources[i][lo:hi],
                                     non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self._stream)
                self._events[c] = ev
                self._issued += 1

    def _chunks_of(self, i: int):
        while (self._consumed < len(self._chunks)
               and self._chunks[self._consumed][0] == i):
            c = self._consumed
            self._issue_until(c + len(self._slots))
            self._events.pop(c).synchronize()
            _, lo, hi = self._chunks[c]
            if c == len(self._chunks) - 1:
                self.copied.set()
            yield self._slots[c % len(self._slots)][:hi - lo].numpy()
            self._consumed += 1

    def buffers(self):
        class _Buffer:
            def __init__(s, i):
                s.nbytes = self._sources[i].numel()
                s.chunks = lambda: self._chunks_of(i)

        return [_Buffer(i) for i in range(len(self._sources))]

    def abandon(self) -> None:
        """After a failure: let in-flight copies land, release waiters."""
        self._stream.synchronize()
        self.copied.set()


class _StagedRestore:
    """Saved shards streamed to the card through the pinned ring: a slot is
    filled from the frame (pread from shm, or a copy out of a storage
    blob) and copied to its target on the side stream; a slot is refilled
    once its copy has landed."""

    def __init__(self, slots, stream):
        self._slots = slots
        self._stream = stream

    def run(self, jobs) -> int:
        """``jobs``: ``(target bytes on the card, saved shard meta)``."""
        slots, size = self._slots, self._slots[0].numel()
        events: List[Optional[torch.cuda.Event]] = [None] * len(slots)
        k = total = 0
        with torch.cuda.stream(self._stream):
            for dst, shard in jobs:
                for lo in range(0, shard["nbytes"], size):
                    hi = min(lo + size, shard["nbytes"])
                    i = k % len(slots)
                    if events[i] is not None:
                        events[i].synchronize()
                    _read_range_into(shard, lo, slots[i][:hi - lo].numpy())
                    dst[lo:hi].copy_(slots[i][:hi - lo], non_blocking=True)
                    events[i] = torch.cuda.Event()
                    events[i].record(self._stream)
                    k += 1
                total += shard["nbytes"]
        self._stream.synchronize()
        return total


def _read_range_into(shard_meta, lo, out) -> None:
    frame = shard_meta["_frame"]
    handler = frame.get("_handler")
    if handler is not None:
        if not handler.read_range_into(shard_meta, lo, out):
            raise ValueError(f"shm read of shard {shard_meta['offset']} "
                             "failed")
        return
    src = frame_shard_bytes(frame, shard_meta)[lo:lo + out.nbytes]
    np.copyto(out, np.frombuffer(src, dtype=np.uint8))


class CheckpointEngine:
    """One engine per worker process.

    ``saving_ranks`` is the saver group, the ranks that call save: every
    rank (the default; each owns shards) or one rank that owns a
    replicated state (the reference's single-writer pattern); a step is
    complete with one frame per saver. ``replica_manager`` replaces the
    one the environment would give (``--ckpt-replica``)."""

    def __init__(
        self,
        ckpt_dir: str,
        job_name: Optional[str] = None,
        node_rank: Optional[int] = None,
        local_rank: Optional[int] = None,
        ipc_socket: Optional[str] = None,
        master_client=None,
        world_size: Optional[int] = None,
        rank: Optional[int] = None,
        local_world_size: Optional[int] = None,
        saving_ranks: Optional[List[int]] = None,
        replica_manager=None,
    ):
        self.ckpt_dir = ckpt_dir
        self.job_name = job_name or env_str(EnvKey.JOB_NAME, "local")
        self.node_rank = (node_rank if node_rank is not None
                          else env_int(EnvKey.NODE_RANK, 0))
        self.local_rank = (local_rank if local_rank is not None
                           else env_int(EnvKey.LOCAL_RANK, 0))
        self.rank = rank if rank is not None else env_int(EnvKey.RANK, 0)
        self.world_size = (world_size if world_size is not None
                           else env_int(EnvKey.WORLD_SIZE, 1))
        self.local_world_size = (
            local_world_size if local_world_size is not None
            else env_int(EnvKey.LOCAL_WORLD_SIZE, 1))
        self.saving_ranks = (sorted(saving_ranks) if saving_ranks is not None
                             else list(range(self.world_size)))
        if not (len(self.saving_ranks) == 1
                or self.saving_ranks == list(range(self.world_size))):
            raise ValueError(f"saving_ranks {self.saving_ranks}: one rank "
                             f"or all {self.world_size}")
        self._shm = SharedMemoryHandler(
            shm_name(self.job_name, self.node_rank, self.local_rank))
        socket_path = ipc_socket or env_str(ConfigKey.IPC_SOCKET)
        self._has_agent = bool(socket_path) and os.path.exists(socket_path)
        if self._has_agent:
            # one lock per frame, shared with the agent's saver so a
            # persist never races a rewrite
            self._save_lock = SharedLock(self._shm.name + ".lock",
                                         socket_path)
            self._event_queue = SharedQueue(
                SharedResourceName.SAVE_EVENT_QUEUE, socket_path)
            self._meta_dict = SharedDict(SharedResourceName.SHM_META_DICT,
                                         socket_path)
        else:
            self._save_lock = None
            self._event_queue = None
            self._meta_dict = None
        self._master = master_client
        self._replicas = (replica_manager if replica_manager is not None
                          else self._replica_manager_from_env())
        reg = get_registry()
        self._reshard_hist = reg.histogram(
            "dlrover_reshard_seconds",
            "End-to-end live-reshard restore latency")
        self._reshard_bytes = reg.counter(
            "dlrover_reshard_bytes_total",
            "Bytes moved by live reshard, by locality",
            labelnames=("locality",))
        self._reshard_aborts = reg.counter(
            "dlrover_reshard_aborts_total",
            "Live-reshard attempts that fell to the next rung, by reason",
            labelnames=("reason",))
        self._latest_step = -1
        self._drain_thread: Optional[threading.Thread] = None
        self._drain_ok = False
        self._slots: Optional[List[torch.Tensor]] = None
        self._stream = None
        # what the last save and the last restore did, for the caller
        self.last_save: Dict[str, Any] = {}
        self.last_restore: Dict[str, Any] = {}
        self._last_reshard: Dict[str, Any] = {}
        # the frames fetched from the replica stores in one load, each once
        self._fetched: Dict[Tuple[int, int, int], Any] = {}

    def _replica_manager_from_env(self):
        """The push side, under an agent with ``--ckpt-replica N`` (N > 1):
        the stores' addresses come from the master KV."""
        group = env_int(EnvKey.REPLICA_GROUP, 0)
        if group <= 1 or self._master is None:
            return None
        from dlrover_tpu_torch.ckpt.replica import ReplicaManager

        return ReplicaManager(self.job_name, self.node_rank,
                              env_int(EnvKey.NODE_NUM, 1), self._master,
                              group_size=group, reporter=self._report_event)

    @property
    def replicas(self):
        """The replica manager, or None without replicas."""
        return self._replicas

    def _report_event(self, kind: str, data: Optional[Dict] = None) -> None:
        """An event for the master's journal; best-effort."""
        report = getattr(self._master, "report_event", None)
        if report is not None:
            try:
                report(kind, data or {})
            except Exception:  # noqa: BLE001 — telemetry never fails a load
                logger.debug("journal report %r failed", kind, exc_info=True)

    # -- collectives ---------------------------------------------------------

    def _host_group(self):
        if self.world_size <= 1 or not dist.is_initialized():
            return None
        from dlrover_tpu_torch.worker import host_group

        return host_group() or dist.group.WORLD

    def _agree(self, value: int, op) -> int:
        """``value`` reduced with ``op`` over every rank (itself when
        alone)."""
        group = self._host_group()
        if group is None:
            return value
        t = torch.tensor([value], dtype=torch.int64)
        dist.all_reduce(t, op=op, group=group)
        return int(t.item())

    def _all_ranks_ready(self, local_ready: bool) -> bool:
        """Readiness agreed within the saver group."""
        if len(self.saving_ranks) == 1:
            return local_ready
        return bool(self._agree(int(local_ready), dist.ReduceOp.MIN))

    # -- save ----------------------------------------------------------------

    def save_to_memory(self, step: int, state, blocking: bool = False,
                       _on_drained: Optional[Callable[[], None]] = None,
                       _wait_busy_s: float = 0.0) -> bool:
        """Snapshot ``state`` into shm. Returns False when skipped (a
        previous snapshot still draining, the agent persisting, or any peer
        rank in either state): saves skip rather than block. The training
        pause is the planning pass; ``blocking=True`` drains inline."""
        with tracing.span(SpanName.CKPT_SAVE_MEMORY,
                          source=f"worker_{self.rank}", step=step,
                          blocking=blocking) as sp:
            ok = self._save_to_memory(step, state, blocking, _on_drained,
                                      _wait_busy_s)
            sp.add_event("result", saved=ok)
            return ok

    def _save_to_memory(self, step, state, blocking, _on_drained,
                        _wait_busy_s) -> bool:
        local_ready, acquired, why = True, False, ""
        if self._drain_thread is not None and self._drain_thread.is_alive():
            if _wait_busy_s > 0:
                self.wait_drained(_wait_busy_s)
            if self._drain_thread.is_alive():
                local_ready, why = False, "previous snapshot draining"
        if local_ready and self._save_lock is not None:
            acquired = self._save_lock.acquire(blocking=False)
            if not acquired:
                local_ready, why = False, "agent persisting previous"
        try:
            ready = self._all_ranks_ready(local_ready)
        except Exception:
            if acquired:
                self._save_lock.release()
            raise
        if not ready:
            if acquired:
                self._save_lock.release()
            logger.info("step %s: skip save, %s", step,
                        why or "a peer rank is busy")
            return False
        t0 = time.perf_counter()
        try:
            meta, buffers, staged = self._plan_state(step, state)
            if self._meta_dict is not None:
                # register the frame before the drain: a breakpoint save
                # must find it even if this worker dies mid-drain
                self._meta_dict.set(
                    f"{self.node_rank}:{self.local_rank}",
                    {"shm": self._shm.name, "ts": time.time(),
                     "persisted": False})
        except Exception:
            if self._save_lock is not None:
                self._save_lock.release()
            raise
        nbytes = sum(int(b.nbytes) for b in buffers)
        self.last_save = {"step": step, "pause_s": time.perf_counter() - t0,
                          "bytes": nbytes}

        # the drain thread continues the save's arc
        drain_parent = tracing.current_context()

        def _drain():
            try:
                with tracing.activate(drain_parent), tracing.span(
                        SpanName.CKPT_DRAIN, source=f"worker_{self.rank}",
                        step=step):
                    self._drain_frame(step, meta, buffers, _on_drained)
            except Exception:  # noqa: BLE001 — a lost snapshot must be LOUD
                self._drain_ok = False
                logger.error("checkpoint drain for step %s failed — "
                             "snapshot lost, previous frame (step %s) "
                             "still intact", step, self._latest_step,
                             exc_info=True)
                if blocking:
                    raise
            finally:
                if staged is not None:
                    staged.abandon()
                if self._save_lock is not None:
                    self._save_lock.release()

        self._drain_ok = False
        if blocking:
            _drain()
        else:
            self._drain_thread = threading.Thread(
                target=_drain, name="ckpt-drain", daemon=True)
            self._drain_thread.start()
        return True

    def _staging(self, device: torch.device):
        if self._slots is None:
            self._slots = [torch.empty(STAGING_SLOT_BYTES, dtype=torch.uint8,
                                       pin_memory=True)
                           for _ in range(STAGING_SLOTS)]
            self._stream = torch.cuda.Stream(device=device)
        return self._slots, self._stream

    def _owned_shard(self, leaf) -> Tuple[bool, torch.Tensor, List[int]]:
        """(saved here?, the local tensor, its global start)."""
        if isinstance(leaf, DTensor):
            mesh = leaf.device_mesh
            sizes = sharding.mesh_sizes(mesh)
            coords = sharding.mesh_coords(mesh)
            spec = sharding.dtensor_spec(leaf)
            start, _ = sharding.region_for(leaf.shape, spec, sizes, coords)
            owner = all(coords[a] == 0
                        for a in sharding.replica_axes(spec, sizes))
            return owner, leaf.to_local(), list(start)
        return self.rank == self.saving_ranks[0], leaf, [0] * leaf.ndim

    def _plan_state(self, step: int, state):
        """Frame meta and the writer's buffers for every owned shard. CUDA
        shards stream through the staging ring (returned, to release its
        waiters on failure); CPU shards are copied here."""
        leaves_meta: List[Dict] = []
        offset = 0
        device_sources: List[torch.Tensor] = []
        host_buffers: List[np.ndarray] = []
        device = None
        for path, leaf in named_leaves(state):
            if isinstance(leaf, np.ndarray):
                leaf = torch.from_numpy(leaf)
            if not isinstance(leaf, torch.Tensor):
                if isinstance(leaf, np.generic):
                    leaf = leaf.item()
                leaves_meta.append({"path": path, "kind": "value",
                                    "value": leaf})
                continue
            owner, local, start = self._owned_shard(leaf)
            shards = []
            if owner:
                flat = local.detach().contiguous().reshape(-1).view(
                    torch.uint8)
                nbytes = int(flat.numel())
                shards.append({"offset": offset, "nbytes": nbytes,
                               "lshape": list(local.shape), "start": start})
                offset += nbytes
                if flat.is_cuda:
                    device = flat.device
                    device_sources.append(flat)
                else:
                    host_buffers.append(flat.clone().numpy())
            leaves_meta.append({"path": path, "kind": "array",
                                "dtype": dtype_name(leaf.dtype),
                                "gshape": list(leaf.shape),
                                "shards": shards})
        if device_sources and host_buffers:
            raise ValueError("a state must live on one device type")
        meta = {
            "step": step, "ts": time.time(), "job": self.job_name,
            "node_rank": self.node_rank, "local_rank": self.local_rank,
            "rank": self.rank, "world_size": self.world_size,
            "expected_frames": len(self.saving_ranks),
            "leaves": leaves_meta,
        }
        if not device_sources:
            return meta, host_buffers, None
        slots, stream = self._staging(device)
        after = torch.cuda.Event()
        after.record(torch.cuda.current_stream(device))
        staged = _StagedCopies(device_sources, slots, stream, after)

        def wait_copied():
            staged.copied.wait()

        state_fence.add_reader(wait_copied)
        return meta, staged.buffers(), staged

    def _drain_frame(self, step, meta, buffers, _on_drained) -> None:
        t0 = time.perf_counter()
        self._shm.write_frame(meta, buffers)
        drain_s = time.perf_counter() - t0
        self.last_save["drain_s"] = drain_s
        self._latest_step = step
        self._drain_ok = True
        if self._replicas is not None:
            # this node's store copies the sealed frame and forwards it to
            # the peers while this thread waits, holding the save lock:
            # training goes on, and its saves skip until the copy is done
            self._replicas.backup_async(self._shm, self.local_rank)
        if self._meta_dict is not None:
            self._meta_dict.set(
                f"{self.node_rank}:{self.local_rank}",
                {"shm": self._shm.name, "step": step, "ts": time.time(),
                 "persisted": False})
        if self._master is not None:
            try:
                self._master.kv_set(
                    f"ckpt/{self.job_name}/shm_step/{self.rank}",
                    str(step).encode())
            except ConnectionError:
                pass
        if _on_drained is not None:
            _on_drained()

    def wait_drained(self, timeout_s: Optional[float] = None) -> bool:
        """Block until the in-flight snapshot lands; False on timeout or
        when the drain failed."""
        t = self._drain_thread
        if t is not None:
            t.join(timeout_s)
            if t.is_alive():
                return False
        return self._drain_ok or self._drain_thread is None

    def save_to_storage(self, step: int, state, path: str = "") -> bool:
        """Memory save, then persist: the agent's saver does it when there
        is an agent (the request rides the drain), else this worker does,
        inline, and rank 0 moves the tracker once every rank has written
        its link. A busy drain is waited out (bounded), not skipped."""
        path = path or self.ckpt_dir
        alone = self._host_group() is None or len(self.saving_ranks) == 1
        with tracing.span(SpanName.CKPT_PERSIST_REQUEST,
                          source=f"worker_{self.rank}", step=step):
            # the request crosses the agent's SharedQueue: the context
            # rides the event, so the saver's spans join this trace
            carry = tracing.inject_wire()

            def _request_persist():
                if self._event_queue is not None:
                    event = CheckpointEvent.save(step, path)
                    if carry is not None:
                        event[tracing.WIRE_KEY] = carry
                    self._event_queue.put(event)
                else:
                    persist_shm_frame(self._shm, path, step, commit=alone)

            t0 = time.perf_counter()
            ok = self.save_to_memory(
                step, state, blocking=not self._has_agent,
                _on_drained=_request_persist,
                _wait_busy_s=env_float(ConfigKey.CKPT_STORAGE_WAIT, 60.0))
        if ok and not self._has_agent and not alone:
            dist.barrier(group=self._host_group())
            if self.rank == 0:
                commit_step(path, step)
            dist.barrier(group=self._host_group())
        if ok:
            self.last_save["storage_s"] = time.perf_counter() - t0
        return ok

    # -- load ----------------------------------------------------------------

    def shm_step(self) -> int:
        return self._shm.step

    def _agree_step(self, step: int) -> Optional[int]:
        """``step`` when every rank holds the same one (>= 0), else None
        (a rank whose frame is empty, torn or corrupt, or whose rung
        failed, holds -1)."""
        lo = self._agree(step, dist.ReduceOp.MIN)
        hi = self._agree(step, dist.ReduceOp.MAX)
        return lo if lo == hi and lo >= 0 else None

    def _verify_shm_or_repair(self) -> int:
        """The local shm step when its frame is intact, or repaired from a
        replica store's copy of the same step; -1 when it is corrupt for
        good (so every rank leaves shm together)."""
        step = self.shm_step()
        if step < 0:
            return step
        corrupt = self._shm.verify_frame()
        if not corrupt:
            return step
        logger.error("checkpoint integrity: shm frame %s (step %s) has "
                     "corrupt shard(s) %s", self._shm.name, step, corrupt)
        self._report_event(JournalEvent.CKPT_CORRUPT, {
            "medium": "shm", "step": step, "shards": corrupt})
        if self._replicas is not None and self._stored_own_step() == step:
            got = self._write_own_frame(step)
            if got == step and not self._shm.verify_frame():
                logger.info("corrupt shard(s) %s repaired from a replica "
                            "store (step %s)", corrupt, got)
                self._report_event(JournalEvent.CKPT_REPAIRED, {
                    "step": got, "shards": corrupt})
                return got
        logger.error("shm frame unrepairable — left out of the restore")
        return -1

    def load(self, target, path: str = "") -> Tuple[Any, int]:
        """Restore into ``target`` (the state as built for this world:
        DTensors, tensors and plain values), in place, from the first rung
        of the ladder (module docstring) every rank can take. Returns
        ``(state, step)``; step is -1 when nothing was restored. Every
        rank must call it."""
        with tracing.span(SpanName.CKPT_RESTORE,
                          source=f"worker_{self.rank}") as sp:
            state, step = self._load(target, path)
            sp.attrs.update(step=step,
                            medium=self.last_restore.get("medium"))
            return state, step

    def _load(self, target, path: str) -> Tuple[Any, int]:
        # the drain's push ends with it: none races the write-back
        self.wait_drained()
        t0 = time.perf_counter()
        path = path or self.ckpt_dir
        # storage's tracked step, the newest any rank read (its frames are
        # whole once the tracker names it)
        floor = self._agree(latest_step(path) if path else -1,
                            dist.ReduceOp.MAX)
        self._fetched = {}
        try:
            got = self._load_via_reshard(target)
            written_back = -1
            if got is None:
                written_back = self._write_back_own_frame()
                got = self._load_from_shm(target)
            if got is None:
                got = self._load_from_peer_frames(target,
                                                  lambda s: s > floor)
            if got is None:
                got = self._load_from_storage(target, path, floor)
            if got is None:
                got = self._load_from_peer_frames(target,
                                                  lambda s: s <= floor)
        finally:
            self._fetched = {}
        if got is None:
            self.last_restore = {"medium": None, "step": -1}
            return target, -1
        state, step, medium, nbytes = got
        self.last_restore = {"medium": medium, "step": step, "bytes": nbytes,
                             "seconds": time.perf_counter() - t0}
        if medium == "shm" and written_back == step:
            self.last_restore["written_back"] = "replica"
        if medium == "reshard":
            self.last_restore["reshard"] = self._last_reshard
        logger.info("restored step %s from %s%s", step, medium,
                    " (written back from a replica store)"
                    if self.last_restore.get("written_back") else "")
        return state, step

    def _load_via_reshard(self, target):
        """Rung 1: (state, step, "reshard", bytes) when the master
        published a cut record for this round and every rank restored
        the same step from the survivors' frames; None on every rank
        otherwise. An abort is journaled with its reason (``peer_aborted``
        on a rank whose own attempt succeeded)."""
        if self._master is None or not env_flag(ConfigKey.RESHARD, True):
            return None
        from dlrover_tpu_torch.ckpt import reshard

        restorer = reshard.ReshardRestorer(
            self.job_name, self._master, self.node_rank,
            local_rank=self.local_rank, rank=self.rank, own_shm=self._shm,
            reporter=self._report_event)
        try:
            cut = restorer.read_cut()
        except (ConnectionError, RuntimeError, ValueError) as e:
            logger.info("reshard cut lookup failed: %r", e)
            cut = None
        got, reason, detail = None, None, ""
        if cut is not None:
            self._report_event(JournalEvent.RESHARD_START, {
                "round": cut.get("round"), "old_world": cut.get("old"),
                "new_world": cut.get("new")})
            stager = self._stager(target)
            try:
                got = restorer.restore(
                    target,
                    lambda t, lookup: _assemble(t, lookup, _blob_reader,
                                                stager), cut)
            except reshard.ReshardAbort as e:
                reason, detail = e.reason, str(e)
        step = self._agree_step(got[1] if got is not None else -1)
        if cut is None:
            return None
        if step is None:
            if reason is None:
                reason, detail = "peer_aborted", "another rank's reshard " \
                    "failed or chose another step"
            logger.warning("live reshard aborted (%s: %s) — falling to the "
                           "next restore rung", reason, detail)
            self._reshard_aborts.labels(reason=reason).inc()
            self._report_event(JournalEvent.RESHARD_ABORTED, {
                "reason": reason, "detail": detail,
                "round": cut.get("round")})
            return None
        (state, nbytes), _, stats = got
        self._reshard_hist.observe(stats["duration_s"])
        self._reshard_bytes.labels(locality="local").inc(
            stats.get("bytes_local", 0))
        self._reshard_bytes.labels(locality="remote").inc(
            stats.get("bytes_remote", 0))
        self._report_event(JournalEvent.RESHARD_COMPLETE, dict(stats))
        logger.info("live reshard complete: step %s, %s transfers, %s bytes "
                    "(%s remote) in %.3fs", step, stats.get("transfers"),
                    stats.get("bytes"), stats.get("bytes_remote"),
                    stats.get("duration_s", 0.0))
        self._last_reshard = dict(stats)
        return state, step, "reshard", nbytes

    def _write_back_own_frame(self) -> int:
        """Rung 2: this worker's frame from a replica store that holds a
        newer step than its segment, written into the segment; the step
        written, or -1."""
        if self._replicas is None:
            return -1
        before = self.shm_step()
        stored = self._stored_own_step()
        if stored <= before:
            return -1
        return self._write_own_frame(stored)

    def _fetch_frame(self, owner: int, local: int, step: int):
        """``(step, blob, corrupt shards)`` of an owner's frame of ``step``
        in the stores (None: none), fetched once a load."""
        key = (owner, local, step)
        if key not in self._fetched:
            try:
                held = self._replicas.fetch_frame(owner, local, step)
            except (ConnectionError, OSError, RuntimeError) as e:
                logger.info("replica fetch (owner=%s local=%s) failed: %r",
                            owner, local, e)
                held = None
            self._fetched[key] = (None if held is None else
                                  (held[0], held[1],
                                   verify_frame_blob(held[1])))
        return self._fetched[key]

    def _write_own_frame(self, step: int) -> int:
        """Write this worker's frame of ``step`` from the stores into its
        segment, when it is intact; the step written, or -1. This node's
        port store writes it itself; else the frame is fetched."""
        local = self._replicas.write_local(self._shm, step, self.local_rank)
        if local is not None:
            self._shm.close()  # map the segment as the store left it
            written, bad = local
            if written:
                logger.info("this worker's frame (step %s) written back by "
                            "this node's replica store", step)
                return step
            # a refused copy is not fetched again by the peer-frame rung
            held = (step, None, bad)
            self._fetched[(self.node_rank, self.local_rank, step)] = held
        else:
            held = self._fetch_frame(self.node_rank, self.local_rank, step)
        if held is None or held[0] != step:
            return -1
        if held[2]:
            logger.error("replica frame of node %s local %s (step %s) "
                         "fails its integrity check (%s) — not restored "
                         "from it", self.node_rank, self.local_rank, step,
                         held[2])
            return -1
        self._shm.write_raw(held[1])
        logger.info("wrote this worker's frame (step %s) back from a "
                    "replica store", step)
        return step

    def _stored_own_step(self) -> int:
        """The newest step of this worker's own frame the stores hold (-1:
        none), read before any frame moves."""
        try:
            entries = self._replicas.list_entries()
        except (ConnectionError, OSError, RuntimeError):
            return -1
        return max((s for o, lr, s in entries
                    if (o, lr) == (self.node_rank, self.local_rank)),
                   default=-1)

    def _load_from_shm(self, target):
        """(state, step, "shm", bytes) when every rank holds a sealed,
        intact frame of one step and its node's frames cover its regions;
        None on every rank otherwise (all ranks take part)."""
        step = self._agree_step(self._verify_shm_or_repair())
        frames = self._node_frames(step) if step is not None else []
        try:
            lookup = merge_frame_leaves(frames)
            covered = bool(frames) and self._covers(target, lookup)
            if not self._agree(int(covered), dist.ReduceOp.MIN):
                return None
            state, nbytes = _assemble(target, lookup, _shm_reader,
                                      self._stager(target))
            return state, step, "shm", nbytes
        finally:
            for frame in frames:
                if frame["_handler"] is not self._shm:
                    frame["_handler"].close()

    def _load_from_peer_frames(self, target, wanted: Callable[[int], bool]):
        """Rung 4: (state, step, "replica", bytes) from the frames of any
        owner the replica stores hold, at the newest ``wanted`` step whose
        intact frames cover this rank's regions, agreed by every rank (a
        rank that covered a newer step tries the agreed one); None on
        every rank otherwise. ``load`` asks first for the steps past
        storage's tracked one, and for that step and older ones only when
        storage fails."""
        if self._replicas is None:
            return None
        try:
            entries = [e for e in self._replicas.list_entries()
                       if wanted(int(e[2]))]
        except (ConnectionError, OSError, RuntimeError) as e:
            logger.info("replica peer-frame listing failed: %r", e)
            entries = []
        fetched: Dict[int, List[Dict]] = {}

        def frames_at(step: int) -> List[Dict]:
            if step not in fetched:
                fetched[step] = self._peer_frames_at(step, entries)
            return fetched[step]

        best = -1
        for step in sorted({int(e[2]) for e in entries}, reverse=True):
            if self._covers(target, merge_frame_leaves(frames_at(step))):
                best = step
                break
        lo = self._agree(best, dist.ReduceOp.MIN)
        if lo >= 0 and lo != self._agree(best, dist.ReduceOp.MAX):
            ok = self._covers(target, merge_frame_leaves(frames_at(lo)))
            lo = lo if self._agree(int(ok), dist.ReduceOp.MIN) else -1
        if lo < 0:
            return None
        state, nbytes = _assemble(target, merge_frame_leaves(frames_at(lo)),
                                  _blob_reader, self._stager(target))
        return state, lo, "replica", nbytes

    def _peer_frames_at(self, step: int, entries) -> List[Dict]:
        """The intact frames of ``step`` the stores hold, parsed."""
        frames = []
        owners = sorted({(int(o), int(lr)) for o, lr, s in entries
                         if int(s) == step})
        for owner, local in owners:
            held = self._fetch_frame(owner, local, step)
            if held is None or held[0] != step:
                continue
            bad = held[2]
            meta = None if bad else parse_frame(held[1])
            if bad or meta is None:
                self._report_event(JournalEvent.CKPT_CORRUPT, {
                    "medium": "replica", "step": step, "shards": bad})
                continue
            frames.append(meta)
        return frames

    def _load_from_storage(self, target, path: str, step: int):
        """(state, step, "storage", bytes) from storage's tracked ``step``,
        its corrupt frames left out; None on every rank when they do not
        cover every rank's state."""
        if step < 0:
            return None
        frames = []
        for frame in load_frames_for_step(path, step):
            bad = verify_parsed_frame(frame)
            if bad:
                logger.error("checkpoint integrity: storage frame step %s "
                             "has corrupt shard(s) %s — excluded", step, bad)
            else:
                frames.append(frame)
        lookup = merge_frame_leaves(frames)
        covered = bool(frames) and self._covers(target, lookup)
        if not self._agree(int(covered), dist.ReduceOp.MIN):
            return None
        state, nbytes = _assemble(target, lookup, _blob_reader,
                                  self._stager(target))
        return state, step, "storage", nbytes

    def _stager(self, target) -> Optional[_StagedRestore]:
        device = next((_local(x).device for _, x in named_leaves(target)
                       if isinstance(x, torch.Tensor) and x.is_cuda), None)
        if device is None:
            return None
        return _StagedRestore(*self._staging(device))

    def _node_frames(self, step: int) -> List[Dict]:
        """The sealed frames of ``step`` on this node: this worker's and
        its local peers' (a replicated leaf is saved by one of them)."""
        frames = []
        for lr in range(max(self.local_world_size, self.local_rank + 1)):
            handler = (self._shm if lr == self.local_rank else
                       SharedMemoryHandler(shm_name(self.job_name,
                                                    self.node_rank, lr)))
            meta = handler.read_meta()
            if meta is not None and int(meta["step"]) == step:
                meta["_handler"] = handler
                frames.append(meta)
        return frames

    def _covers(self, target, lookup) -> bool:
        try:
            _validate(target, lookup)
            return True
        except (KeyError, ValueError) as e:
            logger.info("checkpoint frames do not cover the state: %s", e)
            return False


def _shm_reader(shard_meta):
    return shard_meta["_frame"]["_handler"].read_shard_bytes(shard_meta)


def _blob_reader(shard_meta):
    return frame_shard_bytes(shard_meta["_frame"], shard_meta)


def _target_region(leaf) -> Tuple[torch.Tensor, Tuple, Tuple]:
    """(the tensor to fill, global start, shape) of a target leaf."""
    if isinstance(leaf, DTensor):
        mesh = leaf.device_mesh
        start, shape = sharding.region_for(
            leaf.shape, sharding.dtensor_spec(leaf),
            sharding.mesh_sizes(mesh), sharding.mesh_coords(mesh))
        return leaf.to_local(), start, shape
    return leaf, (0,) * leaf.ndim, tuple(leaf.shape)


def _validate(target, lookup) -> None:
    """Raise unless every tensor leaf of ``target`` has a saved leaf of the
    same global shape whose shards cover the region this rank needs —
    before a byte of the target is written."""
    for path, leaf in named_leaves(target):
        leaf_meta = lookup.get(path)
        if leaf_meta is None:
            raise KeyError(path)
        if isinstance(leaf, torch.Tensor) and leaf_meta["kind"] != "array":
            raise ValueError(f"{path}: saved as a value, target is a tensor")
        if leaf_meta["kind"] == "array" and leaf_meta["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: unknown dtype {leaf_meta['dtype']}")
        if leaf_meta["kind"] != "array" or not isinstance(leaf, torch.Tensor):
            continue
        if tuple(leaf_meta["gshape"]) != tuple(leaf.shape):
            raise ValueError(f"{path}: saved shape {leaf_meta['gshape']} != "
                             f"target {list(leaf.shape)}")
        _, start, shape = _target_region(leaf)
        want = int(np.prod(shape)) if shape else 1
        got = 0
        for s in leaf_meta["shards"]:
            vol = 1
            for w0, wn, s0, sn in zip(start, shape, s["start"], s["lshape"]):
                vol *= max(0, min(w0 + wn, s0 + sn) - max(w0, s0))
            got += vol
        if got < want:
            raise ValueError(f"checkpoint incomplete for {path}: shards "
                             f"cover {got}/{want} elements of its region")


def _read_region(leaf_meta, start, shape, reader) -> np.ndarray:
    """The global region ``(start, shape)`` of one saved leaf, cut from
    whichever saved shards cover it (one exact shard: no copy)."""
    np_dtype = _DTYPES[leaf_meta["dtype"]][0]
    start, shape = list(start), list(shape)
    saved = leaf_meta["shards"]
    for s in saved:
        if list(s["start"]) == start and list(s["lshape"]) == shape:
            arr = np.frombuffer(reader(s), dtype=np_dtype).reshape(shape)
            return arr if arr.flags.writeable else arr.copy()
    out = np.zeros(shape, dtype=np_dtype)
    for s in saved:
        lo = [max(a, b) for a, b in zip(start, s["start"])]
        hi = [min(a + da, b + db) for a, da, b, db in
              zip(start, shape, s["start"], s["lshape"])]
        if any(lo_ >= hi_ for lo_, hi_ in zip(lo, hi)):
            continue
        arr = np.frombuffer(reader(s), dtype=np_dtype).reshape(s["lshape"])
        src = tuple(slice(a - b, c - b) for a, c, b in zip(lo, hi, s["start"]))
        dst = tuple(slice(a - w, c - w) for a, c, w in zip(lo, hi, start))
        out[dst] = arr[src]
    return out


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _assemble(target, lookup, reader,
              stager: Optional[_StagedRestore] = None) -> Tuple[Any, int]:
    """Fill ``target``'s tensors in place from the saved leaves and take
    plain values from the frame (the caller validated coverage). A card
    tensor that one saved shard of its own dtype covers exactly streams
    through ``stager``; the rest is cut and cast on the host, on a thread
    pool. Returns (state, bytes restored)."""
    nbytes = [0]
    lock = threading.Lock()
    direct = []

    def fill(leaf_meta, leaf):
        dst, start, shape = _target_region(leaf)
        arr = _read_region(leaf_meta, start, shape, reader)
        src = torch.from_numpy(arr).view(_DTYPES[leaf_meta["dtype"]][1])
        with torch.no_grad():
            dst.copy_(src.to(dst.dtype))
        with lock:
            nbytes[0] += arr.nbytes

    with ThreadPoolExecutor(_RESTORE_THREADS,
                            thread_name_prefix="ckpt-restore") as pool:
        futures = []

        def put(path, leaf):
            leaf_meta = lookup[path]
            if isinstance(leaf, torch.Tensor):
                dst, start, shape = _target_region(leaf)
                exact = [s for s in leaf_meta["shards"]
                         if tuple(s["start"]) == tuple(start)
                         and tuple(s["lshape"]) == tuple(shape)]
                if (stager is not None and dst.is_cuda and exact
                        and dst.is_contiguous()
                        and leaf_meta["dtype"] == dtype_name(dst.dtype)):
                    direct.append((dst.view(-1).view(torch.uint8), exact[0]))
                else:
                    futures.append(pool.submit(fill, leaf_meta, leaf))
                return leaf
            if leaf_meta["kind"] == "value":
                return leaf_meta["value"]
            # a plain value the other engine saved as an array
            gshape = leaf_meta["gshape"]
            arr = _read_region(leaf_meta, [0] * len(gshape), gshape, reader)
            return arr.item() if arr.ndim == 0 else arr.copy()

        state = map_named(put, target)
        if direct:
            nbytes[0] += stager.run(direct)
        for f in futures:
            f.result()
    if any(isinstance(leaf, torch.Tensor) and leaf.is_cuda
           for _, leaf in named_leaves(state)):
        torch.cuda.synchronize()
    return state, nbytes[0]
