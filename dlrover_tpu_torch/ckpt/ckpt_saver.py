"""Checkpoint persistence: the agent's saver and the storage helpers.

The port's copy of ``dlrover_tpu/ckpt/ckpt_saver.py``.
:class:`AsyncCheckpointSaver` runs in the agent: it consumes the workers'
save events from the IPC queue, persists each matching shm frame to
storage under the frame's lock, writes a done marker per frame, and the
commit leader moves the tracker once the quorum of frames is done. When
workers die it makes the breakpoint save: every frame newer than what
storage holds. It never persists a frame that fails its CRCs: a torn
frame on disk would outlive every good copy. The free functions are the
worker's side (find, read and write persisted steps without an agent).
Either package's saver persists either package's frames. A save event
that carries a worker's trace context (``tc``) runs under it, so the
saver's ``ckpt.persist`` and ``ckpt.commit`` spans join the worker's
``ckpt.persist_request`` trace across the queue. Disk layout per
step::

    <ckpt_dir>/latest_step.txt                        # tracker
    <ckpt_dir>/step_00000042/frame_<node>_<local>.dlrover
    <ckpt_dir>/step_00000042/manifest_<node>_<local>.mf
"""

import os
import queue
import signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from dlrover_tpu_torch.ckpt import manifest
from dlrover_tpu_torch.ckpt.manifest import frame_file, step_dir  # noqa: F401
from dlrover_tpu_torch.ckpt.shm_handler import (
    SharedMemoryHandler,
    parse_frame,
)
from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.common.constants import (
    CheckpointConstant,
    SharedResourceName,
    SpanName,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.multi_process import SharedLock
from dlrover_tpu_torch.observability import tracing
from dlrover_tpu_torch.common.storage import (
    PosixDiskStorage,
    get_checkpoint_storage,
)


def latest_step(ckpt_dir: str,
                storage: Optional[PosixDiskStorage] = None) -> int:
    storage = storage or get_checkpoint_storage(ckpt_dir)
    content = storage.read(
        os.path.join(ckpt_dir, CheckpointConstant.TRACKER_FILE), "r")
    if not content:
        return -1
    try:
        return int(str(content).strip())
    except ValueError:
        return -1


def load_frames_for_step(ckpt_dir: str, step: int,
                         storage: Optional[PosixDiskStorage] = None
                         ) -> List[Dict]:
    """The frames of a committed step: through its manifest links when it
    has them (nothing when the chain fails verification), else the loose
    frame files of the pre-chain layout."""
    storage = storage or get_checkpoint_storage(ckpt_dir)
    if manifest.manifest_links(ckpt_dir, step, storage):
        try:
            return manifest.load_step_frames(ckpt_dir, step, storage)
        except manifest.ChainError as e:
            logger.error("manifest chain for step %s unusable (%s)", step,
                         e.reason)
            return []
    frames = []
    d = step_dir(ckpt_dir, step)
    for name in storage.listdir(d):
        if not name.endswith(CheckpointConstant.FRAME_SUFFIX):
            continue
        blob = storage.read(os.path.join(d, name))
        meta = parse_frame(blob) if blob is not None else None
        if meta is not None:
            frames.append(meta)
    return frames


def merge_frame_leaves(frames):
    """Frames' leaf metas merged into ``{path: meta with all shards}``;
    each shard entry carries its source frame under ``_frame``."""
    merged = {}
    for frame in frames:
        for leaf in frame["leaves"]:
            entry = merged.setdefault(
                leaf["path"],
                {**{k: v for k, v in leaf.items() if k != "shards"},
                 "shards": []})
            entry["shards"].extend(
                dict(sh, _frame=frame) for sh in leaf.get("shards", []))
    return merged


def commit_step(ckpt_dir: str, step: int,
                storage: Optional[PosixDiskStorage] = None) -> None:
    """Point the tracker at ``step`` (atomically)."""
    storage = storage or get_checkpoint_storage(ckpt_dir)
    manifest.commit_file(
        storage, str(step),
        os.path.join(ckpt_dir, CheckpointConstant.TRACKER_FILE))


def persist_shm_frame(shm: SharedMemoryHandler, ckpt_dir: str, step: int,
                      storage: Optional[PosixDiskStorage] = None,
                      commit: bool = True) -> bool:
    """Persist one shm frame as a base link (the agent-less path, same
    format as the agent's saver); ``commit`` points the tracker at it."""
    storage = storage or get_checkpoint_storage(ckpt_dir)
    meta = shm.read_meta()
    if meta is None or meta["step"] != step:
        return False
    blob = shm.frame_view()  # written straight from the mapping
    if blob is None:
        return False
    try:
        with ThreadPoolExecutor(manifest._IO_THREADS,
                                thread_name_prefix="ckpt-persist") as pool:
            manifest.persist_frame(storage, ckpt_dir, step, meta, blob,
                                   executor=pool)
    finally:
        blob.release()
    if commit:
        commit_step(ckpt_dir, step, storage)
    return True


class AsyncCheckpointSaver:
    """The agent-side daemon that persists the workers' shm frames.

    ``expected_frames`` is the number of frames a committed step holds
    across all hosts (the world's worker count, unless the frames' meta
    names a smaller saver group); the commit leader (the lowest node rank)
    commits once that many done markers exist."""

    def __init__(self, ckpt_dir: str = "",
                 storage: Optional[PosixDiskStorage] = None,
                 node_rank: int = 0, local_world_size: int = 1,
                 expected_frames: Optional[int] = None,
                 is_commit_leader: Optional[bool] = None):
        self.ckpt_dir = ckpt_dir
        self._storage = storage or get_checkpoint_storage(ckpt_dir)
        self._node_rank = node_rank
        self._local_world_size = local_world_size
        self._expected_frames = expected_frames or local_world_size
        self._is_commit_leader = (node_rank == 0 if is_commit_leader is None
                                  else is_commit_leader)
        self._ipc_server = None
        self._stopped = threading.Event()
        self._consumer: Optional[threading.Thread] = None
        self._executor = ThreadPoolExecutor(
            max_workers=get_context().ckpt_save_workers,
            thread_name_prefix="ckpt-persist")
        # shm frame name -> last step committed to storage; guarded by
        # _lock (the consumer and the breakpoint-commit threads meet here)
        self._persisted_steps: Dict[str, int] = {}
        self._lock = threading.Lock()
        # serializes the tracker's check and move across commit threads
        self._commit_lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------

    def update_world(self, node_rank: int, expected_frames: int,
                     is_commit_leader: bool) -> None:
        """After every rendezvous: the quorum belongs to the world."""
        self._node_rank = node_rank
        self._expected_frames = max(1, expected_frames)
        self._is_commit_leader = is_commit_leader
        logger.info("ckpt saver world update: node_rank=%s "
                    "expected_frames=%s commit_leader=%s", node_rank,
                    expected_frames, is_commit_leader)

    def start(self, ipc_server) -> None:
        self._ipc_server = ipc_server
        self._consumer = threading.Thread(target=self._consume_events,
                                          name="ckpt-saver", daemon=True)
        self._consumer.start()

    def stop(self) -> None:
        self._stopped.set()
        self._executor.shutdown(wait=False)

    def install_signal_handlers(self) -> None:
        """Persist shm on SIGTERM before dying (main thread only)."""
        prev_term = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            logger.info("SIGTERM: persisting in-memory checkpoints")
            try:
                self.save_shm_to_storage(reason="sigterm")
            finally:
                if callable(prev_term):
                    prev_term(signum, frame)
                else:
                    raise SystemExit(143)

        signal.signal(signal.SIGTERM, _on_term)

    # -- the event loop ------------------------------------------------------

    def _consume_events(self) -> None:
        q = self._ipc_server.local_queue(SharedResourceName.SAVE_EVENT_QUEUE)
        while not self._stopped.is_set():
            try:
                event = q.get(timeout=0.5)
            except queue.Empty:
                continue
            try:
                self._handle_save_event(event)
            except Exception:  # noqa: BLE001
                logger.exception("checkpoint persist failed: %s", event)

    def _local_shm_handlers(self) -> List[SharedMemoryHandler]:
        """The worker frames registered in the meta dict."""
        if self._ipc_server is None:
            return []
        meta = self._ipc_server.local_dict(SharedResourceName.SHM_META_DICT)
        return [SharedMemoryHandler(info["shm"])
                for info in dict(meta).values()]

    def _handle_save_event(self, event: Dict) -> None:
        path = event.get("path") or self.ckpt_dir
        if not path:
            logger.warning("save event without a checkpoint dir — dropped")
            return
        # the worker's trace context, stamped on the event by its engine
        with tracing.activate(
                tracing.extract_wire(event.get(tracing.WIRE_KEY))):
            self.save_step_checkpoint(event["step"], path)

    def save_step_checkpoint(self, step: int, path: str) -> None:
        """Persist every local frame of ``step``, then commit. The saver
        holds all the frames' locks until the last one is written, each
        straight from its mapping: a frame whose lock came free while an
        earlier one was being written would be overwritten by its worker's
        next save. Each local worker sends the same event; a frame already
        persisted at ``step`` in this incarnation is not written twice."""
        with self._lock:
            handlers = [shm for shm in self._local_shm_handlers()
                        if self._persisted_steps.get(shm.name) != step]
        if not handlers:
            return
        with tracing.span(SpanName.CKPT_PERSIST,
                          source=f"saver_{self._node_rank}", step=step) as sp:
            persisted = self._persist_frames(
                handlers, path, step, CheckpointConstant.SAVE_TIMEOUT_S)
            sp.add_event("persisted", frames=len(persisted),
                         handlers=len(handlers))
            if not persisted:
                logger.warning("no shm frame matched step %s — nothing "
                               "persisted", step)
                return
            # done markers only for frames that landed: a skipped frame
            # holds the quorum open
            self._write_done_files(path, step, persisted)
            if self._is_commit_leader:
                meta = persisted[0].read_meta() or {}
                with tracing.span(SpanName.CKPT_COMMIT,
                                  source=f"saver_{self._node_rank}",
                                  step=step):
                    self.commit_checkpoint(
                        path, step,
                        expected_frames=meta.get("expected_frames"))

    def forget_persisted(self) -> None:
        """A new incarnation starts a new lineage: it may restore an older
        step than this saver persisted, and its saves of the steps after
        that one must not be taken for the old ones."""
        with self._lock:
            self._persisted_steps.clear()

    def _frame_lock(self, shm: SharedMemoryHandler) -> Optional[SharedLock]:
        """The lock a worker writes its frame under."""
        if self._ipc_server is None:
            return None
        return SharedLock(shm.name + ".lock", self._ipc_server.path)

    def _persist_frames(self, handlers: List[SharedMemoryHandler], path: str,
                        step: int, lock_timeout: float
                        ) -> List[SharedMemoryHandler]:
        """The frames sealed at ``step`` whose shards pass their CRCs,
        written to storage while the saver holds every frame's lock."""
        held = []
        try:
            for shm in handlers:
                lock = self._frame_lock(shm)
                if lock is not None and not lock.acquire(timeout=lock_timeout):
                    logger.warning("could not take the frame lock of %s in "
                                   "%.0fs — skipped to avoid a torn read",
                                   shm.name, lock_timeout)
                    continue
                held.append((shm, lock))
            return [shm for shm, _ in held
                    if self._persist_locked(shm, path, step)]
        finally:
            for _, lock in held:
                if lock is not None:
                    lock.release()

    def _persist_locked(self, shm: SharedMemoryHandler, path: str,
                        step: int) -> bool:
        meta = shm.read_meta()
        if meta is None or meta["step"] != step:
            return False
        bad = shm.verify_frame()
        if bad:
            logger.error("refusing to persist %s step %s: corrupt "
                         "shard(s) %s", shm.name, step, bad)
            return False
        blob = shm.frame_view()
        if blob is None:
            return False
        try:
            manifest.persist_frame(self._storage, path, step, meta, blob,
                                   executor=self._executor)
        except Exception:  # noqa: BLE001 — no done marker: quorum stays open
            logger.exception("persist of %s for step %s failed", shm.name,
                             step)
            return False
        finally:
            blob.release()
        with self._lock:
            self._persisted_steps[shm.name] = step
        return True

    def _write_done_files(self, path: str, step: int,
                          handlers: List[SharedMemoryHandler]) -> None:
        done_dir = os.path.join(step_dir(path, step),
                                CheckpointConstant.DONE_DIR)
        self._storage.safe_makedirs(done_dir)
        for shm in handlers:
            meta = shm.read_meta()
            if meta is None:
                continue
            self._storage.write("1", os.path.join(
                done_dir, f"done_{meta['node_rank']}_{meta['local_rank']}"))

    def commit_checkpoint(self, path: str, step: int,
                          timeout_s: Optional[float] = None,
                          expected_frames: Optional[int] = None) -> bool:
        """Wait for the expected done markers, then move the tracker
        (never backwards)."""
        timeout_s = timeout_s or CheckpointConstant.SAVE_TIMEOUT_S
        expected = expected_frames or self._expected_frames
        done_dir = os.path.join(step_dir(path, step),
                                CheckpointConstant.DONE_DIR)
        poll = get_context().ckpt_commit_poll_s
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            count = len([f for f in self._storage.listdir(done_dir)
                         if f.startswith("done_")])
            if count >= expected:
                with self._commit_lock:
                    if latest_step(path, self._storage) >= step:
                        logger.info("checkpoint step %s superseded — "
                                    "tracker kept", step)
                        return True
                    commit_step(path, step, self._storage)
                logger.info("checkpoint step %s committed (%s frames)",
                            step, count)
                return True
            if self._stopped.is_set():
                return False
            time.sleep(poll)
        logger.error("checkpoint step %s commit timed out", step)
        return False

    # -- breakpoint saves ------------------------------------------------------

    def save_shm_to_storage(self, reason: str = "",
                            workers_dead: bool = False,
                            async_commit: bool = False) -> int:
        """Persist every shm frame newer than storage: when workers fail,
        the membership changes or the agent is told to stop. Returns the
        number of frames persisted.

        ``workers_dead`` releases the frame locks first (a dead worker
        never releases its own). ``async_commit`` waits for the commit
        quorum on a background thread: a restart after a peer died must
        not block on a frame that is never coming."""
        if not self.ckpt_dir:
            return 0
        persisted = 0
        handlers = self._local_shm_handlers()
        steps = set()
        for shm in handlers:
            if workers_dead:
                lock = self._frame_lock(shm)
                if lock is not None:
                    lock.release()
            meta = shm.read_meta()
            if meta is None and not workers_dead:
                # the worker's drain may still be landing the frame
                lock = self._frame_lock(shm)
                if lock is not None and lock.acquire(timeout=10.0):
                    lock.release()
                    meta = shm.read_meta()
            if meta is None:
                continue
            step = meta["step"]
            with self._lock:
                already = self._persisted_steps.get(shm.name, -1)
            if step <= already:
                continue
            if self._persist_frames([shm], self.ckpt_dir, step, 10.0):
                persisted += 1
                steps.add(step)
        for step in steps:
            done = [h for h in handlers
                    if (m := h.read_meta()) is not None and m["step"] == step]
            self._write_done_files(self.ckpt_dir, step, done)
            # the full-world quorum still holds: a lone host's partial save
            # never becomes the restore point
            if self._is_commit_leader:
                if async_commit:
                    threading.Thread(
                        target=self.commit_checkpoint,
                        args=(self.ckpt_dir, step),
                        kwargs={"timeout_s": 30.0},
                        name=f"bp-commit-{step}", daemon=True).start()
                else:
                    self.commit_checkpoint(self.ckpt_dir, step,
                                           timeout_s=30.0)
        if persisted:
            logger.info("breakpoint save (%s): persisted %s frame(s) to %s",
                        reason, persisted, self.ckpt_dir)
        return persisted
