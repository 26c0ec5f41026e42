"""Storage helpers of the worker: find, read and write persisted steps.

The port's trim of ``dlrover_tpu/ckpt/ckpt_saver.py`` to its worker-side
functions. The agent's ``AsyncCheckpointSaver`` (shm → storage, commit,
breakpoint saves) stays the JAX package's: a port worker under the agent
hands it frames in the shared format. Disk layout per step::

    <ckpt_dir>/latest_step.txt                        # tracker
    <ckpt_dir>/step_00000042/frame_<node>_<local>.dlrover
    <ckpt_dir>/step_00000042/manifest_<node>_<local>.mf
"""

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from dlrover_tpu_torch.ckpt import manifest
from dlrover_tpu_torch.ckpt.manifest import frame_file, step_dir  # noqa: F401
from dlrover_tpu_torch.ckpt.shm_handler import (
    SharedMemoryHandler,
    parse_frame,
)
from dlrover_tpu_torch.common.constants import CheckpointConstant
from dlrover_tpu_torch.common.log import logger
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
