"""User-facing Flash Checkpoint API, the port's counterpart of
``dlrover_tpu/ckpt/checkpointer.py``::

    ckpt = Checkpointer("/mnt/ckpt")
    state, step = ckpt.load_checkpoint(state)   # resume if anything is there
    for step in range(step + 1, max_steps):
        state, _ = trainer.train_step(state, batch)
        ckpt.save_checkpoint(step, state, StorageType.MEMORY)
        if step % 250 == 0:
            ckpt.save_checkpoint(step, state, StorageType.DISK)

``saving_ranks=[0]`` makes rank 0 the only saver of a replicated state
(the other ranks skip ``save_checkpoint``).
"""

import time
from typing import Any, Tuple

from dlrover_tpu_torch.ckpt.ckpt_saver import latest_step
from dlrover_tpu_torch.ckpt.engine import CheckpointEngine
from dlrover_tpu_torch.common.constants import EnvKey, env_str
from dlrover_tpu_torch.common.log import logger


class StorageType:
    MEMORY = "memory"
    DISK = "disk"


class Checkpointer:
    def __init__(self, ckpt_dir: str, master_client=None, **engine_kwargs):
        if master_client is None and env_str(EnvKey.MASTER_ADDR):
            # workers launched by the agent have the master in env
            from dlrover_tpu_torch.agent.master_client import MasterClient

            master_client = MasterClient.singleton()
        self._engine = CheckpointEngine(ckpt_dir, master_client=master_client,
                                        **engine_kwargs)

    @property
    def engine(self) -> CheckpointEngine:
        return self._engine

    def save_checkpoint(self, step: int, state: Any,
                        storage_type: str = StorageType.MEMORY) -> bool:
        if storage_type == StorageType.MEMORY:
            return self._engine.save_to_memory(step, state)
        if storage_type == StorageType.DISK:
            return self._engine.save_to_storage(step, state)
        raise ValueError(f"unknown storage type {storage_type}")

    def load_checkpoint(self, target: Any) -> Tuple[Any, int]:
        """Restore into ``target``; returns (state, step), step -1 when no
        checkpoint exists (the caller keeps its init state)."""
        state, step = self._engine.load(target)
        if step < 0:
            return target, -1
        return state, step

    load = load_checkpoint

    def wait_latest_checkpoint(self, timeout_s: float = 60.0) -> None:
        """Block until storage tracks the newest saved step."""
        deadline = time.time() + timeout_s
        target_step = self._engine.shm_step()
        while time.time() < deadline:
            if latest_step(self._engine.ckpt_dir) >= target_step:
                return
            time.sleep(0.1)
        logger.warning("timed out waiting for checkpoint persistence")
