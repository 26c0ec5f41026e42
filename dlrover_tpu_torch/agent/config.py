"""The elastic launch configuration.

The port's copy of ``ElasticLaunchConfig`` from
``dlrover_tpu/agent/config.py``, trimmed to the fields the port's agent
reads. The network check, auto-tuning and the actor host are not
ported.
"""

import os
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class ElasticLaunchConfig:
    min_nodes: int = 1
    max_nodes: int = 1
    nproc_per_node: int = 1
    node_rank: int = 0
    node_id: int = 0
    job_name: str = "local"
    master_addr: str = ""
    rdzv_timeout_s: float = 600.0
    monitor_interval_s: float = 0.2
    max_restarts: int = 3
    # the world stays a multiple of this many nodes
    node_unit: int = 1
    # persist the newest shm frames when workers fail
    save_at_breakpoint: bool = True
    # the training script and its arguments
    entrypoint: str = ""
    args: List[str] = field(default_factory=list)
    # extra worker environment
    worker_env: Dict[str, str] = field(default_factory=dict)
    # where breakpoint saves go
    ckpt_dir: str = ""
    # checkpoint replicas: the backup-group size (0/1: off); above 1 the
    # agent runs a replica store and its workers push each sealed frame
    # to it and to their group's peers (ckpt/replica.py)
    ckpt_replica: int = 0
    # the device timer: workers preload its CUDA hook and serve per-rank
    # metrics; the agent runs the per-host daemon on :18889 (upstream's
    # xpu_timer_launch LD_PRELOAD wrapper and daemon)
    tpu_timer: bool = False
    # pre-imported spare interpreters, so a worker (re)spawn skips the
    # numpy/torch imports (agent/warm_spawn.py); a spare that fails to
    # release falls back to a cold spawn
    warm_spawn: bool = True

    def auto_configure_params(self) -> None:
        """Fill topology defaults from the environment."""
        if self.nproc_per_node <= 0:
            self.nproc_per_node = 1
        if self.max_nodes < self.min_nodes:
            self.max_nodes = self.min_nodes
        env_rank = os.getenv("NODE_RANK") or os.getenv("TPU_WORKER_ID")
        if env_rank is not None and self.node_rank == 0:
            self.node_rank = int(env_rank)
        self.node_id = self.node_rank
