"""Worker-process API: bootstrap from the agent's environment.

The port's counterpart of ``dlrover_tpu/worker.py``. :func:`init` reads the
environment the agent set for this worker (rank, world, local rank, the
coordinator the master rendezvoused), starts ``torch.distributed`` there —
NCCL on the card, gloo on the CPU, with a gloo group beside NCCL for host
side agreement (checkpoint readiness and restore steps) — binds the
process to its card, and returns a :class:`WorkerContext` with the
control-plane helpers a training loop calls: :meth:`~WorkerContext.report_step`
(master RPC), :meth:`~WorkerContext.publish_step` (the agent's SharedDict,
with the card's memory every ~15 s) and :meth:`~WorkerContext.training_span`
(the goodput span).

Not ported (ROADMAP A11): the on-demand profile listener and the device
timer hooks the reference starts from here.
"""

import socket
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.monitor import (
    HBM_KEY_PREFIX,
    TRAINING_METRICS_DICT,
)
from dlrover_tpu_torch.common.constants import (
    ConfigKey,
    EnvKey,
    env_int,
    env_str,
)
from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.common.log import logger

HBM_PUBLISH_S = 15.0

_host_group = None


def host_group():
    """The gloo group for host-side agreement among all ranks (the default
    group when the backend is gloo), or None before :func:`init`."""
    return _host_group


def _cuda_memory(device: torch.device) -> Dict[int, Dict[str, float]]:
    """``{card index: {hbm_used_mb, hbm_total_mb, hbm_peak_mb}}`` of this
    process's card: used and total from ``mem_get_info`` (the whole card),
    the peak this process's allocator reached. The seam tests replace."""
    free, total = torch.cuda.mem_get_info(device)
    mb = float(1 << 20)
    return {device.index: {
        "hbm_used_mb": (total - free) / mb,
        "hbm_total_mb": total / mb,
        "hbm_peak_mb": torch.cuda.max_memory_allocated(device) / mb,
    }}


@dataclass
class WorkerContext:
    rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    node_rank: int
    node_num: int
    restart_count: int
    master: Optional[MasterClient]
    job_name: str = "local"
    device: Any = None

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    def report_step(self, step: int) -> None:
        if self.master is not None:
            try:
                self.master.report_global_step(step, time.time())
            except ConnectionError:
                pass

    @property
    def ipc_socket(self) -> str:
        return env_str(ConfigKey.IPC_SOCKET)

    def training_span(self, **content):
        """The productive-time span offline goodput analysis counts. A
        crash inside the span leaves it open: the time a fault costs."""
        from dlrover_tpu_torch.common.event import TrainEvent, get_emitter

        return get_emitter(f"worker_{self.rank}").span(
            TrainEvent.TRAINING, rank=self.rank, **content)

    def publish_step(self, step: int) -> None:
        """Publish progress to the local agent through its SharedDict (the
        agent forwards it to the master and feeds its hang bookkeeping);
        every ~15 s the card's memory rides along."""
        if not self.ipc_socket:
            return
        from dlrover_tpu_torch.common.multi_process import SharedDict

        if not hasattr(self, "_metrics_dict"):
            self._metrics_dict = SharedDict(TRAINING_METRICS_DICT,
                                            self.ipc_socket)
            self._last_hbm_publish = 0.0
        now = time.time()
        payload = {"step": step, "ts": now}
        if now - self._last_hbm_publish > HBM_PUBLISH_S:
            self._last_hbm_publish = now
            hbm = self._collect_hbm()
            if hbm:
                payload[f"{HBM_KEY_PREFIX}{self.local_rank}"] = hbm
        try:
            self._metrics_dict.update(payload)
        except OSError:
            pass

    def _collect_hbm(self) -> Dict[int, Dict[str, float]]:
        dev = self.device
        if dev is None or torch.device(dev).type != "cuda":
            return {}
        return _cuda_memory(torch.device(dev))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init(initialize_distributed: bool = True,
         device="cuda") -> WorkerContext:
    """Bootstrap the worker from the agent's environment.

    Starts the default process group at ``tcp://<coordinator>`` (a free
    local port when the agent gave none, as for a lone worker), NCCL when
    ``device`` is a card and gloo on the CPU, with the reference's
    shutdown and heartbeat timeouts (60 s and 30 s; the longer one bounds
    a collective that waits on a dead peer). On a card the process binds
    to ``cuda:<local rank>``."""
    global _host_group
    rank = env_int(EnvKey.RANK, 0)
    world_size = env_int(EnvKey.WORLD_SIZE, 1)
    local_rank = env_int(EnvKey.LOCAL_RANK, 0)
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    if initialize_distributed and not dist.is_initialized():
        coordinator = env_str(EnvKey.COORDINATOR_ADDR)
        if not coordinator:
            if world_size > 1:
                raise RuntimeError(
                    f"{EnvKey.COORDINATOR_ADDR} is unset for a world of "
                    f"{world_size}")
            coordinator = f"127.0.0.1:{_free_port()}"
        timeout_s = max(env_int(ConfigKey.DIST_SHUTDOWN_S, 60),
                        env_int(ConfigKey.DIST_HEARTBEAT_S, 30))
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}",
            world_size=world_size, rank=rank,
            timeout=timedelta(seconds=timeout_s),
            **({"device_id": dev} if dev.type == "cuda" else {}))
        _host_group = (dist.new_group(backend="gloo")
                       if backend == "nccl" else dist.group.WORLD)
        logger.info("torch.distributed initialized: %s rank=%s/%s "
                    "coordinator=%s", backend, rank, world_size, coordinator)
    master_addr = env_str(EnvKey.MASTER_ADDR)
    master = None
    if master_addr:
        master = MasterClient(master_addr, env_int(EnvKey.NODE_ID, 0),
                              env_int(EnvKey.NODE_RANK, 0))
    return WorkerContext(
        rank=rank,
        world_size=world_size,
        local_rank=local_rank,
        local_world_size=env_int(EnvKey.LOCAL_WORLD_SIZE, 1),
        node_rank=env_int(EnvKey.NODE_RANK, 0),
        node_num=env_int(EnvKey.NODE_NUM, 1),
        restart_count=env_int(EnvKey.RESTART_COUNT, 0),
        master=master,
        job_name=env_str(EnvKey.JOB_NAME, "local"),
        device=dev,
    )


def shutdown() -> None:
    """Tear the process group down (and the host group with it)."""
    global _host_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None
