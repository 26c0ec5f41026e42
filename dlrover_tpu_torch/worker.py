"""Worker-process API: bootstrap from the agent's environment.

The port's counterpart of ``dlrover_tpu/worker.py``. :func:`init` reads the
environment the agent set for this worker (rank, world, local rank, the
coordinator the master rendezvoused), starts ``torch.distributed`` there —
NCCL on the card, gloo on the CPU, with a gloo group beside NCCL for host
side agreement (checkpoint readiness and restore steps) — binds the
process to its card, and returns a :class:`WorkerContext` with the
control-plane helpers a training loop calls: :meth:`~WorkerContext.report_step`
(master RPC), :meth:`~WorkerContext.publish_step` (the agent's SharedDict:
the step, the op-class telemetry for the master's skew monitor, and every
~15 s the card's memory and the memory ledger) and
:meth:`~WorkerContext.training_span` (the goodput span).

With a master, :func:`init` wires the process's memory accountant
(``observability/memory.py``) to it: a pressure or degraded sweep is
journaled in the master's journal, and a breach writes a
``memory_pressure`` bundle holding ``memory.json``.

After the process group and the card are up, :func:`init` starts the
on-demand profile listener when the agent's IPC socket exists
(``observability/profiler.py``; ``DLROVER_TPU_PROFILE_LISTENER=0`` turns it
off). A live worker's profile runs on its main thread between steps:
:meth:`~WorkerContext.report_step` and :meth:`~WorkerContext.publish_step`
are its step boundaries, and :func:`shutdown` ends a capture still open.
With with ``TPU_TIMER_ENABLE`` set (the agent's ``--tpu-timer``) the
device timer: the engine with this rank's metrics endpoint, the CUDA hook
the agent preloaded, the GC hook and the ``DLROVER_TPU_TRACE_FUNCS``
tracepoints (``observability/tpu_timer.py``).
"""

import os
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
    MEM_KEY_PREFIX,
    OPTEL_KEY_PREFIX,
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
from dlrover_tpu_torch.observability import profiler

HBM_PUBLISH_S = 15.0

_host_group = None


def host_group():
    """The gloo group for host-side agreement among all ranks (the default
    group when the backend is gloo), or None before :func:`init`."""
    return _host_group


def _cuda_memory(device: torch.device) -> Dict[int, Dict[str, float]]:
    """``{card index: {hbm_used_mb, hbm_total_mb, hbm_reserved_mb,
    hbm_peak_mb}}`` of this process's card, read right after the memory
    accountant's sweep (``observability/memory.py``'s
    ``per_device_stats``: one collection path). The seam tests replace."""
    from dlrover_tpu_torch.observability.memory import per_device_stats

    return per_device_stats()


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
        profiler.step_boundary()
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
        agent forwards it to the master and feeds its hang bookkeeping).
        Every step carries this worker's cumulative op-class telemetry
        (once it has observed anything) and closes the memory ledger's
        step watermark; every ~15 s the card's memory and the ledger's
        wire snapshot ride along. Both snapshots are stamped with the
        global rank the master attributes against."""
        profiler.step_boundary()
        if not self.ipc_socket:
            return
        from dlrover_tpu_torch.common.multi_process import SharedDict
        from dlrover_tpu_torch.observability.memory import get_accountant
        from dlrover_tpu_torch.observability.tpu_timer import get_timer

        if not hasattr(self, "_metrics_dict"):
            self._metrics_dict = SharedDict(TRAINING_METRICS_DICT,
                                            self.ipc_socket)
            self._last_hbm_publish = 0.0
        now = time.time()
        payload = {"step": step, "ts": now}
        mem_acc = get_accountant()
        mem_acc.step_mark(step)
        if now - self._last_hbm_publish > HBM_PUBLISH_S:
            self._last_hbm_publish = now
            hbm = self._collect_hbm()
            if hbm:
                payload[f"{HBM_KEY_PREFIX}{self.local_rank}"] = hbm
            snap = mem_acc.wire_snapshot()
            snap["rank"] = self.rank
            payload[f"{MEM_KEY_PREFIX}{self.local_rank}"] = snap
        # the native engine's telemetry when the timer's library is loaded
        # (raising if it lacks tt_op_telemetry), else the Python spans'
        optel = get_timer().op_telemetry()
        if optel["seq"]:
            optel["rank"] = self.rank
            payload[f"{OPTEL_KEY_PREFIX}{self.local_rank}"] = optel
        try:
            self._metrics_dict.update(payload)
        except OSError:
            pass

    def _collect_hbm(self) -> Dict[int, Dict[str, float]]:
        """The memory accountant's sweep (headroom gauges, pressure), then
        the card's stats ({} on the CPU)."""
        from dlrover_tpu_torch.observability.memory import get_accountant

        get_accountant().reconcile()
        dev = self.device
        if dev is None or torch.device(dev).type != "cuda":
            return {}
        return _cuda_memory(torch.device(dev))


class _WorkerJournal:
    """The journal of a worker's memory accountant: each record lands in
    the worker's own journal (its bundles' ``journal.json``) and is
    reported to the master's journal (one attempt, best effort)."""

    def __init__(self, client: MasterClient):
        from dlrover_tpu_torch.observability.journal import EventJournal

        self.local = EventJournal()
        self._client = client

    def record(self, kind: str, source: str = "worker", **data) -> None:
        self.local.record(kind, source=source, **data)
        self._client.report_event(kind, dict(data, reporter=source))


def _wire_accountant(master: MasterClient, rank: int) -> None:
    """This process's memory accountant: its pressure and degraded sweeps
    are journaled (the worker's own journal and the master's), and a
    breach captures a ``memory_pressure`` bundle (``memory.json`` and
    ``journal.json`` inside) into ``DLROVER_TPU_TRACE_DIR``."""
    from dlrover_tpu_torch.observability.flight_recorder import (
        REASON_MEMORY,
        FlightRecorder,
    )
    from dlrover_tpu_torch.observability.memory import (
        MemoryAccountant,
        set_accountant,
    )

    journal = _WorkerJournal(master)
    recorder = FlightRecorder(source=f"worker_{rank}", journal=journal.local)
    acct = MemoryAccountant(
        journal=journal, source=f"worker_{rank}",
        breach_hook=lambda data: recorder.capture(REASON_MEMORY,
                                                  extra=data))
    recorder.memory_snapshot_fn = acct.snapshot
    set_accountant(acct)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init(initialize_distributed: bool = True,
         device="cuda") -> WorkerContext:
    """Bootstrap the worker from the agent's environment.

    Starts the default process group at ``tcp://<coordinator>`` (a free
    local port when the agent gave none, as for a lone worker), NCCL when
    ``device`` is a card and gloo on the CPU (``DLROVER_TPU_DIST_BACKEND``
    overrides: gloo lets ranks that share one card form a world), with the
    reference's
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
        backend = env_str(ConfigKey.DIST_BACKEND) or (
            "nccl" if dev.type == "cuda" else "gloo")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}",
            world_size=world_size, rank=rank,
            timeout=timedelta(seconds=timeout_s),
            **({"device_id": dev} if backend == "nccl" else {}))
        _host_group = (dist.new_group(backend="gloo")
                       if backend == "nccl" else dist.group.WORLD)
        logger.info("torch.distributed initialized: %s rank=%s/%s "
                    "coordinator=%s", backend, rank, world_size, coordinator)
    master_addr = env_str(EnvKey.MASTER_ADDR)
    master = None
    if master_addr:
        master = MasterClient(master_addr, env_int(EnvKey.NODE_ID, 0),
                              env_int(EnvKey.NODE_RANK, 0))
        _wire_accountant(master, rank)
    ipc = env_str(ConfigKey.IPC_SOCKET)
    if ipc and os.path.exists(ipc) and env_str(
            "DLROVER_TPU_PROFILE_LISTENER", "1") != "0":
        # on-demand torch.profiler capture: the agent's hang diagnosis and
        # straggler dump ask workers for a trace over this channel
        profiler.ProfileListener(ipc, local_rank).start()
    if env_str(ConfigKey.TPU_TIMER_ENABLE):
        # the agent opted this job into the device timer and preloaded its
        # hook: start the engine and serve this rank's metrics
        from dlrover_tpu_torch.observability.tpu_timer import (
            get_timer,
            install_tracepoints,
        )

        timer = get_timer()
        timer.install(rank=rank, world_size=world_size,
                      local_rank=local_rank, device=dev)
        timer.enable_gc_hook()
        if env_str(ConfigKey.TRACE_FUNCS):
            install_tracepoints()
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
    """End the profile listener (and a capture it runs), then tear the
    process group down (and the host group with it)."""
    global _host_group
    profiler.stop_listener()
    if dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None
