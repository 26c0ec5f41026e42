"""The elastic agent: rendezvous, worker processes, fault recovery.

The port's copy of ``MasterRendezvousHandler``, ``assign_worker_ranks`` and
``ElasticTrainingAgent`` from ``dlrover_tpu/agent/training.py``. One agent
runs on each host:

1. it joins the master's training rendezvous and waits for the cut world;
   the world gives each worker its global rank and the process-group
   bootstrap address (rank 0's host and a free port it reported);
2. it spawns ``nproc_per_node`` workers, their environment the
   reference's keys and values (``_worker_env``): each a warm spare of
   its :class:`~dlrover_tpu_torch.agent.warm_spawn.WarmWorkerPool` (an
   interpreter that imported numpy, torch and the port's worker modules
   while the last incarnation trained, released into the script), or,
   with ``--no-warm-spawn`` or no spare alive, a fresh ``subprocess``;
   the agent never touches a device, and a worker never inherits the
   agent's threads;
3. it watches them: a failed worker restarts the group within
   ``max_restarts``; a new round forming at the master (a node joined or
   left) restarts it into the new world; a ``RESTART_WORKER`` action on a
   heartbeat reply (the hang rule, a peer's death) restarts it, fast when
   the workers are marked wedged; ``JOB_ABORT`` ends the agent;
4. around a restart it stops the workers (SIGTERM, then SIGKILL after the
   grace), persists the newest shm frames (the breakpoint save, through
   the agent's :class:`~dlrover_tpu_torch.ckpt.ckpt_saver.
   AsyncCheckpointSaver`) and requeues the node's shard leases.

The agent serves the workers' IPC (:class:`LocalIPCServer`: frame locks,
the save-event queue, progress) and forwards their steps to the master;
an incarnation's first step is also reported as ``step_resumed``, which
closes a recovery in the master's journal. Besides its periodic poll, it
forwards the workers' progress once more before it reports a failure,
restarts the workers or ends, so an incarnation shorter than one poll
period still closes its recovery.
Its rendezvous rounds, spawns, worker failures, restarts and breakpoint
saves are events of target ``agent_<node_rank>`` (``common/event.py``:
the log, and JSONL under ``DLROVER_TPU_EVENT_DIR``).

With ``tpu_timer`` set (``--tpu-timer``) the agent builds the device
timer (``dlrover_tpu_torch/tpu_timer/build.py``; a failed build fails the
agent) before it spawns a worker, puts the hook library in each worker's
``LD_PRELOAD`` with ``TPU_TIMER_ENABLE=1``, and runs the per-host daemon
on ``TPU_TIMER_DAEMON_PORT`` (18889). Its :class:`DiagnosisAgent` scrapes
the daemon every heartbeat and the beat carries the ``XPU_TIMER_*``
gauges, so the master's hang rule hears each node's vote; a rising hang
gauge pulls the workers' stacks and requests a ``torch.profiler`` trace
from each, and a wedged restart waits for that evidence first.

Every beat also carries the workers' cumulative op-class telemetry and
memory ledgers, re-keyed by global rank (``agent/monitor.py``), for the
master's skew monitor and fleet memory monitor, and a
:class:`ResourceMonitor` reports host usage and the workers' card memory
every ``resource_report_interval_s``. A ``STACK_DUMP`` action (the
master's straggler rule naming one of this node's ranks) captures
evidence from the named rank's worker on a thread of its own without
touching the training: a ``torch.profiler`` trace, which the worker takes
on its main thread between steps (``observability/profiler.py``), and,
through the device timer's daemon (so with ``--tpu-timer``), its Python
stack; the agent reports ``stack_dump_captured`` with both files' paths
to the master.

Tracing: a rendezvous round is one ``rdzv.client_round`` trace (the
client's join and world-wait spans and the master's join and cut spans
nest under it), and a restart the master ordered runs under
``agent.restart_workers`` in the trace of the master's
``fault.relaunch``, whose context the action's data carries. The agent's
flight recorder captures a bundle on an unhandled exception and on every
injected fault (its reporter also reports ``fault_injected`` to the
master), and with ``DLROVER_TPU_AGENT_METRICS_PORT`` set (0: a free port;
else the port plus the node rank) the agent serves ``GET /metrics`` and
``/debug/bundle``.

The recovery ladder's agent side: at start the agent unlinks the shm
segments a previous agent incarnation of its node left
(``shm_orphans_cleaned``); it serves its workers' sealed frames by shard
to a new world's workers (``ReshardService``, ``ckpt/reshard.py``), and
with ``--ckpt-replica N`` (N > 1) it keeps the replica store its workers
and its backup group push frames to (``ReplicaService``,
``ckpt/replica.py``), which copies a local worker's sealed frame out of
its segment and pushes it to the group's peers; both publish their
address in the master KV. The
warm pool starts after the device timer's build, so each spare is
spawned with the hook library in ``LD_PRELOAD`` (the loader reads it at
``exec``); the first rendezvous waits (``DLROVER_TPU_WARM_WAIT_S``, 10
s) for the spares' imports. Not ported: the actor host, fan-in, the
partition-degraded mode, the network check.
"""

import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import traceback
import uuid
from dataclasses import dataclass
from enum import Enum
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.agent.config import ElasticLaunchConfig
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.agent.monitor import (
    MemorySnapshotCollector,
    OpTelemetryCollector,
    ResourceMonitor,
    TrainingMonitor,
    device_stats_from_ipc,
)
from dlrover_tpu_torch.common.comm import NodeMeta
from dlrover_tpu_torch.chaos import get_injector
from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.common.constants import (
    ConfigKey,
    DiagnosisActionType,
    EnvKey,
    NodeStatus,
    RendezvousName,
    SharedResourceName,
    SpanName,
    TrainingExceptionLevel,
    env_flag,
    env_float,
    env_int,
    env_str,
)
from dlrover_tpu_torch.common.event import AgentEvent, get_emitter
from dlrover_tpu_torch.common.http_server import HTTPTransportServer
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.multi_process import (
    LocalIPCServer,
    ipc_socket_path,
)
from dlrover_tpu_torch.common.rpc import find_free_port
from dlrover_tpu_torch.diagnosis.diagnosis_agent import (
    _NODE_LEVEL_EXIT_CODES,
    DiagnosisAgent,
    ResourceCollector,
    TpuTimerCollector,
)
from dlrover_tpu_torch.observability import tracing
from dlrover_tpu_torch.observability.flight_recorder import (
    REASON_CRASH,
    FlightRecorder,
)
from dlrover_tpu_torch.observability.journal import JournalEvent
from dlrover_tpu_torch.observability.profiler import (
    PROFILE_DICT,
    THREAD_MAIN,
    await_profile,
)
from dlrover_tpu_torch.observability.registry import get_registry
from dlrover_tpu_torch.observability.tpu_timer import (
    DAEMON_PORT,
    DEFAULT_WORKER_PORT_BASE,
)

# how long past the master's connection-drop grace an abort waits for the
# word that a peer node left the world
_PEER_NEWS_MARGIN_S = 2.0
# the straggler dump's profile of the named worker (the reference's
# duration), how long the dump waits for it, and how long a stopping
# agent waits for a dump in flight
STACK_DUMP_PROFILE_S = 3.0
STACK_DUMP_PROFILE_WAIT_S = 45.0
STACK_DUMP_JOIN_S = 15.0


class MasterRendezvousHandler:
    """Joins a named master rendezvous and polls for the cut world."""

    def __init__(self, name: str, client: MasterClient, node_rank: int,
                 local_world_size: int, timeout_s: float = 600.0,
                 node_unit: int = 1):
        self._name = name
        self._client = client
        self._node_rank = node_rank
        self._local_world_size = local_world_size
        self._timeout_s = timeout_s
        self._node_unit = node_unit

    def next_rendezvous(self) -> Tuple[int, Dict[int, NodeMeta], str]:
        """Join, then poll until this node is in a cut world. Returns
        (round, {node_rank: NodeMeta}, coordinator address)."""
        free_port = find_free_port("127.0.0.1")
        self._client.join_rendezvous(
            self._name, self._node_rank, self._local_world_size,
            host=env_str(ConfigKey.HOST_IP, "127.0.0.1"),
            free_port=free_port, node_unit=self._node_unit)
        start = time.monotonic()
        while True:
            rdzv_round, _, world, coordinator = self._client.get_comm_world(
                self._name, self._node_rank)
            if world and self._node_rank in world:
                return rdzv_round, world, coordinator
            if time.monotonic() - start > self._timeout_s:
                raise TimeoutError(
                    f"rendezvous {self._name} timed out after "
                    f"{self._timeout_s}s (node_rank={self._node_rank})")
            time.sleep(0.1)


def assign_worker_ranks(world: Dict[int, NodeMeta],
                        node_rank: int) -> Tuple[int, int]:
    """(base global rank, world size) of this node in the cut world, in
    the master's ``comm_rank`` order when stamped, else node-rank order."""
    world_size = sum(m.local_world_size for m in world.values())
    if all(m.comm_rank >= 0 for m in world.values()):
        order = sorted(world, key=lambda r: world[r].comm_rank)
    else:
        order = sorted(world)
    base_rank = 0
    for r in order:
        if r == node_rank:
            break
        base_rank += world[r].local_world_size
    return base_rank, world_size


class WorkerState(Enum):
    INIT = "init"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"


@dataclass
class _Worker:
    local_rank: int
    global_rank: int
    proc: subprocess.Popen


class RunResult:
    def __init__(self, state: WorkerState, failures: Optional[Dict] = None):
        self.state = state
        self.failures = failures or {}


class ElasticTrainingAgent:
    def __init__(self, config: ElasticLaunchConfig,
                 client: Optional[MasterClient] = None, ckpt_saver=None):
        self._config = config
        self._client = client or MasterClient(
            config.master_addr, config.node_id, config.node_rank)
        self._workers: List[_Worker] = []
        self._restart_count = 0
        self._remaining_restarts = config.max_restarts
        self._stop_flag = threading.Event()
        self._action_lock = threading.Lock()
        self._pending_action: Optional[Tuple[str, Dict]] = None
        self._dump_thread: Optional[threading.Thread] = None
        # this agent's shm incarnation: its workers' frame names carry it
        self._shm_incarnation = uuid.uuid4().hex[:8]
        self._rdzv_handler = MasterRendezvousHandler(
            RendezvousName.TRAINING, self._client, config.node_rank,
            config.nproc_per_node, timeout_s=config.rdzv_timeout_s,
            node_unit=config.node_unit)
        self._current_round = -1
        self._world: Dict[int, NodeMeta] = {}
        self._ipc_server = LocalIPCServer(
            ipc_socket_path(config.job_name, config.node_rank))
        self._ckpt_saver = ckpt_saver
        self._hb_thread: Optional[threading.Thread] = None
        # the warm spares (started in run, after the device timer's build),
        # and the replica and reshard services
        self._warm_pool = None
        self._replica_service = None
        self._reshard_service = None
        self._training_monitor: Optional[TrainingMonitor] = None
        self._last_global_step = 0
        self._last_step_ts = 0.0
        self._events = get_emitter(f"agent_{config.node_rank}")
        self._flight_recorder = FlightRecorder(
            source=f"agent_{config.node_rank}", registry=get_registry())
        self._metrics_server = self._maybe_start_metrics_server()
        # the device timer's daemon port, and the hook library once built
        self._timer_port = env_int(ConfigKey.TPU_TIMER_DAEMON_PORT,
                                   DAEMON_PORT)
        self._timer_lib: Optional[str] = None
        # node-side diagnosis: the heartbeat's gauges, the hang evidence,
        # and the restart-vs-relaunch verdict on a worker failure
        collectors = [ResourceCollector()]
        if config.tpu_timer:
            collectors.append(TpuTimerCollector(port=self._timer_port))
        # native stacks need gdb; without it the daemon reads the Python
        # stacks alone (the workers' faulthandler dumps)
        self._diagnosis = DiagnosisAgent(
            collectors=collectors, timer_port=self._timer_port,
            ipc_server=self._ipc_server,
            local_world_size=config.nproc_per_node,
            stack_mode="all" if shutil.which("gdb") else "python",
            peer_failed=self._peer_failed)
        # the workers' op-class telemetry and memory ledgers, re-keyed by
        # global rank for the beat
        self._op_telemetry = OpTelemetryCollector(self._ipc_server)
        self._mem_snapshots = MemorySnapshotCollector(self._ipc_server)

    def _maybe_start_metrics_server(self) -> Optional[HTTPTransportServer]:
        """``GET /metrics`` and ``/debug/bundle``, when
        ``DLROVER_TPU_AGENT_METRICS_PORT`` is set (0: a free port; a
        base port is offset by the node rank)."""
        port_env = env_str(ConfigKey.AGENT_METRICS_PORT)
        if not port_env:
            return None
        try:
            base = int(port_env)
            server = HTTPTransportServer(
                port=base + self._config.node_rank if base else 0)
        except (ValueError, OSError) as e:
            logger.warning("agent metrics server disabled: %r", e)
            return None
        server.add_get_route("/metrics", lambda: (
            "text/plain; version=0.0.4; charset=utf-8",
            get_registry().render()))
        server.add_get_route("/debug/bundle",
                             self._flight_recorder.http_handler())
        server.start()
        logger.info("agent metrics on :%s/metrics", server.port)
        return server

    # -- rendezvous + spawn --------------------------------------------------

    def _rendezvous(self) -> Tuple[str, int, int]:
        span = self._events.span(AgentEvent.RENDEZVOUS,
                                 restart_count=self._restart_count).begin()
        # the causal root of this node's round
        with tracing.span(SpanName.RDZV_CLIENT_ROUND,
                          source=f"agent_{self._config.node_rank}",
                          node_rank=self._config.node_rank,
                          restart_count=self._restart_count):
            rdzv_round, world, coordinator = (
                self._rdzv_handler.next_rendezvous())
        self._current_round = rdzv_round
        self._world = world
        base_rank, world_size = assign_worker_ranks(world,
                                                    self._config.node_rank)
        logger.info("node %s rendezvous round %s: %s nodes, world_size=%s, "
                    "base_rank=%s, coordinator=%s", self._config.node_rank,
                    rdzv_round, len(world), world_size, base_rank,
                    coordinator)
        span.end(round=rdzv_round, nodes=sorted(world),
                 world_size=world_size)
        if self._ckpt_saver is not None:
            # the commit quorum belongs to the current world
            self._ckpt_saver.update_world(
                node_rank=self._config.node_rank,
                expected_frames=world_size,
                is_commit_leader=(self._config.node_rank == min(world)))
        return coordinator, base_rank, world_size

    def _base_worker_env(self) -> Dict[str, str]:
        env = dict(os.environ)
        # the workers resolve the same package the agent runs
        import dlrover_tpu_torch

        pkg_root = os.path.dirname(os.path.dirname(
            dlrover_tpu_torch.__file__))
        pythonpath = env.get("PYTHONPATH", "")
        if pkg_root not in pythonpath.split(os.pathsep):
            env["PYTHONPATH"] = (pkg_root + (os.pathsep + pythonpath
                                             if pythonpath else ""))
        env.update(self._config.worker_env)
        return env

    def _worker_env(self, local_rank: int, global_rank: int,
                    world_size: int, coordinator: str) -> Dict[str, str]:
        env = self._base_worker_env()
        env.update({
            EnvKey.JOB_NAME: self._config.job_name,
            EnvKey.MASTER_ADDR: self._client.master_addr,
            EnvKey.NODE_ID: str(self._config.node_id),
            EnvKey.NODE_RANK: str(self._config.node_rank),
            EnvKey.NODE_NUM: str(len(self._world)),
            EnvKey.LOCAL_RANK: str(local_rank),
            EnvKey.LOCAL_WORLD_SIZE: str(self._config.nproc_per_node),
            EnvKey.RANK: str(global_rank),
            EnvKey.WORLD_SIZE: str(world_size),
            EnvKey.COORDINATOR_ADDR: coordinator,
            EnvKey.PROCESS_ID: str(global_rank),
            EnvKey.NUM_PROCESSES: str(world_size),
            EnvKey.RESTART_COUNT: str(self._restart_count),
            EnvKey.RDZV_ROUND: str(self._current_round),
            EnvKey.REPLICA_GROUP: str(self._config.ckpt_replica),
            EnvKey.SHM_INCARNATION: self._shm_incarnation,
            ConfigKey.IPC_SOCKET: self._ipc_server.path,
        })
        return self._with_timer(env)

    def _with_timer(self, env: Dict[str, str]) -> Dict[str, str]:
        """``env`` with the device timer's hook preloaded, once built."""
        if self._timer_lib:
            preload = env.get("LD_PRELOAD", "")
            env.update({
                ConfigKey.TPU_TIMER_ENABLE: "1",
                ConfigKey.TPU_TIMER_LIB: self._timer_lib,
                "LD_PRELOAD": (self._timer_lib + (" " + preload
                                                  if preload else "")),
            })
        return env

    def _start_warm_pool(self) -> None:
        """The spares, spawned with the job-static environment and the
        timer's preload; the first rendezvous waits (bounded) for their
        imports."""
        from dlrover_tpu_torch.agent.warm_spawn import WarmWorkerPool

        self._warm_pool = WarmWorkerPool(
            size=self._config.nproc_per_node,
            base_env=self._with_timer(self._base_worker_env()))
        self._warm_pool.prewarm()
        self._warm_pool.wait_ready(
            n=self._config.nproc_per_node,
            timeout_s=env_float(ConfigKey.WARM_WAIT_S, 10.0))

    def _initialize_workers(self) -> None:
        coordinator, base_rank, world_size = self._rendezvous()
        self._workers = []
        warm = []
        for local_rank in range(self._config.nproc_per_node):
            global_rank = base_rank + local_rank
            env = self._worker_env(local_rank, global_rank, world_size,
                                   coordinator)
            proc = None
            if self._warm_pool is not None:
                proc = self._warm_pool.take(env, self._config.entrypoint,
                                            self._config.args)
            warm.append(proc is not None)
            if proc is None:  # no pool or no live spare: a cold spawn
                cmd = [sys.executable, self._config.entrypoint,
                       *self._config.args]
                proc = subprocess.Popen(cmd, env=env)  # noqa: S603
            self._workers.append(_Worker(local_rank, global_rank, proc))
        logger.info("node %s spawned %s worker(s): pids=%s warm=%s",
                    self._config.node_rank, len(self._workers),
                    [w.proc.pid for w in self._workers], warm)
        self._events.instant(AgentEvent.WORKER_SPAWN,
                             restart_count=self._restart_count,
                             world_size=world_size,
                             pids=[w.proc.pid for w in self._workers],
                             warm=warm)

    # -- monitoring ----------------------------------------------------------

    def _monitor_workers(self) -> RunResult:
        states, failures = [], {}
        for w in self._workers:
            code = w.proc.poll()
            if code is None:
                states.append(WorkerState.RUNNING)
            elif code == 0:
                states.append(WorkerState.SUCCEEDED)
            else:
                states.append(WorkerState.FAILED)
                failures[w.global_rank] = code
        if failures:
            return RunResult(WorkerState.FAILED, failures)
        if all(s == WorkerState.SUCCEEDED for s in states):
            return RunResult(WorkerState.SUCCEEDED)
        return RunResult(WorkerState.RUNNING)

    def _membership_changed(self) -> bool:
        """A new rendezvous round is forming at the master."""
        try:
            return self._client.num_nodes_waiting(
                RendezvousName.TRAINING) > 0
        except ConnectionError:
            return False

    def _stop_workers(self, sig: int = signal.SIGTERM,
                      grace_s: Optional[float] = None) -> None:
        """Signal the workers, then SIGKILL whoever outlives the grace (a
        worker blocked in a collective whose peer died never exits)."""
        if grace_s is None:
            grace_s = get_context().worker_stop_grace_s
        for w in self._workers:
            if w.proc.poll() is None:
                try:
                    w.proc.send_signal(sig)
                except ProcessLookupError:
                    pass
        deadline = time.monotonic() + grace_s
        for w in self._workers:
            try:
                w.proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                w.proc.kill()
                w.proc.wait()

    def _restart_workers(self, reason: str,
                         grace_s: Optional[float] = None) -> None:
        """Same host, new rendezvous round."""
        logger.info("restarting workers on node %s: %s",
                    self._config.node_rank, reason)
        self._events.instant(AgentEvent.RESTART, reason=reason,
                             restart_count=self._restart_count)
        self._forward_progress()
        # stop first: the frames outlive the workers, and persisting after
        # they died rules out reading a frame mid-write
        self._stop_workers(grace_s=grace_s)
        self._save_breakpoint_checkpoint(reason)
        if self._ckpt_saver is not None:
            self._ckpt_saver.forget_persisted()
        try:
            self._client.recover_shard_tasks()
        except (ConnectionError, OSError) as e:
            logger.warning("shard-lease recovery skipped: %r", e)
        self._restart_count += 1
        # a stale step must not re-arm the master's hang rule, and the
        # restored workers may resume from an earlier step
        self._last_global_step = 0
        self._last_step_ts = 0.0
        if self._training_monitor is not None:
            self._training_monitor.reset()
        self._initialize_workers()

    def _save_breakpoint_checkpoint(self, reason: str) -> None:
        """Persist the shm frames newer than storage before the restart."""
        if self._ckpt_saver is not None and self._config.save_at_breakpoint:
            span = self._events.span(AgentEvent.CKPT_SAVE,
                                     reason=reason).begin()
            frames = -1
            try:
                frames = self._ckpt_saver.save_shm_to_storage(
                    reason=reason, workers_dead=True, async_commit=True)
            except Exception:  # noqa: BLE001
                logger.exception("breakpoint checkpoint save failed")
            finally:
                span.end(frames=frames)

    # -- heartbeat and diagnosis actions ---------------------------------------

    def _heartbeat_loop(self) -> None:
        interval = get_context().heartbeat_interval_s
        while not self._stop_flag.wait(interval):
            # the workers' telemetry before the step: a restart zeroes the
            # step before it clears the telemetry, so a beat that reports
            # a step never misses the telemetry that came with it
            gauges = self._diagnosis.collect_gauges()
            op_telemetry = self._op_telemetry.collect()
            memory = self._mem_snapshots.collect()
            try:
                resp = self._client.heartbeat(
                    global_step=self._last_global_step,
                    step_timestamp=self._last_step_ts,
                    gauges=gauges, rdzv_round=self._current_round,
                    op_telemetry=op_telemetry, memory=memory)
            except (ConnectionError, RuntimeError):
                logger.warning("node %s heartbeat failed",
                               self._config.node_rank)
                continue
            self._handle_heartbeat_action(resp)

    def _handle_heartbeat_action(self, resp) -> None:
        if resp.action_type == DiagnosisActionType.NONE:
            return
        if resp.action_type == DiagnosisActionType.STACK_DUMP:
            # evidence only: the workers keep training
            self._capture_stack_dump(dict(resp.action_data or {}))
            return
        with self._action_lock:
            self._pending_action = (resp.action_type,
                                    dict(resp.action_data or {}))
        logger.info("received diagnosis action %s (%s)", resp.action_type,
                    resp.action_data)

    def _capture_stack_dump(self, action_data: Dict) -> None:
        """Serve the straggler rule's ``STACK_DUMP`` for the named rank's
        worker (every local worker when it is not this node's), on a
        thread of its own (a stack capture can take seconds a worker): a
        ``torch.profiler`` trace of ``STACK_DUMP_PROFILE_S`` (requested
        first, taken by the worker's main thread between steps) and its
        Python stack through the device timer's daemon; then reports
        ``stack_dump_captured`` to the master with the stack file's path
        (``path``) and the trace's (``profile``, with ``profile_ok`` and
        the capturing ``profile_thread``; '' when none came within
        ``STACK_DUMP_PROFILE_WAIT_S``). The span joins the trace of the
        master's verdict, whose context the action's data carries."""
        carried = tracing.extract_wire(action_data.get(tracing.WIRE_KEY))
        rank = action_data.get("rank", -1)
        named = [w for w in self._workers if w.global_rank == rank]

        def capture():
            try:
                with tracing.activate(carried), tracing.span(
                        SpanName.AGENT_STACK_DUMP,
                        source=f"agent_{self._config.node_rank}",
                        rank=rank):
                    # the worker is live: its main thread captures
                    # between steps, however long a step takes
                    reqs = self._diagnosis._request_worker_profiles(
                        STACK_DUMP_PROFILE_S,
                        [w.local_rank for w in named] if named else None,
                        THREAD_MAIN)
                    path = self._diagnosis.capture_worker_stacks(
                        pid=named[0].proc.pid if named else None)
                    done = {}
                    for local_rank, req_id in reqs.items():
                        done = await_profile(
                            self._ipc_server.local_dict(PROFILE_DICT),
                            local_rank, req_id,
                            STACK_DUMP_PROFILE_WAIT_S) or {}
                        break  # the named rank's (or the first worker's)
                self._client.report_event(
                    JournalEvent.STACK_DUMP_CAPTURED,
                    {"rank": rank, "cause": action_data.get("cause", ""),
                     "path": path,
                     "profile": done.get("path", "") if done.get("ok")
                     else "",
                     "profile_ok": bool(done.get("ok")),
                     "profile_thread": done.get("thread", "")})
            except Exception:  # noqa: BLE001 — evidence is best-effort;
                # the training plane stays untouched
                logger.warning("stack-dump capture failed", exc_info=True)

        self._dump_thread = threading.Thread(target=capture,
                                             name="stack-dump", daemon=True)
        self._dump_thread.start()

    def _take_pending_action(self):
        """(action_type, action_data), or (None, {})."""
        with self._action_lock:
            pending, self._pending_action = self._pending_action, None
            return pending if pending is not None else (None, {})

    def _forward_progress(self) -> None:
        """Forward what the workers published since the last progress
        poll, before a fault, a restart or the end is reported: an
        incarnation that stopped within one poll period of its first step
        still reports its ``step_resumed`` first, so the master's journal
        closes its recovery before the next fault would open one."""
        if self._training_monitor is None:
            return
        try:
            self._training_monitor.poll_once()
        except Exception:  # noqa: BLE001 — progress is best-effort
            logger.exception("training progress poll failed")

    def observe_global_step(self, step: int, ts: float) -> None:
        if self._last_step_ts == 0.0:
            # the incarnation's first step: training is live again (the
            # master's journal closes a recovery here)
            self._client.report_event(JournalEvent.STEP_RESUMED,
                                      {"step": step})
        self._last_global_step = step
        self._last_step_ts = ts

    def _local_shm_handlers(self):
        """Handlers of the frames this host's workers registered in the
        IPC meta dict (the saver's idiom): what the reshard service
        serves."""
        from dlrover_tpu_torch.ckpt.shm_handler import SharedMemoryHandler

        meta = self._ipc_server.local_dict(SharedResourceName.SHM_META_DICT)
        return [SharedMemoryHandler(info["shm"])
                for info in dict(meta).values()]

    def _start_ckpt_services(self) -> None:
        """The replica store (``--ckpt-replica N``, N > 1) and the reshard
        service, each published in the master KV."""
        if self._config.ckpt_replica > 1:
            from dlrover_tpu_torch.ckpt.replica import (
                ReplicaManager,
                ReplicaService,
            )

            self._replica_service = ReplicaService()
            self._replica_service.start()
            # registers the store's address; pushes the frames its
            # workers hand it to the peers they name
            self._replica_service.forwarder = ReplicaManager(
                self._config.job_name, self._config.node_rank, 1,
                self._client, service=self._replica_service)
        if env_flag(ConfigKey.RESHARD, True):
            from dlrover_tpu_torch.ckpt.reshard import ReshardService

            self._reshard_service = ReshardService(
                shm_provider=self._local_shm_handlers)
            self._reshard_service.start()
            try:
                self._reshard_service.register(
                    self._client, self._config.job_name,
                    self._config.node_rank)
            except ConnectionError as e:
                logger.warning("reshard service address publish failed: "
                               "%r — peers restore from another rung", e)

    # -- main loop -----------------------------------------------------------

    def run(self) -> int:
        from dlrover_tpu_torch.ckpt.shm_handler import (
            cleanup_orphan_segments,
        )

        # a predecessor agent that died uncleanly left its segments
        removed = cleanup_orphan_segments(
            self._config.job_name, self._config.node_rank,
            self._shm_incarnation)
        if removed:
            self._client.report_event(JournalEvent.SHM_ORPHANS_CLEANED,
                                      {"segments": removed})
        inj = get_injector()
        if inj is not None:
            # an injected fault reaches the master's journal by the
            # best-effort event path, and leaves a local bundle
            inj.set_reporter(self._flight_recorder.wrap_fault_reporter(
                lambda event: self._client.report_event(
                    JournalEvent.FAULT_INJECTED, event)))
        self._ipc_server.start()
        self._start_ckpt_services()
        if self._ckpt_saver is not None:
            self._ckpt_saver.start(self._ipc_server)
            try:
                # persist shm before dying on SIGTERM
                self._ckpt_saver.install_signal_handlers()
            except ValueError:
                pass  # not the main thread (an in-process test)
        self._client.update_node_status(NodeStatus.RUNNING)
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name="agent-heartbeat", daemon=True)
        self._hb_thread.start()
        self._training_monitor = TrainingMonitor(
            self._ipc_server, self._client, on_step=self.observe_global_step,
            round_provider=lambda: self._current_round)
        self._training_monitor.start()
        resource_monitor = ResourceMonitor(
            self._client,
            interval_s=get_context().resource_report_interval_s,
            extra_device_stats=lambda: device_stats_from_ipc(
                self._ipc_server))
        resource_monitor.start()
        timer_daemon = None
        try:
            if self._config.tpu_timer:
                timer_daemon = self._start_device_timer()
            if self._config.warm_spawn and self._config.entrypoint:
                self._start_warm_pool()
            self._initialize_workers()
            return self._monitor_loop()
        except Exception:
            # the post-mortem bundle, before the exception unwinds
            self._flight_recorder.capture(REASON_CRASH, extra={
                "error": traceback.format_exc(limit=20)})
            raise
        finally:
            self._stop_flag.set()
            self._training_monitor.stop()
            resource_monitor.stop()
            self._stop_workers()
            if self._dump_thread is not None:
                # a stopping worker answers its profile request: let the
                # evidence reach the master
                self._dump_thread.join(STACK_DUMP_JOIN_S)
            if timer_daemon is not None:
                timer_daemon.kill()
                timer_daemon.wait()
            if self._ckpt_saver is not None:
                self._ckpt_saver.stop()
            for service in (self._replica_service, self._reshard_service):
                if service is not None:
                    service.stop()
            if self._warm_pool is not None:
                self._warm_pool.stop()
            self._ipc_server.stop()
            if self._metrics_server is not None:
                self._metrics_server.stop()
            self._flight_recorder.close()

    def _start_device_timer(self):
        """Build the hook library and the daemon (raising when the build
        fails: the workers would run untimed) and start the daemon over
        this node's workers."""
        from dlrover_tpu_torch.observability.timeline import start_daemon
        from dlrover_tpu_torch.tpu_timer import build

        paths = build.build()
        self._timer_lib = str(paths["lib"])
        base = env_int(ConfigKey.TPU_TIMER_PORT, DEFAULT_WORKER_PORT_BASE)
        daemon = start_daemon(listen_port=self._timer_port, base_port=base,
                              n_workers=self._config.nproc_per_node)
        if daemon is None:
            raise RuntimeError("tpu_timer: the daemon did not start")
        logger.info("node %s device timer: %s, daemon on :%s over :%s..",
                    self._config.node_rank, self._timer_lib,
                    self._timer_port, base)
        return daemon

    def _monitor_loop(self) -> int:
        interval = self._config.monitor_interval_s
        membership_poll = 0.0
        while True:
            time.sleep(interval)
            result = self._monitor_workers()
            if result.state == WorkerState.SUCCEEDED:
                logger.info("node %s workers all succeeded",
                            self._config.node_rank)
                self._forward_progress()
                self._client.update_node_status(NodeStatus.SUCCEEDED)
                return 0
            if result.state == WorkerState.FAILED:
                if not self._handle_worker_failure(result):
                    return 1
                continue
            action, action_data = self._take_pending_action()
            if action == DiagnosisActionType.RESTART_WORKER:
                # wedged workers (the hang rule) never exit on SIGTERM:
                # kill them fast; a healthy group keeps the grace
                grace = (get_context().wedged_kill_grace_s
                         if action_data.get("wedged") else None)
                if action_data.get("wedged") and self._config.tpu_timer:
                    # the wedged workers' stacks and profile requests
                    # before they are killed
                    self._diagnosis.capture_evidence()
                # a master-made action carries the trace context of the
                # arc that caused it (fault.relaunch): join its trace
                carried = tracing.extract_wire(
                    action_data.get(tracing.WIRE_KEY))
                with tracing.activate(carried), tracing.span(
                        SpanName.AGENT_RESTART_WORKERS,
                        source=f"agent_{self._config.node_rank}",
                        reason=action_data.get("reason", "")):
                    self._restart_workers(
                        f"diagnosis action {action} "
                        f"({action_data.get('reason', '')})", grace_s=grace)
                continue
            if action == DiagnosisActionType.JOB_ABORT:
                logger.error("job abort action received")
                self._client.update_node_status(NodeStatus.FAILED,
                                                exit_reason="job_abort")
                return 1
            now = time.monotonic()
            if now - membership_poll >= 1.0:
                membership_poll = now
                if self._membership_changed():
                    self._restart_workers("membership changed")

    def _diagnose_training_failure(self, exit_codes: Dict[int, int]) -> str:
        """RESTART_WORKER in place, or RELAUNCH_WORKER: give up here (the
        diagnosis agent's rule, on this agent's restart budget)."""
        return self._diagnosis.diagnose_training_failure(
            exit_codes, self._remaining_restarts)

    def _peer_failed(self, exit_codes: Dict[int, int]) -> bool:
        """Whether another rank or node failed in this round: a local rank
        that exited otherwise than by a node-level signal, a node waiting
        to re-rendezvous, or the master's word that a peer node left the
        world (a queued RESTART_WORKER, taken here), awaited for the
        master's connection-drop grace and a margin."""
        if any(c not in _NODE_LEVEL_EXIT_CODES for c in exit_codes.values()):
            return True
        deadline = (time.monotonic() + get_context().conn_drop_grace_s
                    + _PEER_NEWS_MARGIN_S)
        while True:
            if any(w.proc.poll() not in (None, 0, *_NODE_LEVEL_EXIT_CODES)
                   for w in self._workers):
                return True
            try:
                self._handle_heartbeat_action(self._client.heartbeat(
                    global_step=self._last_global_step,
                    step_timestamp=self._last_step_ts,
                    rdzv_round=self._current_round))
            except (ConnectionError, RuntimeError):
                pass
            with self._action_lock:
                pending = self._pending_action
                if (pending is not None and pending[0]
                        == DiagnosisActionType.RESTART_WORKER):
                    self._pending_action = None
                    logger.info("abort follows a peer's failure: %s",
                                pending[1].get("reason", ""))
                    return True
            if self._membership_changed():
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.25)

    def _handle_worker_failure(self, result: RunResult) -> bool:
        """True when the workers were restarted, False to give up."""
        logger.warning("node %s worker failure(s): %s",
                       self._config.node_rank, result.failures)
        self._events.instant(AgentEvent.WORKER_FAIL,
                             failures=result.failures,
                             restart_count=self._restart_count)
        self._forward_progress()
        try:
            self._client.report_failure(
                error_data=str(result.failures),
                level=TrainingExceptionLevel.PROCESS_ERROR,
                restart_count=self._restart_count)
        except ConnectionError:
            pass
        if (self._diagnose_training_failure(result.failures)
                == DiagnosisActionType.RELAUNCH_WORKER):
            logger.error("giving up in-place restarts on node %s "
                         "(remaining=%s)", self._config.node_rank,
                         self._remaining_restarts)
            self._save_breakpoint_checkpoint("relaunch")
            self._client.update_node_status(
                NodeStatus.FAILED, exit_reason="relaunched",
                restart_count=self._restart_count)
            return False
        self._remaining_restarts -= 1
        self._restart_workers(f"worker failure {result.failures}")
        return True
