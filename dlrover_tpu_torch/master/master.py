"""The job master: its planes wired behind one RPC server.

The port's copy of ``JobMaster`` and ``LocalJobMaster`` from
``dlrover_tpu/master/master.py``, trimmed to wiring the planes the port
has: the job manager (node table, liveness, actions), the training
rendezvous, the KV store and barriers, the perf monitor, the hang rule,
the shard ledger, the serve registry and the event journal
(``event_journal``, with its goodput gauges on the process registry).
Two hooks make faults visible:

- a closed heartbeat connection reports the node's loss to the job
  manager, which fails it after the grace;
- a failed or deleted training node is journaled (``fault_detected``),
  has its shard leases requeued, leaves every rendezvous waiting set, and
  every other running training node is told to restart its workers (a
  ``RESTART_WORKER`` action on its next heartbeat), so the survivors
  re-form the world at once. A failed serving node leaves the routable
  set instead (``serve_replica_lost``), and the serving autoscaler
  (``master/auto_scaler.py``, driven by whoever runs the serving plane)
  restores the count.

An injector configured before the master is made journals every fault it
fires as ``fault_injected`` and captures a (rate-limited) bundle.

Observability: a training node's failure opens a ``fault.relaunch`` span
whose context rides down in every restart action's data, so each
survivor's ``agent.restart_workers`` joins its trace, and its
``fault_detected`` record carries the ``trace_id``. The flight recorder
captures a ``node_fault`` bundle after a failed node has been handled (a
replica's after the serve registry dropped it, so a bundle never delays
the re-route). With ``DLROVER_TPU_HTTP_PORT`` set (0: a free port) an
:class:`HTTPTransportServer` serves the servicer's methods over ``POST
/rpc`` and ``GET /metrics``, ``/events``, ``/debug/bundle`` and
``/incidents``, ``/memory`` and ``/heartbeats`` (what each node's beats
carried, per rendezvous round). ``stop`` takes the journal's, the
recorder's and the incident stitcher's collect hooks off the registry.
``run`` blocks until the job succeeds or fails.

Attribution and device memory: the agents' beats feed the
:class:`SkewMonitor` (straggler and hang verdicts, journaled and gauged;
its straggler history biases the training rendezvous's world cut and its
verdicts drive the straggler rule's ``STACK_DUMP``; a failed node's
windows are dropped) and the
:class:`FleetMemoryMonitor` (the min-headroom rank, ``GET /memory``);
the master's own :class:`MemoryAccountant` journals into its journal and
captures a ``memory_pressure`` bundle on a breach, and every bundle holds
``memory.json`` (the master's ledger and the fleet view). Resource
reports land in the job metric context the metric-stall rule reads, and
a :class:`JobMetricCollector` snapshots the job every 15 s.

The training rendezvous carries a :class:`ReshardCoordinator`
(``ckpt/reshard.py``): a world cut whose node set changed publishes the
cut record in the KV store that the new world's workers key their live
reshard on (the decomposition kept: no planner), journaled
``reshard_planned``.

Not ported: the brain (and ``/brain``, and with it the pre-scale guard
that reads the fleet headroom, ROADMAP A14), straggler-driven shard
stealing (A13), fan-in, state snapshots, the network-check rendezvous,
and starting the training auto-scaler from the master itself.
"""

import json
import time
from typing import Dict, Optional

from dlrover_tpu_torch.chaos import get_injector
from dlrover_tpu_torch.common.constants import (
    ConfigKey,
    DiagnosisActionType,
    JobStage,
    NodeStatus,
    NodeType,
    RendezvousName,
    SpanName,
    env_str,
)
from dlrover_tpu_torch.common.http_server import HTTPTransportServer
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.metric import JobMetricContext
from dlrover_tpu_torch.common.rpc import RPCServer
from dlrover_tpu_torch.diagnosis.action import DiagnosisAction
from dlrover_tpu_torch.diagnosis.diagnosis_master import DiagnosisMaster
from dlrover_tpu_torch.master.job_manager import JobManager
from dlrover_tpu_torch.master.kv_store import KVStoreService, SyncService
from dlrover_tpu_torch.master.perf_monitor import PerfMonitor
from dlrover_tpu_torch.master.rdzv_manager import (
    ElasticTrainingRendezvousManager,
    RendezvousManager,
)
from dlrover_tpu_torch.master.servicer import MasterServicer
from dlrover_tpu_torch.master.skew_monitor import SkewMonitor
from dlrover_tpu_torch.master.stats import JobMetricCollector
from dlrover_tpu_torch.master.task_manager import TaskManager
from dlrover_tpu_torch.observability import tracing
from dlrover_tpu_torch.observability.flight_recorder import (
    REASON_MEMORY,
    REASON_NODE_FAULT,
    FlightRecorder,
)
from dlrover_tpu_torch.observability.incidents import IncidentStitcher
from dlrover_tpu_torch.observability.journal import (
    EventJournal,
    JournalEvent,
    Phase,
)
from dlrover_tpu_torch.observability.memory import (
    FleetMemoryMonitor,
    MemoryAccountant,
    get_accountant,
    set_accountant,
)
from dlrover_tpu_torch.observability.registry import get_registry
from dlrover_tpu_torch.serving.registry import ServeReplicaRegistry


class JobMaster:
    def __init__(self, job_name: str = "local", port: int = 0,
                 node_num: int = 1, min_nodes: Optional[int] = None,
                 max_nodes: Optional[int] = None, node_unit: int = 1,
                 host: str = "0.0.0.0"):
        self.job_name = job_name
        # one authoritative event sequence, with its phase attribution
        # exported into the process registry
        self.event_journal = EventJournal()
        self.metrics_registry = get_registry()
        self._gauge_hook = self.event_journal.attach_gauges(
            self.metrics_registry)
        # post-mortem bundles on node faults, injected faults and
        # GET /debug/bundle; per-recovery incidents from the journal
        self.flight_recorder = FlightRecorder(
            source="master", journal=self.event_journal,
            registry=self.metrics_registry,
            memory_snapshot_fn=self._memory_snapshot)
        self.perf_monitor = PerfMonitor()
        self.incident_stitcher = IncidentStitcher(
            self.event_journal, step_time_fn=self._step_time_s)
        self._incident_hook = self.incident_stitcher.attach_metrics(
            self.metrics_registry)
        self.job_manager = JobManager(
            job_name, node_num,
            min_nodes=node_num if min_nodes is None else min_nodes)
        self.task_manager = TaskManager()
        self.kv_store = KVStoreService()
        self.sync_service = SyncService()
        self.rdzv_managers: Dict[str, RendezvousManager] = {
            RendezvousName.TRAINING: ElasticTrainingRendezvousManager(),
        }
        min_n = node_num if min_nodes is None else min_nodes
        max_n = node_num if max_nodes is None else max_nodes
        for manager in self.rdzv_managers.values():
            manager.update_rdzv_params(min_n, max_n, node_unit=node_unit)
        # cross-worker skew and hang attribution over the op telemetry
        # the beats carry; its straggler history biases the world cut
        self.skew_monitor = SkewMonitor(event_journal=self.event_journal,
                                        registry=self.metrics_registry)
        self.rdzv_managers[RendezvousName.TRAINING].straggler_history = (
            self.skew_monitor.node_straggler_counts)
        # the live-reshard plane: a training cut whose node set changed
        # publishes the cut record (no planner: the decomposition stays)
        from dlrover_tpu_torch.ckpt.reshard import ReshardCoordinator

        self.rdzv_managers[RendezvousName.TRAINING].reshard_coordinator = (
            ReshardCoordinator(
                job_name, self.kv_store, journal=self.event_journal,
                progress=self.perf_monitor.steps_since_round))
        # the fleet's memory ledgers (min-headroom rank, GET /memory), and
        # the master's own accountant journaling into this journal with a
        # breach hook that writes an OOM-forensics bundle
        self.memory_monitor = FleetMemoryMonitor(
            event_journal=self.event_journal,
            registry=self.metrics_registry)
        self._accountant = set_accountant(MemoryAccountant(
            journal=self.event_journal, registry=self.metrics_registry,
            source="master",
            breach_hook=lambda data: self.flight_recorder.capture(
                REASON_MEMORY, extra=data)))
        self.metric_context = JobMetricContext()
        self.metric_collector = JobMetricCollector(
            self.job_manager, self.perf_monitor,
            goodput_fn=self._journal_goodput)
        self.diagnosis_master = DiagnosisMaster(
            self.job_manager, self.perf_monitor,
            metric_context=self.metric_context,
            skew_monitor=self.skew_monitor,
            event_journal=self.event_journal)
        self.serve_registry = ServeReplicaRegistry(
            event_journal=self.event_journal,
            registry=self.metrics_registry)
        self.servicer = MasterServicer(
            job_manager=self.job_manager, rdzv_managers=self.rdzv_managers,
            kv_store=self.kv_store, sync_service=self.sync_service,
            task_manager=self.task_manager, perf_monitor=self.perf_monitor,
            diagnosis_master=self.diagnosis_master,
            serve_registry=self.serve_registry,
            event_journal=self.event_journal,
            skew_monitor=self.skew_monitor,
            memory_monitor=self.memory_monitor,
            metric_context=self.metric_context)
        self._server = RPCServer(host=host, port=port)
        self._server.register_object(self.servicer)
        self._server.set_on_disconnect(
            lambda ctx: self.job_manager.report_connection_lost(
                ctx["node_id"]) if "node_id" in ctx else None)
        self._server.set_on_contact(
            lambda ctx: self.job_manager.record_raw_contact(
                ctx["node_id"]) if "node_id" in ctx else None)
        self.job_manager.add_event_callback(self._on_node_event)
        # a drill's injected faults land in the journal, so its event
        # sequence is complete and reproducible from the seed
        inj = get_injector()
        if inj is not None:
            inj.set_reporter(self.flight_recorder.wrap_fault_reporter(
                lambda event: self.event_journal.record(
                    JournalEvent.FAULT_INJECTED, source="chaos", **event)))
            logger.info("fault injection active on master: %s",
                        inj.describe())
        self._http_server = self._make_http_server()

    def _make_http_server(self) -> Optional[HTTPTransportServer]:
        """The HTTP transport and scrape routes, when
        ``DLROVER_TPU_HTTP_PORT`` is set (0: a free port)."""
        http_port = env_str(ConfigKey.HTTP_PORT)
        if not http_port:
            return None
        try:
            server = HTTPTransportServer(port=int(http_port))
        except ValueError:
            logger.warning("DLROVER_TPU_HTTP_PORT=%r is not a port; http "
                           "transport disabled", http_port)
            return None
        server.register_object(self.servicer)
        server.add_get_route("/metrics", lambda: (
            "text/plain; version=0.0.4; charset=utf-8",
            self.metrics_registry.render()))
        server.add_get_route("/events", lambda: (
            "application/json", self.event_journal.to_json()))
        server.add_get_route("/debug/bundle",
                             self.flight_recorder.http_handler())
        server.add_get_route("/incidents", lambda: (
            "application/json", self.incident_stitcher.to_json()))
        server.add_get_route("/memory", lambda: (
            "application/json", json.dumps(self.memory_monitor.status())))
        server.add_get_route("/heartbeats", lambda: (
            "application/json", json.dumps(self.servicer.beat_report())))
        return server

    def _memory_snapshot(self) -> dict:
        """A bundle's ``memory.json``: the master process's own ledger and
        the fleet view (per-rank headroom)."""
        snap = get_accountant().snapshot()
        monitor = getattr(self, "memory_monitor", None)
        if monitor is not None:
            snap["fleet"] = monitor.status()
        return snap

    def _journal_goodput(self) -> float:
        """The productive share of the journal's wall time."""
        now_t = self.event_journal.now()
        if now_t <= 0:
            return 1.0
        return (self.event_journal.phase_seconds(now_t)
                .get(Phase.PRODUCTIVE, 0.0) / now_t)

    def _step_time_s(self) -> Optional[float]:
        """Seconds a step from the perf monitor's running speed."""
        speed = self.perf_monitor.running_speed()
        return 1.0 / speed if speed and speed > 0 else None

    def _on_node_event(self, event) -> None:
        node = event.node
        if node.status not in (NodeStatus.FAILED, NodeStatus.DELETED,
                               NodeStatus.BREAKDOWN):
            return
        if node.type == NodeType.SERVE:
            # a replica's death is a serving event: it leaves the routable
            # set and must not restart the training world; the bundle
            # comes after the drop, so it never delays the re-route
            if self.serve_registry.on_node_lost(node.id):
                self.task_manager.recover_tasks(node.id)
                self.flight_recorder.capture(
                    REASON_NODE_FAULT,
                    extra={"node_id": node.id, "status": node.status,
                           "role": "serve"})
            return
        # one trace roots the detect → relaunch arc; its context rides
        # down to every survivor inside the restart action
        with tracing.span(SpanName.FAULT_RELAUNCH, source="master",
                          node_id=node.id, status=node.status) as fspan:
            self.task_manager.recover_tasks(node.id)
            self.event_journal.record(
                JournalEvent.FAULT_DETECTED, node_id=node.id,
                status=node.status,
                step=self.perf_monitor.completed_global_step,
                trace_id=fspan.trace_id)
            for manager in self.rdzv_managers.values():
                manager.remove_alive_node(node.rank)
            # its ranks' stalled counters must not read as a hang
            self.skew_monitor.forget_node(node.id)
            carry = tracing.inject_wire()
            for peer in self.job_manager.list_nodes():
                if (peer.id != node.id and peer.status == NodeStatus.RUNNING
                        and peer.type != NodeType.SERVE):
                    self.job_manager.enqueue_action(DiagnosisAction(
                        DiagnosisActionType.RESTART_WORKER,
                        instance=peer.id,
                        reason=f"peer node {node.id} left the world",
                        data=({tracing.WIRE_KEY: carry}
                              if carry is not None else None)))
        self.flight_recorder.capture(
            REASON_NODE_FAULT,
            extra={"node_id": node.id, "status": node.status})

    @property
    def server(self) -> RPCServer:
        return self._server

    @property
    def port(self) -> int:
        return self._server.port

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"

    @property
    def http_port(self) -> Optional[int]:
        """The HTTP server's port, or None when it is off."""
        return (self._http_server.port if self._http_server is not None
                else None)

    def prepare(self) -> None:
        self._server.start()
        if self._http_server is not None:
            self._http_server.start()
        self.job_manager.start()
        self.task_manager.start()
        self.metric_collector.start()
        self.diagnosis_master.start()
        logger.info("master for job %s serving on port %s", self.job_name,
                    self.port)

    def stop(self) -> None:
        self.metrics_registry.remove_collect_hook(self._gauge_hook)
        self.metrics_registry.remove_collect_hook(self._incident_hook)
        self._accountant.close()
        self.flight_recorder.close()
        if self._http_server is not None:
            self._http_server.stop()
        self.job_manager.stop()
        self.task_manager.stop()
        self.metric_collector.stop()
        self.diagnosis_master.stop()
        self._server.stop()

    def run(self, poll_s: float = 1.0) -> int:
        """Block until the job finishes: 0 on success, 1 on failure."""
        try:
            while True:
                stage = self.job_manager.job_stage
                if stage == JobStage.SUCCEEDED:
                    logger.info("job %s succeeded", self.job_name)
                    return 0
                if stage == JobStage.FAILED:
                    logger.error("job %s failed", self.job_name)
                    return 1
                time.sleep(poll_s)
        finally:
            self.stop()


class LocalJobMaster(JobMaster):
    """The in-process master of standalone mode and the tests."""
