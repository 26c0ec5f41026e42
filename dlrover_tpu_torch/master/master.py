"""The job master: its planes wired behind one RPC server.

The port's copy of ``JobMaster`` and ``LocalJobMaster`` from
``dlrover_tpu/master/master.py``, trimmed to wiring the planes this slice
ported: the job manager (node table, liveness, actions), the training
rendezvous, the KV store and barriers, the perf monitor, the hang rule,
the shard ledger and the serve registry. Two hooks make faults visible:

- a closed heartbeat connection reports the node's loss to the job
  manager, which fails it after the grace;
- a failed or deleted training node has its shard leases requeued, leaves
  every rendezvous waiting set, and every other running training node is
  told to restart its workers (a ``RESTART_WORKER`` action on its next
  heartbeat), so the survivors re-form the world at once. A failed serving
  node leaves the routable set instead.

``run`` blocks until the job succeeds or fails. Not ported: the brain,
fan-in, autoscaler, journal, tracing, state snapshots, the HTTP transport
and the network-check rendezvous.
"""

import time
from typing import Dict, Optional

from dlrover_tpu_torch.common.constants import (
    DiagnosisActionType,
    JobStage,
    NodeStatus,
    NodeType,
    RendezvousName,
)
from dlrover_tpu_torch.common.log import logger
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
from dlrover_tpu_torch.master.task_manager import TaskManager
from dlrover_tpu_torch.serving.registry import ServeReplicaRegistry


class JobMaster:
    def __init__(self, job_name: str = "local", port: int = 0,
                 node_num: int = 1, min_nodes: Optional[int] = None,
                 max_nodes: Optional[int] = None, node_unit: int = 1,
                 host: str = "0.0.0.0"):
        self.job_name = job_name
        self.job_manager = JobManager(
            job_name, node_num,
            min_nodes=node_num if min_nodes is None else min_nodes)
        self.perf_monitor = PerfMonitor()
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
        self.diagnosis_master = DiagnosisMaster(self.job_manager,
                                                self.perf_monitor)
        self.serve_registry = ServeReplicaRegistry()
        self.servicer = MasterServicer(
            job_manager=self.job_manager, rdzv_managers=self.rdzv_managers,
            kv_store=self.kv_store, sync_service=self.sync_service,
            task_manager=self.task_manager, perf_monitor=self.perf_monitor,
            diagnosis_master=self.diagnosis_master,
            serve_registry=self.serve_registry)
        self._server = RPCServer(host=host, port=port)
        self._server.register_object(self.servicer)
        self._server.set_on_disconnect(
            lambda ctx: self.job_manager.report_connection_lost(
                ctx["node_id"]) if "node_id" in ctx else None)
        self._server.set_on_contact(
            lambda ctx: self.job_manager.record_raw_contact(
                ctx["node_id"]) if "node_id" in ctx else None)
        self.job_manager.add_event_callback(self._on_node_event)

    def _on_node_event(self, event) -> None:
        node = event.node
        if node.status not in (NodeStatus.FAILED, NodeStatus.DELETED,
                               NodeStatus.BREAKDOWN):
            return
        if node.type == NodeType.SERVE:
            # a replica's death is a serving event: it leaves the routable
            # set and must not restart the training world
            self.serve_registry.deregister(node.id)
            self.task_manager.recover_tasks(node.id)
            return
        self.task_manager.recover_tasks(node.id)
        for manager in self.rdzv_managers.values():
            manager.remove_alive_node(node.rank)
        for peer in self.job_manager.list_nodes():
            if (peer.id != node.id and peer.status == NodeStatus.RUNNING
                    and peer.type != NodeType.SERVE):
                self.job_manager.enqueue_action(DiagnosisAction(
                    DiagnosisActionType.RESTART_WORKER, instance=peer.id,
                    reason=f"peer node {node.id} left the world"))

    @property
    def server(self) -> RPCServer:
        return self._server

    @property
    def port(self) -> int:
        return self._server.port

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"

    def prepare(self) -> None:
        self._server.start()
        self.job_manager.start()
        self.task_manager.start()
        self.diagnosis_master.start()
        logger.info("master for job %s serving on port %s", self.job_name,
                    self.port)

    def stop(self) -> None:
        self.job_manager.stop()
        self.task_manager.stop()
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
