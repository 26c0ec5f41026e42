"""The master's RPC surface: training control plane and serving.

The port's copy of the part of ``dlrover_tpu/master/servicer.py`` its
agents, workers, replicas and routers call, each handler a named
``rpc_*`` method:

- rendezvous: ``join_rendezvous``, ``get_comm_world``,
  ``num_nodes_waiting``;
- KV and barriers: ``kv``, ``barrier``;
- liveness: ``update_node_status``, ``heartbeat`` (its reply carries the
  node's next queued diagnosis action; its op-class telemetry feeds the
  skew monitor and its memory ledgers the fleet memory monitor),
  ``report_failure`` (a worker fault, journaled as ``fault_detected``
  unless a recovery is already open), ``report_event`` (into the
  master's journal, arrival-stamped), ``report_resource_stats`` (into
  the job metric context the metric-stall rule reads),
  ``get_pre_check_result``, ``ping``;
- progress: ``report_global_step``;
- data shards: ``setup_dataset``, ``get_task``, ``report_task_result``,
  ``recover_shard_tasks`` and the shard checkpoint pair;
- launcher overrides: ``get_run_config``;
- serving: ``serve_register``, ``serve_deregister``, ``serve_replicas``.

Names and messages are the reference's, so the JAX package's agents,
workers and replicas talk to a port master and the reverse. ``heartbeat``
and ``serve_register`` stamp the caller's node id on the connection, so
the master notices the node's death when the connection drops. Not
ported: the network-check and straggler RPCs, the fan-in plane (and with
it the telemetry shedding under backpressure), the batched acks and
data-state export, the parallel-config tuner.
"""

import json
import time
from typing import Dict, Optional

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import (
    ConfigKey,
    NodeStatus,
    NodeType,
    env_str,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.metric import NodeMetrics, TpuMetric
from dlrover_tpu_torch.common.rpc import connection_ctx
from dlrover_tpu_torch.master.job_manager import JobManager
from dlrover_tpu_torch.master.kv_store import KVStoreService, SyncService
from dlrover_tpu_torch.observability.journal import (
    JournalEvent,
    recovery_open,
)


class MasterServicer:
    """Mount with ``RPCServer.register_object``."""

    def __init__(self, job_manager: JobManager, rdzv_managers: Dict,
                 kv_store: Optional[KVStoreService] = None,
                 sync_service: Optional[SyncService] = None,
                 task_manager=None, perf_monitor=None,
                 diagnosis_master=None, serve_registry=None,
                 event_journal=None, skew_monitor=None,
                 memory_monitor=None, metric_context=None):
        self._job_manager = job_manager
        self._rdzv_managers = rdzv_managers
        self._kv_store = kv_store or KVStoreService()
        self._sync_service = sync_service or SyncService()
        self._task_manager = task_manager
        self._perf_monitor = perf_monitor
        self._diagnosis_master = diagnosis_master
        self.serve_registry = serve_registry
        self._event_journal = event_journal
        self._skew_monitor = skew_monitor
        self._memory_monitor = memory_monitor
        self._metric_context = metric_context
        # node_id -> {"t": monotonic time of the last beat, "gauges"}
        self._beats: Dict[int, Dict] = {}
        # node_id -> rendezvous round -> what its beats carried
        self._beat_rounds: Dict[int, Dict[int, Dict]] = {}
        self._start_time = time.monotonic()

    def last_beat(self, node_id: int) -> Optional[Dict]:
        """The node's last beat ``{"t", "gauges"}``, or None."""
        beat = self._beats.get(node_id)
        return dict(beat) if beat is not None else None

    def beat_report(self) -> Dict[str, Dict[str, Dict]]:
        """``{node_id: {round: record}}`` (string keys, JSON-safe): per
        rendezvous round, the beats a node sent, those that reported a step
        and how many of these carried op telemetry and a memory ledger,
        and the last op telemetry its beats carried. The master serves it
        on ``GET /heartbeats``."""
        return {str(node): {str(rnd): dict(rec) for rnd, rec in rounds.items()}
                for node, rounds in list(self._beat_rounds.items())}

    def _note_beat(self, req) -> None:
        rec = self._beat_rounds.setdefault(req.node_id, {}).setdefault(
            req.rdzv_round, {"beats": 0, "stepped": 0,
                             "stepped_with_op_telemetry": 0,
                             "stepped_with_memory": 0,
                             "last_op_telemetry": {}})
        rec["beats"] += 1
        if req.global_step:
            # a reported step follows a worker's publish, which carries
            # both: every such beat should too
            rec["stepped"] += 1
            rec["stepped_with_op_telemetry"] += bool(req.op_telemetry)
            rec["stepped_with_memory"] += bool(req.memory)
        if req.op_telemetry:
            rec["last_op_telemetry"] = dict(req.op_telemetry)

    # -- rendezvous ----------------------------------------------------------

    def rpc_join_rendezvous(self, req: comm.JoinRendezvousRequest
                            ) -> comm.JoinRendezvousResponse:
        manager = self._rdzv_managers[req.rdzv_name]
        meta = comm.NodeMeta(
            node_id=req.node_id, node_rank=req.node_rank, host=req.host,
            local_world_size=req.local_world_size, free_port=req.free_port,
            slice_id=req.slice_id, tpu_worker_id=req.tpu_worker_id)
        rdzv_round = manager.join_rendezvous(meta)
        if self._perf_monitor is not None:
            self._perf_monitor.reset_running_speed_monitor(
                min_round=rdzv_round)
        return comm.JoinRendezvousResponse(round=rdzv_round)

    def rpc_get_comm_world(self, req: comm.CommWorldRequest
                           ) -> comm.CommWorldResponse:
        manager = self._rdzv_managers[req.rdzv_name]
        rdzv_round, group, world = manager.get_comm_world(req.node_id)
        return comm.CommWorldResponse(
            rdzv_name=req.rdzv_name, round=rdzv_round, group=group,
            world=world,
            coordinator_addr=manager.coordinator_addr() if world else "")

    def rpc_num_nodes_waiting(self, req: comm.WaitingNodeNumRequest
                              ) -> comm.WaitingNodeNumResponse:
        manager = self._rdzv_managers[req.rdzv_name]
        return comm.WaitingNodeNumResponse(
            waiting_num=manager.num_nodes_waiting())

    def rpc_report_event(self, req: comm.EventReport) -> comm.BaseResponse:
        """Append an agent's or worker's event to the master's journal;
        the master stamps the arrival time."""
        if self._event_journal is not None and req.kind:
            data = dict(req.data or {})
            # "source" is the journal's stamp of the reporter: a payload
            # key of that name must not shadow it
            if "source" in data:
                data["payload_source"] = data.pop("source")
            self._event_journal.record(req.kind,
                                       source=f"agent_{req.node_id}", **data)
        return comm.BaseResponse()

    # -- kv store / barrier --------------------------------------------------

    def rpc_kv(self, req: comm.KeyValueRequest) -> comm.KeyValueResponse:
        kv = self._kv_store
        if req.op == "set":
            kv.set(req.key, req.value)
            return comm.KeyValueResponse(found=True)
        if req.op == "get":
            value = kv.get(req.key)
            return comm.KeyValueResponse(found=value is not None,
                                         value=value or b"")
        if req.op == "add":
            new = kv.add(req.key, int(req.value or b"0"))
            return comm.KeyValueResponse(found=True, value=str(new).encode())
        if req.op == "wait":
            value = kv.wait(req.key, req.timeout_s or 60.0)
            return comm.KeyValueResponse(found=value is not None,
                                         value=value or b"")
        if req.op == "delete":
            kv.delete(req.key)
            return comm.KeyValueResponse(found=True)
        if req.op == "delete_prefix":
            n = kv.delete_prefix(req.key)
            return comm.KeyValueResponse(found=True, value=str(n).encode())
        if req.op == "multi_get":
            return comm.KeyValueResponse(found=True,
                                         values=kv.multi_get(req.keys))
        if req.op == "multi_set":
            kv.multi_set(req.keys, req.values)
            return comm.KeyValueResponse(found=True)
        raise ValueError(f"unknown kv op {req.op}")

    def rpc_barrier(self, req: comm.BarrierRequest) -> comm.BarrierResponse:
        return comm.BarrierResponse(passed=self._sync_service.join(
            req.barrier_name, req.node_rank, req.world_size, req.timeout_s))

    # -- node lifecycle ------------------------------------------------------

    def rpc_update_node_status(self, req: comm.NodeStatusRequest
                               ) -> comm.BaseResponse:
        self._job_manager.update_node_status(
            req.node_id, req.status, req.exit_reason, req.restart_count)
        if req.status in (NodeStatus.FAILED, NodeStatus.DELETED):
            for manager in self._rdzv_managers.values():
                manager.remove_alive_node(req.node_id)
        return comm.BaseResponse()

    def rpc_heartbeat(self, req: comm.HeartbeatRequest
                      ) -> comm.HeartbeatResponse:
        # bind this connection to the node: its loss is the node's death
        connection_ctx()["node_id"] = req.node_id
        # liveness first, then telemetry
        action = self._job_manager.report_heartbeat(req.node_id,
                                                    req.timestamp)
        self._beats[req.node_id] = {"t": time.monotonic(),
                                    "gauges": dict(req.gauges)}
        self._note_beat(req)
        if req.global_step and self._perf_monitor is not None:
            self._perf_monitor.collect_global_step(
                req.global_step, req.step_timestamp or time.time(),
                rdzv_round=req.rdzv_round)
        if self._diagnosis_master is not None:
            self._diagnosis_master.observe_heartbeat(req)
        if self._skew_monitor is not None and req.op_telemetry:
            self._skew_monitor.observe(req.node_id, req.op_telemetry)
        if self._memory_monitor is not None and req.memory:
            self._memory_monitor.observe(req.node_id, req.memory)
        if req.shard_acks and self._task_manager is not None:
            for r in req.shard_acks:
                self._task_manager.report_task_result(
                    r.dataset_name, r.task_id, r.node_id, r.success)
        return comm.HeartbeatResponse(
            action_type=action.action_type,
            action_data={"reason": action.reason, **action.data})

    def rpc_report_failure(self, req: comm.NodeFailureReport
                           ) -> comm.BaseResponse:
        """A worker failure an agent reports. Journaled as
        ``fault_detected`` when no recovery is open in the journal (no
        fault since the last ``step_resumed``): a single node's worker
        faults then open their incidents, and a worker that failed
        because a peer node died joins that node's incident."""
        self._job_manager.report_failure(req.node_id, req.error_data,
                                         req.level, req.restart_count)
        if (self._event_journal is not None
                and not recovery_open(self._event_journal)):
            self._event_journal.record(
                JournalEvent.FAULT_DETECTED, node_id=req.node_id,
                status="worker_failure", level=req.level,
                restart_count=req.restart_count,
                step=(self._perf_monitor.completed_global_step
                      if self._perf_monitor is not None else None))
        return comm.BaseResponse()

    def rpc_report_global_step(self, req: comm.GlobalStep
                               ) -> comm.BaseResponse:
        if self._perf_monitor is not None:
            self._perf_monitor.collect_global_step(
                req.step, req.timestamp or time.time(),
                rdzv_round=req.rdzv_round)
        return comm.BaseResponse()

    def rpc_report_resource_stats(self, req: comm.ResourceStats
                                  ) -> comm.BaseResponse:
        """A node's host and card usage: onto its node record (the stats
        collector reads it) and into the job metric context (the
        metric-stall rule reads it). A card with memory stats but no duty
        cycle keeps ``duty_cycle_pct=None``: absent telemetry is not 0%."""
        node = self._job_manager.get_node(req.node_id)
        node.used_resource.cpu = req.cpu_percent
        node.used_resource.memory_mb = req.mem_used_mb
        if req.device_util:
            node.used_resource.device_util = (
                sum(req.device_util.values()) / len(req.device_util))
        if self._metric_context is not None:
            self._metric_context.add_node_metrics(NodeMetrics(
                node_id=req.node_id, cpu_percent=req.cpu_percent,
                mem_used_mb=req.mem_used_mb,
                devices=[
                    TpuMetric(
                        device_id=d,
                        duty_cycle_pct=req.device_util.get(d),
                        hbm_used_mb=req.device_mem_mb.get(d, 0.0),
                        hbm_total_mb=req.device_mem_total_mb.get(d, 0.0))
                    for d in sorted(set(req.device_util)
                                    | set(req.device_mem_mb))]))
        return comm.BaseResponse()

    def rpc_get_pre_check_result(self, req: comm.PreCheckRequest
                                 ) -> comm.PreCheckResponse:
        # polling proves the node scheduled and connected
        self._job_manager.record_node_contact(req.node_id)
        if self._diagnosis_master is None:
            return comm.PreCheckResponse(status="pass")
        status, reason = self._diagnosis_master.pre_check_status()
        return comm.PreCheckResponse(status=status, reason=reason)

    # -- data shards ---------------------------------------------------------

    def rpc_get_task(self, req: comm.TaskRequest) -> comm.TaskMessage:
        if self._task_manager is None:
            return comm.TaskMessage(task_id=-1)
        task = self._task_manager.get_task(req.node_id, req.dataset_name)
        if task is None:
            return comm.TaskMessage(task_id=-1,
                                    dataset_name=req.dataset_name)
        return task

    def rpc_report_task_result(self, req: comm.TaskResult
                               ) -> comm.BaseResponse:
        if self._task_manager is not None:
            self._task_manager.report_task_result(
                req.dataset_name, req.task_id, req.node_id, req.success)
        return comm.BaseResponse()

    def rpc_setup_dataset(self, req: comm.DatasetShardParams
                          ) -> comm.BaseResponse:
        if self._task_manager is None:
            return comm.BaseResponse(success=False,
                                     message="no task manager")
        self._task_manager.new_dataset(req)
        return comm.BaseResponse()

    def rpc_get_shard_checkpoint(self, req: comm.ShardCheckpointRequest
                                 ) -> comm.ShardCheckpointResponse:
        if self._task_manager is None:
            return comm.ShardCheckpointResponse()
        return comm.ShardCheckpointResponse(
            content=self._task_manager.get_shard_checkpoint(
                req.dataset_name))

    def rpc_restore_shard_checkpoint(self, req: comm.ShardCheckpointResponse
                                     ) -> comm.BaseResponse:
        if self._task_manager is not None:
            self._task_manager.restore_shard_checkpoint(req.content)
        return comm.BaseResponse()

    def rpc_recover_shard_tasks(self, req: comm.TaskRequest
                                ) -> comm.BaseResponse:
        """Requeue every lease a node holds (the agent calls it around a
        worker restart)."""
        if self._task_manager is not None:
            self._task_manager.recover_tasks(req.node_id)
        return comm.BaseResponse()

    # -- config --------------------------------------------------------------

    def rpc_get_run_config(self, req) -> comm.BaseResponse:
        """Launcher overrides from ``DLROVER_TPU_RUN_CONFIG`` on the
        master: a JSON object of ElasticLaunchConfig fields."""
        raw = env_str(ConfigKey.RUN_CONFIG)
        overrides = {}
        if raw:
            try:
                overrides = json.loads(raw)
            except ValueError:
                logger.warning("bad DLROVER_TPU_RUN_CONFIG %r ignored", raw)
        return comm.BaseResponse(data=overrides)

    def rpc_ping(self, req) -> comm.BaseResponse:
        return comm.BaseResponse(
            data={"uptime": time.monotonic() - self._start_time})

    # -- serving -------------------------------------------------------------

    def rpc_serve_register(self, req: comm.ServeRegisterRequest
                           ) -> comm.BaseResponse:
        """A decode replica joins: its node is typed SERVE (its death
        leaves the routable set, it does not re-form the world) and made a
        live member of the liveness plane."""
        connection_ctx()["node_id"] = req.node_id
        self._job_manager.get_node(req.node_id).type = NodeType.SERVE
        self._job_manager.record_node_contact(req.node_id, running=True)
        epoch = self.serve_registry.register(req.node_id, req.addr,
                                             req.slots)
        return comm.BaseResponse(data={"epoch": epoch})

    def rpc_serve_deregister(self, req: comm.ServeDeregisterRequest
                             ) -> comm.BaseResponse:
        self.serve_registry.deregister(req.node_id, reason=req.reason)
        # a drained replica's exit is a planned leave, not a death
        self._job_manager.update_node_status(
            req.node_id, NodeStatus.DELETED, exit_reason=req.reason)
        return comm.BaseResponse()

    def rpc_serve_replicas(self, req: comm.BaseRequest
                           ) -> comm.ServeReplicasResponse:
        return comm.ServeReplicasResponse(
            replicas=[comm.ServeReplicaInfo(node_id=r["node_id"],
                                            addr=r["addr"], slots=r["slots"])
                      for r in self.serve_registry.live()],
            epoch=self.serve_registry.epoch)


def start_master(host: str = "127.0.0.1", port: int = 0):
    """A master on its own :class:`RPCServer`, started: ``(server,
    servicer)``; ``f"{host}:{server.port}"`` is its address."""
    from dlrover_tpu_torch.master.master import LocalJobMaster

    master = LocalJobMaster(host=host, port=port, node_num=0)
    master.prepare()
    return master.server, master.servicer
