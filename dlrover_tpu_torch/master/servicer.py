"""The master's RPC surface: training control plane and serving.

The port's copy of the part of ``dlrover_tpu/master/servicer.py`` its
agents, workers, replicas and routers call, each handler a named
``rpc_*`` method:

- rendezvous: ``join_rendezvous``, ``get_comm_world``,
  ``num_nodes_waiting``;
- KV and barriers: ``kv``, ``barrier``;
- liveness: ``update_node_status``, ``heartbeat`` (its reply carries the
  node's next queued diagnosis action), ``report_failure``, ``report_event``,
  ``report_resource_stats``, ``get_pre_check_result``, ``ping``;
- progress: ``report_global_step``;
- data shards: ``setup_dataset``, ``get_task``, ``report_task_result``,
  ``recover_shard_tasks`` and the shard checkpoint pair;
- launcher overrides: ``get_run_config``;
- serving: ``serve_register``, ``serve_deregister``, ``serve_replicas``.

Names and messages are the reference's, so the JAX package's agents,
workers and replicas talk to a port master and the reverse. ``heartbeat``
and ``serve_register`` stamp the caller's node id on the connection, so
the master notices the node's death when the connection drops. Not
ported: the network-check and straggler RPCs, the fan-in plane, the
batched acks and data-state export, the parallel-config tuner.
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
from dlrover_tpu_torch.common.rpc import connection_ctx
from dlrover_tpu_torch.master.job_manager import JobManager
from dlrover_tpu_torch.master.kv_store import KVStoreService, SyncService


class MasterServicer:
    """Mount with ``RPCServer.register_object``."""

    def __init__(self, job_manager: JobManager, rdzv_managers: Dict,
                 kv_store: Optional[KVStoreService] = None,
                 sync_service: Optional[SyncService] = None,
                 task_manager=None, perf_monitor=None,
                 diagnosis_master=None, serve_registry=None):
        self._job_manager = job_manager
        self._rdzv_managers = rdzv_managers
        self._kv_store = kv_store or KVStoreService()
        self._sync_service = sync_service or SyncService()
        self._task_manager = task_manager
        self._perf_monitor = perf_monitor
        self._diagnosis_master = diagnosis_master
        self.serve_registry = serve_registry
        # node_id -> {"t": monotonic time of the last beat, "gauges"}
        self._beats: Dict[int, Dict] = {}
        self._start_time = time.monotonic()

    def last_beat(self, node_id: int) -> Optional[Dict]:
        """The node's last beat ``{"t", "gauges"}``, or None."""
        beat = self._beats.get(node_id)
        return dict(beat) if beat is not None else None

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
        """Logged: the port's master keeps no journal (not ported)."""
        logger.debug("event %s from node %s: %s", req.kind, req.node_id,
                     req.data)
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
        if req.global_step and self._perf_monitor is not None:
            self._perf_monitor.collect_global_step(
                req.global_step, req.step_timestamp or time.time(),
                rdzv_round=req.rdzv_round)
        if self._diagnosis_master is not None:
            self._diagnosis_master.observe_heartbeat(req)
        if req.shard_acks and self._task_manager is not None:
            for r in req.shard_acks:
                self._task_manager.report_task_result(
                    r.dataset_name, r.task_id, r.node_id, r.success)
        return comm.HeartbeatResponse(
            action_type=action.action_type,
            action_data={"reason": action.reason, **action.data})

    def rpc_report_failure(self, req: comm.NodeFailureReport
                           ) -> comm.BaseResponse:
        self._job_manager.report_failure(req.node_id, req.error_data,
                                         req.level, req.restart_count)
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
        """Accepted and dropped: the port's master keeps no resource
        metrics (they feed the reference's tuners, not ported)."""
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
        self.serve_registry.deregister(req.node_id)
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
