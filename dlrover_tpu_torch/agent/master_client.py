"""The agent's, the worker's and the serving replica's client of the
master RPC.

The port's copy of ``dlrover_tpu/agent/master_client.py``, trimmed to the
calls the port makes: the agent's (rendezvous, node status, heartbeats,
failures, events, pre-check, run config, shard-lease recovery), the
worker's (steps, KV, barrier, data shards) and a decode replica's
(``serve_*``, ``heartbeat``). Method names and messages on the wire are
the reference's, so either package's master serves either package's
clients. The rendezvous calls retry patiently, a heartbeat gives up fast
(a beat that cannot get through is a signal), an event is one attempt.
The transport comes from the address (``make_rpc_client``):
``http://host:port`` speaks HTTP, a bare ``host:port`` the binary
framing. ``join_rendezvous`` and ``get_comm_world`` are ``rdzv.join`` and
``rdzv.world_wait`` spans, whose context the frames carry to the master.
"""

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import (
    EnvKey,
    SpanName,
    env_int,
    env_str,
)
from dlrover_tpu_torch.common.http_server import make_rpc_client
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.observability import tracing

# retry budgets: a rendezvous rides out a slow master, a heartbeat fails
# fast, telemetry is one attempt
_RDZV_RETRIES = 60
_HEARTBEAT_RETRIES = 2


class MasterClient:
    _instance: Optional["MasterClient"] = None
    _lock = threading.Lock()

    def __init__(self, master_addr: str, node_id: int = 0,
                 node_rank: Optional[int] = None):
        self._client = make_rpc_client(master_addr)
        self._node_id = node_id
        self._node_rank = node_id if node_rank is None else node_rank

    @property
    def master_addr(self) -> str:
        return self._client.addr

    @property
    def node_id(self) -> int:
        return self._node_id

    # -- rendezvous ----------------------------------------------------------

    def join_rendezvous(self, rdzv_name: str, node_rank: int,
                        local_world_size: int, host: str = "",
                        free_port: int = 0, node_unit: int = 1) -> int:
        with tracing.span(SpanName.RDZV_JOIN,
                          source=f"agent_{self._node_id}",
                          rdzv_name=rdzv_name, node_rank=node_rank):
            resp = self._client.call(
                "join_rendezvous",
                comm.JoinRendezvousRequest(
                    node_id=self._node_id, node_rank=node_rank,
                    local_world_size=local_world_size, rdzv_name=rdzv_name,
                    node_unit=node_unit, host=host, free_port=free_port),
                retries=_RDZV_RETRIES)
        return resp.round

    def get_comm_world(self, rdzv_name: str, node_rank: int
                       ) -> Tuple[int, int, Dict[int, comm.NodeMeta], str]:
        with tracing.span(SpanName.RDZV_WORLD_WAIT,
                          source=f"agent_{self._node_id}",
                          rdzv_name=rdzv_name, node_rank=node_rank):
            resp = self._client.call(
                "get_comm_world",
                comm.CommWorldRequest(node_id=node_rank,
                                      rdzv_name=rdzv_name),
                retries=_RDZV_RETRIES)
        return resp.round, resp.group, resp.world, resp.coordinator_addr

    def num_nodes_waiting(self, rdzv_name: str) -> int:
        resp = self._client.call(
            "num_nodes_waiting",
            comm.WaitingNodeNumRequest(node_id=self._node_id,
                                       rdzv_name=rdzv_name),
            retries=_HEARTBEAT_RETRIES)
        return resp.waiting_num

    def barrier(self, name: str, node_rank: int, world_size: int,
                timeout_s: float = 300.0) -> bool:
        resp = self._client.call(
            "barrier",
            comm.BarrierRequest(barrier_name=name, node_rank=node_rank,
                                world_size=world_size, timeout_s=timeout_s),
            retries=_RDZV_RETRIES)
        return resp.passed

    # -- node lifecycle ------------------------------------------------------

    def update_node_status(self, status: str, exit_reason: str = "",
                           restart_count: int = 0) -> None:
        self._client.call(
            "update_node_status",
            comm.NodeStatusRequest(node_id=self._node_id, status=status,
                                   exit_reason=exit_reason,
                                   restart_count=restart_count))

    def report_failure(self, error_data: str, level: str,
                       restart_count: int = 0) -> None:
        self._client.call(
            "report_failure",
            comm.NodeFailureReport(node_id=self._node_id,
                                   error_data=error_data, level=level,
                                   restart_count=restart_count))

    def report_event(self, kind: str, data: Optional[Dict[str, Any]] = None
                     ) -> None:
        """Append an event to the master's record; one attempt, failures
        swallowed."""
        try:
            self._client.call(
                "report_event",
                comm.EventReport(node_id=self._node_id, kind=kind,
                                 data=data or {}),
                retries=1)
        except Exception:  # noqa: BLE001 — telemetry must not stall us
            logger.debug("report_event %r dropped", kind, exc_info=True)

    def get_pre_check_result(self) -> Tuple[str, str]:
        resp = self._client.call(
            "get_pre_check_result",
            comm.PreCheckRequest(node_id=self._node_id))
        return resp.status, resp.reason

    def get_run_config(self) -> Dict:
        resp = self._client.call("get_run_config", comm.BaseRequest())
        return resp.data or {}

    def ping(self) -> bool:
        try:
            self._client.call("ping", comm.BaseRequest(), retries=1)
            return True
        except (ConnectionError, OSError, RuntimeError):
            return False

    # -- data shards ---------------------------------------------------------

    def setup_dataset(self, params: comm.DatasetShardParams) -> bool:
        return self._client.call("setup_dataset", params).success

    def get_task(self, dataset_name: str) -> comm.TaskMessage:
        return self._client.call(
            "get_task", comm.TaskRequest(dataset_name=dataset_name,
                                         node_id=self._node_id))

    def report_task_result(self, dataset_name: str, task_id: int,
                           success: bool = True) -> None:
        self._client.call(
            "report_task_result",
            comm.TaskResult(dataset_name=dataset_name, task_id=task_id,
                            node_id=self._node_id, success=success))

    def get_shard_checkpoint(self, dataset_name: str) -> str:
        return self._client.call(
            "get_shard_checkpoint",
            comm.ShardCheckpointRequest(dataset_name=dataset_name)).content

    def restore_shard_checkpoint(self, content: str) -> None:
        self._client.call("restore_shard_checkpoint",
                          comm.ShardCheckpointResponse(content=content))

    def recover_shard_tasks(self) -> None:
        """Requeue this node's shard leases (around a worker restart)."""
        self._client.call("recover_shard_tasks",
                          comm.TaskRequest(node_id=self._node_id))

    # -- progress --------------------------------------------------------------

    def report_global_step(self, step: int, timestamp: float = 0.0,
                           retries: Optional[int] = None,
                           rdzv_round: int = -1) -> None:
        self._client.call(
            "report_global_step",
            comm.GlobalStep(node_id=self._node_id, step=step,
                            timestamp=timestamp or time.time(),
                            rdzv_round=rdzv_round),
            retries=retries)

    def kv_set(self, key: str, value: bytes) -> None:
        self._client.call("kv", comm.KeyValueRequest(op="set", key=key,
                                                     value=value))

    def kv_add(self, key: str, delta: int) -> int:
        resp = self._client.call("kv", comm.KeyValueRequest(
            op="add", key=key, value=str(delta).encode()))
        return int(resp.value)

    def kv_get(self, key: str) -> Optional[bytes]:
        resp = self._client.call("kv", comm.KeyValueRequest(op="get",
                                                            key=key))
        return resp.value if resp.found else None

    def kv_wait(self, key: str, timeout_s: float = 60.0) -> Optional[bytes]:
        resp = self._client.call("kv", comm.KeyValueRequest(
            op="wait", key=key, timeout_s=timeout_s))
        return resp.value if resp.found else None

    def kv_multi_get(self, keys: List[str]) -> List[bytes]:
        resp = self._client.call("kv", comm.KeyValueRequest(op="multi_get",
                                                            keys=keys))
        return resp.values

    def heartbeat(self, global_step: int = 0, step_timestamp: float = 0.0,
                  gauges=None, rdzv_round: int = -1
                  ) -> comm.HeartbeatResponse:
        return self._client.call(
            "heartbeat",
            comm.HeartbeatRequest(node_id=self._node_id,
                                  timestamp=time.time(),
                                  global_step=global_step,
                                  step_timestamp=step_timestamp,
                                  rdzv_round=rdzv_round,
                                  gauges=gauges or {}),
            retries=_HEARTBEAT_RETRIES)

    # -- serving -----------------------------------------------------------

    def serve_register(self, addr: str, slots: int) -> int:
        """Register this node as a decode replica; the membership epoch."""
        resp = self._client.call(
            "serve_register",
            comm.ServeRegisterRequest(node_id=self._node_id, addr=addr,
                                      slots=slots))
        return int((resp.data or {}).get("epoch", -1))

    def serve_deregister(self, reason: str = "drain") -> None:
        self._client.call(
            "serve_deregister",
            comm.ServeDeregisterRequest(node_id=self._node_id,
                                        reason=reason))

    def serve_replicas(self) -> Tuple[int, List[Dict[str, Any]]]:
        """(epoch, the live replicas as ``{node_id, addr, slots}``), with
        a short budget: a router polls this."""
        resp = self._client.call("serve_replicas", comm.BaseRequest(),
                                 retries=_HEARTBEAT_RETRIES)
        return resp.epoch, [
            {"node_id": r.node_id, "addr": r.addr, "slots": r.slots}
            for r in resp.replicas
        ]

    @classmethod
    def singleton(cls) -> "MasterClient":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls(env_str(EnvKey.MASTER_ADDR),
                                    env_int(EnvKey.NODE_ID, 0))
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._instance = None
