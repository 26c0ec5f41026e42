"""A node of the job and its status machine.

The port's copy of ``dlrover_tpu/common/node.py`` (``Node``, the usage
part of ``NodeResource`` and ``transition_allowed``), trimmed of the
resource and scheduling fields that only a pod-relaunching master reads.
"""

import time
from dataclasses import dataclass, field
from typing import Optional

from dlrover_tpu_torch.common.constants import NodeStatus

# allowed transitions; any other is ignored (stale events arrive out of
# order)
_ALLOWED = {
    NodeStatus.INITIAL: {NodeStatus.PENDING, NodeStatus.RUNNING,
                         NodeStatus.FAILED, NodeStatus.DELETED},
    NodeStatus.PENDING: {NodeStatus.RUNNING, NodeStatus.SUCCEEDED,
                         NodeStatus.FAILED, NodeStatus.DELETED},
    NodeStatus.RUNNING: {NodeStatus.SUCCEEDED, NodeStatus.FAILED,
                         NodeStatus.DELETED, NodeStatus.BREAKDOWN},
    NodeStatus.SUCCEEDED: {NodeStatus.DELETED},
    NodeStatus.FAILED: {NodeStatus.DELETED, NodeStatus.PENDING},
    NodeStatus.BREAKDOWN: {NodeStatus.DELETED, NodeStatus.PENDING},
    NodeStatus.DELETED: set(),
}


def transition_allowed(from_status: str, to_status: str) -> bool:
    if from_status == to_status:
        return False
    return to_status in _ALLOWED.get(from_status, set())


@dataclass
class NodeResource:
    """A node's reported usage (``rpc_report_resource_stats``)."""

    cpu: float = 0.0
    memory_mb: float = 0.0
    # mean card duty-cycle % over the last report (None = no telemetry;
    # diagnosis must not infer a stall from absence)
    device_util: Optional[float] = None


@dataclass
class Node:
    """One host of the job. Its stamps are master-monotonic seconds: they
    only exist to be subtracted (heartbeat timeout, uptime)."""

    type: str = "worker"
    id: int = 0
    rank: int = -1
    host: str = ""
    status: str = NodeStatus.INITIAL
    exit_reason: str = ""
    relaunch_count: int = 0
    max_relaunch_count: int = 3
    relaunchable: bool = True
    is_released: bool = False
    create_time: float = field(default_factory=time.monotonic)
    start_time: Optional[float] = None
    finish_time: Optional[float] = None
    heartbeat_time: float = 0.0
    # master-clock stamp of any contact (heartbeats and other RPCs): the
    # connection-drop grace recheck compares against it
    contact_time: float = 0.0
    # the agent's reported wall time, for display only
    agent_report_ts: float = 0.0
    used_resource: NodeResource = field(default_factory=NodeResource)

    def update_status(self, status: str) -> bool:
        if transition_allowed(self.status, status):
            self.status = status
            if status == NodeStatus.RUNNING and self.start_time is None:
                self.start_time = time.monotonic()
            if NodeStatus.terminal(status):
                self.finish_time = time.monotonic()
            return True
        return False
