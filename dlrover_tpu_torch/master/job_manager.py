"""The master's node table: heartbeats, liveness, failures and actions.

The port's copy of the part of ``dlrover_tpu/master/job_manager.py`` a
master whose agents restart their own workers needs:

- the node table and its status flow (``update_node_status``);
- heartbeats (``report_heartbeat``), whose reply is the node's next
  queued diagnosis action, and ``check_heartbeats`` (a running node silent
  for ``heartbeat_timeout_s`` fails);
- ``report_connection_lost``: a node's heartbeat connection closed; if it
  makes no contact within ``max(conn_drop_grace_s, 1.5 ×
  heartbeat_interval_s)`` it fails, one recheck thread draining a heap;
- the failure ladder (``_should_relaunch``, ``_handle_node_failure``):
  with no scaler to replace a node, a relaunchable failure releases it
  when the survivors still make ``min_nodes`` (the node-event callback
  re-forms the world), and fails the job otherwise.

Stamps are master-monotonic. Not ported: pod relaunch through a scaler,
node-unit relaunch, pending-node strategies, role policies and the fan-in
liveness slack.
"""

import heapq
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.common.constants import (
    DiagnosisActionType,
    JobStage,
    NodeEventType,
    NodeExitReason,
    NodeStatus,
    NodeType,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.node import Node
from dlrover_tpu_torch.diagnosis.action import (
    DiagnosisAction,
    DiagnosisActionQueue,
    JobAbortAction,
)


class NodeEvent:
    def __init__(self, event_type: str, node: Node):
        self.event_type = event_type
        self.node = node


@dataclass
class RelaunchDecision:
    relaunch: bool
    reason: str = ""
    ignore: bool = False  # neither relaunch nor abort


class JobManager:
    def __init__(self, job_name: str, node_num: int,
                 max_relaunch: Optional[int] = None, min_nodes: int = 1):
        ctx = get_context()
        self._job_name = job_name
        self._max_relaunch = (ctx.node_max_relaunch if max_relaunch is None
                              else max_relaunch)
        self._min_nodes = max(1, min_nodes)
        self._nodes: Dict[int, Node] = {}
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._job_stage = JobStage.INIT
        self._action_queue = DiagnosisActionQueue()
        self._event_callbacks: List[Callable[[NodeEvent], None]] = []
        self._monitor_thread: Optional[threading.Thread] = None
        # connection-drop grace rechecks: (due, node_id, drop_ts) drained
        # by one thread
        self._recheck_heap: List[tuple] = []
        self._recheck_cond = threading.Condition()
        self._recheck_thread: Optional[threading.Thread] = None
        for node_id in range(node_num):
            self._nodes[node_id] = self._new_node(node_id)

    def _new_node(self, node_id: int) -> Node:
        return Node(type=NodeType.WORKER, id=node_id, rank=node_id,
                    max_relaunch_count=self._max_relaunch)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._job_stage = JobStage.RUNNING
        self._monitor_thread = threading.Thread(
            target=self._monitor_heartbeats, name="hb-monitor", daemon=True)
        self._monitor_thread.start()

    def stop(self) -> None:
        self._stopped.set()
        with self._recheck_cond:
            self._recheck_cond.notify_all()

    @property
    def job_stage(self) -> str:
        return self._job_stage

    @property
    def nodes(self) -> Dict[int, Node]:
        return self._nodes

    def list_nodes(self) -> List[Node]:
        with self._lock:
            return list(self._nodes.values())

    def add_event_callback(self, cb: Callable[[NodeEvent], None]) -> None:
        self._event_callbacks.append(cb)

    # -- RPC-driven state ----------------------------------------------------

    def get_node(self, node_id: int) -> Node:
        with self._lock:
            if node_id not in self._nodes:
                self._nodes[node_id] = self._new_node(node_id)
            return self._nodes[node_id]

    def update_node_status(self, node_id: int, status: str,
                           exit_reason: str = "",
                           restart_count: int = 0) -> None:
        node = self.get_node(node_id)
        changed = node.update_status(status)
        if exit_reason:
            node.exit_reason = exit_reason
        if changed:
            self._process_event(NodeEvent(NodeEventType.MODIFIED, node))

    def report_heartbeat(self, node_id: int,
                         timestamp: float) -> DiagnosisAction:
        self.record_node_contact(node_id, timestamp, running=True)
        if self._job_stage == JobStage.FAILED:
            return DiagnosisAction(DiagnosisActionType.JOB_ABORT,
                                   instance=node_id, reason="job failed")
        return self._next_action(node_id)

    def record_node_contact(self, node_id: int, timestamp: float = 0.0,
                            running: bool = False) -> None:
        """Any RPC of a node's agent proves it alive; only the heartbeat
        loop (``running=True``) promotes it to RUNNING."""
        node = self.get_node(node_id)
        if running and node.is_released:
            logger.info("node %s returned after release — readmitting",
                        node_id)
            node.is_released = False
            node.relaunchable = True
            node.exit_reason = ""
            node.update_status(NodeStatus.PENDING)
        if running and node.status in (NodeStatus.INITIAL,
                                       NodeStatus.PENDING):
            node.update_status(NodeStatus.RUNNING)
        # after the promotion, so the first beat lands >= start_time
        node.heartbeat_time = time.monotonic()
        node.contact_time = time.monotonic()
        if timestamp:
            node.agent_report_ts = timestamp

    def record_raw_contact(self, node_id: int) -> None:
        """Transport-level proof of life (a replayed frame)."""
        self.get_node(node_id).contact_time = time.monotonic()

    def report_connection_lost(self, node_id: int) -> None:
        """The node's heartbeat connection closed: recheck after the
        grace, and fail the node if it made no contact since."""
        node = self.get_node(node_id)
        if node.status != NodeStatus.RUNNING or node.is_released:
            return
        drop_ts = time.monotonic()
        ctx = get_context()
        # the grace outlasts one heartbeat cadence: an idle connection
        # reset re-contacts only at the agent's next beat
        grace = max(ctx.conn_drop_grace_s, 1.5 * ctx.heartbeat_interval_s)
        logger.info("node %s heartbeat connection dropped — %.1fs grace "
                    "recheck", node_id, grace)
        with self._recheck_cond:
            heapq.heappush(self._recheck_heap,
                           (drop_ts + grace, node_id, drop_ts))
            if self._recheck_thread is None:
                self._recheck_thread = threading.Thread(
                    target=self._recheck_loop, name="conn-drop-recheck",
                    daemon=True)
                self._recheck_thread.start()
            self._recheck_cond.notify_all()

    def _recheck_loop(self) -> None:
        while not self._stopped.is_set():
            with self._recheck_cond:
                if not self._recheck_heap:
                    self._recheck_cond.wait(timeout=5.0)
                    if not self._recheck_heap:
                        # idle exit, under the lock: a concurrent drop
                        # either lands first or starts a fresh thread
                        self._recheck_thread = None
                        return
                    continue
                due, node_id, drop_ts = self._recheck_heap[0]
                delay = due - time.monotonic()
                if delay > 0:
                    self._recheck_cond.wait(timeout=delay)
                    continue
                heapq.heappop(self._recheck_heap)
            try:
                self._recheck_one(node_id, drop_ts)
            except Exception:  # noqa: BLE001 — keep the shared thread
                logger.exception("conn-drop recheck for node %s failed",
                                 node_id)

    def _recheck_one(self, node_id: int, drop_ts: float) -> None:
        n = self.get_node(node_id)
        if (n.status == NodeStatus.RUNNING and not n.is_released
                and n.contact_time < drop_ts):
            logger.warning("node %s made no contact in the grace window "
                           "since its connection dropped — marking failed",
                           node_id)
            n.exit_reason = NodeExitReason.NO_HEARTBEAT
            self.update_node_status(node_id, NodeStatus.FAILED)

    def report_failure(self, node_id: int, error_data: str, level: str,
                       restart_count: int) -> None:
        node = self.get_node(node_id)
        node.exit_reason = NodeExitReason.FATAL_ERROR
        logger.error("node %s reported %s failure: %s", node_id, level,
                     error_data)

    # -- failures ------------------------------------------------------------

    def _process_event(self, event: NodeEvent) -> None:
        node = event.node
        for cb in self._event_callbacks:
            try:
                cb(event)
            except Exception:  # noqa: BLE001
                logger.exception("node event callback failed")
        if node.status == NodeStatus.FAILED:
            self._handle_node_failure(node)
        elif node.status == NodeStatus.SUCCEEDED:
            self._check_job_completed()

    def _should_relaunch(self, node: Node) -> RelaunchDecision:
        """The relaunch ladder, by exit reason: never once the job is
        stopping, for an unrelaunchable node or on a fatal error; always
        for a killed or preempted host; on budget otherwise."""
        if self._job_stage in (JobStage.FAILED, JobStage.SUCCEEDED):
            return RelaunchDecision(False, "job is stopping", ignore=True)
        if not node.relaunchable or node.is_released:
            return RelaunchDecision(False, "node not relaunchable")
        reason = node.exit_reason
        if reason == NodeExitReason.RELAUNCHED:
            return RelaunchDecision(False, "already being relaunched",
                                    ignore=True)
        if reason == NodeExitReason.FATAL_ERROR:
            return RelaunchDecision(False, "fatal error")
        if reason in (NodeExitReason.KILLED, NodeExitReason.PREEMPTED):
            return RelaunchDecision(True, reason)
        return RelaunchDecision(
            node.relaunch_count < node.max_relaunch_count, reason or "exit")

    def _handle_node_failure(self, node: Node) -> None:
        decision = self._should_relaunch(node)
        if decision.ignore:
            return
        if decision.relaunch:
            # nobody replaces the node here: shrink when the survivors
            # still make min_nodes, else the failure is fatal
            alive = sum(1 for n in self.list_nodes()
                        if n.id != node.id and not n.is_released
                        and not NodeStatus.terminal(n.status))
            if alive >= self._min_nodes:
                self.release_node(
                    node, f"{decision.reason}; shrinking to {alive} nodes")
                return
        logger.error("node %s failed permanently (%s) — aborting job",
                     node.id, decision.reason)
        self._job_stage = JobStage.FAILED
        self.enqueue_action(JobAbortAction(
            reason=f"node {node.id} failed: {decision.reason}"))

    def release_node(self, node: Node, reason: str = "") -> None:
        """Give up on a node without failing the job."""
        logger.warning("releasing node %s (%s)", node.id, reason)
        node.is_released = True
        node.relaunchable = False

    def _check_job_completed(self) -> None:
        with self._lock:
            statuses = [n.status for n in self._nodes.values()]
        if all(s == NodeStatus.SUCCEEDED for s in statuses):
            self._job_stage = JobStage.SUCCEEDED

    # -- heartbeat monitoring ------------------------------------------------

    def _monitor_heartbeats(self) -> None:
        ctx = get_context()
        while not self._stopped.wait(ctx.heartbeat_interval_s):
            self.check_heartbeats()

    def check_heartbeats(self, now: Optional[float] = None) -> None:
        now = now or time.monotonic()
        timeout_s = get_context().heartbeat_timeout_s
        for node in self.list_nodes():
            if node.status != NodeStatus.RUNNING:
                continue
            if node.heartbeat_time > 0 and (
                    now - node.heartbeat_time > timeout_s):
                if node.start_time and node.heartbeat_time < node.start_time:
                    # a beat from before the (re)start: not a dead node
                    continue
                logger.warning("node %s heartbeat timed out (%.0fs) — "
                               "marking failed", node.id,
                               now - node.heartbeat_time)
                node.exit_reason = NodeExitReason.NO_HEARTBEAT
                self.update_node_status(node.id, NodeStatus.FAILED)

    # -- the action queue (master → agent in heartbeat replies) --------------

    def enqueue_action(self, action: DiagnosisAction) -> None:
        self._action_queue.add_action(action)

    def _next_action(self, node_id: int) -> DiagnosisAction:
        return self._action_queue.next_action(node_id)
