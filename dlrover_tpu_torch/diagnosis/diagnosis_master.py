"""Master-side diagnosis: the training-hang rule and the loop that runs it.

The port's copy of ``TrainingHangDiagnostician`` and ``DiagnosisMaster``
from ``dlrover_tpu/diagnosis/diagnosis_master.py``. A hang is a global
step that stopped advancing for ``hang_downtime_s`` (master-monotonic)
while every node that forwards the profiler hang gauge votes hung. The
port's agents forward no device-timer gauges yet, so the vote is empty and
a stall alone resolves to ``training_hang``: with ``hang_restart_workers``
set, a broadcast ``RESTART_WORKER`` marked wedged (the agents SIGKILL
their workers fast), else an observe-only event. Not ported: the pre-check
chain, the metric-stall and straggler rules, tracing and the journal.
"""

import time
from typing import Dict

from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.common.constants import (
    DiagnosisActionType,
    DiagnosisConstant,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.diagnosis.action import DiagnosisAction, EventAction
from dlrover_tpu_torch.diagnosis.diagnostician import (
    Diagnostician,
    DiagnosticianRegistry,
    Observation,
)

# the gauge name agents forward from the profiler plane
HANG_GAUGE = "XPU_TIMER_COMMON_HANG"


class TrainingHangDiagnostician(Diagnostician):
    name = "training_hang"

    def __init__(self, perf_monitor, node_gauges: Dict[int, tuple]):
        # node_gauges: node_id -> (gauges, monotonic receive stamp), shared
        # with DiagnosisMaster.observe_heartbeat
        self._perf_monitor = perf_monitor
        self._node_gauges = node_gauges

    def observe(self, **kwargs) -> Observation:
        ctx = get_context()
        if not self._perf_monitor.step_stalled(ctx.hang_downtime_s):
            return Observation()
        # only nodes that recently forwarded the hang gauge vote
        now = time.monotonic()
        fresh_s = 3 * ctx.heartbeat_interval_s
        votes = {nid: g[HANG_GAUGE] > 0
                 for nid, (g, ts) in self._node_gauges.items()
                 if HANG_GAUGE in g and now - ts <= fresh_s}
        if votes and not all(votes.values()):
            return Observation("step_stall",
                               {"votes": sum(votes.values()),
                                "nodes": len(votes)})
        return Observation("training_hang", {"nodes": list(votes)})

    def resolve(self, observation: Observation, **kwargs) -> DiagnosisAction:
        if observation.problem == "step_stall":
            return EventAction(
                "step_stall",
                msg="global step stalled without unanimous hang gauges",
                **observation.data)
        if not get_context().hang_restart_workers:
            return EventAction("training_hang",
                               msg="hang detected (observe-only)")
        logger.warning("training hang detected — restarting all workers")
        return DiagnosisAction(
            DiagnosisActionType.RESTART_WORKER,
            instance=DiagnosisConstant.ANY_INSTANCE,
            reason="training hang",
            # the workers are known wedged: skip the graceful-exit grace
            data={"wedged": True})


class DiagnosisMaster:
    """Runs the registered diagnosticians periodically; their actions go
    to the job manager's queue (EVENT actions to the log)."""

    def __init__(self, job_manager, perf_monitor=None):
        self._job_manager = job_manager
        self._perf_monitor = perf_monitor
        self._node_gauges: Dict[int, tuple] = {}
        self._registry = DiagnosticianRegistry(self._sink_action)
        if perf_monitor is not None:
            self._registry.register(
                TrainingHangDiagnostician(perf_monitor, self._node_gauges),
                period_s=get_context().diagnosis_interval_s)

    def _sink_action(self, action: DiagnosisAction) -> None:
        if action.action_type == DiagnosisActionType.EVENT:
            logger.info("diagnosis event %s: %s %s",
                        action.data.get("event_type", ""), action.reason,
                        action.data)
            return
        self._job_manager.enqueue_action(action)

    def pre_check_status(self):
        """The pre-check verdict: the port runs no pre-check operators."""
        return "pass", ""

    def observe_heartbeat(self, req) -> None:
        """Every beat replaces the node's gauge snapshot."""
        self._node_gauges[req.node_id] = (
            dict(getattr(req, "gauges", None) or {}), time.monotonic())

    def start(self) -> None:
        self._registry.start_observing()

    def stop(self) -> None:
        self._registry.stop()
