"""Master-side diagnosis: the training-hang, metric-stall and straggler
rules and the loop that runs them.

The port's copy of ``TrainingHangDiagnostician``,
``MetricStallDiagnostician``, ``RuntimeStragglerDiagnostician`` and
``DiagnosisMaster`` from ``dlrover_tpu/diagnosis/diagnosis_master.py``. A
hang is a global step that stopped advancing for ``hang_downtime_s``
(master-monotonic) while every node that forwards the device timer's hang
gauge votes hung. An agent run with ``--tpu-timer`` forwards
``XPU_TIMER_COMMON_HANG`` in every beat; where no node forwards it the
vote is empty and a stall alone resolves to ``training_hang``, and where a
node votes not hung (a slow host, the card still completing work) it
resolves to ``step_stall``. A ``training_hang`` with
``hang_restart_workers`` set is a broadcast ``RESTART_WORKER`` marked
wedged (the agents SIGKILL their workers fast), else an observe-only
event.

The metric-stall rule reads the job metric context (``common/metric.py``,
fed by the agents' resource reports): every node's duty cycle under 0.5%
for a whole window is a ``device_stall`` event; nodes without a duty cycle
abstain, and the port reports none yet. The straggler rule reads the skew
monitor's verdicts: one ``STACK_DUMP`` per verdict episode at the culprit
rank's node, worst ratio first. A ``RESTART_WORKER`` the sink queues is
journaled as ``fault_detected`` (the master's journal, when one is given)
unless a recovery is already open: the hang rule re-fires every period
until the workers restart. Not ported: the pre-check chain, and the sink's
tracing.
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
from dlrover_tpu_torch.observability.journal import (
    JournalEvent,
    recovery_open,
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
        logger.warning("training hang detected (hang gauge votes from "
                       "nodes %s) — restarting all workers",
                       observation.data.get("nodes", []))
        return DiagnosisAction(
            DiagnosisActionType.RESTART_WORKER,
            instance=DiagnosisConstant.ANY_INSTANCE,
            reason="training hang",
            # the workers are known wedged: skip the graceful-exit grace
            data={"wedged": True})


class MetricStallDiagnostician(Diagnostician):
    """Device-utilization collapse: every node's reported duty cycle stayed
    near zero for a whole window while the job claims to be training, over
    the JobMetricContext duty-cycle series; nodes without telemetry
    abstain."""

    name = "metric_stall"

    def __init__(
        self,
        metric_context,
        stall_util_pct: float = 0.5,
        window_s: float = 300.0,
    ):
        self._metric_context = metric_context
        self._stall_util_pct = stall_util_pct
        self._window_s = window_s

    def observe(self, **kwargs) -> Observation:
        if self._metric_context is None:
            return Observation()
        if self._metric_context.all_duty_cycles_below(
            self._stall_util_pct, self._window_s
        ):
            return Observation("device_stall", {
                "window_s": self._window_s,
                "threshold_pct": self._stall_util_pct,
            })
        return Observation()

    def resolve(self, observation: Observation, **kwargs) -> DiagnosisAction:
        return EventAction(
            "device_stall",
            msg="all devices near-idle while job running",
            **observation.data,
        )


class RuntimeStragglerDiagnostician(Diagnostician):
    """Act on the SkewMonitor's verdicts (master/skew_monitor.py): a
    straggler verdict becomes a STACK_DUMP action targeted at the culprit
    rank's node — the agent captures the workers' stacks and requests a
    ``torch.profiler`` trace, so the evidence of *why* the rank is slow
    lands next to the verdict that flagged it. A hang verdict is
    evidence-only (the journal already carries the attribution; the hang
    *restart* policy stays with TrainingHangDiagnostician).

    Deduped per verdict episode: a straggler that persists across
    diagnosis periods triggers one dump, re-armed only when the verdict
    clears and re-fires."""

    name = "runtime_straggler"

    def __init__(self, skew_monitor):
        self._skew_monitor = skew_monitor
        self._acted: set = set()

    def observe(self, **kwargs) -> Observation:
        if self._skew_monitor is None:
            return Observation()
        verdicts = self._skew_monitor.current_verdicts()
        current = {(s["rank"], s["cause"]) for s in verdicts["stragglers"]}
        self._acted &= current  # re-arm cleared verdicts
        fresh = [s for s in verdicts["stragglers"]
                 if (s["rank"], s["cause"]) not in self._acted]
        if not fresh:
            return Observation()
        return Observation("runtime_straggler", {"stragglers": fresh})

    def resolve(self, observation: Observation, **kwargs) -> DiagnosisAction:
        # worst offender first; one dump request per diagnosis period is
        # enough (the queue dedups per (action, instance) anyway)
        worst = max(observation.data["stragglers"],
                    key=lambda s: s.get("ratio", 0.0))
        self._acted.add((worst["rank"], worst["cause"]))
        logger.warning(
            "runtime straggler rank %s (%s %.2fx median) — requesting "
            "stack dump from node %s",
            worst["rank"], worst["cause"], worst.get("ratio", 0.0),
            worst.get("node_id", -1),
        )
        return DiagnosisAction(
            DiagnosisActionType.STACK_DUMP,
            instance=worst.get("node_id", DiagnosisConstant.ANY_INSTANCE),
            reason=f"straggler rank {worst['rank']} ({worst['cause']})",
            data={"rank": worst["rank"], "cause": worst["cause"],
                  "ratio": worst.get("ratio", 0.0)},
        )


class DiagnosisMaster:
    """Runs the registered diagnosticians periodically; their actions go
    to the job manager's queue (EVENT actions to the log)."""

    def __init__(self, job_manager, perf_monitor=None, metric_context=None,
                 skew_monitor=None, event_journal=None):
        self._job_manager = job_manager
        self._event_journal = event_journal
        self._perf_monitor = perf_monitor
        self._node_gauges: Dict[int, tuple] = {}
        self._registry = DiagnosticianRegistry(self._sink_action)
        period = get_context().diagnosis_interval_s
        if perf_monitor is not None:
            self._registry.register(
                TrainingHangDiagnostician(perf_monitor, self._node_gauges),
                period_s=period)
        self._registry.register(MetricStallDiagnostician(metric_context),
                                period_s=period)
        if skew_monitor is not None:
            self._registry.register(
                RuntimeStragglerDiagnostician(skew_monitor), period_s=period)

    def _sink_action(self, action: DiagnosisAction) -> None:
        if action.action_type == DiagnosisActionType.EVENT:
            logger.info("diagnosis event %s: %s %s",
                        action.data.get("event_type", ""), action.reason,
                        action.data)
            return
        if (self._event_journal is not None and action.action_type
                == DiagnosisActionType.RESTART_WORKER
                and not recovery_open(self._event_journal)):
            # a hang restart is a detected fault though no node died; the
            # rule re-fires every period until the workers restart, one
            # fault_detected opens the recovery
            self._event_journal.record(JournalEvent.FAULT_DETECTED,
                                       reason=action.reason or "diagnosis")
        self._job_manager.enqueue_action(action)

    def pre_check_status(self):
        """The pre-check verdict: the port runs no pre-check operators."""
        return "pass", ""

    def observe_heartbeat(self, req) -> None:
        """Every beat replaces the node's gauge snapshot."""
        self._node_gauges[req.node_id] = (
            dict(getattr(req, "gauges", None) or {}), time.monotonic())

    def diagnose_once(self) -> None:
        """Run every registered diagnostician once."""
        for name in list(self._registry._diagnosticians):
            self._registry.diagnose(name)

    def start(self) -> None:
        self._registry.start_observing()

    def stop(self) -> None:
        self._registry.stop()
