"""JobAutoScaler: periodic resource re-planning on one deadline-paced tick.

The port's copy of ``dlrover_tpu/master/auto_scaler.py``. Each tick runs
two planners, kept apart on purpose (a serving grow must never resize
the training world):

- the serving side (:meth:`JobAutoScaler.serve_tick`): traffic signals
  from the caller's ``serving_signals`` → the ``ServingOptimizer``'s
  ``ServePlan`` → ``serve_scaler.scale_to``. A restore plan repeats every
  tick until the replacement registers: it is executed every time
  (``scale_to`` is idempotent and respawns a replica that died starting)
  and journaled once;
- the training side (:meth:`JobAutoScaler.tick`): stats from the job
  manager and the perf monitor → the optimizer's ``ResourcePlan`` →
  :meth:`JobAutoScaler.execute`, which clamps the target to the bounds
  and refreshes every rendezvous manager's min/max so the next
  re-rendezvous cuts a world of the new size.

Decisions are the reference's for the same inputs. A new serving plan is
a ``serve.scale`` span and an applied training plan a ``scale.apply``
span, with one ``scale.update_rdzv_params`` child per rendezvous
manager. Not ported: the brain advisor, the strategy generator (the
parallel-config path) and the k8s scaler call; their arguments raise if
given.
"""

import threading
import time
from typing import Dict, Optional

from dlrover_tpu_torch.common.constants import NodeStatus, SpanName
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.master.resource import (
    LocalOptimizer,
    ResourceOptimizer,
    ResourcePlan,
    ScalingStats,
)
from dlrover_tpu_torch.observability import tracing
from dlrover_tpu_torch.observability.journal import JournalEvent


class JobAutoScaler:
    def __init__(
        self,
        job_manager,
        perf_monitor,
        scaler=None,
        rdzv_managers: Optional[Dict] = None,
        optimizer: Optional[ResourceOptimizer] = None,
        min_nodes: int = 1,
        max_nodes: int = 1,
        node_unit: int = 1,
        interval_s: float = 30.0,
        straggler_provider=None,
        strategy_generator=None,
        serving_optimizer=None,
        serving_signals=None,
        serve_scaler=None,
        event_journal=None,
        brain_advisor=None,
    ):
        unported = {"scaler": scaler,
                    "strategy_generator": strategy_generator,
                    "brain_advisor": brain_advisor}
        given = sorted(k for k, v in unported.items() if v is not None)
        if given:
            raise NotImplementedError(
                f"JobAutoScaler: {', '.join(given)} not ported (the k8s "
                "scaler, the parallel-config path and the brain)")
        self._job_manager = job_manager
        self._perf_monitor = perf_monitor
        self._rdzv_managers = rdzv_managers or {}
        self._optimizer = optimizer or LocalOptimizer()
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        self.node_unit = node_unit
        self.target_nodes = max_nodes
        self._interval_s = interval_s
        self._straggler_provider = straggler_provider or (lambda: [])
        # the serving plane rides the same tick: its signals feed its
        # optimizer and its plans go to the serve scaler (replica
        # processes), never to the training world's node count
        self._serving_optimizer = serving_optimizer
        self._serving_signals = serving_signals or (lambda: None)
        self._serve_scaler = serve_scaler
        self._event_journal = event_journal
        self._last_serve_plan = None
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop,
                                        name="job-auto-scaler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()

    def _loop(self) -> None:
        # deadline pacing: ticks land on the cadence grid however long a
        # tick took, stop() wakes the loop at once, and a tick that
        # overruns a whole period skips forward instead of bursting
        next_tick = time.monotonic() + self._interval_s
        while not self._stopped.wait(max(0.0, next_tick - time.monotonic())):
            next_tick += self._interval_s
            now = time.monotonic()
            if next_tick <= now:
                next_tick = now + self._interval_s
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop outlives a tick
                logger.exception("auto-scaler tick failed")

    # -- one planning round ------------------------------------------------

    def collect_stats(self) -> ScalingStats:
        now = time.monotonic()  # against node.create_time (master clock)
        running = pending = 0
        oldest_pending = 0.0
        for node in list(self._job_manager.nodes.values()):
            if node.status == NodeStatus.RUNNING:
                running += 1
            elif node.status in (NodeStatus.PENDING, NodeStatus.INITIAL):
                pending += 1
                oldest_pending = max(oldest_pending, now - node.create_time)
        return ScalingStats(
            running_nodes=running,
            pending_nodes=pending,
            target_nodes=self.target_nodes,
            min_nodes=self.min_nodes,
            max_nodes=self.max_nodes,
            node_unit=self.node_unit,
            running_speed=self._perf_monitor.running_speed(),
            straggler_nodes=list(self._straggler_provider()),
            oldest_pending_s=oldest_pending,
        )

    def serve_tick(self) -> None:
        """The serving side of the tick: signals → ServePlan → scaler."""
        if self._serving_optimizer is None:
            return
        signals = self._serving_signals()
        if signals is None:
            return
        plan = self._serving_optimizer.plan(signals)
        if plan.empty():
            self._last_serve_plan = None
            return
        repeat = (plan.replica_num, plan.reason) == self._last_serve_plan
        self._last_serve_plan = (plan.replica_num, plan.reason)
        if repeat:
            if self._serve_scaler is not None:
                self._serve_scaler.scale_to(plan.replica_num,
                                            reason=plan.reason)
            return
        logger.info("serve auto-scale → %s replicas (%s)",
                    plan.replica_num, plan.reason)
        with tracing.span(SpanName.SERVE_SCALE, source="master",
                          target=plan.replica_num, reason=plan.reason):
            if self._event_journal is not None:
                self._event_journal.record(
                    JournalEvent.SERVE_SCALE, target=plan.replica_num,
                    reason=plan.reason)
            if self._serve_scaler is not None:
                self._serve_scaler.scale_to(plan.replica_num,
                                            reason=plan.reason)

    def tick(self) -> Optional[ResourcePlan]:
        self.serve_tick()
        plan = self._optimizer.plan(self.collect_stats())
        if plan.empty():
            return None
        self.execute(plan)
        return plan

    def execute(self, plan: ResourcePlan) -> None:
        """Apply a plan's node count, clamped to [min_nodes, max_nodes]:
        the next re-rendezvous must cut a world of the new size."""
        if plan.node_num is None:
            return
        target = max(self.min_nodes, min(self.max_nodes, plan.node_num))
        if target == self.target_nodes:
            return
        logger.info("auto-scale %s → %s nodes (%s)", self.target_nodes,
                    target, plan.reason)
        with tracing.span(SpanName.SCALE_APPLY, source="master",
                          target=target, prev=self.target_nodes,
                          reason=str(plan.reason)):
            self.target_nodes = target
            for manager in self._rdzv_managers.values():
                with tracing.span(SpanName.SCALE_RDZV_PARAMS,
                                  source="master", target=target):
                    manager.update_rdzv_params(
                        min_nodes=min(self.min_nodes, target),
                        max_nodes=target, node_unit=self.node_unit)
