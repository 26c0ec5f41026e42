"""Job stats collection and reporting.

The port's copy of ``dlrover_tpu/master/stats.py``: the master's
:class:`JobMetricCollector` snapshots its runtime state (nodes, their
reported host usage, training speed and goodput) every 15 s into a
:class:`LocalStatsReporter`, a bounded in-memory history. Left out: the
micro-batch strategy generator the reference re-evaluates on the same
cadence (the port has no parallel-config tuner). The port's perf monitor
keeps no lost-time ledger, so the goodput comes from ``goodput_fn`` (the
master passes the journal's productive share of the wall time).
"""

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from dlrover_tpu_torch.common.log import logger


@dataclass
class JobRuntimeStats:
    """One snapshot of the job's runtime state."""

    timestamp: float = field(default_factory=time.time)
    node_count: int = 0
    running_nodes: int = 0
    global_step: int = 0
    speed_steps_per_s: float = 0.0
    goodput: float = 1.0
    cpu_percent_avg: float = 0.0
    mem_used_mb_total: float = 0.0
    device_util_avg: Optional[float] = None


class StatsReporter:
    def report(self, stats: JobRuntimeStats) -> None:
        raise NotImplementedError


class LocalStatsReporter(StatsReporter):
    """Keeps a bounded in-memory history."""

    MAX_SAMPLES = 512

    def __init__(self):
        self._lock = threading.Lock()
        self._history: List[JobRuntimeStats] = []

    def report(self, stats: JobRuntimeStats) -> None:
        with self._lock:
            self._history.append(stats)
            if len(self._history) > self.MAX_SAMPLES:
                self._history.pop(0)

    def history(self) -> List[JobRuntimeStats]:
        with self._lock:
            return list(self._history)

    def latest(self) -> Optional[JobRuntimeStats]:
        with self._lock:
            return self._history[-1] if self._history else None


class JobMetricCollector:
    """Periodic snapshot of master state → reporter."""

    def __init__(
        self,
        job_manager,
        perf_monitor=None,
        reporter: Optional[StatsReporter] = None,
        interval_s: float = 15.0,
        goodput_fn: Optional[Callable[[], float]] = None,
    ):
        self._job_manager = job_manager
        self._perf_monitor = perf_monitor
        self._goodput_fn = goodput_fn
        self.reporter = reporter or LocalStatsReporter()
        self._interval_s = interval_s
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def collect_once(self) -> JobRuntimeStats:
        nodes = list(self._job_manager.nodes.values())
        running = [n for n in nodes if n.status == "running"]
        utils = [
            n.used_resource.device_util for n in running
            if n.used_resource.device_util is not None
        ]
        stats = JobRuntimeStats(
            node_count=len(nodes),
            running_nodes=len(running),
            cpu_percent_avg=(
                sum(n.used_resource.cpu for n in running) / len(running)
                if running else 0.0
            ),
            mem_used_mb_total=sum(
                n.used_resource.memory_mb for n in running
            ),
            device_util_avg=sum(utils) / len(utils) if utils else None,
        )
        if self._perf_monitor is not None:
            stats.global_step = self._perf_monitor.completed_global_step
            stats.speed_steps_per_s = self._perf_monitor.running_speed()
        if self._goodput_fn is not None:
            stats.goodput = self._goodput_fn()
        self.reporter.report(stats)
        return stats

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="stats-collector", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()

    def _loop(self) -> None:
        while not self._stopped.wait(self._interval_s):
            try:
                self.collect_once()
            except Exception:  # noqa: BLE001
                logger.exception("stats collection failed")
