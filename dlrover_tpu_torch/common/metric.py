"""Runtime metrics model: per-card samples, node aggregates, job context.

The port's copy of ``dlrover_tpu/common/metric.py``: ``TpuMetric`` (one
card's sample), ``NodeMetrics`` (one host's) and ``JobMetricContext`` (the
bounded per-node series the master's metric-stall rule reads), keyed by
node id. The port reports no duty cycle yet, so its cards' samples carry
``duty_cycle_pct=None`` and the rule's nodes abstain.
"""

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class TpuMetric:
    """One card's health sample (the reference's name, kept so the two
    packages' messages and tests read alike)."""

    device_id: int = 0
    # fraction of time the card executed work; None = telemetry
    # unavailable (memory stats arrive without it, and a card with memory
    # stats only must NOT read as 0% utilization or diagnosis infers a
    # false stall)
    duty_cycle_pct: Optional[float] = None
    hbm_used_mb: float = 0.0
    hbm_total_mb: float = 0.0
    tensorcore_util_pct: float = 0.0

    @property
    def hbm_used_frac(self) -> float:
        return (
            self.hbm_used_mb / self.hbm_total_mb if self.hbm_total_mb else 0.0
        )


@dataclass
class NodeMetrics:
    """One host's sample: CPU/mem and its cards."""

    node_id: int = 0
    # monotonic: only ever COMPARED (window cutoffs), never reported
    timestamp: float = field(default_factory=time.monotonic)
    cpu_percent: float = 0.0
    mem_percent: float = 0.0
    mem_used_mb: float = 0.0
    devices: List[TpuMetric] = field(default_factory=list)

    def avg_duty_cycle(self) -> Optional[float]:
        cycles = [
            d.duty_cycle_pct for d in self.devices
            if d.duty_cycle_pct is not None
        ]
        if not cycles:
            return None
        return sum(cycles) / len(cycles)


class JobMetricContext:
    """Bounded per-node metric time-series. The master's diagnosis reads
    windows of these to answer "did every card's duty cycle collapse"."""

    MAX_SAMPLES_PER_NODE = 240  # ~1h at 15 s cadence

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._series: "OrderedDict[int, List[NodeMetrics]]" = OrderedDict()

    def add_node_metrics(self, metrics: NodeMetrics) -> None:
        with self._lock:
            series = self._series.setdefault(metrics.node_id, [])
            series.append(metrics)
            if len(series) > self.MAX_SAMPLES_PER_NODE:
                series.pop(0)

    def latest(self, node_id: int) -> Optional[NodeMetrics]:
        with self._lock:
            series = self._series.get(node_id)
            return series[-1] if series else None

    def window(self, node_id: int, seconds: float) -> List[NodeMetrics]:
        cutoff = time.monotonic() - seconds
        with self._lock:
            return [
                m for m in self._series.get(node_id, [])
                if m.timestamp >= cutoff
            ]

    def node_ids(self) -> List[int]:
        with self._lock:
            return list(self._series)

    def all_duty_cycles_below(
        self, threshold_pct: float, seconds: float
    ) -> bool:
        """True iff every node with device telemetry stayed under
        ``threshold_pct`` duty cycle for the whole window (and at least one
        node has telemetry) — the tensor-drop-zero hang signal."""
        any_node = False
        for node_id in self.node_ids():
            window = self.window(node_id, seconds)
            cycles = [
                c for c in (m.avg_duty_cycle() for m in window)
                if c is not None
            ]
            if not cycles:
                continue
            any_node = True
            if any(c >= threshold_pct for c in cycles):
                return False
        return any_node

    def clear(self) -> None:
        with self._lock:
            self._series.clear()
