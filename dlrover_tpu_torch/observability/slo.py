"""Declarative serving SLOs, evaluated by multi-window burn rates.

The port's copy of ``dlrover_tpu/observability/slo.py``. An SLO is pure
data (:class:`ServingSLO`): a latency objective ("``target`` of requests
see TTFT under ``ttft_threshold_s``") and an optional goodput objective
("``goodput_target`` of requests complete"), tagged with a tier.

The error budget is ``1 - target``; the burn rate over a window is the
window's bad fraction over the budget (1.0 spends the budget as fast as
it accrues). An alert needs both a fast and a slow window at or above
the threshold: the fast window gives the detection speed, the slow one
keeps a single slow request from paging. A breach journals
``slo_burn_alert {slo, tier, window, rate, slow_rate}``, and the fast
burn feeds ``ServingSignals.slo_burn_rate``.

The plane never touches requests: it diffs histogram bucket counts
(``Histogram.bucket_counts``) and outcome counters between ticks, so a
tick costs one snapshot whatever the traffic. The TTFT objective is
quantized to the histogram's bucket grid, as in the reference.
"""

import math
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.constants import (
    ConfigKey,
    MetricLabel,
    env_float,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.observability.journal import JournalEvent
from dlrover_tpu_torch.observability.registry import get_registry


@dataclass
class ServingSLO:
    """One objective. ``target`` is the share of requests that must see
    TTFT under ``ttft_threshold_s``; ``goodput_target`` (0 = off) the
    share that must complete."""

    name: str = "interactive_ttft"
    tier: str = "interactive"
    ttft_threshold_s: float = 2.0
    target: float = 0.99
    goodput_target: float = 0.0
    metric: str = "dlrover_serving_ttft_seconds"
    # the goodput objective's outcome counter family
    counter_metric: str = "dlrover_serving_requests_total"

    def error_budget(self) -> float:
        return max(1e-6, 1.0 - self.target)


def default_slos() -> List[ServingSLO]:
    """The interactive tier's TTFT SLO (its threshold shared with the
    autoscaler's knob) and a goodput floor."""
    ttft = env_float(ConfigKey.SERVE_TTFT_SLO_S, 2.0)
    goodput = env_float(ConfigKey.SERVE_GOODPUT_SLO, 0.95)
    return [
        ServingSLO(name="interactive_ttft", tier="interactive",
                   ttft_threshold_s=ttft, target=0.99),
        ServingSLO(name="interactive_goodput", tier="interactive",
                   ttft_threshold_s=math.inf, target=1.0,
                   goodput_target=goodput),
    ]


@dataclass
class _Snapshot:
    t: float
    bad: float
    total: float


class _WindowedCounts:
    """A bounded (t, bad, total) history and windowed bad fractions."""

    def __init__(self, horizon_s: float):
        self._horizon_s = horizon_s
        self._snaps: Deque[_Snapshot] = deque()

    def push(self, t: float, bad: float, total: float) -> None:
        self._snaps.append(_Snapshot(t, bad, total))
        while self._snaps and self._snaps[0].t < t - self._horizon_s:
            self._snaps.popleft()

    def bad_fraction(self, window_s: float) -> float:
        """The bad share of the observations of the last ``window_s``
        seconds (0.0 when the window saw none)."""
        if not self._snaps:
            return 0.0
        now = self._snaps[-1]
        cutoff = now.t - window_s
        base = self._snaps[0]
        for snap in self._snaps:
            if snap.t > cutoff:
                break
            base = snap
        d_total = now.total - base.total
        if d_total <= 0:
            return 0.0
        return max(0.0, now.bad - base.bad) / d_total


class SLOPlane:
    """Ticks the burn-rate evaluation of a set of SLOs against one
    registry, journals breaches, and exposes the fast burn."""

    def __init__(
        self,
        slos: Optional[List[ServingSLO]] = None,
        registry=None,
        journal_fn: Optional[Callable] = None,
        fast_window_s: Optional[float] = None,
        slow_window_s: Optional[float] = None,
        burn_threshold: Optional[float] = None,
        alert_cooldown_s: Optional[float] = None,
        monotonic=time.monotonic,
    ):
        self._slos = list(slos) if slos is not None else default_slos()
        self._registry = registry or get_registry()
        self._journal_fn = journal_fn
        self._fast_s = (env_float(ConfigKey.SERVE_SLO_BURN_FAST_S, 1.0)
                        if fast_window_s is None else fast_window_s)
        self._slow_s = (env_float(ConfigKey.SERVE_SLO_BURN_SLOW_S, 5.0)
                        if slow_window_s is None else slow_window_s)
        self._threshold = (env_float(ConfigKey.SERVE_SLO_BURN_RATE, 1.0)
                           if burn_threshold is None else burn_threshold)
        self._cooldown_s = (
            env_float(ConfigKey.SERVE_SLO_ALERT_COOLDOWN_S, 5.0)
            if alert_cooldown_s is None else alert_cooldown_s)
        self._monotonic = monotonic
        self._lock = threading.Lock()
        horizon = max(self._slow_s * 2.0, self._fast_s * 2.0)
        self._windows: Dict[str, _WindowedCounts] = {
            slo.name: _WindowedCounts(horizon) for slo in self._slos}
        self._last_alert: Dict[str, float] = {}
        self._fast_burn: Dict[str, float] = {}
        self.alerts = 0
        self._m_burn = self._registry.gauge(
            "dlrover_serving_slo_burn_rate",
            "current error-budget burn rate per SLO and window",
            labelnames=("slo", "window"))
        self._m_alerts = self._registry.counter(
            "dlrover_serving_slo_alerts_total",
            "journaled slo_burn_alert breaches", labelnames=("slo",))

    @property
    def slos(self) -> List[ServingSLO]:
        return list(self._slos)

    def _bad_total(self, slo: ServingSLO) -> Tuple[float, float]:
        """(bad, total) cumulative counts of one SLO now."""
        if slo.goodput_target > 0.0:
            fam = self._registry.counter(
                slo.counter_metric, "completed requests by outcome",
                labelnames=("status",))
            ok = fam.labels(status="ok").value
            err = (fam.labels(status="error").value
                   + fam.labels(status="lost").value)
            return err, ok + err
        counts = self._registry.histogram(slo.metric).bucket_counts()
        total = counts.get(math.inf, 0)
        # good: the observations in the largest bucket bound under the
        # threshold (the objective is quantized to the bucket grid)
        good = 0
        for bound in sorted(counts):
            if bound <= slo.ttft_threshold_s:
                good = counts[bound]
        return float(total - good), float(total)

    def tick(self) -> Dict[str, float]:
        """Snapshot every SLO, update the burn gauges, journal breaches.
        Returns {slo name: fast-window burn rate}."""
        now = self._monotonic()
        out: Dict[str, float] = {}
        with self._lock:
            for slo in self._slos:
                try:
                    bad, total = self._bad_total(slo)
                except Exception:  # noqa: BLE001 — a missing or retyped
                    # metric gives no verdict; the autoscaler tick goes on
                    logger.warning("SLO %s sampling failed", slo.name,
                                   exc_info=True)
                    continue
                win = self._windows[slo.name]
                win.push(now, bad, total)
                budget = slo.error_budget()
                fast = win.bad_fraction(self._fast_s) / budget
                slow = win.bad_fraction(self._slow_s) / budget
                self._fast_burn[slo.name] = fast
                out[slo.name] = fast
                self._m_burn.labels(
                    slo=slo.name, window=MetricLabel.WINDOW_FAST).set(fast)
                self._m_burn.labels(
                    slo=slo.name, window=MetricLabel.WINDOW_SLOW).set(slow)
                breached = fast >= self._threshold and slow >= self._threshold
                cooled = (now - self._last_alert.get(slo.name, -math.inf)
                          >= self._cooldown_s)
                if breached and cooled:
                    self._last_alert[slo.name] = now
                    self.alerts += 1
                    self._m_alerts.labels(slo=slo.name).inc()
                    logger.warning(
                        "SLO %s burning budget %.1fx fast / %.1fx slow "
                        "(threshold %.1fx)", slo.name, fast, slow,
                        self._threshold)
                    if self._journal_fn is not None:
                        self._journal_fn(
                            JournalEvent.SLO_BURN_ALERT, slo=slo.name,
                            tier=slo.tier, window=MetricLabel.WINDOW_FAST,
                            rate=round(fast, 3), slow_rate=round(slow, 3))
        return out

    def burn_rate(self, slo_name: Optional[str] = None) -> float:
        """The latest fast-window burn: one SLO's, or the largest."""
        with self._lock:
            if slo_name is not None:
                return self._fast_burn.get(slo_name, 0.0)
            return max(self._fast_burn.values(), default=0.0)
