"""Tail-latency attribution: why was this slow request slow.

The port's copy of ``dlrover_tpu/serving/tail.py``. A
:class:`TailAttributor` takes every completed request's segment summary
(``ServeRequest.segments()``: queue-wait, prefill-compute, first-step,
decode, and the re-route, prefix and speculation context) and classifies
the requests past the slow percentile (``DLROVER_TPU_SERVE_TAIL_PCTL``,
90, once ``DLROVER_TPU_SERVE_TAIL_MIN_WINDOW`` completions are in) with
:func:`classify`, a total function onto the six causes of
``MetricLabel.TAIL_CAUSES``:

1. a re-routed request → ``reroute``;
2. queue-wait the largest segment → ``queue``;
3. prefill (with the first step) the largest → ``prefix_miss`` when the
   prefix cache was on and missed, else ``prefill``;
4. decode the largest → ``speculative_miss`` when speculation ran with
   acceptance under 0.5, else ``batch_interference``.

Each attribution is journaled (``request_tail_attributed``) and counted
in ``dlrover_serving_tail_cause_total{cause}``, and the N worst requests
(``DLROVER_TPU_SERVE_TRACE_WORST``, 5) are kept with their trace ids for
the replica's flight-recorder bundle.
"""

import heapq
import threading
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.constants import (
    ConfigKey,
    MetricLabel,
    env_float,
    env_int,
)
from dlrover_tpu_torch.observability.journal import JournalEvent
from dlrover_tpu_torch.observability.registry import get_registry
from dlrover_tpu_torch.serving.traffic import percentile

_SPEC_MISS_RATE = 0.5


def classify(segments: Dict) -> str:
    """Dominant-cause classification of one request's segment summary.
    Pure and total: any dict with the ``ServeRequest.segments()`` keys
    (missing keys default sanely) maps to one of the six causes."""
    if segments.get("rerouted"):
        return MetricLabel.TAIL_REROUTE
    legs = {
        MetricLabel.TAIL_QUEUE: float(segments.get("queue_s", 0.0)),
        MetricLabel.TAIL_PREFILL: (float(segments.get("prefill_s", 0.0))
                                   + float(segments.get("first_step_s",
                                                        0.0))),
        MetricLabel.TAIL_BATCH_INTERFERENCE:
            float(segments.get("decode_s", 0.0)),
    }
    dominant = max(legs, key=lambda k: legs[k])
    if dominant == MetricLabel.TAIL_PREFILL:
        if (segments.get("prefix_enabled")
                and not segments.get("prefix_hit")):
            return MetricLabel.TAIL_PREFIX_MISS
        return MetricLabel.TAIL_PREFILL
    if dominant == MetricLabel.TAIL_BATCH_INTERFERENCE:
        if (segments.get("spec_rounds", 0)
                and float(segments.get("spec_accept_rate", 1.0))
                < _SPEC_MISS_RATE):
            return MetricLabel.TAIL_SPECULATIVE_MISS
        return MetricLabel.TAIL_BATCH_INTERFERENCE
    return dominant


class TailAttributor:
    """Feed every completion through :meth:`observe`; requests past the
    slow percentile of the sliding latency window are attributed."""

    def __init__(
        self,
        journal_fn: Optional[Callable] = None,
        registry=None,
        slow_pctl: Optional[float] = None,
        min_window: Optional[int] = None,
        window_size: int = 512,
        worst_n: Optional[int] = None,
    ):
        self._journal_fn = journal_fn
        self._slow_pctl = (env_float(ConfigKey.SERVE_TAIL_PCTL, 90.0)
                           if slow_pctl is None else slow_pctl)
        self._min_window = (env_int(ConfigKey.SERVE_TAIL_MIN_WINDOW, 20)
                            if min_window is None else min_window)
        self._window_size = window_size
        self._worst_n = (env_int(ConfigKey.SERVE_TRACE_WORST, 5)
                         if worst_n is None else worst_n)
        self._lock = threading.Lock()
        self._latencies: List[float] = []
        # min-heap of (latency, seq, segments) — the N WORST survive
        self._worst: List = []
        self._seq = 0
        self.attributed = 0
        self.cause_counts: Dict[str, int] = {
            c: 0 for c in MetricLabel.TAIL_CAUSES}
        reg = registry or get_registry()
        self._m_causes = reg.counter(
            "dlrover_serving_tail_cause_total",
            "slow-percentile requests by attributed dominant cause",
            labelnames=("cause",))

    def observe(self, segments: Dict) -> Optional[str]:
        """One completed request's summary. Returns the attributed cause
        when the request was slow enough to classify, else ``None``."""
        latency = float(segments.get("latency_s", 0.0))
        with self._lock:
            self._latencies.append(latency)
            del self._latencies[:-self._window_size]
            if len(self._latencies) < self._min_window:
                return None
            threshold = percentile(self._latencies, self._slow_pctl)
            if latency < threshold or latency <= 0.0:
                return None
            cause = classify(segments)
            self.attributed += 1
            self.cause_counts[cause] = self.cause_counts.get(cause, 0) + 1
            self._seq += 1
            record = dict(segments, cause=cause)
            heapq.heappush(self._worst, (latency, self._seq, record))
            while len(self._worst) > self._worst_n:
                heapq.heappop(self._worst)
        self._m_causes.labels(cause=cause).inc()
        if self._journal_fn is not None:
            self._journal_fn(
                JournalEvent.REQUEST_TAIL_ATTRIBUTED, cause=cause,
                request_id=segments.get("request_id", ""),
                trace_id=segments.get("trace_id") or "",
                latency_s=round(latency, 4),
                queue_s=round(float(segments.get("queue_s", 0.0)), 4),
                prefill_s=round(float(segments.get("prefill_s", 0.0)), 4),
                decode_s=round(float(segments.get("decode_s", 0.0)), 4))
        return cause

    def worst_requests(self) -> List[Dict]:
        """The retained worst requests, slowest first — what a serving
        replica's flight-recorder bundle embeds next to the trace ring."""
        with self._lock:
            worst = sorted(self._worst, reverse=True)
        return [dict(rec) for _, _, rec in worst]
