"""Training progress as the master sees it: global steps, speed, stall.

The port's copy of ``dlrover_tpu/master/perf_monitor.py``. Step reports
carry the reporter's rendezvous round: after a re-rendezvous
(``reset_running_speed_monitor``) reports of older rounds are dropped, so
a late report from a dead world neither refreshes progress nor re-arms the
hang rule. Staleness compares master-monotonic arrival stamps only, never
an agent's clock. Not ported: the goodput bookkeeping the journal feeds,
and the metrics gauges.
"""

import threading
import time
from typing import Dict, List, Optional


class GlobalStepRecord:
    def __init__(self, step: int, timestamp: float,
                 arrival: Optional[float] = None):
        self.step = step
        # the reporter's wall time: compared only with other reports
        self.timestamp = timestamp
        # master-monotonic arrival: the basis of staleness checks
        self.arrival = time.monotonic() if arrival is None else arrival


class PerfMonitor:
    MAX_RECORDS = 256

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._records: List[GlobalStepRecord] = []
        self._min_round = -1
        # step reports taken, by the rendezvous round the agent sent
        # them in, never reset: the reshard coordinator reads whether the
        # world of a cut trained (a worker's own reports carry no round)
        self._by_round: Dict[int, int] = {}

    def reset_running_speed_monitor(self, min_round: Optional[int] = None
                                    ) -> None:
        """On re-rendezvous: the old world's samples are void, and reports
        of rounds before ``min_round`` are dropped from now on."""
        with self._lock:
            self._records.clear()
            if min_round is not None and min_round > self._min_round:
                self._min_round = min_round

    def collect_global_step(self, step: int, timestamp: float,
                            rdzv_round: int = -1,
                            arrival: Optional[float] = None) -> None:
        with self._lock:
            if 0 <= rdzv_round < self._min_round:
                return
            # counted before the order check: the worker's own report of
            # a step often lands before its agent's
            if rdzv_round >= 0:
                self._by_round[rdzv_round] = (
                    self._by_round.get(rdzv_round, 0) + 1)
            if self._records and step <= self._records[-1].step:
                return
            self._records.append(GlobalStepRecord(step, timestamp, arrival))
            if len(self._records) > self.MAX_RECORDS:
                self._records.pop(0)

    def running_speed(self, window: int = 8) -> float:
        """Steps a second over the recent window (the auto-scaler's
        speed sample)."""
        with self._lock:
            if len(self._records) < 2:
                return 0.0
            recent = self._records[-window:]
            dt = recent[-1].timestamp - recent[0].timestamp
            ds = recent[-1].step - recent[0].step
            return ds / dt if dt > 0 else 0.0

    def steps_since_round(self, rdzv_round: int) -> int:
        """The step reports taken from agents in ``rdzv_round`` or a
        later round."""
        with self._lock:
            return sum(n for r, n in self._by_round.items()
                       if r >= rdzv_round)

    @property
    def completed_global_step(self) -> int:
        with self._lock:
            return self._records[-1].step if self._records else 0

    def step_stalled(self, timeout_s: float) -> bool:
        """True when steps stopped advancing for ``timeout_s``."""
        with self._lock:
            if not self._records:
                return False
            last = self._records[-1].arrival
        return time.monotonic() - last > timeout_s
