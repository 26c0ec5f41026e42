"""Traffic-driven serving autoscaling and the train↔serve loan.

The port's copy of ``dlrover_tpu/serving/autoscaler.py``. The training
auto-scaler plans from pending nodes, stragglers and speed; serving plans
from traffic: the router's queue depth, TTFT p99 against the SLO, and the
live against the target replica count. :class:`ServingOptimizer` has the
``ResourceOptimizer`` shape, so ``JobAutoScaler`` runs it on the same
deadline-paced tick. Its rules, in priority order:

1. **restore**: live < target means a replica died (the registry has
   journaled ``serve_replica_lost``): plan the target back at once, with
   no cooldown (a crash recovery is never an oscillation);
2. **grow**: queue depth above ``DLROVER_TPU_SERVE_QUEUE_HI`` or TTFT p99
   above ``DLROVER_TPU_SERVE_TTFT_SLO_S``, bounded by the maximum and the
   grow cooldown;
3. **shrink**: no queue and nothing in flight, bounded by the minimum and
   the shrink cooldown; the scaler carries it out as a drain.

:class:`TrainServeCoordinator` lends the serving plane an idle training
node's capacity when serving is hot at its maximum, and hands it back
when the journal says training re-forms (``rdzv_start``).

Both take an injectable clock, so a drill on a simulated timeline gives
the reference's plans for the same signals.
"""

import threading
import time
from dataclasses import dataclass
from typing import Optional

from dlrover_tpu_torch.common.constants import ConfigKey, env_float, env_int
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.observability.journal import JournalEvent


@dataclass
class ServingSignals:
    """One tick's traffic snapshot (router, registry and scaler views)."""

    live_replicas: int = 0
    target_replicas: int = 0
    queue_depth: int = 0
    inflight: int = 0
    ttft_p99_s: float = 0.0
    tokens_per_s: float = 0.0
    # the offered arrival rate (the open-loop generator's envelope): a
    # leading signal beside the lagging queue and TTFT
    offered_rps: float = 0.0
    # the SLO plane's fast-window burn rate: another leading signal
    slo_burn_rate: float = 0.0


@dataclass
class ServePlan:
    replica_num: Optional[int] = None
    reason: str = ""

    def empty(self) -> bool:
        return self.replica_num is None


class ServingOptimizer:
    def __init__(
        self,
        min_replicas: int = 1,
        max_replicas: int = 2,
        ttft_slo_s: Optional[float] = None,
        queue_hi: Optional[int] = None,
        grow_cooldown_s: Optional[float] = None,
        shrink_cooldown_s: Optional[float] = None,
        monotonic=time.monotonic,
    ):
        self._monotonic = monotonic
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.ttft_slo_s = (env_float(ConfigKey.SERVE_TTFT_SLO_S, 2.0)
                           if ttft_slo_s is None else ttft_slo_s)
        self.queue_hi = (env_int(ConfigKey.SERVE_QUEUE_HI, 8)
                         if queue_hi is None else queue_hi)
        self.grow_cooldown_s = (
            env_float(ConfigKey.SERVE_GROW_COOLDOWN_S, 5.0)
            if grow_cooldown_s is None else grow_cooldown_s)
        self.shrink_cooldown_s = (
            env_float(ConfigKey.SERVE_SHRINK_COOLDOWN_S, 30.0)
            if shrink_cooldown_s is None else shrink_cooldown_s)
        # the cooldowns run from construction: a plane that comes up with
        # no traffic must not shrink, nor grow on a cold-start blip, on
        # its first tick
        self._last_grow = self._last_shrink = self._monotonic()

    def plan(self, signals: ServingSignals) -> ServePlan:
        now = self._monotonic()  # cooldown arithmetic
        target = signals.target_replicas
        if signals.live_replicas < target:
            # a lost replica: plan the target back (the scaler decides
            # what spawning reaches it)
            return ServePlan(target, "restore lost replica "
                             f"({signals.live_replicas}/{target} live)")
        hot = (signals.queue_depth > self.queue_hi
               or signals.ttft_p99_s > self.ttft_slo_s)
        if (hot and target < self.max_replicas
                and now - self._last_grow >= self.grow_cooldown_s):
            self._last_grow = now
            return ServePlan(
                target + 1,
                f"traffic grow (queue={signals.queue_depth}, "
                f"ttft_p99={signals.ttft_p99_s:.3f}s)")
        idle = signals.queue_depth == 0 and signals.inflight == 0
        if (idle and target > self.min_replicas
                and now - self._last_shrink >= self.shrink_cooldown_s):
            self._last_shrink = now
            return ServePlan(target - 1, "idle shrink")
        return ServePlan()


class TrainServeCoordinator:
    """Lend idle training capacity to the serving plane; hand it back the
    moment training re-forms.

    The loan is extra headroom on the optimizer's ``max_replicas`` plus a
    ``scale_to`` through the serve scaler. The handback listens to the
    journal for ``handback_kinds`` (``rdzv_start`` by default)."""

    def __init__(self, optimizer: ServingOptimizer, serve_scaler=None,
                 event_journal=None, idle_provider=None, max_borrow: int = 1,
                 handback_kinds=(JournalEvent.RDZV_START,)):
        self._optimizer = optimizer
        self._scaler = serve_scaler
        self._journal = event_journal
        # () -> int: training nodes idle now and borrowable
        self._idle_provider = idle_provider or (lambda: 0)
        self._max_borrow = max_borrow
        self._handback_kinds = tuple(handback_kinds)
        self._lock = threading.Lock()
        self.borrowed = 0
        self._base_max = optimizer.max_replicas
        if event_journal is not None:
            event_journal.add_listener(self._on_journal_event)

    def _record(self, **data) -> None:
        if self._journal is not None:
            self._journal.record(JournalEvent.SERVE_SCALE, source="rose",
                                 **data)

    def maybe_borrow(self, signals: ServingSignals) -> bool:
        """On a tick where serving is hot at its maximum: borrow one idle
        training node's worth of capacity."""
        hot = (signals.queue_depth > self._optimizer.queue_hi
               or signals.ttft_p99_s > self._optimizer.ttft_slo_s)
        with self._lock:
            if (not hot or self.borrowed >= self._max_borrow
                    or signals.target_replicas < self._optimizer.max_replicas
                    or self._idle_provider() <= 0):
                return False
            self.borrowed += 1
            self._optimizer.max_replicas = self._base_max + self.borrowed
            target = self._optimizer.max_replicas
        logger.info("borrowing an idle training node → %s decode replicas",
                    target)
        self._record(direction="borrow", target=target)
        if self._scaler is not None:
            self._scaler.scale_to(target, reason="rose borrow")
        return True

    def _on_journal_event(self, event) -> None:
        if event.get("kind") in self._handback_kinds:
            self.handback(reason=f"training demand ({event.get('kind')})")

    def handback(self, reason: str = "training rendezvous") -> None:
        """Training re-forms: drain every borrowed replica now."""
        with self._lock:
            if self.borrowed == 0:
                return
            self.borrowed = 0
            self._optimizer.max_replicas = self._base_max
            target = self._base_max
        logger.info("handing borrowed capacity back (%s)", reason)
        self._record(direction="handback", target=target, reason=reason)
        if self._scaler is not None:
            self._scaler.scale_to(target, reason=f"rose handback: {reason}")
