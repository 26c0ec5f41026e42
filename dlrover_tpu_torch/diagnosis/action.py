"""Diagnosis actions: what the control plane wants done, and by whom.

The port's copy of ``dlrover_tpu/diagnosis/action.py``. Actions ride from
the master to an agent in heartbeat replies; they are plain value objects
keyed by ``action_type`` (``constants.DiagnosisActionType``). The queue
hands an action for one node to that node once, and a broadcast
(``ANY_INSTANCE``) once to each node; actions expire on the monotonic
clock.
"""

import threading
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.constants import (
    DiagnosisActionType,
    DiagnosisConstant,
)
from dlrover_tpu_torch.common.log import logger


class DiagnosisAction:
    """Base action (reference diagnosis_action.py ``DiagnosisAction``)."""

    def __init__(
        self,
        action_type: str = DiagnosisActionType.NONE,
        instance: int = DiagnosisConstant.MASTER_INSTANCE,
        reason: str = "",
        data: Optional[Dict] = None,
        expired_time_s: float = DiagnosisConstant.ACTION_EXPIRY_S,
    ):
        self.action_type = action_type
        self.instance = instance
        self.reason = reason
        self.data = data or {}
        self.timestamp = time.time()
        self.expired_time_s = expired_time_s
        # expiry runs on the monotonic clock: a wall step under NTP must
        # neither expire a fresh action nor immortalize a stale one
        self._created_mono = time.monotonic()
        # node ids a broadcast (ANY_INSTANCE) action was delivered to
        self.delivered: set = set()

    def is_noop(self) -> bool:
        return self.action_type == DiagnosisActionType.NONE

    def is_expired(self, now: Optional[float] = None) -> bool:
        """``now``, when given, is a time.monotonic() reading."""
        return (
            (now or time.monotonic()) - self._created_mono
        ) > self.expired_time_s

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"{type(self).__name__}(type={self.action_type},"
            f" instance={self.instance}, reason={self.reason!r})"
        )


class NoAction(DiagnosisAction):
    def __init__(self):
        super().__init__(DiagnosisActionType.NONE)


class EventAction(DiagnosisAction):
    """Publish a structured event, no state change (reference EventAction)."""

    def __init__(self, event_type: str = "", msg: str = "", **labels):
        super().__init__(
            DiagnosisActionType.EVENT,
            reason=msg,
            data={"event_type": event_type, **labels},
        )


class NodeAction(DiagnosisAction):
    """Restart or relaunch a specific node's workers (reference
    NodeAction: RESTART_WORKER soft in-pod vs RELAUNCH_WORKER pod-level)."""

    def __init__(
        self,
        node_id: int,
        action_type: str = DiagnosisActionType.RESTART_WORKER,
        reason: str = "",
    ):
        super().__init__(action_type, instance=node_id, reason=reason)


class JobAbortAction(DiagnosisAction):
    def __init__(self, reason: str = "", instance: int = DiagnosisConstant.ANY_INSTANCE):
        super().__init__(
            DiagnosisActionType.JOB_ABORT, instance=instance, reason=reason
        )


class DiagnosisActionQueue:
    """Per-instance action queue with expiry + broadcast semantics
    (reference diagnosis_action.py ``DiagnosisActionQueue``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._actions: List[DiagnosisAction] = []

    def add_action(self, action: DiagnosisAction) -> None:
        if action.is_noop():
            return
        with self._lock:
            for existing in self._actions:
                if (
                    existing.action_type == action.action_type
                    and existing.instance == action.instance
                ):
                    return  # dedup identical pending actions
            logger.info("queueing diagnosis action %r", action)
            self._actions.append(action)

    def next_action(self, instance: int) -> DiagnosisAction:
        now = time.monotonic()
        with self._lock:
            self._actions = [
                a for a in self._actions if not a.is_expired(now)
            ]
            for i, action in enumerate(self._actions):
                if action.instance == instance:
                    return self._actions.pop(i)
                if action.instance == DiagnosisConstant.ANY_INSTANCE:
                    if instance not in action.delivered:
                        action.delivered.add(instance)
                        return action
        return NoAction()

    def __len__(self) -> int:
        with self._lock:
            return len(self._actions)
