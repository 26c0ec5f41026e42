"""Diagnostician framework: observe a symptom, resolve it to an action.

The port's copy of ``dlrover_tpu/diagnosis/diagnostician.py``: a registry
of named diagnosticians, each with ``observe() -> Observation`` and
``resolve(observation) -> DiagnosisAction``; periodic observers run on
their own cadence and feed an action sink.
"""

import threading
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.diagnosis.action import DiagnosisAction, NoAction


class Observation:
    """What a diagnostician saw (reference diagnostician.py Observation)."""

    HEALTHY = ""

    def __init__(self, problem: str = HEALTHY, data: Optional[Dict] = None):
        self.problem = problem
        self.data = data or {}

    @property
    def is_healthy(self) -> bool:
        return self.problem == self.HEALTHY


class Diagnostician:
    """Base diagnostician (reference diagnostician.py:85)."""

    name = "base"

    def observe(self, **kwargs) -> Observation:
        return Observation()

    def resolve(self, observation: Observation, **kwargs) -> DiagnosisAction:
        return NoAction()

    def diagnose(self, **kwargs) -> DiagnosisAction:
        try:
            ob = self.observe(**kwargs)
            if ob.is_healthy:
                return NoAction()
            return self.resolve(ob, **kwargs)
        except Exception:  # noqa: BLE001 — diagnosis must never kill the host
            logger.exception("diagnostician %s failed", self.name)
            return NoAction()


class DiagnosticianRegistry:
    """Named diagnosticians + periodic observers feeding an action sink."""

    def __init__(self, action_sink: Callable[[DiagnosisAction], None]):
        self._diagnosticians: Dict[str, Diagnostician] = {}
        self._periods: Dict[str, float] = {}
        self._action_sink = action_sink
        self._stopped = threading.Event()
        self._threads: List[threading.Thread] = []

    def register(
        self, diagnostician: Diagnostician, period_s: Optional[float] = None
    ) -> None:
        self._diagnosticians[diagnostician.name] = diagnostician
        if period_s is not None:
            self._periods[diagnostician.name] = period_s

    def get(self, name: str) -> Optional[Diagnostician]:
        return self._diagnosticians.get(name)

    def diagnose(self, name: str, **kwargs) -> DiagnosisAction:
        d = self._diagnosticians.get(name)
        if d is None:
            return NoAction()
        action = d.diagnose(**kwargs)
        if not action.is_noop():
            self._action_sink(action)
        return action

    def start_observing(self) -> None:
        for name, period in self._periods.items():
            t = threading.Thread(
                target=self._observe_loop,
                args=(name, period),
                name=f"diag-{name}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _observe_loop(self, name: str, period: float) -> None:
        while not self._stopped.wait(period):
            self.diagnose(name)

    def stop(self) -> None:
        self._stopped.set()
