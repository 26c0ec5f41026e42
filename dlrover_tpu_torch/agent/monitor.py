"""The agent's view of its workers' progress.

The port's copy of the key names and ``TrainingMonitor`` of
``dlrover_tpu/agent/monitor.py``: workers publish ``{"step", "ts"}`` (and
their card's memory under ``hbm/<local_rank>``) into the agent's
SharedDict; the monitor forwards each new step to the agent (its hang
bookkeeping) and to the master, stamped with the agent's rendezvous round
so the master drops reports of a world that is gone. Not ported: the
resource monitor and the op-telemetry and memory collectors.
"""

import threading
import time
from typing import Callable, Optional

from dlrover_tpu_torch.common.log import logger

TRAINING_METRICS_DICT = "training_metrics"
# per-local-rank device memory stats, "hbm/<local_rank>"
HBM_KEY_PREFIX = "hbm/"


class TrainingMonitor:
    def __init__(self, ipc_server, client,
                 on_step: Optional[Callable[[int, float], None]] = None,
                 interval_s: float = 5.0,
                 round_provider: Optional[Callable[[], int]] = None):
        self._ipc_server = ipc_server
        self._client = client
        self._on_step = on_step
        self._interval_s = interval_s
        self._round_provider = round_provider or (lambda: -1)
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_reported = -1
        # a reset landing mid-poll must not let that poll re-publish the
        # pre-restart step; the generation catches one landing after the
        # read
        self._poll_lock = threading.Lock()
        self._generation = 0

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop,
                                        name="training-monitor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()

    def reset(self) -> None:
        """Forget progress across a worker restart: the restored workers
        may resume from an earlier step."""
        with self._poll_lock:
            self._generation += 1
            self._last_reported = -1
            self._ipc_server.local_dict(TRAINING_METRICS_DICT).clear()

    def poll_once(self) -> Optional[int]:
        with self._poll_lock:
            gen = self._generation
            metrics = self._ipc_server.local_dict(TRAINING_METRICS_DICT)
            step = metrics.get("step")
            if step is None or step <= self._last_reported:
                return None
            ts = metrics.get("ts", time.time())
            self._last_reported = step
            if self._on_step is not None:
                self._on_step(step, ts)
        try:
            # one attempt: a retried report could land after a reset
            if gen == self._generation:
                self._client.report_global_step(
                    step, ts, retries=1, rdzv_round=self._round_provider())
        except ConnectionError:
            pass
        return step

    def _loop(self) -> None:
        while not self._stopped.wait(self._interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001
                logger.exception("training progress poll failed")
