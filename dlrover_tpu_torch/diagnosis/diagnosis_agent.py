"""Node-side diagnosis: collect local telemetry, decide restart vs relaunch.

The port's copy of ``dlrover_tpu/diagnosis/diagnosis_agent.py``. Collectors
are pluggable callables returning gauge dicts whose readings ride to the
master inside heartbeats: the device-timer collector scrapes the per-host
daemon's Prometheus page (the hang gauge the master's hang rule votes on,
and the GEMM, collective and copy families), the resource collector reads
psutil where it is installed. A rising hang gauge pulls every worker's
stacks from the daemon and requests a ``torch.profiler`` trace from each
(on a thread of its own: the heartbeat must keep beating).

Failures are classified by exit code (:meth:`DiagnosisAgent.
diagnose_training_failure`): SIGABRT and SIGSEGV are node-level (relaunch:
the card may be wedged), anything else restarts in place while the budget
lasts. The port narrows the abort (ROADMAP C9): c10d also aborts a worker
whose peer died, so with a ``peer_failed`` probe an abort that follows
another rank's or node's failure restarts in place.
"""

import os
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

from dlrover_tpu_torch.common.constants import DiagnosisActionType
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.diagnosis.diagnosis_master import HANG_GAUGE

# exit codes of a node-level fault, not retried in place: SIGABRT (an
# uncaught c10::Error, a CHECK failure) and SIGSEGV, in both encodings —
# subprocess.Popen reports -signum; shells report 128+signum
_NODE_LEVEL_EXIT_CODES = {-6, -11, 134, 139}
# a torch worker also aborts when c10d tears down a process group whose
# peer died: an abort is retried in place when another rank or node failed
# in the same round
_ABORT_EXIT_CODES = {-6, 134}


class GaugeCollector:
    """A named periodic gauge source (reference datacollector/*)."""

    name = "base"

    def collect(self) -> Dict[str, float]:
        return {}


class ResourceCollector(GaugeCollector):
    """Host cpu/mem usage, where psutil is installed."""

    name = "resource"

    def collect(self) -> Dict[str, float]:
        try:
            import psutil
        except ImportError:
            return {}
        return {
            "node_cpu_percent": psutil.cpu_percent(interval=None),
            "node_mem_percent": psutil.virtual_memory().percent,
        }


class TpuTimerCollector(GaugeCollector):
    """Scrape the local device-timer daemon's Prometheus page for the
    hang/latency gauge families (upstream's
    datacollector/xpu_timer_metric_collector.py)."""

    name = "tpu_timer"

    def __init__(self, port: int = 18889, host: str = "127.0.0.1"):
        self._url = f"http://{host}:{port}/metrics"

    def collect(self) -> Dict[str, float]:
        import urllib.request

        try:
            with urllib.request.urlopen(self._url, timeout=2) as resp:
                text = resp.read().decode()
        except OSError:
            return {}
        gauges: Dict[str, float] = {}
        for line in text.splitlines():
            if not line or line.startswith("#"):
                continue
            parts = line.rsplit(" ", 1)
            if len(parts) != 2:
                continue
            name = parts[0].split("{", 1)[0].strip()
            if not name.startswith("XPU_TIMER"):
                continue
            try:
                value = float(parts[1])
            except ValueError:
                continue
            # keep the max across kernels/labels per family — hang is a
            # boolean-ish gauge, latency families report the worst case
            gauges[name] = max(gauges.get(name, float("-inf")), value)
        return gauges


class WorkerFailure:
    def __init__(self, exit_codes: Dict[int, int], restarts_remaining: int):
        self.exit_codes = exit_codes  # global_rank → exit code
        self.restarts_remaining = restarts_remaining
        self.timestamp = time.time()


class DiagnosisAgent:
    """Per-host diagnosis (reference diagnosis_agent.py:55)."""

    # minimum seconds between hang-triggered stack captures (a wedged job
    # raises the gauge on every heartbeat; one dump per window is enough)
    STACK_CAPTURE_COOLDOWN_S = 120.0
    # failed captures retry sooner than the full cooldown (the daemon may
    # just be restarting while the hang persists)
    STACK_CAPTURE_RETRY_S = 15.0

    def __init__(
        self,
        collectors: Optional[List[GaugeCollector]] = None,
        timer_port: int = 18889,
        stack_dir: Optional[str] = None,
        ipc_server=None,
        local_world_size: int = 1,
        stack_mode: str = "all",
        peer_failed: Optional[Callable[[Dict[int, int]], bool]] = None,
    ):
        self._collectors = (
            collectors if collectors is not None
            else [ResourceCollector(), TpuTimerCollector(port=timer_port)]
        )
        self._failures: List[WorkerFailure] = []
        self._timer_port = timer_port
        self._stack_dir = stack_dir or tempfile.gettempdir()
        self._stack_mode = stack_mode
        self._peer_failed = peer_failed
        # monotonic stamps; -inf = "never", so the first trigger always
        # clears the cooldown even right after boot (monotonic starts ~0)
        self._last_stack_capture = float("-inf")
        self._capture_thread: Optional[threading.Thread] = None
        # profile-on-hang: with the agent IPC server in hand, a hang also
        # requests a torch.profiler trace from every worker
        self._ipc_server = ipc_server
        self._local_world_size = local_world_size
        self._last_profile_request = float("-inf")
        self._hang_up = False
        self.last_stack_path = ""

    def collect_gauges(self) -> Dict[str, float]:
        gauges: Dict[str, float] = {}
        for c in self._collectors:
            try:
                gauges.update(c.collect())
            except Exception:  # noqa: BLE001 — telemetry is best-effort
                logger.exception("collector %s failed", c.name)
        self._note_hang_gauge(gauges)
        self._maybe_capture_stacks(gauges)
        return gauges

    def _note_hang_gauge(self, gauges: Dict[str, float]) -> None:
        """Log each rise of the hang gauge with the device families that
        ride the same beat."""
        up = gauges.get(HANG_GAUGE, 0) > 0
        if up and not self._hang_up:
            families = sorted(k for k, v in gauges.items()
                              if k.startswith("XPU_TIMER_MM_KERNEL_") and v)
            logger.warning(
                "hang gauge %s=1 at t=%.3f, beat carries %d non-zero "
                "XPU_TIMER_MM_KERNEL_* gauges: %s", HANG_GAUGE, time.time(),
                len(families), ",".join(families))
        self._hang_up = up

    def _maybe_capture_stacks(self, gauges: Dict[str, float]) -> None:
        """Hang gauge up → pull every worker's stacks from the daemon and
        request a profile from each, on a background thread: a gdb attach
        can take ~20 s a worker and this is the heartbeat loop."""
        if gauges.get(HANG_GAUGE, 0) <= 0:
            return
        now = time.monotonic()
        if now - self._last_stack_capture < self.STACK_CAPTURE_COOLDOWN_S:
            return
        self._start_capture()

    def _start_capture(self) -> Optional[threading.Thread]:
        if self._capture_thread is not None and (
            self._capture_thread.is_alive()
        ):
            return self._capture_thread

        def _capture():
            # own cooldown, independent of stack-RPC success: the retry
            # path must not re-profile a wedged job every beat
            if time.monotonic() - self._last_profile_request > (
                self.STACK_CAPTURE_COOLDOWN_S
            ):
                self._last_profile_request = time.monotonic()
                self._request_worker_profiles()
            path = self.capture_worker_stacks()
            if path:
                # stamp the cooldown only on success: a transient RPC
                # failure must not suppress the diagnostic for 120 s of a
                # live hang
                self._last_stack_capture = time.monotonic()
                self.last_stack_path = path
                logger.warning(
                    "hang detected — worker stacks saved to %s", path,
                )
            else:
                self._last_stack_capture = (
                    time.monotonic()
                    - self.STACK_CAPTURE_COOLDOWN_S
                    + self.STACK_CAPTURE_RETRY_S
                )

        self._capture_thread = threading.Thread(
            target=_capture, name="hang-stack-capture", daemon=True,
        )
        self._capture_thread.start()
        return self._capture_thread

    def capture_evidence(self, timeout_s: float = 30.0) -> str:
        """Before a wedged restart kills the workers: wait (at most
        ``timeout_s``) for a capture in flight, or take one now unless one
        succeeded within the cooldown. Returns the newest stack dump's
        path ('' when none)."""
        recent = (time.monotonic() - self._last_stack_capture
                  < self.STACK_CAPTURE_COOLDOWN_S)
        thread = self._capture_thread
        if not recent and not (thread is not None and thread.is_alive()):
            thread = self._start_capture()
        if thread is not None:
            thread.join(timeout_s)
        return self.last_stack_path

    def _request_worker_profiles(self, duration_s: float = 3.0,
                                 local_ranks=None,
                                 thread: str = "listener") -> Dict[int, str]:
        """Post a profile request to every local worker (or to
        ``local_ranks``), captured by the worker's ``thread``
        (``listener`` for the hang path's wedged workers, ``main`` for a
        live one); returns ``{local rank: request id}``."""
        if self._ipc_server is None:
            return {}
        try:
            from dlrover_tpu_torch.observability.profiler import (
                PROFILE_DICT,
                request_profile,
            )

            pdict = self._ipc_server.local_dict(PROFILE_DICT)
            ranks = (range(self._local_world_size) if local_ranks is None
                     else local_ranks)
            reqs = {lr: request_profile(pdict, lr, duration_s, thread)
                    for lr in ranks}
            logger.warning(
                "requested %0.1fs torch.profiler traces from %d workers "
                "(local ranks %s)", duration_s, len(reqs), sorted(reqs))
            return reqs
        except Exception:  # noqa: BLE001 — diagnosis must not crash
            logger.warning("profile request failed", exc_info=True)
            return {}

    def capture_worker_stacks(
        self,
        port: Optional[int] = None,
        host: str = "127.0.0.1",
        out_dir: Optional[str] = None,
        mode: Optional[str] = None,
        timeout_s: Optional[float] = None,
        pid: Optional[int] = None,
    ) -> str:
        """Fetch every worker's stacks (``pid``: that worker's only)
        through the daemon's /stacktrace (faulthandler readback, and gdb
        where installed) and persist them; returns the dump path ('' on
        failure)."""
        import urllib.request

        port = self._timer_port if port is None else port
        out_dir = self._stack_dir if out_dir is None else out_dir
        mode = self._stack_mode if mode is None else mode
        if timeout_s is None:
            # worst case ~22s/worker (gdb timeout + dump wait), serial
            timeout_s = 30.0 + 25.0 * 8
        url = f"http://{host}:{port}/stacktrace?mode={mode}"
        if pid:
            url += f"&pid={int(pid)}"
        try:
            with urllib.request.urlopen(url, timeout=timeout_s) as resp:
                text = resp.read().decode()
        except OSError as e:
            logger.warning("stacktrace RPC failed: %r", e)
            return ""
        path = os.path.join(
            out_dir, f"dlrover_tpu_stacks_{time.time_ns()}.json"
        )
        try:
            with open(path, "w") as f:
                f.write(text)
        except OSError:
            logger.exception("could not persist stack dump to %s", path)
            return ""
        return path

    def diagnose_training_failure(
        self, exit_codes: Dict[int, int], restarts_remaining: int
    ) -> str:
        """RESTART_WORKER (same host) vs RELAUNCH_WORKER (new pod). The
        caller owns the restart budget counter; this is the single
        decision point."""
        self._failures.append(WorkerFailure(exit_codes, restarts_remaining))
        node_level = [c for c in exit_codes.values()
                      if c in _NODE_LEVEL_EXIT_CODES]
        if node_level and not (
                self._peer_failed is not None
                and all(c in _ABORT_EXIT_CODES for c in node_level)
                and self._peer_failed(exit_codes)):
            logger.warning(
                "node-level failure (exit codes %s) — requesting pod relaunch",
                exit_codes,
            )
            return DiagnosisActionType.RELAUNCH_WORKER
        if restarts_remaining <= 0:
            logger.warning(
                "in-place restart budget spent — requesting pod relaunch"
            )
            return DiagnosisActionType.RELAUNCH_WORKER
        return DiagnosisActionType.RESTART_WORKER

    @property
    def failure_count(self) -> int:
        return len(self._failures)
