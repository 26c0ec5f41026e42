"""The agent's view of its workers: progress, op telemetry, memory, usage.

The port's copy of ``dlrover_tpu/agent/monitor.py``. Workers publish into
the agent's SharedDict (``worker.publish_step``): ``{"step", "ts"}`` every
step, their cumulative op-class telemetry under ``optel/<local_rank>``,
and every ~15 s their card's memory under ``hbm/<local_rank>`` and their
memory ledger under ``mem/<local_rank>``.

- :class:`TrainingMonitor` forwards each new step to the agent (its hang
  bookkeeping) and to the master, stamped with the agent's rendezvous
  round so the master drops reports of a world that is gone;
- :class:`OpTelemetryCollector` and :class:`MemorySnapshotCollector`
  re-key the op-telemetry and ledger snapshots by *global* rank for the
  heartbeat (the master's skew monitor and fleet memory monitor compare
  ranks across hosts);
- :class:`ResourceMonitor` reports host usage (psutil, where installed)
  and the workers' card memory (:func:`device_stats_from_ipc`) to the
  master every 15 s.
"""

import threading
import time
from typing import Callable, Dict, Optional

from dlrover_tpu_torch.common.constants import SharedResourceName
from dlrover_tpu_torch.common.log import logger

TRAINING_METRICS_DICT = "training_metrics"
# per-local-rank device memory stats, "hbm/<local_rank>"
HBM_KEY_PREFIX = "hbm/"
# per-local-rank op-class telemetry and memory-ledger snapshots
OPTEL_KEY_PREFIX = SharedResourceName.OPTEL_KEY_PREFIX
MEM_KEY_PREFIX = SharedResourceName.MEM_KEY_PREFIX


def collect_host_usage() -> Dict[str, float]:
    """Host cpu and memory usage from psutil, where it is installed
    (zeros where it is not)."""
    try:
        import psutil
    except ImportError:
        return {"cpu_percent": 0.0, "mem_percent": 0.0, "mem_used_mb": 0.0}
    vm = psutil.virtual_memory()
    return {
        "cpu_percent": psutil.cpu_percent(interval=None),
        "mem_percent": vm.percent,
        "mem_used_mb": vm.used / (1 << 20),
    }


def collect_device_stats() -> Dict[int, Dict[str, float]]:
    """The agent reads no card itself (its workers own them): nothing
    unless a source is passed (``device_stats_from_ipc``)."""
    return {}


def device_stats_from_ipc(ipc_server) -> Dict[int, Dict[str, float]]:
    """Merge the ``hbm/<local_rank>`` entries workers publish through the
    SharedDict (``worker.publish_step``) into the per-card stats dict the
    ResourceMonitor reports."""
    stats: Dict[int, Dict[str, float]] = {}
    try:
        metrics = dict(ipc_server.local_dict(TRAINING_METRICS_DICT))
    except Exception:  # noqa: BLE001 — IPC down = no telemetry
        logger.debug("worker metrics SharedDict unreachable", exc_info=True)
        return stats
    for key, value in metrics.items():
        if not isinstance(key, str) or not key.startswith(HBM_KEY_PREFIX):
            continue
        try:
            for device_id, mem in dict(value).items():
                stats[int(device_id)] = {
                    "hbm_used_mb": float(mem.get("hbm_used_mb", 0.0)),
                    "hbm_total_mb": float(mem.get("hbm_total_mb", 0.0)),
                }
        except (TypeError, ValueError, AttributeError):
            # one malformed entry (version skew across a rolling restart)
            # must not take down the whole resource report
            logger.warning("ignoring malformed device-memory entry %r", key)
    return stats


class OpTelemetryCollector:
    """Scrape the ``optel/<local_rank>`` snapshots workers publish through
    the SharedDict and re-key them by *global* rank for the heartbeat
    uplink — the master's skew monitor compares ranks across hosts, so the
    local-rank keying of the IPC dict is an implementation detail that
    stops here. Stateless: workers publish cumulative histograms, the
    master does the windowing."""

    def __init__(self, ipc_server):
        self._ipc_server = ipc_server

    def collect(self) -> Dict[str, Dict]:
        """``{str(global_rank): snapshot}`` — string keys survive msgpack
        map encoding unambiguously. Empty dict when nothing published yet
        (heartbeat then omits the field)."""
        out: Dict[str, Dict] = {}
        try:
            metrics = dict(self._ipc_server.local_dict(TRAINING_METRICS_DICT))
        except Exception:  # noqa: DLR003 — IPC briefly down (worker
            # restart in flight) means one heartbeat without telemetry;
            # logging every beat of an outage would flood the agent log
            return out
        for key, value in metrics.items():
            if not isinstance(key, str) or \
                    not key.startswith(OPTEL_KEY_PREFIX):
                continue
            try:
                snap = dict(value)
                rank = int(snap.get("rank", key[len(OPTEL_KEY_PREFIX):]))
                out[str(rank)] = snap
            except (TypeError, ValueError):
                logger.warning("ignoring malformed op-telemetry entry %r",
                               key)
        return out


class MemorySnapshotCollector:
    """Scrape the ``mem/<local_rank>`` accountant snapshots workers
    publish through the SharedDict and re-key them by *global* rank for
    the heartbeat uplink (observability/memory.py FleetMemoryMonitor
    consumes them master-side). Same shape discipline as
    :class:`OpTelemetryCollector`."""

    def __init__(self, ipc_server):
        self._ipc_server = ipc_server

    def collect(self) -> Dict[str, Dict]:
        """``{str(global_rank): wire_snapshot}``; empty when nothing
        published yet (heartbeat then omits the field)."""
        out: Dict[str, Dict] = {}
        try:
            metrics = dict(self._ipc_server.local_dict(TRAINING_METRICS_DICT))
        except Exception:  # noqa: DLR003 — IPC briefly down (worker
            # restart in flight) means one heartbeat without the ledger;
            # logging every beat of an outage would flood the agent log
            return out
        for key, value in metrics.items():
            if not isinstance(key, str) or \
                    not key.startswith(MEM_KEY_PREFIX):
                continue
            try:
                snap = dict(value)
                rank = int(snap.get("rank", key[len(MEM_KEY_PREFIX):]))
                out[str(rank)] = snap
            except (TypeError, ValueError):
                logger.warning("ignoring malformed memory-snapshot entry "
                               "%r", key)
        return out


class ResourceMonitor:
    """Report host and card usage to the master periodically."""

    def __init__(
        self,
        client,
        interval_s: float = 15.0,
        extra_device_stats: Optional[Callable[[], Dict]] = None,
    ):
        self._client = client
        self._interval_s = interval_s
        self._extra_device_stats = extra_device_stats or collect_device_stats
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="resource-monitor", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stopped.set()

    def report_once(self) -> None:
        usage = collect_host_usage()
        devices = self._extra_device_stats()
        # only forward fields that were actually measured: a device with
        # memory stats but no duty cycle must NOT read as 0% utilization
        # (None-means-no-telemetry — diagnosis would infer a false stall)
        self._client.report_resource_stats(
            cpu_percent=usage["cpu_percent"],
            mem_used_mb=usage["mem_used_mb"],
            device_util={
                d: s["duty_cycle_pct"] for d, s in devices.items()
                if "duty_cycle_pct" in s
            },
            device_mem_mb={
                d: s["hbm_used_mb"] for d, s in devices.items()
                if "hbm_used_mb" in s
            },
            device_mem_total_mb={
                d: s["hbm_total_mb"] for d, s in devices.items()
                if "hbm_total_mb" in s
            },
        )

    def _loop(self) -> None:
        # prime psutil's cpu_percent baseline
        try:
            collect_host_usage()
        except Exception:  # noqa: BLE001
            logger.debug("cpu_percent priming failed", exc_info=True)
        while not self._stopped.wait(self._interval_s):
            try:
                self.report_once()
            except ConnectionError:
                continue
            except Exception:  # noqa: BLE001
                logger.exception("resource report failed")


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
