"""Per-step op-class telemetry: compact histograms shipped worker → master.

The port's copy of ``dlrover_tpu/observability/op_telemetry.py``, with the
same wire format byte for byte, so a port worker's beat is read by the
JAX package's skew monitor and the reverse. Each worker folds its op
timings into one :class:`OpTelemetryAccumulator` — four fixed-bucket
log-spaced histograms (one per op class) and a last-entered-collective
marker — and publishes the cumulative snapshot through the agent's
SharedDict (``worker.publish_step``); the agent re-keys its local ranks'
snapshots by global rank onto the heartbeat (``agent/monitor.py``) and the
master diffs consecutive snapshots per rank (``master/skew_monitor.py``).

Two feeds, one format:

- without the device timer's library (the CPU, a worker run without
  ``--tpu-timer``) the timer's Python spans feed this module's
  accumulator: a span's class is :func:`classify` of its kind and name,
  and a collective span marks its entry before it runs;
- with the library loaded the native engine (``tpu_timer/src/engine.cc``)
  keeps the same four histograms, with these bucket bounds, over
  everything it records, and ``tt_op_telemetry`` returns the snapshot
  (``TpuTimer.op_telemetry``); the Python span then does not observe
  again, so a span counts once. The engine classes a hooked cuBLAS GEMM
  as ``compute``, a hooked NCCL collective as ``collective`` (the event
  pair's duration; its entry marked when the hooked call is entered,
  before anything is queued, so a rank parked behind a peer never
  marks), a Python span by :func:`classify`, and a hooked
  ``cudaMemcpyAsync`` not at all: the reference has no span of that kind,
  and a checkpoint's device-to-host copy counted as compute would skew
  the compute means. The attention kernels (K1–K4) link the CUDA runtime
  statically and are not hooked, so ``compute`` holds GEMMs and Python
  compute spans only.

Wire format (msgpack/JSON-safe, a few hundred bytes per rank)::

    {"seq": 1234,                    # total observations; resets on restart
     "classes": {"compute":    {"b": [..13 ints..], "sum": µs, "max": µs, "n": N},
                 "collective": {...}, "input": {...}, "ckpt": {...}},
     "last_collective": {"name": "all_reduce_x", "seq": 57}}

``last_collective.seq`` counts collectives *entered* — the hang verdict
compares these across ranks.
"""

import threading
from typing import Any, Dict, Optional


class OpClass:
    """Op classes the skew monitor attributes against."""

    COMPUTE = "compute"
    COLLECTIVE = "collective"
    HOST_INPUT = "input"
    CKPT = "ckpt"

    ALL = (COMPUTE, COLLECTIVE, HOST_INPUT, CKPT)


# Fixed log-spaced bucket upper bounds in microseconds (powers of 4 from
# 10µs up to ~10.5s) + one overflow bucket. Fixed bounds mean histograms
# from any rank/version merge and diff bucket-by-bucket.
BUCKET_BOUNDS_US = (
    10, 40, 160, 640, 2_560, 10_240, 40_960, 163_840,
    655_360, 2_621_440, 10_485_760,
)
NUM_BUCKETS = len(BUCKET_BOUNDS_US) + 1  # + overflow


class OpClassHistogram:
    """Fixed-bucket duration histogram with max/sum/count. Not
    thread-safe on its own — the accumulator serialises access."""

    __slots__ = ("buckets", "sum_us", "max_us", "count")

    def __init__(self):
        self.buckets = [0] * NUM_BUCKETS
        self.sum_us = 0.0
        self.max_us = 0.0
        self.count = 0

    def observe(self, dur_us: float) -> None:
        dur_us = max(0.0, float(dur_us))
        idx = NUM_BUCKETS - 1
        for i, bound in enumerate(BUCKET_BOUNDS_US):
            if dur_us <= bound:
                idx = i
                break
        self.buckets[idx] += 1
        self.sum_us += dur_us
        self.max_us = max(self.max_us, dur_us)
        self.count += 1

    def merge(self, other: "OpClassHistogram") -> None:
        for i in range(NUM_BUCKETS):
            self.buckets[i] += other.buckets[i]
        self.sum_us += other.sum_us
        self.max_us = max(self.max_us, other.max_us)
        self.count += other.count

    def to_wire(self) -> Dict[str, Any]:
        return {
            "b": list(self.buckets),
            "sum": self.sum_us,
            "max": self.max_us,
            "n": self.count,
        }

    @classmethod
    def from_wire(cls, wire: Dict[str, Any]) -> "OpClassHistogram":
        h = cls()
        raw = list(wire.get("b", ()))[:NUM_BUCKETS]
        for i, v in enumerate(raw):
            h.buckets[i] = int(v)
        h.sum_us = float(wire.get("sum", 0.0))
        h.max_us = float(wire.get("max", 0.0))
        h.count = int(wire.get("n", 0))
        return h

    @property
    def mean_us(self) -> float:
        return self.sum_us / self.count if self.count else 0.0


# name-substring heuristics for spans the timer can't pre-classify by
# kind: host input pipeline and checkpoint I/O ride KIND_MM ("compute")
# spans, so classify() re-routes them by span name.
_INPUT_MARKERS = ("input", "data_load", "dataload", "next_batch", "host_fetch")
_CKPT_MARKERS = ("ckpt", "checkpoint", "save", "restore")


def classify(kind: int, name: str) -> str:
    """Map a TpuTimer span (kind, name) to an op class."""
    # local import: tpu_timer imports this module for its Python feed
    from dlrover_tpu_torch.observability.tpu_timer import KIND_COLL

    if kind == KIND_COLL:
        return OpClass.COLLECTIVE
    low = (name or "").lower()
    if any(m in low for m in _CKPT_MARKERS):
        return OpClass.CKPT
    if any(m in low for m in _INPUT_MARKERS):
        return OpClass.HOST_INPUT
    return OpClass.COMPUTE


class OpTelemetryAccumulator:
    """Thread-safe cumulative accumulator; one per worker process.

    Snapshots are cumulative (never reset between publishes): the master
    diffs consecutive snapshots per rank, so a lost heartbeat only widens
    a window instead of losing data. ``seq`` (total observations) going
    backwards tells the master the worker restarted."""

    def __init__(self):
        self._lock = threading.Lock()
        self._hists: Dict[str, OpClassHistogram] = {
            cls: OpClassHistogram() for cls in OpClass.ALL
        }
        self._seq = 0
        self._coll_seq = 0
        self._last_coll_name = ""

    def observe(self, op_class: str, dur_us: float) -> None:
        if op_class not in self._hists:
            op_class = OpClass.COMPUTE
        with self._lock:
            self._hists[op_class].observe(dur_us)
            self._seq += 1

    def observe_span(self, kind: int, name: str, dur_us: float) -> None:
        self.observe(classify(kind, name), dur_us)

    def enter_collective(self, name: str) -> None:
        """Mark collective ENTRY — recorded before the op runs so a hang
        inside it is still visible in the next snapshot."""
        with self._lock:
            self._coll_seq += 1
            self._last_coll_name = str(name)
            self._seq += 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "seq": self._seq,
                "classes": {
                    cls: h.to_wire() for cls, h in self._hists.items()
                    if h.count
                },
                "last_collective": {
                    "name": self._last_coll_name,
                    "seq": self._coll_seq,
                },
            }

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq


_global_accumulator: Optional[OpTelemetryAccumulator] = None
_global_lock = threading.Lock()


def get_accumulator() -> OpTelemetryAccumulator:
    """Process-wide accumulator (created on first use)."""
    global _global_accumulator
    with _global_lock:
        if _global_accumulator is None:
            _global_accumulator = OpTelemetryAccumulator()
        return _global_accumulator


def reset_accumulator() -> None:
    global _global_accumulator
    with _global_lock:
        _global_accumulator = None
