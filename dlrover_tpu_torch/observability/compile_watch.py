"""Compile watch: first calls of new shapes, hits, and recompile storms.

The port's copy of ``dlrover_tpu/observability/compile_watch.py``. The
port runs eager and compiles nothing, but a call at a shape it has not
seen still pays once: cuBLAS picks its heuristics for the new GEMM
shapes, CUDA loads kernel modules lazily and the caching allocator grows
its pools (a first GEMM of a shape took up to 112 ms on an H100, PERF.md).
So a *signature* here is the shape key the call site already owns — the
serving engine's ``("prefill", bucket)``, ``("prefill_sfx", bucket, m)``,
``("insert", bucket)`` and ``("step",)`` (``serving/engine.py``) and the
trainer's ``(accum, rows, seq)`` (``trainer/elastic.py``) — and a *miss*
is the first call with a new key, timed on the host around the call:

- ``dlrover_compile_total{fn}`` counts misses (distinct signatures),
  ``dlrover_compile_cache_hits_total{fn}`` re-uses,
  ``dlrover_compile_seconds`` the misses' wall time;
- a sliding window per function detects *storms* — at least N distinct
  signatures inside the window — and attributes the storm to the
  varying dimension (the dim with the most distinct values, mapped onto
  ``MetricLabel.STORM_DIMS``), journaling
  ``recompile_storm{dim, count, window_s, fn}`` once per episode.

Storm detection and attribution are the reference's; the port adds
:meth:`CompileWatcher.misses`, each timed miss with its signature and
seconds. Left out: the race detector's registration of the signature
map.
"""

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.constants import ConfigKey, MetricLabel, env_int
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.observability.journal import JournalEvent

# ≥ this many distinct signatures for one fn inside the window = storm
# (ConfigKey.COMPILE_STORM_N overrides)
DEFAULT_STORM_THRESHOLD = 6
DEFAULT_STORM_WINDOW_S = 120.0
# distinct-signature history kept per fn (forensics, not detection)
SIG_HISTORY = 256

# signature dimension name -> bounded storm-dim label. Unlisted dims
# (and multi-way ties) fall to "unknown" rather than minting new label
# values — the STORM_DIMS vocabulary is the DLR013 contract.
_DIM_LABELS = {
    "batch": MetricLabel.STORM_DIM_BATCH,
    "rows": MetricLabel.STORM_DIM_BATCH,
    "slots": MetricLabel.STORM_DIM_BATCH,
    "seq_len": MetricLabel.STORM_DIM_SEQ_LEN,
    "bucket": MetricLabel.STORM_DIM_SEQ_LEN,
    "bucket_len": MetricLabel.STORM_DIM_SEQ_LEN,
    "cache_len": MetricLabel.STORM_DIM_SEQ_LEN,
    "prefix_len": MetricLabel.STORM_DIM_SEQ_LEN,
    "dtype": MetricLabel.STORM_DIM_DTYPE,
    "fn": MetricLabel.STORM_DIM_FN,
}


def _storm_threshold() -> int:
    return env_int(ConfigKey.COMPILE_STORM_N, DEFAULT_STORM_THRESHOLD)


class _Timer:
    """Context manager returned by :meth:`CompileWatcher.time` — times
    the enclosed compile only when the signature was a cache miss."""

    def __init__(self, watcher: "CompileWatcher", fn: str, miss: bool,
                 dims: Optional[Dict[str, Any]] = None):
        self._watcher = watcher
        self._fn = fn
        self._dims = dims or {}
        self.miss = miss
        self._t0: Optional[float] = None

    def __enter__(self) -> "_Timer":
        if self.miss:
            self._t0 = self._watcher._monotonic()
        return self

    def __exit__(self, *exc) -> None:
        if self._t0 is not None and exc[0] is None:
            self._watcher._observe_compile_s(
                self._fn, self._watcher._monotonic() - self._t0,
                self._dims)


class CompileWatcher:
    """Process-wide compile ledger. Thread-safe: serving threads note
    shapes concurrently with the trainer's steps (one lock guards the
    signature maps)."""

    def __init__(
        self,
        journal=None,
        registry=None,
        source: str = "worker",
        storm_threshold: Optional[int] = None,
        window_s: float = DEFAULT_STORM_WINDOW_S,
        monotonic: Callable[[], float] = time.monotonic,
    ):
        self._journal = journal
        self._source = source
        self._monotonic = monotonic
        self._threshold = storm_threshold or _storm_threshold()
        self._window_s = window_s
        self._lock = threading.Lock()
        # fn -> set of signature tuples ever seen (the compile cache's
        # shadow: membership = hit)
        self._sigs: Dict[str, set] = {}
        # fn -> deque of (first-seen t, sig dims dict) inside-ish window
        self._recent: Dict[str, deque] = {}
        # fn -> storm episode open (re-armed when the window drains)
        self._storm_open: Dict[str, bool] = {}
        self._storm_log: List[Dict[str, Any]] = []
        # the timed misses with their signatures (misses())
        self._misses: deque = deque(maxlen=SIG_HISTORY)
        if registry is None:
            from dlrover_tpu_torch.observability.registry import get_registry

            registry = get_registry()
        self._c_compiles = registry.counter(
            "dlrover_compile_total",
            "Compiles (first-seen abstract signatures) per function",
            labelnames=("fn",),
        )
        self._c_hits = registry.counter(
            "dlrover_compile_cache_hits_total",
            "Signature re-uses (no retrace) per function",
            labelnames=("fn",),
        )
        self._h_seconds = registry.histogram(
            "dlrover_compile_seconds",
            "Wall time of timed misses (the first call per signature — "
            "an upper bound including the run itself)",
        )
        self._g_distinct = registry.gauge(
            "dlrover_compile_distinct_signatures",
            "Distinct abstract signatures seen per function since start",
            labelnames=("fn",),
        )
        self._c_storms = registry.counter(
            "dlrover_compile_storms_total",
            "Recompile-storm episodes journaled, by attributed dimension",
            labelnames=("dim",),
        )

    # -- recording ---------------------------------------------------------

    def note(self, fn: str, **dims: Any) -> bool:
        """Record one invocation of ``fn`` with the dimensions of its
        shape signature. Returns True when the signature is first-seen
        (a miss)."""
        sig = tuple(sorted(dims.items()))
        now = self._monotonic()
        with self._lock:
            seen = self._sigs.setdefault(fn, set())
            if sig in seen:
                self._c_hits.labels(fn=fn).inc()
                return False
            seen.add(sig)
            self._c_compiles.labels(fn=fn).inc()
            self._g_distinct.labels(fn=fn).set(float(len(seen)))
            recent = self._recent.setdefault(fn, deque(maxlen=SIG_HISTORY))
            recent.append((now, dict(dims)))
            storm = self._detect_storm_locked(fn, now)
        if storm is not None:
            self._emit_storm(storm)
        return True

    def time(self, fn: str, **dims: Any) -> _Timer:
        """``with watcher.time("train_step", batch=b): step()`` — notes
        the signature and, on a miss, times the enclosed block into
        ``dlrover_compile_seconds``."""
        return _Timer(self, fn, self.note(fn, **dims), dims)

    def _observe_compile_s(self, fn: str, seconds: float,
                           dims: Optional[Dict[str, Any]] = None) -> None:
        self._h_seconds.observe(seconds)
        with self._lock:
            self._misses.append({"fn": fn, "dims": dict(dims or {}),
                                 "seconds": seconds})

    def misses(self) -> List[Dict[str, Any]]:
        """The timed misses, oldest first (the last ``SIG_HISTORY``):
        ``{fn, dims, seconds}`` each."""
        with self._lock:
            return [dict(m) for m in self._misses]

    # -- storm detection ---------------------------------------------------

    def _detect_storm_locked(self, fn: str,
                             now: float) -> Optional[Dict[str, Any]]:
        recent = self._recent[fn]
        in_window = [(t, d) for t, d in recent
                     if now - t <= self._window_s]
        if len(in_window) < self._threshold:
            # window drained below half the threshold: episode closes
            if (self._storm_open.get(fn)
                    and len(in_window) <= self._threshold // 2):
                self._storm_open[fn] = False
            return None
        if self._storm_open.get(fn):
            return None  # one journal event per episode, not per compile
        self._storm_open[fn] = True
        dim = self._attribute_locked(in_window)
        storm = {
            "fn": fn,
            "dim": dim,
            "count": len(in_window),
            "window_s": self._window_s,
        }
        self._storm_log.append(dict(storm, t=round(now, 3)))
        return storm

    @staticmethod
    def _attribute_locked(in_window: List[Tuple[float, Dict[str, Any]]]
                          ) -> str:
        """The varying dimension: the signature dim with the most
        distinct values across the window's compiles, mapped onto the
        bounded STORM_DIMS vocabulary."""
        distinct: Dict[str, set] = {}
        for _t, dims in in_window:
            for key, val in dims.items():
                distinct.setdefault(key, set()).add(val)
        best_key, best_n = None, 1
        for key in sorted(distinct):
            n = len(distinct[key])
            if n > best_n:
                best_key, best_n = key, n
        if best_key is None:
            return MetricLabel.STORM_DIM_UNKNOWN
        return _DIM_LABELS.get(best_key, MetricLabel.STORM_DIM_UNKNOWN)

    def _emit_storm(self, storm: Dict[str, Any]) -> None:
        self._c_storms.labels(dim=storm["dim"]).inc()
        logger.warning("recompile storm: %s", storm)
        if self._journal is not None:
            self._journal.record(JournalEvent.RECOMPILE_STORM,
                                 source=self._source, **storm)

    # -- consumers ---------------------------------------------------------

    def compile_count(self, fn: Optional[str] = None) -> int:
        with self._lock:
            if fn is not None:
                return len(self._sigs.get(fn, ()))
            return sum(len(s) for s in self._sigs.values())

    def storms(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(s) for s in self._storm_log]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "distinct_signatures": {fn: len(s)
                                        for fn, s in self._sigs.items()},
                "storms": [dict(s) for s in self._storm_log],
                "threshold": self._threshold,
                "window_s": self._window_s,
            }


_default_watcher: Optional[CompileWatcher] = None
_default_lock = threading.Lock()


def get_watcher() -> CompileWatcher:
    """The process-wide watcher the call sites note into. Created lazily
    (journal-less) so a bare engine still counts; ``set_watcher`` swaps
    in a journal-wired one at bootstrap."""
    global _default_watcher
    with _default_lock:
        if _default_watcher is None:
            _default_watcher = CompileWatcher()
        return _default_watcher


def set_watcher(watcher: CompileWatcher) -> CompileWatcher:
    global _default_watcher
    with _default_lock:
        _default_watcher = watcher
    return watcher


def reset_watcher() -> None:
    """Test hook: drop the process watcher (pairs with reset_registry)."""
    global _default_watcher
    with _default_lock:
        _default_watcher = None
