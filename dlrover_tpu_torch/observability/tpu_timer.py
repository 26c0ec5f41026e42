"""ctypes bindings for the port's native device timer
(``dlrover_tpu_torch/tpu_timer/``) and the worker-side hooks.

The port's copy of ``dlrover_tpu/observability/tpu_timer.py``:

- :meth:`TpuTimer.install` starts the engine (per-rank metrics endpoint,
  hang watchdog) and the CUDA hook. The hook is an ``LD_PRELOAD`` library
  (upstream xpu_timer's design; the agent sets ``LD_PRELOAD`` for its
  workers) timing every cuBLAS GEMM, NCCL collective and
  ``cudaMemcpyAsync`` with CUDA events; the reference's PJRT api-table
  patch and ``find_libtpu`` have no counterpart here.
- :meth:`TpuTimer.enable_gc_hook` / :meth:`TpuTimer.count_dataloader_batch`
  feed the ``XPU_TIMER_COMMON_{GC_COUNT,DATA_LOADER_COUNT}`` gauges.
- SIGUSR1 armed for stacks: the native hang watchdog (or the daemon's
  ``/dump_stack``) raises the signal and every Python thread's stack
  lands in ``/tmp/tpu_timer_pystack_<pid>.txt``. Departure from the
  reference (ROADMAP C22): the reference registers ``faulthandler``'s
  all-threads dump on the signal, which reads the other threads' frames
  from inside the handler while they run, and a worker whose other
  threads ran Python at that moment died of a SIGSEGV. Here the signal
  only wakes a watcher thread (``signal.set_wakeup_fd``), which writes
  the same ``faulthandler`` text holding the GIL, so no thread's frames
  change under it. A thread that holds the GIL through a wedge (a C call
  that does not release it) delays the dump until it lets go.
- :meth:`TpuTimer.op_telemetry`: the op-class telemetry the worker
  publishes for the master's skew monitor (``observability/
  op_telemetry.py``). With the library loaded the native engine keeps it
  over everything it records (the hook's GEMMs and collectives and the
  Python spans, ``tt_op_telemetry``) and a span does not also observe in
  Python, so it counts once; without the library the spans feed the
  pure-Python accumulator, as in the reference.

Departure from the reference (ROADMAP C13): the reference is a silent
no-op when its library is missing. Here ``install`` raises when the
library is not loaded, when it lacks ``tt_op_telemetry`` (a build of older
sources), when its hook is not the process's definition of the hooked
symbols (``LD_PRELOAD`` unset), and, for a CUDA device, when
``libcuda.so.1`` cannot be loaded: a timer the agent asked for never
quietly measures nothing, nor sends empty telemetry. Without ``install``
the recording methods stay no-ops when the library is absent, as in the
reference.
"""

import ctypes
import faulthandler
import gc
import json
import os
import signal
import threading
import time
from typing import Callable, Optional

from dlrover_tpu_torch.common.constants import ConfigKey, env_int, env_str
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.observability.op_telemetry import get_accumulator

ENV_LIB = ConfigKey.TPU_TIMER_LIB
ENV_PORT = ConfigKey.TPU_TIMER_PORT
DEFAULT_WORKER_PORT_BASE = 18900
DAEMON_PORT = 18889

KIND_MM = 0
KIND_COLL = 1
KIND_MEMORY = 2


def find_library() -> Optional[str]:
    """Locate the hook library: ``$TPU_TIMER_LIB``, then the build of the
    current sources (``dlrover_tpu_torch/tpu_timer/build.py``), which this
    does not start."""
    cand = env_str(ConfigKey.TPU_TIMER_LIB)
    if cand and os.path.exists(cand):
        return cand
    from dlrover_tpu_torch.tpu_timer import build

    built = build.library_path()
    return str(built) if built.exists() else None


def _is_cuda(device) -> bool:
    if device is None:
        return False
    return str(getattr(device, "type", device)).split(":")[0] == "cuda"


def _read_text(fn) -> str:
    """A text the engine copies out (``fn(buf, cap)`` returns its full
    length): the engine records on other threads between the sizing call
    and the copy, so a text that outgrew the buffer is read again."""
    n = fn(None, 0)
    while True:
        cap = n + 4096
        buf = ctypes.create_string_buffer(cap)
        n = fn(buf, cap)
        if n < cap:
            return buf.value.decode()


def arm_stack_dump(signum: int, out) -> Callable[[], None]:
    """Make ``signum`` append every Python thread's stack to ``out`` (an
    open text file), written by a watcher thread that holds the GIL
    (module docstring, ROADMAP C22). Call from the main thread
    (``signal.signal`` requires it). Returns the function that disarms
    it: the handler and wakeup fd it replaced come back, the watcher
    ends."""
    read_fd, write_fd = os.pipe()
    os.set_blocking(write_fd, False)
    # a Python-level handler is what makes the interpreter's C handler
    # write the signal's number into the wakeup fd
    prev_handler = signal.signal(signum, lambda *_: None)
    prev_fd = signal.set_wakeup_fd(write_fd, warn_on_full_buffer=False)

    def watch():
        while True:
            try:
                data = os.read(read_fd, 512)
            except OSError:
                return  # the pipe was closed: disarmed
            if not data:
                return
            if prev_fd != -1:
                # whoever watched the wakeup fd before still sees its bytes
                try:
                    os.write(prev_fd, data)
                except OSError:
                    pass
            if signum in data:
                try:
                    faulthandler.dump_traceback(file=out, all_threads=True)
                    out.flush()
                except (OSError, ValueError):
                    return  # the file was closed: disarmed

    threading.Thread(target=watch, name="tpu-timer-pystack",
                     daemon=True).start()

    def disarm() -> None:
        try:
            signal.set_wakeup_fd(prev_fd)
            signal.signal(signum, prev_handler)
        except ValueError:
            pass  # not the main thread: the process is ending anyway
        for fd in (write_fd, read_fd):
            try:
                os.close(fd)
            except OSError:
                pass

    return disarm


class TpuTimer:
    """One per worker process. Wraps the native engine; its recording
    methods are no-ops when the library is not loaded."""

    def __init__(self, lib_path: Optional[str] = None):
        self._lib = None
        path = lib_path or find_library()
        if path:
            try:
                self._lib = ctypes.CDLL(path)
            except OSError as e:
                logger.warning("tpu_timer native lib load failed: %s", e)
        if self._lib is not None:
            lib = self._lib
            lib.tt_prometheus.restype = ctypes.c_int
            lib.tt_trace_json.restype = ctypes.c_int
            lib.tt_begin.restype = ctypes.c_uint64
            lib.tt_begin.argtypes = [ctypes.c_int, ctypes.c_char_p]
            lib.tt_end.argtypes = [ctypes.c_uint64, ctypes.c_double]
            lib.tt_record.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                      ctypes.c_double, ctypes.c_double]
            lib.tt_set_gauge.argtypes = [ctypes.c_char_p, ctypes.c_double]
            lib.tt_inc_counter.argtypes = [ctypes.c_char_p, ctypes.c_double]
            lib.tt_set_hang_timeout.argtypes = [ctypes.c_double]
            lib.tt_hook_pending.restype = ctypes.c_longlong
            lib.tt_hook_stuck_seconds.restype = ctypes.c_double
        self._path = path
        self._gc_t0 = 0.0
        self._installed = False
        self._stack_file = None
        self._disarm_stacks = None

    @property
    def available(self) -> bool:
        return self._lib is not None

    # -- lifecycle ----------------------------------------------------------
    def install(
        self,
        rank: int = 0,
        world_size: int = 1,
        local_rank: int = 0,
        port: Optional[int] = None,
        hang_timeout_s: Optional[float] = None,
        stack_dump_signal: int = signal.SIGUSR1,
        device=None,
    ) -> bool:
        """Start the engine and the hook. Call after the device is up, from
        the worker process. Port defaults to base + local rank so the
        per-host daemon can scrape every worker. Raises when the library
        is not loaded or not preloaded, or (``device`` a card) when the
        driver cannot be loaded."""
        if self._lib is None:
            raise RuntimeError(
                "tpu_timer: the hook library is not loaded (set "
                f"{ConfigKey.TPU_TIMER_LIB} or build it with python -m "
                "dlrover_tpu_torch.tpu_timer.build)")
        if self._installed:
            # elastic re-init calls install() again; the engine, port and
            # faulthandler registration are already live
            return True
        if not hasattr(self._lib, "tt_op_telemetry"):
            raise RuntimeError(
                f"tpu_timer: {self._path} has no tt_op_telemetry (a build "
                "of older sources): rebuild it with python -m "
                "dlrover_tpu_torch.tpu_timer.build")
        if not self._lib.tt_hook_interposed():
            raise RuntimeError(
                f"tpu_timer: {self._path} is loaded but not preloaded, so "
                "its hook sees no CUDA call: start the process with "
                f"LD_PRELOAD={self._path}")
        if port is None:
            base = env_int(ConfigKey.TPU_TIMER_PORT, DEFAULT_WORKER_PORT_BASE)
            port = base + local_rank
        if hang_timeout_s is not None:
            self._lib.tt_set_hang_timeout(float(hang_timeout_s))
        if stack_dump_signal:
            path = f"/tmp/tpu_timer_pystack_{os.getpid()}.txt"
            self._stack_file = open(path, "w")  # noqa: SIM115 — held open
            self._disarm_stacks = arm_stack_dump(int(stack_dump_signal),
                                                 self._stack_file)
            self._lib.tt_set_hang_signal(int(stack_dump_signal))
        rc = self._lib.tt_init(int(rank), int(world_size), int(local_rank),
                               int(port))
        self._installed = True
        if rc != 0 and _is_cuda(device):
            self.shutdown()
            raise RuntimeError(
                "tpu_timer: libcuda.so.1 could not be loaded, so the hook "
                "cannot time the card")
        logger.info("tpu_timer: engine on :%s, CUDA hook %s", port,
                    "live" if rc == 0 else "inert (no driver)")
        return True

    def shutdown(self) -> None:
        if self._disarm_stacks is not None:
            self._disarm_stacks()
            self._disarm_stacks = None
        if self._stack_file is not None:
            try:
                self._stack_file.close()
            except OSError:
                pass
            self._stack_file = None
        self._installed = False
        if self._lib:
            self._lib.tt_shutdown()

    # -- recording ----------------------------------------------------------
    # the op-class telemetry: the native engine's while the library is
    # loaded, the pure-Python accumulator's otherwise (never both)
    def record(self, kind: int, name: str, dur_us: float,
               payload: float = 0.0) -> None:
        if self._lib:
            self._lib.tt_record(kind, name.encode(), float(dur_us),
                                float(payload))
        else:
            get_accumulator().observe_span(kind, name, dur_us)

    def begin(self, kind: int, name: str) -> int:
        return self._lib.tt_begin(kind, name.encode()) if self._lib else 0

    def end(self, token: int, payload: float = 0.0) -> None:
        if self._lib and token:
            self._lib.tt_end(token, float(payload))

    class _Span:
        def __init__(self, timer: "TpuTimer", kind: int, name: str,
                     payload: float):
            self._t, self._kind, self._name = timer, kind, name
            self._payload = payload
            self._tok = 0
            self._t0 = 0.0

        def __enter__(self):
            if self._t._lib is None:
                # a collective's entry is marked before it runs: a hung
                # collective never exits
                if self._kind == KIND_COLL:
                    get_accumulator().enter_collective(self._name)
                self._t0 = time.monotonic()
            self._tok = self._t.begin(self._kind, self._name)
            return self

        def __exit__(self, *exc):
            self._t.end(self._tok, self._payload)
            if self._t._lib is None:
                get_accumulator().observe_span(
                    self._kind, self._name,
                    (time.monotonic() - self._t0) * 1e6)
            return False

    def span(self, name: str, kind: int = KIND_MM,
             payload: float = 0.0) -> "_Span":
        """``with timer.span("train_step", payload=flops):`` — a host
        bracket feeding the MM latency family and the hang watchdog."""
        return TpuTimer._Span(self, kind, name, payload)

    def set_gauge(self, name: str, value: float) -> None:
        if self._lib:
            self._lib.tt_set_gauge(name.encode(), float(value))

    # -- python-plane tracing (GC / dataloader) -----------------------------
    def enable_gc_hook(self) -> None:
        """Count GC pauses into XPU_TIMER_COMMON_GC_COUNT."""
        if not self._lib:
            return

        def _cb(phase, info):
            if phase == "start":
                self._gc_t0 = time.monotonic()
            elif phase == "stop":
                self._lib.tt_inc_counter(b"GC_COUNT", 1.0)
                dur_us = (time.monotonic() - self._gc_t0) * 1e6
                self._lib.tt_record(KIND_MM, b"py_gc", dur_us, 0.0)

        gc.callbacks.append(_cb)

    def count_dataloader_batch(self, n: int = 1) -> None:
        if self._lib:
            self._lib.tt_inc_counter(b"DATA_LOADER_COUNT", float(n))

    # -- the hook -----------------------------------------------------------
    def set_hook_enabled(self, on: bool) -> None:
        """Record hooked calls (default) or pass them straight through."""
        if self._lib:
            self._lib.tt_hook_set_enabled(1 if on else 0)

    def pending(self) -> int:
        """Hooked ops whose end event the poller has not seen complete."""
        return int(self._lib.tt_hook_pending()) if self._lib else 0

    def stuck_seconds(self) -> float:
        """How long the longest-stuck stream has shown no completed event
        while an op on it is incomplete (0: none)."""
        return float(self._lib.tt_hook_stuck_seconds()) if self._lib else 0.0

    def wait_drained(self, timeout_s: float = 10.0) -> bool:
        """Wait until the poller has read every hooked op's events."""
        deadline = time.monotonic() + timeout_s
        while self.pending() > 0:
            if time.monotonic() > deadline:
                return False
            time.sleep(0.005)
        return True

    # -- readout ------------------------------------------------------------
    def prometheus_text(self) -> str:
        return _read_text(self._lib.tt_prometheus) if self._lib else ""

    def trace_json(self) -> str:
        return (_read_text(self._lib.tt_trace_json) if self._lib
                else '{"traceEvents":[]}')

    def dump_trace(self, path: str) -> bool:
        return bool(self._lib) and \
            self._lib.tt_dump_trace(path.encode()) == 0

    def op_telemetry(self) -> dict:
        """The cumulative op-class telemetry snapshot (``op_telemetry.py``'s
        wire format): the native engine's when the library is loaded (a
        library without ``tt_op_telemetry`` raises), else the pure-Python
        accumulator's."""
        if self._lib is None:
            return get_accumulator().snapshot()
        if not hasattr(self._lib, "tt_op_telemetry"):
            raise RuntimeError(
                f"tpu_timer: {self._path} has no tt_op_telemetry")
        snap = json.loads(_read_text(self._lib.tt_op_telemetry))
        # the C side prints whole sums without a point: floats, as the
        # Python accumulator's wire carries them
        for wire in snap["classes"].values():
            wire["sum"] = float(wire["sum"])
            wire["max"] = float(wire["max"])
        return snap

    def hang_detected(self) -> bool:
        return bool(self._lib) and self._lib.tt_hang_detected() == 1


_global_timer: Optional[TpuTimer] = None


def get_timer() -> TpuTimer:
    """Process-wide singleton (upstream's GpuTimerManager singleton)."""
    global _global_timer
    if _global_timer is None:
        _global_timer = TpuTimer()
    return _global_timer


# -- user-function tracepoints ----------------------------------------------


def trace_function(fn=None, *, name: Optional[str] = None,
                   kind: int = KIND_MM):
    """Decorator: every call becomes a span in the native trace buffer
    (visible in ``/dump_trace`` next to the hooked GEMMs and collectives).

    Usable bare (``@trace_function``) or configured
    (``@trace_function(name="data::tokenize")``). Without the library the
    call passes through.
    """
    import functools

    def wrap(f):
        label = name or f"py::{f.__module__}.{f.__qualname__}"

        @functools.wraps(f)
        def inner(*args, **kwargs):
            with get_timer().span(label, kind=kind):
                return f(*args, **kwargs)

        inner.__tracepoint__ = True
        return inner

    return wrap(fn) if fn is not None else wrap


def install_tracepoints(specs=None) -> int:
    """Wrap configured functions in place; returns how many installed.

    ``specs``: iterable of ``"module:attr.path"``; ``None`` reads the
    comma-separated ``DLROVER_TPU_TRACE_FUNCS`` env, which the agent
    forwards to its workers.
    """
    import importlib

    if specs is None:
        env = env_str(ConfigKey.TRACE_FUNCS, "")
        specs = [s for s in (p.strip() for p in env.split(",")) if s]
    installed = 0
    for spec in specs:
        try:
            mod_name, _, attr_path = spec.partition(":")
            parent = importlib.import_module(mod_name)
            parts = attr_path.split(".")
            for p in parts[:-1]:
                parent = getattr(parent, p)
            leaf = getattr(parent, parts[-1])
            if getattr(leaf, "__tracepoint__", False):
                continue  # idempotent across elastic re-inits
            setattr(parent, parts[-1],
                    trace_function(leaf, name=f"py::{spec}"))
            installed += 1
        except Exception:  # noqa: BLE001 — tracing must never kill training
            logger.warning("tracepoint %r failed to install", spec,
                           exc_info=True)
    return installed
