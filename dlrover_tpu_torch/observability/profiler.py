"""On-demand ``torch.profiler`` capture of live workers.

The port's copy of ``dlrover_tpu/observability/profiler.py``. The engine's
event ring (``tpu_timer``) times hooked GEMMs, collectives and copies
always-on; a profiler trace is the deep, heavy view — every kernel the
card ran, CUDA runtime calls, CPU ops — so it is taken on request:

- the worker runs a :class:`ProfileListener` daemon thread, polling the
  agent-served ``profile_requests`` SharedDict (the IPC plane Flash
  Checkpoint uses; it answers while the card is wedged, which is when a
  profile of the wedge is wanted);
- the agent (or an operator through it) posts a request with a
  duration and the thread that is to capture (``thread``):
  - ``main`` (the straggler rule's ``STACK_DUMP``, ``agent/training.py``:
    the worker is live, only slow): the listener hands the request to
    the main thread, whose next step boundary
    (:meth:`ProfileListener.step_boundary`, called by
    ``WorkerContext.report_step`` and ``publish_step``) starts
    ``torch.profiler.profile`` with CPU and CUDA activities; the first
    boundary ``duration_s`` later stops it, writes the chrome trace into
    ``DLROVER_TPU_PROFILE_DIR`` and posts its path back. The request
    waits for a boundary however long a step takes; a worker that stops
    first answers it as failed (:meth:`ProfileListener.stop`);
  - ``listener`` (the default, and the hang path's: the worker is wedged
    and is restarted anyway): the listener captures on its own thread,
    over whatever the process is doing (stacks say where the host is, the
    trace what the card was doing).

A live worker's capture runs on its main thread because libkineto binds
its client to the thread that registered it (the main thread, at
import): a profile of a live CUDA worker started and stopped on another
thread took the worker down at exit ("External init callback must run in
same thread as registerClient", then a SIGABRT or a SIGSEGV). The agent
never waits on a capture: stopping the profiler can block on a wedged
card (it flushes the device's activity buffers), and
:func:`await_profile` has a timeout. CUPTI's device activity is
process-wide, so a listener-thread trace holds the main thread's kernels.

For the listener-thread case, :meth:`ProfileListener.start` (called from
the main thread) first runs one empty profile there, so that libkineto's
client is initialised on its own thread before a capture elsewhere. The
done record names the thread that captured (``thread``: ``main`` or
``listener``). :func:`step_boundary` reaches the process's listener (the
one :func:`~dlrover_tpu_torch.worker.init` started); it costs an
attribute read when nothing is pending.
"""

import atexit
import os
import tempfile
import threading
import time
from typing import Optional

from dlrover_tpu_torch.common.constants import ConfigKey, env_str
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.multi_process import SharedDict

PROFILE_DICT = "profile_requests"
TRACE_FILE = "trace.json"
THREAD_MAIN = "main"
THREAD_LISTENER = "listener"

# the process's listener, which step_boundary() serves
_active: Optional["ProfileListener"] = None


def request_key(local_rank: int) -> str:
    return f"req/{local_rank}"


def done_key(local_rank: int) -> str:
    return f"done/{local_rank}"


def default_profile_dir() -> str:
    return env_str(ConfigKey.PROFILE_DIR) or os.path.join(
        tempfile.gettempdir(), "dlrover_tpu_profiles")


def _init_profiler_here() -> None:
    """One empty CPU + CUDA profile on the calling thread, where CUDA is
    up: libkineto initialises its client on this thread, so a later
    profile from the listener thread finds it ready."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            pass
    except Exception:  # noqa: BLE001 — a profiler that cannot start here
        # will fail its captures, which report back; the worker goes on
        logger.warning("torch.profiler warm-up failed", exc_info=True)


class _Capture:
    """A profile in flight, started and stopped on one thread."""

    def __init__(self, req: dict, prof, out_dir: str, end: float):
        self.req = req
        self.prof = prof
        self.out_dir = out_dir
        self.end = end


class ProfileListener:
    """Worker-side daemon serving profile requests for this process."""

    def __init__(self, ipc_socket: str, local_rank: int,
                 out_root: Optional[str] = None, poll_s: float = 1.0):
        self._dict = SharedDict(PROFILE_DICT, ipc_socket)
        self._local_rank = local_rank
        self._out_root = out_root or default_profile_dir()
        self._poll_s = poll_s
        self._last_id = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # the request handed to the main thread, and the capture it runs
        self._offer: Optional[dict] = None
        self._live: Optional[_Capture] = None

    def start(self) -> None:
        global _active
        _init_profiler_here()
        # seed the dedup id from any pre-existing request: a relaunched
        # worker must not replay the pre-restart hang request and trace
        # its own startup noise
        try:
            stale = self._dict.get(request_key(self._local_rank))
            if stale:
                self._last_id = stale.get("id")
        except OSError:
            pass
        _active = self
        # an exit that skips worker.shutdown still ends a main-thread
        # capture on the main thread
        atexit.register(self.stop, 5.0)
        self._thread = threading.Thread(
            target=self._run, name="profile-listener", daemon=True
        )
        self._thread.start()

    def stop(self, timeout_s: float = 30.0) -> None:
        """Stop serving. On the main thread this also ends a capture it
        runs (written and reported as usual) and answers a request it has
        not taken as failed; then waits (at most ``timeout_s``) for the
        listener thread."""
        global _active
        self._stop.set()
        if threading.current_thread() is threading.main_thread():
            with self._lock:
                live, self._live = self._live, None
                offer, self._offer = self._offer, None
            if live is not None:
                self._finish(live)
            if offer is not None:
                # the worker ends before a boundary took the request:
                # answer it as failed rather than leave the agent waiting
                self._report(offer, self._out_dir(offer), False,
                             THREAD_MAIN)
        if _active is self:
            _active = None
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout_s)

    # -- the main thread's side ---------------------------------------------

    def step_boundary(self) -> None:
        """A step boundary on the main thread: stop a capture whose window
        has passed, or start the one the listener handed over."""
        if self._live is None and self._offer is None:
            return
        if threading.current_thread() is not threading.main_thread():
            return
        live = self._live
        if live is not None:
            if time.monotonic() >= live.end:
                self._live = None
                self._finish(live)
            return
        with self._lock:
            offer, self._offer = self._offer, None
        if offer is not None:
            self._live = self._begin(offer)

    # -- the listener thread's side ------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            try:
                req = self._dict.get(request_key(self._local_rank))
            except OSError:
                continue  # agent IPC briefly down (restart) — keep polling
            if not req or req.get("id") == self._last_id:
                continue
            self._last_id = req.get("id")
            try:
                self._serve(req)
            except Exception:  # noqa: BLE001 — the listener must outlive
                # any single capture failure (full disk, IPC hiccup, …)
                logger.warning("profile capture crashed", exc_info=True)

    def _serve(self, req: dict) -> None:
        """Hand a ``main`` request to the main thread (a request it has
        not taken yet is superseded, and answered as failed); capture any
        other here, cut short when the listener stops (the process is
        ending)."""
        if req.get("thread") == THREAD_MAIN:
            with self._lock:
                stale, self._offer = self._offer, req
            if stale is not None:
                self._report(stale, self._out_dir(stale), False,
                             THREAD_MAIN)
            return
        live = self._begin(req)
        if live is None:
            return
        # the trace records the main thread's ongoing work; this thread
        # only brackets the window
        self._stop.wait(max(0.0, live.end - time.monotonic()))
        self._finish(live)

    # -- one capture ------------------------------------------------------

    def _out_dir(self, req: dict) -> str:
        return os.path.join(self._out_root,
                            f"torch_{self._local_rank}_{req.get('id')}")

    def _begin(self, req: dict) -> Optional[_Capture]:
        """Start a profile on the calling thread; None (reported failed)
        when it cannot start."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        out_dir = self._out_dir(req)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        try:
            os.makedirs(out_dir, exist_ok=True)
            prof = profile(activities=activities)
            prof.start()
        except Exception as e:  # noqa: BLE001 — a failed capture must not
            # kill the worker; report it back instead
            logger.warning("torch.profiler capture failed: %r", e)
            self._report(req, out_dir, False, _thread_name())
            return None
        return _Capture(req, prof, out_dir,
                        time.monotonic() + float(req.get("duration_s", 3.0)))

    def _finish(self, live: _Capture) -> None:
        """Stop ``live`` on the thread that started it, write its trace
        and report it."""
        req = live.req
        path = os.path.join(live.out_dir, TRACE_FILE)
        try:
            live.prof.stop()
            live.prof.export_chrome_trace(path)
            ok = True
            logger.info("torch.profiler trace (%.1fs) written to %s",
                        float(req.get("duration_s", 3.0)), path)
        except Exception as e:  # noqa: BLE001 — a failed capture must not
            # kill the worker; report it back instead
            ok = False
            logger.warning("torch.profiler capture failed: %r", e)
        self._report(req, live.out_dir, ok, _thread_name())

    def _report(self, req: dict, out_dir: str, ok: bool, thread: str):
        try:
            self._dict.set(done_key(self._local_rank), {
                "id": req.get("id"), "dir": out_dir,
                "path": os.path.join(out_dir, TRACE_FILE), "ok": ok,
                "thread": thread, "ts": time.time(),
            })
        except Exception:  # noqa: BLE001 — incl. RPC dispatch errors; the
            # report is best-effort, the listener must keep serving
            logger.warning("profile report failed", exc_info=True)


def _thread_name() -> str:
    return (THREAD_MAIN if threading.current_thread()
            is threading.main_thread() else THREAD_LISTENER)


def step_boundary() -> None:
    """A step boundary of this process's main thread: serves the
    listener :func:`~dlrover_tpu_torch.worker.init` started, if any."""
    listener = _active
    if listener is not None:
        listener.step_boundary()


def stop_listener() -> None:
    """Stop this process's listener, if any (on the main thread: its
    capture ends and is reported first)."""
    listener = _active
    if listener is not None:
        listener.stop()


def request_profile(profile_dict, local_rank: int,
                    duration_s: float = 3.0,
                    thread: str = THREAD_LISTENER) -> str:
    """Agent side: post a request into the (server-local) profile dict,
    to be captured by the worker's ``thread`` (:data:`THREAD_MAIN` for a
    live worker, between its steps; :data:`THREAD_LISTENER` for a wedged
    one). Returns the request id to await in ``done/<rank>``."""
    req_id = f"{time.time():.3f}"
    profile_dict[request_key(local_rank)] = {
        "id": req_id, "duration_s": duration_s, "thread": thread,
    }
    return req_id


def await_profile(profile_dict, local_rank: int, req_id: str,
                  timeout_s: float = 60.0) -> Optional[dict]:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        done = profile_dict.get(done_key(local_rank))
        if done and done.get("id") == req_id:
            return done
        time.sleep(0.2)
    return None
