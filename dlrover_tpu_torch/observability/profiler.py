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
  duration; the listener runs ``torch.profiler.profile`` with CPU and
  CUDA activities over the next N seconds of whatever the main thread is
  doing, writes a chrome trace into ``DLROVER_TPU_PROFILE_DIR`` and posts
  its path back;
- the hang path requests one automatically: stacks say where the host
  is, the trace what the card was doing.

The listener is its own thread and the agent never waits on it: stopping
the profiler can block on a wedged card (it flushes the device's activity
buffers), and :func:`await_profile` has a timeout. CUPTI's device activity
is process-wide, so the trace holds the main thread's kernels.

On a card, :meth:`ProfileListener.start` (called from the main thread)
first runs one empty profile there: libkineto initialises its client only
on the thread that registered it (the main thread, at import), and a first
profile started on the listener thread leaves the client uninitialised
("External init callback must run in same thread as registerClient") and
the process aborts at exit.
"""

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

    def start(self) -> None:
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
        self._thread = threading.Thread(
            target=self._run, name="profile-listener", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

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
                self._capture(req)
            except Exception:  # noqa: BLE001 — the listener must outlive
                # any single capture failure (full disk, IPC hiccup, …)
                logger.warning("profile capture crashed", exc_info=True)

    def _capture(self, req: dict) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        duration = float(req.get("duration_s", 3.0))
        out_dir = os.path.join(
            self._out_root, f"torch_{self._local_rank}_{req.get('id')}")
        path = os.path.join(out_dir, TRACE_FILE)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        try:
            os.makedirs(out_dir, exist_ok=True)
            prof = profile(activities=activities)
            prof.start()
            # the trace records the main thread's ongoing work; this
            # thread only brackets the window
            time.sleep(duration)
            prof.stop()
            prof.export_chrome_trace(path)
            ok = True
            logger.info("torch.profiler trace (%.1fs) written to %s",
                        duration, path)
        except Exception as e:  # noqa: BLE001 — a failed capture must not
            # kill the worker; report it back instead
            ok = False
            logger.warning("torch.profiler capture failed: %r", e)
        try:
            self._dict.set(done_key(self._local_rank), {
                "id": req.get("id"), "dir": out_dir, "path": path, "ok": ok,
                "ts": time.time(),
            })
        except Exception:  # noqa: BLE001 — incl. RPC dispatch errors; the
            # report is best-effort, the listener must keep serving
            logger.warning("profile report failed", exc_info=True)


def request_profile(profile_dict, local_rank: int,
                    duration_s: float = 3.0) -> str:
    """Agent side: post a request into the (server-local) profile dict.
    Returns the request id to await in ``done/<rank>``."""
    req_id = f"{time.time():.3f}"
    profile_dict[request_key(local_rank)] = {
        "id": req_id, "duration_s": duration_s,
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
