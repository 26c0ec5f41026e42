"""Warm worker spares: pre-imported interpreters for fast restarts.

The port's copy of ``dlrover_tpu/agent/warm_spawn.py``. A worker restart
pays for a fresh interpreter and its imports (``numpy``, ``torch``, the
port's worker modules) every incarnation. The agent keeps
:class:`WarmWorkerPool` spares instead: child interpreters that

1. start with the job-static environment and import the heavy modules
   (``DLROVER_TPU_WARM_PREIMPORT``, default ``numpy,torch,
   dlrover_tpu_torch.worker``); importing them touches no device: no
   module of the port calls ``torch.cuda`` at import, so a spare holds no
   CUDA context and caches no device count before its release;
2. block reading one JSON line from stdin;
3. at release merge the incarnation's environment (ranks, world,
   coordinator, rendezvous round, restart count, fault schedule) into
   ``os.environ``, set ``sys.argv`` and ``runpy.run_path`` the script as
   ``__main__``, which is what ``python script.py args...`` does.

Whatever the dynamic loader reads at ``exec`` (``LD_PRELOAD``) must be in
the spare's spawn environment: merged at release it would do nothing. A
spare exits on EOF, so when the agent dies its spares go with it. At
release a spare puts its spawn time, its pre-imports' seconds and its
release time in ``DLROVER_TPU_WARM_SPARE`` (``spawn,import_s,release``).
A spare that fails to release falls back to a cold ``subprocess.Popen``
in the agent, as in the reference.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from typing import Dict, List, Optional, Sequence

from dlrover_tpu_torch.common.constants import ConfigKey, env_str
from dlrover_tpu_torch.common.log import logger

# what a spare imports before it parks on stdin
DEFAULT_PREIMPORTS = "numpy,torch,dlrover_tpu_torch.worker"

_BOOTSTRAP = r"""
import time
_t0 = time.time()
import json, os, runpy, sys
_failed = []
for _m in sys.argv[1].split(","):
    if _m:
        try:
            __import__(_m)
        except Exception as _e:
            _failed.append("%s: %r" % (_m, _e))
_import_s = time.time() - _t0
if len(sys.argv) > 2 and sys.argv[2]:
    try:  # ready; a non-empty marker names the pre-imports that failed
        with open(sys.argv[2], "w") as _f:
            _f.write("; ".join(_failed))
    except OSError:
        pass
_line = sys.stdin.readline()
if not _line:
    sys.exit(0)  # the agent or the pool is gone
_cfg = json.loads(_line)
os.environ.update(_cfg["env"])
os.environ[sys.argv[3]] = "%.6f,%.6f,%.6f" % (_t0, _import_s, time.time())
# an environment update does not reach sys.path: mirror PYTHONPATH, and
# put the script's directory first as `python script.py` does
for _p in os.environ.get("PYTHONPATH", "").split(os.pathsep):
    if _p and _p not in sys.path:
        sys.path.insert(0, _p)
sys.path.insert(0, os.path.dirname(os.path.abspath(_cfg["script"])))
sys.argv = [_cfg["script"]] + list(_cfg.get("args", []))
runpy.run_path(_cfg["script"], run_name="__main__")
"""


class WarmWorkerPool:
    """Keeps ``size`` pre-imported interpreters ready to become workers."""

    def __init__(self, size: int, base_env: Optional[Dict[str, str]] = None,
                 preimports: Optional[str] = None):
        self._size = max(1, size)
        self._base_env = dict(base_env if base_env is not None
                              else os.environ)
        # spares resolve the same package the agent runs
        import dlrover_tpu_torch

        pkg_root = os.path.dirname(os.path.dirname(dlrover_tpu_torch.__file__))
        pythonpath = self._base_env.get("PYTHONPATH", "")
        if pkg_root not in pythonpath.split(os.pathsep):
            self._base_env["PYTHONPATH"] = (
                pkg_root + (os.pathsep + pythonpath if pythonpath else ""))
        self._preimports = (
            preimports if preimports is not None
            else env_str(ConfigKey.WARM_PREIMPORT, DEFAULT_PREIMPORTS))
        self._spares: List[subprocess.Popen] = []
        self._ready_files: Dict[int, str] = {}  # pid -> marker path
        self._ready_dir = tempfile.mkdtemp(prefix="dtpu_warm_")
        self._lock = threading.Lock()
        self._stopped = False
        self._warned_unwarmed: set = set()

    def _spawn_spare(self) -> Optional[subprocess.Popen]:
        marker = os.path.join(self._ready_dir, uuid.uuid4().hex)
        try:
            proc = subprocess.Popen(  # noqa: S603
                [sys.executable, "-c", _BOOTSTRAP, self._preimports, marker,
                 ConfigKey.WARM_SPARE],
                env=self._base_env, stdin=subprocess.PIPE)
        except OSError as e:
            logger.warning("warm spawn pool: spare spawn failed: %r", e)
            return None
        self._ready_files[proc.pid] = marker
        return proc

    def _is_ready(self, proc: subprocess.Popen) -> bool:
        marker = self._ready_files.get(proc.pid)
        return bool(marker) and os.path.exists(marker)

    def ready_count(self) -> int:
        with self._lock:
            return sum(1 for p in self._spares
                       if p.poll() is None and self._is_ready(p))

    def wait_ready(self, n: int = 1, timeout_s: float = 10.0) -> bool:
        """Block (bounded) until ``n`` spares finished their imports. The
        agent gates its first rendezvous on this: a node joining a running
        job stops the world for every peer, so it joins once it can spawn
        fast. Never waits for more spares than are alive."""
        n = min(n, self._size)
        t0 = time.time()
        deadline = t0 + timeout_s
        ok = False
        while time.time() < deadline:
            with self._lock:
                alive = sum(1 for p in self._spares if p.poll() is None)
            if self._stopped or self.ready_count() >= min(n, alive):
                ok = True
                break
            time.sleep(0.05)
        ok = ok or self.ready_count() >= n
        logger.info("warm spawn pool: %s/%s spares ready after %.1fs%s",
                    self.ready_count(), n, time.time() - t0,
                    "" if ok else " (timeout — spawning cold)")
        self._log_unwarmed()
        return ok

    def _log_unwarmed(self) -> None:
        """Name the spares whose pre-imports failed: they pass the gate
        but save nothing."""
        with self._lock:
            markers = dict(self._ready_files)
        for pid, marker in markers.items():
            try:
                with open(marker) as f:
                    failures = f.read().strip()
            except OSError:
                continue
            if failures and pid not in self._warned_unwarmed:
                self._warned_unwarmed.add(pid)
                logger.warning("warm spawn pool: spare pid=%s is ready but "
                               "UNWARMED — pre-imports failed: %s", pid,
                               failures)

    def prewarm(self) -> None:
        with self._lock:
            if self._stopped:
                return
            self._spares = [p for p in self._spares if p.poll() is None]
            while len(self._spares) < self._size:
                spare = self._spawn_spare()
                if spare is None:
                    return
                self._spares.append(spare)

    def take(self, env: Dict[str, str], script: str,
             args: Sequence[str]) -> Optional[subprocess.Popen]:
        """Release a spare into ``script`` with ``env``: the now-working
        process, or None when no live spare is there (the caller spawns
        cold). A replacement spare starts at once."""
        with self._lock:
            if self._stopped:
                return None
            alive = []
            for cand in self._spares:
                if cand.poll() is None:
                    alive.append(cand)
                else:
                    logger.warning("warm spawn pool: spare pid=%s died "
                                   "before use (rc=%s)", cand.pid,
                                   cand.returncode)
                    self._ready_files.pop(cand.pid, None)
            # a spare done importing first, else the oldest one importing
            spare = next((p for p in alive if self._is_ready(p)),
                         alive[0] if alive else None)
            if spare is None:
                self._spares = []
                return None
            alive.remove(spare)
            self._spares = alive
        try:
            line = json.dumps({"env": env, "script": script,
                               "args": list(args)})
            spare.stdin.write((line + "\n").encode())
            spare.stdin.flush()
            spare.stdin.close()
        except (OSError, ValueError) as e:
            logger.warning("warm spawn pool: release failed: %r", e)
            spare.kill()
            try:  # reap it: an unwaited kill leaves a zombie
                spare.wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass
            return None
        finally:
            self._cleanup_marker(spare)
            self.prewarm()
        return spare

    def _cleanup_marker(self, proc: subprocess.Popen) -> None:
        marker = self._ready_files.pop(proc.pid, None)
        if marker:
            try:
                os.unlink(marker)
            except OSError:
                pass

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            spares, self._spares = self._spares, []
        for p in spares:
            try:
                p.stdin.close()  # EOF: the spare exits by itself
            except (OSError, ValueError):
                pass
            try:
                p.wait(timeout=2)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(self._ready_dir, ignore_errors=True)
