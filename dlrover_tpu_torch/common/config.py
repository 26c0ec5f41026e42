"""Process-wide tunables: the ``Context`` singleton and its defaults.

The port's copy of ``dlrover_tpu/common/config.py``, trimmed to the knobs
its master, agent and checkpoint saver read. Each value starts from
:class:`DefaultValues` and is overridden by ``DLROVER_TPU_<NAME>`` in the
environment (``DLROVER_TPU_HANG_DOWNTIME_S=60``) or by ``set``; the names
and defaults are the reference's, so one environment tunes both packages
alike.
"""

import os
import threading
from dataclasses import dataclass
from typing import Any, Dict


@dataclass
class DefaultValues:
    # --- rendezvous ---
    rdzv_timeout_s: float = 600.0
    rdzv_lastcall_s: float = 3.0
    # --- heartbeats / liveness ---
    heartbeat_interval_s: float = 15.0
    heartbeat_timeout_s: float = 300.0
    # grace after a heartbeat connection drops before the node is declared
    # dead (covers benign reconnects)
    conn_drop_grace_s: float = 1.0
    # --- restarts ---
    # SIGTERM -> SIGKILL window when stopping workers for a restart
    worker_stop_grace_s: float = 3.0
    # the same window for workers judged wedged (the hang rule): they never
    # exit on SIGTERM, and the frame seal makes the fast SIGKILL safe
    wedged_kill_grace_s: float = 0.5
    node_max_relaunch: int = 3
    # --- hang detection ---
    hang_downtime_s: float = 1800.0
    diagnosis_interval_s: float = 60.0
    # how often an agent reports host and card usage to the master
    resource_report_interval_s: float = 15.0
    # observe-only unless set: the hang rule then restarts the workers
    hang_restart_workers: bool = False
    # --- flash checkpoint ---
    ckpt_save_workers: int = 8
    ckpt_commit_poll_s: float = 0.1
    # --- data shards ---
    # a dispatched shard not reported within this window is requeued,
    # measured on the master's monotonic clock
    shard_lease_timeout_s: float = 600.0
    shard_lease_check_s: float = 5.0


def _cast_env(env: str, default: Any) -> Any:
    if isinstance(default, bool):
        return env.strip().lower() in ("1", "true", "yes", "on")
    return type(default)(env)


class Context:
    """Process-wide config singleton."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        self._values: Dict[str, Any] = {}
        defaults = DefaultValues()
        for name in defaults.__dataclass_fields__:
            default = getattr(defaults, name)
            env = os.getenv("DLROVER_TPU_" + name.upper())
            if env is not None:
                default = _cast_env(env, default)
            self._values[name] = default

    def __getattr__(self, name: str) -> Any:
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        raise AttributeError(name)

    def set(self, name: str, value: Any) -> None:
        self._values[name] = value

    @classmethod
    def singleton(cls) -> "Context":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._instance = None


def get_context() -> Context:
    return Context.singleton()
