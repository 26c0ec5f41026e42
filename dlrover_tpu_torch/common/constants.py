"""The environment knobs, names and file layout the port reads.

A private copy of the part of ``dlrover_tpu/common/constants.py`` this
package needs (the port imports nothing of the JAX package). Every value
is the reference's own, so an agent of the JAX package and a worker of the
port agree on each environment variable, shared-memory resource and
checkpoint file name.
"""

import os


def env_str(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


def env_int(name: str, default: int = 0) -> int:
    raw = os.environ.get(name, "")
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


def env_float(name: str, default: float = 0.0) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def env_flag(name: str, default: bool = False) -> bool:
    """Truthiness of an env toggle: unset → ``default``; set → anything
    except 0/false/no/off/empty is True."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in ("", "0", "false", "no", "off")


class EnvKey:
    """Environment variables crossing the agent→worker fork boundary."""

    JOB_NAME = "DLROVER_TPU_JOB_NAME"
    MASTER_ADDR = "DLROVER_TPU_MASTER_ADDR"
    NODE_ID = "DLROVER_TPU_NODE_ID"
    NODE_RANK = "DLROVER_TPU_NODE_RANK"
    NODE_NUM = "DLROVER_TPU_NODE_NUM"
    LOCAL_RANK = "DLROVER_TPU_LOCAL_RANK"
    LOCAL_WORLD_SIZE = "DLROVER_TPU_LOCAL_WORLD_SIZE"
    RANK = "DLROVER_TPU_RANK"
    WORLD_SIZE = "DLROVER_TPU_WORLD_SIZE"
    # process-group bootstrap address (set by the agent from the master's
    # rendezvous: the rank-0 host and a free port)
    COORDINATOR_ADDR = "DLROVER_TPU_COORDINATOR_ADDR"
    PROCESS_ID = "DLROVER_TPU_PROCESS_ID"
    NUM_PROCESSES = "DLROVER_TPU_NUM_PROCESSES"
    RESTART_COUNT = "DLROVER_TPU_RESTART_COUNT"
    RDZV_ROUND = "DLROVER_TPU_RDZV_ROUND"
    # checkpoint replica backup-group size (0/1 = off)
    REPLICA_GROUP = "DLROVER_TPU_REPLICA_GROUP"
    # per-agent-incarnation nonce suffixing shm segment names
    SHM_INCARNATION = "DLROVER_TPU_SHM_INCARNATION"


class ConfigKey:
    LOG_LEVEL = "DLROVER_TPU_LOG_LEVEL"
    # trainer/data.py: the auto-tuner's dataloader config file, inherited
    # by agent-forked workers
    PARAL_CONFIG_FILE = "DLROVER_TPU_PARAL_CONFIG_FILE"
    # models/decode.py fused-kernel routing: 1/0 force the decode kernel
    # on/off; default "auto" follows the policy in flash_decode_wanted
    FLASH_DECODE = "DLROVER_TPU_FLASH_DECODE"
    # the agent's unix socket serving SharedLock/SharedQueue/SharedDict
    IPC_SOCKET = "DLROVER_TPU_IPC_SOCKET"
    EVENT_DIR = "DLROVER_TPU_EVENT_DIR"
    # ckpt: per-shard CRC stamping (default on), dirty-shard delta links
    # (the agent's saver; the port writes full bases), and how long a
    # storage save waits out a busy drain before it skips
    CKPT_CRC = "DLROVER_TPU_CKPT_CRC"
    CKPT_DELTA = "DLROVER_TPU_CKPT_DELTA"
    CKPT_STORAGE_WAIT = "DLROVER_TPU_CKPT_STORAGE_WAIT"
    CKPT_STRIPE_BYTES = "DLROVER_TPU_CKPT_STRIPE_BYTES"
    # worker: process-group shutdown and peer-heartbeat timeouts (s)
    DIST_SHUTDOWN_S = "DLROVER_TPU_DIST_SHUTDOWN_S"
    DIST_HEARTBEAT_S = "DLROVER_TPU_DIST_HEARTBEAT_S"


class CheckpointConstant:
    """Flash Checkpoint layout, the reference's file names."""

    TRACKER_FILE = "latest_step.txt"
    DONE_DIR = "._done"
    MANIFEST_PREFIX = "manifest_"
    MANIFEST_SUFFIX = ".mf"
    DELTA_PREFIX = "delta_"
    FRAME_SUFFIX = ".dlrover"


class SharedResourceName:
    """Names of agent-served IPC resources."""

    SAVE_LOCK = "flash_ckpt_save_lock"
    SAVE_EVENT_QUEUE = "flash_ckpt_event_queue"
    SHM_META_DICT = "flash_ckpt_shm_meta"
