"""The environment knobs, names, enums and file layout the port reads.

A private copy of the part of ``dlrover_tpu/common/constants.py`` this
package needs (the port imports nothing of the JAX package). Every value
is the reference's own, so the agents, masters and workers of the two
packages agree on each environment variable, node status, action name,
shared-memory resource and checkpoint file name.
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


class NodeType:
    MASTER = "master"
    WORKER = "worker"
    # a decode-serving replica: it shares the worker's liveness plane, but
    # its death leaves the routable set instead of re-forming the world
    SERVE = "serve"


class NodeStatus:
    INITIAL = "initial"
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    DELETED = "deleted"
    BREAKDOWN = "breakdown"

    @classmethod
    def terminal(cls, status: str) -> bool:
        return status in (cls.SUCCEEDED, cls.FAILED, cls.DELETED)


class NodeEventType:
    ADDED = "added"
    MODIFIED = "modified"
    DELETED = "deleted"


class NodeExitReason:
    """Why a node terminated."""

    SUCCEEDED = "succeeded"
    KILLED = "killed"
    OOM = "oom"
    FATAL_ERROR = "fatal_error"
    HARDWARE_ERROR = "hardware_error"
    PREEMPTED = "preempted"
    RELAUNCHED = "relaunched"
    NO_HEARTBEAT = "no_heartbeat"
    UNKNOWN = "unknown"


class JobStage:
    INIT = "init"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"


class RendezvousName:
    TRAINING = "training"
    NODE_CHECK = "node-check"


class DiagnosisActionType:
    NONE = "no_action"
    # agent level
    RESTART_WORKER = "restart_worker"
    RELAUNCH_WORKER = "relaunch_worker"
    STACK_DUMP = "stack_dump"
    CHECKPOINT = "checkpoint"
    # master level
    MASTER_RELAUNCH_WORKER = "master_relaunch_worker"
    JOB_ABORT = "job_abort"
    EVENT = "event"


class DiagnosisConstant:
    MASTER_INSTANCE = -1
    ANY_INSTANCE = -2
    ACTION_EXPIRY_S = 60 * 5


class TrainingExceptionLevel:
    RDZV_ERROR = "rdzv_error"
    PROCESS_ERROR = "process_error"
    NODE_ERROR = "node_error"
    WARNING = "warning"
    INFO = "info"


class ChaosSite:
    """Fault-injection site names (``chaos/injector.py``) of the port's
    modules."""

    RPC_SEND = "rpc.send"
    RPC_RECV = "rpc.recv"
    SHM_WRITE = "shm.write"
    KV_WAIT = "kv.wait"
    RDZV_JOIN = "rdzv.join"
    # the state-movement fabric (common/fabric.py)
    FABRIC_CONNECT = "fabric.connect"
    FABRIC_STRIPE = "fabric.stripe"
    STORAGE_PERSIST = "storage.persist"
    STORAGE_COMMIT = "storage.commit"
    # the elastic decode-serving plane (serving/)
    SERVE_REQUEST = "serve.request"
    SERVE_REPLICA = "serve.replica"
    SERVE_PREFIX = "serve.prefix"
    DATA_DISPATCH = "data.dispatch"
    # the live-reshard plane (ckpt/reshard.py): before planning
    RESHARD_PLAN = "reshard.plan"
    # the memory accountant (observability/memory.py): an injected error
    # here forces the pressure → journal → bundle path
    MEM_PRESSURE = "mem.pressure"


class SpanName:
    """Span and span-event names of ``observability/tracing.py``: the
    reference's, so a JAX peer's spans and a port peer's join one arc."""

    # the rendezvous arc (agent/master_client.py and agent/training.py on
    # the client, master/rdzv_manager.py on the master)
    RDZV_CLIENT_ROUND = "rdzv.client_round"
    RDZV_JOIN = "rdzv.join"
    RDZV_WORLD_WAIT = "rdzv.world_wait"
    RDZV_WORLD_CUT = "rdzv.world_cut"
    # the Flash Checkpoint arc (ckpt/engine.py in the worker,
    # ckpt/ckpt_saver.py in the agent)
    CKPT_SAVE_MEMORY = "ckpt.save_to_memory"
    CKPT_DRAIN = "ckpt.drain"
    CKPT_PERSIST_REQUEST = "ckpt.persist_request"
    CKPT_PERSIST = "ckpt.persist"
    CKPT_COMMIT = "ckpt.commit"
    CKPT_RESTORE = "ckpt.restore"
    # one striped multi-source transfer session, client side
    FABRIC_FETCH = "fabric.fetch"
    # the live-reshard rung (ckpt/reshard.py): plan, transfers, assembly
    RESHARD_PLAN = "reshard.plan"
    RESHARD_XFER = "reshard.xfer"
    RESHARD_APPLY = "reshard.apply"
    # an applied training scale plan (master/auto_scaler.py)
    SCALE_APPLY = "scale.apply"
    SCALE_RDZV_PARAMS = "scale.update_rdzv_params"
    # the serving plane: routing one request, the replica's handling of
    # it, a planned drain and an applied serve plan
    SERVE_ROUTE = "serve.route"
    SERVE_GENERATE = "serve.generate"
    SERVE_DRAIN = "serve.drain"
    SERVE_SCALE = "serve.scale"
    # a request's waterfall (serving/batcher.py): queue-wait →
    # prefill-compute → first-step, then one decode segment; spec_verify
    # brackets one speculative verify (serving/speculative.py)
    SERVE_QUEUE_WAIT = "serve.queue_wait"
    SERVE_PREFILL_COMPUTE = "serve.prefill_compute"
    SERVE_FIRST_STEP = "serve.first_step"
    SERVE_DECODE = "serve.decode"
    SERVE_SPEC_VERIFY = "serve.spec_verify"
    # the detect → relaunch arc (master/master.py → agent/training.py)
    FAULT_RELAUNCH = "fault.relaunch"
    AGENT_RESTART_WORKERS = "agent.restart_workers"
    # the straggler rule's evidence capture on the agent
    AGENT_STACK_DUMP = "agent.stack_dump"
    # span events: the retry plane, the chaos plane, serving re-routes
    EVT_RPC_RETRY = "rpc.retry"
    EVT_BREAKER_OPEN = "rpc.breaker_open"
    EVT_FAULT_INJECTED = "chaos.fault_injected"
    EVT_SERVE_REROUTED = "serve.rerouted"


class MetricLabel:
    """Label values of the port's metric families."""

    # the dominant causes serving/tail.py gives a slow request
    TAIL_QUEUE = "queue"
    TAIL_PREFILL = "prefill"
    TAIL_BATCH_INTERFERENCE = "batch_interference"
    TAIL_SPECULATIVE_MISS = "speculative_miss"
    TAIL_PREFIX_MISS = "prefix_miss"
    TAIL_REROUTE = "reroute"
    TAIL_CAUSES = (
        TAIL_QUEUE, TAIL_PREFILL, TAIL_BATCH_INTERFERENCE,
        TAIL_SPECULATIVE_MISS, TAIL_PREFIX_MISS, TAIL_REROUTE,
    )
    # SLO burn windows (observability/slo.py)
    WINDOW_FAST = "fast"
    WINDOW_SLOW = "slow"
    # the restore rung that won an incident (observability/incidents.py),
    # as the restore's journaled medium, or unknown
    RUNG_RESHARD = "reshard"
    RUNG_SHM = "shm"
    RUNG_CHAIN = "chain"
    RUNG_REPLICA = "replica"
    RUNG_STORAGE = "storage"
    RUNG_UNKNOWN = "unknown"
    RESTORE_RUNGS = (
        RUNG_RESHARD, RUNG_SHM, RUNG_CHAIN, RUNG_REPLICA, RUNG_STORAGE,
        RUNG_UNKNOWN,
    )
    # the checkpoint-commit trigger the incident stitcher's counterfactual
    # scores (a brain's pre-emptive save)
    CKPT_TRIGGER_PREEMPTIVE = "preemptive"
    # device-memory ledger categories (observability/memory.py): every
    # byte the accountant tracks is attributed to exactly one
    MEM_PARAMS = "params"
    MEM_OPT_STATE = "opt_state"
    MEM_ACTIVATIONS = "activations"
    MEM_KV_CACHE = "kv_cache"
    MEM_PREFIX_CACHE = "prefix_cache"
    MEM_STAGING = "staging"
    MEM_OTHER = "other"
    MEMORY_CATEGORIES = (
        MEM_PARAMS, MEM_OPT_STATE, MEM_ACTIVATIONS, MEM_KV_CACHE,
        MEM_PREFIX_CACHE, MEM_STAGING, MEM_OTHER,
    )
    # the varying dimension a recompile storm is attributed to
    # (observability/compile_watch.py)
    STORM_DIM_BATCH = "batch"
    STORM_DIM_SEQ_LEN = "seq_len"
    STORM_DIM_FN = "fn"
    STORM_DIM_DTYPE = "dtype"
    STORM_DIM_UNKNOWN = "unknown"
    STORM_DIMS = (
        STORM_DIM_BATCH, STORM_DIM_SEQ_LEN, STORM_DIM_FN, STORM_DIM_DTYPE,
        STORM_DIM_UNKNOWN,
    )


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
    # worker: the default process group's backend (unset: nccl on a card,
    # gloo on the CPU); gloo lets ranks that share one card form a world,
    # which NCCL refuses
    DIST_BACKEND = "DLROVER_TPU_DIST_BACKEND"
    # serving: int8 KV cache in the batched engine (default off), radix
    # prefix-cache reuse on/off, its byte budget and match-block quantum,
    # and the speculative draft length k
    SERVE_QUANT = "DLROVER_TPU_SERVE_QUANT"
    SERVE_PREFIX = "DLROVER_TPU_SERVE_PREFIX"
    SERVE_PREFIX_BYTES = "DLROVER_TPU_SERVE_PREFIX_BYTES"
    SERVE_PREFIX_BLOCK = "DLROVER_TPU_SERVE_PREFIX_BLOCK"
    SERVE_SPEC_K = "DLROVER_TPU_SERVE_SPEC_K"
    # the serving autoscaler (serving/autoscaler.py): the TTFT p99 SLO (s)
    # and the router queue depth above which it grows the replica set,
    # and the grow/shrink cooldowns that bound oscillation
    SERVE_TTFT_SLO_S = "DLROVER_TPU_SERVE_TTFT_SLO_S"
    SERVE_QUEUE_HI = "DLROVER_TPU_SERVE_QUEUE_HI"
    SERVE_GROW_COOLDOWN_S = "DLROVER_TPU_SERVE_GROW_COOLDOWN_S"
    SERVE_SHRINK_COOLDOWN_S = "DLROVER_TPU_SERVE_SHRINK_COOLDOWN_S"
    # the serving SLO plane (observability/slo.py): the goodput floor, the
    # fast/slow burn-rate windows, the burn rate both windows must reach
    # before an alert is journaled, and the alert's re-fire cooldown
    SERVE_GOODPUT_SLO = "DLROVER_TPU_SERVE_GOODPUT_SLO"
    SERVE_SLO_BURN_FAST_S = "DLROVER_TPU_SERVE_SLO_BURN_FAST_S"
    SERVE_SLO_BURN_SLOW_S = "DLROVER_TPU_SERVE_SLO_BURN_SLOW_S"
    SERVE_SLO_BURN_RATE = "DLROVER_TPU_SERVE_SLO_BURN_RATE"
    SERVE_SLO_ALERT_COOLDOWN_S = "DLROVER_TPU_SERVE_SLO_ALERT_COOLDOWN_S"
    # the striped bulk-transfer fabric: stripe size, connections per
    # source, and a source's cap on concurrent stripe fetches
    FABRIC_STRIPE_BYTES = "DLROVER_TPU_FABRIC_STRIPE_BYTES"
    FABRIC_CONNS = "DLROVER_TPU_FABRIC_CONNS"
    FABRIC_ADMIT = "DLROVER_TPU_FABRIC_ADMIT"
    # the address other hosts dial to reach this one (agent rendezvous,
    # the replica and reshard services)
    HOST_IP = "DLROVER_TPU_HOST_IP"
    # the live-reshard rung (default on) and its transfer timeout (s)
    RESHARD = "DLROVER_TPU_RESHARD"
    RESHARD_TIMEOUT_S = "DLROVER_TPU_RESHARD_TIMEOUT_S"
    # warm spawn (agent/warm_spawn.py): how long the agent's first
    # rendezvous waits for its spares' imports, and what they import
    WARM_WAIT_S = "DLROVER_TPU_WARM_WAIT_S"
    WARM_PREIMPORT = "DLROVER_TPU_WARM_PREIMPORT"
    # set by a warm spare in its own environment at release: its spawn
    # time, its pre-imports' seconds and its release time
    WARM_SPARE = "DLROVER_TPU_WARM_SPARE"
    # the device timer and the profiler (observability/, tpu_timer/): the
    # agent sets TPU_TIMER_ENABLE, the hook library's path and LD_PRELOAD
    # in its workers' environment; a worker serves its metrics on
    # TPU_TIMER_PORT + local rank, the per-host daemon on
    # TPU_TIMER_DAEMON_PORT
    TPU_TIMER_ENABLE = "TPU_TIMER_ENABLE"
    TPU_TIMER_LIB = "TPU_TIMER_LIB"
    TPU_TIMER_PORT = "TPU_TIMER_PORT"
    TPU_TIMER_DAEMON_PATH = "TPU_TIMER_DAEMON_PATH"
    TPU_TIMER_DAEMON_PORT = "TPU_TIMER_DAEMON_PORT"
    TRACE_FUNCS = "DLROVER_TPU_TRACE_FUNCS"
    PROFILE_DIR = "DLROVER_TPU_PROFILE_DIR"
    # master-pushed launcher overrides: a JSON object of
    # ElasticLaunchConfig fields, read by the master's get_run_config
    RUN_CONFIG = "DLROVER_TPU_RUN_CONFIG"
    # the fault-injection plane (chaos/injector.py)
    FAULT_SCHEDULE = "DLROVER_FAULT_SCHEDULE"
    FAULT_SEED = "DLROVER_FAULT_SEED"
    # the master's HTTP transport and scrape routes (unset: off; 0: a free
    # port), and the agent's /metrics + /debug/bundle server
    HTTP_PORT = "DLROVER_TPU_HTTP_PORT"
    AGENT_METRICS_PORT = "DLROVER_TPU_AGENT_METRICS_PORT"
    # tracing and the flight recorder (observability/tracing.py,
    # observability/flight_recorder.py)
    TRACE = "DLROVER_TPU_TRACE"
    TRACE_RING = "DLROVER_TPU_TRACE_RING"
    TRACE_DIR = "DLROVER_TPU_TRACE_DIR"
    TRACE_BUNDLE_COOLDOWN_S = "DLROVER_TPU_TRACE_BUNDLE_COOLDOWN_S"
    # tail attribution (serving/tail.py): the slow percentile, the
    # completions before attribution starts, and the worst requests a
    # replica's bundle carries
    SERVE_TAIL_PCTL = "DLROVER_TPU_SERVE_TAIL_PCTL"
    SERVE_TAIL_MIN_WINDOW = "DLROVER_TPU_SERVE_TAIL_MIN_WINDOW"
    SERVE_TRACE_WORST = "DLROVER_TPU_SERVE_TRACE_WORST"
    # the skew monitor (master/skew_monitor.py): the straggler multiple of
    # the lower median, and the snapshots kept per rank
    SKEW_THRESHOLD = "DLROVER_TPU_SKEW_THRESHOLD"
    SKEW_WINDOW = "DLROVER_TPU_SKEW_WINDOW"
    # the memory accountant (observability/memory.py): a synthetic device
    # limit where the device gives none, and the pressure threshold as a
    # fraction of the limit; the compile watch's storm size
    HBM_LIMIT_BYTES = "DLROVER_TPU_HBM_LIMIT_BYTES"
    MEM_PRESSURE_FRAC = "DLROVER_TPU_MEM_PRESSURE_FRAC"
    COMPILE_STORM_N = "DLROVER_TPU_COMPILE_STORM_N"


class CheckpointConstant:
    """Flash Checkpoint layout, the reference's file names."""

    TRACKER_FILE = "latest_step.txt"
    DONE_DIR = "._done"
    MANIFEST_PREFIX = "manifest_"
    MANIFEST_SUFFIX = ".mf"
    DELTA_PREFIX = "delta_"
    FRAME_SUFFIX = ".dlrover"
    SAVE_TIMEOUT_S = 600


class SharedResourceName:
    """Names of agent-served IPC resources."""

    # key prefixes in the workers' training-metrics SharedDict: a worker
    # publishes its cumulative op-class histograms under
    # ``optel/<local_rank>`` and its memory ledger under ``mem/<local_rank>``
    OPTEL_KEY_PREFIX = "optel/"
    MEM_KEY_PREFIX = "mem/"

    SAVE_LOCK = "flash_ckpt_save_lock"
    SAVE_EVENT_QUEUE = "flash_ckpt_event_queue"
    SHM_META_DICT = "flash_ckpt_shm_meta"
