"""The RPC messages the port's agent, worker, master and serving plane
exchange.

The port's copy of the part of ``dlrover_tpu/common/comm.py`` the agent
(rendezvous, node status, failures, heartbeats with their action, events),
the worker (KV, barrier, steps, data shards), the serving replica, its
router and master, the bulk-transfer fabric, the checkpoint replicas and
the live-reshard plane use: the same dataclass names and fields, encoded
as the reference encodes them — one msgpack map ``{"_t": <type name>, "f": {field:
value}}`` per message, nested messages recursively, plain values as they
are — so the JAX package's master, router, replica and fabric read and
answer them unchanged. A reply of a type not listed here decodes to a
plain dict.
"""

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Type

from dlrover_tpu_torch.common import msgpack

_REGISTRY: Dict[str, Type] = {}


def message(cls):
    cls = dataclass(cls)
    _REGISTRY[cls.__name__] = cls
    return cls


def _encode(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and type(obj).__name__ in _REGISTRY:
        return {"_t": type(obj).__name__,
                "f": {f.name: _encode(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)}}
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode(v) for v in obj]
    return obj


def _decode(obj: Any) -> Any:
    if isinstance(obj, dict):
        if obj.get("_t") in _REGISTRY:
            cls = _REGISTRY[obj["_t"]]
            known = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: _decode(v) for k, v in obj.get("f", {}).items()
                          if k in known})
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj


def serialize(obj: Any) -> bytearray:
    return msgpack.pack_buffer(_encode(obj))


def serialize_parts(obj: Any) -> list:
    """:func:`serialize`'s bytes as buffers, a large bin (a frame chunk, a
    stripe) as the object's own memory (``msgpack.pack_parts``)."""
    return msgpack.pack_parts(_encode(obj))


def deserialize(data: bytes, copy_bin: bool = True) -> Any:
    """The message in ``data``; with ``copy_bin=False`` each bin is a
    view of ``data``."""
    if not data:
        return None
    return _decode(msgpack.unpackb(data, copy_bin=copy_bin))


@message
class BaseRequest:
    node_id: int = -1
    node_type: str = ""
    data: Any = None


@message
class BaseResponse:
    success: bool = True
    message: str = ""
    data: Any = None


# -- rendezvous ----------------------------------------------------------------


@message
class NodeMeta:
    """What an agent reports about its host when joining."""

    node_id: int = -1
    node_rank: int = -1
    host: str = ""
    local_world_size: int = 1
    num_devices: int = 0
    free_port: int = 0
    slice_id: str = ""
    tpu_worker_id: int = -1
    # communication rank stamped at the world cut (-1 = unassigned)
    comm_rank: int = -1


@message
class JoinRendezvousRequest:
    node_id: int = 0
    node_rank: int = 0
    local_world_size: int = 1
    rdzv_name: str = ""
    node_unit: int = 1
    host: str = ""
    free_port: int = 0
    slice_id: str = ""
    tpu_worker_id: int = -1


@message
class JoinRendezvousResponse:
    round: int = 0


@message
class CommWorldRequest:
    node_id: int = 0
    rdzv_name: str = ""


@message
class CommWorldResponse:
    rdzv_name: str = ""
    round: int = 0
    group: int = 0
    # {node_rank: NodeMeta} of the cut world
    world: Dict[int, Any] = field(default_factory=dict)
    # the process-group bootstrap address: rank 0's host and free port
    coordinator_addr: str = ""


@message
class WaitingNodeNumRequest:
    node_id: int = 0
    rdzv_name: str = ""


@message
class WaitingNodeNumResponse:
    waiting_num: int = 0


# -- KV store and barrier ------------------------------------------------------


@message
class KeyValueRequest:
    op: str = "get"  # get | set | add | wait | delete | multi_get | multi_set
    key: str = ""
    value: bytes = b""
    keys: List[str] = field(default_factory=list)
    values: List[bytes] = field(default_factory=list)
    timeout_s: float = 0.0


@message
class KeyValueResponse:
    found: bool = False
    value: bytes = b""
    values: List[bytes] = field(default_factory=list)


@message
class BarrierRequest:
    barrier_name: str = ""
    node_rank: int = 0
    world_size: int = 0
    timeout_s: float = 300.0


@message
class BarrierResponse:
    passed: bool = False


# -- node lifecycle, failures, events ------------------------------------------


@message
class NodeStatusRequest:
    node_id: int = 0
    node_type: str = ""
    status: str = ""
    exit_reason: str = ""
    restart_count: int = 0


@message
class NodeFailureReport:
    node_id: int = 0
    error_data: str = ""
    level: str = ""
    restart_count: int = 0


@message
class EventReport:
    """Agent or worker → master journal event; the master stamps the
    arrival time."""

    node_id: int = 0
    kind: str = ""
    data: Dict[str, Any] = field(default_factory=dict)


@message
class ResourceStats:
    node_id: int = 0
    cpu_percent: float = 0.0
    mem_used_mb: float = 0.0
    device_util: Dict[int, float] = field(default_factory=dict)
    device_mem_mb: Dict[int, float] = field(default_factory=dict)
    device_mem_total_mb: Dict[int, float] = field(default_factory=dict)


@message
class PreCheckRequest:
    node_id: int = 0


@message
class PreCheckResponse:
    status: str = "pass"  # pass | fail | checking
    reason: str = ""


# -- data shards ---------------------------------------------------------------


@message
class DatasetShardParams:
    batch_size: int = 0
    num_epochs: int = 1
    dataset_size: int = 0
    shuffle: bool = False
    num_minibatches_per_shard: int = 2
    dataset_name: str = ""
    storage_type: str = ""
    splitter: str = "batch"  # batch | text | streaming


@message
class Shard:
    name: str = ""
    start: int = 0
    end: int = 0
    record_indices: List[int] = field(default_factory=list)


@message
class TaskRequest:
    dataset_name: str = ""
    node_id: int = 0


@message
class TaskMessage:
    task_id: int = -1
    task_type: str = ""
    shard: Optional[Any] = None  # Shard
    dataset_name: str = ""


@message
class TaskResult:
    dataset_name: str = ""
    task_id: int = -1
    node_id: int = 0
    success: bool = True


@message
class ShardCheckpointRequest:
    dataset_name: str = ""


@message
class ShardCheckpointResponse:
    content: str = ""


# -- progress and heartbeats ---------------------------------------------------


@message
class GlobalStep:
    node_id: int = 0
    step: int = 0
    timestamp: float = 0.0
    rdzv_round: int = -1


@message
class HeartbeatRequest:
    node_id: int = 0
    timestamp: float = 0.0
    global_step: int = 0
    step_timestamp: float = 0.0
    rdzv_round: int = -1
    gauges: Dict[str, float] = field(default_factory=dict)
    op_telemetry: Dict[str, Any] = field(default_factory=dict)
    shard_acks: List[Any] = field(default_factory=list)
    memory: Dict[str, Any] = field(default_factory=dict)


@message
class HeartbeatResponse:
    action_type: str = "no_action"
    action_data: Dict[str, Any] = field(default_factory=dict)
    backpressure: int = 0
    backoff_hint_s: float = 0.0
    fanin_role: str = ""
    fanin_parent: str = ""
    fanin_epoch: int = -1


# -- the decode-serving plane ------------------------------------------------


@message
class ServeRegisterRequest:
    """Replica → master: its decode RPC address and slot count."""

    node_id: int = -1
    addr: str = ""
    slots: int = 0


@message
class ServeDeregisterRequest:
    node_id: int = -1
    reason: str = "drain"


@message
class ServeReplicaInfo:
    node_id: int = -1
    addr: str = ""
    slots: int = 0


@message
class ServeReplicasResponse:
    """The live membership; ``epoch`` bumps on every change."""

    replicas: List[Any] = field(default_factory=list)  # [ServeReplicaInfo]
    epoch: int = 0


@message
class ServeGenerateRequest:
    """One greedy request; ``request_id`` keys an idempotent retry on
    another replica."""

    request_id: str = ""
    prompt: List[int] = field(default_factory=list)
    max_new_tokens: int = 16
    rerouted: bool = False


@message
class ServeGenerateResponse:
    request_id: str = ""
    success: bool = True
    message: str = ""
    tokens: List[int] = field(default_factory=list)
    ttft_s: float = 0.0
    tpot_s: float = 0.0
    queue_depth: int = 0
    replica_id: int = -1
    trace_id: str = ""


@message
class ServeDrainRequest:
    """Stop admitting, finish every in-flight sequence, deregister."""

    reason: str = ""


# -- checkpoint replicas (ckpt/replica.py) ------------------------------------


@message
class BoolResponse:
    value: bool = False
    reason: str = ""


@message
class ReplicaPutRequest:
    """One frame, or one chunk of it, pushed to a backup store; the store
    takes the frame once every chunk has arrived."""

    owner_rank: int = 0  # the node rank whose worker sealed the frame
    local_rank: int = 0
    step: int = -1
    blob: bytes = b""
    chunk_index: int = 0
    chunk_count: int = 1


@message
class ReplicaListResponse:
    """The ``[owner_rank, local_rank, step]`` entries a store holds."""

    entries: List[List[int]] = field(default_factory=list)


@message
class ReplicaLocalRequest:
    """The port's same-host store calls (``ckpt/replica.py``): a put that
    the store copies from the worker's segment ``shm_name`` itself and
    forwards to the ``peers`` node ranks, and a write of a stored frame
    back into ``shm_name``. A store takes only its own job's and node's
    segments; a JAX store answers neither method."""

    owner_rank: int = 0
    local_rank: int = 0
    step: int = -1
    shm_name: str = ""
    peers: List[int] = field(default_factory=list)


# -- the live-reshard plane (ckpt/reshard.py) ---------------------------------


@message
class ReshardMetaRequest:
    node_rank: int = -1  # the asking node, for the survivor's logs


@message
class ReshardMetaResponse:
    """The sealed frames a survivor serves, one ``[local_rank, step,
    msgpack(meta)]`` each (the meta without the tensor bytes)."""

    found: bool = False
    node_rank: int = -1
    frames: List[List] = field(default_factory=list)


# -- the bulk-transfer fabric (common/fabric.py) -----------------------------


@message
class FabricDescribeRequest:
    """Can the peer serve ``key``? ``step >= 0`` pins the step."""

    key: str = ""
    step: int = -1


@message
class FabricDescribeResponse:
    found: bool = False
    step: int = -1
    total_bytes: int = 0
    content_crc: int = 0  # crc32 of the whole object


@message
class FabricFetchRequest:
    key: str = ""
    step: int = -1
    offset: int = 0
    nbytes: int = 0


@message
class FabricStripeResponse:
    found: bool = False
    # the source is at its concurrent-fetch cap: back off and re-queue
    busy: bool = False
    step: int = -1
    data: bytes = b""
    crc: int = 0  # crc32 of data
