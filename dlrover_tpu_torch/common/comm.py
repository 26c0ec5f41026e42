"""The master RPC messages the worker sends and reads.

The port's copy of the part of ``dlrover_tpu/common/comm.py`` the worker
uses: the same dataclass names and fields, encoded as the reference
encodes them — one msgpack map ``{"_t": <type name>, "f": {field:
value}}`` per message, nested messages recursively, plain values as they
are — so the JAX package's master reads and answers them unchanged. A
reply of a type not listed here decodes to a plain dict.
"""

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Type

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


def serialize(obj: Any) -> bytes:
    return msgpack.packb(_encode(obj))


def deserialize(data: bytes) -> Any:
    if not data:
        return None
    return _decode(msgpack.unpackb(data))


@message
class BaseResponse:
    success: bool = True
    message: str = ""
    data: Any = None


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
class GlobalStep:
    node_id: int = 0
    step: int = 0
    timestamp: float = 0.0
    rdzv_round: int = -1
