"""The worker's client of the master RPC.

The port's trim of ``dlrover_tpu/agent/master_client.py`` to the calls the
training loop makes: ``report_global_step`` and the KV store. Method names
and messages on the wire are the reference's, so the JAX package's master
serves them as it serves its own workers.
"""

import threading
import time
from typing import List, Optional

from dlrover_tpu_torch.common import comm
from dlrover_tpu_torch.common.constants import EnvKey, env_int, env_str
from dlrover_tpu_torch.common.rpc import RPCClient


class MasterClient:
    _instance: Optional["MasterClient"] = None
    _lock = threading.Lock()

    def __init__(self, master_addr: str, node_id: int = 0,
                 node_rank: Optional[int] = None):
        self._client = RPCClient(master_addr)
        self._node_id = node_id
        self._node_rank = node_id if node_rank is None else node_rank

    @property
    def master_addr(self) -> str:
        return self._client.addr

    @property
    def node_id(self) -> int:
        return self._node_id

    def report_global_step(self, step: int, timestamp: float = 0.0,
                           retries: Optional[int] = None,
                           rdzv_round: int = -1) -> None:
        self._client.call(
            "report_global_step",
            comm.GlobalStep(node_id=self._node_id, step=step,
                            timestamp=timestamp or time.time(),
                            rdzv_round=rdzv_round),
            retries=retries)

    def kv_set(self, key: str, value: bytes) -> None:
        self._client.call("kv", comm.KeyValueRequest(op="set", key=key,
                                                     value=value))

    def kv_get(self, key: str) -> Optional[bytes]:
        resp = self._client.call("kv", comm.KeyValueRequest(op="get",
                                                            key=key))
        return resp.value if resp.found else None

    def kv_wait(self, key: str, timeout_s: float = 60.0) -> Optional[bytes]:
        resp = self._client.call("kv", comm.KeyValueRequest(
            op="wait", key=key, timeout_s=timeout_s))
        return resp.value if resp.found else None

    def kv_multi_get(self, keys: List[str]) -> List[bytes]:
        resp = self._client.call("kv", comm.KeyValueRequest(op="multi_get",
                                                            keys=keys))
        return resp.values

    @classmethod
    def singleton(cls) -> "MasterClient":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls(env_str(EnvKey.MASTER_ADDR),
                                    env_int(EnvKey.NODE_ID, 0))
            return cls._instance
