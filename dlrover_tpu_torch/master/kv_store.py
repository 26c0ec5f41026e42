"""The master's KV store and named barriers.

The port's copy of ``dlrover_tpu/master/kv_store.py`` (``KVStoreService``
and ``SyncService``), as one shard: the reference splits the store into
hash shards for the fan-in plane's swarm scale, which the port does not
run, and without the clear and reset that master fail-over uses (not
ported). ``wait`` and ``join`` deadlines are on ``time.monotonic()`` and
re-derived on every wakeup. ``wait`` fires the ``kv.wait`` chaos site.
"""

import threading
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.chaos import get_injector
from dlrover_tpu_torch.common.constants import ChaosSite


class KVStoreService:
    def __init__(self) -> None:
        self._store: Dict[str, bytes] = {}
        self._cond = threading.Condition()

    def set(self, key: str, value: bytes) -> None:
        with self._cond:
            self._store[key] = value
            self._cond.notify_all()

    def get(self, key: str) -> Optional[bytes]:
        with self._cond:
            return self._store.get(key)

    def add(self, key: str, delta: int) -> int:
        """Atomic counter add (torch Store ``add`` semantics)."""
        with self._cond:
            cur = int(self._store.get(key, b"0")) + delta
            self._store[key] = str(cur).encode()
            self._cond.notify_all()
            return cur

    def wait(self, key: str, timeout_s: float) -> Optional[bytes]:
        inj = get_injector()
        if inj is not None:
            inj.fire(ChaosSite.KV_WAIT, key=key)
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while key not in self._store:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cond.wait(remaining)
            return self._store[key]

    def delete(self, key: str) -> None:
        with self._cond:
            self._store.pop(key, None)

    def delete_prefix(self, prefix: str) -> int:
        with self._cond:
            doomed = [k for k in self._store if k.startswith(prefix)]
            for k in doomed:
                del self._store[k]
            return len(doomed)

    def multi_get(self, keys: List[str]) -> List[bytes]:
        return [self.get(k) or b"" for k in keys]

    def multi_set(self, keys: List[str], values: List[bytes]) -> None:
        for k, v in zip(keys, values):
            self.set(k, v)


class SyncService:
    """Named barriers across nodes."""

    def __init__(self) -> None:
        self._barriers: Dict[str, set] = {}
        self._cond = threading.Condition()

    def join(self, name: str, node_rank: int, world_size: int,
             timeout_s: float = 300.0) -> bool:
        deadline = time.monotonic() + timeout_s
        with self._cond:
            self._barriers.setdefault(name, set()).add(node_rank)
            self._cond.notify_all()
            while len(self._barriers.get(name, ())) < world_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True
