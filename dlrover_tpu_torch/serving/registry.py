"""Master-side table of the live decode replicas.

The port's copy of ``dlrover_tpu/serving/registry.py``: which replicas
are registered, at which addresses, with how many slots, with ``epoch``
bumped on every change so a cached router view validates cheaply.
Liveness is not decided here: replicas heartbeat on the job manager's
plane, and the master's node-event callback turns a SERVE node's death
into :meth:`on_node_lost`.

Journal semantics (goodput attribution): ``serve_replica_up`` opens the
``serving`` phase, ``serve_replica_lost`` opens ``detect`` until the
autoscaler's replacement registers, and a planned
``serve_replica_drained`` is informational. Not ported: the draining
marks (nothing in either package sets them).
"""

import threading
from typing import Dict, List

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.observability.journal import JournalEvent


class ServeReplicaRegistry:
    def __init__(self, event_journal=None, registry=None):
        self._journal = event_journal
        self._lock = threading.Lock()
        # node_id -> {"addr", "slots"}
        self._replicas: Dict[int, Dict] = {}
        self.epoch = 0
        if registry is not None:
            registry.gauge(
                "dlrover_serving_replicas",
                "live (non-draining) decode replicas",
            ).set_function(lambda: float(len(self.live())))

    def _record(self, kind: str, **data) -> None:
        if self._journal is not None:
            self._journal.record(kind, **data)

    def register(self, node_id: int, addr: str, slots: int) -> int:
        with self._lock:
            self._replicas[node_id] = {"addr": addr, "slots": slots}
            self.epoch += 1
            epoch = self.epoch
        logger.info("serve replica %s up at %s (%s slots, epoch %s)",
                    node_id, addr, slots, epoch)
        self._record(JournalEvent.SERVE_REPLICA_UP, node_id=node_id,
                     addr=addr, slots=slots, epoch=epoch)
        return epoch

    def deregister(self, node_id: int, reason: str = "drain") -> None:
        """A planned leave (the replica drained)."""
        with self._lock:
            if self._replicas.pop(node_id, None) is None:
                return
            self.epoch += 1
            epoch = self.epoch
        self._record(JournalEvent.SERVE_REPLICA_DRAINED, node_id=node_id,
                     reason=reason, epoch=epoch)

    def on_node_lost(self, node_id: int) -> bool:
        """A SERVE node died undrained (connection drop, heartbeat
        timeout, SIGKILL). True when it was still registered."""
        with self._lock:
            if self._replicas.pop(node_id, None) is None:
                return False
            self.epoch += 1
            epoch = self.epoch
        logger.warning("serve replica %s LOST (epoch %s)", node_id, epoch)
        self._record(JournalEvent.SERVE_REPLICA_LOST, node_id=node_id,
                     epoch=epoch)
        return True

    def live(self) -> List[Dict]:
        """The routable replicas as ``{node_id, addr, slots}``."""
        with self._lock:
            return [{"node_id": nid, "addr": r["addr"], "slots": r["slots"]}
                    for nid, r in self._replicas.items()]

    def count(self) -> int:
        with self._lock:
            return len(self._replicas)
