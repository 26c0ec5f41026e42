"""Master-side rendezvous: which nodes form the next world.

The port's copy of ``RendezvousManager`` and
``ElasticTrainingRendezvousManager`` from
``dlrover_tpu/master/rdzv_manager.py``, the same semantics:

- agents join a named round; the master cuts a world when ``min_nodes``
  have joined and either ``max_nodes`` have or the last-call window has
  expired;
- the world is truncated to a multiple of ``node_unit``, keeping the
  lowest node ranks; the rest wait for the next round;
- a node known dead shrinks the world the cut waits for, so survivors of
  a fault re-form at once instead of waiting out the last call;
- the cut world carries the process-group bootstrap address: comm rank
  0's host and the free port it reported.

A join fires the ``rdzv.join`` chaos site and is an ``rdzv.join`` span,
and a cut an ``rdzv.world_cut`` span; the servicer activated the caller's
trace context, so both land inside the agent's rendezvous round. Not
ported: the network-check rendezvous, the straggler-history cut, the
reshard announcement, the journal and the metrics.
"""

import time
from threading import Lock
from typing import Dict, List, Tuple

from dlrover_tpu_torch.chaos import get_injector
from dlrover_tpu_torch.common.comm import NodeMeta
from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.common.constants import (
    ChaosSite,
    RendezvousName,
    SpanName,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.observability import tracing


class RendezvousParameters:
    def __init__(self, min_nodes: int, max_nodes: int,
                 waiting_timeout: float = 0.0, node_unit: int = 1):
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        self.waiting_timeout = (waiting_timeout
                                or get_context().rdzv_lastcall_s)
        self.node_unit = max(1, node_unit)


def stamp_comm_ranks(world: Dict[int, NodeMeta]) -> None:
    """Communication order of a cut world: slices contiguous (ordered by
    their lowest node rank), and within a slice by TPU worker id when
    known; node-rank order when no node names a slice."""
    if not any(m.slice_id for m in world.values()):
        order = sorted(world)
    else:
        slices: Dict[str, List[int]] = {}
        for rank in sorted(world):
            slices.setdefault(world[rank].slice_id, []).append(rank)
        order = []
        for ranks in sorted(slices.values(), key=min):
            order.extend(sorted(ranks, key=lambda r: (
                world[r].tpu_worker_id if world[r].tpu_worker_id >= 0
                else r, r)))
    for i, node_rank in enumerate(order):
        world[node_rank].comm_rank = i


class RendezvousManager:
    def __init__(self, name: str):
        self._name = name
        self._lock = Lock()
        self._rdzv_params = RendezvousParameters(1, 1)
        # nodes waiting for the next cut: {node_rank: NodeMeta}
        self._waiting_nodes: Dict[int, NodeMeta] = {}
        # the latest cut world: {node_rank: NodeMeta}
        self._rdzv_nodes: Dict[int, NodeMeta] = {}
        self._latest_rdzv_nodes: List[int] = []
        self._lastcall_time = 0.0
        self._rdzv_round = 0
        self._start_rdzv_ts = 0.0
        # node ranks known dead: the world the cut waits for shrinks by
        # them
        self._dead_ranks: set = set()

    @property
    def name(self) -> str:
        return self._name

    @property
    def rdzv_round(self) -> int:
        return self._rdzv_round

    def update_rdzv_params(self, min_nodes: int, max_nodes: int,
                           waiting_timeout: float = 0.0,
                           node_unit: int = 1) -> None:
        self._rdzv_params = RendezvousParameters(
            min_nodes, max_nodes, waiting_timeout, node_unit)

    def remove_alive_node(self, node_rank: int) -> None:
        """A node died: drop it from the waiting set so the next cut is
        not held open by a ghost."""
        with self._lock:
            self._dead_ranks.add(node_rank)
            if node_rank in self._waiting_nodes:
                del self._waiting_nodes[node_rank]
                logger.info("%s rdzv: removed dead node rank %s from the "
                            "waiting set", self._name, node_rank)

    def join_rendezvous(self, meta: NodeMeta) -> int:
        """Register a node for the next world cut; returns the round."""
        inj = get_injector()
        if inj is not None:
            inj.fire(ChaosSite.RDZV_JOIN, rdzv=self._name,
                     node_rank=meta.node_rank)
        with tracing.span(SpanName.RDZV_JOIN, source="master",
                          rdzv_name=self._name,
                          node_rank=meta.node_rank), self._lock:
            if not self._waiting_nodes:
                self._start_rdzv_ts = time.monotonic()
            # a dead node re-joining is alive again
            self._dead_ranks.discard(meta.node_rank)
            self._waiting_nodes[meta.node_rank] = meta
            # a (re)join voids the previous world: pollers block until the
            # new round cuts, and training agents see num_nodes_waiting
            self._rdzv_nodes = {}
            self._lastcall_time = time.monotonic()
        return self._rdzv_round

    def num_nodes_waiting(self) -> int:
        with self._lock:
            return len(self._waiting_nodes)

    def _check_rdzv_completed(self) -> bool:
        """Cut the world if possible. Caller holds ``self._lock``."""
        params = self._rdzv_params
        waiting = len(self._waiting_nodes)
        dead_in_world = len({r for r in self._dead_ranks
                             if r < params.max_nodes})
        effective_max = max(params.min_nodes,
                            params.max_nodes - dead_in_world)
        completed = waiting >= effective_max or (
            waiting >= params.min_nodes and self._lastcall_time > 0
            and time.monotonic() - self._lastcall_time
            >= params.waiting_timeout)
        if not completed:
            if (self._start_rdzv_ts > 0 and waiting > 0
                    and time.monotonic() - self._start_rdzv_ts
                    > get_context().rdzv_timeout_s):
                logger.warning("%s rdzv round %s timed out with %s/%s "
                               "nodes", self._name, self._rdzv_round,
                               waiting, params.min_nodes)
            return False
        unit = params.node_unit
        world_size = (min(waiting, params.max_nodes) // unit) * unit
        if world_size < max(params.min_nodes, unit):
            return False
        # the cut runs on whichever poll tipped the round: its trace
        # context ties the world commit to that agent's arc
        with tracing.span(SpanName.RDZV_WORLD_CUT, source="master",
                          rdzv_name=self._name,
                          round=self._rdzv_round + 1):
            ranks = sorted(self._waiting_nodes)[:world_size]
            self._rdzv_nodes = {r: self._waiting_nodes[r] for r in ranks}
            stamp_comm_ranks(self._rdzv_nodes)
            self._latest_rdzv_nodes = ranks
            for r in ranks:
                del self._waiting_nodes[r]
        self._rdzv_round += 1
        self._lastcall_time = 0.0
        self._start_rdzv_ts = 0.0
        logger.info("%s rdzv round %s completed: world=%s (waiting "
                    "leftover=%s)", self._name, self._rdzv_round, ranks,
                    sorted(self._waiting_nodes))
        return True

    def get_comm_world(self, node_rank: int
                       ) -> Tuple[int, int, Dict[int, NodeMeta]]:
        """(round, group, world); an empty world means not ready yet."""
        raise NotImplementedError

    def coordinator_addr(self) -> str:
        """The bootstrap address: the comm-rank-0 node of the cut world."""
        if not self._rdzv_nodes:
            return ""
        rank0 = min(self._rdzv_nodes, key=lambda r: (
            self._rdzv_nodes[r].comm_rank
            if self._rdzv_nodes[r].comm_rank >= 0 else r))
        meta = self._rdzv_nodes[rank0]
        return f"{meta.host or '127.0.0.1'}:{meta.free_port}"


class ElasticTrainingRendezvousManager(RendezvousManager):
    """The training rendezvous."""

    def __init__(self) -> None:
        super().__init__(RendezvousName.TRAINING)

    def get_comm_world(self, node_rank: int
                       ) -> Tuple[int, int, Dict[int, NodeMeta]]:
        with self._lock:
            if node_rank not in self._rdzv_nodes:
                self._check_rdzv_completed()
            if node_rank in self._rdzv_nodes:
                return self._rdzv_round, 0, dict(self._rdzv_nodes)
            return self._rdzv_round, 0, {}
