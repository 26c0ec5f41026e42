"""Resource plans and the optimizers that make them.

The port's copy of ``dlrover_tpu/master/resource.py``: a plan speaks in
hosts of the job (a worker count bounded to ``node_unit`` multiples),
and :class:`LocalOptimizer` is the in-master heuristic. Its decisions
are the reference's for the same :class:`ScalingStats`. Not ported: the
``BrainOptimizer`` (the brain service is not ported), and a plan's node
resource and parallel config, which only the brain and the strategy
generator make.
"""

import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class ResourcePlan:
    node_num: Optional[int] = None
    reason: str = ""

    def empty(self) -> bool:
        return self.node_num is None


@dataclass
class ScalingStats:
    """What an optimizer sees, collected master-side each tick."""

    running_nodes: int = 0
    pending_nodes: int = 0
    target_nodes: int = 0
    min_nodes: int = 1
    max_nodes: int = 1
    node_unit: int = 1
    running_speed: float = 0.0          # steps/s (perf monitor)
    straggler_nodes: List[int] = field(default_factory=list)
    oldest_pending_s: float = 0.0


class ResourceOptimizer(ABC):
    @abstractmethod
    def plan(self, stats: ScalingStats) -> ResourcePlan: ...


def round_to_unit(n: int, unit: int) -> int:
    return max(0, (n // max(1, unit)) * max(1, unit))


class LocalOptimizer(ResourceOptimizer):
    """The in-master heuristic, in priority order:

    - **unschedulable shrink**: a node pending longer than
      ``pending_timeout_s`` means the cluster cannot deliver the asked
      size; shrink the world to what runs (a ``node_unit`` multiple, never
      below min) instead of stalling the rendezvous;
    - **straggler shrink**: drop diagnosed stragglers when the rest still
      makes min;
    - **recovery grow**: running below max with nothing pending, probe
      back toward max (preempted capacity tends to return), at most once
      a ``grow_cooldown_s``.
    """

    def __init__(self, pending_timeout_s: float = 900.0,
                 grow_cooldown_s: float = 600.0):
        self.pending_timeout_s = pending_timeout_s
        self.grow_cooldown_s = grow_cooldown_s
        self._last_grow = 0.0

    def plan(self, stats: ScalingStats) -> ResourcePlan:
        unit = stats.node_unit
        if (stats.pending_nodes > 0
                and stats.oldest_pending_s > self.pending_timeout_s):
            target = round_to_unit(stats.running_nodes, unit)
            if stats.min_nodes <= target < stats.target_nodes:
                return ResourcePlan(
                    node_num=target,
                    reason=(f"{stats.pending_nodes} node(s) unschedulable "
                            f"for {stats.oldest_pending_s:.0f}s — shrink to "
                            f"{target}"))
        if stats.straggler_nodes:
            target = round_to_unit(
                stats.running_nodes - len(stats.straggler_nodes), unit)
            if target >= stats.min_nodes:
                return ResourcePlan(
                    node_num=target,
                    reason=(f"excluding stragglers {stats.straggler_nodes} — "
                            f"shrink to {target}"))
        now = time.monotonic()  # grow-cooldown arithmetic
        if (stats.pending_nodes == 0
                and stats.target_nodes < stats.max_nodes
                and now - self._last_grow > self.grow_cooldown_s):
            target = min(stats.max_nodes,
                         round_to_unit(stats.target_nodes + unit, unit))
            if target > stats.target_nodes:
                self._last_grow = now
                return ResourcePlan(node_num=target,
                                    reason=f"probing recovery grow to {target}")
        return ResourcePlan()
