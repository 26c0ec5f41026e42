"""Mesh decompositions: the ``(data, fsdp, tp)`` shape a world runs.

The port's copy of ``Decomposition`` from ``dlrover_tpu/parallel/
replan.py``, with its wire form: a world cut's record (``ckpt/reshard.py``)
carries the old and the new decomposition as ``[data, fsdp, tp]``. The
re-decomposition planner and its cost model are not ported, so a cut
keeps its decomposition, as the reference does with no planner wired.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

# data outermost (replicas), tp innermost
REPLAN_AXES = ("data", "fsdp", "tp")


@dataclass(frozen=True, slots=True)
class Decomposition:
    """One ``(data, fsdp, tp)`` factorisation of the world size: ``data``
    replicates the params over batch shards, ``fsdp`` shards them over
    batch shards, ``tp`` shards the math within one batch shard."""

    data: int = 1
    fsdp: int = 1
    tp: int = 1

    def __post_init__(self):
        for axis in REPLAN_AXES:
            if getattr(self, axis) < 1:
                raise ValueError(f"decomposition axis {axis} must be ≥ 1")

    @property
    def world(self) -> int:
        return self.data * self.fsdp * self.tp

    @property
    def dp_total(self) -> int:
        """The ranks the gradient is averaged over (data × fsdp)."""
        return self.data * self.fsdp

    def sig(self) -> str:
        return f"d{self.data}f{self.fsdp}t{self.tp}"

    def axis_sizes(self) -> Dict[str, int]:
        return {"data": self.data, "fsdp": self.fsdp, "tp": self.tp}

    def coords(self, rank: int) -> Dict[str, int]:
        """A rank's axis coordinates, row-major over (data, fsdp, tp)."""
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside world {self.world}")
        return {"data": rank // (self.fsdp * self.tp),
                "fsdp": (rank // self.tp) % self.fsdp,
                "tp": rank % self.tp}

    def to_wire(self) -> List[int]:
        return [self.data, self.fsdp, self.tp]

    @classmethod
    def from_wire(cls, raw: Optional[Sequence[int]]) -> "Decomposition":
        if not raw:
            return cls()
        vals = [int(v) for v in raw] + [1, 1, 1]
        return cls(data=vals[0], fsdp=vals[1], tp=vals[2])

    @classmethod
    def from_config(cls, config) -> Optional["Decomposition"]:
        """A ``ParallelConfig``'s planned mesh, or None when its mesh
        fields were never planned (all zero)."""
        data = int(getattr(config, "mesh_data", 0) or 0)
        fsdp = int(getattr(config, "mesh_fsdp", 0) or 0)
        tp = int(getattr(config, "mesh_tp", 0) or 0)
        if data <= 0 and fsdp <= 0 and tp <= 0:
            return None
        return cls(data=max(1, data), fsdp=max(1, fsdp), tp=max(1, tp))
