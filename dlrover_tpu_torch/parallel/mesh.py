"""Mesh axis planning: the port's copy of the pure-Python part of
``dlrover_tpu/parallel/mesh.py`` (:32-115).

``AXIS_ORDER``, ``MODEL_AXES``, :class:`MeshPlan` and :func:`plan_mesh`
are the same as the reference's, so a plan made by either package means
the same decomposition. ``dp × fsdp`` absorbs world-size changes while
``tp``/``pp``/``ep`` stay fixed by the model; the elastic trainer rescales
grad-accum from :attr:`MeshPlan.dp_total`. The device mesh itself (a
DeviceMesh with DTensor placements) is not ported yet.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional

# axis order: outermost (cheapest link, least traffic) → innermost
AXIS_ORDER = ("dcn", "pp", "dp", "fsdp", "ep", "sp", "tp")

# axes whose size is fixed by the model, not the cluster
MODEL_AXES = ("pp", "tp", "ep")


@dataclass(frozen=True)
class MeshPlan:
    """A concrete axis assignment for a device count."""

    axes: Dict[str, int] = field(default_factory=dict)

    @property
    def n_devices(self) -> int:
        n = 1
        for v in self.axes.values():
            n *= v
        return n

    def size(self, axis: str) -> int:
        return self.axes.get(axis, 1)

    @property
    def dp_total(self) -> int:
        """Number of data-parallel replicas of the batch axis
        (dcn × dp × fsdp: all shard the batch; fsdp additionally shards
        params within a slice)."""
        return self.size("dcn") * self.size("dp") * self.size("fsdp")

    def nontrivial_axes(self) -> List[str]:
        return [a for a in AXIS_ORDER if self.size(a) > 1]


def plan_mesh(
    n_devices: int,
    tp: int = 1,
    pp: int = 1,
    ep: int = 1,
    sp: int = 1,
    fsdp: Optional[int] = None,
    dp: Optional[int] = None,
    dcn: int = 1,
) -> MeshPlan:
    """Fill in dp/fsdp so the axis product covers ``n_devices``.

    Unspecified ``fsdp`` absorbs the remainder; set ``fsdp=1, dp=None`` for
    pure replication. ``dcn`` = number of slices: only the dcn gradient
    all-reduce crosses between them.
    """
    if n_devices % dcn != 0:
        raise ValueError(
            f"n_devices={n_devices} not divisible by dcn={dcn} slices"
        )
    per_slice = n_devices // dcn
    fixed = tp * pp * ep * sp
    if per_slice % fixed != 0:
        raise ValueError(
            f"per-slice devices {per_slice} not divisible by "
            f"tp*pp*ep*sp={fixed}"
        )
    remainder = per_slice // fixed
    if fsdp is None and dp is None:
        fsdp, dp = remainder, 1
    elif fsdp is None:
        if remainder % dp != 0:
            raise ValueError(f"remainder {remainder} not divisible by dp={dp}")
        fsdp = remainder // dp
    elif dp is None:
        if remainder % fsdp != 0:
            raise ValueError(
                f"remainder {remainder} not divisible by fsdp={fsdp}"
            )
        dp = remainder // fsdp
    if dp * fsdp != remainder:
        raise ValueError(
            f"dp*fsdp={dp * fsdp} != remainder {remainder} "
            f"(n_devices={n_devices}, fixed={fixed})"
        )
    return MeshPlan(axes={
        "dcn": dcn, "pp": pp, "dp": dp, "fsdp": fsdp, "ep": ep, "sp": sp,
        "tp": tp,
    })
