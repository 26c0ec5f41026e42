"""Mesh axis planning: the port's copy of the pure-Python part of
``dlrover_tpu/parallel/mesh.py`` (:32-115).

``AXIS_ORDER``, ``MODEL_AXES``, :class:`MeshPlan` and :func:`plan_mesh`
are the same as the reference's, so a plan made by either package means
the same decomposition. ``dp × fsdp`` absorbs world-size changes while
``tp``/``pp``/``ep`` stay fixed by the model; the elastic trainer rescales
grad-accum from :attr:`MeshPlan.dp_total`.

:func:`build_mesh` turns a plan into a ``torch.distributed`` DeviceMesh
over the same axis names in the same order (one rank per card, rank ``r``
at the row-major position ``r``, as the reference lays device ids out);
:class:`ElasticMeshManager` re-plans it when the world changes.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.log import logger

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


def build_mesh(plan: MeshPlan, device_type: str = "cuda"):
    """A DeviceMesh over :data:`AXIS_ORDER` with the plan's sizes. Needs the
    default process group, with exactly ``plan.n_devices`` ranks."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    if world != plan.n_devices:
        raise ValueError(
            f"plan needs {plan.n_devices} ranks, the world has {world}")
    shape = tuple(plan.size(a) for a in AXIS_ORDER)
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=AXIS_ORDER)


class ElasticMeshManager:
    """Re-plans the mesh when the world size changes (the counterpart of
    elastic DDP world re-formation)."""

    def __init__(self, tp: int = 1, pp: int = 1, ep: int = 1, sp: int = 1,
                 dcn: int = 1):
        self._tp, self._pp, self._ep, self._sp = tp, pp, ep, sp
        self._dcn = dcn
        self._plan: Optional[MeshPlan] = None

    @property
    def plan(self) -> Optional[MeshPlan]:
        return self._plan

    @property
    def min_unit(self) -> int:
        """Smallest usable device count: worlds must keep dp×fsdp ≥ 1
        with the model axes intact."""
        return self._tp * self._pp * self._ep * self._sp

    def usable_devices(self, n_devices: int) -> int:
        return (n_devices // self.min_unit) * self.min_unit

    def replan(self, n_devices: int) -> MeshPlan:
        usable = self.usable_devices(n_devices)
        if usable == 0:
            raise ValueError(
                f"{n_devices} devices cannot host tp={self._tp} pp={self._pp} "
                f"ep={self._ep} sp={self._sp} (needs ≥ {self.min_unit})"
            )
        if usable != n_devices:
            logger.warning(
                "using %s of %s devices (world must be a multiple of %s)",
                usable, n_devices, self.min_unit,
            )
        dcn = self._dcn
        while dcn > 1 and usable % (dcn * self.min_unit) != 0:
            dcn -= 1
        self._plan = plan_mesh(
            usable, tp=self._tp, pp=self._pp, ep=self._ep, sp=self._sp,
            dcn=dcn,
        )
        logger.info("mesh plan for %s devices: %s", usable, self._plan.axes)
        return self._plan

    def apply_plan(self, plan: MeshPlan) -> None:
        """Adopt an externally re-planned decomposition: its model axes
        become the new fixed axes."""
        self._tp = plan.size("tp")
        self._pp = plan.size("pp")
        self._ep = plan.size("ep")
        self._sp = plan.size("sp")
        self._dcn = plan.size("dcn")
        self._plan = plan
        logger.info("mesh plan adopted: %s", plan.axes)

    def build(self, device_type: str = "cuda"):
        if self._plan is None:
            import torch.distributed as dist

            self.replan(dist.get_world_size())
        return build_mesh(self._plan, device_type)
