"""Logical-axis sharding rules → DTensor placements.

The port's counterpart of ``dlrover_tpu/parallel/sharding.py``: model code
names each param dimension with a logical axis, one rules table maps those
to mesh axes, and :func:`shard_tree` turns a tree of full tensors into
DTensors on a :func:`~dlrover_tpu_torch.parallel.mesh.build_mesh` mesh.
The rules, the divisibility clamp and the block arithmetic are the
reference's, so a rank here holds exactly the region the reference's
device at the same mesh coordinate holds (:func:`region_for`; the
checkpoint engine saves and restores those regions).

A spec is a tuple with one entry per tensor dimension: None (replicated),
a mesh axis name, or a tuple of axis names (row-major combined, in mesh
order).
"""

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from dlrover_tpu_torch.parallel.mesh import AXIS_ORDER

# logical axis name → mesh axis (or None = replicate), the reference's
# table: "batch" spreads over every data axis, "embed" (the hidden dim of
# params) over fsdp, heads/mlp/vocab over tp, "layers" over pp
DEFAULT_RULES: Dict[str, Optional[object]] = {
    "batch": ("dcn", "dp", "fsdp"),
    "seq": "sp",
    "embed": "fsdp",
    "heads": "tp",
    "kv_heads": "tp",
    "mlp": "tp",
    "vocab": "tp",
    "expert": "ep",
    "stage": "pp",
    "layers": "pp",
    "norm": None,
    "head_dim": None,
}

BATCH_AXES = ("dcn", "dp", "fsdp")


def spec_for(logical_axes: Sequence[Optional[str]],
             rules: Optional[Dict] = None) -> Tuple:
    rules = rules or DEFAULT_RULES
    return tuple(rules.get(name) if name is not None else None
                 for name in logical_axes)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one spec entry names (None, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_size(axis_sizes: Dict[str, int], entry) -> int:
    n = 1
    for a in entry_axes(entry):
        n *= int(axis_sizes.get(a, 1))
    return n


def valid_spec_for(axis_sizes: Dict[str, int], shape: Sequence[int],
                   logical_axes: Sequence[Optional[str]],
                   rules: Optional[Dict] = None) -> Tuple:
    """:func:`spec_for` with axes the mesh lacks dropped, and any mesh
    axis whose size does not divide its dimension replicated instead (the
    reference's ``valid_spec_for``)."""
    cleaned = []
    for dim, entry in zip(shape, spec_for(logical_axes, rules)):
        kept = tuple(a for a in entry_axes(entry) if a in axis_sizes)
        entry = (None if not kept else kept[0] if len(kept) == 1 else kept)
        size = _axis_size(axis_sizes, entry)
        cleaned.append(entry if (size == 1 or dim % size == 0) else None)
    return tuple(cleaned)


def region_for(gshape: Sequence[int], spec: Sequence,
               axis_sizes: Dict[str, int],
               coords: Dict[str, int]) -> Tuple[Tuple[int, ...],
                                                Tuple[int, ...]]:
    """The ``(start, shape)`` block the rank at mesh coordinate ``coords``
    holds of a tensor of global shape ``gshape`` under ``spec``: combined
    axes index row-major, uneven dims take ceil blocks and trailing blocks
    clamp (possibly to empty) — jax's rule, and torch.chunk's."""
    start: List[int] = []
    shape: List[int] = []
    for d, dim in enumerate(gshape):
        entry = spec[d] if d < len(spec) else None
        n, idx = 1, 0
        for axis in entry_axes(entry):
            size = int(axis_sizes.get(axis, 1))
            n *= size
            idx = idx * size + int(coords.get(axis, 0)) % max(1, size)
        if n <= 1:
            start.append(0)
            shape.append(int(dim))
            continue
        block = -(-int(dim) // n)
        lo = min(idx * block, int(dim))
        start.append(lo)
        shape.append(min(lo + block, int(dim)) - lo)
    return tuple(start), tuple(shape)


def replica_axes(spec: Sequence, axis_sizes: Dict[str, int]) -> List[str]:
    """Mesh axes of size > 1 the tensor is NOT sharded over: the ranks
    along them hold copies of the same region."""
    used = {a for entry in spec for a in entry_axes(entry)}
    return [a for a in AXIS_ORDER
            if int(axis_sizes.get(a, 1)) > 1 and a not in used]


def mesh_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_coords(mesh, rank: Optional[int] = None) -> Dict[str, int]:
    """The mesh coordinate of ``rank`` (default: this process)."""
    rank = dist.get_rank() if rank is None else rank
    where = (mesh.mesh == rank).nonzero()
    if where.numel() == 0:
        raise ValueError(f"rank {rank} is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, (int(i) for i in where[0])))


def placements_for(spec: Sequence, mesh_axis_names: Sequence[str]):
    """DTensor placements (one per mesh dimension) for ``spec``."""
    from torch.distributed.tensor import Replicate, Shard

    owner: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        order = [mesh_axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry!r} is not in mesh order")
        for a in axes:
            owner[a] = d
    return [Shard(owner[a]) if a in owner else Replicate()
            for a in mesh_axis_names]


def held_block(mesh, axis: str, n_local: int, n_global: int
               ) -> Tuple[int, int]:
    """``(start, size)`` of the block of a dim of ``n_global`` that this
    rank was handed, read from the size ``n_local`` it holds: the whole
    dim, or its block along the mesh ``axis`` (even blocks, as
    :func:`valid_spec_for` shards only a dim the axis divides; a dim it
    does not divide stays whole). Raises for any other size."""
    n = 1 if mesh is None else mesh_sizes(mesh).get(axis, 1)
    if n_local == n_global:
        return 0, n_global
    if n > 1 and n_global % n == 0 and n_local == n_global // n:
        return mesh_coords(mesh)[axis] * n_local, n_local
    raise ValueError(f"a dim of {n_global} held as {n_local} is neither "
                     f"whole nor a block over {axis} = {n}")


def tp_heads(n_heads: int, n_kv_heads: int, tp: int, t: int
             ) -> Tuple[int, int, int, int]:
    """``(h0, h1, kv0, kv1)``: the q heads ``[h0, h1)`` the rank at ``tp``
    coordinate ``t`` attends with and the KV heads ``[kv0, kv1)`` they
    read under GQA (q head ``h`` reads KV head ``h // (H / KV)``). The
    q heads split evenly; the KV heads split with them when ``tp``
    divides them, and otherwise (``tp`` a multiple of KV) a rank's q
    heads all read one KV head, shared with its neighbours."""
    if n_heads % tp:
        raise ValueError(f"{n_heads} heads do not split over tp {tp}")
    if n_kv_heads % tp and tp % n_kv_heads:
        raise ValueError(f"{n_kv_heads} KV heads neither split over tp "
                         f"{tp} nor divide it")
    local = n_heads // tp
    rep = n_heads // n_kv_heads
    h0 = t * local
    return h0, h0 + local, h0 // rep, (h0 + local - 1) // rep + 1


def local_region(tensor: torch.Tensor, start, shape) -> torch.Tensor:
    """The ``(start, shape)`` block of ``tensor`` (a view)."""
    out = tensor
    for d, (lo, n) in enumerate(zip(start, shape)):
        out = out.narrow(d, lo, n)
    return out


def shard_tree(mesh, state, logical_tree, rules: Optional[Dict] = None):
    """A tree of full tensors → the same tree of DTensors, each rank
    keeping the region its coordinate owns (no collective: every rank
    holds the full tensor it starts from, as every jax process does)."""
    from torch.distributed.tensor import DTensor

    sizes = mesh_sizes(mesh)
    coords = mesh_coords(mesh)

    def put(axes, leaf):
        if isinstance(axes, dict):
            return {k: put(axes[k], leaf[k]) for k in axes}
        spec = valid_spec_for(sizes, leaf.shape, axes, rules)
        start, shape = region_for(leaf.shape, spec, sizes, coords)
        local = local_region(leaf, start, shape).contiguous()
        return DTensor.from_local(
            local, mesh, placements_for(spec, mesh.mesh_dim_names),
            run_check=False, shape=leaf.shape, stride=leaf.stride())

    return put(logical_tree, state)


def dtensor_spec(t) -> Tuple:
    """The spec of a DTensor: for each tensor dim, the mesh axes (in mesh
    order) that shard it."""
    names = t.device_mesh.mesh_dim_names
    per_dim: List[List[str]] = [[] for _ in range(t.ndim)]
    for axis, p in zip(names, t.placements):
        if p.is_shard():
            per_dim[p.dim].append(axis)
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in per_dim)


_groups: Dict[Tuple, object] = {}


def axis_group(mesh, axes: Sequence[str], backend: Optional[str] = None):
    """This rank's process group over the mesh ``axes`` (the ranks that
    differ from it only along them), or None when that group is this rank
    alone. Every rank builds every group of the family in the same order,
    as ``new_group`` requires; the result is cached per mesh."""
    sizes = mesh_sizes(mesh)
    axes = tuple(a for a in mesh.mesh_dim_names
                 if a in axes and sizes[a] > 1)
    if not axes:
        return None
    key = (id(mesh), axes, backend)
    if key not in _groups:
        names = list(mesh.mesh_dim_names)
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        grid = mesh.mesh.permute(*rest, *dims).reshape(
            -1, int(torch.prod(torch.tensor([sizes[a] for a in axes]))))
        me = dist.get_rank()
        mine = None
        for row in grid.tolist():
            group = dist.new_group(row, backend=backend)
            if me in row:
                mine = group
        _groups[key] = mine
    return _groups[key]


def global_batch_from_local(mesh, local_batch) -> torch.Tensor:
    """The global input batch from this rank's local rows: the rows of the
    ranks along the data axes (dcn, dp, fsdp), gathered in their mesh
    order — the reference's ``make_array_from_process_local_data`` over
    the same axes. On the host, over gloo; one rank is the identity."""
    local = torch.as_tensor(local_batch)
    group = axis_group(mesh, BATCH_AXES, backend="gloo")
    if group is None:
        return local
    parts = [torch.empty_like(local)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts)
