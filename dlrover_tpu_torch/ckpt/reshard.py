"""The regions a process must restore: the port's part of
``dlrover_tpu/ckpt/reshard.py`` (``NeedSpec``, ``needs_from_state``), built
on ``parallel.sharding.region_for``, the port's ``region_for_coords``. The
live reshard plane itself (cut records, the reshard service, transfers) is
not ported."""

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from dlrover_tpu_torch.convert import named_leaves
from dlrover_tpu_torch.parallel import sharding


@dataclass(frozen=True)
class NeedSpec:
    """The global regions of one leaf this process must materialise."""

    path: str
    dtype: str
    gshape: Tuple[int, ...]
    regions: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...]


def needs_from_state(state) -> Dict[str, NeedSpec]:
    """The region THIS rank must restore for each array leaf of ``state``,
    keyed by the reference's leaf names; plain values carry none."""
    needs: Dict[str, NeedSpec] = {}
    for path, leaf in named_leaves(state):
        if isinstance(leaf, np.ndarray):
            leaf = torch.from_numpy(leaf)
        if not isinstance(leaf, torch.Tensor):
            continue
        gshape = tuple(leaf.shape)
        if isinstance(leaf, DTensor):
            mesh = leaf.device_mesh
            region = sharding.region_for(
                gshape, sharding.dtensor_spec(leaf),
                sharding.mesh_sizes(mesh), sharding.mesh_coords(mesh))
        else:
            region = ((0,) * len(gshape), gshape)
        needs[path] = NeedSpec(path=path,
                               dtype=str(leaf.dtype).removeprefix("torch."),
                               gshape=gshape, regions=(region,))
    return needs
