"""ElasticTrainer: fixed global batch under a changing world.

Counterpart of ``dlrover_tpu/trainer/elastic.py``. The trainer keeps the
*global* batch fixed as the data-parallel world changes by recomputing
``grad_accum = global_batch / (micro_batch × dp_total)``, so the tokens per
optimizer step are the same before and after an elastic event.

One ``train_step`` runs the accumulation micro steps one after another
(the reference's ``lax.scan``): each takes ``torch.autograd.grad`` of the
loss, so its bf16 grads are freed once they are added into the f32
accumulators. Then it divides by ``accum``, takes the global norm, runs the
optimizer and writes ``(p.f32 + u).astype(p.dtype)`` into the params in
place (the reference donates the state to the same end).

Across ranks the params are DTensors (``parallel.sharding.shard_tree``).
The kernels take plain tensors through ``ctypes``, so a step gathers each
param whole (``full_tensor``), runs the micro steps on this rank's rows of
the global batch, reduces the f32 accumulators to each leaf's placement as
the mean over the batch ranks (``reduce_scatter_tensor`` along a dim the
data axes shard, ``all_reduce`` over the data axes that replicate it),
takes the global norm with one ``all_reduce`` and runs AdamW on the local
shards. On one rank, or with plain tensors, no collective runs and the
step is the single-card step bit for bit.

Before it writes the state in place the step waits for the registered
readers of it (``common.state_fence``: a checkpoint snapshot still
streaming to the host).

Not ported yet: the memory-ledger claims and the compile-watch signature
of the reference's ``train_step`` (they need the port's own observability
planes).
"""

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from dlrover_tpu_torch.common import state_fence
from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.parallel import sharding
from dlrover_tpu_torch.parallel.mesh import MeshPlan, plan_mesh
from dlrover_tpu_torch.trainer.optim import tree_leaves, tree_unflatten


class TrainStepResult(NamedTuple):
    loss: Any
    grad_norm: Any


def make_train_state(params, optimizer) -> Dict:
    device = tree_leaves(params)[0].device
    return {
        "params": params,
        "opt_state": optimizer.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


class ElasticTrainer:
    def __init__(
        self,
        loss_fn: Callable,  # loss_fn(params, microbatch) -> scalar
        optimizer,          # trainer.optim.GradientTransformation
        global_batch_size: int,
        micro_batch_per_replica: int,
        mesh_manager=None,  # anything with apply_plan(MeshPlan)
        device="cuda",
    ):
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        self.global_batch_size = global_batch_size
        self.micro_batch_per_replica = micro_batch_per_replica
        self._mesh_manager = mesh_manager
        self.device = resolve_device(device)
        self.grad_accum_steps = 1
        self._mesh_version = 0

    def configure_for_world(self, plan: MeshPlan) -> int:
        """(Re)compute grad-accum for the current mesh."""
        dp_total = plan.dp_total
        denom = self.micro_batch_per_replica * dp_total
        if self.global_batch_size % denom != 0:
            raise ValueError(
                f"global_batch_size={self.global_batch_size} not divisible "
                f"by micro_batch×dp_total={denom} — adjust micro batch or "
                f"constrain the world with node_unit"
            )
        self.grad_accum_steps = self.global_batch_size // denom
        logger.info(
            "elastic trainer: dp_total=%s grad_accum=%s (global batch %s)",
            dp_total, self.grad_accum_steps, self.global_batch_size,
        )
        return self.grad_accum_steps

    def apply_parallel_config(self, config) -> Optional[MeshPlan]:
        """Re-form the mesh from a re-planned ``ParallelConfig`` (the
        tuner-shipped JSON dict or the comm message itself). A
        ``mesh_version`` the trainer has not applied yet turns the (data,
        fsdp, tp) decomposition into a :class:`MeshPlan`, adopts it on the
        mesh manager when there is one, and recomputes grad-accum. Returns
        the new plan, or None when nothing changed."""
        if isinstance(config, dict):
            def get(key):
                return config.get(key, 0)
        else:
            def get(key):
                return getattr(config, key, 0)
        version = int(get("mesh_version") or 0)
        data = max(1, int(get("mesh_data") or 0))
        fsdp = max(1, int(get("mesh_fsdp") or 0))
        tp = max(1, int(get("mesh_tp") or 0))
        if version <= self._mesh_version or data * fsdp * tp <= 1:
            return None
        plan = plan_mesh(data * fsdp * tp, tp=tp, fsdp=fsdp, dp=data)
        if self._mesh_manager is not None:
            self._mesh_manager.apply_plan(plan)
        self._mesh_version = version
        self.configure_for_world(plan)
        logger.info(
            "elastic trainer: mesh v%s applied — data=%s fsdp=%s tp=%s",
            version, data, fsdp, tp,
        )
        return plan

    @property
    def micro_batch_global(self) -> int:
        """Rows per microbatch across the whole mesh."""
        return self.global_batch_size // self.grad_accum_steps

    def train_step(self, state, batch):
        """batch: ``(accum, micro_batch_global, ...)`` tokens (numpy or a
        tensor; moved to the trainer's device), the whole global batch on
        every rank. Returns ``(new_state, TrainStepResult(loss,
        grad_norm))``; the params tensors are updated in place and the
        optimizer state is advanced in place."""
        batch = torch.as_tensor(batch).to(self.device)
        accum = self.grad_accum_steps
        if batch.shape[0] != accum:
            raise ValueError(
                f"batch leading axis {batch.shape[0]} != grad_accum {accum}")
        params = state["params"]
        leaves = tree_leaves(params)
        mesh = next((p.device_mesh for p in leaves
                     if isinstance(p, DTensor)), None)
        spread = mesh is not None and mesh.size() > 1
        if spread:
            full = [p.full_tensor() if isinstance(p, DTensor) else p
                    for p in leaves]
            batch = self._rows_of_this_rank(mesh, batch)
        else:
            full = [_local(p) for p in leaves]
        # aliases that require grad, so the caller's tensors keep their flags
        live = [p.detach().requires_grad_() for p in full]
        live_params = tree_unflatten(params, live)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in full]
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        with torch.enable_grad():
            for microbatch in batch:
                loss = self._loss_fn(live_params, microbatch)
                grads = torch.autograd.grad(loss, live)
                torch._foreach_add_(acc, grads)
                del grads
                loss_sum += loss.detach().float()
        del live, live_params, full
        torch._foreach_div_(acc, accum)
        loss = loss_sum / accum
        if spread:
            acc, grad_norm, loss = _reduce_to_placements(
                mesh, leaves, acc, loss)
        else:
            grad_norm = global_norm(acc)
        local_params = tree_unflatten(params, [_local(p) for p in leaves])
        opt_state = state["opt_state"]
        local_opt = {k: (tree_unflatten(v, [_local(t) for t in tree_leaves(v)])
                         if isinstance(v, dict) else v)
                     for k, v in opt_state.items()}
        state_fence.wait_readers()
        updates, new_local = self._optimizer.update(
            tree_unflatten(params, acc), local_opt, local_params)
        new_opt = {k: (opt_state[k] if isinstance(opt_state.get(k), dict)
                       else v) for k, v in new_local.items()}
        with torch.no_grad():
            upd = tree_leaves(updates)
            ps = tree_leaves(local_params)
            torch._foreach_add_(upd, ps)  # p.f32 + u, in f32
            torch._foreach_copy_(ps, upd)  # rounded to the param dtype
        new_state = {**state, "params": params, "opt_state": new_opt,
                     "step": state["step"] + 1}
        return new_state, TrainStepResult(loss, grad_norm)

    @staticmethod
    def _rows_of_this_rank(mesh, batch):
        """This rank's rows of every micro batch: the micro batch split
        over the data axes (dcn, dp, fsdp) in mesh order."""
        sizes = sharding.mesh_sizes(mesh)
        coords = sharding.mesh_coords(mesh)
        n, idx = 1, 0
        for axis in sharding.BATCH_AXES:
            n *= sizes[axis]
            idx = idx * sizes[axis] + coords[axis]
        rows = batch.shape[1]
        if rows % n:
            raise ValueError(f"micro batch {rows} rows over {n} data ranks")
        return batch[:, idx * rows // n:(idx + 1) * rows // n]


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _reduce_to_placements(mesh, leaves, acc, loss):
    """Per-rank f32 grads of the whole params → each leaf's local shard of
    the mean over the data ranks, the global grad norm, and the mean
    loss. Ranks that differ only in model axes (tp, pp, ...) ran the same
    rows, so their grads already agree: they just keep their region."""
    sizes = sharding.mesh_sizes(mesh)
    coords = sharding.mesh_coords(mesh)
    n_data = 1
    for axis in sharding.BATCH_AXES:
        n_data *= sizes[axis]
    out = []
    sq = torch.zeros((), dtype=torch.float32, device=loss.device)
    for p, g in zip(leaves, acc):
        spec = (sharding.dtensor_spec(p) if isinstance(p, DTensor)
                else (None,) * g.ndim)
        model_spec = tuple(
            tuple(a for a in sharding.entry_axes(e)
                  if a not in sharding.BATCH_AXES) or None
            for e in spec)
        start, shape = sharding.region_for(g.shape, model_spec, sizes, coords)
        g = sharding.local_region(g, start, shape)
        used = {a for e in spec for a in sharding.entry_axes(e)}
        group = sharding.axis_group(
            mesh, [a for a in sharding.BATCH_AXES if a not in used])
        if group is not None:
            g = g.contiguous()
            dist.all_reduce(g, group=group)
        for d, e in enumerate(spec):
            data_axes = [a for a in sharding.entry_axes(e)
                         if a in sharding.BATCH_AXES]
            group = sharding.axis_group(mesh, data_axes)
            if group is None:
                continue
            if len(data_axes) != len(sharding.entry_axes(e)):
                raise NotImplementedError(
                    f"dim {d} mixes data and model axes: {e}")
            k = dist.get_world_size(group)
            chunks = torch.stack(g.chunk(k, dim=d))
            piece = torch.empty_like(chunks[0])
            dist.reduce_scatter_tensor(
                piece, chunks.reshape(-1, *piece.shape[1:]), group=group)
            g = piece
        g = g / n_data if n_data > 1 else g.contiguous()
        owner = all(coords[a] == 0
                    for a in sharding.replica_axes(spec, sizes))
        if owner:
            sq = sq + torch.sum(torch.square(g))
        out.append(g)
    dist.all_reduce(sq)
    if n_data > 1:
        loss = loss.clone()
        dist.all_reduce(loss, group=sharding.axis_group(
            mesh, sharding.BATCH_AXES))
        loss = loss / n_data
    return out, torch.sqrt(sq), loss
