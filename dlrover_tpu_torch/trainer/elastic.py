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
param over every mesh axis but the ``local_axes`` the loss handles itself:
``pp`` for a pipeline loss (``llama.next_token_loss_pp``: a stage takes
its block of the stacked layers), ``ep`` for the MoE loss given the mesh
(``moe.next_token_loss``: a rank runs its block of experts), and
``fsdp`` and ``tp`` for a loss given the mesh that computes on blocks
(``models/llama.py``: each layer gathers its fsdp blocks inside its
forward and its recompute through ``collectives.gather_shard``, whose
backward reduce-scatters the grad into the block; the tp ranks run their
own heads, columns and vocab rows between *f* and *g*). The caller names
them (``ElasticTrainer(local_axes=...)``); along them a leaf stays this
rank's block, its f32 accumulator takes that block's shape, and the step
runs no collective of its own. Along the other axes the step computes on
the whole tensor. It runs the micro steps on this rank's rows of the
global batch, reduces the f32 accumulators to each leaf's placement as
the mean over the ranks of the data axes, ``sp`` and ``pp``
(``reduce_scatter_tensor`` along a gathered dim those axes shard,
``all_reduce`` over those that replicate it; a dim held as a block along
a local ``fsdp`` was reduce-scattered by the model already), takes the
global norm with one ``all_reduce`` and runs AdamW on the local shards.
On one rank, or with plain tensors, no collective runs and the step is
the single-card step bit for bit.

Before it writes the state in place the step waits for the registered
readers of it (``common.state_fence``: a checkpoint snapshot still
streaming to the host).

The first step after the world is (re)configured claims the training
state in the memory ledger (``observability/memory.py``): the params and
the optimizer state at the exact bytes of this rank's tensors (a
DTensor's local shard, not its global size) and the f32 grad
accumulators, which a step allocates at each param's gathered shape (its
block along the local axes), as ``activations``. Every step notes its
``(accum, rows, seq)`` signature in the compile watch
(``observability/compile_watch.py``, ``trainer.train_step``); the first
step at a new signature is timed as its miss.
"""

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from dlrover_tpu_torch.common import state_fence
from dlrover_tpu_torch.common.constants import MetricLabel
from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.observability.compile_watch import get_watcher
from dlrover_tpu_torch.observability.memory import get_accountant
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
        # mesh axes along which loss_fn takes this rank's block (LOCAL_AXES)
        local_axes: Sequence[str] = (),
    ):
        unknown = set(local_axes) - set(LOCAL_AXES)
        if unknown:
            raise ValueError(f"local_axes {sorted(unknown)}: a loss computes "
                             f"on its own block only along {LOCAL_AXES}")
        self.local_axes = tuple(local_axes)
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        self.global_batch_size = global_batch_size
        self.micro_batch_per_replica = micro_batch_per_replica
        self._mesh_manager = mesh_manager
        self.device = resolve_device(device)
        self.grad_accum_steps = 1
        self._mesh_version = 0
        # the ledger claims are (re)taken at the first step of a world
        self._state_claimed = False

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
        self._state_claimed = False
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

    def claim_state(self, state) -> None:
        """Claim the training state in the memory ledger: params and
        optimizer state at this rank's exact bytes, and the f32 grad
        accumulators (at the shapes a step allocates them) as
        activations."""
        params = tree_leaves(state["params"])
        params_b = sum(_local(p).numel() * _local(p).element_size()
                       for p in params)
        opt_b = sum(_local(t).numel() * _local(t).element_size()
                    for t in tree_leaves(state["opt_state"])
                    if isinstance(t, torch.Tensor))
        accum_b = sum(4 * math.prod(_compute_shape(p, self.local_axes))
                      for p in params)
        acc = get_accountant()
        acc.register(MetricLabel.MEM_PARAMS, "trainer/params", params_b)
        acc.register(MetricLabel.MEM_OPT_STATE, "trainer/opt_state", opt_b)
        acc.register(MetricLabel.MEM_ACTIVATIONS, "trainer/grad_accum",
                     accum_b)
        self._state_claimed = True

    def train_step(self, state, batch):
        """batch: ``(accum, micro_batch_global, ...)`` tokens (numpy or a
        tensor; moved to the trainer's device), the whole global batch on
        every rank. Returns ``(new_state, TrainStepResult(loss,
        grad_norm))``; the params tensors are updated in place and the
        optimizer state is advanced in place."""
        if not self._state_claimed:
            self.claim_state(state)
        shape = tuple(getattr(batch, "shape", ()) or ())
        with get_watcher().time(
                "trainer.train_step", accum=self.grad_accum_steps,
                batch=shape[1] if len(shape) > 1 else 0,
                seq_len=shape[2] if len(shape) > 2 else 0):
            return self._train_step(state, batch)

    def _train_step(self, state, batch):
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
            full = [_compute_view(p, self.local_axes) for p in leaves]
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
                mesh, leaves, acc, loss, self.local_axes)
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
        over the data axes (dcn, dp, fsdp) in mesh order. Under sequence
        parallelism the model takes the rank's chunk of each row."""
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


# the mesh axes along which a loss may compute on this rank's block
LOCAL_AXES = ("pp", "ep", "fsdp", "tp")


def _local_dims(spec, local_axes):
    """The dims of ``spec`` sharded over a local axis (each over that
    axis alone)."""
    dims = []
    for d, e in enumerate(spec):
        axes = sharding.entry_axes(e)
        if any(a in local_axes for a in axes):
            if len(axes) != 1:
                raise NotImplementedError(
                    f"dim {d} mixes a local axis with others: {e}")
            dims.append(d)
    return dims


def _compute_view(p, local_axes):
    """What a step computes on: ``p`` gathered over every mesh axis but
    ``local_axes``, along which it stays this rank's block."""
    if not isinstance(p, DTensor):
        return p
    keep = [pl if name in local_axes and pl.is_shard() else Replicate()
            for name, pl in zip(p.device_mesh.mesh_dim_names, p.placements)]
    return p.redistribute(p.device_mesh, keep).to_local()


def _compute_shape(p, local_axes):
    """The shape of :func:`_compute_view` of ``p``."""
    if not isinstance(p, DTensor):
        return tuple(p.shape)
    spec = sharding.dtensor_spec(p)
    dims = _local_dims(spec, local_axes)
    local_spec = tuple(e if d in dims else None for d, e in enumerate(spec))
    return sharding.region_for(p.shape, local_spec,
                               sharding.mesh_sizes(p.device_mesh),
                               sharding.mesh_coords(p.device_mesh))[1]


# the axes whose ranks compute different parts of the gradient: the data
# axes (their own rows), sp (its own chunk of the sequence) and pp (its
# stage's part of the pipeline, with the ends on every stage)
MEAN_AXES = sharding.BATCH_AXES + ("pp", "sp")


def _reduce_to_placements(mesh, leaves, acc, loss, local_axes=()):
    """Per-rank f32 grads of the params as the step computed on them (whole,
    or this rank's block along ``local_axes``) → each leaf's local shard
    of their mean over the ranks of :data:`MEAN_AXES`, the global grad
    norm, and the mean loss.

    Each rank's loss is the mean over its rows and, under sequence
    parallelism, over its chunk of the sequence, so the step's loss is the
    mean of the ranks' losses over the data axes and sp. Under pipeline
    parallelism every pp rank returns the same loss, and its gradients are
    its part of the gradient of the sum of the pp ranks' losses (the
    schedule's collectives carry their adjoints, ``parallel/pipeline.py``):
    its stage's layers, the ends on every rank, the embedding on stage 0.
    So the mean over pp counts every contribution once. A dim sharded over
    a local axis is already this rank's block and is neither cut nor
    reduced along it: with a stage-local pipeline loss, no other stage
    touched the stage's layers, so the mean over pp is the stage's own
    gradient over pp. A dim held as a block along a local ``fsdp`` has
    the sum over fsdp already (the model's ``gather_shard`` reduce-
    scattered it), so the leaf is all-reduced over the other averaged
    axes only, and divided by the whole ``n_mean``. Ranks that differ
    only in tp or ep ran the same rows and agree on every gradient they
    both hold (under a local ``ep`` or ``tp`` the region's *f*,
    ``collectives.to_region``, sums the ranks' shares of the replicated
    leaves' gradients): they keep their region with no collective."""
    sizes = sharding.mesh_sizes(mesh)
    coords = sharding.mesh_coords(mesh)
    n_mean = 1
    for axis in MEAN_AXES:
        n_mean *= sizes[axis]
    out = []
    sq = torch.zeros((), dtype=torch.float32, device=loss.device)
    for p, g in zip(leaves, acc):
        spec = (sharding.dtensor_spec(p) if isinstance(p, DTensor)
                else (None,) * g.ndim)
        local = _local_dims(spec, local_axes)
        model_spec = tuple(
            None if d in local else
            tuple(a for a in sharding.entry_axes(e)
                  if a not in MEAN_AXES) or None
            for d, e in enumerate(spec))
        start, shape = sharding.region_for(g.shape, model_spec, sizes, coords)
        g = sharding.local_region(g, start, shape)
        used = {a for e in spec for a in sharding.entry_axes(e)}
        group = sharding.axis_group(
            mesh, [a for a in MEAN_AXES if a not in used])
        if group is not None:
            g = g.contiguous()
            dist.all_reduce(g, group=group)
        for d, e in enumerate(spec):
            if d in local:
                continue
            mean_axes = [a for a in sharding.entry_axes(e) if a in MEAN_AXES]
            group = sharding.axis_group(mesh, mean_axes)
            if group is None:
                continue
            if len(mean_axes) != len(sharding.entry_axes(e)):
                raise NotImplementedError(
                    f"dim {d} mixes averaged and model axes: {e}")
            k = dist.get_world_size(group)
            chunks = torch.stack(g.chunk(k, dim=d))
            piece = torch.empty_like(chunks[0])
            dist.reduce_scatter_tensor(
                piece, chunks.reshape(-1, *piece.shape[1:]), group=group)
            g = piece
        g = g / n_mean if n_mean > 1 else g.contiguous()
        owner = all(coords[a] == 0
                    for a in sharding.replica_axes(spec, sizes))
        if owner:
            sq = sq + torch.sum(torch.square(g))
        out.append(g)
    dist.all_reduce(sq)
    if n_mean > 1:
        loss = loss.clone()
        dist.all_reduce(loss, group=sharding.axis_group(mesh, MEAN_AXES))
        loss = loss / n_mean
    return out, torch.sqrt(sq), loss
