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

Not ported yet: the memory-ledger claims and the compile-watch signature
of the reference's ``train_step`` (they need the port's own observability
planes).
"""

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.common.log import logger
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
        tensor; moved to the trainer's device). Returns ``(new_state,
        TrainStepResult(loss, grad_norm))``; the params tensors are updated
        in place and the optimizer state is advanced in place."""
        batch = torch.as_tensor(batch).to(self.device)
        accum = self.grad_accum_steps
        if batch.shape[0] != accum:
            raise ValueError(
                f"batch leading axis {batch.shape[0]} != grad_accum {accum}")
        params = state["params"]
        leaves = tree_leaves(params)
        # aliases that require grad, so the caller's tensors keep their flags
        live = [p.detach().requires_grad_() for p in leaves]
        live_params = tree_unflatten(params, live)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        with torch.enable_grad():
            for microbatch in batch:
                loss = self._loss_fn(live_params, microbatch)
                grads = torch.autograd.grad(loss, live)
                torch._foreach_add_(acc, grads)
                del grads
                loss_sum += loss.detach().float()
        del live, live_params
        torch._foreach_div_(acc, accum)
        grad_norm = global_norm(acc)
        updates, opt_state = self._optimizer.update(
            tree_unflatten(params, acc), state["opt_state"], params)
        with torch.no_grad():
            upd = tree_leaves(updates)
            torch._foreach_add_(upd, leaves)  # p.f32 + u, in f32
            torch._foreach_copy_(leaves, upd)  # rounded to the param dtype
        new_state = {"params": params, "opt_state": opt_state,
                     "step": state["step"] + 1}
        return new_state, TrainStepResult(loss_sum / accum, grad_norm)
