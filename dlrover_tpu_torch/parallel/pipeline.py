"""Pipeline parallelism over the mesh's ``pp`` axis: the GPipe schedule.

Counterpart of ``dlrover_tpu/parallel/pipeline.py``, with its tick
schedule: ``T = M + S - 1`` ticks stream ``M`` microbatches through ``S``
stages. At tick ``t`` every stage first hands its previous output one hop
on (stage ``i`` to ``i + 1``), stage 0 then takes microbatch ``min(t, M -
1)`` and every other stage what it received, each runs its stage, and the
last stage's output at tick ``t >= S - 1`` is microbatch ``t - (S - 1)``.
The bubble is ``(S - 1) / T`` of the ticks.

The reference's backward is JAX's transpose of the whole SPMD program.
Here each rank differentiates its own graph, so the schedule is built for
that:

- the hop is a differentiable ``collectives.shift`` (no wrap), whose
  backward is the hop ``i + 1 -> i``;
- every rank's returned tensor reaches all of its hop nodes: stage 0
  selects its feed with ``torch.where`` over the received tensor (as the
  reference's ``jnp.where``), and every stage stacks its outputs of the
  last ``M`` ticks as its result, which :func:`pipeline_apply` then
  replaces by the last stage's (``collectives.from_rank``). So every rank
  runs every hop's backward, in reverse tick order, and its neighbours'
  sends find their receives;
- the last stage's outputs go to every rank, whose loss then reads them:
  that broadcast's backward sums the ranks' cotangents onto the last
  stage. Each rank's gradients are its part of the gradient of the sum of
  the ``S`` ranks' (equal) losses, so the trainer takes their mean over
  ``pp`` (``trainer/elastic.py``).

``torch.distributed.pipelining``'s ``ScheduleGPipe`` is not used: its
``step()`` runs forward and backward itself, where the trainer takes the
loss from ``loss_fn`` and the gradients with ``torch.autograd.grad``.
"""

from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.parallel import sharding
from dlrover_tpu_torch.parallel.collectives import from_rank, shift


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_stages(tree: Any, n_stages: int) -> Any:
    """Reshape depth-stacked per-layer params ``(L, ...)`` into stage
    groups ``(S, L/S, ...)`` (contiguous layer ranges per stage)."""

    def _split(leaf):
        L = leaf.shape[0]
        if L % n_stages != 0:
            raise ValueError(
                f"{L} layers not divisible into {n_stages} pipeline stages"
            )
        return leaf.reshape((n_stages, L // n_stages) + tuple(leaf.shape[1:]))

    return _tree_map(_split, tree)


def unstack_stages(tree: Any) -> Any:
    """Inverse of :func:`stack_stages`: back to ``(L, ...)``."""
    return _tree_map(
        lambda leaf: leaf.reshape((-1,) + tuple(leaf.shape[2:])), tree)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe fill/drain overhead: pick M >= 4*S to keep it under 20%."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def microbatch(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, ...) → (n, B/n, ...)"""
    if x.shape[0] % n != 0:
        raise ValueError(f"batch {x.shape[0]} not divisible by {n}")
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))


def unmicrobatch(x: torch.Tensor) -> torch.Tensor:
    """(n, b, ...) → (n*b, ...)"""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    microbatches: torch.Tensor,
    mesh,
    axis: str = "pp",
    checkpoint_ticks: bool = True,
):
    """Run ``M`` microbatches through ``S`` = the mesh's ``axis`` size
    stages; this rank runs stage ``i`` = its ``axis`` coordinate.

    ``stage_params``: a tree whose leaves have leading dim ``S``, every
    stage's params (see :func:`stack_stages`), of which the rank takes
    slice ``i``; or leading dim 1, this stage's own params alone (the
    reference's ``shard_map`` hands each device its ``(1, ...)`` slice),
    taken as they are. ``microbatches``:
    ``(M, b, ...)`` activations, this rank's rows (the trainer has already
    split the batch over the data axes, which the reference does with its
    ``batch_axes``). Returns the last stage's ``(M, b, ...)`` outputs on
    every rank of the axis. ``checkpoint_ticks`` recomputes each tick's
    stage in backward (``torch.utils.checkpoint`` around the stage
    function, never around a hop)."""
    group = sharding.axis_group(mesh, [axis])
    if group is None:
        params = _tree_map(lambda p: p[0], stage_params)
        return torch.stack([stage_fn(params, x) for x in microbatches])
    S = sharding.mesh_sizes(mesh)[axis]
    idx = sharding.mesh_coords(mesh)[axis]
    M = microbatches.shape[0]
    T = M + S - 1

    def take(p):
        if p.shape[0] not in (1, S):
            raise ValueError(f"stage params of leading dim {p.shape[0]}: "
                             f"expected {S} stages or this stage's 1")
        return p[idx if p.shape[0] == S else 0]

    params = _tree_map(take, stage_params)
    if checkpoint_ticks and torch.is_grad_enabled():
        def fn(p, h):
            return checkpoint(stage_fn, p, h, use_reentrant=False)
    else:
        fn = stage_fn
    first = torch.tensor(idx == 0, device=microbatches.device)
    state = torch.zeros_like(microbatches[0])
    outs = []
    for t in range(T):
        # neighbour hop: stage i's previous output arrives at stage i + 1
        (prev,) = shift((state,), group, wrap=False)
        inp = torch.where(first, microbatches[min(t, M - 1)], prev)
        state = fn(params, inp)
        if t >= S - 1:
            outs.append(state)
    return from_rank(torch.stack(outs), group, S - 1)


__all__ = [
    "pipeline_apply",
    "stack_stages",
    "unstack_stages",
    "bubble_fraction",
    "microbatch",
    "unmicrobatch",
]
