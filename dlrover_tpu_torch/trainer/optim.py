"""AdamW with optax's numbers, for the port's trainer.

The JAX trainer takes an optax ``GradientTransformation``; its example job
uses ``optax.adamw(3e-4)``. :func:`adamw` returns the same functional pair,
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``, and computes what ``optax.adamw`` (0.2.6) computes, in the same
order:

- ``mu = (1 - b1) * g + b1 * mu``, ``nu = (1 - b2) * g*g + b2 * nu``;
- bias correction by the incremented ``count`` (``1 - b**count`` in f32),
  ``eps_root = 0``: ``u = mu_hat / (sqrt(nu_hat) + eps)``;
- the decoupled decay ``u + wd * p`` (``wd * p`` in the param dtype, as
  JAX rounds it), then ``-lr`` scales the sum.

optax starts ``mu``/``nu`` in the param dtype and its first update promotes
them to f32 (the grads are f32); f32 zeros from the start give the same
numbers. ``torch.optim.AdamW`` differs on both counts (decay 1e-2 by
default, steps in the param dtype), so it is not used.

Trees are nested dicts of tensors (the params layout); ``mu`` and ``nu``
have the params' nesting. To keep a 7B-class state in device memory the
update works in place: it advances ``state`` and writes the updates into
the storage of ``grads``, which the caller gives up.
"""

from typing import Any, Callable, Dict, List, NamedTuple

import torch


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict in a fixed order (sorted keys, as
    ``jax.tree.leaves`` orders a dict)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_unflatten(like, leaves):
    """The nesting of ``like`` filled with ``leaves`` (in tree_leaves order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        return next(it)

    return build(like)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> GradientTransformation:
    """``optax.adamw`` with a constant learning rate and no mask."""

    def init(params) -> Dict[str, Any]:
        leaves = tree_leaves(params)
        device = leaves[0].device

        def zeros():
            return tree_unflatten(params, [
                torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves])

        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": zeros(), "nu": zeros()}

    def update(grads, state, params):
        g = tree_leaves(grads)
        mu = tree_leaves(state["mu"])
        nu = tree_leaves(state["nu"])
        p = tree_leaves(params)
        # bias corrections as f32 scalars on the device: reading count
        # back to the host would wait for every grad kernel
        count = state["count"] + 1
        bc1 = 1 - torch.pow(b1, count.to(torch.float32))
        bc2 = 1 - torch.pow(b2, count.to(torch.float32))

        sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, sq)
        del sq
        torch._foreach_mul_(g, 1 - b1)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(g, mu)  # g now holds the new mu
        torch._foreach_copy_(mu, g)
        torch._foreach_div_(g, bc1)  # mu_hat
        den = torch._foreach_div(nu, bc2)  # nu_hat
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(g, den)
        del den
        torch._foreach_add_(g, torch._foreach_mul(p, weight_decay))
        torch._foreach_mul_(g, -learning_rate)
        new_state = {"count": count, "mu": state["mu"], "nu": state["nu"]}
        return tree_unflatten(grads, g), new_state

    return GradientTransformation(init, update)
