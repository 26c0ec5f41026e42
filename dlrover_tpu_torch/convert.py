"""Carry a JAX params pytree, or a whole train state, over to the port.

``params_from_jax`` takes the nested dict of arrays that
``dlrover_tpu.models.llama.init_params`` or ``moe.init_params`` builds
(after ``np.asarray`` on each leaf, or the jax arrays themselves) and
returns the same nesting of torch tensors, each leaf in its own dtype (the
MoE router stays f32, the expert tensors keep their leading ``E`` axis). The layout is kept as it is: stacked ``(L, in, out)``
layer weights, ``x @ W`` orientation, no transposes.

bf16 leaves come out of ``np.asarray`` as ``ml_dtypes.bfloat16``, a type
neither torch nor the card machine (which has no ``ml_dtypes``) knows. They
are carried by dtype NAME: the 16-bit pattern is viewed as ``uint16`` and
reinterpreted as ``torch.bfloat16``, bit for bit.

``train_state_from_jax`` carries the JAX trainer's state (params, the
``optax.adamw`` state and ``step``) over to the port's
``trainer.elastic`` / ``trainer.optim`` layout, so a job trained by the JAX
package resumes in the port.
"""

from typing import Any, Dict

import numpy as np
import torch

from dlrover_tpu_torch.common.device import resolve_device


def tensor_from_numpy(arr, device="cuda") -> torch.Tensor:
    """One array (numpy, or anything ``np.asarray`` takes) → tensor on
    ``device``, bf16 carried bitwise."""
    a = np.array(arr, copy=True)  # own, writable, contiguous
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def params_from_jax(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Nested dict of arrays → the same nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def train_state_from_jax(state: Dict[str, Any], device="cuda"
                         ) -> Dict[str, Any]:
    """A JAX ``make_train_state`` dict, after any number of steps, → the
    port's train state. The adam moments are found in ``opt_state`` (the
    chain's ``ScaleByAdamState``: ``count``, ``mu``, ``nu``) and kept in
    f32, as the port's ``adamw`` keeps them (optax's bf16 zeros before the
    first step are the same numbers)."""
    adam = next((s for s in state["opt_state"]
                 if all(hasattr(s, f) for f in ("count", "mu", "nu"))), None)
    if adam is None:
        raise ValueError("opt_state holds no adam state (count, mu, nu)")

    def moments(tree):
        if isinstance(tree, dict):
            return {k: moments(v) for k, v in tree.items()}
        return tensor_from_numpy(tree, device).float()

    def scalar(x):
        return tensor_from_numpy(np.asarray(x, np.int32), device)

    return {
        "params": params_from_jax(state["params"], device),
        "opt_state": {"count": scalar(adam.count), "mu": moments(adam.mu),
                      "nu": moments(adam.nu)},
        "step": scalar(state["step"]),
    }


# -- leaf names shared with the JAX package's checkpoints -------------------
#
# The checkpoint engines name each leaf by jax's ``keystr`` of its path in
# the JAX train state: ``['params']['layers']['wq']``, ``['step']``, and the
# adam moments under the optax chain's first state,
# ``['opt_state'][0].count`` / ``.mu[...]`` / ``.nu[...]``. The port's state
# keeps ``opt_state = {"count", "mu", "nu"}``; these two functions map
# between its paths and those names, so either engine restores the other's
# frames.


def jax_leaf_name(path) -> str:
    """The JAX ``keystr`` name of the port state's leaf at ``path`` (a
    tuple of dict keys)."""
    path = tuple(path)
    if len(path) >= 2 and path[0] == "opt_state":
        return ("['opt_state'][0]." + path[1]
                + "".join(f"[{k!r}]" for k in path[2:]))
    return "".join(f"[{k!r}]" for k in path)


def port_leaf_path(name: str):
    """Inverse of :func:`jax_leaf_name`: the port state's path of the leaf
    the JAX package names ``name``."""
    import ast

    head = "['opt_state'][0]."
    path = []
    if name.startswith(head):
        rest = name[len(head):]
        attr, _, rest = rest.partition("[")
        path += ["opt_state", attr]
        name = "[" + rest if rest else ""
    while name:
        if not name.startswith("["):
            raise ValueError(f"not a dict-key path: {name!r}")
        end = name.index("]")
        path.append(ast.literal_eval(name[1:end]))
        name = name[end + 1:]
    return tuple(path)


def named_leaves(state, path=()):
    """``[(jax name, leaf)]`` of a nested-dict state, in jax's flatten
    order (sorted keys)."""
    if isinstance(state, dict):
        return [item for key in sorted(state)
                for item in named_leaves(state[key], path + (key,))]
    return [(jax_leaf_name(path), state)]


def map_named(fn, state, path=()):
    """The state with each leaf replaced by ``fn(jax name, leaf)``."""
    if isinstance(state, dict):
        return {key: map_named(fn, state[key], path + (key,))
                for key in state}
    return fn(jax_leaf_name(path), state)
