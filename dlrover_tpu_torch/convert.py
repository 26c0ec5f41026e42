"""Carry a JAX params pytree over to the port.

``params_from_jax`` takes the nested dict of arrays that
``dlrover_tpu.models.llama.init_params`` builds (after ``np.asarray`` on
each leaf, or the jax arrays themselves) and returns the same nesting of
torch tensors. The layout is kept as it is: stacked ``(L, in, out)``
layer weights, ``x @ W`` orientation, no transposes.

bf16 leaves come out of ``np.asarray`` as ``ml_dtypes.bfloat16``, a type
neither torch nor the card machine (which has no ``ml_dtypes``) knows. They
are carried by dtype NAME: the 16-bit pattern is viewed as ``uint16`` and
reinterpreted as ``torch.bfloat16``, bit for bit.
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
