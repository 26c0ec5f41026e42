"""Device resolution shared by the port's entry points."""

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`. A CUDA device on a box
    without CUDA raises: the port never drifts to the CPU on its own, the
    caller asks for it (``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
