"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; raises when there is none.

    The port runs on the card unless the caller asks for the CPU
    explicitly (``device="cpu"``, as the CPU tests do): a missing GPU is an
    error, never a silent fall back onto the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path "
                "on the CPU explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={device} requested but CUDA is not "
                               "available")
        if device.index is None:  # "cuda" names the current device
            device = torch.device("cuda", torch.cuda.current_device())
    return device
