"""Device resolution for the port's entry points.

The port's users pay for time on the GPU, so an entry point runs there
unless its caller asks for the CPU by name.  There is no silent fallback:
a caller that passes no device on a machine without CUDA gets an error,
never a CPU run that looks like a device run.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` → the current CUDA device (raises without CUDA);
    ``"cpu"`` or ``"cuda[:n]"`` (or a :class:`torch.device`) as given.
    Any other device type raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: jepsen_tpu_torch runs on the GPU by "
                "default; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r} (cuda or cpu)")
    return dev

