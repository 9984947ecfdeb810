"""Device resolution for the port's entry points: the card by default, never a
silent fall back to the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the current CUDA card and raises when there is none;
    pass ``"cpu"`` explicitly to run the plain PyTorch versions on the host.

    Also switches TF32 off for matmuls and cuDNN: the sampling path is f32
    (``configs/denoising/painn_so3.yml``), and TF32 would keep only about
    three decimal digits in every Linear layer.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch path on the host"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
