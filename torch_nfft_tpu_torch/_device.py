"""Device resolution and float32 numerics for the PyTorch port.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``.
Asking for nothing on a machine without a card raises: the port never falls
back to the CPU silently.

Every CUDA resolution pins full float32 products:
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``. A one-pass reduced-precision
product (TF32 keeps ~10 mantissa bits) fails the NFFT accuracy budget; the
JAX reference measured ~4e-3 rel-L2 for one bf16 pass on its TPU
(docs/tpu_design.md). The plain PyTorch versions of the kernels contract
with ``einsum``, which TF32 would otherwise degrade on the card.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "pin_fp32"]


def pin_fp32() -> None:
    """Turn TF32 off for matmuls and cuDNN (see the module note)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    current CUDA card. Raises when a card is needed and there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        if device.index is None:  # plans compare devices: name the card
            device = torch.device("cuda", torch.cuda.current_device())
        pin_fp32()
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    return device
