"""Device resolution and fp32 numerics for the PyTorch port.

Every entry point of the port takes ``device=None``, which means the GPU:
the port serves from the card, and a caller who wants the CPU (the tests,
a laptop without a card) asks for it by name.  A request for ``cuda`` on a
host without one raises instead of quietly running on the CPU.

The JAX reference computes in strict float32, so the port pins the same
numerics on every device it resolves: ``torch.set_float32_matmul_precision
("highest")`` with TF32 off for both matrix products and cuDNN.  TF32 keeps
about three decimal digits, which would break the port's agreement with the
reference (attention within 1e-5, greedy token streams equal).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "set_fp32_numerics"]


def set_fp32_numerics() -> None:
    """Full-precision float32 products: no TF32 in cuBLAS or cuDNN."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises.

    ``'cuda'`` resolves to the indexed current card (``cuda:0``), the
    device a tensor created on it reports, so devices compare equal.

    Also pins the float32 numerics (:func:`set_fp32_numerics`), so every
    entry point that resolves a device computes like the reference.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on an NVIDIA GPU by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:  # 'cuda' names the current card, as cuda:N
            dev = torch.device("cuda", torch.cuda.current_device())
    set_fp32_numerics()
    return dev
