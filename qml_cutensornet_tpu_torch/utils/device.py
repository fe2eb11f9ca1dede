"""Device setup: the one place the port chooses a device and fixes the f32
matmul precision.

The reference pins every matmul at full f32 accumulation
(``SimConfig.matmul_precision="highest"``; ``precision=HIGHEST`` in every
Pallas dot) because reduced-precision passes break the 1e-6 kernel parity
budget. On Hopper the reduced mode is TF32, so it is switched off for both
cuBLAS and cuDNN. The flags are process-wide torch state; this module sets
them when it is imported, and every port module that runs a matmul imports
it.

There is no default device and no fallback: :func:`resolve_device` returns
exactly the device asked for, or raises.
"""

from __future__ import annotations

import torch


def set_full_f32() -> None:
    """Full f32 accumulation for every torch matmul (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def full_f32_is_set() -> bool:
    return (not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32
            and torch.get_float32_matmul_precision() == "highest")


def resolve_device(name: str) -> torch.device:
    """``torch.device(name)``, after checking that it exists. A CUDA device
    without a usable card raises; nothing moves to the CPU on its own."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() is "
                "False (set QMLTPU_DEVICE=cpu to run the plain CPU path)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    return dev


set_full_f32()
