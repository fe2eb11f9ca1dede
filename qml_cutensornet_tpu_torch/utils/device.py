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

import contextlib
import os
import subprocess

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


def nvidia_smi() -> str:
    """Name and power limit of the first card as ``nvidia-smi`` reports them
    (a card set below its maximum power runs slower under load, so every
    measurement is printed beside this line)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def environ(**knobs: str):
    """Set environment knobs (``QMLTPU_*``) for one run and restore them
    after it."""
    old = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


set_full_f32()
