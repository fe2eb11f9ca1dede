"""Kernel K1, the fused subspace split, and its plain PyTorch version.

Port of ``qml_cutensornet_tpu/ops/pallas_split.py`` (``_make_split_kernel``
/ ``_split_chain``). For each ``theta[b] [m, k]`` and the shared start
block ``v0 [m, nc]``, :func:`subspace_factor` runs ``iters`` power
iterations in the inter-orthonormalized double-multiply form

    w = orth(theta^H v)      v = orth(theta w)      (v = v0 at first)

and returns ``q = v [B, m, nc]`` (a masked isometry approximating the top
left singular subspace; zero columns exactly zero) and ``r = q^H theta
[B, nc, k]``. ``orth`` is the BCGS2 orthonormalizer of ``ops/orth.py``.

Routing: a CPU tensor runs :func:`subspace_factor_plain`; a CUDA tensor runs
the CUDA kernel (``csrc/subspace_split.cu``) or raises. The kernel takes
nc <= 128, m, k <= 256, iters >= 1, in complex64 (complex128 runs the
double instantiation).
"""

from __future__ import annotations

import torch

from qml_cutensornet_tpu_torch.ops import _build
from qml_cutensornet_tpu_torch.ops.orth import _check_input, orth_plain

MAX_NC = 128
MAX_MK = 256


def subspace_factor_plain(theta: torch.Tensor, v0: torch.Tensor, iters: int):
    """Plain version of K1: the double-multiply chain with the plain BCGS2."""
    if theta.is_cuda:
        _build.PLAIN_ON_CUDA["split"] += 1
    v = v0.expand(theta.shape[0], *v0.shape)
    for _ in range(iters):
        w = orth_plain(theta.mH @ v)
        v = orth_plain(theta @ w)
    return v, v.mH @ theta


def subspace_factor(theta: torch.Tensor, v0: torch.Tensor, iters: int):
    """``theta [B, m, k]``, ``v0 [m, nc]`` -> ``(q [B, m, nc], r [B, nc, k])``:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    if theta.device.type == "cpu":
        return subspace_factor_plain(theta, v0, iters)
    return subspace_factor_cuda(theta, v0, iters)


def subspace_factor_cuda(theta: torch.Tensor, v0: torch.Tensor, iters: int):
    """Launch K1."""
    dbl = _check_input(theta, "split")
    _check_input(v0, "split v0")
    if theta.dim() != 3 or v0.dim() != 2 or v0.shape[0] != theta.shape[1]:
        raise ValueError(f"split: expected theta [B, m, k] and v0 [m, nc]; got "
                         f"{tuple(theta.shape)} and {tuple(v0.shape)}")
    if v0.dtype != theta.dtype or v0.device != theta.device:
        raise ValueError("split: theta and v0 must share dtype and device")
    B, m, k = theta.shape
    nc = v0.shape[1]
    if not (1 <= nc <= MAX_NC and 1 <= m <= MAX_MK and 1 <= k <= MAX_MK and iters >= 1):
        raise ValueError(f"split: kernel takes nc <= {MAX_NC}, m, k <= {MAX_MK}, iters >= 1;"
                         f" got m={m}, k={k}, nc={nc}, iters={iters}")
    lib = _build.load()
    in_smem = lib.qk_split_smem(m, k, nc, int(dbl), 1) <= _build.smem_optin(theta.device.index)
    smem_bytes = lib.qk_split_smem(m, k, nc, int(dbl), int(in_smem))
    q = torch.empty((B, m, nc), dtype=theta.dtype, device=theta.device)
    r = torch.empty((B, nc, k), dtype=theta.dtype, device=theta.device)
    scratch = (torch.empty(0, dtype=theta.dtype, device=theta.device) if in_smem
               else torch.empty((B, nc, m + k + 2), dtype=theta.dtype, device=theta.device))
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    rc = lib.qk_split_launch(theta.data_ptr(), v0.data_ptr(), q.data_ptr(), r.data_ptr(),
                             scratch.data_ptr(), B, m, k, nc, int(iters), int(dbl),
                             int(in_smem), smem_bytes, stream)
    _build.check(rc, "split kernel launch")
    _build.LAUNCHES["split"] += 1
    return q, r
