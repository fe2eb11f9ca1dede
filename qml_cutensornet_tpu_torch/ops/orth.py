"""Kernel K2, the fused Q+R orthonormalizer, and its plain PyTorch version.

Port of ``qml_cutensornet_tpu/ops/pallas_qr.py`` (``orth_rows_body`` and
``_make_orth_r_kernel``). :func:`qr` returns, for each ``v[b] [m, k]``, an
orthonormal basis ``q`` of its columns by blocked classical Gram-Schmidt
with reorthogonalization (BCGS2: panels of 16 columns, two CGS passes
against finished columns, then MGS2 within the panel) and ``r = q^H v``
(``[k, k]``, not triangular; ``q @ r == v`` to roundoff). Columns whose
residual norm^2 falls to ``DEP_TOL2`` times their original norm^2 or below
are numerically dependent and come out as exact zeros; exact-zero columns
and rows of ``v`` stay exactly zero. The basis is defined only up to a
unitary mixing within the span, so callers use basis-invariant quantities.

Routing: a CPU tensor runs :func:`orth_r_plain`; a CUDA tensor runs the
CUDA kernel (``csrc/orth_r.cu`` + ``csrc/bcgs2.cuh``) or raises. The kernel
takes k <= 128 (a partial last panel is fine) and m <= 256, in complex64
(complex128 runs the double instantiation of the same kernel).
"""

from __future__ import annotations

import torch

from qml_cutensornet_tpu_torch.ops import _build
from qml_cutensornet_tpu_torch.utils import device as _device  # noqa: F401  (full-f32 matmuls)

PANEL = 16
DEP_TOL2 = 1e-10  # dependent-column cutoff on residual / original norm^2
TINY = 1e-30  # norm^2 floor: exact-zero columns normalize to exact zero
MAX_K = 128
MAX_M = 256


def orth_plain(v: torch.Tensor) -> torch.Tensor:
    """BCGS2 orthonormal basis of the columns of ``v [B, m, k]`` (complex),
    written with torch ops: the same algorithm and constants as the kernel."""
    B, m, k = v.shape
    q = torch.zeros_like(v)
    for p0 in range(0, k, PANEL):
        pw = min(PANEL, k - p0)
        a = v[:, :, p0:p0 + pw]
        n2_orig = (a.real * a.real + a.imag * a.imag).sum(1)  # [B, pw]
        if p0:
            done = q[:, :, :p0]
            for _ in range(2):
                a = a - done @ (done.mH @ a)
        for t in range(pw):
            x = a[:, :, t]
            if t:
                qp = q[:, :, p0:p0 + t]
                for _ in range(2):
                    c = (qp.conj() * x[:, :, None]).sum(1)  # [B, t]
                    x = x - (qp * c[:, None, :]).sum(2)
            n2 = (x.real * x.real + x.imag * x.imag).sum(1)
            keep = (n2 > DEP_TOL2 * n2_orig[:, t]).to(n2.dtype)
            inv = torch.rsqrt(n2 + TINY) * keep
            q[:, :, p0 + t] = x * inv[:, None]
    return q


def orth_r_plain(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: ``(q, q^H v)``."""
    if v.is_cuda:
        _build.PLAIN_ON_CUDA["orth_r"] += 1
    q = orth_plain(v)
    return q, q.mH @ v


def qr(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused orthonormalization ``v [B, m, k] -> (q [B, m, k], r [B, k, k])``:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    if v.device.type == "cpu":
        return orth_r_plain(v)
    return orth_r_cuda(v)


def _check_input(v: torch.Tensor, name: str) -> bool:
    if v.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got device {v.device}")
    if v.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"{name}: expected complex64 or complex128, got {v.dtype}")
    if not v.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return v.dtype == torch.complex128


def orth_r_cuda(v: torch.Tensor, smem_bytes: int | None = None):
    """Launch K2 on ``v [B, m, k]``. ``smem_bytes`` overrides the dynamic
    shared memory request (used only to test the launch-error path)."""
    dbl = _check_input(v, "orth_r")
    if v.dim() != 3:
        raise ValueError(f"orth_r: expected [B, m, k], got {tuple(v.shape)}")
    B, m, k = v.shape
    if not (1 <= k <= MAX_K and 1 <= m <= MAX_M and B >= 1):
        raise ValueError(f"orth_r: kernel takes k <= {MAX_K}, m <= {MAX_M}; got m={m}, k={k}")
    lib = _build.load()
    in_smem = lib.qk_orth_r_smem(m, k, int(dbl), 1) <= _build.smem_optin(v.device.index)
    if smem_bytes is None:
        smem_bytes = lib.qk_orth_r_smem(m, k, int(dbl), int(in_smem))
    q = torch.empty_like(v)
    r = torch.empty((B, k, k), dtype=v.dtype, device=v.device)
    scratch = (torch.empty(0, dtype=v.dtype, device=v.device) if in_smem
               else torch.empty((B, k, m + 1), dtype=v.dtype, device=v.device))
    stream = torch.cuda.current_stream(v.device).cuda_stream
    rc = lib.qk_orth_r_launch(v.data_ptr(), q.data_ptr(), r.data_ptr(), scratch.data_ptr(),
                              B, m, k, int(dbl), int(in_smem), smem_bytes, stream)
    _build.check(rc, "orth_r kernel launch")
    _build.LAUNCHES["orth_r"] += 1
    return q, r
