"""Kernels K2 (fused Q+R) and K3 (basis only), the BCGS2 orthonormalizers,
and their plain PyTorch versions.

Port of ``qml_cutensornet_tpu/ops/pallas_qr.py`` (``orth_rows_body``,
``_make_orth_r_kernel``, ``_make_orth_kernel``) and of the routing of
``ops/cpx.py`` (``qr``, ``qr_orth``). For each ``v[b] [m, k]`` the basis
``q`` of its columns comes from blocked classical Gram-Schmidt with
reorthogonalization (BCGS2: panels of 16 columns, two CGS passes against
finished columns, then MGS2 within the panel); ``r = q^H v`` (``[k, k]``,
not triangular; ``q @ r == v`` to roundoff). Columns whose residual norm^2
falls to ``dep_tol2(dtype)`` times their original norm^2 or below are
numerically dependent and come out as exact zeros (the reference's 1e-10 in
complex64; 1e-24 in complex128, where the reference runs Householder QR with
no cutoff, so that the cutoff stays below f64's singular-value-ratio floor
of 1e-10 in the truncation mask); exact-zero columns and rows of ``v``
stay exactly zero. The basis is defined only up to a unitary mixing within
the span, so callers use basis-invariant quantities.

Routing: a CPU tensor runs the plain version; a CUDA tensor runs the CUDA
kernel or raises.

- :func:`qr` ``(v, fused)``: up to 128 columns, ``fused`` runs K2
  (``csrc/orth_r.cu``: q and r in one launch; m <= 256; launched as
  :func:`orth_r_plan` says), otherwise K3 and
  ``r = q^H v`` as a batched matrix product; above 128 columns the blocked
  route (``ops/blocked_qr.py``: K3 on each panel with ``fused`` in
  complex64, the scanned MGS2 panel step otherwise) and the same product.
- :func:`qr_orth` ``(v, fused)``: K3 (``csrc/orth.cu``: k <= 128, any m;
  launched as :func:`orth_plan` says) up to 128 columns, the blocked route
  above.

Both kernels run complex64 and, through the double instantiation of the
same code, complex128. A partial last panel is fine.

``pair`` (``SimConfig.mgs_pair``, the reference's ``pair=True``) selects the
block-2 in-panel variant: each pair of a panel's columns is projected twice
against the panel's finished prefix together, then the second column twice
against the first (the last column of an odd-width panel alone). Same span,
same exact zeros and dependent-column zeroing; only the f32 summation order
differs. The kernels run it from their pair libraries (``ops/_build.py``)
in complex64; in complex128 the flag changes nothing, as in the reference,
whose f64 path never reaches a kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from qml_cutensornet_tpu_torch.ops import _block, _build, lowp
from qml_cutensornet_tpu_torch.utils import device as _device  # noqa: F401  (full-f32 matmuls)

PANEL = 16
DEP_TOL2 = 1e-10  # dependent-column cutoff on residual / original norm^2 (complex64)
DEP_TOL2_F64 = 1e-24  # the same in complex128
TINY = 1e-30  # norm^2 floor: exact-zero columns normalize to exact zero
MAX_K = 128
MAX_M = 256


def abs2(x: torch.Tensor) -> torch.Tensor:
    """``|x|^2`` elementwise, real."""
    return x.real * x.real + x.imag * x.imag


def dep_tol2(dtype: torch.dtype) -> float:
    """The dependent-column cutoff on squared norms for ``dtype``."""
    return DEP_TOL2_F64 if dtype == torch.complex128 else DEP_TOL2


def _finish_column(x: torch.Tensor, n2_orig: torch.Tensor, tol: float) -> torch.Tensor:
    """``x [B, m]`` scaled to unit norm, or exact zeros where its squared
    norm is not above ``tol`` times ``n2_orig [B]``."""
    n2 = abs2(x).sum(1)
    keep = (n2 > tol * n2_orig).to(n2.dtype)
    return x * (torch.rsqrt(n2 + TINY) * keep)[:, None]


def bcgs2_plain(v: torch.Tensor, pair: bool = False) -> torch.Tensor:
    """BCGS2 orthonormal basis of the columns of ``v [B, m, k]`` (complex),
    written with torch ops: the same algorithm and constants as the kernels,
    the in-panel step one column at a time or, with ``pair`` in complex64,
    two (the reference's block-2 branch, ``pallas_qr.orth_rows_body``).
    Shared by the plain versions of all five kernels (each of which counts
    its own use on CUDA tensors)."""
    B, m, k = v.shape
    tol = dep_tol2(v.dtype)
    q = torch.zeros_like(v)
    for p0 in range(0, k, PANEL):
        pw = min(PANEL, k - p0)
        a = v[:, :, p0:p0 + pw]
        n2_orig = abs2(a).sum(1)  # [B, pw]
        if p0:
            done = q[:, :, :p0]
            for _ in range(2):
                a = a - done @ (done.mH @ a)
        if _block.pair_step(pair, v.dtype):
            for t in range(0, pw, 2):
                x = a[:, :, t:t + 2]  # the pair (one column at an odd panel's end)
                if t:
                    qp = q[:, :, p0:p0 + t]
                    for _ in range(2):
                        x = x - qp @ (qp.mH @ x)
                q0 = _finish_column(x[:, :, 0], n2_orig[:, t], tol)
                q[:, :, p0 + t] = q0
                if t + 1 < pw:
                    x1 = x[:, :, 1]
                    for _ in range(2):
                        x1 = x1 - q0 * (q0.conj() * x1).sum(1, keepdim=True)
                    q[:, :, p0 + t + 1] = _finish_column(x1, n2_orig[:, t + 1], tol)
            continue
        for t in range(pw):
            x = a[:, :, t]
            if t:
                qp = q[:, :, p0:p0 + t]
                for _ in range(2):
                    c = (qp.conj() * x[:, :, None]).sum(1)  # [B, t]
                    x = x - (qp * c[:, None, :]).sum(2)
            q[:, :, p0 + t] = _finish_column(x, n2_orig[:, t], tol)
    return q


def orth_plain(v: torch.Tensor, pair: bool = False) -> torch.Tensor:
    """Plain version of K3: the BCGS2 basis."""
    if v.is_cuda:
        _build.PLAIN_ON_CUDA["orth"] += 1
    return bcgs2_plain(v, pair)


def orth_r_plain(v: torch.Tensor, pair: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: ``(q, q^H v)``."""
    if v.is_cuda:
        _build.PLAIN_ON_CUDA["orth_r"] += 1
    q = bcgs2_plain(v, pair)
    return q, q.mH @ v


def orth(v: torch.Tensor, pair: bool = False) -> torch.Tensor:
    """Orthonormal basis ``v [B, m, k] -> q [B, m, k]`` for k <= 128: kernel
    K3 for CUDA tensors, its plain version for CPU tensors."""
    if v.device.type == "cpu":
        return orth_plain(v, pair)
    return orth_cuda(v, pair)


def qr_orth(v: torch.Tensor, fused: bool, pair: bool = False,
            precision: str = "highest") -> torch.Tensor:
    """Orthonormal basis of the columns of ``v [B, m, k]`` at any k: K3 up
    to 128 columns, the blocked route above, whose panels go through K3 with
    ``fused`` in complex64 and through the scanned MGS2 step otherwise
    (``ops/blocked_qr.py``; the reference's ``cpx.qr_orth(v, fused, pair)``;
    ``pair`` reaches K3 only, as in the reference). K3 runs at full
    precision; the blocked route's products, which are XLA dots in the
    reference, at ``precision``."""
    if v.shape[-1] <= MAX_K:
        return orth(v.contiguous(), pair)
    from qml_cutensornet_tpu_torch.ops import blocked_qr

    return blocked_qr.qr_orth_blocked(v, kernel_panels=fused, pair=pair, precision=precision)


def reference_r_is_dot(m: int, k: int) -> bool:
    """Whether the reference forms ``r = q^H v`` of an unfused QR of an
    ``[m, k]`` f32 input by an XLA dot (``ops/cpx.py:245``, :253): where its
    Pallas basis kernel takes the shape (``pallas_qr.pallas_qr_supported``:
    k a multiple of 16 up to 128, m a multiple of 8 from 32) and on the
    blocked route above 128 columns. Elsewhere (the chi-8 stage) it factors
    by Householder QR, whose r is no dot."""
    return k > MAX_K or (k % PANEL == 0 and m % 8 == 0 and m >= 32)


def qr(v: torch.Tensor, fused: bool, pair: bool = False,
       precision: str = "highest") -> tuple[torch.Tensor, torch.Tensor]:
    """``v [B, m, k] -> (q [B, m, k], r [B, k, k])`` with ``q r == v``. Up to
    128 columns with ``fused``: K2, one launch for both (its plain version
    for CPU tensors), at full precision. Otherwise the basis from
    :func:`qr_orth` (``fused``, ``pair`` and ``precision`` passed on) and
    ``r = q^H v`` as a batched matrix product, at ``precision`` where the
    reference's r is a dot (:func:`reference_r_is_dot`; ``ops/lowp.matmul``)
    and at full precision where it is not."""
    if fused and v.shape[-1] <= MAX_K:
        if v.device.type == "cpu":
            return orth_r_plain(v, pair)
        return orth_r_cuda(v, pair)
    q = qr_orth(v, fused, pair, precision)
    m, k = v.shape[-2], v.shape[-1]
    return q, lowp.matmul(q, v, precision if reference_r_is_dot(m, k) else "highest", "h")


def _check_input(v: torch.Tensor, name: str) -> bool:
    if v.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got device {v.device}")
    if v.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"{name}: expected complex64 or complex128, got {v.dtype}")
    if not v.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return v.dtype == torch.complex128


@dataclasses.dataclass(frozen=True)
class OrthRPlan:
    """How K2 is launched (``csrc/orth_r.cu``, ``OrthRPlan`` of
    ``csrc/block_chain.cuh``): ``grid`` blocks of ``threads``, one block per
    batch element; the vectors Q in shared memory (``rows_smem``) or in a
    per-element global scratch buffer of ``scratch_cx`` complex elements; a
    copy of v in shared memory for ``r = Q^H v`` (``v_smem``) or v read from
    global memory; ``smem_bytes`` of dynamic shared memory per block."""

    threads: int
    grid: int
    rows_smem: bool
    v_smem: bool
    smem_bytes: int
    scratch_cx: int


def orth_r_plan(B: int, m: int, k: int, dtype: torch.dtype, smem_optin: int,
                pair: bool = False) -> OrthRPlan:
    """K2's launch plan, a pure function of the shapes, the dtype, the
    in-panel step (``pair``: its static slots are twice as large) and the
    shared memory a block may opt in to: the first of (Q and v in shared
    memory; Q only; neither) that fits."""
    cx = _block.cx_bytes(dtype)
    work = _block.orth_work_bytes(k, dtype)
    static = _block.static_smem_bytes(dtype, pair)
    rows, vcopy = k * (m + 1) * cx, m * k * cx
    for in_smem, v_smem, nbytes in ((True, True, rows + vcopy), (True, False, rows),
                                    (False, False, 0)):
        if nbytes + work + static <= smem_optin:
            return OrthRPlan(_block.NT, B, in_smem, v_smem, nbytes + work,
                             0 if in_smem else k * (m + 1))
    raise ValueError(f"orth_r: no launch plan fits {smem_optin} bytes of shared memory "
                     f"(m={m}, k={k}, {dtype})")


def orth_r_cuda(v: torch.Tensor, pair: bool = False, smem_bytes: int | None = None):
    """Launch K2 on ``v [B, m, k]``, from the pair library with ``pair`` in
    complex64. ``smem_bytes`` overrides the plan's dynamic shared memory
    request (used only to test the launch-error path)."""
    dbl = _check_input(v, "orth_r")
    if v.dim() != 3:
        raise ValueError(f"orth_r: expected [B, m, k], got {tuple(v.shape)}")
    B, m, k = v.shape
    if not (1 <= k <= MAX_K and 1 <= m <= MAX_M and B >= 1):
        raise ValueError(f"orth_r: kernel takes k <= {MAX_K}, m <= {MAX_M}; got m={m}, k={k}")
    pair = _block.pair_step(pair, v.dtype)
    lib = _build.load(pair)
    plan = orth_r_plan(B, m, k, v.dtype, _build.smem_optin(v.device.index), pair)
    q = torch.empty_like(v)
    r = torch.empty((B, k, k), dtype=v.dtype, device=v.device)
    scratch = torch.empty((B, plan.scratch_cx), dtype=v.dtype, device=v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    rc = lib.qk_orth_r_launch(v.data_ptr(), q.data_ptr(), r.data_ptr(), scratch.data_ptr(),
                              B, m, k, int(dbl), int(plan.rows_smem),
                              plan.smem_bytes if smem_bytes is None else smem_bytes, stream,
                              int(plan.v_smem))
    _build.check(rc, "orth_r kernel launch")
    _build.count_launch("orth_r", pair)
    return q, r


@dataclasses.dataclass(frozen=True)
class OrthPlan:
    """How K3 is launched (``csrc/orth.cu``): ``grid`` blocks of ``threads``,
    one block per batch element; the rows Q in shared memory (``rows_smem``)
    or in a per-element global scratch buffer of ``scratch_cx`` complex
    elements; the in-panel group, ``group_warps`` warps holding
    ``group_epl`` vector elements a lane in registers (``_block.EPL_MEM``:
    the whole block on the panel left in memory); ``smem_bytes`` of dynamic
    shared memory per block."""

    threads: int
    grid: int
    rows_smem: bool
    group_warps: int
    group_epl: int
    smem_bytes: int
    scratch_cx: int


def orth_plan(B: int, m: int, k: int, dtype: torch.dtype, smem_optin: int,
              pair: bool = False) -> OrthPlan:
    """K3's launch plan, a pure function of the shapes, the dtype, the
    in-panel step (``pair``) and the shared memory a block may opt in to:
    the in-panel group of the vector length (``_block.orth_group``), and the
    rows in shared memory where they fit beside the work and the group's
    static slots, else in global scratch."""
    warps, epl = _block.orth_group(m)
    work = _block.orth_work_bytes(k, dtype)
    static = _block.group_static_bytes(warps, dtype, pair)
    rows = k * (m + 1) * _block.cx_bytes(dtype)
    for in_smem, nbytes in ((True, rows), (False, 0)):
        if nbytes + work + static <= smem_optin:
            return OrthPlan(_block.NT, B, in_smem, warps, epl, nbytes + work,
                            0 if in_smem else k * (m + 1))
    raise ValueError(f"orth: no launch plan fits {smem_optin} bytes of shared memory "
                     f"(m={m}, k={k}, {dtype})")


def orth_cuda(v: torch.Tensor, pair: bool = False,
              smem_bytes: int | None = None) -> torch.Tensor:
    """Launch K3 on ``v [B, m, k]`` (k <= 128, any m) as :func:`orth_plan`
    says, from the pair library with ``pair`` in complex64. ``smem_bytes``
    overrides the plan's dynamic shared memory request (used only to test
    the launch-error path)."""
    dbl = _check_input(v, "orth")
    if v.dim() != 3:
        raise ValueError(f"orth: expected [B, m, k], got {tuple(v.shape)}")
    B, m, k = v.shape
    if not (1 <= k <= MAX_K and m >= 1 and B >= 1):
        raise ValueError(f"orth: kernel takes k <= {MAX_K}; got m={m}, k={k}")
    pair = _block.pair_step(pair, v.dtype)
    lib = _build.load(pair)
    plan = orth_plan(B, m, k, v.dtype, _build.smem_optin(v.device.index), pair)
    q = torch.empty_like(v)
    scratch = torch.empty((B, plan.scratch_cx), dtype=v.dtype, device=v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    rc = lib.qk_orth_launch(v.data_ptr(), q.data_ptr(), scratch.data_ptr(), B, m, k, int(dbl),
                            int(plan.rows_smem), plan.group_warps, plan.group_epl,
                            plan.smem_bytes if smem_bytes is None else smem_bytes, stream)
    _build.check(rc, "orth kernel launch")
    _build.count_launch("orth", pair)
    return q
