"""Orthonormalization above 128 columns: blocked BCGS2 over panels of 32
(port of ``qml_cutensornet_tpu/ops/blocked_qr.py``: ``qr_orth_blocked``,
``_mgs2_panel``), and kernel K8, the scanned panel step.

Kernel K3 (``ops/orth.py``) takes at most 128 columns; wider inputs (the
split's ``[B, 2chi, nc]`` iterates and the center move's ``[B, 2chi, chi]``
above chi 128) are orthonormalized panel by panel:

- each panel of ``PANEL`` = 32 columns is projected twice (classical
  Gram-Schmidt, CGS2) against all finished columns, as batched matrix
  products at the caller's ``precision`` (the ambient class: the reference
  leaves these to XLA; ``ops/lowp.matmul``, ``torch.matmul`` at full
  precision);
- the panel itself is orthonormalized by one of the reference's two panel
  steps, chosen as the reference chooses (``kernel_panels``, the caller's
  ``SimConfig.fused_split``; the reference's kernel is f32 only):

  - with ``kernel_panels`` in complex64, kernel K3 on CUDA tensors and K3's
    plain version on CPU tensors (:func:`ops.orth.orth`). A column that
    collapsed against the EARLIER panels (squared norm after projection not
    above ``orth.dep_tol2`` times its squared norm before: the reference's
    ``_DEP_TOL**2`` = 1e-10) is zeroed before the kernel: it is a noise
    residual, and if the kernel normalized it the panel's later columns would
    be orthogonalized against junk. Inside the panel the kernel judges
    collapse against the column's norm after that projection;
  - otherwise (``kernel_panels`` off, or complex128) the scanned MGS2 panel
    step :func:`mgs2_panel`, which judges every column's collapse against
    its norm BEFORE the projection against earlier panels: kernel K8
    (``csrc/mgs2_panel.cu``) on CUDA tensors and its plain version on CPU
    tensors at a full class; at a reduced ambient class in complex64 a chain
    of single-column products on K7 (:func:`mgs2_panel_lowp`), as the
    reference's scan sends its dots to the class.

Every step cuts at ``orth.dep_tol2``: the reference scan's 1e-10 in
complex64, and 1e-24 in complex128 as K2 and K3 cut. The reference never
runs the scan in f64 (its blocked route takes f32 only,
``cpx._blocked_orth_eligible``): it orthonormalizes f64 input of any width
by Householder QR with no cutoff, and 1e-10 here would drop directions
whose singular-value ratio lies between about 1e-5 and f64's floor of
1e-10 in the truncation mask, which the reference keeps.

``pair`` (``SimConfig.mgs_pair``) reaches the K3 panels only; the scanned
panel step ignores it, as the reference's ``_mgs2_panel`` does.

Zero input columns stay exactly zero; dependent columns come out as exact
zeros. The basis is defined up to a unitary mixing within the span.
"""

from __future__ import annotations

import dataclasses

import torch

from qml_cutensornet_tpu_torch.ops import _block, _build, lowp, orth

PANEL = 32  # complex columns per panel


def kernel_panels_used(kernel_panels: bool, dtype: torch.dtype) -> bool:
    """Whether :func:`qr_orth_blocked` runs K3 on its panels."""
    return kernel_panels and dtype == torch.complex64


def _scan(a: torch.Tensor, n2_orig: torch.Tensor, project) -> torch.Tensor:
    """The scan over the columns of ``a [B, m, P]``: each column projected
    twice by ``project(q_prefix, x)`` against the panel's finished prefix,
    then scaled to unit norm or zeroed (not above ``orth.dep_tol2`` times
    ``n2_orig [B, P]``)."""
    tol = orth.dep_tol2(a.dtype)
    q = torch.zeros_like(a)
    for t in range(a.shape[2]):
        x = a[:, :, t]
        if t:
            qp = q[:, :, :t]
            for _ in range(2):
                x = project(qp, x)
        q[:, :, t] = orth._finish_column(x, n2_orig[:, t], tol)
    return q


def mgs2_panel_plain(a: torch.Tensor, n2_orig: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: the reference's scanned panel step on one panel
    ``a [B, m, P]``, its products the elementwise sums they are in the
    kernel."""
    if a.is_cuda:
        _build.PLAIN_ON_CUDA["mgs2_panel"] += 1

    def project(qp, x):
        c = (qp.conj() * x[:, :, None]).sum(1)  # [B, t]
        return x - (qp * c[:, None, :]).sum(2)

    return _scan(a, n2_orig, project)


def mgs2_panel_lowp(a: torch.Tensor, n2_orig: torch.Tensor, precision: str) -> torch.Tensor:
    """The scanned panel step at a reduced ambient class in complex64: each
    projection a pair of single-column products on K7 at ``precision``
    (``ops/lowp.matmul``), as the reference sends its scan's dots to the
    class. Not K8's plain version: K8 runs at a full class only."""
    def project(qp, x):
        c = lowp.matmul(qp, x[:, :, None], precision, "h")
        return x - lowp.matmul(qp, c, precision)[:, :, 0]

    return _scan(a, n2_orig, project)


def mgs2_panel(a: torch.Tensor, n2_orig: torch.Tensor, precision: str = "highest"
               ) -> torch.Tensor:
    """The reference's scanned panel step on ``a [B, m, P]`` (P <= 32) with
    its columns' squared norms before any projection ``n2_orig [B, P]``: at
    a reduced class in complex64 :func:`mgs2_panel_lowp`; else kernel K8 for
    CUDA tensors and its plain version for CPU tensors."""
    if lowp.reduced_passes(precision, a.dtype):
        return mgs2_panel_lowp(a, n2_orig, precision)
    if a.device.type == "cpu":
        return mgs2_panel_plain(a, n2_orig)
    return mgs2_panel_cuda(a, n2_orig)


MGS2_WARPS = 8  # K8's block: 8 warps, the group of every round
MGS2_THREADS = 32 * MGS2_WARPS
MGS2_EPL = (1, 2, 4, 8)  # elements a lane of the register and split plans
MGS2_PANEL_REGS = 128  # 32-bit registers a thread gives the panel's columns
# The global-scratch split plan is built for these elements a lane only:
# where shared memory cannot hold the columns past the registers' on an
# H100 (``csrc/mgs2_panel.cu`` ``pick``).
SPLIT_GLOBAL_EPL = {torch.complex64: (8,), torch.complex128: (4, 8)}
MGS2_KINDS = ("registers", "split_smem", "split_global", "memory")


@dataclasses.dataclass(frozen=True)
class Mgs2Plan:
    """How K8 is launched (``csrc/mgs2_panel.cu``): one block of
    ``MGS2_THREADS`` threads per batch element, ``epl`` elements a lane
    (the vector ``MGS2_THREADS * epl`` long, zero past m). ``kind``:
    "registers", the whole panel in registers, loaded and stored through
    ``smem_bytes`` of dynamic shared memory (P staged columns); "split_smem"
    and "split_global", its first ``reg_cols`` columns in registers and the
    rest in shared memory (``smem_bytes``, through which the register
    columns are also staged) or in a per-element global scratch buffer of
    ``scratch_cx`` complex elements; "memory" (m past ``8 *
    MGS2_THREADS``), the whole panel in global scratch (``epl`` and
    ``reg_cols`` 0). A column in shared memory is ``MGS2_THREADS * epl + 1``
    elements long."""

    kind: str
    epl: int
    reg_cols: int
    smem_bytes: int
    scratch_cx: int

    @property
    def code(self) -> int:
        """The plan's kind as the C side numbers it."""
        return MGS2_KINDS.index(self.kind)


def mgs2_reg_cols(dtype: torch.dtype, epl: int) -> int:
    """Columns K8 holds in registers at ``epl`` elements a lane: as many as
    ``MGS2_PANEL_REGS`` registers a thread take, at most ``PANEL``."""
    return min(PANEL, MGS2_PANEL_REGS // (epl * _block.cx_bytes(dtype) // 4))


def mgs2_static_bytes(dtype: torch.dtype) -> int:
    """K8's static shared memory: the rounds' two buffers of 8 warps x 96
    values (three sets of 32), each warp's copy of a round's 96 sums and
    the panel's ``PANEL`` norms before projection."""
    return (3 * MGS2_WARPS * 96 + PANEL) * (_block.cx_bytes(dtype) // 2)


def mgs2_plan(m: int, p: int, dtype: torch.dtype, smem_optin: int) -> Mgs2Plan:
    """K8's launch plan, a pure function of the panel's shape, the dtype and
    the shared memory a block may opt in to: the fewest elements a lane
    that cover m; the whole panel in registers where its columns fit their
    ``MGS2_PANEL_REGS`` (staged through shared memory); else the columns
    past them in shared memory where they fit beside the static slots,
    else in global scratch; past m ``8 * MGS2_THREADS`` the whole panel in
    global scratch."""
    epl = next((e for e in MGS2_EPL if m <= e * MGS2_THREADS), None)
    if epl is None:
        return Mgs2Plan("memory", 0, 0, 0, p * m)
    r = mgs2_reg_cols(dtype, epl)
    column = (MGS2_THREADS * epl + 1) * _block.cx_bytes(dtype)  # a staged column
    if p <= r:
        return Mgs2Plan("registers", epl, r, p * column, 0)
    if (p - r) * column + mgs2_static_bytes(dtype) <= smem_optin:
        return Mgs2Plan("split_smem", epl, r, (p - r) * column, 0)
    if epl in SPLIT_GLOBAL_EPL[dtype]:
        return Mgs2Plan("split_global", epl, r, 0, (p - r) * MGS2_THREADS * epl)
    return Mgs2Plan("memory", 0, 0, 0, p * m)


def mgs2_panel_cuda(a: torch.Tensor, n2_orig: torch.Tensor,
                    smem_bytes: int | None = None, plan: Mgs2Plan | None = None
                    ) -> torch.Tensor:
    """Launch K8 on the panel ``a [B, m, P]`` (P <= 32, contiguous) with
    ``n2_orig [B, P]`` (contiguous, of ``a``'s real dtype) and the cutoff
    ``orth.dep_tol2`` as :func:`mgs2_plan` says. ``plan`` and ``smem_bytes``
    override the plan and its dynamic shared memory request (used only to
    test the launch-error paths)."""
    if a.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"mgs2_panel: expected complex64 or complex128, got {a.dtype}")
    if a.dim() != 3 or not a.is_contiguous():
        raise ValueError(f"mgs2_panel: expected a contiguous [B, m, P] tensor, got shape "
                         f"{tuple(a.shape)}, strides {a.stride()}")
    B, m, p = a.shape
    if not (1 <= p <= PANEL and m >= 1 and B >= 1):
        raise ValueError(f"mgs2_panel: kernel takes 1 <= P <= {PANEL}; got m={m}, P={p}")
    if (n2_orig.device != a.device or n2_orig.dtype != a.real.dtype
            or tuple(n2_orig.shape) != (B, p) or not n2_orig.is_contiguous()):
        raise ValueError(f"mgs2_panel: n2_orig must be a contiguous [{B}, {p}] "
                         f"{a.real.dtype} tensor on {a.device}")
    if a.device.type != "cuda":
        raise ValueError(f"mgs2_panel: expected a CUDA tensor, got device {a.device}")
    dbl = a.dtype == torch.complex128
    lib = _build.load()
    if plan is None:
        plan = mgs2_plan(m, p, a.dtype, _build.smem_optin(a.device.index))
    q = torch.empty_like(a)
    scratch = torch.empty((B, plan.scratch_cx), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.qk_mgs2_launch(a.data_ptr(), n2_orig.data_ptr(), q.data_ptr(), scratch.data_ptr(),
                            B, m, p, int(dbl), orth.dep_tol2(a.dtype), plan.code, plan.epl,
                            plan.reg_cols,
                            plan.smem_bytes if smem_bytes is None else smem_bytes, stream)
    _build.check(rc, "mgs2_panel kernel launch")
    _build.count_launch("mgs2_panel", False)
    return q


def qr_orth_blocked(v: torch.Tensor, kernel_panels: bool, pair: bool = False,
                    precision: str = "highest") -> torch.Tensor:
    """Orthonormal basis of the columns of ``v [B, m, k]`` (complex), any
    k; ``kernel_panels``, ``pair`` and ``precision`` as in the module
    docstring."""
    k = v.shape[2]
    tol = orth.dep_tol2(v.dtype)
    use_kernel = kernel_panels_used(kernel_panels, v.dtype)
    q = torch.zeros_like(v)
    for p0 in range(0, k, PANEL):
        a = v[:, :, p0:p0 + PANEL]
        n2_orig = orth.abs2(a).sum(1)
        if p0:
            done = q[:, :, :p0]
            for _ in range(2):
                a = a - lowp.matmul(done, lowp.matmul(done, a, precision, "h"), precision)
        if use_kernel:
            cross_keep = orth.abs2(a).sum(1) > tol * n2_orig
            a = a * cross_keep[:, None, :].to(a.real.dtype)
            q[:, :, p0:p0 + PANEL] = orth.orth(a.contiguous(), pair)
        else:
            q[:, :, p0:p0 + PANEL] = mgs2_panel(a.contiguous(), n2_orig, precision)
    return q
