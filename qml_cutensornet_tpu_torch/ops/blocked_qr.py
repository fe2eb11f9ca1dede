"""Orthonormalization above 128 columns: blocked BCGS2 over panels of 32
(port of ``qml_cutensornet_tpu/ops/blocked_qr.py``: ``qr_orth_blocked``,
``_mgs2_panel``).

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
    step :func:`mgs2_panel`, in torch ops, which judges every column's
    collapse against its norm BEFORE the projection against earlier panels;
    its projections are single-column products at ``precision``, as the
    reference's scan leaves them to XLA.

``pair`` (``SimConfig.mgs_pair``) reaches the K3 panels only; the scanned
panel step ignores it, as the reference's ``_mgs2_panel`` does.

Zero input columns stay exactly zero; dependent columns come out as exact
zeros. The basis is defined up to a unitary mixing within the span.
"""

from __future__ import annotations

import torch

from qml_cutensornet_tpu_torch.ops import lowp, orth

PANEL = 32  # complex columns per panel


def kernel_panels_used(kernel_panels: bool, dtype: torch.dtype) -> bool:
    """Whether :func:`qr_orth_blocked` runs K3 on its panels."""
    return kernel_panels and dtype == torch.complex64


def mgs2_panel(a: torch.Tensor, n2_orig: torch.Tensor, precision: str = "highest"
               ) -> torch.Tensor:
    """The reference's scanned panel step: orthonormalize the columns of one
    panel ``a [B, m, P]`` one at a time by MGS2 (two passes against the
    panel's finished prefix, each a pair of single-column products at
    ``precision``), zeroing a column whose residual squared norm is not above
    ``orth.dep_tol2`` times ``n2_orig [B, P]``, its squared norm before any
    projection. At a full class the products stay the elementwise sums they
    were, so that the f64 runs this step serves keep their numerics."""
    tol = orth.dep_tol2(a.dtype)
    reduced = lowp.reduced_passes(precision, a.dtype)
    q = torch.zeros_like(a)
    for t in range(a.shape[2]):
        x = a[:, :, t]
        if t:
            qp = q[:, :, :t]
            for _ in range(2):
                if reduced:
                    c = lowp.matmul(qp, x[:, :, None], precision, "h")
                    x = x - lowp.matmul(qp, c, precision)[:, :, 0]
                else:
                    c = (qp.conj() * x[:, :, None]).sum(1)  # [B, t]
                    x = x - (qp * c[:, None, :]).sum(2)
        n2 = orth.abs2(x).sum(1)
        keep = (n2 > tol * n2_orig[:, t]).to(n2.dtype)
        q[:, :, t] = x * (torch.rsqrt(n2 + orth.TINY) * keep)[:, None]
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
            q[:, :, p0:p0 + PANEL] = mgs2_panel(a, n2_orig, precision)
    return q
