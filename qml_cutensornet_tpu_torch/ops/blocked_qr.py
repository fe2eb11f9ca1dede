"""Orthonormalization above 128 columns: blocked BCGS2 over panels of 32
(port of ``qml_cutensornet_tpu/ops/blocked_qr.py``: ``qr_orth_blocked``,
``_mgs2_panel``).

Kernel K3 (``ops/orth.py``) takes at most 128 columns; wider inputs (the
split's ``[B, 2chi, nc]`` iterates and the center move's ``[B, 2chi, chi]``
above chi 128) are orthonormalized panel by panel:

- each panel of ``PANEL`` = 32 columns is projected twice (classical
  Gram-Schmidt, CGS2) against all finished columns, as batched matrix
  products (``torch.matmul``, full f32; the reference leaves these to XLA);
- a column that collapsed against the EARLIER panels (squared norm after
  projection not above ``orth.dep_tol2`` times its squared norm before: the
  reference's ``_DEP_TOL**2`` = 1e-10 in complex64) is zeroed before the
  panel step: it is a noise residual, and if the panel step normalized it the
  panel's later columns would be orthogonalized against junk;
- the panel itself is orthonormalized by K3 on CUDA tensors and by K3's
  plain version on CPU tensors (:func:`ops.orth.orth`, whose within-panel
  dependent-column rule is the same cutoff).

Zero input columns stay exactly zero; dependent columns come out as exact
zeros. The basis is defined up to a unitary mixing within the span. The
reference's other panel step, a scan over the panel's columns for devices
without its kernel, has no use here: every device runs K3 or its plain
version.
"""

from __future__ import annotations

import torch

from qml_cutensornet_tpu_torch.ops import orth

PANEL = 32  # complex columns per panel


def qr_orth_blocked(v: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis of the columns of ``v [B, m, k]`` (complex), any
    k."""
    k = v.shape[2]
    tol = orth.dep_tol2(v.dtype)
    q = torch.zeros_like(v)
    for p0 in range(0, k, PANEL):
        a = v[:, :, p0:p0 + PANEL]
        n2_orig = orth.abs2(a).sum(1)
        if p0:
            done = q[:, :, :p0]
            for _ in range(2):
                a = a - done @ (done.mH @ a)
        cross_keep = orth.abs2(a).sum(1) > tol * n2_orig
        a = a * cross_keep[:, None, :].to(a.real.dtype)
        q[:, :, p0:p0 + PANEL] = orth.orth(a.contiguous())
    return q
