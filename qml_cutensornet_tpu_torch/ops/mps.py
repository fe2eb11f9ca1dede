"""Batched Matrix Product State engine on complex tensors (port of
``qml_cutensornet_tpu/ops/mps.py``).

An :class:`MPS` holds a BATCH of padded states: ``tensors [B, n, chi, 2,
chi]`` (batch, site, left bond, physical, right bond), ``fidelity [B]``
(product of per-update kept fractions) and ``bond_dims [B, n-1]`` (true bond
dimensions; :func:`actual_nbytes` gives the unpadded bytes from them).
Truncated and padded entries are exact zeros, so contractions over the
padded dimensions equal the true ones. The op stream is the same for every
state of a batch, so sites and directions are Python ints.

The update functions write the changed site tensors into ``tensors`` and
``bond_dims`` IN PLACE (one full-state copy per op saved) and return an
``MPS`` sharing those tensors.

Every product here that is an XLA dot in the reference runs at the ambient
class, ``precision`` (``cfg.matmul_precision`` where a function takes the
config) through ``ops/lowp.matmul``: kernel K7 at a reduced class in
complex64, ``torch.matmul`` otherwise. The center move's ``q`` and ``r``
come from kernel K2 (or K3 and a product at the class, ``ops/orth.qr``),
the split from ``ops/svd``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import DIR_L
from qml_cutensornet_tpu_torch.ops import lowp, orth
from qml_cutensornet_tpu_torch.ops.svd import (
    gate_split_eligible,
    truncated_svd,
    truncated_svd_gate,
)


@dataclasses.dataclass
class MPS:
    tensors: torch.Tensor  # [B, n, chi, 2, chi] complex
    fidelity: torch.Tensor  # [B] real
    bond_dims: torch.Tensor  # [B, n-1] int32


def zero_state(batch: int, n: int, cfg: SimConfig, device: torch.device) -> MPS:
    """|0...0> for every state: each site tensor is e_0 ⊗ |0> ⊗ e_0."""
    if n < 2:
        raise ValueError("MPS needs at least 2 sites.")
    t = torch.zeros((batch, n, cfg.chi, 2, cfg.chi), dtype=cfg.complex_dtype, device=device)
    t[:, :, 0, 0, 0] = 1.0
    return MPS(
        tensors=t,
        fidelity=torch.ones(batch, dtype=cfg.real_dtype, device=device),
        bond_dims=torch.ones((batch, n - 1), dtype=torch.int32, device=device),
    )


def apply_1q_all(mps: MPS, u2: torch.Tensor, precision: str = "highest") -> MPS:
    """The same 1-qubit gate ``u2 [2, 2]`` on every site of every state, at
    ``precision``."""
    t = lowp.matmul(u2, mps.tensors, precision)
    return dataclasses.replace(mps, tensors=t)


def apply_diag_all(mps: MPS, phases: torch.Tensor) -> MPS:
    """Per-site diagonal 1-qubit gates given as ``phases [B, n, 2]``."""
    return dataclasses.replace(mps, tensors=mps.tensors * phases[:, :, None, :, None])


def apply_1q(mps: MPS, site: int, u2: torch.Tensor, precision: str = "highest") -> MPS:
    """1-qubit gates ``u2 [B, 2, 2]`` at ``site``, at ``precision``."""
    mps.tensors[:, site] = lowp.matmul(u2[:, None], mps.tensors[:, site], precision)
    return mps


def apply_2site(mps: MPS, site: int, u4: torch.Tensor, cfg: SimConfig,
                direction: int | None = None) -> MPS:
    """Two-qubit gates ``u4 [B, 4, 4]`` on sites ``(site, site+1)``: contract
    the pair into theta, apply the gate, split back with the truncated
    factorization. ``direction`` DIR_L (1) leaves the orthogonality center
    at ``site`` by factoring theta^T (plain transpose); otherwise it ends at
    ``site+1``.

    When :func:`gate_split_eligible` (``cfg.fused_gate``), theta is built and
    gate-applied inside kernel K4 and never formed here; the factors then
    come back with s-major rows and are reshaped on the write-back."""
    chi = mps.tensors.shape[2]
    B = mps.tensors.shape[0]
    a = mps.tensors[:, site]
    b = mps.tensors[:, site + 1]
    is_left = direction == DIR_L
    if gate_split_eligible(cfg, chi):
        left, right, kept_fraction, rank = truncated_svd_gate(a, b, u4, cfg, chi, is_left)
        if is_left:
            # theta^T factors: left [(t be), keep], right [keep, (s al)].
            new_a = right.reshape(B, chi, 2, chi).permute(0, 3, 2, 1)
            new_b = left.reshape(B, 2, chi, chi).permute(0, 3, 1, 2)
        else:
            # left [(s al), keep] -> new_a [al, s, keep]
            new_a = left.reshape(B, 2, chi, chi).transpose(1, 2)
            new_b = right.reshape(B, chi, 2, chi)
        return _write_pair(mps, site, new_a, new_b, kept_fraction, rank)
    p = cfg.matmul_precision
    theta = lowp.matmul(a.reshape(B, 2 * chi, chi), b.reshape(B, chi, 2 * chi), p)
    # the gate on the physical pair (s t) of theta [B, a, (s t), c]
    m = lowp.matmul(u4[:, None], theta.reshape(B, chi, 4, chi), p).reshape(B, 2 * chi, 2 * chi)
    if is_left:
        m = m.transpose(1, 2).contiguous()
    fl, fr, kept_fraction, rank = truncated_svd(m, cfg, keep=chi)
    if is_left:
        new_a, new_b = fr.transpose(1, 2), fl.transpose(1, 2)
    else:
        new_a, new_b = fl, fr
    return _write_pair(mps, site, new_a.reshape(B, chi, 2, chi), new_b.reshape(B, chi, 2, chi),
                       kept_fraction, rank)


def _write_pair(mps: MPS, site: int, new_a, new_b, kept_fraction, rank) -> MPS:
    mps.tensors[:, site] = new_a
    mps.tensors[:, site + 1] = new_b
    mps.bond_dims[:, site] = rank
    return MPS(mps.tensors, mps.fidelity * kept_fraction.to(mps.fidelity.dtype), mps.bond_dims)


def move_center(mps: MPS, site: int, direction: int, cfg: SimConfig) -> MPS:
    """Move the orthogonality center across bond ``(site, site+1)`` by
    ``orth.qr``: the fused Q+R (kernel K2) with ``cfg.fused_split`` up to chi
    128, else kernel K3 (the blocked route above chi 128, ``ops/blocked_qr``)
    and a matrix product for r; ``cfg.mgs_pair`` selects their block-2
    in-panel step. The products outside K2 run at ``cfg.matmul_precision``.
    Exact: no truncation. DIR_R (0)
    leaves the center at ``site+1``, DIR_L (1) at ``site``; a move toward
    where the center already sits is an exact no-op (chunk padding)."""
    chi = mps.tensors.shape[2]
    B = mps.tensors.shape[0]
    a = mps.tensors[:, site]
    b = mps.tensors[:, site + 1]
    p = cfg.matmul_precision
    if direction == DIR_L:
        th = b.reshape(B, chi, 2 * chi).mH.contiguous()  # t^H [2chi, chi]
        q, r = orth.qr(th, fused=cfg.fused_split, pair=cfg.mgs_pair, precision=p)  # t^H = q r
        new_b = q.mH.reshape(B, chi, 2, chi)  # row-orthonormal
        new_a = lowp.matmul(a.reshape(B, 2 * chi, chi), r, p, op_b="h").reshape(B, chi, 2, chi)
    else:
        q, r = orth.qr(a.reshape(B, 2 * chi, chi).contiguous(), fused=cfg.fused_split,
                       pair=cfg.mgs_pair, precision=p)
        new_a = q.reshape(B, chi, 2, chi)
        new_b = lowp.matmul(r, b.reshape(B, chi, 2 * chi), p).reshape(B, chi, 2, chi)
    mps.tensors[:, site] = new_a
    mps.tensors[:, site + 1] = new_b
    return mps


def vdot(a: MPS, b: MPS, precision: str = "highest") -> torch.Tensor:
    """<a_z|b_z> per batch element by transfer-matrix contraction, its
    products at ``precision``: ``[B]``."""
    ta, tb = a.tensors, b.tensors
    B, n, chi = ta.shape[0], ta.shape[1], ta.shape[2]
    m = torch.zeros((B, chi, chi), dtype=ta.dtype, device=ta.device)
    m[:, 0, 0] = 1.0
    for i in range(n):
        # t[z, a, (s d)] = m[z] tb[z, a, (s d)]; m'[z] = ta[z, (a s), :]^H t[z, (a s), :]
        t = lowp.matmul(m, tb[:, i].reshape(B, chi, 2 * chi), precision)
        m = lowp.matmul(ta[:, i].reshape(B, 2 * chi, chi), t.reshape(B, 2 * chi, chi),
                        precision, "h")
    return m[:, 0, 0]


def norm_sq(a: MPS, precision: str = "highest") -> torch.Tensor:
    return vdot(a, a, precision).real


def max_bond(mps: MPS) -> torch.Tensor:
    return mps.bond_dims.max(dim=1).values


def actual_nbytes(mps: MPS, itemsize: int) -> torch.Tensor:
    """Bytes of each UNPADDED state, ``[B]``: the sum over sites of left
    bond x 2 x right bond x ``itemsize`` (the bytes of one complex entry),
    the reference's stand-in for the unpadded tensors' ``nbytes``."""
    ones = torch.ones_like(mps.bond_dims[:, :1])
    left = torch.cat([ones, mps.bond_dims], 1).to(torch.int64)
    right = torch.cat([mps.bond_dims, ones], 1).to(torch.int64)
    return (left * 2 * right).sum(1) * itemsize


def to_dense(tensors: np.ndarray, n: int) -> np.ndarray:
    """Contract ONE padded MPS ``[n, chi, 2, chi]`` (numpy complex) into a
    dense statevector ``[2**n]``. Host/test only (exponential)."""
    v = tensors[0][0]
    for i in range(1, n):
        v = np.tensordot(v, tensors[i], axes=[[-1], [0]])
    return v[..., 0].reshape(-1)


def mps_from_reference(re, im, fidelity, bond_dims, device="cpu") -> MPS:
    """Build a port MPS from reference-engine arrays (numpy or anything
    ``np.asarray`` takes): ``re, im [B, n, chi, 2, chi]``, ``fidelity [B]``,
    ``bond_dims [B, n-1]``. Carries one reference state into the port."""
    re, im = np.asarray(re), np.asarray(im)
    return MPS(
        tensors=torch.complex(torch.from_numpy(re.copy()), torch.from_numpy(im.copy())).to(device),
        fidelity=torch.as_tensor(np.asarray(fidelity).copy(), device=device),
        bond_dims=torch.as_tensor(np.asarray(bond_dims, dtype=np.int32).copy(), device=device),
    )


def mps_to_numpy(mps: MPS):
    """``(tensors complex [B, n, chi, 2, chi], fidelity [B], bond_dims [B,
    n-1])`` as numpy arrays on the host."""
    return (mps.tensors.detach().cpu().numpy(), mps.fidelity.detach().cpu().numpy(),
            mps.bond_dims.detach().cpu().numpy())
