"""Brick-parallel MPS evolution in Hastings B-form (port of
``qml_cutensornet_tpu/ops/vidal.py``).

The tracked engine (``ops/mps.py``) applies one two-site update at a time at
a tracked canonical center. This engine keeps the state in the Vidal gauge,
where a whole LAYER of disjoint two-site gates (a "brick") updates at once:
one batched factorization over (batch x pairs) per layer, 72 layers at
nq 100, d 6 (``models/ansatz._raw_brick``).

Representation (Hastings' form, no lambda inverses):

- ``tensors [B, n_p, chi, 2, chi]``: B-form site tensors ``B_i = Gamma_i
  lambda_i``. Their plain product is the state, so the tile scan
  (``models/simulate.tile_overlaps_sq``) reads them as they are.
- ``lams [B, n_p-1, chi]``: bond Schmidt values, masked entries exact 0.
- The site axis is padded with dummy product sites (one left, one or two
  right) so that both parities carry the same pair count ``K`` with
  disjoint gathers (``models/ansatz.BrickRep``).

Update across bond i (sites i, i+1) with gate G:

    theta_t = G (B_i B_{i+1})            no left lambda
    theta_w = diag(lam_{i-1}) theta_t    the bond's Schmidt matrix
    V, s    = right factor and singular values of theta_w (truncated)
    B_{i+1}' = V,  B_i' = theta_t V^H,  lam_i' = s

All pairs of one parity have disjoint inputs, so a layer is one ``[B*K]``
batched factorization: kernel K5 (``ops/split.brick_gate_split``) where
:func:`ops.svd.brick_split_eligible`, else the pair product in torch and
:func:`ops.svd.truncated_split_right` (kernel K1, or K3 on the unfused
route). No renormalization after truncation; the kept-fraction product
accumulates into ``fidelity``; masked and padded entries stay exact zeros.

With ``cfg.brick_struct_caps`` (``QMLTPU_BRICK_CAPS``) and the real site
count ``n``, a layer's pairs are chunked by their structural bond caps
(:func:`structural_caps`) and each chunk is updated at its caps' sliced
shapes ``(cl, cm, cr)``: exact, because a stored entry beyond a bond's
Schmidt-rank bound is an exact zero at all times. With the fused gate the
square buckets that K5's shape rule takes stay on K5 (at nf 100, chi 128:
the 43 interior pairs at the cap); the rectangles and the squares it
refuses take the unfused update, whose split is K1 at ``m = 2 cr``, ``k = 2
cl``, ``nc = cm`` (below one panel at the chain's ends).

The products outside the kernels (the Hadamard layer, theta, the gate,
``new_a``) run at the ambient class, ``cfg.matmul_precision``, through
``ops/lowp.matmul`` (kernel K7 at a reduced class, which keeps K5 off, as
in the reference).

Unlike the reference, whose arrays are immutable, the layer writes the
updated pairs into ``tensors``, ``lams`` and ``bond_dims`` IN PLACE (one
state-sized copy per pair chunk saved) and returns a state sharing them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.ops import gates, lowp
from qml_cutensornet_tpu_torch.ops.svd import (
    brick_split_eligible,
    fused_brick_update,
    truncated_split_right,
)


@dataclasses.dataclass
class VidalState:
    """Batched brick-engine state (batch axis leading on every field)."""

    tensors: torch.Tensor  # [B, n_p, chi, 2, chi] complex
    lams: torch.Tensor  # [B, n_p-1, chi] real
    fidelity: torch.Tensor  # [B] real
    bond_dims: torch.Tensor  # [B, n_p-1] int32


def zero_state(batch: int, n_p: int, cfg: SimConfig, device: torch.device) -> VidalState:
    """|0..0> over the padded site space: every site e0 (x) |0> (x) e0, every
    bond lambda e0 (a dim-1 bond of weight 1)."""
    t = torch.zeros((batch, n_p, cfg.chi, 2, cfg.chi), dtype=cfg.complex_dtype, device=device)
    t[:, :, 0, 0, 0] = 1.0
    lams = torch.zeros((batch, n_p - 1, cfg.chi), dtype=cfg.real_dtype, device=device)
    lams[:, :, 0] = 1.0
    return VidalState(
        tensors=t,
        lams=lams,
        fidelity=torch.ones(batch, dtype=cfg.real_dtype, device=device),
        bond_dims=torch.ones((batch, n_p - 1), dtype=torch.int32, device=device),
    )


def apply_1q_real_sites(state: VidalState, u2: torch.Tensor, n: int,
                        precision: str = "highest") -> VidalState:
    """The same 1-qubit gate ``u2 [2, 2]`` on every REAL site (padded sites
    1..n), at ``precision``; 1-qubit unitaries leave the lambdas alone."""
    t = state.tensors.clone()
    t[:, 1:n + 1] = lowp.matmul(u2, t[:, 1:n + 1], precision)
    return dataclasses.replace(state, tensors=t)


def apply_diag_real_sites(state: VidalState, phases: torch.Tensor) -> VidalState:
    """Per-real-site diagonal 1-qubit gates ``phases [B, n, 2]`` (the Rz
    feature layer); dummy sites untouched."""
    n = phases.shape[1]
    t = state.tensors.clone()
    t[:, 1:n + 1] = t[:, 1:n + 1] * phases[:, :, None, :, None]
    return dataclasses.replace(state, tensors=t)


def structural_caps(n: int, K: int, chi: int) -> list[tuple[int, int, int]]:
    """Per-pair-index bond caps ``(cl, cm, cr)`` of one brick layer over
    ``n`` real sites: bond ``j`` splits the chain into ``l = min(j, n)``
    left and ``n - l`` right sites, so its Schmidt rank is at most
    ``min(2^l, 2^(n-l))``. Each cap is the larger over both parities,
    rounded up to a power of two and floored at 4. The engine reads it
    under ``cfg.brick_struct_caps`` (:func:`brick_layer`)."""

    def sb(j: int) -> int:
        l = min(max(j, 0), n)
        m = min(l, n - l)
        return chi if m >= 31 else min(chi, 1 << m)

    def rnd(c: int) -> int:
        return min(chi, max(4, 1 << (c - 1).bit_length()))

    out = []
    for k in range(K):
        j0, j1 = 2 * k, 2 * k + 1  # middle bond at parity 0 / 1
        out.append((
            rnd(max(sb(j0 - 1), sb(j1 - 1))),
            rnd(max(sb(j0), sb(j1))),
            rnd(max(sb(j0 + 1), sb(j1 + 1))),
        ))
    return out


def cap_buckets(n: int, K: int, chi: int) -> list[tuple[int, int, tuple[int, int, int]]]:
    """The runs ``(k0, k1, caps)`` of consecutive pair indices of one layer
    that share their structural caps (:func:`structural_caps`), in order."""
    caps = structural_caps(n, K, chi)
    out = []
    k0 = 0
    while k0 < K:
        k1 = k0 + 1
        while k1 < K and caps[k1] == caps[k0]:
            k1 += 1
        out.append((k0, k1, caps[k0]))
        k0 = k1
    return out


def _pair_chunk(K: int, chi: int, batch: int) -> int:
    """Pairs per sub-step of a layer: the chunk's thetas stay near 2^27 real
    elements (the reference's memory rule, kept so that the launch counts
    follow it). Pairs of a layer are disjoint, so sub-steps are exact."""
    budget_elems = 1 << 27
    per_pair = 4 * chi * chi * 2 * max(batch, 1)
    kc = max(1, budget_elems // max(per_pair, 1))
    return min(K, kc)


def update_pairs(a: torch.Tensor, b: torch.Tensor, lam_l: torch.Tensor, thetas: torch.Tensor,
                 swap_w: float, cfg: SimConfig):
    """Batched Hastings updates of already gathered pairs: ``a [B, K, cl, 2,
    cm]``, ``b [B, K, cm, 2, cr]`` (left and right B-form tensors), ``lam_l
    [B, K, cl]`` (left-bond weights), ``thetas [B, K]`` XXPhase angles,
    ``swap_w`` 1.0 for the fused XXPhase@SWAP step and 0.0 for plain
    XXPhase. The middle bond keeps at most ``cm`` directions. Returns
    ``(new_a, new_b, s [B, K, cm], kept_fraction [B, K], rank [B, K])``;
    the caller owns gather, select and scatter."""
    B, K = a.shape[0], a.shape[1]
    cl, cm, cr = a.shape[2], a.shape[4], b.shape[4]
    # XXSW = XX with columns 1 and 2 exchanged.
    xx = gates.xxphase(thetas)  # [B, K, 4, 4]
    g = swap_w * xx[..., [0, 2, 1, 3]] + (1.0 - swap_w) * xx

    if brick_split_eligible(cfg, cl, cm, cr):
        new_a, new_b, s, kf, rank = fused_brick_update(
            a.reshape(B * K, cl, 2, cm), b.reshape(B * K, cm, 2, cr),
            g.reshape(B * K, 4, 4), lam_l.reshape(B * K, cl), cfg, cm)
        return (new_a.reshape(B, K, cl, 2, cm), new_b.reshape(B, K, cm, 2, cr),
                s.reshape(B, K, cm), kf.reshape(B, K), rank.reshape(B, K))

    p = cfg.matmul_precision
    theta0 = lowp.matmul(a.reshape(B, K, cl * 2, cm), b.reshape(B, K, cm, 2 * cr), p)
    # the gate on the physical pair (s t) of theta [B, K, a, (s t), c]
    theta_t = lowp.matmul(g[:, :, None], theta0.reshape(B, K, cl, 4, cr), p)
    # Weight by the left lambda: the Schmidt matrix of the middle bond.
    theta_w = theta_t * lam_l[:, :, :, None, None]
    th_w = theta_w.reshape(B * K, cl * 2, 2 * cr)
    th_t = theta_t.reshape(B * K, cl * 2, 2 * cr)
    v, s, kf, rank = truncated_split_right(th_w, cfg, cm)
    # Hastings: the new left tensor from the UNWEIGHTED theta, no inverse.
    new_a = lowp.matmul(th_t, v, p, op_b="h")  # [B*K, cl*2, cm]
    return (new_a.reshape(B, K, cl, 2, cm), v.reshape(B, K, cm, 2, cr),
            s.reshape(B, K, cm), kf.reshape(B, K), rank.reshape(B, K))


def _brick_pairs(state: VidalState, parity: int, k_off: int, swap_w: float,
                 active: torch.Tensor, thetas: torch.Tensor, cfg: SimConfig,
                 caps: tuple[int, int, int] | None = None) -> VidalState:
    """Update the pair range ``[k_off, k_off + len(active))`` of one layer:
    pair ``k`` joins padded sites ``parity + 2k`` and ``parity + 2k + 1``.
    Inactive pairs are computed and then discarded by a select, so they are
    exact no-ops. ``caps = (cl, cm, cr)``, the structural bond caps of every
    pair of the range, slices the gathered pairs before the update and
    zero-pads them on writeback (exact for active and inactive pairs: the
    entries past a bond's cap are exact zeros)."""
    t = state.tensors
    K = active.shape[0]
    chi = t.shape[2]
    idx = parity + 2 * (k_off + torch.arange(K, device=t.device))  # left sites
    a = t.index_select(1, idx)  # [B, K, chi, 2, chi]
    b = t.index_select(1, idx + 1)
    lam_old = state.lams.index_select(1, idx)  # middle-bond weights (for inactive pairs)
    # The left lambda of pair k sits on bond idx-1, of the other parity, so
    # this layer never writes it. idx == 0 is only the leading dummy pair,
    # always inactive: its weights are ones and the select discards it.
    lam_l = state.lams.index_select(1, (idx - 1).clamp(min=0))
    if caps is not None:
        cl, cm, cr = caps
        a, b = a[:, :, :cl, :, :cm], b[:, :, :cm, :, :cr]
        lam_l, lam_old = lam_l[:, :, :cl], lam_old[:, :, :cm]
    lam_l = torch.where((idx > 0)[None, :, None], lam_l, torch.ones_like(lam_l))

    new_a, new_b, s, kf, rank = update_pairs(a, b, lam_l, thetas, swap_w, cfg)

    am = active[None, :]
    new_a = torch.where(am[:, :, None, None, None], new_a, a)
    new_b = torch.where(am[:, :, None, None, None], new_b, b)
    lam_new = torch.where(am[:, :, None], s, lam_old)
    rank_new = torch.where(am, rank, state.bond_dims.index_select(1, idx))
    fid = state.fidelity * torch.prod(torch.where(am, kf, torch.ones_like(kf)), dim=1).to(
        state.fidelity.dtype)
    if caps is not None:  # zero-pad back to the stored [chi, 2, chi]
        pad = torch.nn.functional.pad
        new_a = pad(new_a, (0, chi - cm, 0, 0, 0, chi - cl))
        new_b = pad(new_b, (0, chi - cr, 0, 0, 0, chi - cm))
        lam_new = pad(lam_new, (0, chi - cm))
    t[:, idx] = new_a
    t[:, idx + 1] = new_b
    state.lams[:, idx] = lam_new
    state.bond_dims[:, idx] = rank_new.to(torch.int32)
    return VidalState(tensors=t, lams=state.lams, fidelity=fid, bond_dims=state.bond_dims)


def brick_layer(state: VidalState, parity: int, swap_w: float, active: torch.Tensor,
                thetas: torch.Tensor, cfg: SimConfig, n: int | None = None) -> VidalState:
    """One brick layer: simultaneous updates of all pairs ``(parity + 2k,
    parity + 2k + 1)``, k < K, in pair chunks of :func:`_pair_chunk`.
    ``active [K]`` bool tensor (shared by the batch), ``thetas [B, K]``
    per-sample angles (0 on pairs that do not fire). With
    ``cfg.brick_struct_caps`` and ``n`` (the real site count) the chunks
    also split where the pairs' structural caps change
    (:func:`structural_caps`), and each is updated at its caps' shapes."""
    K = active.shape[0]
    batch, chi = state.tensors.shape[0], state.tensors.shape[2]
    if cfg.brick_struct_caps and n is not None:
        for k0, k1, caps in cap_buckets(n, K, chi):
            kc = _pair_chunk(k1 - k0, max(caps), batch)
            for s in range(k0, k1, kc):
                sl = slice(s, min(k1, s + kc))
                state = _brick_pairs(state, parity, s, swap_w, active[sl], thetas[:, sl], cfg,
                                     caps)
        return state
    kc = _pair_chunk(K, chi, batch)
    for k0 in range(0, K, kc):
        sl = slice(k0, min(K, k0 + kc))
        state = _brick_pairs(state, parity, k0, swap_w, active[sl], thetas[:, sl], cfg)
    return state


def layer_scan(state: VidalState, parities, swaps, actives: torch.Tensor, thetas: torch.Tensor,
               cfg: SimConfig, n: int | None = None) -> VidalState:
    """Run a chunk of layers in order: ``parities [C]`` and ``swaps [C]``
    (host arrays), ``actives [C, K]`` bool and ``thetas [C, B, K]`` (on the
    state's device). ``n`` (the real site count) enables the structural
    caps under ``cfg.brick_struct_caps``."""
    for c in range(len(parities)):
        state = brick_layer(state, int(parities[c]), float(swaps[c]), actives[c], thetas[c], cfg,
                            n=n)
    return state


def to_mps_tensors(state: VidalState, n: int):
    """Strip the dummy sites (their bonds are exact dim-1 e0 bonds, so the
    slice is exact): ``(tensors [B, n, chi, 2, chi], fidelity [B],
    bond_dims [B, n-1])``. Sites are in the brick's final permutation."""
    return state.tensors[:, 1:n + 1], state.fidelity, state.bond_dims[:, 1:n]


def vidal_state_from_reference(re, im, lams, fidelity, bond_dims, device="cpu") -> VidalState:
    """Build a port state from reference-engine arrays (numpy or anything
    ``np.asarray`` takes): ``re, im [B, n_p, chi, 2, chi]``, ``lams [B,
    n_p-1, chi]``, ``fidelity [B]``, ``bond_dims [B, n_p-1]``."""
    re, im = np.asarray(re), np.asarray(im)
    return VidalState(
        tensors=torch.complex(torch.from_numpy(re.copy()), torch.from_numpy(im.copy())).to(device),
        lams=torch.as_tensor(np.asarray(lams).copy(), device=device),
        fidelity=torch.as_tensor(np.asarray(fidelity).copy(), device=device),
        bond_dims=torch.as_tensor(np.asarray(bond_dims, dtype=np.int32).copy(), device=device),
    )


def vidal_state_to_numpy(state: VidalState):
    """``(tensors complex, lams, fidelity, bond_dims)`` as numpy arrays on
    the host."""
    return tuple(x.detach().cpu().numpy()
                 for x in (state.tensors, state.lams, state.fidelity, state.bond_dims))
