"""Truncated factorization of the two-site update (port of
``qml_cutensornet_tpu/ops/svd.py``: ``_subspace_start``, ``_split_subspace``,
``_finish_subspace``, ``_mask_from_s2``, ``_tail_weights``,
``_truncation_mask``, ``_left_vectors_svd`` and ``_left_vectors_eigh`` (as
``_left_vectors``), ``truncated_svd``, ``gate_split_eligible``,
``truncated_svd_gate``, ``truncated_split_right``, ``brick_split_eligible``,
``fused_brick_update``).

``truncated_svd(theta [B, m, k], cfg, keep)`` returns ``(left [B, m, keep],
right [B, keep, k], kept_fraction [B], rank [B])`` with ``left`` a masked
isometry spanning (an approximation of) the kept left singular subspace and
``right = left^H theta``. ``cfg.svd_method`` picks how the subspace is found.

"svd" and "eigh" decompose theta itself: ``torch.linalg.svd(theta)``, or
``torch.linalg.eigh(theta theta^H)`` with its ascending eigenvalues reversed
and clipped at 0 (cuSOLVER on the card; no kernel of this package). The
reference decomposes the real embedding ``[[Re, -Im], [Im, Re]]`` and picks a
complex basis from the lifted real vectors by a greedy scan; torch's complex
dtypes give that basis directly. The semantics are the reference's: the
trailing weights of the whole spectrum (:func:`_tail_weights`), the
truncation rule of :func:`_truncation_mask` (bond cap, ``truncation_error``
times the total weight, the ``value_of_zero`` floor, index 0 always kept),
exact zeros past the mask, and ``rank`` counting the kept non-zero singular
values. Within a degenerate cluster any basis is as good as another, so
only the kept subspace is defined.

"subspace" runs ``iters`` rounds of ``w = orth(theta^H v)``, ``v = orth(theta
w)``, started from the same fixed numpy block as the reference so port and
reference iterate from the same v0. Three routes run that chain:

- fused split (``cfg.fused_split`` and a shape kernel K1 takes: nc <= 128,
  m, k <= 256): one launch of K1 (``ops/split.py``);
- unfused split (``cfg.fused_split`` off, a shape K1 does not take, such
  as chi 128 with the default oversampling of 16, nc = 144, a reduced
  ``cfg.matmul_precision`` or a ``cfg.power_precision`` other than
  "inherit"): the two power products at ``cfg.resolved_power_precision``
  and ``r = q^H theta`` at ``cfg.matmul_precision`` (``ops/lowp.matmul``:
  kernel K7 at a reduced class, ``torch.matmul`` otherwise; complex128
  stays full f64), and every orthonormalization through ``orth.qr_orth``
  (kernel K3, at full precision as in the reference; above 128 columns
  the blocked route, K3 on its panels with ``cfg.fused_split`` in
  complex64, the scanned panel step otherwise, its products at the
  ambient class);
- fused gate (``truncated_svd_gate``, taken by ``ops/mps.apply_2site`` when
  :func:`gate_split_eligible`): one launch of K4 builds theta from the two
  site tensors and the gate, and runs the chain; theta is never formed by
  torch ops, and its squared norm comes from the kernel.

``cfg.mgs_pair`` reaches every kernel of these routes (K1, K3, K4, K5 here
and K2 on the center moves, ``ops/mps.move_center``) as the reference
threads it: the block-2 in-panel step (``ops/orth.py``).

The brick engine (``ops/vidal.py``) factors from the right:
:func:`truncated_split_right` is :func:`truncated_svd` of ``theta^H``, and
:func:`fused_brick_update` runs the whole Hastings pair update through kernel
K5 where :func:`brick_split_eligible`. The kernels of the subspace method
serve only full-precision configurations, as in the reference: a reduced
ambient or power class keeps K1, K4 and K5 off (:func:`_kernel_precision`,
the reference's ``ops/svd.py:199-207``, ``:313``, ``:386``).

At a reduced ambient class (``cfg.matmul_precision``) every product that is
an XLA dot in the reference falls to it: the right factor of every method
(``:244``, ``:515``) and the eigh route's Gram (``:462``). The
factorizations themselves (``torch.linalg.svd``, ``eigh``, the kernels'
orthonormalizations) are not dots in the reference and stay at full
precision. The reference's eigh Gram is the real product ``E E^T`` of the
embedding ``E = [[Re, -Im], [Im, Re]]`` of theta; splitting ``E`` splits
theta's real and imaginary parts, so at the class it is the complex
product ``theta theta^H`` at the same class, which the port forms by K7
before rotating it (``Q G Q^H``, full precision; the rotation of
:func:`_left_vectors` is the port's own, exact in exact arithmetic). The
reference's greedy basis scan (``:112-113``) has no counterpart here:
torch's complex factorizations give the basis directly.

On the subspace routes the per-direction squared singular values are the row
norms of ``r``; the truncation mask is the reference's sorted-threshold eps
rule plus the sv-ratio floor and ``value_of_zero``. Discarded directions are
exact zeros (the padding invariant). At a full class the kept fraction
comes from the discarded weight (:func:`_kept_fraction`): the split routes
form ``||theta - q r||^2`` after the chain, kernels K4 and K5 (which never
store theta outside the kernel) return it; so f32 reads what f64 reads. The
reduced classes keep the reference's row-norm form.
"""

from __future__ import annotations

import numpy as np
import torch

from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.ops import lowp, orth, split


def _subspace_start(m: int, keep: int, dtype_name: str):
    """Fixed random start block (numpy ``default_rng(0x5EED)``, identical to
    the reference's)."""
    rng = np.random.default_rng(0x5EED)
    re = rng.normal(size=(m, keep)).astype(dtype_name)
    im = rng.normal(size=(m, keep)).astype(dtype_name)
    return re, im


_V0_CACHE: dict = {}


def start_block(m: int, nc: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The start block as a complex tensor ``[m, nc]`` on ``device``
    (cached: it is a constant)."""
    key = (m, nc, dtype, device)
    v0 = _V0_CACHE.get(key)
    if v0 is None:
        real = torch.float32 if dtype == torch.complex64 else torch.float64
        re, im = _subspace_start(m, nc, str(real).removeprefix("torch."))
        v0 = torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)
        _V0_CACHE[key] = v0
    return v0


def fused_split_supported(m: int, k: int, nc: int) -> bool:
    """Shapes kernel K1 takes (the reference's ``fused_split_supported``
    without its panel-alignment and dtype rules: the Hopper kernel takes
    partial panels and has a double instantiation)."""
    return nc <= split.MAX_NC and m <= split.MAX_MK and k <= split.MAX_MK


def _kernel_precision(cfg: SimConfig) -> bool:
    """The reference runs its fused kernels only in full-precision
    configurations (their products are pinned at full f32), so a lowered
    ambient or power precision keeps a configuration off them."""
    return (cfg.matmul_precision in ("highest", "float32")
            and cfg.power_precision == "inherit")


def _split_subspace(theta: torch.Tensor, cfg: SimConfig, keep: int):
    B, m, k = theta.shape
    nc = keep + max(0, cfg.oversample)
    v0 = start_block(m, nc, theta.dtype, theta.device)
    iters = max(1, cfg.subspace_iters)
    if cfg.fused_split and _kernel_precision(cfg) and fused_split_supported(m, k, nc):
        q, r = split.subspace_factor(theta, v0, iters, cfg.mgs_pair)
    else:
        # The power products at the power precision, r at the ambient class
        # (kernel K7 at a reduced class); the orthonormalizations at full
        # precision (K3), so a reduced power class perturbs only which
        # subspace is kept.
        p, pp = cfg.matmul_precision, cfg.resolved_power_precision
        v = v0.expand(B, m, nc)
        for _ in range(iters):
            w = orth.qr_orth(lowp.matmul(theta, v, pp, "h"), cfg.fused_split, cfg.mgs_pair, p)
            v = orth.qr_orth(lowp.matmul(theta, w, pp), cfg.fused_split, cfg.mgs_pair, p)
        q, r = v, lowp.matmul(v, theta, p, "h")
    total = orth.abs2(theta).sum((1, 2))
    resid2 = None
    if not lowp.reduced_passes(cfg.matmul_precision, theta.dtype):
        resid2 = split.residual_norm2(theta, q, r)
    return _finish_subspace(q, r, total, cfg, keep, nc, resid2)


def _finish_subspace(q, r, total, cfg: SimConfig, keep: int, nc: int, resid2=None):
    """Squared singular values from the right factor's row norms, top-keep
    gather when oversampled, truncation mask, kept fraction
    (:func:`_kept_fraction`, from ``resid2 = ||theta - q r||^2 [B]`` where
    given), masked factors."""
    s2 = orth.abs2(r).sum(2)  # [B, nc]
    unseen = resid2
    if nc > keep:
        order = torch.argsort(-s2, dim=1, stable=True)
        sel = order[:, :keep]
        if unseen is not None:
            unseen = unseen + torch.gather(s2, 1, order[:, keep:]).sum(1)
        q = torch.gather(q, 2, sel[:, None, :].expand(-1, q.shape[1], -1))
        r = torch.gather(r, 1, sel[:, :, None].expand(-1, -1, r.shape[2]))
        s2 = torch.gather(s2, 1, sel)
    mask = _mask_from_s2(s2, total, cfg, keep)
    kept_fraction = _kept_fraction(s2, mask, total, unseen)
    mf = mask.to(s2.dtype)
    left = q * mf[:, None, :]
    right = r * mf[:, :, None]
    if cfg.renormalize:
        inv = torch.rsqrt(torch.where(kept_fraction > 0, kept_fraction,
                                      torch.ones_like(kept_fraction)))
        right = right * inv[:, None, None]
    rank = mask.sum(1, dtype=torch.int32)
    return left, right, kept_fraction, rank


def _mask_from_s2(s2, total, cfg: SimConfig, keep: int):
    """Mask over ``s2 [B, keep]``: sorted-threshold eps rule with unseen
    weight charged as ``total - sum(s2)``, sv-ratio floor, value_of_zero."""
    beyond = torch.clamp(total - s2.sum(1), min=0.0)
    s2_sorted = torch.sort(s2, dim=1, descending=True).values
    tail = torch.flip(torch.cumsum(torch.flip(s2_sorted, [1]), 1), [1]) + beyond[:, None]
    rule = tail > cfg.truncation_error * total[:, None]
    n_keep = torch.clamp(rule.sum(1), min=1)
    idx = torch.clamp(n_keep - 1, max=keep - 1)
    thresh = torch.gather(s2_sorted, 1, idx[:, None])
    sv_ratio_floor = 2e-5 if s2.dtype == torch.float32 else 1e-10
    floor = s2_sorted[:, :1] * (sv_ratio_floor * sv_ratio_floor)
    mask = (s2 >= torch.clamp(thresh, min=0.0)) & (s2 > floor)
    if cfg.value_of_zero > 0.0:
        mask = mask & (torch.sqrt(s2) > cfg.value_of_zero)
    return mask


def _kept_fraction(s2, mask, total, unseen=None):
    """The reference's ``min(kept / total, 1)`` (1 where ``total`` is 0) over
    ``s2 [B, keep]`` and its ``mask``.

    Without ``unseen``, the reference's form: ``kept = sum(s2[mask])``. With
    ``unseen`` (``||theta - q r||^2`` over all ``nc`` directions, plus the
    oversampled directions not gathered), ``kept = total - discarded``, the
    discarded weight summed from small terms alone: ``unseen`` and the
    masked-out ``s2``. The two are equal in exact arithmetic (the residual
    is orthogonal to the basis), and the second is never above 1, so it
    needs no clamp. In f32 the first carries the basis's rounding: the row
    norms of ``q^H theta`` sum to ``||theta||^2`` only as far as ``q`` is
    orthonormal, about 1.6e-7 of noise a split either way; most splits
    truncate nothing, their ratio is 1, and the clamp at 1 keeps only the
    low half of that noise, a bias of about 5e-8 a split that the fidelity
    multiplies over every split of a circuit. The second's error is
    relative to the discarded weight itself, so a split that truncates
    nothing reads 1 to within f32's square."""
    safe_total = torch.where(total > 0, total, 1.0)
    if unseen is None:
        kept = torch.where(mask, s2, 0.0).sum(1)
        return torch.where(total > 0, torch.clamp(kept / safe_total, max=1.0), 1.0)
    return 1.0 - (unseen + torch.where(mask, 0.0, s2).sum(1)) / safe_total


def _tail_weights(p_desc: torch.Tensor):
    """Trailing weights ``tail[:, i] = sum_{j >= i} p_desc[:, j]`` of a
    descending squared spectrum ``p_desc [B, r]``, by a reverse cumulative
    sum, and the total weight ``[B]``. Cancellation-free: ``eps = 1e-16``
    sits below f64 rounding, so a total-minus-cumsum form would put the
    comparison inside rounding noise. The reference's halved reverse cumsum
    of its doubled real spectrum, at even ranks, is this sum."""
    tail = torch.flip(torch.cumsum(torch.flip(p_desc, [1]), 1), [1])
    return tail, p_desc.sum(1)


def _truncation_mask(s, tail, total, cfg: SimConfig, keep: int):
    """Mask over the descending kept singular values ``s [B, keep]``: keep
    index ``i`` iff ``tail[:, i] > truncation_error * total`` and (with
    ``value_of_zero > 0``) ``s > value_of_zero``; index 0 is never dropped.
    Returns ``(mask [B, keep] bool, kept_fraction [B])``."""
    mask = tail > cfg.truncation_error * total[:, None]
    if cfg.value_of_zero > 0.0:
        mask = mask & (s > cfg.value_of_zero)
    mask[:, 0] = True
    return mask, _kept_fraction(s * s, mask, total)


_ROTATION_CACHE: dict = {}


def _rotation(m: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A fixed random unitary ``[m, m]`` (the QR factor of a complex
    Gaussian from numpy ``default_rng(0xE16)``), cached like the start
    block."""
    key = (m, dtype, device)
    q = _ROTATION_CACHE.get(key)
    if q is None:
        rng = np.random.default_rng(0xE16)
        q = np.linalg.qr(rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m)))[0]
        q = torch.from_numpy(q).to(dtype).to(device)
        _ROTATION_CACHE[key] = q
    return q


def _left_vectors(theta: torch.Tensor, method: str, keep: int, precision: str = "highest"):
    """Leading left singular vectors ``u [B, m, keep]``, their singular
    values ``s [B, keep]`` and trailing weights ``tail [B, keep]`` (both
    computed over the whole spectrum), and the total weight ``[B]``, by
    ``torch.linalg.svd(theta)`` ("svd") or ``torch.linalg.eigh(theta
    theta^H)`` ("eigh": ascending, so reversed, and clipped at 0). Past the
    spectrum's length (``keep > min(m, k)`` for "svd") the columns, values
    and weights are zeros.

    "svd" takes cuSOLVER's QR-iteration driver ("gesvd") on the card: on
    an H100 at the headline shape its default Jacobi driver ("gesvdj") took
    2.2x longer a circuit and left the f32 Gram 4.9e-6 off the f64 golden,
    gesvd 3.0e-8 (PERF.md). "eigh" decomposes ``(Q theta)(Q theta)^H`` for a
    fixed random unitary ``Q`` and maps the vectors back by ``Q^H``: the
    same eigenpairs, but dense. On theta theta^H itself, whose bond padding
    leaves exactly-zero rows and a many-fold null block, the libraries'
    eigensolvers fail (cuSOLVER: no convergence; MKL: NaN vectors). At a
    reduced ``precision`` the Gram ``theta theta^H`` is formed at that class
    (the reference's ``E E^T``) and then rotated, ``Q G Q^H``, at full
    precision; at full precision the rotated theta's Gram is formed
    directly, which on an H100 kept the f32 route's Gram 3x closer to the
    f64 golden than ``Q (theta theta^H) Q^H`` (PERF.md)."""
    if method == "eigh":
        q = _rotation(theta.shape[1], theta.dtype, theta.device)
        if lowp.reduced_passes(precision, theta.dtype):
            g = q @ lowp.matmul(theta, theta, precision, op_b="h") @ q.mH
        else:
            t = q @ theta
            g = t @ t.mH
        w, vecs = torch.linalg.eigh(g)
        p = torch.clamp(torch.flip(w, [1]), min=0.0)
        u, s = q.mH @ torch.flip(vecs, [2]), torch.sqrt(p)
    else:
        driver = "gesvd" if theta.is_cuda else None
        u, s, _ = torch.linalg.svd(theta, full_matrices=False, driver=driver)
        p = s * s
    tail, total = _tail_weights(p)
    r = s.shape[1]
    if r >= keep:
        return u[:, :, :keep], s[:, :keep], tail[:, :keep], total
    pad = keep - r
    return (torch.nn.functional.pad(u, (0, pad)), torch.nn.functional.pad(s, (0, pad)),
            torch.nn.functional.pad(tail, (0, pad)), total)


def truncated_svd(theta: torch.Tensor, cfg: SimConfig, keep: int):
    """Factor ``theta [B, m, k] ~= left [B, m, keep] @ right [B, keep, k]``.
    Returns ``(left, right, kept_fraction [B], rank [B])``."""
    if cfg.svd_method == "subspace":
        return _split_subspace(theta, cfg, keep)
    u, s, tail, total = _left_vectors(theta, cfg.svd_method, keep, cfg.matmul_precision)
    mask, kept_fraction = _truncation_mask(s, tail, total, cfg, keep)
    left = u * mask.to(s.dtype)[:, None, :]
    right = lowp.matmul(left, theta, cfg.matmul_precision, "h")
    if cfg.renormalize:
        inv = torch.rsqrt(torch.where(kept_fraction > 0, kept_fraction,
                                      torch.ones_like(kept_fraction)))
        right = right * inv[:, None, None]
    rank = (mask & (s > 0)).sum(1, dtype=torch.int32)
    return left, right, kept_fraction, rank


def gate_split_eligible(cfg: SimConfig, chi: int) -> bool:
    """Whether a two-site update at bond cap ``chi`` takes the fused-gate
    route (kernel K4). The shape rules are the reference's
    (``gate_split_supported``): chi a multiple of 8, nc = chi + oversample a
    multiple of 16 and at most 128, chi at most 128. So on the staged ramp
    the chi-8 stage (nc = 8) stays on the fused or unfused split and the
    stages from chi 16 go to K4, as in the reference. Unlike the reference
    the port also takes f64 (the kernel's double instantiation). Only the
    subspace method in a full-precision configuration takes it, as in the
    reference."""
    if cfg.svd_method != "subspace" or not (cfg.fused_split and cfg.fused_gate):
        return False
    if not _kernel_precision(cfg):
        return False
    nc = chi + max(0, cfg.oversample)
    return chi % 8 == 0 and nc % 16 == 0 and fused_split_supported(2 * chi, 2 * chi, nc)


def gate_feeds(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor, is_left: bool):
    """Kernel K4's inputs for the pair ``a, b [B, chi, 2, chi]`` and gate ``g
    [B, 4, 4]``: ``(A [B, 2chi, chi], Bm [B, chi, 2chi], g)`` whose theta is
    the pair's theta (``is_left`` false) or its plain transpose (``is_left``
    true). The transposed case never transposes theta: it swaps the stacks
    and permutes the gate, ``g'[2t+s, 2v+u] = g[2s+t, 2u+v]``."""
    B, chi = a.shape[0], a.shape[1]
    if is_left:
        A = b.permute(0, 2, 3, 1).reshape(B, 2 * chi, chi)  # rows (t, be), cols b
        Bm = a.permute(0, 3, 2, 1).reshape(B, chi, 2 * chi)  # rows b, cols (u, al)
        perm = [0, 2, 1, 3]
        g = g[:, perm][:, :, perm]
    else:
        A = a.transpose(1, 2).reshape(B, 2 * chi, chi)  # rows (u, al), cols b
        Bm = b.reshape(B, chi, 2 * chi)  # rows b, cols (v, be)
    return A.contiguous(), Bm.contiguous(), g.contiguous()


def truncated_svd_gate(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor, cfg: SimConfig,
                       keep: int, is_left: bool):
    """The two-site update's factorization without forming theta by torch
    ops: ``a, b [B, chi, 2, chi]`` site tensors, ``g [B, 4, 4]`` the gate.
    Returns ``(left [B, 2chi, keep], right [B, keep, 2chi], kept_fraction,
    rank)`` for theta (``is_left`` false) or theta^T (``is_left`` true).

    Layout contract (differs from :func:`truncated_svd` on the row side):
    ``left`` rows are s-major, ``left[s * chi + al]`` is the (spin s, bond
    al) component; ``right`` columns are t-major. For ``is_left`` the roles
    read t-major rows and s-major columns. The caller owns the write-back
    reshapes (``ops/mps.apply_2site``)."""
    chi = a.shape[1]
    nc = keep + max(0, cfg.oversample)
    v0 = start_block(2 * chi, nc, a.dtype, a.device)
    q, r, total, resid2 = split.gate_subspace_factor(*gate_feeds(a, b, g, is_left), v0,
                                                     max(1, cfg.subspace_iters), cfg.mgs_pair)
    return _finish_subspace(q, r, total, cfg, keep, nc, resid2)


def truncated_split_right(theta: torch.Tensor, cfg: SimConfig, keep: int):
    """Right-sided truncated factorization of ``theta [B, m, k] ~= (theta
    V^H) V`` with ``V [B, keep, k]`` row-orthonormal (masked rows exact
    zeros): :func:`truncated_svd` of ``theta^H``, so any basis of its kept
    left subspace gives ``V``. Returns ``(V, s [B, keep], kept_fraction,
    rank)`` with ``s`` the kept singular values (row norms of the right
    factor; zeros on masked rows). Assumes ``cfg.renormalize`` is off, the
    brick engine's setting, so the row norms are the singular values."""
    left, right, kept_fraction, rank = truncated_svd(theta.mH.contiguous(), cfg, keep)
    return left.mH, torch.sqrt(orth.abs2(right).sum(-1)), kept_fraction, rank


def brick_split_eligible(cfg: SimConfig, cl: int, cm: int, cr: int) -> bool:
    """Whether a brick pair update with bonds ``(cl, cm, cr)`` takes kernel
    K5: square pair tensors, renormalize off, and the fused-gate rule of
    :func:`gate_split_eligible` at ``cm`` (the subspace method, full
    precision, its shape rule), so that both packages send each stage to the
    same route."""
    if cl != cm or cm != cr or cfg.renormalize:
        return False
    return gate_split_eligible(cfg, cm)


def fused_brick_update(a: torch.Tensor, b: torch.Tensor, g4: torch.Tensor, lam: torch.Tensor,
                       cfg: SimConfig, keep: int):
    """The Hastings pair update of ``ops/vidal.update_pairs`` over a flat
    batch through kernel K5: ``a, b [Bn, chi, 2, chi]`` site tensors, ``g4
    [Bn, 4, 4]`` blended gates, ``lam [Bn, chi]`` left-bond Schmidt weights.
    Returns ``(new_a [Bn, chi, 2, keep], new_b [Bn, keep, 2, chi], s [Bn,
    keep], kept_fraction [Bn], rank [Bn])``, the unfused route's contract."""
    Bn, chi = a.shape[0], a.shape[1]
    A = a.transpose(1, 2).reshape(Bn, 2 * chi, chi).contiguous()  # rows (s, al)
    Bm = b.reshape(Bn, chi, 2 * chi).contiguous()  # columns (t, be)
    nc = keep + max(0, cfg.oversample)
    v0 = start_block(2 * chi, nc, a.dtype, a.device)
    q2, na0, s2, total, unseen = split.brick_gate_split(
        A, Bm, g4.contiguous(), lam.contiguous(), v0, max(1, cfg.subspace_iters), cfg.mgs_pair)
    if nc > keep:
        order = torch.argsort(-s2, dim=1, stable=True)
        sel = order[:, :keep]
        unseen = unseen + torch.gather(s2, 1, order[:, keep:]).sum(1)
        rows = sel[:, :, None].expand(-1, -1, 2 * chi)
        q2, na0, s2 = torch.gather(q2, 1, rows), torch.gather(na0, 1, rows), torch.gather(s2, 1, sel)
    mask = _mask_from_s2(s2, total, cfg, keep)
    kept_fraction = _kept_fraction(s2, mask, total, unseen)
    mf = mask.to(s2.dtype)
    v = q2.conj() * mf[:, :, None]  # V = conj(Q rows); masked rows of V = masked columns of new_a
    na = na0 * mf[:, :, None]
    s = torch.sqrt(s2) * mf
    rank = mask.sum(1, dtype=torch.int32)
    # na rows [keep, (s al)] are new_a's columns; V rows [keep, (t be)] are new_b.
    new_a = na.reshape(Bn, keep, 2, chi).permute(0, 3, 2, 1)
    new_b = v.reshape(Bn, keep, 2, chi)
    return new_a, new_b, s, kept_fraction, rank
