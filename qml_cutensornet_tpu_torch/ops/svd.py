"""Truncated factorization of the two-site update, subspace method (port of
``qml_cutensornet_tpu/ops/svd.py``: ``_subspace_start``, ``_split_subspace``,
``_finish_subspace``, ``_mask_from_s2``, ``truncated_svd``).

``truncated_svd(theta [B, m, k], cfg, keep)`` returns ``(left [B, m, keep],
right [B, keep, k], kept_fraction [B], rank [B])`` with ``left`` a masked
isometry spanning (an approximation of) the kept left singular subspace and
``right = left^H theta``. The subspace comes from the fused split
(``ops/split.py``: kernel K1 on CUDA tensors, its plain version on CPU
tensors), started from the same fixed numpy block as the reference so port
and reference iterate from the same v0. Per-direction squared singular
values are the row norms of ``r``; the truncation mask is the reference's
sorted-threshold eps rule plus the sv-ratio floor and ``value_of_zero``.
Discarded directions are exact zeros (the padding invariant).
"""

from __future__ import annotations

import numpy as np
import torch

from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.ops import split


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


def _abs2(x: torch.Tensor) -> torch.Tensor:
    return x.real * x.real + x.imag * x.imag


def _split_subspace(theta: torch.Tensor, cfg: SimConfig, keep: int):
    B, m, k = theta.shape
    nc = keep + max(0, cfg.oversample)
    v0 = start_block(m, nc, theta.dtype, theta.device)
    q, r = split.subspace_factor(theta, v0, max(1, cfg.subspace_iters))
    total = _abs2(theta).sum((1, 2))
    return _finish_subspace(q, r, total, cfg, keep, nc)


def _finish_subspace(q, r, total, cfg: SimConfig, keep: int, nc: int):
    """Squared singular values from the right factor's row norms, top-keep
    gather when oversampled, truncation mask, masked factors."""
    s2 = _abs2(r).sum(2)  # [B, nc]
    if nc > keep:
        sel = torch.argsort(-s2, dim=1, stable=True)[:, :keep]
        q = torch.gather(q, 2, sel[:, None, :].expand(-1, q.shape[1], -1))
        r = torch.gather(r, 1, sel[:, :, None].expand(-1, -1, r.shape[2]))
        s2 = torch.gather(s2, 1, sel)
    mask, kept_fraction = _mask_from_s2(s2, total, cfg, keep)
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
    kept = torch.where(mask, s2, torch.zeros_like(s2)).sum(1)
    safe_total = torch.where(total > 0, total, torch.ones_like(total))
    kept_fraction = torch.clamp(
        torch.where(total > 0, kept / safe_total, torch.ones_like(total)), max=1.0)
    return mask, kept_fraction


def truncated_svd(theta: torch.Tensor, cfg: SimConfig, keep: int):
    """Factor ``theta [B, m, k] ~= left [B, m, keep] @ right [B, keep, k]``.
    Returns ``(left, right, kept_fraction [B], rank [B])``."""
    if cfg.svd_method != "subspace":
        raise NotImplementedError(f"svd_method={cfg.svd_method!r} is not ported")
    return _split_subspace(theta, cfg, keep)
