"""Gate matrices in the TKET half-turn convention, as complex tensors (port of
``qml_cutensornet_tpu/ops/gates.py``).

Every function takes the TRUE angle ``theta`` (radians; the TKET exponent
``alpha`` maps to ``theta = pi * alpha / 2``) as a real tensor of any batch
shape and returns the stacked complex matrices ``[..., d, d]`` in the
complex dtype matching ``theta``'s real dtype.
"""

from __future__ import annotations

import math

import torch

from qml_cutensornet_tpu_torch.ops import lowp

_COMPLEX_OF = {torch.float32: torch.complex64, torch.float64: torch.complex128}

_SWAP = ((1.0, 0.0, 0.0, 0.0),
         (0.0, 0.0, 1.0, 0.0),
         (0.0, 1.0, 0.0, 0.0),
         (0.0, 0.0, 0.0, 1.0))


def _cplx(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.complex(re, im)


def rx(theta: torch.Tensor) -> torch.Tensor:
    """TKET_Rx: [[cos t, -i sin t], [-i sin t, cos t]]."""
    c, s = torch.cos(theta), torch.sin(theta)
    z = torch.zeros_like(c)
    re = torch.stack([torch.stack([c, z], -1), torch.stack([z, c], -1)], -2)
    im = torch.stack([torch.stack([z, -s], -1), torch.stack([-s, z], -1)], -2)
    return _cplx(re, im)


def rz_phases(theta: torch.Tensor) -> torch.Tensor:
    """Diagonal of TKET_Rz, diag(e^{-it}, e^{it}), as ``[..., 2]``."""
    c, s = torch.cos(theta), torch.sin(theta)
    return _cplx(torch.stack([c, c], -1), torch.stack([-s, s], -1))


def rz(theta: torch.Tensor) -> torch.Tensor:
    ph = rz_phases(theta)
    return torch.diag_embed(ph)


def xxphase(theta: torch.Tensor) -> torch.Tensor:
    """XXPhase(t) = exp(-i t X⊗X): [[c,0,0,-is],[0,c,-is,0],[0,-is,c,0],[-is,0,0,c]]."""
    c, s = torch.cos(theta), torch.sin(theta)
    z = torch.zeros_like(c)
    re = torch.stack([
        torch.stack([c, z, z, z], -1),
        torch.stack([z, c, z, z], -1),
        torch.stack([z, z, c, z], -1),
        torch.stack([z, z, z, c], -1),
    ], -2)
    im = torch.stack([
        torch.stack([z, z, z, -s], -1),
        torch.stack([z, z, -s, z], -1),
        torch.stack([z, -s, z, z], -1),
        torch.stack([-s, z, z, z], -1),
    ], -2)
    return _cplx(re, im)


def zzphase_phases(theta: torch.Tensor) -> torch.Tensor:
    """Diagonal of ZZPhase: diag(e^{-it}, e^{it}, e^{it}, e^{-it})."""
    c, s = torch.cos(theta), torch.sin(theta)
    return _cplx(torch.stack([c, c, c, c], -1), torch.stack([-s, s, s, -s], -1))


def zzphase(theta: torch.Tensor) -> torch.Tensor:
    return torch.diag_embed(zzphase_phases(theta))


def hadamard(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    h = 1.0 / math.sqrt(2.0)
    return torch.tensor([[h, h], [h, -h]], dtype=_COMPLEX_OF[dtype], device=device)


def swap(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(_SWAP, dtype=_COMPLEX_OF[dtype], device=device)


def xxphase_swap(theta: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """XXPhase(theta) @ SWAP on one adjacent pair (= SWAP @ XXPhase), the
    product at ``precision`` (a dot in the reference, so at a reduced class
    it rounds as the reference's does; ``ops/lowp.matmul``). The engines
    build the fused gate by exchanging columns 1 and 2 of XXPhase instead,
    exactly, as the reference's do."""
    return lowp.matmul(xxphase(theta), swap(theta.dtype, theta.device), precision)
