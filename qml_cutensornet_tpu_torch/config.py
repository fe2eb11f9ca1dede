"""Simulation configuration (port of ``qml_cutensornet_tpu/config.py``).

Same field names, defaults and validation as the reference ``SimConfig``,
with torch dtypes in place of the JAX real dtypes. The port runs native
complex tensors: ``precision`` names the real dtype under them ("f32" ->
complex64, "f64" -> complex128).

The three precision fields take every string the reference takes. JAX
folds them into three classes, which the port computes as the reference's
TPU does (``ops/lowp.py``): full f32 ("highest", "float32"), three bf16
passes ("high", "bfloat16_3x", "tensorfloat32": each f32 split into a bf16
high and low part, ``hi*hi + hi*lo + lo*hi`` accumulated in f32) and one
bf16 pass ("bfloat16", "default"); never TF32, which stays off
(``utils/device.py``). ``matmul_precision`` is the ambient class: the
reference runs every simulator under
``jax.default_matmul_precision(matmul_precision)``, and the port passes it
to every product of the engine that is an XLA dot there (the gates, theta,
the center moves' products, the unfused split's right factor and the
blocked orthonormalizer's projections, the svd and eigh glue, the brick
update, the transfer-matrix contractions; ``ops/lowp.matmul``).
``power_precision`` covers the subspace power products
(``ops/svd._split_subspace``) and ``tile_precision`` the Gram tiles'
products and the state norms (``models/simulate``,
:attr:`SimConfig.resolved_tile_precision`); "inherit" takes the ambient
class. A reduced class runs on kernel K7, a bf16 tensor-core complex
product; the factorizations (``torch.linalg`` svd, eigh) and the kernels
K2 and K3 stay at full precision, as the reference's are not dots or pin
their dots at HIGHEST, and a configuration with a reduced ambient or power
class stays off K1, K4 and K5, as in the reference. Under complex128
(``precision="f64"``) every class computes in full f64, as XLA computes f64
dots whatever their precision. The CLIs take no ambient class (the
reference's read none either): set it through :class:`SimConfig`, e.g.
``build_kernel_matrix(ansatz, X, cfg=SimConfig(..., matmul_precision=
"high"))``.

``mgs_pair`` (the block-2 in-panel step of kernels K1 to K5) and
``brick_struct_caps`` (the brick engine's structural bond caps) run, off by
default as in the reference. All three ``svd_method`` values run, with the
reference's dataclass default "svd" (the CLI's default is "subspace", in
both packages): "subspace" through the kernels below, "svd" and "eigh"
through ``torch.linalg`` (cuSOLVER on the card). ``fused_split`` and
``fused_gate`` mean what they mean in the reference: ``fused_split`` routes
the subspace split through kernel K1 and the center move through K2 (off:
kernel K3 and matrix products, the reference's unfused chain), and
``fused_gate`` on top of it routes the subspace two-site update through K4.
As in the reference the dataclass default of both is off and the CLI turns
``fused_split`` on; a reduced ``matmul_precision`` or a
``power_precision`` other than "inherit" keeps a configuration off K1, K4
and K5 (the reference's ``ops/svd.py:199-207``, ``:313``, ``:386``), while
K2 and K3 stay on. ``fused_interpret`` (Pallas interpret mode) has no counterpart and is dropped;
:meth:`SimConfig.from_reference` discards it.
"""

from __future__ import annotations

import dataclasses

import torch

_REAL_DTYPES = {"f32": torch.float32, "f64": torch.float64}
_COMPLEX_DTYPES = {"f32": torch.complex64, "f64": torch.complex128}
_PRECISIONS = ("highest", "float32", "high", "bfloat16_3x", "tensorfloat32",
               "bfloat16", "default")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static configuration for the MPS engine; see the reference
    ``qml_cutensornet_tpu.config.SimConfig`` for the meaning of each field."""

    chi: int = 64
    truncation_error: float = 1e-16
    criterion: str = "fidelity"
    value_of_zero: float = 0.0
    precision: str = "f32"
    svd_method: str = "svd"
    renormalize: bool = False
    subspace_iters: int = 2
    oversample: int = 0
    matmul_precision: str = "highest"
    power_precision: str = "inherit"
    tile_precision: str = "inherit"
    tile_block: int = 1
    fused_split: bool = False
    mgs_pair: bool = False
    fused_gate: bool = False
    brick_struct_caps: bool = False

    def __post_init__(self):
        if self.criterion not in ("fidelity", "cutoff"):
            raise ValueError(f"Unknown truncation criterion: {self.criterion}")
        if self.svd_method not in ("svd", "eigh", "subspace"):
            raise ValueError(f"Unknown svd_method: {self.svd_method}")
        if self.precision not in _REAL_DTYPES:
            raise ValueError(f"Unknown precision: {self.precision}")
        if self.matmul_precision not in _PRECISIONS:
            raise ValueError(f"Unknown matmul_precision: {self.matmul_precision}")
        if self.power_precision not in ("inherit",) + _PRECISIONS:
            raise ValueError(f"Unknown power_precision: {self.power_precision}")
        if self.tile_precision not in ("inherit",) + _PRECISIONS:
            raise ValueError(f"Unknown tile_precision: {self.tile_precision}")
        if self.chi < 1:
            raise ValueError("chi must be >= 1")
        if self.oversample < 0:
            raise ValueError("oversample must be >= 0")
        if not 1 <= self.tile_block <= 8:
            raise ValueError("tile_block must be in 1..8")

    @property
    def real_dtype(self) -> torch.dtype:
        return _REAL_DTYPES[self.precision]

    @property
    def complex_dtype(self) -> torch.dtype:
        return _COMPLEX_DTYPES[self.precision]

    @property
    def resolved_tile_precision(self) -> str:
        return (self.matmul_precision if self.tile_precision == "inherit"
                else self.tile_precision)

    @property
    def resolved_power_precision(self) -> str:
        return (self.matmul_precision if self.power_precision == "inherit"
                else self.power_precision)

    @classmethod
    def from_reference(cls, fields: dict) -> "SimConfig":
        """Build from the reference config's fields (e.g.
        ``dataclasses.asdict(jax_cfg)``). ``fused_interpret`` is dropped: it
        selects Pallas interpret mode, which has no counterpart here."""
        names = {f.name for f in dataclasses.fields(cls)}
        extra = set(fields) - names - {"fused_interpret"}
        if extra:
            raise ValueError(f"unknown SimConfig fields: {sorted(extra)}")
        return cls(**{k: v for k, v in fields.items() if k in names})
