"""Simulation configuration (port of ``qml_cutensornet_tpu/config.py``).

Same field names, defaults and validation as the reference ``SimConfig``,
with torch dtypes in place of the JAX real dtypes. The port runs native
complex tensors: ``precision`` names the real dtype under them ("f32" ->
complex64, "f64" -> complex128).

Fields whose behaviour the port does not implement raise on a non-default
value instead of being ignored: the reduced precisions
(``power_precision`` / ``tile_precision`` other than "inherit" / "highest",
``matmul_precision`` other than "highest" / "float32"). ``mgs_pair`` (the
block-2 in-panel step of kernels K1 to K5) and ``brick_struct_caps`` (the
brick engine's structural bond caps) run, off by default as in the
reference. All three ``svd_method`` values run, with the
reference's dataclass default "svd" (the CLI's default is "subspace", in
both packages): "subspace" through the kernels below, "svd" and "eigh"
through ``torch.linalg`` (cuSOLVER on the card). ``fused_split`` and
``fused_gate`` mean what they mean in the reference: ``fused_split`` routes
the subspace split through kernel K1 and the center move through K2 (off:
kernel K3 and matrix products, the reference's unfused chain), and
``fused_gate`` on top of it routes the subspace two-site update through K4.
As in the reference the dataclass default of both is off and the CLI turns
``fused_split`` on. ``fused_interpret`` (Pallas interpret mode) has no
counterpart and is dropped; :meth:`SimConfig.from_reference` discards it.
"""

from __future__ import annotations

import dataclasses

import torch

_REAL_DTYPES = {"f32": torch.float32, "f64": torch.float64}
_COMPLEX_DTYPES = {"f32": torch.complex64, "f64": torch.complex128}
_PRECISIONS = ("highest", "float32", "high", "bfloat16_3x", "tensorfloat32",
               "bfloat16", "default")
# Precisions the port runs: full f32 accumulation only (TF32 stays off,
# utils/device.py).
_FULL_PRECISION = ("inherit", "highest", "float32")


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
        # The reduced precisions, which the port does not implement.
        for name in ("power_precision", "tile_precision"):
            if getattr(self, name) not in _FULL_PRECISION:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported; the port "
                    "runs full f32 accumulation ('inherit' or 'highest')")
        if self.matmul_precision not in ("highest", "float32"):
            raise NotImplementedError(
                f"matmul_precision={self.matmul_precision!r} is not ported; "
                "the port runs full f32 accumulation")

    @property
    def real_dtype(self) -> torch.dtype:
        return _REAL_DTYPES[self.precision]

    @property
    def complex_dtype(self) -> torch.dtype:
        return _COMPLEX_DTYPES[self.precision]

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
