"""Automatic bond-dimension selection (port of
``qml_cutensornet_tpu/utils/autotune.py``).

The engine runs at a bond cap fixed up front, so this probes a sample of
datapoints at doubling caps until the accumulated truncation fidelity clears
a target: each probe is one batched run of the chunked simulator over the
sample (``QMLTPU_CHI=auto`` in ``cli/_pipeline``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.simulate import make_chunked_simulator
from qml_cutensornet_tpu_torch.utils.device import resolve_device


def choose_chi(
    schedule,
    sample_features: np.ndarray,
    cfg: SimConfig,
    fidelity_target: float = 1.0 - 1e-6,
    chi_start: int = 8,
    chi_max: int = 256,
    verbose: bool = False,
    device: str = "cuda",
) -> int:
    """Smallest chi in {chi_start, 2*chi_start, ...} <= chi_max whose MIN
    sample fidelity reaches ``fidelity_target`` (or the last probed chi when
    doubling would pass ``chi_max``). Also stops when no state saturates the
    cap (chi was not the binding constraint). ``verbose`` prints each
    probe's chi, min fidelity and max bond."""
    dev = resolve_device(device)
    x = np.asarray(sample_features, dtype=np.float64)
    chi = chi_start
    while True:
        probe_cfg = dataclasses.replace(cfg, chi=int(chi))
        out = make_chunked_simulator(schedule, probe_cfg, dev)(x)
        min_fid = float(out.fidelity.min())
        max_bond = int(out.bond_dims.max())
        if verbose:
            print(f"choose_chi: chi={chi} min_fidelity={min_fid:.3e} max_bond={max_bond}")
        if min_fid >= fidelity_target or max_bond < chi or 2 * chi > chi_max:
            return int(chi)
        chi *= 2
