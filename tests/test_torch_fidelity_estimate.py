"""The port's f32 ``avg_fidelity`` against the JAX package's.

``avg_fidelity`` is the mean over circuits of the product of ``min(kept /
total, 1)`` over the truncating splits (the reference's ``ops/svd.py``
``_mask_from_s2``, ``ops/mps.py``). On the subspace routes the reference
sums ``kept`` from the row norms of ``q^H theta``, whose f32 rounding (the
basis is orthonormal only to f32) is noise of either sign about the exact
ratio; most splits truncate nothing, their exact ratio is 1, and the clamp
keeps only the low half of the noise. The port takes ``kept = total -
discarded`` with the discarded weight summed from small terms
(``ops/svd._kept_fraction``), equal in exact arithmetic; on the fused-gate
and brick routes ``||theta - q r||^2`` comes from kernels K4 and K5 (here
their plain versions).

At 12 qubits, chi 16 (staged chi, subspace iters 2, tile_block 2, one sim
batch of 4 points from ``default_rng(1)``; the settings of
``tests/test_torch_f32_bonds.py``), the reference runs in f32 through its
Pallas BCGS2 bodies in interpret mode, the port in f32 and f64:

- the port's f32 figure is no farther from the port's f64 figure than the
  reference's f32 figure is, plus 1e-6 (the margin is computed here, from
  the reference's own error on the default route); so are the port's
  fused-gate route (K4) and fused brick route (K5), each against its own
  f64 figure (the fused gate truncates other splits than the default route
  in both packages: its states lose more weight);
- both f32 runs keep the same ``ave max chi x``, and their Grams agree
  within 3e-5 (the reference's fused-vs-unfused Gram bar);
- in f64 the residual form equals the row-norm form split by split (the
  two differ only by rounding)."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from qml_cutensornet_tpu.config import SimConfig as RefConfig
from qml_cutensornet_tpu.models.ansatz import KernelStateAnsatz as RefAnsatz
from qml_cutensornet_tpu.models.gram import build_kernel_matrix as ref_build
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix
from qml_cutensornet_tpu_torch.ops import orth, svd

NQ, REPS, D, CHI, N = 12, 2, 6, 16, 4
# (name suffix, routing, fused gate): the default route (K1), K4, K5
ROUTES = [("", "tracked", False), ("_gate", "tracked", True), ("_brick", "brick", True)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{name: (K, profile)}`` for the reference in f32 and the port in f32
    and f64."""
    out = tmp_path_factory.mktemp("fidelity")
    mp = pytest.MonkeyPatch()
    mp.chdir(out)
    mp.setenv("QMLTPU_STAGED", "1")
    try:
        X = np.random.default_rng(1).uniform(0.0, 2.0, size=(N, NQ))
        em = entanglement_graph(NQ, D)
        rcfg = RefConfig(chi=CHI, precision="f32", svd_method="subspace", subspace_iters=2,
                         tile_block=2, fused_split=True, fused_interpret=True)
        res = {"ref_f32": ref_build(RefAnsatz(NQ, REPS, 1.0, em), X, cfg=rcfg, sim_batch=N,
                                    tile=N, info_file="ref_f32")}
        for route, routing, gate in ROUTES:
            for prec in ("f32", "f64"):
                cfg = dataclasses.replace(SimConfig.from_reference(dataclasses.asdict(rcfg)),
                                          precision=prec, fused_gate=gate)
                res[f"port{route}_{prec}"] = build_kernel_matrix(
                    KernelStateAnsatz(NQ, REPS, 1.0, em, routing=routing), X, cfg=cfg,
                    sim_batch=N, tile=N, device="cpu", info_file=f"port{route}_{prec}")
        return {name: (K, json.loads(pathlib.Path(f"{name}.json").read_text()))
                for name, K in res.items()}
    finally:
        mp.undo()


def _fid(runs, name):
    return runs[name][1]["avg_fidelity"][0]


@pytest.mark.parametrize("route", [r[0] for r in ROUTES])
def test_port_f32_fidelity_no_farther_from_f64_than_the_reference(runs, route):
    margin = abs(_fid(runs, "ref_f32") - _fid(runs, "port_f64")) + 1e-6
    f32, f64 = _fid(runs, f"port{route}_f32"), _fid(runs, f"port{route}_f64")
    assert abs(f32 - f64) <= margin, (f32, f64, margin)


def test_f32_runs_keep_the_same_bonds(runs):
    assert runs["port_f32"][1]["ave max chi x"][0] == runs["ref_f32"][1]["ave max chi x"][0]


def test_f32_grams_agree(runs):
    np.testing.assert_allclose(runs["port_f32"][0], runs["ref_f32"][0], atol=3e-5)


@pytest.mark.parametrize("oversample", [0, 4])
def test_residual_form_equals_the_row_norm_form_in_f64(oversample):
    """Random rank-deficient thetas, truncated: the kept fraction from the
    residual equals the mask's ``sum(s2[mask]) / total`` to f64 rounding."""
    rng = np.random.default_rng(4)
    B, m, k, rank, keep = 6, 24, 20, 14, 8
    a = rng.normal(size=(B, m, rank)) + 1j * rng.normal(size=(B, m, rank))
    b = rng.normal(size=(B, rank, k)) + 1j * rng.normal(size=(B, rank, k))
    theta = torch.from_numpy(a @ b)
    cfg = SimConfig(chi=keep, precision="f64", svd_method="subspace", subspace_iters=3,
                    oversample=oversample, fused_split=True)
    _, _, kf, _ = svd.truncated_svd(theta, cfg, keep)
    nc = keep + oversample
    q, r = svd.split.subspace_factor(theta, svd.start_block(m, nc, theta.dtype, theta.device),
                                     3)
    total = orth.abs2(theta).sum((1, 2))
    _, _, kf_rows, _ = svd._finish_subspace(q, r, total, cfg, keep, nc)
    assert float(kf.min()) < 0.99  # the splits truncate
    np.testing.assert_allclose(kf.numpy(), kf_rows.numpy(), rtol=0, atol=1e-12)
