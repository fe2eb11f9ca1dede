"""Why f32 keeps fewer bonds than f64: the reference's own f32 truncation,
not a fault of the port.

At the same settings the port's f32 run keeps a smaller ``ave max chi x``
than its f64 run. This file runs the JAX reference in f32 with its Pallas
BCGS2 kernels in interpret mode (``fused_split=True, fused_interpret=True``)
and the port's plain versions in f32 and f64 on the same seeded points
(8 qubits, r=2, d=6, chi 16, staged chi, subspace iters 2, one sim batch of
4), and pins the answer: the port's f32 run keeps exactly the reference's
bonds, its f64 run keeps more (the f32 truncation mask's singular-value
ratio floor is 2e-5, f64's 1e-10), and the two f32 Grams agree within 3e-5
(the reference's fused-vs-unfused Gram bar, tests/test_pallas_split.py)."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

from qml_cutensornet_tpu.config import SimConfig as RefConfig
from qml_cutensornet_tpu.models.ansatz import KernelStateAnsatz as RefAnsatz
from qml_cutensornet_tpu.models.gram import build_kernel_matrix as ref_build
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix

NQ, REPS, D, CHI, N = 8, 2, 6, 16, 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{name: (K, ave max chi x)}`` for the reference in f32 and the port
    in f32 and f64."""
    out = tmp_path_factory.mktemp("bonds")
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
        for prec in ("f32", "f64"):
            cfg = dataclasses.replace(SimConfig.from_reference(dataclasses.asdict(rcfg)),
                                      precision=prec)
            res[f"port_{prec}"] = build_kernel_matrix(
                KernelStateAnsatz(NQ, REPS, 1.0, em), X, cfg=cfg, sim_batch=N, tile=N,
                device="cpu", info_file=f"port_{prec}")
        return {name: (K, json.loads(pathlib.Path(f"{name}.json").read_text())["ave max chi x"][0])
                for name, K in res.items()}
    finally:
        mp.undo()


def test_port_f32_keeps_the_references_bonds(runs):
    assert runs["port_f32"][1] == runs["ref_f32"][1]


def test_port_f64_keeps_more_bonds_than_f32(runs):
    assert runs["port_f64"][1] > runs["port_f32"][1]


def test_f32_grams_agree(runs):
    np.testing.assert_allclose(runs["port_f32"][0], runs["ref_f32"][0], atol=3e-5)
