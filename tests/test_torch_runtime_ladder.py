"""The port's runtime_scaling ladder (``qml_cutensornet_tpu_torch/runs/
runtime_scaling.ladder``, the reference's ``runs/runtime_scaling/
weak_scaling_vmesh.py``) at world sizes 1 and 2 over gloo on the CPU (nq 6,
chi 8, d 6, 4 points a rank, one process a rank): each rung's Gram equals
the single-process build's (3e-5, the f32 ring bar of
``tests/test_torch_ring.py``), and ``results_weak_scaling.csv`` has the
reference's columns less its two TPU v5e projections."""

import json
import pathlib

import numpy as np
import pytest

from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix
from qml_cutensornet_tpu_torch.runs import common, runtime_scaling

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL_RING_F32 = 3e-5
KNOBS = ("QMLTPU_MESH", "NDEVS", "NQ", "CHI")


@pytest.fixture
def runs_dir(tmp_path, monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("QMLTPU_DEVICE", "cpu")
    monkeypatch.setenv("QMLTPU_RUNS_DIR", str(tmp_path / "runs"))
    return tmp_path / "runs" / "runtime_scaling"


def test_ladder_over_gloo(runs_dir, monkeypatch):
    monkeypatch.setenv("NDEVS", "1 2")
    monkeypatch.setenv("NQ", "6")
    monkeypatch.setenv("CHI", "8")
    out = runtime_scaling.ladder()
    em = entanglement_graph(6, 6)
    for n, K in out["grams"].items():
        feats = out["features"][n]
        assert feats.shape == (4 * n, 6)
        single = build_kernel_matrix(KernelStateAnsatz(6, 2, 1.0, em), feats,
                                     cfg=SimConfig(chi=8, precision="f32"), sim_batch=32,
                                     tile=32, device="cpu")
        np.testing.assert_allclose(K, single, atol=TOL_RING_F32)
    # The reference's columns, less its two TPU v5e projections.
    ref_cols = (ROOT / "runs/runtime_scaling/results_weak_scaling.csv").read_text().splitlines()[0]
    want = [c for c in ref_cols.split(",") if not c.endswith("_v5e")]
    csv_path = runs_dir / runtime_scaling.LADDER_CSV
    assert csv_path.read_text().splitlines()[0].split(",") == want
    rows = common.read_csv(str(csv_path))
    assert [int(r["n_procs"]) for r in rows] == [1, 2]
    assert float(rows[0]["eff_program"]) == 1.0
    assert all(int(r["ici_bytes_per_step"]) == 4 * 6 * 8 * 2 * 8 * 8 for r in rows)
    assert all("gloo" in r["platform"] for r in rows)
    lines = [json.loads(x) for x in (runs_dir / "runs.jsonl").read_text().splitlines()]
    assert [x["ladder"] for x in lines] == [1, 2]
    assert all(x["sim_s"] > 0 and x["ring_s"] > 0 for x in lines)
