"""The port's full classification run (``cli.main``: train Gram, test Gram,
SVC sweep) on the CPU against the reference's ``cli.main``, on the default,
the fused-gate and the unfused route, and the port's ``cli.classical_main``
against the reference's; then the rectangular (test) Gram against the dense
statevector model.

Size: 6 qubits, 10 + 10 points of the pinned v1 data, bond cap 16 without
staging, so that every two-site update of the fused-gate route is one the
gate kernel takes (its plain version here). The reference runs with
``fused_interpret`` on (set by this test around its ``sim_config``; the
reference's CLI has no knob for it), so its Pallas kernels run in interpret
mode on the same routes.

Tolerances: kernels 3e-5, the reference's own fused-vs-unfused Gram bar
(tests/test_pallas_gate_split.py); sweep rows equal (the metrics are
arithmetic on equal predictions); f64 rectangular Gram 1e-10 (roundoff of
an untruncated run)."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

from qml_cutensornet_tpu.cli import _pipeline as ref_pipe
from qml_cutensornet_tpu.cli import classical_main as ref_classical_main
from qml_cutensornet_tpu.cli import main as ref_main
from qml_cutensornet_tpu.ops import dense
from qml_cutensornet_tpu_torch.cli import classical_main, main
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix
from qml_cutensornet_tpu_torch.ops import _build
from qml_cutensornet_tpu_torch.utils.data import load_and_prepare, preprocess_elliptic

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGV = ["main", "GPU", "6", "1", "1.0", "1", "10", "10", "1", "v1.csv"]
TRAIN = "train_Nf6_r1_g1.0_p0.0_nn1_mslinear_Ntr10_s1_v1"
TEST = "test_Nf6_r1_g1.0_p0.0_nn1_mslinear_Ntr10_s1_v1"

ROUTES = {
    "default": {},
    "fused_gate": {"QMLTPU_FUSED_GATE": "1"},
    "unfused": {"QMLTPU_FUSED_SPLIT": "0"},
}


def _files(root: pathlib.Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()
                  and "datasets" not in p.parts)


@pytest.mark.filterwarnings("ignore::sklearn.exceptions.UndefinedMetricWarning")
@pytest.mark.parametrize("route", list(ROUTES))
def test_cli_main_matches_reference(tmp_path, monkeypatch, route):
    for key, value in {"QMLTPU_DEVICE": "cpu", "QMLTPU_CHI": "16", "QMLTPU_STAGED": "0",
                       **ROUTES[route]}.items():
        monkeypatch.setenv(key, value)
    if route == "fused_gate":
        real_sim_config = ref_pipe.sim_config
        monkeypatch.setattr(ref_pipe, "sim_config", lambda *a, **k: dataclasses.replace(
            real_sim_config(*a, **k), fused_interpret=True))
    out = {}
    for side, entry in (("port", main), ("ref", ref_main)):
        work = tmp_path / side
        (work / "datasets").mkdir(parents=True)
        monkeypatch.chdir(work)
        preprocess_elliptic(str(ROOT / "datasets/elliptic_bitcoin_dataset_v1"), "datasets/v1.csv")
        _build.reset_counters()
        returned = entry.main(list(ARGV))
        out[side] = {name: np.load(work / name) for name in _files(work) if name.endswith(".npy")}
        out[side]["files"] = _files(work)
        if side == "port":
            k_train, k_test, test_rows, train_rows = returned
            np.testing.assert_array_equal(k_train, out[side][f"kernels/{TRAIN}.npy"])
            np.testing.assert_array_equal(k_test, out[side][f"kernels/{TEST}.npy"])
            np.testing.assert_array_equal(np.asarray(test_rows), out[side][f"data/{TEST}.npy"])
            prof = json.loads((work / f"{TEST}.json").read_text())
            assert prof["lenX"] == [16, "entries"] and prof["lenY"] == [4, "entries"]
    assert out["port"]["files"] == out["ref"]["files"]
    assert f"kernels/{TRAIN}.npy" in out["port"]["files"] and f"data/{TEST}.npy" in out["port"]["files"]
    for name in (f"kernels/{TRAIN}.npy", f"kernels/{TEST}.npy"):
        assert out["port"][name].shape == out["ref"][name].shape
        np.testing.assert_allclose(out["port"][name], out["ref"][name], atol=3e-5, err_msg=name)
    assert out["port"][f"kernels/{TEST}.npy"].shape == (4, 16)
    for name in (f"data/{TRAIN}.npy", f"data/{TEST}.npy"):
        assert out["port"][name].shape == (11, 5)
        np.testing.assert_allclose(out["port"][name], out["ref"][name], atol=1e-12, err_msg=name)
    # and against the exact model: chi 16 holds 6 qubits without truncation
    x_train, _, x_test, _ = load_and_prepare(str(tmp_path / "port/datasets/v1.csv"), 6, 10, 10, 1)
    em = entanglement_graph(6, 1)
    want = np.array([[dense.kernel_entry(a, b, 1, 1.0, em) for b in x_train] for a in x_test])
    np.testing.assert_allclose(out["port"][f"kernels/{TEST}.npy"], want, atol=1e-5)


@pytest.mark.filterwarnings("ignore::sklearn.exceptions.UndefinedMetricWarning")
def test_classical_main_matches_reference(tmp_path, monkeypatch):
    rows = {}
    for side, entry in (("port", classical_main), ("ref", ref_classical_main)):
        work = tmp_path / side
        (work / "datasets").mkdir(parents=True)
        monkeypatch.chdir(work)
        preprocess_elliptic(str(ROOT / "datasets/elliptic_bitcoin_dataset_v1"), "datasets/v1.csv")
        entry.main(["classical_main", "6", "10", "10", "1", "v1.csv"])
        rows[side] = np.load(work / "raw/gaussian/seed_1.npy")
    assert rows["port"].shape == (11, 5)
    np.testing.assert_allclose(rows["port"], rows["ref"], atol=1e-12)
    with pytest.raises(ValueError, match="classical_main.py"):
        classical_main.main(["classical_main", "6"])


@pytest.mark.parametrize("fused_split,fused_gate", [(True, False), (True, True), (False, False)])
def test_rectangular_gram_matches_dense_f64(fused_split, fused_gate):
    """``K[i, j] = |<psi(Y_i)|psi(X_j)>|^2`` with Y != X: orientation, shape
    and values against the dense model, on each route."""
    nq, reps, d = 8, 1, 2
    rng = np.random.default_rng(3)
    X, Y = rng.uniform(0.0, 2.0, size=(5, nq)), rng.uniform(0.0, 2.0, size=(3, nq))
    em = entanglement_graph(nq, d)
    cfg = SimConfig(chi=16, precision="f64", svd_method="subspace", fused_split=fused_split,
                    fused_gate=fused_gate)
    K = build_kernel_matrix(KernelStateAnsatz(nq, reps, 1.0, em), X, Y=Y, cfg=cfg,
                            sim_batch=4, tile=4, device="cpu")
    want = np.array([[dense.kernel_entry(y, x, reps, 1.0, em) for x in X] for y in Y])
    assert K.shape == (3, 5)
    np.testing.assert_allclose(K, want, atol=1e-10)
    with pytest.raises(ValueError, match="Swap input order"):
        build_kernel_matrix(KernelStateAnsatz(nq, reps, 1.0, em), Y, Y=X, cfg=cfg, device="cpu")
