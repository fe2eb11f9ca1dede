"""The PyTorch port's train-Gram slice end to end on the CPU: the port's
``build_kernel_matrix`` against the dense statevector model in f64 (1e-10,
roundoff of an untruncated chi-16 run) and against the JAX reference in
f32 with staged chi on (3e-5: the reference's own fused-vs-unfused Gram
bar, tests/test_pallas_split.py), the port CLI ``main_no_test`` on
``QMLTPU_DEVICE=cpu``, the knobs that reach the engine, and the knobs and
devices that must raise."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from qml_cutensornet_tpu.config import SimConfig as RefConfig
from qml_cutensornet_tpu.models.ansatz import KernelStateAnsatz as RefAnsatz
from qml_cutensornet_tpu.models.gram import build_kernel_matrix as ref_build
from qml_cutensornet_tpu.ops import dense
from qml_cutensornet_tpu_torch.cli import _pipeline, main_no_test
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix
from qml_cutensornet_tpu_torch.ops import _build
from qml_cutensornet_tpu_torch.utils import device as port_device
from qml_cutensornet_tpu_torch.utils.data import load_and_prepare, preprocess_elliptic

ROOT = pathlib.Path(__file__).resolve().parents[1]
NQ, REPS, D, CHI = 8, 1, 2, 16


def _points(seed, n=5):
    return np.random.default_rng(seed).uniform(0.0, 2.0, size=(n, NQ))


def _dense_kernel(X, reps, em):
    return np.array([[dense.kernel_entry(a, b, reps, 1.0, em) for b in X] for a in X])


def test_f64_gram_matches_dense():
    X = _points(0)
    em = entanglement_graph(NQ, D)
    K = build_kernel_matrix(KernelStateAnsatz(NQ, REPS, 1.0, em), X,
                            cfg=SimConfig(chi=CHI, precision="f64", svd_method="subspace"),
                            sim_batch=4, tile=4, device="cpu")
    np.testing.assert_allclose(K, _dense_kernel(X, REPS, em), atol=1e-10)


def test_f32_gram_matches_reference(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("QMLTPU_STAGED", "1")
    X = _points(1)
    em = entanglement_graph(NQ, D)
    rcfg = RefConfig(chi=CHI, precision="f32", svd_method="subspace", subspace_iters=2,
                     tile_block=2)
    K_ref = ref_build(RefAnsatz(NQ, REPS, 1.0, em), X, cfg=rcfg, sim_batch=4, tile=4,
                      info_file="ref")
    K = build_kernel_matrix(KernelStateAnsatz(NQ, REPS, 1.0, em), X,
                            cfg=SimConfig.from_reference(dataclasses.asdict(rcfg)),
                            sim_batch=4, tile=4, device="cpu", info_file="port")
    np.testing.assert_allclose(K, K_ref, atol=3e-5)
    np.testing.assert_allclose(K, _dense_kernel(X, REPS, em), atol=3e-5)
    port_prof = json.loads(pathlib.Path("port.json").read_text())
    ref_prof = json.loads(pathlib.Path("ref.json").read_text())
    assert set(port_prof) == set(ref_prof)
    for key in ("ave max chi x", "chi", "lenX"):
        np.testing.assert_allclose(port_prof[key][0], ref_prof[key][0], rtol=1e-6)
    # Chi 16 holds 8 qubits: no split truncates, so the exact avg_fidelity is
    # 1. The port's f32 estimate (the discarded weight, ops/svd._kept_fraction)
    # is held at the same 1e-6 to the reference's f64 run on the same points
    # and to 1, and no farther from 1 than the reference's f32 row-norm
    # estimate, whose clamped rounding reads low.
    ref_build(RefAnsatz(NQ, REPS, 1.0, em), X, cfg=dataclasses.replace(rcfg, precision="f64"),
              sim_batch=4, tile=4, info_file="ref_f64")
    ref_f64_fid = json.loads(pathlib.Path("ref_f64.json").read_text())["avg_fidelity"][0]
    port_fid, ref_fid = port_prof["avg_fidelity"][0], ref_prof["avg_fidelity"][0]
    np.testing.assert_allclose(port_fid, ref_f64_fid, rtol=1e-6)
    np.testing.assert_allclose(port_fid, 1.0, rtol=1e-6)
    assert abs(port_fid - 1.0) <= abs(ref_fid - 1.0), (port_fid, ref_fid)


def test_cli_main_no_test_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("QMLTPU_DEVICE", "cpu")
    preprocess_elliptic(str(ROOT / "datasets/elliptic_bitcoin_dataset_v1"), "datasets/v1.csv")
    argv = ["main_no_test", "GPU", "6", "1", "1.0", "1", "5", "5", "1", "v1.csv"]
    K = main_no_test.main(argv)
    x_train = load_and_prepare("datasets/v1.csv", 6, 5, 5, 1)[0]
    # chi defaults to min(2^(6//2), 64) = 8: exact for 6 qubits.
    np.testing.assert_allclose(K, _dense_kernel(x_train, 1, entanglement_graph(6, 1)),
                               atol=1e-5)
    info = "train_Nf6_r1_g1.0_p0.0_nn1_mslinear_Ntr5_s1_v1"
    np.testing.assert_array_equal(np.load(f"kernels/{info}.npy"), K)
    assert json.loads(pathlib.Path(f"{info}.json").read_text())["lenX"] == [8, "entries"]


@pytest.mark.parametrize("knob,value,routing", [
    pytest.param("QMLTPU_MESH", "2", "tracked", id="QMLTPU_MESH-2"),
    pytest.param("QMLTPU_SHARD_MPS", "all", "brick", id="QMLTPU_SHARD_MPS-all"),
    pytest.param("QMLTPU_SHARD_MPS", "all", "tracked", id="QMLTPU_SHARD_MPS-all-tracked"),
])
def test_unported_knobs_raise(monkeypatch, knob, value, routing):
    """The multi-device knobs outside a process group: QMLTPU_MESH > 1 (the
    ring) raises instead of running on one device; QMLTPU_SHARD_MPS (the
    site-sharded brick engine) raises naming the brick routing under any
    other routing, and under the brick routing runs a mesh of one with
    "all" (no ring), raises naming torchrun with N > 1, and raises beside
    QMLTPU_MESH=2."""
    monkeypatch.setenv(knob, value)
    monkeypatch.setenv("QMLTPU_DEVICE", "cpu")
    monkeypatch.setenv("QMLTPU_ROUTING", routing)
    for key in ("WORLD_SIZE", "QMLTPU_MESH" if knob != "QMLTPU_MESH" else "QMLTPU_SHARD_MPS"):
        monkeypatch.delenv(key, raising=False)
    argv = ["m", "GPU", "6", "1", "1.0", "1", "5", "5", "1", "v1.csv"]
    _pipeline.parse_argv(argv)
    if knob == "QMLTPU_MESH":
        with pytest.raises(RuntimeError, match="torchrun"):
            _pipeline.engine_kwargs()
        return
    if routing != "brick":
        with pytest.raises(ValueError, match="QMLTPU_ROUTING=brick"):
            _pipeline.engine_kwargs()
        return
    kwargs = _pipeline.engine_kwargs()
    assert "mesh" not in kwargs and kwargs["site_mesh"].size == 1
    assert _pipeline.n_procs(kwargs) == 1
    ans = KernelStateAnsatz(4, 1, 1.0, entanglement_graph(4, 1), routing="brick")
    X = np.random.default_rng(1).uniform(0, 2, size=(3, 4))
    cfg = SimConfig(chi=4, svd_method="subspace")
    K_sharded = build_kernel_matrix(ans, X, cfg=cfg, site_mesh=kwargs["site_mesh"], device="cpu")
    monkeypatch.setenv(knob, "0")
    assert "site_mesh" not in _pipeline.engine_kwargs()
    np.testing.assert_array_equal(K_sharded, build_kernel_matrix(ans, X, cfg=cfg, device="cpu"))
    monkeypatch.setenv(knob, "2")
    with pytest.raises(RuntimeError, match="torchrun"):
        _pipeline.engine_kwargs()
    monkeypatch.setenv(knob, "all")
    monkeypatch.setenv("QMLTPU_MESH", "2")
    with pytest.raises(ValueError, match="QMLTPU_SHARD_MPS"):
        _pipeline.engine_kwargs()


@pytest.mark.parametrize("knob,value,field,expected", [
    ("QMLTPU_FUSED_GATE", "1", "fused_gate", True),
    ("QMLTPU_FUSED_SPLIT", "0", "fused_split", False),
    ("QMLTPU_SVD", "svd", "svd_method", "svd"),
    ("QMLTPU_SVD", "eigh", "svd_method", "eigh"),
    ("QMLTPU_ROUTING", "reference", "routing", "reference"),
    ("QMLTPU_CHECKPOINT", "1", "checkpoint", True),
    ("QMLTPU_CHI", "auto", "chi", 8),
    ("QMLTPU_MGS_PAIR", "1", "mgs_pair", True),
    ("QMLTPU_BRICK_CAPS", "1", "brick_struct_caps", True),
])
def test_route_knobs_reach_the_config(monkeypatch, knob, value, field, expected):
    """Each knob reaches what the engine reads: the config fields it routes
    on, the schedule's routing, the Gram build's checkpoint flag, and the
    cap QMLTPU_CHI=auto probes (here at most 8: one probe on the CPU). Unset,
    the CLI runs the subspace method, fused_split on, fused_gate off,
    tracked routing, no checkpoint, and neither the pair step nor the brick
    caps."""
    monkeypatch.setenv("QMLTPU_DEVICE", "cpu")
    monkeypatch.setenv("QMLTPU_AUTO_CHI_MAX", "8")
    argv = ["m", "GPU", "6", "1", "1.0", "1", "5", "5", "1", "v1.csv"]
    sample = np.random.default_rng(0).uniform(0.0, 2.0, size=(8, 6))

    def read():
        params = _pipeline.parse_argv(argv)
        seen = dataclasses.asdict(_pipeline.sim_config(params, sample_features=sample))
        seen["routing"] = _pipeline.make_ansatz(params).schedule.routing
        seen["checkpoint"] = _pipeline.engine_kwargs()["checkpoint"]
        return seen

    default = read()
    assert (default["svd_method"], default["fused_split"], default["fused_gate"],
            default["routing"], default["checkpoint"], default["mgs_pair"],
            default["brick_struct_caps"]) == ("subspace", True, False, "tracked", False, False,
                                              False)
    monkeypatch.setenv(knob, value)
    assert read()[field] == expected


def test_cuda_device_without_card_raises(monkeypatch):
    """No silent CPU fallback: asking for CUDA where there is none raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="QMLTPU_DEVICE"):
        port_device.resolve_device("cuda")
    em = entanglement_graph(4, 1)
    with pytest.raises(RuntimeError):
        build_kernel_matrix(KernelStateAnsatz(4, 1, 1.0, em), np.ones((2, 4)),
                            cfg=SimConfig(chi=4), device="cuda")
