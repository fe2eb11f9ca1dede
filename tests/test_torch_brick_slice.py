"""The brick slice of the PyTorch port end to end on the CPU:
``build_kernel_matrix`` with ``routing="brick"`` against the reference's
(f32 with the fused gate on, where every pair update from chi 16 is kernel
K5's plain version against the reference's K5 in interpret mode, and off,
where the split is K1's plain version against the reference's XLA route;
f64 against the reference's f64 and the dense statevector model), and
``cli.main_no_test`` with ``QMLTPU_ROUTING=brick`` against the reference's
CLI on the same argv.

Size: 8 qubits, d 2, 4 points, chi 16 (6 qubits for the CLI). Tolerances:
3e-5 in f32, the reference's own fused-vs-unfused Gram bar
(tests/test_pallas_gate_split.py); 1e-10 in f64 (roundoff of a run that
truncates nothing)."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from qml_cutensornet_tpu.cli import _pipeline as ref_pipe
from qml_cutensornet_tpu.cli import main_no_test as ref_main_no_test
from qml_cutensornet_tpu.config import SimConfig as RefConfig
from qml_cutensornet_tpu.models.ansatz import KernelStateAnsatz as RefAnsatz
from qml_cutensornet_tpu.models.gram import build_kernel_matrix as ref_build
from qml_cutensornet_tpu.ops import dense
from qml_cutensornet_tpu_torch.cli import main_no_test
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix
from qml_cutensornet_tpu_torch.ops import _build
from qml_cutensornet_tpu_torch.utils.data import preprocess_elliptic

ROOT = pathlib.Path(__file__).resolve().parents[1]
NQ, D, CHI = 8, 2, 16


def _grams(X, reps, rcfg):
    em = entanglement_graph(NQ, D)
    K_ref = ref_build(RefAnsatz(NQ, reps, 1.0, em, routing="brick"), X, cfg=rcfg,
                      sim_batch=4, tile=4)
    _build.reset_counters()
    K = build_kernel_matrix(KernelStateAnsatz(NQ, reps, 1.0, em, routing="brick"), X,
                            cfg=SimConfig.from_reference(dataclasses.asdict(rcfg)),
                            sim_batch=4, tile=4, device="cpu")
    assert sum(_build.LAUNCHES.values()) == 0  # CPU tensors: plain versions only
    return K, K_ref, np.array([[dense.kernel_entry(a, b, reps, 1.0, em) for b in X] for a in X])


@pytest.mark.parametrize("fused_gate", [True, False])
def test_f32_brick_gram_matches_reference(fused_gate):
    X = np.random.default_rng(4).uniform(0.0, 2.0, size=(4, NQ))
    rcfg = RefConfig(chi=CHI, precision="f32", svd_method="subspace", subspace_iters=2,
                     fused_split=True, fused_gate=fused_gate, fused_interpret=fused_gate)
    K, K_ref, K_dense = _grams(X, 2, rcfg)
    np.testing.assert_allclose(K, K_ref, atol=3e-5)
    np.testing.assert_allclose(K, K_dense, atol=3e-5)


@pytest.mark.parametrize("reps", [1, 2])
def test_f64_brick_gram_matches_reference_and_dense(reps):
    X = np.random.default_rng(5).uniform(0.0, 2.0, size=(3, NQ))
    rcfg = RefConfig(chi=CHI, precision="f64", svd_method="subspace", subspace_iters=2,
                     fused_split=True)
    K, K_ref, K_dense = _grams(X, reps, rcfg)
    np.testing.assert_allclose(K, K_dense, atol=1e-10)
    if reps == 1:
        # at r 2 the reference's own f64 run is 7e-11 from the dense model
        np.testing.assert_allclose(K, K_ref, atol=1e-10)


def test_cli_main_no_test_brick_matches_reference(tmp_path, monkeypatch):
    """Both CLIs on ``QMLTPU_ROUTING=brick`` with the fused gate at chi 16,
    staging off: every pair update is K5 (its plain version here, the
    reference's in interpret mode). Same saved files, Gram within 3e-5,
    same profiling keys, fidelity and chi statistics."""
    for key, value in {"QMLTPU_DEVICE": "cpu", "QMLTPU_ROUTING": "brick", "QMLTPU_CHI": "16",
                       "QMLTPU_STAGED": "0", "QMLTPU_FUSED_GATE": "1"}.items():
        monkeypatch.setenv(key, value)
    real_sim_config = ref_pipe.sim_config
    monkeypatch.setattr(ref_pipe, "sim_config", lambda *a, **k: dataclasses.replace(
        real_sim_config(*a, **k), fused_interpret=True))
    argv = ["main_no_test", "GPU", "6", "1", "1.0", "2", "5", "5", "1", "v1.csv"]
    info = "train_Nf6_r1_g1.0_p0.0_nn2_mslinear_Ntr5_s1_v1"
    out = {}
    for side, entry in (("port", main_no_test), ("ref", ref_main_no_test)):
        work = tmp_path / side
        (work / "datasets").mkdir(parents=True)
        monkeypatch.chdir(work)
        preprocess_elliptic(str(ROOT / "datasets/elliptic_bitcoin_dataset_v1"), "datasets/v1.csv")
        _build.reset_counters()
        entry.main(list(argv))
        out[side] = (np.load(work / f"kernels/{info}.npy"),
                     json.loads((work / f"{info}.json").read_text()))
    (K, prof), (K_ref, ref_prof) = out["port"], out["ref"]
    assert K.shape == K_ref.shape == (8, 8)
    np.testing.assert_allclose(K, K_ref, atol=3e-5)
    assert set(prof) == set(ref_prof)
    for key in ("avg_fidelity", "ave max chi x", "chi", "lenX"):
        np.testing.assert_allclose(prof[key][0], ref_prof[key][0], rtol=1e-6)


def test_site_sharded_brick_raises(monkeypatch):
    """The site-sharded brick engine's knob, decided by the CLI's engine
    setup: ``QMLTPU_SHARD_MPS=2`` outside a process group raises naming
    torchrun (it never runs on one device instead); beside ``QMLTPU_MESH=2``
    (a ring) it raises; ``"all"`` outside a group gives a mesh of one, on
    which the brick engine equals the whole-chain engine's Gram to the bit,
    and which a tracked schedule refuses, naming the brick routing."""
    from qml_cutensornet_tpu_torch.cli import _pipeline
    from qml_cutensornet_tpu_torch.models.simulate import make_chunked_simulator

    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "QMLTPU_MESH"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("QMLTPU_DEVICE", "cpu")
    monkeypatch.setenv("QMLTPU_ROUTING", "brick")
    ans = KernelStateAnsatz(4, 1, 1.0, entanglement_graph(4, 1), routing="brick")
    X = np.random.default_rng(0).uniform(0, 2, size=(3, 4))
    cfg = SimConfig(chi=4, svd_method="subspace")
    K_whole = build_kernel_matrix(ans, X, cfg=cfg, device="cpu")
    monkeypatch.setenv("QMLTPU_SHARD_MPS", "2")
    with pytest.raises(RuntimeError, match="torchrun"):
        _pipeline.engine_kwargs()
    monkeypatch.setenv("QMLTPU_SHARD_MPS", "all")
    monkeypatch.setenv("QMLTPU_MESH", "2")
    with pytest.raises(ValueError, match="QMLTPU_SHARD_MPS"):
        _pipeline.engine_kwargs()
    monkeypatch.delenv("QMLTPU_MESH")
    kwargs = _pipeline.engine_kwargs()
    assert "mesh" not in kwargs
    K = build_kernel_matrix(ans, X, cfg=cfg, site_mesh=kwargs["site_mesh"], device="cpu")
    np.testing.assert_array_equal(K, K_whole)
    tracked = KernelStateAnsatz(4, 1, 1.0, entanglement_graph(4, 1)).schedule
    with pytest.raises(ValueError, match="QMLTPU_ROUTING=brick"):
        make_chunked_simulator(tracked, cfg, torch.device("cpu"), site_mesh=kwargs["site_mesh"])
