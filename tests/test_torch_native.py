"""The port's native C++ CPU engine (``native/``) and its tile scheduler
(``backends/cpu_native``) against the JAX package's: the source is a byte
copy, both libraries are built from it, so tiles and Grams agree to the bit;
the checkpoint file, resume and profiling keys are the reference's; the
native Gram is within 1e-6 of the port's f64 torch engine (the reference's
own cross-check, ``tests/test_cpu_native_backend.py``). Skips only where
g++ or the system LAPACK is missing, as the reference's tests do.

Size: the reference's tests' (5 and 6 qubits, r 2, 3 to 10 points)."""

import ctypes
import json
import pathlib
import shutil

import numpy as np
import pytest

import qml_cutensornet_tpu as q
from qml_cutensornet_tpu import native as ref_native
from qml_cutensornet_tpu.backends import cpu_native as ref_cpu_native
from qml_cutensornet_tpu_torch import native
from qml_cutensornet_tpu_torch.backends import cpu_native
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix

ROOT = pathlib.Path(__file__).resolve().parents[1]
NQ, REPS, NN, GAMMA = 6, 2, 2, 0.8


def _toolchain_missing():
    if shutil.which("g++") is None:
        return "g++ not found"
    for lib in ("liblapack.so.3", "libblas.so.3"):
        try:
            ctypes.CDLL(lib)
        except OSError as e:
            return f"{lib}: {e}"
    return None


@pytest.fixture(scope="module")
def built():
    missing = _toolchain_missing()
    if missing:
        pytest.skip(f"native build unavailable: {missing}")
    lib = native.load()  # with the toolchain present, a failed build fails the test
    assert lib.qk_version() == 1
    ref_native.load()
    return lib


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 2, size=(10, NQ))
    port = KernelStateAnsatz(NQ, REPS, GAMMA, entanglement_graph(NQ, NN))
    ref = q.KernelStateAnsatz(NQ, REPS, GAMMA, q.entanglement_graph(NQ, NN))
    return port, ref, X


def test_source_is_a_byte_copy():
    ours = ROOT / "qml_cutensornet_tpu_torch/native/qk_native.cpp"
    assert ours.read_bytes() == (ROOT / "qml_cutensornet_tpu/native/qk_native.cpp").read_bytes()
    assert native.OPCODES == ref_native.OPCODES


@pytest.mark.parametrize("chi_cap", [0, 4])
def test_compute_tile_equals_reference(built, problem, chi_cap):
    port, ref, X = problem
    xs = [port.circuit_for_data(x) for x in X[:4]]
    ys = [port.circuit_for_data(x) for x in X[4:7]]
    assert xs == [ref.circuit_for_data(x) for x in X[:4]]
    for y in (None, ys):
        got = native.compute_tile(NQ, xs, y, cutoff=1e-16, chi_cap=chi_cap)
        want = ref_native.compute_tile(NQ, xs, y, cutoff=1e-16, chi_cap=chi_cap)
        for a, b in zip(got[:5], want[:5]):  # tile, chis, fidelities (not the timings)
            np.testing.assert_array_equal(a, b)
    assert got[0].shape == (3, 4)


@pytest.mark.parametrize("rect", [False, True])
def test_cpu_native_equals_reference(built, problem, tmp_path, rect):
    port, ref, X = problem
    Y = X[:4] if rect else None
    K = cpu_native.build_kernel_matrix(port, X, Y=Y, info_file=str(tmp_path / "port"),
                                       number_of_tiles=4, checkpoint_dir=str(tmp_path))
    K_ref = ref_cpu_native.build_kernel_matrix(ref, X, Y=Y, info_file=str(tmp_path / "ref"),
                                               number_of_tiles=4, checkpoint_dir=str(tmp_path))
    assert K.shape == ((4, 10) if rect else (10, 10))
    np.testing.assert_array_equal(K, K_ref)
    prof = json.loads((tmp_path / "port.json").read_text())
    prof_ref = json.loads((tmp_path / "ref.json").read_text())
    assert set(prof) == set(prof_ref)
    for key in ("lenX", "lenY", "n_tiles", "truncation_error", "vdots_per_tile",
                "ave max chi x", "ave max chi y"):
        assert prof[key] == prof_ref[key], key
    assert not list(tmp_path.glob("checkpoint_*.npy"))  # removed at the end


def test_resume_from_a_checkpoint(built, problem, tmp_path):
    """A checkpoint at the reference's path holding the first tile is
    resumed: that tile is taken from the file (here a marker value), the rest
    computed, and the file is gone afterwards."""
    port, ref, X = problem
    full = ref_cpu_native.build_kernel_matrix(ref, X, info_file=str(tmp_path / "full"),
                                              number_of_tiles=4, checkpoint_dir=str(tmp_path))
    side = int(np.floor(np.sqrt(10 * 10 / 4)))
    partial = np.zeros_like(full)
    partial[:side, :side] = 0.5
    ckpt = tmp_path / "checkpoint_rank_0_run.npy"
    np.save(ckpt, partial)
    K = cpu_native.build_kernel_matrix(port, X, info_file=str(tmp_path / "run"),
                                       number_of_tiles=4, checkpoint_dir=str(tmp_path),
                                       verbose=True)
    assert np.all(K[:side, :side] == 0.5)
    mask = np.ones_like(full, dtype=bool)
    mask[:side, :side] = False
    np.testing.assert_array_equal(K[mask], full[mask])
    assert not ckpt.exists()


def test_native_gram_matches_torch_engine(built, problem, tmp_path):
    port, _, X = problem
    K_nat = cpu_native.build_kernel_matrix(port, X, info_file=str(tmp_path / "nat"),
                                           number_of_tiles=4, checkpoint_dir=str(tmp_path))
    K_torch = build_kernel_matrix(port, X, cfg=SimConfig(chi=8, precision="f64"), device="cpu")
    np.testing.assert_allclose(K_nat, K_torch, atol=1e-6)
    np.testing.assert_allclose(np.diag(K_nat), 1.0, atol=1e-12)


def test_rejects_short_x_and_unknown_gates(built, problem, tmp_path):
    port, _, X = problem
    with pytest.raises(ValueError, match="X must not be smaller"):
        cpu_native.build_kernel_matrix(port, X[:3], Y=X, checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="Unrecognised gate"):
        native.pack_circuits([[("CX", [0, 1], [])]])
