"""CUDA kernels of the PyTorch port on a card: each kernel against its plain
PyTorch version at the main path's shapes, the double instantiation and the
global-scratch layout, the launch-error path, and the train-Gram slice on
the card against the same slice on the CPU.

Every test here is marked ``cuda`` and skips where there is no card. This
file imports neither JAX nor the reference package, so it also runs on a
machine that has only PyTorch (``README.md``, "PyTorch / H100 port"):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

Tolerances (f32): kernel and plain version run the same algorithm with
different summation orders; 2e-5 is the reference's own fused-vs-unfused
bar on q/r (tests/test_pallas_split.py) and Gram (3e-5). In f64, 1e-12."""

import numpy as np
import pytest
import torch

from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix
from qml_cutensornet_tpu_torch.ops import _build, orth, split
from qml_cutensornet_tpu_torch.ops.svd import start_block

pytestmark = pytest.mark.cuda
TOL = 2e-5


@pytest.fixture
def dev():
    """The card; decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _input(rng, kind, b, m, k, dtype=np.complex64):
    x = rng.standard_normal((b, m, k)) + 1j * rng.standard_normal((b, m, k))
    if kind == "rank_deficient":
        r = max(1, min(m, k) // 2)
        x = x[:, :, :r] @ (rng.standard_normal((r, k)) + 1j * rng.standard_normal((r, k)))
    elif kind == "zero_padded":
        x[:, m // 2:, :] = 0.0
        x[:, :, k // 2:] = 0.0
    return (x / np.abs(x).max()).astype(dtype)


def _close(qk, rk, qp, rp, tol):
    assert (qk @ qk.mH - qp @ qp.mH).abs().max().item() <= tol
    assert (qk @ rk - qp @ rp).abs().max().item() <= tol
    zero_k = qk.abs().sum(1) == 0
    assert torch.equal(zero_k, qp.abs().pow(2).sum(1) < 0.25)


@pytest.mark.parametrize("chi", [8, 16, 32, 64])
@pytest.mark.parametrize("kind", ["full", "rank_deficient", "zero_padded"])
def test_orth_r_kernel_matches_plain(dev, chi, kind):
    rng = np.random.default_rng(chi)
    v = torch.from_numpy(_input(rng, kind, 32, 2 * chi, chi)).to(dev)
    before = _build.LAUNCHES["orth_r"]
    qk, rk = orth.qr(v)
    assert _build.LAUNCHES["orth_r"] == before + 1
    qp, rp = orth.orth_r_plain(v)
    torch.cuda.synchronize()
    _close(qk, rk, qp, rp, TOL)


@pytest.mark.parametrize("chi", [8, 16, 32, 64])
@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("kind", ["full", "rank_deficient", "zero_padded"])
def test_split_kernel_matches_plain(dev, chi, iters, kind):
    rng = np.random.default_rng(chi + iters)
    th = torch.from_numpy(_input(rng, kind, 32, 2 * chi, 2 * chi)).to(dev)
    v0 = start_block(2 * chi, chi, th.dtype, dev)
    before = _build.LAUNCHES["split"]
    qk, rk = split.subspace_factor(th, v0, iters)
    assert _build.LAUNCHES["split"] == before + 1
    qp, rp = split.subspace_factor_plain(th, v0, iters)
    torch.cuda.synchronize()
    _close(qk, rk, qp, rp, TOL)


def test_double_and_global_scratch_layouts(dev):
    """complex128 runs the double instantiation; chi 128 in f32 (m = k = 256,
    nc = 128) does not fit shared memory and runs the global-scratch layout."""
    rng = np.random.default_rng(3)
    v = torch.from_numpy(_input(rng, "full", 4, 128, 64, np.complex128)).to(dev)
    _close(*orth.orth_r_cuda(v), *orth.orth_r_plain(v), 1e-12)
    th = torch.from_numpy(_input(rng, "full", 4, 64, 64, np.complex128)).to(dev)
    v0 = start_block(64, 32, th.dtype, dev)
    _close(*split.subspace_factor_cuda(th, v0, 2), *split.subspace_factor_plain(th, v0, 2),
           1e-12)
    th = torch.from_numpy(_input(rng, "rank_deficient", 2, 256, 256)).to(dev)
    v0 = start_block(256, 128, th.dtype, dev)
    _close(*split.subspace_factor_cuda(th, v0, 1), *split.subspace_factor_plain(th, v0, 1), TOL)
    v = torch.from_numpy(_input(rng, "full", 2, 256, 128)).to(dev)
    _close(*orth.orth_r_cuda(v), *orth.orth_r_plain(v), TOL)


def test_refused_launch_raises_and_is_not_counted(dev):
    v = torch.zeros((2, 32, 16), dtype=torch.complex64, device=dev)
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error"):
        orth.orth_r_cuda(v, smem_bytes=_build.smem_optin(dev.index) + 4096)
    assert _build.LAUNCHES == before
    q, r = orth.orth_r_cuda(v)  # the next launch is clean
    torch.cuda.synchronize()
    assert q.abs().max().item() == 0.0
    with pytest.raises(ValueError):
        orth.orth_r_cuda(torch.zeros((2, 256, 144), dtype=torch.complex64, device=dev))


def test_slice_on_card_matches_cpu(dev):
    nq = 8
    X = np.random.default_rng(2).uniform(0.0, 2.0, size=(6, nq))
    ans = KernelStateAnsatz(nq, 1, 1.0, entanglement_graph(nq, 2))
    cfg = SimConfig(chi=16, tile_block=2)
    _build.reset_counters()
    K_gpu = build_kernel_matrix(ans, X, cfg=cfg, sim_batch=4, tile=4, device="cuda")
    assert _build.LAUNCHES["split"] > 0 and _build.LAUNCHES["orth_r"] > 0
    assert sum(_build.PLAIN_ON_CUDA.values()) == 0
    K_cpu = build_kernel_matrix(ans, X, cfg=cfg, sim_batch=4, tile=4, device="cpu")
    np.testing.assert_allclose(K_gpu, K_cpu, atol=3e-5)
