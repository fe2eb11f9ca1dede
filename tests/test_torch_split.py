"""Kernel K1 (fused subspace split) of the PyTorch port: its plain version
against the reference Pallas kernel in interpret mode
(``pallas_split.subspace_factor_batched(interpret=True)``) for 1 and 2
power iterations, then through ``_finish_subspace`` (mask, kept fraction,
rank) against the reference's. The CUDA kernel itself is held against the
plain version on a card in test_torch_cuda.py.

Tolerances: the two sides run the same f32 algorithm from the same start
block, so q and r agree to f32 accumulation noise; 2e-5 is the reference's
own fused-vs-unfused bar on q/r (tests/test_pallas_split.py). Masks and
ranks must be identical; kept fractions agree to 1e-6."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qml_cutensornet_tpu.config import SimConfig as RefConfig
from qml_cutensornet_tpu.ops import cpx as jcpx
from qml_cutensornet_tpu.ops import svd as jsvd
from qml_cutensornet_tpu.ops.cpx import Cpx
from qml_cutensornet_tpu.ops.pallas_split import subspace_factor_batched
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.ops import _block, _build, split, svd

TOL = 2e-5
B, M, KEEP = 2, 32, 16  # one interpret-mode compile per iters value


def _theta(rng, b=B, m=M, k=M):
    """A batch exercising the split's regimes: exact low rank (rank 10 <
    keep, so dependent columns) with engine-style zero padding (rows and
    columns beyond the live bond), and a decaying spectrum (truncation)."""
    def crandn(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    th = np.empty((b, m, k), np.complex128)
    for i in range(0, b, 2):
        th[i] = crandn(m, 10) @ crandn(10, k)
        th[i, m // 2:, :] = 0.0
        th[i, :, k // 2:] = 0.0
    for i in range(1, b, 2):
        u, _ = np.linalg.qr(crandn(m, m))
        w, _ = np.linalg.qr(crandn(k, k))
        th[i] = (u * np.geomspace(1.0, 1e-6, min(m, k))) @ w.conj().T
    th /= np.abs(th).max(axis=(1, 2), keepdims=True)
    return th.astype(np.complex64)


def _ref_factor(th, keep, iters):
    re, im = jsvd._subspace_start(th.shape[1], keep, "float32")
    q, r = subspace_factor_batched(
        Cpx(jnp.asarray(th.real), jnp.asarray(th.imag)),
        Cpx(jnp.asarray(re), jnp.asarray(im)), keep, iters=iters, interpret=True)
    return jcpx.to_np(q), jcpx.to_np(r)


def _port_factor(th, keep, iters):
    v0 = svd.start_block(th.shape[1], keep, torch.complex64, torch.device("cpu"))
    q, r = split.subspace_factor(torch.from_numpy(th), v0, iters)
    return q.numpy(), r.numpy()


def _ref_finish(q, r, th, cfg: RefConfig, keep, nc):
    """The reference's _finish_subspace over the batch (one jit per cfg)."""
    fin = jax.jit(jax.vmap(lambda q, r, t: jsvd._finish_subspace(q, r, t, cfg, keep, nc)))
    total = jnp.sum(jnp.abs(jnp.asarray(th)) ** 2, axis=(1, 2))
    left, right, kf, rank = fin(Cpx(jnp.asarray(q.real), jnp.asarray(q.imag)),
                                Cpx(jnp.asarray(r.real), jnp.asarray(r.imag)), total)
    left, right = jcpx.to_np(left), jcpx.to_np(right)
    return [(left[b], right[b], float(kf[b]), int(rank[b])) for b in range(q.shape[0])]


@pytest.mark.parametrize("iters", [1, 2])
def test_plain_matches_pallas_kernel(iters):
    rng = np.random.default_rng(iters)
    th = _theta(rng)
    q, r = _port_factor(th, KEEP, iters)
    qj, rj = _ref_factor(th, KEEP, iters)
    np.testing.assert_allclose(q, qj, atol=TOL)
    np.testing.assert_allclose(r, rj, atol=TOL)
    np.testing.assert_allclose(q @ q.conj().transpose(0, 2, 1),
                               qj @ qj.conj().transpose(0, 2, 1), atol=TOL)
    # exact-rank and padded elements reconstruct theta; zeros stay exact
    np.testing.assert_allclose(q[0] @ r[0], th[0], atol=5e-6)
    assert np.count_nonzero(q[0, M // 2:, :]) == 0
    assert np.count_nonzero(r[0, :, M // 2:]) == 0
    dead = np.linalg.norm(q[0], axis=0) < 0.5
    assert dead.sum() == KEEP - 10 and np.count_nonzero(q[0][:, dead]) == 0

    # Through the truncation tail: identical masks and ranks, same kept
    # fractions, on the same (q, r) and on each side's own factors.
    for eps in (1e-16, 1e-3):
        rcfg = RefConfig(chi=KEEP, svd_method="subspace", truncation_error=eps,
                         subspace_iters=iters)
        pcfg = SimConfig.from_reference(dataclasses.asdict(rcfg))
        total = torch.from_numpy((np.abs(th) ** 2).sum((1, 2)).astype(np.float32))
        ref = _ref_finish(qj, rj, th, rcfg, KEEP, KEEP)
        for qs, rs in ((qj, rj), (q, r)):
            left, right, kf, rank = svd._finish_subspace(
                torch.from_numpy(qs), torch.from_numpy(rs), total, pcfg, KEEP, KEEP)
            for b in range(B):
                assert int(rank[b]) == ref[b][3], (eps, b)
                assert abs(float(kf[b]) - ref[b][2]) <= 1e-6
                np.testing.assert_allclose((left[b] @ right[b]).numpy(),
                                           ref[b][0] @ ref[b][1], atol=TOL)


def test_oversampled_gather_matches_reference():
    """keep + oversample columns, top-keep gathered by captured weight."""
    rng = np.random.default_rng(5)
    th = _theta(rng)
    keep, nc = 8, KEEP
    qj, rj = _ref_factor(th, nc, 1)
    rcfg = RefConfig(chi=keep, svd_method="subspace", oversample=nc - keep)
    pcfg = SimConfig.from_reference(dataclasses.asdict(rcfg))
    total = torch.from_numpy((np.abs(th) ** 2).sum((1, 2)).astype(np.float32))
    ref = _ref_finish(qj, rj, th, rcfg, keep, nc)
    left, right, kf, rank = svd._finish_subspace(
        torch.from_numpy(qj), torch.from_numpy(rj), total, pcfg, keep, nc)
    for b in range(B):
        assert int(rank[b]) == ref[b][3]
        assert abs(float(kf[b]) - ref[b][2]) <= 1e-6
        np.testing.assert_allclose(left[b].numpy(), ref[b][0], atol=1e-7)
        np.testing.assert_allclose(right[b].numpy(), ref[b][1], atol=1e-7)


def test_kernel_wrapper_refuses_cpu_tensors():
    th = torch.zeros((2, 32, 32), dtype=torch.complex64)
    v0 = torch.zeros((32, 16), dtype=torch.complex64)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        split.subspace_factor_cuda(th, v0, 1)
    assert _build.LAUNCHES == before


H100_OPTIN = 232448  # bytes of shared memory a block may opt in to on an H100


@pytest.mark.parametrize("B,m,k,nc,dtype,want", [
    # the main path's stages (B 32, chi 32 and 64, complex64)
    (32, 64, 64, 32, torch.complex64, (True, True, False, 70720)),
    (32, 128, 128, 64, torch.complex64, (True, True, True, 206400)),
    # chi 64 with the oversampling of the chi-128 runs: one row buffer would
    # need two passes of the block's warps
    (32, 128, 128, 80, torch.complex64, (False, True, False, 175424)),
    # the brick route's full width through K1 (408 pairs, chi 128): theta
    # and rows in global memory, the products' slabs staged in shared memory
    (408, 256, 256, 128, torch.complex64, (False, False, False, 49664)),
    # complex128
    (32, 64, 64, 32, torch.complex128, (True, True, False, 141440)),
    (32, 128, 128, 64, torch.complex128, (False, True, True, 148608)),
    (4, 256, 256, 128, torch.complex128, (False, False, False, 99328)),
])
def test_launch_plan_is_a_pure_function_of_the_shapes(B, m, k, nc, dtype, want):
    """K1's launch plan: one 512-thread block per element, theta and the
    rows where they fit the H100's 227 KB, and the shared-memory bytes the C
    side computes for the same plan."""
    plan = split.split_plan(B, m, k, nc, dtype, H100_OPTIN)
    assert (plan.threads, plan.grid) == (512, B)
    assert (plan.theta_smem, plan.rows_smem, plan.inplace, plan.smem_bytes) == want
    assert plan.smem_bytes + _block.static_smem_bytes(dtype) <= H100_OPTIN
    assert plan.scratch_cx == (0 if plan.rows_smem else nc * (m + k + 2))
    assert split.split_plan(B, m, k, nc, dtype, H100_OPTIN) == plan
    with pytest.raises(ValueError, match="no launch plan"):
        split.split_plan(B, m, k, nc, dtype, 1024)
