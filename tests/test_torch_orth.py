"""Kernel K2 (fused Q+R orthonormalizer) of the PyTorch port: its plain
version against the reference Pallas kernel run in interpret mode
(``pallas_qr.orthonormalize_r_batched(interpret=True)``). The CUDA kernel
itself is held against the plain version on a card in test_torch_cuda.py.

Both sides run BCGS2 in f32 from the same inputs, so they agree to f32
rounding; the basis is defined only up to a unitary mixing within the span,
so the checks use the projector ``Q Q^H`` and the product ``Q R``, at 1e-5
(f32 accumulation noise well inside the reference's own 2e-5 fused-vs-
unfused bar, tests/test_pallas_split.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qml_cutensornet_tpu.ops import cpx as jcpx
from qml_cutensornet_tpu.ops.cpx import Cpx
from qml_cutensornet_tpu.ops.pallas_qr import orthonormalize_r_batched
from qml_cutensornet_tpu_torch.ops import _build, orth

TOL = 1e-5
B, M, K = 3, 32, 16  # one interpret-mode compile serves every case


def _crandn(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _make(kind, rng, b=B, m=M, k=K):
    if kind == "full":
        v = _crandn(rng, b, m, k)
    elif kind == "ill_conditioned":
        u, _ = np.linalg.qr(_crandn(rng, b, m, k))
        w, _ = np.linalg.qr(_crandn(rng, b, k, k))
        v = (u * np.geomspace(1.0, 1e-2, k)) @ w.conj().transpose(0, 2, 1)
    elif kind == "rank_deficient":
        v = _crandn(rng, b, m, 5) @ _crandn(rng, 5, k)
    elif kind == "zero_padded":
        v = _crandn(rng, b, m, k)
        v[:, m // 2:, :] = 0.0
        v[:, :, k // 2:] = 0.0
    else:
        raise ValueError(kind)
    return (v / np.abs(v).max()).astype(np.complex64)


def _jax_qr(v):
    q, r = orthonormalize_r_batched(
        Cpx(jnp.asarray(v.real), jnp.asarray(v.imag)), interpret=True)
    return jcpx.to_np(q), jcpx.to_np(r)


def _proj(q):
    return q @ q.conj().transpose(0, 2, 1)


def _nonzero_cols(q):
    return np.linalg.norm(q, axis=1) > 0.5


@pytest.mark.parametrize("kind", ["full", "ill_conditioned", "rank_deficient", "zero_padded"])
def test_plain_matches_pallas_kernel(kind):
    rng = np.random.default_rng(["full", "ill_conditioned", "rank_deficient",
                                 "zero_padded"].index(kind))
    v = _make(kind, rng)
    q, r = (t.numpy() for t in orth.qr(torch.from_numpy(v), fused=True))
    qj, rj = _jax_qr(v)
    np.testing.assert_allclose(_proj(q), _proj(qj), atol=TOL)
    np.testing.assert_allclose(q @ r, qj @ rj, atol=TOL)
    np.testing.assert_allclose(q @ r, v, atol=TOL)
    nz = _nonzero_cols(q)
    np.testing.assert_array_equal(nz, _nonzero_cols(qj))
    assert np.count_nonzero(q[np.broadcast_to(~nz[:, None, :], q.shape)]) == 0
    for b in range(B):
        g = q[b][:, nz[b]].conj().T @ q[b][:, nz[b]]
        np.testing.assert_allclose(g, np.eye(nz[b].sum()), atol=TOL)
    if kind == "rank_deficient":
        assert (nz.sum(1) == 5).all()  # dependent columns are exact zeros
    if kind == "zero_padded":
        assert np.count_nonzero(q[:, M // 2:, :]) == 0
        assert np.count_nonzero(q[:, :, K // 2:]) == 0


def test_partial_panel_matches_householder():
    """k = 8 (half a panel), the staged-chi ramp's first stage: the reference
    sends it to XLA Householder (cpx.qr), the port through the same BCGS2."""
    rng = np.random.default_rng(7)
    v = _make("full", rng, b=2, m=16, k=8)
    q, r = (t.numpy() for t in orth.qr(torch.from_numpy(v), fused=True))
    for b in range(2):
        qj, rj = jcpx.qr(Cpx(jnp.asarray(v[b].real), jnp.asarray(v[b].imag)))
        qj, rj = jcpx.to_np(qj), jcpx.to_np(rj)
        np.testing.assert_allclose(q[b] @ q[b].conj().T, qj @ qj.conj().T, atol=TOL)
        np.testing.assert_allclose(q[b] @ r[b], qj @ rj, atol=TOL)


def test_plain_runs_f64_to_roundoff():
    rng = np.random.default_rng(8)
    v = _make("ill_conditioned", rng).astype(np.complex128)
    q, r = (t.numpy() for t in orth.qr(torch.from_numpy(v), fused=True))
    np.testing.assert_allclose(q @ r, v, atol=1e-13)
    np.testing.assert_allclose(q.conj().transpose(0, 2, 1) @ q,
                               np.broadcast_to(np.eye(K), (B, K, K)), atol=1e-13)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA entry point never runs the plain version: a CPU tensor is an
    error, and no launch is counted."""
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        orth.orth_r_cuda(torch.zeros((2, 32, 16), dtype=torch.complex64))
    assert _build.LAUNCHES == before


H100_OPTIN = 232448  # bytes of shared memory a block may opt in to on an H100


@pytest.mark.parametrize("B,m,k,dtype,want", [
    # the main path's center moves (B 32, chi 32 and 64, complex64)
    (32, 64, 32, torch.complex64, (True, True, 37184)),
    (32, 128, 64, torch.complex64, (True, True, 139840)),
    # the chi-128 runs' center moves, and complex128
    (32, 256, 128, torch.complex64, (False, False, 16448)),
    (32, 128, 64, torch.complex128, (True, False, 148608)),
    (32, 256, 128, torch.complex128, (False, False, 32896)),
])
def test_orth_r_launch_plan_is_a_pure_function_of_the_shapes(B, m, k, dtype, want):
    """K2's launch plan: one 512-thread block per element, Q and a copy of v
    where they fit the H100's 227 KB."""
    plan = orth.orth_r_plan(B, m, k, dtype, H100_OPTIN)
    assert (plan.threads, plan.grid) == (512, B)
    assert (plan.rows_smem, plan.v_smem, plan.smem_bytes) == want
    assert plan.scratch_cx == (0 if plan.rows_smem else k * (m + 1))
    with pytest.raises(ValueError, match="no launch plan"):
        orth.orth_r_plan(B, m, k, dtype, 1024)


@pytest.mark.parametrize("m,k,dtype,want", [
    # the unfused route's split and center-move shapes (chi 32 and 64)
    (64, 32, torch.complex64, (True, 4, 1, 20800)),
    (64, 48, torch.complex64, (True, 4, 1, 31168)),
    (128, 64, torch.complex64, (True, 4, 1, 74304)),
    (128, 80, torch.complex64, (True, 4, 1, 92864)),
    # the blocked route's panels at chi 128, 256 and 1024
    (256, 32, torch.complex64, (True, 8, 1, 69952)),
    (256, 16, torch.complex64, (True, 8, 1, 35008)),
    (512, 32, torch.complex64, (True, 16, 1, 135488)),
    (512, 16, torch.complex64, (True, 16, 1, 67776)),
    (2048, 32, torch.complex64, (False, 16, -1, 4160)),
    # the same shapes in complex128
    (64, 32, torch.complex128, (True, 4, 1, 41600)),
    (64, 48, torch.complex128, (True, 4, 1, 62336)),
    (128, 64, torch.complex128, (True, 4, 1, 148608)),
    (128, 80, torch.complex128, (True, 4, 1, 185728)),
    (256, 32, torch.complex128, (True, 8, 1, 139904)),
    (256, 16, torch.complex128, (True, 8, 1, 70016)),
    (512, 32, torch.complex128, (False, 16, 1, 8320)),
    (512, 16, torch.complex128, (True, 16, 1, 135552)),
    (2048, 32, torch.complex128, (False, 16, -1, 8320)),
])
def test_orth_launch_plan_is_a_pure_function_of_the_shapes(m, k, dtype, want):
    """K3's launch plan: one 512-thread block per element, the rows Q [k][m + 1]
    in shared memory where they fit the H100's 227 KB beside the work and the
    in-panel group's static slots, and the group named by the vector length
    (one element a lane on 4 warps up to 128, 8 up to 256, 16 up to 512; the
    panel in memory past 1024)."""
    from qml_cutensornet_tpu_torch.ops import _block

    plan = orth.orth_plan(32, m, k, dtype, H100_OPTIN)
    assert (plan.threads, plan.grid) == (512, 32)
    assert (plan.rows_smem, plan.group_warps, plan.group_epl, plan.smem_bytes) == want
    assert (plan.group_warps, plan.group_epl) == _block.orth_group(m)
    cx = _block.cx_bytes(dtype)
    rows = k * (m + 1) * cx
    assert plan.smem_bytes == (rows if plan.rows_smem else 0) + _block.orth_work_bytes(k, dtype)
    static = _block.group_static_bytes(plan.group_warps, dtype)
    assert plan.smem_bytes + static <= H100_OPTIN
    assert plan.rows_smem == (rows + _block.orth_work_bytes(k, dtype) + static <= H100_OPTIN)
    assert plan.scratch_cx == (0 if plan.rows_smem else k * (m + 1))
    with pytest.raises(ValueError, match="no launch plan"):
        orth.orth_plan(32, m, k, dtype, 1024)


@pytest.mark.parametrize("m", [1, 64, 128, 129, 256, 257, 512, 513, 1024, 1025, 4096])
def test_orth_group_holds_the_vector(m):
    """Every in-panel group in registers holds the whole vector; past 1024
    elements the whole block works on the panel in memory."""
    from qml_cutensornet_tpu_torch.ops import _block

    warps, epl = _block.orth_group(m)
    if m > 1024:
        assert (warps, epl) == (_block.NW, _block.EPL_MEM)
    else:
        assert epl in (1, 2) and warps in (4, 8, 16) and m <= warps * 32 * epl
        assert m > warps * 32 * epl // 2 or warps == 4  # no group twice as large as needed
