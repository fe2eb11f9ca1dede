"""Kernel K3 (basis-only BCGS2) and the blocked route above 128 columns of
the PyTorch port, on the CPU: K3's plain version against the reference
Pallas kernel in interpret mode
(``pallas_qr.orthonormalize_batched(interpret=True)``), the port's
``qr_orth_blocked`` against the reference's (scanned panels and Pallas
panels in interpret mode), and the routing of ``orth.qr`` / ``orth.qr_orth``.
The CUDA kernel itself is held against the plain version on a card in
test_torch_cuda.py.

Tolerances: both sides run the same f32 algorithm, so projectors agree to
accumulation noise; 2e-5 is the reference's own fused-vs-unfused bar
(tests/test_pallas_split.py), 5e-6 its orthonormality bar
(tests/test_pallas_qr.py, tests/test_blocked_qr.py). The basis itself is
only defined up to a unitary mixing within the span."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qml_cutensornet_tpu.ops import blocked_qr as jblocked
from qml_cutensornet_tpu.ops import cpx as jcpx
from qml_cutensornet_tpu.ops.cpx import Cpx
from qml_cutensornet_tpu.ops.pallas_qr import orthonormalize_batched
from qml_cutensornet_tpu_torch.ops import _build, blocked_qr, orth

TOL = 2e-5
TOL_ORTH = 5e-6


def _crandn(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _cpx(a):
    return Cpx(jnp.asarray(a.real, jnp.float32), jnp.asarray(a.imag, jnp.float32))


def _proj(q):
    return q @ np.conj(np.swapaxes(q, -1, -2))


def _orth_err(q):
    """max |Q^H Q - I| over the non-zero columns of one [m, k] basis."""
    nz = np.linalg.norm(q, axis=0) > 0.5
    g = q[:, nz].conj().T @ q[:, nz]
    return np.abs(g - np.eye(nz.sum())).max()


def _batch(rng, b, m, k):
    """Full rank; rank-deficient with an exact-zero column and engine-style
    zero rows; one cross-panel dependent column."""
    v = _crandn(rng, b, m, k)
    r = k // 2
    v[1] = _crandn(rng, m, r) @ _crandn(rng, r, k)
    v[1, :, 3] = 0.0
    v[1, m // 2:, :] = 0.0
    v[2, :, k - 2] = v[2, :, 1] * (1 + 3e-7) + 1e-7 * v[2, :, 4]
    return (v / np.abs(v).max()).astype(np.complex64)


@pytest.mark.parametrize("m,k", [(32, 16), (64, 32), (128, 32)])
def test_plain_matches_pallas_kernel(m, k):
    rng = np.random.default_rng(m + k)
    v = _batch(rng, 3, m, k)
    q = orth.orth(torch.from_numpy(v)).numpy()
    qj = jcpx.to_np(orthonormalize_batched(_cpx(v), interpret=True))
    np.testing.assert_allclose(_proj(q), _proj(qj), atol=TOL)
    np.testing.assert_allclose(q, qj, atol=TOL)  # same algorithm, same order of columns
    for b in range(3):
        assert _orth_err(q[b]) <= TOL_ORTH
    # zero and dependent columns are exact zeros on both sides, the same ones
    dead, dead_j = np.linalg.norm(q, axis=1) < 0.5, np.linalg.norm(qj, axis=1) < 0.5
    np.testing.assert_array_equal(dead, dead_j)
    assert dead[1].sum() == k - k // 2 and dead[1, 3] and dead[2, k - 2]
    assert np.count_nonzero(q[np.broadcast_to(dead[:, None, :], q.shape)]) == 0
    assert np.count_nonzero(q[1, m // 2:, :]) == 0  # zero rows stay zero


def test_partial_panel_and_f64():
    """k not a multiple of 16 (the staged ramp's chi-8 stage) and complex128."""
    rng = np.random.default_rng(4)
    v = _crandn(rng, 2, 40, 24)
    q = orth.orth(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(np.conj(np.swapaxes(q, 1, 2)) @ q,
                               np.broadcast_to(np.eye(24), (2, 24, 24)), atol=1e-13)
    np.testing.assert_allclose(_proj(q) @ v, v, atol=1e-12)


M, K = 128, 144  # the blocked tests share one shape: one reference compile per panel step


@functools.lru_cache(maxsize=None)
def _ref_blocked(pallas_panels):
    """The reference's blocked route over a batch, jitted once per panel
    step (scanned, or the Pallas kernel in interpret mode)."""
    return jax.jit(jax.vmap(lambda v: jblocked.qr_orth_blocked(
        v, pallas_panels=pallas_panels, interpret=pallas_panels)))


def test_blocked_matches_reference():
    """Above 128 columns: the port's panels-of-32 route against the
    reference's, both panel steps, on a full-rank and a dependent input."""
    rng = np.random.default_rng(K)
    v = _crandn(rng, 2, M, K)
    v[1, :, 40] = v[1, :, 3] * (1 + 3e-7) + 1e-7 * v[1, :, 5]  # cross-panel dependent
    v[1, :, K - 6:] = 0.0  # exact-zero padding columns
    v[1, M // 2:, :] = 0.0  # engine-style zero rows: rank 64 of 138 columns
    v = (v / np.abs(v).max()).astype(np.complex64)
    qs = jcpx.to_np(_ref_blocked(False)(_cpx(v)))
    qp = jcpx.to_np(_ref_blocked(True)(_cpx(v)))
    for kernel_panels in (True, False):
        q = blocked_qr.qr_orth_blocked(torch.from_numpy(v), kernel_panels).numpy()
        np.testing.assert_allclose(_proj(q), _proj(qs), atol=TOL)
        np.testing.assert_allclose(_proj(q), _proj(qp), atol=TOL)
        for b in range(2):
            assert _orth_err(q[b]) <= TOL_ORTH
            span = np.abs(v[b] - _proj(q[b]) @ v[b]).max() / np.abs(v[b]).max()
            assert span <= TOL_ORTH
        assert np.count_nonzero(q[1, :, 40]) == 0 and np.count_nonzero(q[1, :, K - 6:]) == 0
        assert np.count_nonzero(q[1, M // 2:, :]) == 0
        assert (np.linalg.norm(q[1], axis=0) > 0.5).sum() == M // 2


def _degenerate(rng, r=40):
    """A [M, K] input of exact rank ``r`` with exactly repeated singular
    values (10 at 1, 10 at 1e-2, 20 at 1e-3) and its left singular vectors."""
    u, _ = np.linalg.qr(_crandn(rng, M, r))
    w, _ = np.linalg.qr(_crandn(rng, K, r))
    s = np.concatenate([np.full(10, 1.0), np.full(10, 1e-2), np.full(20, 1e-3)])
    return (u * s) @ w.conj().T, u


def test_blocked_degenerate_and_rank_deficient():
    """Exactly repeated singular values and dependent columns, the case of
    the reference's tests/test_blocked_qr.py: columns are unit or exact zero,
    wholly dependent panels are zeroed, the resolvable range is spanned, and
    the port agrees with the reference's kernel-panel route on the projector
    of that range.

    On this input the kernel-panel route (the port's, and the reference's
    with ``pallas_panels=True``) keeps noise columns beyond the true rank 40,
    its kept columns are orthonormal only to about 1e-3 and the span
    residual of the strong directions is about 1e-3, where the reference's
    scanned panels keep exactly 40 columns at 1e-6 and 1e-5: inside the
    panel the kernel measures a column's collapse against its norm AFTER the
    projection against earlier panels, the scan against its norm before it.
    The port reproduces the reference's kernel route here, fault included:
    the bars below are that route's measured level, not the scanned
    route's."""
    rng = np.random.default_rng(7)
    r = 40
    v, u = _degenerate(rng, r)
    v = v.astype(np.complex64)
    q = blocked_qr.qr_orth_blocked(torch.from_numpy(v[None]), True)[0].numpy()
    norms = np.linalg.norm(q, axis=0)
    assert np.all((norms > 0.99) | (norms == 0.0))
    both = _cpx(np.stack([v, v]))  # batch of 2: the compile of the test above
    qp = jcpx.to_np(_ref_blocked(True)(both))[0]
    qs = jcpx.to_np(_ref_blocked(False)(both))[0]
    kept, kept_p = (norms > 0.5).sum(), (np.linalg.norm(qp, axis=0) > 0.5).sum()
    assert (np.linalg.norm(qs, axis=0) > 0.5).sum() == r  # the scanned route: true rank
    assert r <= kept <= kept_p + 2 and (norms == 0.0).sum() == K - kept
    assert _orth_err(q) < 3e-3 and _orth_err(qp) < 3e-3
    top = u[:, :20]  # directions with s >= 1e-2: far above f32 noise
    for basis in (q, qp):
        assert np.linalg.norm(top - _proj(basis) @ top) / np.linalg.norm(top) < 3e-3
    np.testing.assert_allclose(_proj(q) @ top, _proj(qp) @ top, atol=1e-3)
    np.testing.assert_allclose(_proj(q) @ top, _proj(qs) @ top, atol=1e-3)


@pytest.mark.parametrize("dtype,kernel_panels", [
    (np.complex64, False), (np.complex128, False), (np.complex128, True)])
def test_blocked_scanned_route_matches_reference_on_degenerate_input(dtype, kernel_panels):
    """The port's scanned route (``kernel_panels`` off, and every complex128
    run whatever ``kernel_panels`` says) against the reference's scanned
    route (``pallas_panels=False``) on the degenerate rank-40 input of the
    test above: exactly 40 columns kept, the rest exact zeros, orthonormal to
    1e-5, the projected input ``q q^H v`` and the projector on the directions
    of singular value 1 and 1e-2 within 1e-5 of the reference's, and the
    whole projector within 1e-5 in complex128. In complex64 the span of the
    1e-3 cluster is fixed only to about eps / 1e-3 = 6e-5: the two routes'
    whole projectors differ by 4.3e-5 there and each is 3e-5 to 4e-5 from the
    reference's scan of the same input in f64, so that bar is 1e-4. In
    complex128 the reference runs the same scan in f64 (its cutoff 1e-10, the
    port's 1e-24: both far from this input's residual ratios of 1e-6 and
    1e-30)."""
    rng = np.random.default_rng(7)
    v, u = _degenerate(rng)
    v = v.astype(dtype)
    assert blocked_qr.kernel_panels_used(kernel_panels, torch.from_numpy(v).dtype) is False
    q = blocked_qr.qr_orth_blocked(torch.from_numpy(v[None]), kernel_panels)[0].numpy()
    rdt = jnp.float32 if dtype == np.complex64 else jnp.float64
    both = Cpx(jnp.asarray(np.stack([v, v]).real, rdt), jnp.asarray(np.stack([v, v]).imag, rdt))
    qs = jcpx.to_np(_ref_blocked(False)(both))[0]
    norms = np.linalg.norm(q, axis=0)
    assert (norms > 0.5).sum() == 40 and (np.linalg.norm(qs, axis=0) > 0.5).sum() == 40
    assert np.count_nonzero(q[:, norms < 0.5]) == 0
    assert _orth_err(q) <= 1e-5
    top = u[:, :20]
    assert np.abs(_proj(q) @ top - _proj(qs) @ top).max() <= 1e-5
    assert np.abs(_proj(q) @ v - _proj(qs) @ v).max() / np.abs(v).max() <= 1e-5
    assert np.abs(_proj(q) - _proj(qs)).max() <= (1e-4 if dtype == np.complex64 else 1e-5)


def test_qr_routing_and_products():
    """``orth.qr``: fused and unfused agree on q r == v and on the projector;
    above 128 columns both take the blocked route. ``qr_orth`` picks K3 or the
    blocked route by the column count."""
    rng = np.random.default_rng(9)
    v = torch.from_numpy(_batch(rng, 3, 64, 32))
    qf, rf = orth.qr(v, fused=True)
    qu, ru = orth.qr(v, fused=False)
    for q, r in ((qf, rf), (qu, ru)):
        np.testing.assert_allclose((q @ r).numpy(), v.numpy(), atol=TOL_ORTH)
    np.testing.assert_allclose(_proj(qf.numpy()), _proj(qu.numpy()), atol=TOL)
    wide = torch.from_numpy((_crandn(rng, 1, 160, 144) / 4).astype(np.complex64))
    qw, rw = orth.qr(wide, fused=True)
    np.testing.assert_allclose((qw @ rw).numpy(), wide.numpy(), atol=TOL_ORTH)
    torch.testing.assert_close(orth.qr_orth(wide, True), blocked_qr.qr_orth_blocked(wide, True))
    torch.testing.assert_close(orth.qr_orth(wide, False),
                               blocked_qr.qr_orth_blocked(wide, False))
    qs, rs = orth.qr(wide, fused=False)  # the scanned panels, then q^H v
    torch.testing.assert_close(qs, blocked_qr.qr_orth_blocked(wide, False))
    np.testing.assert_allclose((qs @ rs).numpy(), wide.numpy(), atol=TOL_ORTH)
    for fused in (True, False):
        torch.testing.assert_close(orth.qr_orth(v, fused), orth.orth_plain(v))


def test_kernel_wrapper_refuses_cpu_tensors_and_wide_inputs():
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        orth.orth_cuda(torch.zeros((2, 32, 16), dtype=torch.complex64))
    assert _build.LAUNCHES == before and _build.PLAIN_ON_CUDA["orth"] == 0
