"""The block-2 in-panel variant (``mgs_pair``) of kernels K1 to K5 in the
PyTorch port: the plain pair versions against the reference's Pallas kernels
run with ``pair=True`` in interpret mode (``pallas_qr.orthonormalize_batched``
/ ``orthonormalize_r_batched``, ``pallas_split.subspace_factor_batched``,
``gate_split_factor_batched``, ``brick_gate_split_batched``), the odd-width
panel the reference never forms, complex128 (where the flag changes
nothing), and ``build_kernel_matrix`` with ``SimConfig(mgs_pair=True)``
against the reference's. The CUDA pair kernels are held against these plain
versions on a card in test_torch_cuda.py and chip_smoke.py.

Both sides run the same f32 algorithm from the same inputs, so they agree to
f32 rounding; the basis is defined only up to a unitary mixing within the
span, so the checks use basis-invariant quantities (projectors, products,
orthonormality, exact-zero columns, sorted s2). Tolerances are those of
test_torch_orth.py (1e-5) and test_torch_split.py / test_torch_gate_split.py
(2e-5 on factors, 1e-5 on ``||theta||^2``); Grams 3e-5, the reference's own
fused-vs-unfused bar."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qml_cutensornet_tpu.config import SimConfig as RefConfig
from qml_cutensornet_tpu.models.ansatz import KernelStateAnsatz as RefAnsatz
from qml_cutensornet_tpu.models.gram import build_kernel_matrix as ref_build
from qml_cutensornet_tpu.ops import cpx as jcpx
from qml_cutensornet_tpu.ops import svd as jsvd
from qml_cutensornet_tpu.ops.cpx import Cpx
from qml_cutensornet_tpu.ops.pallas_qr import orthonormalize_batched, orthonormalize_r_batched
from qml_cutensornet_tpu.ops.pallas_split import (
    brick_gate_split_batched,
    gate_split_factor_batched,
    subspace_factor_batched,
)
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix
from qml_cutensornet_tpu_torch.ops import _build, gates, orth, split, svd

TOL_ORTH = 1e-5
TOL_SPLIT = 2e-5
TOL_TOT = 1e-5
TOL_GRAM = 3e-5
B, M, K = 3, 32, 16  # one interpret-mode compile per reference function
KINDS = ("full", "rank_deficient", "zero_padded")
CPU = torch.device("cpu")


def _crandn(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _make(kind, rng, b=B, m=M, k=K):
    if kind == "full":
        v = _crandn(rng, b, m, k)
    elif kind == "rank_deficient":
        v = _crandn(rng, b, m, 5) @ _crandn(rng, 5, k)
    elif kind == "zero_padded":
        v = _crandn(rng, b, m, k)
        v[:, m // 2:, :] = 0.0
        v[:, :, k // 2:] = 0.0
    elif kind == "graded":
        u, _ = np.linalg.qr(_crandn(rng, b, m, k))
        w, _ = np.linalg.qr(_crandn(rng, b, k, k))
        v = (u * np.geomspace(1.0, 1e-2, k)) @ w.conj().transpose(0, 2, 1)
    else:
        raise ValueError(kind)
    return (v / np.abs(v).max()).astype(np.complex64)


def _cpx(x):
    return Cpx(jnp.asarray(x.real), jnp.asarray(x.imag))


def _proj(q):
    return q @ q.conj().transpose(0, 2, 1)


def _live(q):
    return np.linalg.norm(q, axis=1) > 0.5


def _check_basis(q, q_ref, tol):
    """Same span and kept columns as the reference; kept columns
    orthonormal, dropped ones exact zeros."""
    np.testing.assert_allclose(_proj(q), _proj(q_ref), atol=tol)
    nz = _live(q)
    np.testing.assert_array_equal(nz, _live(q_ref))
    assert np.count_nonzero(q[np.broadcast_to(~nz[:, None, :], q.shape)]) == 0
    for b in range(q.shape[0]):
        g = q[b][:, nz[b]].conj().T @ q[b][:, nz[b]]
        np.testing.assert_allclose(g, np.eye(nz[b].sum()), atol=tol)


@pytest.mark.parametrize("kind", KINDS)
def test_orth_pair_matches_reference(kind):
    """K3 and K2: the plain pair versions against the reference's pair
    kernels (basis; basis and ``r = q^H v``)."""
    v = _make(kind, np.random.default_rng(KINDS.index(kind)))
    q = orth.orth(torch.from_numpy(v), pair=True).numpy()
    _check_basis(q, jcpx.to_np(orthonormalize_batched(_cpx(v), interpret=True, pair=True)),
                 TOL_ORTH)
    q, r = (t.numpy() for t in orth.qr(torch.from_numpy(v), fused=True, pair=True))
    qj, rj = (jcpx.to_np(t) for t in orthonormalize_r_batched(_cpx(v), interpret=True,
                                                               pair=True))
    _check_basis(q, qj, TOL_ORTH)
    np.testing.assert_allclose(q @ r, qj @ rj, atol=TOL_ORTH)
    np.testing.assert_allclose(q @ r, v, atol=TOL_ORTH)
    if kind == "rank_deficient":
        assert (_live(q).sum(1) == 5).all()  # dependent columns are exact zeros
    if kind == "zero_padded":
        assert np.count_nonzero(q[:, M // 2:, :]) == 0
        assert np.count_nonzero(q[:, :, K // 2:]) == 0


def _theta(rng):
    """Exact low rank with engine-style zero padding (rank 10 < keep:
    dependent columns), and a graded spectrum (truncation)."""
    th = np.empty((2, M, M), np.complex128)
    th[0] = _crandn(rng, M, 10) @ _crandn(rng, 10, M)
    th[0, M // 2:, :] = 0.0
    th[0, :, M // 2:] = 0.0
    u, _ = np.linalg.qr(_crandn(rng, M, M))
    w, _ = np.linalg.qr(_crandn(rng, M, M))
    th[1] = (u * np.geomspace(1.0, 1e-6, M)) @ w.conj().T
    th /= np.abs(th).max(axis=(1, 2), keepdims=True)
    return th.astype(np.complex64)


def _check_factor(q, r, qj, rj, x):
    """q r, the projector of the kept columns and the sorted s2."""
    scale = np.abs(x).max()
    np.testing.assert_allclose(q @ r, qj @ rj, atol=TOL_SPLIT * scale)
    np.testing.assert_allclose(_proj(q), _proj(qj), atol=TOL_SPLIT)
    s2 = np.sort(np.sum(np.abs(r) ** 2, axis=2), axis=1)
    s2j = np.sort(np.sum(np.abs(rj) ** 2, axis=2), axis=1)
    np.testing.assert_allclose(s2, s2j, atol=TOL_SPLIT * s2j.max())
    nz = _live(q)
    np.testing.assert_array_equal(nz, _live(qj))
    assert np.count_nonzero(q[np.broadcast_to(~nz[:, None, :], q.shape)]) == 0


@pytest.mark.parametrize("iters", [1, 2])
def test_split_pair_matches_reference(iters):
    """K1: the plain pair version against the reference's pair kernel, then
    the truncation (mask, kept fraction, rank) of both."""
    th = _theta(np.random.default_rng(10 + iters))
    re, im = jsvd._subspace_start(M, K, "float32")
    qj, rj = (jcpx.to_np(t) for t in subspace_factor_batched(
        _cpx(th), Cpx(jnp.asarray(re), jnp.asarray(im)), K, iters=iters, interpret=True,
        pair=True))
    v0 = svd.start_block(M, K, torch.complex64, CPU)
    q, r = split.subspace_factor(torch.from_numpy(th), v0, iters, pair=True)
    _check_factor(q.numpy(), r.numpy(), qj, rj, th)
    cfg = SimConfig(svd_method="subspace", mgs_pair=True)
    total = orth.abs2(torch.from_numpy(th)).sum((1, 2))
    _, _, kf, rank = svd._finish_subspace(q, r, total, cfg, K, K)
    _, _, kf_ref, rank_ref = svd._finish_subspace(torch.from_numpy(qj), torch.from_numpy(rj),
                                                  total, cfg, K, K)
    np.testing.assert_allclose(kf.numpy(), kf_ref.numpy(), atol=1e-6)
    np.testing.assert_array_equal(rank.numpy(), rank_ref.numpy())


def _pair_feeds(rng, chi, kind):
    a = _make(kind, rng, 2, 2 * chi, chi)
    b = _make(kind, rng, 2, chi, 2 * chi)
    g = np.linalg.qr(_crandn(rng, 2, 4, 4))[0].astype(np.complex64)
    return a, b, g


@pytest.mark.parametrize("kind", ["full", "zero_padded"])
def test_gate_split_pair_matches_reference(kind):
    """K4: theta built from the pair and the gate, then the pair chain."""
    chi = 16
    A, Bm, g = _pair_feeds(np.random.default_rng(20 + len(kind)), chi, kind)
    re, im = jsvd._subspace_start(2 * chi, chi, "float32")
    qj, rj, totj = gate_split_factor_batched(
        _cpx(A), _cpx(Bm), _cpx(g), Cpx(jnp.asarray(re), jnp.asarray(im)), chi, iters=2,
        interpret=True, pair=True)
    qj, rj, totj = jcpx.to_np(qj), jcpx.to_np(rj), np.asarray(totj)
    tA, tB, tg = (torch.from_numpy(x) for x in (A, Bm, g))
    q, r, tot, _ = split.gate_subspace_factor(
        tA, tB, tg, svd.start_block(2 * chi, chi, torch.complex64, CPU), 2, pair=True)
    theta = split.gate_theta(tA, tB, tg).numpy()
    _check_factor(q.numpy(), r.numpy(), qj, rj, theta)
    np.testing.assert_allclose(tot.numpy(), totj, rtol=TOL_TOT)


@pytest.mark.parametrize("swap_w", [0.0, 1.0])
def test_brick_split_pair_matches_reference(swap_w):
    """K5: the Hastings pair update with the pair chain; the projected pair
    ``na0^T conj(q2)``, the sorted s2 and ``||theta_w||^2``."""
    chi, Bn = 16, 3
    rng = np.random.default_rng(30 + int(swap_w))
    a = _crandn(rng, Bn, chi, 2, chi)
    b = _crandn(rng, Bn, chi, 2, chi)
    a[:, 5:] = 0.0  # the left bond live up to 5, its weights exact zeros past it
    lam = rng.uniform(0.3, 1.0, size=(Bn, chi))
    lam[:, 5:] = 0.0
    A = np.ascontiguousarray((a / np.abs(a).max()).transpose(0, 2, 1, 3)).reshape(
        Bn, 2 * chi, chi).astype(np.complex64)
    Bm = (b / np.abs(b).max()).reshape(Bn, chi, 2 * chi).astype(np.complex64)
    xx = gates.xxphase(torch.from_numpy(rng.uniform(-1.5, 1.5, size=Bn).astype(np.float32)))
    g = (swap_w * xx[..., [0, 2, 1, 3]] + (1.0 - swap_w) * xx).contiguous()
    lam = lam.astype(np.float32)
    re, im = jsvd._subspace_start(2 * chi, chi, "float32")
    out = brick_gate_split_batched(
        _cpx(A), _cpx(Bm), _cpx(g.numpy()), jnp.asarray(lam),
        Cpx(jnp.asarray(re), jnp.asarray(im)), chi, iters=2, interpret=True, pair=True)
    q2j, na0j = jcpx.to_np(out[0]), jcpx.to_np(out[1])
    s2j, totj = np.asarray(out[2]), np.asarray(out[3])
    q2, na0, s2, tot, _ = (t.numpy() for t in split.brick_gate_split(
        torch.from_numpy(A), torch.from_numpy(Bm), g, torch.from_numpy(lam),
        svd.start_block(2 * chi, chi, torch.complex64, CPU), 2, pair=True))
    proj = lambda na, q: na.transpose(0, 2, 1) @ q.conj()
    scale = np.abs(proj(na0j, q2j)).max()
    np.testing.assert_allclose(proj(na0, q2), proj(na0j, q2j), atol=TOL_SPLIT * scale)
    np.testing.assert_allclose(np.sort(s2, 1), np.sort(s2j, 1), atol=TOL_SPLIT * s2j.max())
    np.testing.assert_allclose(tot, totj, rtol=TOL_TOT)


@pytest.mark.parametrize("k", [13, 21])
def test_odd_width_panel_keeps_the_span(k):
    """A panel of odd width (the port takes partial panels; the reference
    never forms one): its last column has no partner and takes the
    single-column step. The pair and single-column plain versions span the
    same space, keep the same columns and zero the same ones; one full
    panel ahead of the odd one at k 21."""
    rng = np.random.default_rng(k)
    for kind in ("full", "rank_deficient", "graded"):
        v = torch.from_numpy(_make(kind, rng, 2, 40, k))
        qp, qs = orth.orth(v, pair=True).numpy(), orth.orth(v, pair=False).numpy()
        _check_basis(qp, qs, TOL_ORTH)
        q, r = orth.qr(v, fused=True, pair=True)
        np.testing.assert_allclose((q @ r).numpy(), v.numpy(), atol=TOL_ORTH)


def _f64_cases():
    rng = np.random.default_rng(40)
    v = torch.from_numpy(_make("rank_deficient", rng)).to(torch.complex128)
    th = torch.from_numpy(_theta(rng)).to(torch.complex128)
    A, Bm, g = (torch.from_numpy(x).to(torch.complex128) for x in _pair_feeds(rng, 8, "full"))
    lam = torch.from_numpy(rng.uniform(0.3, 1.0, size=(2, 8)))
    v0m = svd.start_block(M, K, torch.complex128, CPU)
    v0g = svd.start_block(16, 8, torch.complex128, CPU)
    return {
        "orth": lambda pair: orth.orth_plain(v, pair),
        "orth_r": lambda pair: orth.orth_r_plain(v, pair),
        "split": lambda pair: split.subspace_factor_plain(th, v0m, 2, pair),
        "gate_split": lambda pair: split.gate_subspace_factor_plain(A, Bm, g, v0g, 2, pair),
        "brick_split": lambda pair: split.brick_gate_split_plain(A, Bm, g, lam, v0g, 2, pair),
    }


@pytest.mark.parametrize("name", _build.PAIR_KERNELS)
def test_f64_pair_changes_no_bit(name):
    """complex128 has no pair step (the reference's f64 path never reaches a
    kernel): every plain version's outputs are bit-equal with and without
    ``pair``."""
    fn = _f64_cases()[name]
    single, pair = fn(False), fn(True)
    single = single if isinstance(single, tuple) else (single,)
    pair = pair if isinstance(pair, tuple) else (pair,)
    assert all(torch.equal(a, b) for a, b in zip(single, pair))


def test_pair_gram_matches_reference():
    """The slice: ``build_kernel_matrix`` with ``SimConfig(mgs_pair=True,
    fused_split=True, svd_method="subspace")`` at 8 qubits against the
    reference with ``fused_interpret=True`` (its pair kernels in interpret
    mode), after the reference's own test of the flag
    (tests/test_pallas_split.py, test_cfg_mgs_pair_threads_without_env); and
    against the port's single-column Gram."""
    nq = 8
    X = np.random.default_rng(7).uniform(0.0, 2.0, size=(4, nq))
    em = entanglement_graph(nq, 2)
    base = dict(chi=16, precision="f32", svd_method="subspace", fused_split=True)
    k_ref = ref_build(RefAnsatz(nq, 1, 1.0, em), X,
                      cfg=RefConfig(mgs_pair=True, fused_interpret=True, **base),
                      sim_batch=4, tile=4)
    ansatz = KernelStateAnsatz(nq, 1, 1.0, em)
    k_pair = build_kernel_matrix(ansatz, X, cfg=SimConfig(mgs_pair=True, **base), sim_batch=4,
                                 tile=4, device="cpu")
    k_single = build_kernel_matrix(ansatz, X, cfg=SimConfig(**base), sim_batch=4, tile=4,
                                   device="cpu")
    np.testing.assert_allclose(k_pair, k_ref, atol=TOL_GRAM)
    np.testing.assert_allclose(k_pair, k_single, atol=TOL_GRAM)
