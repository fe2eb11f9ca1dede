"""The "svd" and "eigh" methods of the port's truncated factorization
(``ops/svd.truncated_svd``: ``torch.linalg.svd`` of theta, or
``torch.linalg.eigh`` of theta theta^H) against the reference's (the real
embedding and its greedy complex basis), on the CPU.

Inputs are made from a numpy seed with a known spectrum: a bond-cap cut with
a gap at the cap, a ``truncation_error`` cut, an exactly rank-deficient
theta (in f32 cut by ``value_of_zero > 0``, since its zero singular values
come out as rounding; in f64 the eps rule cuts them), ``renormalize``, and
exact-zero rows (the bond padding, whose many-fold null block the eigh
route decomposes in a rotated basis).
Only the kept subspace is defined, so the comparisons are basis-free: the
projector ``left left^H`` and ``left @ right`` (1e-5 in f32, 1e-10 in f64),
kept_fraction and rank (equal), and orthonormal kept columns with exact
zeros past the mask. Then ``truncated_split_right`` with "svd", an 8-qubit
Gram with each method against the reference's (3e-5 in f32), and the
routing rule: K4 and K5 never take either method, in either package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qml_cutensornet_tpu.config import SimConfig as RefConfig
from qml_cutensornet_tpu.models.ansatz import KernelStateAnsatz as RefAnsatz
from qml_cutensornet_tpu.models.gram import build_kernel_matrix as ref_build
from qml_cutensornet_tpu.ops import svd as jsvd
from qml_cutensornet_tpu.ops.cpx import Cpx
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix
from qml_cutensornet_tpu_torch.ops import svd

B, M, K, KEEP = 3, 16, 12, 8
TOL = {"f32": 1e-5, "f64": 1e-10}
CDT = {"f32": np.complex64, "f64": np.complex128}

# kind -> (singular values [min(M, K)], SimConfig overrides)
CASES = {
    # bond cap: a gap of 10x at the cap
    "cap": (np.concatenate([np.geomspace(1.0, 0.3, 8), np.geomspace(0.03, 0.003, 4)]), {}),
    # truncation_error 1e-4 cuts after rank 5
    "eps": (np.concatenate([np.geomspace(1.0, 0.3, 5), np.geomspace(1e-3, 1e-5, 7)]),
            dict(truncation_error=1e-4)),
    # exact rank 5; value_of_zero drops the rounding-level values
    "rankdef_voz": (np.concatenate([np.geomspace(1.0, 0.2, 5), np.zeros(7)]),
                    dict(value_of_zero=1e-3)),
    "renormalize": (np.concatenate([np.geomspace(1.0, 0.3, 8), np.geomspace(0.03, 0.003, 4)]),
                    dict(renormalize=True)),
    # bond padding: rows 10..15 of theta exact zeros (the eigh route's
    # degenerate null block)
    "padded_rows": (np.concatenate([np.geomspace(1.0, 0.3, 8), np.geomspace(0.03, 0.003, 2)]),
                    {}),
}


def _theta(seed, sv, dtype):
    """``U diag(sv) W^H`` with random isometries; with fewer than M
    singular values the rows of U past ``len(sv)`` are exact zeros."""
    rng = np.random.default_rng(seed)
    r = len(sv)
    rows = M if r == min(M, K) else r
    u = np.zeros((B, M, r), complex)
    u[:, :rows], _ = np.linalg.qr(rng.standard_normal((B, rows, r))
                                  + 1j * rng.standard_normal((B, rows, r)))
    w, _ = np.linalg.qr(rng.standard_normal((B, K, K)) + 1j * rng.standard_normal((B, K, K)))
    return ((u * sv) @ w[:, :, :r].conj().transpose(0, 2, 1)).astype(dtype)


def _ref_batched(fn, theta, rcfg, keep):
    out = jax.vmap(lambda re, im: fn(Cpx(re, im), rcfg, keep))(
        jnp.asarray(theta.real), jnp.asarray(theta.imag))
    to = lambda c: np.asarray(c.re) + 1j * np.asarray(c.im)
    second = to(out[1]) if isinstance(out[1], Cpx) else np.asarray(out[1])
    return to(out[0]), second, np.asarray(out[2]), np.asarray(out[3])


def _check_masked_isometry(left, rank, tol):
    """Kept columns orthonormal, masked columns exact zeros."""
    for b in range(left.shape[0]):
        live = np.abs(left[b]).sum(0) > 0
        assert live.sum() >= rank[b]
        g = left[b][:, live].conj().T @ left[b][:, live]
        np.testing.assert_allclose(g, np.eye(live.sum()), atol=tol)


# Only the f64 SVD puts the zero singular values of a rank-deficient theta
# below the eps rule (f32 and eigh's squared spectrum leave them at rounding
# level, which the voz case cuts instead).
@pytest.mark.parametrize("method,precision,kind", [
    (m, p, k) for m in ("svd", "eigh") for p in ("f32", "f64") for k in CASES
] + [("svd", "f64", "rankdef_svd_f64")])
def test_truncated_svd_matches_reference(method, precision, kind):
    if kind == "rankdef_svd_f64":
        sv, over = CASES["rankdef_voz"][0], {}
    else:
        sv, over = CASES[kind]
    theta = _theta(len(kind) + (method == "eigh"), sv, CDT[precision])
    rcfg = RefConfig(chi=KEEP, svd_method=method, precision=precision, **over)
    cfg = SimConfig.from_reference(dataclasses.asdict(rcfg))
    left, right, kf, rank = (t.numpy() for t in svd.truncated_svd(torch.from_numpy(theta), cfg,
                                                                    KEEP))
    rl, rr, rkf, rrank = _ref_batched(jsvd.truncated_svd, theta, rcfg, KEEP)
    tol = TOL[precision]
    proj = left @ left.conj().transpose(0, 2, 1)
    np.testing.assert_allclose(proj, rl @ rl.conj().transpose(0, 2, 1), atol=tol)
    np.testing.assert_allclose(left @ right, rl @ rr, atol=tol)
    np.testing.assert_allclose(kf, rkf, atol=tol)
    np.testing.assert_array_equal(rank, rrank)
    want_rank = {"cap": 8, "eps": 5, "rankdef_voz": 5, "rankdef_svd_f64": 5,
                 "renormalize": 8, "padded_rows": 8}[kind]
    assert (rank == want_rank).all(), rank
    _check_masked_isometry(left, rank, tol)
    if kind != "renormalize":
        # the optimal truncation: left @ right is the projection of theta
        np.testing.assert_allclose(left @ right, proj @ theta, atol=tol)


def test_truncated_split_right_svd_matches_reference():
    sv = CASES["cap"][0]
    theta = _theta(7, sv, np.complex128).transpose(0, 2, 1).copy()  # [B, K, M]
    rcfg = RefConfig(chi=KEEP, svd_method="svd", precision="f64")
    cfg = SimConfig.from_reference(dataclasses.asdict(rcfg))
    v, s, kf, rank = (t.resolve_conj().numpy()
                      for t in svd.truncated_split_right(torch.from_numpy(theta), cfg, KEEP))
    rv, rs, rkf, rrank = _ref_batched(jsvd.truncated_split_right, theta, rcfg, KEEP)
    proj = v.conj().transpose(0, 2, 1) @ v
    np.testing.assert_allclose(proj, rv.conj().transpose(0, 2, 1) @ rv, atol=1e-10)
    np.testing.assert_allclose(np.sort(s, 1), np.sort(np.asarray(rs), 1), atol=1e-10)
    np.testing.assert_allclose(np.sort(s, 1)[:, ::-1], np.broadcast_to(sv[:KEEP], (B, KEEP)),
                               atol=1e-10)
    np.testing.assert_allclose(kf, rkf, atol=1e-10)
    np.testing.assert_array_equal(rank, rrank)


@pytest.mark.parametrize("method", ["svd", "eigh"])
def test_gram_matches_reference(method):
    """8 qubits, r 1, d 2 at chi 8 (bonds truncate), f32, staged chi off."""
    nq = 8
    X = np.random.default_rng(4).uniform(0.0, 2.0, size=(5, nq))
    em = entanglement_graph(nq, 2)
    rcfg = RefConfig(chi=8, precision="f32", svd_method=method, tile_block=2)
    K_ref = ref_build(RefAnsatz(nq, 1, 1.0, em), X, cfg=rcfg, sim_batch=5, tile=8)
    K = build_kernel_matrix(KernelStateAnsatz(nq, 1, 1.0, em), X,
                            cfg=SimConfig.from_reference(dataclasses.asdict(rcfg)),
                            sim_batch=5, tile=8, device="cpu")
    np.testing.assert_allclose(K, K_ref, atol=3e-5)
    assert np.abs(K - np.eye(5)).max() > 1e-2  # the test is not vacuous


def test_kernels_never_take_svd_or_eigh():
    """The fused-gate (K4) and brick (K5) routes are the subspace method's,
    in both packages, for every method and flag combination."""
    for method in ("svd", "eigh", "subspace"):
        for fs, fg in ((True, True), (True, False), (False, True)):
            for chi in (8, 16, 64):
                rcfg = RefConfig(chi=chi, svd_method=method, fused_split=fs, fused_gate=fg,
                                 fused_interpret=True)
                cfg = SimConfig.from_reference(dataclasses.asdict(rcfg))
                want = jsvd.gate_split_eligible(rcfg, chi)
                assert svd.gate_split_eligible(cfg, chi) == want
                assert svd.brick_split_eligible(cfg, chi, chi, chi) == \
                    jsvd.brick_split_eligible(rcfg, chi, chi, chi)
                if method != "subspace":
                    assert not want and not svd.brick_split_eligible(cfg, chi, chi, chi)
    # power_precision other than "inherit" keeps a configuration off the kernels
    cfg = SimConfig(chi=16, svd_method="subspace", fused_split=True, fused_gate=True,
                    power_precision="highest")
    assert not svd.gate_split_eligible(cfg, 16)
    assert not svd.brick_split_eligible(cfg, 16, 16, 16)


def test_eigh_of_a_padded_theta_is_finite():
    """A theta of the first steps of a chain: rank 2 on 4 live rows of 128,
    the rest exact zeros. On theta theta^H itself, with its 124-fold null
    block, the library eigensolver fails (MKL: no convergence or NaN
    vectors); the rotated decomposition keeps the reference's and the svd
    method's truncation of theta. Both eigh versions also keep rounding-level
    directions of the null block (the f32 eps rule does not cut them)."""
    rng = np.random.default_rng(0)
    theta = np.zeros((2, 128, 128), np.complex64)
    for b in range(2):
        a = rng.standard_normal((4, 2)) + 1j * rng.standard_normal((4, 2))
        w = rng.standard_normal((2, 128)) + 1j * rng.standard_normal((2, 128))
        theta[b, [0, 1, 64, 65]] = a @ np.diag([1.0, 0.07]) @ w / 12
    rcfg = RefConfig(chi=64, svd_method="eigh", precision="f32")
    cfg = SimConfig.from_reference(dataclasses.asdict(rcfg))
    left, right, kf, rank = (t.numpy() for t in svd.truncated_svd(torch.from_numpy(theta), cfg,
                                                                    64))
    assert np.isfinite(left).all() and np.isfinite(right).all()
    sl, sr, _, srank = (t.numpy() for t in svd.truncated_svd(
        torch.from_numpy(theta), dataclasses.replace(cfg, svd_method="svd"), 64))
    rl, rr, rkf, _ = _ref_batched(jsvd.truncated_svd, theta, rcfg, 64)
    for other_l, other_r in ((sl, sr), (rl, rr)):
        np.testing.assert_allclose(left @ right, other_l @ other_r, atol=1e-5)
    np.testing.assert_allclose(kf, rkf, atol=1e-5)
    assert (rank >= 2).all() and (srank >= 2).all()
    _check_masked_isometry(left, rank, 1e-5)
