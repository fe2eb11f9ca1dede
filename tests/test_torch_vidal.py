"""The brick (Vidal / Hastings) engine of the PyTorch port against the
reference on the CPU: ``update_pairs`` on both routes (the unfused route,
pair product in torch and the right split through K1's plain version,
against the reference's XLA route; and kernel K5's plain version against the
reference's K5 in interpret mode), K5's plain
version against ``pallas_split.brick_gate_split_batched(interpret=True)``,
and ``brick_layer`` over the leading dummy pair and an inactive pair, with
one state fed to both packages. The CUDA kernel itself is held against the
plain version on a card in test_torch_cuda.py.

Tolerances (f32; both sides run the same algorithm from the same start
block): 3e-5 on pair products, sorted Schmidt values and states, the
reference's own bar for its fused brick update against the unfused one
(tests/test_pallas_gate_split.py); 1e-5 on kept fractions; ranks exact; 2e-5
on K5's basis-level outputs, its bar on q and r."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qml_cutensornet_tpu.config import SimConfig as RefConfig
from qml_cutensornet_tpu.ops import cpx as jcpx
from qml_cutensornet_tpu.ops import svd as jsvd
from qml_cutensornet_tpu.ops import vidal as jvidal
from qml_cutensornet_tpu.ops.cpx import Cpx
from qml_cutensornet_tpu.ops.pallas_split import brick_gate_split_batched
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.ops import _build, split, svd, vidal
from qml_cutensornet_tpu_torch.ops.mps import to_dense

TOL_PAIR = 3e-5
TOL_BASIS = 2e-5
CHI = 16
RANK = 5


def _crandn(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _cpx(a):
    return Cpx(jnp.asarray(a.real, jnp.float32), jnp.asarray(a.imag, jnp.float32))


def _ref_cfg(fused_gate, **kw):
    """The reference's config for a route: with ``fused_gate`` its K5 runs in
    interpret mode; without, its XLA route (on the CPU the reference
    orthonormalizes there by Householder QR, a cheaper compile than its K1
    in interpret mode, with the same subspace to rounding)."""
    kw.setdefault("subspace_iters", 1)
    return RefConfig(chi=CHI, precision="f32", svd_method="subspace", fused_split=True,
                     fused_gate=fused_gate, fused_interpret=fused_gate, **kw)


def _padded(rng, shape, rank):
    """Random site tensors ``[..., chi, 2, chi]`` with exact zeros beyond
    ``rank`` on both bonds, max |entry| 1."""
    t = _crandn(rng, *shape)
    t[..., rank:, :, :] = 0.0
    t[..., :, :, rank:] = 0.0
    return (t / np.abs(t).max()).astype(np.complex64)


def _lams(rng, shape, rank):
    lam = np.zeros(shape, np.float32)
    lam[..., :rank] = rng.uniform(0.3, 1.0, size=shape[:-1] + (rank,))
    return lam


@pytest.mark.parametrize("route", ["unfused", "k5"])
@pytest.mark.parametrize("swap_w", [0.0, 1.0])
@pytest.mark.parametrize("iters,oversample", [(1, 0), (2, 16)])
def test_update_pairs_matches_reference(route, swap_w, iters, oversample):
    rng = np.random.default_rng(12)
    B, K = 2, 3
    a = _padded(rng, (B, K, CHI, 2, CHI), RANK)
    b = _padded(rng, (B, K, CHI, 2, CHI), RANK)
    lam = _lams(rng, (B, K, CHI), RANK)
    thetas = rng.uniform(-1.0, 1.0, size=(B, K)).astype(np.float32)
    rcfg = _ref_cfg(route == "k5", subspace_iters=iters, oversample=oversample)
    cfg = SimConfig.from_reference(dataclasses.asdict(rcfg))
    assert svd.brick_split_eligible(cfg, CHI, CHI, CHI) is (route == "k5")
    assert jsvd.brick_split_eligible(rcfg, CHI, CHI, CHI) is (route == "k5")

    na, nb, s, kf, rk = jvidal.update_pairs(_cpx(a), _cpx(b), jnp.asarray(lam),
                                            jnp.asarray(thetas), jnp.float32(swap_w), rcfg)
    ref = (np.einsum("bkasc,bkctd->bkastd", jcpx.to_np(na), jcpx.to_np(nb)),
           np.asarray(s), np.asarray(kf), np.asarray(rk))
    _build.reset_counters()
    pa, pb, ps, pkf, prk = vidal.update_pairs(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(lam),
        torch.from_numpy(thetas), swap_w, cfg)
    assert sum(_build.PLAIN_ON_CUDA.values()) == 0
    pair = torch.einsum("bkasc,bkctd->bkastd", pa, pb).numpy()
    np.testing.assert_allclose(pair, ref[0], atol=TOL_PAIR)
    np.testing.assert_allclose(np.sort(ps.numpy(), -1), np.sort(ref[1], -1), atol=TOL_PAIR)
    np.testing.assert_allclose(pkf.numpy(), ref[2], atol=1e-5)
    np.testing.assert_array_equal(prk.numpy(), ref[3])
    assert (pa.shape, pb.shape, ps.shape) == ((B, K, CHI, 2, CHI),) * 2 + ((B, K, CHI),)
    # the bond keeps its exact zeros
    assert torch.count_nonzero(pa[:, :, RANK:]) == 0 and torch.count_nonzero(pb[..., RANK:]) == 0


@pytest.mark.parametrize("iters,nc", [(1, 16), (2, 16)])
def test_brick_plain_matches_pallas_kernel(iters, nc):
    """K5's plain version against the reference kernel in interpret mode on
    basis-invariant quantities: ``theta_t V^H V`` (from na0 and q2), sorted
    s2, total and orthonormality; rank-5 elements with lambda zero past the
    rank, and full-rank elements whose split truncates."""
    rng = np.random.default_rng(iters + nc)
    Bn, chi = 4, CHI
    a = _padded(rng, (Bn, chi, 2, chi), RANK)
    b = _padded(rng, (Bn, chi, 2, chi), RANK)
    a[2:] = (_crandn(rng, 2, chi, 2, chi) / 3).astype(np.complex64)
    b[2:] = (_crandn(rng, 2, chi, 2, chi) / 3).astype(np.complex64)
    lam = _lams(rng, (Bn, chi), RANK)
    lam[2:] = rng.uniform(0.1, 1.0, size=(2, chi))
    g = np.linalg.qr(_crandn(rng, Bn, 4, 4))[0].astype(np.complex64)
    A = np.ascontiguousarray(a.transpose(0, 2, 1, 3)).reshape(Bn, 2 * chi, chi)
    Bm = b.reshape(Bn, chi, 2 * chi)
    re, im = jsvd._subspace_start(2 * chi, nc, "float32")
    v0 = torch.complex(torch.from_numpy(re), torch.from_numpy(im))

    q2, na0, s2, total, res = (x.numpy() for x in split.brick_gate_split(
        torch.from_numpy(A), torch.from_numpy(Bm), torch.from_numpy(g), torch.from_numpy(lam),
        v0, iters))
    jq2, jna0, js2, jtot = brick_gate_split_batched(
        _cpx(A), _cpx(Bm), _cpx(g), jnp.asarray(lam), Cpx(jnp.asarray(re), jnp.asarray(im)),
        nc, iters=iters, interpret=True)
    jq2, jna0, js2, jtot = jcpx.to_np(jq2), jcpx.to_np(jna0), np.asarray(js2), np.asarray(jtot)

    theta_t = np.einsum("zstuv,zuavb->zsatb", g.reshape(Bn, 2, 2, 2, 2),
                        (A.astype(np.complex128) @ Bm).reshape(Bn, 2, chi, 2, chi))
    theta_t = theta_t.reshape(Bn, 2 * chi, 2 * chi)
    theta_w = theta_t * np.concatenate([lam, lam], 1)[:, :, None]
    np.testing.assert_allclose(total, (np.abs(theta_w) ** 2).sum((1, 2)), rtol=1e-5)
    np.testing.assert_allclose(total, jtot, rtol=1e-5)
    # the weight the directions miss: the chain runs on theta_w^H with q = q2^T
    th_h, q = np.conj(np.swapaxes(theta_w, 1, 2)), np.swapaxes(q2, 1, 2)
    resid = np.abs(th_h - q @ (np.conj(np.swapaxes(q, 1, 2)) @ th_h)) ** 2
    np.testing.assert_allclose(res, resid.sum((1, 2)), atol=1e-6 * total.max())
    proj = lambda na, q: np.swapaxes(na, 1, 2) @ np.conj(q)  # theta_t V^H V, V = conj(q2)
    scale = np.abs(theta_t).max()
    np.testing.assert_allclose(proj(na0, q2) / scale, proj(jna0, jq2) / scale, atol=TOL_BASIS)
    np.testing.assert_allclose(np.sort(s2, 1), np.sort(js2, 1), atol=TOL_BASIS * js2.max())
    # rank <= nc elements are reconstructed exactly (lambda > 0 on their rows)
    np.testing.assert_allclose(proj(na0, q2)[:2], theta_t[:2], atol=5e-6)
    live = np.linalg.norm(q2, axis=2) > 0.5
    gram = np.conj(q2) @ np.swapaxes(q2, 1, 2)
    np.testing.assert_allclose(gram, np.eye(nc)[None] * live[:, :, None], atol=5e-6)
    assert np.count_nonzero(q2[~live]) == 0 and np.count_nonzero(na0[~live]) == 0


def _layer_state(rng, B, n_p, chi):
    """A state over ``n_p`` padded sites with rank-5 bonds, one-dimensional
    end bonds and Schmidt weights zero past the rank."""
    t = _padded(rng, (B, n_p, chi, 2, chi), RANK)
    t[:, 0, 1:] = 0.0
    t[:, -1, :, :, 1:] = 0.0
    lams = _lams(rng, (B, n_p - 1, chi), RANK)
    bond_dims = np.full((B, n_p - 1), RANK, np.int32)
    return t, lams, np.ones(B, np.float32), bond_dims


@pytest.mark.parametrize("fused_gate", [False, True])
def test_brick_layer_matches_reference(fused_gate):
    """Two layers on 5 real sites (7 padded, 3 pairs): parity 0 with the
    leading dummy pair (idx 0, whose left weights are ones) active and pair 1
    inactive, then parity 1 with pair 2 inactive; one state fed to both
    packages. Compared: the state vector, sorted Schmidt weights, bond
    dimensions and fidelity; inactive pairs and their weights untouched."""
    rng = np.random.default_rng(21)
    B, n_p, K = 2, 7, 3
    t, lams, fid, bd = _layer_state(rng, B, n_p, CHI)
    layers = [(0, 1.0, np.array([True, False, True])), (1, 0.0, np.array([True, True, False]))]
    thetas = rng.uniform(-1.0, 1.0, size=(len(layers), B, K)).astype(np.float32)
    rcfg = _ref_cfg(fused_gate, subspace_iters=2)
    cfg = SimConfig.from_reference(dataclasses.asdict(rcfg))

    jst = jvidal.VidalState(tensors=_cpx(t), lams=jnp.asarray(lams), fidelity=jnp.asarray(fid),
                            bond_dims=jnp.asarray(bd))
    pst = vidal.vidal_state_from_reference(t.real, t.imag, lams, fid, bd)
    for li, (parity, swap_w, active) in enumerate(layers):
        jst = jvidal.brick_layer(jst, jnp.int32(parity), jnp.float32(swap_w),
                                 jnp.asarray(active), jnp.asarray(thetas[li]), rcfg)
        before = vidal.vidal_state_to_numpy(pst)
        pst = vidal.brick_layer(pst, parity, swap_w, torch.from_numpy(active),
                                torch.from_numpy(thetas[li]), cfg)
        after = vidal.vidal_state_to_numpy(pst)
        for k in np.nonzero(~active)[0]:  # inactive pair: exact no-op
            i = parity + 2 * k
            np.testing.assert_array_equal(after[0][:, i:i + 2], before[0][:, i:i + 2])
            np.testing.assert_array_equal(after[1][:, i], before[1][:, i])
            np.testing.assert_array_equal(after[3][:, i], before[3][:, i])

    pt, plams, pfid, pbd = vidal.vidal_state_to_numpy(pst)
    jt = jcpx.to_np(jst.tensors)
    for z in range(B):
        ref_vec = to_dense(jt[z], n_p)
        scale = np.abs(ref_vec).max()
        np.testing.assert_allclose(to_dense(pt[z], n_p) / scale, ref_vec / scale, atol=TOL_PAIR)
    np.testing.assert_allclose(np.sort(plams, -1), np.sort(np.asarray(jst.lams), -1),
                               atol=TOL_PAIR)
    np.testing.assert_array_equal(pbd, np.asarray(jst.bond_dims))
    np.testing.assert_allclose(pfid, np.asarray(jst.fidelity), atol=1e-5)
    # the real sites' MPS: the dummy sites and their bonds stripped
    tensors, fidelity, bond_dims = vidal.to_mps_tensors(pst, n_p - 2)
    assert tensors.shape == (B, n_p - 2, CHI, 2, CHI) and bond_dims.shape == (B, n_p - 3)


def test_kernel_wrapper_refuses_cpu_tensors():
    z = lambda *s: torch.zeros(s, dtype=torch.complex64)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        split.brick_gate_split_cuda(z(2, 32, 16), z(2, 16, 32), z(2, 4, 4),
                                    torch.ones(2, 16), z(32, 16), 1)
    assert _build.LAUNCHES == before and _build.PLAIN_ON_CUDA["brick_split"] == 0
