"""Kernel K4 (gate + theta build + split) and the fused-gate two-site
update of the PyTorch port, on the CPU: K4's plain version against the
reference Pallas kernel in interpret mode
(``pallas_split.gate_split_factor_batched(interpret=True)``), then the
port's ``apply_2site`` under ``fused_gate`` against the reference's with
``fused_interpret=True``. The CUDA kernel itself is held against the plain
version on a card in test_torch_cuda.py.

Tolerances: both sides run the same f32 algorithm from the same start
block; 2e-5 is the reference's fused-vs-unfused bar on q/r and 3e-5 its bar
on the contracted pair (tests/test_pallas_gate_split.py). Comparisons use
basis-invariant quantities: projectors, products, sorted squared singular
values, the pair product ``new_a . new_b``, fidelity and rank."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qml_cutensornet_tpu.config import SimConfig as RefConfig
from qml_cutensornet_tpu.ops import cpx as jcpx
from qml_cutensornet_tpu.ops import gates as jgates
from qml_cutensornet_tpu.ops import mps as jmps
from qml_cutensornet_tpu.ops import svd as jsvd
from qml_cutensornet_tpu.ops.cpx import Cpx
from qml_cutensornet_tpu.ops.pallas_split import gate_split_factor_batched
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.ops import _build, mps, split, svd

TOL = 2e-5
TOL_PAIR = 3e-5
CHI = 16


def _crandn(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _cpx(a):
    return Cpx(jnp.asarray(a.real, jnp.float32), jnp.asarray(a.imag, jnp.float32))


def _gate_mats(rng):
    u, _ = np.linalg.qr(_crandn(rng, 4, 4))
    return {
        "xxphase": jcpx.to_np(jgates.xxphase(jnp.asarray(0.7, jnp.float32), jnp.float32)),
        "swap": jcpx.to_np(jgates.swap(jnp.float32)),
        "zzphase": jcpx.to_np(jgates.zzphase(jnp.asarray(-1.3, jnp.float32), jnp.float32)),
        "random_unitary": u,
    }


GATES = ["xxphase", "swap", "zzphase", "random_unitary"]


def _sites(rng, batch, n, chi, rank):
    """Random padded site tensors with exact zeros beyond ``rank`` on every
    bond and one-dimensional boundary bonds."""
    t = _crandn(rng, batch, n, chi, 2, chi)
    t[:, :, rank:] = 0.0
    t[..., rank:] = 0.0
    t[:, 0, 1:] = 0.0
    t[:, -1, :, :, 1:] = 0.0
    return (t / np.abs(t).max()).astype(np.complex64)


@pytest.mark.parametrize("iters", [1, 2])
def test_plain_matches_pallas_kernel(iters):
    rng = np.random.default_rng(iters)
    b, chi, nc = 4, 8, 16
    t = _sites(rng, b, 3, chi, 5)
    A = np.ascontiguousarray(t[:, 1].transpose(0, 2, 1, 3)).reshape(b, 2 * chi, chi)
    Bm = t[:, 2].reshape(b, chi, 2 * chi)
    A[2:] = (_crandn(rng, 2, 2 * chi, chi) / 3).astype(np.complex64)  # full rank: truncates
    Bm = Bm.copy()
    Bm[2:] = (_crandn(rng, 2, chi, 2 * chi) / 3).astype(np.complex64)
    mats = _gate_mats(rng)
    g = np.stack([mats[name] for name in GATES]).astype(np.complex64)
    re, im = jsvd._subspace_start(2 * chi, nc, "float32")
    v0 = torch.complex(torch.from_numpy(re), torch.from_numpy(im))

    q, r, tot, res = split.gate_subspace_factor(torch.from_numpy(A), torch.from_numpy(Bm),
                                                torch.from_numpy(g), v0, iters)
    q, r, tot, res = q.numpy(), r.numpy(), tot.numpy(), res.numpy()
    qj, rj, totj = gate_split_factor_batched(
        _cpx(A), _cpx(Bm), _cpx(g), Cpx(jnp.asarray(re), jnp.asarray(im)), nc,
        iters=iters, interpret=True)
    qj, rj = jcpx.to_np(qj), jcpx.to_np(rj)

    theta = np.einsum("zstuv,zuavb->zsatb", g.reshape(b, 2, 2, 2, 2),
                      (A.astype(np.complex128) @ Bm).reshape(b, 2, chi, 2, chi))
    theta = theta.reshape(b, 2 * chi, 2 * chi)
    np.testing.assert_allclose(split.gate_theta(torch.from_numpy(A), torch.from_numpy(Bm),
                                                torch.from_numpy(g)).numpy(), theta, atol=1e-6)
    np.testing.assert_allclose(tot, (np.abs(theta) ** 2).sum((1, 2)), rtol=1e-5)
    np.testing.assert_allclose(tot, np.asarray(totj), rtol=1e-5)
    hT = lambda x: np.conj(np.swapaxes(x, 1, 2))
    # the weight the directions miss, ||theta - q r||^2 of the port's factors
    np.testing.assert_allclose(res, (np.abs(theta - q @ r) ** 2).sum((1, 2)),
                               atol=1e-6 * tot.max())
    np.testing.assert_allclose(q @ hT(q), qj @ hT(qj), atol=TOL)
    np.testing.assert_allclose(q @ r, qj @ rj, atol=TOL)
    s2 = lambda x: np.sort((np.abs(x) ** 2).sum(2), axis=1)
    np.testing.assert_allclose(s2(r), s2(rj), atol=TOL * s2(rj).max())
    # rank <= nc elements are reconstructed; dropped directions are exact zeros
    np.testing.assert_allclose((q @ r)[:2], theta[:2], atol=5e-6)
    dead = np.linalg.norm(q, axis=1) < 0.5
    assert dead[:2].any() and not dead[2:].any()
    assert np.count_nonzero(q[np.broadcast_to(dead[:, None, :], q.shape)]) == 0


def _ref_cfg(fused_gate, **kw):
    kw.setdefault("subspace_iters", 1)
    return RefConfig(chi=CHI, precision="f32", svd_method="subspace", fused_split=True,
                     fused_gate=fused_gate, fused_interpret=True, **kw)


def _pair(t, site):
    return np.einsum("...asb,...btc->...astc", t[..., site, :, :, :], t[..., site + 1, :, :, :])


def _ref_apply(t, g, cfg, direction):
    state = jmps.MPS(tensors=_cpx(t), fidelity=jnp.asarray(1.0, jnp.float32),
                     bond_dims=jnp.full((t.shape[0] - 1,), 6, jnp.int32))
    out = jmps.apply_2site(state, 1, _cpx(g), cfg, direction)
    return jcpx.to_np(out.tensors), float(out.fidelity), int(out.bond_dims[1])


@pytest.mark.parametrize("direction", [None, 0, 1])
def test_apply_2site_fused_gate_matches_reference(direction):
    """Every gate kind as one batch: the port's fused-gate update against the
    reference's fused-gate update (interpret mode) and against the port's own
    unfused-theta update, on the contracted pair, fidelity and rank."""
    rng = np.random.default_rng(5)
    t = _sites(rng, len(GATES), 4, CHI, 6)
    mats = _gate_mats(rng)
    g = np.stack([mats[name] for name in GATES]).astype(np.complex64)
    rcfg = _ref_cfg(True)
    assert jsvd.gate_split_eligible(rcfg, CHI)
    outs = {}
    for fused_gate in (True, False):
        cfg = SimConfig.from_reference(dataclasses.asdict(_ref_cfg(fused_gate)))
        assert svd.gate_split_eligible(cfg, CHI) is fused_gate
        state = mps.mps_from_reference(t.real, t.imag, np.ones(len(GATES), np.float32),
                                       np.full((len(GATES), 3), 6))
        outs[fused_gate] = mps.mps_to_numpy(
            mps.apply_2site(state, 1, torch.from_numpy(g), cfg, direction))
    ot, ofid, obd = outs[True]
    np.testing.assert_allclose(_pair(ot, 1), _pair(outs[False][0], 1), atol=TOL_PAIR)
    np.testing.assert_array_equal(obd, outs[False][2])
    np.testing.assert_allclose(ofid, outs[False][1], atol=1e-5)
    np.testing.assert_array_equal(ot[:, 0], t[:, 0])  # sites outside the pair untouched
    np.testing.assert_array_equal(ot[:, 3], t[:, 3])
    # outer bonds keep their zero padding
    assert np.abs(ot[:, 1, 6:]).max() == 0.0 and np.abs(ot[:, 2, :, :, 6:]).max() == 0.0
    for i, name in enumerate(GATES):
        rt, rfid, rrank = _ref_apply(t[i], g[i], rcfg, direction)
        np.testing.assert_allclose(_pair(ot[i], 1), _pair(rt, 1), atol=TOL_PAIR, err_msg=name)
        assert abs(ofid[i] - rfid) <= 1e-5 and obd[i, 1] == rrank, name


@pytest.mark.parametrize("iters,oversample", [(2, 0), (1, 16)])
def test_fused_gate_iters_and_oversample(iters, oversample):
    """iters 2 and oversampling (nc = chi + 16) on a truncating update."""
    rng = np.random.default_rng(8)
    t = _sites(rng, 2, 4, CHI, CHI)  # full bonds: the split truncates
    g = np.stack([_gate_mats(rng)["random_unitary"]] * 2).astype(np.complex64)
    rcfg = _ref_cfg(True, subspace_iters=iters, oversample=oversample)
    cfg = SimConfig.from_reference(dataclasses.asdict(rcfg))
    assert svd.gate_split_eligible(cfg, CHI)
    state = mps.mps_from_reference(t.real, t.imag, np.ones(2, np.float32), np.full((2, 3), CHI))
    ot, ofid, obd = mps.mps_to_numpy(mps.apply_2site(state, 1, torch.from_numpy(g), cfg, 1))
    for i in range(2):
        rt, rfid, rrank = _ref_apply(t[i], g[i], rcfg, 1)
        np.testing.assert_allclose(_pair(ot[i], 1), _pair(rt, 1), atol=TOL_PAIR)
        assert abs(ofid[i] - rfid) <= 1e-5 and obd[i, 1] == rrank and ofid[i] < 0.999


def test_eligibility_follows_the_reference():
    """Which stages of the ramp go to K4: chi a multiple of 8 and nc a
    multiple of 16 up to 128, as the reference routes them in f32."""
    for chi in (4, 8, 12, 16, 32, 64, 128, 256):
        for over in (0, 8, 16):
            for fs, fg in ((True, True), (True, False), (False, True)):
                rcfg = RefConfig(chi=chi, svd_method="subspace", fused_split=fs, fused_gate=fg,
                                 fused_interpret=True, oversample=over)
                cfg = SimConfig.from_reference(dataclasses.asdict(rcfg))
                assert svd.gate_split_eligible(cfg, chi) == jsvd.gate_split_eligible(rcfg, chi)
    sub = dict(svd_method="subspace", fused_split=True, fused_gate=True)
    assert not svd.gate_split_eligible(SimConfig(chi=8, **sub), 8)
    assert svd.gate_split_eligible(SimConfig(chi=16, **sub), 16)


def test_kernel_wrapper_refuses_cpu_tensors():
    z = lambda *s: torch.zeros(s, dtype=torch.complex64)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        split.gate_subspace_factor_cuda(z(2, 32, 16), z(2, 16, 32), z(2, 4, 4), z(32, 16), 1)
    assert _build.LAUNCHES == before and _build.PLAIN_ON_CUDA["gate_split"] == 0
