"""MPS operations of the PyTorch port against the JAX reference and the dense
statevector model (``qml_cutensornet_tpu/ops/dense.py``).

One padded random state (nq=6, chi 8, so no update truncates) is carried
into both engines with ``mps_from_reference``; one ``apply_2site`` per
two-site gate kind and direction, and one ``move_center`` per direction,
are compared on basis-invariant quantities: the pair product
``new_a . new_b`` (unique for an untruncated update) and the dense state.
Tolerances: 1e-5 in f32 (accumulation noise of 8x8 factorizations, inside
the reference's 2e-5 kernel bar); 1e-10 in f64 against the dense model."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qml_cutensornet_tpu.config import SimConfig as RefConfig
from qml_cutensornet_tpu.ops import cpx as jcpx
from qml_cutensornet_tpu.ops import dense
from qml_cutensornet_tpu.ops import gates as jgates
from qml_cutensornet_tpu.ops import mps as jmps
from qml_cutensornet_tpu.ops.cpx import Cpx
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import GATE_SWAP, GATE_XX, GATE_XXSW, GATE_ZZ
from qml_cutensornet_tpu_torch.models.simulate import apply_schedule_op
from qml_cutensornet_tpu_torch.ops import gates, mps

NQ, CHI, SITE = 6, 8, 2


def _random_state(rng, batch, dtype):
    """Padded random MPS: bond k has dim min(2^(k+1), 2^(n-k-1), chi);
    entries outside the live blocks are exact zeros."""
    bonds = [1] + [min(2 ** (k + 1), 2 ** (NQ - k - 1), CHI) for k in range(NQ - 1)] + [1]
    t = np.zeros((batch, NQ, CHI, 2, CHI), np.complex128)
    for i in range(NQ):
        l, r = bonds[i], bonds[i + 1]
        t[:, i, :l, :, :r] = (rng.standard_normal((batch, l, 2, r))
                              + 1j * rng.standard_normal((batch, l, 2, r))) / np.sqrt(2 * l)
    bd = np.broadcast_to(np.asarray(bonds[1:-1], np.int32), (batch, NQ - 1))
    return t.astype(dtype), np.ones(batch), bd


def _pair(t, site):
    return np.einsum("...asb,...btc->...astc", t[..., site, :, :, :], t[..., site + 1, :, :, :])


def _dense_gate(kind, theta):
    if kind == GATE_SWAP:
        return dense.SWAP
    if kind == GATE_XX:
        return dense.xxphase(theta)
    if kind == GATE_XXSW:
        return dense.xxphase(theta) @ dense.SWAP
    return dense.zzphase(theta)


def _ref_gate(kind, theta):
    th = jnp.asarray(theta, jnp.float32)
    if kind == GATE_SWAP:
        return jgates.swap(jnp.float32)
    if kind == GATE_XX:
        return jgates.xxphase(th, jnp.float32)
    if kind == GATE_XXSW:
        return jgates.xxphase_swap(th, jnp.float32)
    return jgates.zzphase(th, jnp.float32)


def _ref_state(t, b):
    return jmps.MPS(tensors=Cpx(jnp.asarray(t[b].real), jnp.asarray(t[b].imag)),
                    fidelity=jnp.ones((), jnp.float32),
                    bond_dims=jnp.asarray([2, 4, 8, 4, 2], jnp.int32))


KINDS = [GATE_SWAP, GATE_XX, GATE_XXSW, GATE_ZZ]


@pytest.mark.parametrize("direction", [0, 1])
def test_apply_2site_matches_reference_and_dense(direction):
    rng = np.random.default_rng(direction)
    t, fid, bd = _random_state(rng, 1, np.complex64)
    thetas = rng.uniform(0, np.pi, size=len(KINDS))
    rcfg = RefConfig(chi=CHI, svd_method="subspace")
    for kind, theta in zip(KINDS, thetas):
        state = mps.mps_from_reference(t.real, t.imag, fid.astype(np.float32), bd)
        out = apply_schedule_op(state, SITE, kind, direction,
                                torch.tensor([theta], dtype=torch.float32),
                                SimConfig(chi=CHI, svd_method="subspace"))
        ot, ofid, obd = mps.mps_to_numpy(out)
        ref = jmps.apply_2site(_ref_state(t, 0), SITE, _ref_gate(kind, theta), rcfg, direction)
        rt = jcpx.to_np(ref.tensors)
        np.testing.assert_allclose(_pair(ot[0], SITE), _pair(rt, SITE), atol=1e-5)
        assert obd[0, SITE] == int(ref.bond_dims[SITE]) == CHI
        assert abs(ofid[0] - float(ref.fidelity)) <= 1e-6
        want = dense.apply_gate(mps.to_dense(t[0].astype(np.complex128), NQ),
                                _dense_gate(kind, theta), [SITE, SITE + 1], NQ)
        np.testing.assert_allclose(mps.to_dense(ot[0], NQ), want, atol=1e-5)
        # untouched sites are untouched
        np.testing.assert_array_equal(ot[0, :SITE], t[0, :SITE])


@pytest.mark.parametrize("direction", [0, 1])
def test_move_center_matches_reference(direction):
    rng = np.random.default_rng(10 + direction)
    t, fid, bd = _random_state(rng, 2, np.complex64)
    out = mps.move_center(mps.mps_from_reference(t.real, t.imag, fid.astype(np.float32), bd),
                          SITE, direction, SimConfig(chi=CHI, svd_method="subspace"))
    ot = mps.mps_to_numpy(out)[0]
    rcfg = RefConfig(chi=CHI, svd_method="subspace")
    for b in range(2):
        rt = jcpx.to_np(jmps.move_center(_ref_state(t, b), SITE, direction, rcfg).tensors)
        np.testing.assert_allclose(_pair(ot[b], SITE), _pair(rt, SITE), atol=1e-5)
        np.testing.assert_allclose(_pair(ot[b], SITE), _pair(t[b], SITE), atol=1e-5)
        # the site the center left is an isometry on its live block
        if direction == 0:
            a = ot[b, SITE].reshape(2 * CHI, CHI)
            g = a.conj().T @ a
        else:
            a = ot[b, SITE + 1].reshape(CHI, 2 * CHI)
            g = a @ a.conj().T
        live = np.abs(np.diag(g)) > 0.5
        np.testing.assert_allclose(g[np.ix_(live, live)], np.eye(live.sum()), atol=1e-5)
        assert np.abs(g[~live]).max(initial=0.0) == 0.0


def test_f64_updates_match_dense_to_roundoff():
    rng = np.random.default_rng(3)
    t, fid, bd = _random_state(rng, 2, np.complex128)
    state = mps.mps_from_reference(t.real, t.imag, fid, bd)
    cfg = SimConfig(chi=CHI, precision="f64", svd_method="subspace")
    thetas = torch.tensor([0.3, 1.1], dtype=torch.float64)
    state = apply_schedule_op(state, SITE, GATE_XXSW, 1, thetas, cfg)
    state = mps.move_center(state, SITE - 1, 1, cfg)
    ot = mps.mps_to_numpy(state)[0]
    for b in range(2):
        want = dense.apply_gate(mps.to_dense(t[b], NQ),
                                _dense_gate(GATE_XXSW, float(thetas[b])), [SITE, SITE + 1], NQ)
        np.testing.assert_allclose(mps.to_dense(ot[b], NQ), want, atol=1e-10)
        vd = mps.vdot(state, state)[b].item()
        np.testing.assert_allclose(vd, np.vdot(want, want), atol=1e-10)
    assert (mps.max_bond(state).numpy() == CHI).all()


def test_gates_pinned_to_reference():
    th = np.linspace(-2.0, 3.0, 7)
    tt = torch.from_numpy(th)
    jt = jnp.asarray(th)
    pairs = [
        (gates.rx(tt), jgates.rx(jt, jnp.float64)),
        (gates.rz(tt), jgates.rz(jt, jnp.float64)),
        (gates.rz_phases(tt), jgates.rz_phases(jt, jnp.float64)),
        (gates.xxphase(tt), jgates.xxphase(jt, jnp.float64)),
        (gates.zzphase(tt), jgates.zzphase(jt, jnp.float64)),
        (gates.xxphase_swap(tt), jgates.xxphase_swap(jt, jnp.float64)),
        (gates.hadamard(torch.float64, torch.device("cpu")), jgates.hadamard(jnp.float64)),
        (gates.swap(torch.float64, torch.device("cpu")), jgates.swap(jnp.float64)),
    ]
    for port, ref in pairs:
        np.testing.assert_allclose(port.numpy(), jcpx.to_np(ref), atol=1e-15)
    np.testing.assert_allclose(gates.xxphase(tt).numpy()[0], dense.xxphase(th[0]), atol=1e-15)
