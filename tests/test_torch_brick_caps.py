"""The brick engine's structural bond caps (``SimConfig.brick_struct_caps``,
``QMLTPU_BRICK_CAPS``) in the PyTorch port, the counterparts of the
reference's tests/test_brick.py caps tests: caps exact in f64 against the
port's dense statevector model, caps against no caps in f32, the port
against the reference with caps on the same points, ``_brick_pairs`` with
caps on a state carried over from the reference's, and the bucket routing
(which ``(cl, cm, cr)`` go to kernel K5 and which to the split, K1).

Sizes: 8 to 12 qubits, a few points. Tolerances: 1e-9 in f64 (the
reference's bar against the dense model); 3e-6 capped against uncapped in
f32 at a cap that truncates nothing (the reference's bar: the same
arithmetic at sliced shapes); 3e-5 port against reference (the reference's
fused-vs-unfused Gram bar); pair updates 3e-5 as in test_torch_vidal.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qml_cutensornet_tpu.config import SimConfig as RefConfig
from qml_cutensornet_tpu.models.ansatz import KernelStateAnsatz as RefAnsatz
from qml_cutensornet_tpu.models.gram import build_kernel_matrix as ref_build
from qml_cutensornet_tpu.ops import cpx as jcpx
from qml_cutensornet_tpu.ops import svd as jsvd
from qml_cutensornet_tpu.ops import vidal as jvidal
from qml_cutensornet_tpu.ops.cpx import Cpx
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix
from qml_cutensornet_tpu_torch.ops import _build, dense, split, svd, vidal
from qml_cutensornet_tpu_torch.ops.mps import to_dense

TOL_PAIR = 3e-5


def _gram(n, reps, d, X, **cfg):
    ansatz = KernelStateAnsatz(n, reps, 1.0, entanglement_graph(n, d), routing="brick")
    _build.reset_counters()
    K = build_kernel_matrix(ansatz, X, cfg=SimConfig(**cfg), sim_batch=len(X), tile=len(X),
                            device="cpu")
    assert sum(_build.LAUNCHES.values()) == 0  # CPU tensors: plain versions only
    return K


@pytest.mark.parametrize("n,reps,d", [(8, 2, 3), (10, 2, 4)])
def test_caps_exact_f64(n, reps, d):
    """Caps are exact: entries past a bond's Schmidt-rank bound are exact
    zeros, so the sliced updates give the dense model's Gram."""
    X = np.random.default_rng(7).uniform(0, 2, size=(4, n))
    K = _gram(n, reps, d, X, chi=2 ** (n // 2), precision="f64", svd_method="subspace",
              subspace_iters=2, brick_struct_caps=True)
    em = entanglement_graph(n, d)
    K_dense = np.array([[dense.kernel_entry(a, b, reps, 1.0, em) for b in X] for a in X])
    np.testing.assert_allclose(K, K_dense, atol=1e-9)


def test_caps_f32_match_uncapped():
    """f32 at a cap that truncates nothing: capped and uncapped Grams agree
    to f32 rounding."""
    n, reps, d = 12, 2, 4
    X = np.random.default_rng(3).uniform(0, 2, size=(6, n))
    base = dict(chi=64, precision="f32", svd_method="subspace", subspace_iters=1)
    K_off = _gram(n, reps, d, X, **base)
    K_on = _gram(n, reps, d, X, brick_struct_caps=True, **base)
    assert np.abs(K_on - K_off).max() < 3e-6


def test_caps_match_reference():
    """The port against the reference with caps on the same points, every
    pair update through the split (K1's plain version; the reference's XLA
    route). K5 under caps: test_brick_pairs_with_caps_match_reference."""
    n, reps, d = 10, 1, 2
    X = np.random.default_rng(11).uniform(0, 2, size=(4, n))
    rcfg = RefConfig(chi=16, precision="f32", svd_method="subspace", subspace_iters=2,
                     fused_split=True, brick_struct_caps=True)
    em = entanglement_graph(n, d)
    K_ref = ref_build(RefAnsatz(n, reps, 1.0, em, routing="brick"), X, cfg=rcfg, sim_batch=4,
                      tile=4)
    K = _gram(n, reps, d, X, **{k: v for k, v in dataclasses.asdict(rcfg).items()
                                if k != "fused_interpret"})
    np.testing.assert_allclose(K, np.asarray(K_ref), atol=3e-5)


def _capped_state(rng, B, n, n_p, chi):
    """A random state over ``n_p`` padded sites (``n`` real) that keeps the
    structural bound: every bond's entries and weights past its Schmidt-rank
    bound ``min(2^l, 2^(n-l))`` are exact zeros."""
    def bound(j):
        l = min(max(j, 0), n)
        return min(chi, 2 ** min(l, n - l))

    t = (rng.standard_normal((B, n_p, chi, 2, chi))
         + 1j * rng.standard_normal((B, n_p, chi, 2, chi))) / 3
    lams = rng.uniform(0.1, 1.0, size=(B, n_p - 1, chi))
    for i in range(n_p):
        t[:, i, bound(i - 1):] = 0.0  # left bond i - 1 (site 0: the dummy's dim-1 bond)
        t[:, i, :, :, bound(i):] = 0.0
        if not 1 <= i <= n:  # a dummy site is |0>
            t[:, i, :, 1] = 0.0
    for j in range(n_p - 1):
        lams[:, j, bound(j):] = 0.0
    bond_dims = np.array([[bound(j) for j in range(n_p - 1)]] * B, np.int32)
    return t.astype(np.complex64), lams.astype(np.float32), bond_dims


@pytest.mark.parametrize("fused_gate", [False, True])
def test_brick_pairs_with_caps_match_reference(fused_gate):
    """``_brick_pairs`` with caps, bucket by bucket over one layer of each
    parity (every third pair and the pairs on a dummy site inactive, as in
    a schedule), on a state carried over by
    ``vidal_state_from_reference``: the same state vector, Schmidt weights,
    bond dimensions and fidelity as the reference's; inactive pairs and the
    entries past the caps untouched."""
    n, chi, B = 9, 16, 2
    sched = KernelStateAnsatz(n, 1, 1.0, entanglement_graph(n, 1), routing="brick").schedule
    n_p, K = sched.num_sites_padded, sched.pairs_per_layer
    rng = np.random.default_rng(17 + fused_gate)
    t, lams, bd = _capped_state(rng, B, n, n_p, chi)
    fid = np.ones(B, np.float32)
    rcfg = RefConfig(chi=chi, precision="f32", svd_method="subspace", subspace_iters=2,
                     fused_split=True, fused_gate=fused_gate, fused_interpret=fused_gate,
                     brick_struct_caps=True)
    cfg = SimConfig.from_reference(dataclasses.asdict(rcfg))
    jst = jvidal.VidalState(tensors=Cpx(jnp.asarray(t.real), jnp.asarray(t.imag)),
                            lams=jnp.asarray(lams), fidelity=jnp.asarray(fid),
                            bond_dims=jnp.asarray(bd))
    pst = vidal.vidal_state_from_reference(t.real, t.imag, lams, fid, bd)
    buckets = vidal.cap_buckets(n, K, chi)
    assert len(buckets) > 1
    for parity, swap_w in ((0, 1.0), (1, 0.0)):
        left = parity + 2 * np.arange(K)
        active = (np.arange(K) % 3 != 2) & (left >= 1) & (left + 1 <= n)
        thetas = rng.uniform(-1.0, 1.0, size=(B, K)).astype(np.float32)
        before = vidal.vidal_state_to_numpy(pst)
        for k0, k1, caps in buckets:
            sl = slice(k0, k1)
            jst = jvidal._brick_pairs(jst, jnp.int32(parity), k0, jnp.float32(swap_w),
                                      jnp.asarray(active[sl]), jnp.asarray(thetas[:, sl]), rcfg,
                                      caps=caps)
            pst = vidal._brick_pairs(pst, parity, k0, swap_w, torch.from_numpy(active[sl]),
                                     torch.from_numpy(thetas[:, sl]), cfg, caps)
        after = vidal.vidal_state_to_numpy(pst)
        for k in np.nonzero(~active)[0]:  # inactive pair: exact no-op
            i = parity + 2 * k
            np.testing.assert_array_equal(after[0][:, i:i + 2], before[0][:, i:i + 2])
            np.testing.assert_array_equal(after[1][:, i], before[1][:, i])
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
    _, lams0, _ = _capped_state(np.random.default_rng(0), 1, n, n_p, chi)
    assert np.count_nonzero(plams[:, lams0[0] == 0]) == 0  # nothing written past a cap


def test_bucket_routing():
    """The buckets of a layer and where each goes. At nf 100, chi 128 (51
    pairs): 43 pairs at (128, 128, 128) and 8 single pairs, as the
    reference's loop splits them; with the fused gate (oversampling 0) the
    square cap bucket takes K5 and every other bucket the split, in both
    packages. Then one capped layer on the CPU at 12 qubits, chi 16: the
    pair updates reach K5's plain version only at (16, 16, 16) and K1's at
    m = 2 cr, k = 2 cl, nc = cm."""
    n, K, chi = 100, 51, 128
    buckets = vidal.cap_buckets(n, K, chi)
    caps = jvidal.structural_caps(n, K, chi)
    assert vidal.structural_caps(n, K, chi) == caps
    ref_bounds, k0 = [], 0
    while k0 < K:  # the reference's bucket loop (ops/vidal.brick_layer)
        k1 = k0 + 1
        while k1 < K and caps[k1] == caps[k0]:
            k1 += 1
        ref_bounds.append((k0, k1, caps[k0]))
        k0 = k1
    assert buckets == ref_bounds
    assert sorted(k1 - k0 for k0, k1, _ in buckets) == [1] * 8 + [43]
    assert {c for _, _, c in buckets} == {
        (128, 128, 128), (4, 4, 4), (4, 8, 16), (16, 32, 64), (64, 128, 128), (128, 64, 32),
        (32, 16, 8), (8, 4, 4)}
    kw = dict(chi=chi, svd_method="subspace", fused_split=True, fused_gate=True, oversample=0)
    cfg, rcfg = SimConfig(**kw), RefConfig(fused_interpret=True, **kw)
    for _, _, c in buckets:
        assert svd.brick_split_eligible(cfg, *c) == jsvd.brick_split_eligible(rcfg, *c) == (
            c == (chi,) * 3), c

    n, chi, B = 12, 16, 2
    sched = KernelStateAnsatz(n, 1, 1.0, entanglement_graph(n, 1), routing="brick").schedule
    n_p, K = sched.num_sites_padded, sched.pairs_per_layer
    t, lams, bd = _capped_state(np.random.default_rng(5), B, n, n_p, chi)
    state = vidal.vidal_state_from_reference(t.real, t.imag, lams, np.ones(B, np.float32), bd)
    calls = []
    real_k5, real_k1 = split.brick_gate_split, split.subspace_factor

    def k5(A, Bm, g, lam, v0, iters, pair=False):
        calls.append(("K5", A.shape[2]))
        return real_k5(A, Bm, g, lam, v0, iters, pair)

    def k1(theta, v0, iters, pair=False):
        calls.append(("K1", tuple(theta.shape[1:]), v0.shape[1]))
        return real_k1(theta, v0, iters, pair)

    cfg = SimConfig(chi=chi, svd_method="subspace", fused_split=True, fused_gate=True,
                    brick_struct_caps=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(split, "brick_gate_split", k5)
        mp.setattr(split, "subspace_factor", k1)
        vidal.brick_layer(state, 0, 1.0, torch.ones(K, dtype=torch.bool),
                          torch.full((B, K), 0.3), cfg, n=n)
    want = []
    for k0, k1_, (cl, cm, cr) in vidal.cap_buckets(n, K, chi):
        for _ in range(-(-(k1_ - k0) // vidal._pair_chunk(k1_ - k0, max(cl, cm, cr), B))):
            want.append(("K5", chi) if (cl, cm, cr) == (chi,) * 3
                        else ("K1", (2 * cr, 2 * cl), cm))
    assert calls == want and ("K5", chi) in calls and any(c[0] == "K1" for c in calls)
