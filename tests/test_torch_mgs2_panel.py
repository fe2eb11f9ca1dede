"""The scanned MGS2 panel step of the blocked orthonormalizer (kernel K8's
plain version, ``ops/blocked_qr.mgs2_panel_plain``) on the CPU against
what the reference runs in its place: in complex64 its ``_mgs2_panel``
(``qml_cutensornet_tpu/ops/blocked_qr.py``, its ``lax.scan``), in
complex128 its f64 orthonormalizer (``cpx.qr_orth``: Householder QR with
no cutoff, because the reference's blocked route takes f32 only); the
routing of ``qr_orth_blocked`` to the plain version, to K8 and to the
reduced-class chain; K8's launch plan and the refusals of its wrapper; and
a Gram whose split iterates pass 128 columns in f64 against the
reference's. The CUDA kernel itself is held against the plain version on a
card in test_torch_cuda.py.

The scanned step zeroes a column whose residual squared norm is not above
``orth.dep_tol2`` times its squared norm before any projection: the
reference scan's ``_DEP_TOL**2`` = 1e-10 in complex64, 1e-24 in
complex128 as K2 and K3 cut. The inputs keep every column's ratio far from
those cutoffs (exact duplicates and zeros below both, 1e-15 between them,
1e-6 above both), so that both sides zero the same columns in complex64;
in complex128 the port keeps the 1e-15 column, as the reference's
Householder QR does, and a split above 128 columns keeps the reference's
rank.

Tolerances: projectors ``Q Q^H`` within 1e-12 in complex128 and 1e-5 in
complex64 (the same algorithm, sums in another order); in complex128,
where Householder QR has no cutoff, the columns before the first exact
duplicate agree one by one up to a phase, ``1 - |<q_j, q_ref_j>|`` within
1e-12; kept columns orthonormal to 1e-12 and 5e-6 (the reference's
orthonormality bar, tests/test_blocked_qr.py); the f64 Gram within
1e-10."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qml_cutensornet_tpu.config import SimConfig as RefConfig
from qml_cutensornet_tpu.models.ansatz import KernelStateAnsatz as RefAnsatz
from qml_cutensornet_tpu.models.gram import build_kernel_matrix as ref_build
from qml_cutensornet_tpu.ops import blocked_qr as jblocked
from qml_cutensornet_tpu.ops import cpx as jcpx
from qml_cutensornet_tpu.ops import svd as jsvd
from qml_cutensornet_tpu.ops.cpx import Cpx
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix
from qml_cutensornet_tpu_torch.ops import _build, blocked_qr, lowp, orth, svd

TOL_PROJ = {np.complex64: 1e-5, np.complex128: 1e-12}
TOL_ORTH = {np.complex64: 5e-6, np.complex128: 1e-12}
# Special columns of batch element 1: (column, what it is)
COLLAPSED, KEPT, DUPLICATE, ZERO = 5, 8, 10, 12


_ref_scan = jax.jit(jax.vmap(
    lambda re, im, n2: jblocked._mgs2_panel(Cpx(re, im), n2, jnp.float32)))
_ref_qr_f64 = jax.jit(jax.vmap(lambda re, im: jcpx.qr_orth(Cpx(re, im))))


def _reference(a):
    """What the reference runs on the panels ``a``: in f32 its scanned
    step, in f64 its Householder orthonormalizer."""
    if a.dtype == np.complex64:
        n2 = (np.abs(a) ** 2).sum(1)
        q = _ref_scan(jnp.asarray(a.real), jnp.asarray(a.imag), jnp.asarray(n2))
    else:
        q = _ref_qr_f64(jnp.asarray(a.real), jnp.asarray(a.imag))
    return np.asarray(q.re) + 1j * np.asarray(q.im)


def _port(a):
    at = torch.from_numpy(a)
    return blocked_qr.mgs2_panel(at, blocked_qr.orth.abs2(at).sum(1)).numpy()


def _crandn(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _panels(seed, m, p, dtype, B=3):
    """Random panels; in element 1 a column at residual ratio^2 about 1e-15
    (column 2 plus a 3e-8 perturbation), one at about 1e-6 (column 1 plus
    1e-3), an exact duplicate of column 4 and an exact-zero column."""
    rng = np.random.default_rng(seed)
    a = _crandn(rng, B, m, p)
    a[1, :, COLLAPSED] = a[1, :, 2] + 3e-8 * _crandn(rng, m)
    a[1, :, KEPT] = a[1, :, 1] + 1e-3 * _crandn(rng, m)
    a[1, :, DUPLICATE] = a[1, :, 4]
    a[1, :, ZERO] = 0.0
    return (a / np.abs(a).max()).astype(dtype)


def _zero_columns(q):
    return np.all(q == 0, axis=1)  # [B, P]


def _check_against_reference(q, qr, dtype):
    """complex64: the same exact-zero columns and projectors as the
    reference's scan. complex128: the random elements 0 and 2 span what the
    reference's Householder basis spans; element 1's columns before its
    exact duplicate match the reference's one by one up to a phase (after
    it Householder, with no cutoff, fills the duplicate's and the zero
    column's places with other directions). Kept columns orthonormal."""
    proj = lambda x: x @ np.conj(np.swapaxes(x, -1, -2))
    if dtype == np.complex64:
        np.testing.assert_array_equal(_zero_columns(q), _zero_columns(qr))
        assert np.abs(proj(q) - proj(qr)).max() <= TOL_PROJ[dtype]
    else:
        assert np.abs(proj(q[[0, 2]]) - proj(qr[[0, 2]])).max() <= TOL_PROJ[dtype]
        overlap = np.abs((np.conj(q[1]) * qr[1]).sum(0))[:DUPLICATE]
        assert np.abs(1.0 - overlap).max() <= TOL_PROJ[dtype]
    for qb in q:
        kept = qb[:, ~np.all(qb == 0, axis=0)]
        g = kept.conj().T @ kept
        assert np.abs(g - np.eye(g.shape[0])).max() <= TOL_ORTH[dtype]


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_collapsed_column_zeroed_as_in_reference(dtype):
    """The column at residual ratio^2 about 1e-15 is zeroed as the
    reference zeroes it: in complex64 by the reference's scan and the
    port's step at 1e-10 alike; in complex128 by neither, because the
    reference runs no scan in f64 (its Householder QR has no cutoff) and
    the port's step cuts at 1e-24, so both keep it at unit norm. The exact
    duplicate and the zero column come out zero from the port's step, and
    the column at about 1e-6 is kept by both."""
    a = _panels(1, 64, 32, dtype)
    q, qr = _port(a), _reference(a)
    collapsed = dtype == np.complex64
    for x in (q, qr):
        assert np.all(x[1, :, COLLAPSED] == 0) == collapsed
        assert abs(np.linalg.norm(x[1, :, KEPT]) - 1.0) <= 1e-6
    if not collapsed:
        assert abs(np.linalg.norm(q[1, :, COLLAPSED]) - 1.0) <= 1e-12
    assert np.all(q[1, :, DUPLICATE] == 0) and np.all(q[1, :, ZERO] == 0)
    _check_against_reference(q, qr, dtype)


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
@pytest.mark.parametrize("m,p", [(64, 32), (64, 16), (256, 32), (256, 16)])
def test_plain_matches_reference(m, p, dtype):
    """Random panels of 32 and of a last panel's 16 columns at m 64 and
    256 against the reference (``_check_against_reference``); the port's
    exact-zero columns are the duplicate, the zero column and, in
    complex64, the 1e-15 column."""
    a = _panels(m + p, m, p, dtype)
    q = blocked_qr.mgs2_panel_plain(torch.from_numpy(a), torch.from_numpy(
        (np.abs(a) ** 2).sum(1).astype(a.real.dtype))).numpy()
    _check_against_reference(q, _reference(a), dtype)
    zeros = 3 if dtype == np.complex64 else 2
    assert _zero_columns(q)[1].sum() == zeros and not _zero_columns(q)[[0, 2]].any()


def _counting(monkeypatch, name):
    calls = []
    fn = getattr(blocked_qr, name)

    def counted(*args, **kw):
        calls.append(tuple(args[0].shape))
        return fn(*args, **kw)

    monkeypatch.setattr(blocked_qr, name, counted)
    return calls


@pytest.mark.parametrize("dtype,kernel_panels,scanned", [
    (torch.complex128, False, True), (torch.complex128, True, True),
    (torch.complex64, False, True), (torch.complex64, True, False)])
def test_cpu_tensor_reaches_plain_version(monkeypatch, dtype, kernel_panels, scanned):
    """``qr_orth_blocked`` on a CPU tensor at a full class: the scanned step
    (``kernel_panels`` off, or complex128) runs K8's plain version once a
    panel, 144 columns in 4 panels of 32 and one of 16; K3's panels run no
    scanned step. No kernel launches."""
    plain = _counting(monkeypatch, "mgs2_panel_plain")
    lowp_chain = _counting(monkeypatch, "mgs2_panel_lowp")
    before = dict(_build.LAUNCHES)
    v = torch.from_numpy(_crandn(np.random.default_rng(5), 2, 160, 144)).to(dtype)
    q = blocked_qr.qr_orth_blocked(v, kernel_panels)
    assert plain == ([(2, 160, 32)] * 4 + [(2, 160, 16)] if scanned else [])
    assert lowp_chain == [] and _build.LAUNCHES == before
    g = q.mH @ q
    assert (g - torch.eye(144, dtype=dtype)).abs().max().item() <= 1e-4


@pytest.mark.parametrize("precision", ["high", "bfloat16"])
def test_reduced_class_keeps_the_k7_chain(monkeypatch, precision):
    """At a reduced ambient class in complex64 the scanned step is the chain
    of single-column products through ``lowp.matmul`` (4 a column after a
    panel's first, beside the 4 inter-panel products), not K8's plain
    version; in complex128 every class is full and the plain version runs."""
    plain = _counting(monkeypatch, "mgs2_panel_plain")
    products = []
    matmul = lowp.matmul

    def counted(*args, **kw):
        products.append(args[2] if len(args) > 2 else kw.get("precision"))
        return matmul(*args, **kw)

    monkeypatch.setattr(lowp, "matmul", counted)
    v = _crandn(np.random.default_rng(11), 2, 96, 64)
    blocked_qr.qr_orth_blocked(torch.from_numpy(v.astype(np.complex64)), False,
                               precision=precision)
    assert plain == [] and len(products) == 4 + 2 * 4 * (blocked_qr.PANEL - 1)
    products.clear()
    blocked_qr.qr_orth_blocked(torch.from_numpy(v), False, precision=precision)
    assert plain == [(2, 96, 32)] * 2 and len(products) == 4


def _refusal_cases():
    a = torch.zeros((2, 64, 32), dtype=torch.complex64)
    n2 = torch.zeros((2, 32), dtype=torch.float32)
    return {
        "cpu": (a, n2, "CUDA tensor"),
        "non_contiguous": (torch.zeros((2, 64, 64), dtype=torch.complex64)[:, :, :32], n2,
                           "contiguous"),
        "wrong_dtype": (a.real.contiguous(), n2, "complex64 or complex128"),
        "wide": (torch.zeros((2, 64, 48), dtype=torch.complex64),
                 torch.zeros((2, 48), dtype=torch.float32), "P <= 32"),
        "norms_dtype": (a, n2.double(), "n2_orig"),
    }


@pytest.mark.parametrize("case", list(_refusal_cases()))
def test_kernel_wrapper_refuses(case):
    """K8's wrapper refuses a CPU tensor, a non-contiguous panel, a dtype
    other than complex64 / complex128, more than 32 columns and norms of
    another dtype, before it builds or launches anything."""
    a, n2, match = _refusal_cases()[case]
    before = dict(_build.LAUNCHES)
    with pytest.raises((ValueError, TypeError), match=match):
        blocked_qr.mgs2_panel_cuda(a, n2)
    assert _build.LAUNCHES == before and _build.PLAIN_ON_CUDA["mgs2_panel"] == 0


C64, C128 = torch.complex64, torch.complex128


# Every (m, P, dtype) of chip_smoke.K8_SHAPES, and past m 2048 the whole
# panel in global scratch: (m, P, dtype, plan kind, elements a lane).
@pytest.mark.parametrize("m,p,dtype,kind,epl", [
    (256, 32, C64, "registers", 1), (256, 16, C64, "registers", 1),
    (512, 32, C64, "registers", 2), (512, 16, C64, "registers", 2),
    (1024, 32, C64, "split_smem", 4), (1024, 16, C64, "registers", 4),
    (2048, 32, C64, "split_global", 8), (2048, 16, C64, "split_smem", 8),
    (256, 32, C128, "registers", 1), (256, 16, C128, "registers", 1),
    (512, 32, C128, "split_smem", 2), (512, 16, C128, "registers", 2),
    (1024, 32, C128, "split_global", 4), (1024, 16, C128, "split_smem", 4),
    (2048, 32, C128, "split_global", 8), (2048, 16, C128, "split_global", 8),
    (2560, 32, C64, "memory", 0), (2560, 16, C128, "memory", 0)])
def test_launch_plan(m, p, dtype, kind, epl):
    """K8's plan on an H100 (232448 bytes a block may opt in to): 256
    threads at the fewest elements a lane (1, 2, 4, 8) that cover m, the
    columns that fit 128 registers a thread held in registers (staged
    through shared memory, a column 256 x epl + 1 long), the rest in
    shared memory where they fit beside the static slots, else in global
    scratch; past m 2048 the whole panel in global scratch. The dynamic and
    static shared memory fit the block's opt-in."""
    plan = blocked_qr.mgs2_plan(m, p, dtype, 232448)
    assert (plan.kind, plan.epl) == (kind, epl)
    assert plan.smem_bytes + blocked_qr.mgs2_static_bytes(dtype) <= 232448
    cx, threads = (16 if dtype == C128 else 8), blocked_qr.MGS2_THREADS
    if kind == "memory":
        assert m > 8 * threads
        assert (plan.reg_cols, plan.smem_bytes, plan.scratch_cx) == (0, 0, p * m)
        return
    assert (epl // 2) * threads < m <= epl * threads  # the group covers m, at the fewest
    r = plan.reg_cols
    assert r == min(32, 128 // (epl * cx // 4))  # the columns' registers a thread
    column = (threads * epl + 1) * cx
    if kind == "registers":
        assert p <= r and plan.smem_bytes == p * column and plan.scratch_cx == 0
    elif kind == "split_smem":
        assert p > r and plan.smem_bytes == (p - r) * column and plan.scratch_cx == 0
    else:
        assert p > r and plan.smem_bytes == 0 and plan.scratch_cx == (p - r) * threads * epl
        assert (p - r) * column + blocked_qr.mgs2_static_bytes(dtype) > 232448


def test_f64_gram_above_128_columns_matches_reference(monkeypatch):
    """6 qubits, r 1, d 2, 3 points at cap 128 with staging off: the split
    iterates are 144 columns wide (oversampling 16), so every split runs the
    blocked route and, in f64, the scanned step on 4 panels of 32 and one of
    16. The port's Gram against the reference's f64 Gram (chunks of 8 ops,
    one subspace iteration, to keep the run short)."""
    monkeypatch.setenv("QMLTPU_STAGED", "0")
    monkeypatch.setenv("QMLTPU_CHUNK_LEN", "8")
    plain = _counting(monkeypatch, "mgs2_panel_plain")
    nq = 6
    X = np.random.default_rng(0).uniform(0.0, 2.0, size=(3, nq))
    em = entanglement_graph(nq, 2)
    rcfg = RefConfig(chi=128, precision="f64", svd_method="subspace", subspace_iters=1,
                     oversample=16)
    K = build_kernel_matrix(KernelStateAnsatz(nq, 1, 1.0, em), X,
                            cfg=SimConfig.from_reference(dataclasses.asdict(rcfg)),
                            sim_batch=4, tile=4, device="cpu")
    K_ref = ref_build(RefAnsatz(nq, 1, 1.0, em), X, cfg=rcfg, sim_batch=4, tile=4)
    assert len(plain) > 0 and len(plain) % 5 == 0
    assert set(plain) == {(4, 256, 32), (4, 256, 16)}
    np.testing.assert_allclose(K, K_ref, atol=1e-10)


def test_f64_split_above_128_columns_keeps_the_reference_rank(monkeypatch):
    """In f64 the reference orthonormalizes every width by Householder QR
    with no cutoff (``cpx.qr_orth``: its blocked route takes f32 only), so
    its split keeps directions at a singular-value ratio of 1e-7, above
    f64's mask floor of 1e-10, which a cutoff of 1e-10 on the power
    iterates' residual ratios^2 would zero. theta [2, 256, 256] with 100
    singular values from 1 to 1e-3 and 20 at 1e-7, split at cap 128 with 16
    oversampled columns (144: the blocked route, the scanned step on each
    panel at its cutoff of 1e-24): the port keeps the reference's rank 120
    and its kept fraction; with the f32 scan's 1e-10 there
    (``orth.dep_tol2`` set to it in complex128) it would keep 100."""
    rng = np.random.default_rng(3)
    u, _ = np.linalg.qr(_crandn(rng, 2, 256, 256))
    w, _ = np.linalg.qr(_crandn(rng, 2, 256, 256))
    sv = np.concatenate([np.geomspace(1.0, 1e-3, 100), np.full(20, 1e-7), np.zeros(136)])
    theta = (u * sv) @ w.conj().transpose(0, 2, 1)
    rcfg = RefConfig(chi=128, precision="f64", svd_method="subspace", subspace_iters=2,
                     oversample=16)
    cfg = SimConfig.from_reference(dataclasses.asdict(rcfg))
    ref = jax.vmap(lambda re, im: jsvd.truncated_svd(Cpx(re, im), rcfg, 128))(
        jnp.asarray(theta.real), jnp.asarray(theta.imag))
    plain = _counting(monkeypatch, "mgs2_panel_plain")
    _, _, kf, rank = svd.truncated_svd(torch.from_numpy(theta), cfg, 128)
    assert len(plain) == 2 * 2 * 5  # 2 iterations x 2 orthonormalizations x 5 panels
    np.testing.assert_array_equal(rank.numpy(), np.asarray(ref[3]))
    assert rank.tolist() == [120, 120]
    np.testing.assert_allclose(kf.numpy(), np.asarray(ref[2]), atol=1e-12)
    monkeypatch.setattr(orth, "dep_tol2", lambda dtype: orth.DEP_TOL2)
    assert svd.truncated_svd(torch.from_numpy(theta), cfg, 128)[3].tolist() == [100, 100]
