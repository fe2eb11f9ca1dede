"""CUDA kernels of the PyTorch port on a card: each of the five kernels
against its plain PyTorch version at the main paths' shapes (the basis-only
kernel also at the blocked route's panel shapes), the double instantiations
and the global-scratch layouts, the launch-error path, the pair variants
(``mgs_pair``) of all five and K1 at the brick caps' shapes, kernel K8 (the
scanned panel step of the blocked orthonormalizer) and its routing, and the
Gram slice on the card against the same slice on the CPU on the fused,
fused-gate, unfused, blocked and brick routes (the brick route also with
caps and the pair step), and the multi-device ring at world size 1 over
NCCL against the single-device Gram; kernel K7 (the bf16 tensor-core
complex product of the reduced precisions) against its plain version and
the exact product, its refusals, and the reduced power and tile
precisions' slice on the card against the CPU; K7 through ``lowp.matmul``
at the engine's shapes of the reduced ambient class (``matmul_precision``)
and the ambient slice on the tracked and brick engines against the CPU.

Every test here is marked ``cuda`` and skips where there is no card. This
file imports neither JAX nor the reference package, so it also runs on a
machine that has only PyTorch (``README.md``, "PyTorch / H100 port"):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

Tolerances (f32): kernel and plain version run the same algorithm with
different summation orders; 2e-5 is the reference's own fused-vs-unfused
bar on q/r (tests/test_pallas_split.py) and Gram (3e-5). In f64, 1e-12."""

import dataclasses

import numpy as np
import pytest
import torch

from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix
from qml_cutensornet_tpu_torch.ops import _build, blocked_qr, lowp, orth, split
from qml_cutensornet_tpu_torch.ops.svd import start_block
from qml_cutensornet_tpu_torch.ops.vidal import update_pairs

pytestmark = pytest.mark.cuda
TOL = 2e-5


@pytest.fixture
def dev():
    """The card; decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _input(rng, kind, b, m, k, dtype=np.complex64):
    x = rng.standard_normal((b, m, k)) + 1j * rng.standard_normal((b, m, k))
    if kind == "rank_deficient":
        r = max(1, min(m, k) // 2)
        x = x[:, :, :r] @ (rng.standard_normal((r, k)) + 1j * rng.standard_normal((r, k)))
    elif kind == "zero_padded":
        x[:, m // 2:, :] = 0.0
        x[:, :, k // 2:] = 0.0
    return (x / np.abs(x).max()).astype(dtype)


def _close(qk, rk, qp, rp, tol):
    assert (qk @ qk.mH - qp @ qp.mH).abs().max().item() <= tol
    assert (qk @ rk - qp @ rp).abs().max().item() <= tol
    zero_k = qk.abs().sum(1) == 0
    assert torch.equal(zero_k, qp.abs().pow(2).sum(1) < 0.25)


@pytest.mark.parametrize("chi", [8, 16, 32, 64])
@pytest.mark.parametrize("kind", ["full", "rank_deficient", "zero_padded"])
def test_orth_r_kernel_matches_plain(dev, chi, kind):
    rng = np.random.default_rng(chi)
    v = torch.from_numpy(_input(rng, kind, 32, 2 * chi, chi)).to(dev)
    before = _build.LAUNCHES["orth_r"]
    qk, rk = orth.qr(v, fused=True)
    assert _build.LAUNCHES["orth_r"] == before + 1
    qp, rp = orth.orth_r_plain(v)
    torch.cuda.synchronize()
    _close(qk, rk, qp, rp, TOL)


@pytest.mark.parametrize("chi", [8, 16, 32, 64])
@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("kind", ["full", "rank_deficient", "zero_padded"])
def test_split_kernel_matches_plain(dev, chi, iters, kind):
    rng = np.random.default_rng(chi + iters)
    th = torch.from_numpy(_input(rng, kind, 32, 2 * chi, 2 * chi)).to(dev)
    v0 = start_block(2 * chi, chi, th.dtype, dev)
    before = _build.LAUNCHES["split"]
    qk, rk = split.subspace_factor(th, v0, iters)
    assert _build.LAUNCHES["split"] == before + 1
    qp, rp = split.subspace_factor_plain(th, v0, iters)
    torch.cuda.synchronize()
    _close(qk, rk, qp, rp, TOL)


@pytest.mark.parametrize("m,k", [(16, 8), (64, 32), (128, 64), (160, 80), (256, 128),
                                 (128, 32), (512, 32), (2048, 32)])
@pytest.mark.parametrize("kind", ["full", "rank_deficient", "zero_padded"])
def test_orth_kernel_matches_plain(dev, m, k, kind):
    """K3 at the center-move and split shapes and at the panel shapes of the
    blocked route (k 32; m 512 takes the whole block as the in-panel group,
    m 2048 the rows in global scratch and the panel step in memory)."""
    rng = np.random.default_rng(m + k)
    v = torch.from_numpy(_input(rng, kind, 8, m, k)).to(dev)
    before = _build.LAUNCHES["orth"]
    qk = orth.orth(v)
    assert _build.LAUNCHES["orth"] == before + 1
    qp = orth.orth_plain(v)
    torch.cuda.synchronize()
    assert (qk @ qk.mH - qp @ qp.mH).abs().max().item() <= TOL
    assert torch.equal(qk.abs().sum(1) == 0, qp.abs().pow(2).sum(1) < 0.25)
    live = (qk.abs().sum(1) > 0).to(qk.real.dtype)
    gram = qk.mH @ qk - torch.diag_embed(live).to(qk.dtype)
    assert gram.abs().max().item() <= 5e-6


def _gate_inputs(rng, kind, b, chi, dtype=np.complex64):
    """Site-tensor stacks A [b, 2chi, chi], Bm [b, chi, 2chi] and unitary
    gates g [b, 4, 4]."""
    A = _input(rng, kind, b, 2 * chi, chi, dtype)
    Bm = _input(rng, kind, b, chi, 2 * chi, dtype)
    g, _ = np.linalg.qr(rng.standard_normal((b, 4, 4)) + 1j * rng.standard_normal((b, 4, 4)))
    return A, Bm, g.astype(dtype)


def _close_gate(dev, A, Bm, g, nc, iters, tol):
    A, Bm, g = (torch.from_numpy(x).to(dev) for x in (A, Bm, g))
    v0 = start_block(A.shape[1], nc, A.dtype, dev)
    before = _build.LAUNCHES["gate_split"]
    qk, rk, totk, resk = split.gate_subspace_factor(A, Bm, g, v0, iters)
    assert _build.LAUNCHES["gate_split"] == before + 1
    qp, rp, totp, resp = split.gate_subspace_factor_plain(A, Bm, g, v0, iters)
    torch.cuda.synchronize()
    _close(qk, rk, qp, rp, tol)
    rel = 1e-5 if tol > 1e-9 else 1e-12
    assert ((totk - totp).abs() / totp).max().item() <= rel
    theta = split.gate_theta(A, Bm, g)
    assert ((totk - theta.abs().pow(2).sum((1, 2))).abs() / totp).max().item() <= 1e-5
    # The weight the directions miss: against the plain version's, and
    # against ||theta - q r||^2 of the kernel's own factors.
    assert (resk - resp).abs().max().item() <= tol * totp.max().item()
    assert ((resk - split.residual_norm2(theta, qk, rk)).abs() / totp).max().item() <= rel


@pytest.mark.parametrize("chi", [8, 16, 32, 64])
@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("kind", ["full", "rank_deficient", "zero_padded"])
def test_gate_split_kernel_matches_plain(dev, chi, iters, kind):
    """K4: theta built in shared memory (chi 8 to 64 in complex64)."""
    rng = np.random.default_rng(100 + chi + iters)
    _close_gate(dev, *_gate_inputs(rng, kind, 32, chi), chi, iters, TOL)


def test_gate_split_oversampled_double_and_scratch(dev):
    """nc = chi + 16; complex128; chi 128 (rows and theta in global scratch)."""
    rng = np.random.default_rng(7)
    _close_gate(dev, *_gate_inputs(rng, "full", 4, 32), 48, 2, TOL)
    _close_gate(dev, *_gate_inputs(rng, "rank_deficient", 4, 16, np.complex128), 16, 2, 1e-12)
    _close_gate(dev, *_gate_inputs(rng, "full", 4, 64, np.complex128), 64, 1, 1e-12)
    _close_gate(dev, *_gate_inputs(rng, "rank_deficient", 2, 128), 128, 1, TOL)
    with pytest.raises(ValueError):
        _close_gate(dev, *_gate_inputs(rng, "full", 2, 128), 144, 1, TOL)


def test_orth_double_and_blocked_route(dev):
    """K3 in complex128 (panel shape: the rows in global scratch) and the
    blocked route above 128 columns on the card against the CPU."""
    rng = np.random.default_rng(11)
    v = torch.from_numpy(_input(rng, "full", 4, 512, 32, np.complex128)).to(dev)
    qk, qp = orth.orth_cuda(v), orth.orth_plain(v)
    assert (qk @ qk.mH - qp @ qp.mH).abs().max().item() <= 1e-12
    wide = torch.from_numpy(_input(rng, "zero_padded", 4, 288, 144))
    before = _build.LAUNCHES["orth"]
    q_gpu = blocked_qr.qr_orth_blocked(wide.to(dev), True)
    assert _build.LAUNCHES["orth"] == before + 5  # 144 columns: 5 panels of 32
    q_cpu = blocked_qr.qr_orth_blocked(wide, True)
    assert (q_gpu.cpu() @ q_gpu.cpu().mH - q_cpu @ q_cpu.mH).abs().max().item() <= TOL
    k8_before = _build.LAUNCHES["mgs2_panel"]
    q_scan = blocked_qr.qr_orth_blocked(wide.to(dev), False)  # the scanned panels: K8, no K3
    assert _build.LAUNCHES["orth"] == before + 5
    assert _build.LAUNCHES["mgs2_panel"] == k8_before + 5
    assert (q_scan.cpu() @ q_scan.cpu().mH - q_cpu @ q_cpu.mH).abs().max().item() <= TOL
    q, r = orth.qr(wide.to(dev), fused=True)  # above 128 columns: blocked, then q^H v
    assert (q @ r - wide.to(dev)).abs().max().item() <= TOL
    with pytest.raises(ValueError):
        orth.orth_cuda(wide.to(dev))


def _mgs2_input(rng, B, m, p, dtype, kind, collapsed=True):
    """A panel for K8 and its columns' squared norms: "full", random;
    "degenerate", its second half exact duplicates of its first, with an
    exact-zero column, an exact duplicate, one column at residual ratio^2
    about 1e-6 (kept) and, with ``collapsed``, one at about 1e-15 (zeroed at
    complex64's cutoff of 1e-10): every ratio far from the cutoff in f32 too
    (a rank-deficient random product is not: its dependent columns' f32
    residuals reach ratios^2 near 1e-10). Without ``collapsed`` (complex128)
    column 5 stays random: under complex128's cutoff of 1e-24 the 1e-15
    column would be kept as a direction that f64 fixes only to about 1e-8,
    a projector no two summation orders agree on to 1e-12. Returns the
    panel, its norms and its count of columns that must come out zero."""
    x = rng.standard_normal((B, m, p)) + 1j * rng.standard_normal((B, m, p))
    zeros = 0
    if kind == "degenerate":
        r = p // 2
        x[:, :, 3] = 0.0
        x[:, :, 7] = x[:, :, 1]
        fresh = rng.standard_normal((B, m, 2)) + 1j * rng.standard_normal((B, m, 2))
        fresh *= np.linalg.norm(x[:, :, 2:3], axis=1, keepdims=True) / np.linalg.norm(
            fresh, axis=1, keepdims=True)  # the scale of column 2
        if collapsed:
            x[:, :, 5] = x[:, :, 2] + 3e-8 * fresh[:, :, 0]
        x[:, :, r:] = x[:, :, :p - r]
        x[:, :, p - 1] = x[:, :, 2] + 1e-3 * fresh[:, :, 1]
        zeros = 2 + int(collapsed) + (r - 1)
    a = torch.from_numpy(x.astype(dtype))
    return a, (a.real ** 2 + a.imag ** 2).sum(1), zeros


@pytest.mark.parametrize("m", [256, 512, 1024, 2048, 2560])
@pytest.mark.parametrize("p", [32, 16])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("kind", ["full", "degenerate"])
def test_mgs2_panel_kernel_matches_plain(dev, m, p, dtype, kind):
    """K8 (the scanned panel step) against its plain version at the blocked
    route's panel shapes (m = 2 chi for chi 128 to 1024, a panel of 32 and a
    last panel of 16; m 2560 for the plan with the whole panel in global
    scratch), batch 32, each dtype at its cutoff (``orth.dep_tol2``), on
    whichever plan ``mgs2_plan`` names (every plan is reached: see
    test_mgs2_panel_plans): the same exact-zero columns, projectors within
    1e-5 (complex64) and 1e-12 (complex128), two launches bit-equal, one
    launch counted each; a launch over the shared-memory opt-in raises and
    is not counted."""
    a, n2, zeros = _mgs2_input(np.random.default_rng(m + p), 32, m, p, dtype, kind,
                               collapsed=dtype == np.complex64)
    a, n2 = a.to(dev), n2.to(dev)
    before = _build.LAUNCHES["mgs2_panel"]
    qk = blocked_qr.mgs2_panel_cuda(a, n2)
    assert _build.LAUNCHES["mgs2_panel"] == before + 1
    again = blocked_qr.mgs2_panel_cuda(a, n2)
    assert _build.LAUNCHES["mgs2_panel"] == before + 2
    with pytest.raises(RuntimeError, match="CUDA error"):
        blocked_qr.mgs2_panel_cuda(a, n2, smem_bytes=_build.smem_optin(dev.index) + 4096)
    assert _build.LAUNCHES["mgs2_panel"] == before + 2
    qp = blocked_qr.mgs2_panel_plain(a, n2)
    torch.cuda.synchronize()
    assert torch.equal(qk, again)
    assert torch.equal((qk == 0).all(1), (qp == 0).all(1))
    assert (qk == 0).all(1).sum().item() == 32 * zeros
    tol = 1e-5 if dtype == np.complex64 else 1e-12
    assert (qk @ qk.mH - qp @ qp.mH).abs().max().item() <= tol


def test_mgs2_panel_plans(dev):
    """The plans of test_mgs2_panel_kernel_matches_plain's shapes reach all
    four kinds in both dtypes; the C side's shared memory and register
    columns equal the Python plan's; and a launch whose plan the C side was
    not built for (register columns other than its own, a register plan on
    a panel wider than its registers, a vector longer than the group) is
    refused, raises and counts nothing."""
    optin = _build.smem_optin(dev.index)
    lib = _build.load()
    kinds = set()
    for dtype in (torch.complex64, torch.complex128):
        dbl = int(dtype == torch.complex128)
        for m in (256, 512, 1024, 2048, 2560):
            for p in (32, 16):
                plan = blocked_qr.mgs2_plan(m, p, dtype, optin)
                kinds.add((dtype, plan.kind))
                assert lib.qk_mgs2_smem(p, dbl, plan.code, plan.epl) == plan.smem_bytes
                if plan.kind != "memory":
                    assert lib.qk_mgs2_reg_cols(dbl, plan.epl) == plan.reg_cols
    assert kinds == {(d, k) for d in (torch.complex64, torch.complex128)
                     for k in blocked_qr.MGS2_KINDS}
    a, n2, _ = _mgs2_input(np.random.default_rng(4), 2, 512, 32, np.complex64, "full")
    a, n2 = a.to(dev), n2.to(dev)
    good = blocked_qr.mgs2_plan(512, 32, torch.complex64, optin)
    before = dict(_build.LAUNCHES)
    for bad in (dataclasses.replace(good, reg_cols=16),
                blocked_qr.Mgs2Plan("registers", 4, 16, 0, 0),
                dataclasses.replace(good, epl=1)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            blocked_qr.mgs2_panel_cuda(a, n2, plan=bad)
    assert _build.LAUNCHES == before


def test_mgs2_panel_refusals_and_routing(dev):
    """K8's wrapper on CUDA tensors refuses a non-contiguous panel, a real
    dtype, more than 32 columns and norms of another dtype, and a launch
    over the shared-memory limit raises uncounted; ``qr_orth_blocked`` on
    CUDA tensors at a full class sends every scanned panel to K8 (complex128
    whatever ``kernel_panels`` says; complex64 with it off), no plain version
    on the card, and matches the CPU."""
    a, n2, _ = _mgs2_input(np.random.default_rng(1), 2, 512, 32, np.complex64, "full")
    a, n2 = a.to(dev), n2.to(dev)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="contiguous"):
        blocked_qr.mgs2_panel_cuda(torch.cat([a, a], 2)[:, :, :32], n2)
    with pytest.raises(TypeError):
        blocked_qr.mgs2_panel_cuda(a.real.contiguous(), n2)
    with pytest.raises(ValueError, match="P <= 32"):
        blocked_qr.mgs2_panel_cuda(torch.cat([a, a], 2), torch.cat([n2, n2], 1))
    with pytest.raises(ValueError, match="n2_orig"):
        blocked_qr.mgs2_panel_cuda(a, n2.double())
    with pytest.raises(RuntimeError, match="CUDA error"):
        blocked_qr.mgs2_panel_cuda(a, n2, smem_bytes=_build.smem_optin(dev.index) + 4096)
    assert _build.LAUNCHES == before
    rng = np.random.default_rng(2)
    for dtype, kernel_panels in ((np.complex128, True), (np.complex128, False),
                                 (np.complex64, False)):
        wide = torch.from_numpy(_input(rng, "zero_padded", 4, 288, 144, dtype))
        _build.reset_counters()
        q = blocked_qr.qr_orth_blocked(wide.to(dev), kernel_panels)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["mgs2_panel"] == 5 and _build.LAUNCHES["orth"] == 0
        assert sum(_build.PLAIN_ON_CUDA.values()) == 0
        q_cpu = blocked_qr.qr_orth_blocked(wide, kernel_panels)
        tol = 1e-12 if dtype == np.complex128 else TOL
        assert (q.cpu() @ q.cpu().mH - q_cpu @ q_cpu.mH).abs().max().item() <= tol


def test_double_and_global_scratch_layouts(dev):
    """complex128 runs the double instantiation; chi 128 in f32 (m = k = 256,
    nc = 128) does not fit shared memory and runs the global-scratch layout."""
    rng = np.random.default_rng(3)
    v = torch.from_numpy(_input(rng, "full", 4, 128, 64, np.complex128)).to(dev)
    _close(*orth.orth_r_cuda(v), *orth.orth_r_plain(v), 1e-12)
    th = torch.from_numpy(_input(rng, "full", 4, 64, 64, np.complex128)).to(dev)
    v0 = start_block(64, 32, th.dtype, dev)
    _close(*split.subspace_factor_cuda(th, v0, 2), *split.subspace_factor_plain(th, v0, 2),
           1e-12)
    th = torch.from_numpy(_input(rng, "rank_deficient", 2, 256, 256)).to(dev)
    v0 = start_block(256, 128, th.dtype, dev)
    _close(*split.subspace_factor_cuda(th, v0, 1), *split.subspace_factor_plain(th, v0, 1), TOL)
    v = torch.from_numpy(_input(rng, "full", 2, 256, 128)).to(dev)
    _close(*orth.orth_r_cuda(v), *orth.orth_r_plain(v), TOL)


def test_refused_launch_raises_and_is_not_counted(dev):
    v = torch.zeros((2, 32, 16), dtype=torch.complex64, device=dev)
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error"):
        orth.orth_r_cuda(v, smem_bytes=_build.smem_optin(dev.index) + 4096)
    assert _build.LAUNCHES == before
    q, r = orth.orth_r_cuda(v)  # the next launch is clean
    torch.cuda.synchronize()
    assert q.abs().max().item() == 0.0
    with pytest.raises(ValueError):
        orth.orth_r_cuda(torch.zeros((2, 256, 144), dtype=torch.complex64, device=dev))


@pytest.mark.parametrize("route,cfg_kw,used,unused", [
    ("fused", dict(fused_split=True), ("split", "orth_r"), ("orth", "gate_split")),
    # without staging every update runs at chi 16, which K4 takes
    ("fused_gate", dict(fused_split=True, fused_gate=True), ("orth_r", "gate_split"),
     ("split", "orth")),
    ("unfused", dict(fused_split=False), ("orth",), ("split", "orth_r", "gate_split")),
])
def test_slice_on_card_matches_cpu(dev, monkeypatch, route, cfg_kw, used, unused):
    monkeypatch.setenv("QMLTPU_STAGED", "0" if route == "fused_gate" else "1")
    nq = 8
    X = np.random.default_rng(2).uniform(0.0, 2.0, size=(6, nq))
    ans = KernelStateAnsatz(nq, 1, 1.0, entanglement_graph(nq, 2))
    cfg = SimConfig(chi=16, tile_block=2, svd_method="subspace", **cfg_kw)
    _build.reset_counters()
    K_gpu = build_kernel_matrix(ans, X, cfg=cfg, sim_batch=4, tile=4, device="cuda")
    for name in used:
        assert _build.LAUNCHES[name] > 0, (route, name)
    for name in unused:
        assert _build.LAUNCHES[name] == 0, (route, name)
    assert sum(_build.PLAIN_ON_CUDA.values()) == 0
    K_cpu = build_kernel_matrix(ans, X, cfg=cfg, sim_batch=4, tile=4, device="cpu")
    np.testing.assert_allclose(K_gpu, K_cpu, atol=3e-5)


def _close_brick(dev, A, Bm, g, lam, nc, iters, tol):
    """K5 against its plain version: ``theta_t V^H V`` (from na0 and q2,
    relative to max |theta_t|), sorted s2, total, orthonormality and the
    exact zeros of dropped directions."""
    A, Bm, g, lam = (torch.from_numpy(x).to(dev) for x in (A, Bm, g, lam))
    v0 = start_block(A.shape[1], nc, A.dtype, dev)
    before = _build.LAUNCHES["brick_split"]
    q2, na0, s2, tot, res = split.brick_gate_split(A, Bm, g, lam, v0, iters)
    assert _build.LAUNCHES["brick_split"] == before + 1
    pq2, pna0, ps2, ptot, pres = split.brick_gate_split_plain(A, Bm, g, lam, v0, iters)
    torch.cuda.synchronize()
    scale = split.gate_theta(A, Bm, g).abs().max().item()
    proj = lambda na, q: na.mT @ q.conj()
    assert ((proj(na0, q2) - proj(pna0, pq2)).abs().max().item()) / scale <= tol
    srt = lambda x: torch.sort(x, dim=1, descending=True).values
    assert (srt(s2) - srt(ps2)).abs().max().item() <= tol * ps2.max().item()
    rel = 1e-5 if tol > 1e-9 else 1e-12
    assert ((tot - ptot).abs() / ptot).max().item() <= rel
    # The weight the directions miss, as in _close_gate: the chain runs on
    # theta_w^H with q = q2^T.
    assert (res - pres).abs().max().item() <= tol * ptot.max().item()
    th_h = (split.gate_theta(A, Bm, g) * torch.cat([lam, lam], 1)[:, :, None]).mH
    q = q2.mT
    assert ((res - split.residual_norm2(th_h, q, q.mH @ th_h)).abs() / ptot).max().item() <= rel
    live = q2.abs().pow(2).sum(2) > 0.25
    gram = q2.conj() @ q2.mT - torch.diag_embed(live.to(q2.real.dtype)).to(q2.dtype)
    assert gram.abs().max().item() <= (5e-6 if tol > 1e-9 else 1e-12)
    assert torch.count_nonzero(q2[~live]) == 0 and torch.count_nonzero(na0[~live]) == 0


def _lam(rng, b, chi, rank, dtype=np.float32):
    lam = np.zeros((b, chi), dtype)
    lam[:, :rank] = rng.uniform(0.3, 1.0, size=(b, rank))
    return lam


@pytest.mark.parametrize("chi", [16, 32, 64, 128])
@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("kind", ["full", "rank_deficient", "zero_padded"])
def test_brick_split_kernel_matches_plain(dev, chi, iters, kind):
    """K5: thH in shared memory up to chi 64, everything in global scratch
    at chi 128; lambda with exact zeros past a rank of 5 on the
    rank-deficient and zero-padded inputs."""
    rng = np.random.default_rng(200 + chi + iters)
    A, Bm, g = _gate_inputs(rng, kind, 6, chi)
    lam = _lam(rng, 6, chi, chi if kind == "full" else 5)
    _close_brick(dev, A, Bm, g, lam, chi, iters, TOL)


def test_brick_split_oversampled_and_double(dev):
    """nc = chi + 16; complex128 (the double instantiation) in shared and in
    global scratch; a CPU lambda or a wrong shape raises."""
    rng = np.random.default_rng(17)
    _close_brick(dev, *_gate_inputs(rng, "full", 4, 16), _lam(rng, 4, 16, 16), 32, 2, TOL)
    _close_brick(dev, *_gate_inputs(rng, "zero_padded", 4, 16, np.complex128),
                 _lam(rng, 4, 16, 5, np.float64), 16, 2, 1e-12)
    _close_brick(dev, *_gate_inputs(rng, "full", 2, 64, np.complex128),
                 _lam(rng, 2, 64, 64, np.float64), 64, 1, 1e-12)
    A, Bm, g = (torch.from_numpy(x).to(dev) for x in _gate_inputs(rng, "full", 2, 16))
    v0 = start_block(32, 16, A.dtype, dev)
    with pytest.raises(ValueError):
        split.brick_gate_split_cuda(A, Bm, g, torch.ones(2, 16), v0, 1)
    with pytest.raises(ValueError):
        split.brick_gate_split_cuda(A, Bm, g, torch.ones(2, 8, device=dev), v0, 1)


def test_update_pairs_on_card_matches_cpu(dev):
    """The fused brick update (K5) and the unfused one (K1) on the card
    against the fused update on the CPU, on the pair product."""
    from qml_cutensornet_tpu_torch.config import SimConfig as Cfg

    rng = np.random.default_rng(19)
    B, K, chi = 2, 3, 16
    a = _input(rng, "zero_padded", B * K, 2 * chi, chi).reshape(B, K, chi, 2, chi)
    b = _input(rng, "zero_padded", B * K, chi, 2 * chi).reshape(B, K, chi, 2, chi)
    lam = _lam(rng, B * K, chi, 5).reshape(B, K, chi)
    th = rng.uniform(-1.0, 1.0, size=(B, K)).astype(np.float32)
    prods = {}
    for where, fused_gate in (("cpu", True), ("cuda", True), ("cuda", False)):
        d = torch.device("cpu") if where == "cpu" else dev
        args = [torch.from_numpy(x).to(d) for x in (a, b, lam, th)]
        _build.reset_counters()
        na, nb, s, kf, rank = update_pairs(*args, 1.0, Cfg(chi=chi, svd_method="subspace",
                                                           fused_split=True,
                                                           fused_gate=fused_gate))
        if where == "cuda":
            name = "brick_split" if fused_gate else "split"
            assert _build.LAUNCHES[name] == 1 and sum(_build.LAUNCHES.values()) == 1
            assert sum(_build.PLAIN_ON_CUDA.values()) == 0
        prods[(where, fused_gate)] = torch.einsum("bkasc,bkctd->bkastd", na, nb).cpu()
    for key in (("cuda", True), ("cuda", False)):
        assert (prods[key] - prods[("cpu", True)]).abs().max().item() <= 3e-5, key


@pytest.mark.parametrize("fused_gate", [True, False])
def test_brick_slice_on_card_matches_cpu(dev, monkeypatch, fused_gate):
    """The brick route on a tiny circuit: without staging every pair update
    is K5 (fused gate) or K1; the Gram equals the CPU run's."""
    monkeypatch.setenv("QMLTPU_STAGED", "0")
    nq = 8
    X = np.random.default_rng(2).uniform(0.0, 2.0, size=(6, nq))
    ans = KernelStateAnsatz(nq, 1, 1.0, entanglement_graph(nq, 2), routing="brick")
    cfg = SimConfig(chi=16, tile_block=2, svd_method="subspace", fused_split=True,
                    fused_gate=fused_gate)
    _build.reset_counters()
    K_gpu = build_kernel_matrix(ans, X, cfg=cfg, sim_batch=4, tile=4, device="cuda")
    used = "brick_split" if fused_gate else "split"
    assert _build.LAUNCHES[used] > 0
    assert sum(_build.LAUNCHES.values()) == _build.LAUNCHES[used]
    assert sum(_build.PLAIN_ON_CUDA.values()) == 0
    K_cpu = build_kernel_matrix(ans, X, cfg=cfg, sim_batch=4, tile=4, device="cpu")
    np.testing.assert_allclose(K_gpu, K_cpu, atol=3e-5)


C64, C128 = torch.complex64, torch.complex128


def _zeros_kept(q, x):
    """Rows of the input that are exact zeros stay exact zeros in q."""
    zero_rows = (x.abs().sum(2) == 0)[:, :, None].expand_as(q)
    assert torch.count_nonzero(q[zero_rows]) == 0


@pytest.mark.parametrize("B,chi,nc,dtype,plan", [
    (1, 8, 8, C64, (True, True, False)),
    (32, 32, 32, C64, (True, True, False)),
    (100, 64, 64, C64, (True, True, True)),
    (32, 64, 80, C64, (False, True, False)),
    (32, 64, 64, C128, (False, True, True)),
    (408, 128, 128, C64, (False, False, False)),
])
@pytest.mark.parametrize("kind", ["full", "rank_deficient", "zero_padded"])
def test_split_kernel_each_launch_plan(dev, B, chi, nc, dtype, plan, kind):
    """K1 on each launch plan its wrapper chooses (theta in shared memory
    with two row buffers or one; theta in global memory with the rows in
    shared memory, two buffers or one; everything in global memory), against
    the plain version; exact zeros of the input stay exact zeros. With more
    columns than the input's rank (nc 80 on the rank-deficient and padded
    inputs) the surplus columns are rounding residuals, so only the product
    q r is compared there."""
    m = 2 * chi
    chosen = split.split_plan(B, m, m, nc, dtype, _build.smem_optin(dev.index))
    assert (chosen.theta_smem, chosen.rows_smem, chosen.inplace) == plan
    assert _build.load().qk_split_smem(m, m, nc, int(dtype == C128), int(plan[1]), int(plan[0]),
                                       int(plan[2])) == chosen.smem_bytes  # C and Python agree
    rng = np.random.default_rng(B + chi + nc)
    npdt = np.complex64 if dtype == C64 else np.complex128
    th = torch.from_numpy(_input(rng, kind, B, m, m, npdt)).to(dev)
    v0 = start_block(m, nc, dtype, dev)
    tol = TOL if dtype == C64 else 1e-12
    qk, rk = split.subspace_factor(th, v0, 2)
    qp, rp = split.subspace_factor_plain(th, v0, 2)
    torch.cuda.synchronize()
    if nc > chi and kind != "full":
        assert (qk @ rk - qp @ rp).abs().max().item() <= tol
    else:
        _close(qk, rk, qp, rp, tol)
    _zeros_kept(qk, th)
    dead = (qk.abs().pow(2).sum(1) < 0.25)[:, None, :].expand_as(qk)
    assert torch.count_nonzero(qk[dead]) == 0


@pytest.mark.parametrize("B,chi,dtype,plan", [
    (1, 64, C64, (True, True)),
    (100, 32, C64, (True, True)),
    (32, 64, C128, (True, False)),
    (32, 128, C64, (False, False)),
    (32, 128, C128, (False, False)),
])
@pytest.mark.parametrize("kind", ["full", "rank_deficient", "zero_padded"])
def test_orth_r_kernel_each_launch_plan(dev, B, chi, dtype, plan, kind):
    """K2 on each launch plan its wrapper chooses (Q and v in shared memory;
    Q alone; both in global memory), against the plain version."""
    chosen = orth.orth_r_plan(B, 2 * chi, chi, dtype, _build.smem_optin(dev.index))
    assert (chosen.rows_smem, chosen.v_smem) == plan
    assert _build.load().qk_orth_r_smem(2 * chi, chi, int(dtype == C128), int(plan[0]),
                                        int(plan[1])) == chosen.smem_bytes
    rng = np.random.default_rng(B + chi)
    npdt = np.complex64 if dtype == C64 else np.complex128
    v = torch.from_numpy(_input(rng, kind, B, 2 * chi, chi, npdt)).to(dev)
    qk, rk = orth.orth_r_cuda(v)
    qp, rp = orth.orth_r_plain(v)
    torch.cuda.synchronize()
    _close(qk, rk, qp, rp, TOL if dtype == C64 else 1e-12)
    _zeros_kept(qk, v)


@pytest.mark.parametrize("B,chi", [(1, 64), (32, 32), (32, 64), (100, 64)])
def test_split_and_orth_r_launches_are_bit_equal(dev, B, chi):
    """Two launches on one input give bit-equal outputs: every sum of K1 and
    K2 is taken in a fixed order, with no atomics."""
    rng = np.random.default_rng(chi)
    th = torch.from_numpy(_input(rng, "full", B, 2 * chi, 2 * chi)).to(dev)
    v0 = start_block(2 * chi, chi, th.dtype, dev)
    v = torch.from_numpy(_input(rng, "rank_deficient", B, 2 * chi, chi)).to(dev)
    for fn in (lambda: split.subspace_factor_cuda(th, v0, 2), lambda: orth.orth_r_cuda(v)):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_refused_split_launch_raises_and_is_not_counted(dev):
    """A K1 launch asking for less shared memory than its plan needs is
    refused by the C side, one asking for more than the card allows by the
    launch; both raise and count nothing."""
    th = torch.zeros((2, 128, 128), dtype=C64, device=dev)
    v0 = start_block(128, 64, th.dtype, dev)
    plan = split.split_plan(2, 128, 128, 64, th.dtype, _build.smem_optin(dev.index))
    before = dict(_build.LAUNCHES)
    for nbytes in (plan.smem_bytes - 16, _build.smem_optin(dev.index) + 4096):
        with pytest.raises(RuntimeError, match="CUDA error"):
            split.subspace_factor_cuda(th, v0, 1, smem_bytes=nbytes)
    assert _build.LAUNCHES == before
    q, _ = split.subspace_factor_cuda(th, v0, 1)  # the next launch is clean
    torch.cuda.synchronize()
    assert q.abs().max().item() == 0.0


@pytest.mark.parametrize("B,chi,nc,dtype,plan", [
    (32, 16, 16, C64, (True, True, False)),
    (32, 64, 64, C64, (True, True, True)),
    (32, 64, 80, C64, (False, True, False)),
    (8, 128, 128, C64, (False, False, False)),
    (8, 32, 32, C128, (True, True, False)),
    (8, 64, 64, C128, (False, True, True)),
    (2, 128, 128, C128, (False, False, False)),
])
@pytest.mark.parametrize("kind", ["full", "rank_deficient", "zero_padded"])
def test_gate_and_brick_kernels_each_launch_plan(dev, B, chi, nc, dtype, plan, kind):
    """K4 and K5 on each launch plan their wrappers choose (theta in shared
    memory with two row buffers or one; theta in global scratch with the rows
    in shared memory, two buffers or one; everything in global scratch),
    against their plain versions; exact zeros of the input stay exact zeros.
    With more columns than theta's rank the surplus columns are rounding
    residuals, so only K4's product q r is compared there."""
    optin = _build.smem_optin(dev.index)
    chosen = split.gate_split_plan(B, chi, nc, dtype, optin)
    assert (chosen.theta_smem, chosen.rows_smem, chosen.inplace) == plan
    assert split.brick_split_plan(B, chi, nc, dtype, optin).smem_bytes == chosen.smem_bytes
    lib = _build.load()
    for smem in (lib.qk_gate_split_smem, lib.qk_brick_split_smem):  # C and Python agree
        assert smem(chi, nc, int(dtype == C128), *map(int, plan)) == chosen.smem_bytes
    rng = np.random.default_rng(300 + B + chi + nc)
    npdt = np.complex64 if dtype == C64 else np.complex128
    tol = TOL if dtype == C64 else 1e-12
    A, Bm, g = _gate_inputs(rng, kind, B, chi, npdt)
    if nc > chi and kind != "full":
        tA, tB, tg = (torch.from_numpy(x).to(dev) for x in (A, Bm, g))
        v0 = start_block(2 * chi, nc, tA.dtype, dev)
        qk, rk, _, _ = split.gate_subspace_factor_cuda(tA, tB, tg, v0, 2)
        qp, rp, _, _ = split.gate_subspace_factor_plain(tA, tB, tg, v0, 2)
        torch.cuda.synchronize()
        assert (qk @ rk - qp @ rp).abs().max().item() <= tol
    else:
        _close_gate(dev, A, Bm, g, nc, 2, tol)
    tA, tB, tg = (torch.from_numpy(x).to(dev) for x in (A, Bm, g))
    qk, _, _, _ = split.gate_subspace_factor_cuda(tA, tB, tg, start_block(2 * chi, nc, tA.dtype,
                                                                          dev), 2)
    _zeros_kept(qk, split.gate_theta(tA, tB, tg))
    lam = _lam(rng, B, chi, chi if kind == "full" else 5,
               np.float32 if dtype == C64 else np.float64)
    if nc == chi:
        _close_brick(dev, A, Bm, g, lam, nc, 2, tol)


@pytest.mark.parametrize("chi,B", [(16, 6), (32, 32), (64, 32), (128, 408)])
def test_gate_and_brick_launches_are_bit_equal(dev, chi, B):
    """Two launches of K4 and of K5 on one input give bit-equal outputs: the
    theta build's total and every sum of the chain in a fixed order, no
    atomics."""
    rng = np.random.default_rng(400 + chi)
    A, Bm, g = (torch.from_numpy(x).to(dev) for x in _gate_inputs(rng, "full", B, chi))
    lam = torch.from_numpy(_lam(rng, B, chi, chi)).to(dev)
    v0 = start_block(2 * chi, chi, A.dtype, dev)
    for fn in (lambda: split.gate_subspace_factor_cuda(A, Bm, g, v0, 2),
               lambda: split.brick_gate_split_cuda(A, Bm, g, lam, v0, 2)):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_refused_gate_and_brick_launches_raise_and_are_not_counted(dev):
    """A K4 or K5 launch asking for less shared memory than its plan needs
    is refused by the C side, one asking for more than the card allows by
    the launch; both raise and count nothing."""
    chi = 64
    A = torch.zeros((2, 2 * chi, chi), dtype=C64, device=dev)
    Bm = torch.zeros((2, chi, 2 * chi), dtype=C64, device=dev)
    g = torch.eye(4, dtype=C64, device=dev).expand(2, 4, 4).contiguous()
    lam = torch.ones((2, chi), device=dev)
    v0 = start_block(2 * chi, chi, C64, dev)
    optin = _build.smem_optin(dev.index)
    plan = split.gate_split_plan(2, chi, chi, C64, optin)
    before = dict(_build.LAUNCHES)
    for nbytes in (plan.smem_bytes - 16, optin + 4096):
        with pytest.raises(RuntimeError, match="CUDA error"):
            split.gate_subspace_factor_cuda(A, Bm, g, v0, 1, smem_bytes=nbytes)
        with pytest.raises(RuntimeError, match="CUDA error"):
            split.brick_gate_split_cuda(A, Bm, g, lam, v0, 1, smem_bytes=nbytes)
    assert _build.LAUNCHES == before
    q, _, tot, _ = split.gate_subspace_factor_cuda(A, Bm, g, v0, 1)  # the next launches are clean
    q2, na0, _, total, _ = split.brick_gate_split_cuda(A, Bm, g, lam, v0, 1)
    torch.cuda.synchronize()
    assert q.abs().max().item() == 0.0 and tot.abs().max().item() == 0.0
    assert q2.abs().max().item() == 0.0 and na0.abs().max().item() == 0.0
    assert total.abs().max().item() == 0.0


@pytest.mark.parametrize("m,k,dtype,plan", [
    (128, 64, C64, (True, 4, 1)),
    (256, 32, C64, (True, 8, 1)),
    (512, 32, C64, (True, 16, 1)),
    (1024, 16, C64, (True, 16, 2)),
    (2048, 8, C64, (True, 16, -1)),
    (256, 128, C64, (False, 8, 1)),
    (512, 64, C64, (False, 16, 1)),
    (1024, 32, C64, (False, 16, 2)),
    (2048, 32, C64, (False, 16, -1)),
    (128, 64, C128, (True, 4, 1)),
    (256, 32, C128, (True, 8, 1)),
    (512, 16, C128, (True, 16, 1)),
    (1024, 8, C128, (True, 16, 2)),
    (2048, 4, C128, (True, 16, -1)),
    (128, 128, C128, (False, 4, 1)),
    (256, 64, C128, (False, 8, 1)),
    (512, 32, C128, (False, 16, 1)),
    (1024, 32, C128, (False, 16, 2)),
    (2048, 32, C128, (False, 16, -1)),
])
@pytest.mark.parametrize("kind", ["full", "rank_deficient", "zero_padded"])
def test_orth_kernel_each_launch_plan(dev, m, k, dtype, plan, kind):
    """K3 on each launch plan its wrapper chooses (the rows in shared memory
    or in global scratch; each in-panel group) against the plain version,
    and two launches bit-equal."""
    chosen = orth.orth_plan(8, m, k, dtype, _build.smem_optin(dev.index))
    assert (chosen.rows_smem, chosen.group_warps, chosen.group_epl) == plan
    assert _build.load().qk_orth_smem(m, k, int(dtype == C128), int(plan[0])) == chosen.smem_bytes
    rng = np.random.default_rng(m + k)
    npdt = np.complex64 if dtype == C64 else np.complex128
    v = torch.from_numpy(_input(rng, kind, 8, m, k, npdt)).to(dev)
    qk, qk2, qp = orth.orth_cuda(v), orth.orth_cuda(v), orth.orth_plain(v)
    torch.cuda.synchronize()
    assert torch.equal(qk, qk2)
    _close(qk, qk.mH @ v, qp, qp.mH @ v, TOL if dtype == C64 else 1e-12)
    _zeros_kept(qk, v)
    live = (qk.abs().sum(1) > 0).to(qk.real.dtype)
    gram = qk.mH @ qk - torch.diag_embed(live).to(qk.dtype)
    assert gram.abs().max().item() <= (5e-6 if dtype == C64 else 1e-12)


def test_refused_orth_launch_raises_and_is_not_counted(dev):
    """A K3 launch asking for less shared memory than its plan needs is
    refused by the C side, one asking for more than the card allows by the
    launch; both raise and count nothing."""
    v = torch.zeros((2, 512, 32), dtype=C64, device=dev)
    plan = orth.orth_plan(2, 512, 32, v.dtype, _build.smem_optin(dev.index))
    before = dict(_build.LAUNCHES)
    for nbytes in (plan.smem_bytes - 16, _build.smem_optin(dev.index) + 4096):
        with pytest.raises(RuntimeError, match="CUDA error"):
            orth.orth_cuda(v, smem_bytes=nbytes)
    assert _build.LAUNCHES == before
    q = orth.orth_cuda(v)  # the next launch is clean
    torch.cuda.synchronize()
    assert q.abs().max().item() == 0.0


# ---------------------------------------------------------------- options
# The single-card options on the card at small sizes, each against the same
# call on CPU copies (f32 3e-5 on Grams; projectors 1e-5 in f32, 1e-10 in f64).

@pytest.mark.parametrize("method", ["svd", "eigh"])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_svd_methods_on_card_match_cpu(dev, method, dtype):
    """``truncated_svd`` with "svd" and "eigh" on a CUDA tensor runs
    cuSOLVER on the card, no kernel and no plain version, and agrees with
    the same call on the CPU copy."""
    from qml_cutensornet_tpu_torch.ops import svd

    rng = np.random.default_rng(3)
    B, m, keep = 6, 32, 12
    u, _ = np.linalg.qr(rng.standard_normal((B, m, m)) + 1j * rng.standard_normal((B, m, m)))
    w, _ = np.linalg.qr(rng.standard_normal((B, m, m)) + 1j * rng.standard_normal((B, m, m)))
    sv = np.concatenate([np.geomspace(1.0, 0.3, keep), np.geomspace(0.03, 0.003, m - keep)])
    theta = torch.from_numpy(((u * sv) @ w.conj().transpose(0, 2, 1)).astype(dtype))
    prec = "f32" if dtype == np.complex64 else "f64"
    cfg = SimConfig(chi=keep, svd_method=method, precision=prec)
    _build.reset_counters()
    lg, rg, kfg, rkg = svd.truncated_svd(theta.to(dev), cfg, keep)
    torch.cuda.synchronize()
    assert sum(_build.LAUNCHES.values()) == 0 and sum(_build.PLAIN_ON_CUDA.values()) == 0
    assert lg.is_cuda and rg.is_cuda
    lc, rc, kfc, rkc = svd.truncated_svd(theta, cfg, keep)
    tol = 1e-5 if prec == "f32" else 1e-10
    lg, rg = lg.cpu(), rg.cpu()
    assert (lg @ lg.mH - lc @ lc.mH).abs().max().item() <= tol
    assert (lg @ rg - lc @ rc).abs().max().item() <= tol
    assert (kfg.cpu() - kfc).abs().max().item() <= tol
    assert torch.equal(rkg.cpu(), rkc)


@pytest.mark.parametrize("route,cfg_kw,routing,used,unused", [
    ("svd", dict(svd_method="svd", fused_split=True), "tracked", ("orth_r",),
     ("split", "orth", "gate_split")),
    ("eigh", dict(svd_method="eigh", fused_split=True, fused_gate=True), "tracked", ("orth_r",),
     ("split", "orth", "gate_split")),
    ("reference", dict(svd_method="subspace", fused_split=True), "reference",
     ("split", "orth_r"), ("orth", "gate_split")),
])
def test_option_routes_on_card_match_cpu(dev, monkeypatch, route, cfg_kw, routing, used,
                                         unused):
    """The svd and eigh routes (cuSOLVER and K2; K1 and K4 never, even with
    the fused-gate flag) and reference routing (K1 + K2) on 8 qubits."""
    monkeypatch.setenv("QMLTPU_STAGED", "1")
    nq = 8
    X = np.random.default_rng(2).uniform(0.0, 2.0, size=(6, nq))
    ans = KernelStateAnsatz(nq, 1, 1.0, entanglement_graph(nq, 2), routing=routing)
    cfg = SimConfig(chi=16, tile_block=2, **cfg_kw)
    _build.reset_counters()
    K_gpu = build_kernel_matrix(ans, X, cfg=cfg, sim_batch=4, tile=4, device="cuda")
    for name in used:
        assert _build.LAUNCHES[name] > 0, (route, name)
    for name in unused:
        assert _build.LAUNCHES[name] == 0, (route, name)
    assert sum(_build.PLAIN_ON_CUDA.values()) == 0
    K_cpu = build_kernel_matrix(ans, X, cfg=cfg, sim_batch=4, tile=4, device="cpu")
    np.testing.assert_allclose(K_gpu, K_cpu, atol=3e-5)


def test_gate_list_on_card_matches_cpu(dev):
    """``simulate_gate_list`` of ``circuit_for_data`` on the card: one K1
    launch per two-site op and one K2 launch per center move."""
    from qml_cutensornet_tpu_torch.models.ansatz import GATE_I, GATE_RX
    from qml_cutensornet_tpu_torch.models.simulate import lower_gate_list, simulate_gate_list
    from qml_cutensornet_tpu_torch.ops import mps

    nq = 8
    ans = KernelStateAnsatz(nq, 2, 1.0, entanglement_graph(nq, 3))
    gates = ans.circuit_for_data(np.random.default_rng(4).uniform(0.0, 2.0, size=nq))
    kinds = lower_gate_list(gates, nq)[1]
    cfg = SimConfig(chi=16, svd_method="subspace", fused_split=True)
    _build.reset_counters()
    st = simulate_gate_list(gates, nq, cfg, device="cuda")
    torch.cuda.synchronize()
    assert _build.LAUNCHES["split"] == int(np.sum((kinds != GATE_I) & (kinds < GATE_RX)))
    assert _build.LAUNCHES["orth_r"] == int(np.sum(kinds == GATE_I))
    assert sum(_build.PLAIN_ON_CUDA.values()) == 0
    ref = simulate_gate_list(gates, nq, cfg, device="cpu")
    a = mps.to_dense(mps.mps_to_numpy(st)[0][0], nq)
    b = mps.to_dense(mps.mps_to_numpy(ref)[0][0], nq)
    assert abs(abs(np.vdot(a, b)) ** 2 / (np.vdot(a, a) * np.vdot(b, b)).real - 1.0) <= 3e-5


def test_checkpoint_resume_on_card(dev, tmp_path):
    """Per-tile checkpoint on the card (the reference's own case, f64 so
    that the normalized first tile stands for the raw one the build saves):
    removed at the end; a partial one holding the first tile resumes to the
    full Gram."""
    nq = 6
    X = np.random.default_rng(0).uniform(0, 2, size=(10, nq))
    ans = KernelStateAnsatz(nq, 1, 0.8, entanglement_graph(nq, 2))
    cfg = SimConfig(chi=8, precision="f64", svd_method="subspace", fused_split=True)
    kw = dict(cfg=cfg, sim_batch=4, tile=4, checkpoint=True, checkpoint_dir=str(tmp_path),
              device="cuda")
    K_full = build_kernel_matrix(ans, X, info_file=str(tmp_path / "run"), **kw)
    assert not list(tmp_path.glob("checkpoint_*.npy"))
    partial = np.zeros((12, 12))
    partial[:4, :4] = K_full[:4, :4]
    np.save(tmp_path / "checkpoint_run.npy", partial)
    K_res = build_kernel_matrix(ans, X, info_file=str(tmp_path / "run"), **kw)
    np.testing.assert_allclose(K_res, K_full, atol=1e-12)
    assert not list(tmp_path.glob("checkpoint_*.npy"))


def test_choose_chi_and_mem_log_on_card_match_cpu(dev):
    """``choose_chi`` picks the CPU's chi on the card; the op-by-op memory
    log of ``cli.main_track_mem`` has the CPU's lines."""
    import io

    from qml_cutensornet_tpu_torch.cli.main_track_mem import simulate_with_mem_log
    from qml_cutensornet_tpu_torch.utils.autotune import choose_chi

    nq = 8
    ans = KernelStateAnsatz(nq, 2, 1.0, entanglement_graph(nq, 3))
    X = np.random.default_rng(1).uniform(0, 2, size=(3, nq))
    cfg = SimConfig(precision="f64", svd_method="subspace", fused_split=True)
    chis = [choose_chi(ans.schedule, X, cfg, chi_start=2, chi_max=16, device=d)
            for d in ("cuda", "cpu")]
    assert chis[0] == chis[1]
    logs = [io.StringIO(), io.StringIO()]
    for log, d in zip(logs, ("cuda", "cpu")):
        simulate_with_mem_log(ans.schedule, X[0], dataclasses.replace(cfg, chi=16), device=d,
                              log=log)
    sizes = [[float(line.split("=")[1]) for line in log.getvalue().splitlines()] for log in logs]
    assert len(sizes[0]) == len(sizes[1]) == ans.schedule.num_two_site_ops
    np.testing.assert_allclose(sizes[0], sizes[1], atol=1e-12)


# ------------------------------------------------- the pair step and the caps
# The block-2 in-panel variant (``pair``, the reference's mgs_pair) of K1 to
# K5 from their pair libraries against the plain pair versions (f32 at the
# kernel tolerance above), and K1 at the brick caps' rectangular shapes.

def _pair_case(name, rng, kind, dev, dtype=np.complex64):
    """``(kernel(pair), plain(pair), factor, x)`` for kernel ``name`` at a
    main-path shape (chi 16 to 64, B 8): ``factor`` maps an output to the
    (q, product) that _close compares."""
    chi = {"split": 32, "orth_r": 64, "orth": 64, "gate_split": 32, "brick_split": 16}[name]
    m = 2 * chi
    v0 = start_block(m, chi, torch.complex64 if dtype == np.complex64 else torch.complex128,
                     dev)
    if name in ("orth_r", "orth"):
        v = torch.from_numpy(_input(rng, kind, 8, m, chi, dtype)).to(dev)
        if name == "orth":
            return (lambda p: orth.orth_cuda(v, p), lambda p: orth.orth_plain(v, p),
                    lambda q: (q, q @ (q.mH @ v)))
        return (lambda p: orth.orth_r_cuda(v, p), lambda p: orth.orth_r_plain(v, p),
                lambda out: (out[0], out[0] @ out[1]))
    if name == "split":
        th = torch.from_numpy(_input(rng, kind, 8, m, m, dtype)).to(dev)
        return (lambda p: split.subspace_factor_cuda(th, v0, 2, p),
                lambda p: split.subspace_factor_plain(th, v0, 2, p),
                lambda out: (out[0], out[0] @ out[1]))
    A = torch.from_numpy(_input(rng, kind, 8, m, chi, dtype)).to(dev)
    Bm = torch.from_numpy(_input(rng, kind, 8, chi, m, dtype)).to(dev)
    g = torch.from_numpy(np.linalg.qr(rng.standard_normal((8, 4, 4)))[0].astype(dtype)).to(dev)
    if name == "gate_split":
        return (lambda p: split.gate_subspace_factor_cuda(A, Bm, g, v0, 2, p),
                lambda p: split.gate_subspace_factor_plain(A, Bm, g, v0, 2, p),
                lambda out: (out[0], out[0] @ out[1]))
    lam = torch.from_numpy(rng.uniform(0.3, 1.0, size=(8, chi))).to(dev, A.real.dtype)
    # q2 rows V = conj(q2): the projected pair theta_t V^H V and the basis V^T
    return (lambda p: split.brick_gate_split_cuda(A, Bm, g, lam, v0, 2, p),
            lambda p: split.brick_gate_split_plain(A, Bm, g, lam, v0, 2, p),
            lambda out: (out[0].mT, out[1].mT @ out[0].conj()))


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", list(_build.PAIR_KERNELS))
@pytest.mark.parametrize("kind", ["full", "rank_deficient", "zero_padded"])
def test_pair_kernels_match_plain(dev, name, kind):
    """Each kernel's pair variant (its pair library, counted in
    ``PAIR_LAUNCHES``) against its plain pair version; two launches
    bit-equal."""
    kern, plain, factor = _pair_case(name, np.random.default_rng(len(name)), kind, dev)
    before = dict(_build.PAIR_LAUNCHES)
    out, again = kern(True), kern(True)
    assert _build.PAIR_LAUNCHES[name] == before[name] + 2
    ref = plain(True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(_tuple(out), _tuple(again)))
    (qk, pk), (qp, pp) = factor(out), factor(ref)
    assert (qk @ qk.mH - qp @ qp.mH).abs().max().item() <= TOL
    assert (pk - pp).abs().max().item() <= TOL * max(1.0, pp.abs().max().item())


@pytest.mark.parametrize("name", list(_build.PAIR_KERNELS))
def test_pair_changes_no_bit_in_f64(dev, name):
    """complex128 has no pair library: ``pair`` launches the single-column
    double kernel, bit-equal to the launch without it, and counts no pair
    launch."""
    kern, _, _ = _pair_case(name, np.random.default_rng(9), "full", dev, np.complex128)
    before = dict(_build.PAIR_LAUNCHES)
    a, b = kern(True), kern(False)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(_tuple(a), _tuple(b)))
    assert _build.PAIR_LAUNCHES == before


@pytest.mark.parametrize("k", [13, 21, 40])
def test_pair_odd_panel_widths(dev, k):
    """K3 and K2 with panels of odd width (the last column of an odd panel
    takes the single-column step)."""
    v = torch.from_numpy(_input(np.random.default_rng(k), "full", 8, 64, k)).to(dev)
    _close(orth.orth_cuda(v, True), orth.orth_cuda(v, True).mH @ v,
           orth.orth_plain(v, True), orth.orth_plain(v, True).mH @ v, TOL)
    _close(*orth.orth_r_cuda(v, True), *orth.orth_r_plain(v, True), TOL)


# (m, k, nc) = (2 cr, 2 cl, cm) of the caps buckets at nf 100, chi 128
CAPS_SHAPES = [(256, 128, 128), (64, 256, 64), (8, 8, 4), (8, 16, 4), (32, 8, 8),
               (128, 32, 32), (16, 64, 16)]


@pytest.mark.parametrize("m,k,nc", CAPS_SHAPES)
@pytest.mark.parametrize("pair", [False, True])
def test_split_at_caps_shapes(dev, m, k, nc, pair):
    """K1 at the brick caps' rectangular shapes (below one panel at the
    chain's ends), single-column and pair, against its plain version."""
    rng = np.random.default_rng(m + k + nc)
    th = torch.from_numpy(_input(rng, "full", 6, m, k)).to(dev)
    v0 = start_block(m, nc, torch.complex64, dev)
    qk, rk = split.subspace_factor_cuda(th, v0, 2, pair)
    qp, rp = split.subspace_factor_plain(th, v0, 2, pair)
    torch.cuda.synchronize()
    assert (qk @ rk - qp @ rp).abs().max().item() <= TOL
    s2k = torch.sort(rk.abs().pow(2).sum(2), 1).values
    s2p = torch.sort(rp.abs().pow(2).sum(2), 1).values
    assert (s2k - s2p).abs().max().item() <= TOL * s2p.max().item()


def test_caps_brick_gram_on_card_matches_cpu(dev):
    """The brick engine with caps and the pair step on the card (K5 on the
    square bucket, K1 on the rest, both from the pair libraries) against the
    same build on the CPU."""
    nq = 10
    X = np.random.default_rng(6).uniform(0.0, 2.0, size=(4, nq))
    ans = KernelStateAnsatz(nq, 1, 1.0, entanglement_graph(nq, 2), routing="brick")
    cfg = SimConfig(chi=16, svd_method="subspace", fused_split=True, fused_gate=True,
                    brick_struct_caps=True, mgs_pair=True)
    _build.reset_counters()
    K_gpu = build_kernel_matrix(ans, X, cfg=cfg, sim_batch=4, tile=4, device="cuda")
    assert _build.PAIR_LAUNCHES["brick_split"] > 0 and _build.PAIR_LAUNCHES["split"] > 0
    assert _build.PAIR_LAUNCHES == _build.LAUNCHES
    assert sum(_build.PLAIN_ON_CUDA.values()) == 0
    K_cpu = build_kernel_matrix(ans, X, cfg=cfg, sim_batch=4, tile=4, device="cpu")
    np.testing.assert_allclose(K_gpu, K_cpu, atol=3e-5)


def test_ring_world_size_one_nccl(dev):
    """The multi-device ring at world size 1 on the card (one rank on
    ``cuda:0`` over NCCL, ``parallel/mesh.launch``): symmetric stepwise and
    fused and rectangular, through K1 and K2, against the single-device Gram
    on the card (2e-6: the ring contracts site by site, the single-device
    tiles two sites a step)."""
    from qml_cutensornet_tpu_torch.parallel import dryrun, mesh
    from qml_cutensornet_tpu_torch.parallel import gram as pgram

    nq = 8
    X = np.random.default_rng(3).uniform(0.0, 2.0, size=(11, nq))
    Y = X[:5] + 0.25
    ans = KernelStateAnsatz(nq, 1, 1.0, entanglement_graph(nq, 2))
    cfg = SimConfig(chi=16, tile_block=2, svd_method="subspace", fused_split=True)
    build = pgram.build_kernel_matrix_sharded
    calls = [(build, (ans, X), dict(cfg=cfg, mesh=dryrun.MESH, sim_batch=4), {}),
             (build, (ans, X), dict(cfg=cfg, mesh=dryrun.MESH, sim_batch=4),
              {"QMLTPU_RING": "fused"}),
             (build, (ans, X), dict(Y=Y, cfg=cfg, mesh=dryrun.MESH, sim_batch=4), {})]
    sym, fused, rect = mesh.launch(dryrun.run_calls, 1, "cuda", "cuda", calls, timeout=600)
    assert sym["launches"]["split"] > 0 and sym["launches"]["orth_r"] > 0
    assert sym["peak_bytes"] > 0
    K = build_kernel_matrix(ans, X, cfg=cfg, sim_batch=4, tile=4, device="cuda")
    K_xy = build_kernel_matrix(ans, X, Y=Y, cfg=cfg, sim_batch=4, tile=4, device="cuda")
    np.testing.assert_allclose(sym["out"], K, atol=2e-6)
    np.testing.assert_allclose(fused["out"], sym["out"], atol=1e-7)
    np.testing.assert_allclose(rect["out"], K_xy, atol=2e-6)


def test_site_sharded_world_size_one_nccl(dev, monkeypatch):
    """The site-sharded brick engine on the card: one rank on ``cuda:0``
    over NCCL (``parallel/mesh.launch``), through K5 (and K1 on the chi-8
    stage): the gathered MPS against the whole chain in the rank's process
    (bond dims equal, fidelity rtol 1e-6, tensors 2e-6: the same kernel per
    pair), the relay against the tile scan of the whole chain's states on
    the card (2e-6); and ``QMLTPU_SHARD_MPS=all`` outside a process group
    (a mesh of one, from the CLI's ``engine_kwargs``) through
    ``build_kernel_matrix`` against the whole chain's Gram (1e-6)."""
    from qml_cutensornet_tpu_torch.cli import _pipeline
    from qml_cutensornet_tpu_torch.models.simulate import make_brick_simulator, tile_overlaps_sq
    from qml_cutensornet_tpu_torch.parallel import dryrun, mesh

    nq = 10
    X = np.random.default_rng(7).uniform(0.0, 2.0, size=(5, nq))
    ans = KernelStateAnsatz(nq, 2, 1.0, entanglement_graph(nq, 2), routing="brick")
    cfg = SimConfig(chi=16, svd_method="subspace", fused_split=True, fused_gate=True)
    calls = [(dryrun.compare_site_sharded, (ans, X, cfg, "cuda"), {}, {}),
             (dryrun.relay_full_and_symmetric, (ans, X, cfg),
              dict(mesh=dryrun.MESH, tile=2), {})]
    cmp, relay = mesh.launch(dryrun.run_calls, 1, "cuda", "cuda", calls, timeout=600)
    assert cmp["launches"]["brick_split"] > 0 and cmp["launches"]["split"] > 0
    sharded_launches = cmp["out"]["launches"]["sharded"]
    assert sharded_launches["brick_split"] > 0 and sharded_launches["split"] > 0
    assert cmp["out"]["bond_dims_equal"] and cmp["out"]["fid_rtol"] <= 1e-6
    assert cmp["out"]["tensor_err"] <= 2e-6
    whole = make_brick_simulator(ans.schedule, cfg, dev)(X).tensors
    K_tiles = tile_overlaps_sq(whole, whole).cpu().numpy()
    np.testing.assert_allclose(relay["out"]["full"], K_tiles, atol=2e-6)
    np.testing.assert_allclose(relay["out"]["sym"], relay["out"]["full"], atol=2e-6)
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    K_whole = build_kernel_matrix(ans, X, cfg=cfg, sim_batch=5, tile=5, device="cuda")
    monkeypatch.setenv("QMLTPU_SHARD_MPS", "all")
    monkeypatch.setenv("QMLTPU_ROUTING", "brick")
    monkeypatch.setenv("QMLTPU_DEVICE", "cuda")
    site_mesh = _pipeline.engine_kwargs()["site_mesh"]
    _build.reset_counters()
    K = build_kernel_matrix(ans, X, cfg=cfg, sim_batch=5, tile=5, device="cuda",
                            site_mesh=site_mesh)
    assert _build.LAUNCHES["brick_split"] > 0 and sum(_build.PLAIN_ON_CUDA.values()) == 0
    np.testing.assert_allclose(K, K_whole, atol=1e-6)


@pytest.mark.parametrize("rect", [False, True], ids=["symmetric", "rectangular"])
def test_host_resident_states_on_card(dev, monkeypatch, capsys, rect):
    """The large-chi memory path on the card: 16 qubits at chi 256 (the
    blocked route, K3 panels), the states host-resident
    (``QMLTPU_STATES_DEVICE_BYTES=0``: one trimmed upload a tile, and the
    rectangular case's norms in uploaded chunks) against device-resident
    (the default); the Grams within 1e-7 (the same kernels on the same
    inputs; a tile trimmed to its own bucket runs its products at another
    shape), the regime each build reports, no plain version on the card."""
    rng = np.random.default_rng(16)
    X = rng.uniform(0.0, 2.0, size=(10, 16))
    Y = rng.uniform(0.0, 2.0, size=(4, 16)) if rect else None
    ans = KernelStateAnsatz(16, 2, 1.0, entanglement_graph(16, 6))
    cfg = SimConfig(chi=256, oversample=16, tile_block=1, svd_method="subspace",
                    fused_split=True)
    out = {}
    for path, limit in (("device", None), ("host", "0")):
        if limit is None:
            monkeypatch.delenv("QMLTPU_STATES_DEVICE_BYTES", raising=False)
        else:
            monkeypatch.setenv("QMLTPU_STATES_DEVICE_BYTES", limit)
        _build.reset_counters()
        out[path] = build_kernel_matrix(ans, X, Y, cfg=cfg, sim_batch=4, tile=4, device="cuda",
                                        loglevel=20)
        assert f"States {path}-resident" in capsys.readouterr().out
        assert _build.LAUNCHES["orth"] > 0 and sum(_build.PLAIN_ON_CUDA.values()) == 0
    assert out["host"].shape == ((4, 10) if rect else (10, 10))
    assert np.abs(out["host"] - out["device"]).max() <= 1e-7


# K7: [B, M, N, K] and op at the main paths' shapes (the headline tile's two
# products of a site block, the chi-64 power products), ragged edges, a
# broadcast start block and one element.
CGEMM_SHAPES = [
    (32, 2048, 256, 64, "n"), (32, 64, 2048, 256, "h"),
    (32, 128, 64, 128, "h"), (32, 128, 64, 128, "n"),
    (3, 17, 33, 70, "n"), (3, 17, 33, 70, "h"), (2, 65, 130, 1, "h"), (1, 1, 1, 1, "n"),
]


def _cgemm_operands(rng, B, M, N, K, op, dev):
    def c(*shape):
        x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(x.astype(np.complex64)).to(dev)

    return (c(B, K, M) if op == "h" else c(B, M, K)), c(B, K, N)


@pytest.mark.parametrize("n_passes", [3, 1])
@pytest.mark.parametrize("B,M,N,K,op", CGEMM_SHAPES)
def test_cgemm_kernel_matches_plain(dev, B, M, N, K, op, n_passes):
    """K7 against its plain version on the card: elementwise within both
    f32 sums' worst case, ``2 (2 K P + 2) 2^-24`` of ``|op(a)| |b|`` (they
    differ only in summation order), and within the class's bound of the
    exact product (``lowp.rel_bound``); two launches bit-equal."""
    a, b = _cgemm_operands(np.random.default_rng(M + N + K), B, M, N, K, op, dev)
    before = _build.LAUNCHES["cgemm"]
    got, again = lowp.cgemm(a, b, n_passes, op), lowp.cgemm(a, b, n_passes, op)
    assert _build.LAUNCHES["cgemm"] == before + 2
    plain = lowp.cgemm_plain(a, b, n_passes, op)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and got.shape == (B, M, N)
    a64 = (a.mH if op == "h" else a).to(torch.complex128)
    scale = a64.abs() @ b.to(torch.complex128).abs()
    assert ((got - plain).abs() / scale).max().item() <= 2 * (2 * K * n_passes + 2) * 2.0**-24
    exact = a64 @ b.to(torch.complex128)
    assert ((got - exact).abs() / scale).max().item() <= lowp.rel_bound(n_passes, K)


def test_cgemm_strides(dev):
    """A broadcast operand (batch stride 0, the power step's start block), a
    sliced one (a site of a state batch) and strided rows (the tile step's
    view of a transposed carry) equal the dense copies."""
    a, b = _cgemm_operands(np.random.default_rng(1), 4, 16, 24, 40, "h", dev)
    bcast = b[:1].expand(4, 40, 24)
    np.testing.assert_array_equal(lowp.cgemm(a, bcast, 3, "h").cpu().numpy(),
                                  lowp.cgemm(a, bcast.contiguous(), 3, "h").cpu().numpy())
    stacked = torch.stack([a, a], 1)  # [4, 2, 40, 16]: a slice has batch stride 2 x 40 x 16
    np.testing.assert_array_equal(lowp.cgemm(stacked[:, 1], b, 1, "h").cpu().numpy(),
                                  lowp.cgemm(a, b, 1, "h").cpu().numpy())
    carry, _ = _cgemm_operands(np.random.default_rng(3), 4 * 4, 8, 8, 8, "n", dev)
    mx = carry.reshape(4, 8, 4, 8).transpose(1, 2).transpose(0, 1).reshape(4, 32, 8)
    assert mx.stride() == (8, 32, 1)
    np.testing.assert_array_equal(lowp.cgemm(mx, b[:, :8], 3).cpu().numpy(),
                                  lowp.cgemm(mx.contiguous(), b[:, :8], 3).cpu().numpy())


def _check_cgemm(a, b, n_passes, op="n", op_b="n"):
    """K7 on ``a``, ``b`` against its plain version (both f32 sums' worst
    case, ``2 (2 K P + 2) 2^-24`` of ``|op(a)| |op_b(b)|``) and the exact
    product (``lowp.rel_bound``); one launch a call, two launches
    bit-equal. Returns the kernel's product."""
    before = _build.LAUNCHES["cgemm"]
    got, again = lowp.cgemm(a, b, n_passes, op, op_b), lowp.cgemm(a, b, n_passes, op, op_b)
    assert _build.LAUNCHES["cgemm"] == before + 2
    plain = lowp.cgemm_plain(a, b, n_passes, op, op_b)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    a64 = (a.mH if op == "h" else a).to(torch.complex128)
    b64 = (b.mH if op_b == "h" else b).to(torch.complex128)
    K = a64.shape[-1]
    scale = a64.abs() @ b64.abs()
    assert ((got - plain).abs() / scale).max().item() <= 2 * (2 * K * n_passes + 2) * 2.0**-24
    assert ((got - a64 @ b64).abs() / scale).max().item() <= lowp.rel_bound(n_passes, K)
    return got


# K7's plans on each side of every boundary (``csrc/bf16_cgemm.cu``: THIN_K
# up to K 8, before THIN_N up to N 2; LARGE from M and N 64, K 16 and 264
# tiles of 128 x 64, or 64 x 128 where N > M), ragged M, N and K included:
# [B, M, N, K] and the plan.
CGEMM_PLAN_SHAPES = [
    (3, 5, 7, 8, "thin_k"), (3, 5, 7, 9, "small"), (2, 300, 1, 8, "thin_k"),
    (5, 9, 2, 40, "thin_n"), (5, 9, 3, 40, "small"), (5, 70, 1, 9, "thin_n"),
    (264, 64, 64, 16, "large_m"), (263, 64, 64, 16, "small"), (264, 64, 64, 15, "small"),
    (264, 63, 64, 16, "small"), (264, 64, 65, 16, "large_n"),
    (64, 300, 70, 33, "large_m"), (64, 70, 300, 33, "large_n"),
]


@pytest.mark.parametrize("ops", ["nn", "hn", "nh", "hh"])
@pytest.mark.parametrize("B,M,N,K,plan", CGEMM_PLAN_SHAPES)
def test_cgemm_plans(dev, B, M, N, K, plan, ops):
    """Each plan of K7 at the shapes on either side of its boundaries, with
    ``op`` "h" on ``a``, on ``b`` and on both, at three passes and one."""
    op, op_b = ops
    assert lowp.plan(B, M, N, K) == plan
    rng = np.random.default_rng(B + M + N + K)
    a, b = _cgemm_operands(rng, B, M, N, K, op, dev)
    if op_b == "h":
        b = b.mH.resolve_conj().contiguous()
    for n_passes in (3, 1):
        _check_cgemm(a, b, n_passes, op, op_b)


@pytest.mark.parametrize("n_passes", [3, 1])
def test_cgemm_two_level_batch(dev, n_passes):
    """The two-level batch: a gate broadcast over theta's bond index (inner
    stride 0; THIN_K) and a slice of sites of a state batch (an outer
    stride of its own, inner stride > 0; THIN_K and, as ``b`` of a chi-16
    product, SMALL) equal the dense copies to the bit (the plan depends on
    the shape only)."""
    rng = np.random.default_rng(11)

    def c(*shape):
        x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(x.astype(np.complex64)).to(dev)

    u4, theta = c(6, 4, 4), c(6, 16, 4, 16)
    a4, b4 = lowp._batched(u4[:, None], theta, (6, 16))
    assert lowp._layout(a4) == (16, 0, 4) and a4.data_ptr() == u4.data_ptr()
    got = _check_cgemm(a4, b4, n_passes)
    dense = lowp.cgemm(u4[:, None].expand(6, 16, 4, 4).reshape(96, 4, 4).contiguous(),
                       theta.reshape(96, 4, 16), n_passes)
    assert torch.equal(got.reshape(96, 4, 16), dense)
    state = c(3, 7, 16, 2, 16)
    sites = state[:, 1:5]
    a4, b4 = lowp._batched(c(2, 2), sites, (3, 4, 16))
    assert lowp._layout(b4) == (7 * 16 * 32, 32, 16) and b4.data_ptr() == sites.data_ptr()
    got = _check_cgemm(a4, b4, n_passes)
    assert torch.equal(got.reshape(192, 2, 16),
                       lowp.cgemm(a4.reshape(192, 2, 2).contiguous(),
                                  sites.reshape(192, 2, 16), n_passes))
    m = c(3, 4, 32, 16)
    a4, b4 = lowp._batched(m, sites.reshape(3, 4, 16, 32), (3, 4))
    assert lowp._layout(b4)[:2] == (7 * 16 * 32, 16 * 32) and lowp.plan(12, 32, 32, 16) == "small"
    got = _check_cgemm(a4, b4, n_passes)
    assert torch.equal(got.reshape(12, 32, 32),
                       lowp.cgemm(m.reshape(12, 32, 16), sites.reshape(12, 16, 32), n_passes))


@pytest.mark.parametrize("B,M,N,K,op", [(65539, 2, 64, 2, "n"), (70000, 9, 2, 20, "h"),
                                        (70000, 2, 16, 16, "n")])
def test_cgemm_batch_past_the_grid(dev, B, M, N, K, op):
    """A batch past 65535 (the Hadamard layer's 65536 matrices and more) on
    THIN_K, THIN_N and SMALL: every matrix computed."""
    a, b = _cgemm_operands(np.random.default_rng(B), B, M, N, K, op, dev)
    if K == 2:
        a = a[:1].expand(B, M, K)  # the Hadamard's batch stride 0
    for n_passes in (3, 1):
        _check_cgemm(a, b, n_passes, op)


def test_cgemm_refusals(dev):
    """complex128, a matrix that is not row-major and dense (a layout no plan
    takes), a lazy conjugate, a bad shape, rank or op, a bad pass count, two
    batch shapes and a CPU operand raise and launch nothing."""
    a, b = _cgemm_operands(np.random.default_rng(2), 2, 8, 8, 8, "n", dev)
    before = dict(_build.LAUNCHES)
    with pytest.raises(TypeError):
        lowp.cgemm_cuda(a.to(torch.complex128), b.to(torch.complex128), 3)
    with pytest.raises(ValueError, match="row-major"):
        lowp.cgemm_cuda(a.mT, b, 3)
    with pytest.raises(ValueError, match="row-major"):
        lowp.cgemm_cuda(a, b.mT, 3, "n", "h")
    with pytest.raises(ValueError, match="lazy conjugate"):
        lowp.cgemm_cuda(a, b.conj(), 3)
    with pytest.raises(ValueError):
        lowp.cgemm_cuda(a, b[:, :5], 3)
    with pytest.raises(ValueError):
        lowp.cgemm_cuda(a, b[:, :, :5], 3, "n", "h")
    with pytest.raises(ValueError):
        lowp.cgemm_cuda(a[None, None], b[None, None], 3)
    with pytest.raises(ValueError):
        lowp.cgemm_cuda(a, b, 3, "t")
    with pytest.raises(ValueError):
        lowp.cgemm_cuda(a.reshape(1, 2, 8, 8), b, 3)
    with pytest.raises(ValueError):
        lowp.cgemm_cuda(a, b, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lowp.cgemm(a, b.cpu(), 3)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("knob", ["tile_precision", "power_precision"])
@pytest.mark.parametrize("precision", ["high", "bfloat16"])
def test_reduced_precision_slice_on_card_matches_cpu(dev, knob, precision):
    """The Gram slice (8 qubits, chi 16, fused split) at a reduced tile or
    power precision on the card against the CPU (3e-5): K7 launched, no
    plain version on the card; the power precision keeps K1 off (K3 takes
    the unfused chain), the tile precision leaves the simulation as it is."""
    nq = 8
    X = np.random.default_rng(2).uniform(0.0, 2.0, size=(6, nq))
    ans = KernelStateAnsatz(nq, 1, 1.0, entanglement_graph(nq, 2))
    cfg = SimConfig(chi=16, tile_block=2, svd_method="subspace", fused_split=True,
                    **{knob: precision})
    _build.reset_counters()
    K_gpu = build_kernel_matrix(ans, X, cfg=cfg, sim_batch=4, tile=4, device="cuda")
    assert _build.LAUNCHES["cgemm"] > 0 and sum(_build.PLAIN_ON_CUDA.values()) == 0
    if knob == "power_precision":
        assert _build.LAUNCHES["split"] == 0 and _build.LAUNCHES["orth"] > 0
    else:
        assert _build.LAUNCHES["split"] > 0 and _build.LAUNCHES["orth"] == 0
    K_cpu = build_kernel_matrix(ans, X, cfg=cfg, sim_batch=4, tile=4, device="cpu")
    np.testing.assert_allclose(K_gpu, K_cpu, atol=3e-5)
    np.testing.assert_allclose(np.diag(K_gpu), 1.0, atol=1e-12)


def _ambient_operands(rng, dev):
    """K7's operands at the engine's shapes on the ambient route (headline
    chi 64, batch 32), as the engine views them: ``(name, a, b, op,
    op_b)``."""
    def c(*shape):
        x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(x.astype(np.complex64)).to(dev)

    chi, B = 64, 32
    state = c(B, 32, chi, 2, chi)  # a state batch of 32 sites; a site is a view
    site, right = state[:, 1], state[:, 2]
    r = c(B, chi, chi)
    theta = c(B, 2 * chi, 2 * chi)
    v0 = c(2 * chi, chi).expand(B, 2 * chi, chi)  # the start block, batch stride 0
    panel = c(B, 512, 32)  # the scanned panel step at chi 256: a 31-column prefix
    return [
        ("theta build", site.reshape(B, 2 * chi, chi), right.reshape(B, chi, 2 * chi), "n", "n"),
        ("gate, K = 4", c(B, 4, 4)[:, None], theta.reshape(B, chi, 4, chi), "n", "n"),
        ("move right, r b", r, right.reshape(B, chi, 2 * chi), "n", "n"),
        ("move left, a r^H", site.reshape(B, 2 * chi, chi), r, "n", "h"),
        ("r = q^H v", site.reshape(B, 2 * chi, chi), site.reshape(B, 2 * chi, chi), "h", "n"),
        ("power theta^H v0", theta, v0, "h", "n"),
        ("vdot, m t", r, right.reshape(B, chi, 2 * chi), "n", "n"),
        ("single column, q^H x", panel[:, :, :31], panel[:, :, 31:], "h", "n"),
        ("Hadamard, batch stride 0", c(2, 2), state, "n", "n"),
    ]


@pytest.mark.parametrize("precision", ["high", "bfloat16"])
def test_ambient_products_at_engine_shapes(dev, monkeypatch, precision):
    """``lowp.matmul`` on the engine's views at a reduced ambient class:
    K7 against its plain version on the same card inputs (both f32 sums'
    worst case, ``2 (2 K P + 2) 2^-24`` of ``|op(a)| |op_b(b)|``) and
    against the exact product (``lowp.rel_bound``), two launches bit-equal,
    one launch a product (the Hadamard's batch of 65536 matrices past the
    65535 of a grid dimension)."""
    P = lowp.passes(precision)
    for name, a, b, op, op_b in _ambient_operands(np.random.default_rng(7), dev):
        before = _build.LAUNCHES["cgemm"]
        got, again = (lowp.matmul(a, b, precision, op, op_b),
                      lowp.matmul(a, b, precision, op, op_b))
        assert _build.LAUNCHES["cgemm"] == before + 2, name
        with monkeypatch.context() as m:
            m.setattr(lowp, "cgemm", lowp.cgemm_plain)
            plain = lowp.matmul(a, b, precision, op, op_b)
        torch.cuda.synchronize()
        assert torch.equal(got, again), name
        a64 = (a.mH if op == "h" else a).to(torch.complex128)
        b64 = (b.mH if op_b == "h" else b).to(torch.complex128)
        scale = a64.abs() @ b64.abs()
        K = a64.shape[-1]
        assert ((got - plain).abs() / scale).max().item() <= 2 * (2 * K * P + 2) * 2.0**-24, name
        assert ((got - a64 @ b64).abs() / scale).max().item() <= lowp.rel_bound(P, K), name


@pytest.mark.parametrize("routing", ["tracked", "brick"])
@pytest.mark.parametrize("precision", ["high", "bfloat16"])
def test_ambient_slice_on_card_matches_cpu(dev, routing, precision):
    """The Gram slice (8 qubits, chi 16, the CLI's kernel settings) at a
    reduced ambient class on the card against the CPU: K1, K4 and K5 never
    launch, K3 (the unfused split) and K7 do, K2 on the tracked center
    moves; no plain version on the card. Kernel and plain version are two
    roundings of one class: within the routes' bar of 3e-5 at three passes,
    and 4 class units (``2^-8``, as the CPU test holds the port to the
    reference) at one."""
    nq = 8
    X = np.random.default_rng(2).uniform(0.0, 2.0, size=(6, nq))
    ans = KernelStateAnsatz(nq, 2, 1.0, entanglement_graph(nq, 2), routing=routing)
    cfg = SimConfig(chi=16, tile_block=2, svd_method="subspace", fused_split=True,
                    fused_gate=True, matmul_precision=precision)
    _build.reset_counters()
    K_gpu = build_kernel_matrix(ans, X, cfg=cfg, sim_batch=8, device="cuda")
    launches = dict(_build.LAUNCHES)
    assert launches["split"] == launches["gate_split"] == launches["brick_split"] == 0, launches
    assert launches["orth"] > 0 and launches["cgemm"] > 0, launches
    assert (launches["orth_r"] > 0) == (routing == "tracked"), launches
    assert sum(_build.PLAIN_ON_CUDA.values()) == 0
    K_cpu = build_kernel_matrix(ans, X, cfg=cfg, sim_batch=8, device="cpu")
    np.testing.assert_allclose(K_gpu, K_cpu, atol=3e-5 if precision == "high" else 4 * 2.0**-8)
    np.testing.assert_allclose(np.diag(K_gpu), 1.0, atol=1e-12)
