"""The reduced power and tile precisions (``SimConfig.power_precision``,
``SimConfig.tile_precision``) of the port on the CPU: the plain version of
kernel K7 (``ops/lowp.py``), the power step, the Gram tiles and norms, the
CLI slice and the ring, against the JAX reference.

JAX's CPU dots ignore their precision, so the reference computes full f32
at every string here; the port computes the TPU's classes (three bf16 passes
for "high", one for "bfloat16" / "default"). Tolerances come from each
class's unit, the relative precision of its split: ``U[3] = 2^-16`` at
three passes and ``U[1] = 2^-8`` at one (``lowp.rel_bound``).

- the class of each string against ``jax.lax.Precision``;
- the plain version against a numpy f64 emulation of the same split (each
  f32 rounded to nearest even into bf16, the low part likewise), to 1e-6 of
  ``||A|| ||B||`` (only the f32 sums differ); against the exact f64 product
  within ``lowp.rel_bound`` elementwise, the one-pass error well above the
  three-pass one; both ``op``s, ragged m, n and k; complex128 at full f64
  (bit-equal to "highest" on the power step, the tiles and the norms); the
  refusals of the kernel's wrapper;
- ``_split_subspace`` at power "high" and "bfloat16" against the
  reference's at the same config (projector, sorted s2 and kept_fraction
  within ``8 x U``, mask equal), both on the unfused route, and the
  eligibility of K1, K4 and K5;
- ``tile_overlaps_sq`` and ``state_norms_sq`` at "high" and "default", site
  block 1 and 2, against the reference's and the port's "highest" (``4 x
  n_sites x U``);
- ``cli.main_no_test`` with both knobs on "high" (6 qubits, chi 8, 8 train
  points) against the reference's at the same environment (``16 x U[3]``),
  symmetric with a unit diagonal;
- the ring at world size 2 over gloo with tile "high" against the
  single-device build at the same config (2e-6, the ring's bar)."""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qml_cutensornet_tpu.cli import main_no_test as ref_main_no_test
from qml_cutensornet_tpu.config import SimConfig as RefConfig
from qml_cutensornet_tpu.models import simulate as ref_sim
from qml_cutensornet_tpu.ops import pallas_split as ref_pallas_split
from qml_cutensornet_tpu.ops import svd as jsvd
from qml_cutensornet_tpu.ops.cpx import Cpx
from qml_cutensornet_tpu_torch.cli import main_no_test
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models import simulate
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix
from qml_cutensornet_tpu_torch.ops import _build, lowp, split, svd
from qml_cutensornet_tpu_torch.parallel import dryrun, mesh
from qml_cutensornet_tpu_torch.parallel import gram as pgram
from qml_cutensornet_tpu_torch.utils.data import preprocess_elliptic

ROOT = pathlib.Path(__file__).resolve().parents[1]
U = {3: 2.0**-16, 1: 2.0**-8}
REDUCED = {"high": 3, "bfloat16": 1, "default": 1}


def _crandn(rng, *shape, dtype=np.complex64):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


# ------------------------------------------------------------ the product

def test_classes_match_jax():
    want = {jax.lax.Precision.HIGHEST: 0, jax.lax.Precision.HIGH: 3,
            jax.lax.Precision.DEFAULT: 1}
    for s in ("highest", "float32", "high", "bfloat16_3x", "tensorfloat32", "bfloat16",
              "default"):
        assert lowp.passes(s) == want[jax.lax.Precision(s)], s
        assert lowp.reduced_passes(s, torch.complex64) == lowp.passes(s)
        assert lowp.reduced_passes(s, torch.complex128) == 0
        RefConfig(power_precision=s, tile_precision=s)  # the reference takes every string
    assert len(lowp.PASSES) == 7
    with pytest.raises(ValueError):
        lowp.passes("inherit")


def _bf16(x):
    """numpy float32 -> the nearest bfloat16 (ties to even), as float64."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def _emulate(a, b, n_passes, op):
    """numpy f64 emulation of the split products (the 4M form)."""
    a = a.conj().transpose(0, 2, 1) if op == "h" else a

    def parts(x):
        x = np.asarray(x, dtype=np.float32)
        hi = _bf16(x)
        return (hi, _bf16((x - hi).astype(np.float32)))

    def prod(x, y):
        (xh, xl), (yh, yl) = parts(x), parts(y)
        out = xh @ yh
        return out + xh @ yl + xl @ yh if n_passes == 3 else out

    re = prod(a.real, b.real) - prod(a.imag, b.imag)
    im = prod(a.real, b.imag) + prod(a.imag, b.real)
    return re + 1j * im


SHAPES = [(1, 16, 8, 16), (2, 17, 33, 70), (3, 64, 5, 1), (2, 1, 9, 130)]  # B, M, N, K


@pytest.mark.parametrize("op", lowp.OPS)
@pytest.mark.parametrize("n_passes", [3, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_emulation_and_bound(op, n_passes, shape):
    B, M, N, K = shape
    rng = np.random.default_rng(M * N + K)
    a = _crandn(rng, B, K, M) if op == "h" else _crandn(rng, B, M, K)
    b = _crandn(rng, B, K, N)
    got = lowp.cgemm(torch.from_numpy(a), torch.from_numpy(b), n_passes, op).numpy()
    assert got.shape == (B, M, N) and got.dtype == np.complex64
    emu = _emulate(a, b, n_passes, op)
    norm = np.linalg.norm(a) * np.linalg.norm(b)
    assert np.abs(got - emu).max() <= 1e-6 * norm
    a64 = a.astype(np.complex128)
    a64 = a64.conj().transpose(0, 2, 1) if op == "h" else a64
    exact = a64 @ b.astype(np.complex128)
    scale = np.abs(a64) @ np.abs(b.astype(np.complex128))
    err = np.abs(got - exact) / scale
    assert err.max() <= lowp.rel_bound(n_passes, K)
    if n_passes == 1 and K >= 16:  # one pass keeps 8 bits: far above three passes
        three = lowp.cgemm(torch.from_numpy(a), torch.from_numpy(b), 3, op).numpy()
        assert err.max() > 30 * (np.abs(three - exact) / scale).max()


def test_plain_is_complex64_only_and_kernel_refuses():
    a = torch.zeros((2, 4, 3), dtype=torch.complex64)
    b = torch.zeros((2, 3, 5), dtype=torch.complex64)
    with pytest.raises(TypeError):
        lowp.cgemm(a.to(torch.complex128), b.to(torch.complex128), 3)
    with pytest.raises(ValueError):
        lowp.cgemm(a, b, 2)
    with pytest.raises(ValueError):
        lowp.cgemm(a, b, 3, "h")  # op(a) is 3 x 4
    with pytest.raises(ValueError):
        lowp.cgemm(a, b[:1], 3)  # batch
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lowp.cgemm_cuda(a, b, 3)  # a CPU tensor never reaches the kernel
    assert _build.LAUNCHES == before and "cgemm" in _build.KERNELS
    assert "cgemm" not in _build.PAIR_KERNELS and "bf16_cgemm.cu" in _build.SINGLE_BUILD
    # a broadcast batch (stride 0), a sliced batch, strided rows (the tile
    # step's view of a transposed carry) and a two-level batch with a
    # broadcast inner level (a gate over theta's bond index) are layouts the
    # kernel takes, as (outer, inner, row) strides; a transposed matrix is
    # not, on either device
    assert lowp._layout(a[:1].expand(4, 4, 3)) == (0, 0, 3)
    assert lowp._layout(torch.zeros((3, 2, 4, 3), dtype=torch.complex64)[:, 1]) == (24, 0, 3)
    carry = torch.zeros((4, 8, 4, 8), dtype=torch.complex64).transpose(1, 2)  # [y, x, a, b]
    assert lowp._layout(carry.transpose(0, 1).reshape(4, 32, 8)) == (8, 0, 32)
    gate = torch.zeros((3, 4, 4), dtype=torch.complex64)[:, None].expand(3, 5, 4, 4)
    assert lowp._layout(gate) == (16, 0, 4)
    with pytest.raises(ValueError, match="row-major"):
        lowp._layout(b.mT)
    with pytest.raises(ValueError, match="row-major"):
        lowp.cgemm(b.mT.contiguous().mT, b.mT.contiguous(), 3)


@pytest.mark.parametrize("n_passes", [3, 1])
@pytest.mark.parametrize("op", lowp.OPS)
def test_plain_op_b_matches_dense_and_emulation(op, n_passes):
    """``op_b`` "h" (``b`` stored ``[N, K]``, its conjugate transpose in the
    product, the layout of ``r^H`` and ``V^H``): the plain version gives the
    bits of the same call on the dense copy ``b^H``, and the numpy emulation
    within 1e-6 of ``|a||b|``; the exact product within the class's bound."""
    B, M, N, K = 2, 17, 33, 70
    rng = np.random.default_rng(N + K + n_passes)
    a = _crandn(rng, B, K, M) if op == "h" else _crandn(rng, B, M, K)
    b = _crandn(rng, B, N, K)
    bh = b.conj().transpose(0, 2, 1)
    got = lowp.cgemm(torch.from_numpy(a), torch.from_numpy(b), n_passes, op, "h").numpy()
    dense = lowp.cgemm(torch.from_numpy(a), torch.from_numpy(bh.copy()), n_passes, op).numpy()
    np.testing.assert_array_equal(got, dense)
    assert np.abs(got - _emulate(a, bh, n_passes, op)).max() <= (
        1e-6 * np.linalg.norm(a) * np.linalg.norm(b))
    a64 = a.astype(np.complex128)
    a64 = a64.conj().transpose(0, 2, 1) if op == "h" else a64
    scale = np.abs(a64) @ np.abs(bh.astype(np.complex128))
    err = np.abs(got - a64 @ bh.astype(np.complex128)) / scale
    assert err.max() <= lowp.rel_bound(n_passes, K)


@pytest.mark.parametrize("n_passes", [3, 1])
def test_plain_two_level_batch_matches_dense(n_passes):
    """K7's two-level batch, as ``lowp.matmul`` lays it out: a gate broadcast
    over theta's bond index (inner stride 0), a slice of sites of a state
    batch (an outer stride of its own, inner stride > 0) and one matrix over
    the whole batch (strides 0) are views of the callers' tensors, and give
    the bits of the dense copies."""
    rng = np.random.default_rng(5 + n_passes)
    u4 = torch.from_numpy(_crandn(rng, 3, 4, 4))
    theta = torch.from_numpy(_crandn(rng, 3, 6, 4, 6))
    a4, b4 = lowp._batched(u4[:, None], theta, (3, 6))
    assert a4.shape == (3, 6, 4, 4) and lowp._layout(a4) == (16, 0, 4)
    assert lowp._layout(b4) == (144, 24, 6)
    assert a4.data_ptr() == u4.data_ptr() and b4.data_ptr() == theta.data_ptr()
    dense = lowp.cgemm(u4[:, None].expand(3, 6, 4, 4).reshape(18, 4, 4).contiguous(),
                       theta.reshape(18, 4, 6), n_passes)
    np.testing.assert_array_equal(lowp.cgemm(a4, b4, n_passes).reshape(18, 4, 6).numpy(),
                                  dense.numpy())
    state = torch.from_numpy(_crandn(rng, 2, 7, 6, 2, 6))
    sites, u2 = state[:, 1:5], torch.from_numpy(_crandn(rng, 2, 2))
    a4, b4 = lowp._batched(u2, sites, (2, 4, 6))
    assert lowp._layout(a4) == (0, 0, 2) and lowp._layout(b4) == (7 * 72, 12, 6)
    assert a4.data_ptr() == u2.data_ptr() and b4.data_ptr() == sites.data_ptr()
    dense = lowp.cgemm(u2.expand(48, 2, 2).contiguous(), sites.reshape(48, 2, 6), n_passes)
    np.testing.assert_array_equal(lowp.cgemm(a4, b4, n_passes).reshape(48, 2, 6).numpy(),
                                  dense.numpy())
    np.testing.assert_array_equal(lowp.matmul(u2, sites, ("high", "bfloat16")[n_passes == 1])
                                  .reshape(48, 2, 6).numpy(), dense.numpy())


# ------------------------------------------------------------ the power step

B, M, K, KEEP = 3, 16, 12, 8
SV = np.concatenate([np.geomspace(1.0, 0.3, 8), np.geomspace(0.03, 0.003, 4)])


def _theta(seed, dtype=np.complex64):
    """``U diag(SV) W^H`` with random isometries: a gap of 10x at KEEP."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(_crandn(rng, B, M, K, dtype=complex))
    w, _ = np.linalg.qr(_crandn(rng, B, K, K, dtype=complex))
    return ((u * SV) @ w.conj().transpose(0, 2, 1)).astype(dtype)


def _ref_split(theta, rcfg):
    out = jax.vmap(lambda re, im: jsvd._split_subspace(Cpx(re, im), rcfg, KEEP))(
        jnp.asarray(theta.real), jnp.asarray(theta.imag))
    to = lambda c: np.asarray(c.re) + 1j * np.asarray(c.im)
    return to(out[0]), to(out[1]), np.asarray(out[2]), np.asarray(out[3])


@pytest.mark.parametrize("precision", ["high", "bfloat16"])
def test_power_step_matches_reference(monkeypatch, precision):
    theta = _theta(11)
    rcfg = RefConfig(chi=KEEP, svd_method="subspace", precision="f32", fused_split=True,
                     subspace_iters=2, power_precision=precision)
    cfg = SimConfig.from_reference(dataclasses.asdict(rcfg))

    def refuse(*args, **kwargs):
        raise AssertionError("a reduced power precision took the fused split")

    monkeypatch.setattr(split, "subspace_factor", refuse)
    monkeypatch.setattr(ref_pallas_split, "subspace_factor", refuse)
    left, right, kf, rank = (t.numpy() for t in svd._split_subspace(torch.from_numpy(theta),
                                                                    cfg, KEEP))
    rl, rr, rkf, rrank = _ref_split(theta, rcfg)
    tol = 8 * U[REDUCED[precision]]
    proj = left @ left.conj().transpose(0, 2, 1)
    np.testing.assert_allclose(proj, rl @ rl.conj().transpose(0, 2, 1), atol=tol)
    s2 = np.sort((np.abs(right) ** 2).sum(2), 1)
    np.testing.assert_allclose(s2, np.sort((np.abs(rr) ** 2).sum(2), 1), atol=tol)
    np.testing.assert_array_equal(np.abs(left).sum(1) > 0, np.abs(rl).sum(1) > 0)  # the mask
    np.testing.assert_array_equal(rank, rrank)
    np.testing.assert_allclose(kf, rkf, atol=tol)
    # the reduced class shows: the port's power products are not f32's
    full = svd._split_subspace(torch.from_numpy(theta),
                               dataclasses.replace(cfg, power_precision="highest"), KEEP)
    assert not torch.equal(full[0], torch.from_numpy(left))


def test_power_precision_keeps_the_fused_kernels_off():
    base = dict(svd_method="subspace", fused_split=True, fused_gate=True)
    for precision in ("inherit", "highest", "high", "bfloat16"):
        cfg = SimConfig(chi=16, power_precision=precision, **base)
        rcfg = RefConfig(chi=16, power_precision=precision, fused_interpret=True, **base)
        on = precision == "inherit"
        assert svd._kernel_precision(cfg) == on
        assert svd.gate_split_eligible(cfg, 16) == jsvd.gate_split_eligible(rcfg, 16) == on
        assert (svd.brick_split_eligible(cfg, 16, 16, 16)
                == jsvd.brick_split_eligible(rcfg, 16, 16, 16) == on)


def test_complex128_power_step_is_full_f64():
    theta = torch.from_numpy(_theta(5, np.complex128))
    cfg = SimConfig(chi=KEEP, svd_method="subspace", precision="f64", power_precision="highest")
    full = svd._split_subspace(theta, cfg, KEEP)
    for precision in ("high", "bfloat16"):
        low = svd._split_subspace(theta, dataclasses.replace(cfg, power_precision=precision),
                                  KEEP)
        assert all(torch.equal(x, y) for x, y in zip(full, low))


# ------------------------------------------------------------ the tiles

NQ = 6


def _states(n, seed, dtype=np.complex64):
    """Simulated states (6 qubits, chi 8): normalized, overlaps in [0, 1]."""
    ans = KernelStateAnsatz(NQ, 1, 1.0, entanglement_graph(NQ, 1))
    cfg = SimConfig(chi=8, precision="f32" if dtype == np.complex64 else "f64",
                    svd_method="subspace", fused_split=True)
    x = np.random.default_rng(seed).uniform(0.0, 2.0, size=(n, NQ))
    sim = simulate.make_chunked_simulator(ans.schedule, cfg, torch.device("cpu"))
    return sim(x).tensors


@pytest.fixture(scope="module")
def tile_states():
    return _states(5, 1), _states(4, 2)


def _ref_cpx(t):
    t = t.numpy()
    return Cpx(jnp.asarray(t.real), jnp.asarray(t.imag))


@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("site_block", [1, 2])
def test_tiles_and_norms_match_reference(tile_states, precision, site_block):
    ay, ax = tile_states
    tol = 4 * NQ * U[REDUCED[precision]]
    got = simulate.tile_overlaps_sq(ay, ax, precision, site_block).numpy()
    ref = np.asarray(ref_sim.tile_overlaps_sq(_ref_cpx(ay), _ref_cpx(ax), precision=precision,
                                              site_block=site_block))
    full = simulate.tile_overlaps_sq(ay, ax, "highest", site_block).numpy()
    assert got.shape == (5, 4)
    np.testing.assert_allclose(got, ref, atol=tol)
    np.testing.assert_allclose(got, full, atol=tol)
    assert not np.array_equal(got, full)  # the class shows
    n2 = simulate.state_norms_sq(ay, precision).numpy()
    np.testing.assert_allclose(
        n2, np.asarray(ref_sim.state_norms_sq(_ref_cpx(ay), precision=precision)), atol=tol)
    np.testing.assert_allclose(n2, simulate.state_norms_sq(ay).numpy(), atol=tol)


def test_complex128_tiles_are_full_f64():
    a = _states(3, 4, np.complex128)
    for site_block in (1, 2):
        full = simulate.tile_overlaps_sq(a, a, "highest", site_block)
        for precision in ("high", "bfloat16"):
            assert torch.equal(simulate.tile_overlaps_sq(a, a, precision, site_block), full)
    assert torch.equal(simulate.state_norms_sq(a, "default"), simulate.state_norms_sq(a))


# ------------------------------------------------------------ the slice

ARGV = ["main", "GPU", str(NQ), "2", "1.0", "2", "5", "5", "1", "v1.csv"]  # 8 train points
TRAIN = f"kernels/train_Nf{NQ}_r2_g1.0_p0.0_nn2_mslinear_Ntr5_s1_v1.npy"


def test_main_no_test_matches_reference(tmp_path, monkeypatch):
    for key, value in {"QMLTPU_DEVICE": "cpu", "QMLTPU_CHI": "8", "QMLTPU_POWER_PRECISION":
                       "high", "QMLTPU_TILE_PRECISION": "high"}.items():
        monkeypatch.setenv(key, value)
    passes, real_plain = [], lowp.cgemm_plain
    monkeypatch.setattr(lowp, "cgemm_plain",
                        lambda a, b, n, op="n", op_b="n": passes.append(n)
                        or real_plain(a, b, n, op, op_b))
    K = {}
    for side, entry in (("port", main_no_test), ("ref", ref_main_no_test)):
        work = tmp_path / side
        (work / "datasets").mkdir(parents=True)
        monkeypatch.chdir(work)
        preprocess_elliptic(str(ROOT / "datasets/elliptic_bitcoin_dataset_v1"), "datasets/v1.csv")
        entry.main(list(ARGV))
        K[side] = np.load(work / TRAIN)
    assert K["port"].shape == (8, 8)
    assert passes and set(passes) == {3}  # the power products and the tiles went through K7's
    np.testing.assert_allclose(K["port"], K["port"].T, atol=1e-6)
    np.testing.assert_allclose(np.diag(K["port"]), 1.0, atol=1e-12)
    np.testing.assert_allclose(K["port"], K["ref"], atol=16 * U[3])


# ------------------------------------------------------------ the ring

def test_ring_world_size_two_at_tile_high(monkeypatch, tmp_path):
    ans = KernelStateAnsatz(5, 2, 0.8, entanglement_graph(5, 2))
    X = np.random.default_rng(0).uniform(0, 2, size=(9, 5))
    cfg = SimConfig(chi=8, precision="f32", svd_method="subspace", tile_precision="high")
    call = (pgram.build_kernel_matrix_sharded, (ans, X), dict(cfg=cfg, mesh=dryrun.MESH), {})
    monkeypatch.chdir(tmp_path)
    ring = [r["out"] for r in mesh.launch(dryrun.run_calls, 2, "cpu", "cpu", [call])][0]
    single = build_kernel_matrix(ans, X, cfg=cfg, device="cpu")
    full = build_kernel_matrix(ans, X, cfg=dataclasses.replace(cfg, tile_precision="highest"),
                               device="cpu")
    assert ring.shape == (9, 9)
    np.testing.assert_allclose(ring, single, atol=2e-6)
    np.testing.assert_allclose(ring, full, atol=4 * 5 * U[3])
    assert np.abs(single - full).max() > 2e-6  # so the ring ran the reduced class
