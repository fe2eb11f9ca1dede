"""The reduced ambient precision (``SimConfig.matmul_precision``) of the port
on the CPU: every product of the engine at the class, through
``ops/lowp.matmul``, against the JAX reference.

The reference runs its simulators under ``jax.default_matmul_precision``;
every XLA dot without a precision of its own then falls to the class. JAX's
CPU dots ignore the class, so the reference computes full f32 here, while
the port computes the TPU's classes (three bf16 passes for "high", one for
"bfloat16"). So the reduced class is pinned three ways: here the port's
plain path against the reference at the same config, within a bound from
the class's unit ``U[3] = 2^-16`` or ``U[1] = 2^-8`` (``lowp.rel_bound``:
a product at three passes is within ``3 U`` of ``|a||b|``, at one pass
within ``2 U``); the products a module makes against the dots the
reference's traced function sends to the class (its jaxpr under the context,
the TPU's kernel routing, Pallas launches excluded); and, on the card, K7
against its plain version (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

- the class of each string, bit for bit on a small tracked slice, complex128
  equal to "highest" at every string;
- the routing: K1's condition, ``gate_split_eligible`` and
  ``brick_split_eligible`` against the reference's for every string and
  knob;
- each module (the Hadamard layers, ``apply_1q``, ``apply_2site``,
  ``move_center`` on K2 and on K3, ``vdot``, the svd and eigh glue, the
  blocked orthonormalizer on both panel steps, ``xxphase_swap``, the brick
  update) at "high" and "bfloat16": its outputs against the reference's, its
  products against the reference's dots, and its "bfloat16" output
  measurably off its "highest" one;
- the slice (6 qubits, r 2, d 2, chi 8, 6 points, the CLI's kernel
  settings): ``build_kernel_matrix`` on the tracked and brick engines against
  the reference's, the site-sharded engine at world size 1 bit-equal to the
  whole chain, and the ring at world size 1 equal to the single-device build,
  at "high"."""

import dataclasses
import functools
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from qml_cutensornet_tpu.config import SimConfig as RefConfig
from qml_cutensornet_tpu.models import gram as ref_gram
from qml_cutensornet_tpu.models.ansatz import KernelStateAnsatz as RefAnsatz
from qml_cutensornet_tpu.models.entanglement import entanglement_graph as ref_graph
from qml_cutensornet_tpu.ops import blocked_qr as jblocked
from qml_cutensornet_tpu.ops import cpx as jcpx
from qml_cutensornet_tpu.ops import gates as jgates
from qml_cutensornet_tpu.ops import mps as jmps
from qml_cutensornet_tpu.ops import pallas_qr as ref_pallas_qr
from qml_cutensornet_tpu.ops import pallas_split as ref_pallas_split
from qml_cutensornet_tpu.ops import svd as jsvd
from qml_cutensornet_tpu.ops import vidal as jvidal
from qml_cutensornet_tpu.ops.cpx import Cpx
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix
from qml_cutensornet_tpu_torch.ops import blocked_qr, gates, lowp, mps, orth, split, svd, vidal
from qml_cutensornet_tpu_torch.parallel import mesh

STRINGS = ("highest", "float32", "high", "bfloat16_3x", "tensorfloat32", "bfloat16", "default")
REDUCED = ("high", "bfloat16")
PASSES = {"high": 3, "bfloat16": 1}
U = {3: 2.0**-16, 1: 2.0**-8}
CLASS = {"high": jax.lax.Precision.HIGH, "bfloat16": jax.lax.Precision.DEFAULT}


def _crandn(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _cpx(x):
    x = np.asarray(x)
    return Cpx(jnp.asarray(x.real), jnp.asarray(x.imag))


def _np(c):
    return np.asarray(c.re) + 1j * np.asarray(c.im)


@pytest.fixture
def products(monkeypatch):
    """The port's reduced-class products: one entry a ``lowp.cgemm`` call."""
    calls = []

    def counting(a, b, n_passes, op="n", op_b="n"):
        calls.append((tuple(a.shape), tuple(b.shape), op, op_b))
        return lowp.cgemm_plain(a, b, n_passes, op, op_b)

    monkeypatch.setattr(lowp, "cgemm", counting)
    return calls


def _dots(jaxpr, cls) -> int:
    """Dots of a jaxpr outside Pallas kernels, each asserted at ``cls``: a
    ``cond`` counts its costliest branch (the engine's branches are
    batch-uniform), a ``scan`` its body times its length."""
    n = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "pallas_call":
            continue
        if name == "dot_general":
            assert eqn.params["precision"] == (cls, cls), eqn.params["precision"]
            n += 1
        elif name == "cond":
            n += max(_dots(b.jaxpr, cls) for b in eqn.params["branches"])
        elif name == "scan":
            n += eqn.params["length"] * _dots(eqn.params["jaxpr"].jaxpr, cls)
        else:
            for v in eqn.params.values():
                sub = getattr(v, "jaxpr", v)
                if hasattr(sub, "eqns"):
                    n += _dots(sub, cls)
    return n


def ref_dots(monkeypatch, precision, fn, *args) -> int:
    """The dots ``fn(*args)`` of the reference sends to ``precision``'s
    class: traced (not run) under ``jax.default_matmul_precision``, with the
    TPU's routing of its orthonormalizations (Pallas K2 / K3 wherever the
    shapes allow). The Pallas launches, whose dots are pinned at HIGHEST and
    not counted, are stood in for by their output shapes."""
    monkeypatch.setattr(jcpx, "_pallas_orth_eligible", jcpx._pallas_shape_ok)
    monkeypatch.setattr(ref_pallas_qr, "qr_orth_pallas", lambda v, **kw: v)
    monkeypatch.setattr(ref_pallas_qr, "qr_with_r_pallas", lambda v, **kw: (v, jcpx.tmap(
        lambda x: jnp.zeros(x.shape[-1:] * 2, x.dtype), v)))
    with jax.default_matmul_precision(precision):
        jaxpr = jax.make_jaxpr(fn)(*args)
    return _dots(jaxpr.jaxpr, CLASS[precision])


def _check(got, ref, full, precision, tol_units, scale=None):
    """``got`` (the port at ``precision``) within ``tol_units`` class units
    of the reference's f32 ``ref``, relative to ``scale`` (default the
    largest ``|ref|``); at one pass measurably off the port's ``full``
    output (by more than a three-pass unit), at three passes not equal."""
    scale = float(np.abs(ref).max()) if scale is None else scale
    unit = U[PASSES[precision]]
    err = float(np.abs(got - ref).max())
    print(f"{precision}: {err / (unit * scale):.3f} units of {tol_units}")
    assert err <= tol_units * unit * scale, (err, tol_units * unit * scale)
    off = float(np.abs(got - full).max())
    assert off > (U[3] * scale if precision == "bfloat16" else 0.0), off
    return err


# ------------------------------------------------------------ classes and routing

def _tiny_slice(matmul_precision, precision="f32"):
    ans = KernelStateAnsatz(4, 1, 1.0, entanglement_graph(4, 1))
    cfg = SimConfig(chi=4, svd_method="subspace", fused_split=True, subspace_iters=2,
                    tile_block=2, precision=precision, matmul_precision=matmul_precision)
    x = np.random.default_rng(3).uniform(0, 2, size=(3, 4))
    return build_kernel_matrix(ans, x, cfg=cfg, sim_batch=3, tile=3, device="cpu")


def test_classes_fold_bit_for_bit():
    k = {s: _tiny_slice(s) for s in STRINGS}
    for group in (("highest", "float32"), ("high", "bfloat16_3x", "tensorfloat32"),
                  ("bfloat16", "default")):
        for s in group[1:]:
            np.testing.assert_array_equal(k[s], k[group[0]])
    assert not np.array_equal(k["high"], k["highest"])
    assert not np.array_equal(k["bfloat16"], k["high"])
    full = _tiny_slice("highest", "f64")
    for s in STRINGS[1:]:
        np.testing.assert_array_equal(_tiny_slice(s, "f64"), full)


def test_every_string_constructs_and_resolves_as_the_reference():
    for s in STRINGS:
        for inherit in ("inherit", "highest", "high"):
            ref = RefConfig(matmul_precision=s, power_precision=inherit, tile_precision=inherit)
            port = SimConfig.from_reference(dataclasses.asdict(ref))
            assert port.matmul_precision == s
            assert port.resolved_tile_precision == ref.resolved_tile_precision
            assert port.resolved_power_precision == (s if inherit == "inherit" else inherit)


class _Routed(Exception):
    """Raised by a stub at the first call of a route."""


def test_routing_matches_reference(monkeypatch):
    """K1 (the reference's ``ops/svd.py:199-207``), K4 and K5 only in a
    full-precision configuration, for every ambient and power string; the
    unfused chain otherwise, in both packages."""
    def stub(route):
        def raise_(*args, **kwargs):
            raise _Routed(route)
        return raise_

    monkeypatch.setattr(split, "subspace_factor", stub("K1"))
    monkeypatch.setattr(ref_pallas_split, "subspace_factor", stub("K1"))
    monkeypatch.setattr(orth, "qr_orth", stub("unfused"))
    monkeypatch.setattr(jcpx, "qr_orth", stub("unfused"))
    theta = _crandn(np.random.default_rng(0), 1, 16, 16)
    base = dict(chi=16, svd_method="subspace", fused_split=True, fused_gate=True)
    for s in STRINGS:
        for power in ("inherit", "highest", "high", "default"):
            rcfg = RefConfig(matmul_precision=s, power_precision=power, fused_interpret=True,
                             **base)
            cfg = SimConfig.from_reference(dataclasses.asdict(rcfg))
            with pytest.raises(_Routed) as port_route:
                svd._split_subspace(torch.from_numpy(theta), cfg, 16)
            with pytest.raises(_Routed) as ref_route:
                jsvd._split_subspace(_cpx(theta[0]), rcfg, 16)
            full = s in ("highest", "float32") and power == "inherit"
            assert str(port_route.value) == str(ref_route.value) == ("K1" if full else "unfused")
            assert svd._kernel_precision(cfg) == full
            assert svd.gate_split_eligible(cfg, 16) == jsvd.gate_split_eligible(rcfg, 16) == full
            assert (svd.brick_split_eligible(cfg, 16, 16, 16)
                    == jsvd.brick_split_eligible(rcfg, 16, 16, 16) == full)


# ------------------------------------------------------------ the modules

NQ, CHI, SITE = 6, 8, 2


def _random_mps(rng, batch):
    """A padded random state (bond k of min(2^(k+1), 2^(n-k-1), chi)): no
    update of it truncates at chi 8."""
    bonds = [1] + [min(2 ** (k + 1), 2 ** (NQ - k - 1), CHI) for k in range(NQ - 1)] + [1]
    t = np.zeros((batch, NQ, CHI, 2, CHI), np.complex64)
    for i in range(NQ):
        l, r = bonds[i], bonds[i + 1]
        t[:, i, :l, :, :r] = _crandn(rng, batch, l, 2, r) / np.sqrt(2 * l)
    bd = np.broadcast_to(np.asarray(bonds[1:-1], np.int32), (batch, NQ - 1)).copy()
    return t, bd


def _port_mps(t, bd):
    return mps.mps_from_reference(t.real, t.imag, np.ones(len(t), np.float32), bd)


def _ref_mps(t, bd, b):
    return jmps.MPS(tensors=_cpx(t[b]), fidelity=jnp.ones((), jnp.float32),
                    bond_dims=jnp.asarray(bd[b]))


def _ref_batch(fn, t, bd, *args):
    """``fn(state, *arg_b)`` of the reference over the batch of ``t``, one
    jitted vmap (``args`` batched on their leading axis); its tensors as
    numpy."""
    states = jmps.MPS(tensors=_cpx(t), fidelity=jnp.ones(len(t), jnp.float32),
                      bond_dims=jnp.asarray(bd))
    return _np(jax.jit(jax.vmap(fn))(states, *args).tensors)


def _pair(t, site):
    return np.einsum("...asb,...btc->...astc", t[..., site, :, :, :], t[..., site + 1, :, :, :])


def _cfgs(precision, **kw):
    rcfg = RefConfig(**{**dict(chi=CHI, svd_method="subspace", fused_split=True,
                               subspace_iters=2, matmul_precision=precision), **kw})
    return rcfg, SimConfig.from_reference(dataclasses.asdict(rcfg))


@pytest.mark.parametrize("precision", REDUCED)
def test_hadamard_layers(products, monkeypatch, precision):
    """``apply_1q_all`` (tracked) and ``apply_1q_real_sites`` (brick): one
    product, a batch stride 0 for the gate. One pass rounds the Hadamard's
    1/sqrt(2) to bf16."""
    t, bd = _random_mps(np.random.default_rng(1), 2)
    h = gates.hadamard(torch.float32, torch.device("cpu"))
    got = mps.apply_1q_all(_port_mps(t, bd), h, precision).tensors.numpy()
    full = mps.apply_1q_all(_port_mps(t, bd), h).tensors.numpy()
    assert len(products) == 1 and products[0][0][0] == 2 * NQ * CHI
    ref = _ref_batch(lambda st: jmps.apply_1q_all(st, jgates.hadamard()), t, bd)
    _check(got, ref, full, precision, 2)
    assert 4 * len(products) == ref_dots(monkeypatch, precision, jmps.apply_1q_all,
                                         _ref_mps(t, bd, 0), jgates.hadamard())
    products.clear()
    vst = vidal.VidalState(torch.from_numpy(t), torch.zeros(2, NQ - 1, CHI),
                           torch.ones(2), torch.from_numpy(bd))
    got = vidal.apply_1q_real_sites(vst, h, NQ - 2, precision).tensors.numpy()
    rst = jvidal.VidalState(_cpx(t), jnp.zeros((2, NQ - 1, CHI)), jnp.ones(2), jnp.asarray(bd))
    ref = _np(jvidal.apply_1q_real_sites(rst, jgates.hadamard(), NQ - 2).tensors)
    full = vidal.apply_1q_real_sites(vst, h, NQ - 2).tensors.numpy()
    _check(got, ref, full, precision, 2)
    np.testing.assert_array_equal(got[:, [0, NQ - 1]], t[:, [0, NQ - 1]])  # dummy sites
    assert 4 * len(products) == ref_dots(
        monkeypatch, precision, lambda st, u: jvidal.apply_1q_real_sites(st, u, NQ - 2), rst,
        jgates.hadamard()) == 4


@pytest.mark.parametrize("precision", REDUCED)
def test_apply_1q(products, monkeypatch, precision):
    t, bd = _random_mps(np.random.default_rng(2), 2)
    th = np.array([0.3, 1.1], np.float32)
    u = gates.rx(torch.from_numpy(th))
    got = mps.apply_1q(_port_mps(t, bd), SITE, u, precision).tensors.numpy()
    full = mps.apply_1q(_port_mps(t, bd), SITE, u).tensors.numpy()
    ref = _ref_batch(lambda st, x: jmps.apply_1q(st, SITE, jgates.rx(x)), t, bd, jnp.asarray(th))
    _check(got, ref, full, precision, 2)
    assert 4 * len(products) == 4 == ref_dots(monkeypatch, precision, jmps.apply_1q,
                                              _ref_mps(t, bd, 0), SITE, jgates.rx(0.3))


@pytest.mark.parametrize("direction", [0, 1])
@pytest.mark.parametrize("precision", REDUCED)
def test_apply_2site(products, monkeypatch, precision, direction):
    """theta, the gate (K = 4, the gate broadcast over the bond index), two
    power products an iteration and the right factor: 3 + 2 x 2 products,
    off K1 (the unfused chain, K3's plain version at full precision). The
    pair product ``new_a new_b`` is basis-invariant; untruncated it is the
    gated theta, whose products carry the class's error."""
    t, bd = _random_mps(np.random.default_rng(3 + direction), 2)
    rcfg, cfg = _cfgs(precision)
    th = np.array([0.7, 2.1], np.float32)
    u4 = gates.xxphase(torch.from_numpy(th))
    got = mps.apply_2site(_port_mps(t, bd), SITE, u4, cfg, direction).tensors.numpy()
    full = mps.apply_2site(_port_mps(t, bd), SITE, u4,
                           dataclasses.replace(cfg, matmul_precision="highest"),
                           direction).tensors.numpy()
    assert len(products) == 3 + 2 * cfg.subspace_iters
    ref = _ref_batch(lambda st, x: jmps.apply_2site(st, SITE, jgates.xxphase(x), rcfg, direction),
                     t, bd, jnp.asarray(th))
    _check(_pair(got, SITE), _pair(ref, SITE), _pair(full, SITE), precision, 4)
    assert 4 * len(products) == ref_dots(
        monkeypatch, precision, lambda s, g: jmps.apply_2site(s, SITE, g, rcfg, direction),
        _ref_mps(t, bd, 0), jgates.xxphase(th[0]))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("direction", [0, 1])
@pytest.mark.parametrize("precision", REDUCED)
def test_move_center(products, monkeypatch, precision, direction, fused):
    """The move's product (r into the neighbour; ``r^H`` passed as ``r``
    with ``op_b`` "h" on a left move) at the class; r from K2 at full
    precision with the fused split, else K3 and ``r = q^H v`` at the class
    (the reference's ``ops/cpx.py:245``). The chi-8 state is padded to chi
    16 with exact zeros, a shape the reference's Pallas basis kernel takes
    (at chi 8 it factors by Householder, no dot:
    ``orth.reference_r_is_dot``)."""
    t, bd = _random_mps(np.random.default_rng(5 + direction), 2)
    t = np.pad(t, ((0, 0), (0, 0), (0, CHI), (0, 0), (0, CHI)))
    rcfg, cfg = _cfgs(precision, fused_split=fused, chi=2 * CHI)
    got = mps.move_center(_port_mps(t, bd), SITE, direction, cfg).tensors.numpy()
    full = mps.move_center(_port_mps(t, bd), SITE, direction,
                           dataclasses.replace(cfg, matmul_precision="highest")).tensors.numpy()
    assert len(products) == (1 if fused else 2)
    ref = _ref_batch(lambda st: jmps.move_center(st, SITE, direction, rcfg), t, bd)
    _check(_pair(got, SITE), _pair(ref, SITE), _pair(full, SITE), precision, 4)
    assert 4 * len(products) == ref_dots(
        monkeypatch, precision, lambda s: jmps.move_center(s, SITE, direction, rcfg),
        _ref_mps(t, bd, 0))


@pytest.mark.parametrize("precision", REDUCED)
def test_vdot(products, monkeypatch, precision):
    t, bd = _random_mps(np.random.default_rng(7), 2)
    u, _ = _random_mps(np.random.default_rng(8), 2)
    got = mps.vdot(_port_mps(t, bd), _port_mps(u, bd), precision).numpy()
    full = mps.vdot(_port_mps(t, bd), _port_mps(u, bd)).numpy()
    ref = np.array([complex(*(float(x) for x in jmps.vdot(_ref_mps(t, bd, b), _ref_mps(u, bd, b))))
                    for b in range(2)])
    scale = float(np.sqrt(np.abs(mps.norm_sq(_port_mps(t, bd)).numpy()
                          * mps.norm_sq(_port_mps(u, bd)).numpy()).max()))
    _check(got, ref, full, precision, 2, scale)
    assert len(products) == 2 * NQ
    assert 4 * len(products) == ref_dots(monkeypatch, precision, jmps.vdot, _ref_mps(t, bd, 0),
                                         _ref_mps(u, bd, 0))


@pytest.mark.parametrize("method", ["svd", "eigh"])
@pytest.mark.parametrize("precision", REDUCED)
def test_svd_and_eigh_glue(products, monkeypatch, precision, method):
    """The right factor ``left^H theta`` (both methods) and the eigh Gram
    ``theta theta^H`` (formed at the class, then rotated at full precision)
    fall to the class; the factorizations do not. The reference's greedy
    basis scan (two dots a candidate) has no counterpart in the port."""
    # U diag(sv) W^H, the kept 8 a decade above the rest: the cap cuts at 8
    rng = np.random.default_rng(9)
    u, _ = np.linalg.qr(_crandn(rng, 2, 16, 16))
    w, _ = np.linalg.qr(_crandn(rng, 2, 16, 16))
    sv = np.concatenate([np.geomspace(1.0, 0.3, 8), np.geomspace(0.03, 0.003, 8)])
    theta = ((u * sv) @ w.conj().transpose(0, 2, 1)).astype(np.complex64)
    rcfg = RefConfig(chi=8, svd_method=method, matmul_precision=precision)
    cfg = SimConfig.from_reference(dataclasses.asdict(rcfg))
    left, right, kf, rank = svd.truncated_svd(torch.from_numpy(theta), cfg, 8)
    assert len(products) == (2 if method == "eigh" else 1)
    full = svd.truncated_svd(torch.from_numpy(theta),
                             dataclasses.replace(cfg, matmul_precision="highest"), 8)
    ref = [jsvd.truncated_svd(_cpx(theta[b]), rcfg, 8) for b in range(2)]
    approx = (left @ right).numpy()
    ref_approx = np.stack([_np(r[0]) @ _np(r[1]) for r in ref])
    # eigh squares the condition number: its class's error reaches the
    # factors through the Gram's, relative to |theta|^2
    _check(approx, ref_approx, (full[0] @ full[1]).numpy(), precision,
           4)
    np.testing.assert_array_equal(rank.numpy(), [int(r[3]) for r in ref])
    # the reference's eigh Gram is ONE real product of the embedding
    ncand = min(2 * 8, 2 * 16)
    assert 4 * len(products) - (3 if method == "eigh" else 0) + 2 * 4 * ncand == ref_dots(
        monkeypatch, precision, lambda re, im: jsvd.truncated_svd(Cpx(re, im), rcfg, 8),
        jnp.asarray(theta[0].real), jnp.asarray(theta[0].imag))


def _blocked_input():
    return _crandn(np.random.default_rng(11), 2, 96, 64)


@functools.lru_cache(maxsize=1)
def _ref_blocked_projector():
    """The reference's (f32 on the CPU) ``Q Q^H`` of :func:`_blocked_input`."""
    v = _blocked_input()
    q = np.stack([_np(jblocked.qr_orth_blocked(_cpx(v[b]))) for b in range(2)])
    return q @ q.conj().transpose(0, 2, 1)


@pytest.mark.parametrize("kernel_panels", [False, True])
@pytest.mark.parametrize("precision", REDUCED)
def test_blocked_orthonormalizer(products, monkeypatch, precision, kernel_panels):
    """64 columns in 2 panels of 32: the inter-panel projections (4 products
    a later panel) at the class, and the scanned panel step's single-column
    products (4 a column after the first), or K3's plain version at full
    precision on the panels. The reference's scan also projects each
    panel's first column against its empty prefix (4 dots, zeros)."""
    v = _blocked_input()
    q = blocked_qr.qr_orth_blocked(torch.from_numpy(v), kernel_panels, precision=precision)
    full = blocked_qr.qr_orth_blocked(torch.from_numpy(v), kernel_panels).numpy()
    scan = 0 if kernel_panels else 2 * 4 * (blocked_qr.PANEL - 1)
    assert len(products) == 4 + scan
    q = q.numpy()
    proj = q @ q.conj().transpose(0, 2, 1)
    _check(proj, _ref_blocked_projector(), full @ full.conj().transpose(0, 2, 1), precision, 4)
    empty_prefix = 0 if kernel_panels else 2 * 4
    assert 4 * (len(products) + empty_prefix) == ref_dots(
        monkeypatch, precision,
        lambda re, im: jblocked.qr_orth_blocked(Cpx(re, im), pallas_panels=kernel_panels,
                                                interpret=kernel_panels),
        jnp.asarray(v[0].real), jnp.asarray(v[0].imag))


@pytest.mark.parametrize("precision", REDUCED)
def test_xxphase_swap(products, monkeypatch, precision):
    """The one gate the reference builds with a dot (two real dots: SWAP is
    real); the engines exchange columns instead, exactly."""
    th = np.array([0.4, 1.9, 2.7], np.float32)
    got = gates.xxphase_swap(torch.from_numpy(th), precision).numpy()
    full = gates.xxphase_swap(torch.from_numpy(th)).numpy()
    ref = _np(jgates.xxphase_swap(jnp.asarray(th)))
    _check(got, ref, full, precision, 2)
    np.testing.assert_array_equal(full, gates.xxphase(torch.from_numpy(th))[..., [0, 2, 1, 3]])
    assert 2 * len(products) == 2 == ref_dots(monkeypatch, precision, jgates.xxphase_swap,
                                              jnp.asarray(th))


@pytest.mark.parametrize("precision", REDUCED)
def test_brick_update(products, monkeypatch, precision):
    """theta, the gate, the split (2 x 2 power products and the right
    factor) and ``new_a = theta V^H`` (``V`` passed as stored): 8 products,
    off K5 and K1. Untruncated (chi 8), ``new_a new_b`` is the gated theta
    and ``s`` its singular values."""
    rng = np.random.default_rng(13)
    B, K = 2, 2
    a, b = _crandn(rng, B, K, CHI, 2, CHI) / 4, _crandn(rng, B, K, CHI, 2, CHI) / 4
    lam = np.abs(rng.standard_normal((B, K, CHI))).astype(np.float32)
    th = rng.uniform(0, 3, size=(B, K)).astype(np.float32)
    rcfg, cfg = _cfgs(precision, fused_gate=True)
    args = (torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(lam),
            torch.from_numpy(th), 1.0)
    na, nb, s, kf, rank = vidal.update_pairs(*args, cfg)
    assert len(products) == 4 + 2 * cfg.subspace_iters
    full = vidal.update_pairs(*args, dataclasses.replace(cfg, matmul_precision="highest"))
    rargs = (_cpx(a), _cpx(b), jnp.asarray(lam), jnp.asarray(th), 1.0)
    rna, rnb, rs, rkf, rrank = jax.jit(lambda *x: jvidal.update_pairs(*x, rcfg))(*rargs)
    pair = lambda x, y: np.einsum("bkasc,bkctd->bkastd", x, y)
    _check(pair(na.numpy(), nb.resolve_conj().numpy()), pair(_np(rna), _np(rnb)),
           pair(full[0].numpy(), full[1].resolve_conj().numpy()), precision, 8)
    np.testing.assert_allclose(np.sort(s.numpy(), -1), np.sort(np.asarray(rs), -1),
                               atol=8 * U[PASSES[precision]] * float(np.asarray(rs).max()))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(rrank))
    assert 4 * len(products) == ref_dots(
        monkeypatch, precision, lambda *x: jvidal.update_pairs(*x, rcfg), *rargs)


@pytest.mark.parametrize("precision", REDUCED)
def test_transposes_and_gates_reach_cgemm_as_views(monkeypatch, precision):
    """``lowp.matmul`` hands ``cgemm`` the ``r`` of a left center move and
    the ``V`` of the brick update as they are stored, with ``op_b`` "h"
    (``V``, a lazy conjugate ``q^H``, as its ``q`` with ``op_b`` "n"), and
    the gate broadcast over theta's bond index with an inner stride 0: the
    callers' data pointers and strides, no copy."""
    seen = []

    def spy(a, b, n_passes, op="n", op_b="n"):
        seen.append((a, b, op, op_b))
        return lowp.cgemm_plain(a, b, n_passes, op, op_b)

    monkeypatch.setattr(lowp, "cgemm", spy)
    factors = []
    real_qr, real_split = orth.qr, vidal.truncated_split_right
    monkeypatch.setattr(orth, "qr", lambda *a, **k: factors.append(real_qr(*a, **k)) or factors[-1])
    monkeypatch.setattr(vidal, "truncated_split_right",
                        lambda *a, **k: factors.append(real_split(*a, **k)) or factors[-1])
    t, bd = _random_mps(np.random.default_rng(5), 2)
    t = np.pad(t, ((0, 0), (0, 0), (0, CHI), (0, 0), (0, CHI)))
    _, cfg = _cfgs(precision, fused_split=True, chi=2 * CHI)
    mps.move_center(_port_mps(t, bd), SITE, 1, cfg)  # new_a = a r^H
    (_, b, op, op_b), = seen
    r = factors[0][1]
    assert (op, op_b) == ("n", "h") and b.data_ptr() == r.data_ptr()
    assert b.stride()[0] == r.stride(0) and b.stride()[-2:] == r.stride()[-2:]

    seen.clear()
    rng = np.random.default_rng(13)
    a, b = _crandn(rng, 2, 2, CHI, 2, CHI) / 4, _crandn(rng, 2, 2, CHI, 2, CHI) / 4
    lam = np.abs(rng.standard_normal((2, 2, CHI))).astype(np.float32)
    th = rng.uniform(0, 3, size=(2, 2)).astype(np.float32)
    vidal.update_pairs(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(lam),
                       torch.from_numpy(th), 1.0, _cfgs(precision, fused_gate=True)[1])
    v = factors[-1][0]  # new_a = theta V^H
    _, b, op, op_b = seen[-1]
    assert v.is_conj() and (op, op_b) == ("n", "n") and not b.is_conj()
    assert b.data_ptr() == v.mH.data_ptr() and b.stride()[-2:] == v.mH.stride()[-2:]

    seen.clear()
    u4 = gates.xxphase(torch.tensor([0.7, 2.1]))
    mps.apply_2site(_port_mps(t[:, :, :CHI, :, :CHI], bd), SITE, u4, _cfgs(precision)[1], 0)
    a, _, _, _ = seen[1]  # the gate on theta [B, chi, 4, chi]
    assert a.data_ptr() == u4.data_ptr() and a.shape == (2, CHI, 4, 4)
    assert a.stride() == (16, 0, 4, 1)


@pytest.mark.parametrize("routing", ["tracked", "brick"])
def test_slice_products_reach_cgemm_as_views(monkeypatch, routing):
    """Every product of the slice at "high" (simulation and tiles) reaches
    ``cgemm`` as views of its caller's tensors: ``lowp.matmul`` copies no
    operand."""
    real, copies, calls = lowp._batched, [], []

    def spy(a, b, batch):
        out = real(a, b, batch)
        calls.append(batch)
        copies.extend((tuple(x.shape), x.stride()) for x, y in zip((a, b), out)
                      if x.data_ptr() != y.data_ptr())
        return out

    monkeypatch.setattr(lowp, "_batched", spy)
    _port_slice("high", routing)
    assert calls and not copies


# ------------------------------------------------------------ the slice

SLICE_NQ, SLICE_CHI, SLICE_N = 6, 8, 6


def _slice_cfg(precision, tile_block=2):
    # 6 qubits: no bond exceeds 2^3 = chi 8, so nothing truncates and the
    # Grams carry only the products' rounding
    return RefConfig(chi=SLICE_CHI, svd_method="subspace", fused_split=True, subspace_iters=2,
                     tile_block=tile_block, matmul_precision=precision)


def _slice_x():
    return np.random.default_rng(5).uniform(0, 2, size=(SLICE_N, SLICE_NQ))


def _port_slice(precision, routing, tile_block=2, **kw):
    ans = KernelStateAnsatz(SLICE_NQ, 2, 1.0, entanglement_graph(SLICE_NQ, 2), routing=routing)
    cfg = SimConfig.from_reference(dataclasses.asdict(_slice_cfg(precision, tile_block)))
    return build_kernel_matrix(ans, _slice_x(), cfg=cfg, sim_batch=8, device="cpu", **kw)


_port_slice_once = functools.lru_cache(maxsize=None)(_port_slice)


@pytest.mark.parametrize("precision", REDUCED)
@pytest.mark.parametrize("routing", ["tracked", "brick"])
def test_slice_matches_reference(precision, routing):
    """The Gram at the class against the reference's at the same config
    (f32 on the CPU): within 4 U (the states pass some 50 products each;
    their rounding is uncorrelated, and the Gram's normalization by its own
    diagonal takes out the norm errors to first order: measured at most
    1.5 U), symmetric within the same, unit diagonal."""
    ans = RefAnsatz(SLICE_NQ, 2, 1.0, ref_graph(SLICE_NQ, 2), routing=routing)
    ref = ref_gram.build_kernel_matrix(ans, _slice_x(), cfg=_slice_cfg(precision), sim_batch=8)
    k = _port_slice_once(precision, routing)
    tol = 4 * U[PASSES[precision]]
    assert np.abs(k - ref).max() <= tol
    assert np.abs(k - k.T).max() <= tol
    np.testing.assert_allclose(np.diag(k), 1.0, atol=1e-12)
    off = np.abs(k - _port_slice_once("highest", routing)).max()
    assert off > (U[3] if precision == "bfloat16" else 0.0)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_site_sharded_and_ring_at_world_size_one(monkeypatch):
    """At "high": the site-sharded brick engine on a mesh of one gives the
    whole chain's Gram to the bit (the same products in the same order);
    the ring at world size 1 (gloo, in this process) equals the
    single-device build at the ring's site block of 1 within 1e-7 (the
    same products at the inherited class, batched over other tiles, so
    their f32 sums may round apart)."""
    whole = _port_slice_once("high", "brick")
    sharded = _port_slice("high", "brick", site_mesh=mesh.make_site_mesh(device="cpu"))
    np.testing.assert_array_equal(sharded, whole)
    for key, value in dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(key, value)
    assert mesh.maybe_distributed_init("cpu")
    try:
        ring = _port_slice("high", "tracked", tile_block=1, mesh=mesh.make_mesh(device="cpu"))
    finally:
        dist.destroy_process_group()
    single = _port_slice("high", "tracked", tile_block=1)
    np.testing.assert_allclose(ring, single, atol=1e-7, rtol=0)
