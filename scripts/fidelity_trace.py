"""Trace the f32 ``avg_fidelity`` of the PyTorch port against the JAX
package, split by split, on the CPU.

Both packages simulate the same points (``default_rng(1).uniform(0, 2,
(4, NQ))``, ``entanglement_graph(NQ, 6)``, r 2, gamma 1.0, staged chi, the
subspace method with 2 iterations, one sim batch of 4): the JAX package in
f32 unfused (Householder QR on the CPU), in f32 through its Pallas BCGS2
bodies in interpret mode, and in f64; the port in f32 and f64. For every
truncating split of the subspace routes it records ``kept / total`` as the
reference computes it (the masked row norms of ``q^H theta`` over
``||theta||^2``) and, in the port, the kept fraction the port returns, then
prints:

- ``avg_fidelity`` of each run; for the port in f32 also the product of the
  reference's estimate over the same splits (what the port read before it
  took the residual form, ``ops/svd._kept_fraction``);
- per split, how the ratios fall about 1 (below, above, equal), and the
  port's f32 ratio less its f64 ratio on the same split (mean, spread, and
  the mean after the clamp at 1);
- the JAX package's f32 ``||theta||^2`` against the same sum in f64;
- at NQ <= 14 the true fidelity of each f32 and f64 state, ``|<psi|mps>|^2 /
  <mps|mps>`` against the dense state of ``ops/dense.ansatz_state``.

    JAX_PLATFORMS=cpu python scripts/fidelity_trace.py            # NQ 12, chi 16
    JAX_PLATFORMS=cpu python scripts/fidelity_trace.py 30 64 port # the port alone

The third argument ``port`` skips the JAX package's runs.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["QMLTPU_STAGED"] = "1"
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from qml_cutensornet_tpu_torch.config import SimConfig  # noqa: E402
from qml_cutensornet_tpu_torch.models import gram  # noqa: E402
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz  # noqa: E402
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph  # noqa: E402
from qml_cutensornet_tpu_torch.ops import dense, mps, svd  # noqa: E402

N, REPS, GAMMA, D = 4, 2, 1.0, 6


def port_run(X, em, nq, cfg):
    """The port's states and fidelities, with each split's (reference ratio,
    returned kept fraction) ``[B]`` pairs in order."""
    splits = []
    orig = svd._finish_subspace

    def hooked(q, r, total, cfg_, keep, nc, resid2=None):
        out = orig(q, r, total, cfg_, keep, nc, resid2)
        s2 = svd.orth.abs2(r).sum(2)
        if nc > keep:
            s2 = torch.sort(s2, dim=1, descending=True).values[:, :keep]
        mask = svd._mask_from_s2(s2, total, cfg_, keep)
        kept = torch.where(mask, s2, torch.zeros_like(s2)).sum(1)
        splits.append(((kept / total).double().numpy(), out[2]))
        return out

    svd._finish_subspace = hooked
    try:
        t, fid, chis, _, _ = gram.simulate_dataset(KernelStateAnsatz(nq, REPS, GAMMA, em).schedule,
                                                   X, cfg, N, torch.device("cpu"))
    finally:
        svd._finish_subspace = orig
    return t.numpy(), fid, chis, splits


def ref_run(X, em, nq, rcfg):
    """The JAX package's states and fidelities, each split's reference ratio
    (in call order) and, per split, its f32 ``||theta||^2`` over the f64
    sum."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    import qml_cutensornet_tpu.ops.svd as rsvd
    from qml_cutensornet_tpu.models import gram as rgram
    from qml_cutensornet_tpu.models.ansatz import KernelStateAnsatz as RefAnsatz

    ratios, totals, theta_box = [], [], {}
    orig_split, orig_mask = rsvd._split_subspace, rsvd._mask_from_s2

    def split(theta, cfg, keep):
        theta_box["t"] = theta
        out = orig_split(theta, cfg, keep)
        th = theta_box["t"]
        t64 = jnp.sum(th.re.astype(jnp.float64) ** 2 + th.im.astype(jnp.float64) ** 2)
        t32 = jnp.sum(th.re * th.re + th.im * th.im)
        jax.debug.callback(lambda a, b: totals.append(float(a) / float(b) - 1.0), t32, t64)
        return out

    def mask(s2, total, cfg, keep, rdt):
        m, kf = orig_mask(s2, total, cfg, keep, rdt)
        kept = jnp.sum(jnp.where(m, s2, 0.0))
        jax.debug.callback(lambda a, b: ratios.append(float(a) / float(b)), kept, total)
        return m, kf

    rsvd._split_subspace, rsvd._mask_from_s2 = split, mask
    try:
        t, fid, chis, _ = rgram.simulate_dataset(RefAnsatz(nq, REPS, GAMMA, em).schedule, X,
                                                 rcfg, N)
    finally:
        rsvd._split_subspace, rsvd._mask_from_s2 = orig_split, orig_mask
    return np.asarray(t.re) + 1j * np.asarray(t.im), fid, chis, np.array(ratios), np.array(totals)


def true_fidelity(tensors, X, em, nq):
    out = []
    for i in range(N):
        v = mps.to_dense(tensors[i].astype(np.complex128), nq)
        psi = dense.ansatz_state(X[i], REPS, GAMMA, em)
        out.append(abs(np.vdot(psi, v)) ** 2 / np.vdot(v, v).real)
    return float(np.mean(out))


def spread(r):
    return f"below 1: {int(np.sum(r < 1))}, above: {int(np.sum(r > 1))}, equal: {int(np.sum(r == 1))}"


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else list(argv)
    nq = int(args[0]) if args else 12
    chi = int(args[1]) if len(args) > 1 else 16
    port_only = len(args) > 2 and args[2] == "port"
    X = np.random.default_rng(1).uniform(0.0, 2.0, size=(N, nq))
    em = entanglement_graph(nq, D)
    base = SimConfig(chi=chi, precision="f32", svd_method="subspace", subspace_iters=2,
                     tile_block=2, fused_split=True)
    dense_ok = nq <= 14
    print(f"NQ {nq}, chi {chi}, {N} points, r {REPS}, gamma {GAMMA}, d {D}, staged, subspace "
          f"iters 2")
    port = {}
    for prec in ("f32", "f64"):
        t0 = time.perf_counter()
        port[prec] = port_run(X, em, nq, dataclasses.replace(base, precision=prec))
        tens, fid, chis, splits = port[prec]
        # The reference's estimate over the same splits, multiplied in the
        # fidelity's dtype in the simulator's order.
        before = np.ones(N, dtype=fid.dtype)
        for ratio, _ in splits:
            before = before * np.minimum(ratio, 1.0).astype(fid.dtype)
        tf = f", true fidelity {true_fidelity(tens, X, em, nq):.8f}" if dense_ok else ""
        print(f"port {prec}: avg_fidelity {np.mean(fid):.8f} (the reference's estimate over "
              f"the same splits: {np.mean(before):.8f}), ave max chi {np.mean(chis)}{tf} "
              f"({time.perf_counter() - t0:.1f} s)")
    r32 = np.concatenate([s[0] for s in port["f32"][3]])
    r64 = np.concatenate([s[0] for s in port["f64"][3]])
    diff = r32 - r64
    clamped = np.minimum(r32, 1.0) - np.minimum(r64, 1.0)
    print(f"port, {len(r32)} splits (before the clamp): f32 {spread(r32)}; f64 {spread(r64)}")
    print(f"port, f32 ratio less f64 ratio a split: mean {diff.mean():.3e}, std "
          f"{diff.std():.3e}; after the clamp at 1: mean {clamped.mean():.3e}, times "
          f"{len(r32) / N:.0f} splits a circuit {clamped.mean() * len(r32) / N:.3e}; f64 "
          f"ratio within 1e-9 of 1 on {np.mean(abs(r64 - 1) < 1e-9):.4f} of the splits")
    if port_only:
        return
    rbase = dict(chi=chi, precision="f32", svd_method="subspace", subspace_iters=2,
                 tile_block=2)
    from qml_cutensornet_tpu.config import SimConfig as RefConfig

    runs = {"f32, unfused": RefConfig(**rbase, fused_split=False),
            "f32, fused interpret": RefConfig(**rbase, fused_split=True, fused_interpret=True),
            "f64": RefConfig(**dict(rbase, precision="f64"), fused_split=False)}
    for name, rcfg in runs.items():
        t0 = time.perf_counter()
        tens, fid, chis, ratios, totals = ref_run(X, em, nq, rcfg)
        tf = f", true fidelity {true_fidelity(tens, X, em, nq):.8f}" if dense_ok else ""
        print(f"JAX package {name}: avg_fidelity {np.mean(fid):.8f}, ave max chi "
              f"{np.mean(chis)}{tf} ({time.perf_counter() - t0:.1f} s)")
        print(f"  {len(ratios)} splits: {spread(ratios)}; mean ratio less the port's f64 "
              f"mean {ratios.mean() - r64.mean():.3e}; ||theta||^2 in its dtype over the "
              f"f64 sum, less 1: mean {totals.mean():.3e}")


if __name__ == "__main__":
    main()
