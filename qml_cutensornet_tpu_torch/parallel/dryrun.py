"""Multi-device dry run (port of ``__graft_entry__.dryrun_multichip``, its
ring parts) and a runner of calls on every rank of a launched group.

    python -m qml_cutensornet_tpu_torch.parallel.dryrun N [--device cuda|cpu]

starts N local processes (``parallel/mesh.launch``; NCCL on cuda, one card
a rank; gloo on cpu) and builds, on the ring over them, the symmetric and
the rectangular Gram of 8 qubits at chi 8 in f32 on ``2N + 3`` points, and
the Gram of a deep schedule (6 qubits, reps 8, ``N + 2`` points), each held
within 2e-6 (the reference's bar) to the single-device
``models/gram.build_kernel_matrix`` of the same call; then it evolves 3
states of ``max(10, 2N)`` qubits on the brick engine with their sites
sharded over the N ranks (``parallel/sharded_mps``, chi 16, f32), holds them
within 1e-6 to the whole-chain brick engine, and takes their Gram.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import pathlib
import time

import numpy as np
import torch
import torch.distributed as dist

from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix
from qml_cutensornet_tpu_torch.models.simulate import make_brick_simulator, tile_overlaps_sq
from qml_cutensornet_tpu_torch.parallel import gram as pgram
from qml_cutensornet_tpu_torch.parallel import sharded_mps
from qml_cutensornet_tpu_torch.parallel.mesh import (
    Mesh,
    launch,
    make_mesh,
    make_site_mesh,
    to_host,
)
from qml_cutensornet_tpu_torch.utils.device import environ

TOL = 2e-6  # ring vs single device, f32 (the reference's dry-run bar)
SITE_TOL = 1e-6  # site-sharded vs whole-chain MPS tensors, f32 (the reference's dry-run bar)
MESH = "<mesh>"  # a keyword argument of run_calls with this value gets the rank's mesh
ENGINE = "<engine>"  # ... and with this one the rank's cli._pipeline.engine_kwargs()


def _toy_problem(nq=8, reps=2, nn=2, gamma=1.0, chi=8, n_points=8):
    ansatz = KernelStateAnsatz(nq, reps, gamma, entanglement_graph(nq, nn))
    cfg = SimConfig(chi=chi, precision="f32")
    rng = np.random.default_rng(0)
    feats = rng.uniform(0.0, 2.0, size=(n_points, nq)).astype(np.float32)
    return ansatz, cfg, feats


def dryrun_rank(device: str = "cuda") -> dict:
    """The dry run on this rank of an initialized process group. Returns the
    largest ring-vs-single-device error and the shape of each Gram; raises
    if an error passes :data:`TOL`."""
    mesh = make_mesh(device=device)
    n = mesh.size
    ansatz, cfg, feats = _toy_problem(n_points=2 * n + 3)
    k_ring = pgram.build_kernel_matrix_sharded(ansatz, feats, cfg=cfg, mesh=mesh)
    k_single = build_kernel_matrix(ansatz, feats, cfg=cfg, sim_batch=8, tile=8, device=device)
    y = feats[: n + 1]
    k_rect = pgram.build_kernel_matrix_sharded(ansatz, feats, Y=y, cfg=cfg, mesh=mesh)
    assert k_rect.shape == (len(y), len(feats)), k_rect.shape
    # Deep schedule (reps 8): many op chunks a segment.
    ansatz_d, cfg_d, feats_d = _toy_problem(nq=6, reps=8, n_points=n + 2)
    k_deep = pgram.build_kernel_matrix_sharded(ansatz_d, feats_d, cfg=cfg_d, mesh=mesh)
    k_deep_single = build_kernel_matrix(ansatz_d, feats_d, cfg=cfg_d, sim_batch=8, tile=8,
                                        device=device)
    out = {}
    for what, got, want in (("sym", k_ring, k_single), ("rect", k_rect, k_single[: len(y)]),
                            ("deep_r8", k_deep, k_deep_single)):
        err = float(np.abs(got - want).max())
        if not err <= TOL:
            raise AssertionError(f"dry run, {what}: ring vs single device {err} > {TOL}")
        out[what] = {"shape": list(got.shape), "max_abs_err": err}
    out["site_sharded"] = site_sharded_dryrun(device)
    return out


def simulate_site_sharded(ansatz, X, cfg: SimConfig, device: str = "cuda", dp: int = 1):
    """``(mps, seconds)``: ``X`` simulated on the site-sharded brick engine
    over this rank's process group (a mesh of one outside a group; ``dp``
    rows of a 2-D site mesh), gathered on every rank, and the seconds it
    took (after a device synchronization)."""
    mesh = make_site_mesh(dp=dp, device=device)
    sim = sharded_mps.make_sharded_brick_simulator(ansatz.schedule, cfg, mesh)
    return _timed(mesh.device, sim, X)


def _timed(device: torch.device, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def compare_site_sharded(ansatz, X, cfg: SimConfig, device: str = "cuda",
                         with_mps: bool = False):
    """Simulate ``X`` on the site-sharded brick engine over this rank's
    process group (a mesh of one outside a group) and on the whole-chain
    brick engine on the rank's device, in turns (whole, sharded, sharded,
    whole). Returns each engine's two times (seconds after a device
    synchronization), each engine's kernel launches over its two runs
    (``launches``, by engine), and the reference's measures of their
    agreement: the largest tensor difference (``tensor_err``), the largest
    relative fidelity difference (``fid_rtol``) and whether the bond
    dimensions are equal. ``with_mps``: ``(sharded MPS, that dict)``."""
    from qml_cutensornet_tpu_torch.ops import _build

    mesh = make_site_mesh(device=device)
    sims = {"sharded": sharded_mps.make_sharded_brick_simulator(ansatz.schedule, cfg, mesh),
            "whole": make_brick_simulator(ansatz.schedule, cfg, mesh.device)}
    out, seconds = {}, {"sharded": [], "whole": []}
    launches = {what: dict.fromkeys(_build.LAUNCHES, 0) for what in sims}
    for what in ("whole", "sharded", "sharded", "whole"):  # in turns
        before = dict(_build.LAUNCHES)
        out[what], t = _timed(mesh.device, sims[what], X)
        seconds[what].append(t)
        for k, v in _build.LAUNCHES.items():
            launches[what][k] += v - before[k]
    sharded, whole = out["sharded"], out["whole"]
    cmp = {"sharded_s": seconds["sharded"], "whole_s": seconds["whole"], "launches": launches,
           "tensor_err": float((sharded.tensors - whole.tensors).abs().max()),
           "fid_rtol": float((sharded.fidelity / whole.fidelity - 1.0).abs().max()),
           "bond_dims_equal": bool(torch.equal(sharded.bond_dims, whole.bond_dims))}
    return (sharded, cmp) if with_mps else cmp


def site_sharded_dryrun(device: str = "cuda") -> dict:
    """The dry run's site-sharded part (the reference's, with its sizes):
    3 states of ``max(10, 2N)`` qubits on N ranks, r 2, d 2, brick routing,
    chi 16, f32, against the whole chain within :data:`SITE_TOL`, then their
    Gram by ``models/simulate.tile_overlaps_sq``. ``launches``: the site-sharded
    engine's kernel launches."""
    nq = max(10, 2 * (dist.get_world_size() if dist.is_initialized() else 1))
    ansatz = KernelStateAnsatz(nq, 2, 1.0, entanglement_graph(nq, 2), routing="brick")
    feats = np.random.default_rng(1).uniform(0.0, 2.0, size=(3, nq)).astype(np.float32)
    sharded, cmp = compare_site_sharded(ansatz, feats, SimConfig(chi=16, precision="f32"),
                                        device, with_mps=True)
    err = cmp["tensor_err"]
    if not err <= SITE_TOL:
        raise AssertionError(f"dry run, site-sharded MPS vs whole chain {err} > {SITE_TOL}")
    k = tile_overlaps_sq(sharded.tensors, sharded.tensors)
    return {"shape": list(k.shape), "max_abs_err": err, "nq": nq,
            "launches": cmp["launches"]["sharded"]}


def relay_full_and_symmetric(ansatz, X, cfg: SimConfig, mesh, tile: int | None = None) -> dict:
    """The relay on ``X``'s site-sharded states (``gather=False``) over the
    1-D site ``mesh``: all tiles (``full``) and the ``yi <= xi`` tiles with
    their mirrors (``sym``), each with its seconds, and the first site of
    the rank's block of the states (``first_site``, on the host)."""
    st = sharded_mps.make_sharded_brick_simulator(ansatz.schedule, cfg, mesh, gather=False)(X)
    out = {"first_site": st.tensors[:, 0].cpu()}
    for what, symmetric in (("full", False), ("sym", True)):
        out[what], out[f"{what}_s"] = _timed(
            mesh.device, functools.partial(sharded_mps.sharded_tile_overlaps_sq,
                                           symmetric=symmetric),
            st.tensors, st.tensors, mesh, tile)
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """:func:`dryrun_rank` on ``n_devices`` local ranks; returns rank 0's
    result."""
    out = launch(dryrun_rank, n_devices, device, device)
    print(f"dryrun_multichip OK on {n_devices} {device} ranks: "
          + ", ".join(f"{k} {tuple(v['shape'])} err {v['max_abs_err']:.3e}"
                      for k, v in out.items()))
    return out


def ring_snapshot(ansatz, X, cfg: SimConfig, mesh: Mesh, info_file, checkpoint_dir="tmp",
                  sim_batch: int = 32, n_done: int = 1) -> pathlib.Path:
    """Write the snapshot that a stepwise, checkpointed symmetric build of
    ``X`` leaves after its first ``n_done`` ring iterations (an interrupted
    build), with the build's own pieces; returns its path. Every rank calls
    it; rank 0 writes."""
    st = pgram.simulate_ring_states(ansatz.schedule, np.asarray(X, dtype=np.float64), None,
                                    cfg, mesh, sim_batch)
    step = pgram.make_ring_steps(mesh, mesh.size // 2 + 1, True)
    k_local = torch.zeros((st.len_y_padded, st.len_x_padded // mesh.size),
                          dtype=cfg.real_dtype, device=mesh.device)
    ay = st.ay
    for i in range(n_done):
        ay, k_local = step(i, st.ax, ay, k_local)
    k = to_host(k_local, mesh)
    path = pathlib.Path(checkpoint_dir) / f"checkpoint_ring_{pathlib.Path(info_file).name}.npz"
    if mesh.rank == 0:
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, k=k, next_iter=n_done)
    return path


def _marked(value, mesh):
    """What a keyword argument of :func:`run_calls` stands for."""
    if isinstance(value, str) and value == MESH:
        return mesh
    if isinstance(value, str) and value == ENGINE:
        from qml_cutensornet_tpu_torch.cli import _pipeline

        return _pipeline.engine_kwargs()
    return value


def run_calls(device: str, calls) -> list[dict]:
    """Make each call ``(fn, args, kwargs, env)`` in turn on this rank of an
    initialized process group, with the environment knobs ``env`` set around
    it; a keyword argument whose value is :data:`MESH` gets this rank's
    mesh (one row over the group: the ring's, and the 1-D site mesh), one
    whose value is :data:`ENGINE` the engine the CLI's ``engine_kwargs``
    gives under those knobs.
    Returns one record a call: ``out`` (its return value),
    ``launches`` (the kernels' launch counts of the call: counters set to 0
    just before it, read just after), ``seconds`` (wall time, after a device
    synchronization), ``peak_bytes`` (``torch.cuda.max_memory_allocated``
    over the call on a card, else None) and ``stdout`` (what it printed)."""
    from qml_cutensornet_tpu_torch.ops import _build

    mesh = make_mesh(device=device)
    on_card = mesh.device.type == "cuda"
    records = []
    for fn, args, kwargs, env in calls:
        buf = io.StringIO()
        with environ(**env), contextlib.redirect_stdout(buf):
            kwargs = {k: _marked(v, mesh) for k, v in kwargs.items()}
            if on_card:
                torch.cuda.synchronize(mesh.device)
                torch.cuda.reset_peak_memory_stats(mesh.device)
            _build.reset_counters()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if on_card:
                torch.cuda.synchronize(mesh.device)
            seconds = time.perf_counter() - t0
        records.append({
            "out": out, "launches": dict(_build.LAUNCHES), "seconds": seconds,
            "peak_bytes": torch.cuda.max_memory_allocated(mesh.device) if on_card else None,
            "stdout": buf.getvalue()})
    return records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
