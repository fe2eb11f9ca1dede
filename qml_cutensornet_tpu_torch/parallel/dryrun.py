"""Multi-device dry run (port of ``__graft_entry__.dryrun_multichip``, its
ring parts) and a runner of calls on every rank of a launched group.

    python -m qml_cutensornet_tpu_torch.parallel.dryrun N [--device cuda|cpu]

starts N local processes (``parallel/mesh.launch``; NCCL on cuda, one card
a rank; gloo on cpu) and builds, on the ring over them, the symmetric and
the rectangular Gram of 8 qubits at chi 8 in f32 on ``2N + 3`` points, and
the Gram of a deep schedule (6 qubits, reps 8, ``N + 2`` points), each held
within 2e-6 (the reference's bar) to the single-device
``models/gram.build_kernel_matrix`` of the same call. The reference's dry
run also evolves one state site-sharded over the mesh; that part waits for
``parallel/sharded_mps``, which is not ported yet.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import pathlib
import time

import numpy as np
import torch

from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix
from qml_cutensornet_tpu_torch.parallel import gram as pgram
from qml_cutensornet_tpu_torch.parallel.mesh import Mesh, launch, make_mesh, to_host
from qml_cutensornet_tpu_torch.utils.device import environ

TOL = 2e-6  # ring vs single device, f32 (the reference's dry-run bar)
MESH = "<mesh>"  # a keyword argument of run_calls with this value gets the rank's mesh


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


def run_calls(device: str, calls) -> list[dict]:
    """Make each call ``(fn, args, kwargs, env)`` in turn on this rank of an
    initialized process group, with the environment knobs ``env`` set around
    it; a keyword argument whose value is :data:`MESH` gets this rank's
    mesh. Returns one record a call: ``out`` (its return value),
    ``launches`` (the kernels' launch counts of the call: counters set to 0
    just before it, read just after), ``seconds`` (wall time, after a device
    synchronization), ``peak_bytes`` (``torch.cuda.max_memory_allocated``
    over the call on a card, else None) and ``stdout`` (what it printed)."""
    from qml_cutensornet_tpu_torch.ops import _build

    mesh = make_mesh(device=device)
    on_card = mesh.device.type == "cuda"
    records = []
    for fn, args, kwargs, env in calls:
        kwargs = {k: (mesh if isinstance(v, str) and v == MESH else v)
                  for k, v in kwargs.items()}
        buf = io.StringIO()
        with environ(**env), contextlib.redirect_stdout(buf):
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
