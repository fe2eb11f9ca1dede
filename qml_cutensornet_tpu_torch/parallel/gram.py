"""Multi-device Gram build: the ring with mirror routing, checkpoint and
resume (port of ``qml_cutensornet_tpu/parallel/gram.py``).

One rank per device (``parallel/mesh.py``). Each rank simulates one
contiguous stripe of the padded rows, holds those X states (its column
stripe of K) and one block of Y states; the Y blocks rotate around the ring
point to point, and in the symmetric case each off-diagonal tile is also
sent, transposed, to the rank that owns the mirrored column stripe:

reference (one controller, XLA SPMD)      | this module (one process per device)
------------------------------------------+----------------------------------------
batch sharded over the mesh, one vmapped  | rank r simulates rows [r*L, (r+1)*L) of
dispatch per block of ``sim_batch`` rows  | the padded batch, block/ndev rows a
                                          | dispatch, on the port's own simulator
Y blocks rotated with ``lax.ppermute``    | ``batch_isend_irecv`` to r-1, from r+1
mirror tiles ``ppermute``'d to their      | the transposed tile to (r+i), the tile
column-stripe owner (same skip rules)     | of (r-i) received (same skip rules)
column stripes assembled by the           | ``all_gather`` of the stripes
out_sharding                              | (``mesh.to_host``)

Complex tensors travel as ``torch.view_as_real`` on both backends, so that
the CPU tests run the transfers the card runs. Each transfer is waited on
before the next tile; the stepwise ring also synchronizes the device after
each iteration, so that its per-iteration times measure the work. The
reference's fused ring is one XLA program; here ``QMLTPU_RING=fused`` is the
same loop without that synchronization (and so without per-iteration times
or snapshots): eager PyTorch launches the same kernels in the same order
either way.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import time

import numpy as np
import torch
import torch.distributed as dist

from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.gram import _actual_mps_bytes
from qml_cutensornet_tpu_torch.models.simulate import (
    make_chunked_simulator,
    state_norms_sq,
    tile_overlaps_sq,
)
from qml_cutensornet_tpu_torch.parallel.mesh import Mesh, to_host

RING_MODES = ("stepwise", "fused")


def _pad_rows(arr: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    n = arr.shape[0]
    target = -(-n // multiple) * multiple
    if target == n:
        return arr, n
    pad = np.repeat(arr[:1], target - n, axis=0)
    return np.concatenate([arr, pad], axis=0), n


@dataclasses.dataclass(frozen=True)
class RingStep:
    """What one rank does at ring iteration ``i``: the tile of its X stripe
    against Y block ``y_block``; with ``mirror``, the transposed tile to
    rank ``y_block`` (the owner of that column stripe) and the tile of rank
    ``mirror_src`` into rows ``mirror_src * Byl``; with ``shift``, its Y
    block to rank r-1 and the block of rank r+1 in its place."""

    i: int
    y_block: int
    mirror: bool
    mirror_src: int
    shift: bool


def ring_schedule(ndev: int, symmetric: bool, rank: int) -> list[RingStep]:
    """The ring of the reference (its ``gpu:389-400`` skip rules): ``ndev//2
    + 1`` iterations when symmetric, else ``ndev``; at iteration ``i`` rank
    ``r`` holds Y block ``(r + i) % ndev``; the mirror (symmetric only) is
    skipped on the diagonal iteration ``i == 0`` and on the last iteration
    when ``ndev`` is even (both ends of the ring compute that tile); no shift
    after the last iteration."""
    n_iters = ndev // 2 + 1 if symmetric else ndev
    return [RingStep(i=i, y_block=(rank + i) % ndev,
                     mirror=symmetric and i > 0 and not (ndev % 2 == 0 and i == n_iters - 1),
                     mirror_src=(rank - i) % ndev, shift=i + 1 < n_iters)
            for i in range(n_iters)]


def _block_overlaps(ay: torch.Tensor, ax: torch.Tensor, precision: str) -> torch.Tensor:
    """``|<y_i|x_j>|^2`` of one ``[Byl] x [Bxl]`` block, site by site, at
    ``precision``."""
    return tile_overlaps_sq(ay, ax, precision=precision, site_block=1)


def _sendrecv(mesh: Mesh, t: torch.Tensor, dst: int, src: int) -> torch.Tensor:
    """Send ``t`` to rank ``dst`` and receive a tensor of its shape and dtype
    from rank ``src``: one ``batch_isend_irecv``, waited on. From a rank to
    itself (a mesh of one) it is the identity, with no transfer."""
    if dst == src == mesh.rank:
        return t
    send = t.contiguous()
    if send.is_complex():
        send = torch.view_as_real(send)
    recv = torch.empty_like(send)
    for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, mesh.group),
                                        dist.P2POp(dist.irecv, recv, src, mesh.group)]):
        work.wait()
    return torch.view_as_complex(recv) if t.is_complex() else recv


def _shift(mesh: Mesh, ay: torch.Tensor) -> torch.Tensor:
    """The Y ring shift (the reference's ``fwd_perm``): to r-1, from r+1."""
    return _sendrecv(mesh, ay, (mesh.rank - 1) % mesh.size, (mesh.rank + 1) % mesh.size)


def make_ring_steps(mesh: Mesh, n_iters: int, symmetric: bool, precision: str = "highest"):
    """``step(i, ax, ay_cur, k_local) -> (ay_next, k_local)``: ring iteration
    ``i`` on this rank. ``k_local [len_y_pad, Bxl]`` is the rank's column
    stripe of K, written in place: the tile (its products at ``precision``,
    the reference's ``cfg.resolved_tile_precision``) into rows ``y_block *
    Byl``, in the symmetric case the mirror tile received into rows
    ``mirror_src * Byl`` (the mirror batch first, then the Y shift, as the
    reference orders them)."""
    schedule = ring_schedule(mesh.size, symmetric, mesh.rank)
    assert len(schedule) == n_iters, (len(schedule), n_iters)

    def step(i: int, ax: torch.Tensor, ay_cur: torch.Tensor, k_local: torch.Tensor):
        s = schedule[i]
        byl = ay_cur.shape[0]
        block = _block_overlaps(ay_cur, ax, precision).to(k_local.dtype)
        k_local[s.y_block * byl:(s.y_block + 1) * byl] = block
        if s.mirror:
            recv = _sendrecv(mesh, block.T, s.y_block, s.mirror_src)
            k_local[s.mirror_src * byl:(s.mirror_src + 1) * byl] = recv
        return (_shift(mesh, ay_cur) if s.shift else ay_cur), k_local

    return step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _max_over_ranks(values, mesh: Mesh) -> np.ndarray:
    """Elementwise maximum of equal-length float lists over the ranks: the
    time of a step that all ranks take together is that of the slowest."""
    t = torch.tensor(np.asarray(values, dtype=np.float64), device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return t.cpu().numpy()


def _grow_bonds(t: torch.Tensor, chi: int) -> torch.Tensor:
    """Pad the bonds of ``t [B, n, c, 2, c]`` to ``chi`` with exact zeros."""
    c = t.shape[2]
    return t if c == chi else torch.nn.functional.pad(t, (0, chi - c, 0, 0, 0, chi - c))


def simulate_stripe(schedule, feats: np.ndarray, block: int, cfg: SimConfig, mesh: Mesh):
    """Simulate this rank's stripe of the padded rows ``feats`` (a multiple
    of ``block`` rows, ``block`` a multiple of the mesh size): rows ``[r*L,
    (r+1)*L)`` in dispatches of ``block / ndev`` rows, each timed after a
    device synchronization. Returns ``(out, times)``: the stripe's ``MPS``
    and one sample per dispatch (seconds per circuit of the dispatch)."""
    ndev, rank = mesh.size, mesh.rank
    rows = feats.shape[0] // ndev
    local = feats[rank * rows:(rank + 1) * rows]
    per = block // ndev
    sim = make_chunked_simulator(schedule, cfg, mesh.device)
    outs, times = [], []
    for s in range(0, rows, per):
        t0 = time.perf_counter()
        outs.append(sim(local[s:s + per]))
        _sync(mesh.device)
        times.append((time.perf_counter() - t0) / per)
    if len(outs) == 1:
        return outs[0], times
    chi = max(o.tensors.shape[2] for o in outs)
    return dataclasses.replace(
        outs[0], tensors=torch.cat([_grow_bonds(o.tensors, chi) for o in outs]),
        fidelity=torch.cat([o.fidelity for o in outs]),
        bond_dims=torch.cat([o.bond_dims for o in outs])), times


def ring_rows(len_x: int, len_y: int | None, ndev: int, sim_batch: int):
    """``(block_x, block_y)``: rows per simulation dispatch over all ranks,
    a multiple of ``ndev``, capped at the batch's own ``ndev``-padded length
    (the reference's ``_block_rows``); ``len_y`` None: symmetric."""

    def block_rows(n: int) -> int:
        return min(max(ndev, sim_batch // ndev * ndev), -(-n // ndev) * ndev)

    block_x = block_rows(len_x)
    return block_x, (block_x if len_y is None else block_rows(len_y))


@dataclasses.dataclass(frozen=True)
class RingStates:
    """This rank's inputs to the ring: ``out_x``/``out_y`` its simulated
    stripes (``out_y is out_x`` when symmetric), ``ax``/``ay`` their tensors
    with every bond grown to the chi agreed over the ranks, the padded
    lengths, the simulation's wall time and one sample per dispatch."""

    out_x: object
    out_y: object
    ax: torch.Tensor
    ay: torch.Tensor
    len_x_padded: int
    len_y_padded: int
    sim_time: float
    block_times: list


def simulate_ring_states(schedule, X: np.ndarray, Y: np.ndarray | None, cfg: SimConfig,
                         mesh: Mesh, sim_batch: int) -> RingStates:
    """The ring's opening steps on this rank: pad the rows (``Y`` None:
    symmetric), simulate the rank's stripes, and grow the bonds to the chi
    agreed over the ranks (an ``all_reduce(MAX)``; the padding is exact
    zeros), so that every Y block has one shape for the transfers."""
    symmetric = Y is None
    block_x, block_y = ring_rows(len(X), None if symmetric else len(Y), mesh.size, sim_batch)
    x_pad, _ = _pad_rows(X, block_x)
    t0 = time.perf_counter()
    out_x, times = simulate_stripe(schedule, x_pad, block_x, cfg, mesh)
    if symmetric:
        out_y, len_y_padded = out_x, x_pad.shape[0]
    else:
        y_pad, _ = _pad_rows(Y, block_y)
        out_y, y_times = simulate_stripe(schedule, y_pad, block_y, cfg, mesh)
        times, len_y_padded = times + y_times, y_pad.shape[0]
    sim_time = time.perf_counter() - t0
    chi = int(_max_over_ranks([out_x.tensors.shape[2], out_y.tensors.shape[2]], mesh).max())
    return RingStates(out_x, out_y, _grow_bonds(out_x.tensors, chi),
                      _grow_bonds(out_y.tensors, chi), x_pad.shape[0], len_y_padded,
                      sim_time, times)


def build_kernel_matrix_sharded(
    ansatz,
    X,
    Y=None,
    info_file=None,
    cfg: SimConfig | None = None,
    mesh: Mesh | None = None,
    loglevel: int = 30,
    checkpoint: bool = False,
    checkpoint_dir: str = "tmp",
    sim_batch: int = 32,
) -> np.ndarray:
    """The Gram matrix ``K[i, j] = |<psi(Y_i)|psi(X_j)>|^2`` built by the
    ring over ``mesh`` (every rank calls it with the same arguments and gets
    the whole ``[len_y, len_x]`` float64 matrix).

    The ring runs one iteration at a time, each timed after a device
    synchronization (``QMLTPU_RING=fused``: no synchronization between
    iterations, only the aggregate time, no snapshots). With ``checkpoint``
    and an ``info_file``, rank 0 snapshots the assembled padded K after each
    iteration to
    ``{checkpoint_dir}/checkpoint_ring_{name of info_file}.npz`` (keys ``k``
    and ``next_iter``, written atomically: the reference's file and format),
    and a restarted build resumes from it; the file is deleted at the end.
    ``sim_batch``: rows per simulation dispatch over all ranks, rounded down
    to a multiple of the mesh size. The profiling JSON (the reference's
    keys) goes to ``{info_file}.json``, written by rank 0."""
    if mesh is None:
        raise ValueError("build_kernel_matrix_sharded needs a mesh (parallel.mesh.make_mesh)")
    cfg = cfg or SimConfig()
    ring_mode = os.environ.get("QMLTPU_RING", "stepwise")
    if ring_mode not in RING_MODES:
        raise ValueError(f"QMLTPU_RING={ring_mode!r}: use one of {RING_MODES}")
    schedule = ansatz.schedule
    ndev, rank, dev = mesh.size, mesh.rank, mesh.device
    verbose = loglevel <= 20 and rank == 0

    X = np.asarray(X, dtype=np.float64)
    len_x = len(X)
    symmetric = Y is None
    Y = None if symmetric else np.asarray(Y, dtype=np.float64)
    len_y = len_x if symmetric else len(Y)

    profiling: dict = {}
    profiling["n_procs"] = [ndev, "devices"]
    profiling["lenX"] = [len_x, "entries"]
    profiling["lenY"] = [None if symmetric else len_y, "entries"]
    start = time.perf_counter()
    profiling["r0_circ_gen"] = [0.0, "seconds"]

    st = simulate_ring_states(schedule, X, Y, cfg, mesh, sim_batch)
    out_x, out_y, ax, ay = st.out_x, st.out_y, st.ax, st.ay
    len_x_padded, len_y_padded = st.len_x_padded, st.len_y_padded

    # One sample per dispatch over all ranks, the time of its slowest rank:
    # quartiles over per-block means, as in the reference.
    times = _max_over_ranks([st.sim_time, *st.block_times], mesh)
    sim_time, per_block = float(times[0]), times[1:]
    profiling["r0_circ_sim"] = [sim_time, "seconds"]
    profiling["avg_circ_sim"] = [float(np.mean(per_block)), "seconds"]
    profiling["median_circ_sim"] = [float(np.median(per_block)), "seconds"]
    profiling["q1_circ_sim"] = [float(np.percentile(per_block, 25)), "seconds"]
    profiling["q3_circ_sim"] = [float(np.percentile(per_block, 75)), "seconds"]
    profiling["stats_semantics"] = [
        "batched execution: circ_sim stats are quartiles over per-block means"
        " and product stats quartiles over per-ring-iteration means,"
        " not per-circuit/per-pair distribution quartiles",
        "",
    ]

    # Gathered over the ranks, then cut: padding rows never reach the stats.
    chi_x = to_host(out_x.bond_dims.max(dim=-1).values, mesh)[:len_x]
    fid_x = to_host(out_x.fidelity, mesh)[:len_x]
    if symmetric:
        chi_y, fid_y = chi_x, np.zeros((0,))
    else:
        chi_y = to_host(out_y.bond_dims.max(dim=-1).values, mesh)[:len_y]
        fid_y = to_host(out_y.fidelity, mesh)[:len_y]
    profiling["avg_fidelity"] = [float(np.mean(np.concatenate([fid_x, fid_y]))), ""]
    profiling["ave max chi x"] = (float(np.mean(chi_x)), "chi x")
    profiling["ave max chi y"] = (float(np.mean(chi_y)), "chi y")
    profiling["chi"] = [cfg.chi, "bond cap"]

    itemsize = 2 * torch.empty((), dtype=cfg.real_dtype).element_size()
    bytes_per_mps = _actual_mps_bytes(chi_x, schedule.num_qubits, itemsize, cfg.chi)
    total_mem = bytes_per_mps * (len_x + len_y) / (1024**2)
    profiling["gpu_mps_mem"] = [float(total_mem / ndev), "MiB"]
    profiling["avg_mps_mem"] = [float(bytes_per_mps / (1024**2)), "MiB"]
    if verbose:
        n_sim = len_x_padded + (0 if symmetric else len_y_padded)
        print(f"[mesh:{ndev}] simulated {n_sim} MPS in {sim_time:.3f}s")

    n_iters = ndev // 2 + 1 if symmetric else ndev
    fused = ring_mode == "fused"
    t0 = time.perf_counter()
    iter_times: list[float] = []
    step = make_ring_steps(mesh, n_iters, symmetric, cfg.resolved_tile_precision)
    bxl = len_x_padded // ndev
    ckpt_file = None
    start_iter = 0
    k_host = np.zeros((len_y_padded, len_x_padded),
                      dtype=np.dtype(str(cfg.real_dtype).removeprefix("torch.")))
    if checkpoint and info_file is not None and not fused:
        pathlib.Path(checkpoint_dir).mkdir(exist_ok=True)
        ckpt_file = (pathlib.Path(checkpoint_dir)
                     / f"checkpoint_ring_{pathlib.Path(info_file).name}.npz")
        if rank == 0 and ckpt_file.is_file():
            saved = np.load(ckpt_file)
            if saved["k"].shape == k_host.shape:
                k_host = saved["k"].astype(k_host.dtype)
                start_iter = int(saved["next_iter"])
                if verbose:
                    print(f"[mesh:{ndev}] ring resumed at iteration {start_iter}")
        if ndev > 1:
            # Only rank 0 reads the snapshot: broadcast the resume state so
            # that every rank enters the same transfers (divergent start
            # iterations would hang the ring).
            state = torch.tensor([start_iter], dtype=torch.int64, device=dev)
            k_all = torch.from_numpy(k_host).to(dev)
            dist.broadcast(state, 0, group=mesh.group)
            dist.broadcast(k_all, 0, group=mesh.group)
            start_iter, k_host = int(state.item()), k_all.cpu().numpy()
    k_local = torch.from_numpy(
        np.ascontiguousarray(k_host[:, rank * bxl:(rank + 1) * bxl])).to(dev)
    ay_cur = ay
    # Fast-forward the Y ring to the resume point.
    for _ in range(start_iter):
        ay_cur = _shift(mesh, ay_cur)
    for i in range(start_iter, n_iters):
        t_it = time.perf_counter()
        ay_cur, k_local = step(i, ax, ay_cur, k_local)
        if fused:
            continue  # no host sync between iterations: only the aggregate time
        _sync(dev)
        iter_times.append(time.perf_counter() - t_it)
        if ckpt_file is not None:
            k_snap = to_host(k_local, mesh)
            if rank == 0:
                tmp = ckpt_file.with_suffix(".tmp.npz")
                np.savez(tmp, k=k_snap, next_iter=i + 1)
                tmp.replace(ckpt_file)
    k = to_host(k_local, mesh)
    if ckpt_file is not None and rank == 0:
        ckpt_file.unlink(missing_ok=True)
    gram_time = time.perf_counter() - t0
    gram_time, *iter_times = map(float, _max_over_ranks([gram_time, *iter_times], mesh))

    # The single-device build's normalization: divide out <y|y><x|x>.
    if os.environ.get("QMLTPU_NORMALIZE", "1") != "0":
        if symmetric:
            # By the ring's own diagonal: exactly unit, and with the same
            # rounding as the off-diagonal tiles.
            dg = np.sqrt(np.maximum(np.diagonal(k), 0.0))
            dg = np.where(dg > 0, dg, 1.0)
            k = k / np.outer(dg, dg)
        else:
            # State norms of the padded batches, matching k's padded shape.
            n2x = to_host(state_norms_sq(ax, cfg.resolved_tile_precision), mesh)
            n2y = to_host(state_norms_sq(ay, cfg.resolved_tile_precision), mesh)
            k = k / np.outer(n2y, n2x)

    profiling["kernel_mat_time"] = [gram_time, "seconds"]
    profiling["r0_product"] = [gram_time, "seconds"]
    n_pairs = max(1, len_y_padded * len_x_padded // ndev)
    if iter_times:
        # Stepwise: one sample per iteration, per pair of the (Byl x Bxl)
        # tile each rank contracts in it.
        pairs_per_iter = max(1, (len_y_padded // ndev) * (len_x_padded // ndev))
        per_it = np.asarray(iter_times) / pairs_per_iter
        profiling["avg_product"] = [float(np.mean(per_it)), "seconds"]
        profiling["median_product"] = [float(np.median(per_it)), "seconds"]
        profiling["q1_product"] = [float(np.percentile(per_it, 25)), "seconds"]
        profiling["q3_product"] = [float(np.percentile(per_it, 75)), "seconds"]
    else:
        # The fused ring exposes only the aggregate.
        per_vdot = gram_time / n_pairs * ndev
        for key in ("avg_product", "median_product", "q1_product", "q3_product"):
            profiling[key] = [per_vdot, "seconds"]
    profiling["r_nonRR_recv"] = [0.0, "seconds"]
    profiling["r0_RR_recv"] = [0.0, "seconds"]
    profiling["total_time"] = [time.perf_counter() - start, "seconds"]
    if verbose:
        print(f"[mesh:{ndev}] gram ring done in {gram_time:.3f}s")

    if info_file is not None and rank == 0:
        with open(str(info_file) + ".json", "w") as fp:
            json.dump(profiling, fp, indent=4)

    return k[:len_y, :len_x].astype(np.float64)
