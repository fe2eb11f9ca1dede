"""Gram (kernel) matrix construction (port of
``qml_cutensornet_tpu/models/gram.py``: ``simulate_dataset``, ``_pad_rows``,
``_chi_bucket``, ``_tile_ranges``, ``_auto_tile``, ``build_kernel_matrix``).

``build_kernel_matrix(ansatz, X, ...)`` returns ``K[i, j] = |<psi(Y_i)|
psi(X_j)>|^2`` with the reference's contract: ``Y=None`` means ``Y == X``
and only the lower block-triangle of tiles is computed (the rest mirrored);
the symmetric result is normalized by the tile path's own diagonal; a
profiling JSON with the reference's keys goes to ``{info_file}.json``.
The simulated states stay on the compute device while the reference's
projection of their assembled footprint fits ``QMLTPU_STATES_DEVICE_BYTES``
(:func:`states_regime`); past it they live in host memory and the tile loop
uploads one block a tile, trimmed to the tile's own chi bucket. With
``checkpoint`` (and an ``info_file``) the tile loop saves the padded Gram to
``{checkpoint_dir}/checkpoint_{name of info_file}.npy`` after each tile (at
most every ``QMLTPU_CKPT_INTERVAL`` seconds), atomically, and resumes from
it: the reference's file and format, so a checkpoint either package wrote
resumes in the other. With a ``mesh`` (``parallel/mesh.make_mesh``, one
process per device) the build goes to the multi-device ring,
``parallel/gram.build_kernel_matrix_sharded``, as in the reference.
"""

from __future__ import annotations

import json
import os
import pathlib
import time
from statistics import mean, median

import numpy as np
import torch

from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.simulate import (
    make_chunked_simulator,
    state_norms_sq,
    tile_overlaps_sq,
)
from qml_cutensornet_tpu_torch.parallel.mesh import process_index
from qml_cutensornet_tpu_torch.utils.device import resolve_device


def _pad_rows(arr: np.ndarray, multiple: int) -> np.ndarray:
    n = arr.shape[0]
    target = -(-n // multiple) * multiple
    if target == n:
        return arr
    pad = np.repeat(arr[:1], target - n, axis=0)
    return np.concatenate([arr, pad], axis=0)


def _chi_bucket(max_chi: int, padded_chi: int) -> int:
    """Smallest multiple-of-64 chi >= the batch's tracked rank (floored at
    128), capped at the simulator's padding. Slicing to it is lossless:
    bond padding beyond each bond's kept rank is exact zeros."""
    b = max(128, -(-int(max_chi) // 64) * 64)
    return min(b, padded_chi)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


STATES_DEVICE_BYTES = 41e9  # derivation: simulate_dataset's docstring


def states_regime(buckets, batch_shape, n_batches: int, itemsize: int, limit: float) -> str:
    """Where the simulated states live, by the reference's rule
    (``qml_cutensornet_tpu/models/gram.py`` ``simulate_dataset``): "device"
    while the projected footprint of the assembled set fits ``limit``, else
    "host". The projection is ``2`` (the concatenation's copy) x
    ``n_batches`` batches of ``batch_shape`` = (sim batch, sites) states at
    the largest chi bucket of ``buckets`` (those seen so far), ``[n, c, 2,
    c]`` elements of ``itemsize`` bytes (complex) each: the reference's byte
    count for its (re, im) pairs of the same shapes. Buckets only grow, so
    once "host" the rule stays "host"."""
    sim_batch, n_sites = batch_shape
    c_max = max(buckets)
    projected = 2 * n_batches * sim_batch * n_sites * c_max * 2 * c_max * itemsize
    return "device" if projected <= limit else "host"


def simulate_dataset(schedule, features: np.ndarray, cfg: SimConfig, sim_batch: int,
                     device: torch.device, site_mesh=None):
    """Simulate all datapoint circuits ``sim_batch`` at a time on ``device``
    (``schedule`` a tracked ``GateSchedule`` or a ``BrickSchedule``; both
    simulators return an ``MPS`` over the ``num_qubits`` real sites).
    Returns (tensors [N, n, c, 2, c], fidelities [N] numpy, max_chis [N]
    numpy, per-batch seconds, regime): ``c`` the largest chi bucket
    (:func:`_chi_bucket`), ``regime`` "device" or "host", where the tensors
    are.

    Each batch is sliced to its own chi bucket (lossless: bond padding is
    exact zeros), then :func:`states_regime` decides, again after every
    batch, from the largest bucket so far and ``QMLTPU_STATES_DEVICE_BYTES``
    (default ``STATES_DEVICE_BYTES``). When it turns to "host" the batches
    kept on the device move to pageable host memory, and every later batch
    goes there once simulated, which frees its device memory before the
    next batch runs. Host batches are assembled on the host and uploaded
    whole only if the set's bytes fit the limit.

    The default, 41e9 B, is one H100 80GB HBM3's memory (power limit
    700.00 W; ``utils/residency_probe.py peak``, one run) less what the rest
    of the build needs beside the states:

    - 85017493504 B, the card (``total_memory``);
    - less 9.2e9 B, the tile budget (``QMLTPU_TILE_BYTES``, :func:`_auto_tile`);
    - less 26843688448 B, one sim batch's peak at the largest chi run: nf
      100, d 10, chi 512, the CLI's sim batch of 32, staged,
      ``max_memory_allocated`` above the start (2.0x the batch's 13.4 GB
      state: a feature layer writes a new state beside the old one);
    - less 5187760640 B, the allocator's reserve above that peak;
    - less 2e9 B, a margin for the CUDA context and cuBLAS workspaces;

    = 41.786e9 B, rounded down. The reference reads the same variable with
    a default of 10e9 for a 16 GB TPU v5e; its projection counts the same
    bytes, so one value puts both packages in the same regime."""
    n_pts = features.shape[0]
    padded = _pad_rows(np.asarray(features, dtype=np.float64), sim_batch)
    sim = make_chunked_simulator(schedule, cfg, device, site_mesh=site_mesh)
    limit = float(os.environ.get("QMLTPU_STATES_DEVICE_BYTES", STATES_DEVICE_BYTES))
    n_batches = padded.shape[0] // sim_batch
    host = torch.device("cpu")
    regime = "device"
    tensors, fids, chis, batch_times, buckets = [], [], [], [], []
    for start in range(0, padded.shape[0], sim_batch):
        chunk = padded[start: start + sim_batch]
        t0 = time.perf_counter()
        out = sim(chunk)
        _sync(device)
        batch_times.append(time.perf_counter() - t0)
        batch_chis = out.bond_dims.max(dim=1).values.cpu().numpy()
        t = out.tensors
        c = _chi_bucket(int(batch_chis.max(initial=1)), t.shape[2])
        buckets.append(c)
        if c < t.shape[2]:
            t = t[:, :, :c, :, :c].contiguous()  # a copy: the padded batch can go
        fids.append(out.fidelity.cpu().numpy())
        chis.append(batch_chis)
        del out
        regime = states_regime(buckets, (sim_batch, t.shape[1]), n_batches, t.element_size(),
                               limit)
        if regime == "host":
            tensors = [p.to(host) for p in tensors]
            t = t.to(host)
        tensors.append(t)
    c = max(buckets)

    def pad_to_bucket(p):  # exact zeros
        if p.shape[2] == c:
            return p
        return torch.nn.functional.pad(p, (0, c - p.shape[4], 0, 0, 0, c - p.shape[2]))

    tensors = torch.cat([pad_to_bucket(t) for t in tensors], dim=0)[:n_pts]
    if regime == "host" and tensors.nbytes <= limit:
        tensors, regime = tensors.to(device), "device"
    fids = np.concatenate(fids)[:n_pts]
    chis = np.concatenate(chis)[:n_pts]
    return tensors, fids, chis, batch_times, regime


def _tile_ranges(n: int, tile: int):
    return [(s, min(n, s + tile)) for s in range(0, n, tile)]


def _auto_tile(tile: int, chi: int, n: int, site_block: int = 1) -> int:
    """Clamp the requested tile so one tile's live set (state blocks, carry,
    site-block temporaries) fits ``QMLTPU_TILE_BYTES`` (default 9.2e9); the
    same model as the reference's."""
    budget = float(os.environ.get("QMLTPU_TILE_BYTES", "9.2e9"))
    k = max(1, site_block)
    t = tile
    while t > 2:
        pad = max(1, 128 // t)
        carry = 4 * t * t * chi * chi * (2 * pad + 2)
        blocks = 2 * (8 * t * n * 2 * chi * chi)
        combined = (blocks * (2 ** k)) // (2 * k) if k > 1 else 0
        temps = 8 * t * t * chi * chi * (2 ** k) if k > 1 else 0
        if carry + blocks + combined + temps <= budget:
            break
        t = t - 8 if t > 8 else t // 2
    return t


def build_kernel_matrix(
    ansatz: KernelStateAnsatz,
    X,
    Y=None,
    info_file=None,
    truncation_error=None,
    loglevel: int = 30,
    cfg: SimConfig | None = None,
    sim_batch: int = 32,
    tile: int = 32,
    mesh=None,
    site_mesh=None,
    checkpoint: bool = False,
    checkpoint_dir: str = "tmp",
    device: str = "cuda",
) -> np.ndarray:
    """``K[i, j] = |<psi(Y_i)|psi(X_j)>|^2`` for all pairs, computed on
    ``device`` ("cuda" or "cpu"; no fallback). With ``mesh`` the ring over
    the mesh's ranks builds it on their devices (``tile`` unused). With
    ``site_mesh`` (``parallel/mesh.make_site_mesh``) the brick engine runs
    site-sharded over that mesh and every rank builds the whole K from the
    gathered states; it excludes ``mesh``."""
    X = np.asarray(X, dtype=np.float64)
    if Y is not None and len(X) < len(np.asarray(Y)):
        raise ValueError(
            "X must not be smaller than Y. Swap input order and transpose output."
        )
    if cfg is None:
        if truncation_error is None:
            raise ValueError("You must specify a truncation error.")
        cfg = SimConfig(truncation_error=truncation_error)
    if mesh is not None:
        if site_mesh is not None:
            raise ValueError("mesh (the ring) and site_mesh exclude each other")
        from qml_cutensornet_tpu_torch.parallel.gram import build_kernel_matrix_sharded

        if torch.device(device).type != mesh.device.type:
            raise ValueError(f"device {device!r} but the mesh runs on {mesh.device}")
        return build_kernel_matrix_sharded(
            ansatz, X, Y, info_file=info_file, cfg=cfg, mesh=mesh, loglevel=loglevel,
            checkpoint=checkpoint, checkpoint_dir=checkpoint_dir, sim_batch=sim_batch,
        )
    dev = resolve_device(device)
    # Inside a process group (the site-sharded engine's) every rank builds
    # the same K; rank 0 alone writes the files.
    writer = process_index() == 0
    verbose = loglevel <= 20 and writer
    schedule = ansatz.schedule
    len_x = len(X)
    len_y = len_x if Y is None else len(np.asarray(Y))

    profiling: dict = {}
    # The site mesh's ranks (its world size); one device otherwise.
    n_procs = 1 if site_mesh is None else site_mesh.size * site_mesh.dp
    profiling["n_procs"] = [n_procs, "devices"]
    profiling["lenX"] = [len_x, "entries"]
    profiling["lenY"] = [None if Y is None else len_y, "entries"]
    start_time = time.perf_counter()

    profiling["r0_circ_gen"] = [0.0, "seconds"]
    ax, fid_x, chi_x, times_x, at_x = simulate_dataset(schedule, X, cfg, sim_batch, dev,
                                                       site_mesh)
    if Y is not None:
        ay, fid_y, chi_y, times_y, at_y = simulate_dataset(
            schedule, np.asarray(Y, dtype=np.float64), cfg, sim_batch, dev, site_mesh)
    else:
        ay, fid_y, chi_y, times_y, at_y = ax, fid_x, chi_x, [], at_x

    sim_times = times_x + times_y
    n_batches_pts = [min(sim_batch, len_x)] * len(times_x) + [
        min(sim_batch, len_y)] * len(times_y)
    per_circ = [t / p for t, p in zip(sim_times, n_batches_pts) for _ in range(p)]
    profiling["r0_circ_sim"] = [sum(sim_times), "seconds"]
    profiling["avg_circ_sim"] = [mean(per_circ), "seconds"]
    profiling["median_circ_sim"] = [median(per_circ), "seconds"]
    profiling["q1_circ_sim"] = [float(np.percentile(per_circ, 25)), "seconds"]
    profiling["q3_circ_sim"] = [float(np.percentile(per_circ, 75)), "seconds"]
    profiling["stats_semantics"] = [
        "batched execution: circ_sim quartiles are over per-batch means"
        " (within-batch times are not individually observable);"
        " product quartiles are over per-tile means",
        "",
    ]
    profiling["chi"] = [cfg.chi, "bond cap"]
    itemsize = 2 * torch.empty((), dtype=cfg.real_dtype).element_size()
    bytes_per_mps = _actual_mps_bytes(chi_x, schedule.num_qubits, itemsize, cfg.chi)
    total_mem = (bytes_per_mps * (len_x + len_y)) / (1024**2)
    profiling["gpu_mps_mem"] = [float(total_mem), "MiB"]
    profiling["avg_mps_mem"] = [float(total_mem / (len_x + len_y)), "MiB"]
    all_fids = np.concatenate([fid_x, fid_y]) if Y is not None else fid_x
    profiling["avg_fidelity"] = [float(np.mean(all_fids)), ""]
    profiling["ave max chi x"] = (float(np.mean(chi_x)), "chi x")
    profiling["ave max chi y"] = (float(np.mean(chi_y)), "chi y")
    profiling["r_nonRR_recv"] = [0.0, "seconds"]
    profiling["r0_RR_recv"] = [0.0, "seconds"]

    if verbose:
        print(f"Simulated {len_x + (len_y if Y is not None else 0)} MPS "
              f"in {sum(sim_times):.3f}s (avg chi {np.mean(chi_x):.1f}).")

    # Tiles: pad the state batches to tile multiples with exact-zero states
    # (zero overlaps, sliced away before normalization). Host-resident
    # states are not padded: each uploaded block is, on the device, so that
    # neither a host copy of the set nor zero states cross the bus.
    tiling_start = time.perf_counter()
    tile = _auto_tile(tile, max(ax.shape[2], ay.shape[2]), ax.shape[1],
                      site_block=cfg.tile_block)
    len_y_pad = -(-len_y // tile) * tile
    len_x_pad = -(-len_x // tile) * tile

    def pad_states(t: torch.Tensor, target: int) -> torch.Tensor:
        if t.shape[0] == target:
            return t
        return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 1) + (0, target - t.shape[0]))

    if at_y == "device":
        ay = pad_states(ay, len_y_pad)
    if at_x == "device":
        ax = pad_states(ax, len_x_pad)
    kernel_mat = np.zeros((len_y_pad, len_x_pad))
    ckpt_file = None
    ckpt_interval = float(os.environ.get("QMLTPU_CKPT_INTERVAL", "0"))
    last_ckpt = -float("inf")  # the first finished tile always saves
    if checkpoint and info_file is not None:
        pathlib.Path(checkpoint_dir).mkdir(exist_ok=True)
        ckpt_file = (pathlib.Path(checkpoint_dir)
                     / f"checkpoint_{pathlib.Path(info_file).name}.npy")
        if ckpt_file.is_file():
            loaded = np.load(ckpt_file)
            if loaded.shape == kernel_mat.shape:
                kernel_mat = loaded
                if verbose:
                    print("Recovered from checkpoint!")
            elif verbose:
                # Another tile size: other tile boundaries, so the corner
                # test below could take a half-covered tile for a finished
                # one. Discarded and recomputed.
                print(f"Checkpoint shape {loaded.shape} != {kernel_mat.shape} (tile size "
                      "changed); discarding it and recomputing.")
    vdot_time: list[float] = []
    tile_pairs: list[int] = []
    upload_time = 0.0
    symmetric = Y is None

    def block(states, at, r0, r1, c_t):
        # A host-resident block: its rows trimmed to the tile's bucket,
        # uploaded, then padded to the tile's rows with zero states.
        if at == "device":
            return states[r0:r1]
        return pad_states(states[r0:r1, :, :c_t, :, :c_t].to(dev), r1 - r0)

    for (y0, y1) in _tile_ranges(len_y_pad, tile):
        for (x0, x1) in _tile_ranges(len_x_pad, tile):
            if symmetric and x0 > y0:
                continue  # upper block-triangle comes from the mirror
            if ckpt_file is not None and kernel_mat[y0, x0] != 0:
                continue  # the tile is in the checkpoint
            t0 = time.perf_counter()
            # The tile's own bucket: the largest tracked chi of its rows and
            # columns (lossless, exact-zero padding), so that one
            # cap-saturating state elsewhere does not widen every upload.
            # Capped by the wider of the two sets (the reference caps by Y's,
            # which would cut X states tracked past Y's bucket).
            c_t = _chi_bucket(max(chi_y[y0:min(y1, len_y)].max(initial=1),
                                  chi_x[x0:min(x1, len_x)].max(initial=1)),
                              max(ay.shape[2], ax.shape[2]))
            ay_blk = block(ay, at_y, y0, y1, c_t)
            # A symmetric diagonal tile uploads its block once, for both sides.
            ax_blk = ay_blk if (symmetric and x0 == y0) else block(ax, at_x, x0, x1, c_t)
            if "host" in (at_x, at_y):
                _sync(dev)
                upload_time += time.perf_counter() - t0
            out = tile_overlaps_sq(ay_blk, ax_blk, precision=cfg.resolved_tile_precision,
                                   site_block=cfg.tile_block)
            out = out.cpu().numpy()
            vdot_time.append(time.perf_counter() - t0)
            tile_pairs.append(max(1, (min(y1, len_y) - y0) * (min(x1, len_x) - x0)))
            kernel_mat[y0:y1, x0:x1] = out
            if symmetric and x0 < y0:
                kernel_mat[x0:x1, y0:y1] = out.T
            if (ckpt_file is not None and writer
                    and time.perf_counter() - last_ckpt >= ckpt_interval):
                # Atomic: a crash mid-save leaves the previous checkpoint.
                tmp = ckpt_file.with_suffix(".tmp.npy")
                np.save(tmp, kernel_mat)
                tmp.replace(ckpt_file)
                last_ckpt = time.perf_counter()
    if ckpt_file is not None and writer:
        ckpt_file.unlink(missing_ok=True)
    kernel_mat = kernel_mat[:len_y, :len_x]

    # Normalize out the states' norm deficits. Symmetric case: by the tile
    # path's OWN diagonal (unit diagonal by construction, same rounding as
    # the off-diagonal tiles); otherwise by separately computed state norms,
    # ``tile`` states at a time.
    if os.environ.get("QMLTPU_NORMALIZE", "1") != "0":
        if Y is None:
            dg = np.sqrt(np.maximum(np.diag(kernel_mat), 0.0))
            dg = np.where(dg > 0, dg, 1.0)
            kernel_mat = kernel_mat / np.outer(dg, dg)
        else:
            prec = cfg.resolved_tile_precision
            n2x, up_x = _norms_chunked(ax, at_x, tile, dev, prec)
            n2y, up_y = _norms_chunked(ay, at_y, tile, dev, prec)
            upload_time += up_x + up_y
            kernel_mat = kernel_mat / np.outer(n2y[:len_y], n2x[:len_x])

    tiling_duration = time.perf_counter() - tiling_start
    total_duration = time.perf_counter() - start_time
    per_vdot = [t / p for t, p in zip(vdot_time, tile_pairs)]
    profiling["kernel_mat_time"] = [tiling_duration, "seconds"]
    profiling["total_time"] = [total_duration, "seconds"]
    profiling["r0_product"] = [sum(vdot_time), "seconds"]
    if per_vdot:
        profiling["avg_product"] = [mean(per_vdot), "seconds"]
        profiling["median_product"] = [median(per_vdot), "seconds"]
        profiling["q1_product"] = [float(np.percentile(per_vdot, 25)), "seconds"]
        profiling["q3_product"] = [float(np.percentile(per_vdot, 75)), "seconds"]

    if verbose:
        print(f"States {at_x}-resident"
              + ("" if Y is None else f" (Y {at_y}-resident)")
              + f": tiles {tiling_duration:.3f} s, of them uploads {upload_time:.3f} s.")
    if info_file is not None and writer:
        with open(str(info_file) + ".json", "w") as fp:
            json.dump(profiling, fp, indent=4)
    return kernel_mat


def _norms_chunked(a: torch.Tensor, at: str, chunk: int, device: torch.device,
                   precision: str = "highest"):
    """Squared norms of the states ``a`` (where ``at`` says), ``chunk`` at a
    time, each chunk uploaded when the states are host-resident, the
    products at ``precision``. Returns (norms [N] numpy, upload seconds)."""
    out, upload = [], 0.0
    for s in range(0, a.shape[0], chunk):
        blk = a[s:s + chunk]
        if at == "host":
            t0 = time.perf_counter()
            blk = blk.to(device)
            _sync(device)
            upload += time.perf_counter() - t0
        out.append(state_norms_sq(blk, precision).cpu().numpy())
    return np.concatenate(out), upload


def _actual_mps_bytes(max_chis, n_sites, itemsize, chi_cap):
    """Rough unpadded memory estimate per MPS (bond dims ramp up as
    min(2^k, 2^(n-k), chi))."""
    chi = float(np.mean(max_chis)) if len(np.atleast_1d(max_chis)) else 1.0
    total = 0.0
    for k in range(n_sites):
        left = min(2.0**k, 2.0 ** (n_sites - k), chi)
        right = min(2.0 ** (k + 1), 2.0 ** (n_sites - k - 1), chi)
        total += left * 2 * right
    return total * itemsize
