"""CPU backend: static tile scheduling over the native C++ MPS engine (port
of ``qml_cutensornet_tpu/backends/cpu_native.py``).

The original CPU backend's distribution strategy: tile the lenY x lenX
kernel matrix into about ``number_of_tiles`` square tiles (default 4x the
worker count), drop the upper-triangle tiles when Y == X (mirrored by
transpose), compute each tile natively (``native.compute_tile``, on the
circuits of ``KernelStateAnsatz.circuit_for_data``), checkpoint after every
tile to ``{checkpoint_dir}/checkpoint_rank_0_{name of info_file}.npy`` and
resume from it, and write the CPU profiling JSON. The native library's
OpenMP threads work the circuits of a tile.
"""

from __future__ import annotations

import json
import pathlib
import time
from statistics import mean, median

import numpy as np

from qml_cutensornet_tpu_torch import native
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz


def build_kernel_matrix(
    ansatz: KernelStateAnsatz,
    X,
    Y=None,
    info_file: str = "info_file",
    truncation_error: float = 1e-16,
    number_of_tiles: int | None = None,
    n_workers: int = 1,
    chi_cap: int = 0,
    checkpoint_dir: str = "tmp",
    verbose: bool = False,
) -> np.ndarray:
    """``K[i, j] = |<psi(Y_i)|psi(X_j)>|^2`` on the native engine, with the
    static tile scheduler, its checkpoint and resume, and the CPU profiling
    JSON (``{info_file}.json``). ``chi_cap`` 0: no bond cap."""
    X = np.asarray(X, dtype=np.float64)
    len_x = len(X)
    symmetric = Y is None
    Yarr = X if symmetric else np.asarray(Y, dtype=np.float64)
    len_y = len(Yarr)
    if len_x < len_y:
        raise ValueError("X must not be smaller than Y. Swap input order and transpose output.")

    number_of_tiles = number_of_tiles if number_of_tiles is not None else 4 * n_workers
    tile_side = max(1, int(np.floor(np.sqrt(len_x * len_y / number_of_tiles))))
    x_slices = -(-len_x // tile_side)
    y_slices = -(-len_y // tile_side)
    tiles = [
        (
            (ys * tile_side, min(len_y, (ys + 1) * tile_side)),
            (xs * tile_side, min(len_x, (xs + 1) * tile_side)),
        )
        for ys in range(y_slices)
        for xs in range(x_slices)
    ]
    n_tiles = len(tiles)
    if symmetric:  # keep only tiles with x_start <= y_start
        tiles = [t for t in tiles if t[1][0] <= t[0][0]]

    # Every circuit lowered once.
    x_circs = [ansatz.circuit_for_data(X[i]) for i in range(len_x)]
    y_circs = x_circs if symmetric else [ansatz.circuit_for_data(Yarr[i]) for i in range(len_y)]

    pathlib.Path(checkpoint_dir).mkdir(exist_ok=True)
    ckpt = pathlib.Path(checkpoint_dir) / f"checkpoint_rank_0_{pathlib.Path(info_file).name}.npy"

    profiling: dict = {}
    profiling["lenX"] = (len_x, "entries")
    profiling["lenY"] = (None if symmetric else len_y, "entries")
    profiling["n_tiles"] = (n_tiles, "tiles")
    profiling["truncation_error"] = (truncation_error, "")
    profiling["vdots_per_tile"] = (tile_side**2, "entries")

    if ckpt.is_file():
        kernel_mat = np.load(ckpt)
        if verbose:
            print("[Rank 0] Recovered from checkpoint!")
    else:
        kernel_mat = np.zeros((len_y, len_x))

    tile_times, sim_times, vdot_times = [], [], []
    all_chi_x, all_chi_y = [], []
    start_time = time.perf_counter()
    nq = ansatz.num_qubits
    for (y_slice, x_slice) in tiles:
        if kernel_mat[y_slice[0], x_slice[0]] != 0:
            continue  # already in the checkpoint
        t0 = time.perf_counter()
        xs = x_circs[x_slice[0] : x_slice[1]]
        ys = y_circs[y_slice[0] : y_slice[1]]
        same = symmetric and x_slice == y_slice
        tile, chi_x, chi_y, _, _, timings = native.compute_tile(
            nq, xs, None if same else ys, cutoff=truncation_error, chi_cap=chi_cap
        )
        kernel_mat[y_slice[0] : y_slice[1], x_slice[0] : x_slice[1]] = tile
        if symmetric and x_slice[0] != y_slice[0]:
            kernel_mat[x_slice[0] : x_slice[1], y_slice[0] : y_slice[1]] = tile.T
        all_chi_x += [int(c) for c in chi_x]
        all_chi_y += [int(c) for c in chi_y]
        sim_times.append(float(timings[0]))
        vdot_times.append(float(timings[1]))
        tile_times.append(time.perf_counter() - t0)
        ckpt.unlink(missing_ok=True)
        np.save(ckpt, kernel_mat)

    total_time = time.perf_counter() - start_time
    profiling["total_time"] = (total_time, "seconds")
    if tile_times:
        per_circ = [t / max(1, tile_side) for t in sim_times]
        per_dot = [t / max(1, tile_side**2) for t in vdot_times]
        profiling["median_tile_time"] = (float(median(tile_times)), "seconds")
        profiling["median_circ_sim"] = (float(median(per_circ)), "seconds")
        profiling["q1_circ_sim"] = (float(np.percentile(per_circ, 25)), "seconds")
        profiling["q3_circ_sim"] = (float(np.percentile(per_circ, 75)), "seconds")
        profiling["median_product"] = (float(median(per_dot)), "seconds")
        profiling["q1_product"] = (float(np.percentile(per_dot, 25)), "seconds")
        profiling["q3_product"] = (float(np.percentile(per_dot, 75)), "seconds")
        profiling["ave max chi x"] = (float(mean(all_chi_x)), "chi x")
        profiling["ave max chi y"] = (float(mean(all_chi_y)), "chi y")

    with open(str(info_file) + ".json", "w") as fp:
        json.dump(profiling, fp, indent=4)
    ckpt.unlink(missing_ok=True)
    return kernel_mat
