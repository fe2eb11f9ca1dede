"""Runtime scaling on the port (the reference's weak-scaling suite, from
``runs/runtime_scaling/{run_all.sh,sweep_inproc.py,weak_scaling_vmesh.py,to_csv.py,plot.py}``).

``run``, on the card: the train Gram of ``cli.main_no_test`` in this process
at nf 165, r 2, gamma 0.1, d 1, data seed 5, for each data size of ``NTRS``
(points a class): 50, 100 and 200 (``sweep_inproc.py``'s defaults), then the
paper's weak-scaling sizes 400 to 3200 (800 to 6400 points, which the paper
ran on 4 to 32 A100s) on one card. Each record goes to ``raw/`` named by
``run_info`` with the ``_m1`` suffix of ``run_all.sh``. Then, for each size
of ``RING_NTRS`` (default 100), the same call on the ring at world size 1
(``QMLTPU_MESH=1``, one rank started by ``parallel/mesh.launch``), its record
suffixed ``_m1_ring``. The data is ``cli.make_synthetic``'s set of
:data:`N_LABELED` labelled rows in the suite's ``work/datasets``, which holds
the 3200 illicit rows the largest size draws (the pinned v1 set has 500).
A small run first (``PREWARM=0`` skips it) pays the process's first-call
costs and is deleted; a record already in ``raw/`` is skipped.

``ladder``: the weak-scaling ladder of ``weak_scaling_vmesh.py``. For each
world size of ``NDEVS`` (default "1 2 4 8"), ``P_PER_DEV`` points a rank
(4), nq 100, chi 64, d 6, r 2, features drawn from numpy
``default_rng(7)`` in turn: one process a rank (``parallel/mesh.launch``) on
the device ``QMLTPU_DEVICE`` names, the Gram built twice by the ring
(``parallel/gram``), cold then warm. ``cpu`` runs gloo ranks on the host's
cores; ``cuda`` needs one card a rank, NCCL's rule, and raises with fewer.
It writes ``results_weak_scaling.csv`` with the reference's columns up to
``ici_bytes_per_step``: ``wall_s`` the warm build, ``eff_program`` =
``wall(1) / (wall(N) / N)``, ``ici_bytes_per_step`` the ring's bytes a shift
(``P n chi 2 chi`` complex64 entries, the reference's count), and
``platform`` the host and its ranks. The reference's two ``_v5e`` columns
project a TPU v5e's links and are left out: this ladder measures no
interconnect.

    python -m qml_cutensornet_tpu_torch.runs.runtime_scaling run     # on the card
    QMLTPU_DEVICE=cpu python -m qml_cutensornet_tpu_torch.runs.runtime_scaling ladder
    python -m qml_cutensornet_tpu_torch.runs.runtime_scaling csv     # results.csv
    python -m qml_cutensornet_tpu_torch.runs.runtime_scaling plot    # runtime_scaling.png

Env: ``NTRS``, ``RING_NTRS``, ``NF``, ``PREWARM``; ``NDEVS``, ``NQ``,
``CHI`` (``NF``, ``NQ`` and ``CHI`` cut a run to a test's size).
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
import time

import numpy as np

from qml_cutensornet_tpu_torch.runs import _harness as h
from qml_cutensornet_tpu_torch.runs import common
from qml_cutensornet_tpu_torch.utils.device import environ
from qml_cutensornet_tpu_torch.utils.naming import run_info

SUITE = "runtime_scaling"
N_LABELED = 11000  # 3324 illicit rows
REPS, GAMMA, D, SEED, PREWARM_NTR = 2, 0.1, 1, 5, 16
LADDER_D, P_PER_DEV = 6, 4
LADDER_CSV = "results_weak_scaling.csv"


def run() -> dict:
    """Run the sizes; returns {record name: train Gram} of the records this
    call wrote."""
    from qml_cutensornet_tpu_torch.cli import main_no_test

    nf = int(os.environ.get("NF", "165"))
    raw = h.suite_dir(SUITE) / "raw"
    raw.mkdir(parents=True, exist_ok=True)
    grams = {}
    with h.workdir(SUITE):
        df = h.synthetic_data(N_LABELED)
        data = f"cli.make_synthetic {N_LABELED} (seed 0), {df}"

        def argv(ntr):
            return ["main_no_test.py", "GPU", str(nf), str(REPS), str(GAMMA), str(D), str(ntr),
                    str(ntr), str(SEED), df]

        def info(ntr):
            return run_info("train", nf, REPS, GAMMA, D, ntr, SEED, df)

        sizes = [n for n in h.env_ints("NTRS", "50 100 200 400 800 1600 3200")
                 if not (raw / f"{info(n)}_m1.json").exists()]
        ring = [n for n in h.env_ints("RING_NTRS", "100")
                if not (raw / f"{info(n)}_m1_ring.json").exists()]
        if sizes and h.prewarm_on():
            t0 = time.perf_counter()
            h.call(main_no_test, argv(PREWARM_NTR), SUITE, info(PREWARM_NTR), prewarm=True,
                   data=data)
            h.drop(f"{info(PREWARM_NTR)}.json", f"kernels/{info(PREWARM_NTR)}.npy")
            print(f"[rs] prewarm: {time.perf_counter() - t0:.1f} s", flush=True)
        for ntr in sizes:
            t0 = time.perf_counter()
            grams[f"{info(ntr)}_m1"] = h.call(main_no_test, argv(ntr), SUITE, info(ntr),
                                              raw=f"{info(ntr)}_m1.json", data=data)
            h.keep(pathlib.Path(f"{info(ntr)}.json"), raw / f"{info(ntr)}_m1.json")
            h.drop(f"kernels/{info(ntr)}.npy")
            print(f"[rs] ntr={ntr}: {time.perf_counter() - t0:.1f} s", flush=True)
        if ring:
            grams.update(_ring_runs(ring, argv, info, raw, data))
    return grams


def _ring_runs(ntrs, argv, info, raw, data) -> dict:
    """``cli.main_no_test`` on the ring at world size 1 for each size, in one
    rank started by ``parallel/mesh.launch`` (after a prewarm call there
    unless ``PREWARM=0``); each call's line goes to ``runs.jsonl`` with the
    rank's launches and peak memory."""
    from qml_cutensornet_tpu_torch.cli import main_no_test
    from qml_cutensornet_tpu_torch.parallel import dryrun, mesh

    device = os.environ.get("QMLTPU_DEVICE", "cuda")
    prewarm = h.prewarm_on()
    sizes = ([PREWARM_NTR] if prewarm else []) + list(ntrs)
    calls = [(main_no_test.main, (argv(n),), {}, {"QMLTPU_MESH": "1"}) for n in sizes]
    t0 = time.perf_counter()
    recs = mesh.launch(dryrun.run_calls, 1, device, device, calls, timeout=3600)
    print(f"[rs] ring at world size 1: {time.perf_counter() - t0:.1f} s", flush=True)
    grams = {}
    with environ(QMLTPU_MESH="1"):
        if prewarm:
            rec, recs = recs[0], recs[1:]
            h.log_run(SUITE, argv(PREWARM_NTR), rec["seconds"], rec["peak_bytes"],
                      rec["launches"], rec["stdout"], info(PREWARM_NTR), prewarm=True, mesh=1,
                      data=data)
            h.drop(f"{info(PREWARM_NTR)}.json", f"kernels/{info(PREWARM_NTR)}.npy")
        for ntr, rec in zip(ntrs, recs):
            h.log_run(SUITE, argv(ntr), rec["seconds"], rec["peak_bytes"], rec["launches"],
                      rec["stdout"], info(ntr), raw=f"{info(ntr)}_m1_ring.json", mesh=1,
                      data=data)
            h.keep(pathlib.Path(f"{info(ntr)}.json"), raw / f"{info(ntr)}_m1_ring.json")
            h.drop(f"kernels/{info(ntr)}.npy")
            grams[f"{info(ntr)}_m1_ring"] = rec["out"]
    return grams


def _ladder_rank(device: str, feats: np.ndarray, nq: int, reps: int, d: int, chi: int) -> dict:
    """One rank of a ladder rung: the ring's Gram of ``feats`` built twice
    (cold, warm) over this process group. Rank 0's result: the warm Gram,
    both wall times (after a device synchronization), the warm build's
    profile and the kernels' launches of each build."""
    import torch

    from qml_cutensornet_tpu_torch.config import SimConfig
    from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
    from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
    from qml_cutensornet_tpu_torch.ops import _build
    from qml_cutensornet_tpu_torch.parallel.gram import build_kernel_matrix_sharded
    from qml_cutensornet_tpu_torch.parallel.mesh import make_mesh

    m = make_mesh(device=device)
    ansatz = KernelStateAnsatz(nq, reps, 1.0, entanglement_graph(nq, d))
    cfg = SimConfig(chi=chi, precision="f32")
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="ladder_")) if m.rank == 0 else None
    out = {}
    try:
        for build in ("cold", "warm"):
            info = None if tmp is None else str(tmp / build)
            _build.reset_counters()
            t0 = time.perf_counter()
            k = build_kernel_matrix_sharded(ansatz, feats, cfg=cfg, mesh=m, info_file=info)
            if m.device.type == "cuda":
                torch.cuda.synchronize(m.device)
            out[f"{build}_s"] = time.perf_counter() - t0
            out[f"{build}_launches"] = dict(_build.LAUNCHES)
        if tmp is not None:
            out["profile"] = json.loads((tmp / "warm.json").read_text())
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    out["K"] = k
    return out


def ladder() -> dict:
    """Run the ladder and write its CSV; returns ``{"rows": the CSV's rows,
    "grams": {world size: Gram}, "features": {world size: features}}``."""
    import torch

    from qml_cutensornet_tpu_torch.parallel import mesh

    device = os.environ.get("QMLTPU_DEVICE", "cuda")
    ndevs = h.env_ints("NDEVS", "1 2 4 8")
    p, d, reps = P_PER_DEV, LADDER_D, REPS
    nq = int(os.environ.get("NQ", "100"))
    chi = int(os.environ.get("CHI", "64"))
    kind = torch.device(device).type
    if kind == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if max(ndevs) > cards:
            raise RuntimeError(
                f"ladder: world size {max(ndevs)} on {device} needs {max(ndevs)} cards, one a "
                f"rank (NCCL runs one rank a card), and this host has {cards}; run the larger "
                "rungs over gloo with QMLTPU_DEVICE=cpu")
        platform = f"{torch.cuda.get_device_name(0)}, NCCL ranks"
    elif kind == "cpu":
        platform = f"CPU ({os.cpu_count()} cores), gloo ranks"
    else:
        raise ValueError(f"ladder: unsupported device {device!r}: use 'cuda' or 'cpu'")
    out_dir = h.suite_dir(SUITE)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(7)
    rows, grams, features = [], {}, {}
    wall1 = None
    for n in ndevs:
        b = p * n
        feats = rng.uniform(0.0, 2.0, size=(b, nq)).astype(np.float32)
        t0 = time.perf_counter()
        res = mesh.launch(_ladder_rank, n, device, device, feats, nq, reps, d, chi,
                          timeout=3600)
        launch_s = time.perf_counter() - t0
        k = res["K"]
        if k.shape != (b, b) or abs(np.diag(k) - 1).max() >= 1e-4:
            raise RuntimeError(f"ladder, {n} ranks: Gram {k.shape} off its unit diagonal")
        warm = res["warm_s"]
        wall1 = warm if wall1 is None else wall1
        row = {"n_procs": n, "points": b, "points_per_device": p, "nq": nq, "chi": chi, "d": d,
               "layers": reps, "wall_s": round(warm, 3), "cold_s": round(res["cold_s"], 3),
               "eff_program": round(wall1 / (warm / n), 4),
               "ici_bytes_per_step": p * nq * chi * 2 * chi * 8, "platform": platform}
        rows.append(row)
        grams[n], features[n] = k, feats
        prof = res["profile"]
        line = {"ladder": n, **row, "wall_s": warm, "cold_s": res["cold_s"], "launch_s": launch_s,
                "sim_s": prof["r0_circ_sim"][0], "ring_s": prof["kernel_mat_time"][0],
                "avg_max_chi": common.avg_max_chi(prof),
                "avg_fidelity": prof["avg_fidelity"][0], "launches": res["warm_launches"],
                "cold_launches": res["cold_launches"], "card": h.card() if kind == "cuda" else None}
        with open(out_dir / "runs.jsonl", "a") as fp:
            fp.write(json.dumps(line) + "\n")
        print(json.dumps(row), flush=True)
    common.write_csv(rows, str(out_dir / LADDER_CSV))
    return {"rows": rows, "grams": grams, "features": features}


def csv() -> list[dict]:
    out = h.suite_dir(SUITE)
    rows = common.runtime_scaling_csv(str(out / "raw"), str(out / "results.csv"))
    print((out / "results.csv").read_text())
    return rows


def plot() -> None:
    """The runtime of each data size, stacked: MPS simulation, inner
    products, communication (``runs/runtime_scaling/plot.py``'s bars, in
    seconds)."""
    out = h.suite_dir(SUITE)
    rows = common.read_csv(str(out / "results.csv"))
    rows.sort(key=lambda r: (int(r["n_procs"]), int(r["licit_data"]), r["data_set"]))
    labels = [f"{2 * int(r['licit_data'])} / {r['n_procs']}"
              + (" ring" if r["data_set"].endswith("_ring") else "") for r in rows]
    mps = np.array([float(r["mps_wall_time"]) for r in rows])
    dot = np.array([float(r["dot_wall_time"]) for r in rows])
    mpi = np.array([float(r["mpi_wall_time"]) for r in rows])
    plt = h.pyplot()
    fig, ax = plt.subplots(figsize=(max(6.4, 0.9 * len(rows)), 4.8))
    ax.bar(labels, mpi, bottom=mps + dot, label="Communication", color="#2a7f62", alpha=0.7)
    ax.bar(labels, dot, bottom=mps, label="Inner products", color="#e8903a", alpha=0.7)
    ax.bar(labels, mps, label="MPS simulation", color="#3a5fe8", alpha=0.7)
    ax.set_xlabel("Data size / num. devices", fontsize=11)
    ax.set_ylabel("Runtime (s)", fontsize=11)
    ax.set_title(f"Train-Gram build, nf 165, r 2, gamma 0.1, d 1 (1 {h.card_title(SUITE)})")
    ax.legend(fontsize=10)
    fig.savefig(out / "runtime_scaling.png", dpi=150, bbox_inches="tight")
    plt.close(fig)


def main(argv=None) -> None:
    h.dispatch(argv, run, csv, plot, ladder=ladder)


if __name__ == "__main__":
    main()
