"""AUC against qubit count on the port (the reference's Figures 9 and 10,
from ``runs/qml_figures/{run_all.sh,plot.py}``): nf 15, 50, 100, 165 x
150, 750, 3200 points a class, r 2, gamma 0.1, d 1, data seed 5, the full
classification run of ``cli.main`` in this process, on
``cli.make_synthetic``'s 8000 labelled rows; the train and test metric
``.npy`` files go to ``raw/``.

    python -m qml_cutensornet_tpu_torch.runs.qml_figures run   # on the card
    python -m qml_cutensornet_tpu_torch.runs.qml_figures csv   # results.csv
    python -m qml_cutensornet_tpu_torch.runs.qml_figures plot  # qml_figures.png

Env: ``NTRS``, ``NFS``. A run whose test metrics are in ``raw/`` is
skipped.
"""

from __future__ import annotations

import os
import pathlib
import time

import numpy as np

from qml_cutensornet_tpu_torch.runs import _harness as h
from qml_cutensornet_tpu_torch.runs import common
from qml_cutensornet_tpu_torch.utils.naming import parse_run_info, run_info

SUITE = "qml_figures"
N_LABELED = 8000
REPS, GAMMA, D, SEED = 2, 0.1, 1, 5


def run() -> list:
    """Run the grid; returns the test records this call wrote."""
    from qml_cutensornet_tpu_torch.cli import main as qmain

    raw = h.suite_dir(SUITE) / "raw"
    raw.mkdir(parents=True, exist_ok=True)
    wrote = []
    with h.workdir(SUITE):
        df = h.synthetic_data(N_LABELED)
        for ntr in h.env_ints("NTRS", "150 750 3200"):
            for nf in h.env_ints("NFS", "15 50 100 165"):
                info = run_info("test", nf, REPS, GAMMA, D, ntr, SEED, df)
                if (raw / f"{info}.npy").exists():
                    print(f"[qml] ntr={ntr} nf={nf}: present, skip", flush=True)
                    continue
                t0 = time.perf_counter()
                argv = ["main.py", "GPU", str(nf), str(REPS), str(GAMMA), str(D), str(ntr),
                        str(ntr), str(SEED), df]
                h.call(qmain, argv, SUITE, run_info("train", nf, REPS, GAMMA, D, ntr, SEED, df))
                for kind in ("train", "test"):
                    ri = run_info(kind, nf, REPS, GAMMA, D, ntr, SEED, df)
                    h.keep(pathlib.Path("data", f"{ri}.npy"), raw / f"{ri}.npy")
                    h.drop(f"{ri}.json", f"kernels/{ri}.npy")
                wrote.append(info)
                print(f"[qml] ntr={ntr} nf={nf}: {time.perf_counter() - t0:.1f} s", flush=True)
    return wrote


def best_auc() -> list[dict]:
    """One row a metric file: split, points a class, features, and the best
    AUC over the C sweep (what the figure plots)."""
    rows = []
    for f in sorted((h.suite_dir(SUITE) / "raw").glob("*.npy")):
        p = parse_run_info(f.stem)
        rows.append({"split": p["prefix"], "licit_data": p["n_illicit"],
                     "features": p["num_features"], "best_auc": float(np.max(np.load(f)[:, 4]))})
    return rows


def csv() -> list[dict]:
    rows = best_auc()
    common.write_csv(rows, str(h.suite_dir(SUITE) / "results.csv"))
    print((h.suite_dir(SUITE) / "results.csv").read_text())
    return rows


def plot() -> None:
    """Best AUC against the feature count, one curve a data size, train and
    test side by side."""
    plt = h.pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(10, 4), sharey=True)
    rows = best_auc()
    for ax, split in zip(axes, ("train", "test")):
        for ntr in sorted({r["licit_data"] for r in rows}):
            pts = sorted((r["features"], r["best_auc"]) for r in rows
                         if r["split"] == split and r["licit_data"] == ntr)
            ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o", label=f"{2 * ntr}")
        ax.set_xlabel("Number of Features")
        ax.set_title(split)
        ax.set_ylim(0.5, 1.0)
    axes[0].set_ylabel("Best AUC")
    axes[0].legend(loc="lower right", title="Data Size")
    fig.suptitle(f"r=2, gamma=0.1, d=1 (1 {h.card_title(SUITE)})")
    fig.savefig(h.suite_dir(SUITE) / "qml_figures.png", dpi=150, bbox_inches="tight")
    plt.close(fig)


def main(argv=None) -> None:
    h.dispatch(argv, run, csv, plot)


if __name__ == "__main__":
    main()
