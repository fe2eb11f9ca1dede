"""Table II sweep on the port (from ``runs/table2/{run_all.sh,sweep_inproc.py,
to_csv.py}``): nf 50, r 2, 200 + 200 points, six data seeds; the Gaussian
baseline of ``cli.classical_main`` a seed into ``raw/gaussian``, and the
quantum kernels of ``cli.main`` over d x gamma a seed into ``raw/quantum``,
in this process, on ``cli.make_synthetic``'s 2000 labelled rows.

    python -m qml_cutensornet_tpu_torch.runs.table2 run   # on the card
    python -m qml_cutensornet_tpu_torch.runs.table2 csv   # results.csv
    python -m qml_cutensornet_tpu_torch.runs.table2 plot  # table2.png

Env: ``SEEDS``, ``DS``, ``GAMMAS``, ``NF``, ``NTR``. A run whose test
metrics are in ``raw/`` is skipped.
"""

from __future__ import annotations

import os
import pathlib
import time

from qml_cutensornet_tpu_torch.runs import _harness as h
from qml_cutensornet_tpu_torch.runs import common
from qml_cutensornet_tpu_torch.utils.naming import run_info

SUITE = "table2"
N_LABELED = 2000


def run() -> list:
    """Run the grid; returns the names of the metric files this call wrote
    (``gaussian/seed_{s}`` and the quantum test records)."""
    from qml_cutensornet_tpu_torch.cli import classical_main
    from qml_cutensornet_tpu_torch.cli import main as qmain

    nf = int(os.environ.get("NF", "50"))
    ntr = int(os.environ.get("NTR", "200"))
    seeds = h.env_ints("SEEDS", "5 8 20 25 30 35")
    ds = h.env_ints("DS", "1 2 4 6")
    gammas = h.env_floats("GAMMAS", "0.1 0.5 1.0")
    raw = h.suite_dir(SUITE) / "raw"
    (raw / "gaussian").mkdir(parents=True, exist_ok=True)
    (raw / "quantum").mkdir(parents=True, exist_ok=True)
    wrote = []
    with h.workdir(SUITE):
        df = h.synthetic_data(N_LABELED)
        for s in seeds:
            gout = raw / "gaussian" / f"seed_{s}.npy"
            if not gout.exists():
                argv = ["classical_main.py", str(nf), str(ntr), str(ntr), str(s), df, str(gout)]
                h.call(classical_main, argv, SUITE)
                wrote.append(f"gaussian/seed_{s}")
                print(f"[table2] gaussian seed {s} done", flush=True)
        total, i = len(seeds) * len(ds) * len(gammas), 0
        for s in seeds:
            for d in ds:
                for g in gammas:
                    i += 1
                    info = run_info("test", nf, 2, g, d, ntr, s, df)
                    if (raw / "quantum" / f"{info}.npy").exists():
                        print(f"[table2] {i}/{total} skip s{s} d{d} g{g}", flush=True)
                        continue
                    t0 = time.perf_counter()
                    argv = ["main.py", "GPU", str(nf), "2", str(g), str(d), str(ntr), str(ntr),
                            str(s), df]
                    h.call(qmain, argv, SUITE, run_info("train", nf, 2, g, d, ntr, s, df))
                    for kind in ("train", "test"):
                        ri = run_info(kind, nf, 2, g, d, ntr, s, df)
                        h.keep(pathlib.Path("data", f"{ri}.npy"), raw / "quantum" / f"{ri}.npy")
                        h.drop(f"{ri}.json", f"kernels/{ri}.npy")
                    wrote.append(info)
                    print(f"[table2] {i}/{total} s{s} d{d} g{g}: "
                          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return wrote


def csv() -> list[dict]:
    out = h.suite_dir(SUITE)
    rows = common.table2_csv(str(out / "raw" / "quantum"), str(out / "raw" / "gaussian"),
                             str(out / "results.csv"))
    print((out / "results.csv").read_text())
    return rows


def plot() -> None:
    """Best test AUC of each row: the Gaussian baseline and every (d,
    gamma) quantum kernel."""
    out = h.suite_dir(SUITE)
    rows = common.read_csv(str(out / "results.csv"))
    plt = h.pyplot()
    fig, ax = plt.subplots(figsize=(max(6, 0.5 * len(rows)), 4))
    labels = ["Gaussian" if r["kernel"] == "Gaussian" else f"d{r['d']} g{r['gamma']}"
              for r in rows]
    ax.bar(range(len(rows)), [float(r["AUC"]) for r in rows],
           color=["gray" if r["kernel"] == "Gaussian" else "tab:blue" for r in rows])
    ax.set_xticks(range(len(rows)), labels, rotation=60, fontsize=8)
    ax.set_ylim(0.5, 1.0)
    ax.set_ylabel("Test AUC (best over C, mean over seeds)")
    ax.set_title(f"nf=50, r=2 (1 {h.card_title(SUITE)})")
    fig.savefig(out / "table2.png", dpi=150, bbox_inches="tight")
    plt.close(fig)


def main(argv=None) -> None:
    h.dispatch(argv, run, csv, plot)


if __name__ == "__main__":
    main()
