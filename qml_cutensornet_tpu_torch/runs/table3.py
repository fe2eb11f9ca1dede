"""Table III sweep on the port (from ``runs/table3/{sweep_inproc.py,
to_csv.py}``): test metrics against circuit depth r 2 to 20 at nf 50, d 1,
gamma 1.0, 200 + 200 points, six data seeds, the full classification run of
``cli.main`` in this process, on ``cli.make_synthetic``'s 2000 labelled rows.

    python -m qml_cutensornet_tpu_torch.runs.table3 run   # on the card
    python -m qml_cutensornet_tpu_torch.runs.table3 csv   # results.csv
    python -m qml_cutensornet_tpu_torch.runs.table3 plot  # table3.png

Env: ``SEEDS``, ``RS``, ``NF``, ``NTR``. Depth-major order; the train and
test metric ``.npy`` files move to ``raw/``, and a run whose test metrics
are there is skipped.
"""

from __future__ import annotations

import os
import pathlib
import time

from qml_cutensornet_tpu_torch.runs import _harness as h
from qml_cutensornet_tpu_torch.runs import common
from qml_cutensornet_tpu_torch.utils.naming import run_info

SUITE = "table3"
N_LABELED = 2000


def run() -> list:
    """Run the grid; returns the record names of the test metrics this call
    wrote."""
    from qml_cutensornet_tpu_torch.cli import main as qmain

    nf = int(os.environ.get("NF", "50"))
    ntr = int(os.environ.get("NTR", "200"))
    seeds = h.env_ints("SEEDS", "5 8 20 25 30 35")
    rs = h.env_ints("RS", "2 4 8 12 16 20")
    raw = h.suite_dir(SUITE) / "raw"
    raw.mkdir(parents=True, exist_ok=True)
    wrote = []
    with h.workdir(SUITE):
        df = h.synthetic_data(N_LABELED)
        total, i = len(seeds) * len(rs), 0
        for r in rs:
            for s in seeds:
                i += 1
                info = run_info("test", nf, r, 1.0, 1, ntr, s, df)
                if (raw / f"{info}.npy").exists():
                    print(f"[table3] {i}/{total} skip r{r} s{s}", flush=True)
                    continue
                t0 = time.perf_counter()
                argv = ["main.py", "GPU", str(nf), str(r), "1.0", "1", str(ntr), str(ntr), str(s),
                        df]
                h.call(qmain, argv, SUITE, run_info("train", nf, r, 1.0, 1, ntr, s, df))
                for kind in ("train", "test"):
                    ri = run_info(kind, nf, r, 1.0, 1, ntr, s, df)
                    h.keep(pathlib.Path("data", f"{ri}.npy"), raw / f"{ri}.npy")
                    h.drop(f"{ri}.json", f"kernels/{ri}.npy")
                wrote.append(info)
                print(f"[table3] {i}/{total} r{r} s{s}: {time.perf_counter() - t0:.1f} s",
                      flush=True)
    return wrote


def csv() -> list[dict]:
    out = h.suite_dir(SUITE)
    rows = common.table3_csv(str(out / "raw"), str(out / "results.csv"))
    print((out / "results.csv").read_text())
    return rows


def plot() -> None:
    """Best test AUC, recall and precision against the circuit depth."""
    out = h.suite_dir(SUITE)
    rows = common.read_csv(str(out / "results.csv"))
    plt = h.pyplot()
    fig, ax = plt.subplots()
    depth = [int(r["depth"]) for r in rows]
    for key in ("AUC", "recall", "precision"):
        ax.plot(depth, [float(r[key]) for r in rows], marker="o", label=key)
    ax.set_xlabel("Circuit depth r")
    ax.set_ylabel("Test metric (best AUC over C, mean over seeds)")
    ax.set_title(f"nf=50, d=1, gamma=1.0 (1 {h.card_title(SUITE)})")
    ax.legend()
    fig.savefig(out / "table3.png", dpi=150, bbox_inches="tight")
    plt.close(fig)


def main(argv=None) -> None:
    h.dispatch(argv, run, csv, plot)


if __name__ == "__main__":
    main()
