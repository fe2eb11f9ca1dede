"""Qubit-scaling sweep on the port (the reference's Figure 7 suite, from
``runs/qubit_scaling/{sweep_inproc.py,to_csv.py,plot.py}``): nf 30 to 165 x
gamma 0.1, 0.5, 1.0 at r 2, d 6, 5 + 5 points, the train Gram only, through
``cli.main_no_test`` in this process.

    python -m qml_cutensornet_tpu_torch.runs.qubit_scaling run   # on the card
    python -m qml_cutensornet_tpu_torch.runs.qubit_scaling csv   # results.csv
    python -m qml_cutensornet_tpu_torch.runs.qubit_scaling plot  # qubit_scaling.png

Env: ``NFS``, ``GAMMAS``, ``NTR``, ``D``, ``PREWARM=0``; ``QMLTPU_CHI`` sets
every nf's bond cap, else :data:`CHI_FOR_NF`; ``QMLTPU_SIM_BATCH`` defaults
to 10. Each nf group first runs gamma 1.0 once and deletes its record (the
prewarm: the first run of a process pays the kernel libraries' load and the
cuBLAS and cuSOLVER handles). Records move to ``raw/`` one by one, and a
record already there is skipped. The caller's environment comes back as it
was.
"""

from __future__ import annotations

import os
import pathlib
import time

from qml_cutensornet_tpu_torch.runs import _harness as h
from qml_cutensornet_tpu_torch.runs import common
from qml_cutensornet_tpu_torch.utils.device import environ
from qml_cutensornet_tpu_torch.utils.naming import run_info

SUITE = "qubit_scaling"
# The reference sweep's bond caps: 64 up to nf 90, 128 at 120 and 150 so
# that the truncation, not the cap, sets the reported chi, 192 at nf 165.
CHI_FOR_NF = {30: 64, 60: 64, 90: 64, 120: 128, 150: 128, 165: 192}


def run() -> dict:
    """Run the sweep; returns {record name: train Gram} of the records this
    call wrote."""
    from qml_cutensornet_tpu_torch.cli import main_no_test

    ntr = int(os.environ.get("NTR", "5"))
    d = int(os.environ.get("D", "6"))
    nfs = h.env_ints("NFS", "30 60 90 120 150 165")
    gammas = h.env_floats("GAMMAS", "0.1 0.5 1.0")
    prewarm = h.prewarm_on()
    chi_env = os.environ.get("QMLTPU_CHI")
    s = 5
    raw = h.suite_dir(SUITE) / "raw"
    raw.mkdir(parents=True, exist_ok=True)
    grams = {}
    with h.workdir(SUITE), environ(QMLTPU_SIM_BATCH=os.environ.get("QMLTPU_SIM_BATCH", "10")):
        df = h.v1_data()

        def argv(g):
            return ["main_no_test.py", "GPU", str(nf), "2", str(g), str(d), str(ntr), str(ntr),
                    str(s), df]

        for nf in nfs:
            todo = [g for g in gammas
                    if not (raw / f"{run_info('train', nf, 2, g, d, ntr, s, df)}.json").exists()]
            if not todo:
                print(f"[qs] nf={nf}: all {len(gammas)} records present, skip", flush=True)
                continue
            with environ(QMLTPU_CHI=chi_env or str(CHI_FOR_NF.get(nf, 64))):
                if prewarm:
                    t0 = time.perf_counter()
                    ri = run_info("train", nf, 2, 1.0, d, ntr, s, df)
                    h.call(main_no_test, argv(1.0), SUITE, ri, prewarm=True)
                    h.drop(f"{ri}.json", f"kernels/{ri}.npy")
                    print(f"[qs] nf={nf} prewarm: {time.perf_counter() - t0:.1f} s", flush=True)
                for g in todo:
                    t0 = time.perf_counter()
                    ri = run_info("train", nf, 2, g, d, ntr, s, df)
                    grams[ri] = h.call(main_no_test, argv(g), SUITE, ri)
                    h.keep(pathlib.Path(f"{ri}.json"), raw / f"{ri}.json")
                    h.drop(f"kernels/{ri}.npy")
                    print(f"[qs] nf={nf} g={g}: {time.perf_counter() - t0:.1f} s", flush=True)
    return grams


def csv() -> list[dict]:
    out = h.suite_dir(SUITE)
    rows = common.qubit_scaling_csv(str(out / "raw"), str(out / "results.csv"))
    print((out / "results.csv").read_text())
    return rows


def plot() -> None:
    """Average per-circuit simulation seconds against the qubit count, one
    curve per gamma, at the sweep's d."""
    out = h.suite_dir(SUITE)
    rows = common.read_csv(str(out / "results.csv"))
    ds = [int(r["neighbours"]) for r in rows]
    d = max(set(ds), key=ds.count)
    rows = [r for r in rows if int(r["neighbours"]) == d]
    plt = h.pyplot()
    fig, ax = plt.subplots()
    for gamma in sorted({float(r["gamma"]) for r in rows}):
        pts = sorted((int(r["features"]), float(r["avg_mps_time"])) for r in rows
                     if float(r["gamma"]) == gamma)
        ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o", label=f"{gamma}")
    ax.legend(title=r"$\gamma$", fontsize=10)
    ax.set_xticks(sorted({int(r["features"]) for r in rows}))
    ax.set_xlabel("Number of qubits", fontsize=11)
    ax.set_ylabel("MPS sim. time (s)", fontsize=11)
    ax.set_title(f"Per-circuit MPS simulation time (r=2, d={d}, 1 {h.card_title(SUITE)})")
    fig.savefig(out / "qubit_scaling.png", dpi=150, bbox_inches="tight")
    plt.close(fig)


def main(argv=None) -> None:
    h.dispatch(argv, run, csv, plot)


if __name__ == "__main__":
    main()
