"""Crossover sweep on the port (the reference's Figure 5 suite, from
``runs/crossover/{run_all.sh,to_csv.py,plot.py}``): nf 100, r 2, gamma 1.0,
5 + 5 points, the train Gram only, through ``cli.main_no_test`` in this
process, over the interaction distance d at the bond cap
:func:`chi_for_d`, in three modes:

- ``gpu``: the fidelity criterion (backend label "GPU"), d 2 to 12, into
  ``raw/gpu``;
- ``cpu``: the cutoff criterion (backend label "CPU", ``cli/_pipeline.py``
  ``sim_config``), d 2 to 10, into ``raw/cpu``. The label picks the
  criterion only: the run stays on the card;
- ``brick``: the brick engine with its pair updates in kernel K5 at chi 128
  and no oversampling, d 6, into ``raw/gpu``.

    python -m qml_cutensornet_tpu_torch.runs.crossover run [cpu gpu brick]
    python -m qml_cutensornet_tpu_torch.runs.crossover csv   # {gpu,cpu}_results.csv
    python -m qml_cutensornet_tpu_torch.runs.crossover plot  # crossover.png

Env: ``NF`` (default 100), ``DS`` (every mode's distances), ``PREWARM=0`` (else each point runs
once first and its record is deleted), ``QMLTPU_CHI`` (every point's cap),
``QMLTPU_SIM_BATCH`` (default 10). A record of another configuration than
the sweep's tracked route at a cap up to 512 takes the reference's name
suffix (``_tracked_chi1024``, ``_brick_chi128``), which ``crossover_csv``
keeps as its ``config`` column. A record already there is skipped.
"""

from __future__ import annotations

import os
import pathlib
import time

from qml_cutensornet_tpu_torch.runs import _harness as h
from qml_cutensornet_tpu_torch.runs import common
from qml_cutensornet_tpu_torch.utils.device import environ
from qml_cutensornet_tpu_torch.utils.naming import run_info

SUITE = "crossover"
REPS, GAMMA, NTR, SEED = 2, 1.0, 5, 5
# mode -> (backend label, default distances, raw subdirectory)
MODES = {"cpu": ("CPU", "2 4 6 8 10", "cpu"), "gpu": ("GPU", "2 4 6 8 10 12", "gpu"),
         "brick": ("GPU", "6", "gpu")}
BRICK_CHI = 128
BRICK_KNOBS = {"QMLTPU_ROUTING": "brick", "QMLTPU_FUSED_GATE": "1", "QMLTPU_OVERSAMPLE": "0"}


def chi_for_d(d: int) -> int:
    """The sweep's bond cap: about twice the reference's observed avg max
    chi at nf 100, so that the truncation, not the cap, sets the chi."""
    for top, chi in ((2, 64), (4, 96), (6, 192), (8, 256), (10, 512)):
        if d <= top:
            return chi
    return 1024


def config_suffix(mode: str, d: int, chi: int) -> str:
    if mode == "brick":
        return f"_brick_chi{chi}"
    return "" if chi == chi_for_d(d) and chi <= 512 else f"_tracked_chi{chi}"


def point_argv(mode: str, nf: int, d: int, df: str) -> list:
    return ["main_no_test.py", MODES[mode][0], str(nf), str(REPS), str(GAMMA), str(d), str(NTR),
            str(NTR), str(SEED), df]


def run(*modes: str) -> dict:
    """Run the modes (default cpu, gpu, brick) in turn; returns {"mode/record
    name": train Gram} of the records this call wrote."""
    from qml_cutensornet_tpu_torch.cli import main_no_test

    modes = modes or ("cpu", "gpu", "brick")
    unknown = [m for m in modes if m not in MODES]
    if unknown:
        raise ValueError(f"unknown crossover modes {unknown}: use {sorted(MODES)}")
    from qml_cutensornet_tpu_torch.cli import _pipeline as pipe

    nf = int(os.environ.get("NF", "100"))
    chi_env = os.environ.get("QMLTPU_CHI")
    out = h.suite_dir(SUITE)
    grams = {}
    with h.workdir(SUITE), environ(QMLTPU_SIM_BATCH=os.environ.get("QMLTPU_SIM_BATCH", "10")):
        df = h.v1_data()
        for mode in modes:
            raw = out / "raw" / MODES[mode][2]
            raw.mkdir(parents=True, exist_ok=True)
            for d in h.env_ints("DS", MODES[mode][1]):
                chi = int(chi_env) if chi_env else (BRICK_CHI if mode == "brick" else chi_for_d(d))
                ri = run_info("train", nf, REPS, GAMMA, d, NTR, SEED, df)
                dest = raw / f"{ri}{config_suffix(mode, d, chi)}.json"
                if dest.exists():
                    print(f"[xo] {mode} d={d}: {dest.name} present, skip", flush=True)
                    continue
                knobs = {"QMLTPU_CHI": str(chi), **(BRICK_KNOBS if mode == "brick" else {})}
                argv = point_argv(mode, nf, d, df)
                with environ(**knobs):
                    criterion = pipe.sim_config(pipe.parse_argv(argv)).criterion
                    if h.prewarm_on():
                        t0 = time.perf_counter()
                        h.call(main_no_test, argv, SUITE, ri, mode=mode, criterion=criterion,
                               prewarm=True)
                        h.drop(f"{ri}.json", f"kernels/{ri}.npy")
                        print(f"[xo] {mode} d={d} prewarm: {time.perf_counter() - t0:.1f} s",
                              flush=True)
                    t0 = time.perf_counter()
                    grams[f"{mode}/{dest.stem}"] = h.call(
                        main_no_test, argv, SUITE, ri, mode=mode, criterion=criterion,
                        kept_as=dest.name)
                    h.keep(pathlib.Path(f"{ri}.json"), dest)
                    h.drop(f"kernels/{ri}.npy")
                    print(f"[xo] {mode} d={d} chi={chi}: {time.perf_counter() - t0:.1f} s",
                          flush=True)
    return grams


def csv() -> tuple[list, list]:
    out = h.suite_dir(SUITE)
    gpu = common.crossover_csv(str(out / "raw" / "gpu"), str(out / "gpu_results.csv"),
                               with_mem=True)
    cpu = common.crossover_csv(str(out / "raw" / "cpu"), str(out / "cpu_results.csv"),
                               with_mem=False)
    for name in ("gpu", "cpu"):
        print((out / f"{name}_results.csv").read_text())
    return gpu, cpu


def _best_per_d(rows: list[dict]) -> list[dict]:
    """One row per d: the fastest recorded configuration."""
    best: dict = {}
    for r in rows:
        d = int(r["neighbours"])
        if d not in best or float(r["median_mps_time"]) < float(best[d]["median_mps_time"]):
            best[d] = r
    return [best[d] for d in sorted(best)]


def plot() -> None:
    """Median per-circuit simulation seconds against d for both criteria,
    the quartiles as error bars."""
    out = h.suite_dir(SUITE)
    plt = h.pyplot()
    fig, ax = plt.subplots()
    for name, marker, label in (("gpu", "o", "fidelity criterion (GPU-mode)"),
                                ("cpu", "s", "cutoff criterion (CPU-mode)")):
        rows = _best_per_d(common.read_csv(str(out / f"{name}_results.csv")))
        if not rows:
            continue
        med = [float(r["median_mps_time"]) for r in rows]
        ax.errorbar([int(r["neighbours"]) for r in rows], med,
                    yerr=[[m - float(r["q1_mps_time"]) for m, r in zip(med, rows)],
                          [float(r["q3_mps_time"]) - m for m, r in zip(med, rows)]],
                    marker=marker, label=label)
    ax.set_xlabel("Interaction distance d")
    ax.set_ylabel("Median MPS simulation time (s)")
    ax.set_yscale("log")
    nfs = sorted({int(r["features"]) for r in common.read_csv(str(out / "gpu_results.csv"))})
    ax.set_title(f"nf={', '.join(map(str, nfs))}, r=2, gamma=1.0 (1 {h.card_title(SUITE)})")
    ax.legend()
    fig.savefig(out / "crossover.png", dpi=150, bbox_inches="tight")
    plt.close(fig)


def main(argv=None) -> None:
    h.dispatch(argv, run, csv, plot)


if __name__ == "__main__":
    main()
