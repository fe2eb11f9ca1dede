"""Memory-evolution capture on the port (the reference's Figure 8 suite, from
``runs/mem_evol/{run_all.sh,plot.py}``): one datapoint circuit a run at nf
100, r 2, gamma 1.0, 5 + 5 points, for each d and train index x, through
``cli.main_track_mem`` in this process; its ``[DEBUG] MPS size (MiB) = ..``
lines (one an op) go to ``raw/d{d}/{x}.out``, which
:func:`~qml_cutensornet_tpu_torch.runs.common.mem_evol_series` parses.

    python -m qml_cutensornet_tpu_torch.runs.mem_evol run   # on the card
    python -m qml_cutensornet_tpu_torch.runs.mem_evol plot  # mem_evol.png

Env: ``NF``, ``DS`` (default "6 12"), ``XS`` (default "0 1 2 3 4 5 6 7"),
``QMLTPU_CHI`` (unset: the CLI's default cap, 64 at nf 100). A capture
already there is skipped; each is written whole or not at all.
"""

from __future__ import annotations

import contextlib
import os
import time

from qml_cutensornet_tpu_torch.runs import _harness as h
from qml_cutensornet_tpu_torch.runs import common

SUITE = "mem_evol"


def run() -> dict:
    """Run the captures; returns {"d{d}/{x}.out": number of size lines} of
    the captures this call wrote."""
    from qml_cutensornet_tpu_torch.cli import main_track_mem

    nf = int(os.environ.get("NF", "100"))
    ds = h.env_ints("DS", "6 12")
    xs = h.env_ints("XS", "0 1 2 3 4 5 6 7")
    ntr, r, g, s = 5, 2, 1.0, 5
    raw = h.suite_dir(SUITE) / "raw"
    wrote = {}
    with h.workdir(SUITE):
        df = h.v1_data()
        for d in ds:
            (raw / f"d{d}").mkdir(parents=True, exist_ok=True)
            for x in xs:
                out = raw / f"d{d}" / f"{x}.out"
                if out.exists():
                    print(f"[mem] d={d} x={x}: capture present, skip", flush=True)
                    continue
                argv = ["main_track_mem.py", "GPU", str(nf), str(r), str(g), str(d), str(ntr),
                        str(ntr), str(s), df, str(x)]
                t0 = time.perf_counter()
                part = out.with_suffix(".part")
                with open(part, "w") as fp, contextlib.redirect_stderr(fp):
                    h.call(main_track_mem, argv, SUITE, capture=f"d{d}/{x}.out")
                h.keep(part, out)
                wrote[f"d{d}/{x}.out"] = sum("MPS size" in line for line in open(out))
                print(f"[mem] d={d} x={x}: {wrote[f'd{d}/{x}.out']} ops, "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
    return wrote


def csv() -> dict:
    """The per-op series of each d (no CSV in the reference's schema: the
    captures are the data)."""
    raw = h.suite_dir(SUITE) / "raw"
    series = {p.name: common.mem_evol_series(str(p)) for p in sorted(raw.iterdir()) if p.is_dir()}
    for d, caps in series.items():
        for name, sizes in caps.items():
            print(f"{d}/{name}: {len(sizes)} ops, largest {max(sizes, default=0.0)} MiB")
    return series


def plot() -> None:
    """Mean, least and largest MPS size against the share of ops applied,
    one band a d."""
    import numpy as np

    out = h.suite_dir(SUITE)
    plt = h.pyplot()
    fig, ax = plt.subplots()
    dirs = sorted((p for p in (out / "raw").iterdir() if p.is_dir()), key=lambda p: int(p.name[1:]))
    for raw, color in zip(dirs, ("mediumblue", "orange", "seagreen", "crimson", "gray")):
        d = raw.name
        series = common.mem_evol_series(str(raw))
        if not series or not any(series.values()):
            continue
        nticks = max(len(v) for v in series.values())
        progress = [100 * i / nticks for i in range(nticks)]
        stacked = np.array([v for v in series.values() if len(v) == nticks])
        ax.plot(progress, stacked.mean(axis=0), linewidth=0.75, color=color,
                label=f"d={d[1:]}")
        ax.fill_between(progress, stacked.min(axis=0), stacked.max(axis=0), color=color,
                        alpha=0.2)
    ax.legend(fontsize=10)
    ax.set_xlabel("Gates applied (%)", fontsize=11)
    ax.set_ylabel("MPS size (MiB)", fontsize=11)
    ax.set_yscale("log")
    ax.set_title(f"MPS size per op, one circuit (1 {h.card_title(SUITE)})")
    fig.savefig(out / "mem_evol.png", dpi=150, bbox_inches="tight")
    plt.close(fig)


def main(argv=None) -> None:
    h.dispatch(argv, run, csv, plot)


if __name__ == "__main__":
    main()
