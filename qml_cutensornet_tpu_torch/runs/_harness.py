"""What the port's experiment suites share: where a suite writes, the data
it reads, the environment knobs, and the run log.

Every suite writes under ``$QMLTPU_RUNS_DIR/<suite>/`` (default
``runs_torch/<suite>/`` at the repository root): ``raw/`` for the records,
the CSVs and the PNG beside it, ``runs.jsonl`` with one line a CLI call
(wall, sim and tile seconds, peak device memory, kernel launches, where the
states lived, the card's name and power limit), and ``work/``, the working directory of
the CLI calls (their ``datasets/``, ``kernels/`` and ``data/``; not kept).
The CLIs run in-process on the device ``QMLTPU_DEVICE`` names (default
``cuda``; ``cpu`` is the only way to the CPU).

The runtime suites (qubit_scaling, mem_evol, crossover) read the pinned v1
data, ``datasets/elliptic_bitcoin_dataset_v1`` preprocessed to
``elliptic_preproc_bench.csv``, and refuse to run without it; their record
names end in that CSV's stem. The quality suites (table2, table3,
qml_figures) and runtime_scaling, whose largest size draws more illicit
rows than the v1 set holds, write the synthetic data of
``cli.make_synthetic`` into their own ``work/datasets``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import re
import sys
import time

from qml_cutensornet_tpu_torch.runs.common import avg_max_chi

ROOT = pathlib.Path(__file__).resolve().parents[2]
V1_ARCHIVE = ROOT / "datasets" / "elliptic_bitcoin_dataset_v1"
V1_CSV = "elliptic_preproc_bench.csv"
SYNTHETIC_CSV = "elliptic_preproc.csv"


def suite_dir(suite: str) -> pathlib.Path:
    """The suite's output directory, absolute (a relative
    ``QMLTPU_RUNS_DIR`` is taken from the current directory)."""
    base = os.environ.get("QMLTPU_RUNS_DIR")
    return (pathlib.Path(base) if base else ROOT / "runs_torch").absolute() / suite


def env_ints(name: str, default: str) -> list[int]:
    return [int(v) for v in os.environ.get(name, default).split()]


def env_floats(name: str, default: str) -> list[float]:
    return [float(v) for v in os.environ.get(name, default).split()]


def prewarm_on() -> bool:
    return os.environ.get("PREWARM", "1") == "1"


def on_card() -> bool:
    return os.environ.get("QMLTPU_DEVICE", "cuda").startswith("cuda")


@contextlib.contextmanager
def workdir(suite: str):
    """Run the block in ``<suite>/work`` (made if missing), with
    ``QMLTPU_RUNS_DIR`` made absolute for it, and return to the caller's
    directory and environment after it."""
    from qml_cutensornet_tpu_torch.utils.device import environ

    out = suite_dir(suite)
    work = out / "work"
    (work / "datasets").mkdir(parents=True, exist_ok=True)
    old = os.getcwd()
    with environ(QMLTPU_RUNS_DIR=str(out.parent)):
        os.chdir(work)
        try:
            yield work
        finally:
            os.chdir(old)


def v1_data() -> str:
    """Preprocess the pinned v1 archive into ``datasets/`` of the working
    directory and return the CSV's name. Raises where the archive is
    missing: the runtime suites never fall back to other data."""
    from qml_cutensornet_tpu_torch.utils.data import preprocess_elliptic

    needed = [V1_ARCHIVE / f for f in ("elliptic_txs_features.csv", "elliptic_txs_classes.csv")]
    missing = [str(p) for p in needed if not p.is_file()]
    if missing:
        raise FileNotFoundError(
            f"the runtime suites read the pinned v1 data, and {missing} is missing; "
            "they do not fall back to other data")
    preprocess_elliptic(str(V1_ARCHIVE), f"datasets/{V1_CSV}")
    return V1_CSV


def synthetic_data(n_labeled: int) -> str:
    """``cli.make_synthetic n_labeled`` into the working directory unless its
    ``datasets/elliptic_preproc.csv`` is there; returns the CSV's name."""
    from qml_cutensornet_tpu_torch.cli import make_synthetic

    if not pathlib.Path("datasets", SYNTHETIC_CSV).exists():
        make_synthetic.main(["make_synthetic.py", str(n_labeled)])
    return SYNTHETIC_CSV


def card() -> str | None:
    """The card's name and power limit as nvidia-smi gives them, or None on
    the CPU."""
    if not on_card():
        return None
    from qml_cutensornet_tpu_torch.utils.device import nvidia_smi

    return nvidia_smi()


class _Tee(io.TextIOBase):
    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def call(entry, argv: list, suite: str, record: str | None = None, **note):
    """Run ``entry.main(argv)`` in-process and append its line to
    ``runs.jsonl`` (:func:`log_run`), its peak device memory the peak of
    ``torch.cuda.max_memory_allocated`` over the call and its launches those
    of the kernels' counters (``ops/_build.LAUNCHES``) over the call.
    Returns ``entry.main``'s result."""
    import torch

    from qml_cutensornet_tpu_torch.ops import _build

    before = dict(_build.LAUNCHES)
    if on_card():
        torch.cuda.reset_peak_memory_stats()
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        out = entry.main(list(argv))
    if on_card():
        torch.cuda.synchronize()
    log_run(suite, argv, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() if on_card() else None,
            {k: n - before[k] for k, n in _build.LAUNCHES.items()}, tee.buf.getvalue(), record,
            **note)
    return out


def log_run(suite: str, argv: list, wall_s: float, peak_bytes, launches: dict, stdout: str,
            record: str | None = None, **note) -> None:
    """Append one CLI call's line to the suite's ``runs.jsonl``: ``record``
    (the profiling JSON's stem in the working directory, read for the sim
    and tile seconds, ``avg_max_chi`` and ``avg_fidelity``), the wall
    seconds, the ``QMLTPU_*`` knobs, the peak device memory, the kernel
    launches, where the build's states lived (its ``States ...-resident``
    line in ``stdout``) and the card, beside ``note``."""
    line = {"argv": [str(a) for a in argv[1:]], **note,
            "wall_s": wall_s,
            "knobs": {k: v for k, v in sorted(os.environ.items()) if k.startswith("QMLTPU_")},
            "peak_bytes": peak_bytes, "launches": launches, "card": card()}
    regime = re.search(r"States (\w+)-resident", stdout)
    line["states"] = regime.group(1) if regime else None
    if record is not None:
        line["record"] = record
        prof_path = pathlib.Path(f"{record}.json")
        if prof_path.exists():
            prof = json.loads(prof_path.read_text())
            line.update(sim_s=prof["r0_circ_sim"][0], tile_s=prof["kernel_mat_time"][0],
                        avg_max_chi=avg_max_chi(prof),
                        avg_fidelity=prof["avg_fidelity"][0])
    with open(suite_dir(suite) / "runs.jsonl", "a") as fp:
        fp.write(json.dumps(line) + "\n")


def keep(src: pathlib.Path, dest: pathlib.Path) -> None:
    dest.parent.mkdir(parents=True, exist_ok=True)
    os.replace(src, dest)


def drop(*paths) -> None:
    for p in paths:
        pathlib.Path(p).unlink(missing_ok=True)


def read_runs(suite: str) -> list[dict]:
    path = suite_dir(suite) / "runs.jsonl"
    if not path.exists():
        return []
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


def card_title(suite: str) -> str:
    """The card of the suite's newest logged run, for a figure's title."""
    cards = [r["card"] for r in read_runs(suite) if r.get("card")]
    return cards[-1].split(",")[0] if cards else "CPU"


def pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def dispatch(argv, run, csv, plot, **more) -> None:
    """``python -m qml_cutensornet_tpu_torch.runs.<suite> run|csv|plot
    [arguments]``, and the suite's ``more`` steps by name."""
    args = sys.argv[1:] if argv is None else list(argv)
    cmd, rest = (args[0], args[1:]) if args else ("run", [])
    steps = {"run": run, "csv": csv, "plot": plot, **more}
    if cmd not in steps:
        raise SystemExit(f"usage: {' | '.join(steps)} (got {cmd!r})")
    steps[cmd](*rest)
