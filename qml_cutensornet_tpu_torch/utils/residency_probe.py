"""Measurements behind the large-chi memory path of the Gram build
(``models/gram``: ``STATES_DEVICE_BYTES``, host-resident states):

    python3 -m qml_cutensornet_tpu_torch.utils.residency_probe [peak] [d10]

- ``peak``: the device-memory peak of one sim batch at the largest chi the
  port has run, as ``torch.cuda.max_memory_allocated`` measures it: the
  CLI's config at nf 100, r 2, d 10, chi 512 (the crossover sweep's d-10
  cap) on the CLI's default sim batch of 32, each rep cut to its first 512
  ops. Rep 1 then ramps through the stages 32, 128, 256 and 512 as the
  whole run does, and rep 2 starts at 512 with its feature layer (a new
  state beside the old one) and runs its ops there: the whole run's peak,
  in a sixth of its ops. Prints the card's total memory and
  the default of ``QMLTPU_STATES_DEVICE_BYTES`` derived from it (total,
  less the tile budget ``QMLTPU_TILE_BYTES`` 9.2e9, less this peak, less
  the allocator's reserve above the allocated peak, less a margin).
- ``d10``: the crossover sweep's d-10 configuration through
  ``cli.main_no_test`` (nf 100, chi 512, its 5 + 5 points: 8 train points
  in one sim batch; 2 + 2 draws only 3, whose features are 0, 1 and 2 and
  whose states are products, and 1 + 1 cannot be stratified), once with
  the states on the card and once with ``QMLTPU_STATES_DEVICE_BYTES=0``:
  sim, tile and upload seconds, peak memory, avg_max_chi and avg_fidelity
  of each, and the two Grams against each other.

Prints the card's name, power limit and memory first. Needs
a card (exits 2 without one) and the repo's datasets; works under
``build/residency``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import pathlib
import re
import sys
import time

import numpy as np
import torch

from qml_cutensornet_tpu_torch.cli import _pipeline as pipe
from qml_cutensornet_tpu_torch.cli import main_no_test
from qml_cutensornet_tpu_torch.models import gram
from qml_cutensornet_tpu_torch.models.simulate import make_chunked_simulator
from qml_cutensornet_tpu_torch.utils.data import preprocess_elliptic
from qml_cutensornet_tpu_torch.utils.device import environ, nvidia_smi
from qml_cutensornet_tpu_torch.utils.naming import run_info

ROOT = pathlib.Path(__file__).resolve().parents[2]
WORK = ROOT / "build" / "residency"
CSV = "elliptic_preproc_bench.csv"
TILE_BYTES = 9.2e9  # the tile budget's default (models/gram._auto_tile)
MARGIN = 2e9  # the CUDA context, cuBLAS workspaces and the host's own kernels' buffers


def sim_peak(chi: int = 512, batch: int = 32, d: int = 10, ops: int = 512) -> None:
    argv = ["main", "GPU", "100", "2", "1.0", str(d), "5", "5", "5", CSV]
    with environ(QMLTPU_CHI=str(chi)):
        params = pipe.parse_argv(argv)
        cfg = pipe.sim_config(params)
    sched = pipe.make_ansatz(params).schedule
    cut = dataclasses.replace(sched, segments=[
        dataclasses.replace(s, sites=s.sites[:ops], gkinds=s.gkinds[:ops], dirs=s.dirs[:ops],
                            fa=s.fa[:ops], fb=s.fb[:ops]) for s in sched.segments])
    dev = torch.device("cuda", 0)
    sim = make_chunked_simulator(cut, cfg, dev)
    x = np.random.default_rng(0).uniform(0.0, 2.0, size=(batch, 100))
    sim(x[:1])  # builds the kernels this config launches
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = sim(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    reserved = torch.cuda.max_memory_reserved()
    state = out.tensors.nbytes
    total = torch.cuda.get_device_properties(0).total_memory
    reserve = max(0, reserved - torch.cuda.max_memory_allocated())
    default = total - TILE_BYTES - peak - reserve - MARGIN
    print(f"sim batch peak [{nvidia_smi()}]: nf 100, d {d}, chi {chi} (oversample "
          f"{cfg.oversample}, iters {cfg.subspace_iters}), batch {batch}, {2 * ops} ops, "
          f"staged: {wall:.3f} s; max_memory_allocated above the start {peak} B "
          f"({peak / state:.3f} x the batch's state, {state} B); max_memory_reserved "
          f"{reserved} B, {reserve} B above the allocated peak", flush=True)
    print(f"default QMLTPU_STATES_DEVICE_BYTES: total {total} B - tile budget {TILE_BYTES:.4g}"
          f" - sim batch peak {peak} - reserve {reserve} - margin {MARGIN:.4g} = "
          f"{default:.6g} B (models/gram.STATES_DEVICE_BYTES now {gram.STATES_DEVICE_BYTES:.6g})",
          flush=True)


def run_cli(argv, knobs: dict) -> dict:
    """``cli.main_no_test(argv)`` under ``knobs``: the Gram, its profile,
    the reported residency and upload seconds, peak memory and wall."""
    buf = io.StringIO()
    with environ(**knobs):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            K = main_no_test.main(list(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    (regime, tiles, upload), = re.findall(
        r"States (\w+)-resident: tiles (\S+) s, of them uploads (\S+) s", buf.getvalue())
    params = pipe.parse_argv(list(argv))
    info = run_info("train", params.num_features, params.reps, params.gamma,
                    params.nearest_neighbors, params.n_illicit, params.data_seed, CSV)
    prof = json.loads(pathlib.Path(f"{info}.json").read_text())
    return dict(K=K, regime=regime, upload=float(upload), peak=peak, base=base, wall=wall,
                sim=prof["r0_circ_sim"][0], tiles=prof["kernel_mat_time"][0],
                chi=prof["ave max chi x"][0], fid=prof["avg_fidelity"][0])


def d10(points: int = 5, sim_batch: int = 8) -> None:
    argv = ["main", "GPU", "100", "2", "1.0", "10", str(points), str(points), "5", CSV]
    knobs = {"QMLTPU_CHI": "512", "QMLTPU_SIM_BATCH": str(sim_batch)}
    out = {}
    for path, extra in (("device", {}), ("host", {"QMLTPU_STATES_DEVICE_BYTES": "0"})):
        r = run_cli(argv, dict(knobs, **extra))
        out[path] = r
        print(f"d10 {path} path [{nvidia_smi()}]: nf 100, chi 512, {r['K'].shape[0]} train "
              f"points, sim batch {sim_batch}: states {r['regime']}-resident; sim {r['sim']:.3f}"
              f" s, tiles {r['tiles']:.3f} s, uploads {r['upload']:.3f} s, wall "
              f"{r['wall']:.3f} s; peak memory {r['peak']} B ({r['base']} B before); "
              f"avg_max_chi {r['chi']:.2f}, avg_fidelity {r['fid']:.8f}", flush=True)
        assert r["regime"] == path, r["regime"]
    diff = float(np.abs(out["host"]["K"] - out["device"]["K"]).max())
    print(f"d10: host-path Gram vs device-path Gram max abs diff {diff:.3e}, bit-equal "
          f"{np.array_equal(out['host']['K'], out['device']['K'])}", flush=True)


def main(argv=None) -> int:
    what = (sys.argv[1:] if argv is None else argv) or ["peak", "d10"]
    if not torch.cuda.is_available():
        print("residency_probe: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"card: {nvidia_smi()}; device memory "
          f"{torch.cuda.get_device_properties(0).total_memory} B", flush=True)
    (WORK / "datasets").mkdir(parents=True, exist_ok=True)
    preprocess_elliptic(str(ROOT / "datasets/elliptic_bitcoin_dataset_v1"),
                        str(WORK / "datasets" / CSV))
    os.chdir(WORK)
    os.environ["QMLTPU_DEVICE"] = "cuda"
    os.environ.pop("QMLTPU_STATES_DEVICE_BYTES", None)
    for name in what:
        {"peak": sim_peak, "d10": d10}[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
