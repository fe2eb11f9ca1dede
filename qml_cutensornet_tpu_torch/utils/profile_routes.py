"""Where the simulation time goes on each route of the two-site update, on
one NVIDIA GPU:

    python3 -m qml_cutensornet_tpu_torch.utils.profile_routes

For the default (K1 + K2), the fused-gate (K4 + K2) and the unfused (K3 +
matrix products) route it simulates one sim batch of 32 circuits at the
headline shape (32 qubits, r=2, d=6, chi 64, f32, the pinned v1 data) and
prints: the wall time of two unprofiled batches; then, from one batch under
``torch.profiler``, the kernel launches per op, the device time in total and
by kernel (the largest eight), and the device's idle share of the profiled
wall time. Needs a card (exits 2 without one) and the repo's datasets;
writes its preprocessed CSV under ``build/profile/``.
"""

from __future__ import annotations

import pathlib
import sys
import time

import numpy as np
import torch

from qml_cutensornet_tpu_torch.cli import _pipeline as pipe
from qml_cutensornet_tpu_torch.models.ansatz import GATE_I, GATE_RX
from qml_cutensornet_tpu_torch.models.simulate import make_chunked_simulator, stream_chunk_plan
from qml_cutensornet_tpu_torch.ops import _build
from qml_cutensornet_tpu_torch.utils.data import load_and_prepare, preprocess_elliptic
from qml_cutensornet_tpu_torch.utils.device import environ, nvidia_smi

ROOT = pathlib.Path(__file__).resolve().parents[2]
ARGV = ["profile", "GPU", "32", "2", "1.0", "6", "64", "64", "5", "elliptic_preproc_bench.csv"]
ROUTES = (("default", {}), ("fused_gate", {"QMLTPU_FUSED_GATE": "1"}),
          ("unfused", {"QMLTPU_FUSED_SPLIT": "0"}))


def _one_batch(sim, x, dev):
    t0 = time.perf_counter()
    sim(x)
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_routes: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"card: {nvidia_smi()}", flush=True)
    work = ROOT / "build" / "profile"
    (work / "datasets").mkdir(parents=True, exist_ok=True)
    csv = work / "datasets" / ARGV[-1]
    preprocess_elliptic(str(ROOT / "datasets/elliptic_bitcoin_dataset_v1"), str(csv))
    x = np.asarray(load_and_prepare(str(csv), 32, 64, 64, 5)[0][:32])

    for route, knobs in ROUTES:
        with environ(**knobs):
            params = pipe.parse_argv(list(ARGV))
            cfg = pipe.sim_config(params)
        schedule = pipe.make_ansatz(params).schedule
        segs = stream_chunk_plan(schedule, cfg, 128, True)[0]
        kinds = np.concatenate([seg[2] for seg in segs])  # padding moves included
        n_gates = int(np.sum((kinds != GATE_I) & (kinds < GATE_RX)))
        n_moves = int(np.sum(kinds == GATE_I))
        sim = make_chunked_simulator(schedule, cfg, dev, chunk_len=128, staged=True)
        _one_batch(sim, x, dev)  # warm-up: builds the kernels, fills the caches
        walls = [_one_batch(sim, x, dev) for _ in range(2)]
        _build.reset_counters()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            wall_prof = _one_batch(sim, x, dev)
        events = prof.key_averages()
        launches = sum(e.count for e in events if e.key.startswith("cudaLaunchKernel"))
        kernels = [(e.key, e.count, getattr(e, "self_device_time_total", 0.0) / 1e3)
                   for e in events if "cuda" in str(getattr(e, "device_type", "")).lower()]
        kernels.sort(key=lambda t: -t[2])
        dev_ms = sum(t[2] for t in kernels)
        print(f"[{route}] fused_split={cfg.fused_split} fused_gate={cfg.fused_gate}: "
              f"unprofiled wall per batch {walls[0]:.3f} / {walls[1]:.3f} s; profiled "
              f"{wall_prof:.3f} s; ops {n_gates} two-site gates + {n_moves} center moves; "
              f"launches of the port's kernels {dict(_build.LAUNCHES)}; cudaLaunchKernel "
              f"calls {launches} ({launches / (n_gates + n_moves):.1f} per op); device time "
              f"{dev_ms:.2f} ms; device idle "
              f"share of the profiled wall {1.0 - dev_ms / 1e3 / wall_prof:.3f}", flush=True)
        for key, count, ms in kernels[:8]:
            print(f"    {ms:9.2f} ms  {count:6d} x  {key[:100]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
