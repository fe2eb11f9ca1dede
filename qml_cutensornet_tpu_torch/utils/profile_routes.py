"""Where the simulation time goes on each route of the two-site update, on
one NVIDIA GPU:

    python3 -m qml_cutensornet_tpu_torch.utils.profile_routes [ROUTE ...]

ROUTE is any of ``default`` (K1 + K2), ``fused_gate`` (K4 + K2), ``unfused``
(K3 + matrix products), ``runtime_scaling`` (K1 + K2 at the runtime_scaling
suite's configuration: nf 165, r 2, gamma 0.1, d 1, chi 64, on the v1
data), ``ambient_high`` and ``ambient_bfloat16`` (the
CLI's config at ``SimConfig.matmul_precision`` "high" or "bfloat16": K2,
K3 and every product on K7), ``brick_k5``, ``brick_k1``,
``brick_k5_sharded``, ``brick14_k5`` and ``brick14_k5_sharded`` (default:
``default``, ``fused_gate``, ``unfused``, ``brick_k5`` and ``brick_k1``).
The tracked routes simulate one sim batch of 32 circuits at the headline shape
(32 qubits, r=2, d=6, chi 64, f32, the pinned v1 data); the brick routes
one sim batch of 8 circuits of the full-width brick configuration (100
qubits, r=2, d=6, chi 128, oversampling 0, ``QMLTPU_ROUTING=brick``), every
pair update from chi 16 on through K5 (``brick_k5``: fused gate) or through
torch products and K1 (``brick_k1``); the ``brick14`` routes one sim batch
of 32 circuits of 14 qubits at the same settings through K5; the
``_sharded`` routes the same on the site-sharded engine
(``QMLTPU_SHARD_MPS=all``, a mesh of one). For each it prints: the wall time of
two unprofiled batches; then, from one batch under ``torch.profiler``, the
kernel launches per op (per two-site gate or center move; per pair update
on the brick routes), the device time in total and by kernel (the largest
eight), and the device's idle share of the profiled wall time. Needs a card
(exits 2 without one) and the repo's datasets; writes its preprocessed CSV
under ``build/profile/``.
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys
import time

import numpy as np
import torch

from qml_cutensornet_tpu_torch.cli import _pipeline as pipe
from qml_cutensornet_tpu_torch.models.ansatz import GATE_I, GATE_RX
from qml_cutensornet_tpu_torch.models import simulate
from qml_cutensornet_tpu_torch.models.simulate import make_chunked_simulator, stream_chunk_plan
from qml_cutensornet_tpu_torch.ops import vidal
from qml_cutensornet_tpu_torch.ops import _build
from qml_cutensornet_tpu_torch.parallel import sharded_mps
from qml_cutensornet_tpu_torch.utils.data import load_and_prepare, preprocess_elliptic
from qml_cutensornet_tpu_torch.utils.device import environ, nvidia_smi

ROOT = pathlib.Path(__file__).resolve().parents[2]
ARGV = ["profile", "GPU", "32", "2", "1.0", "6", "64", "64", "5", "elliptic_preproc_bench.csv"]
ARGV_RS = ["profile", "GPU", "165", "2", "0.1", "1", "64", "64", "5",
           "elliptic_preproc_bench.csv"]
ARGV_BRICK = ["profile", "GPU", "100", "2", "1.0", "6", "5", "5", "5",
              "elliptic_preproc_bench.csv"]
ARGV_BRICK14 = ["profile", "GPU", "14", "2", "1.0", "6", "20", "20", "5",
                "elliptic_preproc_bench.csv"]
BRICK = {"QMLTPU_ROUTING": "brick", "QMLTPU_CHI": "128", "QMLTPU_OVERSAMPLE": "0"}
K5 = {**BRICK, "QMLTPU_FUSED_GATE": "1"}
SHARD = {"QMLTPU_SHARD_MPS": "all"}
# route -> (argv, knobs, circuits in the sim batch[, the ambient class])
ROUTES = {
    "default": (ARGV, {}, 32),
    "fused_gate": (ARGV, {"QMLTPU_FUSED_GATE": "1"}, 32),
    "unfused": (ARGV, {"QMLTPU_FUSED_SPLIT": "0"}, 32),
    "runtime_scaling": (ARGV_RS, {}, 32),
    "ambient_high": (ARGV, {}, 32, "high"),
    "ambient_bfloat16": (ARGV, {}, 32, "bfloat16"),
    "brick_k5": (ARGV_BRICK, K5, 8),
    "brick_k1": (ARGV_BRICK, {**BRICK, "QMLTPU_FUSED_GATE": "0"}, 8),
    "brick_k5_sharded": (ARGV_BRICK, {**K5, **SHARD}, 8),
    "brick14_k5": (ARGV_BRICK14, K5, 32),
    "brick14_k5_sharded": (ARGV_BRICK14, {**K5, **SHARD}, 32),
}
DEFAULT_ROUTES = ("default", "fused_gate", "unfused", "brick_k5", "brick_k1")


def _one_batch(sim, x, dev):
    t0 = time.perf_counter()
    sim(x)
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def _op_count(schedule, cfg, batch, sharded: bool):
    """Ops of one sim batch: two-site gates and center moves of the tracked
    stream (padding moves included), or the brick plan's pair updates (its
    chunks padded to full length with inactive layers, each layer one update
    per pair chunk; the site-sharded engine's pairs on a mesh of one)."""
    if isinstance(schedule, simulate.BrickSchedule):
        K = schedule.pairs_per_layer
        if sharded:
            K = sharded_mps.padded_sites_for(schedule.num_sites_padded, 1) // 2
        rep_stages, _ = simulate.brick_stage_plan(schedule, cfg, True)
        chunks2, _ = simulate.brick_chunk_plan(schedule, rep_stages,
                                               simulate.BRICK_LAYER_CHUNK, K)
        steps = len(chunks2) * simulate.BRICK_LAYER_CHUNK
        updates = sum(simulate.BRICK_LAYER_CHUNK * -(-K // vidal._pair_chunk(K, c[3], batch))
                      for c in chunks2)
        return updates, f"{steps} layer steps of {K} pairs, {updates} pair updates"
    segs = stream_chunk_plan(schedule, cfg, 128, True)[0]
    kinds = np.concatenate([seg[2] for seg in segs])  # padding moves included
    n_gates = int(np.sum((kinds != GATE_I) & (kinds < GATE_RX)))
    n_moves = int(np.sum(kinds == GATE_I))
    return n_gates + n_moves, f"{n_gates} two-site gates + {n_moves} center moves"


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("profile_routes: needs a CUDA card", file=sys.stderr)
        return 2
    routes = list(argv if argv is not None else sys.argv[1:]) or list(DEFAULT_ROUTES)
    unknown = set(routes) - set(ROUTES)
    if unknown:
        print(f"profile_routes: unknown routes {sorted(unknown)}; known: {list(ROUTES)}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"card: {nvidia_smi()}", flush=True)
    work = ROOT / "build" / "profile"
    (work / "datasets").mkdir(parents=True, exist_ok=True)
    csv = work / "datasets" / ARGV[-1]
    preprocess_elliptic(str(ROOT / "datasets/elliptic_bitcoin_dataset_v1"), str(csv))

    for route in routes:
        argv_r, knobs, batch, *ambient = ROUTES[route]
        with environ(**knobs):
            params = pipe.parse_argv(list(argv_r))
            cfg = dataclasses.replace(pipe.sim_config(params),
                                      matmul_precision=(ambient or ["highest"])[0])
            schedule = pipe.make_ansatz(params).schedule
            site_mesh = pipe.engine_kwargs().get("site_mesh")
            n_ops, ops_text = _op_count(schedule, cfg, batch, site_mesh is not None)
            nq = int(argv_r[2])
            x = np.asarray(load_and_prepare(str(csv), nq, int(argv_r[6]), int(argv_r[7]),
                                            5)[0][:batch])
            sim = make_chunked_simulator(schedule, cfg, dev, chunk_len=128, staged=True,
                                         site_mesh=site_mesh)
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
        print(f"[{route}] fused_split={cfg.fused_split} fused_gate={cfg.fused_gate} "
              f"matmul_precision={cfg.matmul_precision}, "
              f"{len(x)} circuits: unprofiled wall per batch {walls[0]:.3f} / {walls[1]:.3f} s; "
              f"profiled {wall_prof:.3f} s; ops {ops_text}; launches of the port's kernels "
              f"{dict(_build.LAUNCHES)}; cudaLaunchKernel calls {launches} "
              f"({launches / n_ops:.1f} per op); device time {dev_ms:.2f} ms; device idle "
              f"share of the profiled wall {1.0 - dev_ms / 1e3 / wall_prof:.3f}", flush=True)
        for key, count, ms in kernels[:8]:
            print(f"    {ms:9.2f} ms  {count:6d} x  {key[:100]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
