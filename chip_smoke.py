"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py       # needs one CUDA card
    python3 chip_smoke.py k8    # phases 1, 2 and 3c only (K8 beside the parent's)
    python3 chip_smoke.py harness  # phases 1, 2 and 12b only

Phases (any failure raises and exits non-zero; nothing is caught):

1. device: torch sees a card; print ``nvidia-smi`` name and power limit.
2. build: compile ``qml_cutensornet_tpu_torch/csrc`` with nvcc (two
   libraries per source, the single-column one and the pair one, one
   process each, all ten at once; timed; where ``build/parent`` holds the
   parent commit's sources, their five build alone first, timed), print the
   ptxas resource lines, and check that a launch asking for more dynamic
   shared memory than the card allows raises (negative control).
3. kernels: each of the five kernels against its plain PyTorch version on
   the card at the main paths' shapes (chi 8..64, batch 32 and 100, 1 and 2
   power iterations; full-rank, rank-deficient, zero-padded and graded
   inputs; the basis-only kernel also at the blocked route's panel shapes,
   the gate kernel on both feeds and at chi 128; and the shapes that only
   the chi-128 and chi-256 runs give: K1 with 16 oversampled columns, K2 at
   [32, 256, 128] on its global-scratch layout, K3 on the 16-column last
   panel of a 144- or 272-column split; the brick kernel K5 at chi 16..128,
   batch 6 and 408 pairs, 1 and 2 iterations, swap-network and plain gates,
   full inputs and zero-padded ones whose Schmidt weights are exact zeros
   past a rank of 5, and with 16 oversampled columns at chi 16), on
   basis-invariant quantities, each against its stated tolerance; K1, K2,
   K4 and K5 on every launch plan their wrappers choose (B 1, 32 and 100 at
   chi 8 to 64; K1 at nc 80, at [408, 256, 256] with nc 128 and in
   complex128 at chi 64 and 128; K2 in complex128 at chi 64 and 128; K4 at
   nc 80 and in complex128 at chi 16 to 128; K5 in complex128 at chi 16 to
   128), and two launches of each on one input bit-equal; then kernel,
   plain-version and library-call times at the main-path shape with CUDA
   events (K5 at the brick slice's chi 128, 408 pairs, beside K1 on the same
   theta_w^H, its yardstick), beside the least time the card could take for
   the same work (``bound_ms``); K1, K2 and K4 also at both stage shapes of
   the main path (chi 32 and 64, B 32, iters 2) with their launch plans,
   and beside the parent commit's K1, K2, K4 and K5 where its sources were
   unpacked into ``build/parent`` (``git archive``; absent in a plain
   checkout); K3 on every launch plan its wrapper chooses (rows in shared
   memory or global scratch, each in-panel group), complex64 and
   complex128, two launches bit-equal, and its times at every shape of its
   routes (m 64 to 2048, k 16 to 80) beside the parent's K3.
3b. pair kernels: the block-2 in-panel variant of K1 to K5 (``pair``, built
   as a second library per source with ``-DQK_PAIR``) against the plain pair
   versions, complex64, on every launch plan the wrappers choose (K1 and K4
   at chi 8 to 128, nc 13 to 128; K2 at m 16 to 256; K3 on its nine plans;
   K5 at chi 16 to 128), full-rank, rank-deficient, zero-padded and graded
   inputs and panels of odd width, two launches bit-equal on each plan; K1
   single-column and pair at the brick caps' rectangular shapes (m, k, nc)
   = (2 cr, 2 cl, cm); in complex128 ``pair`` changes no output bit; then
   the pair kernels' times beside the single-column ones (CUDA events,
   turns single, pair, pair, single).
3c. K8, the scanned MGS2 panel step of the blocked orthonormalizer
   (``csrc/mgs2_panel.cu``, built once like K7): against its plain version
   at m 256 to 2048, 32 columns and a last panel of 16, batch 32, complex64
   and complex128, each at its cutoff (1e-10, 1e-24: ``orth.dep_tol2``),
   full and degenerate panels (the same exact-zero columns,
   projectors within 1e-5 and 1e-12), two launches bit-equal, on every
   launch plan in both dtypes (the panel in registers; its columns past the
   registers' in shared memory or in global scratch; and, at m 2560, the
   whole panel in global scratch); a launch over the shared-memory limit
   raises uncounted; its device time at each shape (a CUDA graph of 20
   launches; beside the parent commit's K8 where its sources were unpacked
   into ``build/parent``, turns parent, kernel, kernel, parent), call time,
   the plain version's time, ``torch.linalg.qr(a, mode="reduced")``'s (the
   library call) and its bound.
4. default route: the port's ``cli.main_no_test`` at the repo's headline
   shape (32 qubits, r=2, d=6, chi 64, f32, 102 train points of the pinned v1
   data): kernels K1 and K2 carry it; K symmetric with unit diagonal, its
   leading 8x8 block within 1e-6 of the f64 golden; its sim and tile FLOPs
   by the FLOP model (``utils/flops.gram_flops``) and their roofline against
   the H100 entry of ``utils/flops.PEAKS`` (whose peaks also give every
   ``bound_ms``).
5. fused-gate route: the port's ``cli.main`` (train Gram, test Gram, SVC
   sweep) with ``QMLTPU_FUSED_GATE=1`` at the same shape: kernel K4 on every
   two-site update (with chunks of 128 ops the staged ramp of this shape has
   a chi-32 and a chi-64 stage only, and the gate kernel takes both; a chi-8
   stage, which its shape rule refuses, would stay on K1); the train K
   against the golden and within 3e-5 of the default route's; the test K's
   shape, orientation and range; the sweep's rows and each fit's KKT
   conditions.
6. unfused route: ``cli.main_no_test`` with ``QMLTPU_FUSED_SPLIT=0`` on one
   sim batch at the headline shape (kernel K3 on every orthonormalization,
   K1 and K2 never), held to the default route on the same points; then a
   chi-256 run (16 qubits, r=2, d=6, one sim batch; stages chi 32, 64 and
   256) whose chi-256 stage orthonormalizes every split iterate (272 columns)
   and every center move (256 columns) through the blocked route, K3 on
   panels of 32 (in f32; the f64 runs take the scanned panel step, K8 once a
   panel, their sim seconds printed beside the host loop's before K8),
   held to the port's own f64 run on the card at 1e-5 on v1 data; the
   tied-spectrum v2 data at cap 128 (its bonds stay below 9 on average),
   whose f32-vs-f64 error is printed, not gated; and a chi-128 run (stages 32, 64, 128), where the
   default oversampling makes the split 144 columns wide, so that it leaves
   K1 for the blocked route while the center moves stay on K2, held to its
   f64 run likewise. Each of these Grams (v1 and v2, f32 and f64) is also
   held against the dense statevector Gram ``|<psi_i|psi_j>|^2`` of the same
   points, each state built once by the port's ``ops/dense`` (complex128, on
   the host): the errors are printed (the dense verdict), not gated. Last,
   the chi-128 v1 run with ``QMLTPU_FUSED_SPLIT=0`` (K3 up to 128 columns,
   the 144-column split iterates on K8 in complex64) within 3e-5 of the
   fused run's Gram.
7. brick route (``QMLTPU_ROUTING=brick``, chi 128, oversampling 0, so that
   every stage from chi 16 is one K5 takes): (a) 14 qubits, r=2, d=6, one sim
   batch of 32, with ``QMLTPU_FUSED_GATE=1`` (K5, and K1 on the chi-8 stage),
   held within 3e-5 to the tracked default route at the same settings (K1
   and K2; no bond of 14 qubits exceeds 2^7 = 128, so neither truncates); (b)
   the full-width configuration, nf=100, r=2, d=6, 5 + 5 points (8 train
   points, one sim batch of 8) with ``QMLTPU_FUSED_GATE=1`` (128 K5 and 16 K1
   launches); (c) the same with ``QMLTPU_FUSED_GATE=0``, K1 on every pair
   update, held to (b) within 1e-4; (e) (b) in f64; fidelity, chi, sim and
   tile seconds of each run beside the card's name and power limit.
7b. (k) the pair step (``QMLTPU_MGS_PAIR=1``): ``cli.main_no_test`` at the
   headline shape (K1 and K2 pair) against the golden (1e-6) and the default
   route's Gram (3e-5), sim seconds beside the default route's; one sim
   batch each of the fused-gate route (K4 pair), the unfused route (K3
   pair) and the nf-100 brick route through K5 (pair), each held to its
   single-column run at that route's tolerance.
7c. (l) the brick caps (``QMLTPU_BRICK_CAPS=1``, fused gate, chi 128,
   oversampling 0): 14 qubits against the tracked route and the uncapped
   run (3e-5); nf 100, one sim batch of 8, through K5 (the square buckets)
   and K1 (the rectangles), against the uncapped run (1e-4), sim seconds
   and launches by kernel beside the uncapped run's.
8. svd and eigh routes: ``QMLTPU_SVD=svd`` and ``=eigh`` on one sim batch
   of 8 circuits (the golden's 8 train points, through
   ``cli._pipeline.build``, the train-Gram call of ``cli.main_no_test``;
   cuSOLVER's gesvd costs the same per op for 4 circuits as for 8):
   cuSOLVER factors every two-site update, K2 every center move, K1 never;
   eigh at the headline shape, its 8x8 block against the golden at 1e-6 and
   the Gram within 3e-5 of the default route's (eigh in f32, which squares
   the condition number, is reported and run again in f64 for both bars if
   it misses either); svd on one rep of the headline circuit (r 1), its
   Gram within 3e-5 of the default route's on the same points and rep.
9. reference routing: ``QMLTPU_ROUTING=reference`` through
   ``cli.main_no_test`` at the headline shape (2803 two-site ops against
   tracked's 1092), golden and tracked-route bars, sim seconds beside the
   tracked route's; then ``simulate_gate_list`` of ``circuit_for_data`` for
   two points, op by op at chi 64, against the route's own states (1 minus
   the normalized overlap within 3e-5).
10. checkpoint and resume: ``QMLTPU_CHECKPOINT=1`` (tile 32, raw Grams with
   ``QMLTPU_NORMALIZE=0``) through ``cli.main_no_test``: the full run, a
   partial checkpoint holding its first tile, the resumed run equal to the
   full one (1e-7; bit-equality printed), the file gone after each run.
10b. mesh: the multi-device Gram build (``parallel/``) through
   ``parallel.mesh.launch`` on NCCL, one process a card, at every world size
   from 1 to min(4, cards) (printed; 1 on a one-card machine), one launch a
   world size: the headline train Gram on the ring, stepwise and
   ``QMLTPU_RING=fused`` (the same loop without per-iteration syncs, only
   the aggregate time; golden 1e-6, the single-device default route's Gram
   2e-6, each other 1e-7; launches counted against the rank's sim
   dispatches; sim, ring and per-iteration seconds and peak memory
   printed, beside the single-device build in the rank's process); a ring
   snapshot after iteration 0 resumed by
   ``cli.main_no_test`` with ``QMLTPU_CHECKPOINT=1`` (bit-equal, the file
   gone); ``cli.main`` on 20 + 20 points against the same run on one device
   (2e-6) with its SVC sweep; the dry run (``parallel/dryrun``, 2e-6).
10c. site-sharded: the site-sharded brick engine (``parallel/sharded_mps``,
   ``QMLTPU_SHARD_MPS=all``) through ``parallel.mesh.launch`` on NCCL at the
   same world sizes, one launch a world size: ``cli.main_no_test`` at nf 100,
   chi 128 on 8 circuits through K5 and through K1, and at 14 qubits (K5),
   each Gram held to phase 7's whole-chain Gram (1e-6) and its launches to
   the brick plan, and each gathered MPS to the whole-chain simulator in the
   rank's process (bond dims equal, fidelity rtol 1e-6, tensors 2e-6; the
   two timed in turns); ``sharded_gram`` on the nf-100 points against the
   K5 Gram (5e-6) and the relay's symmetric tiles against all tiles (the
   mirrored block exactly transposed, 2e-6); the dry run's site-sharded part
   (1e-6). Sim, relay and peak memory printed beside the whole chain's.
11. ``QMLTPU_CHI=auto`` through ``cli.main`` on 20 + 20 points, probes
   capped at chi 64: one probe sequence (chi, min fidelity, max bond
   printed) serves the train and the test Gram.
12. ``cli.main_track_mem`` at nf 100, r 2, d 6, chi 64, one circuit: one
   ``MPS size`` line per op of the schedule (3744), all positive.
12b. harness: the experiment suites of ``qml_cutensornet_tpu_torch/runs``
   into a temporary directory, ``PREWARM=0``: qubit_scaling at nf 30, gamma
   1.0, 5 + 5 points, d 6 (cap 64) and crossover at d 2 (nf 100, cap 64) in
   both modes, then their ``csv`` steps; every row against its profiling
   JSON, every Gram symmetric with a unit diagonal, the launches against
   the op stream's (K1 and K2); then runtime_scaling's ``run`` at nf 165,
   d 1, 4 + 4 points in this process and on the ring at world size 1, and
   its ``ladder`` rung at world size 1 (16 qubits, chi 64, truncating),
   each Gram against its in-process or single-device twin.
13. residency: ``cli.main_no_test`` at the crossover sweep's d-8
   configuration (nf 100, r 2, d 8, chi 256, 5 + 5 points, one sim batch of
   8) with the default ``QMLTPU_STATES_DEVICE_BYTES`` (the states stay on
   the card) and with 0 (host-resident states, one trimmed upload a tile;
   its simulation is the first run's, replayed from a host copy): the
   regime each run reports, the two Grams within 1e-7 (bit-equality
   printed), and each run's sim, tile and upload seconds, peak memory,
   avg_max_chi and avg_fidelity.
14. reduced precisions (kernel K7, ``ops/lowp.py``: the bf16 tensor-core
   complex product of ``QMLTPU_POWER_PRECISION`` and
   ``QMLTPU_TILE_PRECISION``): (a) every plan's registers, local and shared
   bytes; K7 at three passes and at one against its plain version and the
   exact product at the headline tile's two products of a site block
   ([32,2048,64] . [32,64,256] and [32,256,64]^H . [32,256,2048]), the
   chi-64 power products, ragged shapes and each side of every plan
   boundary (op "h" on a, on b and on both), two launches bit-equal; at
   the main shapes its plan, device time (``graph_ms``: a CUDA graph of 20
   launches), call time and host time beside ``torch.matmul`` in full f32
   (device and call) and its bound; (b) ``cli.main_no_test`` at the headline shape
   with the tile precision "high", then "bfloat16", and the power precision
   "high": golden 8x8 parity (printed), the Gram against the default
   route's, K7 launches equal to the op stream's and the tiles' count (K1
   none on the power route); (c) the golden's 8 points simulated once,
   their tiles by K7, by its plain version and in full f32 against the
   golden. On every other route K7 launches 0 times.
15. the reduced ambient class (``SimConfig.matmul_precision``: every
   product of the engine on K7, ``ops/lowp.matmul``): (a) K7 at the
   engine's shapes as the engine lays them out (theta, the gate with K = 4
   at an inner stride 0, the center moves' products with ``a r^H`` as ``r``
   and ``op_b`` "h", the split's r, a power product with a broadcast start
   block, ``vdot``, a single column, the Hadamard layer's batch stride 0
   and on a slice of sites, two levels) at three passes and one against
   its plain version and the exact product, two launches bit-equal, its
   plan, device, call and host times beside ``torch.matmul`` in f32 and its
   bound; (b) the
   golden's 8 points (headline shape, one sim batch, the CLI's config)
   through ``models/gram.build_kernel_matrix`` at "high", then "bfloat16":
   K1, K4 and K5 never, K2 on every center move, K3 and K7 as the op stream
   and the tile say, golden, ``K - K^T`` and the default route's Gram
   printed, and the same run with K7's plain version held to it; (c) the
   brick route at 14 qubits, chi 128, "high", likewise (K5 and K1 never).

On every route the launch counters (K1 to K5, K7 and K8) must equal the
counts worked out from the op stream (the brick layers' chunk plan on the
brick route, its caps buckets under ``QMLTPU_BRICK_CAPS``; the tiles at a
reduced tile precision; every product at a reduced ambient class; one K8
launch a scanned panel at a full class) and the routing rules, every launch
of K1 to K5 must come from the pair libraries exactly when the pair step is
on (f32), none of K7's or K8's, and no plain version may have run on a CUDA
tensor. The last three lines of stdout are the card's name and power
limit, the kernels summary JSON and the result JSON ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import os
import pathlib
import shutil
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

CSV_V1, CSV_V2 = "elliptic_preproc_bench.csv", "elliptic_preproc_v2.csv"
ARGV = ["main", "GPU", "32", "2", "1.0", "6", "64", "64", "5", CSV_V1]
# 20 + 20 points: 32 train points, one sim batch.
ARGV_ONE_BATCH = ["main", "GPU", "32", "2", "1.0", "6", "20", "20", "5", CSV_V1]
ARGV_CHI256 = ["main", "GPU", "16", "2", "1.0", "6", "20", "20", "5", CSV_V1]
# The svd and eigh routes: the first SVD_POINTS train points of the headline
# draw (the golden's 8), one sim batch: cuSOLVER factors each matrix of a
# batch in turn, so a batch of 32 takes minutes.
SVD_POINTS = 8
# The svd route runs one rep (r 1) of the headline circuit: cuSOLVER's gesvd
# took 145 s for the two reps of 8 circuits, whatever the batch.
ARGV_SVD = ARGV[:3] + ["1"] + ARGV[4:]
# The brick route: 14 qubits on one sim batch of 32, and the full width, nf
# 100 on 5 + 5 points (8 train points, one sim batch of 8).
ARGV_BRICK14 = ["main", "GPU", "14", "2", "1.0", "6", "20", "20", "5", CSV_V1]
ARGV_BRICK100 = ["main", "GPU", "100", "2", "1.0", "6", "5", "5", "5", CSV_V1]
BRICK_KNOBS = {"QMLTPU_CHI": "128", "QMLTPU_OVERSAMPLE": "0"}
BRICK_BN = 8 * 51  # pairs of one full-width layer: 8 circuits x 51 pairs (nf 100)
# The residency phase: the crossover sweep's d-8 configuration at full width
# (``runs/crossover/run_all.sh``: nf 100, r 2, gamma 1.0, d 8, chi_for_d(8) =
# 256) on 5 + 5 points (8 train points), one sim batch of 8: above chi 128
# an op costs the same for 3 to 8 circuits, so a second batch would double
# the phase (two batches of 5 took 225 to 350 s); the card test
# ``test_host_resident_states_on_card`` assembles three batches.
ARGV_D8 = ["main", "GPU", "100", "2", "1.0", "8", "5", "5", "5", CSV_V1]
RESIDENCY_KNOBS = {"QMLTPU_CHI": "256", "QMLTPU_SIM_BATCH": "8"}
GOLDEN = ROOT / "runs/golden/bench_nq32_r2_d6_g1.0_N8.npz"
RAW_V1 = ROOT / "datasets/elliptic_bitcoin_dataset_v1"
RAW_V2 = ROOT / "datasets/elliptic_bitcoin_dataset"  # generator version 2: tied levels
WORK = ROOT / "build" / "smoke"

# Tolerances, f32 kernel vs plain version on the same card. The two run the
# same algorithm with different summation orders, so they differ by f32
# rounding amplified by the conditioning of the inputs (graded spectra span
# two decades here).
TOL_PROJ = 2e-5  # projectors QQ^H; the reference's fused-vs-unfused bar on q/r
TOL_PROD = 2e-5  # products QR (relative to max |input|); same bar
TOL_ORTH = 5e-6  # |Q^H Q - I| on non-zero columns; the reference kernel tests' bar
TOL_S2 = 2e-5  # sorted squared singular values, relative to the largest
TOL_TOT = 1e-5  # ||theta||^2 of the gate kernel, relative
TOL_GOLDEN = 1e-6  # leading 8x8 Gram block vs the f64 golden (ROADMAP bar)
TOL_ROUTES = 3e-5  # Gram of one route vs another; the reference's fused-vs-unfused bar
TOL_F64 = 1e-5  # chi-256 and chi-128 f32 Gram vs the port's f64 Gram on the card
TOL_KKT = 1e-3  # the SVC's stopping tolerance
# Host-resident states against device-resident ones: the same kernels on the
# same inputs, so the Grams should be equal to the bit; a tile trimmed to its
# own bucket runs its products at another shape, which may group a sum
# otherwise.
TOL_RESIDENCY = 1e-7
# nf 100 brick Gram through K5 vs through K1 at chi 128: both runs truncate,
# and their kept subspaces differ by rounding, which truncating every bond of
# 100 qubits can carry past the 3e-5 of runs that truncate nothing.
TOL_BRICK_ROUTES = 1e-4


KERNEL_TABLE = (
    ("split", "qml_cutensornet_tpu_torch/csrc/subspace_split.cu",
     "qml_cutensornet_tpu/ops/pallas_split.py:145"),
    ("orth_r", "qml_cutensornet_tpu_torch/csrc/orth_r.cu",
     "qml_cutensornet_tpu/ops/pallas_qr.py:241"),
    ("orth", "qml_cutensornet_tpu_torch/csrc/orth.cu",
     "qml_cutensornet_tpu/ops/pallas_qr.py:232"),
    ("gate_split", "qml_cutensornet_tpu_torch/csrc/gate_split.cu",
     "qml_cutensornet_tpu/ops/pallas_split.py:158"),
    ("brick_split", "qml_cutensornet_tpu_torch/csrc/brick_split.cu",
     "qml_cutensornet_tpu/ops/pallas_split.py:603"),
)
KERNEL_NAMES = tuple(row[0] for row in KERNEL_TABLE)
# K7, the bf16 tensor-core complex product of the reduced power and tile
# precisions; it has no pair library. The launch counters hold K1 to K5 and
# K7 (``ops/_build.KERNELS``).
K7 = ("cgemm", "qml_cutensornet_tpu_torch/csrc/bf16_cgemm.cu",
      "qml_cutensornet_tpu/ops/svd.py:236, :240 and qml_cutensornet_tpu/models/simulate.py:931 "
      "(XLA dots under HIGH and DEFAULT, not Pallas kernels)")
# K8, the scanned MGS2 panel step of the blocked orthonormalizer, built once
# like K7 (``ops/_build.SINGLE_BUILD``).
K8 = ("mgs2_panel", "qml_cutensornet_tpu_torch/csrc/mgs2_panel.cu",
      "qml_cutensornet_tpu/ops/blocked_qr.py:58 (_mgs2_panel, a lax.scan that XLA compiles, "
      "called at :157; not a Pallas kernel)")
LAUNCH_NAMES = KERNEL_NAMES + (K7[0], K8[0])


def log(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------- inputs

def _crandn(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _graded(rng, B, m, k, lo):
    """U diag(s) W^H with s geometric from 1 down to ``lo``."""
    r = min(m, k)
    u, _ = np.linalg.qr(_crandn(rng, B, m, r))
    w, _ = np.linalg.qr(_crandn(rng, B, k, r))
    s = np.geomspace(1.0, lo, r)
    return (u * s[None, None, :]) @ w.conj().transpose(0, 2, 1)


def make_input(rng, kind, B, m, k, chi):
    """An [B, m, k] complex input of the given kind, max |entry| = 1."""
    if kind == "full":
        x = _crandn(rng, B, m, k)
    elif kind == "rankdef":
        r = max(1, min(m, k) // 2)
        x = _crandn(rng, B, m, r) @ _crandn(rng, r, k)
    elif kind == "padded":
        # Engine-like padding: live bond b < chi, rows (al, s) with al >= b
        # and columns beyond the live bond are exact zeros.
        b = max(1, chi // 2)
        x = _crandn(rng, B, m, k)
        rows = np.arange(m) // 2 >= b
        x[:, rows, :] = 0
        cols = (np.arange(k) % chi >= b) if k == 2 * chi else (np.arange(k) >= b)
        x[:, :, cols] = 0
    elif kind == "graded":
        x = _graded(rng, B, m, k, 1e-2)
    else:
        raise ValueError(kind)
    return (x / np.abs(x).max()).astype(np.complex64)


def make_pair(rng, kind, B, chi, dev):
    """Two site tensors ``a, b [B, chi, 2, chi]`` of the given kind and
    random unitary gates ``g [B, 4, 4]``, on the card."""
    a = make_input(rng, kind, B, 2 * chi, chi, chi).reshape(B, chi, 2, chi)
    b = make_input(rng, kind, B, chi, 2 * chi, chi).reshape(B, chi, 2, chi)
    g, _ = np.linalg.qr(_crandn(rng, B, 4, 4))
    return tuple(torch.from_numpy(x).to(dev) for x in (a, b, g.astype(np.complex64)))


def make_brick(rng, kind, Bn, chi, swap_w, dev):
    """K5's inputs for ``Bn`` pairs: ``A [Bn, 2chi, chi]``, ``Bm [Bn, chi,
    2chi]``, the brick's blended gates ``g [Bn, 4, 4]`` (XXPhase, or
    XXPhase@SWAP for ``swap_w`` 1, at random angles) and left-bond weights
    ``lam [Bn, chi]``. "full": every entry live. "padded": engine-like
    padding, the left bond live up to 5 (its weights exact zeros past 5),
    the middle and right bonds up to chi // 2."""
    from qml_cutensornet_tpu_torch.ops import gates

    a = _crandn(rng, Bn, chi, 2, chi)
    b = _crandn(rng, Bn, chi, 2, chi)
    lam = rng.uniform(0.3, 1.0, size=(Bn, chi))
    if kind == "padded":
        a[:, 5:] = 0
        a[..., chi // 2:] = 0
        b[:, chi // 2:] = 0
        b[..., chi // 2:] = 0
        lam[:, 5:] = 0
    a = (a / np.abs(a).max()).astype(np.complex64)
    b = (b / np.abs(b).max()).astype(np.complex64)
    A = np.ascontiguousarray(a.transpose(0, 2, 1, 3)).reshape(Bn, 2 * chi, chi)
    xx = gates.xxphase(torch.from_numpy(rng.uniform(-1.5, 1.5, size=Bn).astype(np.float32)))
    g = swap_w * xx[..., [0, 2, 1, 3]] + (1.0 - swap_w) * xx
    return (torch.from_numpy(A).to(dev), torch.from_numpy(b.reshape(Bn, chi, 2 * chi)).to(dev),
            g.contiguous().to(dev), torch.from_numpy(lam.astype(np.float32)).to(dev))


# -------------------------------------------------------------- comparisons

def compare(qk, rk, qp, rp, x, what, with_s2, surplus=False):
    """Basis-invariant comparison of kernel (qk, rk) and plain (qp, rp)
    factorizations of x; asserts the tolerances and returns the larger of
    the projector and product errors. ``with_s2`` also compares the sorted
    squared row norms of r (the split's singular-value estimates).

    ``surplus`` is for a split with more columns than x has rank (the
    oversampled split of a state whose live bond is below the cap). The
    surplus columns are rounding residuals at the dependent-column cutoff:
    here and there one survives it, in the kernel or in the plain version,
    as a unit vector orthogonal to the rest whose row of r is zero to
    rounding. Which ones survive is not a property of the function, so the
    sets of kept columns and the bare projectors are not compared; the
    product q r (the projector weighted by what it is applied to), the sorted
    s2, the orthonormality of every kept column and the exact zeros are."""
    proj = 0.0 if surplus else (qk @ qk.mH - qp @ qp.mH).abs().max().item()
    scale = x.abs().max().item()
    prod = ((qk @ rk - qp @ rp).abs().max().item()) / scale
    nzk = qk.abs().pow(2).sum(1) > 0.25
    nzp = qp.abs().pow(2).sum(1) > 0.25
    assert surplus or torch.equal(nzk, nzp), f"{what}: kernel and plain keep different columns"
    dead = (~nzk)[:, None, :].expand_as(qk)
    assert torch.count_nonzero(qk[dead]) == 0, f"{what}: dropped columns not exact zeros"
    zero_rows = (x.abs().sum(2) == 0)[:, :, None].expand_as(qk)
    assert torch.count_nonzero(qk[zero_rows]) == 0, f"{what}: zero rows of input leaked"
    qz = qk * nzk[:, None, :]
    eye = torch.diag_embed(nzk.to(qk.real.dtype)).to(qk.dtype)
    orth = (qz.mH @ qz - eye).abs().max().item()
    s2 = 0.0
    if with_s2:
        s2k = torch.sort(rk.abs().pow(2).sum(2), dim=1, descending=True).values
        s2p = torch.sort(rp.abs().pow(2).sum(2), dim=1, descending=True).values
        s2 = ((s2k - s2p).abs().max() / s2p.max()).item()
    log(f"  {what}: proj {'not compared' if surplus else f'{proj:.2e}'} prod {prod:.2e} "
        f"orth {orth:.2e} s2 {s2:.2e} kept {int(nzk.sum(1).min())}..{int(nzk.sum(1).max())}")
    assert proj <= TOL_PROJ, f"{what}: projector error {proj} > {TOL_PROJ}"
    assert prod <= TOL_PROD, f"{what}: product error {prod} > {TOL_PROD}"
    assert orth <= TOL_ORTH, f"{what}: orthonormality error {orth} > {TOL_ORTH}"
    assert s2 <= TOL_S2, f"{what}: sorted s2 error {s2} > {TOL_S2}"
    return max(proj, prod)


def compare_orth(orth_mod, v, what, pair=False):
    """Kernel K3 against its plain version on ``v`` (r = q^H v on both sides)."""
    qk, qp = orth_mod.orth_cuda(v, pair), orth_mod.orth_plain(v, pair)
    torch.cuda.synchronize()
    return compare(qk, qk.mH @ v, qp, qp.mH @ v, v, what, False)


def resid_errors(split_mod, resk, resp, theta, q, r, tot):
    """The residual ``||theta - q r||^2`` of K4 or K5 against its plain
    version's (relative to the largest total; the two bases differ by
    rounding, as the sorted s2 do) and against the residual of the kernel's
    own factors (relative to each total), each held to its bar."""
    vs_plain = ((resk - resp).abs().max() / tot.max()).item()
    own = ((resk - split_mod.residual_norm2(theta, q, r)).abs() / tot).max().item()
    assert vs_plain <= TOL_S2, f"residual vs plain {vs_plain} > {TOL_S2}"
    assert own <= TOL_TOT, f"residual vs the kernel's factors {own} > {TOL_TOT}"
    return vs_plain, own


def compare_gate(split_mod, A, Bm, g, v0, iters, what, surplus=False, pair=False):
    """Kernel K4 against its plain version: the factorization of theta,
    ``tot = ||theta||^2`` and ``resid = ||theta - q r||^2`` (``surplus`` as in
    :func:`compare`)."""
    qk, rk, totk, resk = split_mod.gate_subspace_factor_cuda(A, Bm, g, v0, iters, pair)
    qp, rp, totp, resp = split_mod.gate_subspace_factor_plain(A, Bm, g, v0, iters, pair)
    torch.cuda.synchronize()
    theta = split_mod.gate_theta(A, Bm, g)
    tot_err = max(((totk - totp).abs() / totp).max().item(),
                  ((totk - theta.abs().pow(2).sum((1, 2))).abs() / totp).max().item())
    assert tot_err <= TOL_TOT, f"{what}: tot error {tot_err} > {TOL_TOT}"
    res_err = resid_errors(split_mod, resk, resp, theta, qk, rk, totp)
    log(f"  {what}: tot {tot_err:.2e} resid {res_err[0]:.2e} (vs plain), {res_err[1]:.2e} "
        f"(vs its factors)")
    return max(compare(qk, rk, qp, rp, theta, what, True, surplus), tot_err, *res_err)


def compare_brick(split_mod, A, Bm, g, lam, v0, iters, what, pair=False):
    """Kernel K5 against its plain version, on quantities that do not depend
    on the basis: the projected pair ``theta_t V^H V`` (from na0 and q2,
    relative to max |theta_t|), the sorted s2 (relative to the largest),
    ``||theta_w||^2``, the orthonormality of the kept rows, and exact zeros
    (dropped rows; the columns of zero rows and columns of theta). A kept
    row set is not compared: where the weighted theta's rank is below nc a
    surplus row can survive the dependent-column cutoff by rounding in
    either version, as in K1's comparison (it adds nothing to the projected
    pair: theta_t has no rows where the weights are zero)."""
    q2, na0, s2, tot, res = split_mod.brick_gate_split_cuda(A, Bm, g, lam, v0, iters, pair)
    pq2, pna0, ps2, ptot, pres = split_mod.brick_gate_split_plain(A, Bm, g, lam, v0, iters, pair)
    torch.cuda.synchronize()
    theta_t = split_mod.gate_theta(A, Bm, g)
    th_h, q = (theta_t * torch.cat([lam, lam], 1)[:, :, None]).mH, q2.mT
    res_err = resid_errors(split_mod, res, pres, th_h, q, q.mH @ th_h, ptot)
    proj = lambda na, q: na.mT @ q.conj()
    prod = ((proj(na0, q2) - proj(pna0, pq2)).abs().max() / theta_t.abs().max()).item()
    srt = lambda x: torch.sort(x, dim=1, descending=True).values
    s2e = ((srt(s2) - srt(ps2)).abs().max() / ps2.max()).item()
    tot_err = ((tot - ptot).abs() / ptot).max().item()
    live = q2.abs().pow(2).sum(2) > 0.25
    eye = torch.diag_embed(live.to(q2.real.dtype)).to(q2.dtype)
    orth_err = (q2.conj() @ q2.mT - eye).abs().max().item()
    assert torch.count_nonzero(q2[~live]) == 0 and torch.count_nonzero(na0[~live]) == 0, (
        f"{what}: dropped rows not exact zeros")
    zero_rows = theta_t.abs().sum(2) == 0  # (s al) of theta_t: columns of na0
    zero_cols = theta_t.abs().sum(1) == 0  # (t be): columns of q2
    assert torch.count_nonzero(na0.transpose(1, 2)[zero_rows]) == 0, f"{what}: na0 leaked"
    assert torch.count_nonzero(q2.transpose(1, 2)[zero_cols]) == 0, f"{what}: q2 leaked"
    log(f"  {what}: prod {prod:.2e} s2 {s2e:.2e} tot {tot_err:.2e} orth {orth_err:.2e} "
        f"resid {res_err[0]:.2e} / {res_err[1]:.2e} "
        f"kept {int(live.sum(1).min())}..{int(live.sum(1).max())}")
    assert prod <= TOL_PROD, f"{what}: projected-pair error {prod} > {TOL_PROD}"
    assert s2e <= TOL_S2, f"{what}: sorted s2 error {s2e} > {TOL_S2}"
    assert tot_err <= TOL_TOT, f"{what}: total error {tot_err} > {TOL_TOT}"
    assert orth_err <= TOL_ORTH, f"{what}: orthonormality error {orth_err} > {TOL_ORTH}"
    return max(prod, s2e, tot_err, *res_err)


def time_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, launches=20, replays=5):
    """Device time of one call of ``fn`` alone, without its host path: the
    mean over ``replays`` replays of a CUDA graph that captures ``launches``
    calls, by CUDA events (``fn`` allocates through the graph's pool)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (launches * replays)
    del graph
    torch.cuda.empty_cache()
    return ms


def host_ms(fn, reps=50):
    """Host time of one call of ``fn``: the host clock around ``reps``
    calls that are only enqueued (the device may still be busy)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def plan_text(plan):
    """One launch plan of K1 or K2 (``ops/split.split_plan``,
    ``ops/orth.orth_r_plan``) as a log fragment: blocks, threads, shared
    memory and where each buffer lives."""
    where = {k: v for k, v in dataclasses.asdict(plan).items()
             if k not in ("threads", "grid", "smem_bytes", "scratch_cx")}
    return (f"{plan.grid} blocks x {plan.threads} threads, {plan.smem_bytes} B shared, "
            + ", ".join(f"{k}={int(v)}" for k, v in where.items()))


PARENT = ROOT / "build" / "parent" / "qml_cutensornet_tpu_torch" / "csrc"


PARENT_SOURCES = ("subspace_split", "orth_r", "gate_split", "brick_split", "orth", "mgs2_panel")
PARENT_LIBS = ROOT / "build" / "parent_kernels"


def parent_build_start():
    """Start building the parent commit's K1 to K5 from
    ``build/parent`` (the parent unpacked there by ``git archive``), one
    ``nvcc`` each, all at once; None where that directory is absent."""
    import subprocess

    from qml_cutensornet_tpu_torch.ops import _build

    if not PARENT.is_dir():
        return None
    PARENT_LIBS.mkdir(parents=True, exist_ok=True)
    procs = {src: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(PARENT_LIBS / f"lib{src}.so"),
         str(PARENT / f"{src}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in PARENT_SOURCES}
    # A check that fails before the builds are waited for leaves no nvcc behind.
    atexit.register(lambda: [proc.kill() for proc in procs.values() if proc.poll() is None])
    return procs


def parent_kernels(dev, built):
    """The parent commit's K1 to K5 (single-column) and K8, once
    :func:`phase_build` has ``built`` them, called through their own C
    interfaces with the current launch plans, or None where there is no
    parent. Timing only: each is checked once against the current kernel on
    a basis-invariant quantity."""
    import ctypes
    import types

    from qml_cutensornet_tpu_torch.ops import _build

    if built is None:
        return None
    out, srcs = PARENT_LIBS, PARENT_SOURCES
    ks, kr, kg, kb, ko, km = (ctypes.CDLL(str(out / f"lib{src}.so")) for src in srcs)
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ks.qk_split_launch.argtypes = [vp] * 5 + [i] * 7 + [ll, vp, i, i]
    ks.qk_split_launch.restype = i
    kr.qk_orth_r_launch.argtypes = [vp] * 4 + [i] * 5 + [ll, vp, i]
    kr.qk_orth_r_launch.restype = i
    kg.qk_gate_split_launch.argtypes = [vp] * 8 + [i] * 8 + [ll, vp]
    kg.qk_gate_split_launch.restype = i
    kb.qk_brick_split_launch.argtypes = [vp] * 10 + [i] * 8 + [ll, vp]
    kb.qk_brick_split_launch.restype = i
    ko.qk_orth_launch.argtypes, ko.qk_orth_launch.restype = [vp] * 3 + [i] * 7 + [ll, vp], i
    km.qk_mgs2_launch.argtypes = [vp] * 4 + [i] * 4 + [ctypes.c_double, i, ll, vp]
    km.qk_mgs2_launch.restype = i
    optin = _build.smem_optin(dev.index)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream

    # The parent's K1 to K5 take the current C interfaces and launch plans
    # (ops/split.split_plan, gate_split_plan, brick_split_plan,
    # ops/orth.orth_r_plan, orth_plan).
    from qml_cutensornet_tpu_torch.ops import orth as orth_mod
    from qml_cutensornet_tpu_torch.ops import split as split_mod

    def split(th, v0, iters):
        B, m, k = th.shape
        nc = v0.shape[1]
        plan = split_mod.split_plan(B, m, k, nc, th.dtype, optin)
        q = torch.empty((B, m, nc), dtype=th.dtype, device=dev)
        r = torch.empty((B, nc, k), dtype=th.dtype, device=dev)
        scratch = torch.empty((B, plan.scratch_cx), dtype=th.dtype, device=dev)
        rc = ks.qk_split_launch(th.data_ptr(), v0.data_ptr(), q.data_ptr(), r.data_ptr(),
                                scratch.data_ptr(), B, m, k, nc, iters, 0, int(plan.rows_smem),
                                plan.smem_bytes, stream(), int(plan.theta_smem),
                                int(plan.inplace))
        assert rc == 0, f"parent split launch: CUDA error {rc}"
        return q, r

    def orth_r(v):
        B, m, k = v.shape
        plan = orth_mod.orth_r_plan(B, m, k, v.dtype, optin)
        q = torch.empty_like(v)
        r = torch.empty((B, k, k), dtype=v.dtype, device=dev)
        scratch = torch.empty((B, plan.scratch_cx), dtype=v.dtype, device=dev)
        rc = kr.qk_orth_r_launch(v.data_ptr(), q.data_ptr(), r.data_ptr(), scratch.data_ptr(),
                                 B, m, k, 0, int(plan.rows_smem), plan.smem_bytes, stream(),
                                 int(plan.v_smem))
        assert rc == 0, f"parent orth_r launch: CUDA error {rc}"
        return q, r

    def gate_split(A, Bm, g, v0, iters):
        B, m, chi = A.shape
        nc = v0.shape[1]
        plan = split_mod.gate_split_plan(B, chi, nc, A.dtype, optin)
        q = torch.empty((B, m, nc), dtype=A.dtype, device=dev)
        r = torch.empty((B, nc, m), dtype=A.dtype, device=dev)
        tot = torch.empty(B, dtype=A.real.dtype, device=dev)
        scratch = torch.empty((B, plan.scratch_cx), dtype=A.dtype, device=dev)
        rc = kg.qk_gate_split_launch(A.data_ptr(), Bm.data_ptr(), g.data_ptr(), v0.data_ptr(),
                                     q.data_ptr(), r.data_ptr(), tot.data_ptr(),
                                     scratch.data_ptr(), B, chi, nc, iters, 0,
                                     int(plan.theta_smem), int(plan.rows_smem),
                                     int(plan.inplace), plan.smem_bytes, stream())
        assert rc == 0, f"parent gate_split launch: CUDA error {rc}"
        return q, r, tot

    def brick_split(A, Bm, g, lam, v0, iters):
        B, m, chi = A.shape
        nc = v0.shape[1]
        plan = split_mod.brick_split_plan(B, chi, nc, A.dtype, optin)
        q2 = torch.empty((B, nc, m), dtype=A.dtype, device=dev)
        na0 = torch.empty((B, nc, m), dtype=A.dtype, device=dev)
        s2 = torch.empty((B, nc), dtype=lam.dtype, device=dev)
        tot = torch.empty(B, dtype=lam.dtype, device=dev)
        scratch = torch.empty((B, plan.scratch_cx), dtype=A.dtype, device=dev)
        rc = kb.qk_brick_split_launch(A.data_ptr(), Bm.data_ptr(), g.data_ptr(), lam.data_ptr(),
                                      v0.data_ptr(), q2.data_ptr(), na0.data_ptr(), s2.data_ptr(),
                                      tot.data_ptr(), scratch.data_ptr(), B, chi, nc, iters, 0,
                                      int(plan.theta_smem), int(plan.rows_smem),
                                      int(plan.inplace), plan.smem_bytes, stream())
        assert rc == 0, f"parent brick_split launch: CUDA error {rc}"
        return q2, na0, s2, tot

    def orth(v):
        B, m, k = v.shape
        plan = orth_mod.orth_plan(B, m, k, v.dtype, optin)
        q = torch.empty_like(v)
        scratch = torch.empty((B, plan.scratch_cx), dtype=v.dtype, device=dev)
        rc = ko.qk_orth_launch(v.data_ptr(), q.data_ptr(), scratch.data_ptr(), B, m, k,
                               int(v.dtype == torch.complex128), int(plan.rows_smem),
                               plan.group_warps, plan.group_epl, plan.smem_bytes, stream())
        assert rc == 0, f"parent orth launch: CUDA error {rc}"
        return q

    def mgs2(a, n2):
        # The parent's K8 with its own plan (the first version's): the rows
        # [P][m + 1] in shared memory where they fit beside its 2048 values
        # of static slots, else in global scratch.
        B, m, p = a.shape
        cx = 16 if a.dtype == torch.complex128 else 8
        rows = p * (m + 1) * cx
        in_smem = rows + 2048 * cx // 2 <= optin
        q = torch.empty_like(a)
        scratch = torch.empty((B, 0 if in_smem else p * (m + 1)), dtype=a.dtype, device=dev)
        rc = km.qk_mgs2_launch(a.data_ptr(), n2.data_ptr(), q.data_ptr(), scratch.data_ptr(), B,
                               m, p, int(cx == 16), orth_mod.dep_tol2(a.dtype), int(in_smem),
                               rows if in_smem else 0, stream())
        assert rc == 0, f"parent mgs2_panel launch: CUDA error {rc}"
        return q

    log(f"parent kernels built from {PARENT}")
    return types.SimpleNamespace(split=split, orth_r=orth_r, gate_split=gate_split,
                                 brick_split=brick_split, orth=orth, mgs2=mgs2)


# ------------------------------------------------------------------ bounds
# Operations and bytes from the shapes. One complex multiply-add is 8 real
# operations; complex64 is 8 bytes. Each input is read once and each output
# written once, whatever the kernel reads again.

def _orth_ops(length, ncols):
    """BCGS2 of ``ncols`` vectors of ``length``: every column is projected
    twice (coefficient + update) against all earlier columns, then normed
    and scaled."""
    return 8.0 * 2 * length * ncols * (ncols - 1) + 8.0 * length * ncols


def _chain_ops(m, k, nc, iters):
    products = (2 * iters + 1) * 8.0 * m * k * nc
    return products + iters * (_orth_ops(k, nc) + _orth_ops(m, nc))


def bound(ops, nbytes):
    """The least time in ms for ``ops`` and ``nbytes``: the larger of the
    operations over the card's f32 peak (outside the tensor cores) and the
    bytes over its memory rate, the published H100 SXM figures at 700 W
    (``utils/flops.PEAKS``)."""
    from qml_cutensornet_tpu_torch.utils.flops import phase_time_floors

    t = phase_time_floors(ops, nbytes, "h100")
    t_ops, t_bytes = t["compute_s"], t["hbm_s"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def brick_bound(Bn, chi, nc, iters):
    """K5 on ``Bn`` pairs: the theta build (A·B, the gate combine, the lambda
    weight), the chain on theta_w^H (its last product gives s2), the residual
    product and the na0 product; inputs A, B, g, lam and v0 read once, q2,
    na0, s2, total and resid written once."""
    m = 2 * chi
    ops = Bn * (_chain_ops(m, m, nc, iters) + 2 * 8.0 * m * nc * m + 8.0 * m * chi * m
                + 8.0 * 4 * m * m + 2.0 * m * m)
    nbytes = 8.0 * (Bn * (2 * m * chi + 16 + 2 * nc * m) + m * nc) + 4.0 * Bn * (chi + nc + 2)
    return bound(ops, nbytes)


def kernel_bounds(B, chi, iters):
    m, k, nc = 2 * chi, 2 * chi, chi
    c = 8.0  # bytes per complex64
    return {
        "split": bound(B * _chain_ops(m, k, nc, iters),
                       c * (B * m * k + m * nc + B * m * nc + B * nc * k)),
        "orth_r": bound(B * (_orth_ops(m, chi) + 8.0 * chi * chi * m),
                        c * B * (2 * m * chi + chi * chi)),
        "orth": bound(B * _orth_ops(m, chi), c * B * 2 * m * chi),
        "gate_split": bound(  # the theta build, the chain, the residual product
            B * (_chain_ops(m, k, nc, iters) + 8.0 * m * chi * k + 8.0 * 4 * m * k
                 + 8.0 * m * k * nc),
            c * (B * (2 * m * chi + 16) + m * nc + B * m * nc + B * nc * k) + 2 * 4.0 * B),
    }


# ----------------------------------------------------------------- phases

def phase_build(dev):
    """Build the kernels (timed), after the parent commit's where its
    sources were unpacked into ``build/parent`` (timed alone first, on the
    same machine: the build before and after this tree's change). Returns
    ``{source: nvcc output}`` of the parent's build, or None."""
    from qml_cutensornet_tpu_torch.ops import _build, orth

    parent_procs, parent_built = parent_build_start(), None
    if parent_procs is not None:
        t0 = time.perf_counter()
        parent_built = {}
        for src, proc in parent_procs.items():
            parent_built[src] = proc.communicate()[0]
            assert proc.returncode == 0, f"parent {src}.cu did not build:\n{parent_built[src]}"
        log(f"build of the parent's {len(parent_procs)} sources alone (one nvcc each, all at "
            f"once): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.2f} s -> {_build.BUILD_INFO['path']}; each library's nvcc ended at "
        + ", ".join(f"{name} {sec:.1f} s" for name, sec in sorted(
            _build.BUILD_INFO["seconds_by_library"].items(), key=lambda kv: kv[1]))
        + f" (K7, bf16_cgemm: {_build.BUILD_INFO['seconds_by_library'].get('bf16_cgemm', 0):.1f}"
        " s)")
    for line in _build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())
    # Negative control: a launch refused for too much dynamic shared memory
    # must raise through the cudaGetLastError check and count no launch.
    optin = _build.smem_optin(dev.index)
    v = torch.zeros((2, 32, 16), dtype=torch.complex64, device=dev)
    before = dict(_build.LAUNCHES)
    try:
        orth.orth_r_cuda(v, smem_bytes=optin + 4096)
    except RuntimeError as exc:
        log(f"negative control: refused launch raised: {exc}")
    else:
        raise AssertionError("a launch over the shared-memory limit did not raise")
    assert _build.LAUNCHES == before, "a refused launch was counted"
    torch.cuda.synchronize()
    return parent_built


def phase_kernels(dev, parent_built):
    from qml_cutensornet_tpu_torch.ops import _build, orth, split
    from qml_cutensornet_tpu_torch.ops.svd import gate_feeds, start_block

    rng = np.random.default_rng(20261016)
    kinds = ("full", "rankdef", "padded", "graded")
    err = dict.fromkeys(KERNEL_NAMES, 0.0)
    optin = _build.smem_optin(dev.index)

    def worst(name, value):
        err[name] = max(err[name], value)

    # B 1, 32 and 100 at chi 8 to 64: K1 and K2 on the launch plans the
    # wrappers choose for complex64 (theta and both row buffers in shared
    # memory up to chi 32, one row buffer at chi 64; K2 with Q and v in
    # shared memory), on 1 to 100 blocks.
    for B in (1, 32, 100):
        for chi in (8, 16, 32, 64):
            m = 2 * chi
            v0 = start_block(m, chi, torch.complex64, dev)
            for kind in kinds:
                v = torch.from_numpy(make_input(rng, kind, B, m, chi, chi)).to(dev)
                qk, rk = orth.orth_r_cuda(v)
                qp, rp = orth.orth_r_plain(v)
                torch.cuda.synchronize()
                worst("orth_r", compare(qk, rk, qp, rp, v,
                                        f"orth_r B={B} chi={chi} {kind}", False))
                worst("orth", compare_orth(orth, v, f"orth B={B} chi={chi} {kind}"))
                th = torch.from_numpy(make_input(rng, kind, B, m, m, chi)).to(dev)
                a, b, g = make_pair(rng, kind, B, chi, dev)
                for iters in (1, 2):
                    qk, rk = split.subspace_factor_cuda(th, v0, iters)
                    qp, rp = split.subspace_factor_plain(th, v0, iters)
                    torch.cuda.synchronize()
                    worst("split", compare(
                        qk, rk, qp, rp, th, f"split B={B} chi={chi} iters={iters} {kind}", True))
                    for feed, is_left in (("n", False), ("t", True)):
                        worst("gate_split", compare_gate(
                            split, *gate_feeds(a, b, g, is_left), v0, iters,
                            f"gate_split B={B} chi={chi} iters={iters} {kind} feed={feed}"))

    # K3 at the blocked route's panel shapes (32 columns, m = 2 chi for chi
    # 64, 128, 256 and 1024; at chi 128 and 256 the split is chi + 16 columns
    # wide, so its last panel has 16 columns), at the unfused route's split
    # shapes (k = chi + 16), and on every launch plan its wrapper chooses
    # (ops/orth.orth_plan: the rows in shared memory or in global scratch,
    # times the in-panel group of the length: 4, 8 and 16 warps at one
    # element a lane, the whole block at two, the whole block on the panel
    # in memory), in complex64 and complex128, with two
    # launches of each bit-equal. K4 at chi 128 after it, where rows and
    # theta are in global scratch.
    c64, c128 = torch.complex64, torch.complex128
    plans = {}
    for dtype, m, k in ((c64, 128, 32), (c64, 256, 32), (c64, 256, 16), (c64, 512, 32),
                        (c64, 512, 16), (c64, 2048, 32), (c64, 64, 48), (c64, 128, 80),
                        (c64, 1024, 16), (c64, 1024, 32), (c64, 2048, 8), (c64, 256, 128),
                        (c64, 512, 64),
                        (c128, 128, 64), (c128, 256, 32), (c128, 512, 16), (c128, 1024, 8),
                        (c128, 2048, 4), (c128, 128, 128), (c128, 256, 64), (c128, 512, 32),
                        (c128, 1024, 32), (c128, 2048, 32)):
        plan = orth.orth_plan(32, m, k, dtype, optin)
        plans.setdefault(str(dtype)[6:], set()).add(
            (plan.rows_smem, plan.group_warps, plan.group_epl))
        for kind in kinds:
            v = torch.from_numpy(make_input(rng, kind, 32, m, k, m // 2)).to(dev, dtype)
            worst("orth", compare_orth(orth, v, f"orth B=32 m={m} k={k} {str(dtype)[6:]} {kind} "
                                              f"[{plan_text(plan)}]"))
        first, second = orth.orth_cuda(v), orth.orth_cuda(v)
        torch.cuda.synchronize()
        assert torch.equal(first, second), f"orth m={m} k={k} {dtype}: two launches differ"
    log(f"  orth plans checked (rows_smem, group warps, elements a lane; -1 in memory), two "
        f"launches bit-equal on each: {plans}")
    assert len(plans["complex64"]) == 9 and len(plans["complex128"]) == 10, plans
    v0 = start_block(256, 128, torch.complex64, dev)
    for kind in ("full", "padded"):
        a, b, g = make_pair(rng, kind, 8, 128, dev)
        worst("gate_split", compare_gate(split, *gate_feeds(a, b, g, False), v0, 1,
                                         f"gate_split B=8 chi=128 iters=1 {kind} feed=n"))

    # The other shapes of the chi-128 and chi-256 runs. A cap of 128 or more
    # sets the oversample to 16 at every stage, so K1 runs the chi-32 and
    # chi-64 stages with nc = chi + 16 columns; the chi-128 stage's center
    # moves give K2 v [32, 256, 128], whose rows do not fit in shared memory
    # (the global-scratch layout).
    for chi in (32, 64):
        m = 2 * chi
        v0 = start_block(m, chi + 16, torch.complex64, dev)
        for kind in kinds:
            th = torch.from_numpy(make_input(rng, kind, 32, m, m, chi)).to(dev)
            qk, rk = split.subspace_factor_cuda(th, v0, 2)
            qp, rp = split.subspace_factor_plain(th, v0, 2)
            torch.cuda.synchronize()
            # rankdef and padded inputs have rank chi, below nc
            worst("split", compare(qk, rk, qp, rp, th,
                                   f"split B=32 chi={chi} nc={chi + 16} iters=2 {kind}", True,
                                   surplus=kind in ("rankdef", "padded")))
    for kind in kinds:
        v = torch.from_numpy(make_input(rng, kind, 32, 256, 128, 128)).to(dev)
        qk, rk = orth.orth_r_cuda(v)
        qp, rp = orth.orth_r_plain(v)
        torch.cuda.synchronize()
        worst("orth_r", compare(qk, rk, qp, rp, v, f"orth_r B=32 chi=128 {kind}", False))

    # K1 and K2 on the launch plans the shapes above do not reach, each
    # named by its wrapper's plan: K1 with theta in global memory and two row
    # buffers in shared memory (chi 64, nc 80: one buffer needs one-pass
    # products), with one row buffer (complex128 at chi 64), and with
    # everything in global memory (chi 128: the brick route's [408, 256, 256]
    # with nc 128, and complex128); K2 with Q alone in shared memory
    # (complex128 at chi 64) and in global scratch (complex128 at chi 128).
    for B, chi, nc, dtype in ((32, 64, 80, c64), (408, 128, 128, c64), (32, 64, 64, c128),
                              (4, 128, 128, c128)):
        m = 2 * chi
        v0 = start_block(m, nc, dtype, dev)
        for kind in (kinds if B < 408 else ("full", "padded")):
            th = torch.from_numpy(make_input(rng, kind, B, m, m, chi)).to(dev, dtype)
            qk, rk = split.subspace_factor_cuda(th, v0, 2)
            qp, rp = split.subspace_factor_plain(th, v0, 2)
            torch.cuda.synchronize()
            what = (f"split B={B} chi={chi} nc={nc} iters=2 {str(dtype)[6:]} {kind} "
                    f"[{plan_text(split.split_plan(B, m, m, nc, dtype, optin))}]")
            worst("split", compare(qk, rk, qp, rp, th, what, True,
                                   surplus=nc > chi and kind in ("rankdef", "padded")))
    for B, chi in ((32, 64), (32, 128)):
        for kind in kinds:
            v = torch.from_numpy(make_input(rng, kind, B, 2 * chi, chi, chi)).to(dev, c128)
            qk, rk = orth.orth_r_cuda(v)
            qp, rp = orth.orth_r_plain(v)
            torch.cuda.synchronize()
            what = (f"orth_r B={B} chi={chi} complex128 {kind} "
                    f"[{plan_text(orth.orth_r_plan(B, 2 * chi, chi, c128, optin))}]")
            worst("orth_r", compare(qk, rk, qp, rp, v, what, False))

    # K4 on the launch plans the shapes above do not reach, each named by its
    # wrapper's plan: theta in global scratch with two row buffers in shared
    # memory (chi 64, nc 80: the oversampled chi-64 stage), and complex128 at
    # chi 16 and 32 (theta and rows in shared memory), 64 (theta in scratch,
    # one row buffer) and 128 (everything in scratch).
    for B, chi, nc, dtype in ((32, 64, 80, c64), (32, 16, 16, c128), (32, 32, 32, c128),
                              (32, 64, 64, c128), (8, 128, 128, c128)):
        v0 = start_block(2 * chi, nc, dtype, dev)
        for kind in ("full", "padded"):
            a, b, g = (t.to(dtype) for t in make_pair(rng, kind, B, chi, dev))
            what = (f"gate_split B={B} chi={chi} nc={nc} iters=2 {str(dtype)[6:]} {kind} "
                    f"[{plan_text(split.gate_split_plan(B, chi, nc, dtype, optin))}]")
            worst("gate_split", compare_gate(split, *gate_feeds(a, b, g, False), v0, 2, what,
                                             surplus=nc > chi and kind == "padded"))

    # Two launches on one input give bit-equal outputs (every sum in a fixed
    # order, no atomics), on every plan of the main paths.
    for B, chi in ((1, 64), (32, 32), (32, 64), (100, 64)):
        m = 2 * chi
        th = torch.from_numpy(make_input(rng, "graded", B, m, m, chi)).to(dev)
        v0 = start_block(m, chi, torch.complex64, dev)
        v = torch.from_numpy(make_input(rng, "rankdef", B, m, chi, chi)).to(dev)
        feeds = gate_feeds(*make_pair(rng, "graded", B, chi, dev), False)
        for name, fn in (("split", lambda: split.subspace_factor_cuda(th, v0, 2)),
                         ("orth_r", lambda: orth.orth_r_cuda(v)),
                         ("gate_split", lambda: split.gate_subspace_factor_cuda(*feeds, v0, 2))):
            first, second = fn(), fn()
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(first, second)), (
                f"{name} B={B} chi={chi}: two launches differ")
        log(f"  bit-equal: split, orth_r and gate_split, two launches each, B={B} chi={chi}")

    # K5 at the brick route's stages: chi 16 to 128 (thH in shared memory up
    # to chi 32; the rows in global scratch at chi 128), 6 pairs and the full
    # width's 408 (8 circuits x 51 pairs), both gate kinds of the swap
    # network, nc = chi, and nc = chi + 16 at chi 16.
    for chi in (16, 32, 64, 128):
        v0 = start_block(2 * chi, chi, torch.complex64, dev)
        for Bn in (6, 408):
            for kind in ("full", "padded"):
                for iters in (1, 2):
                    sw = float((iters + (kind == "padded")) % 2)
                    worst("brick_split", compare_brick(
                        split, *make_brick(rng, kind, Bn, chi, sw, dev), v0, iters,
                        f"brick_split Bn={Bn} chi={chi} iters={iters} {kind} swap_w={sw:.0f}"))
    v0 = start_block(32, 32, torch.complex64, dev)
    for kind in ("full", "padded"):
        worst("brick_split", compare_brick(split, *make_brick(rng, kind, 408, 16, 1.0, dev), v0,
                                           2, f"brick_split Bn=408 chi=16 nc=32 iters=2 {kind}"))
    # K5 in complex128 on each plan its wrapper chooses there (thH and rows in
    # shared memory at chi 16 and 32; thH in scratch with one row buffer at
    # 64; everything in scratch at 128), and two launches bit-equal on every
    # complex64 plan (chi 16 and 32; 64; 128 at the full width's 408 pairs).
    for chi in (16, 32, 64, 128):
        v0 = start_block(2 * chi, chi, c128, dev)
        for kind in ("full", "padded"):
            A, Bm, g, lam = make_brick(rng, kind, 6, chi, float(kind == "full"), dev)
            what = (f"brick_split Bn=6 chi={chi} iters=2 complex128 {kind} "
                    f"[{plan_text(split.brick_split_plan(6, chi, chi, c128, optin))}]")
            worst("brick_split", compare_brick(split, A.to(c128), Bm.to(c128), g.to(c128),
                                               lam.double(), v0, 2, what))
    for chi, Bn in ((16, 6), (32, 6), (64, 6), (128, 408)):
        v0 = start_block(2 * chi, chi, c64, dev)
        brick = make_brick(rng, "full", Bn, chi, 1.0, dev)
        first = split.brick_gate_split_cuda(*brick, v0, 2)
        second = split.brick_gate_split_cuda(*brick, v0, 2)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second)), (
            f"brick_split Bn={Bn} chi={chi}: two launches differ")
        log(f"  bit-equal: brick_split, two launches, Bn={Bn} chi={chi} "
            f"[{plan_text(split.brick_split_plan(Bn, chi, chi, c64, optin))}]")

    # Times at the main paths' largest shape: chi 64, one sim batch of 32,
    # iters 2; K1 and K2 also at the chi-32 stage, and beside the parent
    # commit's K1 and K2 where its sources were unpacked into build/parent;
    # K5 at the brick route's: chi 128, 408 pairs, iters 2. The library calls
    # are yardsticks only; no path calls them.
    B = 32
    stage = {}
    for chi in (32, 64):
        m = 2 * chi
        stage[chi] = (torch.from_numpy(make_input(rng, "full", B, m, chi, chi)).to(dev),
                      torch.from_numpy(make_input(rng, "full", B, m, m, chi)).to(dev),
                      start_block(m, chi, torch.complex64, dev))
    v, th, v0 = stage[64]
    chi = 64
    A, Bm, g = gate_feeds(*make_pair(rng, "full", B, chi, dev), False)
    panel = torch.from_numpy(make_input(rng, "full", B, 512, 32, 256)).to(dev)
    times = {}
    for name, kern, plain, library in (
        ("orth_r", lambda: orth.orth_r_cuda(v), lambda: orth.orth_r_plain(v),
         lambda: torch.linalg.qr(v, mode="reduced")),
        ("orth", lambda: orth.orth_cuda(v), lambda: orth.orth_plain(v),
         lambda: torch.linalg.qr(v, mode="reduced")),
        ("split", lambda: split.subspace_factor_cuda(th, v0, 2),
         lambda: split.subspace_factor_plain(th, v0, 2), None),
        ("gate_split", lambda: split.gate_subspace_factor_cuda(A, Bm, g, v0, 2),
         lambda: split.gate_subspace_factor_plain(A, Bm, g, v0, 2), None),
    ):
        p1 = time_ms(plain, 3)
        k1 = time_ms(kern, 20)
        lib = time_ms(library, 5) if library else None
        k2 = time_ms(kern, 20)
        p2 = time_ms(plain, 3)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2, lib)
        log(f"  time {name} B={B} chi={chi}: kernel {k1:.4f} / {k2:.4f} ms, "
            f"plain {p1:.4f} / {p2:.4f} ms, library call "
            f"{'none' if lib is None else f'{lib:.4f} ms (torch.linalg.qr)'}")
    parent = parent_kernels(dev, parent_built)
    stage_ms = {"split": {}, "orth_r": {}, "gate_split": {}}
    for chi, (vs, ths, v0s) in stage.items():
        m = 2 * chi
        feeds = gate_feeds(*make_pair(rng, "full", B, chi, dev), False)
        for name, kern, plan, old in (
            ("split", lambda: split.subspace_factor_cuda(ths, v0s, 2),
             split.split_plan(B, m, m, chi, ths.dtype, optin),
             parent and (lambda: parent.split(ths, v0s, 2))),
            ("orth_r", lambda: orth.orth_r_cuda(vs), orth.orth_r_plan(B, m, chi, vs.dtype, optin),
             parent and (lambda: parent.orth_r(vs))),
            ("gate_split", lambda: split.gate_subspace_factor_cuda(*feeds, v0s, 2),
             split.gate_split_plan(B, chi, chi, ths.dtype, optin),
             parent and (lambda: parent.gate_split(*feeds, v0s, 2))),
        ):
            if old:
                qn, qo = kern()[0], old()[0]
                diff = (qn @ qn.mH - qo @ qo.mH).abs().max().item()
                assert diff <= TOL_PROJ, f"{name} chi={chi}: parent's projector off by {diff}"
                o1, k1, k2, o2 = (time_ms(f, 20) for f in (old, kern, kern, old))
                stage_ms[name][f"chi{chi}"] = {"ms": (k1 + k2) / 2, "parent_ms": (o1 + o2) / 2}
                log(f"  time {name} B={B} chi={chi} [{plan_text(plan)}]: kernel {k1:.4f} / "
                    f"{k2:.4f} ms, parent's kernel {o1:.4f} / {o2:.4f} ms (same call, "
                    f"turns parent, kernel, kernel, parent)")
            else:
                k1 = time_ms(kern, 20)
                stage_ms[name][f"chi{chi}"] = {"ms": k1, "parent_ms": None}
                log(f"  time {name} B={B} chi={chi} [{plan_text(plan)}]: kernel {k1:.4f} ms "
                    f"(no parent sources in build/parent)")
    # K3 at every shape of its routes, B 32: the unfused route's split and
    # center-move shapes at chi 32 and 64 (m 64, 128; k chi and chi + 16) and
    # the blocked route's panels at chi 128, 256 and 1024 (m 256, 512, 2048;
    # k 32 and a last panel of 16), beside the parent's K3 and the bound.
    stage_ms["orth"] = {}
    for m, k in ((64, 32), (64, 48), (128, 64), (128, 80), (256, 32), (256, 16), (512, 32),
                 (512, 16), (2048, 32)):
        vs = torch.from_numpy(make_input(rng, "full", B, m, k, m // 2)).to(dev)
        plan = orth.orth_plan(B, m, k, vs.dtype, optin)
        kern = lambda: orth.orth_cuda(vs)
        bound_ms = bound(B * _orth_ops(m, k), 8.0 * B * 2 * m * k)[0]
        entry = {"plan": plan_text(plan), "bound_ms": bound_ms, "parent_ms": None}
        if parent:
            old = lambda: parent.orth(vs)
            qn, qo = kern(), old()
            diff = (qn @ qn.mH - qo @ qo.mH).abs().max().item()
            assert diff <= TOL_PROJ, f"orth m={m} k={k}: parent's projector off by {diff}"
            o1, k1, k2, o2 = (time_ms(f, 20) for f in (old, kern, kern, old))
            entry.update(ms=(k1 + k2) / 2, parent_ms=(o1 + o2) / 2)
            vs_parent = (f"kernel {k1:.4f} / {k2:.4f} ms, parent's kernel {o1:.4f} / {o2:.4f} ms "
                         f"(same call, turns parent, kernel, kernel, parent)")
        else:
            entry["ms"] = time_ms(kern, 20)
            vs_parent = f"kernel {entry['ms']:.4f} ms (no parent sources in build/parent)"
        stage_ms["orth"][f"m{m}_k{k}"] = entry
        log(f"  time orth B={B} m={m} k={k} [{plan_text(plan)}]: {vs_parent}, bound "
            f"{bound_ms:.4f} ms")
    brick = make_brick(rng, "full", BRICK_BN, 128, 1.0, dev)
    v0b = start_block(256, 128, torch.complex64, dev)
    kern = lambda: split.brick_gate_split_cuda(*brick, v0b, 2)
    plain = lambda: split.brick_gate_split_plain(*brick, v0b, 2)
    p1 = time_ms(plain, 2)
    if parent:
        old = lambda: parent.brick_split(*brick, v0b, 2)
        (qn, nn, *_), (qo, no, *_) = kern(), old()
        pair_o = no.mT @ qo.conj()
        diff = ((nn.mT @ qn.conj() - pair_o).abs().max() / pair_o.abs().max()).item()
        assert diff <= TOL_PROD, f"brick_split: parent's projected pair off by {diff}"
        o1, k1, k2, o2 = (time_ms(f, 5) for f in (old, kern, kern, old))
        parent_ms = (o1 + o2) / 2
        vs_parent = f", parent's kernel {o1:.4f} / {o2:.4f} ms (turns parent, kernel, kernel, parent)"
    else:
        k1, k2 = time_ms(kern, 5), time_ms(kern, 5)
        parent_ms, vs_parent = None, " (no parent sources in build/parent)"
    p2 = time_ms(plain, 2)
    times["brick_split"] = ((k1 + k2) / 2, (p1 + p2) / 2, None)
    plan = split.brick_split_plan(BRICK_BN, 128, 128, torch.complex64, optin)
    log(f"  time brick_split Bn={BRICK_BN} chi=128 nc=128 [{plan_text(plan)}]: kernel {k1:.4f} / "
        f"{k2:.4f} ms{vs_parent}, plain {p1:.4f} / {p2:.4f} ms, library call none")
    # K5's yardstick: the unfused brick update's split of the same pairs, K1
    # on theta_w^H (its theta and new_a products are torch matmuls).
    A, Bm, g, lam = brick
    th_h = (split.gate_theta(A, Bm, g) * torch.cat([lam, lam], 1)[:, :, None]).mH.contiguous()
    yard = time_ms(lambda: split.subspace_factor_cuda(th_h, v0b, 2), 5)
    yard_parent = parent and time_ms(lambda: parent.split(th_h, v0b, 2), 5)
    stage_ms["brick_split"] = {"chi128_Bn408": {
        "ms": times["brick_split"][0], "parent_ms": parent_ms, "k1_same_theta_ms": yard,
        "parent_k1_same_theta_ms": yard_parent or None}}
    log(f"  context: K1 on the same theta_w^H [{BRICK_BN},256,256], nc 128, iters 2: "
        f"{yard:.4f} ms" + (f", the parent's K1 {yard_parent:.4f} ms" if parent else ""))
    log(f"  time orth panel v [32,512,32]: kernel {time_ms(lambda: orth.orth_cuda(panel), 20):.4f}"
        f" ms, torch.linalg.qr {time_ms(lambda: torch.linalg.qr(panel), 5):.4f} ms")
    log(f"  context only (another function: the full decomposition): torch.linalg.svd of theta "
        f"[32,128,128] {time_ms(lambda: torch.linalg.svd(th), 3):.4f} ms")
    return err, times, stage_ms, parent


# K8 against its plain version: projectors within 1e-5 in complex64 (f32
# sums in another order, the routes' bar on q) and 1e-12 in complex128, the
# same exact-zero columns.
TOL_K8 = {torch.complex64: 1e-5, torch.complex128: 1e-12}
# The scanned step's panels: m = 2 chi for chi 128, 256, 512 and 1024, 32
# columns and a last panel of 16 (a split of chi + 16 columns), batch 32 (the
# smoke's sim batch); the main path's shape is the chi-256 f64 run's.
K8_SHAPES = tuple((m, p) for m in (256, 512, 1024, 2048) for p in (32, 16))
K8_MAIN = (512, 32, torch.complex128)
# Past m 2048 (chi 1024) the whole panel stays in global scratch: checked,
# not timed (no path of the smoke reaches it).
K8_MEMORY_SHAPE = (2560, 32)


def mgs2_bound(B, m, p, dtype):
    """K8's least time in ms: the larger of its operations (each column
    projected twice against its prefix, normed and scaled: ``_orth_ops``)
    over the card's peak for the type (``utils/flops.PEAKS``: f32 outside
    the tensor cores, f64 on them) and its bytes (the panel read
    once, its norms read once, q written once) over the memory rate."""
    from qml_cutensornet_tpu_torch.utils.flops import PEAKS

    cx = 16 if dtype == torch.complex128 else 8
    peak = PEAKS["h100"]["f64_flops" if dtype == torch.complex128 else "f32_flops"]
    t_ops = B * _orth_ops(m, p) / peak * 1e3
    t_bytes = B * (2 * m * p * cx + p * cx // 2) / PEAKS["h100"]["hbm_bytes_per_s"] * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def mgs2_panel_input(rng, B, m, p, dtype, kind, dev, collapsed=True):
    """A panel, its columns' squared norms and how many of its columns must
    come out zero: "full", random; "degenerate", its second half exact
    duplicates of its first, with an exact-zero column, an exact duplicate,
    one column at residual ratio^2 about 1e-6 (kept) and, with
    ``collapsed``, one at about 1e-15 (zeroed at complex64's cutoff of
    1e-10): every ratio far from the cutoff in f32 too. Under complex128's
    cutoff of 1e-24 the 1e-15 column would be kept as a direction that f64
    fixes only to about 1e-8, so it is left out there."""
    x = _crandn(rng, B, m, p)
    zeros = 0
    if kind == "degenerate":
        r = p // 2
        x[:, :, 3] = 0.0
        x[:, :, 7] = x[:, :, 1]
        fresh = _crandn(rng, B, m, 2)
        fresh *= np.linalg.norm(x[:, :, 2:3], axis=1, keepdims=True) / np.linalg.norm(
            fresh, axis=1, keepdims=True)  # the scale of column 2
        if collapsed:
            x[:, :, 5] = x[:, :, 2] + 3e-8 * fresh[:, :, 0]
        x[:, :, r:] = x[:, :, :p - r]
        x[:, :, p - 1] = x[:, :, 2] + 1e-3 * fresh[:, :, 1]
        zeros = 2 + int(collapsed) + (r - 1)
    a = torch.from_numpy(x).to(dev, dtype)
    return a, (a.real ** 2 + a.imag ** 2).sum(1), zeros


def phase_mgs2_kernel(dev, smi, parent):
    """K8, the scanned panel step (``ops/blocked_qr.mgs2_panel_cuda``):
    against its plain version at every shape of ``K8_SHAPES`` and
    ``K8_MEMORY_SHAPE`` in complex64 and complex128, each at its cutoff
    (``orth.dep_tol2``), full and degenerate panels (the same exact-zero
    columns, projectors within ``TOL_K8``), two launches bit-equal, each
    launch plan named and every plan of ``blocked_qr.MGS2_KINDS`` reached
    in both dtypes; a launch refused for too much shared memory raises and
    counts nothing; then at each shape of ``K8_SHAPES`` (full panels) its
    device time (a CUDA graph of 20 launches, ``graph_ms``; with ``parent``,
    the parent commit's K8 in turns parent, kernel, kernel, parent, its
    projector checked once against the kernel's), call time, the plain
    version's time, ``torch.linalg.qr(a, mode="reduced")``'s (the library
    call) and its bound. Returns the kernel's summary for the kernels
    line."""
    from qml_cutensornet_tpu_torch.ops import _build, blocked_qr, orth

    rng = np.random.default_rng(20261019)
    optin = _build.smem_optin(dev.index)
    err, plans = {}, set()
    for dtype in (torch.complex64, torch.complex128):
        tol2 = orth.dep_tol2(dtype)
        for m, p in K8_SHAPES + (K8_MEMORY_SHAPE,):
            plan = blocked_qr.mgs2_plan(m, p, dtype, optin)
            plans.add((str(dtype)[6:], plan.kind))
            for kind in ("full", "degenerate"):
                a, n2, zeros = mgs2_panel_input(rng, 32, m, p, dtype, kind, dev,
                                                collapsed=dtype == torch.complex64)
                qk = blocked_qr.mgs2_panel_cuda(a, n2)
                again = blocked_qr.mgs2_panel_cuda(a, n2)
                qp = blocked_qr.mgs2_panel_plain(a, n2)
                torch.cuda.synchronize()
                what = (f"K8 [32,{m},{p}] {str(dtype)[6:]} cutoff {tol2:g} {kind} (plan "
                        f"{plan.kind}, {plan.epl} elements a lane, {plan.reg_cols} columns in "
                        f"registers, {plan.smem_bytes} B dynamic shared)")
                assert torch.equal(qk, again), f"{what}: two launches differ"
                zk, zp = (qk == 0).all(1), (qp == 0).all(1)
                assert torch.equal(zk, zp), f"{what}: other exact-zero columns than the plain"
                assert int(zk.sum()) == 32 * zeros, f"{what}: {int(zk.sum())} zero columns"
                perr = (qk @ qk.mH - qp @ qp.mH).abs().max().item()
                err[str(dtype)[6:]] = max(err.get(str(dtype)[6:], 0.0), perr)
                log(f"  {what}: projector vs plain {perr:.3e} (tol {TOL_K8[dtype]}), exact-zero "
                    f"columns {int(zk.sum())} on both, two launches bit-equal")
                assert perr <= TOL_K8[dtype], f"{what}: projector off the plain's by {perr}"
    assert plans == {(d, k) for d in ("complex64", "complex128") for k in blocked_qr.MGS2_KINDS}, (
        f"K8 plans reached: {plans}")
    a, n2, _ = mgs2_panel_input(rng, 2, 512, 32, torch.complex64, "full", dev)
    before = dict(_build.LAUNCHES)
    try:
        blocked_qr.mgs2_panel_cuda(a, n2, smem_bytes=optin + 4096)
    except RuntimeError as exc:
        log(f"  K8 negative control: refused launch raised: {exc}")
    else:
        raise AssertionError("a K8 launch over the shared-memory limit did not raise")
    assert _build.LAUNCHES == before, "a refused K8 launch was counted"
    by_shape = {}
    for dtype in (torch.complex64, torch.complex128):
        for m, p in K8_SHAPES:
            a, n2, _ = mgs2_panel_input(rng, 32, m, p, dtype, "full", dev)
            kern = lambda: blocked_qr.mgs2_panel_cuda(a, n2)
            if parent:
                old = lambda: parent.mgs2(a, n2)
                qo, qk = old(), kern()
                diff = (qo @ qo.mH - qk @ qk.mH).abs().max().item()
                assert diff <= TOL_K8[dtype], f"K8 [32,{m},{p}]: parent's projector off by {diff}"
                o1 = graph_ms(old)
            d1, d2 = graph_ms(kern), graph_ms(kern)
            o2 = graph_ms(old) if parent else None
            call = time_ms(kern, 20)
            plain_ms = time_ms(lambda: blocked_qr.mgs2_panel_plain(a, n2), 2)
            lib_ms = time_ms(lambda: torch.linalg.qr(a, mode="reduced"), 3)
            bound_ms, bound_by = mgs2_bound(32, m, p, dtype)
            key = f"B32_m{m}_P{p}_{str(dtype)[6:]}"
            plan = blocked_qr.mgs2_plan(m, p, dtype, optin)
            by_shape[key] = {"ms": (d1 + d2) / 2, "call_ms": call, "plain_ms": plain_ms,
                             "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                             "plan": plan.kind, "epl": plan.epl, "reg_cols": plan.reg_cols,
                             "parent_ms": (o1 + o2) / 2 if parent else None}
            vs_parent = (f", parent's K8 {o1:.4f} / {o2:.4f} ms (turns parent, kernel, kernel, "
                         f"parent)" if parent else "")
            log(f"  time K8 [32,{m},{p}] {str(dtype)[6:]} [{plan.kind}] [{smi}]: device {d1:.4f} / "
                f"{d2:.4f} ms (a CUDA graph of 20 launches){vs_parent}, call {call:.4f} ms, plain "
                f"{plain_ms:.4f} ms, "
                f"torch.linalg.qr {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
                f"{32 * _orth_ops(m, p) / 1e9:.3f} GFLOP)")
    main = by_shape[f"B32_m{K8_MAIN[0]}_P{K8_MAIN[1]}_{str(K8_MAIN[2])[6:]}"]
    return {"max_abs_err": max(err.values()), "max_abs_err_by_dtype": err,
            **{k: main[k] for k in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
                                    "bound_by")},
            "ms_by_shape": by_shape}


# The caps buckets' K1 shapes at nf 100, chi 128, oversampling 0: (m, k, nc)
# = (2 cr, 2 cl, cm) of (64, 128, 128), (128, 64, 32), (4, 8, 16), (16, 32,
# 64), (32, 16, 8), (4, 4, 4) and (8, 4, 4); the (128, 128, 128) bucket is
# K5's.
CAPS_K1_SHAPES = ((256, 128, 128), (64, 256, 64), (32, 8, 8), (128, 32, 32), (16, 64, 16),
                  (8, 8, 4), (8, 16, 4))


def phase_pair_kernels(dev):
    """The block-2 in-panel variant (``pair``, the pair libraries) of K1 to
    K5 against the plain pair versions, complex64, on every launch plan
    their wrappers choose, full-rank, rank-deficient, zero-padded and graded
    inputs and panels of odd width, two launches bit-equal on each plan; K1
    single-column and pair at the brick caps' rectangular shapes; complex128
    unchanged by ``pair``; then the pair kernels' times beside the
    single-column ones (turns single, pair, pair, single). Returns the worst
    errors and ``{kernel: {shape: {"ms", "pair_ms"}}}``."""
    from qml_cutensornet_tpu_torch.ops import _build, orth, split
    from qml_cutensornet_tpu_torch.ops.svd import gate_feeds, start_block

    rng = np.random.default_rng(20261017)
    kinds = ("full", "rankdef", "padded", "graded")
    err = dict.fromkeys(KERNEL_NAMES, 0.0)
    optin = _build.smem_optin(dev.index)
    c64, c128 = torch.complex64, torch.complex128
    plans = {name: set() for name in KERNEL_NAMES}

    def worst(name, value):
        err[name] = max(err[name], value)

    def bit_equal(name, fn, what):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        first = first if isinstance(first, tuple) else (first,)
        second = second if isinstance(second, tuple) else (second,)
        assert all(torch.equal(a, b) for a, b in zip(first, second)), (
            f"pair {name} {what}: two launches differ")

    pair_before = dict(_build.PAIR_LAUNCHES)
    # K1 and K4 (iters 1 and 2), K2 and K3 at chi 8 to 64, B 32: theta and
    # rows in shared memory up to chi 32, one row buffer at chi 64; K2 and
    # K3 with Q (and v) in shared memory. nc 13 at chi 16: a panel of odd
    # width.
    for chi, nc in ((8, 8), (16, 16), (16, 13), (32, 32), (64, 64), (64, 80)):
        m = 2 * chi
        v0 = start_block(m, nc, c64, dev)
        for kind in (kinds if nc == chi else ("full", "graded")):
            th = torch.from_numpy(make_input(rng, kind, 32, m, m, chi)).to(dev)
            a, b, g = make_pair(rng, kind, 32, chi, dev)
            feeds = gate_feeds(a, b, g, False)
            sur = nc > chi and kind in ("rankdef", "padded")
            for iters in ((1, 2) if nc == chi else (2,)):
                what = f"B=32 chi={chi} nc={nc} iters={iters} {kind}"
                qk, rk = split.subspace_factor_cuda(th, v0, iters, True)
                qp, rp = split.subspace_factor_plain(th, v0, iters, True)
                torch.cuda.synchronize()
                worst("split", compare(qk, rk, qp, rp, th, f"pair split {what}", True, sur))
                worst("gate_split", compare_gate(split, *feeds, v0, iters,
                                                 f"pair gate_split {what}", sur, True))
            bit_equal("split", lambda: split.subspace_factor_cuda(th, v0, 2, True), what)
            bit_equal("gate_split", lambda: split.gate_subspace_factor_cuda(*feeds, v0, 2, True),
                      what)
        plans["split"].add(plan_text(split.split_plan(32, m, m, nc, c64, optin, True)))
        plans["gate_split"].add(plan_text(split.gate_split_plan(32, chi, nc, c64, optin, True)))
    for m, k in ((16, 8), (32, 16), (64, 32), (128, 64), (64, 13), (128, 45), (256, 128)):
        for kind in kinds:
            v = torch.from_numpy(make_input(rng, kind, 32, m, k, m // 2)).to(dev)
            qk, rk = orth.orth_r_cuda(v, True)
            qp, rp = orth.orth_r_plain(v, True)
            torch.cuda.synchronize()
            what = f"B=32 m={m} k={k} {kind}"
            worst("orth_r", compare(qk, rk, qp, rp, v, f"pair orth_r {what}", False))
        bit_equal("orth_r", lambda: orth.orth_r_cuda(v, True), f"m={m} k={k}")
        plans["orth_r"].add(plan_text(orth.orth_r_plan(32, m, k, c64, optin, True)))
    # K3 on every complex64 plan (rows in shared memory or global scratch,
    # each in-panel group; the whole block on the panel in memory at 2048),
    # and on odd panel widths.
    for m, k in ((128, 32), (256, 32), (256, 16), (512, 32), (512, 16), (2048, 32), (64, 48),
                 (128, 80), (1024, 16), (1024, 32), (2048, 8), (256, 128), (512, 64),
                 (128, 13), (512, 45), (2048, 21)):
        for kind in kinds:
            v = torch.from_numpy(make_input(rng, kind, 32, m, k, m // 2)).to(dev)
            worst("orth", compare_orth(orth, v, f"pair orth B=32 m={m} k={k} {kind}", True))
        bit_equal("orth", lambda: orth.orth_cuda(v, True), f"m={m} k={k}")
        plan = orth.orth_plan(32, m, k, c64, optin, True)
        plans["orth"].add((plan.rows_smem, plan.group_warps, plan.group_epl))
    assert len(plans["orth"]) == 9, plans["orth"]
    # K1 with everything in global memory (the brick route's [408, 256, 256],
    # nc 128) and K4 at chi 128.
    v0 = start_block(256, 128, c64, dev)
    for kind in ("full", "padded"):
        th = torch.from_numpy(make_input(rng, kind, 408, 256, 256, 128)).to(dev)
        qk, rk = split.subspace_factor_cuda(th, v0, 2, True)
        qp, rp = split.subspace_factor_plain(th, v0, 2, True)
        torch.cuda.synchronize()
        worst("split", compare(qk, rk, qp, rp, th, f"pair split B=408 chi=128 {kind}", True))
        a, b, g = make_pair(rng, kind, 8, 128, dev)
        feeds = gate_feeds(a, b, g, False)
        worst("gate_split", compare_gate(split, *feeds, v0, 2,
                                         f"pair gate_split B=8 chi=128 {kind}", pair=True))
    bit_equal("split", lambda: split.subspace_factor_cuda(th, v0, 2, True), "B=408 chi=128")
    bit_equal("gate_split", lambda: split.gate_subspace_factor_cuda(*feeds, v0, 2, True),
              "B=8 chi=128")
    plans["split"].add(plan_text(split.split_plan(408, 256, 256, 128, c64, optin, True)))
    plans["gate_split"].add(plan_text(split.gate_split_plan(8, 128, 128, c64, optin, True)))
    # K5 at chi 16 to 128 (6 pairs; the full width's 408 at chi 128), nc 13
    # at chi 16.
    for chi, Bn, nc in ((16, 6, 16), (16, 6, 13), (32, 6, 32), (64, 6, 64), (128, 408, 128)):
        v0 = start_block(2 * chi, nc, c64, dev)
        for kind in ("full", "padded"):
            brick = make_brick(rng, kind, Bn, chi, float(kind == "full"), dev)
            worst("brick_split", compare_brick(
                split, *brick, v0, 2, f"pair brick_split Bn={Bn} chi={chi} nc={nc} {kind}",
                pair=True))
        bit_equal("brick_split", lambda: split.brick_gate_split_cuda(*brick, v0, 2, True),
                  f"Bn={Bn} chi={chi} nc={nc}")
        plans["brick_split"].add(plan_text(split.brick_split_plan(Bn, chi, nc, c64, optin, True)))
    for name in ("split", "orth_r", "gate_split", "brick_split"):
        log(f"  pair {name} plans checked, two launches bit-equal on each: {sorted(plans[name])}")
    log(f"  pair orth plans (rows_smem, group warps, elements a lane): {plans['orth']}")

    # K1 single-column and pair at the caps buckets' rectangular shapes.
    for m, k, nc in CAPS_K1_SHAPES:
        v0 = start_block(m, nc, c64, dev)
        for kind in ("full", "padded"):
            th = torch.from_numpy(make_input(rng, kind, 16, m, k, max(1, min(m, k) // 2))).to(dev)
            for pair in (False, True):
                qk, rk = split.subspace_factor_cuda(th, v0, 2, pair)
                qp, rp = split.subspace_factor_plain(th, v0, 2, pair)
                torch.cuda.synchronize()
                worst("split", compare(qk, rk, qp, rp, th,
                                       f"{'pair' if pair else 'single'} split caps m={m} k={k} "
                                       f"nc={nc} {kind}", True, surplus=kind == "padded"))
    diff = {name: _build.PAIR_LAUNCHES[name] - pair_before[name] for name in KERNEL_NAMES}
    assert all(diff.values()), f"a pair kernel never launched: {diff}"

    # complex128: pair changes no output bit and launches no pair kernel.
    before = dict(_build.PAIR_LAUNCHES)
    v = torch.from_numpy(make_input(rng, "graded", 8, 128, 64, 64)).to(dev, c128)
    th = torch.from_numpy(make_input(rng, "graded", 8, 128, 128, 64)).to(dev, c128)
    v0 = start_block(128, 64, c128, dev)
    feeds = tuple(t.to(c128) for t in gate_feeds(*make_pair(rng, "full", 8, 64, dev), False))
    brick = make_brick(rng, "full", 6, 64, 1.0, dev)
    brick = tuple(t.to(c128) for t in brick[:3]) + (brick[3].double(),)
    for name, fn in (("split", lambda p: split.subspace_factor_cuda(th, v0, 2, p)),
                     ("orth_r", lambda p: orth.orth_r_cuda(v, p)),
                     ("orth", lambda p: orth.orth_cuda(v, p)),
                     ("gate_split", lambda p: split.gate_subspace_factor_cuda(*feeds, v0, 2, p)),
                     ("brick_split", lambda p: split.brick_gate_split_cuda(*brick, v0, 2, p))):
        a, b = fn(True), fn(False)
        torch.cuda.synchronize()
        a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
        assert all(torch.equal(x, y) for x, y in zip(a, b)), f"complex128 {name}: pair changed it"
    assert _build.PAIR_LAUNCHES == before, "a complex128 launch went to a pair library"
    log("  complex128: pair changes no output bit of K1 to K5 and launches no pair kernel")

    # Times, CUDA events, turns single, pair, pair, single: K1, K2 and K4 at
    # B 32, chi 64, iters 2; K3 at [32,128,64] and the [32,512,32] panel; K5
    # at chi 128, 408 pairs.
    v = torch.from_numpy(make_input(rng, "full", 32, 128, 64, 64)).to(dev)
    th = torch.from_numpy(make_input(rng, "full", 32, 128, 128, 64)).to(dev)
    panel = torch.from_numpy(make_input(rng, "full", 32, 512, 32, 256)).to(dev)
    v0 = start_block(128, 64, c64, dev)
    feeds = gate_feeds(*make_pair(rng, "full", 32, 64, dev), False)
    brick = make_brick(rng, "full", BRICK_BN, 128, 1.0, dev)
    v0b = start_block(256, 128, c64, dev)
    pair_ms = {}
    for name, shape, fn, reps in (
        ("split", "B32_chi64", lambda p: split.subspace_factor_cuda(th, v0, 2, p), 20),
        ("orth_r", "B32_chi64", lambda p: orth.orth_r_cuda(v, p), 20),
        ("orth", "m128_k64", lambda p: orth.orth_cuda(v, p), 20),
        ("orth", "m512_k32", lambda p: orth.orth_cuda(panel, p), 20),
        ("gate_split", "B32_chi64", lambda p: split.gate_subspace_factor_cuda(*feeds, v0, 2, p),
         20),
        ("brick_split", f"Bn{BRICK_BN}_chi128",
         lambda p: split.brick_gate_split_cuda(*brick, v0b, 2, p), 5),
    ):
        s1, p1, p2, s2 = (time_ms(lambda: fn(p), reps) for p in (False, True, True, False))
        pair_ms.setdefault(name, {})[shape] = {"ms": (s1 + s2) / 2, "pair_ms": (p1 + p2) / 2}
        log(f"  time {name} {shape}: single-column {s1:.4f} / {s2:.4f} ms, pair {p1:.4f} / "
            f"{p2:.4f} ms (turns single, pair, pair, single)")
    return err, pair_ms


def op_launches(cfg, count):
    """``add(chi, kind)``: add to ``count`` the kernel launches of one op of
    a stream at stage ``chi`` under ``cfg``: per two-site gate one K4 launch
    where the stage is gate-split eligible, else one K1 launch where the
    fused split takes the shape in a full-precision configuration, else 2 *
    iters orthonormalizations by K3 (and, at a reduced power precision in
    complex64, 2 * iters power products by K7), and none with the svd or
    eigh method (cuSOLVER); per center move one K2
    launch with the fused split up to ``orth.MAX_K`` columns, else one
    orthonormalization by K3. An orthonormalization of more columns than that
    is one K3 launch per panel of ``blocked_qr.PANEL`` on the fused split in
    complex64 and otherwise one K8 launch per panel (the scanned panel step)
    at a full class, none at a reduced one. At a reduced
    ambient class in complex64 (``cfg.matmul_precision``) every product of
    the engine is one K7 launch (``ops/lowp.matmul``): theta and the gate of
    a two-site update, the split's right factor (and the eigh route's Gram),
    the center move's product and, off K2, its ``r`` where the reference's
    is a dot (``orth.reference_r_is_dot``), a 1-qubit gate, and on the
    blocked route 4 projection products a later panel and, on the scanned
    panel step, 4 a column after a panel's first. Also returns ``split(chi,
    m, k)``, the launches of one truncating split off the gate kernels,
    keeping ``chi`` columns of a ``[m, k]`` theta (``2 chi`` square by
    default)."""
    from qml_cutensornet_tpu_torch.models.ansatz import GATE_I, GATE_RX
    from qml_cutensornet_tpu_torch.ops import blocked_qr, lowp, orth, svd

    iters = max(1, cfg.subspace_iters)
    power_passes = lowp.reduced_passes(cfg.resolved_power_precision, cfg.complex_dtype)
    ambient = bool(lowp.reduced_passes(cfg.matmul_precision, cfg.complex_dtype))

    def panels(k):
        if k <= orth.MAX_K:
            return 1
        if blocked_qr.kernel_panels_used(cfg.fused_split, cfg.complex_dtype):
            return -(-k // blocked_qr.PANEL)
        return 0

    def scanned(k):
        if (k <= orth.MAX_K or ambient
                or blocked_qr.kernel_panels_used(cfg.fused_split, cfg.complex_dtype)):
            return 0
        return -(-k // blocked_qr.PANEL)

    def blocked_products(k):
        if not ambient or k <= orth.MAX_K:
            return 0
        widths = [min(blocked_qr.PANEL, k - p0) for p0 in range(0, k, blocked_qr.PANEL)]
        out = 4 * (len(widths) - 1)
        if not blocked_qr.kernel_panels_used(cfg.fused_split, cfg.complex_dtype):
            out += sum(4 * (w - 1) for w in widths)
        return out

    def split(chi, m=None, k=None):
        if cfg.svd_method != "subspace":
            count["cgemm"] += ambient * (2 if cfg.svd_method == "eigh" else 1)
            return
        nc = chi + max(0, cfg.oversample)
        m, k = m or 2 * chi, k or 2 * chi
        if cfg.fused_split and svd._kernel_precision(cfg) and svd.fused_split_supported(m, k, nc):
            count["split"] += 1
        else:
            count["orth"] += 2 * iters * panels(nc)
            count["mgs2_panel"] += 2 * iters * scanned(nc)
            count["cgemm"] += 2 * iters * (bool(power_passes) + blocked_products(nc)) + ambient

    def add(chi, kind):
        if kind >= GATE_RX:
            count["cgemm"] += ambient
            return
        if kind == GATE_I:
            count["cgemm"] += ambient
            if cfg.fused_split and chi <= orth.MAX_K:
                count["orth_r"] += 1
            else:
                count["orth"] += panels(chi)
                count["mgs2_panel"] += scanned(chi)
                count["cgemm"] += ambient * (orth.reference_r_is_dot(2 * chi, chi)
                                             + blocked_products(chi))
        elif svd.gate_split_eligible(dataclasses.replace(cfg, chi=chi), chi):
            count["gate_split"] += 1
        else:
            count["cgemm"] += 2 * ambient  # theta and the gate
            split(chi)

    return add, split


def expected_launches(argv, n_batches, cfg=None):
    """Kernel launches the simulation of ``n_batches`` sim batches must make
    under the current environment (``cfg``: the CLI's config of ``argv``
    unless given), from the op stream's chunk plan and the
    routing rules (:func:`op_launches`). On the brick route, per chunk of the
    layer plan and per layer, one update per pair chunk: one K5 launch where
    the stage is brick-split eligible, else the split's K1 or K3 launches
    (at a reduced ambient class also theta, the gate and ``new_a`` on K7);
    with ``QMLTPU_BRICK_CAPS=1`` the pair chunks of each caps bucket
    (``ops/vidal.cap_buckets``), K5 where the bucket's ``(cl, cm, cr)`` is
    eligible, else the split of ``[2 cr, 2 cl]`` keeping ``cm``. At a
    reduced ambient class the Hadamard layer is one K7 launch a batch."""
    from qml_cutensornet_tpu_torch.cli import _pipeline as pipe
    from qml_cutensornet_tpu_torch.models import simulate
    from qml_cutensornet_tpu_torch.models.ansatz import GATE_I, GATE_RX, BrickSchedule
    from qml_cutensornet_tpu_torch.ops import lowp, svd, vidal

    params = pipe.parse_argv(list(argv))
    cfg = cfg or pipe.sim_config(params)
    chunk_len = int(os.environ.get("QMLTPU_CHUNK_LEN", "128"))
    staged = os.environ.get("QMLTPU_STAGED", "1") != "0"
    schedule = pipe.make_ansatz(params).schedule
    count = dict.fromkeys(LAUNCH_NAMES, 0)
    add, split_launches = op_launches(cfg, count)
    ambient = bool(lowp.reduced_passes(cfg.matmul_precision, cfg.complex_dtype))
    count["cgemm"] += ambient * schedule.hadamard_init
    if isinstance(schedule, BrickSchedule):
        # Per chunk of the plan (padded to its full length with inactive
        # layers, computed all the same), per layer, one update per pair chunk.
        K = schedule.pairs_per_layer
        batch = pipe.engine_kwargs()["sim_batch"]
        layers = simulate.BRICK_LAYER_CHUNK
        rep_stages, _ = simulate.brick_stage_plan(schedule, cfg, staged)
        chunks2, _ = simulate.brick_chunk_plan(schedule, rep_stages, layers, K)
        by_stage: dict = {}
        cur = chunks2[0][3]
        for (_, _, _, stage) in chunks2:
            cur = max(cur, stage)  # the simulator's bond cap only grows
            by_stage[cur] = by_stage.get(cur, 0) + 1
            buckets = (vidal.cap_buckets(schedule.num_qubits, K, cur) if cfg.brick_struct_caps
                       else [(0, K, (cur, cur, cur))])
            for k0, k1, (cl, cm, cr) in buckets:
                chunks = -(-(k1 - k0) // vidal._pair_chunk(k1 - k0, max(cl, cm, cr), batch))
                for _ in range(layers * chunks):
                    if svd.brick_split_eligible(dataclasses.replace(cfg, chi=cur), cl, cm, cr):
                        count["brick_split"] += 1
                    else:
                        split_launches(cm, 2 * cr, 2 * cl)
                        count["cgemm"] += 3 * ambient  # theta, the gate, new_a
        log(f"  brick plan per sim batch of {batch}: {len(chunks2)} chunks of {layers} layers, "
            f"{K} pairs a layer; stage chi -> chunks {by_stage}")
        return {k: n * n_batches for k, n in count.items()}
    segs, chunk_chis, final_chi = simulate.stream_chunk_plan(schedule, cfg, chunk_len, staged)
    by_stage: dict = {}
    cur = next((st[0] for st in chunk_chis if st), final_chi)
    for (_, _, gk, _, _, _, n_chunks), stages in zip(segs, chunk_chis):
        for c in range(n_chunks):
            cur = max(cur, stages[c])
            for kind in gk[c * chunk_len:(c + 1) * chunk_len]:
                if kind < GATE_RX:
                    by_stage.setdefault(cur, [0, 0])[int(kind == GATE_I)] += 1
                add(cur, int(kind))
    log(f"  op stream per sim batch, stage chi -> [two-site gates, center moves]: {by_stage}")
    return {k: n * n_batches for k, n in count.items()}


def count_launches(run, want, what):
    """Call ``run()`` with the counters set to 0 just before and read just
    after; the launches must equal ``want``, no plain version may have run on
    a CUDA tensor, and every launch is a pair library's under
    ``QMLTPU_MGS_PAIR=1`` in f32 and none otherwise. The pair launches go
    to ``PAIR_BY_RUN[what]``."""
    from qml_cutensornet_tpu_torch.ops import _build

    _build.reset_counters()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_on_cuda = dict(_build.LAUNCHES), dict(_build.PLAIN_ON_CUDA)
    pair = dict(_build.PAIR_LAUNCHES)
    log(f"{what}: launches {launches}, of them by the pair libraries {pair}, plain versions "
        f"on CUDA tensors {plain_on_cuda}, {wall:.3f} s")
    assert launches == want, f"{what}: launches {launches} != expected {want}"
    assert sum(plain_on_cuda.values()) == 0, f"{what}: a plain version ran on a CUDA tensor"
    pair_mode = (os.environ.get("QMLTPU_MGS_PAIR", "0") != "0"
                 and os.environ.get("QMLTPU_PRECISION", "f32") == "f32")
    pair_k, launches_k = ({k: d[k] for k in KERNEL_NAMES} for d in (pair, launches))
    assert pair_k == (launches_k if pair_mode else dict.fromkeys(KERNEL_NAMES, 0)), (
        f"{what}: pair launches {pair} (pair step {'on' if pair_mode else 'off'})")
    assert pair[K7[0]] == pair[K8[0]] == 0, f"{what}: a K7 or K8 launch counted as a pair's"
    PAIR_BY_RUN[what] = pair
    return out, launches


PAIR_BY_RUN: dict = {}  # what -> the pair libraries' launches of the run


def run_counted(entry, argv, n_batches, what):
    """Drive one entry point's ``main(argv)``, counting its launches
    (:func:`count_launches`) against :func:`expected_launches`."""
    return count_launches(lambda: entry.main(list(argv)), expected_launches(argv, n_batches),
                          what)


def check_train_gram(K, n, what, sym_tol=1e-6):
    assert K.shape == (n, n) and np.isfinite(K).all(), (what, K.shape)
    # Off-diagonal tiles are mirrored exactly; inside a diagonal tile K[i,j]
    # and K[j,i] come from different f32 contraction orders (at a reduced
    # tile precision, from different bf16 roundings: ``sym_tol``, None where
    # the class bounds nothing useful).
    sym_err = float(np.abs(K - K.T).max())
    assert sym_tol is None or sym_err <= sym_tol, f"{what}: K is not symmetric: {sym_err}"
    diag_err = float(np.abs(np.diag(K) - 1.0).max())
    assert diag_err <= 1e-12, f"{what}: diagonal of K off by {diag_err}"


SIM_SECONDS: dict = {}  # what -> r0_circ_sim of the run's profile
TILE_SECONDS: dict = {}  # what -> kernel_mat_time of the run's profile


def profile_line(info, smi, what):
    prof = json.loads((WORK / f"{info}.json").read_text())
    SIM_SECONDS[what] = prof["r0_circ_sim"][0]
    TILE_SECONDS[what] = prof["kernel_mat_time"][0]
    return (f"{what} [{smi}]: avg_fidelity {prof['avg_fidelity'][0]:.8f}, avg_max_chi "
            f"{prof['ave max chi x'][0]:.2f}, sim {prof['r0_circ_sim'][0]:.3f} s, tiles "
            f"{prof['kernel_mat_time'][0]:.3f} s, build_kernel_matrix "
            f"{prof['total_time'][0]:.3f} s")


def phase_default_route(smi, golden):
    from qml_cutensornet_tpu_torch.cli import main_no_test
    from qml_cutensornet_tpu_torch.utils.naming import run_info

    K, launches = run_counted(main_no_test, ARGV, 4, "default route")
    assert launches["split"] > 0 and launches["orth_r"] > 0
    check_train_gram(K, 102, "default route")
    gold_err = float(np.abs(K[:8, :8] - golden["k"]).max())
    log(profile_line(run_info("train", 32, 2, 1.0, 6, 64, 5, CSV_V1), smi, "default route")
        + f", max_abs_err vs f64 golden {gold_err:.3e} (tol {TOL_GOLDEN})")
    assert gold_err <= TOL_GOLDEN, f"8x8 block off the golden by {gold_err}"
    log(flops_line(ARGV, 102, smi, "default route"))
    return K, launches


def flops_line(argv, n_points, smi, what):
    """The run's sim and tile FLOPs by the FLOP model (``utils/flops.
    gram_flops``: ``n_points`` circuits, not the padding of the last sim
    batch; the tiles' pairs at the final chi) and their roofline against
    the card's f32 peak, from the sim and tile seconds of its profile."""
    from qml_cutensornet_tpu_torch.cli import _pipeline as pipe
    from qml_cutensornet_tpu_torch.utils import flops

    params = pipe.parse_argv(list(argv))
    g = flops.gram_flops(pipe.make_ansatz(params).schedule, pipe.sim_config(params), n_points,
                         int(os.environ.get("QMLTPU_CHUNK_LEN", "128")),
                         os.environ.get("QMLTPU_STAGED", "1") != "0")
    sim = flops.roofline(g["sim_flops"], SIM_SECONDS[what], "h100")
    tile = flops.roofline(g["tile_flops"], TILE_SECONDS[what], "h100")
    return (f"{what} FLOPs [{smi}]: sim {g['sim_flops']} ({g['sim_flops_per_circuit']} a "
            f"circuit x {n_points}) in {SIM_SECONDS[what]:.3f} s, {sim['tflops']} TFLOP/s, "
            f"peak fraction {sim['peak_fraction']}; tiles {g['tile_flops']} ({g['n_pairs']} "
            f"pairs at chi {g['final_chi']}) in {TILE_SECONDS[what]:.3f} s, {tile['tflops']} "
            f"TFLOP/s, peak fraction {tile['peak_fraction']} (h100 f32 "
            f"{flops.PEAKS['h100']['f32_flops']:.3g} FLOP/s)")


def phase_fused_gate_route(smi, golden, K_default):
    from qml_cutensornet_tpu_torch.cli import main
    from qml_cutensornet_tpu_torch.models import svm
    from qml_cutensornet_tpu_torch.utils.data import load_and_prepare
    from qml_cutensornet_tpu_torch.utils.device import environ
    from qml_cutensornet_tpu_torch.utils.naming import run_info

    with environ(QMLTPU_FUSED_GATE="1"):
        # 4 sim batches for the train Gram, 4 + 1 for the test Gram
        (K, K_test, test_rows, train_rows), launches = run_counted(
            main, ARGV, 9, "fused-gate route")
    assert launches["gate_split"] > 0 and launches["split"] == 0 and launches["orth_r"] > 0
    check_train_gram(K, 102, "fused-gate route")
    gold_err = float(np.abs(K[:8, :8] - golden["k"]).max())
    route_err = float(np.abs(K - K_default).max())
    args = (32, 2, 1.0, 6, 64, 5, CSV_V1)
    log(profile_line(run_info("train", *args), smi, "fused-gate route, train Gram")
        + f", max_abs_err vs f64 golden {gold_err:.3e} (tol {TOL_GOLDEN}), vs the default "
        f"route's K {route_err:.3e} (tol {TOL_ROUTES})")
    log(profile_line(run_info("test", *args), smi, "fused-gate route, test Gram"))
    assert gold_err <= TOL_GOLDEN, f"fused-gate 8x8 block off the golden by {gold_err}"
    assert route_err <= TOL_ROUTES, f"fused-gate K off the default route's by {route_err}"

    x_train, y_train, x_test, y_test = load_and_prepare(
        str(WORK / "datasets" / CSV_V1), 32, 64, 64, 5)
    assert K_test.shape == (len(x_test), len(x_train)) == (26, 102), K_test.shape
    assert np.isfinite(K_test).all() and K_test.min() >= 0.0 and K_test.max() <= 1.0 + 1e-6, (
        K_test.min(), K_test.max())
    t0 = time.perf_counter()
    for rows in (test_rows, train_rows):
        rows = np.asarray(rows)
        assert rows.shape == (11, 5) and np.isfinite(rows).all()
        assert list(rows[:, 0]) == svm.REGULARIZATION_SWEEP
        assert rows[:, 1:].min() >= 0.0 and rows[:, 1:].max() <= 1.0
    worst_kkt = 0.0
    for C in svm.REGULARIZATION_SWEEP:
        worst_kkt = max(worst_kkt, svm.SVC(C=C, tol=TOL_KKT).fit(K, y_train).kkt_violation_)
    assert worst_kkt <= TOL_KKT, f"an SVC fit violates its KKT conditions by {worst_kkt}"
    best = np.asarray(test_rows)[np.argmax(np.asarray(test_rows)[:, 4])]
    log(f"fused-gate route, SVC sweep: 11 + 11 rows, worst KKT violation {worst_kkt:.3e} "
        f"(tol {TOL_KKT}), best test row [C, acc, prec, rec, auc] {best.tolist()}, "
        f"11 refits {time.perf_counter() - t0:.3f} s on the host")
    return launches


def phase_unfused_route(smi):
    from qml_cutensornet_tpu_torch.cli import main_no_test
    from qml_cutensornet_tpu_torch.utils.data import preprocess_elliptic
    from qml_cutensornet_tpu_torch.utils.device import environ
    from qml_cutensornet_tpu_torch.utils.naming import run_info

    total = dict.fromkeys(LAUNCH_NAMES, 0)

    def add(launches):
        for k, n in launches.items():
            total[k] += n

    # (a) the headline shape, one sim batch, every orthonormalization by K3
    info = run_info("train", 32, 2, 1.0, 6, 20, 5, CSV_V1)
    with environ(QMLTPU_FUSED_SPLIT="0"):
        K, launches = run_counted(main_no_test, ARGV_ONE_BATCH, 1, "unfused route")
    assert launches["orth"] > 0 and launches["split"] == launches["orth_r"] == 0
    add(launches)
    check_train_gram(K, 32, "unfused route")
    log(profile_line(info, smi, "unfused route, one sim batch"))
    K_fused, _ = run_counted(main_no_test, ARGV_ONE_BATCH, 1, "default route, same points")
    GRAMS["unfused, one batch"], GRAMS["default, one batch"] = K, K_fused
    log(profile_line(info, smi, "default route, same points"))
    err = float(np.abs(K - K_fused).max())
    log(f"unfused route vs default route on the same 32 points: max_abs_err {err:.3e} "
        f"(tol {TOL_ROUTES})")
    assert err <= TOL_ROUTES, f"unfused K off the default route's by {err}"

    # (b) 16 qubits above chi 64, where K1 no longer takes the split (nc =
    # chi + 16 > 128): the unfused chain with the blocked route, K3 on
    # panels of 32. Cap 256 (stages 32, 64, 256): every split iterate (272
    # columns) and center move (256 columns) of the chi-256 stage is blocked.
    # Cap 128 (stages 32, 64, 128): the split iterates (144 columns) are
    # blocked, the center moves stay on K2. Each f32 run is held to the
    # port's own f64 run on the card at the same cap, whose blocked
    # orthonormalizations take the scanned panel step (K8, no K3 on panels);
    # each f64 run's sim seconds are printed beside those of the step run
    # from the host (HOST_LOOP_F64_SIM).
    preprocess_elliptic(dataset_dir=str(RAW_V2), out_csv=str(WORK / "datasets" / CSV_V2))
    dense_grams, K32_by_run = {}, {}
    # The tied-spectrum v2 points keep every bond far below 128 (avg_max_chi
    # 7.12 in f32, 8.91 in f64 at cap 256), so they run at cap 128.
    for chi, data, csv in (("256", "v1", CSV_V1), ("128", "tied-spectrum v2", CSV_V2),
                           ("128", "v1", CSV_V1)):
        argv = ARGV_CHI256[:-1] + [csv]
        info = run_info("train", 16, 2, 1.0, 6, 20, 5, csv)
        what = f"chi {chi}, {data} data"
        with environ(QMLTPU_CHI=chi):
            K32, launches = run_counted(main_no_test, argv, 1, f"{what}, f32")
            log(profile_line(info, smi, f"{what}, f32"))
            assert launches["orth"] > 0
            add(launches)
            with environ(QMLTPU_PRECISION="f64"):
                K64, launches = run_counted(main_no_test, argv, 1, f"{what}, f64")
                log(profile_line(info, smi, f"{what}, f64"))
            assert launches["mgs2_panel"] > 0 and launches["cgemm"] == 0
            add(launches)
        K32_by_run[what] = K32
        log(f"{what}, f64 sim [{smi}]: {SIM_SECONDS[f'{what}, f64']:.3f} s with K8; with the "
            f"scanned step from the host: {HOST_LOOP_F64_SIM[what]}")
        if csv not in dense_grams:
            dense_grams[csv] = dense_gram(str(WORK / "datasets" / csv), 16, 20, 20, 5)
        K_dense = dense_grams[csv]
        e32, e64 = float(np.abs(K32 - K_dense).max()), float(np.abs(K64 - K_dense).max())
        DENSE_VERDICT[f"{what}"] = {"f32": e32, "f64": e64}
        log(f"dense verdict, {what}: max_abs_err vs the dense statevector Gram (ops/dense, "
            f"complex128) f32 {e32:.3e}, f64 {e64:.3e} (f32 bar 1e-5)")
        diff = np.abs(K32 - K64)
        err, at = float(diff.max()), np.unravel_index(np.argmax(diff), diff.shape)
        off = K64[~np.eye(32, dtype=bool)]
        log(f"{what}: f32 vs f64 on the card max_abs_err {err:.3e} at entry "
            f"{tuple(int(i) for i in at)} (f64 value {K64[at]:.6f}); f64 off-diagonal entries "
            f"median {np.median(off):.3e}, max {off.max():.6f}; f32 asymmetry "
            f"{np.abs(K32 - K32.T).max():.3e}")
        if data == "v1":
            check_train_gram(K32, 32, f"{what}, f32")
            assert err <= TOL_F64, f"{what}: f32 Gram off its f64 Gram by {err}"
        else:
            # Near-duplicate points: entries near 1, whose rounding the unit
            # diagonal does not absorb; reported, not gated.
            log(f"tied-spectrum answer (not gated): f32-vs-f64 error {err:.3e} at nq 16, chi {chi}")

    # (c) chi 128 on v1 with the fused split off: K3 on every
    # orthonormalization up to 128 columns and the split iterates (144
    # columns) through the scanned panel step, K8 in complex64, held to the
    # fused run's Gram of (b) at the routes' bar.
    what = "chi 128, v1 data, f32, fused split off"
    with environ(QMLTPU_CHI="128", QMLTPU_FUSED_SPLIT="0"):
        K, launches = run_counted(main_no_test, ARGV_CHI256, 1, what)
        log(profile_line(run_info("train", 16, 2, 1.0, 6, 20, 5, CSV_V1), smi, what))
    assert launches["mgs2_panel"] > 0 and launches["split"] == launches["orth_r"] == 0
    add(launches)
    check_train_gram(K, 32, what)
    err = float(np.abs(K - K32_by_run["chi 128, v1 data"]).max())
    log(f"{what}: vs the fused split's f32 Gram max_abs_err {err:.3e} (tol {TOL_ROUTES})")
    assert err <= TOL_ROUTES, f"{what}: off the fused split's Gram by {err}"
    return total


# Sim seconds of phase 6's f64 runs when the scanned panel step ran from
# the host, before K8 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 5).
HOST_LOOP_F64_SIM = {
    "chi 256, v1 data": "62.252 s",
    "chi 128, tied-spectrum v2 data": "60.775 s (then at cap 256)",
    "chi 128, v1 data": "30.216 s",
}


DENSE_VERDICT: dict = {}  # run -> {"f32": err, "f64": err} against the dense Gram
GRAMS: dict = {}  # Grams that later phases hold their runs to


def dense_gram(csv, nq, n_illicit, n_licit, seed, reps=2, gamma=1.0, d=6):
    """``|<psi_i|psi_j>|^2`` of the train points of a CLI draw, each state
    built once by the port's dense statevector model (complex128, on the
    host)."""
    from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
    from qml_cutensornet_tpu_torch.ops import dense
    from qml_cutensornet_tpu_torch.utils.data import load_and_prepare

    t0 = time.perf_counter()
    x = load_and_prepare(csv, nq, n_illicit, n_licit, seed)[0]
    em = entanglement_graph(nq, d)
    v = np.stack([dense.ansatz_state(xi, reps, gamma, em) for xi in x])
    g = np.abs(v.conj() @ v.T) ** 2
    log(f"  dense Gram of {len(x)} states of {v.shape[1]} amplitudes: "
        f"{time.perf_counter() - t0:.3f} s on the host")
    return g


def phase_brick_route(smi):
    """The brick route at chi 128 with oversampling 0: 14 qubits against the
    tracked route, then the full width (nf 100) through K5 and through K1.
    Returns the brick runs' launches and the tracked comparison run's."""
    from qml_cutensornet_tpu_torch.cli import main_no_test
    from qml_cutensornet_tpu_torch.utils.device import environ
    from qml_cutensornet_tpu_torch.utils.naming import run_info

    total = dict.fromkeys(LAUNCH_NAMES, 0)

    def add(launches):
        for k, n in launches.items():
            total[k] += n

    # (a) 14 qubits, one sim batch of 32: no bond exceeds 2^7 = 128, so the
    # brick (K5, and K1 on the chi-8 stage) and tracked (K1 + K2) Grams agree
    # to rounding.
    info = run_info("train", 14, 2, 1.0, 6, 20, 5, CSV_V1)
    with environ(**BRICK_KNOBS):
        with environ(QMLTPU_ROUTING="brick", QMLTPU_FUSED_GATE="1"):
            K_brick, launches = run_counted(main_no_test, ARGV_BRICK14, 1,
                                            "brick route, 14 qubits, K5")
        log(profile_line(info, smi, "brick route, 14 qubits, chi 128, K5"))
        assert launches["brick_split"] > 0 and launches["split"] > 0, launches
        assert launches["orth_r"] == launches["orth"] == launches["gate_split"] == 0, launches
        add(launches)
        K_tracked, tracked = run_counted(main_no_test, ARGV_BRICK14, 1,
                                         "tracked default route, 14 qubits")
        log(profile_line(info, smi, "tracked default route, 14 qubits, chi 128"))
    GRAMS["brick 14 qubits"], GRAMS["tracked 14 qubits"] = K_brick, K_tracked
    check_train_gram(K_brick, 32, "brick route, 14 qubits")
    check_train_gram(K_tracked, 32, "tracked route, 14 qubits")
    err = float(np.abs(K_brick - K_tracked).max())
    log(f"brick route (K5) vs tracked route on 14 qubits, chi 128: max_abs_err {err:.3e} "
        f"(tol {TOL_ROUTES})")
    assert err <= TOL_ROUTES, f"14-qubit brick K off the tracked route's by {err}"

    # (b), (c) the full width, nf 100, one sim batch of 8 train points:
    # every pair update from chi 16 on through K5, then through K1.
    info = run_info("train", 100, 2, 1.0, 6, 5, 5, CSV_V1)
    grams = {}
    for gate, kern in (("1", "K5"), ("0", "K1")):
        what = f"brick route, nf 100, chi 128, {kern}"
        with environ(**BRICK_KNOBS, QMLTPU_ROUTING="brick", QMLTPU_FUSED_GATE=gate,
                     QMLTPU_SIM_BATCH="8"):
            K, launches = run_counted(main_no_test, ARGV_BRICK100, 1, what)
        log(profile_line(info, smi, what))
        check_train_gram(K, 8, what)
        assert launches["split"] > 0 and launches["orth_r"] == launches["orth"] == 0, launches
        assert (launches["brick_split"] > 0) == (gate == "1"), launches
        add(launches)
        grams[kern] = GRAMS[f"brick nf 100 {kern}"] = K
    err = float(np.abs(grams["K5"] - grams["K1"]).max())
    off = np.abs(grams["K5"][~np.eye(8, dtype=bool)])
    log(f"brick route at nf 100, chi 128, K5 vs K1: max_abs_err {err:.3e} "
        f"(tol {TOL_BRICK_ROUTES}); off-diagonal entries of the K5 Gram: max {off.max():.3e}")
    assert err <= TOL_BRICK_ROUTES, f"nf-100 brick K through K5 off K1's by {err}"
    # (e) the same through K5 in f64: a yardstick for the f32 runs' fidelity
    # (their kept fractions are f32 ratios, each clamped at 1).
    what = "brick route, nf 100, chi 128, K5, f64"
    with environ(**BRICK_KNOBS, QMLTPU_ROUTING="brick", QMLTPU_FUSED_GATE="1",
                 QMLTPU_SIM_BATCH="8", QMLTPU_PRECISION="f64"):
        K, launches = run_counted(main_no_test, ARGV_BRICK100, 1, what)
    log(profile_line(info, smi, what))
    check_train_gram(K, 8, what)
    assert launches["brick_split"] > 0, launches
    add(launches)
    return total, tracked


def phase_pair_routes(smi, golden, K_default):
    """(k) ``QMLTPU_MGS_PAIR=1``: ``cli.main_no_test`` at the headline shape
    (K1 and K2 from the pair libraries) against the golden and the default
    route's Gram; then one sim batch each of the fused-gate route (K4), the
    unfused route (K3) and the nf-100 brick route through K5, each held to
    its single-column run on the same points at that route's tolerance.
    Returns ``{path: launches}``, every launch a pair library's."""
    from qml_cutensornet_tpu_torch.cli import main_no_test
    from qml_cutensornet_tpu_torch.utils.device import environ
    from qml_cutensornet_tpu_torch.utils.naming import run_info

    paths = {}
    with environ(QMLTPU_MGS_PAIR="1"):
        K, paths["mgs_pair_default"] = run_counted(main_no_test, ARGV, 4, "pair, default route")
    check_train_gram(K, 102, "pair, default route")
    gold_err = float(np.abs(K[:8, :8] - golden["k"]).max())
    route_err = float(np.abs(K - K_default).max())
    what = "pair, default route"
    log(profile_line(run_info("train", 32, 2, 1.0, 6, 64, 5, CSV_V1), smi, what)
        + f", max_abs_err vs f64 golden {gold_err:.3e} (tol {TOL_GOLDEN}), vs the default "
        f"route's K {route_err:.3e} (tol {TOL_ROUTES}); sim {SIM_SECONDS[what]:.3f} s against "
        f"the single-column default route's {SIM_SECONDS['default route']:.3f} s")
    assert gold_err <= TOL_GOLDEN, f"pair 8x8 block off the golden by {gold_err}"
    assert route_err <= TOL_ROUTES, f"pair K off the default route's by {route_err}"

    one = run_info("train", 32, 2, 1.0, 6, 20, 5, CSV_V1)
    nf100 = run_info("train", 100, 2, 1.0, 6, 5, 5, CSV_V1)
    for path, knobs, argv, info, single, tol, single_what in (
        ("mgs_pair_fused_gate", {"QMLTPU_FUSED_GATE": "1"}, ARGV_ONE_BATCH, one, None,
         TOL_ROUTES, "fused-gate route, one batch"),
        ("mgs_pair_unfused", {"QMLTPU_FUSED_SPLIT": "0"}, ARGV_ONE_BATCH, one,
         "unfused, one batch", TOL_ROUTES, "unfused route, one sim batch"),
        ("mgs_pair_brick_nf100", dict(**BRICK_KNOBS, QMLTPU_ROUTING="brick",
                                      QMLTPU_FUSED_GATE="1", QMLTPU_SIM_BATCH="8"),
         ARGV_BRICK100, nf100, "brick nf 100 K5", TOL_BRICK_ROUTES,
         "brick route, nf 100, chi 128, K5"),
    ):
        with environ(**knobs):
            if single is None:
                K_single, _ = run_counted(main_no_test, argv, 1, single_what)
                log(profile_line(info, smi, single_what))
            else:
                K_single = GRAMS[single]
            with environ(QMLTPU_MGS_PAIR="1"):
                what = f"pair, {single_what}"
                K, paths[path] = run_counted(main_no_test, argv, 1, what)
        log(profile_line(info, smi, what))
        err = float(np.abs(K - K_single).max())
        log(f"{what}: max_abs_err vs the single-column run {err:.3e} (tol {tol}); sim "
            f"{SIM_SECONDS[what]:.3f} s against {SIM_SECONDS[single_what]:.3f} s")
        assert err <= tol, f"{what}: K off the single-column run's by {err}"
    for path, name in (("mgs_pair_default", "split"), ("mgs_pair_default", "orth_r"),
                       ("mgs_pair_fused_gate", "gate_split"), ("mgs_pair_unfused", "orth"),
                       ("mgs_pair_brick_nf100", "brick_split")):
        assert paths[path][name] > 0, (path, name, paths[path])
    return paths


def phase_caps_routes(smi):
    """(l) ``QMLTPU_BRICK_CAPS=1`` on the brick route at chi 128,
    oversampling 0, with the fused gate: 14 qubits against the tracked route
    and the uncapped brick run; then nf 100, one sim batch of 8, through K5
    (the square buckets) and K1 (the rectangles and small squares), against
    the uncapped run. Returns ``{path: launches}``."""
    from qml_cutensornet_tpu_torch.cli import main_no_test
    from qml_cutensornet_tpu_torch.utils.device import environ
    from qml_cutensornet_tpu_torch.utils.naming import run_info

    paths = {}
    knobs = dict(**BRICK_KNOBS, QMLTPU_ROUTING="brick", QMLTPU_FUSED_GATE="1",
                 QMLTPU_BRICK_CAPS="1")
    what = "caps, brick route, 14 qubits"
    with environ(**knobs):
        K, paths["brick_caps_14q"] = run_counted(main_no_test, ARGV_BRICK14, 1, what)
    log(profile_line(run_info("train", 14, 2, 1.0, 6, 20, 5, CSV_V1), smi, what))
    check_train_gram(K, 32, what)
    e_tracked = float(np.abs(K - GRAMS["tracked 14 qubits"]).max())
    e_uncapped = float(np.abs(K - GRAMS["brick 14 qubits"]).max())
    log(f"{what}: max_abs_err vs the tracked route {e_tracked:.3e} (tol {TOL_ROUTES}), vs the "
        f"uncapped brick run {e_uncapped:.3e} (tol {TOL_ROUTES}); sim {SIM_SECONDS[what]:.3f} s "
        f"against uncapped {SIM_SECONDS['brick route, 14 qubits, chi 128, K5']:.3f} s")
    assert e_tracked <= TOL_ROUTES and e_uncapped <= TOL_ROUTES, (e_tracked, e_uncapped)

    what = "caps, brick route, nf 100, chi 128"
    with environ(**knobs, QMLTPU_SIM_BATCH="8"):
        K, paths["brick_caps_nf100"] = run_counted(main_no_test, ARGV_BRICK100, 1, what)
    log(profile_line(run_info("train", 100, 2, 1.0, 6, 5, 5, CSV_V1), smi, what))
    check_train_gram(K, 8, what)
    err = float(np.abs(K - GRAMS["brick nf 100 K5"]).max())
    uncapped = "brick route, nf 100, chi 128, K5"
    log(f"{what}: launches by kernel {paths['brick_caps_nf100']}; max_abs_err vs the uncapped "
        f"run {err:.3e} (tol {TOL_BRICK_ROUTES}); sim {SIM_SECONDS[what]:.3f} s against "
        f"uncapped {SIM_SECONDS[uncapped]:.3f} s, tiles {TILE_SECONDS[what]:.3f} s against "
        f"{TILE_SECONDS[uncapped]:.3f} s")
    assert paths["brick_caps_nf100"]["brick_split"] > 0 and paths["brick_caps_nf100"]["split"] > 0
    assert err <= TOL_BRICK_ROUTES, f"{what}: K off the uncapped run's by {err}"
    return paths


def _add_all(total, launches):
    for k, n in launches.items():
        total[k] += n


def phase_svd_methods(smi, golden, K_default, x_train):
    """QMLTPU_SVD=svd and =eigh, one sim batch: the first SVD_POINTS train
    points through ``cli._pipeline.build`` (the train Gram of
    ``cli.main_no_test``): cuSOLVER factors every two-site update, K2
    carries every center move, K1 never runs. eigh at the headline shape,
    held to the golden and the default route's Gram; svd on one rep of the
    headline circuit (``ARGV_SVD``), held to the default route's Gram of the
    same points and rep, run here. If eigh in f32 misses the golden bar (it
    squares the condition number), eigh runs again in f64 for the bar."""
    from qml_cutensornet_tpu_torch.cli import _pipeline as pipe
    from qml_cutensornet_tpu_torch.utils.device import environ

    total = dict.fromkeys(LAUNCH_NAMES, 0)
    n = SVD_POINTS
    params_svd = pipe.parse_argv(list(ARGV_SVD))
    ansatz_svd = pipe.make_ansatz(params_svd)
    K_default_r1, _ = count_launches(
        lambda: pipe.build(params_svd, ansatz_svd, X=x_train[:n], engine=pipe.engine_kwargs(),
                           info_file="svd_default_r1"),
        expected_launches(ARGV_SVD, 1), f"default route, r 1, {n} points")
    refs = {"svd": (ARGV_SVD, K_default_r1, False),
            "eigh": (ARGV, K_default[:n, :n], True)}
    runs = [("svd", "f32"), ("eigh", "f32")]
    for method, precision in runs:
        argv, K_route, with_golden = refs[method]
        params = pipe.parse_argv(list(argv))
        ansatz = pipe.make_ansatz(params)
        what = f"QMLTPU_SVD={method}, {precision}, {n} points, r {params.reps}"
        info = f"svd_method_{method}_{precision}"
        with environ(QMLTPU_SVD=method, QMLTPU_PRECISION=precision):
            K, launches = count_launches(
                lambda: pipe.build(params, ansatz, X=x_train[:n], engine=pipe.engine_kwargs(),
                                   info_file=info),
                expected_launches(argv, -(-n // 32)), what)
        assert launches["split"] == 0 and launches["orth_r"] > 0, launches
        _add_all(total, launches)
        check_train_gram(K, n, what)
        gold_err = float(np.abs(K[:8, :8] - golden["k"]).max()) if with_golden else 0.0
        route_err = float(np.abs(K - K_route).max())
        log(profile_line(info, smi, what) + (f", max_abs_err vs f64 golden {gold_err:.3e} "
                                             f"(tol {TOL_GOLDEN})" if with_golden else "")
            + f", vs the default route's K {route_err:.3e} (tol {TOL_ROUTES})")
        if (method, precision) == ("eigh", "f32") and (gold_err > TOL_GOLDEN
                                                       or route_err > TOL_ROUTES):
            # eigh squares the condition number: in f32 its kept subspace is
            # set by rounding near the cut. Reported; f64 eigh takes the bars.
            log(f"{what}: golden error {gold_err:.3e}, route error {route_err:.3e} above "
                f"the bars (reported, not gated): eigh runs in f64 for the bars")
            runs.append(("eigh", "f64"))
            continue
        assert gold_err <= TOL_GOLDEN, f"{what}: 8x8 block off the golden by {gold_err}"
        assert route_err <= TOL_ROUTES, f"{what}: K off the default route's by {route_err}"
    return total


def phase_reference_routing(smi, golden, K_default, x_train):
    """QMLTPU_ROUTING=reference through ``cli.main_no_test`` at the headline
    shape (K1 + K2 on the reference stream), then the gate-list engine on
    ``circuit_for_data`` of two points against the route's own states."""
    from qml_cutensornet_tpu_torch.cli import _pipeline as pipe
    from qml_cutensornet_tpu_torch.cli import main_no_test
    from qml_cutensornet_tpu_torch.models.simulate import (
        lower_gate_list, make_chunked_simulator, simulate_gate_list)
    from qml_cutensornet_tpu_torch.ops import mps as mps_ops
    from qml_cutensornet_tpu_torch.utils.device import environ
    from qml_cutensornet_tpu_torch.utils.naming import run_info

    total = dict.fromkeys(LAUNCH_NAMES, 0)
    info = run_info("train", 32, 2, 1.0, 6, 64, 5, CSV_V1)
    with environ(QMLTPU_ROUTING="reference"):
        K, launches = run_counted(main_no_test, ARGV, 4, "reference routing")
        params = pipe.parse_argv(list(ARGV))
        cfg = pipe.sim_config(params)
        ansatz = pipe.make_ansatz(params)
    _add_all(total, launches)
    log(profile_line(info, smi, "reference routing"))
    check_train_gram(K, 102, "reference routing")
    gold_err = float(np.abs(K[:8, :8] - golden["k"]).max())
    route_err = float(np.abs(K - K_default).max())
    s = ansatz.schedule
    log(f"reference routing: {s.num_two_site_ops} two-site ops ({s.num_gate_ops} gates) against "
        f"tracked 1092 (622); sim {SIM_SECONDS['reference routing']:.3f} s against tracked "
        f"{SIM_SECONDS['default route']:.3f} s for 4 sim batches; max_abs_err vs f64 golden "
        f"{gold_err:.3e} (tol {TOL_GOLDEN}), vs the tracked route's K {route_err:.3e} "
        f"(tol {TOL_ROUTES})")
    assert (s.num_two_site_ops, s.num_gate_ops) == (2803, 1982)
    assert gold_err <= TOL_GOLDEN, f"reference routing: 8x8 off the golden by {gold_err}"
    assert route_err <= TOL_ROUTES, f"reference routing: K off the tracked route's by {route_err}"

    # The gate-list engine: each circuit op by op at chi 64 (no staging).
    dev = torch.device("cuda", 0)
    with environ(QMLTPU_ROUTING="reference"):
        states, launches = count_launches(
            lambda: make_chunked_simulator(s, cfg, dev)(x_train[:2]),
            expected_launches(ARGV, 1), "reference routing, 2 points")
    _add_all(total, launches)
    for i in range(2):
        gates = ansatz.circuit_for_data(x_train[i])
        gkinds = lower_gate_list(gates, 32)[1]
        want = dict.fromkeys(LAUNCH_NAMES, 0)
        add, _ = op_launches(cfg, want)
        for kind in gkinds:
            add(cfg.chi, int(kind))
        what = f"simulate_gate_list, point {i} ({len(gates)} gates, {len(gkinds)} ops)"
        st, launches = count_launches(lambda: simulate_gate_list(gates, 32, cfg), want, what)
        _add_all(total, launches)
        route = mps_ops.MPS(states.tensors[i:i + 1], states.fidelity[i:i + 1],
                            states.bond_dims[i:i + 1])
        ov = float(mps_ops.vdot(st, route).abs()[0] ** 2
                   / (mps_ops.norm_sq(st)[0] * mps_ops.norm_sq(route)[0]))
        log(f"{what}: |<gate list|route>|^2 normalized {ov:.9f}, 1 - it {1.0 - ov:.3e} "
            f"(tol {TOL_ROUTES}); fidelity {float(st.fidelity[0]):.8f} against the route's "
            f"{float(route.fidelity[0]):.8f}, max bond {int(mps_ops.max_bond(st)[0])}")
        assert abs(1.0 - ov) <= TOL_ROUTES, f"{what}: overlap with the route's state {ov}"
    return total


def phase_checkpoint(smi, K_default):
    """``QMLTPU_CHECKPOINT=1`` (tile 32) through ``cli.main_no_test`` at the
    headline shape: the full run, then a partial checkpoint holding its first
    tile and a resumed run. ``QMLTPU_NORMALIZE=0`` in both, so that the
    partial checkpoint can hold the first tile's raw overlaps as the build
    saves them; the raw Grams normalized by their diagonals are then held to
    the default route's."""
    from qml_cutensornet_tpu_torch.cli import main_no_test
    from qml_cutensornet_tpu_torch.utils.device import environ
    from qml_cutensornet_tpu_torch.utils.naming import run_info

    total = dict.fromkeys(LAUNCH_NAMES, 0)
    info = run_info("train", 32, 2, 1.0, 6, 64, 5, CSV_V1)
    ckpt = WORK / "tmp" / f"checkpoint_{info}.npy"
    with environ(QMLTPU_CHECKPOINT="1", QMLTPU_NORMALIZE="0", QMLTPU_TILE="32"):
        K_raw, launches = run_counted(main_no_test, ARGV, 4, "checkpointed run")
        _add_all(total, launches)
        log(profile_line(info, smi, "checkpointed run"))
        assert not ckpt.exists(), "the checkpoint was not removed at the end"
        partial = np.zeros((128, 128))
        partial[:32, :32] = K_raw[:32, :32]
        np.save(ckpt, partial)
        K_res, launches = run_counted(main_no_test, ARGV, 4, "resumed run")
        _add_all(total, launches)
        log(profile_line(info, smi, "resumed run"))
        assert not ckpt.exists(), "the checkpoint was not removed after the resumed run"

    def normalized(k):
        dg = np.sqrt(np.diag(k))
        return k / np.outer(dg, dg)

    diff = float(np.abs(K_res - K_raw).max())
    err = float(np.abs(normalized(K_res) - K_default).max())
    log(f"checkpoint: resumed Gram vs the full run's: bit-equal {np.array_equal(K_res, K_raw)}, "
        f"max_abs_err {diff:.3e} (tol 1e-7); normalized vs the default route's K {err:.3e} "
        f"(tol 1e-7); tiles {TILE_SECONDS['checkpointed run']:.3f} s with checkpoints against "
        f"{TILE_SECONDS['default route']:.3f} s without, resumed "
        f"{TILE_SECONDS['resumed run']:.3f} s")
    assert diff <= 1e-7, f"resumed Gram off the full run's by {diff}"
    assert err <= 1e-7, f"checkpointed Gram off the default route's by {err}"
    return total


TOL_RING_SINGLE = 2e-6  # ring vs single-device Gram, f32 (the reference's dry-run bar)
TOL_RING_FUSED = 1e-7  # QMLTPU_RING=fused vs the stepwise ring


def phase_mesh(smi, golden, K_default):
    """The multi-device Gram build (``parallel/``) through ``mesh.launch``
    with NCCL, one process a card, at every world size from 1 to min(4,
    cards), in one launch a world size: (a) the headline train Gram
    (``cli._pipeline.build``, the train-Gram call of ``cli.main_no_test``) on
    the ring, stepwise and ``QMLTPU_RING=fused``, held to the golden (1e-6),
    to the single-device default route's Gram of this run (2e-6) and to each
    other (1e-7), its launches those of the rank's sim dispatches, and the
    same Gram on the rank's card alone in the rank's process (its times
    beside the ring's); (b) a ring snapshot after iteration 0
    (``dryrun.ring_snapshot``), then ``cli.main_no_test`` with
    ``QMLTPU_CHECKPOINT=1``, which must resume from it, bit-equal to (a), and
    remove it; (c) ``cli.main`` on 20 + 20 points, train and test Grams held
    to the same run on one device (2e-6), and its SVC sweep; (d) the dry run
    (``parallel/dryrun``). Returns the ring's launches of each world size
    (counters set to 0 before each call): those of (a), (b) and (c), not
    those of the single-device builds held against them or of the dry
    run."""
    import contextlib
    import io

    from qml_cutensornet_tpu_torch.cli import _pipeline as pipe
    from qml_cutensornet_tpu_torch.cli import main, main_no_test
    from qml_cutensornet_tpu_torch.models import svm
    from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix
    from qml_cutensornet_tpu_torch.parallel import dryrun, mesh
    from qml_cutensornet_tpu_torch.parallel import gram as pgram

    cards = torch.cuda.device_count()
    sizes = list(range(1, min(4, cards) + 1))
    log(f"mesh: {cards} card(s) seen; world sizes to run: {sizes}")
    params = pipe.parse_argv(list(ARGV))
    train_info = pipe.info_names(params)[0]
    test_info_one = pipe.info_names(pipe.parse_argv(list(ARGV_ONE_BATCH)))[1]
    ckpt = WORK / "tmp" / f"checkpoint_ring_{train_info}.npz"
    x_train = pipe.prepare(params)[0]
    ansatz, cfg = pipe.make_ansatz(params), pipe.sim_config(params, x_train)
    with contextlib.redirect_stdout(io.StringIO()):
        K1_train, K1_test, _, _ = main.main(list(ARGV_ONE_BATCH))  # one device
    torch.cuda.empty_cache()
    by_path = {}
    for ws in sizes:
        calls = [
            (pipe.build, (params, ansatz),
             dict(X=x_train, engine=dryrun.ENGINE, info_file=f"mesh{ws}_stepwise"), {}),
            (pipe.build, (params, ansatz),
             dict(X=x_train, engine=dryrun.ENGINE, info_file=f"mesh{ws}_fused"),
             {"QMLTPU_RING": "fused"}),
            # the same Gram on this rank's card alone, in the same process
            (build_kernel_matrix, (ansatz, x_train),
             dict(cfg=cfg, info_file=f"mesh{ws}_single", device="cuda"), {}),
            (dryrun.ring_snapshot, (ansatz, x_train, cfg),
             dict(mesh=dryrun.MESH, info_file=train_info, checkpoint_dir="tmp"), {}),
            (main_no_test.main, (list(ARGV),), {}, {"QMLTPU_CHECKPOINT": "1"}),
            (main.main, (list(ARGV_ONE_BATCH),), {}, {}),
            (dryrun.dryrun_rank, ("cuda",), {}, {}),
        ]
        t0 = time.perf_counter()
        recs = mesh.launch(dryrun.run_calls, ws, "cuda", "cuda", calls, timeout=900)
        wall = time.perf_counter() - t0
        stepwise, fused, single, snap, resumed, cli_main, dry = recs
        what = f"mesh, world size {ws}"

        block, _ = pgram.ring_rows(len(x_train), None, ws, 32)
        n_disp = -(-len(x_train) // block)  # sim dispatches of each rank
        want = expected_launches(ARGV, n_disp)
        for name, rec in (("stepwise", stepwise), ("fused", fused), ("single", single),
                          ("resumed", resumed)):
            assert rec["launches"] == want, (
                f"{what}, {name}: launches {rec['launches']} != expected {want}")
        K = stepwise["out"]
        check_train_gram(K, 102, f"{what}, stepwise")
        gold_err = float(np.abs(K[:8, :8] - golden["k"]).max())
        single_err = float(np.abs(K - K_default).max())
        fused_err = float(np.abs(fused["out"] - K).max())
        prof = {m: json.loads((WORK / f"mesh{ws}_{m}.json").read_text())
                for m in ("stepwise", "fused", "single")}
        single_err = max(single_err, float(np.abs(single["out"] - K_default).max()))
        assert prof["stepwise"]["n_procs"] == [ws, "devices"], prof["stepwise"]["n_procs"]
        pad = -(-len(x_train) // block) * block
        iter_s = prof["stepwise"]["avg_product"][0] * (pad // ws) ** 2
        log(f"{what} [{smi}]: launches {stepwise['launches']} a rank ({n_disp} dispatches of "
            f"{block // ws} rows); stepwise sim {prof['stepwise']['r0_circ_sim'][0]:.3f} s, ring "
            f"{prof['stepwise']['kernel_mat_time'][0]:.3f} s ({ws // 2 + 1} iterations, "
            f"{iter_s:.4f} s each), build {prof['stepwise']['total_time'][0]:.3f} s; fused sim "
            f"{prof['fused']['r0_circ_sim'][0]:.3f} s, ring "
            f"{prof['fused']['kernel_mat_time'][0]:.3f} s, build "
            f"{prof['fused']['total_time'][0]:.3f} s; peak memory "
            f"{stepwise['peak_bytes'] / 2**30:.3f} GiB (stepwise), "
            f"{fused['peak_bytes'] / 2**30:.3f} GiB (fused); single device in the same process "
            f"sim {prof['single']['r0_circ_sim'][0]:.3f} s, tiles "
            f"{prof['single']['kernel_mat_time'][0]:.3f} s, peak "
            f"{single['peak_bytes'] / 2**30:.3f} GiB; single device in this process (phase 4) "
            f"sim {SIM_SECONDS['default route']:.3f} s, tiles "
            f"{TILE_SECONDS['default route']:.3f} s")
        log(f"{what}: max_abs_err vs f64 golden {gold_err:.3e} (tol {TOL_GOLDEN}), vs the "
            f"single-device Gram {single_err:.3e} (tol {TOL_RING_SINGLE}), fused vs stepwise "
            f"{fused_err:.3e} (tol {TOL_RING_FUSED}); avg_fidelity "
            f"{prof['stepwise']['avg_fidelity'][0]:.8f}, avg_max_chi "
            f"{prof['stepwise']['ave max chi x'][0]:.2f}")
        assert gold_err <= TOL_GOLDEN, f"{what}: 8x8 block off the golden by {gold_err}"
        assert single_err <= TOL_RING_SINGLE, f"{what}: off the single-device Gram by {single_err}"
        assert fused_err <= TOL_RING_FUSED, f"{what}: fused off stepwise by {fused_err}"
        agg = {prof["fused"][k][0] for k in ("avg_product", "median_product", "q1_product",
                                             "q3_product")}
        assert len(agg) == 1, f"{what}: fused reports per-iteration product stats {agg}"

        resumed_line = [ln for ln in resumed["stdout"].splitlines() if "ring resumed" in ln]
        bit_equal = bool(np.array_equal(resumed["out"], K))
        log(f"{what}, checkpoint: snapshot {snap['out'].name} after iteration 0; "
            f"{resumed_line}; resumed Gram bit-equal to the stepwise one: {bit_equal}, "
            f"max_abs_err {float(np.abs(resumed['out'] - K).max()):.3e}; "
            f"main_no_test {resumed['seconds']:.3f} s")
        assert resumed_line == [f"[mesh:{ws}] ring resumed at iteration 1"], resumed_line
        assert bit_equal, f"{what}: the resumed ring differs from the full one"
        assert not ckpt.exists(), f"{what}: the ring snapshot was not removed"

        K_tr, K_te, test_rows, train_rows = cli_main["out"]
        e_tr = float(np.abs(K_tr - K1_train).max())
        e_te = float(np.abs(K_te - K1_test).max())
        prof_te = json.loads((WORK / f"{test_info_one}.json").read_text())
        assert prof_te["n_procs"] == [ws, "devices"] and K_te.shape == (8, 32), K_te.shape
        assert np.isfinite(K_te).all() and K_te.min() >= 0.0 and K_te.max() <= 1.0 + 1e-6
        for rows in (test_rows, train_rows):
            rows = np.asarray(rows)
            assert rows.shape == (11, 5) and list(rows[:, 0]) == svm.REGULARIZATION_SWEEP
        log(f"{what}, cli.main on 20 + 20 points: train Gram vs one device {e_tr:.3e}, test "
            f"Gram {e_te:.3e} (tol {TOL_RING_SINGLE}); launches {cli_main['launches']}; "
            f"{cli_main['seconds']:.3f} s")
        assert max(e_tr, e_te) <= TOL_RING_SINGLE, f"{what}: cli.main off one device"
        log(f"{what}, dry run: {json.dumps(dry['out'])}, {dry['seconds']:.3f} s; "
            f"launch wall {wall:.3f} s")
        # The ring's launches only: not the single-device builds held
        # against it, nor the dry run (ring, single device and site-sharded
        # runs in one call).
        total = dict.fromkeys(LAUNCH_NAMES, 0)
        for rec in (stepwise, fused, snap, resumed, cli_main):
            _add_all(total, rec["launches"])
        by_path[f"mesh_ws{ws}"] = total
    log(f"mesh phase: world sizes run {sizes} on {cards} card(s)")
    return by_path


TOL_SITE_GRAM = 1e-6  # site-sharded vs whole-chain brick Gram of the same argv
TOL_SITE_TENSORS = 2e-6  # gathered MPS vs the whole chain (the reference's bars)
TOL_SITE_FID = 1e-6  # relative fidelity, the same
TOL_RELAY = 5e-6  # sharded_gram vs the site-sharded CLI Gram (the reference's bar)
TOL_RELAY_SYM = 2e-6  # symmetric relay vs all tiles
RELAY_TILE = 4  # relay tile of (c): 8 states, 2 x 2 tiles, one mirrored


def _slug(text: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in text)


def phase_site_sharded(smi):
    """The site-sharded brick engine (``parallel/sharded_mps``,
    ``QMLTPU_SHARD_MPS=all``) through ``mesh.launch`` with NCCL, one process
    a card, at every world size from 1 to min(4, cards), one launch a world
    size: (a) nf 100, chi 128, 8 circuits through ``cli.main_no_test``, with
    K5 (``QMLTPU_FUSED_GATE=1``) and with K1, each Gram held to phase 7's
    whole-chain Gram of the same argv (1e-6), and the gathered MPS to the
    whole-chain simulator in the rank's process (bond dims equal, fidelity
    within rtol 1e-6, tensors within 2e-6); (b) the same at 14 qubits (K5),
    its Gram informative; (c) ``sharded_gram`` on (a)'s points against
    (a)'s Gram (5e-6), and the relay's symmetric tiles against all tiles
    (off-diagonal blocks transposed exactly, 2e-6); (d) the dry run's
    site-sharded part. Each CLI run's launches equal the brick plan's, K5
    and K1 (K1 alone on the K1 route), no K2, K3 or K4. Returns the
    site-sharded engine's launches of each world size (counters set to 0
    before each call; of a comparison or the dry run, the sharded runs'
    only, never the whole chain's)."""
    from qml_cutensornet_tpu_torch.cli import _pipeline as pipe
    from qml_cutensornet_tpu_torch.cli import main_no_test
    from qml_cutensornet_tpu_torch.parallel import dryrun, mesh, sharded_mps
    from qml_cutensornet_tpu_torch.utils.device import environ

    cards = torch.cuda.device_count()
    sizes = list(range(1, min(4, cards) + 1))
    brick = {**BRICK_KNOBS, "QMLTPU_ROUTING": "brick"}
    env_k5 = {**brick, "QMLTPU_SIM_BATCH": "8", "QMLTPU_FUSED_GATE": "1"}
    env_k1 = {**brick, "QMLTPU_SIM_BATCH": "8", "QMLTPU_FUSED_GATE": "0"}
    env_14 = {**brick, "QMLTPU_FUSED_GATE": "1"}
    shard = {"QMLTPU_SHARD_MPS": "all"}

    def inputs(argv, env):
        with environ(**env):
            params = pipe.parse_argv(list(argv))
            x = pipe.prepare(params)[0]
            return pipe.make_ansatz(params), x, pipe.sim_config(params, x), \
                expected_launches(argv, 1)

    a100, x100, cfg_k5, want_k5 = inputs(ARGV_BRICK100, env_k5)
    _, _, cfg_k1, want_k1 = inputs(ARGV_BRICK100, env_k1)
    a14, x14, cfg_14, want_14 = inputs(ARGV_BRICK14, env_14)
    runs = (("nf 100, K5", ARGV_BRICK100, env_k5, a100, x100, cfg_k5, want_k5,
             "brick nf 100 K5", "brick route, nf 100, chi 128, K5"),
            ("nf 100, K1", ARGV_BRICK100, env_k1, a100, x100, cfg_k1, want_k1,
             "brick nf 100 K1", "brick route, nf 100, chi 128, K1"),
            ("14 qubits, K5", ARGV_BRICK14, env_14, a14, x14, cfg_14, want_14,
             "brick 14 qubits", "brick route, 14 qubits, chi 128, K5"))
    by_path = {}
    for ws in sizes:
        calls = []
        for name, argv, env, ans, x, cfg, _, _, _ in runs:
            info = WORK / pipe.info_names(pipe.parse_argv(list(argv)))[0]
            calls += [  # the profile is kept aside before a run of the same argv overwrites it
                (main_no_test.main, (list(argv),), {}, {**env, **shard}),
                (shutil.copyfile, (f"{info}.json", f"{info}.{_slug(name)}.json"), {}, {}),
                (dryrun.compare_site_sharded, (ans, x, cfg, "cuda"), {}, {})]
        calls += [
            (sharded_mps.sharded_gram, (a100, x100, cfg_k5), dict(mesh=dryrun.MESH), {}),
            (dryrun.relay_full_and_symmetric, (a100, x100, cfg_k5),
             dict(mesh=dryrun.MESH, tile=RELAY_TILE), {}),
            (dryrun.site_sharded_dryrun, ("cuda",), {}, {}),
        ]
        t0 = time.perf_counter()
        recs = mesh.launch(dryrun.run_calls, ws, "cuda", "cuda", calls, timeout=900)
        wall = time.perf_counter() - t0
        what = f"site-sharded, world size {ws}"
        for i, (name, argv, _, _, x, _, want, gram, whole) in enumerate(runs):
            cli, cmp = recs[3 * i], recs[3 * i + 2]
            info = pipe.info_names(pipe.parse_argv(list(argv)))[0]
            prof = json.loads((WORK / f"{info}.{_slug(name)}.json").read_text())
            K = cli["out"]
            check_train_gram(K, len(x), f"{what}, {name}")
            err = float(np.abs(K - GRAMS[gram]).max())
            launches = cli["launches"]
            log(f"{what}, {name} [{smi}]: launches {launches} (plan {want}); sim "
                f"{prof['r0_circ_sim'][0]:.3f} s, tiles {prof['kernel_mat_time'][0]:.3f} s, "
                f"main_no_test {cli['seconds']:.3f} s, peak memory "
                f"{cli['peak_bytes'] / 2**30:.3f} GiB; whole chain (phase 7, this process) sim "
                f"{SIM_SECONDS[whole]:.3f} s; n_procs {prof['n_procs']}; avg_fidelity "
                f"{prof['avg_fidelity'][0]:.8f}, avg_max_chi {prof['ave max chi x'][0]:.2f}; "
                f"Gram vs the whole chain's {err:.3e} (tol {TOL_SITE_GRAM})")
            secs = {k: " / ".join(f"{t:.3f}" for t in cmp["out"][f"{k}_s"])
                    for k in ("sharded", "whole")}
            log(f"{what}, {name}, MPS in the rank's process (in turns whole, sharded, sharded, "
                f"whole): site-sharded {secs['sharded']} s, whole chain {secs['whole']} s, "
                f"peak {cmp['peak_bytes'] / 2**30:.3f} GiB; tensors {cmp['out']['tensor_err']:.3e} "
                f"(tol {TOL_SITE_TENSORS}), fidelity rtol {cmp['out']['fid_rtol']:.3e} (tol "
                f"{TOL_SITE_FID}), bond dims equal {cmp['out']['bond_dims_equal']}; launches "
                f"of the two runs, site-sharded {cmp['out']['launches']['sharded']}, whole "
                f"chain {cmp['out']['launches']['whole']}")
            assert launches == want, f"{what}, {name}: launches {launches} != plan {want}"
            assert launches["split"] > 0, launches
            assert (launches["brick_split"] > 0) == ("K5" in name), launches
            assert launches["orth_r"] == launches["orth"] == launches["gate_split"] == 0
            assert err <= TOL_SITE_GRAM, f"{what}, {name}: Gram off the whole chain's by {err}"
            assert cmp["out"]["bond_dims_equal"], f"{what}, {name}: bond dims differ"
            assert cmp["out"]["fid_rtol"] <= TOL_SITE_FID, cmp["out"]["fid_rtol"]
            assert cmp["out"]["tensor_err"] <= TOL_SITE_TENSORS, cmp["out"]["tensor_err"]
        sg, relay, dry = recs[-3:]
        k_sg, full, sym = sg["out"], relay["out"]["full"], relay["out"]["sym"]
        sg_err = float(np.abs(k_sg - recs[0]["out"]).max())
        sym_err = float(np.abs(sym - full).max())
        n_loc = sharded_mps.padded_sites_for(a100.schedule.num_sites_padded, ws) // ws
        t = RELAY_TILE
        off = ~np.eye(len(x100), dtype=bool)
        log(f"{what}, relay [{smi}]: sharded_gram {sg['seconds']:.3f} s (evolution and relay, "
            f"tile {sharded_mps.relay_auto_tile(cfg_k5.chi, n_loc)}), peak "
            f"{sg['peak_bytes'] / 2**30:.3f} GiB, vs (a)'s K5 Gram {sg_err:.3e} (tol "
            f"{TOL_RELAY}), diagonal off 1 by {float(np.abs(np.diag(k_sg) - 1).max()):.3e}; "
            f"relay of {len(x100)} states, tile {t}: all tiles "
            f"{relay['out']['full_s']:.4f} s, symmetric {relay['out']['sym_s']:.4f} s, "
            f"symmetric vs all {sym_err:.3e} (tol {TOL_RELAY_SYM}); off-diagonal overlaps max "
            f"{float(full[off].max()):.3e}")
        assert sg_err <= TOL_RELAY, f"{what}: sharded_gram off (a)'s Gram by {sg_err}"
        assert sym_err <= TOL_RELAY_SYM, f"{what}: symmetric relay off all tiles by {sym_err}"
        assert np.array_equal(sym[t:2 * t, :t], sym[:t, t:2 * t].T), f"{what}: mirror"
        log(f"{what}, dry run: {json.dumps(dry['out'])}, {dry['seconds']:.3f} s; launch wall "
            f"{wall:.3f} s")
        # The site-sharded engine's launches only: the CLI runs, the sharded
        # runs of each comparison and of the dry run, sharded_gram, the relay.
        total = dict.fromkeys(LAUNCH_NAMES, 0)
        for i in range(len(runs)):
            _add_all(total, recs[3 * i]["launches"])
            _add_all(total, recs[3 * i + 2]["out"]["launches"]["sharded"])
        for rec in (sg, relay):
            _add_all(total, rec["launches"])
        _add_all(total, dry["out"]["launches"])
        by_path[f"site_sharded_ws{ws}"] = total
    log(f"site-sharded phase: world sizes run {sizes} on {cards} card(s)")
    return by_path


def phase_auto_chi(smi):
    """``QMLTPU_CHI=auto`` through ``cli.main`` (train Gram, test Gram, SVC
    sweep) at the headline shape on 20 + 20 points, probes capped at chi 64
    (``QMLTPU_AUTO_CHI_MAX``): one probe sequence on the first 8 train
    points, shared by both Grams."""
    import contextlib
    import io
    import re

    from qml_cutensornet_tpu_torch.cli import _pipeline as pipe
    from qml_cutensornet_tpu_torch.cli import main
    from qml_cutensornet_tpu_torch.ops import _build
    from qml_cutensornet_tpu_torch.utils.device import environ

    pipe._auto_chi_cache.clear()
    buf = io.StringIO()
    with environ(QMLTPU_CHI="auto", QMLTPU_AUTO_CHI_MAX="64"):
        _build.reset_counters()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            K_train, K_test, _, _ = main.main(list(ARGV_ONE_BATCH))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_ON_CUDA)
    text = buf.getvalue()
    probes = [(int(c), float(f), int(b)) for c, f, b in re.findall(
        r"choose_chi: chi=(\d+) min_fidelity=(\S+) max_bond=(\d+)", text)]
    chosen = [int(c) for c in re.findall(r"QMLTPU_CHI=auto selected chi=(\d+)", text)]
    log(f"auto chi: probes (chi, min fidelity, max bond) {probes}; chosen {chosen}; "
        f"main() {wall:.3f} s")
    assert len(chosen) == 1, f"{len(chosen)} probe sequences in one run (want 1)"
    assert probes and probes[-1][0] == chosen[0] and probes[0][0] == 8
    want = dict.fromkeys(LAUNCH_NAMES, 0)
    for chi, _, _ in probes:  # one sim batch of the 8 sample points each
        with environ(QMLTPU_CHI=str(chi), QMLTPU_OVERSAMPLE="0"):
            _add_all(want, expected_launches(ARGV_ONE_BATCH, 1))
    with environ(QMLTPU_CHI=str(chosen[0])):  # train 1 batch, test 1 + 1
        _add_all(want, expected_launches(ARGV_ONE_BATCH, 3))
    log(f"auto chi: launches {launches}, plain versions on CUDA tensors {plain}")
    assert launches == want, f"auto chi: launches {launches} != expected {want}"
    assert sum(plain.values()) == 0
    check_train_gram(K_train, 32, "auto chi")
    assert K_test.shape == (8, 32) and np.isfinite(K_test).all()
    return launches


def phase_track_mem(smi):
    """``cli.main_track_mem`` at nf 100, r 2, d 6, chi 64 on one circuit
    (the memory-evolution figure's shape): one ``MPS size`` line per op of
    the schedule."""
    import contextlib
    import io

    from qml_cutensornet_tpu_torch.cli import _pipeline as pipe
    from qml_cutensornet_tpu_torch.cli import main_track_mem
    from qml_cutensornet_tpu_torch.utils.device import environ

    argv = ["main_track_mem", "GPU", "100", "2", "1.0", "6", "5", "5", "5", CSV_V1, "0"]
    out, err = io.StringIO(), io.StringIO()
    with environ(QMLTPU_CHI="64"):
        params = pipe.parse_argv(list(argv))
        cfg = pipe.sim_config(params)
        schedule = pipe.make_ansatz(params).schedule
        want = dict.fromkeys(LAUNCH_NAMES, 0)
        add, _ = op_launches(cfg, want)
        for seg in schedule.segments:
            for kind in seg.gkinds:
                add(cfg.chi, int(kind))
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            _, launches = count_launches(lambda: main_track_mem.main(list(argv)), want,
                                         "main_track_mem")
        wall = time.perf_counter() - t0
    log(f"main_track_mem: launches {launches}")
    lines = [line for line in err.getvalue().splitlines() if "MPS size" in line]
    sizes = [float(line.split("=")[1]) for line in lines]
    final = {line.split(":")[0]: line.split(":")[1].strip()
             for line in out.getvalue().splitlines()
             if line.startswith(("Final fidelity:", "Max bond dimension:"))}
    log(f"main_track_mem, nf 100, r 2, d 6, chi 64, one circuit [{smi}]: {len(lines)} MPS size "
        f"lines for {schedule.num_two_site_ops} ops; last size {sizes[-1]} MiB, largest "
        f"{max(sizes)} MiB; final fidelity {final['Final fidelity']}, max bond "
        f"{final['Max bond dimension']}; wall {wall:.3f} s")
    assert len(lines) == schedule.num_two_site_ops == 3744, len(lines)
    assert min(sizes) > 0
    return launches


def phase_harness(smi):
    """Phase 12b: the qubit_scaling and crossover suites on the card at one
    point each (d 2 in both modes), their CSVs against the profiles, their
    Grams and launches."""
    import contextlib
    import tempfile

    from qml_cutensornet_tpu_torch.runs import _harness, common, crossover, qubit_scaling
    from qml_cutensornet_tpu_torch.utils.device import environ

    assert "QMLTPU_CHI" not in os.environ and "QMLTPU_SIM_BATCH" not in os.environ
    out = pathlib.Path(tempfile.mkdtemp(prefix="harness_", dir=WORK))
    qs_argv = ["main_no_test", "GPU", "30", "2", "1.0", "6", "5", "5", "5", CSV_V1]
    xo_argv = ["main_no_test", "{}", "100", "2", "1.0", "2", "5", "5", "5", CSV_V1]
    # Both suites run at cap 64 (CHI_FOR_NF[30], chi_for_d(2)) and a sim
    # batch of 10: the 8 train points in one batch.
    assert qubit_scaling.CHI_FOR_NF[30] == crossover.chi_for_d(2) == 64
    with environ(QMLTPU_CHI="64", QMLTPU_SIM_BATCH="10"):
        want = expected_launches(qs_argv, 1)
        for label in ("CPU", "GPU"):
            _add_all(want, expected_launches([a.format(label) for a in xo_argv], 1))
    knobs = dict(QMLTPU_RUNS_DIR=str(out), PREWARM="0", NFS="30", GAMMAS="1.0", NTR="5", D="6",
                 DS="2")
    t0 = time.perf_counter()
    with environ(**knobs):
        grams, launches = count_launches(
            lambda: {**qubit_scaling.run(), **crossover.run("cpu", "gpu")}, want, "harness")
        with contextlib.redirect_stdout(sys.stderr):
            qs_rows = qubit_scaling.csv()
            gpu_rows, cpu_rows = crossover.csv()
        lines = {(r.get("mode", "qs"), r["record"]): r
                 for suite in ("qubit_scaling", "crossover") for r in _harness.read_runs(suite)}
    assert "QMLTPU_CHI" not in os.environ and "QMLTPU_SIM_BATCH" not in os.environ
    assert len(grams) == 3 and len(qs_rows) == len(gpu_rows) == len(cpu_rows) == 1, grams.keys()
    for name, K in grams.items():
        check_train_gram(K, 8, f"harness {name}")
    checks = [("qs", qs_rows[0], out / "qubit_scaling/raw",
               {"avg_mps_time": "avg_circ_sim", "avg_dot_time": "avg_product",
                "avg_mps_mem": "avg_mps_mem"}),
              ("gpu", gpu_rows[0], out / "crossover/raw/gpu",
               {"median_mps_time": "median_circ_sim", "median_dot_time": "median_product",
                "q1_mps_time": "q1_circ_sim", "avg_mps_mem": "avg_mps_mem"}),
              ("cpu", cpu_rows[0], out / "crossover/raw/cpu",
               {"median_mps_time": "median_circ_sim", "q3_dot_time": "q3_product"})]
    for label, row, raw, keys in checks:
        (path,) = raw.glob("*.json")
        prof = json.loads(path.read_text())
        assert row["features"] == int(path.name.split("_")[1][2:]), (row, path.name)
        for col, key in keys.items():
            assert row[col] == prof[key][0], (path.name, col, row[col], prof[key][0])
        chi = common.avg_max_chi(prof)
        assert row["avg_max_chi"] == chi, (path.name, row["avg_max_chi"], chi)
        line = lines[(label, path.stem)]
        log(f"harness {label} {path.stem} [{smi}]: avg_max_chi {chi}, sim "
            f"{prof['r0_circ_sim'][0]:.3f} s, tiles {prof['kernel_mat_time'][0]:.3f} s, peak "
            f"{line['peak_bytes']} B, states {line['states']}, criterion "
            f"{line.get('criterion', 'fidelity')}")
    assert gpu_rows[0]["avg_max_chi"] == cpu_rows[0]["avg_max_chi"]
    _add_all(launches, phase_runtime_scaling(smi, out))
    log(f"harness phase: launches {launches}, {time.perf_counter() - t0:.3f} s")
    shutil.rmtree(out)
    return launches


def phase_runtime_scaling(smi, out):
    """Phase 12b, the runtime_scaling suite: ``run`` at nf 165, d 1, 4 + 4
    points in this process and on the ring at world size 1 (one rank of
    ``mesh.launch``), and ``ladder`` at world size 1 on the card at 16
    qubits (bonds up to 256 uncapped, so the cap of 64 truncates: the rung's
    avg_max_chi is 64 and its avg_fidelity below 1; at the suite's 100
    qubits the svd method makes a rung's builds take minutes, 80 s each on
    an H100), its Gram held to the single-device build of the same
    features. Each run's launches
    equal the op stream's (the rank's own counters for the ring and the
    ladder, reset before each call); returns their sum."""
    import contextlib

    from qml_cutensornet_tpu_torch.config import SimConfig
    from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
    from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
    from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix
    from qml_cutensornet_tpu_torch.parallel import gram as pgram
    from qml_cutensornet_tpu_torch.runs import _harness, common, runtime_scaling
    from qml_cutensornet_tpu_torch.utils.device import environ

    t0 = time.perf_counter()
    argv = ["main_no_test", "GPU", "165", "2", "0.1", "1", "4", "4", "5",
            _harness.SYNTHETIC_CSV]
    knobs = dict(QMLTPU_RUNS_DIR=str(out), PREWARM="0", NF="165", NTRS="4", RING_NTRS="4",
                 NDEVS="1", NQ="16")
    with environ(**knobs):
        grams, launches = count_launches(runtime_scaling.run, expected_launches(argv, 1),
                                         "runtime_scaling")
        with contextlib.redirect_stdout(sys.stderr):
            rows = runtime_scaling.csv()
            ladder = runtime_scaling.ladder()
        lines = _harness.read_runs("runtime_scaling")
    raw = out / "runtime_scaling" / "raw"
    (one, ring), (line_one, line_ring, line_ladder) = sorted(grams), lines
    assert ring == f"{one}_ring" and one.endswith("_m1"), sorted(grams)
    prof = {name: json.loads((raw / f"{name}.json").read_text()) for name in (one, ring)}
    n = prof[one]["lenX"][0]
    for name in (one, ring):
        check_train_gram(grams[name], n, f"runtime_scaling {name}")
        assert prof[name]["n_procs"] == [1, "devices"], prof[name]["n_procs"]
    ring_err = float(np.abs(grams[ring] - grams[one]).max())
    block, _ = pgram.ring_rows(n, None, 1, 32)
    want_ring = expected_launches(argv, -(-n // block))
    assert line_ring["launches"] == want_ring, (line_ring["launches"], want_ring)
    by_name = {r["data_set"]: r for r in rows}
    for name, key in ((one, "elliptic_preproc_m1"), (ring, "elliptic_preproc_m1_ring")):
        row = by_name[key]
        assert (row["mps_wall_time"], row["dot_wall_time"], row["total_wall_time"]) == (
            prof[name]["r0_circ_sim"][0], prof[name]["r0_product"][0],
            prof[name]["total_time"][0]), (name, row)
        assert row["avg_max_chi"] == common.avg_max_chi(prof[name]), (name, row)

    # The ladder's rung: the reference's dataclass defaults (the svd method,
    # the fused split off) at chi 64, d 6, 4 points, one dispatch a build,
    # cold and warm.
    (row,) = ladder["rows"]
    K = ladder["grams"][1]
    cfg = SimConfig(chi=row["chi"], precision="f32")
    ladder_argv = ["ladder", "GPU", str(row["nq"]), str(row["layers"]), "1.0", str(row["d"]),
                   "4", "4", "5", _harness.SYNTHETIC_CSV]
    block, _ = pgram.ring_rows(row["points"], None, 1, 32)
    want_ladder = expected_launches(ladder_argv, -(-row["points"] // block), cfg)
    for key in ("cold_launches", "launches"):
        assert line_ladder[key] == want_ladder, (key, line_ladder[key], want_ladder)
    check_train_gram(K, row["points"], "runtime_scaling ladder")
    single = build_kernel_matrix(
        KernelStateAnsatz(row["nq"], row["layers"], 1.0, entanglement_graph(row["nq"], row["d"])),
        ladder["features"][1], cfg=cfg, device=os.environ["QMLTPU_DEVICE"])
    ladder_err = float(np.abs(K - single).max())
    log(f"runtime_scaling [{smi}]: {one}: sim {prof[one]['r0_circ_sim'][0]:.3f} s, tiles "
        f"{prof[one]['kernel_mat_time'][0]:.3f} s, avg_max_chi {common.avg_max_chi(prof[one])}, "
        f"avg_fidelity {prof[one]['avg_fidelity'][0]:.8f}, peak {line_one['peak_bytes']} B; the "
        f"ring at world size 1: sim {prof[ring]['r0_circ_sim'][0]:.3f} s, ring "
        f"{prof[ring]['kernel_mat_time'][0]:.3f} s, Gram vs in-process {ring_err:.3e} (tol "
        f"{TOL_RING_SINGLE}), launches {line_ring['launches']}; ladder rung 1: {json.dumps(row)}, "
        f"sim {line_ladder['sim_s']:.3f} s, ring {line_ladder['ring_s']:.3f} s, Gram vs the "
        f"single-device build {ladder_err:.3e} (tol {TOL_RING_SINGLE}), launches a build "
        f"{line_ladder['launches']}; {time.perf_counter() - t0:.3f} s")
    assert ring_err <= TOL_RING_SINGLE, f"runtime_scaling: ring off in-process by {ring_err}"
    assert ladder_err <= TOL_RING_SINGLE, f"runtime_scaling: ladder off one device by {ladder_err}"
    assert line_ladder["avg_max_chi"] == row["chi"] and line_ladder["avg_fidelity"] < 1.0, (
        f"runtime_scaling: the ladder's rung does not truncate: {line_ladder}")
    assert row["eff_program"] == 1.0, row
    assert ("NCCL" in row["platform"]) == (os.environ["QMLTPU_DEVICE"] == "cuda"), row
    for extra in (line_ring["launches"], line_ladder["cold_launches"], line_ladder["launches"]):
        _add_all(launches, extra)
    return launches


def phase_residency(smi):
    """The large-chi memory path: ``cli.main_no_test`` at the crossover's d-8
    configuration (nf 100, chi 256, 8 points in one sim batch) with the default
    ``QMLTPU_STATES_DEVICE_BYTES`` (states on the card) and with 0 (states in
    host memory, each tile's block trimmed to its bucket and uploaded); the
    two Grams held to each other (bit-equality printed), and each run's
    sim, tile and upload seconds, peak memory, avg_max_chi and
    avg_fidelity printed."""
    import contextlib
    import io
    import re

    from qml_cutensornet_tpu_torch.cli import main_no_test
    from qml_cutensornet_tpu_torch.models import gram
    from qml_cutensornet_tpu_torch.ops.mps import MPS
    from qml_cutensornet_tpu_torch.utils.device import environ
    from qml_cutensornet_tpu_torch.utils.naming import run_info

    os.environ.pop("QMLTPU_STATES_DEVICE_BYTES", None)  # the first run takes the default
    info = run_info("train", 100, 2, 1.0, 8, 5, 5, CSV_V1)
    grams, total = {}, dict.fromkeys(LAUNCH_NAMES, 0)
    t_phase = time.perf_counter()
    # The host path replays the device path's simulation (the same points
    # and config; the simulation is deterministic: its launches are
    # bit-equal), so that only the states' residency and the tiles differ.
    replay, real_make = {}, gram.make_chunked_simulator

    def replaying(schedule, cfg, device, **kw):
        sim = real_make(schedule, cfg, device, **kw)

        def run_sim(x):  # a host copy, so that the device path's peak is its own
            key = np.asarray(x).tobytes()
            if key in replay:
                return MPS(*(t.to(device) for t in replay[key]))
            out = sim(x)
            replay[key] = tuple(t.cpu() for t in (out.tensors, out.fidelity, out.bond_dims))
            return out

        return run_sim

    gram.make_chunked_simulator = replaying
    try:
        for path, knobs in (("device", RESIDENCY_KNOBS),
                            ("host", dict(RESIDENCY_KNOBS, QMLTPU_STATES_DEVICE_BYTES="0"))):
            what = f"residency, {path} path"
            buf = io.StringIO()

            def run():
                with contextlib.redirect_stdout(buf):
                    return main_no_test.main(list(ARGV_D8))

            with environ(**knobs):
                # the host path's simulation is the device path's, replayed
                want = (expected_launches(ARGV_D8, 1) if path == "device"
                        else dict.fromkeys(LAUNCH_NAMES, 0))
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                K, launches = count_launches(run, want, what)
                peak = torch.cuda.max_memory_allocated()
            _add_all(total, launches)
            found = re.findall(r"States (\w+)-resident: tiles (\S+) s, of them uploads (\S+) s",
                               buf.getvalue())
            assert len(found) == 1, f"{what}: {len(found)} residency lines"
            regime, _, upload = found[0]
            assert regime == path, f"{what}: the states were {regime}-resident"
            check_train_gram(K, 8, what)
            grams[path] = K
            log(profile_line(info, smi, what) + f", uploads {float(upload):.3f} s, peak memory "
                f"{peak / 2**30:.3f} GiB ({base / 2**30:.3f} GiB held before the run; default "
                f"limit {gram.STATES_DEVICE_BYTES:.4g} B)")
    finally:
        gram.make_chunked_simulator = real_make
    diff = float(np.abs(grams["host"] - grams["device"]).max())
    log(f"residency [{smi}]: host-path Gram vs device-path Gram max abs diff {diff:.3e} "
        f"(tol {TOL_RESIDENCY}; bit-equal {np.array_equal(grams['host'], grams['device'])}); "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    assert diff <= TOL_RESIDENCY, f"host path off the device path by {diff}"
    return total


# Phase 14, the reduced precisions. K7 against its plain version: the two
# differ only in the order of their f32 sums, so elementwise within both
# sums' worst case, 2 (2 K P + 2) 2^-24 of |op(a)| |b|; against the exact
# product within the class's bound (ops/lowp.rel_bound). The routes' Grams
# against the default route's, and K - K^T (K[i, j] and K[j, i] of a
# diagonal tile round apart): three passes at the routes' bar; one pass
# keeps 8 bits a product, which a scan of 16 steps can carry past any useful
# bar (8 qubits at chi 16 on the CPU: K - K^T 8.8e-3), so those two are
# printed, and the pass is held by (a) and (c). K7 against its plain
# version on the same states: the tiles differ by the f32 sums and the rare
# bf16 rounding those sums move.
TOL_LOWP_GRAM = {3: TOL_ROUTES, 1: None}
TOL_K7_SAME_STATES = {3: 1e-6, 1: 2.0**-8}
BF16_PEAK = 989e12  # H100 SXM dense bf16 tensor cores at 700 W (NVIDIA's data sheet)
HBM_RATE = 3.35e12
# [B, M, N, K] and op: the headline tile's two products of a site block
# (tile 32, chi 64, tile block 2), the chi-64 power products (B 32), ragged.
CGEMM_MAIN = ((32, 2048, 256, 64, "n"), (32, 64, 2048, 256, "h"),
              (32, 128, 64, 128, "h"), (32, 128, 64, 128, "n"))
CGEMM_RAGGED = ((3, 17, 33, 70, "n"), (3, 17, 33, 70, "h"), (2, 65, 130, 1, "h"))
# K7's plans on each side of their boundaries (``csrc/bf16_cgemm.cu``; ragged
# M, N and K, op "h" on a, on b and on both): [B, M, N, K], op, op_b, plan.
CGEMM_BOUNDARY = ((3, 5, 7, 8, "h", "h", "thin_k"), (3, 5, 7, 9, "n", "h", "small"),
                  (5, 9, 2, 40, "h", "n", "thin_n"), (5, 9, 3, 40, "n", "h", "small"),
                  (264, 64, 64, 16, "n", "h", "large_m"), (263, 64, 64, 16, "h", "h", "small"),
                  (264, 64, 65, 16, "h", "n", "large_n"), (64, 300, 70, 33, "h", "h", "large_m"),
                  (64, 70, 300, 33, "n", "h", "large_n"))
LOWP_ROUTES = (("tile high", {"QMLTPU_TILE_PRECISION": "high"}),
               ("tile bfloat16", {"QMLTPU_TILE_PRECISION": "bfloat16"}),
               ("power high", {"QMLTPU_POWER_PRECISION": "high"}))


def cgemm_bound(B, M, N, K, passes):
    """K7's least time in ms: the larger of its tensor-core operations (8 M N
    K a pass, a batch element) over the bf16 peak and its bytes (each
    complex64 operand read once, C written once) over the memory rate."""
    t_ops = 8.0 * B * M * N * K * passes / BF16_PEAK * 1e3
    t_bytes = 8.0 * B * (M * K + K * N + M * N) / HBM_RATE * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def cgemm_key(B, M, N, K, op, passes):
    return f"B{B}_M{M}_N{N}_K{K}_{op}_P{passes}"


def expected_tile_cgemm(argv, n_points, cfg=None):
    """K7 launches of a symmetric train Gram's tiles (``models/gram``) under
    the current environment (``cfg``: the CLI's config of ``argv`` unless
    given): none at a full tile precision; else per tile
    of the block triangle two products a scan step (``n / k`` steps, one
    more for a remainder) and, with a site block ``k > 1``, ``k - 1``
    combining products for each side's whole blocks (``rem - 1`` for its
    remainder)."""
    from qml_cutensornet_tpu_torch.cli import _pipeline as pipe
    from qml_cutensornet_tpu_torch.models import gram
    from qml_cutensornet_tpu_torch.ops import lowp

    params = pipe.parse_argv(list(argv))
    cfg = cfg or pipe.sim_config(params)
    if not lowp.reduced_passes(cfg.resolved_tile_precision, cfg.complex_dtype):
        return 0
    n, k = params.num_features, cfg.tile_block
    tile = gram._auto_tile(int(os.environ.get("QMLTPU_TILE", "32")), cfg.chi, n, k)
    nb = -(-n_points // tile)
    g, rem = divmod(n, k)
    combines = ((k - 1 if g else 0) + (rem - 1 if rem else 0)) if k > 1 else 0
    return nb * (nb + 1) // 2 * (2 * combines + 2 * (g + (1 if rem else 0)))


def phase_reduced_precision(dev, smi, golden, K_default, x_train):
    """The reduced power and tile precisions: (a) K7 against its plain
    version and the exact product at the main paths' shapes, both ops, both
    pass counts and ragged edges, two launches bit-equal, and its times
    beside ``torch.matmul`` in full f32 (the library call) and its bound;
    (b) ``cli.main_no_test`` at the headline shape with
    ``QMLTPU_TILE_PRECISION=high``, ``=bfloat16`` and
    ``QMLTPU_POWER_PRECISION=high``, each against the golden and the default
    route's Gram, its K7 launches equal to the op stream's and the tiles'
    count (K1 none on the power route); (c) the golden's 8 points simulated
    once, their tiles by K7, by its plain version and in full f32, each
    against the golden. Returns (the kernel's summary, launches by route)."""
    from qml_cutensornet_tpu_torch.cli import _pipeline as pipe
    from qml_cutensornet_tpu_torch.cli import main_no_test
    from qml_cutensornet_tpu_torch.models import gram, simulate
    from qml_cutensornet_tpu_torch.ops import _build, lowp
    from qml_cutensornet_tpu_torch.utils.device import environ
    from qml_cutensornet_tpu_torch.utils.naming import run_info

    t_phase = time.perf_counter()
    rng = np.random.default_rng(20261018)

    def operands(B, M, N, K, op, op_b="n"):
        def c(*shape):
            x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            return torch.from_numpy(x.astype(np.complex64)).to(dev)
        return (c(B, K, M) if op == "h" else c(B, M, K)), (c(B, N, K) if op_b == "h" else
                                                            c(B, K, N))

    # (a) the kernel: every plan's registers, local (spill) and shared bytes
    plans = {}
    for name in lowp.PLANS:
        for P in (3, 1):
            at = {ops: lowp.plan_attrs(name, P, *ops) for ops in ("nn", "hn", "nh", "hh")}
            plans[f"{name}_P{P}"] = at
            log(f"  K7 plan {name}, {P} pass{'es' if P > 1 else ''}: " + "; ".join(
                f"{ops} {x['threads']} threads, {x['registers']} registers, {x['local_bytes']} B "
                f"local, {x['static_smem'] + x['dynamic_smem']} B shared" for ops, x in at.items()))
    err = 0.0
    for B, M, N, K, op, op_b, want in ([(*x, "n", None) for x in CGEMM_MAIN + CGEMM_RAGGED]
                                       + list(CGEMM_BOUNDARY)):
        plan = lowp.plan(B, M, N, K)
        assert want is None or plan == want, f"K7 [{B},{M},{N},{K}]: plan {plan}, not {want}"
        a, b = operands(B, M, N, K, op, op_b)
        a64 = (a.mH if op == "h" else a).to(torch.complex128)
        b64 = (b.mH if op_b == "h" else b).to(torch.complex128)
        exact, scale = a64 @ b64, a64.abs() @ b64.abs()
        full = (a.mH if op == "h" else a) @ (b.mH if op_b == "h" else b)
        for P in (3, 1):
            got, again = lowp.cgemm(a, b, P, op, op_b), lowp.cgemm(a, b, P, op, op_b)
            plain = lowp.cgemm_plain(a, b, P, op, op_b)
            torch.cuda.synchronize()
            what = (f"K7 [{B},{M},{N},{K}] op {op}{op_b} plan {plan}, "
                    f"{P} pass{'es' if P > 1 else ''}")
            assert torch.equal(got, again), f"{what}: two launches differ"
            rel_plain = ((got - plain).abs() / scale).max().item()
            rel_exact = ((got - exact).abs() / scale).max().item()
            abs_plain = (got - plain).abs().max().item()
            abs_full = (got - full).abs().max().item()
            err = max(err, abs_plain)
            log(f"  {what}: vs plain max abs {abs_plain:.3e} (relative to |a||b| "
                f"{rel_plain:.3e}, tol {2 * (2 * K * P + 2) * 2.0**-24:.3e}); vs the exact "
                f"product {rel_exact:.3e} relative (class bound {lowp.rel_bound(P, K):.3e}); "
                f"vs torch.matmul in f32 max abs {abs_full:.3e}")
            assert rel_plain <= 2 * (2 * K * P + 2) * 2.0**-24, f"{what}: off its plain version"
            assert rel_exact <= lowp.rel_bound(P, K), f"{what}: outside its class's bound"
    # device time (a CUDA graph of 20 launches, the kernel alone) and call
    # time (back-to-back calls, host path included) of K7 and torch.matmul
    by_shape = {}
    for B, M, N, K, op in CGEMM_MAIN:
        a, b = operands(B, M, N, K, op)
        am = a.mH if op == "h" else a
        plan = lowp.plan(B, M, N, K)
        for P in (3, 1):
            kern, lib = (lambda: lowp.cgemm(a, b, P, op)), (lambda: am @ b)
            d1, dl, d2 = graph_ms(kern), graph_ms(lib), graph_ms(kern)
            c1, cl, c2 = time_ms(kern, 20), time_ms(lib, 20), time_ms(kern, 20)
            host = host_ms(kern)
            plain_ms = time_ms(lambda: lowp.cgemm_plain(a, b, P, op), 3)
            bound_ms, bound_by = cgemm_bound(B, M, N, K, P)
            by_shape[cgemm_key(B, M, N, K, op, P)] = {
                "plan": plan, "ms": (d1 + d2) / 2, "call_ms": (c1 + c2) / 2, "host_ms": host,
                "plain_ms": plain_ms, "library_ms": dl, "library_call_ms": cl,
                "bound_ms": bound_ms, "bound_by": bound_by}
            log(f"  time K7 [{B},{M},{N},{K}] op {op}, {P} pass{'es' if P > 1 else ''}, plan "
                f"{plan} [{smi}]: device {d1:.4f} / {d2:.4f} ms, torch.matmul f32 device "
                f"{dl:.4f} ms (turns kernel, matmul, kernel); call {c1:.4f} / {c2:.4f} ms, "
                f"torch.matmul f32 call {cl:.4f} ms; host {host:.4f} ms a call; plain "
                f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}; "
                f"{8.0 * B * M * N * K * P / 1e9:.2f} GFLOP)")
    # the main shape: the tile route's first product at tile "high"
    summary = {"max_abs_err": err, **by_shape[cgemm_key(*CGEMM_MAIN[0], 3)],
               "ms_by_shape": by_shape, "plans": plans}

    # (b) the routes, each through cli.main_no_test
    info = run_info("train", int(ARGV[2]), int(ARGV[3]), float(ARGV[4]), int(ARGV[5]),
                    int(ARGV[6]), int(ARGV[8]), ARGV[9])
    by_route = {}
    for name, knobs in LOWP_ROUTES:
        what = f"reduced precision, {name}"
        with environ(**knobs):
            want = expected_launches(ARGV, 4)
            want["cgemm"] += expected_tile_cgemm(ARGV, 102)
            cfg = pipe.sim_config(pipe.parse_argv(list(ARGV)))
            K, launches = count_launches(lambda: main_no_test.main(list(ARGV)), want, what)
        passes = lowp.passes(knobs.get("QMLTPU_TILE_PRECISION",
                                       knobs.get("QMLTPU_POWER_PRECISION")))
        assert launches["cgemm"] > 0, f"{what}: K7 never launched"
        if "QMLTPU_POWER_PRECISION" in knobs:
            assert launches["split"] == launches["gate_split"] == 0, launches
        check_train_gram(K, 102, what, TOL_LOWP_GRAM[passes])
        gold_err = float(np.abs(K[:8, :8] - golden["k"]).max())
        route_err = float(np.abs(K - K_default).max())
        sym_err = float(np.abs(K - K.T).max())
        log(profile_line(info, smi, what) + f", golden 8x8 max_abs_err {gold_err:.3e} (the "
            f"default route's bar {TOL_GOLDEN}, printed); vs the default route's Gram "
            f"{route_err:.3e} (tol {TOL_LOWP_GRAM[passes] or 'none, printed'}); K - K^T "
            f"{sym_err:.3e} (the same); "
            f"K7 launches {launches['cgemm']} "
            f"(expected {want['cgemm']}: tile block {cfg.tile_block}, power iterations "
            f"{cfg.subspace_iters})")
        assert TOL_LOWP_GRAM[passes] is None or route_err <= TOL_LOWP_GRAM[passes], (
            f"{what}: K off the default route's")
        GRAMS[what] = K
        by_route[name.replace(" ", "_")] = launches

    # (c) the golden's 8 points simulated once; their tiles by K7, by its
    # plain version on the same states (outside the counted runs) and in f32
    params = pipe.parse_argv(list(ARGV))
    cfg = pipe.sim_config(params)
    states = gram.simulate_dataset(pipe.make_ansatz(params).schedule, x_train[:8], cfg, 8,
                                   dev)[0]

    def normalized(precision):
        k = simulate.tile_overlaps_sq(states, states, precision, cfg.tile_block).cpu().numpy()
        dg = np.sqrt(np.diag(k))
        return k / np.outer(dg, dg)

    full = normalized("highest")
    line = [f"full f32 {np.abs(full - golden['k']).max():.3e}"]
    for precision in ("high", "bfloat16"):
        kern = normalized(precision)
        real_cgemm, lowp.cgemm = lowp.cgemm, lowp.cgemm_plain
        try:
            plain = normalized(precision)
        finally:
            lowp.cgemm = real_cgemm
        diff = float(np.abs(kern - plain).max())
        passes = lowp.passes(precision)
        line.append(f"{precision}: K7 {np.abs(kern - golden['k']).max():.3e}, plain "
                    f"{np.abs(plain - golden['k']).max():.3e}, K7 vs plain {diff:.3e} (tol "
                    f"{TOL_K7_SAME_STATES[passes]:.3e})")
        assert diff <= TOL_K7_SAME_STATES[passes], f"same states, {precision}: K7 off plain"
    log(f"reduced precision, the golden's 8 points simulated once [{smi}]: golden 8x8 "
        f"max_abs_err by tile precision: " + "; ".join(line))
    _build.reset_counters()
    log(f"reduced precision phase {time.perf_counter() - t_phase:.1f} s")
    return summary, by_route


# Phase 15, the reduced ambient class (``SimConfig.matmul_precision``):
# every product of the engine on K7 (``ops/lowp.matmul``). (a) K7 at the
# engine's shapes against its plain version, elementwise within both f32
# sums' worst case (as phase 14), and the exact product within the class's
# bound. (b) and (c) Whole runs through kernel K7 and through its plain
# version on the card: two roundings of one class, which truncation
# amplifies (the 32-qubit headline truncates at chi 64). Three passes: the
# routes' bar, 3e-5. One pass: 2^-8, one class unit (on the CPU, two f32
# summation orders of the plain version took a truncating 12-qubit chi-16
# Gram 7.4e-4 apart, 0.19 unit). The golden is printed, not gated: one pass
# keeps 8 bits a product (the reference expects about 1e-2 in deep
# circuits, its ``config.py``), three passes about 16.
AMBIENT_PRECISIONS = ("high", "bfloat16")
TOL_AMBIENT_K7_PLAIN = {3: TOL_ROUTES, 1: 2.0**-8}
AMBIENT_BRICK_KNOBS = dict(BRICK_KNOBS, QMLTPU_ROUTING="brick", QMLTPU_FUSED_GATE="1")


def ambient_operands(rng, dev):
    """K7's operands at the engine's shapes on the ambient headline route
    (chi 64, a sim batch of 32; the scanned panel step at chi 256), as the
    engine views them: ``(name, a, b, op, op_b)``."""
    def c(*shape):
        x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(x.astype(np.complex64)).to(dev)

    chi, B = 64, 32
    state = c(B, 32, chi, 2, chi)  # a state batch; a site is a view
    site, right = state[:, 1], state[:, 2]
    r = c(B, chi, chi)
    theta = c(B, 2 * chi, 2 * chi)
    panel = c(B, 512, 32)
    return [
        ("theta build", site.reshape(B, 2 * chi, chi), right.reshape(B, chi, 2 * chi), "n", "n"),
        ("gate, K = 4, inner stride 0", c(B, 4, 4)[:, None], theta.reshape(B, chi, 4, chi), "n",
         "n"),
        ("move right, r b", r, right.reshape(B, chi, 2 * chi), "n", "n"),
        ("move left, a r^H", site.reshape(B, 2 * chi, chi), r, "n", "h"),
        ("split r = q^H theta", c(B, 2 * chi, chi), theta, "h", "n"),
        ("power theta^H v0, batch stride 0", theta, c(2 * chi, chi).expand(B, 2 * chi, chi),
         "h", "n"),
        ("vdot t^H (m t)", site.reshape(B, 2 * chi, chi), c(B, 2 * chi, chi), "h", "n"),
        ("single column q^H x", panel[:, :, :31], panel[:, :, 31:], "h", "n"),
        ("Hadamard, batch stride 0", c(2, 2), state, "n", "n"),
        ("Hadamard on sites 1..30, two levels", c(2, 2), state[:, 1:31], "n", "n"),
    ]


def _unique_elements(x):
    """Elements ``x`` really holds: its broadcast (stride 0) axes count once."""
    return int(np.prod([d for d, st in zip(x.shape, x.stride()) if st != 0 or d == 1]))


def phase_ambient_precision(dev, smi, golden, K_default, x_train):
    """The reduced ambient class: (a) K7 at the engine's shapes through
    ``lowp.matmul`` against its plain version and the exact product, two
    launches bit-equal, timed beside ``torch.matmul`` in f32 and its bound;
    (b) the golden's 8 points (one sim batch, the headline's CLI config)
    through ``models/gram.build_kernel_matrix`` with ``matmul_precision``
    "high", then "bfloat16": K1, K4 and K5 never, K2 on every center move,
    K3 and K7 as the op stream and the tiles say; golden, ``K - K^T`` and
    the default route's Gram printed; the same run with K7's plain version,
    within ``TOL_AMBIENT_K7_PLAIN``; (c) the brick route at 14 qubits, chi
    128 (one sim batch of 32) at "high" likewise, K5 and K1 never. Returns
    (K7's times by shape, launches by route)."""
    from qml_cutensornet_tpu_torch.cli import _pipeline as pipe
    from qml_cutensornet_tpu_torch.models import gram
    from qml_cutensornet_tpu_torch.ops import _build, lowp
    from qml_cutensornet_tpu_torch.utils.device import environ

    t_phase = time.perf_counter()
    # (a) the products at the engine's shapes
    by_shape = {}
    for name, a, b, op, op_b in ambient_operands(np.random.default_rng(20261019), dev):
        a64 = (a.mH if op == "h" else a).to(torch.complex128)
        b64 = (b.mH if op_b == "h" else b).to(torch.complex128)
        exact, scale = a64 @ b64, a64.abs() @ b64.abs()
        batch = int(np.prod(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])))
        M, N, K = exact.shape[-2], exact.shape[-1], a64.shape[-1]
        plan = lowp.plan(batch, M, N, K)
        for precision in AMBIENT_PRECISIONS:
            P = lowp.passes(precision)
            before = _build.LAUNCHES["cgemm"]
            got = lowp.matmul(a, b, precision, op, op_b)
            again = lowp.matmul(a, b, precision, op, op_b)
            assert _build.LAUNCHES["cgemm"] == before + 2, f"{name}: one K7 launch a product"
            real_cgemm, lowp.cgemm = lowp.cgemm, lowp.cgemm_plain
            try:
                plain = lowp.matmul(a, b, precision, op, op_b)
                plain_ms = time_ms(lambda: lowp.matmul(a, b, precision, op, op_b), 3)
            finally:
                lowp.cgemm = real_cgemm
            torch.cuda.synchronize()
            what = f"K7 {name} [{batch},{M},{N},{K}] op {op}{op_b} plan {plan}, {precision}"
            assert torch.equal(got, again), f"{what}: two launches differ"
            rel_plain = ((got - plain).abs() / scale).max().item()
            rel_exact = ((got - exact).abs() / scale).max().item()
            assert rel_plain <= 2 * (2 * K * P + 2) * 2.0**-24, f"{what}: off its plain version"
            assert rel_exact <= lowp.rel_bound(P, K), f"{what}: outside its class's bound"
            kern = lambda: lowp.matmul(a, b, precision, op, op_b)
            full = lambda: lowp.matmul(a, b, "highest", op, op_b)
            d1, dl, d2 = graph_ms(kern), graph_ms(full), graph_ms(kern)
            c1, cl, c2 = time_ms(kern, 20), time_ms(full, 20), time_ms(kern, 20)
            host, host_full = host_ms(kern), host_ms(full)
            nbytes = 8 * (_unique_elements(a) + _unique_elements(b) + batch * M * N)
            t_ops = 8.0 * batch * M * N * K * P / BF16_PEAK * 1e3
            bound_ms = max(t_ops, nbytes / HBM_RATE * 1e3)
            bound_by = "operations" if t_ops >= nbytes / HBM_RATE * 1e3 else "bytes"
            by_shape[f"{name}_{precision}"] = {
                "plan": plan, "ms": (d1 + d2) / 2, "call_ms": (c1 + c2) / 2, "host_ms": host,
                "plain_ms": plain_ms, "library_ms": dl, "library_call_ms": cl,
                "library_host_ms": host_full, "bound_ms": bound_ms, "bound_by": bound_by,
                "max_abs_err": (got - plain).abs().max().item()}
            log(f"  {what} [{smi}]: vs plain {rel_plain:.3e} of |op(a)||op_b(b)| (tol "
                f"{2 * (2 * K * P + 2) * 2.0**-24:.3e}), vs exact {rel_exact:.3e} (class bound "
                f"{lowp.rel_bound(P, K):.3e}); lowp.matmul device {d1:.4f} / {d2:.4f} ms, "
                f"torch.matmul f32 device {dl:.4f} ms; call {c1:.4f} / {c2:.4f} ms, "
                f"torch.matmul f32 call {cl:.4f} ms; host {host:.4f} ms a call (torch.matmul "
                f"{host_full:.4f}); plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by})")

    # (b) the golden's 8 points, (c) the brick route at 14 qubits
    runs = [(f"ambient_{p}", f"ambient {p}, the golden's 8 points", p, ARGV, {}, x_train[:8])
            for p in AMBIENT_PRECISIONS]
    with environ(**AMBIENT_BRICK_KNOBS):
        x_brick = pipe.prepare(pipe.parse_argv(list(ARGV_BRICK14)))[0]
    runs.append(("ambient_brick14_high", "ambient high, brick route, 14 qubits, chi 128",
                 "high", ARGV_BRICK14, AMBIENT_BRICK_KNOBS, x_brick))
    by_route = {}
    for key, what, precision, argv, knobs, x in runs:
        P = lowp.passes(precision)
        info = key
        with environ(**knobs):
            params = pipe.parse_argv(list(argv))
            cfg = dataclasses.replace(pipe.sim_config(params), matmul_precision=precision)
            ansatz = pipe.make_ansatz(params)
            want = expected_launches(argv, 1, cfg)
            want["cgemm"] += expected_tile_cgemm(argv, len(x), cfg)

            def run():
                return gram.build_kernel_matrix(ansatz, x, cfg=cfg, sim_batch=len(x),
                                                info_file=info, device="cuda")

            K, launches = count_launches(run, want, what)
            real_cgemm, lowp.cgemm = lowp.cgemm, lowp.cgemm_plain
            try:
                K_plain = run()
            finally:
                lowp.cgemm = real_cgemm
        assert launches["split"] == launches["gate_split"] == launches["brick_split"] == 0, (
            what, launches)
        assert launches["orth"] > 0 and launches["cgemm"] > 0, (what, launches)
        check_train_gram(K, len(x), what, None)
        plain_err = float(np.abs(K - K_plain).max())
        line = (profile_line(info, smi, what) + f", K7 launches {launches['cgemm']}, K2 "
                f"{launches['orth_r']}, K3 {launches['orth']}; K7 vs its plain version on the "
                f"card {plain_err:.3e} (tol {TOL_AMBIENT_K7_PLAIN[P]:.3e}); K - K^T "
                f"{np.abs(K - K.T).max():.3e}")
        if argv is ARGV:
            line += (f"; golden 8x8 max_abs_err {np.abs(K - golden['k']).max():.3e} (printed);"
                     f" vs the default route's Gram {np.abs(K - K_default[:8, :8]).max():.3e}")
        log(line)
        assert plain_err <= TOL_AMBIENT_K7_PLAIN[P], f"{what}: K7 off its plain version"
        GRAMS[what] = K
        by_route[key] = launches
    _build.reset_counters()
    log(f"ambient precision phase {time.perf_counter() - t_phase:.1f} s")
    return by_shape, by_route


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA card",
              file=sys.stderr)
        return 2
    from qml_cutensornet_tpu_torch.ops import _build
    from qml_cutensornet_tpu_torch.utils.data import load_and_prepare, preprocess_elliptic
    from qml_cutensornet_tpu_torch.utils.device import nvidia_smi

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | python {sys.version.split()[0]}")
    parent_built = phase_build(dev)
    if sys.argv[1:] == ["k8"]:  # K8 alone, beside the parent's where build/parent holds it
        k8 = phase_mgs2_kernel(dev, smi, parent_kernels(dev, parent_built))
        log(f"K8 phase done at {time.perf_counter() - t_start:.1f} s")
        print(smi)
        print(json.dumps({"mgs2_panel": k8}))
        return 0
    if sys.argv[1:] == ["harness"]:  # the experiment suites alone
        WORK.mkdir(parents=True, exist_ok=True)
        os.environ["QMLTPU_DEVICE"] = "cuda"
        launches = phase_harness(smi)
        log(f"harness phase done at {time.perf_counter() - t_start:.1f} s")
        print(smi)
        print(json.dumps({"harness": launches}))
        return 0
    err, times, stage_ms, parent = phase_kernels(dev, parent_built)
    log(f"kernels phase done at {time.perf_counter() - t_start:.1f} s")
    pair_err, pair_ms = phase_pair_kernels(dev)
    log(f"pair kernels phase done at {time.perf_counter() - t_start:.1f} s")
    k8 = phase_mgs2_kernel(dev, smi, parent)
    log(f"K8 phase done at {time.perf_counter() - t_start:.1f} s")

    (WORK / "datasets").mkdir(parents=True, exist_ok=True)
    csv = WORK / "datasets" / CSV_V1
    preprocess_elliptic(dataset_dir=str(RAW_V1), out_csv=str(csv))
    golden = np.load(GOLDEN)
    x_train = load_and_prepare(str(csv), 32, 64, 64, 5)[0]
    x_err = float(np.abs(x_train[:8] - golden["x"]).max())
    assert x_err <= 1e-12, f"first 8 train rows differ from the golden x by {x_err}"
    os.chdir(WORK)
    os.environ["QMLTPU_DEVICE"] = "cuda"

    by_path = {}
    K_default, by_path["default"] = phase_default_route(smi, golden)
    log(f"default route done at {time.perf_counter() - t_start:.1f} s")
    by_path["fused_gate"] = phase_fused_gate_route(smi, golden, K_default)
    log(f"fused-gate route done at {time.perf_counter() - t_start:.1f} s")
    by_path["unfused"] = phase_unfused_route(smi)
    log(f"unfused routes done at {time.perf_counter() - t_start:.1f} s")
    by_path["brick"], by_path["tracked_14q_chi128"] = phase_brick_route(smi)
    log(f"brick route done at {time.perf_counter() - t_start:.1f} s")
    pair_paths = phase_pair_routes(smi, golden, K_default)
    by_path.update(pair_paths)
    log(f"pair routes done at {time.perf_counter() - t_start:.1f} s")
    by_path.update(phase_caps_routes(smi))
    log(f"caps routes done at {time.perf_counter() - t_start:.1f} s")
    by_path["svd_eigh"] = phase_svd_methods(smi, golden, K_default, x_train)
    log(f"svd and eigh routes done at {time.perf_counter() - t_start:.1f} s")
    by_path["reference_routing"] = phase_reference_routing(smi, golden, K_default, x_train)
    log(f"reference routing done at {time.perf_counter() - t_start:.1f} s")
    by_path["checkpoint"] = phase_checkpoint(smi, K_default)
    log(f"checkpoint and resume done at {time.perf_counter() - t_start:.1f} s")
    by_path.update(phase_mesh(smi, golden, K_default))
    log(f"mesh phase done at {time.perf_counter() - t_start:.1f} s")
    by_path.update(phase_site_sharded(smi))
    log(f"site-sharded phase done at {time.perf_counter() - t_start:.1f} s")
    by_path["auto_chi"] = phase_auto_chi(smi)
    log(f"auto chi done at {time.perf_counter() - t_start:.1f} s")
    by_path["track_mem"] = phase_track_mem(smi)
    log(f"main_track_mem done at {time.perf_counter() - t_start:.1f} s")
    by_path["harness"] = phase_harness(smi)
    log(f"harness done at {time.perf_counter() - t_start:.1f} s")
    by_path["residency"] = phase_residency(smi)
    log(f"residency done at {time.perf_counter() - t_start:.1f} s")
    k7, lowp_paths = phase_reduced_precision(dev, smi, golden, K_default, x_train)
    log(f"reduced precision done at {time.perf_counter() - t_start:.1f} s")
    ambient_ms, ambient_paths = phase_ambient_precision(dev, smi, golden, K_default, x_train)
    lowp_paths.update(ambient_paths)
    by_path.update(lowp_paths)
    log(f"ambient precision done at {time.perf_counter() - t_start:.1f} s")
    log(f"dense verdict (max_abs_err vs the dense statevector Gram): {json.dumps(DENSE_VERDICT)}")

    bounds = kernel_bounds(32, 64, 2)
    bounds["brick_split"] = brick_bound(BRICK_BN, 128, 128, 2)
    main_shape = {"split": "B32_chi64", "orth_r": "B32_chi64", "orth": "m128_k64",
                  "gate_split": "B32_chi64", "brick_split": f"Bn{BRICK_BN}_chi128"}
    kernels = []
    for name, source, replaces in KERNEL_TABLE:
        launches = sum(p[name] for p in by_path.values())
        assert launches > 0, f"kernel {name} never launched on any main path"
        pair_launches = sum(p[name] for p in pair_paths.values())
        assert pair_launches > 0, f"kernel {name}'s pair variant never launched on a path"
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "launches_by_path": {path: p[name] for path, p in by_path.items()},
            "pair_launches": pair_launches,
            "pair_ms": pair_ms[name][main_shape[name]]["pair_ms"],
            "pair_ms_by_shape": pair_ms[name], "pair_max_abs_err": pair_err[name],
            "max_abs_err": err[name], "ms": times[name][0], "plain_ms": times[name][1],
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "library_ms": times[name][2],
            **({"ms_by_stage": stage_ms[name]} if name in stage_ms else {}),
            **({"yardstick_ms": stage_ms[name]["chi128_Bn408"]["k1_same_theta_ms"]}
               if name == "brick_split" else {})})
    name, source, replaces = K7
    k7_build_s = _build.BUILD_INFO["seconds_by_library"].get("bf16_cgemm")
    launches = sum(p.get(name, 0) for p in by_path.values())
    assert launches > 0, "K7 never launched on a reduced-precision path"
    assert all(p.get(name, 0) == 0 for path, p in by_path.items() if path not in lowp_paths), (
        "K7 launched on a full-precision path")
    kernels.append({
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "launches_by_path": {path: p[name] for path, p in lowp_paths.items()},
        "max_abs_err": k7["max_abs_err"], "ms": k7["ms"], "plain_ms": k7["plain_ms"],
        "bound_ms": k7["bound_ms"], "bound_by": k7["bound_by"], "library_ms": k7["library_ms"],
        "plan": k7["plan"], "call_ms": k7["call_ms"], "library_call_ms": k7["library_call_ms"],
        "build_s": k7_build_s, "plans": k7["plans"], "ms_by_shape": k7["ms_by_shape"],
        "ms_by_engine_shape": ambient_ms})
    name, source, replaces = K8
    launches = sum(p.get(name, 0) for p in by_path.values())
    assert launches > 0, "K8 never launched on a main path"
    kernels.append({
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "launches_by_path": {path: p[name] for path, p in by_path.items() if p.get(name)},
        "build_s": _build.BUILD_INFO["seconds_by_library"].get("mgs2_panel"),
        "shape": f"[32,{K8_MAIN[0]},{K8_MAIN[1]}] {str(K8_MAIN[2])[6:]}", **k8})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
