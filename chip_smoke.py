"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py    # needs one CUDA card

Phases (any failure raises and exits non-zero; nothing is caught):

1. device: torch sees a card; print ``nvidia-smi`` name and power limit.
2. build: compile ``qml_cutensornet_tpu_torch/csrc`` with nvcc (timed),
   print the ptxas resource lines, and check that a launch asking for more
   dynamic shared memory than the card allows raises (negative control).
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (chi 8..64, batch 32 and 100, 1 and 2 power
   iterations; full-rank, rank-deficient, zero-padded and graded inputs),
   on basis-invariant quantities, each against its stated tolerance; then
   kernel and plain times at the main-path shape with CUDA events.
4. main path: the port's ``cli.main_no_test`` at the repo's headline shape
   (32 qubits, r=2, d=6, chi 64, f32, 102 train points of the pinned v1
   data); the launch counters must show both kernels ran and no plain
   version ran on a CUDA tensor; K must be symmetric with unit diagonal and
   its leading 8x8 block within 1e-6 of the f64 golden.

The last two lines of stdout are the kernels summary JSON and the result
JSON ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

ARGV = ["main_no_test", "GPU", "32", "2", "1.0", "6", "64", "64", "5",
        "elliptic_preproc_bench.csv"]
GOLDEN = ROOT / "runs/golden/bench_nq32_r2_d6_g1.0_N8.npz"
RAW_V1 = ROOT / "datasets/elliptic_bitcoin_dataset_v1"
WORK = ROOT / "build" / "smoke"

# Tolerances, f32 kernel vs plain version on the same card. The two run the
# same algorithm with different summation orders, so they differ by f32
# rounding amplified by the conditioning of the inputs (graded spectra span
# two decades here).
TOL_PROJ = 2e-5  # projectors QQ^H; the reference's fused-vs-unfused bar on q/r
TOL_PROD = 2e-5  # products QR (relative to max |input|); same bar
TOL_ORTH = 5e-6  # |Q^H Q - I| on non-zero columns; the reference kernel tests' bar
TOL_S2 = 2e-5  # sorted squared singular values, relative to the largest
TOL_GOLDEN = 1e-6  # leading 8x8 Gram block vs the f64 golden (ROADMAP bar)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


# -------------------------------------------------------------- comparisons

def compare(qk, rk, qp, rp, x, what, with_s2):
    """Basis-invariant comparison of kernel (qk, rk) and plain (qp, rp)
    factorizations of x; asserts the tolerances and returns the larger of
    the projector and product errors. ``with_s2`` also compares the sorted
    squared row norms of r (the split's singular-value estimates)."""
    proj = (qk @ qk.mH - qp @ qp.mH).abs().max().item()
    scale = x.abs().max().item()
    prod = ((qk @ rk - qp @ rp).abs().max().item()) / scale
    nzk = qk.abs().pow(2).sum(1) > 0.25
    nzp = qp.abs().pow(2).sum(1) > 0.25
    assert torch.equal(nzk, nzp), f"{what}: kernel and plain keep different columns"
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
    log(f"  {what}: proj {proj:.2e} prod {prod:.2e} orth {orth:.2e} s2 {s2:.2e} "
        f"kept {int(nzk.sum(1).min())}..{int(nzk.sum(1).max())}")
    assert proj <= TOL_PROJ, f"{what}: projector error {proj} > {TOL_PROJ}"
    assert prod <= TOL_PROD, f"{what}: product error {prod} > {TOL_PROD}"
    assert orth <= TOL_ORTH, f"{what}: orthonormality error {orth} > {TOL_ORTH}"
    assert s2 <= TOL_S2, f"{what}: sorted s2 error {s2} > {TOL_S2}"
    return max(proj, prod)


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


def phase_kernels(dev):
    from qml_cutensornet_tpu_torch.ops import orth, split
    from qml_cutensornet_tpu_torch.ops.svd import start_block

    rng = np.random.default_rng(20261016)
    err = {"orth_r": 0.0, "split": 0.0}
    for B in (32, 100):
        for chi in (8, 16, 32, 64):
            m = 2 * chi
            for kind in ("full", "rankdef", "padded", "graded"):
                v = torch.from_numpy(make_input(rng, kind, B, m, chi, chi)).to(dev)
                qk, rk = orth.orth_r_cuda(v)
                qp, rp = orth.orth_r_plain(v)
                torch.cuda.synchronize()
                err["orth_r"] = max(err["orth_r"], compare(
                    qk, rk, qp, rp, v, f"orth_r B={B} chi={chi} {kind}", False))
                th = torch.from_numpy(make_input(rng, kind, B, m, m, chi)).to(dev)
                v0 = start_block(m, chi, th.dtype, dev)
                for iters in (1, 2):
                    qk, rk = split.subspace_factor_cuda(th, v0, iters)
                    qp, rp = split.subspace_factor_plain(th, v0, iters)
                    torch.cuda.synchronize()
                    err["split"] = max(err["split"], compare(
                        qk, rk, qp, rp, th, f"split B={B} chi={chi} iters={iters} {kind}", True))

    # Times at the main path's shape: chi 64, one sim batch of 32, iters 2.
    B, chi = 32, 64
    v = torch.from_numpy(make_input(rng, "full", B, 2 * chi, chi, chi)).to(dev)
    th = torch.from_numpy(make_input(rng, "full", B, 2 * chi, 2 * chi, chi)).to(dev)
    v0 = start_block(2 * chi, chi, th.dtype, dev)
    times = {}
    for name, kern, plain in (
        ("orth_r", lambda: orth.orth_r_cuda(v), lambda: orth.orth_r_plain(v)),
        ("split", lambda: split.subspace_factor_cuda(th, v0, 2),
         lambda: split.subspace_factor_plain(th, v0, 2)),
    ):
        p1 = time_ms(plain, 3)
        k1 = time_ms(kern, 20)
        k2 = time_ms(kern, 20)
        p2 = time_ms(plain, 3)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"  time {name} B={B} chi={chi}: kernel {k1:.4f} / {k2:.4f} ms, "
            f"plain {p1:.4f} / {p2:.4f} ms")
    return err, times


def phase_build(dev):
    from qml_cutensornet_tpu_torch.ops import _build, orth

    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.2f} s -> {_build.BUILD_INFO['path']}")
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
    return build_s


def phase_main_path(dev, smi):
    from qml_cutensornet_tpu_torch.cli import main_no_test
    from qml_cutensornet_tpu_torch.ops import _build
    from qml_cutensornet_tpu_torch.utils.data import load_and_prepare, preprocess_elliptic
    from qml_cutensornet_tpu_torch.utils.naming import run_info

    (WORK / "datasets").mkdir(parents=True, exist_ok=True)
    csv = WORK / "datasets" / ARGV[-1]
    preprocess_elliptic(dataset_dir=str(RAW_V1), out_csv=str(csv))
    golden = np.load(GOLDEN)
    x_train = load_and_prepare(str(csv), 32, 64, 64, 5)[0]
    x_err = float(np.abs(x_train[:8] - golden["x"]).max())
    assert x_err <= 1e-12, f"first 8 train rows differ from the golden x by {x_err}"

    os.chdir(WORK)
    os.environ["QMLTPU_DEVICE"] = "cuda"
    _build.reset_counters()
    t0 = time.perf_counter()
    K = main_no_test.main(list(ARGV))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    plain_on_cuda = dict(_build.PLAIN_ON_CUDA)
    log(f"main path launches {launches}, plain versions on CUDA tensors {plain_on_cuda}")
    for name, count in launches.items():
        assert count > 0, f"kernel {name} never launched on the main path"
    assert sum(plain_on_cuda.values()) == 0, "a plain version ran on a CUDA tensor"

    assert K.shape == (102, 102) and np.isfinite(K).all(), K.shape
    # Off-diagonal tiles are mirrored exactly; inside a diagonal tile K[i,j]
    # and K[j,i] come from different f32 contraction orders.
    sym_err = float(np.abs(K - K.T).max())
    assert sym_err <= 1e-6, f"K is not symmetric: {sym_err}"
    diag_err = float(np.abs(np.diag(K) - 1.0).max())
    assert diag_err <= 1e-12, f"diagonal of K off by {diag_err}"
    gold_err = float(np.abs(K[:8, :8] - golden["k"]).max())
    info = run_info("train", 32, 2, 1.0, 6, 64, 5, ARGV[-1])
    prof = json.loads((WORK / f"{info}.json").read_text())
    log(f"main path [{smi}]: max_abs_err vs f64 golden {gold_err:.3e} "
        f"(tol {TOL_GOLDEN}), avg_fidelity {prof['avg_fidelity'][0]:.8f}, "
        f"avg_max_chi {prof['ave max chi x'][0]:.2f}, sim {prof['r0_circ_sim'][0]:.3f} s, "
        f"tiles {prof['kernel_mat_time'][0]:.3f} s, build_kernel_matrix "
        f"{prof['total_time'][0]:.3f} s, main() {wall:.3f} s")
    assert gold_err <= TOL_GOLDEN, f"8x8 block off the golden by {gold_err}"
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a CUDA card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | python {sys.version.split()[0]}")
    phase_build(dev)
    err, times = phase_kernels(dev)
    launches = phase_main_path(dev, smi)
    summary = {"kernels": [
        {"name": "split", "route": "cuda",
         "source": "qml_cutensornet_tpu_torch/csrc/subspace_split.cu",
         "replaces": "qml_cutensornet_tpu/ops/pallas_split.py:145",
         "launches": launches["split"], "max_abs_err": err["split"],
         "ms": times["split"][0], "plain_ms": times["split"][1]},
        {"name": "orth_r", "route": "cuda",
         "source": "qml_cutensornet_tpu_torch/csrc/orth_r.cu",
         "replaces": "qml_cutensornet_tpu/ops/pallas_qr.py:241",
         "launches": launches["orth_r"], "max_abs_err": err["orth_r"],
         "ms": times["orth_r"][0], "plain_ms": times["orth_r"][1]},
    ]}
    print(smi)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
