"""How the svd and eigh methods' library decompositions behave on the card
(the measurements behind the choices in ``ops/svd._left_vectors``):

    python3 -m qml_cutensornet_tpu_torch.utils.linalg_probe

At the headline shape (32 qubits, r=2, d=6, chi 64, f32) on the golden's 8
points of the pinned v1 data, one sim batch of 8:

- the svd route with torch's default cuSOLVER driver (Jacobi, "gesvdj",
  redone by "gesvd" for the matrices where it does not converge) and with
  "gesvd" (QR iteration, the port's choice): seconds and the 8x8 Gram's
  error against the f64 golden;
- the eigh route decomposing theta theta^H itself and in the rotated basis
  (the port's choice): whether the eigensolver converges on every update,
  and the golden error where it does.

Prints the card's name and power limit first. Needs a card (exits 2
without one) and the repo's datasets.
"""

from __future__ import annotations

import pathlib
import sys
import time

import numpy as np
import torch

from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix
from qml_cutensornet_tpu_torch.ops import svd
from qml_cutensornet_tpu_torch.utils.device import nvidia_smi

ROOT = pathlib.Path(__file__).resolve().parents[2]
GOLDEN = ROOT / "runs/golden/bench_nq32_r2_d6_g1.0_N8.npz"


def _run(ansatz, x, golden, method):
    cfg = SimConfig(chi=64, svd_method=method, fused_split=True, tile_block=2)
    t0 = time.perf_counter()
    K = build_kernel_matrix(ansatz, x, cfg=cfg, sim_batch=8, tile=8, device="cuda")
    torch.cuda.synchronize()
    return float(np.abs(K - golden["k"]).max()), time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("linalg_probe: needs a CUDA card", file=sys.stderr)
        return 2
    print(f"card: {nvidia_smi()}", flush=True)
    golden = np.load(GOLDEN)
    ansatz = KernelStateAnsatz(32, 2, 1.0, entanglement_graph(32, 6))
    x = golden["x"]
    _run(ansatz, x[:1], golden, "subspace")  # builds the kernels (K2 moves the centers)
    real_svd, real_rotation = torch.linalg.svd, svd._rotation
    try:
        for driver in (None, "gesvd"):
            torch.linalg.svd = lambda a, full_matrices=True, driver=None, _d=driver: real_svd(
                a, full_matrices=full_matrices, driver=_d)
            err, wall = _run(ansatz, x, golden, "svd")
            print(f"svd route, driver {driver or 'default'}, 8 circuits: golden err {err:.3e}, "
                  f"build_kernel_matrix {wall:.3f} s", flush=True)
        torch.linalg.svd = real_svd
        for label, rotation in (("theta theta^H itself", None), ("rotated basis", real_rotation)):
            svd._rotation = rotation or (lambda m, dtype, device: torch.eye(
                m, dtype=dtype, device=device))
            try:
                err, wall = _run(ansatz, x, golden, "eigh")
                print(f"eigh route, {label}, 8 circuits: golden err {err:.3e}, "
                      f"build_kernel_matrix {wall:.3f} s", flush=True)
            except torch.linalg.LinAlgError as exc:
                print(f"eigh route, {label}: the eigensolver failed: {exc}", flush=True)
    finally:
        torch.linalg.svd, svd._rotation = real_svd, real_rotation
    return 0


if __name__ == "__main__":
    sys.exit(main())
