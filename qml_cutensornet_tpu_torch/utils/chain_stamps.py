"""Where the time of kernels K1 and K2 goes, from phase stamps inside the
kernels.

    python3 -m qml_cutensornet_tpu_torch.utils.chain_stamps   # needs one GPU

Builds ``csrc/subspace_split.cu`` and ``csrc/orth_r.cu`` with
``-DQK_STAMPS`` into ``build/stamps/`` (gitignored): thread 0 of block 0
then records ``clock64()`` and a phase id after each block barrier that
ends a phase (``QK_STAMP`` in ``csrc/block_chain.cuh``). Each kernel is
launched once to warm up and once stamped, at the main path's stage shapes
(B 32, chi 32 and 64, complex64; K1 with iters 2), and the SM cycles of each
phase are summed: the load, the theta products, the panels' norms, the CGS
coefficients and updates, the in-panel group rounds and column ends, the
epilogue. The same
launch's CUDA-event time gives the cycle rate. The last lines are the card's
name and power limit and a JSON object of the breakdowns.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from qml_cutensornet_tpu_torch.ops import _build, orth, split
from qml_cutensornet_tpu_torch.ops.svd import start_block
from qml_cutensornet_tpu_torch.utils.device import nvidia_smi

STAMP_DIR = _build.BUILD_DIR.parent / "stamps"
PHASES = {1: "start", 2: "load", 3: "panel_norms", 4: "cgs_update", 5: "column_end",
          6: "product", 7: "orth_end", 8: "epilogue", 9: "cgs_coefficients", 10: "group_round"}


def _libs(srcs):
    """Build each source with -DQK_STAMPS (one nvcc each, all at once) and
    load it."""
    STAMP_DIR.mkdir(parents=True, exist_ok=True)
    procs = {src: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DQK_STAMPS", "-o",
         str(STAMP_DIR / f"lib{src}_stamps.so"), str(_build.CSRC / f"{src}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for src in srcs}
    libs = []
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for src, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}.cu:\n{out}")
        lib = ctypes.CDLL(str(STAMP_DIR / f"lib{src}_stamps.so"))
        lib.qk_read_stamps.argtypes, lib.qk_read_stamps.restype = [vp, vp, i], i
        if src == "subspace_split":
            lib.qk_split_launch.argtypes = [vp] * 5 + [i] * 7 + [ll, vp, i, i]
            lib.qk_split_launch.restype = i
        else:
            lib.qk_orth_r_launch.argtypes = [vp] * 4 + [i] * 5 + [ll, vp, i]
            lib.qk_orth_r_launch.restype = i
        libs.append(lib)
    return libs


def _stamped(lib, launch):
    """Warm up, drop the stamps, then one stamped launch timed by CUDA
    events: ``(breakdown dict, microseconds)``."""
    t = np.zeros(8192, np.int64)
    ids = np.zeros(8192, np.int32)
    assert launch() == 0
    torch.cuda.synchronize()
    lib.qk_read_stamps(t.ctypes.data, ids.ctypes.data, 8192)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    rc = launch()
    end.record()
    assert rc == 0, f"launch failed: CUDA error {rc}"
    torch.cuda.synchronize()
    us = start.elapsed_time(end) * 1e3
    n = lib.qk_read_stamps(t.ctypes.data, ids.ctypes.data, 8192)
    assert n > 1, f"no stamps read ({n})"
    cycles: dict = {}
    counts: dict = {}
    for a in range(1, n):
        name = PHASES[int(ids[a])]
        cycles[name] = cycles.get(name, 0) + int(t[a] - t[a - 1])
        counts[name] = counts.get(name, 0) + 1
    total = int(t[n - 1] - t[0])
    out = {"total_cycles": total, "event_us": us, "cycles_per_us": total / us}
    for name, c in cycles.items():
        out[name] = {"cycles": c, "count": counts[name], "share": c / total,
                     "cycles_each": c / counts[name]}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chain_stamps: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    optin = _build.smem_optin(dev.index)
    rng = np.random.default_rng(0)
    ks, kr = _libs(("subspace_split", "orth_r"))
    stream = torch.cuda.current_stream(dev).cuda_stream
    result = {}
    for chi in (32, 64):
        B, m = 32, 2 * chi
        th = torch.from_numpy((rng.standard_normal((B, m, m)) + 1j * rng.standard_normal(
            (B, m, m))).astype(np.complex64)).to(dev)
        v0 = start_block(m, chi, th.dtype, dev)
        p = split.split_plan(B, m, m, chi, th.dtype, optin)
        q = torch.empty((B, m, chi), dtype=th.dtype, device=dev)
        r = torch.empty((B, chi, m), dtype=th.dtype, device=dev)
        scratch = torch.empty((B, p.scratch_cx), dtype=th.dtype, device=dev)
        result[f"split_chi{chi}"] = _stamped(ks, lambda: ks.qk_split_launch(
            th.data_ptr(), v0.data_ptr(), q.data_ptr(), r.data_ptr(), scratch.data_ptr(), B, m, m,
            chi, 2, 0, int(p.rows_smem), p.smem_bytes, stream, int(p.theta_smem),
            int(p.inplace)))
        v = th[:, :, :chi].contiguous()
        po = orth.orth_r_plan(B, m, chi, v.dtype, optin)
        qo = torch.empty_like(v)
        ro = torch.empty((B, chi, chi), dtype=v.dtype, device=dev)
        so = torch.empty((B, po.scratch_cx), dtype=v.dtype, device=dev)
        result[f"orth_r_chi{chi}"] = _stamped(kr, lambda: kr.qk_orth_r_launch(
            v.data_ptr(), qo.data_ptr(), ro.data_ptr(), so.data_ptr(), B, m, chi, 0,
            int(po.rows_smem), po.smem_bytes, stream, int(po.v_smem)))
    for name, res in result.items():
        parts = ", ".join(f"{k} {v['share']:.3f} ({v['count']} x {v['cycles_each']:.0f})"
                          for k, v in res.items() if isinstance(v, dict))
        print(f"{name}: {res['total_cycles']} cycles, {res['event_us']:.1f} us; {parts}")
    print(nvidia_smi())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
