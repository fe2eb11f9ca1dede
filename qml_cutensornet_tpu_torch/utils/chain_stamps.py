"""Where the time of kernels K1 to K5 goes, from phase stamps inside the
kernels.

    python3 -m qml_cutensornet_tpu_torch.utils.chain_stamps [KERNEL ...]   # needs one GPU

KERNEL is any of ``split``, ``orth_r``, ``orth``, ``gate_split``,
``brick_split`` (default: these five), ``mgs2_panel`` (K8) and
``mgs2_panel_parent`` (the parent commit's K8, unpacked into
``build/parent`` by ``git archive`` as for ``chip_smoke.py``: its source
gets the same phase stamps at the ends of its load, projections, column
ends and store before it is built; its rounds stamp themselves through
``block_chain.cuh``). Builds their sources
(``csrc/subspace_split.cu``, ``orth_r.cu``, ``orth.cu``, ``gate_split.cu``,
``brick_split.cu``) with ``-DQK_STAMPS`` into ``build/stamps/``
(gitignored; ``orth.cu`` also with ``-DQK_ORTH_CANDIDATES``, which adds the
in-panel groups measured against the chosen ones): thread 0 of block 0 then
records
``clock64()`` and a phase id after each block barrier that ends a phase
(``QK_STAMP`` in ``csrc/block_chain.cuh``). Each kernel is launched once to
warm up and once stamped, and the SM cycles of each phase are summed: the
load or the theta build, the theta products, the panels' norms, the CGS
coefficients and updates, the in-panel group rounds and column ends, the
epilogue (K5: its s2 and na0 products). Shapes, complex64, iters 2: K1, K2
and K4 at the main path's stages (B 32, chi 32 and 64); K1 and K5 at the
brick route's full width (408 pairs, chi 128, nc 128), where one block of
512 threads fills an SM, so that 408 elements run in 4 waves on 132 SMs;
K3 (B 32) at v [32, 128, 64] (the unfused route at chi 64) and on the
blocked route's panels of 32 columns at m 256 and 512, once for every
in-panel group (``ORTH_GROUPS``: warps, elements a lane; -1 the panel in
memory) that holds the length, with its rows in shared memory; K8 (B 32)
at the main path's panel [32, 512, 32] in complex128 and at [32, 512, 32]
in complex64, its phases the load, the rounds (each column's dots, warp
butterflies and barrier; in the redesign also the previous column's
second projection, which the first round's loop carries), the first
projections, the column ends and the store. The same launch's CUDA-event
time gives the cycle rate (over all waves). The last lines are the card's
name and power limit and a JSON object of the breakdowns.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import torch

from qml_cutensornet_tpu_torch.ops import _block, _build, orth, split
from qml_cutensornet_tpu_torch.ops.svd import start_block
from qml_cutensornet_tpu_torch.utils.device import nvidia_smi

STAMP_DIR = _build.BUILD_DIR.parent / "stamps"
PHASES = {1: "start", 2: "load", 3: "panel_norms", 4: "cgs_update", 5: "column_end",
          6: "product", 7: "orth_end", 8: "epilogue", 9: "cgs_coefficients", 10: "group_round",
          11: "theta_build", 12: "s2", 13: "na0", 14: "projection"}
SOURCES = {"split": "subspace_split", "orth_r": "orth_r", "orth": "orth",
           "gate_split": "gate_split", "brick_split": "brick_split",
           "mgs2_panel": "mgs2_panel", "mgs2_panel_parent": "mgs2_panel"}
DEFAULT = ("split", "orth_r", "orth", "gate_split", "brick_split")
PARENT_CSRC = _build.BUILD_DIR.parent / "parent" / "qml_cutensornet_tpu_torch" / "csrc"
# K8's shapes: (m, P, dtype), the main path's first.
MGS2_SHAPES = ((512, 32, torch.complex128), (512, 32, torch.complex64))
# Stamps for the parent's K8 (its source has none of its own but the
# rounds'): (anchor, the line to insert after it).
PARENT_MGS2_STAMPS = (
    ("  T* cw = coef[tid >> 5];\n", "  QK_STAMP(blk::ST_START);\n"),
    ("  __syncthreads();\n\n  int buf = 0;\n", "  QK_STAMP(blk::ST_LOAD);\n"),
    ("        x[e].im -= si[0] + si[1];\n      }\n", "      QK_STAMP(14);\n"),
    ("      x[e].im *= inv;\n    }\n", "    QK_STAMP(blk::ST_COLUMN);\n"),
    ("    qb[idx] = W[(size_t)j * ld + e];\n  }\n", "  QK_STAMP(blk::ST_END);\n"),
)


def _parent_mgs2_source() -> pathlib.Path:
    """The parent's K8 source with its phase stamps, beside its headers in
    ``build/stamps/parent_csrc``."""
    out = STAMP_DIR / "parent_csrc"
    out.mkdir(parents=True, exist_ok=True)
    for header in _build.HEADERS:
        shutil.copy(PARENT_CSRC / header, out / header)
    text = (PARENT_CSRC / "mgs2_panel.cu").read_text()
    for anchor, line in PARENT_MGS2_STAMPS:
        assert text.count(anchor) == 1, f"parent mgs2_panel.cu: anchor {anchor!r} not found once"
        text = text.replace(anchor, anchor + line)
    (out / "mgs2_panel.cu").write_text(text)
    return out / "mgs2_panel.cu"
# K3's in-panel groups (warps, elements a lane; _block.EPL_MEM: the panel in
# memory): the plan's and the candidates of -DQK_ORTH_CANDIDATES.
ORTH_GROUPS = ((4, 1), (4, 2), (4, 4), (8, 1), (8, 2), (16, 1), (16, 2), (16, _block.EPL_MEM))


def _libs(kernels):
    """Build each kernel's source with -DQK_STAMPS (one nvcc each, all at
    once) and load it with the C signatures of ``ops/_build.py``."""
    STAMP_DIR.mkdir(parents=True, exist_ok=True)
    src = {name: (_parent_mgs2_source() if name == "mgs2_panel_parent"
                  else _build.CSRC / f"{SOURCES[name]}.cu") for name in kernels}
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DQK_STAMPS",
         *(["-DQK_ORTH_CANDIDATES"] if name == "orth" else []), "-o",
         str(STAMP_DIR / f"lib{name}_stamps.so"), str(src[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name in kernels}
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src[name]}:\n{out}")
        if name in ("orth", "mgs2_panel", "mgs2_panel_parent"):  # registers and spills
            for line in out.splitlines():
                if any(w in line for w in ("_kernel", "Function properties", "registers",
                                           "spill")):
                    print(f"ptxas {name}: " + line.strip())
        lib = ctypes.CDLL(str(STAMP_DIR / f"lib{name}_stamps.so"))
        lib.qk_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.qk_read_stamps.restype = ctypes.c_int
        if name == "mgs2_panel_parent":  # the parent's C interface
            lib.qk_mgs2_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                                           + [ctypes.c_double, ctypes.c_int, ctypes.c_longlong,
                                              ctypes.c_void_p])
            lib.qk_mgs2_launch.restype = ctypes.c_int
        else:
            for fn, (argtypes, restype) in _build.SOURCES[f"{SOURCES[name]}.cu"].items():
                getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
        libs[name] = lib
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


def _mean_us(launch, n=20):
    """Mean time of one of ``n`` back-to-back launches, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / n


def _mgs2_stamps(name, lib, rng, dev, optin, stream):
    """K8's breakdowns at ``MGS2_SHAPES`` (B 32): the current kernel with
    its plan (``ops/blocked_qr.mgs2_plan``), or the parent's with its own
    (the rows ``[P][m + 1]`` in shared memory where they fit beside its
    16384 B of static slots in complex128, 8192 B in complex64, else in
    global scratch)."""
    from qml_cutensornet_tpu_torch.ops import blocked_qr

    out = {}
    for m, p, dtype in MGS2_SHAPES:
        B = 32
        a = torch.from_numpy(_crandn(rng, B, m, p)).to(dev, dtype)
        n2 = (a.real ** 2 + a.imag ** 2).sum(1).contiguous()
        q = torch.empty_like(a)
        dbl, tol = int(dtype == torch.complex128), orth.dep_tol2(dtype)
        cx = _block.cx_bytes(dtype)
        if name == "mgs2_panel":
            plan = blocked_qr.mgs2_plan(m, p, dtype, optin)
            scratch = torch.empty((B, max(plan.scratch_cx, 1)), dtype=dtype, device=dev)
            launch = lambda: lib.qk_mgs2_launch(
                a.data_ptr(), n2.data_ptr(), q.data_ptr(), scratch.data_ptr(), B, m, p, dbl, tol,
                plan.code, plan.epl, plan.reg_cols, plan.smem_bytes, stream)
            what = f"{plan.kind} epl {plan.epl} R {plan.reg_cols}"
        else:
            rows = p * (m + 1) * cx
            in_smem = rows + (2 * 16 * 32 + 16 * 2 * 32) * cx // 2 <= optin
            scratch = torch.empty((B, 1 if in_smem else p * (m + 1)), dtype=dtype, device=dev)
            launch = lambda: lib.qk_mgs2_launch(
                a.data_ptr(), n2.data_ptr(), q.data_ptr(), scratch.data_ptr(), B, m, p, dbl, tol,
                int(in_smem), rows if in_smem else 0, stream)
            what = "rows in shared memory" if in_smem else "rows in global scratch"
        res = _stamped(lib, launch)
        res["mean_us_20_launches"] = _mean_us(launch)
        res["plan"] = what
        out[f"{name}_m{m}_P{p}_{str(dtype)[6:]}"] = res
    return out


def _crandn(rng, *shape):
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return x / np.abs(x).max()


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("chain_stamps: needs a CUDA card", file=sys.stderr)
        return 2
    kernels = list(argv if argv is not None else sys.argv[1:]) or list(DEFAULT)
    unknown = set(kernels) - set(SOURCES)
    if unknown:
        print(f"chain_stamps: unknown kernels {sorted(unknown)}; known: {list(SOURCES)}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    optin = _build.smem_optin(dev.index)
    rng = np.random.default_rng(0)
    libs = _libs(kernels)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda = lambda x: torch.from_numpy(x.astype(np.complex64)).to(dev)
    empty = lambda *shape: torch.empty(shape, dtype=torch.complex64, device=dev)
    result = {}
    if "split" in kernels:
        lib = libs["split"]
        for B, chi, nc in ((32, 32, 32), (32, 64, 64), (408, 128, 128)):
            m = 2 * chi
            th = cuda(_crandn(rng, B, m, m))
            v0 = start_block(m, nc, th.dtype, dev)
            p = split.split_plan(B, m, m, nc, th.dtype, optin)
            q, r, scratch = empty(B, m, nc), empty(B, nc, m), empty(B, p.scratch_cx)
            result[f"split_chi{chi}" + (f"_B{B}" if B != 32 else "")] = _stamped(
                lib, lambda: lib.qk_split_launch(
                    th.data_ptr(), v0.data_ptr(), q.data_ptr(), r.data_ptr(),
                    scratch.data_ptr(), B, m, m, nc, 2, 0, int(p.rows_smem), p.smem_bytes,
                    stream, int(p.theta_smem), int(p.inplace)))
    if "orth_r" in kernels:
        lib = libs["orth_r"]
        for chi in (32, 64):
            B, m = 32, 2 * chi
            v = cuda(_crandn(rng, B, m, chi))
            po = orth.orth_r_plan(B, m, chi, v.dtype, optin)
            qo, ro, so = empty(B, m, chi), empty(B, chi, chi), empty(B, po.scratch_cx)
            result[f"orth_r_chi{chi}"] = _stamped(lib, lambda: lib.qk_orth_r_launch(
                v.data_ptr(), qo.data_ptr(), ro.data_ptr(), so.data_ptr(), B, m, chi, 0,
                int(po.rows_smem), po.smem_bytes, stream, int(po.v_smem)))
    if "orth" in kernels:
        lib = libs["orth"]
        for m, k in ((128, 64), (256, 32), (512, 32)):
            B = 32
            v = cuda(_crandn(rng, B, m, k))
            p = orth.orth_plan(B, m, k, v.dtype, optin)
            assert p.rows_smem, (m, k)
            qo = empty(B, m, k)
            for warps, epl in ORTH_GROUPS:
                if epl != _block.EPL_MEM and m > warps * 32 * epl:
                    continue
                chosen = "_plan" if (warps, epl) == (p.group_warps, p.group_epl) else ""
                launch = lambda: lib.qk_orth_launch(v.data_ptr(), qo.data_ptr(), 0, B, m, k, 0,
                                                    1, warps, epl, p.smem_bytes, stream)
                res = _stamped(lib, launch)
                res["mean_us_20_launches"] = _mean_us(launch)
                result[f"orth_m{m}_k{k}_g{warps}x{epl}{chosen}"] = res
    for name, shapes in (("gate_split", ((32, 32), (32, 64))), ("brick_split", ((408, 128),))):
        if name not in kernels:
            continue
        lib = libs[name]
        for B, chi in shapes:
            m = 2 * chi
            A, Bm = cuda(_crandn(rng, B, m, chi)), cuda(_crandn(rng, B, chi, m))
            g = cuda(np.linalg.qr(_crandn(rng, B, 4, 4))[0])
            v0 = start_block(m, chi, A.dtype, dev)
            plan_fn = split.gate_split_plan if name == "gate_split" else split.brick_split_plan
            p = plan_fn(B, chi, chi, A.dtype, optin)
            scratch = empty(B, p.scratch_cx)
            tot, resid = torch.empty(B, device=dev), torch.empty(B, device=dev)
            where = (int(p.theta_smem), int(p.rows_smem), int(p.inplace), p.smem_bytes, stream)
            if name == "gate_split":
                q, r = empty(B, m, chi), empty(B, chi, m)
                launch = lambda: lib.qk_gate_split_launch(
                    A.data_ptr(), Bm.data_ptr(), g.data_ptr(), v0.data_ptr(), q.data_ptr(),
                    r.data_ptr(), tot.data_ptr(), resid.data_ptr(), scratch.data_ptr(), B, chi,
                    chi, 2, 0, *where)
            else:
                lam = torch.from_numpy(rng.uniform(0.3, 1.0, (B, chi)).astype(np.float32)).to(dev)
                q2, na0, s2 = empty(B, chi, m), empty(B, chi, m), torch.empty((B, chi), device=dev)
                launch = lambda: lib.qk_brick_split_launch(
                    A.data_ptr(), Bm.data_ptr(), g.data_ptr(), lam.data_ptr(), v0.data_ptr(),
                    q2.data_ptr(), na0.data_ptr(), s2.data_ptr(), tot.data_ptr(),
                    resid.data_ptr(), scratch.data_ptr(), B, chi, chi, 2, 0, *where)
            result[f"{name}_chi{chi}" + (f"_B{B}" if B != 32 else "")] = _stamped(lib, launch)
    for name in ("mgs2_panel", "mgs2_panel_parent"):
        if name in kernels:
            result.update(_mgs2_stamps(name, libs[name], rng, dev, optin, stream))
    for name, res in result.items():
        parts = ", ".join(f"{k} {v['share']:.3f} ({v['count']} x {v['cycles_each']:.0f})"
                          for k, v in res.items() if isinstance(v, dict))
        mean = (f", {res['mean_us_20_launches']:.1f} us a launch over 20"
                if "mean_us_20_launches" in res else "")
        plan = f" [{res['plan']}]" if "plan" in res else ""
        print(f"{name}{plan}: {res['total_cycles']} cycles, {res['event_us']:.1f} us{mean}; "
              f"{parts}")
    print(nvidia_smi())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
