"""Build ``csrc/*.cu`` with ``nvcc`` and load it with ``ctypes``.

The kernels have a plain C interface (no PyTorch headers), so ``nvcc``
builds each source in seconds to a minute. Each source of K1 to K5 becomes
two shared libraries in ``build/kernels/`` next to the package
(``.gitignore`` lists ``build/``): the single-column one, and the pair
library, the same source with ``-DQK_PAIR`` (the block-2 in-panel step of
the reference's ``mgs_pair``, complex64 kernels only). K7
(``bf16_cgemm.cu``) and K8 (``mgs2_panel.cu``, the scanned panel step,
which ignores ``pair`` as the reference's does), :data:`SINGLE_BUILD`, are
built once; their entry points are in both namespaces :func:`load`
returns. One ``nvcc`` process per library, all twelve started together.
Each is named by a hash of the sources, headers and flags, so a fresh
checkout builds on first use and a rebuilt source never loads a stale
library.

Launch bookkeeping lives here too: ``LAUNCHES`` counts kernel launches per
kernel (incremented by each wrapper right after its launch succeeded),
``PAIR_LAUNCHES`` those of them made by a pair library, and
``PLAIN_ON_CUDA`` counts calls of a plain PyTorch version on CUDA tensors
(which only comparisons against the kernel should make).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
import types

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
HEADERS = ("bcgs2.cuh", "block_chain.cuh")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

PAIR_KERNELS = ("split", "orth_r", "orth", "gate_split", "brick_split")  # K1 to K5
KERNELS = PAIR_KERNELS + ("cgemm", "mgs2_panel")  # and K7, K8
LAUNCHES = dict.fromkeys(KERNELS, 0)
PAIR_LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_ON_CUDA = dict.fromkeys(KERNELS, 0)
# Filled by the first load(): {"seconds": build time (0 if cached),
# "path": the libraries' directory, "log": nvcc output,
# "seconds_by_library": {source stem, "_pair" for a pair library: seconds
# from the start until its nvcc ended} for the libraries built}.
BUILD_INFO: dict = {}

_LIBS: dict = {}  # pair (bool) -> the namespace of that library's entry points
PAIR_FLAG = "-DQK_PAIR"

_vp, _i, _ll, _d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
# source -> {C entry point: (argtypes, restype)}
SOURCES = {
    "orth_r.cu": {
        "qk_orth_r_smem": ([_i] * 5, _ll),
        "qk_orth_r_launch": ([_vp] * 4 + [_i] * 5 + [_ll, _vp, _i], _i),
        "qk_smem_optin": ([_i], _ll),
        "qk_error_string": ([_i], ctypes.c_char_p),
    },
    "subspace_split.cu": {
        "qk_split_smem": ([_i] * 7, _ll),
        "qk_split_launch": ([_vp] * 5 + [_i] * 7 + [_ll, _vp, _i, _i], _i),
    },
    "orth.cu": {
        "qk_orth_smem": ([_i] * 4, _ll),
        "qk_orth_launch": ([_vp] * 3 + [_i] * 7 + [_ll, _vp], _i),
    },
    "gate_split.cu": {
        "qk_gate_split_smem": ([_i] * 6, _ll),
        "qk_gate_split_launch": ([_vp] * 9 + [_i] * 8 + [_ll, _vp], _i),
    },
    "brick_split.cu": {
        "qk_brick_split_smem": ([_i] * 6, _ll),
        "qk_brick_split_launch": ([_vp] * 11 + [_i] * 8 + [_ll, _vp], _i),
    },
    "bf16_cgemm.cu": {
        "qk_cgemm_plan": ([_ll, _i, _i, _i], _i),
        "qk_cgemm_launch": ([_vp] * 3 + [_ll] * 2 + [_i] * 3 + [_ll] * 6 + [_i] * 3 + [_vp], _i),
        "qk_cgemm_attrs": ([_i] * 4 + [_vp], _i),
    },
    "mgs2_panel.cu": {
        "qk_mgs2_smem": ([_i] * 4, _ll),
        "qk_mgs2_reg_cols": ([_i] * 2, _i),
        "qk_mgs2_launch": ([_vp] * 4 + [_i] * 4 + [_d] + [_i] * 3 + [_ll, _vp], _i),
    },
}
# Sources built once, without a pair library.
SINGLE_BUILD = ("bf16_cgemm.cu", "mgs2_panel.cu")


def reset_counters() -> None:
    for d in (LAUNCHES, PAIR_LAUNCHES, PLAIN_ON_CUDA):
        for key in d:
            d[key] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); cannot build the CUDA kernels")


def count_launch(name: str, pair: bool) -> None:
    """Count one launch of kernel ``name`` (``pair``: by the pair library)."""
    LAUNCHES[name] += 1
    if pair:
        PAIR_LAUNCHES[name] += 1


def _flags(pair: bool) -> tuple:
    return (*NVCC_FLAGS, PAIR_FLAG) if pair else NVCC_FLAGS


def _source_key(source: str, pair: bool) -> str:
    h = hashlib.sha256(" ".join(_flags(pair)).encode())
    for name in (source, *HEADERS):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def load(pair: bool = False):
    """The kernels' C entry points (attributes of the returned namespace) in
    the single-column libraries, or with ``pair`` in the pair libraries
    (both with the entry points of :data:`SINGLE_BUILD`). Every library is
    built on first use: each that is not there yet is compiled by its own
    ``nvcc`` process, all of them running at once."""
    if _LIBS:
        return _LIBS[pair]
    t0 = time.perf_counter()
    paths = {(src, p): BUILD_DIR / (f"libqk_{pathlib.Path(src).stem}{'_pair' if p else ''}_"
                                    f"{_source_key(src, p)}.so")
             for p in (False, True) for src in SOURCES if not (p and src in SINGLE_BUILD)}
    procs = []
    for (src, p), so in paths.items():
        if so.is_file():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(p), "-o", str(tmp), str(CSRC / src)]
        out = open(so.with_suffix(f".{os.getpid()}.log"), "w+")  # closed once nvcc ends
        procs.append((f"{pathlib.Path(src).stem}{'_pair' if p else ''}", cmd, tmp, so, out,
                      subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, text=True)))
    seconds, pending = {}, list(procs)
    while pending:  # wait for every process before raising; note when each ends
        for item in [item for item in pending if item[-1].poll() is not None]:
            seconds[item[0]] = time.perf_counter() - t0
            pending.remove(item)
        time.sleep(0.05 if pending else 0)
    log, failed = "", []
    for _, cmd, tmp, so, out, proc in procs:
        out.seek(0)
        text = out.read()
        out.close()
        os.remove(out.name)
        log += text
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    libs = {False: types.SimpleNamespace(), True: types.SimpleNamespace()}
    for (src, p), so in paths.items():
        cdll = ctypes.CDLL(str(so))  # RTLD_LOCAL: the two libraries' symbols stay apart
        for name, (argtypes, restype) in SOURCES[src].items():
            fn = getattr(cdll, name)
            fn.argtypes = argtypes
            fn.restype = restype
            for ns in ((False, True) if src in SINGLE_BUILD else (p,)):
                setattr(libs[ns], name, fn)
        if src in SINGLE_BUILD:
            continue
        cdll.qk_pair_step.restype = _i
        if cdll.qk_pair_step() != int(p):
            raise RuntimeError(f"{so.name}: built {'without' if p else 'with'} {PAIR_FLAG}")
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(BUILD_DIR), log=log,
                      seconds_by_library=seconds)
    _LIBS.update(libs)
    return libs[pair]


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = load().qk_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


@functools.lru_cache(maxsize=None)
def smem_optin(device_index: int) -> int:
    """Dynamic shared memory a block may opt in to on this device (bytes)."""
    v = load().qk_smem_optin(device_index)
    if v < 0:
        check(int(-v), "cudaDeviceGetAttribute")
    return int(v)
