"""Build ``csrc/*.cu`` with ``nvcc`` and load it with ``ctypes``.

The kernels have a plain C interface (no PyTorch headers), so one ``nvcc``
call builds them in seconds. The shared library goes into
``build/kernels/`` next to the package (``.gitignore`` lists ``build/``),
named by a hash of the sources and flags, so a fresh checkout builds on
first use and a rebuilt source never loads a stale library.

Launch bookkeeping lives here too: ``LAUNCHES`` counts kernel launches per
kernel (incremented by each wrapper right after its launch succeeded), and
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

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("orth_r.cu", "subspace_split.cu")
HEADERS = ("bcgs2.cuh",)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"split": 0, "orth_r": 0}
PLAIN_ON_CUDA = {"split": 0, "orth_r": 0}
# Filled by the first load(): {"seconds": build time (0 if cached),
# "path": library path, "log": nvcc output}.
BUILD_INFO: dict = {}

_LIB = None

_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "qk_orth_r_smem": ([_i, _i, _i, _i], _ll),
    "qk_orth_r_launch": ([_vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _ll, _vp], _i),
    "qk_split_smem": ([_i, _i, _i, _i, _i], _ll),
    "qk_split_launch": ([_vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _ll, _vp], _i),
    "qk_smem_optin": ([_i], _ll),
    "qk_error_string": ([_i], ctypes.c_char_p),
}


def reset_counters() -> None:
    for d in (LAUNCHES, PLAIN_ON_CUDA):
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


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def load():
    """The kernels' shared library, built on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so = BUILD_DIR / f"libqk_{_source_key()}.so"
    t0 = time.perf_counter()
    log = ""
    if not so.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)] + [str(CSRC / s) for s in SOURCES]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(so), log=log)
    _LIB = lib
    return lib


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
