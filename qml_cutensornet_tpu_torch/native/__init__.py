"""ctypes binding of the native C++ CPU MPS engine (port of
``qml_cutensornet_tpu/native/__init__.py``; ``qk_native.cpp`` is a byte copy
of the reference's source).

The library is built at first use (:func:`load`), never at import, with the
system toolchain: ``g++ -O3 -fPIC -shared -fopenmp`` against the system
LAPACK and BLAS (``liblapack.so.3``, ``libblas.so.3``). It goes to
``build/native/`` beside the package (``QMLTPU_NATIVE_CACHE`` names another
directory), named by the source's hash; a failed build raises with the
compiler's stderr. This engine is the CPU backend (``backends/cpu_native``)
and has no device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

# Op codes shared with qk_native.cpp.
OPCODES = {"H": 0, "Rx": 1, "Rz": 2, "XXPhase": 3, "ZZPhase": 4, "SWAP": 5}

_SRC = pathlib.Path(__file__).with_name("qk_native.cpp")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
_LIB = None


def _build_lib() -> pathlib.Path:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out_dir = pathlib.Path(os.environ.get("QMLTPU_NATIVE_CACHE", str(BUILD_DIR)))
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libqk_{tag}.so"
    if not so.exists():
        # Built under a temporary name and renamed: processes that build at
        # once never load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = ["g++", "-O3", "-fPIC", "-shared", "-fopenmp", str(_SRC), "-o", tmp,
               "-l:liblapack.so.3", "-l:libblas.so.3"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building the native engine failed ({' '.join(cmd)}):\n"
                                   f"{proc.stderr}")
            os.replace(tmp, so)
        finally:
            pathlib.Path(tmp).unlink(missing_ok=True)
    return so


def load():
    """Load the native library, building it first if needed; returns the
    ``ctypes.CDLL`` with every entry point's argument and result types."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(_build_lib()))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.qk_version.restype = ctypes.c_int
    lib.qk_version.argtypes = []
    lib.qk_simulate_stats.restype = ctypes.c_int
    lib.qk_simulate_stats.argtypes = [
        ctypes.c_int, ctypes.c_int, i64p, i32p, i32p, i32p, f64p,
        ctypes.c_double, ctypes.c_int, f64p, i32p,
    ]
    lib.qk_compute_tile.restype = ctypes.c_int
    lib.qk_compute_tile.argtypes = [
        ctypes.c_int,
        ctypes.c_int, i64p, i32p, i32p, i32p, f64p,
        ctypes.c_int, i64p, i32p, i32p, i32p, f64p,
        ctypes.c_double, ctypes.c_int,
        f64p, f64p, i32p, f64p, i32p, f64p,
    ]
    _LIB = lib
    return lib


def pack_circuits(circuits):
    """Serialize gate lists in the reference CPU backend's tuple format
    ``[(name, qubits, params), ...]`` (``KernelStateAnsatz.circuit_for_data``)
    into flat buffers ``(offsets, ops, q0, q1, alpha)``; an unknown gate
    raises ``ValueError``."""
    offsets = np.zeros(len(circuits) + 1, dtype=np.int64)
    ops, q0, q1, alpha = [], [], [], []
    for i, circ in enumerate(circuits):
        for (name, qubits, params) in circ:
            if name not in OPCODES:
                raise ValueError(f"Unrecognised gate: {name}")
            ops.append(OPCODES[name])
            q0.append(qubits[0])
            q1.append(qubits[1] if len(qubits) > 1 else -1)
            alpha.append(params[0] if params else 0.0)
        offsets[i + 1] = len(ops)
    return (
        offsets,
        np.asarray(ops, dtype=np.int32),
        np.asarray(q0, dtype=np.int32),
        np.asarray(q1, dtype=np.int32),
        np.asarray(alpha, dtype=np.float64),
    )


def compute_tile(nq, x_circuits, y_circuits=None, cutoff=1e-16, chi_cap=0):
    """``tile[i, j] = |<y_i|x_j>|^2`` of the simulated circuits (``y_circuits``
    None: the x circuits against themselves). Returns ``(tile [n_y, n_x],
    x_chi, y_chi, x_fid, y_fid, timings)``, ``timings`` the engine's
    simulation and overlap seconds."""
    lib = load()
    xb = pack_circuits(x_circuits)
    same = y_circuits is None
    yb = xb if same else pack_circuits(y_circuits)
    n_x = len(x_circuits)
    n_y = n_x if same else len(y_circuits)

    tile = np.zeros((n_y, n_x), dtype=np.float64)
    x_fid = np.zeros(n_x)
    y_fid = np.zeros(n_y)
    x_chi = np.zeros(n_x, dtype=np.int32)
    y_chi = np.zeros(n_y, dtype=np.int32)
    timings = np.zeros(2)
    rc = lib.qk_compute_tile(
        nq,
        n_x, xb[0], xb[1], xb[2], xb[3], xb[4],
        n_y, yb[0], yb[1], yb[2], yb[3], yb[4],
        float(cutoff), int(chi_cap),
        tile, x_fid, x_chi, y_fid, y_chi, timings,
    )
    if rc != 0:
        raise RuntimeError(f"qk_compute_tile failed with code {rc}")
    return tile, x_chi, y_chi, x_fid, y_fid, timings
