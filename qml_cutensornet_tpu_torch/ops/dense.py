"""Dense statevector reference simulator (numpy, complex128; the port's copy
of ``qml_cutensornet_tpu/ops/dense.py``, unchanged in behaviour and pinned to
the original by ``tests/test_torch_dense.py``).

Golden model for tests and for the card's checks of the MPS Grams. This is
an INDEPENDENT implementation path from the MPS engine: it applies gates on
arbitrary (non-adjacent) qubit pairs directly to the full 2**n statevector,
with no routing, no scheduling and no truncation. Gate conventions follow
the TKET half-turn definitions that the reference's Julia backend spells out
explicitly (KernelPkg/src/KernelPkg.jl:8-42).
"""

from __future__ import annotations

import numpy as np


def rx(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -1j * s], [-1j * s, c]], dtype=np.complex128)


def rz(theta):
    return np.diag([np.exp(-1j * theta), np.exp(1j * theta)]).astype(np.complex128)


def xxphase(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array(
        [
            [c, 0, 0, -1j * s],
            [0, c, -1j * s, 0],
            [0, -1j * s, c, 0],
            [-1j * s, 0, 0, c],
        ],
        dtype=np.complex128,
    )


def zzphase(theta):
    em, ep = np.exp(-1j * theta), np.exp(1j * theta)
    return np.diag([em, ep, ep, em]).astype(np.complex128)


HADAMARD = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2)

SWAP = np.array(
    [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.complex128
)


def zero_state(n: int) -> np.ndarray:
    v = np.zeros(2**n, dtype=np.complex128)
    v[0] = 1.0
    return v


def apply_gate(state: np.ndarray, u: np.ndarray, qubits: list[int], n: int) -> np.ndarray:
    """Apply a k-qubit gate ``u [2^k, 2^k]`` on the given qubits (qubit 0 is
    the most significant axis, matching the MPS site ordering)."""
    k = len(qubits)
    t = state.reshape([2] * n)
    t = np.moveaxis(t, qubits, range(k))
    shp = t.shape
    t = u.reshape([2] * (2 * k)).reshape(2**k, 2**k) @ t.reshape(2**k, -1)
    t = t.reshape(shp)
    t = np.moveaxis(t, range(k), qubits)
    return t.reshape(-1)


def ansatz_state(features, reps, gamma, entanglement_map, hadamard_init=True):
    """|psi(x)> for the reference ansatz, straight from its mathematical
    definition (gpu_backend/kernel_state_ansatz.py:53-66), with TRUE angles:
    Rz angle gamma*x_i (pytket exponent (2/pi)*gamma*x_i) and XXPhase angle
    (pi/2)*gamma^2*(1-x_i)*(1-x_j) (pytket exponent gamma^2*(1-x_i)*(1-x_j)).
    No routing — gates act on their original qubit pairs.
    """
    x = np.asarray(features, dtype=np.float64)
    n = len(x)
    v = zero_state(n)
    if hadamard_init:
        for q in range(n):
            v = apply_gate(v, HADAMARD, [q], n)
    for _ in range(reps):
        for q in range(n):
            v = apply_gate(v, rz(gamma * x[q]), [q], n)
        for (q0, q1) in entanglement_map:
            theta = 0.5 * np.pi * gamma * gamma * (1 - x[q0]) * (1 - x[q1])
            v = apply_gate(v, xxphase(theta), [q0, q1], n)
    return v


def kernel_entry(xi, xj, reps, gamma, entanglement_map, hadamard_init=True):
    """K[i, j] = |<psi(x_i)|psi(x_j)>|^2 (gpu:380-383, KernelPkg.jl:106)."""
    vi = ansatz_state(xi, reps, gamma, entanglement_map, hadamard_init)
    vj = ansatz_state(xj, reps, gamma, entanglement_map, hadamard_init)
    ov = np.vdot(vi, vj)
    return float((ov * np.conj(ov)).real)
