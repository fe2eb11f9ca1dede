"""The port's copy of the dense statevector model
(``qml_cutensornet_tpu_torch/ops/dense.py``, numpy complex128) against the
original (``qml_cutensornet_tpu/ops/dense.py``): gates, ``ansatz_state`` and
``kernel_entry`` on random features, to 1e-12 (both run the same numpy
operations, so they agree to the last bit in practice)."""

import numpy as np
import pytest

from qml_cutensornet_tpu.ops import dense as ref_dense
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.ops import dense


def test_gates_equal():
    for theta in (0.0, 0.37, -1.2, np.pi):
        for name in ("rx", "rz", "xxphase", "zzphase"):
            np.testing.assert_allclose(getattr(dense, name)(theta),
                                       getattr(ref_dense, name)(theta), atol=1e-12)
    np.testing.assert_array_equal(dense.HADAMARD, ref_dense.HADAMARD)
    np.testing.assert_array_equal(dense.SWAP, ref_dense.SWAP)
    np.testing.assert_array_equal(dense.zero_state(5), ref_dense.zero_state(5))
    v = np.random.default_rng(0).standard_normal(32) + 0j
    np.testing.assert_allclose(dense.apply_gate(v, dense.xxphase(0.4), [3, 1], 5),
                               ref_dense.apply_gate(v, ref_dense.xxphase(0.4), [3, 1], 5),
                               atol=1e-12)


@pytest.mark.parametrize("nq,reps,d,hadamard", [(4, 1, 1, True), (6, 2, 3, True),
                                                (8, 2, 2, False)])
def test_ansatz_state_and_kernel_entry_equal(nq, reps, d, hadamard):
    rng = np.random.default_rng(nq + reps)
    em = entanglement_graph(nq, d)
    xi, xj = rng.uniform(0.0, 2.0, size=(2, nq))
    v = dense.ansatz_state(xi, reps, 0.8, em, hadamard)
    np.testing.assert_allclose(v, ref_dense.ansatz_state(xi, reps, 0.8, em, hadamard),
                               atol=1e-12)
    assert abs(np.vdot(v, v) - 1.0) <= 1e-12
    k = dense.kernel_entry(xi, xj, reps, 0.8, em, hadamard)
    assert abs(k - ref_dense.kernel_entry(xi, xj, reps, 0.8, em, hadamard)) <= 1e-12
    assert abs(dense.kernel_entry(xi, xi, reps, 0.8, em, hadamard) - 1.0) <= 1e-12
