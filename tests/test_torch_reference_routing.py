"""Reference routing and the gate-list engine of the port, against the JAX
reference on the CPU.

- ``build_schedule(..., routing="reference")``: segment arrays equal to the
  reference's at nq 8 and 32, with the reference's op counts (2803 two-site
  ops, 1982 of them gates, at the headline shape);
- ``KernelStateAnsatz.circuit_for_data``: equal gate lists;
- ``lower_gate_list``: equal arrays on random circuits of all six gate
  kinds, and the same errors;
- ``simulate_gate_list``: the state equal to the reference's and to the
  dense model (f64, untruncated: vectors to 1e-10, no phase freedom);
- the reference-routed 8-qubit Gram against the reference's and against the
  port's tracked Gram (f32, 3e-5)."""

import dataclasses

import numpy as np
import pytest

from qml_cutensornet_tpu.config import SimConfig as RefConfig
from qml_cutensornet_tpu.models import ansatz as ref_ansatz
from qml_cutensornet_tpu.models import simulate as ref_simulate
from qml_cutensornet_tpu.models.gram import build_kernel_matrix as ref_build
from qml_cutensornet_tpu.ops import mps as ref_mps
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models import ansatz, simulate
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix
from qml_cutensornet_tpu_torch.ops import dense, mps

FIELDS = ("pos_to_feature", "sites", "gkinds", "dirs", "fa", "fb")


@pytest.mark.parametrize("nq,reps,d,counts", [(8, 2, 3, None), (32, 2, 6, (2803, 1982))])
def test_reference_schedule_identical(nq, reps, d, counts):
    em = entanglement_graph(nq, d)
    port = ansatz.build_schedule(nq, reps, 1.0, em, routing="reference")
    ref = ref_ansatz.build_schedule(nq, reps, 1.0, em, routing="reference")
    assert port.routing == ref.routing == "reference"
    np.testing.assert_array_equal(port.final_pos, ref.final_pos)
    assert len(port.segments) == len(ref.segments) == reps
    for a, b in zip(port.segments, ref.segments):
        for field in FIELDS:
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert (port.num_two_site_ops, port.num_gate_ops) == (ref.num_two_site_ops,
                                                          ref.num_gate_ops)
    if counts is not None:
        assert (port.num_two_site_ops, port.num_gate_ops) == counts
    for staged in (True, False):
        p = simulate.stream_chunk_plan(port, SimConfig(chi=64), 128, staged)
        r = ref_simulate.stream_chunk_plan(ref, RefConfig(chi=64), 128, staged)
        assert p[1:] == r[1:]


def test_circuit_for_data_identical():
    rng = np.random.default_rng(5)
    nq, reps, gamma = 7, 2, 0.8
    em = entanglement_graph(nq, 3)
    x = rng.uniform(0.0, 2.0, size=nq)
    for routing in ("tracked", "reference"):
        got = ansatz.KernelStateAnsatz(nq, reps, gamma, em, routing=routing).circuit_for_data(x)
        want = ref_ansatz.KernelStateAnsatz(nq, reps, gamma, em).circuit_for_data(x)
        assert got == want
    with pytest.raises(RuntimeError, match="number of values"):
        ansatz.KernelStateAnsatz(nq, reps, gamma, em).circuit_for_data(x[:-1])


def _random_circuit(rng, n, depth):
    """H on every qubit, then ``depth`` gates of the six kinds; two-qubit
    gates on adjacent qubits listed in either order."""
    gates = [("H", [q], []) for q in range(n)]
    for _ in range(depth):
        kind = str(rng.choice(["H", "Rx", "Rz", "XXPhase", "ZZPhase", "SWAP"]))
        if kind in ("H", "Rx", "Rz"):
            params = [] if kind == "H" else [float(rng.uniform(-1, 1))]
            gates.append((kind, [int(rng.integers(n))], params))
        else:
            q0 = int(rng.integers(n - 1))
            qubits = [q0, q0 + 1] if rng.uniform() < 0.5 else [q0 + 1, q0]
            params = [] if kind == "SWAP" else [float(rng.uniform(-1, 1))]
            gates.append((kind, qubits, params))
    return gates


def _dense_apply(gates, n):
    v = dense.zero_state(n)
    for name, qubits, params in gates:
        theta = 0.5 * np.pi * (float(params[0]) if params else 0.0)
        u = {"H": lambda t: dense.HADAMARD, "SWAP": lambda t: dense.SWAP, "Rx": dense.rx,
             "Rz": dense.rz, "XXPhase": dense.xxphase, "ZZPhase": dense.zzphase}[name](theta)
        v = dense.apply_gate(v, u, list(qubits), n)
    return v


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lower_gate_list_identical(seed):
    rng = np.random.default_rng(seed)
    gates = _random_circuit(rng, 6, 60)
    got = simulate.lower_gate_list(gates, 6)
    want = ref_simulate.lower_gate_list(gates, 6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    kinds = set(int(k) for k in got[1])
    assert {ansatz.GATE_I, ansatz.GATE_SWAP, ansatz.GATE_XX, ansatz.GATE_ZZ,
            ansatz.GATE_RX, ansatz.GATE_RZ1, ansatz.GATE_H1} <= kinds


@pytest.mark.parametrize("gates,match", [
    ([("CX", [0, 1], [])], "not supported"),
    ([("XXPhase", [0, 2], [0.5])], "non-adjacent"),
])
def test_gate_list_errors_identical(gates, match):
    for lower in (simulate.lower_gate_list, ref_simulate.lower_gate_list):
        with pytest.raises(RuntimeError, match=match):
            lower(gates, 4)
    with pytest.raises(RuntimeError, match=match):
        simulate.simulate_gate_list(gates, 4, SimConfig(chi=4, precision="f64"), device="cpu")


def _port_dense(gates, n, cfg):
    st = simulate.simulate_gate_list(gates, n, cfg, device="cpu")
    return mps.to_dense(mps.mps_to_numpy(st)[0][0], n)


@pytest.mark.parametrize("method", ["svd", "subspace"])
@pytest.mark.parametrize("seed", [0, 1])
def test_simulate_gate_list_matches_reference_and_dense(seed, method):
    rng = np.random.default_rng(10 + seed)
    n = 6
    gates = _random_circuit(rng, n, 50)
    cfg = SimConfig(chi=8, precision="f64", svd_method=method)
    got = _port_dense(gates, n, cfg)
    rcfg = RefConfig(chi=8, precision="f64", svd_method=method)
    want = ref_mps.to_dense(ref_simulate.simulate_gate_list(gates, n, rcfg), n)
    assert np.abs(got - want).max() < 1e-10
    assert np.abs(got - _dense_apply(gates, n)).max() < 1e-10


def test_circuit_for_data_through_gate_list_matches_dense():
    rng = np.random.default_rng(7)
    n, reps, gamma = 6, 2, 0.8
    em = entanglement_graph(n, 3)
    x = rng.uniform(0.0, 2.0, size=n)
    gates = ansatz.KernelStateAnsatz(n, reps, gamma, em).circuit_for_data(x)
    got = _port_dense(gates, n, SimConfig(chi=8, precision="f64"))
    assert np.abs(got - dense.ansatz_state(x, reps, gamma, em)).max() < 1e-10
    # f32 through the subspace kernels' plain versions: overlap 1 to 3e-5
    got32 = _port_dense(gates, n, SimConfig(chi=8, svd_method="subspace", fused_split=True))
    ov = abs(np.vdot(got32, dense.ansatz_state(x, reps, gamma, em))) ** 2
    assert abs(ov - 1.0) <= 3e-5


def test_reference_routed_gram_matches_reference_and_tracked(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    nq = 8
    X = np.random.default_rng(3).uniform(0.0, 2.0, size=(5, nq))
    em = entanglement_graph(nq, 2)
    rcfg = RefConfig(chi=16, precision="f32", svd_method="subspace", fused_split=True,
                     fused_interpret=True, tile_block=2)
    cfg = SimConfig.from_reference(dataclasses.asdict(rcfg))
    K_ref = ref_build(ref_ansatz.KernelStateAnsatz(nq, 1, 1.0, em, routing="reference"), X,
                      cfg=rcfg, sim_batch=5, tile=8)
    K = build_kernel_matrix(ansatz.KernelStateAnsatz(nq, 1, 1.0, em, routing="reference"), X,
                            cfg=cfg, sim_batch=5, tile=8, device="cpu")
    K_tracked = build_kernel_matrix(ansatz.KernelStateAnsatz(nq, 1, 1.0, em), X, cfg=cfg,
                                    sim_batch=5, tile=8, device="cpu")
    np.testing.assert_allclose(K, K_ref, atol=3e-5)
    np.testing.assert_allclose(K, K_tracked, atol=3e-5)
    want = np.array([[dense.kernel_entry(a, b, 1, 1.0, em) for b in X] for a in X])
    np.testing.assert_allclose(K, want, atol=3e-5)
