"""The port's numpy-level modules against the reference: the ansatz schedule
compiler and the staged-chi chunk plan (identical arrays), the copied
entanglement / naming modules (identical outputs), the configuration, and
the numpy + scipy data pipeline, which must equal the pandas / sklearn
original to 1e-12 on the pinned v1 data (the chi statistics depend on the
exact features) and reproduce the golden file's first 8 train rows."""

import dataclasses

import numpy as np
import pytest

from qml_cutensornet_tpu.config import SimConfig as RefConfig
from qml_cutensornet_tpu.models import ansatz as ref_ansatz
from qml_cutensornet_tpu.models import simulate as ref_simulate
from qml_cutensornet_tpu.models.entanglement import entanglement_graph as ref_graph
from qml_cutensornet_tpu.utils import data as ref_data
from qml_cutensornet_tpu.utils import naming as ref_naming
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models import ansatz, simulate
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.utils import data, naming

V1 = "datasets/elliptic_bitcoin_dataset_v1"
GOLDEN = "runs/golden/bench_nq32_r2_d6_g1.0_N8.npz"


@pytest.mark.parametrize("nq,reps,d", [(6, 1, 1), (8, 2, 2), (12, 3, 4), (32, 2, 6)])
def test_schedule_and_chunk_plan_identical(nq, reps, d):
    em = entanglement_graph(nq, d)
    assert em == ref_graph(nq, d)
    port = ansatz.build_schedule(nq, reps, 1.0, em)
    ref = ref_ansatz.build_schedule(nq, reps, 1.0, em)
    np.testing.assert_array_equal(port.final_pos, ref.final_pos)
    assert len(port.segments) == len(ref.segments)
    for a, b in zip(port.segments, ref.segments):
        for field in ("pos_to_feature", "sites", "gkinds", "dirs", "fa", "fb"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert (port.num_two_site_ops, port.num_gate_ops) == (ref.num_two_site_ops, ref.num_gate_ops)
    for staged in (True, False):
        p = simulate.stream_chunk_plan(port, SimConfig(chi=64), 128, staged)
        r = ref_simulate.stream_chunk_plan(ref, RefConfig(chi=64), 128, staged)
        assert p[1:] == r[1:]
        for ps, rs in zip(p[0], r[0]):
            for x, y in zip(ps, rs):
                np.testing.assert_array_equal(x, y)


def test_headline_schedule_counts():
    """The main path's stream: 1092 two-site ops of which 622 are gates."""
    s = ansatz.KernelStateAnsatz(32, 2, 1.0, entanglement_graph(32, 6)).schedule
    assert (s.num_two_site_ops, s.num_gate_ops) == (1092, 622)


def test_untracked_routing_raises():
    """Reference routing builds a GateSchedule (its arrays are held to the
    reference in test_torch_reference_routing.py) and brick routing a
    BrickSchedule (test_torch_brick_schedule.py); an unknown name is refused
    as in the reference."""
    ref = ansatz.build_schedule(4, 1, 1.0, [(0, 2)], routing="reference")
    assert isinstance(ref, ansatz.GateSchedule) and ref.routing == "reference"
    assert (ref.num_two_site_ops, ref.num_gate_ops) == (3, 3)  # swap in, XX, swap back
    with pytest.raises(ValueError):
        ansatz.build_schedule(4, 1, 1.0, [(0, 1)], routing="bricks")
    assert isinstance(ansatz.build_schedule(4, 1, 1.0, [(0, 1)], routing="brick"),
                      ansatz.BrickSchedule)


def test_naming_copy():
    args = (32, 2, 1.0, 6, 64, 5, "elliptic_preproc_bench.csv")
    name = naming.run_info("train", *args)
    assert name == ref_naming.run_info("train", *args)
    assert naming.parse_run_info(name) == ref_naming.parse_run_info(name)


def test_config_from_reference_and_unported_fields():
    ref = RefConfig(chi=32, svd_method="subspace", subspace_iters=1, oversample=16,
                    fused_split=True, fused_interpret=True, tile_block=2)
    port = SimConfig.from_reference(dataclasses.asdict(ref))
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    # The route flags are carried faithfully in every combination.
    for fs in (False, True):
        for fg in (False, True):
            ref = RefConfig(svd_method="subspace", fused_split=fs, fused_gate=fg)
            port = SimConfig.from_reference(dataclasses.asdict(ref))
            assert (port.fused_split, port.fused_gate) == (fs, fg)
    # The dataclass defaults agree, svd_method="svd" included; every method runs.
    assert SimConfig.from_reference(dataclasses.asdict(RefConfig())) == SimConfig()
    assert SimConfig().svd_method == RefConfig().svd_method == "svd"
    for method in ("svd", "eigh", "subspace"):
        assert SimConfig(svd_method=method).svd_method == method
    # The three precision fields take every string the reference takes
    # (ops/lowp.py), the ambient matmul_precision included; every
    # combination round-trips through from_reference, and both resolved
    # precisions resolve as the reference's ("inherit" takes the ambient
    # class).
    strings = ("highest", "float32", "high", "bfloat16_3x", "tensorfloat32", "bfloat16",
               "default")
    for m in strings:
        for s in ("inherit",) + strings:
            port = SimConfig(matmul_precision=m, power_precision=s, tile_precision=s)
            ref = RefConfig(matmul_precision=m, power_precision=s, tile_precision=s)
            assert SimConfig.from_reference(dataclasses.asdict(ref)) == port
            assert port.resolved_tile_precision == ref.resolved_tile_precision
            assert port.resolved_power_precision == (m if s == "inherit" else s)
    with pytest.raises(ValueError):
        SimConfig(matmul_precision="tf32")
    # The pair step and the brick caps run; both default off, as in the reference.
    assert not (SimConfig().mgs_pair or SimConfig().brick_struct_caps)
    for field in ("mgs_pair", "brick_struct_caps"):
        assert getattr(SimConfig(**{field: True}), field)
        ref = RefConfig(**{field: True})
        assert getattr(SimConfig.from_reference(dataclasses.asdict(ref)), field)
    with pytest.raises(ValueError):
        SimConfig(precision="f16")


def test_data_pipeline_matches_sklearn(tmp_path):
    port_csv, ref_csv = tmp_path / "port.csv", tmp_path / "ref.csv"
    data.preprocess_elliptic(V1, str(port_csv))
    ref_data.preprocess_elliptic(V1, str(ref_csv))
    assert port_csv.read_text().splitlines()[0] == ref_csv.read_text().splitlines()[0]
    np.testing.assert_array_equal(data.read_preprocessed(str(port_csv)),
                                  data.read_preprocessed(str(ref_csv)))
    # The headline draw (bench.py / chip_smoke: 64 + 64 points, seed 5) and
    # a second draw with a different seed and class balance.
    for args in ((32, 64, 64, 5), (8, 20, 30, 2)):
        port = data.load_and_prepare(str(port_csv), *args)
        with pytest.warns(UserWarning):  # sklearn: n_quantiles > n_samples
            ref = ref_data.load_and_prepare(str(ref_csv), *args)
        for p, r in zip(port, ref):
            assert p.shape == r.shape
            np.testing.assert_allclose(p, np.asarray(r, dtype=p.dtype), rtol=0, atol=1e-12)
    x_train = data.load_and_prepare(str(port_csv), 32, 64, 64, 5)[0]
    np.testing.assert_allclose(x_train[:8], np.load(GOLDEN)["x"], rtol=0, atol=1e-12)
