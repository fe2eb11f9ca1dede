"""The port's brick routing against the reference, on the host: the
``BrickSchedule`` of ``models/ansatz`` (every layer's parity, swap flag,
active and firing pairs and angle features, the final permutation), the
staged-chi plan ``brick_stage_plan`` and the chunk plan ``brick_chunk_plan``
of ``models/simulate``, and ``ops/vidal.structural_caps`` and
``_pair_chunk``, all exactly equal over a grid of (n, reps, d) that takes in
d = 1, 2d >= n, odd n and odd d. Then the plan of the full-width brick
configuration (nf 100, r 2, d 6, chi 128): its layer, chunk and stage
counts, which fix the launch counts the card run is held to."""

import numpy as np
import pytest

from qml_cutensornet_tpu.config import SimConfig as RefConfig
from qml_cutensornet_tpu.models import ansatz as ref_ansatz
from qml_cutensornet_tpu.models import simulate as ref_simulate
from qml_cutensornet_tpu.ops import vidal as ref_vidal
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models import ansatz, simulate
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.ops import vidal

REP_FIELDS = ("pos_to_feature", "parities", "swaps", "active", "fire", "fa", "fb")


@pytest.mark.parametrize("nq,reps,d", [(6, 2, 1), (7, 3, 1), (8, 2, 2), (7, 2, 3), (6, 2, 3),
                                       (5, 2, 4), (12, 3, 4), (14, 2, 6), (17, 2, 5),
                                       (32, 2, 6)])
def test_brick_schedule_and_plans_identical(nq, reps, d):
    em = entanglement_graph(nq, d)
    port = ansatz.build_schedule(nq, reps, 1.0, em, routing="brick")
    ref = ref_ansatz.build_schedule(nq, reps, 1.0, em, routing="brick")
    assert isinstance(port, ansatz.BrickSchedule)
    for field in ("num_qubits", "reps", "gamma", "hadamard_init", "num_sites_padded",
                  "pairs_per_layer", "routing", "num_two_site_ops", "num_layers"):
        assert getattr(port, field) == getattr(ref, field), field
    np.testing.assert_array_equal(port.final_pos, ref.final_pos)
    assert len(port.bricks) == len(ref.bricks) == reps
    for a, b in zip(port.bricks, ref.bricks):
        for field in REP_FIELDS:
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype, field
            np.testing.assert_array_equal(x, y, err_msg=field)
    K = port.pairs_per_layer
    for chi in (8, 16, 64, 128):
        for staged in (True, False):
            stages, final = simulate.brick_stage_plan(port, SimConfig(chi=chi), staged)
            assert (stages, final) == ref_simulate.brick_stage_plan(ref, RefConfig(chi=chi),
                                                                   staged)
            for pairs in (K, K + 3):
                c2, arrs = simulate.brick_chunk_plan(port, stages, 16, pairs)
                rc2, rarrs = ref_simulate.brick_chunk_plan(ref, stages, 16, pairs)
                assert c2 == rc2
                for pa, ra in zip(arrs, rarrs):
                    for x, y in zip(pa, ra):
                        assert x.dtype == y.dtype and x.shape == y.shape
                        np.testing.assert_array_equal(x, y)
        assert vidal.structural_caps(nq, K, chi) == ref_vidal.structural_caps(nq, K, chi)
        for batch in (1, 8, 32):
            assert vidal._pair_chunk(K, chi, batch) == ref_vidal._pair_chunk(K, chi, batch)


@pytest.mark.parametrize("nq,batch,layers,stage_chunks", [
    # per stage chi: the number of 16-layer chunks of one sim batch
    (100, 8, 36, {8: 1, 16: 1, 32: 1, 64: 2, 128: 4}),
    (14, 32, 32, {8: 1, 16: 1, 32: 1, 64: 2, 128: 3}),
])
def test_full_width_brick_plan(nq, batch, layers, stage_chunks):
    """nf 100 (and the 14-qubit check of the card run), r 2, d 6, chi 128:
    one pair chunk per layer at these batches, so K5 takes 16 launches per
    chunk from chi 16 on (128 at nf 100, 112 at 14 qubits) and K1 the 16 of
    the chi-8 chunk."""
    s = ansatz.build_schedule(nq, 2, 1.0, entanglement_graph(nq, 6), routing="brick")
    assert [len(r.parities) for r in s.bricks] == [layers, layers]
    stages, final = simulate.brick_stage_plan(s, SimConfig(chi=128), True)
    chunks2, arrs = simulate.brick_chunk_plan(s, stages, 16, s.pairs_per_layer)
    got: dict = {}
    for (_, i, j, stage) in chunks2:
        got[stage] = got.get(stage, 0) + 1
    assert got == stage_chunks and final == 128
    assert all(len(a[0]) == 16 for a in arrs)
    assert sum(j - i for (_, i, j, _) in chunks2) == 2 * layers
    assert vidal._pair_chunk(s.pairs_per_layer, 128, batch) == s.pairs_per_layer
