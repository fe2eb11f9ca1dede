"""The port's FLOP model (``utils/flops``) against the reference's
(``qml_cutensornet_tpu/utils/flops.py``): every count exactly equal (Python
integers) on the same schedules and configs, read through each package's
own plans, and the roofline arithmetic against the port's H100 entry.

Schedules: the headline tracked schedule (32 qubits, r 2, d 6, chi 64;
subspace iters 1 and 2, oversampling 0 and 16, staged and unstaged chi), a
16-qubit chi-256 tracked schedule, and the full-width brick schedule (nf
100, r 2, d 6, chi 128) with and without the structural caps."""

import dataclasses

import pytest

from qml_cutensornet_tpu.config import SimConfig as RefConfig
from qml_cutensornet_tpu.models.ansatz import KernelStateAnsatz as RefAnsatz
from qml_cutensornet_tpu.models.entanglement import entanglement_graph as ref_graph
from qml_cutensornet_tpu.utils import flops as ref_flops
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.utils import flops

_SCHEDULES: dict = {}


def _schedules(nq, d, routing):
    """(port schedule, reference schedule), built once per shape."""
    key = (nq, d, routing)
    if key not in _SCHEDULES:
        _SCHEDULES[key] = (
            KernelStateAnsatz(nq, 2, 1.0, entanglement_graph(nq, d), routing=routing).schedule,
            RefAnsatz(nq, 2, 1.0, ref_graph(nq, d), routing=routing).schedule)
    return _SCHEDULES[key]


def _configs(**kw):
    ref = RefConfig(svd_method="subspace", **kw)
    return SimConfig.from_reference(dataclasses.asdict(ref)), ref


def _equal(got, want):
    assert type(got) is type(want) and got == want, (got, want)


TRACKED = [
    pytest.param(32, dict(chi=64, subspace_iters=i, oversample=o), s,
                 id=f"32q-chi64-iters{i}-os{o}-{'staged' if s else 'flat'}")
    for i in (1, 2) for o in (0, 16) for s in (True, False)
] + [
    pytest.param(16, dict(chi=256, subspace_iters=2, oversample=16), s,
                 id=f"16q-chi256-{'staged' if s else 'flat'}")
    for s in (True, False)
]


@pytest.mark.parametrize("nq,cfg_kw,staged", TRACKED)
def test_tracked_counts_equal_reference(nq, cfg_kw, staged):
    sched, ref_sched = _schedules(nq, 6, "tracked")
    cfg, ref_cfg = _configs(**cfg_kw)
    _equal(flops.sim_flops_per_circuit(sched, cfg, 128, staged),
           ref_flops.sim_flops_per_circuit(ref_sched, ref_cfg, 128, staged))
    got = flops.gram_flops(sched, cfg, n_points=102, staged=staged)
    want = ref_flops.gram_flops(ref_sched, ref_cfg, n_points=102, staged=staged)
    assert got.keys() == want.keys()
    for key in want:
        _equal(got[key], want[key])


@pytest.mark.parametrize("caps", [False, True], ids=["plain", "caps"])
@pytest.mark.parametrize("iters", [1, 2])
def test_brick_counts_equal_reference(caps, iters):
    sched, ref_sched = _schedules(100, 6, "brick")
    cfg, ref_cfg = _configs(chi=128, subspace_iters=iters, oversample=0,
                            brick_struct_caps=caps)
    for staged in (True, False):
        _equal(flops.brick_sim_flops_per_circuit(sched, cfg, staged=staged),
               ref_flops.brick_sim_flops_per_circuit(ref_sched, ref_cfg, staged=staged))
    got = flops.gram_flops(sched, cfg, n_points=8)
    want = ref_flops.gram_flops(ref_sched, ref_cfg, n_points=8)
    assert got.keys() == want.keys()
    for key in want:
        _equal(got[key], want[key])


def test_brick_caps_cost_less_than_plain():
    sched, _ = _schedules(100, 6, "brick")
    plain, _ = _configs(chi=128, subspace_iters=2)
    caps, _ = _configs(chi=128, subspace_iters=2, brick_struct_caps=True)
    assert 0 < flops.brick_sim_flops_per_circuit(sched, caps) < \
        flops.brick_sim_flops_per_circuit(sched, plain)


@pytest.mark.parametrize("chi", [8, 64, 128, 256, 512])
def test_per_op_counts_equal_reference(chi):
    for iters in (1, 2):
        for os_ in (0, 16):
            _equal(flops.two_site_flops(chi, iters, os_), ref_flops.two_site_flops(chi, iters, os_))
            _equal(flops.brick_pair_flops(chi, chi // 2, chi, iters, os_),
                   ref_flops.brick_pair_flops(chi, chi // 2, chi, iters, os_))
        _equal(flops.two_site_hbm_bytes(chi, iters), ref_flops.two_site_hbm_bytes(chi, iters))
        _equal(flops.two_site_hbm_bytes(chi, iters, 8),
               ref_flops.two_site_hbm_bytes(chi, iters, 8))
    for fn in ("center_move_flops", "single_site_flops"):
        _equal(getattr(flops, fn)(chi), getattr(ref_flops, fn)(chi))
    _equal(flops.cmatmul_flops(chi, 2 * chi, 3), ref_flops.cmatmul_flops(chi, 2 * chi, 3))
    _equal(flops.orth_flops(2 * chi, chi), ref_flops.orth_flops(2 * chi, chi))
    for n_pairs, nq in ((5253, 32), (36, 100), (1, 16)):
        _equal(flops.tile_flops(n_pairs, nq, chi), ref_flops.tile_flops(n_pairs, nq, chi))


def test_peaks_hold_the_h100_only():
    assert flops.PEAKS == {"h100": {"f32_flops": 67e12, "f64_flops": 67e12,
                                    "hbm_bytes_per_s": 3.35e12}}


def test_roofline_and_floors_against_h100():
    r = flops.roofline(33.5e12, 1.0)
    assert r == {"tflops": 33.5, "peak_fraction": 0.5}
    assert flops.roofline(67e12, 2.0, "h100", "f32_flops")["peak_fraction"] == 0.5
    assert flops.roofline(1, 0.0) == {"tflops": None, "peak_fraction": None}
    assert flops.roofline(1, 1.0, peak_key="bf16_flops")["peak_fraction"] is None
    f = flops.two_site_flops(64, 2)
    b = flops.two_site_hbm_bytes(64, 2)["xla"]
    t = flops.phase_time_floors(f, b)
    assert t == {"compute_s": f / 67e12, "hbm_s": b / 3.35e12}
    # chi 512, iters 2 is compute-bound on the card too
    t2 = flops.phase_time_floors(flops.two_site_flops(512, 2),
                                 flops.two_site_hbm_bytes(512, 2)["xla"])
    assert t2["compute_s"] > 4 * t2["hbm_s"]
    with pytest.raises(KeyError):
        flops.phase_time_floors(f, b, "v5e")
