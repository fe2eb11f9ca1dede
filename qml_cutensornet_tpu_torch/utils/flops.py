"""Analytic FLOP model of the Gram build (port of
``qml_cutensornet_tpu/utils/flops.py``; a copy, since the port imports
nothing of the reference package).

Counts real-arithmetic FLOPs for the shapes the chunked stream simulator
dispatches, through the port's own plans (``models/simulate``
``stream_chunk_plan``, ``brick_stage_plan``, ``brick_chunk_plan``, and
``ops/vidal.structural_caps``), plus the Gram tile contraction. Every count
equals the reference's for the same schedule and config (pinned by
``tests/test_torch_flops.py``), so a benchmark reads the same model in both
packages.

Conventions (the reference's)
-----------------------------
- A complex ``[m,k] @ [k,n]`` product is ``8*m*k*n`` real FLOPs (mult and
  add counted apart).
- Orthonormalizing a complex ``[m, n]`` block is costed as BCGS2 on the
  whole block: two passes of projection and update, ``16 m n^2``.
- O(chi^2) terms (gate application, diagonal layers) are counted where they
  are dispatched work; host work and kernel builds are not.

What the port dispatches that the model does not count (the counts stay the
reference's):

- above 128 columns the port orthonormalizes in panels of 32
  (``ops/blocked_qr``: K3 on each panel in complex64, the scanned panel step
  otherwise), whose inter-panel projections and in-panel passes differ from
  one BCGS2 over the block by O(m n^2) terms;
- K1, K2, K4 and K5 zero dependent columns and round their in-panel steps
  inside the kernel; the model counts the products and projections only;
- the tile scan pre-contracts ``tile_block`` sites (``site_block``, 2 on the
  CLI), runs at the states' chi bucket (``models/gram._chi_bucket``, which
  can be below ``final_chi`` above chi 128, or, per tile, on host-resident
  states) and on tiles padded with zero states; the model counts
  ``32 chi^3`` a site a pair at ``final_chi`` on the unpadded pairs;
- the svd and eigh methods (cuSOLVER) are not modelled: the model counts the
  subspace route.

``PEAKS`` holds the card only: one H100 SXM at its full 700 W power limit,
f32 outside the tensor cores (TF32 stays off), IEEE f64 on the tensor cores
(DMMA, twice the 34e12 outside them) and HBM3 bandwidth.
"""

from __future__ import annotations

from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import GATE_I, GATE_RX, GateSchedule

PEAKS = {
    "h100": {
        "f32_flops": 67e12,
        "f64_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    }
}


def cmatmul_flops(m: int, k: int, n: int) -> int:
    """Real FLOPs of a complex [m,k]@[k,n] product."""
    return 8 * m * k * n


def orth_flops(m: int, n: int) -> int:
    """Real FLOPs of orthonormalizing a complex [m, n] block (BCGS2, 2 passes)."""
    return 16 * m * n * n


def center_move_flops(chi: int) -> int:
    """One canonical-center move at working chi (``ops/mps.move_center``):
    QR of the [2chi, chi] site panel (orth + r = q^H v) plus folding r into
    the neighbor ([chi,chi] x [chi, 2chi]). Padding GATE_I ops of the chunk
    stream dispatch exactly this work."""
    return (
        orth_flops(2 * chi, chi)
        + cmatmul_flops(2 * chi, chi, chi)  # r = q^H v
        + cmatmul_flops(chi, chi, 2 * chi)  # r @ b (or a @ l)
    )


def two_site_flops(chi: int, subspace_iters: int, oversample: int = 0) -> int:
    """One truncating two-site update at working chi (``ops/mps.apply_2site``
    and the subspace split), theta [2chi, 2chi], keep = chi. With
    oversampling the iterate runs at ``keep + oversample`` columns."""
    m = 2 * chi
    k = 2 * chi
    nc = chi + oversample
    f = cmatmul_flops(2 * chi, chi, 2 * chi)  # theta build
    f += 8 * 4 * (4 * chi * chi)  # 4x4 gate contraction
    # Per iteration w = orth(theta^H v); v = orth(theta w).
    for _ in range(max(1, subspace_iters)):
        f += cmatmul_flops(k, m, nc)  # w = theta^H v
        f += orth_flops(k, nc)
        f += cmatmul_flops(m, k, nc)  # v = theta w
        f += orth_flops(m, nc)
    f += cmatmul_flops(nc, m, k)  # r = q^H theta
    return f


def single_site_flops(chi: int) -> int:
    """One 1q gate ([2,2] x [chi,2,chi])."""
    return cmatmul_flops(2, 2, chi * chi)


def sim_flops_per_circuit(
    schedule: GateSchedule, cfg: SimConfig, chunk_len: int = 128, staged: bool = True
) -> int:
    """Real FLOPs the chunked stream engine dispatches per circuit,
    including chunk-padding center moves and the staged-chi plan: the shapes
    actually run, not the idealized gate list."""
    from qml_cutensornet_tpu_torch.models.simulate import stream_chunk_plan

    segs, chunk_chis, _ = stream_chunk_plan(schedule, cfg, chunk_len, staged)
    n = schedule.num_qubits
    total = 0
    for (_, sites, gk, _, _, _, n_chunks), stages in zip(segs, chunk_chis):
        # Rz feature layer before each segment: n diagonal scalings, O(chi^2).
        first_chi = stages[0] if stages else cfg.chi
        total += n * 6 * 2 * first_chi * first_chi
        for c in range(n_chunks):
            chi = stages[c]
            for i in range(c * chunk_len, (c + 1) * chunk_len):
                kind = int(gk[i])
                if kind == GATE_I:
                    total += center_move_flops(chi)
                elif kind >= GATE_RX:
                    total += single_site_flops(chi)
                else:
                    total += two_site_flops(chi, cfg.subspace_iters, cfg.oversample)
    return total


def brick_pair_flops(
    cl: int, cm: int, cr: int, subspace_iters: int, oversample: int = 0
) -> int:
    """One Hastings pair update at caps (cl, cm, cr) (``ops/vidal.
    update_pairs``): theta build and gate, the right-sided subspace split of
    [2cl, 2cr] keeping cm (run on the transpose: m=2cr, k=2cl), and the
    recontraction new_a = theta~ V^H. Oversampling widens the iterate to
    cm + oversample."""
    f = 32 * cl * cm * cr  # theta0 = a x b
    f += 128 * cl * cr  # 4x4 gate contraction
    m, k, nc = 2 * cr, 2 * cl, cm + oversample
    for _ in range(max(1, subspace_iters)):
        f += cmatmul_flops(k, m, nc)  # theta^H v
        f += orth_flops(k, nc)
        f += cmatmul_flops(m, k, nc)  # theta w
        f += orth_flops(m, nc)
    f += cmatmul_flops(nc, m, k)  # r = q^H theta
    f += cmatmul_flops(2 * cl, 2 * cr, cm)  # new_a = theta~ V^H
    return f


def brick_sim_flops_per_circuit(
    schedule, cfg: SimConfig, layer_chunk: int = 16, staged: bool = True
) -> int:
    """Real FLOPs the brick engine dispatches per circuit: every layer of
    every chunk, the inactive padding layers and pairs included (computed,
    then selected away), at its stage chi, sliced to the structural caps
    under ``cfg.brick_struct_caps``."""
    from qml_cutensornet_tpu_torch.models.simulate import brick_chunk_plan, brick_stage_plan
    from qml_cutensornet_tpu_torch.ops.vidal import structural_caps

    n = schedule.num_qubits
    K = schedule.pairs_per_layer
    rep_stages, _ = brick_stage_plan(schedule, cfg, staged)
    chunks2, _ = brick_chunk_plan(schedule, rep_stages, layer_chunk, K)
    total = 0
    cap_cache: dict = {}
    for (_, _, _, stage) in chunks2:
        if cfg.brick_struct_caps:
            if stage not in cap_cache:
                cap_cache[stage] = structural_caps(n, K, stage)
            per_layer = sum(
                brick_pair_flops(cl, cm, cr, cfg.subspace_iters, cfg.oversample)
                for (cl, cm, cr) in cap_cache[stage]
            )
        else:
            per_layer = K * brick_pair_flops(
                stage, stage, stage, cfg.subspace_iters, cfg.oversample
            )
        total += layer_chunk * per_layer
    # Rz feature layers (one per rep): one diagonal pass at the rep's first stage.
    for stages in rep_stages:
        first = stages[0] if stages else cfg.chi
        total += n * 6 * 2 * first * first
    return total


def two_site_hbm_bytes(chi: int, subspace_iters: int, dtype_bytes: int = 4) -> dict:
    """Device-memory traffic of one two-site update at working chi, bytes per
    op per batch element, two models: ``floor``, only the state slices move
    (2 site tensors read, 2 written); ``xla``, every product and
    orthonormalization of the unfused chain materializes its result (the
    reference's name for its un-fused upper model; the port's fused kernels
    exist to bring the traffic toward ``floor``)."""
    site = chi * 2 * chi * 2 * dtype_bytes
    theta = 4 * chi * chi * 2 * dtype_bytes
    skinny = 2 * chi * chi * 2 * dtype_bytes  # [2chi, chi] blocks
    floor = 4 * site
    n_theta_trips = 3 if subspace_iters <= 1 else 3 + subspace_iters
    xla = floor + n_theta_trips * 2 * theta + 4 * 2 * skinny
    return {"floor": floor, "xla": xla}


def phase_time_floors(flops_count: int, bytes_count: int, platform: str = "h100") -> dict:
    """Compute- and bandwidth-bound time floors (seconds) of one phase; the
    larger is the roofline bound. A measured time far above both says the
    phase is launch- or latency-bound."""
    p = PEAKS[platform]
    return {
        "compute_s": flops_count / p["f32_flops"],
        "hbm_s": bytes_count / p["hbm_bytes_per_s"],
    }


def tile_flops(n_pairs: int, nq: int, chi: int) -> int:
    """Transfer-matrix overlap contraction: per pair per site, m @ b then
    a^H (mb), two [chi, chi(x2)] complex product groups = 32 chi^3."""
    return n_pairs * nq * 2 * cmatmul_flops(chi, chi, 2 * chi)


def gram_flops(
    schedule: GateSchedule,
    cfg: SimConfig,
    n_points: int,
    chunk_len: int = 128,
    staged: bool = True,
) -> dict:
    """FLOPs of one symmetric train-Gram build: every circuit simulated once,
    N(N+1)/2 overlap pairs. Returns the counts by phase and the final
    working chi the tiles run at; dispatches on the schedule type (a
    ``BrickSchedule`` has ``bricks``)."""
    from qml_cutensornet_tpu_torch.models.simulate import brick_stage_plan, stream_chunk_plan

    if hasattr(schedule, "bricks"):
        _, final_chi = brick_stage_plan(schedule, cfg, staged)
        per_circ = brick_sim_flops_per_circuit(schedule, cfg, staged=staged)
    else:
        _, _, final_chi = stream_chunk_plan(schedule, cfg, chunk_len, staged)
        per_circ = sim_flops_per_circuit(schedule, cfg, chunk_len, staged)
    n_pairs = n_points * (n_points + 1) // 2
    return {
        "sim_flops": n_points * per_circ,
        "sim_flops_per_circuit": per_circ,
        "tile_flops": tile_flops(n_pairs, schedule.num_qubits, final_chi),
        "final_chi": final_chi,
        "n_pairs": n_pairs,
    }


def roofline(flops: int, seconds: float, platform: str = "h100",
             peak_key: str = "f32_flops") -> dict:
    """Achieved TFLOP/s and fraction of the platform's peak for one phase."""
    if not seconds or seconds <= 0:
        return {"tflops": None, "peak_fraction": None}
    achieved = flops / seconds
    peak = PEAKS.get(platform, {}).get(peak_key)
    return {
        "tflops": round(achieved / 1e12, 3),
        "peak_fraction": round(achieved / peak, 4) if peak else None,
    }
