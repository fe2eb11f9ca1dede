"""Batched circuit simulation over the op stream and over the brick layers,
the gate-list engine, and the Gram-tile overlaps (port of
``qml_cutensornet_tpu/models/simulate.py``: ``apply_schedule_op``,
``stream_chunk_plan``, the chunked stream simulator, ``brick_stage_plan``,
``brick_chunk_plan``, ``drive_brick_schedule``, ``make_brick_simulator``,
``_GATE_LIST_KINDS``, ``lower_gate_list``, ``simulate_gate_list``,
``state_norms_sq``, ``_combine_sites``, ``tile_overlaps_sq``).

A :class:`GateSchedule` of either routing ("tracked" or "reference") runs on
the same chunked stream simulator.

The op stream is shared by every datapoint of a batch, so the batch is a
leading tensor dimension and the stream is a Python loop: each op is one
batched update (one kernel launch for its factorization). The stream is
cut into chunks exactly as the reference cuts it, padded with the same
neutral ops (identity center moves, exact no-ops for the state), and each
chunk runs at the same staged bond cap, so the port performs the same
operations at the same shapes as the reference.

A :class:`BrickSchedule` runs on the brick engine (``ops/vidal.py``)
instead: its layers are cut into same-stage chunks of 16, padded with
inactive layers as the reference pads them, so that the same pair updates
run at the same staged bond caps.

The gate-list engine (:func:`simulate_gate_list`) takes one bound circuit in
the reference's tuple format (H/Rx/Rz/XXPhase/ZZPhase/SWAP on adjacent
sites, ``KernelStateAnsatz.circuit_for_data``), lowers it with the ansatz
compiler's center tracking (:func:`lower_gate_list`) and runs it op by op
through :func:`apply_schedule_op` at the configuration's bond cap.

Every engine runs its products at the ambient class ``cfg.matmul_precision``
(the reference wraps each simulator's init, Rz and chunk steps in
``jax.default_matmul_precision``): the Hadamard layer, each op's products
(``ops/mps``, ``ops/vidal``, ``ops/svd``), through ``ops/lowp.matmul``.
The tiles and norms run theirs at the precision their callers pass, the
resolved tile precision.
"""

from __future__ import annotations

import dataclasses
import os
from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import (
    DIR_L,
    DIR_R,
    GATE_H1,
    GATE_I,
    GATE_RX,
    GATE_RZ1,
    GATE_SWAP,
    GATE_XX,
    GATE_XXSW,
    GATE_ZZ,
    BrickSchedule,
    GateSchedule,
)
from qml_cutensornet_tpu_torch.ops import gates, lowp, mps as mps_ops, vidal
from qml_cutensornet_tpu_torch.ops.mps import MPS
from qml_cutensornet_tpu_torch.utils.device import resolve_device


def apply_schedule_op(state: MPS, site: int, gkind: int, direction: int,
                      theta: torch.Tensor, cfg: SimConfig) -> MPS:
    """Dispatch one lowered op on the whole batch: GATE_I is a center move,
    SWAP/XX/XXSW/ZZ a truncating two-site update, RX/RZ1/H1 a single-site
    gate. ``theta [B]`` holds the per-sample angles. The gate matrix is the
    reference's one-hot blend over the gate kinds."""
    if gkind == GATE_I:
        return mps_ops.move_center(state, site, direction, cfg)
    rdt = cfg.real_dtype
    if gkind >= GATE_RX:
        w_rx = float(gkind == GATE_RX)
        w_rz = float(gkind == GATE_RZ1)
        w_h = 1.0 - w_rx - w_rz
        mat = (w_rx * gates.rx(theta) + w_rz * gates.rz(theta)
               + w_h * gates.hadamard(rdt, theta.device))
        return mps_ops.apply_1q(state, site, mat, cfg.matmul_precision)
    xx = gates.xxphase(theta)
    sw = gates.swap(rdt, theta.device)
    zz = gates.zzphase(theta)
    # The fused XXSW matrix is xx @ swap: xx with columns 1 and 2 exchanged.
    fu = xx[..., [0, 2, 1, 3]]
    w_xx = float(gkind == GATE_XX)
    w_fu = float(gkind == GATE_XXSW)
    w_zz = float(gkind == GATE_ZZ)
    w_sw = 1.0 - w_xx - w_fu - w_zz
    mat = w_xx * xx + w_fu * fu + w_zz * zz + w_sw * sw
    return mps_ops.apply_2site(state, site, mat, cfg, direction)


def stream_chunk_plan(schedule: GateSchedule, cfg: SimConfig, chunk_len: int, staged: bool):
    """Lower a tracked schedule to padded chunk arrays plus the staged-chi
    plan; identical to the reference's (same stage chis at the same op
    indices). Returns ``(segs, chunk_chis, final_chi)`` with ``segs`` entries
    ``(pos_to_feature, sites, gkinds, dirs, fa, fb, n_chunks)``."""
    n = schedule.num_qubits
    segs = []
    for seg in schedule.segments:
        g = len(seg.sites)
        n_chunks = max(1, -(-g // chunk_len)) if g else 0
        pad = n_chunks * chunk_len - g
        if g:
            # Neutral padding op: identity move at the segment-final center.
            neutral_site = int(seg.sites[-1])
            neutral_dir = int(seg.dirs[-1])
            sites = np.concatenate([seg.sites, np.full(pad, neutral_site, np.int32)])
            gk = np.concatenate([seg.gkinds, np.full(pad, GATE_I, np.int32)])
            dirs = np.concatenate([seg.dirs, np.full(pad, neutral_dir, np.int32)])
            fa = np.concatenate([seg.fa, np.zeros(pad, np.int32)])
            fb = np.concatenate([seg.fb, np.zeros(pad, np.int32)])
        else:
            sites = gk = dirs = fa = fb = np.zeros((0,), np.int32)
        segs.append((seg.pos_to_feature, sites, gk, dirs, fa, fb, n_chunks))

    chunk_chis: list[list[int]] = []
    if staged:
        floor_chi = min(8, cfg.chi)
        bd = np.ones(max(n - 1, 1), dtype=np.float64)
        cut = np.array(
            [min(2.0 ** (k + 1), 2.0 ** (n - k - 1)) for k in range(max(n - 1, 1))]
        )
        for (_, sites, gk, _, _, _, n_chunks) in segs:
            stages = []
            for c in range(n_chunks):
                for i in range(c * chunk_len, (c + 1) * chunk_len):
                    if gk[i] == GATE_I:
                        continue
                    s = int(sites[i])
                    lb = bd[s - 1] if s > 0 else 1.0
                    rb = bd[s + 1] if s + 1 <= n - 2 else 1.0
                    bd[s] = min(2 * lb, 2 * rb, cut[s], float(cfg.chi))
                bound = int(bd.max())
                stage = floor_chi
                while stage < bound:
                    stage *= 2
                stages.append(min(stage, cfg.chi))
            chunk_chis.append(stages)
    else:
        chunk_chis = [[cfg.chi] * nc for (_, _, _, _, _, _, nc) in segs]
    final_chi = cfg.chi
    for stages in chunk_chis:
        for s in stages:
            final_chi = s
    if not any(len(st) for st in chunk_chis):
        final_chi = min(8, cfg.chi) if staged else cfg.chi
    return segs, chunk_chis, final_chi


def _pad_bonds(state: MPS, chi: int) -> MPS:
    """Grow the bond padding to ``chi`` with exact zeros."""
    old = state.tensors.shape[-1]
    if old == chi:
        return state
    t = torch.nn.functional.pad(state.tensors, (0, chi - old, 0, 0, 0, chi - old))
    return dataclasses.replace(state, tensors=t)


def make_chunked_simulator(schedule: GateSchedule | BrickSchedule, cfg: SimConfig,
                           device: torch.device, chunk_len: int | None = None,
                           staged: bool | None = None, site_mesh=None):
    """``simulate(features [B, n]) -> MPS`` over the tracked op stream, in
    chunks of ``chunk_len`` ops (``QMLTPU_CHUNK_LEN``, default 128) with the
    staged bond cap (``QMLTPU_STAGED``, default on): each chunk runs at the
    smallest power-of-two chi that holds its structural bond bound, which
    is exactly equivalent to running at ``cfg.chi`` throughout. A
    :class:`BrickSchedule` goes to :func:`make_brick_simulator`, or with a
    ``site_mesh`` (``parallel/mesh.make_site_mesh``; the CLI's
    ``QMLTPU_SHARD_MPS``) to the site-sharded engine
    (``parallel/sharded_mps.py``), which gives every rank the gathered MPS.
    A ``site_mesh`` with any other schedule raises."""
    if isinstance(schedule, BrickSchedule):
        if site_mesh is not None:
            from qml_cutensornet_tpu_torch.parallel import sharded_mps

            return sharded_mps.make_sharded_brick_simulator(schedule, cfg, site_mesh,
                                                            staged=staged)
        return make_brick_simulator(schedule, cfg, device, staged=staged)
    if site_mesh is not None:
        raise ValueError("a site mesh (QMLTPU_SHARD_MPS) shards the brick engine's sites: "
                         "use the brick routing (QMLTPU_ROUTING=brick)")
    if chunk_len is None:
        chunk_len = int(os.environ.get("QMLTPU_CHUNK_LEN", "128"))
    if staged is None:
        staged = os.environ.get("QMLTPU_STAGED", "1") != "0"
    n = schedule.num_qubits
    rdt = cfg.real_dtype
    np_rdt = np.dtype(str(rdt).removeprefix("torch."))
    gamma = schedule.gamma
    segs, chunk_chis, final_chi = stream_chunk_plan(schedule, cfg, chunk_len, staged)
    cfgs: dict[int, SimConfig] = {}

    def cfg_for(chi_s: int) -> SimConfig:
        if chi_s not in cfgs:
            cfgs[chi_s] = dataclasses.replace(cfg, chi=chi_s)
        return cfgs[chi_s]

    def simulate(features) -> MPS:
        x = np.asarray(features, dtype=np.float64)
        batch = x.shape[0]
        cur_chi = next((st[0] for st in chunk_chis if st), final_chi)
        state = mps_ops.zero_state(batch, n, cfg_for(cur_chi), device)
        if schedule.hadamard_init:
            state = mps_ops.apply_1q_all(state, gates.hadamard(rdt, device),
                                         cfg.matmul_precision)
        for (pos_to_feature, sites, gk, dirs, fa, fb, n_chunks), stages in zip(
            segs, chunk_chis
        ):
            xs = torch.as_tensor(x[:, pos_to_feature].astype(np_rdt),
                                 device=device)
            state = mps_ops.apply_diag_all(state, gates.rz_phases(gamma * xs))
            if n_chunks == 0:
                continue
            thetas = 0.5 * np.pi * gamma * gamma * (1.0 - x[:, fa]) * (1.0 - x[:, fb])
            thetas = torch.as_tensor(thetas.astype(np_rdt), device=device)
            for c in range(n_chunks):
                if stages[c] > cur_chi:
                    cur_chi = stages[c]
                    state = _pad_bonds(state, cur_chi)
                cfg_s = cfg_for(cur_chi)
                for i in range(c * chunk_len, (c + 1) * chunk_len):
                    state = apply_schedule_op(state, int(sites[i]), int(gk[i]),
                                              int(dirs[i]), thetas[:, i], cfg_s)
        return state

    return simulate


def brick_stage_plan(schedule: BrickSchedule, cfg: SimConfig, staged: bool):
    """Staged chi of the brick engine: a host replay of the per-layer
    structural bond bounds (a two-site update across real bond s gives at
    most min(2 left bond, 2 right bond, position cut, cap), from the bonds
    before the layer). Returns ``(rep_stages, final_chi)``; identical to the
    reference's."""
    n = schedule.num_qubits
    rep_stages: list[list[int]] = []
    if staged:
        floor_chi = min(8, cfg.chi)
        bd = np.ones(max(n - 1, 1))
        cut = np.array(
            [min(2.0 ** (k + 1), 2.0 ** (n - k - 1)) for k in range(max(n - 1, 1))]
        )
        for rep in schedule.bricks:
            stages = []
            for li in range(len(rep.parities)):
                par = int(rep.parities[li])
                new_bd = bd.copy()
                for k in np.nonzero(rep.active[li])[0]:
                    s = par + 2 * int(k) - 1  # real left site
                    if not (0 <= s <= n - 2):
                        continue
                    lb = bd[s - 1] if s > 0 else 1.0
                    rb = bd[s + 1] if s + 1 <= n - 2 else 1.0
                    new_bd[s] = min(2 * lb, 2 * rb, cut[s], float(cfg.chi))
                bd = new_bd
                bound = int(bd.max())
                stage = floor_chi
                while stage < bound:
                    stage *= 2
                stages.append(min(stage, cfg.chi))
            rep_stages.append(stages)
    else:
        rep_stages = [[cfg.chi] * len(r.parities) for r in schedule.bricks]
    final_chi = min(8, cfg.chi) if staged else cfg.chi
    for st_list in rep_stages:
        for s in st_list:
            final_chi = s
    return rep_stages, final_chi


def brick_chunk_plan(schedule: BrickSchedule, rep_stages, layer_chunk: int, pairs: int):
    """Cut the layers into runs of consecutive same-stage layers within one
    rep, padded to ``layer_chunk`` layers with inactive (all-false) layers,
    exact no-ops under the active select; the pair axis is padded to
    ``pairs`` columns. Returns ``(chunks2, chunk_arrays)``: entries ``(rep,
    layer_start, layer_end, stage)`` and ``(parities [C], swaps [C] f32,
    actives [C, pairs] bool)``; identical to the reference's."""
    K = schedule.pairs_per_layer
    chunks2 = []
    for ri, (rep, stages) in enumerate(zip(schedule.bricks, rep_stages)):
        L = len(rep.parities)
        i = 0
        while i < L:
            j = i + 1
            while j < L and j - i < layer_chunk and stages[j] == stages[i]:
                j += 1
            chunks2.append((ri, i, j, stages[i]))
            i = j

    chunk_arrays = []
    for (ri, i, j, stage) in chunks2:
        rep = schedule.bricks[ri]
        pad = layer_chunk - (j - i)
        act = np.concatenate([rep.active[i:j], np.zeros((pad, K), bool)])
        if pairs > K:
            act = np.pad(act, ((0, 0), (0, pairs - K)))
        chunk_arrays.append((
            np.concatenate([rep.parities[i:j], np.zeros(pad, np.int32)]),
            np.concatenate([rep.swaps[i:j].astype(np.float32), np.zeros(pad, np.float32)]),
            act,
        ))
    return chunks2, chunk_arrays


def _pad_vidal(state: vidal.VidalState, chi: int) -> vidal.VidalState:
    """Grow the bond padding of tensors and lambdas to ``chi`` with exact
    zeros."""
    old = state.tensors.shape[-1]
    return dataclasses.replace(
        state,
        tensors=torch.nn.functional.pad(state.tensors, (0, chi - old, 0, 0, 0, chi - old)),
        lams=torch.nn.functional.pad(state.lams, (0, chi - old)))


class BrickStageFns(NamedTuple):
    """One stage's steps of a brick engine (:func:`drive_brick_schedule`)."""

    init: Callable  # features [B, n] -> state
    rz: Callable  # (state, rz_arg(rep, x)) -> state
    chunk: Callable  # (state, parities, swaps, actives, thetas) -> state
    pad_to: Callable  # state of a lower stage -> state at this stage's chi
    finalize: Callable  # state -> MPS


def drive_brick_schedule(x, schedule: BrickSchedule, chunks2, chunk_arrays, layer_chunk: int,
                         rdt: torch.dtype, fns_for, *, rz_arg, place_acts, place_thetas,
                         k_pad: int, final_chi: int):
    """The one host loop both brick engines run, as the reference's: per-rep
    angles, one Rz layer per rep, staged-chi growth before the first chunk
    of a higher stage, the chunks, then the finalize step.

    The whole-chain engine (:func:`make_brick_simulator`) and the
    site-sharded one (``parallel/sharded_mps.py``) differ only in where
    their arrays live and in the site frame their Rz layer addresses; both
    are injected here, so the stage and chunk sequence that keeps the two
    numerically identical lives in one place. ``fns_for(chi)`` returns the
    stage's :class:`BrickStageFns`; ``rz_arg(rep, x)`` makes the Rz step's
    input, ``place_acts`` and ``place_thetas`` put the chunk's actives
    ``[C, k_pad]`` and thetas ``[C, B, k_pad]`` where the chunk step reads
    them (its parities and swaps stay on the host); ``k_pad`` pads the pair
    axis."""
    gamma = schedule.gamma
    np_rdt = np.dtype(str(rdt).removeprefix("torch."))
    x = np.asarray(x, dtype=np.float64)
    cur_chi = chunks2[0][3] if chunks2 else final_chi
    state = fns_for(cur_chi).init(x)
    K = schedule.pairs_per_layer
    rep_thetas = []
    for rep in schedule.bricks:
        th = 0.5 * np.pi * gamma * gamma * (1.0 - x[:, rep.fa]) * (1.0 - x[:, rep.fb])
        th = np.where(rep.fire[None], th, 0.0)  # [B, L, K]
        if k_pad > K:
            th = np.pad(th, ((0, 0), (0, 0), (0, k_pad - K)))
        rep_thetas.append(th.astype(np_rdt))
    done_rz = -1
    for (ri, i, j, stage), (pars, sws, acts) in zip(chunks2, chunk_arrays):
        if ri > done_rz:
            state = fns_for(cur_chi).rz(state, rz_arg(ri, x))
            done_rz = ri
        if stage > cur_chi:
            cur_chi = stage
            state = fns_for(cur_chi).pad_to(state)
        # thetas [C, B, K], padded layers get zeros
        th = np.pad(rep_thetas[ri][:, i:j], ((0, 0), (0, layer_chunk - (j - i)), (0, 0)))
        state = fns_for(cur_chi).chunk(state, pars, sws, place_acts(acts),
                                       place_thetas(np.ascontiguousarray(th.transpose(1, 0, 2))))
    return fns_for(cur_chi).finalize(state)


BRICK_LAYER_CHUNK = 16  # brick layers per chunk, padded with inactive layers


def make_brick_simulator(schedule: BrickSchedule, cfg: SimConfig, device: torch.device,
                         layer_chunk: int = BRICK_LAYER_CHUNK, staged: bool | None = None):
    """``simulate(features [B, n]) -> MPS`` on the brick engine: every layer
    is one ``[B * K]``-batched pair update (kernel K5 where the stage takes
    it), chunks of ``layer_chunk`` layers padded with inactive layers, and
    the staged bond cap of :func:`brick_stage_plan` (``QMLTPU_STAGED``,
    default on). Single device."""
    if staged is None:
        staged = os.environ.get("QMLTPU_STAGED", "1") != "0"
    n, n_p, K = schedule.num_qubits, schedule.num_sites_padded, schedule.pairs_per_layer
    rdt, gamma = cfg.real_dtype, schedule.gamma
    np_rdt = np.dtype(str(rdt).removeprefix("torch."))
    rep_stages, final_chi = brick_stage_plan(schedule, cfg, staged)
    chunks2, chunk_arrays = brick_chunk_plan(schedule, rep_stages, layer_chunk, K)
    fns: dict = {}

    def fns_for(chi_s: int):
        if chi_s in fns:
            return fns[chi_s]
        cfg_s = dataclasses.replace(cfg, chi=chi_s)

        def init(x):
            state = vidal.zero_state(x.shape[0], n_p, cfg_s, device)
            if schedule.hadamard_init:
                state = vidal.apply_1q_real_sites(state, gates.hadamard(rdt, device), n,
                                                  cfg.matmul_precision)
            return state

        def rz(state, xs):
            return vidal.apply_diag_real_sites(state, gates.rz_phases(gamma * xs))

        def chunk(state, pars, sws, acts, thetas):
            return vidal.layer_scan(state, pars, sws, acts, thetas, cfg_s, n=n)

        def finalize(state):
            tensors, fidelity, bond_dims = vidal.to_mps_tensors(state, n)
            return MPS(tensors=tensors, fidelity=fidelity, bond_dims=bond_dims)

        fns[chi_s] = BrickStageFns(init, rz, chunk, lambda state: _pad_vidal(state, chi_s),
                                   finalize)
        return fns[chi_s]

    def on_device(a):
        return torch.as_tensor(a, device=device)

    def simulate(features) -> MPS:
        return drive_brick_schedule(
            features, schedule, chunks2, chunk_arrays, layer_chunk, rdt, fns_for,
            rz_arg=lambda ri, x: on_device(
                x[:, schedule.bricks[ri].pos_to_feature].astype(np_rdt)),
            place_acts=on_device, place_thetas=on_device, k_pad=K, final_chi=final_chi)

    return simulate


_GATE_LIST_KINDS = {
    "SWAP": GATE_SWAP,
    "XXPhase": GATE_XX,
    "ZZPhase": GATE_ZZ,
    "Rx": GATE_RX,
    "Rz": GATE_RZ1,
    "H": GATE_H1,
}


def lower_gate_list(gate_list, num_qubits: int):
    """Lower a bound circuit ``[(name, qubits, params), ...]`` (pytket
    half-turn exponents) to op-stream arrays ``(sites, gkinds, dirs,
    thetas)`` for :func:`apply_schedule_op`, as the reference does: the full
    gate set H/Rx/Rz/XXPhase/ZZPhase/SWAP, ``RuntimeError`` on any other
    gate and on a two-qubit gate on non-adjacent qubits; canonical-center
    moves inserted as in ``models/ansatz._canonical_lower``, each two-site
    op's direction by lookahead to the next two-site op; single-site gates
    neither need nor move the center."""
    raw = []  # (site, kind, theta, is_two_site)
    for name, qubits, params in gate_list:
        kind = _GATE_LIST_KINDS.get(name)
        if kind is None:
            raise RuntimeError(f"Gate {name} not supported.")
        alpha = float(params[0]) if params else 0.0
        theta = 0.5 * np.pi * alpha  # half-turns -> true angle
        if kind >= GATE_RX:
            (q,) = qubits
            raw.append((int(q), kind, theta, False))
        else:
            q0, q1 = sorted(int(q) for q in qubits)
            if q1 != q0 + 1:
                raise RuntimeError(
                    f"Two-qubit gate {name} on non-adjacent qubits ({q0},{q1});"
                    " route the circuit first.")
            raw.append((q0, kind, theta, True))

    nxt2 = [None] * len(raw)  # site of the NEXT two-site op
    nxt = None
    for i in range(len(raw) - 1, -1, -1):
        nxt2[i] = nxt
        if raw[i][3]:
            nxt = raw[i][0]

    ops = []  # (site, kind, dir, theta)
    center = None
    for i, (site, kind, theta, is2q) in enumerate(raw):
        if not is2q:
            ops.append((site, kind, DIR_R, theta))
            continue
        if center is None:
            center = site
        while center < site:
            ops.append((center, GATE_I, DIR_R, 0.0))
            center += 1
        while center > site + 1:
            ops.append((center - 1, GATE_I, DIR_L, 0.0))
            center -= 1
        nxt = nxt2[i] if nxt2[i] is not None else site
        d = DIR_L if nxt < site else DIR_R
        ops.append((site, kind, d, theta))
        center = site if d == DIR_L else site + 1

    arr = np.asarray([(s, k, d) for (s, k, d, _) in ops], dtype=np.int32).reshape(-1, 3)
    thetas = np.asarray([t for (_, _, _, t) in ops], dtype=np.float64)
    return arr[:, 0], arr[:, 1], arr[:, 2], thetas


def simulate_gate_list(gate_list, num_qubits: int, cfg: SimConfig,
                       device: str = "cuda") -> MPS:
    """Simulate ONE bound circuit in the reference's tuple format on
    ``device`` ("cuda" or "cpu"; no fallback), op by op at ``cfg.chi``.
    Returns the final :class:`MPS` (a batch of one state)."""
    dev = resolve_device(device)
    sites, gkinds, dirs, thetas = lower_gate_list(gate_list, num_qubits)
    th = torch.as_tensor(thetas, dtype=cfg.real_dtype, device=dev)
    state = mps_ops.zero_state(1, num_qubits, cfg, dev)
    for i in range(len(sites)):
        state = apply_schedule_op(state, int(sites[i]), int(gkinds[i]), int(dirs[i]),
                                  th[i:i + 1], cfg)
    return state


def state_norms_sq(a: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """``<psi_b|psi_b>`` for ``a [B, n, chi, 2, chi]`` -> real ``[B]``, its
    products at ``precision`` (``ops/lowp.matmul``: kernel K7 at a reduced
    class in complex64)."""
    B, n, chi = a.shape[0], a.shape[1], a.shape[2]
    m = torch.zeros((B, chi, chi), dtype=a.dtype, device=a.device)
    m[:, 0, 0] = 1.0
    for i in range(n):
        t = a[:, i]
        # tm[z, a, (s d)] = m[z] t[z, a, (s d)]; m'[z] = t[z, (a s), :]^H tm[z, (a s), :]
        tm = lowp.matmul(m, t.reshape(B, chi, 2 * chi), precision)
        m = lowp.matmul(t.reshape(B, 2 * chi, chi), tm.reshape(B, 2 * chi, chi), precision, "h")
    return m[:, 0, 0].real


def _combine_sites(a: torch.Tensor, k: int, precision: str = "highest"):
    """Pre-contract runs of ``k`` adjacent sites into physical-dim ``2^k``
    blocks: ``[B, n, chi, 2, chi] -> ([B, n//k, chi, 2^k, chi], tail
    [B, chi, 2^rem, chi] | None)``, the products at ``precision`` (as
    :func:`state_norms_sq`)."""
    b, n, chi = a.shape[0], a.shape[1], a.shape[2]
    g, rem = n // k, n % k

    def combine(u, t):
        # [..., (x p), y] @ [..., y, (t z)]
        p, lead = u.shape[-2], u.shape[:-3]
        out = lowp.matmul(u.reshape(*lead, chi * p, chi), t.reshape(*lead, chi, 2 * chi),
                          precision)
        return out.reshape(*lead, chi, p * 2, chi)

    main = None
    if g:
        grp = a[:, : g * k].reshape(b, g, k, chi, 2, chi)
        main = grp[:, :, 0]
        for j in range(1, k):
            main = combine(main, grp[:, :, j])
    tail = None
    if rem:
        tail = a[:, g * k]
        for j in range(1, rem):
            tail = combine(tail, a[:, g * k + j])
    return main, tail


def tile_step(m: torch.Tensor, ty: torch.Tensor, tx: torch.Tensor, p: int,
              precision: str = "highest") -> torch.Tensor:
    """One transfer-matrix step of an all-pairs tile: the carry ``m [By, Bx,
    chi, chi]`` (``m[y, x, a, b]``, ``a`` the bond of ``y``, ``b`` that of
    ``x``) through the sites ``ty [By, chi, p, chi]`` and ``tx [Bx, chi, p,
    chi]`` (``p`` physical values): two batched complex matmuls, at
    ``precision`` (as :func:`state_norms_sq`)."""
    By, Bx, chi = m.shape[0], m.shape[1], m.shape[2]
    # T[x, (y a), (s d)] = sum_b M[x, (y a), b] Tx[x, b, (s d)]
    mx = m.transpose(0, 1).reshape(Bx, By * chi, chi)
    t1 = lowp.matmul(mx, tx.reshape(Bx, chi, p * chi), precision)
    # regroup [x, (y a), (s d)] -> [y, (a s), (x d)]
    t2 = (t1.reshape(Bx, By, chi, p, chi).permute(1, 2, 3, 0, 4)
          .reshape(By, chi * p, Bx * chi))
    tym = ty.reshape(By, chi * p, chi)
    m2 = lowp.matmul(tym, t2, precision, "h")  # [By, chi, Bx*chi]
    return m2.reshape(By, chi, Bx, chi).transpose(1, 2)


def tile_overlaps_sq(ay: torch.Tensor, ax: torch.Tensor, precision: str = "highest",
                     site_block: int = 1) -> torch.Tensor:
    """All-pairs ``|<y_i|x_j>|^2`` between ``ay [By, n, chi, 2, chi]`` and
    ``ax [Bx, n, chi, 2, chi]`` -> real ``[By, Bx]``, by a transfer-matrix
    scan carrying ``M [By, Bx, chi, chi]``: two large batched complex
    matmuls per site block (the reference leaves this to XLA; here it is
    torch.matmul in full f32, utils/device.py, and at a reduced
    ``precision`` in complex64 kernel K7, ``ops/lowp.py``, the site
    pre-combination included)."""
    By, Bx = ay.shape[0], ax.shape[0]
    chi = max(ay.shape[2], ax.shape[2])

    def grow(t):
        c = t.shape[2]
        return t if c == chi else torch.nn.functional.pad(t, (0, chi - c, 0, 0, 0, chi - c))

    ay, ax = grow(ay), grow(ax)
    m = torch.zeros((By, Bx, chi, chi), dtype=ax.dtype, device=ax.device)
    m[:, :, 0, 0] = 1.0

    k = site_block
    gy, ty_tail = _combine_sites(ay, k, precision) if k > 1 else (ay, None)
    gx, tx_tail = _combine_sites(ax, k, precision) if k > 1 else (ax, None)
    if gy is not None:
        p = gy.shape[3]
        for i in range(gy.shape[1]):
            m = tile_step(m, gy[:, i], gx[:, i], p, precision)
    if ty_tail is not None:
        m = tile_step(m, ty_tail, tx_tail, ty_tail.shape[2], precision)
    ov = m[:, :, 0, 0]
    return ov.real * ov.real + ov.imag * ov.imag

