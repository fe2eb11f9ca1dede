"""Batched circuit simulation over the tracked op stream, and the Gram-tile
overlaps (port of ``qml_cutensornet_tpu/models/simulate.py``:
``apply_schedule_op``, ``stream_chunk_plan``, the chunked stream simulator,
``state_norms_sq``, ``_combine_sites``, ``tile_overlaps_sq``).

The op stream is shared by every datapoint of a batch, so the batch is a
leading tensor dimension and the stream is a Python loop: each op is one
batched update (one kernel launch for its factorization). The stream is
cut into chunks exactly as the reference cuts it, padded with the same
neutral ops (identity center moves, exact no-ops for the state), and each
chunk runs at the same staged bond cap, so the port performs the same
operations at the same shapes as the reference.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import (
    GATE_I,
    GATE_RX,
    GATE_RZ1,
    GATE_XX,
    GATE_XXSW,
    GATE_ZZ,
    GateSchedule,
)
from qml_cutensornet_tpu_torch.ops import gates, mps as mps_ops
from qml_cutensornet_tpu_torch.ops.mps import MPS


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
        return mps_ops.apply_1q(state, site, mat)
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


def make_chunked_simulator(schedule: GateSchedule, cfg: SimConfig, device: torch.device,
                           chunk_len: int | None = None, staged: bool | None = None):
    """``simulate(features [B, n]) -> MPS`` over the tracked op stream, in
    chunks of ``chunk_len`` ops (``QMLTPU_CHUNK_LEN``, default 128) with the
    staged bond cap (``QMLTPU_STAGED``, default on): each chunk runs at the
    smallest power-of-two chi that holds its structural bond bound, which
    is exactly equivalent to running at ``cfg.chi`` throughout."""
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
            state = mps_ops.apply_1q_all(state, gates.hadamard(rdt, device))
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


def state_norms_sq(a: torch.Tensor) -> torch.Tensor:
    """``<psi_b|psi_b>`` for ``a [B, n, chi, 2, chi]`` -> real ``[B]``."""
    B, n, chi = a.shape[0], a.shape[1], a.shape[2]
    m = torch.zeros((B, chi, chi), dtype=a.dtype, device=a.device)
    m[:, 0, 0] = 1.0
    for i in range(n):
        t = a[:, i]
        tm = torch.einsum("zab,zbsd->zasd", m, t)
        m = torch.einsum("zasc,zasd->zcd", t.conj(), tm)
    return m[:, 0, 0].real


def _combine_sites(a: torch.Tensor, k: int):
    """Pre-contract runs of ``k`` adjacent sites into physical-dim ``2^k``
    blocks: ``[B, n, chi, 2, chi] -> ([B, n//k, chi, 2^k, chi], tail
    [B, chi, 2^rem, chi] | None)``."""
    b, n, chi = a.shape[0], a.shape[1], a.shape[2]
    g, rem = n // k, n % k

    def combine(u, t):
        out = torch.einsum("...xpy,...ytz->...xptz", u, t)
        return out.reshape(*out.shape[:-4], chi, out.shape[-3] * 2, chi)

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


def tile_overlaps_sq(ay: torch.Tensor, ax: torch.Tensor, site_block: int = 1) -> torch.Tensor:
    """All-pairs ``|<y_i|x_j>|^2`` between ``ay [By, n, chi, 2, chi]`` and
    ``ax [Bx, n, chi, 2, chi]`` -> real ``[By, Bx]``, by a transfer-matrix
    scan carrying ``M [By, Bx, chi, chi]``: two large batched complex
    matmuls per site block (the reference leaves this to XLA; here it is
    torch.matmul in full f32, utils/device.py)."""
    By, Bx = ay.shape[0], ax.shape[0]
    chi = max(ay.shape[2], ax.shape[2])

    def grow(t):
        c = t.shape[2]
        return t if c == chi else torch.nn.functional.pad(t, (0, chi - c, 0, 0, 0, chi - c))

    ay, ax = grow(ay), grow(ax)
    m = torch.zeros((By, Bx, chi, chi), dtype=ax.dtype, device=ax.device)
    m[:, :, 0, 0] = 1.0

    def step(m, ty, tx, p):
        # T[x, (y a), (s d)] = sum_b M[x, (y a), b] Tx[x, b, (s d)]
        mx = m.transpose(0, 1).reshape(Bx, By * chi, chi)
        t1 = mx @ tx.reshape(Bx, chi, p * chi)
        # regroup [x, (y a), (s d)] -> [y, (a s), (x d)]
        t2 = (t1.reshape(Bx, By, chi, p, chi).permute(1, 2, 3, 0, 4)
              .reshape(By, chi * p, Bx * chi))
        m2 = ty.reshape(By, chi * p, chi).mH @ t2  # [By, chi, Bx*chi]
        return m2.reshape(By, chi, Bx, chi).transpose(1, 2)

    k = site_block
    gy, ty_tail = _combine_sites(ay, k) if k > 1 else (ay, None)
    gx, tx_tail = _combine_sites(ax, k) if k > 1 else (ax, None)
    if gy is not None:
        p = gy.shape[3]
        for i in range(gy.shape[1]):
            m = step(m, gy[:, i], gx[:, i], p)
    if ty_tail is not None:
        m = step(m, ty_tail, tx_tail, ty_tail.shape[2])
    ov = m[:, :, 0, 0]
    return ov.real * ov.real + ov.imag * ov.imag

