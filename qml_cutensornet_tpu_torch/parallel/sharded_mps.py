"""Site-sharded brick evolution: one MPS split over the ranks of a site mesh
(port of ``qml_cutensornet_tpu/parallel/sharded_mps.py``).

At large (n, chi) the working set of the evolution (each layer's thetas and
factorization workspaces, several times the state) outgrows one device
before the state at rest does. This engine shards the brick engine's site
axis over the ``sp`` ranks of a site mesh (``parallel.mesh.make_site_mesh``), so that
evolution memory and factorization work scale with the rank count.

reference (one controller, ``shard_map``)  | this module (one process per device)
-------------------------------------------+----------------------------------------
``tensors [B, n_s, chi, 2, chi]`` sharded   | rank ``d`` of a row holds ``[B, n_loc,
over ``sp``; 2-D ``(dp, sp)`` also shards   | chi, 2, chi]``, sites ``[d n_loc, (d+1)
the batch over ``dp``                       | n_loc)``, of its row's batch share
halo ``ppermute``s                          | ``batch_isend_irecv`` between neighbour
                                            | ranks (``parallel/gram._sendrecv``)
``fid [ndev, B]`` sharded partials          | the rank's partial product ``[B]``
replicated output by ``out_sharding``       | ``all_gather`` over the row (and over
                                            | the column on a 2-D mesh)

Layout of a rank's state: ``n_s`` rounds the padded site count up to a
multiple of ``2 sp`` with dummy product sites (exact e0 bonds), so every rank
holds ``n_loc = n_s / sp`` sites and ``K_loc = n_loc / 2`` pairs of either
parity. ``lams [B, n_loc, chi]``: ``lams[:, i]`` is the bond right of local
site ``i``. ``bond_dims [B, n_loc]`` likewise. ``fidelity [B]`` is the
product of the kept fractions of the rank's own active pairs; the state's is
the product over the row, taken once in the finalize step.

A brick layer makes three transfers, each one send and one receive posted
together and waited on: the right neighbour's first site comes in (the
halo; the last parity-1 pair straddles the boundary and updates it), the
left neighbour's last lambda comes in (the first parity-0 pair's left
weights), and after the local pairs the halo goes back right, where it is
the new first site on parity-1 layers only (on parity 0 that site was
updated locally). The wrap pair (the last rank's parity-1 straddler) is
always inactive, because ``n_p`` is odd and so ``n_s > n_p``: the halo that
returns to rank 0 is its own first site, unchanged.

Stage plans, chunk plans and the per-pair update (``ops/vidal.update_pairs``:
kernel K5 where the stage takes it, else the pair product and K1; at a
reduced ambient class ``cfg.matmul_precision`` the products on kernel K7
and the split's orthonormalizations on K3, as in the whole chain) are the
whole-chain engine's, driven by the same ``models/simulate.
drive_brick_schedule``, so the two engines do identical per-pair arithmetic.

The Gram of site-sharded states is a relay (:func:`sharded_tile_overlaps_sq`):
a tile's transfer-matrix carry passes from rank to rank, each applying its
site block, with the tiles pipelined down the row.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import BrickSchedule
from qml_cutensornet_tpu_torch.models.simulate import (
    BRICK_LAYER_CHUNK,
    BrickStageFns,
    brick_chunk_plan,
    brick_stage_plan,
    drive_brick_schedule,
    tile_step,
)
from qml_cutensornet_tpu_torch.ops import gates, lowp, vidal
from qml_cutensornet_tpu_torch.ops.mps import MPS
from qml_cutensornet_tpu_torch.parallel.gram import _sendrecv
from qml_cutensornet_tpu_torch.parallel.mesh import (
    Mesh,
    gather_along,
    make_site_mesh,
    maybe_distributed_init,
)


@dataclasses.dataclass
class ShardedVidalState:
    """One rank's block of a site-sharded brick-engine state (module
    docstring)."""

    tensors: torch.Tensor  # [B, n_loc, chi, 2, chi] complex
    lams: torch.Tensor  # [B, n_loc, chi] real
    fidelity: torch.Tensor  # [B] real, this rank's partial product
    bond_dims: torch.Tensor  # [B, n_loc] int32


def padded_sites_for(n_p: int, ndev: int) -> int:
    """Smallest multiple of ``2 * ndev`` >= ``n_p``. ``n_p`` is odd, so the
    result always exceeds it (the wrap pair stays inactive)."""
    step = 2 * ndev
    return ((n_p + step - 1) // step) * step


def _neighbours(mesh: Mesh) -> tuple[int, int]:
    """Global ranks of the left and right neighbour in the row (a ring)."""
    return mesh.peer(mesh.col - 1), mesh.peer(mesh.col + 1)


def _layer_local(state: ShardedVidalState, par: int, sw: float, act: torch.Tensor,
                 th: torch.Tensor, cfg: SimConfig, mesh: Mesh) -> ShardedVidalState:
    """One brick layer on this rank's site block: ``act [K_loc]`` bool,
    ``th [B, K_loc]`` angles of the rank's pairs, at left offsets ``par + 2j``."""
    sites, lams, bdims = state.tensors, state.lams, state.bond_dims
    B, n_loc, chi = sites.shape[0], sites.shape[1], sites.shape[2]
    k_total = act.shape[0]
    left, right = _neighbours(mesh)

    # Halo in: the right neighbour's first site, the left neighbour's last lambda.
    halo_site = _sendrecv(mesh, sites[:, :1], left, right)
    halo_lam = _sendrecv(mesh, lams[:, -1:], right, left)
    ext = torch.cat([sites, halo_site], dim=1)
    lam_ext = torch.cat([halo_lam, lams], dim=1)  # [j]: the bond left of site j

    fid = state.fidelity
    kc = vidal._pair_chunk(k_total, chi, B)
    for k0 in range(0, k_total, kc):
        hi = min(k_total, k0 + kc)
        idx = par + 2 * (k0 + torch.arange(hi - k0, device=sites.device))  # left offsets
        a, b = ext.index_select(1, idx), ext.index_select(1, idx + 1)
        new_a, new_b, s, kf, rank = vidal.update_pairs(a, b, lam_ext.index_select(1, idx),
                                                       th[:, k0:hi], sw, cfg)
        am = act[k0:hi][None, :]
        ext[:, idx] = torch.where(am[:, :, None, None, None], new_a, a)
        ext[:, idx + 1] = torch.where(am[:, :, None, None, None], new_b, b)
        # The pair at left offset o writes local bond o.
        lams[:, idx] = torch.where(am[:, :, None], s, lams.index_select(1, idx))
        bdims[:, idx] = torch.where(am, rank, bdims.index_select(1, idx)).to(torch.int32)
        fid = fid * torch.prod(torch.where(am, kf, torch.ones_like(kf)), dim=1).to(fid.dtype)

    # Halo out: the (possibly updated) halo back to the right neighbour, our
    # new first site on parity-1 layers only.
    back = _sendrecv(mesh, ext[:, n_loc:], right, left)
    first = back if par == 1 else ext[:, :1]
    return ShardedVidalState(tensors=torch.cat([first, ext[:, 1:n_loc]], dim=1), lams=lams,
                             fidelity=fid, bond_dims=bdims)


def make_sharded_brick_simulator(schedule: BrickSchedule, cfg: SimConfig, mesh: Mesh,
                                 layer_chunk: int = BRICK_LAYER_CHUNK, gather: bool = True,
                                 staged: bool | None = None):
    """The site-sharded counterpart of ``models/simulate.make_brick_simulator``:
    ``simulate(features [B, n]) -> MPS`` with the state's sites sharded over
    the row of ``mesh`` during the evolution, on the mesh's device. Every
    rank of the mesh calls it with the same features. On a 2-D mesh each row
    takes ``B / dp`` rows of the batch (``B`` a multiple of ``dp``).

    ``gather=True`` returns the real-site MPS on every rank (``all_gather``
    over the row, and over the column on a 2-D mesh). ``gather=False`` (1-D
    mesh only) returns the rank's block in the padded ``n_s`` frame (real
    sites at global ``1..n``, dummies included) with the state's fidelity,
    for :func:`sharded_tile_overlaps_sq`."""
    if not gather and mesh.dp != 1:
        raise ValueError("gather=False wants a 1-D site mesh.")
    if staged is None:
        staged = os.environ.get("QMLTPU_STAGED", "1") != "0"
    ndev, dev = mesh.size, mesh.device
    n, n_p = schedule.num_qubits, schedule.num_sites_padded
    n_s = padded_sites_for(n_p, ndev)
    n_loc, K_s = n_s // ndev, n_s // 2
    k_lo, k_hi = mesh.col * (n_loc // 2), (mesh.col + 1) * (n_loc // 2)  # this rank's pairs
    off = mesh.col * n_loc  # global index of the first local site
    real_lo, real_hi = max(0, 1 - off), min(n_loc, n + 1 - off)  # local real sites
    rdt, gamma = cfg.real_dtype, schedule.gamma
    np_rdt = np.dtype(str(rdt).removeprefix("torch."))
    rep_stages, final_chi = brick_stage_plan(schedule, cfg, staged)
    chunks2, chunk_arrays = brick_chunk_plan(schedule, rep_stages, layer_chunk, K_s)
    fns: dict = {}

    def fns_for(chi_s: int):
        if chi_s in fns:
            return fns[chi_s]
        cfg_s = dataclasses.replace(cfg, chi=chi_s)

        def init(x):
            B = x.shape[0]
            t = torch.zeros((B, n_loc, chi_s, 2, chi_s), dtype=cfg.complex_dtype, device=dev)
            t[:, :, 0, 0, 0] = 1.0
            lams = torch.zeros((B, n_loc, chi_s), dtype=rdt, device=dev)
            lams[:, :, 0] = 1.0
            if schedule.hadamard_init and real_lo < real_hi:
                t[:, real_lo:real_hi] = lowp.matmul(gates.hadamard(rdt, dev),
                                                    t[:, real_lo:real_hi], cfg.matmul_precision)
            return ShardedVidalState(
                tensors=t, lams=lams, fidelity=torch.ones(B, dtype=rdt, device=dev),
                bond_dims=torch.ones((B, n_loc), dtype=torch.int32, device=dev))

        def rz(state, xs):
            # xs [B, n_loc] in the n_s frame, zeros on dummy sites (identity
            # phases); gamma multiplies the cast features on the device, as
            # the whole-chain engine does, so the two agree to the bit.
            ph = gates.rz_phases(gamma * xs)
            return dataclasses.replace(state, tensors=state.tensors * ph[:, :, None, :, None])

        def chunk(state, pars, sws, acts, thetas):
            for c in range(len(pars)):
                state = _layer_local(state, int(pars[c]), float(sws[c]), acts[c], thetas[c],
                                     cfg_s, mesh)
            return state

        def pad_to(state):
            old = state.tensors.shape[-1]
            pad = torch.nn.functional.pad
            return dataclasses.replace(
                state, tensors=pad(state.tensors, (0, chi_s - old, 0, 0, 0, chi_s - old)),
                lams=pad(state.lams, (0, chi_s - old)))

        def finalize(state):
            fid = torch.prod(gather_along(state.fidelity[None], 0, ndev, mesh.group), dim=0)
            if not gather:
                return MPS(tensors=state.tensors, fidelity=fid, bond_dims=state.bond_dims)
            tensors = gather_along(state.tensors, 1, ndev, mesh.group)[:, 1:n + 1]
            bond_dims = gather_along(state.bond_dims, 1, ndev, mesh.group)[:, 1:n]
            if mesh.dp > 1:
                tensors, fid, bond_dims = (gather_along(a, 0, mesh.dp, mesh.batch_group)
                                           for a in (tensors, fid, bond_dims))
            return MPS(tensors=tensors, fidelity=fid, bond_dims=bond_dims)

        fns[chi_s] = BrickStageFns(init, rz, chunk, pad_to, finalize)
        return fns[chi_s]

    def on_device(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    def rz_arg(ri, x):
        xs_s = np.zeros((x.shape[0], n_s), dtype=np_rdt)
        xs_s[:, 1:n + 1] = x[:, schedule.bricks[ri].pos_to_feature].astype(np_rdt)
        return on_device(xs_s[:, off:off + n_loc])

    def simulate(features) -> MPS:
        x = np.asarray(features, dtype=np.float64)
        if x.shape[0] % mesh.dp:
            raise ValueError(f"{x.shape[0]} rows do not split over dp = {mesh.dp}")
        rows = x.shape[0] // mesh.dp
        return drive_brick_schedule(
            x[mesh.row * rows:(mesh.row + 1) * rows], schedule, chunks2, chunk_arrays,
            layer_chunk, rdt, fns_for, rz_arg=rz_arg,
            place_acts=lambda a: on_device(a[:, k_lo:k_hi]),
            place_thetas=lambda a: on_device(a[:, :, k_lo:k_hi]), k_pad=K_s,
            final_chi=final_chi)

    return simulate


def mesh_for_knob(value: str, device) -> Mesh:
    """The site mesh that ``QMLTPU_SHARD_MPS`` names: ``"all"`` is the
    process group (initialized from the ``torchrun`` environment where there
    is one), or a mesh of one outside a group; ``N`` must equal the world
    size. Outside a group ``N > 1`` raises: it never runs on one device
    instead."""
    maybe_distributed_init(torch.device(device).type)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if value != "all":
        ndev = int(value)
        if not dist.is_initialized() and ndev > 1:
            raise RuntimeError(
                f"QMLTPU_SHARD_MPS={ndev} needs one process per device: run under torchrun "
                f"--nproc-per-node {ndev} -m qml_cutensornet_tpu_torch.cli.main ...")
        if ndev != world:
            raise ValueError(f"QMLTPU_SHARD_MPS={ndev}, but the process group has {world} ranks")
    return make_site_mesh(device=str(device))


def relay_auto_tile(chi: int, n_loc: int, dtype_bytes: int = 4) -> int:
    """Memory-bounded relay tile (the reference's rule): one stage's live set
    is the site step's intermediate (``32 tile^2 chi^2`` bytes at f32) and
    the carries (``16 tile^2 chi^2``), plus the two sliced site blocks
    (``64 tile n_loc chi^2``); both terms are bounded by
    ``QMLTPU_RELAY_TILE_BYTES`` (default 2 GiB), and the tile by 2 and 128."""
    budget = int(os.environ.get("QMLTPU_RELAY_TILE_BYTES", str(2 << 30)))
    per = 2 * dtype_bytes  # bytes of one complex element
    quad = int((budget / (24 * chi * chi * per)) ** 0.5)  # site step and carries
    lin = budget // (16 * max(n_loc, 1) * chi * chi * per)  # site blocks
    return max(2, min(128, quad, lin))


def sharded_tile_overlaps_sq(ay: torch.Tensor, ax: torch.Tensor, mesh: Mesh,
                             tile: int | None = 32, precision: str = "highest",
                             symmetric: bool = False) -> np.ndarray:
    """All-pairs ``|<y_i|x_j>|^2`` of site-sharded batches: ``ay [By, n_loc,
    chi, 2, chi]`` and ``ax [Bx, n_loc, ...]`` are this rank's blocks (the
    ``gather=False`` output of :func:`make_sharded_brick_simulator`; dummy
    sites are exact ``e0 (x) |0> (x) e0`` products, identity steps). Every
    rank of the row calls it and gets the same ``[By, Bx]`` numpy array.

    The transfer-matrix product runs over the sites in order, so it is a
    relay: the carry ``[tile, tile, chi, chi]`` passes from rank ``d`` to
    ``d + 1``, each applying its site block (:func:`models.simulate.
    tile_step`, one site a step, its products at ``precision``). The tiles
    are pipelined: at stage ``s`` rank ``d`` works tile ``s - d``, so ``T``
    tiles take ``T + D - 1`` stages on ``D`` ranks, and a rank with no tile
    at a stage only passes the carry on. The last rank emits each finished tile; at the end it
    broadcasts the assembled matrix. ``symmetric=True`` (``ay`` is ``ax``)
    computes the ``yi <= xi`` tiles and copies their transposes. ``tile``
    None takes :func:`relay_auto_tile`."""
    if mesh.dp != 1:
        raise ValueError("sharded_tile_overlaps_sq wants a 1-D site mesh.")
    ndev, d = mesh.size, mesh.col
    left, right = _neighbours(mesh)
    By, Bx, n_loc = ay.shape[0], ax.shape[0], ay.shape[1]
    chi = max(ay.shape[2], ax.shape[2])
    if tile is None:
        tile = relay_auto_tile(chi, n_loc)

    def prepare(t, rows):  # grow the bonds, pad the batch with zero states
        pad = torch.nn.functional.pad
        c = t.shape[2]
        return pad(t, (0, chi - c, 0, 0, 0, chi - c, 0, 0, 0, rows - t.shape[0]))

    byp, bxp = -(-By // tile) * tile, -(-Bx // tile) * tile
    ay, ax = prepare(ay, byp), prepare(ax, bxp)
    nyb, nxb = byp // tile, bxp // tile
    if symmetric and nyb != nxb:
        raise ValueError("symmetric=True wants ay and ax the same batch")
    tiles = [(yi, xi) for yi in range(nyb) for xi in range(nxb) if not symmetric or yi <= xi]
    n_tiles, n_stages = len(tiles), len(tiles) + ndev - 1

    real = ay.real.dtype
    out = torch.zeros((byp, bxp), dtype=real, device=ay.device)
    m = torch.zeros((tile, tile, chi, chi), dtype=ay.dtype, device=ay.device)
    for s in range(n_stages):
        t_idx = s - d
        if 0 <= t_idx < n_tiles:
            yi, xi = tiles[t_idx]
            if d == 0:
                m = torch.zeros_like(m)
                m[:, :, 0, 0] = 1.0
            ay_b = ay[yi * tile:(yi + 1) * tile]
            ax_b = ax[xi * tile:(xi + 1) * tile]
            for i in range(n_loc):
                m = tile_step(m, ay_b[:, i], ax_b[:, i], 2, precision)
            if d == ndev - 1:
                ov = m[:, :, 0, 0]
                blk = ov.real * ov.real + ov.imag * ov.imag
                out[yi * tile:(yi + 1) * tile, xi * tile:(xi + 1) * tile] = blk
                if symmetric and yi != xi:
                    out[xi * tile:(xi + 1) * tile, yi * tile:(yi + 1) * tile] = blk.T
        if s + 1 < n_stages:
            m = _sendrecv(mesh, m, right, left)
    if ndev > 1:
        dist.broadcast(out, mesh.peer(ndev - 1), group=mesh.group)
    return out[:By, :Bx].cpu().numpy()


def sharded_gram(ansatz, X, cfg: SimConfig, mesh: Mesh, tile: int | None = None) -> np.ndarray:
    """The symmetric Gram built without gathering a state: the site-sharded
    evolution (``gather=False``) and the relay. Normalized as
    ``models/gram.build_kernel_matrix`` normalizes a symmetric Gram, by its
    own diagonal (``QMLTPU_NORMALIZE=0``: the raw overlaps). Every rank of
    the row gets the same matrix."""
    sim = make_sharded_brick_simulator(ansatz.schedule, cfg, mesh, gather=False)
    st = sim(np.asarray(X, dtype=np.float64))
    k = sharded_tile_overlaps_sq(st.tensors, st.tensors, mesh, tile=tile,
                                 precision=cfg.resolved_tile_precision, symmetric=True)
    if os.environ.get("QMLTPU_NORMALIZE", "1") != "0":
        dg = np.sqrt(np.maximum(np.diag(k), 0.0))
        dg = np.where(dg > 0, dg, 1.0)
        k = k / np.outer(dg, dg)
    return k
