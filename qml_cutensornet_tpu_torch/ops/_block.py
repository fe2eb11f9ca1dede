"""The host-side shape rules of ``csrc/block_chain.cuh`` (kernels K1 to K5),
mirrored in Python so that the wrappers' launch plans are pure functions the
CPU tests can check: the block size, the GEMM's warp tiling and the bytes of
the orthonormalizer's scratch. A launch whose shared-memory request is below
what the C side computes for the same plan is refused with an error, so a
drift between the two raises instead of corrupting memory.
"""

from __future__ import annotations

import torch

NT = 512  # threads per block (``blk::NT``)
NW = NT // 32  # warps per block
TJ = TC = 4  # output rows and columns per thread of the GEMM
PANEL = 16  # columns per BCGS2 panel


def cx_bytes(dtype: torch.dtype) -> int:
    """Bytes of one complex element."""
    return 16 if dtype == torch.complex128 else 8


def gemm_tiles(nj: int, ncol: int) -> int:
    """Warp tiles of an ``[nj, ncol]`` GEMM output (``blk::gemm_tiles``)."""
    lc = 4
    while lc < 32 and lc * TC < ncol:
        lc *= 2
    jw, cw = (32 // lc) * TJ, lc * TC
    return -(-nj // jw) * -(-ncol // cw)


def inplace_ok(m: int, k: int, nc: int) -> bool:
    """K1's W and V may share one buffer: both products of the chain are one
    pass of the block's warps (``blk::split_inplace_ok``)."""
    return gemm_tiles(nc, k) <= NW and gemm_tiles(nc, m) <= NW


GW = 4  # warps of the in-panel group (``blk::GW``)


def orth_work_bytes(nvec: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of the orthonormalizer's coefficients and the
    panel's norms (``blk::orth_work_bytes``)."""
    cx = cx_bytes(dtype)
    return nvec * PANEL * cx + PANEL * (cx // 2)


def group_static_bytes(warps: int, dtype: torch.dtype, pair: bool = False) -> int:
    """Static shared memory of one in-panel group's reduction slots, two
    buffers of ``warps`` x 32 values (``mgs_panel`` / ``mgs_panel_mem``), or
    with ``pair`` (the block-2 step in complex64) of ``warps`` x 64 values
    (``mgs_panel_pair`` / ``mgs_panel_pair_mem``)."""
    slots = 64 if pair_step(pair, dtype) else 32
    return 2 * warps * slots * (cx_bytes(dtype) // 2)


def static_smem_bytes(dtype: torch.dtype, pair: bool = False) -> int:
    """Static shared memory of K1, K2, K4 and K5: the 4-warp group's
    reduction slots, one set per element count (``blk::static_smem_bytes``,
    with ``pair`` ``blk::pair_static_smem_bytes``). A plan's dynamic request
    plus this must fit the block's opt-in."""
    return 2 * group_static_bytes(GW, dtype, pair)


def pair_step(pair: bool, dtype: torch.dtype) -> bool:
    """Whether a launch runs the block-2 in-panel step: ``pair`` asked for in
    complex64. complex128 has no pair library; there the flag changes
    nothing, as in the reference, whose f64 path never reaches a kernel."""
    return pair and dtype == torch.complex64


EPL_MEM = -1  # the in-panel step on the panel in memory (``blk::EPL_MEM``)


def orth_group(m: int) -> tuple[int, int]:
    """K3's in-panel group for vectors of length ``m``: ``(warps, elements a
    lane)``, the elements held in registers (``m <= warps * 32 * elements``):
    one element a lane on 4, 8 or 16 warps up to 512, two on the whole block
    up to 1024; past that ``(NW, EPL_MEM)``, the whole block on the panel
    left in memory (``csrc/orth.cu``)."""
    for warps in (GW, 2 * GW, NW):
        if m <= warps * 32:
            return warps, 1
    if m <= 2 * NW * 32:
        return NW, 2
    return NW, EPL_MEM


KS = 16  # reduction steps per slab of the theta build (``blk::KS``)


def build_stage_bytes(chi: int, dtype: torch.dtype) -> int:
    """Shared memory of the theta build's slabs of A and B (``[KS][2chi + 1]``
    each) and its warps' partial sums (``blk::build_stage_bytes``)."""
    cx = cx_bytes(dtype)
    return 2 * KS * (2 * chi + 1) * cx + NW * (cx // 2)


RS = 16  # reduction steps per slab of the staged products (``blk::RS``)


def staged_slab_bytes(ncol: int, dtype: torch.dtype) -> int:
    """Shared memory of ``blk::gemm_staged``'s two slab buffers for an
    ``ncol``-wide output: each ``[RS][PJ + 1]`` of X's rows and ``[RS][PC +
    1]`` of Y's columns, a pass being the block's warp tiles stacked over
    the rows (``blk::staged_slab_bytes``)."""
    lc = 4
    while lc < 32 and lc * TC < ncol:
        lc *= 2
    return 2 * RS * (NW * (32 // lc) * TJ + 1 + lc * TC + 1) * cx_bytes(dtype)
