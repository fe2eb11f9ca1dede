"""Kernels K1 (fused subspace split), K4 (gate + theta build + split) and K5
(the fused brick pair update), and their plain PyTorch versions.

Port of ``qml_cutensornet_tpu/ops/pallas_split.py`` (``_make_split_kernel``
/ ``_split_chain``). For each ``theta[b] [m, k]`` and the shared start
block ``v0 [m, nc]``, :func:`subspace_factor` runs ``iters`` power
iterations in the inter-orthonormalized double-multiply form

    w = orth(theta^H v)      v = orth(theta w)      (v = v0 at first)

and returns ``q = v [B, m, nc]`` (a masked isometry approximating the top
left singular subspace; zero columns exactly zero) and ``r = q^H theta
[B, nc, k]``. ``orth`` is the BCGS2 orthonormalizer of ``ops/orth.py``.

:func:`gate_subspace_factor` is the port of ``_make_gate_split_kernel``
(with ``_gate_combine``): it takes the two site tensors as ``A [B, 2chi,
chi]`` (rows ``(u, alpha)`` u-major) and ``Bm [B, chi, 2chi]`` (columns
``(v, beta)`` v-major) and the gate ``g [B, 4, 4]`` (``g[2s+t, 2u+v]``),
builds ``theta[(s alpha), (t beta)] = sum_uv g[2s+t, 2u+v] (A Bm)[(u alpha),
(v beta)]`` and runs the same chain on it, returning ``(q [B, 2chi, nc],
r [B, nc, 2chi], tot [B], resid [B])`` with ``tot = ||theta||_F^2`` and
``resid = ||theta - q r||_F^2``, the weight the ``nc`` directions miss
(theta itself is not returned: the truncation mask needs only its weight,
and the kept fraction these two and ``r``'s row norms,
``ops/svd._kept_fraction``).


:func:`brick_gate_split` is the port of ``_make_brick_split_kernel`` (the
Hastings pair update of the brick engine, ``ops/vidal.py``). From the same
``A``, ``Bm`` and ``g`` and the left-bond Schmidt weights ``lam [B, chi]``
it builds ``theta_t`` (gate applied, unweighted) and ``theta_w =
diag(lam, lam) theta_t`` (rows ``(s alpha)`` weighted by ``lam[alpha]``),
runs the same chain on ``theta_w^H`` (so its basis spans the top right
singular subspace of ``theta_w``) and returns ``(q2 [B, nc, 2chi], na0
[B, nc, 2chi], s2 [B, nc], total [B], resid [B])``: ``q2`` the basis as rows
(``V = conj(q2)``), ``na0`` the rows of ``theta_t q`` (= ``(theta_t V^H)^T``,
no lambda inverse), ``s2`` the squared norms ``||theta_w q_j||^2``, ``total =
||theta_w||_F^2`` and ``resid = ||theta_w^H - q r||_F^2`` with ``q =
q2^T`` and ``r = q^H theta_w^H``.

Routing: a CPU tensor runs the plain version; a CUDA tensor runs the CUDA
kernel (``csrc/subspace_split.cu``, ``csrc/gate_split.cu`` and
``csrc/brick_split.cu``, all three on the chain of ``csrc/block_chain.cuh``,
launched as :func:`split_plan`, :func:`gate_split_plan` and
:func:`brick_split_plan` say) or raises. The kernels take nc <= 128, m, k <=
256 (chi <= 128), iters >= 1, in complex64 (complex128 runs the double
instantiation). Each takes ``pair`` (``SimConfig.mgs_pair``): the block-2
in-panel step of ``ops/orth.bcgs2_plain`` in every orthonormalization of the
chain, from the pair libraries in complex64; in complex128 it changes
nothing.
"""

from __future__ import annotations

import dataclasses

import torch

from qml_cutensornet_tpu_torch.ops import _block, _build
from qml_cutensornet_tpu_torch.ops.orth import _check_input, abs2, bcgs2_plain

MAX_NC = 128
MAX_MK = 256


def _chain_plain(theta: torch.Tensor, v0: torch.Tensor, iters: int, pair: bool):
    """The double-multiply chain with the plain BCGS2."""
    v = v0.expand(theta.shape[0], *v0.shape)
    for _ in range(iters):
        w = bcgs2_plain(theta.mH @ v, pair)
        v = bcgs2_plain(theta @ w, pair)
    return v, v.mH @ theta


def residual_norm2(theta: torch.Tensor, q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``||theta - q r||_F^2 [B]``, the weight a split's directions miss."""
    return torch.view_as_real(torch.baddbmm(theta, q, r, alpha=-1)).square().sum((1, 2, 3))


def subspace_factor_plain(theta: torch.Tensor, v0: torch.Tensor, iters: int,
                          pair: bool = False):
    """Plain version of K1."""
    if theta.is_cuda:
        _build.PLAIN_ON_CUDA["split"] += 1
    return _chain_plain(theta, v0, iters, pair)


def subspace_factor(theta: torch.Tensor, v0: torch.Tensor, iters: int, pair: bool = False):
    """``theta [B, m, k]``, ``v0 [m, nc]`` -> ``(q [B, m, nc], r [B, nc, k])``:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    if theta.device.type == "cpu":
        return subspace_factor_plain(theta, v0, iters, pair)
    return subspace_factor_cuda(theta, v0, iters, pair)


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How K1 is launched (``csrc/subspace_split.cu``, ``SplitPlan`` of
    ``csrc/block_chain.cuh``): ``grid`` blocks of ``threads``, one block per
    batch element; theta in shared memory (``theta_smem``) or read from global
    memory; the working rows W and V in shared memory (``rows_smem``), one
    buffer for both (``inplace``), or a per-element global scratch buffer of
    ``scratch_cx`` complex elements; ``smem_bytes`` of dynamic shared memory
    per block."""

    threads: int
    grid: int
    theta_smem: bool
    rows_smem: bool
    inplace: bool
    smem_bytes: int
    scratch_cx: int


def _plan(B: int, m: int, k: int, nc: int, dtype: torch.dtype, smem_optin: int,
          stage: int, what: str, pair: bool) -> SplitPlan:
    """The first of K1's placements (theta and rows in shared memory; the
    same with one buffer for W and V; theta in global memory and the rows in
    shared memory, two buffers or one; everything in global memory, the
    products' operands staged through shared memory) that fits, with
    ``stage`` bytes over the rows and the orthonormalizer's work (0 for K1;
    the theta build's slabs for K4 and K5), and the in-panel step's static
    slots (twice as large with ``pair``). One buffer needs one-pass
    products (:func:`_block.inplace_ok`)."""
    cx = _block.cx_bytes(dtype)
    work = _block.orth_work_bytes(nc, dtype)
    static = _block.static_smem_bytes(dtype, pair)
    theta = m * (k + 1) * cx
    rows_two = nc * (k + 1 + m + 1) * cx
    rows_one = nc * (max(m, k) + 1) * cx
    one_ok = _block.inplace_ok(m, k, nc)
    # Without the rows in shared memory (theta in global memory too) the
    # products stage their operands through shared memory, in the space of
    # the orthonormalizer's work.
    slab = max(_block.staged_slab_bytes(m, dtype), _block.staged_slab_bytes(k, dtype))
    options = ((True, True, False, theta, rows_two), (True, True, True, theta, rows_one),
               (False, True, False, 0, rows_two), (False, True, True, 0, rows_one),
               (False, False, False, 0, 0))
    for th, rows, inplace, th_bytes, rows_bytes in options:
        nbytes = th_bytes + max(rows_bytes + work if rows else max(work, slab), stage)
        if (one_ok or not inplace) and nbytes + static <= smem_optin:
            return SplitPlan(_block.NT, B, th, rows, inplace, nbytes,
                             0 if rows else nc * (k + 1 + m + 1))
    raise ValueError(f"{what}: no launch plan fits {smem_optin} bytes of shared memory "
                     f"(m={m}, k={k}, nc={nc}, {dtype})")


def split_plan(B: int, m: int, k: int, nc: int, dtype: torch.dtype,
               smem_optin: int, pair: bool = False) -> SplitPlan:
    """K1's launch plan, a pure function of the shapes, the dtype and the
    shared memory a block may opt in to: the first of (theta and rows in
    shared memory; the same with one buffer for W and V; theta in global
    memory and the rows in shared memory, two buffers or one; everything in
    global memory) that fits. One buffer needs one-pass products
    (:func:`_block.inplace_ok`)."""
    return _plan(B, m, k, nc, dtype, smem_optin, 0, "split", pair)


def gate_split_plan(B: int, chi: int, nc: int, dtype: torch.dtype,
                    smem_optin: int, pair: bool = False) -> SplitPlan:
    """K4's launch plan (``csrc/gate_split.cu``): K1's placements on theta
    ``[2chi, 2chi]``, theta built in place (``theta_smem``: ``[2chi][2chi +
    1]`` in shared memory, else ``[2chi][2chi]`` in the element's global
    scratch, counted in ``scratch_cx``), the theta build's slabs over the rows
    and the work (:func:`_block.build_stage_bytes`). At chi 32 and 64 in
    complex64 it is K1's plan."""
    m = 2 * chi
    plan = _plan(B, m, m, nc, dtype, smem_optin, _block.build_stage_bytes(chi, dtype),
                 "gate_split", pair)
    return dataclasses.replace(plan, scratch_cx=plan.scratch_cx + (0 if plan.theta_smem
                                                                    else m * m))


def brick_split_plan(B: int, chi: int, nc: int, dtype: torch.dtype,
                     smem_optin: int, pair: bool = False) -> SplitPlan:
    """K5's launch plan (``csrc/brick_split.cu``): K4's, ``theta_smem``
    placing theta_w^H (the chain's theta), plus the unweighted theta_t^T
    ``[2chi][2chi]`` that always lives in the element's global scratch."""
    plan = gate_split_plan(B, chi, nc, dtype, smem_optin, pair)
    return dataclasses.replace(plan, scratch_cx=plan.scratch_cx + 4 * chi * chi)


def subspace_factor_cuda(theta: torch.Tensor, v0: torch.Tensor, iters: int, pair: bool = False,
                         smem_bytes: int | None = None):
    """Launch K1, from the pair library with ``pair`` in complex64.
    ``smem_bytes`` overrides the plan's dynamic shared memory request (used
    only to test the launch-error path)."""
    dbl = _check_input(theta, "split")
    _check_input(v0, "split v0")
    if theta.dim() != 3 or v0.dim() != 2 or v0.shape[0] != theta.shape[1]:
        raise ValueError(f"split: expected theta [B, m, k] and v0 [m, nc]; got "
                         f"{tuple(theta.shape)} and {tuple(v0.shape)}")
    if v0.dtype != theta.dtype or v0.device != theta.device:
        raise ValueError("split: theta and v0 must share dtype and device")
    B, m, k = theta.shape
    nc = v0.shape[1]
    if not (1 <= nc <= MAX_NC and 1 <= m <= MAX_MK and 1 <= k <= MAX_MK and iters >= 1):
        raise ValueError(f"split: kernel takes nc <= {MAX_NC}, m, k <= {MAX_MK}, iters >= 1;"
                         f" got m={m}, k={k}, nc={nc}, iters={iters}")
    pair = _block.pair_step(pair, theta.dtype)
    lib = _build.load(pair)
    plan = split_plan(B, m, k, nc, theta.dtype, _build.smem_optin(theta.device.index), pair)
    q = torch.empty((B, m, nc), dtype=theta.dtype, device=theta.device)
    r = torch.empty((B, nc, k), dtype=theta.dtype, device=theta.device)
    scratch = torch.empty((B, plan.scratch_cx), dtype=theta.dtype, device=theta.device)
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    rc = lib.qk_split_launch(theta.data_ptr(), v0.data_ptr(), q.data_ptr(), r.data_ptr(),
                             scratch.data_ptr(), B, m, k, nc, int(iters), int(dbl),
                             int(plan.rows_smem),
                             plan.smem_bytes if smem_bytes is None else smem_bytes, stream,
                             int(plan.theta_smem), int(plan.inplace))
    _build.check(rc, "split kernel launch")
    _build.count_launch("split", pair)
    return q, r


def gate_theta(A: torch.Tensor, Bm: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``theta [B, 2chi, 2chi]`` of the gate applied to the pair, from the
    u-major / v-major stacks: the 4 x 4 combine over the four chi x chi
    quadrants of ``A @ Bm``."""
    B, m, chi = A.shape
    t0 = (A @ Bm).reshape(B, 2, chi, 2, chi)
    theta = torch.einsum("zstuv,zuavb->zsatb", g.reshape(B, 2, 2, 2, 2), t0)
    return theta.reshape(B, m, m)


def gate_subspace_factor_plain(A, Bm, g, v0, iters: int, pair: bool = False):
    """Plain version of K4."""
    if A.is_cuda:
        _build.PLAIN_ON_CUDA["gate_split"] += 1
    theta = gate_theta(A, Bm, g)
    tot = abs2(theta).sum((1, 2))
    q, r = _chain_plain(theta, v0, iters, pair)
    return q, r, tot, residual_norm2(theta, q, r)


def gate_subspace_factor(A, Bm, g, v0, iters: int, pair: bool = False):
    """``A [B, 2chi, chi]``, ``Bm [B, chi, 2chi]``, ``g [B, 4, 4]``, ``v0
    [2chi, nc]`` -> ``(q [B, 2chi, nc], r [B, nc, 2chi], tot [B], resid
    [B])``: kernel K4 for CUDA tensors, its plain version for CPU tensors."""
    if A.device.type == "cpu":
        return gate_subspace_factor_plain(A, Bm, g, v0, iters, pair)
    return gate_subspace_factor_cuda(A, Bm, g, v0, iters, pair)


def _check_gate_feeds(A, Bm, g, v0, iters: int, what: str):
    """Device, dtype and shape checks of the ``A, Bm, g, v0`` feeds of K4 and
    K5; returns ``(dbl, B, chi, nc)``."""
    dbl = _check_input(A, f"{what} A")
    for t, name in ((Bm, "B"), (g, "g"), (v0, "v0")):
        _check_input(t, f"{what} {name}")
        if t.dtype != A.dtype or t.device != A.device:
            raise ValueError(f"{what}: A, B, g and v0 must share dtype and device")
    if A.dim() != 3 or A.shape[1] != 2 * A.shape[2]:
        raise ValueError(f"{what}: expected A [B, 2chi, chi], got {tuple(A.shape)}")
    B, m, chi = A.shape
    if tuple(Bm.shape) != (B, chi, m) or tuple(g.shape) != (B, 4, 4) or (
            v0.dim() != 2 or v0.shape[0] != m):
        raise ValueError(f"{what}: expected B [B, chi, 2chi], g [B, 4, 4], v0 [2chi, nc]; "
                         f"got {tuple(Bm.shape)}, {tuple(g.shape)}, {tuple(v0.shape)}")
    nc = v0.shape[1]
    if not (1 <= nc <= MAX_NC and 1 <= m <= MAX_MK and iters >= 1):
        raise ValueError(f"{what}: kernel takes nc <= {MAX_NC}, 2chi <= {MAX_MK}, "
                         f"iters >= 1; got chi={chi}, nc={nc}, iters={iters}")
    return dbl, B, chi, nc


def gate_subspace_factor_cuda(A, Bm, g, v0, iters: int, pair: bool = False,
                              smem_bytes: int | None = None):
    """Launch K4 as :func:`gate_split_plan` says, from the pair library with
    ``pair`` in complex64. ``smem_bytes`` overrides the plan's dynamic
    shared memory request (used only to test the launch-error path)."""
    dbl, B, chi, nc = _check_gate_feeds(A, Bm, g, v0, iters, "gate_split")
    m = 2 * chi
    pair = _block.pair_step(pair, A.dtype)
    lib = _build.load(pair)
    plan = gate_split_plan(B, chi, nc, A.dtype, _build.smem_optin(A.device.index), pair)
    q = torch.empty((B, m, nc), dtype=A.dtype, device=A.device)
    r = torch.empty((B, nc, m), dtype=A.dtype, device=A.device)
    tot = torch.empty(B, dtype=A.real.dtype, device=A.device)
    resid = torch.empty(B, dtype=A.real.dtype, device=A.device)
    scratch = torch.empty((B, plan.scratch_cx), dtype=A.dtype, device=A.device)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    rc = lib.qk_gate_split_launch(A.data_ptr(), Bm.data_ptr(), g.data_ptr(), v0.data_ptr(),
                                  q.data_ptr(), r.data_ptr(), tot.data_ptr(), resid.data_ptr(),
                                  scratch.data_ptr(), B, chi, nc, int(iters), int(dbl),
                                  int(plan.theta_smem), int(plan.rows_smem), int(plan.inplace),
                                  plan.smem_bytes if smem_bytes is None else smem_bytes, stream)
    _build.check(rc, "gate_split kernel launch")
    _build.count_launch("gate_split", pair)
    return q, r, tot, resid


def brick_gate_split_plain(A, Bm, g, lam, v0, iters: int, pair: bool = False):
    """Plain version of K5: ``theta_t`` by :func:`gate_theta`, the lambda
    row weight, the chain on ``theta_w^H``, then ``s2``, ``na0`` and the
    residual."""
    if A.is_cuda:
        _build.PLAIN_ON_CUDA["brick_split"] += 1
    theta_t = gate_theta(A, Bm, g)
    theta_w = theta_t * torch.cat([lam, lam], 1)[:, :, None]
    total = abs2(theta_w).sum((1, 2))
    theta_h = theta_w.mH
    q, r = _chain_plain(theta_h, v0, iters, pair)  # q [B, 2chi, nc]: columns of the basis
    return q.mT, (theta_t @ q).mT, abs2(r).sum(2), total, residual_norm2(theta_h, q, r)


def brick_gate_split(A, Bm, g, lam, v0, iters: int, pair: bool = False):
    """``A [B, 2chi, chi]``, ``Bm [B, chi, 2chi]``, ``g [B, 4, 4]``, ``lam
    [B, chi]`` (real), ``v0 [2chi, nc]`` -> ``(q2 [B, nc, 2chi], na0 [B, nc,
    2chi], s2 [B, nc], total [B], resid [B])``: kernel K5 for CUDA tensors,
    its plain version for CPU tensors."""
    if A.device.type == "cpu":
        return brick_gate_split_plain(A, Bm, g, lam, v0, iters, pair)
    return brick_gate_split_cuda(A, Bm, g, lam, v0, iters, pair)


def brick_gate_split_cuda(A, Bm, g, lam, v0, iters: int, pair: bool = False,
                          smem_bytes: int | None = None):
    """Launch K5 as :func:`brick_split_plan` says, from the pair library with
    ``pair`` in complex64. ``smem_bytes`` overrides the plan's dynamic
    shared memory request (used only to test the launch-error path)."""
    dbl, B, chi, nc = _check_gate_feeds(A, Bm, g, v0, iters, "brick_split")
    if lam.device != A.device or lam.dtype != A.real.dtype or tuple(lam.shape) != (B, chi) or (
            not lam.is_contiguous()):
        raise ValueError(f"brick_split: expected a contiguous real lam [B, chi] of A's real "
                         f"dtype on A's device; got {tuple(lam.shape)} {lam.dtype} {lam.device}")
    m = 2 * chi
    pair = _block.pair_step(pair, A.dtype)
    lib = _build.load(pair)
    plan = brick_split_plan(B, chi, nc, A.dtype, _build.smem_optin(A.device.index), pair)
    q2 = torch.empty((B, nc, m), dtype=A.dtype, device=A.device)
    na0 = torch.empty((B, nc, m), dtype=A.dtype, device=A.device)
    s2 = torch.empty((B, nc), dtype=lam.dtype, device=A.device)
    total = torch.empty(B, dtype=lam.dtype, device=A.device)
    resid = torch.empty(B, dtype=lam.dtype, device=A.device)
    scratch = torch.empty((B, plan.scratch_cx), dtype=A.dtype, device=A.device)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    rc = lib.qk_brick_split_launch(A.data_ptr(), Bm.data_ptr(), g.data_ptr(), lam.data_ptr(),
                                   v0.data_ptr(), q2.data_ptr(), na0.data_ptr(), s2.data_ptr(),
                                   total.data_ptr(), resid.data_ptr(), scratch.data_ptr(), B, chi,
                                   nc, int(iters),
                                   int(dbl), int(plan.theta_smem), int(plan.rows_smem),
                                   int(plan.inplace),
                                   plan.smem_bytes if smem_bytes is None else smem_bytes, stream)
    _build.check(rc, "brick_split kernel launch")
    _build.count_launch("brick_split", pair)
    return q2, na0, s2, total, resid
