"""Reduced-precision complex products: kernel K7, its plain PyTorch version,
and :func:`matmul`, the one entry point of every product of the engine, at
the reference's ``SimConfig.matmul_precision`` (the ambient class),
``power_precision`` and ``tile_precision``.

The reference names a precision by one of JAX's seven strings and its TPU
folds them into three classes (``jax.lax.Precision``), which the port
computes as the TPU does, not as TF32:

- full (``"highest"``, ``"float32"``): f32 products accumulated in f32 (on
  the card ``torch.matmul`` with TF32 off, ``utils/device.py``);
- three passes (``"high"``, ``"bfloat16_3x"``, ``"tensorfloat32"``): each
  f32 split into a bf16 high part ``hi = bf16(x)`` (round to nearest even)
  and a bf16 low part ``lo = bf16(x - hi)``; the products ``hi*hi + hi*lo +
  lo*hi`` accumulated in f32 (about 16 of f32's 24 bits kept);
- one pass (``"bfloat16"``, ``"default"``): ``hi*hi`` accumulated in f32.

In complex128 every class is full f64, as XLA computes an f64 dot whatever
its precision: :func:`reduced_passes` is 0 there.

:func:`cgemm` ``(a, b, passes, op, op_b)`` computes ``op(a[b]) @ op_b(b[b])``
(``op`` "n": ``a`` as it is, ``[.., M, K]``; "h": its conjugate transpose,
``a`` is ``[.., K, M]``; ``op_b`` likewise, ``b`` is ``[.., K, N]`` or
``[.., N, K]``) at ``passes`` 1 or 3, over a batch of one level ``[B, r,
c]`` or two ``[B1, B2, r, c]``, each with a stride of its own. A CPU tensor
runs the plain version (:func:`cgemm_plain`); a CUDA tensor runs kernel K7
(``csrc/bf16_cgemm.cu``, :func:`cgemm_cuda`) or raises. The kernel chooses
one of its plans (:data:`PLANS`) from ``(batch, M, N, K)``; :func:`plan`
names it. The plain version splits as the kernel does and forms the same
products as f32 matrix products of the bf16 values (each product is exact
in f32: 8 x 8 mantissa bits fit in 24), summed in f32 in the reference's 4M
form (``ops/cpx.py:87-106``): four real products for each complex product.
It and the kernel differ only in the order of their f32 sums.

:func:`matmul` ``(a, b, precision, op, op_b)`` is ``op(a) @ op_b(b)`` with
``torch.matmul``'s broadcasting of the leading dimensions. At a full class
(and in complex128) it is ``torch.matmul`` itself; at a reduced class it is
one :func:`cgemm` over the broadcast batch. The reference runs its
simulators under ``jax.default_matmul_precision(cfg.matmul_precision)``, so
that every XLA dot without a precision of its own falls to the class; the
port's engine passes the class to each product that is such a dot in the
reference, and to no other (the kernels K1 to K5 and their plain versions
stay at full precision, as the reference pins its Pallas dots at HIGHEST).
Each caller names its layouts, so that the operands reach K7 as views:

- a conjugate-transposed second operand (``r^H`` of a center move, ``V^H``
  of the brick update, ``theta^H`` of the eigh route's Gram) is passed as
  it is stored, with ``op_b`` "h";
- the leading dimensions become K7's two-level batch (:func:`_batched`):
  a gate ``[B, 4, 4]`` broadcast over the bond index of theta ``[B, chi, 4,
  chi]`` has an inner stride 0, a slice of sites an outer stride of its
  own, one matrix over the whole batch strides 0;
- a lazy conjugate ``x`` (``q^H`` of a split) is passed as the stored
  ``x^H`` with the other op;
- only a matrix that is not row-major with unit column stride (a plain
  transpose), or leading dimensions that no split into two levels
  flattens, is copied, in plain torch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from qml_cutensornet_tpu_torch.ops import _build
from qml_cutensornet_tpu_torch.utils import device as _device  # noqa: F401  (full-f32 matmuls)

# The reference's precision strings and their passes (0: full precision).
PASSES = {
    "highest": 0, "float32": 0,
    "high": 3, "bfloat16_3x": 3, "tensorfloat32": 3,
    "bfloat16": 1, "default": 1,
}
OPS = ("n", "h")
_FLIP = {"n": "h", "h": "n"}


def passes(precision: str) -> int:
    """The class of a precision string: 0 (full), 3 or 1 bf16 passes."""
    if precision not in PASSES:
        raise ValueError(f"unknown precision {precision!r}; expected one of {sorted(PASSES)}")
    return PASSES[precision]


def reduced_passes(precision: str, dtype: torch.dtype) -> int:
    """The bf16 passes of a product of ``dtype`` operands at ``precision``:
    :func:`passes` in complex64, 0 in complex128 (full f64)."""
    p = passes(precision)
    return p if dtype == torch.complex64 else 0


def rel_bound(n_passes: int, k: int) -> float:
    """Bound on ``|C - C_exact|`` elementwise, relative to ``(|op(a)| @
    |b|)``, of a product at ``n_passes`` with inner dimension ``k`` (``0``:
    full f32). bf16 keeps 8 significant bits, so ``|lo| <= 2^-8 |x|`` and
    ``hi + lo`` is ``x`` to within 2^-16 of itself: a real product at three
    passes is off by at most 3 x 2^-16 of ``|x||y|`` (the dropped
    ``lo*lo``, and the rounding of each low part), at one pass by 2 x 2^-8 +
    2^-16 (each factor rounded to 8 bits); the 4M form's two real products
    of a part sum to at most ``|x||y|`` of the complex factors. The
    f32 sums add at most 2^-24 for each of a part's ``2 k`` products a pass
    and the two that combine them (a worst case: random signs give about
    its square root)."""
    split = {0: 0.0, 3: 3 * 2.0**-16, 1: 2 * 2.0**-8 + 2.0**-16}[n_passes]
    return split + (2 * k * max(n_passes, 1) + 2) * 2.0**-24


def _split(x: torch.Tensor, n_passes: int):
    """The bf16 parts of a real f32 tensor, as f32: ``(hi,)`` or ``(hi,
    lo)``."""
    hi = x.to(torch.bfloat16).float()
    if n_passes == 1:
        return (hi,)
    return hi, (x - hi).to(torch.bfloat16).float()


def _real_product(x, y, n_passes: int) -> torch.Tensor:
    """``x @ y`` of split real operands: ``hi hi`` (+ ``hi lo + lo hi``)."""
    out = x[0] @ y[0]
    if n_passes == 3:
        out = out + x[0] @ y[1] + x[1] @ y[0]
    return out


# K7's plans (``csrc/bf16_cgemm.cu``), by the id its C interface returns.
PLANS = ("thin_k", "thin_n", "small", "large_m", "large_n")


def _layout(x: torch.Tensor) -> tuple[int, int, int]:
    """``(outer stride, inner stride, row stride)`` in elements of a
    ``[batch, rows, cols]`` or ``[outer, inner, rows, cols]`` tensor whose
    rows have unit stride (an inner stride 0 for one level; a stride 0 for
    a dimension of one or a broadcast); raises on any other layout, such as
    a transpose."""
    sh, st = x.shape, x.stride()
    if sh[-1] > 1 and st[-1] != 1:
        raise ValueError(f"cgemm: each matrix must be row-major with unit column stride, got "
                         f"shape {tuple(sh)} strides {st}")
    outer = st[0] if sh[0] > 1 else 0
    inner = st[1] if len(sh) == 4 and sh[1] > 1 else 0
    return outer, inner, (st[-2] if sh[-2] > 1 else sh[-1])


def _check_args(a: torch.Tensor, b: torch.Tensor, n_passes: int, op: str, op_b: str):
    """``(M, N, K, layout of a, layout of b)`` of a valid call; raises on
    anything the kernel does not take (on either device, so that the CPU
    runs hold the callers to the kernel's layouts)."""
    if n_passes not in (1, 3):
        raise ValueError(f"cgemm: passes must be 1 or 3, got {n_passes}")
    if op not in OPS or op_b not in OPS:
        raise ValueError(f"cgemm: op and op_b must be in {OPS}, got {op!r}, {op_b!r}")
    for name, x in (("a", a), ("b", b)):
        if x.dtype != torch.complex64:
            raise TypeError(f"cgemm: {name} must be complex64, got {x.dtype}")
        if x.dim() not in (3, 4):
            raise ValueError(f"cgemm: {name} must be [batch, rows, cols] or [outer, inner, "
                             f"rows, cols], got {tuple(x.shape)}")
        if x.is_conj() or x.is_neg():
            raise ValueError(f"cgemm: {name} is a lazy conjugate or negation (the kernel "
                             f"reads the stored values); resolve it first")
    sa, sb = a.shape, b.shape
    if sa[:-2] != sb[:-2]:
        raise ValueError(f"cgemm: batch {tuple(sa[:-2])} != {tuple(sb[:-2])}")
    M, K = (sa[-1], sa[-2]) if op == "h" else (sa[-2], sa[-1])
    Kb, N = (sb[-1], sb[-2]) if op_b == "h" else (sb[-2], sb[-1])
    if Kb != K:
        raise ValueError(f"cgemm: op(a) is {M} x {K}, op_b(b) is {Kb} x {N}")
    return M, N, K, _layout(a), _layout(b)


def _operand(x: torch.Tensor, op: str):
    """The real and imaginary parts of ``op(x)``, dense."""
    if op == "h":
        return x.real.mT.contiguous(), (-x.imag.mT).contiguous()
    return x.real.contiguous(), x.imag.contiguous()


def cgemm_plain(a: torch.Tensor, b: torch.Tensor, n_passes: int, op: str = "n",
                op_b: str = "n"):
    """Plain version of K7: ``op(a) @ op_b(b)`` at ``n_passes``, the kernel's
    split and its 4M products as f32 matrix products (of dense operands, so
    that a view and its dense copy give the same bits)."""
    _check_args(a, b, n_passes, op, op_b)
    if a.is_cuda or b.is_cuda:
        _build.PLAIN_ON_CUDA["cgemm"] += 1
    ar, ai = (_split(x, n_passes) for x in _operand(a, op))
    br, bi = (_split(x, n_passes) for x in _operand(b, op_b))
    re = _real_product(ar, br, n_passes) - _real_product(ai, bi, n_passes)
    im = _real_product(ar, bi, n_passes) + _real_product(ai, br, n_passes)
    return torch.complex(re, im)


def cgemm_cuda(a: torch.Tensor, b: torch.Tensor, n_passes: int, op: str = "n",
               op_b: str = "n"):
    """Launch K7: ``c [.., M, N] = op(a) @ op_b(b)`` at ``n_passes``, one
    launch. ``a`` and ``b`` are complex64 CUDA tensors on one device, of one
    batch shape (one level or two), whose matrices are row-major with unit
    column stride (any row stride and batch strides, 0 included)."""
    M, N, K, (sa0, sa1, lda), (sb0, sb1, ldb) = _check_args(a, b, n_passes, op, op_b)
    if a.device.type != "cuda" or b.device.type != "cuda":
        raise ValueError(f"cgemm: a and b must be CUDA tensors, got devices {a.device}, "
                         f"{b.device}")
    if a.device != b.device:
        raise ValueError(f"cgemm: a on {a.device}, b on {b.device}")
    lead = a.shape[:-2]
    c = torch.empty((*lead, M, N), dtype=torch.complex64, device=a.device)
    rc = _build.load().qk_cgemm_launch(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), math.prod(lead), lead[-1] if len(lead) == 2
        else 1, M, N, K, sa0, sa1, lda, sb0, sb1, ldb, int(op == "h"), int(op_b == "h"),
        n_passes, torch._C._cuda_getCurrentRawStream(a.device.index))
    _build.check(rc, "cgemm kernel launch")
    _build.count_launch("cgemm", False)
    return c


def cgemm(a: torch.Tensor, b: torch.Tensor, n_passes: int, op: str = "n",
          op_b: str = "n") -> torch.Tensor:
    """``op(a) @ op_b(b)`` at ``n_passes`` (1 or 3): kernel K7 for CUDA
    tensors, its plain version for CPU tensors."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return cgemm_plain(a, b, n_passes, op, op_b)
    return cgemm_cuda(a, b, n_passes, op, op_b)


def plan(batch: int, m: int, n: int, k: int) -> str:
    """The name of the plan K7 takes for a product of ``batch`` matrices of
    ``[m, k] . [k, n]`` (chosen by its C interface; needs the built
    library, so a card)."""
    return PLANS[_build.load().qk_cgemm_plan(batch, m, n, k)]


def plan_attrs(name: str, n_passes: int, op: str = "n", op_b: str = "n") -> dict:
    """Registers and local (spill) bytes a thread, static and dynamic shared
    bytes and threads a block of plan ``name``'s kernel at ``n_passes`` and
    the ops (from ``cudaFuncGetAttributes``; a card)."""
    import ctypes

    out = (ctypes.c_int * 5)()
    rc = _build.load().qk_cgemm_attrs(PLANS.index(name), n_passes, int(op == "h"),
                                      int(op_b == "h"), ctypes.addressof(out))
    _build.check(rc, "cgemm kernel attributes")
    return dict(zip(("registers", "static_smem", "dynamic_smem", "threads", "local_bytes"),
                    out))


def _flat(shape, strides):
    """The one stride over which dimensions of ``shape`` and ``strides``
    flatten (0 where none has more than one element), or None."""
    dims = [(n, st) for n, st in zip(shape, strides) if n > 1]
    for (_, outer), (n, inner) in zip(dims, dims[1:]):
        if outer != inner * n:
            return None
    return dims[-1][1] if dims else 0


def _batched(a: torch.Tensor, b: torch.Tensor, batch: tuple[int, ...]):
    """``a`` and ``b`` broadcast to the leading dimensions ``batch``, as
    ``[outer, inner, rows, cols]`` views that K7 takes: ``batch`` split into
    two levels that each operand's strides flatten (one level first; a
    broadcast dimension strides 0). A matrix that is not row-major is made
    contiguous first; where no split serves both operands, both are
    copied. Strides are worked out as integers and each view made once:
    every product of the engine pays this on the host."""
    nb = len(batch)
    xs, strides = [], []
    for x in (a, b):
        if x.shape[-1] > 1 and x.stride(-1) != 1:
            x = x.contiguous()
        lead, st = x.shape[:-2], x.stride()
        pad = nb - len(lead)
        strides.append([0 if i < pad or lead[i - pad] == 1 else st[i - pad] for i in range(nb)])
        xs.append(x)
    for j in range(nb, -1, -1):
        split = [(_flat(batch[:j], st[:j]), _flat(batch[j:], st[j:])) for st in strides]
        if None not in split[0] + split[1]:
            outer, inner = math.prod(batch[:j]), math.prod(batch[j:])
            return tuple(
                x.as_strided((outer, inner, x.shape[-2], x.shape[-1]),
                             (so, si, x.stride(-2), x.stride(-1)), x.storage_offset())
                for x, (so, si) in zip(xs, split))
    n = math.prod(batch)
    return tuple(x.expand(*batch, *x.shape[-2:]).reshape(n, 1, *x.shape[-2:]) for x in xs)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str, op: str = "n",
           op_b: str = "n") -> torch.Tensor:
    """``op(a) @ op_b(b)`` at ``precision`` (one of the reference's seven
    strings): ``op`` "n" takes ``a [..., M, K]`` as it is, "h" its
    conjugate transpose (``a [..., K, M]``); ``op_b`` likewise ``b [..., K,
    N]`` or ``[..., N, K]``; the leading dimensions broadcast as
    ``torch.matmul``'s do. At a full class, and in complex128 at every
    class, ``torch.matmul`` (full f32, TF32 off); at a reduced one,
    :func:`cgemm` (kernel K7 on CUDA tensors, its plain version on CPU
    tensors) over the broadcast batch, in the layouts of the module
    docstring."""
    if op not in OPS or op_b not in OPS:
        raise ValueError(f"matmul: op and op_b must be in {OPS}, got {op!r}, {op_b!r}")
    n_passes = reduced_passes(precision, a.dtype)
    if not n_passes:
        return (a.mH if op == "h" else a) @ (b.mH if op_b == "h" else b)
    # a lazy conjugate x (such as q^H of a split) is the stored x^H
    # conjugate-transposed: pass that, with the other op
    if a.is_conj():
        a, op = a.mH, _FLIP[op]
    if b.is_conj():
        b, op_b = b.mH, _FLIP[op_b]
    if (a.dim() == 3 and b.dim() == 3 and a.shape[0] == b.shape[0]
            and a.stride(2) == 1 and b.stride(2) == 1):
        return cgemm(a, b, n_passes, op, op_b)  # one level already: most products
    # numpy's broadcast rule (torch's): torch.broadcast_shapes costs the host
    # far more, and the op stream pays it for every product
    batch = np.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    c = cgemm(*_batched(a, b, batch), n_passes, op, op_b)
    return c.reshape(*batch, c.shape[-2], c.shape[-1])
