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

:func:`cgemm` ``(a, b, passes, op)`` computes ``op(a[b]) @ b[b]`` (``op``
"n": ``a`` as it is, ``[B, M, K]``; "h": its conjugate transpose, ``a`` is
``[B, K, M]``) at ``passes`` 1 or 3. A CPU tensor runs the plain version
(:func:`cgemm_plain`); a CUDA tensor runs kernel K7 (``csrc/bf16_cgemm.cu``,
:func:`cgemm_cuda`) or raises. The plain version splits as the kernel
does and forms the same products as f32 matrix products of the bf16 values
(each product is exact in f32: 8 x 8 mantissa bits fit in 24), summed in
f32 in the reference's 4M form (``ops/cpx.py:87-106``): four real products
for each complex product. It and the kernel differ only in the order of
their f32 sums.

:func:`matmul` ``(a, b, precision, op)`` is ``op(a) @ b`` with
``torch.matmul``'s broadcasting of the leading dimensions. At a full class
(and in complex128) it is ``torch.matmul`` itself; at a reduced class it is
one :func:`cgemm` over the broadcast batch. The reference runs its
simulators under ``jax.default_matmul_precision(cfg.matmul_precision)``, so
that every XLA dot without a precision of its own falls to the class; the
port's engine passes the class to each product that is such a dot in the
reference, and to no other (the kernels K1 to K5 and their plain versions
stay at full precision, as the reference pins its Pallas dots at HIGHEST).
Einsums map onto K7's ``[batch, rows, cols]`` layouts as views where they
can; where they cannot, :func:`matmul` copies in plain torch:

- an operand whose matrices are not row-major with unit column stride (the
  conjugate transpose of a second operand, ``r^H`` of a center move and
  ``V^H`` of the brick update, or ``theta^H`` of the eigh route's Gram) is
  made contiguous;
- an operand broadcast over part of the batch (a gate ``[B, 4, 4]`` over
  the bond index of theta ``[B, chi, 4, chi]``) is expanded into a copy of
  the small operand; one broadcast over the whole batch is passed with a
  batch stride 0, no copy;
- leading dimensions that do not flatten to one stride (a slice of sites)
  are copied by ``reshape``.
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


def _layout(x: torch.Tensor) -> tuple[int, int]:
    """``(batch stride, row stride)`` in elements of a ``[batch, rows, cols]``
    tensor whose rows have unit stride (a batch stride 0 for a batch of one
    or a broadcast); raises on any other layout, such as a transpose."""
    rows, cols = x.shape[1], x.shape[2]
    if cols > 1 and x.stride(2) != 1:
        raise ValueError(f"cgemm: each matrix must be row-major with unit column stride, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    return (x.stride(0) if x.shape[0] > 1 else 0), (x.stride(1) if rows > 1 else cols)


def _check_args(a: torch.Tensor, b: torch.Tensor, n_passes: int, op: str):
    """``(M, N, K)`` of a valid call; raises on anything the kernel does not
    take (on either device, so that the CPU runs hold the callers to the
    kernel's layouts)."""
    if n_passes not in (1, 3):
        raise ValueError(f"cgemm: passes must be 1 or 3, got {n_passes}")
    if op not in OPS:
        raise ValueError(f"cgemm: op must be one of {OPS}, got {op!r}")
    for name, x in (("a", a), ("b", b)):
        if x.dtype != torch.complex64:
            raise TypeError(f"cgemm: {name} must be complex64, got {x.dtype}")
        if x.dim() != 3:
            raise ValueError(f"cgemm: {name} must be [batch, rows, cols], got {tuple(x.shape)}")
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"cgemm: batch {a.shape[0]} != {b.shape[0]}")
    M, K = (a.shape[2], a.shape[1]) if op == "h" else (a.shape[1], a.shape[2])
    if b.shape[1] != K:
        raise ValueError(f"cgemm: op(a) is {M} x {K}, b is {b.shape[1]} x {b.shape[2]}")
    _layout(a), _layout(b)
    return M, b.shape[2], K


def cgemm_plain(a: torch.Tensor, b: torch.Tensor, n_passes: int, op: str = "n"):
    """Plain version of K7: ``op(a) @ b`` at ``n_passes``, the kernel's split
    and its 4M products as f32 matrix products."""
    _check_args(a, b, n_passes, op)
    if a.is_cuda or b.is_cuda:
        _build.PLAIN_ON_CUDA["cgemm"] += 1
    ar, ai = (a.real.mT, -a.imag.mT) if op == "h" else (a.real, a.imag)
    ar, ai = _split(ar, n_passes), _split(ai, n_passes)
    br, bi = _split(b.real, n_passes), _split(b.imag, n_passes)
    re = _real_product(ar, br, n_passes) - _real_product(ai, bi, n_passes)
    im = _real_product(ar, bi, n_passes) + _real_product(ai, br, n_passes)
    return torch.complex(re, im)


def cgemm_cuda(a: torch.Tensor, b: torch.Tensor, n_passes: int, op: str = "n"):
    """Launch K7: ``c [B, M, N] = op(a) @ b`` at ``n_passes``. ``a`` and
    ``b`` are complex64 CUDA tensors on one device whose matrices are
    row-major with unit column stride (any row and batch stride, a batch
    stride 0 included)."""
    M, N, K = _check_args(a, b, n_passes, op)
    for name, x in (("a", a), ("b", b)):
        if x.device.type != "cuda":
            raise ValueError(f"cgemm: {name} must be a CUDA tensor, got device {x.device}")
    if a.device != b.device:
        raise ValueError(f"cgemm: a on {a.device}, b on {b.device}")
    (sa, lda), (sb, ldb) = _layout(a), _layout(b)
    lib = _build.load()
    c = torch.empty((a.shape[0], M, N), dtype=torch.complex64, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.qk_cgemm_launch(a.data_ptr(), b.data_ptr(), c.data_ptr(), a.shape[0], M, N, K,
                             sa, lda, sb, ldb, int(op == "h"), n_passes, stream)
    _build.check(rc, "cgemm kernel launch")
    _build.count_launch("cgemm", False)
    return c


def cgemm(a: torch.Tensor, b: torch.Tensor, n_passes: int, op: str = "n") -> torch.Tensor:
    """``op(a) @ b`` at ``n_passes`` (1 or 3): kernel K7 for CUDA tensors,
    its plain version for CPU tensors."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return cgemm_plain(a, b, n_passes, op)
    return cgemm_cuda(a, b, n_passes, op)


def _batched(x: torch.Tensor, batch: tuple[int, ...]) -> torch.Tensor:
    """``x [..., r, c]`` as ``[prod(batch), r, c]`` in a layout K7 takes:
    its matrices made row-major first if they are not, then a batch stride 0
    where ``x`` has one matrix, else its leading dimensions broadcast to
    ``batch`` and flattened (a view where the strides allow, a copy
    otherwise)."""
    r, c = x.shape[-2], x.shape[-1]
    if c > 1 and x.stride(-1) != 1:
        x = x.contiguous()
    n = math.prod(batch)
    if math.prod(x.shape[:-2]) == 1:
        return x.reshape(1, r, c).expand(n, r, c)
    return x.expand(*batch, r, c).reshape(n, r, c)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str, op: str = "n") -> torch.Tensor:
    """``op(a) @ b`` at ``precision`` (one of the reference's seven strings):
    ``op`` "n" takes ``a [..., M, K]`` as it is, "h" its conjugate
    transpose (``a [..., K, M]``); ``b [..., K, N]``; the leading dimensions
    broadcast as ``torch.matmul``'s do. At a full class, and in complex128
    at every class, ``torch.matmul`` (full f32, TF32 off); at a reduced one,
    :func:`cgemm` (kernel K7 on CUDA tensors, its plain version on CPU
    tensors) over the broadcast batch, in the layouts of the module
    docstring."""
    if op not in OPS:
        raise ValueError(f"matmul: op must be one of {OPS}, got {op!r}")
    n_passes = reduced_passes(precision, a.dtype)
    if not n_passes:
        return (a.mH if op == "h" else a) @ b
    # numpy's broadcast rule (torch's): torch.broadcast_shapes costs the host
    # far more, and the op stream pays it for every product
    batch = np.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    c = cgemm(_batched(a, batch), _batched(b, batch), n_passes, op)
    return c.reshape(*batch, c.shape[1], c.shape[2])
