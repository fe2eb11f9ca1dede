// The types, constants and warp helper that the BCGS2 orthonormalizer of
// csrc/block_chain.cuh (and through it every kernel of this directory) is
// built on. The file keeps its name from the block-wide BCGS2 chain it
// held until every kernel moved onto block_chain.cuh; no kernel code is
// left here.
//
// The algorithm's constants are those of
// qml_cutensornet_tpu/ops/pallas_qr.py:orth_rows_body (the scalar,
// pair=False variant):
//   - vectors are processed in panels of PANEL = 16;
//   - a column whose residual norm^2 is not above DEP_TOL2 = 1e-10 times
//     its norm^2 before projection is numerically dependent and is written
//     as exact zeros; otherwise it is scaled by rsqrt(n2 + TINY), TINY=1e-30.
//     The double instantiations cut at DEP_TOL2_F64 = 1e-24 instead: the
//     reference's f64 path is Householder QR with no cutoff, and 1e-10 would
//     drop directions above f64's singular-value-ratio floor of 1e-10;
//   - so exact-zero input vectors, and exact-zero entries shared by every
//     input vector, stay exactly zero (the MPS padding invariant).
#pragma once

#include <cuda_runtime.h>

namespace qk {

constexpr int PANEL = 16;
constexpr double DEP_TOL2 = 1e-10;
constexpr double DEP_TOL2_F64 = 1e-24;
constexpr double TINY = 1e-30;

// Layout-compatible with torch complex64 / complex128 (re, im interleaved).
template <typename T>
struct alignas(2 * sizeof(T)) Cx {
  T re, im;
};

__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace qk
