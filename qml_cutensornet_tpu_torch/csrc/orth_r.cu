// Kernel K2: fused batched complex Q+R orthonormalization.
//
// Replaces: qml_cutensornet_tpu/ops/pallas_qr.py:_make_orth_r_kernel (built
// by _build_call_r, entry points orthonormalize_r_batched / qr_with_r_pallas;
// reached from ops/mps.move_center on every canonical-center move).
//
// For each batch element b, with v[b] an [m, k] complex matrix (row-major,
// the port's column layout), computes
//   q[b] [m, k]  an orthonormal basis of the columns of v[b] by BCGS2
//                (block_chain.cuh: panels of 16, CGS2 + in-panel MGS2,
//                dependent columns exact zeros);
//   r[b] [k, k]  r = q^H v  (not triangular; q r == v to roundoff).
//
// What bounds it on Hopper: latency of the serial column chain, not FLOPs
// or bytes (bound 0.006 ms at v [32, 128, 64]: k dependent steps with
// block-wide reductions; ~0.1 MB of traffic per element). The design
// (block_chain.cuh): one 512-thread block per element; the vectors Q (rows
// [k][m + 1]) and a copy of v in shared memory where they fit (at chi 64:
// 66 KB + 64 KB), else Q in a per-element global scratch buffer and v read
// from global memory (chi 128 in f64); the CGS passes and r = Q^H v as
// register-tiled CUDA-core GEMMs. The launch plan (OrthRPlan) is chosen by
// the wrapper, ops/orth.py orth_r_plan; the launch refuses a shared-memory
// size below what the plan needs. Complex FMAs on CUDA cores only (no TF32).
//
// Built a second time with -DQK_PAIR (ops/_build.py), the same kernels form the
// pair library: complex64 only, every orthonormalization with the block-2
// in-panel step (block_chain.cuh mgs_pairs), the reference's
// _make_orth_r_kernel(pair=True).
//
// C interface (ctypes): every entry point returns a cudaError_t as int.
#include <cuda_runtime.h>

#include <cstddef>

#include "block_chain.cuh"

namespace qk {

template <typename T, bool ROWS_SMEM, bool V_SMEM>
__global__ void __launch_bounds__(blk::NT, 1)
orth_r_kernel(const Cx<T>* __restrict__ v, Cx<T>* __restrict__ q, Cx<T>* __restrict__ r,
              Cx<T>* scratch, int m, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int ldq = m + 1;
  const Cx<T>* vb = v + (size_t)b * m * k;

  Cx<T>* p = reinterpret_cast<Cx<T>*>(smem_raw);
  Cx<T>* Q;
  if constexpr (ROWS_SMEM) {
    Q = p;
    p += (size_t)k * ldq;
  } else {
    Q = scratch + (size_t)b * k * ldq;
  }
  Cx<T>* vcopy = p;
  if constexpr (V_SMEM) p += (size_t)m * k;
  const blk::OrthWork<T> ow = blk::orth_work_carve<T>(reinterpret_cast<unsigned char*>(p), k);

  // Column j of v[b] is vector j: Q[j][e] = v[e, j] (coalesced reads over j;
  // the odd row stride of Q keeps the transposed writes conflict-free).
  for (int idx = threadIdx.x; idx < m * k; idx += blk::NT) {
    const int e = idx / k, j = idx - e * k;
    const Cx<T> x = vb[idx];
    Q[(size_t)j * ldq + e] = x;
    if constexpr (V_SMEM) vcopy[idx] = x;
  }
  QK_STAMP(blk::ST_START);
  __syncthreads();
  QK_STAMP(blk::ST_LOAD);
  blk::bcgs2_rows<T, blk::GW, blk::EPL_AUTO, blk::LIB_PAIR>(Q, ldq, k, m, ow);

  Cx<T>* qb = q + (size_t)b * m * k;
  for (int idx = threadIdx.x; idx < m * k; idx += blk::NT) {
    const int e = idx / k, j = idx - e * k;
    qb[idx] = Q[(size_t)j * ldq + e];
  }
  // r[i, j] = sum_e conj(Q[i][e]) v[e, j]
  if constexpr (V_SMEM) {
    blk::gemm<T, true, false, false, false>(Q, ldq, 1, vcopy, k, 1, r + (size_t)b * k * k, k, 1,
                                            k, k, m);
  } else {
    blk::gemm<T, true, false, false, false>(Q, ldq, 1, vb, k, 1, r + (size_t)b * k * k, k, 1, k,
                                            k, m);
  }
  QK_STAMP(blk::ST_END);
}

template <typename T, bool ROWS_SMEM, bool V_SMEM>
int orth_r_launch_as(const void* v, void* q, void* r, void* scratch, int B, int m, int k,
                     long long smem_bytes, cudaStream_t stream) {
  auto kern = orth_r_kernel<T, ROWS_SMEM, V_SMEM>;
  // A request over the card's limit fails here AND at the launch; both
  // errors surface through the single cudaGetLastError() below, which also
  // clears them so no stale error reaches the next launch.
  if (smem_bytes > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  kern<<<B, blk::NT, (size_t)smem_bytes, stream>>>(
      static_cast<const Cx<T>*>(v), static_cast<Cx<T>*>(q), static_cast<Cx<T>*>(r),
      static_cast<Cx<T>*>(scratch), m, k);
  return (int)cudaGetLastError();
}

template <typename T>
int orth_r_launch(const void* v, void* q, void* r, void* scratch, int B, int m, int k,
                  blk::OrthRPlan plan, long long smem_bytes, cudaStream_t stream) {
  if (plan.v_smem && !plan.rows_smem) return (int)cudaErrorInvalidValue;
  if (smem_bytes < (long long)blk::orth_r_smem_bytes<T>(m, k, plan))
    return (int)cudaErrorInvalidValue;
  if (plan.v_smem)
    return orth_r_launch_as<T, true, true>(v, q, r, scratch, B, m, k, smem_bytes, stream);
  if (plan.rows_smem)
    return orth_r_launch_as<T, true, false>(v, q, r, scratch, B, m, k, smem_bytes, stream);
  return orth_r_launch_as<T, false, false>(v, q, r, scratch, B, m, k, smem_bytes, stream);
}

}  // namespace qk

extern "C" {

// Dynamic shared memory of a launch plan for [m, k] inputs (dbl: complex128).
long long qk_orth_r_smem(int m, int k, int dbl, int rows_in_smem, int v_in_smem) {
  const qk::blk::OrthRPlan p{rows_in_smem, v_in_smem};
  return dbl ? (long long)qk::blk::orth_r_smem_bytes<double>(m, k, p)
             : (long long)qk::blk::orth_r_smem_bytes<float>(m, k, p);
}

int qk_orth_r_launch(const void* v, void* q, void* r, void* scratch, int B, int m, int k,
                     int dbl, int rows_in_smem, long long smem_bytes, void* stream,
                     int v_in_smem) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const qk::blk::OrthRPlan p{rows_in_smem, v_in_smem};
  return dbl ? QK_DOUBLE(qk::orth_r_launch<double>(v, q, r, scratch, B, m, k, p, smem_bytes, s))
             : qk::orth_r_launch<float>(v, q, r, scratch, B, m, k, p, smem_bytes, s);
}

// Largest dynamic shared memory a block may opt in to, or -(cudaError_t).
long long qk_smem_optin(int device) {
  int bytes = 0;
  cudaError_t e = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? (long long)bytes : -(long long)e;
}

const char* qk_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
