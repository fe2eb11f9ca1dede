// Kernel K1: fused batched subspace factorization (the truncating two-site
// split of the MPS engine).
//
// Replaces: qml_cutensornet_tpu/ops/pallas_split.py:_make_split_kernel /
// _split_chain (built by _build_call, entry points subspace_factor_batched /
// subspace_factor; reached from ops/svd._split_subspace on every truncating
// two-site update when fused_split is on).
//
// For each batch element b, with theta[b] an [m, k] complex matrix and the
// shared start block v0 [m, nc], runs ``iters`` double-multiply power
// iterations with an orthonormalization after every multiply, in rows
// layout (vector j of length L at W + j * ldw):
//   W = v^T conj(theta)      -> orth(W)   (v = v0 on the first iteration)
//   V = W theta^T            -> orth(V)
// then writes q[b] [m, nc] = V^T (the port's column layout) and
// r[b] [nc, k] = conj(V) theta (= q^H theta). Both orthonormalizations are
// BCGS2 (block_chain.cuh: same constants and zero invariants as
// pallas_qr.orth_rows_body).
//
// What bounds it on Hopper: at the main path's shapes (B 32, chi 32 and 64)
// neither bytes nor operations (bound 0.036 ms at chi 64) but the serial
// chain of 2 * iters orthonormalizations, each nc dependent column steps with
// block-wide reductions, beside 2 * iters + 1 theta products of about 8 MFLOP
// per element. The design (block_chain.cuh, whose split_chain and
// split_outputs K4 and K5 share): one 512-thread block per element; theta
// in shared memory for the whole launch where it fits beside the rows (chi
// 64 in complex64: W and V share one buffer), else read from
// global memory (the batch's thetas sit in the 50 MB L2); the products as
// register-tiled CUDA-core GEMMs; the rows in shared memory where they fit,
// else in a per-element global scratch buffer (chi 128, or f64 above chi
// 32), and with both theta and the rows in global memory the products stage
// their operands through shared memory (gemm_staged: cp.async slabs, double
// buffered).
// The launch plan (SplitPlan) is chosen by the wrapper, ops/split.py
// split_plan; the launch refuses a shared-memory size below what the plan
// needs.
//
// Built a second time with -DQK_PAIR (ops/_build.py), the same kernels form the
// pair library: complex64 only, every orthonormalization with the block-2
// in-panel step (block_chain.cuh mgs_pairs), the reference's
// _make_split_kernel(iters, pair=True).
//
// C interface (ctypes): every entry point returns a cudaError_t as int.
#include <cuda_runtime.h>

#include <cstddef>

#include "block_chain.cuh"

namespace qk {

template <typename T, bool THETA_SMEM, bool ROWS_SMEM, bool INPLACE>
__global__ void __launch_bounds__(blk::NT, 1)
split_kernel(const Cx<T>* __restrict__ theta, const Cx<T>* __restrict__ v0,
             Cx<T>* __restrict__ q, Cx<T>* __restrict__ r, Cx<T>* scratch, int m, int k,
             int nc, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const Cx<T>* thb = theta + (size_t)b * m * k;
  Cx<T>* p = reinterpret_cast<Cx<T>*>(smem_raw);

  // theta: [m][k + 1] in shared memory, or theta[b] itself ([m][k]).
  const Cx<T>* th = thb;
  int ldt = k;
  if constexpr (THETA_SMEM) {
    Cx<T>* ts = p;
    p += (size_t)m * (k + 1);
    for (int idx = threadIdx.x; idx < m * k; idx += blk::NT) {
      const int row = idx / k, col = idx - row * k;
      ts[(size_t)row * (k + 1) + col] = thb[idx];
    }
    th = ts;
    ldt = k + 1;
  }
  // The rows: W [nc][k + 1] and V [nc][m + 1], or one buffer X [nc][max + 1].
  const blk::Rows<T> x = blk::rows_carve<T, ROWS_SMEM, INPLACE>(
      p, scratch + (ROWS_SMEM ? 0 : (size_t)b * blk::split_scratch_cx(m, k, nc)), m, k, nc);
  const blk::OrthWork<T> ow = blk::orth_work_carve<T>(reinterpret_cast<unsigned char*>(p), nc);
  QK_STAMP(blk::ST_START);
  __syncthreads();
  QK_STAMP(blk::ST_LOAD);

  // With the rows in global memory (theta too) the products stage their
  // operands through shared memory, in the space of the orthonormalizer's work.
  Cx<T>* slab = p;
  blk::split_chain<T, INPLACE, !ROWS_SMEM, blk::LIB_PAIR>(th, ldt, v0, x, ow,
                                                          m, k, nc, iters, slab);
  blk::split_outputs<T, !ROWS_SMEM>(th, ldt, x, q + (size_t)b * m * nc, r + (size_t)b * nc * k,
                                    m, k, nc, slab);
  QK_STAMP(blk::ST_END);
}

template <typename T, bool THETA_SMEM, bool ROWS_SMEM, bool INPLACE>
int split_launch_as(const void* theta, const void* v0, void* q, void* r, void* scratch, int B,
                    int m, int k, int nc, int iters, long long smem_bytes, cudaStream_t stream) {
  auto kern = split_kernel<T, THETA_SMEM, ROWS_SMEM, INPLACE>;
  // A request over the card's limit fails here AND at the launch; both
  // errors surface through the single cudaGetLastError() below, which also
  // clears them so no stale error reaches the next launch.
  if (smem_bytes > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  kern<<<B, blk::NT, (size_t)smem_bytes, stream>>>(
      static_cast<const Cx<T>*>(theta), static_cast<const Cx<T>*>(v0), static_cast<Cx<T>*>(q),
      static_cast<Cx<T>*>(r), static_cast<Cx<T>*>(scratch), m, k, nc, iters);
  return (int)cudaGetLastError();
}

template <typename T>
int split_launch(const void* theta, const void* v0, void* q, void* r, void* scratch, int B,
                 int m, int k, int nc, int iters, blk::SplitPlan plan, long long smem_bytes,
                 cudaStream_t stream) {
  if (plan.inplace && !(plan.rows_smem && blk::split_inplace_ok(m, k, nc)))
    return (int)cudaErrorInvalidValue;
  if (plan.theta_smem && !plan.rows_smem) return (int)cudaErrorInvalidValue;
  if (smem_bytes < (long long)blk::split_smem_bytes<T>(m, k, nc, plan))
    return (int)cudaErrorInvalidValue;
  if (plan.theta_smem)
    return plan.inplace ? split_launch_as<T, true, true, true>(theta, v0, q, r, scratch, B, m, k,
                                                                nc, iters, smem_bytes, stream)
                        : split_launch_as<T, true, true, false>(theta, v0, q, r, scratch, B, m,
                                                                 k, nc, iters, smem_bytes,
                                                                 stream);
  if (plan.rows_smem)
    return plan.inplace ? split_launch_as<T, false, true, true>(theta, v0, q, r, scratch, B, m,
                                                                 k, nc, iters, smem_bytes, stream)
                        : split_launch_as<T, false, true, false>(theta, v0, q, r, scratch, B, m,
                                                                  k, nc, iters, smem_bytes,
                                                                  stream);
  return split_launch_as<T, false, false, false>(theta, v0, q, r, scratch, B, m, k, nc, iters,
                                                 smem_bytes, stream);
}

}  // namespace qk

extern "C" {

// Dynamic shared memory of a launch plan, in bytes (dbl: complex128).
long long qk_split_smem(int m, int k, int nc, int dbl, int rows_in_smem, int theta_in_smem,
                        int inplace) {
  const qk::blk::SplitPlan p{theta_in_smem, rows_in_smem, inplace};
  return dbl ? (long long)qk::blk::split_smem_bytes<double>(m, k, nc, p)
             : (long long)qk::blk::split_smem_bytes<float>(m, k, nc, p);
}

int qk_split_launch(const void* theta, const void* v0, void* q, void* r, void* scratch, int B,
                    int m, int k, int nc, int iters, int dbl, int rows_in_smem,
                    long long smem_bytes, void* stream, int theta_in_smem, int inplace) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const qk::blk::SplitPlan p{theta_in_smem, rows_in_smem, inplace};
  return dbl ? QK_DOUBLE(qk::split_launch<double>(theta, v0, q, r, scratch, B, m, k, nc, iters,
                                                  p, smem_bytes, s))
             : qk::split_launch<float>(theta, v0, q, r, scratch, B, m, k, nc, iters, p,
                                       smem_bytes, s);
}

}  // extern "C"
