// Kernel K4: fused two-site gate application, theta build and subspace
// split, in one launch per two-site update.
//
// Replaces: qml_cutensornet_tpu/ops/pallas_split.py:_make_gate_split_kernel
// with its helper _gate_combine (built by _build_gate_call, entry points
// gate_split_factor_batched / gate_subspace_factor; reached from
// ops/svd.truncated_svd_gate on every two-site update when fused_gate is
// on).
//
// For each batch element b, with
//   A[b] [2 chi, chi]   the left site tensor, rows (u, alpha) u-major,
//   B[b] [chi, 2 chi]   the right site tensor, columns (v, beta) v-major,
//   g[b] [4, 4]         the two-site gate, g[2s+t, 2u+v],
// the kernel computes in its own body
//   theta0 = A B                                          (complex product)
//   theta[(s alpha), (t beta)] = sum_uv g[2s+t, 2u+v] theta0[(u alpha), (v beta)]
//   tot[b] = ||theta||_F^2
// and then runs kernel K1's chain on theta (block_chain.cuh split_chain and
// split_outputs), writing q[b] [2 chi, nc] and r[b] [nc, 2 chi], and
//   resid[b] = ||theta - q r||_F^2   (block_chain.cuh residual_norm2),
// the weight the nc directions miss, which the kept fraction needs and which
// only the kernel can form (theta is never stored outside it). The gate is
// read as [4, 4] and tot is one scalar per element: the TPU kernel's
// replicated-lane gate rows and its sublane-partial tot are layout
// workarounds of that compiler and are not carried over.
//
// The design is K1's kernel with a theta-building prologue
// (block_chain.cuh theta_build): one 512-thread block per element; A and B
// staged through shared memory in slabs of 16 reduction steps, in the space
// the chain's rows take later; each thread accumulates a 2 x 2 tile of
// (alpha, beta) pairs in all four (u, v) quadrants in registers, combines the
// quadrants with the gate in registers and writes theta straight into K1's
// layout, [2 chi][2 chi + 1] in shared memory where the plan has theta
// there (chi 32 and 64 in complex64), else [2 chi][2 chi] in the element's
// global scratch. tot is summed in a fixed order. theta0 is never stored.
// The launch plan (K1's SplitPlan on m = k = 2 chi) is chosen by the
// wrapper, ops/split.py gate_split_plan; the launch refuses a shared-memory
// size below what the plan needs.
//
// What bounds it on Hopper: as K1, the serial chain of BCGS2 column steps;
// the theta build adds one product of 4 chi^3 complex FMAs (the size of one
// of the chain's theta products). What the fusion saves is not arithmetic but
// the two einsum launches, the layout copies and the ||theta||^2 reduction
// of the unfused update, and their traffic. Complex FMAs on CUDA cores only
// (no TF32, no tensor cores).
//
// Built a second time with -DQK_PAIR (ops/_build.py), the same kernels form the
// pair library: complex64 only, every orthonormalization with the block-2
// in-panel step (block_chain.cuh mgs_pairs), the reference's
// _make_gate_split_kernel(iters, chi, pair=True).
//
// C interface (ctypes): every entry point returns a cudaError_t as int.
#include <cuda_runtime.h>

#include <cstddef>

#include "block_chain.cuh"

namespace qk {

template <typename T, bool THETA_SMEM, bool ROWS_SMEM, bool INPLACE>
__global__ void __launch_bounds__(blk::NT, 1)
gate_split_kernel(const Cx<T>* __restrict__ A, const Cx<T>* __restrict__ Bm,
                  const Cx<T>* __restrict__ g, const Cx<T>* __restrict__ v0,
                  Cx<T>* __restrict__ q, Cx<T>* __restrict__ r, T* __restrict__ tot,
                  T* __restrict__ resid, Cx<T>* scratch, int chi, int nc, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int m = 2 * chi;
  Cx<T>* p = reinterpret_cast<Cx<T>*>(smem_raw);
  Cx<T>* sb = scratch + (size_t)b * blk::gate_split_scratch_cx(
                                       chi, nc, blk::SplitPlan{THETA_SMEM, ROWS_SMEM, INPLACE});

  // theta: [m][m + 1] in shared memory, or [m][m] in the element's scratch.
  Cx<T>* th;
  int ldt;
  if constexpr (THETA_SMEM) {
    th = p;
    ldt = m + 1;
    p += (size_t)m * (m + 1);
  } else {
    th = sb;
    ldt = m;
    sb += (size_t)m * m;
  }
  Cx<T>* stage = p;  // the build's slabs, over the rows and the work
  const blk::Rows<T> x = blk::rows_carve<T, ROWS_SMEM, INPLACE>(p, sb, m, m, nc);
  const blk::OrthWork<T> ow = blk::orth_work_carve<T>(reinterpret_cast<unsigned char*>(p), nc);
  QK_STAMP(blk::ST_START);

  const T total = blk::theta_build<T, false>(
      A + (size_t)b * m * chi, chi, 1, Bm + (size_t)b * chi * m, m, 1, g + (size_t)b * 16, chi,
      stage, [&](int row, int col, Cx<T> v) {
        th[(size_t)row * ldt + col] = v;
        return v.re * v.re + v.im * v.im;
      });
  if (threadIdx.x == 0) tot[b] = total;

  Cx<T>* slab = p;  // gemm_staged's slabs where the rows are in global memory
  blk::split_chain<T, INPLACE, !ROWS_SMEM, blk::LIB_PAIR>(th, ldt, v0, x, ow,
                                                          m, m, nc, iters, slab);
  blk::split_outputs<T, !ROWS_SMEM>(th, ldt, x, q + (size_t)b * m * nc, r + (size_t)b * nc * m,
                                    m, m, nc, slab);
  const T res = blk::residual_norm2<T>(th, ldt, x, r + (size_t)b * nc * m, m, m, nc,
                                       reinterpret_cast<T*>(slab));
  if (threadIdx.x == 0) resid[b] = res;
  QK_STAMP(blk::ST_END);
}

template <typename T, bool THETA_SMEM, bool ROWS_SMEM, bool INPLACE>
int gate_split_launch_as(const void* A, const void* Bm, const void* g, const void* v0, void* q,
                         void* r, void* tot, void* resid, void* scratch, int B, int chi, int nc,
                         int iters, long long smem_bytes, cudaStream_t stream) {
  auto kern = gate_split_kernel<T, THETA_SMEM, ROWS_SMEM, INPLACE>;
  // A request over the card's limit fails here AND at the launch; both
  // errors surface through the single cudaGetLastError() below, which also
  // clears them so no stale error reaches the next launch.
  if (smem_bytes > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  kern<<<B, blk::NT, (size_t)smem_bytes, stream>>>(
      static_cast<const Cx<T>*>(A), static_cast<const Cx<T>*>(Bm), static_cast<const Cx<T>*>(g),
      static_cast<const Cx<T>*>(v0), static_cast<Cx<T>*>(q), static_cast<Cx<T>*>(r),
      static_cast<T*>(tot), static_cast<T*>(resid), static_cast<Cx<T>*>(scratch), chi, nc,
      iters);
  return (int)cudaGetLastError();
}

template <typename T>
int gate_split_launch(const void* A, const void* Bm, const void* g, const void* v0, void* q,
                      void* r, void* tot, void* resid, void* scratch, int B, int chi, int nc,
                      int iters, blk::SplitPlan plan, long long smem_bytes, cudaStream_t stream) {
  const int m = 2 * chi;
  if (plan.inplace && !(plan.rows_smem && blk::split_inplace_ok(m, m, nc)))
    return (int)cudaErrorInvalidValue;
  if (plan.theta_smem && !plan.rows_smem) return (int)cudaErrorInvalidValue;
  if (smem_bytes < (long long)blk::gate_split_smem_bytes<T>(chi, nc, plan))
    return (int)cudaErrorInvalidValue;
#define QK_GATE_SPLIT(TH, RS, IP) \
  gate_split_launch_as<T, TH, RS, IP>(A, Bm, g, v0, q, r, tot, resid, scratch, B, chi, nc, \
                                      iters, smem_bytes, stream)
  if (plan.theta_smem) return plan.inplace ? QK_GATE_SPLIT(true, true, true)
                                           : QK_GATE_SPLIT(true, true, false);
  if (plan.rows_smem) return plan.inplace ? QK_GATE_SPLIT(false, true, true)
                                          : QK_GATE_SPLIT(false, true, false);
  return QK_GATE_SPLIT(false, false, false);
#undef QK_GATE_SPLIT
}

}  // namespace qk

extern "C" {

// Dynamic shared memory of a launch plan, in bytes (dbl: complex128).
long long qk_gate_split_smem(int chi, int nc, int dbl, int theta_in_smem, int rows_in_smem,
                             int inplace) {
  const qk::blk::SplitPlan p{theta_in_smem, rows_in_smem, inplace};
  return dbl ? (long long)qk::blk::gate_split_smem_bytes<double>(chi, nc, p)
             : (long long)qk::blk::gate_split_smem_bytes<float>(chi, nc, p);
}

int qk_gate_split_launch(const void* A, const void* Bm, const void* g, const void* v0, void* q,
                         void* r, void* tot, void* resid, void* scratch, int B, int chi, int nc,
                         int iters, int dbl, int theta_in_smem, int rows_in_smem, int inplace,
                         long long smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const qk::blk::SplitPlan p{theta_in_smem, rows_in_smem, inplace};
  return dbl ? QK_DOUBLE(qk::gate_split_launch<double>(A, Bm, g, v0, q, r, tot, resid, scratch,
                                                       B, chi, nc, iters, p, smem_bytes, s))
             : qk::gate_split_launch<float>(A, Bm, g, v0, q, r, tot, resid, scratch, B, chi, nc,
                                            iters, p, smem_bytes, s);
}

}  // extern "C"
