// Kernel K5: the fused Hastings pair update of the brick (Vidal) engine, in
// one launch per batch of pairs.
//
// Replaces: qml_cutensornet_tpu/ops/pallas_split.py:_make_brick_split_kernel
// with its helpers _build_theta_quadrants and _gate_combine (built by
// _build_brick_call, entry point brick_gate_split_batched; reached from
// ops/svd.fused_brick_update on every pair update of ops/vidal.update_pairs
// when fused_gate is on and the stage's shape is one the kernel takes).
//
// For each batch element b (one pair of one circuit), with
//   A[b] [2 chi, chi]   the left site tensor, rows (u, alpha) u-major,
//   B[b] [chi, 2 chi]   the right site tensor, columns (v, beta) v-major,
//   g[b] [4, 4]         the two-site gate, g[2s+t, 2u+v],
//   lam[b] [chi]        the Schmidt weights of the pair's left bond (real),
// the kernel computes
//   theta_t[(s alpha), (t beta)] = sum_uv g[2s+t, 2u+v] (A B)[(u alpha), (v beta)]
//   theta_w = diag(lam, lam) theta_t       (row (s alpha) weighted by lam[alpha])
//   tot[b]  = ||theta_w||_F^2
// then runs kernel K1's chain (block_chain.cuh split_chain) on theta_w^H
// (rows (t beta), columns (s alpha)), whose basis is the top right singular
// basis of theta_w. With V the final basis as rows [nc, 2 chi] (the engine's
// right factor is conj(V)), the epilogue writes
//   q2[b]  [nc, 2 chi] = V
//   na0[b] [nc, 2 chi] = V theta_t^T       (rows of theta_t V^T: the new left
//                                            tensor, from the UNWEIGHTED theta,
//                                            with no division by lambda)
//   s2[b]  [nc]        = row norms^2 of conj(V) theta_w^H (= ||theta_w v_j||^2)
//   resid[b]           = ||theta_w^H - V^T conj(V) theta_w^H||_F^2, the weight the
//                        nc directions miss (block_chain.cuh residual_norm2)
// The TPU kernel's replicated-lane gate rows and its sublane-partial tot are
// layout workarounds of that compiler and are not carried over.
//
// The design is K4's (block_chain.cuh): one 512-thread block per element;
// the theta build as a register-tiled product over slabs of A and B staged
// in shared memory, the gate combined in registers, computed transposed (B^T
// A^T, lanes on neighbouring alpha) so that both thetas are written with
// coalesced stores in the chain's orientation: theta_w^H [(t beta)][(s
// alpha)] into shared memory ([2 chi][2 chi + 1]) where the plan has it there
// (chi 16 to 64 in complex64), else into the element's global scratch, and
// theta_t^T [(t beta)][(s alpha)] always into the scratch: it is read once,
// by the na0 product, and rebuilding it from A, B and g there would add the
// build's product to that one. Then K1's chain on K1's placements (SplitPlan
// on m = k = 2 chi, chosen by the wrapper, ops/split.py brick_split_plan; the
// launch refuses a shared-memory size below what the plan needs); then the
// epilogue's two products as the chain's register-tiled GEMMs, the rows of
// conj(V) theta_w^H passing through na0's output rows before their norms are
// summed in a fixed order.
//
// What bounds it on Hopper: the chain, as in K1. At the brick route's chi 128
// (408 pairs) nothing of an element fits in shared memory (theta_w^H alone is
// 512 KB in complex64), so every product streams its operands from global
// memory through L1 and L2, and one 512-thread block of up to 128 registers
// a thread fills an SM's register file: 408 elements run in 4 waves on 132
// SMs. Complex FMAs on CUDA cores only (no TF32, no tensor cores).
//
// Built a second time with -DQK_PAIR (ops/_build.py), the same kernels form the
// pair library: complex64 only, every orthonormalization with the block-2
// in-panel step (block_chain.cuh mgs_pairs), the reference's
// _make_brick_split_kernel(iters, chi, pair=True).
//
// C interface (ctypes): every entry point returns a cudaError_t as int.
#include <cuda_runtime.h>

#include <cstddef>

#include "block_chain.cuh"

namespace qk {

template <typename T, bool THETA_SMEM, bool ROWS_SMEM, bool INPLACE>
__global__ void __launch_bounds__(blk::NT, 1)
brick_split_kernel(const Cx<T>* __restrict__ A, const Cx<T>* __restrict__ Bm,
                   const Cx<T>* __restrict__ g, const T* __restrict__ lam,
                   const Cx<T>* __restrict__ v0, Cx<T>* __restrict__ q2,
                   Cx<T>* __restrict__ na0, T* __restrict__ s2, T* __restrict__ tot,
                   T* __restrict__ resid, Cx<T>* scratch, int chi, int nc, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int m = 2 * chi;
  Cx<T>* p = reinterpret_cast<Cx<T>*>(smem_raw);
  Cx<T>* sb = scratch + (size_t)b * blk::brick_split_scratch_cx(
                                       chi, nc, blk::SplitPlan{THETA_SMEM, ROWS_SMEM, INPLACE});

  // theta_t^T [m][m] in the element's scratch; theta_w^H [m][m + 1] in shared
  // memory or [m][m] in the scratch.
  Cx<T>* thT = sb;
  sb += (size_t)m * m;
  Cx<T>* thH;
  int ldh;
  if constexpr (THETA_SMEM) {
    thH = p;
    ldh = m + 1;
    p += (size_t)m * (m + 1);
  } else {
    thH = sb;
    ldh = m;
    sb += (size_t)m * m;
  }
  Cx<T>* stage = p;  // the build's slabs, over the rows and the work
  const blk::Rows<T> x = blk::rows_carve<T, ROWS_SMEM, INPLACE>(p, sb, m, m, nc);
  const blk::OrthWork<T> ow = blk::orth_work_carve<T>(reinterpret_cast<unsigned char*>(p), nc);
  QK_STAMP(blk::ST_START);

  // theta_t^T = (B^T A^T) with the gate transposed: row (t be), col (s al).
  const T* lb = lam + (size_t)b * chi;
  const T total = blk::theta_build<T, true>(
      Bm + (size_t)b * chi * m, 1, m, A + (size_t)b * m * chi, 1, chi, g + (size_t)b * 16, chi,
      stage, [&](int row, int col, Cx<T> v) {
        const T l = lb[col < chi ? col : col - chi];
        thT[(size_t)row * m + col] = v;
        thH[(size_t)row * ldh + col] = Cx<T>{l * v.re, -(l * v.im)};
        return l * l * (v.re * v.re + v.im * v.im);
      });
  if (threadIdx.x == 0) tot[b] = total;

  Cx<T>* slab = p;  // gemm_staged's slabs where the rows are in global memory
  blk::split_chain<T, INPLACE, !ROWS_SMEM, blk::LIB_PAIR>(thH, ldh, v0, x, ow,
                                                          m, m, nc, iters, slab);

  Cx<T>* q2b = q2 + (size_t)b * nc * m;
  Cx<T>* nab = na0 + (size_t)b * nc * m;
  for (int idx = threadIdx.x; idx < nc * m; idx += blk::NT) {
    const int j = idx / m, e = idx - j * m;
    q2b[idx] = x.V[(size_t)j * x.ldv + e];
  }
  // na0's rows hold conj(V) theta_w^H first, whose squared row norms are s2:
  // rw[j][e] = sum_kk conj(V[j][kk]) thH[kk][e].
  if constexpr (ROWS_SMEM) {
    blk::gemm<T, true, false, false, false>(x.V, x.ldv, 1, thH, ldh, 1, nab, m, 1, nc, m, m);
  } else {
    blk::gemm_staged<T, true, false>(x.V, x.ldv, 1, thH, ldh, 1, nab, m, 1, nc, m, m, slab);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < nc; j += blk::NW) {
    T acc = 0;
    for (int e = lane; e < m; e += 32) {
      const Cx<T> v = nab[(size_t)j * m + e];
      acc += v.re * v.re + v.im * v.im;
    }
    acc = warp_sum(acc);
    if (lane == 0) s2[(size_t)b * nc + j] = acc;
  }
  const T res = blk::residual_norm2<T>(thH, ldh, x, nab, m, m, nc, reinterpret_cast<T*>(slab));
  if (threadIdx.x == 0) resid[b] = res;
  QK_STAMP(blk::ST_S2);
  // na0[j][e] = sum_kk V[j][kk] thT[kk][e] = (theta_t q)[e, j]
  if constexpr (ROWS_SMEM) {
    blk::gemm<T, false, false, false, false>(x.V, x.ldv, 1, thT, m, 1, nab, m, 1, nc, m, m);
  } else {
    blk::gemm_staged<T, false, false>(x.V, x.ldv, 1, thT, m, 1, nab, m, 1, nc, m, m, slab);
  }
  QK_STAMP(blk::ST_NA0);
}

template <typename T, bool THETA_SMEM, bool ROWS_SMEM, bool INPLACE>
int brick_split_launch_as(const void* A, const void* Bm, const void* g, const void* lam,
                          const void* v0, void* q2, void* na0, void* s2, void* tot,
                          void* resid, void* scratch, int B, int chi, int nc, int iters,
                          long long smem_bytes, cudaStream_t stream) {
  auto kern = brick_split_kernel<T, THETA_SMEM, ROWS_SMEM, INPLACE>;
  // A request over the card's limit fails here AND at the launch; both
  // errors surface through the single cudaGetLastError() below.
  if (smem_bytes > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  kern<<<B, blk::NT, (size_t)smem_bytes, stream>>>(
      static_cast<const Cx<T>*>(A), static_cast<const Cx<T>*>(Bm), static_cast<const Cx<T>*>(g),
      static_cast<const T*>(lam), static_cast<const Cx<T>*>(v0), static_cast<Cx<T>*>(q2),
      static_cast<Cx<T>*>(na0), static_cast<T*>(s2), static_cast<T*>(tot),
      static_cast<T*>(resid), static_cast<Cx<T>*>(scratch), chi, nc, iters);
  return (int)cudaGetLastError();
}

template <typename T>
int brick_split_launch(const void* A, const void* Bm, const void* g, const void* lam,
                       const void* v0, void* q2, void* na0, void* s2, void* tot, void* resid,
                       void* scratch, int B, int chi, int nc, int iters, blk::SplitPlan plan,
                       long long smem_bytes, cudaStream_t stream) {
  const int m = 2 * chi;
  if (plan.inplace && !(plan.rows_smem && blk::split_inplace_ok(m, m, nc)))
    return (int)cudaErrorInvalidValue;
  if (plan.theta_smem && !plan.rows_smem) return (int)cudaErrorInvalidValue;
  if (smem_bytes < (long long)blk::gate_split_smem_bytes<T>(chi, nc, plan))
    return (int)cudaErrorInvalidValue;
#define QK_BRICK_SPLIT(TH, RS, IP) \
  brick_split_launch_as<T, TH, RS, IP>(A, Bm, g, lam, v0, q2, na0, s2, tot, resid, scratch, B, \
                                       chi, nc, iters, smem_bytes, stream)
  if (plan.theta_smem) return plan.inplace ? QK_BRICK_SPLIT(true, true, true)
                                           : QK_BRICK_SPLIT(true, true, false);
  if (plan.rows_smem) return plan.inplace ? QK_BRICK_SPLIT(false, true, true)
                                          : QK_BRICK_SPLIT(false, true, false);
  return QK_BRICK_SPLIT(false, false, false);
#undef QK_BRICK_SPLIT
}

}  // namespace qk

extern "C" {

// Dynamic shared memory of a launch plan, in bytes (dbl: complex128): the
// same as K4's.
long long qk_brick_split_smem(int chi, int nc, int dbl, int theta_in_smem, int rows_in_smem,
                              int inplace) {
  const qk::blk::SplitPlan p{theta_in_smem, rows_in_smem, inplace};
  return dbl ? (long long)qk::blk::gate_split_smem_bytes<double>(chi, nc, p)
             : (long long)qk::blk::gate_split_smem_bytes<float>(chi, nc, p);
}

int qk_brick_split_launch(const void* A, const void* Bm, const void* g, const void* lam,
                          const void* v0, void* q2, void* na0, void* s2, void* tot, void* resid,
                          void* scratch, int B, int chi, int nc, int iters, int dbl,
                          int theta_in_smem, int rows_in_smem, int inplace, long long smem_bytes,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const qk::blk::SplitPlan p{theta_in_smem, rows_in_smem, inplace};
  return dbl ? QK_DOUBLE(qk::brick_split_launch<double>(A, Bm, g, lam, v0, q2, na0, s2, tot,
                                                        resid, scratch, B, chi, nc, iters, p,
                                                        smem_bytes, s))
             : qk::brick_split_launch<float>(A, Bm, g, lam, v0, q2, na0, s2, tot, resid, scratch,
                                             B, chi, nc, iters, p, smem_bytes, s);
}

}  // extern "C"
