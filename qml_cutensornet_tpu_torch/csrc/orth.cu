// Kernel K3: batched complex orthonormalization (basis only).
//
// Replaces: qml_cutensornet_tpu/ops/pallas_qr.py:_make_orth_kernel with its
// body orth_rows_body (built by _build_call, entry points
// orthonormalize_batched / qr_orth_pallas; reached from cpx.qr_orth on every
// orthonormalization of the unfused split, from cpx.qr on the unfused center
// move, and as the panel step of blocked_qr.qr_orth_blocked above 128
// columns).
//
// For each batch element b, with v[b] an [m, k] complex matrix (row-major,
// the port's column layout), writes q[b] [m, k], an orthonormal basis of the
// columns of v[b] by BCGS2 (block_chain.cuh: panels of 16, CGS2 + in-panel
// MGS2; dependent and zero columns come out as exact zeros). No r factor: the
// callers that need one form q^H v as a batched matrix product outside.
//
// Shapes: k <= 128 and any m. Besides the center-move and split shapes
// ([B, 2 chi, chi] and [B, 2 chi, nc] up to chi 64 on the unfused route) it
// takes the panels of the blocked route, k = 32 (and a last panel of 16)
// with m = 2 chi: 256 at chi 128, 512 at chi 256, 2048 at chi 1024.
//
// What bounds it on Hopper: the latency of the serial column chain (k
// dependent column steps, each two reduction rounds), not arithmetic or bytes
// (bound 0.0040 ms at v [32, 128, 64]). The design is K2's (orth_r.cu) on the
// routines of block_chain.cuh: one 512-thread block per element; v is
// transposed into the rows Q [k][m + 1] (odd stride: the transposed writes
// and the GEMMs' column reads are conflict-free), in shared memory where they
// fit ([64][129] at chi 64 is 66 KB, the 512-long panel [32][513] 131 KB),
// else in a per-element global scratch buffer ([32][2049] is 524 KB);
// blk::bcgs2_rows runs the register-tiled CGS passes, the butterfly-reduced
// coefficients and the in-panel MGS2; Q is transposed back out. The in-panel
// group is what K3 adds: K1, K2, K4 and K5 hold a panel on 4 warps at one or
// two elements a lane (len <= 256), and two-thirds of K3's launches have
// m = 512. Measured on the H100 (utils/chain_stamps.py orth, B 32): a round
// costs about 1340 to 1530 cycles at one element a lane on 4, 8 or 16
// warps, 1830 to 2120 at two (mgs_panel<float, 2> spills) and 3230 at four
// (it spills more); the group's width barely matters. So the launch plan
// (ops/orth.py orth_plan, shape rules in ops/_block.py orth_group) names
// the group by the vector length at one element a lane: 4 warps up to 128,
// 8 up to 256, the whole block up to 512; then the whole block at two up to
// 1024; above that the whole block on the panel left in memory
// (blk::mgs_panel_mem), for any m. The launch refuses a group it was not
// built with, a length the group cannot hold and a shared-memory size below
// what the plan needs. Complex FMAs on CUDA cores only (no TF32, no tensor
// cores); every sum in a fixed order.
//
// Built with -DQK_ORTH_CANDIDATES (utils/chain_stamps.py), the complex64
// shared-memory plan also takes the groups that were measured against the
// chosen ones: 4 warps at two and four elements a lane, 8 warps at two.
//
// Built a second time with -DQK_PAIR (ops/_build.py), the same kernels form the
// pair library: complex64 only, every orthonormalization with the block-2
// in-panel step (block_chain.cuh mgs_pairs), the reference's
// _make_orth_kernel(pair=True).
//
// C interface (ctypes): every entry point returns a cudaError_t as int.
#include <cuda_runtime.h>

#include <cstddef>

#include "block_chain.cuh"

namespace qk {

// Dynamic shared memory of a launch plan: the rows Q [k][m + 1] when
// rows_smem, and the orthonormalizer's work. The in-panel group's reduction
// slots are static shared memory (2 x GWN x 32 values).
template <typename T>
size_t orth_smem_bytes(int m, int k, int rows_smem) {
  return (rows_smem ? (size_t)k * ((size_t)m + 1) * sizeof(Cx<T>) : 0) +
         blk::orth_work_bytes<T>(k);
}

template <typename T, bool ROWS_SMEM, int GWN, int EPL>
__global__ void __launch_bounds__(blk::NT, 1)
orth_kernel(const Cx<T>* __restrict__ v, Cx<T>* __restrict__ q, Cx<T>* scratch, int m, int k) {
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
  const blk::OrthWork<T> ow = blk::orth_work_carve<T>(reinterpret_cast<unsigned char*>(p), k);

  // Column j of v[b] is vector j: Q[j][e] = v[e, j] (coalesced reads over j).
  for (int idx = threadIdx.x; idx < m * k; idx += blk::NT) {
    const int e = idx / k, j = idx - e * k;
    Q[(size_t)j * ldq + e] = vb[idx];
  }
  QK_STAMP(blk::ST_START);
  __syncthreads();
  QK_STAMP(blk::ST_LOAD);
  blk::bcgs2_rows<T, GWN, EPL, blk::LIB_PAIR>(Q, ldq, k, m, ow);

  Cx<T>* qb = q + (size_t)b * m * k;
  for (int idx = threadIdx.x; idx < m * k; idx += blk::NT) {
    const int e = idx / k, j = idx - e * k;
    qb[idx] = Q[(size_t)j * ldq + e];
  }
  QK_STAMP(blk::ST_END);
}

template <typename T, bool ROWS_SMEM, int GWN, int EPL>
int orth_launch_as(const void* v, void* q, void* scratch, int B, int m, int k,
                   long long smem_bytes, cudaStream_t stream) {
  auto kern = orth_kernel<T, ROWS_SMEM, GWN, EPL>;
  // A request over the card's limit fails here AND at the launch; both
  // errors surface through the single cudaGetLastError() below, which also
  // clears them so no stale error reaches the next launch.
  if (smem_bytes > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  kern<<<B, blk::NT, (size_t)smem_bytes, stream>>>(static_cast<const Cx<T>*>(v),
                                                   static_cast<Cx<T>*>(q),
                                                   static_cast<Cx<T>*>(scratch), m, k);
  return (int)cudaGetLastError();
}

// One instantiation per launch plan: the placement of the rows and the
// in-panel group (warps, elements a lane; EPL_MEM: the panel in memory).
template <typename T, bool ROWS_SMEM>
int orth_launch_group(const void* v, void* q, void* scratch, int B, int m, int k, int gwn,
                      int epl, long long smem_bytes, cudaStream_t stream) {
#define QK_ORTH_GROUP(G, E)                                                              \
  if (gwn == (G) && epl == (E))                                                         \
    return orth_launch_as<T, ROWS_SMEM, (G), (E)>(v, q, scratch, B, m, k, smem_bytes, \
                                                  stream);
  QK_ORTH_GROUP(4, 1)
  QK_ORTH_GROUP(8, 1)
  QK_ORTH_GROUP(16, 1)
  QK_ORTH_GROUP(16, 2)
  QK_ORTH_GROUP(16, blk::EPL_MEM)
#ifdef QK_ORTH_CANDIDATES
  if constexpr (sizeof(T) == sizeof(float) && ROWS_SMEM) {
    QK_ORTH_GROUP(4, 2)
    QK_ORTH_GROUP(4, 4)
    QK_ORTH_GROUP(8, 2)
  }
#endif
#undef QK_ORTH_GROUP
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int orth_launch(const void* v, void* q, void* scratch, int B, int m, int k, int rows_smem,
                int gwn, int epl, long long smem_bytes, cudaStream_t stream) {
  if (epl != blk::EPL_MEM && (epl < 1 || (long long)m > (long long)epl * gwn * 32))
    return (int)cudaErrorInvalidValue;
  if (smem_bytes < (long long)orth_smem_bytes<T>(m, k, rows_smem))
    return (int)cudaErrorInvalidValue;
  if (rows_smem)
    return orth_launch_group<T, true>(v, q, scratch, B, m, k, gwn, epl, smem_bytes, stream);
  return orth_launch_group<T, false>(v, q, scratch, B, m, k, gwn, epl, smem_bytes, stream);
}

}  // namespace qk

extern "C" {

// Dynamic shared memory of a launch plan for [m, k] inputs (dbl: complex128).
long long qk_orth_smem(int m, int k, int dbl, int rows_smem) {
  return dbl ? (long long)qk::orth_smem_bytes<double>(m, k, rows_smem)
             : (long long)qk::orth_smem_bytes<float>(m, k, rows_smem);
}

// rows_smem 0: ``scratch`` holds k * (m + 1) complex elements per batch
// element. (gwn, epl): the in-panel group of the plan.
int qk_orth_launch(const void* v, void* q, void* scratch, int B, int m, int k, int dbl,
                   int rows_smem, int gwn, int epl, long long smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dbl ? QK_DOUBLE(qk::orth_launch<double>(v, q, scratch, B, m, k, rows_smem, gwn, epl,
                                                 smem_bytes, s))
             : qk::orth_launch<float>(v, q, scratch, B, m, k, rows_smem, gwn, epl, smem_bytes, s);
}

}  // extern "C"
