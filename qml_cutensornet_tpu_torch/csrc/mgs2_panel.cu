// Kernel K8: the scanned MGS2 panel step of the blocked orthonormalizer.
//
// Replaces no pallas_call: it computes what the reference's
// qml_cutensornet_tpu/ops/blocked_qr.py:_mgs2_panel leaves to XLA, a
// lax.scan over the columns of one panel that XLA compiles into one device
// loop (called from qr_orth_blocked on every panel that does not go to the
// Pallas basis kernel: above 128 columns in f32 with fused_split off). The
// port's blocked route also takes complex128, where the reference runs
// Householder QR (its blocked route takes f32 only): every f64
// orthonormalization above 128 columns reaches this kernel.
//
// For each batch element b, with a[b] an [m, p] complex panel (row-major,
// the port's column layout, p <= 32) and n2o[b] [p] its columns' squared
// norms before the projection against earlier panels, writes q[b] [m, p]:
// for t = 0 .. p - 1 in order,
//   x = a[:, t];
//   twice: c = q[:, :t]^H x, then x -= q[:, :t] c;
//   n2 = |x|^2;
//   q[:, t] = x * rsqrt(n2 + TINY) if n2 > dep_tol2 * n2o[t], else zeros.
// The cutoff dep_tol2 is the caller's (ops/orth.dep_tol2): the reference
// scan's _DEP_TOL**2 = 1e-10 in complex64, and 1e-24 in complex128 as K2
// and K3 cut (bcgs2.cuh), because the reference orthonormalizes f64 input
// of any width by Householder QR with no cutoff. Exact-zero input columns
// come out as exact zeros.
//
// Shapes on the main paths: m = 2 chi (256, 512, 1024, 2048), p = 32 and a
// last panel of 16 (a split of chi + 16 columns); complex128 (the f64 runs)
// and complex64 (fused_split off, or a full ambient class).
//
// What bounds it on Hopper: the latency of the column chain, not arithmetic
// or bytes. [32, 512, 32] in complex128 is 0.26 GFLOP and 17 MB, a bound of
// about 5 us, but each column needs dependent block-wide reductions, and
// one block per batch element fills 32 of 132 SMs. The design, on
// block_chain.cuh's wide_panel (the sibling of K1 to K5's in-panel step
// for 32 columns):
// - two reduction rounds a column, 63 for a panel of 32 (the first version
//   took 124): column t's first round also sums column t - 1's norm. A
//   round's values go through one named barrier in three sets, each with
//   its own warp butterfly: the coefficients of the finished columns below
//   16 and from 16 (each butterfly as narrow as its values allow), and
//   those of the column before t with its norm;
// - the panel in registers: one block of 8 warps (256 threads, up to 255
//   registers a thread) a batch element, EPL = 1, 2, 4 or 8 elements a lane
//   chosen by m (m <= 256 EPL), 128 registers a thread for the panel's
//   columns, so R = 128 / (EPL * 2 * sizeof(T) / 4) of them (32 columns in
//   complex64 at m 512, 16 in complex128 at m 512). Each thread owns its
//   elements of every column, so the rounds are the only traffic between
//   threads;
// - the columns run in a loop, not unrolled: a loop over the finished
//   columns is one jump into a chain of unrolled steps (blk::chain16), so
//   every register index is a constant and the code stays linear in the
//   panel's width (a build that unrolled all 32 columns of every plan did
//   not finish within 18 minutes of nvcc);
// - where the panel is wider than R (the split plans), the columns past R
//   wait in shared memory, are taken one at a time into registers and go
//   back there finished, a column of the second half reading each finished
//   column past R four times (two dots, two projections) and none of the R
//   in registers;
// - where shared memory cannot hold the columns past R either (complex64
//   at m 2048 and p > 21, complex128 at m 1024 and p > 21 and at m 2048 and
//   p > 10: 393 KB and more), they wait in global scratch in the same
//   layout (L2-resident: at most 29 MB for B 32), the one plan that reads
//   memory that is not on the SM. Only past m 2048, where no EPL of 8
//   warps covers the vector, does the whole panel stay in global scratch
//   (blk::wide_panel_mem, the block's 8 warps on any m);
// - the panel is loaded and stored through shared memory (coalesced reads
//   and writes of its rows, each thread then taking its own elements;
//   columns of NT * EPL + 1 elements, so neither side has bank conflicts),
//   each warp keeps its copy of a round's sums in shared memory for the
//   projections' broadcast loads, and the panel's n2o is read into shared
//   memory once, at the start.
// Where the cycles go at [32, 512, 32] (utils/chain_stamps.py, one block):
// 55 to 59% in the rounds (about 2000 cycles each in complex64, 3100 in
// complex128: dots, butterflies and barrier), 31 to 33% in the
// projections, 7 to 10% in load and store. No thread-block cluster: a cluster-wide round
// costs 0.96 to 1.17 us (utils/cluster_probe.py), as much as a whole round
// here, and would not shorten the chain of 63.
// Complex FMAs on the CUDA cores (IEEE fp32 or fp64; no TF32, no tensor
// cores), every sum in a fixed order, no atomics: two launches on one input
// give bit-equal outputs.
//
// C interface (ctypes): the launch returns a cudaError_t as int.
#include <cuda_runtime.h>

#include <cstddef>

#include "block_chain.cuh"

namespace qk {
namespace mgs2 {

constexpr int GWN = 8;  // warps of a block: the group of every round
constexpr int NT = GWN * 32;
constexpr int MAX_P = blk::WIDE;  // columns of a panel (ops/blocked_qr.PANEL)
constexpr int PANEL_REGS = 128;   // 32-bit registers a thread gives the panel's columns

// Launch plans (ops/blocked_qr.mgs2_plan): the panel in registers; R
// columns in registers and the rest in shared memory or in global scratch;
// the whole panel in global scratch.
enum Kind { REGISTERS = 0, SPLIT_SMEM = 1, SPLIT_GLOBAL = 2, MEMORY = 3 };

// Columns held in registers at epl elements a lane.
template <typename T>
__host__ __device__ constexpr int reg_cols(int epl) {
  return PANEL_REGS / (epl * 2 * (int)(sizeof(T) / 4)) < MAX_P
             ? PANEL_REGS / (epl * 2 * (int)(sizeof(T) / 4))
             : MAX_P;
}

// Complex elements of the columns past R a batch element keeps in memory
// (split plans: each column NT * epl long).
template <typename T>
__host__ __device__ size_t split_cx(int p, int epl) {
  const int r = reg_cols<T>(epl);
  return p > r ? (size_t)(p - r) * NT * epl : 0;
}

// Dynamic shared memory of a plan: the register plan's staging buffer of
// p columns, or the split plan's columns past R, each NT * epl + 1 long
// (an odd stride: the staging copies and each thread's own elements read
// without bank conflicts).
template <typename T>
size_t smem_bytes(int p, int kind, int epl) {
  const size_t col = ((size_t)NT * epl + 1) * sizeof(Cx<T>);
  if (kind == REGISTERS) return (size_t)p * col;
  if (kind == SPLIT_SMEM) return (size_t)(p - reg_cols<T>(epl)) * col;
  return 0;
}

// Columns [c0, c0 + nc) of a row-major [m][p] panel into S[j][e] (stride
// lds, zeros from m to ld), or back: neighbouring threads on neighbouring
// addresses of the panel's rows.
template <typename T>
__device__ __forceinline__ void stage_in(Cx<T>* S, int lds, const Cx<T>* ab, int m, int ld, int p,
                                         int c0, int nc) {
  for (int i = threadIdx.x; i < ld * nc; i += NT) {
    const int e = i / nc, j = i - e * nc;
    S[(size_t)j * lds + e] = e < m ? ab[(size_t)e * p + c0 + j] : Cx<T>{T(0), T(0)};
  }
}

template <typename T>
__device__ __forceinline__ void stage_out(Cx<T>* qb, const Cx<T>* S, int lds, int m, int p,
                                          int c0, int nc) {
  for (int i = threadIdx.x; i < m * nc; i += NT) {
    const int e = i / nc, j = i - e * nc;
    qb[(size_t)e * p + c0 + j] = S[(size_t)j * lds + e];
  }
}

template <typename T, int EPL, bool SMEM>
__global__ void __launch_bounds__(NT, 1)
mgs2_panel_kernel(const Cx<T>* __restrict__ a, const T* __restrict__ n2o, Cx<T>* __restrict__ q,
                  Cx<T>* scratch, int m, int p, T dep_tol2) {
  constexpr int R = reg_cols<T>(EPL);
  constexpr int LD = NT * EPL, LDS = LD + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T part[2 * GWN * 96];      // the rounds' two buffers
  __shared__ Cx<T> coef[GWN * 48];      // each warp's copy of a round's sums
  __shared__ T n2s[MAX_P];
  QK_STAMP(blk::ST_START);
  const int b = blockIdx.x;
  if (threadIdx.x < p) n2s[threadIdx.x] = n2o[(size_t)b * p + threadIdx.x];
  blk::WideCols<T, EPL, R> w;
  Cx<T>* S = reinterpret_cast<Cx<T>*>(smem_raw);
  w.M = SMEM ? S : scratch + (size_t)b * split_cx<T>(p, EPL);
  w.ld = SMEM ? LDS : LD;
  const Cx<T> zero{T(0), T(0)};
  const Cx<T>* ab = a + (size_t)b * m * p;
  Cx<T>* qb = q + (size_t)b * m * p;
  const int rc = p < R ? p : R;                  // columns in registers
  const int slots = SMEM ? (p > R ? p - R : p) : 0;  // column slots of S
  if constexpr (SMEM) {
    // The register columns pass through S, ``slots`` at a time; the
    // columns past R are staged into their own slots.
    for (int c0 = 0; c0 < rc; c0 += slots) {
      const int nc = rc - c0 < slots ? rc - c0 : slots;
      stage_in(S, LDS, ab, m, LD, p, c0, nc);
      __syncthreads();
#pragma unroll
      for (int s = 0; s < R; ++s)
        if (s >= c0 && s < c0 + nc) {
#pragma unroll
          for (int u = 0; u < EPL; ++u)
            w.x[s][u] = S[(size_t)(s - c0) * LDS + blk::wide_elem<GWN>(u)];
        }
      __syncthreads();
    }
    if (p > R) stage_in(S, LDS, ab, m, LD, p, R, p - R);
  } else {
#pragma unroll
    for (int u = 0; u < EPL; ++u) {
      const int e = blk::wide_elem<GWN>(u);
      const Cx<T>* row = ab + (size_t)e * p;
#pragma unroll
      for (int s = 0; s < R; ++s) w.x[s][u] = (s < p && e < m) ? row[s] : zero;
      for (int s = R; s < p; ++s) w.M[(size_t)(s - R) * LD + e] = e < m ? row[s] : zero;
    }
  }
#pragma unroll
  for (int u = 0; u < EPL; ++u) w.y[u] = w.z[u] = zero;
  __syncthreads();
  QK_STAMP(blk::ST_LOAD);
  int buf = 0;
  blk::wide_panel<T, EPL, R, GWN>(w, p, part, coef, buf, n2s, dep_tol2);
  if constexpr (SMEM) {
    __syncthreads();
    if (p > R) stage_out(qb, S, LDS, m, p, R, p - R);
    for (int c0 = 0; c0 < rc; c0 += slots) {
      const int nc = rc - c0 < slots ? rc - c0 : slots;
      __syncthreads();
#pragma unroll
      for (int s = 0; s < R; ++s)
        if (s >= c0 && s < c0 + nc) {
#pragma unroll
          for (int u = 0; u < EPL; ++u)
            S[(size_t)(s - c0) * LDS + blk::wide_elem<GWN>(u)] = w.x[s][u];
        }
      __syncthreads();
      stage_out(qb, S, LDS, m, p, c0, nc);
    }
  } else {
#pragma unroll
    for (int u = 0; u < EPL; ++u) {
      const int e = blk::wide_elem<GWN>(u);
      if (e >= m) continue;
      Cx<T>* row = qb + (size_t)e * p;
#pragma unroll
      for (int s = 0; s < R; ++s)
        if (s < p) row[s] = w.x[s][u];
      for (int s = R; s < p; ++s) row[s] = w.M[(size_t)(s - R) * LD + e];
    }
  }
  QK_STAMP(blk::ST_END);
}

// The whole panel in global scratch (column s at P + s * m), any m.
template <typename T>
__global__ void __launch_bounds__(NT, 1)
mgs2_memory_kernel(const Cx<T>* __restrict__ a, const T* __restrict__ n2o,
                   Cx<T>* __restrict__ q, Cx<T>* scratch, int m, int p, T dep_tol2) {
  __shared__ T part[2 * GWN * 96];
  __shared__ T n2s[MAX_P];
  QK_STAMP(blk::ST_START);
  const int b = blockIdx.x;
  if (threadIdx.x < p) n2s[threadIdx.x] = n2o[(size_t)b * p + threadIdx.x];
  Cx<T>* P = scratch + (size_t)b * p * m;
  const Cx<T>* ab = a + (size_t)b * m * p;
  for (int e = threadIdx.x; e < m; e += NT)
    for (int s = 0; s < p; ++s) P[(size_t)s * m + e] = ab[(size_t)e * p + s];
  __syncthreads();
  QK_STAMP(blk::ST_LOAD);
  int buf = 0;
  blk::wide_panel_mem<T, GWN>(P, m, p, m, part, buf, n2s, dep_tol2);
  Cx<T>* qb = q + (size_t)b * m * p;
  for (int e = threadIdx.x; e < m; e += NT)
    for (int s = 0; s < p; ++s) qb[(size_t)e * p + s] = P[(size_t)s * m + e];
  QK_STAMP(blk::ST_END);
}

// The kernel of a plan, or nullptr where none was built for it: the
// register and shared-memory plans at every EPL, global scratch past R
// only where shared memory cannot hold the columns past R on an H100
// (complex64 at EPL 8, complex128 at EPL 4 and 8; ops/blocked_qr
// SPLIT_GLOBAL_EPL).
template <typename T>
void (*pick(int kind, int epl))(const Cx<T>*, const T*, Cx<T>*, Cx<T>*, int, int, T) {
  constexpr bool DBL = sizeof(T) == sizeof(double);
  if (kind == MEMORY) return mgs2_memory_kernel<T>;
  if (kind == REGISTERS || kind == SPLIT_SMEM) {
    switch (epl) {
      case 1: return mgs2_panel_kernel<T, 1, true>;
      case 2: return mgs2_panel_kernel<T, 2, true>;
      case 4: return mgs2_panel_kernel<T, 4, true>;
      case 8: return mgs2_panel_kernel<T, 8, true>;
      default: return nullptr;
    }
  }
  if (kind == SPLIT_GLOBAL && epl == 8) return mgs2_panel_kernel<T, 8, false>;
  if constexpr (DBL) {
    if (kind == SPLIT_GLOBAL && epl == 4) return mgs2_panel_kernel<T, 4, false>;
  }
  return nullptr;
}

template <typename T>
int launch(const void* a, const void* n2o, void* q, void* scratch, int B, int m, int p,
           double dep_tol2, int kind, int epl, int rcols, long long smem, cudaStream_t stream) {
  if (B < 1 || m < 1 || p < 1 || p > MAX_P) return (int)cudaErrorInvalidValue;
  if (kind != MEMORY) {
    // The group must hold the vector, the plan's register columns must be
    // the kernel's, and the register plan must hold the panel.
    if ((long long)m > (long long)NT * epl || epl < 1 || rcols != reg_cols<T>(epl))
      return (int)cudaErrorInvalidValue;
    if ((kind == REGISTERS) != (p <= rcols)) return (int)cudaErrorInvalidValue;
  }
  if (smem < (long long)smem_bytes<T>(p, kind, epl)) return (int)cudaErrorInvalidValue;
  auto kern = pick<T>(kind, epl);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  // A request over the card's limit fails here AND at the launch; both
  // errors surface through the single cudaGetLastError() below.
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  kern<<<B, NT, (size_t)smem, stream>>>(static_cast<const Cx<T>*>(a),
                                        static_cast<const T*>(n2o), static_cast<Cx<T>*>(q),
                                        static_cast<Cx<T>*>(scratch), m, p, T(dep_tol2));
  return (int)cudaGetLastError();
}

}  // namespace mgs2
}  // namespace qk

extern "C" {

// Dynamic shared memory of a launch plan for panels of p columns (dbl:
// complex128; kind, epl as in qk_mgs2_launch).
long long qk_mgs2_smem(int p, int dbl, int kind, int epl) {
  return dbl ? (long long)qk::mgs2::smem_bytes<double>(p, kind, epl)
             : (long long)qk::mgs2::smem_bytes<float>(p, kind, epl);
}

// Columns a register or split plan holds in registers at epl elements a
// lane (dbl: complex128).
int qk_mgs2_reg_cols(int dbl, int epl) {
  return dbl ? qk::mgs2::reg_cols<double>(epl) : qk::mgs2::reg_cols<float>(epl);
}

// a [B, m, p] and q [B, m, p] complex, n2o [B, p] real of the same precision;
// dep_tol2 the cutoff on squared norms; kind 0 the panel in registers, 1
// the columns past rcols in shared memory, 2 in global scratch (``scratch``:
// (p - rcols) * 256 * epl complex elements per batch element), 3 the whole
// panel in global scratch (p * m per element); epl elements a lane and rcols
// register columns of the plan (kinds 0 to 2).
int qk_mgs2_launch(const void* a, const void* n2o, void* q, void* scratch, int B, int m, int p,
                   int dbl, double dep_tol2, int kind, int epl, int rcols, long long smem_bytes,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dbl ? qk::mgs2::launch<double>(a, n2o, q, scratch, B, m, p, dep_tol2, kind, epl,
                                        rcols, smem_bytes, s)
             : qk::mgs2::launch<float>(a, n2o, q, scratch, B, m, p, dep_tol2, kind, epl, rcols,
                                       smem_bytes, s);
}

}  // extern "C"
