// Kernel K8: the scanned MGS2 panel step of the blocked orthonormalizer.
//
// Replaces no pallas_call: it computes what the reference's
// qml_cutensornet_tpu/ops/blocked_qr.py:_mgs2_panel leaves to XLA, a
// lax.scan over the columns of one panel that XLA compiles into one device
// loop (called from qr_orth_blocked on every panel that does not go to the
// Pallas basis kernel: above 128 columns in f32 with fused_split off). The
// port's blocked route also takes complex128, where the reference runs
// Householder QR (its blocked route takes f32 only): every f64
// orthonormalization above 128 columns reaches this kernel. Without it the
// port ran the scan from the host, 10 to 20 launches a column.
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
// about 8 us, but every column takes two or three dependent block-wide
// reduction rounds a pass (the coefficients, then the norm): 124 rounds for
// a panel of 32. The design is the simple one: one 512-thread block per
// batch element; the columns run in order inside the block. The panel is
// transposed into rows W [p][m + 1] (each column contiguous, so that the
// threads' reads of one column coalesce), in shared memory where they fit
// (p (m + 1) complex: 131 KB at m 512 in complex64, m 256 in complex128,
// and for p 16 at twice those m), else in a per-element global scratch
// buffer that stays L2-resident (at most 33 MB for B 32, m 2048, complex128),
// as K3's plan without the rows in shared memory does. Each thread owns the
// elements tid + u * 512 of every column and is the only thread to touch
// them after the load, so the rounds' sums are the only traffic between
// threads. A round is block_chain.cuh's group_sum over the whole block
// (warp reduce-scatter butterflies of up to 16 complex coefficients, one
// named barrier, the 16 warps' partials added in warp order); a column past
// the 16th takes two rounds a pass. Each warp keeps its own copy of the
// coefficients in shared memory for the update. Complex FMAs on the CUDA
// cores (IEEE fp32 or fp64; no TF32, no tensor cores), every sum in a fixed
// order, no atomics: two launches on one input give bit-equal outputs.
//
// Left for later: thread-block clusters with distributed shared memory (a
// complex128 panel at m >= 512 across 2 to 8 SMs) and more than B blocks
// at a small batch.
//
// C interface (ctypes): the launch returns a cudaError_t as int.
#include <cuda_runtime.h>

#include <cstddef>

#include "block_chain.cuh"

namespace qk {
namespace mgs2 {

constexpr int NT = blk::NT;  // 512 threads, the whole block a round's group
constexpr int NW = blk::NW;
constexpr int MAX_P = 32;  // columns of a panel (ops/blocked_qr.PANEL)
constexpr int CHUNK = 16;  // coefficients of one round (32 real values)

// Dynamic shared memory of a launch plan: the rows W [p][m + 1] when
// panel_smem, else none.
template <typename T>
size_t smem_bytes(int m, int p, int panel_smem) {
  return panel_smem ? (size_t)p * ((size_t)m + 1) * sizeof(Cx<T>) : 0;
}

// This thread's part of conj(W[s]) . x for s in [s0, s0 + CHUNK) and s < t:
// v[2 j], v[2 j + 1] for s = s0 + j, zeros past t.
template <typename T>
__device__ __forceinline__ void dots(const Cx<T>* W, size_t ld, const Cx<T>* x, int m, int s0,
                                     int t, T (&v)[2 * CHUNK]) {
#pragma unroll
  for (int j = 0; j < 2 * CHUNK; ++j) v[j] = T(0);
  for (int e = threadIdx.x; e < m; e += NT) {
    const Cx<T> b = x[e];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (s0 + j < t) {
        const Cx<T> a = W[(size_t)(s0 + j) * ld + e];
        v[2 * j] += a.re * b.re + a.im * b.im;
        v[2 * j + 1] += a.re * b.im - a.im * b.re;
      }
    }
  }
}

template <typename T, bool PANEL_SMEM>
__global__ void __launch_bounds__(NT, 1)
mgs2_panel_kernel(const Cx<T>* __restrict__ a, const T* __restrict__ n2o, Cx<T>* __restrict__ q,
                  Cx<T>* scratch, int m, int p, T dep_tol2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T part[2 * NW * 32];  // group_sum's two buffers
  __shared__ __align__(16) T coef[NW][2 * MAX_P];  // each warp's copy of a pass's c
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const size_t ld = (size_t)m + 1;
  Cx<T>* W = PANEL_SMEM ? reinterpret_cast<Cx<T>*>(smem_raw) : scratch + (size_t)b * p * ld;
  T* cw = coef[tid >> 5];

  // Column j of a[b] is row j of W (coalesced reads over the panel).
  const Cx<T>* ab = a + (size_t)b * m * p;
  for (int idx = tid; idx < m * p; idx += NT) {
    const int e = idx / p, j = idx - e * p;
    W[(size_t)j * ld + e] = ab[idx];
  }
  __syncthreads();

  int buf = 0;
  for (int t = 0; t < p; ++t) {
    Cx<T>* x = W + (size_t)t * ld;
    for (int pass = 0; t > 0 && pass < 2; ++pass) {
      for (int s0 = 0; s0 < t; s0 += CHUNK) {
        T v[2 * CHUNK];
        dots<T>(W, ld, x, m, s0, t, v);
        // lane l holds the block's sum of v[l]: c_{s0 + l / 2}'s re or im
        cw[2 * s0 + lane] = blk::group_sum<2 * CHUNK, NW>(v, part, buf);
      }
      __syncwarp();
      // x -= sum_s W[s] c_s, in two interleaved chains. The next write to
      // cw follows a block-wide barrier, which every lane reaches after
      // this loop.
      for (int e = tid; e < m; e += NT) {
        T sr[2] = {T(0), T(0)}, si[2] = {T(0), T(0)};
#pragma unroll 4
        for (int s = 0; s < t; ++s) {
          const Cx<T> w = W[(size_t)s * ld + e];
          const T cr = cw[2 * s], ci = cw[2 * s + 1];
          sr[s & 1] += w.re * cr - w.im * ci;
          si[s & 1] += w.re * ci + w.im * cr;
        }
        x[e].re -= sr[0] + sr[1];
        x[e].im -= si[0] + si[1];
      }
    }
    T nv[1] = {T(0)};
    for (int e = tid; e < m; e += NT) nv[0] += x[e].re * x[e].re + x[e].im * x[e].im;
    const T n2 = blk::group_sum<1, NW>(nv, part, buf);
    const T keep = (n2 > dep_tol2 * n2o[(size_t)b * p + t]) ? T(1) : T(0);
    const T inv = rsqrt_(n2 + T(TINY)) * keep;
    for (int e = tid; e < m; e += NT) {
      x[e].re *= inv;
      x[e].im *= inv;
    }
  }
  __syncthreads();

  Cx<T>* qb = q + (size_t)b * m * p;
  for (int idx = tid; idx < m * p; idx += NT) {
    const int e = idx / p, j = idx - e * p;
    qb[idx] = W[(size_t)j * ld + e];
  }
}

template <typename T>
int launch(const void* a, const void* n2o, void* q, void* scratch, int B, int m, int p,
           double dep_tol2, int panel_smem, long long smem, cudaStream_t stream) {
  if (B < 1 || m < 1 || p < 1 || p > MAX_P) return (int)cudaErrorInvalidValue;
  if (smem < (long long)smem_bytes<T>(m, p, panel_smem)) return (int)cudaErrorInvalidValue;
  void (*kern)(const Cx<T>*, const T*, Cx<T>*, Cx<T>*, int, int, T) =
      panel_smem ? mgs2_panel_kernel<T, true> : mgs2_panel_kernel<T, false>;
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

// Dynamic shared memory of a launch plan for [m, p] panels (dbl: complex128).
long long qk_mgs2_smem(int m, int p, int dbl, int panel_smem) {
  return dbl ? (long long)qk::mgs2::smem_bytes<double>(m, p, panel_smem)
             : (long long)qk::mgs2::smem_bytes<float>(m, p, panel_smem);
}

// a [B, m, p] and q [B, m, p] complex, n2o [B, p] real of the same precision;
// dep_tol2 the cutoff on squared norms; panel_smem 0: ``scratch`` holds
// p * (m + 1) complex elements per batch element.
int qk_mgs2_launch(const void* a, const void* n2o, void* q, void* scratch, int B, int m, int p,
                   int dbl, double dep_tol2, int panel_smem, long long smem_bytes,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dbl ? qk::mgs2::launch<double>(a, n2o, q, scratch, B, m, p, dep_tol2, panel_smem,
                                        smem_bytes, s)
             : qk::mgs2::launch<float>(a, n2o, q, scratch, B, m, p, dep_tol2, panel_smem,
                                       smem_bytes, s);
}

}  // extern "C"
