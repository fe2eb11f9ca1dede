// The 512-thread, one-block-per-element building blocks of kernels K1
// (subspace_split.cu), K2 (orth_r.cu), K3 (orth.cu), K4 (gate_split.cu) and
// K5 (brick_split.cu): a register-tiled complex GEMM over shared (or global)
// memory, the BCGS2 orthonormalization of the rows of a matrix in place, the
// power-iteration chain of the subspace split on one theta (split_chain), the
// register-tiled theta build of a gated pair (theta_build), and the laid-out
// buffers of the kernels.
//
// Replaces, for K1 to K5: qml_cutensornet_tpu/ops/pallas_qr.py:orth_rows_body,
// pallas_split.py:_split_chain, _build_theta_quadrants and _gate_combine.
// Same algorithm, same
// constants (bcgs2.cuh): panels of PANEL = 16; two CGS passes of each panel
// against the finished vectors; then MGS2 column by column inside the panel;
// a column whose residual norm^2 is not above dep_tol2 (1e-10 complex64,
// 1e-24 complex128) times its norm^2 before projection is written as exact
// zeros, otherwise scaled by rsqrt(n2 + TINY). Exact-zero input vectors and
// exact-zero entries shared by every input vector stay exactly zero.
//
// Why one block per element and not a thread-block cluster: one cluster-wide
// reduction round (barrier.cluster arrive/wait plus the partials read over
// distributed shared memory) measured 0.96 / 1.02 / 1.17 us at cluster sizes
// 2 / 4 / 8 on the H100, against 0.13 us for a block-wide reduction of 256
// threads and 0.03 / 0.05 us for one __syncthreads at 256 / 1024 threads
// (utils/cluster_probe.py). K1 makes about 770 dependent reduction rounds a
// call at chi 64; at 1 us each the rounds alone would take as long as the
// whole orthonormalization did before.
//
// What the design does about the old limits:
// - Products (the chain's five theta products, the CGS passes, K2's r = Q^H v)
//   are one GEMM routine: each thread holds a 4 x 4 tile of complex outputs in
//   registers (16 independent accumulator pairs), a warp covers 4 to 32 rows
//   by 128 to 16 columns, lanes on neighbouring columns (conflict-free rows of
//   odd stride, broadcast reads of the row operand). 512 threads leave each
//   thread up to 128 registers, which the 4 x 4 tile needs; 1024 would leave
//   64.
// - theta lives in shared memory for the whole launch when it fits beside the
//   working rows: at chi 64 in complex64 (theta 128 x 129, 132 KB) that needs
//   the rows W and V to share one buffer, which works because each product
//   keeps its whole output in registers (at most 16 warps x 4 rows x 128
//   columns = 8192 outputs, one pass) and overwrites its input only after a
//   barrier. theta is copied in once with coalesced loads; its rows have an odd
//   stride (k + 1) so that the V product, whose lanes walk down a column of
//   theta, reads without bank conflicts (which also rules out a bulk tensor
//   copy, whose rows must be 16-byte aligned).
// - The CGS coefficients: each warp takes 4 x 4 tiles, its lanes split the
//   vector, and one reduce-scatter butterfly of 31 shuffles sums the tile.
// - Inside a panel the column steps run on the registers of a group of warps
//   (4 warps, one or two vector elements a thread, for K1, K2, K4 and K5; K3
//   names a group by its vector length, up to the whole block, and past 1024
//   elements keeps the panel in memory): two reduction rounds a column (the
//   first pass shares its round with the previous column's norm), each a warp
//   butterfly, one named barrier of the group and the group's warp partials
//   added in a fixed order; no block-wide barrier.
//
// The block-2 in-panel variant (the reference's pair=True, mgs_pair): a
// source built with -DQK_PAIR is the pair library, whose complex64 kernels
// take the in-panel step two columns at a time (mgs_pairs below: both columns
// of a pair projected twice against the panel's finished prefix in the same
// rounds, then the second projected twice against the first); it has no
// complex128 kernels, because the reference's f64 path never reaches a kernel
// and so never reads the flag (the wrappers send complex128 to the
// single-column library).
//
// Arithmetic: full-precision complex FMAs on CUDA cores, no TF32, no tensor
// cores. Every sum is taken in a fixed order, with no atomics: two launches on
// the same input give bit-equal outputs.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "bcgs2.cuh"

// Phase stamps for utils/chain_stamps.py: built with -DQK_STAMPS, thread 0
// of block 0 records clock64() and a phase id where a phase ends (after the
// barrier that closes it, or after each in-panel reduction round); the
// stamp that opens a kernel (id 1) restarts the count. Without -DQK_STAMPS
// the stamps compile to nothing.
#ifdef QK_STAMPS
__device__ long long qk_stamp_t[8192];
__device__ int qk_stamp_id[8192];
__device__ int qk_stamp_n;
__shared__ int qk_stamp_ns;  // the count, kept where thread 0 reads it cheaply
#define QK_STAMP(id)                                                        \
  do {                                                                      \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                              \
      const int qk_n = (id) == 1 ? 0 : qk_stamp_ns;                         \
      if (qk_n < 8192) {                                                    \
        qk_stamp_t[qk_n] = clock64();                                       \
        qk_stamp_id[qk_n] = (id);                                           \
        qk_stamp_ns = qk_n + 1;                                             \
        qk_stamp_n = qk_n + 1;                                              \
      }                                                                     \
    }                                                                       \
  } while (0)
// Copies up to ``cap`` stamps (clock64 values and phase ids) of the last
// stamped launch to the host and returns how many there were, or
// -(cudaError_t). Each library that includes this header has its own.
extern "C" int qk_read_stamps(long long* t, int* id, int cap) {
  int n = 0;
  cudaError_t e = cudaMemcpyFromSymbol(&n, qk_stamp_n, sizeof(int));
  if (e == cudaSuccess && n > cap) n = cap;
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(t, qk_stamp_t, n * sizeof(long long));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(id, qk_stamp_id, n * sizeof(int));
  return e == cudaSuccess ? n : -(int)e;
}
#else
#define QK_STAMP(id) \
  do {               \
  } while (0)
#endif

// QK_DOUBLE(launch) is the complex128 launch in the single-column library and
// a refusal in the pair library, whose kernels are complex64 only.
#ifdef QK_PAIR
#define QK_DOUBLE(...) ((int)cudaErrorInvalidValue)
#else
#define QK_DOUBLE(...) (__VA_ARGS__)
#endif

// 1 in the pair library, 0 in the single-column one (each library that
// includes this header has its own).
extern "C" int qk_pair_step() {
#ifdef QK_PAIR
  return 1;
#else
  return 0;
#endif
}

namespace qk {
namespace blk {

#ifdef QK_PAIR
constexpr bool LIB_PAIR = true;
#else
constexpr bool LIB_PAIR = false;
#endif

// Phase ids of the stamps.
enum Stamp {
  ST_START = 1, ST_LOAD, ST_PANEL, ST_CGS, ST_COLUMN, ST_PRODUCT, ST_ORTH, ST_END, ST_COEF,
  ST_ROUND, ST_BUILD, ST_S2, ST_NA0, ST_PROJECT
};

constexpr int NT = 512;
constexpr int NW = NT / 32;
constexpr int TC = 4;  // output columns per thread (rows: TJ, 4 unless stated)

// Lanes a warp spreads over the columns of an ncol-wide output: the fewest
// (4 to 32) whose tiles cover ncol. Each thread holds TJ rows by TC columns.
__host__ __device__ inline int gemm_lanes(int ncol) {
  int lc = 4;
  while (lc < 32 && lc * TC < ncol) lc *= 2;
  return lc;
}

// Warp tiles of an [nj, ncol] output at 4 rows a thread.
__host__ __device__ inline int gemm_tiles(int nj, int ncol) {
  const int lc = gemm_lanes(ncol);
  const int jw = (32 / lc) * 4, cw = lc * TC;
  return ((nj + jw - 1) / jw) * ((ncol + cw - 1) / cw);
}

// out(j, c) = sum_r opX(X[j * xj + r * xr]) * opY(Y[r * yr + c * yc]) for
// j < nj, c < ncol, r < nr, stored at O[j * oj + c * oc] (SUB: subtracted
// from what is there), TJ rows by TC columns a thread. opX / opY conjugate
// when CONJX / CONJY. INPLACE (with TJ 4): O may
// alias X or Y; the caller guarantees gemm_tiles(nj, ncol) <= NW (one pass),
// and every thread reaches the barrier between the last read and the first
// store. Without INPLACE there is no barrier.
template <typename T, bool CONJX, bool CONJY, bool SUB, bool INPLACE, int TJ = 4>
__device__ __forceinline__ void gemm(const Cx<T>* X, int xj, int xr, const Cx<T>* Y, int yr, int yc, Cx<T>* O,
                     int oj, int oc, int nj, int ncol, int nr) {
  const int lc = gemm_lanes(ncol);
  const int rg = 32 / lc;
  const int jw = rg * TJ, cw = lc * TC;
  const int njt = (nj + jw - 1) / jw, nct = (ncol + cw - 1) / cw;
  const int ntiles = njt * nct;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T sx = CONJX ? T(-1) : T(1);
  const T sy = CONJY ? T(-1) : T(1);
  for (int t0 = 0; t0 < ntiles; t0 += NW) {
    const int tile = t0 + warp;
    const bool live = tile < ntiles;
    const int j0 = (live ? tile / nct : 0) * jw + (lane / lc) * TJ;
    const int c0 = (live ? tile % nct : 0) * cw + (lane % lc);
    T ar[TJ][TC], ai[TJ][TC];
#pragma unroll
    for (int u = 0; u < TJ; ++u)
#pragma unroll
      for (int v = 0; v < TC; ++v) ar[u][v] = ai[u][v] = T(0);
    // Rows and columns past the edge read row / column 0 (always there) and
    // are never stored.
    int jr[TJ], cr[TC];
#pragma unroll
    for (int u = 0; u < TJ; ++u) jr[u] = (j0 + u < nj) ? j0 + u : 0;
#pragma unroll
    for (int v = 0; v < TC; ++v) cr[v] = (c0 + v * lc < ncol) ? c0 + v * lc : 0;
    if (live) {
#pragma unroll 2
      for (int r = 0; r < nr; ++r) {
        Cx<T> x[TJ], y[TC];
#pragma unroll
        for (int u = 0; u < TJ; ++u) x[u] = X[(size_t)jr[u] * xj + (size_t)r * xr];
#pragma unroll
        for (int v = 0; v < TC; ++v) y[v] = Y[(size_t)r * yr + (size_t)cr[v] * yc];
#pragma unroll
        for (int u = 0; u < TJ; ++u) {
          const T xre = x[u].re, xim = sx * x[u].im;
#pragma unroll
          for (int v = 0; v < TC; ++v) {
            const T yre = y[v].re, yim = sy * y[v].im;
            ar[u][v] += xre * yre - xim * yim;
            ai[u][v] += xre * yim + xim * yre;
          }
        }
      }
    }
    if (INPLACE) __syncthreads();
    if (live) {
#pragma unroll
      for (int u = 0; u < TJ; ++u) {
        if (j0 + u >= nj) continue;
#pragma unroll
        for (int v = 0; v < TC; ++v) {
          const int c = c0 + v * lc;
          if (c >= ncol) continue;
          Cx<T>* o = O + (size_t)(j0 + u) * oj + (size_t)c * oc;
          if (SUB) {
            o->re -= ar[u][v];
            o->im -= ai[u][v];
          } else {
            *o = Cx<T>{ar[u][v], ai[u][v]};
          }
        }
      }
    }
  }
}

// The in-panel steps run on a group of the block's first GWN warps,
// synchronized by a named barrier. K1, K2, K4 and K5 take GWN = GW with one
// or two vector elements a thread (len <= 2 * GW * 32); K3 takes the group
// its launch plan names (orth.cu), up to the whole block.
constexpr int GW = 4;
constexpr int GT = GW * 32;

template <int GWN = GW>
__device__ __forceinline__ void group_bar() {
  asm volatile("bar.sync 1, %0;" ::"n"(GWN * 32) : "memory");
}

// One stage of the reduce-scatter butterfly and the stages after it: lanes
// that differ in bit K swap halves of v[0..2K-1], each keeping the half its
// bit selects, so that afterwards slot j holds index j + K * bit. Written as
// a recursion so that every index is a compile-time constant (v stays in
// registers).
template <int K, int N, typename T>
__device__ __forceinline__ void butterfly(T (&v)[N], int lane) {
  if constexpr (K >= 1) {
    const bool upper = (lane & K) != 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const T send = upper ? v[j] : v[j + K];
      const T keep = upper ? v[j + K] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, K);
    }
    butterfly<K / 2, N, T>(v, lane);
  }
}

// The xor stages K, 2K, ..., 16 of a plain warp sum.
template <int K, typename T>
__device__ __forceinline__ T xor_sum(T s) {
  if constexpr (K < 32) {
    return xor_sum<2 * K, T>(s + __shfl_xor_sync(0xffffffffu, s, K));
  } else {
    return s;
  }
}

// v[0..N-1] in every lane (N a power of 2, at most 32). Returns, in lane l,
// the sum over the warp's lanes of v[l % N]: a reduce-scatter butterfly
// (N / 2 + ... + 1 shuffles), then xor stages over the lanes that hold the
// same index. Every lane of one index gets the bit-identical sum.
template <int N, typename T>
__device__ __forceinline__ T warp_reduce_scatter(T (&v)[N]) {
  butterfly<N / 2, N, T>(v, threadIdx.x & 31);
  return xor_sum<N, T>(v[0]);
}

// Scratch of bcgs2_rows in dynamic shared memory: CGS coefficients (nvec x
// PANEL complex) and the panel's norms^2 before projection (PANEL). The
// in-panel group's reduction slots are mgs_panel's (or mgs_panel_pair's)
// static shared memory (static_smem_bytes, pair_static_smem_bytes: both
// element counts of one dtype).
template <typename T>
struct OrthWork {
  Cx<T>* coef;
  T* n2o;
};

template <typename T>
__host__ __device__ inline size_t orth_work_bytes(int nvec) {
  return (size_t)nvec * PANEL * sizeof(Cx<T>) + (size_t)PANEL * sizeof(T);
}

template <typename T>
__host__ __device__ inline size_t static_smem_bytes() {
  return 2 * (size_t)(2 * GW * 32) * sizeof(T);
}

// The same for the pair step (mgs_panel_pair): 2 x GW x 64 values a set.
template <typename T>
__host__ __device__ inline size_t pair_static_smem_bytes() {
  return 2 * (size_t)(2 * GW * 64) * sizeof(T);
}

template <typename T>
__device__ __forceinline__ OrthWork<T> orth_work_carve(unsigned char* p, int nvec) {
  OrthWork<T> w;
  w.coef = reinterpret_cast<Cx<T>*>(p);
  w.n2o = reinterpret_cast<T*>(w.coef + (size_t)nvec * PANEL);
  return w;
}

// One reduction round of a group of GWN warps: every thread gives
// v[0..N-1]; every thread gets, in lane l, the group-wide sum of v[l % N]
// (warp butterflies, one named barrier, then the GWN warp partials added in
// warp order, so every thread holds bit-identical sums). ``part`` holds two
// buffers of GWN x 32 values, used in turn.
template <int N, int GWN = GW, typename T>
__device__ __forceinline__ T group_sum(T (&v)[N], T* part, int& buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T s = warp_reduce_scatter<N>(v);
  T* pb = part + buf * (GWN * 32);
  if (lane < N) pb[warp * 32 + lane] = s;
  group_bar<GWN>();
  T tot = 0;
#pragma unroll
  for (int w = 0; w < GWN; ++w) tot += pb[w * 32 + (lane % N)];
  buf ^= 1;
  QK_STAMP(ST_ROUND);
  return tot;
}

// Scale a column of the group's registers to unit norm given its norm^2
// n2, or to exact zeros when it is dependent (n2 not above dep_tol2 times its
// norm^2 before projection); returns the factor.
template <typename T, int EPL>
__device__ __forceinline__ T finish_column(Cx<T> (&x)[EPL], T n2, T n2o, T dep_tol2) {
  const T keep = (n2 > dep_tol2 * n2o) ? T(1) : T(0);
  const T inv = rsqrt_(n2 + T(TINY)) * keep;
#pragma unroll
  for (int u = 0; u < EPL; ++u) {
    x[u].re *= inv;
    x[u].im *= inv;
  }
  QK_STAMP(ST_COLUMN);
  return inv;
}

template <typename T, int EPL>
__device__ __forceinline__ T norm2(const Cx<T> (&x)[EPL]) {
  T s = 0;
#pragma unroll
  for (int u = 0; u < EPL; ++u) s += x[u].re * x[u].re + x[u].im * x[u].im;
  return s;
}

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// v[2s], v[2s + 1] = this thread's part of conj(x_s) . x_TGT for s < NS,
// zeros above.
template <typename T, int EPL, int NS, int TGT, int N>
__device__ __forceinline__ void dots(const Cx<T> (&x)[PANEL][EPL], T (&v)[N]) {
#pragma unroll
  for (int s = 0; s < N / 2; ++s) {
    T re = 0, im = 0;
    if (s < NS) {
#pragma unroll
      for (int u = 0; u < EPL; ++u) {
        re += x[s][u].re * x[TGT][u].re + x[s][u].im * x[TGT][u].im;
        im += x[s][u].re * x[TGT][u].im - x[s][u].im * x[TGT][u].re;
      }
    }
    v[2 * s] = re;
    v[2 * s + 1] = im;
  }
}

// x[TGT] -= sum_{s < NS} x[s] c[s], the coefficients c[s] taken from lanes
// 2s, 2s + 1 of ``tot`` (column NS - 1's coefficient times ``last``), in two
// interleaved chains.
template <typename T, int EPL, int NS, int TGT>
__device__ __forceinline__ void project_out(Cx<T> (&x)[PANEL][EPL], T tot, T last) {
  T sr[2][EPL], si[2][EPL];
#pragma unroll
  for (int u = 0; u < EPL; ++u) sr[0][u] = sr[1][u] = si[0][u] = si[1][u] = T(0);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    T cr = __shfl_sync(0xffffffffu, tot, 2 * s);
    T ci = __shfl_sync(0xffffffffu, tot, 2 * s + 1);
    if (s == NS - 1) {
      cr *= last;
      ci *= last;
    }
#pragma unroll
    for (int u = 0; u < EPL; ++u) {
      sr[s & 1][u] += x[s][u].re * cr - x[s][u].im * ci;
      si[s & 1][u] += x[s][u].re * ci + x[s][u].im * cr;
    }
  }
#pragma unroll
  for (int u = 0; u < EPL; ++u) {
    x[TGT][u].re -= sr[0][u] + sr[1][u];
    x[TGT][u].im -= si[0][u] + si[1][u];
  }
}

// The in-panel MGS2 from column TT on, on the group's registers: x[t][u] is
// element threadIdx.x + u * GT of panel column t (zero past the vector's
// length and past the panel's width pw); columns before TT - 1 are finished
// and column TT - 1 waits for its norm. Column TT takes two group rounds:
// the first sums the coefficients conj(x_s) . x_TT (s < TT) together with
// column TT - 1's norm^2, which finishes column TT - 1 (its coefficient is
// scaled by the same factor as the column, so the pass projects on the
// finished q); the second is the second pass. The last column's norm is a
// round of its own. Unrolled over the columns, so every register index and
// every butterfly width is a compile-time constant.
template <typename T, int EPL, int TT, int GWN = GW>
__device__ __forceinline__ void mgs_columns(Cx<T> (&x)[PANEL][EPL], int pw, T* part, int& buf,
                                            const T* n2o, T dep_tol2) {
  if constexpr (TT == PANEL) {
    T v[1] = {norm2<T, EPL>(x[PANEL - 1])};
    finish_column<T, EPL>(x[PANEL - 1], group_sum<1, GWN>(v, part, buf), n2o[PANEL - 1],
                          dep_tol2);
  } else if constexpr (TT == 0) {
    mgs_columns<T, EPL, 1, GWN>(x, pw, part, buf, n2o, dep_tol2);
  } else {
    if (TT >= pw) {
      T v[1] = {norm2<T, EPL>(x[TT - 1])};
      finish_column<T, EPL>(x[TT - 1], group_sum<1, GWN>(v, part, buf), n2o[TT - 1], dep_tol2);
      return;
    }
    constexpr int N = pow2_at_least(2 * TT + 1);
    T v[N];
    dots<T, EPL, TT, TT, N>(x, v);
    v[2 * TT] = norm2<T, EPL>(x[TT - 1]);
    T tot = group_sum<N, GWN>(v, part, buf);
    const T inv = finish_column<T, EPL>(x[TT - 1], __shfl_sync(0xffffffffu, tot, 2 * TT),
                                        n2o[TT - 1], dep_tol2);
    project_out<T, EPL, TT, TT>(x, tot, inv);
    T w[N];
    dots<T, EPL, TT, TT, N>(x, w);
    tot = group_sum<N, GWN>(w, part, buf);
    project_out<T, EPL, TT, TT>(x, tot, T(1));
    mgs_columns<T, EPL, TT + 1, GWN>(x, pw, part, buf, n2o, dep_tol2);
  }
}

// The panel's MGS2 on a group of GWN warps (len <= EPL * GWN * 32): load the
// panel into registers, run the columns, store them back. Not inlined: one
// copy per (T, EPL, GWN) for every kernel of a source, which keeps the
// unrolled column code from being compiled once per call site and launch
// plan. Its reduction slots are static shared memory of its own (2 x GWN x
// 32 values), so their accesses are known to be shared-memory ones.
template <typename T, int EPL, int GWN = GW>
__device__ __noinline__ void mgs_panel(Cx<T>* P, int ld, int pw, int len, const T* n2o,
                                       T dep_tol2) {
  __shared__ T part[2 * GWN * 32];
  int buf = 0;
  Cx<T> x[PANEL][EPL];
#pragma unroll
  for (int t = 0; t < PANEL; ++t)
#pragma unroll
    for (int u = 0; u < EPL; ++u) {
      const int e = threadIdx.x + u * GWN * 32;
      x[t][u] = (t < pw && e < len) ? P[(size_t)t * ld + e] : Cx<T>{T(0), T(0)};
    }
  mgs_columns<T, EPL, 0, GWN>(x, pw, part, buf, n2o, dep_tol2);
#pragma unroll
  for (int t = 0; t < PANEL; ++t)
#pragma unroll
    for (int u = 0; u < EPL; ++u) {
      const int e = threadIdx.x + u * GWN * 32;
      if (t < pw && e < len) P[(size_t)t * ld + e] = x[t][u];
    }
}

// The same MGS2 for a vector of any length, with the panel left where it is
// (shared or global memory) and the whole block as the group: each thread
// owns the elements threadIdx.x + u * NT of every column and is the only
// thread to read or write them, so the rounds' sums are the only traffic
// between threads. Column TT takes the register version's two rounds, each
// a pass over the thread's elements of columns 0..TT.
template <typename T, int TT>
__device__ __forceinline__ void mgs_columns_mem(Cx<T>* P, int ld, int pw, int len, T* part,
                                                int& buf, const T* n2o, T dep_tol2) {
  const int tid = threadIdx.x;
  // Column c's norm^2 from the round's sum: scale it to unit norm, or to
  // exact zeros when dependent.
  auto finish = [&](int c, T n2) {
    const T keep = (n2 > dep_tol2 * n2o[c]) ? T(1) : T(0);
    const T inv = rsqrt_(n2 + T(TINY)) * keep;
    for (int e = tid; e < len; e += NT) {
      Cx<T>& x = P[(size_t)c * ld + e];
      x.re *= inv;
      x.im *= inv;
    }
    QK_STAMP(ST_COLUMN);
    return inv;
  };
  auto norm = [&](int c) {
    T s = 0;
    for (int e = tid; e < len; e += NT) {
      const Cx<T> x = P[(size_t)c * ld + e];
      s += x.re * x.re + x.im * x.im;
    }
    return s;
  };
  if constexpr (TT == PANEL) {
    T v[1] = {norm(PANEL - 1)};
    finish(PANEL - 1, group_sum<1, NW>(v, part, buf));
  } else if constexpr (TT == 0) {
    mgs_columns_mem<T, 1>(P, ld, pw, len, part, buf, n2o, dep_tol2);
  } else {
    if (TT >= pw) {
      T v[1] = {norm(TT - 1)};
      finish(TT - 1, group_sum<1, NW>(v, part, buf));
      return;
    }
    constexpr int N = pow2_at_least(2 * TT + 1);
    Cx<T>* xt = P + (size_t)TT * ld;
    // v[2s], v[2s + 1] = this thread's part of conj(x_s) . x_TT (s < TT)
    auto dots_mem = [&](T (&v)[N]) {
#pragma unroll
      for (int a = 0; a < N; ++a) v[a] = T(0);
      for (int e = tid; e < len; e += NT) {
        const Cx<T> b = xt[e];
#pragma unroll
        for (int s = 0; s < TT; ++s) {
          const Cx<T> a = P[(size_t)s * ld + e];
          v[2 * s] += a.re * b.re + a.im * b.im;
          v[2 * s + 1] += a.re * b.im - a.im * b.re;
        }
      }
    };
    // x_TT -= sum_s x_s c_s, the coefficients from lanes 2s, 2s + 1 of tot
    // (column TT - 1's times ``last``), in two interleaved chains.
    auto project = [&](T tot, T last) {
      T cr[TT], ci[TT];
#pragma unroll
      for (int s = 0; s < TT; ++s) {
        cr[s] = __shfl_sync(0xffffffffu, tot, 2 * s);
        ci[s] = __shfl_sync(0xffffffffu, tot, 2 * s + 1);
      }
      cr[TT - 1] *= last;
      ci[TT - 1] *= last;
      for (int e = tid; e < len; e += NT) {
        T sr[2] = {T(0), T(0)}, si[2] = {T(0), T(0)};
#pragma unroll
        for (int s = 0; s < TT; ++s) {
          const Cx<T> a = P[(size_t)s * ld + e];
          sr[s & 1] += a.re * cr[s] - a.im * ci[s];
          si[s & 1] += a.re * ci[s] + a.im * cr[s];
        }
        xt[e].re -= sr[0] + sr[1];
        xt[e].im -= si[0] + si[1];
      }
    };
    T v[N];
    dots_mem(v);
    v[2 * TT] = norm(TT - 1);
    T tot = group_sum<N, NW>(v, part, buf);
    const T inv = finish(TT - 1, __shfl_sync(0xffffffffu, tot, 2 * TT));
    project(tot, inv);
    dots_mem(v);
    tot = group_sum<N, NW>(v, part, buf);
    project(tot, T(1));
    mgs_columns_mem<T, TT + 1>(P, ld, pw, len, part, buf, n2o, dep_tol2);
  }
}

template <typename T>
__device__ __noinline__ void mgs_panel_mem(Cx<T>* P, int ld, int pw, int len, const T* n2o,
                                           T dep_tol2) {
  __shared__ T part[2 * NT];
  int buf = 0;
  mgs_columns_mem<T, 0>(P, ld, pw, len, part, buf, n2o, dep_tol2);
}

// ------------------------------------- the block-2 in-panel step (pair)
//
// The reference's pair=True branch of orth_rows_body (pallas_qr.py:162-208).
// For each pair of columns (t, t + 1): two CGS passes of both columns against
// the panel's finished prefix [0, t); column t finished (norm^2 against
// dep_tol2 times its norm^2 before projection, then zeroed or scaled by
// rsqrt(n2 + TINY)); column t + 1 projected twice against the new q_t; column
// t + 1 finished. Merged rounds, as the single-column step merges them: the
// first prefix pass shares its round with column t - 1's norm (the previous
// pair's second column), whose coefficients are scaled by the factor that
// finishes it; column t's norm and conj(x_t) . x_{t+1} share one round, the
// coefficient scaled like the column. A pair's prefix round sums 2 x t
// complex coefficients and a norm, up to 57 values at t = 14, past the 32 of
// one butterfly: each column's coefficients take a butterfly of their own,
// and both go through one named barrier (group_sums). The last column of a
// panel of odd width has no partner: it takes the prefix passes and its norm
// alone (the single-column step). Four rounds a pair, as the single-column
// step's two a column.

// One reduction round of a group of GWN warps over A (1 or 2) sets of N
// values: every thread gives v[a][0..N-1] and gets, in lane l, the group-wide
// sum of v[a][l % N] in tot[a] (a butterfly per set, one named barrier, the
// warp partials added in warp order). ``part`` holds two buffers of GWN x 64
// values (a 32-value slot per set and warp), used in turn.
template <int N, int A, int GWN, typename T>
__device__ __forceinline__ void group_sums(T (&v)[A][N], T (&tot)[A], T* part, int& buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* pb = part + buf * (GWN * 64);
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const T s = warp_reduce_scatter<N>(v[a]);
    if (lane < N) pb[(2 * warp + a) * 32 + lane] = s;
  }
  group_bar<GWN>();
#pragma unroll
  for (int a = 0; a < A; ++a) {
    T t = 0;
#pragma unroll
    for (int w = 0; w < GWN; ++w) t += pb[(2 * w + a) * 32 + (lane % N)];
    tot[a] = t;
  }
  buf ^= 1;
  QK_STAMP(ST_ROUND);
}

// This thread's part of conj(x_C) . x_{C+1}.
template <typename T, int EPL, int C>
__device__ __forceinline__ void pair_dot(const Cx<T> (&x)[PANEL][EPL], T& re, T& im) {
  re = im = T(0);
#pragma unroll
  for (int u = 0; u < EPL; ++u) {
    re += x[C][u].re * x[C + 1][u].re + x[C][u].im * x[C + 1][u].im;
    im += x[C][u].re * x[C + 1][u].im - x[C][u].im * x[C + 1][u].re;
  }
}

// x_{C+1} -= x_C (cr + i ci).
template <typename T, int EPL, int C>
__device__ __forceinline__ void pair_project(Cx<T> (&x)[PANEL][EPL], T cr, T ci) {
#pragma unroll
  for (int u = 0; u < EPL; ++u) {
    x[C + 1][u].re -= x[C][u].re * cr - x[C][u].im * ci;
    x[C + 1][u].im -= x[C][u].re * ci + x[C][u].im * cr;
  }
}

// The last round of a column that waits only for its norm: finish it.
template <typename T, int EPL, int C, int GWN>
__device__ __forceinline__ void pair_norm_round(Cx<T> (&x)[PANEL][EPL], T* part, int& buf,
                                                const T* n2o, T dep_tol2) {
  T v[1][1] = {{norm2<T, EPL>(x[C])}};
  T tot[1];
  group_sums<1, 1, GWN>(v, tot, part, buf);
  finish_column<T, EPL>(x[C], tot[0], n2o[C], dep_tol2);
}

// The in-panel block-2 MGS2 from the pair (TT, TT + 1) on (TT even), on the
// group's registers (layout as mgs_columns): columns before TT - 1 are
// finished and column TT - 1 waits for its norm. Unrolled over the pairs.
template <typename T, int EPL, int TT, int GWN>
__device__ __forceinline__ void mgs_pairs(Cx<T> (&x)[PANEL][EPL], int pw, T* part, int& buf,
                                          const T* n2o, T dep_tol2) {
  if constexpr (TT == PANEL) {
    pair_norm_round<T, EPL, PANEL - 1, GWN>(x, part, buf, n2o, dep_tol2);
  } else {
    if (TT >= pw) {
      if constexpr (TT > 0) pair_norm_round<T, EPL, TT - 1, GWN>(x, part, buf, n2o, dep_tol2);
      return;
    }
    if constexpr (TT > 0) {
      // Two passes of both columns against [0, TT); column TT + 1 is zeros
      // past the panel's width, and stays so.
      constexpr int N = pow2_at_least(2 * TT + 1);
      T v[2][N], tot[2];
      dots<T, EPL, TT, TT, N>(x, v[0]);
      dots<T, EPL, TT, TT + 1, N>(x, v[1]);
      v[0][2 * TT] = norm2<T, EPL>(x[TT - 1]);
      group_sums<N, 2, GWN>(v, tot, part, buf);
      const T inv = finish_column<T, EPL>(x[TT - 1], __shfl_sync(0xffffffffu, tot[0], 2 * TT),
                                          n2o[TT - 1], dep_tol2);
      project_out<T, EPL, TT, TT>(x, tot[0], inv);
      project_out<T, EPL, TT, TT + 1>(x, tot[1], inv);
      dots<T, EPL, TT, TT, N>(x, v[0]);
      dots<T, EPL, TT, TT + 1, N>(x, v[1]);
      group_sums<N, 2, GWN>(v, tot, part, buf);
      project_out<T, EPL, TT, TT>(x, tot[0], T(1));
      project_out<T, EPL, TT, TT + 1>(x, tot[1], T(1));
    }
    if (TT + 1 == pw) {  // the odd panel's last column: no partner
      pair_norm_round<T, EPL, TT, GWN>(x, part, buf, n2o, dep_tol2);
      return;
    }
    // Column TT's norm and conj(x_TT) . x_{TT+1} in one round: column TT
    // finished, x_{TT+1} projected on q_TT (the coefficient scaled like the
    // column); then the second pass against q_TT.
    T u[1][4] = {{norm2<T, EPL>(x[TT]), T(0), T(0), T(0)}};
    pair_dot<T, EPL, TT>(x, u[0][1], u[0][2]);
    T tot[1];
    group_sums<4, 1, GWN>(u, tot, part, buf);
    const T inv = finish_column<T, EPL>(x[TT], __shfl_sync(0xffffffffu, tot[0], 0), n2o[TT],
                                        dep_tol2);
    pair_project<T, EPL, TT>(x, __shfl_sync(0xffffffffu, tot[0], 1) * inv,
                             __shfl_sync(0xffffffffu, tot[0], 2) * inv);
    T d[1][2];
    pair_dot<T, EPL, TT>(x, d[0][0], d[0][1]);
    group_sums<2, 1, GWN>(d, tot, part, buf);
    pair_project<T, EPL, TT>(x, __shfl_sync(0xffffffffu, tot[0], 0),
                             __shfl_sync(0xffffffffu, tot[0], 1));
    mgs_pairs<T, EPL, TT + 2, GWN>(x, pw, part, buf, n2o, dep_tol2);
  }
}

// mgs_panel with the block-2 step; its reduction slots are 2 x GWN x 64
// values of static shared memory (pair_static_smem_bytes).
template <typename T, int EPL, int GWN = GW>
__device__ __noinline__ void mgs_panel_pair(Cx<T>* P, int ld, int pw, int len, const T* n2o,
                                            T dep_tol2) {
  __shared__ T part[2 * GWN * 64];
  int buf = 0;
  Cx<T> x[PANEL][EPL];
#pragma unroll
  for (int t = 0; t < PANEL; ++t)
#pragma unroll
    for (int u = 0; u < EPL; ++u) {
      const int e = threadIdx.x + u * GWN * 32;
      x[t][u] = (t < pw && e < len) ? P[(size_t)t * ld + e] : Cx<T>{T(0), T(0)};
    }
  mgs_pairs<T, EPL, 0, GWN>(x, pw, part, buf, n2o, dep_tol2);
#pragma unroll
  for (int t = 0; t < PANEL; ++t)
#pragma unroll
    for (int u = 0; u < EPL; ++u) {
      const int e = threadIdx.x + u * GWN * 32;
      if (t < pw && e < len) P[(size_t)t * ld + e] = x[t][u];
    }
}

// The block-2 step on the panel left in memory, the whole block as the group
// (as mgs_columns_mem: each thread owns the elements threadIdx.x + u * NT of
// every column). Row TT + 1 is read only when it lies inside the panel.
template <typename T, int TT>
__device__ __forceinline__ void mgs_pairs_mem(Cx<T>* P, int ld, int pw, int len, T* part,
                                              int& buf, const T* n2o, T dep_tol2) {
  const int tid = threadIdx.x;
  auto finish = [&](int c, T n2) {
    const T keep = (n2 > dep_tol2 * n2o[c]) ? T(1) : T(0);
    const T inv = rsqrt_(n2 + T(TINY)) * keep;
    for (int e = tid; e < len; e += NT) {
      Cx<T>& x = P[(size_t)c * ld + e];
      x.re *= inv;
      x.im *= inv;
    }
    QK_STAMP(ST_COLUMN);
    return inv;
  };
  auto norm_round = [&](int c) {
    T v[1][1] = {{T(0)}};
    for (int e = tid; e < len; e += NT) {
      const Cx<T> x = P[(size_t)c * ld + e];
      v[0][0] += x.re * x.re + x.im * x.im;
    }
    T tot[1];
    group_sums<1, 1, NW>(v, tot, part, buf);
    return finish(c, tot[0]);
  };
  if constexpr (TT == PANEL) {
    norm_round(PANEL - 1);
  } else {
    if (TT >= pw) {
      if constexpr (TT > 0) norm_round(TT - 1);
      return;
    }
    const bool two = TT + 1 < pw;
    Cx<T>* x0 = P + (size_t)TT * ld;
    Cx<T>* x1 = P + (size_t)(TT + 1) * ld;
    if constexpr (TT > 0) {
      constexpr int N = pow2_at_least(2 * TT + 1);
      // v[a][2s], v[a][2s + 1] = this thread's part of conj(x_s) . x_{TT+a}
      auto dots2 = [&](T (&v)[2][N]) {
#pragma unroll
        for (int a = 0; a < N; ++a) v[0][a] = v[1][a] = T(0);
        for (int e = tid; e < len; e += NT) {
          const Cx<T> b0 = x0[e];
          const Cx<T> b1 = two ? x1[e] : Cx<T>{T(0), T(0)};
#pragma unroll
          for (int s = 0; s < TT; ++s) {
            const Cx<T> a = P[(size_t)s * ld + e];
            v[0][2 * s] += a.re * b0.re + a.im * b0.im;
            v[0][2 * s + 1] += a.re * b0.im - a.im * b0.re;
            v[1][2 * s] += a.re * b1.re + a.im * b1.im;
            v[1][2 * s + 1] += a.re * b1.im - a.im * b1.re;
          }
        }
      };
      // x_{TT+a} -= sum_s x_s c_s, c_s from lanes 2s, 2s + 1 of tot[a]
      // (column TT - 1's times ``last``).
      auto project2 = [&](const T (&tot)[2], T last) {
        T cr[2][TT], ci[2][TT];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int s = 0; s < TT; ++s) {
            cr[a][s] = __shfl_sync(0xffffffffu, tot[a], 2 * s);
            ci[a][s] = __shfl_sync(0xffffffffu, tot[a], 2 * s + 1);
          }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          cr[a][TT - 1] *= last;
          ci[a][TT - 1] *= last;
        }
        for (int e = tid; e < len; e += NT) {
          T sr[2][2] = {{T(0), T(0)}, {T(0), T(0)}}, si[2][2] = {{T(0), T(0)}, {T(0), T(0)}};
#pragma unroll
          for (int s = 0; s < TT; ++s) {
            const Cx<T> a = P[(size_t)s * ld + e];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              sr[c][s & 1] += a.re * cr[c][s] - a.im * ci[c][s];
              si[c][s & 1] += a.re * ci[c][s] + a.im * cr[c][s];
            }
          }
          x0[e].re -= sr[0][0] + sr[0][1];
          x0[e].im -= si[0][0] + si[0][1];
          if (two) {
            x1[e].re -= sr[1][0] + sr[1][1];
            x1[e].im -= si[1][0] + si[1][1];
          }
        }
      };
      T v[2][N], tot[2];
      dots2(v);
      for (int e = tid; e < len; e += NT) {
        const Cx<T> x = P[(size_t)(TT - 1) * ld + e];
        v[0][2 * TT] += x.re * x.re + x.im * x.im;
      }
      group_sums<N, 2, NW>(v, tot, part, buf);
      const T inv = finish(TT - 1, __shfl_sync(0xffffffffu, tot[0], 2 * TT));
      project2(tot, inv);
      dots2(v);
      group_sums<N, 2, NW>(v, tot, part, buf);
      project2(tot, T(1));
    }
    if (!two) {  // the odd panel's last column: no partner
      norm_round(TT);
      return;
    }
    // conj(x_TT) . x_{TT+1} (this thread's part)
    auto pair_dot_mem = [&](T& re, T& im) {
      re = im = T(0);
      for (int e = tid; e < len; e += NT) {
        const Cx<T> a = x0[e], b = x1[e];
        re += a.re * b.re + a.im * b.im;
        im += a.re * b.im - a.im * b.re;
      }
    };
    auto pair_project_mem = [&](T cr, T ci) {
      for (int e = tid; e < len; e += NT) {
        const Cx<T> a = x0[e];
        x1[e].re -= a.re * cr - a.im * ci;
        x1[e].im -= a.re * ci + a.im * cr;
      }
    };
    T u[1][4] = {{T(0), T(0), T(0), T(0)}};
    for (int e = tid; e < len; e += NT) {
      const Cx<T> x = x0[e];
      u[0][0] += x.re * x.re + x.im * x.im;
    }
    pair_dot_mem(u[0][1], u[0][2]);
    T tot[1];
    group_sums<4, 1, NW>(u, tot, part, buf);
    const T inv = finish(TT, __shfl_sync(0xffffffffu, tot[0], 0));
    pair_project_mem(__shfl_sync(0xffffffffu, tot[0], 1) * inv,
                     __shfl_sync(0xffffffffu, tot[0], 2) * inv);
    T d[1][2];
    pair_dot_mem(d[0][0], d[0][1]);
    group_sums<2, 1, NW>(d, tot, part, buf);
    pair_project_mem(__shfl_sync(0xffffffffu, tot[0], 0), __shfl_sync(0xffffffffu, tot[0], 1));
    mgs_pairs_mem<T, TT + 2>(P, ld, pw, len, part, buf, n2o, dep_tol2);
  }
}

template <typename T>
__device__ __noinline__ void mgs_panel_pair_mem(Cx<T>* P, int ld, int pw, int len, const T* n2o,
                                                T dep_tol2) {
  __shared__ T part[2 * NT * 2];
  int buf = 0;
  mgs_pairs_mem<T, 0>(P, ld, pw, len, part, buf, n2o, dep_tol2);
}

// ------------------------------- panels of up to 32 columns (kernel K8)
//
// The in-panel MGS2 of kernel K8 (mgs2_panel.cu) on panels of up to WIDE =
// 32 columns: mgs_columns's two rounds a column on a panel twice as wide. A
// round of column t carries up to 2 t + 1 = 63 values (31 complex
// coefficients and a norm) in three sets, each through its own warp
// butterfly, all through one named barrier (wide_finish, as group_sums).
// The group is the whole block, GWN warps, EPL elements a lane (element
// threadIdx.x + u * GWN * 32 in slot u). Its registers hold the panel's
// columns 0 .. R - 1 for the whole panel; where the panel is wider, columns
// R .. pw - 1 wait in memory M (column s at M + (s - R) * ld, each thread
// touching only its own elements: shared memory, or global scratch where
// that cannot hold them). The column being projected sits in the register
// slot y and its predecessor in slot z until its norm is known; a finished
// column goes back to its register or memory slot. The columns run in a
// loop, not unrolled, and a loop over the finished columns jumps into a
// chain of unrolled steps, so every register index is a compile-time
// constant and the code stays linear in the panel's width.

constexpr int WIDE = 32;

// f(std::integral_constant<int, I>{}) for I = B .. E - 1 in order, so that
// every column index is a compile-time constant.
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    static_for<B + 1, E>(f);
  }
}

template <typename T, int EPL>
using CxCol = Cx<T>[EPL];

template <typename T, int EPL, int R>
struct WideCols {
  Cx<T> x[R][EPL];  // columns 0 .. R - 1
  Cx<T> y[EPL];     // the column being projected
  Cx<T> z[EPL];     // the column before it, waiting for its norm
  Cx<T>* M;         // columns R ..: M + (s - R) * ld
  int ld;
};

template <int GWN>
__device__ __forceinline__ int wide_elem(int u) {
  return threadIdx.x + u * GWN * 32;
}

// Register column c (LO <= c < HI) to or from a slot, by a binary tree of
// uniform branches, so that every register index is a constant.
template <int LO, int HI, bool PUT, typename T, int EPL, int R>
__device__ __forceinline__ void wide_move(WideCols<T, EPL, R>& w, int c, CxCol<T, EPL>& slot) {
  if constexpr (HI - LO == 1) {
#pragma unroll
    for (int u = 0; u < EPL; ++u) {
      if constexpr (PUT) {
        w.x[LO][u] = slot[u];
      } else {
        slot[u] = w.x[LO][u];
      }
    }
  } else {
    constexpr int MID = (LO + HI) / 2;
    if (c < MID) {
      wide_move<LO, MID, PUT>(w, c, slot);
    } else {
      wide_move<MID, HI, PUT>(w, c, slot);
    }
  }
}

// Column c to (PUT) or from a slot, from its registers or its memory.
template <bool PUT, int GWN, typename T, int EPL, int R>
__device__ __forceinline__ void wide_slot(WideCols<T, EPL, R>& w, int c, CxCol<T, EPL>& slot) {
  if (c < R) {
    wide_move<0, R, PUT>(w, c, slot);
  } else {
#pragma unroll
    for (int u = 0; u < EPL; ++u) {
      Cx<T>& m = w.M[(size_t)(c - R) * w.ld + wide_elem<GWN>(u)];
      if constexpr (PUT) {
        m = slot[u];
      } else {
        slot[u] = m;
      }
    }
  }
}

// Element u of a finished column S.
template <int S, int GWN, typename T, int EPL, int R>
__device__ __forceinline__ Cx<T> wide_col(const WideCols<T, EPL, R>& w, int u) {
  if constexpr (S < R) {
    return w.x[S][u];
  } else {
    return w.M[(size_t)(S - R) * w.ld + wide_elem<GWN>(u)];
  }
}

// f(std::integral_constant<int, s>{}) for s = B + n - 1 down to B (0 <= n
// <= 16): one jump into a chain of 16 unrolled calls, so that a loop over a
// runtime number of columns keeps every register index a constant.
template <int B, typename F>
__device__ __forceinline__ void chain16(int n, F&& f) {
#define QK_LINK(k)                               \
  case (k) + 1:                                  \
    f(std::integral_constant<int, B + (k)>{});   \
    [[fallthrough]];
  switch (n) {
    QK_LINK(15) QK_LINK(14) QK_LINK(13) QK_LINK(12) QK_LINK(11) QK_LINK(10) QK_LINK(9)
    QK_LINK(8) QK_LINK(7) QK_LINK(6) QK_LINK(5) QK_LINK(4) QK_LINK(3) QK_LINK(2) QK_LINK(1)
    QK_LINK(0)
    default:
      break;
  }
#undef QK_LINK
}

// This lane's warp sum of value lane % N of v[0 .. N - 1] (a reduce-scatter
// butterfly), N the least of 8, 16 and 32 that holds the n values of v.
template <typename T>
__device__ __forceinline__ T wide_scatter(T (&v)[32], int n, int& N) {
  const int lane = threadIdx.x & 31;
  if (n <= 8) {
    N = 8;
    butterfly<4, 32, T>(v, lane);
    return xor_sum<8, T>(v[0]);
  }
  if (n <= 16) {
    N = 16;
    butterfly<8, 32, T>(v, lane);
    return xor_sum<16, T>(v[0]);
  }
  N = 32;
  butterfly<16, 32, T>(v, lane);
  return v[0];
}

// The group-wide half of a round of three sets: s[a] is this lane's warp
// sum of value lane % n[a] of set a; every thread gets the group-wide sums
// in tot[a] (one named barrier, the GWN warp partials added in warp order).
// ``part`` holds two buffers of GWN x 96 values, used in turn.
template <int GWN, typename T>
__device__ __forceinline__ void wide_finish(const T (&s)[3], T (&tot)[3], const int (&n)[3],
                                            T* part, int& buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* pb = part + buf * (GWN * 96);
#pragma unroll
  for (int a = 0; a < 3; ++a) pb[(3 * warp + a) * 32 + lane] = s[a];
  group_bar<GWN>();
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int j = lane & (n[a] - 1);
    T t = 0;
#pragma unroll
    for (int w = 0; w < GWN; ++w) t += pb[(3 * w + a) * 32 + j];
    tot[a] = t;
  }
  buf ^= 1;
  QK_STAMP(ST_ROUND);
}

// The panel's MGS2 on the group's registers and memory. Column t (t >= 1;
// columns s < t - 1 finished, column t - 1 in slot z projected twice and
// waiting for its norm, column t taken into slot y) takes two rounds of
// three sets each: set 0 the coefficients conj(q_s) . x_t of
// the finished columns s < 16, set 1 those of 16 <= s < t - 1 (absent
// below t 18), set 2 conj(x_{t-1}) . x_t and, in the first round,
// |x_{t-1}|^2, which finishes column t - 1 (its coefficient scaled by the
// same factor, as the column). Each round is followed by its projection
// x_t -= sum_s q_s c_s. The last column takes its norm in a round of its
// own. A loop over the finished columns is one jump into a chain of
// unrolled steps (chain16), set 1's first.
template <typename T, int EPL, int R, int GWN>
__device__ __forceinline__ void wide_panel(WideCols<T, EPL, R>& w, int pw, T* part,
                                           Cx<T>* coef, int& buf, const T* n2o, T dep_tol2) {
  // This warp's copy of a round's sums (``coef``: GWN x 48 complex), read
  // by the projections as one broadcast load a coefficient: coefficient s
  // of the finished columns at s, column t - 1's at 32.
  Cx<T>* cw = coef + (threadIdx.x >> 5) * 48;
  auto publish = [&](const T (&tot)[3]) {
    T* slot = reinterpret_cast<T*>(cw);
    const int lane = threadIdx.x & 31;
    __syncwarp();
    slot[lane] = tot[0];
    slot[32 + lane] = tot[1];
    slot[64 + lane] = tot[2];
    __syncwarp();
  };
  // One round over the nc finished columns, slot z and (with_norm) |z|^2.
  auto round = [&](T (&tot)[3], int nc, bool with_norm) {
    T s3[3];
    int n3[3] = {32, 32, 4};
    auto dots = [&](auto S, T (&v)[32]) {
      constexpr int s = decltype(S)::value;
      T re = 0, im = 0;
#pragma unroll
      for (int u = 0; u < EPL; ++u) {
        const Cx<T> q = wide_col<s, GWN>(w, u);
        re += q.re * w.y[u].re + q.im * w.y[u].im;
        im += q.re * w.y[u].im - q.im * w.y[u].re;
      }
      v[(2 * s) % 32] = re;
      v[(2 * s) % 32 + 1] = im;
    };
    const int k1 = nc > 16 ? nc - 16 : 0, k0 = nc < 16 ? nc : 16;
    s3[1] = T(0);
    if (k1 > 0) {
      T v[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) v[j] = T(0);
      chain16<16>(k1, [&](auto S) { dots(S, v); });
      s3[1] = wide_scatter(v, 2 * k1, n3[1]);
    }
    {
      T v[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) v[j] = T(0);
      chain16<0>(k0, [&](auto S) { dots(S, v); });
      s3[0] = wide_scatter(v, 2 * k0, n3[0]);
    }
    T v2[4] = {T(0), T(0), with_norm ? norm2<T, EPL>(w.z) : T(0), T(0)};
#pragma unroll
    for (int u = 0; u < EPL; ++u) {
      v2[0] += w.z[u].re * w.y[u].re + w.z[u].im * w.y[u].im;
      v2[1] += w.z[u].re * w.y[u].im - w.z[u].im * w.y[u].re;
    }
    s3[2] = warp_reduce_scatter<4>(v2);
    wide_finish<GWN>(s3, tot, n3, part, buf);
  };
  // x_t -= sum_{s < nc} q_s c_s + x_{t-1} c_{t-1} (that one times
  // ``last``), in two interleaved chains, the coefficients from this
  // warp's copy of the round's sums.
  auto project = [&](const T (&tot)[3], int nc, T last) {
    publish(tot);
    T pr[2][EPL], pi[2][EPL];
#pragma unroll
    for (int u = 0; u < EPL; ++u) pr[0][u] = pr[1][u] = pi[0][u] = pi[1][u] = T(0);
    auto step = [&](auto S) {
      constexpr int s = decltype(S)::value;
      const Cx<T> c = cw[s];
#pragma unroll
      for (int u = 0; u < EPL; ++u) {
        const Cx<T> q = wide_col<s, GWN>(w, u);
        pr[s & 1][u] += q.re * c.re - q.im * c.im;
        pi[s & 1][u] += q.re * c.im + q.im * c.re;
      }
    };
    chain16<16>(nc > 16 ? nc - 16 : 0, step);
    chain16<0>(nc < 16 ? nc : 16, step);
    const Cx<T> cz = cw[32];
    const T cr = cz.re * last, ci = cz.im * last;
#pragma unroll
    for (int u = 0; u < EPL; ++u) {
      w.y[u].re -= (pr[0][u] + pr[1][u]) + (w.z[u].re * cr - w.z[u].im * ci);
      w.y[u].im -= (pi[0][u] + pi[1][u]) + (w.z[u].re * ci + w.z[u].im * cr);
    }
    QK_STAMP(ST_PROJECT);
  };
  wide_slot<false, GWN>(w, 0, w.z);
  for (int t = 1; t < pw; ++t) {
    wide_slot<false, GWN>(w, t, w.y);
    T tot[3];
    round(tot, t - 1, true);
    const T inv = finish_column<T, EPL>(w.z, __shfl_sync(0xffffffffu, tot[2], 2), n2o[t - 1],
                                        dep_tol2);
    wide_slot<true, GWN>(w, t - 1, w.z);
    project(tot, t - 1, inv);
    round(tot, t - 1, false);
    project(tot, t - 1, T(1));
#pragma unroll
    for (int u = 0; u < EPL; ++u) w.z[u] = w.y[u];
  }
  T s3[3] = {T(0), T(0), T(0)}, tot[3];
  int n3[3] = {32, 32, 4};
  T v2[4] = {norm2<T, EPL>(w.z), T(0), T(0), T(0)};
  s3[2] = warp_reduce_scatter<4>(v2);
  wide_finish<GWN>(s3, tot, n3, part, buf);
  finish_column<T, EPL>(w.z, __shfl_sync(0xffffffffu, tot[2], 0), n2o[pw - 1], dep_tol2);
  wide_slot<true, GWN>(w, pw - 1, w.z);
}

// The same MGS2 with the whole panel in memory P (column s at P + s * ld)
// for vectors of any length len, on the block's GWN warps: each thread owns
// the elements threadIdx.x + k * GWN * 32 of every column and is the only
// thread to read or write them. Column t takes wide_panel's two rounds (two
// sets of 32 values through group_sums: conj(x_s) . x_t for s < t at 2s,
// 2s + 1 and, in the first, |x_{t-1}|^2 at 2t), each a pass over the
// thread's elements; its projections follow its rounds at once
// (mgs_columns_mem's order, on 32 columns).
template <typename T, int GWN>
__device__ __forceinline__ void wide_panel_mem(Cx<T>* P, int ld, int pw, int len, T* part,
                                               int& buf, const T* n2o, T dep_tol2) {
  constexpr int GT_ = GWN * 32;
  const int tid = threadIdx.x;
  // Column c's norm^2 from the round's sum: scale it to unit norm, or to
  // exact zeros when dependent.
  auto finish = [&](int c, T n2) {
    const T keep = (n2 > dep_tol2 * n2o[c]) ? T(1) : T(0);
    const T inv = rsqrt_(n2 + T(TINY)) * keep;
    for (int e = tid; e < len; e += GT_) {
      Cx<T>& x = P[(size_t)c * ld + e];
      x.re *= inv;
      x.im *= inv;
    }
    QK_STAMP(ST_COLUMN);
    return inv;
  };
  for (int t = 1; t < pw; ++t) {
    Cx<T>* xt = P + (size_t)t * ld;
    auto round = [&](T (&tot)[2], bool with_norm) {
      T v[2][32];
#pragma unroll
      for (int j = 0; j < 32; ++j) v[0][j] = v[1][j] = T(0);
      for (int e = tid; e < len; e += GT_) {
        const Cx<T> b = xt[e];
        static_for<0, WIDE>([&](auto S) {
          constexpr int s = decltype(S)::value;
          if (s < t) {
            const Cx<T> q = P[(size_t)s * ld + e];
            v[s / 16][(2 * s) % 32] += q.re * b.re + q.im * b.im;
            v[s / 16][(2 * s) % 32 + 1] += q.re * b.im - q.im * b.re;
          } else if (with_norm && s == t) {
            const Cx<T> x = P[(size_t)(t - 1) * ld + e];
            v[s / 16][(2 * s) % 32] += x.re * x.re + x.im * x.im;
          }
        });
      }
      group_sums<32, 2, GWN>(v, tot, part, buf);
    };
    // x_t -= sum_{s < t} x_s c_s (column t - 1's coefficient times
    // ``last``), in two interleaved chains.
    auto project = [&](const T (&tot)[2], T last) {
      T cr[WIDE - 1], ci[WIDE - 1];
      static_for<0, WIDE - 1>([&](auto S) {
        constexpr int s = decltype(S)::value;
        if (s < t) {
          cr[s] = __shfl_sync(0xffffffffu, tot[s / 16], (2 * s) % 32);
          ci[s] = __shfl_sync(0xffffffffu, tot[s / 16], (2 * s) % 32 + 1);
          if (s == t - 1) {
            cr[s] *= last;
            ci[s] *= last;
          }
        }
      });
      for (int e = tid; e < len; e += GT_) {
        T sr[2] = {T(0), T(0)}, si[2] = {T(0), T(0)};
        static_for<0, WIDE - 1>([&](auto S) {
          constexpr int s = decltype(S)::value;
          if (s < t) {
            const Cx<T> q = P[(size_t)s * ld + e];
            sr[s & 1] += q.re * cr[s] - q.im * ci[s];
            si[s & 1] += q.re * ci[s] + q.im * cr[s];
          }
        });
        xt[e].re -= sr[0] + sr[1];
        xt[e].im -= si[0] + si[1];
      }
      QK_STAMP(ST_PROJECT);
    };
    T tot[2];
    round(tot, true);
    project(tot, finish(t - 1, __shfl_sync(0xffffffffu, t >= 16 ? tot[1] : tot[0], (2 * t) % 32)));
    round(tot, false);
    project(tot, T(1));
  }
  T v[1][1] = {{T(0)}}, tot[1];
  for (int e = tid; e < len; e += GT_) {
    const Cx<T> x = P[(size_t)(pw - 1) * ld + e];
    v[0][0] += x.re * x.re + x.im * x.im;
  }
  group_sums<1, 1, GWN>(v, tot, part, buf);
  finish(pw - 1, tot[0]);
}

// coef[i][t] = sum_e conj(X[i][e]) P[t][e] for i < p0, t < pw: each warp
// takes 4 x 4 tiles of coefficients, its lanes split the vector's elements,
// and one butterfly (warp_reduce_scatter) leaves one of the tile's 32 real
// parts in each lane.
template <typename T>
__device__ __forceinline__ void cgs_coefficients(const Cx<T>* X, const Cx<T>* P, int ld, int p0, int pw,
                                 int len, Cx<T>* coef) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nit = (p0 + 3) / 4, ntt = (pw + 3) / 4;
  for (int tile = warp; tile < nit * ntt; tile += NW) {
    const int i0 = (tile / ntt) * 4, t0 = (tile % ntt) * 4;
    int ir[4], tr[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ir[u] = i0 + u < p0 ? i0 + u : 0;
      tr[u] = t0 + u < pw ? t0 + u : 0;
    }
    T v[32];
#pragma unroll
    for (int a = 0; a < 32; ++a) v[a] = T(0);
    for (int e = lane; e < len; e += 32) {
      Cx<T> q[4], a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        q[u] = X[(size_t)ir[u] * ld + e];
        a[u] = P[(size_t)tr[u] * ld + e];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          v[8 * u + 2 * c] += q[u].re * a[c].re + q[u].im * a[c].im;
          v[8 * u + 2 * c + 1] += q[u].re * a[c].im - q[u].im * a[c].re;
        }
    }
    const T s = warp_reduce_scatter<32>(v);
    const int i = i0 + (lane >> 3), t = t0 + ((lane >> 1) & 3);
    if (i < p0 && t < pw) reinterpret_cast<T*>(coef + (size_t)i * PANEL + t)[lane & 1] = s;
  }
}

// The in-panel group of bcgs2_rows: EPL_AUTO is the rule of K1, K2, K4 and
// K5 (GW warps, one element a thread up to len GT, else two); EPL_MEM the
// whole block on the panel in memory (mgs_panel_mem, any len); EPL >= 1 that
// many elements a thread on GWN warps in registers (len <= EPL * GWN * 32).
constexpr int EPL_AUTO = 0;
constexpr int EPL_MEM = -1;

// Orthonormalize, in place, the ``nvec`` vectors of length ``len`` held as
// the rows of X (row j at X + j * ld), the in-panel steps on the group
// (GWN, EPL) names, one column at a time or, with PAIR, two (mgs_pairs); with
// the default group len is at most 2 * GT. Must be entered by the whole block
// after a barrier that makes X visible; ends with a barrier.
template <typename T, int GWN = GW, int EPL = EPL_AUTO, bool PAIR = false>
__device__ __forceinline__ void bcgs2_rows(Cx<T>* X, int ld, int nvec, int len, const OrthWork<T>& w) {
  static_assert(EPL != EPL_MEM || GWN == NW, "the memory step takes the whole block");
  static_assert(!PAIR || sizeof(T) == sizeof(float), "the pair step is complex64 only");
  const T dep_tol2 = sizeof(T) == sizeof(double) ? T(DEP_TOL2_F64) : T(DEP_TOL2);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int p0 = 0; p0 < nvec; p0 += PANEL) {
    const int pw = min(PANEL, nvec - p0);
    Cx<T>* P = X + (size_t)p0 * ld;
    for (int t = warp; t < pw; t += NW) {
      T s = 0;
      for (int e = lane; e < len; e += 32) {
        const Cx<T> a = P[(size_t)t * ld + e];
        s += a.re * a.re + a.im * a.im;
      }
      s = warp_sum(s);
      if (lane == 0) w.n2o[t] = s;
    }
    __syncthreads();
    QK_STAMP(ST_PANEL);

    // Two CGS passes against the finished rows [0, p0):
    //   coef[i][t] = sum_e conj(X[i][e]) P[t][e];  P[t][e] -= sum_i coef[i][t] X[i][e].
    if (p0 > 0) {
      for (int pass = 0; pass < 2; ++pass) {
        cgs_coefficients<T>(X, P, ld, p0, pw, len, w.coef);
        __syncthreads();
        QK_STAMP(ST_COEF);
        gemm<T, false, false, true, false, 1>(w.coef, 1, PANEL, X, ld, 1, P, ld, 1, pw, len, p0);
        __syncthreads();
        QK_STAMP(ST_CGS);
      }
    }

    // MGS2 inside the panel, column by column, on the group.
    if (tid < GWN * 32) {
      if constexpr (PAIR) {
        if constexpr (EPL == EPL_MEM) {
          mgs_panel_pair_mem<T>(P, ld, pw, len, w.n2o, dep_tol2);
        } else if constexpr (EPL > 0) {
          mgs_panel_pair<T, EPL, GWN>(P, ld, pw, len, w.n2o, dep_tol2);
        } else if (len <= GT) {
          mgs_panel_pair<T, 1>(P, ld, pw, len, w.n2o, dep_tol2);
        } else {
          mgs_panel_pair<T, 2>(P, ld, pw, len, w.n2o, dep_tol2);
        }
      } else if constexpr (EPL == EPL_MEM) {
        mgs_panel_mem<T>(P, ld, pw, len, w.n2o, dep_tol2);
      } else if constexpr (EPL > 0) {
        mgs_panel<T, EPL, GWN>(P, ld, pw, len, w.n2o, dep_tol2);
      } else if (len <= GT) {
        mgs_panel<T, 1>(P, ld, pw, len, w.n2o, dep_tol2);
      } else {
        mgs_panel<T, 2>(P, ld, pw, len, w.n2o, dep_tol2);
      }
    }
    __syncthreads();
  }
  QK_STAMP(ST_ORTH);
}

// ------------------------------------ products with global operands

// gemm_staged: the GEMM of gemm (no SUB, no INPLACE) for operands that both
// live in global memory, their slabs staged through shared memory. A pass
// is the block's NW warp tiles stacked over the rows: PJ = NW * (32 / lc) *
// 4 rows by PC = lc * TC columns (lc = gemm_lanes(ncol)); for each pass the
// reduction runs over slabs of RS steps, X's rows [RS][PJ + 1] and Y's
// columns [RS][PC + 1], copied by cp.async (neighbouring threads on the
// source's contiguous index) into one of two buffers while the block
// computes on the other. The tiles read the slabs from shared memory as
// gemm reads shared operands (broadcast rows, conflict-free columns), so the
// FMAs wait on shared memory, not on L2 or HBM. Every thread must enter;
// ``slab`` holds staged_slab_bytes(ncol); ends with a barrier.
constexpr int RS = 16;

__host__ __device__ inline int staged_rows(int ncol) { return NW * (32 / gemm_lanes(ncol)) * 4; }

template <typename T>
__host__ __device__ inline size_t staged_slab_bytes(int ncol) {
  return (size_t)2 * RS * (staged_rows(ncol) + 1 + gemm_lanes(ncol) * TC + 1) * sizeof(Cx<T>);
}

template <typename T>
__device__ __forceinline__ void cp_async(Cx<T>* dst, const Cx<T>* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(Cx<T>) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// dst[r * ld + i] = src[i * s_i + r * s_r] for i < ni, r < nr (cp.async).
template <typename T>
__device__ __forceinline__ void stage_slab(const Cx<T>* src, int s_i, int s_r, int ni, int nr,
                                           Cx<T>* dst, int ld) {
  const int n = ni * nr;
  if (s_r == 1) {
    for (int idx = threadIdx.x; idx < n; idx += NT) {
      const int i = idx / nr, r = idx - i * nr;
      cp_async<T>(dst + (size_t)r * ld + i, src + (size_t)i * s_i + r);
    }
  } else {
    for (int idx = threadIdx.x; idx < n; idx += NT) {
      const int r = idx / ni, i = idx - r * ni;
      cp_async<T>(dst + (size_t)r * ld + i, src + (size_t)i * s_i + (size_t)r * s_r);
    }
  }
}

template <typename T, bool CONJX, bool CONJY>
__device__ __forceinline__ void gemm_staged(const Cx<T>* X, int xj, int xr, const Cx<T>* Y,
                                            int yr, int yc, Cx<T>* O, int oj, int oc, int nj,
                                            int ncol, int nr, Cx<T>* slab) {
  const int lc = gemm_lanes(ncol);
  const int pj = staged_rows(ncol), pc = lc * TC;
  const int ldx = pj + 1, ldy = pc + 1;
  const int npc = (ncol + pc - 1) / pc, npass = ((nj + pj - 1) / pj) * npc;
  const int nslab = (nr + RS - 1) / RS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int jl = warp * (32 / lc) * 4 + (lane / lc) * 4;  // this thread's rows in the pass
  const int cl = lane % lc;                                // and its first column
  const size_t nbuf = (size_t)RS * (ldx + ldy);  // complex elements of one buffer
  const T sx = CONJX ? T(-1) : T(1);
  const T sy = CONJY ? T(-1) : T(1);
  for (int pass = 0; pass < npass; ++pass) {
    const int j0 = (pass / npc) * pj, c0 = (pass % npc) * pc;
    const int pjn = min(pj, nj - j0), pcn = min(pc, ncol - c0);
    auto stage = [&](int s) {
      const int r0 = s * RS, rn = min(RS, nr - r0);
      Cx<T>* xb = slab + (s & 1) * nbuf;
      stage_slab<T>(X + (size_t)j0 * xj + (size_t)r0 * xr, xj, xr, pjn, rn, xb, ldx);
      stage_slab<T>(Y + (size_t)r0 * yr + (size_t)c0 * yc, yc, yr, pcn, rn, xb + (size_t)RS * ldx,
                    ldy);
      cp_async_commit();
    };
    T ar[4][TC], ai[4][TC];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < TC; ++v) ar[u][v] = ai[u][v] = T(0);
    stage(0);
    for (int s = 0; s < nslab; ++s) {
      if (s + 1 < nslab) {
        stage(s + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // slab s is in shared memory for every thread
      const Cx<T>* xb = slab + (s & 1) * nbuf;
      const Cx<T>* yb = xb + (size_t)RS * ldx;
      const int rn = min(RS, nr - s * RS);
      // Rows and columns past the pass's edge read stale slots and are never
      // stored.
      if (jl < pjn) {
#pragma unroll 2
        for (int r = 0; r < rn; ++r) {
          Cx<T> x[4], y[TC];
#pragma unroll
          for (int u = 0; u < 4; ++u) x[u] = xb[(size_t)r * ldx + jl + u];
#pragma unroll
          for (int v = 0; v < TC; ++v) y[v] = yb[(size_t)r * ldy + cl + v * lc];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const T xre = x[u].re, xim = sx * x[u].im;
#pragma unroll
            for (int v = 0; v < TC; ++v) {
              const T yre = y[v].re, yim = sy * y[v].im;
              ar[u][v] += xre * yre - xim * yim;
              ai[u][v] += xre * yim + xim * yre;
            }
          }
        }
      }
      __syncthreads();  // slab s is read: its buffer may take slab s + 2
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (jl + u >= pjn) continue;
#pragma unroll
      for (int v = 0; v < TC; ++v) {
        const int c = cl + v * lc;
        if (c >= pcn) continue;
        O[(size_t)(j0 + jl + u) * oj + (size_t)(c0 + c) * oc] = Cx<T>{ar[u][v], ai[u][v]};
      }
    }
  }
}

// ---------------------------------------------------------------- K1 layout

// Where K1's buffers live (each kernel instantiation has its placement as
// template arguments, so that the compiler knows which loads are from
// shared memory). theta_smem: theta [m][k + 1] in shared memory,
// else read from global memory. rows_smem: the working rows in shared
// memory, else in a per-element global scratch buffer of split_scratch_cx
// complex elements, and then (theta in global memory too) the products are
// gemm_staged, whose slabs share the space of the orthonormalizer's work
// (the two are never live at once). inplace (needs rows_smem and one-pass
// products): W and V share one buffer of nc rows.
struct SplitPlan {
  int theta_smem, rows_smem, inplace;
};

__host__ __device__ inline bool split_inplace_ok(int m, int k, int nc) {
  return gemm_tiles(nc, k) <= NW && gemm_tiles(nc, m) <= NW;
}

__host__ __device__ inline size_t split_scratch_cx(int m, int k, int nc) {
  return (size_t)nc * ((size_t)k + 1) + (size_t)nc * ((size_t)m + 1);
}

template <typename T>
__host__ __device__ size_t split_smem_bytes(int m, int k, int nc, SplitPlan p) {
  size_t cx = 0;
  if (p.theta_smem) cx += (size_t)m * ((size_t)k + 1);
  if (p.rows_smem) {
    cx += p.inplace ? (size_t)nc * ((size_t)(m > k ? m : k) + 1) : split_scratch_cx(m, k, nc);
    return cx * sizeof(Cx<T>) + orth_work_bytes<T>(nc);
  }
  size_t shared = orth_work_bytes<T>(nc);
  if (staged_slab_bytes<T>(m) > shared) shared = staged_slab_bytes<T>(m);
  if (staged_slab_bytes<T>(k) > shared) shared = staged_slab_bytes<T>(k);
  return cx * sizeof(Cx<T>) + shared;
}

// ------------------------------------------------- the chain (K1, K4, K5)

// The chain's working rows: W [nc][ldw] and V [nc][ldv] (one buffer when
// INPLACE).
template <typename T>
struct Rows {
  Cx<T>* W;
  Cx<T>* V;
  int ldw, ldv;
};

// Lay the rows out at ``p`` (advanced past them) when ROWS_SMEM, else in the
// element's global scratch ``rows_scratch`` (split_scratch_cx elements).
template <typename T, bool ROWS_SMEM, bool INPLACE>
__device__ __forceinline__ Rows<T> rows_carve(Cx<T>*& p, Cx<T>* rows_scratch, int m, int k,
                                              int nc) {
  Rows<T> x;
  if constexpr (INPLACE) {
    x.W = x.V = p;
    x.ldw = x.ldv = (m > k ? m : k) + 1;
    p += (size_t)nc * x.ldw;
  } else {
    Cx<T>* rows;
    if constexpr (ROWS_SMEM) {
      rows = p;
      p += split_scratch_cx(m, k, nc);
    } else {
      rows = rows_scratch;
    }
    x.W = rows;
    x.V = rows + (size_t)nc * (k + 1);
    x.ldw = k + 1;
    x.ldv = m + 1;
  }
  return x;
}

// The power iterations of the subspace split on theta [m, k] (row mm at
// th + mm * ldt, in shared or global memory) from the shared start block v0
// [m, nc], in rows layout:
//   W = v^T conj(theta)  -> orth(W)   (v = v0 on the first iteration)
//   V = W theta^T        -> orth(V)
// Entered by the whole block after a barrier that makes theta visible;
// returns, after a barrier, with the basis as the rows of x.V.
template <typename T, bool INPLACE, bool STAGED = false, bool PAIR = false>
__device__ __forceinline__ void split_chain(const Cx<T>* th, int ldt, const Cx<T>* v0,
                                            const Rows<T>& x, const OrthWork<T>& ow, int m,
                                            int k, int nc, int iters, Cx<T>* slab = nullptr) {
  for (int it = 0; it < iters; ++it) {
    // W[j][kk] = sum_mm v[mm, j] conj(theta[mm, kk]), v = v0 or V^T.
    if constexpr (STAGED) {
      if (it == 0) {
        gemm_staged<T, false, true>(v0, 1, nc, th, ldt, 1, x.W, x.ldw, 1, nc, k, m, slab);
      } else {
        gemm_staged<T, false, true>(x.V, x.ldv, 1, th, ldt, 1, x.W, x.ldw, 1, nc, k, m, slab);
      }
    } else if (it == 0) {
      gemm<T, false, true, false, false>(v0, 1, nc, th, ldt, 1, x.W, x.ldw, 1, nc, k, m);
    } else {
      gemm<T, false, true, false, INPLACE>(x.V, x.ldv, 1, th, ldt, 1, x.W, x.ldw, 1, nc, k, m);
    }
    __syncthreads();
    QK_STAMP(ST_PRODUCT);
    bcgs2_rows<T, GW, EPL_AUTO, PAIR>(x.W, x.ldw, nc, k, ow);
    // V[j][mm] = sum_kk W[j][kk] theta[mm, kk]
    if constexpr (STAGED) {
      gemm_staged<T, false, false>(x.W, x.ldw, 1, th, 1, ldt, x.V, x.ldv, 1, nc, m, k, slab);
    } else {
      gemm<T, false, false, false, INPLACE>(x.W, x.ldw, 1, th, 1, ldt, x.V, x.ldv, 1, nc, m, k);
    }
    __syncthreads();
    QK_STAMP(ST_PRODUCT);
    bcgs2_rows<T, GW, EPL_AUTO, PAIR>(x.V, x.ldv, nc, m, ow);
  }
}

// The split's outputs for one element: qb [m, nc] = V^T and rb [nc, k] =
// conj(V) theta (= q^H theta).
template <typename T, bool STAGED = false>
__device__ __forceinline__ void split_outputs(const Cx<T>* th, int ldt, const Rows<T>& x,
                                              Cx<T>* qb, Cx<T>* rb, int m, int k, int nc,
                                              Cx<T>* slab = nullptr) {
  for (int idx = threadIdx.x; idx < m * nc; idx += NT) {
    const int j = idx % nc, mm = idx / nc;
    qb[idx] = x.V[(size_t)j * x.ldv + mm];
  }
  // r[j][kk] = sum_mm conj(V[j][mm]) theta[mm, kk]
  if constexpr (STAGED) {
    gemm_staged<T, true, false>(x.V, x.ldv, 1, th, ldt, 1, rb, k, 1, nc, k, m, slab);
  } else {
    gemm<T, true, false, false, false>(x.V, x.ldv, 1, th, ldt, 1, rb, k, 1, nc, k, m);
  }
}

// ||theta - q r||^2 of one element (K4, K5): theta [m, k] at th (row
// stride ldt), q [m, nc] read from the rows (q[i][c] = V[c][i]) and r [nc,
// k] at rb (row stride k), which the block has just written. The weight
// that the split's nc directions miss, for the kept fraction's discarded
// weight (ops/svd._kept_fraction): formed from small terms, so that f32
// reads it to its own rounding. gemm's tiles (TJ 4 by TC) with each output
// compared with theta and squared in registers, never stored; summed in a
// fixed order (each warp's lanes by a butterfly, then the warps in order)
// in red [NW]. Starts and ends with a barrier.
template <typename T>
__device__ __forceinline__ T residual_norm2(const Cx<T>* th, int ldt, const Rows<T>& x,
                                            const Cx<T>* rb, int m, int k, int nc, T* red) {
  constexpr int TJ = 4;
  __syncthreads();  // rb written, red free
  const int lc = gemm_lanes(k);
  const int jw = (32 / lc) * TJ, cw = lc * TC;
  const int njt = (m + jw - 1) / jw, nct = (k + cw - 1) / cw;
  const int ntiles = njt * nct;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T part = 0;
  for (int t0 = 0; t0 < ntiles; t0 += NW) {
    const int tile = t0 + warp;
    if (tile >= ntiles) break;
    const int j0 = (tile / nct) * jw + (lane / lc) * TJ;
    const int c0 = (tile % nct) * cw + (lane % lc);
    T ar[TJ][TC], ai[TJ][TC];
#pragma unroll
    for (int u = 0; u < TJ; ++u)
#pragma unroll
      for (int v = 0; v < TC; ++v) ar[u][v] = ai[u][v] = T(0);
    int jr[TJ], cr[TC];
#pragma unroll
    for (int u = 0; u < TJ; ++u) jr[u] = (j0 + u < m) ? j0 + u : 0;
#pragma unroll
    for (int v = 0; v < TC; ++v) cr[v] = (c0 + v * lc < k) ? c0 + v * lc : 0;
#pragma unroll 2
    for (int c = 0; c < nc; ++c) {
      Cx<T> a[TJ], b[TC];
#pragma unroll
      for (int u = 0; u < TJ; ++u) a[u] = x.V[(size_t)c * x.ldv + jr[u]];
#pragma unroll
      for (int v = 0; v < TC; ++v) b[v] = rb[(size_t)c * k + cr[v]];
#pragma unroll
      for (int u = 0; u < TJ; ++u)
#pragma unroll
        for (int v = 0; v < TC; ++v) {
          ar[u][v] += a[u].re * b[v].re - a[u].im * b[v].im;
          ai[u][v] += a[u].re * b[v].im + a[u].im * b[v].re;
        }
    }
#pragma unroll
    for (int u = 0; u < TJ; ++u) {
      if (j0 + u >= m) continue;
#pragma unroll
      for (int v = 0; v < TC; ++v) {
        const int c = c0 + v * lc;
        if (c >= k) continue;
        const Cx<T> t = th[(size_t)(j0 + u) * ldt + c];
        const T dr = t.re - ar[u][v], di = t.im - ai[u][v];
        part += dr * dr + di * di;
      }
    }
  }
  part = warp_sum(part);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  T total = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) total += red[w];
  __syncthreads();  // every thread has read red
  return total;
}

// ------------------------------------------------ the theta build (K4, K5)

// The pair's theta from the site tensors A [2 chi, chi] (rows (u, al),
// u-major) and B [chi, 2 chi] (columns (v, be), v-major) and the gate g
// [4, 4] (g[2s+t][2u+v]):
//   theta[(s al), (t be)] = sum_uv g[2s+t][2u+v] (A B)[(u al), (v be)].
// theta_build computes the product X Y of X [2 chi, chi] (row (u i) at
// X + (u chi + i) * xi, column c at + c * xc) and Y [chi, 2 chi] (row c at
// Y + c * yc, column (v j) at + (v chi + j) * yj), each thread holding a tile
// of 2 i by 2 j outputs in all four (u, v) quadrants (16 complex
// accumulators in registers), lanes on neighbouring j; combines the
// quadrants with the gate in registers and hands every entry to
// store(row, col, value), row (s i) and col (t j), which returns the entry's
// weight in the total. X and Y are staged through shared memory in slabs of
// KS reduction steps, [KS][2 chi + 1] each, copied by stage_slab
// (``stage``: build_stage_bytes). With TRANS the product is the transpose:
// X = B^T, Y = A^T, the gate read as g[2t+s][2v+u], so row (s i) of the
// output is (t be) and col (t j) is (s al). Returns the block's total of the
// weights, summed in a fixed order (each warp's lanes by a butterfly, then
// the warps in order): two launches give bit-equal totals. Entered and left
// with a barrier; the stage is free on return.
constexpr int KS = 16;

template <typename T>
__host__ __device__ inline size_t build_stage_bytes(int chi) {
  return (size_t)2 * KS * (2 * (size_t)chi + 1) * sizeof(Cx<T>) + NW * sizeof(T);
}

// Lanes of a warp along j: the fewest (4 to 32) whose 2 columns each cover chi.
__host__ __device__ inline int build_lanes(int chi) {
  int lc = 4;
  while (lc < 32 && lc * 2 < chi) lc *= 2;
  return lc;
}

template <typename T, bool TRANS, typename Store>
__device__ __forceinline__ T theta_build(const Cx<T>* X, int xi, int xc, const Cx<T>* Y, int yc,
                                         int yj, const Cx<T>* __restrict__ g, int chi,
                                         Cx<T>* stage, Store store) {
  const int m = 2 * chi, ld = m + 1;
  Cx<T>* xs = stage;
  Cx<T>* ys = stage + (size_t)KS * ld;
  T* red = reinterpret_cast<T*>(ys + (size_t)KS * ld);
  const int lc = build_lanes(chi);
  const int iw = (32 / lc) * 2, jw = lc * 2;
  const int nit = (chi + iw - 1) / iw, njt = (chi + jw - 1) / jw;
  const int ntiles = nit * njt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T part = 0;
  for (int t0 = 0; t0 < ntiles; t0 += NW) {
    const int tile = t0 + warp;
    const bool live = tile < ntiles;
    const int i0 = (live ? tile / njt : 0) * iw + (lane / lc) * 2;
    const int j0 = (live ? tile % njt : 0) * jw + (lane % lc);
    // Rows and columns past the edge read index 0 and are never stored.
    int ir[2], jr[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      ir[a] = i0 + a < chi ? i0 + a : 0;
      jr[a] = j0 + a * lc < chi ? j0 + a * lc : 0;
    }
    // acc[2u+v][2a+b]: quadrant (u, v), output (i0 + a, j0 + b lc)
    T ar[4][4], ai[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int o = 0; o < 4; ++o) ar[q][o] = ai[q][o] = T(0);
    for (int c0 = 0; c0 < chi; c0 += KS) {
      const int kw = min(KS, chi - c0);
      __syncthreads();  // the previous slab is read
      stage_slab<T>(X + (size_t)c0 * xc, xi, xc, m, kw, xs, ld);
      stage_slab<T>(Y + (size_t)c0 * yc, yj, yc, m, kw, ys, ld);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (live) {
#pragma unroll 2
        for (int c = 0; c < kw; ++c) {
          Cx<T> x[4], y[4];  // x[2u+a], y[2v+b]
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int a = 0; a < 2; ++a) {
              x[2 * u + a] = xs[(size_t)c * ld + u * chi + ir[a]];
              y[2 * u + a] = ys[(size_t)c * ld + u * chi + jr[a]];
            }
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int v = 0; v < 2; ++v)
#pragma unroll
              for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int b = 0; b < 2; ++b) {
                  const Cx<T> xv = x[2 * u + a], yv = y[2 * v + b];
                  ar[2 * u + v][2 * a + b] += xv.re * yv.re - xv.im * yv.im;
                  ai[2 * u + v][2 * a + b] += xv.re * yv.im + xv.im * yv.re;
                }
        }
      }
    }
    if (live) {
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int i = i0 + a, j = j0 + b * lc;
          if (i >= chi || j >= chi) continue;
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              T xr = 0, xi_ = 0;
#pragma unroll
              for (int u = 0; u < 2; ++u)
#pragma unroll
                for (int v = 0; v < 2; ++v) {
                  const Cx<T> gc = TRANS ? g[4 * (2 * t + s) + 2 * v + u]
                                         : g[4 * (2 * s + t) + 2 * u + v];
                  const T qr = ar[2 * u + v][2 * a + b], qi = ai[2 * u + v][2 * a + b];
                  xr += gc.re * qr - gc.im * qi;
                  xi_ += gc.re * qi + gc.im * qr;
                }
              part += store(s * chi + i, t * chi + j, Cx<T>{xr, xi_});
            }
        }
    }
  }
  part = warp_sum(part);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  T total = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) total += red[w];
  __syncthreads();  // every thread has read red: the stage is free
  QK_STAMP(ST_BUILD);
  return total;
}

// ------------------------------------------------------ K4 and K5 layouts

// K4 and K5 carry K1's placements (SplitPlan) on m = k = 2 chi, theta being
// the kernel's own: built in place into [m][m + 1] shared memory
// (theta_smem), else into the element's global scratch ([m][m]); the
// theta build's stage overlays the rows and the orthonormalizer's work
// (free until the chain starts) and extends the request where it is the
// larger. K5 also keeps its unweighted theta (the na0 product's operand) in
// global scratch, [m][m] ahead of the rest.
template <typename T>
__host__ __device__ size_t gate_split_smem_bytes(int chi, int nc, SplitPlan p) {
  const int m = 2 * chi;
  const size_t theta = p.theta_smem ? (size_t)m * (m + 1) * sizeof(Cx<T>) : 0;
  const size_t rest = split_smem_bytes<T>(m, m, nc, SplitPlan{0, p.rows_smem, p.inplace});
  const size_t stage = build_stage_bytes<T>(chi);
  return theta + (rest > stage ? rest : stage);
}

__host__ __device__ inline size_t gate_split_scratch_cx(int chi, int nc, SplitPlan p) {
  const int m = 2 * chi;
  return (p.theta_smem ? 0 : (size_t)m * m) + (p.rows_smem ? 0 : split_scratch_cx(m, m, nc));
}

__host__ __device__ inline size_t brick_split_scratch_cx(int chi, int nc, SplitPlan p) {
  return (size_t)4 * chi * chi + gate_split_scratch_cx(chi, nc, p);
}

// ---------------------------------------------------------------- K2 layout

// rows_smem: Q [k][m + 1] in shared memory, else in per-element global
// scratch of k * (m + 1) complex elements. v_smem: a copy of v [m][k] in
// shared memory for r = Q^H v, else v is read from global memory.
struct OrthRPlan {
  int rows_smem, v_smem;
};

template <typename T>
__host__ __device__ size_t orth_r_smem_bytes(int m, int k, OrthRPlan p) {
  size_t cx = 0;
  if (p.rows_smem) cx += (size_t)k * ((size_t)m + 1);
  if (p.v_smem) cx += (size_t)m * k;
  return cx * sizeof(Cx<T>) + orth_work_bytes<T>(k);
}

}  // namespace blk
}  // namespace qk
