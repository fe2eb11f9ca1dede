// Block-wide BCGS2 orthonormalization of complex vectors, shared by the fused
// Q+R kernel (orth_r.cu) and the fused subspace-split kernel
// (subspace_split.cu).
//
// Replaces: qml_cutensornet_tpu/ops/pallas_qr.py:orth_rows_body (the
// scalar, pair=False variant). Same algorithm, same constants:
//   - vectors are processed in panels of PANEL = 16;
//   - each panel is projected twice (classical Gram-Schmidt, CGS2) against
//     every finished vector, then runs MGS2 column by column within the
//     panel (each column projected twice against the panel's finished
//     prefix);
//   - a column whose residual norm^2 is not above DEP_TOL2 = 1e-10 times
//     its norm^2 before projection is numerically dependent and is written
//     as exact zeros; otherwise it is scaled by rsqrt(n2 + TINY), TINY=1e-30.
//     The double instantiation cuts at DEP_TOL2_F64 = 1e-24 instead: the
//     reference's f64 path is Householder QR with no cutoff, and 1e-10 would
//     drop directions above f64's singular-value-ratio floor of 1e-10;
//   - so exact-zero input vectors, and exact-zero entries shared by every
//     input vector, stay exactly zero (the MPS padding invariant).
//
// What bounds it on Hopper: the serial chain of column steps. At chi 64 the
// orthonormalization of 64 vectors of length 128 is 64 dependent steps, each
// with block-wide reductions and barriers; the arithmetic (about 4 MFLOP) is
// small. The simple design keeps everything one thread block per batch
// element (no cross-block traffic), the panel and the finished vectors in
// shared memory where they fit, CGS passes as one-thread-per-coefficient
// loops over conflict-free padded rows, and within-panel passes as
// warp-per-coefficient shuffle reductions. Arithmetic is full-precision
// complex FMAs on CUDA cores: no TF32 and no tensor cores, so the full-f32
// accumulation rule of the reference (precision=HIGHEST) holds.
#pragma once

#include <cuda_runtime.h>

namespace qk {

constexpr int PANEL = 16;
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
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

// Sum of one value per thread over the block; every thread gets the total
// (summed in the same order by all threads). ``red`` holds NWARPS values.
template <typename T>
__device__ T block_sum(T v, T* red) {
  v = warp_sum(v);
  __syncthreads();  // red may still be read by a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = 0;
#pragma unroll
  for (int i = 0; i < NWARPS; ++i) s += red[i];
  return s;
}

// Vector j, element e of a strided set of vectors: p[j * js + e * es].
template <typename T>
struct Src {
  const Cx<T>* p;
  int js, es;
};

// Orthonormalize ``nvec`` complex vectors of length ``len`` read from
// ``src`` into the rows of ``Q`` (row j at Q + j * ldq, contiguous). ``src``
// may alias ``Q`` with js == ldq, es == 1: each panel is read before any of
// its rows are written. Scratch: ``panel`` holds PANEL rows of stride ``ldp``
// (>= len), ``coef`` holds nvec * PANEL values, ``red`` NWARPS + PANEL values.
// Ends with a barrier, so Q may be read by the whole block afterwards.
template <typename T>
__device__ void bcgs2(Src<T> src, Cx<T>* Q, int ldq, int nvec, int len,
                      Cx<T>* panel, int ldp, Cx<T>* coef, T* red) {
  T* n2o = red + NWARPS;  // per-column norm^2 before projection
  const T dep_tol2 = sizeof(T) == sizeof(double) ? T(DEP_TOL2_F64) : T(DEP_TOL2);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int p0 = 0; p0 < nvec; p0 += PANEL) {
    const int pw = min(PANEL, nvec - p0);

    // Load the panel (column index fastest: coalesced for column-layout
    // inputs, conflict-free for padded rows).
    for (int idx = tid; idx < pw * len; idx += NTHREADS) {
      const int t = idx % pw, e = idx / pw;
      panel[t * ldp + e] = src.p[(size_t)(p0 + t) * src.js + (size_t)e * src.es];
    }
    __syncthreads();

    for (int t = warp; t < pw; t += NWARPS) {
      T s = 0;
      for (int e = lane; e < len; e += 32) {
        const Cx<T> a = panel[t * ldp + e];
        s += a.re * a.re + a.im * a.im;
      }
      s = warp_sum(s);
      if (lane == 0) n2o[t] = s;
    }

    // Two CGS passes against the finished rows [0, p0).
    if (p0 > 0) {
      for (int pass = 0; pass < 2; ++pass) {
        for (int idx = tid; idx < p0 * pw; idx += NTHREADS) {
          const int t = idx % pw, i = idx / pw;
          const Cx<T>* qi = Q + (size_t)i * ldq;
          const Cx<T>* at = panel + t * ldp;
          T cr = 0, ci = 0;
          for (int e = 0; e < len; ++e) {
            const Cx<T> q = qi[e], a = at[e];
            cr += q.re * a.re + q.im * a.im;  // conj(q) * a
            ci += q.re * a.im - q.im * a.re;
          }
          coef[i * PANEL + t] = Cx<T>{cr, ci};
        }
        __syncthreads();
        for (int idx = tid; idx < pw * len; idx += NTHREADS) {
          const int t = idx / len, e = idx - t * len;
          T sr = 0, si = 0;
          for (int i = 0; i < p0; ++i) {
            const Cx<T> q = Q[(size_t)i * ldq + e], c = coef[i * PANEL + t];
            sr += q.re * c.re - q.im * c.im;
            si += q.re * c.im + q.im * c.re;
          }
          panel[t * ldp + e].re -= sr;
          panel[t * ldp + e].im -= si;
        }
        __syncthreads();
      }
    }

    // MGS2 within the panel, one column at a time.
    Cx<T>* qp = Q + (size_t)p0 * ldq;
    for (int t = 0; t < pw; ++t) {
      Cx<T>* x = panel + t * ldp;
      if (t > 0) {
        for (int pass = 0; pass < 2; ++pass) {
          for (int s = warp; s < t; s += NWARPS) {
            const Cx<T>* qs = qp + (size_t)s * ldq;
            T cr = 0, ci = 0;
            for (int e = lane; e < len; e += 32) {
              const Cx<T> q = qs[e], a = x[e];
              cr += q.re * a.re + q.im * a.im;
              ci += q.re * a.im - q.im * a.re;
            }
            cr = warp_sum(cr);
            ci = warp_sum(ci);
            if (lane == 0) coef[s] = Cx<T>{cr, ci};
          }
          __syncthreads();
          for (int e = tid; e < len; e += NTHREADS) {
            T sr = 0, si = 0;
            for (int s = 0; s < t; ++s) {
              const Cx<T> q = qp[(size_t)s * ldq + e], c = coef[s];
              sr += q.re * c.re - q.im * c.im;
              si += q.re * c.im + q.im * c.re;
            }
            x[e].re -= sr;
            x[e].im -= si;
          }
          __syncthreads();
        }
      }
      T s = 0;
      for (int e = tid; e < len; e += NTHREADS) s += x[e].re * x[e].re + x[e].im * x[e].im;
      const T n2 = block_sum(s, red);
      const T keep = (n2 > dep_tol2 * n2o[t]) ? T(1) : T(0);
      const T inv = rsqrt_(n2 + T(TINY)) * keep;
      for (int e = tid; e < len; e += NTHREADS)
        qp[(size_t)t * ldq + e] = Cx<T>{x[e].re * inv, x[e].im * inv};
      __syncthreads();
    }
  }
}

// out[j * ldo + c] = sum_r opX(X[j * xj + r * xr]) * opY(Y[r * ldy + c])
// for j < nj, c < ncol, r < nr; opX / opY conjugate when CONJX / CONJY.
// Each thread accumulates JB rows j for one column c, so every Y element it
// loads feeds JB FMAs; neighbouring threads take neighbouring c (coalesced
// Y reads, broadcast X reads). No barrier.
template <typename T, bool CONJX, bool CONJY>
__device__ void gemm_xty(const Cx<T>* X, int xj, int xr, const Cx<T>* Y, int ldy,
                         Cx<T>* out, int ldo, int nj, int ncol, int nr) {
  constexpr int JB = 4;
  const int ngrp = (nj + JB - 1) / JB;
  const T sx = CONJX ? T(-1) : T(1);
  const T sy = CONJY ? T(-1) : T(1);
  for (int idx = threadIdx.x; idx < ngrp * ncol; idx += NTHREADS) {
    const int c = idx % ncol, j0 = (idx / ncol) * JB;
    T ar[JB], ai[JB];
#pragma unroll
    for (int u = 0; u < JB; ++u) ar[u] = ai[u] = 0;
    for (int r = 0; r < nr; ++r) {
      const Cx<T> y = Y[(size_t)r * ldy + c];
      const T yr = y.re, yi = sy * y.im;
#pragma unroll
      for (int u = 0; u < JB; ++u) {
        if (j0 + u < nj) {
          const Cx<T> x = X[(size_t)(j0 + u) * xj + (size_t)r * xr];
          const T xre = x.re, xim = sx * x.im;
          ar[u] += xre * yr - xim * yi;
          ai[u] += xre * yi + xim * yr;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < JB; ++u)
      if (j0 + u < nj) out[(size_t)(j0 + u) * ldo + c] = Cx<T>{ar[u], ai[u]};
  }
}

}  // namespace qk
