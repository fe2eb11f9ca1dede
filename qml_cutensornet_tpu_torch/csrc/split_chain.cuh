// The subspace-split chain on one theta, shared by the fused subspace-split
// kernel (subspace_split.cu, theta given), the fused gate + theta-build
// split kernel (gate_split.cu, theta built in the kernel) and the fused brick
// pair update (brick_split.cu, which runs the iteration alone on the
// conjugate transpose of its weighted theta and has its own epilogue).
//
// Replaces: qml_cutensornet_tpu/ops/pallas_split.py:_split_chain. For one
// theta [m, k] (row-major, leading dimension k, in global or shared memory)
// and the shared start block v0 [m, nc], runs ``iters`` double-multiply
// power iterations with an orthonormalization after every multiply, in rows
// layout (vector j of length L at W + j * ldw):
//   W = v^T conj(theta)      -> orth(W)   (v = v0 on the first iteration)
//   V = W theta^T            -> orth(V)
// then writes q [m, nc] = V^T (the port's column layout) and
// r [nc, k] = conj(V) theta (= q^H theta). Both orthonormalizations are the
// BCGS2 routine of bcgs2.cuh.
//
// The working rows W [nc][k+1] and V [nc][m+1] live in dynamic shared memory
// when they fit and in a per-element global scratch buffer otherwise; the
// panel, the coefficients and the reduction slots are always shared memory.
#pragma once

#include <cstddef>

#include "bcgs2.cuh"

namespace qk {

// Complex elements of W and V together (also the per-element scratch size
// when they do not live in shared memory).
__host__ __device__ inline size_t chain_rows_cx(int m, int k, int nc) {
  return (size_t)nc * ((size_t)k + 1) + (size_t)nc * ((size_t)m + 1);
}

// Dynamic shared memory of the chain's work buffers, in bytes.
template <typename T>
__host__ __device__ size_t chain_smem_bytes(int m, int k, int nc, bool rows_in_smem) {
  const size_t ldp = (size_t)(m > k ? m : k) + 1;
  size_t cx = (size_t)PANEL * ldp + (size_t)nc * PANEL;
  if (rows_in_smem) cx += chain_rows_cx(m, k, nc);
  return cx * sizeof(Cx<T>) + (size_t)(NWARPS + PANEL) * sizeof(T);
}

template <typename T>
struct ChainWork {
  Cx<T>* W;
  Cx<T>* V;
  Cx<T>* panel;
  Cx<T>* coef;
  T* red;
  int ldw, ldv, ldp;
};

// Lay the chain's buffers out from ``smem`` (and W, V from ``rows`` when
// they are not in shared memory).
template <typename T>
__device__ ChainWork<T> chain_carve(Cx<T>* smem, Cx<T>* rows, int m, int k, int nc,
                                    bool rows_in_smem) {
  ChainWork<T> w;
  w.ldw = k + 1;
  w.ldv = m + 1;
  w.ldp = (m > k ? m : k) + 1;
  Cx<T>* p = smem;
  if (rows_in_smem) {
    w.W = p;
    p += (size_t)nc * w.ldw;
    w.V = p;
    p += (size_t)nc * w.ldv;
  } else {
    w.W = rows;
    w.V = rows + (size_t)nc * w.ldw;
  }
  w.panel = p;
  p += (size_t)PANEL * w.ldp;
  w.coef = p;
  p += (size_t)nc * PANEL;
  w.red = reinterpret_cast<T*>(p);
  return w;
}

// V[j * ldv + mm] = sum_kk theta[mm, kk] W[j * ldw + kk]. Each thread holds
// MB rows mm for one j (neighbouring threads: neighbouring j, conflict-free
// on the padded W rows; theta reads broadcast). No barrier.
template <typename T>
__device__ void theta_times_w(const Cx<T>* th, int m, int k, const Cx<T>* W, int ldw,
                              Cx<T>* V, int ldv, int nc) {
  constexpr int MB = 4;
  const int ngrp = (m + MB - 1) / MB;
  for (int idx = threadIdx.x; idx < ngrp * nc; idx += NTHREADS) {
    const int j = idx % nc, m0 = (idx / nc) * MB;
    T ar[MB], ai[MB];
#pragma unroll
    for (int u = 0; u < MB; ++u) ar[u] = ai[u] = 0;
    const Cx<T>* wj = W + (size_t)j * ldw;
    for (int kk = 0; kk < k; ++kk) {
      const Cx<T> w = wj[kk];
#pragma unroll
      for (int u = 0; u < MB; ++u) {
        if (m0 + u < m) {
          const Cx<T> t = th[(size_t)(m0 + u) * k + kk];
          ar[u] += t.re * w.re - t.im * w.im;
          ai[u] += t.re * w.im + t.im * w.re;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < MB; ++u)
      if (m0 + u < m) V[(size_t)j * ldv + m0 + u] = Cx<T>{ar[u], ai[u]};
  }
}

// The power iterations. ``th`` must be visible to the whole block on entry
// (the caller puts a barrier after writing it). Leaves the final basis as
// the rows of w.V (V[j * ldv + mm], mm < m), visible to the whole block.
template <typename T>
__device__ void chain_iterate(const Cx<T>* th, const Cx<T>* v0, const ChainWork<T>& w, int m,
                              int k, int nc, int iters) {
  Cx<T>* W = w.W;
  Cx<T>* V = w.V;
  const int ldw = w.ldw, ldv = w.ldv;
  for (int it = 0; it < iters; ++it) {
    if (it == 0) {
      // W[j][kk] = sum_mm v0[mm, j] conj(theta[mm, kk])
      gemm_xty<T, false, true>(v0, 1, nc, th, k, W, ldw, nc, k, m);
    } else {
      // W[j][kk] = sum_mm V[j][mm] conj(theta[mm, kk])
      gemm_xty<T, false, true>(V, ldv, 1, th, k, W, ldw, nc, k, m);
    }
    __syncthreads();
    bcgs2<T>(Src<T>{W, ldw, 1}, W, ldw, nc, k, w.panel, w.ldp, w.coef, w.red);
    theta_times_w<T>(th, m, k, W, ldw, V, ldv, nc);
    __syncthreads();
    bcgs2<T>(Src<T>{V, ldv, 1}, V, ldv, nc, m, w.panel, w.ldp, w.coef, w.red);
  }
}

// The chain: the iterations, then this element's outputs in global memory,
// ``qb`` [m, nc] and ``rb`` [nc, k].
template <typename T>
__device__ void split_chain(const Cx<T>* th, const Cx<T>* v0, Cx<T>* qb, Cx<T>* rb,
                            const ChainWork<T>& w, int m, int k, int nc, int iters) {
  chain_iterate<T>(th, v0, w, m, k, nc, iters);
  const Cx<T>* V = w.V;
  const int ldv = w.ldv;
  for (int idx = threadIdx.x; idx < m * nc; idx += NTHREADS) {
    const int j = idx % nc, mm = idx / nc;
    qb[idx] = V[(size_t)j * ldv + mm];
  }
  // r[j][kk] = sum_mm conj(V[j][mm]) theta[mm, kk]
  gemm_xty<T, true, false>(V, ldv, 1, th, k, rb, k, nc, k, m);
}

}  // namespace qk
