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
// columns of v[b] by BCGS2 (bcgs2.cuh: panels of 16, CGS2 + in-panel MGS2;
// dependent and zero columns come out as exact zeros). No r factor: the
// callers that need one form q^H v as a batched matrix product outside.
//
// Shapes: k <= 128 and any m. Besides the center-move and split shapes
// ([B, 2 chi, chi] and [B, 2 chi, nc] up to chi 128) it takes the panels of
// the blocked route, k = 32 with m = 2 chi up to 2048 and beyond.
//
// What bounds it on Hopper: the latency of the serial column chain (k
// dependent steps with block-wide barriers), not arithmetic or bytes. The
// simple design runs one 256-thread block per batch element and reads v in
// place as interleaved (re, im) pairs. The finished vectors Q ([k][m + 1])
// and the working panel ([16][m + 1]) live in dynamic shared memory as long
// as they fit the 227 KB a block may use, and move to a per-element global
// scratch buffer in two steps (``place``):
//   2  Q and panel in shared memory:   (k + 16)(m + 1) elements; for a panel
//      of k = 32 in f32 up to m = 593 (chi 296), for k = 64 up to m = 349,
//      for k = 128 up to m = 186;
//   1  panel in shared memory, Q in global scratch: 16 (m + 1) elements; for
//      k = 32 in f32 up to m = 1782 (half of that in f64);
//   0  both in global scratch (L2-resident): for k = 32 in f32 from
//      m = 1783, so the chi 1024 panels (m = 2048, 32 rows of 16 KB) run
//      here.
// The coefficients and reduction slots are always shared memory. Complex
// FMAs on CUDA cores only (no TF32, no tensor cores).
//
// C interface (ctypes): every entry point returns a cudaError_t as int.
#include <cuda_runtime.h>

#include <cstddef>

#include "bcgs2.cuh"

namespace qk {

template <typename T>
__host__ __device__ size_t orth_smem_bytes(int m, int k, int place) {
  const size_t ld = (size_t)m + 1;
  size_t cx = (size_t)k * PANEL;
  if (place >= 1) cx += (size_t)PANEL * ld;
  if (place >= 2) cx += (size_t)k * ld;
  return cx * sizeof(Cx<T>) + (size_t)(NWARPS + PANEL) * sizeof(T);
}

// Per-element global scratch, in complex elements.
__host__ __device__ inline size_t orth_scratch_cx(int m, int k, int place) {
  const size_t ld = (size_t)m + 1;
  return (place < 2 ? (size_t)k * ld : 0) + (place < 1 ? (size_t)PANEL * ld : 0);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
orth_kernel(const Cx<T>* __restrict__ v, Cx<T>* __restrict__ q, Cx<T>* scratch, int m, int k,
            int place) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int ld = m + 1;
  const Cx<T>* vb = v + (size_t)b * m * k;

  Cx<T>* sp = reinterpret_cast<Cx<T>*>(smem_raw);
  Cx<T>* gp = scratch + (size_t)b * orth_scratch_cx(m, k, place);
  Cx<T>* Q;
  if (place >= 2) {
    Q = sp;
    sp += (size_t)k * ld;
  } else {
    Q = gp;
    gp += (size_t)k * ld;
  }
  Cx<T>* panel;
  if (place >= 1) {
    panel = sp;
    sp += (size_t)PANEL * ld;
  } else {
    panel = gp;
  }
  Cx<T>* coef = sp;
  sp += (size_t)k * PANEL;
  T* red = reinterpret_cast<T*>(sp);

  // Column j of v[b] is vector j: element e at vb[e * k + j].
  bcgs2<T>(Src<T>{vb, 1, k}, Q, ld, k, m, panel, ld, coef, red);

  Cx<T>* qb = q + (size_t)b * m * k;
  for (int idx = threadIdx.x; idx < m * k; idx += NTHREADS) {
    const int j = idx % k, e = idx / k;
    qb[idx] = Q[(size_t)j * ld + e];
  }
}

template <typename T>
int orth_launch(const void* v, void* q, void* scratch, int B, int m, int k, int place,
                long long smem_bytes, cudaStream_t stream) {
  auto kern = orth_kernel<T>;
  // A request over the card's limit fails here AND at the launch; both
  // errors surface through the single cudaGetLastError() below, which also
  // clears them so no stale error reaches the next launch.
  if (smem_bytes > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  kern<<<B, NTHREADS, (size_t)smem_bytes, stream>>>(
      static_cast<const Cx<T>*>(v), static_cast<Cx<T>*>(q), static_cast<Cx<T>*>(scratch), m, k,
      place);
  return (int)cudaGetLastError();
}

}  // namespace qk

extern "C" {

// Dynamic shared memory the kernel needs for [m, k] inputs (dbl: complex128).
long long qk_orth_smem(int m, int k, int dbl, int place) {
  return dbl ? (long long)qk::orth_smem_bytes<double>(m, k, place)
             : (long long)qk::orth_smem_bytes<float>(m, k, place);
}

// Complex elements of global scratch the kernel needs per batch element.
long long qk_orth_scratch(int m, int k, int place) {
  return (long long)qk::orth_scratch_cx(m, k, place);
}

int qk_orth_launch(const void* v, void* q, void* scratch, int B, int m, int k, int dbl,
                   int place, long long smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dbl ? qk::orth_launch<double>(v, q, scratch, B, m, k, place, smem_bytes, s)
             : qk::orth_launch<float>(v, q, scratch, B, m, k, place, smem_bytes, s);
}

}  // extern "C"
