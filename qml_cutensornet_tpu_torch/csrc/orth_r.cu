// Kernel K2: fused batched complex Q+R orthonormalization.
//
// Replaces: qml_cutensornet_tpu/ops/pallas_qr.py:_make_orth_r_kernel (built
// by _build_call_r, entry points orthonormalize_r_batched / qr_with_r_pallas;
// reached from ops/mps.move_center on every canonical-center move).
//
// For each batch element b, with v[b] an [m, k] complex matrix (row-major,
// the port's column layout), computes
//   q[b] [m, k]  an orthonormal basis of the columns of v[b] by BCGS2
//                (bcgs2.cuh: panels of 16, CGS2 + in-panel MGS2, dependent
//                columns exact zeros);
//   r[b] [k, k]  r = q^H v  (not triangular; q r == v to roundoff).
//
// What bounds it on Hopper: latency of the serial column chain, not FLOPs
// or bytes (k dependent steps with block barriers; ~1 MB of traffic per
// element). The simple design runs one 256-thread block per batch element,
// keeps the finished vectors Q in dynamic shared memory when they fit (at
// chi 64: 64 x 129 complex64 = 66 KB) and in a global scratch buffer
// otherwise (chi 128 in f64), and computes r from Q while it is still
// resident. Complex f32 FMAs on CUDA cores only (no TF32).
//
// C interface (ctypes): every entry point returns a cudaError_t as int.
#include <cuda_runtime.h>

#include <cstddef>

#include "bcgs2.cuh"

namespace qk {

template <typename T>
__host__ __device__ size_t orth_r_smem_bytes(int m, int k, bool rows_in_smem) {
  const size_t ld = (size_t)m + 1;
  size_t cx = (size_t)PANEL * ld + (size_t)k * PANEL;
  if (rows_in_smem) cx += (size_t)k * ld;
  return cx * sizeof(Cx<T>) + (size_t)(NWARPS + PANEL) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
orth_r_kernel(const Cx<T>* __restrict__ v, Cx<T>* __restrict__ q, Cx<T>* __restrict__ r,
              Cx<T>* scratch, int m, int k, int rows_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int ld = m + 1;
  const Cx<T>* vb = v + (size_t)b * m * k;

  Cx<T>* p = reinterpret_cast<Cx<T>*>(smem_raw);
  Cx<T>* Q;
  if (rows_in_smem) {
    Q = p;
    p += (size_t)k * ld;
  } else {
    Q = scratch + (size_t)b * k * ld;
  }
  Cx<T>* panel = p;
  p += (size_t)PANEL * ld;
  Cx<T>* coef = p;
  p += (size_t)k * PANEL;
  T* red = reinterpret_cast<T*>(p);

  // Column j of v[b] is vector j: element e at vb[e * k + j].
  bcgs2<T>(Src<T>{vb, 1, k}, Q, ld, k, m, panel, ld, coef, red);

  Cx<T>* qb = q + (size_t)b * m * k;
  for (int idx = threadIdx.x; idx < m * k; idx += NTHREADS) {
    const int j = idx % k, e = idx / k;
    qb[idx] = Q[(size_t)j * ld + e];
  }
  // r[i, j] = sum_e conj(Q[i][e]) v[e, j]
  gemm_xty<T, true, false>(Q, ld, 1, vb, k, r + (size_t)b * k * k, k, k, k, m);
}

template <typename T>
int orth_r_launch(const void* v, void* q, void* r, void* scratch, int B, int m, int k,
                  int rows_in_smem, long long smem_bytes, cudaStream_t stream) {
  auto kern = orth_r_kernel<T>;
  // A request over the card's limit fails here AND at the launch; both
  // errors surface through the single cudaGetLastError() below, which also
  // clears them so no stale error reaches the next launch.
  if (smem_bytes > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  kern<<<B, NTHREADS, (size_t)smem_bytes, stream>>>(
      static_cast<const Cx<T>*>(v), static_cast<Cx<T>*>(q), static_cast<Cx<T>*>(r),
      static_cast<Cx<T>*>(scratch), m, k, rows_in_smem);
  return (int)cudaGetLastError();
}

}  // namespace qk

extern "C" {

// Dynamic shared memory the kernel needs for [m, k] inputs (dbl: complex128).
long long qk_orth_r_smem(int m, int k, int dbl, int rows_in_smem) {
  return dbl ? (long long)qk::orth_r_smem_bytes<double>(m, k, rows_in_smem != 0)
             : (long long)qk::orth_r_smem_bytes<float>(m, k, rows_in_smem != 0);
}

int qk_orth_r_launch(const void* v, void* q, void* r, void* scratch, int B, int m, int k,
                     int dbl, int rows_in_smem, long long smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dbl ? qk::orth_r_launch<double>(v, q, r, scratch, B, m, k, rows_in_smem, smem_bytes, s)
             : qk::orth_r_launch<float>(v, q, r, scratch, B, m, k, rows_in_smem, smem_bytes, s);
}

// Largest dynamic shared memory a block may opt in to, or -(cudaError_t).
long long qk_smem_optin(int device) {
  int bytes = 0;
  cudaError_t e = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? (long long)bytes : -(long long)e;
}

const char* qk_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
