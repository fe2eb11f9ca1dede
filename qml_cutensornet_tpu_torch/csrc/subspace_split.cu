// Kernel K1: fused batched subspace factorization (the truncating two-site
// split of the MPS engine).
//
// Replaces: qml_cutensornet_tpu/ops/pallas_split.py:_make_split_kernel /
// _split_chain (built by _build_call, entry points subspace_factor_batched /
// subspace_factor; reached from ops/svd._split_subspace on every truncating
// two-site update when fused_split is on).
//
// For each batch element b, with theta[b] an [m, k] complex matrix and the
// shared start block v0 [m, nc], runs ``iters`` double-multiply power
// iterations with an orthonormalization after every multiply, in rows
// layout (vector j of length L at W + j * ldw):
//   W = v^T conj(theta)      -> orth(W)   (v = v0 on the first iteration)
//   V = W theta^T            -> orth(V)
// then writes q[b] [m, nc] = V^T (the port's column layout) and
// r[b] [nc, k] = conj(V) theta (= q^H theta). Both orthonormalizations are
// the BCGS2 routine of bcgs2.cuh (same constants and zero invariants as
// pallas_qr.orth_rows_body). The chain itself is split_chain.cuh, shared
// with the gate + theta-build kernel (gate_split.cu).
//
// What bounds it on Hopper: latency of the serial BCGS2 column chains
// (2 * iters orthonormalizations of nc dependent column steps each); the
// 2 * iters + 1 theta products are about 8 MFLOP each per batch element at
// chi 64 and run as register-blocked CUDA-core FMAs. The simple design runs
// one 256-thread block per batch element. theta stays in global memory
// (128 KB per element at chi 64; the batch's thetas sit in the 50 MB L2),
// and the working rows W and V live in dynamic shared memory when they fit
// (at chi 64, f32:
// 2 x 64 x 129 complex64 = 132 KB plus 25 KB of panel scratch) or in a
// global scratch buffer otherwise (chi 128, or f64). Complex FMAs on CUDA
// cores only (no TF32, no tensor cores): full f32 accumulation.
//
// C interface (ctypes): every entry point returns a cudaError_t as int.
#include <cuda_runtime.h>

#include <cstddef>

#include "split_chain.cuh"

namespace qk {

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
split_kernel(const Cx<T>* __restrict__ theta, const Cx<T>* __restrict__ v0,
             Cx<T>* __restrict__ q, Cx<T>* __restrict__ r, Cx<T>* scratch,
             int m, int k, int nc, int iters, int rows_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const ChainWork<T> w = chain_carve<T>(reinterpret_cast<Cx<T>*>(smem_raw),
                                        scratch + (size_t)b * chain_rows_cx(m, k, nc), m, k, nc,
                                        rows_in_smem != 0);
  split_chain<T>(theta + (size_t)b * m * k, v0, q + (size_t)b * m * nc,
                 r + (size_t)b * nc * k, w, m, k, nc, iters);
}

template <typename T>
int split_launch(const void* theta, const void* v0, void* q, void* r, void* scratch, int B,
                 int m, int k, int nc, int iters, int rows_in_smem, long long smem_bytes,
                 cudaStream_t stream) {
  auto kern = split_kernel<T>;
  // A request over the card's limit fails here AND at the launch; both
  // errors surface through the single cudaGetLastError() below, which also
  // clears them so no stale error reaches the next launch.
  if (smem_bytes > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  kern<<<B, NTHREADS, (size_t)smem_bytes, stream>>>(
      static_cast<const Cx<T>*>(theta), static_cast<const Cx<T>*>(v0), static_cast<Cx<T>*>(q),
      static_cast<Cx<T>*>(r), static_cast<Cx<T>*>(scratch), m, k, nc, iters, rows_in_smem);
  return (int)cudaGetLastError();
}

}  // namespace qk

extern "C" {

long long qk_split_smem(int m, int k, int nc, int dbl, int rows_in_smem) {
  return dbl ? (long long)qk::chain_smem_bytes<double>(m, k, nc, rows_in_smem != 0)
             : (long long)qk::chain_smem_bytes<float>(m, k, nc, rows_in_smem != 0);
}

int qk_split_launch(const void* theta, const void* v0, void* q, void* r, void* scratch, int B,
                    int m, int k, int nc, int iters, int dbl, int rows_in_smem,
                    long long smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dbl ? qk::split_launch<double>(theta, v0, q, r, scratch, B, m, k, nc, iters,
                                        rows_in_smem, smem_bytes, s)
             : qk::split_launch<float>(theta, v0, q, r, scratch, B, m, k, nc, iters,
                                       rows_in_smem, smem_bytes, s);
}

}  // extern "C"
