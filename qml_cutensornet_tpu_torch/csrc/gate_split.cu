// Kernel K4: fused two-site gate application, theta build and subspace
// split, in one launch per two-site update.
//
// Replaces: qml_cutensornet_tpu/ops/pallas_split.py:_make_gate_split_kernel
// with its helper _gate_combine (built by _build_gate_call, entry points
// gate_split_factor_batched / gate_subspace_factor; reached from
// ops/svd.truncated_svd_gate on every two-site update when fused_gate is
// on).
//
// For each batch element b, with
//   A[b] [2 chi, chi]   the left site tensor, rows (u, alpha) u-major,
//   B[b] [chi, 2 chi]   the right site tensor, columns (v, beta) v-major,
//   g[b] [4, 4]         the two-site gate, g[2s+t, 2u+v],
// the kernel computes in its own body
//   theta0 = A B                                          (complex product)
//   theta[(s alpha), (t beta)] = sum_uv g[2s+t, 2u+v] theta0[(u alpha), (v beta)]
//   tot[b] = ||theta||_F^2
// and then runs the subspace-split chain of split_chain.cuh on theta (the
// same chain as kernel K1), writing q[b] [2 chi, nc] and r[b] [nc, 2 chi].
// The gate is read as [4, 4] and tot is one scalar per element: the TPU
// kernel's replicated-lane gate rows and its sublane-partial tot are
// layout workarounds of that compiler and are not carried over.
//
// Each thread owns one (alpha, beta) pair at a time: it accumulates the four
// quadrant entries theta0[(u alpha), (v beta)] in registers over the shared
// bond, applies the 16 gate coefficients, writes the four theta entries and
// adds their squared magnitudes to its partial of tot. theta0 is never
// stored. A and B are read from global memory (L2), not staged.
//
// Where theta lives: in dynamic shared memory when it fits beside the
// chain's working rows (in f32 up to chi 32: 32 KB of theta at chi 32), in a
// per-element global scratch buffer otherwise (from chi 64 in f32, where the
// rows alone take 157 KB of the 227 KB a block may use, and theta is
// another 128 KB; the batch's thetas then sit in the 50 MB L2). The rows
// themselves move to the scratch buffer at chi 128, or from chi 64 in f64,
// as in kernel K1. The scratch theta is written and read only by its own
// block.
//
// What bounds it on Hopper: as K1, the latency of the serial BCGS2 column
// chains; the theta build adds one product of 4 chi^3 complex FMAs (the size
// of one of the chain's theta products). What the fusion saves is not
// arithmetic but the two einsum launches, the layout copies and the
// ||theta||^2 reduction of the unfused update, and their traffic.
// Complex FMAs on CUDA cores only (no TF32, no tensor cores).
//
// C interface (ctypes): every entry point returns a cudaError_t as int.
#include <cuda_runtime.h>

#include <cstddef>

#include "split_chain.cuh"

namespace qk {

constexpr int GATE_CX = 16;  // the gate's 4 x 4 coefficients, staged in shared memory

template <typename T>
__host__ __device__ size_t gate_split_smem_bytes(int chi, int nc, bool rows_in_smem,
                                                 bool theta_in_smem) {
  const int m = 2 * chi;
  size_t bytes = chain_smem_bytes<T>(m, m, nc, rows_in_smem) + GATE_CX * sizeof(Cx<T>);
  if (theta_in_smem) bytes += (size_t)m * m * sizeof(Cx<T>);
  return bytes;
}

// Per-element global scratch, in complex elements.
__host__ __device__ inline size_t gate_split_scratch_cx(int chi, int nc, bool rows_in_smem,
                                                        bool theta_in_smem) {
  const int m = 2 * chi;
  return (theta_in_smem ? 0 : (size_t)m * m) + (rows_in_smem ? 0 : chain_rows_cx(m, m, nc));
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
gate_split_kernel(const Cx<T>* __restrict__ A, const Cx<T>* __restrict__ Bm,
                  const Cx<T>* __restrict__ g, const Cx<T>* __restrict__ v0,
                  Cx<T>* __restrict__ q, Cx<T>* __restrict__ r, T* __restrict__ tot,
                  Cx<T>* scratch, int chi, int nc, int iters, int rows_in_smem,
                  int theta_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int m = 2 * chi;

  Cx<T>* sp = reinterpret_cast<Cx<T>*>(smem_raw);
  Cx<T>* gp = scratch + (size_t)b * gate_split_scratch_cx(chi, nc, rows_in_smem != 0,
                                                           theta_in_smem != 0);
  Cx<T>* gs = sp;
  sp += GATE_CX;
  Cx<T>* th;
  if (theta_in_smem) {
    th = sp;
    sp += (size_t)m * m;
  } else {
    th = gp;
    gp += (size_t)m * m;
  }
  const ChainWork<T> w = chain_carve<T>(sp, gp, m, m, nc, rows_in_smem != 0);

  if (tid < GATE_CX) gs[tid] = g[(size_t)b * GATE_CX + tid];
  __syncthreads();

  const Cx<T>* Ab = A + (size_t)b * m * chi;
  const Cx<T>* Bb = Bm + (size_t)b * chi * m;
  T part = 0;
  for (int idx = tid; idx < chi * chi; idx += NTHREADS) {
    const int be = idx % chi, al = idx / chi;
    // t0[2u+v] = theta0[(u al), (v be)]
    T t0r[4] = {0, 0, 0, 0}, t0i[4] = {0, 0, 0, 0};
    const Cx<T>* a0 = Ab + (size_t)al * chi;
    const Cx<T>* a1 = Ab + (size_t)(chi + al) * chi;
    for (int c = 0; c < chi; ++c) {
      const Cx<T> au[2] = {a0[c], a1[c]};
      const Cx<T> bv[2] = {Bb[(size_t)c * m + be], Bb[(size_t)c * m + chi + be]};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          t0r[2 * u + v] += au[u].re * bv[v].re - au[u].im * bv[v].im;
          t0i[2 * u + v] += au[u].re * bv[v].im + au[u].im * bv[v].re;
        }
      }
    }
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      T xr = 0, xi = 0;
#pragma unroll
      for (int uv = 0; uv < 4; ++uv) {
        const Cx<T> c = gs[4 * st + uv];
        xr += c.re * t0r[uv] - c.im * t0i[uv];
        xi += c.re * t0i[uv] + c.im * t0r[uv];
      }
      const int s = st >> 1, t = st & 1;
      th[(size_t)(s * chi + al) * m + t * chi + be] = Cx<T>{xr, xi};
      part += xr * xr + xi * xi;
    }
  }
  const T total = block_sum(part, w.red);
  if (tid == 0) tot[b] = total;
  __syncthreads();  // theta complete before the chain reads it

  split_chain<T>(th, v0, q + (size_t)b * m * nc, r + (size_t)b * nc * m, w, m, m, nc, iters);
}

template <typename T>
int gate_split_launch(const void* A, const void* Bm, const void* g, const void* v0, void* q,
                      void* r, void* tot, void* scratch, int B, int chi, int nc, int iters,
                      int rows_in_smem, int theta_in_smem, long long smem_bytes,
                      cudaStream_t stream) {
  auto kern = gate_split_kernel<T>;
  // A request over the card's limit fails here AND at the launch; both
  // errors surface through the single cudaGetLastError() below, which also
  // clears them so no stale error reaches the next launch.
  if (smem_bytes > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  kern<<<B, NTHREADS, (size_t)smem_bytes, stream>>>(
      static_cast<const Cx<T>*>(A), static_cast<const Cx<T>*>(Bm), static_cast<const Cx<T>*>(g),
      static_cast<const Cx<T>*>(v0), static_cast<Cx<T>*>(q), static_cast<Cx<T>*>(r),
      static_cast<T*>(tot), static_cast<Cx<T>*>(scratch), chi, nc, iters, rows_in_smem,
      theta_in_smem);
  return (int)cudaGetLastError();
}

}  // namespace qk

extern "C" {

// Dynamic shared memory the kernel needs (dbl: complex128).
long long qk_gate_split_smem(int chi, int nc, int dbl, int rows_in_smem, int theta_in_smem) {
  const bool rs = rows_in_smem != 0, ts = theta_in_smem != 0;
  return dbl ? (long long)qk::gate_split_smem_bytes<double>(chi, nc, rs, ts)
             : (long long)qk::gate_split_smem_bytes<float>(chi, nc, rs, ts);
}

// Complex elements of global scratch the kernel needs per batch element.
long long qk_gate_split_scratch(int chi, int nc, int rows_in_smem, int theta_in_smem) {
  return (long long)qk::gate_split_scratch_cx(chi, nc, rows_in_smem != 0, theta_in_smem != 0);
}

int qk_gate_split_launch(const void* A, const void* Bm, const void* g, const void* v0, void* q,
                         void* r, void* tot, void* scratch, int B, int chi, int nc, int iters,
                         int dbl, int rows_in_smem, int theta_in_smem, long long smem_bytes,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dbl ? qk::gate_split_launch<double>(A, Bm, g, v0, q, r, tot, scratch, B, chi, nc, iters,
                                             rows_in_smem, theta_in_smem, smem_bytes, s)
             : qk::gate_split_launch<float>(A, Bm, g, v0, q, r, tot, scratch, B, chi, nc, iters,
                                            rows_in_smem, theta_in_smem, smem_bytes, s);
}

}  // extern "C"
