// Kernel K5: the fused Hastings pair update of the brick (Vidal) engine, in
// one launch per batch of pairs.
//
// Replaces: qml_cutensornet_tpu/ops/pallas_split.py:_make_brick_split_kernel
// with its helpers _build_theta_quadrants and _gate_combine (built by
// _build_brick_call, entry point brick_gate_split_batched; reached from
// ops/svd.fused_brick_update on every pair update of ops/vidal.update_pairs
// when fused_gate is on and the stage's shape is one the kernel takes).
//
// For each batch element b (one pair of one circuit), with
//   A[b] [2 chi, chi]   the left site tensor, rows (u, alpha) u-major,
//   B[b] [chi, 2 chi]   the right site tensor, columns (v, beta) v-major,
//   g[b] [4, 4]         the two-site gate, g[2s+t, 2u+v],
//   lam[b] [chi]        the Schmidt weights of the pair's left bond (real),
// the kernel computes
//   theta_t[(s alpha), (t beta)] = sum_uv g[2s+t, 2u+v] (A B)[(u alpha), (v beta)]
//   theta_w = diag(lam, lam) theta_t       (row (s alpha) weighted by lam[alpha])
//   tot[b]  = ||theta_w||_F^2
// then runs the power iterations of split_chain.cuh on theta_w^H (rows
// (t beta), columns (s alpha)), whose left basis is the top right singular
// basis of theta_w. With V the final basis as rows [nc, 2 chi] (the chain's
// V; the engine's right factor is conj(V)), the epilogue writes
//   q2[b]  [nc, 2 chi] = V
//   na0[b] [nc, 2 chi] = V theta_t^T       (rows of theta_t V^T: the new left
//                                            tensor, from the UNWEIGHTED theta,
//                                            with no division by lambda)
//   s2[b]  [nc]        = row norms^2 of conj(V) theta_w^H (= ||theta_w v_j||^2)
// The TPU kernel's replicated-lane gate rows and its sublane-partial tot are
// layout workarounds of that compiler and are not carried over.
//
// Each thread of the theta build owns one (alpha, beta) pair at a time, as in
// kernel K4: it accumulates the four quadrant entries of A B over the shared
// bond in registers, applies the 16 gate coefficients and writes both thetas
// TRANSPOSED, thT[(t beta)][(s alpha)] = theta_t and thH = lam conj(theta_t).
// Neighbouring threads take neighbouring beta, so the 4 chi reads of each
// thread are coalesced (B) or broadcast (A); only its 8 writes are strided.
// thH is the chain's input, read on every product of the chain; thT is read
// once, by the epilogue's na0 product.
//
// Where the data lives: thH in dynamic shared memory when it fits beside the
// chain's working rows (f32 up to chi 32), in a per-element global scratch
// buffer otherwise; the rows in shared memory up to chi 64 in f32 (chi 32 in
// f64), in the scratch buffer above; thT always in the scratch buffer. The
// scratch is allocated by the wrapper from torch, and written and read only
// by its own block. At chi 128 it is 1.6 MB per element in f32.
//
// What bounds it on Hopper: as K1 and K4, the latency of the serial BCGS2
// column chains (one 256-thread block per element), not arithmetic or bytes;
// the fusion removes the torch launches and the theta-sized temporaries of
// the unfused pair update. Complex FMAs on CUDA cores only (no TF32, no
// tensor cores).
//
// C interface (ctypes): every entry point returns a cudaError_t as int.
#include <cuda_runtime.h>

#include <cstddef>

#include "split_chain.cuh"

namespace qk {

constexpr int BRICK_GATE_CX = 16;  // the gate's 4 x 4 coefficients, staged in shared memory

template <typename T>
__host__ __device__ size_t brick_split_smem_bytes(int chi, int nc, bool rows_in_smem,
                                                  bool theta_in_smem) {
  const int m = 2 * chi;
  size_t bytes = chain_smem_bytes<T>(m, m, nc, rows_in_smem) + BRICK_GATE_CX * sizeof(Cx<T>);
  if (theta_in_smem) bytes += (size_t)m * m * sizeof(Cx<T>);
  return bytes;
}

// Per-element global scratch, in complex elements: thT, then thH and the rows
// where they are not in shared memory.
__host__ __device__ inline size_t brick_split_scratch_cx(int chi, int nc, bool rows_in_smem,
                                                         bool theta_in_smem) {
  const int m = 2 * chi;
  return (size_t)m * m + (theta_in_smem ? 0 : (size_t)m * m) +
         (rows_in_smem ? 0 : chain_rows_cx(m, m, nc));
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
brick_split_kernel(const Cx<T>* __restrict__ A, const Cx<T>* __restrict__ Bm,
                   const Cx<T>* __restrict__ g, const T* __restrict__ lam,
                   const Cx<T>* __restrict__ v0, Cx<T>* __restrict__ q2,
                   Cx<T>* __restrict__ na0, T* __restrict__ s2, T* __restrict__ tot,
                   Cx<T>* scratch, int chi, int nc, int iters, int rows_in_smem,
                   int theta_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int m = 2 * chi;

  Cx<T>* sp = reinterpret_cast<Cx<T>*>(smem_raw);
  Cx<T>* gp = scratch + (size_t)b * brick_split_scratch_cx(chi, nc, rows_in_smem != 0,
                                                            theta_in_smem != 0);
  Cx<T>* gs = sp;
  sp += BRICK_GATE_CX;
  Cx<T>* thT = gp;
  gp += (size_t)m * m;
  Cx<T>* thH;
  if (theta_in_smem) {
    thH = sp;
    sp += (size_t)m * m;
  } else {
    thH = gp;
    gp += (size_t)m * m;
  }
  const ChainWork<T> w = chain_carve<T>(sp, gp, m, m, nc, rows_in_smem != 0);

  if (tid < BRICK_GATE_CX) gs[tid] = g[(size_t)b * BRICK_GATE_CX + tid];
  __syncthreads();

  const Cx<T>* Ab = A + (size_t)b * m * chi;
  const Cx<T>* Bb = Bm + (size_t)b * chi * m;
  const T* lb = lam + (size_t)b * chi;
  T part = 0;
  for (int idx = tid; idx < chi * chi; idx += NTHREADS) {
    const int be = idx % chi, al = idx / chi;
    // t0[2u+v] = (A B)[(u al), (v be)]
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
    const T l = lb[al];
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
      const size_t o = (size_t)(t * chi + be) * m + s * chi + al;
      thT[o] = Cx<T>{xr, xi};
      thH[o] = Cx<T>{l * xr, -(l * xi)};
      part += l * l * (xr * xr + xi * xi);
    }
  }
  const T total = block_sum(part, w.red);
  if (tid == 0) tot[b] = total;
  __syncthreads();  // both thetas complete before the chain reads them

  chain_iterate<T>(thH, v0, w, m, m, nc, iters);

  const Cx<T>* V = w.V;
  const int ldv = w.ldv;
  Cx<T>* q2b = q2 + (size_t)b * nc * m;
  for (int idx = tid; idx < nc * m; idx += NTHREADS) {
    const int j = idx / m, e = idx - j * m;
    q2b[idx] = V[(size_t)j * ldv + e];
  }
  // W[j][e] = sum_kk conj(V[j][kk]) thH[kk][e]: the rows of q^H theta_w^H,
  // whose squared norms are s2. W is free once the iterations are done.
  gemm_xty<T, true, false>(V, ldv, 1, thH, m, w.W, w.ldw, nc, m, m);
  // na0[j][e] = sum_kk V[j][kk] thT[kk][e] = (theta_t q)[e, j]
  gemm_xty<T, false, false>(V, ldv, 1, thT, m, na0 + (size_t)b * nc * m, m, nc, m, m);
  __syncthreads();
  for (int j = warp; j < nc; j += NWARPS) {
    T acc = 0;
    for (int e = lane; e < m; e += 32) {
      const Cx<T> x = w.W[(size_t)j * w.ldw + e];
      acc += x.re * x.re + x.im * x.im;
    }
    acc = warp_sum(acc);
    if (lane == 0) s2[(size_t)b * nc + j] = acc;
  }
}

template <typename T>
int brick_split_launch(const void* A, const void* Bm, const void* g, const void* lam,
                       const void* v0, void* q2, void* na0, void* s2, void* tot, void* scratch,
                       int B, int chi, int nc, int iters, int rows_in_smem, int theta_in_smem,
                       long long smem_bytes, cudaStream_t stream) {
  auto kern = brick_split_kernel<T>;
  // A request over the card's limit fails here AND at the launch; both
  // errors surface through the single cudaGetLastError() below.
  if (smem_bytes > 48 * 1024)
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  kern<<<B, NTHREADS, (size_t)smem_bytes, stream>>>(
      static_cast<const Cx<T>*>(A), static_cast<const Cx<T>*>(Bm), static_cast<const Cx<T>*>(g),
      static_cast<const T*>(lam), static_cast<const Cx<T>*>(v0), static_cast<Cx<T>*>(q2),
      static_cast<Cx<T>*>(na0), static_cast<T*>(s2), static_cast<T*>(tot),
      static_cast<Cx<T>*>(scratch), chi, nc, iters, rows_in_smem, theta_in_smem);
  return (int)cudaGetLastError();
}

}  // namespace qk

extern "C" {

// Dynamic shared memory the kernel needs (dbl: complex128).
long long qk_brick_split_smem(int chi, int nc, int dbl, int rows_in_smem, int theta_in_smem) {
  const bool rs = rows_in_smem != 0, ts = theta_in_smem != 0;
  return dbl ? (long long)qk::brick_split_smem_bytes<double>(chi, nc, rs, ts)
             : (long long)qk::brick_split_smem_bytes<float>(chi, nc, rs, ts);
}

// Complex elements of global scratch the kernel needs per batch element.
long long qk_brick_split_scratch(int chi, int nc, int rows_in_smem, int theta_in_smem) {
  return (long long)qk::brick_split_scratch_cx(chi, nc, rows_in_smem != 0, theta_in_smem != 0);
}

int qk_brick_split_launch(const void* A, const void* Bm, const void* g, const void* lam,
                          const void* v0, void* q2, void* na0, void* s2, void* tot, void* scratch,
                          int B, int chi, int nc, int iters, int dbl, int rows_in_smem,
                          int theta_in_smem, long long smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dbl ? qk::brick_split_launch<double>(A, Bm, g, lam, v0, q2, na0, s2, tot, scratch, B,
                                              chi, nc, iters, rows_in_smem, theta_in_smem,
                                              smem_bytes, s)
             : qk::brick_split_launch<float>(A, Bm, g, lam, v0, q2, na0, s2, tot, scratch, B,
                                             chi, nc, iters, rows_in_smem, theta_in_smem,
                                             smem_bytes, s);
}

}  // extern "C"
