// Kernel K7: batched complex64 product on the bf16 tensor cores, f32
// accumulation, in one or three passes.
//
// Replaces no Pallas kernel: it computes what the reference leaves to XLA
// dots under a reduced jax.default_matmul_precision, on the TPU's MXU:
//   - the subspace power products theta^H v and theta w under
//     SimConfig.power_precision (qml_cutensornet_tpu/ops/svd.py:236, :240);
//   - the Gram-tile transfer-matrix products, the site pre-combination and
//     the state norms under SimConfig.tile_precision
//     (qml_cutensornet_tpu/models/simulate.py:862, :900-931).
// The classes are the TPU's (ops/lowp.py): HIGH is three bf16 passes, each
// f32 split into a bf16 high part and a bf16 low part and the products
// hi*hi + hi*lo + lo*hi accumulated in f32 (about 16 bits kept); DEFAULT is
// one pass, hi*hi. No library call computes these on complex operands, and
// TF32 (10 bits) is another class, so the product is written by hand.
//
// For each batch element b (grid z, looping past 65535):
//   C[b] [M, N] = op(A[b]) . B[b],  op = identity (A[b] is [M, K]) or the
//   conjugate transpose (A[b] is [K, M]);  B[b] is [K, N].
// Every matrix is row-major (interleaved re, im, torch.complex64) with unit
// column stride; A and B have a row stride and a batch stride of their own
// in complex elements (a batch stride 0 broadcasts one matrix over the
// batch), so the views of the callers (a carry's transpose, a site of a
// state batch) need no copy; C is dense.
//
// Method: a 64 x 64 tile of C a block of 4 warps (2 x 2, a 32 x 32 warp
// tile of 2 x 4 m16n8 fragments, real and imaginary accumulators apart), K
// in chunks of 32. Each chunk is split on its way from global to shared
// memory: op(A) as rows [m][k] and B transposed to [n][k], one bf16 plane
// each for re hi, im hi and, with three passes, re lo and im lo (lo =
// bf16(x - hi), exact in f32; the conjugate's sign is applied before the
// split, which commutes with round-to-nearest-even). A shared row holds 32 +
// 8 bf16 (80 bytes), so every fragment is one 32-bit load and the 8 rows x 4
// words of a warp's load hit 32 distinct banks. The products are
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, the 4M form:
//   re += Ar Br + (-Ai) Bi,   im += Ar Bi + Ai Br
// (-Ai: the sign bits of the im planes flipped in registers, exact), each
// real product as hi*hi, plus hi*lo and lo*hi with three passes. Ragged
// edges of M, N and K load exact zeros; C's ragged edge is not written.
//
// What bounds it on Hopper: at the headline tile (tile 32, chi 64, tile
// block 2) the two products of a site block, [32,2048,64] . [32,64,256] and
// [32,256,64]^H . [32,256,2048], do 8.6 GFLOP a pass each and move about
// 172 MB, C written once: bytes bound them (0.051 ms at 3.35 TB/s; three
// passes are 0.026 ms of operations at 989 TFLOP/s). This first version
// stages each chunk once, synchronously (no cp.async, TMA or wgmma), and
// splits on the load path; the transposed stores into shared memory are
// 4-way bank conflicted.
//
// C interface (ctypes): the entry point returns a cudaError_t as int.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace qk7 {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDS = BK + 8;  // bf16 a shared row
constexpr int NT = 128;      // 4 warps
constexpr int MAX_GRID_Z = 65535;
// Planes of a staged operand: 0 re hi, 1 im hi, 2 re lo, 3 im lo.
constexpr int RE_HI = 0, IM_HI = 1, RE_LO = 2, IM_LO = 3;

template <int P>
__device__ __forceinline__ void stage(__nv_bfloat16 (*s)[BM][LDS], int row, int col, float re,
                                      float im) {
  const __nv_bfloat16 rh = __float2bfloat16_rn(re), ih = __float2bfloat16_rn(im);
  s[RE_HI][row][col] = rh;
  s[IM_HI][row][col] = ih;
  if constexpr (P == 3) {
    s[RE_LO][row][col] = __float2bfloat16_rn(re - __bfloat162float(rh));
    s[IM_LO][row][col] = __float2bfloat16_rn(im - __bfloat162float(ih));
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int P, bool OP_H>
__global__ void __launch_bounds__(NT)
cgemm_kernel(const float2* __restrict__ A, const float2* __restrict__ B, float2* __restrict__ C,
             int batch, int M, int N, int K, long long sa, long long lda, long long sb,
             long long ldb) {
  constexpr int NP = P == 3 ? 4 : 2;  // planes
  __shared__ __align__(16) __nv_bfloat16 sA[NP][BM][LDS];
  __shared__ __align__(16) __nv_bfloat16 sB[NP][BN][LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  for (int b = blockIdx.z; b < batch; b += gridDim.z) {
    const float2* Ab = A + (size_t)b * (size_t)sa;
    const float2* Bb = B + (size_t)b * (size_t)sb;
    float2* Cb = C + (size_t)b * (size_t)M * N;
    float accR[2][4][4], accI[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) accR[i][j][e] = accI[i][j][e] = 0.f;

    for (int k0 = 0; k0 < K; k0 += BK) {
      // op(A) chunk -> sA[.][m][k]; coalesced along the row of A as stored.
      for (int idx = tid; idx < BM * BK; idx += NT) {
        const int mm = OP_H ? idx % BM : idx / BK;
        const int kk = OP_H ? idx / BM : idx % BK;
        const int gm = m0 + mm, gk = k0 + kk;
        float2 v = make_float2(0.f, 0.f);
        if (gm < M && gk < K)
          v = __ldg(OP_H ? Ab + (size_t)gk * lda + gm : Ab + (size_t)gm * lda + gk);
        stage<P>(sA, mm, kk, v.x, OP_H ? -v.y : v.y);
      }
      // B chunk [k][n] -> sB[.][n][k]; coalesced along n.
      for (int idx = tid; idx < BN * BK; idx += NT) {
        const int nn = idx % BN, kk = idx / BN;
        const int gn = n0 + nn, gk = k0 + kk;
        float2 v = make_float2(0.f, 0.f);
        if (gn < N && gk < K) v = __ldg(Bb + (size_t)gk * ldb + gn);
        stage<P>(sB, nn, kk, v.x, v.y);
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        uint32_t a[2][NP][4], na[2][NP / 2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const __nv_bfloat16* r0 = &sA[p][wm + i * 16 + g][ks + 2 * t];
            const __nv_bfloat16* r1 = &sA[p][wm + i * 16 + g + 8][ks + 2 * t];
            a[i][p][0] = ld32(r0);
            a[i][p][1] = ld32(r1);
            a[i][p][2] = ld32(r0 + 8);
            a[i][p][3] = ld32(r1 + 8);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            na[i][0][e] = a[i][IM_HI][e] ^ 0x80008000u;
            if constexpr (P == 3) na[i][1][e] = a[i][IM_LO][e] ^ 0x80008000u;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bf[NP][2];
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const __nv_bfloat16* c = &sB[p][wn + j * 8 + g][ks + 2 * t];
            bf[p][0] = ld32(c);
            bf[p][1] = ld32(c + 8);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float* re = accR[i][j];
            float* im = accI[i][j];
            if constexpr (P == 3) {  // the low-part products first
              mma(re, a[i][RE_HI], bf[RE_LO]);
              mma(re, a[i][RE_LO], bf[RE_HI]);
              mma(re, na[i][0], bf[IM_LO]);
              mma(re, na[i][1], bf[IM_HI]);
              mma(im, a[i][RE_HI], bf[IM_LO]);
              mma(im, a[i][RE_LO], bf[IM_HI]);
              mma(im, a[i][IM_HI], bf[RE_LO]);
              mma(im, a[i][IM_LO], bf[RE_HI]);
            }
            mma(re, a[i][RE_HI], bf[RE_HI]);
            mma(re, na[i][0], bf[IM_HI]);
            mma(im, a[i][RE_HI], bf[IM_HI]);
            mma(im, a[i][IM_HI], bf[RE_HI]);
          }
        }
      }
      __syncthreads();
    }

    // Fragment element e of (i, j): row g (e < 2) or g + 8, column 2t + (e & 1).
    const bool vec = (N % 2) == 0;  // two neighbouring complex values are 16-byte aligned
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm + i * 16 + g + 8 * h;
          const int col = n0 + wn + j * 8 + 2 * t;
          if (row >= M || col >= N) continue;
          float2* out = Cb + (size_t)row * N + col;
          const float2 v0 = make_float2(accR[i][j][2 * h], accI[i][j][2 * h]);
          const float2 v1 = make_float2(accR[i][j][2 * h + 1], accI[i][j][2 * h + 1]);
          if (vec && col + 1 < N) {
            *reinterpret_cast<float4*>(out) = make_float4(v0.x, v0.y, v1.x, v1.y);
          } else {
            out[0] = v0;
            if (col + 1 < N) out[1] = v1;
          }
        }
  }
}

template <int P, bool OP_H>
int launch_as(const void* a, const void* b, void* c, int batch, int m, int n, int k,
              long long sa, long long lda, long long sb, long long ldb, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch < MAX_GRID_Z ? batch : MAX_GRID_Z);
  cgemm_kernel<P, OP_H><<<grid, NT, 0, stream>>>(static_cast<const float2*>(a),
                                                   static_cast<const float2*>(b),
                                                   static_cast<float2*>(c), batch, m, n, k, sa,
                                                   lda, sb, ldb);
  return (int)cudaGetLastError();
}

}  // namespace qk7

extern "C" {

// c[b] = op(a[b]) . b[b] (op_h: the conjugate transpose, a[b] is [k, m]);
// sa, lda, sb, ldb: the batch and row strides of a and b in complex
// elements; passes 1 or 3.
int qk_cgemm_launch(const void* a, const void* b, void* c, int batch, int m, int n, int k,
                    long long sa, long long lda, long long sb, long long ldb, int op_h,
                    int passes, void* stream) {
  if (batch < 1 || m < 1 || n < 1 || k < 1 || sa < 0 || lda < 0 || sb < 0 || ldb < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (passes == 3)
    return op_h ? qk7::launch_as<3, true>(a, b, c, batch, m, n, k, sa, lda, sb, ldb, s)
                : qk7::launch_as<3, false>(a, b, c, batch, m, n, k, sa, lda, sb, ldb, s);
  if (passes == 1)
    return op_h ? qk7::launch_as<1, true>(a, b, c, batch, m, n, k, sa, lda, sb, ldb, s)
                : qk7::launch_as<1, false>(a, b, c, batch, m, n, k, sa, lda, sb, ldb, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
