// Kernel K7: batched complex64 product on the bf16 tensor cores (and, for
// the thin shapes, on the CUDA cores), f32 accumulation, in one or three
// passes.
//
// Replaces no Pallas kernel: it computes what the reference leaves to XLA
// dots under a reduced jax.default_matmul_precision, on the TPU's MXU:
//   - the subspace power products theta^H v and theta w under
//     SimConfig.power_precision (qml_cutensornet_tpu/ops/svd.py:236, :240);
//   - the Gram-tile transfer-matrix products, the site pre-combination and
//     the state norms under SimConfig.tile_precision
//     (qml_cutensornet_tpu/models/simulate.py:862, :900-931);
//   - every engine dot under SimConfig.matmul_precision (ops/lowp.matmul).
// The classes are the TPU's (ops/lowp.py): HIGH is three bf16 passes, each
// f32 split into a bf16 high part hi = bf16_rn(x) and a bf16 low part lo =
// bf16_rn(x - hi), the products hi*hi + hi*lo + lo*hi accumulated in f32
// (about 16 bits kept); DEFAULT is one pass, hi*hi. No library call computes
// these on complex operands, and TF32 (10 bits) is another class, so the
// product is written by hand. Every product of two bf16 values is exact in
// f32, so every plan below and the plain version (ops/lowp.cgemm_plain)
// differ only in the order of their f32 sums. The complex product is the
// reference's 4M form (ops/cpx.py:87-106): re = Ar Br - Ai Bi, im = Ar Bi +
// Ai Br, four real products each.
//
// For each batch element b:
//   C[b] [M, N] = op_a(A[b]) . op_b(B[b]),
// op_a "n": A[b] is [M, K]; "h": its conjugate transpose, A[b] is [K, M];
// op_b "n": B[b] is [K, N]; "h": B[b] is [N, K]. Every matrix is row-major
// (interleaved re, im, torch.complex64) with unit column stride and a row
// stride of its own. Matrix b of an operand lies at
//   (b / inner) * s_outer + (b % inner) * s_inner
// complex elements from its base: a two-level batch, so that a gate
// broadcast over theta's bond index (s_inner 0), a site of a state batch
// and a carry's transposed view pass with no copy. C is dense.
//
// The C entry point qk_cgemm_launch chooses one of three plans from
// (batch, M, N, K) alone (qk_cgemm_plan), so that a shape always sums in
// the same order and two launches are bit-equal:
//
// 1. THIN (K <= 8, or N <= 2), on the CUDA cores: the gates (M = K = 4 over
//    2048 matrices of [4, 64]), the Hadamard layer (M = K = 2 over 65536
//    matrices of [2, 64]) and the single columns of the scanned panel step
//    (N = 1). These are bytes-bound by far (the Hadamard layer's bound is
//    0.040 ms at 3.35 TB/s); a tensor-core tile would be 97% padding. THIN_K
//    (K <= 8): a thread a (b, 4 rows, 2 columns); for each k it reads its two
//    columns of B (16 bytes where aligned), splits them, and forms the
//    products of its rows with fmaf (exact products, f32 sums), the small A
//    from L1; few registers, so that many loads are in flight. THIN_N (N <=
//    2, K > 8): a block of 32 warps a (b, rows) streams A once; with op_a
//    "h" (A stored [K, M]) a lane a row and the warps over K, reduced in
//    shared memory in warp order; with "n" a warp a row and its lanes over
//    K, reduced by a fixed butterfly.
// 2. SMALL (the rest), the engine's chi-64 products (theta, r b, a r^H,
//    q^H theta, the power products, vdot): a 32 x 32 tile of C a block,
//    which at batch 32 and 128 x 128 makes 512 blocks for 132 SMs. Latency
//    bounds these (a few MB, 0.002 ms at 3.35 TB/s, against a few
//    dependent copy and product rounds a chunk), so a block is up to 4
//    warps that split K: warp w sums chunks w, w + 4, ... on a ring of its
//    own, and the sums are added in shared memory in warp order. The
//    number of warps doubles from 1 while the blocks' warps still fit on
//    the card at once (12 an SM at their registers) and each keeps a chunk:
//    a function of the shape alone.
// 3. LARGE (M, N >= 64, K >= 16, and at least 264 tiles: two blocks on each
//    SM), the Gram tiles and the large power products: 8 warps (4 x 2 or
//    2 x 4) of 32 x 32 warp tiles, a 128 x 64 (LARGE_M, M >= N) or 64 x 128
//    (LARGE_N) block tile, so that the larger operand is read from device
//    memory once and the other re-read from L2 only. The headline tile's
//    two products, [32,2048,64] . [32,64,256] and [32,256,64]^H .
//    [32,256,2048], move 172 MB (0.051 ms at 3.35 TB/s) for 26 GFLOP at
//    three passes (0.026 ms at 989 TFLOP/s; mma.sync reaches a part of
//    that): bytes bound them at one pass and the tensor cores come close
//    at three, so two blocks an SM (128 registers a thread) keep copies in
//    flight while the other computes. The ring holds 3 chunks at three
//    passes and 4 at one, where the two blocks' registers spill least.
//
// SMALL and LARGE share one kernel (cgemm_tc). Each chunk of f32 operand is
// copied into shared memory by cp.async (16 bytes a thread where the
// pointers and strides allow, 8 otherwise; the ragged edge zero-filled by
// the copy's source size) STAGES - 1 chunks ahead of the one being
// multiplied. The copy keeps the operand's own layout: a k-contiguous
// operand (op_a "n", op_b "h") as rows of 16 complex whose 16-byte vectors
// are swizzled by the row's parity (the 8 lanes of a fragment's 16-byte
// load hit 32 distinct banks), a k-strided one (op_a "h", op_b "n") as rows
// of the tile's width + 2 complex (a row stride 16 bytes past a multiple of
// 64: the 16 lanes of an 8-byte load hit 32 distinct banks). Each warp
// splits its own fragments on the way from shared memory to registers: a k
// pair (2 complex) becomes one bf16x2 register of each plane (re hi, im hi,
// and with three passes re lo, im lo), the conjugate's sign applied before
// the split (it commutes with round-to-nearest-even). So no split pass, no
// second launch, no transposed store and no barrier beyond the ring's one a
// chunk. The products are mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.
// f32; -Ai Bi takes B's im planes with their sign bits flipped in registers
// (exact). No wgmma: the shapes are bytes-bound, and the split has to pass
// through registers.
//
// C interface (ctypes): each entry point returns a cudaError_t as int.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace qk7 {

// Plans: their ids are the C interface's (ops/lowp.PLANS).
enum Plan : int { THIN_K = 0, THIN_N = 1, SMALL = 2, LARGE_M = 3, LARGE_N = 4 };
constexpr int THIN_K_MAX = 8;  // THIN_K takes K up to this
constexpr int THIN_N_MAX = 2;  // THIN_N takes N up to this
constexpr int LARGE_MIN_TILES = 2 * 132;

constexpr int BK = 16;      // K chunk, the mma depth (complex elements)
constexpr int PAD_KS = 2;   // pad of a k-strided staged row (complex)
// Planes of a split operand: 0 re hi, 1 im hi, 2 re lo, 3 im lo.
constexpr int RE_HI = 0, IM_HI = 1, RE_LO = 2, IM_LO = 3;
constexpr uint32_t SIGNS = 0x80008000u;  // the sign bits of a bf16x2

struct Operand {
  const float2* p;
  long long s_outer, s_inner, ld;  // complex elements
  int vec;                         // 16-byte copies: p 16-byte aligned, strides even
};

struct Args {
  Operand a, b;
  float2* c;
  long long batch, inner;
  int m, n, k;
};

__device__ __forceinline__ const float2* matrix(const Operand& o, long long bi, long long inner) {
  return o.p + (bi / inner) * o.s_outer + (bi % inner) * o.s_inner;
}

// ------------------------------------------------------------ the split

__device__ __forceinline__ uint32_t pack(float k0, float k1) {  // k0 in the low half
  const __nv_bfloat162 v = __floats2bfloat162_rn(k0, k1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One plane pair of a k pair: hi = bf16(x), lo = bf16(x - hi).
template <int P>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack(x0, x1);
  if constexpr (P == 3)
    lo = pack(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
}

// Register e of every plane of a fragment from the k pair (x0, x1).
template <int P, bool CONJ, int R>
__device__ __forceinline__ void split_frag(float2 x0, float2 x1, uint32_t (&f)[4][R], int e) {
  if constexpr (CONJ) {
    x0.y = -x0.y;
    x1.y = -x1.y;
  }
  split2<P>(x0.x, x1.x, f[RE_HI][e], f[RE_LO][e]);
  split2<P>(x0.y, x1.y, f[IM_HI][e], f[IM_LO][e]);
}

// The split of one f32 value, as floats: exact bf16 values.
template <int P>
__device__ __forceinline__ void split1(float x, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  lo = P == 3 ? __bfloat162float(__float2bfloat16_rn(x - hi)) : 0.f;
}

// ----------------------------------------------------------- the copies

__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp8(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy rows [row0, row0 + ROWS) x columns [col0, col0 + WIDTH) of a stored
// matrix (rows x cols valid, row stride ld) into a staged tile of row
// stride LDS, 16 bytes a copy with vec, else 8; what lies outside is
// zero-filled. SWZ (the k-contiguous layout, 16 complex a row): a row's
// 16-byte vectors are swizzled by the row's parity (v ^ 4 at odd rows), so
// that the 8 lanes of a fragment's 16-byte load hit 32 distinct banks. The
// loop is not unrolled: its addresses are computed, not held in registers.
template <int ROWS, int WIDTH, int LDS, int NT, bool SWZ, int PER>
__device__ __forceinline__ void stage_copies(float2* s, const float2* g, long long ld, int row0,
                                             int rows, int col0, int cols, int tid) {
  constexpr int VPR = WIDTH / PER;  // copies a row
#pragma unroll 1
  for (int idx = tid; idx < ROWS * VPR; idx += NT) {
    const int r = idx / VPR, c = (idx % VPR) * PER;
    const int gr = row0 + r, gc = col0 + c;
    const bool ok = gr < rows && gc < cols;
    const float2* src = ok ? g + gr * ld + gc : g;
    float2* dst = s + r * LDS + (SWZ ? c ^ (8 * (r & 1)) : c);
    if constexpr (PER == 2)
      cp16(dst, src, ok ? (gc + 1 < cols ? 16 : 8) : 0);
    else
      cp8(dst, src, ok ? 8 : 0);
  }
}

template <int ROWS, int WIDTH, int LDS, int NT, bool SWZ>
__device__ __forceinline__ void stage_tile(float2* s, const float2* g, long long ld, int row0,
                                           int rows, int col0, int cols, bool vec, int tid) {
  if (vec)
    stage_copies<ROWS, WIDTH, LDS, NT, SWZ, 2>(s, g, ld, row0, rows, col0, cols, tid);
  else
    stage_copies<ROWS, WIDTH, LDS, NT, SWZ, 1>(s, g, ld, row0, rows, col0, cols, tid);
}

__device__ __forceinline__ void mma(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ------------------------------------------------- SMALL and LARGE plans

// A block takes one BM x BN tile of C (32 x 32 a warp) and ks groups
// (blockDim / GT, run-time) of WGM x WGN warps: each group owns a ring of
// chunks and sums the chunks kc = group, group + ks, ... of the tile; with
// ks > 1 the groups' sums are added in shared memory, in group order,
// after the last chunk.
constexpr int SMALL_GROUPS = 4;        // at most 4 groups (of one warp) a block
constexpr int SMALL_WARPS = 12 * 132;  // SMALL warps resident at once: 12 an SM (registers)

template <bool AH, bool BH, int WGM, int WGN>
struct TcShape {
  static constexpr int GT = 32 * WGM * WGN;  // threads a group
  static constexpr int BM = 32 * WGM, BN = 32 * WGN;
  // op_a "n" stages A as [BM][BK] (swizzled); "h" as [BK][BM + PAD_KS]
  static constexpr int LDA = AH ? BM + PAD_KS : BK;
  static constexpr int A_ELEMS = AH ? BK * LDA : BM * LDA;
  // op_b "n" stages B as [BK][BN + PAD_KS]; "h" as [BN][BK] (swizzled)
  static constexpr int LDB = BH ? BK : BN + PAD_KS;
  static constexpr int B_ELEMS = BH ? BN * LDB : BK * LDB;
};

// Chunks a group's ring holds: STAGES, and no more than the group has.
template <int STAGES>
__host__ __device__ __forceinline__ int ring_stages(int nk, int ks) {
  const int per = (nk + ks - 1) / ks;
  return per > STAGES ? STAGES : per;
}

template <bool AH, bool BH, int WGM, int WGN, int STAGES>
__host__ __device__ __forceinline__ int tc_smem(int nk, int ks) {
  using S = TcShape<AH, BH, WGM, WGN>;
  const int ring = ks * ring_stages<STAGES>(nk, ks) * (S::A_ELEMS + S::B_ELEMS) * 8;
  const int red = (ks - 1) * S::GT * 64 * 4;  // the groups' sums, over the rings
  return ring > red ? ring : red;
}

// op(A) fragment (m16 x k16) of a staged chunk at rows m0.., split:
// register e holds row g + 8 (e & 1), k pair 2t + 8 (e >> 1).
template <int P, bool AH, int LDA>
__device__ __forceinline__ void a_frag(const float2* a, int m0, int gq, int t,
                                       uint32_t (&f)[4][4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = m0 + gq + 8 * (e & 1), k = 2 * t + 8 * (e >> 1);
    float2 x0, x1;
    if constexpr (AH) {
      x0 = a[k * LDA + m];
      x1 = a[(k + 1) * LDA + m];
    } else {
      const float4 v = *reinterpret_cast<const float4*>(a + m * LDA + (k ^ (8 * (m & 1))));
      x0 = make_float2(v.x, v.y);
      x1 = make_float2(v.z, v.w);
    }
    split_frag<P, AH>(x0, x1, f, e);
  }
}

// op(B) fragment (k16 x n8) of a staged chunk at columns n0.., split:
// register e holds column g, k pair 2t + 8e; nb the im planes negated.
template <int P, bool BH, int LDB>
__device__ __forceinline__ void b_frag(const float2* b, int n0, int gq, int t,
                                       uint32_t (&f)[4][2], uint32_t (&nb)[2][2]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int n = n0 + gq, k = 2 * t + 8 * e;
    float2 x0, x1;
    if constexpr (BH) {
      const float4 v = *reinterpret_cast<const float4*>(b + n * LDB + (k ^ (8 * (n & 1))));
      x0 = make_float2(v.x, v.y);
      x1 = make_float2(v.z, v.w);
    } else {
      x0 = b[k * LDB + n];
      x1 = b[(k + 1) * LDB + n];
    }
    split_frag<P, BH>(x0, x1, f, e);
    nb[0][e] = f[IM_HI][e] ^ SIGNS;
    if constexpr (P == 3) nb[1][e] = f[IM_LO][e] ^ SIGNS;
  }
}

// The 4M products of one (A, B) fragment pair into (re, im): the low-part
// products first with three passes; nb holds B's im planes negated.
template <int P>
__device__ __forceinline__ void mma_4m(float* re, float* im, const uint32_t (&af)[4][4],
                                       const uint32_t (&bf)[4][2], const uint32_t (&nb)[2][2]) {
  if constexpr (P == 3) {
    mma(re, af[RE_HI], bf[RE_LO]);
    mma(re, af[RE_LO], bf[RE_HI]);
    mma(re, af[IM_HI], nb[1]);
    mma(re, af[IM_LO], nb[0]);
    mma(im, af[RE_HI], bf[IM_LO]);
    mma(im, af[RE_LO], bf[IM_HI]);
    mma(im, af[IM_HI], bf[RE_LO]);
    mma(im, af[IM_LO], bf[RE_HI]);
  }
  mma(re, af[RE_HI], bf[RE_HI]);
  mma(re, af[IM_HI], nb[0]);
  mma(im, af[RE_HI], bf[IM_HI]);
  mma(im, af[IM_HI], bf[RE_HI]);
}

template <int P, bool AH, bool BH, int WGM, int WGN, int STAGES, int MINB>
__global__ void __launch_bounds__(32 * WGM * WGN * (WGM * WGN == 1 ? SMALL_GROUPS : 1), MINB)
    cgemm_tc(const Args g) {
  using S = TcShape<AH, BH, WGM, WGN>;
  extern __shared__ __align__(16) float2 smem[];
  const int ks = blockDim.x / S::GT;
  const int tid = threadIdx.x % S::GT, group = threadIdx.x / S::GT;
  const int nk = (g.k + BK - 1) / BK;
  const int st = ring_stages<STAGES>(nk, ks);
  float2* sA = smem + group * st * (S::A_ELEMS + S::B_ELEMS);
  float2* sB = sA + st * S::A_ELEMS;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = (warp / WGN) * 32, wn = (warp % WGN) * 32;
  const int gq = lane >> 2, t = lane & 3;
  const int tm = (g.m + S::BM - 1) / S::BM, tn = (g.n + S::BN - 1) / S::BN;
  const int nkg = group < nk ? (nk - group + ks - 1) / ks : 0;  // this group's chunks
  const int n0 = (int)(blockIdx.x % tn) * S::BN;
  const int m0 = (int)(blockIdx.x / tn % tm) * S::BM;
  const long long bi = blockIdx.x / tn / tm;
  const float2* A = matrix(g.a, bi, g.inner);
  const float2* B = matrix(g.b, bi, g.inner);

  auto stage = [&](int i, int slot) {  // this group's chunk i
    const int k0 = (group + i * ks) * BK;
    if constexpr (AH)
      stage_tile<BK, S::BM, S::LDA, S::GT, false>(sA + slot * S::A_ELEMS, A, g.a.ld, k0, g.k,
                                                    m0, g.m, g.a.vec, tid);
    else
      stage_tile<S::BM, BK, S::LDA, S::GT, true>(sA + slot * S::A_ELEMS, A, g.a.ld, m0, g.m,
                                                   k0, g.k, g.a.vec, tid);
    if constexpr (BH)
      stage_tile<S::BN, BK, S::LDB, S::GT, true>(sB + slot * S::B_ELEMS, B, g.b.ld, n0, g.n,
                                                   k0, g.k, g.b.vec, tid);
    else
      stage_tile<BK, S::BN, S::LDB, S::GT, false>(sB + slot * S::B_ELEMS, B, g.b.ld, k0, g.k,
                                                    n0, g.n, g.b.vec, tid);
  };
  auto sync = [] {
    if constexpr (S::GT == 32)
      __syncwarp();
    else
      __syncthreads();  // (ks is 1)
  };

  float accR[2][4][4], accI[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) accR[i][j][e] = accI[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkg) stage(s, s);
    cp_commit();
  }
  for (int kc = 0; kc < nkg; ++kc) {
    cp_wait<STAGES - 2>();  // this thread's copies of chunk kc have landed
    sync();                 // the group's; and the slot of chunk kc - 1 is free
    if (kc + STAGES - 1 < nkg) stage(kc + STAGES - 1, (kc + STAGES - 1) % STAGES);
    cp_commit();
    const float2* a = sA + (kc % STAGES) * S::A_ELEMS;
    const float2* b = sB + (kc % STAGES) * S::B_ELEMS;
    // one row fragment of A at a time, B's fragment for each j (registers)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t af[4][4], bf[4][2], nb[2][2];
      a_frag<P, AH, S::LDA>(a, wm + 16 * i, gq, t, af);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b_frag<P, BH, S::LDB>(b, wn + 8 * j, gq, t, bf, nb);
        mma_4m<P>(accR[i][j], accI[i][j], af, bf, nb);
      }
    }
  }
  cp_wait<0>();

  if (ks > 1) {  // group 0 adds the other groups' sums, in group order
    __syncthreads();  // every ring is read
    float* red = reinterpret_cast<float*>(smem);
    if (group > 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = (i * 4 + j) * 4 + e;
            red[((group - 1) * 64 + r) * S::GT + tid] = accR[i][j][e];
            red[((group - 1) * 64 + 32 + r) * S::GT + tid] = accI[i][j][e];
          }
    }
    __syncthreads();
    if (group > 0) return;
    for (int q = 0; q < ks - 1; ++q)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = (i * 4 + j) * 4 + e;
            accR[i][j][e] += red[(q * 64 + r) * S::GT + tid];
            accI[i][j][e] += red[(q * 64 + 32 + r) * S::GT + tid];
          }
  }

  // Fragment element e of (i, j): row g (e < 2) or g + 8, column 2t + (e & 1).
  float2* Cb = g.c + bi * (long long)g.m * g.n;
  const bool vec = (g.n % 2) == 0;  // two neighbouring complex values are 16-byte aligned
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + i * 16 + gq + 8 * h;
        const int col = n0 + wn + j * 8 + 2 * t;
        if (row >= g.m || col >= g.n) continue;
        float2* out = Cb + (long long)row * g.n + col;
        const float2 v0 = make_float2(accR[i][j][2 * h], accI[i][j][2 * h]);
        const float2 v1 = make_float2(accR[i][j][2 * h + 1], accI[i][j][2 * h + 1]);
        if (vec && col + 1 < g.n) {
          *reinterpret_cast<float4*>(out) = make_float4(v0.x, v0.y, v1.x, v1.y);
        } else {
          out[0] = v0;
          if (col + 1 < g.n) out[1] = v1;
        }
      }
}

// ------------------------------------------------------------ THIN plans

// a (+)= x * y for the split parts of one real product: hi*lo + lo*hi first,
// then hi*hi (three passes), or hi*hi (one); each product exact in f32.
template <int P>
__device__ __forceinline__ float fma_split(float xh, float xl, float yh, float yl, float acc) {
  if constexpr (P == 3) {
    acc = fmaf(xh, yl, acc);
    acc = fmaf(xl, yh, acc);
  }
  return fmaf(xh, yh, acc);
}

constexpr int THIN_NT = 256;
constexpr int THIN_MC = 4;  // rows a THIN_K thread

template <int P, bool AH, bool BH>
__global__ void __launch_bounds__(THIN_NT) cgemm_thin_k(const Args g) {
  const int np = (g.n + 1) / 2, nmc = (g.m + THIN_MC - 1) / THIN_MC;
  const long long total = g.batch * nmc * np;
  for (long long idx = (long long)blockIdx.x * THIN_NT + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * THIN_NT) {
    const int n0 = (int)(idx % np) * 2;
    const long long rest = idx / np;
    const int m0 = (int)(rest % nmc) * THIN_MC;
    const long long bi = rest / nmc;
    const float2* A = matrix(g.a, bi, g.inner);
    const float2* B = matrix(g.b, bi, g.inner);
    const bool two = n0 + 1 < g.n;
    float cr[THIN_MC][2] = {}, ci[THIN_MC][2] = {};
#pragma unroll 2
    for (int k = 0; k < g.k; ++k) {
      // op(B)[k][n0], [k][n0 + 1], split
      float2 v[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
      if constexpr (BH) {
        v[0] = __ldg(B + n0 * g.b.ld + k);
        if (two) v[1] = __ldg(B + (n0 + 1) * g.b.ld + k);
        v[0].y = -v[0].y;
        v[1].y = -v[1].y;
      } else if (two && g.b.vec) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(B + k * g.b.ld + n0));
        v[0] = make_float2(q.x, q.y);
        v[1] = make_float2(q.z, q.w);
      } else {
        v[0] = __ldg(B + k * g.b.ld + n0);
        if (two) v[1] = __ldg(B + k * g.b.ld + n0 + 1);
      }
      float brh[2], brl[2], bih[2], bil[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        split1<P>(v[c].x, brh[c], brl[c]);
        split1<P>(v[c].y, bih[c], bil[c]);
      }
#pragma unroll
      for (int i = 0; i < THIN_MC; ++i) {
        const int m = m0 + i;
        if (m < g.m) {
          float2 x = AH ? __ldg(A + k * g.a.ld + m) : __ldg(A + m * g.a.ld + k);
          if constexpr (AH) x.y = -x.y;
          float arh, arl, aih, ail;
          split1<P>(x.x, arh, arl);
          split1<P>(x.y, aih, ail);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            cr[i][c] = fma_split<P>(arh, arl, brh[c], brl[c], cr[i][c]);
            cr[i][c] = fma_split<P>(-aih, -ail, bih[c], bil[c], cr[i][c]);
            ci[i][c] = fma_split<P>(arh, arl, bih[c], bil[c], ci[i][c]);
            ci[i][c] = fma_split<P>(aih, ail, brh[c], brl[c], ci[i][c]);
          }
        }
      }
    }
    float2* Cb = g.c + bi * (long long)g.m * g.n;
#pragma unroll
    for (int i = 0; i < THIN_MC; ++i) {
      const int m = m0 + i;
      if (m >= g.m) break;
      float2* out = Cb + (long long)m * g.n + n0;
      if (two && (g.n % 2) == 0) {
        *reinterpret_cast<float4*>(out) = make_float4(cr[i][0], ci[i][0], cr[i][1], ci[i][1]);
      } else {
        out[0] = make_float2(cr[i][0], ci[i][0]);
        if (two) out[1] = make_float2(cr[i][1], ci[i][1]);
      }
    }
  }
}

constexpr int THIN_N_NT = 1024;
constexpr int THIN_N_WARPS = THIN_N_NT / 32;

template <int P, bool AH, bool BH>
__global__ void __launch_bounds__(THIN_N_NT) cgemm_thin_n(const Args g) {
  __shared__ float4 red[THIN_N_WARPS][32];  // op_a "h": (re0, im0, re1, im1) a warp and lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int ROWS = AH ? 32 : THIN_N_WARPS;  // rows a block
  const int tm = (g.m + ROWS - 1) / ROWS;
  const bool two = g.n > 1;
  for (long long blk = blockIdx.x; blk < g.batch * tm; blk += gridDim.x) {
    const long long bi = blk / tm;
    const int m = (int)(blk % tm) * ROWS + (AH ? lane : warp);
    const float2* A = matrix(g.a, bi, g.inner);
    const float2* B = matrix(g.b, bi, g.inner);
    float cr[2] = {0.f, 0.f}, ci[2] = {0.f, 0.f};
    if (m < g.m) {
      const int k_first = AH ? warp : lane, k_step = AH ? THIN_N_WARPS : 32;
#pragma unroll 8
      for (int k = k_first; k < g.k; k += k_step) {
        float2 x = AH ? __ldg(A + (long long)k * g.a.ld + m) : __ldg(A + (long long)m * g.a.ld + k);
        float2 v[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
        if constexpr (BH) {
          v[0] = __ldg(B + k);
          if (two) v[1] = __ldg(B + g.b.ld + k);
          v[0].y = -v[0].y;
          v[1].y = -v[1].y;
        } else {
          v[0] = __ldg(B + (long long)k * g.b.ld);
          if (two) v[1] = __ldg(B + (long long)k * g.b.ld + 1);
        }
        if constexpr (AH) x.y = -x.y;
        float arh, arl, aih, ail;
        split1<P>(x.x, arh, arl);
        split1<P>(x.y, aih, ail);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float brh, brl, bih, bil;
          split1<P>(v[c].x, brh, brl);
          split1<P>(v[c].y, bih, bil);
          cr[c] = fma_split<P>(arh, arl, brh, brl, cr[c]);
          cr[c] = fma_split<P>(-aih, -ail, bih, bil, cr[c]);
          ci[c] = fma_split<P>(arh, arl, bih, bil, ci[c]);
          ci[c] = fma_split<P>(aih, ail, brh, brl, ci[c]);
        }
      }
    }
    float2* Cb = g.c + bi * (long long)g.m * g.n;
    if constexpr (AH) {
      red[warp][lane] = make_float4(cr[0], ci[0], cr[1], ci[1]);
      __syncthreads();
      if (warp == 0 && m < g.m) {
        float4 s = red[0][lane];
#pragma unroll
        for (int w = 1; w < THIN_N_WARPS; ++w) {
          const float4 r = red[w][lane];
          s.x += r.x;
          s.y += r.y;
          s.z += r.z;
          s.w += r.w;
        }
        Cb[(long long)m * g.n] = make_float2(s.x, s.y);
        if (two) Cb[(long long)m * g.n + 1] = make_float2(s.z, s.w);
      }
      __syncthreads();
    } else {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          cr[c] += __shfl_xor_sync(0xffffffffu, cr[c], off);
          ci[c] += __shfl_xor_sync(0xffffffffu, ci[c], off);
        }
      if (lane == 0 && m < g.m) {
        Cb[(long long)m * g.n] = make_float2(cr[0], ci[0]);
        if (two) Cb[(long long)m * g.n + 1] = make_float2(cr[1], ci[1]);
      }
    }
  }
}

// ---------------------------------------------------------------- plans

int choose_plan(long long batch, int m, int n, int k) {
  if (k <= THIN_K_MAX) return THIN_K;
  if (n <= THIN_N_MAX) return THIN_N;
  if (m >= 64 && n >= 64 && k >= 16) {
    const bool tall = m >= n;  // 128 x 64 tiles, else 64 x 128
    const int bm = tall ? 128 : 64, bn = tall ? 64 : 128;
    if (batch * ((m + bm - 1) / bm) * ((n + bn - 1) / bn) >= LARGE_MIN_TILES)
      return tall ? LARGE_M : LARGE_N;
  }
  return SMALL;
}

struct Launch {
  const void* fn;
  int threads, smem;
  long long blocks;
};

long long cap_blocks(long long n) { return n < (1LL << 20) ? (n > 0 ? n : 1) : (1LL << 20); }

// SMALL's groups a block: doubled while the blocks' warps still fit at once
// and each group keeps a chunk (a function of the shape alone).
int small_groups(long long tiles, int nk) {
  int ks = 1;
  while (ks < SMALL_GROUPS && ks < nk && tiles * ks * 2 <= SMALL_WARPS) ks *= 2;
  return ks;
}

template <int P, bool AH, bool BH, int WGM, int WGN, int STAGES, int MINB>
Launch tc_launch(const Args* g) {
  using S = TcShape<AH, BH, WGM, WGN>;
  const void* fn = reinterpret_cast<const void*>(cgemm_tc<P, AH, BH, WGM, WGN, STAGES, MINB>);
  constexpr int max_ks = WGM * WGN == 1 ? SMALL_GROUPS : 1;
  constexpr int max_smem = max_ks * STAGES * (S::A_ELEMS + S::B_ELEMS) * 8;
  // The dynamic shared memory a block may ask for, once a process and device.
  static unsigned configured = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (max_smem > 48 * 1024 && !((configured >> (dev & 31)) & 1u)) {
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    configured |= 1u << (dev & 31);
  }
  if (!g) return {fn, S::GT * max_ks, max_smem, 0};
  const long long tiles = g->batch * ((g->m + S::BM - 1) / S::BM) * ((g->n + S::BN - 1) / S::BN);
  const int nk = (g->k + BK - 1) / BK;
  const int ks = max_ks > 1 ? small_groups(tiles, nk) : 1;
  return {fn, S::GT * ks, tc_smem<AH, BH, WGM, WGN, STAGES>(nk, ks), tiles};
}

template <int P, bool AH, bool BH>
Launch plan_launch(int plan, const Args* g) {
  switch (plan) {
    case THIN_K: {
      long long n = 0;
      if (g) n = g->batch * ((g->m + THIN_MC - 1) / THIN_MC) * ((g->n + 1) / 2);
      return {reinterpret_cast<const void*>(cgemm_thin_k<P, AH, BH>), THIN_NT, 0,
              cap_blocks((n + THIN_NT - 1) / THIN_NT)};
    }
    case THIN_N: {
      long long n = 0;
      if (g) n = g->batch * ((g->m + (AH ? 31 : THIN_N_WARPS - 1)) / (AH ? 32 : THIN_N_WARPS));
      return {reinterpret_cast<const void*>(cgemm_thin_n<P, AH, BH>), THIN_N_NT, 0,
              cap_blocks(n)};
    }
    // SMALL: up to 4 groups of one warp, K split among them. LARGE: a ring
    // of 3 chunks at three passes and of 4 at one, the depths at which the
    // 128 registers of two blocks an SM spill least (timed on the card).
    case SMALL:
      return tc_launch<P, AH, BH, 1, 1, 2, 3>(g);
    case LARGE_M:
      return tc_launch<P, AH, BH, 4, 2, P == 3 ? 3 : 4, 2>(g);
    default:
      return tc_launch<P, AH, BH, 2, 4, P == 3 ? 3 : 4, 2>(g);
  }
}

Launch launch_of(int plan, int passes, bool ah, bool bh, const Args* g) {
  if (passes == 3) {
    if (ah) return bh ? plan_launch<3, true, true>(plan, g) : plan_launch<3, true, false>(plan, g);
    return bh ? plan_launch<3, false, true>(plan, g) : plan_launch<3, false, false>(plan, g);
  }
  if (ah) return bh ? plan_launch<1, true, true>(plan, g) : plan_launch<1, true, false>(plan, g);
  return bh ? plan_launch<1, false, true>(plan, g) : plan_launch<1, false, false>(plan, g);
}

bool vec_ok(const void* p, long long s_outer, long long s_inner, long long ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s_outer % 2 == 0 && s_inner % 2 == 0 &&
         ld % 2 == 0;
}

}  // namespace qk7

extern "C" {

// The plan qk_cgemm_launch takes for (batch, m, n, k): 0 thin_k, 1 thin_n,
// 2 small, 3 large_m, 4 large_n (ops/lowp.PLANS).
int qk_cgemm_plan(long long batch, int m, int n, int k) {
  return qk7::choose_plan(batch, m, n, k);
}

// c[b] = op_a(a[b]) . op_b(b[b]) for b < batch (op_a: a[b] is [k, m], the
// conjugate transpose taken; op_b: b[b] is [n, k], likewise); matrix b of an
// operand at (b / inner) * s_outer + (b % inner) * s_inner, rows ld apart,
// in complex elements; c dense [batch, m, n]; passes 1 or 3.
int qk_cgemm_launch(const void* a, const void* b, void* c, long long batch, long long inner,
                    int m, int n, int k, long long sa_outer, long long sa_inner, long long lda,
                    long long sb_outer, long long sb_inner, long long ldb, int op_a, int op_b,
                    int passes, void* stream) {
  if (batch < 1 || inner < 1 || batch % inner != 0 || m < 1 || n < 1 || k < 1 || sa_outer < 0 ||
      sa_inner < 0 || lda < 0 || sb_outer < 0 || sb_inner < 0 || ldb < 0 ||
      (passes != 1 && passes != 3))
    return (int)cudaErrorInvalidValue;
  const qk7::Args g{{static_cast<const float2*>(a), sa_outer, sa_inner, lda,
                     qk7::vec_ok(a, sa_outer, sa_inner, lda)},
                    {static_cast<const float2*>(b), sb_outer, sb_inner, ldb,
                     qk7::vec_ok(b, sb_outer, sb_inner, ldb)},
                    static_cast<float2*>(c),
                    batch,
                    inner,
                    m,
                    n,
                    k};
  const qk7::Launch l =
      qk7::launch_of(qk7::choose_plan(batch, m, n, k), passes, op_a != 0, op_b != 0, &g);
  if (l.blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  void* args[] = {const_cast<qk7::Args*>(&g)};
  return (int)cudaLaunchKernel(l.fn, dim3((unsigned)l.blocks), dim3((unsigned)l.threads), args,
                               (size_t)l.smem, static_cast<cudaStream_t>(stream));
}

// out[0..4]: registers a thread, static shared bytes, dynamic shared bytes,
// threads a block and local (spill) bytes a thread of a plan's kernel.
int qk_cgemm_attrs(int plan, int passes, int op_a, int op_b, int* out) {
  if (plan < qk7::THIN_K || plan > qk7::LARGE_N || (passes != 1 && passes != 3))
    return (int)cudaErrorInvalidValue;
  const qk7::Launch l = qk7::launch_of(plan, passes, op_a != 0, op_b != 0, nullptr);
  cudaFuncAttributes at;
  const cudaError_t err = cudaFuncGetAttributes(&at, l.fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = at.numRegs;
  out[1] = (int)at.sharedSizeBytes;
  out[2] = l.smem;
  out[3] = l.threads;
  out[4] = (int)at.localSizeBytes;
  return 0;
}

}  // extern "C"
