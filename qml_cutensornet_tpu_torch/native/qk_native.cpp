// Native CPU MPS engine for the quantum-kernel pipeline.
//
// The counterpart of the reference's in-repo Julia package
// (KernelPkg/src/KernelPkg.jl): TKET-convention gates applied to an MPS with
// per-two-site-gate truncated SVD under a relative cutoff (ITensors
// `apply(...; cutoff)` semantics, KernelPkg.jl:68), plus tile computation
// tile[i,j] = |<y_i|x_j>|^2 (KernelPkg.jl:75-112). Used as the CPU backend
// and as an independent native cross-check of the JAX/TPU engine.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment). Gate
// lists arrive pre-routed (adjacent 2-qubit ops only), in the same lowered
// form the reference's CPU backend ships to Julia
// (cpu_backend/kernel_state_ansatz.py:96-131): op code, qubits, pytket
// half-turn exponent.
//
// Build: g++ -O3 -fPIC -shared -fopenmp qk_native.cpp -o libqk.so \
//        -l:liblapack.so.3 -l:libblas.so.3

#include <ctime>

#include <algorithm>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <vector>

using cd = std::complex<double>;

extern "C" {
void zgesdd_(const char* jobz, const int* m, const int* n, cd* a, const int* lda,
             double* s, cd* u, const int* ldu, cd* vt, const int* ldvt,
             cd* work, const int* lwork, double* rwork, int* iwork, int* info);
void zgemm_(const char* transa, const char* transb, const int* m, const int* n,
            const int* k, const cd* alpha, const cd* a, const int* lda,
            const cd* b, const int* ldb, const cd* beta, cd* c, const int* ldc);
void zgeqrf_(const int* m, const int* n, cd* a, const int* lda, cd* tau,
             cd* work, const int* lwork, int* info);
void zungqr_(const int* m, const int* n, const int* k, cd* a, const int* lda,
             const cd* tau, cd* work, const int* lwork, int* info);
void zgelqf_(const int* m, const int* n, cd* a, const int* lda, cd* tau,
             cd* work, const int* lwork, int* info);
void zunglq_(const int* m, const int* n, const int* k, cd* a, const int* lda,
             const cd* tau, cd* work, const int* lwork, int* info);
}

namespace {

constexpr double kPi = 3.14159265358979323846;

// Gate op codes (must match native/__init__.py).
enum OpCode : int32_t { OP_H = 0, OP_RX = 1, OP_RZ = 2, OP_XXPHASE = 3, OP_ZZPHASE = 4, OP_SWAP = 5 };

// Column-major complex matrix multiply C = A(m x k) * B(k x n).
void matmul(const cd* a, const cd* b, cd* c, int m, int k, int n) {
  const cd one(1.0, 0.0), zero(0.0, 0.0);
  zgemm_("N", "N", &m, &n, &k, &one, a, &m, b, &k, &zero, c, &m);
}

struct Site {
  int chiL = 1, chiR = 1;
  std::vector<cd> a;  // column-major over flattened (chiL*2, chiR):
                      // a[(l + chiL*s) + (chiL*2)*r]
  cd& at(int l, int s, int r) { return a[(l + chiL * s) + (size_t)(chiL * 2) * r]; }
  cd at(int l, int s, int r) const { return a[(l + chiL * s) + (size_t)(chiL * 2) * r]; }
};

struct MPS {
  int n = 0;
  std::vector<Site> t;
  double fidelity = 1.0;
  int max_chi = 1;
  // Orthogonality center (-1 = undefined; a product state is canonical
  // everywhere). Kept at the gate position so every truncated SVD acts
  // against orthonormal environments — ITensors' `apply` orthogonalizes
  // to each gate the same way (KernelPkg.jl:68); without this, truncation
  // against non-orthogonal environments is wildly suboptimal once the
  // chi cap binds (measured: fidelity 0.77 vs 0.999999 at 16q cap 16).
  int center = -1;

  explicit MPS(int nq) : n(nq), t(nq) {
    for (auto& s : t) {
      s.chiL = s.chiR = 1;
      s.a.assign(2, cd(0.0, 0.0));
      s.a[0] = cd(1.0, 0.0);  // |0>
    }
  }
};

void gate_matrix_1q(int op, double alpha, cd u[4]) {
  const double th = kPi * alpha / 2.0;  // TKET half-turn convention
  switch (op) {
    case OP_H: {
      const double r = 1.0 / std::sqrt(2.0);
      u[0] = r; u[1] = r; u[2] = r; u[3] = -r;  // column-major (symmetric)
      break;
    }
    case OP_RX:
      u[0] = std::cos(th); u[1] = cd(0, -std::sin(th));
      u[2] = cd(0, -std::sin(th)); u[3] = std::cos(th);
      break;
    case OP_RZ:
      u[0] = std::exp(cd(0, -th)); u[1] = 0; u[2] = 0; u[3] = std::exp(cd(0, th));
      break;
    default:
      u[0] = u[3] = 1; u[1] = u[2] = 0;
  }
}

// 4x4 gate, column-major, basis order |s0 s1> with s0 the LEFT site's
// physical index as the faster-varying row bit? We use index (s0*2 + s1).
void gate_matrix_2q(int op, double alpha, cd u[16]) {
  const double th = kPi * alpha / 2.0;
  std::fill(u, u + 16, cd(0, 0));
  auto set = [&](int r, int c, cd v) { u[r + 4 * c] = v; };
  switch (op) {
    case OP_XXPHASE: {
      const cd c(std::cos(th), 0.0), is(0.0, -std::sin(th));
      set(0, 0, c); set(0, 3, is);
      set(1, 1, c); set(1, 2, is);
      set(2, 2, c); set(2, 1, is);
      set(3, 3, c); set(3, 0, is);
      break;
    }
    case OP_ZZPHASE:
      set(0, 0, std::exp(cd(0, -th)));
      set(1, 1, std::exp(cd(0, th)));
      set(2, 2, std::exp(cd(0, th)));
      set(3, 3, std::exp(cd(0, -th)));
      break;
    case OP_SWAP:
      set(0, 0, 1); set(1, 2, 1); set(2, 1, 1); set(3, 3, 1);
      break;
    default:
      set(0, 0, 1); set(1, 1, 1); set(2, 2, 1); set(3, 3, 1);
  }
}

void apply_1q(MPS& mps, int q, const cd u[4]) {
  // u is column-major 2x2: u[r + 2*c]; new[s'] = sum_s u[s', s] old[s].
  Site& s = mps.t[q];
  std::vector<cd> out(s.a.size());
  for (int r = 0; r < s.chiR; ++r)
    for (int l = 0; l < s.chiL; ++l) {
      const cd v0 = s.at(l, 0, r), v1 = s.at(l, 1, r);
      out[(l + s.chiL * 0) + (size_t)(s.chiL * 2) * r] = u[0] * v0 + u[2] * v1;
      out[(l + s.chiL * 1) + (size_t)(s.chiL * 2) * r] = u[1] * v0 + u[3] * v1;
    }
  s.a.swap(out);
}

// Move the orthogonality center right across bond (i, i+1): QR-factor site
// i (left-orthonormal Q stays), absorb R into site i+1. Exact — ranks can
// only shrink (k = min(2*chiL, chiR)).
int push_right(MPS& mps, int i) {
  Site& A = mps.t[i];
  Site& B = mps.t[i + 1];
  const int m = A.chiL * 2, n = A.chiR, k = std::min(m, n);
  std::vector<cd> a = A.a;  // (m x n) column-major
  std::vector<cd> tau(k);
  int info = 0, lwork = -1;
  cd wq;
  zgeqrf_(&m, &n, a.data(), &m, tau.data(), &wq, &lwork, &info);
  lwork = (int)wq.real();
  std::vector<cd> work(lwork);
  zgeqrf_(&m, &n, a.data(), &m, tau.data(), work.data(), &lwork, &info);
  if (info != 0) return -4;
  std::vector<cd> rmat((size_t)k * n, cd(0, 0));  // R: k x n upper tri
  for (int c = 0; c < n; ++c)
    for (int r = 0; r <= std::min(c, k - 1); ++r)
      rmat[r + (size_t)k * c] = a[r + (size_t)m * c];
  lwork = -1;
  zungqr_(&m, &k, &k, a.data(), &m, tau.data(), &wq, &lwork, &info);
  lwork = (int)wq.real();
  work.resize(lwork);
  zungqr_(&m, &k, &k, a.data(), &m, tau.data(), work.data(), &lwork, &info);
  if (info != 0) return -4;
  A.a.assign(a.begin(), a.begin() + (size_t)m * k);
  A.chiR = k;
  // B' = R (k x n) @ B viewed as (n, 2*chiR) with column (s + 2*r).
  const int cr = B.chiR;
  std::vector<cd> bmat((size_t)n * 2 * cr);
  for (int r = 0; r < cr; ++r)
    for (int s = 0; s < 2; ++s)
      for (int l = 0; l < n; ++l)
        bmat[l + (size_t)n * (s + 2 * r)] = B.at(l, s, r);
  std::vector<cd> c2((size_t)k * 2 * cr);
  matmul(rmat.data(), bmat.data(), c2.data(), k, n, 2 * cr);
  B.chiL = k;
  B.a.assign((size_t)(k * 2) * cr, cd(0, 0));
  for (int r = 0; r < cr; ++r)
    for (int s = 0; s < 2; ++s)
      for (int l = 0; l < k; ++l)
        B.a[(l + k * s) + (size_t)(k * 2) * r] = c2[l + (size_t)k * (s + 2 * r)];
  return 0;
}

// Move the orthogonality center left across bond (i-1, i): LQ-factor site i
// (row-orthonormal Q stays), absorb L into site i-1.
int push_left(MPS& mps, int i) {
  Site& B = mps.t[i];
  Site& A = mps.t[i - 1];
  const int mB = B.chiL, nB = 2 * B.chiR, k = std::min(mB, nB);
  std::vector<cd> mmat((size_t)mB * nB);  // (mB x nB), column (s + 2*r)
  for (int r = 0; r < B.chiR; ++r)
    for (int s = 0; s < 2; ++s)
      for (int l = 0; l < mB; ++l)
        mmat[l + (size_t)mB * (s + 2 * r)] = B.at(l, s, r);
  std::vector<cd> tau(k);
  int info = 0, lwork = -1;
  cd wq;
  zgelqf_(&mB, &nB, mmat.data(), &mB, tau.data(), &wq, &lwork, &info);
  lwork = (int)wq.real();
  std::vector<cd> work(lwork);
  zgelqf_(&mB, &nB, mmat.data(), &mB, tau.data(), work.data(), &lwork, &info);
  if (info != 0) return -5;
  std::vector<cd> lmat((size_t)mB * k, cd(0, 0));  // L: mB x k lower tri
  for (int c = 0; c < k; ++c)
    for (int r = c; r < mB; ++r)
      lmat[r + (size_t)mB * c] = mmat[r + (size_t)mB * c];
  lwork = -1;
  zunglq_(&k, &nB, &k, mmat.data(), &mB, tau.data(), &wq, &lwork, &info);
  lwork = (int)wq.real();
  work.resize(lwork);
  zunglq_(&k, &nB, &k, mmat.data(), &mB, tau.data(), work.data(), &lwork, &info);
  if (info != 0) return -5;
  const int cr = B.chiR;
  B.chiL = k;
  B.a.assign((size_t)(k * 2) * cr, cd(0, 0));
  for (int r = 0; r < cr; ++r)
    for (int s = 0; s < 2; ++s)
      for (int l = 0; l < k; ++l)
        B.a[(l + k * s) + (size_t)(k * 2) * r] = mmat[l + (size_t)mB * (s + 2 * r)];
  // A' = A (2*chiL x mB) @ L (mB x k).
  const int ma = A.chiL * 2;
  std::vector<cd> a2((size_t)ma * k);
  matmul(A.a.data(), lmat.data(), a2.data(), ma, mB, k);
  A.a.swap(a2);
  A.chiR = k;
  return 0;
}

// Bring the center to the gate pair (q, q+1); either endpoint is valid
// (sites < q left-orthonormal, sites > q+1 right-orthonormal).
int ensure_center(MPS& mps, int q) {
  if (mps.center < 0) {
    mps.center = q;  // product start: canonical everywhere
    return 0;
  }
  while (mps.center < q) {
    const int r = push_right(mps, mps.center);
    if (r != 0) return r;
    ++mps.center;
  }
  while (mps.center > q + 1) {
    const int r = push_left(mps, mps.center);
    if (r != 0) return r;
    --mps.center;
  }
  return 0;
}

// Apply a 2-qubit gate on adjacent sites (q, q+1) and truncate with the
// relative-cutoff rule (discarded squared-sv weight <= cutoff * total).
// The center is first brought to the pair so the truncation is globally
// optimal (ITensors `apply` semantics).
int apply_2q(MPS& mps, int q, const cd u[16], double cutoff, int chi_cap) {
  if (ensure_center(mps, q) != 0) return -6;
  Site& A = mps.t[q];
  Site& B = mps.t[q + 1];
  const int cl = A.chiL, cm = A.chiR, cr = B.chiR;
  if (cm != B.chiL) return -1;

  // theta[(l,s0),(s1,r)] = sum_m A[l,s0,m] B[m,s1,r]; column-major
  // (rows cl*2, cols 2*cr). A is already (cl*2, cm) column-major; B needs
  // permuting to (cm, 2*cr) with column index (s1 + 2*r) -> use (r fastest?
  // keep column index c = s1*cr + r? We choose c = s1 + 2*r to match the
  // gate basis (s0*2+s1) row/col mapping below.
  std::vector<cd> bmat((size_t)cm * 2 * cr);
  for (int r = 0; r < cr; ++r)
    for (int s1 = 0; s1 < 2; ++s1)
      for (int m = 0; m < cm; ++m)
        bmat[m + (size_t)cm * (s1 + 2 * r)] = B.at(m, s1, r);
  std::vector<cd> theta((size_t)(cl * 2) * (2 * cr));
  matmul(A.a.data(), bmat.data(), theta.data(), cl * 2, cm, 2 * cr);

  // Apply gate: theta'[(l,s0'),(s1',r)] = sum_{s0,s1} U[(s0's1'),(s0 s1)] theta[(l,s0),(s1,r)]
  std::vector<cd> theta2((size_t)(cl * 2) * (2 * cr), cd(0, 0));
  for (int r = 0; r < cr; ++r)
    for (int s1p = 0; s1p < 2; ++s1p)
      for (int s0p = 0; s0p < 2; ++s0p)
        for (int s1 = 0; s1 < 2; ++s1)
          for (int s0 = 0; s0 < 2; ++s0) {
            const cd g = u[(s0p * 2 + s1p) + 4 * (s0 * 2 + s1)];
            if (g == cd(0, 0)) continue;
            for (int l = 0; l < cl; ++l)
              theta2[(l + cl * s0p) + (size_t)(cl * 2) * (s1p + 2 * r)] +=
                  g * theta[(l + cl * s0) + (size_t)(cl * 2) * (s1 + 2 * r)];
          }

  // SVD (LAPACK zgesdd, jobz='S').
  const int m = cl * 2, n = 2 * cr, mn = std::min(m, n);
  std::vector<double> s(mn);
  std::vector<cd> umat((size_t)m * mn), vt((size_t)mn * n);
  {
    int info = 0, lwork = -1;
    cd wq;
    std::vector<double> rwork((size_t)mn * std::max(5 * mn + 7, 2 * std::max(m, n) + 2 * mn + 1));
    std::vector<int> iwork(8 * mn);
    zgesdd_("S", &m, &n, theta2.data(), &m, s.data(), umat.data(), &m, vt.data(), &mn,
            &wq, &lwork, rwork.data(), iwork.data(), &info);
    lwork = (int)wq.real();
    std::vector<cd> work(lwork);
    zgesdd_("S", &m, &n, theta2.data(), &m, s.data(), umat.data(), &m, vt.data(), &mn,
            work.data(), &lwork, rwork.data(), iwork.data(), &info);
    if (info != 0) return -2;
  }

  // Truncate: keep the smallest leading set with tail weight <= cutoff*total.
  double total = 0.0;
  for (double v : s) total += v * v;
  int keep = mn;
  double tail = 0.0;
  while (keep > 1) {
    const double p = s[keep - 1] * s[keep - 1];
    if (tail + p > cutoff * total) break;
    tail += p;
    --keep;
  }
  if (chi_cap > 0) keep = std::min(keep, chi_cap);
  double kept_w = 0.0;
  for (int i = 0; i < keep; ++i) kept_w += s[i] * s[i];
  if (total > 0) mps.fidelity *= kept_w / total;
  mps.max_chi = std::max(mps.max_chi, keep);

  // New A = U[:, :keep]  (already column-major (m, keep) prefix).
  A.chiR = keep;
  A.a.assign(umat.begin(), umat.begin() + (size_t)m * keep);
  // New B[(k),(s1,r)] = s_k * VT[k, (s1 + 2r)] -> tensor [keep, 2, cr].
  B.chiL = keep;
  B.a.assign((size_t)(keep * 2) * cr, cd(0, 0));
  for (int r = 0; r < cr; ++r)
    for (int s1 = 0; s1 < 2; ++s1)
      for (int k = 0; k < keep; ++k)
        B.a[(k + keep * s1) + (size_t)(keep * 2) * r] = s[k] * vt[k + (size_t)mn * (s1 + 2 * r)];
  mps.center = q + 1;  // B holds S*VT; A = U is left-orthonormal
  return keep;
}

// <a|b> via transfer contraction (dynamic bond dims).
cd vdot(const MPS& a, const MPS& b) {
  std::vector<cd> env(1, cd(1.0, 0.0));  // [chiA x chiB] column-major
  int ca = 1, cb = 1;
  for (int i = 0; i < a.n; ++i) {
    const Site& ta = a.t[i];
    const Site& tb = b.t[i];
    // tmp[(la,s), rb] = sum_lb env[la, lb] tb[lb, s, rb]
    std::vector<cd> tb_mat((size_t)cb * 2 * tb.chiR);
    for (int r = 0; r < tb.chiR; ++r)
      for (int s = 0; s < 2; ++s)
        for (int l = 0; l < cb; ++l)
          tb_mat[l + (size_t)cb * (s + 2 * r)] = tb.at(l, s, r);
    std::vector<cd> tmp((size_t)ca * 2 * tb.chiR);
    matmul(env.data(), tb_mat.data(), tmp.data(), ca, cb, 2 * tb.chiR);
    // env'[ra, rb] = sum_{la,s} conj(ta[la, s, ra]) tmp[la, (s, rb)]
    // -> env' = (ta as (la*2, ra))^H * (tmp reshaped (la*2? mismatched
    // ordering)) ... tmp index is la + ca*(s + 2*rb): same (la, s) fusing as
    // ta's (la + chiL*s) only if ca == ta.chiL (true) and orders match: ta
    // fuses (l + chiL*s) and tmp fuses (l + ca*s): identical. Reshape tmp to
    // (ca*2, tb.chiR) by regrouping columns: tmp column (s + 2*rb) holds l;
    // we need rows (l + ca*s). Build explicitly.
    std::vector<cd> tmp2((size_t)(ca * 2) * tb.chiR);
    for (int rb = 0; rb < tb.chiR; ++rb)
      for (int s = 0; s < 2; ++s)
        for (int l = 0; l < ca; ++l)
          tmp2[(l + ca * s) + (size_t)(ca * 2) * rb] = tmp[l + (size_t)ca * (s + 2 * rb)];
    std::vector<cd> env2((size_t)ta.chiR * tb.chiR, cd(0, 0));
    const int mm = ta.chiR, kk = ca * 2, nn = tb.chiR;
    const cd one(1, 0), zero(0, 0);
    zgemm_("C", "N", &mm, &nn, &kk, &one, ta.a.data(), &kk, tmp2.data(), &kk, &zero,
           env2.data(), &mm);
    env.swap(env2);
    ca = ta.chiR;
    cb = tb.chiR;
  }
  return env[0];
}

// Simulate one pre-routed gate list.
int simulate(MPS& mps, int n_ops, const int32_t* ops, const int32_t* q0,
             const int32_t* q1, const double* alpha, double cutoff, int chi_cap) {
  for (int g = 0; g < n_ops; ++g) {
    const int op = ops[g];
    if (op == OP_H || op == OP_RX || op == OP_RZ) {
      cd u[4];
      gate_matrix_1q(op, alpha[g], u);
      apply_1q(mps, q0[g], u);
    } else if (op == OP_XXPHASE || op == OP_ZZPHASE || op == OP_SWAP) {
      int a = q0[g], b = q1[g];
      if (b == a + 1) {
        // gate basis (s_a, s_b) matches (left, right)
      } else if (a == b + 1) {
        std::swap(a, b);  // all these gates are symmetric under exchange
      } else {
        return -10 - g;  // non-adjacent: caller must route
      }
      cd u[16];
      gate_matrix_2q(op, alpha[g], u);
      if (apply_2q(mps, a, u, cutoff, chi_cap) < 0) return -1;
    } else {
      return -3;  // unrecognised gate (KernelPkg.jl:62 behavior)
    }
  }
  return 0;
}

}  // namespace

extern "C" {

int qk_version() { return 1; }

// Simulate n_circ circuits and fill per-circuit fidelity and max chi.
// Gate lists are concatenated; offsets has n_circ+1 entries.
int qk_simulate_stats(int nq, int n_circ, const int64_t* offsets, const int32_t* ops,
                      const int32_t* q0, const int32_t* q1, const double* alpha,
                      double cutoff, int chi_cap, double* fidelity, int32_t* max_chi) {
  int rc = 0;
#pragma omp parallel for schedule(dynamic)
  for (int c = 0; c < n_circ; ++c) {
    MPS mps(nq);
    const int64_t a = offsets[c], b = offsets[c + 1];
    int r = simulate(mps, (int)(b - a), ops + a, q0 + a, q1 + a, alpha + a, cutoff, chi_cap);
    if (r != 0) {
#pragma omp critical
      rc = r;
    }
    fidelity[c] = mps.fidelity;
    max_chi[c] = mps.max_chi;
  }
  return rc;
}

// The KernelPkg.compute_tile equivalent (KernelPkg.jl:75-112): simulate the
// x- and y-circuit lists and fill tile[i, j] = |<y_i|x_j>|^2 (row-major,
// n_y rows by n_x columns). If y buffers alias x buffers the states are
// reused. Returns 0 on success.
int qk_compute_tile(int nq,
                    int n_x, const int64_t* x_off, const int32_t* x_ops,
                    const int32_t* x_q0, const int32_t* x_q1, const double* x_alpha,
                    int n_y, const int64_t* y_off, const int32_t* y_ops,
                    const int32_t* y_q0, const int32_t* y_q1, const double* y_alpha,
                    double cutoff, int chi_cap,
                    double* tile, double* x_fid, int32_t* x_chi,
                    double* y_fid, int32_t* y_chi, double* timings /* [2]: sim, vdot */) {
  const auto wall = []() {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + 1e-9 * ts.tv_nsec;
  };
  const double t_start = wall();
  std::vector<MPS> xs, ys;
  xs.reserve(n_x);
  for (int c = 0; c < n_x; ++c) xs.emplace_back(nq);
  const bool same = (x_ops == y_ops && x_off == y_off && n_x == n_y);
  if (!same) {
    ys.reserve(n_y);
    for (int c = 0; c < n_y; ++c) ys.emplace_back(nq);
  }

  int rc = 0;
#pragma omp parallel for schedule(dynamic)
  for (int c = 0; c < n_x + (same ? 0 : n_y); ++c) {
    int r;
    if (c < n_x) {
      const int64_t a = x_off[c], b = x_off[c + 1];
      r = simulate(xs[c], (int)(b - a), x_ops + a, x_q0 + a, x_q1 + a, x_alpha + a, cutoff, chi_cap);
      x_fid[c] = xs[c].fidelity;
      x_chi[c] = xs[c].max_chi;
    } else {
      const int cc = c - n_x;
      const int64_t a = y_off[cc], b = y_off[cc + 1];
      r = simulate(ys[cc], (int)(b - a), y_ops + a, y_q0 + a, y_q1 + a, y_alpha + a, cutoff, chi_cap);
      y_fid[cc] = ys[cc].fidelity;
      y_chi[cc] = ys[cc].max_chi;
    }
    if (r != 0) {
#pragma omp critical
      rc = r;
    }
  }
  if (rc != 0) return rc;
  const std::vector<MPS>& yv = same ? xs : ys;
  if (same) {
    for (int c = 0; c < n_x; ++c) {
      y_fid[c] = x_fid[c];
      y_chi[c] = x_chi[c];
    }
  }
  const double t_sim = wall();

#pragma omp parallel for collapse(2) schedule(dynamic)
  for (int i = 0; i < n_y; ++i)
    for (int j = 0; j < n_x; ++j) {
      const cd ov = vdot(yv[i], xs[j]);
      tile[(size_t)i * n_x + j] = std::norm(ov);
    }
  if (timings) {
    timings[0] = t_sim - t_start;
    timings[1] = wall() - t_sim;
  }
  return 0;
}

}  // extern "C"
