// Device code of the fused DMRG bond step (K12), its multi-bond block (K12m),
// its two halves around an outside QR (K1, K2), its four pieces for data-
// parallel and batch-tiled bond steps (K1a, K1b, K2-split, K2-env), the
// stand-alone power step of the split-tail route (K1-tail), real
// (float) and complex (cfloat), and the kernels that run a bond over a
// thread-block cluster: the multi-bond block (K12m, K12 and K12mc), the
// batch gradient (K1a, K1c-grad), the bond update up to its
// orthogonalisation (K1 and K1c, K1b and K1c-update) and the split with or
// without the environment advance (K2 and K2c, K2-split and K2c-split) at
// both scalar types, and the complex bond step (K12c) and the tracked-ritz
// bond step (K12cr) at cfloat; the environment advance over independent
// row tiles (K2-env, K2c-env) and the stored-BT power step over a
// cooperative grid (K1-tail, K1c-tail).
// See bond_step.cu and bond_step_c.cu for what the kernels replace and how
// they are bounded; this header holds the math, phase by phase, written once
// for both scalar types and both teams.
//
// Layouts (row-major, contiguous; T = float or cfloat):
//   lhs      [Bb, chi, d, chi]  T  the static core of each bond
//                                  (backward: cores[j]; forward: cores[j+1])
//   center   [C, chi, d, chi]   T  the class-major two-site center
//   envx     [Bb, N, chi]       T  the opposite-side environment of each bond
//                                  (backward: LE[j]; forward: RE[j+2])
//   env0/ls0 [N, chi] / [N]     T / float  the advancing environment entering
//                                  the block
//   phil/phir [Bb, N, d]        T  conjugated site features of the two sites
//   y1h [N, C], w [N]           float  one-hot labels and per-sample weights
//   v0  [Bb, chi*d, chi]        T  the cached subspace of each bond
// With P = chi*d, the bond tensor of class c is BT[c] [P, P]: rows
// p = a*d + i (left bond a, left site i), columns q = k*chi + b (right site
// k, right bond b).  The subspace Q [P, chi] spans the q side going backward
// and the p side going forward.
//
// Complex conjugation (the map of mpstime_tpu/ops/pallas_bond_c.py:15-32;
// conj is the identity on float, so the real kernels read the same code):
//   L = conj(le) (x) phil,  R = phir (x) conj(re)        yhat = L BT R
//   u = w / conj(y_true),   G = -conj(L)^T (conj(R) * y1h * u)
//   power step: Y <- BT^H BT Y backward, BT BT^H Y forward; NS on X^H X
//   split: backward B = BT Q, core = Qm^H; forward B = Q^H BT, core = Qm
//   env advance on the stored environment (no conj), through conj(Qm)
//   backward and Qm forward.
// Energies, norms, the cutoff mask and the log-scales are real.
//
// Every device function takes a team, the threads that share one bond:
// BlockTeam, one thread block (the kernels of one block: the references
// K12m, K1, K2, K1a, K1b, K2-split, K2-env and K1-tail, and each row tile
// of the row-tile K2-env), ClusterTeam, every block of a thread-block
// cluster (the cluster K12m, K1a, K1, K1b, K2, K2-split, K12c and K12cr),
// or GridTeam, every block of a cooperative grid (the grid K1-tail).  A
// thread's index in the team is rank * blockDim.x + threadIdx.x, loops
// stride over the team's threads, and team.sync() separates the phases
// (__syncthreads(), the cluster barrier or the grid barrier).
// The arithmetic of every output does not depend on the team:
//   * each product output is one thread's sequential chain over k = 0..Kd-1
//     (no split-K), by one-element-per-thread loads (BlockTeam) or from
//     shared-memory tiles with a register micro-tile (ClusterTeam, gemm_tiles);
//   * each team-wide sum keeps kParts partials: partial t is the ordered sum
//     over the elements e = t (mod kParts), computed by the team's thread t,
//     and one fixed tree combines them (block_sum);
//   * each epilogue is one expression in one function (gemm_out).
// So a cluster or a grid of any size computes the one-block kernels' bits,
// and so does a row tile of K2-env, whose rows share nothing.  The host
// launchers at the end need <cuda_runtime.h>, included first by the .cu
// sources.
#pragma once

#include <cooperative_groups.h>

namespace mpst {

constexpr int kMaxThreads = 512;
constexpr int kParts = kMaxThreads;          // partials of a team-wide sum
constexpr float kTiny = 1.17549435e-38f;     // FLT_MIN (finfo(float32).tiny)
constexpr float kNsA = 3.4445f, kNsB = -4.7750f, kNsC = 2.0315f;
constexpr int kNsQuintic = 8, kNsCubic = 6;
constexpr float kNsRevive = 1e-3f;
constexpr int kTriNewton = 8;                // pallas_bond_c.py:325
static_assert(kTriNewton % 2 == 0, "tri_newton leaves X in its input buffer");
// Dynamic shared memory K12cr may take for its [K, K] rotation buffers (of
// the 227 KB a block can address; the rest is static reduction scratch).
constexpr long kMaxDynSmem = 200L * 1024;

// ---- scalar types -----------------------------------------------------------

// complex64 as torch lays it out: interleaved (re, im) float pairs.
struct __align__(8) cfloat {
  float x, y;
};

template <class T>
struct IsComplex {
  static constexpr bool value = false;
};
template <>
struct IsComplex<cfloat> {
  static constexpr bool value = true;
};

__host__ __device__ inline cfloat operator+(cfloat a, cfloat b) {
  return {a.x + b.x, a.y + b.y};
}
__host__ __device__ inline cfloat operator-(cfloat a, cfloat b) {
  return {a.x - b.x, a.y - b.y};
}
__host__ __device__ inline cfloat operator-(cfloat a) { return {-a.x, -a.y}; }
__host__ __device__ inline cfloat operator*(cfloat a, cfloat b) {
  return {a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x};
}
__host__ __device__ inline cfloat operator*(float s, cfloat a) {
  return {s * a.x, s * a.y};
}
__host__ __device__ inline cfloat operator*(cfloat a, float s) {
  return {a.x * s, a.y * s};
}
__host__ __device__ inline cfloat operator/(cfloat a, float s) {
  return {a.x / s, a.y / s};
}
__host__ __device__ inline cfloat& operator+=(cfloat& a, cfloat b) {
  a = a + b;
  return a;
}
__host__ __device__ inline cfloat& operator*=(cfloat& a, float s) {
  a = a * s;
  return a;
}
__host__ __device__ inline cfloat& operator/=(cfloat& a, float s) {
  a = a / s;
  return a;
}

__device__ inline float conj(float a) { return a; }
__device__ inline cfloat conj(cfloat a) { return {a.x, -a.y}; }

__device__ inline float real_part(float a) { return a; }
__device__ inline float real_part(cfloat a) { return a.x; }

template <class T>
__device__ inline T from_real(float v) {
  return v;
}
template <>
__device__ inline cfloat from_real<cfloat>(float v) {
  return {v, 0.f};
}

template <bool C, class T>
__device__ inline T cj(T a) {
  return C ? conj(a) : a;
}

// acc + a * b
__device__ inline float mac(float a, float b, float acc) {
  return fmaf(a, b, acc);
}
__device__ inline cfloat mac(cfloat a, cfloat b, cfloat acc) {
  return {fmaf(-a.y, b.y, fmaf(a.x, b.x, acc.x)),
          fmaf(a.y, b.x, fmaf(a.x, b.y, acc.y))};
}

// s + |v|^2
__device__ inline float abs2_add(float v, float s) { return fmaf(v, v, s); }
__device__ inline float abs2_add(cfloat v, float s) {
  return fmaf(v.y, v.y, fmaf(v.x, v.x, s));
}

// The KLD weight u = w / conj(y_true) (= w * y_true / |y_true|^2).
__device__ inline float kld_u(float w, float yt) { return w / yt; }
__device__ inline cfloat kld_u(float w, cfloat yt) {
  return yt * (w / abs2_add(yt, 0.f));
}

// ---- operands and workspace -------------------------------------------------

template <class T>
struct K12Args {
  const T* lhs;
  const T* center0;
  const T* envx;
  const T* env0;
  const float* ls0;
  const float* opp_ls;     // [N] opposite-side log-scales (MSE only; null
                           // when ls0 already holds the total, as in K1)
  const T* phil;
  const T* phir;
  const float* y1h;
  const float* w;
  const T* v0;
  T* center_out;           // [C, chi, d, chi]
  T* core_out;             // [Bb, chi, d, chi]
  T* env_out;              // [Bb, N, chi]
  float* ls_out;           // [Bb, N]
  T* q_out;                // [Bb, chi*d, chi]
  float* ws;               // workspace_floats<T>(C, chi, d, N)
  int Bb, C, chi, d, N;
  int forward, refresh, q_iters, mse, gd;
  int qr;                  // power step for an outside QR: column
                           // normalisation only, no revival, no polar
  int tri;                 // power step of K12cr: column normalisation,
                           // then tri_newton (no revival)
  int upto;                // K2's parts to run, 1-3 (0: all four), so that
                           // the parts can be timed by prefixes
  float eta, cutoff, max_rank;
};

// Global scratch, carved from one workspace: the bond tensor and its
// gradient (2 x C*P*P), batch products, power-step and Newton-Schulz
// buffers of T, then the real per-direction vectors.  It stays resident in
// L2 between the phases of a bond.
template <class T>
__host__ __device__ inline long workspace_floats(int C, int chi, int d,
                                                 int N) {
  const long P = (long)chi * d, K = chi;
  const long s = sizeof(T) / sizeof(float);
  return s * (2 * C * P * P          // BT, G
              + (long)C * N * P      // T1 / U
              + 2L * N * P           // L, R
              + 2L * N * C           // yhat, wc
              + (long)C * P * K      // MV / projected blocks
              + 3 * P * K            // Ya, Yb, Yc
              + 3 * K * K)           // Gm, G2, Mq
         + 3 * K                     // wv, mask, nrm
         + kParts;                   // a cluster's sum partials
}

template <class T>
struct Work {
  T *BT, *G, *T1, *L, *R, *yhat, *wc, *MV, *Ya, *Yb, *Yc, *Gm, *G2, *Mq;
  float *wv, *mask, *nrm, *parts;
};

template <class T>
__device__ inline Work<T> carve(float* wsf, int C, int chi, int d, int N) {
  const long P = (long)chi * d, K = chi;
  T* ws = reinterpret_cast<T*>(wsf);
  Work<T> w;
  w.BT = ws;            ws += C * P * P;
  w.G = ws;             ws += C * P * P;
  w.T1 = ws;            ws += (long)C * N * P;
  w.L = ws;             ws += (long)N * P;
  w.R = ws;             ws += (long)N * P;
  w.yhat = ws;          ws += (long)N * C;
  w.wc = ws;            ws += (long)N * C;
  w.MV = ws;            ws += (long)C * P * K;
  w.Ya = ws;            ws += P * K;
  w.Yb = ws;            ws += P * K;
  w.Yc = ws;            ws += P * K;
  w.Gm = ws;            ws += K * K;
  w.G2 = ws;            ws += K * K;
  w.Mq = ws;            ws += K * K;
  float* f = reinterpret_cast<float*>(ws);
  w.wv = f;             f += K;
  w.mask = f;           f += K;
  w.nrm = f;            f += K;
  w.parts = f;
  return w;
}

// A strided matrix view: element (b, r, c) at p[b*sb + r*sr + c*sc].
template <class T>
struct View {
  const T* p;
  long sb, sr, sc;
};

template <class T>
__device__ inline View<T> vw(const T* p, long sb, long sr, long sc) {
  return View<T>{p, sb, sr, sc};
}

// ---- teams ------------------------------------------------------------------

// One thread block.
struct BlockTeam {
  static constexpr bool kCluster = false;
  __device__ int tid() const { return threadIdx.x; }
  __device__ int size() const { return blockDim.x; }
  __device__ void sync() const { __syncthreads(); }
  // a sum's partials: every thread holds one (blockDim.x == kParts)
  __device__ bool holds_part() const { return true; }
  __device__ int part_stride() const { return blockDim.x; }
};

// Every block of a multi-block team, kMaxThreads threads each, separated
// by Sync's barrier.  parts is the workspace's [kParts] floats, stage the
// block's dynamic shared memory (gemm_tiles' tiles, team_update's buffers;
// the leader's, leader_tail).  Nothing is shared
// between the blocks but global memory read through L2, so the team's
// products and sums do not depend on which barrier joins the blocks.
template <class Sync>
struct MultiTeam {
  static constexpr bool kCluster = true;     // several blocks
  int rank, ctas;
  float* parts;
  void* stage;
  __device__ int tid() const { return rank * blockDim.x + threadIdx.x; }
  __device__ int size() const { return ctas * blockDim.x; }
  __device__ void sync() const { Sync::sync(); }
  // a sum's partials: the team's threads t < kParts hold one each
  __device__ bool holds_part() const { return tid() < kParts; }
  __device__ int part_stride() const { return kParts; }
};

struct ClusterSync {
  __device__ static void sync() { cooperative_groups::this_cluster().sync(); }
};

// The whole grid of a cooperative launch (every block co-resident).
struct GridSync {
  __device__ static void sync() { cooperative_groups::this_grid().sync(); }
};

// Every block of a thread-block cluster (at most 16 on Hopper).
using ClusterTeam = MultiTeam<ClusterSync>;
// Every block of a cooperative grid: as many as the card holds at once.
using GridTeam = MultiTeam<GridSync>;

__device__ inline ClusterTeam cluster_team(float* parts, void* stage) {
  const cooperative_groups::cluster_group c =
      cooperative_groups::this_cluster();
  return ClusterTeam{(int)c.block_rank(), (int)c.num_blocks(), parts, stage};
}

__device__ inline GridTeam grid_team(float* parts, void* stage) {
  return GridTeam{(int)blockIdx.x, (int)gridDim.x, parts, stage};
}

// A load through L2 only: what another block of the cluster wrote in an
// earlier phase is read past this SM's L1.
__device__ inline float ldcg(const float* p) { return __ldcg(p); }
__device__ inline cfloat ldcg(const cfloat* p) {
  const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
  return {v.x, v.y};
}

// ---- products and sums ------------------------------------------------------

// The elementwise steps of the power step's tail, one expression each, which
// the team's phases and the leader block (leader_tail) share.
// A column's norm from its sum of |y|^2.
__device__ inline float col_norm(float s) { return fmaxf(sqrtf(s), kTiny); }

// The revived column-normalised iterate Y / ||col|| + eps * Yprev.
template <class T>
__device__ inline T ns_revive(T y, float nrm, T yprev) {
  return y / nrm + kNsRevive * yprev;
}

// The pre-scale 1 / (||X||_F (1 + 1e-3)) from the sum of |X|^2.
__device__ inline float ns_prescale(float sum) {
  const float grow = 1.f + 1e-3f;
  return 1.f / sqrtf(fmaxf(sum * (grow * grow), kTiny));
}

// The quintic step's Mq = b G + c G^2.
template <class T>
__device__ inline T ns_mix(T g, T g2) {
  return kNsB * g + kNsC * g2;
}

// A product output: alpha * acc + beta * src[o] (src may be out itself), the
// one expression both gemm forms contract.
template <class T>
__device__ inline T gemm_out(T acc, float alpha, float beta, const T* src,
                             long o) {
  return (src != nullptr) ? alpha * acc + beta * src[o] : alpha * acc;
}

// The quintic's Mq[o] = b Gm[o] + c (Gm Gm)[o] formed in the epilogue of
// Gm Gm (src = Gm): ns_mix of gemm_out's G2, as if G2 were stored first.
template <class T>
__device__ inline T mix_out(T acc, const T* src, long o) {
  return ns_mix(src[o], gemm_out(acc, 1.f, 0.f, (const T*)nullptr, o));
}

// out[b, m, n] = alpha * sum_k A[b, m, k] * B[b, k, n] + beta * src[b, m, n]
// (src shares out's strides and may be out itself), with A conjugated when
// CA and B when CB.  One block: one output element per thread, n fastest,
// so a warp reads B along n and broadcasts A.
template <bool CA = false, bool CB = false, bool MIX = false, class T>
__device__ inline void gemm(BlockTeam, int batch, int M, int Nc, int Kd,
                            View<T> A, View<T> B, T* out, long ob, long orow,
                            long ocol, float alpha = 1.f, float beta = 0.f,
                            const T* src = nullptr) {
  const int total = batch * M * Nc;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int n = e % Nc;
    const int t = e / Nc;
    const int m = t % M;
    const int b = t / M;
    const T* a = A.p + b * A.sb + m * A.sr;
    const T* bb = B.p + b * B.sb + n * B.sc;
    T acc{};
    for (int k = 0; k < Kd; ++k)
      acc = mac(cj<CA>(a[k * A.sc]), cj<CB>(bb[k * B.sr]), acc);
    const long o = b * ob + m * orow + n * ocol;
    if constexpr (MIX)
      out[o] = mix_out(acc, src, o);
    else
      out[o] = gemm_out(acc, alpha, beta, src, o);
  }
}

// K-chunk of a staged tile.
constexpr int kBK = 64;

// The shared memory gemm_tiles<2, 2> stages: A [kBK, 32 + 1] and B [kBK,
// 64 + 1] (a padded row each against bank conflicts).
template <class T>
__host__ __device__ inline long stage_smem_bytes() {
  return (long)kBK * (32 + 1 + 64 + 1) * (long)sizeof(T);
}

// The multi-block team's gemm (a cluster's or a cooperative grid's):
// output tiles of (16 TM) x (32 TN) dealt to the blocks
// in turn; each block stages the tile's A and B K-chunks in shared memory
// (conjugated as they land, through L2) and each of its 16 x 32 threads
// keeps a TM x TN register micro-tile, rows ty + 16 i and columns tx + 32 j,
// so a shared load feeds TM or TN multiply-adds.  A thread loads its share
// of the next chunk into registers while the block computes this one, all
// its loads in flight at once.  Each output is still one chain over
// k = 0..Kd-1 in order, with gemm's mac.  Needs blockDim.x == kMaxThreads.
template <int TM, int TN, bool CA, bool CB, bool MIX, class S, class T>
__device__ inline void gemm_tiles(const MultiTeam<S>& tm, int batch, int M,
                                  int Nc, int Kd, View<T> A, View<T> B,
                                  T* out, long ob, long orow, long ocol,
                                  float alpha, float beta, const T* src) {
  constexpr int BM = 16 * TM, BN = 32 * TN, LA = BM + 1, LB = BN + 1;
  constexpr int NA = BM * kBK / kMaxThreads, NB = BN * kBK / kMaxThreads;
  static_assert(NA * kMaxThreads == BM * kBK && NB * kMaxThreads == BN * kBK,
                "a chunk is a whole number of loads a thread");
  T* As = static_cast<T*>(tm.stage);      // [kBK, LA]: As[k * LA + m]
  T* Bs = As + kBK * LA;                  // [kBK, LB]: Bs[k * LB + n]
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int mt = (M + BM - 1) / BM, nt = (Nc + BN - 1) / BN;
  // stage along the operand's unit stride, so a warp's loads coalesce
  const bool a_m_fast = A.sc != 1 && A.sr == 1;
  const bool b_k_fast = B.sc != 1 && B.sr == 1;
  for (int tile = tm.rank; tile < batch * mt * nt; tile += tm.ctas) {
    const int b = tile / (mt * nt), r = tile % (mt * nt);
    const int m0 = (r / nt) * BM, n0 = (r % nt) * BN;
    const T* Ab = A.p + b * A.sb;
    const T* Bb = B.p + b * B.sb;
    T ra[NA], rb[NB];
    // this thread's elements of the chunk from k0 into ra, rb
    auto load = [&](int k0) {
      const int kc = min(kBK, Kd - k0);
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int e = i * kMaxThreads + threadIdx.x;
        const int m = a_m_fast ? e % BM : e / kBK;
        const int k = a_m_fast ? e / BM : e % kBK;
        ra[i] = (m0 + m < M && k < kc)
                    ? cj<CA>(ldcg(Ab + (m0 + m) * A.sr + (k0 + k) * A.sc))
                    : T{};
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int e = i * kMaxThreads + threadIdx.x;
        const int n = b_k_fast ? e / kBK : e % BN;
        const int k = b_k_fast ? e % kBK : e / BN;
        rb[i] = (n0 + n < Nc && k < kc)
                    ? cj<CB>(ldcg(Bb + (k0 + k) * B.sr + (n0 + n) * B.sc))
                    : T{};
      }
    };
    T acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = T{};
    load(0);
    for (int k0 = 0; k0 < Kd; k0 += kBK) {
      const int kc = min(kBK, Kd - k0);
      __syncthreads();                    // the last chunk's reads are done
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int e = i * kMaxThreads + threadIdx.x;
        As[(a_m_fast ? e / BM : e % kBK) * LA + (a_m_fast ? e % BM : e / kBK)]
            = ra[i];
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int e = i * kMaxThreads + threadIdx.x;
        Bs[(b_k_fast ? e % kBK : e / BN) * LB + (b_k_fast ? e / kBK : e % BN)]
            = rb[i];
      }
      __syncthreads();
      if (k0 + kBK < Kd) load(k0 + kBK);
      for (int kk = 0; kk < kc; ++kk) {
        T av[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = As[kk * LA + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = Bs[kk * LB + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = mac(av[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx + 32 * j;
        if (m < M && n < Nc) {
          const long o = b * ob + m * orow + n * ocol;
          if constexpr (MIX)
            out[o] = mix_out(acc[i][j], src, o);
          else
            out[o] = gemm_out(acc[i][j], alpha, beta, src, o);
        }
      }
    }
  }
}

// The multi-block gemm: 32 x 64 tiles (2 x 2 micro-tiles) when there are
// at least as many of them as blocks, else 16 x 32 (1 x 1), which spreads a
// small product over more blocks.  Both give every output the same bits.
template <bool CA = false, bool CB = false, bool MIX = false, class S,
          class T>
__device__ inline void gemm(const MultiTeam<S>& tm, int batch, int M, int Nc,
                            int Kd, View<T> A, View<T> B, T* out, long ob,
                            long orow, long ocol, float alpha = 1.f,
                            float beta = 0.f, const T* src = nullptr) {
  const long tiles = (long)batch * ((M + 31) / 32) * ((Nc + 63) / 64);
  if (tiles >= tm.ctas)
    gemm_tiles<2, 2, CA, CB, MIX>(tm, batch, M, Nc, Kd, A, B, out, ob, orow,
                                  ocol, alpha, beta, src);
  else
    gemm_tiles<1, 1, CA, CB, MIX>(tm, batch, M, Nc, Kd, A, B, out, ob, orow,
                                  ocol, alpha, beta, src);
}

// Deterministic block-wide sum: v is partial threadIdx.x of blockDim.x ==
// kParts, combined by a fixed tree.
__device__ inline float block_sum(BlockTeam, float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

// The same sum over a cluster or a grid: the team's threads t < kParts
// hold the partials; every block gathers all kParts of them and runs the
// same tree on its own copy, so every block gets the same bits.
template <class S>
__device__ inline float block_sum(const MultiTeam<S>& tm, float v,
                                  float* red) {
  if (tm.holds_part()) tm.parts[tm.tid()] = v;
  tm.sync();
  for (int i = threadIdx.x; i < kParts; i += blockDim.x)
    red[i] = ldcg(tm.parts + i);
  __syncthreads();
  for (int s = kParts / 2; s > 0; s >>= 1) {
    for (int i = threadIdx.x; i < s; i += blockDim.x) red[i] += red[i + s];
    __syncthreads();
  }
  const float r = red[0];
  tm.sync();                              // parts and red free again
  return r;
}

// Block-wide maximum, the same tree.
__device__ inline float block_max(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s)
      red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

// ---- K1 body: kron factors, bond tensor, yhat, gradient, step --------------

// L[n, a*d+i] = conj(le[n,a]) phil[n,i];  R[n, k*chi+b] = phir[n,k] conj(re[n,b]).
template <class Tm, class T>
__device__ inline void kron_factors(const Tm& tm, const T* le, const T* re,
                                    const T* phil, const T* phir, Work<T> w,
                                    int chi, int d, int N) {
  const int P = chi * d;
  for (int e = tm.tid(); e < N * P; e += tm.size()) {
    const int n = e / P, p = e % P;
    w.L[e] = conj(le[n * chi + p / d]) * phil[n * d + p % d];
    w.R[e] = phir[n * d + p / chi] * conj(re[n * chi + p % chi]);
  }
}

// BT[c] = X_c @ Y_c: backward X = core [P, chi], Y_c = center[c] [chi, P];
// forward X_c = center[c] [P, chi], Y = core [chi, P].
template <class Tm, class T>
__device__ inline void bond_tensor(const Tm& tm, const T* core,
                                   const T* center, Work<T> w, int C, int chi,
                                   int d, bool forward) {
  const long P = (long)chi * d;
  View<T> X = forward ? vw(center, P * chi, chi, 1) : vw(core, 0, chi, 1);
  View<T> Y = forward ? vw(core, 0, P, 1) : vw(center, chi * P, P, 1);
  gemm(tm, C, P, P, chi, X, Y, w.BT, P * P, P, 1);
}

// yhat, the loss weights and the loss gradient of the batch into w.G (the
// KLD sign folded in: w.G is the gradient itself, as K1a emits it).
template <class Tm, class T>
__device__ inline void k1_grad(const Tm& tm, const K12Args<T>& a,
                               const float* ls, Work<T> w) {
  const int C = a.C, N = a.N;
  const long P = (long)a.chi * a.d, PP = P * P;
  // T1[c, n, q] = sum_p L[n,p] BT[c,p,q]
  gemm(tm, C, N, P, P, vw(w.L, 0, P, 1), vw(w.BT, PP, P, 1), w.T1, N * P, P,
       1);
  tm.sync();
  // yhat[n, c] = sum_q T1[c,n,q] R[n,q]
  for (int e = tm.tid(); e < N * C; e += tm.size()) {
    const int n = e / C, c = e % C;
    const T* t = w.T1 + (c * (long)N + n) * P;
    const T* r = w.R + n * P;
    T acc{};
    for (int q = 0; q < P; ++q) acc = mac(t[q], r[q], acc);
    w.yhat[e] = acc;
  }
  tm.sync();
  // per-sample, per-class weights (the KLD sign folded in)
  for (int n = tm.tid(); n < N; n += tm.size()) {
    const float* y1 = a.y1h + n * C;
    const T* yh = w.yhat + n * C;
    if (!a.mse) {
      T yt{};
      for (int c = 0; c < C; ++c) yt += yh[c] * y1[c];
      const T u = kld_u(a.w[n], yt);
      for (int c = 0; c < C; ++c) w.wc[n * C + c] = -(y1[c] * u);
    } else if constexpr (!IsComplex<T>::value) {
      // the complex kernels take KLD only (their launchers pass mse = 0)
      const float s = expf(a.opp_ls ? ls[n] + a.opp_ls[n] : ls[n]);
      const float ws = a.w[n] * s;
      for (int c = 0; c < C; ++c) w.wc[n * C + c] = (yh[c] * s - y1[c]) * ws;
    }
  }
  tm.sync();
  // U[c, n, q] = conj(R[n,q]) wc[n,c]  (into T1)
  for (int e = tm.tid(); e < C * N * P; e += tm.size()) {
    const int q = e % P, n = (e / P) % N, c = e / (P * N);
    w.T1[e] = conj(w.R[n * P + q]) * w.wc[n * C + c];
  }
  tm.sync();
  // G[c, p, q] = sum_n conj(L[n,p]) U[c,n,q]
  gemm<true>(tm, C, P, P, N, vw(w.L, 0, 1, P), vw(w.T1, N * P, P, 1), w.G, PP,
             P, 1);
  tm.sync();
}

// The optimiser step on w.BT against the gradient w.G (TSGO: normalised by
// the norm of the whole w.G, the reduced gradient in K1b), then
// post-normalisation; BT leaves updated in place.  A cluster steps every
// element, then sums the kParts partials of the stepped values.
template <class Tm, class T>
__device__ inline void k1_step(const Tm& tm, const K12Args<T>& a, Work<T> w,
                               float* red) {
  const long P = (long)a.chi * a.d, PP = P * P;
  const long n = a.C * PP;
  float step = a.eta;
  if (!a.gd) {                       // TSGO: normalised-gradient step
    float part = 0.f;
    for (long e = tm.tid(); tm.holds_part() && e < n; e += tm.part_stride())
      part = abs2_add(w.G[e], part);
    step = a.eta / sqrtf(fmaxf(block_sum(tm, part, red), kTiny));
  }
  float part = 0.f;
  if constexpr (Tm::kCluster) {
    for (long e = tm.tid(); e < n; e += tm.size())
      w.BT[e] = w.BT[e] - step * w.G[e];
    tm.sync();
    for (long e = tm.tid(); tm.holds_part() && e < n; e += tm.part_stride())
      part = abs2_add(w.BT[e], part);
  } else {
    for (long e = tm.tid(); e < n; e += tm.size()) {
      const T v = w.BT[e] - step * w.G[e];
      w.BT[e] = v;
      part = abs2_add(v, part);
    }
  }
  const float bn = 1.f / sqrtf(fmaxf(block_sum(tm, part, red), kTiny));
  for (long e = tm.tid(); e < n; e += tm.size()) w.BT[e] *= bn;
  tm.sync();
}

// The gradient of the whole batch and the step on it (K1, K12, K12cr).
template <class Tm, class T>
__device__ inline void k1_update(const Tm& tm, const K12Args<T>& a,
                                 const float* ls, Work<T> w, float* red) {
  k1_grad(tm, a, ls, w);
  k1_step(tm, a, w, red);
}

// ---- warm power step with Newton-Schulz polar ------------------------------

// Whether an NS step's update fits team_update's buffers: Gm, Mq and the
// block's rows of X, in the gemm tiles' shared memory.
template <class T>
__device__ inline bool team_update_fits(int P, int K, int ctas) {
  const long rows = (P + ctas - 1) / ctas;
  return (2L * K * K + rows * K) * (long)sizeof(T) <= stage_smem_bytes<T>();
}

// The update of an NS step on a multi-block team in one phase: every block
// stages Gm (the last phase's) in its shared memory, forms Mq = b Gm + c
// Gm Gm there itself (quintic), and computes its rows p = rank + ctas r of
// X' = a X + X Mq (quintic) or 1.5 X - 0.5 X Gm (cubic) from them, so the
// step takes two team phases, not three.  Each output is still one chain
// over k in order with mac and mix_out's or gemm_out's epilogue, whichever
// thread computes it.
template <class S, class T>
__device__ inline void team_update(const MultiTeam<S>& tm, const T* x, T* xn,
                                   const T* gram, int P, int K,
                                   bool quintic) {
  T* g = static_cast<T*>(tm.stage);       // Gm [K, K]
  T* mq = g + K * K;                      // Mq [K, K]
  T* xr = mq + K * K;                     // this block's rows of X [rows, K]
  const int rows = (P - tm.rank + tm.ctas - 1) / tm.ctas;
  for (int e = threadIdx.x; e < K * K; e += blockDim.x) g[e] = ldcg(gram + e);
  for (int e = threadIdx.x; e < rows * K; e += blockDim.x)
    xr[e] = ldcg(x + (long)(tm.rank + tm.ctas * (e / K)) * K + e % K);
  __syncthreads();
  if (quintic) {
    for (int e = threadIdx.x; e < K * K; e += blockDim.x) {
      const int i = e / K, j = e % K;
      T acc{};
      for (int k = 0; k < K; ++k) acc = mac(g[i * K + k], g[k * K + j], acc);
      mq[e] = mix_out(acc, g, e);
    }
    __syncthreads();
  }
  const T* m = quintic ? mq : g;
  for (int e = threadIdx.x; e < rows * K; e += blockDim.x) {
    const int r = e / K, n = e % K;
    T acc{};
    for (int k = 0; k < K; ++k) acc = mac(xr[r * K + k], m[k * K + n], acc);
    const long o = (long)(tm.rank + tm.ctas * r) * K + n;
    if (quintic)
      xn[o] = gemm_out(acc, 1.f, kNsA, xr, e);
    else
      xn[o] = gemm_out(acc, -0.5f, 1.5f, xr, e);
  }
}

// out <- polar(X) by 8 quintic + 6 cubic Newton-Schulz steps; X is the
// pre-scaled input in *x, *xn is scratch, the last step writes out.
template <class Tm, class T>
__device__ inline void ns_polar(const Tm& tm, T* x, T* xn, T* out, Work<T> w,
                                int P, int K) {
  for (int it = 0; it < kNsQuintic + kNsCubic; ++it) {
    const bool quintic = it < kNsQuintic;
    if (it == kNsQuintic + kNsCubic - 1) xn = out;
    // Gm = X^H X
    gemm<true>(tm, 1, K, K, P, vw(x, 0, 1, K), vw(x, 0, K, 1), w.Gm, 0, K, 1);
    tm.sync();
    if constexpr (Tm::kCluster) {
      if (team_update_fits<T>(P, K, tm.ctas)) {
        team_update(tm, x, xn, w.Gm, P, K, quintic);
        tm.sync();
        T* t = x; x = xn; xn = t;
        continue;
      }
    }
    if (quintic) {
      // Mq = b G + c G^2, in the epilogue of G^2
      gemm<false, false, true>(tm, 1, K, K, K, vw(w.Gm, 0, K, 1),
                               vw(w.Gm, 0, K, 1), w.Mq, 0, K, 1, 1.f, 0.f,
                               w.Gm);
      tm.sync();
      // X' = a X + X (b G + c G^2)
      gemm(tm, 1, P, K, K, vw(x, 0, K, 1), vw(w.Mq, 0, K, 1), xn, 0, K, 1,
           1.f, kNsA, x);
    } else {
      // X' = 1.5 X - 0.5 X G
      gemm(tm, 1, P, K, K, vw(x, 0, K, 1), vw(w.Gm, 0, K, 1), xn, 0, K, 1,
           -0.5f, 1.5f, x);
    }
    tm.sync();
    T* t = x; x = xn; xn = t;
  }
}

// ---- the power step's tail on the leader block ---------------------------
// Under a multi-block team each phase of the tail after the power step's two
// products (the column norms, the revival and its sum, the pre-scale, the
// fourteen Newton-Schulz steps: ~40 phases) ends in a team barrier, though
// it works on one [P, K] iterate and [K, K] Gram matrices.  In real
// arithmetic, where these fit in a block's dynamic shared memory
// (polar_in_block), block rank 0 alone runs the whole tail there between
// __syncthreads() and the team waits at one barrier.  Each output keeps the
// team's arithmetic: one thread's chain over k = 0..Kd-1 in order with mac,
// gemm_out's and mix_out's epilogues, the elementwise expressions above, and
// the revival's kParts partials combined by block_sum's tree (the leader's
// kMaxThreads == kParts threads hold one each, as the team's threads
// t < kParts do).  So the kernels that take it compute the bits of the team
// and of the one-block kernels.
//
// One SM does the work of sixteen here, so the products are built for its
// shared-memory port, which delivers about 128 bytes a cycle: every operand
// is stored with its chain index k contiguous (X [P, K] for X' = X M, its
// transpose X^T [K, P] for Gm = X^T X, Mq transposed), each thread reads 16
// bytes of a row a load into a register micro-tile, and rows are padded to
// an odd number of 16-byte vectors, so that the lanes of a quarter-warp
// reading eight rows hit distinct banks.  Complex bonds keep the team: there
// a tail is four times the multiply-adds, and one SM took longer for them
// (116-125 us a power step at chi 25) than the team's phases.

// A row of n floats padded to an odd number of 16-byte vectors.
__host__ __device__ inline int polar_ld(int n) {
  return 4 * ((n + 3) / 4 | 1);
}

// The leader's buffers: X and X' [P, K], X^T and X'^T [K, P], Gm and Mq^T
// [K, K], in padded rows of floats.  Real Gm = X^T X is symmetric bit for
// bit (each output's chain of fmaf(X[p][m], X[p][n], acc) is its mirror's,
// fmaf(a, b, c) == fmaf(b, a, c)), so it is its own transpose.
__host__ __device__ inline long polar_smem_bytes(int chi, int d) {
  const long P = (long)chi * d, lk = polar_ld(chi), lp = polar_ld(P);
  return (2 * P * lk + 2L * chi * lp + 2L * chi * lk) * (long)sizeof(float);
}

// The leader's budget: one SM's tail beat the team's phases up to real
// chi 40 at d 5 (150 KB of buffers) and lost from chi 44 (170 KB), where
// its Gram products grow as chi^2 chi d on one SM.
constexpr long kPolarSmem = 160L * 1024;

// Whether a Newton-Schulz power step's tail runs on the leader block
// (ops/bond_kernels.py's polar_path mirrors it).
template <class T>
__host__ __device__ inline bool polar_in_block(int chi, int d) {
  return !IsComplex<T>::value && polar_smem_bytes(chi, d) <= kPolarSmem;
}

// The four floats at p (16-byte aligned) into v.
__device__ __forceinline__ void lds16(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// A thread's tile of a product's grid of tiles: its index (tm, tn) and
// whether it has one.  A grid deals tile t to thread t mod blockDim.x.
struct Tile {
  int tm, tn;
  bool live;
};

// Tile t of a gm x gn grid (t = tm gn + tn).
__device__ inline Tile grid_tile(int t, int gm, int gn) {
  return Tile{t / gn, t % gn, t < gm * gn};
}

// Tile t of the g (g + 1) / 2 tiles tm <= tn of a symmetric g x g grid
// (t = tn (tn + 1) / 2 + tm).
__device__ inline Tile tri_tile(int t, int g) {
  int tn = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((tn + 1) * (tn + 2) / 2 <= t) ++tn;
  while (tn * (tn + 1) / 2 > t) --tn;
  return Tile{t - tn * (tn + 1) / 2, tn, t < g * (g + 1) / 2};
}

// One block's product in shared memory: epi(m, n, acc) with acc = sum_k
// a_m[k] b_n[k] over M x Nc outputs, a_m = A + m lda and b_n = B + n ldb
// rows contiguous in k.  Thread t keeps a TM x TN register micro-tile, rows
// tm + gm i and columns tn + gn j (gm, gn the tiles down and across; own the
// thread's first tile, computed once by the caller), and reads its rows 16
// bytes at a time; each output is one chain over k = 0..Kd-1 in order with
// mac.  A tile past the edge repeats the last row or column: it computes
// that output's bits again and stores them again, so the epilogue needs no
// branch.  With SYM (a product symmetric bit for bit, M == Nc, TM == TN:
// Gm = X^T X) only the tiles tm <= tn run, each output stored at (m, n) and
// (n, m).
template <int TM, int TN, bool SYM, class Epi>
__device__ __forceinline__ void row_gemm(Tile own, int M, int Nc, int Kd,
                                         const float* A, int lda,
                                         const float* B, int ldb, Epi epi) {
  static_assert(!SYM || TM == TN, "a symmetric grid has square tiles");
  const int gm = (M + TM - 1) / TM, gn = (Nc + TN - 1) / TN;
  const int kv = Kd - Kd % 4;
  for (int t = threadIdx.x;; t += blockDim.x) {
    const Tile tl = t == (int)threadIdx.x ? own
                    : SYM                 ? tri_tile(t, gm)
                                          : grid_tile(t, gm, gn);
    if (!tl.live) break;
    int mi[TM], nj[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) mi[i] = min(tl.tm + gm * i, M - 1);
#pragma unroll
    for (int j = 0; j < TN; ++j) nj[j] = min(tl.tn + gn * j, Nc - 1);
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int k = 0; k < kv; k += 4) {
      float av[TM][4], bv[TN][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) lds16(A + mi[i] * lda + k, av[i]);
#pragma unroll
      for (int j = 0; j < TN; ++j) lds16(B + nj[j] * ldb + k, bv[j]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = mac(av[i][u], bv[j][u], acc[i][j]);
    }
    for (int k = kv; k < Kd; ++k) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = mac(A[mi[i] * lda + k], B[nj[j] * ldb + k], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        epi(mi[i], nj[j], acc[i][j]);
        if (SYM) epi(nj[j], mi[i], acc[i][j]);
      }
  }
}

// Micro-tiles of the leader's products, from their times on the card at
// chi 25 (2 x 2 on the Gram products, 4 x 4 on X' of 2 x 2 to 5 x 5): a
// product's time is about its threads' loaded bytes, (TM + TN) Kd 4 a
// thread, over the port's 128 a cycle, while enough warps are left to issue
// the multiply-adds.
constexpr int kPolarG = 2, kPolarXm = 4, kPolarXn = 4;

// The tail of one Newton-Schulz power step on the leader block: the new
// iterate yb (the team's products) and yprev staged in its dynamic shared
// memory (polar_smem_bytes), then the column norms, the revival and its
// sum, the pre-scale and the polar (power_tail's and ns_polar's phases), the
// result into ya.  Not inlined, so that its registers do not crowd the
// kernels' own.
__device__ __noinline__ inline void leader_tail(int P, int K, const float* yb,
                                                const float* yprev, float* ya,
                                                float* red) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const int lk = polar_ld(K), lp = polar_ld(P);
  float* x = reinterpret_cast<float*>(dyn_smem);   // [P, lk]
  float* xn = x + P * lk;
  float* xt = xn + P * lk;                         // [K, lp]
  float* xnt = xt + K * lp;
  float* gm = xnt + K * lp;                        // [K, lk]
  float* mqt = gm + K * lk;
  for (int e = threadIdx.x; e < P * K; e += blockDim.x) {
    const int r = e / K, c = e % K;
    const float v = ldcg(yb + e);
    x[r * lk + c] = v;
    xt[c * lp + r] = v;
    xn[r * lk + c] = ldcg(yprev + e);
  }
  __syncthreads();
  float* nrm = gm;
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    const float* col = xt + j * lp;                // column j of the iterate
    float s = 0.f;
    int r = 0;
#pragma unroll 4
    for (; r + 4 <= P; r += 4) {
      float v[4];
      lds16(col + r, v);
#pragma unroll
      for (int u = 0; u < 4; ++u) s = abs2_add(v[u], s);
    }
    for (; r < P; ++r) s = abs2_add(col[r], s);
    nrm[j] = col_norm(s);
  }
  __syncthreads();
  // partial t: the elements e = t (mod kParts) of the [P, K] iterate, in
  // order
  float part = 0.f;
  for (int e = threadIdx.x; e < P * K; e += kParts) {
    const int r = e / K, c = e % K;
    const float v = ns_revive(x[r * lk + c], nrm[c], xn[r * lk + c]);
    x[r * lk + c] = v;
    part = abs2_add(v, part);
  }
  const float sc = ns_prescale(block_sum(BlockTeam{}, part, red));
  for (int e = threadIdx.x; e < P * K; e += blockDim.x) {
    const int r = e / K, c = e % K;
    float v = x[r * lk + c];
    v *= sc;
    x[r * lk + c] = v;
    xt[c * lp + r] = v;
  }
  __syncthreads();
  // each thread's first tile of the Gram grids and of the update's grid
  const int gg = (K + kPolarG - 1) / kPolarG;
  const Tile gram = grid_tile(threadIdx.x, gg, gg);
  const Tile gram_sym = tri_tile(threadIdx.x, gg);
  const Tile upd = grid_tile(threadIdx.x, (P + kPolarXm - 1) / kPolarXm,
                             (K + kPolarXn - 1) / kPolarXn);
  for (int it = 0; it < kNsQuintic + kNsCubic; ++it) {
    const float* xs = x;
    float* xo = xn;
    float* xot = xnt;
    // Gm = X^T X
    row_gemm<kPolarG, kPolarG, true>(
        gram_sym, K, K, P, xt, lp, xt, lp, [=](int m, int n, float acc) {
          gm[m * lk + n] = gemm_out(acc, 1.f, 0.f, (const float*)nullptr, 0);
        });
    __syncthreads();
    if (it < kNsQuintic) {
      // Mq = b Gm + c Gm Gm, stored transposed (row n of Gm is its column)
      row_gemm<kPolarG, kPolarG, false>(
          gram, K, K, K, gm, lk, gm, lk, [=](int m, int n, float acc) {
            mqt[n * lk + m] = mix_out(acc, gm, m * lk + n);
          });
      __syncthreads();
      // X' = a X + X Mq, and X'^T
      row_gemm<kPolarXm, kPolarXn, false>(
          upd, P, K, K, xs, lk, mqt, lk, [=](int m, int n, float acc) {
            const long o = m * lk + n;
            const float v = gemm_out(acc, 1.f, kNsA, xs, o);
            xo[o] = v;
            xot[n * lp + m] = v;
          });
    } else {
      // X' = 1.5 X - 0.5 X Gm, and X'^T
      row_gemm<kPolarXm, kPolarXn, false>(
          upd, P, K, K, xs, lk, gm, lk, [=](int m, int n, float acc) {
            const long o = m * lk + n;
            const float v = gemm_out(acc, -0.5f, 1.5f, xs, o);
            xo[o] = v;
            xot[n * lp + m] = v;
          });
    }
    __syncthreads();
    float* t = x; x = xn; xn = t;
    t = xt; xt = xnt; xnt = t;
  }
  for (int e = threadIdx.x; e < P * K; e += blockDim.x)
    ya[e] = x[(e / K) * lk + e % K];
}

// X <- the QR-gauge orthonormal basis of span(X) [P, K] by kTriNewton damped
// triangular-Newton steps X <- X (I - s (triu(E, 1) + diag(E)/2)) with
// E = X^H X - I and s = 1/max(1, ||E||_F) (pallas_bond_c.py:320-365): each
// correction is upper triangular, so the limit is the thin-QR Q of X with a
// positive real R diagonal.  xn is scratch [P, K], E and Tm scratch [K, K];
// the result is left in x.
template <class Tm, class T>
__device__ inline void tri_newton(const Tm& tm, T* x, T* xn, T* E, T* Tmat,
                                  int P, int K, float* red) {
  for (int it = 0; it < kTriNewton; ++it) {
    gemm<true>(tm, 1, K, K, P, vw(x, 0, 1, K), vw(x, 0, K, 1), E, 0, K, 1);
    tm.sync();
    // partial t's thread shifts the diagonal of its own elements
    float part = 0.f;
    for (int e = tm.tid(); tm.holds_part() && e < K * K;
         e += tm.part_stride()) {
      T v = E[e];
      if (e / K == e % K) v = v - from_real<T>(1.f);
      E[e] = v;
      part = abs2_add(v, part);
    }
    const float s = rsqrtf(fmaxf(block_sum(tm, part, red), 1.f));
    // diag(E) is real (hermitian), so Tm's diagonal is real
    for (int e = tm.tid(); e < K * K; e += tm.size()) {
      const int r = e / K, c = e % K;
      Tmat[e] = r < c
                    ? -(s * E[e])
                    : (r == c ? from_real<T>(1.f - s * (0.5f * real_part(E[e])))
                              : T{});
    }
    tm.sync();
    gemm(tm, 1, P, K, K, vw(x, 0, K, 1), vw(Tmat, 0, K, 1), xn, 0, K, 1);
    tm.sync();
    T* t = x; x = xn; xn = t;
  }
}

// q warm power steps from v0 (subspace iteration: per-column normalisation,
// eps revival, NS polar each step).  Backward: Y <- sum_c BT_c^H BT_c Y;
// forward: Y <- sum_c BT_c BT_c^H Y.  Returns the orthonormal Q (in w.Ya).
// With a.qr set, each step only normalises the columns (no revival, no
// polar) and the returned iterate is orthonormalised by the caller's QR;
// with a.tri set, each normalised step is orthonormalised by tri_newton.
// Under a multi-block team a real Newton-Schulz step's tail after its two
// products runs on the leader block where it fits (polar_in_block), the
// rest of the team waiting at one barrier.
template <class Tm, class T>
__device__ inline const T* power_tail(const Tm& tm, const K12Args<T>& a,
                                      const T* v0, Work<T> w, float* red) {
  const int C = a.C, K = a.chi;
  const long P = (long)a.chi * a.d, PP = P * P;
  const T* yprev = v0;
  for (int it = 0; it < a.q_iters; ++it) {
    if (!a.forward) {
      // MV[c, p, j] = sum_q BT[c,p,q] Y[q,j]
      gemm(tm, C, P, K, P, vw(w.BT, PP, P, 1), vw(yprev, 0, K, 1), w.MV,
           P * K, K, 1);
      tm.sync();
      // Ynew[q, j] = sum_c sum_p conj(BT[c,p,q]) MV[c,p,j]  (class by class;
      // the same thread owns each element in every pass)
      for (int c = 0; c < C; ++c)
        gemm<true>(tm, 1, P, K, P, vw(w.BT + c * PP, 0, 1, P),
                   vw(w.MV + c * P * K, 0, K, 1), w.Yb, 0, K, 1, 1.f,
                   c ? 1.f : 0.f, c ? w.Yb : nullptr);
    } else {
      // MtU[c, q, j] = sum_p conj(BT[c,p,q]) Y[p,j]
      gemm<true>(tm, C, P, K, P, vw(w.BT, PP, 1, P), vw(yprev, 0, K, 1), w.MV,
                 P * K, K, 1);
      tm.sync();
      // Ynew[p, j] = sum_c sum_q BT[c,p,q] MtU[c,q,j]
      for (int c = 0; c < C; ++c)
        gemm(tm, 1, P, K, P, vw(w.BT + c * PP, 0, P, 1),
             vw(w.MV + c * P * K, 0, K, 1), w.Yb, 0, K, 1, 1.f,
             c ? 1.f : 0.f, c ? w.Yb : nullptr);
    }
    tm.sync();
    if constexpr (Tm::kCluster && !IsComplex<T>::value) {
      if (!a.qr && !a.tri && polar_in_block<T>(a.chi, a.d)) {
        if (tm.rank == 0) leader_tail(P, K, w.Yb, yprev, w.Ya, red);
        tm.sync();
        yprev = w.Ya;
        continue;
      }
    }
    for (int j = tm.tid(); j < K; j += tm.size()) {
      float s = 0.f;
      for (int r = 0; r < P; ++r) s = abs2_add(w.Yb[r * K + j], s);
      w.nrm[j] = col_norm(s);
    }
    tm.sync();
    if (a.qr || a.tri) {
      for (int e = tm.tid(); e < P * K; e += tm.size())
        w.Ya[e] = w.Yb[e] / w.nrm[e % K];
      tm.sync();
      if (a.tri) tri_newton(tm, w.Ya, w.Yc, w.Gm, w.G2, P, K, red);
      yprev = w.Ya;
      continue;
    }
    // X = Ynew / ||col|| + eps * Yprev, then pre-scale by ||X||_F (1 + 1e-3);
    // partial t's thread forms its own elements
    float part = 0.f;
    for (int e = tm.tid(); tm.holds_part() && e < P * K;
         e += tm.part_stride()) {
      const T v = ns_revive(w.Yb[e], w.nrm[e % K], yprev[e]);
      w.Yb[e] = v;
      part = abs2_add(v, part);
    }
    const float sc = ns_prescale(block_sum(tm, part, red));
    for (int e = tm.tid(); e < P * K; e += tm.size()) w.Yb[e] *= sc;
    tm.sync();
    ns_polar(tm, w.Yb, w.Yc, w.Ya, w, P, K);
    yprev = w.Ya;
  }
  return yprev;
}

// ---- K2: projection, energies, cutoff mask, emission, env advance ---------

// The ITensor cutoff without a sort on the direction energies w.wv [K], in
// any order, into w.mask: direction i counts j toward its suffix iff
// w_j < w_i, or w_j == w_i and j >= i (the stable descending order), and is
// kept iff that suffix's energy exceeds cutoff * total, w_i > 0, and its
// sorted position is below max_rank (cnt_i > K - max_rank).
template <class Tm, class T>
__device__ inline void cutoff_mask(const Tm& tm, const K12Args<T>& a,
                                   Work<T> w) {
  const int K = a.chi;
  for (int i = tm.tid(); i < K; i += tm.size()) {
    const float wi = w.wv[i];
    float total = 0.f, suffix = 0.f;
    int cnt = 0;
    for (int j = 0; j < K; ++j) {
      const float wj = w.wv[j];
      total += wj;
      if (wj < wi || (wj == wi && j >= i)) {
        suffix += wj;
        ++cnt;
      }
    }
    const bool keep = suffix > a.cutoff * total && wi > 0.f &&
                      (float)cnt > (float)K - a.max_rank;
    w.mask[i] = keep ? 1.f : 0.f;
  }
  tm.sync();
}

// The projected blocks of BT onto Q into w.MV: backward B_c = BT_c Q
// [C, P, K], forward B_c = Q^H BT_c [C, K, P].
template <class Tm, class T>
__device__ inline void project(const Tm& tm, const K12Args<T>& a, const T* Q,
                               Work<T> w) {
  const int C = a.C, K = a.chi;
  const long P = (long)a.chi * a.d, PP = P * P;
  if (!a.forward)
    gemm(tm, C, P, K, P, vw(w.BT, PP, P, 1), vw(Q, 0, K, 1), w.MV, P * K, K,
         1);
  else
    gemm<true>(tm, C, K, P, P, vw(Q, 0, 1, K), vw(w.BT, PP, P, 1), w.MV,
               K * P, P, 1);
  tm.sync();
}

// The direction energies w.wv [K] of the projected blocks and their cutoff
// mask.
template <class Tm, class T>
__device__ inline void energies_mask(const Tm& tm, const K12Args<T>& a,
                                     Work<T> w) {
  const int C = a.C, K = a.chi;
  const long P = (long)a.chi * a.d;
  for (int j = tm.tid(); j < K; j += tm.size()) {
    float wv = 0.f;
    for (int c = 0; c < C; ++c) {
      float s = 0.f;
      if (!a.forward) {
        for (int p = 0; p < P; ++p) s = abs2_add(w.MV[(c * P + p) * K + j], s);
      } else {
        for (int q = 0; q < P; ++q) s = abs2_add(w.MV[(c * K + j) * P + q], s);
      }
      wv += s;
    }
    w.wv[j] = wv;
  }
  tm.sync();
  cutoff_mask(tm, a, w);
}

// The projected blocks, the direction energies and their cutoff mask.
template <class Tm, class T>
__device__ inline void project_mask(const Tm& tm, const K12Args<T>& a,
                                    const T* Q, Work<T> w) {
  project(tm, a, Q, w);
  energies_mask(tm, a, w);
}

// Emit the masked split factors in their final core layouts, the unmasked
// subspace cache (unless q_out is null), and the masked isometry Qm (into
// w.Yb).
template <class Tm, class T>
__device__ inline void emit(const Tm& tm, const K12Args<T>& a, const T* Q,
                            T* core_out, T* q_out, Work<T> w) {
  const int C = a.C, K = a.chi;
  const long P = (long)a.chi * a.d;
  // backward center[c, a, i, m] = B[c, p, m] mask[m];
  // forward  center[c, m, k, b] = B[c, m, q] mask[m]
  for (long e = tm.tid(); e < C * P * K; e += tm.size()) {
    const int m = a.forward ? (int)((e / P) % K) : (int)(e % K);
    a.center_out[e] = w.MV[e] * w.mask[m];
  }
  for (long e = tm.tid(); e < P * K; e += tm.size()) {
    const int m = (int)(e % K);
    const T qm = Q[e] * w.mask[m];
    w.Yb[e] = qm;
    if (q_out != nullptr) q_out[e] = Q[e];
    if (a.forward) {
      core_out[e] = qm;                       // U[a, i, m]
    } else {
      core_out[m * P + e / K] = conj(qm);     // V[m, k, b] = conj(Qm[(k, b), m])
    }
  }
  tm.sync();
}

// env'[n, m] = sum_r F[n, r] Qm[r, m] with F = L forward, R backward; then
// per-sample renormalisation with log-scale accumulation.  In complex the
// factor takes the stored environment ``env`` and features ``phi`` without
// the conjugation K1 puts on the environment, and the backward advance
// reads conj(Qm).
template <class Tm, class T>
__device__ inline void env_advance(const Tm& tm, const K12Args<T>& a,
                                   const T* env, const T* phi,
                                   const float* ls, T* env_out, float* ls_out,
                                   Work<T> w) {
  const int N = a.N, K = a.chi, d = a.d;
  const long P = (long)a.chi * a.d;
  T* F = a.forward ? w.L : w.R;
  if constexpr (IsComplex<T>::value) {
    for (long e = tm.tid(); e < N * P; e += tm.size()) {
      const long n = e / P, p = e % P;
      F[e] = a.forward ? env[n * K + p / d] * phi[n * d + p % d]
                       : phi[n * d + p / K] * env[n * K + p % K];
    }
    tm.sync();
    if (!a.forward) {
      gemm<false, true>(tm, 1, N, K, P, vw(F, 0, P, 1), vw(w.Yb, 0, K, 1),
                        env_out, 0, K, 1);
    } else {
      gemm(tm, 1, N, K, P, vw(F, 0, P, 1), vw(w.Yb, 0, K, 1), env_out, 0, K,
           1);
    }
  } else {
    gemm(tm, 1, N, K, P, vw(F, 0, P, 1), vw(w.Yb, 0, K, 1), env_out, 0, K, 1);
  }
  tm.sync();
  for (int n = tm.tid(); n < N; n += tm.size()) {
    float s = 0.f;
    for (int m = 0; m < K; ++m) s = abs2_add(env_out[n * K + m], s);
    const float nrm = sqrtf(s);
    const float safe = fmaxf(nrm, kTiny);
    const float div = nrm > 0.f ? safe : 1.f;
    for (int m = 0; m < K; ++m) env_out[n * K + m] /= div;
    ls_out[n] = ls[n] + (nrm > 0.f ? logf(safe) : 0.f);
  }
  tm.sync();
}

// One bond step (bond b of a block): the kron factors, the bond tensor, the
// step, the power step (a refresh bond), the split and the env advance.
template <class Tm, class T>
__device__ inline void bond_step(const Tm& tm, const K12Args<T>& a, int b,
                                 const T* env, const float* ls,
                                 const T* center, Work<T> w, float* red) {
  const int chi = a.chi, d = a.d, N = a.N;
  const long P = (long)chi * d;
  const T* core = a.lhs + b * P * chi;
  const T* envx = a.envx + (long)b * N * chi;
  const T* v0 = a.v0 + b * P * chi;
  const T* phil = a.phil + (long)b * N * d;
  const T* phir = a.phir + (long)b * N * d;
  kron_factors(tm, a.forward ? env : envx, a.forward ? envx : env, phil, phir,
               w, chi, d, N);
  bond_tensor(tm, core, center, w, a.C, chi, d, a.forward);
  tm.sync();
  k1_update(tm, a, ls, w, red);
  const T* Q = a.refresh ? power_tail(tm, a, v0, w, red) : v0;
  project_mask(tm, a, Q, w);
  emit(tm, a, Q, a.core_out + b * P * chi, a.q_out + b * P * chi, w);
  env_advance(tm, a, env, a.forward ? phil : phir, ls,
              a.env_out + (long)b * N * chi, a.ls_out + (long)b * N, w);
}

// Bb consecutive bond steps on a team; the center, environment and
// log-scales carry from bond to bond through the outputs.  Bond b + 1 reads
// what every block of a cluster wrote in bond b only after env_advance's
// closing team barrier.
template <class Tm, class T>
__device__ inline void block_steps(const Tm& tm, const K12Args<T>& a,
                                   Work<T> w, float* red) {
  for (int b = 0; b < a.Bb; ++b) {
    const long off = (long)(b - 1) * a.N;
    bond_step(tm, a, b, b ? a.env_out + off * a.chi : a.env0,
              b ? a.ls_out + off : a.ls0, b ? a.center_out : a.center0, w,
              red);
  }
}

// K12m (K12 at Bb = 1, K12mc at cfloat) in one block: the reference the
// cluster kernel is held against bit for bit.
template <class T>
__global__ void __launch_bounds__(kMaxThreads) k12m_kernel(K12Args<T> a) {
  __shared__ float red[kMaxThreads];
  block_steps(BlockTeam{}, a, carve<T>(a.ws, a.C, a.chi, a.d, a.N), red);
}

// K12m over a thread-block cluster: the same Bb bond steps under
// ClusterTeam, the same bits as k12m_kernel (launch bound as K12c's).
template <class T>
__global__ void __launch_bounds__(kMaxThreads, 1)
    k12m_cluster_kernel(K12Args<T> a) {
  __shared__ float red[kMaxThreads];
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  Work<T> w = carve<T>(a.ws, a.C, a.chi, a.d, a.N);
  block_steps(cluster_team(w.parts, dyn_smem), a, w, red);
}

// K12c: one bond step (K12m's at Bb = 1) over a thread-block cluster.  The
// launch bound's one block a SM lets ptxas keep 128 registers (without it,
// ptxas for sm_90a gave these kernels 64 and spilled).  k12m_cluster_kernel
// at Bb = 1 computes the same bits, but with b a constant 0 here ptxas
// spills less (1052 B of stores, not 1888), which keeps this kernel the
// faster of the two (chip_smoke.py's [k12c-k12cr-cluster] times both).
template <class T>
__global__ void __launch_bounds__(kMaxThreads, 1) k12c_kernel(K12Args<T> a) {
  __shared__ float red[kMaxThreads];
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  Work<T> w = carve<T>(a.ws, a.C, a.chi, a.d, a.N);
  const ClusterTeam tm = cluster_team(w.parts, dyn_smem);
  bond_step(tm, a, 0, a.env0, a.ls0, a.center0, w, red);
}

// y_out [P, chi] <- y, the last phase of K1, K1b and K1-tail (y is v0, or
// the power iterate, which power_tail leaves behind a team barrier).
template <class Tm, class T>
__device__ inline void store_y(const Tm& tm, const K12Args<T>& a,
                               const T* y, T* y_out) {
  const long PK = (long)a.chi * a.d * a.chi;
  for (long e = tm.tid(); e < PK; e += tm.size()) y_out[e] = y[e];
}

// K1 on a team: the bond tensor is built, stepped and emitted in place in
// w.BT (the caller's bt_out), then the power iterate into y_out.
template <class Tm, class T>
__device__ inline void k1_body(const Tm& tm, const K12Args<T>& a,
                               const T* le, const T* re, Work<T> w,
                               T* y_out, float* red) {
  kron_factors(tm, le, re, a.phil, a.phir, w, a.chi, a.d, a.N);
  bond_tensor(tm, a.lhs, a.center0, w, a.C, a.chi, a.d, a.forward);
  tm.sync();
  k1_update(tm, a, a.ls0, w, red);
  store_y(tm, a, a.refresh ? power_tail(tm, a, a.v0, w, red) : a.v0, y_out);
}

// K1: one bond step up to its orthogonalisation.  The bond tensor is built,
// stepped and emitted in place in bt_out ([C, P, P], i.e. [C, chi*d, d,
// chi]); y_out [P, chi] gets the q-step power iterate (a.qr: column-
// normalised only) or, for a frozen bond (a.refresh == 0), v0.  ls0 holds
// the total log-scales le_ls + re_ls (MSE only; opp_ls is null).
template <class T>
__global__ void __launch_bounds__(kMaxThreads) k1_kernel(K12Args<T> a,
                                                         const T* le,
                                                         const T* re,
                                                         T* bt_out,
                                                         T* y_out) {
  __shared__ float red[kMaxThreads];
  Work<T> w = carve<T>(a.ws, a.C, a.chi, a.d, a.N);
  w.BT = bt_out;
  k1_body(BlockTeam{}, a, le, re, w, y_out, red);
}

// K1 (K1c) over a thread-block cluster: K1's body and operands under
// ClusterTeam, bt_out written by every block (its gemm tiles), the same
// bits as k1_kernel.  The launch bound's one block a SM keeps ptxas from
// capping the registers at 64, as for K12c.
template <class T>
__global__ void __launch_bounds__(kMaxThreads, 1)
    k1_cluster_kernel(K12Args<T> a, const T* le, const T* re, T* bt_out,
                      T* y_out) {
  __shared__ float red[kMaxThreads];
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  Work<T> w = carve<T>(a.ws, a.C, a.chi, a.d, a.N);
  w.BT = bt_out;
  k1_body(cluster_team(w.parts, dyn_smem), a, le, re, w, y_out, red);
}

// K2: the split of a stepped bond tensor bt against the orthonormal basis
// Q [P, chi]: projection, energies and cutoff mask, the center and core in
// their final layouts, and the advance of the environment env0 / ls0
// through the new isometry with its features phil (backward: re and phir;
// forward: le and phil).  The body on a team, in four parts: the
// projection (after the real kron factors), the energies and mask, the
// emission, the advance; a.upto = n > 0 stops after part n.  Then the
// kernel of one block.
template <class Tm, class T>
__device__ inline void k2_body(const Tm& tm, const K12Args<T>& a, const T* Q,
                               Work<T> w) {
  // one side's factor is all the advance needs: L (forward) or R (backward)
  if constexpr (!IsComplex<T>::value) {
    kron_factors(tm, a.env0, a.env0, a.phil, a.phil, w, a.chi, a.d, a.N);
    tm.sync();
  }
  project(tm, a, Q, w);
  if (a.upto == 1) return;
  energies_mask(tm, a, w);
  if (a.upto == 2) return;
  emit(tm, a, Q, a.core_out, static_cast<T*>(nullptr), w);
  if (a.upto == 3) return;
  env_advance(tm, a, a.env0, a.phil, a.ls0, a.env_out, a.ls_out, w);
}

template <class T>
__global__ void __launch_bounds__(kMaxThreads) k2_kernel(K12Args<T> a,
                                                         const T* bt,
                                                         const T* Q) {
  Work<T> w = carve<T>(a.ws, a.C, a.chi, a.d, a.N);
  w.BT = const_cast<T*>(bt);                // read only
  k2_body(BlockTeam{}, a, Q, w);
}

// K2 (K2c) over a thread-block cluster: K2's body and operands under
// ClusterTeam, the same bits as k2_kernel (launch bound as K1c's).
template <class T>
__global__ void __launch_bounds__(kMaxThreads, 1)
    k2_cluster_kernel(K12Args<T> a, const T* bt, const T* Q) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  Work<T> w = carve<T>(a.ws, a.C, a.chi, a.d, a.N);
  w.BT = const_cast<T*>(bt);                // read only
  k2_body(cluster_team(w.parts, dyn_smem), a, Q, w);
}

// ---- K1a, K1b, K2-split, K2-env: the bond step in four pieces ------------
// The data-parallel bond step (pallas_bond.py:1320-1372 with axis_name) runs
// K1a on every shard, sums the gradients across shards, runs K1b (and the
// QR under orth="qr") and K2-split once per replica, then K2-env on every
// shard; the batch-tiled bond step runs the same pieces over row tiles.
// Only K1a and K2-env touch the batch; K1b and K2-split carve their
// workspace at N = 0, K2-env at C = 0.

// K1a: the gradient of this shard's batch, G [C, P, P] into w.G, from the
// bond tensor of the replicated core and center (left in the workspace).
// ls0 holds the total log-scales (MSE only).  The body on a team, then the
// kernel of one block.
template <class Tm, class T>
__device__ inline void k1a_body(const Tm& tm, const K12Args<T>& a,
                                const T* le, const T* re, Work<T> w) {
  kron_factors(tm, le, re, a.phil, a.phir, w, a.chi, a.d, a.N);
  bond_tensor(tm, a.lhs, a.center0, w, a.C, a.chi, a.d, a.forward);
  tm.sync();
  k1_grad(tm, a, a.ls0, w);
}

template <class T>
__global__ void __launch_bounds__(kMaxThreads) k1a_kernel(K12Args<T> a,
                                                          const T* le,
                                                          const T* re,
                                                          T* g_out) {
  Work<T> w = carve<T>(a.ws, a.C, a.chi, a.d, a.N);
  w.G = g_out;
  k1a_body(BlockTeam{}, a, le, re, w);
}

// K1a (K1c-grad) over a thread-block cluster: K1a's body and operands under
// ClusterTeam, g_out written by every block (its gemm tiles), the same bits
// as k1a_kernel (launch bound as K1c's).
template <class T>
__global__ void __launch_bounds__(kMaxThreads, 1)
    k1a_cluster_kernel(K12Args<T> a, const T* le, const T* re, T* g_out) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  Work<T> w = carve<T>(a.ws, a.C, a.chi, a.d, a.N);
  w.G = g_out;
  k1a_body(cluster_team(w.parts, dyn_smem), a, le, re, w);
}

// K1b: the bond tensor, the step against the reduced gradient g, and the
// q-step power iterate (a.qr: column-normalised only) into y_out, or v0 for
// a frozen bond (a.refresh == 0); the stepped bond tensor into bt_out.
// The body on a team, then the kernel of one block.
template <class Tm, class T>
__device__ inline void k1b_body(const Tm& tm, const K12Args<T>& a, Work<T> w,
                                T* y_out, float* red) {
  bond_tensor(tm, a.lhs, a.center0, w, a.C, a.chi, a.d, a.forward);
  tm.sync();
  k1_step(tm, a, w, red);
  store_y(tm, a, a.refresh ? power_tail(tm, a, a.v0, w, red) : a.v0, y_out);
}

template <class T>
__global__ void __launch_bounds__(kMaxThreads) k1b_kernel(K12Args<T> a,
                                                          const T* g,
                                                          T* bt_out,
                                                          T* y_out) {
  __shared__ float red[kMaxThreads];
  Work<T> w = carve<T>(a.ws, a.C, a.chi, a.d, 0);
  w.BT = bt_out;
  w.G = const_cast<T*>(g);                  // read only
  k1b_body(BlockTeam{}, a, w, y_out, red);
}

// K1b (K1c-update) over a thread-block cluster: K1b's body and operands
// under ClusterTeam, the same bits as k1b_kernel (launch bound as K1c's).
template <class T>
__global__ void __launch_bounds__(kMaxThreads, 1)
    k1b_cluster_kernel(K12Args<T> a, const T* g, T* bt_out, T* y_out) {
  __shared__ float red[kMaxThreads];
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  Work<T> w = carve<T>(a.ws, a.C, a.chi, a.d, 0);
  w.BT = bt_out;
  w.G = const_cast<T*>(g);                  // read only
  k1b_body(cluster_team(w.parts, dyn_smem), a, w, y_out, red);
}

// K1-tail: a.q_iters warm power steps of a stored, stepped bond tensor bt
// (K1's or K1b's, launched with emit_y = 0) from v0 into y_out (a.qr:
// column-normalised only; else the revival and Newton-Schulz polar of each
// step).  The split-tail route chains launches at q = 1, which is K1's own
// tail step by step: power_tail over the same BT, as K1b reads it.  The
// body on a team, then the kernel of one block.
template <class Tm, class T>
__device__ inline void k1_tail_body(const Tm& tm, const K12Args<T>& a,
                                    const T* bt, T* y_out, float* red) {
  Work<T> w = carve<T>(a.ws, a.C, a.chi, a.d, 0);
  w.BT = const_cast<T*>(bt);                // read only
  store_y(tm, a, power_tail(tm, a, a.v0, w, red), y_out);
}

template <class T>
__global__ void __launch_bounds__(kMaxThreads) k1_tail_kernel(K12Args<T> a,
                                                              const T* bt,
                                                              T* y_out) {
  __shared__ float red[kMaxThreads];
  k1_tail_body(BlockTeam{}, a, bt, y_out, red);
}

// K1-tail (K1c-tail) over every block of a cooperative grid: K1-tail's body
// and operands under GridTeam, the same bits as k1_tail_kernel.  A cluster
// holds at most 16 blocks; the grid spans as many SMs as the card holds
// blocks at once (132 at one block a SM), which the large products of a
// stored BT at chi 192-320 can fill.  Launch bound as the cluster kernels'.
template <class T>
__global__ void __launch_bounds__(kMaxThreads, 1)
    k1_tail_grid_kernel(K12Args<T> a, const T* bt, T* y_out) {
  __shared__ float red[kMaxThreads];
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const GridTeam tm = grid_team(
      carve<T>(a.ws, a.C, a.chi, a.d, 0).parts, dyn_smem);
  k1_tail_body(tm, a, bt, y_out, red);
}

// K2-split: the split of bt against the orthonormal basis Q: projection,
// energies and cutoff mask, the center and core in their final layouts, and
// the masked isometry Qm = Q * mask into qm_out (emit forms it in w.Yb).
// The body on a team, then the kernel of one block.
template <class Tm, class T>
__device__ inline void k2_split_body(const Tm& tm, const K12Args<T>& a,
                                     const T* Q, Work<T> w) {
  project_mask(tm, a, Q, w);
  emit(tm, a, Q, a.core_out, static_cast<T*>(nullptr), w);
}

template <class T>
__global__ void __launch_bounds__(kMaxThreads) k2_split_kernel(K12Args<T> a,
                                                               const T* bt,
                                                               const T* Q,
                                                               T* qm_out) {
  Work<T> w = carve<T>(a.ws, a.C, a.chi, a.d, 0);
  w.BT = const_cast<T*>(bt);                // read only
  w.Yb = qm_out;
  k2_split_body(BlockTeam{}, a, Q, w);
}

// K2-split (K2c-split) over a thread-block cluster: K2-split's body and
// operands under ClusterTeam, the same bits as k2_split_kernel (launch
// bound as K1c's).
template <class T>
__global__ void __launch_bounds__(kMaxThreads, 1)
    k2_split_cluster_kernel(K12Args<T> a, const T* bt, const T* Q,
                            T* qm_out) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  Work<T> w = carve<T>(a.ws, a.C, a.chi, a.d, 0);
  w.BT = const_cast<T*>(bt);                // read only
  w.Yb = qm_out;
  k2_split_body(cluster_team(w.parts, dyn_smem), a, Q, w);
}

// K2-env: the advance of this shard's environment env0 / ls0 through the
// masked isometry qm with its features phil (backward: re and phir; forward:
// le and phil).  The body on one block's rows (w.L and w.R the rows' kron
// factors), then the kernel of one block over all N rows.
template <class T>
__device__ inline void k2_env_body(const K12Args<T>& a, Work<T> w) {
  const BlockTeam tm;
  if constexpr (!IsComplex<T>::value) {
    kron_factors(tm, a.env0, a.env0, a.phil, a.phil, w, a.chi, a.d, a.N);
    tm.sync();
  }
  env_advance(tm, a, a.env0, a.phil, a.ls0, a.env_out, a.ls_out, w);
}

template <class T>
__global__ void __launch_bounds__(kMaxThreads) k2_env_kernel(K12Args<T> a,
                                                             const T* qm) {
  Work<T> w = carve<T>(a.ws, 0, a.chi, a.d, a.N);
  w.Yb = const_cast<T*>(qm);                // read only
  k2_env_body(a, w);
}

// K2-env (K2c-env) over independent row tiles: block b advances rows
// [b rows, min(N, (b + 1) rows)) with K2-env's body on that slice, its
// operands, outputs and kron factors offset by the tile's first row.  Every
// output row is its own kron row times Qm (one chain over p per element)
// and its own renormalisation (one chain over m), so the tiles need no
// barrier and no sum between them, and each element is the one-block
// kernel's chain: the same bits.  The grid grows with N.
// Staged, the block copies Qm [P, chi] into its dynamic shared memory and
// keeps its rows' kron factors there (k2_env_rows_smem_bytes), so the
// advance's chains read shared memory, not L2; the body's barrier before
// the product (after the real kron factors, after the complex factor)
// orders the copy.  The values and chains are the same either way.
template <class T, bool Staged>
__global__ void __launch_bounds__(kMaxThreads)
    k2_env_rows_kernel(K12Args<T> a, const T* qm, int rows) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const int r0 = blockIdx.x * rows;
  const long P = (long)a.chi * a.d;
  Work<T> w = carve<T>(a.ws, 0, a.chi, a.d, a.N);
  w.L += r0 * P;
  w.R += r0 * P;
  w.Yb = const_cast<T*>(qm);                // read only
  if constexpr (Staged) {
    T* q = reinterpret_cast<T*>(dyn_smem);
#pragma unroll 4
    for (long e = threadIdx.x; e < P * a.chi; e += blockDim.x) q[e] = qm[e];
    w.Yb = q;
    w.L = q + P * a.chi;
    w.R = w.L + rows * P;
  }
  K12Args<T> t = a;
  t.N = min(rows, a.N - r0);
  t.env0 += (long)r0 * a.chi;
  t.phil += (long)r0 * a.d;
  t.ls0 += r0;
  t.env_out += (long)r0 * a.chi;
  t.ls_out += r0;
  k2_env_body(t, w);
}

// ---- K12cr: the tracked-ritz bond step ------------------------------------

// K12cr's rotation buffers: S and W [K, K], and one round's rotations of the
// K/2 adjacent pairs, (x, y) and liveness.  In the leader block's dynamic
// shared memory when they fit (rot_smem_bytes <= kMaxDynSmem), else in the
// global workspace's Gm, G2, Mq and nrm, which K12cr does not otherwise need
// by then.
template <class T>
struct Rot {
  T *S, *W, *x, *y;
  float* live;
};

template <class T>
__host__ __device__ inline long rot_smem_bytes(int K) {
  return (2L * K * K + 2L * (K / 2)) * (long)sizeof(T) +
         (K / 2) * (long)sizeof(float);
}

template <class T>
__device__ inline Rot<T> rot_buffers(Work<T> w, unsigned char* dyn, int smem,
                                     int K) {
  Rot<T> r;
  if (smem) {
    r.S = reinterpret_cast<T*>(dyn);
    r.W = r.S + K * K;
    r.x = r.W + K * K;
    r.y = r.x + K / 2;
    r.live = reinterpret_cast<float*>(r.y + K / 2);
  } else {
    r.S = w.Gm;
    r.W = w.G2;
    r.x = w.Mq;
    r.y = w.Mq + K / 2;
    r.live = w.nrm;
  }
  return r;
}

// The projected blocks (project) and their Gram S [K, K]: sum_c B_c^H B_c
// backward, sum_c B_c B_c^H forward (pallas_bond_c.py:942-965).
template <class Tm, class T>
__device__ inline void ritz_gram(const Tm& tm, const K12Args<T>& a,
                                 const T* Q, Work<T> w, T* S) {
  const int C = a.C, K = a.chi;
  const long P = (long)a.chi * a.d;
  project(tm, a, Q, w);
  // class by class; the same thread owns each element of S in every pass
  for (int c = 0; c < C; ++c) {
    const T* B = w.MV + c * P * K;
    if (!a.forward)
      gemm<true>(tm, 1, K, K, P, vw(B, 0, 1, K), vw(B, 0, K, 1), S, 0, K, 1,
                 1.f, c ? 1.f : 0.f, c ? S : nullptr);
    else
      gemm<false, true>(tm, 1, K, K, P, vw(B, 0, P, 1), vw(B, 0, 1, P), S, 0,
                        K, 1, 1.f, c ? 1.f : 0.f, c ? S : nullptr);
  }
  tm.sync();
}

// rounds odd-even rounds of exact 2x2 Jacobi rotations on the adjacent
// disjoint pairs (i, i+1), i = r % 2, r % 2 + 2, ... (ops/decomp.py's
// _jacobi_round, pallas_bond_c.py:827-910, the same branch rules): S, scaled
// by nf = max |diag S|, goes to J^H S J and W from I to W J, where J's
// column i is (x, y) and column i + 1 (-conj(y), conj(x)); S is
// re-hermitised after each round.  A round touches two rows and two columns
// of S and two columns of W per pair, O(K) each, instead of the TPU's dense
// J products.  wv gets diag(S) * nf in round order.
template <class T>
__device__ inline void jacobi_rounds(Rot<T> r, int K, int rounds, float* wv,
                                     float* red) {
  T* S = r.S;
  T* W = r.W;
  float m = 0.f;
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    m = fmaxf(m, fabsf(real_part(S[i * K + i])));
  const float nf = fmaxf(block_max(m, red), kTiny);
  for (int e = threadIdx.x; e < K * K; e += blockDim.x) {
    S[e] /= nf;
    W[e] = (e / K == e % K) ? from_real<T>(1.f) : T{};
  }
  __syncthreads();
  for (int rd = 0; rd < rounds; ++rd) {
    const int off = rd % 2;
    const int np = (K - off) / 2;
    // each pair's rotation: its first column is the 2x2 block's mu_plus
    // eigenvector, built on the better-conditioned branch
    for (int p = threadIdx.x; p < np; p += blockDim.x) {
      const int i = off + 2 * p;
      const float al = real_part(S[i * K + i]);
      const float be = real_part(S[(i + 1) * K + i + 1]);
      const T wo = S[i * K + i + 1];
      const float half = 0.5f * (al - be);
      const float mu =
          0.5f * (al + be) + sqrtf(half * half + abs2_add(wo, 0.f));
      const bool hi = al >= be;
      const T x = hi ? from_real<T>(mu - be) : wo;
      const T y = hi ? conj(wo) : from_real<T>(mu - al);
      const float n2 = abs2_add(y, abs2_add(x, 0.f));
      const bool live = n2 > kTiny;
      const float n = sqrtf(n2);
      r.x[p] = live ? x / n : from_real<T>(1.f);
      r.y[p] = live ? y / n : T{};
      r.live[p] = live ? 1.f : 0.f;
    }
    __syncthreads();
    // S <- S J, W <- W J: columns i and i + 1 of every row
    for (int e = threadIdx.x; e < 2 * K * np; e += blockDim.x) {
      const int p = e % np;
      if (r.live[p] == 0.f) continue;
      const int row = (e / np) % K;
      T* M = e < K * np ? S : W;
      const int i = off + 2 * p;
      const T x = r.x[p], y = r.y[p];
      const T a = M[row * K + i], b = M[row * K + i + 1];
      M[row * K + i] = mac(b, y, a * x);
      M[row * K + i + 1] = mac(b, conj(x), a * (-conj(y)));
    }
    __syncthreads();
    // S <- J^H S: rows i and i + 1 of every column
    for (int e = threadIdx.x; e < K * np; e += blockDim.x) {
      const int p = e % np;
      if (r.live[p] == 0.f) continue;
      const int col = e / np;
      const int i = off + 2 * p;
      const T x = r.x[p], y = r.y[p];
      const T a = S[i * K + col], b = S[(i + 1) * K + col];
      S[i * K + col] = mac(conj(y), b, conj(x) * a);
      S[(i + 1) * K + col] = mac(x, b, (-y) * a);
    }
    __syncthreads();
    // S <- (S + S^H) / 2
    for (int e = threadIdx.x; e < K * K; e += blockDim.x) {
      const int i = e / K, j = e % K;
      if (i > j) continue;
      const T v = 0.5f * (S[e] + conj(S[j * K + i]));
      S[e] = v;
      S[j * K + i] = conj(v);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    wv[i] = real_part(S[i * K + i]) * nf;
  __syncthreads();
}

// K12cr's emission (pallas_bond_c.py:968-997): the cache Q W (unmasked)
// into q_out, W masked in place to Wm, the masked isometry Qm = Q Wm into
// w.Yb, the center through Wm (backward B_c Wm, forward Wm^H B_c) and the
// core from Qm (backward Qm^H, forward Qm) in their final layouts.
template <class Tm, class T>
__device__ inline void ritz_emit(const Tm& tm, const K12Args<T>& a,
                                 const T* Q, T* W, Work<T> w) {
  const int C = a.C, K = a.chi;
  const long P = (long)a.chi * a.d;
  gemm(tm, 1, P, K, K, vw(Q, 0, K, 1), vw(W, 0, K, 1), a.q_out, 0, K, 1);
  tm.sync();
  for (int e = tm.tid(); e < K * K; e += tm.size()) W[e] *= w.mask[e % K];
  tm.sync();
  gemm(tm, 1, P, K, K, vw(Q, 0, K, 1), vw(W, 0, K, 1), w.Yb, 0, K, 1);
  if (!a.forward)
    gemm(tm, C, P, K, K, vw(w.MV, P * K, K, 1), vw(W, 0, K, 1), a.center_out,
         P * K, K, 1);
  else
    gemm<true>(tm, C, K, P, K, vw(W, 0, 1, K), vw(w.MV, K * P, P, 1),
               a.center_out, K * P, P, 1);
  tm.sync();
  for (long e = tm.tid(); e < P * K; e += tm.size()) {
    const int m = (int)(e % K);
    if (a.forward)
      a.core_out[e] = w.Yb[e];                     // U[a, i, m]
    else
      a.core_out[m * P + e / K] = conj(w.Yb[e]);   // V[m, k, b]
  }
  tm.sync();
}

// K12cr: one tracked-ritz bond step (Bb = 1) over a thread-block cluster:
// the K1 body, q power steps with tri_newton (a frozen bond keeps Q = v0),
// the Ritz Gram S (into w.Gm), rounds Jacobi rounds on the leader block
// alone (S and W in its dynamic shared memory when smem is set, else in the
// workspace's Gm and G2; W leaves in G2), the cutoff mask on the round-order
// energies, the emission and the env advance.  env0/ls0 are the advancing
// environment, envx the opposite one.
template <class T>
__global__ void __launch_bounds__(kMaxThreads, 1) k12cr_kernel(K12Args<T> a,
                                                               int rounds,
                                                               int smem) {
  __shared__ float red[kMaxThreads];
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  Work<T> w = carve<T>(a.ws, a.C, a.chi, a.d, a.N);
  const ClusterTeam tm = cluster_team(w.parts, dyn_smem);
  const int K = a.chi;
  kron_factors(tm, a.forward ? a.env0 : a.envx, a.forward ? a.envx : a.env0,
               a.phil, a.phir, w, a.chi, a.d, a.N);
  bond_tensor(tm, a.lhs, a.center0, w, a.C, a.chi, a.d, a.forward);
  tm.sync();
  k1_update(tm, a, a.ls0, w, red);
  const T* Q = a.refresh ? power_tail(tm, a, a.v0, w, red) : a.v0;
  ritz_gram(tm, a, Q, w, w.Gm);
  if (tm.rank == 0) {              // the gemm tiles are free until the emission
    const Rot<T> r = rot_buffers(w, dyn_smem, smem, K);
    if (smem) {
      for (int e = threadIdx.x; e < K * K; e += blockDim.x)
        r.S[e] = ldcg(w.Gm + e);
      __syncthreads();
    }
    jacobi_rounds(r, K, rounds, w.wv, red);
    if (smem)
      for (int e = threadIdx.x; e < K * K; e += blockDim.x) w.G2[e] = r.W[e];
  }
  tm.sync();
  cutoff_mask(tm, a, w);
  ritz_emit(tm, a, Q, w.G2, w);
  env_advance(tm, a, a.env0, a.forward ? a.phil : a.phir, a.ls0, a.env_out,
              a.ls_out, w);
}

// ---- host launchers ---------------------------------------------------------
// The C entry points of bond_step.cu (T = float) and bond_step_c.cu
// (T = cfloat) forward to these, so one argument list per kernel serves
// both scalar types.  Each launches one block of kMaxThreads (the cluster
// K12m, K12c, K12cr, K1, K1a, K1b, K2 and K2-split: one cluster of
// `cluster` blocks of kMaxThreads; the row-tile K2-env: ceil(N / rows)
// blocks; the grid K1-tail: a cooperative grid of `blocks` blocks) on the
// caller's stream and returns cudaGetLastError().

// A launch configuration of one cluster of `cluster` blocks with smem bytes
// of dynamic shared memory, the kernel's attributes set to allow both.
template <class Kernel>
inline cudaError_t cluster_config(Kernel kernel, int cluster, long smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr,
                                  cudaLaunchConfig_t* cfg) {
  if (cluster < 1) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster);
  cfg->blockDim = dim3(kMaxThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// Launch one cluster; a launch the card refuses (a cluster it cannot
// place) returns its error, and the error is cleared so that it does not
// surface at a later launch.
template <class Kernel, class... Args>
inline int launch_cluster(Kernel kernel, int cluster, long smem,
                          void* stream, Args... args) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t e = cluster_config(kernel, cluster, smem,
                                 static_cast<cudaStream_t>(stream), &attr,
                                 &cfg);
  if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// How many clusters of `cluster` blocks the card can hold at once (0: it
// cannot place one) into *n.
template <class Kernel>
inline int cluster_occupancy(Kernel kernel, int cluster, long smem, int* n) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t e = cluster_config(kernel, cluster, smem, nullptr, &attr, &cfg);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// Allow smem bytes of dynamic shared memory to a grid kernel's blocks.
template <class Kernel>
inline cudaError_t grid_smem(Kernel kernel, long smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                   (int)smem)
             : cudaSuccess;
}

// Launch a cooperative grid of `blocks` blocks of kMaxThreads, every block
// co-resident, so that GridSync's barrier can hold them all.  A grid larger
// than the card holds at once is refused by the launch itself
// (cudaErrorCooperativeLaunchTooLarge) and the error cleared, as
// launch_cluster does; nothing shrinks the grid.
template <class Kernel, class... Args>
inline int launch_grid(Kernel kernel, int blocks, long smem, void* stream,
                       Args... args) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  void* params[] = {static_cast<void*>(&args)...};
  cudaError_t e = grid_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(kernel), dim3(blocks),
        dim3(kMaxThreads), params, (size_t)smem,
        static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// How many blocks of a grid kernel the current card holds at once (the
// largest cooperative grid) into *n: blocks a SM times SMs.
template <class Kernel>
inline int grid_occupancy(Kernel kernel, long smem, int* n) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = grid_smem(kernel, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kMaxThreads, smem);
  *n = e == cudaSuccess ? per_sm * sms : 0;
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// The dynamic shared memory of a kernel whose power steps may take the
// leader's tail: the gemm tiles, or the leader's polar buffers where they
// are larger and fit.
template <class T>
inline long bond_smem_bytes(int chi, int d) {
  const long polar = polar_smem_bytes(chi, d);
  const long stage = stage_smem_bytes<T>();
  return polar_in_block<T>(chi, d) && polar > stage ? polar : stage;
}

// K12cr's dynamic shared memory: the gemm tiles, or the leader's rotation
// buffers where they are larger and fit.
template <class T>
inline long k12cr_smem_bytes(int chi) {
  const long rot = rot_smem_bytes<T>(chi);
  const long stage = stage_smem_bytes<T>();
  return rot <= kMaxDynSmem && rot > stage ? rot : stage;
}

// The operands of a K12m (K12cr: Bb = 1) launch.
template <class T>
inline K12Args<T> k12m_args(const void* lhs, const void* center0,
                            const void* envx, const void* env0,
                            const void* ls0, const void* opp_ls,
                            const void* phil, const void* phir,
                            const void* y1h, const void* w, const void* v0,
                            void* center_out, void* core_out, void* env_out,
                            void* ls_out, void* q_out, void* ws, int Bb,
                            int C, int chi, int d, int N, int forward,
                            int refresh, int q_iters, int mse, int gd,
                            float eta, float cutoff, float max_rank) {
  K12Args<T> a{};
  a.lhs = static_cast<const T*>(lhs);
  a.center0 = static_cast<const T*>(center0);
  a.envx = static_cast<const T*>(envx);
  a.env0 = static_cast<const T*>(env0);
  a.ls0 = static_cast<const float*>(ls0);
  a.opp_ls = static_cast<const float*>(opp_ls);
  a.phil = static_cast<const T*>(phil);
  a.phir = static_cast<const T*>(phir);
  a.y1h = static_cast<const float*>(y1h);
  a.w = static_cast<const float*>(w);
  a.v0 = static_cast<const T*>(v0);
  a.center_out = static_cast<T*>(center_out);
  a.core_out = static_cast<T*>(core_out);
  a.env_out = static_cast<T*>(env_out);
  a.ls_out = static_cast<float*>(ls_out);
  a.q_out = static_cast<T*>(q_out);
  a.ws = static_cast<float*>(ws);
  a.Bb = Bb;
  a.C = C;
  a.chi = chi;
  a.d = d;
  a.N = N;
  a.forward = forward;
  a.refresh = refresh;
  a.q_iters = q_iters;
  a.mse = mse;
  a.gd = gd;
  a.eta = eta;
  a.cutoff = cutoff;
  a.max_rank = max_rank;
  return a;
}

template <class T>
inline int launch_k12m(const void* lhs, const void* center0, const void* envx,
                       const void* env0, const void* ls0, const void* opp_ls,
                       const void* phil, const void* phir, const void* y1h,
                       const void* w, const void* v0, void* center_out,
                       void* core_out, void* env_out, void* ls_out,
                       void* q_out, void* ws, int Bb, int C, int chi, int d,
                       int N, int forward, int refresh, int q_iters, int mse,
                       int gd, float eta, float cutoff, float max_rank,
                       void* stream) {
  const K12Args<T> a = k12m_args<T>(
      lhs, center0, envx, env0, ls0, opp_ls, phil, phir, y1h, w, v0,
      center_out, core_out, env_out, ls_out, q_out, ws, Bb, C, chi, d, N,
      forward, refresh, q_iters, mse, gd, eta, cutoff, max_rank);
  k12m_kernel<T><<<1, kMaxThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// K12m (K12, K12mc) over one cluster of `cluster` blocks: K12m's operands.
template <class T>
inline int launch_k12m_cluster(
    const void* lhs, const void* center0, const void* envx, const void* env0,
    const void* ls0, const void* opp_ls, const void* phil, const void* phir,
    const void* y1h, const void* w, const void* v0, void* center_out,
    void* core_out, void* env_out, void* ls_out, void* q_out, void* ws,
    int Bb, int C, int chi, int d, int N, int forward, int refresh,
    int q_iters, int mse, int gd, float eta, float cutoff, float max_rank,
    int cluster, void* stream) {
  const K12Args<T> a = k12m_args<T>(
      lhs, center0, envx, env0, ls0, opp_ls, phil, phir, y1h, w, v0,
      center_out, core_out, env_out, ls_out, q_out, ws, Bb, C, chi, d, N,
      forward, refresh, q_iters, mse, gd, eta, cutoff, max_rank);
  return launch_cluster(k12m_cluster_kernel<T>, cluster,
                        bond_smem_bytes<T>(chi, d), stream, a);
}

// K12c: K12m's operands at Bb = 1 over one cluster of `cluster` blocks.
template <class T>
inline int launch_k12c(const void* lhs, const void* center0, const void* envx,
                       const void* env0, const void* ls0, const void* phil,
                       const void* phir, const void* y1h, const void* w,
                       const void* v0, void* center_out, void* core_out,
                       void* env_out, void* ls_out, void* q_out, void* ws,
                       int C, int chi, int d, int N, int forward, int refresh,
                       int q_iters, float eta, float cutoff, float max_rank,
                       int cluster, void* stream) {
  const K12Args<T> a = k12m_args<T>(
      lhs, center0, envx, env0, ls0, nullptr, phil, phir, y1h, w, v0,
      center_out, core_out, env_out, ls_out, q_out, ws, 1, C, chi, d, N,
      forward, refresh, q_iters, 0, 0, eta, cutoff, max_rank);
  return launch_cluster(k12c_kernel<T>, cluster, bond_smem_bytes<T>(chi, d),
                        stream, a);
}

// K12cr: K12m's operands at Bb = 1 (KLD + TSGO) plus the Jacobi round count,
// over one cluster of `cluster` blocks; the leader's rotation buffers go to
// its dynamic shared memory when they fit.
template <class T>
inline int launch_k12cr(const void* lhs, const void* center0,
                        const void* envx, const void* env0, const void* ls0,
                        const void* phil, const void* phir, const void* y1h,
                        const void* w, const void* v0, void* center_out,
                        void* core_out, void* env_out, void* ls_out,
                        void* q_out, void* ws, int C, int chi, int d, int N,
                        int forward, int refresh, int q_iters, float eta,
                        float cutoff, float max_rank, int rounds, int cluster,
                        void* stream) {
  K12Args<T> a = k12m_args<T>(
      lhs, center0, envx, env0, ls0, nullptr, phil, phir, y1h, w, v0,
      center_out, core_out, env_out, ls_out, q_out, ws, 1, C, chi, d, N,
      forward, refresh, q_iters, 0, 0, eta, cutoff, max_rank);
  a.tri = 1;
  const int smem = rot_smem_bytes<T>(chi) <= kMaxDynSmem;
  return launch_cluster(k12cr_kernel<T>, cluster, k12cr_smem_bytes<T>(chi),
                        stream, a, rounds, smem);
}

// The operands of a K1 launch: gls [N] is the total log-scale (MSE only,
// else null); emit_y = 0 passes v0 through as Y (frozen bond).
template <class T>
inline K12Args<T> k1_args(const void* lhs, const void* center0,
                          const void* gls, const void* phil, const void* phir,
                          const void* y1h, const void* w, const void* v0,
                          void* ws, int C, int chi, int d, int N, int forward,
                          int emit_y, int q_iters, int qr, int mse, int gd,
                          float eta) {
  K12Args<T> a{};
  a.lhs = static_cast<const T*>(lhs);
  a.center0 = static_cast<const T*>(center0);
  a.ls0 = static_cast<const float*>(gls);
  a.phil = static_cast<const T*>(phil);
  a.phir = static_cast<const T*>(phir);
  a.y1h = static_cast<const float*>(y1h);
  a.w = static_cast<const float*>(w);
  a.v0 = static_cast<const T*>(v0);
  a.ws = static_cast<float*>(ws);
  a.Bb = 1;
  a.C = C;
  a.chi = chi;
  a.d = d;
  a.N = N;
  a.forward = forward;
  a.refresh = emit_y;
  a.q_iters = q_iters;
  a.qr = qr;
  a.mse = mse;
  a.gd = gd;
  a.eta = eta;
  return a;
}

template <class T>
inline int launch_k1(const void* lhs, const void* center0, const void* le,
                     const void* re, const void* gls, const void* phil,
                     const void* phir, const void* y1h, const void* w,
                     const void* v0, void* bt_out, void* y_out, void* ws,
                     int C, int chi, int d, int N, int forward, int emit_y,
                     int q_iters, int qr, int mse, int gd, float eta,
                     void* stream) {
  const K12Args<T> a =
      k1_args<T>(lhs, center0, gls, phil, phir, y1h, w, v0, ws, C, chi, d,
                 N, forward, emit_y, q_iters, qr, mse, gd, eta);
  k1_kernel<T><<<1, kMaxThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const T*>(le), static_cast<const T*>(re),
      static_cast<T*>(bt_out), static_cast<T*>(y_out));
  return (int)cudaGetLastError();
}

// K1 (K1c) over one cluster of `cluster` blocks: K1's operands.
template <class T>
inline int launch_k1_cluster(const void* lhs, const void* center0,
                             const void* le, const void* re, const void* gls,
                             const void* phil, const void* phir,
                             const void* y1h, const void* w, const void* v0,
                             void* bt_out, void* y_out, void* ws, int C,
                             int chi, int d, int N, int forward, int emit_y,
                             int q_iters, int qr, int mse, int gd, float eta,
                             int cluster, void* stream) {
  const K12Args<T> a =
      k1_args<T>(lhs, center0, gls, phil, phir, y1h, w, v0, ws, C, chi, d,
                 N, forward, emit_y, q_iters, qr, mse, gd, eta);
  return launch_cluster(k1_cluster_kernel<T>, cluster,
                        bond_smem_bytes<T>(chi, d), stream, a,
                        static_cast<const T*>(le),
                        static_cast<const T*>(re), static_cast<T*>(bt_out),
                        static_cast<T*>(y_out));
}

// The operands of a K2 launch: env / env_ls / phi are the advancing side's
// environment, log-scales and features.
template <class T>
inline K12Args<T> k2_args(const void* env, const void* env_ls,
                          const void* phi, void* center_out, void* core_out,
                          void* env_out, void* ls_out, void* ws, int C,
                          int chi, int d, int N, int forward, float cutoff,
                          float max_rank) {
  K12Args<T> a{};
  a.env0 = static_cast<const T*>(env);
  a.ls0 = static_cast<const float*>(env_ls);
  a.phil = static_cast<const T*>(phi);
  a.center_out = static_cast<T*>(center_out);
  a.core_out = static_cast<T*>(core_out);
  a.env_out = static_cast<T*>(env_out);
  a.ls_out = static_cast<float*>(ls_out);
  a.ws = static_cast<float*>(ws);
  a.Bb = 1;
  a.C = C;
  a.chi = chi;
  a.d = d;
  a.N = N;
  a.forward = forward;
  a.cutoff = cutoff;
  a.max_rank = max_rank;
  return a;
}

template <class T>
inline int launch_k2(const void* bt, const void* q, const void* env,
                     const void* env_ls, const void* phi, void* center_out,
                     void* core_out, void* env_out, void* ls_out, void* ws,
                     int C, int chi, int d, int N, int forward, float cutoff,
                     float max_rank, void* stream) {
  const K12Args<T> a =
      k2_args<T>(env, env_ls, phi, center_out, core_out, env_out, ls_out, ws,
                 C, chi, d, N, forward, cutoff, max_rank);
  k2_kernel<T><<<1, kMaxThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const T*>(bt), static_cast<const T*>(q));
  return (int)cudaGetLastError();
}

// K2 (K2c) over one cluster of `cluster` blocks: K2's operands; upto > 0
// runs only the body's first upto parts (the by-part timing), 0 all.
template <class T>
inline int launch_k2_cluster(const void* bt, const void* q, const void* env,
                             const void* env_ls, const void* phi,
                             void* center_out, void* core_out, void* env_out,
                             void* ls_out, void* ws, int C, int chi, int d,
                             int N, int forward, float cutoff, float max_rank,
                             int upto, int cluster, void* stream) {
  if (upto < 0 || upto > 3) return (int)cudaErrorInvalidValue;
  K12Args<T> a =
      k2_args<T>(env, env_ls, phi, center_out, core_out, env_out, ls_out, ws,
                 C, chi, d, N, forward, cutoff, max_rank);
  a.upto = upto;
  return launch_cluster(k2_cluster_kernel<T>, cluster, stage_smem_bytes<T>(),
                        stream, a, static_cast<const T*>(bt),
                        static_cast<const T*>(q));
}

// The operands of a K1a launch: gls [N] is the total log-scale (MSE only,
// else null).  Scratch: workspace_floats(C, chi, d, N).
template <class T>
inline K12Args<T> k1a_args(const void* lhs, const void* center0,
                           const void* gls, const void* phil,
                           const void* phir, const void* y1h, const void* w,
                           void* ws, int C, int chi, int d, int N,
                           int forward, int mse) {
  K12Args<T> a{};
  a.lhs = static_cast<const T*>(lhs);
  a.center0 = static_cast<const T*>(center0);
  a.ls0 = static_cast<const float*>(gls);
  a.phil = static_cast<const T*>(phil);
  a.phir = static_cast<const T*>(phir);
  a.y1h = static_cast<const float*>(y1h);
  a.w = static_cast<const float*>(w);
  a.ws = static_cast<float*>(ws);
  a.Bb = 1;
  a.C = C;
  a.chi = chi;
  a.d = d;
  a.N = N;
  a.forward = forward;
  a.mse = mse;
  return a;
}

template <class T>
inline int launch_k1a(const void* lhs, const void* center0, const void* le,
                      const void* re, const void* gls, const void* phil,
                      const void* phir, const void* y1h, const void* w,
                      void* g_out, void* ws, int C, int chi, int d, int N,
                      int forward, int mse, void* stream) {
  const K12Args<T> a = k1a_args<T>(lhs, center0, gls, phil, phir, y1h, w, ws,
                                   C, chi, d, N, forward, mse);
  k1a_kernel<T><<<1, kMaxThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const T*>(le), static_cast<const T*>(re),
      static_cast<T*>(g_out));
  return (int)cudaGetLastError();
}

// K1a (K1c-grad) over one cluster of `cluster` blocks: K1a's operands.
template <class T>
inline int launch_k1a_cluster(const void* lhs, const void* center0,
                              const void* le, const void* re,
                              const void* gls, const void* phil,
                              const void* phir, const void* y1h,
                              const void* w, void* g_out, void* ws, int C,
                              int chi, int d, int N, int forward, int mse,
                              int cluster, void* stream) {
  const K12Args<T> a = k1a_args<T>(lhs, center0, gls, phil, phir, y1h, w, ws,
                                   C, chi, d, N, forward, mse);
  return launch_cluster(k1a_cluster_kernel<T>, cluster,
                        stage_smem_bytes<T>(), stream, a,
                        static_cast<const T*>(le), static_cast<const T*>(re),
                        static_cast<T*>(g_out));
}

// The operands of a K1b launch: g [C, P, P] (passed to the kernel) is the
// reduced gradient; emit_y = 0 passes v0 through as Y (frozen bond).
// Scratch: workspace_floats(C, chi, d, 0).
template <class T>
inline K12Args<T> k1b_args(const void* lhs, const void* center0,
                           const void* v0, void* ws, int C, int chi, int d,
                           int forward, int emit_y, int q_iters, int qr,
                           int gd, float eta) {
  K12Args<T> a{};
  a.lhs = static_cast<const T*>(lhs);
  a.center0 = static_cast<const T*>(center0);
  a.v0 = static_cast<const T*>(v0);
  a.ws = static_cast<float*>(ws);
  a.Bb = 1;
  a.C = C;
  a.chi = chi;
  a.d = d;
  a.forward = forward;
  a.refresh = emit_y;
  a.q_iters = q_iters;
  a.qr = qr;
  a.gd = gd;
  a.eta = eta;
  return a;
}

template <class T>
inline int launch_k1b(const void* lhs, const void* center0, const void* g,
                      const void* v0, void* bt_out, void* y_out, void* ws,
                      int C, int chi, int d, int forward, int emit_y,
                      int q_iters, int qr, int gd, float eta, void* stream) {
  const K12Args<T> a = k1b_args<T>(lhs, center0, v0, ws, C, chi, d, forward,
                                   emit_y, q_iters, qr, gd, eta);
  k1b_kernel<T><<<1, kMaxThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const T*>(g), static_cast<T*>(bt_out),
      static_cast<T*>(y_out));
  return (int)cudaGetLastError();
}

// K1b (K1c-update) over one cluster of `cluster` blocks: K1b's operands.
template <class T>
inline int launch_k1b_cluster(const void* lhs, const void* center0,
                              const void* g, const void* v0, void* bt_out,
                              void* y_out, void* ws, int C, int chi, int d,
                              int forward, int emit_y, int q_iters, int qr,
                              int gd, float eta, int cluster, void* stream) {
  const K12Args<T> a = k1b_args<T>(lhs, center0, v0, ws, C, chi, d, forward,
                                   emit_y, q_iters, qr, gd, eta);
  return launch_cluster(k1b_cluster_kernel<T>, cluster,
                        bond_smem_bytes<T>(chi, d), stream, a,
                        static_cast<const T*>(g), static_cast<T*>(bt_out),
                        static_cast<T*>(y_out));
}

// K1-tail: bt [C, P, P] is a stepped bond tensor; q_iters power steps from
// v0 into y_out.  Scratch: workspace_floats(C, chi, d, 0).
template <class T>
inline K12Args<T> k1_tail_args(const void* v0, void* ws, int C, int chi,
                               int d, int forward, int q_iters, int qr) {
  K12Args<T> a{};
  a.v0 = static_cast<const T*>(v0);
  a.ws = static_cast<float*>(ws);
  a.Bb = 1;
  a.C = C;
  a.chi = chi;
  a.d = d;
  a.forward = forward;
  a.refresh = 1;
  a.q_iters = q_iters;
  a.qr = qr;
  return a;
}

template <class T>
inline int launch_k1_tail(const void* bt, const void* v0, void* y_out,
                          void* ws, int C, int chi, int d, int forward,
                          int q_iters, int qr, void* stream) {
  const K12Args<T> a =
      k1_tail_args<T>(v0, ws, C, chi, d, forward, q_iters, qr);
  k1_tail_kernel<T><<<1, kMaxThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const T*>(bt), static_cast<T*>(y_out));
  return (int)cudaGetLastError();
}

// K1-tail (K1c-tail) over a cooperative grid of `blocks` blocks: K1-tail's
// operands.  A grid larger than the card holds at once is refused by the
// launch (cudaErrorCooperativeLaunchTooLarge), never shrunk.
template <class T>
inline int launch_k1_tail_grid(const void* bt, const void* v0, void* y_out,
                               void* ws, int C, int chi, int d, int forward,
                               int q_iters, int qr, int blocks,
                               void* stream) {
  const K12Args<T> a =
      k1_tail_args<T>(v0, ws, C, chi, d, forward, q_iters, qr);
  return launch_grid(k1_tail_grid_kernel<T>, blocks,
                     bond_smem_bytes<T>(chi, d), stream, a,
                     static_cast<const T*>(bt),
                     static_cast<T*>(y_out));
}

// The operands of a K2-split launch.  Scratch: workspace_floats(C, chi, d,
// 0).
template <class T>
inline K12Args<T> k2_split_args(void* center_out, void* core_out, void* ws,
                                int C, int chi, int d, int forward,
                                float cutoff, float max_rank) {
  K12Args<T> a{};
  a.center_out = static_cast<T*>(center_out);
  a.core_out = static_cast<T*>(core_out);
  a.ws = static_cast<float*>(ws);
  a.Bb = 1;
  a.C = C;
  a.chi = chi;
  a.d = d;
  a.forward = forward;
  a.cutoff = cutoff;
  a.max_rank = max_rank;
  return a;
}

template <class T>
inline int launch_k2_split(const void* bt, const void* q, void* center_out,
                           void* core_out, void* qm_out, void* ws, int C,
                           int chi, int d, int forward, float cutoff,
                           float max_rank, void* stream) {
  const K12Args<T> a = k2_split_args<T>(center_out, core_out, ws, C, chi, d,
                                        forward, cutoff, max_rank);
  k2_split_kernel<T><<<1, kMaxThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const T*>(bt), static_cast<const T*>(q),
      static_cast<T*>(qm_out));
  return (int)cudaGetLastError();
}

// K2-split (K2c-split) over one cluster of `cluster` blocks: K2-split's
// operands.
template <class T>
inline int launch_k2_split_cluster(const void* bt, const void* q,
                                   void* center_out, void* core_out,
                                   void* qm_out, void* ws, int C, int chi,
                                   int d, int forward, float cutoff,
                                   float max_rank, int cluster,
                                   void* stream) {
  const K12Args<T> a = k2_split_args<T>(center_out, core_out, ws, C, chi, d,
                                        forward, cutoff, max_rank);
  return launch_cluster(k2_split_cluster_kernel<T>, cluster,
                        stage_smem_bytes<T>(), stream, a,
                        static_cast<const T*>(bt), static_cast<const T*>(q),
                        static_cast<T*>(qm_out));
}

// K2-env: env / env_ls / phi are the advancing side's environment,
// log-scales and features.  Scratch: workspace_floats(0, chi, d, N).
template <class T>
inline K12Args<T> k2_env_args(const void* env, const void* env_ls,
                              const void* phi, void* env_out, void* ls_out,
                              void* ws, int chi, int d, int N, int forward) {
  K12Args<T> a{};
  a.env0 = static_cast<const T*>(env);
  a.ls0 = static_cast<const float*>(env_ls);
  a.phil = static_cast<const T*>(phi);
  a.env_out = static_cast<T*>(env_out);
  a.ls_out = static_cast<float*>(ls_out);
  a.ws = static_cast<float*>(ws);
  a.Bb = 1;
  a.chi = chi;
  a.d = d;
  a.N = N;
  a.forward = forward;
  return a;
}

template <class T>
inline int launch_k2_env(const void* qm, const void* env, const void* env_ls,
                         const void* phi, void* env_out, void* ls_out,
                         void* ws, int chi, int d, int N, int forward,
                         void* stream) {
  const K12Args<T> a = k2_env_args<T>(env, env_ls, phi, env_out, ls_out, ws,
                                      chi, d, N, forward);
  k2_env_kernel<T><<<1, kMaxThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const T*>(qm));
  return (int)cudaGetLastError();
}

// The threads of a K2-env row tile of `rows` rows at bond width chi: one
// an output (rows * chi), in whole warps, at most kMaxThreads.
inline int k2_env_rows_threads(int rows, int chi) {
  const long outs = (long)rows * chi;
  return (int)(outs >= kMaxThreads ? kMaxThreads : (outs + 31) / 32 * 32);
}

// A staged K2-env block's dynamic shared memory: Qm [P, chi] and the kron
// factors L and R of its rows [rows, P].
template <class T>
inline long k2_env_rows_smem_bytes(int rows, int chi, int d) {
  const long P = (long)chi * d;
  return (P * chi + 2L * rows * P) * (long)sizeof(T);
}

// K2-env (K2c-env) over ceil(N / rows) independent blocks of `rows` rows
// each (the last one partial): K2-env's operands, the same workspace.  With
// `stage` set the blocks stage Qm and their factors in shared memory when
// they fit in the 48 KB a launch takes without an attribute (20 KB at
// float, 41 KB at cfloat at chi 25, 8 rows); otherwise, and with stage 0
// (for timing the two), they read both from global memory.
template <class T>
inline int launch_k2_env_rows(const void* qm, const void* env,
                              const void* env_ls, const void* phi,
                              void* env_out, void* ls_out, void* ws, int chi,
                              int d, int N, int forward, int rows, int stage,
                              void* stream) {
  if (rows < 1 || N < 1 || chi < 1) return (int)cudaErrorInvalidValue;
  const K12Args<T> a = k2_env_args<T>(env, env_ls, phi, env_out, ls_out, ws,
                                      chi, d, N, forward);
  const long smem = k2_env_rows_smem_bytes<T>(rows, chi, d);
  const dim3 grid((N + rows - 1) / rows);
  const dim3 block(k2_env_rows_threads(rows, chi));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stage && smem <= 48 * 1024)
    k2_env_rows_kernel<T, true><<<grid, block, smem, s>>>(
        a, static_cast<const T*>(qm), rows);
  else
    k2_env_rows_kernel<T, false><<<grid, block, 0, s>>>(
        a, static_cast<const T*>(qm), rows);
  return (int)cudaGetLastError();
}

}  // namespace mpst
