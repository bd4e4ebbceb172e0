// Device code of the fused DMRG bond step (K12) and its multi-bond block
// (K12m).  See bond_step.cu for what the kernel replaces and how it is
// bounded; this header holds the math, phase by phase.
//
// Layouts (all float32, row-major, contiguous):
//   lhs      [Bb, chi, d, chi]  the static core of each bond
//                              (backward: cores[j]; forward: cores[j+1])
//   center   [C, chi, d, chi]  the class-major two-site center
//   envx     [Bb, N, chi]      the opposite-side environment of each bond
//                              (backward: LE[j]; forward: RE[j+2])
//   env0/ls0 [N, chi] / [N]    the advancing environment entering the block
//   phil/phir [Bb, N, d]       conjugated site features of the two sites
//   y1h [N, C], w [N]          one-hot labels and per-sample weights
//   v0  [Bb, chi*d, chi]       the cached subspace of each bond
// With P = chi*d, the bond tensor of class c is BT[c] [P, P]: rows
// p = a*d + i (left bond a, left site i), columns q = k*chi + b (right site
// k, right bond b).  The subspace Q [P, chi] spans the q side going backward
// and the p side going forward.
//
// The code uses only __syncthreads() and shared memory, no warp intrinsics,
// and every loop is strided by blockDim.x, so one block of any power-of-two
// size up to kMaxThreads computes the same result.
#pragma once

namespace mpst {

constexpr int kMaxThreads = 512;
constexpr float kTiny = 1.17549435e-38f;     // FLT_MIN (finfo(float32).tiny)
constexpr float kNsA = 3.4445f, kNsB = -4.7750f, kNsC = 2.0315f;
constexpr int kNsQuintic = 8, kNsCubic = 6;
constexpr float kNsRevive = 1e-3f;

struct K12Args {
  const float* lhs;
  const float* center0;
  const float* envx;
  const float* env0;
  const float* ls0;
  const float* opp_ls;     // [N] opposite-side log-scales (MSE only)
  const float* phil;
  const float* phir;
  const float* y1h;
  const float* w;
  const float* v0;
  float* center_out;       // [C, chi, d, chi]
  float* core_out;         // [Bb, chi, d, chi]
  float* env_out;          // [Bb, N, chi]
  float* ls_out;           // [Bb, N]
  float* q_out;            // [Bb, chi*d, chi]
  float* ws;               // workspace_floats(C, chi, d, N)
  int Bb, C, chi, d, N;
  int forward, refresh, q_iters, mse, gd;
  float eta, cutoff, max_rank;
};

// Global scratch, carved from one workspace: the bond tensor and its
// gradient (2 x C*P*P), batch products, power-step and Newton-Schulz
// buffers.  It stays resident in L2 between the phases of a bond.
__host__ __device__ inline long workspace_floats(int C, int chi, int d, int N) {
  const long P = (long)chi * d, K = chi;
  return 2 * C * P * P          // BT, G
         + (long)C * N * P      // T1 / U
         + 2L * N * P           // L, R
         + 2L * N * C           // yhat, wc
         + (long)C * P * K      // MV / projected blocks
         + 3 * P * K            // Ya, Yb, Yc
         + 3 * K * K            // Gm, G2, Mq
         + 3 * K;               // wv, mask, nrm
}

struct Work {
  float *BT, *G, *T1, *L, *R, *yhat, *wc, *MV, *Ya, *Yb, *Yc, *Gm, *G2, *Mq,
      *wv, *mask, *nrm;
};

__device__ inline Work carve(float* ws, int C, int chi, int d, int N) {
  const long P = (long)chi * d, K = chi;
  Work w;
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
  w.wv = ws;            ws += K;
  w.mask = ws;          ws += K;
  w.nrm = ws;
  return w;
}

// A strided matrix view: element (b, r, c) at p[b*sb + r*sr + c*sc].
struct View {
  const float* p;
  long sb, sr, sc;
};

// out[b, m, n] = alpha * sum_k A[b, m, k] * B[b, k, n] + beta * src[b, m, n]
// (src shares out's strides and may be out itself).  One output element per
// thread, n fastest, so a warp reads B along n and broadcasts A.
__device__ inline void gemm(int batch, int M, int Nc, int Kd, View A, View B,
                            float* out, long ob, long orow, long ocol,
                            float alpha = 1.f, float beta = 0.f,
                            const float* src = nullptr) {
  const int total = batch * M * Nc;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int n = e % Nc;
    const int t = e / Nc;
    const int m = t % M;
    const int b = t / M;
    const float* a = A.p + b * A.sb + m * A.sr;
    const float* bb = B.p + b * B.sb + n * B.sc;
    float acc = 0.f;
    for (int k = 0; k < Kd; ++k) acc = fmaf(a[k * A.sc], bb[k * B.sr], acc);
    const long o = b * ob + m * orow + n * ocol;
    out[o] = (src != nullptr) ? alpha * acc + beta * src[o] : alpha * acc;
  }
}

// Deterministic block-wide sum (fixed tree over blockDim.x partials).
__device__ inline float block_sum(float v, float* red) {
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

// ---- K1 body: kron factors, bond tensor, yhat, gradient, step --------------

// L[n, a*d+i] = le[n,a] phil[n,i];  R[n, k*chi+b] = phir[n,k] re[n,b].
__device__ inline void kron_factors(const float* le, const float* re,
                                    const float* phil, const float* phir,
                                    Work w, int chi, int d, int N) {
  const int P = chi * d;
  for (int e = threadIdx.x; e < N * P; e += blockDim.x) {
    const int n = e / P, p = e % P;
    w.L[e] = le[n * chi + p / d] * phil[n * d + p % d];
    w.R[e] = phir[n * d + p / chi] * re[n * chi + p % chi];
  }
}

// BT[c] = X_c @ Y_c: backward X = core [P, chi], Y_c = center[c] [chi, P];
// forward X_c = center[c] [P, chi], Y = core [chi, P].
__device__ inline void bond_tensor(const float* core, const float* center,
                                   Work w, int C, int chi, int d,
                                   bool forward) {
  const long P = (long)chi * d;
  View X = forward ? View{center, P * chi, chi, 1} : View{core, 0, chi, 1};
  View Y = forward ? View{core, 0, P, 1} : View{center, chi * P, P, 1};
  gemm(C, P, P, chi, X, Y, w.BT, P * P, P, 1);
}

// yhat, the loss weights, the gradient and the optimiser step with
// post-normalisation; BT leaves updated in place.
__device__ inline void k1_update(const K12Args& a, const float* ls, Work w,
                                 float* red) {
  const int C = a.C, N = a.N;
  const long P = (long)a.chi * a.d, PP = P * P;
  // T1[c, n, q] = sum_p L[n,p] BT[c,p,q]
  gemm(C, N, P, P, View{w.L, 0, P, 1}, View{w.BT, PP, P, 1}, w.T1, N * P, P, 1);
  __syncthreads();
  // yhat[n, c] = sum_q T1[c,n,q] R[n,q]
  for (int e = threadIdx.x; e < N * C; e += blockDim.x) {
    const int n = e / C, c = e % C;
    const float* t = w.T1 + (c * (long)N + n) * P;
    const float* r = w.R + n * P;
    float acc = 0.f;
    for (int q = 0; q < P; ++q) acc = fmaf(t[q], r[q], acc);
    w.yhat[e] = acc;
  }
  __syncthreads();
  // per-sample, per-class weights (the KLD sign folded in)
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float* y1 = a.y1h + n * C;
    const float* yh = w.yhat + n * C;
    if (!a.mse) {
      float yt = 0.f;
      for (int c = 0; c < C; ++c) yt += yh[c] * y1[c];
      const float u = a.w[n] / yt;
      for (int c = 0; c < C; ++c) w.wc[n * C + c] = -(y1[c] * u);
    } else {
      const float s = expf(ls[n] + a.opp_ls[n]);
      const float ws = a.w[n] * s;
      for (int c = 0; c < C; ++c) w.wc[n * C + c] = (yh[c] * s - y1[c]) * ws;
    }
  }
  __syncthreads();
  // U[c, n, q] = R[n,q] wc[n,c]  (into T1)
  for (int e = threadIdx.x; e < C * N * P; e += blockDim.x) {
    const int q = e % P, n = (e / P) % N, c = e / (P * N);
    w.T1[e] = w.R[n * P + q] * w.wc[n * C + c];
  }
  __syncthreads();
  // G[c, p, q] = sum_n L[n,p] U[c,n,q]
  gemm(C, P, P, N, View{w.L, 0, 1, P}, View{w.T1, N * P, P, 1}, w.G, PP, P, 1);
  __syncthreads();
  float step = a.eta;
  if (!a.gd) {                       // TSGO: normalised-gradient step
    float part = 0.f;
    for (long e = threadIdx.x; e < C * PP; e += blockDim.x)
      part = fmaf(w.G[e], w.G[e], part);
    step = a.eta / sqrtf(fmaxf(block_sum(part, red), kTiny));
  }
  float part = 0.f;
  for (long e = threadIdx.x; e < C * PP; e += blockDim.x) {
    const float v = w.BT[e] - step * w.G[e];
    w.BT[e] = v;
    part = fmaf(v, v, part);
  }
  const float bn = 1.f / sqrtf(fmaxf(block_sum(part, red), kTiny));
  for (long e = threadIdx.x; e < C * PP; e += blockDim.x) w.BT[e] *= bn;
  __syncthreads();
}

// ---- warm power step with Newton-Schulz polar ------------------------------

// X <- polar(X) by 8 quintic + 6 cubic Newton-Schulz steps; X is the
// pre-scaled input in *x, *xn is scratch; returns the buffer holding the
// result.
__device__ inline float* ns_polar(float* x, float* xn, Work w, int P, int K) {
  for (int it = 0; it < kNsQuintic + kNsCubic; ++it) {
    const bool quintic = it < kNsQuintic;
    // Gm = X^T X
    gemm(1, K, K, P, View{x, 0, 1, K}, View{x, 0, K, 1}, w.Gm, 0, K, 1);
    __syncthreads();
    if (quintic) {
      gemm(1, K, K, K, View{w.Gm, 0, K, 1}, View{w.Gm, 0, K, 1}, w.G2, 0, K, 1);
      __syncthreads();
      for (int e = threadIdx.x; e < K * K; e += blockDim.x)
        w.Mq[e] = kNsB * w.Gm[e] + kNsC * w.G2[e];
      __syncthreads();
      // X' = a X + X (b G + c G^2)
      gemm(1, P, K, K, View{x, 0, K, 1}, View{w.Mq, 0, K, 1}, xn, 0, K, 1,
           1.f, kNsA, x);
    } else {
      // X' = 1.5 X - 0.5 X G
      gemm(1, P, K, K, View{x, 0, K, 1}, View{w.Gm, 0, K, 1}, xn, 0, K, 1,
           -0.5f, 1.5f, x);
    }
    __syncthreads();
    float* t = x; x = xn; xn = t;
  }
  return x;
}

// q warm power steps from v0 (subspace iteration: per-column normalisation,
// eps revival, NS polar each step).  Backward: Y <- sum_c BT_c^T BT_c Y;
// forward: Y <- sum_c BT_c BT_c^T Y.  Returns the orthonormal Q (in w.Ya).
__device__ inline const float* power_tail(const K12Args& a, const float* v0,
                                          Work w, float* red) {
  const int C = a.C, K = a.chi;
  const long P = (long)a.chi * a.d, PP = P * P;
  const float* yprev = v0;
  for (int it = 0; it < a.q_iters; ++it) {
    if (!a.forward) {
      // MV[c, p, j] = sum_q BT[c,p,q] Y[q,j]
      gemm(C, P, K, P, View{w.BT, PP, P, 1}, View{yprev, 0, K, 1}, w.MV,
           P * K, K, 1);
      __syncthreads();
      // Ynew[q, j] = sum_c sum_p BT[c,p,q] MV[c,p,j]  (class by class; the
      // same thread owns each element in every pass)
      for (int c = 0; c < C; ++c)
        gemm(1, P, K, P, View{w.BT + c * PP, 0, 1, P},
             View{w.MV + c * P * K, 0, K, 1}, w.Yb, 0, K, 1, 1.f,
             c ? 1.f : 0.f, c ? w.Yb : nullptr);
    } else {
      // MtU[c, q, j] = sum_p BT[c,p,q] Y[p,j]
      gemm(C, P, K, P, View{w.BT, PP, 1, P}, View{yprev, 0, K, 1}, w.MV,
           P * K, K, 1);
      __syncthreads();
      // Ynew[p, j] = sum_c sum_q BT[c,p,q] MtU[c,q,j]
      for (int c = 0; c < C; ++c)
        gemm(1, P, K, P, View{w.BT + c * PP, 0, P, 1},
             View{w.MV + c * P * K, 0, K, 1}, w.Yb, 0, K, 1, 1.f,
             c ? 1.f : 0.f, c ? w.Yb : nullptr);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < K; j += blockDim.x) {
      float s = 0.f;
      for (int r = 0; r < P; ++r) s = fmaf(w.Yb[r * K + j], w.Yb[r * K + j], s);
      w.nrm[j] = fmaxf(sqrtf(s), kTiny);
    }
    __syncthreads();
    // X = Ynew / ||col|| + eps * Yprev, then pre-scale by ||X||_F (1 + 1e-3)
    float part = 0.f;
    for (int e = threadIdx.x; e < P * K; e += blockDim.x) {
      const float v = w.Yb[e] / w.nrm[e % K] + kNsRevive * yprev[e];
      w.Yb[e] = v;
      part = fmaf(v, v, part);
    }
    const float grow = 1.f + 1e-3f;
    const float sc = 1.f / sqrtf(fmaxf(block_sum(part, red) * (grow * grow),
                                       kTiny));
    for (int e = threadIdx.x; e < P * K; e += blockDim.x) w.Yb[e] *= sc;
    __syncthreads();
    const float* y = ns_polar(w.Yb, w.Yc, w, P, K);
    for (int e = threadIdx.x; e < P * K; e += blockDim.x) w.Ya[e] = y[e];
    __syncthreads();
    yprev = w.Ya;
  }
  return yprev;
}

// ---- K2: projection, energies, cutoff mask, emission, env advance ---------

// Projected blocks into w.MV (backward [C, P, K], forward [C, K, P]) and the
// direction energies w.wv [K]; then the ITensor cutoff without a sort:
// direction i counts j toward its suffix iff w_j < w_i, or w_j == w_i and
// j >= i (the stable descending order), and is kept iff that suffix's
// energy exceeds cutoff * total, w_i > 0, and its sorted position is below
// max_rank (cnt_i > K - max_rank).
__device__ inline void project_mask(const K12Args& a, const float* Q, Work w) {
  const int C = a.C, K = a.chi;
  const long P = (long)a.chi * a.d, PP = P * P;
  if (!a.forward)
    gemm(C, P, K, P, View{w.BT, PP, P, 1}, View{Q, 0, K, 1}, w.MV, P * K, K, 1);
  else
    gemm(C, K, P, P, View{Q, 0, 1, K}, View{w.BT, PP, P, 1}, w.MV, K * P, P, 1);
  __syncthreads();
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    float wv = 0.f;
    for (int c = 0; c < C; ++c) {
      float s = 0.f;
      if (!a.forward) {
        for (int p = 0; p < P; ++p) {
          const float v = w.MV[(c * P + p) * K + j];
          s = fmaf(v, v, s);
        }
      } else {
        for (int q = 0; q < P; ++q) {
          const float v = w.MV[(c * K + j) * P + q];
          s = fmaf(v, v, s);
        }
      }
      wv += s;
    }
    w.wv[j] = wv;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
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
  __syncthreads();
}

// Emit the masked split factors in their final core layouts, the unmasked
// subspace cache, and the masked isometry Qm (into w.Yb).
__device__ inline void emit(const K12Args& a, const float* Q, float* core_out,
                            float* q_out, Work w) {
  const int C = a.C, K = a.chi;
  const long P = (long)a.chi * a.d;
  // backward center[c, a, i, m] = B[c, p, m] mask[m];
  // forward  center[c, m, k, b] = B[c, m, q] mask[m]
  for (long e = threadIdx.x; e < C * P * K; e += blockDim.x) {
    const int m = a.forward ? (int)((e / P) % K) : (int)(e % K);
    a.center_out[e] = w.MV[e] * w.mask[m];
  }
  for (long e = threadIdx.x; e < P * K; e += blockDim.x) {
    const int m = (int)(e % K);
    const float qm = Q[e] * w.mask[m];
    w.Yb[e] = qm;
    q_out[e] = Q[e];
    if (a.forward) {
      core_out[e] = qm;                       // U[a, i, m]
    } else {
      core_out[m * P + e / K] = qm;           // V[m, k, b] = Qm[(k, b), m]
    }
  }
  __syncthreads();
}

// env'[n, m] = sum_r F[n, r] Qm[r, m] with F = L forward, R backward; then
// per-sample renormalisation with log-scale accumulation.
__device__ inline void env_advance(const K12Args& a, const float* ls,
                                   float* env_out, float* ls_out, Work w) {
  const int N = a.N, K = a.chi;
  const long P = (long)a.chi * a.d;
  const float* F = a.forward ? w.L : w.R;
  gemm(1, N, K, P, View{F, 0, P, 1}, View{w.Yb, 0, K, 1}, env_out, 0, K, 1);
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float s = 0.f;
    for (int m = 0; m < K; ++m) s = fmaf(env_out[n * K + m], env_out[n * K + m], s);
    const float nrm = sqrtf(s);
    const float safe = fmaxf(nrm, kTiny);
    const float div = nrm > 0.f ? safe : 1.f;
    for (int m = 0; m < K; ++m) env_out[n * K + m] /= div;
    ls_out[n] = ls[n] + (nrm > 0.f ? logf(safe) : 0.f);
  }
  __syncthreads();
}

// Bb consecutive bond steps in one block; the center, environment and
// log-scales carry from bond to bond through the outputs.
__global__ void __launch_bounds__(kMaxThreads) k12m_kernel(K12Args a) {
  __shared__ float red[kMaxThreads];
  const int chi = a.chi, d = a.d, N = a.N;
  const long P = (long)chi * d;
  Work w = carve(a.ws, a.C, chi, d, N);
  const float* env = a.env0;
  const float* ls = a.ls0;
  const float* center = a.center0;
  for (int b = 0; b < a.Bb; ++b) {
    const float* core = a.lhs + b * P * chi;
    const float* envx = a.envx + (long)b * N * chi;
    const float* v0 = a.v0 + b * P * chi;
    float* env_out = a.env_out + (long)b * N * chi;
    float* ls_out = a.ls_out + (long)b * N;
    kron_factors(a.forward ? env : envx, a.forward ? envx : env,
                 a.phil + (long)b * N * d, a.phir + (long)b * N * d, w, chi,
                 d, N);
    bond_tensor(core, center, w, a.C, chi, d, a.forward);
    __syncthreads();
    k1_update(a, ls, w, red);
    const float* Q = a.refresh ? power_tail(a, v0, w, red) : v0;
    project_mask(a, Q, w);
    emit(a, Q, a.core_out + b * P * chi, a.q_out + b * P * chi, w);
    env_advance(a, ls, env_out, ls_out, w);
    env = env_out;
    ls = ls_out;
    center = a.center_out;
  }
}

}  // namespace mpst
