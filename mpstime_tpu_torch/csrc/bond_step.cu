// Fused DMRG bond step for NVIDIA Hopper (sm_90a): K12 and K12m.
//
// Replaces the Pallas TPU kernels _k12_kernel (mpstime_tpu/ops/pallas_bond.py,
// one bond step per launch) and _k12m_kernel (same file, Bb consecutive bond
// steps per launch with the center carried on chip).  One kernel serves both:
// K12 is the launch at Bb = 1 (with the MSE operand), K12m the launch at a
// runtime Bb, so the remainder block needs no second build and K12m equals
// chained K12 launches exactly.
//
// Per bond it computes: the bond tensor BT per class, yhat and the KLD or
// MSE gradient, a TSGO or GD step with renormalisation, q warm power steps
// each ending in a Newton-Schulz polar step (refresh bonds; frozen bonds
// split against the cached basis), the projection onto Q, the direction
// energies and the sort-free cutoff / rank mask, the emitted center and
// core, and the environment advance with its log-scale.
//
// What bounds it on this card: at the main-path shape (chi = 25, d = 5,
// C = 2, N = 100) a bond is a chain of ~12 M multiply-adds in some 80
// dependent phases (small matrix products, two block-wide reductions for
// ||G||^2 and ||BT||^2, fourteen Newton-Schulz steps per power step, an
// O(chi^2) mask).  It is latency-bound: far too little work per phase to
// fill 132 SMs, and each phase needs the previous one's result.
//
// What the design does about it: the whole block of bonds runs in ONE
// thread block, phases separated by __syncthreads(), so a block of 8 bonds
// costs one launch instead of hundreds of small library kernels.  BT and its
// gradient (2 x C*chi*d*d*chi floats, 250 KB at the main-path shape, more
// than a block's 227 KB of shared memory) live in a global workspace that
// stays resident in L2.  Arithmetic is plain f32 FMA (no TF32).  The
// block-wide sums use a fixed tree, so results are deterministic.  Spreading
// a bond over several SMs, wgmma and TMA are left for later work.
//
// C interface (ctypes): pointers as void*, the stream as a void* handle; the
// launch goes to the caller's current device and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "bond_step.cuh"

extern "C" {

long mpst_k12_workspace_floats(int C, int chi, int d, int N) {
  return mpst::workspace_floats(C, chi, d, N);
}

int mpst_k12m_launch(const void* lhs, const void* center0, const void* envx,
                     const void* env0, const void* ls0, const void* opp_ls,
                     const void* phil, const void* phir, const void* y1h,
                     const void* w, const void* v0, void* center_out,
                     void* core_out, void* env_out, void* ls_out, void* q_out,
                     void* ws, int Bb, int C, int chi, int d, int N,
                     int forward, int refresh, int q_iters, int mse, int gd,
                     float eta, float cutoff, float max_rank, void* stream) {
  mpst::K12Args a;
  a.lhs = static_cast<const float*>(lhs);
  a.center0 = static_cast<const float*>(center0);
  a.envx = static_cast<const float*>(envx);
  a.env0 = static_cast<const float*>(env0);
  a.ls0 = static_cast<const float*>(ls0);
  a.opp_ls = static_cast<const float*>(opp_ls);
  a.phil = static_cast<const float*>(phil);
  a.phir = static_cast<const float*>(phir);
  a.y1h = static_cast<const float*>(y1h);
  a.w = static_cast<const float*>(w);
  a.v0 = static_cast<const float*>(v0);
  a.center_out = static_cast<float*>(center_out);
  a.core_out = static_cast<float*>(core_out);
  a.env_out = static_cast<float*>(env_out);
  a.ls_out = static_cast<float*>(ls_out);
  a.q_out = static_cast<float*>(q_out);
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
  mpst::k12m_kernel<<<1, mpst::kMaxThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* mpst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
