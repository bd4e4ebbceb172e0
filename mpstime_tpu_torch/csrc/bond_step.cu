// Fused DMRG bond step for NVIDIA Hopper (sm_90a): K12 and K12m, the two
// halves K1 and K2 of the bond step around an outside QR, its four pieces
// K1a, K1b, K2-split and K2-env, and the stand-alone power step K1-tail.
//
// Replaces the Pallas TPU kernels _k12_kernel (mpstime_tpu/ops/pallas_bond.py,
// one bond step per launch) and _k12m_kernel (same file, Bb consecutive bond
// steps per launch with the center carried on chip).  One kernel serves both:
// K12 is the launch at Bb = 1 (with the MSE operand), K12m the launch at a
// runtime Bb, so the remainder block needs no second build and K12m equals
// chained K12 launches exactly.
//
// K1 and K2 replace _k1_kernel and _k2_kernel of the same file: the
// orth="qr" refresh bond runs K1 (bond tensor, gradient, step, q column-
// normalised power steps; BT and Y to device memory), a thin QR of Y in
// PyTorch, then K2 (projection, cutoff mask, emission, environment advance).
// They are built from the same device functions as K12, phase for phase, so
// the three cannot drift apart; K1 writes BT straight into its output.  At
// the main-path shape K1 is a chain of ~8.6 M multiply-adds and K2 of
// ~1.1 M, each over ~0.2 MB of operands: latency-bound like K12.  K1 and
// K2 run over a thread-block cluster (mpst_k1_cluster_launch and
// mpst_k2_cluster_launch, the wrappers' K1_CLUSTER and K2_CLUSTER blocks):
// k1_cluster_kernel and k2_cluster_kernel are k1_kernel's and k2_kernel's
// bodies, k1_body and k2_body, under ClusterTeam, the same bits, and
// mpst_k1_launch and mpst_k2_launch stay as their one-block references,
// which no route of the package launches.  K2's work is two products (the
// projection C*P*K*P and the advance N*K*P multiply-adds, 16 and 7 output
// tiles of 16 x 32 at the main-path shape) between elementwise phases
// (kron factors, energies, mask, emission, the per-sample renormalisation)
// that spread over the cluster's threads; mpst_k2_cluster_parts_launch runs
// a prefix of its four parts, so that the parts can be timed.
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
// launch, phases separated by a team barrier, so a block of 8 bonds costs
// one launch instead of hundreds of small library kernels.  K12 and K12m
// (mpst_k12m_cluster_launch, over the wrappers' K12M_CLUSTER blocks)
// run it over a thread-block cluster of up to 16 blocks of 512 threads:
// k12m_cluster_kernel is k12m_kernel's loop of bond steps under
// ClusterTeam, whose products deal 32 x 64 (or 16 x 32) output tiles to the
// blocks through shared memory and whose sums keep their 512 partials, so
// it computes the one-block kernel's bits.  Each power step's tail after
// its two products (the column norms, the revival, the fourteen
// Newton-Schulz steps on a [P, chi] iterate) is too small for sixteen SMs
// and was ~49 of those phases; it runs on block rank 0 alone, in its
// dynamic shared memory between __syncthreads() (leader_tail, polar_in_block:
// real bonds whose buffers fit), with one team barrier before and after.
// The one-block launcher, mpst_k12m_launch, stays as that reference; no
// route of the package launches it.  BT and its gradient (2 x
// C*chi*d*d*chi floats, 250 KB at the main-path shape, more than a block's
// 227 KB of shared memory) live in a global workspace that stays resident
// in L2.  Arithmetic is plain f32
// FMA (no TF32).  The sums use a fixed tree, so results are deterministic.
// wgmma and TMA are left for later work.
//
// K1a, K1b, K2-split and K2-env replace _k1_grad_kernel, _k1_update_kernel,
// _k2_split_kernel and _k2_env_kernel of the same file: the bond step of a
// data-parallel mesh (K1a on each shard, one sum of the gradients across
// shards, K1b -> QR -> K2-split on each replica, K2-env on each shard) and of
// the batch-tiled route (the same pieces over row tiles of one device).  They
// recompose K12's device functions: K1a is the bond tensor and the gradient
// half of k1_update, K1b the bond tensor, the step half against the summed
// gradient and the power step, K2-split the projection, mask and emission
// with the masked isometry Qm written out, K2-env the environment advance
// through Qm.  At the main-path shape (C = 2, chi = 25, d = 5, N = 100 per
// shard) K1a is ~7.1 M multiply-adds, K1b ~4.7 M with the Newton-Schulz
// power step, K2-split ~0.8 M and K2-env ~0.3 M: latency-bound like K12.
// K2-env runs over independent row tiles (below).  K1a, K1b and K2-split
// run over a
// thread-block cluster as K12m does (mpst_k1a_cluster_launch,
// mpst_k1b_cluster_launch and mpst_k2_split_cluster_launch, the wrappers'
// K1A_CLUSTER, K1B_CLUSTER and K2_SPLIT_CLUSTER blocks): K1a's work is
// almost all batch products (BT = core center, T1 = L BT [C, N, P],
// G = L^H U [C, P, P], each ~16 output tiles of 32 x 64), K1b's the bond
// tensor, the step's sums and the power step's products, whose
// Newton-Schulz tail runs on the leader block as K12m's, K2-split's the
// projection and the elementwise emission.  k1a_cluster_kernel,
// k1b_cluster_kernel and k2_split_cluster_kernel are k1a_kernel's,
// k1b_kernel's and k2_split_kernel's bodies under ClusterTeam, the same
// bits.  mpst_k1a_launch, mpst_k1b_launch and mpst_k2_split_launch stay as
// the one-block references; no route of the package launches them.  The gradient G [C, chi*d, d, chi] (250 KB) is
// the only operand that crosses devices.
//
// K1-tail replaces _k1_tail_kernel of the same file: the warm power step of
// the split-tail route (pallas_bond.py:1320-1372), where K1 or K1b runs with
// emit_y = 0 and power_iters K1-tail launches at q = 1 read the stored bond
// tensor back and carry the iterate from one to the next.  It is K1's power
// step (power_tail) over a read-only BT, with the revival and the
// Newton-Schulz polar under orth="ns" and column normalisation only under
// "qr", so a chain of q launches computes what K1's q in-kernel steps do.  At
// the main-path shape one step is ~1.6 M multiply-adds of the Gram
// application plus ~2.3 M of the Newton-Schulz polar (ns), over ~150 KB of
// operands (BT 125 KB, V0 and Y): latency-bound like the rest.  At the chi
// where the split-tail route runs (192-320) its products are large (one
// backward step at chi 256 ~1.7 G multiply-adds before the polar), more
// than a 16-block cluster fills.  So k1_tail_grid_kernel runs K1-tail's
// body over every block of a cooperative launch (GridTeam: the cluster
// kernels' L2-staged tiles and 512-partial sums, grid.sync() between the
// phases), as many as the card holds at once (132 at one block a SM; the
// wrapper's K1_TAIL_BLOCKS), launched by mpst_k1_tail_grid_launch; a grid
// past that is refused by the card (cudaErrorCooperativeLaunchTooLarge).
// It computes the one-block kernel's bits; mpst_k1_tail_launch stays as
// that reference, which no route launches.
//
// K2-env, the advance of a shard's environment through Qm, has no
// dependence between rows: each output row is its kron row times Qm (a
// chain over chi*d per element) and its own renormalisation.  So
// k2_env_rows_kernel runs ceil(N / rows) independent blocks (the wrapper's
// K2_ENV_ROWS rows each), K2-env's body on each tile with no barrier or sum
// between blocks, the same bits as the one-block k2_env_kernel
// (mpst_k2_env_launch, the reference no route launches).  Each block
// stages Qm and its rows' kron factors in shared memory where they fit in
// 48 KB, so the chains read shared memory, not L2.  At the dp shape (N 100,
// 13 tiles) it is bound by its dependent chains, not by its ~0.1 MB.
//
// C interface (ctypes): pointers as void*, the stream as a void* handle; the
// launch goes to the caller's current device and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "bond_step.cuh"

extern "C" {

long mpst_k12_workspace_floats(int C, int chi, int d, int N) {
  return mpst::workspace_floats<float>(C, chi, d, N);
}

int mpst_k12m_launch(const void* lhs, const void* center0, const void* envx,
                     const void* env0, const void* ls0, const void* opp_ls,
                     const void* phil, const void* phir, const void* y1h,
                     const void* w, const void* v0, void* center_out,
                     void* core_out, void* env_out, void* ls_out, void* q_out,
                     void* ws, int Bb, int C, int chi, int d, int N,
                     int forward, int refresh, int q_iters, int mse, int gd,
                     float eta, float cutoff, float max_rank, void* stream) {
  return mpst::launch_k12m<float>(
      lhs, center0, envx, env0, ls0, opp_ls, phil, phir, y1h, w, v0,
      center_out, core_out, env_out, ls_out, q_out, ws, Bb, C, chi, d, N,
      forward, refresh, q_iters, mse, gd, eta, cutoff, max_rank, stream);
}

// K12m (K12 at Bb = 1) over one cluster of `cluster` blocks:
// mpst_k12m_launch's arguments and the cluster size, the same bits.
// Scratch: mpst_k12_workspace_floats.
int mpst_k12m_cluster_launch(const void* lhs, const void* center0,
                             const void* envx, const void* env0,
                             const void* ls0, const void* opp_ls,
                             const void* phil, const void* phir,
                             const void* y1h, const void* w, const void* v0,
                             void* center_out, void* core_out, void* env_out,
                             void* ls_out, void* q_out, void* ws, int Bb,
                             int C, int chi, int d, int N, int forward,
                             int refresh, int q_iters, int mse, int gd,
                             float eta, float cutoff, float max_rank,
                             int cluster, void* stream) {
  return mpst::launch_k12m_cluster<float>(
      lhs, center0, envx, env0, ls0, opp_ls, phil, phir, y1h, w, v0,
      center_out, core_out, env_out, ls_out, q_out, ws, Bb, C, chi, d, N,
      forward, refresh, q_iters, mse, gd, eta, cutoff, max_rank, cluster,
      stream);
}

// How many clusters of `cluster` blocks of a real cluster kernel the card
// holds at once, into *n (0: it cannot place one): kernel 0 K12m (and K12,
// its Bb = 1), 1 K1a, 2 K1, 3 K1b, 4 K2, 5 K2-split; chi is unused.
// Returns the CUDA error
// of the query (cudaErrorInvalidValue for another kernel); bond_step_c.cu's
// mpst_c_cluster_occupancy answers for the complex ones.
int mpst_cluster_occupancy(int kernel, int cluster, int chi, int* n) {
  (void)chi;
  *n = 0;
  const long stage = mpst::stage_smem_bytes<float>();
  switch (kernel) {
    case 0:
      return mpst::cluster_occupancy(mpst::k12m_cluster_kernel<float>,
                                     cluster, stage, n);
    case 1:
      return mpst::cluster_occupancy(mpst::k1a_cluster_kernel<float>,
                                     cluster, stage, n);
    case 2:
      return mpst::cluster_occupancy(mpst::k1_cluster_kernel<float>,
                                     cluster, stage, n);
    case 3:
      return mpst::cluster_occupancy(mpst::k1b_cluster_kernel<float>,
                                     cluster, stage, n);
    case 4:
      return mpst::cluster_occupancy(mpst::k2_cluster_kernel<float>,
                                     cluster, stage, n);
    case 5:
      return mpst::cluster_occupancy(mpst::k2_split_cluster_kernel<float>,
                                     cluster, stage, n);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K1.  gls: [N] total log-scales (MSE only, else null); emit_y = 0 passes
// v0 through as Y (frozen bond).  Scratch: mpst_k12_workspace_floats.
int mpst_k1_launch(const void* lhs, const void* center0, const void* le,
                   const void* re, const void* gls, const void* phil,
                   const void* phir, const void* y1h, const void* w,
                   const void* v0, void* bt_out, void* y_out, void* ws, int C,
                   int chi, int d, int N, int forward, int emit_y,
                   int q_iters, int qr, int mse, int gd, float eta,
                   void* stream) {
  return mpst::launch_k1<float>(lhs, center0, le, re, gls, phil, phir, y1h,
                                w, v0, bt_out, y_out, ws, C, chi, d, N,
                                forward, emit_y, q_iters, qr, mse, gd, eta,
                                stream);
}

// K1 over one cluster of `cluster` blocks: mpst_k1_launch's arguments and
// the cluster size, the same bits (MSE and GD allowed, as K1 takes them).
// Scratch: mpst_k12_workspace_floats.
int mpst_k1_cluster_launch(const void* lhs, const void* center0,
                           const void* le, const void* re, const void* gls,
                           const void* phil, const void* phir,
                           const void* y1h, const void* w, const void* v0,
                           void* bt_out, void* y_out, void* ws, int C,
                           int chi, int d, int N, int forward, int emit_y,
                           int q_iters, int qr, int mse, int gd, float eta,
                           int cluster, void* stream) {
  return mpst::launch_k1_cluster<float>(
      lhs, center0, le, re, gls, phil, phir, y1h, w, v0, bt_out, y_out, ws,
      C, chi, d, N, forward, emit_y, q_iters, qr, mse, gd, eta, cluster,
      stream);
}

// K2.  env / env_ls / phi: the advancing side's environment, log-scales and
// features.  Scratch: mpst_k12_workspace_floats.
int mpst_k2_launch(const void* bt, const void* q, const void* env,
                   const void* env_ls, const void* phi, void* center_out,
                   void* core_out, void* env_out, void* ls_out, void* ws,
                   int C, int chi, int d, int N, int forward, float cutoff,
                   float max_rank, void* stream) {
  return mpst::launch_k2<float>(bt, q, env, env_ls, phi, center_out,
                                core_out, env_out, ls_out, ws, C, chi, d, N,
                                forward, cutoff, max_rank, stream);
}

// K2 over one cluster of `cluster` blocks: mpst_k2_launch's arguments and
// the cluster size, the same bits.  Scratch: mpst_k12_workspace_floats.
int mpst_k2_cluster_launch(const void* bt, const void* q, const void* env,
                           const void* env_ls, const void* phi,
                           void* center_out, void* core_out, void* env_out,
                           void* ls_out, void* ws, int C, int chi, int d,
                           int N, int forward, float cutoff, float max_rank,
                           int cluster, void* stream) {
  return mpst::launch_k2_cluster<float>(
      bt, q, env, env_ls, phi, center_out, core_out, env_out, ls_out, ws, C,
      chi, d, N, forward, cutoff, max_rank, 0, cluster, stream);
}

// The first `upto` (1-3) of the cluster K2's four parts (projection;
// energies and mask; emission; advance), for timing them by prefixes:
// mpst_k2_cluster_launch's arguments with upto before the cluster size.
// The outputs of the parts not run are left unwritten.
int mpst_k2_cluster_parts_launch(const void* bt, const void* q,
                                 const void* env, const void* env_ls,
                                 const void* phi, void* center_out,
                                 void* core_out, void* env_out, void* ls_out,
                                 void* ws, int C, int chi, int d, int N,
                                 int forward, float cutoff, float max_rank,
                                 int upto, int cluster, void* stream) {
  if (upto < 1) return (int)cudaErrorInvalidValue;
  return mpst::launch_k2_cluster<float>(
      bt, q, env, env_ls, phi, center_out, core_out, env_out, ls_out, ws, C,
      chi, d, N, forward, cutoff, max_rank, upto, cluster, stream);
}

// K1a.  gls: [N] total log-scales (MSE only, else null).  Scratch:
// mpst_k12_workspace_floats(C, chi, d, N).
int mpst_k1a_launch(const void* lhs, const void* center0, const void* le,
                    const void* re, const void* gls, const void* phil,
                    const void* phir, const void* y1h, const void* w,
                    void* g_out, void* ws, int C, int chi, int d, int N,
                    int forward, int mse, void* stream) {
  return mpst::launch_k1a<float>(lhs, center0, le, re, gls, phil, phir, y1h,
                                 w, g_out, ws, C, chi, d, N, forward, mse,
                                 stream);
}

// K1a over one cluster of `cluster` blocks: mpst_k1a_launch's arguments and
// the cluster size, the same bits (MSE allowed, as K1a takes it).  Scratch:
// mpst_k12_workspace_floats(C, chi, d, N).
int mpst_k1a_cluster_launch(const void* lhs, const void* center0,
                            const void* le, const void* re, const void* gls,
                            const void* phil, const void* phir,
                            const void* y1h, const void* w, void* g_out,
                            void* ws, int C, int chi, int d, int N,
                            int forward, int mse, int cluster,
                            void* stream) {
  return mpst::launch_k1a_cluster<float>(lhs, center0, le, re, gls, phil,
                                         phir, y1h, w, g_out, ws, C, chi, d,
                                         N, forward, mse, cluster, stream);
}

// K1b.  g: the reduced gradient [C, chi*d, d, chi].  Scratch:
// mpst_k12_workspace_floats(C, chi, d, 0).
int mpst_k1b_launch(const void* lhs, const void* center0, const void* g,
                    const void* v0, void* bt_out, void* y_out, void* ws,
                    int C, int chi, int d, int forward, int emit_y,
                    int q_iters, int qr, int gd, float eta, void* stream) {
  return mpst::launch_k1b<float>(lhs, center0, g, v0, bt_out, y_out, ws, C,
                                 chi, d, forward, emit_y, q_iters, qr, gd,
                                 eta, stream);
}

// K1b over one cluster of `cluster` blocks: mpst_k1b_launch's arguments and
// the cluster size, the same bits (GD allowed, as K1b takes it).  Scratch:
// mpst_k12_workspace_floats(C, chi, d, 0).
int mpst_k1b_cluster_launch(const void* lhs, const void* center0,
                            const void* g, const void* v0, void* bt_out,
                            void* y_out, void* ws, int C, int chi, int d,
                            int forward, int emit_y, int q_iters, int qr,
                            int gd, float eta, int cluster, void* stream) {
  return mpst::launch_k1b_cluster<float>(lhs, center0, g, v0, bt_out, y_out,
                                         ws, C, chi, d, forward, emit_y,
                                         q_iters, qr, gd, eta, cluster,
                                         stream);
}

// K1-tail.  bt: a stepped bond tensor [C, chi*d, d, chi]; q_iters power
// steps from v0 into y_out (qr = 1: column-normalised only).  Scratch:
// mpst_k12_workspace_floats(C, chi, d, 0).
int mpst_k1_tail_launch(const void* bt, const void* v0, void* y_out, void* ws,
                        int C, int chi, int d, int forward, int q_iters,
                        int qr, void* stream) {
  return mpst::launch_k1_tail<float>(bt, v0, y_out, ws, C, chi, d, forward,
                                     q_iters, qr, stream);
}

// K1-tail over a cooperative grid of `blocks` blocks: mpst_k1_tail_launch's
// arguments and the grid size, the same bits.  A grid past what the card
// holds at once (mpst_grid_occupancy) returns
// cudaErrorCooperativeLaunchTooLarge.  Scratch:
// mpst_k12_workspace_floats(C, chi, d, 0).
int mpst_k1_tail_grid_launch(const void* bt, const void* v0, void* y_out,
                             void* ws, int C, int chi, int d, int forward,
                             int q_iters, int qr, int blocks, void* stream) {
  return mpst::launch_k1_tail_grid<float>(bt, v0, y_out, ws, C, chi, d,
                                          forward, q_iters, qr, blocks,
                                          stream);
}

// How many blocks of a real grid kernel the card holds at once (the largest
// grid it launches), into *n: kernel 0 K1-tail.  Returns the CUDA error of
// the query (cudaErrorInvalidValue for another kernel); bond_step_c.cu's
// mpst_c_grid_occupancy answers for K1c-tail.
int mpst_grid_occupancy(int kernel, int* n) {
  *n = 0;
  if (kernel != 0) return (int)cudaErrorInvalidValue;
  return mpst::grid_occupancy(mpst::k1_tail_grid_kernel<float>,
                              mpst::stage_smem_bytes<float>(), n);
}

// K2-split.  Scratch: mpst_k12_workspace_floats(C, chi, d, 0).
int mpst_k2_split_launch(const void* bt, const void* q, void* center_out,
                         void* core_out, void* qm_out, void* ws, int C,
                         int chi, int d, int forward, float cutoff,
                         float max_rank, void* stream) {
  return mpst::launch_k2_split<float>(bt, q, center_out, core_out, qm_out,
                                      ws, C, chi, d, forward, cutoff,
                                      max_rank, stream);
}

// K2-split over one cluster of `cluster` blocks: mpst_k2_split_launch's
// arguments and the cluster size, the same bits.  Scratch:
// mpst_k12_workspace_floats(C, chi, d, 0).
int mpst_k2_split_cluster_launch(const void* bt, const void* q,
                                 void* center_out, void* core_out,
                                 void* qm_out, void* ws, int C, int chi,
                                 int d, int forward, float cutoff,
                                 float max_rank, int cluster, void* stream) {
  return mpst::launch_k2_split_cluster<float>(bt, q, center_out, core_out,
                                              qm_out, ws, C, chi, d, forward,
                                              cutoff, max_rank, cluster,
                                              stream);
}

// K2-env.  Scratch: mpst_k12_workspace_floats(0, chi, d, N).
int mpst_k2_env_launch(const void* qm, const void* env, const void* env_ls,
                       const void* phi, void* env_out, void* ls_out, void* ws,
                       int chi, int d, int N, int forward, void* stream) {
  return mpst::launch_k2_env<float>(qm, env, env_ls, phi, env_out, ls_out, ws,
                                    chi, d, N, forward, stream);
}

// K2-env over ceil(N / rows) independent blocks of `rows` rows each:
// mpst_k2_env_launch's arguments, the rows a block and whether to stage Qm
// and the kron factors in shared memory (where they fit), the same bits.
// Scratch: mpst_k12_workspace_floats(0, chi, d, N).
int mpst_k2_env_rows_launch(const void* qm, const void* env,
                            const void* env_ls, const void* phi,
                            void* env_out, void* ls_out, void* ws, int chi,
                            int d, int N, int forward, int rows,
                            int stage, void* stream) {
  return mpst::launch_k2_env_rows<float>(qm, env, env_ls, phi, env_out,
                                         ls_out, ws, chi, d, N, forward,
                                         rows, stage, stream);
}

const char* mpst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
