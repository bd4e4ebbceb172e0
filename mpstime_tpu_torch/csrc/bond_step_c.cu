// Complex (complex64) fused DMRG bond step for NVIDIA Hopper (sm_90a): K12c
// and K12mc, the two halves K1c and K2c of the bond step around an outside
// QR, the tracked-ritz bond step K12cr, the four pieces K1c-grad,
// K1c-update, K2c-split and K2c-env of the data-parallel and batch-tiled
// bond step, and the stand-alone power step K1c-tail.
//
// Replaces the Pallas TPU kernels of mpstime_tpu/ops/pallas_bond_c.py:
// _k12c_kernel (one complex bond step), _k12mc_kernel (Bb <= 4 consecutive
// complex bond steps with the center carried on chip), _k1c_kernel and
// _k2c_kernel (the orth="qr" refresh bond: K1c, a QR of the realified Y in
// PyTorch, then K2c), and _k12cr_kernel (one bond of the ritz route's
// Jacobi-rotated sweeps).  Mosaic has no complex type, so the TPU kernels
// carry every operand as a (re, im) pair of f32 arrays and expand each
// complex product into four real ones.  Here the operands stay torch.complex64
// tensors, read interleaved as cfloat, and the kernels are the real
// kernels' device functions (bond_step.cuh) instantiated at cfloat: no
// second copy of the math.  They cover
// what the TPU kernels cover: KLD loss, TSGO step, one update iteration,
// Newton-Schulz refresh (or the column-normalised iterate for an outside
// QR), frozen bonds, and the runtime max_rank cap.
//
// K1c-grad, K1c-update, K2c-split and K2c-env replace _k1c_grad_kernel,
// _k1c_update_kernel, _k2c_split_kernel and _k2c_env_kernel of the same
// file: the complex bond step of a data-parallel mesh and of the batch-tiled
// route (K1c-grad per shard or tile, one sum of the gradients, K1c-update ->
// the realified QR under orth="qr" -> K2c-split once per replica, K2c-env
// per shard or tile).  They are the real pieces' kernels (k1a_kernel,
// k1b_kernel, k2_split_kernel, k2_env_kernel) at cfloat, so one shard
// computes K12c's (ns) and K1c -> QR -> K2c's (qr) arithmetic in the same
// order.  At the complex main-path shape (N = 100 per shard, q = 3, ns)
// K1c-grad is ~7.1 M complex multiply-adds, almost all batch products, and
// K1c-update ~13 M (three power steps of fourteen Newton-Schulz steps each,
// ~150 dependent phases), both run over a cluster (see below).  The
// gradient G (C*chi*d*d*chi complex values, 500 KB) is the one operand that
// crosses devices.
//
// K1c-tail replaces _k1c_tail_kernel of the same file (_k1c_power,
// pallas_bond_c.py:250-317): the complex split-tail route runs K1c or
// K1c-update with emit_y = 0, then power_iters K1c-tail launches at q = 1
// over the stored bond tensor.  It is k1_tail_kernel at cfloat, power_tail
// over a read-only BT, and accepts orth "ns" and "qr" only (no tail call of
// the JAX package passes "tri").  At the complex main-path shape one step is
// ~1.6 M complex multiply-adds of the Gram application plus ~2.3 M of the
// Newton-Schulz polar (ns), over ~300 KB of operands (BT 250 KB, V0 and Y).
// It runs over a cooperative grid (k1_tail_grid_kernel at cfloat,
// mpst_k1c_tail_grid_launch, the wrapper's K1C_TAIL_BLOCKS), and K2c-env
// over independent row tiles (k2_env_rows_kernel at cfloat,
// mpst_k2c_env_rows_launch, K2C_ENV_ROWS rows a block), as bond_step.cu
// says of the real ones; mpst_k1c_tail_launch and mpst_k2c_env_launch stay
// as their one-block references.
//
// K12cr is the same device code around three more phases
// (bond_step.cuh): the power step orthonormalised by damped triangular
// Newton (the QR gauge, no Householder factorisation), the Ritz Gram
// S [chi, chi] of the projected blocks, and odd-even Jacobi rounds that
// rotate two rows and columns of S and two columns of W per adjacent pair;
// the mask, the emission through the rotation and the env advance follow.
// At the ritz cell (C = 2, chi = 64, d = 5, N = 100, q = 1, 6 rounds) a
// bond is ~125 M complex multiply-adds.
//
// What bounds them on this card: at the complex main-path shape (C = 2,
// chi = 25, d = 5, N = 100, q = 3) a refresh bond is a chain of ~20 M
// complex multiply-adds (four real ones each) in ~170 dependent phases (the
// batch products, q power steps of fourteen Newton-Schulz steps each, the
// projection, the mask).  On one thread block (the one-block references)
// every
// phase is latency-bound on one SM of 132, its products reading both
// operands from L1/L2 per multiply-add.  BT and its gradient
// (2 x C*chi*d*d*chi complex values, 500 KB) live in the L2-resident global
// workspace.  Arithmetic is plain f32 FMA; the block sums use a fixed tree,
// so results are deterministic.
//
// K12c and K12cr (the two kernels with the most time lost, PERF.md) run one
// bond over a thread-block cluster of up to 16 blocks of 512 threads (the
// wrapper's CLUSTER), launched with cudaLaunchKernelEx: ClusterTeam deals
// each product's 32 x 64 (or 16 x 32) output tiles to the blocks, which
// stage the operands' K-chunks in shared memory through L2 (the next
// chunk's loads in flight during this one's products) and keep 2 x 2
// (1 x 1) register micro-tiles; the cluster barrier separates the phases;
// the TSGO, renormalisation, pre-scale and tri-Newton sums keep their 512
// partials, so both compute the one-block kernels' bits (K12c equals K12mc
// at Bb = 1).  K12cr's Jacobi rounds, O(chi) work a round, run on the
// leader block alone with S and W in its dynamic shared memory (2 x 32 KB
// at chi 64; the workspace past 200 KB).  They replace the one-block K12c
// (k12m_kernel at Bb = 1) and K12cr of PRs 3-4 (2.291 ms and 13.494 ms a
// bond, PERF.md).  A cluster the card cannot place is refused at launch and
// raised by the wrapper; nothing falls back to one block.  Still bounding
// them: the dependent chain of phases (a cluster barrier and a tile staging
// through L2 each) and the products' sequential K chains, kept for the
// bits.  A Newton-Schulz step is two phases: Gm = X^H X, then every block
// forms Mq from Gm in its own shared memory and updates its rows of X
// (team_update), the last step writing Ya.  The real kernels' leader-block
// tail (bond_step.cu) is not taken here: one SM took longer for the four
// times as many multiply-adds (116-125 us a power step at chi 25) than
// the team's phases.
//
// K1c and K1c-update run the same way (mpst_k1c_cluster_launch,
// mpst_k1c_update_cluster_launch, with the wrappers' K1C_CLUSTER and
// K1C_UPDATE_CLUSTER): k1_cluster_kernel and k1b_cluster_kernel are K1's and
// K1b's bodies under ClusterTeam, so a fourier qr refresh bond's K1c (~30
// phases, its batch products C*N*P^2 ~3.1 M complex multiply-adds each) and
// a complex dp bond's K1c-update (~150 phases) spread their products over
// the cluster's SMs.  Their one-block launchers, mpst_k1c_launch and
// mpst_k1c_update_launch, stay as the reference the cluster kernels are
// held against bit for bit; no route of the package launches them.  So does
// K1c-grad (mpst_k1c_grad_cluster_launch, the wrapper's K1C_GRAD_CLUSTER):
// k1a_cluster_kernel at cfloat spreads its three batch products (C*N*P^2
// and C*P^2*chi complex multiply-adds, ~16 output tiles each) over the
// cluster's SMs; mpst_k1c_grad_launch stays as its one-block reference.
//
// K2c and K2c-split run the same way (mpst_k2c_cluster_launch,
// mpst_k2c_split_cluster_launch, the wrappers' K2C_CLUSTER and
// K2C_SPLIT_CLUSTER): k2_cluster_kernel and k2_split_cluster_kernel at
// cfloat are K2's and K2-split's bodies under ClusterTeam, so the
// projection (C*P*K*P complex multiply-adds, 16 output tiles of 16 x 32 at
// the main-path shape), the advance (N*K*P, 7 tiles) and the elementwise
// emission of a fourier qr refresh bond or a complex dp bond spread over
// the cluster's SMs.  mpst_k2c_launch and mpst_k2c_split_launch stay as
// their one-block references; mpst_k2c_cluster_parts_launch runs a prefix
// of K2c's four parts, so that the parts can be timed.
//
// K12mc runs the same way too (mpst_k12mc_cluster_launch, the wrapper's
// K12MC_CLUSTER): k12m_cluster_kernel at cfloat is the one-block
// k12m_kernel's loop of Bb bond steps under ClusterTeam, the center,
// environment and log-scales carried from bond to bond through the outputs
// behind a cluster barrier, so a frozen block of 4 bonds of the fourier qr
// fit spreads over the cluster's SMs.  mpst_k12mc_launch stays as its
// one-block reference.  At Bb = 1 it computes K12c's bits, but slower a
// bond than k12c_kernel (bond_step.cuh), so K12c keeps its own.
//
// C interface (ctypes): pointers as void*, the stream as a void* handle; the
// launch goes to the caller's current device and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "bond_step.cuh"

using mpst::cfloat;

extern "C" {

long mpst_c_workspace_floats(int C, int chi, int d, int N) {
  return mpst::workspace_floats<cfloat>(C, chi, d, N);
}

// K12mc (K12c at Bb = 1).  The argument lists are the real launchers', so
// one host wrapper per kernel serves both; the complex kernels take KLD +
// TSGO only and refuse mse or gd (opp_ls and gls are unused).
int mpst_k12mc_launch(const void* lhs, const void* center0, const void* envx,
                      const void* env0, const void* ls0, const void* opp_ls,
                      const void* phil, const void* phir, const void* y1h,
                      const void* w, const void* v0, void* center_out,
                      void* core_out, void* env_out, void* ls_out,
                      void* q_out, void* ws, int Bb, int C, int chi, int d,
                      int N, int forward, int refresh, int q_iters, int mse,
                      int gd, float eta, float cutoff, float max_rank,
                      void* stream) {
  if (mse || gd) return (int)cudaErrorInvalidValue;
  return mpst::launch_k12m<cfloat>(
      lhs, center0, envx, env0, ls0, nullptr, phil, phir, y1h, w, v0,
      center_out, core_out, env_out, ls_out, q_out, ws, Bb, C, chi, d, N,
      forward, refresh, q_iters, 0, 0, eta, cutoff, max_rank, stream);
}

// K12mc over one cluster of `cluster` blocks: mpst_k12mc_launch's
// arguments and the cluster size, the same bits (KLD + TSGO).  Scratch:
// mpst_c_workspace_floats.
int mpst_k12mc_cluster_launch(const void* lhs, const void* center0,
                              const void* envx, const void* env0,
                              const void* ls0, const void* opp_ls,
                              const void* phil, const void* phir,
                              const void* y1h, const void* w, const void* v0,
                              void* center_out, void* core_out,
                              void* env_out, void* ls_out, void* q_out,
                              void* ws, int Bb, int C, int chi, int d, int N,
                              int forward, int refresh, int q_iters, int mse,
                              int gd, float eta, float cutoff, float max_rank,
                              int cluster, void* stream) {
  (void)opp_ls;
  if (mse || gd) return (int)cudaErrorInvalidValue;
  return mpst::launch_k12m_cluster<cfloat>(
      lhs, center0, envx, env0, ls0, nullptr, phil, phir, y1h, w, v0,
      center_out, core_out, env_out, ls_out, q_out, ws, Bb, C, chi, d, N,
      forward, refresh, q_iters, 0, 0, eta, cutoff, max_rank, cluster,
      stream);
}

// K1c: emit_y = 0 passes v0 through as Y (frozen bond); qr = 1 leaves Y
// column-normalised for the caller's QR.  Scratch: mpst_c_workspace_floats.
int mpst_k1c_launch(const void* lhs, const void* center0, const void* le,
                    const void* re, const void* gls, const void* phil,
                    const void* phir, const void* y1h, const void* w,
                    const void* v0, void* bt_out, void* y_out, void* ws,
                    int C, int chi, int d, int N, int forward, int emit_y,
                    int q_iters, int qr, int mse, int gd, float eta,
                    void* stream) {
  if (mse || gd) return (int)cudaErrorInvalidValue;
  return mpst::launch_k1<cfloat>(lhs, center0, le, re, nullptr, phil, phir,
                                 y1h, w, v0, bt_out, y_out, ws, C, chi, d, N,
                                 forward, emit_y, q_iters, qr, 0, 0, eta,
                                 stream);
}

// K1c over one cluster of `cluster` blocks: mpst_k1c_launch's arguments and
// the cluster size, the same bits.  Scratch: mpst_c_workspace_floats.
int mpst_k1c_cluster_launch(const void* lhs, const void* center0,
                            const void* le, const void* re, const void* gls,
                            const void* phil, const void* phir,
                            const void* y1h, const void* w, const void* v0,
                            void* bt_out, void* y_out, void* ws, int C,
                            int chi, int d, int N, int forward, int emit_y,
                            int q_iters, int qr, int mse, int gd, float eta,
                            int cluster, void* stream) {
  if (mse || gd) return (int)cudaErrorInvalidValue;
  return mpst::launch_k1_cluster<cfloat>(
      lhs, center0, le, re, nullptr, phil, phir, y1h, w, v0, bt_out, y_out,
      ws, C, chi, d, N, forward, emit_y, q_iters, qr, 0, 0, eta, cluster,
      stream);
}

// K2c.  Scratch: mpst_c_workspace_floats.
int mpst_k2c_launch(const void* bt, const void* q, const void* env,
                    const void* env_ls, const void* phi, void* center_out,
                    void* core_out, void* env_out, void* ls_out, void* ws,
                    int C, int chi, int d, int N, int forward, float cutoff,
                    float max_rank, void* stream) {
  return mpst::launch_k2<cfloat>(bt, q, env, env_ls, phi, center_out,
                                 core_out, env_out, ls_out, ws, C, chi, d, N,
                                 forward, cutoff, max_rank, stream);
}

// K2c over one cluster of `cluster` blocks: mpst_k2c_launch's arguments and
// the cluster size, the same bits.  Scratch: mpst_c_workspace_floats.
int mpst_k2c_cluster_launch(const void* bt, const void* q, const void* env,
                            const void* env_ls, const void* phi,
                            void* center_out, void* core_out, void* env_out,
                            void* ls_out, void* ws, int C, int chi, int d,
                            int N, int forward, float cutoff, float max_rank,
                            int cluster, void* stream) {
  return mpst::launch_k2_cluster<cfloat>(
      bt, q, env, env_ls, phi, center_out, core_out, env_out, ls_out, ws, C,
      chi, d, N, forward, cutoff, max_rank, 0, cluster, stream);
}

// The first `upto` (1-3) of the cluster K2c's four parts, for timing them
// by prefixes: mpst_k2c_cluster_launch's arguments with upto before the
// cluster size (bond_step.cu's mpst_k2_cluster_parts_launch at cfloat).
int mpst_k2c_cluster_parts_launch(const void* bt, const void* q,
                                  const void* env, const void* env_ls,
                                  const void* phi, void* center_out,
                                  void* core_out, void* env_out,
                                  void* ls_out, void* ws, int C, int chi,
                                  int d, int N, int forward, float cutoff,
                                  float max_rank, int upto, int cluster,
                                  void* stream) {
  if (upto < 1) return (int)cudaErrorInvalidValue;
  return mpst::launch_k2_cluster<cfloat>(
      bt, q, env, env_ls, phi, center_out, core_out, env_out, ls_out, ws, C,
      chi, d, N, forward, cutoff, max_rank, upto, cluster, stream);
}

// K12c: K12mc's argument list at Bb = 1 over one cluster of `cluster`
// blocks (KLD + TSGO).  Scratch: mpst_c_workspace_floats.
int mpst_k12c_launch(const void* lhs, const void* center0, const void* envx,
                     const void* env0, const void* ls0, const void* opp_ls,
                     const void* phil, const void* phir, const void* y1h,
                     const void* w, const void* v0, void* center_out,
                     void* core_out, void* env_out, void* ls_out, void* q_out,
                     void* ws, int Bb, int C, int chi, int d, int N,
                     int forward, int refresh, int q_iters, int mse, int gd,
                     float eta, float cutoff, float max_rank, int cluster,
                     void* stream) {
  (void)opp_ls;
  if (Bb != 1 || mse || gd) return (int)cudaErrorInvalidValue;
  return mpst::launch_k12c<cfloat>(
      lhs, center0, envx, env0, ls0, phil, phir, y1h, w, v0, center_out,
      core_out, env_out, ls_out, q_out, ws, C, chi, d, N, forward, refresh,
      q_iters, eta, cutoff, max_rank, cluster, stream);
}

// K12cr: K12mc's argument list at Bb = 1 (KLD + TSGO; the refresh is always
// tri-Newton) plus the Jacobi round count, over one cluster of `cluster`
// blocks.  Scratch: mpst_c_workspace_floats.
int mpst_k12cr_launch(const void* lhs, const void* center0, const void* envx,
                      const void* env0, const void* ls0, const void* opp_ls,
                      const void* phil, const void* phir, const void* y1h,
                      const void* w, const void* v0, void* center_out,
                      void* core_out, void* env_out, void* ls_out,
                      void* q_out, void* ws, int Bb, int C, int chi, int d,
                      int N, int forward, int refresh, int q_iters, int mse,
                      int gd, float eta, float cutoff, float max_rank,
                      int rounds, int cluster, void* stream) {
  (void)opp_ls;
  if (Bb != 1 || mse || gd || rounds < 0) return (int)cudaErrorInvalidValue;
  return mpst::launch_k12cr<cfloat>(
      lhs, center0, envx, env0, ls0, phil, phir, y1h, w, v0, center_out,
      core_out, env_out, ls_out, q_out, ws, C, chi, d, N, forward, refresh,
      q_iters, eta, cutoff, max_rank, rounds, cluster, stream);
}

// How many clusters of `cluster` blocks of a complex cluster kernel at bond
// width chi the card holds at once, into *n (0: it cannot place one):
// kernel 0 K12c, 1 K12cr, 2 K1c, 3 K1c-update, 4 K12mc, 5 K1c-grad, 6 K2c,
// 7 K2c-split.
// Returns the CUDA error of the query (cudaErrorInvalidValue for another
// kernel); bond_step.cu's mpst_cluster_occupancy answers for the real ones.
int mpst_c_cluster_occupancy(int kernel, int cluster, int chi, int* n) {
  *n = 0;
  const long stage = mpst::stage_smem_bytes<cfloat>();
  switch (kernel) {
    case 0:
      return mpst::cluster_occupancy(mpst::k12c_kernel<cfloat>, cluster,
                                     stage, n);
    case 1:
      return mpst::cluster_occupancy(mpst::k12cr_kernel<cfloat>, cluster,
                                     mpst::k12cr_smem_bytes<cfloat>(chi), n);
    case 2:
      return mpst::cluster_occupancy(mpst::k1_cluster_kernel<cfloat>,
                                     cluster, stage, n);
    case 3:
      return mpst::cluster_occupancy(mpst::k1b_cluster_kernel<cfloat>,
                                     cluster, stage, n);
    case 4:
      return mpst::cluster_occupancy(mpst::k12m_cluster_kernel<cfloat>,
                                     cluster, stage, n);
    case 5:
      return mpst::cluster_occupancy(mpst::k1a_cluster_kernel<cfloat>,
                                     cluster, stage, n);
    case 6:
      return mpst::cluster_occupancy(mpst::k2_cluster_kernel<cfloat>,
                                     cluster, stage, n);
    case 7:
      return mpst::cluster_occupancy(mpst::k2_split_cluster_kernel<cfloat>,
                                     cluster, stage, n);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K1c-grad (K1a at complex64): this shard's (or tile's) KLD gradient of
// the bond tensor into g_out [C, chi*d, d, chi], the KLD sign included.
// Scratch: mpst_c_workspace_floats(C, chi, d, N).
int mpst_k1c_grad_launch(const void* lhs, const void* center0, const void* le,
                         const void* re, const void* gls, const void* phil,
                         const void* phir, const void* y1h, const void* w,
                         void* g_out, void* ws, int C, int chi, int d, int N,
                         int forward, int mse, void* stream) {
  (void)gls;
  if (mse) return (int)cudaErrorInvalidValue;
  return mpst::launch_k1a<cfloat>(lhs, center0, le, re, nullptr, phil, phir,
                                  y1h, w, g_out, ws, C, chi, d, N, forward, 0,
                                  stream);
}

// K1c-grad over one cluster of `cluster` blocks: mpst_k1c_grad_launch's
// arguments and the cluster size, the same bits (KLD only).  Scratch:
// mpst_c_workspace_floats(C, chi, d, N).
int mpst_k1c_grad_cluster_launch(const void* lhs, const void* center0,
                                 const void* le, const void* re,
                                 const void* gls, const void* phil,
                                 const void* phir, const void* y1h,
                                 const void* w, void* g_out, void* ws, int C,
                                 int chi, int d, int N, int forward, int mse,
                                 int cluster, void* stream) {
  (void)gls;
  if (mse) return (int)cudaErrorInvalidValue;
  return mpst::launch_k1a_cluster<cfloat>(lhs, center0, le, re, nullptr,
                                          phil, phir, y1h, w, g_out, ws, C,
                                          chi, d, N, forward, 0, cluster,
                                          stream);
}

// K1c-update (K1b at complex64): the TSGO step against the summed gradient
// g, then the q-step power iterate (qr = 1: column-normalised only) into
// y_out, or v0 for a frozen bond (emit_y = 0).  Scratch:
// mpst_c_workspace_floats(C, chi, d, 0).
int mpst_k1c_update_launch(const void* lhs, const void* center0,
                           const void* g, const void* v0, void* bt_out,
                           void* y_out, void* ws, int C, int chi, int d,
                           int forward, int emit_y, int q_iters, int qr,
                           int gd, float eta, void* stream) {
  if (gd) return (int)cudaErrorInvalidValue;
  return mpst::launch_k1b<cfloat>(lhs, center0, g, v0, bt_out, y_out, ws, C,
                                  chi, d, forward, emit_y, q_iters, qr, 0,
                                  eta, stream);
}

// K1c-update over one cluster of `cluster` blocks: mpst_k1c_update_launch's
// arguments and the cluster size, the same bits.  Scratch:
// mpst_c_workspace_floats(C, chi, d, 0).
int mpst_k1c_update_cluster_launch(const void* lhs, const void* center0,
                                   const void* g, const void* v0,
                                   void* bt_out, void* y_out, void* ws, int C,
                                   int chi, int d, int forward, int emit_y,
                                   int q_iters, int qr, int gd, float eta,
                                   int cluster, void* stream) {
  if (gd) return (int)cudaErrorInvalidValue;
  return mpst::launch_k1b_cluster<cfloat>(lhs, center0, g, v0, bt_out, y_out,
                                          ws, C, chi, d, forward, emit_y,
                                          q_iters, qr, 0, eta, cluster,
                                          stream);
}

// K2c-split (K2-split at complex64): the center, the core (backward:
// Qm^H) and the masked isometry Qm.  Scratch:
// mpst_c_workspace_floats(C, chi, d, 0).
int mpst_k2c_split_launch(const void* bt, const void* q, void* center_out,
                          void* core_out, void* qm_out, void* ws, int C,
                          int chi, int d, int forward, float cutoff,
                          float max_rank, void* stream) {
  return mpst::launch_k2_split<cfloat>(bt, q, center_out, core_out, qm_out,
                                       ws, C, chi, d, forward, cutoff,
                                       max_rank, stream);
}

// K2c-split over one cluster of `cluster` blocks: mpst_k2c_split_launch's
// arguments and the cluster size, the same bits.  Scratch:
// mpst_c_workspace_floats(C, chi, d, 0).
int mpst_k2c_split_cluster_launch(const void* bt, const void* q,
                                  void* center_out, void* core_out,
                                  void* qm_out, void* ws, int C, int chi,
                                  int d, int forward, float cutoff,
                                  float max_rank, int cluster,
                                  void* stream) {
  return mpst::launch_k2_split_cluster<cfloat>(bt, q, center_out, core_out,
                                               qm_out, ws, C, chi, d,
                                               forward, cutoff, max_rank,
                                               cluster, stream);
}

// K2c-env (K2-env at complex64): the advance through Qm, conj(Qm) backward.
// Scratch: mpst_c_workspace_floats(0, chi, d, N).
int mpst_k2c_env_launch(const void* qm, const void* env, const void* env_ls,
                        const void* phi, void* env_out, void* ls_out,
                        void* ws, int chi, int d, int N, int forward,
                        void* stream) {
  return mpst::launch_k2_env<cfloat>(qm, env, env_ls, phi, env_out, ls_out,
                                     ws, chi, d, N, forward, stream);
}

// K1c-tail (K1-tail at complex64).  Scratch:
// mpst_c_workspace_floats(C, chi, d, 0).
int mpst_k1c_tail_launch(const void* bt, const void* v0, void* y_out,
                         void* ws, int C, int chi, int d, int forward,
                         int q_iters, int qr, void* stream) {
  return mpst::launch_k1_tail<cfloat>(bt, v0, y_out, ws, C, chi, d, forward,
                                      q_iters, qr, stream);
}

// K1c-tail over a cooperative grid of `blocks` blocks:
// mpst_k1c_tail_launch's arguments and the grid size, the same bits; a grid
// past what the card holds at once (mpst_c_grid_occupancy) returns
// cudaErrorCooperativeLaunchTooLarge.  Scratch:
// mpst_c_workspace_floats(C, chi, d, 0).
int mpst_k1c_tail_grid_launch(const void* bt, const void* v0, void* y_out,
                              void* ws, int C, int chi, int d, int forward,
                              int q_iters, int qr, int blocks,
                              void* stream) {
  return mpst::launch_k1_tail_grid<cfloat>(bt, v0, y_out, ws, C, chi, d,
                                           forward, q_iters, qr, blocks,
                                           stream);
}

// How many blocks of a complex grid kernel the card holds at once, into
// *n: kernel 0 K1c-tail (cudaErrorInvalidValue for another kernel).
int mpst_c_grid_occupancy(int kernel, int* n) {
  *n = 0;
  if (kernel != 0) return (int)cudaErrorInvalidValue;
  return mpst::grid_occupancy(mpst::k1_tail_grid_kernel<cfloat>,
                              mpst::stage_smem_bytes<cfloat>(), n);
}

// K2c-env over ceil(N / rows) independent blocks of `rows` rows each:
// mpst_k2c_env_launch's arguments, the rows a block and whether to stage Qm
// and the kron factors in shared memory (where they fit), the same bits.
// Scratch: mpst_c_workspace_floats(0, chi, d, N).
int mpst_k2c_env_rows_launch(const void* qm, const void* env,
                             const void* env_ls, const void* phi,
                             void* env_out, void* ls_out, void* ws, int chi,
                             int d, int N, int forward, int rows,
                             int stage, void* stream) {
  return mpst::launch_k2_env_rows<cfloat>(qm, env, env_ls, phi, env_out,
                                          ls_out, ws, chi, d, N, forward,
                                          rows, stage, stream);
}

}  // extern "C"
