// Twin-trunk forward kernel: both CNNPolicy feature trunks, conv1 -> ReLU ->
// conv2 -> ReLU -> flatten -> fc1 -> ReLU, from the (B, F, NB) scans to the
// (2, B, 256) features.
//
// Replaces rl_collision_avoidance_tpu/ops/trunk_pallas.py::_fwd_kernel
// (reached through _fwd_call and fused_trunks).  Its plain PyTorch version
// is rl_collision_avoidance_torch/ops/trunk_cuda.py::twin_trunks_plain
// (F.conv1d / F.linear in float32, TF32 off).
//
// What bounds it on an H100: operations.  Per sample and trunk it does
// ~3.1 MFLOP (conv1 0.24, conv2 0.79, fc1 2.1) against 6 KB of scans read
// and 1 KB of features written: at B = 32,768, 0.21 TFLOP, ~3.1 ms at the
// 67 TFLOP/s float32 peak.
//
// Design: trunk_fwd_launch enqueues two passes.
//   1. The conv pass (trunk_conv.cuh): 2 x 132 blocks of 256 threads, each
//      walking a fixed range of samples two at a time, conv1 and conv2 as
//      register-tiled products in ~95 KB of shared memory (two blocks fit
//      on an SM), writing the channel-major flat features (2, B, 32 L2) to
//      a workspace.
//   2. fc1 on the shared product core (trunk_gemm.cuh), bias + ReLU in its
//      epilogue, into the (2, B, 256) output.  Where the batch gives too
//      few 128 x 128 tiles to fill the card (B = 768: 24), the wrapper's
//      plan splits K = 32 L2 into ranges whose partial sums a fixed-order
//      pass adds.
// A fused kernel would have to keep 32 KB of conv1 activations per sample
// to amortise the 4 MB fc1 weight over enough samples; two passes keep the
// features in HBM instead (1.07 GB at B = 32,768, in L2 at B = 768).  The
// backward kernel runs the same two pieces with the same plan, so its
// recomputed fc1 pre-activations equal these bit for bit.
#include <cuda_runtime.h>

#include "trunk_conv.cuh"
#include "trunk_gemm.cuh"

using trunk::kH;
using trunk::Trunk;

namespace {

long long fwd_workspace_floats(int batch, const trunk::ConvGeom& g,
                               int fc1_splits) {
  return 2LL * batch * g.nflat +
         trunk::gemm_part_floats(batch, kH, fc1_splits);
}

}  // namespace

// Floats of workspace trunk_fwd_launch needs for this batch and plan.
extern "C" long long trunk_fwd_workspace_floats(int batch, int frames,
                                                int beams, int fc1_splits) {
  return fwd_workspace_floats(batch, trunk::conv_geom(frames, beams),
                              fc1_splits);
}

// x (B, F, NB) scans; w: the 12 weight pointers, actor trunk then critic
// trunk, each in the order w1, b1, w2, b2, wf, bf of struct Trunk; out
// (2, B, 256); work: work_floats floats.  The plan: conv_blocks conv blocks
// per trunk (trunk_conv.cuh, block_samples), fc1_splits ranges of fc1's K.  Returns
// cudaErrorInvalidValue for shapes the kernels do not take (see
// trunk_conv.cuh), a plan that leaves a range empty, or too little
// workspace.
extern "C" int trunk_fwd_launch(const void* x, const void* const* w,
                                void* out, void* work, long long work_floats,
                                int batch, int frames, int beams,
                                int conv_blocks, int fc1_splits,
                                int device, void* stream) {
  const trunk::ConvGeom g = trunk::conv_geom(frames, beams);
  if (!trunk::conv_shapes_ok(frames, beams) || batch < 1 ||
      conv_blocks < 1 || conv_blocks > trunk::ceil_div(batch, trunk::kFwdGroup) ||
      fc1_splits < 1 ||
      work_floats < fwd_workspace_floats(batch, g, fc1_splits))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* const* f = reinterpret_cast<const float* const*>(w);
  const Trunk tr[2] = {{f[0], f[1], f[2], f[3], f[4], f[5]},
                       {f[6], f[7], f[8], f[9], f[10], f[11]}};
  float* flat = static_cast<float*>(work);  // (2, B, nflat)
  err = trunk::launch_conv_fwd(static_cast<const float*>(x), tr, flat, batch,
                               frames, beams, conv_blocks, st);
  if (err != cudaSuccess) return err;

  trunk::Gemm p{};
  for (int t = 0; t < 2; ++t) {
    p.a[t] = flat + static_cast<size_t>(t) * batch * g.nflat;
    p.b[t] = tr[t].wf;
    p.c[t] = static_cast<float*>(out) + static_cast<size_t>(t) * batch * kH;
    p.bias[t] = tr[t].bf;
  }
  p.lda = g.nflat, p.ldb = g.nflat, p.ldc = kH;
  p.m = batch, p.n = kH, p.k = g.nflat;
  p.part = flat + 2LL * batch * g.nflat;
  p.splits = fc1_splits;
  p.kchunk = trunk::ceil_div(trunk::ceil_div(g.nflat, trunk::kBK), fc1_splits);
  return trunk::run_gemm<true, true, trunk::kBiasRelu>(p, st);
}
