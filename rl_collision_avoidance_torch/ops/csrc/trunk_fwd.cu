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
// Two modes (trunk_bf16.cuh): float32, and bf16, the JAX kernel's
// precision="default" with out_dtype bfloat16: the scans, weights and
// activations rounded to bf16 where they enter a product, float32 sums,
// bias adds and ReLUs, the flat features kept as bf16 (half the workspace)
// and the features written as bf16.  The scans may be float32 or bf16 in
// either mode.  In bf16 mode the bound is the tensor cores' 989 TFLOP/s;
// this version multiplies on the FFMA path all the same.
// A fused kernel would have to keep 32 KB of conv1 activations per sample
// to amortise the 4 MB fc1 weight over enough samples; two passes keep the
// features in HBM instead (1.07 GB at B = 32,768, in L2 at B = 768).  The
// backward kernel runs the same two pieces with the same plan, so its
// recomputed fc1 pre-activations equal these bit for bit.
#include <cuda_runtime.h>

#include "trunk_conv.cuh"
#include "trunk_gemm.cuh"

using trunk::bf16;
using trunk::kH;
using trunk::Trunk;

namespace {

// Floats of the flat features: (2, B, nflat) floats, or as many bf16.
long long flat_floats(int batch, const trunk::ConvGeom& g, bool bf16_mode) {
  const long long n = 2LL * batch * g.nflat;
  return bf16_mode ? n / 2 : n;
}

long long fwd_workspace_floats(int batch, const trunk::ConvGeom& g,
                               int fc1_splits, bool bf16_mode) {
  return flat_floats(batch, g, bf16_mode) +
         trunk::gemm_part_floats(batch, kH, fc1_splits);
}

// The conv pass into the flat features, then fc1 + bias + ReLU into out;
// in bf16 mode (kRound) the flat features and out are bf16 (T).
template <bool kRound, class TX, class T>
cudaError_t forward(const TX* x, const Trunk* tr, T* out, float* work,
                    int batch, int frames, int beams, int conv_blocks,
                    int fc1_splits, cudaStream_t st) {
  const trunk::ConvGeom g = trunk::conv_geom(frames, beams);
  T* flat = reinterpret_cast<T*>(work);  // (2, B, nflat)
  cudaError_t err = trunk::launch_conv_fwd<kRound>(x, tr, flat, batch, frames,
                                                   beams, conv_blocks, st);
  if (err != cudaSuccess) return err;

  trunk::Gemm p{};
  for (int t = 0; t < 2; ++t) {
    p.a[t] = flat + static_cast<size_t>(t) * batch * g.nflat;
    p.b[t] = tr[t].wf;
    p.c[t] = out + static_cast<size_t>(t) * batch * kH;
    p.bias[t] = tr[t].bf;
  }
  p.lda = g.nflat, p.ldb = g.nflat, p.ldc = kH;
  p.m = batch, p.n = kH, p.k = g.nflat;
  p.part = work + flat_floats(batch, g, kRound);
  p.splits = fc1_splits;
  p.kchunk = trunk::ceil_div(trunk::ceil_div(g.nflat, trunk::kBK), fc1_splits);
  return trunk::run_gemm<true, true, trunk::kBiasRelu, T, T, float, kRound>(
      p, st);
}

template <class TX>
cudaError_t forward_in_mode(const TX* x, const Trunk* tr, void* out,
                            float* work, int batch, int frames, int beams,
                            int conv_blocks, int fc1_splits, bool bf16_mode,
                            cudaStream_t st) {
  if (bf16_mode)
    return forward<true, TX, bf16>(x, tr, static_cast<bf16*>(out), work,
                                   batch, frames, beams, conv_blocks,
                                   fc1_splits, st);
  return forward<false, TX, float>(x, tr, static_cast<float*>(out), work,
                                   batch, frames, beams, conv_blocks,
                                   fc1_splits, st);
}

}  // namespace

// Floats of workspace trunk_fwd_launch needs for this batch, plan and mode.
extern "C" long long trunk_fwd_workspace_floats(int batch, int frames,
                                                int beams, int fc1_splits,
                                                int bf16_mode) {
  return fwd_workspace_floats(batch, trunk::conv_geom(frames, beams),
                              fc1_splits, bf16_mode != 0);
}

// x (B, F, NB) scans, float32 or (x_bf16) bf16; w: the 12 float32 weight
// pointers, actor trunk then critic trunk, each in the order w1, b1, w2, b2,
// wf, bf of struct Trunk; out (2, B, 256), float32 or (bf16_mode) bf16;
// work: work_floats floats.  The plan: conv_blocks conv blocks per trunk
// (trunk_conv.cuh, block_samples), fc1_splits ranges of fc1's K.  bf16_mode:
// the bf16 mode of trunk_bf16.cuh.  Returns cudaErrorInvalidValue for shapes
// the kernels do not take (see trunk_conv.cuh), a plan that leaves a range
// empty, or too little workspace.
extern "C" int trunk_fwd_launch(const void* x, const void* const* w,
                                void* out, void* work, long long work_floats,
                                int batch, int frames, int beams,
                                int conv_blocks, int fc1_splits, int x_bf16,
                                int bf16_mode, int device, void* stream) {
  const trunk::ConvGeom g = trunk::conv_geom(frames, beams);
  if (!trunk::conv_shapes_ok(frames, beams) || batch < 1 ||
      conv_blocks < 1 || conv_blocks > trunk::ceil_div(batch, trunk::kFwdGroup) ||
      fc1_splits < 1 ||
      work_floats < fwd_workspace_floats(batch, g, fc1_splits, bf16_mode != 0))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* const* f = reinterpret_cast<const float* const*>(w);
  const Trunk tr[2] = {{f[0], f[1], f[2], f[3], f[4], f[5]},
                       {f[6], f[7], f[8], f[9], f[10], f[11]}};
  float* ws = static_cast<float*>(work);
  return x_bf16 ? forward_in_mode(static_cast<const bf16*>(x), tr, out, ws,
                                  batch, frames, beams, conv_blocks,
                                  fc1_splits, bf16_mode != 0, st)
                : forward_in_mode(static_cast<const float*>(x), tr, out, ws,
                                  batch, frames, beams, conv_blocks,
                                  fc1_splits, bf16_mode != 0, st);
}
