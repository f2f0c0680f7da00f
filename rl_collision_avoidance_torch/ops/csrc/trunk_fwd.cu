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
// 67 TFLOP/s FFMA peak (float32 mode) and 0.21 ms at the 989 TFLOP/s dense
// bf16 tensor-core peak (bf16 mode).  The bf16 mode's two passes also write
// and read its bf16 flat features, 1.07 GB at B = 32,768: 0.32 ms at 3.35
// TB/s, above the ops bound (fusing the conv pass into fc1 would keep them
// on chip).
//
// Design: trunk_fwd_launch enqueues two passes.
//   1. The conv pass: 2 x 132 blocks of 256 threads, each walking a fixed
//      range of samples two at a time, writing the channel-major flat
//      features (2, B, 32 L2) to a workspace.  float32 mode:
//      trunk_conv.cuh, conv1 and conv2 as register-tiled FFMA products in
//      ~95 KB of shared memory.  bf16 mode: trunk_conv_mma.cuh, conv1 and
//      conv2 on the tensor cores, the features bf16 (half the workspace);
//      its blocks also write the fc1 weight as bf16 for pass 2.
//   2. fc1 + bias + ReLU into the (2, B, 256) output: float32 mode on the
//      FFMA product core (trunk_gemm.cuh), bf16 mode on the tensor-core
//      core (trunk_mma.cuh) with bf16 output.  Where the batch gives too
//      few 128 x 128 tiles to fill the card (B = 768: 24), the wrapper's
//      plan splits K = 32 L2 into ranges whose partial sums a fixed-order
//      pass adds.
// The bf16 mode is the JAX kernel's precision="default" with out_dtype
// bfloat16: the scans, weights and activations rounded to bf16 where they
// enter a product, float32 sums, bias adds and ReLUs, and the features
// written as bf16.  The scans may be float32 or bf16 in either mode.
// A fused kernel would have to keep 32 KB of conv1 activations per sample
// to amortise the 4 MB fc1 weight over enough samples; two passes keep the
// features in HBM instead (in L2 at B = 768).  The backward kernel runs the
// same two pieces with the same plan, so its recomputed fc1
// pre-activations equal these bit for bit.
#include <cuda_runtime.h>

#include "trunk_conv.cuh"
#include "trunk_conv_mma.cuh"
#include "trunk_gemm.cuh"
#include "trunk_mma.cuh"

using trunk::bf16;
using trunk::kH;
using trunk::Trunk;

namespace {

// Floats of workspace: the flat features (2, B, nflat), float32 or as many
// bf16; in bf16 mode the bf16 fc1 weight (2, 256, nflat); fc1's split-K
// partials.
long long fwd_workspace_floats(int batch, const trunk::ConvGeom& g,
                               int fc1_splits, bool bf16_mode) {
  const long long flat = 2LL * batch * g.nflat;
  return (bf16_mode ? flat / 2 + 1LL * kH * g.nflat : flat) +
         trunk::gemm_part_floats(batch, kH, fc1_splits);
}

// fc1's product over the flat features: M = B, N = 256, K = nflat.
template <class TA, class TB, class TC>
trunk::Gemm fc1_gemm(const TA* flat, const TB* const (&wf)[2], TC* out,
                     const Trunk* tr, float* part, int batch, int nflat,
                     int splits, int k_tile) {
  trunk::Gemm p{};
  for (int t = 0; t < 2; ++t) {
    p.a[t] = flat + static_cast<size_t>(t) * batch * nflat;
    p.b[t] = wf[t];
    p.c[t] = out + static_cast<size_t>(t) * batch * kH;
    p.bias[t] = tr[t].bf;
  }
  p.lda = nflat, p.ldb = nflat, p.ldc = kH;
  p.m = batch, p.n = kH, p.k = nflat;
  p.part = part;
  p.splits = splits;
  p.kchunk = trunk::ceil_div(trunk::ceil_div(nflat, k_tile), splits);
  return p;
}

template <class TX>
cudaError_t forward_f32(const TX* x, const Trunk* tr, float* out,
                        float* work, int batch, int frames, int beams,
                        int conv_blocks, int fc1_splits, cudaStream_t st) {
  const trunk::ConvGeom g = trunk::conv_geom(frames, beams);
  float* flat = work;  // (2, B, nflat)
  cudaError_t err = trunk::launch_conv_fwd(x, tr, flat, batch, frames, beams,
                                           conv_blocks, st);
  if (err != cudaSuccess) return err;
  const float* const wf[2] = {tr[0].wf, tr[1].wf};
  const trunk::Gemm p =
      fc1_gemm(flat, wf, out, tr, work + 2LL * batch * g.nflat, batch,
               g.nflat, fc1_splits, trunk::kBK);
  return trunk::run_gemm<true, true, trunk::kBiasRelu>(p, st);
}

template <class TX>
cudaError_t forward_bf16(const TX* x, const Trunk* tr, bf16* out,
                         float* work, int batch, int frames, int beams,
                         int conv_blocks, int fc1_splits, cudaStream_t st) {
  const trunk::ConvGeom g = trunk::conv_geom(frames, beams);
  const long long flat_floats = 1LL * batch * g.nflat;  // (2, B, nflat) bf16
  bf16* flat = reinterpret_cast<bf16*>(work);
  bf16* wf16 = reinterpret_cast<bf16*>(work + flat_floats);
  cudaError_t err = trunk::launch_conv_mma(x, tr, flat, wf16, batch, frames,
                                           beams, conv_blocks, st);
  if (err != cudaSuccess) return err;
  const bf16* const wf[2] = {wf16, wf16 + static_cast<size_t>(kH) * g.nflat};
  const trunk::Gemm p = fc1_gemm(
      flat, wf, out, tr, work + flat_floats + 1LL * kH * g.nflat, batch,
      g.nflat, fc1_splits, trunk::mma::kBK);
  return trunk::run_mma_gemm<true, true, trunk::kBiasRelu, bf16>(p, st);
}

template <class TX>
cudaError_t forward_in_mode(const TX* x, const Trunk* tr, void* out,
                            float* work, int batch, int frames, int beams,
                            int conv_blocks, int fc1_splits, bool bf16_mode,
                            cudaStream_t st) {
  if (bf16_mode)
    return forward_bf16(x, tr, static_cast<bf16*>(out), work, batch, frames,
                        beams, conv_blocks, fc1_splits, st);
  return forward_f32(x, tr, static_cast<float*>(out), work, batch, frames,
                     beams, conv_blocks, fc1_splits, st);
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
// the bf16 mode (tensor cores).  Returns cudaErrorInvalidValue for shapes
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
