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
// and 1 KB of features written; at 3,072 samples that is ~19 GFLOP against
// ~34 MB, i.e. ~0.29 ms at the 67 TFLOP/s float32 peak and ~0.01 ms of
// memory traffic.  The 4 MB fc1 weight of each trunk is re-read by every
// block, from L2.
//
// Design (simple and exact first; tensor cores are a later step): one block
// per (tile of kTile samples, trunk), grid (ceil(B / kTile), 2).  The block
// keeps the trunk's conv weights, one sample's scans and conv1 output, and
// the tile's conv2 outputs in shared memory (212 KB at NB = 512, so the
// kernel asks for it with cudaFuncSetAttribute); no activation reaches
// device memory and no im2col matrix is built.  conv1 and conv2 run one
// output per thread; conv2 writes in the channel-major flatten order of the
// reference layout (k = c * L2 + l).  fc1 gives each warp kJ outputs at a
// time for all kTile samples: lanes stride the 4096-long input (coalesced
// weight rows, conflict-free shared reads), then a butterfly sum.  All
// arithmetic is float32 FMA; the sums run in another order than cuDNN's and
// cuBLAS's, which the tolerance in chip_smoke.py accounts for.
#include <cuda_runtime.h>

#include "trunk_conv.cuh"

namespace {

using trunk::kC;
using trunk::kH;
using trunk::Trunk;
using trunk::conv1_len;
using trunk::conv2_len;

constexpr int kThreads = 512;  // 16 warps
constexpr int kTile = 10;      // samples per block; 3,072 is not a multiple
constexpr int kJ = 2;          // fc1 outputs per warp pass

inline size_t smem_floats(int frames, int beams) {
  const int l1 = conv1_len(beams);
  const int flat = kC * conv2_len(l1);
  return static_cast<size_t>(kC * frames * 5 + kC + kC * kC * 3 + kC +
                             frames * beams + kC * l1) +
         static_cast<size_t>(kTile) * flat;
}

__global__ void __launch_bounds__(kThreads)
    trunk_fwd_kernel(const float* __restrict__ x, Trunk act, Trunk crt,
                     float* __restrict__ out, int batch, int frames,
                     int beams) {
  extern __shared__ float sh[];
  const int l1 = conv1_len(beams);  // k5 s2 p1
  const int l2 = conv2_len(l1);     // k3 s2 p1
  const int flat = kC * l2;
  const Trunk p = blockIdx.y == 0 ? act : crt;
  const int b0 = blockIdx.x * kTile;
  const int nb = min(kTile, batch - b0);
  const int tid = threadIdx.x;

  float* w1 = sh;
  float* b1 = w1 + kC * frames * 5;
  float* w2 = b1 + kC;
  float* b2 = w2 + kC * kC * 3;
  float* xs = b2 + kC;           // (F, NB) one sample
  float* y1 = xs + frames * beams;  // (32, L1) one sample
  float* y2 = y1 + kC * l1;      // (kTile, 32 * L2) flattened conv2 outputs

  trunk::load_conv_weights(p, w1, b1, w2, b2, frames, tid, kThreads);

  for (int s = 0; s < nb; ++s) {
    const float* xb = x + static_cast<size_t>(b0 + s) * frames * beams;
    for (int i = tid; i < frames * beams; i += kThreads) xs[i] = xb[i];
    __syncthreads();
    trunk::conv1_relu(xs, w1, b1, y1, frames, beams, tid, kThreads);
    __syncthreads();
    trunk::conv2_relu(y1, w2, b2, y2 + s * flat, l1, tid, kThreads);
    // The next sample overwrites xs only after this barrier, and y1 only
    // after the next one, when every thread has finished reading both.
  }
  for (int i = nb * flat + tid; i < kTile * flat; i += kThreads) y2[i] = 0.0f;
  __syncthreads();

  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int j0 = warp * kJ; j0 < kH; j0 += (kThreads / 32) * kJ) {
    float acc[kJ][kTile];
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
      for (int s = 0; s < kTile; ++s) acc[jj][s] = 0.0f;
    for (int k = lane; k < flat; k += 32) {
      float wv[kJ];
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj)
        wv[jj] = p.wf[static_cast<size_t>(j0 + jj) * flat + k];
#pragma unroll
      for (int s = 0; s < kTile; ++s) {
        const float xv = y2[s * flat + k];
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) acc[jj][s] = fmaf(wv[jj], xv, acc[jj][s]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const float bias = p.bf[j0 + jj];
#pragma unroll
      for (int s = 0; s < kTile; ++s) {
        float v = acc[jj][s];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0 && s < nb)
          out[(static_cast<size_t>(blockIdx.y) * batch + b0 + s) * kH + j0 + jj] =
              fmaxf(v + bias, 0.0f);
      }
    }
  }
}

}  // namespace

// w: the 12 weight pointers, actor trunk then critic trunk, each in the
// order w1, b1, w2, b2, wf, bf of struct Trunk.
extern "C" int trunk_fwd_launch(const void* x, const void* const* w,
                                void* out, int batch, int frames, int beams,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* const* f = reinterpret_cast<const float* const*>(w);
  const Trunk act{f[0], f[1], f[2], f[3], f[4], f[5]};
  const Trunk crt{f[6], f[7], f[8], f[9], f[10], f[11]};
  const size_t smem = sizeof(float) * smem_floats(frames, beams);
  err = cudaFuncSetAttribute(trunk_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + kTile - 1) / kTile, 2);
  trunk_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), act, crt, static_cast<float*>(out), batch,
      frames, beams);
  return cudaGetLastError();
}
