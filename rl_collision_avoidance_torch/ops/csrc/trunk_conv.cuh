// The two convolutions of a CNNPolicy trunk for one sample, shared by the
// forward (trunk_fwd.cu) and backward (trunk_bwd.cu) kernels so both compute
// the activations the same way.  Every buffer is in shared memory; the
// block's threads stride over the outputs.  float32 FMA, no TF32.
#pragma once

#include <cuda_runtime.h>

namespace trunk {

constexpr int kC = 32;   // conv channels
constexpr int kH = 256;  // fc1 width

struct Trunk {
  const float* w1;  // (32, F, 5)
  const float* b1;  // (32,)
  const float* w2;  // (32, 32, 3)
  const float* b2;  // (32,)
  const float* wf;  // (256, 32 * L2)
  const float* bf;  // (256,)
};

__host__ __device__ inline int conv1_len(int beams) { return (beams - 3) / 2 + 1; }
__host__ __device__ inline int conv2_len(int l1) { return (l1 - 1) / 2 + 1; }

// conv1 (F -> 32, k5 s2 p1) + ReLU: xs (F, NB) -> y1 (32, L1).
__device__ inline void conv1_relu(const float* xs, const float* w1,
                                  const float* b1, float* y1, int frames,
                                  int beams, int tid, int nthreads) {
  const int l1 = conv1_len(beams);
  for (int o = tid; o < kC * l1; o += nthreads) {
    const int c = o / l1;
    const int l = o - c * l1;
    float acc = b1[c];
    for (int ci = 0; ci < frames; ++ci) {
      const float* wr = w1 + (c * frames + ci) * 5;
      const float* xr = xs + ci * beams;
#pragma unroll
      for (int t = 0; t < 5; ++t) {
        const int idx = 2 * l + t - 1;
        if (idx >= 0 && idx < beams) acc = fmaf(wr[t], xr[idx], acc);
      }
    }
    y1[o] = fmaxf(acc, 0.0f);
  }
}

// conv2 (32 -> 32, k3 s2 p1) + ReLU: y1 (32, L1) -> y2 (32 * L2) in the
// channel-major flatten order of the reference layout (k = c * L2 + l).
__device__ inline void conv2_relu(const float* y1, const float* w2,
                                  const float* b2, float* y2, int l1, int tid,
                                  int nthreads) {
  const int l2 = conv2_len(l1);
  for (int o = tid; o < kC * l2; o += nthreads) {
    const int c = o / l2;
    const int m = o - c * l2;
    float acc = b2[c];
    for (int ci = 0; ci < kC; ++ci) {
      const float* wr = w2 + (c * kC + ci) * 3;
      const float* yr = y1 + ci * l1;
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const int idx = 2 * m + t - 1;
        if (idx >= 0 && idx < l1) acc = fmaf(wr[t], yr[idx], acc);
      }
    }
    y2[o] = fmaxf(acc, 0.0f);
  }
}

// The trunk's conv weights into shared memory: w1 (32 F 5), b1, w2, b2.
__device__ inline void load_conv_weights(const Trunk& p, float* w1, float* b1,
                                         float* w2, float* b2, int frames,
                                         int tid, int nthreads) {
  for (int i = tid; i < kC * frames * 5; i += nthreads) w1[i] = p.w1[i];
  for (int i = tid; i < kC * kC * 3; i += nthreads) w2[i] = p.w2[i];
  for (int i = tid; i < kC; i += nthreads) {
    b1[i] = p.b1[i];
    b2[i] = p.b2[i];
  }
}

}  // namespace trunk
