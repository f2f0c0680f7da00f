// The float32 mode's two convolutions of a CNNPolicy trunk, shared by the
// forward (trunk_fwd.cu) and backward (trunk_bwd.cu) kernels so both
// compute the activations with the same code and the same rounding.
// float32 FMA only (no tensor cores, no TF32: the exact-f32 rule), so the
// 67 TFLOP/s FFMA peak bounds it; the bf16 mode's conv pass runs on the
// tensor cores instead (trunk_conv_mma.cuh).
//
// conv1 (F -> 32, k5 s2 p1) and conv2 (32 -> 32, k3 s2 p1) are small
// register-tiled products: a thread owns 8 output channels x 4 positions
// (32 sums), reads the 8 channels' weights as float4 broadcasts (every lane
// of a warp holds the same channels) and each input value once for its 8
// channels.  Stride 2 is taken out of the shared-memory reads by storing
// each input de-interleaved into an even plane e[q] = in[2q] and a shifted
// odd plane o[q] = in[2q - 1] (o[0] = 0 is the left padding), so that
// output l reads, for tap t, o[l + t / 2] (t even) or e[l + t / 2] (t odd)
// for conv1 and o[m], e[m], o[m + 1] for conv2: contiguous float4s across
// lanes.  Each sum starts at the bias and adds its terms in the order
// (frame or input channel, tap), as F.conv1d's definition lists them.
//
// The scans may be float32 or bf16 (TX).
//
// Shapes: 1 <= F <= kMaxFrames frames and a beam count that is a multiple
// of 16, so that L1 = NB / 2 - 1 (padded to NB / 2 with one zero output)
// and L2 = NB / 4 split into position groups of 4.
#pragma once

#include <cuda_runtime.h>

#include "trunk_bf16.cuh"

namespace trunk {

constexpr int kC = 32;          // conv channels
constexpr int kH = 256;         // fc1 width
constexpr int kMaxFrames = 6;   // more frames: the launchers refuse them
constexpr int kConvThreads = 256;
constexpr int kFwdGroup = 2;    // samples per step of the forward conv pass

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

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

struct ConvGeom {
  int frames, beams, half, l1, l2, nflat;
  int xs;  // floats per row of an x plane (e or o) in shared memory
  int ys;  // floats per row of a conv1 plane
};

__host__ __device__ inline ConvGeom conv_geom(int frames, int beams) {
  ConvGeom g;
  g.frames = frames;
  g.beams = beams;
  g.half = beams / 2;
  g.l1 = conv1_len(beams);
  g.l2 = conv2_len(g.l1);
  g.nflat = kC * g.l2;
  g.xs = g.half + 4;
  g.ys = g.l2 + 4;
  return g;
}

inline bool conv_shapes_ok(int frames, int beams) {
  return frames >= 1 && frames <= kMaxFrames && beams >= 16 && beams % 16 == 0;
}

// Floats of one sample's x planes: F even rows, then F odd rows.
__host__ __device__ inline int x_floats(const ConvGeom& g) { return 2 * g.frames * g.xs; }
// Floats of one sample's conv1 planes: 32 even rows, then 32 odd rows.
__host__ __device__ inline int y1_floats(const ConvGeom& g) { return 2 * kC * g.ys; }

// w1 (c, f, t) -> w1t[(f * 5 + t) * 32 + c], and b1.
__device__ inline void stage_conv1_weights(const Trunk& p, float* w1t,
                                           float* b1, int frames, int tid) {
  for (int i = tid; i < kC * frames * 5; i += kConvThreads) {
    const int c = i / (frames * 5);
    w1t[(i - c * frames * 5) * kC + c] = p.w1[i];
  }
  for (int i = tid; i < kC; i += kConvThreads) b1[i] = p.b1[i];
}

// w2 (c, ci, t) -> w2s[(ci * 3 + t) * 32 + c] when kByOutput (conv2: the
// output channels contiguous), else w2s[(c * 3 + t) * 32 + ci] (the
// transposed conv2: the input channels contiguous).
template <bool kByOutput>
__device__ inline void stage_conv2_weights(const Trunk& p, float* w2s,
                                           int tid) {
  for (int i = tid; i < kC * kC * 3; i += kConvThreads) {
    const int c = i / (kC * 3);
    const int ci = (i / 3) % kC;
    const int t = i % 3;
    w2s[kByOutput ? (ci * 3 + t) * kC + c : (c * 3 + t) * kC + ci] = p.w2[i];
  }
}

// The zero paddings of n samples' x planes and conv1 planes; the loads and
// conv1 never write them.
__device__ inline void zero_pads(float* xsm, float* y1, const ConvGeom& g,
                                 int n, int tid) {
  for (int s = 0; s < n; ++s) {
    for (int i = tid; i < g.frames; i += kConvThreads) {
      float* xe = xsm + s * x_floats(g) + i * g.xs;
      float* xo = xe + g.frames * g.xs;
      for (int q = g.half; q < g.xs; ++q) xe[q] = 0.0f;
      xo[0] = 0.0f;
      for (int q = g.half + 1; q < g.xs; ++q) xo[q] = 0.0f;
    }
    for (int ci = tid; ci < kC; ci += kConvThreads)
      y1[s * y1_floats(g) + (kC + ci) * g.ys] = 0.0f;
  }
}

// One sample's scans (F, NB) into its x planes: e[q] = x[2q], o[q + 1] =
// x[2q + 1].
template <class TX>
__device__ inline void load_x(const TX* __restrict__ xb, float* xsm,
                              const ConvGeom& g, int tid) {
  const int per_row = g.beams / 4;
  for (int i = tid; i < g.frames * per_row; i += kConvThreads) {
    const int f = i / per_row;
    const int q = i - f * per_row;
    const float4 v = ld4(xb + f * g.beams + 4 * q);
    float* xe = xsm + f * g.xs;
    float* xo = xe + g.frames * g.xs;
    xe[2 * q] = v.x;
    xe[2 * q + 1] = v.z;
    xo[2 * q + 1] = v.y;
    xo[2 * q + 2] = v.w;
  }
}

// conv1 + ReLU for channels 8 cg .. 8 cg + 7 at positions 4 lg .. 4 lg + 3
// of one sample, into its conv1 planes (position L1, the padding, gets 0).
__device__ __forceinline__ void conv1_item(const float* xsm, const float* w1t,
                                           const float* b1, float* y1,
                                           const ConvGeom& g, int cg, int lg) {
  const int c0 = cg * 8, l0 = lg * 4;
  float acc[8][4];
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[c][j] = b1[c0 + c];
  for (int f = 0; f < g.frames; ++f) {
    const float* xe = xsm + f * g.xs;
    const float* xo = xe + g.frames * g.xs;
    const float4 e4 = *reinterpret_cast<const float4*>(xe + l0);
    const float4 o4 = *reinterpret_cast<const float4*>(xo + l0);
    const float2 o2 = *reinterpret_cast<const float2*>(xo + l0 + 4);
    const float e[5] = {e4.x, e4.y, e4.z, e4.w, xe[l0 + 4]};
    const float o[6] = {o4.x, o4.y, o4.z, o4.w, o2.x, o2.y};
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const float4 wa = *reinterpret_cast<const float4*>(w1t + (f * 5 + t) * kC + c0);
      const float4 wb = *reinterpret_cast<const float4*>(w1t + (f * 5 + t) * kC + c0 + 4);
      const float w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xv = (t & 1) ? e[j + t / 2] : o[j + t / 2];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[c][j] = fmaf(w[c], xv, acc[c][j]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = l0 + j < g.l1 ? fmaxf(acc[c][j], 0.0f) : 0.0f;
    float* ye = y1 + (c0 + c) * g.ys;
    float* yo = y1 + (kC + c0 + c) * g.ys;
    *reinterpret_cast<float2*>(ye + l0 / 2) = make_float2(v[0], v[2]);
    yo[l0 / 2 + 1] = v[1];
    yo[l0 / 2 + 2] = v[3];
  }
}

// conv2 + ReLU for channels 8 cg .. 8 cg + 7 at positions 4 mg .. 4 mg + 3
// of one sample, into its flat features out[c * L2 + m] (channel-major,
// the reference layout).
__device__ __forceinline__ void conv2_item(const float* y1, const float* w2t,
                                           const float* b2,
                                           float* __restrict__ out,
                                           const ConvGeom& g, int cg, int mg) {
  const int c0 = cg * 8, m0 = mg * 4;
  float acc[8][4];
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[c][j] = b2[c0 + c];
#pragma unroll 2
  for (int ci = 0; ci < kC; ++ci) {
    const float* ye = y1 + ci * g.ys;
    const float* yo = y1 + (kC + ci) * g.ys;
    const float4 e4 = *reinterpret_cast<const float4*>(ye + m0);
    const float4 o4 = *reinterpret_cast<const float4*>(yo + m0);
    const float e[4] = {e4.x, e4.y, e4.z, e4.w};
    const float o[5] = {o4.x, o4.y, o4.z, o4.w, yo[m0 + 4]};
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const float4 wa = *reinterpret_cast<const float4*>(w2t + (ci * 3 + t) * kC + c0);
      const float4 wb = *reinterpret_cast<const float4*>(w2t + (ci * 3 + t) * kC + c0 + 4);
      const float w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float yv = t == 1 ? e[j] : o[j + t / 2];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[c][j] = fmaf(w[c], yv, acc[c][j]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c)
    st4(out + (c0 + c) * g.l2 + m0,
        make_float4(fmaxf(acc[c][0], 0.0f), fmaxf(acc[c][1], 0.0f),
                    fmaxf(acc[c][2], 0.0f), fmaxf(acc[c][3], 0.0f)));
}

inline size_t conv_fwd_smem_bytes(const ConvGeom& g) {
  return sizeof(float) *
         (static_cast<size_t>(kC * g.frames * 5 + 2 * kC + kC * kC * 3) +
          static_cast<size_t>(kFwdGroup) * (x_floats(g) + y1_floats(g)));
}

// The samples of conv block i of `blocks`: groups [i G / blocks, (i + 1) G /
// blocks) of the G = ceil(batch / kFwdGroup) groups of kFwdGroup samples, so
// block ranges differ by at most one group and none is empty while
// blocks <= G.  Both conv passes cut the batch this way.
__device__ inline void block_samples(int batch, int blocks, int i, int* lo,
                                     int* hi) {
  const long long groups = ceil_div(batch, kFwdGroup);
  *lo = static_cast<int>(i * groups / blocks) * kFwdGroup;
  *hi = min(batch, static_cast<int>((i + 1) * groups / blocks) * kFwdGroup);
}

// The conv pass: flat[t][b] = the channel-major conv2 features of sample b
// through trunk t = blockIdx.y.  Block i takes the samples block_samples
// gives it, kGroup at a time, with three barriers per group.  TX: the
// scans' type.
template <int kGroup, class TX>
__global__ void __launch_bounds__(kConvThreads, 2)
    conv_fwd_kernel(const TX* __restrict__ x, Trunk act, Trunk crt,
                    float* __restrict__ flat, int batch, int frames,
                    int beams) {
  extern __shared__ __align__(16) float sh[];
  const ConvGeom g = conv_geom(frames, beams);
  const Trunk p = blockIdx.y == 0 ? act : crt;
  const int tid = threadIdx.x;
  float* w1t = sh;
  float* b1 = w1t + kC * frames * 5;
  float* b2 = b1 + kC;
  float* w2t = b2 + kC;
  float* xsm = w2t + kC * kC * 3;
  float* y1 = xsm + kGroup * x_floats(g);
  stage_conv1_weights(p, w1t, b1, frames, tid);
  stage_conv2_weights<true>(p, w2t, tid);
  for (int i = tid; i < kC; i += kConvThreads) b2[i] = p.b2[i];
  zero_pads(xsm, y1, g, kGroup, tid);

  const int nlg = g.half / 4, nmg = g.l2 / 4;
  int b_begin, b_end;
  block_samples(batch, gridDim.x, blockIdx.x, &b_begin, &b_end);
  for (int b0 = b_begin; b0 < b_end; b0 += kGroup) {
    const int nb = min(kGroup, b_end - b0);
    __syncthreads();  // the previous group's conv2 has read y1
    for (int s = 0; s < nb; ++s)
      load_x(x + static_cast<size_t>(b0 + s) * frames * beams,
             xsm + s * x_floats(g), g, tid);
    __syncthreads();
    for (int it = tid; it < nb * 4 * nlg; it += kConvThreads) {
      const int s = it / (4 * nlg);
      const int r = it - s * 4 * nlg;
      conv1_item(xsm + s * x_floats(g), w1t, b1, y1 + s * y1_floats(g), g,
                 r / nlg, r % nlg);
    }
    __syncthreads();
    for (int it = tid; it < nb * 4 * nmg; it += kConvThreads) {
      const int s = it / (4 * nmg);
      const int r = it - s * 4 * nmg;
      conv2_item(y1 + s * y1_floats(g), w2t, b2,
                 flat + (blockIdx.y * static_cast<size_t>(batch) + b0 + s) * g.nflat,
                 g, r / nmg, r % nmg);
    }
  }
}

// Enqueue the conv pass over both trunks.
template <class TX>
inline cudaError_t launch_conv_fwd(const TX* x, const Trunk* tr, float* flat,
                                   int batch, int frames, int beams,
                                   int blocks, cudaStream_t stream) {
  const ConvGeom g = conv_geom(frames, beams);
  const size_t smem = conv_fwd_smem_bytes(g);
  auto kernel = conv_fwd_kernel<kFwdGroup, TX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks, 2);
  kernel<<<grid, kConvThreads, smem, stream>>>(
      x, tr[0], tr[1], flat, batch, frames, beams);
  return cudaGetLastError();
}

}  // namespace trunk
