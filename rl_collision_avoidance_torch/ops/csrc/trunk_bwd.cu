// Twin-trunk backward kernel: the six weight gradients of both CNNPolicy
// feature trunks from the (2, B, 256) feature cotangent g, summed over the
// batch.  No gradient flows to the scans.
//
// Replaces rl_collision_avoidance_tpu/ops/trunk_pallas.py::_bwd_kernel
// (reached through _bwd_call and the fused_trunks custom_vjp).  Its plain
// PyTorch version is rl_collision_avoidance_torch/ops/trunk_cuda.py::
// twin_trunks_grads_plain (autograd through F.conv1d / F.linear in float32).
//
// What bounds it on an H100: operations.  Per sample and trunk it does
// ~9.1 MFLOP: the recomputed forward (conv1 0.24, conv2 0.79, fc1 2.1), then
// dWf 2.1, dflat 2.1, dW2 0.79, the transposed conv2 0.79 and dW1 0.24.  At
// B = 32,768 that is ~0.6 TFLOP against ~270 MB of inputs and outputs, so
// ~8.9 ms at the 67 TFLOP/s float32 peak.
//
// The TPU kernel sums every gradient over a sequential grid, in place.  On
// the card blocks run in parallel and in no order, and this kernel uses no
// float atomics, so the same inputs give the same bits.  The batch sums are
// split into passes that each own their outputs and sum in a fixed order:
//
//   1. conv_fwd: per sample, conv1 and conv2 into the channel-major flat
//      features, written to a workspace `act` (2, B, 32 L2).
//   2. gemm <fc1>: out = flat Wf^T + bf, g1 = g [out > 0] -> workspace (2, B, 256).
//   3. gemm <dWf>: dWf = g1^T flat, output-stationary: each block owns a
//      128 x 128 tile of dWf and loops over the whole batch in order.
//   4. gemm <dflat>: g2 = (g1 Wf) [flat > 0], written over `act` in place.
//   5. conv_bwd: per sample, recompute conv1, then dW2, db2, the transposed
//      conv2 onto the conv1 grid, g3 = dconv1 [conv1 > 0], dW1 and db1; each
//      block sums its kConvTile samples in registers and writes one partial.
//   6. reduce: one warp per small-gradient element sums the blocks' partials
//      (and, for dbf, the rows of g1) in a fixed order.
//
// Workspace: the flat features (B x 4096 x 4 B = 537 MB per trunk at
// B = 32,768), g1 (34 MB per trunk) and the partials (2 x ceil(B / 16) x
// 3,616 floats, 59 MB).  The passes move ~8 GB through HBM in all (the flat
// features are written once, read by passes 2 to 4, and g2 is written over
// them and read by pass 5), ~2.4 ms at 3.35 TB/s, so operations still bound
// it.  The products are plain register-tiled float32 FMA (8 x 8 outputs a
// thread): no tensor cores, no TF32.  Samples past B are never read, so a
// ragged batch adds nothing.
#include <cuda_runtime.h>

#include "trunk_conv.cuh"

namespace {

using trunk::kC;
using trunk::kH;
using trunk::Trunk;
using trunk::conv1_len;
using trunk::conv2_len;

constexpr int kConvThreads = 512;
constexpr int kConvTile = 16;  // samples per block in passes 1 and 5
constexpr int kMaxFrames = 6;  // more frames: trunk_bwd_launch refuses them
// Pass 5's per-thread accumulators: [dW2 | db2] has 32 * 32 * 3 + 32
// entries, [dW1 | db1] at most 32 * kMaxFrames * 5 + 32.
constexpr int kPer2 = (kC * kC * 3 + kC + kConvThreads - 1) / kConvThreads;
constexpr int kPer1 = (kC * kMaxFrames * 5 + kC + kConvThreads - 1) / kConvThreads;

constexpr int kBM = 128, kBN = 128, kBK = 16;  // gemm block tile
constexpr int kGemmThreads = 256;              // 16 x 16, 8 x 8 outputs each
constexpr int kTM = kBM / 16, kTN = kBN / 16;

constexpr int kReduceThreads = 256;

// Per trunk, the gradients lie in one row of `grads` in the order w1, b1,
// w2, b2, wf, bf; a partial holds the first four.
struct Layout {
  int frames, l1, l2, nflat;
  int off_w2, psize, off_wf, off_bf, total;
  int blocks;  // conv blocks per trunk
};

Layout layout(int batch, int frames, int beams) {
  Layout s;
  s.frames = frames;
  s.l1 = conv1_len(beams);
  s.l2 = conv2_len(s.l1);
  s.nflat = kC * s.l2;
  s.off_w2 = kC * frames * 5 + kC;
  s.psize = s.off_w2 + kC * kC * 3 + kC;
  s.off_wf = s.psize;
  s.off_bf = s.off_wf + kH * s.nflat;
  s.total = s.off_bf + kH;
  s.blocks = (batch + kConvTile - 1) / kConvTile;
  return s;
}

size_t conv_smem_floats(int frames, int beams, bool backward) {
  const int l1 = conv1_len(beams);
  return static_cast<size_t>(kC * frames * 5 + kC + kC * kC * 3 + kC +
                             frames * beams + kC * l1) +
         (backward ? static_cast<size_t>(kC) * conv2_len(l1) : 0);
}

// Pass 1: act[t][b] = the flat conv2 features of sample b, trunk t.
__global__ void __launch_bounds__(kConvThreads)
    conv_fwd_kernel(const float* __restrict__ x, Trunk act_w, Trunk crt_w,
                    float* __restrict__ act, int batch, int frames,
                    int beams) {
  extern __shared__ float sh[];
  const int l1 = conv1_len(beams);
  const int nflat = kC * conv2_len(l1);
  const Trunk p = blockIdx.y == 0 ? act_w : crt_w;
  const int b0 = blockIdx.x * kConvTile;
  const int nb = min(kConvTile, batch - b0);
  const int tid = threadIdx.x;

  float* w1 = sh;
  float* b1 = w1 + kC * frames * 5;
  float* w2 = b1 + kC;
  float* b2 = w2 + kC * kC * 3;
  float* xs = b2 + kC;              // (F, NB) one sample
  float* y1 = xs + frames * beams;  // (32, L1) one sample
  trunk::load_conv_weights(p, w1, b1, w2, b2, frames, tid, kConvThreads);

  for (int s = 0; s < nb; ++s) {
    const size_t b = static_cast<size_t>(b0 + s);
    const float* xb = x + b * frames * beams;
    for (int i = tid; i < frames * beams; i += kConvThreads) xs[i] = xb[i];
    __syncthreads();
    trunk::conv1_relu(xs, w1, b1, y1, frames, beams, tid, kConvThreads);
    __syncthreads();
    trunk::conv2_relu(y1, w2, b2,
                      act + (blockIdx.y * static_cast<size_t>(batch) + b) * nflat,
                      l1, tid, kConvThreads);
    // xs is written again only after every thread has passed the barrier
    // after conv1, and y1 only after the next one.
  }
}

enum Epilogue { kStore = 0, kBiasReluGrad = 1, kMaskPositive = 2 };

// C (M, N) = A (M, K) B (K, N), per trunk t = blockIdx.z, with element
// (m, k) of A at a[t][m * sam + k * sak] and (k, n) of B at
// b[t][k * sbk + n * sbn].  Epilogues: kStore writes the sum;
// kBiasReluGrad writes aux[m][n] where sum + bias[n] > 0, else 0 (the fc1
// ReLU's backward); kMaskPositive writes the sum where aux[m][n] > 0, else 0
// (aux may be C itself: each element is read and then written by one thread).
struct Gemm {
  const float* a[2];
  const float* b[2];
  float* c[2];
  const float* bias[2];
  const float* aux[2];
  long long sam, sak, sbk, sbn;
  int ldc, ldaux, m, n, k;
};

// kAk: A's k index is the contiguous one; kBn: B's n index is.  They only
// choose which thread loads which element, so that loads are coalesced.
template <bool kAk, bool kBn, int kEpi>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(Gemm p) {
  __shared__ float as[kBK][kBM + 1];
  __shared__ float bs[kBK][kBN + 1];
  const int t = blockIdx.z;
  const float* a = p.a[t];
  const float* b = p.b[t];
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < p.k; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kGemmThreads) {
      const int mm = kAk ? i / kBK : i % kBM;
      const int kk = kAk ? i % kBK : i / kBM;
      const int m = m0 + mm, k = k0 + kk;
      as[kk][mm] = (m < p.m && k < p.k) ? a[m * p.sam + k * p.sak] : 0.0f;
    }
    for (int i = tid; i < kBN * kBK; i += kGemmThreads) {
      const int nn = kBn ? i % kBN : i / kBK;
      const int kk = kBn ? i / kBN : i % kBK;
      const int n = n0 + nn, k = k0 + kk;
      bs[kk][nn] = (n < p.n && k < p.k) ? b[k * p.sbk + n * p.sbn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= p.m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= p.n) continue;
      float v = acc[i][j];
      if (kEpi == kBiasReluGrad) {
        v = v + p.bias[t][n] > 0.0f
                ? p.aux[t][static_cast<size_t>(m) * p.ldaux + n]
                : 0.0f;
      } else if (kEpi == kMaskPositive) {
        v = p.aux[t][static_cast<size_t>(m) * p.ldaux + n] > 0.0f ? v : 0.0f;
      }
      p.c[t][static_cast<size_t>(m) * p.ldc + n] = v;
    }
  }
}

// Pass 5: per block of kConvTile samples and trunk, the sums over those
// samples of dW1, db1, dW2 and db2, into partial[t][block][0 : psize].
__global__ void __launch_bounds__(kConvThreads)
    conv_bwd_kernel(const float* __restrict__ x, Trunk act_w, Trunk crt_w,
                    const float* __restrict__ g2, float* __restrict__ partial,
                    int batch, int frames, int beams) {
  extern __shared__ float sh[];
  const int l1 = conv1_len(beams);
  const int l2 = conv2_len(l1);
  const int nflat = kC * l2;
  const int nw1 = kC * frames * 5;
  const int nw2 = kC * kC * 3;
  const Trunk p = blockIdx.y == 0 ? act_w : crt_w;
  const int b0 = blockIdx.x * kConvTile;
  const int nb = min(kConvTile, batch - b0);
  const int tid = threadIdx.x;

  float* w1 = sh;
  float* b1 = w1 + nw1;
  float* w2 = b1 + kC;
  float* b2 = w2 + nw2;
  float* xs = b2 + kC;              // (F, NB) one sample
  float* y1 = xs + frames * beams;  // (32, L1) conv1, then g3 in place
  float* gs = y1 + kC * l1;         // (32, L2) g2 of one sample
  trunk::load_conv_weights(p, w1, b1, w2, b2, frames, tid, kConvThreads);

  float acc2[kPer2], acc1[kPer1];
#pragma unroll
  for (int r = 0; r < kPer2; ++r) acc2[r] = 0.0f;
#pragma unroll
  for (int r = 0; r < kPer1; ++r) acc1[r] = 0.0f;

  for (int s = 0; s < nb; ++s) {
    const size_t b = static_cast<size_t>(b0 + s);
    const float* xb = x + b * frames * beams;
    const float* gb = g2 + (blockIdx.y * static_cast<size_t>(batch) + b) * nflat;
    for (int i = tid; i < frames * beams; i += kConvThreads) xs[i] = xb[i];
    for (int i = tid; i < nflat; i += kConvThreads) gs[i] = gb[i];
    __syncthreads();
    trunk::conv1_relu(xs, w1, b1, y1, frames, beams, tid, kConvThreads);
    __syncthreads();

    // dW2[c][ci][t] += sum_m g2[c][m] conv1[ci][2m + t - 1]; db2[c] += sum_m g2[c][m]
#pragma unroll
    for (int r = 0; r < kPer2; ++r) {
      const int e = tid + r * kConvThreads;
      if (e < nw2) {
        const int c = e / (kC * 3);
        const int ci = (e / 3) % kC;
        const int t = e % 3;
        const float* gr = gs + c * l2;
        const float* yr = y1 + ci * l1;
        float v = acc2[r];
        for (int m = 0; m < l2; ++m) {
          const int idx = 2 * m + t - 1;
          if (idx >= 0 && idx < l1) v = fmaf(gr[m], yr[idx], v);
        }
        acc2[r] = v;
      } else if (e < nw2 + kC) {
        const float* gr = gs + (e - nw2) * l2;
        float v = acc2[r];
        for (int m = 0; m < l2; ++m) v += gr[m];
        acc2[r] = v;
      }
    }
    __syncthreads();

    // Transposed conv2: conv1 position l takes tap t of conv2 position m
    // where 2m + t - 1 = l (even l: tap 1; odd l: tap 0 of the next
    // position and tap 2).  Masked by the conv1 ReLU, written over y1.
    for (int o = tid; o < kC * l1; o += kConvThreads) {
      const int ci = o / l1;
      const int l = o - ci * l1;
      float d = 0.0f;
      if (y1[o] > 0.0f) {
        for (int c = 0; c < kC; ++c) {
          const float* wr = w2 + (c * kC + ci) * 3;
          const float* gr = gs + c * l2;
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            const int num = l + 1 - t;
            if (num >= 0 && (num & 1) == 0 && (num >> 1) < l2)
              d = fmaf(gr[num >> 1], wr[t], d);
          }
        }
      }
      y1[o] = d;
    }
    __syncthreads();

    // dW1[c][f][t] += sum_l g3[c][l] x[f][2l + t - 1]; db1[c] += sum_l g3[c][l]
#pragma unroll
    for (int r = 0; r < kPer1; ++r) {
      const int e = tid + r * kConvThreads;
      if (e < nw1) {
        const int c = e / (frames * 5);
        const int f = (e / 5) % frames;
        const int t = e % 5;
        const float* gr = y1 + c * l1;
        const float* xr = xs + f * beams;
        float v = acc1[r];
        for (int l = 0; l < l1; ++l) {
          const int idx = 2 * l + t - 1;
          if (idx >= 0 && idx < beams) v = fmaf(gr[l], xr[idx], v);
        }
        acc1[r] = v;
      } else if (e < nw1 + kC) {
        const float* gr = y1 + (e - nw1) * l1;
        float v = acc1[r];
        for (int l = 0; l < l1; ++l) v += gr[l];
        acc1[r] = v;
      }
    }
    __syncthreads();
  }

  const int psize = nw1 + kC + nw2 + kC;
  float* out = partial + (blockIdx.y * static_cast<size_t>(gridDim.x) +
                          blockIdx.x) * psize;
#pragma unroll
  for (int r = 0; r < kPer1; ++r) {
    const int e = tid + r * kConvThreads;
    if (e < nw1 + kC) out[e] = acc1[r];
  }
#pragma unroll
  for (int r = 0; r < kPer2; ++r) {
    const int e = tid + r * kConvThreads;
    if (e < nw2 + kC) out[nw1 + kC + e] = acc2[r];
  }
}

// Pass 6: one warp per (trunk, element) of [w1 b1 w2 b2] (from the partials)
// and of bf (from the rows of g1).  Lanes take strided rows; the butterfly
// adds them in a fixed order.
__global__ void __launch_bounds__(kReduceThreads)
    reduce_kernel(const float* __restrict__ partial,
                  const float* __restrict__ g1, float* __restrict__ grads,
                  int batch, int blocks, int psize, int off_bf, int total) {
  const int jobs = psize + kH;
  const int w = (blockIdx.x * kReduceThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= 2 * jobs) return;
  const int t = w / jobs;
  const int e = w - t * jobs;
  float v = 0.0f;
  if (e < psize) {
    const float* src = partial + static_cast<size_t>(t) * blocks * psize + e;
    for (int i = lane; i < blocks; i += 32) v += src[static_cast<size_t>(i) * psize];
  } else {
    const float* src = g1 + static_cast<size_t>(t) * batch * kH + (e - psize);
    for (int i = lane; i < batch; i += 32) v += src[static_cast<size_t>(i) * kH];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0)
    grads[static_cast<size_t>(t) * total + (e < psize ? e : off_bf + e - psize)] = v;
}

template <bool kAk, bool kBn, int kEpi>
cudaError_t run_gemm(const Gemm& p, cudaStream_t stream) {
  const dim3 grid((p.n + kBN - 1) / kBN, (p.m + kBM - 1) / kBM, 2);
  gemm_kernel<kAk, kBn, kEpi><<<grid, kGemmThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Floats of workspace that trunk_bwd_launch needs for this batch.
extern "C" long long trunk_bwd_workspace_floats(int batch, int frames,
                                                int beams) {
  const Layout s = layout(batch, frames, beams);
  return 2LL * batch * s.nflat + 2LL * batch * kH +
         2LL * s.blocks * s.psize;
}

// x (B, F, NB) scans; w: the 12 weight pointers, actor trunk then critic
// trunk, each in the order w1, b1, w2, b2, wf, bf of struct Trunk; g
// (2, B, 256) feature cotangent; grads (2, total): per trunk the gradients of
// w1, b1, w2, b2, wf, bf back to back, each in its weight's layout; work:
// trunk_bwd_workspace_floats floats.  Returns cudaErrorInvalidValue for more
// than kMaxFrames frames.
extern "C" int trunk_bwd_launch(const void* x, const void* const* w,
                                const void* g, void* grads, void* work,
                                int batch, int frames, int beams, int device,
                                void* stream) {
  if (frames > kMaxFrames) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* const* f = reinterpret_cast<const float* const*>(w);
  const Trunk tr[2] = {{f[0], f[1], f[2], f[3], f[4], f[5]},
                       {f[6], f[7], f[8], f[9], f[10], f[11]}};
  const Layout s = layout(batch, frames, beams);
  const float* xs = static_cast<const float*>(x);
  const float* gg = static_cast<const float*>(g);
  float* out = static_cast<float*>(grads);
  float* act = static_cast<float*>(work);                // (2, B, nflat)
  float* g1 = act + 2LL * batch * s.nflat;               // (2, B, 256)
  float* partial = g1 + 2LL * batch * kH;                // (2, blocks, psize)
  const size_t bn = static_cast<size_t>(batch) * s.nflat;
  const size_t bh = static_cast<size_t>(batch) * kH;

  // 1. the flat conv features
  size_t smem = sizeof(float) * conv_smem_floats(frames, beams, false);
  err = cudaFuncSetAttribute(conv_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 conv_grid(s.blocks, 2);
  conv_fwd_kernel<<<conv_grid, kConvThreads, smem, st>>>(xs, tr[0], tr[1], act,
                                                         batch, frames, beams);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 2. g1 = g [flat Wf^T + bf > 0]: M = B, N = 256, K = nflat
  Gemm p{};
  for (int t = 0; t < 2; ++t) {
    p.a[t] = act + t * bn;
    p.b[t] = tr[t].wf;
    p.c[t] = g1 + t * bh;
    p.bias[t] = tr[t].bf;
    p.aux[t] = gg + t * bh;
  }
  p.sam = s.nflat, p.sak = 1, p.sbk = 1, p.sbn = s.nflat;
  p.ldc = kH, p.ldaux = kH, p.m = batch, p.n = kH, p.k = s.nflat;
  if ((err = run_gemm<true, false, kBiasReluGrad>(p, st)) != cudaSuccess) return err;

  // 3. dWf = g1^T flat: M = 256, N = nflat, K = B
  p = Gemm{};
  for (int t = 0; t < 2; ++t) {
    p.a[t] = g1 + t * bh;
    p.b[t] = act + t * bn;
    p.c[t] = out + static_cast<size_t>(t) * s.total + s.off_wf;
  }
  p.sam = 1, p.sak = kH, p.sbk = s.nflat, p.sbn = 1;
  p.ldc = s.nflat, p.m = kH, p.n = s.nflat, p.k = batch;
  if ((err = run_gemm<false, true, kStore>(p, st)) != cudaSuccess) return err;

  // 4. g2 = (g1 Wf) [flat > 0], over act: M = B, N = nflat, K = 256
  p = Gemm{};
  for (int t = 0; t < 2; ++t) {
    p.a[t] = g1 + t * bh;
    p.b[t] = tr[t].wf;
    p.c[t] = act + t * bn;
    p.aux[t] = act + t * bn;
  }
  p.sam = kH, p.sak = 1, p.sbk = s.nflat, p.sbn = 1;
  p.ldc = s.nflat, p.ldaux = s.nflat, p.m = batch, p.n = s.nflat, p.k = kH;
  if ((err = run_gemm<true, true, kMaskPositive>(p, st)) != cudaSuccess) return err;

  // 5. per-block partial sums of dW1, db1, dW2, db2
  smem = sizeof(float) * conv_smem_floats(frames, beams, true);
  err = cudaFuncSetAttribute(conv_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  conv_bwd_kernel<<<conv_grid, kConvThreads, smem, st>>>(
      xs, tr[0], tr[1], act, partial, batch, frames, beams);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 6. the batch sums of the small gradients and of bf
  const int warps = 2 * (s.psize + kH);
  const int blocks = (warps * 32 + kReduceThreads - 1) / kReduceThreads;
  reduce_kernel<<<blocks, kReduceThreads, 0, st>>>(partial, g1, out, batch,
                                                   s.blocks, s.psize, s.off_bf,
                                                   s.total);
  return cudaGetLastError();
}
