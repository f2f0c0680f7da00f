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
//   1. the conv pass of the forward kernel (trunk_conv.cuh): the flat
//      features, written to a workspace `act` (2, B, 32 L2).
//   2. product <fc1>: g1 = g [act Wf^T + bf > 0] -> workspace (2, B, 256),
//      split over K as the forward's fc1 is, so the mask is the forward's.
//   3. product <dWf>: dWf = g1^T act, K = the batch, split into fixed sample
//      ranges whose partials a fixed-order pass adds.
//   4. product <dflat>: g2 = (g1 Wf) [act > 0], written over `act` in place.
//   5. conv_bwd: per sample, recompute conv1, then dW2 and db2, the
//      transposed conv2 onto the conv1 grid masked by the conv1 ReLU (g3),
//      dW1 and db1; block i sums a fixed range of samples in registers and
//      writes one partial.
//   6. reduce: one warp per small-gradient element sums the blocks' partials
//      (and, for dbf, the rows of g1) in a fixed order.
//
// Two modes, as the forward's (trunk_bf16.cuh).  In bf16 mode the cotangent
// g is bf16, and every product operand is rounded to bf16 as the JAX
// kernel's precision="default" rounds it: the scans, the weights, the
// conv1 and flat activations (rounded where the conv pass makes them; the
// flat features stay a float32 workspace holding bf16 values, since g2
// overwrites them in place), and the cotangents g1 (bf16 already), g2 and
// g3.  The bias gradients sum g1, g2 and g3 unrounded in float32, as the
// JAX kernel's do, so conv_bwd sums each g2 element into db2 before it
// rounds it in shared memory, and sums g3 into db1 beside the rounded
// products of dW1.  The weight gradients are float32.
//
// The products run on trunk_gemm.cuh's core.  conv_bwd is register tiled
// like the conv pass: dW2 is a product (32 x 96) with K = positions x
// samples, a thread owning 8 output channels x 3 taps of one input channel;
// the transposed conv2 a per-sample product owning 4 input channels x 4
// positions (even and odd); dW1 one (channel, frame) pair's 5 taps over a
// range of positions.  Its shared memory (~71 KB) lets two blocks share an
// SM.  Samples past B are never read, so a ragged batch adds nothing.
#include <cuda_runtime.h>

#include "trunk_conv.cuh"
#include "trunk_gemm.cuh"

namespace {

using trunk::bf16;
using trunk::ceil_div;
using trunk::ConvGeom;
using trunk::kC;
using trunk::kConvThreads;
using trunk::kH;
using trunk::kReduceThreads;
using trunk::Trunk;

// Per trunk, the gradients lie in one row of `grads` in the order w1, b1,
// w2, b2, wf, bf; a partial holds the first four.
struct Layout {
  ConvGeom g;
  int nw1, nw2, psize, off_wf, off_bf, total;
  int blocks;  // conv_bwd blocks per trunk
  int nchunk;  // position ranges of dW1 per (channel, frame)
  int fc1_splits, dwf_splits;  // split-K ranges of the fc1 recompute, dWf
  int gs;      // floats per row of g2 in shared memory
  long long act, g1, partial, part, work;  // workspace offsets and size
};

Layout layout(int batch, int frames, int beams, int conv_blocks, int fc1_splits,
              int dwf_splits) {
  Layout s;
  s.g = trunk::conv_geom(frames, beams);
  s.nw1 = kC * frames * 5;
  s.nw2 = kC * kC * 3;
  s.psize = s.nw1 + kC + s.nw2 + kC;
  s.off_wf = s.psize;
  s.off_bf = s.off_wf + kH * s.g.nflat;
  s.total = s.off_bf + kH;
  s.blocks = conv_blocks;
  s.nchunk = 8 / frames;
  s.fc1_splits = fc1_splits;
  s.dwf_splits = dwf_splits;
  s.gs = s.g.l2 + 4;
  s.act = 0;
  s.g1 = 2LL * batch * s.g.nflat;
  s.partial = s.g1 + 2LL * batch * kH;
  s.part = s.partial + 2LL * s.blocks * s.psize;
  const long long fc1 = trunk::gemm_part_floats(batch, kH, fc1_splits);
  const long long dwf = trunk::gemm_part_floats(kH, s.g.nflat, dwf_splits);
  s.work = s.part + (fc1 > dwf ? fc1 : dwf);
  return s;
}

// conv_bwd's shared memory: w1t, b1, w2 by input channel, one sample's x
// planes, then a region that holds its conv1 planes (g3 in place) and its
// g2 rows while samples are summed and the end-of-block scratch after.
struct BwdSmem {
  int w1t, b1, w2b, x, y1, g2, scratch, floats;
};

__host__ __device__ inline int scratch_floats(const Layout& s) {
  return 2 * s.nw2 + kC * 8 + s.nchunk * s.nw1 + s.nchunk * kC;
}

__host__ __device__ inline BwdSmem bwd_smem(const Layout& s) {
  BwdSmem m;
  m.w1t = 0;
  m.b1 = m.w1t + s.nw1;
  m.w2b = m.b1 + kC;
  m.x = m.w2b + s.nw2;
  m.y1 = m.x + trunk::x_floats(s.g);
  m.g2 = m.y1 + trunk::y1_floats(s.g);
  m.scratch = m.y1;
  const int region = trunk::y1_floats(s.g) + kC * s.gs;
  const int scratch = scratch_floats(s);
  m.floats = m.y1 + (region > scratch ? region : scratch);
  return m;
}

// Pass 5: per conv block and trunk, the sums over the block's samples
// (trunk::block_samples) of dW1, db1, dW2 and db2, into
// partial[t][block][0 : psize].  kRound: bf16 mode; TX: the scans' type.
template <bool kRound, class TX>
__global__ void __launch_bounds__(kConvThreads, 2)
    conv_bwd_kernel(const TX* __restrict__ x, Trunk act_w, Trunk crt_w,
                    const float* __restrict__ g2, float* __restrict__ partial,
                    Layout s, int batch) {
  extern __shared__ __align__(16) float sh[];
  const ConvGeom& g = s.g;
  const BwdSmem sm = bwd_smem(s);
  const Trunk p = blockIdx.y == 0 ? act_w : crt_w;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  float* w1t = sh + sm.w1t;
  float* b1 = sh + sm.b1;
  float* w2b = sh + sm.w2b;
  float* xsm = sh + sm.x;
  float* y1 = sh + sm.y1;  // even rows, then odd rows; g3 in place
  float* gsm = sh + sm.g2;
  trunk::stage_conv1_weights<kRound>(p, w1t, b1, g.frames, tid);
  trunk::stage_conv2_weights<false, kRound>(p, w2b, tid);
  trunk::zero_pads(xsm, y1, g, 1, tid);
  for (int i = tid; i < kC * 4; i += kConvThreads)
    gsm[(i >> 2) * s.gs + g.l2 + (i & 3)] = 0.0f;

  // dW2: warp w owns output channels 8 (w % 4) .. + 7 and half w / 4 of the
  // position groups; lane = input channel.  db2: channel tid / 8, part
  // tid % 8 of the positions.  dW1: warp w < F * nchunk owns frame w % F,
  // position range w / F; lane = output channel.
  const int nq = g.l2 / 4;  // position groups of conv2
  const int c0 = (warp & 3) * 8;
  const int q_half = ceil_div(nq, 2);
  const int q_lo = (warp >> 2) * q_half, q_hi = min(nq, q_lo + q_half);
  const int bc = tid >> 3;
  const int m_part = ceil_div(g.l2, 8);
  const int m_lo = (tid & 7) * m_part, m_hi = min(g.l2, m_lo + m_part);
  const int f1 = warp % g.frames, ch = warp / g.frames;
  const bool dw1 = warp < g.frames * s.nchunk;
  const int n8 = g.half / 8;
  const int l_part = ceil_div(n8, s.nchunk);
  const int k8_lo = ch * l_part, k8_hi = min(n8, k8_lo + l_part);
  float acc2[8][3], accb2 = 0.0f, acc1[5], accb1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int t = 0; t < 3; ++t) acc2[c][t] = 0.0f;
#pragma unroll
  for (int t = 0; t < 5; ++t) acc1[t] = 0.0f;

  int b_begin, b_end;
  trunk::block_samples(batch, s.blocks, blockIdx.x, &b_begin, &b_end);
  for (int b = b_begin; b < b_end; ++b) {
    const float* gb = g2 + (blockIdx.y * static_cast<size_t>(batch) + b) * g.nflat;
    for (int i = tid; i < g.nflat / 4; i += kConvThreads) {
      const int c = i / nq;
      const int q = i - c * nq;
      trunk::cp_async16(gsm + c * s.gs + 4 * q, gb + 4 * i, true);
    }
    trunk::cp_async_commit();
    trunk::load_x<kRound>(x + static_cast<size_t>(b) * g.frames * g.beams,
                          xsm, g, tid);
    trunk::cp_async_wait<0>();
    __syncthreads();
    for (int it = tid; it < g.half; it += kConvThreads)  // 4 x (half / 4) items
      trunk::conv1_item<kRound>(xsm, w1t, b1, y1, g, it / (g.half / 4),
                                it % (g.half / 4));
    // db2 from g2 as it came; then, in bf16 mode, the same elements rounded
    // for the products (each (channel, position) is one thread's)
    for (int m = m_lo; m < m_hi; ++m) {
      const float v = gsm[bc * s.gs + m];
      accb2 += v;
      if (kRound) gsm[bc * s.gs + m] = trunk::round_bf16(v);
    }
    __syncthreads();

    // dW2[c][ci][t] += sum_m g2[c][m] conv1[ci][2m + t - 1]
    {
      const float* ye = y1 + lane * g.ys;
      const float* yo = y1 + (kC + lane) * g.ys;
      for (int q = q_lo; q < q_hi; ++q) {
        const int m = 4 * q;
        const float4 e4 = *reinterpret_cast<const float4*>(ye + m);
        const float4 o4 = *reinterpret_cast<const float4*>(yo + m);
        const float yv[3][4] = {{o4.x, o4.y, o4.z, o4.w},
                                {e4.x, e4.y, e4.z, e4.w},
                                {o4.y, o4.z, o4.w, yo[m + 4]}};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float4 g4 = *reinterpret_cast<const float4*>(gsm + (c0 + c) * s.gs + m);
          const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int t = 0; t < 3; ++t) acc2[c][t] = fmaf(gv[j], yv[t][j], acc2[c][t]);
        }
      }
    }
    __syncthreads();

    // Transposed conv2: conv1 position 2q takes tap 1 of conv2 position q;
    // 2q + 1 takes tap 2 of position q and tap 0 of q + 1.  Masked by the
    // conv1 ReLU and written over the conv1 planes.
    for (int it = tid; it < 8 * nq; it += kConvThreads) {
      const int ci0 = (it / nq) * 4, q0 = (it % nq) * 4;
      float ev[4][4], ov[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ev[i][j] = ov[i][j] = 0.0f;
#pragma unroll 2
      for (int c = 0; c < kC; ++c) {
        const float* gr = gsm + c * s.gs + q0;
        const float4 g4 = *reinterpret_cast<const float4*>(gr);
        const float gv[5] = {g4.x, g4.y, g4.z, g4.w, gr[4]};
        const float4 w0 = *reinterpret_cast<const float4*>(w2b + (c * 3 + 0) * kC + ci0);
        const float4 w1 = *reinterpret_cast<const float4*>(w2b + (c * 3 + 1) * kC + ci0);
        const float4 w2 = *reinterpret_cast<const float4*>(w2b + (c * 3 + 2) * kC + ci0);
        const float wt[3][4] = {{w0.x, w0.y, w0.z, w0.w},
                                {w1.x, w1.y, w1.z, w1.w},
                                {w2.x, w2.y, w2.z, w2.w}};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ev[i][j] = fmaf(wt[1][i], gv[j], ev[i][j]);
            ov[i][j] = fmaf(wt[2][i], gv[j], ov[i][j]);
            ov[i][j] = fmaf(wt[0][i], gv[j + 1], ov[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* ye = y1 + (ci0 + i) * g.ys + q0;
        float* yo = y1 + (kC + ci0 + i) * g.ys + q0 + 1;
        const float4 e4 = *reinterpret_cast<const float4*>(ye);
        *reinterpret_cast<float4*>(ye) = make_float4(
            e4.x > 0.0f ? ev[i][0] : 0.0f, e4.y > 0.0f ? ev[i][1] : 0.0f,
            e4.z > 0.0f ? ev[i][2] : 0.0f, e4.w > 0.0f ? ev[i][3] : 0.0f);
#pragma unroll
        for (int j = 0; j < 4; ++j) yo[j] = yo[j] > 0.0f ? ov[i][j] : 0.0f;
      }
    }
    __syncthreads();

    // dW1[c][f][t] += sum_l g3[c][l] x[f][2l + t - 1]; db1[c] += sum_l g3[c][l]
    if (dw1) {
      const float* ge = y1 + lane * g.ys;
      const float* go = y1 + (kC + lane) * g.ys;
      const float* xe = xsm + f1 * g.xs;
      const float* xo = xe + g.frames * g.xs;
      for (int k8 = k8_lo; k8 < k8_hi; ++k8) {
        const int l0 = 8 * k8;
        const float4 e4 = *reinterpret_cast<const float4*>(ge + l0 / 2);
        const float4 o4 = *reinterpret_cast<const float4*>(go + l0 / 2);
        const float gl[8] = {e4.x, o4.y, e4.y, o4.z, e4.z, o4.w, e4.w,
                             go[l0 / 2 + 4]};
        float gr[8];  // g3 as a product operand
#pragma unroll
        for (int j = 0; j < 8; ++j) gr[j] = trunk::operand<kRound>(gl[j]);
        const float4 xe0 = *reinterpret_cast<const float4*>(xe + l0);
        const float4 xe1 = *reinterpret_cast<const float4*>(xe + l0 + 4);
        const float4 xo0 = *reinterpret_cast<const float4*>(xo + l0);
        const float4 xo1 = *reinterpret_cast<const float4*>(xo + l0 + 4);
        const float2 xo2 = *reinterpret_cast<const float2*>(xo + l0 + 8);
        const float ex[9] = {xe0.x, xe0.y, xe0.z, xe0.w, xe1.x, xe1.y, xe1.z,
                             xe1.w, xe[l0 + 8]};
        const float ox[10] = {xo0.x, xo0.y, xo0.z, xo0.w, xo1.x, xo1.y,
                              xo1.z, xo1.w, xo2.x, xo2.y};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int t = 0; t < 5; ++t)
            acc1[t] = fmaf(gr[j], (t & 1) ? ex[j + t / 2] : ox[j + t / 2], acc1[t]);
          if (f1 == 0) accb1 += gl[j];
        }
      }
    }
    __syncthreads();  // the next sample overwrites x, conv1 and g2
  }

  // The block's sums through shared memory, added in a fixed order.
  float* sc2 = sh + sm.scratch;         // dW2 per position half
  float* scb2 = sc2 + 2 * s.nw2;        // db2 per part
  float* sc1 = scb2 + kC * 8;           // dW1 per position range
  float* scb1 = sc1 + s.nchunk * s.nw1; // db1 per position range
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int t = 0; t < 3; ++t)
      sc2[(warp >> 2) * s.nw2 + ((c0 + c) * kC + lane) * 3 + t] = acc2[c][t];
  scb2[tid] = accb2;
  if (dw1) {
#pragma unroll
    for (int t = 0; t < 5; ++t)
      sc1[ch * s.nw1 + (lane * g.frames + f1) * 5 + t] = acc1[t];
    if (f1 == 0) scb1[ch * kC + lane] = accb1;
  }
  __syncthreads();
  float* out = partial + (blockIdx.y * static_cast<size_t>(gridDim.x) +
                          blockIdx.x) * s.psize;
  for (int e = tid; e < s.nw1; e += kConvThreads) {
    float v = sc1[e];
    for (int r = 1; r < s.nchunk; ++r) v += sc1[r * s.nw1 + e];
    out[e] = v;
  }
  for (int c = tid; c < kC; c += kConvThreads) {
    float v = scb1[c];
    for (int r = 1; r < s.nchunk; ++r) v += scb1[r * kC + c];
    out[s.nw1 + c] = v;
    float u = scb2[c * 8];
    for (int r = 1; r < 8; ++r) u += scb2[c * 8 + r];
    out[s.nw1 + kC + s.nw2 + c] = u;
  }
  for (int e = tid; e < s.nw2; e += kConvThreads)
    out[s.nw1 + kC + e] = sc2[e] + sc2[s.nw2 + e];
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

// The six passes.  kRound: bf16 mode; TX, TG: the scans' and the
// cotangent's types.
template <bool kRound, class TX, class TG>
cudaError_t backward(const TX* xs, const Trunk* tr, const TG* g, float* out,
                     float* ws, const Layout& s, int batch, cudaStream_t st) {
  float* act = ws + s.act;          // (2, B, nflat), then g2 in place
  float* g1 = ws + s.g1;            // (2, B, 256)
  float* partial = ws + s.partial;  // (2, blocks, psize)
  float* part = ws + s.part;        // split-K partials of passes 2 and 3
  const int nflat = s.g.nflat;
  const size_t bn = static_cast<size_t>(batch) * nflat;
  const size_t bh = static_cast<size_t>(batch) * kH;

  // 1. the flat conv features
  cudaError_t err = trunk::launch_conv_fwd<kRound>(
      xs, tr, act, batch, s.g.frames, s.g.beams, s.blocks, st);
  if (err != cudaSuccess) return err;

  // 2. g1 = g [act Wf^T + bf > 0]: M = B, N = 256, K = nflat
  trunk::Gemm p{};
  for (int t = 0; t < 2; ++t) {
    p.a[t] = act + t * bn;
    p.b[t] = tr[t].wf;
    p.c[t] = g1 + t * bh;
    p.bias[t] = tr[t].bf;
    p.aux[t] = g + t * bh;
  }
  p.lda = nflat, p.ldb = nflat, p.ldc = kH, p.ldaux = kH;
  p.m = batch, p.n = kH, p.k = nflat;
  p.part = part, p.splits = s.fc1_splits;
  p.kchunk = ceil_div(ceil_div(nflat, trunk::kBK), s.fc1_splits);
  err = trunk::run_gemm<true, true, trunk::kBiasReluGrad, float, float, TG,
                        kRound>(p, st);
  if (err != cudaSuccess) return err;

  // 3. dWf = g1^T act: M = 256, N = nflat, K = B
  p = trunk::Gemm{};
  for (int t = 0; t < 2; ++t) {
    p.a[t] = g1 + t * bh;
    p.b[t] = act + t * bn;
    p.c[t] = out + static_cast<size_t>(t) * s.total + s.off_wf;
  }
  p.lda = kH, p.ldb = nflat, p.ldc = nflat;
  p.m = kH, p.n = nflat, p.k = batch;
  p.part = part, p.splits = s.dwf_splits;
  p.kchunk = ceil_div(ceil_div(batch, trunk::kBK), s.dwf_splits);
  err = trunk::run_gemm<false, false, trunk::kStore>(p, st);
  if (err != cudaSuccess) return err;

  // 4. g2 = (g1 Wf) [act > 0], over act: M = B, N = nflat, K = 256
  p = trunk::Gemm{};
  for (int t = 0; t < 2; ++t) {
    p.a[t] = g1 + t * bh;
    p.b[t] = tr[t].wf;
    p.c[t] = act + t * bn;
    p.aux[t] = act + t * bn;
  }
  p.lda = kH, p.ldb = nflat, p.ldc = nflat, p.ldaux = nflat;
  p.m = batch, p.n = nflat, p.k = kH;
  p.splits = 1, p.kchunk = kH / trunk::kBK;
  err = trunk::run_gemm<true, false, trunk::kMaskPositive, float, float,
                        float, kRound>(p, st);
  if (err != cudaSuccess) return err;

  // 5. per-block partial sums of dW1, db1, dW2, db2
  const size_t smem = sizeof(float) * bwd_smem(s).floats;
  auto conv_bwd = conv_bwd_kernel<kRound, TX>;
  err = cudaFuncSetAttribute(conv_bwd,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  conv_bwd<<<dim3(s.blocks, 2), kConvThreads, smem, st>>>(
      xs, tr[0], tr[1], act, partial, s, batch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 6. the batch sums of the small gradients and of bf
  const int warps = 2 * (s.psize + kH);
  const int blocks = (warps * 32 + kReduceThreads - 1) / kReduceThreads;
  reduce_kernel<<<blocks, kReduceThreads, 0, st>>>(partial, g1, out, batch,
                                                   s.blocks, s.psize, s.off_bf,
                                                   s.total);
  return cudaGetLastError();
}

}  // namespace

// Floats of workspace that trunk_bwd_launch needs for this batch and plan.
extern "C" long long trunk_bwd_workspace_floats(int batch, int frames,
                                                int beams, int conv_blocks,
                                                int fc1_splits,
                                                int dwf_splits) {
  return layout(batch, frames, beams, conv_blocks, fc1_splits, dwf_splits)
      .work;
}

// x (B, F, NB) scans, float32 or (x_bf16) bf16; w: the 12 float32 weight
// pointers, actor trunk then critic trunk, each in the order w1, b1, w2, b2,
// wf, bf of struct Trunk; g (2, B, 256) feature cotangent, float32 or
// (bf16_mode) bf16; grads (2, total) float32: per trunk the gradients of
// w1, b1, w2, b2, wf, bf back to back, each in its weight's layout; work:
// work_floats floats.  The plan: conv_blocks conv blocks per trunk (the
// forward's; trunk_conv.cuh, block_samples), fc1_splits ranges of fc1's K
// (the forward's), dwf_splits sample ranges of dWf.  bf16_mode: the bf16
// mode of trunk_bf16.cuh.  Returns cudaErrorInvalidValue for shapes the
// kernels do not take, a plan that leaves a range empty, or too little
// workspace.
extern "C" int trunk_bwd_launch(const void* x, const void* const* w,
                                const void* g, void* grads, void* work,
                                long long work_floats, int batch, int frames,
                                int beams, int conv_blocks, int fc1_splits,
                                int dwf_splits, int x_bf16, int bf16_mode,
                                int device, void* stream) {
  if (!trunk::conv_shapes_ok(frames, beams) || batch < 1 ||
      conv_blocks < 1 || conv_blocks > ceil_div(batch, trunk::kFwdGroup) ||
      fc1_splits < 1 || dwf_splits < 1)
    return cudaErrorInvalidValue;
  const Layout s = layout(batch, frames, beams, conv_blocks, fc1_splits,
                          dwf_splits);
  if (work_floats < s.work) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* const* f = reinterpret_cast<const float* const*>(w);
  const Trunk tr[2] = {{f[0], f[1], f[2], f[3], f[4], f[5]},
                       {f[6], f[7], f[8], f[9], f[10], f[11]}};
  float* out = static_cast<float*>(grads);
  float* ws = static_cast<float*>(work);
  const bool round = bf16_mode != 0;
  if (x_bf16)
    return round ? backward<true>(static_cast<const bf16*>(x), tr,
                                  static_cast<const bf16*>(g), out, ws, s,
                                  batch, st)
                 : backward<false>(static_cast<const bf16*>(x), tr,
                                   static_cast<const float*>(g), out, ws, s,
                                   batch, st);
  return round ? backward<true>(static_cast<const float*>(x), tr,
                                static_cast<const bf16*>(g), out, ws, s,
                                batch, st)
               : backward<false>(static_cast<const float*>(x), tr,
                                 static_cast<const float*>(g), out, ws, s,
                                 batch, st);
}
