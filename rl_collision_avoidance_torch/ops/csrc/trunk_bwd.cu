// Twin-trunk backward kernel: the six weight gradients of both CNNPolicy
// feature trunks from the (2, B, 256) feature cotangent g, summed over the
// batch.  No gradient flows to the scans.
//
// Replaces rl_collision_avoidance_tpu/ops/trunk_pallas.py::_bwd_kernel
// (reached through _bwd_call and the fused_trunks custom_vjp).  Its plain
// PyTorch version is rl_collision_avoidance_torch/ops/trunk_cuda.py::
// twin_trunks_grads_plain (autograd through F.conv1d / F.linear).
//
// What bounds it on an H100: operations.  Per sample and trunk it does
// ~9.1 MFLOP: the recomputed forward (conv1 0.24, conv2 0.79, fc1 2.1), then
// dWf 2.1, dflat 2.1, dW2 0.79, the transposed conv2 0.79 and dW1 0.24.  At
// B = 32,768 that is ~0.6 TFLOP: ~8.9 ms at the 67 TFLOP/s FFMA peak in
// float32 mode, 0.61 ms at the 989 TFLOP/s bf16 tensor-core peak in bf16
// mode.  The bf16 mode also moves its bf16 workspace: the flat features
// (0.54 GB at B = 32,768) written once and read by three passes, and g2
// written over them and read once, ~3.2 GB, ~1 ms at 3.35 TB/s.
//
// The TPU kernel sums every gradient over a sequential grid, in place.  On
// the card blocks run in parallel and in no order, and this kernel uses no
// float atomics, so the same inputs give the same bits.  The batch sums are
// split into passes that each own their outputs and sum in a fixed order:
//
//   1. the conv pass of the forward kernel: the flat features, written to a
//      workspace `act` (2, B, 32 L2).
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
// Two modes, as the forward's.  float32 mode: every pass on the FFMA path
// (trunk_conv.cuh, trunk_gemm.cuh), the workspace float32 (1.16 GB at B =
// 32,768).  conv_bwd is register tiled like the conv pass: dW2 is a product
// (32 x 96) with K = positions x samples, a thread owning 8 output channels
// x 3 taps of one input channel; the transposed conv2 a per-sample product
// owning 4 input channels x 4 positions (even and odd); dW1 one (channel,
// frame) pair's 5 taps over a range of positions.  Its shared memory (~71
// KB) lets two blocks share an SM.
//
// bf16 mode (the JAX kernel's precision="default"): every product on the
// tensor cores (trunk_conv_mma.cuh, trunk_mma.cuh and conv_bwd_mma below),
// every product operand rounded to bf16 as the JAX kernel rounds it: the
// scans, the weights, the conv1 and flat activations, and the cotangents g1
// (the bf16 g masked), g2 and g3.  The bias gradients sum g1, g2 and g3
// unrounded in float32, as the JAX kernel's do: dflat's epilogue sums its
// float32 g2 per (M tile, column) before it stores g2 as bf16 over `act`
// (db2_kernel adds each channel's columns), and conv_bwd_mma sums its
// float32 g3 into db1 before it rounds it.  The weight gradients are
// float32.  The workspace holds `act` (then g2), g1 and the fc1 weight as
// bf16: 0.60 GB at B = 32,768.
// conv_bwd_mma's three products fit m16n8k16: dW2 (M = 32 channels, N = 96
// taps x input channels, K = positions x samples), the transposed conv2 (M
// = positions of one conv1 plane, N = 32, K = 32 or 64 per tap pair) and
// dW1 (M = 32, N = 5F taps, K = conv1 positions x samples, the scans'
// fragments gathered from shared memory).  g2 is staged position-major,
// so every operand is a whole 16-byte row for ldmatrix.
//
// Samples past B are never read, so a ragged batch adds nothing.
#include <cuda_runtime.h>

#include "trunk_conv.cuh"
#include "trunk_conv_mma.cuh"
#include "trunk_gemm.cuh"
#include "trunk_mma.cuh"

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
  int mtiles;  // bf16: dflat's M tiles
  // workspace offsets and size, in floats; bf16 mode: act and g1 bf16, wf16
  // the bf16 fc1 weight, db2 the dflat blocks' column sums (2, mtiles,
  // nflat), bias dbf's sums over kBiasRanges row ranges of g1
  long long act, g1, wf16, partial, db2, bias, part, work;
};

constexpr int kBiasRanges = 64;

Layout layout(int batch, int frames, int beams, int conv_blocks, int fc1_splits,
              int dwf_splits, bool bf16_mode) {
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
  s.mtiles = ceil_div(batch, trunk::mma::kBM);
  const long long half = bf16_mode ? 2 : 1;  // elements per float
  s.act = 0;
  s.g1 = 2LL * batch * s.g.nflat / half;
  s.wf16 = s.g1 + 2LL * batch * kH / half;
  s.partial = s.wf16 + (bf16_mode ? 1LL * kH * s.g.nflat : 0);
  s.db2 = s.partial + 2LL * s.blocks * s.psize;
  s.bias = s.db2 + (bf16_mode ? 2LL * s.mtiles * s.g.nflat : 0);
  s.part = s.bias + (bf16_mode ? 2LL * kBiasRanges * kH : 0);
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
// partial[t][block][0 : psize].  TX: the scans' type.
template <class TX>
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
  trunk::stage_conv1_weights(p, w1t, b1, g.frames, tid);
  trunk::stage_conv2_weights<false>(p, w2b, tid);
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
    trunk::load_x(x + static_cast<size_t>(b) * g.frames * g.beams, xsm, g,
                  tid);
    trunk::cp_async_wait<0>();
    __syncthreads();
    for (int it = tid; it < g.half; it += kConvThreads)  // 4 x (half / 4) items
      trunk::conv1_item(xsm, w1t, b1, y1, g, it / (g.half / 4),
                        it % (g.half / 4));
    for (int m = m_lo; m < m_hi; ++m) accb2 += gsm[bc * s.gs + m];
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
            acc1[t] = fmaf(gl[j], (t & 1) ? ex[j + t / 2] : ox[j + t / 2], acc1[t]);
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

// The six passes in float32 mode.  TX: the scans' type.
template <class TX>
cudaError_t backward_f32(const TX* xs, const Trunk* tr, const float* g,
                         float* out, float* ws, const Layout& s, int batch,
                         cudaStream_t st) {
  float* act = ws + s.act;          // (2, B, nflat), then g2 in place
  float* g1 = ws + s.g1;            // (2, B, 256)
  float* partial = ws + s.partial;  // (2, blocks, psize)
  float* part = ws + s.part;        // split-K partials of passes 2 and 3
  const int nflat = s.g.nflat;
  const size_t bn = static_cast<size_t>(batch) * nflat;
  const size_t bh = static_cast<size_t>(batch) * kH;

  // 1. the flat conv features
  cudaError_t err = trunk::launch_conv_fwd(xs, tr, act, batch, s.g.frames,
                                           s.g.beams, s.blocks, st);
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
  err = trunk::run_gemm<true, true, trunk::kBiasReluGrad>(p, st);
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
  err = trunk::run_gemm<true, false, trunk::kMaskPositive>(p, st);
  if (err != cudaSuccess) return err;

  // 5. per-block partial sums of dW1, db1, dW2, db2
  const size_t smem = sizeof(float) * bwd_smem(s).floats;
  auto conv_bwd = conv_bwd_kernel<TX>;
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

// ---- bf16 mode -----------------------------------------------------------

using trunk::kPlaneRow;
using trunk::ldsm_x2;
using trunk::ldsm_x4;
using trunk::mma_add;
using trunk::MmaGeom;
using trunk::pack_bf16;

constexpr int kWarps = kConvThreads / 32;

// conv_bwd_mma's shared memory, in bytes: w1 as conv1's B, w2 as the
// transposed conv2's B (w2t[t][ci][c]), b1, two buffers of one sample's
// scans and of its g2 as it lies in memory (channel-major, rows of L2 + 8),
// its g2 position-major (g2p[m][c]), its conv1 planes and its g3 planes
// (both E then O, as trunk_conv_mma.cuh); at the end the block's dW1 and db1
// sums per warp over the planes.
struct BwdMmaSmem {
  int w1s, w2t, b1, x, g2raw, g2p, y1, g3, bytes;
};

// bf16 per channel row of the staged g2 (8-byte copies; rows 16 bytes
// apart in banks, so the transposition's reads of 8 channels meet none twice).
__host__ __device__ inline int g2raw_row(const MmaGeom& m) { return m.g.l2 + 8; }

template <class TX>
__host__ __device__ inline BwdMmaSmem conv_bwd_mma_smem(const MmaGeom& m) {
  BwdMmaSmem b;
  const int planes = 2 * m.prow * kPlaneRow * 2;
  b.w1s = 0;
  b.w2t = trunk::align16(kC * m.w1row * 2);
  b.b1 = b.w2t + 3 * kC * kPlaneRow * 2;
  b.x = b.b1 + kC * 4;
  b.g2raw = b.x + 2 * m.g.frames * m.xrow * static_cast<int>(sizeof(TX));
  b.g2p = b.g2raw + trunk::align16(2 * kC * g2raw_row(m) * 2);
  b.y1 = b.g2p + m.prow * kPlaneRow * 2;
  b.g3 = b.y1 + planes;
  const int scratch = kWarps * (kC * 5 * m.g.frames + kC) * 4;
  b.bytes = b.y1 + (2 * planes > scratch ? 2 * planes : scratch);
  return b;
}

// 8-byte asynchronous copy global -> shared (cp.async.ca); the #else branch
// is the synchronous equivalent for a host compiler.
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
#else
  float* f = static_cast<float*>(dst);
  const float* g = static_cast<const float*>(src);
  f[0] = g[0];
  f[1] = g[1];
#endif
}

// Pass 5, bf16 mode: per conv block and trunk, the sums over the block's
// samples of dW1, db1 and dW2 into partial[t][block] (db2 comes from dflat's
// column sums), one sample at a time with three barriers, the next
// sample's scans and g2 in flight (cp.async, two buffers): (1) g2 into g2p
// and conv1 (trunk_conv_mma.cuh, the forward's code); (2) dW2, and the
// transposed conv2 with its mask and db1; (3) dW1.  Warp w owns dW2's m16
// tile w % 2 and n8 tiles 3 (w / 2) .. + 2 (tap, 8 input channels each);
// the transposed conv2's position tiles w, w + 8, ... of the two planes;
// and dW1's K chunks w, w + 8, ... (16 positions of one plane), summed over
// the warps at the end in a fixed order.
template <class TX>
__global__ void __launch_bounds__(kConvThreads, 2)
    conv_bwd_mma_kernel(const TX* __restrict__ x, Trunk act_w, Trunk crt_w,
                        const bf16* __restrict__ g2, float* __restrict__ partial,
                        Layout s, int batch) {
  extern __shared__ __align__(16) unsigned char bwd_sh[];
  const MmaGeom m = trunk::mma_geom<TX>(s.g.frames, s.g.beams);
  const ConvGeom& g = m.g;
  const BwdMmaSmem sm = conv_bwd_mma_smem<TX>(m);
  const Trunk p = blockIdx.y == 0 ? act_w : crt_w;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3, j = lane >> 3, rr = lane & 7;
  const int grow = g2raw_row(m);
  const int xs_n = g.frames * m.xrow;
  bf16* w1s = reinterpret_cast<bf16*>(bwd_sh + sm.w1s);
  bf16* w2t = reinterpret_cast<bf16*>(bwd_sh + sm.w2t);
  float* b1 = reinterpret_cast<float*>(bwd_sh + sm.b1);
  TX* xbuf = reinterpret_cast<TX*>(bwd_sh + sm.x);
  bf16* g2raw = reinterpret_cast<bf16*>(bwd_sh + sm.g2raw);
  bf16* g2p = reinterpret_cast<bf16*>(bwd_sh + sm.g2p);
  bf16* y1e = reinterpret_cast<bf16*>(bwd_sh + sm.y1);
  bf16* y1o = y1e + m.prow * kPlaneRow;
  bf16* g3e = reinterpret_cast<bf16*>(bwd_sh + sm.g3);
  bf16* g3o = g3e + m.prow * kPlaneRow;

  trunk::stage_w1_bf16(p, w1s, m, tid);
  for (int i = tid; i < kC * kC * 3; i += kConvThreads) {
    // w2 (c, ci, t) -> w2t[t][ci][c]
    const int c = i / (3 * kC), r = i - c * 3 * kC, ci = r / 3, t = r % 3;
    w2t[(t * kC + ci) * kPlaneRow + c] = __float2bfloat16_rn(p.w2[i]);
  }
  for (int i = tid; i < kC; i += kConvThreads) b1[i] = p.b1[i];
  // zero g2p and both pairs of planes (rows past L2, O[0] stay so) and the
  // scans' padding
  for (int i = tid; i < (sm.g3 + 2 * m.prow * kPlaneRow * 2 - sm.g2p) / 16;
       i += kConvThreads)
    reinterpret_cast<uint4*>(bwd_sh + sm.g2p)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < 2 * g.frames; i += kConvThreads) {
    TX* row = xbuf + i * m.xrow;
    for (int k = 0; k < trunk::kXPad<TX>; ++k) row[k] = TX(0.0f);
    for (int k = trunk::kXPad<TX> + g.beams; k < m.xrow; ++k) row[k] = TX(0.0f);
  }

  int b_begin, b_end;
  trunk::block_samples(batch, s.blocks, blockIdx.x, &b_begin, &b_end);
  // sample b's scans and g2 into buffer buf
  auto load = [&](int buf, int b) {
    const int per_row = g.beams / trunk::kXPad<TX>;
    for (int i = tid; i < g.frames * per_row; i += kConvThreads) {
      const int f = i / per_row, c = i - f * per_row;
      trunk::cp_async16(
          xbuf + buf * xs_n + f * m.xrow + trunk::kXPad<TX> * (c + 1),
          x + (static_cast<size_t>(b) * g.frames + f) * g.beams +
              c * trunk::kXPad<TX>,
          true);
    }
    const bf16* gb =
        g2 + (blockIdx.y * static_cast<size_t>(batch) + b) * g.nflat;
    for (int i = tid; i < g.nflat / 4; i += kConvThreads) {
      const int c = 4 * i / g.l2, mm = 4 * i - c * g.l2;
      cp_async8(g2raw + (buf * kC + c) * grow + mm, gb + 4 * i);
    }
  };
  if (b_begin < b_end) load(0, b_begin);
  trunk::cp_async_commit();
  __syncthreads();  // the weights are staged
  unsigned w1f[2][4][2];
  trunk::load_w1_frags(w1f, w1s, m, lane);
  int xoff[2][4];
  trunk::x_tap_offsets<TX>(xoff, m, lane);

  const int mi2 = warp & 1, u0 = 3 * (warp >> 1);
  float acc2[3][4], acc1[2][4][4], db1[4][2];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int u = 0; u < 3; ++u) acc2[u][e] = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc1[0][nt][e] = acc1[1][nt][e] = 0.0f;
    db1[e][0] = db1[e][1] = 0.0f;
  }
  const int taps = 5 * g.frames;

  for (int b = b_begin, it = 0; b < b_end; ++b, ++it) {
    trunk::cp_async_wait<0>();
    __syncthreads();  // sample b has landed; the previous dW1 is done
    if (b + 1 < b_end) load((it + 1) & 1, b + 1);
    trunk::cp_async_commit();
    const TX* xs = xbuf + (it & 1) * xs_n;
    const bf16* gr = g2raw + (it & 1) * kC * grow;

    // g2 position-major: lanes take 8 positions x 4 channel pairs, so
    // neither the reads nor the pair stores meet a bank twice
    for (int w = warp; w < 4 * ceil_div(g.l2, 8); w += kWarps) {
      const int cp = (w & 3) * 4 + (lane >> 3), mm = (w >> 2) * 8 + (lane & 7);
      if (mm < g.l2) {
        __nv_bfloat162 v;
        v.x = gr[2 * cp * grow + mm];
        v.y = gr[(2 * cp + 1) * grow + mm];
        *reinterpret_cast<__nv_bfloat162*>(g2p + mm * kPlaneRow + 2 * cp) = v;
      }
    }
    // conv1, as the forward computes it
    for (int tile = warp; tile < 2 * m.mt; tile += kWarps) {
      const int pp = tile / m.mt, i = tile - pp * m.mt;
      trunk::conv1_mma_tile(xs, w1f, xoff, b1, pp ? y1o : y1e, m, pp, i,
                            lane);
    }
    __syncthreads();

    // dW2[c][ci][t] += sum_m g2[c][m] y1[ci][2m + t - 1]: A = g2 (.trans
    // from g2p), B = the plane rows of tap t (.trans)
    for (int ks = 0; ks < m.mt; ++ks) {
      unsigned a[4];
      ldsm_x4<true>(a, g2p + (ks * 16 + rr + (j >> 1) * 8) * kPlaneRow +
                           mi2 * 16 + (j & 1) * 8);
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const int nb8 = u0 + u, t = nb8 >> 2;
        const bf16* base = (t == 1 ? y1e : y1o) + (t == 2 ? kPlaneRow : 0);
        unsigned bq[2];
        ldsm_x2<true>(bq, base + (ks * 16 + rr + (j & 1) * 8) * kPlaneRow +
                              (nb8 & 3) * 8);
        mma_add(acc2[u], a, bq[0], bq[1]);
      }
    }
    // the transposed conv2: conv1 position 2q takes tap 1 of conv2 position
    // q; 2q + 1 takes tap 2 of q and tap 0 of q + 1.  Masked by the conv1
    // ReLU into the g3 planes, db1 summed from the float32 values.
    for (int tile = warp; tile < 2 * m.mt; tile += kWarps) {
      const int pp = tile / m.mt, i = tile - pp * m.mt;
      float acc[4][4];
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nj][e] = 0.0f;
      for (int tap = 0; tap < (pp ? 2 : 1); ++tap) {
        const int t = pp ? (tap ? 0 : 2) : 1;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          unsigned a[4];
          ldsm_x4<false>(a, g2p + (16 * i + (lane & 15) + (pp ? tap : 0)) *
                                      kPlaneRow +
                                  ks * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            unsigned bq[4];
            ldsm_x4<false>(bq, w2t + (t * kC + np * 16 + rr + (j >> 1) * 8) *
                                         kPlaneRow +
                                   ks * 16 + (j & 1) * 8);
            mma_add(acc[2 * np], a, bq[0], bq[1]);
            mma_add(acc[2 * np + 1], a, bq[2], bq[3]);
          }
        }
      }
      const bf16* ym = pp ? y1o : y1e;
      bf16* gm = pp ? g3o : g3e;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qr = 16 * i + gq + 8 * h;
        if (qr >= g.l2) continue;
        const int row = (qr + pp) * kPlaneRow;
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const int c = nj * 8 + 2 * q;
          const unsigned y = *reinterpret_cast<const unsigned*>(ym + row + c);
          const float v0 =
              trunk::bf16_half<false>(y) > 0.0f ? acc[nj][2 * h] : 0.0f;
          const float v1 =
              trunk::bf16_half<true>(y) > 0.0f ? acc[nj][2 * h + 1] : 0.0f;
          db1[nj][0] += v0;
          db1[nj][1] += v1;
          *reinterpret_cast<unsigned*>(gm + row + c) = pack_bf16(v0, v1);
        }
      }
    }
    __syncthreads();

    // dW1[c][f][t] += sum_l g3[c][l] x[f][2l + t - 1]: A = g3 (.trans from
    // the g3 planes), B = the scans' taps gathered as conv1's A is (taps
    // past 5F read tap 0's column, which is not kept)
    for (int kc = warp; kc < 2 * m.mt; kc += kWarps) {
      const int pp = kc / m.mt, i = kc - pp * m.mt;
      const bf16* gm = (pp ? g3o : g3e) + pp * kPlaneRow;
      unsigned a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4<true>(a[mi], gm + (16 * i + rr + (j >> 1) * 8) * kPlaneRow +
                                 mi * 16 + (j & 1) * 8);
      const int q0 = 16 * i + 2 * q;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt >= 2 * m.k1) break;
        const int n = nt * 8 + gq;
        const int off = trunk::tap_offset<TX>(n < taps ? n : 0, m);
        const unsigned b0 = pack_bf16(trunk::x_tap(xs, off, q0, pp),
                                      trunk::x_tap(xs, off, q0 + 1, pp));
        const unsigned b1v = pack_bf16(trunk::x_tap(xs, off, q0 + 8, pp),
                                       trunk::x_tap(xs, off, q0 + 9, pp));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_add(acc1[mi][nt], a[mi], b0, b1v);
      }
    }
  }
  __syncthreads();  // every warp is done with the planes

  // The block's sums: dW2 straight from its owners; dW1 and db1 per warp
  // through shared memory, added over the warps in order.
  float* out = partial + (blockIdx.y * static_cast<size_t>(gridDim.x) +
                          blockIdx.x) * s.psize;
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    const int nb8 = u0 + u, t = nb8 >> 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = mi2 * 16 + gq + 8 * (e >> 1);
      const int ci = (nb8 & 3) * 8 + 2 * q + (e & 1);
      out[s.nw1 + kC + (c * kC + ci) * 3 + t] = acc2[u][e];
    }
  }
  float* sc1 = reinterpret_cast<float*>(bwd_sh + sm.y1);  // [warp][nw1]
  float* scb1 = sc1 + kWarps * s.nw1;                      // [warp][32]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = nt * 8 + 2 * q + (e & 1);
        if (n < taps)
          sc1[warp * s.nw1 + (mi * 16 + gq + 8 * (e >> 1)) * taps + n] =
              acc1[mi][nt][e];
      }
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        db1[nj][e] += __shfl_xor_sync(0xffffffffu, db1[nj][e], off);
      if (gq == 0) scb1[warp * kC + nj * 8 + 2 * q + e] = db1[nj][e];
    }
  __syncthreads();
  for (int e = tid; e < s.nw1; e += kConvThreads) {
    float v = sc1[e];
    for (int w = 1; w < kWarps; ++w) v += sc1[w * s.nw1 + e];
    out[e] = v;
  }
  for (int c = tid; c < kC; c += kConvThreads) {
    float v = scb1[c];
    for (int w = 1; w < kWarps; ++w) v += scb1[w * kC + c];
    out[s.nw1 + c] = v;
  }
}

// dbf's first level, bf16 mode: block (r, t) sums rows [r B / R, (r + 1)
// B / R) of trunk t's g1 (R = kBiasRanges) into bias[t][r]; thread i takes
// the column pair i % 128 over every other row from i / 128, whole rows a
// warp apart in memory, and the two halves are added in order.
__global__ void __launch_bounds__(kReduceThreads)
    bias_rows_kernel(const bf16* __restrict__ g1, float* __restrict__ bias,
                     int batch) {
  extern __shared__ __align__(16) float bias_sh[];  // [2][kH]
  const int r = blockIdx.x, t = blockIdx.y;
  const int lo = static_cast<int>(static_cast<long long>(r) * batch / kBiasRanges);
  const int hi =
      static_cast<int>(static_cast<long long>(r + 1) * batch / kBiasRanges);
  const int cp = threadIdx.x & (kH / 2 - 1), half = threadIdx.x / (kH / 2);
  const __nv_bfloat162* src = reinterpret_cast<const __nv_bfloat162*>(
      g1 + static_cast<size_t>(t) * batch * kH);
  float s0 = 0.0f, s1 = 0.0f;
  for (int b = lo + half; b < hi; b += 2) {
    const __nv_bfloat162 v = src[static_cast<size_t>(b) * (kH / 2) + cp];
    s0 += trunk::to_float(v.x);
    s1 += trunk::to_float(v.y);
  }
  bias_sh[half * kH + 2 * cp] = s0;
  bias_sh[half * kH + 2 * cp + 1] = s1;
  __syncthreads();
  if (threadIdx.x < kH)
    bias[(static_cast<size_t>(t) * kBiasRanges + r) * kH + threadIdx.x] =
        bias_sh[threadIdx.x] + bias_sh[kH + threadIdx.x];
}

// db2, bf16 mode: block (c, t) sums trunk t's dflat column sums over the M
// tiles and channel c's columns [c L2, (c + 1) L2): thread i the elements
// i, i + 256, ... of that (M tile, column) range in row-major order, then a
// tree over the threads.
__global__ void __launch_bounds__(kReduceThreads)
    db2_kernel(const float* __restrict__ db2, float* __restrict__ grads,
               Layout s) {
  __shared__ float red[kReduceThreads];
  const int c = blockIdx.x, t = blockIdx.y, l2 = s.g.l2;
  const float* src =
      db2 + static_cast<size_t>(t) * s.mtiles * s.g.nflat + c * l2;
  const int n = s.mtiles * l2;
  float v = 0.0f;
#pragma unroll 8
  for (int i = threadIdx.x; i < n; i += kReduceThreads) {
    const int r = i / l2;
    v += src[static_cast<size_t>(r) * s.g.nflat + i - r * l2];
  }
  red[threadIdx.x] = v;
  __syncthreads();
  for (int h = kReduceThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0)
    grads[static_cast<size_t>(t) * s.total + s.nw1 + kC + s.nw2 + c] = red[0];
}

// Pass 6, bf16 mode: as reduce_kernel, but dbf from bias_rows_kernel's range
// sums, and db2 left to db2_kernel.
__global__ void __launch_bounds__(kReduceThreads)
    reduce_bf16_kernel(const float* __restrict__ partial,
                       const float* __restrict__ bias,
                       float* __restrict__ grads, Layout s) {
  const int jobs = s.psize + kH;
  const int w = (blockIdx.x * kReduceThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= 2 * jobs) return;
  const int t = w / jobs;
  const int e = w - t * jobs;
  if (e >= s.nw1 + kC + s.nw2 && e < s.psize) return;  // db2
  float v = 0.0f;
  if (e < s.psize) {
    const float* src = partial + static_cast<size_t>(t) * s.blocks * s.psize + e;
    for (int i = lane; i < s.blocks; i += 32)
      v += src[static_cast<size_t>(i) * s.psize];
  } else {
    const float* src = bias + static_cast<size_t>(t) * kBiasRanges * kH +
                       (e - s.psize);
    for (int i = lane; i < kBiasRanges; i += 32) v += src[i * kH];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0)
    grads[static_cast<size_t>(t) * s.total +
          (e < s.psize ? e : s.off_bf + e - s.psize)] = v;
}

// The six passes in bf16 mode, every product on the tensor cores.  TX: the
// scans' type; g bf16.
template <class TX>
cudaError_t backward_bf16(const TX* xs, const Trunk* tr, const bf16* g,
                          float* out, float* ws, const Layout& s, int batch,
                          cudaStream_t st) {
  bf16* act = reinterpret_cast<bf16*>(ws + s.act);    // then g2 in place
  bf16* g1 = reinterpret_cast<bf16*>(ws + s.g1);      // (2, B, 256)
  bf16* wf16 = reinterpret_cast<bf16*>(ws + s.wf16);  // (2, 256, nflat)
  float* partial = ws + s.partial;
  float* db2 = ws + s.db2;
  float* part = ws + s.part;
  const int nflat = s.g.nflat;
  const size_t bn = static_cast<size_t>(batch) * nflat;
  const size_t bh = static_cast<size_t>(batch) * kH;
  const size_t hn = static_cast<size_t>(kH) * nflat;
  const int kbk = trunk::mma::kBK;

  // 1. the flat conv features (and Wf in bf16)
  cudaError_t err = trunk::launch_conv_mma(xs, tr, act, wf16, batch,
                                           s.g.frames, s.g.beams, s.blocks,
                                           st);
  if (err != cudaSuccess) return err;

  // 2. g1 = g [act Wf^T + bf > 0]: M = B, N = 256, K = nflat
  trunk::Gemm p{};
  for (int t = 0; t < 2; ++t) {
    p.a[t] = act + t * bn;
    p.b[t] = wf16 + t * hn;
    p.c[t] = g1 + t * bh;
    p.bias[t] = tr[t].bf;
    p.aux[t] = g + t * bh;
  }
  p.lda = nflat, p.ldb = nflat, p.ldc = kH, p.ldaux = kH;
  p.m = batch, p.n = kH, p.k = nflat;
  p.part = part, p.splits = s.fc1_splits;
  p.kchunk = ceil_div(ceil_div(nflat, kbk), s.fc1_splits);
  err = trunk::run_mma_gemm<true, true, trunk::kBiasReluGrad, bf16>(p, st);
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
  p.kchunk = ceil_div(ceil_div(batch, kbk), s.dwf_splits);
  err = trunk::run_mma_gemm<false, false, trunk::kStore, float>(p, st);
  if (err != cudaSuccess) return err;

  // 4. g2 = (g1 Wf) [act > 0], over act, with db2's column sums: M = B,
  //    N = nflat, K = 256
  p = trunk::Gemm{};
  for (int t = 0; t < 2; ++t) {
    p.a[t] = g1 + t * bh;
    p.b[t] = wf16 + t * hn;
    p.c[t] = act + t * bn;
    p.aux[t] = act + t * bn;
  }
  p.lda = kH, p.ldb = nflat, p.ldc = nflat, p.ldaux = nflat;
  p.m = batch, p.n = nflat, p.k = kH;
  p.splits = 1, p.kchunk = kH / kbk;
  err = trunk::run_mma_gemm<true, false, trunk::kMaskPositiveSum, bf16>(
      p, st, db2);
  if (err != cudaSuccess) return err;

  // 5. per-block partial sums of dW1, db1, dW2
  const MmaGeom m = trunk::mma_geom<TX>(s.g.frames, s.g.beams);
  const int smem = conv_bwd_mma_smem<TX>(m).bytes;
  auto conv_bwd = conv_bwd_mma_kernel<TX>;
  err = cudaFuncSetAttribute(
      conv_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  conv_bwd<<<dim3(s.blocks, 2), kConvThreads, smem, st>>>(
      xs, tr[0], tr[1], act, partial, s, batch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 6. the batch sums of the small gradients, db2 and bf
  float* bias = ws + s.bias;
  bias_rows_kernel<<<dim3(kBiasRanges, 2), kReduceThreads, 2 * kH * 4, st>>>(
      g1, bias, batch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int warps = 2 * (s.psize + kH);
  const int blocks = (warps * 32 + kReduceThreads - 1) / kReduceThreads;
  reduce_bf16_kernel<<<blocks, kReduceThreads, 0, st>>>(partial, bias, out,
                                                        s);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  db2_kernel<<<dim3(kC, 2), kReduceThreads, 0, st>>>(db2, out, s);
  return cudaGetLastError();
}

}  // namespace

// Floats of workspace that trunk_bwd_launch needs for this batch, plan and
// mode.
extern "C" long long trunk_bwd_workspace_floats(int batch, int frames,
                                                int beams, int conv_blocks,
                                                int fc1_splits,
                                                int dwf_splits,
                                                int bf16_mode) {
  return layout(batch, frames, beams, conv_blocks, fc1_splits, dwf_splits,
                bf16_mode != 0)
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
// mode (tensor cores).  Returns cudaErrorInvalidValue for shapes the
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
                          dwf_splits, bf16_mode != 0);
  if (work_floats < s.work) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* const* f = reinterpret_cast<const float* const*>(w);
  const Trunk tr[2] = {{f[0], f[1], f[2], f[3], f[4], f[5]},
                       {f[6], f[7], f[8], f[9], f[10], f[11]}};
  float* out = static_cast<float*>(grads);
  float* ws = static_cast<float*>(work);
  if (bf16_mode)
    return x_bf16 ? backward_bf16(static_cast<const bf16*>(x), tr,
                                  static_cast<const bf16*>(g), out, ws, s,
                                  batch, st)
                  : backward_bf16(static_cast<const float*>(x), tr,
                                  static_cast<const bf16*>(g), out, ws, s,
                                  batch, st);
  return x_bf16 ? backward_f32(static_cast<const bf16*>(x), tr,
                               static_cast<const float*>(g), out, ws, s,
                               batch, st)
                : backward_f32(static_cast<const float*>(x), tr,
                               static_cast<const float*>(g), out, ws, s,
                               batch, st);
}
