// The bf16 mode's two convolutions of a CNNPolicy trunk on the H100's
// tensor cores (mma.sync m16n8k16, bf16 operands, float32 sums), shared by
// the forward (trunk_fwd.cu) and backward (trunk_bwd.cu) kernels so both
// compute the activations with the same code and the same rounding: the
// backward's ReLU masks are the forward's.
//
// What bounds it on an H100: per sample and trunk 0.13 + 0.39 M bf16
// multiply-adds (1 MFLOP, 0.07 ms for all of B = 32,768 at 989 TFLOP/s)
// against 6 KB of float32 scans read and 8 KB of bf16 flat features written
// (0.47 GB at B = 32,768, 0.14 ms at 3.35 TB/s): the bytes.  So the pass
// streams: each block walks its samples kFwdGroup at a time with the next
// group's scans in flight (cp.async, two buffers) and two barriers a group,
// and its features leave straight from the conv2 accumulators.
//
// Both convolutions are small products that fit m16n8k16 exactly:
//   conv1 (F -> 32, k5 s2 p1): M = positions (L1 = NB / 2 - 1, padded to
//     NB / 2 with a zero output), N = 32 channels, K = 5F taps padded to 16
//     (F <= 3) or 32 (F <= 6).  Its A fragments are gathered straight from
//     the scans in shared memory (x[f][2l + t - 1] of row l, tap (f, t)); B
//     (w1 as [c][f * 5 + t]) stays in registers for the whole pass.
//   conv2 (32 -> 32, k3 s2 p1), transposed: M = 32 channels, N = L2 = NB /
//     4 positions, K = 3 taps x 32 channels: six k16 steps, A (w2 as
//     [c][t * 32 + ci]) and B read by ldmatrix, B from conv1's output kept
//     position-major as an even plane E[q] = y1[2q] and an odd plane O[q +
//     1] = y1[2q + 1] (O[0] = y1[-1] = 0, the left padding), so that tap t
//     of output m is row m of O, E, O + 1: whole 16-byte rows.  Each thread
//     then holds two consecutive positions of a channel, which go straight
//     to the channel-major flat features (the reference layout) as bf16.
// conv1 is computed plane by plane (rows q of E, then of O), its bias add
// and ReLU in float32, rounded to bf16 into the planes; conv2's bias add and
// ReLU are float32.  Rows of 80 bytes (32 + 8 bf16) keep every ldmatrix
// phase and fragment store free of bank conflicts.  Staged scan rows are
// padded with zeros to 64 x (position tiles) values, so the tap gathers
// need no bounds checks: rows past L2 read zeros or scans, and taps past 5F
// read tap 0 against a zero weight.
//
// Shapes: 1 <= F <= kMaxFrames frames and a beam count that is a multiple
// of 16, as trunk_conv.cuh; position tiles past L2 are masked.
#pragma once

#include <cuda_runtime.h>

#include "trunk_conv.cuh"
#include "trunk_mma.cuh"

namespace trunk {

constexpr int kPlaneRow = kC + 8;  // bf16 per position row of a plane
constexpr int kW2Row = 3 * kC + 8;  // bf16 per output channel of w2 (conv2 B)

// The tensor-core conv geometry: position tiles of a plane, plane rows (the
// rows past L2 stay zero), the k16 steps and row of conv1, and the scans'
// row in shared memory (TX values: kXPad of zero padding, the NB scans,
// zeros up to the reach of the position tiles' gathers).
struct MmaGeom {
  ConvGeom g;
  int mt;      // m16 tiles per plane (L2 positions)
  int prow;    // rows of a plane
  int k1;      // k16 steps of conv1 (5F taps)
  int w1row;   // bf16 per output channel of w1 (conv1 B)
  int xrow;    // TX values per frame row of the staged scans
};

template <class TX>
__host__ __device__ inline MmaGeom mma_geom(int frames, int beams) {
  MmaGeom m;
  m.g = conv_geom(frames, beams);
  m.mt = ceil_div(m.g.l2, 16);
  m.prow = 16 * m.mt + 8;
  m.k1 = ceil_div(5 * frames, 16);
  m.w1row = 16 * m.k1 + 8;
  m.xrow = 64 * m.mt + 2 * (16 / static_cast<int>(sizeof(TX)));
  return m;
}

// Leading zero padding of a staged scan row: one 16-byte chunk.
template <class TX>
constexpr int kXPad = 16 / static_cast<int>(sizeof(TX));

// w1 (c, f, t) -> w1s[c][f * 5 + t] in bf16, zero past 5F.
__device__ inline void stage_w1_bf16(const Trunk& p, bf16* w1s,
                                     const MmaGeom& m, int tid) {
  const int taps = 5 * m.g.frames;
  for (int i = tid; i < kC * 16 * m.k1; i += kConvThreads) {
    const int c = i / (16 * m.k1), k = i - c * 16 * m.k1;
    w1s[c * m.w1row + k] = __float2bfloat16_rn(k < taps ? p.w1[c * taps + k]
                                                        : 0.0f);
  }
}

// conv1's B fragments (w1, n8 tiles nj, k16 steps ks) into registers.
__device__ inline void load_w1_frags(unsigned (&w)[2][4][2], const bf16* w1s,
                                     const MmaGeom& m, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const bf16* r = w1s + (nj * 8 + g) * m.w1row + ks * 16 + 2 * q;
      w[ks][nj][0] = ks < m.k1 ? *reinterpret_cast<const unsigned*>(r) : 0u;
      w[ks][nj][1] = ks < m.k1 ? *reinterpret_cast<const unsigned*>(r + 8) : 0u;
    }
}

// Offsets into a staged sample's scans of this lane's conv1 taps: for k16
// step ks and entry e (k = 16 ks + 2q + {0, 1, 8, 9}[e]), f * xrow + t - 1
// + kXPad for tap (f, t) = (k / 5, k % 5); past 5F, tap 0's (its weight is
// 0).  Row q of plane p (conv1 position l = 2q + p) reads scan index
// 2l + t - 1 = 4q + 2p + t - 1.
template <class TX>
__host__ __device__ inline int tap_offset(int k, const MmaGeom& m) {
  return (k / 5) * m.xrow + k % 5 - 1 + kXPad<TX>;
}

template <class TX>
__device__ inline void x_tap_offsets(int (&off)[2][4], const MmaGeom& m,
                                     int lane) {
  const int q = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 16 * ks + 2 * q + (e & 1) + 8 * (e >> 1);
      off[ks][e] = tap_offset<TX>(k < 5 * m.g.frames ? k : 0, m);
    }
}

// The staged scan value of tap offset off at row qr of plane p.
template <class TX>
__device__ __forceinline__ float x_tap(const TX* xs, int off, int qr, int p) {
  return to_float(xs[off + 4 * qr + 2 * p]);
}

// conv1 + bias + ReLU of plane p, position tile i, of one staged sample,
// into that plane (E[q] for p = 0, O[q + 1] for p = 1) as bf16; position
// L1 (the padding) gets 0.
template <class TX>
__device__ __forceinline__ void conv1_mma_tile(
    const TX* xs, const unsigned (&w)[2][4][2], const int (&off)[2][4],
    const float* b1, bf16* plane, const MmaGeom& m, int p, int i, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int q0 = 16 * i + g, q1 = q0 + 8;
  float acc[4][4];
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nj][e] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    if (ks >= m.k1) break;
    const int* o = off[ks];
    const unsigned a[4] = {
        pack_bf16(x_tap(xs, o[0], q0, p), x_tap(xs, o[1], q0, p)),
        pack_bf16(x_tap(xs, o[0], q1, p), x_tap(xs, o[1], q1, p)),
        pack_bf16(x_tap(xs, o[2], q0, p), x_tap(xs, o[3], q0, p)),
        pack_bf16(x_tap(xs, o[2], q1, p), x_tap(xs, o[3], q1, p))};
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) mma_add(acc[nj], a, w[ks][nj][0], w[ks][nj][1]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qr = h ? q1 : q0;
    if (qr >= m.g.l2) continue;
    const bool live = 2 * qr + p < m.g.l1;
    bf16* row = plane + (qr + p) * kPlaneRow;
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int c = nj * 8 + 2 * q;
      const float v0 = live ? fmaxf(acc[nj][2 * h] + b1[c], 0.0f) : 0.0f;
      const float v1 = live ? fmaxf(acc[nj][2 * h + 1] + b1[c + 1], 0.0f) : 0.0f;
      *reinterpret_cast<unsigned*>(row + c) = pack_bf16(v0, v1);
    }
  }
}

// Shared memory of the tensor-core conv pass, in bytes from the start;
// every region 16-byte aligned.
struct ConvMmaSmem {
  int w1s, w2s, b1, b2, x, planes, bytes;
};

__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }

template <class TX>
__host__ __device__ inline ConvMmaSmem conv_mma_smem(const MmaGeom& m) {
  ConvMmaSmem s;
  s.w1s = 0;
  s.w2s = s.w1s + align16(kC * m.w1row * 2);
  s.b1 = s.w2s + kC * kW2Row * 2;
  s.b2 = s.b1 + kC * 4;
  s.x = s.b2 + kC * 4;
  // two buffers of kFwdGroup samples' scans
  s.planes = s.x + 2 * kFwdGroup * m.g.frames * m.xrow *
                       static_cast<int>(sizeof(TX));
  s.bytes = s.planes + kFwdGroup * 2 * m.prow * kPlaneRow * 2;
  return s;
}

// The tensor-core conv pass: flat[t][b] = the channel-major conv2 features
// of sample b through trunk t = blockIdx.y, as bf16.  Block i takes the
// samples block_samples gives it, kFwdGroup at a time, with two barriers
// per group.  Each block also converts its share of trunk t's fc1 weight
// to bf16 into wf16[t] (the product core's B), so no launch of its own is
// spent on that.  TX: the scans' type.
template <class TX>
__global__ void __launch_bounds__(kConvThreads, 2)
    conv_mma_kernel(const TX* __restrict__ x, Trunk act, Trunk crt,
                    bf16* __restrict__ flat, bf16* __restrict__ wf16,
                    int batch, int frames, int beams) {
  extern __shared__ __align__(16) unsigned char conv_sh[];
  const MmaGeom m = mma_geom<TX>(frames, beams);
  const ConvGeom& g = m.g;
  const ConvMmaSmem sm = conv_mma_smem<TX>(m);
  const Trunk p = blockIdx.y == 0 ? act : crt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bf16* w1s = reinterpret_cast<bf16*>(conv_sh + sm.w1s);
  bf16* w2s = reinterpret_cast<bf16*>(conv_sh + sm.w2s);
  float* b1 = reinterpret_cast<float*>(conv_sh + sm.b1);
  float* b2 = reinterpret_cast<float*>(conv_sh + sm.b2);
  TX* xbuf = reinterpret_cast<TX*>(conv_sh + sm.x);
  bf16* planes = reinterpret_cast<bf16*>(conv_sh + sm.planes);
  const int xs_n = g.frames * m.xrow;           // TX values per sample
  const int pl_n = 2 * m.prow * kPlaneRow;       // bf16 per sample's planes

  // this block's share of Wf in bf16, four values a thread at a time
  {
    const long long n4 = static_cast<long long>(kH) * g.nflat / 4;
    const float4* src = reinterpret_cast<const float4*>(p.wf);
    uint2* dst = reinterpret_cast<uint2*>(wf16 + blockIdx.y * kH * static_cast<long long>(g.nflat));
    const long long lo = n4 * blockIdx.x / gridDim.x;
    const long long hi = n4 * (blockIdx.x + 1) / gridDim.x;
    for (long long e = lo + tid; e < hi; e += kConvThreads) {
      const float4 v = src[e];
      dst[e] = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
  }
  stage_w1_bf16(p, w1s, m, tid);
  for (int i = tid; i < kC * 3 * kC; i += kConvThreads) {
    // w2 (c, ci, t) -> w2s[c][t * 32 + ci]
    const int c = i / (3 * kC), r = i - c * 3 * kC, ci = r / 3, t = r % 3;
    w2s[c * kW2Row + t * kC + ci] = __float2bfloat16_rn(p.w2[i]);
  }
  for (int i = tid; i < kC; i += kConvThreads) {
    b1[i] = p.b1[i];
    b2[i] = p.b2[i];
  }
  // zero the planes (rows past L2 and O[0] stay so) and the scans' padding
  for (int i = tid; i < kFwdGroup * pl_n / 8; i += kConvThreads)
    reinterpret_cast<uint4*>(planes)[i] = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < 2 * kFwdGroup * g.frames; i += kConvThreads) {
    TX* row = xbuf + i * m.xrow;
    for (int j = 0; j < kXPad<TX>; ++j) row[j] = TX(0.0f);
    for (int j = kXPad<TX> + beams; j < m.xrow; ++j) row[j] = TX(0.0f);
  }

  int b_begin, b_end;
  block_samples(batch, gridDim.x, blockIdx.x, &b_begin, &b_end);
  // scans of samples [b0, b0 + nb) into buffer buf
  auto load_x = [&](int buf, int b0, int nb) {
    const int per_row = beams / kXPad<TX>;
    for (int i = tid; i < nb * g.frames * per_row; i += kConvThreads) {
      const int r = i / per_row, c = i - r * per_row;
      cp_async16(xbuf + (buf * kFwdGroup * g.frames + r) * m.xrow +
                     kXPad<TX> + c * kXPad<TX>,
                 x + (static_cast<size_t>(b0) * g.frames + r) * beams +
                     c * kXPad<TX>,
                 true);
    }
  };
  if (b_begin < b_end) load_x(0, b_begin, min(kFwdGroup, b_end - b_begin));
  cp_async_commit();
  __syncthreads();  // the weights are staged
  unsigned w1f[2][4][2];
  load_w1_frags(w1f, w1s, m, lane);
  int xoff[2][4];
  x_tap_offsets<TX>(xoff, m, lane);

  for (int b0 = b_begin, it = 0; b0 < b_end; b0 += kFwdGroup, ++it) {
    const int nb = min(kFwdGroup, b_end - b0);
    cp_async_wait<0>();
    __syncthreads();  // this group's scans have landed; the planes are free
    if (b0 + kFwdGroup < b_end)
      load_x((it + 1) & 1, b0 + kFwdGroup,
             min(kFwdGroup, b_end - b0 - kFwdGroup));
    cp_async_commit();
    const TX* xg = xbuf + (it & 1) * kFwdGroup * xs_n;
    for (int tile = warp; tile < nb * 2 * m.mt; tile += kConvThreads / 32) {
      const int s = tile / (2 * m.mt), r = tile - s * 2 * m.mt;
      const int pp = r / m.mt, i = r - pp * m.mt;
      conv1_mma_tile(xg + s * xs_n, w1f, xoff, b1,
                     planes + s * pl_n + pp * m.prow * kPlaneRow, m, pp, i,
                     lane);
    }
    __syncthreads();  // the planes are written
    // conv2, transposed: D[c][m] = w2[c][k] Y[k][m] for 16 positions a tile
    for (int tile = warp; tile < nb * m.mt; tile += kConvThreads / 32) {
      const int s = tile / m.mt, i = tile - s * m.mt;
      const bf16* ev = planes + s * pl_n;
      const bf16* od = ev + m.prow * kPlaneRow;
      float acc[2][2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.0f;
      const int j = lane >> 3, rr = lane & 7;
#pragma unroll
      for (int ks = 0; ks < 6; ++ks) {
        const int t = ks >> 1, ci0 = (ks & 1) * 16;
        const bf16* base = (t == 1 ? ev : od) + (t == 2 ? kPlaneRow : 0);
        unsigned bq[4], a[2][4];
        ldsm_x4<false>(bq, base + (16 * i + rr + (j >> 1) * 8) * kPlaneRow +
                               ci0 + (j & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          ldsm_x4<false>(a[mi], w2s + (mi * 16 + (lane & 15)) * kW2Row +
                                    ks * 16 + (lane >> 4) * 8);
          mma_add(acc[mi][0], a[mi], bq[0], bq[1]);
          mma_add(acc[mi][1], a[mi], bq[2], bq[3]);
        }
      }
      bf16* out = flat + (blockIdx.y * static_cast<size_t>(batch) + b0 + s) *
                             g.nflat;
      const int gq = lane >> 2, q = lane & 3;
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int mm = 16 * i + nj * 8 + 2 * q;
        if (mm >= g.l2) continue;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = mi * 16 + gq + 8 * h;
            *reinterpret_cast<unsigned*>(out + c * g.l2 + mm) = pack_bf16(
                fmaxf(acc[mi][nj][2 * h] + b2[c], 0.0f),
                fmaxf(acc[mi][nj][2 * h + 1] + b2[c], 0.0f));
          }
      }
    }
  }
}

// Enqueue the tensor-core conv pass over both trunks (and the fc1 weight's
// conversion into wf16, (2, 256, nflat) bf16).
template <class TX>
inline cudaError_t launch_conv_mma(const TX* x, const Trunk* tr, bf16* flat,
                                   bf16* wf16, int batch, int frames,
                                   int beams, int blocks,
                                   cudaStream_t stream) {
  const MmaGeom m = mma_geom<TX>(frames, beams);
  const int smem = conv_mma_smem<TX>(m).bytes;
  auto kernel = conv_mma_kernel<TX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(blocks, 2), kConvThreads, smem, stream>>>(
      x, tr[0], tr[1], flat, wf16, batch, frames, beams);
  return cudaGetLastError();
}

}  // namespace trunk
