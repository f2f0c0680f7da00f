// The bf16 mode's product core of the twin-trunk kernels, on the H100's
// tensor cores: C = A B per trunk with bf16 operands and float32 sums, by
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.  trunk_fwd.cu runs fc1
// on it; trunk_bwd.cu the fc1 recompute, dWf and dflat.  The float32 mode
// keeps its FFMA core (trunk_gemm.cuh), whose Gemm, epilogues, cp.async
// helpers and split-K reduce this core shares.
//
// What bounds it on an H100: fc1 at B = 32,768 is 0.14 TFLOP, 0.14 ms at
// the 989 TFLOP/s dense bf16 rate, against 0.54 GB of bf16 flat features
// read once (0.16 ms at 3.35 TB/s): at the balance point, so the design
// keeps both the tensor cores and the copies busy.  mma.sync reaches only
// part of that rate (wgmma, TMA and warp specialisation are the later step).
//
// A block owns a 128 x 128 tile of C; its eight warps own 64 x 32 outputs
// each (4 x 4 mma tiles, 64 float32 sums a thread).  Shared memory is a ring
// of kStages stages of 32-deep k tiles filled by 16-byte cp.async copies, so
// the copies of the next stages overlap this one's products.  Operands stay
// bf16 in shared memory: one whose k index is contiguous in memory as rows
// of 32 + 8 bf16 (80 bytes, so the eight 16-byte rows of an ldmatrix
// phase fall in distinct bank groups), one whose m or n index is contiguous
// as 32 rows of 128 + 8 bf16 (272 bytes), read with ldmatrix.trans.  The
// tensor core adds the 16 exact bf16 products of one mma in its own order
// and that sum is added to the accumulator in float32 (mma_add), so sums
// differ from a sequential float32 sum by float32 roundings only.
//
// Rounding points (the JAX kernels' precision="default"): the operands are
// bf16 in memory (the conv pass writes the flat features as bf16 and the fc1
// weight once a launch as bf16; g1 and g2 are bf16 values), sums and
// epilogues float32, outputs rounded to TC.  An epilogue that reads aux
// stages the block's aux tile in shared memory first.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "trunk_conv.cuh"  // ceil_div
#include "trunk_gemm.cuh"

namespace trunk {

namespace mma {
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kStages = 4;
constexpr int kThreads = 256;  // 8 warps: 2 (m) x 4 (n) of 64 x 32 outputs
constexpr int kKRow = kBK + 8;    // bf16 per row of a k-contiguous tile
constexpr int kMRow = kBM + 8;    // bf16 per row of an m/n-contiguous tile
constexpr int kTile = kBM * kKRow;  // bf16 per operand and stage
static_assert(kTile >= kBK * kMRow, "a stage holds either layout");
constexpr int kSmemBytes = kStages * 2 * kTile * 2;  // 81,920: two an SM
}  // namespace mma

// This core's own epilogue (dflat): kMaskPositive, and each block's sums of
// the float32 values it stores, before they are rounded to TC, per column
// over its rows into sums[trunk][m tile][n]: db2 from the unrounded g2.
constexpr int kMaskPositiveSum = kMaskPositive + 1;

// ---- warp-level tensor-core primitives --------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8j .. 8j + 7 give the
// 16-byte row addresses of matrix j, r[j] its fragment (kTrans: transposed).
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  if (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
}

// Two such matrices; lanes 0 .. 15 give the row addresses.
template <bool kTrans>
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const bf16* p) {
  if (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1])
        : "r"(smem_u32(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_u32(p)));
}

// d += a b for a 16 x 16 bf16 A (row) and 16 x 8 bf16 B (col), float32 d.
// Fragments (g = lane / 4, q = lane % 4): a[0] A[g][2q, 2q + 1], a[1]
// A[g + 8][..], a[2] A[g][2q + 8, 2q + 9], a[3] A[g + 8][..]; b0
// B[2q, 2q + 1][g], b1 B[2q + 8, 2q + 9][g]; d[0], d[1] D[g][2q, 2q + 1],
// d[2], d[3] D[g + 8][..].
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b as a float32 sum: the tensor core forms the 16 products' sum from
// zero, and it is added to d in float32, rounding to nearest.  The tensor
// core's own accumulation (d as its C operand) does not round to nearest,
// so a long chain of mma steps into one accumulator drifts from a float32
// sum step by step: fc1 at K = 4,096 in one chain gave ~9x the bf16 rounding
// flips of the same sum split ten ways (PERF.md).  Every product of the
// bf16 mode accumulates through this.
__device__ __forceinline__ void mma_add(float (&d)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_bf16(s, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += s[e];
}

// lo and hi rounded to bf16 (to nearest, ties to even) and packed, lo in the
// low half: one fragment register.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// ---- the product core ---------------------------------------------------

// One operand's k tile [k0, k0 + 32) x rows [r0, r0 + 128) into a stage in
// 16-byte chunks of 8 bf16, two per thread; chunks outside the operand are
// zero-filled (the host makes each chunk wholly inside or outside).
template <bool kKContig>
__device__ __forceinline__ void mma_load_tile(bf16* s, const bf16* g,
                                              long long ld, int r0, int nrows,
                                              int k0, int nk, int tid) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int c = tid + mma::kThreads * q;
    if (kKContig) {
      const int r = c >> 2, kq = (c & 3) * 8;
      const bool ok = r0 + r < nrows && k0 + kq < nk;
      cp_async16(s + r * mma::kKRow + kq,
                 ok ? g + (r0 + r) * ld + k0 + kq : g, ok);
    } else {
      const int kk = c >> 4, rq = (c & 15) * 8;
      const bool ok = k0 + kk < nk && r0 + rq < nrows;
      cp_async16(s + kk * mma::kMRow + rq,
                 ok ? g + (k0 + kk) * ld + r0 + rq : g, ok);
    }
  }
}

// The warp's A fragments (four m16 tiles from row wm) at k16 step ks.
template <bool kAk>
__device__ __forceinline__ void load_a_frags(unsigned (&a)[4][4],
                                             const bf16* s, int wm, int ks,
                                             int lane) {
  const int j = lane >> 3, r = lane & 7;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int m0 = wm + mi * 16;
    if (kAk)
      ldsm_x4<false>(a[mi], s + (m0 + (lane & 15)) * mma::kKRow + ks * 16 +
                                (lane >> 4) * 8);
    else
      ldsm_x4<true>(a[mi], s + (ks * 16 + r + (j >> 1) * 8) * mma::kMRow +
                               m0 + (j & 1) * 8);
  }
}

// The warp's B fragments (four n8 tiles from column wn) at k16 step ks.
template <bool kBk>
__device__ __forceinline__ void load_b_frags(unsigned (&b)[4][2],
                                             const bf16* s, int wn, int ks,
                                             int lane) {
  const int j = lane >> 3, r = lane & 7;
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    const int n0 = wn + np * 16;
    unsigned q[4];
    if (kBk)
      ldsm_x4<false>(q, s + (n0 + r + (j >> 1) * 8) * mma::kKRow + ks * 16 +
                            (j & 1) * 8);
    else
      ldsm_x4<true>(q, s + (ks * 16 + r + (j & 1) * 8) * mma::kMRow + n0 +
                           (j >> 1) * 8);
    b[2 * np][0] = q[0];
    b[2 * np][1] = q[1];
    b[2 * np + 1][0] = q[2];
    b[2 * np + 1][1] = q[3];
  }
}

// Whether an epilogue reads aux (then the block stages its aux tile).
template <int kEpi>
constexpr bool kReadsAux = kEpi == kBiasReluGrad || kEpi == kMaskPositive ||
                           kEpi == kMaskPositiveSum;

// The epilogue of the outputs (m, n) and (m, n + 1) with their aux values
// a: what epilogue() gives for each.
template <int kEpi>
__device__ __forceinline__ float2 epilogue_pair(const Gemm& p, int t, float v0,
                                                float v1, float2 a, int n) {
  if constexpr (kEpi == kBiasRelu || kEpi == kBiasReluGrad) {
    const float* b = pick(p.bias, t) + n;
    if constexpr (kEpi == kBiasRelu)
      return make_float2(fmaxf(v0 + b[0], 0.0f), fmaxf(v1 + b[1], 0.0f));
    return make_float2(v0 + b[0] > 0.0f ? a.x : 0.0f,
                       v1 + b[1] > 0.0f ? a.y : 0.0f);
  }
  if constexpr (kEpi == kMaskPositive || kEpi == kMaskPositiveSum)
    return make_float2(a.x > 0.0f ? v0 : 0.0f, a.y > 0.0f ? v1 : 0.0f);
  return make_float2(v0, v1);
}

template <class T>
__device__ __forceinline__ void store_pair(T* p, float lo, float hi);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float lo,
                                                  float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}
template <>
__device__ __forceinline__ void store_pair<bf16>(bf16* p, float lo, float hi) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16(lo, hi);
}

// Grid (n tiles, m tiles, 2 * splits); a and b bf16; sums: kMaskPositiveSum's
// (2, m tiles, n) column sums.
template <bool kAk, bool kBk, int kEpi, class TC, class TAux>
__global__ void __launch_bounds__(mma::kThreads, 2)
    mma_gemm_kernel(Gemm p, float* __restrict__ sums) {
  constexpr int kBM = mma::kBM, kBN = mma::kBN, kBK = mma::kBK;
  constexpr int kStages = mma::kStages, kTile = mma::kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int t = blockIdx.z / p.splits;
  const int split = blockIdx.z - t * p.splits;
  const bf16* a = static_cast<const bf16*>(pick(p.a, t));
  const bf16* b = static_cast<const bf16*>(pick(p.b, t));
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int ktiles = ceil_div(p.k, kBK);
  const int kt0 = split * p.kchunk;
  const int nkt = min(ktiles, kt0 + p.kchunk) - kt0;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  auto stage_a = [&](int s) { return smem + s * 2 * kTile; };
  auto stage_b = [&](int s) { return smem + s * 2 * kTile + kTile; };
  auto load = [&](int s, int kt) {
    const int k0 = (kt0 + kt) * kBK;
    mma_load_tile<kAk>(stage_a(s), a, p.lda, m0, p.m, k0, p.k, tid);
    mma_load_tile<kBk>(stage_b(s), b, p.ldb, n0, p.n, k0, p.k, tid);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nkt) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // the stage refilled here was read in iteration kt - 1, which every
    // warp has finished at the barrier above
    if (kt + kStages - 1 < nkt)
      load((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();
    const bf16* as = stage_a(kt % kStages);
    const bf16* bs = stage_b(kt % kStages);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      unsigned af[4][4], bfr[4][2];
      load_a_frags<kAk>(af, as, wm, ks, lane);
      load_b_frags<kBk>(bfr, bs, wn, ks, lane);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          mma_add(acc[mi][nj], af[mi], bfr[nj][0], bfr[nj][1]);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, q = lane & 3;
  if (p.splits > 1) {
    float* part = p.part + static_cast<long long>(blockIdx.z) * p.m * p.n;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mi * 16 + g + 8 * h;
        if (m >= p.m) continue;
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const int n = n0 + wn + nj * 8 + 2 * q;
          if (n < p.n)
            store_pair(part + static_cast<long long>(m) * p.n + n,
                       acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
        }
      }
    return;
  }
  // The aux tile into shared memory (over the stages) in one round of
  // copies: every aux read then precedes every store, which matters where C
  // is aux itself (dflat writes g2 over act) and the compiler must otherwise
  // keep each load behind the store before it.
  const bf16* auxs = smem;  // [kBM][kMRow]
  if constexpr (kReadsAux<kEpi>) {
    static_assert(sizeof(TAux) == 2, "the staged aux tile is bf16");
    const TAux* ag = static_cast<const TAux*>(pick(p.aux, t));
    __syncthreads();  // every warp is done with the stages
    for (int i = tid; i < kBM * kBN / 8; i += mma::kThreads) {
      const int r = i >> 4, cc = (i & 15) * 8;
      const bool ok = m0 + r < p.m && n0 + cc < p.n;
      cp_async16(smem + r * mma::kMRow + cc,
                 ok ? ag + (m0 + r) * p.ldaux + n0 + cc : ag, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  TC* c = static_cast<TC*>(pick(p.c, t));
  float cs[4][2];  // kMaskPositiveSum: this thread's column sums
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) cs[nj][0] = cs[nj][1] = 0.0f;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + mi * 16 + g + 8 * h;
      if (m >= p.m) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int n = n0 + wn + nj * 8 + 2 * q;
        if (n >= p.n) continue;
        float2 a = make_float2(0.0f, 0.0f);
        if constexpr (kReadsAux<kEpi>) {
          const unsigned u = *reinterpret_cast<const unsigned*>(
              auxs + (m - m0) * mma::kMRow + n - n0);
          a = make_float2(bf16_half<false>(u), bf16_half<true>(u));
        }
        const float2 v = epilogue_pair<kEpi>(p, t, acc[mi][nj][2 * h],
                                             acc[mi][nj][2 * h + 1], a, n);
        store_pair(c + m * p.ldc + n, v.x, v.y);
        cs[nj][0] += v.x;
        cs[nj][1] += v.y;
      }
    }
  if constexpr (kEpi == kMaskPositiveSum) {
    // column sums over the block's 128 rows in a fixed order: the thread's
    // rows, the butterfly over the lanes of one column, the two warp rows
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          cs[nj][e] += __shfl_xor_sync(0xffffffffu, cs[nj][e], off);
    float* csum = reinterpret_cast<float*>(smem_raw);  // [2][kBN]
    __syncthreads();  // every warp is done with the aux tile
    if (g == 0)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          csum[(warp >> 2) * kBN + wn + nj * 8 + 2 * q + e] = cs[nj][e];
    __syncthreads();
    if (tid < kBN)
      sums[(static_cast<long long>(t) * gridDim.y + blockIdx.y) * p.n + n0 +
           tid] = csum[tid] + csum[kBN + tid];
  }
}

// Enqueue the product (and its split-K reduce).  The host checks what the
// 16-byte copies need: a k-contiguous operand's k and every leading
// dimension multiples of 8, an m- or n-contiguous operand's rows too; that
// the splits cover the k tiles with none empty; and for kMaskPositiveSum
// one split, whole N tiles and somewhere for the sums.
template <bool kAk, bool kBk, int kEpi, class TC, class TAux = bf16>
cudaError_t run_mma_gemm(const Gemm& p, cudaStream_t stream,
                         float* sums = nullptr) {
  const int ktiles = ceil_div(p.k, mma::kBK);
  const bool ok =
      (kAk ? p.k % 8 == 0 : p.m % 8 == 0) && p.lda % 8 == 0 &&
      (kBk ? p.k % 8 == 0 : p.n % 8 == 0) && p.ldb % 8 == 0 &&
      p.ldc % 2 == 0 && (!kReadsAux<kEpi> || p.ldaux % 8 == 0) &&
      splits_ok(p, ktiles) &&
      (kEpi != kMaskPositiveSum ||
       (p.splits == 1 && p.n % mma::kBN == 0 && sums != nullptr));
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = mma_gemm_kernel<kAk, kBk, kEpi, TC, TAux>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, mma::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(p.n, mma::kBN), ceil_div(p.m, mma::kBM),
                  2 * p.splits);
  kernel<<<grid, mma::kThreads, mma::kSmemBytes, stream>>>(p, sums);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if constexpr (kEpi == kMaskPositiveSum)
    return cudaSuccess;
  else
    return run_splitk_reduce<kEpi, TC, TAux>(p, stream);
}

}  // namespace trunk
