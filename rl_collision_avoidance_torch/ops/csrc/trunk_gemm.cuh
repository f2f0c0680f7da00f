// The float32 mode's product core of the twin-trunk kernels: C = A B per
// trunk, register tiled, float32 FMA only (no tensor cores, no TF32: the
// exact-f32 rule).  trunk_fwd.cu runs fc1 on it; trunk_bwd.cu the fc1
// recompute, dWf and dflat.  The bf16 mode's products run on the tensor
// cores instead (trunk_mma.cuh), which shares this file's Gemm, epilogues,
// cp.async helpers and split-K reduce.
//
// What bounds it on an H100: the 67 TFLOP/s FFMA peak; fc1 at B = 32,768 is
// 0.14 TFLOP, ~2.1 ms at that peak.
//
// A block owns a kBM x kBN tile of C; its 256 threads own 8 x 8 outputs
// each.  Shared memory is a ring of kStages stages filled by 16-byte
// cp.async copies, so the copies of the next stages overlap the FMAs of this
// one.  An operand whose k index is contiguous in memory is staged as rows
// of kBK + kPad floats (rows r, r + 16, ... per thread, so one warp's float4
// reads hit distinct banks); one whose m or n index is contiguous as kBK
// rows of kBM floats (float4 chunks 4t and 64 + 4t per thread).  Either way
// a thread reads its fragments as float4 and adds the k terms of each
// output in order, k = 0, 1, ..., so a tile shape changes no rounding.
//
// Split-K: with splits > 1, block z = trunk * splits + s sums only the k
// tiles [s * kchunk, (s + 1) * kchunk) and writes its plain sum to
// part[trunk][s]; splitk_reduce then adds the partials in the order s = 0,
// 1, ... and applies the epilogue.  No float atomics: the same inputs give
// the same bits.
#pragma once

#include <cuda_runtime.h>

#include "trunk_bf16.cuh"

namespace trunk {

constexpr int kBM = 128, kBN = 128, kBK = 16;
constexpr int kStages = 3;
constexpr int kGemmThreads = 256;        // 16 x 16 threads, 8 x 8 outputs each
constexpr int kPad = 4;                  // floats after each k-contiguous row
constexpr int kTileFloats = kBM * (kBK + kPad);  // one operand, one stage

// Shared memory of a product: the ring of both operands.
constexpr int kGemmSmemBytes = 2 * kStages * kTileFloats * 4;
constexpr int kReduceThreads = 256;

// kStore: the sum.  kBiasRelu: max(sum + bias[n], 0) (fc1 forward).
// kBiasReluGrad: aux[m][n] where sum + bias[n] > 0, else 0 (the fc1 ReLU's
// backward).  kMaskPositive: the sum where aux[m][n] > 0, else 0; aux may
// be C itself (each element is read and then written by one thread).
enum Epilogue { kStore = 0, kBiasRelu = 1, kBiasReluGrad = 2,
                kMaskPositive = 3 };

// Per trunk t: element (m, k) of A at a[t][m * lda + k] when A is
// k-contiguous, else at a[t][k * lda + m]; (k, n) of B at b[t][n * ldb + k]
// when B is k-contiguous, else at b[t][k * ldb + n].  a and b are float
// (this core) or bf16 (trunk_mma.cuh); c and aux point at the instance's TC
// and TAux.
struct Gemm {
  const void* a[2];
  const void* b[2];
  void* c[2];
  const float* bias[2];
  const void* aux[2];
  long long lda, ldb, ldc, ldaux;
  int m, n, k;
  float* part;     // (2, splits, m, n) partial sums when splits > 1
  int splits, kchunk;  // kchunk: k tiles per split
};

// 16-byte asynchronous copy global -> shared; zero-fills when !valid.  The
// #else branch is the synchronous equivalent for a host compiler.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
#else
  float* f = static_cast<float*>(dst);
  const float* g = static_cast<const float*>(src);
  for (int i = 0; i < 4; ++i) f[i] = valid ? g[i] : 0.0f;
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
#endif
}

// Row (of A) or column (of B) of a thread's i-th fragment entry, t = ty or tx.
template <bool kKContig>
__device__ __forceinline__ int frag_index(int t, int i) {
  return kKContig ? t + 16 * i : 4 * t + (i & 3) + 64 * (i >> 2);
}

// One operand's k tile [k0, k0 + kBK) x rows [r0, r0 + 128) into shared
// memory in 16-byte chunks: 512 chunks of 4 floats, two per thread.  Chunks
// outside the operand (rows >= nrows, k >= nk) are zero-filled; the host
// guarantees that a chunk is either wholly inside or wholly outside.
template <bool kKContig>
__device__ __forceinline__ void load_tile(float* s, const float* g,
                                          long long ld, int r0, int nrows,
                                          int k0, int nk, int tid) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int c = tid + kGemmThreads * q;
    if (kKContig) {
      const int r = c >> 2, kq = (c & 3) * 4;
      const bool ok = r0 + r < nrows && k0 + kq < nk;
      cp_async16(s + r * (kBK + kPad) + kq,
                 ok ? g + (r0 + r) * ld + k0 + kq : g, ok);
    } else {
      const int kk = c >> 5, rq = (c & 31) * 4;
      const bool ok = k0 + kk < nk && r0 + rq < nrows;
      cp_async16(s + kk * kBM + rq, ok ? g + (k0 + kk) * ld + r0 + rq : g,
                 ok);
    }
  }
}

// Trunk t's pointer of a Gemm field: a select, not a run-time index into the
// kernel's parameter array (which measured slower on the H100).
template <class T>
__device__ __forceinline__ T pick(T const (&v)[2], int t) {
  return t == 0 ? v[0] : v[1];
}

template <class TAux>
__device__ __forceinline__ float aux_at(const Gemm& p, int t, int m, int n) {
  return to_float(static_cast<const TAux*>(pick(p.aux, t))[m * p.ldaux + n]);
}

template <int kEpi, class TAux>
__device__ __forceinline__ float epilogue(const Gemm& p, int t, float v,
                                          int m, int n) {
  if (kEpi == kBiasRelu) return fmaxf(v + pick(p.bias, t)[n], 0.0f);
  if (kEpi == kBiasReluGrad)
    return v + pick(p.bias, t)[n] > 0.0f ? aux_at<TAux>(p, t, m, n) : 0.0f;
  if (kEpi == kMaskPositive)
    return aux_at<TAux>(p, t, m, n) > 0.0f ? v : 0.0f;
  return v;
}

// Grid (n tiles, m tiles, 2 * splits).
template <bool kAk, bool kBk, int kEpi>
__global__ void __launch_bounds__(kGemmThreads, 2) gemm_kernel(Gemm p) {
  static_assert(kAk || !kBk, "an m-contiguous A needs an n-contiguous B");
  extern __shared__ __align__(16) float smem[];
  const int t = blockIdx.z / p.splits;
  const int split = blockIdx.z - t * p.splits;
  const float* a = static_cast<const float*>(pick(p.a, t));
  const float* b = static_cast<const float*>(pick(p.b, t));
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int ktiles = (p.k + kBK - 1) / kBK;
  const int kt0 = split * p.kchunk;
  const int nkt = min(ktiles, kt0 + p.kchunk) - kt0;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  auto stage_a = [&](int s) { return smem + s * 2 * kTileFloats; };
  auto stage_b = [&](int s) { return smem + s * 2 * kTileFloats + kTileFloats; };
  auto load = [&](int s, int kt) {
    const int k0 = (kt0 + kt) * kBK;
    load_tile<kAk>(stage_a(s), a, p.lda, m0, p.m, k0, p.k, tid);
    load_tile<kBk>(stage_b(s), b, p.ldb, n0, p.n, k0, p.k, tid);
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
    // thread has finished at the barrier above
    if (kt + kStages - 1 < nkt) load((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();
    const float* as = stage_a(kt % kStages);
    const float* bs = stage_b(kt % kStages);
    if constexpr (kAk) {
#pragma unroll
      for (int kq = 0; kq < kBK; kq += 4) {
        if (kBk) {
          // both operands k-contiguous: half the rows of A at a time, so
          // that 16 + 4 fragment registers sit beside the 64 sums
#pragma unroll
          for (int h = 0; h < 8; h += 4) {
            float4 av[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              av[i] = *reinterpret_cast<const float4*>(
                  as + frag_index<true>(ty, h + i) * (kBK + kPad) + kq);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float4 bv = *reinterpret_cast<const float4*>(
                  bs + frag_index<true>(tx, j) * (kBK + kPad) + kq);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                acc[h + i][j] = fmaf(av[i].x, bv.x, acc[h + i][j]);
                acc[h + i][j] = fmaf(av[i].y, bv.y, acc[h + i][j]);
                acc[h + i][j] = fmaf(av[i].z, bv.z, acc[h + i][j]);
                acc[h + i][j] = fmaf(av[i].w, bv.w, acc[h + i][j]);
              }
            }
          }
        } else {
          float4 av[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            av[i] = *reinterpret_cast<const float4*>(
                as + frag_index<true>(ty, i) * (kBK + kPad) + kq);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float* br = bs + (kq + kk) * kBN + 4 * tx;
            const float4 b0 = *reinterpret_cast<const float4*>(br);
            const float4 b1 = *reinterpret_cast<const float4*>(br + 64);
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float ak = kk == 0 ? av[i].x : kk == 1 ? av[i].y
                             : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ak, bv[j], acc[i][j]);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float* ar = as + kk * kBM + 4 * ty;
        const float* br = bs + kk * kBN + 4 * tx;
        const float4 a0 = *reinterpret_cast<const float4*>(ar);
        const float4 a1 = *reinterpret_cast<const float4*>(ar + 64);
        const float4 b0 = *reinterpret_cast<const float4*>(br);
        const float4 b1 = *reinterpret_cast<const float4*>(br + 64);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

  float* part = p.splits > 1
                    ? p.part + static_cast<long long>(blockIdx.z) * p.m * p.n
                    : nullptr;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + frag_index<kAk>(ty, i);
    if (m >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + frag_index<kBk>(tx, j);
      if (n >= p.n) continue;
      if (p.splits > 1)
        part[static_cast<long long>(m) * p.n + n] = acc[i][j];
      else
        static_cast<float*>(pick(p.c, t))[m * p.ldc + n] =
            epilogue<kEpi, float>(p, t, acc[i][j], m, n);
    }
  }
}

// C[t] = epilogue(part[t][0] + part[t][1] + ...), in that order; C and aux
// of type TC and TAux (float, or bf16 for the tensor-core core).
template <int kEpi, class TC, class TAux>
__global__ void __launch_bounds__(kReduceThreads) splitk_reduce(Gemm p) {
  const int t = blockIdx.y;
  const long long mn = static_cast<long long>(p.m) * p.n;
  const float* part = p.part + t * p.splits * mn;
  for (long long e = blockIdx.x * static_cast<long long>(kReduceThreads) +
                     threadIdx.x;
       e < mn; e += static_cast<long long>(gridDim.x) * kReduceThreads) {
    float v = part[e];
    for (int s = 1; s < p.splits; ++s) v += part[s * mn + e];
    const int m = static_cast<int>(e / p.n);
    const int n = static_cast<int>(e - static_cast<long long>(m) * p.n);
    static_cast<TC*>(pick(p.c, t))[m * p.ldc + n] =
        from_float<TC>(epilogue<kEpi, TAux>(p, t, v, m, n));
  }
}

// Floats of split-K partials a product of this shape needs.
inline long long gemm_part_floats(int m, int n, int splits) {
  return splits > 1 ? 2LL * splits * m * n : 0;
}

// The split-K checks both cores make: the splits cover the k tiles with
// none empty, and partials have somewhere to go.
inline bool splits_ok(const Gemm& p, int ktiles) {
  return p.splits >= 1 && p.kchunk >= 1 &&
         static_cast<long long>(p.splits) * p.kchunk >= ktiles &&
         static_cast<long long>(p.splits - 1) * p.kchunk < ktiles &&
         (p.splits == 1 || p.part != nullptr);
}

// Enqueue p's split-K reduce (after its product), when it has splits.
template <int kEpi, class TC, class TAux>
cudaError_t run_splitk_reduce(const Gemm& p, cudaStream_t stream) {
  if (p.splits == 1) return cudaSuccess;
  const long long mn = static_cast<long long>(p.m) * p.n;
  const long long want = (mn + kReduceThreads - 1) / kReduceThreads;
  const dim3 rgrid(static_cast<unsigned>(want < 1024 ? want : 1024), 2);
  splitk_reduce<kEpi, TC, TAux><<<rgrid, kReduceThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// Enqueue the product (and its split-K reduce).  The host checks what the
// 16-byte copies need: a k-contiguous operand's k and leading dimension, an
// m- or n-contiguous operand's rows and leading dimension, multiples of 4;
// and that the splits cover the k tiles with none empty.
template <bool kAk, bool kBk, int kEpi>
cudaError_t run_gemm(const Gemm& p, cudaStream_t stream) {
  const int ktiles = (p.k + kBK - 1) / kBK;
  const bool ok =
      (kAk ? p.k % 4 == 0 : p.m % 4 == 0) && p.lda % 4 == 0 &&
      (kBk ? p.k % 4 == 0 : p.n % 4 == 0) && p.ldb % 4 == 0 &&
      splits_ok(p, ktiles);
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = gemm_kernel<kAk, kBk, kEpi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + kBN - 1) / kBN, (p.m + kBM - 1) / kBM, 2 * p.splits);
  kernel<<<grid, kGemmThreads, kGemmSmemBytes, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return run_splitk_reduce<kEpi, float, float>(p, stream);
}

}  // namespace trunk
