// Lidar kernel: one 512-beam normalized scan per robot, with the cell-table
// lookup and candidate gather fused in.
//
// Replaces rl_collision_avoidance_tpu/ops/lidar_pallas.py::_kernel (launched
// by make_scan_fn).  Its plain PyTorch version is
// rl_collision_avoidance_torch/ops/lidar_cuda.py::lidar_obs_plain: cell
// lookup, gather, engine/lidar.py::raycast_culled, then r / max_range - 0.5.
//
// What bounds it on an H100: instruction throughput, then latency.  At
// stage 1 with 128 arenas it reads ~0.1 MB (poses, the cell table rows, the
// beam table) and writes 6.3 MB, ~2 us at 3.35 TB/s.  Its work is, per
// beam, a test of each live candidate segment (~6.4 at stage 1) and each
// kept disc (~8), ~12 instructions a test, executed for a warp's 32 beams
// at a time: ~10M warp instructions for 3,072 robots.
//
// Design: one block per robot.  A prologue does all per-robot work once,
// into shared memory, while the block stages the beam table there: the
// heading's cos and sin; for each live candidate segment p - o, e and
// cross(p - o, e) (a padding slot has e = 0 and never hits, so it is
// dropped); for each other disc c - o and c2 = |c - o|^2 - r^2, dropping
// the discs that cannot change the clipped result (origin inside or on the
// disc, or the disc beyond max_range).  lidar_cuda.py states both rules
// (live_slots, disc_kept) and tests/test_torch_lidar_cull.py holds them
// conservative.  Each thread then takes kPer beams at once, so that every
// candidate it reads from shared memory serves kPer independent tests: per
// segment the cross products w and c0 and the window test
// c0 (w - c0) >= 0, dividing only where the window passes; per disc b and
// b^2 - c2, with a square root only where that is positive.  At 512 beams
// that is 256 threads a block, eight blocks an SM at 32 registers.  The TPU
// kernel's (A, K, N, 4) culled-segment tensor never exists in device
// memory.
//
// Walls-only mode: a far-disc bound far_c2 = 0 keeps no disc (the keep rule
// is 0 < c2 < far_c2), so the block tests the cell-culled walls alone; the
// caller adds the other robots' silhouettes (boxes, or the k nearest discs)
// itself.
//
// Numerics: every operation is the IEEE-rounded one the plain version does,
// in its order (__fmul_rn / __fadd_rn / __fsub_rn forbid FMA contraction,
// __fdiv_rn and __fsqrt_rn are exact), so kernel and plain version agree to
// the last bit wherever cosf/sinf do; the hoisted values are the same
// operations on the same operands, so they keep their bits.  The culls skip
// only candidates whose float32 test cannot give a hit below max_range, and
// a minimum is order-free, so the result does not depend on them.  The
// division is the exact one of the TPU kernel's interpret branch, not its
// approximate reciprocal.
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr float kEps = 1e-8f;
constexpr float kBig = 1e9f;
constexpr int kWarp = 32;
constexpr int kMaxThreads = 256;
constexpr int kPer = 2;  // beams a thread takes at once

// Where each lane's item goes when the warp appends, in lane order, the
// items whose ``keep`` holds after the ``count`` items already there.
__device__ __forceinline__ int slot(unsigned mask, int count, int lane) {
  return count + __popc(mask & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(kMaxThreads)
lidar_obs_kernel(const float* __restrict__ pose,   // (A, N, 3)
                 const float* __restrict__ table,  // (C, K, 4)
                 const float* __restrict__ dirs,   // (B, 2)
                 float* __restrict__ out,          // (A, N, B)
                 int n, int beams, int k, int nx, int ny, float lo_x,
                 float lo_y, float cell, float radius_sq, float max_range,
                 float far_c2) {
  extern __shared__ float4 sh[];
  float4* segs = sh;                // (K) p - o, e of the live slots
  float4* discs = sh + k;           // (N) c - o, c2 of the kept discs
  float2* dir = reinterpret_cast<float2*>(sh + k + n);   // (B) beam table
  float* t_num = reinterpret_cast<float*>(dir + beams);  // (K)
  __shared__ int n_seg, n_disc;
  __shared__ float heading[2];

  const int robot = blockIdx.x;  // arena * n + self
  const int arena = robot / n;
  const int self = robot - arena * n;
  const float x = pose[3 * robot];
  const float y = pose[3 * robot + 1];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;

  // Prologue: every thread stages its share of the beam table; job 0 the
  // segments, job 1 the discs, job 2 the heading, each on its own warp where
  // the block has three.
  const float2* dir2 = reinterpret_cast<const float2*>(dirs);
  for (int b = threadIdx.x; b < beams; b += blockDim.x) dir[b] = dir2[b];
  for (int job = warp; job < 3; job += blockDim.x / kWarp) {
    if (job == 0) {
      // engine/celltable.py::lookup_cells: truncate toward zero, then clamp.
      int ix = static_cast<int>(__fdiv_rn(__fsub_rn(x, lo_x), cell));
      int iy = static_cast<int>(__fdiv_rn(__fsub_rn(y, lo_y), cell));
      ix = min(max(ix, 0), nx - 1);
      iy = min(max(iy, 0), ny - 1);
      const float4* cand = reinterpret_cast<const float4*>(table) +
                           static_cast<size_t>(ix * ny + iy) * k;
      int count = 0;
      for (int base = 0; base < k; base += kWarp) {
        const int q = base + lane;
        const float4 s = q < k ? cand[q] : make_float4(0.f, 0.f, 0.f, 0.f);
        const bool live = s.z != 0.0f || s.w != 0.0f;
        const unsigned mask = __ballot_sync(0xffffffffu, live);
        if (live) {
          const int at = slot(mask, count, lane);
          const float px = __fsub_rn(s.x, x);
          const float py = __fsub_rn(s.y, y);
          segs[at] = make_float4(px, py, s.z, s.w);
          t_num[at] = __fsub_rn(__fmul_rn(px, s.w), __fmul_rn(py, s.z));
        }
        count += __popc(mask);
      }
      if (lane == 0) n_seg = count;
    } else if (job == 1) {
      const float* arena_pose = pose + static_cast<size_t>(arena) * n * 3;
      int count = 0;
      for (int base = 0; base < n; base += kWarp) {
        const int j = base + lane;
        float ocx = 0.f, ocy = 0.f, c2 = 0.f;
        if (j < n && j != self) {
          ocx = __fsub_rn(arena_pose[3 * j], x);
          ocy = __fsub_rn(arena_pose[3 * j + 1], y);
          c2 = __fsub_rn(__fadd_rn(__fmul_rn(ocx, ocx), __fmul_rn(ocy, ocy)),
                         radius_sq);
        }
        // lidar_cuda.py::disc_kept: c2 <= 0 (origin inside or on the disc)
        // never hits; c2 >= far_c2 hits, if at all, beyond max_range.
        const bool keep = c2 > 0.0f && c2 < far_c2;
        const unsigned mask = __ballot_sync(0xffffffffu, keep);
        if (keep) {
          discs[slot(mask, count, lane)] = make_float4(ocx, ocy, c2, 0.f);
        }
        count += __popc(mask);
      }
      if (lane == 0) n_disc = count;
    } else if (lane == 0) {
      const float th = pose[3 * robot + 2];
      heading[0] = cosf(th);
      heading[1] = sinf(th);
    }
  }
  __syncthreads();

  const float c = heading[0];
  const float s = heading[1];
  const int ns = n_seg;
  const int nd = n_disc;
  // Each thread takes kPer beams at once, blockDim.x apart, so that every
  // candidate it reads from shared memory serves kPer independent tests.
  for (int b0 = threadIdx.x; b0 < beams; b0 += kPer * blockDim.x) {
    float dx[kPer], dy[kPer], d[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float2 l = dir[min(b0 + i * static_cast<int>(blockDim.x),
                               beams - 1)];
      dx[i] = __fsub_rn(__fmul_rn(c, l.x), __fmul_rn(s, l.y));
      dy[i] = __fadd_rn(__fmul_rn(s, l.x), __fmul_rn(c, l.y));
      d[i] = kBig;
    }
    // Ray/segment: w = cross(d, e), c0 = cross(p - o, d) = u w; u in [0, 1]
    // iff c0 (w - c0) >= 0, and t = cross(p - o, e) / w.
    for (int q = 0; q < ns; ++q) {
      const float4 g = segs[q];
      const float tn = t_num[q];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float w =
            __fsub_rn(__fmul_rn(dx[i], g.w), __fmul_rn(dy[i], g.z));
        const float c0 =
            __fsub_rn(__fmul_rn(g.x, dy[i]), __fmul_rn(g.y, dx[i]));
        if (__fmul_rn(c0, __fsub_rn(w, c0)) >= 0.0f) {
          const float t = __fdiv_rn(tn, w == 0.0f ? kEps : w);
          if (t > kEps) d[i] = fminf(d[i], t);
        }
      }
    }
    // Ray/disc: t = b - sqrt(b^2 - c2) with b = d.(c - o).
    for (int j = 0; j < nd; ++j) {
      const float4 o = discs[j];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float bb =
            __fadd_rn(__fmul_rn(dx[i], o.x), __fmul_rn(dy[i], o.y));
        const float disc = __fsub_rn(__fmul_rn(bb, bb), o.z);
        if (disc > 0.0f) {
          const float td = __fsub_rn(bb, __fsqrt_rn(disc));
          if (td > kEps) d[i] = fminf(d[i], td);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int b = b0 + i * static_cast<int>(blockDim.x);
      if (b < beams) {
        out[static_cast<size_t>(robot) * beams + b] =
            __fsub_rn(__fdiv_rn(fminf(d[i], max_range), max_range), 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" int lidar_obs_launch(const void* pose, const void* table,
                                const void* dirs, void* out, int arenas,
                                int n, int beams, int k, int nx, int ny,
                                float lo_x, float lo_y, float cell,
                                float radius_sq, float max_range,
                                float far_c2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int per_thread = (beams + kPer - 1) / kPer;
  const int threads =
      std::min(kMaxThreads, (per_thread + kWarp - 1) / kWarp * kWarp);
  const size_t smem =
      sizeof(float4) * (k + n) + sizeof(float2) * beams + sizeof(float) * k;
  lidar_obs_kernel<<<arenas * n, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pose), static_cast<const float*>(table),
      static_cast<const float*>(dirs), static_cast<float*>(out), n, beams, k,
      nx, ny, lo_x, lo_y, cell, radius_sq, max_range, far_c2);
  return cudaGetLastError();
}

extern "C" const char* rca_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
