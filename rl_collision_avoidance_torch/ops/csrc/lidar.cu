// Lidar kernel: one 512-beam normalized scan per robot, with the cell-table
// lookup and candidate gather fused in.
//
// Replaces rl_collision_avoidance_tpu/ops/lidar_pallas.py::_kernel (launched
// by make_scan_fn).  Its plain PyTorch version is
// rl_collision_avoidance_torch/ops/lidar_cuda.py::lidar_obs_plain: cell
// lookup, gather, engine/lidar.py::raycast_culled, then r / max_range - 0.5.
//
// What bounds it on an H100: neither bytes nor operations.  At stage 1 with
// 128 arenas it reads ~0.1 MB (poses, the cell table rows, the beam table)
// and writes 6.3 MB, and does ~0.5 GFLOP of f32 arithmetic (per beam 16
// segment tests and 23 disc tests of ~12 operations): a few microseconds
// either way, so launch latency and the per-thread serial loop set its time.
//
// Design: one block per robot, one thread per beam.  Every thread repeats
// the robot's cell lookup (a few operations, no extra synchronisation); the
// block stages the robot's K candidate segments and its arena's N disc
// centres in shared memory, then each thread loops over segments and discs
// with a running f32 minimum.  The TPU kernel's (A, K, N, 4) culled-segment
// tensor never exists in device memory.
//
// Numerics: every operation is the IEEE-rounded one the plain version does,
// in its order (__fmul_rn / __fadd_rn / __fsub_rn forbid FMA contraction,
// __fdiv_rn and __fsqrt_rn are exact), so kernel and plain version agree to
// the last bit wherever cosf/sinf do.  The division is the exact one of the
// TPU kernel's interpret branch, not its approximate reciprocal.
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr float kEps = 1e-8f;
constexpr float kBig = 1e9f;

__global__ void lidar_obs_kernel(const float* __restrict__ pose,   // (A, N, 3)
                                 const float* __restrict__ table,  // (C, K, 4)
                                 const float* __restrict__ dirs,   // (B, 2)
                                 float* __restrict__ out,          // (A, N, B)
                                 int n, int beams, int k, int nx, int ny,
                                 float lo_x, float lo_y, float cell,
                                 float radius_sq, float max_range) {
  extern __shared__ float sh[];
  float* segs = sh;         // (K, 4)
  float* cent = sh + 4 * k;  // (N, 2)
  const int robot = blockIdx.x;  // arena * n + self
  const int arena = robot / n;
  const int self = robot - arena * n;
  const float x = pose[3 * robot];
  const float y = pose[3 * robot + 1];
  const float th = pose[3 * robot + 2];

  // engine/celltable.py::lookup_cells: truncate toward zero, then clamp.
  int ix = static_cast<int>(__fdiv_rn(__fsub_rn(x, lo_x), cell));
  int iy = static_cast<int>(__fdiv_rn(__fsub_rn(y, lo_y), cell));
  ix = min(max(ix, 0), nx - 1);
  iy = min(max(iy, 0), ny - 1);
  const float* cand = table + static_cast<size_t>(ix * ny + iy) * k * 4;
  for (int i = threadIdx.x; i < 4 * k; i += blockDim.x) segs[i] = cand[i];
  const float* arena_pose = pose + static_cast<size_t>(arena) * n * 3;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    cent[2 * j] = arena_pose[3 * j];
    cent[2 * j + 1] = arena_pose[3 * j + 1];
  }
  __syncthreads();

  const float c = cosf(th);
  const float s = sinf(th);
  for (int b = threadIdx.x; b < beams; b += blockDim.x) {
    const float lx = dirs[2 * b];
    const float ly = dirs[2 * b + 1];
    const float dx = __fsub_rn(__fmul_rn(c, lx), __fmul_rn(s, ly));
    const float dy = __fadd_rn(__fmul_rn(s, lx), __fmul_rn(c, ly));

    // 13-op ray/segment test: w = cross(d, e), c0 = cross(p0 - o, d) = u w;
    // u in [0, 1] iff c0 (w - c0) >= 0, and t = cross(p0 - o, e) / w.
    float d_seg = kBig;
    for (int q = 0; q < k; ++q) {
      const float px = __fsub_rn(segs[4 * q], x);
      const float py = __fsub_rn(segs[4 * q + 1], y);
      const float ex = segs[4 * q + 2];
      const float ey = segs[4 * q + 3];
      const float w = __fsub_rn(__fmul_rn(dx, ey), __fmul_rn(dy, ex));
      const float c0 = __fsub_rn(__fmul_rn(px, dy), __fmul_rn(py, dx));
      const float t_num = __fsub_rn(__fmul_rn(px, ey), __fmul_rn(py, ex));
      const float win = __fmul_rn(c0, __fsub_rn(w, c0));
      const float t = __fdiv_rn(t_num, w == 0.0f ? kEps : w);
      if (win >= 0.0f && t > kEps) d_seg = fminf(d_seg, t);
    }

    // Ray-disc: t = b - sqrt(b^2 - c2), c2 = |c - o|^2 - r^2; self excluded.
    float d_rob = kBig;
    for (int j = 0; j < n; ++j) {
      if (j == self) continue;
      const float ocx = __fsub_rn(cent[2 * j], x);
      const float ocy = __fsub_rn(cent[2 * j + 1], y);
      const float c2 = __fsub_rn(
          __fadd_rn(__fmul_rn(ocx, ocx), __fmul_rn(ocy, ocy)), radius_sq);
      const float bb = __fadd_rn(__fmul_rn(dx, ocx), __fmul_rn(dy, ocy));
      const float disc = __fsub_rn(__fmul_rn(bb, bb), c2);
      const float td = __fsub_rn(bb, __fsqrt_rn(fmaxf(disc, 0.0f)));
      if (disc > 0.0f && td > kEps) d_rob = fminf(d_rob, td);
    }

    const float r = fminf(fminf(d_seg, d_rob), max_range);
    out[static_cast<size_t>(robot) * beams + b] =
        __fsub_rn(__fdiv_rn(r, max_range), 0.5f);
  }
}

}  // namespace

extern "C" int lidar_obs_launch(const void* pose, const void* table,
                                const void* dirs, void* out, int arenas,
                                int n, int beams, int k, int nx, int ny,
                                float lo_x, float lo_y, float cell,
                                float radius_sq, float max_range, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int threads = std::min(1024, (beams + 31) / 32 * 32);
  const size_t smem = sizeof(float) * (4 * k + 2 * n);
  lidar_obs_kernel<<<arenas * n, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pose), static_cast<const float*>(table),
      static_cast<const float*>(dirs), static_cast<float*>(out), n, beams, k,
      nx, ny, lo_x, lo_y, cell, radius_sq, max_range);
  return cudaGetLastError();
}

extern "C" const char* rca_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
