// Env-step kernels: one control step of every robot of every arena, all of
// engine/env.py::Env.step but the lidar, in at most three launches; and the
// reset sampler's maps from its uniforms (Env.sample_pose_goal).
//
// Replaces no TPU kernel: the JAX package's step is plain XLA, fused by its
// compiler into the rollout's lax.scan.  The port ran the same step as ~100
// small PyTorch ops (engine/env.py::Env._step_plain, the plain version and
// the reference of these kernels), each ~15-20 us of host enqueue for ~2 us
// of device work, so the card waited on the host for most of a step.
//
// What bounds it on an H100: launch latency.  At 1,600 robots the step reads
// ~100 KB (state, actions, the wall-table rows) and writes ~120 KB, well
// under a microsecond at 3.35 TB/s; the work is ~50 robot pairs and ~4-16
// wall candidates a robot, a few thousand instructions a block.
//
// Design: env_physics_kernel takes one block per arena and one thread per
// robot, with the arena's candidate positions in shared memory.  In order:
// actions clipped and masked, diff-drive integration over the substeps, the
// wall-cell lookup and disc-vs-segment test over the wall table's row, after
// a barrier the disc-vs-disc test against the arena's other candidates, the
// stall select; then step counter, goal distance, reward, termination,
// result and the reset mask (per robot, per scenario group through a shared
// flag array, or never).  It writes every output of the step as if no robot
// reset.  env_reset_kernel, one thread per robot, then overwrites the robots
// under the reset mask with the sample the caller drew at the post-physics
// poses (phys_pose): pose, goal, first distance, counter, speed and return.
// A FIXED_TABLES world never resets and needs the first launch alone.  Both
// also write the body-frame goal of the observation.
//
// The reset sample between them: Env.sample_pose_goal draws its uniforms
// with torch.rand from the env's generator, and env_sample_kernel, one
// thread per robot, maps them as engine/sampling.py's plain maps do (8 to
// 42 small PyTorch kernels a step, each a launch).  RANDOM_DISC: the pose by
// polar inversion in the disc, then the first of K annulus candidates
// inside the disc, projected into it when none is.  TABLES_THEN_CORRIDOR:
// the robot's table pose (jittered where the world jitters) and goal, or,
// for a robot at n_fixed or above, the first of K corridor candidates at
// least 7 m from where it stands, its heading, and the first of K goal
// candidates at least 7 m from the new pose.  It reads the mode and n_fixed
// from EnvConsts, as env_physics_kernel does.  Each thread loops over its
// K candidates and stops at the first valid one: a few microseconds for
// ~1,600 robots.
//
// Numerics: every float operation is the IEEE-rounded one the plain chain
// does, in its order (__fmul_rn / __fadd_rn / __fsub_rn forbid contraction,
// __fdiv_rn and __fsqrt_rn are exact, cosf/sinf are PyTorch's own without
// fast math).  Where PyTorch reduces a pair (sum(-1), vector_norm), it adds
// the two rounded terms; a division by a scalar is a product with the
// scalar's float32 reciprocal, as PyTorch computes it on the card, and a
// scalar divided by a tensor (R / norm) is the tensor's reciprocal times
// the scalar.  Python-double constants are rounded to float32 once, as
// PyTorch rounds a scalar operand (2 pi, dmin^2, dmax^2 - dmin^2, 0.4).  So
// the outputs are the plain chain's bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxRobots = 1024;
constexpr int kResetThreads = 128;
// float32(2.0 * math.pi), the scalar PyTorch multiplies the samplers'
// uniforms by.
constexpr float kTwoPi = 6.2831854820251465f;

// ResetMode of worlds/spec.py.
enum Mode { kRandomDisc = 0, kTablesThenCorridor = 1, kFixedTables = 2 };

// Float outputs: offsets in units of M = arenas * n robots.
enum FloatOut {
  kPose = 0,       // (A, N, 3) the step's poses
  kPhysPose = 3,   // (A, N, 3) the poses before any reset
  kSpeed = 6,      // (A, N, 2) applied (v, w); 0 after a reset
  kGoal = 8,       // (A, N, 2)
  kObsGoal = 10,   // (A, N, 2) the goal in the robot's body frame
  kDist = 12,      // (A, N)
  kReturn = 13,    // (A, N) running episode return
  kReward = 14,    // (A, N)
  kInfoReturn = 15 // (A, N) the return where an episode ended, else 0
};
// Bool outputs, (A, N) each.
enum BoolOut { kDead = 0, kDone, kValid, kReached, kCrashed, kReset };

}  // namespace

// World constants, built once per env (ops/env_cuda.py::EnvConsts).
struct EnvConsts {
  const float4* wall;    // (C, K) [px, py, ex, ey] wall-cell table
  const int* group_id;   // (N) dense group ids, or null
  int k, nx, ny;
  float lo_x, lo_y, inv_cell;
  int n, mode, substeps, timeout, dist_zero;
  float h, radius_sq, diam_sq, goal_size, omega;
  // The reset sampler's: (N, 3) table poses and (N, 2) goals (null in a
  // RANDOM_DISC world), the robots that keep them, the disc's radius,
  // dmin^2, dmax^2 - dmin^2 and the table jitter.
  const float* pose_table;
  const float* goal_table;
  int n_fixed;
  float spawn_r, dmin_sq, d_span, jitter;
};

namespace {

// Tensor.clamp: NaN stays NaN.
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// Tensor.clamp_min.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// Tensor.clamp_max.
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

// torch.linalg.vector_norm of a pair: the two rounded squares, added.
__device__ __forceinline__ float norm2(float dx, float dy) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
}

// engine/env.py::local_goal.
__device__ __forceinline__ void local_goal(float px, float py, float th,
                                           float gx, float gy, float* out) {
  const float dx = __fsub_rn(gx, px);
  const float dy = __fsub_rn(gy, py);
  const float c = cosf(th);
  const float s = sinf(th);
  out[0] = __fadd_rn(__fmul_rn(dx, c), __fmul_rn(dy, s));
  out[1] = __fadd_rn(__fmul_rn(-dx, s), __fmul_rn(dy, c));
}

// engine/physics.py::wall_collision_packed for one disc and its cell's row.
__device__ bool wall_hit(const EnvConsts& c, float x, float y) {
  // engine/celltable.py::lookup_cells: truncate toward zero, then clamp.
  int ix = static_cast<int>(__fmul_rn(__fsub_rn(x, c.lo_x), c.inv_cell));
  int iy = static_cast<int>(__fmul_rn(__fsub_rn(y, c.lo_y), c.inv_cell));
  ix = min(max(ix, 0), c.nx - 1);
  iy = min(max(iy, 0), c.ny - 1);
  const float4* row = c.wall + static_cast<size_t>(ix * c.ny + iy) * c.k;
  bool hit = false;
  for (int q = 0; q < c.k; ++q) {
    const float4 s = row[q];
    const float pox = __fsub_rn(x, s.x);
    const float poy = __fsub_rn(y, s.y);
    const float ee =
        clamp_min(__fadd_rn(__fmul_rn(s.z, s.z), __fmul_rn(s.w, s.w)), 1e-12f);
    const float tt = clampf(
        __fdiv_rn(__fadd_rn(__fmul_rn(pox, s.z), __fmul_rn(poy, s.w)), ee),
        0.0f, 1.0f);
    const float dx = __fsub_rn(x, __fadd_rn(s.x, __fmul_rn(tt, s.z)));
    const float dy = __fsub_rn(y, __fadd_rn(s.y, __fmul_rn(tt, s.w)));
    hit |= __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) < c.radius_sq;
  }
  return hit;
}

__global__ void __launch_bounds__(kMaxRobots)
env_physics_kernel(EnvConsts c,
                   const float* __restrict__ pose,       // (A, N, 3)
                   const float* __restrict__ goal,       // (A, N, 2)
                   const float* __restrict__ dist,       // (A, N)
                   const int* __restrict__ step,         // (A, N)
                   const bool* __restrict__ dead,        // (A, N)
                   const float* __restrict__ ep_return,  // (A, N)
                   const float* __restrict__ action,     // (A, N, 2)
                   float* __restrict__ fout, bool* __restrict__ bout,
                   int* __restrict__ step_out,
                   long long* __restrict__ result_out) {
  extern __shared__ float env_sh[];
  float* cx = env_sh;                          // (blockDim) candidates
  float* cy = env_sh + blockDim.x;
  int* group_alive = reinterpret_cast<int*>(env_sh + 2 * blockDim.x);
  const int n = c.n;
  const int i = threadIdx.x;
  const bool robot = i < n;
  const size_t m = static_cast<size_t>(gridDim.x) * n;
  const size_t r = static_cast<size_t>(blockIdx.x) * n + i;

  // 1. Actions and integration (engine/physics.py::integrate).
  bool live = false;
  float v = 0.f, w = 0.f, x = 0.f, y = 0.f, th = 0.f;
  if (robot) {
    live = !dead[r];
    const float lf = live ? 1.0f : 0.0f;
    v = __fmul_rn(clampf(action[2 * r], 0.0f, 1.0f), lf);
    w = clampf(action[2 * r + 1], -1.0f, 1.0f);
    // Finished circle-eval robots keep steering with the policy's w but
    // v := 0 (circle_test.py:64-66): they spin in place.
    if (c.mode != kFixedTables) w = __fmul_rn(w, lf);
    x = pose[3 * r];
    y = pose[3 * r + 1];
    th = pose[3 * r + 2];
    for (int s = 0; s < c.substeps; ++s) {
      const float cs = cosf(th);
      const float sn = sinf(th);
      x = __fadd_rn(x, __fmul_rn(__fmul_rn(v, cs), c.h));
      y = __fadd_rn(y, __fmul_rn(__fmul_rn(v, sn), c.h));
      th = __fadd_rn(th, __fmul_rn(w, c.h));
    }
    cx[i] = x;
    cy[i] = y;
  }
  group_alive[i] = 0;
  __syncthreads();

  // 2. Collisions: walls, then the arena's other candidates; a stalled
  // robot keeps its pose.
  bool stalled = false;
  if (robot) {
    stalled = wall_hit(c, x, y);
    for (int j = 0; j < n; ++j) {
      const float dx = __fsub_rn(x, cx[j]);
      const float dy = __fsub_rn(y, cy[j]);
      stalled |= j != i && __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <
                               c.diam_sq;
    }
    if (stalled) {
      x = pose[3 * r];
      y = pose[3 * r + 1];
      th = pose[3 * r + 2];
    }
  }

  // 3. Termination and reward (stage_world1.py:180-211).
  const float lf = live ? 1.0f : 0.0f;
  float gx = 0.f, gy = 0.f, dn = 0.f, ret_now = 0.f;
  bool terminal = false, reached = false, dead_after = false;
  int steps = 0;
  if (robot) {
    steps = step[r] + (live ? 1 : 0);
    gx = goal[2 * r];
    gy = goal[2 * r + 1];
    dn = norm2(__fsub_rn(gx, x), __fsub_rn(gy, y));
    reached = dn < c.goal_size;
    const bool timeout = steps > c.timeout;
    const float reward_g =
        reached ? 15.0f : __fmul_rn(__fsub_rn(dist[r], dn), 2.5f);
    const float reward_c = stalled ? -15.0f : 0.0f;
    // The spin penalty reads the realized w: a stalled robot did not turn.
    const float w_real = fabsf(__fmul_rn(w, stalled ? 0.0f : 1.0f));
    const float reward_w =
        w_real > c.omega ? __fmul_rn(w_real, -0.1f) : 0.0f;
    const float reward =
        __fmul_rn(__fadd_rn(__fadd_rn(reward_g, reward_c), reward_w), lf);
    terminal = (reached || stalled || timeout) && live;
    dead_after = !live || terminal;
    ret_now = __fadd_rn(ep_return[r], reward);
    fout[kReward * m + r] = reward;
    fout[kInfoReturn * m + r] = terminal ? ret_now : 0.0f;
    result_out[r] = !live ? 0 : timeout ? 3 : stalled ? 2 : reached ? 1 : 0;
    if (c.mode == kTablesThenCorridor && !dead_after) {
      group_alive[c.group_id[i]] = 1;
    }
  }
  __syncthreads();
  if (!robot) return;

  bool reset, dead_next;
  if (c.mode == kRandomDisc) {
    reset = terminal;
    dead_next = false;
  } else if (c.mode == kTablesThenCorridor) {
    // Group-synchronized episode boundaries (model/utils.py:81-87).
    reset = group_alive[c.group_id[i]] == 0;
    dead_next = dead_after && !reset;
  } else {
    reset = false;
    dead_next = dead_after;
  }

  // Every output as if the robot did not reset; env_reset_kernel
  // overwrites the robots that do.
  float* p = fout + kPose * m + 3 * r;
  p[0] = x;
  p[1] = y;
  p[2] = th;
  if (c.mode != kFixedTables) {
    float* q = fout + kPhysPose * m + 3 * r;
    q[0] = x;
    q[1] = y;
    q[2] = th;
  }
  fout[kSpeed * m + 2 * r] = v;
  fout[kSpeed * m + 2 * r + 1] = w;
  fout[kGoal * m + 2 * r] = gx;
  fout[kGoal * m + 2 * r + 1] = gy;
  if (!reset) local_goal(x, y, th, gx, gy, fout + kObsGoal * m + 2 * r);
  fout[kDist * m + r] = dn;
  fout[kReturn * m + r] = ret_now;
  step_out[r] = steps;
  bout[kDead * m + r] = dead_next;
  bout[kDone * m + r] = dead_after;
  bout[kValid * m + r] = live;
  bout[kReached * m + r] = reached && live;
  bout[kCrashed * m + r] = stalled && live;
  bout[kReset * m + r] = reset;
}

__global__ void __launch_bounds__(kResetThreads)
env_reset_kernel(EnvConsts c, int m,
                 const float* __restrict__ reset_pose,  // (A, N, 3)
                 const float* __restrict__ reset_goal,  // (A, N, 2)
                 float* __restrict__ fout, const bool* __restrict__ bout,
                 int* __restrict__ step_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m || !bout[static_cast<size_t>(kReset) * m + r]) return;
  const size_t mm = m;
  const float x = reset_pose[3 * r];
  const float y = reset_pose[3 * r + 1];
  const float th = reset_pose[3 * r + 2];
  const float gx = reset_goal[2 * r];
  const float gy = reset_goal[2 * r + 1];
  float* p = fout + kPose * mm + 3 * r;
  p[0] = x;
  p[1] = y;
  p[2] = th;
  fout[kGoal * mm + 2 * r] = gx;
  fout[kGoal * mm + 2 * r + 1] = gy;
  // The first "previous distance": 0 (stage 2, circle) or the true one.
  fout[kDist * mm + r] =
      c.dist_zero ? 0.0f : norm2(__fsub_rn(gx, x), __fsub_rn(gy, y));
  step_out[r] = 0;
  // Fresh resets start at rest.
  fout[kSpeed * mm + 2 * r] = 0.0f;
  fout[kSpeed * mm + 2 * r + 1] = 0.0f;
  fout[kReturn * mm + r] = 0.0f;
  local_goal(x, y, th, gx, gy, fout + kObsGoal * mm + 2 * r);
}

// engine/sampling.py::stage1_poses_from and stage1_goals_from for robot r:
// u_pose (3, M), u_goal (2, M, K).
__device__ void disc_sample(const EnvConsts& c, int m, int k, int r,
                            const float* __restrict__ u_pose,
                            const float* __restrict__ u_goal, float* pose,
                            float* goal) {
  const float rad = __fmul_rn(c.spawn_r, __fsqrt_rn(u_pose[r]));
  const float phi = __fmul_rn(kTwoPi, u_pose[m + r]);
  const float px = __fmul_rn(rad, cosf(phi));
  const float py = __fmul_rn(rad, sinf(phi));
  pose[0] = px;
  pose[1] = py;
  pose[2] = __fmul_rn(kTwoPi, u_pose[2 * m + r]);
  // The first candidate inside the disc (argmax over a uint8 mask: the
  // first valid one, else candidate 0).
  const float* ur = u_goal + static_cast<size_t>(r) * k;
  const float* uphi = ur + static_cast<size_t>(m) * k;
  float gx = 0.f, gy = 0.f;
  for (int q = 0; q < k; ++q) {
    const float rq =
        __fsqrt_rn(__fadd_rn(c.dmin_sq, __fmul_rn(ur[q], c.d_span)));
    const float ph = __fmul_rn(kTwoPi, uphi[q]);
    const float x = __fadd_rn(px, __fmul_rn(rq, cosf(ph)));
    const float y = __fadd_rn(py, __fmul_rn(rq, sinf(ph)));
    const bool valid = norm2(x, y) <= c.spawn_r;
    if (q == 0 || valid) {
      gx = x;
      gy = y;
      if (valid) break;
    }
  }
  // Into the disc: scale = min(R / max(|g|, 1e-6), 1), where R / t is
  // PyTorch's reciprocal(t) * R.
  const float nrm = clamp_min(norm2(gx, gy), 1e-6f);
  const float scale = clamp_max(__fmul_rn(__fdiv_rn(1.0f, nrm), c.spawn_r),
                                1.0f);
  goal[0] = __fmul_rn(gx, scale);
  goal[1] = __fmul_rn(gy, scale);
}

// engine/sampling.py::_corridor_xy and the first of K candidates at least
// 7 m from (fx, fy), else candidate 0: ux, uy the candidates' uniforms.
__device__ void corridor_pick(int k, const float* __restrict__ ux,
                              const float* __restrict__ uy, float fx,
                              float fy, float* x_out, float* y_out) {
  for (int q = 0; q < k; ++q) {
    const float x = __fadd_rn(__fmul_rn(10.0f, ux[q]), 9.0f);
    const float ty = __fmul_rn(uy[q], 10.0f);
    const float y =
        uy[q] <= 0.4f ? -__fadd_rn(ty, 1.0f) : -__fadd_rn(ty, 9.0f);
    const bool valid = norm2(__fsub_rn(x, fx), __fsub_rn(y, fy)) >= 7.0f;
    if (q == 0 || valid) {
      *x_out = x;
      *y_out = y;
      if (valid) return;
    }
  }
}

__global__ void __launch_bounds__(kResetThreads)
env_sample_kernel(EnvConsts c, int m, int k,
                  const float* __restrict__ u_pose,    // (3, A, N[, K])
                  const float* __restrict__ u_goal,    // (2, A, N, K)
                  const float* __restrict__ u_jitter,  // (A, N, 2) or null
                  const float* __restrict__ cur_pose,  // (A, N, 3) or null
                  float* __restrict__ out) {  // pose (A, N, 3), goal (A, N, 2)
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m) return;
  const size_t mm = m;
  float* pose = out + 3 * static_cast<size_t>(r);
  float* goal = out + 3 * mm + 2 * static_cast<size_t>(r);
  if (c.mode == kRandomDisc) {
    disc_sample(c, m, k, r, u_pose, u_goal, pose, goal);
    return;
  }
  const int i = r % c.n;
  if (i < c.n_fixed) {
    // The table pose, x/y moved by jitter * (2 u - 1) where the world
    // jitters (engine/sampling.py::table_poses_from).
    float x = c.pose_table[3 * i];
    float y = c.pose_table[3 * i + 1];
    if (u_jitter != nullptr) {
      const float jx = __fsub_rn(__fmul_rn(2.0f, u_jitter[2 * r]), 1.0f);
      const float jy = __fsub_rn(__fmul_rn(2.0f, u_jitter[2 * r + 1]), 1.0f);
      x = __fadd_rn(x, __fmul_rn(c.jitter, jx));
      y = __fadd_rn(y, __fmul_rn(c.jitter, jy));
    }
    pose[0] = x;
    pose[1] = y;
    pose[2] = c.pose_table[3 * i + 2];
    goal[0] = c.goal_table[2 * i];
    goal[1] = c.goal_table[2 * i + 1];
    return;
  }
  // A corridor robot (corridor_poses_from, corridor_goals_from): a pose at
  // least 7 m from where it stands (the origin without cur_pose), heading
  // 2 pi u[2, r, 0], and a goal at least 7 m from the new pose.
  const size_t mk = mm * k;
  const float* u = u_pose + static_cast<size_t>(r) * k;
  const float fx = cur_pose != nullptr ? cur_pose[3 * r] : 0.0f;
  const float fy = cur_pose != nullptr ? cur_pose[3 * r + 1] : 0.0f;
  float px = 0.f, py = 0.f, gx = 0.f, gy = 0.f;
  corridor_pick(k, u, u + mk, fx, fy, &px, &py);
  pose[0] = px;
  pose[1] = py;
  pose[2] = __fmul_rn(kTwoPi, u[2 * mk]);
  const float* ug = u_goal + static_cast<size_t>(r) * k;
  corridor_pick(k, ug, ug + mk, px, py, &gx, &gy);
  goal[0] = gx;
  goal[1] = gy;
}

}  // namespace

extern "C" int env_physics_launch(const EnvConsts* c, int arenas,
                                  const void* pose, const void* goal,
                                  const void* dist, const void* step,
                                  const void* dead, const void* ep_return,
                                  const void* action, void* fout, void* bout,
                                  void* step_out, void* result_out,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (c->n < 1 || c->n > kMaxRobots) return cudaErrorInvalidValue;
  const int threads = (c->n + kWarp - 1) / kWarp * kWarp;
  const size_t smem = threads * (2 * sizeof(float) + sizeof(int));
  env_physics_kernel<<<arenas, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      *c, static_cast<const float*>(pose), static_cast<const float*>(goal),
      static_cast<const float*>(dist), static_cast<const int*>(step),
      static_cast<const bool*>(dead), static_cast<const float*>(ep_return),
      static_cast<const float*>(action), static_cast<float*>(fout),
      static_cast<bool*>(bout), static_cast<int*>(step_out),
      static_cast<long long*>(result_out));
  return cudaGetLastError();
}

extern "C" int env_reset_launch(const EnvConsts* c, int arenas,
                                const void* reset_pose,
                                const void* reset_goal, void* fout,
                                const void* bout, void* step_out, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int m = arenas * c->n;
  env_reset_kernel<<<(m + kResetThreads - 1) / kResetThreads, kResetThreads,
                     0, static_cast<cudaStream_t>(stream)>>>(
      *c, m, static_cast<const float*>(reset_pose),
      static_cast<const float*>(reset_goal), static_cast<float*>(fout),
      static_cast<const bool*>(bout), static_cast<int*>(step_out));
  return cudaGetLastError();
}

extern "C" int env_sample_launch(const EnvConsts* c, int arenas, int k,
                                 const void* u_pose, const void* u_goal,
                                 const void* u_jitter, const void* cur_pose,
                                 void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int m = arenas * c->n;
  env_sample_kernel<<<(m + kResetThreads - 1) / kResetThreads, kResetThreads,
                      0, static_cast<cudaStream_t>(stream)>>>(
      *c, m, k, static_cast<const float*>(u_pose),
      static_cast<const float*>(u_goal), static_cast<const float*>(u_jitter),
      static_cast<const float*>(cur_pose), static_cast<float*>(out));
  return cudaGetLastError();
}
