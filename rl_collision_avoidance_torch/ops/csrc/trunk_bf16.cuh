// bf16 helpers of the twin-trunk kernels.
//
// In float32 mode every product operand is the float it is.  In bf16 mode
// (the JAX package's TrunkConfig(precision="default"): bf16 multiplies,
// float32 accumulation) every product operand is rounded to bf16, to
// nearest with ties to even as torch's .to(torch.bfloat16) and XLA's
// convert do, and the tensor cores multiply bf16 values exactly and add the
// products in float32 (trunk_mma.cuh).  Sums, bias adds and ReLUs stay
// float32.  The scans may be bf16 in either mode.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace trunk {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <class T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// The float whose bits are the bf16 in the high (kHigh) or low half of u.
template <bool kHigh>
__device__ __forceinline__ float bf16_half(unsigned u) {
  const unsigned bits = kHigh ? (u & 0xffff0000u) : (u << 16);
#if defined(__CUDA_ARCH__)
  return __uint_as_float(bits);
#else
  float f;
  __builtin_memcpy(&f, &bits, 4);
  return f;
#endif
}

// Four consecutive values at p (16-byte aligned for float, 8 for bf16), as
// floats; in global or shared memory.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_half<false>(u.x), bf16_half<true>(u.x),
                     bf16_half<false>(u.y), bf16_half<true>(u.y));
}

// Store four floats at p (16-byte aligned).
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

}  // namespace trunk
