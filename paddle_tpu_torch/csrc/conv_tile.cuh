// conv_tile.cuh: the helpers the three conv + batch-norm kernels share
// (conv_affine.cu, conv_bn_train.cu, conv_bn_bwd.cu), for Hopper (sm_90a):
// conversions between the operand dtype and float32, the conv geometry,
// the folded batch-norm affine and the relu. All three run their GEMMs on
// conv_mma.cuh's tensor-core mainloop.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace convtile {

constexpr int LANES = 32;  // lanes per channel of the cross-block merges

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round a float32 sum to T and back: the conv output as the reference's
// kernels store it (in x's dtype)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

struct ConvGeom {
  int N, H, W, Cin, Cout, kh, kw, stride, ph, pw, Ho, Wo;
};

// The folded batch-norm affine of a channel's statistics, with explicit
// round-to-nearest ops (no FMA contraction): inv = rsqrt(var + eps),
// a = scale * inv, b = bias - mean * a. The forward and the backward both
// fold through this function, so they see the same a and b.
struct Fold {
  float a, b, inv;
};
__device__ __forceinline__ Fold bn_fold(float scale, float bias, float mean,
                                        float var, float eps) {
  Fold f;
  f.inv = __frsqrt_rn(__fadd_rn(var, eps));
  f.a = __fmul_rn(scale, f.inv);
  f.b = __fsub_rn(bias, __fmul_rn(mean, f.a));
  return f;
}

// z * a + b with explicit round-to-nearest ops: the pre-activation
__device__ __forceinline__ float affine(float z, float a, float b) {
  return __fadd_rn(__fmul_rn(z, a), b);
}

// max(v, 0) that keeps a NaN, as the plain versions' clamp does (fmaxf
// would return 0)
__device__ __forceinline__ float relu_of(float v) {
  return v < 0.f ? 0.f : v;
}

}  // namespace convtile

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
