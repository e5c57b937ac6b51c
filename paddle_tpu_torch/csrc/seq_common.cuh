// seq_common: what the whole-sequence recurrent kernels (lstm_seq.cu,
// gru_seq.cu) share: their cooperative partition (block j owns hidden units
// 4j..4j+3 and their GATES gate columns), the bf16 rounding and sigmoid
// they compute with, the staging of rows and of a block's columns of W into
// shared memory, their shape limits and shared-memory sizes, and the
// cooperative launch. Each .cu includes it into its own library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>

namespace seq {

constexpr int UNITS = 4;          // hidden units per block
constexpr int THREADS = 256;      // = BMAX * UNITS: one cell per thread
constexpr int BMAX = 64;          // batch rows a block holds
constexpr int PART = 4096;        // the partial sums a block keeps
constexpr int MAX_H = 512;        // dW: H / THREADS rows of W per thread

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// as torch.sigmoid computes it on the card: 1 / (1 + exp(-v))
__device__ __forceinline__ float sigm(float v) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
}

// global column of local column lc (gate lc / UNITS of unit j0 + lc % UNITS)
__device__ __forceinline__ int gcol(int lc, int j0, int H) {
  return (lc / UNITS) * H + j0 + lc % UNITS;
}

// src rows [b, H] (row stride ld) -> dst [BMAX][hp], rounded to bf16 when
// `to_bf16`; rows >= b are left as they are (zero)
__device__ inline void stage_rows(float* dst, int hp, const float* src, int b,
                                  int H, int ld, bool to_bf16) {
  const int q = H / 4;
  for (int i = threadIdx.x; i < b * q; i += THREADS) {
    const int r = i / q, k = (i % q) * 4;
    float4 v = __ldcg(reinterpret_cast<const float4*>(src + r * ld + k));
    if (to_bf16) {
      v.x = bf16r(v.x); v.y = bf16r(v.y); v.z = bf16r(v.z); v.w = bf16r(v.w);
    }
    *reinterpret_cast<float4*>(dst + r * hp + k) = v;
  }
}

// w_s [H][GATES * UNITS] = bf16(w) at the block's gate columns; w is
// [H, GATES * H]
template <int GATES>
__device__ __forceinline__ void stage_w_cols(float* w_s, const float* w,
                                             int H, int j0) {
  constexpr int COLS = GATES * UNITS;
  for (int i = threadIdx.x; i < H * COLS; i += THREADS)
    w_s[i] = bf16r(w[(i / COLS) * GATES * H + gcol(i % COLS, j0, H)]);
}

inline bool shape_ok(int L, int b, int H) {
  return L >= 1 && b >= 1 && b <= BMAX && H % 16 == 0 && H >= 16 &&
         H <= MAX_H;
}

// the forward's shared memory: staged rows [BMAX][H + 4], the block's
// columns of W [H][COLS], the partial sums and the gate tile [BMAX][COLS]
template <int GATES>
size_t fwd_smem(int H) {
  constexpr size_t COLS = GATES * UNITS;
  return sizeof(float) *
         ((size_t)BMAX * (H + 4) + (size_t)H * COLS + PART + BMAX * COLS);
}

template <typename Kernel>
int launch(Kernel kernel, int blocks, size_t smem, void** args,
           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // refuses (cudaErrorCooperativeLaunchTooLarge) a grid that cannot be
  // resident all at once
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(THREADS), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace seq

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
