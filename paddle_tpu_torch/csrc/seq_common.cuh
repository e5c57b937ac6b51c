// seq_common: what the whole-sequence recurrent kernels (lstm_seq.cu,
// gru_seq.cu) share: their cooperative grid (one block per 4 hidden units,
// all resident at once), the bf16 rounding and sigmoid they compute with,
// their shape limits and the cooperative launch. Each .cu includes it into
// its own library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>

namespace seq {

constexpr int UNITS = 4;          // hidden units per block
constexpr int THREADS = 256;      // one cell (unit, batch row) a thread
constexpr int BMAX = 64;          // batch rows the grid holds
constexpr int MAX_H = 512;        // H / 4 blocks, one an SM

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// as torch.sigmoid computes it on the card: 1 / (1 + exp(-v))
__device__ __forceinline__ float sigm(float v) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
}

inline bool shape_ok(int L, int b, int H) {
  return L >= 1 && b >= 1 && b <= BMAX && H % 16 == 0 && H >= 16 &&
         H <= MAX_H;
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
