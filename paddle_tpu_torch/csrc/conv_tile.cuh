// conv_tile.cuh: the CUDA-core implicit-GEMM conv mainloop of conv_affine.cu
// (serving), and the helpers the conv + batch-norm kernels share
// (conv_affine.cu, conv_bn_train.cu, conv_bn_bwd.cu), for Hopper (sm_90a).
// The training kernels run their GEMMs on conv_mma.cuh's tensor-core loop;
// moving conv_affine onto it is queued.
//
// One block computes a BM x BN tile of the conv output over NHWC x:
// M = N*Ho*Wo output pixels by N = Cout channels, with the K = kh*kw*Cin
// reduction walked tap by tap, BK input channels at a time. Per K step the
// block stages a BK x BM tile of x (gathered straight from the NHWC input:
// padding is a masked load, stride 2 is read in place) and a BK x BN tile of
// the tap's weights through shared memory, and every thread accumulates a
// 4 x 4 sub-tile in float32 registers with fmaf, in one fixed order.
//
// Every kernel allocates nothing: callers pass every buffer and the stream.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace convtile {

constexpr int BM = 64;        // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 16;        // input channels per K step
constexpr int THREADS = 256;  // 16 x 16 threads, each owning a 4 x 4 sub-tile
constexpr int LANES = 32;     // lanes per channel of the cross-block merges

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

struct TileSmem {
  // As is [k][pixel] so the compute loop reads 4 consecutive pixels as one
  // float4; the +4 keeps rows 16-byte aligned and halves store conflicts.
  __align__(16) float As[BK][BM + 4];
  __align__(16) float Bs[BK][BN];
};

// acc[i][j] = sum over taps and input channels of x at the tap's input
// pixel of output pixel m0 + ty*4 + i, times wt[tap][c][n0 + tx*4 + j];
// wt is [kh*kw, Cin, Cout]. Pixels past M and channels past Cout stay 0.
template <typename T>
__device__ __forceinline__ void conv_mainloop(const T* __restrict__ x,
                                              const T* __restrict__ wt,
                                              const ConvGeom& g,
                                              long long m0, int n0,
                                              TileSmem& sm,
                                              float (&acc)[4][4]) {
  const int tid = threadIdx.x;
  const long long M = (long long)g.N * g.Ho * g.Wo;

  // A loader: channel ka of pixels ra + 16*i; consecutive threads read
  // consecutive channels of one pixel
  const int ka = tid % BK;
  const int ra = tid / BK;
  int img[4], ih0[4], iw0[4];
  bool mvalid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ra + 16 * i;
    mvalid[i] = m < M;
    const long long mm = mvalid[i] ? m : 0;
    const int ow = (int)(mm % g.Wo);
    const long long t = mm / g.Wo;
    const int oh = (int)(t % g.Ho);
    img[i] = (int)(t / g.Ho);
    ih0[i] = oh * g.stride - g.ph;
    iw0[i] = ow * g.stride - g.pw;
  }
  // B loader: output channel nb of K rows kb + 4*i (coalesced along Cout)
  const int nb = tid % BN;
  const int kb = tid / BN;
  // compute role: pixels ty*4 .. +3, channels tx*4 .. +3 of the tile
  const int tx = tid % 16;
  const int ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < g.kh * g.kw; ++tap) {
    const int r = tap / g.kw;
    const int s = tap % g.kw;
    long long rowoff[4];
    bool rvalid[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ih = ih0[i] + r;
      const int iw = iw0[i] + s;
      rvalid[i] = mvalid[i] && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
      rowoff[i] =
          rvalid[i] ? (((long long)img[i] * g.H + ih) * g.W + iw) * g.Cin : 0;
    }
    const T* wtap = wt + (long long)tap * g.Cin * g.Cout;
    for (int c0 = 0; c0 < g.Cin; c0 += BK) {
      const int ca = c0 + ka;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sm.As[ka][ra + 16 * i] =
            (rvalid[i] && ca < g.Cin) ? to_f32(x[rowoff[i] + ca]) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = kb + 4 * i;
        const int c = c0 + k;
        const int n = n0 + nb;
        sm.Bs[k][nb] = (c < g.Cin && n < g.Cout)
                           ? to_f32(wtap[(long long)c * g.Cout + n])
                           : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(&sm.As[k][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&sm.Bs[k][tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
}

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

inline dim3 tile_grid(const ConvGeom& g) {
  const long long M = (long long)g.N * g.Ho * g.Wo;
  return dim3((unsigned)((M + BM - 1) / BM), (unsigned)((g.Cout + BN - 1) / BN));
}

}  // namespace convtile

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
