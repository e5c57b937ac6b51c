// conv_bn_train: training-mode NHWC convolution + batch statistics +
// normalize (+ relu), for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/conv_bn.py::conv_bn_train_pallas (kernel
// _conv_bn_train_kernel): z = round_to_input_dtype(conv(x, w)); per channel
// the batch mean and biased variance of z over N*Ho*Wo pixels;
// y = act(z * a + b) with a = scale * rsqrt(var + eps), b = bias - mean * a.
// Returns y (x's dtype) and mean, var (float32 [Cout]); the running-stat
// blend stays at the op layer.
//
// Shapes: x [N, H, W, Cin] NHWC, float32 or bfloat16; wt [kh*kw, Cin, Cout]
// in x's dtype; scale, bias [Cout] float32; y [N, Ho, Wo, Cout]. Taps are
// 1x1 or 3x3 at stride 1 with any padding, or 1x1 at stride 2 unpadded.
//
// Design. The Pallas kernel runs the conv twice to keep z out of device
// memory, a trade made for the TPU's HBM. On the H100 the float32 conv on
// the CUDA cores costs far more than writing z and reading it back (for the
// 1x1 64->256 conv at 56x56, batch 32: ~3.3 GFLOP against ~2 x 103 MB), so z
// is computed once, in three launches:
//   1. conv_stats: the implicit GEMM of conv_tile.cuh; the epilogue stores
//      z (rounded to x's dtype) into y and writes, per block of 64 pixels
//      and per channel, the block mean and the sum of squared deviations
//      from it (two passes over the tile in registers) into part
//      [2, blocks_m, Cout]. No atomics: every run sums in the same order.
//   2. stats_finalize: per channel, Chan's pairwise merge of the block
//      (count, mean, M2) partials in float64, in a fixed order; the biased
//      variance M2 / n is clamped at 0. This is the two-pass variance's
//      accuracy (the reference's Pallas kernel uses E[z^2] - mean^2), and it
//      folds a and b (conv_tile.cuh bn_fold, shared with the backward).
//   3. bn_apply: y = act(z * a + b) in place, in x's dtype.
//
// Bound on the H100: the conv's 2*M*Cout*K operations on the CUDA cores
// (67 TFLOP/s float32) dominate; the z round trip adds ~2 bytes of traffic
// per output byte. No tensor cores yet (wgmma, TMA and pipelining are later
// work).
//
// The C entry returns cudaGetLastError() after the launches; the caller
// allocates every buffer and passes its stream.

#include <algorithm>

#include "conv_tile.cuh"

namespace {

using namespace convtile;

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_stats_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                  T* __restrict__ z, float* __restrict__ part, ConvGeom g) {
  __shared__ TileSmem sm;
  __shared__ float red[16][BN];
  __shared__ float bmean[BN];
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long M = (long long)g.N * g.Ho * g.Wo;
  float acc[4][4];
  conv_mainloop<T>(x, wt, g, m0, n0, sm, acc);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  bool keep[4];
  float zr[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    keep[i] = m < M;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      zr[i][j] = round_to<T>(acc[i][j]);
      if (keep[i] && n < g.Cout) z[m * g.Cout + n] = from_f32<T>(acc[i][j]);
    }
  }
  const float rows = (float)(M - m0 < BM ? M - m0 : BM);
  const float s = tile_channel_sum(zr, keep, red);
  if (threadIdx.x < BN) bmean[threadIdx.x] = __fdiv_rn(s, rows);
  __syncthreads();
  float d2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float d = __fsub_rn(zr[i][j], bmean[tx * 4 + j]);
      d2[i][j] = __fmul_rn(d, d);
    }
  const float q = tile_channel_sum(d2, keep, red);
  const int n = n0 + threadIdx.x;
  if (threadIdx.x < BN && n < g.Cout) {
    const long long blocks_m = gridDim.x;
    part[(long long)blockIdx.x * g.Cout + n] = bmean[threadIdx.x];
    part[(blocks_m + blockIdx.x) * g.Cout + n] = q;
  }
}

// Chan et al.'s merge of (n, mean, M2) with (nb, mb, qb)
__device__ __forceinline__ void chan_merge(double& n, double& mean,
                                           double& m2, double nb, double mb,
                                           double qb) {
  if (nb == 0.0) return;
  if (n == 0.0) {
    n = nb;
    mean = mb;
    m2 = qb;
    return;
  }
  const double t = n + nb;
  const double d = mb - mean;
  mean += d * (nb / t);
  m2 += qb + d * d * (n * nb / t);
  n = t;
}

// one block per 32 channels; lane l of a channel merges blocks l, l+LANES,
// ... in order, then lane 0 merges the lane results in order
__global__ void __launch_bounds__(32 * LANES)
stats_finalize_kernel(const float* __restrict__ part, int blocks_m,
                      long long M, int Cout, const float* __restrict__ scale,
                      const float* __restrict__ bias, float eps,
                      float* __restrict__ stats, float* __restrict__ ab) {
  __shared__ double sn[LANES][32], smean[LANES][32], sm2[LANES][32];
  const int cl = threadIdx.x % 32;
  const int lane = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + cl;
  double n = 0.0, mean = 0.0, m2 = 0.0;
  if (c < Cout) {
    for (int b = lane; b < blocks_m; b += LANES) {
      const long long left = M - (long long)b * BM;
      const double nb = (double)(left < BM ? left : BM);
      chan_merge(n, mean, m2, nb, part[(long long)b * Cout + c],
                 part[((long long)blocks_m + b) * Cout + c]);
    }
  }
  sn[lane][cl] = n;
  smean[lane][cl] = mean;
  sm2[lane][cl] = m2;
  __syncthreads();
  if (lane == 0 && c < Cout) {
    for (int l = 1; l < LANES; ++l)
      chan_merge(n, mean, m2, sn[l][cl], smean[l][cl], sm2[l][cl]);
    const float mf = (float)mean;
    const float vf = fmaxf((float)(m2 / n), 0.f);
    stats[c] = mf;
    stats[Cout + c] = vf;
    const Fold f = bn_fold(scale[c], bias[c], mf, vf, eps);
    ab[c] = f.a;
    ab[Cout + c] = f.b;
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
bn_apply_kernel(T* __restrict__ y, const float* __restrict__ ab,
                long long total, int Cout, int relu) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % Cout);
    float v = affine(to_f32(y[i]), ab[c], ab[Cout + c]);
    if (relu) v = fmaxf(v, 0.f);
    y[i] = from_f32<T>(v);
  }
}

template <typename T>
int launch(const void* x, const void* wt, const float* scale,
           const float* bias, void* y, float* part, float* stats, float* ab,
           const ConvGeom& g, int relu, float eps, cudaStream_t st) {
  const dim3 grid = tile_grid(g);
  const long long M = (long long)g.N * g.Ho * g.Wo;
  conv_stats_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt),
      static_cast<T*>(y), part, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_finalize_kernel<<<(g.Cout + 31) / 32, 32 * LANES, 0, st>>>(
      part, (int)grid.x, M, g.Cout, scale, bias, eps, stats, ab);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = M * g.Cout;
  const long long blocks = std::min((total + 255) / 256, 132LL * 32);
  bn_apply_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(
      static_cast<T*>(y), ab, total, g.Cout, relu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. part is [2, blocks_m, Cout] float32
// scratch (blocks_m = ceil(N*Ho*Wo / 64)), stats [2, Cout] (mean, var) and
// ab [2, Cout] (the folded affine) are float32 outputs. Returns the first
// launch error (0 = success).
int conv_bn_train(const void* x, const void* wt, const float* scale,
                  const float* bias, void* y, float* part, float* stats,
                  float* ab, int dtype, int N, int H, int W, int Cin,
                  int Cout, int kh, int kw, int stride, int ph, int pw,
                  int Ho, int Wo, int relu, float eps, void* stream) {
  const ConvGeom g{N, H, W, Cin, Cout, kh, kw, stride, ph, pw, Ho, Wo};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, wt, scale, bias, y, part, stats, ab, g, relu,
                         eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wt, scale, bias, y, part, stats, ab, g,
                                 relu, eps, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
