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
// memory, a trade made for the TPU's HBM. On the H100 the two cost about
// the same (for the 1x1 64->256 conv at 56x56, batch 32: a second conv is
// ~3.3 GFLOP, 20 us at the 3xTF32 peak and a few times that at the rate
// mma.sync reaches, and re-reads x; the z round trip is ~2 x 103 MB, ~61 us
// at 3.35 TB/s), so z is computed once, in three launches:
//   1. conv_stats: the implicit GEMM of conv_mma.cuh; the epilogue stores
//      z (rounded to x's dtype) into y and writes, per block of BM pixels
//      (64 or 128, pick_tile) and per channel, the block mean and the sum
//      of squared deviations from it (two passes over the tile in
//      registers) into part [2, blocks_m, Cout]. No atomics: every run sums
//      in the same order.
//   2. stats_finalize: per channel, Chan's pairwise merge of the block
//      (count, mean, M2) partials in float64, in a fixed order; the biased
//      variance M2 / n is clamped at 0. This is the two-pass variance's
//      accuracy (the reference's Pallas kernel uses E[z^2] - mean^2), and it
//      folds a and b (conv_tile.cuh bn_fold, shared with the backward).
//   3. bn_apply: y = act(z * a + b) in place, in x's dtype.
//
// Bound on the H100: the conv's 2*M*Cout*K operations dominate; the z
// round trip adds ~2 bytes of traffic per output byte. They run on the
// tensor cores through conv_mma.cuh's mainloop (3xTF32 mma.sync for
// float32, bf16 mma.sync for bfloat16, a cp.async ring), so the bound is
// the GEMM's operations at the 3xTF32 rate (495 / 3 TFLOP/s) or the bf16
// rate (989), plus the elementwise work at float32's 67 TFLOP/s. wgmma and
// TMA are later work (conv_mma.cuh says why).
//
// The C entry returns cudaGetLastError() after the launches; the caller
// allocates every buffer and passes its stream.

#include <algorithm>
#include <type_traits>

#include "conv_mma.cuh"

namespace {

using convtile::affine;
using convtile::bn_fold;
using convtile::ConvGeom;
using convtile::Fold;
using convtile::from_f32;
using convtile::LANES;
using convtile::relu_of;
using convtile::round_to;
using convtile::to_f32;
using namespace convmma;

// z of the tile into y (x's dtype) and, per channel, the tile's mean and
// its sum of squared deviations from it over the valid rows into part
// [2, blocks_m, Cout]: rows in (mt, half) order, then lanes, then warps.
// SPLIT (the two-image variant's 128-row tile, 4 x 2 warps of 32 rows):
// the tile's two halves are two statistics blocks of 64 rows, each summed
// in the order a 64-row tile (2 warps of 32 rows) sums it, so the partials,
// and the statistics merged from them, are bitwise the default tile's.
template <typename T, class TL, bool SPLIT>
__global__ void __launch_bounds__(TL::THREADS, MIN_BLOCKS)
conv_stats_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                  T* __restrict__ z, float* __restrict__ part, ConvGeom g) {
  constexpr int NB = SPLIT ? 2 : 1;  // statistics blocks in the tile
  constexpr int SB = TL::BM / NB;    // rows of a statistics block
  static_assert(!SPLIT || (TL::BM == 128 && TL::WM == 32),
                "a split tile's warps hold the 64-row tile's warp rows");
  extern __shared__ __align__(16) unsigned char smem[];
  const long long m0 = (long long)blockIdx.x * TL::BM;
  const int n0 = blockIdx.y * TL::BN;
  const long long M = (long long)g.N * g.Ho * g.Wo;
  float acc[TL::MT][TL::NT][4];
  conv_tile<T, TL>(x, wt, g, m0, n0, smem, acc);

  const Frag<TL> f;
  float* red = reinterpret_cast<float*>(smem);  // WARPS_M x BN
  float* bmean = red + TL::WARPS_M * TL::BN;     // NB x BN
  const bool even = g.Cout % 2 == 0;
  float s[TL::NT][2] = {};
#pragma unroll
  for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + f.row(mt, 2 * h);
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < TL::NT; ++nt) {
        const int n = n0 + f.col(nt, 0);
        store_row2<T>(z + m * g.Cout + n, acc[mt][nt][2 * h],
                      acc[mt][nt][2 * h + 1], pair_count(n, g.Cout), even);
        s[nt][0] = __fadd_rn(s[nt][0], round_to<T>(acc[mt][nt][2 * h]));
        s[nt][1] = __fadd_rn(s[nt][1], round_to<T>(acc[mt][nt][2 * h + 1]));
      }
    }
  // this thread's statistics block (threads tid < NB * BN) and its rows
  const int sb = threadIdx.x / TL::BN;
  const long long left = M - m0 - (long long)sb * SB;
  const float rows = (float)(left < SB ? left : SB);
  const float tot = column_sum<TL, NB>(s, f, red);
  if (threadIdx.x < NB * TL::BN)
    bmean[threadIdx.x] = left > 0 ? __fdiv_rn(tot, rows) : 0.f;
  __syncthreads();
  const float* my_mean = bmean + (f.wm0 / SB) * TL::BN;
  float q[TL::NT][2] = {};
#pragma unroll
  for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (m0 + f.row(mt, 2 * h) >= M) continue;
#pragma unroll
      for (int nt = 0; nt < TL::NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float d = __fsub_rn(round_to<T>(acc[mt][nt][2 * h + j]),
                                    my_mean[f.col(nt, j)]);
          q[nt][j] = __fadd_rn(q[nt][j], __fmul_rn(d, d));
        }
    }
  const float m2 = column_sum<TL, NB>(q, f, red);
  const int n = n0 + threadIdx.x % TL::BN;
  if (threadIdx.x < NB * TL::BN && n < g.Cout && left > 0) {
    const long long blocks_m = SPLIT ? (M + SB - 1) / SB : gridDim.x;
    const long long b = (long long)blockIdx.x * NB + sb;
    part[b * g.Cout + n] = bmean[threadIdx.x];
    part[(blocks_m + b) * g.Cout + n] = m2;
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
stats_finalize_kernel(const float* __restrict__ part, int blocks_m, int bm,
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
      const long long left = M - (long long)b * bm;
      const double nb = (double)(left < bm ? left : bm);
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
    const float vq = (float)(m2 / n);
    const float vf = vq < 0.f ? 0.f : vq;  // a NaN stays NaN
    stats[c] = mf;
    stats[Cout + c] = vf;
    const Fold f = bn_fold(scale[c], bias[c], mf, vf, eps);
    ab[c] = f.a;
    ab[Cout + c] = f.b;
  }
}

// y = act(z * a + b) in place; four channels a thread where Cout % 4 == 0
template <typename T>
__global__ void __launch_bounds__(256)
bn_apply_kernel(T* __restrict__ y, const float* __restrict__ ab,
                long long total, int Cout, int relu) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (Cout % 4 == 0) {
    for (long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
         i < total; i += 4 * stride) {
      const int c = (int)(i % Cout);
      float v[4];
      load4(y + i, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] = affine(v[k], ab[c + k], ab[Cout + c + k]);
        if (relu) v[k] = relu_of(v[k]);
      }
      store4(y + i, v);
    }
    return;
  }
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int c = (int)(i % Cout);
    float v = affine(to_f32(y[i]), ab[c], ab[Cout + c]);
    if (relu) v = relu_of(v);
    y[i] = from_f32<T>(v);
  }
}

template <typename T>
int launch(const void* x, const float* w, void* wt, const float* scale,
           const float* bias, void* y, float* part, float* stats, float* ab,
           const ConvGeom& g, int relu, float eps, int tile_arg,
           cudaStream_t st) {
  const long long M = (long long)g.N * g.Ho * g.Wo;
  const bool vec = vec_ok<T>(g.Cin, g.Cout);
  if (tile_arg != 0 && !(tile_arg == 128 && db_ok(M, g.Cout, vec)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e0 =
      launch_taps<T, false>(w, static_cast<T*>(wt), nullptr, g, st);
  if (e0 != cudaSuccess) return (int)e0;
  // the statistics' row blocks are pick_tile's whatever the compute tile
  const TilePick tile = pick_tile(M, g.Cout, vec);
  int blocks_m = 0;
  auto run = [&](auto tl, auto split) -> int {
    using TL = decltype(tl);
    constexpr bool SPLIT = decltype(split)::value;
    constexpr int smem = conv_smem_bytes<TL>();
    const cudaError_t e = allow_smem(conv_stats_kernel<T, TL, SPLIT>, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)((M + TL::BM - 1) / TL::BM),
                    (unsigned)((g.Cout + TL::BN - 1) / TL::BN));
    blocks_m = SPLIT ? (int)((M + 63) / 64) : (int)grid.x;
    conv_stats_kernel<T, TL, SPLIT><<<grid, TL::THREADS, smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(wt),
        static_cast<T*>(y), part, g);
    return (int)cudaGetLastError();
  };
  int err;
  if (tile_arg == 128) {
    err = tile.bn == 128
              ? run(Tile<T, 128, 128, true, true, 4>{}, std::true_type{})
              : run(Tile<T, 128, 64, true, true>{}, std::true_type{});
  } else {
    err = with_tile<T, true>(
        tile, [&](auto tl) -> int { return run(tl, std::false_type{}); });
  }
  if (err != 0) return err;
  stats_finalize_kernel<<<(g.Cout + 31) / 32, 32 * LANES, 0, st>>>(
      part, blocks_m, tile.bm, M, g.Cout, scale, bias, eps, stats, ab);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = M * g.Cout;
  const long long per = g.Cout % 4 == 0 ? 4 : 1;  // elements a thread
  const long long blocks = std::min((total / per + 255) / 256, 132LL * 32);
  bn_apply_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(
      static_cast<T*>(y), ab, total, g.Cout, relu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// sizes[0] = the floats of conv_bn_train's part scratch for this geometry
// (2 x blocks_m x Cout, blocks_m the row blocks of pick_tile's tile).
// Returns 0, or an error for an unknown dtype.
int conv_bn_train_scratch(int dtype, int N, int H, int W, int Cin, int Cout,
                          int kh, int kw, int stride, int ph, int pw, int Ho,
                          int Wo, long long* sizes) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const bool vec = dtype == 0 ? convmma::vec_ok<float>(Cin, Cout)
                              : convmma::vec_ok<__nv_bfloat16>(Cin, Cout);
  sizes[0] = 2 * Cout *
             convmma::conv_blocks_m((long long)N * Ho * Wo, Cout, vec);
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. w is the OIHW float32 filter; wt
// [kh*kw, Cin, Cout] in x's dtype (16-byte aligned) and part (float32,
// conv_bn_train_scratch's size) are scratch; stats [2, Cout] (mean, var)
// and ab [2, Cout] (the folded affine) are float32 outputs. tile: 0 =
// pick_tile's, 128 = the 128-row tile where pick_tile takes 64 (db_ok;
// otherwise an error), whose statistics are bitwise the default's (the
// SPLIT kernel). Returns the first launch error (0 = success).
int conv_bn_train(const void* x, const float* w, void* wt, const float* scale,
                  const float* bias, void* y, float* part, float* stats,
                  float* ab, int dtype, int N, int H, int W, int Cin,
                  int Cout, int kh, int kw, int stride, int ph, int pw,
                  int Ho, int Wo, int relu, float eps, int tile,
                  void* stream) {
  const ConvGeom g{N, H, W, Cin, Cout, kh, kw, stride, ph, pw, Ho, Wo};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, wt, scale, bias, y, part, stats, ab, g, relu,
                         eps, tile, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, wt, scale, bias, y, part, stats, ab,
                                 g, relu, eps, tile, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
