// conv_bn_bwd: the backward of conv_bn_train (conv + batch norm + relu) in
// training mode, for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/conv_bn.py::conv_bn_bwd_pallas (kernel
// _conv_bn_bwd_kernel). From x, w, dy and the saved batch mean/var:
//   z      = round_to_input_dtype(conv(x, w))      (recomputed)
//   dy'    = dy * (z * a + b > 0) under a relu, else dy
//   x^     = (z - mean) * inv,  inv = rsqrt(var + eps), a = scale * inv,
//            b = bias - mean * a
//   dbias  = sum dy',  dscale = sum dy' * x^       (over N*Ho*Wo pixels)
//   dz     = (scale * inv / m) * (m * dy' - dbias - x^ * dscale), rounded to
//            x's dtype
//   dw     = sum over pixels of x_tap^T * dz       (float32, OIHW)
//   dx     = the transposed conv of dz, in x's dtype; a stride-2 1x1 conv
//            writes dz * W^T to the even positions and zeros elsewhere.
//
// Shapes: x [N, H, W, Cin], dy [N, Ho, Wo, Cout] (x's dtype, float32 or
// bfloat16); wt [kh*kw, Cin, Cout] and wrot [kh*kw, Cout, Cin] (tap (r, s)
// of wrot holds w[:, :, kh-1-r, kw-1-s]) in x's dtype; scale, bias, mean,
// var [Cout] float32. Same tap set as conv_bn_train.
//
// Design, in seven launches, each a stage of the reference kernel:
//   1. fold: a, b, inv and scale * inv / m per channel (conv_tile.cuh
//      bn_fold, the function the forward folds with).
//   2. recompute: the implicit GEMM of conv_tile.cuh, the SAME mainloop in
//      the same summation order as the forward, so z, and with it the relu
//      mask, is bitwise the forward's; stores z (x's dtype) and writes
//      per-block per-channel partial sums of dy' and dy' * x^ (no atomics).
//   3. grad_finalize: dbias and dscale, the partials summed in float64 in a
//      fixed order.
//   4. dz: elementwise over the stored z, in place.
//   5. dw_gemm: dw per tap as a GEMM over K = N*Ho*Wo pixels (100 352 at
//      batch 32 for 56x56), split along K into `splits` pixel ranges so
//      enough blocks run; each block writes a float32 partial tile, and
//   6. dw_reduce sums the partials in a fixed order into OIHW dw.
//   7. dx: the same implicit GEMM on dz with the rotated, transposed
//      filter and padding k-1-p (stride 1), or on the 1x1 filter with the
//      epilogue scattering to the even positions (stride 2).
//
// Bound on the H100: three GEMMs of the conv's size (z, dw, dx) on the CUDA
// cores in float32, 6*M*Cout*K operations; the z/dz round trips are small
// beside them. No tensor cores yet.
//
// The C entry returns the first launch error; the caller allocates every
// buffer and passes its stream.

#include <algorithm>

#include "conv_tile.cuh"

namespace {

using namespace convtile;

__global__ void __launch_bounds__(256)
fold_kernel(const float* __restrict__ scale, const float* __restrict__ bias,
            const float* __restrict__ mean, const float* __restrict__ var,
            float eps, float m, int Cout, float* __restrict__ aux) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= Cout) return;
  const Fold f = bn_fold(scale[c], bias[c], mean[c], var[c], eps);
  aux[c] = f.a;
  aux[Cout + c] = f.b;
  aux[2 * Cout + c] = f.inv;
  aux[3 * Cout + c] = __fdiv_rn(__fmul_rn(scale[c], f.inv), m);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
recompute_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                 const T* __restrict__ dy, const float* __restrict__ mean,
                 const float* __restrict__ aux, T* __restrict__ z,
                 float* __restrict__ part, ConvGeom g, int relu) {
  __shared__ TileSmem sm;
  __shared__ float red[16][BN];
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long M = (long long)g.N * g.Ho * g.Wo;
  float acc[4][4];
  conv_mainloop<T>(x, wt, g, m0, n0, sm, acc);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  bool keep[4];
  float dyp[4][4], dyx[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    keep[i] = m < M;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      dyp[i][j] = 0.f;
      dyx[i][j] = 0.f;
      if (!keep[i] || n >= g.Cout) continue;
      const float zr = round_to<T>(acc[i][j]);
      z[m * g.Cout + n] = from_f32<T>(acc[i][j]);
      float d = to_f32(dy[m * g.Cout + n]);
      if (relu && !(affine(zr, aux[n], aux[g.Cout + n]) > 0.f)) d = 0.f;
      const float xh = __fmul_rn(__fsub_rn(zr, mean[n]), aux[2 * g.Cout + n]);
      dyp[i][j] = d;
      dyx[i][j] = __fmul_rn(d, xh);
    }
  }
  const float s = tile_channel_sum(dyp, keep, red);
  const float q = tile_channel_sum(dyx, keep, red);
  const int n = n0 + threadIdx.x;
  if (threadIdx.x < BN && n < g.Cout) {
    const long long blocks_m = gridDim.x;
    part[(long long)blockIdx.x * g.Cout + n] = s;
    part[(blocks_m + blockIdx.x) * g.Cout + n] = q;
  }
}

// one block per 32 channels; lane l sums blocks l, l+LANES, ... in order,
// then lane 0 sums the lane results in order. grads = [dscale, dbias].
__global__ void __launch_bounds__(32 * LANES)
grad_finalize_kernel(const float* __restrict__ part, int blocks_m, int Cout,
                     float* __restrict__ grads) {
  __shared__ double ss[LANES][32], sq[LANES][32];
  const int cl = threadIdx.x % 32;
  const int lane = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + cl;
  double s = 0.0, q = 0.0;
  if (c < Cout) {
    for (int b = lane; b < blocks_m; b += LANES) {
      s += part[(long long)b * Cout + c];
      q += part[((long long)blocks_m + b) * Cout + c];
    }
  }
  ss[lane][cl] = s;
  sq[lane][cl] = q;
  __syncthreads();
  if (lane == 0 && c < Cout) {
    for (int l = 1; l < LANES; ++l) {
      s += ss[l][cl];
      q += sq[l][cl];
    }
    grads[c] = (float)q;
    grads[Cout + c] = (float)s;
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
dz_kernel(T* __restrict__ z, const T* __restrict__ dy,
          const float* __restrict__ mean, const float* __restrict__ aux,
          const float* __restrict__ grads, long long total, int Cout,
          float m, int relu) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % Cout);
    const float zr = to_f32(z[i]);
    float d = to_f32(dy[i]);
    if (relu && !(affine(zr, aux[c], aux[Cout + c]) > 0.f)) d = 0.f;
    const float xh = __fmul_rn(__fsub_rn(zr, mean[c]), aux[2 * Cout + c]);
    const float u = __fsub_rn(__fsub_rn(__fmul_rn(m, d), grads[Cout + c]),
                              __fmul_rn(xh, grads[c]));
    z[i] = from_f32<T>(__fmul_rn(aux[3 * Cout + c], u));
  }
}

// dw_part[split][tap][ci][co] = sum over the split's pixels m of
// x_tap[m, ci] * dz[m, co]; a 64 (ci) x 64 (co) tile per block
template <typename T>
__global__ void __launch_bounds__(THREADS)
dw_gemm_kernel(const T* __restrict__ x, const T* __restrict__ dz,
               float* __restrict__ dw_part, ConvGeom g, int splits,
               long long k_per_split) {
  __shared__ TileSmem sm;  // As[pixel][ci], Bs[pixel][co]
  const int ci0 = blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;
  const int tap = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int r = tap / g.kw;
  const int s = tap % g.kw;
  const long long M = (long long)g.N * g.Ho * g.Wo;
  const long long kbeg = (long long)split * k_per_split;
  const long long kend = kbeg + k_per_split < M ? kbeg + k_per_split : M;

  __shared__ int row[BK];   // the K step's input pixels, -1 where padding
  const int tid = threadIdx.x;
  const int lc = tid % 64;  // loader: channel within the tile
  const int lk = tid / 64;  // loader: pixel rows lk + 4*i
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long k0 = kbeg; k0 < kend; k0 += BK) {
    // one thread per pixel of the step decodes it (32-bit: the wrapper
    // keeps N*H*W and N*Ho*Wo below 2^31)
    if (tid < BK) {
      const int m = (int)(k0 + tid);
      int r_in = -1;
      if (m < kend) {
        const int ow = m % g.Wo;
        const int t = m / g.Wo;
        const int ih = (t % g.Ho) * g.stride - g.ph + r;
        const int iw = ow * g.stride - g.pw + s;
        if (ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
          r_in = ((t / g.Ho) * g.H + ih) * g.W + iw;
      }
      row[tid] = r_in;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = lk + 4 * i;
      const long long m = k0 + k;
      const int ci = ci0 + lc;
      const int co = co0 + lc;
      sm.As[k][lc] = (row[k] >= 0 && ci < g.Cin)
                         ? to_f32(x[(long long)row[k] * g.Cin + ci])
                         : 0.f;
      sm.Bs[k][lc] = (m < kend && co < g.Cout)
                         ? to_f32(dz[m * g.Cout + co])
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
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
  const int taps = g.kh * g.kw;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = ci0 + ty * 4 + i;
    if (ci >= g.Cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx * 4 + j;
      if (co >= g.Cout) continue;
      dw_part[(((long long)split * taps + tap) * g.Cin + ci) * g.Cout + co] =
          acc[i][j];
    }
  }
}

// dw[co][ci][r][s] = sum over splits, in order, of dw_part[.][tap][ci][co]
__global__ void __launch_bounds__(256)
dw_reduce_kernel(const float* __restrict__ dw_part, float* __restrict__ dw,
                 int splits, int kh, int kw, int Cin, int Cout) {
  const long long total = (long long)kh * kw * Cin * Cout;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int sp = 0; sp < splits; ++sp)
      sum = __fadd_rn(sum, dw_part[sp * total + i]);
    const int co = (int)(i % Cout);
    const long long t = i / Cout;
    const int ci = (int)(t % Cin);
    const int tap = (int)(t / Cin);
    dw[(((long long)co * Cin + ci) * kh + tap / kw) * kw + tap % kw] = sum;
  }
}

// dx from dz through the mainloop (gd: dz as the input, wrot as the filter)
template <typename T>
__global__ void __launch_bounds__(THREADS)
dx_kernel(const T* __restrict__ dz, const T* __restrict__ wrot,
          T* __restrict__ dx, ConvGeom gd, int H, int W, int stride2) {
  __shared__ TileSmem sm;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long M = (long long)gd.N * gd.Ho * gd.Wo;
  float acc[4][4];
  conv_mainloop<T>(dz, wrot, gd, m0, n0, sm, acc);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int C = gd.Cout;  // the forward's Cin
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
    long long base = m * C;
    bool right = false, down = false;
    if (stride2) {
      const int ow = (int)(m % gd.Wo);
      const long long t = m / gd.Wo;
      const int oh = (int)(t % gd.Ho);
      const long long img = t / gd.Ho;
      base = ((img * H + 2 * oh) * W + 2 * ow) * C;
      right = 2 * ow + 1 < W;
      down = 2 * oh + 1 < H;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= C) continue;
      dx[base + n] = from_f32<T>(acc[i][j]);
      if (right) dx[base + C + n] = from_f32<T>(0.f);
      if (down) dx[base + (long long)W * C + n] = from_f32<T>(0.f);
      if (right && down) dx[base + (long long)W * C + C + n] = from_f32<T>(0.f);
    }
  }
}

int grid_1d(long long total) {
  return (int)std::min((total + 255) / 256, 132LL * 32);
}

template <typename T>
int launch(const void* x, const void* wt, const void* wrot, const void* dy,
           const float* scale, const float* bias, const float* mean,
           const float* var, void* zbuf, float* aux, float* part,
           float* grads, float* dw_part, float* dw, void* dx,
           const ConvGeom& g, int relu, float eps, int splits,
           cudaStream_t st) {
  const long long M = (long long)g.N * g.Ho * g.Wo;
  const float mf = (float)M;
  const T* xt = static_cast<const T*>(x);
  T* z = static_cast<T*>(zbuf);
  cudaError_t err;
#define CHECK_LAUNCH()                          \
  err = cudaGetLastError();                     \
  if (err != cudaSuccess) return (int)err;

  fold_kernel<<<(g.Cout + 255) / 256, 256, 0, st>>>(scale, bias, mean, var,
                                                    eps, mf, g.Cout, aux);
  CHECK_LAUNCH();
  const dim3 grid = tile_grid(g);
  recompute_kernel<T><<<grid, THREADS, 0, st>>>(
      xt, static_cast<const T*>(wt), static_cast<const T*>(dy), mean, aux, z,
      part, g, relu);
  CHECK_LAUNCH();
  grad_finalize_kernel<<<(g.Cout + 31) / 32, 32 * LANES, 0, st>>>(
      part, (int)grid.x, g.Cout, grads);
  CHECK_LAUNCH();
  const long long total = M * g.Cout;
  dz_kernel<T><<<grid_1d(total), 256, 0, st>>>(
      z, static_cast<const T*>(dy), mean, aux, grads, total, g.Cout, mf,
      relu);
  CHECK_LAUNCH();
  const long long per = (M + splits - 1) / splits;
  const long long k_per_split = (per + BK - 1) / BK * BK;
  const dim3 wgrid((unsigned)((g.Cin + BM - 1) / BM),
                   (unsigned)((g.Cout + BN - 1) / BN),
                   (unsigned)(g.kh * g.kw * splits));
  dw_gemm_kernel<T><<<wgrid, THREADS, 0, st>>>(xt, z, dw_part, g, splits,
                                               k_per_split);
  CHECK_LAUNCH();
  dw_reduce_kernel<<<grid_1d((long long)g.kh * g.kw * g.Cin * g.Cout), 256,
                     0, st>>>(dw_part, dw, splits, g.kh, g.kw, g.Cin,
                              g.Cout);
  CHECK_LAUNCH();
  const int stride2 = g.stride == 2;
  // dz is the input ([N, Ho, Wo, Cout]) and the forward's Cin the output
  // channels; stride 1 pads by k-1-p and gives H x W, stride 2 (1x1,
  // unpadded) gives Ho x Wo, which the epilogue scatters
  const ConvGeom gd{g.N,
                    g.Ho,
                    g.Wo,
                    g.Cout,
                    g.Cin,
                    g.kh,
                    g.kw,
                    1,
                    stride2 ? 0 : g.kh - 1 - g.ph,
                    stride2 ? 0 : g.kw - 1 - g.pw,
                    stride2 ? g.Ho : g.H,
                    stride2 ? g.Wo : g.W};
  dx_kernel<T><<<tile_grid(gd), THREADS, 0, st>>>(
      z, static_cast<const T*>(wrot), static_cast<T*>(dx), gd, g.H, g.W,
      stride2);
  CHECK_LAUNCH();
#undef CHECK_LAUNCH
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Scratch: zbuf [N*Ho*Wo, Cout] in x's
// dtype, aux [4, Cout], part [2, blocks_m, Cout] (blocks_m =
// ceil(N*Ho*Wo / 64)), dw_part [splits, kh*kw, Cin, Cout], all float32
// except zbuf. Outputs: grads [2, Cout] = (dscale, dbias), dw [Cout, Cin,
// kh, kw] float32, dx [N, H, W, Cin] in x's dtype. Returns the first launch
// error (0 = success).
int conv_bn_bwd(const void* x, const void* wt, const void* wrot,
                const void* dy, const float* scale, const float* bias,
                const float* mean, const float* var, void* zbuf, float* aux,
                float* part, float* grads, float* dw_part, float* dw,
                void* dx, int dtype, int N, int H, int W, int Cin, int Cout,
                int kh, int kw, int stride, int ph, int pw, int Ho, int Wo,
                int relu, float eps, int splits, void* stream) {
  const ConvGeom g{N, H, W, Cin, Cout, kh, kw, stride, ph, pw, Ho, Wo};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, wt, wrot, dy, scale, bias, mean, var, zbuf, aux,
                         part, grads, dw_part, dw, dx, g, relu, eps, splits,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wt, wrot, dy, scale, bias, mean, var,
                                 zbuf, aux, part, grads, dw_part, dw, dx, g,
                                 relu, eps, splits, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
