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
//   2. recompute: the implicit GEMM of conv_mma.cuh, the SAME mainloop and
//      tile (pick_tile of the conv's geometry) as the forward, so z, and
//      with it the relu mask, is bitwise the forward's; stores z (x's
//      dtype) and writes per-block per-channel partial sums of dy' and
//      dy' * x^ (no atomics).
//   3. grad_finalize: dbias and dscale, the partials summed in float64 in a
//      fixed order.
//   4. dz: elementwise over the stored z, in place.
//   5. dw_gemm: dw per tap as a GEMM over K = N*Ho*Wo pixels (100 352 at
//      batch 32 for 56x56) on the same mainloop (A = x at the tap,
//      M-contiguous; B = dz), split along K into pixel ranges (dw_splits:
//      two blocks an SM) so enough blocks run; each block writes a float32
//      partial tile, and
//   6. dw_reduce sums the partials in a fixed order into OIHW dw.
//   7. dx: the same implicit GEMM on dz with the rotated, transposed
//      filter and padding k-1-p (stride 1), or on the 1x1 filter with the
//      epilogue scattering to the even positions (stride 2).
//
// Bound on the H100: three GEMMs of the conv's size (z, dw, dx),
// 6*M*Cout*K operations, on the tensor cores (3xTF32 mma.sync for float32,
// bf16 mma.sync for bfloat16; conv_mma.cuh), plus ~12 elementwise
// operations per output element on the CUDA cores; the z/dz round trips
// are small beside them.
//
// The C entry returns the first launch error; the caller allocates every
// buffer and passes its stream.

#include <algorithm>

#include "conv_mma.cuh"

namespace {

using convtile::affine;
using convtile::bn_fold;
using convtile::ConvGeom;
using convtile::Fold;
using convtile::from_f32;
using convtile::LANES;
using convtile::round_to;
using convtile::to_f32;
using namespace convmma;

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

// z of the tile into z (x's dtype) and, per channel, the tile's sums of
// dy' and dy' * x^ over its valid rows into part [2, blocks_m, Cout]
template <typename T, class TL>
__global__ void __launch_bounds__(TL::THREADS, MIN_BLOCKS)
recompute_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                 const T* __restrict__ dy, const float* __restrict__ mean,
                 const float* __restrict__ aux, T* __restrict__ z,
                 float* __restrict__ part, ConvGeom g, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long m0 = (long long)blockIdx.x * TL::BM;
  const int n0 = blockIdx.y * TL::BN;
  const long long M = (long long)g.N * g.Ho * g.Wo;
  float acc[TL::MT][TL::NT][4];
  conv_tile<T, TL>(x, wt, g, m0, n0, smem, acc);

  const Frag<TL> f;
  float* red = reinterpret_cast<float*>(smem);  // WARPS_M x BN
  const bool even = g.Cout % 2 == 0;
  float s[TL::NT][2] = {}, q[TL::NT][2] = {};
#pragma unroll
  for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + f.row(mt, 2 * h);
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < TL::NT; ++nt) {
        const int n = n0 + f.col(nt, 0);
        const int cnt = pair_count(n, g.Cout);
        store_row2<T>(z + m * g.Cout + n, acc[mt][nt][2 * h],
                      acc[mt][nt][2 * h + 1], cnt, even);
        float d[2];
        load_row2<T>(dy + m * g.Cout + n, cnt, even, d[0], d[1]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (j >= cnt) continue;
          const int c = n + j;
          const float zr = round_to<T>(acc[mt][nt][2 * h + j]);
          if (relu && !(affine(zr, aux[c], aux[g.Cout + c]) > 0.f)) d[j] = 0.f;
          const float xh =
              __fmul_rn(__fsub_rn(zr, mean[c]), aux[2 * g.Cout + c]);
          s[nt][j] = __fadd_rn(s[nt][j], d[j]);
          q[nt][j] = __fadd_rn(q[nt][j], __fmul_rn(d[j], xh));
        }
      }
    }
  const float ts = column_sum<TL>(s, f, red);
  const float tq = column_sum<TL>(q, f, red);
  const int n = n0 + threadIdx.x;
  if (threadIdx.x < TL::BN && n < g.Cout) {
    const long long blocks_m = gridDim.x;
    part[(long long)blockIdx.x * g.Cout + n] = ts;
    part[(blocks_m + blockIdx.x) * g.Cout + n] = tq;
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

// dz in place of z; four channels a thread where Cout % 4 == 0
__device__ __forceinline__ float dz_of(float zr, float d, int c,
                                      const float* __restrict__ mean,
                                      const float* __restrict__ aux,
                                      const float* __restrict__ grads,
                                      int Cout, float m, int relu) {
  if (relu && !(affine(zr, aux[c], aux[Cout + c]) > 0.f)) d = 0.f;
  const float xh = __fmul_rn(__fsub_rn(zr, mean[c]), aux[2 * Cout + c]);
  const float u = __fsub_rn(__fsub_rn(__fmul_rn(m, d), grads[Cout + c]),
                            __fmul_rn(xh, grads[c]));
  return __fmul_rn(aux[3 * Cout + c], u);
}

template <typename T>
__global__ void __launch_bounds__(256)
dz_kernel(T* __restrict__ z, const T* __restrict__ dy,
          const float* __restrict__ mean, const float* __restrict__ aux,
          const float* __restrict__ grads, long long total, int Cout,
          float m, int relu) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (Cout % 4 == 0) {
    for (long long i = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
         i < total; i += 4 * stride) {
      const int c = (int)(i % Cout);
      float zv[4], dv[4];
      load4(z + i, zv);
      load4(dy + i, dv);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        zv[k] = dz_of(zv[k], dv[k], c + k, mean, aux, grads, Cout, m, relu);
      store4(z + i, zv);
    }
    return;
  }
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int c = (int)(i % Cout);
    z[i] = from_f32<T>(dz_of(to_f32(z[i]), to_f32(dy[i]), c, mean, aux,
                                grads, Cout, m, relu));
  }
}

// dw_part[split][tap][ci][co] = sum over the split's pixels m of
// x_tap[m, ci] * dz[m, co]; a BM (ci) x BN (co) tile per block
template <typename T, class TL>
__global__ void __launch_bounds__(TL::THREADS, MIN_BLOCKS)
dw_gemm_kernel(const T* __restrict__ x, const T* __restrict__ dz,
               float* __restrict__ dw_part, ConvGeom g, int splits,
               long long k_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ci0 = blockIdx.x * TL::BM;
  const int co0 = blockIdx.y * TL::BN;
  const int tap = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const long long M = (long long)g.N * g.Ho * g.Wo;
  const long long kbeg = (long long)split * k_per_split;
  const long long kend = kbeg + k_per_split < M ? kbeg + k_per_split : M;
  float acc[TL::MT][TL::NT][4];
  dw_tile<T, TL>(x, dz, g, tap / g.kw, tap % g.kw, kbeg, kend, ci0, co0,
                 smem, acc);

  const Frag<TL> f;
  const bool even = g.Cout % 2 == 0;
  float* out =
      dw_part + ((long long)split * g.kh * g.kw + tap) * g.Cin * g.Cout;
#pragma unroll
  for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = ci0 + f.row(mt, 2 * h);
      if (ci >= g.Cin) continue;
#pragma unroll
      for (int nt = 0; nt < TL::NT; ++nt) {
        const int co = co0 + f.col(nt, 0);
        store_row2<float>(out + (long long)ci * g.Cout + co,
                          acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1],
                          pair_count(co, g.Cout), even);
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
template <typename T, class TL>
__global__ void __launch_bounds__(TL::THREADS, MIN_BLOCKS)
dx_kernel(const T* __restrict__ dz, const T* __restrict__ wrot,
          T* __restrict__ dx, ConvGeom gd, int H, int W, int stride2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long m0 = (long long)blockIdx.x * TL::BM;
  const int n0 = blockIdx.y * TL::BN;
  const long long M = (long long)gd.N * gd.Ho * gd.Wo;
  float acc[TL::MT][TL::NT][4];
  conv_tile<T, TL>(dz, wrot, gd, m0, n0, smem, acc);

  const Frag<TL> f;
  const int C = gd.Cout;  // the forward's Cin
  const bool even = C % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + f.row(mt, 2 * h);
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
      for (int nt = 0; nt < TL::NT; ++nt) {
        const int n = n0 + f.col(nt, 0);
        const int cnt = pair_count(n, C);
        store_row2<T>(dx + base + n, acc[mt][nt][2 * h],
                      acc[mt][nt][2 * h + 1], cnt, even);
        if (right) store_row2<T>(dx + base + C + n, 0.f, 0.f, cnt, even);
        if (down)
          store_row2<T>(dx + base + (long long)W * C + n, 0.f, 0.f, cnt, even);
        if (right && down)
          store_row2<T>(dx + base + (long long)W * C + C + n, 0.f, 0.f, cnt,
                        even);
      }
    }
}

int grid_1d(long long total) {
  return (int)std::min((total + 255) / 256, 132LL * 32);
}

template <typename T>
int launch(const void* x, const float* w, void* wt, void* wrot,
           const void* dy, const float* scale, const float* bias,
           const float* mean, const float* var, void* zbuf, float* aux,
           float* part, float* grads, float* dw_part, float* dw, void* dx,
           const ConvGeom& g, int relu, float eps, int sms,
           cudaStream_t st) {
  const long long M = (long long)g.N * g.Ho * g.Wo;
  const float mf = (float)M;
  const T* xt = static_cast<const T*>(x);
  T* z = static_cast<T*>(zbuf);
  const bool vec = vec_ok<T>(g.Cin, g.Cout);
  cudaError_t err;
  int ierr;
#define CHECK_LAUNCH()                          \
  err = cudaGetLastError();                     \
  if (err != cudaSuccess) return (int)err;

  err = launch_taps<T, true>(w, static_cast<T*>(wt), static_cast<T*>(wrot), g,
                             st);
  if (err != cudaSuccess) return (int)err;
  fold_kernel<<<(g.Cout + 255) / 256, 256, 0, st>>>(scale, bias, mean, var,
                                                    eps, mf, g.Cout, aux);
  CHECK_LAUNCH();
  int blocks_m = 0;
  ierr = with_tile<T, true>(pick_tile(M, g.Cout, vec), [&](auto tl) -> int {
    using TL = decltype(tl);
    constexpr int smem = conv_smem_bytes<TL>();
    const cudaError_t e = allow_smem(recompute_kernel<T, TL>, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)((M + TL::BM - 1) / TL::BM),
                    (unsigned)((g.Cout + TL::BN - 1) / TL::BN));
    blocks_m = (int)grid.x;
    recompute_kernel<T, TL><<<grid, TL::THREADS, smem, st>>>(
        xt, static_cast<const T*>(wt), static_cast<const T*>(dy), mean, aux,
        z, part, g, relu);
    return (int)cudaGetLastError();
  });
  if (ierr != 0) return ierr;
  grad_finalize_kernel<<<(g.Cout + 31) / 32, 32 * LANES, 0, st>>>(
      part, blocks_m, g.Cout, grads);
  CHECK_LAUNCH();
  const long long total = M * g.Cout;
  dz_kernel<T><<<grid_1d(g.Cout % 4 == 0 ? total / 4 : total), 256, 0,
                 st>>>(
      z, static_cast<const T*>(dy), mean, aux, grads, total, g.Cout, mf,
      relu);
  CHECK_LAUNCH();
  const int splits = dw_splits(g, vec, sms);
  const long long per = (M + splits - 1) / splits;
  const long long k_per_split = (per + BK - 1) / BK * BK;
  const TilePick dw_pick = pick_dw_tile(g.Cin, g.Cout, vec);
  ierr = with_tile<T, false>(dw_pick, [&](auto tl) -> int {
    using TL = decltype(tl);
    constexpr int smem = TL::RING_BYTES;
    const cudaError_t e = allow_smem(dw_gemm_kernel<T, TL>, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)((g.Cin + TL::BM - 1) / TL::BM),
                    (unsigned)((g.Cout + TL::BN - 1) / TL::BN),
                    (unsigned)(g.kh * g.kw * splits));
    dw_gemm_kernel<T, TL><<<grid, TL::THREADS, smem, st>>>(xt, z, dw_part, g,
                                                       splits, k_per_split);
    return (int)cudaGetLastError();
  });
  if (ierr != 0) return ierr;
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
  const long long Md = (long long)gd.N * gd.Ho * gd.Wo;
  ierr = with_tile<T, true>(pick_tile(Md, gd.Cout, vec), [&](auto tl) -> int {
    using TL = decltype(tl);
    constexpr int smem = conv_smem_bytes<TL>();
    const cudaError_t e = allow_smem(dx_kernel<T, TL>, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)((Md + TL::BM - 1) / TL::BM),
                    (unsigned)((gd.Cout + TL::BN - 1) / TL::BN));
    dx_kernel<T, TL><<<grid, TL::THREADS, smem, st>>>(
        z, static_cast<const T*>(wrot), static_cast<T*>(dx), gd, g.H, g.W,
        stride2);
    return (int)cudaGetLastError();
  });
  if (ierr != 0) return ierr;
#undef CHECK_LAUNCH
  return 0;
}

}  // namespace

extern "C" {

// sizes[0], sizes[1] = the floats of conv_bn_bwd's part and dw_part
// scratch for this geometry on a card of `sms` SMs: 2 x blocks_m x Cout
// (blocks_m the row blocks of pick_tile's tile) and splits x kh*kw x Cin x
// Cout (dw_splits). Returns 0, or an error for a bad argument.
int conv_bn_bwd_scratch(int dtype, int N, int H, int W, int Cin, int Cout,
                        int kh, int kw, int stride, int ph, int pw, int Ho,
                        int Wo, int sms, long long* sizes) {
  if ((dtype != 0 && dtype != 1) || sms < 1)
    return (int)cudaErrorInvalidValue;
  const ConvGeom g{N, H, W, Cin, Cout, kh, kw, stride, ph, pw, Ho, Wo};
  const bool vec = dtype == 0 ? convmma::vec_ok<float>(Cin, Cout)
                              : convmma::vec_ok<__nv_bfloat16>(Cin, Cout);
  sizes[0] = 2 * Cout *
             convmma::conv_blocks_m((long long)N * Ho * Wo, Cout, vec);
  sizes[1] =
      (long long)convmma::dw_splits(g, vec, sms) * kh * kw * Cin * Cout;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. w is the OIHW float32 filter; sms is
// the card's SM count. Scratch: wt [kh*kw, Cin, Cout], wrot [kh*kw, Cout,
// Cin] and zbuf [N*Ho*Wo, Cout] in x's dtype (each 16-byte aligned), aux
// [4, Cout], part and dw_part float32 (conv_bn_bwd_scratch's sizes for the
// same geometry and sms).
// Outputs: grads [2, Cout] = (dscale, dbias), dw [Cout, Cin, kh, kw]
// float32, dx [N, H, W, Cin] in x's dtype. Returns the first launch error
// (0 = success).
int conv_bn_bwd(const void* x, const float* w, void* wt, void* wrot,
                const void* dy, const float* scale, const float* bias,
                const float* mean, const float* var, void* zbuf, float* aux,
                float* part, float* grads, float* dw_part, float* dw,
                void* dx, int dtype, int N, int H, int W, int Cin, int Cout,
                int kh, int kw, int stride, int ph, int pw, int Ho, int Wo,
                int relu, float eps, int sms, void* stream) {
  const ConvGeom g{N, H, W, Cin, Cout, kh, kw, stride, ph, pw, Ho, Wo};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sms < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, w, wt, wrot, dy, scale, bias, mean, var, zbuf,
                         aux, part, grads, dw_part, dw, dx, g, relu, eps,
                         sms, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, wt, wrot, dy, scale, bias, mean, var,
                                 zbuf, aux, part, grads, dw_part, dw, dx, g,
                                 relu, eps, sms, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
