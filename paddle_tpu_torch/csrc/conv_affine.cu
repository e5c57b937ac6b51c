// conv_affine: NHWC convolution + per-channel affine (+ relu), the folded
// batch-norm inference epilogue, for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/conv_bn.py::conv_affine_pallas (kernel
// _conv_affine_kernel): y = act(round_to_input_dtype(conv(x, w)) * a + b),
// a = scale * rsqrt(var + eps) and b = bias - mean * a folded by the caller.
//
// Shapes: x [N, H, W, Cin] NHWC, float32 or bfloat16; w the OIHW float32
// filter, laid out per tap as wt [kh*kw, Cin, Cout] in x's dtype inside the
// C entry (conv_mma.cuh taps_kernel); a, b [Cout] float32; y [N, Ho, Wo,
// Cout] in x's dtype. Taps are 1x1 or 3x3 at stride 1 with any padding, or
// 1x1 at stride 2 with no padding.
//
// Design: the implicit GEMM of conv_mma.cuh (3xTF32 mma.sync for float32,
// bf16 mma.sync for bfloat16, a cp.async ring, the tile pick_tile chooses
// from the geometry), then one pass over the accumulator fragments: round
// the sum to x's dtype, z * a + b in float32 (explicit round-to-nearest
// ops, so the compiler does not contract them into an FMA the plain
// version does not do), the relu (NaN-keeping, relu_of), and a store in
// x's dtype, two channels at a time; a and b of the block's columns are
// staged once in shared memory. The conv output never goes to device
// memory before the affine.
//
// Infinities. 3xTF32 splits an infinite operand into hi = Inf and lo =
// NaN, so every sum an infinity reaches comes out NaN from the tensor
// cores, where the plain version's float32 sum gives +-Inf (and NaN only
// for Inf - Inf, Inf * 0 or a NaN operand). In float32 a block whose tile
// holds a NaN after the epilogue therefore sums each such element again,
// one product at a time in K order (direct_sum, which stops at the first
// NaN), and stores that instead. Finite tiles pay one test per element;
// bfloat16's products are exact and carry an infinity as the plain
// version's do.
//
// Determinism: a block sums its whole K walk in one fixed order, with no
// atomics, so two calls on one card are bitwise equal. K is not split
// where the grid is small (the serving buckets 1-8 give 4-52 blocks for
// 132 SMs on most layers): a split into float32 partials and a second
// kernel that adds them cut the device time of a batch-1 forward 2.5x
// on an H100 but made no request faster (batch 1 and 8 slower), because
// the host, not the device, sets the latency there and the extra launch
// is host time (PERF.md section 6).
//
// Bound on the H100: the conv's 2*M*Cout*K operations, run on the tensor
// cores, at the 3xTF32 rate (495 / 3 TFLOP/s) for float32 or the bf16 rate
// (989), plus the epilogue's few operations per output element at 67 on
// the CUDA cores; x, the filter and y move far fewer bytes than that takes
// at 3.35 TB/s. wgmma and TMA are later work (conv_mma.cuh says why).
//
// The C entry returns the first launch error; the caller allocates every
// buffer and passes its stream. The kernels allocate nothing.

#include "conv_mma.cuh"

namespace {

using convtile::affine;
using convtile::ConvGeom;
using convtile::from_f32;
using convtile::relu_of;
using convtile::round_to;
using namespace convmma;

// y of one accumulated sum: act(round_to<T>(acc) * a + b)
template <typename T>
__device__ __forceinline__ float epilogue(float acc, float a, float b,
                                          int relu) {
  const float v = affine(round_to<T>(acc), a, b);
  return relu ? relu_of(v) : v;
}

// The conv sum of output element (m, n) one product at a time in K order
// (taps, then channels), each padded tap's zero times the filter as the
// plain version's padded input gives; stops at the first NaN. Only where
// the tensor cores gave NaN (see the header): a rare, slow path.
template <typename T>
__device__ float direct_sum(const T* __restrict__ x, const T* __restrict__ wt,
                            const ConvGeom& g, long long m, int n) {
  const int wo = (int)(m % g.Wo);
  const long long q = m / g.Wo;
  const int ho = (int)(q % g.Ho);
  const long long img = q / g.Ho;
  float s = 0.f;
  for (int i = 0; i < g.kh; ++i)
    for (int j = 0; j < g.kw; ++j) {
      const int hi = ho * g.stride - g.ph + i, wi = wo * g.stride - g.pw + j;
      const bool in = hi >= 0 && hi < g.H && wi >= 0 && wi < g.W;
      const long long xr = ((img * g.H + hi) * g.W + wi) * g.Cin;
      const long long wr = (long long)(i * g.kw + j) * g.Cin * g.Cout + n;
      for (int c = 0; c < g.Cin; ++c) {
        const float xv = in ? convtile::to_f32(x[xr + c]) : 0.f;
        s = __fadd_rn(s, __fmul_rn(xv, convtile::to_f32(
                                           wt[wr + (long long)c * g.Cout])));
        if (isnan(s)) return s;
      }
    }
  return s;
}

// float32 needs direct_sum where the tensor cores gave NaN (the header)
template <typename T>
constexpr bool REDO_NAN = sizeof(T) == 4;

// y of the tile: the conv, then the epilogue (see the header)
template <typename T, class TL>
__global__ void __launch_bounds__(TL::THREADS, MIN_BLOCKS)
conv_affine_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                   const float* __restrict__ a, const float* __restrict__ b,
                   T* __restrict__ y, ConvGeom g, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long m0 = (long long)blockIdx.x * TL::BM;
  const int n0 = blockIdx.y * TL::BN;
  const long long M = (long long)g.N * g.Ho * g.Wo;
  float acc[TL::MT][TL::NT][4];
  conv_tile<T, TL>(x, wt, g, m0, n0, smem, acc);

  // the ring is free once conv_tile returns: a, b of the block's columns
  float* sa = reinterpret_cast<float*>(smem);
  float* sb = sa + TL::BN;
  if (threadIdx.x < TL::BN) {
    const int n = n0 + threadIdx.x;
    sa[threadIdx.x] = n < g.Cout ? a[n] : 0.f;
    sb[threadIdx.x] = n < g.Cout ? b[n] : 0.f;
  }
  __syncthreads();
  const Frag<TL> f;
  const bool even = g.Cout % 2 == 0;
  bool seen_nan = false;
#pragma unroll
  for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + f.row(mt, 2 * h);
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < TL::NT; ++nt) {
        const int c = f.col(nt, 0);
        const int n = n0 + c;
        const float v0 = epilogue<T>(acc[mt][nt][2 * h], sa[c], sb[c], relu);
        const float v1 = epilogue<T>(acc[mt][nt][2 * h + 1], sa[c + 1],
                                     sb[c + 1], relu);
        if (REDO_NAN<T>) seen_nan |= isnan(v0) | isnan(v1);
        store_row2<T>(y + m * g.Cout + n, v0, v1, pair_count(n, g.Cout),
                      even);
      }
    }
  // the rare path: the block's stores are visible to it after the barrier
  if constexpr (REDO_NAN<T>) {
    if (!__syncthreads_or(seen_nan)) return;
    for (int i = threadIdx.x; i < TL::BM * TL::BN; i += TL::THREADS) {
      const long long m = m0 + i / TL::BN;
      const int c = i % TL::BN, n = n0 + c;
      if (m >= M || n >= g.Cout) continue;
      T* p = y + m * g.Cout + n;
      if (isnan(convtile::to_f32(*p)))
        *p = from_f32<T>(epilogue<T>(direct_sum(x, wt, g, m, n), sa[c],
                                     sb[c], relu));
    }
  }
}

template <typename T>
int launch(const void* x, const float* w, void* wt, const float* a,
           const float* b, void* y, const ConvGeom& g, int relu, int tile_arg,
           cudaStream_t st) {
  const long long M = (long long)g.N * g.Ho * g.Wo;
  const bool vec = vec_ok<T>(g.Cin, g.Cout);
  if (tile_arg != 0 && !(tile_arg == 128 && db_ok(M, g.Cout, vec)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e0 =
      launch_taps<T, false>(w, static_cast<T*>(wt), nullptr, g, st);
  if (e0 != cudaSuccess) return (int)e0;
  const TilePick tile = pick_tile_arg(M, g.Cout, vec, tile_arg);
  return with_tile<T, true>(tile, [&](auto tl) -> int {
    using TL = decltype(tl);
    constexpr int smem = conv_smem_bytes<TL>();
    const cudaError_t e = allow_smem(conv_affine_kernel<T, TL>, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)((M + TL::BM - 1) / TL::BM),
                    (unsigned)((g.Cout + TL::BN - 1) / TL::BN));
    conv_affine_kernel<T, TL><<<grid, TL::THREADS, smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(wt), a, b,
        static_cast<T*>(y), g, relu);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. w is the OIHW float32 filter; wt
// [kh*kw, Cin, Cout] in x's dtype (16-byte aligned) is scratch. tile: 0 =
// pick_tile's, 128 = the 128-row tile where pick_tile takes 64 (db_ok;
// otherwise an error). The output is bitwise the same on either tile: a
// block sums each element's K walk in one order, whatever its rows.
// Returns the first launch error (0 = success).
int conv_affine(const void* x, const float* w, void* wt, const float* a,
                const float* b, void* y, int dtype, int N, int H, int W,
                int Cin, int Cout, int kh, int kw, int stride, int ph,
                int pw, int Ho, int Wo, int relu, int tile, void* stream) {
  const ConvGeom g{N, H, W, Cin, Cout, kh, kw, stride, ph, pw, Ho, Wo};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, wt, a, b, y, g, relu, tile, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, wt, a, b, y, g, relu, tile, st);
  return (int)cudaErrorInvalidValue;
}

// 1 where tile 128 runs another tile than pick_tile's for this conv (db_ok),
// in conv_affine and conv_bn_train alike: where the tuner's "pallas_db"
// variant is offered. M = N * Ho * Wo output rows.
int conv_db_ok(int dtype, int N, int Ho, int Wo, int Cin, int Cout) {
  const long long M = (long long)N * Ho * Wo;
  if (dtype == 0) return db_ok(M, Cout, vec_ok<float>(Cin, Cout));
  if (dtype == 1) return db_ok(M, Cout, vec_ok<__nv_bfloat16>(Cin, Cout));
  return 0;
}

}  // extern "C"
