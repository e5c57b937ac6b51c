// conv_affine: NHWC convolution + per-channel affine (+ relu), the folded
// batch-norm inference epilogue, for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/conv_bn.py::conv_affine_pallas (kernel
// _conv_affine_kernel): y = act(round_to_input_dtype(conv(x, w)) * a + b),
// a = scale * rsqrt(var + eps) and b = bias - mean * a folded by the caller.
//
// Shapes: x [N, H, W, Cin] NHWC, float32 or bfloat16; wt [kh*kw, Cin, Cout]
// (the OIHW filter laid out per tap, in x's dtype); a, b [Cout] float32;
// y [N, Ho, Wo, Cout] in x's dtype. Taps are 1x1 or 3x3 at stride 1 with any
// padding, or 1x1 at stride 2 with no padding.
//
// Design: an implicit GEMM. M = N*Ho*Wo output pixels, N = Cout, and the
// K = kh*kw*Cin reduction walks tap by tap, BK input channels at a time.
// Each block computes a BM x BN output tile; per K step it stages a BM x BK
// tile of x (gathered straight from the NHWC input: padding is a masked
// load, stride 2 is read in place) and a BK x BN tile of the tap's weights
// through shared memory, and every thread accumulates a 4 x 4 sub-tile in
// float32 registers. The epilogue rounds the sum to the input dtype, applies
// z * a + b in float32, the optional relu, and stores in the input dtype, so
// the conv output never goes to device memory before the affine.
//
// Bound on the H100: these shapes do 2*M*Cout*K operations over a few bytes
// each, so at float32 on the CUDA cores (67 TFLOP/s) the kernel is bound by
// operations, not by the 3.35 TB/s of device memory. This first version uses
// no tensor cores (no wgmma, no TMA, no pipelining) and so stays far from
// the 989 TFLOP/s bfloat16 tensor-core rate; those come in a later version.
//
// The C entry returns cudaGetLastError() after the launch; the caller
// allocates y and passes its stream. The kernel allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;       // output pixels per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 16;       // input channels per K step
constexpr int THREADS = 256; // 16 x 16 threads, each owning a 4 x 4 sub-tile

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_affine_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                   const float* __restrict__ a, const float* __restrict__ b,
                   T* __restrict__ y, int N, int H, int W, int Cin, int Cout,
                   int kh, int kw, int stride, int ph, int pw, int Ho, int Wo,
                   int relu) {
  // As is [k][pixel] so the compute loop reads 4 consecutive pixels as one
  // float4; the +4 keeps rows 16-byte aligned and halves store conflicts.
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long M = (long long)N * Ho * Wo;

  // A loader: channel ka of pixels ra + 16*i. Consecutive threads read
  // consecutive channels of one pixel.
  const int ka = tid % BK;
  const int ra = tid / BK;
  int img[4], ih0[4], iw0[4];
  bool mvalid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ra + 16 * i;
    mvalid[i] = m < M;
    const long long mm = mvalid[i] ? m : 0;
    const int ow = (int)(mm % Wo);
    const long long t = mm / Wo;
    const int oh = (int)(t % Ho);
    img[i] = (int)(t / Ho);
    ih0[i] = oh * stride - ph;
    iw0[i] = ow * stride - pw;
  }

  // B loader: output channel nb of K rows kb + 4*i (coalesced along Cout).
  const int nb = tid % BN;
  const int kb = tid / BN;

  // compute role: pixels ty*4 .. +3, channels tx*4 .. +3 of the tile
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < kh * kw; ++tap) {
    const int r = tap / kw;
    const int s = tap % kw;
    long long rowoff[4];
    bool rvalid[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ih = ih0[i] + r;
      const int iw = iw0[i] + s;
      rvalid[i] = mvalid[i] && ih >= 0 && ih < H && iw >= 0 && iw < W;
      rowoff[i] = rvalid[i] ? (((long long)img[i] * H + ih) * W + iw) * Cin
                            : 0;
    }
    const T* wtap = wt + (long long)tap * Cin * Cout;
    for (int c0 = 0; c0 < Cin; c0 += BK) {
      const int ca = c0 + ka;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        As[ka][ra + 16 * i] =
            (rvalid[i] && ca < Cin) ? to_f32(x[rowoff[i] + ca]) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = kb + 4 * i;
        const int c = c0 + k;
        const int n = n0 + nb;
        Bs[k][nb] = (c < Cin && n < Cout)
                        ? to_f32(wtap[(long long)c * Cout + n])
                        : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
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

  // epilogue: round to the input dtype, z*a + b in float32 (explicit
  // round-to-nearest ops, so the compiler does not contract them into an
  // FMA the plain version does not do), relu, store in the input dtype
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= Cout) continue;
      const float z = to_f32(from_f32<T>(acc[i][j]));
      float v = __fadd_rn(__fmul_rn(z, a[n]), b[n]);
      if (relu) v = fmaxf(v, 0.f);
      y[m * Cout + n] = from_f32<T>(v);
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() (0 = success).
int conv_affine(const void* x, const void* wt, const float* a, const float* b,
                void* y, int dtype, int N, int H, int W, int Cin, int Cout,
                int kh, int kw, int stride, int ph, int pw, int Ho, int Wo,
                int relu, void* stream) {
  const long long M = (long long)N * Ho * Wo;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    conv_affine_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(wt), a, b,
        static_cast<float*>(y), N, H, W, Cin, Cout, kh, kw, stride, ph, pw,
        Ho, Wo, relu);
  } else if (dtype == 1) {
    conv_affine_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(wt), a, b,
        static_cast<__nv_bfloat16*>(y), N, H, W, Cin, Cout, kh, kw, stride,
        ph, pw, Ho, Wo, relu);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* conv_affine_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
