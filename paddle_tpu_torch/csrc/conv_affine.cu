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
// Design: the implicit GEMM of conv_tile.cuh (64 x 64 output tile per
// block, 4 x 4 float32 accumulators per thread). The epilogue rounds the sum
// to the input dtype, applies z * a + b in float32 (explicit round-to-nearest
// ops, so the compiler does not contract them into an FMA the plain version
// does not do), the optional relu, and stores in the input dtype, so the
// conv output never goes to device memory before the affine.
//
// Bound on the H100: these shapes do 2*M*Cout*K operations over a few bytes
// each, so at float32 on the CUDA cores (67 TFLOP/s) the kernel is bound by
// operations, not by the 3.35 TB/s of device memory. This first version uses
// no tensor cores (no wgmma, no TMA, no pipelining) and so stays far from
// the 989 TFLOP/s bfloat16 tensor-core rate; those come in a later version.
//
// The C entry returns cudaGetLastError() after the launch; the caller
// allocates y and passes its stream. The kernel allocates nothing.

#include "conv_tile.cuh"

namespace {

using namespace convtile;

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_affine_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                   const float* __restrict__ a, const float* __restrict__ b,
                   T* __restrict__ y, ConvGeom g, int relu) {
  __shared__ TileSmem sm;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long M = (long long)g.N * g.Ho * g.Wo;
  float acc[4][4];
  conv_mainloop<T>(x, wt, g, m0, n0, sm, acc);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= g.Cout) continue;
      float v = affine(round_to<T>(acc[i][j]), a[n], b[n]);
      if (relu) v = fmaxf(v, 0.f);
      y[m * g.Cout + n] = from_f32<T>(v);
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
  const ConvGeom g{N, H, W, Cin, Cout, kh, kw, stride, ph, pw, Ho, Wo};
  const dim3 grid = tile_grid(g);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    conv_affine_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(wt), a, b,
        static_cast<float*>(y), g, relu);
  } else if (dtype == 1) {
    conv_affine_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(wt), a, b,
        static_cast<__nv_bfloat16*>(y), g, relu);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
