// conv_mma.cuh: the tensor-core implicit-GEMM mainloop of the conv +
// batch-norm kernels (conv_affine.cu, conv_bn_train.cu, conv_bn_bwd.cu),
// for Hopper (sm_90a). The helpers they share beside it (to_f32, round_to,
// ConvGeom, bn_fold, affine, relu_of) live in conv_tile.cuh.
//
// One block of 8 warps computes a BM x BN tile of a GEMM whose K dimension
// is walked BK = 32 elements at a time through a ring of STAGES shared-memory
// stages. Two operand shapes run on it:
//   - the conv (forward z, the backward's recompute of z, and dx): A is
//     BM output pixels x BK input channels of one tap, gathered straight
//     from NHWC activations (padding taps, the M tail and channels past Cin
//     are zero-filled), K-contiguous in shared memory; B is BK channels x BN
//     output channels of the tap's filter [kh*kw, Cin, Cout];
//   - dw: A is BK output pixels x BM input channels of x at one tap
//     (M-contiguous), B is the same BK pixels x BN channels of dz.
// Both operands arrive by cp.async (16 bytes a copy where every channel
// count is a multiple of 16 bytes, else one element a copy: a 4-byte
// cp.async for float32, a plain load for a bfloat16 element), with
// src-size 0 zero-filling what lies outside the operand; the loads of step
// s + 2 are in flight while step s computes, and one wait_group +
// __syncthreads separates the steps. Row pitches are padded so that every
// fragment load of a warp hits 32 distinct banks. taps_kernel lays the
// OIHW float32 filter out per tap (and rotated, for dx) in the operands'
// dtype inside each C entry.
//
// Math. float32 operands run mma.sync m16n8k8 TF32 as 3xTF32: each operand
// is split in registers at fragment load into hi = tf32(a) and
// lo = tf32(a - hi) (cvt.rna.tf32.f32's rounding, done on the bits; a NaN
// or an infinity in a reaches lo as a NaN), and every 8-deep slice sums
// lo*hi + hi*lo, then hi*hi, on the tensor cores into a fresh accumulator
// that is added to the running float32 sum with one round-to-nearest add.
// So a tensor-core sum never spans more than 24 products and the running
// sum rounds as a float32 FMA loop does; the dropped lo*lo term is below
// 2^-22 of each product. bfloat16 operands run mma.sync m16n8k16 once:
// their products are exact. Single-pass TF32 never touches float32 data.
//
// Why mma.sync and not wgmma: wgmma with tf32 operands needs both operands
// K-major in shared memory, and the dw GEMM's are not (x_tap^T is
// Cin-contiguous, dz Cout-contiguous); 3xTF32's split of B would also need
// a second shared copy for wgmma, where mma.sync splits fragments in
// registers for a few instructions. Moving this loop onto wgmma and TMA is
// the next redesign.
//
// Determinism. The result of an output element depends only on K's order
// (steps of BK, slices of 8 or 16, the three products in a fixed order),
// never on the tile, and the tile is a function of the GEMM's geometry
// (pick_tile) alone: the forward's z and the backward's recompute of z run
// this same loop on the same operands and are bitwise equal, so the relu
// mask is the forward's. The epilogue reductions go lane shuffles, then
// shared memory, in one fixed order; nothing uses atomics.
//
// Every kernel allocates nothing: callers pass every buffer and the stream.

#pragma once

#include <cstdint>

#include "conv_tile.cuh"

namespace convmma {

using convtile::ConvGeom;

constexpr int BK = 32;        // K elements (channels or pixels) per stage
constexpr int STAGES = 3;     // shared-memory ring depth
constexpr int MIN_BLOCKS = 2; // blocks per SM the register budget allows

// ---- PTX wrappers --------------------------------------------------------

// 16-byte copy, or zero-fill when !valid (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cvt.rna.tf32.f32's rounding (to 10 mantissa bits, ties away from zero)
// as two integer operations on the bits, which issue faster than the
// conversion; right for every finite v and for the infinities.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo to ~22 bits, both TF32. For a NaN v, hi's add may carry the
// payload into the sign and exponent (0x7fffffff, the card's NaN, gives
// -0.0), so lo carries the NaN instead: v - hi is the card's NaN whenever
// v is a NaN or an infinity (a float32 subtraction returns that one NaN),
// and lo's rounding keeps it, taking the unrounded bits where the add
// would wrap past 0x7fffffff (the signed max; every finite d and the
// infinities take the add). A NaN or infinite v so gives NaN products, as
// the float32 products are NaN or infinite; one integer max a split.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  const int d = (int)__float_as_uint(__fsub_rn(v, __uint_as_float(hi)));
  const int up = (int)((unsigned)d + 0x1000u);
  lo = (unsigned)max(up, d) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b, the accumulator input zero (no registers to clear)
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 (k, k + 1) into one register, the lower k in the low half
__device__ __forceinline__ uint32_t pack2(unsigned short lo,
                                          unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// ---- tile geometry -------------------------------------------------------

// A GEMM tile: BM x BN outputs, 8 warps of WM x WN, each holding MT x NT
// mma fragments. AK: A is K-contiguous in shared memory ([BM][BK], the
// conv), else M-contiguous ([BK][BM], dw). VEC: 16-byte copies. WMF, where
// not 0, sets the warps along M (conv_bn_train's two-image variant runs a
// 128 x 128 tile as 4 x 2 warps of 32 rows, the 64-row tile's warp rows).
template <typename T, int BM_, int BN_, bool AK, bool VEC_, int WMF = 0>
struct Tile {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr bool VEC = VEC_;
  static constexpr int WARPS_M =
      WMF ? WMF : ((BM == 128 && BN == 64) ? 4 : 2);
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int VW = VEC ? 16 / (int)sizeof(T) : 1;  // per copy
  // pitches (elements): a fragment load's 32 lanes hit 32 banks
  static constexpr int A_LD = AK ? BK + 16 / (int)sizeof(T) : BM + 8;
  static constexpr int B_LD = BN + 8;
  static constexpr int A_ELEMS = (AK ? BM : BK) * A_LD;
  static constexpr int STAGE_ELEMS = A_ELEMS + BK * B_LD;
  static constexpr int RING_BYTES = STAGES * STAGE_ELEMS * (int)sizeof(T);
  static_assert(WM % 16 == 0 && WN % 8 == 0, "warp tile");
  static_assert(BN <= THREADS, "one thread per column in the epilogue");
  static_assert((A_ELEMS * (int)sizeof(T)) % 16 == 0, "stage alignment");
};

// The conv's tile (M output pixels by N output channels): 128 x 128, 64
// columns where N <= 64, and 64 rows where 128-row tiles would leave SMs
// without a block (ResNet-50's 7x7 layers at batch 32: 52 blocks of 128
// rows for 132 SMs, 100 of 64; chip_smoke.py phase 2 times those layers
// slower without it, PERF.md section 6). Vectorised copies need every
// channel count a multiple of 16 bytes; otherwise the 64 x 64 tile copies
// one element at a time. A function of the geometry alone.
struct TilePick {
  int bm, bn;
  bool vec;
};
inline TilePick pick_tile(long long M, int N, bool vec) {
  if (!vec) return {64, 64, false};
  const int bn = N <= 64 ? 64 : 128;
  const long long tiles = (M + 127) / 128 * ((N + bn - 1) / bn);
  return {tiles < 132 ? 64 : 128, bn, true};
}

// The C entries' tile argument: 0 takes pick_tile's choice; 128 takes the
// 128-row tile where pick_tile would take 64 rows, the counterpart of the
// reference's two-image grid step (conv_bn.py block_n=2, the tuner's
// "pallas_db" variant). db_ok says where the two differ; elsewhere the
// variant is not offered (its C entries refuse the argument).
inline bool db_ok(long long M, int N, bool vec) {
  return vec && pick_tile(M, N, vec).bm == 64;
}

inline TilePick pick_tile_arg(long long M, int N, bool vec, int tile) {
  TilePick p = pick_tile(M, N, vec);
  if (tile == 128) p.bm = 128;
  return p;
}

// The dw GEMM's tile (M = Cin, N = Cout): 64 along a side of at most 64
// channels, else 128; copies as for the conv.
inline TilePick pick_dw_tile(int cin, int cout, bool vec) {
  if (!vec) return {64, 64, false};
  return {cin <= 64 ? 64 : 128, cout <= 64 ? 64 : 128, true};
}

template <typename T>
inline bool vec_ok(int cin, int cout) {
  constexpr int vw = 16 / (int)sizeof(T);
  return cin % vw == 0 && cout % vw == 0;
}

// Calls f(Tile<...>{}) for the picked configuration.
template <typename T, bool AK, typename F>
inline int with_tile(const TilePick& p, F&& f) {
  if (!p.vec) return f(Tile<T, 64, 64, AK, false>{});
  if (p.bm == 128 && p.bn == 128) return f(Tile<T, 128, 128, AK, true>{});
  if (p.bm == 128) return f(Tile<T, 128, 64, AK, true>{});
  if (p.bn == 128) return f(Tile<T, 64, 128, AK, true>{});
  return f(Tile<T, 64, 64, AK, true>{});
}

// The conv's row blocks: the per-block partial statistics hold this many
// rows of Cout.
inline long long conv_blocks_m(long long M, int N, bool vec) {
  const int bm = pick_tile(M, N, vec).bm;
  return (M + bm - 1) / bm;
}

// How many pixel ranges the dw GEMM splits its K = N*Ho*Wo reduction into:
// enough blocks for two per SM, each range at least 512 pixels (16 of the
// loop's 32-pixel steps). Only the speed depends on it; the partial buffer
// holds splits x kh*kw x Cin x Cout floats.
inline int dw_splits(const ConvGeom& g, bool vec, int sms) {
  const TilePick p = pick_dw_tile(g.Cin, g.Cout, vec);
  const long long tiles = (long long)g.kh * g.kw *
                          ((g.Cin + p.bm - 1) / p.bm) *
                          ((g.Cout + p.bn - 1) / p.bn);
  const long long m = (long long)g.N * g.Ho * g.Wo;
  const long long by_sms = (2LL * sms + tiles - 1) / tiles;
  const long long by_k = (m + 511) / 512;
  const long long s = by_sms < by_k ? by_sms : by_k;
  return s > 1 ? (int)s : 1;
}

// Raise the kernel's dynamic shared-memory limit; returns the error.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// ---- copies --------------------------------------------------------------

// VW elements from src to shared dst, zeros where !valid (src then unread)
template <typename T, int VW>
__device__ __forceinline__ void copy_in(T* dst, const T* src, bool valid) {
  if constexpr (VW * sizeof(T) == 16) {
    cp_async16(dst, src, valid);
  } else if constexpr (sizeof(T) == 4) {
    cp_async4(dst, src, valid);
  } else {
    // one bfloat16: below cp.async's 4-byte minimum, so a plain copy; the
    // ring's barrier orders it like the asynchronous ones
    *dst = valid ? *src : convtile::from_f32<T>(0.f);
  }
}

// ---- the math of one stage ----------------------------------------------

// acc[mt][nt][i] += this stage's BK-deep product for the warp's fragments.
// Fragment layouts (PTX ISA, mma.m16n8k8 / m16n8k16): with g = lane / 4,
// t = lane % 4, A's (row, k) and B's (k, col) per register as below; the
// accumulator's c0..c3 are (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
template <class TL, bool AK>
__device__ __forceinline__ void mma_stage(const float* As, const float* Bs,
                                          float (&acc)[TL::MT][TL::NT][4],
                                          int wm0, int wn0, int g, int t) {
  auto A = [&](int m, int k) {
    return AK ? As[m * TL::A_LD + k] : As[k * TL::A_LD + m];
  };
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    uint32_t bh[TL::NT][2], bl[TL::NT][2];
#pragma unroll
    for (int nt = 0; nt < TL::NT; ++nt) {
      const int n = wn0 + nt * 8 + g;
      split_tf32(Bs[(kk + t) * TL::B_LD + n], bh[nt][0], bl[nt][0]);
      split_tf32(Bs[(kk + t + 4) * TL::B_LD + n], bh[nt][1], bl[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < TL::MT; ++mt) {
      const int m = wm0 + mt * 16 + g;
      const float a[4] = {A(m, kk + t), A(m + 8, kk + t), A(m, kk + t + 4),
                          A(m + 8, kk + t + 4)};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
      // the slice's three products of each fragment into a fresh sum,
      // small terms first, then one round-to-nearest add into acc
      float c[TL::NT][4];
#pragma unroll
      for (int nt = 0; nt < TL::NT; ++nt) mma_tf32_zero(c[nt], al, bh[nt]);
#pragma unroll
      for (int nt = 0; nt < TL::NT; ++nt) mma_tf32(c[nt], ah, bl[nt]);
#pragma unroll
      for (int nt = 0; nt < TL::NT; ++nt) mma_tf32(c[nt], ah, bh[nt]);
#pragma unroll
      for (int nt = 0; nt < TL::NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[mt][nt][i] = __fadd_rn(acc[mt][nt][i], c[nt][i]);
    }
  }
}

template <class TL, bool AK>
__device__ __forceinline__ void mma_stage(const __nv_bfloat16* As_,
                                          const __nv_bfloat16* Bs_,
                                          float (&acc)[TL::MT][TL::NT][4],
                                          int wm0, int wn0, int g, int t) {
  const unsigned short* As = reinterpret_cast<const unsigned short*>(As_);
  const unsigned short* Bs = reinterpret_cast<const unsigned short*>(Bs_);
  // A's register (m, k..k+1), k even
  auto A = [&](int m, int k) -> uint32_t {
    if (AK) return *reinterpret_cast<const uint32_t*>(&As[m * TL::A_LD + k]);
    return pack2(As[k * TL::A_LD + m], As[(k + 1) * TL::A_LD + m]);
  };
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t b[TL::NT][2];
#pragma unroll
    for (int nt = 0; nt < TL::NT; ++nt) {
      const int n = wn0 + nt * 8 + g;
      const int k0 = kk + 2 * t;
      b[nt][0] = pack2(Bs[k0 * TL::B_LD + n], Bs[(k0 + 1) * TL::B_LD + n]);
      b[nt][1] = pack2(Bs[(k0 + 8) * TL::B_LD + n],
                       Bs[(k0 + 9) * TL::B_LD + n]);
    }
#pragma unroll
    for (int mt = 0; mt < TL::MT; ++mt) {
      const int m = wm0 + mt * 16 + g;
      const int k0 = kk + 2 * t;
      const uint32_t a[4] = {A(m, k0), A(m + 8, k0), A(m, k0 + 8),
                             A(m + 8, k0 + 8)};
#pragma unroll
      for (int nt = 0; nt < TL::NT; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
    }
  }
}

// ---- the pipelined K loop ------------------------------------------------

// Runs `steps` K steps: load(s, A_stage, B_stage) issues step s's copies,
// STAGES - 1 steps ahead of the math, for s = 0, 1, ... in order. On return
// every copy has landed and the ring may be reused.
template <typename T, class TL, bool AK, class Load>
__device__ __forceinline__ void k_loop(int steps, T* ring, Load&& load,
                                       float (&acc)[TL::MT][TL::NT][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp % TL::WARPS_M) * TL::WM;
  const int wn0 = (warp / TL::WARPS_M) * TL::WN;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < TL::NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  auto stage = [&](int s) { return ring + (s % STAGES) * TL::STAGE_ELEMS; };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, stage(s), stage(s) + TL::A_ELEMS);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = s + STAGES - 1;
    if (nxt < steps) load(nxt, stage(nxt), stage(nxt) + TL::A_ELEMS);
    cp_async_commit();
    mma_stage<TL, AK>(stage(s), stage(s) + TL::A_ELEMS, acc, wm0, wn0, g, t);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ---- the conv GEMM -------------------------------------------------------

// Per output pixel of the block: the input pixel index of tap (0, 0),
// (img * H + ih0) * W + iw0, and ih0, iw0 themselves (ih0 far below 0 past
// M, so that no tap of it is inside the image).
struct PixelRow {
  long long base;
  int ih0, iw0;
};
constexpr int NO_ROW = -(1 << 30);

// dynamic shared memory of a conv kernel: the ring, then the pixel table
template <class TL>
constexpr int conv_smem_bytes() {
  return TL::RING_BYTES + TL::BM * (int)sizeof(PixelRow);
}

// acc = the conv tile at output pixels m0.. and channels n0.. of x
// [N, H, W, Cin] with wt [kh*kw, Cin, Cout]; K walks taps, then channels.
// Copies outside the operands are zero-filled from unclamped addresses: a
// cp.async of src-size 0 reads nothing.
template <typename T, class TL>
__device__ __forceinline__ void conv_tile(const T* __restrict__ x,
                                          const T* __restrict__ wt,
                                          const ConvGeom& g, long long m0,
                                          int n0, unsigned char* smem,
                                          float (&acc)[TL::MT][TL::NT][4]) {
  T* ring = reinterpret_cast<T*>(smem);
  PixelRow* pix = reinterpret_cast<PixelRow*>(smem + TL::RING_BYTES);
  const int tid = threadIdx.x;
  const long long M = (long long)g.N * g.Ho * g.Wo;
  for (int r = tid; r < TL::BM; r += TL::THREADS) {
    const long long m = m0 + r;
    PixelRow p{0, NO_ROW, 0};
    if (m < M) {
      const int ow = (int)(m % g.Wo);
      const long long q = m / g.Wo;
      p.ih0 = (int)(q % g.Ho) * g.stride - g.ph;
      p.iw0 = ow * g.stride - g.pw;
      p.base = ((q / g.Ho) * g.H + p.ih0) * g.W + p.iw0;
    }
    pix[r] = p;
  }
  __syncthreads();

  constexpr int VW = TL::VW;
  // A: BM pixel rows of BK / VW copies; A_TPR threads share a row
  constexpr int A_CPR = BK / VW;
  constexpr int A_TPR = TL::VEC ? A_CPR : TL::THREADS / TL::BM;
  constexpr int A_CPT = A_CPR / A_TPR;
  constexpr int A_RPT = TL::BM * A_TPR / TL::THREADS;
  // B: BK channel rows of BN / VW copies; B_TPR threads share a row
  constexpr int B_TPR = TL::THREADS / BK;
  constexpr int B_CPT = TL::BN / VW / B_TPR;
  static_assert(A_CPT >= 1 && A_RPT >= 1 && B_CPT >= 1, "loader shape");
  const int steps = g.kh * g.kw * ((g.Cin + BK - 1) / BK);
  const int a_col = (tid % A_TPR) * VW;  // first A channel in the block
  const int kr = tid / B_TPR;            // B's row (channel in the block)
  const int n = n0 + (tid % B_TPR) * VW; // first B column
  // the next step to load (steps load in order): tap (r, q), channels c0..
  int r = 0, q = 0, c0 = 0;
  // (tap * Cin + c0 + kr) * Cout + n: the start of the thread's B copies
  long long wrow = (long long)kr * g.Cout + n;

  auto load = [&](int, T* As, T* Bs) {
    const long long dpix = (long long)r * g.W + q;
#pragma unroll
    for (int i = 0; i < A_RPT; ++i) {
      const int row = tid / A_TPR + (TL::THREADS / A_TPR) * i;
      const PixelRow p = pix[row];
      const bool ok = (unsigned)(p.ih0 + r) < (unsigned)g.H &&
                      (unsigned)(p.iw0 + q) < (unsigned)g.W;
      const T* src = x + (p.base + dpix) * g.Cin + c0 + a_col;
#pragma unroll
      for (int j = 0; j < A_CPT; ++j)
        copy_in<T, VW>(As + row * TL::A_LD + a_col + A_TPR * VW * j,
                       src + A_TPR * VW * j,
                       ok && c0 + a_col + A_TPR * VW * j < g.Cin);
    }
    const bool kv = c0 + kr < g.Cin;
#pragma unroll
    for (int j = 0; j < B_CPT; ++j)
      copy_in<T, VW>(Bs + kr * TL::B_LD + (n - n0) + B_TPR * VW * j,
                     wt + wrow + B_TPR * VW * j,
                     kv && n + B_TPR * VW * j < g.Cout);
    c0 += BK;
    wrow += (long long)BK * g.Cout;
    if (c0 >= g.Cin) {  // next tap
      wrow += (long long)(g.Cin - c0) * g.Cout;
      c0 = 0;
      if (++q == g.kw) {
        q = 0;
        ++r;
      }
    }
  };
  k_loop<T, TL, true>(steps, ring, load, acc);
}

// ---- the dw GEMM ---------------------------------------------------------

// acc = sum over pixels kbeg..kend-1 of x_tap[m, ci0..]^T dz[m, co0..] at
// tap (r, q); K walks pixels.
template <typename T, class TL>
__device__ __forceinline__ void dw_tile(const T* __restrict__ x,
                                        const T* __restrict__ dz,
                                        const ConvGeom& g, int r, int q,
                                        long long kbeg, long long kend,
                                        int ci0, int co0, unsigned char* smem,
                                        float (&acc)[TL::MT][TL::NT][4]) {
  T* ring = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x;
  constexpr int VW = TL::VW;
  constexpr int TPR = TL::THREADS / BK;  // threads per pixel row
  constexpr int A_CPT = TL::BM / VW / TPR;
  constexpr int B_CPT = TL::BN / VW / TPR;
  static_assert(A_CPT >= 1 && B_CPT >= 1, "loader shape");
  const int steps = kend > kbeg ? (int)((kend - kbeg + BK - 1) / BK) : 0;
  const int p = tid / TPR;             // the thread's pixel row of each step
  const int col = (tid % TPR) * VW;    // its first column in the tile
  // the thread's next pixel m and its (img, oh, ow); 32-bit indices: the
  // wrapper keeps N*H*W and N*Ho*Wo below 2^31
  long long m = kbeg + p;
  int ow = (int)(m % g.Wo), oh = (int)(m / g.Wo % g.Ho);
  int img = (int)(m / g.Wo / g.Ho);

  auto load = [&](int, T* As, T* Bs) {
    const bool mv = m < kend;
    const int ih = oh * g.stride - g.ph + r, iw = ow * g.stride - g.pw + q;
    const bool ok = mv && (unsigned)ih < (unsigned)g.H &&
                    (unsigned)iw < (unsigned)g.W;
    const T* xs = x + (((long long)img * g.H + ih) * g.W + iw) * g.Cin +
                  ci0 + col;
    const T* ds = dz + m * g.Cout + co0 + col;
#pragma unroll
    for (int j = 0; j < A_CPT; ++j)
      copy_in<T, VW>(As + p * TL::A_LD + col + TPR * VW * j,
                     xs + TPR * VW * j,
                     ok && ci0 + col + TPR * VW * j < g.Cin);
#pragma unroll
    for (int j = 0; j < B_CPT; ++j)
      copy_in<T, VW>(Bs + p * TL::B_LD + col + TPR * VW * j,
                     ds + TPR * VW * j,
                     mv && co0 + col + TPR * VW * j < g.Cout);
    m += BK;
    ow += BK;
    while (ow >= g.Wo) {
      ow -= g.Wo;
      if (++oh == g.Ho) {
        oh = 0;
        ++img;
      }
    }
  };
  k_loop<T, TL, false>(steps, ring, load, acc);
}

// ---- epilogue helpers ----------------------------------------------------

// Where a thread's accumulator element (mt, nt, i) lies in the tile.
template <class TL>
struct Frag {
  int wm0, wn0, g, t;
  __device__ Frag() {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    wm0 = (warp % TL::WARPS_M) * TL::WM;
    wn0 = (warp / TL::WARPS_M) * TL::WN;
    g = lane / 4;
    t = lane % 4;
  }
  __device__ int row(int mt, int i) const {
    return wm0 + mt * 16 + g + 8 * (i / 2);
  }
  __device__ int col(int nt, int i) const {
    return wn0 + nt * 8 + 2 * t + (i % 2);
  }
};

// Per-column sums over the tile: s[nt][j] is the thread's sum over its rows
// (added in (mt, half) order by the caller) of column col(nt, j). The 8
// lanes sharing a column add by shuffles, then the WARPS_M warps sharing it
// in order through red (WARPS_M x BN floats of shared memory). Returns the
// column tid's sum in threads tid < BN. With NB > 1 the tile's rows are NB
// blocks of BM / NB rows (WARPS_M / NB warps each), summed apart: thread
// tid < NB * BN gets block tid / BN's sum of column tid % BN, in the same
// order a tile of BM / NB rows and WARPS_M / NB warps sums it.
template <class TL, int NB = 1>
__device__ __forceinline__ float column_sum(float (&s)[TL::NT][2],
                                            const Frag<TL>& f, float* red) {
  static_assert(TL::WARPS_M % NB == 0, "whole warps per row block");
  constexpr int WPB = TL::WARPS_M / NB;
#pragma unroll
  for (int nt = 0; nt < TL::NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = s[nt][j];
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 4));
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 16));
      if (f.g == 0)
        red[(threadIdx.x / 32 % TL::WARPS_M) * TL::BN + f.col(nt, j)] = v;
    }
  __syncthreads();
  float r = 0.f;
  if (threadIdx.x < NB * TL::BN) {
    const int b = threadIdx.x / TL::BN, c = threadIdx.x % TL::BN;
    for (int w = b * WPB; w < (b + 1) * WPB; ++w)
      r = __fadd_rn(r, red[w * TL::BN + c]);
  }
  __syncthreads();
  return r;
}

// The kernels' filter layouts from the OIHW float32 filter w, in T:
// wt[tap][ci][co] = w[co][ci][r][s] (tap = r * kw + s), the conv's B, and,
// with ROT (the backward), wrot[tap][co][ci] = w[co][ci][kh-1-r][kw-1-s],
// the B of dx (the filter rotated 180 degrees and transposed per tap).
// Each output is written in its own order (coalesced); the reads gather
// from w, which is small enough to stay in L2.
template <typename T, bool ROT>
__global__ void __launch_bounds__(256)
taps_kernel(const float* __restrict__ w, T* __restrict__ wt,
            T* __restrict__ wrot, int Cout, int Cin, int taps) {
  const long long total = (long long)Cout * Cin * taps;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int co = (int)(i % Cout);
    const long long q = i / Cout;
    const int ci = (int)(q % Cin), tap = (int)(q / Cin);
    wt[i] = convtile::from_f32<T>(w[((long long)co * Cin + ci) * taps + tap]);
    if (ROT) {
      const int ci2 = (int)(i % Cin);
      const long long q2 = i / Cin;
      const int co2 = (int)(q2 % Cout), tap2 = (int)(q2 / Cout);
      wrot[i] = convtile::from_f32<T>(
          w[((long long)co2 * Cin + ci2) * taps + (taps - 1 - tap2)]);
    }
  }
}

template <typename T, bool ROT>
inline cudaError_t launch_taps(const float* w, T* wt, T* wrot,
                               const ConvGeom& g, cudaStream_t st) {
  const long long total = (long long)g.Cout * g.Cin * g.kh * g.kw;
  const unsigned blocks = (unsigned)((total + 255) / 256 < 132 * 8
                                         ? (total + 255) / 256 : 132 * 8);
  taps_kernel<T, ROT><<<blocks, 256, 0, st>>>(w, wt, wrot, g.Cout, g.Cin,
                                              g.kh * g.kw);
  return cudaGetLastError();
}

// Four consecutive elements (at a multiple of 4) as one access, in float32.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<uint32_t*>(&a);
  t.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

// how many of columns n, n + 1 lie below C
__device__ __forceinline__ int pair_count(int n, int C) {
  return C - n >= 2 ? 2 : (C - n > 0 ? C - n : 0);
}

// Two neighbouring elements p[0], p[1] of a row, cnt of them (0..2) inside
// it; one 2-element access where the row length is even (then p is
// 2-element aligned, as every column pair starts at an even column).
template <typename T>
__device__ __forceinline__ void store_row2(T* p, float a, float b, int cnt,
                                           bool even) {
  if (even && cnt == 2) {
    if constexpr (sizeof(T) == 4)
      *reinterpret_cast<float2*>(p) = make_float2(a, b);
    else
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
    return;
  }
  if (cnt > 0) p[0] = convtile::from_f32<T>(a);
  if (cnt > 1) p[1] = convtile::from_f32<T>(b);
}

template <typename T>
__device__ __forceinline__ void load_row2(const T* p, int cnt, bool even,
                                          float& a, float& b) {
  a = 0.f;
  b = 0.f;
  if (even && cnt == 2) {
    if constexpr (sizeof(T) == 4) {
      const float2 v = *reinterpret_cast<const float2*>(p);
      a = v.x;
      b = v.y;
    } else {
      const float2 v =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
      a = v.x;
      b = v.y;
    }
    return;
  }
  if (cnt > 0) a = convtile::to_f32(p[0]);
  if (cnt > 1) b = convtile::to_f32(p[1]);
}

}  // namespace convmma
