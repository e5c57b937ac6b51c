// seq_mma: the tensor-core code of the whole-sequence recurrent kernels
// (lstm_seq.cu, gru_seq.cu), all on `mma.sync` m16n8k16 bf16 with float32
// accumulation: the forwards' gate tiles on batch-row groups, and the
// backwards' three stages: the prologue's GEMM that recomputes every
// step's gates at once, the chain's product dgates_t . W^T on a batch-row
// group, and the epilogue's dW = sum_t bf16(A_t^T . D_t).
//
// Exactness. bf16 x bf16 products are exact in float32, so the gate
// products, whose operands are bf16(h) (or bf16(r * h)) and bf16(W) as the
// reference rounds them, run as they are: each 16-deep k-step a fresh
// accumulator, the k-steps' sums added in increasing k on the CUDA cores,
// so that only the float32 summation order differs from the plain
// version's. A float32 operand (dgates) is split into three
// bf16 parts, hi + mid + lo, by truncation: hi keeps the top 8 significant
// bits, mid the next 8 of the exact remainder, lo the last 8, so the three
// add up to it exactly (but where the last remainder is subnormal, |v| <
// 2^-102) and every product part is exact: only the order of the float32
// sums differs from the plain version. Each chain k-step (16 columns) and
// each epilogue step starts a fresh accumulator (lo, then mid, then hi)
// whose sum is added to the running float32 total on the CUDA cores, in a
// fixed order: every run is bitwise the same. Non-finite values:
// truncation keeps an infinity in hi (and cannot round a value near
// FLT_MAX up to one), a NaN becomes the canonical bf16 NaN (truncating
// 0x7f800001 would give Inf), and both have mid = lo = 0, so a product
// meets exactly the infinities and NaNs the plain version's does.

#pragma once

#include <algorithm>
#include <cstdint>

#include "seq_common.cuh"

namespace seqmma {

using seq::THREADS;

constexpr int WARPS = THREADS / 32;
constexpr int TM = 64, TN = 128;    // prologue and epilogue tiles: 2 x 4
                                    // warps of 32 x 32
constexpr int PAD = 8;              // bf16 of padding a shared row: rows
                                    // an odd number of 16 B apart
constexpr int TMP = TM + PAD, TNP = TN + PAD;
constexpr int RING = 3;             // stages of the cp.async rings
constexpr int KC = 64;              // the prologue's K chunk
constexpr int KCP = KC + PAD;       // its bf16 pitch

// (bf16(x), bf16(y)) rounded to nearest, as one bf16 pair
__device__ __forceinline__ uint32_t bf16x2(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint2 pack4(float4 v) {
  return make_uint2(bf16x2(v.x, v.y), bf16x2(v.z, v.w));
}

// x and y rounded to bf16 and back
__device__ __forceinline__ float2 bf16r2(float x, float y) {
  const uint32_t p = bf16x2(x, y);
  return make_float2(__uint_as_float(p << 16),
                     __uint_as_float(p & 0xffff0000u));
}

// hi, mid, lo of v in the top 16 bits of each: v = hi + mid + lo exactly
// (module comment); a non-finite v in hi alone
__device__ __forceinline__ void split3(float v, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const uint32_t u = __float_as_uint(v);
  const bool finite = (u & 0x7f800000u) != 0x7f800000u;
  hi = finite ? u & 0xffff0000u : (v != v ? 0x7fc00000u : u);
  const float r1 = finite ? __fsub_rn(v, __uint_as_float(hi)) : 0.f;
  mid = __float_as_uint(r1) & 0xffff0000u;
  lo = __float_as_uint(__fsub_rn(r1, __uint_as_float(mid)));
}

// the parts of (v.x, v.y) in p[i].x and of (v.z, v.w) in p[i].y; four
// finite values (the rule) take four bit masks and four subtractions
__device__ __forceinline__ void split_quad(float4 v, uint2 (&p)[3]) {
  const float f[4] = {v.x, v.y, v.z, v.w};
  uint32_t e = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) e = max(e, __float_as_uint(f[i]) & 0x7f800000u);
  uint32_t q[3][4];
  if (e != 0x7f800000u) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      q[0][i] = __float_as_uint(f[i]) & 0xffff0000u;
      const float r1 = __fsub_rn(f[i], __uint_as_float(q[0][i]));
      q[1][i] = __float_as_uint(r1) & 0xffff0000u;
      q[2][i] = __float_as_uint(__fsub_rn(r1, __uint_as_float(q[1][i])));
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) split3(f[i], q[0][i], q[1][i], q[2][i]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    p[i] = make_uint2((q[i][0] >> 16) | (q[i][1] & 0xffff0000u),
                      (q[i][2] >> 16) | (q[i][3] & 0xffff0000u));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const uint16_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm2(uint32_t (&r)[2], const uint16_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const uint16_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a . b, one m16n8k16 bf16 product with float32 accumulation (not
// volatile: the compiler may interleave independent products)
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, in flight until cp_async_wait; zeros when
// !valid (nothing is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// block 0's clock at stage boundary i: 0 start, 1 after the prologue, 2
// after the chain, 3 after its epilogue (chip_smoke.py reads the shares)
__device__ __forceinline__ void stamp(long long* stamps, int i) {
  if (blockIdx.x == 0 && threadIdx.x == 0) stamps[i] = clock64();
}

// store(i, load(i)) for i < total, U loads a thread in flight at once
// (a loop that waits on each load would pay the latency of every one)
template <int U, typename Load, typename Store>
__device__ __forceinline__ void batched(int total, Load load, Store store) {
  for (int base = threadIdx.x; base < total; base += THREADS * U) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * THREADS;
      v[u] = i < total ? load(i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * THREADS < total) store(base + u * THREADS, v[u]);
  }
}

// ---- forwards ------------------------------------------------------------
//
// A forward block owns UB units (32, or 16 where H is not a multiple of 32)
// of RB = THREADS / UB batch rows, as a backward chain block does. It holds
// its units' gate columns of W as bf16 rows of ws (W^T: K = H columns, a
// pitch of H + PAD), staged once a launch, and each step stages its rows of
// h_{t-1} as bf16 rows of hb, read from L2 (the blocks of its row group
// wrote them in this launch). A warp forms one 16 x 8 tile of the gates:
// 16 gate columns (rows of ws, in the order the kernel's tile map puts
// them) by 8 batch rows, over all H: per 16-deep k-step a fresh
// tensor-core sum, added to the float32 total in increasing k.

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// ws[tile(u, g)][k] = bf16(w[k][g H + j0 + u]) for u < ub, g < G: the
// block's gate columns of w [H, G H] as rows of ws, tile(u, g) the row a
// column takes in the warps' tiles
template <typename Tile>
__device__ void stage_w_tiles(uint16_t* ws, int wp, const float* w, int G,
                              int H, int j0, int ub, Tile tile) {
  const int q = ub / 4, per_k = G * q;
  batched<8>(
      H * per_k,
      [&](int i) {
        const int k = i / per_k, g = (i % per_k) / q;
        return __ldg(reinterpret_cast<const float4*>(
            w + (size_t)k * G * H + g * H + j0 + 4 * (i % q)));
      },
      [&](int i, float4 v) {
        const int k = i / per_k, g = (i % per_k) / q, u = 4 * (i % q);
        ws[tile(u, g) * wp + k] = bf16_bits(v.x);
        ws[tile(u + 1, g) * wp + k] = bf16_bits(v.y);
        ws[tile(u + 2, g) * wp + k] = bf16_bits(v.z);
        ws[tile(u + 3, g) * wp + k] = bf16_bits(v.w);
      });
}

// hb[r][k] = bf16(src[r][k]) for r < rows, k < H: rows of the carries,
// H floats apart, that other blocks wrote in this launch (read from L2)
__device__ __forceinline__ void stage_h_rows(uint16_t* hb, int hp,
                                             const float* src, int rows,
                                             int H) {
  const int q = H / 4;
  batched<8>(
      rows * q,
      [&](int i) {
        return __ldcg(reinterpret_cast<const float4*>(src + (size_t)(i / q) *
                                                      H) + i % q);
      },
      [&](int i, float4 v) {
        *reinterpret_cast<uint2*>(hb + (i / q) * hp + (i % q) * 4) = pack4(v);
      });
}

// hb[r][k] = src[r][k] for r < rows, k < H: bf16 rows, H apart, that other
// blocks wrote in this launch (read from L2, 16 bytes at a time)
__device__ __forceinline__ void stage_bf16_rows(uint16_t* hb, int hp,
                                                const uint16_t* src,
                                                int rows, int H) {
  const int q = H / 8;
  batched<8>(
      rows * q,
      [&](int i) {
        return __ldcg(reinterpret_cast<const float4*>(src + (size_t)(i / q) *
                                                      H) + i % q);
      },
      [&](int i, float4 v) {
        *reinterpret_cast<float4*>(hb + (i / q) * hp + (i % q) * 8) = v;
      });
}

// sum += G k-steps from the lane's rows `a` (of the A tile: 16 gate
// columns) and `bq` (of the B tile: 8 batch rows), each a fresh
// tensor-core sum, added in increasing k; G is 1 or even
template <int G>
__device__ __forceinline__ void fwd_group(const uint16_t* a,
                                          const uint16_t* bq,
                                          float (&sum)[4]) {
  uint32_t af[G][4], bf[(G + 1) / 2][4];
  float c[G][4];
  if (G == 1) {
    uint32_t b2[2];
    ldsm2(b2, bq);
    bf[0][0] = b2[0];
    bf[0][1] = b2[1];
  } else {
#pragma unroll
    for (int i = 0; i < G / 2; ++i) ldsm4(bf[i], bq + 32 * i);
  }
#pragma unroll
  for (int i = 0; i < G; ++i) {
    ldsm4(af[i], a + 16 * i);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
    mma16816(c[i], af[i], bf[i / 2][(i % 2) * 2], bf[i / 2][(i % 2) * 2 + 1]);
  }
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[e] = __fadd_rn(sum[e], c[i][e]);
}

// the tile's gate sums over all ks = H / 16 k-steps, in increasing k:
// sum[0], sum[1] at A row g (lane / 4) and batch rows 2 (lane % 4) and
// 2 (lane % 4) + 1, sum[2], sum[3] at A row g + 8 and the same rows.
// `a` points at this lane's ldmatrix row of the A tile (its row
// ((lane >> 3) & 1) * 8 + (lane & 7), column (lane >> 4) * 8), `bq` at its
// row of the B tile (row lane & 7, column (lane >> 3) * 8).
__device__ __forceinline__ void fwd_product(const uint16_t* a,
                                            const uint16_t* bq, int ks,
                                            float (&sum)[4]) {
  int s = 0;
  for (; s + 8 <= ks; s += 8) fwd_group<8>(a + 16 * s, bq + 16 * s, sum);
  for (; s + 2 <= ks; s += 2) fwd_group<2>(a + 16 * s, bq + 16 * s, sum);
  if (s < ks) fwd_group<1>(a + 16 * s, bq + 16 * s, sum);
}

// the forward's shared memory: G gate columns of its UB units and its RB
// rows of h, bf16 rows of H + PAD
inline size_t tile_fwd_smem(int gates, int H, int ub) {
  return 2 * (size_t)(gates * ub + THREADS / ub) * (H + PAD);
}

// ---- prologue ----------------------------------------------------------
//
// dst[m][co + n] = act(co + n, x[m][co + n] + sum_k bf16(a_m[k]) .
// bf16(w[k][co + n])) for m < M, n < N, k < K, where a_m = m < split ?
// a0 + m K : a1 + (m - split) K and every row of x, dst and w is ld
// floats: one GEMM over the L*b rows of all steps. A block takes the
// tiles blockIdx.x, + gridDim.x, ...; it keeps the tile's columns of W in
// shared memory (all K rows, bf16) while the next tile needs the same
// columns, and streams the tile's 64 rows of A in K chunks of 64 floats
// through a ring of three cp.async stages; each thread rounds the 16
// floats it copied to bf16, into one of two chunk tiles the fragments are
// read from.
template <typename Act>
__device__ void gate_gemm(const float* a0, const float* a1, int split, int M,
                          const float* w, const float* x, float* dst, int ld,
                          int co, int N, int K, Act act, uint16_t* sm) {
  uint16_t* bs = sm;                                        // [K][TNP]
  uint16_t* ab = bs + K * TNP;                              // [2][TM][KCP]
  float4* ar = reinterpret_cast<float4*>(ab + 2 * TM * KCP);  // [RING][..]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / 4, wn = warp % 4, g = lane >> 2, tq = lane & 3;
  const int mtiles = (M + TM - 1) / TM, ntiles = (N + TN - 1) / TN;
  const int chunks = (K + KC - 1) / KC;
  int staged = -1;
  for (int idx = blockIdx.x; idx < mtiles * ntiles; idx += gridDim.x) {
    const int nt = idx % ntiles, m0 = (idx / ntiles) * TM, n0 = nt * TN;
    // chunk kc of the tile's A rows: a thread copies 16 bytes of rows
    // tid / 16 + 16 i, columns (tid % 16) * 4 ..
    auto issue = [&](int kc) {
      float4* d = ar + (kc % RING) * TM * KC / 4;
      const int k = kc * KC + (tid % 16) * 4;
#pragma unroll
      for (int i = 0; i < TM / 16; ++i) {
        const int row = m0 + tid / 16 + 16 * i;
        const bool ok = row < M && k < K;
        const int rc = ok ? row : 0;
        cp_async16(d + i * THREADS + tid,
                   (rc < split ? a0 + (size_t)rc * K
                               : a1 + (size_t)(rc - split) * K) +
                       (ok ? k : 0),
                   ok);
      }
      cp_async_commit();
    };
    __syncthreads();   // the previous tile is read
    issue(0);
    if (chunks > 1)
      issue(1);
    else
      cp_async_commit();
    if (nt != staged) {
      batched<16>(
          K * (TN / 4),
          [&](int i) {
            const int n = n0 + (i % (TN / 4)) * 4;
            return n < N ? __ldg(reinterpret_cast<const float4*>(
                               w + (size_t)(i / (TN / 4)) * ld + co + n))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
          },
          [&](int i, float4 v) {
            *reinterpret_cast<uint2*>(bs + (i / (TN / 4)) * TNP +
                                      (i % (TN / 4)) * 4) = pack4(v);
          });
      staged = nt;
    }
    float acc[2][4][4] = {};
    for (int kc = 0; kc < chunks; ++kc) {
      cp_async_wait<1>();   // this thread's chunk kc has landed
      uint16_t* as = ab + (kc % 2) * TM * KCP;
      const float4* src = ar + (kc % RING) * TM * KC / 4;
#pragma unroll
      for (int i = 0; i < TM / 16; ++i)
        *reinterpret_cast<uint2*>(as + (tid / 16 + 16 * i) * KCP +
                                  (tid % 16) * 4) = pack4(src[i * THREADS +
                                                              tid]);
      __syncthreads();   // chunk kc is converted; chunk kc - 1 is read
      if (kc + 2 < chunks)
        issue(kc + 2);
      else
        cp_async_commit();
      auto kstep = [&](int kk) {
        uint32_t a[2][4], bq[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm4(a[mt], as + (wm * 32 + mt * 16 + ((lane >> 3) & 1) * 8 +
                             (lane & 7)) * KCP + kk + (lane >> 4) * 8);
        const int k = kc * KC + kk;
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldsm4_t(bq[np], bs + (k + ((lane >> 3) & 1) * 8 + (lane & 7)) * TNP +
                              wn * 32 + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt2 = 0; nt2 < 4; ++nt2)
            mma16816(acc[mt][nt2], a[mt], bq[nt2 / 2][(nt2 % 2) * 2],
                     bq[nt2 / 2][(nt2 % 2) * 2 + 1]);
      };
      if (kc * KC + KC <= K) {   // a full chunk: straight code
#pragma unroll
        for (int kk = 0; kk < KC; kk += 16) kstep(kk);
      } else {
        for (int kk = 0; kc * KC + kk < K; kk += 16) kstep(kk);
      }
    }
    // every x load of the tile before its first store
    float2 xv[2][4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt2 = 0; nt2 < 4; ++nt2)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm * 32 + mt * 16 + g + h * 8;
          const int col = n0 + wn * 32 + nt2 * 8 + 2 * tq;
          xv[mt][nt2][h] = row < M && col < N
                               ? __ldg(reinterpret_cast<const float2*>(
                                     x + (size_t)row * ld + co + col))
                               : make_float2(0.f, 0.f);
        }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt2 = 0; nt2 < 4; ++nt2)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm * 32 + mt * 16 + g + h * 8;
          const int col = n0 + wn * 32 + nt2 * 8 + 2 * tq;
          if (row < M && col < N)
            *reinterpret_cast<float2*>(dst + (size_t)row * ld + co + col) =
                make_float2(act(co + col, __fadd_rn(xv[mt][nt2][h].x,
                                                    acc[mt][nt2][2 * h])),
                            act(co + col + 1,
                                __fadd_rn(xv[mt][nt2][h].y,
                                          acc[mt][nt2][2 * h + 1])));
        }
  }
}

// ---- chain ---------------------------------------------------------------
//
// A chain block owns UB = 16 MT units and RB = 8 NT batch rows: it holds
// its units' rows of W (bf16, all G*H columns) and needs only its rows'
// dgates of every unit, which the blocks of its row group wrote.

// ws[u][n] = bf16(w[u][n]) for u < rows, n < ld
__device__ __forceinline__ void stage_w_rows(uint16_t* ws, int wp,
                                             const float* w, int rows,
                                             int ld) {
  const int q = ld / 4;
  batched<16>(
      rows * q,
      [&](int i) {
        return __ldg(reinterpret_cast<const float4*>(w + (size_t)(i / q) * ld +
                                                     (i % q) * 4));
      },
      [&](int i, float4 v) {
        *reinterpret_cast<uint2*>(ws + (i / q) * wp + (i % q) * 4) = pack4(v);
      });
}

// floats a row of the chain's staged dgates: all G*H columns, rows 8
// floats (32 B) apart modulo 128 B so that a warp's float2 reads of 4 rows
// x 4 pairs hit distinct banks
__host__ __device__ inline int xpitch(int gates, int H) {
  return gates * H + 8;
}

// xs[r][c] = dg[r][c] for r < RB (zero for r >= rows), c0 <= c < c1
// (c1 - c0 <= 8 THREADS): the block's rows of the dgates other blocks
// wrote in this launch, read from L2 (16 float4 loads a thread in flight,
// 8 rows at a time) into shared memory, xp floats a row. The caller's
// __syncthreads publishes them to the block.
template <int RB>
__device__ __forceinline__ void stage_dgates(float* xs, int xp,
                                             const float* dg, int ld,
                                             int rows, int c0, int c1) {
#pragma unroll
  for (int r0 = 0; r0 < RB; r0 += 8) {
    float4 v[8][2];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = (threadIdx.x + h * THREADS) * 4;
        v[r][h] = r0 + r < rows && c < c1 - c0
                      ? __ldcg(reinterpret_cast<const float4*>(
                            dg + (size_t)(r0 + r) * ld + c0 + c))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = (threadIdx.x + h * THREADS) * 4;
        if (c < c1 - c0)
          *reinterpret_cast<float4*>(xs + (r0 + r) * xp + c0 + c) = v[r][h];
      }
  }
}

// sum[mt][nt] += the products of G k-steps s = sb, sb + WARPS, ... (all
// valid): columns 16 s .. 16 s + 15 of ws's and xs's rows, each a fresh
// tensor-core sum of the three parts of xs (lo, then mid, then hi), the G
// k-steps' independent products side by side
template <int MT, int NT, int G>
__device__ __forceinline__ void chain_group(const uint16_t* ws, int wp,
                                            const float* xs, int xp, int sb,
                                            float (&sum)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  uint32_t a[G][MT][4], bp[G][NT][2][3];   // [k-step][n tile][reg][part]
  float c[G][MT][NT][4];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int s = sb + i * WARPS;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* x = xs + (nt * 8 + g) * xp + s * 16 + 2 * tq;
      const float2 v0 = *reinterpret_cast<const float2*>(x);
      const float2 v1 = *reinterpret_cast<const float2*>(x + 8);
      uint2 q[3];
      split_quad(make_float4(v0.x, v0.y, v1.x, v1.y), q);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        bp[i][nt][0][p] = q[p].x;
        bp[i][nt][1][p] = q[p].y;
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      ldsm4(a[i][mt], ws + (mt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                               wp + s * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][mt][nt][e] = 0.f;
    }
  }
#pragma unroll
  for (int p = 2; p >= 0; --p)
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma16816(c[i][mt][nt], a[i][mt], bp[i][nt][0][p], bp[i][nt][1][p]);
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sum[mt][nt][e] = __fadd_rn(sum[mt][nt][e], c[i][mt][nt][e]);
}

// sum[mt][nt] += this warp's part of xs . ws^T: the k-steps s = s0 + warp,
// s0 + warp + WARPS, ... < s1, in increasing s, in groups of four (straight
// code, so that the compiler can interleave them) and the rest one by one
template <int MT, int NT>
__device__ __forceinline__ void chain_product(const uint16_t* ws, int wp,
                                              const float* xs, int xp,
                                              int s0, int s1,
                                              float (&sum)[MT][NT][4]) {
  const int warp = threadIdx.x >> 5;
  const int n = s1 - s0 > warp ? (s1 - s0 - warp + WARPS - 1) / WARPS : 0;
  int i = 0;
  for (; i + 4 <= n; i += 4)
    chain_group<MT, NT, 4>(ws, wp, xs, xp, s0 + warp + i * WARPS, sum);
  for (; i < n; ++i)
    chain_group<MT, NT, 1>(ws, wp, xs, xp, s0 + warp + i * WARPS, sum);
}

// sum += the block's rows of dg . ws^T over the columns [c0, c1), read
// from L2 (other blocks wrote them in this launch) in two parts split at
// cm (each at most 4 THREADS columns): the products of [c0, cm) run while
// the loads of [cm, c1) are in flight. Per warp the k-steps come in
// increasing order within each part; the caller's __syncthreads before
// the next use of xs. A block of 16 rows stages both parts first.
template <int MT, int NT>
__device__ __forceinline__ void chain_staged(const uint16_t* ws, int wp,
                                             float* xs, int xp,
                                             const float* dg, int ld,
                                             int rows, int c0, int cm,
                                             int c1,
                                             float (&sum)[MT][NT][4]) {
  constexpr int RB = NT * 8;
  if (RB > 8) {
    stage_dgates<RB>(xs, xp, dg, ld, rows, c0, c1);
    __syncthreads();
    chain_product<MT, NT>(ws, wp, xs, xp, c0 / 16, cm / 16, sum);
    chain_product<MT, NT>(ws, wp, xs, xp, cm / 16, c1 / 16, sum);
    return;
  }
  const int c = threadIdx.x * 4;
  float4 va[8], vb[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    va[r] = r < rows && c < cm - c0
                ? __ldcg(reinterpret_cast<const float4*>(dg + (size_t)r * ld +
                                                         c0 + c))
                : make_float4(0.f, 0.f, 0.f, 0.f);
    vb[r] = r < rows && c < c1 - cm
                ? __ldcg(reinterpret_cast<const float4*>(dg + (size_t)r * ld +
                                                         cm + c))
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
    if (c < cm - c0) *reinterpret_cast<float4*>(xs + r * xp + c0 + c) = va[r];
  __syncthreads();
  chain_product<MT, NT>(ws, wp, xs, xp, c0 / 16, cm / 16, sum);
#pragma unroll
  for (int r = 0; r < 8; ++r)
    if (c < c1 - cm) *reinterpret_cast<float4*>(xs + r * xp + cm + c) = vb[r];
  __syncthreads();
  chain_product<MT, NT>(ws, wp, xs, xp, cm / 16, c1 / 16, sum);
}

// the block's sum for cell (unit, row): every warp's part, added in warp
// order. part holds WARPS x UB x RB floats; the caller makes sure no thread
// still reads an earlier use (a grid barrier lies between two calls).
template <int MT, int NT>
__device__ __forceinline__ float chain_reduce(const float (&sum)[MT][NT][4],
                                              float* part, int unit,
                                              int row) {
  constexpr int CELLS = MT * 16 * NT * 8, RB = NT * 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[warp * CELLS + (mt * 16 + g + (e / 2) * 8) * RB + nt * 8 +
             2 * tq + e % 2] = sum[mt][nt][e];
  __syncthreads();
  float s = part[unit * RB + row];
  for (int w = 1; w < WARPS; ++w)
    s = __fadd_rn(s, part[w * CELLS + unit * RB + row]);
  return s;
}

// ---- epilogue ------------------------------------------------------------
//
// dw[m][co + n] = sum over t = L-1 .. 0 of bf16(sum_{r < b} bf16(a_t[r][m])
// d_t[r][co + n]) for the tile m0 .. m0 + TM, n0 .. n0 + TN (m < K, n < N),
// with a_t = t < shift ? a0 : a1 + (t - shift) b K and d_t = dx + t b ld:
// each step a fresh accumulator over K = b (the three parts of d_t),
// rounded to bf16 before it is added, t descending as the reference's scan
// adds. A step's operands, 16 KS rows (b padded with zeros) of 16 float4
// of A and 32 of D, are copied (cp.async) into a ring of three float32
// stages two steps ahead; each thread converts the KS chunks of A and 2 KS
// of D it copied into the bf16 tiles the products read.
template <int KS>
__device__ void dw_tile(const float* a0, const float* a1, int shift,
                        const float* dx, float* dw, int ld, int co, int N,
                        int K, int L, int b, int m0, int n0, uint16_t* sm) {
  constexpr int ROWS = 16 * KS, CHUNKS = 48 * ROWS, PER = CHUNKS / THREADS;
  constexpr int ABUF = ROWS * TMP, DBUF = ROWS * TNP;
  float4* raw = reinterpret_cast<float4*>(sm);            // [RING][CHUNKS]
  uint16_t* st = sm + RING * CHUNKS * 8;                  // A, 3 D planes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / 4, wn = warp % 4, g = lane >> 2, tq = lane & 3;
  // chunk i of a thread: A row q / 16 (i < KS) or D row q / 32, q = tid +
  // THREADS i (counted from the first D chunk for D)
  auto issue = [&](int t, float4* dst) {
    const float* at = t < shift ? a0 : a1 + (size_t)(t - shift) * b * K;
    const float* dt = dx + (size_t)t * b * ld + co;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      if (i < KS) {
        const int q = tid + i * THREADS, r = q / 16, m = m0 + (q % 16) * 4;
        cp_async16(dst + i * THREADS + tid,
                   at + (size_t)min(r, b - 1) * K + min(m, K - 4),
                   r < b && m < K);
      } else {
        const int q = tid + (i - KS) * THREADS, r = q / 32;
        const int n = n0 + (q % 32) * 4;
        cp_async16(dst + i * THREADS + tid,
                   dt + (size_t)min(r, b - 1) * ld + min(n, N - 4),
                   r < b && n < N);
      }
    }
    cp_async_commit();
  };
  float acc[2][4][4] = {};
  __syncthreads();   // no thread still reads the previous stage's memory
  issue(L - 1, raw);
  if (L > 1)
    issue(L - 2, raw + CHUNKS);
  else
    cp_async_commit();
  for (int k = 0; k < L; ++k) {
    const int t = L - 1 - k;
    if (t >= 2)
      issue(t - 2, raw + ((k + 2) % RING) * CHUNKS);
    else
      cp_async_commit();   // an empty group keeps the count
    cp_async_wait<2>();    // this thread's copies of step t have landed
    __syncthreads();       // every warp is done with step t+1's tiles
    const float4* src = raw + (k % RING) * CHUNKS;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float4 v = src[i * THREADS + tid];
      if (i < KS) {
        const int q = tid + i * THREADS;
        *reinterpret_cast<uint2*>(st + (q / 16) * TMP + (q % 16) * 4) =
            pack4(v);
      } else {
        const int q = tid + (i - KS) * THREADS;
        uint2 pq[3];
        split_quad(v, pq);
        uint16_t* d = st + ABUF + (q / 32) * TNP + (q % 32) * 4;
#pragma unroll
        for (int p = 0; p < 3; ++p)
          *reinterpret_cast<uint2*>(d + p * DBUF) = pq[p];
      }
    }
    __syncthreads();
    float c[2][4][4] = {};
#pragma unroll
    for (int kk = 0; kk < ROWS; kk += 16) {
      uint32_t a[2][4], bq[3][2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm4_t(a[mt], st + (kk + (lane >> 4) * 8 + (lane & 7)) * TMP +
                           wm * 32 + mt * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldsm4_t(bq[p][np], st + ABUF + p * DBUF +
                                 (kk + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                     TNP +
                                 wn * 32 + np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int p = 2; p >= 0; --p)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma16816(c[mt][nt], a[mt], bq[p][nt / 2][(nt % 2) * 2],
                     bq[p][nt / 2][(nt % 2) * 2 + 1]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const float2 r = bf16r2(c[mt][nt][e], c[mt][nt][e + 1]);
          acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], r.x);
          acc[mt][nt][e + 1] = __fadd_rn(acc[mt][nt][e + 1], r.y);
        }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + mt * 16 + g + h * 8;
        const int n = n0 + wn * 32 + nt * 8 + 2 * tq;
        if (m < K && n < N)
          *reinterpret_cast<float2*>(dw + (size_t)m * ld + co + n) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
}

// dw_tile at the batch's k16 steps
__device__ __forceinline__ void dw_tile_b(const float* a0, const float* a1,
                                          int shift, const float* dx,
                                          float* dw, int ld, int co, int N,
                                          int K, int L, int b, int m0, int n0,
                                          uint16_t* sm) {
  switch ((b + 15) / 16) {
    case 1: dw_tile<1>(a0, a1, shift, dx, dw, ld, co, N, K, L, b, m0, n0, sm);
      break;
    case 2: dw_tile<2>(a0, a1, shift, dx, dw, ld, co, N, K, L, b, m0, n0, sm);
      break;
    case 3: dw_tile<3>(a0, a1, shift, dx, dw, ld, co, N, K, L, b, m0, n0, sm);
      break;
    default:
      dw_tile<4>(a0, a1, shift, dx, dw, ld, co, N, K, L, b, m0, n0, sm);
  }
}

// the chain's shared memory: its units' rows of W (bf16), its rows'
// dgates (float32) and the warps' partial sums
inline size_t chain_smem(int gates, int H, int ub) {
  const size_t wp = gates * H + PAD, rb = THREADS / ub;
  return 2 * ub * wp + 4 * rb * xpitch(gates, H) + 4 * WARPS * THREADS;
}

// the backward's shared memory: the largest of its three stages
inline size_t bwd_smem(int gates, int H, int b, int ub) {
  const size_t prologue =
      2 * ((size_t)H * TNP + 2 * TM * KCP) + 4 * RING * TM * KC;
  const size_t rows = (b + 15) / 16 * 16;
  const size_t epilogue = 16 * RING * 48 * rows +
                          2 * (rows * TMP + 3 * rows * TNP);
  return std::max(prologue, std::max(chain_smem(gates, H, ub), epilogue));
}

}  // namespace seqmma
