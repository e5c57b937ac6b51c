// paged_attention: one decode step's attention for every slot of the batch,
// straight through the paged KV arena, for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py::paged_attention_pallas
// (kernel _paged_attn_kernel :53, pallas_call :129). For each slot s and
// head h: walk the slot's block table bt[s, p / bs] for the positions
// p < ctx_lens[s], score q[s, h]·k[p] * scale (the scale applied after the
// dot, scale = D^-0.5 from the wrapper), keep an online softmax (running
// max, normalizer and weighted sum of v[p]) and write acc / l. A slot with
// ctx_lens[s] == 0 writes exact zeros. The gathered context is never
// materialized: K and V rows are read from the arena where the table
// points.
//
// Design (flash-decoding). The Pallas grid (S, P) runs one arena block per
// sequential grid step and carries the online state in scratch. Here a
// slot's context is cut into partitions of `part` = part_blocks * bs
// positions, a whole number of KV blocks, and one 128-thread CTA owns a
// (slot, head, partition): grid (S * H, nsplit), nsplit =
// ceil(P / part_blocks), a function of the static shapes alone. So a long
// context spreads over many CTAs and no CTA's walk is longer than one
// partition: the launch no longer lasts as long as its longest slot. A CTA
// reads its partition's table entries into shared memory once. Its 4 warps
// take the partition's positions in turns, UNROLL at a time: a warp issues
// the K rows' AND the V rows' loads of its UNROLL positions together (as
// float4 where D % 4 == 0 and the tensors are 16-byte aligned, else as
// floats), then reduces the partial dots with shuffles and folds them into
// its online state, so no load waits on the softmax. Lane l holds vectors
// c = l + 32 j of q and of the accumulator (j < NE), so a row is read with
// coalesced loads and any D up to 256 runs. The warps' states merge through
// shared memory in warp order.
//   nsplit == 1 (the serving lane's tables): the CTA writes acc / l into
// out; one launch, no workspace.
//   nsplit > 1: each CTA writes its partition's (m, l, acc) to a float32
// workspace (the wrapper allocates it); a CTA whose partition starts at or
// past the slot's context writes the empty state (m = -inf, l = 0) and
// exits. A second small kernel, one CTA per (slot, head), merges the live
// partitions in partition order: out = sum_i exp(m_i - M) acc_i /
// sum_i exp(m_i - M) l_i, M = max_i m_i; an idle slot writes zeros. No sum
// uses atomics, and every order is fixed by the slot's own context: a
// slot's output is the same bits whichever other slots share the batch and
// in whatever order the CTAs run.
//
// Bound on the H100: bytes. The function reads each live K and V row once
// (2 * sum(ctx) * H * D * 4 bytes) plus q and writes out (2 * S * H * D *
// 4), against 3.35 TB/s; its operations (4 flops per element of the live
// context) are two orders of magnitude below float32's peak, so the CUDA
// cores in float32 are right and the tensor cores are not needed. The
// workspace adds (D + 2) * 4 bytes per live partition each way, under 1%
// at partitions of 256 positions and D 128. At the serving lane's geometry
// (ctx <= 128) the launch sets the time.
//
// Numerics: the online softmax and the merge re-associate the reduction,
// so the result agrees with the plain version (ops/cuda/paged_attention.py
// ::paged_attention_torch, gather + masked softmax) to float32 roundings,
// not bitwise, as the Pallas kernel agrees with its jnp twin;
// paged_attention_split_torch models the decomposition on the CPU.
//
// The C entry returns cudaGetLastError() after the launches. The kernels
// allocate nothing; block-table entries of live positions must lie in
// [0, num_blocks).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 4;          // positions a warp has in flight
constexpr int MAX_D = 256;
constexpr int MAX_PART_BLOCKS = 512;

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<1> {
  using T = float;
};

__device__ __forceinline__ float dot(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float dot(float a, float b, float acc) {
  return fmaf(a, b, acc);
}
__device__ __forceinline__ void axpy(float w, float4 v, float4& acc) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}
__device__ __forceinline__ void axpy(float w, float v, float& acc) {
  acc = fmaf(w, v, acc);
}
__device__ __forceinline__ void scale_by(float4& a, float c) {
  a.x *= c;
  a.y *= c;
  a.z *= c;
  a.w *= c;
}
__device__ __forceinline__ void scale_by(float& a, float c) { a *= c; }
template <class V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}

// One (slot, head) = blockIdx.x, partition blockIdx.y of part_blocks table
// entries. ws_ml / ws_acc: [S * H, nsplit, 2] and [S * H, nsplit, D], used
// only when gridDim.y > 1.
template <int VEC, int NE>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ kc,
                       const float* __restrict__ vc,
                       const int* __restrict__ bt,
                       const int* __restrict__ ctx_lens,
                       float* __restrict__ out, float* __restrict__ ws_ml,
                       float* __restrict__ ws_acc, int H, int D, int bs,
                       int P, int part_blocks, float scale) {
  using V = typename Vec<VEC>::T;
  __shared__ float sm_m[WARPS];
  __shared__ float sm_l[WARPS];
  __shared__ __align__(16) float sm_acc[WARPS][MAX_D];
  __shared__ int sm_blk[MAX_PART_BLOCKS];

  const int sh = blockIdx.x;  // s * H + h
  const int s = sh / H;
  const int h = sh - s * H;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long qoff = static_cast<long long>(sh) * D;
  const long long wsi = static_cast<long long>(sh) * nsplit + split;
  const int ctx = min(ctx_lens[s], P * bs);
  const int part = part_blocks * bs;
  const int p0 = split * part;
  const int p1 = min(ctx, p0 + part);
  if (p0 >= p1) {
    // an idle slot, or a partition wholly past the slot's context
    if (nsplit == 1) {
      for (int d = threadIdx.x; d < D; d += THREADS) out[qoff + d] = 0.f;
    } else if (threadIdx.x == 0) {
      ws_ml[2 * wsi] = -INFINITY;
      ws_ml[2 * wsi + 1] = 0.f;
    }
    return;
  }

  // the partition's table entries, read once
  const int* btr = bt + static_cast<long long>(s) * P + split * part_blocks;
  const int nblk = (p1 - p0 + bs - 1) / bs;
  for (int i = threadIdx.x; i < nblk; i += THREADS) sm_blk[i] = btr[i];

  const int nv = D / VEC;  // vectors in a row
  const V* q4 = reinterpret_cast<const V*>(q + qoff);
  V qr[NE];
  V acc[NE];
#pragma unroll
  for (int j = 0; j < NE; ++j) {
    const int c = lane + 32 * j;
    qr[j] = c < nv ? q4[c] : zero<V>();
    acc[j] = zero<V>();
  }
  float m = -INFINITY;
  float l = 0.f;
  const long long pos_stride = static_cast<long long>(H) * D;
  const long long head_off = static_cast<long long>(h) * D;
  __syncthreads();

  for (int base = p0 + warp * UNROLL; base < p1; base += WARPS * UNROLL) {
    long long off[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int p = base + u;
      off[u] = -1;
      if (p < p1) {
        const int r = p - p0;
        const long long blk = sm_blk[r / bs];
        off[u] = (blk * bs + r % bs) * pos_stride + head_off;
      }
    }
    // every K and V load of the UNROLL positions issued before any use
    V kr[UNROLL][NE];
    V vr[UNROLL][NE];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const V* k4 = reinterpret_cast<const V*>(kc + (off[u] < 0 ? 0 : off[u]));
      const V* v4 = reinterpret_cast<const V*>(vc + (off[u] < 0 ? 0 : off[u]));
#pragma unroll
      for (int j = 0; j < NE; ++j) {
        const int c = lane + 32 * j;
        const bool live = off[u] >= 0 && c < nv;
        kr[u][j] = live ? k4[c] : zero<V>();
        vr[u][j] = live ? v4[c] : zero<V>();
      }
    }
    float sc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float part_dot = 0.f;
#pragma unroll
      for (int j = 0; j < NE; ++j) part_dot = dot(qr[j], kr[u][j], part_dot);
      sc[u] = part_dot;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], w);
    }
    // position base < p1 is live, so mx is finite: a masked score gives
    // exp(-inf - mx) == 0, and the first update's correction exp(-inf -
    // mx) zeroes the (all-zero) initial state exactly
    float mx = m;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      sc[u] = off[u] >= 0 ? sc[u] * scale : -INFINITY;
      mx = fmaxf(mx, sc[u]);
    }
    const float corr = expf(m - mx);
    l *= corr;
#pragma unroll
    for (int j = 0; j < NE; ++j) scale_by(acc[j], corr);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (off[u] < 0) continue;
      const float w = expf(sc[u] - mx);
      l += w;
#pragma unroll
      for (int j = 0; j < NE; ++j) axpy(w, vr[u][j], acc[j]);
    }
    m = mx;
  }

  // merge the warps' states in warp order; a warp that saw no position
  // holds m = -inf, l = 0, acc = 0 and weighs exp(-inf - M) == 0
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  V* sacc = reinterpret_cast<V*>(sm_acc[warp]);
#pragma unroll
  for (int j = 0; j < NE; ++j) {
    const int c = lane + 32 * j;
    if (c < nv) sacc[c] = acc[j];
  }
  __syncthreads();
  float M = -INFINITY;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w]);
  float f[WARPS];
  float L = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    f[w] = expf(sm_m[w] - M);
    L = fmaf(f[w], sm_l[w], L);
  }
  if (nsplit == 1) {
    for (int d = threadIdx.x; d < D; d += THREADS) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) a = fmaf(f[w], sm_acc[w][d], a);
      out[qoff + d] = a / L;
    }
    return;
  }
  float* wacc = ws_acc + wsi * D;
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a = fmaf(f[w], sm_acc[w][d], a);
    wacc[d] = a;
  }
  if (threadIdx.x == 0) {
    ws_ml[2 * wsi] = M;
    ws_ml[2 * wsi + 1] = L;
  }
}

// One CTA per (slot, head): the live partitions' states merged in
// partition order into out; an idle slot writes zeros.
__global__ void __launch_bounds__(THREADS)
paged_attention_merge(const int* __restrict__ ctx_lens,
                      const float* __restrict__ ws_ml,
                      const float* __restrict__ ws_acc,
                      float* __restrict__ out, int H, int D, int bs, int P,
                      int part_blocks, int nsplit) {
  const int sh = blockIdx.x;
  const int s = sh / H;
  float* o = out + static_cast<long long>(sh) * D;
  const int ctx = min(ctx_lens[s], P * bs);
  if (ctx <= 0) {
    for (int d = threadIdx.x; d < D; d += THREADS) o[d] = 0.f;
    return;
  }
  const int part = part_blocks * bs;
  const int live = (ctx + part - 1) / part;  // partitions holding positions
  const float* ml = ws_ml + 2LL * sh * nsplit;
  const float* acc = ws_acc + static_cast<long long>(sh) * nsplit * D;
  float M = -INFINITY;
  for (int i = 0; i < live; ++i) M = fmaxf(M, ml[2 * i]);
  float L = 0.f;
  for (int i = 0; i < live; ++i) L = fmaf(expf(ml[2 * i] - M), ml[2 * i + 1], L);
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float a = 0.f;
    for (int i = 0; i < live; ++i)
      a = fmaf(expf(ml[2 * i] - M), acc[static_cast<long long>(i) * D + d], a);
    o[d] = a / L;
  }
}

template <int VEC, int NE>
void launch(const float* q, const float* k, const float* v, const int* bt,
            const int* cl, float* out, float* ws, int S, int H, int D,
            int bs, int P, int part_blocks, int nsplit, float scale,
            cudaStream_t st) {
  const long long rows = static_cast<long long>(S) * H;
  float* ws_ml = ws;
  float* ws_acc = ws ? ws + 2 * rows * nsplit : nullptr;
  paged_attention_kernel<VEC, NE><<<dim3(S * H, nsplit), THREADS, 0, st>>>(
      q, k, v, bt, cl, out, ws_ml, ws_acc, H, D, bs, P, part_blocks, scale);
  if (nsplit > 1)
    paged_attention_merge<<<S * H, THREADS, 0, st>>>(
        cl, ws_ml, ws_acc, out, H, D, bs, P, part_blocks, nsplit);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// q: [S, H, D] float32; k, v: [num_blocks, bs, H, D] float32 arenas;
// bt: [S, P] int32 block tables; cl: [S] int32 context lengths; out:
// [S, H, D] float32; part_blocks: table entries a partition (1..512); ws:
// S * H * nsplit * (D + 2) float32 of workspace where nsplit =
// ceil(P / part_blocks) > 1, else unused (may be null).
// All contiguous, on the device of the stream. Returns cudaGetLastError()
// (0 = success).
int paged_attention(const float* q, const float* k, const float* v,
                    const int* bt, const int* cl, float* out, float* ws,
                    int S, int H, int D, int bs, int P, int part_blocks,
                    float scale, void* stream) {
  if (S < 1 || H < 1 || D < 1 || D > MAX_D || bs < 1 || P < 1 ||
      part_blocks < 1 || part_blocks > MAX_PART_BLOCKS ||
      static_cast<long long>(S) * H > 0x7fffffffLL ||
      static_cast<long long>(P) * bs > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (P + part_blocks - 1) / part_blocks;
  if (nsplit > 65535 || (nsplit > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec4 = D % 4 == 0 && aligned16(q) && aligned16(k) &&
                    aligned16(v) && aligned16(out);
#define PA_ARGS q, k, v, bt, cl, out, ws, S, H, D, bs, P, part_blocks, \
                nsplit, scale, st
  if (vec4) {
    switch ((D / 4 + 31) / 32) {
      case 1: launch<4, 1>(PA_ARGS); break;
      case 2: launch<4, 2>(PA_ARGS); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch ((D + 31) / 32) {
      case 1: launch<1, 1>(PA_ARGS); break;
      case 2: launch<1, 2>(PA_ARGS); break;
      case 3: launch<1, 3>(PA_ARGS); break;
      case 4: launch<1, 4>(PA_ARGS); break;
      case 5: launch<1, 5>(PA_ARGS); break;
      case 6: launch<1, 6>(PA_ARGS); break;
      case 7: launch<1, 7>(PA_ARGS); break;
      case 8: launch<1, 8>(PA_ARGS); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef PA_ARGS
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
