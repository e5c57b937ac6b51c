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
// Design. The Pallas grid (S, P) runs one arena block per sequential grid
// step and carries the online state in scratch; here one 128-thread CTA
// owns a (slot, head) and loops over that slot's live positions itself, so
// no state crosses blocks. Its 4 warps take the positions in turn, UNROLL
// at a time: each warp issues the UNROLL K rows' loads together, reduces
// the UNROLL partial dots with shuffles, and folds them into its own online
// state. Lane l holds elements d = l + 32 j (j < NE = ceil(D / 32)) of q
// and of the accumulator, so one row's load is NE coalesced 128-byte reads
// and lanes past D hold nothing: any D up to 256 runs. At the end the 4
// warps' states merge through shared memory. A (slot, head) result depends
// on nothing of any other slot, so a slot's output is the same bits
// whichever other slots share the batch.
//
// Bound on the H100: bytes. The function reads each live K and V row once
// (2 * sum(ctx) * H * D * 4 bytes) plus q and writes out (2 * S * H * D *
// 4), against 3.35 TB/s; its operations (4 flops per element of the live
// context) are two orders of magnitude below float32's peak. At the
// serving lane's geometry (ctx <= 31) the launch sets the time. Work is
// ragged: a CTA's time is its slot's context length, so the longest slot
// bounds the launch; splitting a long context over several CTAs
// (flash-decoding) and staging blocks with cp.async or TMA are open work.
//
// Numerics: the online softmax re-associates the reduction, so the result
// agrees with the plain version (ops/cuda/paged_attention.py::
// paged_attention_torch, gather + masked softmax) to float32 roundings,
// not bitwise, as the Pallas kernel agrees with its jnp twin.
//
// The C entry returns cudaGetLastError() after the launch. The kernel
// allocates nothing; block-table entries of live positions must lie in
// [0, num_blocks).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 4;
constexpr int MAX_D = 256;

template <int NE>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ kc,
                       const float* __restrict__ vc,
                       const int* __restrict__ bt,
                       const int* __restrict__ ctx_lens,
                       float* __restrict__ out, int H, int D, int bs, int P,
                       float scale) {
  __shared__ float sm_m[WARPS];
  __shared__ float sm_l[WARPS];
  __shared__ float sm_acc[WARPS][MAX_D];

  const int sh = blockIdx.x;  // s * H + h
  const int s = sh / H;
  const int h = sh - s * H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long qoff = static_cast<long long>(sh) * D;
  float* o = out + qoff;
  int ctx = ctx_lens[s];
  ctx = min(ctx, P * bs);
  if (ctx <= 0) {
    for (int d = threadIdx.x; d < D; d += THREADS) o[d] = 0.f;
    return;
  }

  float qr[NE];
  float acc[NE];
#pragma unroll
  for (int j = 0; j < NE; ++j) {
    const int d = lane + 32 * j;
    qr[j] = d < D ? q[qoff + d] : 0.f;
    acc[j] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;
  const int* btr = bt + static_cast<long long>(s) * P;
  const long long pos_stride = static_cast<long long>(H) * D;
  const long long head_off = static_cast<long long>(h) * D;

  for (int base = warp * UNROLL; base < ctx; base += WARPS * UNROLL) {
    long long off[UNROLL];
    float sc[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int p = base + u;
      off[u] = -1;
      if (p < ctx) {
        const long long blk = btr[p / bs];
        off[u] = (blk * bs + p % bs) * pos_stride + head_off;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float part = 0.f;
      if (off[u] >= 0) {
        const float* kr = kc + off[u];
#pragma unroll
        for (int j = 0; j < NE; ++j) {
          const int d = lane + 32 * j;
          if (d < D) part = fmaf(qr[j], kr[d], part);
        }
      }
      sc[u] = part;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], w);
    }
    // position base < ctx is live, so mx is finite: a masked score gives
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
    for (int j = 0; j < NE; ++j) acc[j] *= corr;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (off[u] < 0) continue;
      const float w = expf(sc[u] - mx);
      l += w;
      const float* vr = vc + off[u];
#pragma unroll
      for (int j = 0; j < NE; ++j) {
        const int d = lane + 32 * j;
        if (d < D) acc[j] = fmaf(w, vr[d], acc[j]);
      }
    }
    m = mx;
  }

  // merge the warps' states; a warp that saw no position holds m = -inf,
  // l = 0, acc = 0 and weighs exp(-inf - M) == 0
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < NE; ++j) {
    const int d = lane + 32 * j;
    if (d < D) sm_acc[warp][d] = acc[j];
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
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a = fmaf(f[w], sm_acc[w][d], a);
    o[d] = a / L;
  }
}

template <int NE>
void launch(const float* q, const float* k, const float* v, const int* bt,
            const int* cl, float* out, int S, int H, int D, int bs, int P,
            float scale, cudaStream_t st) {
  paged_attention_kernel<NE><<<S * H, THREADS, 0, st>>>(q, k, v, bt, cl, out,
                                                         H, D, bs, P, scale);
}

}  // namespace

extern "C" {

// q: [S, H, D] float32; k, v: [num_blocks, bs, H, D] float32 arenas;
// bt: [S, P] int32 block tables; cl: [S] int32 context lengths; out:
// [S, H, D] float32. All contiguous, on the device of the stream. Returns
// cudaGetLastError() (0 = success).
int paged_attention(const float* q, const float* k, const float* v,
                    const int* bt, const int* cl, float* out, int S, int H,
                    int D, int bs, int P, float scale, void* stream) {
  if (S < 1 || H < 1 || D < 1 || D > MAX_D || bs < 1 || P < 1 ||
      static_cast<long long>(S) * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 31) / 32) {
    case 1: launch<1>(q, k, v, bt, cl, out, S, H, D, bs, P, scale, st); break;
    case 2: launch<2>(q, k, v, bt, cl, out, S, H, D, bs, P, scale, st); break;
    case 3: launch<3>(q, k, v, bt, cl, out, S, H, D, bs, P, scale, st); break;
    case 4: launch<4>(q, k, v, bt, cl, out, S, H, D, bs, P, scale, st); break;
    case 5: launch<5>(q, k, v, bt, cl, out, S, H, D, bs, P, scale, st); break;
    case 6: launch<6>(q, k, v, bt, cl, out, S, H, D, bs, P, scale, st); break;
    case 7: launch<7>(q, k, v, bt, cl, out, S, H, D, bs, P, scale, st); break;
    case 8: launch<8>(q, k, v, bt, cl, out, S, H, D, bs, P, scale, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
