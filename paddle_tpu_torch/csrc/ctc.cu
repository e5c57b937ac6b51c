// ctc: the CTC alpha recurrence (the loss) and its backward, ONE launch
// each, for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas/ctc.py::ctc_alpha_pallas (kernel
// _ctc_alpha_kernel: one program per batch row, alpha resident across all
// T steps, as warp-ctc keeps it in shared memory) and the backward the
// reference takes as jax.vjp of its scan (ops/ctc_ops.py:155).
//
// Forward, per row, from logp [T, C] and the labels alone (the Pallas
// kernel takes e, the masks and alpha_0 from XLA code around it; here they
// are formed in shared memory, as the backward forms them):
//   alpha_t[s] = valid[s] ? lae(lae(a[s], a[s-1]), skip[s] ? a[s-2] : NEG)
//                           + logp[t][z[s]] : NEG      (a = alpha_{t-1})
// for t = 1 .. x_len-1, and loss = -lae(alpha[2U'], alpha[2U'-1]) at
// t = x_len-1 (U' the row's label length); 1e30 (-NEG) where x_len is
// outside 1..T, where the scan selects no final. lae is jnp.logaddexp
// written as the reference computes it: max(a, b) + log1p(exp(-|a - b|)),
// a + b where a - b is nan, every operation rounded explicitly.
//
// Backward, per row, from logp and the labels alone: the extended labels,
// the masks and alpha_0 are formed in shared memory as the forward forms
// them, alpha_0..alpha_{x_len-1} are
// recomputed through the forward's code, then the scan's adjoint is walked
// back from the loss: logaddexp's gradient is jax's custom jvp,
// g*exp(x - out) for each operand, so the backward is autograd of the scan
// (not the alpha-beta formula; the two differ in rounding, and where a row
// is too short for its labels every state is -1e30, each weight is 1 and
// the scan's gradient grows threefold a step, as the reference's does). At
// each t the cotangent of the emissions is scattered onto the classes
// (dlogp[t][c] = sum of de[t][s] over z[s] == c, in increasing s) and taken
// through the log-softmax: dlogits = dlogp - exp(logp) * sum_c dlogp (the
// classes summed in increasing c); dlogp is 0 at t >= x_len. Autograd of
// the scan also adds 0 * weight for each final it computes and does not
// select and for each step after x_len - 1, and reads +inf as 0 in the
// weights (logaddexp's custom jvp): the kernel does the same, so that a
// NaN or an infinity reaches the elements it reaches in the reference.
//
// Design of both. One block of 8 warps per row. Only what depends on the
// step before it stays on the serial chain, which runs on the first warps,
// a state a thread (up to Sp 128; K states a thread beyond), each thread's
// states and masks in registers, one named barrier of the chain's threads
// a step (chain_step, which both kernels call); the other warps produce,
// and a block barrier separates chunks of steps.
//
// The forward is the backward's stage (a) without the weights: the chain
// takes alpha_1 .. alpha_tr, exchanging a[s-1] and a[s-2] through two rows
// of shared memory, while the producers gather the emissions logp[t][z[s]]
// a chunk of steps ahead (eight loads of a thread in flight), so that no
// load from device memory is on the chain; then one thread takes the loss
// from alpha_tr's row. It replaces the first version, which ran every step
// behind a block barrier on 256 threads, read each step's emissions from a
// materialised e [b, T, Sp] on the chain, and took e, the masks, alpha_0
// and the final of one-frame rows from a dozen torch launches before it
// (0.1088 ms for the kernel alone at b 64, T 200, C 29, Sp 104 on the
// H100); its loss is bitwise the first version's.
//
// The backward's stages:
// (a) the recompute: alpha_t from alpha_{t-1} (a ring of two chunks in
//     shared memory) and the emissions logp[t][z[s]], which the
//     producers gather a chunk ahead; the chain also forms step t's
//     adjoint weights exp(inner - merged), exp(a[s] - inner),
//     exp(a[s-1] - inner), exp(a[s-2] - merged) from the two logaddexp
//     it just took (inner, merged) and writes them to a per-row scratch
//     in global memory (L2-resident): they hang off its dependency and
//     fill its latency (producers forming them from shared memory took
//     longer than the chain, on the H100);
// (b) the producers form each step's finals' weights a chunk behind;
// (c) the adjoint, t = x_len-1 .. 1: per state the mask, four products
//     and the gather g0[s] + g1[s+1] + g2[s+2] through shared memory;
//     the producers stage each chunk's weights back into shared memory a
//     chunk ahead; the chain writes each step's emission cotangent (the
//     masked cotangent of alpha_t) to the scratch;
// (d) the emission epilogue, after the adjoint, every warp: the class
//     scatter, a class's label positions listed once a row in increasing
//     s and walked by the lanes of a warp over other steps (the blank's
//     list is the long one), then the log-softmax.
// One thread's states, or the lanes of a warp that take log1pf's two
// paths, do not overlap: two logaddexp a step are the chain's floor
// (ctc_chain_floor). Every operation and every sum is the first
// version's, in its order (explicit roundings, no contraction into FMA),
// so dlogits are bitwise the first version's on finite inputs; it ran
// every step of all four parts behind block barriers on 256 threads, alpha
// in global memory (0.546 ms a call at b 64, T 200, C 29, Sp 104 on the
// H100).
//
// Bound on the H100: neither bytes nor operations. The CTC model's batch
// (b 64, T <= 200, Sp 104, C 29) reads ~5 MB and runs ~10^7 exp/log1p;
// each row is a chain of x_len dependent steps in the forward (two
// logaddexp and the emission's add) and 2 x_len in the backward (the
// recompute's, then the adjoint's products and adds), whose latency bounds
// them (ctc_chain_floor runs either chain alone). One block per row runs
// the rows in parallel on 64 SMs.
//
// The C entries return cudaGetLastError() after the launch (0 = success);
// the caller allocates every output and scratch and passes its stream.

#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int THREADS = 256;

__device__ __forceinline__ float lae(float a, float b) {
  const float d = __fsub_rn(a, b);
  if (isnan(d)) return __fadd_rn(a, b);
  return __fadd_rn(fmaxf(a, b), log1pf(expf(-fabsf(d))));
}

// +inf read as 0, as logaddexp's custom jvp reads its operands and output
__device__ __forceinline__ float rinf(float v) {
  return v == INFINITY ? 0.f : v;
}

__device__ __forceinline__ float final_of(const float* a, int ylen) {
  const int last = 2 * ylen;
  return lae(a[last], ylen > 0 ? a[last - 1] : NEG);
}

// a kernel's block: the first warps run the serial chain, as many as hold
// a state a thread (at most MAX_CHAIN threads, K states a thread beyond),
// the others produce
constexpr int MAX_CHAIN = 128;

__host__ __device__ inline int chain_threads(int sp) {
  return sp < MAX_CHAIN ? (sp + 31) / 32 * 32 : MAX_CHAIN;
}

// a barrier of the n threads of one group (id 1 the chain's, 2 the
// producers'), a multiple of 32
template <int ID>
__device__ __forceinline__ void group_sync(int n) {
  asm volatile("bar.sync %0, %1;" ::"n"(ID), "r"(n) : "memory");
}

// a chunk's share of the shared memory, at most RING_BYTES
constexpr int RING_BYTES = 96 * 1024;

__host__ __device__ inline int clamp_to(int v, int lo, int hi) {
  return v < lo ? lo : v > hi ? hi : v;
}

// steps a chunk holds: two chunks of weights (a float4 a state) in the
// adjoint; two of alpha and two of emissions in the recompute; two of
// emissions in the forward
__host__ __device__ inline int chunk_steps(int sp) {
  return clamp_to(RING_BYTES / (32 * sp), 1, 16);
}

// the floats of the region the stages share, a multiple of 4: the
// chunks, or one step of the epilogue (de at an odd pitch, dl, tot)
__host__ __device__ inline int region_floats(int sp, int C) {
  const int chunks = 8 * chunk_steps(sp) * sp, step = sp + C + 2;
  return ((chunks > step ? chunks : step) + 3) / 4 * 4;
}

// a row's scratch: each step's weights (4 sp floats), each step's
// emission cotangents (sp floats), then each step's finals' weights (two
// floats a step, padded to a multiple of 4)
__host__ __device__ inline size_t scratch_floats(int T, int sp) {
  return (size_t)T * 5 * sp + (2 * (size_t)T + 3) / 4 * 4;
}

// the backward's shared memory: the stages' region, then sv, cs, alpha_0,
// the exchange [2][2][sp], the extended labels, the class lists (C + 1
// offsets, padded to an even count), the finals' weights [2][kc + 1]
inline size_t bwd_smem(int sp, int C) {
  return sizeof(float) * ((size_t)region_floats(sp, C) + 9 * (size_t)sp +
                          C + 2 - (C & 1) + 4 * (chunk_steps(sp) + 1));
}

// store(i, load(i)) for i = i0, i0 + nthr, ... < total, U loads of a
// thread in flight at once (a loop that waits on each load would pay the
// latency of every one)
template <int U, typename Load, typename Store>
__device__ __forceinline__ void batched(int i0, int nthr, int total,
                                        Load load, Store store) {
  for (int base = i0; base < total; base += nthr * U) {
    decltype(load(0)) v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * nthr < total) v[u] = load(base + u * nthr);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * nthr < total) store(base + u * nthr, v[u]);
  }
}

// the adjoint's weights of one state of step t from alpha_{t-1} (a at s,
// s - 1, s - 2) and the logaddexp the recompute took (inner, merged):
// exp(inner - merged), exp(a[s] - inner), exp(a[s-1] - inner),
// exp(a[s-2] - merged), with +inf read as 0 (logaddexp's custom jvp)
__device__ __forceinline__ float4 weights(float as, float a1, float a2,
                                          float inner, float merged,
                                          bool has1, bool has2) {
  const float ri = rinf(inner), rm = rinf(merged);
  return make_float4(expf(__fsub_rn(ri, rm)), expf(__fsub_rn(rinf(as), ri)),
                     has1 ? expf(__fsub_rn(rinf(a1), ri)) : 0.f,
                     has2 ? expf(__fsub_rn(rinf(a2), rm)) : 0.f);
}

// block 0's clock at stage boundary i (chip_smoke.py reads the shares):
// in the backward 0 start, 1 after the recompute, 2 after the adjoint, 3
// after the epilogue; in the forward 0 start, 1 after the prologue, 2
// after the chain, 3 after the loss
__device__ __forceinline__ void stamp(long long* stamps, int i) {
  if (blockIdx.x == 0 && threadIdx.x == 0) stamps[i] = clock64();
}

// the forward's shared memory: two chunks of emissions, the exchange [2]
// [sp], then sv, cs, alpha_0 and the extended labels
inline size_t fwd_smem(int sp) {
  return sizeof(float) * (2 * (size_t)chunk_steps(sp) + 6) * sp;
}

// the extended labels zs (blank, l_1, blank, ..., l_U, blank; blank in the
// padding up to sp), the positions below 2U'+1 valid (reference
// ctc_ops.py:48-55); then a label may skip the blank before it when it
// differs from the label before that, and alpha_0 holds logp[0] at the
// blank and the first label (reference :60-64). One block barrier between
// the two; the caller syncs after.
__device__ __forceinline__ void extended_labels(
    int* zs, float* sv, float* cs, float* a0, const long long* lab,
    const float* lp, int U, int ylen, int blank, int sp) {
  const int last = 2 * ylen;
  for (int s = threadIdx.x; s < sp; s += THREADS) {
    zs[s] = (s & 1) && s < 2 * U + 1 ? (int)lab[s >> 1] : blank;
    sv[s] = s <= last ? 1.f : 0.f;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < sp; s += THREADS) {
    cs[s] = ((s & 1) && s >= 2 && zs[s] != zs[s - 2]) ? 1.f : 0.f;
    a0[s] = (s == 0 || (s == 1 && ylen > 0)) ? lp[zs[s]] : NEG;
  }
}

// the emissions of steps t0 .. t0 + n - 1 into dst [n][sp] (NEG where a
// position is not valid), by producer ptid of prod, eight loads of a
// thread in flight at once
__device__ __forceinline__ void gather_emissions(
    const float* lp, const int* zs, const float* sv, int t0, int n,
    float* dst, int ptid, int prod, int sp, int C) {
  for (int s = ptid; s < sp; s += prod) {
    const float* lps = lp + (size_t)t0 * C + zs[s];
    for (int k0 = 0; k0 < n; k0 += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = k0 + u < n && sv[s] > 0.f ? __ldg(lps + (k0 + u) * C) : NEG;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k0 + u < n) dst[(k0 + u) * sp + s] = v[u];
    }
  }
}

// a chain thread's states s = tid + k chain, k < K: alpha_0 and the masks
// into registers
template <int K>
__device__ __forceinline__ void chain_registers(
    float (&av)[K], bool (&valid)[K], bool (&skip)[K], const float* a0,
    const float* sv, const float* cs, int chain, int sp) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = min((int)threadIdx.x + k * chain, sp - 1);
    av[k] = a0[s];
    valid[k] = sv[s] > 0.f;
    skip[k] = cs[s] > 0.f;
  }
}

// one step of the chain: alpha_t at a chain thread's states (av, which
// held alpha_{t-1}) from a, alpha_{t-1}'s row, and e, step t's emissions;
// alpha_t goes to its row n for the neighbours, then the chain's barrier.
// Before av moves on, with(s, skip, a[s], a[s-1], a[s-2], inner, merged)
// sees the two logaddexp (the backward forms its weights there).
template <int K, typename With>
__device__ __forceinline__ void chain_step(float (&av)[K],
                                           const bool (&valid)[K],
                                           const bool (&skip)[K],
                                           const float* a, const float* e,
                                           float* n, int chain, int sp,
                                           With with) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = threadIdx.x + k * chain;
    if (s < sp) {
      const float a1 = s >= 1 ? a[s - 1] : NEG;
      const float a2 = skip[k] ? a[s - 2] : NEG;
      const float inner = lae(av[k], a1);
      const float merged = lae(inner, a2);
      with(s, skip[k], av[k], a1, a2, inner, merged);
      av[k] = valid[k] ? __fadd_rn(merged, e[s]) : NEG;
      n[s] = av[k];
    }
  }
  group_sync<1>(chain);
}

// the loss of each row, from logp, the labels and the lengths; K states a
// chain thread (Sp up to K MAX_CHAIN), kept in registers
template <int K>
__global__ void __launch_bounds__(THREADS, 1)
ctc_fwd_kernel(const float* __restrict__ logp,
               const long long* __restrict__ labels,
               const int* __restrict__ x_lens,
               const int* __restrict__ y_lens, float* loss,
               long long* stamps, int T, int sp, int C, int U, int blank) {
  extern __shared__ float smem[];
  const int kc = chunk_steps(sp);
  float* ering = smem;                 // [2][kc][sp] emissions
  float* ax = ering + 2 * kc * sp;     // [2][sp] alpha_t by step parity
  float* sv = ax + 2 * sp;             // [sp] valid
  float* cs = sv + sp;                 // [sp] the skip mask
  float* a0 = cs + sp;                 // [sp] alpha_0
  int* zs = reinterpret_cast<int*>(a0 + sp);   // [sp] extended labels
  const int row = blockIdx.x, tid = threadIdx.x;
  const int CHAIN = chain_threads(sp), PROD = THREADS - CHAIN;
  const bool chain = tid < CHAIN;
  const float* lp = logp + (size_t)row * T * C;
  const int xlen = x_lens[row], ylen = y_lens[row];
  stamp(stamps, 0);
  // the scan selects its final at t = x_len - 1 where 1 <= x_len <= T
  // (alpha_tr after tr steps), else none: the loss is then -NEG, and no
  // step is taken
  const bool final_on = xlen >= 1 && xlen <= T;
  const int tr = final_on ? xlen - 1 : 0;
  extended_labels(zs, sv, cs, a0, labels + (size_t)row * U, lp, U, ylen,
                  blank, sp);
  __syncthreads();
  const int nch = (tr + kc - 1) / kc;
  if (!chain && nch > 0)
    gather_emissions(lp, zs, sv, 1, min(kc, tr), ering, tid - CHAIN, PROD,
                     sp, C);
  float av[K];
  bool valid[K], skip[K];
  chain_registers<K>(av, valid, skip, a0, sv, cs, CHAIN, sp);
  __syncthreads();
  stamp(stamps, 1);
  // chunk j holds steps 1 + j kc ..; alpha_t lies in row t & 1 (alpha_0
  // in a0): step t writes the row step t - 1 read, behind its barrier
  for (int j = 0; j < nch; ++j) {
    const int t0 = 1 + j * kc;
    if (chain) {
      const float* e = ering + (j & 1) * kc * sp;
      for (int t = t0; t < min(t0 + kc, tr + 1); ++t) {
        chain_step<K>(av, valid, skip, t == 1 ? a0 : ax + ((t - 1) & 1) * sp,
                      e, ax + (t & 1) * sp, CHAIN, sp,
                      [](int, bool, float, float, float, float, float) {});
        e += sp;
      }
    } else if (j + 1 < nch) {
      gather_emissions(lp, zs, sv, t0 + kc, min(kc, tr + 1 - t0 - kc),
                       ering + ((j + 1) & 1) * kc * sp, tid - CHAIN, PROD,
                       sp, C);
    }
    __syncthreads();
  }
  stamp(stamps, 2);
  if (tid == 0)
    loss[row] = final_on
                    ? -final_of(tr == 0 ? a0 : ax + (tr & 1) * sp, ylen)
                    : -NEG;
  stamp(stamps, 3);
}

// the dlogits of each row; K states a chain thread (Sp up to K
// MAX_CHAIN), kept in registers; one block an SM, so that every register a
// thread may hold is there
template <int K>
__global__ void __launch_bounds__(THREADS, 1)
ctc_bwd_kernel(const float* __restrict__ logp,
               const long long* __restrict__ labels,
               const int* __restrict__ x_lens,
               const int* __restrict__ y_lens,
               const float* __restrict__ dloss, float* scratch,
               float* dlogits, long long* stamps, int T, int sp, int C,
               int U, int blank) {
  extern __shared__ float4 smem4[];
  const int kc = chunk_steps(sp);
  float* region = reinterpret_cast<float*>(smem4);
  // the recompute's view of the region
  float* aring = region;                 // [2][kc][sp] alpha_1 ..
  float* ering = aring + 2 * kc * sp;    // [2][kc][sp] emissions
  // the adjoint's
  float4* wring = smem4;                 // [2][kc][sp] weights
  // the epilogue's: ge steps at a time, de rows sp + 1 apart (an odd
  // pitch: the lanes of a warp read one position of other rows)
  const int ge = region_floats(sp, C) / (sp + C + 2);
  float* des = region;                   // [ge][sp + 1] emission cotangents
  float* dl = des + ge * (sp + 1);       // [ge][C]
  float* tot = dl + ge * C;              // [ge]
  float* sv = region + region_floats(sp, C);   // [sp] valid
  float* cs = sv + sp;                 // [sp] the skip mask
  float* a0 = cs + sp;                 // [sp] alpha_0
  float* gx = a0 + sp;                 // [2][2][sp] g1, g2 by step parity
  int* zs = reinterpret_cast<int*>(gx + 4 * sp);   // [sp] extended labels
  int* cpos = zs + sp;                 // [sp] label positions by class
  int* coff = cpos + sp;               // [C + 1] each class's first
  float2* fring = reinterpret_cast<float2*>(coff + C + 2 - (C & 1));
                                       // [2][kc + 1] the finals' weights
  const int row = blockIdx.x, tid = threadIdx.x;
  const int CHAIN = chain_threads(sp), PROD = THREADS - CHAIN;
  const bool chain = tid < CHAIN;
  const int ptid = tid - CHAIN;        // a producer's index
  const float* lp = logp + (size_t)row * T * C;
  const long long* lab = labels + (size_t)row * U;
  float* S = scratch + (size_t)row * scratch_floats(T, sp);
  float4* W = reinterpret_cast<float4*>(S);   // [T][sp] weights
  float* D = S + (size_t)T * 4 * sp;          // [T][sp] de
  float2* F = reinterpret_cast<float2*>(D + (size_t)T * sp);   // [T]
  float* out = dlogits + (size_t)row * T * C;
  const int xlen = x_lens[row], ylen = y_lens[row], last = 2 * ylen;
  stamp(stamps, 0);
  // the scan's real steps are 1 .. tr (it carries alpha_tr through the
  // steps after); the loss selects final at tf = tr where 1 <= x_len <= T
  const bool final_on = xlen >= 1 && xlen <= T;
  const int tr = xlen < 1 ? 0 : (xlen > T ? T - 1 : xlen - 1);
  // dlogits past the real steps: dlogp is 0 there, so 0 - exp(logp) * 0
  for (size_t i = (size_t)(tr + 1) * C + tid; i < (size_t)T * C;
       i += THREADS)
    out[i] = __fsub_rn(0.f, __fmul_rn(expf(__ldg(lp + i)), 0.f));

  // the extended labels, the masks and alpha_0; each class's label
  // positions are counted
  extended_labels(zs, sv, cs, a0, lab, lp, U, ylen, blank, sp);
  for (int c = tid; c < C; c += THREADS) {
    int n = 0;
    for (int s = 0; s < sp; ++s) n += zs[s] == c;
    coff[c + 1] = n;
  }
  __syncthreads();
  if (tid < 32) {   // the counts' running sum, lane by lane
    const int per = (C + 31) / 32, c0 = min(C, tid * per);
    const int c1 = min(C, c0 + per);
    int sum = 0;
    for (int c = c0; c < c1; ++c) sum += coff[c + 1];
    int run = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, run, o);
      if (tid >= o) run += v;
    }
    run -= sum;
    if (tid == 0) coff[0] = 0;
    for (int c = c0; c < c1; ++c) {
      run += coff[c + 1];
      coff[c + 1] = run;
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += THREADS) {
    int k = coff[c];
    for (int s = 0; s < sp; ++s)
      if (zs[s] == c) cpos[k++] = s;
  }

  // ---- (a) alpha_1 .. alpha_tr on the chain, the emissions a chunk
  // ahead; (b) each step's weights, off the chain's dependency, into the
  // scratch; the producers form the finals' weights a chunk behind ----
  // Chunk j holds steps 1 + j kc ..; alpha_t lies in a ring of two chunks.
  auto arow = [=](int t) -> float* {   // alpha_t's row, t >= 0
    return t == 0 ? a0
                  : aring + ((t - 1) / kc & 1) * kc * sp + (t - 1) % kc * sp;
  };
  // steps t0 .. of one chunk
  auto gather = [=](int t0, float* dst) {
    gather_emissions(lp, zs, sv, t0, min(kc, tr + 1 - t0), dst, ptid, PROD,
                     sp, C);
  };
  // the finals' weights of alpha_t, exp(a_t[x] - fin_t) for x = last,
  // last - 1, with +inf read as 0
  auto finals_weights = [=](int t, const float* a) {   // a: alpha_t
    const float al = a[last], am = ylen > 0 ? a[last - 1] : NEG;
    const float rf = rinf(lae(al, am));
    F[t] = make_float2(expf(__fsub_rn(rinf(al), rf)),
                       expf(__fsub_rn(rinf(am), rf)));
  };
  const int nch = (tr + kc - 1) / kc;
  if (!chain && nch > 0) gather(1, ering);
  // a chain thread's states: alpha_{t-1} and the masks in registers
  float av[K];
  bool valid[K], skip[K];
  chain_registers<K>(av, valid, skip, a0, sv, cs, CHAIN, sp);
  __syncthreads();
  for (int j = 0; j < nch; ++j) {
    const int t0 = 1 + j * kc;
    if (chain) {
      const float* e = ering + (j & 1) * kc * sp;
      const float* a = arow(t0 - 1);
      float* n = arow(t0);   // the chunk's rows follow it
      float4* w = W + (size_t)t0 * sp;
      for (int t = t0; t < min(t0 + kc, tr + 1); ++t) {
        chain_step<K>(av, valid, skip, a, e, n, CHAIN, sp,
                      [=](int s, bool sk, float as, float a1, float a2,
                          float inner, float merged) {
                        w[s] = weights(as, a1, a2, inner, merged, s >= 1,
                                       sk);
                      });
        a = n;
        n += sp;
        e += sp;
        w += sp;
      }
    } else {
      if (j + 1 < nch) gather(t0 + kc, ering + ((j + 1) & 1) * kc * sp);
      if (j >= 1)
        for (int t = t0 - kc + ptid; t < t0; t += PROD)
          finals_weights(t, arow(t));
    }
    __syncthreads();
  }
  // the last chunk's finals' weights and alpha_0's; the weights of the
  // step past tr, which the scan takes from alpha_tr
  const int tb = tr < T - 1 ? tr + 1 : tr;
  if (!chain) {
    for (int t = nch > 0 ? 1 + (nch - 1) * kc : 1; t + ptid <= tr; t += PROD)
      finals_weights(t + ptid, arow(t + ptid));
    if (ptid == PROD - 1) finals_weights(0, a0);
    if (tb > tr) {
      const float* a = arow(tr);
      for (int s = ptid; s < sp; s += PROD) {
        const float a1 = s >= 1 ? a[s - 1] : NEG;
        const float a2 = (s >= 2 && cs[s] > 0.f) ? a[s - 2] : NEG;
        const float inner = lae(a[s], a1);
        W[(size_t)tb * sp + s] = weights(a[s], a1, a2, inner,
                                         lae(inner, a2), s >= 1,
                                         s >= 2 && cs[s] > 0.f);
      }
    }
  }
  __syncthreads();
  stamp(stamps, 1);

  // ---- (c) the adjoint, t = tb .. 1 on the chain, the producers staging
  // each chunk's weights a chunk ahead ----
  // Autograd of the scan (the plain version's, the reference's) adds to a
  // cotangent also the terms of the unselected finals and of the steps
  // after tr, 0 * weight, which are 0 but where a weight is NaN or
  // infinite: the adjoint adds them too. It starts at the first such step,
  // tb = tr + 1 (from a cotangent of 0), where there is one; chunk j holds
  // steps tb - j kc .. down to 1.
  const float gf = -dloss[row];
  auto stage = [=](int j, float4* dst, float2* fdst) {
    const int t0 = tb - j * kc, n = min(kc, t0);
    for (int s = ptid; s < sp; s += PROD) {
      const float4* ws = W + (size_t)t0 * sp + s;
      for (int k0 = 0; k0 < n; k0 += 8) {   // eight loads in flight
        float4 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (k0 + u < n) v[u] = __ldcg(ws - (size_t)(k0 + u) * sp);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (k0 + u < n) dst[(k0 + u) * sp + s] = v[u];
      }
    }
    for (int k = ptid; k <= n; k += PROD) {
      const int t = t0 - k;
      if (t <= tr && (k < n || t == 0)) fdst[k] = __ldcg(F + t);
    }
  };
  // the cotangent of alpha_t is complete with its final's terms: the loss's
  // at tf, 0 * weight where the scan computes a final it does not select
  auto finals = [=](int t, float (&gk)[K], float2 wf) {
    const bool real = final_on && t == tr;
    const bool leak = !real || tr < T - 1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = tid + k * CHAIN;
      if (s == last || (ylen > 0 && s == last - 1)) {
        const float w = s == last ? wf.x : wf.y;
        float v = gk[k];
        if (real) v = __fadd_rn(v, __fmul_rn(gf, w));
        if (leak) v = __fadd_rn(v, __fmul_rn(0.f, w));
        gk[k] = v;
      }
    }
  };
  // (d) dlogits[t][c] = dl[c] - exp(logp[t][c]) * sum_c dl[c], dl[c] the
  // sum of de_t[s] over z[s] == c in increasing s, for t = t_lo .. t_hi
  // (at most ge steps), by threads i0 + k nthr, each phase behind sync()
  auto epilogue = [=](int t_lo, int t_hi, int i0, int nthr, auto sync) {
    const int n = t_hi + 1 - t_lo;
    batched<8>(
        i0, nthr, n * sp,
        [=](int i) { return __ldcg(D + (size_t)t_lo * sp + i); },
        [=](int i, float v) { des[i + i / sp] = v; });
    sync();
    // item i = c n + k: class c, step t_lo + k, so that the lanes of a
    // warp walk one class's list (the same length) over other steps
    for (int i = i0; i < n * C; i += nthr) {
      const int c = i / n, k = i - c * n;
      const float* d = des + k * (sp + 1);
      const int qe = coff[c + 1];
      float acc = 0.f;
      int q = coff[c];
      for (; q + 8 <= qe; q += 8) {   // eight loads, then eight adds
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = d[cpos[q + u]];
#pragma unroll
        for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, v[u]);
      }
      for (; q < qe; ++q) acc = __fadd_rn(acc, d[cpos[q]]);
      dl[k * C + c] = acc;
    }
    sync();
    for (int k = i0; k < n; k += nthr) {
      const float* d = dl + k * C;
      float sum = 0.f;
      int c = 0;
      for (; c + 8 <= C; c += 8) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = d[c + u];
#pragma unroll
        for (int u = 0; u < 8; ++u) sum = __fadd_rn(sum, v[u]);
      }
      for (; c < C; ++c) sum = __fadd_rn(sum, d[c]);
      tot[k] = sum;
    }
    sync();
    batched<8>(
        i0, nthr, n * C,
        [=](int i) { return __ldg(lp + (size_t)t_lo * C + i); },
        [=](int i, float v) {
          out[(size_t)t_lo * C + i] =
              __fsub_rn(dl[i], __fmul_rn(expf(v), tot[i / C]));
        });
  };
  const int nb = (tb + kc - 1) / kc;
  float g[K] = {};   // the cotangent of alpha_t at a chain thread's states
  if (!chain && nb > 0) stage(0, wring, fring);
  __syncthreads();
  for (int j = 0; j < nb; ++j) {
    const int t0 = tb - j * kc;
    if (chain) {
      const float4* wt = wring + (j & 1) * kc * sp;
      const float2* fc = fring + (j & 1) * (kc + 1);
      float* de = D + (size_t)t0 * sp;   // the emissions' cotangents
      for (int t = t0; t > max(0, t0 - kc); --t) {
        if (t <= tr) finals(t, g, fc[t0 - t]);
        float* x1 = gx + (t & 1) * 2 * sp;
        float* x2 = x1 + sp;
        float g0[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int s = tid + k * CHAIN;
          if (s < sp) {
            const float gn = valid[k] ? g[k] : 0.f;
            const float4 w = wt[s];
            const float gi = __fmul_rn(gn, w.x);
            if (t <= tr) de[s] = gn;
            g0[k] = __fmul_rn(gi, w.y);
            x1[s] = s >= 1 ? __fmul_rn(gi, w.z) : 0.f;
            x2[s] = skip[k] ? __fmul_rn(gn, w.w) : 0.f;
          }
        }
        group_sync<1>(CHAIN);
        // g[s] = g0[s] + g1[s + 1] + g2[s + 2]
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int s = tid + k * CHAIN;
          if (s < sp) {
            float v = g0[k];
            if (s + 1 < sp) v = __fadd_rn(v, x1[s + 1]);
            if (s + 2 < sp) v = __fadd_rn(v, x2[s + 2]);
            g[k] = v;
          }
        }
        wt += sp;
        de -= sp;
      }
      if (t0 - kc < 1) finals(0, g, fc[t0]);   // the last chunk: alpha_0's
    } else if (j + 1 < nb) {
      stage(j + 1, wring + ((j + 1) & 1) * kc * sp,
            fring + ((j + 1) & 1) * (kc + 1));
    }
    __syncthreads();
  }
  if (chain) {
    if (nb == 0) finals(0, g, __ldcg(F));   // no step (T = 1)
    // t = 0: alpha0[0] = logp[0][blank], alpha0[1] = logp[0][z[1]] (with
    // a label), both where valid
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = tid + k * CHAIN;
      if (s < sp)
        D[s] = (valid[k] && (s == 0 || (s == 1 && ylen > 0))) ? g[k] : 0.f;
    }
  }
  __syncthreads();
  stamp(stamps, 2);

  // every step, ge at a time, every thread
  for (int t_lo = 0; t_lo <= tr; t_lo += ge)
    epilogue(t_lo, min(t_lo + ge - 1, tr), tid, THREADS,
             [] { __syncthreads(); });
  stamp(stamps, 3);
}

// the serial floor: one warp running T dependent steps of the recurrence
// alone (two logaddexp, the emission's add: the forward's), then, with
// adjoint, T of the adjoint (two products, a neighbour's product through a
// shuffle, two adds: the backward's 2 T); in holds (a, e, g, w), out the
// results
__global__ void chain_floor_kernel(const float* in, float* out, int T,
                                   int adjoint) {
  float a = in[0];
  const float e = in[1], e1 = __fsub_rn(in[1], 1.f), w = in[3];
  for (int t = 0; t < T; ++t) a = __fadd_rn(lae(lae(a, e), e1), e);
  float g = in[2];
  for (int t = 0; t < (adjoint ? T : 0); ++t) {
    const float gi = __fmul_rn(g, w);
    const float g1 = __shfl_down_sync(0xffffffffu, __fmul_rn(gi, w), 1);
    g = __fadd_rn(__fadd_rn(__fmul_rn(gi, w), g1), gi);
  }
  if (threadIdx.x == 0) {
    out[0] = a;
    out[1] = g;
  }
}

}  // namespace

extern "C" {

// logp [b, T, C] float32, labels [b, U] int64, x_lens, y_lens [b] int32
// in; loss [b, 1] out (sp >= 2U+1); stamps [4] (int64) out: block 0's
// clock at the stage boundaries.
int ctc_loss_fwd(const float* logp, const long long* labels,
                 const int* x_lens, const int* y_lens, float* loss,
                 long long* stamps, int b, int T, int sp, int C, int U,
                 int blank, void* stream) {
  if (b < 1 || T < 1 || C < 1 || U < 0 || sp < 2 * U + 1 || sp % 4 != 0 ||
      sp > 8 * MAX_CHAIN)
    return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(sp);
  const auto kernel =
      sp <= MAX_CHAIN ? ctc_fwd_kernel<1> : ctc_fwd_kernel<8>;
  if (smem > 48 * 1024) {   // the default limit, which needs no attribute
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<b, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      logp, labels, x_lens, y_lens, loss, stamps, T, sp, C, U, blank);
  return (int)cudaGetLastError();
}

// the floats of ctc_loss_bwd's scratch a batch row takes
long long ctc_bwd_scratch(int T, int sp) {
  return (long long)scratch_floats(T, sp);
}

// logp [b, T, C] float32, labels [b, U] int64, x_lens, y_lens [b] int32
// and dloss [b] float32 in; dlogits [b, T, C] out; scratch [b,
// ctc_bwd_scratch(T, sp)] (sp >= 2U+1); stamps [4] (int64) out: block 0's
// clock at the stage boundaries.
int ctc_loss_bwd(const float* logp, const long long* labels,
                 const int* x_lens, const int* y_lens, const float* dloss,
                 float* scratch, float* dlogits, long long* stamps, int b,
                 int T, int sp, int C, int U, int blank, void* stream) {
  if (b < 1 || T < 1 || C < 1 || U < 0 || sp < 2 * U + 1 || sp % 4 != 0 ||
      sp > 8 * MAX_CHAIN)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(sp, C);
  const auto kernel =
      sp <= MAX_CHAIN ? ctc_bwd_kernel<1> : ctc_bwd_kernel<8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<b, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      logp, labels, x_lens, y_lens, dloss, scratch, dlogits, stamps, T, sp,
      C, U, blank);
  return (int)cudaGetLastError();
}

// one warp running the forward's serial chain of T steps alone, or with
// adjoint the backward's of 2 T (their floors); in [4], out [2] float32
int ctc_chain_floor(const float* in, float* out, int T, int adjoint,
                    void* stream) {
  chain_floor_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, T, adjoint);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
