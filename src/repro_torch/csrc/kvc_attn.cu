// One-token GQA decode attention over the KV cache's compressed region,
// dequantizing int4/int8 K/V inside the kernel, for Hopper (sm_90a); and
// its MLA form over the compressed latent cache, at the end of the file: on
// the CUDA cores for f32 queries (kvc_latent_partial) and on the tensor
// cores for bf16 ones (kvc_latent_partial_tc).
//
// Replaces the TPU kernel kernels/kvc_attn.py::kvc_decode_attention
// (_kvc_kernel) of the JAX package. The JAX serving path computes the same
// attention in jnp (models/decode.py::quantized_attention_partial) and
// needs the unnormalised online-softmax partial (m, l, acc) to merge with
// the hot window's; this kernel writes that partial, and the normalised
// form is the partial plus `finish` (acc / max(l, 1e-30)) in the wrapper.
//
//   q [B, Hq, D] bf16/f32; codes [B, S, Hkv, D*bits/8] u8 (4-bit: two
//   values a byte, low nibble first); scales [B, S, Hkv] f32 (one block per
//   token and KV head); lengths [B] i32 -> m, l [B, Hq] f32, acc [B, Hq, D]
//   f32, over the tokens t < lengths[b]:
//     s = (q . k_t) * sm_scale,  m = max s,  l = sum exp(s - m),
//     acc = sum exp(s - m) v_t.
//   A row of length 0 gives m = -1e30, l = 0, acc = 0, which merge_partials
//   weights 0. With empty_uniform set it runs over all S tokens, every one
//   masked to -1e30, and so gives the reference kernel's result for such a
//   row: the uniform average of V (ROADMAP C).
//
// Bound: bytes. Each token a lane attends reads D*bits/8 + 4 bytes of K and
// the same of V once, shared by the G = Hq/Hkv query heads of its KV head;
// the arithmetic is 4*G*D flops a token, far under the card's rate. At the
// serving shape (8 lanes, 8 KV heads, a few hundred tokens each) the bytes
// are about 3 MB, under 1 us at 3.35 TB/s: the call is bound by latency,
// the length of the longest serial chain of one CTA plus the launch.
//
// The design splits the sequence across the card's SMs (flash-decoding)
// and merges in the same launch:
//   - grid (Hkv * n_slices, B, n_split), n_split = ceil(S / CHUNK) fixed by
//     S, so the host reads no length; n_slices = ceil(G / 8) head slices
//     (two for qwen3-moe's G = 16): slice s owns query heads [8s, 8s + 8)
//     of its KV head's group and reads the KV head's codes itself (a group
//     of 16 reads them twice, from L2 the second time; device-memory bytes
//     stay the same). A CTA whose chunk starts at or past its lane's span
//     exits at once; a lane whose span is 0 has its split-0 CTAs write the
//     empty partial straight to the output.
//   - a CTA of eight warps owns CHUNK (128) tokens of one (lane, KV head,
//     slice). All its
//     K and V codes are loaded at once into registers (16-byte reads for K;
//     4 or 8 bytes, 8 values, for V) and dequantized there without the
//     quarter-rate int-to-float convert (no shared-memory round trip for K
//     or V): 256 / CHUNK neighbouring threads score a token for the G heads
//     (q in shared memory, read as broadcasts) and sum their parts with
//     shuffles; a warp per head takes the chunk's max, exp and sum; then
//     thread (d-group, token-group) accumulates 8 dims of p.v over its
//     tokens, and the token groups are summed in a fixed order (shuffles,
//     then shared memory).
//   - D 80 (zamba2-2.7b's 32/32 heads of 80): a 4-bit (token, head) row is
//     40 bytes, 8-byte aligned only, so K's two threads a token read 20
//     bytes each in 4-byte words (8-byte at 8 bits) and V's 8 values a
//     thread 4 or 8 bytes; p.v's 10 dim groups are padded to 16 lanes (6
//     idle), so the token groups still sum with shuffles. D 64 and 128 run
//     the same code as before.
//   - a CTA that is its lane's only split writes the output directly.
//     Otherwise it writes (acc, m, l) for its slice's heads to scratch
//     [B, Hkv, n_split, G, D + 2] f32 and adds one to a per-(lane, KV head,
//     slice) counter with an acq_rel atomic (the threadfence reduction,
//     the fence folded into the atomic); the CTA that brings it to the
//     number of splits merges splits 0..n-1 in index order, every output
//     loading its splits' (m, acc) in one round (so repeated calls give
//     bit-identical partials), and resets the counter to 0. The wrapper
//     keeps the int32 counters per device, zeroed once: the kernel assumes
//     one stream at a time per counter buffer.
// Online softmax in f32 with expf; no fast math. What it still lacks: the
// chain of one CTA (lengths -> codes -> scores -> max -> p.v -> partial ->
// atomic -> merge) is serial, about 7 us for a lane of one chunk and 11 us
// with a merge at the serving shape, against a 1.7 us launch (PERF.md); at
// S = 2048 most of the ~1,000 CTAs exit at once.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;        // query heads a CTA (a head slice)
constexpr int kMaxGroup = 16;   // query heads per KV head: two slices
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
// Tokens per CTA (CHUNK above); kernels/kvc_attn.py::CHUNK, which sizes
// the scratch, holds the same. -DKVC_CHUNK overrides it for
// tools/sweep_attn.py's sweep only.
#ifndef KVC_CHUNK
#define KVC_CHUNK 128
#endif
constexpr int kChunk = KVC_CHUNK;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// One 32-bit word of codes -> 8 (4-bit) or 4 (8-bit) values, code * scale.
// A code c becomes a float without the quarter-rate convert: with its sign
// bit flipped it is the low mantissa of 2^23 + c + 2^(bits-1), exactly, and
// subtracting 2^23 + 2^(bits-1) leaves c (the same value I2F gives).
template <int BITS>
__device__ __forceinline__ void dequant_word(uint32_t w, float scale,
                                             float* dst) {
  if constexpr (BITS == 4) {
    const uint32_t x = w ^ 0x88888888u;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      dst[i] = (__uint_as_float(0x4B000000u | ((x >> (4 * i)) & 0xFu)) -
                8388616.0f) * scale;
  } else {
    const uint32_t x = w ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dst[i] = (__uint_as_float(0x4B000000u | ((x >> (8 * i)) & 0xFFu)) -
                8388736.0f) * scale;
  }
}

// NW 32-bit words of codes in loads of 16 bytes (or 8, or 4). An odd
// count (D 80 at 4 bits: 5 words, 20 bytes a thread from a 40-byte row,
// so only 4-byte aligned) takes 4-byte loads.
template <int NW>
__device__ __forceinline__ void load_words(const uint8_t* src, uint32_t (&w)[NW]) {
  if constexpr (NW % 2 == 1) {
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = reinterpret_cast<const uint32_t*>(src)[i];
  } else if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NW / 4; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(src)[i];
      w[4 * i] = u.x;
      w[4 * i + 1] = u.y;
      w[4 * i + 2] = u.z;
      w[4 * i + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) {
      const uint2 u = reinterpret_cast<const uint2*>(src)[i];
      w[2 * i] = u.x;
      w[2 * i + 1] = u.y;
    }
  }
}

template <int D, int BITS, int CHUNK>
__global__ void __launch_bounds__(kThreads)
kvc_split_kernel(const void* __restrict__ q, int q_f32,
                 const uint8_t* __restrict__ kc, const float* __restrict__ ks,
                 const uint8_t* __restrict__ vc, const float* __restrict__ vs,
                 const int* __restrict__ lengths, float* __restrict__ m_out,
                 float* __restrict__ l_out, float* __restrict__ acc_out,
                 float* __restrict__ scratch, int* __restrict__ counters,
                 int S, int Hq, int Hkv, int n_split, float sm_scale,
                 int empty_uniform) {
  constexpr int DP = D * BITS / 8;      // code bytes per (token, head)
  constexpr int TPT = kThreads / CHUNK; // threads per token for the scores
  constexpr int KWD = DP / TPT / 4;     // 32-bit code words a thread scores
  constexpr int VPW = 32 / BITS;        // values per word
  constexpr int DG = D / 8;             // p.v: 8 dims a thread
  // dim groups rounded up to a power of two (16 for D 80's 10), so that a
  // token group's threads sit at lane offsets of DGP inside a warp; the
  // threads with dg >= DG load and add nothing
  constexpr int DGP = DG <= 8 ? 8 : DG <= 16 ? 16 : 32;
  constexpr int TG = kThreads / DGP;    // token groups
  constexpr int VT = CHUNK / TG;        // V tokens a thread
  static_assert(TPT >= 1 && CHUNK % TG == 0 && DG <= 32 && D % 8 == 0 &&
                DP % (TPT * 4) == 0, "chunk and D do not tile");
  __shared__ __align__(16) float q_s[kMaxG * D];
  __shared__ float p_s[kMaxG][CHUNK];
  __shared__ __align__(16) float red_s[kWarps][kMaxG * D];
  __shared__ float m_s[kMaxG], l_s[kMaxG];
  __shared__ int last_s;

  const int G = Hq / Hkv;                 // the KV head's whole group
  const int n_slices = (G + kMaxG - 1) / kMaxG;
  const int h = blockIdx.x / n_slices, sl = blockIdx.x % n_slices;
  const int b = blockIdx.y, split = blockIdx.z;
  const int g0 = sl * kMaxG;             // this slice: heads [g0, g0 + Gs)
  const int Gs = min(kMaxG, G - g0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(max(lengths[b], 0), S);
  const int span = (len == 0 && empty_uniform) ? S : len;
  const int n_active = (span + CHUNK - 1) / CHUNK;
  const int64_t row0 = static_cast<int64_t>(b) * Hq + h * G + g0;
  if (split >= n_active) {
    if (split == 0) {                   // span 0: the empty partial
      for (int i = tid; i < Gs * D; i += kThreads)
        acc_out[row0 * D + i] = 0.0f;
      if (tid < Gs) {
        m_out[row0 + tid] = kNegInf;
        l_out[row0 + tid] = 0.0f;
      }
    }
    return;
  }
  const int c0 = split * CHUNK;
  const int n = min(CHUNK, span - c0);  // tokens of this chunk

  // all K and V codes of the chunk, in flight at once: the scores take
  // token tid / TPT, its dims (tid % TPT) * D / TPT.., the p.v 8 dims of
  // tokens tg, tg + TG, ..
  const int tk = tid / TPT, part = tid % TPT;
  uint32_t kw[KWD];
  float ksc = 0.0f;
  if (tk < n) {
    const int64_t row = (static_cast<int64_t>(b) * S + c0 + tk) * Hkv + h;
    load_words<KWD>(kc + row * DP + part * (DP / TPT), kw);
    ksc = ks[row];
  }
  const int dg = tid % DGP, tg = tid / DGP;
  uint32_t vw[VT][BITS / 4];
  float vsc[VT];
#pragma unroll
  for (int j = 0; j < VT; ++j) {
    const int tt = tg + j * TG;
    vsc[j] = 0.0f;
#pragma unroll
    for (int w = 0; w < BITS / 4; ++w) vw[j][w] = 0u;
    if (tt < n && dg < DG) {
      const int64_t row = (static_cast<int64_t>(b) * S + c0 + tt) * Hkv + h;
      load_words<BITS / 4>(vc + row * DP + dg * BITS, vw[j]);
      vsc[j] = vs[row];
    }
  }
  for (int i = tid; i < Gs * D; i += kThreads) {
    const int64_t qi = row0 * D + i;
    q_s[i] = q_f32 ? static_cast<const float*>(q)[qi]
                   : __bfloat162float(static_cast<const __nv_bfloat16*>(q)[qi]);
  }
  __syncthreads();

  // scores: TPT neighbouring threads share a token, then sum their parts
  float s[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) s[g] = 0.0f;
  if (tk < n) {
#pragma unroll
    for (int w = 0; w < KWD; ++w) {
      float val[VPW];
      dequant_word<BITS>(kw[w], ksc, val);
      const int d0 = part * (D / TPT) + w * VPW;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= Gs) break;
        const float4* qrow = reinterpret_cast<const float4*>(q_s + g * D + d0);
#pragma unroll
        for (int i4 = 0; i4 < VPW / 4; ++i4) {
          const float4 a = qrow[i4];
          s[g] += a.x * val[4 * i4] + a.y * val[4 * i4 + 1] +
                  a.z * val[4 * i4 + 2] + a.w * val[4 * i4 + 3];
        }
      }
    }
  }
#pragma unroll
  for (int o = 1; o < TPT; o <<= 1) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= Gs) break;
      s[g] += __shfl_xor_sync(kFull, s[g], o);
    }
  }
  if (part == 0 && tk < n) {
    const bool valid = c0 + tk < len;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= Gs) break;
      p_s[g][tk] = valid ? s[g] * sm_scale : kNegInf;
    }
  }
  __syncthreads();

  // per head (a warp each): the chunk's max, p = exp(s - m) in place, l
  if (warp < Gs) {
    const int g = warp;
    float mx = kNegInf;
    for (int tt = lane; tt < n; tt += 32) mx = fmaxf(mx, p_s[g][tt]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int tt = lane; tt < CHUNK; tt += 32) {
      const float p = tt < n ? expf(p_s[g][tt] - mx) : 0.0f;
      p_s[g][tt] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = sum;
    }
  }
  __syncthreads();

  // p.v: thread (dg, tg) sums dims 8dg..8dg+7 over tokens tg + j * TG
  float acc[kMaxG][8];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.0f;
#pragma unroll
  for (int j = 0; j < VT; ++j) {
    const int tt = tg + j * TG;
    float val[8];
#pragma unroll
    for (int w = 0; w < BITS / 4; ++w)
      dequant_word<BITS>(vw[j][w], vsc[j], val + w * VPW);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= Gs) break;
      const float p = p_s[g][tt];     // 0 past the chunk's tokens
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] += p * val[e];
    }
  }
  // token groups: first inside the warp, then across warps
#pragma unroll
  for (int o = DGP; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= Gs) break;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[g][e] += __shfl_xor_sync(kFull, acc[g][e], o);
    }
  }
  if (lane < DG) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= Gs) break;
#pragma unroll
      for (int e = 0; e < 8; ++e) red_s[warp][g * D + dg * 8 + e] = acc[g][e];
    }
  }
  __syncthreads();

  const bool alone = n_active == 1;
  float* part_out = scratch +
      (((static_cast<int64_t>(b) * Hkv + h) * n_split + split) * G + g0) *
          (D + 2);
  for (int i = tid; i < Gs * D; i += kThreads) {
    float a = red_s[0][i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) a += red_s[w][i];
    const int g = i / D, d = i % D;
    if (alone) acc_out[row0 * D + i] = a;
    else part_out[g * (D + 2) + d] = a;
  }
  if (tid < Gs) {
    if (alone) {
      m_out[row0 + tid] = m_s[tid];
      l_out[row0 + tid] = l_s[tid];
    } else {
      part_out[tid * (D + 2) + D] = m_s[tid];
      part_out[tid * (D + 2) + D + 1] = l_s[tid];
    }
  }
  if (alone) return;

  // The last CTA of this (lane, KV head, slice) merges the splits. The
  // counter's add is acq_rel at gpu scope: after the barrier it releases
  // this CTA's partial, and the last adder acquires all of them. Every
  // output then loads its splits' (m, acc) together, kMerge at a time, and
  // merges them online in index order (fixed: repeated calls agree bit for
  // bit).
  __syncthreads();
  int* counter = counters + (b * Hkv + h) * n_slices + sl;
  if (tid == 0) {
    int prev;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;"
                 : "=r"(prev)
                 : "l"(counter)
                 : "memory");
    last_s = prev == n_active - 1;
  }
  __syncthreads();
  if (!last_s) return;
  constexpr int kMerge = 8;
  const float* parts =
      scratch + (static_cast<int64_t>(b) * Hkv + h) * n_split * G * (D + 2);
  for (int i = tid; i < Gs * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mx = kNegInf, l = 0.0f, a = 0.0f;
    for (int sp0 = 0; sp0 < n_active; sp0 += kMerge) {
      float mv[kMerge], av[kMerge], lv[kMerge];
#pragma unroll
      for (int j = 0; j < kMerge; ++j) {
        const bool in = sp0 + j < n_active;
        const float* pp = parts + ((sp0 + j) * G + g0 + g) * (D + 2);
        mv[j] = in ? __ldcg(pp + D) : kNegInf;
        av[j] = in ? __ldcg(pp + d) : 0.0f;
        lv[j] = in && d == 0 ? __ldcg(pp + D + 1) : 0.0f;
      }
      float mn = mx;
#pragma unroll
      for (int j = 0; j < kMerge; ++j) mn = fmaxf(mn, mv[j]);
      const float e0 = expf(mx - mn);
      a *= e0;
      l *= e0;
#pragma unroll
      for (int j = 0; j < kMerge; ++j) {
        const float e = sp0 + j < n_active ? expf(mv[j] - mn) : 0.0f;
        a += av[j] * e;
        l += lv[j] * e;
      }
      mx = mn;
    }
    acc_out[row0 * D + i] = a;
    if (d == 0) {
      m_out[row0 + g] = mx;
      l_out[row0 + g] = l;
    }
  }
  if (tid == 0) *counter = 0;
}

template <int D, int BITS>
int launch(const void* q, int q_f32, const void* kc, const void* ks,
           const void* vc, const void* vs, const void* lengths, void* m,
           void* l, void* acc, void* scratch, void* counters, int B, int S,
           int Hq, int Hkv, float sm_scale, int empty_uniform,
           cudaStream_t s) {
  const int n_split = (S + kChunk - 1) / kChunk;
  const int n_slices = (Hq / Hkv + kMaxG - 1) / kMaxG;
  kvc_split_kernel<D, BITS, kChunk>
      <<<dim3(Hkv * n_slices, B, n_split), kThreads, 0, s>>>(
      q, q_f32, static_cast<const uint8_t*>(kc), static_cast<const float*>(ks),
      static_cast<const uint8_t*>(vc), static_cast<const float*>(vs),
      static_cast<const int*>(lengths), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(acc),
      static_cast<float*>(scratch), static_cast<int*>(counters), S, Hq, Hkv,
      n_split, sm_scale, empty_uniform);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// MLA's latent decode partial: one code stream, K = V. f32 queries: the
// CUDA cores.
// ---------------------------------------------------------------------------
//
// The absorbed MLA decode (models/decode.py::mla_decode_layer) attends H
// query heads of R values (minicpm3-4b: 40 heads, R = kv_lora_rank 256 +
// rope 32 = 288; q_nope folded through W_uk) over one latent row a token,
// shared by every head: a single KV head, and the key and the value are
// the same codes. Two routes, chosen by q's type alone (the wrapper, never
// one giving way to the other): bf16 queries, the serving path's, go to the
// tensor cores (lat_tc below); f32 queries, the f32 checks' and the f32
// model's, to this kernel, which keeps every product in f32 as the
// reference's jnp partial does. The GQA kernel above holds a (lane, KV
// head)'s G <= 8 heads' accumulators in one CTA, D <= 128; here 40 heads x
// 288 f32 is 46 KB, and one CTA for each 64 tokens of 8 lanes of a few
// hundred tokens (~43 CTAs) would leave most of the 132 SMs idle. So:
//   - grid (CL * n_split, B) in clusters of CL CTAs (2), with n_split =
//     ceil(S / kLatChunk) fixed by S (the host reads no length). A cluster
//     owns kLatChunk (32) tokens of one lane; its CTA of rank r owns heads
//     [r H/CL, (r + 1) H/CL) (20), with R threads, one latent column each.
//     At the main path's lengths that is ~160 working CTAs, 3 a SM by
//     shared memory (63 KB): one wave.
//   - the chunk's codes are read with 16-byte loads and dequantized ONCE for
//     all H heads: 16-byte unit u by the CTA of rank u % CL, into its
//     shared memory as f32 rows (padded to R + 4 so that float4 reads of 8
//     rows by 8 lanes hit distinct banks). After a cluster barrier each CTA
//     copies the other ranks' units out of their shared memory (Hopper's
//     distributed shared memory); a second barrier lets every CTA reuse its
//     tile and exit.
//   - scores: warp w takes heads w, w + R/32, .. of the CTA's group, lane l
//     tokens l + 32 i, an R-long dot with q in shared memory (float4
//     broadcasts); the head's max, exp and sum are a warp reduction.
//   - p.v: thread r accumulates column r of the CTA's heads over the
//     chunk's tokens, four tokens a step.
//   - a lane of one split writes its partial directly; otherwise each CTA
//     writes (acc, m, l) of its heads to scratch [B, n_split, H, R + 2] and
//     counts itself on its (lane, rank)'s counter (acq_rel, as above); the
//     last CTA of a (lane, rank) merges its heads: their max M and weights
//     exp(m_s - M) per split (a warp a head, a lane a split), then each
//     thread sums its column over the splits in index order (repeated calls
//     agree bit for bit), and resets the counter.
// Bound: operations. A token costs 4 * H * R flops (scores and p.v) against
// its R * bits / 8 + 4 code bytes, all of them f32 operations here: at 13d's
// lengths (8 lanes, 2,503 tokens) 115 MFLOP at the f32 CUDA cores' 67
// TFLOP/s is 0.0017 ms, against 0.00033 ms for the bytes (f32 q) at 3.35
// TB/s (PERF.md has the measured time). The shape (H, R, CL) is a template:
// another MLA config needs an instantiation in kvc_latent_partial, H % CL
// == 0, R % 32 == 0.

// Tokens a cluster and CTAs a cluster: kernels/kvc_attn.py's LATENT_CHUNK
// and LATENT_CLUSTER, which size the scratch and the counters, hold the
// same. -DKVC_LAT_CHUNK / -DKVC_LAT_CLUSTER override them for
// tools/sweep_attn.py's sweep only.
#ifndef KVC_LAT_CHUNK
#define KVC_LAT_CHUNK 32
#endif
#ifndef KVC_LAT_CLUSTER
#define KVC_LAT_CLUSTER 2
#endif
constexpr int kLatChunk = KVC_LAT_CHUNK;
static_assert(kLatChunk % 32 == 0, "a chunk is whole warps of tokens");

template <int H, int R, int CL>
struct LatShape {
  static constexpr int HC = H / CL;         // heads a CTA
  static constexpr int RS = R + 4;          // padded row of the f32 latent tile
  static constexpr int Threads = R;
  static constexpr int Warps = R / 32;
  static constexpr int HPW = (HC + Warps - 1) / Warps;
  static constexpr int TPL = kLatChunk / 32;
  static constexpr size_t Smem =
      sizeof(float) * (HC * R + kLatChunk * RS + HC * kLatChunk + 2 * HC);
  static_assert(H % CL == 0 && R % 32 == 0 && CL >= 1 && CL <= 8,
                "latent shape");
};

template <int H, int R, int CL, int BITS>
__global__ void __launch_bounds__(R)
kvc_latent_kernel(const float* __restrict__ q,
                  const uint8_t* __restrict__ codes,
                  const float* __restrict__ scales,
                  const int* __restrict__ lengths, float* __restrict__ m_out,
                  float* __restrict__ l_out, float* __restrict__ acc_out,
                  float* __restrict__ scratch, int* __restrict__ counters,
                  int S, int n_split, float sm_scale) {
  using Sh = LatShape<H, R, CL>;
  constexpr int HC = Sh::HC, RS = Sh::RS, T = Sh::Threads, NW = Sh::Warps;
  constexpr int RP = R * BITS / 8;      // code bytes a token
  constexpr int U = RP / 16;            // 16-byte units a token
  constexpr int VPW = 32 / BITS;        // values a 32-bit word
  constexpr int UF4 = VPW;              // float4s a unit (4 words x VPW / 4)
  constexpr int PR = R + 2;             // a head's partial: acc, m, l
  static_assert(RP % 16 == 0, "16-byte code rows");
  extern __shared__ __align__(16) float lsm[];
  float* q_s = lsm;                               // [HC][R]
  float* lat_s = q_s + HC * R;                    // [chunk][RS]
  float* p_s = lat_s + kLatChunk * RS;            // [HC][chunk]
  float* m_s = p_s + HC * kLatChunk;              // [HC]
  float* l_s = m_s + HC;                          // [HC]
  __shared__ int last_s;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int split = blockIdx.x / CL, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(max(lengths[b], 0), S);
  const int n_active = (len + kLatChunk - 1) / kLatChunk;
  const int64_t row0 = static_cast<int64_t>(b) * H + rank * HC;
  if (split >= n_active) {              // the whole cluster (one lane, split)
    if (split == 0) {                   // length 0: the empty partial
      for (int i = tid; i < HC * R; i += T) acc_out[row0 * R + i] = 0.0f;
      if (tid < HC) {
        m_out[row0 + tid] = kNegInf;
        l_out[row0 + tid] = 0.0f;
      }
    }
    return;
  }
  const int c0 = split * kLatChunk;
  const int n = min(kLatChunk, len - c0);
  const int n4 = (n + 3) & ~3;

  // this rank's units of the chunk's codes -> f32 latent rows
  for (int u = rank + CL * tid; u < n * U; u += CL * T) {
    const int t = u / U, c = u % U;
    const int64_t tok = static_cast<int64_t>(b) * S + c0 + t;
    const uint4 w4 = *reinterpret_cast<const uint4*>(codes + tok * RP + c * 16);
    const float sc = scales[tok];
    const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
    float* dst = lat_s + t * RS + c * 4 * VPW;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v[VPW];
      dequant_word<BITS>(w[i], sc, v);
#pragma unroll
      for (int e = 0; e < VPW; e += 4)
        *reinterpret_cast<float4*>(dst + i * VPW + e) =
            make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
    }
  }
  for (int i = tid; i < (n4 - n) * R; i += T)  // p.v's tail
    lat_s[(n + i / R) * RS + i % R] = 0.0f;
  for (int i = tid; i < HC * R; i += T) q_s[i] = q[row0 * R + i];
  cluster.sync();
  // the other ranks' units, float4 by float4 out of their shared memory
  for (int i = tid; i < n * U * UF4; i += T) {
    const int u = i / UF4, p = u % CL;
    if (p == rank) continue;
    const int off = (u / U) * RS + (u % U) * 4 * VPW + (i % UF4) * 4;
    *reinterpret_cast<float4*>(lat_s + off) =
        *reinterpret_cast<const float4*>(cluster.map_shared_rank(lat_s, p) + off);
  }
  cluster.sync();

  // scores of this warp's heads for tokens lane + 32 tt, then the heads'
  // max, p and sum inside the warp
  float sv[Sh::HPW][Sh::TPL];
#pragma unroll
  for (int i = 0; i < Sh::HPW; ++i)
#pragma unroll
    for (int tt = 0; tt < Sh::TPL; ++tt) sv[i][tt] = 0.0f;
#pragma unroll 4
  for (int d4 = 0; d4 < R / 4; ++d4) {
    float4 kv[Sh::TPL];
#pragma unroll
    for (int tt = 0; tt < Sh::TPL; ++tt)
      kv[tt] = *reinterpret_cast<const float4*>(
          lat_s + (lane + 32 * tt) * RS + 4 * d4);
#pragma unroll
    for (int i = 0; i < Sh::HPW; ++i) {
      const int h = warp + NW * i;
      if (h >= HC) break;
      const float4 a = *reinterpret_cast<const float4*>(q_s + h * R + 4 * d4);
#pragma unroll
      for (int tt = 0; tt < Sh::TPL; ++tt)
        sv[i][tt] += a.x * kv[tt].x + a.y * kv[tt].y + a.z * kv[tt].z +
                     a.w * kv[tt].w;
    }
  }
#pragma unroll
  for (int i = 0; i < Sh::HPW; ++i) {
    const int h = warp + NW * i;
    if (h >= HC) break;
    float x[Sh::TPL], mx = kNegInf;
#pragma unroll
    for (int tt = 0; tt < Sh::TPL; ++tt) {
      x[tt] = lane + 32 * tt < n ? sv[i][tt] * sm_scale : kNegInf;
      mx = fmaxf(mx, x[tt]);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
#pragma unroll
    for (int tt = 0; tt < Sh::TPL; ++tt) {
      const int t = lane + 32 * tt;
      const float p = t < n ? expf(x[tt] - mx) : 0.0f;
      p_s[h * kLatChunk + t] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[h] = mx;
      l_s[h] = sum;
    }
  }
  __syncthreads();

  // p.v: column tid of the CTA's heads, four tokens a step (p is 0 past n)
  float acc[HC];
#pragma unroll
  for (int h = 0; h < HC; ++h) acc[h] = 0.0f;
  for (int t = 0; t < n4; t += 4) {
    const float v0 = lat_s[t * RS + tid], v1 = lat_s[(t + 1) * RS + tid];
    const float v2 = lat_s[(t + 2) * RS + tid], v3 = lat_s[(t + 3) * RS + tid];
#pragma unroll
    for (int h = 0; h < HC; ++h) {
      const float4 p = *reinterpret_cast<const float4*>(p_s + h * kLatChunk + t);
      acc[h] += p.x * v0 + p.y * v1 + p.z * v2 + p.w * v3;
    }
  }

  if (n_active == 1) {                  // the lane's only split
#pragma unroll
    for (int h = 0; h < HC; ++h) acc_out[(row0 + h) * R + tid] = acc[h];
    if (tid < HC) {
      m_out[row0 + tid] = m_s[tid];
      l_out[row0 + tid] = l_s[tid];
    }
    return;
  }
  float* part = scratch +
      ((static_cast<int64_t>(b) * n_split + split) * H + rank * HC) * PR;
#pragma unroll
  for (int h = 0; h < HC; ++h) part[h * PR + tid] = acc[h];
  if (tid < HC) {
    part[tid * PR + R] = m_s[tid];
    part[tid * PR + R + 1] = l_s[tid];
  }
  __syncthreads();
  int* counter = counters + b * CL + rank;
  if (tid == 0) {
    int prev;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;"
                 : "=r"(prev)
                 : "l"(counter)
                 : "memory");
    last_s = prev == n_active - 1;
  }
  __syncthreads();
  if (!last_s) return;

  // the merge of this rank's heads: per head (a warp each, a lane per
  // split) M = max m, w = exp(m - M) per split (in the latent tile, free
  // now), L = sum w l in a fixed reduction order; then the columns, in
  // split order
  const float* parts =
      scratch + (static_cast<int64_t>(b) * n_split * H + rank * HC) * PR;
  float* w_s = lat_s;                   // [n_active][HC]
  for (int h = warp; h < HC; h += NW) {
    float M = kNegInf;
    for (int sp = lane; sp < n_active; sp += 32)
      M = fmaxf(M, __ldcg(parts + (static_cast<int64_t>(sp) * H + h) * PR + R));
    M = warp_max(M);
    float L = 0.0f;
    for (int sp = lane; sp < n_active; sp += 32) {
      const float* pp = parts + (static_cast<int64_t>(sp) * H + h) * PR;
      const float w = expf(__ldcg(pp + R) - M);
      w_s[sp * HC + h] = w;
      L += w * __ldcg(pp + R + 1);
    }
    L = warp_sum(L);
    if (lane == 0) {
      m_s[h] = M;
      l_s[h] = L;
    }
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < HC; ++h) acc[h] = 0.0f;
  for (int sp = 0; sp < n_active; ++sp) {
    const float* pp = parts + static_cast<int64_t>(sp) * H * PR + tid;
    float a[HC];
#pragma unroll
    for (int h = 0; h < HC; ++h) a[h] = __ldcg(pp + h * PR);
#pragma unroll
    for (int h = 0; h < HC; ++h) acc[h] += w_s[sp * HC + h] * a[h];
  }
#pragma unroll
  for (int h = 0; h < HC; ++h) acc_out[(row0 + h) * R + tid] = acc[h];
  if (tid < HC) {
    m_out[row0 + tid] = m_s[tid];
    l_out[row0 + tid] = l_s[tid];
  }
  if (tid == 0) *counter = 0;
}

template <int H, int R, int CL, int BITS>
int launch_latent(const void* q, const void* codes,
                  const void* scales, const void* lengths, void* m, void* l,
                  void* acc, void* scratch, void* counters, int B, int S,
                  float sm_scale, cudaStream_t s) {
  using Sh = LatShape<H, R, CL>;
  const int n_split = (S + kLatChunk - 1) / kLatChunk;
  if (static_cast<int64_t>(n_split) * Sh::HC > kLatChunk * Sh::RS)
    return cudaErrorInvalidValue;       // the merge's weights: past the tile
  auto kern = kvc_latent_kernel<H, R, CL, BITS>;
  static bool attr_set = false;         // above 48 KB needs the opt-in
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Sh::Smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * n_split, B);
  cfg.blockDim = dim3(Sh::Threads);
  cfg.dynamicSmemBytes = Sh::Smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const float*>(q),
      static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scales), static_cast<const int*>(lengths),
      static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(acc),
      static_cast<float*>(scratch), static_cast<int*>(counters), S, n_split,
      sm_scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// MLA's latent decode partial on the tensor cores: bf16 queries.
// ---------------------------------------------------------------------------
//
// The same function as kvc_latent_kernel (q [B, H, R] bf16 against one
// code stream that is K and V of every head) with both products on wgmma:
//   - heads as rows: all H heads of a lane are the rows of one m64 tile, so
//     a code tile is read and converted once for every head. q is copied
//     once a CTA, as bf16 (cp.async, 16 bytes a copy), into a 128-byte-
//     swizzled tile of ceil(R / 64) boxes (wgmma.cuh) of H rows each, the
//     boxes H rows apart: rows H..63 of a box are the next box's first rows
//     (finite values that reach only output rows past H, which are never
//     stored), which saves 24 rows a box of shared memory. At R = 288 the
//     last box is half used, and Q C^T issues only the R / 16 (18) k16
//     steps of the real columns.
//   - codes as exact bf16 integers: every 4-bit code (-8..7) and 8-bit code
//     (-128..127) is exact in bf16, so the code tile holds the codes
//     themselves (codes_bf16) and the per-token f32 scale stays outside
//     both products:
//       S[h, t] = (Q C^T)[h, t] * (scale[t] * sm_scale)   (f32, after the MMA)
//       p = exp(S - m) (ex2.approx, about 2 ulp),  l = sum p  (f32),
//       P = p * scale[t] = hi + lo,  hi = bf16(P),  lo = bf16(P - hi),
//       O += hi C + lo C            (f32 accumulator).
//     Q C^T is wgmma m64n{kTok}k16, both operands K-major; P C takes hi and
//     lo from registers in the score accumulator's own fragment layout and
//     C as the MN-major operand. hi + lo is P to about 2^-17 (exact in f32):
//     the partial is not normalized, so a single bf16 P (flash attention's
//     rounding, 2^-9) leaves an error that grows with l, and on long lanes
//     of nearly flat scores it passed the reference's 2e-2 on a few
//     elements (tests/test_torch_mla_hopper.py); the second product costs a
//     few HGMMA of a chain bound by latency.
//   - the output columns split over CTAs: wgmma's n stops at 256 < 288, and
//     all 288 columns of 40 heads in f32 are 160 registers a thread. So a
//     CTA owns one (lane, span of kTok tokens, 64-wide column box): it
//     computes the span's scores (the same in each of the ceil(R / 64)
//     boxes' CTAs, bit for bit) and P C for its box only, m64n64k16, 32
//     accumulator registers. The box CTAs of a span share nothing, so no
//     partial crosses shared memory between CTAs (a cluster that merged
//     its CTAs' 46 KB partials through distributed shared memory spent
//     ~5 us a CTA doing so, PERF.md) and no CTA waits for another before
//     its last merge.
//   - one tile a CTA, no ring: a CTA issues its q copies, its code loads
//     and its scale loads at once; at the main path's lengths a lane's
//     tokens are spread over ~19 a SM, so a second tile a CTA would only
//     lengthen the chain that bounds the call. A CTA is two warpgroups:
//     the first runs the products; both copy and convert the tiles (4-bit
//     codes through bf16's own mantissa, codes_bf16) and both run the last
//     merge, the two steps of the chain that a thread's serial work sets.
//   - grid (RB * B, n_span), n_span = ceil(S / kTok) fixed by S (the host
//     reads no length): a lane's spans lie along y, so the spans with
//     tokens are dispatched before those past the lanes' lengths, which exit
//     at once (span 0 of a lane of length 0 writes the empty partial: m =
//     -1e30, l = 0, acc = 0). kTok = 96: at 13d's lengths 30 spans x 5
//     boxes = 150 CTAs work, 2 a SM (90 KB of shared memory, 128 registers
//     a thread), one wave;
//     longer spans mean fewer records a merge reads but fewer CTAs than
//     SMs (128 tokens: 120 at 13d's lengths), shorter ones more records
//     (tools/sweep_attn.py, PERF.md).
//   - the merge, in span order (repeated calls agree bit for bit): a lane of
//     one span writes its partial; otherwise each CTA writes its box's
//     (acc, m, l) to scratch [B, n_span, RB, H * 64 + 2 H] and counts itself
//     on the (lane, box) counter (acq_rel, as above), and the last CTA of a
//     (lane, box) stages the spans' (m, l), weighs them, sums its columns
//     over the spans with 16 spans' loads in flight a thread, and resets
//     the counter (the merge is bound by the latency of its loads: staging
//     the records with cp.async, or batching a thread's items, was slower,
//     PERF.md). At 13d's lengths the records are 1.5 MB against the
//     CUDA-core route's 3.8 MB of scratch, and the longest lane's five last
//     merges read 7 records of 10.6 KB each, in parallel. The scratch is a
//     buffer the wrapper keeps across calls.
// Bound: bytes. At 13d's lengths (8 lanes, 2,503 tokens of 148 B at 4
// bits, q 8 x 40 x 288 bf16, the f32 partial out) 926 KB at 3.35 TB/s is
// 0.000276 ms; the 115 MFLOP of bf16 operations at 989 TFLOP/s, 0.000117
// ms. Both are far under a launch: the call is bound by the longest chain
// of one CTA (the length, q and codes in, the two products, the record and
// its counter, the last merge), and the design keeps that chain to those
// steps: no f32 copy of q, no exchange between CTAs before the record,
// merges spread over the boxes. The price: each of a span's 5 box CTAs
// computes its scores (4 x 58 MFLOP more) and reads its q and codes (3.5 MB
// and 1.9 MB from L2 at 13d's lengths).
// The kernel is a template on (H, R): H <= 64 (the m64 tile), R % 16 == 0
// (the k16 steps); kvc_latent_partial_tc instantiates minicpm3-4b's (40,
// 288).

namespace lat_tc {

using namespace hopper;

// Tokens a CTA: kernels/kvc_attn.py's LATENT_TC_TOKENS, which sizes the
// scratch, holds the same. -DKVC_TC_TOKENS overrides it for
// tools/sweep_attn.py's sweep only.
#ifndef KVC_TC_TOKENS
#define KVC_TC_TOKENS 96
#endif
constexpr int kTok = KVC_TC_TOKENS;
// Two warpgroups: the first runs the products, both copy and convert the
// tiles and both run the last merge (each bound by latency: twice the
// threads, half the serial steps).
constexpr int kThreads = 256;
constexpr int kRows = 64;               // wgmma's m: the heads
constexpr int kBox = 64;                // output columns a CTA
static_assert(kTok == 64 || kTok == 96 || kTok == 128,
              "tokens a CTA: a wgmma n of the score tile");

template <int H, int R>
struct Shape {
  static constexpr int RB = (R + 63) / 64;        // 64-wide boxes a row
  static constexpr int REC = H * kBox + 2 * H;    // a merge record
  // Q: RB boxes of H rows (a box is read as 64 rows, into the next one)
  static constexpr int kQBox = (H + 7) / 8 * 1024;
  static constexpr int kQ = 0;
  static constexpr int kC = kQ + (RB - 1) * kQBox + kRows * 128;  // codes: RB boxes of kTok rows
  static constexpr int kTiles = kC + RB * kTok * 128;
  static constexpr int kSmem = kTiles + 4 * kTok + 1024;  // scales; the base's alignment
  // the last merge's (m, l) and weights, [n_span][3][H], over the tiles
  static constexpr int kMaxSpans = kTiles / 4 / (3 * H);
  static_assert(H <= kRows && R % 16 == 0, "latent shape: H <= 64, R % 16 == 0");
};

// The 16-byte unit j of row r of the swizzled box at `box`.
__device__ __forceinline__ uint32_t swz(uint32_t box, int r, int j) {
  return box + r * 128 + ((j ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint32_t a,
                                            uint32_t b, uint32_t c,
                                            uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(dst), "r"(a),
               "r"(b), "r"(c), "r"(d)
               : "memory");
}

// One 32-bit word of codes -> its 32 / BITS codes as exact bf16, in pairs.
// 4-bit: a code c with its sign bit flipped is the mantissa of the bf16
// 128 + c + 8 (0x4300 | nibble), exactly; nibbles i and i + 4 go as a pair
// through one subtraction of 136, then the pairs are put in order. 8-bit:
// dequant_word's f32 form with scale 1, then bf16.
template <int BITS>
__device__ __forceinline__ void codes_bf16(uint32_t w,
                                           uint32_t (&out)[16 / BITS]) {
  if constexpr (BITS == 4) {
    const uint32_t x = w ^ 0x88888888u;
    const __nv_bfloat162 k = __float2bfloat162_rn(136.0f);
    uint32_t p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t t = ((x >> (4 * i)) & 0x000F000Fu) | 0x43004300u;
      const __nv_bfloat162 v =
          __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&t), k);
      p[i] = *reinterpret_cast<const uint32_t*>(&v);   // codes i, i + 4
    }
    out[0] = __byte_perm(p[0], p[1], 0x5410);          // codes 0, 1
    out[1] = __byte_perm(p[2], p[3], 0x5410);          // 2, 3
    out[2] = __byte_perm(p[0], p[1], 0x7632);          // 4, 5
    out[3] = __byte_perm(p[2], p[3], 0x7632);          // 6, 7
  } else {
    float v[32 / BITS];
    dequant_word<BITS>(w, 1.0f, v);
#pragma unroll
    for (int i = 0; i < 16 / BITS; ++i) out[i] = pack_bf16(v[2 * i], v[2 * i + 1]);
  }
}

// P (the score accumulator's fragment, f32) -> hi = bf16(P) and lo =
// bf16(P - hi) as A fragments, the layout of hopper::to_bf16.
template <int BK>
__device__ __forceinline__ void to_bf16_split(const float (&p)[BK / 2],
                                              uint32_t (&hi)[BK / 16][4],
                                              uint32_t (&lo)[BK / 16][4]) {
#pragma unroll
  for (int i = 0; i < BK / 2; i += 2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(p[i], p[i + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[i / 8][(i % 8) / 2] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i / 8][(i % 8) / 2] = pack_bf16(p[i] - hf.x, p[i + 1] - hf.y);
  }
}

// e^x as 2^(x log2 e) on the special-function unit (about 2 ulp; what
// flash attention's tensor-core route uses).
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ float4 fma4(float w, float4 v, float4 o) {
  return make_float4(o.x + w * v.x, o.y + w * v.y, o.z + w * v.z,
                     o.w + w * v.w);
}

template <int H, int R, int BITS>
__global__ void __launch_bounds__(kThreads, 2)
kvc_latent_tc_kernel(const __nv_bfloat16* __restrict__ q,
                     const uint8_t* __restrict__ codes,
                     const float* __restrict__ scales,
                     const int* __restrict__ lengths, float* __restrict__ m_out,
                     float* __restrict__ l_out, float* __restrict__ acc_out,
                     float* __restrict__ scratch, int* __restrict__ counters,
                     int S, int n_span, float sm_scale) {
  using Sh = Shape<H, R>;
  constexpr int RB = Sh::RB, REC = Sh::REC;
  constexpr int RP = R * BITS / 8;      // code bytes a token
  constexpr int U = RP / 16;            // 16-byte units a token
  constexpr int VU = 128 / BITS;        // codes a unit
  constexpr int QU = R / 8;             // 16-byte units of a q row
  static_assert(RP % 16 == 0, "16-byte code rows");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // the swizzle's alignment
  float* const tiles_s = reinterpret_cast<float*>(smem_raw + (base - raw));
  float* const sc_s = tiles_s + Sh::kTiles / 4;   // [kTok]
  __shared__ int last_s;

  const int b = blockIdx.x / RB, box = blockIdx.x % RB, g = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(max(lengths[b], 0), S);
  const int n_act = (len + kTok - 1) / kTok;      // spans with tokens
  const int c0 = box * kBox;                      // this CTA's columns
  const int ncol = min(kBox, R - c0);
  if (g >= n_act) {
    if (g == 0) {                       // length 0: the empty partial
      for (int i = tid; i < H * ncol; i += kThreads)
        acc_out[(static_cast<int64_t>(b) * H + i / ncol) * R + c0 + i % ncol] = 0.0f;
      if (box == 0 && tid < H) {
        m_out[b * H + tid] = kNegInf;
        l_out[b * H + tid] = 0.0f;
      }
    }
    return;
  }
  const int t0 = g * kTok;
  const int n = min(len - t0, kTok);    // this span's tokens, >= 1

  // q rows into the Q tile; the codes into the code tile as bf16 integers
  // (rows past n and the columns past R zero); the scales
  const __nv_bfloat16* qb = q + static_cast<int64_t>(b) * H * R;
  for (int i = tid; i < H * QU; i += kThreads) {
    const int h = i / QU, j = i % QU;
    cp_async16(swz(base + Sh::kQ + (j / 8) * Sh::kQBox, h, j % 8),
               qb + h * R + 8 * j);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  // every code unit and scale of this thread in flight at once (the
  // stores below would otherwise hold each load back to the one before)
  constexpr int NU = (kTok * U + kThreads - 1) / kThreads;
  uint4 w[NU];
#pragma unroll
  for (int k = 0; k < NU; ++k) {
    const int i = tid + k * kThreads, t = i / U;
    w[k] = make_uint4(0u, 0u, 0u, 0u);
    if (i < kTok * U && t < n)
      w[k] = *reinterpret_cast<const uint4*>(
          codes + (static_cast<int64_t>(b) * S + t0 + t) * RP + 16 * (i % U));
  }
  const float sc_t = tid < n ? scales[static_cast<int64_t>(b) * S + t0 + tid] : 0.0f;
  // the last Q box's rows past H: read by the products, zero
  for (int i = tid; i < (kRows - H) * 8; i += kThreads)
    st_shared16(swz(base + Sh::kQ + (RB - 1) * Sh::kQBox, H + i / 8, i % 8), 0u,
                0u, 0u, 0u);
#pragma unroll
  for (int k = 0; k < NU; ++k) {
    const int i = tid + k * kThreads, t = i / U, col = (i % U) * VU;
    if (i >= kTok * U) break;
    const uint32_t ws[4] = {w[k].x, w[k].y, w[k].z, w[k].w};
    uint32_t pk[4 * (16 / BITS)];
#pragma unroll
    for (int wi = 0; wi < 4; ++wi) {
      uint32_t o[16 / BITS];
      codes_bf16<BITS>(ws[wi], o);
#pragma unroll
      for (int e = 0; e < 16 / BITS; ++e) pk[wi * (16 / BITS) + e] = o[e];
    }
    const uint32_t cbox = base + Sh::kC + (col / 64) * kTok * 128;
#pragma unroll
    for (int c = 0; c < 16 / BITS; ++c)
      st_shared16(swz(cbox, t, (col % 64) / 8 + c), pk[4 * c], pk[4 * c + 1],
                  pk[4 * c + 2], pk[4 * c + 3]);
  }
  if constexpr (R % 64 != 0) {
    constexpr int J0 = (R % 64) / 8;    // the last box's first unused unit
    for (int i = tid; i < kTok * (8 - J0); i += kThreads)
      st_shared16(swz(base + Sh::kC + (RB - 1) * kTok * 128, i / (8 - J0),
                      J0 + i % (8 - J0)),
                  0u, 0u, 0u, 0u);
  }
  if (tid < kTok) sc_s[tid] = sc_t;
  asm volatile("cp.async.wait_all;" ::: "memory");
  // the tiles were written through the generic proxy; wgmma reads them
  // through the async one
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const bool alone = n_act == 1;
  if (warp < 4) {                       // warpgroup 0: the products
    // S = Q C^T: R / 16 k16 steps, box kk / 4, 32 bytes into its rows
    float sc[kTok / 2];
#pragma unroll
    for (int i = 0; i < kTok / 2; ++i) sc[i] = 0.0f;
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk)
      mma_ss<kTok>(sc,
                   desc_b128(base + Sh::kQ + (kk / 4) * Sh::kQBox + (kk % 4) * 32,
                             16, 1024),
                   desc_b128(base + Sh::kC + (kk / 4) * kTok * 128 + (kk % 4) * 32,
                             16, 1024),
                   1);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);

    // the softmax of the span, rows r0 and r0 + 8 (a quad shares a row); then
    // P = p * scale as two bf16 A fragments, hi and lo
    const int r0 = warp * 16 + lane / 4;
    float mx[2] = {kNegInf, kNegInf}, rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kTok / 2; ++i) {
      const int t = (i / 4) * 8 + (lane % 4) * 2 + (i % 2);
      const float x = t < n ? sc[i] * (sc_s[t] * sm_scale) : kNegInf;
      sc[i] = x;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(kFull, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(kFull, mx[hh], 2));
    }
#pragma unroll
    for (int i = 0; i < kTok / 2; ++i) {
      const int t = (i / 4) * 8 + (lane % 4) * 2 + (i % 2);
      const float p = t < n ? exp_sfu(sc[i] - mx[(i / 2) % 2]) : 0.0f;
      rs[(i / 2) % 2] += p;
      sc[i] = p * sc_s[t];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rs[hh] += __shfl_xor_sync(kFull, rs[hh], 1);
      rs[hh] += __shfl_xor_sync(kFull, rs[hh], 2);
    }
    uint32_t pa[kTok / 16][4], pl[kTok / 16][4];
    to_bf16_split<kTok>(sc, pa, pl);

    // O = hi C + lo C over this CTA's box: kTok / 16 k16 steps each
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTok / 16; ++kk) {
      const uint64_t dc = desc_b128(base + Sh::kC + box * kTok * 128 + kk * 16 * 128,
                                    kTok * 128, 1024);
      mma_rs_n64(acc, pa[kk], dc, 1);
      mma_rs_n64(acc, pl[kk], dc, 1);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_frags<kTok / 16>(pa);
    fence_frags<kTok / 16>(pl);

    // the span's partial of this box: straight to the output for a lane of
    // one span, else to its record
    float* const rec = scratch + ((static_cast<int64_t>(b) * n_span + g) * RB + box) * REC;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 8 * hh, col = 8 * j + 2 * (lane % 4);
        if (row < H && col < ncol) {
          const float2 v = make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
          if (alone)
            *reinterpret_cast<float2*>(acc_out + (static_cast<int64_t>(b) * H + row) * R +
                                       c0 + col) = v;
          else
            *reinterpret_cast<float2*>(rec + row * kBox + col) = v;
        }
      }
    if (lane % 4 == 0)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 8 * hh;
        if (row >= H) continue;
        if (!alone) {
          rec[H * kBox + row] = mx[hh];
          rec[H * kBox + H + row] = rs[hh];
        } else if (box == 0) {
          m_out[b * H + row] = mx[hh];
          l_out[b * H + row] = rs[hh];
        }
      }
  }
  if (alone) return;

  // the last CTA of this (lane, box) merges the spans' records of its
  // columns in span order (the counter's add as in the GQA kernel)
  __syncthreads();
  int* counter = counters + b * RB + box;
  if (tid == 0) {
    int prev;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;"
                 : "=r"(prev)
                 : "l"(counter)
                 : "memory");
    last_s = prev == n_act - 1;
  }
  __syncthreads();
  if (!last_s) return;
  const float* recs = scratch + (static_cast<int64_t>(b) * n_span * RB + box) * REC;
  constexpr int kStride = RB * REC;     // one span's record to the next
  // the spans' (m, l) [n_act][2][H] and weights [n_act][H], over the tiles:
  // every load at once, then a thread a head
  float* const gml_s = tiles_s;
  float* const gw_s = tiles_s + n_act * 2 * H;
  for (int i = tid; i < n_act * 2 * H; i += kThreads)
    gml_s[i] = __ldcg(recs + (i / (2 * H)) * kStride + H * kBox + i % (2 * H));
  __syncthreads();
  if (tid < H) {
    float M = kNegInf;
    for (int gg = 0; gg < n_act; ++gg) M = fmaxf(M, gml_s[gg * 2 * H + tid]);
    float L = 0.0f;
    for (int gg = 0; gg < n_act; ++gg) {
      const float w = expf(gml_s[gg * 2 * H + tid] - M);
      gw_s[gg * H + tid] = w;
      L += w * gml_s[gg * 2 * H + H + tid];
    }
    if (box == 0) {
      m_out[b * H + tid] = M;
      l_out[b * H + tid] = L;
    }
  }
  __syncthreads();
  // the columns, kBatch spans' loads in flight at once, summed in span order
  constexpr int kBatch = 16;
  const int n4 = ncol / 4;
  for (int i = tid; i < H * n4; i += kThreads) {
    const int h = i / n4, c = 4 * (i % n4);
    float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int g0 = 0; g0 < n_act; g0 += kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        v[j] = g0 + j < n_act
                   ? __ldcg(reinterpret_cast<const float4*>(
                         recs + (g0 + j) * kStride + h * kBox + c))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (g0 + j < n_act) o = fma4(gw_s[(g0 + j) * H + h], v[j], o);
    }
    *reinterpret_cast<float4*>(acc_out + (static_cast<int64_t>(b) * H + h) * R +
                               c0 + c) = o;
  }
  if (tid == 0) *counter = 0;
}

template <int H, int R, int BITS>
int launch(const void* q, const void* codes, const void* scales,
           const void* lengths, void* m, void* l, void* acc, void* scratch,
           void* counters, int B, int S, float sm_scale, cudaStream_t s) {
  using Sh = Shape<H, R>;
  const int n_span = (S + kTok - 1) / kTok;
  if (n_span > Sh::kMaxSpans)
    return cudaErrorInvalidValue;       // the last merge's weights: past the tiles
  auto kern = kvc_latent_tc_kernel<H, R, BITS>;
  static bool attr_set = false;         // above 48 KB needs the opt-in
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  kern<<<dim3(Sh::RB * B, n_span), kThreads, Sh::kSmem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scales), static_cast<const int*>(lengths),
      static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(acc),
      static_cast<float*>(scratch), static_cast<int*>(counters), S, n_span,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lat_tc

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for a shape the kernel does
// not take (D other than 64/80/128, bits other than 4/8, G = Hq/Hkv > 16).
// scratch holds B*Hkv*ceil(S/kChunk)*G*(D+2) floats; counters
// B*Hkv*ceil(G/8) int32 (a (lane, KV head, head slice) each), all 0 between
// calls.
extern "C" int kvc_attn_partial(const void* q, int q_f32, const void* kc,
                                const void* ks, const void* vc,
                                const void* vs, const void* lengths, void* m,
                                void* l, void* acc, void* scratch,
                                void* counters, int B, int S, int Hq, int Hkv,
                                int D, int bits, float sm_scale,
                                int empty_uniform, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv || Hq / Hkv > kMaxGroup || S <= 0)
    return cudaErrorInvalidValue;
  if (D == 128 && bits == 4)
    return launch<128, 4>(q, q_f32, kc, ks, vc, vs, lengths, m, l, acc, scratch, counters, B, S, Hq, Hkv, sm_scale, empty_uniform, s);
  if (D == 128 && bits == 8)
    return launch<128, 8>(q, q_f32, kc, ks, vc, vs, lengths, m, l, acc, scratch, counters, B, S, Hq, Hkv, sm_scale, empty_uniform, s);
  if (D == 64 && bits == 4)
    return launch<64, 4>(q, q_f32, kc, ks, vc, vs, lengths, m, l, acc, scratch, counters, B, S, Hq, Hkv, sm_scale, empty_uniform, s);
  if (D == 64 && bits == 8)
    return launch<64, 8>(q, q_f32, kc, ks, vc, vs, lengths, m, l, acc, scratch, counters, B, S, Hq, Hkv, sm_scale, empty_uniform, s);
  if (D == 80 && bits == 4)
    return launch<80, 4>(q, q_f32, kc, ks, vc, vs, lengths, m, l, acc, scratch, counters, B, S, Hq, Hkv, sm_scale, empty_uniform, s);
  if (D == 80 && bits == 8)
    return launch<80, 8>(q, q_f32, kc, ks, vc, vs, lengths, m, l, acc, scratch, counters, B, S, Hq, Hkv, sm_scale, empty_uniform, s);
  return cudaErrorInvalidValue;
}

// MLA's latent partial, f32 queries (the CUDA cores): q [B, H, R] f32,
// codes [B, S, R*bits/8] u8, scales [B, S] f32, lengths [B] -> m, l [B, H],
// acc [B, H, R] f32. Returns cudaErrorInvalidValue for a shape the kernel
// does not take ((H, R) other than minicpm3-4b's (40, 288), bits other than
// 4/8, S past what the merge's weights fit in shared memory). scratch holds
// B*ceil(S/kLatChunk)*H*(R+2) floats; counters B*KVC_LAT_CLUSTER int32 (a
// lane's cluster of CTAs), 0 between calls.
extern "C" int kvc_latent_partial(const void* q, const void* codes,
                                  const void* scales, const void* lengths,
                                  void* m, void* l, void* acc, void* scratch,
                                  void* counters, int B, int S, int H, int R,
                                  int bits, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return cudaErrorInvalidValue;
  if (H == 40 && R == 288 && bits == 4)
    return launch_latent<40, 288, KVC_LAT_CLUSTER, 4>(q, codes, scales, lengths, m, l, acc, scratch, counters, B, S, sm_scale, s);
  if (H == 40 && R == 288 && bits == 8)
    return launch_latent<40, 288, KVC_LAT_CLUSTER, 8>(q, codes, scales, lengths, m, l, acc, scratch, counters, B, S, sm_scale, s);
  return cudaErrorInvalidValue;
}

// MLA's latent partial, bf16 queries (the tensor cores): q [B, H, R] bf16,
// the rest as kvc_latent_partial. Returns cudaErrorInvalidValue for a shape
// the kernel does not take ((H, R) other than (40, 288), bits other than
// 4/8, S past what the last merge's weights fit in shared memory). scratch
// holds B*ceil(S/KVC_TC_TOKENS)*ceil(R/64)*(64H+2H) floats; counters
// B*ceil(R/64) int32 (a lane's column boxes), 0 between calls.
extern "C" int kvc_latent_partial_tc(const void* q, const void* codes,
                                     const void* scales, const void* lengths,
                                     void* m, void* l, void* acc,
                                     void* scratch, void* counters, int B,
                                     int S, int H, int R, int bits,
                                     float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return cudaErrorInvalidValue;
  if (H == 40 && R == 288 && bits == 4)
    return lat_tc::launch<40, 288, 4>(q, codes, scales, lengths, m, l, acc, scratch, counters, B, S, sm_scale, s);
  if (H == 40 && R == 288 && bits == 8)
    return lat_tc::launch<40, 288, 8>(q, codes, scales, lengths, m, l, acc, scratch, counters, B, S, sm_scale, s);
  return cudaErrorInvalidValue;
}
