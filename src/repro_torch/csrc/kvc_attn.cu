// One-token GQA decode attention over the KV cache's compressed region,
// dequantizing int4/int8 K/V inside the kernel, for Hopper (sm_90a); and
// its MLA form over the compressed latent cache (kvc_latent_partial, at
// the end of the file).
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
//   - grid (Hkv, B, n_split), n_split = ceil(S / CHUNK) fixed by S, so the
//     host reads no length. A CTA whose chunk starts at or past its lane's
//     span exits at once; a lane whose span is 0 has its split-0 CTA write
//     the empty partial straight to the output.
//   - a CTA of eight warps owns CHUNK (128) tokens of one (lane, KV head). All its
//     K and V codes are loaded at once into registers (16-byte reads for K;
//     4 or 8 bytes, 8 values, for V) and dequantized there without the
//     quarter-rate int-to-float convert (no shared-memory round trip for K
//     or V): 256 / CHUNK neighbouring threads score a token for the G heads
//     (q in shared memory, read as broadcasts) and sum their parts with
//     shuffles; a warp per head takes the chunk's max, exp and sum; then
//     thread (d-group, token-group) accumulates 8 dims of p.v over its
//     tokens, and the token groups are summed in a fixed order (shuffles,
//     then shared memory).
//   - a CTA that is its lane's only split writes the output directly.
//     Otherwise it writes (acc, m, l) for its G heads to scratch
//     [B, Hkv, n_split, G, D + 2] f32 and adds one to a per-(lane, KV head)
//     counter with an acq_rel atomic (the threadfence reduction, the fence
//     folded into the atomic); the CTA that brings it to the number of
//     splits merges splits 0..n-1 in index order, every output loading its
//     splits' (m, acc) in one round (so repeated calls give bit-identical
//     partials), and resets the counter to 0. The wrapper keeps the int32
//     counters per device, zeroed once: the kernel assumes one stream at a
//     time per counter buffer.
// Online softmax in f32 with expf; no fast math. What it still lacks: the
// chain of one CTA (lengths -> codes -> scores -> max -> p.v -> partial ->
// atomic -> merge) is serial, about 7 us for a lane of one chunk and 11 us
// with a merge at the serving shape, against a 1.7 us launch (PERF.md); at
// S = 2048 most of the ~1,000 CTAs exit at once.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;        // query heads per KV head
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

// NW 32-bit words of codes in loads of 16 bytes (or 8, or 4).
template <int NW>
__device__ __forceinline__ void load_words(const uint8_t* src, uint32_t (&w)[NW]) {
  if constexpr (NW == 1) {
    w[0] = *reinterpret_cast<const uint32_t*>(src);
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
    static_assert(NW % 2 == 0, "1, 2k or 4k words");
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
  constexpr int TG = kThreads / DG;     // token groups
  constexpr int VT = CHUNK / TG;        // V tokens a thread
  static_assert(TPT >= 1 && CHUNK % TG == 0 && DG <= 32, "chunk and D do not tile");
  __shared__ __align__(16) float q_s[kMaxG * D];
  __shared__ float p_s[kMaxG][CHUNK];
  __shared__ __align__(16) float red_s[kWarps][kMaxG * D];
  __shared__ float m_s[kMaxG], l_s[kMaxG];
  __shared__ int last_s;

  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(max(lengths[b], 0), S);
  const int span = (len == 0 && empty_uniform) ? S : len;
  const int n_active = (span + CHUNK - 1) / CHUNK;
  const int64_t row0 = static_cast<int64_t>(b) * Hq + h * G;
  if (split >= n_active) {
    if (split == 0) {                   // span 0: the empty partial
      for (int i = tid; i < G * D; i += kThreads) acc_out[row0 * D + i] = 0.0f;
      if (tid < G) {
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
  const int dg = tid % DG, tg = tid / DG;
  uint32_t vw[VT][BITS / 4];
  float vsc[VT];
#pragma unroll
  for (int j = 0; j < VT; ++j) {
    const int tt = tg + j * TG;
    vsc[j] = 0.0f;
#pragma unroll
    for (int w = 0; w < BITS / 4; ++w) vw[j][w] = 0u;
    if (tt < n) {
      const int64_t row = (static_cast<int64_t>(b) * S + c0 + tt) * Hkv + h;
      load_words<BITS / 4>(vc + row * DP + dg * BITS, vw[j]);
      vsc[j] = vs[row];
    }
  }
  for (int i = tid; i < G * D; i += kThreads) {
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
        if (g >= G) break;
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
      if (g >= G) break;
      s[g] += __shfl_xor_sync(kFull, s[g], o);
    }
  }
  if (part == 0 && tk < n) {
    const bool valid = c0 + tk < len;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      p_s[g][tk] = valid ? s[g] * sm_scale : kNegInf;
    }
  }
  __syncthreads();

  // per head (a warp each): the chunk's max, p = exp(s - m) in place, l
  if (warp < G) {
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
      if (g >= G) break;
      const float p = p_s[g][tt];     // 0 past the chunk's tokens
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] += p * val[e];
    }
  }
  // token groups: first inside the warp, then across warps
#pragma unroll
  for (int o = DG; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[g][e] += __shfl_xor_sync(kFull, acc[g][e], o);
    }
  }
  if (lane < DG) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int e = 0; e < 8; ++e) red_s[warp][g * D + dg * 8 + e] = acc[g][e];
    }
  }
  __syncthreads();

  const bool alone = n_active == 1;
  float* part_out = scratch +
      ((static_cast<int64_t>(b) * Hkv + h) * n_split + split) * G * (D + 2);
  for (int i = tid; i < G * D; i += kThreads) {
    float a = red_s[0][i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) a += red_s[w][i];
    const int g = i / D, d = i % D;
    if (alone) acc_out[row0 * D + i] = a;
    else part_out[g * (D + 2) + d] = a;
  }
  if (tid < G) {
    if (alone) {
      m_out[row0 + tid] = m_s[tid];
      l_out[row0 + tid] = l_s[tid];
    } else {
      part_out[tid * (D + 2) + D] = m_s[tid];
      part_out[tid * (D + 2) + D + 1] = l_s[tid];
    }
  }
  if (alone) return;

  // The last CTA of this (lane, KV head) merges the splits. The counter's
  // add is acq_rel at gpu scope: after the barrier it releases this CTA's
  // partial, and the last adder acquires all of them. Every output then
  // loads its splits' (m, acc) together, kMerge at a time, and merges them
  // online in index order (fixed: repeated calls agree bit for bit).
  __syncthreads();
  int* counter = counters + b * Hkv + h;
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
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mx = kNegInf, l = 0.0f, a = 0.0f;
    for (int sp0 = 0; sp0 < n_active; sp0 += kMerge) {
      float mv[kMerge], av[kMerge], lv[kMerge];
#pragma unroll
      for (int j = 0; j < kMerge; ++j) {
        const bool in = sp0 + j < n_active;
        const float* pp = parts + ((sp0 + j) * G + g) * (D + 2);
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
  kvc_split_kernel<D, BITS, kChunk><<<dim3(Hkv, B, n_split), kThreads, 0, s>>>(
      q, q_f32, static_cast<const uint8_t*>(kc), static_cast<const float*>(ks),
      static_cast<const uint8_t*>(vc), static_cast<const float*>(vs),
      static_cast<const int*>(lengths), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(acc),
      static_cast<float*>(scratch), static_cast<int*>(counters), S, Hq, Hkv,
      n_split, sm_scale, empty_uniform);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// MLA's latent decode partial: one code stream, K = V.
// ---------------------------------------------------------------------------
//
// The absorbed MLA decode (models/decode.py::mla_decode_layer) attends H
// query heads of R values (minicpm3-4b: 40 heads, R = kv_lora_rank 256 +
// rope 32 = 288; q_nope folded through W_uk) over one latent row a token,
// shared by every head: a single KV head, and the key and the value are
// the same codes. The GQA kernel above holds a (lane, KV head)'s G <= 8
// heads' accumulators in one CTA, D <= 128; here 40 heads x 288 f32 is 46
// KB, and one CTA for each 64 tokens of 8 lanes of a few hundred tokens
// (~43 CTAs) would leave most of the 132 SMs idle. So the design differs:
//   - grid (CL * n_split, B) in clusters of CL CTAs (2), with n_split =
//     ceil(S / kLatChunk) fixed by S (the host reads no length). A cluster
//     owns kLatChunk (32) tokens of one lane; its CTA of rank r owns heads
//     [r H/CL, (r + 1) H/CL) (20), with R threads, one latent column each.
//     At the main path's lengths that is ~160 working CTAs, 3 a SM by
//     shared memory (63 KB): one wave. More CTAs a chunk (clusters of 4)
//     fill more SMs at short lengths but need a second wave at long ones,
//     and each CTA adds a q load, a tile copy and a merge input
//     (tools/sweep_attn.py times the candidates; PERF.md has the times).
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
// Bound: operations. A token costs 4 * 40 * 288 flops (scores and p.v)
// against its 148 code bytes (4-bit): 311 flops a byte, above the f32 CUDA
// cores' 20 flops a byte (67 TFLOP/s over 3.35 TB/s): 8 lanes of ~450
// tokens are 166 MFLOP, 2.5 us at the f32 peak, against 0.16 us for their
// bytes (PERF.md has the measured time). Kept on the CUDA cores in f32, as
// the reference's jnp partial computes it; a tensor-core (bf16 wgmma) form
// is a later PR's. The shape (H, R, CL) is a template: another MLA config
// needs an instantiation in kvc_latent_partial, H % CL == 0, R % 32 == 0.

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
kvc_latent_kernel(const void* __restrict__ q, int q_f32,
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
  for (int i = tid; i < HC * R; i += T) {
    const int64_t qi = row0 * R + i;
    q_s[i] = q_f32 ? static_cast<const float*>(q)[qi]
                   : __bfloat162float(static_cast<const __nv_bfloat16*>(q)[qi]);
  }
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
int launch_latent(const void* q, int q_f32, const void* codes,
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
      &cfg, kern, q, q_f32, static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scales), static_cast<const int*>(lengths),
      static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(acc),
      static_cast<float*>(scratch), static_cast<int*>(counters), S, n_split,
      sm_scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for a shape the kernel does
// not take (D other than 64/128, bits other than 4/8, G = Hq/Hkv > 8).
// scratch holds B*Hkv*ceil(S/kChunk)*G*(D+2) floats; counters B*Hkv int32,
// all 0 between calls.
extern "C" int kvc_attn_partial(const void* q, int q_f32, const void* kc,
                                const void* ks, const void* vc,
                                const void* vs, const void* lengths, void* m,
                                void* l, void* acc, void* scratch,
                                void* counters, int B, int S, int Hq, int Hkv,
                                int D, int bits, float sm_scale,
                                int empty_uniform, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv || Hq / Hkv > kMaxG || S <= 0)
    return cudaErrorInvalidValue;
  if (D == 128 && bits == 4)
    return launch<128, 4>(q, q_f32, kc, ks, vc, vs, lengths, m, l, acc, scratch, counters, B, S, Hq, Hkv, sm_scale, empty_uniform, s);
  if (D == 128 && bits == 8)
    return launch<128, 8>(q, q_f32, kc, ks, vc, vs, lengths, m, l, acc, scratch, counters, B, S, Hq, Hkv, sm_scale, empty_uniform, s);
  if (D == 64 && bits == 4)
    return launch<64, 4>(q, q_f32, kc, ks, vc, vs, lengths, m, l, acc, scratch, counters, B, S, Hq, Hkv, sm_scale, empty_uniform, s);
  if (D == 64 && bits == 8)
    return launch<64, 8>(q, q_f32, kc, ks, vc, vs, lengths, m, l, acc, scratch, counters, B, S, Hq, Hkv, sm_scale, empty_uniform, s);
  return cudaErrorInvalidValue;
}

// MLA's latent partial: q [B, H, R] (bf16, or f32 when q_f32), codes [B,
// S, R*bits/8] u8, scales [B, S] f32, lengths [B] -> m, l [B, H], acc [B,
// H, R] f32. Returns cudaErrorInvalidValue for a shape the kernel does not
// take ((H, R) other than minicpm3-4b's (40, 288), bits other than 4/8, S
// past what the merge's weights fit in shared memory). scratch holds
// B*ceil(S/kLatChunk)*H*(R+2) floats; counters B*KVC_LAT_CLUSTER int32 (a
// lane's cluster of CTAs), 0 between calls.
extern "C" int kvc_latent_partial(const void* q, int q_f32, const void* codes,
                                  const void* scales, const void* lengths,
                                  void* m, void* l, void* acc, void* scratch,
                                  void* counters, int B, int S, int H, int R,
                                  int bits, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return cudaErrorInvalidValue;
  if (H == 40 && R == 288 && bits == 4)
    return launch_latent<40, 288, KVC_LAT_CLUSTER, 4>(q, q_f32, codes, scales, lengths, m, l, acc, scratch, counters, B, S, sm_scale, s);
  if (H == 40 && R == 288 && bits == 8)
    return launch_latent<40, 288, KVC_LAT_CLUSTER, 8>(q, q_f32, codes, scales, lengths, m, l, acc, scratch, counters, B, S, sm_scale, s);
  return cudaErrorInvalidValue;
}
