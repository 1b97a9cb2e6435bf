// One-token GQA decode attention over the KV cache's compressed region,
// dequantizing int4/int8 K/V inside the kernel, for Hopper (sm_90a).
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
// the arithmetic is 4*G*D flops a token, far under the card's rate. The
// design: one CTA of four warps per (lane, KV head) walks the sequence in
// tiles of 32 tokens up to lengths[b] and skips the rest. Each tile is
// loaded with 16-byte reads, dequantized once into shared memory (K rows
// padded so that a lane's float4 reads hit distinct banks), and used by all
// G heads: warp w takes heads w and w + 4, lane j token j of the tile for
// the scores and dims j, j + 32, ... for acc. Online softmax in f32 with
// expf; no fast math. Simple first: B*Hkv CTAs (64 at the serving shape)
// leave most of the 132 SMs idle on a long sequence; splitting the
// sequence across CTAs is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 32;          // tokens per tile, one per lane
constexpr int kWarps = 4;
constexpr int kMaxG = 8;        // query heads per KV head
constexpr float kNegInf = -1e30f;
constexpr float kOutside = -3.0e38f;   // a slot past S: takes no part
constexpr unsigned kFull = 0xffffffffu;

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

// 16 code bytes -> 32 (4-bit) or 16 (8-bit) f32 values, code * scale.
template <int BITS>
__device__ __forceinline__ void dequant16(const uint8_t* src, float scale,
                                          float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if constexpr (BITS == 4) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int nib = static_cast<int>((w[t] >> (4 * i)) & 0xFu);
        dst[8 * t + i] = static_cast<float>(nib >= 8 ? nib - 16 : nib) * scale;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dst[4 * t + i] = static_cast<float>(
            static_cast<int8_t>((w[t] >> (8 * i)) & 0xFFu)) * scale;
    }
  }
}

template <int D, int BITS>
__global__ void __launch_bounds__(kWarps * 32)
kvc_partial_kernel(const void* __restrict__ q, int q_f32,
                   const uint8_t* __restrict__ kc, const float* __restrict__ ks,
                   const uint8_t* __restrict__ vc, const float* __restrict__ vs,
                   const int* __restrict__ lengths, float* __restrict__ m_out,
                   float* __restrict__ l_out, float* __restrict__ acc_out,
                   int S, int Hq, int Hkv, float sm_scale, int empty_uniform) {
  constexpr int DP = D * BITS / 8;      // code bytes per (token, head)
  constexpr int CPR = DP / 16;          // 16-byte chunks per row
  constexpr int VPC = 128 / BITS;       // values per chunk
  constexpr int KS = D + 4;             // padded K row
  constexpr int DL = D / 32;            // acc values per lane
  constexpr int HPW = kMaxG / kWarps;   // heads per warp
  __shared__ __align__(16) float k_s[kT * KS];
  __shared__ __align__(16) float v_s[kT * D];
  __shared__ __align__(16) float q_s[kMaxG * D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t qbase = (static_cast<int64_t>(b) * Hq + h * G) * D;
  for (int i = tid; i < G * D; i += kWarps * 32)
    q_s[i] = q_f32 ? static_cast<const float*>(q)[qbase + i]
                   : __bfloat162float(
                         static_cast<const __nv_bfloat16*>(q)[qbase + i]);
  const int len = min(max(lengths[b], 0), S);
  const int span = (len == 0 && empty_uniform) ? S : len;

  float m[HPW], l[HPW], acc[HPW][DL];
#pragma unroll
  for (int hg = 0; hg < HPW; ++hg) {
    m[hg] = kNegInf;
    l[hg] = 0.0f;
#pragma unroll
    for (int dl = 0; dl < DL; ++dl) acc[hg][dl] = 0.0f;
  }

  for (int t0 = 0; t0 < span; t0 += kT) {
    __syncthreads();                    // the previous tile is consumed
    for (int i = tid; i < 2 * kT * CPR; i += kWarps * 32) {
      const int which = i / (kT * CPR);             // 0: K, 1: V
      const int r = (i / CPR) % kT, c = i % CPR;
      const int t = t0 + r;
      float vals[VPC];
      if (t < S) {
        const int64_t row = (static_cast<int64_t>(b) * S + t) * Hkv + h;
        dequant16<BITS>((which ? vc : kc) + row * DP + c * 16,
                        (which ? vs : ks)[row], vals);
      } else {
#pragma unroll
        for (int j = 0; j < VPC; ++j) vals[j] = 0.0f;
      }
      float4* dst = reinterpret_cast<float4*>(
          which ? v_s + r * D + c * VPC : k_s + r * KS + c * VPC);
#pragma unroll
      for (int j = 0; j < VPC / 4; ++j)
        dst[j] = make_float4(vals[4 * j], vals[4 * j + 1], vals[4 * j + 2],
                             vals[4 * j + 3]);
    }
    __syncthreads();

    const int t = t0 + lane;
    const bool inside = t < S;
    const bool valid = t < len;
    const float4* krow = reinterpret_cast<const float4*>(k_s + lane * KS);
#pragma unroll
    for (int hg = 0; hg < HPW; ++hg) {
      const int g = warp + hg * kWarps;
      if (g >= G) break;                // uniform over the warp
      const float4* qrow = reinterpret_cast<const float4*>(q_s + g * D);
      float s = 0.0f;
#pragma unroll 8
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 a = qrow[d4], kk = krow[d4];
        s += a.x * kk.x + a.y * kk.y + a.z * kk.z + a.w * kk.w;
      }
      s *= sm_scale;
      const float sv = inside ? (valid ? s : kNegInf) : kOutside;
      const float m_new = fmaxf(m[hg], warp_max(sv));
      const float alpha = expf(m[hg] - m_new);
      const float p = inside ? expf(sv - m_new) : 0.0f;
      l[hg] = l[hg] * alpha + warp_sum(p);
      m[hg] = m_new;
#pragma unroll
      for (int dl = 0; dl < DL; ++dl) acc[hg][dl] *= alpha;
#pragma unroll 4
      for (int j = 0; j < kT; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
        const float* vrow = v_s + j * D + lane;
#pragma unroll
        for (int dl = 0; dl < DL; ++dl) acc[hg][dl] += pj * vrow[32 * dl];
      }
    }
  }

#pragma unroll
  for (int hg = 0; hg < HPW; ++hg) {
    const int g = warp + hg * kWarps;
    if (g >= G) break;
    const int64_t row = static_cast<int64_t>(b) * Hq + h * G + g;
#pragma unroll
    for (int dl = 0; dl < DL; ++dl) acc_out[row * D + lane + 32 * dl] = acc[hg][dl];
    if (lane == 0) {
      m_out[row] = m[hg];
      l_out[row] = l[hg];
    }
  }
}

template <int D, int BITS>
void launch(const void* q, int q_f32, const void* kc, const void* ks,
            const void* vc, const void* vs, const void* lengths, void* m,
            void* l, void* acc, int B, int S, int Hq, int Hkv,
            float sm_scale, int empty_uniform, cudaStream_t s) {
  kvc_partial_kernel<D, BITS><<<dim3(Hkv, B), kWarps * 32, 0, s>>>(
      q, q_f32, static_cast<const uint8_t*>(kc), static_cast<const float*>(ks),
      static_cast<const uint8_t*>(vc), static_cast<const float*>(vs),
      static_cast<const int*>(lengths), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(acc), S, Hq, Hkv, sm_scale,
      empty_uniform);
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for a shape the kernel does
// not take (D other than 64/128, bits other than 4/8, G = Hq/Hkv > 8).
extern "C" int kvc_attn_partial(const void* q, int q_f32, const void* kc,
                                const void* ks, const void* vc,
                                const void* vs, const void* lengths, void* m,
                                void* l, void* acc, int B, int S, int Hq,
                                int Hkv, int D, int bits, float sm_scale,
                                int empty_uniform, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv || Hq / Hkv > kMaxG) return cudaErrorInvalidValue;
  if (D == 128 && bits == 4)
    launch<128, 4>(q, q_f32, kc, ks, vc, vs, lengths, m, l, acc, B, S, Hq, Hkv, sm_scale, empty_uniform, s);
  else if (D == 128 && bits == 8)
    launch<128, 8>(q, q_f32, kc, ks, vc, vs, lengths, m, l, acc, B, S, Hq, Hkv, sm_scale, empty_uniform, s);
  else if (D == 64 && bits == 4)
    launch<64, 4>(q, q_f32, kc, ks, vc, vs, lengths, m, l, acc, B, S, Hq, Hkv, sm_scale, empty_uniform, s);
  else if (D == 64 && bits == 8)
    launch<64, 8>(q, q_f32, kc, ks, vc, vs, lengths, m, l, acc, B, S, Hq, Hkv, sm_scale, empty_uniform, s);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}
