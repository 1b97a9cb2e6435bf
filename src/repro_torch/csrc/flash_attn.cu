// Causal or full GQA attention forward (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/flash_attn.py::flash_attention
// (_flash_kernel) of the JAX package, whose serving path computes the same
// attention with layers.chunked_attention (models/decode.py::prefill).
//
//   q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] (bf16, or all f32) ->
//   o [B, Sq, Hq, D] in q's type; query head h reads KV head h / (Hq/Hkv).
//   Causal: query row i sees key columns c <= i + (Sk - Sq), the mask of
//   chunked_attention and mha_ref (the TPU kernel's c <= i is the case
//   Sq == Sk); masked scores are -1e30 as in the reference.
//
// Bound: at the serving shape (B 8, S 1024, Hq 32, D 128, causal) the
// work is about 4*B*Hq*S*S*D/2 = 69 GFLOP a layer against 50 MB of q, k, v
// and o: operations, by far (989 TFLOP/s bf16 on the tensor cores). This
// first kernel does not reach the tensor cores: it is the simple, right
// schedule, on the CUDA cores in f32. A CTA of four warps owns 32 query
// rows of one head (8 rows a warp). It walks the key tiles of 32 up to the
// causal limit of its last row (block skip), stages each K/V tile in shared
// memory as f32 (K rows padded so that each lane's float4 reads hit
// distinct banks), and keeps an online softmax per row in registers: lane
// j scores key j of the tile for all 8 rows (q pre-scaled by sm_scale, as
// chunked_attention does), then accumulates dims j, j + 32, ... of p.v.
// Any Sq, Sk >= 1 (ragged tiles are masked; causal needs Sq <= Sk, so
// every row sees a key). Moving the two products to wgmma with TMA-fed
// tiles is the redesign queued in ROADMAP.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;         // query rows per CTA
constexpr int kBK = 32;         // keys per tile, one per lane
constexpr int kWarps = 4;
constexpr int kRPW = kBQ / kWarps;
constexpr float kNegInf = -1e30f;
constexpr float kOutside = -3.0e38f;   // a column past Sk: takes no part
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * D + kBK * (D + 4) + kBK * D);
}

template <int D, typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int Hq, int Hkv, float sm_scale, int causal) {
  constexpr int KS = D + 4;
  constexpr int DL = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // [kBQ][D], pre-scaled
  float* k_s = q_s + kBQ * D;           // [kBK][KS]
  float* v_s = k_s + kBK * KS;          // [kBK][D]

  const int i0 = blockIdx.x * kBQ, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < kBQ * D; i += kWarps * 32) {
    const int r = i / D, d = i % D, row = i0 + r;
    q_s[i] = row < Sq
        ? to_f(q[((static_cast<int64_t>(b) * Sq + row) * Hq + hq) * D + d]) * sm_scale
        : 0.0f;
  }
  const int off = Sk - Sq;
  const int kend = causal ? min(Sk, i0 + kBQ + off) : Sk;

  float m[kRPW], l[kRPW], acc[kRPW][DL];
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.0f;
#pragma unroll
    for (int dl = 0; dl < DL; ++dl) acc[rr][dl] = 0.0f;
  }

  for (int j0 = 0; j0 < kend; j0 += kBK) {
    __syncthreads();                    // the previous tile is consumed
    for (int i = tid; i < kBK * D; i += kWarps * 32) {
      const int r = i / D, d = i % D, c = j0 + r;
      float kv = 0.0f, vv = 0.0f;
      if (c < Sk) {
        const int64_t idx = ((static_cast<int64_t>(b) * Sk + c) * Hkv + hk) * D + d;
        kv = to_f(k[idx]);
        vv = to_f(v[idx]);
      }
      k_s[r * KS + d] = kv;
      v_s[r * D + d] = vv;
    }
    __syncthreads();

    const int c = j0 + lane;
    const bool inside = c < Sk;
    float s[kRPW];
#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr) s[rr] = 0.0f;
    const float4* krow = reinterpret_cast<const float4*>(k_s + lane * KS);
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 kk = krow[d4];
#pragma unroll
      for (int rr = 0; rr < kRPW; ++rr) {
        const float4 a =
            reinterpret_cast<const float4*>(q_s + (warp * kRPW + rr) * D)[d4];
        s[rr] += a.x * kk.x + a.y * kk.y + a.z * kk.z + a.w * kk.w;
      }
    }
    float p[kRPW];
#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr) {
      const int row = i0 + warp * kRPW + rr;
      float sv = (causal && c > row + off) ? kNegInf : s[rr];
      sv = inside ? sv : kOutside;
      const float m_new = fmaxf(m[rr], warp_max(sv));
      const float alpha = expf(m[rr] - m_new);
      p[rr] = inside ? expf(sv - m_new) : 0.0f;
      l[rr] = l[rr] * alpha + warp_sum(p[rr]);
      m[rr] = m_new;
#pragma unroll
      for (int dl = 0; dl < DL; ++dl) acc[rr][dl] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vj[DL];
#pragma unroll
      for (int dl = 0; dl < DL; ++dl) vj[dl] = v_s[j * D + lane + 32 * dl];
#pragma unroll
      for (int rr = 0; rr < kRPW; ++rr) {
        const float pj = __shfl_sync(kFull, p[rr], j);
#pragma unroll
        for (int dl = 0; dl < DL; ++dl) acc[rr][dl] += pj * vj[dl];
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) {
    const int row = i0 + warp * kRPW + rr;
    if (row >= Sq) continue;
    const float den = fmaxf(l[rr], 1e-30f);
    T* out = o + ((static_cast<int64_t>(b) * Sq + row) * Hq + hq) * D + lane;
#pragma unroll
    for (int dl = 0; dl < DL; ++dl) from_f(out + 32 * dl, acc[rr][dl] / den);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int Hq, int Hkv, float sm_scale, int causal,
           cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D>();
  static bool attr_set = false;         // above 48 KB needs the opt-in
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<D, T><<<grid, kWarps * 32, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, Hq, Hkv,
      sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t: cudaErrorInvalidValue for a shape the kernel does
// not take (D other than 64/128, Hq not a multiple of Hkv).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, int in_f32, int B, int Sq, int Sk,
                              int Hq, int Hkv, int D, float sm_scale,
                              int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv) return cudaErrorInvalidValue;
  if (D == 128)
    return in_f32 ? launch<128, float>(q, k, v, o, B, Sq, Sk, Hq, Hkv, sm_scale, causal, s)
                  : launch<128, __nv_bfloat16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, sm_scale, causal, s);
  if (D == 64)
    return in_f32 ? launch<64, float>(q, k, v, o, B, Sq, Sk, Hq, Hkv, sm_scale, causal, s)
                  : launch<64, __nv_bfloat16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, sm_scale, causal, s);
  return cudaErrorInvalidValue;
}
