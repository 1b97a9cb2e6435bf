// Fixed-rate block quantize + pack (encode) and its inverse (decode) for
// Hopper (sm_90a): the KV cache's compressed region; and the decode step's
// ring step, which does the hot window's eviction with the same quantize.
//
// Replaces the TPU kernels kernels/qpack.py::qpack_encode_2d
// (_encode_kernel) and ::qpack_decode_2d (_decode_kernel) of the JAX
// package, with the shape contract of their wrappers kernels/ops.py::
// qpack_encode / qpack_decode: N blocks of `block` values each (any even
// block; the TPU's 256-value rows and TILE=8 padding are not needed here).
// The bytes are identical to core/compressor.py::quantize_blocks /
// dequantize_blocks:
//
//   encode, per block: amax = max |x| (f32); scale = amax * f32(1/qmax),
//     or 1 when amax == 0; recip = 1 / scale (IEEE division); q = clip(
//     rint(x * recip), -qmax - 1, qmax) (round half to even); 4-bit codes
//     packed two to a byte, low nibble first; 8-bit codes as int8.
//   decode: sign-extended nibbles or int8 codes, times the block's scale,
//     rounded once to the output type (bf16 or f32).
//
// Bound: one pass over memory with no reuse. Encode reads the input once
// (2 or 4 bytes a value) and writes bits/8 bytes a value plus 4 bytes a
// block; decode the reverse. At 3.35 TB/s a 128-value bf16 block costs
// about 0.1 ns to encode. The design: a group of TPB threads (a power of two
// up to a warp) owns one block; each thread takes 8 values at a time with a
// 16-byte load (bf16) or two (f32), the group's amax is a shuffle reduction
// inside the warp, and the second pass re-reads the block from L1. Stores
// are 4 or 8 bytes a thread. No shared memory, no atomics, any N >= 1.
// Built without fast math and with --fmad=false, so each product and the
// reciprocal round exactly as the plain version's do.
//
// Ring step (qpack_ring_step): one decode step's hot-window update of one
// layer, K and V, in place and in one launch: for each lane b and KV head,
// read the ring slot pos[b] % W; when pos[b] - W >= cold_len[b], quantize
// it (encode_block, the encode's own body) into codes/scales at position
// pos[b] - W; then write the new token into the slot. pos and cold_len are
// read on the card, so the step needs no host sync. It replaces an eager
// chain of about 48 launches a layer (models/decode.py's eviction: the
// slot gather, the encode, the index arithmetic and masked scatters, and
// the two ring inserts). Bound: it moves about 2 * B * Hkv * (3D + D*bits/8
// + 4) bytes, some 10 ns at llama3-8b's widths, so the call costs the
// latency of one launch. A group of D/8 threads (16 at D 128) owns one
// (lane, head, K or V) block, so one warp does K and V of a head.
//
// Prefill fill (qpack_prefill_fill): a prefill layer's cache writes, K and
// V, in one launch: every prompt token quantized (encode_block) straight
// into the strided codes/scales rows [:, :S] of the layer's cache, and the
// ring's W slots copied from their source tokens in bf16. It replaces
// about 8 device events a layer (the encode, the codes and scales copies,
// the ring gather and its copy, for K and for V). Bound: at llama3-8b's
// widths one 1,024-token row moves about 6.3 MB, some 2 us.
//
// Lane flush (qpack_lane_flush): the device half of a lane demotion, K and
// V of all layers in one launch: only the live ring tokens, positions
// [max(cold_len, pos - W), pos), are quantized from slot p % W into the
// lane's codes and scales at p, in place, and each layer's cold_len
// clamped to pos goes to a fresh output. It replaces about 29 device events
// and some 200 MB of traffic for each of K and V (the whole ring converted to f32 and
// quantized, masks, a gather of codes over every position and two
// where-selects over the lane's region, for K and for V). In place is
// safe: serve/engine.py parks (copies to the host) the lane's codes right
// after the flush, and nothing reads the lane's slice again before
// _install_parked or _lanes_install overwrites all of it (the decode steps
// in between run the lane inactive and drop its output). Bound: a live
// ring of 256 tokens in each of 32 layers reads 33.6 MB of bf16 (K and V)
// and writes 8.9 MB of codes and scales at llama3-8b's widths, some 13 us.
// One group of D/8 threads a (layer, K or V, position, head) block, as in
// the ring step.
//
// MLA's latent cache (models/decode.py, minicpm3-4b) is one stream of rows
// of R = kv_lora_rank + rope = 288 values with no head axis, which is both
// the key and the value of all 40 heads. The three steps take it as a
// stream count of 1 (streams; the V pointers are then unused) and H = 1: a
// warp owns a 288-value row (36 chunks of 8 values, one or two a thread),
// its codes 144 (4-bit) or 288 bytes, 16-byte multiples.
// Bound at minicpm3's widths: the latent ring step moves about 8 * (3 *
// 576 + 148) bytes, under 5 ns at 3.35 TB/s, so it costs one launch; a
// 1,024-token prefill row's latent fill about 1.0 MB, 0.3 us; a lane flush
// of a live ring of 256 tokens in 62 layers 11.5 MB, 3.4 us.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <int NV>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p, float* v) {
  if constexpr (NV == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      v[2 * t] = __uint_as_float((w[t] & 0xffffu) << 16);
      v[2 * t + 1] = __uint_as_float(w[t] & 0xffff0000u);
    }
  } else {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    v[0] = __uint_as_float((w & 0xffffu) << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
}

template <int NV>
__device__ __forceinline__ void load_vals(const float* p, float* v) {
  if constexpr (NV == 8) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  }
}

// One block of `block` values at xb, owned by a group of tpb threads (a
// power of two up to 32, aligned inside the warp): thread `sub` takes the
// chunks of VPC values sub, sub + tpb, ... The group's amax is a shuffle
// reduction, so every thread of the warp must call this; a thread with
// store false takes part in the reduction and writes nothing. Writes the
// packed codes at out and the scale at *scale_out.
template <int VPC, typename TIn>
__device__ __forceinline__ void encode_block(const TIn* __restrict__ xb,
                                             uint8_t* __restrict__ out,
                                             float* __restrict__ scale_out,
                                             int block, int bits, int sub,
                                             int tpb, bool store) {
  const int nchunks = block / VPC;
  const float qmax = bits == 4 ? 7.0f : 127.0f;
  const float inv = bits == 4 ? static_cast<float>(1.0 / 7.0)
                              : static_cast<float>(1.0 / 127.0);

  float amax = 0.0f;
  for (int c = sub; c < nchunks; c += tpb) {
    float v[VPC];
    load_vals<VPC>(xb + c * VPC, v);
#pragma unroll
    for (int i = 0; i < VPC; ++i) amax = fmaxf(amax, fabsf(v[i]));
  }
  for (int o = tpb >> 1; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, o));
  const float scale = amax > 0.0f ? __fmul_rn(amax, inv) : 1.0f;
  const float recip = __fdiv_rn(1.0f, scale);
  if (!store) return;

  for (int c = sub; c < nchunks; c += tpb) {
    float v[VPC];
    load_vals<VPC>(xb + c * VPC, v);
    int q[VPC];
#pragma unroll
    for (int i = 0; i < VPC; ++i)
      q[i] = static_cast<int>(
          fminf(fmaxf(rintf(__fmul_rn(v[i], recip)), -qmax - 1.0f), qmax));
    if (bits == 4) {
      uint8_t* o = out + c * (VPC / 2);
      if constexpr (VPC == 8) {
        uint32_t w = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) w |= static_cast<uint32_t>(q[i] & 0xF) << (4 * i);
        *reinterpret_cast<uint32_t*>(o) = w;
      } else {
        *o = static_cast<uint8_t>((q[0] & 0xF) | ((q[1] & 0xF) << 4));
      }
    } else {
      uint8_t* o = out + c * VPC;
      if constexpr (VPC == 8) {
        uint2 w;
        w.x = (q[0] & 0xFF) | ((q[1] & 0xFF) << 8) | ((q[2] & 0xFF) << 16) |
              (static_cast<uint32_t>(q[3] & 0xFF) << 24);
        w.y = (q[4] & 0xFF) | ((q[5] & 0xFF) << 8) | ((q[6] & 0xFF) << 16) |
              (static_cast<uint32_t>(q[7] & 0xFF) << 24);
        *reinterpret_cast<uint2*>(o) = w;
      } else {
        *reinterpret_cast<uint16_t*>(o) =
            static_cast<uint16_t>((q[0] & 0xFF) | ((q[1] & 0xFF) << 8));
      }
    }
  }
  if (sub == 0) *scale_out = scale;
}

// VPC values per chunk (8, or 2 when the block is not a multiple of 8);
// groups of (1 << tpb_log2) threads per block.
template <int VPC, typename TIn>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const TIn* __restrict__ x, uint8_t* __restrict__ codes,
              float* __restrict__ scales, int n, int block, int bits,
              int tpb_log2) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int tpb = 1 << tpb_log2;
  int64_t blk = g >> tpb_log2;
  const int sub = static_cast<int>(g & (tpb - 1));
  const bool live = blk < n;
  if (!live) blk = n - 1;              // still joins the group's shuffles
  encode_block<VPC>(x + blk * block, codes + blk * (block * bits / 8),
                    scales + blk, block, bits, sub, tpb, live);
}

template <int NV>
__device__ __forceinline__ void store_vals(__nv_bfloat16* p, const float* v) {
  if constexpr (NV == 8) {
    uint32_t w[4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      w[t] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * t]))) |
             (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * t + 1]))) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *reinterpret_cast<uint32_t*>(p) =
        static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[0]))) |
        (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[1]))) << 16);
  }
}

template <int NV>
__device__ __forceinline__ void store_vals(float* p, const float* v) {
  if constexpr (NV == 8) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// One thread per chunk of VPC values.
template <int VPC, typename TOut>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint8_t* __restrict__ codes,
              const float* __restrict__ scales, TOut* __restrict__ out,
              int64_t n_chunks, int block, int bits) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= n_chunks) return;
  const int per = block / VPC;
  const int64_t blk = g / per;
  const int c = static_cast<int>(g - blk * per);
  const float scale = scales[blk];
  int q[VPC];
  if (bits == 4) {
    const uint8_t* in = codes + blk * (block / 2) + c * (VPC / 2);
    uint32_t w;
    if constexpr (VPC == 8) w = *reinterpret_cast<const uint32_t*>(in);
    else w = static_cast<uint32_t>(*in);
#pragma unroll
    for (int i = 0; i < VPC; ++i) {
      const int nib = static_cast<int>((w >> (4 * i)) & 0xFu);
      q[i] = nib >= 8 ? nib - 16 : nib;
    }
  } else {
    const uint8_t* in = codes + blk * block + c * VPC;
    uint32_t w[2] = {0u, 0u};
    if constexpr (VPC == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(in);
      w[0] = u.x; w[1] = u.y;
    } else {
      w[0] = *reinterpret_cast<const uint16_t*>(in);
    }
#pragma unroll
    for (int i = 0; i < VPC; ++i)
      q[i] = static_cast<int>(static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xFFu));
  }
  float v[VPC];
#pragma unroll
  for (int i = 0; i < VPC; ++i) v[i] = __fmul_rn(static_cast<float>(q[i]), scale);
  store_vals<VPC>(out + blk * block + c * VPC, v);
}

// The ring step: block blk = (b * H + h) * streams + kind (kind 1 = V),
// groups of (1 << tpb_log2) threads, 8 values a chunk (D % 8 == 0).
template <typename THot, typename TNew>
__global__ void __launch_bounds__(kThreads)
ring_step_kernel(uint8_t* __restrict__ k_codes, float* __restrict__ k_scales,
                 THot* k_hot, uint8_t* __restrict__ v_codes,
                 float* __restrict__ v_scales, THot* v_hot,
                 const TNew* __restrict__ k_new,
                 const TNew* __restrict__ v_new,
                 const int32_t* __restrict__ pos,
                 const int32_t* __restrict__ cold_len, int B, int S, int W,
                 int H, int D, int bits, int streams, int tpb_log2) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int tpb = 1 << tpb_log2;
  const int nblk = streams * B * H;
  int64_t blk = g >> tpb_log2;
  const int sub = static_cast<int>(g & (tpb - 1));
  const bool live = blk < nblk;
  if (!live) blk = nblk - 1;           // still joins the group's shuffles
  const bool is_v = blk % streams == 1;
  const int h = static_cast<int>((blk / streams) % H);
  const int b = static_cast<int>((blk / streams) / H);
  const int p = pos[b];
  const int slot = ((p % W) + W) % W;  // floor mod, as torch's %
  const int e = p - W;                 // the position aging out
  const bool evict = live && e >= cold_len[b] && e < S;
  const int64_t at = (static_cast<int64_t>(b) * S + (evict ? e : 0)) * H + h;
  THot* ring = (is_v ? v_hot : k_hot) +
               ((static_cast<int64_t>(b) * W + slot) * H + h) * D;
  // the slot's old token, read before it is overwritten below
  encode_block<8>(ring, (is_v ? v_codes : k_codes) + at * (D * bits / 8),
                  (is_v ? v_scales : k_scales) + at, D, bits, sub, tpb,
                  evict);
  if (!live) return;
  // each thread rewrites only the chunks it read above
  const TNew* src = (is_v ? v_new : k_new) +
                    (static_cast<int64_t>(b) * H + h) * D;
  for (int c = sub; c < D / 8; c += tpb) {
    float v[8];
    load_vals<8>(src + c * 8, v);
    store_vals<8>(ring + c * 8, v);
  }
}

// The prefill fill of one layer, K and V (or the one stream K when streams
// is 1): CTAs [0, enc_ctas) quantize the
// blocks of t[B, S, H, D] (block blk = ((kind * B + b) * S + s) * H + h,
// groups of (1 << tpb_log2) threads) into codes [B, L, H, D*bits/8] and
// scales [B, L, H] at position s < S <= L; the CTAs after them copy the
// ring, one group a row (kind, b, w, h): hot[b, w, h] = t[b, src, h] in
// bf16 with src = clamp(last - ((last - w) mod W), 0, S - 1), last =
// lens[b] - 1, the latest real token at a position = w (mod W). The
// branch is per CTA, so a group's shuffles never diverge.
template <typename TIn>
__global__ void __launch_bounds__(kThreads)
prefill_fill_kernel(const TIn* __restrict__ k, const TIn* __restrict__ v,
                    uint8_t* __restrict__ k_codes,
                    float* __restrict__ k_scales,
                    __nv_bfloat16* __restrict__ k_hot,
                    uint8_t* __restrict__ v_codes,
                    float* __restrict__ v_scales,
                    __nv_bfloat16* __restrict__ v_hot,
                    const int32_t* __restrict__ lens, int B, int S, int L,
                    int W, int H, int D, int bits, int streams, int tpb_log2,
                    int enc_ctas) {
  const int tpb = 1 << tpb_log2;
  const int sub = static_cast<int>(threadIdx.x & (tpb - 1));
  if (static_cast<int>(blockIdx.x) < enc_ctas) {
    const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    const int64_t per = static_cast<int64_t>(B) * S * H;
    int64_t blk = g >> tpb_log2;
    const bool live = blk < streams * per;
    if (!live) blk = streams * per - 1;   // still joins the group's shuffles
    const bool is_v = blk >= per;
    const int64_t r = is_v ? blk - per : blk;   // (b * S + s) * H + h
    const int64_t bs = r / H;
    const int64_t at = ((bs / S) * L + bs % S) * H + r % H;
    encode_block<8>((is_v ? v : k) + r * D,
                    (is_v ? v_codes : k_codes) + at * (D * bits / 8),
                    (is_v ? v_scales : k_scales) + at, D, bits, sub, tpb,
                    live);
    return;
  }
  const int64_t g = static_cast<int64_t>(blockIdx.x - enc_ctas) * kThreads +
                    threadIdx.x;
  const int64_t per = static_cast<int64_t>(B) * W * H;
  const int64_t row = g >> tpb_log2;
  if (row >= streams * per) return;
  const bool is_v = row >= per;
  const int64_t r = is_v ? row - per : row;     // (b * W + w) * H + h
  const int h = static_cast<int>(r % H);
  const int w = static_cast<int>((r / H) % W);
  const int b = static_cast<int>(r / H / W);
  const int last = lens[b] - 1;
  const int src = min(max(last - (((last - w) % W) + W) % W, 0), S - 1);
  const TIn* x = (is_v ? v : k) +
                 ((static_cast<int64_t>(b) * S + src) * H + h) * D;
  __nv_bfloat16* y = (is_v ? v_hot : k_hot) + r * D;
  for (int c = sub; c < D / 8; c += tpb) {
    float vals[8];
    load_vals<8>(x + c * 8, vals);
    store_vals<8>(y + c * 8, vals);
  }
}

// The device half of a lane demotion, K and V (or the one stream K when
// streams is 1) of every layer, in place:
// block blk = ((l * streams + kind) * W + j) * H + h quantizes the ring slot of
// position p = pos - W + j into codes/scales at p when p >= 0, p >=
// cold_len[l] and p < T (the live ring tokens, [max(cold_len, pos - W),
// pos)); the bf16 ring converts to f32 exactly, so the codes are those of
// the f32 path. Each layer's clamped cold_len, max(cold_len, pos), goes
// to cold_out. Leading (layer) strides in elements; a layer's codes
// [T, H, D*bits/8], scales [T, H] and ring [W, H, D] are contiguous.
__global__ void __launch_bounds__(kThreads)
lane_flush_kernel(uint8_t* __restrict__ k_codes, float* __restrict__ k_scales,
                  const __nv_bfloat16* __restrict__ k_hot,
                  uint8_t* __restrict__ v_codes, float* __restrict__ v_scales,
                  const __nv_bfloat16* __restrict__ v_hot,
                  const int32_t* __restrict__ cold_len,
                  int32_t* __restrict__ cold_out, int64_t codes_ls,
                  int64_t scales_ls, int64_t hot_ls, int64_t cold_ls,
                  int Lyr, int T, int W, int H, int D, int bits, int pos,
                  int streams, int tpb_log2) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int tpb = 1 << tpb_log2;
  const int64_t nblk = static_cast<int64_t>(Lyr) * streams * W * H;
  int64_t blk = g >> tpb_log2;
  const int sub = static_cast<int>(g & (tpb - 1));
  const bool live = blk < nblk;
  if (!live) blk = nblk - 1;           // still joins the group's shuffles
  const int h = static_cast<int>(blk % H);
  const int j = static_cast<int>((blk / H) % W);
  const bool is_v = (blk / H / W) % streams == 1;
  const int l = static_cast<int>(blk / H / W / streams);
  const int cl = cold_len[l * cold_ls];
  const int p = pos - W + j;
  const bool flush = live && p >= 0 && p >= cl && p < T;
  const int slot = flush ? p % W : 0;
  const __nv_bfloat16* ring = (is_v ? v_hot : k_hot) + l * hot_ls +
                              (static_cast<int64_t>(slot) * H + h) * D;
  const int64_t at = static_cast<int64_t>(flush ? p : 0) * H + h;
  encode_block<8>(ring, (is_v ? v_codes : k_codes) + l * codes_ls +
                            at * (D * bits / 8),
                  (is_v ? v_scales : k_scales) + l * scales_ls + at, D, bits,
                  sub, tpb, flush);
  if (live && j == 0 && h == 0 && !is_v && sub == 0) cold_out[l] = max(cl, pos);
}

int tpb_log2_for(int nchunks) {
  int t = 0;                            // largest power of two <= 32
  while (t < 5 && (2 << t) <= nchunks) ++t;   // and <= nchunks: a group
  return t;                             // may hold threads with one chunk
}                                       // more than others

}  // namespace

// x [n, block] (bf16, or f32 when x_f32) -> codes [n, block*bits/8],
// scales [n]. vec: block % 8 == 0 and every pointer 16-byte aligned.
extern "C" int qpack_fixed_encode(const void* x, int x_f32, void* codes,
                                  void* scales, int n, int block, int bits,
                                  int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vpc = vec ? 8 : 2;
  const int tl = tpb_log2_for(block / vpc);
  const int64_t threads = static_cast<int64_t>(n) << tl;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  uint8_t* c = static_cast<uint8_t*>(codes);
  float* sc = static_cast<float*>(scales);
  if (x_f32) {
    const float* xp = static_cast<const float*>(x);
    if (vec) encode_kernel<8, float><<<grid, kThreads, 0, s>>>(xp, c, sc, n, block, bits, tl);
    else encode_kernel<2, float><<<grid, kThreads, 0, s>>>(xp, c, sc, n, block, bits, tl);
  } else {
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    if (vec) encode_kernel<8, __nv_bfloat16><<<grid, kThreads, 0, s>>>(xp, c, sc, n, block, bits, tl);
    else encode_kernel<2, __nv_bfloat16><<<grid, kThreads, 0, s>>>(xp, c, sc, n, block, bits, tl);
  }
  return static_cast<int>(cudaGetLastError());
}

// codes [n, block*bits/8], scales [n] -> out [n, block] (bf16, or f32 when
// out_f32).
extern "C" int qpack_fixed_decode(const void* codes, const void* scales,
                                  void* out, int out_f32, int n, int block,
                                  int bits, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vpc = vec ? 8 : 2;
  const int64_t chunks = static_cast<int64_t>(n) * (block / vpc);
  const dim3 grid(static_cast<unsigned>((chunks + kThreads - 1) / kThreads));
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* sc = static_cast<const float*>(scales);
  if (out_f32) {
    float* o = static_cast<float*>(out);
    if (vec) decode_kernel<8, float><<<grid, kThreads, 0, s>>>(c, sc, o, chunks, block, bits);
    else decode_kernel<2, float><<<grid, kThreads, 0, s>>>(c, sc, o, chunks, block, bits);
  } else {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    if (vec) decode_kernel<8, __nv_bfloat16><<<grid, kThreads, 0, s>>>(c, sc, o, chunks, block, bits);
    else decode_kernel<2, __nv_bfloat16><<<grid, kThreads, 0, s>>>(c, sc, o, chunks, block, bits);
  }
  return static_cast<int>(cudaGetLastError());
}

// The ring step of one layer, in place: codes [B, S, H, D*bits/8] u8,
// scales [B, S, H] f32, hot [B, W, H, D] (bf16, or f32 when hot_f32), new
// [B, H, D] (bf16, or f32 when new_f32), pos and cold_len [B] int32. D a
// multiple of 8, every pointer 16-byte aligned. streams 2: K and V; 1: the
// K pointers only (MLA's latent stream), the V pointers unused.
extern "C" int qpack_ring_step(void* k_codes, void* k_scales, void* k_hot,
                               void* v_codes, void* v_scales, void* v_hot,
                               const void* k_new, const void* v_new,
                               const void* pos, const void* cold_len,
                               int hot_f32, int new_f32, int b, int s_len,
                               int w, int h, int d, int bits, int streams,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || w < 1 || h < 1 || d % 8 != 0 || d < 8 ||
      (bits != 4 && bits != 8) || (streams != 1 && streams != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tl = tpb_log2_for(d / 8);
  const int64_t threads = static_cast<int64_t>(streams) * b * h << tl;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  uint8_t* kc = static_cast<uint8_t*>(k_codes);
  uint8_t* vc = static_cast<uint8_t*>(v_codes);
  float* ks = static_cast<float*>(k_scales);
  float* vs = static_cast<float*>(v_scales);
  const int32_t* p = static_cast<const int32_t*>(pos);
  const int32_t* cl = static_cast<const int32_t*>(cold_len);
#define RING(THOT, TNEW)                                                    \
  ring_step_kernel<THOT, TNEW><<<grid, kThreads, 0, s>>>(                  \
      kc, ks, static_cast<THOT*>(k_hot), vc, vs, static_cast<THOT*>(v_hot), \
      static_cast<const TNEW*>(k_new), static_cast<const TNEW*>(v_new), p,  \
      cl, b, s_len, w, h, d, bits, streams, tl)
  if (hot_f32 && new_f32) RING(float, float);
  else if (hot_f32) RING(float, __nv_bfloat16);
  else if (new_f32) RING(__nv_bfloat16, float);
  else RING(__nv_bfloat16, __nv_bfloat16);
#undef RING
  return static_cast<int>(cudaGetLastError());
}

// The prefill fill of one layer (see prefill_fill_kernel): k, v [B, S, H,
// D] (bf16, or f32 when x_f32), codes [B, L, H, D*bits/8] u8, scales [B,
// L, H] f32, hot [B, W, H, D] bf16, lens [B] int32; S <= L, D a multiple of
// 8, k/v/hot 16-byte aligned, codes aligned to their 4- or 8-byte stores.
// streams 2: K and V; 1: the K pointers only (MLA's latent stream).
extern "C" int qpack_prefill_fill(const void* k, const void* v, int x_f32,
                                  void* k_codes, void* k_scales, void* k_hot,
                                  void* v_codes, void* v_scales, void* v_hot,
                                  const void* lens, int b, int s_len,
                                  int l_len, int w, int h, int d, int bits,
                                  int streams, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || s_len < 1 || s_len > l_len || w < 1 || h < 1 || d % 8 != 0 ||
      d < 8 || (bits != 4 && bits != 8) || (streams != 1 && streams != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tl = tpb_log2_for(d / 8);
  const int64_t enc = (static_cast<int64_t>(streams) * b * s_len * h) << tl;
  const int64_t hot = (static_cast<int64_t>(streams) * b * w * h) << tl;
  const int enc_ctas = static_cast<int>((enc + kThreads - 1) / kThreads);
  const dim3 grid(static_cast<unsigned>(enc_ctas + (hot + kThreads - 1) / kThreads));
#define FILL(TIN)                                                            \
  prefill_fill_kernel<TIN><<<grid, kThreads, 0, s>>>(                       \
      static_cast<const TIN*>(k), static_cast<const TIN*>(v),               \
      static_cast<uint8_t*>(k_codes), static_cast<float*>(k_scales),        \
      static_cast<__nv_bfloat16*>(k_hot), static_cast<uint8_t*>(v_codes),   \
      static_cast<float*>(v_scales), static_cast<__nv_bfloat16*>(v_hot),    \
      static_cast<const int32_t*>(lens), b, s_len, l_len, w, h, d, bits,    \
      streams, tl, enc_ctas)
  if (x_f32) FILL(float);
  else FILL(__nv_bfloat16);
#undef FILL
  return static_cast<int>(cudaGetLastError());
}

// The lane flush (see lane_flush_kernel): codes [Lyr, T, H, D*bits/8] u8,
// scales [Lyr, T, H] f32, hot [Lyr, W, H, D] bf16, cold_len [Lyr] int32,
// each with its own layer stride (elements); cold_out int32[Lyr]. streams
// 2: K and V; 1: the K pointers only (MLA's latent stream).
extern "C" int qpack_lane_flush(void* k_codes, void* k_scales,
                                const void* k_hot, void* v_codes,
                                void* v_scales, const void* v_hot,
                                const void* cold_len, void* cold_out,
                                long long codes_ls, long long scales_ls,
                                long long hot_ls, long long cold_ls, int lyr,
                                int t_len, int w, int h, int d, int bits,
                                int pos, int streams, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lyr < 1 || t_len < 1 || w < 1 || h < 1 || d % 8 != 0 || d < 8 ||
      (bits != 4 && bits != 8) || (streams != 1 && streams != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tl = tpb_log2_for(d / 8);
  const int64_t threads = (static_cast<int64_t>(lyr) * streams * w * h) << tl;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
  lane_flush_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<uint8_t*>(k_codes), static_cast<float*>(k_scales),
      static_cast<const __nv_bfloat16*>(k_hot), static_cast<uint8_t*>(v_codes),
      static_cast<float*>(v_scales), static_cast<const __nv_bfloat16*>(v_hot),
      static_cast<const int32_t*>(cold_len), static_cast<int32_t*>(cold_out),
      codes_ls, scales_ls, hot_ls, cold_ls, lyr, t_len, w, h, d, bits, pos,
      streams, tl);
  return static_cast<int>(cudaGetLastError());
}
