// Fused demote / promote kernels of the IBEX compression engine, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels kernels/qpack.py::qpack_fused_encode_2d
// (_fused_encode_kernel) and ::qpack_fused_decode_2d (_fused_decode_kernel)
// of the JAX package; the bytes they produce are identical.
//
// Encode (demotion), per block of V values (bf16 or f32 input):
//   amax; 4- and 8-bit quantization with scale = amax * f32(1/qmax),
//   recip = 1/scale (IEEE division), round-half-even, clip; rate pick
//   (lossless: the bf16 dequantization equals x; else max |err| / amax <=
//   tol, compared in f32); zero rate for amax == 0, clamped to 4-bit when
//   zero elision is off; then ONLY the chosen dense layout is written:
//     4-bit: f32 scale (LE) | nibbles, low nibble first | zero pad to 2V
//     8-bit: f32 scale (LE) | int8 codes               | zero pad to 2V
//     raw  : little-endian bf16 bytes
//     zero : 2V zero bytes
// Decode (promotion): f32 scale from bytes 0..3, sign-extended nibbles or
//   int8 codes times the scale rounded to bf16, raw bf16, or zeros.
//
// Demote-and-compact (qpack_fused_demote): the pool's whole demotion step
// in one launch, the same kernel with the compaction epilogue on. One CTA
// per page, one warp per block; the page is read straight from the store
// row slots[k]; each warp writes its dense row to shared memory, the warps
// exchange their quanta there across one barrier, and each copies its live
// bytes [start_i, start_i + quanta_i*128) to the page stream with 16-byte
// stores (start_i = 128 * sum(quanta[:i]), the dense row placed at start_i
// clamped to page_bytes - 2V, as compressor.py::_compact_pages places it);
// the CTA zeroes the tail and writes the page's chunk count. It replaces
// the eager chain around the TPU kernel's contract (a gather of the
// victims, the encode, about 26 launches of compaction, the chunk
// arithmetic and a concatenation of what the host fetches).
//
// Promotion step (qpack_fused_promote): the pool's whole promotion in one
// launch, with the decode's own body (decode_piece). One CTA per page of
// 128 threads: the page's compacted stream is read from the C-chunk store
// through the page's chunk ids (16-byte loads into shared memory), block i
// is located at 128 * sum(quanta[:i]) clamped to page_bytes - 2V, decoded
// in registers 8 values a thread at a time, and written with 16-byte
// stores straight into the page's P-chunk row, only in the block_bytes
// ranges its mask selects (fine-grained promotion writes one block; an
// update-promotion keeps the hot ones). The host uploads one int32 record
// a page (chunk ids, rates, slot, mask). It replaces an eager chain of
// about 15 device events per promotion around the TPU kernel's contract
// (three uploads, the chunk gather, the dense slicing's index arithmetic
// and gather, the decode, and one to four copies into the store). A page
// moves at most 4 KB in and 4 KB out, some 2.5 ns at 3.35 TB/s, so the
// step is bound by the latency of its one launch.
//
// Bound: both are one pass over memory with no reuse. Encode reads 2V bytes
// (bf16) and writes 2V + 8 bytes per block; decode reads 2V + 4 and writes
// 2V. At 3.35 TB/s a 512-value block costs ~0.6 ns each way; a demotion
// batch of 8 pages moves about 64 KB, some 20 ns, so a call is bound by the
// latency of one launch (about 2 us) and the design spends exactly one.
// Each block has one warp: 16-byte loads, the row's values stay in
// registers between the reduction, the rate test and the store, and each
// output byte is written once (the TPU kernel built all three candidate
// rows and selected with a where chain). No atomics; any N >= 1 (no tile
// padding). Built without fast math and with --fmad=false, so every product
// and quotient rounds exactly as the reference does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;              // blocks (rows) per CTA of the encode
constexpr int kMaxPageWarps = 8;       // blocks per page of the demotion
constexpr int kPromoteThreads = 128;   // threads of a promotion CTA
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    out[2 * t] = __uint_as_float((w[t] & 0xffffu) << 16);
    out[2 * t + 1] = __uint_as_float(w[t] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

__device__ __forceinline__ float quant(float x, float recip, float qmax) {
  return fminf(fmaxf(rintf(__fmul_rn(x, recip)), -qmax - 1.0f), qmax);
}

__device__ __forceinline__ float deq_bf16(float q, float scale) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(q, scale)));
}

// kCompact false: rows x[row] -> dense rows out[row] (the TPU kernel's
// contract), kWarps rows per CTA. kCompact true: CTA k encodes the page
// x[slots[k]] (x[k] when slots is null), one warp per block, and writes the
// compacted page stream out[k] and nchunks[k].
template <int CH, typename TIn, bool kCompact>
__global__ void __launch_bounds__(kMaxPageWarps * 32)
fused_encode_kernel(const TIn* __restrict__ x,
                    const int64_t* __restrict__ slots,
                    uint8_t* __restrict__ out, int32_t* __restrict__ rates,
                    int32_t* __restrict__ quanta,
                    int32_t* __restrict__ nchunks, int n, int qpc,
                    float tol4, float tol8, int lossless, int zero_elision,
                    int q0, int q1, int q2, int q3) {
  constexpr int V = CH * 256;          // values per block
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int row = blockIdx.x * warps + warp;
  if (!kCompact && row >= n) return;   // whole warp leaves together

  // lane owns values [8*(lane + 32*j), +8) for j < CH
  float v[CH * 8];
  size_t src = row;
  if (kCompact)
    src = static_cast<size_t>(slots ? slots[blockIdx.x] : blockIdx.x) *
          warps + warp;
  const TIn* xr = x + src * V;
#pragma unroll
  for (int j = 0; j < CH; ++j) load8(xr + (lane + 32 * j) * 8, v + 8 * j);

  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < CH * 8; ++k) amax = fmaxf(amax, fabsf(v[k]));
  amax = warp_max(amax);

  const float s4 = amax > 0.0f ? __fmul_rn(amax, static_cast<float>(1.0 / 7.0)) : 1.0f;
  const float s8 = amax > 0.0f ? __fmul_rn(amax, static_cast<float>(1.0 / 127.0)) : 1.0f;
  const float r4 = __fdiv_rn(1.0f, s4);
  const float r8 = __fdiv_rn(1.0f, s8);

  bool ok4 = true, ok8 = true;
  float e4 = 0.0f, e8 = 0.0f;
#pragma unroll
  for (int k = 0; k < CH * 8; ++k) {
    const float d4 = deq_bf16(quant(v[k], r4, 7.0f), s4);
    const float d8 = deq_bf16(quant(v[k], r8, 127.0f), s8);
    if (lossless) {
      // float compare of bf16 values: -0.0 == +0.0
      const float xb = __bfloat162float(__float2bfloat16_rn(v[k]));
      ok4 = ok4 && (d4 == xb);
      ok8 = ok8 && (d8 == xb);
    } else {
      e4 = fmaxf(e4, fabsf(d4 - v[k]));
      e8 = fmaxf(e8, fabsf(d8 - v[k]));
    }
  }
  if (lossless) {
    ok4 = __all_sync(kFull, ok4);
    ok8 = __all_sync(kFull, ok8);
  } else {
    e4 = warp_max(e4);
    e8 = warp_max(e8);
    const float safe = amax > 0.0f ? amax : 1.0f;
    ok4 = __fdiv_rn(e4, safe) <= tol4;
    ok8 = __fdiv_rn(e8, safe) <= tol8;
  }
  int rate = ok8 ? 2 : 3;
  if (ok4) rate = 1;
  if (amax == 0.0f) rate = 0;
  if (!zero_elision && rate < 1) rate = 1;

  // the dense row: straight to memory, or to shared memory for compaction
  extern __shared__ __align__(16) uint8_t page_smem[];
  __shared__ int block_quanta[kMaxPageWarps];
  uint8_t* dr = kCompact ? page_smem + warp * (2 * V)
                         : out + static_cast<size_t>(row) * (2 * V);
  uint32_t* dw = reinterpret_cast<uint32_t*>(dr);
  if (rate == 0) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int w = lane; w < (2 * V) / 16; w += 32) reinterpret_cast<uint4*>(dr)[w] = z;
  } else if (rate == 3) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const float* p = v + 8 * j;
      uint4 o;
      o.x = bf16_bits(p[0]) | (bf16_bits(p[1]) << 16);
      o.y = bf16_bits(p[2]) | (bf16_bits(p[3]) << 16);
      o.z = bf16_bits(p[4]) | (bf16_bits(p[5]) << 16);
      o.w = bf16_bits(p[6]) | (bf16_bits(p[7]) << 16);
      reinterpret_cast<uint4*>(dr)[lane + 32 * j] = o;
    }
  } else if (rate == 1) {
    if (lane == 0) dw[0] = __float_as_uint(s4);
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      uint32_t word = 0u;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int q = static_cast<int>(quant(v[8 * j + t], r4, 7.0f));
        word |= (static_cast<uint32_t>(q) & 0xfu) << (4 * t);
      }
      dw[1 + lane + 32 * j] = word;
    }
    for (int w = 1 + V / 8 + lane; w < V / 2; w += 32) dw[w] = 0u;
  } else {
    if (lane == 0) dw[0] = __float_as_uint(s8);
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      uint32_t lo = 0u, hi = 0u;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int qa = static_cast<int>(quant(v[8 * j + t], r8, 127.0f));
        const int qb = static_cast<int>(quant(v[8 * j + 4 + t], r8, 127.0f));
        lo |= (static_cast<uint32_t>(qa) & 0xffu) << (8 * t);
        hi |= (static_cast<uint32_t>(qb) & 0xffu) << (8 * t);
      }
      const int idx = lane + 32 * j;
      dw[1 + 2 * idx] = lo;
      dw[2 + 2 * idx] = hi;
    }
    for (int w = 1 + V / 4 + lane; w < V / 2; w += 32) dw[w] = 0u;
  }
  const int qn = rate == 0 ? q0 : rate == 1 ? q1 : rate == 2 ? q2 : q3;
  if (lane == 0) {
    rates[row] = rate;
    quanta[row] = qn;
  }
  if constexpr (kCompact) {
    if (lane == 0) block_quanta[warp] = qn;
    __syncthreads();                   // dense rows and quanta are shared
    int start = 0, total = 0;
    for (int i = 0; i < warps; ++i) {
      start += i < warp ? block_quanta[i] : 0;
      total += block_quanta[i];
    }
    start *= 128;
    total *= 128;
    const int page_bytes = warps * (2 * V);
    const int placed = min(start, page_bytes - 2 * V);
    uint8_t* page = out + static_cast<size_t>(blockIdx.x) * page_bytes;
    // start, placed and total are multiples of 16: 16-byte copies
    for (int o = start + 16 * lane; o < start + qn * 128; o += 16 * 32)
      *reinterpret_cast<uint4*>(page + o) =
          *reinterpret_cast<const uint4*>(dr + (o - placed));
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int o = total + 16 * threadIdx.x; o < page_bytes; o += 16 * blockDim.x)
      *reinterpret_cast<uint4*>(page + o) = z;
    if (threadIdx.x == 0) nchunks[blockIdx.x] = (total / 128 + qpc - 1) / qpc;
  }
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return bf16_bits(a) | (bf16_bits(b) << 16);
}

// The 8 values [8*idx, +8) of a dense row dr at `rate`, as 8 bf16 (one
// 16-byte store): raw bytes, sign-extended nibbles or int8 codes times the
// row's f32 scale rounded to bf16, or zeros. The one copy of the decode:
// fused_decode_kernel calls it on rows in device memory, fused_promote_
// kernel on rows of a page stream in shared memory. dr is 16-byte aligned.
__device__ __forceinline__ uint4 decode_piece(const uint8_t* dr, int rate,
                                              float scale, int idx) {
  const uint32_t* dw = reinterpret_cast<const uint32_t*>(dr);
  uint4 o = make_uint4(0u, 0u, 0u, 0u);
  if (rate == 3) {
    o = reinterpret_cast<const uint4*>(dr)[idx];
  } else if (rate == 1 || rate == 2) {
    float f[8];
    if (rate == 1) {
      const uint32_t w = dw[1 + idx];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        int q = static_cast<int>((w >> (4 * t)) & 0xfu);
        q = q >= 8 ? q - 16 : q;
        f[t] = __fmul_rn(static_cast<float>(q), scale);
      }
    } else {
      const uint32_t w[2] = {dw[1 + 2 * idx], dw[2 + 2 * idx]};
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int q = static_cast<int8_t>((w[t / 4] >> (8 * (t % 4))) & 0xffu);
        f[t] = __fmul_rn(static_cast<float>(q), scale);
      }
    }
    o.x = pack2(f[0], f[1]);
    o.y = pack2(f[2], f[3]);
    o.z = pack2(f[4], f[5]);
    o.w = pack2(f[6], f[7]);
  }
  return o;
}

template <int CH>
__global__ void __launch_bounds__(kWarps * 32)
fused_decode_kernel(const uint8_t* __restrict__ dense,
                    const int32_t* __restrict__ rates,
                    __nv_bfloat16* __restrict__ out, int n) {
  constexpr int V = CH * 256;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  const uint8_t* dr = dense + static_cast<size_t>(row) * (2 * V);
  const int rate = rates[row];
  const float scale = __uint_as_float(reinterpret_cast<const uint32_t*>(dr)[0]);
  uint4* orow = reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * V);
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int idx = lane + 32 * j;     // 8 output values [8*idx, +8)
    orow[idx] = decode_piece(dr, rate, scale, idx);
  }
}

// The pool's promotion step: CTA k promotes one page. Its record rec =
// record + k * (cpp + nb + 2) holds the page's cpp chunk ids, its nb block
// rates, the P-chunk slot and the mask of the range_bytes ranges to write.
// The page stream is gathered into shared memory with 16-byte loads
// through the chunk table (a piece never straddles a chunk: chunk_bytes
// and every offset are multiples of 16); then each thread decodes 16-byte
// pieces of the bf16 page (block i's dense row starts at 128 * sum of the
// quanta of blocks < i, clamped to page_bytes - 2v, as
// compressor.py::_page_dense_blocks slices it) and stores the pieces of
// the ranges the mask selects straight into p_store[slot].
__global__ void __launch_bounds__(kPromoteThreads)
fused_promote_kernel(const uint8_t* __restrict__ c_store,
                     uint8_t* __restrict__ p_store,
                     const int32_t* __restrict__ record, int cpp, int nb,
                     int v, int chunk_bytes, int range_bytes, int q0, int q1,
                     int q2, int q3) {
  extern __shared__ __align__(16) uint8_t stream[];
  const int page_bytes = 2 * nb * v;
  const int32_t* rec = record + static_cast<size_t>(blockIdx.x) * (cpp + nb + 2);
  for (int o = 16 * threadIdx.x; o < page_bytes; o += 16 * blockDim.x) {
    const int c = o / chunk_bytes;
    *reinterpret_cast<uint4*>(stream + o) = *reinterpret_cast<const uint4*>(
        c_store + static_cast<size_t>(rec[c]) * chunk_bytes +
        (o - c * chunk_bytes));
  }
  __syncthreads();
  const int32_t* rates = rec + cpp;
  const uint32_t mask = static_cast<uint32_t>(rec[cpp + nb + 1]);
  uint8_t* dst = p_store + static_cast<size_t>(rec[cpp + nb]) * page_bytes;
  for (int p = threadIdx.x; p < page_bytes / 16; p += blockDim.x) {
    if (!((mask >> ((16 * p) / range_bytes)) & 1u)) continue;
    const int i = (8 * p) / v;         // the piece's block
    int start = 0;
    for (int j = 0; j < i; ++j) {
      const int r = rates[j];
      start += r == 0 ? q0 : r == 1 ? q1 : r == 2 ? q2 : q3;
    }
    const uint8_t* dr = stream + min(128 * start, page_bytes - 2 * v);
    const float scale = __uint_as_float(reinterpret_cast<const uint32_t*>(dr)[0]);
    *reinterpret_cast<uint4*>(dst + 16 * p) =
        decode_piece(dr, rates[i], scale, p - i * (v / 8));
  }
}

template <int CH, bool kCompact, typename TIn>
void launch_encode_as(const void* x, const void* slots, void* out,
                      void* rates, void* quanta, void* nchunks, int n,
                      int qpc, int page_warps, float tol4, float tol8,
                      int lossless, int zero_elision, int q0, int q1, int q2,
                      int q3, cudaStream_t s) {
  // compaction: one CTA a page and its page in shared memory
  const int warps = kCompact ? page_warps : kWarps;
  const dim3 grid(kCompact ? n / page_warps : (n + kWarps - 1) / kWarps);
  const size_t smem = kCompact ? static_cast<size_t>(warps) * 2 * CH * 256 : 0;
  fused_encode_kernel<CH, TIn, kCompact><<<grid, warps * 32, smem, s>>>(
      static_cast<const TIn*>(x), static_cast<const int64_t*>(slots),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(rates),
      static_cast<int32_t*>(quanta), static_cast<int32_t*>(nchunks), n, qpc,
      tol4, tol8, lossless, zero_elision, q0, q1, q2, q3);
}

template <int CH, bool kCompact>
void launch_encode(const void* x, int x_f32, const void* slots, void* out,
                   void* rates, void* quanta, void* nchunks, int n, int qpc,
                   int page_warps, float tol4, float tol8, int lossless,
                   int zero_elision, int q0, int q1, int q2, int q3,
                   cudaStream_t s) {
  if (x_f32)
    launch_encode_as<CH, kCompact, float>(
        x, slots, out, rates, quanta, nchunks, n, qpc, page_warps, tol4, tol8,
        lossless, zero_elision, q0, q1, q2, q3, s);
  else
    launch_encode_as<CH, kCompact, __nv_bfloat16>(
        x, slots, out, rates, quanta, nchunks, n, qpc, page_warps, tol4, tol8,
        lossless, zero_elision, q0, q1, q2, q3, s);
}

template <int CH>
void launch_decode(const void* dense, const void* rates, void* out, int n,
                   cudaStream_t s) {
  const dim3 grid((n + kWarps - 1) / kWarps), block(kWarps * 32);
  fused_decode_kernel<CH><<<grid, block, 0, s>>>(
      static_cast<const uint8_t*>(dense), static_cast<const int32_t*>(rates),
      static_cast<__nv_bfloat16*>(out), n);
}

}  // namespace

// C entry points (bound with ctypes). V must be a multiple of 256 in
// [256, 2048]; each returns the cudaError_t of its launch.

extern "C" int qpack_fused_encode(const void* x, int x_f32, void* dense,
                                  void* rates, void* quanta, int n, int v,
                                  float tol4, float tol8, int lossless,
                                  int zero_elision, int q0, int q1, int q2,
                                  int q3, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || v % 256 != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (v / 256) {
#define ENC(C) case C: launch_encode<C, false>(x, x_f32, nullptr, dense, rates, quanta, nullptr, n, 0, 0, tol4, tol8, lossless, zero_elision, q0, q1, q2, q3, s); break;
    ENC(1) ENC(2) ENC(3) ENC(4) ENC(5) ENC(6) ENC(7) ENC(8)
#undef ENC
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Demote-and-compact: k pages of nb blocks of v values, page i read from
// row slots[i] of x (row i when slots is null) -> bufs [k, nb*2v] (page
// streams), rates and quanta [k*nb], nchunks [k] = ceil(sum quanta / qpc).
extern "C" int qpack_fused_demote(const void* x, int x_f32,
                                  const void* slots, void* bufs, void* rates,
                                  void* quanta, void* nchunks, int k, int nb,
                                  int v, int qpc, float tol4, float tol8,
                                  int lossless, int zero_elision, int q0,
                                  int q1, int q2, int q3, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || nb < 1 || nb > kMaxPageWarps || qpc < 1 || v % 256 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (v / 256) {
#define DEM(C) case C: launch_encode<C, true>(x, x_f32, slots, bufs, rates, quanta, nchunks, k * nb, qpc, nb, tol4, tol8, lossless, zero_elision, q0, q1, q2, q3, s); break;
    DEM(1) DEM(2) DEM(3) DEM(4) DEM(5) DEM(6) DEM(7) DEM(8)
#undef DEM
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qpack_fused_decode(const void* dense, const void* rates,
                                  void* out, int n, int v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || v % 256 != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (v / 256) {
#define DEC(C) case C: launch_decode<C>(dense, rates, out, n, s); break;
    DEC(1) DEC(2) DEC(3) DEC(4) DEC(5) DEC(6) DEC(7) DEC(8)
#undef DEC
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Promotion: k pages, each of nb blocks of v values (cpp chunks of
// chunk_bytes), from c_store [*, chunk_bytes] into p_store [*,
// 2*nb*v] through record int32[k, cpp + nb + 2] (chunk ids, rates, slot,
// range mask over 2*nb*v / range_bytes <= 31 ranges). Slots must differ.
extern "C" int qpack_fused_promote(const void* c_store, void* p_store,
                                   const void* record, int k, int cpp,
                                   int nb, int v, int chunk_bytes,
                                   int range_bytes, int q0, int q1, int q2,
                                   int q3, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int page_bytes = 2 * nb * v;
  if (k < 1 || nb < 1 || nb > kMaxPageWarps || v % 256 != 0 || v < 256 ||
      v > 2048 || chunk_bytes < 16 || chunk_bytes % 16 != 0 ||
      cpp * chunk_bytes != page_bytes || range_bytes < 16 ||
      range_bytes % 16 != 0 || page_bytes % range_bytes != 0 ||
      page_bytes / range_bytes > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  fused_promote_kernel<<<k, kPromoteThreads, page_bytes, s>>>(
      static_cast<const uint8_t*>(c_store), static_cast<uint8_t*>(p_store),
      static_cast<const int32_t*>(record), cpp, nb, v, chunk_bytes,
      range_bytes, q0, q1, q2, q3);
  return static_cast<int>(cudaGetLastError());
}
