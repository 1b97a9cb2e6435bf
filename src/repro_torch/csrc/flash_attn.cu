// Causal or full GQA attention forward (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/flash_attn.py::flash_attention
// (_flash_kernel) of the JAX package, whose serving path computes the same
// attention with layers.chunked_attention (models/decode.py::prefill).
//
//   q [B, Sq, Hq, D], k [B, Sk, Hkv, D], v [B, Sk, Hkv, DV] (all bf16, or
//   all f32) -> o [B, Sq, Hq, DV] in q's type; query head h reads KV head
//   h / (Hq/Hkv). (D, DV) is (64, 64), (80, 80), (128, 128) or (96, 64):
//   (80, 80) is zamba2-2.7b's shared attention (32/32 heads of 80), (96,
//   64) MLA's expanded prefill (minicpm3-4b: 40 heads, q/k nope 64 + rope
//   32, v 64), run by the same two kernels with the qk and v widths apart.
//   Causal: query row i sees key columns c <= i + (Sk - Sq), the mask of
//   chunked_attention and mha_ref (the TPU kernel's c <= i is the case
//   Sq == Sk); masked scores are -1e30 as in the reference.
//
// Bound: at the serving shape (B 8, S 1024, Hq 32, D 128, causal) the work
// is about 4*B*Hq*S*S*D/2 = 69 GFLOP a layer against 50 MB of q, k, v and
// o: operations, by far, and only the tensor cores (989 TFLOP/s bf16, 15x
// the 67 TFLOP/s of f32 on the CUDA cores) come near the bound. Two routes,
// chosen by the input type alone (flash_attn_fwd), neither falling back to
// the other:
//
// bf16 -> tc::flash_tc_kernel, on the tensor cores, persistent: one CTA an
//   SM walks work tiles (batch row, query head, 128 query rows), causal
//   ones heaviest first. A CTA has three warpgroups:
//   - a producer (one thread issues; setmaxnreg cuts the warpgroup to 24
//     registers) loads each work tile's Q once and K/V tiles of BK keys
//     into a ring of NS stages with TMA, each stage guarded by a full and
//     an empty mbarrier, and runs ahead into the next work tile while the
//     consumers finish this one (Q has its own full/empty pair). The
//     tensor maps are rank 4 over [B, S, H, D] with a 128-byte swizzle, so
//     a box is 64 bf16 wide and a D = 128 tile is two boxes side by side;
//     TMA fills rows past S with zeros.
//   - two consumers of 64 query rows each (setmaxnreg raises them to 240):
//     S = Q K^T with wgmma m64nBKk16, both operands K-major in shared
//     memory; the f32 scores are scaled after the product (sm_scale *
//     log2 e, exp2 on the special-function unit) and masked only on tiles
//     that cross the diagonal or the ragged end Sk; an online softmax per
//     row in registers; P rounded to bf16 and fed back as wgmma's A operand
//     from registers in the score accumulator's own fragment layout;
//     O += P V with V the transposed (MN-major) B operand; O rescaled by
//     alpha per tile, divided by max(l, 1e-30) at the end, stored as bf16.
//     Inside a consumer the next tile's Q K^T and this tile's P V are in
//     flight while the softmax runs; across the two, named barriers take
//     turns at issuing wgmmas (ping-pong), so that one's softmax overlaps
//     the other's products.
//   A consumer skips the key tiles past its rows' causal limit. Shared
//   memory: Q (128 x D) plus NS K and NS V stages of BK x D, 176 KB at
//   D = 128, BK = 96, NS = 3 (tc::Tile). At D = 96 a Q or K row is two
//   64-wide boxes, the second half past the tensor's 96 columns, which TMA
//   fills with zeros: the smem rows are 128 wide (a third of the Q and K
//   stages idle), but the Q K^T issues only the 6 k16 steps of the 96
//   real columns and global memory moves only those, so neither product
//   does padded work; V (64 wide) is one box. 176 KB at (96, 64), BK 128.
//   At (80, 80) a 160-byte row of Q, K or V is two boxes, the second
//   holding 16 real columns (TMA fills the rest with zeros): Q K^T issues
//   the 5 k16 steps of the 80 real columns, P V is one m64n80k16 product a
//   k-step (N 80 reads the second box's first 16 columns), so again no
//   product does padded work; each of Q, K and V stores 128-wide rows, 225
//   KB of shared memory at BK 128 and 3 stages, and the accumulator
//   holds the 80 columns exactly (no store past them).
//   (96, 64) takes this tensor-core tile rather than the CUDA cores
//   because MLA's prefill is operation-bound like GQA's (40 heads, 54
//   GFLOP a layer at 8 x 1,024) and the tile needed only the two widths
//   apart: its registers are the D = 64 tile's. Rounding P to bf16 before the second product
//   is the one rounding the plain version does not have (a few 1e-3 on
//   unit-scale outputs).
//   What it still lacks: a 128-key tile (its registers do not fit, see
//   kThreads), and O is stored from registers rather than through shared
//   memory and a TMA store; it runs at about 1.3x the time of PyTorch's
//   SDPA at the serving shape (PERF.md).
//
// f32 -> cc::flash_fwd_kernel, on the CUDA cores (the checks' route: the
//   serving path is bf16). A CTA of four warps owns 32 query rows of one
//   head (8 rows a warp), walks key tiles of 32 up to the causal limit of
//   its last row, stages each K/V tile in shared memory as f32 and keeps an
//   online softmax per row in registers (q pre-scaled by sm_scale, as
//   chunked_attention does).
//
// Any Sq, Sk >= 1 (ragged tiles are masked; causal needs Sq <= Sk, so
// every row sees a key).
//
// The TMA descriptors are encoded on the host per call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (by
// version from CUDA 12.5) so that the library links against the runtime
// only (no -lcuda), and passed by value as __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel.
// ---------------------------------------------------------------------------

namespace cc {

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

template <int D, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * D + kBK * (D + 4) + kBK * DV);
}

template <int D, int DV>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
                 int Hq, int Hkv, float sm_scale, int causal) {
  constexpr int KS = D + 4;
  // V's columns a lane takes: lane + 32 dl; at DV 80 the third reaches
  // only lanes 0-15
  constexpr int DL = (DV + 31) / 32;
  auto col_in = [](int lane_, int dl) {
    return DV % 32 == 0 || lane_ + 32 * dl < DV;
  };
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // [kBQ][D], pre-scaled
  float* k_s = q_s + kBQ * D;           // [kBK][KS]
  float* v_s = k_s + kBK * KS;          // [kBK][DV]

  const int i0 = blockIdx.x * kBQ, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < kBQ * D; i += kWarps * 32) {
    const int r = i / D, d = i % D, row = i0 + r;
    q_s[i] = row < Sq
        ? q[((static_cast<int64_t>(b) * Sq + row) * Hq + hq) * D + d] * sm_scale
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
      k_s[r * KS + d] =
          c < Sk ? k[((static_cast<int64_t>(b) * Sk + c) * Hkv + hk) * D + d] : 0.0f;
    }
    for (int i = tid; i < kBK * DV; i += kWarps * 32) {
      const int r = i / DV, d = i % DV, c = j0 + r;
      v_s[r * DV + d] =
          c < Sk ? v[((static_cast<int64_t>(b) * Sk + c) * Hkv + hk) * DV + d] : 0.0f;
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
      for (int dl = 0; dl < DL; ++dl)
        vj[dl] = col_in(lane, dl) ? v_s[j * DV + lane + 32 * dl] : 0.0f;
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
    float* out = o + ((static_cast<int64_t>(b) * Sq + row) * Hq + hq) * DV + lane;
#pragma unroll
    for (int dl = 0; dl < DL; ++dl)
      if (col_in(lane, dl)) out[32 * dl] = acc[rr][dl] / den;
  }
}

template <int D, int DV>
int launch_cc(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int Hq, int Hkv, float sm_scale, int causal,
           cudaStream_t s) {
  constexpr size_t smem = smem_bytes<D, DV>();
  static bool attr_set = false;         // above 48 KB needs the opt-in
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<D, DV><<<grid, kWarps * 32, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, Hq, Hkv,
      sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cc

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel.
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kBQ = 128;               // query rows per CTA
constexpr int kWGRows = 64;            // query rows per consumer warpgroup
constexpr int kConsumers = 2;
// Two consumer warpgroups and one producer warpgroup, which gives its
// registers to them with setmaxnreg (24 against 240). ptxas still sizes the
// whole kernel for 168 a thread: a 96-key tile fits (about 160); a 128-key
// tile, with the next Q K^T and this P V in flight together, needs about
// 190, spills and has its wgmmas serialized.
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBox = 64;               // bf16 values in one 128-byte swizzled row

// Keys per tile (BK) and ring stages (NS) for each head dim: at D = 128 the
// widest tile whose registers fit, at D = 64 a 128-key tile. The D = 128
// tile takes -DFLASH_TC_BK / -DFLASH_TC_STAGES, for tools/sweep_attn.py's
// sweep only; kernels/flash_attn.py::TC_KEYS holds the same key counts.
#ifndef FLASH_TC_BK
#define FLASH_TC_BK 96
#endif
#ifndef FLASH_TC_STAGES
#define FLASH_TC_STAGES 3
#endif
template <int D, int DV = D>
struct Tile;
template <>
struct Tile<128> {
  static constexpr int kBK = FLASH_TC_BK, kNS = FLASH_TC_STAGES;
};
template <>
struct Tile<64> {
  static constexpr int kBK = 128, kNS = 3;
};
// MLA's (96, 64): the registers of the D = 64 tile (sc 64, acc 32)
template <>
struct Tile<96, 64> {
  static constexpr int kBK = 128, kNS = 3;
};
// zamba2's (80, 80): sc 64, acc 40, P 32, the D = 128 tile's 136; Q, K and
// V rows boxed to 128 values, 225 KB of shared memory at 3 stages
template <>
struct Tile<80, 80> {
  static constexpr int kBK = 128, kNS = 3;
};
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Byte offsets from the 1024-aligned base of dynamic shared memory (the
// 128-byte swizzle repeats every 8 rows of 128 bytes). A tile of R rows
// stores its ceil(D/64) boxes one after the other, R x 128 bytes each: Q
// and K rows are QW = 64 * ceil(D/64) values wide, V rows VW = 64 *
// ceil(DV/64).
template <int D>
constexpr int boxed() { return (D + 63) / 64 * 64; }

template <int D, int DV, int BK, int NS>
struct Smem {
  static constexpr int QW = boxed<D>(), VW = boxed<DV>();
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * QW * 2;
  static constexpr int kV = kK + NS * BK * QW * 2;
  static constexpr int kBar = kV + NS * BK * VW * 2;   // q_full, q_empty, full[NS], empty[NS]
  static constexpr int kBytes = kBar + 8 * (2 + 2 * NS);
  static constexpr int kAlloc = kBytes + 1024;         // room to align the base
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of the given parity to complete. A wait that never
// ends is a fault of the kernel: after about 2^34 cycles (seconds) it
// traps, so that a deadlock surfaces as a launch error, not a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 34)) __trap();
}

// One box of a rank-4 tensor map ({d, head, row, batch}, innermost first)
// into shared memory; completion is counted on the barrier in bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int h, int row,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(row),
      "r"(b)
      : "memory");
}

// S (64 x BK) = Q K^T for one key tile, issued and committed, not waited:
// 16 columns of D a step, box kk / 4, 32 bytes into its 128-byte rows.
template <int D, int BK>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t q_tile,
                                         uint32_t k_tile) {
  fence_regs(sc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mma_ss<BK>(sc, desc_b128(q_tile + (kk / 4) * kBQ * 128 + (kk % 4) * 32, 16, 1024),
               desc_b128(k_tile + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024),
               kk > 0);
  wg_commit();
}

// O (64 x D) += P V for one key tile, issued and committed, not waited
// (D here is V's width, N of the product: 64, 80 or 128): 16 keys a step,
// V's rows 16 kk.., its boxes LBO = BK * 128 bytes apart (at D 80 the
// product reads the second box's first 16 columns; the rest of that box
// is TMA's zero fill, never read).
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_tile) {
  fence_regs(acc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    mma_rs<D>(acc, pa[kk], desc_b128(v_tile + kk * 16 * 128, BK * 128, 1024), 1);
  wg_commit();
}

// 2^x on the special-function unit (what exp2f becomes under fast math;
// about 2 ulp, far inside the bf16 route's tolerance).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Ping-pong of the two consumer warpgroups (named barriers 1 and 2; 0 is
// __syncthreads): a warpgroup issues its wgmmas only in its turn, so that
// one's softmax runs while the other's products occupy the tensor cores.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(2 * 128) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(2 * 128) : "memory");
}

// What the softmax needs to know of a thread's two rows.
struct Rows {
  int row0, lane, Sk, off, causal;
  float scale;   // sm_scale * log2 e
};

// The online softmax of one tile, in place: sc becomes p = exp2(s * scale
// - m) in f32; m (scaled) and l (this thread's columns) are updated and
// alpha = exp2(m_old - m_new) is returned per row. Masks (-1e30) only where
// `edge`: key columns >= Sk, and past the causal limit row + off.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const Rows& r, int j0, bool edge) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float x = sc[i] * r.scale;
    if (edge) {
      const int col = j0 + (i / 4) * 8 + (r.lane % 4) * 2 + (i % 2);
      const int row = r.row0 + 8 * ((i / 2) % 2);
      if (col >= r.Sk || (r.causal && col > row + r.off)) x = kNegInf;
    }
    sc[i] = x;
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = ex2(m[h] - mx[h]);
    m[h] = mx[h];
  }
  float rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    sc[i] = ex2(sc[i] - m[(i / 2) % 2]);
    rs[(i / 2) % 2] += sc[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
}

// The work tiles (batch row, query head, 128 query rows) in the order the
// persistent CTAs take them: causal ones heaviest first, the heads of one
// batch row and query tile next to each other (they share K/V in L2).
struct Work {
  int n_qt, Hq, B, causal;
  __device__ __forceinline__ int count() const { return n_qt * Hq * B; }
  __device__ __forceinline__ void decode(int w, int& qt, int& hq, int& b) const {
    const int r = w / (Hq * B), rem = w % (Hq * B);
    qt = causal ? n_qt - 1 - r : r;
    hq = rem % Hq;
    b = rem / Hq;
  }
};

template <int D, int DV, int BK, int NS>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, int B, int Sq, int Sk, int Hq,
                int Hkv, float scale_log2, int causal) {
  using L = Smem<D, DV, BK, NS>;
  constexpr int QW = L::QW, VW = L::VW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBar, q_empty = q_full + 8;
  const uint32_t full0 = q_empty + 8, empty0 = full0 + 8 * NS;

  const Work work{(Sq + kBQ - 1) / kBQ, Hq, B, causal};
  const int group = Hq / Hkv, off = Sk - Sq;
  // key tiles of a work tile: up to the causal limit of its last row
  auto tiles_of = [&](int q0) {
    return ((causal ? min(Sk, q0 + kBQ + off) : Sk) + BK - 1) / BK;
  };
  // warpgroups 0 and 1 consume, warpgroup 2 produces; the index is made
  // warp-uniform (a shuffle from lane 0) so that ptxas sees each role as one
  // region
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 128 * kConsumers);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread issues every TMA load, running ahead into
    // the next work tile while the consumers finish this one ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (t == 0) {
      int ring = 0;                      // K/V tiles loaded so far
      for (int w = blockIdx.x, n = 0; w < work.count(); w += gridDim.x, ++n) {
        int qt, hq, b;
        work.decode(w, qt, hq, b);
        const int q0 = qt * kBQ, hk = hq / group, n_tiles = tiles_of(q0);
        mbar_wait(q_empty, (n & 1) ^ 1);   // the last work tile's Q is done
        // whole boxes: the columns of a box past D arrive as zeros and
        // count in the transaction bytes
        mbar_expect_tx(q_full, kBQ * QW * 2);
#pragma unroll
        for (int c = 0; c < QW / kBox; ++c)
          tma_load(base + L::kQ + c * kBQ * 128, &tm_q, q_full, c * kBox, hq, q0, b);
        for (int it = 0; it < n_tiles; ++it, ++ring) {
          const int s = ring % NS;
          mbar_wait(empty0 + 8 * s, ((ring / NS) & 1) ^ 1);
          mbar_expect_tx(full0 + 8 * s, BK * (QW + VW) * 2);
#pragma unroll
          for (int c = 0; c < QW / kBox; ++c)
            tma_load(base + L::kK + s * BK * QW * 2 + c * BK * 128, &tm_k,
                     full0 + 8 * s, c * kBox, hk, it * BK, b);
#pragma unroll
          for (int c = 0; c < VW / kBox; ++c)
            tma_load(base + L::kV + s * BK * VW * 2 + c * BK * 128, &tm_v,
                     full0 + 8 * s, c * kBox, hk, it * BK, b);
        }
      }
    }
  } else {
    // ---- consumer: 64 query rows of each work tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int warp = t / 32, lane = t % 32;
    auto k_tile = [&](int r) { return base + L::kK + (r % NS) * BK * QW * 2; };
    auto v_tile = [&](int r) { return base + L::kV + (r % NS) * BK * VW * 2; };
    auto full = [&](int r) { mbar_wait(full0 + 8 * (r % NS), (r / NS) & 1); };
    auto release = [&](int r) { mbar_arrive(empty0 + 8 * (r % NS)); };
    const uint32_t q_tile = base + L::kQ + wg * kWGRows * 128;
    // turns: warpgroup 0 goes first; each takes one turn per issue of its
    // wgmmas and as many turns as the other (n_tiles + 1 a work tile), so
    // that every arrival on the other's barrier is matched by a sync
    const int my_bar = 1 + wg, other_bar = 2 - wg;
    auto turn = [&](auto&& issue) {
      bar_sync(my_bar);
      issue();
      bar_arrive(other_bar);
    };
    if (wg == 1) bar_arrive(1);

    int ring = 0;                        // K/V tiles consumed so far
    for (int w = blockIdx.x, n = 0; w < work.count(); w += gridDim.x, ++n) {
      int qt, hq, b;
      work.decode(w, qt, hq, b);
      const int q0 = qt * kBQ, n_tiles = tiles_of(q0);
      const int qw = q0 + wg * kWGRows;          // this warpgroup's first row
      const int row0 = qw + warp * 16 + lane / 4;  // rows row0 and row0 + 8
      // tiles this warpgroup needs: up to the causal limit of its last row
      const int wend = qw >= Sq ? 0 : (causal ? min(Sk, qw + kWGRows + off) : Sk);
      const int n_mine = (wend + BK - 1) / BK;
      const Rows rows{row0, lane, Sk, off, causal, scale_log2};
      auto edge = [&](int it) {  // the tile crosses the diagonal or the end Sk
        return (causal && (it + 1) * BK - 1 > qw + off) || (it + 1) * BK > Sk;
      };

      float acc[DV / 2], sc[BK / 2];
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
      uint32_t pa[BK / 16][4];
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, alpha[2];

      mbar_wait(q_full, n & 1);
      if (n_mine > 0) {
        full(ring);
        turn([&] { issue_qk<D, BK>(sc, q_tile, k_tile(ring)); });
        wg_wait<0>();
        fence_regs(sc);
        softmax_tile<BK>(sc, m, l, alpha, rows, 0, edge(0));
        to_bf16<BK>(sc, pa);
        // tile it's Q K^T and tile it-1's P V run while tile it's softmax
        // waits only for the first
        for (int it = 1; it < n_mine; ++it) {
          full(ring + it);
          turn([&] {
            issue_qk<D, BK>(sc, q_tile, k_tile(ring + it));
            issue_pv<DV, BK>(acc, pa, v_tile(ring + it - 1));
          });
          wg_wait<1>();
          fence_regs(sc);
          softmax_tile<BK>(sc, m, l, alpha, rows, it * BK, edge(it));
          wg_wait<0>();
          fence_regs(acc);
          fence_frags<BK / 16>(pa);
          release(ring + it - 1);
#pragma unroll
          for (int i = 0; i < DV / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
          to_bf16<BK>(sc, pa);
        }
        mbar_arrive(q_empty);            // the last Q K^T is done
        turn([&] { issue_pv<DV, BK>(acc, pa, v_tile(ring + n_mine - 1)); });
        wg_wait<0>();
        fence_regs(acc);
        fence_frags<BK / 16>(pa);
        release(ring + n_mine - 1);
      } else {
        mbar_arrive(q_empty);
        turn([] {});
      }
      for (int it = n_mine; it < n_tiles; ++it) {   // past this warpgroup's rows
        full(ring + it);
        turn([] {});
        release(ring + it);
      }
      ring += n_tiles;

      // epilogue: row sums across the quad, normalise, store bf16
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= Sq) continue;
        const float den = fmaxf(l[h], 1e-30f);
        __nv_bfloat16* out =
            o + ((static_cast<int64_t>(b) * Sq + row) * Hq + hq) * DV + (lane % 4) * 2;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h] / den,
                                    acc[4 * j + 2 * h + 1] / den);
      }
    }
    if (wg == 0) bar_sync(1);   // the other's last arrival
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once through the runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Rank-4 map over a contiguous bf16 [B, S, H, D]: boxes of 64 values of D,
// one head and `rows` rows, 128-byte swizzle; rows past S read as zeros.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int S,
              int H, int D, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(H) * D * 2,
                                 static_cast<cuuint64_t>(S) * H * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kBox), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int DV>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int Sq, int Sk, int Hq, int Hkv, float sm_scale, int causal,
              cudaStream_t s) {
  constexpr int BK = Tile<D, DV>::kBK, NS = Tile<D, DV>::kNS;
  constexpr int smem = Smem<D, DV, BK, NS>::kAlloc;
  static bool attr_set = false;         // above 48 KB needs the opt-in
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tc_kernel<D, DV, BK, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(enc, &tm_q, q, B, Sq, Hq, D, kBQ) ||
      !make_map(enc, &tm_k, k, B, Sk, Hkv, D, BK) ||
      !make_map(enc, &tm_v, v, B, Sk, Hkv, DV, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;                 // one persistent CTA an SM
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_work = static_cast<long long>((Sq + kBQ - 1) / kBQ) * Hq * B;
  const unsigned grid = static_cast<unsigned>(n_work < sms ? n_work : sms);
  flash_tc_kernel<D, DV, BK, NS><<<grid, kThreads, smem, s>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), B, Sq, Sk, Hq, Hkv,
      sm_scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// dtype: 0 bf16 -> the tensor-core kernel; 1 f32 -> the CUDA-core kernel.
// D is q's and k's head dim, DV v's. Returns a cudaError_t:
// cudaErrorInvalidValue for a case neither route takes (another dtype code,
// (D, DV) other than (64, 64), (80, 80), (128, 128) and (96, 64), Hq not a
// multiple of Hkv).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, int dtype, int B, int Sq, int Sk,
                              int Hq, int Hkv, int D, int DV, float sm_scale,
                              int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv || B <= 0 || Sq <= 0 || Sk <= 0)
    return cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D == 128 && DV == 128) return cc::launch_cc<128, 128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, sm_scale, causal, s);
    if (D == 64 && DV == 64) return cc::launch_cc<64, 64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, sm_scale, causal, s);
    if (D == 96 && DV == 64) return cc::launch_cc<96, 64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, sm_scale, causal, s);
    if (D == 80 && DV == 80) return cc::launch_cc<80, 80>(q, k, v, o, B, Sq, Sk, Hq, Hkv, sm_scale, causal, s);
    return cudaErrorInvalidValue;
  }
  if (dtype != 0) return cudaErrorInvalidValue;
  if (D == 128 && DV == 128) return tc::launch_tc<128, 128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, sm_scale, causal, s);
  if (D == 64 && DV == 64) return tc::launch_tc<64, 64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, sm_scale, causal, s);
  if (D == 96 && DV == 64) return tc::launch_tc<96, 64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, sm_scale, causal, s);
  if (D == 80 && DV == 80) return tc::launch_tc<80, 80>(q, k, v, o, B, Sq, Sk, Hq, Hkv, sm_scale, causal, s);
  return cudaErrorInvalidValue;
}
