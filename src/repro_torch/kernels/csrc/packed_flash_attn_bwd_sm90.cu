// Packed (segment-aware) flash attention, backward, bf16, for Hopper (sm_90a):
// tensor-core products (wgmma) fed by TMA through an mbarrier ring.
//
// The gradient of the Pallas TPU kernel `_attn_kernel`
// (src/repro/kernels/packed_flash_attn.py:39, launched by
// `packed_flash_attention`), for bf16 inputs; fp32 inputs take the 3xTF32
// backward in packed_flash_attn_bwd.cu. The JAX package has no backward
// kernel (it trains through its jnp attention, which XLA differentiates);
// this one computes the same gradient under the forward's tile skip, so a
// training micro-batch costs sum(l_i^2) rather than N^2 in its backward too.
// The mask is the forward's exactly: a key is visible from a query when both
// carry the same nonzero segment id, pos_q >= pos_k (causal) and
// pos_q - pos_k < window (sliding window); GQA maps query head h to kv head
// h * K / H. A row with no visible key has lse = +inf from the forward, so its
// probabilities, and its gradients, are exactly 0.
//
// Math (FlashAttention-2), per query head, with S = scale * Q K^T over the
// visible pairs, P = exp(S - lse) recomputed from the forward's row
// log-sum-exp, and delta_i = sum_d dO_id O_id:
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - delta),
//   dQ = scale * dS K,  dK = scale * dS^T Q,
// dK and dV summed over the H / K query heads of a KV head, and returned
// un-repeated. One numerical difference from the fp32 backward, as in
// FlashAttention-2/3: P and dS are rounded to bf16 before the three products
// that take them (dV, dK, dQ); S, dP, P's exponent and every sum stay fp32.
//
// Bound on an H100 SXM: operations, 5 products of 2 * dh flops per visible
// (query, key) pair and head (S, dP, dV, dK, dQ). At the serving shape
// (B=4, S=2048, H=32, K=8, dh=128, causal) that is 344 GFLOP, 0.348 ms at
// the 989 TFLOP/s of the bf16 tensor cores, against 337 MB of q, k, v, out,
// dO, lse read and dq, dk, dv written, 0.10 ms at 3.35 TB/s. So every
// product runs on the tensor cores and no tile waits on a synchronous load.
//
// Design. Three kernels, deterministic, no atomics:
//   (a) delta: rowsum(dO o O) over 16-byte loads, a group of lanes per row
//       (dh / 8 rounded up to a power of two, `delta_lanes`); it also
//       writes the forward's lse in units of log2 (+inf on padding rows)
//       and delta (0 there) to (B, H, Sqp) buffers padded to
//       whole 128-row tiles, so that the other kernels copy whole rows of
//       them by bulk copy and need no bounds test.
//   (b) dK/dV: a CTA owns 128 keys of one (batch, KV head), two consumer
//       warpgroups of 64 keys each, plus one producer warpgroup whose first
//       thread issues every copy (and which hands its registers to the
//       consumers by setmaxnreg). K and V arrive once by TMA. The producer
//       streams, for each query head of the GQA group, the 64-row Q and dO
//       tiles whose code in this key tile's column of `blk_kv` is nonzero
//       (with their rows' lse, delta, segment ids and positions by bulk
//       copy) through a ring of STAGES stages. Each warpgroup computes
//       S^T = K Q^T and dP^T = V dO^T with wgmma m64n64k16 (both operands
//       K-major from shared memory), masks code-1 tiles, forms P^T and dS^T
//       in registers with lse and delta taken per column, rounds both to bf16
//       as register A operands (the accumulator layout of S^T is the A layout
//       of P^T), and accumulates dV += P^T dO and dK += dS^T Q with wgmma
//       m64n{dh}k16, reading the same swizzled Q and dO stage as MN-major B
//       operands. dK and dV stay in fp32 registers to the end. Early key
//       tiles, which see the most queries under the causal mask, launch
//       first.
//   (c) dQ: the forward's skeleton with other products. A CTA owns 128 query
//       rows of one (batch, head); Q and dO arrive once by TMA, K and V tiles
//       of 128 keys stream through the ring; each warpgroup computes
//       S = Q K^T and dP = dO V^T (ss), dS in registers, and dQ += dS K (rs,
//       the K tile as an MN-major B operand). Late (heavy) query tiles first.
// This runs 7 products per visible pair where the bound counts 5 (S and dP
// twice): the price of keeping dQ out of atomics. Shared tiles use the
// forward's chunked swizzled layout (sm90_common.cuh); TMA maps are 4-D over
// (dh, heads, S, B), so rows and keys past the sequence are zero-filled. Tile
// codes: 0 skip, 1 mask per element, 2 every pair visible (no mask).
//
// Head width 256 (gemma3) has its own tiles (`Tiles<256>`) and dK/dV kernel,
// because a warpgroup cannot hold 64 x 256 fp32 dK and dV at once (256
// registers a thread against the 232 that setmaxnreg gives a consumer):
//   (b') dK/dV: a CTA owns 64 keys (wgmma's least M), and its two consumer
//       warpgroups split the products rather than the keys. Warpgroup 0
//       computes S^T = K Q^T, forms P^T, and owns dV += P^T dO; warpgroup 1
//       computes dP^T = V dO^T and owns dK += dS^T Q, taking P^T (fp32, 16
//       KB, in the accumulator order both share) from warpgroup 0 through
//       shared memory under two named barriers (full, empty). Each holds one
//       128-register accumulator plus a 64 x 64 score tile, and the CTA still
//       runs 4 products a visible pair: splitting dh instead would recompute
//       S^T and dP^T in both warpgroups (6). K and V take 64 KB, a stage of
//       64-row Q and dO 65 KB, two stages and P^T 210 KB. Where KV heads x
//       key tiles leave SMs idle (gemma3-1b: one KV head, 64 CTAs on 132
//       SMs), the wrapper splits each GQA group's query heads over
//       `splits` CTAs, which store fp32 parts of dK and dV; (d) sums them in
//       split order and rounds to bf16, so the result stays deterministic.
//   (c') dQ: 128-row CTAs as at the other widths, Q and dO resident (128
//       KB), so K and V stream in 32-key stages (33 KB, two stages); S and dP
//       are m64n32 products and dQ += dS K two m64n128 products over the
//       halves of dh, as the forward fills its O at this width.
// The dK/dV kernel's map is at 64 x 64 tiles and the dQ kernel's at 128 x 32;
// the wrapper derives both from one map at 64 x 32 by `coarsen`.
//
// Head width 80 (h2o-danube) runs (a)-(c) at the dh <= 128 tiles on its own
// width: five 16-column chunks under the 32-byte swizzle (sm90_common.cuh),
// Q K^T-type products over 5 k-steps, dV, dK and dQ each one m64n80k16
// product a k-step (40 accumulator registers a thread each), and the delta
// pass at 16 lanes a row, 10 of them loading.
//
// Head widths 16, 32 and 64 (whisper-medium) run two narrow kernels of their
// own, (c'') dQ with the delta pass folded in, then (b'') a persistent dK/dV
// kernel over a compacted list of each key tile's query tiles (the
// `Tiles<64>` branch below; its design note is beside the kernels).

#include "sm90_common.cuh"

namespace {

// Tiles of a head width: dK/dV (query rows per streamed tile, keys per CTA),
// dQ (query rows per CTA, keys per streamed tile), and the multiples the
// wrapper pads the query and key ids (and lse2, delta) to.
template <int DH>
struct Tiles {
  static constexpr int KV_BQ = 64, KV_BK = 128, DQ_BQ = 128, DQ_BK = 128;
  static constexpr int PAD_Q = 128, PAD_K = 128;
};
template <>
struct Tiles<256> {
  static constexpr int KV_BQ = 64, KV_BK = 64, DQ_BQ = 128, DQ_BK = 32;
  static constexpr int PAD_Q = 128, PAD_K = 64;
};
// dh <= 64: dQ at 64 query rows a CTA, so ids pad to 64 queries (the
// narrow kernels (b'') and (c'') below)
struct NarrowTiles {
  static constexpr int KV_BQ = 64, KV_BK = 128, DQ_BQ = 64, DQ_BK = 128;
  static constexpr int PAD_Q = 64, PAD_K = 128;
};
template <> struct Tiles<16> : NarrowTiles {};
template <> struct Tiles<32> : NarrowTiles {};
template <> struct Tiles<64> : NarrowTiles {};
constexpr int CONSUMERS = 256;            // two warpgroups of 64 rows each
constexpr int THREADS = CONSUMERS + 128;  // and one producer warpgroup
constexpr int STAGES = 2;                 // ring depth
constexpr int DELTA_THREADS = 256;
// Registers per thread after `setmaxnreg`: ptxas gives a kernel of three
// warpgroups 168 at launch (65536 / 384), under which dK and dV (or dQ and
// two score tiles) spill at dh = 128; the producer hands its spare ones to
// the consumers. 2 x 232 + 40 = 3 x 168.
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
// named barriers of the dh 256 dK/dV kernel's P^T hand-over (0 is __syncthreads),
// of the narrow dQ kernel's hand-over of warpgroup 1's part, and of each
// warpgroup's turn to issue its score products in the narrow kernels
constexpr int BAR_P_FULL = 1, BAR_P_EMPTY = 2, BAR_MERGE = 3, BAR_TURN = 4;
constexpr int NARROW_STAGES = 4;  // ring depth of the narrow kernels
constexpr int NARROW_KV_BUFS = 2;  // K/V buffers of the narrow dK/dV kernel
// Two habits of the narrow kernels, as in FlashAttention-3. Ping-pong: the
// two warpgroups issue their score products (S and dP, or S^T and dP^T) in
// turn (BAR_TURN + wg), so that one's elementwise work runs while the
// other's products hold the tensor cores; without it they run in step, both
// on the same stage or on two stages that arrive together. Overlap: a
// warpgroup's elementwise work runs while its next product is in flight (P
// while dP runs; in dK/dV also dS^T while dV runs), by waiting for all but
// the last committed product group.

template <int DH>
__host__ __device__ constexpr bool tiles_divide_padding() {
  using T = Tiles<DH>;
  return T::PAD_Q % T::KV_BQ == 0 && T::PAD_Q % T::DQ_BQ == 0 && T::PAD_K % T::KV_BK == 0 &&
         T::PAD_K % T::DQ_BK == 0;
}
static_assert(tiles_divide_padding<64>() && tiles_divide_padding<80>() &&
                  tiles_divide_padding<128>() && tiles_divide_padding<256>(),
              "every tile divides the padding");

// dK/dV shared memory: K and V tiles, then per stage the Q and dO tiles and
// the rows' lse2, delta, segment ids and positions; at dh 256 then the fp32
// P^T tile the two warpgroups hand over; then the barriers.
template <int DH>
struct KvSmem {
  using T = Tiles<DH>;
  static constexpr int KT_BYTES = T::KV_BK * DH * 2;
  static constexpr int QT_BYTES = T::KV_BQ * DH * 2;
  static constexpr int META_BYTES = 4 * T::KV_BQ * 4;
  static constexpr int STAGE_BYTES = 2 * QT_BYTES + META_BYTES;
  static constexpr int STAGE0 = 2 * KT_BYTES;
  static constexpr int PT = STAGE0 + STAGES * STAGE_BYTES;
  static constexpr int PT_BYTES = DH > 128 ? T::KV_BK * T::KV_BQ * 4 : 0;
  static constexpr int BAR = PT + PT_BYTES;  // kv, full[STAGES], empty[STAGES]
  static constexpr int ALLOC = BAR + (1 + 2 * STAGES) * 8 + 1024;  // + slack to align to 1024
  static_assert(KT_BYTES % 1024 == 0 && QT_BYTES % 1024 == 0 && META_BYTES % 1024 == 0,
                "swizzle atoms need 1024-byte alignment");
  static_assert(ALLOC <= 232448, "more shared memory than a CTA can have");
};

// dQ shared memory: Q and dO tiles, then per stage the K and V tiles and the
// keys' segment ids and positions (padded to 1 KB); then the barriers.
template <int DH>
struct DqSmem {
  using T = Tiles<DH>;
  static constexpr int QT_BYTES = T::DQ_BQ * DH * 2;
  static constexpr int KT_BYTES = T::DQ_BK * DH * 2;
  static constexpr int META_BYTES = (2 * T::DQ_BK * 4 + 1023) / 1024 * 1024;
  static constexpr int STAGE_BYTES = 2 * KT_BYTES + META_BYTES;
  static constexpr int LOAD_BYTES = 2 * KT_BYTES + 2 * T::DQ_BK * 4;  // what a stage's copies bring
  static constexpr int STAGE0 = 2 * QT_BYTES;
  static constexpr int BAR = STAGE0 + STAGES * STAGE_BYTES;  // q, full[STAGES], empty[STAGES]
  static constexpr int ALLOC = BAR + (1 + 2 * STAGES) * 8 + 1024;
  static_assert(QT_BYTES % 1024 == 0 && KT_BYTES % 1024 == 0 && META_BYTES % 1024 == 0,
                "swizzle atoms need 1024-byte alignment");
  static_assert(ALLOC <= 232448, "more shared memory than a CTA can have");
};

__device__ __forceinline__ bool visible(int sq, int pq, int sk, int pk, int causal,
                                        int has_window, int window) {
  bool ok = sq == sk && sq != 0;
  if (causal) ok = ok && pq >= pk;
  if (has_window) ok = ok && pq - pk < window;
  return ok;
}

__device__ __forceinline__ void init_ring(uint32_t first) {
  // first: the once-loaded tiles' barrier; then full[STAGES], empty[STAGES]
  mbar_init(first, 1);
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(first + 8u * (1 + s), 1);
    mbar_init(first + 8u * (1 + STAGES + s), CONSUMERS / 32);  // lane 0 of each consumer warp
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Lanes of the delta kernel per row: the dh / 8 lanes that load 8 bf16 (16
// bytes) each, rounded up to a power of two, so that a row's lanes sit in one
// warp and its xor tree mixes no other row's; the spare lanes add 0 (dh 80:
// 10 of 16). Every other width is a power of two, dh / 8 lanes exactly.
template <int DH>
__host__ __device__ constexpr int delta_lanes() {
  int lanes = 1;
  while (lanes < DH / 8) lanes *= 2;
  return lanes;
}
static_assert(delta_lanes<16>() == 2 && delta_lanes<64>() == 8 && delta_lanes<80>() == 16 &&
                  delta_lanes<128>() == 16 && delta_lanes<256>() == 32,
              "a row's lanes divide a warp");

// (a) delta[b, h, s] = sum_d dO[b, s, h, d] O[b, s, h, d] and
// lse2[b, h, s] = lse[b, h, s] * log2(e), over s < Sqp: 0 and +inf past Sq.
template <int DH>
__global__ void __launch_bounds__(DELTA_THREADS)
bwd_sm90_delta_kernel(const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ d_out,
                      const float* __restrict__ lse, float* __restrict__ lse2,
                      float* __restrict__ delta, int Sq, int Sqp, int H, long long rows) {
  constexpr int LPR = delta_lanes<DH>();
  const long long row = (long long)blockIdx.x * (DELTA_THREADS / LPR) + threadIdx.x / LPR;
  const int part = threadIdx.x % LPR;
  const int s = (int)(row % Sqp);
  const long long bh = row / Sqp;  // b * H + h
  const bool valid = row < rows && s < Sq;
  float acc = 0.f;
  if (valid && part < DH / 8) {
    const size_t at = (((size_t)(bh / H) * Sq + s) * H + (size_t)(bh % H)) * DH + part * 8;
    const uint4 o = *reinterpret_cast<const uint4*>(out + at);
    const uint4 g = *reinterpret_cast<const uint4*>(d_out + at);
    const uint32_t ow[4] = {o.x, o.y, o.z, o.w}, gw[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ow[i]));
      const float2 gf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&gw[i]));
      acc = fmaf(of.x, gf.x, acc);
      acc = fmaf(of.y, gf.y, acc);
    }
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && part == 0) {
    delta[row] = valid ? acc : 0.f;
    lse2[row] = valid ? lse[bh * Sq + s] * LOG2E : INFINITY;
  }
}

// (b) dK, dV of KV_BK (128) keys of one KV head, dh <= 128
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
bwd_sm90_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse2,
                     const float* __restrict__ delta, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_k, const int* __restrict__ pos_q,
                     const int* __restrict__ pos_k, const int8_t* __restrict__ blk,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sk,
                     int Sqp, int Skp, int H, int KH, float scale, float scale_log2, int causal,
                     int has_window, int window) {
  using C = Chunking<DH>;
  using M = KvSmem<DH>;
  constexpr int KV_BQ = Tiles<DH>::KV_BQ, KV_BK = Tiles<DH>::KV_BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_kv = base + M::BAR;
  auto bar_full = [&](int s) { return bar_kv + 8u * (1 + s); };
  auto bar_empty = [&](int s) { return bar_kv + 8u * (1 + STAGES + s); };

  const int kh = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;  // early (heavy) key tiles first
  const int nQ = Sqp / KV_BQ, nK = Skp / KV_BK, group = H / KH;
  const int8_t* codes = blk + (size_t)b * nQ * nK + kt;  // this key tile's column: codes[qt * nK]
  const int tid = threadIdx.x;

  if (tid == 0) init_ring(bar_kv);
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS) {
      mbar_expect_tx(bar_kv, 2 * M::KT_BYTES);
#pragma unroll
      for (int c = 0; c < C::NCH; ++c) {
        tma_load_4d(base + c * KV_BK * C::SW, &tm_k, bar_kv, c * C::CW, kh, kt * KV_BK, b);
        tma_load_4d(base + M::KT_BYTES + c * KV_BK * C::SW, &tm_v, bar_kv, c * C::CW, kh,
                    kt * KV_BK, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int h = kh * group; h < (kh + 1) * group; ++h) {
        for (int qt = 0; qt < nQ; ++qt) {
          if (!codes[(size_t)qt * nK]) continue;
          mbar_wait(bar_empty(stage), phase ^ 1u);
          const uint32_t full = bar_full(stage);
          mbar_expect_tx(full, M::STAGE_BYTES);
          const uint32_t dst = base + M::STAGE0 + stage * M::STAGE_BYTES;
#pragma unroll
          for (int c = 0; c < C::NCH; ++c) {
            tma_load_4d(dst + c * KV_BQ * C::SW, &tm_q, full, c * C::CW, h, qt * KV_BQ, b);
            tma_load_4d(dst + M::QT_BYTES + c * KV_BQ * C::SW, &tm_do, full, c * C::CW, h,
                        qt * KV_BQ, b);
          }
          const uint32_t meta = dst + 2 * M::QT_BYTES;
          const size_t stat = ((size_t)b * H + h) * Sqp + (size_t)qt * KV_BQ;
          const size_t ids = (size_t)b * Sqp + (size_t)qt * KV_BQ;
          bulk_load(meta, lse2 + stat, KV_BQ * 4, full);
          bulk_load(meta + KV_BQ * 4, delta + stat, KV_BQ * 4, full);
          bulk_load(meta + 2 * KV_BQ * 4, seg_q + ids, KV_BQ * 4, full);
          bulk_load(meta + 3 * KV_BQ * 4, pos_q + ids, KV_BQ * 4, full);
          if (++stage == STAGES) { stage = 0; phase ^= 1u; }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  // consumers: warpgroup wg owns keys 64 wg .. 64 wg + 63 of the tile; this
  // thread holds keys r0 and r0 + 8 of them (the rows of S^T) and queries
  // 8i + cq (+1) of each streamed tile (its columns)
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = 64 * wg + 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  int sk[2], pk[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const size_t i = (size_t)b * Skp + (size_t)kt * KV_BK + r0 + 8 * j;  // padded: in range
    sk[j] = seg_k[i];
    pk[j] = pos_k[i];
  }
  float dk_acc[DH / 2], dv_acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  const uint32_t k_addr = base + wg * 64 * C::SW, v_addr = k_addr + M::KT_BYTES;
  mbar_wait(bar_kv, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int h = kh * group; h < (kh + 1) * group; ++h) {
    for (int qt = 0; qt < nQ; ++qt) {
      const int code = codes[(size_t)qt * nK];
      if (!code) continue;
      mbar_wait(bar_full(stage), phase);
      const uint32_t q_addr = base + M::STAGE0 + stage * M::STAGE_BYTES;
      const uint32_t do_addr = q_addr + M::QT_BYTES;

      // S^T = K Q^T and dP^T = V dO^T: m64 keys x n64 queries, dh / 16 k-steps
      float s[KV_BQ / 2], dp[KV_BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        Wgmma<KV_BQ>::ss(s, kmajor_desc<DH>(k_addr, KV_BK, kk),
                         kmajor_desc<DH>(q_addr, KV_BQ, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        Wgmma<KV_BQ>::ss(dp, kmajor_desc<DH>(v_addr, KV_BK, kk),
                         kmajor_desc<DH>(do_addr, KV_BQ, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      pin(s);
      pin(dp);

      // P^T = exp2(S^T scale log2e - lse2) where visible, else 0;
      // dS^T = P^T o (dP^T - delta); lse2, delta, ids of column (query) c
      const float* row_lse = reinterpret_cast<const float*>(smem + M::STAGE0 +
                                                            stage * M::STAGE_BYTES +
                                                            2 * M::QT_BYTES);
      const float* row_delta = row_lse + KV_BQ;
      const int* row_seg = reinterpret_cast<const int*>(row_delta + KV_BQ);
      const int* row_pos = row_seg + KV_BQ;
#pragma unroll
      for (int i = 0; i < KV_BQ / 8; ++i) {
        const int c = 8 * i + cq;
        const float2 l2 = *reinterpret_cast<const float2*>(row_lse + c);
        const float2 dl = *reinterpret_cast<const float2*>(row_delta + c);
        const int2 sq = *reinterpret_cast<const int2*>(row_seg + c);
        const int2 pq = *reinterpret_cast<const int2*>(row_pos + c);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool v0 = code == 2 || visible(sq.x, pq.x, sk[j], pk[j], causal, has_window, window);
          const bool v1 = code == 2 || visible(sq.y, pq.y, sk[j], pk[j], causal, has_window, window);
          const int e = 4 * i + 2 * j;
          const float p0 = v0 ? exp2f(fmaf(s[e], scale_log2, -l2.x)) : 0.f;
          const float p1 = v1 ? exp2f(fmaf(s[e + 1], scale_log2, -l2.y)) : 0.f;
          s[e] = p0;
          s[e + 1] = p1;
          dp[e] = p0 * (dp[e] - dl.x);
          dp[e + 1] = p1 * (dp[e + 1] - dl.y);
        }
      }
      // P^T and dS^T to bf16 in the register layout of the wgmma A operand
      uint32_t pa[KV_BQ / 4], dsa[KV_BQ / 4];
#pragma unroll
      for (int i = 0; i < KV_BQ / 4; ++i) {
        pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
        dsa[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
      }

      // dV += P^T dO, dK += dS^T Q: 16 queries per k-step, dO and Q MN-major
      pin(dv_acc);
      pin(dk_acc);
      pin(pa);
      pin(dsa);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < KV_BQ / 16; ++t) {
        Wgmma<DH>::rs(dv_acc, pa + 4 * t, mnmajor_desc<DH>(do_addr, KV_BQ, t));
        Wgmma<DH>::rs(dk_acc, dsa + 4 * t, mnmajor_desc<DH>(q_addr, KV_BQ, t));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(dv_acc);
      pin(dk_acc);
      if (lane == 0) mbar_arrive(bar_empty(stage));
      if (++stage == STAGES) { stage = 0; phase ^= 1u; }
    }
  }

  // epilogue: keys past Sk are not stored; a key no query sees stores 0
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int key = kt * KV_BK + r0 + 8 * j;
    if (key < Sk) {
      const size_t at = (((size_t)b * Sk + key) * KH + kh) * DH + cq;
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * i) = __floats2bfloat162_rn(
            dk_acc[4 * i + 2 * j] * scale, dk_acc[4 * i + 2 * j + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * i) =
            __floats2bfloat162_rn(dv_acc[4 * i + 2 * j], dv_acc[4 * i + 2 * j + 1]);
      }
    }
  }
}

// (b') dK, dV of 64 keys of one KV head at dh 256: warpgroup 0 computes
// S^T and P^T and owns dV, warpgroup 1 computes dP^T and owns dK, P^T
// passing from 0 to 1 through shared memory
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
bwd_sm90_dkdv_split_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const float* __restrict__ lse2, const float* __restrict__ delta,
                           const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                           const int* __restrict__ pos_q, const int* __restrict__ pos_k,
                           const int8_t* __restrict__ blk, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int Sk, int Sqp, int Skp, int H,
                           int KH, float scale, float scale_log2, int causal, int has_window,
                           int window, int splits, float* __restrict__ part) {
  using C = Chunking<DH>;
  using M = KvSmem<DH>;
  constexpr int KV_BQ = Tiles<DH>::KV_BQ, KV_BK = Tiles<DH>::KV_BK;
  constexpr int ON = 128;  // N of one dV or dK product: two over the halves of dh
  static_assert(KV_BK == 64 && DH % ON == 0, "one warpgroup's M per CTA, dh in halves");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_kv = base + M::BAR;
  auto bar_full = [&](int s) { return bar_kv + 8u * (1 + s); };
  auto bar_empty = [&](int s) { return bar_kv + 8u * (1 + STAGES + s); };

  // blockIdx.x: KV head kh, split sp of its GQA group; early (heavy) key tiles first
  const int kh = blockIdx.x / splits, sp = blockIdx.x % splits, b = blockIdx.y, kt = blockIdx.z;
  const int nQ = Sqp / KV_BQ, nK = Skp / KV_BK, heads = H / KH / splits;
  const int h0 = kh * H / KH + sp * heads, h1 = h0 + heads;  // this CTA's query heads
  const int8_t* codes = blk + (size_t)b * nQ * nK + kt;  // this key tile's column: codes[qt * nK]
  const int tid = threadIdx.x;

  if (tid == 0) init_ring(bar_kv);
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer warpgroup: one thread issues every copy, as in (b)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS) {
      mbar_expect_tx(bar_kv, 2 * M::KT_BYTES);
#pragma unroll
      for (int c = 0; c < C::NCH; ++c) {
        tma_load_4d(base + c * KV_BK * C::SW, &tm_k, bar_kv, c * C::CW, kh, kt * KV_BK, b);
        tma_load_4d(base + M::KT_BYTES + c * KV_BK * C::SW, &tm_v, bar_kv, c * C::CW, kh,
                    kt * KV_BK, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int h = h0; h < h1; ++h) {
        for (int qt = 0; qt < nQ; ++qt) {
          if (!codes[(size_t)qt * nK]) continue;
          mbar_wait(bar_empty(stage), phase ^ 1u);
          const uint32_t full = bar_full(stage);
          mbar_expect_tx(full, M::STAGE_BYTES);
          const uint32_t dst = base + M::STAGE0 + stage * M::STAGE_BYTES;
#pragma unroll
          for (int c = 0; c < C::NCH; ++c) {
            tma_load_4d(dst + c * KV_BQ * C::SW, &tm_q, full, c * C::CW, h, qt * KV_BQ, b);
            tma_load_4d(dst + M::QT_BYTES + c * KV_BQ * C::SW, &tm_do, full, c * C::CW, h,
                        qt * KV_BQ, b);
          }
          const uint32_t meta = dst + 2 * M::QT_BYTES;
          const size_t stat = ((size_t)b * H + h) * Sqp + (size_t)qt * KV_BQ;
          const size_t ids = (size_t)b * Sqp + (size_t)qt * KV_BQ;
          bulk_load(meta, lse2 + stat, KV_BQ * 4, full);
          bulk_load(meta + KV_BQ * 4, delta + stat, KV_BQ * 4, full);
          bulk_load(meta + 2 * KV_BQ * 4, seg_q + ids, KV_BQ * 4, full);
          bulk_load(meta + 3 * KV_BQ * 4, pos_q + ids, KV_BQ * 4, full);
          if (++stage == STAGES) { stage = 0; phase ^= 1u; }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  // consumers: both warpgroups cover the CTA's 64 keys; this thread holds
  // keys r0 and r0 + 8 (the rows of S^T, dP^T) and queries 8i + cq (+1) of
  // each streamed tile (the columns), in the same places in both warpgroups
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t128 = tid & 127;
  const int r0 = 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float4* pt = reinterpret_cast<float4*>(smem + M::PT);  // P^T, [KV_BQ / 8][128 threads]
  const uint32_t k_addr = base, v_addr = base + M::KT_BYTES;
  // warpgroup 0: dV = P^T dO; warpgroup 1: dK = dS^T Q (scaled at the store)
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_kv, 0);
  int stage = 0, tiles = 0;
  uint32_t phase = 0;
  if (wg == 0) {
    int sk[2], pk[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const size_t i = (size_t)b * Skp + (size_t)kt * KV_BK + r0 + 8 * j;  // padded: in range
      sk[j] = seg_k[i];
      pk[j] = pos_k[i];
    }
    for (int h = h0; h < h1; ++h) {
      for (int qt = 0; qt < nQ; ++qt) {
        const int code = codes[(size_t)qt * nK];
        if (!code) continue;
        mbar_wait(bar_full(stage), phase);
        const uint32_t q_addr = base + M::STAGE0 + stage * M::STAGE_BYTES;
        const uint32_t do_addr = q_addr + M::QT_BYTES;

        // S^T = K Q^T: m64 keys x n64 queries, dh / 16 k-steps
        float s[KV_BQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          Wgmma<KV_BQ>::ss(s, kmajor_desc<DH>(k_addr, KV_BK, kk),
                           kmajor_desc<DH>(q_addr, KV_BQ, kk), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        pin(s);

        // P^T = exp2(S^T scale log2e - lse2) where visible, else 0
        const float* row_lse = reinterpret_cast<const float*>(
            smem + M::STAGE0 + stage * M::STAGE_BYTES + 2 * M::QT_BYTES);
        const int* row_seg = reinterpret_cast<const int*>(row_lse + 2 * KV_BQ);
        const int* row_pos = row_seg + KV_BQ;
#pragma unroll
        for (int i = 0; i < KV_BQ / 8; ++i) {
          const int c = 8 * i + cq;
          const float2 l2 = *reinterpret_cast<const float2*>(row_lse + c);
          const int2 sq = *reinterpret_cast<const int2*>(row_seg + c);
          const int2 pq = *reinterpret_cast<const int2*>(row_pos + c);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const bool v0 = code == 2 || visible(sq.x, pq.x, sk[j], pk[j], causal, has_window, window);
            const bool v1 = code == 2 || visible(sq.y, pq.y, sk[j], pk[j], causal, has_window, window);
            const int e = 4 * i + 2 * j;
            s[e] = v0 ? exp2f(fmaf(s[e], scale_log2, -l2.x)) : 0.f;
            s[e + 1] = v1 ? exp2f(fmaf(s[e + 1], scale_log2, -l2.y)) : 0.f;
          }
        }
        // hand P^T (fp32) to warpgroup 1, once it has read the last one
        if (tiles > 0) named_bar_sync(BAR_P_EMPTY, CONSUMERS);
#pragma unroll
        for (int i = 0; i < KV_BQ / 8; ++i)
          pt[i * 128 + t128] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
        named_bar_arrive(BAR_P_FULL, CONSUMERS);
        uint32_t pa[KV_BQ / 4];
#pragma unroll
        for (int i = 0; i < KV_BQ / 4; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

        // dV += P^T dO: 16 queries per k-step, dO MN-major, two halves of dh
        pin(acc);
        pin(pa);
        wgmma_fence();
#pragma unroll
        for (int n = 0; n < DH / ON; ++n)
#pragma unroll
          for (int t = 0; t < KV_BQ / 16; ++t)
            Wgmma<ON>::rs(*reinterpret_cast<float(*)[ON / 2]>(acc + n * ON / 2), pa + 4 * t,
                          mnmajor_desc<DH>(do_addr + n * (ON / C::CW) * KV_BQ * C::SW, KV_BQ, t));
        wgmma_commit();
        wgmma_wait_all();
        pin(acc);
        if (lane == 0) mbar_arrive(bar_empty(stage));
        if (++stage == STAGES) { stage = 0; phase ^= 1u; }
        ++tiles;
      }
    }
    // balance warpgroup 1's arrival after it read the last P^T
    if (tiles > 0) named_bar_sync(BAR_P_EMPTY, CONSUMERS);
  } else {
    for (int h = h0; h < h1; ++h) {
      for (int qt = 0; qt < nQ; ++qt) {
        if (!codes[(size_t)qt * nK]) continue;
        mbar_wait(bar_full(stage), phase);
        const uint32_t q_addr = base + M::STAGE0 + stage * M::STAGE_BYTES;
        const uint32_t do_addr = q_addr + M::QT_BYTES;

        // dP^T = V dO^T: m64 keys x n64 queries
        float dp[KV_BQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          Wgmma<KV_BQ>::ss(dp, kmajor_desc<DH>(v_addr, KV_BK, kk),
                           kmajor_desc<DH>(do_addr, KV_BQ, kk), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        pin(dp);

        // dS^T = P^T o (dP^T - delta), P^T from warpgroup 0 (0 where not
        // visible, so no mask here); delta of column (query) c
        named_bar_sync(BAR_P_FULL, CONSUMERS);
        float p[KV_BQ / 2];
#pragma unroll
        for (int i = 0; i < KV_BQ / 8; ++i) {
          const float4 v = pt[i * 128 + t128];
          p[4 * i] = v.x;
          p[4 * i + 1] = v.y;
          p[4 * i + 2] = v.z;
          p[4 * i + 3] = v.w;
        }
        named_bar_arrive(BAR_P_EMPTY, CONSUMERS);
        const float* row_delta = reinterpret_cast<const float*>(
            smem + M::STAGE0 + stage * M::STAGE_BYTES + 2 * M::QT_BYTES) + KV_BQ;
#pragma unroll
        for (int i = 0; i < KV_BQ / 8; ++i) {
          const float2 dl = *reinterpret_cast<const float2*>(row_delta + 8 * i + cq);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int e = 4 * i + 2 * j;
            dp[e] = p[e] * (dp[e] - dl.x);
            dp[e + 1] = p[e + 1] * (dp[e + 1] - dl.y);
          }
        }
        uint32_t dsa[KV_BQ / 4];
#pragma unroll
        for (int i = 0; i < KV_BQ / 4; ++i) dsa[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);

        // dK += dS^T Q: Q MN-major, two halves of dh
        pin(acc);
        pin(dsa);
        wgmma_fence();
#pragma unroll
        for (int n = 0; n < DH / ON; ++n)
#pragma unroll
          for (int t = 0; t < KV_BQ / 16; ++t)
            Wgmma<ON>::rs(*reinterpret_cast<float(*)[ON / 2]>(acc + n * ON / 2), dsa + 4 * t,
                          mnmajor_desc<DH>(q_addr + n * (ON / C::CW) * KV_BQ * C::SW, KV_BQ, t));
        wgmma_commit();
        wgmma_wait_all();
        pin(acc);
        if (lane == 0) mbar_arrive(bar_empty(stage));
        if (++stage == STAGES) { stage = 0; phase ^= 1u; }
      }
    }
  }

  // epilogue: warpgroup 0 stores dV, 1 stores scale dK, in bf16, or, when
  // the group is split, as this split's fp32 part (summed by (d)); keys past
  // Sk are not stored; a key no query sees stores 0
  const float mul = wg == 0 ? 1.f : scale;
  const size_t n = (size_t)gridDim.y * Sk * KH * DH;  // elements of dk (and of dv)
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int key = kt * KV_BK + r0 + 8 * j;
    if (key < Sk) {
      const size_t at = (((size_t)b * Sk + key) * KH + kh) * DH + cq;
      if (splits == 1) {
        __nv_bfloat16* out = wg == 0 ? dv : dk;
#pragma unroll
        for (int i = 0; i < DH / 8; ++i)
          *reinterpret_cast<__nv_bfloat162*>(out + at + 8 * i) =
              __floats2bfloat162_rn(acc[4 * i + 2 * j] * mul, acc[4 * i + 2 * j + 1] * mul);
      } else {
        float* out = part + (size_t)(2 * sp + (wg == 0 ? 1 : 0)) * n + at;  // (split, dk|dv)
#pragma unroll
        for (int i = 0; i < DH / 8; ++i)
          *reinterpret_cast<float2*>(out + 8 * i) =
              make_float2(acc[4 * i + 2 * j] * mul, acc[4 * i + 2 * j + 1] * mul);
      }
    }
  }
}

// (d) dk and dv of a split GQA group: the splits' fp32 parts summed in split
// order (deterministic), rounded to bf16; n elements each, n % 4 == 0
__global__ void __launch_bounds__(DELTA_THREADS)
bwd_sm90_kv_sum_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, long long n, int splits) {
  const long long quads = 2 * n / 4;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < quads;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = 4 * i;  // element of (dk | dv)
    const int which = e >= n;    // 0: dk, 1: dv
    const long long at = e - which * n;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < splits; ++sp) {
      const float4 v = *reinterpret_cast<const float4*>(part + (2 * sp + which) * n + at);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    __nv_bfloat16* out = (which ? dv : dk) + at;
    *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(acc.x, acc.y);
    *reinterpret_cast<__nv_bfloat162*>(out + 2) = __floats2bfloat162_rn(acc.z, acc.w);
  }
}

// (c) dQ of DQ_BQ (128) query rows of one head
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
bwd_sm90_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse2,
                   const float* __restrict__ delta, const int* __restrict__ seg_q,
                   const int* __restrict__ seg_k, const int* __restrict__ pos_q,
                   const int* __restrict__ pos_k, const int8_t* __restrict__ blk,
                   __nv_bfloat16* __restrict__ dq, int Sq, int Sqp, int Skp, int H, int KH,
                   float scale, float scale_log2, int causal, int has_window, int window) {
  using C = Chunking<DH>;
  using M = DqSmem<DH>;
  constexpr int DQ_BQ = Tiles<DH>::DQ_BQ, DQ_BK = Tiles<DH>::DQ_BK;
  constexpr int ON = DH < 128 ? DH : 128;  // N of one dQ += dS K product
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + M::BAR;
  auto bar_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_empty = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };

  const int nQ = Sqp / DQ_BQ, nK = Skp / DQ_BK;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = nQ - 1 - (int)blockIdx.z;  // heavy causal q-tiles first
  const int kh = h * KH / H;
  const int q0 = qt * DQ_BQ;
  const int8_t* codes = blk + ((size_t)b * nQ + qt) * nK;
  const int tid = threadIdx.x;

  if (tid == 0) init_ring(bar_q);
  __syncthreads();

  if (tid >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS) {
      mbar_expect_tx(bar_q, 2 * M::QT_BYTES);
#pragma unroll
      for (int c = 0; c < C::NCH; ++c) {
        tma_load_4d(base + c * DQ_BQ * C::SW, &tm_q, bar_q, c * C::CW, h, q0, b);
        tma_load_4d(base + M::QT_BYTES + c * DQ_BQ * C::SW, &tm_do, bar_q, c * C::CW, h, q0, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < nK; ++kt) {
        if (!codes[kt]) continue;
        mbar_wait(bar_empty(stage), phase ^ 1u);
        const uint32_t full = bar_full(stage);
        mbar_expect_tx(full, M::LOAD_BYTES);
        const uint32_t dst = base + M::STAGE0 + stage * M::STAGE_BYTES;
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          tma_load_4d(dst + c * DQ_BK * C::SW, &tm_k, full, c * C::CW, kh, kt * DQ_BK, b);
          tma_load_4d(dst + M::KT_BYTES + c * DQ_BK * C::SW, &tm_v, full, c * C::CW, kh,
                      kt * DQ_BK, b);
        }
        const uint32_t meta = dst + 2 * M::KT_BYTES;
        const size_t ids = (size_t)b * Skp + (size_t)kt * DQ_BK;
        bulk_load(meta, seg_k + ids, DQ_BK * 4, full);
        bulk_load(meta + DQ_BK * 4, pos_k + ids, DQ_BK * 4, full);
        if (++stage == STAGES) { stage = 0; phase ^= 1u; }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the q-tile; this
  // thread holds rows r0 and r0 + 8 of them
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = 64 * wg + 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  int sq[2], pq[2];
  float l2[2], dl[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = q0 + r0 + 8 * j;  // < Sqp: every buffer is padded
    sq[j] = seg_q[(size_t)b * Sqp + row];
    pq[j] = pos_q[(size_t)b * Sqp + row];
    l2[j] = lse2[((size_t)b * H + h) * Sqp + row];
    dl[j] = delta[((size_t)b * H + h) * Sqp + row];
  }
  float dq_acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dq_acc[i] = 0.f;

  const uint32_t q_addr = base + wg * 64 * C::SW, do_addr = q_addr + M::QT_BYTES;
  mbar_wait(bar_q, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < nK; ++kt) {
    const int code = codes[kt];
    if (!code) continue;
    mbar_wait(bar_full(stage), phase);
    const uint32_t k_addr = base + M::STAGE0 + stage * M::STAGE_BYTES;
    const uint32_t v_addr = k_addr + M::KT_BYTES;

    // S = Q K^T and dP = dO V^T: m64 rows x n{DQ_BK} keys
    float s[DQ_BK / 2], dp[DQ_BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      Wgmma<DQ_BK>::ss(s, kmajor_desc<DH>(q_addr, DQ_BQ, kk), kmajor_desc<DH>(k_addr, DQ_BK, kk),
                       kk > 0);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      Wgmma<DQ_BK>::ss(dp, kmajor_desc<DH>(do_addr, DQ_BQ, kk),
                       kmajor_desc<DH>(v_addr, DQ_BK, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    pin(s);
    pin(dp);

    // dS = P o (dP - delta), P = exp2(S scale log2e - lse2) where visible
    const int* key_seg = reinterpret_cast<const int*>(smem + M::STAGE0 + stage * M::STAGE_BYTES +
                                                      2 * M::KT_BYTES);
    const int* key_pos = key_seg + DQ_BK;
#pragma unroll
    for (int i = 0; i < DQ_BK / 8; ++i) {
      const int2 skv = *reinterpret_cast<const int2*>(key_seg + 8 * i + cq);
      const int2 pkv = *reinterpret_cast<const int2*>(key_pos + 8 * i + cq);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool v0 = code == 2 || visible(sq[j], pq[j], skv.x, pkv.x, causal, has_window, window);
        const bool v1 = code == 2 || visible(sq[j], pq[j], skv.y, pkv.y, causal, has_window, window);
        const int e = 4 * i + 2 * j;
        const float p0 = v0 ? exp2f(fmaf(s[e], scale_log2, -l2[j])) : 0.f;
        const float p1 = v1 ? exp2f(fmaf(s[e + 1], scale_log2, -l2[j])) : 0.f;
        dp[e] = p0 * (dp[e] - dl[j]);
        dp[e + 1] = p1 * (dp[e + 1] - dl[j]);
      }
    }
    uint32_t dsa[DQ_BK / 4];
#pragma unroll
    for (int i = 0; i < DQ_BK / 4; ++i) dsa[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);

    // dQ += dS K: 16 keys per k-step, K MN-major; product n fills dQ's
    // columns ON n .. ON n + ON - 1 from the K chunks that hold them
    pin(dq_acc);
    pin(dsa);
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < DH / ON; ++n)
#pragma unroll
      for (int t = 0; t < DQ_BK / 16; ++t)
        Wgmma<ON>::rs(*reinterpret_cast<float(*)[ON / 2]>(dq_acc + n * ON / 2), dsa + 4 * t,
                      mnmajor_desc<DH>(k_addr + n * (ON / C::CW) * DQ_BK * C::SW, DQ_BK, t));
    wgmma_commit();
    wgmma_wait_all();
    pin(dq_acc);
    if (lane == 0) mbar_arrive(bar_empty(stage));
    if (++stage == STAGES) { stage = 0; phase ^= 1u; }
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = q0 + r0 + 8 * j;
    if (row < Sq) {
      __nv_bfloat16* drow = dq + (((size_t)b * Sq + row) * H + h) * DH + cq;
#pragma unroll
      for (int i = 0; i < DH / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(drow + 8 * i) = __floats2bfloat162_rn(
            dq_acc[4 * i + 2 * j] * scale, dq_acc[4 * i + 2 * j + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// Narrow heads (dh <= 64: whisper-medium's 64, and 16, 32). At these widths a
// CTA's products are few and short, so its fixed chain (launch, barrier set-
// up, the once-loaded tiles, the first stage, the epilogue) and the launches
// themselves set the time: whisper serving's cross-attention (64 queries over
// 1500 keys) gave 768 dK/dV CTAs of one stage each, 5.8 waves of that chain,
// and 64 dQ CTAs whose 128-row tiles were half padding. Two kernels, no
// delta launch:
//   (c'') dQ, launched first, with the delta pass folded in: a CTA owns 64
//       query rows of one (batch, head) (two such map rows, one a
//       warpgroup, in pair mode: see the kernel); each consumer thread computes
//       delta for its two rows from O and dO in device memory (a quad of
//       threads a row, DH / 4 columns each) while Q and dO arrive by TMA,
//       and warpgroup 0 writes lse2 and delta to the (B, H, Sqp) buffers
//       that (b'') reads. Both warpgroups hold all 64 rows and take the
//       row's visible key tiles in turn (the even ones warpgroup 0, the odd
//       ones 1) through a ring of NARROW_STAGES stages, visible tile i in
//       stage i % NARROW_STAGES; warpgroup 1 hands its fp32 dQ part to
//       warpgroup 0 through shared memory, which adds it (in that order:
//       deterministic) and stores.
//   (b'') dK/dV, persistent: `ctas` CTAs (one an SM) walk the work items,
//       (key tile, KV head, batch) with early (heavy) key tiles first: CTA c
//       starts on item c, and each later item goes to the first CTA whose
//       producer asks for one (an atomic counter, which (c'') zeroes), so
//       uneven items (packed clips) balance as the hardware's own block
//       scheduling would; every item is computed the same way whichever CTA
//       takes it, so the result is deterministic. K, V and the keys' ids of
//       an item go into one of NARROW_KV_BUFS buffers, so the producer
//       copies the next item's while the consumers finish this one and
//       store its dK and dV. The
//       producer's first warp reads the item's column of tile codes once,
//       32 codes a load, and compacts the nonzero ones into a list in
//       shared memory (qt << 2 | code; a ballot and a prefix count), which
//       the producer and both consumer warpgroups walk: no thread scans the
//       column byte by byte at a stride of nK. The products are (b)'s.
// ---------------------------------------------------------------------------

// sum of a[i] b[i] over N bf16 (N a multiple of 4), in 16-byte loads (8-byte
// ones when N is not a multiple of 8)
template <int N>
__device__ __forceinline__ float dot_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b) {
  constexpr int W = N % 8 == 0 ? 8 : 4;  // bf16 a load
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < N; i += W) {
    uint32_t aw[W / 2], bw[W / 2];
    if constexpr (W == 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(a + i);
      const uint4 y = *reinterpret_cast<const uint4*>(b + i);
      aw[0] = x.x; aw[1] = x.y; aw[2] = x.z; aw[3] = x.w;
      bw[0] = y.x; bw[1] = y.y; bw[2] = y.z; bw[3] = y.w;
    } else {
      const uint2 x = *reinterpret_cast<const uint2*>(a + i);
      const uint2 y = *reinterpret_cast<const uint2*>(b + i);
      aw[0] = x.x; aw[1] = x.y;
      bw[0] = y.x; bw[1] = y.y;
    }
#pragma unroll
    for (int w = 0; w < W / 2; ++w) {
      const float2 af = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&aw[w]));
      const float2 bf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bw[w]));
      acc = fmaf(af.x, bf.x, acc);
      acc = fmaf(af.y, bf.y, acc);
    }
  }
  return acc;
}

// (c'') shared memory: the Q tiles of the CTA's map rows (64 rows each; two
// in pair mode), then their dO tiles, then per stage the K and V tiles and
// the keys' segment ids and positions; warpgroup 1's dQ part (DH / 2 floats
// a thread, split mode); then the barriers.
template <int DH>
struct DqNarrowSmem {
  using T = Tiles<DH>;
  static constexpr int QT_BYTES = T::DQ_BQ * DH * 2;
  static constexpr int KT_BYTES = T::DQ_BK * DH * 2;
  static constexpr int META_BYTES = 2 * T::DQ_BK * 4;
  static constexpr int STAGE_BYTES = 2 * KT_BYTES + META_BYTES;
  static constexpr int DO = 2 * QT_BYTES;  // Q of map rows 0 and 1, then dO of each
  static constexpr int STAGE0 = 4 * QT_BYTES;
  static constexpr int MERGE = STAGE0 + NARROW_STAGES * STAGE_BYTES;
  static constexpr int BAR = MERGE + 128 * (DH / 2) * 4;  // q, full[STAGES], empty[STAGES]
  static constexpr int ALLOC = BAR + (1 + 2 * NARROW_STAGES) * 8 + 1024;
  static_assert(QT_BYTES % 1024 == 0 && KT_BYTES % 1024 == 0 && META_BYTES % 1024 == 0,
                "swizzle atoms need 1024-byte alignment");
  static_assert(ALLOC <= 232448, "more shared memory than a CTA can have");
};

// (c'') dQ of one or two 64-row map rows of one head, dh <= 64, and the
// rows' lse2 and delta. Split mode (pair 0): one map row a CTA, the two
// warpgroups taking its visible key tiles in turn and adding their parts in
// shared memory. Pair mode (pair 1, grids of two waves or more, as the
// forward's): two map rows a CTA, one a warpgroup, both consuming every key
// tile either row needs, so that each K/V tile serves 128 rows. One
// instance a mode (PAIR).
template <int DH, bool PAIR>
__global__ void __launch_bounds__(THREADS, 1)
bwd_sm90_dq_narrow_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __nv_bfloat16* __restrict__ out,
                          const __nv_bfloat16* __restrict__ d_out, const float* __restrict__ lse,
                          float* __restrict__ lse2, float* __restrict__ delta,
                          const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                          const int* __restrict__ pos_q, const int* __restrict__ pos_k,
                          const int8_t* __restrict__ blk, __nv_bfloat16* __restrict__ dq,
                          int* __restrict__ next_item, int Sq, int Sqp, int Skp, int H, int KH,
                          float scale, float scale_log2, int causal, int has_window,
                          int window) {
  using M = DqNarrowSmem<DH>;
  constexpr int BQ = Tiles<DH>::DQ_BQ, BK = Tiles<DH>::DQ_BK, NST = NARROW_STAGES;
  constexpr bool pair = PAIR;
  static_assert(DH <= 64 && Chunking<DH>::NCH == 1, "one chunk a row");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + M::BAR;
  auto bar_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_empty = [&](int s) { return bar_q + 8u * (1 + NST + s); };

  const int nQ = Sqp / BQ, nK = Skp / BK;
  const int h = blockIdx.x, b = blockIdx.y;
  const int ct = (pair ? (nQ + 1) / 2 : nQ) - 1 - (int)blockIdx.z;  // heavy causal tiles first
  const int kh = h * KH / H;
  // the CTA's map rows: mt0 (and, in pair mode, mt0 + 1 if there is one)
  const int mt0 = pair ? 2 * ct : ct;
  const bool two = pair && mt0 + 1 < nQ;
  const int8_t* codes0 = blk + ((size_t)b * nQ + mt0) * nK;
  const int8_t* codes1 = codes0 + nK;  // read only when `two`
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(bar_full(s), 1);
      // lane 0 of each warp of the stage's consumers: one warpgroup, or both
      mbar_init(bar_empty(s), pair ? 8 : 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // (b''), launched after this kernel, hands out its items from 0
    if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) *next_item = 0;
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS) {
      mbar_expect_tx(bar_q, (two ? 4 : 2) * M::QT_BYTES);
      tma_load_4d(base, &tm_q, bar_q, 0, h, mt0 * BQ, b);
      tma_load_4d(base + M::DO, &tm_do, bar_q, 0, h, mt0 * BQ, b);
      if (two) {
        tma_load_4d(base + M::QT_BYTES, &tm_q, bar_q, 0, h, (mt0 + 1) * BQ, b);
        tma_load_4d(base + M::DO + M::QT_BYTES, &tm_do, bar_q, 0, h, (mt0 + 1) * BQ, b);
      }
      int n = 0;
      for (int kt = 0; kt < nK; ++kt) {
        if (!(codes0[kt] | (two ? codes1[kt] : 0))) continue;
        const int stage = n % NST;
        const uint32_t phase = (n / NST) & 1u;
        ++n;
        mbar_wait(bar_empty(stage), phase ^ 1u);
        const uint32_t full = bar_full(stage);
        mbar_expect_tx(full, M::STAGE_BYTES);
        const uint32_t dst = base + M::STAGE0 + stage * M::STAGE_BYTES;
        tma_load_4d(dst, &tm_k, full, 0, kh, kt * BK, b);
        tma_load_4d(dst + M::KT_BYTES, &tm_v, full, 0, kh, kt * BK, b);
        const size_t ids = (size_t)b * Skp + (size_t)kt * BK;
        bulk_load(dst + 2 * M::KT_BYTES, seg_k + ids, BK * 4, full);
        bulk_load(dst + 2 * M::KT_BYTES + BK * 4, pos_k + ids, BK * 4, full);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  // consumers: warpgroup wg's map row mt (both hold mt0 in split mode), this
  // thread its rows r0 and r0 + 8; `mine` false for pair mode's missing row.
  // First the delta pass over the rows, while Q and dO arrive.
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t128 = tid & 127;
  const int r0 = 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int mt = pair ? mt0 + wg : mt0;
  const bool mine = !pair || wg == 0 || two;
  const int8_t* codes = pair && wg == 1 ? codes1 : codes0;
  int sq[2] = {0, 0}, pq[2] = {0, 0};
  float l2[2] = {INFINITY, INFINITY}, dl[2] = {0.f, 0.f};
  if (mine) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = mt * BQ + r0 + 8 * j;  // < Sqp: the ids are padded
      sq[j] = seg_q[(size_t)b * Sqp + row];
      pq[j] = pos_q[(size_t)b * Sqp + row];
      float acc = 0.f;
      if (row < Sq) {
        const size_t at = (((size_t)b * Sq + row) * H + h) * DH + (lane & 3) * (DH / 4);
        acc = dot_bf16<DH / 4>(out + at, d_out + at);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      l2[j] = row < Sq ? lse[((size_t)b * H + h) * Sq + row] * LOG2E : INFINITY;
      dl[j] = row < Sq ? acc : 0.f;
      if ((pair || wg == 0) && (lane & 3) == 0) {
        lse2[((size_t)b * H + h) * Sqp + row] = l2[j];
        delta[((size_t)b * H + h) * Sqp + row] = dl[j];
      }
    }
  }
  float dq_acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dq_acc[i] = 0.f;

  const uint32_t q_addr = base + (pair ? wg * M::QT_BYTES : 0), do_addr = q_addr + M::DO;
  mbar_wait(bar_q, 0);
  if (wg == 1) named_bar_arrive(BAR_TURN, CONSUMERS);  // warpgroup 0 first
  int n = 0;
  for (int kt = 0; kt < nK; ++kt) {
    const int any = codes0[kt] | (two ? codes1[kt] : 0);
    if (!any) continue;
    const int idx = n++;
    if (!pair && (idx & 1) != wg) continue;
    // a pair-mode warpgroup runs every tile, masked where its own row sees
    // none of it (code 0 there, or no row): no product is conditional, which
    // would serialize the asynchronous ones
    const int own = pair && mine ? codes[kt] : 0;
    const int code = pair ? (own ? own : 1) : any;
    const int stage = idx % NST;
    mbar_wait(bar_full(stage), (idx / NST) & 1u);
    const uint32_t k_addr = base + M::STAGE0 + stage * M::STAGE_BYTES;
    const uint32_t v_addr = k_addr + M::KT_BYTES;

    // S = Q K^T, then dP = dO V^T, two commit groups: m64 rows x n128 keys,
    // in this warpgroup's turn; P is computed while dP runs
    float s[BK / 2], dp[BK / 2];
    named_bar_sync(BAR_TURN + wg, CONSUMERS);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      Wgmma<BK>::ss(s, kmajor_desc<DH>(q_addr, BQ, kk), kmajor_desc<DH>(k_addr, BK, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      Wgmma<BK>::ss(dp, kmajor_desc<DH>(do_addr, BQ, kk), kmajor_desc<DH>(v_addr, BK, kk), kk > 0);
    wgmma_commit();
    named_bar_arrive(BAR_TURN + 1 - wg, CONSUMERS);
    wgmma_wait<1>();  // S
    pin(s);

    // P = exp2(S scale log2e - lse2) where visible, else 0
    const int* key_seg = reinterpret_cast<const int*>(smem + M::STAGE0 +
                                                      stage * M::STAGE_BYTES + 2 * M::KT_BYTES);
    const int* key_pos = key_seg + BK;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const int2 skv = *reinterpret_cast<const int2*>(key_seg + 8 * i + cq);
      const int2 pkv = *reinterpret_cast<const int2*>(key_pos + 8 * i + cq);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool v0 = code == 2 || visible(sq[j], pq[j], skv.x, pkv.x, causal, has_window, window);
        const bool v1 = code == 2 || visible(sq[j], pq[j], skv.y, pkv.y, causal, has_window, window);
        const int e = 4 * i + 2 * j;
        s[e] = v0 ? exp2f(fmaf(s[e], scale_log2, -l2[j])) : 0.f;
        s[e + 1] = v1 ? exp2f(fmaf(s[e + 1], scale_log2, -l2[j])) : 0.f;
      }
    }
    wgmma_wait_all();  // dP
    pin(dp);
    // dS = P o (dP - delta), to bf16 in the register layout of the A operand
    uint32_t dsa[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 4 * i + 2 * j;
        dsa[2 * i + j] = pack_bf16(s[e] * (dp[e] - dl[j]), s[e + 1] * (dp[e + 1] - dl[j]));
      }

    // dQ += dS K: 16 keys per k-step, K MN-major
    pin(dq_acc);
    pin(dsa);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
      Wgmma<DH>::rs(dq_acc, dsa + 4 * t, mnmajor_desc<DH>(k_addr, BK, t));
    wgmma_commit();
    wgmma_wait_all();
    pin(dq_acc);
    if (lane == 0) mbar_arrive(bar_empty(stage));
  }
  // the last hand-on of a turn is taken: in split mode by warpgroup n % 2,
  // in pair mode, where both take every tile, by 0
  if (wg == (pair ? 0 : n & 1)) named_bar_sync(BAR_TURN + wg, CONSUMERS);

  if (!pair) {
    // warpgroup 1 hands its part to warpgroup 0, thread for thread
    float* mg = reinterpret_cast<float*>(smem + M::MERGE);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) mg[i * 128 + t128] = dq_acc[i];
      named_bar_arrive(BAR_MERGE, CONSUMERS);
      return;
    }
    named_bar_sync(BAR_MERGE, CONSUMERS);
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dq_acc[i] += mg[i * 128 + t128];
  }
  if (!mine) return;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = mt * BQ + r0 + 8 * j;
    if (row < Sq) {
      __nv_bfloat16* drow = dq + (((size_t)b * Sq + row) * H + h) * DH + cq;
#pragma unroll
      for (int i = 0; i < DH / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(drow + 8 * i) = __floats2bfloat162_rn(
            dq_acc[4 * i + 2 * j] * scale, dq_acc[4 * i + 2 * j + 1] * scale);
    }
  }
}

// (b'') shared memory: NARROW_KV_BUFS buffers of an item's K and V tiles, the
// ring's stages (Q and dO tiles, the rows' lse2, delta, segment ids,
// positions), each buffer's key ids, each buffer's item and count of listed
// query tiles, the barriers; then (sized at launch) each buffer's list of
// query tiles.
template <int DH>
struct KvNarrowSmem {
  using T = Tiles<DH>;
  static constexpr int KT_BYTES = T::KV_BK * DH * 2;
  static constexpr int QT_BYTES = T::KV_BQ * DH * 2;
  static constexpr int META_BYTES = 4 * T::KV_BQ * 4;
  static constexpr int STAGE_BYTES = 2 * QT_BYTES + META_BYTES;
  static constexpr int NB = NARROW_KV_BUFS;
  static constexpr int KV_BUF = 2 * KT_BYTES;
  static constexpr int STAGE0 = NB * KV_BUF;
  static constexpr int KMETA = STAGE0 + NARROW_STAGES * STAGE_BYTES;  // buffer u: seg_k, pos_k
  static constexpr int KMETA_BYTES = 2 * T::KV_BK * 4;
  static constexpr int COUNT = KMETA + NB * KMETA_BYTES;  // int count[NB], item[NB]
  static constexpr int BAR = COUNT + (8 * NB + 15) / 16 * 16;  // kv_full[NB], kv_empty[NB],
  // full[STAGES], empty[STAGES]
  static constexpr int LIST = BAR + (2 * NB + 2 * NARROW_STAGES + 1) / 2 * 16;  // uint16
  // list[NB][list_cap]
  static_assert(KT_BYTES % 1024 == 0 && QT_BYTES % 1024 == 0 && META_BYTES % 1024 == 0 &&
                    KMETA_BYTES % 1024 == 0 && LIST % 16 == 0,
                "swizzle atoms need 1024-byte alignment");
  // bytes of dynamic shared memory with lists of `cap` entries (1024 of slack to align)
  static constexpr int alloc(int cap) { return LIST + NB * cap * 2 + 1024; }
};

// (b'') dK, dV, dh <= 64: persistent CTAs over (key tile, KV head, batch)
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
bwd_sm90_dkdv_narrow_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const float* __restrict__ lse2, const float* __restrict__ delta,
                            const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                            const int* __restrict__ pos_q, const int* __restrict__ pos_k,
                            const int8_t* __restrict__ blk, __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int* __restrict__ next_item, int B,
                            int Sk, int Sqp, int Skp, int H, int KH, float scale,
                            float scale_log2, int causal, int has_window, int window,
                            int list_cap) {
  using C = Chunking<DH>;
  using M = KvNarrowSmem<DH>;
  constexpr int KV_BQ = Tiles<DH>::KV_BQ, KV_BK = Tiles<DH>::KV_BK, NST = NARROW_STAGES;
  constexpr int NB = M::NB;
  static_assert(DH <= 64 && C::NCH == 1, "one chunk a row");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar = base + M::BAR;
  auto kv_full = [&](int u) { return bar + 8u * u; };
  auto kv_empty = [&](int u) { return bar + 8u * (NB + u); };
  auto bar_full = [&](int s) { return bar + 8u * (2 * NB + s); };
  auto bar_empty = [&](int s) { return bar + 8u * (2 * NB + NST + s); };
  int* counts = reinterpret_cast<int*>(smem + M::COUNT);
  int* item_of = counts + NB;  // buffer u's item, -1: no more items
  uint16_t* lists = reinterpret_cast<uint16_t*>(smem + M::LIST);

  const int nQ = Sqp / KV_BQ, nK = Skp / KV_BK, group = H / KH, items = nK * KH * B;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int u = 0; u < NB; ++u) {
      mbar_init(kv_full(u), 1);
      mbar_init(kv_empty(u), CONSUMERS / 32);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < NST; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: its first warp lists each item's query tiles, and that
    // warp's first thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid < CONSUMERS + 32) {
      const int lane = tid & 31;
      int stage = 0;
      uint32_t phase = 0;
      for (int n = 0;; ++n) {
        const int u = n % NB;
        mbar_wait(kv_empty(u), ((n / NB) & 1u) ^ 1u);
        // this CTA's first item is its index, each later one the next unclaimed
        int item = 0;
        if (lane == 0) item = n == 0 ? (int)blockIdx.x : (int)gridDim.x + atomicAdd(next_item, 1);
        item = __shfl_sync(0xffffffffu, item, 0);
        if (item >= items) {  // tell the consumers, and stop
          if (lane == 0) {
            item_of[u] = -1;
            mbar_arrive(kv_full(u));
          }
          break;
        }
        const int kt = item / (KH * B), kh = item % (KH * B) / B, b = item % B;
        // the key tile's column of codes (codes[qt * nK]), 32 a load, its
        // nonzero entries listed in order
        const int8_t* col = blk + (size_t)b * nQ * nK + kt;
        uint16_t* list = lists + u * list_cap;
        int cnt = 0;
        for (int q0 = 0; q0 < nQ; q0 += 32) {
          const int qt = q0 + lane;
          const int code = qt < nQ ? col[(size_t)qt * nK] : 0;
          const unsigned nz = __ballot_sync(0xffffffffu, code != 0);
          if (code) list[cnt + __popc(nz & ((1u << lane) - 1u))] = (uint16_t)(qt << 2 | code);
          cnt += __popc(nz);
        }
        if (lane == 0) {
          counts[u] = cnt;
          item_of[u] = item;
        }
        __threadfence_block();
        __syncwarp();
        if (lane == 0) {
          const uint32_t kvf = kv_full(u);
          mbar_expect_tx(kvf, 2 * M::KT_BYTES + M::KMETA_BYTES);
          const uint32_t kdst = base + u * M::KV_BUF;
          tma_load_4d(kdst, &tm_k, kvf, 0, kh, kt * KV_BK, b);
          tma_load_4d(kdst + M::KT_BYTES, &tm_v, kvf, 0, kh, kt * KV_BK, b);
          const uint32_t kmeta = base + M::KMETA + u * M::KMETA_BYTES;
          const size_t kid = (size_t)b * Skp + (size_t)kt * KV_BK;
          bulk_load(kmeta, seg_k + kid, KV_BK * 4, kvf);
          bulk_load(kmeta + KV_BK * 4, pos_k + kid, KV_BK * 4, kvf);
          for (int h = kh * group; h < (kh + 1) * group; ++h) {
            for (int e = 0; e < cnt; ++e) {
              const int qt = list[e] >> 2;
              mbar_wait(bar_empty(stage), phase ^ 1u);
              const uint32_t full = bar_full(stage);
              mbar_expect_tx(full, M::STAGE_BYTES);
              const uint32_t dst = base + M::STAGE0 + stage * M::STAGE_BYTES;
              tma_load_4d(dst, &tm_q, full, 0, h, qt * KV_BQ, b);
              tma_load_4d(dst + M::QT_BYTES, &tm_do, full, 0, h, qt * KV_BQ, b);
              const uint32_t meta = dst + 2 * M::QT_BYTES;
              const size_t stat = ((size_t)b * H + h) * Sqp + (size_t)qt * KV_BQ;
              const size_t ids = (size_t)b * Sqp + (size_t)qt * KV_BQ;
              bulk_load(meta, lse2 + stat, KV_BQ * 4, full);
              bulk_load(meta + KV_BQ * 4, delta + stat, KV_BQ * 4, full);
              bulk_load(meta + 2 * KV_BQ * 4, seg_q + ids, KV_BQ * 4, full);
              bulk_load(meta + 3 * KV_BQ * 4, pos_q + ids, KV_BQ * 4, full);
              if (++stage == NST) { stage = 0; phase ^= 1u; }
            }
          }
        }
        __syncwarp();
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  // consumers: warpgroup wg owns keys 64 wg .. 64 wg + 63 of each item's
  // tile; this thread keys r0 and r0 + 8 (rows of S^T), queries 8i + cq (+1)
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = 64 * wg + 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  int stage = 0;
  uint32_t phase = 0;
  if (wg == 1) named_bar_arrive(BAR_TURN, CONSUMERS);  // warpgroup 0 first
  for (int n = 0;; ++n) {
    const int u = n % NB;
    mbar_wait(kv_full(u), (n / NB) & 1u);
    const int item = item_of[u];
    if (item < 0) break;
    const int kt = item / (KH * B), kh = item % (KH * B) / B, b = item % B;
    const int cnt = counts[u];
    const uint16_t* list = lists + u * list_cap;
    const int* kseg = reinterpret_cast<const int*>(smem + M::KMETA + u * M::KMETA_BYTES);
    int sk[2], pk[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sk[j] = kseg[r0 + 8 * j];
      pk[j] = kseg[KV_BK + r0 + 8 * j];
    }
    float dk_acc[DH / 2], dv_acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const uint32_t k_addr = base + u * M::KV_BUF + wg * 64 * C::SW, v_addr = k_addr + M::KT_BYTES;

    for (int h = kh * group; h < (kh + 1) * group; ++h) {
      for (int e = 0; e < cnt; ++e) {
        const int code = list[e] & 3;
        mbar_wait(bar_full(stage), phase);
        const uint32_t q_addr = base + M::STAGE0 + stage * M::STAGE_BYTES;
        const uint32_t do_addr = q_addr + M::QT_BYTES;

        // S^T = K Q^T, then dP^T = V dO^T, two commit groups: m64 keys x n64
        // queries, in this warpgroup's turn (warpgroup 0 issues each stage's
        // first). The chain below overlaps its elementwise work with the
        // products in flight: P^T while dP^T runs, dS^T while dV runs.
        float s[KV_BQ / 2], dp[KV_BQ / 2];
        named_bar_sync(BAR_TURN + wg, CONSUMERS);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          Wgmma<KV_BQ>::ss(s, kmajor_desc<DH>(k_addr, KV_BK, kk),
                           kmajor_desc<DH>(q_addr, KV_BQ, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          Wgmma<KV_BQ>::ss(dp, kmajor_desc<DH>(v_addr, KV_BK, kk),
                           kmajor_desc<DH>(do_addr, KV_BQ, kk), kk > 0);
        wgmma_commit();
        named_bar_arrive(BAR_TURN + 1 - wg, CONSUMERS);
        wgmma_wait<1>();  // S^T
        pin(s);

        // P^T = exp2(S^T scale log2e - lse2) where visible, else 0; lse2,
        // delta and ids of column (query) c
        const float* row_lse = reinterpret_cast<const float*>(smem + M::STAGE0 +
                                                              stage * M::STAGE_BYTES +
                                                              2 * M::QT_BYTES);
        const float* row_delta = row_lse + KV_BQ;
        const int* row_seg = reinterpret_cast<const int*>(row_delta + KV_BQ);
        const int* row_pos = row_seg + KV_BQ;
#pragma unroll
        for (int i = 0; i < KV_BQ / 8; ++i) {
          const int c = 8 * i + cq;
          const float2 l2 = *reinterpret_cast<const float2*>(row_lse + c);
          const int2 sq = *reinterpret_cast<const int2*>(row_seg + c);
          const int2 pq = *reinterpret_cast<const int2*>(row_pos + c);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const bool v0 = code == 2 || visible(sq.x, pq.x, sk[j], pk[j], causal, has_window, window);
            const bool v1 = code == 2 || visible(sq.y, pq.y, sk[j], pk[j], causal, has_window, window);
            const int x = 4 * i + 2 * j;
            s[x] = v0 ? exp2f(fmaf(s[x], scale_log2, -l2.x)) : 0.f;
            s[x + 1] = v1 ? exp2f(fmaf(s[x + 1], scale_log2, -l2.y)) : 0.f;
          }
        }
        uint32_t pa[KV_BQ / 4], dsa[KV_BQ / 4];
#pragma unroll
        for (int i = 0; i < KV_BQ / 4; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

        // dV += P^T dO: 16 queries per k-step, dO MN-major
        pin(dv_acc);
        pin(pa);
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < KV_BQ / 16; ++t)
          Wgmma<DH>::rs(dv_acc, pa + 4 * t, mnmajor_desc<DH>(do_addr, KV_BQ, t));
        wgmma_commit();
        wgmma_wait<1>();  // dP^T (dV may still run)
        pin(dp);

        // dS^T = P^T o (dP^T - delta)
#pragma unroll
        for (int i = 0; i < KV_BQ / 8; ++i) {
          const float2 dl = *reinterpret_cast<const float2*>(row_delta + 8 * i + cq);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int x = 4 * i + 2 * j;
            dp[x] = s[x] * (dp[x] - dl.x);
            dp[x + 1] = s[x + 1] * (dp[x + 1] - dl.y);
          }
        }
#pragma unroll
        for (int i = 0; i < KV_BQ / 4; ++i) dsa[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);

        // dK += dS^T Q: Q MN-major
        pin(dk_acc);
        pin(dsa);
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < KV_BQ / 16; ++t)
          Wgmma<DH>::rs(dk_acc, dsa + 4 * t, mnmajor_desc<DH>(q_addr, KV_BQ, t));
        wgmma_commit();
        wgmma_wait_all();
        pin(dv_acc);
        pin(dk_acc);
        if (lane == 0) mbar_arrive(bar_empty(stage));
        if (++stage == NST) { stage = 0; phase ^= 1u; }
      }
    }
    // K, V, the key ids and the list of buffer u are read: the producer may refill it
    if (lane == 0) mbar_arrive(kv_empty(u));

    // epilogue: keys past Sk are not stored; a key no query sees stores 0
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int key = kt * KV_BK + r0 + 8 * j;
      if (key < Sk) {
        const size_t at = (((size_t)b * Sk + key) * KH + kh) * DH + cq;
#pragma unroll
        for (int i = 0; i < DH / 8; ++i) {
          *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * i) = __floats2bfloat162_rn(
              dk_acc[4 * i + 2 * j] * scale, dk_acc[4 * i + 2 * j + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * i) =
              __floats2bfloat162_rn(dv_acc[4 * i + 2 * j], dv_acc[4 * i + 2 * j + 1]);
        }
      }
    }
  }
  // both warpgroups ran every stage: warpgroup 1's last hand-on is to 0
  if (wg == 0) named_bar_sync(BAR_TURN, CONSUMERS);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* out, const void* d_out,
           const void* lse, const void* seg_q, const void* seg_k, const void* pos_q,
           const void* pos_k, const void* blk_kv, const void* blk_dq, void* lse2, void* delta,
           void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, int KH, int Sqp, int Skp,
           float scale, int causal, int has_window, int window, int splits, void* part,
           int ctas, void* counter, int pair, cudaStream_t stream) {
  using T = Tiles<DH>;
  if (Sqp % T::PAD_Q || Skp % T::PAD_K) return (int)cudaErrorInvalidValue;
  // the narrow dK/dV kernel runs `ctas` persistent CTAs and hands out items by `counter`
  if (DH <= 64 && (ctas < 1 || counter == nullptr)) return (int)cudaErrorInvalidValue;
  // the GQA group splits over dK/dV CTAs only at dh 256, into fp32 parts
  if (splits < 1 || (H / KH) % splits || (splits > 1 && (DH <= 128 || part == nullptr)))
    return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return ERR_NO_ENCODER;
  // boxes of each kernel's tiles: dK/dV streams Q, dO and holds K, V; dQ the
  // other way round (one K/V map serves both where their key tiles agree)
  CUtensorMap tm_q_kv, tm_do_kv, tm_q_dq, tm_do_dq, tm_k_kv, tm_v_kv, tm_k_dq, tm_v_dq;
  if (!make_map<DH>(enc, &tm_q_kv, q, B, Sq, H, T::KV_BQ) ||
      !make_map<DH>(enc, &tm_do_kv, d_out, B, Sq, H, T::KV_BQ) ||
      !make_map<DH>(enc, &tm_q_dq, q, B, Sq, H, T::DQ_BQ) ||
      !make_map<DH>(enc, &tm_do_dq, d_out, B, Sq, H, T::DQ_BQ) ||
      !make_map<DH>(enc, &tm_k_kv, k, B, Sk, KH, T::KV_BK) ||
      !make_map<DH>(enc, &tm_v_kv, v, B, Sk, KH, T::KV_BK))
    return ERR_ENCODE;
  if constexpr (T::KV_BK == T::DQ_BK) {
    tm_k_dq = tm_k_kv;
    tm_v_dq = tm_v_kv;
  } else if (!make_map<DH>(enc, &tm_k_dq, k, B, Sk, KH, T::DQ_BK) ||
             !make_map<DH>(enc, &tm_v_dq, v, B, Sk, KH, T::DQ_BK)) {
    return ERR_ENCODE;
  }
  const float* l2 = static_cast<const float*>(lse2);
  const float* dl = static_cast<const float*>(delta);
  const int *sq = static_cast<const int*>(seg_q), *sk = static_cast<const int*>(seg_k),
            *pq = static_cast<const int*>(pos_q), *pk = static_cast<const int*>(pos_k);
  const float scale_log2 = scale * LOG2E;

  if constexpr (DH <= 64) {
    // (c'') dQ and the delta pass, then (b'') dK/dV, which reads lse2 and delta
    auto dqk = pair ? bwd_sm90_dq_narrow_kernel<DH, true> : bwd_sm90_dq_narrow_kernel<DH, false>;
    constexpr int q_smem = DqNarrowSmem<DH>::ALLOC;
    cudaError_t err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, q_smem);
    if (err != cudaSuccess) return (int)err;
    const int nQ = Sqp / T::DQ_BQ;
    dqk<<<dim3(H, B, pair ? (nQ + 1) / 2 : nQ), THREADS, q_smem, stream>>>(
        tm_q_dq, tm_do_dq, tm_k_dq, tm_v_dq, static_cast<const __nv_bfloat16*>(out),
        static_cast<const __nv_bfloat16*>(d_out), static_cast<const float*>(lse),
        static_cast<float*>(lse2), static_cast<float*>(delta), sq, sk, pq, pk,
        static_cast<const int8_t*>(blk_dq), static_cast<__nv_bfloat16*>(dq),
        static_cast<int*>(counter), Sq, Sqp, Skp, H, KH, scale, scale_log2, causal, has_window,
        window);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int list_cap = (Sqp / T::KV_BQ + 7) / 8 * 8;  // query tiles, in 16-byte rows
    const int kv_smem = KvNarrowSmem<DH>::alloc(list_cap);
    if (kv_smem > 232448) return (int)cudaErrorInvalidValue;
    auto dkdv = bwd_sm90_dkdv_narrow_kernel<DH>;
    err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
    if (err != cudaSuccess) return (int)err;
    dkdv<<<ctas, THREADS, kv_smem, stream>>>(
        tm_q_kv, tm_do_kv, tm_k_kv, tm_v_kv, l2, dl, sq, sk, pq, pk,
        static_cast<const int8_t*>(blk_kv), static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), static_cast<int*>(counter), B, Sk, Sqp, Skp, H, KH, scale,
        scale_log2, causal, has_window, window, list_cap);
  } else {
    const long long rows = (long long)B * H * Sqp;
    constexpr int rows_per_block = DELTA_THREADS / delta_lanes<DH>();
    bwd_sm90_delta_kernel<DH><<<(unsigned)((rows + rows_per_block - 1) / rows_per_block),
                                DELTA_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(d_out),
        static_cast<const float*>(lse), static_cast<float*>(lse2), static_cast<float*>(delta), Sq,
        Sqp, H, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    constexpr int kv_smem = KvSmem<DH>::ALLOC;
    const int8_t* bkv = static_cast<const int8_t*>(blk_kv);
    __nv_bfloat16 *dk16 = static_cast<__nv_bfloat16*>(dk), *dv16 = static_cast<__nv_bfloat16*>(dv);
    if constexpr (DH > 128) {
      auto dkdv = bwd_sm90_dkdv_split_kernel<DH>;
      err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
      if (err != cudaSuccess) return (int)err;
      float* parts = static_cast<float*>(part);
      dkdv<<<dim3(KH * splits, B, Skp / T::KV_BK), THREADS, kv_smem, stream>>>(
          tm_q_kv, tm_do_kv, tm_k_kv, tm_v_kv, l2, dl, sq, sk, pq, pk, bkv, dk16, dv16, Sk, Sqp,
          Skp, H, KH, scale, scale_log2, causal, has_window, window, splits, parts);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      if (splits > 1) {
        const long long n = (long long)B * Sk * KH * DH;
        const long long blocks = (2 * n / 4 + DELTA_THREADS - 1) / DELTA_THREADS;
        bwd_sm90_kv_sum_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), DELTA_THREADS, 0,
                                 stream>>>(parts, dk16, dv16, n, splits);
      }
    } else {
      auto dkdv = bwd_sm90_dkdv_kernel<DH>;
      err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
      if (err != cudaSuccess) return (int)err;
      dkdv<<<dim3(KH, B, Skp / T::KV_BK), THREADS, kv_smem, stream>>>(
          tm_q_kv, tm_do_kv, tm_k_kv, tm_v_kv, l2, dl, sq, sk, pq, pk, bkv, dk16, dv16, Sk, Sqp,
          Skp, H, KH, scale, scale_log2, causal, has_window, window);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    auto dqk = bwd_sm90_dq_kernel<DH>;
    constexpr int q_smem = DqSmem<DH>::ALLOC;
    err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, q_smem);
    if (err != cudaSuccess) return (int)err;
    dqk<<<dim3(H, B, Sqp / T::DQ_BQ), THREADS, q_smem, stream>>>(
        tm_q_dq, tm_do_dq, tm_k_dq, tm_v_dq, l2, dl, sq, sk, pq, pk,
        static_cast<const int8_t*>(blk_dq), static_cast<__nv_bfloat16*>(dq), Sq, Sqp, Skp, H, KH,
        scale, scale_log2, causal, has_window, window);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile sizes at a head width, so the wrapper builds each kernel's tile map
// at its own tiles: dK/dV (query rows streamed, keys per CTA), then dQ (rows
// per CTA, keys streamed).
#define PFA_TILE(NAME, FIELD)                                                 \
  int packed_flash_attn_bwd_sm90_##NAME(int head_dim) {                      \
    return head_dim == 256 ? Tiles<256>::FIELD                               \
           : head_dim <= 64 ? Tiles<64>::FIELD                               \
                            : Tiles<128>::FIELD;                             \
  }
PFA_TILE(block_q, KV_BQ)
PFA_TILE(block_k, KV_BK)
PFA_TILE(dq_block_q, DQ_BQ)
PFA_TILE(dq_block_k, DQ_BK)
#undef PFA_TILE

// bf16 q, out, d_out, dq (B,Sq,H,dh); k, v, dk, dv (B,Sk,KH,dh). lse is the
// forward's fp32 (B,H,Sq) row log-sum-exp of the scaled scores, +inf on rows
// with no visible key. seg/pos are int32 padded with zeros to (B, Sqp) and
// (B, Skp), multiples of 128 (Sqp of 64 at dh <= 64, Skp of 64 at dh 256).
// blk_kv is the int8 tile map at the dK/dV tiles, (B, Sqp/64, Skp/128)
// (Skp/64 at dh 256), and blk_dq the map at the dQ tiles, (B, Sqp/128,
// Skp/128) (Sqp/64 at dh <= 64, Skp/32 at dh 256): 0 skip, 1 mask, 2 all
// visible. lse2 and delta are fp32 (B,H,Sqp) scratch, written here. kv_splits
// (1 below dh 256) divides the GQA group H / KH over that many dK/dV CTAs;
// when it is more than 1, kv_part is fp32 (kv_splits, 2, B, Sk, KH, dh)
// scratch for their parts of dk and dv. ctas (read at dh <= 64 only, at least
// 1) is the number of persistent dK/dV CTAs, counter (there only) an int32
// scratch they hand out their items by, and pair (there only) 1 to run the
// dQ kernel on two map rows a CTA, 0 on one. Launches three kernels on
// `stream` (four with splits, two at dh <= 64); returns 0, a cudaError_t, or
// a negative code of this file (see the error string).
int packed_flash_attn_bwd_sm90_launch(int head_dim, const void* q, const void* k, const void* v,
                                      const void* out, const void* d_out, const void* lse,
                                      const void* seg_q, const void* seg_k, const void* pos_q,
                                      const void* pos_k, const void* blk_kv, const void* blk_dq,
                                      void* lse2, void* delta, void* dq, void* dk, void* dv,
                                      int B, int Sq, int Sk, int H, int KH, int Sqp, int Skp,
                                      float scale, int causal, int has_window, int window,
                                      int kv_splits, void* kv_part, int ctas, void* counter,
                                      int pair, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PFA_CASE(DH)                                                                           \
  if (head_dim == DH)                                                                          \
    return launch<DH>(q, k, v, out, d_out, lse, seg_q, seg_k, pos_q, pos_k, blk_kv, blk_dq,   \
                      lse2, delta, dq, dk, dv, B, Sq, Sk, H, KH, Sqp, Skp, scale, causal,      \
                      has_window, window, kv_splits, kv_part, ctas, counter, pair, st);
  PFA_CASE(16)
  PFA_CASE(32)
  PFA_CASE(64)
  PFA_CASE(80)
  PFA_CASE(128)
  PFA_CASE(256)
#undef PFA_CASE
  return ERR_HEAD_DIM;
}

const char* packed_flash_attn_bwd_sm90_error_string(int code) { return error_string(code); }

}  // extern "C"
