// Packed (segment-aware) flash attention, forward, bf16, for Hopper (sm_90a):
// tensor-core products (wgmma) fed by TMA through an mbarrier ring.
//
// Replaces the Pallas TPU kernel `_attn_kernel`, launched by
// `packed_flash_attention` in src/repro/kernels/packed_flash_attn.py, for
// bf16 inputs (fp32 inputs take the SIMT kernel in packed_flash_attn.cu). It
// computes the same function: a key is visible from a query when both carry
// the same nonzero segment id, pos_q >= pos_k (causal) and
// pos_q - pos_k < window (sliding window); GQA maps query head h to kv head
// h * K / H; a row with no visible key returns exactly 0. One numerical
// difference, as in FlashAttention-2/3: the probabilities are rounded to bf16
// before P.V (the TPU kernel keeps them in fp32); Q.K^T, the softmax
// statistics and the P.V sums stay fp32.
//
// Bound on an H100 SXM: operations, 4 * dh flops per visible (query, key)
// pair and head. At the serving shape (B=4, S=2048, H=32, K=8, dh=128,
// causal) that is 137.5 GFLOP, 0.139 ms at the 989 TFLOP/s of the bf16
// tensor cores, against 168 MB of q, k, v and out, 0.050 ms at 3.35 TB/s.
// So both products must run on the tensor cores, and the tensor cores must
// not wait on loads.
//
// Design. A CTA owns 128 query rows of one (batch, head): two consumer
// warpgroups of 64 rows, plus one producer warp (a warpgroup at dh 256)
// whose elected thread issues every copy. The producer loads the Q tile once
// by TMA, then streams the K and V tiles of BK keys (and the tile's key
// segment ids and positions, by bulk copy) through a ring of STAGES
// shared-memory stages, each with a full and an empty mbarrier; it loads
// only tiles whose code in `blk_ok` is nonzero. Each consumer warpgroup computes S = Q K^T with
// wgmma m64nBKk16 (both operands from shared memory, K-major: dh contiguous),
// masks S in registers where the tile's code is 1 (2 means every pair is
// visible), runs the online softmax on its fp32 accumulator (each row spread
// over the 4 threads of a quad), converts P to bf16 in registers and
// accumulates O += P V with wgmma m64n{dh}k16, P as the register A operand
// and V from shared memory as an MN-major B operand. Then it frees the stage.
// Shared tiles are stored in chunks of the widest of 64, 32 or 16 columns
// that divides dh, under the TMA swizzle of the chunk's row width (128, 64
// or 32 bytes); the wgmma descriptors name the same swizzle. TMA maps are 4-D over
// (dh, heads, S, B), so a box never crosses into the next batch row and keys
// or queries past the sequence are zero-filled. Heavy (late, under the causal
// mask) q-tiles are launched first. The barrier, copy and wgmma helpers are
// in sm90_common.cuh, shared with the backward.
//
// Head widths. dh 16..128 run at BK = 128 keys a tile and one P V product of
// N = dh; dh 16, 32 and 64 (whisper-medium) in the narrow kernel below, at
// 64 query rows a CTA. dh 256 (gemma3) runs at BK = 64: a 128-key stage would need 64 KB of
// Q plus 2 x 2 x 64 KB of K and V, more than the 227 KB of an SM, while 64
// keys need 192 KB; its 64 x 256 fp32 O accumulator (128 registers a thread)
// is filled by two P V products of N = 128, each over two 64-column chunks
// of the V tile. dh 80 (h2o-danube) runs at its own width: its 160-byte rows
// are five 16-column chunks under the 32-byte swizzle (a TMA copy per chunk,
// 20 KB tiles), Q K^T takes 5 k-steps, one from each chunk, and P V is one
// m64n80k16 product a k-step over all five chunks of the V tile (40
// accumulator registers a thread).

#include "sm90_common.cuh"

namespace {

constexpr int BQ = 128;                  // query rows per CTA
template <int DH>
__host__ __device__ constexpr int keys_per_tile() { return DH > 128 ? 64 : 128; }  // keys per K/V tile
constexpr int CONSUMERS = 256;           // two warpgroups of 64 query rows each
// and one producer warp; at dh 256 a producer warpgroup, which hands its
// registers to the consumers by setmaxnreg: ptxas gives a CTA of these
// sizes 168 registers a thread at launch, and the 64 x 256 fp32 O
// accumulator alone takes 128 (at 168 the products spill and serialize).
// 2 x 232 + 40 = 3 x 168.
template <int DH>
__host__ __device__ constexpr int threads_of() { return CONSUMERS + (DH > 128 ? 128 : 32); }
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int STAGES = 2;                // K/V ring depth

template <int DH>
struct Smem {
  static constexpr int BK = keys_per_tile<DH>();
  static constexpr int Q_BYTES = BQ * DH * 2;
  static constexpr int KV_BYTES = BK * DH * 2;      // one K (or V) tile
  static constexpr int KV = Q_BYTES;                // stage s: K, then V
  static constexpr int META = KV + STAGES * 2 * KV_BYTES;  // stage s: seg_k[BK], pos_k[BK]
  static constexpr int META_BYTES = 2 * BK * 4;
  static constexpr int BAR = META + STAGES * META_BYTES;   // q_full, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8;
  static constexpr int ALLOC = BYTES + 1024;  // slack to align the base to 1024 bytes
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "swizzle atoms need 1024-byte alignment");
};

template <int DH>
__global__ void __launch_bounds__(threads_of<DH>(), 1)
packed_flash_attn_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                              const int* __restrict__ pos_q, const int* __restrict__ pos_k,
                              const int8_t* __restrict__ blk_ok, __nv_bfloat16* __restrict__ out,
                              float* __restrict__ lse, int Sq, int H, int KH, int nQ, int nK,
                              float scale_log2, int causal, int has_window, int window) {
  using C = Chunking<DH>;
  using M = Smem<DH>;
  constexpr int BK = M::BK;
  constexpr int ON = DH < 128 ? DH : 128;  // N of one P V product
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + M::BAR;
  auto bar_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_empty = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = nQ - 1 - (int)blockIdx.z;  // heavy causal q-tiles first
  const int kh = h * KH / H;
  const int q0 = qt * BQ;
  const int8_t* codes = blk_ok + ((size_t)b * nQ + qt) * nK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), CONSUMERS / 32);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: one thread issues every copy
    if constexpr (DH > 128) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS) {
      mbar_expect_tx(bar_q, M::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::NCH; ++c)
        tma_load_4d(base + c * BQ * C::SW, &tm_q, bar_q, c * C::CW, h, q0, b);
      const size_t krow = (size_t)b * nK * BK;  // padded seg/pos rows
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < nK; ++kt) {
        if (!codes[kt]) continue;
        mbar_wait(bar_empty(stage), phase ^ 1u);
        const uint32_t full = bar_full(stage);
        mbar_expect_tx(full, 2 * M::KV_BYTES + M::META_BYTES);
        const uint32_t kdst = base + M::KV + stage * 2 * M::KV_BYTES;
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          tma_load_4d(kdst + c * BK * C::SW, &tm_k, full, c * C::CW, kh, kt * BK, b);
          tma_load_4d(kdst + M::KV_BYTES + c * BK * C::SW, &tm_v, full, c * C::CW, kh, kt * BK, b);
        }
        const uint32_t meta = base + M::META + stage * M::META_BYTES;
        bulk_load(meta, seg_k + krow + (size_t)kt * BK, BK * 4, full);
        bulk_load(meta + BK * 4, pos_k + krow + (size_t)kt * BK, BK * 4, full);
        if (++stage == STAGES) { stage = 0; phase ^= 1u; }
      }
    }
    return;
  }
  if constexpr (DH > 128) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the q-tile; this
  // thread holds rows r0 and r0 + 8 of them
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = 64 * wg + 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);  // first of the thread's two columns in each 8-column group
  int sq[2], pq[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const size_t i = (size_t)b * nQ * BQ + q0 + r0 + 8 * j;  // padded: always in range
    sq[j] = seg_q[i];
    pq[j] = pos_q[i];
  }
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const uint32_t q_addr = base + wg * 64 * C::SW;
  mbar_wait(bar_q, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < nK; ++kt) {
    const int code = codes[kt];
    if (!code) continue;
    mbar_wait(bar_full(stage), phase);
    const uint32_t k_addr = base + M::KV + stage * 2 * M::KV_BYTES;
    const uint32_t v_addr = k_addr + M::KV_BYTES;

    // S = Q K^T: dh / 16 k-steps, each 32 bytes further along a chunk row
    float s[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      Wgmma<BK>::ss(s, kmajor_desc<DH>(q_addr, BQ, kk), kmajor_desc<DH>(k_addr, BK, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(s);

    if (code == 1) {  // mask: segment, causal, window
      const int* seg_s = reinterpret_cast<const int*>(smem + M::META + stage * M::META_BYTES);
      const int* pos_s = seg_s + BK;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const int2 sk = *reinterpret_cast<const int2*>(seg_s + 8 * i + cq);
        const int2 pk = *reinterpret_cast<const int2*>(pos_s + 8 * i + cq);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          bool v0 = sq[j] == sk.x && sq[j] != 0, v1 = sq[j] == sk.y && sq[j] != 0;
          if (causal) { v0 = v0 && pq[j] >= pk.x; v1 = v1 && pq[j] >= pk.y; }
          if (has_window) { v0 = v0 && pq[j] - pk.x < window; v1 = v1 && pq[j] - pk.y < window; }
          if (!v0) s[4 * i + 2 * j] = -INFINITY;
          if (!v1) s[4 * i + 2 * j + 1] = -INFINITY;
        }
      }
    }

    // online softmax per row (in units of log2, scale folded into exp2)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
        mx = fmaxf(mx, fmaxf(s[4 * i + 2 * j], s[4 * i + 2 * j + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[j], mx);
      const bool none = m_new == -INFINITY;  // nothing visible in this row yet
      const float corr = none ? 1.f : exp2f((m[j] - m_new) * scale_log2);
      const float ms = none ? 0.f : m_new * scale_log2;
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(fmaf(s[4 * i + 2 * j + e], scale_log2, -ms));
          s[4 * i + 2 * j + e] = p;
          rs += p;
        }
      l[j] = l[j] * corr + rs;
      m[j] = m_new;
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) {
        o[4 * i + 2 * j] *= corr;
        o[4 * i + 2 * j + 1] *= corr;
      }
    }

    // P to bf16 in the register layout of the wgmma A operand: k-step t
    // (keys 16t .. 16t + 15) reads p[4t .. 4t + 3]
    uint32_t p[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

    // O += P V: V is MN-major (dh contiguous); 16 keys per k-step. Product n
    // fills O's columns ON n .. ON n + ON - 1: accumulator registers
    // ON n / 2 on, from the V chunks that hold those columns.
    pin(o);
    pin(p);
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < DH / ON; ++n)
#pragma unroll
      for (int t = 0; t < BK / 16; ++t)
        Wgmma<ON>::rs(*reinterpret_cast<float(*)[ON / 2]>(o + n * ON / 2), p + 4 * t,
                      mnmajor_desc<DH>(v_addr + n * (ON / C::CW) * BK * C::SW, BK, t));
    wgmma_commit();
    wgmma_wait_all();
    pin(o);
    if (lane == 0) mbar_arrive(bar_empty(stage));
    if (++stage == STAGES) { stage = 0; phase ^= 1u; }
  }

  // epilogue: O / l, exactly 0 where no key was visible; the row
  // log-sum-exp of the scaled scores for the backward, +inf where no key is
  // visible (so that exp(s - lse) is exactly 0 there)
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float lt = l[j];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
    const int row = q0 + r0 + 8 * j;
    if (row < Sq) {
      __nv_bfloat16* orow = out + (((size_t)b * Sq + row) * H + h) * DH + cq;
#pragma unroll
      for (int i = 0; i < DH / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
            __floats2bfloat162_rn(o[4 * i + 2 * j] * inv, o[4 * i + 2 * j + 1] * inv);
      if (lse != nullptr && (lane & 3) == 0)
        lse[((size_t)b * H + h) * Sq + row] =
            lt > 0.f ? (m[j] * scale_log2 + log2f(lt)) * LN2 : INFINITY;
    }
  }
}

// Narrow heads (dh <= 64: whisper-medium's 64, and 16, 32). At these widths a
// 128-row CTA does little work for its fixed chain (barrier set-up, the Q
// copy, the first stage, the epilogue), and a short prompt fills half of it
// with padding rows (whisper serving's 64-token cross-attention: 64 CTAs of
// which half the rows are padding, each walking 12 key tiles alone). The
// tile map is at 64 query rows, and a CTA runs in one of two modes, which
// the wrapper picks by the grid (`fwd_pair`):
//   split (small grids): a CTA owns one 64-row map row, and its two consumer
//     warpgroups take the row's visible key tiles in turn (warpgroup 0 the
//     even ones, 1 the odd ones), each with its own fp32 (m, l, O) over the
//     same rows; at the end warpgroup 1 hands its state to warpgroup 0
//     through shared memory, which merges the two softmaxes and stores. The
//     grid doubles, a prompt of 64 pays for no padding rows, and each
//     warpgroup walks half the tiles.
//   pair (grids of two waves or more of 128-row CTAs): a CTA owns two map
//     rows, one a warpgroup, as the 128-row kernel does, and streams the
//     key tiles either row needs; each K/V tile then serves 128 rows, where
//     split mode reads it from L2 once for every 64 (whisper's 4 x 1500
//     encoder ran 12% slower split than at 128 rows). A warpgroup skips the
//     products of a tile its own row does not need.
// The ring holds NARROW_STAGES stages. In split mode the visible tile of
// index i goes to stage i % NARROW_STAGES and warpgroup i % 2; in pair mode
// both warpgroups consume every stage.
constexpr int NARROW_BQ = 64;
constexpr int NARROW_STAGES = 4;
// Named barriers (0 is __syncthreads): the (m, l, O) hand-over, and each
// warpgroup's turn to issue its S = Q K^T products (BAR_TURN + wg). The two
// warpgroups issue in turn (ping-pong, as in FlashAttention-3), so one's
// softmax can run while the other's products hold the tensor cores.
constexpr int BAR_MERGE = 1, BAR_TURN = 2;

template <int DH>
struct NarrowSmem {
  static constexpr int BK = keys_per_tile<DH>();
  static constexpr int Q_BYTES = NARROW_BQ * DH * 2;  // one map row's Q (two in pair mode)
  static constexpr int KV_BYTES = BK * DH * 2;
  static constexpr int KV = 2 * Q_BYTES;  // stage s: K, then V
  static constexpr int META = KV + NARROW_STAGES * 2 * KV_BYTES;  // stage s: seg_k[BK], pos_k[BK]
  static constexpr int META_BYTES = 2 * BK * 4;
  // warpgroup 1's O (DH / 2 floats a thread), then its m[2] and l[2]
  static constexpr int MERGE = META + NARROW_STAGES * META_BYTES;
  static constexpr int MERGE_BYTES = 128 * (DH / 2 + 4) * 4;
  static constexpr int BAR = MERGE + MERGE_BYTES;  // q_full, full[STAGES], empty[STAGES]
  static constexpr int ALLOC = BAR + (1 + 2 * NARROW_STAGES) * 8 + 1024;
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "swizzle atoms need 1024-byte alignment");
  static_assert(ALLOC <= 232448, "more shared memory than a CTA can have");
};

// PAIR: pair mode (two map rows a CTA), else split mode; one instance each
template <int DH, bool PAIR>
__global__ void __launch_bounds__(threads_of<DH>(), 1)
packed_flash_attn_sm90_narrow_kernel(const __grid_constant__ CUtensorMap tm_q,
                                     const __grid_constant__ CUtensorMap tm_k,
                                     const __grid_constant__ CUtensorMap tm_v,
                                     const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                                     const int* __restrict__ pos_q, const int* __restrict__ pos_k,
                                     const int8_t* __restrict__ blk_ok,
                                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                                     int Sq, int H, int KH, int nQ, int nK, float scale_log2,
                                     int causal, int has_window, int window) {
  using C = Chunking<DH>;
  using M = NarrowSmem<DH>;
  constexpr int BK = M::BK, BQ = NARROW_BQ, NST = NARROW_STAGES;
  constexpr bool pair = PAIR;
  static_assert(DH <= 64 && C::NCH == 1, "one chunk a row");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + M::BAR;
  auto bar_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_empty = [&](int s) { return bar_q + 8u * (1 + NST + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int ct = (pair ? (nQ + 1) / 2 : nQ) - 1 - (int)blockIdx.z;  // heavy causal tiles first
  const int kh = h * KH / H;
  // the CTA's map rows: mt0 (and, in pair mode, mt0 + 1 if there is one)
  const int mt0 = pair ? 2 * ct : ct;
  const bool two = pair && mt0 + 1 < nQ;
  const int8_t* codes0 = blk_ok + ((size_t)b * nQ + mt0) * nK;
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
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: one thread issues every copy; visible tile i into stage i % NST
    if (tid == CONSUMERS) {
      mbar_expect_tx(bar_q, (two ? 2 : 1) * M::Q_BYTES);
      tma_load_4d(base, &tm_q, bar_q, 0, h, mt0 * BQ, b);
      if (two) tma_load_4d(base + M::Q_BYTES, &tm_q, bar_q, 0, h, (mt0 + 1) * BQ, b);
      const size_t krow = (size_t)b * nK * BK;  // padded seg/pos rows
      int n = 0;
      for (int kt = 0; kt < nK; ++kt) {
        if (!(codes0[kt] | (two ? codes1[kt] : 0))) continue;
        const int stage = n % NST;
        const uint32_t phase = (n / NST) & 1u;
        ++n;
        mbar_wait(bar_empty(stage), phase ^ 1u);
        const uint32_t full = bar_full(stage);
        mbar_expect_tx(full, 2 * M::KV_BYTES + M::META_BYTES);
        const uint32_t kdst = base + M::KV + stage * 2 * M::KV_BYTES;
        tma_load_4d(kdst, &tm_k, full, 0, kh, kt * BK, b);
        tma_load_4d(kdst + M::KV_BYTES, &tm_v, full, 0, kh, kt * BK, b);
        const uint32_t meta = base + M::META + stage * M::META_BYTES;
        bulk_load(meta, seg_k + krow + (size_t)kt * BK, BK * 4, full);
        bulk_load(meta + BK * 4, pos_k + krow + (size_t)kt * BK, BK * 4, full);
      }
    }
    return;
  }

  // consumers: warpgroup wg's map row mt (both hold mt0 in split mode), this
  // thread its rows r0 and r0 + 8; `mine` false for pair mode's missing row
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t128 = tid & 127;
  const int r0 = 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int mt = pair ? mt0 + wg : mt0;
  const bool mine = !pair || wg == 0 || two;
  const int8_t* codes = pair && wg == 1 ? codes1 : codes0;
  const uint32_t q_addr = base + (pair ? wg * M::Q_BYTES : 0);
  int sq[2] = {0, 0}, pq[2] = {0, 0};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (!mine) continue;
    const size_t i = ((size_t)b * nQ + mt) * BQ + r0 + 8 * j;  // padded: in range
    sq[j] = seg_q[i];
    pq[j] = pos_q[i];
  }
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

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
    const uint32_t k_addr = base + M::KV + stage * 2 * M::KV_BYTES;
    const uint32_t v_addr = k_addr + M::KV_BYTES;

    // S = Q K^T: dh / 16 k-steps, issued in this warpgroup's turn
    float s[BK / 2];
    named_bar_sync(BAR_TURN + wg, CONSUMERS);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      Wgmma<BK>::ss(s, kmajor_desc<DH>(q_addr, BQ, kk), kmajor_desc<DH>(k_addr, BK, kk), kk > 0);
    wgmma_commit();
    named_bar_arrive(BAR_TURN + 1 - wg, CONSUMERS);
    wgmma_wait_all();
    pin(s);

    if (code == 1) {  // mask: segment, causal, window
      const int* seg_s = reinterpret_cast<const int*>(smem + M::META + stage * M::META_BYTES);
      const int* pos_s = seg_s + BK;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const int2 sk = *reinterpret_cast<const int2*>(seg_s + 8 * i + cq);
        const int2 pk = *reinterpret_cast<const int2*>(pos_s + 8 * i + cq);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          bool v0 = sq[j] == sk.x && sq[j] != 0, v1 = sq[j] == sk.y && sq[j] != 0;
          if (causal) { v0 = v0 && pq[j] >= pk.x; v1 = v1 && pq[j] >= pk.y; }
          if (has_window) { v0 = v0 && pq[j] - pk.x < window; v1 = v1 && pq[j] - pk.y < window; }
          if (!v0) s[4 * i + 2 * j] = -INFINITY;
          if (!v1) s[4 * i + 2 * j + 1] = -INFINITY;
        }
      }
    }

    // online softmax per row (in units of log2, scale folded into exp2)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
        mx = fmaxf(mx, fmaxf(s[4 * i + 2 * j], s[4 * i + 2 * j + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[j], mx);
      const bool none = m_new == -INFINITY;  // nothing visible in this row yet
      const float corr = none ? 1.f : exp2f((m[j] - m_new) * scale_log2);
      const float ms = none ? 0.f : m_new * scale_log2;
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(fmaf(s[4 * i + 2 * j + e], scale_log2, -ms));
          s[4 * i + 2 * j + e] = p;
          rs += p;
        }
      l[j] = l[j] * corr + rs;
      m[j] = m_new;
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) {
        o[4 * i + 2 * j] *= corr;
        o[4 * i + 2 * j + 1] *= corr;
      }
    }

    uint32_t p[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

    // O += P V: one m64n{dh}k16 product a k-step of 16 keys
    pin(o);
    pin(p);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
      Wgmma<DH>::rs(o, p + 4 * t, mnmajor_desc<DH>(v_addr, BK, t));
    wgmma_commit();
    wgmma_wait_all();
    pin(o);
    if (lane == 0) mbar_arrive(bar_empty(stage));
  }
  // the last hand-on of a turn is taken, so that every arrival on a turn
  // barrier has its wait: in split mode by warpgroup n % 2, whose turn the
  // last tile handed on; in pair mode, where both take every tile, by 0
  if (wg == (pair ? 0 : n & 1)) named_bar_sync(BAR_TURN + wg, CONSUMERS);

  if (!pair) {
    // warpgroup 1 hands its (m, l, O) to warpgroup 0, thread for thread
    // (both hold the same rows and columns), which merges the two softmaxes
    float* mg = reinterpret_cast<float*>(smem + M::MERGE);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) mg[i * 128 + t128] = o[i];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mg[(DH / 2 + j) * 128 + t128] = m[j];
        mg[(DH / 2 + 2 + j) * 128 + t128] = l[j];
      }
      named_bar_arrive(BAR_MERGE, CONSUMERS);
      return;
    }
    named_bar_sync(BAR_MERGE, CONSUMERS);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float m1 = mg[(DH / 2 + j) * 128 + t128], l1 = mg[(DH / 2 + 2 + j) * 128 + t128];
      const float mn = fmaxf(m[j], m1);
      const float c0 = m[j] == -INFINITY ? 0.f : exp2f((m[j] - mn) * scale_log2);
      const float c1 = m1 == -INFINITY ? 0.f : exp2f((m1 - mn) * scale_log2);
      l[j] = l[j] * c0 + l1 * c1;
      m[j] = mn;
#pragma unroll
      for (int i = 0; i < DH / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * i + 2 * j + e;
          o[x] = o[x] * c0 + mg[x * 128 + t128] * c1;
        }
    }
  }
  if (!mine) return;

  // epilogue as in the 128-row kernel
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float lt = l[j];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
    const int row = mt * BQ + r0 + 8 * j;
    if (row < Sq) {
      __nv_bfloat16* orow = out + (((size_t)b * Sq + row) * H + h) * DH + cq;
#pragma unroll
      for (int i = 0; i < DH / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
            __floats2bfloat162_rn(o[4 * i + 2 * j] * inv, o[4 * i + 2 * j + 1] * inv);
      if (lse != nullptr && (lane & 3) == 0)
        lse[((size_t)b * H + h) * Sq + row] =
            lt > 0.f ? (m[j] * scale_log2 + log2f(lt)) * LN2 : INFINITY;
    }
  }
}

template <int DH>
__host__ __device__ constexpr int rows_per_cta() { return DH <= 64 ? NARROW_BQ : BQ; }

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* seg_q, const void* seg_k,
           const void* pos_q, const void* pos_k, const void* blk_ok, void* out, void* lse, int B,
           int Sq, int Sk, int H, int KH, int nQ, int nK, float scale, int causal,
           int has_window, int window, int pair, cudaStream_t stream) {
  constexpr int BK = Smem<DH>::BK;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return ERR_NO_ENCODER;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map<DH>(enc, &tm_q, q, B, Sq, H, rows_per_cta<DH>()) ||
      !make_map<DH>(enc, &tm_k, k, B, Sk, KH, BK) || !make_map<DH>(enc, &tm_v, v, B, Sk, KH, BK))
    return ERR_ENCODE;
  if constexpr (DH <= 64) {
    auto kern = pair ? packed_flash_attn_sm90_narrow_kernel<DH, true>
                     : packed_flash_attn_sm90_narrow_kernel<DH, false>;
    constexpr int smem = NarrowSmem<DH>::ALLOC;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(H, B, pair ? (nQ + 1) / 2 : nQ), threads_of<DH>(), smem, stream>>>(
        tm_q, tm_k, tm_v, static_cast<const int*>(seg_q), static_cast<const int*>(seg_k),
        static_cast<const int*>(pos_q), static_cast<const int*>(pos_k),
        static_cast<const int8_t*>(blk_ok), static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(lse), Sq, H, KH, nQ, nK, scale * LOG2E, causal, has_window, window);
  } else {
    auto kern = packed_flash_attn_sm90_kernel<DH>;
    constexpr int smem = Smem<DH>::ALLOC;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(H, B, nQ);
    kern<<<grid, threads_of<DH>(), smem, stream>>>(
        tm_q, tm_k, tm_v, static_cast<const int*>(seg_q), static_cast<const int*>(seg_k),
        static_cast<const int*>(pos_q), static_cast<const int*>(pos_k),
        static_cast<const int8_t*>(blk_ok), static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(lse), Sq, H, KH, nQ, nK, scale * LOG2E, causal, has_window, window);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile sizes at a head width, so the wrapper builds `blk_ok` at the
// kernel's own tiles (0: the width is not compiled).
int packed_flash_attn_sm90_block_q(int head_dim) {
  return head_dim <= 64 ? rows_per_cta<64>() : head_dim == 256 || head_dim <= 128 ? BQ : 0;
}
int packed_flash_attn_sm90_block_k(int head_dim) {
  return head_dim == 256 ? keys_per_tile<256>() : head_dim <= 128 ? keys_per_tile<128>() : 0;
}

// bf16 q (B,Sq,H,dh), k/v (B,Sk,KH,dh), out like q. seg/pos are int32 padded
// with zeros to (B, nQ*BQ) and (B, nK*BK), BQ = 128 (64 at dh <= 64), BK = 128
// (64 at dh 256); blk_ok is (B, nQ, nK) int8
// tile codes (0 skip, 1 mask, 2 all visible). pair (read at dh <= 64 only):
// 1 runs the narrow kernel's CTAs on two map rows each, 0 on one (split
// mode). lse, when not null, receives
// the fp32 (B,H,Sq) row log-sum-exp of the scaled scores (+inf on rows with
// no visible key). Returns 0, a cudaError_t, or a negative code of this file
// (see the error string).
int packed_flash_attn_sm90_fwd(int head_dim, const void* q, const void* k, const void* v,
                               const void* seg_q, const void* seg_k,
                               const void* pos_q, const void* pos_k, const void* blk_ok,
                               void* out, void* lse, int B, int Sq, int Sk, int H, int KH, int nQ,
                               int nK, float scale, int causal, int has_window, int window,
                               int pair, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PFA_CASE(DH)                                                                         \
  if (head_dim == DH)                                                                        \
    return launch<DH>(q, k, v, seg_q, seg_k, pos_q, pos_k, blk_ok, out, lse, B, Sq, Sk, H, KH, \
                      nQ, nK, scale, causal, has_window, window, pair, st);
  PFA_CASE(16)
  PFA_CASE(32)
  PFA_CASE(64)
  PFA_CASE(80)
  PFA_CASE(128)
  PFA_CASE(256)
#undef PFA_CASE
  return ERR_HEAD_DIM;
}

const char* packed_flash_attn_sm90_error_string(int code) { return error_string(code); }

}  // extern "C"
