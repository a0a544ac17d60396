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
// N = dh. dh 256 (gemma3) runs at BK = 64: a 128-key stage would need 64 KB of
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

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* seg_q, const void* seg_k,
           const void* pos_q, const void* pos_k, const void* blk_ok, void* out, void* lse, int B,
           int Sq, int Sk, int H, int KH, int nQ, int nK, float scale, int causal,
           int has_window, int window, cudaStream_t stream) {
  constexpr int BK = Smem<DH>::BK;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return ERR_NO_ENCODER;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map<DH>(enc, &tm_q, q, B, Sq, H, BQ) || !make_map<DH>(enc, &tm_k, k, B, Sk, KH, BK) ||
      !make_map<DH>(enc, &tm_v, v, B, Sk, KH, BK))
    return ERR_ENCODE;
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
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile sizes at a head width, so the wrapper builds `blk_ok` at the
// kernel's own tiles (0: the width is not compiled).
int packed_flash_attn_sm90_block_q(int head_dim) {
  return head_dim == 256 || head_dim <= 128 ? BQ : 0;
}
int packed_flash_attn_sm90_block_k(int head_dim) {
  return head_dim == 256 ? keys_per_tile<256>() : head_dim <= 128 ? keys_per_tile<128>() : 0;
}

// bf16 q (B,Sq,H,dh), k/v (B,Sk,KH,dh), out like q. seg/pos are int32 padded
// with zeros to (B, nQ*128) and (B, nK*BK), BK = 128 (64 at dh 256); blk_ok is (B, nQ, nK) int8
// tile codes (0 skip, 1 mask, 2 all visible). lse, when not null, receives
// the fp32 (B,H,Sq) row log-sum-exp of the scaled scores (+inf on rows with
// no visible key). Returns 0, a cudaError_t, or a negative code of this file
// (see the error string).
int packed_flash_attn_sm90_fwd(int head_dim, const void* q, const void* k, const void* v,
                               const void* seg_q, const void* seg_k,
                               const void* pos_q, const void* pos_k, const void* blk_ok,
                               void* out, void* lse, int B, int Sq, int Sk, int H, int KH, int nQ,
                               int nK, float scale, int causal, int has_window, int window,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PFA_CASE(DH)                                                                         \
  if (head_dim == DH)                                                                        \
    return launch<DH>(q, k, v, seg_q, seg_k, pos_q, pos_k, blk_ok, out, lse, B, Sq, Sk, H, KH, \
                      nQ, nK, scale, causal, has_window, window, st);
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
