// Packed (segment-aware) flash attention, backward, fp32, for Hopper
// (sm_90a): every product in 3xTF32 on the tensor cores (mma.sync), tiles
// copied ahead of use by cp.async.
//
// The gradient of the Pallas TPU kernel `_attn_kernel`
// (src/repro/kernels/packed_flash_attn.py:39, launched by
// `packed_flash_attention`), for fp32 inputs: the fp32 parity path's and
// every fp32 training run's backward. bf16 inputs take
// packed_flash_attn_bwd_sm90.cu. The JAX package has no backward kernel (it
// trains through its jnp attention, which XLA differentiates); this one
// computes the same gradient under the forward kernels' tile skip, so that a
// training micro-batch costs sum(l_i^2) rather than N^2 in its backward too.
// The mask is the forward's exactly: a key is visible from a query when both
// carry the same nonzero segment id, pos_q >= pos_k (causal) and
// pos_q - pos_k < window (sliding window); GQA maps query head h to kv head
// h * K / H. A row with no visible key has lse = +inf from the forward, so
// its probabilities, and its gradients, are exactly 0.
//
// Math (FlashAttention-2), per query head, with S = scale * Q K^T over the
// visible pairs, P = exp(S - lse) recomputed from the forward's row
// log-sum-exp, and delta_i = sum_d dO_id O_id:
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - delta),
//   dQ = scale * dS K,  dK = scale * dS^T Q,
// dK and dV summed over the H / K query heads of a KV head.
//
// Precision. One TF32 product keeps about 11 bits of each operand, which
// misses the fp32 path's 1e-4 gate by 20x (dK 2.4e-3 of max |ref| in a numpy
// emulation at 256 x 128, causal). 3xTF32 (sm90_common.cuh: x = hi + lo,
// a b = alo bhi + ahi blo + ahi bhi) comes within 2x of plain fp32 there. The
// tensor cores' fp32 sums do not round to nearest, so dK and dV, which sum
// over every query of a GQA group (28 672 at qwen2.5's 7 x 4096), reached
// 9e-5 of max |ref| when the accumulator ran across stages; each stage's part
// now starts from zero on the tensor cores and joins the total by fp32 adds
// (3e-6 to 1e-5 on the card at every shape timed). The softmax recomputation
// and dS stay fp32.
//
// Bound on an H100 SXM: operations, 5 products of 2 * dh flops per visible
// (query, key) pair and head. Two ceilings: the 67 TFLOP/s of fp32 outside
// the tensor cores (what the earlier CUDA-core backward answered to), and
// 495 / 3 = 165 TFLOP/s of fp32 products as 3xTF32 on the tensor cores, the
// one this design answers to. At the parity path's 1 x 256 micro-batches
// neither binds: 8 dK/dV CTAs of whole GQA groups would leave 124 of 132
// SMs idle, so the grid and each CTA's latency set the time there.
//
// What the design does about each:
//  - Tensor cores: mma.sync m16n8k8 .tf32, not wgmma. wgmma reads 32-bit
//    operands from shared memory K-major only, so dV += P^T dO, dK += dS^T Q
//    and dQ += dS K would need transposed copies of dO, Q and K, and 3xTF32
//    would double every shared operand (hi and lo planes): a 64 x 128 fp32
//    tile is already 32 KB. mma.sync takes its fragments from registers in
//    any layout, so each thread splits what it reads. P^T and dS^T never
//    leave registers: the accumulating products run transposed (dV^T =
//    dO^T P, dK^T = Q^T dS, dQ^T = K^T dS^T), so that an accumulator of
//    S^T = K Q^T (or S = Q K^T) is their B operand with the reduction index
//    permuted (k slots t and t + 4 hold columns 2t and 2t + 1), which keeps
//    its register pairs in place (as an A operand ptxas copied four
//    registers before every product). Tiles sit in shared memory as fp32
//    rows padded by 4 floats, so every fragment read, along a row or down a
//    column, hits 32 distinct banks. Two warps share 16 rows: warp A forms
//    the scores, warp B dP, and they hand P (and dP) over in shared memory.
//  - Copies: every tile is a cp.async copy issued one stage ahead, into a
//    ring of 2 stages, so a stage's copies overlap the previous one's products.
//  - Filling the card: a CTA walks its row or column of the tile map from a
//    list compacted in shared memory (`Walk`, tf32_common.cuh, which the
//    fp32 forward walks too), which also drops the tiles the map keeps only
//    because its range tests span a document start (a key tile at a
//    boundary of documents passes every query tile of both; such CTAs ran
//    3-5x the median work and set the kernel's time). CTAs launch in
//    key-tile-major order (query-tile-major, late tiles first, for dQ), so
//    that the heavy ones start first, and where a grid holds under four
//    waves the wrapper splits its loop over CTAs (`tf32_splits`): a dK/dV
//    CTA's (GQA head, query tile) iterations, a dQ CTA's key tiles, taken
//    every splits-th from part. Each part stores fp32 partial sums, which (d)
//    adds in part order, so the result stays deterministic.
//
// Kernels, no atomics:
//   (a) delta: one warp per (batch, head, padded row); writes the forward's
//       lse (+inf past Sq) and delta (0 there) to (2, B, H, Sqp) rows
//       padded to whole tiles, so the other kernels copy them unguarded.
//   (b) dK/dV: a CTA owns 64 keys of one (batch, KV head), four warp pairs
//       of 16 keys; K and V stay in shared memory, and Q, dO and the rows'
//       lse, delta, segment ids and positions stream in stages of KV_BQ rows
//       (32; 16 at dh 256) over the GQA group's heads and the query tiles of
//       the walk. Warp A: S^T = K Q^T, P^T, dV^T += dO^T P; warp B: dP^T =
//       V dO^T, dS^T, dK^T += Q^T dS. Registers: a 16 x dh total and a part
//       of it (one CTA an SM from dh 80 on).
//   (c) dQ: a CTA owns 64 query rows of one (batch, head), four warp pairs
//       of 16 rows; Q and dO stay, K and V stream in 16-key stages. Warp A:
//       S = Q K^T and P; warp B: dP = dO V^T; both form dS and each adds its
//       half of dQ's columns, dQ^T += K^T dS^T.
//   (d) sum: out = mul * sum of the parts in order, one launch for dK, dV
//       and dQ, where a loop was split.
// Tile codes: 0 skip, 1 mask per element, 2 every pair visible (no mask).
// Rows and keys past the sequence are zero-filled and carry segment id 0
// (the wrapper pads seg/pos to whole tiles).

#include "tf32_common.cuh"

namespace {

constexpr int STAGES = 2;
constexpr int DELTA_WARPS = 8;
constexpr int SUM_THREADS = 256;
constexpr int PAD_Q = 64, PAD_K = 64;  // what the wrapper pads the ids (and stats) to

// Tiles of a head width: dK/dV (query rows a stage, keys a CTA), dQ (query
// rows a CTA, keys a stage)
template <int DH>
struct Tiles {
  static constexpr int KV_BQ = DH > 128 ? 16 : 32, KV_BK = 64, DQ_BQ = 64, DQ_BK = 16;
  static_assert(PAD_Q % KV_BQ == 0 && PAD_Q % DQ_BQ == 0 && PAD_K % KV_BK == 0 &&
                    PAD_K % DQ_BK == 0,
                "every tile divides the padding");
};

// A fragment of Y^T X (16 x 8): columns c0 .. c0 + 15 of row-major Y as
// its rows, rows r0 .. r0 + 7 of Y its reduction, permuted: k slot t is
// row r0 + 2t, slot t + 4 row r0 + 2t + 1
template <int LD>
__device__ __forceinline__ void frag_a_t(const float* tile, int r0, int c0, uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  const float* p = tile + (r0 + 2 * lane_t()) * LD + c0 + lane_g();
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8], hi[1], lo[1]);
  split_tf32(p[LD], hi[2], lo[2]);
  split_tf32(p[LD + 8], hi[3], lo[3]);
}

// An accumulator n-tile (columns 2t, 2t + 1 of rows g and g + 8) as the two
// B fragments of its transpose, rows g (h = 0) and g + 8 (h = 1) as the
// product's columns and its columns the reduction, permuted as in
// `frag_a_t`: already in register order, so no copy precedes the product.
__device__ __forceinline__ void frag_b_acc(const float (&c)[4], int h, uint32_t (&hi)[2],
                                           uint32_t (&lo)[2]) {
  split_tf32(c[2 * h], hi[0], lo[0]);
  split_tf32(c[2 * h + 1], hi[1], lo[1]);
}

// A warp pair owns 16 rows (keys of the dK/dV kernel, queries of the dQ
// kernel): warp A (warps 0 .. GROUPS - 1) forms the scores and P, its
// partner B (GROUPS more) dP, and shared memory hands P (and dP) across.
template <int DH>
struct KvCfg : Tiles<DH> {
  using Tiles<DH>::KV_BQ;
  using Tiles<DH>::KV_BK;
  static constexpr int GROUPS = KV_BK / 16;
  static constexpr int THREADS = 2 * GROUPS * 32;
  static constexpr int LD = DH + PAD;
  static constexpr int MT = DH / 16;             // m-tiles of dV^T (warp A) or dK^T (warp B)
  // m-tiles a stage's part holds at once (at dh 256 the total alone is 128 registers)
  static constexpr int MC = DH > 128 ? 2 : MT % 4 == 0 ? 4 : MT;
  static constexpr int KT = KV_BK * LD;          // floats of the K (or V) tile
  static constexpr int QT = KV_BQ * LD;          // floats of a Q (or dO) tile
  static constexpr int STAGE = 2 * QT + 4 * KV_BQ;  // Q, dO, lse, delta, seg, pos
  static constexpr int XCH = GROUPS * 16 * KV_BQ;   // P^T, A to B
  static constexpr int BYTES = (2 * KT + STAGES * STAGE + XCH + WALK) * 4;
  // registers: a total and a part; at dh 64 two CTAs an SM (128 registers)
  // spilled 16 bytes, one takes 166
  static constexpr int MIN_CTAS = DH >= 64 ? 1 : 2;
  static_assert(BYTES <= 232448, "more shared memory than a CTA can have");
};

template <int DH>
struct DqCfg : Tiles<DH> {
  using Tiles<DH>::DQ_BQ;
  using Tiles<DH>::DQ_BK;
  static constexpr int GROUPS = DQ_BQ / 16;
  static constexpr int THREADS = 2 * GROUPS * 32;
  static constexpr int LD = DH + PAD;
  static constexpr int MT = DH / 16;             // m-tiles of dQ^T
  static constexpr int MH = (MT + 1) / 2;        // of them warp A's (B has the rest)
  static constexpr int QT = DQ_BQ * LD;
  static constexpr int KT = DQ_BK * LD;
  static constexpr int STAGE = 2 * KT + 2 * DQ_BK;  // K, V, seg, pos
  static constexpr int XCH = 2 * GROUPS * 16 * DQ_BK;  // P from A, dP from B
  static constexpr int BYTES = (2 * QT + STAGES * STAGE + XCH + WALK) * 4;
  static constexpr int MIN_CTAS = DH > 128 ? 1 : 2;
  static_assert(BYTES <= 232448, "more shared memory than a CTA can have");
};

// (a) lse and delta over padded rows: stats[0][b, h, s] = lse (+inf past
// Sq), stats[1][b, h, s] = sum_d dO O (0 past Sq); one warp a row
template <int DH>
__global__ void __launch_bounds__(DELTA_WARPS * 32)
bwd_tf32_delta_kernel(const float* __restrict__ out, const float* __restrict__ d_out,
                      const float* __restrict__ lse, float* __restrict__ stats, int Sq, int Sqp,
                      int H, long long rows) {
  const long long row = (long long)blockIdx.x * DELTA_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform over the warp
  const int lane = threadIdx.x & 31;
  const int s = (int)(row % Sqp);
  const long long bh = row / Sqp;  // b * H + h
  float acc = 0.f;
  if (s < Sq) {
    const size_t base = (((size_t)(bh / H) * Sq + s) * H + bh % H) * DH;
    for (int d = lane; d < DH; d += 32) acc = fmaf(out[base + d], d_out[base + d], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    stats[row] = s < Sq ? lse[bh * Sq + s] : INFINITY;
    stats[rows + row] = acc;
  }
}

// acc += (X Y[rows])^T for the n-tiles J0 .. J1 - 1 of X: X an
// accumulator (16 rows x 8 SN columns, its columns the reduction), Y
// row-major padded (its rows 8j .. 8j + 7 the reduction). acc[m][h] holds
// output rows (Y's columns) 16 (m0 + m) + g (+ 8) and columns (X's rows)
// 8h + 2t (+ 1); m0 is a constant once the caller's loop is unrolled.
template <int LD, int J0, int J1, int SN, int MT>
__device__ __forceinline__ void accumulate_t(const float (&x)[SN][4], const float* Y,
                                             float (&acc)[MT][2][4], int m0 = 0,
                                             int m_end = 1 << 30) {
#pragma unroll
  for (int j = J0; j < J1; ++j) {
    uint32_t bh[2][2], bl[2][2];
    frag_b_acc(x[j], 0, bh[0], bl[0]);
    frag_b_acc(x[j], 1, bh[1], bl[1]);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m0 + m >= m_end) break;  // uniform over the warp
      uint32_t ah[4], al[4];
      frag_a_t<LD>(Y, 8 * j, 16 * (m0 + m), ah, al);
      mma_3xtf32(acc[m][0], ah, al, bh[0], bl[0]);
      mma_3xtf32(acc[m][1], ah, al, bh[1], bl[1]);
    }
  }
}

// Store acc (as `accumulate_t` leaves it, from m-tile m0, below m_end)
// times mul: output row d of column r goes to out[r * stride + d], for rows
// r0 + r below `limit`.
template <int MT>
__device__ __forceinline__ void store_t(const float (&acc)[MT][2][4], float* out, size_t stride,
                                        int r0, int limit, float mul, int m0 = 0,
                                        int m_end = 1 << 30) {
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * h + 2 * t + (e & 1);
      if (r >= limit) continue;
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m0 + m < m_end) out[(size_t)r * stride + 16 * (m0 + m) + g + 8 * (e >> 1)] = acc[m][h][e] * mul;
    }
}

// (b) dK, dV of one key tile of one KV head (or a part of them, over every
// splits-th of its iterations). Warp A of a pair forms S^T = K Q^T, P^T
// (to shared memory) and dV += P^T dO; warp B dP^T = V dO^T, then
// dS^T = P^T o (dP^T - delta) and dK += dS^T Q.
template <int DH>
__global__ void __launch_bounds__(KvCfg<DH>::THREADS, KvCfg<DH>::MIN_CTAS)
bwd_tf32_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ d_out,
                     const float* __restrict__ stats, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_k, const int* __restrict__ pos_q,
                     const int* __restrict__ pos_k, const int8_t* __restrict__ blk,
                     float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ part,
                     int B, int Sq, int Sk, int H, int KH, int Sqp, int Skp, int splits,
                     float scale, int causal, int has_window, int window) {
  using C = KvCfg<DH>;
  constexpr int KV_BQ = C::KV_BQ, KV_BK = C::KV_BK;
  constexpr int SN = KV_BQ / 8;  // n-tiles of S^T
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = smem + C::KT;
  float* ring = smem + 2 * C::KT;

  // CTAs in key-tile-major order (parts, then heads, then batch rows fastest):
  // the early key tiles of a packed row, which see the most queries, start first
  const int pi = blockIdx.x % splits, kh = blockIdx.x / splits % KH;
  const int b = blockIdx.x / splits / KH % B, kt = blockIdx.x / splits / KH / B;
  const int warp = threadIdx.x >> 5, g = lane_g(), t = lane_t();
  const int kg = warp % C::GROUPS;
  const bool first = warp < C::GROUPS;  // warp A of its pair
  float* xch = ring + STAGES * C::STAGE + kg * 16 * KV_BQ;  // the pair's P^T
  WalkMem* wm = reinterpret_cast<WalkMem*>(ring + STAGES * C::STAGE + C::XCH);
  const int group = H / KH, nQ = Sqp / KV_BQ, nK = Skp / KV_BK;
  // this key tile's column of the map, over the group's heads
  if (threadIdx.x == 0)
    wm->set(blk + (size_t)b * nQ * nK + kt, seg_q, pos_q, (size_t)b * Sqp, nK, nQ, group, splits,
            pi, causal, has_window, window);
  // the walk's fields are set before any thread reads them (this barrier
  // after the copies and the summary spilled 16 bytes at head_dim 256)
  __syncthreads();
  Walk<C::THREADS, KV_BQ, true> walk{wm};
  const size_t qstride = (size_t)H * DH, kstride = (size_t)KH * DH;
  const size_t nstat = (size_t)B * H * Sqp;
  auto load_stage = [&](int rep, int qt, int st) {
    float* base = ring + st * C::STAGE;
    const int h = kh * group + rep, q0 = qt * KV_BQ;
    const size_t off = (size_t)b * Sq * qstride + (size_t)h * DH;
    load_rows<DH, KV_BQ, C::THREADS>(base, q + off, q0, Sq, qstride);
    load_rows<DH, KV_BQ, C::THREADS>(base + C::QT, d_out + off, q0, Sq, qstride);
    float* meta = base + 2 * C::QT;
    const size_t row = ((size_t)b * H + h) * Sqp + q0;
    constexpr int W = KV_BQ / 4;  // threads a metadata row
    load_words<KV_BQ, C::THREADS>(meta, stats + row, 0);
    load_words<KV_BQ, C::THREADS>(meta + KV_BQ, stats + nstat + row, W);
    load_words<KV_BQ, C::THREADS>(meta + 2 * KV_BQ, seg_q + (size_t)b * Sqp + q0, 2 * W);
    load_words<KV_BQ, C::THREADS>(meta + 3 * KV_BQ, pos_q + (size_t)b * Sqp + q0, 3 * W);
  };

  const size_t koff = (size_t)b * Sk * kstride + (size_t)kh * DH;
  // K and V are issued after the walk's first refill (faster at the parity
  // shape), but first at head_dim 256, where that order spilled 8 bytes
  auto load_kv = [&] {
    load_rows<DH, KV_BK, C::THREADS>(Ks, k + koff, kt * KV_BK, Sk, kstride);
    load_rows<DH, KV_BK, C::THREADS>(Vs, v + koff, kt * KV_BK, Sk, kstride);
  };
  if constexpr (DH > 128) load_kv();
  if (warp == 0) summarise<KV_BK>(seg_k, pos_k, (size_t)b * Skp + kt * KV_BK, &wm->sum);
  int rep, qt, code, nrep, nqt, ncode;
  bool have = walk.next(rep, qt, code);
  if constexpr (DH <= 128) load_kv();
  if (have) load_stage(rep, qt, 0);
  cp_async_commit();
  bool nhave = have && walk.next(nrep, nqt, ncode);
  if (nhave) load_stage(nrep, nqt, 1);
  cp_async_commit();

  // this thread's keys: 16 kg + g and 16 kg + g + 8 of the tile
  int skey[2], pkey[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t i = (size_t)b * Skp + kt * KV_BK + 16 * kg + g + 8 * r;
    skey[r] = seg_k[i];
    pkey[r] = pos_k[i];
  }

  float acc[C::MT][2][4];  // dV^T (warp A) or dK^T (warp B)
#pragma unroll
  for (int m = 0; m < C::MT; ++m)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[m][e / 4][e % 4] = 0.f;

  for (int it = 0; have; ++it) {
    cp_async_wait<1>();
    __syncthreads();
    const float* Qs = ring + (it & 1) * C::STAGE;
    const float* dOs = Qs + C::QT;
    const float* lse_r = Qs + 2 * C::QT;
    const float* del_r = lse_r + KV_BQ;
    const int* sq_r = reinterpret_cast<const int*>(lse_r + 2 * KV_BQ);
    const int* pq_r = sq_r + KV_BQ;

    // A: S^T = K Q^T; B: dP^T = V dO^T. Element e of n-tile j is key
    // g + 8 (e / 2), query 8j + 2t + e % 2.
    float x[SN][4];
    scores<DH, C::LD, SN>(first ? Ks : Vs, 16 * kg, first ? Qs : dOs, x);
    if (first) {  // P^T, handed to B
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * j + 2 * t + (e & 1), kr = e >> 1;
          const bool vis = code == 2 || visible(sq_r[r], pq_r[r], skey[kr], pkey[kr], causal,
                                                has_window, window);
          x[j][e] = vis ? expf(fmaf(x[j][e], scale, -lse_r[r])) : 0.f;
        }
      put<SN>(xch, x);
    }
    __syncthreads();
    if (!first) {  // dS^T = P^T o (dP^T - delta)
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[j][e] = xch[(4 * j + e) * 32 + (threadIdx.x & 31)] *
                    (x[j][e] - del_r[8 * j + 2 * t + (e & 1)]);
    }
    // A: dV^T += dO^T P; B: dK^T += Q^T dS, this stage's part on the tensor
    // cores, then into the total by fp32 adds (the tensor cores' fp32 sums
    // do not round to nearest, and their error would grow with the stages),
    // MC m-tiles at a time
#pragma unroll
    for (int m0 = 0; m0 < C::MT; m0 += C::MC) {
      float part[C::MC][2][4];
#pragma unroll
      for (int m = 0; m < C::MC; ++m)
#pragma unroll
        for (int e = 0; e < 8; ++e) part[m][e / 4][e % 4] = 0.f;
      accumulate_t<C::LD, 0, SN>(x, first ? dOs : Qs, part, m0);
#pragma unroll
      for (int m = 0; m < C::MC; ++m)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[m0 + m][e / 4][e % 4] += part[m][e / 4][e % 4];
    }
    __syncthreads();  // every warp is done with this stage and the hand-over
    have = nhave, rep = nrep, qt = nqt, code = ncode;
    nhave = have && walk.next(nrep, nqt, ncode);
    if (nhave) load_stage(nrep, nqt, it & 1);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // a split stores unscaled parts (splits, 2, B, Sk, KH, DH) for (d)
  const size_t nkv = (size_t)B * Sk * kstride;
  float* out = splits > 1 ? part + ((size_t)pi * 2 + first) * nkv : first ? dv : dk;
  const float mul = first || splits > 1 ? 1.f : scale;
  store_t<C::MT>(acc, out + koff, kstride, kt * KV_BK + 16 * kg, Sk, mul);
}

// (c) dQ of one query tile of one head (or a part, over every splits-th of
// its key tiles). Warp A of a pair forms S = Q K^T and P, warp B dP = dO V^T;
// each hands its tile to the other, both form dS = P o (dP - delta), and
// each accumulates its half of dQ's columns (as dQ^T += K^T dS^T).
template <int DH>
__global__ void __launch_bounds__(DqCfg<DH>::THREADS, DqCfg<DH>::MIN_CTAS)
bwd_tf32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ d_out,
                   const float* __restrict__ stats, const int* __restrict__ seg_q,
                   const int* __restrict__ seg_k, const int* __restrict__ pos_q,
                   const int* __restrict__ pos_k, const int8_t* __restrict__ blk,
                   float* __restrict__ dq, float* __restrict__ part, int B, int Sq, int Sk, int H,
                   int KH, int Sqp, int Skp, int splits, float scale, int causal,
                   int has_window, int window) {
  using C = DqCfg<DH>;
  constexpr int DQ_BQ = C::DQ_BQ, DQ_BK = C::DQ_BK;
  constexpr int SN = DQ_BK / 8;  // n-tiles of S
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = smem + C::QT;
  float* ring = smem + 2 * C::QT;

  const int nQ = Sqp / DQ_BQ, nK = Skp / DQ_BK;
  // CTAs in query-tile-major order, late (heavy) query tiles first
  const int pi = blockIdx.x % splits, h = blockIdx.x / splits % H;
  const int b = blockIdx.x / splits / H % B, qt = nQ - 1 - (int)(blockIdx.x / splits / H / B);
  const int kh = h * KH / H;
  const int warp = threadIdx.x >> 5, g = lane_g(), t = lane_t();
  const int rg = warp % C::GROUPS;
  const bool first = warp < C::GROUPS;  // warp A of its pair
  float* xch = ring + STAGES * C::STAGE;
  float* mine = xch + (first ? 0 : C::GROUPS) * 16 * DQ_BK + rg * 16 * DQ_BK;
  const float* theirs = xch + (first ? C::GROUPS : 0) * 16 * DQ_BK + rg * 16 * DQ_BK;
  // this query tile's row of the map
  WalkMem* wm = reinterpret_cast<WalkMem*>(xch + C::XCH);
  if (threadIdx.x == 0)
    wm->set(blk + ((size_t)b * nQ + qt) * nK, seg_k, pos_k, (size_t)b * Skp, 1, nK, 1, splits,
            pi, causal, has_window, window);
  Walk<C::THREADS, DQ_BK, false> walk{wm};
  const size_t qstride = (size_t)H * DH, kstride = (size_t)KH * DH;
  const size_t koff = (size_t)b * Sk * kstride + (size_t)kh * DH;
  auto load_stage = [&](int i, int st) {
    float* base = ring + st * C::STAGE;
    load_rows<DH, DQ_BK, C::THREADS>(base, k + koff, i * DQ_BK, Sk, kstride);
    load_rows<DH, DQ_BK, C::THREADS>(base + C::KT, v + koff, i * DQ_BK, Sk, kstride);
    const size_t key = (size_t)b * Skp + i * DQ_BK;
    load_words<DQ_BK, C::THREADS>(base + 2 * C::KT, seg_k + key, 0);
    load_words<DQ_BK, C::THREADS>(base + 2 * C::KT + DQ_BK, pos_k + key, DQ_BK / 4);
  };

  const int q0 = qt * DQ_BQ;
  const size_t qoff = (size_t)b * Sq * qstride + (size_t)h * DH;
  if (warp == 0) summarise<DQ_BQ>(seg_q, pos_q, (size_t)b * Sqp + q0, &wm->sum);
  __syncthreads();  // the walk's fields and summary are set before any thread reads them
  int rep, kt, code, nrep, nkt, ncode;
  bool have = walk.next(rep, kt, code);
  load_rows<DH, DQ_BQ, C::THREADS>(Qs, q + qoff, q0, Sq, qstride);
  load_rows<DH, DQ_BQ, C::THREADS>(dOs, d_out + qoff, q0, Sq, qstride);
  if (have) load_stage(kt, 0);
  cp_async_commit();
  bool nhave = have && walk.next(nrep, nkt, ncode);
  if (nhave) load_stage(nkt, 1);
  cp_async_commit();

  // this thread's rows: 16 rg + g and 16 rg + g + 8 of the tile
  int srow[2], prow[2];
  float lrow[2], drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = q0 + 16 * rg + g + 8 * r;
    srow[r] = seg_q[(size_t)b * Sqp + s];
    prow[r] = pos_q[(size_t)b * Sqp + s];
    const size_t i = ((size_t)b * H + h) * Sqp + s;
    lrow[r] = stats[i];
    drow[r] = stats[(size_t)B * H * Sqp + i];
  }

  float acc[C::MH][2][4];  // dQ^T's first MH m-tiles (A) or the rest (B)
  const int m0 = first ? 0 : C::MH, m_end = first ? C::MH : C::MT;
#pragma unroll
  for (int m = 0; m < C::MH; ++m)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[m][e / 4][e % 4] = 0.f;

  for (int it = 0; have; ++it) {
    cp_async_wait<1>();
    __syncthreads();
    const float* Ks = ring + (it & 1) * C::STAGE;
    const float* Vs = Ks + C::KT;
    const int* sk = reinterpret_cast<const int*>(Ks + 2 * C::KT);
    const int* pk = sk + DQ_BK;

    // A: S = Q K^T, then P; B: dP = dO V^T. Element e of n-tile j is row
    // g + 8 (e / 2), key 8j + 2t + e % 2.
    float x[SN][4];
    scores<DH, C::LD, SN>(first ? Qs : dOs, 16 * rg, first ? Ks : Vs, x);
    if (first) {
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1), r = e >> 1;
          const bool vis =
              code == 2 || visible(srow[r], prow[r], sk[c], pk[c], causal, has_window, window);
          x[j][e] = vis ? expf(fmaf(x[j][e], scale, -lrow[r])) : 0.f;
        }
    }
    put<SN>(mine, x);
    __syncthreads();
    // dS = P o (dP - delta), the same in both warps
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float y = theirs[(4 * j + e) * 32 + (threadIdx.x & 31)];
        const float p = first ? x[j][e] : y, dp = first ? y : x[j][e];
        x[j][e] = p * (dp - drow[e >> 1]);
      }
    // dQ^T += K^T dS^T over this warp's m-tiles (columns of dQ)
    accumulate_t<C::LD, 0, SN>(x, Ks, acc, m0, m_end);
    __syncthreads();  // every warp is done with this stage and the hand-over
    have = nhave, kt = nkt, code = ncode;
    nhave = have && walk.next(nrep, nkt, ncode);
    if (nhave) load_stage(nkt, it & 1);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // a split stores unscaled parts (splits, B, Sq, H, DH) for (d)
  float* out = splits > 1 ? part + (size_t)pi * B * Sq * qstride : dq;
  store_t<C::MH>(acc, out + qoff, qstride, q0 + 16 * rg, Sq, splits > 1 ? 1.f : scale, m0, m_end);
}

// (d) The sums of split loops' parts, one launch for all: job j writes
// out[i] = mul * sum_p parts[p * stride + i], p in order, over n floats
// (n and stride multiples of 4); its blocks follow the previous job's.
struct SumJob {
  const float* parts;
  float* out;
  long long stride, n;
  int splits;
  float mul;
};
constexpr int SUM_JOBS = 3;  // dK, dV, dQ
struct SumJobs {
  SumJob job[SUM_JOBS];
  long long first_block[SUM_JOBS + 1];
};

// Each job is read at a constant index: a job picked by a loop's index
// was copied out of the parameter into local memory (a 4-byte spill).
__global__ void __launch_bounds__(SUM_THREADS)
bwd_tf32_sum_kernel(const __grid_constant__ SumJobs jobs) {
#pragma unroll
  for (int j = 0; j < SUM_JOBS; ++j) {
    if (blockIdx.x < jobs.first_block[j] || blockIdx.x >= jobs.first_block[j + 1]) continue;
    const SumJob& job = jobs.job[j];
    const long long i =
        ((long long)(blockIdx.x - jobs.first_block[j]) * SUM_THREADS + threadIdx.x) * 4;
    if (i >= job.n) return;
    float4 acc = *reinterpret_cast<const float4*>(job.parts + i);
    for (int p = 1; p < job.splits; ++p) {
      const float4 x = *reinterpret_cast<const float4*>(job.parts + p * job.stride + i);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    *reinterpret_cast<float4*>(job.out + i) =
        make_float4(acc.x * job.mul, acc.y * job.mul, acc.z * job.mul, acc.w * job.mul);
  }
}

struct Args {
  const float *q, *k, *v, *out, *d_out, *lse;
  const int *seg_q, *seg_k, *pos_q, *pos_k;
  const int8_t *blk_kv, *blk_dq;
  float *stats, *dq, *dk, *dv, *kv_part, *q_part;
  int B, Sq, Sk, H, KH, Sqp, Skp, kv_splits, q_splits;
  float scale;
  int causal, has_window, window;
};

template <int DH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.H * a.Sqp;
  bwd_tf32_delta_kernel<DH><<<(unsigned)((rows + DELTA_WARPS - 1) / DELTA_WARPS),
                              DELTA_WARPS * 32, 0, stream>>>(a.out, a.d_out, a.lse, a.stats,
                                                             a.Sq, a.Sqp, a.H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv = bwd_tf32_dkdv_kernel<DH>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             KvCfg<DH>::BYTES);
  if (err != cudaSuccess) return err;
  dkdv<<<a.kv_splits * a.KH * a.B * (a.Skp / Tiles<DH>::KV_BK), KvCfg<DH>::THREADS,
         KvCfg<DH>::BYTES,
         stream>>>(a.q, a.k, a.v, a.d_out, a.stats, a.seg_q, a.seg_k, a.pos_q, a.pos_k,
                   a.blk_kv, a.dk, a.dv, a.kv_part, a.B, a.Sq, a.Sk, a.H, a.KH, a.Sqp, a.Skp,
                   a.kv_splits, a.scale, a.causal, a.has_window, a.window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = bwd_tf32_dq_kernel<DH>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, DqCfg<DH>::BYTES);
  if (err != cudaSuccess) return err;
  dqk<<<a.q_splits * a.H * a.B * (a.Sqp / Tiles<DH>::DQ_BQ), DqCfg<DH>::THREADS,
        DqCfg<DH>::BYTES,
        stream>>>(a.q, a.k, a.v, a.d_out, a.stats, a.seg_q, a.seg_k, a.pos_q, a.pos_k, a.blk_dq,
                  a.dq, a.q_part, a.B, a.Sq, a.Sk, a.H, a.KH, a.Sqp, a.Skp, a.q_splits,
                  a.scale, a.causal, a.has_window, a.window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  SumJobs jobs = {};
  int n_jobs = 0;
  const long long nkv = (long long)a.B * a.Sk * a.KH * DH, nq = (long long)a.B * a.Sq * a.H * DH;
  if (a.kv_splits > 1) {  // parts (splits, 2, B, Sk, KH, DH): dK, then dV
    jobs.job[n_jobs++] = {a.kv_part, a.dk, 2 * nkv, nkv, a.kv_splits, a.scale};
    jobs.job[n_jobs++] = {a.kv_part + nkv, a.dv, 2 * nkv, nkv, a.kv_splits, 1.f};
  }
  if (a.q_splits > 1)  // parts (splits, B, Sq, H, DH)
    jobs.job[n_jobs++] = {a.q_part, a.dq, nq, nq, a.q_splits, a.scale};
  if (n_jobs == 0) return cudaSuccess;
  long long blocks = 0;
  for (int j = 0; j < SUM_JOBS; ++j) {
    jobs.first_block[j] = blocks;
    if (j < n_jobs) blocks += (jobs.job[j].n / 4 + SUM_THREADS - 1) / SUM_THREADS;
  }
  jobs.first_block[SUM_JOBS] = blocks;
  bwd_tf32_sum_kernel<<<(unsigned)blocks, SUM_THREADS, 0, stream>>>(jobs);
  return cudaGetLastError();
}

#define PFA_HEAD_DIMS(X) X(16) X(32) X(64) X(80) X(128) X(256)

int dispatch(int head_dim, const Args& a, cudaStream_t stream) {
#define PFA_CASE(DH) \
  if (head_dim == DH) return (int)launch<DH>(a, stream);
  PFA_HEAD_DIMS(PFA_CASE)
#undef PFA_CASE
  return ERR_HEAD_DIM;
}

// the tiles at a head width, or 0 for a width not compiled
int tile_at(int head_dim, int which) {
#define PFA_CASE(DH)                                                                        \
  if (head_dim == DH) {                                                                     \
    using T = Tiles<DH>;                                                                    \
    const int tiles[4] = {T::KV_BQ, T::KV_BK, T::DQ_BQ, T::DQ_BK};                          \
    return tiles[which];                                                                    \
  }
  PFA_HEAD_DIMS(PFA_CASE)
#undef PFA_CASE
  return 0;
}

}  // namespace

extern "C" {

// Tiles at a head width, so the wrapper builds each kernel's tile map at
// its own tiles: the dK/dV kernel's (query rows a stage, keys a CTA) and the
// dQ kernel's (query rows a CTA, keys a stage).
int packed_flash_attn_bwd_block_q(int head_dim) { return tile_at(head_dim, 0); }
int packed_flash_attn_bwd_block_k(int head_dim) { return tile_at(head_dim, 1); }
int packed_flash_attn_bwd_dq_block_q(int head_dim) { return tile_at(head_dim, 2); }
int packed_flash_attn_bwd_dq_block_k(int head_dim) { return tile_at(head_dim, 3); }

// fp32 q, out, d_out, dq (B,Sq,H,dh); k, v, dk, dv (B,Sk,KH,dh); lse fp32
// (B,H,Sq), the forward's row log-sum-exp of the scaled scores, +inf on
// rows with no visible key. seg/pos are int32 padded with zeros to (B, Sqp)
// and (B, Skp), multiples of 64; blk_kv (B, Sqp/16, Skp/64) and blk_dq
// (B, Sqp/64, Skp/16) are int8 tile codes (0 skip, 1 mask, 2 all visible).
// stats (2, B, H, Sqp) fp32 is scratch. kv_part (kv_splits, 2, B, Sk, KH,
// dh) and q_part (q_splits, B, Sq, H, dh) fp32 scratch, read only where the
// split is above 1. Launches its kernels on `stream`; returns 0 or the
// first error.
int packed_flash_attn_bwd_launch(int head_dim, const void* q, const void* k, const void* v,
                                 const void* out, const void* d_out, const void* lse,
                                 const void* seg_q, const void* seg_k, const void* pos_q,
                                 const void* pos_k, const void* blk_kv, const void* blk_dq,
                                 void* stats, void* dq, void* dk, void* dv, int B, int Sq, int Sk,
                                 int H, int KH, int Sqp, int Skp, float scale, int causal,
                                 int has_window, int window, int kv_splits, void* kv_part,
                                 int q_splits, void* q_part, void* stream) {
  if (Sqp % PAD_Q || Skp % PAD_K || kv_splits < 1 || q_splits < 1 ||
      (kv_splits > 1 && kv_part == nullptr) || (q_splits > 1 && q_part == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(out),
               static_cast<const float*>(d_out), static_cast<const float*>(lse),
               static_cast<const int*>(seg_q), static_cast<const int*>(seg_k),
               static_cast<const int*>(pos_q), static_cast<const int*>(pos_k),
               static_cast<const int8_t*>(blk_kv), static_cast<const int8_t*>(blk_dq),
               static_cast<float*>(stats), static_cast<float*>(dq), static_cast<float*>(dk),
               static_cast<float*>(dv), static_cast<float*>(kv_part), static_cast<float*>(q_part),
               B, Sq, Sk, H, KH, Sqp, Skp, kv_splits, q_splits, scale, causal, has_window,
               window};
  return dispatch(head_dim, a, static_cast<cudaStream_t>(stream));
}

const char* packed_flash_attn_bwd_error_string(int code) { return error_string(code); }

}  // extern "C"
