// Packed (segment-aware) flash attention, forward, fp32, for Hopper (sm_90a):
// every product in 3xTF32 on the tensor cores (mma.sync), key tiles copied
// ahead of use by cp.async.
//
// Replaces the Pallas TPU kernel `_attn_kernel`, launched by
// `packed_flash_attention` in src/repro/kernels/packed_flash_attn.py, for
// fp32 inputs; bf16 inputs take packed_flash_attn_sm90.cu. It computes the
// same function: a key is visible from a query when both carry the same
// nonzero segment id, pos_q >= pos_k (causal) and pos_q - pos_k < window
// (sliding window); GQA maps query head h to kv head h * K / H; a row with
// no visible key returns exactly 0. It also writes the row log-sum-exp of
// the scaled scores in natural-log units (+inf on a row with no visible
// key), which the fp32 backward (packed_flash_attn_bwd.cu) reads.
//
// Precision. fp32 is the parity path, held to 1e-4 of max |ref| against the
// plain version. One TF32 product keeps about 11 bits of each operand and
// cannot hold that; 3xTF32 (sm90_common.cuh: x = hi + lo, a b = alo bhi +
// ahi blo + ahi bhi) comes within 2x of plain fp32. The tensor cores' fp32
// sums do not round to nearest, and an output accumulated in place over
// 16-key stages drifts with the keys (5.4e-5 of max |ref| at 4096 keys in a
// numpy model that truncates each product's sum toward zero); so each
// stage's P V starts from zero on the tensor cores and joins the running
// output by an fp32 fma, out = out * corr + part (4.5e-6 there; the model is
// tests/test_torch_kernels.py's). The online softmax stays fp32.
//
// Bound on an H100 SXM: operations, 2 products of 2 * dh flops per visible
// (query, key) pair and head, at 495 / 3 = 165 TFLOP/s of fp32 products as
// 3xTF32 (the 67 TFLOP/s of fp32 outside the tensor cores was the earlier
// CUDA-core kernel's ceiling). At the parity paths' 2 x 256 batches bytes
// bound it, and the grid (32 CTAs at 4 heads) and the longest CTA's walk
// (9 stages of about 3 us) set the time: there the walk is split (below).
//
// Design, the shape of the fp32 backward's dQ kernel with an online softmax
// in place of its lse and dS:
//  - A CTA owns 64 query rows of one (batch, head), which stay in shared
//    memory (their copy starts first, under the walk's set-up); K, V and
//    the keys' segment ids and positions stream in 16-key stages through a
//    2-stage cp.async ring, each issued one stage ahead. The CTA walks its
//    row of the tile map (tiles 64 x 16) from a list compacted in shared
//    memory (`Walk`, tf32_common.cuh), which drops the tiles the backward
//    drops: those the map keeps only because its range tests span a
//    document start. CTAs launch query-tile-major, late (heavy) tiles first.
//  - Where the grid leaves SMs idle, `splits` CTAs share a walk (every
//    splits-th tile each; the wrapper's `fwd_splits`, one wave of the SMs):
//    each stores its unnormalised output and its rows' max and sum, and
//    `packed_flash_attn_tf32_merge_kernel` merges the parts in order, so
//    the result stays deterministic.
//  - Products: mma.sync m16n8k8 .tf32 in 3xTF32, not wgmma, which reads
//    32-bit operands from shared memory K-major only; V, the B operand of
//    P V, is MN-major. Each thread splits what it reads into hi and lo.
//  - Warps: a 16-row group per warp (four a CTA) up to dh 128, each with
//    the whole width: a 16 x dh output (dh / 2 registers) and a part of it,
//    MC n-tiles at a time. At dh 256 that output alone would take 128
//    registers, so two warps share a group: each forms S over half of dh,
//    they add their halves through shared memory (the same sum in both, as
//    fp32 addition commutes), and each owns half of the output's columns.
//    S sums even and odd k-steps in two accumulators (`scores2`), two
//    chains of dependent products where the backward's `scores` has one.
//  - P never leaves registers: the S accumulator is P V's A operand with
//    the reduction index permuted (k slots t and t + 4 hold keys 2t and
//    2t + 1 of each 8), and V's rows are read in that order (`frag_b_kn`).
//    Row max and row sum reduce over a quad by shuffles.
//  - Shared memory a CTA (fp32 rows padded by 4 floats, so that every
//    fragment read hits 32 distinct banks): Q 64 rows, 2 stages of 16 K and
//    V rows, the walk's list; 45 KB at dh 80 and 70 KB at dh 128 with 163
//    and 168 registers a thread (three CTAs of 128 threads an SM), 144 KB
//    with the hand-over at dh 256, 212 registers (one CTA of 256 threads).
// Tile codes: 0 skip, 1 mask per element, 2 every pair visible (no mask).
// Rows and keys past the sequence are zero-filled and carry segment id 0
// (the wrapper pads seg/pos to whole tiles), so the mask removes them.

#include "tf32_common.cuh"

namespace {

constexpr int STAGES = 2;
constexpr int MERGE_WARPS = 8;

template <int DH>
struct FwdCfg {
  static constexpr int BQ = 64, BK = 16;   // query rows a CTA, keys a stage: the map's tiles
  static constexpr int GROUPS = BQ / 16;   // 16-row groups
  static constexpr int WP = DH > 128 ? 2 : 1;  // warps a group, each DH / WP columns
  static constexpr int THREADS = GROUPS * WP * 32;
  static constexpr int DW = DH / WP;       // columns a warp reduces S over and owns of O
  static constexpr int NT = DW / 8;        // n-tiles of a warp's output
  static constexpr int MC = NT % 4 == 0 ? 4 : NT % 5 == 0 ? 5 : NT;  // n-tiles a part holds
  static constexpr int LD = DH + PAD;
  static constexpr int QT = BQ * LD;
  static constexpr int KT = BK * LD;
  static constexpr int STAGE = 2 * KT + 2 * BK;  // K, V, seg, pos
  static constexpr int XCH = WP > 1 ? GROUPS * WP * 16 * BK : 0;  // S halves of a warp pair
  static constexpr int BYTES = (QT + STAGES * STAGE + XCH + WALK) * 4;
  static constexpr int MIN_CTAS = DH > 128 ? 1 : 3;  // dh 128: 168 registers
  static_assert(DW % 8 == 0 && NT % MC == 0, "whole n-tiles, whole parts");
  static_assert(BYTES <= 232448, "more shared memory than a CTA can have");
};

// S accumulator n-tile (keys 2t, 2t + 1 of rows g and g + 8) as the A
// fragment of P V, its keys the reduction permuted: k slot t is key 2t,
// slot t + 4 key 2t + 1
__device__ __forceinline__ void frag_a_acc(const float (&c)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// B fragment of P V: rows k0 + 2t and k0 + 2t + 1 of row-major V (its keys,
// permuted as in `frag_a_acc`), column n0 + g
template <int LD>
__device__ __forceinline__ void frag_b_kn(const float* tile, int k0, int n0, uint32_t (&hi)[2],
                                          uint32_t (&lo)[2]) {
  const float* p = tile + (k0 + 2 * lane_t()) * LD + n0 + lane_g();
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[LD], hi[1], lo[1]);
}

// S = rows r0 .. r0 + 15 of X times Y^T over DW columns, as `scores` forms
// it, but each n-tile summed in two accumulators, the even and the odd
// k-steps, added in fp32 at the end: two chains of dependent products where
// `scores` has one, which a CTA's latency follows where few warps share an SM
template <int DW, int LD, int SN>
__device__ __forceinline__ void scores2(const float* X, int r0, const float* Y,
                                        float (&acc)[SN][4]) {
  static_assert(DW % 16 == 0, "k-steps in pairs");
  float odd[SN][4];
#pragma unroll
  for (int j = 0; j < SN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = odd[j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < DW; kk += 16) {
    uint32_t ah[2][4], al[2][4];
    frag_a<LD>(X, r0, kk, ah[0], al[0]);
    frag_a<LD>(X, r0, kk + 8, ah[1], al[1]);
#pragma unroll
    for (int j = 0; j < SN; ++j) {
      uint32_t bh[2][2], bl[2][2];
      frag_b_nk<LD>(Y, 8 * j, kk, bh[0], bl[0]);
      frag_b_nk<LD>(Y, 8 * j, kk + 8, bh[1], bl[1]);
      mma_3xtf32(acc[j], ah[0], al[0], bh[0], bl[0]);
      mma_3xtf32(odd[j], ah[1], al[1], bh[1], bl[1]);
    }
  }
#pragma unroll
  for (int j = 0; j < SN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += odd[j][e];
}

template <int DH>
__global__ void __launch_bounds__(FwdCfg<DH>::THREADS, FwdCfg<DH>::MIN_CTAS)
packed_flash_attn_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const int* __restrict__ seg_q,
                              const int* __restrict__ seg_k, const int* __restrict__ pos_q,
                              const int* __restrict__ pos_k, const int8_t* __restrict__ blk,
                              float* __restrict__ out, float* __restrict__ lse,
                              float* __restrict__ part, int B, int Sq, int Sk, int H, int KH,
                              int Sqp, int Skp, int splits, float scale, int causal,
                              int has_window, int window) {
  using C = FwdCfg<DH>;
  constexpr int BQ = C::BQ, BK = C::BK;
  constexpr int SN = BK / 8;  // n-tiles of S
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* ring = smem + C::QT;
  float* xch = ring + STAGES * C::STAGE;

  const int nQ = Sqp / BQ, nK = Skp / BK;
  // CTAs in query-tile-major order, late (heavy) query tiles first; the
  // parts of a split walk side by side
  const int pi = blockIdx.x % splits, h = blockIdx.x / splits % H;
  const int b = blockIdx.x / splits / H % B, qt = nQ - 1 - (int)(blockIdx.x / splits / H / B);
  const int kh = h * KH / H;
  const int warp = threadIdx.x >> 5, g = lane_g(), t = lane_t();
  const int rg = warp % C::GROUPS, half = warp / C::GROUPS;  // its rows, its columns
  const int c0 = half * C::DW;
  const int q0 = qt * BQ;
  const size_t qstride = (size_t)H * DH, kstride = (size_t)KH * DH;
  const size_t qoff = (size_t)b * Sq * qstride + (size_t)h * DH;
  // Q first: its copy overlaps the walk's set-up
  load_rows<DH, BQ, C::THREADS>(Qs, q + qoff, q0, Sq, qstride);
  // this query tile's row of the map, every splits-th tile from part pi
  WalkMem* wm = reinterpret_cast<WalkMem*>(xch + C::XCH);
  if (threadIdx.x == 0)
    wm->set(blk + ((size_t)b * nQ + qt) * nK, seg_k, pos_k, (size_t)b * Skp, 1, nK, 1, splits,
            pi, causal, has_window, window);
  Walk<C::THREADS, BK, false> walk{wm};
  const size_t koff = (size_t)b * Sk * kstride + (size_t)kh * DH;
  auto load_stage = [&](int i, int st) {
    float* base = ring + st * C::STAGE;
    load_rows<DH, BK, C::THREADS>(base, k + koff, i * BK, Sk, kstride);
    load_rows<DH, BK, C::THREADS>(base + C::KT, v + koff, i * BK, Sk, kstride);
    const size_t key = (size_t)b * Skp + i * BK;
    load_words<BK, C::THREADS>(base + 2 * C::KT, seg_k + key, 0);
    load_words<BK, C::THREADS>(base + 2 * C::KT + BK, pos_k + key, BK / 4);
  };

  if (warp == 0) summarise<BQ>(seg_q, pos_q, (size_t)b * Sqp + q0, &wm->sum);
  __syncthreads();  // the walk's fields and summary are set before any thread reads them
  int rep, kt, code, nrep, nkt, ncode;
  bool have = walk.next(rep, kt, code);
  if (have) load_stage(kt, 0);
  cp_async_commit();
  bool nhave = have && walk.next(nrep, nkt, ncode);
  if (nhave) load_stage(nkt, 1);
  cp_async_commit();

  // this thread's rows: 16 rg + g and 16 rg + g + 8 of the tile
  int srow[2], prow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t i = (size_t)b * Sqp + q0 + 16 * rg + g + 8 * r;
    srow[r] = seg_q[i];
    prow[r] = pos_q[i];
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[C::NT][4];  // O's columns c0 .. c0 + DW - 1, unnormalised
#pragma unroll
  for (int n = 0; n < C::NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; have; ++it) {
    cp_async_wait<1>();
    __syncthreads();
    const float* Ks = ring + (it & 1) * C::STAGE;
    const float* Vs = Ks + C::KT;
    const int* sk = reinterpret_cast<const int*>(Ks + 2 * C::KT);
    const int* pk = sk + BK;

    // S = Q K^T over this warp's columns. Element e of n-tile j is row
    // g + 8 (e / 2), key 8j + 2t + e % 2.
    float x[SN][4];
    scores2<C::DW, C::LD, SN>(Qs + c0, 16 * rg, Ks + c0, x);
    if constexpr (C::WP > 1) {  // the pair adds its halves of the reduction
      put<SN>(xch + (half * C::GROUPS + rg) * 16 * BK, x);
      __syncthreads();
      const float* theirs = xch + ((1 - half) * C::GROUPS + rg) * 16 * BK;
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[j][e] += theirs[(4 * j + e) * 32 + (threadIdx.x & 31)];
    }

    // mask and online softmax of row r (g, g + 8): its 16 keys lie on the
    // quad's four lanes, 4 each
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          const bool vis =
              code == 2 || visible(srow[r], prow[r], sk[c], pk[c], causal, has_window, window);
          x[j][e] = vis ? x[j][e] * scale : -INFINITY;
          mx = fmaxf(mx, x[j][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // nothing visible yet: p, corr 0
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          x[j][e] = expf(x[j][e] - m_use);
          rs += x[j][e];
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      corr[r] = expf(m[r] - m_use);
      l[r] = l[r] * corr[r] + rs;
      m[r] = m_new;
    }

    // O = O corr + P V over this warp's columns: each part of MC n-tiles
    // from zero on the tensor cores, joined by fp32 fmas
    uint32_t ph[SN][4], pl[SN][4];
#pragma unroll
    for (int j = 0; j < SN; ++j) frag_a_acc(x[j], ph[j], pl[j]);
#pragma unroll
    for (int n0 = 0; n0 < C::NT; n0 += C::MC) {
      float part[C::MC][4];
#pragma unroll
      for (int n = 0; n < C::MC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int n = 0; n < C::MC; ++n) {
          uint32_t bh[2], bl[2];
          frag_b_kn<C::LD>(Vs, 8 * j, c0 + 8 * (n0 + n), bh, bl);
          mma_3xtf32(part[n], ph[j], pl[j], bh, bl);
        }
#pragma unroll
      for (int n = 0; n < C::MC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n0 + n][e] = fmaf(acc[n0 + n][e], corr[e >> 1], part[n][e]);
    }
    __syncthreads();  // every warp is done with this stage and the hand-over
    have = nhave, kt = nkt, code = ncode;
    nhave = have && walk.next(nrep, nkt, ncode);
    if (nhave) load_stage(nkt, it & 1);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // a split stores its unnormalised part (splits, B, Sq, H, DH) and its rows'
  // m and l (splits, 2, B, H, Sq) for the merge
  const size_t nout = (size_t)B * Sq * qstride, nrow = (size_t)B * H * Sq;
  float* o = splits > 1 ? part + (size_t)pi * nout : out;
  float* ml = splits > 1 ? part + splits * nout + (size_t)pi * 2 * nrow : nullptr;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = q0 + 16 * rg + g + 8 * r;
    if (s >= Sq) continue;
    float* orow = o + qoff + (size_t)s * qstride + c0 + 2 * t;
    const bool any = l[r] > 0.f;
    const float mul = splits > 1 ? 1.f : 1.f / l[r];
#pragma unroll
    for (int n = 0; n < C::NT; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          any ? make_float2(acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul)
              : make_float2(0.f, 0.f);
    const size_t row = ((size_t)b * H + h) * Sq + s;
    if (t != 0 || half != 0) continue;
    if (splits > 1) {
      ml[row] = m[r];
      ml[nrow + row] = l[r];
    } else if (lse != nullptr) {
      // row log-sum-exp of the scaled scores, for the backward; +inf where
      // no key is visible, so that exp(s - lse) is exactly 0 there
      lse[row] = any ? m[r] + logf(l[r]) : INFINITY;
    }
  }
}

// The parts of split key walks merged, one warp a (batch, row, head), parts
// in order: out = sum_p e^(m_p - M) O_p / L, L = sum_p e^(m_p - M) l_p, M =
// max_p m_p, and lse = M + log L (+inf and a row of 0 where L is 0)
template <int DH>
__global__ void __launch_bounds__(MERGE_WARPS * 32)
packed_flash_attn_tf32_merge_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    float* __restrict__ lse, int B, int Sq, int H,
                                    int splits) {
  constexpr int PER = (DH / 4 + 31) / 32;  // 4-column chunks a lane
  const int rows = B * Sq * H;
  const int row = blockIdx.x * MERGE_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform over the warp
  const int lane = threadIdx.x & 31;
  const int h = row % H, s = row / H % Sq, b = row / H / Sq;
  const size_t nrow = (size_t)B * H * Sq, i = ((size_t)b * H + h) * Sq + s;
  const float* ml = part + (size_t)splits * rows * DH;
  float M = -INFINITY;
  for (int p = 0; p < splits; ++p) M = fmaxf(M, ml[2 * p * nrow + i]);
  const float m_use = M == -INFINITY ? 0.f : M;
  float L = 0.f;
  float4 acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = 0; p < splits; ++p) {
    const float w = expf(ml[2 * p * nrow + i] - m_use);
    L += ml[(2 * p + 1) * nrow + i] * w;
    const float* src = part + ((size_t)p * rows + row) * DH;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = 4 * (lane + 32 * j);
      if (c >= DH) break;
      const float4 x = *reinterpret_cast<const float4*>(src + c);
      acc[j] = make_float4(fmaf(w, x.x, acc[j].x), fmaf(w, x.y, acc[j].y),
                           fmaf(w, x.z, acc[j].z), fmaf(w, x.w, acc[j].w));
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = 4 * (lane + 32 * j);
    if (c >= DH) break;
    *reinterpret_cast<float4*>(out + (size_t)row * DH + c) =
        L > 0.f ? make_float4(acc[j].x / L, acc[j].y / L, acc[j].z / L, acc[j].w / L)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (lane == 0 && lse != nullptr) lse[i] = L > 0.f ? M + logf(L) : INFINITY;
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, const int* seg_q,
                   const int* seg_k, const int* pos_q, const int* pos_k, const int8_t* blk,
                   float* out, float* lse, int B, int Sq, int Sk, int H, int KH, int nQ, int nK,
                   float scale, int causal, int has_window, int window, int splits, float* part,
                   cudaStream_t stream) {
  using C = FwdCfg<DH>;
  auto kern = packed_flash_attn_tf32_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::BYTES);
  if (err != cudaSuccess) return err;
  kern<<<splits * H * B * nQ, C::THREADS, C::BYTES, stream>>>(
      q, k, v, seg_q, seg_k, pos_q, pos_k, blk, out, lse, part, B, Sq, Sk, H, KH, nQ * C::BQ,
      nK * C::BK, splits, scale, causal, has_window, window);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int rows = B * Sq * H;
  packed_flash_attn_tf32_merge_kernel<DH>
      <<<(rows + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32, 0, stream>>>(
          part, out, lse, B, Sq, H, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile sizes, so the wrapper builds `blk_ok` at the kernel's own tiles (the
// same at every head width).
int packed_flash_attn_block_q(int) { return FwdCfg<128>::BQ; }
int packed_flash_attn_block_k(int) { return FwdCfg<128>::BK; }

// fp32 q (B,Sq,H,dh), k/v (B,Sk,KH,dh), out like q. seg/pos are int32 padded
// with zeros to (B, nQ*64) and (B, nK*16); blk_ok is (B, nQ, nK) int8 tile
// codes (0 skip, 1 mask, 2 all visible). lse, when not null, receives the
// fp32 (B,H,Sq) row log-sum-exp of the scaled scores (+inf on rows with no
// visible key). With splits > 1 each (batch, head, query tile) walks its keys
// in that many CTAs, which store fp32 parts to `part` (splits * (B*Sq*H*dh +
// 2*B*H*Sq) floats of scratch) that a second kernel merges in order.
// Returns 0 or the first error of the launches.
int packed_flash_attn_fwd(int head_dim, const void* q, const void* k, const void* v,
                          const void* seg_q, const void* seg_k, const void* pos_q,
                          const void* pos_k, const void* blk_ok, void* out, void* lse, int B,
                          int Sq, int Sk, int H, int KH, int nQ, int nK, float scale, int causal,
                          int has_window, int window, int splits, void* part, void* stream) {
  if (splits < 1 || (splits > 1 && part == nullptr)) return (int)cudaErrorInvalidValue;
#define PFA_CASE(DH)                                                                          \
  if (head_dim == DH)                                                                         \
    return (int)launch<DH>(                                                                   \
        static_cast<const float*>(q), static_cast<const float*>(k),                           \
        static_cast<const float*>(v), static_cast<const int*>(seg_q),                         \
        static_cast<const int*>(seg_k), static_cast<const int*>(pos_q),                       \
        static_cast<const int*>(pos_k), static_cast<const int8_t*>(blk_ok),                   \
        static_cast<float*>(out), static_cast<float*>(lse), B, Sq, Sk, H, KH, nQ, nK, scale,  \
        causal, has_window, window, splits, static_cast<float*>(part),                        \
        static_cast<cudaStream_t>(stream));
  PFA_CASE(16)
  PFA_CASE(32)
  PFA_CASE(64)
  PFA_CASE(80)
  PFA_CASE(128)
  PFA_CASE(256)
#undef PFA_CASE
  return ERR_HEAD_DIM;
}

const char* packed_flash_attn_error_string(int code) { return error_string(code); }

}  // extern "C"
