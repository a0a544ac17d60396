// Packed (segment-aware) flash attention, backward, fp32, for Hopper
// (sm_90a), on the CUDA cores.
//
// The gradient of the Pallas TPU kernel `_attn_kernel`, launched by
// `packed_flash_attention` in src/repro/kernels/packed_flash_attn.py, for
// fp32 inputs: the fp32 parity path's backward. bf16 inputs take the
// tensor-core backward in packed_flash_attn_bwd_sm90.cu. TF32 tensor cores
// cannot hold the fp32 path's 1e-4 tolerance, so fp32 stays on the CUDA
// cores. The JAX package has no backward kernel (it trains through its jnp
// attention, which XLA differentiates); this one computes the same gradient
// under the forward kernels' tile skip, so that a training micro-batch costs
// sum(l_i^2) rather than N^2 in its backward too. The mask is the forward's
// exactly: a key is visible from a query when both carry the same nonzero
// segment id, pos_q >= pos_k (causal) and pos_q - pos_k < window (sliding
// window); GQA maps query head h to kv head h * K / H. A row with no visible
// key has lse = +inf from the forward, so its probabilities, and its
// gradients, are exactly 0.
//
// Math (FlashAttention-2), per query head, with S = scale * Q K^T over the
// visible pairs, P = exp(S - lse) recomputed from the forward's row
// log-sum-exp, and delta_i = sum_d dO_id O_id:
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - delta),
//   dQ = scale * dS K,  dK = scale * dS^T Q,
// dK and dV summed over the H / K query heads of a KV head.
//
// Bound on an H100 SXM: operations, 5 products of 2 * dh flops per visible
// (query, key) pair and head, at the 67 TFLOP/s of fp32 outside the tensor
// cores; at the parity path's 1 x 256 micro-batches, the bytes. This design
// runs them as fp32 FMAs from shared memory and reaches a fraction of that.
//
// Design. Three kernels, deterministic, no atomics, at square tiles of TB rows
// and keys: 64, and 32 at dh 256, where four 64-row fp32 tiles would need
// 266 KB of shared memory:
//   (a) delta: one warp per (batch, row, head);
//   (b) dK/dV: one CTA of 256 threads per (TB-key tile, KV head, batch). It
//       keeps its K and V tile in shared memory and dK, dV in registers, and
//       loops over the query heads of its GQA group and over the TB-row
//       query tiles whose code in `blk_ok` is nonzero. For each it loads Q,
//       dO, lse and delta, recomputes P and forms dS (both to shared
//       memory), then accumulates dV += P^T dO and dK += dS^T Q;
//   (c) dQ: one CTA per (TB-row query tile, head, batch). It keeps Q, dO
//       and dQ, loops over the nonzero key tiles, recomputes dS, and
//       accumulates dQ += dS K.
// `blk_ok` is the wrapper's tile map at these TB x TB tiles (0 skip, 1 mask
// per element, 2 every pair visible). Tiles sit in shared memory as fp32
// with rows padded by 4 elements, so the row reads of a warp fall in distinct
// banks. A thread owns TB / 16 rows x TB / 16 keys of a score tile and
// dh / 16 columns of its rows of dK, dV or dQ, read as vectors of 4, 2 or 1
// (dh 80: 5 columns, one at a time).
// Rows and keys beyond the sequence are zero-filled and carry segment id 0
// (the wrapper pads seg/pos).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256; // 16 row groups x 16 column groups
constexpr int PAD = 4;       // row padding of the Q/K/V/dO tiles, in floats
constexpr int DELTA_WARPS = 8;

// rows (and keys) of a tile at head width DH
template <int DH>
__host__ __device__ constexpr int tile_rows() { return DH > 128 ? 32 : 64; }

// 16 bytes -> 4 floats
__device__ __forceinline__ void unpack(const uint4& raw, float* o) {
  o[0] = __uint_as_float(raw.x); o[1] = __uint_as_float(raw.y);
  o[2] = __uint_as_float(raw.z); o[3] = __uint_as_float(raw.w);
}

template <int N>
__device__ __forceinline__ void lds(const float* p, float* o) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x; o[1] = x.y;
  } else {
    o[0] = *p;
  }
}

// Copy rows [row0, row0 + TB) of one head into a padded fp32 shared tile;
// rows at or past `limit` become zeros.
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int limit,
                                          size_t row_stride) {
  constexpr int TB = tile_rows<DH>();
  constexpr int LDT = DH + PAD;
  constexpr int CPR = DH / 4;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < TB * CPR; idx += THREADS) {
    const int r = idx / CPR;
    const int c = (idx % CPR) * 4;
    const int s = row0 + r;
    float vals[4] = {0.f, 0.f, 0.f, 0.f};
    if (s < limit) unpack(*reinterpret_cast<const uint4*>(src + (size_t)s * row_stride + c), vals);
    *reinterpret_cast<float4*>(dst + r * LDT + c) = make_float4(vals[0], vals[1], vals[2], vals[3]);
  }
}

__device__ __forceinline__ bool visible(int sq, int pq, int sk, int pk, int causal,
                                        int has_window, int window) {
  bool ok = sq == sk && sq != 0;
  if (causal) ok = ok && pq >= pk;
  if (has_window) ok = ok && pq - pk < window;
  return ok;
}

// s[i][j] = sum_d A[rq + 16 i][d] * B[ck + 16 j][d] over padded fp32 tiles;
// R = TB / 16 rows and keys a thread
template <int DH, int R>
__device__ __forceinline__ void tile_product(const float* A, const float* B, float (&s)[R][R],
                                             int rq, int ck) {
  constexpr int LDT = DH + PAD;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    float a[R][4], b[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i) lds<4>(A + (rq + 16 * i) * LDT + d, a[i]);
#pragma unroll
    for (int j = 0; j < R; ++j) lds<4>(B + (ck + 16 * j) * LDT + d, b[j]);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float x = s[i][j];
        x = fmaf(a[i][0], b[j][0], x);
        x = fmaf(a[i][1], b[j][1], x);
        x = fmaf(a[i][2], b[j][2], x);
        x = fmaf(a[i][3], b[j][3], x);
        s[i][j] = x;
      }
  }
}

// Shared memory of one CTA: Q, dO, K, V tiles, then P and dS, then the rows'
// segment ids, positions, lse and delta, and the keys' segment ids and
// positions.
template <int DH>
struct Smem {
  static constexpr int TB = tile_rows<DH>();
  static constexpr int R = TB / 16;      // rows (keys) of a score tile a thread
  static constexpr int LDS = TB + 16;    // row stride of the P and dS tiles: rows 16 apart in banks
  static constexpr int LDT = DH + PAD;
  static constexpr int TILE = TB * LDT;  // floats
  static constexpr int PS = 4 * TILE;
  static constexpr int DS = PS + TB * LDS;
  static constexpr int META = DS + TB * LDS;
  static constexpr size_t BYTES = (size_t)(META + 6 * TB) * 4;
  // output columns a thread (dh / 16), read VEC at a time
  static constexpr int DC = DH / 16;
  static constexpr int VEC = DC % 4 == 0 ? 4 : DC % 2 == 0 ? 2 : 1;
  static constexpr int NM = DC / VEC;
};

struct Rows {  // per-row metadata of the current query tile, in shared memory
  int* seg;
  int* pos;
  float* lse;
  float* delta;
};

// Load the query-side tiles of (batch b, head h, query tile qt): Q, dO, and
// the rows' segment ids, positions, lse and delta.
template <int DH>
__device__ __forceinline__ void load_query_side(float* Qs, float* dOs, Rows rows, const float* q,
                                                const float* d_out, const float* lse,
                                                const float* delta, const int* seg_q,
                                                const int* pos_q, int b, int h, int qt, int Sq,
                                                int H, int nQ) {
  constexpr int TB = tile_rows<DH>();
  const size_t stride = (size_t)H * DH;
  const size_t base = (size_t)b * Sq * stride + (size_t)h * DH;
  const int q0 = qt * TB;
  load_tile<DH>(Qs, q + base, q0, Sq, stride);
  load_tile<DH>(dOs, d_out + base, q0, Sq, stride);
  for (int r = threadIdx.x; r < TB; r += THREADS) {
    const size_t i = (size_t)b * nQ * TB + q0 + r;  // seg/pos padded with zeros
    rows.seg[r] = seg_q[i];
    rows.pos[r] = pos_q[i];
    const int s = q0 + r;
    const size_t li = ((size_t)b * H + h) * Sq + s;
    rows.lse[r] = s < Sq ? lse[li] : INFINITY;
    rows.delta[r] = s < Sq ? delta[li] : 0.f;
  }
}

template <int DH>
__device__ __forceinline__ void load_key_side(float* Ks, float* Vs, int* sk, int* pk,
                                              const float* k, const float* v, const int* seg_k,
                                              const int* pos_k, int b, int kh, int kt, int Sk,
                                              int KH, int nK) {
  constexpr int TB = tile_rows<DH>();
  const size_t stride = (size_t)KH * DH;
  const size_t base = (size_t)b * Sk * stride + (size_t)kh * DH;
  const int k0 = kt * TB;
  load_tile<DH>(Ks, k + base, k0, Sk, stride);
  load_tile<DH>(Vs, v + base, k0, Sk, stride);
  for (int r = threadIdx.x; r < TB; r += THREADS) {
    const size_t i = (size_t)b * nK * TB + k0 + r;
    sk[r] = seg_k[i];
    pk[r] = pos_k[i];
  }
}

// One (query tile, key tile) pair: recompute P and form dS = P o (dP - delta)
// into shared memory (P only when Ps is not null). Thread (rq, ck) owns rows
// rq + 16 i and keys ck + 16 j.
template <int DH>
__device__ __forceinline__ void probs_and_dscores(const float* Qs, const float* dOs,
                                                  const float* Ks, const float* Vs, Rows rows,
                                                  const int* sk, const int* pk, float* Ps,
                                                  float* dSs, int code, float scale, int causal,
                                                  int has_window, int window) {
  using M = Smem<DH>;
  constexpr int R = M::R, LDS = M::LDS;
  const int rq = threadIdx.x >> 4, ck = threadIdx.x & 15;
  float s[R][R], dp[R][R];
  tile_product<DH, R>(Qs, Ks, s, rq, ck);
  tile_product<DH, R>(dOs, Vs, dp, rq, ck);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = rq + 16 * i;
    const int sqv = rows.seg[r], pqv = rows.pos[r];
    const float l = rows.lse[r], dl = rows.delta[r];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = ck + 16 * j;
      const bool vis = code == 2 || visible(sqv, pqv, sk[c], pk[c], causal, has_window, window);
      const float p = vis ? expf(fmaf(s[i][j], scale, -l)) : 0.f;
      if (Ps != nullptr) Ps[r * LDS + c] = p;
      dSs[r * LDS + c] = p * (dp[i][j] - dl);
    }
  }
}

// (a) delta[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d]: one warp per row
template <int DH>
__global__ void __launch_bounds__(DELTA_WARPS * 32)
bwd_delta_kernel(const float* __restrict__ out, const float* __restrict__ d_out,
                 float* __restrict__ delta, int Sq, int H, long long rows) {
  const long long row = (long long)blockIdx.x * DELTA_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform over the warp
  const int lane = threadIdx.x & 31;
  const float* o = out + row * DH;
  const float* g = d_out + row * DH;
  float acc = 0.f;
  for (int d = lane; d < DH; d += 32) acc = fmaf(o[d], g[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bs = row / H;  // b * Sq + s
    const int s = (int)(bs % Sq);
    const long long b = bs / Sq;
    delta[((size_t)b * H + h) * Sq + s] = acc;
  }
}

// (b) dK, dV of one key tile of one KV head
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ d_out,
                const float* __restrict__ lse,
                const float* __restrict__ delta, const int* __restrict__ seg_q,
                const int* __restrict__ seg_k, const int* __restrict__ pos_q,
                const int* __restrict__ pos_k, const int8_t* __restrict__ blk_ok,
                float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H, int KH,
                int nQ, int nK, float scale, int causal, int has_window, int window) {
  using M = Smem<DH>;
  constexpr int TB = M::TB, R = M::R, LDS = M::LDS, LDT = M::LDT;
  constexpr int DC = M::DC, VEC = M::VEC, NM = M::NM;
  extern __shared__ __align__(16) float smem[];
  float *Qs = smem, *dOs = smem + M::TILE, *Ks = smem + 2 * M::TILE, *Vs = smem + 3 * M::TILE;
  float *Ps = smem + M::PS, *dSs = smem + M::DS;
  Rows rows{reinterpret_cast<int*>(smem + M::META), reinterpret_cast<int*>(smem + M::META) + TB,
            smem + M::META + 2 * TB, smem + M::META + 3 * TB};
  int* sk = reinterpret_cast<int*>(smem + M::META + 4 * TB);
  int* pk = sk + TB;

  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, rk = tid >> 4, cc = tid & 15;
  load_key_side<DH>(Ks, Vs, sk, pk, k, v, seg_k, pos_k, b, kh, kt, Sk, KH, nK);

  float dk_acc[R][DC], dv_acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int group = H / KH;
  for (int h = kh * group; h < (kh + 1) * group; ++h) {
    for (int qt = 0; qt < nQ; ++qt) {
      const int code = blk_ok[((size_t)b * nQ + qt) * nK + kt];
      if (!code) continue;  // uniform over the CTA
      __syncthreads();      // the previous pair's reads of Qs, dOs, Ps, dSs are done
      load_query_side<DH>(Qs, dOs, rows, q, d_out, lse, delta, seg_q, pos_q, b, h, qt, Sq, H,
                          nQ);
      __syncthreads();
      probs_and_dscores<DH>(Qs, dOs, Ks, Vs, rows, sk, pk, Ps, dSs, code, scale, causal,
                            has_window, window);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: keys rk + 16 i, columns cc * VEC + 16 VEC mm + e
#pragma unroll 2
      for (int r = 0; r < TB; ++r) {
        float p[R], ds[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          p[i] = Ps[r * LDS + rk + 16 * i];
          ds[i] = dSs[r * LDS + rk + 16 * i];
        }
#pragma unroll
        for (int mm = 0; mm < NM; ++mm) {
          float gf[VEC], qf[VEC];
          lds<VEC>(dOs + r * LDT + cc * VEC + 16 * VEC * mm, gf);
          lds<VEC>(Qs + r * LDT + cc * VEC + 16 * VEC * mm, qf);
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              dv_acc[i][mm * VEC + e] = fmaf(p[i], gf[e], dv_acc[i][mm * VEC + e]);
              dk_acc[i][mm * VEC + e] = fmaf(ds[i], qf[e], dk_acc[i][mm * VEC + e]);
            }
        }
      }
    }
  }

  const size_t stride = (size_t)KH * DH;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int s = kt * TB + rk + 16 * i;
    if (s >= Sk) continue;
    const size_t row = ((size_t)b * Sk + s) * stride + (size_t)kh * DH;
#pragma unroll
    for (int mm = 0; mm < NM; ++mm)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int c = cc * VEC + 16 * VEC * mm + e;
        dk[row + c] = dk_acc[i][mm * VEC + e] * scale;
        dv[row + c] = dv_acc[i][mm * VEC + e];
      }
  }
}

// (c) dQ of one query tile of one head
template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ d_out,
              const float* __restrict__ lse,
              const float* __restrict__ delta, const int* __restrict__ seg_q,
              const int* __restrict__ seg_k, const int* __restrict__ pos_q,
              const int* __restrict__ pos_k, const int8_t* __restrict__ blk_ok,
              float* __restrict__ dq, int Sq, int Sk, int H, int KH, int nQ, int nK, float scale,
              int causal, int has_window, int window) {
  using M = Smem<DH>;
  constexpr int TB = M::TB, R = M::R, LDS = M::LDS, LDT = M::LDT;
  constexpr int DC = M::DC, VEC = M::VEC, NM = M::NM;
  extern __shared__ __align__(16) float smem[];
  float *Qs = smem, *dOs = smem + M::TILE, *Ks = smem + 2 * M::TILE, *Vs = smem + 3 * M::TILE;
  float* dSs = smem + M::DS;
  Rows rows{reinterpret_cast<int*>(smem + M::META), reinterpret_cast<int*>(smem + M::META) + TB,
            smem + M::META + 2 * TB, smem + M::META + 3 * TB};
  int* sk = reinterpret_cast<int*>(smem + M::META + 4 * TB);
  int* pk = sk + TB;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h * KH / H;
  const int tid = threadIdx.x, rq = tid >> 4, cc = tid & 15;
  load_query_side<DH>(Qs, dOs, rows, q, d_out, lse, delta, seg_q, pos_q, b, h, qt, Sq, H, nQ);

  float acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int8_t* codes = blk_ok + ((size_t)b * nQ + qt) * nK;
  for (int kt = 0; kt < nK; ++kt) {
    const int code = codes[kt];
    if (!code) continue;
    __syncthreads();  // the previous pair's reads of Ks, Vs, dSs are done
    load_key_side<DH>(Ks, Vs, sk, pk, k, v, seg_k, pos_k, b, kh, kt, Sk, KH, nK);
    __syncthreads();
    probs_and_dscores<DH>(Qs, dOs, Ks, Vs, rows, sk, pk, nullptr, dSs, code, scale, causal,
                          has_window, window);
    __syncthreads();
    // dQ += dS K: rows rq + 16 i, columns cc * VEC + 16 VEC mm + e
#pragma unroll 2
    for (int c = 0; c < TB; ++c) {
      float ds[R];
#pragma unroll
      for (int i = 0; i < R; ++i) ds[i] = dSs[(rq + 16 * i) * LDS + c];
#pragma unroll
      for (int mm = 0; mm < NM; ++mm) {
        float kf[VEC];
        lds<VEC>(Ks + c * LDT + cc * VEC + 16 * VEC * mm, kf);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[i][mm * VEC + e] = fmaf(ds[i], kf[e], acc[i][mm * VEC + e]);
      }
    }
  }

  const size_t stride = (size_t)H * DH;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int s = qt * TB + rq + 16 * i;
    if (s >= Sq) continue;
    const size_t row = ((size_t)b * Sq + s) * stride + (size_t)h * DH;
#pragma unroll
    for (int mm = 0; mm < NM; ++mm)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        dq[row + cc * VEC + 16 * VEC * mm + e] = acc[i][mm * VEC + e] * scale;
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* d_out, const void* lse, const void* seg_q, const void* seg_k,
                   const void* pos_q, const void* pos_k, const void* blk_ok, void* delta,
                   void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, int KH, int nQ,
                   int nK, float scale, int causal, int has_window, int window,
                   cudaStream_t stream) {
  const float *qp = static_cast<const float*>(q), *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v), *gp = static_cast<const float*>(d_out);
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);
  const int *sq = static_cast<const int*>(seg_q), *sk = static_cast<const int*>(seg_k),
            *pq = static_cast<const int*>(pos_q), *pk = static_cast<const int*>(pos_k);
  const int8_t* codes = static_cast<const int8_t*>(blk_ok);

  const long long rows = (long long)B * Sq * H;
  bwd_delta_kernel<DH><<<(unsigned)((rows + DELTA_WARPS - 1) / DELTA_WARPS), DELTA_WARPS * 32, 0,
                         stream>>>(static_cast<const float*>(out), gp, dp, Sq, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem = Smem<DH>::BYTES;
  auto dkdv = bwd_dkdv_kernel<DH>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3(nK, KH, B), THREADS, smem, stream>>>(
      qp, kp, vp, gp, lp, dp, sq, sk, pq, pk, codes, static_cast<float*>(dk),
      static_cast<float*>(dv), Sq, Sk, H, KH, nQ, nK, scale, causal, has_window, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = bwd_dq_kernel<DH>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dqk<<<dim3(nQ, H, B), THREADS, smem, stream>>>(qp, kp, vp, gp, lp, dp, sq, sk, pq, pk, codes,
                                                 static_cast<float*>(dq), Sq, Sk, H, KH, nQ, nK,
                                                 scale, causal, has_window, window);
  return cudaGetLastError();
}

cudaError_t dispatch(int head_dim, const void* q, const void* k, const void* v,
                     const void* out, const void* d_out, const void* lse, const void* seg_q,
                     const void* seg_k, const void* pos_q, const void* pos_k, const void* blk_ok,
                     void* delta, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
                     int KH, int nQ, int nK, float scale, int causal, int has_window, int window,
                     cudaStream_t stream) {
#define PFA_CASE(DH)                                                                         \
  if (head_dim == DH)                                                                        \
    return launch<DH>(q, k, v, out, d_out, lse, seg_q, seg_k, pos_q, pos_k, blk_ok, delta,    \
                      dq, dk, dv, B, Sq, Sk, H, KH, nQ, nK, scale, causal, has_window,        \
                      window, stream);
  PFA_CASE(16)
  PFA_CASE(32)
  PFA_CASE(64)
  PFA_CASE(80)
  PFA_CASE(128)
  PFA_CASE(256)
#undef PFA_CASE
  return cudaErrorInvalidValue;
}

int tile_rows_at(int head_dim) { return head_dim > 128 ? tile_rows<256>() : tile_rows<128>(); }

}  // namespace

extern "C" {

// Tile sizes at a head width, so the wrapper builds `blk_ok` at the kernels'
// own tiles.
int packed_flash_attn_bwd_block_q(int head_dim) { return tile_rows_at(head_dim); }
int packed_flash_attn_bwd_block_k(int head_dim) { return tile_rows_at(head_dim); }

// fp32 q, out, d_out, dq (B,Sq,H,dh); k, v, dk, dv (B,Sk,KH,dh). lse and
// delta (scratch, written here) are fp32 (B,H,Sq); lse is the forward's row
// log-sum-exp of the scaled scores,
// +inf on rows with no visible key. seg/pos are int32 padded with zeros to
// (B, nQ*TB) and (B, nK*TB); blk_ok is (B, nQ, nK) int8 tile codes (0 skip,
// 1 mask, 2 all visible). Launches three kernels on `stream`; returns the
// first cudaError_t that is not success.
int packed_flash_attn_bwd_launch(int head_dim, const void* q, const void* k, const void* v,
                                 const void* out, const void* d_out, const void* lse,
                                 const void* seg_q, const void* seg_k, const void* pos_q,
                                 const void* pos_k, const void* blk_ok, void* delta, void* dq,
                                 void* dk, void* dv, int B, int Sq, int Sk, int H, int KH,
                                 int nQ, int nK, float scale, int causal, int has_window,
                                 int window, void* stream) {
  return (int)dispatch(head_dim, q, k, v, out, d_out, lse, seg_q, seg_k, pos_q, pos_k,
                       blk_ok, delta, dq, dk, dv, B, Sq, Sk, H, KH, nQ, nK, scale, causal,
                       has_window, window, static_cast<cudaStream_t>(stream));
}

const char* packed_flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
