// Packed (segment-aware) flash attention, forward, fp32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_attn_kernel`, launched by
// `packed_flash_attention` in src/repro/kernels/packed_flash_attn.py, for
// fp32 inputs; bf16 inputs take the tensor-core kernel in
// packed_flash_attn_sm90.cu. It computes the same function: a key is visible
// from a query when both carry the same nonzero segment id, pos_q >= pos_k
// (causal) and pos_q - pos_k < window (sliding window); GQA maps query head h
// to kv head h * K / H; a row with no visible key returns exactly 0.
//
// Why fp32 stays on CUDA cores: fp32 is the parity path, held to 1e-4
// against the plain version with TF32 off. The tensor cores take fp32 only
// as TF32 (10-bit mantissa), which cannot meet that tolerance.
//
// Design. One CTA of 128 threads owns 64 query rows of one (batch, head) and
// loops over 64-row KV tiles in order, carrying the running max, sum and
// accumulator in fp32 registers (the Pallas grid's sequential KV axis becomes
// this loop). A tile whose code in `blk_ok` is 0 (computed by the wrapper
// from per-tile segment and position ranges, at these tile sizes) is skipped
// before it is loaded, which is what makes the cost scale with sum(l_i^2)
// rather than N^2. Q, K and V tiles sit in shared memory with rows padded by
// 4 elements, so the row reads of a warp fall in distinct banks; the
// probability tile is fp32. Each thread owns 4 query rows x 8 keys of the
// score tile and 4 query rows x head_dim/8 columns of the output, and the
// products are fp32 FMAs on the CUDA cores. Rows and keys beyond the
// sequence are zero-filled and carry segment id 0 (the wrapper pads seg/pos),
// so the mask removes them.
//
// Bound on an H100 SXM: compute, 4 * dh flops per visible (query, key) pair
// and head, at the 67 TFLOP/s of fp32 outside the tensor cores.
//
// Head widths 16, 32, 64, 80, 128 and 256. At dh 80 a thread's output columns
// are read from V two at a time (80 is not a multiple of 8 threads x 4); at
// dh 256 the Q, K, V and P tiles take 214 KB of shared memory, which the
// launch opts into.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per CTA
constexpr int BK = 64;       // keys per KV tile
constexpr int THREADS = 128; // 16 row groups x 8 column groups
constexpr int PAD = 4;       // row padding of the Q/K/V tiles, in elements
constexpr int LDP = BK + 8;  // fp32 row stride of the probability tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}

__device__ __forceinline__ void load2(const float* p, float* o) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  o[0] = x.x; o[1] = x.y;
}

template <int N, typename T>
__device__ __forceinline__ void loadv(const T* p, float* o) {
  if constexpr (N == 4) load4(p, o); else load2(p, o);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// Copy rows [row0, row0 + ROWS) of one head into a padded shared tile, in
// 16-byte chunks; rows at or past `limit` become zeros.
template <typename T, int DH, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, int limit,
                                          size_t row_stride) {
  constexpr int LDT = DH + PAD;
  constexpr int CH = 16 / sizeof(T);  // elements per chunk
  constexpr int CPR = DH / CH;        // chunks per row
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += THREADS) {
    const int r = idx / CPR;
    const int c = (idx % CPR) * CH;
    const int s = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < limit) val = *reinterpret_cast<const uint4*>(src + (size_t)s * row_stride + c);
    uint2* d = reinterpret_cast<uint2*>(dst + r * LDT + c);  // padded rows: 8-byte aligned
    d[0] = make_uint2(val.x, val.y);
    d[1] = make_uint2(val.z, val.w);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
packed_flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int* __restrict__ seg_q,
                         const int* __restrict__ seg_k, const int* __restrict__ pos_q,
                         const int* __restrict__ pos_k, const int8_t* __restrict__ blk_ok,
                         T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H,
                         int KH, int nQ, int nK, float scale, int causal, int has_window,
                         int window) {
  constexpr int LDT = DH + PAD;
  constexpr int VEC = DH % 32 == 0 ? 4 : 2;  // output columns per vector load of V
  constexpr int NM = DH / (8 * VEC);     // vectors per thread per output row
  constexpr int DC = NM * VEC;           // output columns per thread (DH / 8)

  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BQ * LDT;
  T* Vs = Ks + BK * LDT;
  float* Ps = reinterpret_cast<float*>(Vs + BK * LDT);
  int* sq_s = reinterpret_cast<int*>(Ps + BQ * LDP);
  int* pq_s = sq_s + BQ;
  int* sk_s = pq_s + BQ;
  int* pk_s = sk_s + BK;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h * KH / H;
  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  const int q0 = qt * BQ;
  const size_t q_stride = (size_t)H * DH, kv_stride = (size_t)KH * DH;
  const T* qb = q + (size_t)b * Sq * q_stride + (size_t)h * DH;
  const T* kb = k + (size_t)b * Sk * kv_stride + (size_t)kh * DH;
  const T* vb = v + (size_t)b * Sk * kv_stride + (size_t)kh * DH;

  load_tile<T, DH, BQ>(Qs, qb, q0, Sq, q_stride);
  for (int r = tid; r < BQ; r += THREADS) {
    const size_t i = (size_t)b * nQ * BQ + q0 + r;  // seg/pos padded with zeros
    sq_s[r] = seg_q[i];
    pq_s[r] = pos_q[i];
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int8_t* ok_row = blk_ok + ((size_t)b * nQ + qt) * nK;
  for (int kt = 0; kt < nK; ++kt) {
    if (!ok_row[kt]) continue;  // uniform over the CTA
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of Ks, Vs and Ps are done
    load_tile<T, DH, BK>(Ks, kb, k0, Sk, kv_stride);
    load_tile<T, DH, BK>(Vs, vb, k0, Sk, kv_stride);
    for (int r = tid; r < BK; r += THREADS) {
      const size_t i = (size_t)b * nK * BK + k0 + r;
      sk_s[r] = seg_k[i];
      pk_s[r] = pos_k[i];
    }
    __syncthreads();

    // scores: rows rg + 16 i, keys cg + 8 j
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float qf[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load4(Qs + (rg + 16 * i) * LDT + d, qf[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float kf[4];
        load4(Ks + (cg + 8 * j) * LDT + d, kf);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = s[i][j];
          a = fmaf(qf[i][0], kf[0], a);
          a = fmaf(qf[i][1], kf[1], a);
          a = fmaf(qf[i][2], kf[2], a);
          a = fmaf(qf[i][3], kf[3], a);
          s[i][j] = a;
        }
      }
    }

    // mask, online softmax, probabilities to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 16 * i;
      const int sqv = sq_s[r], pqv = pq_s[r];
      float mx = NEG_INF;
      unsigned vis = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = cg + 8 * j;
        const int pkv = pk_s[c];
        bool ok = (sqv == sk_s[c]) && (sqv != 0);
        if (causal) ok = ok && (pqv >= pkv);
        if (has_window) ok = ok && (pqv - pkv < window);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        vis |= (unsigned)ok << j;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = ((vis >> j) & 1u) ? expf(s[i][j] - m_new) : 0.f;
        Ps[r * LDP + cg + 8 * j] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P V: rows rg + 16 i, columns cg * VEC + 8 * VEC * mm + e
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float pf[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load4(Ps + (rg + 16 * i) * LDP + kk, pf[i]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const T* vrow = Vs + (kk + u) * LDT + cg * VEC;
#pragma unroll
        for (int mm = 0; mm < NM; ++mm) {
          float vf[VEC];
          loadv<VEC>(vrow + 8 * VEC * mm, vf);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[i][mm * VEC + e] = fmaf(pf[i][u], vf[e], acc[i][mm * VEC + e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + rg + 16 * i;
    if (s >= Sq) continue;
    T* orow = out + ((size_t)b * Sq + s) * q_stride + (size_t)h * DH;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int mm = 0; mm < NM; ++mm)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        store1(orow + cg * VEC + 8 * VEC * mm + e,
               l[i] > 0.f ? acc[i][mm * VEC + e] / denom : 0.f);
    // row log-sum-exp of the scaled scores, for the backward; +inf where no
    // key is visible, so that exp(s - lse) is exactly 0 there
    if (lse != nullptr && cg == 0)
      lse[((size_t)b * H + h) * Sq + s] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* seg_q,
                   const void* seg_k, const void* pos_q, const void* pos_k,
                   const void* blk_ok, void* out, void* lse, int B, int Sq, int Sk, int H,
                   int KH, int nQ, int nK, float scale, int causal, int has_window, int window,
                   cudaStream_t stream) {
  constexpr int LDT = DH + PAD;
  const size_t smem = (size_t)(BQ + 2 * BK) * LDT * sizeof(T) +
                      (size_t)BQ * LDP * sizeof(float) + (size_t)2 * (BQ + BK) * sizeof(int);
  auto kern = packed_flash_attn_kernel<T, DH>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(seg_q), static_cast<const int*>(seg_k),
      static_cast<const int*>(pos_q), static_cast<const int*>(pos_k),
      static_cast<const int8_t*>(blk_ok), static_cast<T*>(out), static_cast<float*>(lse), Sq, Sk,
      H, KH, nQ, nK, scale, causal, has_window, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int head_dim, const void* q, const void* k, const void* v,
                     const void* seg_q, const void* seg_k, const void* pos_q,
                     const void* pos_k, const void* blk_ok, void* out, void* lse, int B, int Sq,
                     int Sk, int H, int KH, int nQ, int nK, float scale, int causal,
                     int has_window, int window, cudaStream_t stream) {
#define PFA_CASE(DH)                                                                        \
  case DH:                                                                                  \
    return launch<T, DH>(q, k, v, seg_q, seg_k, pos_q, pos_k, blk_ok, out, lse, B, Sq, Sk, H, \
                         KH, nQ, nK, scale, causal, has_window, window, stream);
  switch (head_dim) {
    PFA_CASE(16)
    PFA_CASE(32)
    PFA_CASE(64)
    PFA_CASE(80)
    PFA_CASE(128)
    PFA_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef PFA_CASE
}

}  // namespace

extern "C" {

// Tile sizes, so the wrapper builds `blk_ok` at the kernel's own tiles (the
// same at every head width).
int packed_flash_attn_block_q(int) { return BQ; }
int packed_flash_attn_block_k(int) { return BK; }

// fp32 q (B,Sq,H,dh), k/v (B,Sk,KH,dh), out like q. seg/pos are int32 padded
// with zeros to (B, nQ*64) and (B, nK*64); blk_ok is (B, nQ, nK) int8 tile
// codes (0 skip, else run). lse, when not null, receives the fp32 (B,H,Sq)
// row log-sum-exp of the scaled scores (+inf on rows with no visible key).
// Returns the cudaError_t of the launch.
int packed_flash_attn_fwd(int head_dim, const void* q, const void* k, const void* v,
                          const void* seg_q, const void* seg_k, const void* pos_q,
                          const void* pos_k, const void* blk_ok, void* out, void* lse, int B,
                          int Sq, int Sk, int H, int KH, int nQ, int nK, float scale, int causal,
                          int has_window, int window, void* stream) {
  return (int)dispatch<float>(head_dim, q, k, v, seg_q, seg_k, pos_q, pos_k, blk_ok, out, lse, B,
                              Sq, Sk, H, KH, nQ, nK, scale, causal, has_window, window,
                              static_cast<cudaStream_t>(stream));
}

const char* packed_flash_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
