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
// warpgroups of 64 rows, plus one producer warp whose elected thread issues
// every copy. The producer loads the Q tile once by TMA, then streams the K
// and V tiles of BK = 128 keys (and the tile's key segment ids and positions, by
// bulk copy) through a ring of STAGES shared-memory stages, each with a full
// and an empty mbarrier; it loads only tiles whose code in `blk_ok` is
// nonzero. Each consumer warpgroup computes S = Q K^T with
// wgmma m64nBKk16 (both operands from shared memory, K-major: dh contiguous),
// masks S in registers where the tile's code is 1 (2 means every pair is
// visible), runs the online softmax on its fp32 accumulator (each row spread
// over the 4 threads of a quad), converts P to bf16 in registers and
// accumulates O += P V with wgmma m64n{dh}k16, P as the register A operand
// and V from shared memory as an MN-major B operand. Then it frees the stage.
// Shared tiles are stored in chunks of min(dh, 64) columns under the TMA
// swizzle of the chunk's row width (32, 64 or 128 bytes); the wgmma
// descriptors name the same swizzle. TMA maps are 4-D over
// (dh, heads, S, B), so a box never crosses into the next batch row and keys
// or queries past the sequence are zero-filled. Heavy (late, under the causal
// mask) q-tiles are launched first.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;                  // query rows per CTA
constexpr int BK = 128;                  // keys per K/V tile
constexpr int CONSUMERS = 256;           // two warpgroups of 64 query rows each
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int STAGES = 2;                // K/V ring depth
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared-memory tile layout of a head width: chunks of CW columns, each a
// dense (rows x SW bytes) block under the SW-byte swizzle.
template <int DH>
struct Chunking {
  static constexpr int SW = DH * 2 < 128 ? DH * 2 : 128;  // bytes per chunk row
  static constexpr int CW = SW / 2;                        // columns per chunk
  static constexpr int NCH = DH / CW;                      // chunks per row
  // wgmma descriptor layout type: 1 = 128B, 2 = 64B, 3 = 32B swizzle
  static constexpr uint64_t DESC_LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
};

template <int DH>
struct Smem {
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed. A wait of more than
// 4 s can only be a broken pipeline: trap, so the launch fails instead of
// holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = global_ns();
    } else if (global_ns() - t0 > 4000000000ull) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout type; base offset 0, since
// every tile starts on a 1024-byte boundary.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin register arrays at this point, so that the compiler moves none of
// their ordinary reads and writes across a wgmma fence or wait.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma.mma_async m64nNk16, f32 += bf16 * bf16. The accumulator of thread
// (warp w, lane l) holds rows 16w + l/4 (+8) and columns 8i + 2(l%4) (+1):
// d[4i] and d[4i+1] on the first row, d[4i+2] and d[4i+3] on the second.
template <int N>
struct Wgmma;

template <> struct Wgmma<16> {
  // D[8] += A[registers] * B[smem, MN-major]
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct Wgmma<32> {
  // D[16] += A[registers] * B[smem, MN-major]
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct Wgmma<64> {
  // D[32] += A[registers] * B[smem, MN-major]
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <> struct Wgmma<128> {
  // D[64] (+)= A[smem, K-major] * B[smem, K-major]
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // D[64] += A[registers] * B[smem, MN-major]
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
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
  constexpr uint32_t SBO = 8 * C::SW;  // next 8-row group of a chunk
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
      const uint32_t c = (kk * 16) / C::CW, off = (kk * 16) % C::CW * 2;
      Wgmma<BK>::ss(s, smem_desc(q_addr + c * BQ * C::SW + off, 16, SBO, C::DESC_LAYOUT),
                    smem_desc(k_addr + c * BK * C::SW + off, 16, SBO, C::DESC_LAYOUT), kk > 0);
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

    // O += P V: V is MN-major (dh contiguous); 16 keys per k-step
    pin(o);
    pin(p);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
      Wgmma<DH>::rs(o, p + 4 * t,
                    smem_desc(v_addr + t * 16 * C::SW, BK * C::SW, SBO, C::DESC_LAYOUT));
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

// cuTensorMapEncodeTiled, looked up at run time so that the library needs
// no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

constexpr int ERR_NO_ENCODER = -1;   // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = -2;       // cuTensorMapEncodeTiled refused a map
constexpr int ERR_HEAD_DIM = -3;     // unsupported head_dim

// 4-D map over a (B, S, heads, DH) bf16 tensor; a box is one head's `rows`
// rows of one chunk, swizzled as the wgmma descriptors expect.
template <int DH>
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int rows) {
  using C = Chunking<DH>;
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)DH * 2, (cuuint64_t)heads * DH * 2,
                                 (cuuint64_t)S * heads * DH * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::CW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = C::SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : C::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* seg_q, const void* seg_k,
           const void* pos_q, const void* pos_k, const void* blk_ok, void* out, void* lse, int B,
           int Sq, int Sk, int H, int KH, int nQ, int nK, float scale, int causal,
           int has_window, int window, cudaStream_t stream) {
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
  kern<<<grid, THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<const int*>(seg_q), static_cast<const int*>(seg_k),
      static_cast<const int*>(pos_q), static_cast<const int*>(pos_k),
      static_cast<const int8_t*>(blk_ok), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Sq, H, KH, nQ, nK, scale * LOG2E, causal, has_window, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile sizes, so the wrapper builds `blk_ok` at the kernel's own tiles.
int packed_flash_attn_sm90_block_q() { return BQ; }
int packed_flash_attn_sm90_block_k() { return BK; }

// bf16 q (B,Sq,H,dh), k/v (B,Sk,KH,dh), out like q. seg/pos are int32 padded
// with zeros to (B, nQ*128) and (B, nK*128); blk_ok is (B, nQ, nK) int8
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
  PFA_CASE(128)
#undef PFA_CASE
  return ERR_HEAD_DIM;
}

const char* packed_flash_attn_sm90_error_string(int code) {
  switch (code) {
    case ERR_NO_ENCODER: return "cuTensorMapEncodeTiled entry point not found";
    case ERR_ENCODE: return "cuTensorMapEncodeTiled refused a tensor map";
    case ERR_HEAD_DIM: return "unsupported head_dim";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
