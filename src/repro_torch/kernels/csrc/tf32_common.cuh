// Pieces shared by the two fp32 packed flash attention kernels on Hopper
// (sm_90a), the forward (packed_flash_attn.cu) and the backward
// (packed_flash_attn_bwd.cu), both 3xTF32 by mma.sync: the mask test,
// cp.async row copies into shared tiles padded by PAD floats a row, the
// m16n8k8 fragments read from such tiles, the hand-over of a fragment-ordered
// tile between warps, the scores S = X Y^T, and the tile walk (`Walk`) over a
// row or column of the wrapper's tile map, so that both kernels skip the same
// tiles. `kernels/build.py` hashes this header into the name of every library
// whose source includes it.
#pragma once

#include <limits.h>

#include "sm90_common.cuh"

namespace {

constexpr int PAD = 4;  // floats of row padding in shared memory
constexpr int CAP = 512;  // tiles a window of a `Walk`

__device__ __forceinline__ bool visible(int sq, int pq, int sk, int pk, int causal,
                                        int has_window, int window) {
  bool ok = sq == sk && sq != 0;
  if (causal) ok = ok && pq >= pk;
  if (has_window) ok = ok && pq - pk < window;
  return ok;
}

// Copy rows [row0, row0 + ROWS) of one head (rows `stride` floats apart)
// into a padded shared tile; rows at or past `limit` are zero-filled.
template <int DH, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int limit,
                                          size_t stride) {
  constexpr int CPR = DH / 4;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR * 4, s = row0 + r;
    const bool ok = s < limit;
    cp_async16(dst + r * (DH + PAD) + c, ok ? src + (size_t)s * stride + c : src, ok);
  }
}

// Copy N (a multiple of 4) 32-bit words; threads from `first` on issue them.
template <int N, int THREADS>
__device__ __forceinline__ void load_words(void* dst, const void* src, int first) {
  const int i = (int)threadIdx.x - first;
  if (i >= 0 && i < N / 4)
    cp_async16(static_cast<uint32_t*>(dst) + 4 * i, static_cast<const uint32_t*>(src) + 4 * i,
               true);
  static_assert(N / 4 <= THREADS, "one chunk a thread");
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// A fragment (16 x 8) at rows r0.., columns c0.. of a row-major padded tile
template <int LD>
__device__ __forceinline__ void frag_a(const float* tile, int r0, int c0, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float* p = tile + (r0 + lane_g()) * LD + c0 + lane_t();
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8 * LD], hi[1], lo[1]);
  split_tf32(p[4], hi[2], lo[2]);
  split_tf32(p[8 * LD + 4], hi[3], lo[3]);
}

// B fragment of X Y^T: rows n0 .. n0 + 7 of Y, columns k0 .. k0 + 7
template <int LD>
__device__ __forceinline__ void frag_b_nk(const float* tile, int n0, int k0, uint32_t (&hi)[2],
                                          uint32_t (&lo)[2]) {
  const float* p = tile + (n0 + lane_g()) * LD + k0 + lane_t();
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[4], hi[1], lo[1]);
}

// Segment summaries of a CTA's resident rows (keys of the dK/dV kernel,
// queries of the dQ kernel and of the forward): each nonzero segment id with
// the least and greatest position of its rows, at most NSEG of them (more:
// no summary).
constexpr int NSEG = 4;
struct Summary {
  int n;  // segments, or -1 where there were more than NSEG
  int seg[NSEG], lo[NSEG], hi[NSEG];
};

// Summarise the ROWS (a multiple of 32, at most 64) rows from row0 of
// seg/pos; called by every lane of one warp. Each round takes the least
// segment id not yet summarised and reduces its positions over the warp.
template <int ROWS>
__device__ __forceinline__ void summarise(const int* seg, const int* pos, size_t row0,
                                          Summary* out) {
  static_assert(ROWS % 32 == 0 && ROWS <= 64, "rows a warp summarises");
  constexpr int R = ROWS / 32;
  const int lane = threadIdx.x & 31;
  int s_own[R], p_own[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    s_own[i] = seg[row0 + 32 * i + lane];
    p_own[i] = pos[row0 + 32 * i + lane];
  }
  Summary m;
  m.n = 0;
  bool negative = false;  // ids below 0 are segments too; such a tile is not summarised
#pragma unroll
  for (int i = 0; i < R; ++i) negative |= s_own[i] < 0;
  if (__any_sync(0xffffffffu, negative)) {
    if (lane == 0) out->n = -1;
    return;
  }
  int done = 0;  // the greatest id summarised so far
#pragma unroll
  for (int j = 0; j <= NSEG; ++j) {
    int next_id = INT_MAX;
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (s_own[i] > done) next_id = min(next_id, s_own[i]);
    next_id = __reduce_min_sync(0xffffffffu, next_id);
    if (next_id == INT_MAX) break;
    if (j == NSEG) {  // more segments than a summary holds
      m.n = -1;
      break;
    }
    int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (s_own[i] == next_id) lo = min(lo, p_own[i]), hi = max(hi, p_own[i]);
    m.seg[j] = next_id;
    m.lo[j] = __reduce_min_sync(0xffffffffu, lo);
    m.hi[j] = __reduce_max_sync(0xffffffffu, hi);
    m.n = j + 1;
    done = next_id;
  }
  if (lane == 0) *out = m;
}

// What a walk reads (shared memory, so that the walk holds only its cursor
// in registers): the map's row or column, the streamed side's ids from
// row0, the masking, the part, and the list. Thread 0 sets the fields, and
// a barrier must follow before any thread's first `next`, which reads `n`;
// warp 0 writes the summary, which only `refill` reads, behind its barrier.
struct WalkMem {
  const int8_t* codes;
  const int* seg;
  const int* pos;
  size_t row0;
  int stride, n, reps, splits, part, causal, has_window, window;
  Summary sum;
  int list[CAP + 1];  // CAP entries (tile << 2 | code), then the count

  __device__ void set(const int8_t* codes_, const int* seg_, const int* pos_, size_t row0_,
                      int stride_, int n_, int reps_, int splits_, int part_, int causal_,
                      int has_window_, int window_) {
    codes = codes_, seg = seg_, pos = pos_, row0 = row0_, stride = stride_, n = n_;
    reps = reps_, splits = splits_, part = part_;
    causal = causal_, has_window = has_window_, window = window_;
  }
};
constexpr int WALK = (sizeof(WalkMem) + 15) / 16 * 4;  // floats of shared memory

// The nonzero tile codes of one row or column of a tile map (codes[i *
// stride], i < n), walked `reps` times over (the GQA group's heads), every
// `splits`-th entry from `part` on: rep-major within windows of CAP tiles,
// each window compacted into shared memory, so that a step reads shared
// memory and not the map. A code-1 tile (TILE rows of the streamed side,
// ids in seg/pos from `row0`) is dropped where no row can see a row of the
// CTA's summary: per segment, the position ranges cannot meet under the
// causal and window tests. The tile map's range tests are looser where a
// tile holds a document start (a key tile at a boundary of documents
// passes every query tile of both), and such tiles would otherwise set the
// kernel's critical path; a dropped tile would have added exact zeros.
// Every thread calls `next` at the same points (a refill synchronises the
// CTA).
template <int THREADS, int TILE, bool STREAM_Q>
struct Walk {
  WalkMem* m;
  int w0 = -CAP, r = 0, e = 0, len = 0, c = 0;

  // can a streamed row at (s, p) see a resident row of the summary `sum`?
  __device__ bool sees(const Summary& sum, int s, int p) const {
    bool any = false;
#pragma unroll
    for (int j = 0; j < NSEG; ++j) {
      const int lo = sum.lo[j], hi = sum.hi[j];
      // a query at p sees a key in [lo, hi] (STREAM_Q), a key at p a query in [lo, hi]
      const bool c_ok = !m->causal || (STREAM_Q ? lo <= p : hi >= p);
      const bool w_ok = !m->has_window || (STREAM_Q ? hi > p - m->window : lo < p + m->window);
      any |= j < sum.n && sum.seg[j] == s && c_ok && w_ok;
    }
    return any;
  }

  // whether tile t is kept: its code, and for code 1 the summary test. The
  // tile's ids come 16 rows at a time in 16-byte loads issued together, and
  // the summary sits in registers (a load a row, each behind the last row's
  // test, took 8.6 us at the parity shape).
  __device__ int keep(int t) const {
    static_assert(TILE % 16 == 0, "ids in 16-byte loads, 16 rows at a time");
    if (t >= m->n) return 0;
    const int code = m->codes[(size_t)t * m->stride];
    const Summary sum = m->sum;
    bool any = sum.n < 0;
    for (int r0 = 0; r0 < TILE && !any; r0 += 16) {
      const size_t row = m->row0 + (size_t)t * TILE + r0;  // 16-byte aligned
      const int4* s4 = reinterpret_cast<const int4*>(m->seg + row);
      const int4* p4 = reinterpret_cast<const int4*>(m->pos + row);
      int4 sv[4], pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = s4[i], pv[i] = p4[i];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int sr[4] = {sv[i].x, sv[i].y, sv[i].z, sv[i].w};
        const int pr[4] = {pv[i].x, pv[i].y, pv[i].z, pv[i].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) any |= sr[e] != 0 && sees(sum, sr[e], pr[e]);
      }
    }
    return code == 2 || (code == 1 && any) ? t << 2 | code : 0;
  }

  __device__ void refill() {
    __syncthreads();  // every thread is done with the last window's list
    int* list = m->list;
    for (int i = threadIdx.x; i < CAP; i += THREADS) list[i] = keep(w0 + i);
    __syncthreads();
    if (threadIdx.x < 32) {  // compact in place, in order
      const int lane = threadIdx.x;
      int kept = 0;
      for (int base = 0; base < CAP; base += 32) {
        const int v = list[base + lane];
        const unsigned hit = __ballot_sync(0xffffffffu, v != 0);
        if (v != 0) list[kept + __popc(hit & ((1u << lane) - 1))] = v;
        kept += __popc(hit);
      }
      if (lane == 0) list[CAP] = kept;
    }
    __syncthreads();
    len = list[CAP];
  }

  // the next (rep, tile, code) of this part; false when there is none
  __device__ bool next(int& rep, int& tile, int& code) {
    for (;;) {
      if (++e >= len) {  // past this window's list for rep r
        e = -1;
        if (len == 0 || ++r >= m->reps) {
          r = 0;
          w0 += CAP;
          if (w0 >= m->n) {
            len = 0;
            return false;
          }
          refill();
        }
        continue;
      }
      if (c++ % m->splits == m->part) {
        const int v = m->list[e];
        rep = r;
        tile = v >> 2;
        code = v & 3;
        return true;
      }
    }
  }
};

// A fragment-ordered n-tile array (thread lane's 4 values of each n-tile)
// into a warp's slot of the hand-over buffer, lane-contiguous, so that every
// access (here, and the partner's reads of element (4j + e) * 32 + lane)
// hits 32 distinct banks.
template <int SN>
__device__ __forceinline__ void put(float* slot, const float (&x)[SN][4]) {
#pragma unroll
  for (int j = 0; j < SN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) slot[(4 * j + e) * 32 + (threadIdx.x & 31)] = x[j][e];
}

// acc[j] (+)= rows r0 .. r0 + 15 of X times Y^T over all of dh: 3xTF32 over
// k-steps of 8, X and Y row-major padded tiles
template <int DH, int LD, int SN>
__device__ __forceinline__ void scores(const float* X, int r0, const float* Y, float (&acc)[SN][4]) {
#pragma unroll
  for (int j = 0; j < SN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < DH; kk += 8) {
    uint32_t ah[4], al[4];
    frag_a<LD>(X, r0, kk, ah, al);
#pragma unroll
    for (int j = 0; j < SN; ++j) {
      uint32_t bh[2], bl[2];
      frag_b_nk<LD>(Y, 8 * j, kk, bh, bl);
      mma_3xtf32(acc[j], ah, al, bh, bl);
    }
  }
}

}  // namespace
