// Exact streaming top-k of q . e^T for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces anorag_tpu/ops/topk.py::_topk_kernel (:40), via
// _dense_topk_pallas (:124): for each query row, the exact top-k of
// q . e^T (+ bias_weight * bias), rows >= n_valid masked.
// Function: q (B, D) and e (N, D) in one dtype (bf16 or f32), products
// summed in f32; for each query the k best valid rows by (score descending,
// row ascending) -- lax.top_k's rule, not the Pallas kernel's slot history;
// output sorted that way, slots never filled are (-3.0e38, -1).
//
// Design. Phase 1, one CTA per unit: a tile of QT queries against one
// corpus range (a split) of whole 128-row sub-tiles. The wrapper's plan
// (ops/topk.py topk_work_plan) cuts the corpus into as many splits as make
// the units about the CTAs the card holds at once, one wave; the unit index
// runs over the query tiles first, so the tiles of one range run side by
// side and share it in L2 (the corpus leaves device memory about once).
//   From 48 queries at k <= 32 (topk_query_tile) bf16 batches with 16-byte
//   rows take the wgmma route (topk_wgmma_kernel): 128-query tiles, one
//   producer thread keeping a 4-stage ring of TMA loads (128-byte swizzled
//   slices of 64 columns of the tile's queries and of a sub-tile's rows)
//   in flight behind mbarriers, and two consumer warpgroups of 64 queries
//   running wgmma m64n128k16 on them; each warp then holds all 128 rows of
//   its 16 queries, so it selects and merges without any CTA barrier.
//   Everything else takes topk_partial_kernel, mma.sync m16n8k16 from
//   ldmatrix (bf16) or FMAs (f32) behind a cp.async ring: 64-query tiles
//   at k <= 128 from 64 queries, from one on rows that are not 16-byte
//   aligned (plain loads; 16 warps, warp tiles 16 x 32, 3 stages of 64
//   columns); 16-query tiles for smaller batches and for k to 1024 (8
//   warps, 16 x 16; bf16 4 stages of 128 columns to k 512, 2 above; f32 6
//   stages of 32 columns, 4 above). Query rows past B are zeroed once,
//   never copied. One CTA an SM throughout.
//   After a sub-tile's last slice the selection (select_sub, shared by both
//   kernels) runs on the accumulators in registers (the bias added from
//   float2 loads in the fragment's layout, prefetched to L2 a sub-tile
//   ahead): a thread tests its scores against its queries' bars, the tails
//   of their running lists, where a query's largest score reaches its bar;
//   survivors take slots of their query's candidate buffer in shared
//   memory, one count update for a query's 4 lanes; a warp with no
//   survivor skips that. Scores never pass through shared memory. While
//   some survivor finds its buffer full, every buffer at least half full is
//   merged into its query's sorted list (shared memory, k entries) by one
//   warp: the candidates sorted in registers (a bitonic network), then each
//   output entry found by a binary search along its diagonal (merge path)
//   -- exact under ties (distinct rows, the full rank rule); the waiting
//   survivors are then tested again against the new tails, so a burst of
//   ties, or more survivors than slots, drops nothing. Only how the merge
//   rounds meet differs: in topk_partial_kernel a query's scores are
//   spread over 4 warps, so they meet at a CTA barrier (CtaRounds); on the
//   wgmma route a warp merges its own queries (WarpRounds). The buffers are
//   merged once more at the end of the unit and each list goes to partial
//   slot (query, split).
//   The batch route (QT 128 and 64) first runs the same kernel over a prefix
//   of the corpus (topk_seed_rows: 512 k rows, at most N / 16); each
//   query's k-th best score there is its first bar, reached by k rows, so
//   the scan keeps nothing below it and merges far fewer candidates.
//   Phase 2 (common.cuh's merge_kernel): one warp per query merges its
//   sorted partials by the same rule.
//
// Bound: 2 * B * N * D operations on bf16 inputs and the corpus read once
// (512 x 200,000 x 1024: 209.7 GFLOP, 409.6 MB): the tensor cores' 989
// TFLOP/s bound it at large batch (0.2120 ms), the 3.35 TB/s of device
// memory at one query (0.1223 ms). Both batch routes move the corpus and
// the query slices from L2 once per query tile and sub-tile (at B 512, QT
// 128: 3.28 GB): on an H100 80GB HBM3 at 700 W the TMA ring and wgmma
// products take about 0.52 ms for it, cp.async and mma.sync 1.05-1.11; the
// selection's stops at the 48 sub-tile ends cost about as much again. At
// one query phase 1 streams the corpus at about 2.5 TB/s (0.164-0.169 ms)
// and phase 2 adds about 0.035 ms, its launch and k rounds one after the
// other (PERF.md). Selection overlapped with the next sub-tile's products,
// multicast of the corpus slice across a cluster of query tiles, and phase
// 2 folded into phase 1 at small batch are the next steps (ROADMAP).
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kRows = 128;             // corpus rows per sub-tile
constexpr int kMaxK = 1024;

// Slices of D a ring stage holds: 128 bytes at the 64-query tile, 256 (bf16)
// at the 16-query tile, whose few query rows leave room for deeper corpus
// slices; rows padded by 16 bytes keep 16-byte alignment for cp.async and
// ldmatrix and put the 8 rows of a fragment on distinct banks.
template <typename T, int QT> struct Layout;
template <int QT> struct Layout<__nv_bfloat16, QT> {
  static constexpr int kDk = QT == 16 ? 128 : 64;
  static constexpr int kStride = kDk + 8;
  static constexpr int kVec = 8;                 // elements in 16 bytes
};
template <int QT> struct Layout<float, QT> {
  static constexpr int kDk = 32;
  static constexpr int kStride = kDk + 4;
  static constexpr int kVec = 4;
};

// The warps' share of a QT x 128 tile (QT 64 or 16): kWarpsQ warps down the
// queries, kWarpsR across the rows; kMT m-tiles of 16 queries and kNT
// n-tiles of 8 rows a warp. LK: k above 512 (16-query tiles only).
template <int QT, bool LK = false> struct Tile {
  static constexpr int kWarpsQ = QT == 64 ? 4 : 1;
  static constexpr int kWarpsR = QT == 64 ? 4 : 8;
  static constexpr int kWarps = kWarpsQ * kWarpsR;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kMT = QT / 16 / kWarpsQ;
  static constexpr int kWarpRows = kRows / kWarpsR;
  static constexpr int kNT = kWarpRows / 8;
  static constexpr int kVals = kMT * kNT * 4;    // scores a thread holds
  static constexpr int kMaxK = QT == 64 ? 128 : LK ? ::kMaxK : 512;
  static constexpr int kCand = QT == 64 ? 128 : 64;   // candidate slots a query
  static_assert((QT == 64 || QT == 16) && kNT % 2 == 0 && kVals <= 64, "warp tiles");
};

// Ring stages: what fits beside the lists of the tile's largest k.
template <typename T, int QT, bool LK>
constexpr int kStages = QT == 64 ? 3 : sizeof(T) == 2 ? (LK ? 2 : 4) : (LK ? 4 : 6);

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// Stage columns [c0, c0 + kDk) of rows [row0, row0 + R) of src (n_rows, D)
// into dst (row stride kStride of Layout<T, QT>). Columns at or past D are
// zeros; rows at or past n_rows are zeros (kSkip: left alone, the caller
// zeroed them once). vec: 16-byte cp.async (D and the base 16-byte
// multiples); else plain loads.
template <typename T, int QT, int R, bool kSkip, int kThreads>
__device__ __forceinline__ void stage(const T* __restrict__ src, int64_t row0,
                                      int64_t n_rows, int D, int c0, bool vec,
                                      T* dst) {
  using L = Layout<T, QT>;
  const T* base = src + row0 * D + c0;
  const int rows = n_rows - row0 < R ? (int)(n_rows - row0) : R;
  if (vec) {
    constexpr int kPerRow = L::kDk / L::kVec;
    constexpr int kIters = (R * kPerRow + kThreads - 1) / kThreads;
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int e = threadIdx.x + it * kThreads;
      if ((R * kPerRow) % kThreads != 0 && e >= R * kPerRow) break;
      const int r = e / kPerRow, cv = (e % kPerRow) * L::kVec;
      if (kSkip && r >= rows) continue;
      const bool ok = r < rows && c0 + cv < D;
      cp_async16(dst + r * L::kStride + cv, ok ? base + r * D + cv : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < R * L::kDk; e += kThreads) {
      const int r = e / L::kDk, c = e % L::kDk;
      if (kSkip && r >= rows) continue;
      const bool ok = r < rows && c0 + c < D;
      dst[r * L::kStride + c] = ok ? base[r * D + c] : zero<T>();
    }
  }
}

// One slice's products in the accumulator layout of mma.sync m16n8k16:
// warp w owns queries 16 kMT (w % kWarpsQ) + [0, 16 kMT) and rows
// kWarpRows (w / kWarpsQ) + [0, kWarpRows); acc[(m kNT + j) 4 + i] is query
// 16 (kMT (w % kWarpsQ) + m) + g + 8 (i >> 1) against row
// kWarpRows (w / kWarpsQ) + 8 j + 2 t4 + (i & 1), g = lane / 4, t4 = lane % 4.
template <int QT>
__device__ __forceinline__ void slice_scores(const __nv_bfloat16* __restrict__ qs,
                                             const __nv_bfloat16* __restrict__ es,
                                             float (&acc)[Tile<QT>::kVals]) {
  using Tl = Tile<QT>;
  using Ly = Layout<__nv_bfloat16, QT>;
  constexpr int S = Ly::kStride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wq = warp % Tl::kWarpsQ, wr = warp / Tl::kWarpsQ;
  // ldmatrix row addresses: lanes 8m..8m+7 give the rows of matrix m
  const __nv_bfloat16* qa =
      qs + (16 * Tl::kMT * wq + (lane & 7) + 8 * ((lane >> 3) & 1)) * S + 8 * (lane >> 4);
  const __nv_bfloat16* eb =
      es + (Tl::kWarpRows * wr + (lane & 7) + 8 * (lane >> 4)) * S + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < Ly::kDk; kk += 16) {
    uint32_t a[Tl::kMT][4];
#pragma unroll
    for (int m = 0; m < Tl::kMT; ++m) ldmatrix_x4(a[m], qa + 16 * m * S + kk);
#pragma unroll
    for (int j = 0; j < Tl::kNT; j += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, eb + 8 * j * S + kk);       // n-tiles j and j + 1, both k halves
#pragma unroll
      for (int m = 0; m < Tl::kMT; ++m) {
        mma_bf16(&acc[(m * Tl::kNT + j) * 4], a[m], b[0], b[1]);
        mma_bf16(&acc[(m * Tl::kNT + j + 1) * 4], a[m], b[2], b[3]);
      }
    }
  }
}

template <int QT>
__device__ __forceinline__ void slice_scores(const float* __restrict__ qs,
                                             const float* __restrict__ es,
                                             float (&acc)[Tile<QT>::kVals]) {
  using Tl = Tile<QT>;
  using Ly = Layout<float, QT>;
  constexpr int S = Ly::kStride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wq = warp % Tl::kWarpsQ, wr = warp / Tl::kWarpsQ;
  const float* q0 = qs + (16 * Tl::kMT * wq + g) * S;
  const float* e0 = es + (Tl::kWarpRows * wr + 2 * t4) * S;
#pragma unroll 4
  for (int c = 0; c < Ly::kDk; ++c) {
#pragma unroll
    for (int m = 0; m < Tl::kMT; ++m) {
      const float a0 = q0[16 * m * S + c], a1 = q0[(16 * m + 8) * S + c];
#pragma unroll
      for (int j = 0; j < Tl::kNT; ++j) {
        const float x0 = e0[8 * j * S + c], x1 = e0[(8 * j + 1) * S + c];
        float* d = &acc[(m * Tl::kNT + j) * 4];
        d[0] = fmaf(a0, x0, d[0]);
        d[1] = fmaf(a0, x1, d[1]);
        d[2] = fmaf(a1, x0, d[2]);
        d[3] = fmaf(a1, x1, d[3]);
      }
    }
  }
}

// A (score, row) pair; row -1 is an empty entry, ranked after every other.
struct __align__(8) Entry {
  float v;
  int i;
};

__device__ __forceinline__ bool beats(Entry a, Entry b) { return beats(a.v, a.i, b.v, b.i); }

// Sort a warp's 32 kPerLane entries (entry 32 p + lane in register p),
// best first by the rank rule, empty entries last: a bitonic network,
// shuffles between lanes, register swaps within one.
template <int kPerLane>
__device__ __forceinline__ void warp_sort(Entry (&x)[kPerLane]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32 * kPerLane; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int p = 0; p < kPerLane; ++p) {
        const int e = 32 * p + lane;
        const bool best_first = (e & size) == 0;   // this block's direction
        if (stride >= 32) {                        // the partner is register q
          const int q = p ^ (stride >> 5);
          if (q < p) continue;                     // each pair once, from below
          if (best_first ? beats(x[q], x[p]) : beats(x[p], x[q])) {
            const Entry t = x[p];
            x[p] = x[q];
            x[q] = t;
          }
        } else {
          Entry o;
          o.v = __shfl_xor_sync(kFull, x[p].v, stride);
          o.i = __shfl_xor_sync(kFull, x[p].i, stride);
          const bool keep_better = ((e & stride) == 0) == best_first;
          if (keep_better != beats(x[p], o)) x[p] = o;
        }
      }
    }
  }
}

// Merge the n candidates C, distinct rows in any order, into the sorted
// list L of nf entries, keeping at most k; warp-wide. The candidates are
// sorted in registers (warp_sort) and written back; output entry o of the
// merge is found by a binary search along its diagonal (how many list
// entries are among the first o + 1: "merge path"). Outputs are written
// from the top chunk of 32 down: a chunk reads list entries at or below its
// own positions only. Returns the new length.
template <int kCand>
__device__ int merge_list(Entry* L, int nf, int k, Entry* C, int n) {
  constexpr int kPerLane = kCand / 32;
  const int lane = threadIdx.x & 31;
  Entry x[kPerLane];
#pragma unroll
  for (int p = 0; p < kPerLane; ++p) {
    const int j = 32 * p + lane;
    if (j < n) x[p] = C[j];
    else x[p] = Entry{kNegInf, -1};
  }
  warp_sort(x);
  __syncwarp();
#pragma unroll
  for (int p = 0; p < kPerLane; ++p)
    if (32 * p + lane < n) C[32 * p + lane] = x[p];
  __syncwarp();
  const int n_out = nf + n < k ? nf + n : k;
  for (int base = (n_out - 1) & ~31; base >= 0; base -= 32) {
    const int o = base + lane;
    Entry out{0.0f, -1};
    if (o < n_out) {
      const int d = o + 1;                         // entries taken so far
      int lo = d - n > 0 ? d - n : 0, hi = d < nf ? d : nf;
      while (lo < hi) {                            // list entries among them
        const int mid = (lo + hi) >> 1;
        if (beats(L[mid], C[d - mid - 1])) lo = mid + 1;
        else hi = mid;
      }
      const int i = lo, j = d - lo;
      // entry o is the worse of the last taken from each side
      if (i == 0) {
        out = C[j - 1];
      } else if (j == 0) {
        out = L[i - 1];
      } else {
        const Entry a = L[i - 1], c = C[j - 1];
        out = beats(c, a) ? a : c;
      }
    }
    __syncwarp();
    if (o < n_out) L[o] = out;
    __syncwarp();
  }
  return n_out;
}

// Fetch the bias of rows [r0, r0 + 128) of a tile's nq queries (from q0)
// to L2: one bulk prefetch of each query's row segment where it is 16-byte
// aligned, else one prefetch a 128-byte line; threads tid, tid + stride, ...
// take the queries.
__device__ __forceinline__ void prefetch_bias(const float* bias, int64_t ldb, int q0,
                                              int nq, int r0, int N, int tid, int stride) {
  const int bytes = (N - r0 < kRows ? N - r0 : kRows) * 4;
  for (int x = tid; x < nq; x += stride) {
    const float* p = bias + (int64_t)(q0 + x) * ldb + r0;
    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0 && bytes >= 16) {
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(p), "r"(bytes & ~15));
    } else {
      for (int b = 0; b < bytes; b += 128)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(p + b / 4));
    }
  }
}

// Per-query state of a unit in shared memory.
struct Lists {
  Entry* list;       // QT x k, sorted
  Entry* cand;       // QT x kCand
  int* cnt;          // candidates taken (may pass kCand: the surplus waits)
  int* fill;         // list length
  Entry* tail;       // the list's tail once full, else the seed bar or (kNegInf, -1)
};

// Merge query slot s's buffer of kCand into its list; warp-wide.
template <int kCand>
__device__ __forceinline__ void merge_slot(const Lists& L, int s, int k) {
  const int n = min(L.cnt[s], kCand);
  Entry* list = L.list + (size_t)s * k;
  const int nn = merge_list<kCand>(list, L.fill[s], k, L.cand + s * kCand, n);
  if ((threadIdx.x & 31) == 0) {
    L.fill[s] = nn;
    L.cnt[s] = 0;
    if (nn == k) L.tail[s] = list[k - 1];
  }
  __syncwarp();
}

// ------------------------------------- the selection both routes share
// A thread's scores of a sub-tile, in mma's accumulator layout on both
// routes: acc[(m NT + j) 4 + 2 h + c] is the tile's query slot
// q_base + 16 m + g + 8 h against row row0 + r_base + 8 j + 2 t4 + c
// (g = lane / 4, t4 = lane % 4), and the same bit of a pending mask stands
// for it. Query slot's bar: tl[m][h], the tail of its sorted list.
struct Frag {
  int q_base, r_base, g, t4;
  __device__ __forceinline__ int slot(int m, int h) const { return q_base + 16 * m + g + 8 * h; }
  __device__ __forceinline__ int row(int j, int c) const { return r_base + 8 * j + 2 * t4 + c; }
};

// Add bias_weight * bias (multiplied, then added, as the plain version
// rounds it) to the scores of the tile's nq queries (from q0), rows from
// row0; float2 loads in the fragment's layout where bias_vec.
template <int MT, int NT>
__device__ __forceinline__ void add_bias(float (&acc)[MT * NT * 4], const Frag& f,
                                         const float* __restrict__ bias, int64_t ldb,
                                         float bias_weight, int bias_vec, int q0, int nq,
                                         int row0, int N) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int rb = row0 + f.row(j, 0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int slot = f.slot(m, h);
        if (slot >= nq) continue;
        const float* bp = bias + (int64_t)(q0 + slot) * ldb + rb;
        float b0 = 0.0f, b1 = 0.0f;
        if (bias_vec && rb + 1 < N) {
          const float2 t = *reinterpret_cast<const float2*>(bp);
          b0 = t.x;
          b1 = t.y;
        } else {
          if (rb < N) b0 = bp[0];
          if (rb + 1 < N) b1 = bp[1];
        }
        float* d = &acc[(m * NT + j) * 4 + 2 * h];
        d[0] = __fadd_rn(d[0], __fmul_rn(bias_weight, b0));
        d[1] = __fadd_rn(d[1], __fmul_rn(bias_weight, b1));
      }
    }
}

// Drop the pending scores that do not beat their query's bar by the full
// rule (score, then row).
template <int MT, int NT>
__device__ __forceinline__ uint64_t retest(uint64_t pend, const float (&acc)[MT * NT * 4],
                                           const Frag& f, const Entry (&tl)[MT][2],
                                           int row0) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int b = (m * NT + j) * 4 + i;
        if ((pend >> b & 1) &&
            !beats(acc[b], row0 + f.row(j, i & 1), tl[m][i >> 1].v, tl[m][i >> 1].i))
          pend &= ~(1ull << b);
      }
  return pend;
}

// The pending-mask bits of query slot (m, h): (m NT + j) 4 + 2 h + c for
// every j and c.
template <int NT>
__device__ __forceinline__ uint64_t query_bits(int m, int h) {
  uint64_t b = 0;
#pragma unroll
  for (int j = 0; j < NT; ++j) b |= 3ull << ((m * NT + j) * 4 + 2 * h);
  return b;
}

// Survivors to their query's candidate buffer: the 4 lanes of a query take
// their slots with one update of its count (Rounds::take), which may pass
// kCand; a survivor that finds no slot stays pending. Warp-wide.
template <int MT, int NT, class Rounds>
__device__ __forceinline__ void insert(uint64_t& pend, const float (&acc)[MT * NT * 4],
                                       const Frag& f, int row0, const Lists& L,
                                       const Rounds& rounds) {
  constexpr int kCand = Rounds::kCand;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint64_t mask = query_bits<NT>(m, h);
      if (!__any_sync(kFull, (pend & mask) != 0)) continue;
      const int mine = __popcll(pend & mask);
      int upto = mine;                             // inclusive scan over t4
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const int y = __shfl_up_sync(kFull, upto, off, 4);
        if (f.t4 >= off) upto += y;
      }
      const int total = __shfl_sync(kFull, upto, 3, 4);
      const int slot = f.slot(m, h);
      int pos = 0;
      if (f.t4 == 0 && total > 0) pos = rounds.take(&L.cnt[slot], total);
      pos = __shfl_sync(kFull, pos, 0, 4) + upto - mine;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int b = (m * NT + j) * 4 + 2 * h + c;
          if (!(pend >> b & 1)) continue;
          if (pos < kCand) {
            L.cand[slot * kCand + pos] = Entry{acc[b], row0 + f.row(j, c)};
            pend &= ~(1ull << b);
          }
          ++pos;
        }
    }
}

// How the warps that hold a query's scores share its buffer and meet for
// merge rounds. topk_partial_kernel spreads a query's scores over 4 warps:
// they take buffer slots by a shared-memory atomic, every warp takes part
// in a round, merges slots warp, warp + kWarps, ... and meets the others
// at a CTA barrier.
template <int QT, int kWarps, int kCand_> struct CtaRounds {
  static constexpr int kCand = kCand_;
  __device__ __forceinline__ int take(int* cnt, int n) const { return atomicAdd(cnt, n); }
  __device__ __forceinline__ bool any(bool p) const { return __syncthreads_or(p); }
  __device__ __forceinline__ void merge(const Lists& L, int k) const {
    for (int s = threadIdx.x >> 5; s < QT; s += kWarps)
      if (L.cnt[s] >= kCand / 2) merge_slot<kCand>(L, s, k);
    __syncthreads();
  }
};

// topk_wgmma_kernel: a warp holds all scores of its 16 queries (from
// q_base): one lane of a query updates its count, and the warp merges
// their buffers alone.
template <int kCand_> struct WarpRounds {
  static constexpr int kCand = kCand_;
  int q_base;
  __device__ __forceinline__ int take(int* cnt, int n) const {
    const int pos = *cnt;
    *cnt = pos + n;
    return pos;
  }
  __device__ __forceinline__ bool any(bool p) const { return __any_sync(kFull, p); }
  __device__ __forceinline__ void merge(const Lists& L, int k) const {
    __syncwarp();
    for (int s = q_base; s < q_base + 16; ++s)
      if (L.cnt[s] >= kCand / 2) merge_slot<kCand>(L, s, k);
  }
};

// Select on a complete sub-tile's scores (rows from row0; whole: no row or
// query masked). A score survives when it beats its query's bar: a query
// whose largest score is below its bar is skipped, the others compared (at
// least the bar), then the few that pass tested by the full rule. Survivors
// go to their buffers; while one waits for a free slot, every buffer at
// least half full is merged (a bitonic sort, then merge path: exact under
// ties), the bars refreshed from the lists' tails and the waiting survivors
// tested again, so a burst of ties, or more survivors than slots, drops
// nothing. Scores never pass through shared memory.
template <int MT, int NT, class Rounds>
__device__ __forceinline__ void select_sub(const float (&acc)[MT * NT * 4], Entry (&tl)[MT][2],
                                           const Frag& f, const Lists& L, const Rounds& rounds,
                                           int k, int row0, int N, int nq, bool whole) {
  uint64_t pend = 0;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float top = acc[m * NT * 4 + 2 * h];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        top = fmaxf(top, fmaxf(acc[(m * NT + j) * 4 + 2 * h], acc[(m * NT + j) * 4 + 2 * h + 1]));
      if (top < tl[m][h].v) continue;
      const bool live = f.slot(m, h) < nq;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int b = (m * NT + j) * 4 + 2 * h + c;
          if (acc[b] >= tl[m][h].v && (whole || (live && row0 + f.row(j, c) < N)))
            pend |= 1ull << b;
        }
    }
  if (pend) pend = retest<MT, NT>(pend, acc, f, tl, row0);
  while (true) {
    if (__any_sync(kFull, pend != 0)) insert<MT, NT>(pend, acc, f, row0, L, rounds);
    if (!rounds.any(pend != 0)) break;
    rounds.merge(L, k);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) tl[m][h] = L.tail[f.slot(m, h)];
    pend = retest<MT, NT>(pend, acc, f, tl, row0);
  }
}

template <typename T, int QT, bool LK>
constexpr size_t smem_bytes(int k) {
  return (size_t)kStages<T, QT, LK> * (QT + kRows) * Layout<T, QT>::kStride * sizeof(T) +
         (size_t)QT * k * sizeof(Entry) + (size_t)QT * Tile<QT, LK>::kCand * sizeof(Entry) +
         (size_t)QT * (8 + sizeof(Entry));
}

// Phase 1 on mma.sync: unit blockIdx.x = split * q_tiles + query tile; the
// split is sub-tiles [split * per, (split + 1) * per) of the corpus.
template <typename T, int QT, bool LK>
__global__ void __launch_bounds__(Tile<QT, LK>::kThreads, 1)
topk_partial_kernel(const T* __restrict__ q, const T* __restrict__ e,
                    const float* __restrict__ bias, int64_t ldb, float bias_weight,
                    int bias_vec, const float* __restrict__ seed, int B, int N, int D,
                    int k, int vec, int per, float* __restrict__ part_v,
                    int32_t* __restrict__ part_i) {
  using Ly = Layout<T, QT>;
  using Tl = Tile<QT, LK>;
  constexpr int kSt = kStages<T, QT, LK>;
  constexpr int kCand = Tl::kCand;
  constexpr int kStageElems = (QT + kRows) * Ly::kStride;
  const int q_tiles = (B + QT - 1) / QT;
  const int splits = gridDim.x / q_tiles;
  const int split = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * QT;
  const int nq = B - q0 < QT ? B - q0 : QT;
  const int n_sub = (N + kRows - 1) / kRows;
  const int sub_lo = split * per;
  const int sub_hi = sub_lo + per < n_sub ? sub_lo + per : n_sub;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  Lists L;
  L.list = reinterpret_cast<Entry*>(smem_raw + (size_t)kSt * kStageElems * sizeof(T));
  L.cand = L.list + (size_t)QT * k;
  L.tail = L.cand + QT * kCand;
  L.cnt = reinterpret_cast<int*>(L.tail + QT);
  L.fill = L.cnt + QT;
  // a seed bar: any score at least seed[q] (the k-th best of a prefix of
  // the corpus, so at least k rows reach it)
  auto first_tail = [&](int s) {
    return seed != nullptr && s < nq ? Entry{seed[q0 + s], 0x7fffffff}
                                     : Entry{kNegInf, -1};
  };
  for (int s = threadIdx.x; s < QT; s += Tl::kThreads) {
    L.cnt[s] = 0;
    L.fill[s] = 0;
    L.tail[s] = first_tail(s);
  }
  // the bias of a sub-tile is fetched to L2 one sub-tile ahead
  auto prefetch_sub = [&](int sub) {
    if (bias != nullptr && sub < sub_hi)
      prefetch_bias(bias, ldb, q0, nq, sub * kRows, N, threadIdx.x, Tl::kThreads);
  };
  prefetch_sub(sub_lo);
  // query rows past B: zeroed once in every stage, never copied
  for (int x = threadIdx.x; x < kSt * (QT - nq) * Ly::kStride; x += Tl::kThreads) {
    const int per_stage = (QT - nq) * Ly::kStride;
    ring[(x / per_stage) * kStageElems + nq * Ly::kStride + x % per_stage] = zero<T>();
  }

  const int n_chunks = (D + Ly::kDk - 1) / Ly::kDk;
  const int steps = sub_lo < sub_hi ? (sub_hi - sub_lo) * n_chunks : 0;
  int ld_sub = sub_lo, ld_c0 = 0;              // the next (sub-tile, slice) to stage
  auto load_next = [&](int buf) {
    T* qs = ring + buf * kStageElems;
    stage<T, QT, QT, true, Tl::kThreads>(q, q0, B, D, ld_c0, vec, qs);
    stage<T, QT, kRows, false, Tl::kThreads>(e, (int64_t)ld_sub * kRows, N, D, ld_c0, vec,
                                             qs + QT * Ly::kStride);
    ld_c0 += Ly::kDk;
    if (ld_c0 >= D) {
      ld_c0 = 0;
      ++ld_sub;
    }
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wq = warp % Tl::kWarpsQ, wr = warp / Tl::kWarpsQ;
  const Frag f{16 * Tl::kMT * wq, Tl::kWarpRows * wr, lane >> 2, lane & 3};
  const CtaRounds<QT, Tl::kWarps, kCand> rounds{};
  float acc[Tl::kVals];
#pragma unroll
  for (int i = 0; i < Tl::kVals; ++i) acc[i] = 0.0f;
  Entry tl[Tl::kMT][2];                        // this thread's queries' bars
#pragma unroll
  for (int m = 0; m < Tl::kMT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) tl[m][h] = first_tail(f.slot(m, h));

  for (int s = 0; s < kSt - 1; ++s) {
    if (s < steps) load_next(s);
    cp_async_commit();
  }
  int buf_ld = kSt - 1, buf_use = 0, use_chunk = 0, use_sub = sub_lo;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kSt - 2>();       // this thread's copies for `step` landed
    __syncthreads();                // everyone's did; step - 1's buffer is free
    if (step + kSt - 1 < steps) load_next(buf_ld);
    cp_async_commit();
    buf_ld = buf_ld + 1 == kSt ? 0 : buf_ld + 1;
    const T* qs = ring + buf_use * kStageElems;
    slice_scores<QT>(qs, qs + QT * Ly::kStride, acc);
    buf_use = buf_use + 1 == kSt ? 0 : buf_use + 1;
    if (++use_chunk < n_chunks) continue;
    use_chunk = 0;

    // the sub-tile is complete: select on the accumulators
    const int row0 = use_sub * kRows;
    ++use_sub;
    prefetch_sub(use_sub);
    if (bias != nullptr)
      add_bias<Tl::kMT, Tl::kNT>(acc, f, bias, ldb, bias_weight, bias_vec, q0, nq, row0, N);
    select_sub<Tl::kMT, Tl::kNT>(acc, tl, f, L, rounds, k, row0, N, nq,
                                 row0 + kRows <= N && nq == QT);
#pragma unroll
    for (int i = 0; i < Tl::kVals; ++i) acc[i] = 0.0f;
  }
  cp_async_wait<0>();
  __syncthreads();                  // every insertion (and the init) visible
  for (int s = warp; s < nq; s += Tl::kWarps) {
    if (L.cnt[s] > 0) merge_slot<kCand>(L, s, k);
    const int64_t out = ((int64_t)(q0 + s) * splits + split) * k;
    const int nf = L.fill[s];
    const Entry* list = L.list + (size_t)s * k;
    for (int i = lane; i < k; i += 32) {
      const Entry x = i < nf ? list[i] : Entry{kNegInf, -1};
      part_v[out + i] = x.v;
      part_i[out + i] = x.i;
    }
  }
}

template <typename T, int QT, bool LK>
int set_smem(int k) {
  return (int)cudaFuncSetAttribute(topk_partial_kernel<T, QT, LK>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_bytes<T, QT, LK>(k));
}

template <typename T, int QT, bool LK>
int resident(int k, int* per_sm) {
  const int err = set_smem<T, QT, LK>(k);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, topk_partial_kernel<T, QT, LK>, Tile<QT, LK>::kThreads,
      smem_bytes<T, QT, LK>(k));
}

// One launch's operands (anorag_dense_topk's arguments, checked).
struct Args {
  const void* q;
  const void* e;
  const float* bias;
  long long ldb;
  float bias_weight;
  int bias_vec;
  const float* seed;
  int B, N, D, k, vec, splits, per;
  float* part_v;
  int32_t* part_i;
};

template <typename T, int QT, bool LK>
int launch(const Args& a, cudaStream_t s) {
  const int err = set_smem<T, QT, LK>(a.k);
  if (err) return err;
  const int q_tiles = (a.B + QT - 1) / QT;
  topk_partial_kernel<T, QT, LK><<<(unsigned)(q_tiles * a.splits),
                                   Tile<QT, LK>::kThreads, smem_bytes<T, QT, LK>(a.k), s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.e), a.bias, a.ldb,
      a.bias_weight, a.bias_vec, a.seed, a.B, a.N, a.D, a.k, a.vec, a.per, a.part_v,
      a.part_i);
  return (int)cudaGetLastError();
}

// The mma.sync instance for (dtype, q_tile 64 or 16, k), called as
// fn<T, QT, LK>(args...).
template <template <typename, int, bool> class Fn, typename... A>
int dispatch(int dtype, int q_tile, int k, A... args) {
  const bool lk = k > Tile<16>::kMaxK;
  if (dtype == 1)
    return lk ? Fn<float, 16, true>::run(args...) : Fn<float, 16, false>::run(args...);
  if (q_tile == 64) return Fn<__nv_bfloat16, 64, false>::run(args...);
  return lk ? Fn<__nv_bfloat16, 16, true>::run(args...)
            : Fn<__nv_bfloat16, 16, false>::run(args...);
}

template <typename T, int QT, bool LK> struct Resident {
  static int run(int k, int* per_sm) { return resident<T, QT, LK>(k, per_sm); }
};
template <typename T, int QT, bool LK> struct Launch {
  static int run(const Args* a, cudaStream_t s) { return launch<T, QT, LK>(*a, s); }
};

// ------------------------------------------------- the wgmma route (bf16)
// 128-query tiles at k <= 32 with 16-byte rows: a producer thread keeps a
// ring of TMA loads (128-byte swizzled slices of the tile's queries and of
// a 128-row sub-tile) in flight behind mbarriers; two consumer warpgroups,
// 64 queries each, run wgmma m64n128k16 on them, so each warp holds all 128
// rows of its 16 queries and selects on its accumulators without a CTA
// barrier (the warp merges its own queries' buffers).
constexpr int kWgStages = 4;
constexpr int kWgMaxK = 32;                    // the lists beside the ring
constexpr int kWgCand = 32;                    // candidate slots a query
constexpr int kWgSlice = kSliceCols;           // columns of D a stage
constexpr int kWgRowBytes = kWgSlice * 2;      // a slice's row: 128 bytes
constexpr int kWgThreads = 384;                // 2 consumer warpgroups + producer

size_t wg_smem_bytes(int k) {
  return 1024 + (size_t)kWgStages * 2 * kRows * kWgRowBytes + (size_t)128 * k * sizeof(Entry) +
         (size_t)128 * kWgCand * sizeof(Entry) + (size_t)128 * (8 + sizeof(Entry)) +
         (size_t)kWgStages * 2 * 8;
}

// Phase 1 on the wgmma route: unit blockIdx.x as topk_partial_kernel's.
__global__ void __launch_bounds__(kWgThreads, 1)
topk_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap emap,
                  const float* __restrict__ bias, int64_t ldb, float bias_weight,
                  int bias_vec, const float* __restrict__ seed, int B, int N, int D,
                  int k, int per, float* __restrict__ part_v,
                  int32_t* __restrict__ part_i) {
  constexpr int QT = 128;
  const int q_tiles = (B + QT - 1) / QT;
  const int splits = gridDim.x / q_tiles;
  const int split = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * QT;
  const int nq = B - q0 < QT ? B - q0 : QT;
  const int n_sub = (N + kRows - 1) / kRows;
  const int sub_lo = split * per;
  const int sub_hi = sub_lo + per < n_sub ? sub_lo + per : n_sub;
  const int n_chunks = (D + kWgSlice - 1) / kWgSlice;
  const int steps = sub_lo < sub_hi ? (sub_hi - sub_lo) * n_chunks : 0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  constexpr int kTileBytes = kRows * kWgRowBytes;   // a stage's slice of either
  unsigned char* qs = base;                                  // stages x 128 queries
  unsigned char* es = base + kWgStages * kTileBytes;         // stages x 128 rows
  Lists L;
  L.list = reinterpret_cast<Entry*>(es + kWgStages * kTileBytes);
  L.cand = L.list + (size_t)QT * k;
  L.tail = L.cand + QT * kWgCand;
  L.cnt = reinterpret_cast<int*>(L.tail + QT);
  L.fill = L.cnt + QT;
  uint64_t* full = reinterpret_cast<uint64_t*>(L.fill + QT);
  uint64_t* empty = full + kWgStages;

  auto first_tail = [&](int s) {
    return seed != nullptr && s < nq ? Entry{seed[q0 + s], 0x7fffffff}
                                     : Entry{kNegInf, -1};
  };
  for (int s = threadIdx.x; s < QT; s += kWgThreads) {
    L.cnt[s] = 0;
    L.fill[s] = 0;
    L.tail[s] = first_tail(s);
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {                                  // the producer warpgroup
    if (threadIdx.x != 256) return;
    for (int t = 0; t < steps; ++t) {
      const int st = t % kWgStages;
      if (t >= kWgStages) mbar_wait(&empty[st], ((t / kWgStages) & 1) ^ 1);
      const int sub = sub_lo + t / n_chunks, c0 = (t % n_chunks) * kWgSlice;
      if (c0 == 0 && bias != nullptr)            // the sub-tile's bias to L2
        prefetch_bias(bias, ldb, q0, nq, sub * kRows, N, 0, 1);
      mbar_expect_tx(&full[st], 2 * kTileBytes);
      tma_load(qs + st * kTileBytes, &qmap, &full[st], c0, q0);
      tma_load(es + st * kTileBytes, &emap, &full[st], c0, sub * kRows);
    }
    return;
  }

  // a consumer warp: queries f.slot(0, 0) and f.slot(0, 1) of the tile, all 128 rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Frag f{16 * warp, 0, lane >> 2, lane & 3};
  const WarpRounds<kWgCand> rounds{f.q_base};
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  Entry tl[1][2] = {{first_tail(f.slot(0, 0)), first_tail(f.slot(0, 1))}};
  for (int t = 0; t < steps; ++t) {
    const int st = t % kWgStages, chunk = t % n_chunks;
    mbar_wait(&full[st], (t / kWgStages) & 1);
    wgmma_fence_regs(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    const uint64_t da = sw128_desc(qs + st * kTileBytes + wg * 64 * kWgRowBytes);
    const uint64_t db = sw128_desc(es + st * kTileBytes);
#pragma unroll
    for (int kk = 0; kk < kWgSlice / 16; ++kk)     // 32 bytes of K a step
      wgmma_m64n128(acc, da + 2 * kk, db + 2 * kk, chunk != 0 || kk != 0);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    // one slice's products in flight behind this one: the slice before is
    // done, and its stage goes back to the producer
    const bool leader = (threadIdx.x & 127) == 0;
    if (chunk + 1 < n_chunks) {
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      if (leader && chunk > 0) mbar_arrive(&empty[(t - 1) % kWgStages]);
      continue;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    wgmma_fence_regs(acc);
    if (leader) {
      if (chunk > 0) mbar_arrive(&empty[(t - 1) % kWgStages]);
      mbar_arrive(&empty[st]);
    }

    // the sub-tile is complete: select on the accumulators, within the warp
    const int row0 = (sub_lo + t / n_chunks) * kRows;
    if (bias != nullptr)
      add_bias<1, 16>(acc, f, bias, ldb, bias_weight, bias_vec, q0, nq, row0, N);
    select_sub<1, 16>(acc, tl, f, L, rounds, k, row0, N, nq, row0 + kRows <= N && nq == QT);
  }
  // the warp's queries: last merge and write-out
  __syncwarp();
  for (int s = f.q_base; s < f.q_base + 16 && s < nq; ++s) {
    if (L.cnt[s] > 0) merge_slot<kWgCand>(L, s, k);
    const int64_t out = ((int64_t)(q0 + s) * splits + split) * k;
    const int nf = L.fill[s];
    const Entry* list = L.list + (size_t)s * k;
    for (int i = lane; i < k; i += 32) {
      const Entry x = i < nf ? list[i] : Entry{kNegInf, -1};
      part_v[out + i] = x.v;
      part_i[out + i] = x.i;
    }
  }
}

int wgmma_set_smem(int k) {
  return (int)cudaFuncSetAttribute(topk_wgmma_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)wg_smem_bytes(k));
}

int launch_wgmma(const Args& a, cudaStream_t s) {
  CUtensorMap qmap, emap;
  int err = make_map(&qmap, a.q, a.B, a.D, a.D, 128);
  if (!err) err = make_map(&emap, a.e, a.N, a.D, a.D, kRows);
  if (!err) err = wgmma_set_smem(a.k);
  if (err) return err;
  const int q_tiles = (a.B + 127) / 128;
  topk_wgmma_kernel<<<(unsigned)(q_tiles * a.splits), kWgThreads, wg_smem_bytes(a.k), s>>>(
      qmap, emap, a.bias, a.ldb, a.bias_weight, a.bias_vec, a.seed, a.B, a.N, a.D, a.k,
      a.per, a.part_v, a.part_i);
  return (int)cudaGetLastError();
}

// The tile takes (dtype, k, vec): bf16 at 128 queries to k 32 with 16-byte
// rows (the wgmma route, TMA's row stride), at 64 to k 128, at 16 to k
// 1024; f32 only at 16 (ops/topk.py topk_tiles).
bool bad_tile(int dtype, int q_tile, int k, int vec) {
  if (k < 1 || k > kMaxK) return true;
  if (dtype == 1) return q_tile != 16;
  if (q_tile == 128) return k > kWgMaxK || !vec;
  if (q_tile == 64) return k > Tile<64>::kMaxK;
  return q_tile != 16;
}

}  // namespace

// CTAs of the phase-1 kernel for dtype (0 bf16, 1 f32), q_tile, k and vec
// (anorag_dense_topk's) that the card holds at once: per SM times the SMs.
// Returns minus the CUDA error code on failure.
extern "C" int anorag_topk_slots(int dtype, int q_tile, int k, int vec, int device) {
  if (bad_tile(dtype, q_tile, k, vec)) return -(int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  int per_sm = 0, sms = 0;
  if (!err && q_tile == 128) {
    err = wgmma_set_smem(k);
    if (!err)
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, topk_wgmma_kernel, kWgThreads, wg_smem_bytes(k));
  } else if (!err) {
    err = dispatch<Resident>(dtype, q_tile, k, k, &per_sm);
  }
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err) return -err;
  return per_sm * sms > 0 ? per_sm * sms : 1;
}

// dtype 0 = bf16, 1 = f32. q (B, D), e (N, D); bias f32 or null, row q's
// scores at bias + q ldb (ldb >= N), bias_vec 1 when its rows can be read
// as float2 (ldb even, 8-byte base); seed (B) f32 or null, a bar per query
// that at least k rows reach (a score below it is never kept). The plan:
// tiles of q_tile queries, splits of per 128-row sub-tiles covering the N
// rows, none empty (ops/topk.py topk_work_plan). part_v / part_i (B,
// splits, k) scratch, out (B, k). Returns the CUDA error code (0 on
// success); launches on `stream` of CUDA device `device`.
extern "C" int anorag_dense_topk(const void* q, const void* e, const void* bias,
                                 long long ldb, float bias_weight, int bias_vec,
                                 const void* seed, int dtype, long long B, long long N,
                                 int D, int k, int vec, int q_tile, int splits, int per,
                                 void* part_v, void* part_i, void* out_v, void* out_i,
                                 int device, void* stream) {
  if (B <= 0) return 0;
  const long long n_sub = (N + kRows - 1) / kRows;
  if (bad_tile(dtype, q_tile, k, vec) || D < 1 || N < 1 || N > 0x7fffff00LL ||
      B > 0x7fffffffLL || splits < 1 || splits > kMaxLists || per < 1 ||
      (long long)splits * per < n_sub || (long long)(splits - 1) * per >= n_sub ||
      (B + q_tile - 1) / q_tile * splits > 0x7fffffffLL || (bias && ldb < N))
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, e, static_cast<const float*>(bias), ldb, bias_weight, bias_vec,
               static_cast<const float*>(seed), (int)B, (int)N, D, k, vec, splits, per,
               static_cast<float*>(part_v), static_cast<int32_t*>(part_i)};
  err = q_tile == 128 ? launch_wgmma(a, s) : dispatch<Launch>(dtype, q_tile, k, &a, s);
  if (err) return err;
  return merge(a.part_v, a.part_i, B, splits, k, static_cast<float*>(out_v),
               static_cast<int32_t*>(out_i), s);
}
