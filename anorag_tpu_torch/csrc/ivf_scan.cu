// IVF scan for Hopper (sm_90a): the exact top-k over the probed clusters of
// a cluster-sorted corpus, each cluster scanned once per tile of the
// queries that probe it. Plain C interface for ctypes.
//
// Replaces anorag_tpu/ops/ivf.py::_ivf_kernel (:119), via
// _ivf_search_pallas (:185).
// Function: q (B, D) and the cluster-sorted corpus e (n_rows, D) in one
// dtype (bf16 or f32), products summed in f32. For each query, the k best
// rows by (score descending, row ascending) among the rows of its clusters
// (its row of sel) that lie in a scanned block; output sorted that way,
// slots never filled (-3.0e38, -1). Cluster c holds the rows
// [offsets[c], offsets[c + 1]): the corpus is sorted by cluster, so each
// cluster is contiguous.
//
// Design. A one-CTA kernel (plan_kernel) inverts sel into a work plan on
// the device (no host sync): the distinct (query, probe slot) pairs sorted
// by cluster and cut into tiles of QT queries of one cluster, at most
// max_tiles of them, and each tile's cluster rows cut into splits of whole
// 64-row sub-tiles, as many in proportion to the rows as make the (tile,
// split) units about the CTAs the card holds at once: one wave of CTAs of
// about equal work.
//   Phase 1, one CTA per unit (the grid a bound on the units; surplus CTAs
//   exit): it scores its tile's queries against only its split's rows, so
//   no row is tested for its cluster and no product is thrown away except
//   the padding of a part-full tile.
//   Rows of unscanned blocks are zero-filled, never read, and masked. The
//   tile's queries (gathered by row) and the corpus rows stream through a
//   cp.async ring (2 stages at QT 64, 3 at 16) in slices of D (128 columns
//   for bf16, 64 for f32). bf16 slices go to the tensor cores: 8 warps run
//   mma.sync m16n8k16 with f32 accumulators over the QT x 64 tile,
//   fragments from ldmatrix; f32 slices are summed by FMAs in the same
//   accumulator layout.
//   After a sub-tile's last slice the scores pass through shared memory to
//   the warps that merge them, QT / 8 queries to a warp, into each query's
//   running list in shared memory: filled first, score descending, row
//   ascending; a score enters only past the tail, which the warp keeps in
//   registers, so a sub-tile with nothing to insert costs one ballot a
//   query and 32 rows. Each list is written to partial slot (query, probe
//   slot * max_splits + split); the wrapper fills every slot with
//   (-3.0e38, -1) first, so a slot no CTA owns (a dropped pair, an empty
//   split) stays empty.
//   Phase 2: one warp per query merges its sorted partials by the same
//   rule (common.cuh's merge_kernel; more than 256 lists merge in
//   two levels of at most 256).
// QT is 64 where k <= 128 (the lists take 64 x 128 x 8 = 64 KB) and the
// batch gives a probed cluster 32 or more queries on average, else 16 (k up
// to 1024, or a small batch, where a 64-query tile would be mostly padding).
//
// Bound: the rows of the scanned blocks read once (bytes) against 2 * D
// operations for each row each query must score (sum over queries of their
// clusters' sizes). At 512 queries x 5,000,000 x 1024 bf16, nlist 20,
// nprobe 4: 10.26 GB against 1.05 TFLOP, 3.06 ms against 1.06 ms, so bytes
// bound it; one query is bound by its 1,005 blocks' 2.06 GB. This design
// reads a cluster once per query tile (about 2 tiles a cluster at B 512,
// some of it from L2), does the padding of part-full tiles (about 1.3
// TFLOP in all), re-stages the query slices for every sub-tile and runs
// mma.sync on 8 warps, two CTAs an SM at QT 64 and k 20; wgmma fed by TMA,
// resident queries and warp specialisation are the next steps (ROADMAP).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;                  // corpus rows per sub-tile
constexpr int kMaxK = 1024;
constexpr int kSmallK = 128;               // largest k of the 64-query tile
constexpr int kScStride = kRows + 8;       // f32 scores: float2 stores bank-free

// Slices of D staged per step. Rows of 272 bytes keep 16-byte alignment for
// cp.async and ldmatrix and put the 8 rows of a fragment on distinct banks.
template <typename T> struct Layout;
template <> struct Layout<__nv_bfloat16> {
  static constexpr int kDk = 128;
  static constexpr int kStride = kDk + 8;
  static constexpr int kVec = 8;           // elements in 16 bytes
};
template <> struct Layout<float> {
  static constexpr int kDk = 64;
  static constexpr int kStride = kDk + 4;
  static constexpr int kVec = 4;
};

// The warps' share of a QT x 64 tile: kWarpsQ warps down the queries (16
// each), kWarpsR across the rows; kNJ mma n-tiles of 8 rows a warp.
template <int QT> struct Tile {
  static constexpr int kWarpsQ = QT / 16;
  static constexpr int kWarpsR = kWarps / kWarpsQ;
  static constexpr int kWarpRows = kRows / kWarpsR;
  static constexpr int kNJ = kWarpRows / 8;
  static constexpr int kQPerWarp = QT / kWarps;   // queries a warp merges
  // slices in the cp.async ring: 2 at 64 queries (99 KB of shared memory at
  // k 20, so two CTAs an SM), 3 at 16
  static constexpr int kStages = QT == 64 ? 2 : 3;
  static_assert(kWarpsQ * kWarpsR == kWarps && kNJ >= 1 && kQPerWarp >= 1,
                "the warps tile the queries x rows");
  static_assert(kNJ == 1 || kNJ % 2 == 0, "n-tiles load in pairs");
};

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// Which rows of a sub-tile count: the first n (the cluster's end), those
// before `edge` when block a is scanned, those from `edge` on when block b
// is (64 rows span at most two blocks, since block_rows is a multiple of 64).
struct RowMask {
  int n, edge;
  bool a, b;
  __device__ __forceinline__ bool ok(int r) const {
    return r < n && (r < edge ? a : b);
  }
};

__device__ __forceinline__ RowMask row_mask(int64_t row0, int64_t hi,
                                            const uint8_t* __restrict__ scanned,
                                            int block_rows) {
  RowMask m;
  const int64_t left = hi - row0;
  m.n = left < kRows ? (int)left : kRows;
  const int64_t blk = row0 / block_rows;
  m.edge = (int)((blk + 1) * block_rows - row0);
  m.a = scanned[blk] != 0;
  m.b = m.edge < m.n && scanned[blk + 1] != 0;
  return m;
}

// Stage columns [c0, c0 + kDk) of R rows into dst (row stride kStride):
// row r of the tile is src row rows[r] (queries: rows from shared memory,
// -1 for an empty slot) or row0 + r under `mask` (corpus). Rows that do not
// count and columns at or past D are zeros and are not read. vec: 16-byte
// cp.async (D and the base 16-byte multiples); else plain loads.
template <typename T, int R, bool kGather>
__device__ __forceinline__ void stage(const T* __restrict__ src, const int* rows,
                                      int64_t row0, RowMask mask, int D, int c0,
                                      bool vec, T* dst) {
  using L = Layout<T>;
  if (vec) {
    constexpr int kPerRow = L::kDk / L::kVec;
    for (int e = threadIdx.x; e < R * kPerRow; e += kThreads) {
      const int r = e / kPerRow, cv = (e % kPerRow) * L::kVec;
      const int64_t row = kGather ? rows[r] : row0 + r;
      const bool ok = (kGather ? row >= 0 : mask.ok(r)) && c0 + cv < D;
      const T* p = ok ? src + row * D + (c0 + cv) : src;
      cp_async16(dst + r * L::kStride + cv, p, ok);
    }
  } else {
    for (int e = threadIdx.x; e < R * L::kDk; e += kThreads) {
      const int r = e / L::kDk, c = e % L::kDk;
      const int64_t row = kGather ? rows[r] : row0 + r;
      const bool ok = (kGather ? row >= 0 : mask.ok(r)) && c0 + c < D;
      dst[r * L::kStride + c] = ok ? src[row * D + (c0 + c)] : zero<T>();
    }
  }
}

// One slice's products, in the accumulator layout of mma.sync m16n8k16:
// warp w owns queries 16 (w % kWarpsQ) + [0, 16) and rows
// kWarpRows (w / kWarpsQ) + [0, kWarpRows); acc[j][i] is query
// 16 (w % kWarpsQ) + g + 8 (i >> 1) against row
// kWarpRows (w / kWarpsQ) + 8 j + 2 t4 + (i & 1), g = lane / 4, t4 = lane % 4.
template <int QT>
__device__ __forceinline__ void slice_scores(const __nv_bfloat16* __restrict__ qs,
                                             const __nv_bfloat16* __restrict__ es,
                                             float acc[][4]) {
  using Tl = Tile<QT>;
  constexpr int S = Layout<__nv_bfloat16>::kStride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wq = warp % Tl::kWarpsQ, wr = warp / Tl::kWarpsQ;
  // ldmatrix row addresses: lanes 8m..8m+7 give the rows of matrix m (x2
  // reads lanes 0-15 only; the rest repeat them, so every address is valid)
  const int lb = Tl::kNJ == 1 ? lane & 15 : lane;
  const __nv_bfloat16* qa =
      qs + (16 * wq + (lane & 7) + 8 * ((lane >> 3) & 1)) * S + 8 * (lane >> 4);
  const __nv_bfloat16* eb =
      es + (Tl::kWarpRows * wr + (lb & 7) + 8 * (lb >> 4)) * S + 8 * ((lb >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < Layout<__nv_bfloat16>::kDk; kk += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, qa + kk);
    if constexpr (Tl::kNJ == 1) {
      uint32_t b[2];
      ldmatrix_x2(b, eb + kk);             // lanes 0-15: rows 0-7, k halves
      mma_bf16(acc[0], a, b[0], b[1]);
    } else {
#pragma unroll
      for (int j = 0; j < Tl::kNJ; j += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, eb + 8 * j * S + kk);
        mma_bf16(acc[j], a, b[0], b[1]);
        mma_bf16(acc[j + 1], a, b[2], b[3]);
      }
    }
  }
}

template <int QT>
__device__ __forceinline__ void slice_scores(const float* __restrict__ qs,
                                             const float* __restrict__ es,
                                             float acc[][4]) {
  using Tl = Tile<QT>;
  constexpr int S = Layout<float>::kStride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wq = warp % Tl::kWarpsQ, wr = warp / Tl::kWarpsQ;
  const float* q0 = qs + (16 * wq + g) * S;
  const float* q1 = q0 + 8 * S;
  const float* e0 = es + (Tl::kWarpRows * wr + 2 * t4) * S;
#pragma unroll 4
  for (int c = 0; c < Layout<float>::kDk; ++c) {
    const float a0 = q0[c], a1 = q1[c];
#pragma unroll
    for (int j = 0; j < Tl::kNJ; ++j) {
      const float x0 = e0[8 * j * S + c], x1 = e0[(8 * j + 1) * S + c];
      acc[j][0] = fmaf(a0, x0, acc[j][0]);
      acc[j][1] = fmaf(a0, x1, acc[j][1]);
      acc[j][2] = fmaf(a1, x0, acc[j][2]);
      acc[j][3] = fmaf(a1, x1, acc[j][3]);
    }
  }
}

// Insert the (s, row) of the lanes in `mask` into the sorted list (V, I)
// of nf entries, at most k, one lane at a time. Warp-wide.
__device__ void insert(unsigned mask, float s, int row, float* V, int32_t* I,
                       int& nf, int k) {
  const int lane = threadIdx.x & 31;
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const float cv = __shfl_sync(kFull, s, src);
    const int ci = __shfl_sync(kFull, row, src);
    if (nf == k && !beats(cv, ci, V[k - 1], I[k - 1])) continue;
    int cnt = 0;
    for (int p = lane; p < nf; p += 32) cnt += beats(V[p], I[p], cv, ci);
    const int pos = __reduce_add_sync(kFull, cnt);
    const int nn = nf + 1 < k ? nf + 1 : k;
    // shift [pos, nn - 1) up by one slot, the top chunk of 32 first
    for (int top = nn - 1; top > pos; top -= 32) {
      const int p = top - lane;
      const bool act = p > pos;
      float v = 0.0f;
      int32_t id = 0;
      if (act) {
        v = V[p - 1];
        id = I[p - 1];
      }
      __syncwarp();
      if (act) {
        V[p] = v;
        I[p] = id;
      }
      __syncwarp();
    }
    if (lane == 0) {
      V[pos] = cv;
      I[pos] = ci;
    }
    __syncwarp();
    nf = nn;
  }
}

template <typename T, int QT>
constexpr size_t smem_bytes(int k) {
  return (size_t)Tile<QT>::kStages * (QT + kRows) * Layout<T>::kStride * sizeof(T) +
         (size_t)QT * kScStride * 4 + (size_t)QT * k * 8 + (size_t)QT * 4;
}

// Phase 1: unit blockIdx.x of the plan, one split of one tile's cluster
// rows. tiles holds five rows of max_tiles: cluster, first entry in pairs,
// query count, splits, and the running sum of the splits (units end).
template <typename T, int QT>
__global__ void __launch_bounds__(kThreads)
ivf_partial_kernel(const T* __restrict__ q, const T* __restrict__ e, int D,
                   int vec, const int64_t* __restrict__ offsets,
                   const uint8_t* __restrict__ scanned, int block_rows,
                   const int32_t* __restrict__ pairs,
                   const int32_t* __restrict__ tiles, int max_tiles, int nprobe,
                   int max_splits, int list_stride, int k,
                   float* __restrict__ part_v, int32_t* __restrict__ part_i) {
  using L = Layout<T>;
  using Tl = Tile<QT>;
  constexpr int kStages = Tl::kStages;
  constexpr int kStageElems = (QT + kRows) * L::kStride;
  const int32_t* unit_end = tiles + 4 * max_tiles;
  const int u = blockIdx.x;
  if (u >= unit_end[max_tiles - 1]) return;        // a surplus CTA
  int t = 0;                                       // the first tile ending past u
  for (int span = max_tiles - 1; span > 0;) {
    const int half = span / 2;
    if (unit_end[t + half] > u) {
      span = half;
    } else {
      t += half + 1;
      span -= half + 1;
    }
  }
  const int c = tiles[t];
  const int splits = tiles[3 * max_tiles + t];
  const int split = u - (unit_end[t] - splits);
  const int64_t lo = offsets[c], hi = offsets[c + 1];
  const int n_sub = (int)((hi - lo + kRows - 1) / kRows);
  const int per = (n_sub + splits - 1) / splits;
  const int sub_lo = split * per;
  const int sub_hi = sub_lo + per < n_sub ? sub_lo + per : n_sub;
  if (sub_lo >= sub_hi) return;                    // its slots stay empty

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* sc = reinterpret_cast<float*>(smem_raw + (size_t)kStages * kStageElems * sizeof(T));
  float* lists_v = sc + QT * kScStride;
  int32_t* lists_i = reinterpret_cast<int32_t*>(lists_v + QT * k);
  int* qrow = reinterpret_cast<int*>(lists_i + QT * k);

  const int p0 = tiles[max_tiles + t];
  const int nq = tiles[2 * max_tiles + t];
  if (threadIdx.x < QT)
    qrow[threadIdx.x] = threadIdx.x < nq ? pairs[p0 + threadIdx.x] / nprobe : -1;
  __syncthreads();

  const int n_chunks = (D + L::kDk - 1) / L::kDk;
  const int steps = (sub_hi - sub_lo) * n_chunks;
  // the producer's position: the next (sub-tile, slice) to stage
  int ld_sub = sub_lo, ld_c0 = 0;
  RowMask ld_mask = row_mask(lo + (int64_t)ld_sub * kRows, hi, scanned, block_rows);
  auto load_next = [&](int buf) {
    T* qs = ring + buf * kStageElems;
    stage<T, QT, true>(q, qrow, 0, ld_mask, D, ld_c0, vec, qs);
    stage<T, kRows, false>(e, nullptr, lo + (int64_t)ld_sub * kRows, ld_mask, D,
                           ld_c0, vec, qs + QT * L::kStride);
    ld_c0 += L::kDk;
    if (ld_c0 >= D) {
      ld_c0 = 0;
      if (++ld_sub < sub_hi)
        ld_mask = row_mask(lo + (int64_t)ld_sub * kRows, hi, scanned, block_rows);
    }
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wq = warp % Tl::kWarpsQ, wr = warp / Tl::kWarpsQ;
  float acc[Tl::kNJ][4];
#pragma unroll
  for (int j = 0; j < Tl::kNJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
  // each merged query's list length and tail, the bar a score must beat
  int nf[Tl::kQPerWarp], tail_i[Tl::kQPerWarp];
  float tail_v[Tl::kQPerWarp];
#pragma unroll
  for (int j = 0; j < Tl::kQPerWarp; ++j) {
    nf[j] = 0;
    tail_v[j] = kNegInf;
    tail_i[j] = -1;
  }
  RowMask m;                                       // the sub-tile in use

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_next(s);
    cp_async_commit();
  }
  int buf_ld = kStages - 1, buf_use = 0, use_chunk = 0, use_sub = sub_lo;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();   // this thread's copies for `step` landed
    __syncthreads();                // everyone's did; step - 1's buffer is free
    if (step + kStages - 1 < steps) load_next(buf_ld);
    cp_async_commit();
    buf_ld = buf_ld + 1 == kStages ? 0 : buf_ld + 1;
    if (use_chunk == 0)   // read now, needed at the merge
      m = row_mask(lo + (int64_t)use_sub * kRows, hi, scanned, block_rows);
    const T* qs = ring + buf_use * kStageElems;
    slice_scores<QT>(qs, qs + QT * L::kStride, acc);
    buf_use = buf_use + 1 == kStages ? 0 : buf_use + 1;
    if (++use_chunk < n_chunks) continue;
    // the sub-tile is complete: its scores to shared memory, then the merge
    use_chunk = 0;
#pragma unroll
    for (int j = 0; j < Tl::kNJ; ++j) {
      const int col = Tl::kWarpRows * wr + 8 * j + 2 * t4;
      float* r0 = sc + (16 * wq + g) * kScStride + col;
      *reinterpret_cast<float2*>(r0) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(r0 + 8 * kScStride) = make_float2(acc[j][2], acc[j][3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
    }
    __syncthreads();
    const int row0 = (int)(lo + (int64_t)use_sub * kRows);
    float sv[Tl::kQPerWarp][2];                    // all loads first
#pragma unroll
    for (int j = 0; j < Tl::kQPerWarp; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        sv[j][r] = sc[(warp * Tl::kQPerWarp + j) * kScStride + lane + 32 * r];
#pragma unroll
    for (int j = 0; j < Tl::kQPerWarp; ++j) {
      const int slot = warp * Tl::kQPerWarp + j;
      if (slot >= nq) break;                       // warp-uniform
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + lane + 32 * r;
        const bool cand = m.ok(lane + 32 * r) &&
                          (nf[j] < k || beats(sv[j][r], row, tail_v[j], tail_i[j]));
        const unsigned mask = __ballot_sync(kFull, cand);
        if (mask == 0) continue;                   // the common case
        float* V = lists_v + slot * k;
        int32_t* I = lists_i + slot * k;
        insert(mask, sv[j][r], row, V, I, nf[j], k);
        if (nf[j] == k) {
          tail_v[j] = V[k - 1];
          tail_i[j] = I[k - 1];
        }
      }
    }
    ++use_sub;
    // sc is written again only after the next step's barrier
  }
#pragma unroll
  for (int j = 0; j < Tl::kQPerWarp; ++j) {
    const int slot = warp * Tl::kQPerWarp + j;
    if (slot >= nq) break;
    const int pair = pairs[p0 + slot];
    const int64_t qi = pair / nprobe, p = pair % nprobe;
    const int64_t out = (qi * list_stride + p * max_splits + split) * k;
    const float* V = lists_v + slot * k;
    const int32_t* I = lists_i + slot * k;
    for (int i = lane; i < k; i += 32) {
      part_v[out + i] = i < nf[j] ? V[i] : kNegInf;
      part_i[out + i] = i < nf[j] ? I[i] : -1;
    }
  }
}

template <typename T, int QT>
int set_smem(int k) {
  return (int)cudaFuncSetAttribute(ivf_partial_kernel<T, QT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_bytes<T, QT>(k));
}

template <typename T, int QT>
int resident(int k, int* per_sm) {
  const int err = set_smem<T, QT>(k);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, ivf_partial_kernel<T, QT>, kThreads, smem_bytes<T, QT>(k));
}

template <typename T, int QT>
int launch(const void* q, const void* e, int D, int vec, const int64_t* offsets,
           const uint8_t* scanned, int block_rows, const int32_t* pairs,
           const int32_t* tiles, int max_tiles, int grid, int nprobe,
           int max_splits, int list_stride, int k, float* part_v,
           int32_t* part_i, cudaStream_t s) {
  const int err = set_smem<T, QT>(k);
  if (err) return err;
  ivf_partial_kernel<T, QT><<<(unsigned)grid, kThreads, smem_bytes<T, QT>(k), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(e), D, vec, offsets,
      scanned, block_rows, pairs, tiles, max_tiles, nprobe, max_splits,
      list_stride, k, part_v, part_i);
  return (int)cudaGetLastError();
}

// The work plan, one CTA of kPlanThreads threads (the counterpart of
// ivf_work_plan_ref's torch ops, equal to them: the tiles and the kept
// pairs). The threads mark each entry of sel kept (valid, and the first of
// its cluster in its row) and count the kept entries of each cluster with
// atomics; scans over the clusters, in rounds of kPlanThreads, place each
// cluster's pairs, tiles and units; warp 0 then walks the kept entries in
// order, 32 at a time, and writes each after those of its cluster before it
// (__match_any_sync groups a cluster's lanes), so a cluster's pairs are in
// query order.
constexpr int kPlanThreads = 1024;

// Exclusive prefix of v over the CTA's threads in order; `total` gets the
// sum. Every thread of the CTA calls it.
__device__ long long block_scan(long long v, long long* red, long long& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  __syncthreads();                       // red is free
  if (lane == 31) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < kPlanThreads / 32 ? red[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += y;
    }
    red[lane] = w;                       // inclusive over the warps
  }
  __syncthreads();
  total = red[kPlanThreads / 32 - 1];
  return x - v + (warp > 0 ? red[warp - 1] : 0);
}

// ws int32 scratch: (4, nlist) per cluster its kept entries, first pair,
// first tile and a cursor, then one entry per pair: its cluster if kept,
// else -1.
__global__ void __launch_bounds__(kPlanThreads)
plan_kernel(const int32_t* __restrict__ sel, int B, int P,
            const int64_t* __restrict__ offsets, int nlist, int q_tile,
            int slots, int max_splits, int max_tiles, int32_t* __restrict__ ws,
            int32_t* __restrict__ pairs, int32_t* __restrict__ tiles) {
  __shared__ long long red[32];
  int32_t* count = ws;
  int32_t* first = ws + nlist;
  int32_t* tile_first = ws + 2 * nlist;
  int32_t* cursor = ws + 3 * nlist;
  int32_t* kept = ws + 4 * nlist;
  const int m = B * P;
  for (int c = threadIdx.x; c < nlist; c += kPlanThreads) count[c] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += kPlanThreads) {
    const int c = sel[i], row = i - i % P;
    bool keep = c >= 0 && c < nlist;
    for (int j = row; keep && j < i; ++j) keep = sel[j] != c;
    kept[i] = keep ? c : -1;
    if (keep) atomicAdd(&count[c], 1);
  }
  __syncthreads();
  const int rounds = (nlist + kPlanThreads - 1) / kPlanThreads;
  long long n_tiles = 0, n_pairs = 0, work = 0, total;
  for (int r = 0; r < rounds; ++r) {
    const int c = r * kPlanThreads + threadIdx.x;
    int cnt = 0, n_sub = 0;
    if (c < nlist) {
      cnt = count[c];
      n_sub = (int)((offsets[c + 1] - offsets[c] + kRows - 1) / kRows);
    }
    const int tl = (cnt + q_tile - 1) / q_tile;
    const long long fp = block_scan(cnt, red, total) + n_pairs;
    n_pairs += total;
    const long long ft = block_scan(tl, red, total) + n_tiles;
    n_tiles += total;
    block_scan((long long)tl * n_sub, red, total);
    work += total;
    if (c < nlist) {
      first[c] = cursor[c] = (int32_t)fp;
      tile_first[c] = (int32_t)ft;
    }
  }
  if (work < 1) work = 1;
  long long n_units = 0;
  for (int r = 0; r < rounds; ++r) {
    const int c = r * kPlanThreads + threadIdx.x;
    int tl = 0, splits = 0;
    if (c < nlist) {
      const int n_sub = (int)((offsets[c + 1] - offsets[c] + kRows - 1) / kRows);
      tl = (count[c] + q_tile - 1) / q_tile;
      long long sp = (long long)n_sub * slots / work;
      sp = sp < 1 ? 1 : sp;
      const int cap = n_sub < max_splits ? n_sub : max_splits;
      splits = (int)(sp < cap ? sp : cap);
    }
    const long long fu = block_scan((long long)tl * splits, red, total) + n_units;
    n_units += total;
    if (c < nlist) {
      const int ft = tile_first[c], fp = first[c], cnt = count[c];
      for (int j = 0; j < tl; ++j) {
        const int t = ft + j;
        const int left = cnt - j * q_tile;
        tiles[t] = c;
        tiles[max_tiles + t] = fp + j * q_tile;
        tiles[2 * max_tiles + t] = left < q_tile ? left : q_tile;
        tiles[3 * max_tiles + t] = splits;
        tiles[4 * max_tiles + t] = (int32_t)(fu + (long long)(j + 1) * splits);
      }
    }
  }
  for (int t = (int)n_tiles + threadIdx.x; t < max_tiles; t += kPlanThreads) {
    tiles[t] = -1;
    tiles[max_tiles + t] = 0;
    tiles[2 * max_tiles + t] = 0;
    tiles[3 * max_tiles + t] = 0;
    tiles[4 * max_tiles + t] = (int32_t)n_units;
  }
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  for (int base = 0; base < m; base += 32) {
    const int i = base + lane;
    const int c = i < m ? kept[i] : -1;
    const unsigned peers = __match_any_sync(kFull, c);
    const int leader = __ffs(peers) - 1;
    int pos = 0;
    if (c >= 0 && lane == leader) {
      pos = cursor[c];
      cursor[c] = pos + __popc(peers);
    }
    pos = __shfl_sync(kFull, pos, leader) + __popc(peers & ((1u << lane) - 1));
    if (c >= 0) pairs[pos] = i;
    __syncwarp();
  }
}

bool bad_tile(int q_tile, int k) {
  return k < 1 || k > kMaxK || !(q_tile == 16 || (q_tile == 64 && k <= kSmallK));
}

}  // namespace

// The work plan of sel (B, P) int32 for the phase-1 kernel: pairs (B * P)
// and tiles (5, max_tiles) int32 as anorag_ivf_scan takes them (the kept
// pairs first; the entries after them are not written), ws 4 * nlist + B *
// P int32 of scratch. One CTA. Returns the CUDA error code (0 on success).
extern "C" int anorag_ivf_plan(const void* sel, int B, int P, const void* offsets,
                               int nlist, int q_tile, int slots, int max_splits,
                               int max_tiles, void* ws, void* pairs, void* tiles,
                               int device, void* stream) {
  if (B < 1 || P < 1 || nlist < 0 || q_tile < 1 || slots < 1 || max_splits < 1 ||
      max_tiles < 1)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  plan_kernel<<<1, kPlanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sel), B, P, static_cast<const int64_t*>(offsets),
      nlist, q_tile, slots, max_splits, max_tiles, static_cast<int32_t*>(ws),
      static_cast<int32_t*>(pairs), static_cast<int32_t*>(tiles));
  return (int)cudaGetLastError();
}

// CTAs of the phase-1 kernel for dtype (0 bf16, 1 f32), q_tile and k that
// the card holds at once: per SM times the SMs. Returns minus the CUDA error
// code on failure.
extern "C" int anorag_ivf_slots(int dtype, int q_tile, int k, int device) {
  if (bad_tile(q_tile, k)) return -(int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  int per_sm = 0, sms = 0;
  if (!err) {
    if (dtype == 0)
      err = q_tile == 64 ? resident<__nv_bfloat16, 64>(k, &per_sm)
                         : resident<__nv_bfloat16, 16>(k, &per_sm);
    else
      err = q_tile == 64 ? resident<float, 64>(k, &per_sm)
                         : resident<float, 16>(k, &per_sm);
  }
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err) return -err;
  return per_sm * sms > 0 ? per_sm * sms : 1;
}

// dtype 0 = bf16, 1 = f32. q (B, D); e the cluster-sorted corpus, D wide;
// offsets (nlist + 1) int64, cluster c's rows [offsets[c], offsets[c + 1]);
// scanned (ceil(n_rows / block_rows)) uint8 block flags; the plan: pairs
// (query * nprobe + probe slot) sorted by cluster, and tiles (5, max_tiles)
// int32: per tile (at most q_tile queries of one cluster, q_tile 16 or 64)
// its cluster (-1: surplus), first entry in pairs, query count, splits (at
// most max_splits) and the running sum of the splits; grid CTAs, at least
// that sum. part_v / part_i (B, list_stride, k) filled with (-3.0e38, -1),
// slot p * max_splits + split for probe slot p; list_stride >= nprobe *
// max_splits, and above 256 a multiple of 256 with mid_v / mid_i (B,
// list_stride / 256, k) for the first of two merge levels. out (B, k).
// Returns the CUDA error code (0 on success); launches on `stream` of CUDA
// device `device`.
extern "C" int anorag_ivf_scan(const void* q, const void* e, int dtype, long long B,
                               int D, int vec, const void* offsets,
                               const void* scanned, int block_rows,
                               const void* pairs, const void* tiles, int max_tiles,
                               int grid, int q_tile, int nprobe, int max_splits,
                               int list_stride, int k, void* part_v, void* part_i,
                               void* mid_v, void* mid_i, void* out_v,
                               void* out_i, int device, void* stream) {
  if (B <= 0) return 0;
  const bool two_level = list_stride > kMaxLists;
  if (bad_tile(q_tile, k) || D < 1 || nprobe < 1 || max_splits < 1 ||
      max_tiles < 1 || grid < 1 || block_rows < kRows || block_rows % kRows != 0 ||
      list_stride < (long long)nprobe * max_splits ||
      (two_level && (list_stride % kMaxLists != 0 ||
                     list_stride / kMaxLists > kMaxLists || !mid_v || !mid_i)))
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* off = static_cast<const int64_t*>(offsets);
  const uint8_t* fl = static_cast<const uint8_t*>(scanned);
  const int32_t* pr = static_cast<const int32_t*>(pairs);
  const int32_t* tl = static_cast<const int32_t*>(tiles);
  float* pv = static_cast<float*>(part_v);
  int32_t* pi = static_cast<int32_t*>(part_i);
  if (dtype == 0 && q_tile == 64)
    err = launch<__nv_bfloat16, 64>(q, e, D, vec, off, fl, block_rows, pr, tl,
                                    max_tiles, grid, nprobe, max_splits,
                                    list_stride, k, pv, pi, s);
  else if (dtype == 0)
    err = launch<__nv_bfloat16, 16>(q, e, D, vec, off, fl, block_rows, pr, tl,
                                    max_tiles, grid, nprobe, max_splits,
                                    list_stride, k, pv, pi, s);
  else if (q_tile == 64)
    err = launch<float, 64>(q, e, D, vec, off, fl, block_rows, pr, tl, max_tiles,
                            grid, nprobe, max_splits, list_stride, k, pv, pi, s);
  else
    err = launch<float, 16>(q, e, D, vec, off, fl, block_rows, pr, tl, max_tiles,
                            grid, nprobe, max_splits, list_stride, k, pv, pi, s);
  if (err) return err;
  float* ov = static_cast<float*>(out_v);
  int32_t* oi = static_cast<int32_t*>(out_i);
  if (!two_level) return merge(pv, pi, B, list_stride, k, ov, oi, s);
  const int groups = list_stride / kMaxLists;
  float* mv = static_cast<float*>(mid_v);
  int32_t* mi = static_cast<int32_t*>(mid_i);
  err = merge(pv, pi, B * groups, kMaxLists, k, mv, mi, s);
  if (err) return err;
  return merge(mv, mi, B, groups, k, ov, oi, s);
}
