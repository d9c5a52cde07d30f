// Bucketed-winners dense scan for Hopper (sm_90a), with a plain C interface
// for ctypes.
//
// Replaces anorag_tpu/ops/topk.py::_bucket_kernel (:172), reached through
// _bucket_winners_pallas (:228) and bucket_topk (:297).
// Function: q (B, D) and the corpus e (N rows of width D, read through two
// element strides, so the (N, D) layout and the transposed (D, N) one need
// no copy) in one dtype (bf16 or f32), products summed in f32. Global column
// c < n competes in bucket c mod W: winners[b, c mod W] keeps the largest
// q_b . e_c and its c, the earliest c among exact ties (strict >, tiles in
// increasing order). Rows >= n are masked. Buckets that saw no valid row
// keep (-3.0e38, 0), the reference's initial state.
//
// Two routes; the wrapper (ops/topk.py bucket_winners, bucket_route) picks
// one from the shapes and dtypes alone.
//
// The wgmma route (bucket_wgmma_kernel): bf16, row-major 16-byte rows (TMA's
// stride), W a multiple of 128, any batch (the route lines on the card put
// it ahead from one query; the wrapper fills a short last query tile with
// zeros, which TMA reads faster than its own fill past the end). A unit is
// (128-query tile, 128-bucket-column tile, split: a contiguous range of the
// corpus tiles); the wrapper's plan (bucket_work_plan) cuts the tiles into
// as many splits as fill one wave of CTAs, and the unit index runs over the
// query tiles first, so the tiles of one (column tile, split) run side by
// side and share the corpus rows in L2. One producer thread keeps a 5-stage
// ring of TMA loads in flight behind mbarriers: for corpus tile t, 64-column
// 128-byte-swizzled slices of the tile's queries and of rows
// t W + cb + [0, 128), one box each (rows past n and B, columns past D:
// zeros). Two consumer warpgroups of 64 queries run wgmma m64n128k16 on
// them; after a tile's last slice each thread compares its 64 accumulators
// with its winners' values, held in registers in the accumulator layout,
// strictly (rows at or past n score -3.0e38); a winner's row goes to shared
// memory (one slot a thread and accumulator, written only on a change), so
// the registers hold 64 accumulators and 64 values, and setmaxnreg moves
// registers from the producer warpgroup to the consumers. No candidate
// list, no CTA barrier after the start. Each split writes its (B, W) winners to
// scratch (the output itself when there is one split), and
// bucket_merge_kernel takes, per (query, bucket), the largest value over
// the splits by strict > in split order: an earlier split holds the earlier
// tiles, so the earliest row keeps an exact tie, as in the reference.
//
// The mma.sync / FMA route (bucket_winners_kernel, the first version): f32
// (FMAs, never TF32), the transposed (D, N) corpus, rows that are not
// 16-byte aligned, W not a multiple of 128. The grid runs
// over (32-query tile, 64-bucket-column tile), so each (query, bucket) pair
// has one owner, which walks the corpus tiles in order and keeps its
// winners in registers: no atomics, no merge. For tile t the CTA stages
// rows t * W + [c0, c0 + 64) of the corpus and its 32 queries in slices of
// D (128 columns for bf16, 64 for f32) through a ring of 3 shared-memory
// stages (cp.async for 16-byte-aligned row-major rows, plain loads
// otherwise; zeros past n, past D and past the last query). bf16 slices go
// to the tensor cores: each of the 8 warps runs mma.sync m16n8k16 for 16
// queries x 16 columns with f32 accumulators; f32 slices are summed with
// FMAs. After the last slice of a tile each thread compares its
// accumulators with its winners, in the accumulator layout itself.
//
// Bound: 2 * B * N * D operations on bf16 inputs, the corpus read once
// (512 x 200,000 x 1024: 209.7 GFLOP, 409.6 MB), so the tensor cores'
// 989 TFLOP/s bound it (0.212 ms) above the 3.35 TB/s of device memory
// (0.12 ms). Both routes read the corpus once per query tile and the query
// slices once per tile, from L2: the wgmma route at B 512, W 512 pulls
// 3.28 GB (4 query tiles) and on an H100 80GB HBM3 at 700 W takes about
// 0.30 ms, its loads alone and its products alone about 0.25 each, so the
// loads keep it from the bound; the mma.sync route pulls 16 query tiles'
// worth and takes about 3.2 ms, two thirds of it the staging (PERF.md:
// times, and the variants with one part cut out). TMA multicast of the
// query slices over a cluster of column tiles is the next step (ROADMAP).
#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------- the mma.sync / FMA route
constexpr int kThreads = 256;
constexpr int kBQ = 32;                    // queries per CTA
constexpr int kWT = 64;                    // bucket columns per CTA
constexpr int kWarpRows = kBQ / 16;        // warps down the queries, 16 each
constexpr int kWarpCols = (kThreads / 32) / kWarpRows;
constexpr int kWarpN = kWT / kWarpCols;    // columns per warp
constexpr int kNJ = kWarpN / 8;            // mma n-tiles of 8 columns per warp
static_assert(kWarpRows * kWarpCols == kThreads / 32 && kNJ * 8 * kWarpCols == kWT,
              "the warps tile the CTA's queries x columns");

// The staged slices: kDk columns of D per stage, kStages stages in the ring.
// Row strides of 272 bytes keep 16-byte alignment for cp.async and put the
// fragment loads of a warp on distinct banks.
template <typename T> struct Layout;
template <> struct Layout<__nv_bfloat16> {
  static constexpr int kDk = 128;
  static constexpr int kStride = kDk + 8;
  static constexpr int kVec = 8;           // elements in 16 bytes
  static constexpr int kStages = 3;
  static constexpr int kStageElems = (kBQ + kWT) * kStride;
};
template <> struct Layout<float> {
  static constexpr int kDk = 64;
  static constexpr int kStride = kDk + 4;
  static constexpr int kVec = 4;
  static constexpr int kStages = 3;
  static constexpr int kStageElems = (kBQ + kWT) * kStride;
};

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// Element (r, c) of a matrix is src[r * sr + c * sc]. Stage rows
// [row0, row0 + R) x columns [c0, c0 + kDk) into dst; rows at or past
// `rows` and columns at or past D are zeros. mode 0: 16-byte cp.async
// (sc == 1, D, sr and the base 16-byte multiples); 1: plain loads, columns
// fastest; 2: plain loads, rows fastest (sr == 1, the transposed corpus).
template <typename T, int R>
__device__ __forceinline__ void stage(const T* __restrict__ src, int64_t sr,
                                      int64_t sc, int64_t row0, int rows, int D,
                                      int c0, int mode, T* dst) {
  constexpr int S = Layout<T>::kStride, Dk = Layout<T>::kDk;
  if (mode == 0) {
    constexpr int V = Layout<T>::kVec, kPerRow = Dk / V;
    for (int e = threadIdx.x; e < R * kPerRow; e += kThreads) {
      const int r = e / kPerRow, cv = (e % kPerRow) * V;
      const bool ok = r < rows && c0 + cv < D;
      const T* p = ok ? src + (row0 + r) * sr + (c0 + cv) : src;
      cp_async16(dst + r * S + cv, p, ok);
    }
  } else {
    for (int e = threadIdx.x; e < R * Dk; e += kThreads) {
      const int r = mode == 1 ? e / Dk : e % R;
      const int c = mode == 1 ? e % Dk : e / R;
      dst[r * S + c] = (r < rows && c0 + c < D)
                           ? src[(row0 + r) * sr + (int64_t)(c0 + c) * sc]
                           : zero<T>();
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The accumulator layout of mma.sync m16n8k16, used for both dtypes: warp w
// owns queries 16 (w % kWarpRows) + [0, 16) and columns
// kWarpN (w / kWarpRows) + [0, kWarpN); acc[j][i] is query
// 16 (w % kWarpRows) + g + 8 (i >> 1) against column
// kWarpN (w / kWarpRows) + 8 j + 2 t4 + (i & 1), g = lane / 4, t4 = lane % 4.
__device__ __forceinline__ void slice_scores(const __nv_bfloat16* __restrict__ qs,
                                             const __nv_bfloat16* __restrict__ es,
                                             float acc[kNJ][4]) {
  constexpr int S = Layout<__nv_bfloat16>::kStride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const __nv_bfloat16* qa = qs + ((warp % kWarpRows) * 16 + g) * S + 2 * t4;
  const __nv_bfloat16* eb = es + ((warp / kWarpRows) * kWarpN + g) * S + 2 * t4;
#pragma unroll
  for (int kk = 0; kk < Layout<__nv_bfloat16>::kDk; kk += 16) {
    const uint32_t a0 = ld32(qa + kk), a1 = ld32(qa + 8 * S + kk);
    const uint32_t a2 = ld32(qa + kk + 8), a3 = ld32(qa + 8 * S + kk + 8);
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const __nv_bfloat16* e = eb + 8 * j * S + kk;
      const uint32_t b0 = ld32(e), b1 = ld32(e + 8);
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
}

__device__ __forceinline__ void slice_scores(const float* __restrict__ qs,
                                             const float* __restrict__ es,
                                             float acc[kNJ][4]) {
  constexpr int S = Layout<float>::kStride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const float* q0 = qs + ((warp % kWarpRows) * 16 + g) * S;
  const float* q1 = q0 + 8 * S;
  const float* e0 = es + ((warp / kWarpRows) * kWarpN + 2 * t4) * S;
#pragma unroll 4
  for (int c = 0; c < Layout<float>::kDk; ++c) {
    const float a0 = q0[c], a1 = q1[c];
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const float x0 = e0[8 * j * S + c], x1 = e0[(8 * j + 1) * S + c];
      acc[j][0] = fmaf(a0, x0, acc[j][0]);
      acc[j][1] = fmaf(a0, x1, acc[j][1]);
      acc[j][2] = fmaf(a1, x0, acc[j][2]);
      acc[j][3] = fmaf(a1, x1, acc[j][3]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bucket_winners_kernel(const T* __restrict__ q, const T* __restrict__ e,
                      int64_t esr, int64_t esc, int e_mode, int q_mode, int B,
                      int64_t n, int D, int W, float* __restrict__ out_v,
                      int32_t* __restrict__ out_i) {
  using L = Layout<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int q0 = blockIdx.x * kBQ;
  const int cb = blockIdx.y * kWT;                 // first bucket column
  const int qrows = min(kBQ, B - q0);
  const int wcols = min(kWT, W - cb);
  const int n_chunks = (D + L::kDk - 1) / L::kDk;
  const int64_t steps = (n + W - 1) / W * n_chunks;

  // The producer's position: the next (tile row0, slice c0) to stage.
  int64_t ld_row0 = cb;
  int ld_c0 = 0;
  auto load_next = [&](int buf) {
    T* qs = smem + buf * L::kStageElems;
    stage<T, kBQ>(q, D, 1, q0, qrows, D, ld_c0, q_mode, qs);
    const int64_t left = n - ld_row0;
    const int rows = left < wcols ? (int)(left > 0 ? left : 0) : wcols;
    stage<T, kWT>(e, esr, esc, ld_row0, rows, D, ld_c0, e_mode, qs + kBQ * L::kStride);
    ld_c0 += L::kDk;
    if (ld_c0 >= D) {
      ld_c0 = 0;
      ld_row0 += W;
    }
  };

  float acc[kNJ][4], wv[kNJ][4];
  int32_t wi[kNJ][4];
#pragma unroll
  for (int j = 0; j < kNJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[j][i] = 0.0f;
      wv[j][i] = kNegInf;
      wi[j][i] = 0;
    }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = cb + (warp / kWarpRows) * kWarpN + 2 * (lane & 3);

  for (int s = 0; s < L::kStages - 1; ++s) {
    if (s < steps) load_next(s);
    cp_async_commit();
  }
  int buf_ld = L::kStages - 1, buf_use = 0, use_chunk = 0;
  int64_t use_base = 0;                            // first row of the tile in use
  for (int64_t step = 0; step < steps; ++step) {
    cp_async_wait<L::kStages - 2>();  // this thread's copies for `step` landed
    __syncthreads();                  // everyone's did; step - 1's buffer is free
    if (step + L::kStages - 1 < steps) load_next(buf_ld);
    cp_async_commit();
    buf_ld = buf_ld + 1 == L::kStages ? 0 : buf_ld + 1;
    const T* qs = smem + buf_use * L::kStageElems;
    slice_scores(qs, qs + kBQ * L::kStride, acc);
    buf_use = buf_use + 1 == L::kStages ? 0 : buf_use + 1;
    if (++use_chunk == n_chunks) {                 // the tile is complete
      use_chunk = 0;
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = col0 + 8 * j + (i & 1);
          const int64_t row = use_base + col;
          const float s = (col < W && row < n) ? acc[j][i] : kNegInf;
          if (s > wv[j][i]) {                      // strict: earlier tile keeps ties
            wv[j][i] = s;
            wi[j][i] = (int32_t)row;
          }
          acc[j][i] = 0.0f;
        }
      use_base += W;
    }
  }
  const int qw = q0 + (warp % kWarpRows) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kNJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = qw + 8 * (i >> 1);
      const int col = col0 + 8 * j + (i & 1);
      if (qi < B && col < W) {
        out_v[(int64_t)qi * W + col] = wv[j][i];
        out_i[(int64_t)qi * W + col] = wi[j][i];
      }
    }
}

template <typename T>
int launch(const void* q, const void* e, long long esr, long long esc,
           int e_mode, int q_mode, long long B, long long n, int D, int W,
           void* out_v, void* out_i, cudaStream_t s) {
  const int smem = Layout<T>::kStages * Layout<T>::kStageElems * (int)sizeof(T);
  auto kern = bucket_winners_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((B + kBQ - 1) / kBQ), (unsigned)((W + kWT - 1) / kWT));
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(e), esr, esc, e_mode,
      q_mode, (int)B, n, D, W, static_cast<float*>(out_v),
      static_cast<int32_t*>(out_i));
  return (int)cudaGetLastError();
}

// ------------------------------------------------- the wgmma route (bf16)
constexpr int kBwStages = 5;
constexpr int kBwTile = 128;                     // queries and bucket columns of a unit
constexpr int kBwSliceBytes = kBwTile * kSliceCols * 2;   // one stage's slice of either
constexpr int kBwConsumers = 256;                // 2 consumer warpgroups
constexpr int kBwThreads = kBwConsumers + 128;   // + the producer warpgroup
constexpr int kBwSmem = 1024 + kBwStages * 2 * kBwSliceBytes +
                        64 * kBwConsumers * (int)sizeof(int32_t) + kBwStages * 2 * 8;
constexpr int kMergeCells = 256;                 // (query, bucket) cells a merge CTA

// mbarrier arrival by the threads where `pred` holds, with no branch: the
// wgmma loop keeps no divergent path, since ptxas may wait for every
// product in flight where paths join (its note C7517).
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile("{ .reg .pred p; setp.ne.b32 p, %1, 0; @p mbarrier.arrive.shared::cta.b64 _, [%0]; }"
               ::"r"(smem_u32(bar)), "r"((int)pred) : "memory");
}

// A shared-memory store where `pred` holds, with no branch (as above).
__device__ __forceinline__ void st_shared_if(uint32_t addr, int v, bool pred) {
  asm volatile("{ .reg .pred p; setp.ne.b32 p, %2, 0; @p st.shared.b32 [%0], %1; }"
               ::"r"(addr), "r"(v), "r"((int)pred) : "memory");
}

// Unit blockIdx.x = (split * c_tiles + column tile) * q_tiles + query tile;
// the split is corpus tiles [split * per, (split + 1) * per). Writes the
// unit's winners of queries < B to out_v / out_i + split * B * W, (B, W)
// each (qmap may hold more rows: zeros past B).
__global__ void __launch_bounds__(kBwThreads, 1)
bucket_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap emap, int B, int n, int D, int W,
                    int q_tiles, int c_tiles, int per, float* __restrict__ out_v,
                    int32_t* __restrict__ out_i) {
  const int q0 = (blockIdx.x % q_tiles) * kBwTile;
  const int cb = (blockIdx.x / q_tiles % c_tiles) * kBwTile;     // first bucket column
  const int split = blockIdx.x / q_tiles / c_tiles;
  const int n_tiles = (int)(((long long)n + W - 1) / W);
  const int t_lo = split * per;
  const int t_hi = t_lo + per < n_tiles ? t_lo + per : n_tiles;
  const int n_chunks = (D + kSliceCols - 1) / kSliceCols;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* es = qs + kBwStages * kBwSliceBytes;        // stages x 128 rows
  // win_row[i * 256 + thread]: the row of the thread's winner i
  int32_t* win_row = reinterpret_cast<int32_t*>(es + kBwStages * kBwSliceBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(win_row + 64 * kBwConsumers);
  uint64_t* empty = full + kBwStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kBwStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // registers: the producer warpgroup gives back what the consumers' 64
  // accumulators and 64 winners need (128 x 40 + 256 x 232 <= 65,536)
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {                                  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != kBwConsumers) return;
    int st = 0, phase = 0, t = 0;                 // ring position, slices issued
    for (int tile = t_lo; tile < t_hi; ++tile) {
      const int row0 = tile * W + cb;
      for (int c0 = 0; c0 < D; c0 += kSliceCols, ++t) {
        if (t >= kBwStages) mbar_wait(&empty[st], phase ^ 1);
        mbar_expect_tx(&full[st], 2 * kBwSliceBytes);
        tma_load(qs + st * kBwSliceBytes, &qmap, &full[st], c0, q0);
        tma_load(es + st * kBwSliceBytes, &emap, &full[st], c0, row0);
        if (++st == kBwStages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // a consumer thread: acc[4 j + 2 h + c] is query 16 warp + g + 8 h of the
  // tile against row 8 j + 2 t4 + c of the unit's 128 (g = lane / 4, t4 =
  // lane % 4), and wv[4 j + 2 h + c] its winner's value
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r_lane = 2 * (lane & 3);
  const bool leader = (threadIdx.x & 127) == 0;
  const uint32_t my_rows = smem_u32(win_row + threadIdx.x);
  float acc[64], wv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0.0f;
    wv[i] = kNegInf;
    win_row[i * kBwConsumers + threadIdx.x] = 0;
  }
  int st = 0, phase = 0, prev = 0;                // ring position; the slice before's stage
  for (int tile = t_lo; tile < t_hi; ++tile) {
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      mbar_wait(&full[st], phase);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      const uint64_t da = sw128_desc(qs + st * kBwSliceBytes + wg * 64 * kSliceCols * 2);
      const uint64_t db = sw128_desc(es + st * kBwSliceBytes);
#pragma unroll
      for (int kk = 0; kk < kSliceCols / 16; ++kk)   // 32 bytes of K a step
        wgmma_m64n128(acc, da + 2 * kk, db + 2 * kk, chunk != 0 || kk != 0);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      // one slice's products stay in flight behind this one: the slice
      // before is done, and its stage goes back to the producer
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      mbar_arrive_if(&empty[prev], leader && chunk > 0);
      prev = st;
      if (++st == kBwStages) {
        st = 0;
        phase ^= 1;
      }
    }
    // the tile's last slice: waited for after the loop, so no path through
    // the loop leaves products in flight that ptxas must wait for there
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    mbar_arrive_if(&empty[prev], leader);
    wgmma_fence_regs(acc);

    // the tile is complete: the bucket max on the accumulators (strict,
    // so the earlier tile keeps a tie); rows at or past n only in the last
    const int row0 = tile * W + cb + r_lane;
    if (row0 - r_lane + kBwTile > n) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (row0 + 8 * (i >> 2) + (i & 1) >= n) acc[i] = kNegInf;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const bool up = acc[i] > wv[i];             // strict: the earlier tile keeps a tie
      wv[i] = up ? acc[i] : wv[i];
      st_shared_if(my_rows + 4 * i * kBwConsumers, row0 + 8 * (i >> 2) + (i & 1), up);
    }
  }

  // the thread's winners, two adjacent buckets a store
  float* ov = out_v + (int64_t)split * B * W;
  int32_t* oi = out_i + (int64_t)split * B * W;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + 16 * warp + (lane >> 2) + 8 * h;
    if (qi >= B) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i = 4 * j + 2 * h;
      const int64_t o = (int64_t)qi * W + cb + 8 * j + r_lane;
      *reinterpret_cast<float2*>(ov + o) = make_float2(wv[i], wv[i + 1]);
      *reinterpret_cast<int2*>(oi + o) =
          make_int2(win_row[i * kBwConsumers + threadIdx.x],
                    win_row[(i + 1) * kBwConsumers + threadIdx.x]);
    }
  }
}

// Per (query, bucket) cell: the largest value over the splits' tables
// (splits x cells each) by strict > in split order, and its row.
__global__ void __launch_bounds__(kMergeCells)
bucket_merge_kernel(const float* __restrict__ part_v, const int32_t* __restrict__ part_i,
                    int64_t cells, int splits, float* __restrict__ out_v,
                    int32_t* __restrict__ out_i) {
  const int64_t x = (int64_t)blockIdx.x * kMergeCells + threadIdx.x;
  if (x >= cells) return;
  float v = part_v[x];
  int32_t id = part_i[x];
  for (int s = 1; s < splits; ++s) {
    const float u = part_v[s * cells + x];
    if (u > v) {                                  // strict: the earlier split keeps a tie
      v = u;
      id = part_i[s * cells + x];
    }
  }
  out_v[x] = v;
  out_i[x] = id;
}

int bucket_set_smem() {
  return (int)cudaFuncSetAttribute(bucket_wgmma_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, kBwSmem);
}

}  // namespace

// dtype 0 = bf16, 1 = f32. q is (B, D) row-major; corpus element (row r,
// column c) is e[r * esr + c * esc]; rows >= n are not read. e_mode and
// q_mode pick the staging (see stage); modes 0 need 16-byte alignment, which
// the caller checks. out_v / out_i are (B, W). Returns the CUDA error code
// (0 on success); launches on `stream` of CUDA device `device`.
extern "C" int anorag_bucket_winners(const void* q, const void* e, long long esr,
                                     long long esc, int e_mode, int q_mode,
                                     int dtype, long long B, long long n, int D,
                                     int W, void* out_v, void* out_i, int device,
                                     void* stream) {
  if (B <= 0) return 0;
  if (D < 1 || W < 1 || n < 0 || n > 0x7fffffffLL || B > 0x7fffffffLL ||
      (W + kWT - 1) / kWT > 65535 || e_mode < 0 || e_mode > 2 || q_mode < 0 ||
      q_mode > 1)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(q, e, esr, esc, e_mode, q_mode, B, n, D, W,
                                 out_v, out_i, s);
  return launch<float>(q, e, esr, esc, e_mode, q_mode, B, n, D, W, out_v,
                       out_i, s);
}

// CTAs of the wgmma route that card `device` holds at once: per SM times
// the SMs. Returns minus the CUDA error code on failure.
extern "C" int anorag_bucket_slots(int device) {
  int err = (int)cudaSetDevice(device);
  int per_sm = 0, sms = 0;
  if (!err) err = bucket_set_smem();
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bucket_wgmma_kernel,
                                                             kBwThreads, kBwSmem);
  if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err) return -err;
  return per_sm * sms > 0 ? per_sm * sms : 1;
}

// The wgmma route. q (q_rows >= B, D) bf16 row-major, D a multiple of 8;
// rows past B are read, never written out (the wrapper fills the last
// query tile so: a tile read past the tensor's end, which TMA fills with
// zeros, streams slower); corpus row
// r at e + r * esr (esr a multiple of 8, at least D), n >= 1 rows read;
// q and e 16-byte aligned; W a multiple of 128. The plan: splits of per
// corpus tiles covering the ceil(n / W) tiles, none empty (ops/topk.py
// bucket_work_plan). out_v / out_i: (splits, B, W) f32 / int32, one table a
// split (with one split, the output). Returns the CUDA error code (0 on
// success); launches on `stream` of CUDA device `device`.
extern "C" int anorag_bucket_winners_wgmma(const void* q, long long q_rows, const void* e,
                                           long long esr, long long B, long long n, int D,
                                           int W, int splits, int per, void* out_v,
                                           void* out_i, int device, void* stream) {
  if (B <= 0) return 0;
  const long long n_tiles = n > 0 && W > 0 ? (n + W - 1) / W : 0;
  const long long q_tiles = (B + kBwTile - 1) / kBwTile, c_tiles = W / kBwTile;
  if (n < 1 || D < 1 || D % 8 != 0 || esr < D || esr % 8 != 0 || W < kBwTile ||
      W % kBwTile != 0 || n + W > 0x7fffffffLL || B > 0x7fffffffLL || q_rows < B || splits < 1 ||
      per < 1 || (long long)splits * per < n_tiles || (long long)(splits - 1) * per >= n_tiles ||
      q_tiles * c_tiles * splits > 0x7fffffffLL ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(e)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  CUtensorMap qmap, emap;
  if (!err) err = make_map(&qmap, q, q_rows, D, D, kBwTile);
  if (!err) err = make_map(&emap, e, n, D, esr, kBwTile);
  if (!err) err = bucket_set_smem();
  if (err) return err;
  bucket_wgmma_kernel<<<(unsigned)(q_tiles * c_tiles * splits), kBwThreads, kBwSmem,
                        static_cast<cudaStream_t>(stream)>>>(
      qmap, emap, (int)B, (int)n, D, W, (int)q_tiles, (int)c_tiles, per,
      static_cast<float*>(out_v), static_cast<int32_t*>(out_i));
  return (int)cudaGetLastError();
}

// The merge of the wgmma route's split tables: part_v / part_i (splits,
// cells) f32 / int32 into out_v / out_i (cells). Returns the CUDA error
// code; launches on `stream` of CUDA device `device`.
extern "C" int anorag_bucket_merge(const void* part_v, const void* part_i, long long cells,
                                   int splits, void* out_v, void* out_i, int device,
                                   void* stream) {
  if (cells <= 0) return 0;
  if (splits < 1) return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  bucket_merge_kernel<<<(unsigned)((cells + kMergeCells - 1) / kMergeCells), kMergeCells, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_v), static_cast<const int32_t*>(part_i), cells, splits,
      static_cast<float*>(out_v), static_cast<int32_t*>(out_i));
  return (int)cudaGetLastError();
}
