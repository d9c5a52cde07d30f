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
// Design (a first version: simple and exact, not yet fast): the grid runs
// over (32-query tile, 64-bucket-column tile), so each (query, bucket) pair
// has one owner, which walks the corpus tiles t = 0, 1, ... in order and
// keeps its winners in registers: no atomics, no merge. For tile t the CTA
// stages rows t * W + [c0, c0 + 64) of the corpus and its 32 queries in
// slices of D (128 columns for bf16, 64 for f32) through a ring of 3
// shared-memory stages (cp.async for 16-byte-aligned row-major rows, plain
// loads otherwise; zeros past n, past D and past the last query). bf16
// slices go to the tensor cores: each of the 8 warps runs mma.sync
// m16n8k16 for 16 queries x 16 columns with f32 accumulators; f32 slices
// are summed with FMAs on the CUDA cores (never TF32). After the last slice
// of a tile each thread compares its accumulators with its winners, in the
// accumulator layout itself. Counters, not divisions, track the ring.
//
// Bound: 2 * B * N * D operations on bf16 inputs, the corpus read once
// (512 x 200,000 x 1024: 209.7 GFLOP, 409.6 MB), so the tensor cores'
// 989 TFLOP/s bound it (0.212 ms) above the 3.35 TB/s of device memory
// (0.12 ms). This design reads the corpus once per query tile (16 times at
// B 512, mostly from L2), re-stages the query slices for every tile, loads
// mma fragments 32 bits at a time and uses mma.sync rather than wgmma; on
// an H100 80GB HBM3 at 700 W it runs at about 15x the bound (PERF.md).
// Resident queries, ldmatrix, wgmma with a TMA ring and corpus splits
// merged by (value, earlier tile) are the next steps (ROADMAP).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -3.0e38f;
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;        // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
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
