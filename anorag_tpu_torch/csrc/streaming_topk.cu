// Exact streaming top-k of q . e^T for Hopper (sm_90a), with a plain C
// interface for ctypes.
//
// Replaces anorag_tpu/ops/topk.py::_topk_kernel (:40), via
// _dense_topk_pallas (:124): for each query row, the exact top-k of
// q . e^T (+ bias_weight * bias), rows >= n_valid masked. (The IVF kernel,
// once a branch of this one, is csrc/ivf_scan.cu.)
// Function: q (B, D) and e (rows, D) in one dtype (bf16 or f32), products
// summed in f32; for each query the k best valid rows by (score descending,
// row ascending) -- lax.top_k's rule, not the Pallas kernel's slot history;
// output sorted that way, slots never filled are (-3.0e38, -1).
//
// Design (a first version: simple and exact, not yet fast):
//   phase 1, grid (query tiles of 16) x (corpus splits): a block stages
//   64 corpus rows x 128 columns, and its 16 queries' 128 columns, in shared
//   memory with 16-byte loads where the width and alignment allow. bf16
//   tiles go to the tensor cores: each of the 8 warps runs mma.sync
//   m16n8k16 for the 16 queries x 8 rows, f32 accumulators, and the scores
//   pass through shared memory; f32 tiles are widened and summed with FMAs
//   on the CUDA cores. Warp w then merges queries 2w and 2w + 1 x the 64
//   rows into each query's running top-k, a list in shared memory sorted by
//   the rule above: a score enters only when it beats the list's tail (the
//   per-row threshold, counterpart of the reference's block reject test,
//   ops/topk.py:81-83); insertion counts its place and shifts the tail with
//   the whole warp. Each (query, split) list goes to a (B, splits, k)
//   partial. Phase 2: one warp per query merges the sorted partials by the
//   same rule.
//
// Bound: the function needs 2 * B * rows * D operations on bf16 inputs and
// reads the corpus once (512 x 200,000 x 1024: 209.7 GFLOP, 409.6 MB), so
// the tensor cores' 989 TFLOP/s bound it at large batch and the 3.35 TB/s of
// device memory at one query. This design re-reads the corpus once per
// query tile (32 times at B = 512, mostly from L2), stages synchronously
// with no overlap of loads and math, and uses mma.sync rather than wgmma;
// larger query tiles, a TMA ring and wgmma are the next steps (ROADMAP).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -3.0e38f;
constexpr int kThreads = 256;
constexpr int kQ = 16;             // queries per block, 2 per warp
constexpr int kRows = 64;          // corpus rows per tile, 2 per lane
constexpr int kDk = 128;           // columns staged per step
constexpr int kStride = kDk + 1;   // f32 tiles, padded: lanes read rows bank-free
constexpr int kStrideH = kDk + 8;  // bf16 tiles: 16-byte rows, fragment loads bank-free
constexpr int kScStride = kRows + 4;
// shared bytes before the lists: the larger of the two tile layouts
constexpr int kTileBytes = (kRows + kQ) * kStride * 4;
static_assert((kRows + kQ) * kStrideH * 2 + kQ * kScStride * 4 <= kTileBytes,
              "bf16 tiles and scores fit in the f32 tiles' room");
constexpr int kMaxK = 1024;
constexpr int kMaxSplits = 256;
constexpr unsigned kFull = 0xffffffffu;

// a ranks before b: filled first, then score descending, then row ascending
__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  if (ai < 0) return false;
  if (bi < 0) return true;
  return av > bv || (av == bv && ai < bi);
}

// f32 rows [row0, row0 + R) x columns [c0, c0 + kDk) of a (n_rows, D) matrix
// into dst (row stride kStride); zeros outside the matrix.
template <int R>
__device__ void stage_f32(const float* __restrict__ src, int64_t row0,
                          int64_t n_rows, int D, int c0, bool vec_ok, float* dst) {
  if (vec_ok) {
    constexpr int kPerRow = kDk / 4;
    for (int e = threadIdx.x; e < R * kPerRow; e += kThreads) {
      const int r = e / kPerRow, cv = (e % kPerRow) * 4;
      const int64_t row = row0 + r;
      const int col = c0 + cv;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < n_rows && col < D)
        v = *reinterpret_cast<const float4*>(src + row * D + col);
      float* d = dst + r * kStride + cv;
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
  } else {
    for (int e = threadIdx.x; e < R * kDk; e += kThreads) {
      const int r = e / kDk, c = e % kDk;
      const int64_t row = row0 + r;
      const int col = c0 + c;
      dst[r * kStride + c] = (row < n_rows && col < D) ? src[row * D + col] : 0.0f;
    }
  }
}

// bf16 rows [row0, row0 + R) x columns [c0, c0 + kDk) into dst (row stride
// kStrideH), zeros outside the matrix.
template <int R>
__device__ void stage_bf16(const __nv_bfloat16* __restrict__ src, int64_t row0,
                           int64_t n_rows, int D, int c0, bool vec_ok,
                           __nv_bfloat16* dst) {
  if (vec_ok) {
    constexpr int kPerRow = kDk / 8;
    for (int e = threadIdx.x; e < R * kPerRow; e += kThreads) {
      const int r = e / kPerRow, cv = (e % kPerRow) * 8;
      const int64_t row = row0 + r;
      const int col = c0 + cv;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (row < n_rows && col < D)
        u = *reinterpret_cast<const uint4*>(src + row * D + col);
      *reinterpret_cast<uint4*>(dst + r * kStrideH + cv) = u;
    }
  } else {
    for (int e = threadIdx.x; e < R * kDk; e += kThreads) {
      const int r = e / kDk, c = e % kDk;
      const int64_t row = row0 + r;
      const int col = c0 + c;
      dst[r * kStrideH + c] = (row < n_rows && col < D) ? src[row * D + col]
                                                        : __float2bfloat16(0.0f);
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Scores of the block's 16 queries against tile rows [row0, row0 + 64):
// acc[j][r] is query 2 * warp + j against row row0 + lane + 32 r.
// bf16: tensor cores. Warp w runs mma.sync m16n8k16 (all 16 queries x rows
// 8w..8w+7, f32 accumulators), and the scores pass through shared memory to
// the warp that merges them.
__device__ void tile_scores(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ e, int64_t row0,
                            int64_t n_rows, int64_t q0, int64_t B, int D,
                            bool vec_ok, float* smem, float acc[2][2]) {
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* qs = tile + kRows * kStrideH;
  float* sc = reinterpret_cast<float*>(qs + kQ * kStrideH);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c0 = 0; c0 < D; c0 += kDk) {
    __syncthreads();
    stage_bf16<kRows>(e, row0, n_rows, D, c0, vec_ok, tile);
    stage_bf16<kQ>(q, q0, B, D, c0, vec_ok, qs);
    __syncthreads();
    const __nv_bfloat16* qa = qs + g * kStrideH + 2 * t4;
    const __nv_bfloat16* eb = tile + (8 * warp + g) * kStrideH + 2 * t4;
#pragma unroll
    for (int kk = 0; kk < kDk; kk += 16) {
      const uint32_t a0 = ld32(qa + kk), a1 = ld32(qa + 8 * kStrideH + kk);
      const uint32_t a2 = ld32(qa + kk + 8), a3 = ld32(qa + 8 * kStrideH + kk + 8);
      const uint32_t b0 = ld32(eb + kk), b1 = ld32(eb + kk + 8);
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  const int col = 8 * warp + 2 * t4;
  sc[g * kScStride + col] = c[0];
  sc[g * kScStride + col + 1] = c[1];
  sc[(g + 8) * kScStride + col] = c[2];
  sc[(g + 8) * kScStride + col + 1] = c[3];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      acc[j][r] = sc[(2 * warp + j) * kScStride + lane + 32 * r];
}

// f32: FMAs on the CUDA cores, each lane 2 queries x 2 rows from f32 tiles.
__device__ void tile_scores(const float* __restrict__ q, const float* __restrict__ e,
                            int64_t row0, int64_t n_rows, int64_t q0, int64_t B,
                            int D, bool vec_ok, float* smem, float acc[2][2]) {
  float* tile = smem;                              // kRows x kStride
  float* qs = tile + kRows * kStride;              // kQ x kStride
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  acc[0][0] = acc[0][1] = acc[1][0] = acc[1][1] = 0.0f;
  for (int c0 = 0; c0 < D; c0 += kDk) {
    __syncthreads();
    stage_f32<kRows>(e, row0, n_rows, D, c0, vec_ok, tile);
    stage_f32<kQ>(q, q0, B, D, c0, vec_ok, qs);
    __syncthreads();
    const float* qa = qs + (2 * warp) * kStride;
    const float* qb = qa + kStride;
    const float* e0 = tile + lane * kStride;
    const float* e1 = tile + (lane + 32) * kStride;
#pragma unroll 8
    for (int c = 0; c < kDk; ++c) {
      const float x0 = e0[c], x1 = e1[c], a = qa[c], b = qb[c];
      acc[0][0] = fmaf(a, x0, acc[0][0]);
      acc[0][1] = fmaf(a, x1, acc[0][1]);
      acc[1][0] = fmaf(b, x0, acc[1][0]);
      acc[1][1] = fmaf(b, x1, acc[1][1]);
    }
  }
}

// Merge (s, row) of each lane into the sorted list (V, I) of nf entries, at
// most k; `ok` marks lanes whose row is valid for this query. Warp-wide.
__device__ void merge_scores(float s, int row, bool ok, float* V, int32_t* I,
                             int& nf, int k) {
  const int lane = threadIdx.x & 31;
  const bool cand = ok && (nf < k || beats(s, row, V[k - 1], I[k - 1]));
  unsigned mask = __ballot_sync(kFull, cand);
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

// Phase 1: units are 64-row tiles of e (n_rows = N, the valid rows).
template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_partial_kernel(const T* __restrict__ q, const T* __restrict__ e,
                    const float* __restrict__ bias, float bias_weight,
                    int64_t B, int64_t n_rows, int D, int k, int vec_ok,
                    int64_t units, float* __restrict__ part_v,
                    int32_t* __restrict__ part_i) {
  extern __shared__ __align__(16) float smem[];
  float* lists_v = smem + kTileBytes / 4;          // kQ x k
  int32_t* lists_i = reinterpret_cast<int32_t*>(lists_v + kQ * k);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t q0 = (int64_t)blockIdx.x * kQ;
  const int splits = gridDim.y, split = blockIdx.y;
  const int64_t per = (units + splits - 1) / splits;
  const int64_t u_lo = split * per;
  const int64_t u_hi = u_lo + per < units ? u_lo + per : units;
  const int64_t n_tiles = u_hi > u_lo ? u_hi - u_lo : 0;
  int nf[2] = {0, 0};

  for (int64_t t = 0; t < n_tiles; ++t) {
    const int64_t row0 = (u_lo + t) * kRows;
    float acc[2][2];
    tile_scores(q, e, row0, n_rows, q0, B, D, vec_ok, smem, acc);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int64_t qi = q0 + 2 * warp + j;
      if (qi >= B) continue;                       // warp-uniform
      float* V = lists_v + (2 * warp + j) * k;
      int32_t* I = lists_i + (2 * warp + j) * k;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int64_t row = row0 + lane + 32 * r;
        const bool ok = row < n_rows;
        float s = acc[j][r];
        if (bias != nullptr && ok)
          s = __fadd_rn(s, __fmul_rn(bias_weight, bias[qi * n_rows + row]));
        merge_scores(s, (int)row, ok, V, I, nf[j], k);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int64_t qi = q0 + 2 * warp + j;
    if (qi >= B) continue;
    const float* V = lists_v + (2 * warp + j) * k;
    const int32_t* I = lists_i + (2 * warp + j) * k;
    const int64_t out = (qi * splits + split) * k;
    for (int p = lane; p < k; p += 32) {
      part_v[out + p] = p < nf[j] ? V[p] : kNegInf;
      part_i[out + p] = p < nf[j] ? I[p] : -1;
    }
  }
}

// Phase 2: one warp per query merges its `splits` sorted lists of k.
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ part_v, const int32_t* __restrict__ part_i,
             int64_t B, int splits, int k, float* __restrict__ out_v,
             int32_t* __restrict__ out_i) {
  constexpr int kHeads = kMaxSplits / 32;
  const int lane = threadIdx.x & 31;
  const int64_t qi = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (qi >= B) return;                             // warp-uniform
  const float* pv = part_v + qi * splits * k;
  const int32_t* pi = part_i + qi * splits * k;
  int head[kHeads];
#pragma unroll
  for (int h = 0; h < kHeads; ++h) head[h] = 0;
  for (int o = 0; o < k; ++o) {
    float bv = kNegInf;
    int bi = -1, bh = -1;
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      const int s = lane + 32 * h;
      if (s < splits && head[h] < k) {
        const float v = pv[s * k + head[h]];
        const int id = pi[s * k + head[h]];
        if (beats(v, id, bv, bi)) {
          bv = v;
          bi = id;
          bh = h;
        }
      }
    }
    float wv = bv;
    int wi = bi, wl = lane;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, wv, off);
      const int oi = __shfl_xor_sync(kFull, wi, off);
      const int ol = __shfl_xor_sync(kFull, wl, off);
      if (beats(ov, oi, wv, wi) || (!beats(wv, wi, ov, oi) && ol < wl)) {
        wv = ov;
        wi = oi;
        wl = ol;
      }
    }
    if (lane == wl && wi >= 0) {
#pragma unroll
      for (int h = 0; h < kHeads; ++h) head[h] += (h == bh);
    }
    if (lane == 0) {
      out_v[qi * k + o] = wi >= 0 ? wv : kNegInf;
      out_i[qi * k + o] = wi;
    }
  }
}

size_t smem_bytes(int k) {
  return (size_t)kTileBytes + (size_t)kQ * k * 8;
}

template <typename T>
int launch(const void* q, const void* e, const float* bias, float bias_weight,
           long long B, long long n_rows, int D, int k, int vec_ok,
           long long units, int splits, void* part_v, void* part_i, void* out_v,
           void* out_i, cudaStream_t s) {
  const size_t smem = smem_bytes(k);
  auto kern = topk_partial_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((B + kQ - 1) / kQ), (unsigned)splits);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(e), bias, bias_weight, B,
      n_rows, D, k, vec_ok, units,
      static_cast<float*>(part_v), static_cast<int32_t*>(part_i));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps = kThreads / 32;
  merge_kernel<<<(unsigned)((B + warps - 1) / warps), kThreads, 0, s>>>(
      static_cast<const float*>(part_v), static_cast<const int32_t*>(part_i), B,
      splits, k, static_cast<float*>(out_v), static_cast<int32_t*>(out_i));
  return (int)cudaGetLastError();
}

int check(long long B, int D, int k, int splits) {
  if (k < 1 || k > kMaxK || splits < 1 || splits > kMaxSplits || D < 1)
    return (int)cudaErrorInvalidValue;
  if (B > 65535LL * kQ) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Corpus splits for B queries over `units` tiles: about four
// blocks for each SM, at most kMaxSplits, at most one split per unit.
extern "C" int anorag_topk_splits(long long B, long long units, int device) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long tiles = (B + kQ - 1) / kQ;
  long long s = (4LL * sms + tiles - 1) / tiles;
  if (s > kMaxSplits) s = kMaxSplits;
  if (s > units) s = units;
  return s < 1 ? 1 : (int)s;
}

// dtype 0 = bf16, 1 = f32. bias is (B, N) f32 or null. Returns the CUDA error
// code (0 on success); launches on `stream` of CUDA device `device`.
extern "C" int anorag_dense_topk(const void* q, const void* e, const void* bias,
                                 float bias_weight, int dtype, long long B,
                                 long long N, int D, int k, int vec_ok,
                                 int splits, void* part_v, void* part_i,
                                 void* out_v, void* out_i, int device,
                                 void* stream) {
  if (B <= 0) return 0;
  int err = check(B, D, k, splits);
  if (err) return err;
  err = (int)cudaSetDevice(device);
  if (err) return err;
  const long long units = (N + kRows - 1) / kRows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0)
    return launch<__nv_bfloat16>(q, e, b, bias_weight, B, N, D, k, vec_ok, units,
                                 splits, part_v, part_i, out_v, out_i, s);
  return launch<float>(q, e, b, bias_weight, B, N, D, k, vec_ok, units, splits,
                       part_v, part_i, out_v, out_i, s);
}
