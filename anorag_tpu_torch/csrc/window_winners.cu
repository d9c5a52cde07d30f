// BM25 window-winners for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel anorag_tpu/ops/bm25.py::_window_winners_kernel
// (:404), reached through window_winners_pallas (:549) and
// window_winners_tiled (:499). Same function:
//   input  a (B, L) int32 doc ids sorted per row (pad id = n_docs),
//          w (B, L) f32 Okapi weights, max_seg in [1, 32];
//   at each position t where a[t] != a[t-1] and a[t-1] is a real doc, the
//   total of doc a[t-1] is w[t-1] + sum_{j=2..max_seg} w[t-j]*[a[t-j]==a[t-1]]
//   (taps added in that order, so sums are bit-equal to the reference);
//   the total competes in bucket t mod block_l with strict '>', so the
//   earliest position wins ties; empty buckets keep (-3.0e38, -1);
//   mx[row] = max(0, every total of the row).
// Positions run over [1, n_pos); a[t] for t >= L reads as the pad id, which
// gives the wrapper its trailing pad column without a copy.
//
// Design: one thread per (row, bucket c). It walks t = c, c + block_l, ...
// in order, which gives the earliest-wins tie rule with no atomics, and it
// reads the <= max_seg lookback taps straight from global memory: within a
// warp neighbouring threads read neighbouring positions, so the loads
// coalesce and the taps hit L1. The TPU's 128-lane carry between grid steps
// is not needed. Each block writes the max of its buckets to a (B, parts)
// scratch; a second tiny kernel reduces the parts into mx.
//
// Bound: memory. Each (row, position) needs 8 bytes read once, and each row
// writes 8 * block_l + 4 bytes; the taps are at most 2 * max_seg integer and
// f32 operations per position, far below the card's rates. At the main
// path's shape (B = 512, L = 32,768, block_l = 1024; chip_smoke.py) that
// is 138.4 MB, or 41.3 us at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -3.0e38f;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
window_winners_kernel(const int32_t* __restrict__ a, const float* __restrict__ w,
                      int64_t L, int64_t n_pos, int block_l, int n_docs,
                      int max_seg, float* __restrict__ wv,
                      int32_t* __restrict__ wd, float* __restrict__ mx_part) {
  const int64_t row = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int32_t* ar = a + row * L;
  const float* wr = w + row * L;
  float m = 0.0f;
  if (c < block_l) {
    float best = kNegInf;
    int32_t best_id = -1;
    // t = 0 has no predecessor and is never a segment start
    for (int64_t t = (c == 0 ? block_l : c); t < n_pos; t += block_l) {
      const int32_t prev = ar[t - 1];
      const int32_t cur = t < L ? ar[t] : n_docs;
      if (cur == prev || prev < 0 || prev >= n_docs) continue;
      float s = wr[t - 1];
      const int64_t lo = t - max_seg;
      for (int64_t u = t - 2; u >= lo && u >= 0; --u) {
        if (ar[u] == prev) s += wr[u];
      }
      if (s > best) {
        best = s;
        best_id = prev;
      }
      m = fmaxf(m, s);
    }
    wv[row * block_l + c] = best;
    wd[row * block_l + c] = best_id;
  }
  // block max of the per-thread maxima (all >= 0)
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, off));
  __shared__ float warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, off));
    if (lane == 0) mx_part[row * gridDim.x + blockIdx.x] = m;
  }
}

__global__ void row_max_kernel(const float* __restrict__ mx_part, int64_t B,
                               int parts, float* __restrict__ mx) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  float m = 0.0f;
  for (int p = 0; p < parts; ++p) m = fmaxf(m, mx_part[row * parts + p]);
  mx[row] = m;
}

}  // namespace

// Number of (B, parts) f32 scratch columns the caller allocates.
extern "C" int anorag_window_winners_parts(int block_l) {
  return (block_l + kThreads - 1) / kThreads;
}

// Launches on `stream` of CUDA device `device`; returns the CUDA error
// code (0 on success).
extern "C" int anorag_window_winners(const void* a, const void* w, void* wv,
                                     void* wd, void* mx, void* mx_part,
                                     long long B, long long L, long long n_pos,
                                     int block_l, int n_docs, int max_seg,
                                     int device, void* stream) {
  if (B <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int parts = anorag_window_winners_parts(block_l);
  dim3 grid(parts, (unsigned)B);
  window_winners_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int32_t*>(a), static_cast<const float*>(w), L, n_pos,
      block_l, n_docs, max_seg, static_cast<float*>(wv),
      static_cast<int32_t*>(wd), static_cast<float*>(mx_part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  row_max_kernel<<<(unsigned)((B + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(mx_part), B, parts, static_cast<float*>(mx));
  return (int)cudaGetLastError();
}
