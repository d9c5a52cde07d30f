// BM25 segment scan for Hopper (sm_90a): segment totals and segment
// winners, plain C interface for ctypes.
//
// Replaces the TPU kernels anorag_tpu/ops/bm25.py::_segment_totals_kernel
// (:184, via segment_totals_pallas :230) and ::_segment_winners_kernel
// (:287, via segment_winners_pallas :342). Same function:
//   input  a (B, L) int32 doc ids sorted per row (pad id = n_docs),
//          w (B, L) f32 Okapi weights (0 on pads);
//   each row is cut into blocks of bl = block_l <= 1024 positions, the last
//   padded with id n_docs and weight 0; per block, in this order:
//     x   = inclusive cumsum of w in Hillis-Steele log steps: at s = 1, 2,
//           4, ... < bl, x[p] = x[p] + (p >= s ? x[p - s] : 0), the order of
//           the reference's _prefix_scan (:166), so sums are bit-equal;
//     c   = x + carried c of the previous block's last position;
//     end = a[t] != a[t + 1] (a[t + 1] = -1 past the padded row);
//     cm  = log-step max scan of (end ? c : 0) (max is order-free);
//     tot = c - max(carried cm, cm[p - 1]);   valid = end && a[t] < n_docs;
//   totals: masked[t] = valid ? tot : -3.0e38;
//   winners: tot competes in bucket p with strict '>', so the earliest
//   block keeps ties; empty buckets keep (-3.0e38, -1);
//   mx[row] = max(0, every valid tot of the row).
//
// Design: the cumsum carries along a row, so rows are the parallel axis:
// one CTA per row walks its blocks in order, one thread per position of a
// block. The add scan keeps the reference's step order exactly: at steps
// s < 32 lane l takes x[p - s] from lane l - s by a warp shuffle, and for
// l < s from lane l - s + 32 of the previous warp, whose value each lane
// tracks in a second register (the same steps applied to the weights 32
// positions back; the lanes below s of that register are never read
// again); at steps s >= 32 values go through shared memory (two buffers in
// turn, one barrier a step). A Blelloch or thread-serial scan would add in
// another order. The max scan is order-free: warp shuffles, then warp 0
// combines the warps' maxima. So a 1024-wide block takes 8 barriers. The successor a[t + 1] is read
// from global memory (the neighbour's load brought it to L1), so no third
// (B, L) array is read. The next block's loads are issued before the
// current block's scan. The winners table lives in registers (thread p
// owns bucket p) and is written once; the (B, L) totals never reach memory
// in the winners kernel. The row max is a per-thread max reduced across
// the CTA at the end.
//
// Bound: memory. Each position reads 8 bytes; totals writes 4 more, winners
// 8 * bl + 4 per row. About 20 adds, maxes and selects a position are far
// below the card's rates. At the main path's plan (B = 512, L = 32,768;
// chip_smoke.py) that is 201.3 MB (0.0601 ms at 3.35 TB/s) for totals and
// 138.4 MB (0.0413 ms) for winners.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -3.0e38f;
constexpr int kMaxBlockL = 1024;

constexpr unsigned kFull = 0xffffffffu;

// One position of a row: its id, its successor's id, its weight, and the
// weight 32 positions back in the same block (0 before the block's start).
// Threads past the block's end (the last warp's tail) hold only the last:
// a live lane of their warp may read it.
struct Pos {
  int32_t id, nxt;
  float x, xp;
};

__device__ __forceinline__ Pos load_pos(const int32_t* __restrict__ ar,
                                        const float* __restrict__ wr,
                                        int64_t t, int p, bool live, int64_t L,
                                        int64_t Lp, int n_docs) {
  Pos q{n_docs, n_docs, 0.0f, 0.0f};
  if (live) {
    if (t < L) {
      q.id = ar[t];
      q.x = wr[t];
    }
    if (t + 1 < L)
      q.nxt = ar[t + 1];
    else if (t + 1 >= Lp)
      q.nxt = -1;
  }
  if (p >= 32 && t - 32 < L) q.xp = wr[t - 32];
  return q;
}

template <bool kWinners>
__global__ void __launch_bounds__(kMaxBlockL)
segment_scan_kernel(const int32_t* __restrict__ a, const float* __restrict__ w,
                    int64_t L, int block_l, int n_docs,
                    float* __restrict__ masked, float* __restrict__ wv,
                    int32_t* __restrict__ wd, float* __restrict__ mx) {
  __shared__ float buf[2][kMaxBlockL];
  __shared__ float warp_cm[kMaxBlockL / 32], warp_pre[kMaxBlockL / 32];
  __shared__ float tail_c, block_cm;
  const int64_t row = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31, warp = p >> 5, n_warps = blockDim.x >> 5;
  const bool live = p < block_l;
  const int32_t* ar = a + row * L;
  const float* wr = w + row * L;
  const int64_t Lp = (L + block_l - 1) / block_l * block_l;
  float cs = 0.0f, cp = 0.0f, m = 0.0f;
  float best = kNegInf;
  int32_t best_id = -1;
  Pos cur = load_pos(ar, wr, p, p, live, L, Lp, n_docs);
  for (int64_t base = 0; base < Lp; base += block_l) {
    const int64_t t = base + p;
    Pos next{n_docs, n_docs, 0.0f, 0.0f};
    if (base + block_l < Lp)
      next = load_pos(ar, wr, t + block_l, p, live, L, Lp, n_docs);

    // add scan, steps s < 32: x[p] + x[p - s], x[p - s] from this warp's
    // lane l - s or the previous warp's lane l - s + 32 (0 before the block)
    float x = cur.x, xp = cur.xp;
    for (int s = 1; s < 32 && s < block_l; s <<= 1) {
      const float up = __shfl_up_sync(kFull, x, s);
      // lane (l - s) & 31: xp of lane l - s, or of lane l - s + 32 for l < s
      const float from = __shfl_sync(kFull, xp, (lane - s) & 31);
      x = x + (lane >= s ? up : from);
      xp = xp + (lane >= s ? from : 0.0f);
    }
    // steps s >= 32 through shared memory
    int k = 0;
    for (int s = 32; s < block_l; s <<= 1, k ^= 1) {
      buf[k][p] = x;
      __syncthreads();
      x = x + (p >= s ? buf[k][p - s] : 0.0f);
    }
    const float c = x + cs;
    const bool is_end = cur.id != cur.nxt;
    // max scan of the end values (order-free): inside the warp, then the
    // earlier warps' maxima
    float y = is_end ? c : 0.0f;
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(kFull, y, o);
      if (lane >= o) y = fmaxf(y, v);
    }
    const float left = __shfl_up_sync(kFull, y, 1);   // cm[p - 1] in the warp
    if (lane == 31) warp_cm[warp] = y;
    if (p == block_l - 1) tail_c = c;
    __syncthreads();
    if (warp == 0) {  // each warp's max over the earlier warps, and over all
      float v = lane < n_warps ? warp_cm[lane] : 0.0f;
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v = fmaxf(v, u);
      }
      const float ex = __shfl_up_sync(kFull, v, 1);
      warp_pre[lane] = lane > 0 ? ex : 0.0f;
      if (lane == 31) block_cm = v;
    }
    __syncthreads();
    const float before = fmaxf(lane > 0 ? left : 0.0f, warp_pre[warp]);
    const float all = block_cm;
    const float total = c - fmaxf(cp, before);
    const bool valid = is_end && cur.id < n_docs;
    if (live) {
      if (valid) m = fmaxf(m, total);
      if (kWinners) {
        const float tv = valid ? total : kNegInf;
        if (tv > best) {
          best = tv;
          best_id = cur.id;
        }
      } else if (t < L) {
        masked[row * L + t] = valid ? total : kNegInf;
      }
    }
    cs = tail_c;
    cp = fmaxf(cp, all);
    cur = next;
    __syncthreads();  // every read done before the next block writes
  }
  if (kWinners && live) {
    wv[row * block_l + p] = best;
    wd[row * block_l + p] = best_id;
  }
  // row max: the per-thread maxima (all >= 0) reduced across the CTA
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_down_sync(kFull, m, off));
  if (lane == 0) warp_cm[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < n_warps ? warp_cm[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_down_sync(kFull, m, off));
    if (lane == 0) mx[row] = m;
  }
}

template <bool kWinners>
int launch(const void* a, const void* w, void* masked, void* wv, void* wd,
           void* mx, long long B, long long L, int block_l, int n_docs,
           int device, void* stream) {
  if (B <= 0) return 0;
  if (L < 1 || block_l < 1 || block_l > kMaxBlockL || block_l > L)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = (block_l + 31) / 32 * 32;
  segment_scan_kernel<kWinners><<<(unsigned)B, threads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const float*>(w), L, block_l,
      n_docs, static_cast<float*>(masked), static_cast<float*>(wv),
      static_cast<int32_t*>(wd), static_cast<float*>(mx));
  return (int)cudaGetLastError();
}

}  // namespace

// Both launch on `stream` of CUDA device `device` and return the CUDA error
// code (0 on success). block_l is min(block_l, L), at most 1024.
extern "C" int anorag_segment_totals(const void* a, const void* w, void* masked,
                                     void* mx, long long B, long long L,
                                     int block_l, int n_docs, int device,
                                     void* stream) {
  return launch<false>(a, w, masked, nullptr, nullptr, mx, B, L, block_l,
                       n_docs, device, stream);
}

extern "C" int anorag_segment_winners(const void* a, const void* w, void* wv,
                                      void* wd, void* mx, long long B,
                                      long long L, int block_l, int n_docs,
                                      int device, void* stream) {
  return launch<true>(a, w, nullptr, wv, wd, mx, B, L, block_l, n_docs,
                      device, stream);
}
