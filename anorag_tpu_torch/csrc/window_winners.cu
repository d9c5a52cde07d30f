// BM25 window-winners for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel anorag_tpu/ops/bm25.py::_window_winners_kernel
// (:404), reached through window_winners_pallas (:549) and
// window_winners_tiled (:499). Same function:
//   input  ids and f32 Okapi weights of a sorted posting plan (pad id =
//          n_docs), max_seg in [1, 32]; position t of row r lives at
//          r * sb + (t / bl) * sj + t % bl: the (B, L) layout has sb = L,
//          sj = bl; plan_tiles' (L / bl, Bp, bl) layout sb = bl, sj = Bp * bl,
//          read in place;
//   at each position t in [1, n_pos) where a[t] != a[t-1] and a[t-1] is a
//   real doc, the total of doc a[t-1] is
//   w[t-1] + sum_{j=2..max_seg} w[t-j]*[a[t-j]==a[t-1]] (taps added in that
//   order, so sums are bit-equal to the reference); the total competes in
//   bucket t mod bl with strict '>', so the earliest position wins ties;
//   empty buckets keep (-3.0e38, -1); mx[row] = max(0, every total).
// Positions t >= len read as the pad id (the (B, L) layout's trailing pad
// column at t = L, n_pos = L + 1, without a copy); t < 0 as an id that is
// no doc, so t = 0 is never a start.
//
// Design: a staged walk per bucket range. A CTA owns a row and a range of
// R buckets [c0, c0 + R) (R a multiple of 4; the wrapper picks R so the
// grid fills the card) and walks the blocks j in order, which keeps the
// earliest-wins tie rule with no atomics. A 4-stage cp.async ring brings
// in, for each block, the ids and weights of t in [j*bl + c0 - 32,
// j*bl + c0 + R): the range and a left halo of 32 positions (max_seg <= 32
// taps back), 16 bytes a copy where the layout allows; about 25 KB in
// flight a CTA at R = 1024. A thread owns 4 neighbouring buckets and reads
// them and the 4 positions before them as 16-byte words (no bank
// conflicts); the taps come from those registers, then from shared
// memory, in the order j = 2..max_seg. Rows are
// sorted, so a doc's earlier positions sit next to each other and the
// taps stop at the first other doc: the taps added are the reference's
// (the rest add 0), in its order. The row max is folded into the one
// launch: all maxima are >= 0, so an integer atomicMax on their bits is
// exact (mx zeroed by a memset first).
//
// anorag_window_winners_threads keeps the first kernel (one thread per
// (row, bucket), taps read from global memory, a second launch reducing
// the row max) as the yardstick the staged walk is timed against.
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
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSentinel = -7;     // the id before position 0: never a doc
constexpr int kHalo = 32;         // taps back: max_seg <= 32
constexpr int kStages = 4;
constexpr int kMaxRange = 1024;   // 4 buckets a thread, 256 threads

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

struct Plan {
  const int32_t* a;
  const float* w;
  int64_t sb, sj;      // row and block strides, in elements
  int64_t len, n_pos;  // positions held in memory; positions walked
  int bl, nj, n_docs, max_seg, range, splits;
};

// Stage the ids and weights of t in [t0 - kHalo, t0 + R) into sid / sw.
template <bool kVec>
__device__ __forceinline__ void stage(const Plan& g, int64_t row, int64_t t0,
                                      int32_t* sid, float* sw) {
  const int n = kHalo + g.range;
  const int64_t rbase = row * g.sb;
  if (kVec) {   // bl, sb, sj, len and the bases 16-byte aligned: whole chunks
    for (int q = threadIdx.x; q < n / 4; q += blockDim.x) {
      const int64_t t = t0 - kHalo + 4 * q;
      if (t < 0 || t >= g.len) {
        const int32_t fill = t < 0 ? kSentinel : g.n_docs;
        *reinterpret_cast<int4*>(sid + 4 * q) = make_int4(fill, fill, fill, fill);
        *reinterpret_cast<float4*>(sw + 4 * q) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        const int64_t off = rbase + (t / g.bl) * g.sj + t % g.bl;
        cp_async16(sid + 4 * q, g.a + off);
        cp_async16(sw + 4 * q, g.w + off);
      }
    }
  } else {
    for (int q = threadIdx.x; q < n; q += blockDim.x) {
      const int64_t t = t0 - kHalo + q;
      if (t < 0 || t >= g.len) {
        sid[q] = t < 0 ? kSentinel : g.n_docs;
        sw[q] = 0.0f;
      } else {
        const int64_t off = rbase + (t / g.bl) * g.sj + t % g.bl;
        cp_async4(sid + q, g.a + off);
        cp_async4(sw + q, g.w + off);
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kMaxRange / 4)
window_winners_staged(Plan g, float* __restrict__ wv, int32_t* __restrict__ wd,
                      int* __restrict__ mx_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = kHalo + g.range;   // a multiple of 4: stages stay aligned
  int32_t* sid = reinterpret_cast<int32_t*>(smem);
  float* sw = reinterpret_cast<float*>(smem + (size_t)kStages * n * 4);
  const int64_t row = blockIdx.x / g.splits;
  const int c0 = (int)(blockIdx.x % g.splits) * g.range;
  const int u = threadIdx.x, q0 = kHalo + 4 * u;
  const int live = min(g.range, g.bl - c0) - 4 * u;   // buckets this thread owns
  float best[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
  int32_t best_id[4] = {-1, -1, -1, -1};
  float m = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < g.nj)
      stage<kVec>(g, row, (int64_t)s * g.bl + c0, sid + s * n, sw + s * n);
    cp_async_commit();
  }
  for (int j = 0; j < g.nj; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // block j staged; block j - 1's stage free again
    {
      const int jn = j + kStages - 1;
      if (jn < g.nj) {
        const int s = jn % kStages;
        stage<kVec>(g, row, (int64_t)jn * g.bl + c0, sid + s * n, sw + s * n);
      }
      cp_async_commit();
    }
    if (live <= 0) continue;   // past the range: only the barriers
    const int32_t* ids = sid + (j % kStages) * n;
    const float* ws = sw + (j % kStages) * n;
    const int64_t t0 = (int64_t)j * g.bl + c0 + 4 * u;
    // this thread's 4 positions and the 4 before them, 16 bytes a read:
    // a[t - 1] and the first taps come from registers
    const int4 i0 = *reinterpret_cast<const int4*>(ids + q0 - 4);
    const int4 i1 = *reinterpret_cast<const int4*>(ids + q0);
    const float4 w0 = *reinterpret_cast<const float4*>(ws + q0 - 4);
    const float4 w1 = *reinterpret_cast<const float4*>(ws + q0);
    const int32_t cid[8] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
    const float cw[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int32_t prev = cid[3 + i];
      if (i < live && t0 + i < g.n_pos && cid[4 + i] != prev && prev >= 0 &&
          prev < g.n_docs) {
        float s = cw[3 + i];
        bool more = true;   // taps j = 2..max_seg, up to the first other doc
#pragma unroll
        for (int tap = 2; tap <= i + 4; ++tap) {
          more = more && tap <= g.max_seg && cid[4 + i - tap] == prev;
          if (more) s += cw[4 + i - tap];
        }
        if (more) {
          const int q = q0 + i;
          for (int tap = i + 5; tap <= g.max_seg; ++tap) {
            if (ids[q - tap] != prev) break;
            s += ws[q - tap];
          }
        }
        if (s > best[i]) {
          best[i] = s;
          best_id[i] = prev;
        }
        m = fmaxf(m, s);
      }
    }
  }
  cp_async_wait<0>();
  const int64_t out = row * g.bl + c0 + 4 * u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < live) {
      wv[out + i] = best[i];
      wd[out + i] = best_id[i];
    }
  }
  const unsigned top = __reduce_max_sync(kFull, __float_as_uint(m) & 0x7fffffffu);
  if ((threadIdx.x & 31) == 0 && top != 0u) atomicMax(mx_bits + row, (int)top);
}

// ------------------------------------------- the first kernel, the yardstick
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
window_winners_threads(const int32_t* __restrict__ a, const float* __restrict__ w,
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
    m = fmaxf(m, __shfl_down_sync(kFull, m, off));
  __shared__ float warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? warp_max[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_down_sync(kFull, m, off));
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

// The staged walk over `rows` rows. range (a multiple of 4, at most 1024)
// and splits (range * splits >= block_l) come from the wrapper's plan
// (ops/bm25.py window_plan); wv, wd are (rows, block_l), mx (rows) f32.
// Launches on `stream` of CUDA device `device`; returns the CUDA error code
// (0 on success).
extern "C" int anorag_window_winners(const void* a, const void* w, void* wv,
                                     void* wd, void* mx, long long rows,
                                     long long sb, long long sj, long long len,
                                     long long n_pos, int block_l, int n_docs,
                                     int max_seg, int range, int splits,
                                     int device, void* stream) {
  if (rows <= 0) return 0;
  if (block_l < 1 || n_pos < 1 || max_seg < 1 || max_seg > kHalo || range < 4 ||
      range % 4 || range > kMaxRange || (long long)range * splits < block_l ||
      (long long)range * (splits - 1) >= block_l || rows * splits >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(mx, 0, (size_t)rows * 4, s);
  if (err != cudaSuccess) return (int)err;
  Plan g{static_cast<const int32_t*>(a), static_cast<const float*>(w), sb, sj,
         len, n_pos, block_l, (int)((n_pos + block_l - 1) / block_l), n_docs,
         max_seg, range, splits};
  const bool vec = block_l % 4 == 0 && sb % 4 == 0 && sj % 4 == 0 &&
                   len % 4 == 0 && ((uintptr_t)a | (uintptr_t)w) % 16 == 0;
  const int threads = ((range / 4) + 31) / 32 * 32;
  const size_t smem = (size_t)kStages * (kHalo + range) * 8;
  const unsigned grid = (unsigned)(rows * splits);
  if (vec)
    window_winners_staged<true><<<grid, threads, smem, s>>>(
        g, static_cast<float*>(wv), static_cast<int32_t*>(wd), static_cast<int*>(mx));
  else
    window_winners_staged<false><<<grid, threads, smem, s>>>(
        g, static_cast<float*>(wv), static_cast<int32_t*>(wd), static_cast<int*>(mx));
  return (int)cudaGetLastError();
}

// Number of (B, parts) f32 scratch columns the first kernel needs.
extern "C" int anorag_window_winners_threads_parts(int block_l) {
  return (block_l + kThreads - 1) / kThreads;
}

// The first kernel over a (B, L) plan, at most 65,535 rows.
extern "C" int anorag_window_winners_threads(
    const void* a, const void* w, void* wv, void* wd, void* mx, void* mx_part,
    long long B, long long L, long long n_pos, int block_l, int n_docs,
    int max_seg, int device, void* stream) {
  if (B <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int parts = anorag_window_winners_threads_parts(block_l);
  dim3 grid(parts, (unsigned)B);
  window_winners_threads<<<grid, kThreads, 0, s>>>(
      static_cast<const int32_t*>(a), static_cast<const float*>(w), L, n_pos,
      block_l, n_docs, max_seg, static_cast<float*>(wv),
      static_cast<int32_t*>(wd), static_cast<float*>(mx_part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  row_max_kernel<<<(unsigned)((B + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(mx_part), B, parts, static_cast<float*>(mx));
  return (int)cudaGetLastError();
}
