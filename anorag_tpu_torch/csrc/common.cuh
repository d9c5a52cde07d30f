// Building blocks shared by the top-k kernels for Hopper (sm_90a):
// streaming_topk.cu and ivf_scan.cu include this header, and _build.py
// hashes it with each source, so an edit rebuilds both.
//   - the rank rule of every list: filled first, score descending, row
//     ascending (beats);
//   - cp.async copies of 16 bytes (zero-filled when the source is not read);
//   - ldmatrix fragment loads and mma.sync m16n8k16 (bf16 in, f32 sums);
//   - phase 2 of both kernels: one warp per query merges its sorted
//     partial lists of k into its output (merge_kernel, merge).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -3.0e38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMergeThreads = 256;
constexpr int kMaxLists = 256;   // sorted lists one merge warp takes

// a ranks before b: filled first, then score descending, then row ascending
__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  if (ai < 0) return false;
  if (bi < 0) return true;
  return av > bv || (av == bv && ai < bi);
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Phase 2: one warp per query merges its `lists` sorted lists of k
// (part_v / part_i (B, lists, k), at most kMaxLists) into out (B, k): each
// lane holds the heads of lists lane, lane + 32, ...; k rounds of a warp
// arg-max by the rank rule, the winner's head advancing.
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ part_v, const int32_t* __restrict__ part_i,
             int64_t B, int lists, int k, float* __restrict__ out_v,
             int32_t* __restrict__ out_i) {
  constexpr int kHeads = kMaxLists / 32;
  const int lane = threadIdx.x & 31;
  const int64_t qi = (int64_t)blockIdx.x * (kMergeThreads / 32) + (threadIdx.x >> 5);
  if (qi >= B) return;                             // warp-uniform
  const float* pv = part_v + qi * lists * k;
  const int32_t* pi = part_i + qi * lists * k;
  int head[kHeads];
#pragma unroll
  for (int h = 0; h < kHeads; ++h) head[h] = 0;
  for (int o = 0; o < k; ++o) {
    float bv = kNegInf;
    int bi = -1, bh = -1;
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      const int s = lane + 32 * h;
      if (s < lists && head[h] < k) {
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

int merge(const float* pv, const int32_t* pi, long long B, int lists, int k,
          float* ov, int32_t* oi, cudaStream_t s) {
  constexpr int kWarpsPerCta = kMergeThreads / 32;
  merge_kernel<<<(unsigned)((B + kWarpsPerCta - 1) / kWarpsPerCta), kMergeThreads,
                 0, s>>>(pv, pi, B, lists, k, ov, oi);
  return (int)cudaGetLastError();
}

}  // namespace
