// BM25 segment scan for Hopper (sm_90a): segment totals and segment
// winners, plain C interface for ctypes.
//
// Replaces the TPU kernels anorag_tpu/ops/bm25.py::_segment_totals_kernel
// (:184, via segment_totals_pallas :230) and ::_segment_winners_kernel
// (:287, via segment_winners_pallas :342). Same function:
//   input  a (B, L) int32 doc ids sorted per row (pad id = n_docs),
//          w (B, L) f32 Okapi weights (>= 0; 0 on pads);
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
// Row tiles with an in-order carry fold (segment_totals_tiles,
// segment_winners_tiles: one tile, scan_tile, that both kernels run). The
// carry of block j is the serial chain cs_{j+1} = fl(x_last_j + cs_j),
// cp_{j+1} = max(cp_j, cm_last_j). Rounding is monotone and every c >= 0,
// so cm_last_j = fl(xe_j + cs_j), xe_j the largest x at an end of block j
// (-inf with none), and inside a block cm[p - 1] = fl(xm[p] + cs) with
// xm[p] the largest x at an end before p. So a block's local scan and its
// summary (x_last, xe) need no carry; the carry is the same serial fold of
// the summaries, in block order. A tile is one block of a row and one
// warp's work; a persistent grid takes tiles from one atomic counter in
// (block, row) order, so a tile's predecessors in its row were handed out
// before it, to running warps, B tiles apart. A warp takes a tile only when
// it can scan and publish it without waiting (a tile held through a wait
// would chain the waits). It stages the block through its own 8 KB of
// shared memory (cp.async, 16 bytes a copy where the layout allows; each
// input byte read once), scans it, publishes its summary as one 64-bit
// word, then folds its row's summaries in block order from the latest
// published carry of the row (each carry is itself that fold, so the
// starting point does not change a bit; no partial aggregates are
// combined), publishes its own carry and computes its totals. A tile waits
// only on summaries, which need no carry, never on a chain of carries.
// Lane l holds positions 128c + 4l + i of 8 rows c: the add scan keeps the
// reference's step order, steps 1 and 2 inside the lane and from lane l -
// 1, steps 4-64 by one warp shuffle a value (lanes below the distance read
// the row below from the lanes that send it), steps 128-512 inside the
// lane; no CTA barrier. The row max is an integer atomicMax of each tile's
// maximum (all >= 0).
//   Totals: 4-warp CTAs, a warp a tile; the tile writes its masked totals.
//   Winners: 8-warp CTAs, a CTA a group of 8 consecutive blocks of one row
// (a warp a block), groups from the counter in (group, row) order. The
// group's winners are merged in shared memory (strict '>' in block order),
// then each bucket's into the row's table of 64-bit keys by one atomicMin
// of the key's complement (winner_key: the total's order, then the earlier
// block, so the minimum is the reference's winner), and its id into the
// group's id table. One atomic a bucket a group, not one a segment end:
// that would be about 12 million at (512, 32,768), and cost more than the
// whole walk (tools/segment_winners_breakdown.py, variant "group 1").
// Each row counts its finished groups; the CTA that finishes the last, in
// completion order, reads the row's keys back at L2 scope and decodes
// them: the value from the key, the id from the winning block's group's id
// table, (-3.0e38, -1) for a bucket no end reached. The plan's 16-byte
// copies are marked to leave L2 first, so the 4 MB key table that the
// groups merge into stays there while 134 MB of plan stream past.
// One memset sets the scratch to all ones: summaries unpublished, counter
// -1, mx -1 as int; for winners every row's count -1 and every key empty
// (its complement ~0); the id tables are written before they are read.
//
// The first design (segment_scan_kernel; its instances are kept only as the
// yardsticks the row tiles are timed against): rows are the parallel axis,
// one CTA per row walks its blocks in order, one thread per position of a
// block. At steps s < 32 lane l takes x[p - s] from lane l - s by a warp
// shuffle, and for l < s from lane l - s + 32 of the previous warp, tracked
// in a second register; at steps s >= 32 values go through shared memory
// (two buffers in turn, one barrier a step). The max scan is order-free:
// warp shuffles, then warp 0 combines the warps' maxima. The winners table
// lives in registers (thread p owns bucket p) and is written once.
//
// Bound: memory. Each position reads 8 bytes; totals writes 4 more, winners
// 8 * bl + 4 per row. About 20 adds, maxes and selects a position are far
// below the card's rates. At the main path's plan (B = 512, L = 32,768;
// chip_smoke.py) that is 201.3 MB (0.0601 ms at 3.35 TB/s) for totals and
// 138.4 MB (0.0413 ms) for winners; a 128-row bucket 32,768 wide moves
// 50.3 MB (0.0150 ms).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

// ------------------------------------- segment totals and winners: row tiles
constexpr int kRows = 8;              // a 1024-wide block as 8 rows of 128
constexpr int kTileWarps = 4;         // totals: warps a CTA, each on its own tiles
constexpr int kGroupWarps = 8;        // winners: warps a CTA, blocks of one row
constexpr unsigned long long kUnpublished = ~0ull;
constexpr unsigned kSpinLimit = 1u << 24;      // a lost publication traps

__device__ __forceinline__ unsigned long long ld_gpu(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_gpu(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// (lo, hi) as one word, published and read in one access
__device__ __forceinline__ unsigned long long pack(float lo, float hi) {
  return (unsigned long long)__float_as_uint(lo) |
         ((unsigned long long)__float_as_uint(hi) << 32);
}
__device__ __forceinline__ float lo_of(unsigned long long v) {
  return __uint_as_float((unsigned)v);
}
__device__ __forceinline__ float hi_of(unsigned long long v) {
  return __uint_as_float((unsigned)(v >> 32));
}

// A segment end's key in its bucket: the total's bits in an order-keeping
// map (order_bits: nonnegative, top bit set; negative, all bits flipped;
// rounding can leave a total a few ulps below 0, and none is -0) above
// 0xffffffff - jb, so the largest key is the largest total and, on a tie,
// the earliest block: the reference's strict '>' in block order. Every
// total's order_bits is > 0, so every key is.
__device__ __forceinline__ unsigned order_bits(float total) {
  const unsigned u = __float_as_uint(total);
  return u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
}
__device__ __forceinline__ unsigned long long winner_key(unsigned order, int jb) {
  return ((unsigned long long)order << 32) | (0xffffffffu - (unsigned)jb);
}
__device__ __forceinline__ float key_value(unsigned long long k) {
  const unsigned o = (unsigned)(k >> 32);
  return __uint_as_float(o ^ ((unsigned)((int)~o >> 31) | 0x80000000u));
}

// Warp-wide: the carry (cs, cp) into block jb of a row, folded in block
// order over the summaries of blocks [start, jb), from the carry of block
// start - 1, the latest published (or the row's start). One round trip
// reads the carries and summaries of the last 32 blocks.
__device__ __forceinline__ void fold_carry(const unsigned long long* summ,
                                           const unsigned long long* carry,
                                           int jb, int lane, float& cs,
                                           float& cp) {
  cs = 0.0f;
  cp = 0.0f;
  const int base = jb - 32, j = base + lane;   // lane l: block base + l
  unsigned long long c = kUnpublished, s = kUnpublished;
  if (j >= 0) {
    c = ld_gpu(carry + j);
    s = ld_gpu(summ + j);
  }
  int start = 0;
  unsigned got = __ballot_sync(kFull, c != kUnpublished);
  if (got) {
    const int src = 31 - __clz(got);
    c = __shfl_sync(kFull, c, src);
    cs = lo_of(c);
    cp = hi_of(c);
    start = base + src + 1;
  }
  for (int hi = base; !got && hi > 0; hi -= 32) {   // none in the last 32
    const int jj = hi - 32 + lane;
    unsigned long long cc = jj >= 0 ? ld_gpu(carry + jj) : kUnpublished;
    got = __ballot_sync(kFull, cc != kUnpublished);
    if (got) {
      const int src = 31 - __clz(got);
      cc = __shfl_sync(kFull, cc, src);
      cs = lo_of(cc);
      cp = hi_of(cc);
      start = hi - 32 + src + 1;
    }
  }
  const int mid = max(start, base);
  for (int lo = start; lo < mid; lo += 32) {   // summaries before the last 32
    const int jj = lo + lane;
    unsigned long long v = 0;
    if (jj < mid) {
      unsigned spins = 0;
      while ((v = ld_gpu(summ + jj)) == kUnpublished)
        if (++spins > kSpinLimit) __trap();
    }
    const int n = min(32, mid - lo);
    for (int i = 0; i < n; ++i) {
      const unsigned long long u = __shfl_sync(kFull, v, i);
      cp = fmaxf(cp, hi_of(u) + cs);   // cm_last = fl(xe + cs), or none
      cs = lo_of(u) + cs;
    }
  }
  if (j >= mid && j < jb) {   // the last 32 blocks' summaries, read above
    unsigned spins = 0;
    while (s == kUnpublished) {
      s = ld_gpu(summ + j);
      if (++spins > kSpinLimit) __trap();
    }
  }
  for (int i = mid - base; i < 32; ++i) {
    const unsigned long long u = __shfl_sync(kFull, s, i);
    cp = fmaxf(cp, hi_of(u) + cs);
    cs = lo_of(u) + cs;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

// The same copy marked to leave L2 first (policy: evict_first_policy)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           unsigned long long policy) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src), "l"(policy)
               : "memory");
}

__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

// One tile, block jb of a row, one warp: lane l holds positions 128c + 4l
// + i of the block, rows c = 0..7, i = 0..3. The block comes in through the
// warp's own 8 KB of shared memory (sid, sw; cp.async), so the ids are read
// a row at a time and never held whole in registers. stage_tile starts the
// copies (ar, wr: the row); scan_tile waits for them, publishes the tile's
// summary, folds its row's carry, publishes its carry, runs after_fold,
// and hands emit(c, out) its masked totals (valid ? total : -3.0e38) a row
// c at a time; it returns its largest valid total (at least 0). srow and
// crow are the row's summaries and carries.
// kEvict: the 16-byte copies are marked to leave L2 first (the winners'
// key table, reused, stays in L2 while the plan streams through it).
template <bool kVec, bool kEvict = false>
__device__ __forceinline__ void stage_tile(const int32_t* __restrict__ ar,
                                           const float* __restrict__ wr, int64_t L,
                                           int bl, int jb, int n_docs, int32_t* sid,
                                           float* sw, int lane) {
  const int64_t b0 = (int64_t)jb * bl;            // the block's first position
  const unsigned long long policy = kEvict ? evict_first_policy() : 0ull;
#pragma unroll
  for (int c = 0; c < kRows; ++c) {   // stage the block; pads past it
    const int p0 = 128 * c + 4 * lane;
    const int64_t t0 = b0 + p0;
    if (kVec && p0 < bl && t0 < L) {   // L and bl multiples of 4
      if (kEvict) {
        cp_async16(sid + p0, ar + t0, policy);
        cp_async16(sw + p0, wr + t0, policy);
      } else {
        cp_async16(sid + p0, ar + t0);
        cp_async16(sw + p0, wr + t0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (p0 + i < bl && t0 + i < L) {
          cp_async4(sid + p0 + i, ar + t0 + i);
          cp_async4(sw + p0 + i, wr + t0 + i);
        } else {
          sid[p0 + i] = n_docs;
          sw[p0 + i] = 0.0f;
        }
      }
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <class AfterFold, class Emit>
__device__ __forceinline__ float scan_tile(const int32_t* __restrict__ ar, int bl,
                                           int nb, int jb, int n_docs,
                                           const int32_t* sid, const float* sw,
                                           unsigned long long* srow,
                                           unsigned long long* crow, int lane,
                                           AfterFold after_fold, Emit emit) {
  const float kInf = __int_as_float(0x7f800000);
  const int64_t b0 = (int64_t)jb * bl;
  float x[kRows][4];
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncwarp();
  // segment ends: a[t] != a[t + 1]; past the row's last block, -1
  const int32_t after = jb + 1 < nb ? ar[b0 + bl] : -1;
  unsigned end_bits = 0, valid_bits = 0;          // bit 4c + i
#pragma unroll
  for (int c = 0; c < kRows; ++c) {
    const int p0 = 128 * c + 4 * lane;
    const int4 iv = *reinterpret_cast<const int4*>(sid + p0);
    const float4 wv = *reinterpret_cast<const float4*>(sw + p0);
    x[c][0] = wv.x; x[c][1] = wv.y; x[c][2] = wv.z; x[c][3] = wv.w;
    const int32_t id[4] = {iv.x, iv.y, iv.z, iv.w};
    const int32_t send = lane == 0 ? (c + 1 < kRows ? sid[128 * (c + 1)] : after) : id[0];
    const int32_t right = __shfl_sync(kFull, send, (lane + 1) & 31);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + i;
      const int32_t s = p == bl - 1 ? after : (i < 3 ? id[i + 1] : right);
      if (p < bl && id[i] != s) {
        end_bits |= 1u << (4 * c + i);
        if (id[i] < n_docs) valid_bits |= 1u << (4 * c + i);
      }
    }
  }
  __syncwarp();   // every lane's reads done before the next tile is staged

  // add scan in the reference's step order, rows in descending order so
  // that each step reads the rows below it before they change
  const int left = (lane - 1) & 31;
  if (bl > 1) {   // s = 1: lane 0 reads lane 31 of the row below
#pragma unroll
    for (int c = kRows - 1; c >= 0; --c) {
      const float send = lane == 31 ? (c > 0 ? x[c - 1][3] : 0.0f) : x[c][3];
      const float r = __shfl_sync(kFull, send, left);
      x[c][3] = x[c][3] + x[c][2]; x[c][2] = x[c][2] + x[c][1];
      x[c][1] = x[c][1] + x[c][0]; x[c][0] = x[c][0] + r;
    }
  }
  if (bl > 2) {   // s = 2
#pragma unroll
    for (int c = kRows - 1; c >= 0; --c) {
      const float s2 = lane == 31 ? (c > 0 ? x[c - 1][2] : 0.0f) : x[c][2];
      const float s3 = lane == 31 ? (c > 0 ? x[c - 1][3] : 0.0f) : x[c][3];
      const float r2 = __shfl_sync(kFull, s2, left);
      const float r3 = __shfl_sync(kFull, s3, left);
      x[c][3] = x[c][3] + x[c][1]; x[c][2] = x[c][2] + x[c][0];
      x[c][1] = x[c][1] + r3; x[c][0] = x[c][0] + r2;
    }
  }
  // s = 4m, m = 1..16: lane l - m of the row, or for l < m lane l - m + 32
  // of the row below; a lane >= 32 - m is read only by those, so it sends
  // the row below
  for (int m = 1; m < 32 && 4 * m < bl; m <<= 1) {
    const int from = (lane - m) & 31;
    const bool low = lane >= 32 - m;
#pragma unroll
    for (int c = kRows - 1; c >= 0; --c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float send = low ? (c > 0 ? x[c - 1][i] : 0.0f) : x[c][i];
        x[c][i] = x[c][i] + __shfl_sync(kFull, send, from);
      }
    }
  }
#pragma unroll
  for (int d = 1; d < kRows; d <<= 1) {   // s = 128d: row c - d, in the lane
    if (128 * d < bl) {
#pragma unroll
      for (int c = kRows - 1; c >= d; --c) {
#pragma unroll
        for (int i = 0; i < 4; ++i) x[c][i] = x[c][i] + x[c - d][i];
      }
    }
  }

  // the largest x at an end before each position: before this lane's
  // positions of row c, ex[c]; xe, the block's largest
  float ex[kRows], xe = -kInf;
#pragma unroll
  for (int c = 0; c < kRows; ++c) {
    float run = -kInf;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if ((end_bits >> (4 * c + i)) & 1u) run = fmaxf(run, x[c][i]);
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(kFull, run, o);
      if (lane >= o) run = fmaxf(run, v);
    }
    const float before = __shfl_up_sync(kFull, run, 1);
    ex[c] = fmaxf(xe, lane == 0 ? -kInf : before);
    xe = fmaxf(xe, __shfl_sync(kFull, run, 31));
  }
  float mine = 0.0f;   // x at the block's last position
#pragma unroll
  for (int c = 0; c < kRows; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (128 * c + 4 * lane + i == bl - 1) mine = x[c][i];
  const float xl = __shfl_sync(kFull, mine, ((bl - 1) & 127) >> 2);

  // publish the summary, fold the carry, publish it
  if (lane == 0 && jb + 1 < nb) st_gpu(srow + jb, pack(xl, xe));
  float cs, cp;
  fold_carry(srow, crow, jb, lane, cs, cp);
  if (lane == 0 && jb + 1 < nb) st_gpu(crow + jb, pack(xl + cs, fmaxf(cp, xe + cs)));
  after_fold();

  // totals: c - max(cp, cm[p - 1]), cm[p - 1] = fl(xm[p] + cs)
  float m = 0.0f;
#pragma unroll
  for (int c = 0; c < kRows; ++c) {
    float run = ex[c], out[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float total = (x[c][i] + cs) - fmaxf(cp, run + cs);
      const bool valid = (valid_bits >> (4 * c + i)) & 1u;
      out[i] = valid ? total : kNegInf;
      if (valid) m = fmaxf(m, total);
      if ((end_bits >> (4 * c + i)) & 1u) run = fmaxf(run, x[c][i]);
    }
    emit(c, out);
  }
  return m;
}

// Segment totals: one warp a tile, 6 CTAs of 4 warps an SM. Tiles in
// (block, row) order from one counter, so a tile's predecessors in its row
// were handed out before it, B tickets apart: by the time a tile folds, its
// predecessor has mostly published. A tile is taken only when the warp can
// scan and publish it without waiting (a tile held through a wait would
// chain the waits): first here, then right after the fold of the tile
// before. The counter starts at -1 (all ones): old + 1 counts from 0.
template <bool kVec>
__global__ void __launch_bounds__(32 * kTileWarps, 6)
segment_totals_tiles(const int32_t* __restrict__ a, const float* __restrict__ w,
                     int64_t L, int bl, int nb, long long n_tiles, int n_docs,
                     float* __restrict__ masked, unsigned long long* summ,
                     unsigned long long* carry, unsigned* counter,
                     int* mx_bits) {
  __shared__ __align__(16) int32_t stage_id[kTileWarps][kRows * 128];
  __shared__ __align__(16) float stage_w[kTileWarps][kRows * 128];
  const int lane = threadIdx.x & 31;
  int32_t* sid = stage_id[threadIdx.x >> 5];
  float* sw = stage_w[threadIdx.x >> 5];
  unsigned ticket = 0;
  if (lane == 0) ticket = atomicAdd(counter, 1u) + 1u;
  long long tile = __shfl_sync(kFull, ticket, 0);
  const long long n_rows = n_tiles / nb;
  while (tile < n_tiles) {
    const int64_t row = tile % n_rows;
    const int jb = (int)(tile / n_rows);
    const int64_t b0 = (int64_t)jb * bl;
    const int32_t* ar = a + row * L;
    stage_tile<kVec>(ar, w + row * L, L, bl, jb, n_docs, sid, sw, lane);
    const float m = scan_tile(
        ar, bl, nb, jb, n_docs, sid, sw, summ + row * nb, carry + row * nb, lane,
        [&] {
          if (lane == 0) ticket = atomicAdd(counter, 1u) + 1u;
        },
        [&](int c, const float (&out)[4]) {
          const int p0 = 128 * c + 4 * lane;
          float* dst = masked + row * L + b0 + p0;
          if (kVec && p0 < bl && b0 + p0 < L) {
            __stcs(reinterpret_cast<float4*>(dst), make_float4(out[0], out[1], out[2], out[3]));
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (p0 + i < bl && b0 + p0 + i < L) __stcs(dst + i, out[i]);
          }
        });
    // row max: totals >= 0 compare as their bits; -0 counts as 0
    const unsigned top = __reduce_max_sync(kFull, __float_as_uint(m) & 0x7fffffffu);
    if (lane == 0) atomicMax(mx_bits + row, (int)top);
    tile = __shfl_sync(kFull, ticket, 0);
  }
}

// Segment winners: the same tiles, a group of kGroupWarps consecutive
// blocks of one row a CTA (a warp a block), groups in (group, row) order
// from one counter; the CTA asks for its next group as it starts one and
// stages it as soon as the merge below has read the stages. Each warp
// leaves its block's masked totals in its weights stage; after a barrier
// thread t takes buckets t, t + 256, ...: the group's winner of each
// (strict '>' in block order) is merged into the row's key table by one
// atomicMin of its complemented key, so a bucket costs at most one atomic a
// group, not one a segment end; its id, read from the ids stage, goes to
// the group's id table. Each row counts its finished groups; the CTA that
// finishes the last, in completion order, reads the row's keys back at L2
// scope and decodes them: the value from the key, the id from the id table
// of the winning block's group.
template <bool kVec>
__global__ void __launch_bounds__(32 * kGroupWarps, 3)
segment_winners_tiles(const int32_t* __restrict__ a, const float* __restrict__ w,
                      int64_t L, int bl, int nb, long long n_groups, int n_docs,
                      float* __restrict__ win_v, int32_t* __restrict__ win_d,
                      unsigned long long* summ, unsigned long long* carry,
                      unsigned* counter, int* mx_bits, unsigned* row_done,
                      unsigned long long* keys, int32_t* ids) {
  extern __shared__ __align__(16) unsigned char smem[];   // kGroupWarps x 8 KB
  __shared__ long long s_next;
  __shared__ unsigned s_done;
  constexpr int kTile = kRows * 128, kThreads = 32 * kGroupWarps;
  constexpr int kPer = kTile / kThreads;   // buckets a thread
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t* sids = reinterpret_cast<const int32_t*>(smem);
  int32_t* sid = reinterpret_cast<int32_t*>(smem) + warp * kTile;
  float* stages = reinterpret_cast<float*>(smem) + kGroupWarps * kTile;
  float* sw = stages + warp * kTile;
  const int per_row = (nb + kGroupWarps - 1) / kGroupWarps;
  const long long n_rows = n_groups / per_row;
  // stage a group's blocks, a warp a block
  auto stage = [&](long long group) {
    const int64_t row = group % n_rows;
    const int jb = (int)(group / n_rows) * kGroupWarps + warp;
    if (group < n_groups && jb < nb)
      stage_tile<kVec, true>(a + row * L, w + row * L, L, bl, jb, n_docs, sid, sw, lane);
  };
  if (threadIdx.x == 0) s_next = (long long)(atomicAdd(counter, 1u) + 1u);
  __syncthreads();
  long long group = s_next;
  stage(group);
  while (group < n_groups) {
    unsigned ticket = 0;
    if (threadIdx.x == 0) ticket = atomicAdd(counter, 1u) + 1u;   // the next group
    const int64_t row = group % n_rows;
    const int g = (int)(group / n_rows), jb0 = g * kGroupWarps;
    const int n_blocks = min(kGroupWarps, nb - jb0);
    const int32_t* ar = a + row * L;
    if (warp < n_blocks) {
      float x[kRows][4];
      const float m = scan_tile(
          ar, bl, nb, jb0 + warp, n_docs, sid, sw, summ + row * nb, carry + row * nb, lane,
          [] {},
          [&](int c, const float (&out)[4]) {
#pragma unroll
            for (int i = 0; i < 4; ++i) x[c][i] = out[i];
          });
#pragma unroll
      for (int c = 0; c < kRows; ++c)   // the masked totals into the weights stage
        *reinterpret_cast<float4*>(sw + 128 * c + 4 * lane) =
            make_float4(x[c][0], x[c][1], x[c][2], x[c][3]);
      const unsigned top = __reduce_max_sync(kFull, __float_as_uint(m) & 0x7fffffffu);
      if (lane == 0) atomicMax(mx_bits + row, (int)top);
    }
    if (threadIdx.x == 0) s_next = (long long)ticket;
    __syncthreads();
    const long long next = s_next;
    unsigned long long* krow = keys + row * bl;
    int32_t* irow = ids + (row * per_row + g) * bl;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int p = threadIdx.x + j * kThreads;
      float best = kNegInf;   // -3.0e38 never wins, as in the reference
      int bj = -1;
      for (int k = 0; k < n_blocks; ++k) {
        const float v = stages[k * kTile + p];
        if (v > best) {
          best = v;
          bj = k;
        }
      }
      if (bj >= 0) {
        atomicMin(krow + p, ~winner_key(order_bits(best), jb0 + bj));
        irow[p] = sids[bj * kTile + p];
      }
    }
    // every thread's keys and ids performed before the row's count moves;
    // the stages read before the next group's copies land in them
    __threadfence();
    __syncthreads();
    stage(next);
    if (threadIdx.x == 0) s_done = atomicAdd(row_done + row, 1u) + 1u;   // groups before
    __syncthreads();
    if (s_done == (unsigned)per_row - 1u) {
      __threadfence();
      unsigned long long k[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int p = threadIdx.x + j * kThreads;
        k[j] = p < bl ? ~__ldcg(krow + p) : 0ull;
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int p = threadIdx.x + j * kThreads;
        if (p < bl) {   // the bucket's winner: its value, its id
          const int jb = (int)(0xffffffffu - (unsigned)k[j]);
          win_v[row * bl + p] = k[j] ? key_value(k[j]) : kNegInf;
          win_d[row * bl + p] =
              k[j] ? __ldcg(ids + (row * per_row + jb / kGroupWarps) * bl + p) : -1;
        }
      }
    }
    group = next;
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

// Scratch, int64 words: a summary and a carry a block, the tile counter, mx
// as B f32; for winners also a count of finished groups a row as B u32, a
// key a bucket, (B, bl), and then, not cleared (written before they are
// read), an id table a group of each row, (B, ceil(nb / 8), bl) int32. The
// rest is set to all ones: unpublished, tile -1, mx -1 as int, count -1,
// every key empty (its complement ~0).
template <bool kVec, bool kWinners>
int launch_tiles(const void* a, const void* w, void* masked, void* wv, void* wd,
                 void* scratch, long long B, long long L, int bl, int n_docs,
                 int device, cudaStream_t s) {
  const int nb = (int)((L + bl - 1) / bl);
  const long long n_tiles = B * nb;
  // winners: a CTA a group of kGroupWarps blocks, its stages dynamic
  const int warps = kWinners ? kGroupWarps : kTileWarps;
  const long long units = kWinners ? B * ((nb + kGroupWarps - 1) / kGroupWarps)
                                   : (n_tiles + kTileWarps - 1) / kTileWarps;
  const int smem = kWinners ? kGroupWarps * kRows * 128 * 8 : 0;
  const void* kernel = kWinners ? (const void*)segment_winners_tiles<kVec>
                                : (const void*)segment_totals_tiles<kVec>;
  cudaError_t err = cudaSuccess;
  if (kWinners)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * warps, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long grid = std::min<long long>(units, (long long)std::max(per_sm, 1) * sms);
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  const long long mx_word = 2 * n_tiles + 1, count_word = mx_word + (B + 1) / 2;
  const long long keys_word = count_word + (B + 1) / 2, ids_word = keys_word + B * bl;
  // the id tables are written before they are read: not cleared
  err = cudaMemsetAsync(scratch, 0xff, (kWinners ? ids_word : count_word) * 8, s);
  if (err != cudaSuccess) return (int)err;
  const int32_t* ap = static_cast<const int32_t*>(a);
  const float* wp = static_cast<const float*>(w);
  unsigned* counter = reinterpret_cast<unsigned*>(words + 2 * n_tiles);
  int* mx_bits = reinterpret_cast<int*>(words + mx_word);
  if (kWinners)
    segment_winners_tiles<kVec><<<(unsigned)grid, 32 * warps, smem, s>>>(
        ap, wp, L, bl, nb, units, n_docs, static_cast<float*>(wv),
        static_cast<int32_t*>(wd), words, words + n_tiles, counter, mx_bits,
        reinterpret_cast<unsigned*>(words + count_word), words + keys_word,
        reinterpret_cast<int32_t*>(words + ids_word));
  else
    segment_totals_tiles<kVec><<<(unsigned)grid, 32 * warps, 0, s>>>(
        ap, wp, L, bl, nb, n_tiles, n_docs, static_cast<float*>(masked), words,
        words + n_tiles, counter, mx_bits);
  return (int)cudaGetLastError();
}

template <bool kWinners>
int run_tiles(const void* a, const void* w, void* masked, void* wv, void* wd,
              void* scratch, long long B, long long L, int block_l, int n_docs,
              int device, void* stream) {
  if (B <= 0) return 0;
  if (L < 1 || block_l < 1 || block_l > kMaxBlockL || block_l > L ||
      B * ((L + block_l - 1) / block_l) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = L % 4 == 0 && block_l % 4 == 0 &&
                   ((uintptr_t)a | (uintptr_t)w | (uintptr_t)masked) % 16 == 0;
  return vec ? launch_tiles<true, kWinners>(a, w, masked, wv, wd, scratch, B, L, block_l,
                                            n_docs, device, s)
             : launch_tiles<false, kWinners>(a, w, masked, wv, wd, scratch, B, L, block_l,
                                             n_docs, device, s);
}

}  // namespace

// All launch on `stream` of CUDA device `device` and return the CUDA error
// code (0 on success). block_l is min(block_l, L), at most 1024.
//
// Row tiles (a warp a block). For totals `scratch` holds 2 * B * ceil(L /
// block_l) + 1 + ceil(B / 2) int64 words; for winners B * block_l +
// ceil(B / 2) more. The kernels write the row max (B f32) at word 2 * B *
// ceil(L / block_l) + 1, where the caller reads it.
extern "C" int anorag_segment_totals(const void* a, const void* w, void* masked,
                                     void* scratch, long long B, long long L,
                                     int block_l, int n_docs, int device,
                                     void* stream) {
  return run_tiles<false>(a, w, masked, nullptr, nullptr, scratch, B, L, block_l,
                          n_docs, device, stream);
}

extern "C" int anorag_segment_winners(const void* a, const void* w, void* wv,
                                      void* wd, void* scratch, long long B,
                                      long long L, int block_l, int n_docs,
                                      int device, void* stream) {
  return run_tiles<true>(a, w, nullptr, wv, wd, scratch, B, L, block_l, n_docs,
                         device, stream);
}

// The first kernels, one CTA a row: the yardsticks the row tiles are timed
// against. mx is (B) f32.
extern "C" int anorag_segment_totals_rows(const void* a, const void* w,
                                          void* masked, void* mx, long long B,
                                          long long L, int block_l, int n_docs,
                                          int device, void* stream) {
  return launch<false>(a, w, masked, nullptr, nullptr, mx, B, L, block_l,
                       n_docs, device, stream);
}

extern "C" int anorag_segment_winners_rows(const void* a, const void* w, void* wv,
                                           void* wd, void* mx, long long B,
                                           long long L, int block_l, int n_docs,
                                           int device, void* stream) {
  return launch<true>(a, w, nullptr, wv, wd, mx, B, L, block_l, n_docs,
                      device, stream);
}
