// Display pooling of the spectrogram figure with its colour percentiles: a
// (C, T, F) float32 dB plane max-pooled onto log-frequency rows and column
// buckets, and the 99.5th and 5th percentiles of each channel's selected
// valid region, all quantised to the 1/128-dB int16 fixed point.
//
// Replaces the compiled device program of audio_analysis_tpu/ops/display.py:151
// (_pooled_image_dev, one jax.jit of masked_percentiles, a shifted-max
// pyramid along F and a one-hot selection matmul). The output is the
// (C, rows, T' + 1) int16 image, T' = ceil(T / col_pool), in the figure's
// (row, column) orientation. Cell (c, r, j), j < T', is the maximum of the
// plane over the frames t in [j col_pool, (j + 1) col_pool) with
// t < num_frames[c], and over the bins [i0 + lo_r, i0 + lo_r + w_r) of row r
// (ops/display.py _log_row_spans); a cell with no such frame is -3e38 (the
// pyramid's identity of max). Column T' holds the percentiles in rows 0
// and 1 and 0 in the rest. Every cell is quantised as quantize_db_i16 does:
// clamp to +-255.99, times 128, round half to even, to int16; NaN, which
// max passes on as the pyramid does, becomes 0 as torch's cast makes it.
//
// The percentiles are exact, with masked_percentiles' contract
// (ops/selectq.py): over each channel's finite cells of the valid frames'
// selected bins, n of them, the order statistics at floor(r) and ceil(r),
// r = float32(q / 100) * float32(n - 1), interpolated as
// v_lo + frac * (v_hi - v_lo) with every operation rounded in that order
// (the _rn intrinsics: no fused multiply-add); NaN for n = 0. They come
// from a radix selection on each value's order-preserving 32-bit key
// (the sign bit flipped for a positive float, every bit for a negative
// one), 12 + 10 + 10 bits:
//   pass 1 reads the region once: it max-pools every cell and histograms
//          the keys' top 12 bits in shared memory, folded into each
//          channel's global counts with atomics. Its last block (an atomic
//          ticket) finds from the counts the bucket of each of the four
//          order statistics and the rank left inside it;
//   pass 2 and pass 3 read the region again (from L2: 28 MB at the
//          report's call) and histogram the next 10 bits of the keys in
//          the chosen buckets; their last blocks fix those bits, and pass
//          3's writes the two percentiles.
// Counts are exact, so ties come out as the sort's: a value that holds
// many cells (the dB floor of a decaying tail) fills its bucket, and the
// rank lands on it. -0 sorts below +0 here and level with it in the sort;
// either gives the same int16. Every count stays on the device: one memset
// and three launches, no host synchronisation.
//
// What bounds it: bytes, the selected bins of the valid frames read once
// and the image written once (9.2 us at the report's call at 3.35 TB/s).
// The selection reads the region twice more; the design keeps those reads
// in L2 and keeps every pass's loads in flight:
//   pass 1: a block of 256 threads (4 a multiprocessor) takes a few
//          neighbouring columns of one channel; each thread loads 8 bins of
//          two frames at a stride of 256 (16 coalesced 4-byte loads in
//          flight; a frame's row starts at any 4-byte offset when F is odd,
//          so 16-byte loads would need a ragged head and tail), and issues
//          the next item's loads before it counts and reduces the current
//          one. The column's bin maxima
//          are staged in shared memory, each thread reduces its rows' bin
//          ranges out of it (rows narrower than a bin repeat one bin; the
//          rows widen with frequency, so every other pass over them runs
//          backwards), and the block's quantised columns wait in a shared
//          tile and leave row by row;
//   passes 2 and 3: as many blocks as fit at once (two a multiprocessor),
//          each thread with 8 frames' loads (64) in flight; an element
//          costs one vote unless its key has a target's prefix.
// Warps whose 32 keys fall in one bucket (the floor) add 32 once, not 32
// times to one address. The last blocks copy a histogram with all of a
// thread's loads in flight, scan it block-wide and keep the targets in
// shared memory. Max is exact, so the image is bit-equal to the pyramid's.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBinsPerThread = 8;
constexpr int kChunk = kThreads * kBinsPerThread;  // bins of a frame staged at once
constexpr int kRefineFrames = 8;  // frames a refinement pass loads at once
constexpr int kTopBits = 12;
constexpr int kTopBuckets = 1 << kTopBits;
constexpr int kLowBits = 10;
constexpr int kLowBuckets = 1 << kLowBits;
constexpr int kTargets = 4;  // floor and ceil rank of the 99.5th, then of the 5th percentile
constexpr int kSlotsWords = kTargets * kLowBuckets;
static_assert(kSlotsWords == kTopBuckets, "one shared histogram size serves every pass");
// scratch: 4 tickets, then per channel its state (n, 3 spare, then per
// target: key prefix, rank inside the prefix, histogram slot, spare) and
// the three passes' histograms
constexpr int kTickets = 4;
constexpr int kStateWords = 4 + 4 * kTargets;
constexpr int kChannelWords = kStateWords + 3 * kTopBuckets;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -3.0e38f;
constexpr float kDbClip = 255.99f;
constexpr float kDbScale = 128.0f;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr size_t kPass1StaticSmem = 1024;  // bounds pass 1's static shared memory (the last block's scratch)

// max that passes a NaN on, as torch.maximum and amax do
__device__ __forceinline__ float max_nan(float m, float v) { return (v > m || v != v) ? v : m; }

__device__ __forceinline__ short quantize_db(float v) {
  if (v != v) return 0;
  v = fminf(fmaxf(v, -kDbClip), kDbClip);
  return (short)rintf(__fmul_rn(v, kDbScale));
}

__device__ __forceinline__ bool finite(float v) { return (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u; }

// order-preserving key of a float: a < b <=> key(a) < key(b) (-0 < +0)
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// q / 100 in float32, as ops/selectq.py _fractions forms it
__device__ __forceinline__ float target_fraction(int target) {
  return __fdiv_rn(target < 2 ? 99.5f : 5.0f, 100.0f);
}

// the fractional rank r = q (n - 1) of a target's percentile
__device__ __forceinline__ float target_position(int target, unsigned n) {
  return __fmul_rn(target_fraction(target), (float)(n - 1u));
}

// 0-based rank of a target's order statistic: floor(r), then ceil(r)
__device__ __forceinline__ unsigned target_rank(int target, unsigned n) {
  const float r = target_position(target, n);
  return (unsigned)((target & 1) ? ceilf(r) : floorf(r));
}

// hist[digit] += 1 for each lane with `ok`; all 32 lanes call it. A warp
// whose lanes all count one digit adds 32 once.
__device__ __forceinline__ void count_digit(unsigned* hist, bool ok, unsigned digit) {
  const unsigned first = __shfl_sync(kFull, digit, 0);
  if (__all_sync(kFull, ok && digit == first)) {
    if ((threadIdx.x & 31) == 0) atomicAdd(hist + digit, 32u);
  } else if (ok) {
    atomicAdd(hist + digit, 1u);
  }
}

__device__ __forceinline__ unsigned warp_inclusive_sum(unsigned v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// after every thread's atomics: true in the block that finishes last
__device__ __forceinline__ bool last_block(unsigned* ticket) {
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

// A block-wide scan of a histogram `h` (shared) of blockDim.x * per
// buckets: thread t owns buckets [t per, (t + 1) per), summed from a
// rotated start so that a warp's loads fall in distinct banks. Every
// thread calls it; `warp_sums` is shared scratch of 32 words.
struct Scan {
  unsigned before;  // the count in the buckets before this thread's
  unsigned own;     // the count in this thread's buckets
  unsigned total;
};

__device__ __forceinline__ Scan block_scan(const unsigned* h, int per, unsigned* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  unsigned own = 0;
  for (int i = 0; i < per; ++i) own += h[threadIdx.x * per + ((i + threadIdx.x) & (per - 1))];
  const unsigned incl = warp_inclusive_sum(own);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned w = warp_inclusive_sum(lane < warps ? warp_sums[lane] : 0u);
    if (lane < warps) warp_sums[lane] = w;
  }
  __syncthreads();
  const Scan scan = {(warp > 0 ? warp_sums[warp - 1] : 0u) + incl - own, own, warp_sums[warps - 1]};
  __syncthreads();
  return scan;
}

// The bucket d of `h` with sum(h[< d]) <= rank < sum(h[<= d]), and the
// rank left inside it: true, with *bucket and *rest set, in the one thread
// whose buckets hold the rank.
__device__ __forceinline__ bool locate(const unsigned* h, int per, const Scan& scan, unsigned rank, unsigned* bucket,
                                       unsigned* rest) {
  if (rank < scan.before || rank - scan.before >= scan.own) return false;
  unsigned cum = scan.before;
  int d = threadIdx.x * per;
  while (cum + h[d] <= rank) cum += h[d++];
  *bucket = (unsigned)d;
  *rest = rank - cum;
  return true;
}

// sh[0, kTopBuckets) = src[0, kTopBuckets) (global, just summed by every
// block: read from L2), all of a thread's loads in flight at once
__device__ __forceinline__ void copy_histogram(unsigned* sh, const unsigned* src) {
  constexpr int kPer = kTopBuckets / kThreads;
  unsigned r[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) r[i] = __ldcg(src + i * kThreads + threadIdx.x);
#pragma unroll
  for (int i = 0; i < kPer; ++i) sh[i * kThreads + threadIdx.x] = r[i];
}

// A channel's selection state while a last block works on it, in shared
// memory: each target's key prefix, rank inside the prefix and histogram
// slot (targets that share a prefix share the first one's slot).
struct Targets {
  unsigned prefix[kTargets], rank[kTargets], slot[kTargets];
};

// thread 0, after the block has set every prefix and rank: the slots, and
// the state to global memory for the next pass
__device__ __forceinline__ void publish(Targets& tg, unsigned* st, unsigned n) {
  st[0] = n;
  for (int i = 0; i < kTargets; ++i) {
    tg.slot[i] = (unsigned)i;
    for (int j = 0; j < i; ++j)
      if (tg.prefix[j] == tg.prefix[i]) {
        tg.slot[i] = tg.slot[j];
        break;
      }
    st[4 + 4 * i] = tg.prefix[i];
    st[4 + 4 * i + 1] = tg.rank[i];
    st[4 + 4 * i + 2] = tg.slot[i];
  }
}

// pass 1's last block: n and each target's 12-bit bucket, per channel
__device__ __forceinline__ void select_top(unsigned* sh, unsigned* scratch, long long channels) {
  __shared__ unsigned warp_sums[32];
  __shared__ Targets tg;
  for (long long c = 0; c < channels; ++c) {
    unsigned* st = scratch + kTickets + c * kChannelWords;
    const unsigned* hist = st + kStateWords;
    copy_histogram(sh, hist);
    __syncthreads();
    const int per = kTopBuckets / kThreads;
    const Scan scan = block_scan(sh, per, warp_sums);
    const unsigned n = scan.total;
    for (int i = 0; i < kTargets && n > 0; ++i) {
      unsigned bucket, rest;
      if (locate(sh, per, scan, target_rank(i, n), &bucket, &rest)) {
        tg.prefix[i] = bucket;
        tg.rank[i] = rest;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) publish(tg, st, n);
    __syncthreads();
  }
}

// pass 2's or 3's last block: each target's next 10 bits; after pass 3
// the keys are whole, and the two percentiles go to column T' of out
__device__ __forceinline__ void select_low(unsigned* sh, unsigned* scratch, int pass, long long channels, short* out,
                                           int rows, long long cols) {
  __shared__ unsigned warp_sums[32];
  __shared__ Targets tg, next;
  for (long long c = 0; c < channels; ++c) {
    unsigned* st = scratch + kTickets + c * kChannelWords;
    const unsigned* hist = st + kStateWords + (pass - 1) * kTopBuckets;
    const unsigned n = __ldcg(st);
    if (n == 0) {
      if (pass == 3 && threadIdx.x == 0)  // no valid cell: NaN, quantised to 0
        for (int p = 0; p < 2 && p < rows; ++p) out[((c * rows) + p) * (cols + 1) + cols] = 0;
      continue;  // the same for the whole block
    }
    copy_histogram(sh, hist);
    if (threadIdx.x < kTargets) {
      tg.prefix[threadIdx.x] = __ldcg(st + 4 + 4 * threadIdx.x);
      tg.rank[threadIdx.x] = __ldcg(st + 4 + 4 * threadIdx.x + 1);
      tg.slot[threadIdx.x] = __ldcg(st + 4 + 4 * threadIdx.x + 2);
    }
    __syncthreads();
    const int per = kLowBuckets / kThreads;
    for (int s = 0; s < kTargets; ++s) {
      if (tg.slot[s] != (unsigned)s) continue;  // not a slot's owner: the same for the whole block
      const Scan scan = block_scan(sh + s * kLowBuckets, per, warp_sums);
      for (int i = s; i < kTargets; ++i) {
        unsigned digit, rest;
        if (tg.slot[i] == (unsigned)s && locate(sh + s * kLowBuckets, per, scan, tg.rank[i], &digit, &rest)) {
          next.prefix[i] = (tg.prefix[i] << kLowBits) | digit;
          next.rank[i] = rest;
        }
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      publish(next, st, n);
      for (int p = 0; pass == 3 && p < 2 && p < rows; ++p) {
        const float r = target_position(2 * p, n);
        const float frac = __fsub_rn(r, floorf(r));
        const float lo = key_value(next.prefix[2 * p]), hi = key_value(next.prefix[2 * p + 1]);
        out[((c * rows) + p) * (cols + 1) + cols] = quantize_db(__fadd_rn(lo, __fmul_rn(frac, __fsub_rn(hi, lo))));
      }
    }
    __syncthreads();
  }
}

// The frames [t, t + 2) of one column's bins [b0, b0 + kChunk) that a
// pass-1 block loads at once, and the step to the next such item: the
// column's next two frames, else its next chunk of bins, else the next
// column. A column with no valid frame is one item with nothing to load.
struct Item {
  long long j;  // column
  int b0;       // first bin of the chunk
  long long t;  // first frame of the pair
};

// Pass 1. Block (c, g) pools columns [g cpb, (g + 1) cpb) of channel c and
// histograms their valid frames' keys. The next item's loads are issued
// before the current item is counted and reduced.
__global__ void __launch_bounds__(kThreads, 4)
    pool_pass1_kernel(const float* __restrict__ x, const long long* __restrict__ num_frames,
                      const int* __restrict__ spans, unsigned* __restrict__ scratch, short* __restrict__ out,
                      long long channels, long long frames, long long bins, int i0, int n_sel, int rows,
                      int col_pool, long long cols, int groups, int cpb) {
  extern __shared__ float4 pool_smem[];
  unsigned* hist = reinterpret_cast<unsigned*>(pool_smem);  // kTopBuckets
  float* pooled = reinterpret_cast<float*>(hist + kTopBuckets);  // kChunk
  float* acc = pooled + kChunk;  // rows
  int* row_lo = reinterpret_cast<int*>(acc + rows);  // rows
  int* row_hi = row_lo + rows;  // rows
  short* tile = reinterpret_cast<short*>(row_hi + rows);  // rows x cpb
  const long long c = blockIdx.x / groups, g = blockIdx.x % groups;
  const long long j0 = g * cpb, j1 = j0 + cpb < cols ? j0 + cpb : cols;
  long long valid = num_frames[c];
  valid = valid < 0 ? 0 : (valid > frames ? frames : valid);
  const long long stride = cols + 1;
  short* o = out + c * rows * stride;
  for (int d = threadIdx.x; d < kTopBuckets; d += kThreads) hist[d] = 0;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    row_lo[r] = spans[2 * r];
    row_hi[r] = spans[2 * r] + spans[2 * r + 1];
    acc[r] = kNeg;
  }
  if (g == 0)
    for (int r = 2 + threadIdx.x; r < rows; r += kThreads) o[r * stride + cols] = 0;
  __syncthreads();

  const float* plane = x + c * frames * bins + i0;
  auto end_of = [&](long long j) { return j * col_pool + col_pool < valid ? j * col_pool + col_pool : valid; };
  auto load = [&](const Item& it, float (&v)[2][kBinsPerThread]) {
    const long long t1 = end_of(it.j);
    const float* row = plane + it.t * bins + it.b0;
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int u = 0; u < kBinsPerThread; ++u) {
        const int k = threadIdx.x + u * kThreads;
        v[f][u] = it.t + f < t1 && it.b0 + k < n_sel ? row[f * bins + k] : 0.0f;
      }
  };
  Item cur = {j0, 0, j0 * col_pool};
  float v[2][kBinsPerThread], m[kBinsPerThread];
#pragma unroll
  for (int u = 0; u < kBinsPerThread; ++u) m[u] = kNeg;
  if (j0 < j1) load(cur, v);
  while (cur.j < j1) {
    const long long t1 = end_of(cur.j);
    const bool chunk_done = cur.t + 2 >= t1;
    const bool column_done = chunk_done && cur.b0 + kChunk >= n_sel;
    Item nxt = cur;
    if (!chunk_done) {
      nxt.t += 2;
    } else if (!column_done) {
      nxt.b0 += kChunk;
      nxt.t = cur.j * col_pool;
    } else {
      nxt = {cur.j + 1, 0, (cur.j + 1) * col_pool};
    }
    float w[2][kBinsPerThread];
    if (nxt.j < j1) load(nxt, w);  // the same for the whole block

    const int nb = n_sel - cur.b0 < kChunk ? n_sel - cur.b0 : kChunk;
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      if (cur.t + f >= t1) break;  // the same for the whole block
#pragma unroll
      for (int u = 0; u < kBinsPerThread; ++u) {
        if (u * kThreads >= nb) break;  // the same for the whole block
        const bool in = threadIdx.x + u * kThreads < nb;
        count_digit(hist, in && finite(v[f][u]), order_key(v[f][u]) >> (32 - kTopBits));
        if (in) m[u] = max_nan(m[u], v[f][u]);
      }
    }
    if (chunk_done) {
#pragma unroll
      for (int u = 0; u < kBinsPerThread; ++u) {
        const int k = threadIdx.x + u * kThreads;
        if (k < nb) pooled[k] = m[u];
        m[u] = kNeg;
      }
      __syncthreads();
      // rows widen with frequency: every other pass of 256 rows runs
      // backwards, so a thread's rows mix narrow and wide; two running
      // maxima halve the chain of shared loads
      for (int base_row = 0; base_row < rows; base_row += kThreads) {
        const int r = base_row + ((base_row / kThreads) & 1 ? kThreads - 1 - threadIdx.x : threadIdx.x);
        if (r >= rows) continue;
        const int lo = row_lo[r] - cur.b0, hi = row_hi[r] - cur.b0;
        const int s0 = lo > 0 ? lo : 0, e = hi < nb ? hi : nb;
        float mm = acc[r], m2 = kNeg;
        int i = s0;
        for (; i + 1 < e; i += 2) {
          mm = max_nan(mm, pooled[i]);
          m2 = max_nan(m2, pooled[i + 1]);
        }
        if (i < e) mm = max_nan(mm, pooled[i]);
        mm = max_nan(mm, m2);
        if (column_done) {
          tile[r * cpb + (cur.j - j0)] = quantize_db(mm);
          mm = kNeg;
        }
        acc[r] = mm;
      }
      __syncthreads();
    }
    cur = nxt;
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int u = 0; u < kBinsPerThread; ++u) v[f][u] = w[f][u];
  }
  const int width = (int)(j1 > j0 ? j1 - j0 : 0);
  for (int e = threadIdx.x; e < rows * width; e += kThreads) {
    const int r = e / width, jj = e - r * width;
    o[r * stride + j0 + jj] = tile[r * cpb + jj];
  }

  unsigned* global_hist = scratch + kTickets + c * kChannelWords + kStateWords;
  for (int d = threadIdx.x; d < kTopBuckets; d += kThreads)
    if (hist[d]) atomicAdd(global_hist + d, hist[d]);
  if (last_block(scratch)) select_top(hist, scratch, channels);
}

// Passes 2 and 3. Block (c, g) reads frames [g fpb, (g + 1) fpb) of
// channel c's valid region and histograms, for each target slot, the next
// 10 bits of the keys whose leading bits are the slot's prefix.
__global__ void __launch_bounds__(kThreads)
    pool_refine_kernel(const float* __restrict__ x, const long long* __restrict__ num_frames,
                       unsigned* __restrict__ scratch, short* __restrict__ out, long long channels,
                       long long frames, long long bins, int i0, int n_sel, int rows, long long cols, int groups,
                       int fpb, int pass) {
  __shared__ unsigned hist[kSlotsWords];
  const long long c = blockIdx.x / groups, g = blockIdx.x % groups;
  unsigned* st = scratch + kTickets + c * kChannelWords;
  const unsigned n = __ldcg(st);
  // each slot's key prefix, or none where the target shares another's slot
  unsigned prefix[kTargets];
  bool owner[kTargets];
#pragma unroll
  for (int i = 0; i < kTargets; ++i) {
    prefix[i] = __ldcg(st + 4 + 4 * i);
    owner[i] = __ldcg(st + 4 + 4 * i + 2) == (unsigned)i;
  }
  for (int d = threadIdx.x; d < kSlotsWords; d += kThreads) hist[d] = 0;
  __syncthreads();

  const int shift = pass == 2 ? 32 - kTopBits : 32 - kTopBits - kLowBits;  // bits below the prefix
  if (n > 0) {
    long long valid = num_frames[c];
    valid = valid < 0 ? 0 : (valid > frames ? frames : valid);
    const long long f0 = g * fpb, f1 = f0 + fpb < valid ? f0 + fpb : valid;
    const float* plane = x + c * frames * bins + i0;
    for (int b0 = 0; b0 < n_sel; b0 += kChunk) {
      for (long long t = f0; t < f1; t += kRefineFrames) {
        // kRefineFrames frames' loads in flight at once
        float v[kRefineFrames][kBinsPerThread];
#pragma unroll
        for (int f = 0; f < kRefineFrames; ++f) {
          const float* row = plane + (t + f) * bins + b0;
#pragma unroll
          for (int u = 0; u < kBinsPerThread; ++u) {
            const int k = threadIdx.x + u * kThreads;
            v[f][u] = t + f < f1 && b0 + k < n_sel ? row[k] : 0.0f;
          }
        }
#pragma unroll
        for (int f = 0; f < kRefineFrames; ++f) {
          if (t + f >= f1) break;  // the same for the whole block
#pragma unroll
          for (int u = 0; u < kBinsPerThread; ++u) {
            if (b0 + u * kThreads >= n_sel) break;  // the same for the whole block
            const bool ok = b0 + threadIdx.x + u * kThreads < n_sel && finite(v[f][u]);
            const unsigned key = order_key(v[f][u]);
            const unsigned top = key >> shift;
            // the owners' prefixes differ: at most one slot matches
            bool hit = false;
            unsigned slot = 0;
#pragma unroll
            for (int i = 0; i < kTargets; ++i)
              if (owner[i] && top == prefix[i]) {
                hit = true;
                slot = (unsigned)i;
              }
            hit = hit && ok;
            if (__any_sync(kFull, hit))
              count_digit(hist, hit, slot * kLowBuckets + ((key >> (shift - kLowBits)) & (kLowBuckets - 1)));
          }
        }
      }
    }
  }
  __syncthreads();
  unsigned* global_hist = st + kStateWords + (pass - 1) * kTopBuckets;
  for (int d = threadIdx.x; d < kSlotsWords; d += kThreads)
    if (hist[d]) atomicAdd(global_hist + d, hist[d]);
  if (last_block(scratch + pass - 1)) select_low(hist, scratch, pass, channels, out, rows, cols);
}

size_t pass1_smem(int rows, int cpb) {
  const size_t bytes = sizeof(unsigned) * kTopBuckets + sizeof(float) * (kChunk + rows) + sizeof(int) * 2 * rows +
                       sizeof(short) * rows * cpb;
  return (bytes + 15) / 16 * 16;
}

// resident blocks of a kernel on the whole card (at least 1)
template <class K>
long long resident_blocks(K kernel, size_t smem) {
  int device = 0, sms = 1, per_sm = 1;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) != cudaSuccess)
    return 1;
  const long long blocks = (long long)sms * per_sm;
  return blocks > 0 ? blocks : 1;
}

// `items` split over about `blocks` blocks: (blocks, items a block)
void split(long long items, long long blocks, int* groups, int* per) {
  if (items < 1) items = 1;
  if (blocks > items) blocks = items;
  if (blocks < 1) blocks = 1;
  const long long each = (items + blocks - 1) / blocks;
  *per = (int)each;
  *groups = (int)((items + each - 1) / each);
}

}  // namespace

// Bytes of scratch that aa_pool_image needs for `channels` channels.
extern "C" long long aa_pool_scratch_bytes(long long channels) {
  return channels < 0 ? 0 : (long long)sizeof(unsigned) * (kTickets + channels * kChannelWords);
}

// x: (channels, frames, bins) float32 row-major; num_frames: (channels,)
// int64; spans: (rows, 2) int32 (lo, w), each range inside the selection
// [i0, i0 + n_sel); scratch: aa_pool_scratch_bytes(channels) bytes; out:
// (channels, rows, ceil(frames / col_pool) + 1) int16. A memset of the
// scratch and three launches; nothing is allocated. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for negative sizes, a
// selection outside the bins, a col_pool below 1, null pointers, more
// cells in a channel's region than 32-bit counts hold, rows that do not
// fit in shared memory or a grid too large.
extern "C" int aa_pool_image(const float* x, const long long* num_frames, const int* spans, unsigned* scratch,
                             short* out, long long channels, long long frames, long long bins, int i0, int n_sel,
                             int rows, int col_pool, void* stream) {
  if (channels < 0 || frames < 0 || bins < 0 || i0 < 0 || n_sel < 1 || (long long)i0 + n_sel > bins || rows < 0 ||
      col_pool < 1)
    return (int)cudaErrorInvalidValue;
  if (channels == 0 || rows == 0) return 0;
  if (x == nullptr || num_frames == nullptr || spans == nullptr || scratch == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (frames * n_sel > 0xffffffffLL) return (int)cudaErrorInvalidValue;
  const long long cols = (frames + col_pool - 1) / col_pool;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  int groups1 = 1, cpb = 1;
  const size_t smem_one = pass1_smem(rows, 1);
  if (smem_one + kPass1StaticSmem > kMaxSmem) return (int)cudaErrorInvalidValue;
  split(cols, (resident_blocks(pool_pass1_kernel, smem_one) + channels - 1) / channels, &groups1, &cpb);
  const size_t smem = pass1_smem(rows, cpb);
  if (smem + kPass1StaticSmem > kMaxSmem) return (int)cudaErrorInvalidValue;
  int groups2 = 1, fpb = 1;
  split(frames, (resident_blocks(pool_refine_kernel, 0) + channels - 1) / channels, &groups2, &fpb);
  if (groups1 > 0x7fffffffLL / channels || groups2 > 0x7fffffffLL / channels) return (int)cudaErrorInvalidValue;

  if (smem + kPass1StaticSmem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(pool_pass1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaError_t zeroed = cudaMemsetAsync(scratch, 0, (size_t)aa_pool_scratch_bytes(channels), s);
  if (zeroed != cudaSuccess) return (int)zeroed;
  pool_pass1_kernel<<<(unsigned)(channels * groups1), kThreads, smem, s>>>(
      x, num_frames, spans, scratch, out, channels, frames, bins, i0, n_sel, rows, col_pool, cols, groups1, cpb);
  for (int pass = 2; pass <= 3; ++pass) {
    pool_refine_kernel<<<(unsigned)(channels * groups2), kThreads, 0, s>>>(
        x, num_frames, scratch, out, channels, frames, bins, i0, n_sel, rows, cols, groups2, fpb, pass);
  }
  return (int)cudaGetLastError();
}
