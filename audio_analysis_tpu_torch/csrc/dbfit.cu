// Decay fits over dB ranges (K5): for every row of a (rows, n) dB curve, up
// to kMaxRanges fits at once, each the whole contract of
// audio_analysis_tpu_torch/ops/dbfit.py fit_decay_slope_over_db_range: the
// interpolated crossings of the range's two levels (with `found`, and the
// index 0 that torch.argmax gives an all-false row), the window
// `i < length & t >= start & t <= end` with t = i * float32(1/sr), its point
// count, slope, intercept, r^2, RT60, and the `ok` flag.
//
// Replaces no TPU kernel: the JAX package's fits are jnp code under jit,
// which XLA fuses. On the card the same code ran as about 25 ATen passes
// over the (rows, n) plane per range, about 135 plane reads and writes for
// the engine's three ranges, most of them broadcast elementwise kernels
// below the streaming rate; a profile of the engine step put those passes at
// about 80% of the third-octave bands block, itself 89% of the step's
// device time. So this kernel was added.
//
// What bounds it: bytes. Every fit needs the curve read up to its lower
// crossing and its window read once; two reads of the plane are the most
// any input asks (at 52 rows x 1,155,072 samples, 0.14 ms at 3.35 TB/s).
//
// Design. Two launches (and a memset of three counters a row) on the
// caller's stream; no allocation, no host sync, no floating-point atomics.
// Both passes cut a row into blocks of a few 4096-sample steps (grid_for).
//   Pass 1 (dbfit_cross_kernel): a block finds, in one read of its span,
//   the first index at or below each distinct level of the ranges (the
//   engine's defaults have five: 0, -5, -10, -25 and -35 dB). It stops
//   after the first step in which every level is found, and publishes that
//   with an integer atomicMax per row; a block of a later span that sees it
//   reads nothing, since no later index can be first. The grid runs span
//   by span over all rows (block b is row b % rows, span b / rows), so the
//   later spans mostly start after that is published, and on a decaying
//   curve pass 1 reads little past the last crossing. The row's last block
//   (an integer ticket) takes each level's least index over the spans
//   (exact in any order), forms the crossing times with the plain
//   version's float32 operations in its order (__fmul_rn and friends, so
//   that nvcc contracts nothing into a fused multiply-add that torch's
//   separate kernels never form), and finds each window's first and last
//   index exactly, by evaluating the time axis at the window's ends (the
//   axis is monotone, so a window is one index range).
//   Pass 2 (dbfit_sum_kernel): the union of a row's windows is cut into
//   pieces of a span each, and the blocks past the last piece return at
//   once. A block reads its piece once and sums, per range,
//   a = t - t(first point), b = y - (the range's upper level), a a, a b and
//   b b in float64 (a and b are exact in float64 and their products nearly
//   so, and the H100's float64 rate is far above what these bytes need).
//   Partial sums reduce in a fixed order (a shuffle butterfly, then the
//   warps in order) and are stored per piece; the row's last piece (an
//   integer ticket; block 0 where the row has no window) adds them in piece
//   order and finishes the fits. So two calls give bit-identical output,
//   and only the sums differ from the plain version, which sums in
//   float32: crossing times, window membership and point counts are the
//   plain version's to the bit, and slope, intercept, r^2 and RT60 are the
//   float64 fit's over the same window, rounded once to float32. `ok`
//   tests the sign of that slope (and s_tt > 0, which both versions read
//   as num >= 2), so it is the plain version's to the bit where the sign
//   is clear of float32 rounding: on any curve that does not increase, as
//   the engine's EDCs do; an all but flat window may flip it.
// The span follows the shape, rows and n: 4 steps, or 2 or 1 where fewer
// would not give pass 1 two waves of the card's resident blocks, so a
// chunk's 16 broadband rows, 48 three-band rows and a tap's 52
// third-octave rows all fill the 132 SMs, as do the decimated lengths.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                             // floats per 16-byte access
constexpr int kRounds = 4;                          // 16-byte accesses in flight per thread
constexpr int kRoundStride = kThreads * kVec;       // samples between a thread's accesses
constexpr int kStep = kRoundStride * kRounds;       // 4096 samples a block reads per step
constexpr int kMaxSpanSteps = 4;                    // steps of one block's span or piece, at most
constexpr int kMaxRanges = 4;
constexpr int kMaxLevels = 2 * kMaxRanges;
constexpr int kStats = 5;                           // a, b, a a, a b, b b
constexpr int kSums = kMaxRanges * kStats;
constexpr int kFields = 6;                          // slope, intercept, r2, rt60, start, end
constexpr int kNone = 0x7fffffff;                   // no index at or below the level
constexpr unsigned kFull = 0xffffffffu;

struct Ranges {
  float level[kMaxLevels];      // distinct dB levels, in float32 as the plain version compares them
  int high[kMaxRanges];         // each range's upper level (its start), an index into `level`
  int low[kMaxRanges];          // ... and its effective lower level (its end)
  float high_level[kMaxRanges]; // level[high[r]]
  int num_levels, num_ranges, min_points;
  float dt;                     // float32(1 / sample rate): t = i * dt, rounded to float32
};

// a row's crossings and windows, written by pass 1's last block of the row
struct RowInfo {
  float t[kMaxLevels];             // each level's crossing time
  int found;                       // bit k: level k is reached
  int lo[kMaxRanges], hi[kMaxRanges];  // each range's window [lo, hi], empty when hi < lo
  int pad;
};

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ float time_at(int i, float dt) { return __fmul_rn((float)i, dt); }

// a[i] for a runtime i, by selection: a kernel parameter array indexed at
// run time would be copied to local memory
template <class T, int N>
__device__ __forceinline__ T pick(const T (&a)[N], int i) {
  T v = a[0];
#pragma unroll
  for (int k = 1; k < N; ++k) v = k == i ? a[k] : v;
  return v;
}

// the smallest i in [0, n] with time_at(i) >= s (n if none)
__device__ int first_at_or_after(float s, int n, float dt) {
  const double e = ceil((double)s / (double)dt);
  int i = e <= 0.0 ? 0 : e >= (double)n ? n : (int)e;
  while (i > 0 && time_at(i - 1, dt) >= s) --i;
  while (i < n && time_at(i, dt) < s) ++i;
  return i;
}

// the largest i in [-1, n) with time_at(i) <= s (-1 if none)
__device__ int last_at_or_before(float s, int n, float dt) {
  const double e = floor((double)s / (double)dt);
  int i = e < 0.0 ? -1 : e >= (double)(n - 1) ? n - 1 : (int)e;
  while (i + 1 < n && time_at(i + 1, dt) <= s) ++i;
  while (i >= 0 && time_at(i, dt) > s) --i;
  return i;
}

// samples [base, base + kStep) of a row, this thread's four 16-byte
// accesses; the ones at or past `end` read 0 (the caller skips them)
__device__ __forceinline__ void load_step(const float* xr, int base, int end, bool vec,
                                          float (&v)[kRounds][kVec]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int c = 0; c < kRounds; ++c) {
    const int o = base + c * kRoundStride + tid * kVec;
    if (vec && o + kVec <= end) {
      const float4 f = __ldcg(reinterpret_cast<const float4*>(xr + o));
      v[c][0] = f.x, v[c][1] = f.y, v[c][2] = f.z, v[c][3] = f.w;
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[c][j] = o + j < end ? __ldcg(xr + o + j) : 0.0f;
    }
  }
}

// Pass 1: per block, the first index of its span at or below each level;
// in the row's last block, the row's crossings and windows.
__global__ void __launch_bounds__(kThreads) dbfit_cross_kernel(
    const float* __restrict__ x, const int* __restrict__ lengths, int* __restrict__ firsts,
    unsigned* __restrict__ found_by, unsigned* __restrict__ tickets, RowInfo* __restrict__ info, int rows,
    int n, int per_row, int span, Ranges p) {
  __shared__ unsigned warp_found[kWarps];
  __shared__ int warp_first[kWarps][kMaxLevels];
  __shared__ int skip, last;
  __shared__ float cross_t[kMaxLevels];
  __shared__ int cross_found[kMaxLevels];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x % rows, g = blockIdx.x / rows;  // every row's first spans start first
  const float* xr = x + (long long)row * n;
  const int len = imin(imax(lengths[row], 0), n);
  const int lo = g * span;
  const int hi = imin(lo + span, len);
  const bool vec = (reinterpret_cast<uintptr_t>(xr) & 15) == 0;
  const unsigned all = (1u << p.num_levels) - 1u;
  // found_by[row]: per_row - g of the earliest span known to reach every
  // level; no index of a later span can be first
  const unsigned rank = (unsigned)(per_row - g);
  volatile unsigned* row_found_by = found_by + row;

  if (tid == 0) skip = *row_found_by > rank;
  __syncthreads();
  const bool read_any = lo < hi && !skip;  // uniform over the block
  int* block_firsts = firsts + ((long long)row * per_row + g) * kMaxLevels;
  int first[kMaxLevels];
#pragma unroll
  for (int k = 0; k < kMaxLevels; ++k) first[k] = kNone;
  for (int base = lo; base < hi && !skip; base += kStep) {
    float v[kRounds][kVec];
    load_step(xr, base, hi, vec, v);
    // a thread's samples rise in index with c and j, so its first hit is
    // its smallest
#pragma unroll
    for (int c = 0; c < kRounds; ++c) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int i = base + c * kRoundStride + tid * kVec + j;
#pragma unroll
        for (int k = 0; k < kMaxLevels; ++k)
          if (k < p.num_levels && i < hi && first[k] == kNone && v[c][j] <= p.level[k]) first[k] = i;
      }
    }
    unsigned found = 0;
#pragma unroll
    for (int k = 0; k < kMaxLevels; ++k) found |= (first[k] != kNone ? 1u : 0u) << k;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) found |= __shfl_xor_sync(kFull, found, off);
    if (lane == 0) warp_found[warp] = found;
    __syncthreads();
    unsigned block_found = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) block_found |= warp_found[w];
    const bool done = (block_found & all) == all;  // later indices of the span cannot be first
    if (tid == 0) {
      if (done) atomicMax(found_by + row, rank);
      skip = *row_found_by > rank;
    }
    __syncthreads();  // every thread has read warp_found, and sees `skip`, before the next step
    if (done) break;
  }

  // the span's first index of each level: none where it read nothing
  if (read_any) {
#pragma unroll
    for (int k = 0; k < kMaxLevels; ++k) {
      int m = first[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = imin(m, __shfl_xor_sync(kFull, m, off));
      if (lane == 0) warp_first[warp][k] = m;
    }
    __syncthreads();
  }
  if (tid < p.num_levels) {
    int m = kNone;
    if (read_any) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m = imin(m, warp_first[w][tid]);
    }
    block_firsts[tid] = m;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + row, 1u) == (unsigned)per_row - 1u;
  __syncthreads();
  if (!last) return;

  // the row's last block: each level's first index is the least over the
  // row's spans (exact in any order)
  __threadfence();
  {
    int m[kMaxLevels];
#pragma unroll
    for (int k = 0; k < kMaxLevels; ++k) m[k] = kNone;
    for (int b = tid; b < per_row; b += kThreads) {
      const int* f = firsts + ((long long)row * per_row + b) * kMaxLevels;
#pragma unroll
      for (int k = 0; k < kMaxLevels; ++k)
        if (k < p.num_levels) m[k] = imin(m[k], __ldcg(f + k));
    }
#pragma unroll
    for (int k = 0; k < kMaxLevels; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m[k] = imin(m[k], __shfl_xor_sync(kFull, m[k], off));
      if (lane == 0) warp_first[warp][k] = m[k];
    }
  }
  __syncthreads();
  // each level's crossing time: ops/dbfit.py crossing_time, operation for
  // operation in float32
  if (tid < p.num_levels) {
    int first_k = kNone;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) first_k = imin(first_k, warp_first[w][tid]);
    const bool found = first_k != kNone;
    const int idx = found ? first_k : 0;  // torch.argmax of an all-false row
    const int prev = idx > 0 ? idx - 1 : 0;
    const float y0 = xr[prev], y1 = xr[idx];
    const float t0 = time_at(prev, p.dt), t1 = time_at(idx, p.dt);
    const bool same = y1 == y0;
    const float q = __fdiv_rn(__fsub_rn(pick(p.level, tid), y0), same ? 1.0f : __fsub_rn(y1, y0));
    float frac = q < 0.0f ? 0.0f : q;  // torch.clamp(q, 0, 1), NaN kept
    frac = 1.0f < frac ? 1.0f : frac;
    const float interp = same ? t1 : __fadd_rn(t0, __fmul_rn(frac, __fsub_rn(t1, t0)));
    cross_t[tid] = idx == 0 ? 0.0f : interp;
    cross_found[tid] = found;
    info[row].t[tid] = cross_t[tid];
  }
  __syncthreads();
  // each range's window [lo, hi]: valid & t >= start & t <= end
  if (tid < p.num_ranges) {
    const float start = cross_t[pick(p.high, tid)], end = cross_t[pick(p.low, tid)];
    int w_lo = 0, w_hi = -1;
    if (start == start && end == end && len > 0) {  // a NaN time admits no point
      w_lo = first_at_or_after(start, n, p.dt);
      w_hi = imin(last_at_or_before(end, n, p.dt), len - 1);
    }
    info[row].lo[tid] = w_lo;
    info[row].hi[tid] = w_hi;
  }
  if (tid == 0) {
    int mask = 0;
    for (int k = 0; k < p.num_levels; ++k) mask |= cross_found[k] << k;
    info[row].found = mask;
  }
}

// Pass 2: the block's piece of the row's windows' sums and, in the row's
// last block, the fits.
__global__ void __launch_bounds__(kThreads) dbfit_sum_kernel(
    const float* __restrict__ x, const RowInfo* __restrict__ info, double* __restrict__ partials,
    unsigned* __restrict__ tickets, float* __restrict__ out_f, int* __restrict__ out_num,
    unsigned char* __restrict__ out_ok, int rows, int n, int per_row, int piece, Ranges p) {
  __shared__ double warp_sums[kWarps][kSums];
  __shared__ double totals[kSums];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x % rows, g = blockIdx.x / rows;  // every row's first pieces start first
  const float* xr = x + (long long)row * n;
  const RowInfo* ri = info + row;

  // the windows, and the block's piece of their union: pieces of `piece`
  // samples from the union's first multiple of kVec. A block past the
  // union's pieces has nothing to do, but block 0 of a row with no window
  // finishes its fits.
  int ulo = n, uhi = -1;
  int wlo[kMaxRanges], whi[kMaxRanges];
  float tref[kMaxRanges];
#pragma unroll
  for (int r = 0; r < kMaxRanges; ++r) {
    wlo[r] = r < p.num_ranges ? ri->lo[r] : 0;
    whi[r] = r < p.num_ranges ? ri->hi[r] : -1;
    if (whi[r] >= wlo[r]) ulo = imin(ulo, wlo[r]), uhi = imax(uhi, whi[r]);
    tref[r] = time_at(wlo[r], p.dt);
  }
  const int a_lo = ulo & ~(kVec - 1);
  const int pieces = uhi >= ulo ? (uhi + 1 - a_lo + piece - 1) / piece : 0;
  if (g >= imax(pieces, 1)) return;
  double acc[kMaxRanges][kStats];
#pragma unroll
  for (int r = 0; r < kMaxRanges; ++r)
#pragma unroll
    for (int s = 0; s < kStats; ++s) acc[r][s] = 0.0;
  const int p_lo = pieces > 0 ? a_lo + g * piece : 0;
  const int p_hi = pieces > 0 ? imin(p_lo + piece, uhi + 1) : 0;
  const bool vec = (reinterpret_cast<uintptr_t>(xr) & 15) == 0;
  for (int base = p_lo; base < p_hi; base += kStep) {
    float v[kRounds][kVec];
    load_step(xr, base, p_hi, vec, v);
#pragma unroll
    for (int c = 0; c < kRounds; ++c) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int i = base + c * kRoundStride + tid * kVec + j;
        if (i < p_hi) {
          const double t = (double)time_at(i, p.dt), y = (double)v[c][j];
#pragma unroll
          for (int r = 0; r < kMaxRanges; ++r) {
            if (i >= wlo[r] && i <= whi[r]) {
              // exact in float64: differences of float32 values
              const double a = t - (double)tref[r], b = y - (double)p.high_level[r];
              acc[r][0] += a;
              acc[r][1] += b;
              acc[r][2] += a * a;
              acc[r][3] += a * b;
              acc[r][4] += b * b;
            }
          }
        }
      }
    }
  }

  // the block's sums in a fixed order: a butterfly over each warp, then the
  // warps in order
#pragma unroll
  for (int r = 0; r < kMaxRanges; ++r) {
#pragma unroll
    for (int s = 0; s < kStats; ++s) {
      double a = acc[r][s];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(kFull, a, off);
      if (lane == 0) warp_sums[warp][r * kStats + s] = a;
    }
  }
  __syncthreads();
  if (tid < p.num_ranges * kStats) {
    double a = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += warp_sums[w][tid];
    partials[((long long)row * per_row + g) * kSums + tid] = a;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + row, 1u) == (unsigned)imax(pieces, 1) - 1u;
  __syncthreads();
  if (!last) return;

  // the row's last block: its pieces' sums in piece order, then the fits
  __threadfence();
  if (tid < p.num_ranges * kStats) {
    double a = 0.0;
    for (int b = 0; b < pieces; ++b) a += __ldcg(partials + ((long long)row * per_row + b) * kSums + tid);
    totals[tid] = a;
  }
  __syncthreads();
  if (tid < p.num_ranges) {
    const int r = tid, w_lo = ri->lo[r], w_hi = ri->hi[r];
    const int num = w_hi >= w_lo ? w_hi - w_lo + 1 : 0;
    const double t_ref = (double)time_at(w_lo, p.dt), y_ref = (double)pick(p.high_level, r);
    double slope = 0.0, intercept = 0.0, r2 = 0.0, s_tt = 0.0;
    if (num > 0) {
      const double* s = totals + r * kStats;
      const double ma = s[0] / num, mb = s[1] / num;
      s_tt = fmax(s[2] - s[0] * ma, 0.0);
      const double s_ty = s[3] - s[0] * mb;
      const double s_yy = fmax(s[4] - s[1] * mb, 0.0);
      slope = s_tt > 0.0 ? s_ty / s_tt : s_ty;
      intercept = (y_ref + mb) - slope * (t_ref + ma);
      const double ss_res = fmax(s_yy - slope * (2.0 * s_ty - slope * s_tt), 0.0);
      r2 = s_yy > 0.0 ? 1.0 - ss_res / s_yy : 0.0;
    }
    const int high = pick(p.high, r), low = pick(p.low, r);
    const float slope_f = (float)slope;
    const float start = ri->t[high], end = ri->t[low];
    const bool ok = ((ri->found >> high) & 1) && ((ri->found >> low) & 1) && end > start && num >= p.min_points &&
                    slope_f < 0.0f && s_tt > 0.0;
    float* o = out_f + (long long)r * kFields * rows + row;
    o[0] = slope_f;
    o[rows] = (float)intercept;
    o[2 * rows] = (float)r2;
    o[3 * rows] = __fdiv_rn(-60.0f, slope_f < 0.0f ? slope_f : -1.0f);
    o[4 * rows] = start;
    o[5 * rows] = end;
    out_num[(long long)r * rows + row] = num;
    out_ok[(long long)r * rows + row] = ok ? 1 : 0;
  }
}

// blocks of pass 1 the current card holds at once, asked once per card
// (kept per device, so a mesh of unlike cards sizes each one's grid by its
// own count); 0 if the runtime refuses to say
constexpr int kMaxDevices = 64;

int resident_blocks() {
  static int cached[kMaxDevices] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0) return 0;
  if (device < kMaxDevices && cached[device] != 0) return cached[device];
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dbfit_cross_kernel, kThreads, 0) != cudaSuccess)
    return 0;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  if (device < kMaxDevices) cached[device] = resident;
  return resident;
}

// The grid of both passes for (rows, n): a block takes `span_steps` steps
// of a row (pass 1's span, pass 2's piece), the most of 4, 2 and 1 that
// still gives pass 1 two waves of the card's resident blocks (1 below
// that). Short spans let the blocks that start after a row's last
// crossing is known skip their span, and keep the blocks of a long window
// many; longer ones cost fewer blocks. 0 steps for a shape the kernels do
// not take (n above 2^30 keeps every index sum of the kernels inside an
// int).
struct Grid {
  int span_steps, per_row;
};

Grid grid_for(long long rows, long long n) {
  if (rows <= 0 || n <= 0 || n > (1LL << 30)) return Grid{0, 0};
  const long long resident = resident_blocks();
  if (resident == 0) return Grid{0, 0};
  const long long steps = (n + kVec + kStep - 1) / kStep;  // pass 2's pieces start up to kVec - 1 early
  int s = kMaxSpanSteps;
  while (s > 1 && rows * ((steps + s - 1) / s) < 2 * resident) s /= 2;
  const long long per_row = (steps + s - 1) / s;
  if (rows * per_row > 0x7fffffffLL) return Grid{0, 0};
  return Grid{s, (int)per_row};
}

long long round8(long long bytes) { return (bytes + 7) / 8 * 8; }

}  // namespace

// Bytes of scratch `aa_dbfit` needs for (rows, n): three counters a row,
// each pass-1 block's first indices, each row's crossings and windows, and
// each pass-2 block's partial sums. -1 for a shape it does not take (n of 0
// or above 2^30, too many blocks) or a runtime error.
extern "C" long long aa_dbfit_scratch_bytes(long long rows, long long n) {
  if (rows <= 0) return 0;
  const Grid grid = grid_for(rows, n);
  if (grid.per_row == 0) return -1;
  const long long blocks = rows * grid.per_row;
  return round8(rows * 12) + blocks * kMaxLevels * 4 + rows * (long long)sizeof(RowInfo) + blocks * kSums * 8;
}

// x: (rows, n) float32 row-major dB curves; lengths: (rows,) int32 valid
// samples; scratch: aa_dbfit_scratch_bytes(rows, n) bytes, 8-byte aligned,
// its counters zeroed here on the stream; range_db: host memory, the
// (upper, effective lower) level of each of `num_ranges` ranges; dt:
// float32(1 / sample rate). Output, range-major: out_f (num_ranges, 6,
// rows) slope, intercept, r2, rt60, start and end time; out_num and out_ok
// (num_ranges, rows).
extern "C" int aa_dbfit(const float* x, const int* lengths, void* scratch, float* out_f, int* out_num,
                        unsigned char* out_ok, long long rows, long long n, float dt, const float* range_db,
                        int num_ranges, int min_points, void* stream) {
  if (rows <= 0) return 0;
  if (x == nullptr || lengths == nullptr || scratch == nullptr || out_f == nullptr || out_num == nullptr ||
      out_ok == nullptr || range_db == nullptr || num_ranges < 1 || num_ranges > kMaxRanges ||
      (reinterpret_cast<uintptr_t>(scratch) & 7) != 0)
    return (int)cudaErrorInvalidValue;
  const Grid grid = grid_for(rows, n);
  if (grid.per_row == 0) return (int)cudaErrorInvalidValue;
  Ranges p{};
  p.num_ranges = num_ranges;
  p.min_points = min_points;
  p.dt = dt;
  for (int r = 0; r < num_ranges; ++r) {
    for (int side = 0; side < 2; ++side) {
      const float level = range_db[2 * r + side];
      int k = 0;
      while (k < p.num_levels && !(p.level[k] == level)) ++k;
      if (k == p.num_levels) p.level[p.num_levels++] = level;
      (side == 0 ? p.high : p.low)[r] = k;
    }
    p.high_level[r] = p.level[p.high[r]];
  }
  const long long blocks = rows * grid.per_row;
  const int span = grid.span_steps * kStep;
  unsigned* found_by = static_cast<unsigned*>(scratch);
  unsigned* tickets1 = found_by + rows;
  unsigned* tickets2 = tickets1 + rows;
  int* firsts = reinterpret_cast<int*>(static_cast<char*>(scratch) + round8(rows * 12));
  RowInfo* info = reinterpret_cast<RowInfo*>(firsts + blocks * kMaxLevels);
  double* partials = reinterpret_cast<double*>(info + rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)rows * 12, s);
  if (err != cudaSuccess) return (int)err;
  dbfit_cross_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(x, lengths, firsts, found_by, tickets1, info, (int)rows,
                                                           (int)n, grid.per_row, span, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dbfit_sum_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(x, info, partials, tickets2, out_f, out_num, out_ok,
                                                         (int)rows, (int)n, grid.per_row, span, p);
  return (int)cudaGetLastError();
}
