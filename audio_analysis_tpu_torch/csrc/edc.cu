// Schroeder energy decay curve in dB, one row per (tap, channel, band).
//
// Replaces the TPU kernel audio_analysis_tpu/ops/pallas_kernels.py
// schroeder_edc_db_pallas (body _edc_kernel) and computes the whole contract
// of audio_analysis_tpu/ops/edc.py schroeder_edc_db in one call: energy
// x^2 masked past the row's `length`, backward (suffix) sum, eps floor,
// normalisation by the value at index 0, 10*log10, display floor, and 0
// past `length`. Any row length N is taken (the TPU kernel needed
// N % 16384 == 0).
//
// What bounds it: memory traffic. The curve needs one read and one write of
// N floats per row; this two-pass scheme reads each row twice (the second
// read often hits the 50 MB L2) and writes it once, with a few flops per
// sample.
//
// Design. The TPU kernel walked each row tail-first through one sequential
// grid, carrying the running sum in scratch memory. Hopper's blocks run in
// parallel and in no order, so the carry becomes a second pass:
//   pass 1: each (row, tile) block computes its tile's total;
//   pass 2: each block sums the totals of the tiles after its own (its
//           carry) and the row total, redoes the in-tile reverse scan and
//           writes the dB curve.
// The in-tile scan is a per-thread serial suffix over 16 consecutive
// samples, a warp suffix scan with shuffles, and a suffix over the warp
// totals in shared memory. Every suffix is formed by adding the samples
// after it, never as total - prefix: that difference cancels
// catastrophically on fast decays, where the tail is 1e-12 of the total.
// Sums are fp32 and deterministic (fixed order, no atomics), and the
// tile-0 total of pass 1 is bit-identical to the value pass 2 forms at
// index 0, so index 0 is exactly 0 dB. log10f is the accurate libdevice
// function, not __log10f.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;                   // consecutive samples per thread
constexpr int kTile = kThreads * kItems;     // samples per block
constexpr int kWarps = kThreads / 32;

// one pad word per 32 floats: the per-thread runs of 16 consecutive
// samples then fall on 32 distinct banks
__device__ __forceinline__ int padded(int j) { return j + (j >> 5); }

template <bool kFinal>
__global__ void __launch_bounds__(kThreads) edc_kernel(
    const float* __restrict__ x, const int* __restrict__ lengths,
    float* __restrict__ tile_sums, float* __restrict__ out, long long n,
    int num_tiles, float eps, float floor_db) {
  __shared__ float buf[kTile + kTile / 32];
  __shared__ float warp_total[kWarps];
  __shared__ float reduce_a[kWarps];
  __shared__ float reduce_b[kWarps];

  const long long row = blockIdx.x / num_tiles;
  const int tile = blockIdx.x % num_tiles;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long len = lengths[row];
  const long long tile0 = (long long)tile * kTile;
  const float* xr = x + row * n;

  // coalesced load of the tile's masked energy into shared memory
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + tid;
    const long long g = tile0 + j;
    float e = 0.0f;
    if (g < n && g < len) {
      const float s = xr[g];
      e = s * s;
    }
    buf[padded(j)] = e;
  }

  // pass 2: this tile's carry (sum of the tiles after it) and the row's
  // sum over tiles 1.., one fixed-order block reduction for both
  float carry = 0.0f, after_first = 0.0f;
  if (kFinal) {
    const float* sums = tile_sums + row * num_tiles;
    float a = 0.0f, b = 0.0f;
    for (int u = num_tiles - 1 - tid; u >= 1; u -= kThreads) {
      const float v = sums[u];
      if (u > tile) a += v;
      b += v;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    if (lane == 0) {
      reduce_a[warp] = a;
      reduce_b[warp] = b;
    }
  }
  __syncthreads();
  if (kFinal) {
    for (int w = kWarps - 1; w >= 0; --w) {
      carry += reduce_a[w];
      after_first += reduce_b[w];
    }
  }

  // per-thread serial suffix over its kItems consecutive samples
  float s[kItems];
  float acc = 0.0f;
#pragma unroll
  for (int k = kItems - 1; k >= 0; --k) {
    acc += buf[padded(tid * kItems + k)];
    s[k] = acc;
  }

  // sum of this tile's samples after this thread's run: later lanes of the
  // warp (shuffle suffix scan), then later warps
  float incl = acc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += y;
  }
  float excl = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) excl = 0.0f;
  if (lane == 0) warp_total[warp] = incl;
  __syncthreads();
  float later_warps = 0.0f;
  for (int w = kWarps - 1; w > warp; --w) later_warps += warp_total[w];
  const float thread_carry = later_warps + excl;

  if (!kFinal) {
    // the tile's total: the in-tile suffix at its first sample
    if (tid == 0) tile_sums[row * num_tiles + tile] = s[0] + thread_carry;
    return;
  }

  // row total = tile 0's total + the tiles after it; at tile 0, index 0
  // this is exactly the same sum as the curve's value there
  const float total = tile_sums[row * num_tiles] + after_first;
  const float denom = fmaxf(total, eps);
  __syncthreads();  // every thread has read buf: reuse it for the output
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = tid * kItems + k;
    const float suffix = (s[k] + thread_carry) + carry;
    float db = 10.0f * log10f(fmaxf(suffix, eps) / denom);
    db = fmaxf(db, floor_db);
    buf[padded(j)] = (tile0 + j < len) ? db : 0.0f;
  }
  __syncthreads();
  float* orow = out + row * n;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + tid;
    const long long g = tile0 + j;
    if (g < n) orow[g] = buf[padded(j)];
  }
}

}  // namespace

extern "C" int aa_edc_tile_size() { return kTile; }

// x, out: (rows, n) float32 row-major; lengths: (rows,) int32;
// tile_sums: (rows, ceil(n / kTile)) float32 scratch.
extern "C" int aa_edc_db(const float* x, const int* lengths, float* tile_sums,
                         float* out, long long rows, long long n, float eps,
                         float floor_db, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const long long num_tiles = (n + kTile - 1) / kTile;
  const long long blocks = rows * num_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  edc_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
      x, lengths, tile_sums, out, n, (int)num_tiles, eps, floor_db);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  edc_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
      x, lengths, tile_sums, out, n, (int)num_tiles, eps, floor_db);
  return (int)cudaGetLastError();
}
