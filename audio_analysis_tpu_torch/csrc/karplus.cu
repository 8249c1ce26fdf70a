// Karplus-Strong plucked strings: B strings of one delay length L, float32.
//
// Replaces the compiled device loop of audio_analysis_tpu/signals/jaxgen.py:46
// (_ks_scan, one jax.jit lax.scan over every output sample). With out[0:L]
// the initial delay line and out[-1] its last sample, each later sample is
//
//   out[n + L] = g * ((1 - b) * out[n] + b * (0.5 * (out[n - 1] + out[n])))
//
// for `total` samples, which may be fewer than L or no multiple of it.
//
// What bounds it: the dependent chain, not the bytes. The bytes are the
// output written once (0.115 us for 2 s of one string at 3.35 TB/s). But
// each period of L outputs needs the period before it, and one step is 5
// dependent fp32 operations (the sum, the halving, the product by b, the
// sum with (1 - b) out[n], the decay): about 20 cycles, 10-11 ns at the
// H100's 1.76-1.98 GHz, so 2 s at 4 kHz (L = 12, 7,999 periods) cannot take
// less than about 0.085 ms. The design keeps every period in registers and
// puts as little as possible beside the chain. One launch; per string:
//   L <= 3:     one thread, the whole period in registers: the L steps of a
//               period are independent, so nothing but the chain is serial
//               (no shuffle, no barrier);
//   L <= 32:    one warp, lane j holds out[kL + j] and its value of the
//               period before. Temporal blocking: a round fetches the M = 3
//               samples before the lane's own, out[kL + j - 3 .. kL + j - 1],
//               by 3 shuffles issued together, and advances 3 periods
//               through the triangle of steps that those 4 samples
//               determine, so one shuffle latency pays for 3 periods. The
//               extra steps at the triangle's edge are the neighbours' own
//               steps on the same inputs, so they give the same bits. The
//               first period runs alone: its left neighbour out[-1] is the
//               line's last sample, not a step. (Rounds of 4 and 6 periods
//               ran slower on the H100: ptxas spread their shuffles
//               through the triangle.)
//   L <= 8192:  W warps of V registers a lane: warp w holds columns
//               [32 V w, 32 V (w + 1)), lane j slot k the column
//               32 V w + 32 k + j, so a store of one slot is 32 neighbouring
//               samples. A column's left neighbour is the lane before it
//               (a shuffle), lane 31's slot before (a shuffle), or, for a
//               warp's first column, the warp before's last one: the only
//               value that crosses warps, through shared memory with one
//               named barrier a period. Column 0's neighbour is column
//               L - 1 two periods back, carried in a register. One warp (no
//               barrier) of V = 2 or 4 up to L = 128; above, up to 32 warps
//               of V = 2, 4 or 8 (on the H100 a wider warp lost more to its
//               instructions than a barrier a period costs). The period loop
//               is unrolled by 2; ptxas keeps every variant in registers.
//   L > 8192:   (below 6 Hz at 48 kHz) the output itself is the ring: a
//               period's threads read the period before from global memory,
//               a barrier a period, any L.
//
// Every float operation is rounded in the order of the per-sample scan and
// of the plain torch version (signals/torchgen.py karplus_strong_batch_plain):
// the sum, the halving, the two products, their sum, the decay. __fadd_rn
// and __fmul_rn keep nvcc from contracting a product and a sum into one
// fused multiply-add, which would round once where the scan rounds twice;
// 1 - b is formed in float32 as the scan forms it. So the samples are
// bit-equal to the plain version's and the JAX package's.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kThreadMaxDelay = 3;
constexpr int kRound = 3;  // periods a round on the warp path
constexpr int kMaxThreads = 1024;
constexpr long long kOneWarpMaxDelay = 128;  // the register path's one warp: V = 2 or 4
constexpr int kRingThreads = 256;
constexpr long long kLanesMaxDelay = 8192;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float ks_step(float cur, float prev, float g, float b, float one_minus_b) {
  const float average = __fmul_rn(0.5f, __fadd_rn(prev, cur));
  return __fmul_rn(g, __fadd_rn(__fmul_rn(one_minus_b, cur), __fmul_rn(b, average)));
}

// bar.sync on barrier 1 over the whole block
__device__ __forceinline__ void period_barrier() {
#ifdef __CUDA_ARCH__
  asm volatile("bar.sync 1, %0;" ::"r"(blockDim.x) : "memory");
#else
  __syncthreads();
#endif
}

// L <= 3: one thread a string, the whole period in registers; the L steps
// of a period are independent, so the chain is one step a period.
template <int L>
__global__ void __launch_bounds__(kWarp)
    karplus_thread_kernel(const float* __restrict__ init, float* __restrict__ out, long long strings,
                          long long total, float g, float b) {
  const long long string = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (string >= strings) return;
  const float* line = init + string * L;
  float* y = out + string * total;
  const float one_minus_b = __fsub_rn(1.0f, b);
  float cur[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    cur[j] = line[j];
    if (j < total) y[j] = cur[j];
  }
  float before = cur[L - 1];  // the period before's last sample: out[-1] at first
  for (long long base = L; base < total; base += L) {
    float next[L];
    next[0] = ks_step(cur[0], before, g, b, one_minus_b);
#pragma unroll
    for (int j = 1; j < L; ++j) next[j] = ks_step(cur[j], cur[j - 1], g, b, one_minus_b);
    before = cur[L - 1];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      cur[j] = next[j];
      if (base + j < total) y[base + j] = cur[j];
    }
  }
}

// 3 < L <= 32: one warp a string, M = 3 periods a round (M <= L); lanes
// >= L compute values nobody reads.
template <int M>
__global__ void __launch_bounds__(kWarp)
    karplus_warp_kernel(const float* __restrict__ init, float* __restrict__ out, int delay, long long total,
                        float g, float b) {
  const int lane = threadIdx.x;
  const bool own = lane < delay;
  const float* line = init + (long long)blockIdx.x * delay;
  float* y = out + (long long)blockIdx.x * total;
  const float one_minus_b = __fsub_rn(1.0f, b);
  float cur = own ? line[lane] : 0.0f;  // out[kL + lane] of period k
  float prev = line[delay - 1];         // period k - 1's; out[-1] where lane L-1's is read at first
  if (own && lane < total) y[lane] = cur;
  long long base = delay;  // the first sample of the next period
  // the first period alone: its left neighbour out[-1] is the line's last
  // sample, not a step
  if (base < total) {
    const float left = __shfl_sync(kFullMask, lane + 1 < delay ? cur : prev, lane == 0 ? delay - 1 : lane - 1);
    prev = cur;
    cur = ks_step(cur, left, g, b, one_minus_b);
    if (own && base + lane < total) y[base + lane] = cur;
    base += delay;
  }
  // halo i (1..M): out[kL + lane - i], lane (lane - i) mod L's value of
  // period k, or of period k - 1 where lane - i < 0; the source lane
  // picks which
  int src[M];
  bool give_cur[M];
#pragma unroll
  for (int i = 1; i <= M; ++i) {
    src[i - 1] = own ? (lane - i + delay) % delay : lane;
    give_cur[i - 1] = lane + i < delay;
  }
#pragma unroll 2
  for (; base < total; base += (long long)M * delay) {
    float w[M + 1];  // w[M - i] = out[kL + lane - i]
    w[M] = cur;
#pragma unroll
    for (int i = 1; i <= M; ++i) w[M - i] = __shfl_sync(kFullMask, give_cur[i - 1] ? cur : prev, src[i - 1]);
#pragma unroll
    for (int t = 1; t <= M; ++t) {
      // level t: w[k] = out[(k + t) L + lane - (M - k)] for k >= t
#pragma unroll
      for (int k = M; k >= t; --k) w[k] = ks_step(w[k], w[k - 1], g, b, one_minus_b);
      const long long n = base + (long long)(t - 1) * delay + lane;
      if (own && n < total) y[n] = w[M];
      if (t == M - 1) prev = w[M];
    }
    cur = w[M];
  }
}

// v[slot], by a balanced tree of selects on the slot's bits (depth log2 V:
// the pick sits on the path from one period to the next)
template <int V>
__device__ __forceinline__ float pick(const float (&v)[V], int slot) {
  float r[V];
#pragma unroll
  for (int k = 0; k < V; ++k) r[k] = v[k];
#pragma unroll
  for (int step = 1; step < V; step *= 2)
#pragma unroll
    for (int k = 0; k + step < V; k += 2 * step) r[k] = (slot & step) ? r[k + step] : r[k];
  return r[0];
}

// 32 < L <= 8192: W warps of V registers a lane (blockDim = 32 W; kMulti
// where W > 1).
template <int V, bool kMulti>
__global__ void __launch_bounds__(kMulti ? kMaxThreads : kWarp)
    karplus_lanes_kernel(const float* __restrict__ init, float* __restrict__ out, int delay, long long total,
                         float g, float b) {
  __shared__ float edge[2][kMaxThreads / kWarp];  // each warp's last column, by period parity
  __shared__ float tail[2];                        // column L - 1, by period parity
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int first = warp * kWarp * V + lane;  // the column of slot 0
  const int last = delay - 1;
  const int last_warp = last / (kWarp * V), last_lane = last % kWarp, last_slot = last % (kWarp * V) / kWarp;
  const bool holds_last = warp == last_warp && lane == last_lane;
  const int up = (lane + kWarp - 1) % kWarp;
  const float* line = init + (long long)blockIdx.x * delay;
  float* y = out + (long long)blockIdx.x * total + first;  // slot 0's column
  long long room = total - first;                           // its samples left, from the current period's
  const float one_minus_b = __fsub_rn(1.0f, b);
  float cur[V];
  bool live[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    live[k] = first + kWarp * k < delay;
    cur[k] = live[k] ? line[first + kWarp * k] : 0.0f;
    if (live[k] && kWarp * k < room) y[kWarp * k] = cur[k];
  }
  float wrap = line[last];  // column L - 1 two periods back: out[-1] at first
  int parity = 0;
#pragma unroll 2
  for (long long base = delay; base < total; base += delay) {
    room -= delay;
    if (kMulti) {
      if (lane == kWarp - 1) edge[parity][warp] = cur[V - 1];
      if (holds_last) tail[parity] = pick(cur, last_slot);
    }
    float left[V];
#pragma unroll
    for (int k = 0; k < V; ++k) left[k] = __shfl_sync(kFullMask, lane == kWarp - 1 && k > 0 ? cur[k - 1] : cur[k], up);
    float wrap_next;
    if (kMulti) {
      period_barrier();
      if (lane == 0) left[0] = warp > 0 ? edge[parity][warp - 1] : wrap;
      wrap_next = tail[parity];
      parity ^= 1;
    } else {
      wrap_next = __shfl_sync(kFullMask, pick(cur, last_slot), last_lane);
      if (lane == 0) left[0] = wrap;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      cur[k] = ks_step(cur[k], left[k], g, b, one_minus_b);
      if (live[k] && kWarp * k < room) y[base + kWarp * k] = cur[k];
    }
    wrap = wrap_next;
  }
}

// L > 8192: the block's threads stride over the period; out is the ring.
__global__ void __launch_bounds__(kRingThreads)
    karplus_ring_kernel(const float* __restrict__ init, float* out, long long delay, long long total, float g,
                        float b) {
  const float* line = init + (long long)blockIdx.x * delay;
  float* y = out + (long long)blockIdx.x * total;
  const float one_minus_b = __fsub_rn(1.0f, b);
  const float before = line[delay - 1];  // out[-1]
  const long long head = delay < total ? delay : total;
  for (long long j = threadIdx.x; j < head; j += blockDim.x) y[j] = line[j];
  __syncthreads();
  for (long long base = delay; base < total; base += delay) {
    const long long end = total - base < delay ? total - base : delay;
    for (long long j = threadIdx.x; j < end; j += blockDim.x) {
      const long long n = base - delay + j;
      y[base + j] = ks_step(y[n], n == 0 ? before : y[n - 1], g, b, one_minus_b);
    }
    __syncthreads();
  }
}

using KernelFn = void (*)(const float*, float*, int, long long, float, float);
using ThreadKernelFn = void (*)(const float*, float*, long long, long long, float, float);

ThreadKernelFn thread_kernel_for(long long delay) {
  switch (delay) {
    case 1: return karplus_thread_kernel<1>;
    case 2: return karplus_thread_kernel<2>;
    default: return karplus_thread_kernel<3>;
  }
}

}  // namespace

// init: (strings, delay) float32 row-major; out: (strings, total) float32
// row-major. One launch; nothing is allocated. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a delay below 1, negative sizes, null
// pointers or more strings than a grid holds.
extern "C" int aa_karplus(const float* init, float* out, long long strings, long long delay, long long total,
                          float g, float b, void* stream) {
  if (strings < 0 || delay < 1 || total < 0) return (int)cudaErrorInvalidValue;
  if (strings == 0 || total == 0) return 0;
  if (init == nullptr || out == nullptr || strings > 0x7fffffffLL || total > INT64_MAX / strings ||
      delay > INT64_MAX / strings)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (delay <= kThreadMaxDelay) {
    ThreadKernelFn thread_kernel = thread_kernel_for(delay);
    thread_kernel<<<(unsigned)((strings + kWarp - 1) / kWarp), kWarp, 0, s>>>(init, out, strings, total, g, b);
  } else if (delay <= kWarp) {
    KernelFn warp_kernel = karplus_warp_kernel<kRound>;
    warp_kernel<<<(unsigned)strings, kWarp, 0, s>>>(init, out, (int)delay, total, g, b);
  } else if (delay <= kLanesMaxDelay) {
    // one warp of V = 2 or 4 up to L = 128; above, W <= 32 warps of the
    // least V in 2, 4, 8 with 32 V W >= L
    const int v = delay <= kOneWarpMaxDelay ? (delay <= 2 * kWarp ? 2 : 4)
                  : delay <= 2 * kMaxThreads ? 2 : delay <= 4 * kMaxThreads ? 4 : 8;
    const long long warps = (delay + (long long)kWarp * v - 1) / ((long long)kWarp * v);
    KernelFn lanes_kernel = warps == 1 ? (v == 2 ? karplus_lanes_kernel<2, false> : karplus_lanes_kernel<4, false>)
                            : v == 2   ? karplus_lanes_kernel<2, true>
                            : v == 4   ? karplus_lanes_kernel<4, true>
                                       : karplus_lanes_kernel<8, true>;
    lanes_kernel<<<(unsigned)strings, (int)(warps * kWarp), 0, s>>>(init, out, (int)delay, total, g, b);
  } else {
    karplus_ring_kernel<<<(unsigned)strings, kRingThreads, 0, s>>>(init, out, delay, total, g, b);
  }
  return (int)cudaGetLastError();
}
