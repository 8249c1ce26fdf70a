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
// What bounds it: latency. Each period of L outputs depends only on the
// period before it (and lane 0 on the last sample of the period before
// that), so the periods run in sequence and the L samples of a period in
// parallel. One block per string:
//   L <= 32: one warp, the period in registers (lane j holds out[kL + j]),
//            the neighbour out[n - 1] by __shfl_up_sync, and lane 0's
//            neighbour, lane L-1's value of two periods back, by
//            __shfl_sync from a second register; no barrier and no load
//            after the line is read;
//   L > 32:  the output itself is the ring: a period's lanes read the
//            period before from global memory (the block wrote it; the
//            barrier that ends each period makes it visible), any L.
// The bytes are the output written once; at 4 kHz (L = 12) a period is a
// few dependent float operations and two shuffles, about 8,000 periods for
// two seconds of audio.
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
constexpr int kBlockThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float ks_step(float cur, float prev, float g, float b, float one_minus_b) {
  const float average = __fmul_rn(0.5f, __fadd_rn(prev, cur));
  return __fmul_rn(g, __fadd_rn(__fmul_rn(one_minus_b, cur), __fmul_rn(b, average)));
}

// L <= 32: one warp a string; lanes >= L compute values nobody reads.
__global__ void __launch_bounds__(kWarp)
    karplus_warp_kernel(const float* __restrict__ init, float* __restrict__ out, int delay,
                        long long total, float g, float b) {
  const int lane = threadIdx.x;
  const float* line = init + (long long)blockIdx.x * delay;
  float* y = out + (long long)blockIdx.x * total;
  const float one_minus_b = __fsub_rn(1.0f, b);
  float cur = lane < delay ? line[lane] : 0.0f;  // out[kL + lane] of period k
  float back = line[delay - 1];                  // period k - 1's; out[-1] at first
  if (lane < delay && lane < total) y[lane] = cur;
  for (long long base = delay; base < total; base += delay) {
    const float up = __shfl_up_sync(kFullMask, cur, 1);
    const float wrap = __shfl_sync(kFullMask, back, delay - 1);
    const float next = ks_step(cur, lane == 0 ? wrap : up, g, b, one_minus_b);
    back = cur;
    cur = next;
    if (lane < delay && base + lane < total) y[base + lane] = cur;
  }
}

// L > 32: the block's threads stride over the period; out is the ring.
__global__ void __launch_bounds__(kBlockThreads)
    karplus_block_kernel(const float* __restrict__ init, float* out, long long delay,
                         long long total, float g, float b) {
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

}  // namespace

// init: (strings, delay) float32 row-major; out: (strings, total) float32
// row-major. One launch; nothing is allocated. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a delay below 1, negative sizes, null
// pointers or more strings than a grid holds.
extern "C" int aa_karplus(const float* init, float* out, long long strings, long long delay,
                          long long total, float g, float b, void* stream) {
  if (strings < 0 || delay < 1 || total < 0) return (int)cudaErrorInvalidValue;
  if (strings == 0 || total == 0) return 0;
  if (init == nullptr || out == nullptr || strings > 0x7fffffffLL ||
      total > INT64_MAX / strings || delay > INT64_MAX / strings)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (delay <= kWarp) {
    karplus_warp_kernel<<<(unsigned)strings, kWarp, 0, s>>>(init, out, (int)delay, total, g, b);
  } else {
    const long long warps = (delay + kWarp - 1) / kWarp;
    const int threads = warps * kWarp < kBlockThreads ? (int)(warps * kWarp) : kBlockThreads;
    karplus_block_kernel<<<(unsigned)strings, threads, 0, s>>>(init, out, delay, total, g, b);
  }
  return (int)cudaGetLastError();
}
