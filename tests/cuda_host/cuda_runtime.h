// Host stand-in for the CUDA subset that the kernel sources of csrc/ use
// (stft.cu, edc.cu, karplus.cu, pool.cu, dbfit.cu), so they compile with g++
// and run on the CPU (tests/test_torch_stft_host.py,
// tests/test_torch_edc_host.py, tests/test_torch_karplus_host.py,
// tests/test_torch_pool_host.py, tests/test_torch_dbfit_host.py): every CUDA
// thread of a block is a std::thread, __syncthreads (and a named barrier,
// which the sources reach through __syncthreads when __CUDA_ARCH__ is not
// defined) is a std::barrier over the block, a warp shuffle or vote is an
// exchange through a per-warp slot array between two per-warp barriers,
// atomics are the compiler's sequentially consistent builtins and
// __threadfence a full fence, blocks run one after another (in reverse
// order when host_reverse_blocks is set), `extern __shared__` memory is one
// buffer per launch and a `__shared__` variable is a function-level static.
// A spin-wait that is never satisfied (__nanosleep called for more than
// kHostWaitLimit in one thread) prints a message and aborts, so a wait for
// a value that is never published fails within a bounded time.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

struct float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline float sqrtf(float a) { return std::sqrt(a); }
inline float fmaxf(float a, float b) { return std::fmax(a, b); }
inline float __log2f(float a) { return std::log2(a); }
// the _rn intrinsics: one IEEE operation each (x86-64 float arithmetic is
// SSE, and g++ in an ISO mode contracts nothing into a fused multiply-add);
// rintf and fminf are the C library's (rintf rounds half to even in the
// default rounding mode, as the device's does)
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline unsigned __float_as_uint(float a) {
  unsigned u;
  std::memcpy(&u, &a, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float a;
  std::memcpy(&a, &u, 4);
  return a;
}

struct host_dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local host_dim3 threadIdx, blockIdx;
inline host_dim3 blockDim, gridDim;
inline std::barrier<>* host_block_barrier = nullptr;
inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }

// loads and stores: plain accesses (cache hints have no meaning here)
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
template <class T>
inline T __ldcg(const T* p) {
  return *p;
}
template <class T>
inline T __ldcs(const T* p) {
  return *p;
}
template <class T>
inline void __stcs(T* p, T v) {
  *p = v;
}

// global and shared atomics alike (shared memory is host memory here)
inline unsigned atomicAdd(unsigned* p, unsigned v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline unsigned atomicMax(unsigned* p, unsigned v) {
  unsigned old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (old < v && !__atomic_compare_exchange_n(p, &old, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {
  }
  return old;
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }

constexpr auto kHostWaitLimit = std::chrono::seconds(2);
inline void __nanosleep(unsigned ns) {
  static thread_local auto first = std::chrono::steady_clock::now();
  if (std::chrono::steady_clock::now() - first > kHostWaitLimit) {
    std::fprintf(stderr, "cuda_host: a spin-wait was never satisfied (block %u, thread %u)\n",
                 blockIdx.x, threadIdx.x);
    std::abort();
  }
  std::this_thread::sleep_for(std::chrono::nanoseconds(ns));
}

// warps: a slot per lane and a barrier per warp of the running block
struct host_warp {
  std::unique_ptr<std::barrier<>> barrier;
  unsigned lanes = 32;
  uint64_t slot[32];
};
inline std::vector<host_warp> host_warps;

template <class T>
inline T host_shfl(T v, unsigned src_lane) {
  static_assert(sizeof(T) <= sizeof(uint64_t));
  const unsigned lane = threadIdx.x % 32;
  host_warp& w = host_warps[threadIdx.x / 32];
  std::memcpy(&w.slot[lane], &v, sizeof(T));
  w.barrier->arrive_and_wait();
  T r;
  std::memcpy(&r, &w.slot[src_lane], sizeof(T));
  w.barrier->arrive_and_wait();
  return r;
}
// votes: the lanes' predicates as a bit mask (lanes of a partial last
// warp that do not exist vote 0)
inline unsigned __ballot_sync(unsigned, int pred) {
  const unsigned lane = threadIdx.x % 32;
  host_warp& w = host_warps[threadIdx.x / 32];
  w.slot[lane] = pred != 0;
  w.barrier->arrive_and_wait();
  unsigned bits = 0;
  for (unsigned i = 0; i < w.lanes; ++i) bits |= w.slot[i] ? 1u << i : 0u;
  w.barrier->arrive_and_wait();
  return bits;
}
inline int __all_sync(unsigned mask, int pred) {
  const host_warp& w = host_warps[threadIdx.x / 32];
  const unsigned live = mask & (w.lanes == 32 ? 0xffffffffu : (1u << w.lanes) - 1u);
  return (__ballot_sync(mask, pred) & live) == live;
}
inline int __any_sync(unsigned mask, int pred) { return (__ballot_sync(mask, pred) & mask) != 0; }

template <class T>
inline T __shfl_down_sync(unsigned, T v, unsigned delta) {
  const unsigned lane = threadIdx.x % 32;
  return host_shfl(v, lane + delta < 32 ? lane + delta : lane);
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, unsigned mask) {
  return host_shfl(v, (threadIdx.x % 32) ^ mask);
}
template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned delta) {
  const unsigned lane = threadIdx.x % 32;
  return host_shfl(v, lane >= delta ? lane - delta : lane);
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src_lane) {
  return host_shfl(v, static_cast<unsigned>(src_lane) % 32);
}

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, int, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// a small stand-in card: 2 SMs that hold 2 blocks each
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* device) {
  *device = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = 2;
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F, int, size_t) {
  *blocks = 2;
  return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* p, int value, size_t bytes, cudaStream_t) {
  std::memset(p, value, bytes);
  return cudaSuccess;
}

// the kernel's `extern __shared__` buffer, filled with NaN-like bytes at
// every launch so that a read before a write shows
inline std::vector<unsigned char> host_shared_memory;
inline bool host_reverse_blocks = false;

template <class Kernel, class... Args>
void host_launch(Kernel kernel, unsigned blocks, int threads, size_t smem, Args... args) {
  host_shared_memory.assign(smem, 0xff);
  blockDim.x = static_cast<unsigned>(threads);
  blockDim.y = blockDim.z = 1;
  gridDim.x = blocks;
  gridDim.y = gridDim.z = 1;
  for (unsigned i = 0; i < blocks; ++i) {
    const unsigned b = host_reverse_blocks ? blocks - 1 - i : i;
    std::barrier<> barrier(threads);
    host_block_barrier = &barrier;
    host_warps.clear();
    host_warps.resize((threads + 31) / 32);
    for (int w = 0; w < (threads + 31) / 32; ++w) {
      host_warps[w].lanes = static_cast<unsigned>(std::min(32, threads - 32 * w));
      host_warps[w].barrier = std::make_unique<std::barrier<>>(host_warps[w].lanes);
    }
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([=] {
        threadIdx.x = t;
        blockIdx.x = b;
        kernel(args...);
      });
    for (auto& th : pool) th.join();
  }
}
