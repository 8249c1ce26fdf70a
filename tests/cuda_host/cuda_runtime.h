// Host stand-in for the CUDA subset that csrc/stft.cu uses, so its kernel
// source compiles with g++ and runs on the CPU (tests/test_torch_stft_host.py):
// every CUDA thread of a block is a std::thread, __syncthreads is a
// std::barrier over the block, blocks run one after another, and shared
// memory is one buffer per launch.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>

struct float2 {
  float x, y;
};
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float sqrtf(float a) { return std::sqrt(a); }
inline float fmaxf(float a, float b) { return std::fmax(a, b); }

struct host_dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local host_dim3 threadIdx, blockIdx;
inline std::barrier<>* host_block_barrier = nullptr;
inline void __syncthreads() { host_block_barrier->arrive_and_wait(); }
template <class T>
inline T __ldg(const T* p) {
  return *p;
}

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidValue = 1;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, int, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// the kernel's `extern __shared__` buffer, filled with NaN-like bytes at
// every launch so that a read before a write shows
inline std::vector<unsigned char> host_shared_memory;

template <class Kernel, class... Args>
void host_launch(Kernel kernel, unsigned blocks, int threads, size_t smem, Args... args) {
  host_shared_memory.assign(smem, 0xff);
  for (unsigned b = 0; b < blocks; ++b) {
    std::barrier<> barrier(threads);
    host_block_barrier = &barrier;
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
