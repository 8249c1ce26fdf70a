// Linear STFT magnitude of real rows, frames read straight from the signal.
//
// Replaces the TPU kernel audio_analysis_tpu/ops/pallas_stft.py
// stft_magnitude_pallas (body _stft_kernel): |rfft(window * frame)| with the
// "valid" framing T = 1 + (N - n_fft) // hop, bins [0, k_out). The epilogue
// of audio_analysis_tpu/ops/stft.py stft_magnitude is fused: the magnitude
// is floored at `floor_lin`, and frames that do not lie wholly inside the
// row's valid `length` are written as 0. Neither a frame matrix nor a
// complex spectrum is stored in device memory.
//
// What bounds it: FFT arithmetic and shared-memory bandwidth. Each frame
// is an n_fft/2-point complex FFT in shared memory, log2(n_fft/2) passes
// over it; the signal is read about n_fft/hop times (8x at 4096/512, 16x at
// 8192/512, mostly from L2), and the magnitude plane is written once.
//
// Design (simple first). One block per (row, frame):
//   1. load the frame, multiply by the window and pack pairs of real
//      samples as n_fft/2 complex values z[m] = x[2m] + i x[2m+1], stored
//      in bit-reversed order;
//   2. iterative radix-2 decimation-in-time FFT in place;
//   3. split Z into the rfft bins, X[k] = E[k] + W^k O[k] with
//      E = (Z[k] + conj Z[M-k]) / 2 and O = (Z[k] - conj Z[M-k]) / 2i, and
//      write |X[k]|.
// Shared memory is n_fft/2 complex floats: 16 KB at n_fft 4096, 32 KB at
// 8192, 64 KB at 16384 (the dynamic opt-in above 48 KB). Twiddles come
// from a host table computed in float64 and rounded to fp32; the TPU
// kernel's two-stage matmul DFT was shaped for its matrix unit and is not
// carried over. Power-of-two n_fft from 256 to 16384.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinFft = 256;
constexpr int kMaxFft = 16384;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__global__ void __launch_bounds__(kThreads) stft_mag_kernel(
    const float* __restrict__ x, const int* __restrict__ lengths,
    const float* __restrict__ window, const float2* __restrict__ twiddle,
    float* __restrict__ out, long long n, int n_fft, int log2_half, int hop,
    int frames, int k_out, float floor_lin) {
  extern __shared__ float2 z[];
  const int tid = threadIdx.x;
  const int half = n_fft >> 1;
  const long long row = blockIdx.x / frames;
  const int frame = blockIdx.x % frames;
  const float* src = x + row * n + (long long)frame * hop;

  // 1. window, pack two real samples per complex value, bit-reverse
  for (int m = tid; m < half; m += kThreads) {
    const float re = src[2 * m] * window[2 * m];
    const float im = src[2 * m + 1] * window[2 * m + 1];
    z[__brev(m) >> (32 - log2_half)] = make_float2(re, im);
  }
  __syncthreads();

  // 2. radix-2 DIT: butterflies of span `span`, twiddle W_{2 span}^pos =
  //    twiddle[pos * half / span] (the table holds W_{n_fft}^k)
  for (int span = 1; span < half; span <<= 1) {
    const int stride = half / span;
    for (int b = tid; b < (half >> 1); b += kThreads) {
      const int pos = b & (span - 1);
      const int i0 = ((b - pos) << 1) + pos;
      const int i1 = i0 + span;
      const float2 t = cmul(twiddle[pos * stride], z[i1]);
      const float2 a = z[i0];
      z[i0] = make_float2(a.x + t.x, a.y + t.y);
      z[i1] = make_float2(a.x - t.x, a.y - t.y);
    }
    __syncthreads();
  }

  // 3. rfft bins from the packed spectrum, floor, frame validity
  const bool valid = (long long)frame * hop + n_fft <= (long long)lengths[row];
  float* dst = out + (row * frames + frame) * (long long)k_out;
  for (int k = tid; k < k_out; k += kThreads) {
    const float2 zk = z[k & (half - 1)];
    const float2 zc = z[(half - k) & (half - 1)];
    const float er = 0.5f * (zk.x + zc.x);
    const float ei = 0.5f * (zk.y - zc.y);
    const float2 o = make_float2(0.5f * (zk.y + zc.y), -0.5f * (zk.x - zc.x));
    const float2 wo = cmul(twiddle[k], o);
    const float xr = er + wo.x;
    const float xi = ei + wo.y;
    const float mag = sqrtf(xr * xr + xi * xi);
    dst[k] = valid ? fmaxf(mag, floor_lin) : 0.0f;
  }
}

}  // namespace

// x: (rows, n) float32; lengths: (rows,) int32; window: (n_fft,) float32;
// twiddle: (n_fft/2 + 1,) complex64 exp(-2 pi i k / n_fft);
// out: (rows, frames, k_out) float32 with k_out <= n_fft/2 + 1.
extern "C" int aa_stft_mag(const float* x, const int* lengths,
                           const float* window, const void* twiddle,
                           float* out, long long rows, long long n, int n_fft,
                           int hop, int frames, int k_out, float floor_lin,
                           void* stream) {
  if (n_fft < kMinFft || n_fft > kMaxFft || (n_fft & (n_fft - 1)) != 0 ||
      hop <= 0 || k_out <= 0 || k_out > n_fft / 2 + 1 ||
      (long long)(frames - 1) * hop + n_fft > n)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0 || frames <= 0) return 0;
  const long long blocks = rows * frames;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int log2_half = 0;
  while ((1 << log2_half) < n_fft / 2) ++log2_half;
  const size_t smem = sizeof(float2) * (size_t)(n_fft / 2);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        stft_mag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  stft_mag_kernel<<<(unsigned)blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      x, lengths, window, static_cast<const float2*>(twiddle), out, n, n_fft,
      log2_half, hop, frames, k_out, floor_lin);
  return (int)cudaGetLastError();
}
