// Display pooling of the spectrogram figure: a (C, T, F) float32 dB plane
// max-pooled onto log-frequency rows and column buckets, quantised to the
// 1/128-dB int16 fixed point.
//
// Replaces the compiled device program of audio_analysis_tpu/ops/display.py:151
// (_pooled_image_dev, one jax.jit of a shifted-max pyramid along F and a
// one-hot selection matmul). Cell (c, j, r) of the (C, T' + 1, rows) image,
// j < T' = ceil(T / col_pool), is the maximum of the plane over the frames
// t in [j col_pool, (j + 1) col_pool) with t < num_frames[c], and over the
// bins [i0 + lo_r, i0 + lo_r + w_r) of row r (ops/display.py _log_row_spans);
// a cell with no such frame is -3e38 (the pyramid's identity of max). The
// extra column j = T' holds the two colour percentiles (computed beside the
// kernel: a per-row sort keeps their exactness contract) in its first two
// cells and 0 in the rest. Every cell is then quantised as quantize_db_i16
// does: clamp to +-255.99, times 128, round half to even, to int16; NaN,
// which max passes on as the pyramid does, becomes 0 as torch's cast makes
// it.
//
// What bounds it: bytes. A row's bin range is read directly, with no
// pyramid: the rows cover the selected bins about once (rows narrower than
// a bin repeat the nearest one, from cache), so the plane is read about
// once and the int16 image written once. One block per (channel, column);
// its threads take the rows, each reading its row's bins in the bucket's
// frames. Max is exact, so the image is bit-equal to the pyramid's.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPoolThreads = 256;
constexpr float kNeg = -3.0e38f;
constexpr float kDbClip = 255.99f;
constexpr float kDbScale = 128.0f;

// max that passes a NaN on, as torch.maximum and amax do
__device__ __forceinline__ float max_nan(float m, float v) { return (v > m || v != v) ? v : m; }

__device__ __forceinline__ short quantize_db(float v) {
  if (v != v) return 0;
  v = fminf(fmaxf(v, -kDbClip), kDbClip);
  return (short)rintf(__fmul_rn(v, kDbScale));
}

__global__ void __launch_bounds__(kPoolThreads)
    pool_kernel(const float* __restrict__ x, const long long* __restrict__ num_frames,
                const int* __restrict__ spans, const float* __restrict__ pcts,
                short* __restrict__ out, long long frames, long long bins, int i0, int rows,
                int col_pool, long long cols) {
  const long long c = blockIdx.x / (cols + 1), col = blockIdx.x % (cols + 1);
  short* o = out + (long long)blockIdx.x * rows;
  if (col == cols) {
    for (int r = threadIdx.x; r < rows; r += blockDim.x) o[r] = r < 2 ? quantize_db(pcts[2 * c + r]) : 0;
    return;
  }
  long long valid = num_frames[c];
  valid = valid < 0 ? 0 : (valid > frames ? frames : valid);
  const long long t0 = col * col_pool;
  const long long t1 = t0 + col_pool < valid ? t0 + col_pool : valid;
  const float* plane = x + c * frames * bins + i0;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int lo = spans[2 * r], width = spans[2 * r + 1];
    float m = kNeg;
    for (long long t = t0; t < t1; ++t) {
      const float* p = plane + t * bins + lo;
      for (int i = 0; i < width; ++i) m = max_nan(m, p[i]);
    }
    o[r] = quantize_db(m);
  }
}

}  // namespace

// x: (channels, frames, bins) float32 row-major; num_frames: (channels,)
// int64; spans: (rows, 2) int32 (lo, w), each range inside the selection
// that starts at bin i0; pcts: (channels, 2) float32; out: (channels,
// ceil(frames / col_pool) + 1, rows) int16. One launch; nothing is
// allocated. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// negative sizes, a col_pool below 1, null pointers or a grid too large.
extern "C" int aa_pool_image(const float* x, const long long* num_frames, const int* spans,
                             const float* pcts, short* out, long long channels, long long frames,
                             long long bins, int i0, int rows, int col_pool, void* stream) {
  if (channels < 0 || frames < 0 || bins < 0 || i0 < 0 || rows < 0 || col_pool < 1)
    return (int)cudaErrorInvalidValue;
  if (channels == 0 || rows == 0) return 0;
  if (x == nullptr || num_frames == nullptr || spans == nullptr || pcts == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long cols = (frames + col_pool - 1) / col_pool;
  if (cols + 1 > 0x7fffffffLL / channels) return (int)cudaErrorInvalidValue;
  const long long blocks = channels * (cols + 1);
  const int threads = rows < kPoolThreads ? (rows + 31) / 32 * 32 : kPoolThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pool_kernel<<<(unsigned)blocks, threads, 0, s>>>(x, num_frames, spans, pcts, out, frames, bins, i0,
                                                   rows, col_pool, cols);
  return (int)cudaGetLastError();
}
