// Linear STFT magnitude of real rows, frames read straight from the signal.
//
// Replaces the TPU kernel audio_analysis_tpu/ops/pallas_stft.py:170
// stft_magnitude_pallas (pallas_call at :219, body _stft_kernel):
// |rfft(window * frame)| with the "valid" framing T = 1 + (N - n_fft) // hop,
// bins [0, k_out). The epilogue of audio_analysis_tpu/ops/stft.py
// stft_magnitude is fused: the magnitude is floored at `floor_lin`, and
// frames that do not lie wholly inside the row's valid `length` are written
// as 0. Neither a frame matrix nor a complex spectrum reaches device memory.
//
// What bounds it on an H100: the HBM writes of the magnitude plane. At the
// main path's shapes (16 rows x 2^20) that is 268 MB at (4096, 512) and
// 444 MB at (8192, 512, k_out 3414) against 67 MB of input, 0.100 and
// 0.153 ms at 3.35 TB/s; the FFT arithmetic (2.5 n_fft log2 n_fft per frame,
// 4.0 and 8.7 GFLOP) would take 0.060 and 0.129 ms at 67 TFLOP/s fp32.
// Short of those, the cost is in the FFT's traffic through shared memory
// and the twiddle loads, which this design keeps small.
//
// Design. Two real samples are packed per complex value,
// z[m] = w[2m] x[2m] + i w[2m+1] x[2m+1], and the M = n_fft/2-point complex
// FFT of z is a self-sorting Stockham FFT with a register radix:
//   - each thread holds 16 complex values; a frame takes M/16 threads, and a
//     block of at least 128 threads holds 128/(M/16) frames when M is small;
//   - a pass of radix R (16, or one last pass of 2, 4 or 8 doing 16/R
//     butterflies per thread) multiplies its inputs by W_{pR}^{rk}, runs the
//     R-point DFT in registers (radix 16 as two radix-4 stages with constant
//     twiddles), and stores y[(b - k) R + k + s p] to shared memory, where p
//     is the product of the earlier radices and k = b mod p;
//   - every pass reads s[t + (M/16) c], c = 0..15, so the first pass reads
//     natural order straight from global memory (8-byte loads of x[2m],
//     x[2m+1] where the frame start allows, scalar loads otherwise: any hop
//     works), and no bit reversal is needed;
//   - the shared buffer has one pad float2 per 16, so every pass's stores
//     and loads are free of bank conflicts;
//   - M = 2048 (n_fft 4096) is 16 x 16 x 8 and M = 4096 (n_fft 8192) is
//     16 x 16 x 16: three passes and two exchanges, where a radix-2 FFT
//     takes 11-12 passes with a barrier each.
// Twiddles come from the host table W_{n_fft}^j, j in [0, n_fft/2], computed
// in float64 and rounded to fp32 (W_M^j = W_{n_fft}^{2j}; the other half
// of the circle is its conjugate mirror), read through the read-only cache.
// A radix-16 pass loads W^k, W^2k, W^4k, W^8k and forms the other powers
// with at most three complex products. All arithmetic is fp32; no tensor
// cores and no fast-math sines.
//   The epilogue splits Z into the rfft bins, X[k] = E[k] + W^k O[k] with
// E = (Z[k] + conj Z[M-k]) / 2 and O = (Z[k] - conj Z[M-k]) / 2i, and
// writes |X[k]| coalesced across the frame's threads.
// Power-of-two n_fft from 256 to 16384 (M = 128 .. 8192), one template
// instance per size. Shared memory is (M + M/16) float2 per frame: 17 KB at
// n_fft 4096, 34 KB at 8192, 68 KB at 16384 (the dynamic opt-in above
// 48 KB).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMinLog2Half = 7;   // n_fft 256
constexpr int kMaxLog2Half = 13;  // n_fft 16384

template <int LOG2M>
struct Plan {
  static constexpr int M = 1 << LOG2M;       // complex points per frame
  static constexpr int T = M / 16;           // threads per frame
  static constexpr int THREADS = T < 128 ? 128 : T;
  static constexpr int FRAMES = THREADS / T;  // frames per block
  static constexpr int PADDED = M + M / 16;   // shared float2 per frame
  static constexpr int N16 = LOG2M / 4;       // radix-16 passes
  static constexpr int LAST = 1 << (LOG2M % 4);  // last pass radix, 1: none
  static constexpr int PASSES = N16 + (LAST > 1 ? 1 : 0);
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 mul_neg_i(float2 a) {  // -i a
  return make_float2(a.y, -a.x);
}

// one pad float2 after every 16
__device__ __forceinline__ int pad(int a) { return a + (a >> 4); }

// W_16^e for the exponents of the radix-16 inner twiddles
__device__ __forceinline__ float2 w16(int e) {
  constexpr float C = 0.923879532511286756f;  // cos(pi/8)
  constexpr float S = 0.382683432365089772f;  // sin(pi/8)
  constexpr float H = 0.707106781186547524f;  // sqrt(1/2)
  switch (e) {
    case 1: return make_float2(C, -S);
    case 2: return make_float2(H, -H);
    case 3: return make_float2(S, -C);
    case 6: return make_float2(-H, -H);
    default: return make_float2(-C, S);  // 9
  }
}

// forward DFTs in registers, natural order in and out
__device__ __forceinline__ void dft2(float2& a, float2& b) {
  const float2 t = a;
  a = cadd(t, b);
  b = csub(t, b);
}

__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2);
  const float2 t2 = cadd(a1, a3), t3 = mul_neg_i(csub(a1, a3));
  a0 = cadd(t0, t2);
  a2 = csub(t0, t2);
  a1 = cadd(t1, t3);
  a3 = csub(t1, t3);
}

// r = r0 + 2 r1, s = s0 + 4 s1
__device__ __forceinline__ void dft8(float2 (&u)[8]) {
  constexpr float H = 0.707106781186547524f;
  dft4(u[0], u[2], u[4], u[6]);
  dft4(u[1], u[3], u[5], u[7]);
  u[3] = cmul(u[3], make_float2(H, -H));
  u[5] = mul_neg_i(u[5]);
  u[7] = cmul(u[7], make_float2(-H, -H));
  float2 o[8];
#pragma unroll
  for (int s0 = 0; s0 < 4; ++s0) {
    o[s0] = cadd(u[2 * s0], u[2 * s0 + 1]);
    o[s0 + 4] = csub(u[2 * s0], u[2 * s0 + 1]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) u[i] = o[i];
}

// r = r0 + 4 r1, s = s0 + 4 s1: DFT-4 over r1, twiddle W_16^{r0 s0},
// DFT-4 over r0
__device__ __forceinline__ void dft16(float2 (&u)[16]) {
#pragma unroll
  for (int r0 = 0; r0 < 4; ++r0) dft4(u[r0], u[r0 + 4], u[r0 + 8], u[r0 + 12]);
#pragma unroll
  for (int r0 = 1; r0 < 4; ++r0) {
#pragma unroll
    for (int s0 = 1; s0 < 4; ++s0) {
      const int e = r0 * s0;
      u[r0 + 4 * s0] = e == 4 ? mul_neg_i(u[r0 + 4 * s0]) : cmul(u[r0 + 4 * s0], w16(e));
    }
  }
#pragma unroll
  for (int s0 = 0; s0 < 4; ++s0) dft4(u[4 * s0], u[4 * s0 + 1], u[4 * s0 + 2], u[4 * s0 + 3]);
  float2 o[16];
#pragma unroll
  for (int s0 = 0; s0 < 4; ++s0) {
#pragma unroll
    for (int s1 = 0; s1 < 4; ++s1) o[s0 + 4 * s1] = u[4 * s0 + s1];
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) u[i] = o[i];
}

template <int R>
__device__ __forceinline__ void dft(float2 (&u)[R]) {
  if constexpr (R == 2) {
    dft2(u[0], u[1]);
  } else if constexpr (R == 4) {
    dft4(u[0], u[1], u[2], u[3]);
  } else if constexpr (R == 8) {
    dft8(u);
  } else {
    dft16(u);
  }
}

// W_{n_fft}^j for j in [0, n_fft) from the table of j in [0, n_fft/2]
template <int LOG2N>
__device__ __forceinline__ float2 tw(const float2* __restrict__ table, int j) {
  constexpr int N = 1 << LOG2N;
  const bool upper = j > N / 2;
  const float2 w = __ldg(table + (upper ? N - j : j));
  return make_float2(w.x, upper ? -w.y : w.y);
}

// u[r] *= W_{n_fft}^{r j}, r = 1..R-1
template <int LOG2N, int R>
__device__ __forceinline__ void apply_twiddles(float2 (&u)[R], const float2* __restrict__ table,
                                               int j) {
  if constexpr (R <= 4) {
#pragma unroll
    for (int r = 1; r < R; ++r) u[r] = cmul(u[r], tw<LOG2N>(table, r * j));
  } else {
    const float2 w1 = tw<LOG2N>(table, j), w2 = tw<LOG2N>(table, 2 * j);
    const float2 w4 = tw<LOG2N>(table, 4 * j);
    const float2 w3 = cmul(w1, w2);
    float2 w[8] = {make_float2(1.f, 0.f), w1, w2, w3, w4, cmul(w1, w4), cmul(w2, w4), cmul(w3, w4)};
#pragma unroll
    for (int r = 1; r < 8; ++r) u[r] = cmul(u[r], w[r]);
    if constexpr (R == 16) {
      const float2 w8 = tw<LOG2N>(table, 8 * j);
      u[8] = cmul(u[8], w8);
#pragma unroll
      for (int r = 9; r < 16; ++r) u[r] = cmul(u[r], cmul(w[r - 8], w8));
    }
  }
}

// One Stockham pass of radix R. The thread's 16 values are
// v[q + r NB] = x[b_q + r M/R] for its NB = 16/R butterflies b_q = t + q M/16;
// p = 2^LOG2P is the product of the earlier radices. Stores
// y[(b - k) R + k + s p], k = b mod p, to the padded shared buffer.
template <int LOG2M, int R, int LOG2P>
__device__ __forceinline__ void stockham_pass(float2 (&v)[16], float2* s, int t,
                                              const float2* __restrict__ table) {
  constexpr int T = Plan<LOG2M>::T, NB = 16 / R, P = 1 << LOG2P;
  constexpr int LOG2R = R == 16 ? 4 : R == 8 ? 3 : R == 4 ? 2 : 1;
  // table index of W_{pR}^1 is 2^SHIFT (the table holds W_{2M}^j)
  constexpr int SHIFT = LOG2M + 1 - LOG2P - LOG2R;
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    const int b = t + q * T;
    const int k = b & (P - 1);
    float2 u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = v[q + r * NB];
    if constexpr (LOG2P > 0) apply_twiddles<LOG2M + 1, R>(u, table, k << SHIFT);
    dft<R>(u);
    const int base = (b - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) s[pad(base + r * P)] = u[r];
  }
}

// pass PASS and the ones after it; the last leaves the spectrum in `s`
template <int LOG2M, int PASS>
__device__ __forceinline__ void run_passes(float2 (&v)[16], float2* s, int t,
                                           const float2* __restrict__ table) {
  using P = Plan<LOG2M>;
  constexpr int R = PASS < P::N16 ? 16 : P::LAST;
  stockham_pass<LOG2M, R, 4 * PASS>(v, s, t, table);
  __syncthreads();
  if constexpr (PASS + 1 < P::PASSES) {
#pragma unroll
    for (int c = 0; c < 16; ++c) v[c] = s[pad(t + P::T * c)];
    __syncthreads();
    run_passes<LOG2M, PASS + 1>(v, s, t, table);
  }
}

template <int LOG2M>
__global__ void __launch_bounds__(Plan<LOG2M>::THREADS, 512 / Plan<LOG2M>::THREADS)
    stft_mag_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                    const float* __restrict__ window, const float2* __restrict__ twiddle,
                    float* __restrict__ out, long long n, long long total, int hop, int frames,
                    int k_out, float floor_lin) {
  using P = Plan<LOG2M>;
  constexpr int M = P::M, T = P::T;
  extern __shared__ float2 smem[];
  const int t = threadIdx.x % T;
  const int slot = threadIdx.x / T;
  float2* s = smem + slot * P::PADDED;
  // g indexes (row, frame) pairs; a block's last slots may lie past the end
  const long long g = (long long)blockIdx.x * P::FRAMES + slot;
  const bool live = g < total;
  const long long row = live ? g / frames : 0;
  const int frame = live ? (int)(g % frames) : 0;
  const float* src = x + row * n + (long long)frame * hop;
  const float2* win = reinterpret_cast<const float2*>(window);

  // window and pack, natural order: v[c] = z[t + T c]
  float2 v[16];
  if (!live) {
#pragma unroll
    for (int c = 0; c < 16; ++c) v[c] = make_float2(0.f, 0.f);
  } else if ((reinterpret_cast<uintptr_t>(src) & 7) == 0) {
    const float2* src2 = reinterpret_cast<const float2*>(src);
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const float2 a = __ldg(src2 + t + T * c), w = __ldg(win + t + T * c);
      v[c] = make_float2(a.x * w.x, a.y * w.y);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int m = t + T * c;
      const float2 w = __ldg(win + m);
      v[c] = make_float2(__ldg(src + 2 * m) * w.x, __ldg(src + 2 * m + 1) * w.y);
    }
  }

  run_passes<LOG2M, 0>(v, s, t, twiddle);
  if (!live) return;

  // rfft bins from the packed spectrum, floor, frame validity
  const bool valid = (long long)frame * hop + 2 * M <= (long long)lengths[row];
  float* dst = out + g * k_out;
  for (int k = t; k < k_out; k += T) {
    const float2 zk = s[pad(k & (M - 1))];
    const float2 zc = s[pad((M - k) & (M - 1))];
    const float er = 0.5f * (zk.x + zc.x);
    const float ei = 0.5f * (zk.y - zc.y);
    const float2 o = make_float2(0.5f * (zk.y + zc.y), -0.5f * (zk.x - zc.x));
    const float2 wo = cmul(__ldg(twiddle + k), o);
    const float xr = er + wo.x;
    const float xi = ei + wo.y;
    const float mag = sqrtf(xr * xr + xi * xi);
    dst[k] = valid ? fmaxf(mag, floor_lin) : 0.0f;
  }
}

template <int LOG2M>
cudaError_t launch(const float* x, const int* lengths, const float* window,
                   const float2* twiddle, float* out, long long rows, long long n, int hop,
                   int frames, int k_out, float floor_lin, cudaStream_t stream) {
  using P = Plan<LOG2M>;
  const size_t smem = sizeof(float2) * P::PADDED * P::FRAMES;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stft_mag_kernel<LOG2M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long total = rows * frames;
  const long long blocks = (total + P::FRAMES - 1) / P::FRAMES;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  stft_mag_kernel<LOG2M><<<(unsigned)blocks, P::THREADS, smem, stream>>>(
      x, lengths, window, twiddle, out, n, total, hop, frames, k_out, floor_lin);
  return cudaGetLastError();
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
  int log2_half = 0;
  while (log2_half < 31 && (1 << (log2_half + 1)) < n_fft) ++log2_half;
  if (n_fft <= 0 || (n_fft & (n_fft - 1)) != 0 || log2_half < kMinLog2Half ||
      log2_half > kMaxLog2Half || hop <= 0 || k_out <= 0 || k_out > n_fft / 2 + 1 ||
      (long long)(frames - 1) * hop + n_fft > n ||
      (reinterpret_cast<uintptr_t>(window) & 7) != 0 ||
      (reinterpret_cast<uintptr_t>(twiddle) & 7) != 0)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0 || frames <= 0) return 0;
  const float2* tw = static_cast<const float2*>(twiddle);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (log2_half) {
    case 7: return (int)launch<7>(x, lengths, window, tw, out, rows, n, hop, frames, k_out, floor_lin, st);
    case 8: return (int)launch<8>(x, lengths, window, tw, out, rows, n, hop, frames, k_out, floor_lin, st);
    case 9: return (int)launch<9>(x, lengths, window, tw, out, rows, n, hop, frames, k_out, floor_lin, st);
    case 10: return (int)launch<10>(x, lengths, window, tw, out, rows, n, hop, frames, k_out, floor_lin, st);
    case 11: return (int)launch<11>(x, lengths, window, tw, out, rows, n, hop, frames, k_out, floor_lin, st);
    case 12: return (int)launch<12>(x, lengths, window, tw, out, rows, n, hop, frames, k_out, floor_lin, st);
    default: return (int)launch<13>(x, lengths, window, tw, out, rows, n, hop, frames, k_out, floor_lin, st);
  }
}
