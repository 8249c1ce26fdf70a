// Schroeder energy decay curve in dB, one row per (tap, channel, band).
//
// Replaces the TPU kernel audio_analysis_tpu/ops/pallas_kernels.py:100
// schroeder_edc_db_pallas (pallas_call at :143, body _edc_kernel) and
// computes the whole contract of audio_analysis_tpu/ops/edc.py
// schroeder_edc_db in one launch: energy x^2 masked past the row's
// `length`, backward (suffix) sum, eps floor, normalisation by the value at
// index 0, 10*log10, display floor, and 0 past `length`. Any row length N
// and any number of rows (the TPU kernel needed N % 16384 == 0).
//
// What bounds it: bytes. The curve needs one read and one write of N floats
// per row (at the main path's 48 rows x 2^20: 201 MB each way, 0.120 ms at
// 3.35 TB/s) and a handful of operations per sample.
//
// Design. The TPU kernel walked each row tail-first through one sequential
// grid, carrying the running sum in scratch memory. Hopper's blocks run in
// parallel and in no order, so a tile's suffix needs the totals of the tiles
// after it. Two kinds of work item, each a tile of kTile samples, share one
// launch:
//   total(r, t): the tile's sum, published to scratch as one 64-bit word
//                (the float and a flag), so no fence or count is needed;
//   scan(r, t):  reads the row's published totals (waiting for any whose
//                flag is not set yet), sums those of the tiles after its own
//                (its carry) and of the whole row, redoes the in-tile suffix
//                and writes the curve.
// Work is handed out by an atomic ticket counter, not by blockIdx: the grid
// is as many blocks as the card holds at once, and each block takes its next
// ticket while it works on the current one (the counter's latency is then
// off the critical path). Tickets hand out rows in order and interleave the
// totals of row r + kLead with the scans of row r (item_of), so a scan only
// waits for items of lower tickets. Those are held by blocks that are
// running: the lowest unfinished ticket is always a block's current item,
// and all it waits for is finished. So the kernel makes progress at any
// occupancy and under any block order, without co-residency or a
// cooperative launch. Between a tile's two reads lie only kLead rows of
// first reads (12 MB at N = 2^20), so the second read comes from the 50 MB
// L2: HBM sees each row read once (the first read caches at L2, the second
// is an evict-first __ldcs) and the curve written once, with evict-first
// __stcs stores that do not push waiting rows out of L2. The totals and the
// ticket counter are zeroed by one cudaMemsetAsync in the C entry, on the
// stream. (A per-row count of published totals, read with an acquire load,
// was tried first: its round trip sat between each scan and its totals,
// and the kernel was markedly slower on the H100.)
//
// Inside a tile a thread owns four 16-byte chunks, chunk c at sample
// 1024 c + 4 tid, so every load and store is a coalesced float4 (a scalar
// edge path takes a tile cut by the row's end or length, or a row that is
// not 16-byte aligned). The suffix is formed from the samples after each
// position, never as total - prefix, which cancels catastrophically on fast
// decays where the tail is 1e-12 of the total: a serial suffix within the
// chunk, a shuffle suffix scan over the warp's lanes, the warps' chunk
// totals through shared memory (the item's one barrier), and the totals of
// later chunk rounds and later tiles. No sample goes through shared memory.
// All sums are fp32 in a fixed order with no atomics in the arithmetic, so
// two calls give bit-identical output; squares are __fmul_rn so that no
// item contracts them into a fused multiply-add differently from another.
// The row total is tile 0's published total plus the later tiles' totals in
// the very order in which the scan of tile 0 adds them at index 0, so the
// value at index 0 and the normaliser are the same float. The dB value is
// 10 log10(2) (log2(max(s, eps)) - log2(max(total, eps))) with the second
// term computed once per item, so there is no division per sample and
// index 0 is exactly 0 dB. log2 is the hardware __log2f (MUFU.LG2): within
// 2^-22 absolute on [0.5, 2] and 2 ulp elsewhere, so above -100 dB (energies
// within 2^-34 of a total below 2^40) it adds at most 4 x 2^-18 x 3.0103,
// about 5e-5 dB, to the curve.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                            // floats per 16-byte access
constexpr int kRounds = 4;                         // chunks per thread
constexpr int kRoundStride = kThreads * kVec;      // samples between a thread's chunks
constexpr int kTile = kRoundStride * kRounds;      // 4096 samples per work item
// Rows by which the totals run ahead of the scans. The scans of row r are
// handed out (2 kLead - 1) rows' worth of tiles after the last total of row
// r: at N = 2^20 that is 1,280 tickets, more than the H100 holds at once
// (132 SMs x 4 blocks, each with its current and its next ticket), so a
// scan rarely waits. And only kLead rows of fresh reads (12 MB at
// N = 2^20) and as many rows of evict-first writes pass through the 50 MB
// L2 between a tile's two reads. On the H100 (scripts/torch_edc_ab.py
// --lead) a lead of 2 rows is as fast within the noise and 4 rows is
// slower.
constexpr int kLead = 3;
constexpr float kDbPerLog2 = 3.01029995663981195f;  // 10 log10(2)

struct Item {
  bool scan;
  unsigned row;
  unsigned tile;
};

// ticket -> work item: totals of rows [0, lead), then per row m the totals of
// row m + lead and the scans of row m, then the scans of the last lead rows
__device__ __forceinline__ Item item_of(unsigned q, unsigned rows, unsigned tiles) {
  const unsigned lead = rows < kLead ? rows : kLead;
  const unsigned head = lead * tiles;
  if (q < head) return Item{false, q / tiles, q % tiles};
  q -= head;
  const unsigned mid = (rows - lead) * 2 * tiles;
  if (q < mid) {
    const unsigned m = q / (2 * tiles), r = q % (2 * tiles);
    return r < tiles ? Item{false, lead + m, r} : Item{true, m, r - tiles};
  }
  q -= mid;
  return Item{true, rows - lead + q / tiles, q % tiles};
}

__device__ __forceinline__ bool aligned16(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A published tile total: the float's bits and a flag in the high word,
// stored and loaded as one aligned 64-bit word, so a reader sees either
// nothing (0) or the whole value. No fence or count sits between a scan and
// the totals it needs.
__device__ __forceinline__ void publish(unsigned long long* slot, float total) {
  *reinterpret_cast<volatile unsigned long long*>(slot) = (1ull << 32) | __float_as_uint(total);
}
__device__ __forceinline__ unsigned long long load_total(const unsigned long long* slot) {
  return *reinterpret_cast<const volatile unsigned long long*>(slot);
}
// the total in `word`, loaded from `slot`, once it is published (by an
// item of a lower ticket)
__device__ __forceinline__ float await_total(const unsigned long long* slot, unsigned long long word) {
  while ((word >> 32) == 0) {
    __nanosleep(32);
    word = load_total(slot);
  }
  return __uint_as_float((unsigned)word);
}

// shared memory of one work item; a block alternates between two so that
// one barrier per item suffices
struct ItemShared {
  unsigned ticket;       // this item's ticket, taken during the item before
  int length;            // its row's valid length
  float4 warp_sums[kWarps];  // each warp's sum of each chunk round
  float after_tile[kWarps];  // partial sums of the later tiles' totals
  float after_first[kWarps]; // ... and of the totals of tiles 1..
};

__global__ void __launch_bounds__(kThreads) edc_kernel(
    const float* __restrict__ x, const int* __restrict__ lengths,
    unsigned long long* __restrict__ tile_totals, unsigned* __restrict__ ticket_counter,
    float* __restrict__ out, unsigned rows, long long n, unsigned tiles, float eps,
    float floor_db) {
  __shared__ ItemShared sh[2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned items = 2 * rows * tiles;

  if (tid == 0) {
    const unsigned q = atomicAdd(ticket_counter, 1u);
    sh[0].ticket = q;
    sh[0].length = q < items ? lengths[item_of(q, rows, tiles).row] : 0;
  }
  __syncthreads();

  // the block's items, one after another, in ticket order
  for (int k = 0;; k ^= 1) {
    ItemShared& cur = sh[k];
    const unsigned q = cur.ticket;
    if (q >= items) return;
    // take the next ticket now; it is used once this item is done
    unsigned next = 0;
    if (tid == 0) next = atomicAdd(ticket_counter, 1u);

    const Item it = item_of(q, rows, tiles);
    const long long tile0 = (long long)it.tile * kTile;
    const float* xr = x + it.row * n + tile0;
    float* orow = out + it.row * n + tile0;
    unsigned long long* row_totals = tile_totals + (long long)it.row * tiles;
    // samples [0, limit) of the tile lie inside the row and its length; a
    // tile wholly past the length (limit 0) reads nothing: total 0, curve 0
    const long long len = cur.length < n ? cur.length : n;
    const int limit = len <= tile0 ? 0 : len - tile0 >= kTile ? kTile : (int)(len - tile0);
    const bool vec_in = limit == kTile && aligned16(xr);

    // this thread's samples: chunk c at offset c kRoundStride + tid kVec
    float s[kRounds][kVec];
#pragma unroll
    for (int c = 0; c < kRounds; ++c) {
      const int o = c * kRoundStride + tid * kVec;
      if (vec_in) {
        const float4* p = reinterpret_cast<const float4*>(xr + o);
        const float4 f = it.scan ? __ldcs(p) : __ldcg(p);
        s[c][0] = f.x, s[c][1] = f.y, s[c][2] = f.z, s[c][3] = f.w;
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          s[c][j] = o + j < limit ? (it.scan ? __ldcs(xr + o + j) : __ldcg(xr + o + j)) : 0.0f;
      }
    }

    float a = 0.0f, b = 0.0f, first_total = 0.0f;
    if (it.scan && limit > 0) {
      // while the samples are on their way: the row's tile totals (waiting
      // for any not yet published), reduced in a fixed order to the later
      // tiles' sum and the sum of all tiles but the first
      const int u0 = (int)tiles - 1 - tid;
      const unsigned long long w0 = load_total(row_totals);
      const unsigned long long wu = u0 >= 1 ? load_total(row_totals + u0) : 0;
      first_total = await_total(row_totals, w0);
      for (int u = u0; u >= 1; u -= kThreads) {
        const float v = await_total(row_totals + u, u == u0 ? wu : load_total(row_totals + u));
        if (u > (int)it.tile) a = a + v;
        b = b + v;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        a = a + __shfl_xor_sync(0xffffffffu, a, off);
        b = b + __shfl_xor_sync(0xffffffffu, b, off);
      }
      if (lane == 0) {
        cur.after_tile[warp] = a;
        cur.after_first[warp] = b;
      }
    }

    // energy, then each chunk's serial suffix in place
#pragma unroll
    for (int c = 0; c < kRounds; ++c) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) s[c][j] = __fmul_rn(s[c][j], s[c][j]);
#pragma unroll
      for (int j = kVec - 2; j >= 0; --j) s[c][j] = s[c][j] + s[c][j + 1];
    }

    // per round: the sum of the chunks of the later lanes of this warp
    // (inclusive shuffle suffix scan, then shifted by one lane)
    float later_lanes[kRounds], incl[kRounds];
#pragma unroll
    for (int c = 0; c < kRounds; ++c) {
      incl[c] = s[c][0];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_down_sync(0xffffffffu, incl[c], off);
        if (lane + off < 32) incl[c] = incl[c] + y;
      }
      later_lanes[c] = __shfl_down_sync(0xffffffffu, incl[c], 1);
      if (lane == 31) later_lanes[c] = 0.0f;
    }
    // lane 0's inclusive suffix is the warp's sum of the round
    if (lane == 0) cur.warp_sums[warp] = make_float4(incl[0], incl[1], incl[2], incl[3]);
    if (tid == 0) {
      ItemShared& nxt = sh[k ^ 1];
      nxt.ticket = next;
      nxt.length = next < items ? lengths[item_of(next, rows, tiles).row] : 0;
    }
    __syncthreads();
    // a total item needs only thread 0's carry below
    if (!it.scan && tid != 0) continue;

    // the later warps' chunk sums per round, and each round's tile-wide sum,
    // both accumulated from the last warp down
    float acc[kRounds] = {0.0f, 0.0f, 0.0f, 0.0f};
    float later_warps[kRounds] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int w = kWarps - 1; w >= 0; --w) {
      if (w == warp) {
#pragma unroll
        for (int c = 0; c < kRounds; ++c) later_warps[c] = acc[c];
      }
      const float4 ws = cur.warp_sums[w];
      acc[0] = acc[0] + ws.x;
      acc[1] = acc[1] + ws.y;
      acc[2] = acc[2] + ws.z;
      acc[3] = acc[3] + ws.w;
    }
    // carry of each chunk within the tile: later lanes, warps and rounds
    float thread_carry[kRounds];
    float later_rounds = 0.0f;
#pragma unroll
    for (int c = kRounds - 1; c >= 0; --c) {
      thread_carry[c] = (later_lanes[c] + later_warps[c]) + later_rounds;
      later_rounds = later_rounds + acc[c];
    }

    if (!it.scan) {
      // the tile's total: its suffix at its first sample
      publish(row_totals + it.tile, s[0][0] + thread_carry[0]);
      continue;
    }

    float carry = 0.0f, first = 0.0f;
    if (limit > 0) {
#pragma unroll
      for (int w = kWarps - 1; w >= 0; --w) {
        carry = carry + cur.after_tile[w];
        first = first + cur.after_first[w];
      }
    }
    // row total = tile 0's total + the tiles after it: at tile 0, index 0
    // this is the same float as the curve's value there
    const float total = first_total + first;
    const float log_denom = __log2f(fmaxf(total, eps));
    const int room = n - tile0 >= kTile ? kTile : (int)(n - tile0);
    const bool vec_out = room == kTile && aligned16(orow);
#pragma unroll
    for (int c = 0; c < kRounds; ++c) {
      const int o = c * kRoundStride + tid * kVec;
      float d[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float suffix = (s[c][j] + thread_carry[c]) + carry;
        d[j] = fmaxf(kDbPerLog2 * (__log2f(fmaxf(suffix, eps)) - log_denom), floor_db);
      }
      if (limit < kTile) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) d[j] = o + j < limit ? d[j] : 0.0f;
      }
      if (vec_out) {
        __stcs(reinterpret_cast<float4*>(orow + o), make_float4(d[0], d[1], d[2], d[3]));
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          if (o + j < room) __stcs(orow + o + j, d[j]);
      }
    }
  }
}

}  // namespace

extern "C" int aa_edc_tile_size() { return kTile; }

// x, out: (rows, n) float32 row-major; lengths: (rows,) int32; scratch:
// rows * ceil(n / kTile) 64-bit flagged tile totals followed by the 32-bit
// ticket counter, all of which this entry zeroes on the stream before the
// one launch. The grid is as many blocks as the card holds at once (fewer
// for a small call); each block works through tickets until they run out.
extern "C" int aa_edc_db(const float* x, const int* lengths, float* scratch,
                         float* out, long long rows, long long n, float eps,
                         float floor_db, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (x == nullptr || lengths == nullptr || scratch == nullptr || out == nullptr ||
      (reinterpret_cast<uintptr_t>(scratch) & 7) != 0)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles > 0x3fffffffLL || rows > 0x3fffffffLL / tiles) return (int)cudaErrorInvalidValue;
  const long long items = 2 * rows * tiles;
  // blocks the card holds at once, asked once per process (its cards alike)
  static int resident = 0;
  if (resident == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, edc_kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long blocks = items < resident ? items : resident;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* totals = reinterpret_cast<unsigned long long*>(scratch);
  unsigned* ticket = reinterpret_cast<unsigned*>(totals + rows * tiles);
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)(rows * tiles) * 8 + 4, s);
  if (err != cudaSuccess) return (int)err;
  edc_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(x, lengths, totals, ticket, out, (unsigned)rows,
                                                   n, (unsigned)tiles, eps, floor_db);
  return (int)cudaGetLastError();
}
