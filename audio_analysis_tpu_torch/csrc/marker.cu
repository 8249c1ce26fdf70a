// Block markers of the engine step: one empty kernel for each boundary,
// each under its own name, so that a device trace tells the engine's
// blocks apart (engine/batch.py analyze_batch, ops/marker.py). A marker
// is one thread that does nothing; launched on the step's stream, it is
// captured into the step's CUDA graph and shows in every replay.

#include <cuda_runtime.h>

extern "C" __global__ void aa_mark_deinterleave() {}
extern "C" __global__ void aa_mark_align_decay() {}
extern "C" __global__ void aa_mark_bands() {}
extern "C" __global__ void aa_mark_fr_gd() {}
extern "C" __global__ void aa_mark_stft() {}
extern "C" __global__ void aa_mark_modal() {}
extern "C" __global__ void aa_mark_diffusion() {}
extern "C" __global__ void aa_mark_end() {}

// block: the index of the marker in ops/marker.py BLOCKS.
extern "C" int aa_mark(int block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 0: aa_mark_deinterleave<<<1, 1, 0, s>>>(); break;
    case 1: aa_mark_align_decay<<<1, 1, 0, s>>>(); break;
    case 2: aa_mark_bands<<<1, 1, 0, s>>>(); break;
    case 3: aa_mark_fr_gd<<<1, 1, 0, s>>>(); break;
    case 4: aa_mark_stft<<<1, 1, 0, s>>>(); break;
    case 5: aa_mark_modal<<<1, 1, 0, s>>>(); break;
    case 6: aa_mark_diffusion<<<1, 1, 0, s>>>(); break;
    case 7: aa_mark_end<<<1, 1, 0, s>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
