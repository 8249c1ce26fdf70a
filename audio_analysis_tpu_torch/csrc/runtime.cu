// Error text for the codes the kernel entries return (see _build.check).

#include <cuda_runtime.h>

extern "C" const char* aa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
