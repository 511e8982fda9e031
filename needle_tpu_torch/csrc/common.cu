// Helpers shared by every kernel entry point of the port's C interface.

#include <cuda_runtime.h>

// Human-readable name of a cudaError_t returned by an entry point.
extern "C" const char* needle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
