// Helpers shared by every kernel of the library (one copy per shared object).
#include <cuda_runtime.h>

// Text of a CUDA error code a kernel's C entry point returned.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
