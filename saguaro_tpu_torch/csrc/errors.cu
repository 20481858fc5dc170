// Error strings for the ctypes bindings of the segment-reduction kernels.
#include <cuda_runtime.h>

extern "C" const char* sag_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
