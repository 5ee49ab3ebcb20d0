// C-interface helpers shared by every kernel wrapper.
#include "common.cuh"

extern "C" const char* dst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
