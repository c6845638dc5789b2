// Error names for the Python wrappers: every launch function in this
// directory returns the cudaError_t of its launch as an int, and
// kernels/_build.py turns a nonzero one into an exception with this name.
#include <cuda_runtime.h>

extern "C" const char* spira_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
