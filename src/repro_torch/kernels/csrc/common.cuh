// Shared by every kernel library of the port: the C interface convention.
//
// Each library exports plain `extern "C"` launchers. Pointers and the CUDA
// stream arrive as void pointers (PyTorch's data_ptr() and
// current_stream().cuda_stream, passed through ctypes), sizes as int. A
// launcher enqueues its kernel on the given stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so that a refused launch
// surfaces in the Python wrapper as an exception.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

constexpr int kThreads = 256;

inline unsigned int grid_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

REPRO_EXPORT const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
