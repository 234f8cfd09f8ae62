// Shared plumbing of the port's hand-written Hopper kernels.
//
// Every kernel library is a plain C interface loaded with ctypes: each
// exported launcher takes raw device pointers, sizes and the caller's
// stream, launches, and returns cudaGetLastError() so the Python wrapper can
// raise on a refused launch.  Nothing here allocates or synchronises.
#pragma once

#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// Message of a CUDA error code returned by a launcher.
REPRO_EXPORT const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bind the launching thread to the tensor's device (the static runtime of
// this library keeps its own notion of the current device).
static inline cudaError_t repro_set_device(int device) {
  return cudaSetDevice(device);
}
