// The card a launcher launches on, made current for the launch only.
//
// cudaSetDevice changes the calling thread's current device, which PyTorch
// reads for its current stream, its events and every allocation made with
// a bare device="cuda".  A launcher that left it on its tensor's card
// would move all of those to another card after a launch there (a shard of
// a graph split over several cards).  DeviceGuard sets the launch's card
// and sets the caller's back when the launcher returns, after the launch
// and its error check.
#pragma once

#include <cuda_runtime.h>

struct DeviceGuard {
  int previous = -1;
  bool switched = false;
  cudaError_t err;

  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&previous);
    if (err == cudaSuccess && previous != device) {
      err = cudaSetDevice(device);
      switched = err == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched) cudaSetDevice(previous);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};
