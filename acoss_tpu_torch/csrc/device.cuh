// The device scope of a C entry point: it makes the tensors' device
// current for the launch and gives the caller back its own current device
// on return, so a launch on one card never moves a later allocation of the
// same thread onto it.

#pragma once

#include <cuda_runtime.h>

namespace acoss {

class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      restore_ = err_ == cudaSuccess;
    }
  }
  ~DeviceScope() {
    if (restore_) cudaSetDevice(prev_);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;
  // cudaSuccess, or the error of reading or setting the current device
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool restore_ = false;
  cudaError_t err_;
};

}  // namespace acoss
