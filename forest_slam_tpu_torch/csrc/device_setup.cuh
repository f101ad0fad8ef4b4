// The opt-in shared memory of the current device, with a kernel's launch
// attributes set once per device rather than once per launch (a runtime
// call on the launch path, which the host-bound paths feel): its dynamic
// shared memory raised to the opt-in limit and, where asked, cluster sizes
// past the portable 8 allowed. Shared by csrc/refine_cost.cu and
// csrc/sinkhorn.cu; one instance per kernel.

#pragma once

#include <cuda_runtime.h>

struct DeviceSetup {
  static constexpr int kDevices = 64;
  int cap[kDevices] = {};

  // *out: the device's opt-in shared memory per block, in bytes
  cudaError_t get(const void* kernel, bool nonportable_clusters, int* out) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < kDevices && cap[dev] > 0) {
      *out = cap[dev];
      return cudaSuccess;
    }
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    if (nonportable_clusters) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    if (dev < kDevices) cap[dev] = optin;
    *out = optin;
    return cudaSuccess;
  }
};
