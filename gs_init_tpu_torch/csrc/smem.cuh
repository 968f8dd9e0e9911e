// Dynamic shared memory above the 48 KB default, for the launchers of every
// kernel that takes more (composite_fwd.cu, composite_bwd.cu,
// sam_attention.cu).
#pragma once

#include <cuda_runtime.h>

namespace gs {

// Let `Kernel` take `bytes` of dynamic shared memory on the current device.
// Above 48 KB that needs cudaFuncSetAttribute, set once per kernel and
// device: each kernel (each instance of a template) has its own record.
template <auto Kernel>
cudaError_t allow_smem(size_t bytes) {
  static int allowed[64] = {};  // bytes allowed so far, per device
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && allowed[dev] >= static_cast<int>(bytes)) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 64) allowed[dev] = static_cast<int>(bytes);
  return err;
}

}  // namespace gs
