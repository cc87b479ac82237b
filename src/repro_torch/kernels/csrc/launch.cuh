// Host-side helpers of the launchers: the card's SM count, which sizes
// the persistent grids (sliding_dft.cu, pairwise_corr.cu), and
// cuTensorMapEncodeTiled for the sources that encode TMA tensor maps
// (flash_attention.cu, pairwise_corr.cu), reached through the runtime's
// driver entry point, so that no library links -lcuda.
#pragma once

#include <cuda.h>                       // CUtensorMap and its enums only
#include <cuda_runtime.h>

namespace sde {

// SMs of the current device, asked once per device.
inline int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0 &&
      cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return cached[dev];
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  if (found == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess) return err;
    if (status != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorNotSupported;
    found = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = found;
  return cudaSuccess;
}

}  // namespace sde
