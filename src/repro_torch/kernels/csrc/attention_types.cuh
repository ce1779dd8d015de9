// Element types of the attention kernels K3 and K4.  The float32 kernels
// read float32 (`to_float`); every kernel rounds its float32 result to the
// output's type (`from_float`).  The build defines
// __CUDA_NO_BFLOAT16_CONVERSIONS__ and its fp16 twin, so conversions go
// through the intrinsics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace repro_attention {

constexpr float kNegInf = -1e30f;   // the reference's masked score

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as JAX's astype
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);       // round to nearest even
}

}  // namespace repro_attention
