// Device helpers shared by every kernel source of the port: element
// conversion between the storage types (bf16, fp32) and the fp32 the
// kernels compute in, and the error-string entry point each library
// exports. Each source is its own library (build.py), so the helpers sit
// in an anonymous namespace and every library carries its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and back: an fp32 value as T would hold it
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

}  // namespace

extern "C" const char* tpushare_cuda_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
