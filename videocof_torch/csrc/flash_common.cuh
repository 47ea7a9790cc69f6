// Building blocks shared by the attention kernels for Hopper (sm_90a): the
// bf16/fp16 element traits (conversions, and the packing of two fp32 values
// into one 32-bit register of 16-bit pairs, the form of a wgmma A fragment),
// the exp2 of the softmax, and the constants of the TPU kernels' arithmetic.
// Included through `hopper_attention.cuh` by `flash_attention_fwd.cu`,
// `flash_attention_bwd.cu` and `int8_attention.cu`.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kMaskedLogit = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T> struct Elem;

template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

template <> struct Elem<__half> {
  static __device__ __forceinline__ float to_float(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ __half from_float(float x) {
    return __float2half_rn(x);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace flash
