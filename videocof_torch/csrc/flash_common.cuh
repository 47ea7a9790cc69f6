// Building blocks shared by the flash-attention kernels for Hopper (sm_90a):
// the bf16/fp16 element traits with their mma.sync m16n8k16 product, ldmatrix
// and cp.async wrappers, the XOR swizzle of shared-memory tiles, and the tile
// loader. Included by `flash_attention_bwd.cu` and, through
// `hopper_attention.cuh`, by `flash_attention_fwd.cu` and `int8_attention.cu`.
//
// Fragment layout of mma.sync m16n8k16 used throughout (per warp, lane =
// thread index in the warp): an fp32 accumulator tile of 16 rows x 8 columns
// holds rows lane/4 (elements 0, 1) and lane/4 + 8 (elements 2, 3), at columns
// (lane % 4) * 2 and + 1. Two neighbouring 16 x 8 accumulator tiles, packed
// to the input type, are exactly the A operand of a product over their 16
// columns, so a probability tile never leaves the registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
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
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16-byte async copy; src_bytes 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// 4-byte async copy (one fp32), zero-filled when not valid.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Element offset of (row, 16-byte chunk) in a [rows, D] tile whose chunks are
// XOR-swizzled by the row's low three bits.
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

// Stage rows [row0, row0 + ROWS) of one head into a swizzled tile; rows at or
// past `len` are zero-filled.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* tile, const T* base, int row0,
                                          int len, long long row_stride,
                                          int tid) {
  constexpr int kChunks = D / 8;
  static_assert(ROWS * kChunks % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = row0 + r < len;
    const T* src = valid ? base + (long long)(row0 + r) * row_stride + c * 8
                         : base;
    cp_async_16(tile + swz<D>(r, c), src, valid);
  }
}

// Stage `n` fp32 values of one row vector ([.., L] contiguous), zero past len.
template <int N>
__device__ __forceinline__ void load_vec(float* dst, const float* base,
                                         int row0, int len, int tid) {
  static_assert(N <= kThreads, "one value per thread");
  if (tid < N) {
    const bool valid = row0 + tid < len;
    cp_async_4(dst + tid, valid ? base + row0 + tid : base, valid);
  }
}

}  // namespace flash
