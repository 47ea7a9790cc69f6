// Building blocks for Hopper (sm_90a) kernels written with the Tensor Memory
// Accelerator (TMA), mbarriers and warpgroup matrix products (wgmma):
// mbarrier init / arrive / expect_tx / try_wait.parity, 4-D tiled TMA loads
// (`cp.async.bulk.tensor`, 2-, 3- and 4-D), the fp32 TMA reduce-add of a box
// into global memory (`cp.reduce.async.bulk.tensor`) with its bulk groups,
// the shared-memory matrix descriptor of a 128-byte-swizzled tile, wgmma
// wrappers (SS m64n128k16 for S = Q K^T in bf16/fp16, SS m64n64k16 with
// either operand K- or MN-major for the backward's products, SS
// m64n{64,128}k32 s8 x s8 -> s32 for the int8 S = Qi Ki^T, RS
// m64n{64,128,256}k16 with A from registers for O += P V), setmaxnreg, the
// generic-to-async proxy fence, named barriers, and on the host the encoding
// of TMA tensor maps. Included by `flash_attention_fwd.cu`,
// `flash_attention_bwd.cu` and `int8_attention.cu` (through
// `hopper_attention.cuh`).
//
// Layouts. A TMA box of 64 16-bit elements (128 bytes) by R rows, loaded with
// CU_TENSOR_MAP_SWIZZLE_128B, lands as R rows of 128 bytes with the 16-byte
// chunks of row r XOR-ed by r % 8: the canonical 128-byte-swizzled layout of
// wgmma. A [rows, 128] tile is two such boxes side by side ("halves"); an
// int8 box holds 128 values a row, so an int8 [rows, 128] tile is one box.
// A box's base must be 1024-byte aligned (one swizzle period of 8 rows), so
// the descriptors carry base offset 0.
// - K-major operand (Q, K: the reduction dimension D is contiguous): the
//   descriptor's stride byte offset is 1024 (8 rows of 128 bytes); the k16
//   slice kk of a 16-bit half, or the k32 slice kk of an int8 box, starts kk
//   * 32 bytes into it. 8-bit wgmma takes only K-major operands.
// - MN-major operand (V as B of P V: D, the N dimension, is contiguous):
//   leading byte offset = the byte stride between 64-element halves along
//   N, stride byte offset = 1024 (8 key rows); the k16 slice kk (16 keys)
//   starts kk * 16 rows * 128 bytes in. The instruction's transpose bit for
//   B is set (16-bit types allow it). An A operand stored with M contiguous
//   (a [K rows][64] tile) is read the same way with A's transpose bit.
// The fp32 accumulator of m64nNk16 (and the s32 one of m64nNk32): thread t of the warpgroup (warp w, lane
// l) holds d[4j + 2r + e] = D(16w + l/4 + 8r, 8j + 2(l%4) + e), the layout of
// mma.sync m16n8 tiles stacked along N; the RS A operand of m64n*k16 is the
// mma.sync m16n8k16 A fragment, so two neighbouring 8-column accumulator
// tiles packed to 16 bits are the A operand of a 16-deep product.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

constexpr int kBoxCols = 64;   // 16-bit values in one 128-byte TMA box row
constexpr int kBoxBytes = 128; // bytes in one 128-byte TMA box row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// One arrival, and `bytes` more transaction bytes to wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// ----------------------------------------------------------------------- TMA

// A 2-D box of `map` at coordinates (c0, c1), innermost first, into shared
// memory at `dst`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A 3-D box of `map` at coordinates (c0, c1, c2), innermost first.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A 4-D box of `map` at coordinates (c0, c1, c2, c3), innermost first, into
// shared memory at `dst`; completes `bytes` of the barrier's transaction.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Adds the fp32 4-D box at `src` in shared memory into `map` at coordinates
// (c0, c1, c2, c3), innermost first (elements outside the tensor are
// dropped); tracked by the issuing thread's bulk groups.
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's bulk groups still read shared
// memory (the source may then be overwritten).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// Waits until at most N of this thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// Counts this thread towards barrier `id` without waiting for it.
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------- registers

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ---------------------------------------------------------------------- wgmma

// Descriptor of a 128-byte-swizzled operand tile at `p` (see the layouts
// above); `lbo` and `sbo` in bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t desc = (smem_u32(p) & 0x3FFFFu) >> 4;
  desc |= static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16;
  desc |= static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32;
  desc |= 1ull << 62;   // layout type 1: 128-byte swizzle
  return desc;
}

// The two 32-bit words of sw128_desc: the low one holds the address and the
// leading byte offset, the high one the stride byte offset and the layout
// type (a constant), so a kernel may keep only the low word in a register.
__device__ __forceinline__ uint32_t sw128_desc_lo(const void* p,
                                                  uint32_t lbo) {
  return ((smem_u32(p) & 0x3FFFFu) >> 4) | (((lbo >> 4) & 0x3FFFu) << 16);
}

__device__ __forceinline__ uint64_t sw128_desc_from_lo(uint32_t lo,
                                                       uint32_t sbo) {
  return static_cast<uint64_t>(((sbo >> 4) & 0x3FFFu) | (1u << 30)) << 32 |
         lo;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products' fence, commit and wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// The instructions, one macro per shape; TY is the PTX type, bf16 or f16.
#define HOPPER_WGMMA_SS_N128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"  \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"  \
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"  \
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "%64, %65, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))

#define HOPPER_WGMMA_SS_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"  \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, %35, %36;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TA), "n"(TB))

#define HOPPER_WGMMA_RS_N128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"  \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"  \
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"  \
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d))

#define HOPPER_WGMMA_RS_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"  \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d))

#define HOPPER_WGMMA_SS_S8_N128 \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "%64, %65, p;\n}\n" \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), \
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), \
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), \
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), \
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), \
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]) \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))

#define HOPPER_WGMMA_SS_S8_N64 \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p;\n}\n" \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), \
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]) \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))

#define HOPPER_WGMMA_RS_N256(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63," \
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79," \
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95," \
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111," \
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, " \
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d))


// d (+)= A B for a 64 x 128 x 16 product, A and B K-major in shared memory
// (descriptors); scale_d 0 overwrites d.
template <typename T>
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    HOPPER_WGMMA_SS_N128("f16");
  } else {
    HOPPER_WGMMA_SS_N128("bf16");
  }
}

// d (+)= A B for a 64 x 64 x 16 product, A and B in shared memory
// (descriptors); TA / TB 1 reads A / B MN-major (the transpose bits), 0
// K-major; scale_d 0 overwrites d.
template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    HOPPER_WGMMA_SS_N64("f16");
  } else {
    HOPPER_WGMMA_SS_N64("bf16");
  }
}

// d (+)= A B for a 64 x N x 32 int8 product accumulated in s32, A and B
// K-major in shared memory (descriptors); scale_d 0 overwrites d. The
// integer instruction has no scale or transpose immediates.
template <int N>
__device__ __forceinline__ void wgmma_ss_s8(uint32_t (&d)[N / 2],
                                            uint64_t desc_a, uint64_t desc_b,
                                            int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_ss_s8: N is 64 or 128");
  if constexpr (N == 128) {
    HOPPER_WGMMA_SS_S8_N128;
  } else {
    HOPPER_WGMMA_SS_S8_N64;
  }
}

// d (+)= A B for a 64 x N x 16 product, A from registers (four 32-bit
// registers of packed 16-bit pairs, the m16n8k16 A fragment of each warp's 16
// rows), B MN-major in shared memory (transposed).
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 64 || N == 128 || N == 256,
                "wgmma_rs: N is 64, 128 or 256");
  if constexpr (N == 256) {
    if constexpr (std::is_same<T, __half>::value) {
      HOPPER_WGMMA_RS_N256("f16");
    } else {
      HOPPER_WGMMA_RS_N256("bf16");
    }
  } else if constexpr (N == 128) {
    if constexpr (std::is_same<T, __half>::value) {
      HOPPER_WGMMA_RS_N128("f16");
    } else {
      HOPPER_WGMMA_RS_N128("bf16");
    }
  } else {
    if constexpr (std::is_same<T, __half>::value) {
      HOPPER_WGMMA_RS_N64("f16");
    } else {
      HOPPER_WGMMA_RS_N64("bf16");
    }
  }
}

#undef HOPPER_WGMMA_SS_N128
#undef HOPPER_WGMMA_SS_N64
#undef HOPPER_WGMMA_RS_N128
#undef HOPPER_WGMMA_RS_N64
#undef HOPPER_WGMMA_SS_S8_N128
#undef HOPPER_WGMMA_SS_S8_N64
#undef HOPPER_WGMMA_RS_N256

// ------------------------------------------------------- host: tensor maps

// A failed encode makes an entry point return this plus the driver's CUresult.
constexpr int kTensorMapError = 1000;

// cuTensorMapEncodeTiled from the driver, through the runtime (which the
// library already links), so the build needs no -lcuda.
inline PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                         12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }();
  return fn;
}

// A tiled map of `rank` dims (innermost first; `strides` in bytes, rank - 1
// of them), read in boxes of `box`, every element stride 1.
inline CUresult encode_tiled(CUtensorMap* map, CUtensorMapDataType type,
                             int rank, const void* base,
                             const cuuint64_t* dims, const cuuint64_t* strides,
                             const cuuint32_t* box,
                             CUtensorMapSwizzle swizzle) {
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encoder()(map, type, rank, const_cast<void*>(base), dims, strides,
                   box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A [B, L, N, D] 16-bit tensor with element strides as dims {D, N, L, B},
// read in boxes of 64 x 1 x rows x 1 (one 128-byte swizzled row per
// position).
inline CUresult encode_bld(CUtensorMap* map, const void* base, bool fp16,
                           int B, int L, int N, int D, long long sb,
                           long long sl, long long sn, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sn * 2, (cuuint64_t)sl * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, (cuuint32_t)rows, 1};
  return encode_tiled(map,
                      fp16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      4, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// A [heads, L] fp32 tensor whose rows start `stride` values apart (a
// multiple of 4: TMA's 16-byte strides), read in boxes of `rows` values of
// one row; positions past L read as zeros.
inline CUresult encode_rows(CUtensorMap* map, const float* base, int heads,
                            int L, long long stride, int rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)L, (cuuint64_t)heads};
  const cuuint64_t strides[1] = {(cuuint64_t)stride * 4};
  const cuuint32_t box[2] = {(cuuint32_t)rows, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace hopper
