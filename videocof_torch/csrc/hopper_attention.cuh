// The consumer side of a warp-specialised attention forward for Hopper
// (sm_90a), shared by the flash forward (`flash_attention_fwd.cu`, B1/B2) and
// the int8 forward (`int8_attention.cu`, B4). Both run a CTA of three
// warpgroups: one producer that issues TMA loads, two consumers of 64 q rows
// each. What a consumer does with the fp32 fragment of one 64 x BN tile of
// logits (the accumulator layout of hopper_common.cuh): mask it, run the
// exp2 online softmax on it, rescale the O accumulator, pack P to 16 bits as
// P V's A operand in registers, issue O += P V, and take turns with the other
// consumer (ping-pong). The backward (`flash_attention_bwd.cu`, B3) runs the
// same three warpgroups and takes the constants, `pack_p` and `issue_pv`
// (for dV += P^T dO and dK += dS^T Q).

#pragma once

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace hopper {

constexpr int kWgRows = 64;           // q rows per consumer warpgroup
constexpr int kThreadsWs = 384;       // producer + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// acc += P V for BN keys, P from registers, V a [D / 64][BN][64] tile of
// 128-byte-swizzled halves (MN-major); issued, not waited for.
template <typename T, int D, int BN>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         uint32_t (&pf)[BN / 16][4],
                                         const T* v) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) fence_regs(pf[kk]);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs<T, D>(acc, pf[kk],
                   sw128_desc(v + kk * 16 * kBoxCols, BN * kBoxCols * 2,
                              1024),
                   1);
  wgmma_commit();
}

// Keys past Lk get -inf (no weight), keys with mask 0 the logit -1e30.
template <int BN>
__device__ __forceinline__ void mask_tile(float (&s)[BN / 2], int k0, int Lk,
                                          const uint8_t* mb, int lane) {
  if (mb == nullptr && k0 + BN <= Lk) return;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kidx = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
      if (kidx >= Lk)
        s[4 * j + e] = __uint_as_float(0xff800000u);
      else if (mb != nullptr && mb[kidx] == 0)
        s[4 * j + e] = flash::kMaskedLogit;
    }
  }
}

// Online softmax of one tile, in place: s becomes exp2(s - m); the running
// max and sum move on, and alpha is the factor the accumulator takes before
// this tile's P V. The thread holds rows lane/4 (r = 0) and lane/4 + 8
// (r = 1) of its warp's 16; the four threads of a quad share a row.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2],
                                             float (&row_max)[2],
                                             float (&row_sum)[2],
                                             float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = row_max[r];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[r] = flash::fast_exp2(row_max[r] - mx);
    row_max[r] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s[4 * j + 2 * r] = flash::fast_exp2(s[4 * j + 2 * r] - mx);
      s[4 * j + 2 * r + 1] = flash::fast_exp2(s[4 * j + 2 * r + 1] - mx);
      sum += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
    }
    row_sum[r] = row_sum[r] * alpha[r] + sum;
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * jd + e] *= alpha[e >> 1];
  }
}

// P rounded to the input type, as P V's A operand: keys 16kk..16kk+15 are
// the accumulator's 8-column tiles 2kk and 2kk + 1.
template <typename T, int BN>
__device__ __forceinline__ void pack_p(uint32_t (&pf)[BN / 16][4],
                                       const float (&s)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pf[kk][i] = flash::Elem<T>::pack(s[8 * kk + 2 * i],
                                       s[8 * kk + 2 * i + 1]);
  }
}

// The two consumers take turns to issue their products (named barriers 3
// and 4 over both warpgroups): one's softmax runs under the other's
// products. Consumer 1 passes first so consumer 0 goes first; consumer 0
// passes after its last products, and consumer 1 does not, so no arrival
// outlives the CTA.
__device__ __forceinline__ void turn_wait(int c) {
  named_barrier_sync(3 + c, kConsumerThreads);
}

__device__ __forceinline__ void turn_pass(int c) {
  named_barrier_arrive(3 + (c ^ 1), kConsumerThreads);
}

}  // namespace hopper
