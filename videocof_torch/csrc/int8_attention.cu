// Int8 (SageAttention-style) flash attention for Hopper (sm_90a), kernel B4,
// bound to Python through plain C entry points (ctypes).
//
// Replaces the Pallas TPU kernel `videocof_tpu/ops/int8_attention.py::
// _int8_kernel` and the quantization it does in its prologue. The same
// function: Q and the mean-centred K are quantized to int8 with one scale per
// row (scale = max(amax |x|, 1e-6) * fp32(1/127), the product XLA compiles
// `amax / 127.0` into; q = clip(round-half-even(x / scale), -127, 127), an IEEE
// division as in XLA), S = qi ki^T is an int8 product accumulated in
// s32, the logits are s32 -> fp32 times ((sq * scale * log2 e) * sk) in that
// order, the softmax runs online in fp32 in the exp2 domain, P is rounded to
// v's type before a bf16/fp16 PV product accumulated in fp32, and the output
// is acc / l in v's type. Keys with mask 0 get the logit -1e30. Keys past Lk
// are excluded outright; the TPU wrapper pads Lk to its key block
// (min(512, rup(Lk, 128))) and gives those keys -1e30 too, which matters only
// for a fully masked row (it averages V over the padded length): the caller
// passes the padding as `n_pad` and the epilogue adds n_pad * exp2(-1e30 - m)
// to the row sum, as B1 does.
//
// Two kernels. `quant_k_kernel` centres K on its per-(batch, head) mean (an
// fp32 [B, N, D] input, computed by the caller as the TPU wrapper computes it
// outside its kernel) and quantizes it once into int8 [B, N, Lk, D] with fp32
// row scales [B, N, Lk]: the quantized K is the same for every q tile, so the
// TPU kernel's per-(q block, k block) requantization is done once here.
// `int8_attn_kernel` is B1's structure: one CTA of 4 warps per (64-row q tile,
// head, batch); the CTA quantizes its q tile once into shared memory, each
// warp keeps the int8 A fragments of its 16 rows in registers and walks K/V
// tiles staged in shared memory with cp.async, double-buffered. QK^T runs on
// mma.sync m16n8k32 s8 x s8 -> s32: an int8 row of 32 bytes has the byte
// layout of a bf16 row of 16, so ldmatrix (b16) loads both operands, and K
// stored [key, d] is already the "col" B operand. The s32 accumulator has the
// layout of m16n8k16's fp32 accumulator, so after dequantization and exp2 the
// S fragment becomes PV's A operand in registers, exactly as in B1.
//
// Bound on this card: at the main path's self-attention shape with batched
// CFG (B = 2, L = 29,640, 12 heads, D = 128) the int8 product is 5.4e12 OP
// (2.73 ms at 1,979 TOP/s) and the bf16 product 5.4e12 FLOP (5.46 ms at 989
// TFLOP/s) against 364 MB of q/k/v/o traffic per batch row: bound by
// operations, 8.19 ms. What this simple design leaves on the table: mma.sync
// int8 runs at half the wgmma int8 rate and waits on ldmatrix; the loads are
// issued by the computing warps, with no TMA or producer warp; the softmax of
// one tile does not overlap the next tile's products.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBlockM = 64;          // q rows per CTA
constexpr int kQuantRowsPerWarp = 8; // K rows each warp of quant_k_kernel does
constexpr int kQuantRows = kWarps * kQuantRowsPerWarp;
constexpr float kQuantEps = 1e-6f;
constexpr float kRecip127 = 1.0f / 127.0f;   // rounded to fp32 once

// keys per K/V tile: 64 at D = 128; 32 at D = 256 so that the fp32
// accumulator (D / 2 registers) and the S tile fit in registers together
template <int D>
constexpr int kBlockN = D == 128 ? 64 : 32;

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Byte offset of (row, 16-byte chunk) in an int8 [rows, D] tile whose chunks
// are XOR-swizzled by the row's low three bits (D >= 128: 8 or more chunks).
template <int D>
__device__ __forceinline__ int swz8(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float quant_scale(float amax) {
  return __fmul_rn(fmaxf(amax, kQuantEps), kRecip127);
}

// clip(round-half-even(x / scale), -127, 127), IEEE division as jnp's
__device__ __forceinline__ uint32_t quant(float x, float scale) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(r)) & 0xffu;
}

// Quantize one row of D fp32 values spread over a warp, kPer = D / 32 per
// lane at columns [lane * kPer, lane * kPer + kPer): packs the int8 values
// into kPer / 4 words and returns the row scale.
template <int kPer>
__device__ __forceinline__ float quant_row(const float* x, uint32_t* packed) {
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) amax = fmaxf(amax, fabsf(x[j]));
  const float scale = quant_scale(warp_max(amax));
#pragma unroll
  for (int w = 0; w < kPer / 4; ++w) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) word |= quant(x[4 * w + j], scale) << (8 * j);
    packed[w] = word;
  }
  return scale;
}

// kPer consecutive elements of T (8 or 16 bytes, aligned) as fp32
template <typename T, int kPer>
__device__ __forceinline__ void load_row_part(const T* src, float* x) {
  static_assert(kPer == 4 || kPer == 8, "4 or 8 elements a lane");
  alignas(16) T vals[kPer];
  if constexpr (kPer == 4)
    *reinterpret_cast<uint2*>(vals) = *reinterpret_cast<const uint2*>(src);
  else
    *reinterpret_cast<uint4*>(vals) = *reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int j = 0; j < kPer; ++j) x[j] = Elem<T>::to_float(vals[j]);
}

template <int kPer>
__device__ __forceinline__ void store_packed(void* dst, const uint32_t* w) {
  if constexpr (kPer == 4)
    *reinterpret_cast<uint32_t*>(dst) = w[0];
  else
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
}

// Stage int8 rows [row0, row0 + ROWS) of a contiguous [len, D] matrix into a
// swizzled tile; rows at or past `len` are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_s8(int8_t* tile, const int8_t* base,
                                             int row0, int len, int tid) {
  constexpr int kChunks = D / 16;
  static_assert(ROWS * kChunks % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = row0 + r < len;
    const int8_t* src = valid ? base + (long long)(row0 + r) * D + c * 16
                              : base;
    cp_async_16(tile + swz8<D>(r, c), src, valid);
  }
}

// ------------------------------------------------------------ K quantization

struct QuantParams {
  const void* k;        // [B, Lk, N, D] through strides
  const float* k_mean;  // [B, N, D] fp32
  int8_t* ki;           // [B, N, Lk, D]
  float* sk;            // [B, N, Lk]
  int Lk;
  long long k_sb, k_sl, k_sn;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
quant_k_kernel(const QuantParams p) {
  constexpr int kPer = D / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * gridDim.y + h;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sn;
  float mu[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) mu[j] = p.k_mean[bh * D + lane * kPer + j];
  const int row0 = blockIdx.x * kQuantRows + warp * kQuantRowsPerWarp;
  for (int i = 0; i < kQuantRowsPerWarp; ++i) {
    const int row = row0 + i;
    if (row >= p.Lk) break;   // the same for the whole warp
    float x[kPer];
    load_row_part<T, kPer>(kb + row * p.k_sl + lane * kPer, x);
#pragma unroll
    for (int j = 0; j < kPer; ++j) x[j] -= mu[j];
    uint32_t packed[kPer / 4];
    const float scale = quant_row<kPer>(x, packed);
    store_packed<kPer>(p.ki + (bh * p.Lk + row) * D + lane * kPer, packed);
    if (lane == 0) p.sk[bh * p.Lk + row] = scale;
  }
}

// --------------------------------------------------------------- attention

struct AttnParams {
  const void* q;        // [B, Lq, N, D] through strides
  const int8_t* ki;     // [B, N, Lk, D], from quant_k_kernel
  const float* sk;      // [B, N, Lk]
  const void* v;        // [B, Lk, N, D] through strides
  const uint8_t* mask;  // [B, Lk] bytes or null
  void* o;              // [B, Lq, N, D] through strides, v's type
  int Lq, Lk, n_pad;
  long long q_sb, q_sl, q_sn;
  long long v_sb, v_sl, v_sn;
  long long o_sb, o_sl, o_sn;
  float logit_scale;    // softmax scale * log2(e), rounded to fp32
};

template <typename T, int D>
constexpr int attn_smem_bytes() {
  constexpr int BN = kBlockN<D>;
  return (kBlockM + 2 * BN) * D * static_cast<int>(sizeof(T))  // q, V
         + (kBlockM + 2 * BN) * D                                // qi, ki
         + (2 * BN + kBlockM) * static_cast<int>(sizeof(float)); // sk, sq
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
int8_attn_kernel(const AttnParams p) {
  using E = Elem<T>;
  constexpr int BN = kBlockN<D>;
  constexpr int kPer = D / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);                          // raw q tile
  T* sV = sQ + kBlockM * D;                                    // 2 stages
  int8_t* sQi = reinterpret_cast<int8_t*>(sV + 2 * BN * D);    // int8 q tile
  int8_t* sK = sQi + kBlockM * D;                              // 2 stages
  float* sSk = reinterpret_cast<float*>(sK + 2 * BN * D);      // 2 stages
  float* sSq = sSk + 2 * BN;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * gridDim.y + h;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sn;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sn;
  const int8_t* kib = p.ki + bh * p.Lk * D;
  const float* skb = p.sk + bh * p.Lk;
  const uint8_t* mb = p.mask ? p.mask + (long long)b * p.Lk : nullptr;
  const int n_tiles = (p.Lk + BN - 1) / BN;

  load_tile<T, D, kBlockM>(sQ, qb, q0, p.Lq, p.q_sl, tid);
  cp_async_commit();
  load_tile_s8<D, BN>(sK, kib, 0, p.Lk, tid);
  load_vec<BN>(sSk, skb, 0, p.Lk, tid);
  load_tile<T, D, BN>(sV, vb, 0, p.Lk, p.v_sl, tid);
  cp_async_commit();

  // Quantize the q tile once: each warp its own 16 rows (rows past Lq are
  // zero and quantize to zero), the lanes kPer columns each.
  cp_async_wait<1>();
  __syncthreads();
  for (int i = 0; i < 16; ++i) {
    const int row = warp * 16 + i, col = lane * kPer;
    float x[kPer];
    load_row_part<T, kPer>(sQ + swz<D>(row, col / 8) + col % 8, x);
    uint32_t packed[kPer / 4];
    const float scale = quant_row<kPer>(x, packed);
    store_packed<kPer>(sQi + swz8<D>(row, col / 16) + col % 16, packed);
    if (lane == 0) sSq[row] = scale;
  }
  __syncwarp();   // a warp reads back only its own rows

  // int8 A fragments of this warp's 16 q rows, all of D (32 bytes a step)
  uint32_t qf[D / 32][4];
  {
    const int mi = lane >> 3;
    const int row = warp * 16 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk)
      ldmatrix_x4(qf[kk], sQi + swz8<D>(row, kk * 2 + (mi >> 1)));
  }
  // (sq * scale * log2 e) of the thread's rows lane/4 and lane/4 + 8
  const float row_scale[2] = {
      sSq[warp * 16 + (lane >> 2)] * p.logit_scale,
      sSq[warp * 16 + (lane >> 2) + 8] * p.logit_scale};

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float row_max[2] = {kMaskedLogit, kMaskedLogit};
  float row_sum[2] = {0.f, 0.f};   // this thread's partial sums

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      const int nxt = (t + 1) * BN;
      load_tile_s8<D, BN>(sK + (stage ^ 1) * BN * D, kib, nxt, p.Lk, tid);
      load_vec<BN>(sSk + (stage ^ 1) * BN, skb, nxt, p.Lk, tid);
      load_tile<T, D, BN>(sV + (stage ^ 1) * BN * D, vb, nxt, p.Lk, p.v_sl,
                          tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* cK = sK + stage * BN * D;
    const T* cV = sV + stage * BN * D;
    const float* cSk = sSk + stage * BN;

    // S = qi ki^T for 16 rows x BN keys, s32
    int si[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      si[j][0] = si[j][1] = si[j][2] = si[j][3] = 0;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
#pragma unroll
      for (int jn = 0; jn < BN / 8; jn += 2) {
        uint32_t bf[4];
        const int mi = lane >> 3;
        const int key = (jn + (mi >> 1)) * 8 + (lane & 7);
        ldmatrix_x4(bf, cK + swz8<D>(key, kk * 2 + (mi & 1)));
        mma_s8(si[jn], qf[kk], bf);
        mma_s8(si[jn + 1], qf[kk], bf + 2);
      }
    }

    // dequantize: float(s32) * ((sq * scale * log2 e) * sk), then mask
    const int k0 = t * BN;
    float s[BN / 8][4];
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = jn * 8 + (lane & 3) * 2 + (e & 1);
        s[jn][e] = static_cast<float>(si[jn][e]) *
                   (row_scale[e >> 1] * cSk[col]);
      }
    }
    if (mb != nullptr || k0 + BN > p.Lk) {
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kidx = k0 + jn * 8 + (lane & 3) * 2 + (e & 1);
          if (kidx >= p.Lk)
            s[jn][e] = __uint_as_float(0xff800000u);  // -inf: no weight
          else if (mb != nullptr && mb[kidx] == 0)
            s[jn][e] = kMaskedLogit;
        }
      }
    }

    // online softmax; the thread holds rows lane/4 (r = 0) and lane/4 + 8
    // (r = 1), and the four threads of a quad share a row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = row_max[r];
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn)
        mx = fmaxf(mx, fmaxf(s[jn][2 * r], s[jn][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = fast_exp2(row_max[r] - mx);
      row_max[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn) {
        s[jn][2 * r] = fast_exp2(s[jn][2 * r] - mx);
        s[jn][2 * r + 1] = fast_exp2(s[jn][2 * r + 1] - mx);
        sum += s[jn][2 * r] + s[jn][2 * r + 1];
      }
      row_sum[r] = row_sum[r] * alpha + sum;
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd) {
        acc[jd][2 * r] *= alpha;
        acc[jd][2 * r + 1] *= alpha;
      }
    }

    // acc += P V, with P rounded to v's type
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = E::pack(s[2 * kk][0], s[2 * kk][1]);
      a[1] = E::pack(s[2 * kk][2], s[2 * kk][3]);
      a[2] = E::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = E::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int jd = 0; jd < D / 8; jd += 2) {
        uint32_t bf[4];
        const int mi = lane >> 3;
        const int key = kk * 16 + (mi & 1) * 8 + (lane & 7);
        ldmatrix_x4_trans(bf, cV + swz<D>(key, jd + (mi >> 1)));
        E::mma(acc[jd], a, bf);
        E::mma(acc[jd + 1], a, bf + 2);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sn;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = row_sum[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    // the TPU wrapper's padded keys: 0 unless every real key was masked
    l += p.n_pad * fast_exp2(kMaskedLogit - row_max[r]);
    const int row = q0 + warp * 16 + (lane >> 2) + r * 8;
    if (row >= p.Lq) continue;
    T* orow = ob + (long long)row * p.o_sl;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      const int col = jd * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(orow + col) =
          E::pack(acc[jd][2 * r] / l, acc[jd][2 * r + 1] / l);
    }
  }
}

template <typename T, int D>
cudaError_t launch_quant(const QuantParams& p, int B, int N,
                         cudaStream_t stream) {
  const dim3 grid((p.Lk + kQuantRows - 1) / kQuantRows, N, B);
  quant_k_kernel<T, D><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_attn(const AttnParams& p, int B, int N,
                        cudaStream_t stream) {
  constexpr int smem = attn_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      int8_attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + kBlockM - 1) / kBlockM, N, B);
  int8_attn_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Both entry points return a cudaError_t: 0 when the launch was accepted.
// Strides are in elements; every row must start on a 16-byte boundary (the
// caller checks). D is 128 or 256.

// K centred on k_mean [B, N, D] and quantized: ki [B, N, Lk, D] int8, sk
// [B, N, Lk] fp32.
extern "C" int int8_quantize_k(
    const void* k, const float* k_mean, void* ki, float* sk, int B, int N,
    int Lk, int D, int is_fp16, long long k_sb, long long k_sl,
    long long k_sn, void* stream) {
  if (B <= 0 || N <= 0 || Lk <= 0 || N > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  QuantParams p;
  p.k = k; p.k_mean = k_mean; p.ki = static_cast<int8_t*>(ki); p.sk = sk;
  p.Lk = Lk; p.k_sb = k_sb; p.k_sl = k_sl; p.k_sn = k_sn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 128)
    err = is_fp16 ? launch_quant<__half, 128>(p, B, N, s)
                  : launch_quant<__nv_bfloat16, 128>(p, B, N, s);
  else if (D == 256)
    err = is_fp16 ? launch_quant<__half, 256>(p, B, N, s)
                  : launch_quant<__nv_bfloat16, 256>(p, B, N, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The attention over q and the quantized K of `int8_quantize_k`.
extern "C" int int8_attention_fwd(
    const void* q, const void* ki, const float* sk, const void* v,
    const void* kv_mask, void* o, int B, int N, int Lq, int Lk, int D,
    int is_fp16, int n_pad, long long q_sb, long long q_sl, long long q_sn,
    long long v_sb, long long v_sl, long long v_sn,
    long long o_sb, long long o_sl, long long o_sn, float logit_scale,
    void* stream) {
  if (B <= 0 || N <= 0 || Lq <= 0 || Lk <= 0 || n_pad < 0 || N > 65535 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  AttnParams p;
  p.q = q; p.ki = static_cast<const int8_t*>(ki); p.sk = sk; p.v = v;
  p.mask = static_cast<const uint8_t*>(kv_mask); p.o = o;
  p.Lq = Lq; p.Lk = Lk; p.n_pad = n_pad;
  p.q_sb = q_sb; p.q_sl = q_sl; p.q_sn = q_sn;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sn = v_sn;
  p.o_sb = o_sb; p.o_sl = o_sl; p.o_sn = o_sn;
  p.logit_scale = logit_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 128)
    err = is_fp16 ? launch_attn<__half, 128>(p, B, N, s)
                  : launch_attn<__nv_bfloat16, 128>(p, B, N, s);
  else if (D == 256)
    err = is_fp16 ? launch_attn<__half, 256>(p, B, N, s)
                  : launch_attn<__nv_bfloat16, 256>(p, B, N, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
