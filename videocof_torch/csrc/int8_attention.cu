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
// row scales [B, N, Lk] (rows `sk_stride` apart, a multiple of 4: the
// 16-byte strides TMA needs): the quantized K is the same for every q tile,
// so the TPU kernel's per-(q block, k block) requantization is done once
// here.
//
// `int8_attn_kernel` is the design of B1's forward (`flash_attention_fwd.cu`)
// with an int8 QK^T: one CTA of three warpgroups per (128-row q tile, head,
// batch), warp-specialised.
// - The producer warpgroup drops to 24 registers; one of its threads issues
//   every TMA load: the 16-bit q tile once ({D, N, L, B} map over q's
//   strides), then per K/V tile the int8 K rows (a {D, Lk, B*N} map, 128-byte
//   boxes: one at D = 128, two at D = 256), their fp32 row scales (a {Lk,
//   B*N} map over the pre-pass's padded rows) and the V rows, into a ring
//   of 2 stages with full and empty barriers for K (+ scales) and for V.
// - Two consumer warpgroups (240 registers) own 64 q rows each. Each first
//   quantizes its rows of the TMA-loaded q tile into an int8 tile in shared
//   memory, written where TMA would have put it (16-byte chunk c of row r at
//   chunk c ^ (r % 8)), keeps the row scales times scale * log2 e in
//   registers, and fences the generic proxy's stores against wgmma's reads.
//   Per K/V tile it runs S = Qi Ki^T as wgmma m64nBNk32 s8 x s8 -> s32 with
//   both operands K-major in shared memory, turns the s32 fragment into fp32
//   logits, masks (only the last tile, or every tile when a key mask is
//   given: two loops, so the common one carries no mask code), runs B1's
//   online softmax, packs P to v's type in registers, and runs O += P V as
//   wgmma RS (V MN-major, transposed).
// - Overlap as in B1: tile t's Qi Ki^T is issued with tile t-1's P V, tile
//   t's softmax runs under that P V, and the consumers take turns to issue
//   (ping-pong).
// - The loop is bound by the consumers' instructions (the dequantization
//   and the softmax), not by the tensor cores, so it spends few: I2F for the
//   conversion, no mask code outside the masked loop, no rescale in a warp
//   whose rows all kept their max (alpha is then exactly 1), and one
//   register for the Qi descriptors, which keeps ptxas from spilling.
// - Key tiles: 128 keys at D = 128 (S 64, P 32 and O 64 registers live at
//   once); 64 keys at D = 256, where O alone is 128 registers a thread.
//
// Bound on this card: at the main path's self-attention shape with batched
// CFG (B = 2, L = 29,640, 12 heads, D = 128) the int8 product is 5.4e12 OP
// (2.73 ms at 1,979 TOP/s) and the bf16 product 5.4e12 FLOP (5.46 ms at 989
// TFLOP/s) against 364 MB of q/k/v/o traffic per batch row: bound by
// operations, 8.19 ms. The int8 product reaches its rate only through
// wgmma; TMA and a producer warpgroup take the loads off the computing
// warps; the 128-row q tile halves the K/V traffic per q row against a
// 64-row one; the overlap keeps the tensor cores fed while the
// dequantization and the exponentials run. What it leaves for later: the
// instructions per logit (the conversion, two products, max, subtraction,
// exp2, sum, half a pack and a rescale product against the tensor cores'
// int8 and bf16 work) bound the loop; the CTAs are not persistent, so each
// CTA's prologue (the q tile's load and quantization) and epilogue are
// exposed, which weighs at Lk = 512; the K pre-pass is a separate launch.

#include "hopper_attention.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int kQuantWarps = 4;       // warps of a quant_k_kernel CTA
constexpr int kQuantThreads = kQuantWarps * 32;
constexpr int kQuantRowsPerWarp = 8; // K rows each warp of quant_k_kernel does
constexpr int kQuantRows = kQuantWarps * kQuantRowsPerWarp;
constexpr float kQuantEps = 1e-6f;
constexpr float kRecip127 = 1.0f / 127.0f;   // rounded to fp32 once

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

// ------------------------------------------------------------ K quantization

struct QuantParams {
  const void* k;        // [B, Lk, N, D] through strides
  const float* k_mean;  // [B, N, D] fp32
  int8_t* ki;           // [B, N, Lk, D]
  float* sk;            // [B, N, Lk], rows sk_stride apart
  int Lk;
  long long sk_stride;
  long long k_sb, k_sl, k_sn;
};

template <typename T, int D>
__global__ void __launch_bounds__(kQuantThreads)
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
    if (lane == 0) p.sk[bh * p.sk_stride + row] = scale;
  }
}

// --------------------------------------------------------------- attention

constexpr int kBlockM = 128;   // q rows per CTA

template <int D>
struct Cfg {
  static constexpr int kBlockN = D == 128 ? 128 : 64;  // keys per K/V tile
  static constexpr int kStages = 2;
  static constexpr int kHalves = D / kBoxCols;   // 16-bit boxes across D
  static constexpr int kBoxes8 = D / kBoxBytes;  // int8 boxes across D
  static constexpr uint32_t kQBytes = kBlockM * D * 2;
  static constexpr uint32_t kQiBytes = kBlockM * D;
  static constexpr uint32_t kKBytes = kBlockN * D;
  static constexpr uint32_t kVBytes = kBlockN * D * 2;
  static constexpr uint32_t kSkBytes = kBlockN * 4;
  // q (16-bit), qi (int8), K of each stage, V of each stage, the scales of
  // each stage, then the barriers: q_full, k_full[S], v_full[S],
  // k_empty[S], v_empty[S]; 1024 more to align the base to the swizzle
  // period. Every tile starts on 1024 bytes.
  static constexpr int kQiOffset = kQBytes;
  static constexpr int kKOffset = kQiOffset + kQiBytes;
  static constexpr int kVOffset = kKOffset + kStages * kKBytes;
  static constexpr int kSkOffset = kVOffset + kStages * kVBytes;
  static constexpr int kBarOffset = kSkOffset + kStages * kSkBytes;
  static constexpr int kSmem = kBarOffset + (1 + 4 * kStages) * 8 + 1024;
};

struct AttnParams {
  const uint8_t* mask;  // [B, Lk] bytes or null
  void* o;              // [B, Lq, N, D] through strides, v's type
  int Lq, Lk, n_pad;
  long long o_sb, o_sl, o_sn;
  float logit_scale;    // softmax scale * log2(e), rounded to fp32
};

// Quantizes rows [row0, row0 + 16) of the 16-bit q tile (TMA's swizzled
// [D / 64][128][64]) into the int8 tile ([D / 128][128][128], 128-byte
// swizzle, as TMA would write it), one row at a time over the warp's lanes
// (D / 32 columns a lane). rs gets (sq * logit_scale) of the thread's
// accumulator rows row0 + lane/4 and row0 + lane/4 + 8.
template <typename T, int D>
__device__ __forceinline__ void quantize_q(const T* sQ, int8_t* sQi,
                                           int row0, int lane,
                                           float logit_scale,
                                           float (&rs)[2]) {
  constexpr int kPer = D / 32;
  const int col = lane * kPer;
  const int c16 = col % kBoxCols, c8 = col % kBoxBytes;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int row = row0 + i;
    float x[kPer];
    load_row_part<T, kPer>(sQ + (col / kBoxCols) * kBlockM * kBoxCols +
                               row * kBoxCols +
                               (((c16 / 8) ^ (row & 7)) << 3) + c16 % 8,
                           x);
    uint32_t packed[kPer / 4];
    const float scale = quant_row<kPer>(x, packed);
    store_packed<kPer>(sQi + (col / kBoxBytes) * kBlockM * kBoxBytes +
                           row * kBoxBytes +
                           (((c8 / 16) ^ (row & 7)) << 4) + c8 % 16,
                       packed);
    if ((lane >> 2) == i) rs[0] = scale * logit_scale;
    if ((lane >> 2) + 8 == i) rs[1] = scale * logit_scale;
  }
}

// S = Qi Ki^T for the warpgroup's 64 rows x BN keys in s32, issued, not
// waited for: per k32 slice kk, box kk / 4 at byte kk % 4 * 32 of each row.
// qd is the low word of the warpgroup's Qi descriptor: one register, where
// the slices' descriptors kept across the loop would take two each.
template <int D, int BN>
__device__ __forceinline__ void issue_qk(uint32_t (&s)[BN / 2], uint32_t qd,
                                         const int8_t* k) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    const int qoff = (kk / 4) * kBlockM * kBoxBytes + (kk % 4) * 32;
    const int koff = (kk / 4) * BN * kBoxBytes + (kk % 4) * 32;
    wgmma_ss_s8<BN>(s, sw128_desc_from_lo(qd + qoff / 16, 1024),
                    sw128_desc(k + koff, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// The logits of one tile: float(s32) * (rs[row] * sk[key]), in that order
// (float(s32) is exact: |s32| <= 127^2 * D < 2^24).
template <int BN>
__device__ __forceinline__ void dequant(float (&s)[BN / 2],
                                        const uint32_t (&si)[BN / 2],
                                        const float (&rs)[2], const float* sk,
                                        int lane) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float2 k2 =
        *reinterpret_cast<const float2*>(sk + j * 8 + (lane & 3) * 2);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * j + e] = __int2float_rn(static_cast<int>(si[4 * j + e])) *
                     (rs[e >> 1] * ((e & 1) ? k2.y : k2.x));
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreadsWs, 1)
int8_attn_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_sk,
                 const __grid_constant__ CUtensorMap tm_v,
                 const AttnParams p) {
  using C = Cfg<D>;
  using E = Elem<T>;
  constexpr int BN = C::kBlockN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  T* sQ = reinterpret_cast<T*>(smem);          // [halves][128 rows][64]
  int8_t* sQi = reinterpret_cast<int8_t*>(smem + C::kQiOffset);
  int8_t* sK = reinterpret_cast<int8_t*>(smem + C::kKOffset);
  T* sV = reinterpret_cast<T*>(smem + C::kVOffset);
  float* sSk = reinterpret_cast<float*>(smem + C::kSkOffset);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + C::kStages;
  uint64_t* k_empty = v_full + C::kStages;
  uint64_t* v_empty = k_empty + C::kStages;

  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * gridDim.y + h;
  const int n_tiles = (p.Lk + BN - 1) / BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], kConsumerThreads);
      mbar_init(&v_empty[s], kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_sk);
      prefetch_tensormap(&tm_v);
      mbar_arrive_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int hf = 0; hf < C::kHalves; ++hf)
        tma_load_4d(sQ + hf * kBlockM * kBoxCols, &tm_q, q_full,
                    hf * kBoxCols, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % C::kStages;
        // both consumers are done with the stage's last use
        const uint32_t freed = ((t / C::kStages) & 1) ^ 1;
        if (t >= C::kStages) mbar_wait(&k_empty[s], freed);
        mbar_arrive_expect_tx(&k_full[s], C::kKBytes + C::kSkBytes);
#pragma unroll
        for (int bx = 0; bx < C::kBoxes8; ++bx)
          tma_load_3d(sK + s * C::kKBytes + bx * BN * kBoxBytes, &tm_k,
                      &k_full[s], bx * kBoxBytes, t * BN, bh);
        tma_load_2d(sSk + s * BN, &tm_sk, &k_full[s], t * BN, bh);
        if (t >= C::kStages) mbar_wait(&v_empty[s], freed);
        mbar_arrive_expect_tx(&v_full[s], C::kVBytes);
#pragma unroll
        for (int hf = 0; hf < C::kHalves; ++hf)
          tma_load_4d(sV + s * BN * D + hf * BN * kBoxCols, &tm_v,
                      &v_full[s], hf * kBoxCols, h, t * BN, b);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;                       // which 64 rows of the tile
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const uint8_t* mb = p.mask ? p.mask + (long long)b * p.Lk : nullptr;
    if (c == 1) turn_pass(1);                   // consumer 0 goes first

    // the warp quantizes the 16 rows it holds in the accumulators
    mbar_wait(q_full, 0);
    float rs[2];
    quantize_q<T, D>(sQ, sQi, c * kWgRows + warp * 16, lane, p.logit_scale,
                     rs);
    fence_proxy_async();                 // generic writes -> wgmma reads
    named_barrier_sync(1 + c, 128);
    const uint32_t qd = sw128_desc_lo(sQi + c * kWgRows * kBoxBytes, 16);

    uint32_t si[BN / 2];                 // S fragment in s32, 64 x BN keys
    float s[BN / 2];                     // the logits, then P
    float acc[D / 2];                    // O fragment, 64 x D
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float row_max[2] = {kMaskedLogit, kMaskedLogit};
    float row_sum[2] = {0.f, 0.f};       // this thread's partial sums
    float alpha[2];
    uint32_t pf[BN / 16][4];             // P of the tile before, packed

    // Tile t's S = Qi Ki^T is issued together with tile t-1's O += P V
    // (acc takes tile t-1's alpha between the two issues); the softmax of
    // tile t runs while P V is still in flight. A stage's K and scales are
    // released once the logits are formed.
    mbar_wait(&k_full[0], 0);
    turn_wait(c);
    issue_qk<D, BN>(si, qd, sK);
    turn_pass(c);
    wgmma_wait<0>();
    fence_regs(si);
    dequant<BN>(s, si, rs, sSk, lane);
    mbar_arrive(&k_empty[0]);
    mask_tile<BN>(s, 0, p.Lk, mb, lane);
    softmax_tile<BN>(s, row_max, row_sum, alpha);
    pack_p<T, BN>(pf, s);
    auto step = [&](int t, auto masked) {
      const int st = t % C::kStages, sp = (t - 1) % C::kStages;
      uint32_t qd_t = qd;
      asm volatile("" : "+r"(qd_t));     // the slices' sums stay in the loop
      mbar_wait(&k_full[st], (t / C::kStages) & 1);
      turn_wait(c);
      issue_qk<D, BN>(si, qd_t, sK + st * C::kKBytes);
      // alpha is 1 in a row whose max held; multiplying by 1 is exact, so
      // a warp whose rows all held skips the rescale
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))
        rescale<D>(acc, alpha);
      mbar_wait(&v_full[sp], ((t - 1) / C::kStages) & 1);
      issue_pv<T, D, BN>(acc, pf, sV + sp * BN * D);
      turn_pass(c);
      wgmma_wait<1>();                   // S of tile t
      fence_regs(si);
      dequant<BN>(s, si, rs, sSk + st * BN, lane);
      mbar_arrive(&k_empty[st]);
      if constexpr (decltype(masked)::value)
        mask_tile<BN>(s, t * BN, p.Lk, mb, lane);
      softmax_tile<BN>(s, row_max, row_sum, alpha);
      wgmma_wait<0>();                   // P V of tile t-1
      fence_regs(acc);
      mbar_arrive(&v_empty[sp]);
      pack_p<T, BN>(pf, s);
    };
    // the tiles before the last need no mask unless a key mask is given
    const int n_plain = mb != nullptr ? 1 : n_tiles - 1;
    int t = 1;
    for (; t < n_plain; ++t) step(t, std::false_type{});
    for (; t < n_tiles; ++t) step(t, std::true_type{});
    {
      const int sp = (n_tiles - 1) % C::kStages;
      rescale<D>(acc, alpha);
      mbar_wait(&v_full[sp], ((n_tiles - 1) / C::kStages) & 1);
      turn_wait(c);
      issue_pv<T, D, BN>(acc, pf, sV + sp * BN * D);
      if (c == 0) turn_pass(0);          // consumer 1 takes the last turn
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&v_empty[sp]);
    }

    T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sn;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = row_sum[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      // the TPU wrapper's padded keys: 0 unless every real key was masked
      l += p.n_pad * fast_exp2(kMaskedLogit - row_max[r]);
      const int row = q0 + c * kWgRows + warp * 16 + (lane >> 2) + r * 8;
      if (row >= p.Lq) continue;
      T* orow = ob + (long long)row * p.o_sl;
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd) {
        const int col = jd * 8 + (lane & 3) * 2;
        *reinterpret_cast<uint32_t*>(orow + col) =
            E::pack(acc[4 * jd + 2 * r] / l, acc[4 * jd + 2 * r + 1] / l);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch_quant(const QuantParams& p, int B, int N,
                         cudaStream_t stream) {
  const dim3 grid((p.Lk + kQuantRows - 1) / kQuantRows, N, B);
  quant_k_kernel<T, D><<<grid, kQuantThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_attn(const CUtensorMap* maps, const AttnParams& p, int B,
                        int N, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      int8_attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<D>::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + kBlockM - 1) / kBlockM, N, B);
  int8_attn_kernel<T, D><<<grid, kThreadsWs, Cfg<D>::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

// The tensor map of the quantized K ({D, Lk, B*N} int8, 128-byte swizzled
// boxes of 128 columns by `rows` keys); its row scales take `encode_rows`.
CUresult encode_ki(CUtensorMap* map, const void* ki, int heads, int Lk,
                   int D, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)Lk,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D, (cuuint64_t)Lk * D};
  const cuuint32_t box[3] = {kBoxBytes, (cuuint32_t)rows, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, ki, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// `int8_quantize_k` returns a cudaError_t: 0 when the launch was accepted.
// `int8_attention_fwd` returns 0, a cudaError_t when the launch was refused,
// or 1000 + the driver's CUresult when a tensor map could not be encoded.
// Strides are in elements; every stride but D's must be a multiple of 8
// elements and every base 16-byte aligned (the caller checks). D is 128 or
// 256.

// K centred on k_mean [B, N, D] and quantized: ki [B, N, Lk, D] int8, sk
// [B, N, Lk] fp32 with rows sk_stride (>= Lk, a multiple of 4) apart.
extern "C" int int8_quantize_k(
    const void* k, const float* k_mean, void* ki, float* sk, int B, int N,
    int Lk, int D, int is_fp16, long long sk_stride, long long k_sb,
    long long k_sl, long long k_sn, void* stream) {
  if (B <= 0 || N <= 0 || Lk <= 0 || N > 65535 || B > 65535 ||
      sk_stride < Lk || sk_stride % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  QuantParams p;
  p.k = k; p.k_mean = k_mean; p.ki = static_cast<int8_t*>(ki); p.sk = sk;
  p.Lk = Lk; p.sk_stride = sk_stride;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sn = k_sn;
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

// The attention over q and the quantized K of `int8_quantize_k` (ki
// contiguous, sk rows sk_stride apart).
extern "C" int int8_attention_fwd(
    const void* q, const void* ki, const float* sk, const void* v,
    const void* kv_mask, void* o, int B, int N, int Lq, int Lk, int D,
    int is_fp16, int n_pad, long long sk_stride,
    long long q_sb, long long q_sl, long long q_sn,
    long long v_sb, long long v_sl, long long v_sn,
    long long o_sb, long long o_sl, long long o_sn, float logit_scale,
    void* stream) {
  if (B <= 0 || N <= 0 || Lq <= 0 || Lk <= 0 || n_pad < 0 || N > 65535 ||
      B > 65535 || sk_stride < Lk || sk_stride % 4 || (D != 128 && D != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  if (encoder() == nullptr)
    return kTensorMapError + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const bool fp16 = is_fp16 != 0;
  const int BN = D == 128 ? Cfg<128>::kBlockN : Cfg<256>::kBlockN;
  CUtensorMap maps[4];
  const CUresult enc[4] = {
      encode_bld(&maps[0], q, fp16, B, Lq, N, D, q_sb, q_sl, q_sn, kBlockM),
      encode_ki(&maps[1], ki, B * N, Lk, D, BN),
      encode_rows(&maps[2], sk, B * N, Lk, sk_stride, BN),
      encode_bld(&maps[3], v, fp16, B, Lk, N, D, v_sb, v_sl, v_sn, BN)};
  for (CUresult r : enc)
    if (r != CUDA_SUCCESS) return kTensorMapError + static_cast<int>(r);
  AttnParams p;
  p.mask = static_cast<const uint8_t*>(kv_mask); p.o = o;
  p.Lq = Lq; p.Lk = Lk; p.n_pad = n_pad;
  p.o_sb = o_sb; p.o_sl = o_sl; p.o_sn = o_sn;
  p.logit_scale = logit_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 128)
    err = fp16 ? launch_attn<__half, 128>(maps, p, B, N, s)
               : launch_attn<__nv_bfloat16, 128>(maps, p, B, N, s);
  else
    err = fp16 ? launch_attn<__half, 256>(maps, p, B, N, s)
               : launch_attn<__nv_bfloat16, 256>(maps, p, B, N, s);
  return static_cast<int>(err);
}
