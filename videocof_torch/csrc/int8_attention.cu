// Int8 (SageAttention-style) flash attention for Hopper (sm_90a), kernel B4,
// bound to Python through plain C entry points (ctypes).
//
// Replaces the Pallas TPU kernel `videocof_tpu/ops/int8_attention.py::
// _int8_kernel`, the quantization it does in its prologue, and the K mean
// its wrapper takes in XLA. The same
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
// Two kernels. `k_prepass_kernel` replaces the mean the TPU wrapper takes
// outside its kernel (`int8_flash_attention`, `jnp.mean(kt.astype(f32),
// axis=1)` at :130) and the K quantization in `_int8_kernel`'s body
// (:68-71): it takes K's fp32 mean over Lk per (batch, head) (masked keys
// count; the fp32 sum times fp32(1 / Lk)), then centres K on it and
// quantizes it once into int8 [B, N, Lk, D] with fp32 row scales [B, N, Lk]
// (rows `sk_stride` apart, a multiple of 4: the 16-byte strides TMA needs):
// the quantized K is the same for every q tile, so the TPU kernel's
// per-(q block, k block) requantization is done once here.
// - Bound: the bytes of K read once, the int8 K and the scales written once
//   (182.1 + 91.0 + 2.8 MB at the standard edit's self-attention shape,
//   B = 2, Lk = 29,640, 12 heads of 128: 0.0824 ms at 3.35 TB/s).
// - The mean needs all of a slab before any row is centred, and CTAs run in
//   no order, while the chip's shared memory holds about three of the 24
//   slabs of 7.6 MB. So the CTAs, two an SM and all resident (one
//   cooperative launch), take the slabs' chunks in rounds of whole slabs
//   (263 chunks of 113 rows at the self shape: a slab a round; 24 slabs of
//   11 chunks in one round at the cross shape). A CTA copies a chunk into
//   shared memory once, sums its columns, publishes them and counts its
//   arrival on the slab's counter in device memory; one CTA of the slab
//   adds the sums in chunk order and publishes the mean; then each CTA
//   centres and quantizes the rows it holds. There is one launch, and no
//   torch reduction over K precedes it. No K byte is read twice up to the
//   rows the resident CTAs' stages keep (Lk = 33,792 at D = 128, 16,896 at
//   D = 256 on an H100); past that a slab is cut into a chunk a resident
//   CTA, and each chunk reads the rows its stage cannot keep again.
// - Three chunks in flight a CTA hide the copies and the barrier: it issues
//   the copies of chunk i + 2, sums and arrives on chunk i + 1, and
//   quantizes chunk i, whose mean was published a round before.
// - What it leaves: a round waits for the slowest CTA of its slab, and the
//   two CTAs of an SM quantize at the same moment, so the issue slots idle
//   in the waits and are shared in the quantization (42% of the bound at
//   the self shape on an H100). The quantization takes x * RN(1 / scale) and the IEEE quotient
//   only near a tie, the same bytes with fewer instructions.
// - Loads are 16-byte cp.async copies, each thread's into its own slots of
//   shared memory; stores are 8 bytes a lane, a row's 128 or 256 int8
//   values written by neighbouring lanes.
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
// exposed, which weighs at Lk = 512; the K pre-pass is a launch of its own
// before it.

#include <atomic>

#include "hopper_attention.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int kPrepThreads = 256;  // threads of a k_prepass_kernel CTA
constexpr int kPrepBatch = 4;      // rows a thread quantizes at once
// a pre-pass CTA keeps kPrepStages items of at most kPrepStageBytes of K in
// shared memory (two CTAs an SM)
constexpr int kPrepStages = 3;
constexpr int kPrepStageBytes = 32 * 1024;
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

// Eight values' int8 bytes of clip(round-half-even(x / scale), -127, 127),
// packed: by x * rcp with rcp = RN(1 / scale), which is within 3 ulps of
// the IEEE quotient (|x / scale| < 128, an ulp 2^-17), so it rounds to the
// same integer unless it lies within 2^-14 of a half-integer; then the
// IEEE quotients of the eight decide. Adding 1.5 * 2^23 rounds to an
// integer, half to even, whose low byte is the int8; the clip is never
// active, since |x| <= the row's amax makes |x / scale| < 127.5 (for
// finite x). The same bytes as `quant`, with fewer instructions.
__device__ __forceinline__ void quant_row_rcp(const float (&x)[8],
                                              float scale,
                                              uint32_t (&packed)[2]) {
  constexpr float kRound = 12582912.0f;   // 1.5 * 2^23
  const float rcp = __frcp_rn(scale);
  float t[8], worst = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float q = __fmul_rn(x[e], rcp);
    t[e] = __fadd_rn(q, kRound);
    worst = fmaxf(worst, fabsf(__fsub_rn(q, __fsub_rn(t[e], kRound))));
  }
  if (worst > 0.5f - 1.0f / 16384) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      t[e] = __fadd_rn(__fdiv_rn(x[e], scale), kRound);
  }
  uint32_t b[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) b[e] = __float_as_uint(t[e]);
#pragma unroll
  for (int w = 0; w < 2; ++w)
    packed[w] = __byte_perm(__byte_perm(b[4 * w], b[4 * w + 1], 0x0040),
                            __byte_perm(b[4 * w + 2], b[4 * w + 3], 0x0040),
                            0x5410);
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

// ------------------------------------------------------- K pre-pass

struct PrepParams {
  const void* k;        // [B, Lk, N, D] through strides
  int8_t* ki;           // [B, N, Lk, D]
  float* sk;            // [B, N, Lk], rows sk_stride apart
  float* k_mean;        // [B, N, D] fp32, written
  float* partial;       // [B * N, chunks, D] fp32 column sums (chunks > 1)
  unsigned* count;      // [B * N] slab barriers: 0 on entry, left 0
  int N, Lk;
  int chunks, rows;     // chunks a slab, rows a chunk (the last one fewer)
  int items;            // B * N * chunks
  int held;             // rows a thread keeps in a stage of shared memory
  long long sk_stride, k_sb, k_sl, k_sn;
  float recip_lk;       // fp32(1 / Lk)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// 8 consecutive elements of T (16 bytes) as fp32
template <typename T>
__device__ __forceinline__ void unpack8(const uint4 raw, float* x) {
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = Elem<T>::to_float(v[j]);
}

// The geometry of work item w (one chunk of one slab's rows) for a thread:
// thread t owns the 16-byte piece t % (D / 8) of the chunk's rows
// t / (D / 8) + j * kGroups, j < mine.
template <typename T, int D>
struct PrepItem {
  static constexpr int kGroups = kPrepThreads / (D / 8);
  int slab, chunk, mine, warp_rows;
  const T* k;           // this thread's piece of the chunk's first row
  __device__ PrepItem(const PrepParams& p, int w, int group, int piece,
                      int lane) {
    slab = w / p.chunks;
    chunk = w % p.chunks;
    const int n = min(p.rows, p.Lk - chunk * p.rows);
    mine = (n - group + kGroups - 1) / kGroups;
    // rows of the warp's first group: the loop bound of the row shuffles
    warp_rows = (n - (group - lane / (D / 8)) + kGroups - 1) / kGroups;
    k = static_cast<const T*>(p.k) + (slab / p.N) * p.k_sb +
        (slab % p.N) * p.k_sn +
        (long long)(chunk * p.rows + group) * p.k_sl + piece * 8;
  }
  __device__ const uint4* row(const PrepParams& p, int j) const {
    return reinterpret_cast<const uint4*>(k + (long long)j * kGroups * p.k_sl);
  }
};

// One launch per call: each (batch, head) slab of K is read from device
// memory once, its fp32 column sums give the mean, and the rows still in
// shared memory are centred and quantized. Work items are chunks of a
// slab's rows, taken by the CTAs in turn (w = blockIdx.x + i * gridDim.x;
// a slab has at most as many chunks as the grid has CTAs, and the host
// makes the grid a whole number of slabs, so each round takes whole slabs,
// one chunk of a slab a CTA). Each thread copies its pieces of an item's
// rows with cp.async into its own slots of one of kPrepStages stages of
// shared memory, so the rows need no barrier of their own, and the CTA
// runs three items at once: it sums item i + 1 and arrives on its slab,
// issues the copies of item i + 2, then waits for item i's mean and
// quantizes item i. With one chunk a slab the CTA has the whole sum. With
// more, the slab's CTAs write their column sums to `partial` and count
// their arrival on the slab's counter without waiting for it; the slab's
// reducer (`reducer`) waits for every arrival, adds the sums in chunk
// order, writes the mean and counts once more (chunks + 1: ready); the
// others wait for that, then all leave, and the last to leave sets the
// counter back to 0. The reducer publishes at the end of the round in
// which the slab's arrivals were made. The launch is then cooperative,
// every CTA resident: each CTA arrives on round i + 1's slab before it
// waits for round i's mean, so every barrier is reached. A chunk of more
// rows than a stage keeps (`held` a thread: only where Lk outgrows the
// resident CTAs' stages) reads the rest from device memory again. Sums run
// in a fixed order, so
// two calls give the same bits.
template <typename T, int D>
__global__ void __launch_bounds__(kPrepThreads, 2)
k_prepass_kernel(const PrepParams p) {
  using Item = PrepItem<T, D>;
  constexpr int kPieces = D / 8;                  // 16-byte pieces a row
  constexpr int kGroups = Item::kGroups;          // rows in flight a pass
  constexpr int kSlices = kPrepThreads / (D / 4); // chunk slices, last CTA
  constexpr int kWarps = kPrepThreads / 32;
  static_assert(kPieces == 16 || kPieces == 32, "D is 128 or 256");
  extern __shared__ __align__(16) uint4 s_rows[];  // [stage][held][threads]
  // a warp's column sums, or the last CTA's float4 of partial sums
  __shared__ __align__(16) float s_red[kWarps * D > 4 * kPrepThreads
                                           ? kWarps * D : 4 * kPrepThreads];
  __shared__ float s_mean[kPrepStages][D];       // items i .. i + ahead
  const int tid = threadIdx.x, piece = tid % kPieces, group = tid / kPieces;
  const int lane = tid & 31, warp = tid / 32;
  const int n_items = (p.items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  auto item = [&](int i) {
    return Item(p, blockIdx.x + i * gridDim.x, group, piece, lane);
  };
  auto slot = [&](int i, int j) -> uint4& {
    return s_rows[((i % kPrepStages) * p.held + j) * kPrepThreads + tid];
  };
  // row j of item i: from its stage, or again from device memory past held
  auto row = [&](const Item& it, int i, int j) {
    return j < p.held ? slot(i, j) : __ldg(it.row(p, j));
  };

  // issue item i's copies (a group, empty past the last item)
  auto load = [&](int i) {
    if (i < n_items) {
      const Item it = item(i);
      const int held = min(it.mine, p.held);
      for (int j = 0; j < held; ++j) cp_async16(&slot(i, j), it.row(p, j));
    }
    cp_async_commit();
  };

  // item i's column sums (its copies landed): its slab's mean when the
  // slab is one chunk, else published as a partial, and its arrival counted
  auto sum_arrive = [&](int i) {
    const Item it = item(i);
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int j = 0; j < it.mine; ++j) {
      float x[8];
      unpack8<T>(row(it, i, j), x);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = __fadd_rn(acc[e], x[e]);
    }
    // my rows in order, then a warp's two row groups (D = 128), then the
    // warps in order
    if constexpr (kPieces == 16) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[e] = __fadd_rn(acc[e], __shfl_xor_sync(0xffffffffu, acc[e], 16));
    }
    float4* red4 = reinterpret_cast<float4*>(s_red);
    if (lane < kPieces) {
      red4[2 * (warp * kPieces + lane)] =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
      red4[2 * (warp * kPieces + lane) + 1] =
          make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
    __syncthreads();
    float col = 0.f;
    if (tid < D)
      for (int g = 0; g < kWarps; ++g)
        col = __fadd_rn(col, s_red[(g * kPieces + tid / 8) * 8 + tid % 8]);
    float* mean = p.k_mean + (long long)it.slab * D;
    if (p.chunks == 1) {
      if (tid < D)
        s_mean[i % kPrepStages][tid] = mean[tid] = __fmul_rn(col, p.recip_lk);
      __syncthreads();
      return;
    }
    if (tid < D)
      p.partial[((long long)it.slab * p.chunks + it.chunk) * D + tid] = col;
    __syncthreads();
    // arrive, without waiting for the count: the writes above go first
    if (tid == 0) {
      __threadfence();
      atomicAdd(&p.count[it.slab], 1u);
    }
  };

  // the slab's mean from its chunks' column sums, in chunk order within
  // kSlices strided slices, the slices in order (float4 loads from L2)
  // A slab's reducer: chunk slab % chunks (the reducers of successive slabs
  // rotate over the CTAs).
  auto reducer = [&](const Item& it) { return it.chunk == it.slab % p.chunks; };
  // (the reducer) wait for every arrival on item i's slab, then publish its
  // mean (count chunks + 1)
  auto publish_mean = [&](int i) {
    const Item it = item(i);
    unsigned* count = p.count + it.slab;
    if (tid == 0)
      while (ld_acquire(count) < (unsigned)p.chunks) __nanosleep(32);
    __syncthreads();
    const float* part = p.partial + (long long)it.slab * p.chunks * D;
    const int c4 = tid % (D / 4), slice = tid / (D / 4);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int c = slice; c < p.chunks; c += kSlices) {
      const float4 v = __ldcg(
          reinterpret_cast<const float4*>(part + (long long)c * D) + c4);
      a.x = __fadd_rn(a.x, v.x); a.y = __fadd_rn(a.y, v.y);
      a.z = __fadd_rn(a.z, v.z); a.w = __fadd_rn(a.w, v.w);
    }
    reinterpret_cast<float4*>(s_red)[tid] = a;
    __syncthreads();
    if (tid < D) {
      float s = 0.f;
      for (int sl = 0; sl < kSlices; ++sl)
        s = __fadd_rn(s, s_red[sl * D + tid]);
      s_mean[i % kPrepStages][tid] = p.k_mean[(long long)it.slab * D + tid] =
          __fmul_rn(s, p.recip_lk);
    }
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      atomicAdd(count, 1u);
    }
  };

  // wait for item i's mean, leave its slab's barrier, quantize item i
  auto wait_quantize = [&](int i) {
    const Item it = item(i);
    if (p.chunks > 1) {
      unsigned* count = p.count + it.slab;
      if (!reducer(it)) {   // else this CTA published it
        if (tid == 0)
          while (ld_acquire(count) < (unsigned)p.chunks + 1) __nanosleep(32);
        __syncthreads();
        if (tid < D)
          s_mean[i % kPrepStages][tid] =
              __ldcg(p.k_mean + (long long)it.slab * D + tid);
      }
      __syncthreads();
      // leave; the last of the slab's chunks to leave resets its counter
      if (tid == 0 && atomicAdd(count, 1u) == 2u * p.chunks) *count = 0u;
    }
    float mu[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) mu[e] = s_mean[i % kPrepStages][piece * 8 + e];
    int8_t* kio = p.ki + ((long long)it.slab * p.Lk + it.chunk * p.rows) * D +
                  piece * 8;
    float* sko = p.sk + it.slab * p.sk_stride + it.chunk * p.rows;
    // kPrepBatch rows at once: their loads, shuffles and divisions overlap
    for (int j0 = 0; j0 < it.warp_rows; j0 += kPrepBatch) {
      float x[kPrepBatch][8], amax[kPrepBatch];
#pragma unroll
      for (int q = 0; q < kPrepBatch; ++q) {
        amax[q] = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) x[q][e] = 0.f;
        if (j0 + q < it.mine) {
          unpack8<T>(row(it, i, j0 + q), x[q]);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            x[q][e] = __fsub_rn(x[q][e], mu[e]);
            amax[q] = fmaxf(amax[q], fabsf(x[q][e]));
          }
        }
      }
#pragma unroll
      for (int off = kPieces / 2; off > 0; off >>= 1)
#pragma unroll
        for (int q = 0; q < kPrepBatch; ++q)
          amax[q] = fmaxf(amax[q], __shfl_xor_sync(0xffffffffu, amax[q], off));
#pragma unroll
      for (int q = 0; q < kPrepBatch; ++q) {
        if (j0 + q >= it.mine) continue;
        const float scale = quant_scale(amax[q]);
        uint32_t packed[2];
        quant_row_rcp(x[q], scale, packed);
        const int r = group + (j0 + q) * kGroups;   // row within the chunk
        *reinterpret_cast<uint2*>(kio + (long long)r * D) =
            make_uint2(packed[0], packed[1]);
        if (piece == 0) sko[r] = scale;
      }
    }
  };

  // A memory fence waits for the thread's copies in flight, so item i + 2's
  // copies are issued after the fences of item i + 1's arrival; they stay
  // in flight under item i's wait and quantization. A slab's mean is
  // published in the round in which its arrivals were made, a round before
  // it is waited for.
  const bool barrier = p.chunks > 1;
  load(0);
  cp_async_wait<0>();
  if (n_items > 0) {
    sum_arrive(0);
    if (barrier && reducer(item(0))) publish_mean(0);
  }
  load(1);
  for (int i = 0; i < n_items; ++i) {
    cp_async_wait<0>();   // item i + 1's copies landed
    if (i + 1 < n_items) sum_arrive(i + 1);
    load(i + 2);          // into item i - 1's stage, quantized last round
    wait_quantize(i);
    if (barrier && i + 1 < n_items && reducer(item(i + 1)))
      publish_mean(i + 1);
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

constexpr int kMaxDevices = 64;   // devices whose pre-pass limits are cached

// Shared memory of a pre-pass CTA whose stages keep `held` rows a thread
inline size_t prep_smem(int held) {
  return static_cast<size_t>(kPrepStages) * held * kPrepThreads *
         sizeof(uint4);
}

template <typename T, int D>
cudaError_t prep_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      k_prepass_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kPrepStages * kPrepStageBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(k_prepass_kernel<T, D>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// CTAs of the pre-pass resident on the current device at once (full
// stages). The first call on a device sets the kernel's attributes there
// and asks the occupancy calculator; later calls read the cached count.
template <typename T, int D>
cudaError_t prep_resident(int* resident) {
  static std::atomic<int> cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && (*resident = cached[dev].load()) > 0)
    return cudaSuccess;
  if ((err = prep_attributes<T, D>()) != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, k_prepass_kernel<T, D>, kPrepThreads,
      kPrepStages * kPrepStageBytes);
  *resident = per_sm * sms;
  if (err == cudaSuccess && dev < kMaxDevices) cached[dev] = *resident;
  return err;
}

template <typename T, int D>
cudaError_t launch_prep(PrepParams p, int slabs, cudaStream_t stream) {
  constexpr int kGroups = kPrepThreads / (D / 8);
  constexpr int kHeld = kPrepStageBytes / (kPrepThreads * 16);  // a thread
  p.items = slabs * p.chunks;
  const int per_thread = (p.rows + kGroups - 1) / kGroups;
  p.held = per_thread < kHeld ? per_thread : kHeld;
  int resident = 0;
  cudaError_t err = prep_resident<T, D>(&resident);
  if (err != cudaSuccess) return err;
  if (resident <= 0 || p.chunks > resident) return cudaErrorInvalidValue;
  // whole slabs a round: a slab's chunks are taken together and its
  // arrivals made in one round
  const int ctas = resident / p.chunks * p.chunks;
  const dim3 grid(p.items < ctas ? p.items : ctas);
  if (p.chunks == 1) {   // no barrier: any grid will do
    k_prepass_kernel<T, D><<<grid, kPrepThreads, prep_smem(p.held),
                             stream>>>(p);
    return cudaGetLastError();
  }
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(k_prepass_kernel<T, D>), grid,
      dim3(kPrepThreads), args, prep_smem(p.held), stream);
  if (err != cudaSuccess) return err;
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

// The CTAs of the pre-pass resident on the current device at once: its
// grid, and the most chunks a slab may be cut into. Returns a cudaError_t.
extern "C" int int8_prepass_resident(int D, int is_fp16, int* resident) {
  *resident = 0;
  if (D == 128)
    return static_cast<int>(is_fp16 ? prep_resident<__half, 128>(resident)
                            : prep_resident<__nv_bfloat16, 128>(resident));
  if (D == 256)
    return static_cast<int>(is_fp16 ? prep_resident<__half, 256>(resident)
                            : prep_resident<__nv_bfloat16, 256>(resident));
  return static_cast<int>(cudaErrorInvalidValue);
}

// K's fp32 mean over its Lk keys into k_mean [B, N, D], and K centred on
// it and quantized: ki [B, N, Lk, D] int8, sk [B, N, Lk] fp32 with rows
// sk_stride (>= Lk, a multiple of 4) apart. Each slab is cut into `chunks`
// (at most `int8_prepass_resident`) of `rows` rows, the last one not
// empty; partial [B * N * chunks * D] fp32 is scratch and
// count [B * N] must be 0 and is left 0 (both unused for one chunk).
extern "C" int int8_quantize_k(
    const void* k, void* ki, float* sk, float* k_mean, float* partial,
    unsigned* count, int B, int N, int Lk, int D, int is_fp16, int chunks,
    int rows, long long sk_stride, long long k_sb, long long k_sl,
    long long k_sn, float recip_lk, void* stream) {
  if (B <= 0 || N <= 0 || Lk <= 0 || chunks <= 0 || rows <= 0 ||
      (long long)chunks * rows < Lk || (long long)(chunks - 1) * rows >= Lk ||
      (long long)B * N * chunks > 0x7fffffff || sk_stride < Lk ||
      sk_stride % 4 || (chunks > 1 && (partial == nullptr || count == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  PrepParams p;
  p.k = k; p.ki = static_cast<int8_t*>(ki); p.sk = sk; p.k_mean = k_mean;
  p.partial = partial; p.count = count;
  p.N = N; p.Lk = Lk; p.chunks = chunks; p.rows = rows;
  p.sk_stride = sk_stride; p.k_sb = k_sb; p.k_sl = k_sl; p.k_sn = k_sn;
  p.recip_lk = recip_lk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slabs = B * N;
  cudaError_t err;
  if (D == 128)
    err = is_fp16 ? launch_prep<__half, 128>(p, slabs, s)
                  : launch_prep<__nv_bfloat16, 128>(p, slabs, s);
  else if (D == 256)
    err = is_fp16 ? launch_prep<__half, 256>(p, slabs, s)
                  : launch_prep<__nv_bfloat16, 256>(p, slabs, s);
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
