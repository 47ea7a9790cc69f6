// Flash-attention backward for Hopper (sm_90a): one warp-specialised kernel,
// bound to Python through a plain C entry point (ctypes).
//
// Replaces both Pallas TPU kernels of `videocof_tpu/ops/flash_attention.py::
// _flash_bwd_bnld`: `_bwd_dq_kernel` (kernel B3a) and `_bwd_dkv_kernel`
// (kernel B3b), which recompute the logits twice, once per kernel. The same
// function: with q already scaled (the training wrapper folds the softmax
// scale into q and runs the core at scale 1), S = q K^T * scale in the
// natural domain, P = exp(S - lse) against the forward's LSE, dP = dO V^T,
// dS = P * (dP - delta) * scale with delta = rowsum(dO * O) (computed by the
// caller, as the TPU wrapper computes it outside its kernels), and
//   dQ = dS K,  dV = P^T dO,  dK = dS^T Q.
// Keys past Lk and q rows past Lq contribute nothing. No key mask: the masked
// path's backward recomputes through plain attention (`_flash_core_masked_bwd`
// has no Pallas kernel either).
//
// Rounding. The TPU kernels run all five products in fp32 on fp32-upcast
// inputs. Here S and dP come from the tensor cores on the bf16/fp16 inputs
// with fp32 accumulation, which is exact in the products as there; P and dS
// are rounded to the input type to feed the tensor cores for dV, dK and dQ,
// as FlashAttention does. That rounding is the one difference from the TPU
// arithmetic (about 2.6e-3 relative L2 on dq, dk and dv in bf16, 3e-4 in
// fp16); the plain backward's `rounded=True` repeats it exactly. fp32
// products (split bf16 or TF32 operands for 3 of the 5 products) would cost
// 1.6x the tensor-core time.
//
// Layouts. q, k, v and dO are read in their [B, L, N, D] layout through TMA
// tensor maps over the strides they come with; lse and delta are [B, N, Lq]
// fp32 with rows 16 bytes apart (the wrapper pads them when Lq % 4 != 0);
// dk and dv are written in [B, Lk, N, D] in the input type; dQ is added into
// an fp32 [B, Lq, N, D] accumulator that the caller zeroes and casts.
//
// Design: one CTA of three warpgroups per (128-key tile, head, batch): the
// TPU grid's sequential q axis becomes a loop inside the CTA, so dK and dV
// stay in registers over all q rows and are stored once, with no atomics.
// - The producer warpgroup drops to 24 registers (setmaxnreg); one of its
//   threads issues every TMA load: the CTA's K and V tiles once, then per
//   64-row q tile the Q and dO tiles and that tile's lse and delta into a
//   ring of 2 stages with a full and an empty barrier each.
// - Two consumer warpgroups (240 registers) own 64 keys each. Per q tile
//   each runs S^T = K Q^T and dP^T = V dO^T as wgmma SS m64n64k16 (K, Q, V
//   and dO all K-major), forms P^T and dS^T on the fp32 fragments (lse and
//   delta indexed by the fragment's columns), packs both to the input type
//   in registers, and runs dV += P^T dO and dK += dS^T Q as wgmma RS with
//   dO and Q MN-major (the transpose bit, as V in the forward's P V).
// - dQ: each consumer writes its dS^T into a 128-byte-swizzled [128 keys]
//   [64 q] tile (two buffers, alternating by q tile), fences it against
//   wgmma's async-proxy reads and meets the other consumer at a named
//   barrier; then dQ = dS K runs as wgmma SS with dS read MN-major (A's
//   transpose bit) and K MN-major. At D = 128 the consumers split dQ's
//   columns (each all 128 keys, one 64-column half of K); at D = 64 each
//   takes its own 64 keys and all columns, so no barrier across them is
//   needed there. The fp32 partial goes through a swizzled staging tile in
//   shared memory, and one thread adds it into the accumulator with two TMA
//   reduce-adds (`cp.reduce.async.bulk.tensor ... add.f32`), which cost the
//   consumers no instructions per element.
// - Determinism: dk and dv are bitwise reproducible; dq is not, since the
//   key tiles' reduce-adds land in no fixed order: after the cast it stays
//   within one ulp of its type where a value is not far below dq's largest,
//   and smaller values carry the fp32 sums' order through the cast.
//
// Bound on this card at the main-path self-attention shape (L = 29,640, 12
// heads, D = 128): 5 products of L^2 * D per head, 10 * L^2 * D * N = 1.35e13
// FLOP (13.64 ms at 989 TFLOP/s dense bf16) against well under 1 GB of
// inputs and outputs: bound by tensor-core operations. Computing S and dP
// once for all three gradients is what brings the work from B3a + B3b's 14
// L^2 * D products to 10. Within a consumer a q tile's steps run one after
// the other; two overlaps were tried and did not pay: P's exponentials under
// dP^T's products measured the same, and S^T of the next tile issued before
// dQ's staging left an accumulator in flight across the loop's back edge,
// which makes ptxas serialize the wgmmas (its C7515 note) or spill. What it
// leaves for later: the two consumers run in step (dS is shared each tile),
// so neither's elementwise work hides under the other's products; the CTAs
// are not persistent; at the cross shape (Lk = 512) there are only 4 key
// tiles per head, 48 CTAs for 132 SMs, each walking all q rows (splitting
// the q range over CTAs needs dK/dV reductions too).

#include "hopper_attention.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int kBlockN = 128;    // keys per CTA, 64 per consumer
constexpr int kBlockQ = 64;     // q rows per tile of the q loop
constexpr int kStages = 2;      // Q/dO tiles in flight
constexpr int kDqBoxCols = 32;  // fp32 columns of a dQ TMA box (128 bytes)
// the leading byte offset of an MN-major operand 64 elements wide: the
// instruction reads one 64-element block, so it is never applied
constexpr uint32_t kMnLbo = kBlockN * kBoxCols * 2;

template <int D>
struct Cfg {
  static constexpr int kHalves = D / kBoxCols;   // TMA boxes across D
  static constexpr uint32_t kKVBytes = kBlockN * D * 2;
  static constexpr uint32_t kQBytes = kBlockQ * D * 2;
  static constexpr uint32_t kVecBytes = kBlockQ * 4;
  static constexpr int kDsBytes = kBlockN * kBlockQ * 2;
  static constexpr int kDqBytes = kBlockQ * kWgRows * 4;   // per consumer
  // K, V, the Q and dO stages, two dS tiles, the consumers' dQ staging
  // tiles, the lse and delta stages, then the barriers: kv_full,
  // q_full[S], q_empty[S]; 1024 more to align the base to the swizzle
  // period. Every tile starts on 1024 bytes.
  static constexpr int kVOffset = kKVBytes;
  static constexpr int kQOffset = 2 * kKVBytes;
  static constexpr int kDoOffset = kQOffset + kStages * kQBytes;
  static constexpr int kDsOffset = kDoOffset + kStages * kQBytes;
  static constexpr int kDqOffset = kDsOffset + 2 * kDsBytes;
  static constexpr int kLseOffset = kDqOffset + 2 * kDqBytes;
  static constexpr int kDeltaOffset = kLseOffset + kStages * kVecBytes;
  static constexpr int kBarOffset = kDeltaOffset + kStages * kVecBytes;
  static constexpr int kSmem = kBarOffset + (1 + 2 * kStages) * 8 + 1024;
};

struct Params {
  void* dk;
  void* dv;
  int Lq, Lk;
  long long dk_sb, dk_sl, dk_sn;
  long long dv_sb, dv_sl, dv_sn;
  float scale;
};

// S^T = K Q^T and dP^T = V dO^T for the warpgroup's 64 keys x 64 q rows, all
// four operands K-major ([halves][rows][64] tiles); one group, issued, not
// waited for.
template <typename T, int D>
__device__ __forceinline__ void issue_sdp(float (&s)[kBlockQ / 2],
                                          float (&dp)[kBlockQ / 2],
                                          const T* k, const T* v,
                                          const T* q, const T* dout) {
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int koff = (kk / 4) * kBlockN * kBoxCols + (kk % 4) * 16;
    const int qoff = (kk / 4) * kBlockQ * kBoxCols + (kk % 4) * 16;
    wgmma_ss_m64n64k16<T, 0, 0>(s, sw128_desc(k + koff, 16, 1024),
                                sw128_desc(q + qoff, 16, 1024), kk > 0);
    wgmma_ss_m64n64k16<T, 0, 0>(dp, sw128_desc(v + koff, 16, 1024),
                                sw128_desc(dout + qoff, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// P^T = exp2(S^T * scale * log2 e - lse * log2 e) into s and dS^T = P^T *
// (dP^T - delta) * scale into dp, the arithmetic of the TPU kernels in the
// exp2 domain; lse and delta of the q tile in shared memory, indexed by the
// fragment's columns. kMasked zeroes the rows of keys past Lk: their K rows
// are TMA's zeros, which give dQ nothing, but exp2(-lse) alone could
// overflow.
template <bool kMasked>
__device__ __forceinline__ void form_p_ds(float (&s)[kBlockQ / 2],
                                          float (&dp)[kBlockQ / 2],
                                          const float* lse,
                                          const float* delta, float scale,
                                          const bool (&key_ok)[2], int lane) {
  const float scale2 = scale * kLog2e;
#pragma unroll
  for (int j = 0; j < kBlockQ / 8; ++j) {
    const float2 l2 =
        *reinterpret_cast<const float2*>(lse + 8 * j + 2 * (lane & 3));
    const float2 d2 =
        *reinterpret_cast<const float2*>(delta + 8 * j + 2 * (lane & 3));
    const float lse2[2] = {l2.x * kLog2e, l2.y * kLog2e};
    const float dl[2] = {d2.x, d2.y};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * r + e;
        float pv = fast_exp2(s[i] * scale2 - lse2[e]);
        if constexpr (kMasked) pv = key_ok[r] ? pv : 0.f;
        s[i] = pv;
        dp[i] = pv * (dp[i] - dl[e]) * scale;
      }
    }
  }
}

// The packed dS^T fragments of a warp's 16 keys (rows row0 and row0 + 8 of
// this thread) into the [128 keys][64 q] tile, 128-byte swizzled as TMA
// would write it (16-byte chunk c of row r at chunk c ^ r % 8).
template <typename T>
__device__ __forceinline__ void store_ds(T* ds,
                                         const uint32_t (&f)[kBlockQ / 16][4],
                                         int row0, int lane) {
#pragma unroll
  for (int kk = 0; kk < kBlockQ / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + (i & 1) * 8;
      const int col = kk * 16 + (i >> 1) * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(
          ds + row * kBoxCols + (((col >> 3) ^ (row & 7)) << 3) +
          (col & 7)) = f[kk][i];
    }
  }
}

// dQ (64 q rows x 64 columns, fp32) = dS K over the keys this warpgroup
// takes: at D = 128 all 128 of the CTA's keys and column half c of K, at
// D = 64 its own 64 keys and all of K's columns. dS is the [128 keys][64 q]
// tile (q contiguous: A MN-major), K the [halves][128 keys][64] tile (D
// contiguous: B MN-major); issued, not waited for.
template <typename T, int D>
__device__ __forceinline__ void issue_dq(float (&dq)[kWgRows / 2],
                                         const T* ds, const T* k, int c) {
  constexpr int kKeys = D == 128 ? kBlockN : kWgRows;
  const T* a = ds + (D == 128 ? 0 : c * kWgRows * kBoxCols);
  const T* bk = k + (D == 128 ? c * kBlockN : c * kWgRows) * kBoxCols;
  fence_regs(dq);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
    wgmma_ss_m64n64k16<T, 1, 1>(
        dq, sw128_desc(a + kk * 16 * kBoxCols, kMnLbo, 1024),
        sw128_desc(bk + kk * 16 * kBoxCols, kMnLbo, 1024), kk > 0);
  wgmma_commit();
}

// The dQ fragment (64 q rows x 64 columns) into two [64 rows][32 columns]
// fp32 boxes, 128-byte swizzled as the dQ tensor map reads them.
__device__ __forceinline__ void stage_dq(float* box,
                                         const float (&dq)[kWgRows / 2],
                                         int warp, int lane) {
#pragma unroll
  for (int j = 0; j < kWgRows / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + (lane >> 2) + r * 8;
      const int col = (8 * j + 2 * (lane & 3)) % kDqBoxCols;
      *reinterpret_cast<float2*>(
          box + (j * 8 / kDqBoxCols) * kBlockQ * kDqBoxCols +
          row * kDqBoxCols + (((col >> 2) ^ (row & 7)) << 2) + (col & 3)) =
          make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreadsWs, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_lse,
                 const __grid_constant__ CUtensorMap tm_delta,
                 const __grid_constant__ CUtensorMap tm_dq, const Params p) {
  using C = Cfg<D>;
  using E = Elem<T>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  T* sK = reinterpret_cast<T*>(smem);                  // [halves][128][64]
  T* sV = reinterpret_cast<T*>(smem + C::kVOffset);    // the same
  T* sQ = reinterpret_cast<T*>(smem + C::kQOffset);    // [S][halves][64][64]
  T* sdO = reinterpret_cast<T*>(smem + C::kDoOffset);  // the same
  T* sdS = reinterpret_cast<T*>(smem + C::kDsOffset);  // [2][128 keys][64]
  float* sdQ = reinterpret_cast<float*>(smem + C::kDqOffset);  // [2][2][64][32]
  float* sLse = reinterpret_cast<float*>(smem + C::kLseOffset);     // [S][64]
  float* sDelta = reinterpret_cast<float*>(smem + C::kDeltaOffset); // [S][64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* q_full = kv_full + 1;
  uint64_t* q_empty = q_full + kStages;

  const int k0 = blockIdx.x * kBlockN;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (p.Lq + kBlockQ - 1) / kBlockQ;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&q_empty[s], kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      const int bh = b * gridDim.y + h;
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      prefetch_tensormap(&tm_do);
      prefetch_tensormap(&tm_lse);
      prefetch_tensormap(&tm_delta);
      mbar_arrive_expect_tx(kv_full, 2 * C::kKVBytes);
#pragma unroll
      for (int hf = 0; hf < C::kHalves; ++hf) {
        tma_load_4d(sK + hf * kBlockN * kBoxCols, &tm_k, kv_full,
                    hf * kBoxCols, h, k0, b);
        tma_load_4d(sV + hf * kBlockN * kBoxCols, &tm_v, kv_full,
                    hf * kBoxCols, h, k0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        // both consumers are done with the stage's last use
        if (t >= kStages) mbar_wait(&q_empty[s], ((t / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&q_full[s], 2 * C::kQBytes + 2 * C::kVecBytes);
#pragma unroll
        for (int hf = 0; hf < C::kHalves; ++hf) {
          const int off = s * kBlockQ * D + hf * kBlockQ * kBoxCols;
          tma_load_4d(sQ + off, &tm_q, &q_full[s], hf * kBoxCols, h,
                      t * kBlockQ, b);
          tma_load_4d(sdO + off, &tm_do, &q_full[s], hf * kBoxCols, h,
                      t * kBlockQ, b);
        }
        tma_load_2d(sLse + s * kBlockQ, &tm_lse, &q_full[s], t * kBlockQ, bh);
        tma_load_2d(sDelta + s * kBlockQ, &tm_delta, &q_full[s],
                    t * kBlockQ, bh);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;                       // which 64 keys of the tile
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int key0 = k0 + c * kWgRows + warp * 16 + (lane >> 2);
    const bool key_ok[2] = {key0 < p.Lk, key0 + 8 < p.Lk};
    const T* kc = sK + c * kWgRows * kBoxCols;  // this consumer's K rows
    const T* vc = sV + c * kWgRows * kBoxCols;
    float* dq_box = sdQ + c * kBlockQ * kWgRows;
    const int dq_col0 = D == 128 ? c * kWgRows : 0;
    const CUtensorMap* dq_map = &tm_dq;

    float dk[D / 2], dv[D / 2];                 // 64 keys x D each
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(kv_full, 0);

    auto tile = [&](int t, auto masked) {
      const int st = t % kStages;
      const T* q_t = sQ + st * kBlockQ * D;
      const T* do_t = sdO + st * kBlockQ * D;
      mbar_wait(&q_full[st], (t / kStages) & 1);
      float s[kBlockQ / 2], dp[kBlockQ / 2];    // S^T, dP^T: 64 keys x 64 q
      issue_sdp<T, D>(s, dp, kc, vc, q_t, do_t);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      form_p_ds<decltype(masked)::value>(s, dp, sLse + st * kBlockQ,
                                         sDelta + st * kBlockQ, p.scale,
                                         key_ok, lane);
      uint32_t pf[kBlockQ / 16][4], dsf[kBlockQ / 16][4];
      pack_p<T, kBlockQ>(pf, s);
      pack_p<T, kBlockQ>(dsf, dp);
      issue_pv<T, D, kBlockQ>(dv, pf, do_t);    // dV += P^T dO
      issue_pv<T, D, kBlockQ>(dk, dsf, q_t);    // dK += dS^T Q
      // dS^T to shared memory for dQ; buffer t & 1 was last read by the
      // dQ of tile t - 2, which both consumers finished before the barrier
      // of tile t - 1
      T* ds_t = sdS + (t & 1) * kBlockN * kBlockQ;
      store_ds(ds_t, dsf, c * kWgRows + warp * 16 + (lane >> 2), lane);
      fence_proxy_async();                      // generic writes -> wgmma
      if (tid == 0) bulk_wait_read<0>();        // the dQ staging tile is free
      if constexpr (D == 128)
        named_barrier_sync(3, kConsumerThreads);
      else
        named_barrier_sync(1 + c, 128);
      float dq[kWgRows / 2];
      issue_dq<T, D>(dq, ds_t, sK, c);
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(dq);
      mbar_arrive(&q_empty[st]);
      stage_dq(dq_box, dq, warp, lane);
      fence_proxy_async();                      // generic writes -> TMA
      named_barrier_sync(1 + c, 128);
      if (tid == 0) {
        tma_reduce_add_4d(dq_map, dq_box, dq_col0, h, t * kBlockQ, b);
        tma_reduce_add_4d(dq_map, dq_box + kBlockQ * kDqBoxCols,
                          dq_col0 + kDqBoxCols, h, t * kBlockQ, b);
        bulk_commit();
      }
    };
    // only the CTA holding the ragged end of the keys masks
    if (k0 + kBlockN > p.Lk) {
      for (int t = 0; t < n_tiles; ++t) tile(t, std::true_type{});
    } else {
      for (int t = 0; t < n_tiles; ++t) tile(t, std::false_type{});
    }
    if (tid == 0) bulk_wait<0>();

    T* dkb = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sn;
    T* dvb = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sn;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!key_ok[r]) continue;
      const long long row = key0 + r * 8;
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd) {
        const int col = jd * 8 + (lane & 3) * 2;
        *reinterpret_cast<uint32_t*>(dkb + row * p.dk_sl + col) =
            E::pack(dk[4 * jd + 2 * r], dk[4 * jd + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dvb + row * p.dv_sl + col) =
            E::pack(dv[4 * jd + 2 * r], dv[4 * jd + 2 * r + 1]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const CUtensorMap* maps, const Params& p, int B, int N,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<D>::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lk + kBlockN - 1) / kBlockN, N, B);
  flash_bwd_kernel<T, D><<<grid, kThreadsWs, Cfg<D>::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], p);
  return cudaGetLastError();
}

// The dQ accumulator: a contiguous [B, L, N, D] fp32 tensor as dims {D, N,
// L, B}, written in 128-byte-swizzled boxes of 32 columns x 64 rows.
CUresult encode_dq(CUtensorMap* map, float* dq, int B, int L, int N, int D) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 4, (cuuint64_t)N * D * 4,
                                 (cuuint64_t)L * N * D * 4};
  const cuuint32_t box[4] = {kDqBoxCols, 1, kBlockQ, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dq, dims,
                      strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// Returns 0 when the launch was accepted, a cudaError_t when it was refused,
// or 1000 + the driver's CUresult when a tensor map could not be encoded.
// `in_strides` holds the (batch, row, head) element strides of q, k, v and
// dO, in that order (12 values); every stride but D's must be a multiple of
// 8 elements and every base 16-byte aligned (the caller checks). lse and
// delta are [B, N, Lq] fp32 with rows `vec_stride` (>= Lq, a multiple of 4)
// apart; dq_acc is a zeroed contiguous [B, Lq, N, D] fp32 tensor that the
// kernel adds dQ into; dk and dv are written in the input type.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, float* dq_acc, void* dk, void* dv,
    int B, int N, int Lq, int Lk, int D, int is_fp16, long long vec_stride,
    const long long* in_strides, long long dk_sb, long long dk_sl,
    long long dk_sn, long long dv_sb, long long dv_sl, long long dv_sn,
    float scale, void* stream) {
  if (B <= 0 || N <= 0 || Lq <= 0 || Lk <= 0 || N > 65535 || B > 65535 ||
      vec_stride < Lq || vec_stride % 4 || (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (encoder() == nullptr)
    return kTensorMapError + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const bool fp16 = is_fp16 != 0;
  const long long* st = in_strides;
  CUtensorMap maps[7];
  const CUresult enc[7] = {
      encode_bld(&maps[0], q, fp16, B, Lq, N, D, st[0], st[1], st[2],
                 kBlockQ),
      encode_bld(&maps[1], k, fp16, B, Lk, N, D, st[3], st[4], st[5],
                 kBlockN),
      encode_bld(&maps[2], v, fp16, B, Lk, N, D, st[6], st[7], st[8],
                 kBlockN),
      encode_bld(&maps[3], dout, fp16, B, Lq, N, D, st[9], st[10], st[11],
                 kBlockQ),
      encode_rows(&maps[4], lse, B * N, Lq, vec_stride, kBlockQ),
      encode_rows(&maps[5], delta, B * N, Lq, vec_stride, kBlockQ),
      encode_dq(&maps[6], dq_acc, B, Lq, N, D)};
  for (CUresult r : enc)
    if (r != CUDA_SUCCESS) return kTensorMapError + static_cast<int>(r);
  Params p;
  p.dk = dk; p.dv = dv;
  p.Lq = Lq; p.Lk = Lk;
  p.dk_sb = dk_sb; p.dk_sl = dk_sl; p.dk_sn = dk_sn;
  p.dv_sb = dv_sb; p.dv_sl = dv_sl; p.dv_sn = dv_sn;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 128)
    err = fp16 ? launch<__half, 128>(maps, p, B, N, s)
               : launch<__nv_bfloat16, 128>(maps, p, B, N, s);
  else
    err = fp16 ? launch<__half, 64>(maps, p, B, N, s)
               : launch<__nv_bfloat16, 64>(maps, p, B, N, s);
  return static_cast<int>(err);
}
