// Flash-attention forward for Hopper (sm_90a), bound to Python through a
// plain C entry point (ctypes).
//
// Replaces the Pallas TPU kernel `videocof_tpu/ops/flash_attention.py::
// _flash_kernel` on both of its paths: without the LSE (`_flash_bnld(
// need_lse=False)`, reached by `flash_attention`; kernel B1) and with it
// (`need_lse=True`, reached by the training forward `_flash_core_fwd` and by
// `flash_attention_with_lse`; kernel B2). One template, the LSE a compile-time
// flag, so B1 carries no LSE code. Same function as the TPU kernel:
// bidirectional softmax attention in the exp2 domain, with q pre-scaled
// exactly as the TPU wrapper does (q * scale rounded to the input type, then
// * log2(e) rounded to the input type), fp32 logits, running max, running sum
// and accumulator, P rounded to the input type before the PV product, keys
// with mask 0 set to -1e30 (so a fully masked row never yields NaN). Keys past
// Lk (the ragged edge) are excluded outright (-inf), and q rows past Lq are
// never stored.
//
// The TPU wrapper pads Lk to its key block and gives the padded keys the same
// -1e30 as masked ones; that matters only for a fully masked row, which it
// averages over the padded length. The caller passes the padding as `n_pad`,
// and the epilogue adds n_pad * exp2(-1e30 - m) to the row sum: exactly 0
// for a row with any unmasked key, exactly n_pad for a fully masked row.
// The LSE is natural-domain, m * ln 2 + ln l, in fp32 [B, N, Lq]; a fully
// masked row keeps an LSE near -1e30 * ln 2, finite.
//
// Inputs are read in their [B, L, N, D] layout through TMA tensor maps that
// the host encodes per launch over the strides it is given (dims {D, N, L,
// B}): no transpose and no padding copy, and TMA fills rows past Lq and Lk
// with zeros. The key mask is [B, Lk] bytes, read per batch row for every
// head.
//
// Design: one CTA of three warpgroups per (128-row q tile, head, batch),
// warp-specialised.
// - The producer warpgroup drops to 24 registers (setmaxnreg); one of its
//   threads issues every TMA load: the q tile once, then 128-key K and V
//   tiles into a ring of 2 stages at D = 128 (4 at D = 64), each stage with
//   a full and an empty barrier for K and for V. It refills a stage as soon
//   as both consumers have released it, so the next tiles are in flight
//   while the consumers compute.
// - Two consumer warpgroups (240 registers each) own 64 q rows each. Each
//   scales its rows of Q in shared memory once (then fences the generic
//   proxy's writes against wgmma's async-proxy reads). Per key tile it runs
//   S = Q K^T as wgmma m64n128k16 with both operands in shared memory
//   (128-byte swizzle, K-major), masks, runs the online softmax on the fp32
//   fragment, packs P to the input type in registers, and runs O += P V as
//   wgmma m64nDk16 with P from registers and V in shared memory (MN-major,
//   the descriptor's transpose bit).
// - Overlap: tile t's Q K^T is issued together with tile t-1's P V, and
//   tile t's softmax runs while that P V is still in flight (so S, P and O
//   are live at once: 64 + 32 + 64 registers at D = 128). The two consumers
//   take turns to issue their products (ping-pong on two named barriers),
//   so one's softmax runs under the other's products.
//
// Bound on this card: at the main-path self-attention shape (L = 29,640,
// 12 heads, D = 128) the kernel does 4*L^2*D*N = 5.4e12 FLOP against 364 MB
// of q/k/v/o traffic, so it is bound by tensor-core operations (>= 5.46 ms at
// 989 TFLOP/s dense bf16). wgmma is the only way to that rate; TMA with a
// producer warpgroup takes the loads off the computing warps; the 128-row q
// tile halves the K/V traffic from L2 per q row against a 64-row tile; the
// overlap keeps the tensor cores fed while the exponentials run. What it
// leaves for a later PR: the CTAs are not persistent, so each CTA's
// prologue (the q tile's load and scaling) and epilogue are exposed, which
// is most of the time at Lk = 512; the output leaves by plain stores rather
// than TMA; wider key tiles (176 keys, as FlashAttention-3 takes at D = 128)
// spill registers in this arrangement.

#include "hopper_attention.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int kBlockM = 128;          // q rows per CTA
constexpr int kBlockN = 128;          // keys per K/V tile

template <int D>
struct Cfg {
  static constexpr int kHalves = D / kBoxCols;     // TMA boxes across D
  static constexpr int kStages = D == 128 ? 2 : 4;
  static constexpr int kQElems = kBlockM * D;
  static constexpr int kKVElems = kBlockN * D;
  static constexpr uint32_t kQBytes = kQElems * 2;
  static constexpr uint32_t kKVBytes = kKVElems * 2;
  // Q, then K and V of each stage, then the barriers: q_full, k_full[S],
  // v_full[S], k_empty[S], v_empty[S]; 1024 more to align the base to the
  // swizzle period
  static constexpr int kBarOffset = (kQElems + 2 * kStages * kKVElems) * 2;
  static constexpr int kSmem = kBarOffset + (1 + 4 * kStages) * 8 + 1024;
};

struct Params {
  const uint8_t* mask;  // [B, Lk] bytes or null
  void* o;
  float* lse;           // [B, N, Lq] fp32, written when the LSE is asked for
  int Lq, Lk, n_pad;
  long long o_sb, o_sl, o_sn;
  float scale_q;   // softmax scale, already rounded to the input type
  float log2e_q;   // log2(e), already rounded to the input type
};

// S = Q K^T for the warpgroup's 64 rows x 128 keys, issued, not waited for.
template <typename T, int D>
__device__ __forceinline__ void issue_qk(float (&s)[kBlockN / 2], const T* q,
                                         const T* k) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int qoff = (kk / 4) * kBlockM * kBoxCols + (kk % 4) * 16;
    const int koff = (kk / 4) * kBlockN * kBoxCols + (kk % 4) * 16;
    wgmma_ss_m64n128k16<T>(s, sw128_desc(q + qoff, 16, 1024),
                           sw128_desc(k + koff, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(kThreadsWs, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using C = Cfg<D>;
  using E = Elem<T>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  T* sQ = reinterpret_cast<T*>(smem);          // [halves][128 rows][64]
  T* sK = sQ + C::kQElems;                     // [stages][halves][128][64]
  T* sV = sK + C::kStages * C::kKVElems;       // the same
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + C::kStages;
  uint64_t* k_empty = v_full + C::kStages;
  uint64_t* v_empty = k_empty + C::kStages;

  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (p.Lk + kBlockN - 1) / kBlockN;
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
        mbar_arrive_expect_tx(&k_full[s], C::kKVBytes);
#pragma unroll
        for (int hf = 0; hf < C::kHalves; ++hf)
          tma_load_4d(sK + s * C::kKVElems + hf * kBlockN * kBoxCols, &tm_k,
                      &k_full[s], hf * kBoxCols, h, t * kBlockN, b);
        if (t >= C::kStages) mbar_wait(&v_empty[s], freed);
        mbar_arrive_expect_tx(&v_full[s], C::kKVBytes);
#pragma unroll
        for (int hf = 0; hf < C::kHalves; ++hf)
          tma_load_4d(sV + s * C::kKVElems + hf * kBlockN * kBoxCols, &tm_v,
                      &v_full[s], hf * kBoxCols, h, t * kBlockN, b);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;                       // which 64 rows of the tile
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const uint8_t* mb = p.mask ? p.mask + (long long)b * p.Lk : nullptr;
    if (c == 1) turn_pass(1);                   // consumer 0 goes first

    // q * scale, then * log2(e), each rounded to the input type as the TPU
    // wrapper and kernel do; elementwise, so the swizzle does not matter
    mbar_wait(q_full, 0);
#pragma unroll
    for (int hf = 0; hf < C::kHalves; ++hf) {
      uint4* rows = reinterpret_cast<uint4*>(sQ + hf * kBlockM * kBoxCols +
                                             c * kWgRows * kBoxCols);
#pragma unroll
      for (int i = 0; i < kWgRows * kBoxCols / 8 / 128; ++i) {
        uint4 x = rows[tid + i * 128];
        T* e = reinterpret_cast<T*>(&x);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float y = E::to_float(E::from_float(E::to_float(e[j]) *
                                                    p.scale_q));
          e[j] = E::from_float(y * p.log2e_q);
        }
        rows[tid + i * 128] = x;
      }
    }
    fence_proxy_async();                 // generic writes -> wgmma reads
    named_barrier_sync(1 + c, 128);
    const T* q_wg = sQ + c * kWgRows * kBoxCols;

    float s[kBlockN / 2];                // S fragment, 64 x 128 keys
    float acc[D / 2];                    // O fragment, 64 x D
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float row_max[2] = {kMaskedLogit, kMaskedLogit};
    float row_sum[2] = {0.f, 0.f};       // this thread's partial sums
    float alpha[2];
    uint32_t pf[kBlockN / 16][4];        // P of the tile before, packed

    // Tile t's S = Q K^T is issued together with tile t-1's O += P V; the
    // softmax of tile t runs while P V is still in flight.
    mbar_wait(&k_full[0], 0);
    turn_wait(c);
    issue_qk<T, D>(s, q_wg, sK);
    turn_pass(c);
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(&k_empty[0]);
    mask_tile<kBlockN>(s, 0, p.Lk, mb, lane);
    softmax_tile<kBlockN>(s, row_max, row_sum, alpha);
    pack_p<T, kBlockN>(pf, s);
    for (int t = 1; t < n_tiles; ++t) {
      const int st = t % C::kStages, sp = (t - 1) % C::kStages;
      mbar_wait(&k_full[st], (t / C::kStages) & 1);
      turn_wait(c);
      issue_qk<T, D>(s, q_wg, sK + st * C::kKVElems);
      rescale<D>(acc, alpha);
      mbar_wait(&v_full[sp], ((t - 1) / C::kStages) & 1);
      issue_pv<T, D, kBlockN>(acc, pf, sV + sp * C::kKVElems);
      turn_pass(c);
      wgmma_wait<1>();                   // S of tile t
      fence_regs(s);
      mbar_arrive(&k_empty[st]);
      mask_tile<kBlockN>(s, t * kBlockN, p.Lk, mb, lane);
      softmax_tile<kBlockN>(s, row_max, row_sum, alpha);
      wgmma_wait<0>();                   // P V of tile t-1
      fence_regs(acc);
      mbar_arrive(&v_empty[sp]);
      pack_p<T, kBlockN>(pf, s);
    }
    {
      const int sp = (n_tiles - 1) % C::kStages;
      rescale<D>(acc, alpha);
      mbar_wait(&v_full[sp], ((n_tiles - 1) / C::kStages) & 1);
      turn_wait(c);
      issue_pv<T, D, kBlockN>(acc, pf, sV + sp * C::kKVElems);
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
      // the TPU kernel's padded keys: 0 unless every real key was masked
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
      if (kLse && (lane & 3) == 0)
        p.lse[((long long)b * gridDim.y + h) * p.Lq + row] =
            row_max[r] * kLn2 + logf(l);
    }
  }
}

template <typename T, int D, bool kLse>
cudaError_t launch(const CUtensorMap* maps, const Params& p, int B, int N,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + kBlockM - 1) / kBlockM, N, B);
  flash_fwd_kernel<T, D, kLse><<<grid, kThreadsWs, Cfg<D>::kSmem, stream>>>(
      maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_lse(const CUtensorMap* maps, const Params& p, int B, int N,
                       cudaStream_t s) {
  return p.lse ? launch<T, D, true>(maps, p, B, N, s)
               : launch<T, D, false>(maps, p, B, N, s);
}

}  // namespace

// Returns 0 when the launch was accepted, a cudaError_t when it was refused,
// or 1000 + the driver's CUresult when a tensor map could not be encoded.
// Strides are in elements; every stride but D's must be a multiple of 8
// elements and every base 16-byte aligned (the caller checks). `lse` null
// runs B1 (no LSE), otherwise B2 writes the LSE [B, N, Lq] fp32.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kv_mask, void* o,
    float* lse, int B, int N, int Lq, int Lk, int D, int is_fp16, int n_pad,
    long long q_sb, long long q_sl, long long q_sn,
    long long k_sb, long long k_sl, long long k_sn,
    long long v_sb, long long v_sl, long long v_sn,
    long long o_sb, long long o_sl, long long o_sn,
    float scale_q, float log2e_q, void* stream) {
  if (B <= 0 || N <= 0 || Lq <= 0 || Lk <= 0 || n_pad < 0 || N > 65535 ||
      B > 65535 || (D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (encoder() == nullptr)
    return kTensorMapError + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const bool fp16 = is_fp16 != 0;
  CUtensorMap maps[3];
  const CUresult enc[3] = {
      encode_bld(&maps[0], q, fp16, B, Lq, N, D, q_sb, q_sl, q_sn, kBlockM),
      encode_bld(&maps[1], k, fp16, B, Lk, N, D, k_sb, k_sl, k_sn, kBlockN),
      encode_bld(&maps[2], v, fp16, B, Lk, N, D, v_sb, v_sl, v_sn, kBlockN)};
  for (CUresult r : enc)
    if (r != CUDA_SUCCESS) return kTensorMapError + static_cast<int>(r);
  Params p;
  p.mask = static_cast<const uint8_t*>(kv_mask);
  p.o = o; p.lse = lse;
  p.Lq = Lq; p.Lk = Lk; p.n_pad = n_pad;
  p.o_sb = o_sb; p.o_sl = o_sl; p.o_sn = o_sn;
  p.scale_q = scale_q; p.log2e_q = log2e_q;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 128)
    err = fp16 ? launch_lse<__half, 128>(maps, p, B, N, s)
               : launch_lse<__nv_bfloat16, 128>(maps, p, B, N, s);
  else
    err = fp16 ? launch_lse<__half, 64>(maps, p, B, N, s)
               : launch_lse<__nv_bfloat16, 64>(maps, p, B, N, s);
  return static_cast<int>(err);
}
