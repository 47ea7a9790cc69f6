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
// and accumulator, keys with mask 0 set to -1e30 (so a fully masked row never
// yields NaN). Keys past Lk (the ragged edge) are excluded outright, and q rows
// past Lq are never stored.
//
// The TPU wrapper pads Lk to its key block and gives the padded keys the same
// -1e30 as masked ones; that matters only for a fully masked row, which it
// averages over the padded length. The caller passes the padding as `n_pad`,
// and the epilogue adds n_pad * exp2(-1e30 - m) to the row sum: exactly 0
// for a row with any unmasked key, exactly n_pad for a fully masked row.
// The LSE is natural-domain, m * ln 2 + ln l, in fp32 [B, N, Lq]; a fully
// masked row keeps an LSE near -1e30 * ln 2, finite.
//
// Inputs are read in their [B, L, N, D] layout through element strides: no
// transpose and no padding copy. The key mask is [B, Lk] bytes, read per
// batch row for every head.
//
// Design: one CTA of 4 warps per (64-row q tile, head, batch). Each warp owns
// 16 q rows, keeps its q fragments in registers, and walks 64-key K/V tiles
// that the CTA stages in shared memory with cp.async, double-buffered. QK^T
// and PV run on the tensor cores with mma.sync m16n8k16 (bf16 or fp16 in,
// fp32 accumulate); the fp32 S fragment is converted in registers into the A
// operand of the PV product. Shared-memory rows are XOR-swizzled in 16-byte
// chunks so the ldmatrix reads are free of bank conflicts.
//
// Bound on this card: at the main-path self-attention shape (L = 29,640,
// 12 heads, D = 128) the kernel does 4*L^2*D*N = 5.4e12 FLOP against 364 MB
// of q/k/v/o traffic, so it is bound by tensor-core operations (>= 5.46 ms at
// 989 TFLOP/s dense bf16). What this simple design leaves on the table:
// mma.sync issues from every warp and waits on ldmatrix, where wgmma reads
// B straight from shared memory asynchronously; loads are cp.async issued by
// the same warps that compute, where TMA plus a producer warp would overlap
// them fully; the softmax of one tile is not overlapped with the products of
// the next; and CTAs are not persistent.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBlockM = 64;   // q rows per CTA
constexpr int kBlockN = 64;   // keys per K/V tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;  // [B, Lk] bytes or null
  void* o;
  float* lse;           // [B, N, Lq] fp32, written when the LSE is asked for
  int Lq, Lk, n_pad;
  long long q_sb, q_sl, q_sn;
  long long k_sb, k_sl, k_sn;
  long long v_sb, v_sl, v_sn;
  long long o_sb, o_sl, o_sn;
  float scale_q;   // softmax scale, already rounded to the input type
  float log2e_q;   // log2(e), already rounded to the input type
};

template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  using E = Elem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kBlockM * D;           // 2 stages
  T* sV = sK + 2 * kBlockN * D;       // 2 stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sn;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sn;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sn;
  const uint8_t* mb = p.mask ? p.mask + (long long)b * p.Lk : nullptr;
  const int n_tiles = (p.Lk + kBlockN - 1) / kBlockN;

  load_tile<T, D, kBlockM>(sQ, qb, q0, p.Lq, p.q_sl, tid);
  cp_async_commit();
  load_tile<T, D, kBlockN>(sK, kb, 0, p.Lk, p.k_sl, tid);
  load_tile<T, D, kBlockN>(sV, vb, 0, p.Lk, p.v_sl, tid);
  cp_async_commit();

  // q * scale, then * log2(e), each rounded to the input type as the TPU
  // wrapper and kernel do.
  cp_async_wait<1>();
  __syncthreads();
  for (int i = tid; i < kBlockM * D; i += kThreads) {
    float x = E::to_float(E::from_float(E::to_float(sQ[i]) * p.scale_q));
    sQ[i] = E::from_float(x * p.log2e_q);
  }
  __syncthreads();

  // A fragments of this warp's 16 q rows, all of D.
  uint32_t qf[D / 16][4];
  {
    const int mi = lane >> 3;
    const int row = warp * 16 + (mi & 1) * 8 + (lane & 7);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldmatrix_x4(qf[kk], sQ + swz<D>(row, kk * 2 + (mi >> 1)));
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float row_max[2] = {kMaskedLogit, kMaskedLogit};
  float row_sum[2] = {0.f, 0.f};   // this thread's partial sums

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      load_tile<T, D, kBlockN>(sK + (stage ^ 1) * kBlockN * D, kb,
                               (t + 1) * kBlockN, p.Lk, p.k_sl, tid);
      load_tile<T, D, kBlockN>(sV + (stage ^ 1) * kBlockN * D, vb,
                               (t + 1) * kBlockN, p.Lk, p.v_sl, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* cK = sK + stage * kBlockN * D;
    const T* cV = sV + stage * kBlockN * D;

    // S = (q * log2 e) K^T for 16 rows x 64 keys, fp32.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jn = 0; jn < kBlockN / 8; jn += 2) {
        uint32_t bf[4];
        const int mi = lane >> 3;
        const int key = (jn + (mi >> 1)) * 8 + (lane & 7);
        ldmatrix_x4(bf, cK + swz<D>(key, kk * 2 + (mi & 1)));
        E::mma(s[jn], qf[kk], bf);
        E::mma(s[jn + 1], qf[kk], bf + 2);
      }
    }

    const int k0 = t * kBlockN;
    if (mb != nullptr || k0 + kBlockN > p.Lk) {
#pragma unroll
      for (int jn = 0; jn < kBlockN / 8; ++jn) {
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

    // Online softmax; the thread holds rows lane/4 (r = 0) and lane/4 + 8
    // (r = 1), and the four threads of a quad share a row.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = row_max[r];
#pragma unroll
      for (int jn = 0; jn < kBlockN / 8; ++jn)
        mx = fmaxf(mx, fmaxf(s[jn][2 * r], s[jn][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = fast_exp2(row_max[r] - mx);
      row_max[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int jn = 0; jn < kBlockN / 8; ++jn) {
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

    // acc += P V, with P rounded to the input type.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
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
    // the TPU kernel's padded keys: 0 unless every real key was masked
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
    if (kLse && (lane & 3) == 0)
      p.lse[((long long)b * gridDim.y + h) * p.Lq + row] =
          row_max[r] * kLn2 + logf(l);
  }
}

template <typename T, int D, bool kLse>
cudaError_t launch(const Params& p, int B, int N, cudaStream_t stream) {
  const int smem = (kBlockM + 4 * kBlockN) * D * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + kBlockM - 1) / kBlockM, N, B);
  flash_fwd_kernel<T, D, kLse><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_lse(const Params& p, int B, int N, cudaStream_t s) {
  return p.lse ? launch<T, D, true>(p, B, N, s) : launch<T, D, false>(p, B, N, s);
}

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted. Strides are in
// elements; every row must start on a 16-byte boundary (the caller checks).
// `lse` null runs B1 (no LSE), otherwise B2 writes the LSE [B, N, Lq] fp32.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kv_mask, void* o,
    float* lse, int B, int N, int Lq, int Lk, int D, int is_fp16, int n_pad,
    long long q_sb, long long q_sl, long long q_sn,
    long long k_sb, long long k_sl, long long k_sn,
    long long v_sb, long long v_sl, long long v_sn,
    long long o_sb, long long o_sl, long long o_sn,
    float scale_q, float log2e_q, void* stream) {
  if (B <= 0 || N <= 0 || Lq <= 0 || Lk <= 0 || n_pad < 0 || N > 65535 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse;
  p.mask = static_cast<const uint8_t*>(kv_mask);
  p.Lq = Lq; p.Lk = Lk; p.n_pad = n_pad;
  p.q_sb = q_sb; p.q_sl = q_sl; p.q_sn = q_sn;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sn = k_sn;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sn = v_sn;
  p.o_sb = o_sb; p.o_sl = o_sl; p.o_sn = o_sn;
  p.scale_q = scale_q; p.log2e_q = log2e_q;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 128)
    err = is_fp16 ? launch_lse<__half, 128>(p, B, N, s)
                  : launch_lse<__nv_bfloat16, 128>(p, B, N, s);
  else if (D == 64)
    err = is_fp16 ? launch_lse<__half, 64>(p, B, N, s)
                  : launch_lse<__nv_bfloat16, 64>(p, B, N, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
