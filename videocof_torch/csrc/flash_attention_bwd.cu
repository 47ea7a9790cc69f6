// Flash-attention backward for Hopper (sm_90a): two kernels, bound to Python
// through plain C entry points (ctypes).
//
// Replace the Pallas TPU kernels of `videocof_tpu/ops/flash_attention.py::
// _flash_bwd_bnld`: `_bwd_dq_kernel` (kernel B3a) and `_bwd_dkv_kernel`
// (kernel B3b). Same function: with q already scaled (the training wrapper
// folds the softmax scale into q and runs the core at scale 1), the logits are
// recomputed in the natural domain, S = q K^T * scale, and the probabilities
// against the forward's natural-domain LSE, P = exp(S - lse); then
// dP = dO V^T, dS = P * (dP - delta) * scale with delta = rowsum(dO * O)
// (computed by the caller, as the TPU wrapper computes it outside its
// kernels), and
//   dQ = dS K            (B3a)
//   dV = P^T dO, dK = dS^T Q  (B3b).
// Keys past Lk leave dQ (P = 0), and q rows past Lq leave dK and dV (P = 0).
// No key mask: the masked path's backward recomputes through plain attention
// (`_flash_core_masked_bwd` has no Pallas kernel either).
//
// The TPU kernels run the products in fp32 on fp32-upcast inputs. Here S and
// dP come from the tensor cores on the bf16/fp16 inputs with fp32
// accumulation, which is exact in the products as there; P and dS are
// rounded to the input type to feed the tensor cores for dV, dK and dQ, as
// FlashAttention-2 does. That rounding is the one difference from the TPU
// arithmetic (about 3e-3 relative L2 expected on dq, dk, dv).
//
// Inputs are read in their [B, L, N, D] layout through element strides;
// lse and delta are [B, N, Lq] fp32; dq, dk, dv are written in [B, L, N, D],
// in the input type, as the TPU wrapper casts them.
//
// Design. The TPU grid is sequential and carries dQ (or dK, dV) in VMEM
// scratch over its inner axis; Hopper's CTAs run in parallel in no order, so
// each CTA loops over the inner axis itself and owns its output tile: no
// atomics, no second pass.
//  - B3a: one CTA of 4 warps per (64-row q tile, head, batch); each warp owns
//    16 q rows and walks 64-key K/V tiles staged with cp.async, double-
//    buffered. dQ (16 x D fp32 per warp) stays in registers; the Q and dO
//    fragments are re-read from shared memory for each K/V tile so that the
//    registers hold dQ, S and dP only.
//  - B3b: one CTA of 4 warps per (64-key tile, head, batch); each warp owns
//    16 keys and walks q tiles (32 rows at D = 128, 64 at D = 64) with their
//    dO, LSE and delta, double-buffered. The warp computes S^T and dP^T
//    directly (K and V fragments as the A operand), so P^T and dS^T are the A
//    operands of dV and dK without a transpose. dK and dV (2 x 16 x D fp32
//    per warp) stay in registers; the short q tile at D = 128 keeps S^T and
//    dP^T small enough that nothing spills.
//
// Bound on this card at the main-path self-attention shape (L = 29,640,
// 12 heads, D = 128): B3a does 6*L^2*D*N = 8.1e12 FLOP (S, dP, dQ) and B3b
// 8*L^2*D*N = 1.08e13 FLOP (S, dP, dV, dK) against well under 1 GB of
// traffic each, so both are bound by tensor-core operations (8.19 ms and
// 10.9 ms at 989 TFLOP/s dense bf16). Left for later, as in the forward:
// wgmma, TMA with a producer warp, and persistent CTAs. At the cross shape
// (Lk = 512) B3b has only 8 key tiles per head: 96 CTAs for 132 SMs, each
// walking all 29,640 q rows; splitting the q loop across CTAs needs a
// reduction pass.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBlockM = 64;   // B3a: q rows per CTA
constexpr int kBlockN = 64;   // keys per K/V tile (B3a) and per CTA (B3b)

// B3b's q tile: shorter at D = 128, where dK and dV take 128 registers.
template <int D> struct DkvBlockQ { static constexpr int value = 64; };
template <> struct DkvBlockQ<128> { static constexpr int value = 32; };

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // [B, N, Lq], natural domain
  const float* delta;   // [B, N, Lq]
  void* dq;
  void* dk;
  void* dv;
  int Lq, Lk;
  long long q_sb, q_sl, q_sn;
  long long k_sb, k_sl, k_sn;
  long long v_sb, v_sl, v_sn;
  long long do_sb, do_sl, do_sn;
  long long dq_sb, dq_sl, dq_sn;
  long long dk_sb, dk_sl, dk_sn;
  long long dv_sb, dv_sl, dv_sn;
  float scale;
};

template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, long long row_stride,
                                           int row0, int len,
                                           const float (*acc)[4], int lane) {
  using E = Elem<T>;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + r * 8;
    if (row >= len) continue;
    T* out = base + (long long)row * row_stride;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      const int col = jd * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(out + col) =
          E::pack(acc[jd][2 * r], acc[jd][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------------- B3a: dQ

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const BwdParams p) {
  using E = Elem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + kBlockM * D;
  T* sK = sdO + kBlockM * D;          // 2 stages
  T* sV = sK + 2 * kBlockN * D;       // 2 stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mi = lane >> 3;
  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sn;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sn;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sn;
  const T* dob = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sn;
  const long long vec0 = ((long long)b * gridDim.y + h) * p.Lq;
  const int n_tiles = (p.Lk + kBlockN - 1) / kBlockN;

  load_tile<T, D, kBlockM>(sQ, qb, q0, p.Lq, p.q_sl, tid);
  load_tile<T, D, kBlockM>(sdO, dob, q0, p.Lq, p.do_sl, tid);
  load_tile<T, D, kBlockN>(sK, kb, 0, p.Lk, p.k_sl, tid);
  load_tile<T, D, kBlockN>(sV, vb, 0, p.Lk, p.v_sl, tid);
  cp_async_commit();

  // log2-domain LSE and delta of this thread's two rows
  const float scale2 = p.scale * kLog2e;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + (lane >> 2) + r * 8;
    const bool ok = row < p.Lq;
    lse2[r] = ok ? p.lse[vec0 + row] * kLog2e : 0.f;
    dlt[r] = ok ? p.delta[vec0 + row] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int arow = warp * 16 + (mi & 1) * 8 + (lane & 7);

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

    // S = Q K^T and dP = dO V^T for 16 rows x 64 keys, fp32.
    float s[kBlockN / 8][4], dp[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      ldmatrix_x4(qa, sQ + swz<D>(arow, kk * 2 + (mi >> 1)));
      ldmatrix_x4(da, sdO + swz<D>(arow, kk * 2 + (mi >> 1)));
#pragma unroll
      for (int jn = 0; jn < kBlockN / 8; jn += 2) {
        const int key = (jn + (mi >> 1)) * 8 + (lane & 7);
        uint32_t bf[4];
        ldmatrix_x4(bf, cK + swz<D>(key, kk * 2 + (mi & 1)));
        E::mma(s[jn], qa, bf);
        E::mma(s[jn + 1], qa, bf + 2);
        ldmatrix_x4(bf, cV + swz<D>(key, kk * 2 + (mi & 1)));
        E::mma(dp[jn], da, bf);
        E::mma(dp[jn + 1], da, bf + 2);
      }
    }

    // P = exp(S * scale - lse), 0 past Lk; dS = P * (dP - delta) * scale,
    // kept in dp.
    const int k0 = t * kBlockN;
#pragma unroll
    for (int jn = 0; jn < kBlockN / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kidx = k0 + jn * 8 + (lane & 3) * 2 + (e & 1);
        const float pv =
            kidx < p.Lk ? fast_exp2(s[jn][e] * scale2 - lse2[r]) : 0.f;
        dp[jn][e] = pv * (dp[jn][e] - dlt[r]) * p.scale;
      }
    }

    // dQ += dS K, with dS rounded to the input type.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      a[0] = E::pack(dp[2 * kk][0], dp[2 * kk][1]);
      a[1] = E::pack(dp[2 * kk][2], dp[2 * kk][3]);
      a[2] = E::pack(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      a[3] = E::pack(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int jd = 0; jd < D / 8; jd += 2) {
        uint32_t bf[4];
        const int key = kk * 16 + (mi & 1) * 8 + (lane & 7);
        ldmatrix_x4_trans(bf, cK + swz<D>(key, jd + (mi >> 1)));
        E::mma(acc[jd], a, bf);
        E::mma(acc[jd + 1], a, bf + 2);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  T* dqb = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sn;
  store_rows<T, D>(dqb, p.dq_sl, q0 + warp * 16, p.Lq, acc, lane);
}

// -------------------------------------------------------------- B3b: dK, dV

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const BwdParams p) {
  using E = Elem<T>;
  constexpr int BQ = DkvBlockQ<D>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kBlockN * D;
  T* sQ = sV + kBlockN * D;           // 2 stages
  T* sdO = sQ + 2 * BQ * D;           // 2 stages
  float* sL = reinterpret_cast<float*>(sdO + 2 * BQ * D);   // 2 stages
  float* sD = sL + 2 * BQ;                                  // 2 stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mi = lane >> 3;
  const int k0 = blockIdx.x * kBlockN;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sn;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sn;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sn;
  const T* dob = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sn;
  const long long vec0 = ((long long)b * gridDim.y + h) * p.Lq;
  const float* lb = p.lse + vec0;
  const float* db = p.delta + vec0;
  const int n_tiles = (p.Lq + BQ - 1) / BQ;

  load_tile<T, D, kBlockN>(sK, kb, k0, p.Lk, p.k_sl, tid);
  load_tile<T, D, kBlockN>(sV, vb, k0, p.Lk, p.v_sl, tid);
  load_tile<T, D, BQ>(sQ, qb, 0, p.Lq, p.q_sl, tid);
  load_tile<T, D, BQ>(sdO, dob, 0, p.Lq, p.do_sl, tid);
  load_vec<BQ>(sL, lb, 0, p.Lq, tid);
  load_vec<BQ>(sD, db, 0, p.Lq, tid);
  cp_async_commit();

  const float scale2 = p.scale * kLog2e;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }
  const int arow = warp * 16 + (mi & 1) * 8 + (lane & 7);

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      const int n0 = (t + 1) * BQ, ns = stage ^ 1;
      load_tile<T, D, BQ>(sQ + ns * BQ * D, qb, n0, p.Lq, p.q_sl, tid);
      load_tile<T, D, BQ>(sdO + ns * BQ * D, dob, n0, p.Lq, p.do_sl, tid);
      load_vec<BQ>(sL + ns * BQ, lb, n0, p.Lq, tid);
      load_vec<BQ>(sD + ns * BQ, db, n0, p.Lq, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* cQ = sQ + stage * BQ * D;
    const T* cdO = sdO + stage * BQ * D;
    const float* cL = sL + stage * BQ;
    const float* cD = sD + stage * BQ;

    // S^T = K Q^T and dP^T = V dO^T for 16 keys x BQ q rows, fp32.
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, sK + swz<D>(arow, kk * 2 + (mi >> 1)));
      ldmatrix_x4(va, sV + swz<D>(arow, kk * 2 + (mi >> 1)));
#pragma unroll
      for (int jn = 0; jn < BQ / 8; jn += 2) {
        const int qrow = (jn + (mi >> 1)) * 8 + (lane & 7);
        uint32_t bf[4];
        ldmatrix_x4(bf, cQ + swz<D>(qrow, kk * 2 + (mi & 1)));
        E::mma(s[jn], ka, bf);
        E::mma(s[jn + 1], ka, bf + 2);
        ldmatrix_x4(bf, cdO + swz<D>(qrow, kk * 2 + (mi & 1)));
        E::mma(dp[jn], va, bf);
        E::mma(dp[jn + 1], va, bf + 2);
      }
    }

    // P^T = exp(S^T * scale - lse), 0 for q rows past Lq (kept in s);
    // dS^T = P^T * (dP^T - delta) * scale (kept in dp).
    const int q0 = t * BQ;
#pragma unroll
    for (int jn = 0; jn < BQ / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = jn * 8 + (lane & 3) * 2 + (e & 1);
        const float pv = q0 + col < p.Lq
            ? fast_exp2(s[jn][e] * scale2 - cL[col] * kLog2e) : 0.f;
        s[jn][e] = pv;
        dp[jn][e] = pv * (dp[jn][e] - cD[col]) * p.scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q, with P and dS rounded to the input type.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      pa[0] = E::pack(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = E::pack(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = E::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = E::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      da[0] = E::pack(dp[2 * kk][0], dp[2 * kk][1]);
      da[1] = E::pack(dp[2 * kk][2], dp[2 * kk][3]);
      da[2] = E::pack(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[3] = E::pack(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int jd = 0; jd < D / 8; jd += 2) {
        uint32_t bf[4];
        const int qrow = kk * 16 + (mi & 1) * 8 + (lane & 7);
        ldmatrix_x4_trans(bf, cdO + swz<D>(qrow, jd + (mi >> 1)));
        E::mma(dv[jd], pa, bf);
        E::mma(dv[jd + 1], pa, bf + 2);
        ldmatrix_x4_trans(bf, cQ + swz<D>(qrow, jd + (mi >> 1)));
        E::mma(dk[jd], da, bf);
        E::mma(dk[jd + 1], da, bf + 2);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  T* dkb = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sn;
  T* dvb = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sn;
  store_rows<T, D>(dkb, p.dk_sl, k0 + warp * 16, p.Lk, dk, lane);
  store_rows<T, D>(dvb, p.dv_sl, k0 + warp * 16, p.Lk, dv, lane);
}

template <typename T, int D>
cudaError_t launch_dq(const BwdParams& p, int B, int N, cudaStream_t stream) {
  const int smem = (2 * kBlockM + 4 * kBlockN) * D * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lq + kBlockM - 1) / kBlockM, N, B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdParams& p, int B, int N, cudaStream_t stream) {
  constexpr int BQ = DkvBlockQ<D>::value;
  const int smem = (2 * kBlockN + 4 * BQ) * D * static_cast<int>(sizeof(T))
                   + 4 * BQ * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Lk + kBlockN - 1) / kBlockN, N, B);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      int Lq, int Lk, const long long* st, float scale) {
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta;
  p.dq = p.dk = p.dv = nullptr;
  p.Lq = Lq; p.Lk = Lk;
  p.q_sb = st[0]; p.q_sl = st[1]; p.q_sn = st[2];
  p.k_sb = st[3]; p.k_sl = st[4]; p.k_sn = st[5];
  p.v_sb = st[6]; p.v_sl = st[7]; p.v_sn = st[8];
  p.do_sb = st[9]; p.do_sl = st[10]; p.do_sn = st[11];
  p.scale = scale;
  return p;
}

bool bad_sizes(int B, int N, int Lq, int Lk) {
  return B <= 0 || N <= 0 || Lq <= 0 || Lk <= 0 || N > 65535 || B > 65535;
}

}  // namespace

// Both return a cudaError_t: 0 when the launch was accepted. `in_strides`
// holds the (batch, row, head) element strides of q, k, v and dO, in that
// order (12 values); every row must start on a 16-byte boundary and D must
// be contiguous (the caller checks). lse and delta are [B, N, Lq] fp32.
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq,
    int B, int N, int Lq, int Lk, int D, int is_fp16,
    const long long* in_strides, long long dq_sb, long long dq_sl,
    long long dq_sn, float scale, void* stream) {
  if (bad_sizes(B, N, Lq, Lk)) return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p = make_params(q, k, v, dout, lse, delta, Lq, Lk, in_strides,
                            scale);
  p.dq = dq; p.dq_sb = dq_sb; p.dq_sl = dq_sl; p.dq_sn = dq_sn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 128)
    err = is_fp16 ? launch_dq<__half, 128>(p, B, N, s)
                  : launch_dq<__nv_bfloat16, 128>(p, B, N, s);
  else if (D == 64)
    err = is_fp16 ? launch_dq<__half, 64>(p, B, N, s)
                  : launch_dq<__nv_bfloat16, 64>(p, B, N, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
    int B, int N, int Lq, int Lk, int D, int is_fp16,
    const long long* in_strides, long long dk_sb, long long dk_sl,
    long long dk_sn, long long dv_sb, long long dv_sl, long long dv_sn,
    float scale, void* stream) {
  if (bad_sizes(B, N, Lq, Lk)) return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p = make_params(q, k, v, dout, lse, delta, Lq, Lk, in_strides,
                            scale);
  p.dk = dk; p.dk_sb = dk_sb; p.dk_sl = dk_sl; p.dk_sn = dk_sn;
  p.dv = dv; p.dv_sb = dv_sb; p.dv_sl = dv_sl; p.dv_sn = dv_sn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 128)
    err = is_fp16 ? launch_dkv<__half, 128>(p, B, N, s)
                  : launch_dkv<__nv_bfloat16, 128>(p, B, N, s);
  else if (D == 64)
    err = is_fp16 ? launch_dkv<__half, 64>(p, B, N, s)
                  : launch_dkv<__nv_bfloat16, 64>(p, B, N, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
