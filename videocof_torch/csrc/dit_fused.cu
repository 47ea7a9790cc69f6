// The Wan DiT block's elementwise chain in five passes for Hopper (sm_90a),
// bound to Python through plain C entry points (ctypes).
//
// Replaces no TPU kernel: the JAX package leaves this chain of
// `videocof_tpu/models/wan_dit.py` (`wan_block_apply` and `_attn_qkv`: AdaLN
// modulation, the gated residual adds, the cross-attention norm, q/k
// RMSNorm, `rope.apply_rope`) to XLA, which fuses it into its neighbours.
// PyTorch runs each step of the chain as its own kernel over [L, D] tensors
// (about 300 bytes an element of the stream a block), so the chain is
// written here as five passes, each reading its inputs once and writing its
// outputs once:
//
//   dit_ln_modulate_kernel          bf16(LN(x) * (1 + scale) + shift)
//   dit_qk_norm_rope_kernel         q, k: bf16(RMSNorm(x) * w), then each
//                                   channel pair rotated in fp32 and rounded
//                                   (RoPE off: the cross-attention's q)
//   dit_gate_residual_ln_kernel     x + y * gate, and bf16(LN(x) * w + b)
//                                   (or bf16(x) without the norm)
//   dit_residual_ln_modulate_kernel x + y, and bf16(LN(x) * (1 + scale) +
//                                   shift)
//   dit_gate_residual_kernel        x + h * gate
//
// The arithmetic is the plain path's (`models/wan_dit.py`, `WanBlock.forward`
// and `Attention.forward`): the stream in fp32, LayerNorm and modulation in
// fp32, q/k RMSNorm in fp32 rounded to bf16 before the rotation, the
// rotation in fp32 from those bf16 values. Each product and sum that the
// plain path stores as a tensor is rounded here too (`__fmul_rn`,
// `__fadd_rn`: no contraction into an FMA), so the residual adds are the
// plain path's bit for bit; only the row reductions (mean, variance, mean
// square) add in another order.
//
// Bound: the bytes, 52 an element of the stream a block (fp32 stream 4 B,
// bf16 branch tensors 2 B): 6 + 8 + 12 + 4 + 12 + 10, the cross-attention's
// q pass included. Design: one CTA a token row, the row held in registers
// (`V` 16-byte vectors a thread, the CTA sized by the wrapper so that a row
// of D fills it), two block reductions for a LayerNorm (sum, then the
// squared deviations from the mean, as F.layer_norm's biased variance) and
// one for an RMSNorm; loads and stores are 16 bytes (fp32) or 8 bytes
// (bf16) a lane, neighbouring lanes on neighbouring addresses. The
// modulation rows [B, D], the norm weights and the RoPE tables are small
// and read through the caches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxThreads = 512;
constexpr int kMaxVec = 8;

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const bf16* p, float v[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 lo = __bfloat1622float2(h[0]);
  const float2 hi = __bfloat1622float2(h[1]);
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// a norm's weight or bias [D], stored in bf16 or fp32
__device__ __forceinline__ void load4(const void* p, int f32, int c,
                                      float v[4]) {
  if (f32) load4(static_cast<const float*>(p) + c, v);
  else load4(static_cast<const bf16*>(p) + c, v);
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(bf16* p, const float v[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The sum of v over the CTA, in every thread (blockDim.x a multiple of 32).
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();                       // red may hold an earlier sum
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool owns(int i, int nvec) {
  return threadIdx.x + i * blockDim.x < static_cast<unsigned>(nvec);
}

__device__ __forceinline__ int column(int i) {
  return 4 * (threadIdx.x + i * blockDim.x);
}

// A row of D values into v (zero where the thread holds no vector).
template <int V, typename T>
__device__ __forceinline__ void load_row(const T* row, int nvec,
                                         float (&v)[V][4]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (owns(i, nvec)) load4(row + column(i), v[i]);
    else v[i][0] = v[i][1] = v[i][2] = v[i][3] = 0.f;
  }
}

// (mean, 1 / sqrt(biased variance + eps)) of a row held in v
template <int V>
__device__ __forceinline__ float2 ln_stats(const float (&v)[V][4], int nvec,
                                           int D, float eps, float* red) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) s += (v[i][0] + v[i][1]) + (v[i][2] + v[i][3]);
  const float mean = block_sum(s, red) / static_cast<float>(D);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (!owns(i, nvec)) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float d = v[i][k] - mean;
      q = fmaf(d, d, q);
    }
  }
  const float var = block_sum(q, red) / static_cast<float>(D);
  return make_float2(mean, rsqrtf(var + eps));
}

// _layer_norm(x) * (1 + scale) + shift, each step rounded as the plain
// path's tensors are
__device__ __forceinline__ float modulate(float x, float2 st, float shift,
                                          float scale) {
  const float n = __fmul_rn(__fsub_rn(x, st.x), st.y);
  return __fadd_rn(__fmul_rn(n, __fadd_rn(1.f, scale)), shift);
}

// One pass's operands. Stream rows are [B, L, D] with strides (sb, sl, 1);
// the modulation rows are [B, D] with stride e_sb (0: one row for all);
// outputs are contiguous [B * L, D].
struct StreamArgs {
  const float* x; long long x_sb, x_sl;    // the fp32 stream
  const bf16* y; long long y_sb, y_sl;     // a branch's bf16 output
  const float* e_a; const float* e_b;      // shift and scale, or the gate
  long long e_sb;
  const void* w; const void* bias; int p_f32;  // norm3's scale and bias
  float* xo;                               // the new stream
  bf16* out;                               // the next branch's bf16 input
  int L, D;
  float eps;
};

template <int V>
__global__ void __launch_bounds__(kMaxThreads)
dit_ln_modulate_kernel(const StreamArgs a) {
  __shared__ float red[32];
  const int nvec = a.D >> 2;
  const long long row = blockIdx.x, b = row / a.L, l = row - b * a.L;
  float v[V][4];
  load_row<V>(a.x + b * a.x_sb + l * a.x_sl, nvec, v);
  const float2 st = ln_stats<V>(v, nvec, a.D, a.eps, red);
  const float* shift = a.e_a + b * a.e_sb;
  const float* scale = a.e_b + b * a.e_sb;
  bf16* out = a.out + row * a.D;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (!owns(i, nvec)) continue;
    const int c = column(i);
    float sh[4], sc[4], o[4];
    load4(shift + c, sh);
    load4(scale + c, sc);
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = modulate(v[i][k], st, sh[k], sc[k]);
    store4(out + c, o);
  }
}

// x + y * gate into xo and v (the plain path's `x.float() + y.float() * e2`)
template <int V>
__device__ __forceinline__ void gated_add(const StreamArgs& a, long long b,
                                          long long l, long long row,
                                          int nvec, float (&v)[V][4]) {
  load_row<V>(a.x + b * a.x_sb + l * a.x_sl, nvec, v);
  const bf16* y = a.y + b * a.y_sb + l * a.y_sl;
  const float* gate = a.e_a + b * a.e_sb;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (!owns(i, nvec)) continue;
    const int c = column(i);
    float yv[4], g[4];
    load4(y + c, yv);
    load4(gate + c, g);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[i][k] = __fadd_rn(v[i][k], __fmul_rn(yv[k], g[k]));
    store4(a.xo + row * a.D + c, v[i]);
  }
}

template <int V>
__global__ void __launch_bounds__(kMaxThreads)
dit_gate_residual_ln_kernel(const StreamArgs a) {
  __shared__ float red[32];
  const int nvec = a.D >> 2;
  const long long row = blockIdx.x, b = row / a.L, l = row - b * a.L;
  float v[V][4];
  gated_add<V>(a, b, l, row, nvec, v);
  bf16* out = a.out + row * a.D;
  if (a.w == nullptr) {                  // no cross-attention norm
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (owns(i, nvec)) store4(out + column(i), v[i]);
    return;
  }
  const float2 st = ln_stats<V>(v, nvec, a.D, a.eps, red);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (!owns(i, nvec)) continue;
    const int c = column(i);
    float w[4], bias[4], o[4];
    load4(a.w, a.p_f32, c, w);
    load4(a.bias, a.p_f32, c, bias);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float n = __fmul_rn(__fsub_rn(v[i][k], st.x), st.y);
      o[k] = __fadd_rn(__fmul_rn(n, w[k]), bias[k]);
    }
    store4(out + c, o);
  }
}

template <int V>
__global__ void __launch_bounds__(kMaxThreads)
dit_residual_ln_modulate_kernel(const StreamArgs a) {
  __shared__ float red[32];
  const int nvec = a.D >> 2;
  const long long row = blockIdx.x, b = row / a.L, l = row - b * a.L;
  float v[V][4];
  load_row<V>(a.x + b * a.x_sb + l * a.x_sl, nvec, v);
  const bf16* y = a.y + b * a.y_sb + l * a.y_sl;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (!owns(i, nvec)) continue;
    const int c = column(i);
    float yv[4];
    load4(y + c, yv);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[i][k] = __fadd_rn(v[i][k], yv[k]);
    store4(a.xo + row * a.D + c, v[i]);
  }
  const float2 st = ln_stats<V>(v, nvec, a.D, a.eps, red);
  const float* shift = a.e_a + b * a.e_sb;
  const float* scale = a.e_b + b * a.e_sb;
  bf16* out = a.out + row * a.D;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (!owns(i, nvec)) continue;
    const int c = column(i);
    float sh[4], sc[4], o[4];
    load4(shift + c, sh);
    load4(scale + c, sc);
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = modulate(v[i][k], st, sh[k], sc[k]);
    store4(out + c, o);
  }
}

template <int V>
__global__ void __launch_bounds__(kMaxThreads)
dit_gate_residual_kernel(const StreamArgs a) {
  const int nvec = a.D >> 2;
  const long long row = blockIdx.x, b = row / a.L, l = row - b * a.L;
  float v[V][4];
  gated_add<V>(a, b, l, row, nvec, v);
}

// q and k [B, L, D] bf16 with strides (sb, sl, 1) (k null: q alone);
// outputs contiguous. RoPE tables [B, L, hd / 2] fp32 with strides (t_sb,
// t_sl, 1), t_sb 0 for one table for the batch; cos null: no rotation.
struct QKArgs {
  const bf16* src[2]; long long s_sb[2], s_sl[2];
  const void* w[2]; int w_f32;
  bf16* dst[2];
  const float* cos; const float* sin; long long t_sb, t_sl;
  int L, D, hd;
  float eps;
};

// The sums of v.x and of v.y over the CTA, in every thread.
__device__ __forceinline__ float2 block_sum2(float2 v, float2* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane]
                                                : make_float2(0.f, 0.f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  return v;
}

// _rms_norm's scaled row times w, rounded to bf16, then rotated as
// apply_rope does ((a c - b s, a s + b c) of each consecutive pair in fp32,
// rounded to bf16) when the tables are given, into out
template <int V>
__device__ __forceinline__ void norm_rope_store(
    const float (&v)[V][4], float r, const void* weight, const QKArgs& a,
    long long t_row, int nvec, bf16* out) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (!owns(i, nvec)) continue;
    const int c = column(i);
    float w[4], n[4];
    load4(weight, a.w_f32, c, w);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      n[k] = round_bf16(__fmul_rn(__fmul_rn(v[i][k], r), w[k]));
    if (a.cos != nullptr) {
      const int h0 = c % a.hd;           // c's channel in its head
      const int h1 = h0 + 2 == a.hd ? 0 : h0 + 2;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const long long f = t_row + ((p ? h1 : h0) >> 1);
        const float cs = a.cos[f], sn = a.sin[f];
        const float x0 = n[2 * p], x1 = n[2 * p + 1];
        n[2 * p] = __fsub_rn(__fmul_rn(x0, cs), __fmul_rn(x1, sn));
        n[2 * p + 1] = __fadd_rn(__fmul_rn(x0, sn), __fmul_rn(x1, cs));
      }
    }
    store4(out + c, n);
  }
}

// One CTA a token: its q and k rows in flight together and their two mean
// squares in one reduction.
template <int V>
__global__ void __launch_bounds__(kMaxThreads)
dit_qk_norm_rope_kernel(const QKArgs a) {
  __shared__ float2 red[32];
  const int nvec = a.D >> 2;
  const long long row = blockIdx.x, b = row / a.L, l = row - b * a.L;
  const bool has_k = a.src[1] != nullptr;
  float vq[V][4], vk[V][4];
  load_row<V>(a.src[0] + b * a.s_sb[0] + l * a.s_sl[0], nvec, vq);
  if (has_k) load_row<V>(a.src[1] + b * a.s_sb[1] + l * a.s_sl[1], nvec, vk);
  float2 ss = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < V; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ss.x = fmaf(vq[i][k], vq[i][k], ss.x);
      if (has_k) ss.y = fmaf(vk[i][k], vk[i][k], ss.y);
    }
  // _rms_norm: x * rsqrt(mean(x^2) + eps)
  ss = block_sum2(ss, red);
  const float inv_d = 1.f / static_cast<float>(a.D);
  const long long t_row = b * a.t_sb + l * a.t_sl;
  norm_rope_store<V>(vq, rsqrtf(ss.x * inv_d + a.eps), a.w[0], a, t_row,
                     nvec, a.dst[0] + row * a.D);
  if (has_k)
    norm_rope_store<V>(vk, rsqrtf(ss.y * inv_d + a.eps), a.w[1], a, t_row,
                       nvec, a.dst[1] + row * a.D);
}

bool bad_shape(int B, int L, int D, int vec, int threads) {
  return B <= 0 || L <= 0 || D <= 0 || D % 4 || vec < 1 || vec > kMaxVec ||
         threads < 32 || threads > kMaxThreads || threads % 32 ||
         static_cast<long long>(vec) * threads * 4 < D ||
         static_cast<long long>(B) * L > 0x7fffffffLL;
}

}  // namespace

#define DIT_LAUNCH(KERNEL, VEC, GRID, THREADS, STREAM, ARGS)              \
  do {                                                                    \
    switch (VEC) {                                                        \
      case 1: KERNEL<1><<<GRID, THREADS, 0, STREAM>>>(ARGS); break;       \
      case 2: KERNEL<2><<<GRID, THREADS, 0, STREAM>>>(ARGS); break;       \
      case 3: KERNEL<3><<<GRID, THREADS, 0, STREAM>>>(ARGS); break;       \
      case 4: KERNEL<4><<<GRID, THREADS, 0, STREAM>>>(ARGS); break;       \
      case 5: KERNEL<5><<<GRID, THREADS, 0, STREAM>>>(ARGS); break;       \
      case 6: KERNEL<6><<<GRID, THREADS, 0, STREAM>>>(ARGS); break;       \
      case 7: KERNEL<7><<<GRID, THREADS, 0, STREAM>>>(ARGS); break;       \
      case 8: KERNEL<8><<<GRID, THREADS, 0, STREAM>>>(ARGS); break;       \
      default: return static_cast<int>(cudaErrorInvalidValue);            \
    }                                                                     \
  } while (0)

// Every entry point takes the row shape (B, L, D), `vec` 16-byte vectors a
// thread and `threads` a CTA (vec * threads * 4 >= D), and returns the
// launch's cudaGetLastError(). The wrapper (`ops/dit_fused.py`) checks
// dtypes, shapes, strides and alignment.

// out = bf16(LN(x) * (1 + scale) + shift)
extern "C" int dit_ln_modulate(
    const float* x, long long x_sb, long long x_sl, const float* shift,
    const float* scale, long long e_sb, void* out, int B, int L, int D,
    int vec, int threads, float eps, void* stream) {
  if (bad_shape(B, L, D, vec, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  StreamArgs a = {};
  a.x = x; a.x_sb = x_sb; a.x_sl = x_sl;
  a.e_a = shift; a.e_b = scale; a.e_sb = e_sb;
  a.out = static_cast<bf16*>(out);
  a.L = L; a.D = D; a.eps = eps;
  DIT_LAUNCH(dit_ln_modulate_kernel, vec, B * L, threads,
             static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
}

// q, k -> bf16(RMSNorm(.) * w) rotated by (cos, sin) when cos is not null;
// k null: q alone
extern "C" int dit_qk_norm_rope(
    const void* q, long long q_sb, long long q_sl, const void* k,
    long long k_sb, long long k_sl, const void* w_q, const void* w_k,
    int w_f32, const float* cos, const float* sin, long long t_sb,
    long long t_sl, void* q_out, void* k_out, int B, int L, int D, int hd,
    int vec, int threads, float eps, void* stream) {
  if (bad_shape(B, L, D, vec, threads) || hd <= 0 || hd % 2 || D % hd ||
      (k != nullptr && (w_k == nullptr || k_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  QKArgs a = {};
  a.src[0] = static_cast<const bf16*>(q); a.s_sb[0] = q_sb; a.s_sl[0] = q_sl;
  a.src[1] = static_cast<const bf16*>(k); a.s_sb[1] = k_sb; a.s_sl[1] = k_sl;
  a.w[0] = w_q; a.w[1] = w_k; a.w_f32 = w_f32;
  a.dst[0] = static_cast<bf16*>(q_out); a.dst[1] = static_cast<bf16*>(k_out);
  a.cos = cos; a.sin = sin; a.t_sb = t_sb; a.t_sl = t_sl;
  a.L = L; a.D = D; a.hd = hd; a.eps = eps;
  DIT_LAUNCH(dit_qk_norm_rope_kernel, vec, B * L, threads,
             static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
}

// x_out = x + y * gate; nx = bf16(LN(x_out) * w + bias), or bf16(x_out)
// when w is null
extern "C" int dit_gate_residual_ln(
    const float* x, long long x_sb, long long x_sl, const void* y,
    long long y_sb, long long y_sl, const float* gate, long long e_sb,
    const void* w, const void* bias, int p_f32, float* x_out, void* nx,
    int B, int L, int D, int vec, int threads, float eps, void* stream) {
  if (bad_shape(B, L, D, vec, threads) || (w != nullptr && bias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  StreamArgs a = {};
  a.x = x; a.x_sb = x_sb; a.x_sl = x_sl;
  a.y = static_cast<const bf16*>(y); a.y_sb = y_sb; a.y_sl = y_sl;
  a.e_a = gate; a.e_sb = e_sb;
  a.w = w; a.bias = bias; a.p_f32 = p_f32;
  a.xo = x_out; a.out = static_cast<bf16*>(nx);
  a.L = L; a.D = D; a.eps = eps;
  DIT_LAUNCH(dit_gate_residual_ln_kernel, vec, B * L, threads,
             static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
}

// x_out = x + y; tx = bf16(LN(x_out) * (1 + scale) + shift)
extern "C" int dit_residual_ln_modulate(
    const float* x, long long x_sb, long long x_sl, const void* y,
    long long y_sb, long long y_sl, const float* shift, const float* scale,
    long long e_sb, float* x_out, void* tx, int B, int L, int D, int vec,
    int threads, float eps, void* stream) {
  if (bad_shape(B, L, D, vec, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  StreamArgs a = {};
  a.x = x; a.x_sb = x_sb; a.x_sl = x_sl;
  a.y = static_cast<const bf16*>(y); a.y_sb = y_sb; a.y_sl = y_sl;
  a.e_a = shift; a.e_b = scale; a.e_sb = e_sb;
  a.xo = x_out; a.out = static_cast<bf16*>(tx);
  a.L = L; a.D = D; a.eps = eps;
  DIT_LAUNCH(dit_residual_ln_modulate_kernel, vec, B * L, threads,
             static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
}

// x_out = x + h * gate
extern "C" int dit_gate_residual(
    const float* x, long long x_sb, long long x_sl, const void* h,
    long long h_sb, long long h_sl, const float* gate, long long e_sb,
    float* x_out, int B, int L, int D, int vec, int threads, void* stream) {
  if (bad_shape(B, L, D, vec, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  StreamArgs a = {};
  a.x = x; a.x_sb = x_sb; a.x_sl = x_sl;
  a.y = static_cast<const bf16*>(h); a.y_sb = h_sb; a.y_sl = h_sl;
  a.e_a = gate; a.e_sb = e_sb;
  a.xo = x_out;
  a.L = L; a.D = D;
  DIT_LAUNCH(dit_gate_residual_kernel, vec, B * L, threads,
             static_cast<cudaStream_t>(stream), a);
  return static_cast<int>(cudaGetLastError());
}
