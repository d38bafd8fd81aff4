// Chunked RWKV6 WKV scan: per-channel data-dependent decay, bonus u.
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py:rwkv6_scan (_kernel)
// and computes the recurrence of the model's rwkv block
// (repro/models/ssm.py:_wkv_scan) on the model's own layout:
//
//   r, k, v, w [N, S, H, hd] (strided; last dim contiguous), u [Nu, H, hd],
//   s0 [N, H, hd, hd] (optional), y [N, S, H, hd] f32, s_fin [N, H, hd, hd]
//
// with  y_t = r_t . (S + diag(u) k_t^T v_t),  S <- diag(w_t) S + k_t^T v_t
// (S indexed [key channel c][value channel j]).  Row n of r takes u's row
// n / (N / Nu).  r, k, v are float32 or bfloat16 (converted exactly to
// float32 on load), w, u and the state float32.  Two extensions over the
// TPU kernel, both needed by serving: an initial state s0 (null: zeros) and
// any S (the ragged last chunk is masked in the loops, never padded).
// s_fin may be s0 itself: one CTA owns one (n, h), reads its state before
// the first chunk and writes it after the last, so the cache's state is
// updated in place.
//
// The chunked form per chunk of Lc <= L rows (as the TPU kernel):
//   logw = log(max(w, 1e-38)); cum = inclusive cumsum over the chunk,
//   cum_prev = exclusive cumsum (the running sum before row t);
//   y_t  = (r_t * exp(cum_prev_t)) . S                         inter-chunk
//        + sum_{s<t} A[t,s] v_s,  A[t,s] = sum_c r_tc k_sc
//                                   exp(min(cum_prev_tc - cum_sc, 0))
//        + (r_t . (u * k_t)) v_t                                 bonus
//   S    = exp(cum_last) * S + (k * exp(cum_last - cum))^T v
// Every exponent is <= 0, so nothing overflows; strong decay underflows
// to 0, which is the right limit.
//
// Bound on an H100 (rwkv6-3b serve prefill: N = 32 rows of 1024 tokens, H =
// 5 heads of 64 per rank): bytes are bf16 r, k, v and f32 w read once, f32 y
// written once (~150 MB, 0.045 ms at 3.35 TB/s).  The operations are
// ~(L/2 + 2 hd) multiply-adds and L/2 exps per output element, float32
// outside the tensor cores: 3.7 GFLOP, 0.055 ms at 67 TFLOP/s, so
// operations bound it, just.  What the design does: one CTA per (n, h)
// looping over its chunks of L = 32 rows with the [hd, hd] float32 state
// in shared memory;
// the chunk's r, k, v, cum and cum_prev are staged beside it (rows padded by
// one float so that column walks across threads hit distinct banks);
// one thread per channel forms the cumsum; the pairs (t, s) are formed
// one thread each from exp(min(cum_prev - cum, 0)).  The products are plain
// float32 FMA loops: no tensor cores, no library call.
// Not yet: mma for the chunk products, more than one CTA per (n, h).
//
// Plain C interface, built with nvcc for sm_90a and loaded with ctypes.  The
// entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 32;          // chunk length
constexpr int THREADS = 256;

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;
  float* y;
  float* s_out;
  int n, s, h, hd, nu;
  long long r_sn, r_ss, r_sh;
  long long k_sn, k_ss, k_sh;
  long long v_sn, v_ss, v_sh;
  long long w_sn, w_ss, w_sh;
  long long u_sn, u_sh;
};

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) rwkv6_kernel(Params p) {
  extern __shared__ float sm[];
  const int hd = p.hd;
  const int ld = hd + 1;                   // padded row stride
  float* st = sm;                          // [hd][hd] state S[c][j]
  float* rr = st + hd * hd;                // [L][ld] r, then r * exp(cum_prev)
  float* kk = rr + L * ld;                 // [L][ld] k, then k * exp(last-cum)
  float* vv = kk + L * ld;                 // [L][ld] v
  float* cm = vv + L * ld;                 // [L][ld] logw, then cum
  float* cp = cm + L * ld;                 // [L][ld] cum_prev
  float* aa = cp + L * ld;                 // [L][L] A (diagonal = bonus)
  float* uu = aa + L * L;                  // [hd]

  const int nh = blockIdx.x;
  const int n = nh / p.h, h = nh % p.h;
  const int tid = threadIdx.x;
  const int hh = hd * hd;

  const float* s0 = p.s0 ? p.s0 + (long long)nh * hh : nullptr;
  for (int i = tid; i < hh; i += THREADS) st[i] = s0 ? s0[i] : 0.f;
  const int nu = n / (p.n / p.nu);
  for (int c = tid; c < hd; c += THREADS)
    uu[c] = p.u[nu * p.u_sn + h * p.u_sh + c];

  const T* rg = static_cast<const T*>(p.r) + n * p.r_sn + h * p.r_sh;
  const T* kg = static_cast<const T*>(p.k) + n * p.k_sn + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + n * p.v_sn + h * p.v_sh;
  const float* wg = p.w + n * p.w_sn + h * p.w_sh;
  float* yg = p.y + ((long long)n * p.s * p.h + h) * hd;
  const long long y_ss = (long long)p.h * hd;

  for (int c0 = 0; c0 < p.s; c0 += L) {
    const int lc = min(L, p.s - c0);       // rows of this chunk
    __syncthreads();                        // the last chunk's readers done
    for (int i = tid; i < lc * hd; i += THREADS) {
      const int t = i / hd, c = i % hd;
      const long long row = c0 + t;
      rr[t * ld + c] = to_f32<T>(rg[row * p.r_ss + c]);
      kk[t * ld + c] = to_f32<T>(kg[row * p.k_ss + c]);
      vv[t * ld + c] = to_f32<T>(vg[row * p.v_ss + c]);
      cm[t * ld + c] = logf(fmaxf(wg[row * p.w_ss + c], 1e-38f));
    }
    __syncthreads();
    // the per-channel cumsum, one thread per channel
    for (int c = tid; c < hd; c += THREADS) {
      float run = 0.f;
      for (int t = 0; t < lc; ++t) {
        cp[t * ld + c] = run;
        run += cm[t * ld + c];
        cm[t * ld + c] = run;
      }
    }
    __syncthreads();
    // A[t, s] for s < t, the bonus on the diagonal
    for (int i = tid; i < lc * lc; i += THREADS) {
      const int t = i / lc, s = i % lc;
      float acc = 0.f;
      if (s < t) {
        for (int c = 0; c < hd; ++c)
          acc += rr[t * ld + c] * kk[s * ld + c] *
                 expf(fminf(cp[t * ld + c] - cm[s * ld + c], 0.f));
      } else if (s == t) {
        for (int c = 0; c < hd; ++c)
          acc += rr[t * ld + c] * uu[c] * kk[t * ld + c];
      }
      aa[t * L + s] = acc;
    }
    __syncthreads();
    // r * exp(cum_prev) and k * exp(cum_last - cum), in place
    for (int i = tid; i < lc * hd; i += THREADS) {
      const int t = i / hd, c = i % hd;
      rr[t * ld + c] *= expf(cp[t * ld + c]);
      kk[t * ld + c] *= expf(cm[(lc - 1) * ld + c] - cm[t * ld + c]);
    }
    __syncthreads();
    // y = rdec @ S + A @ v
    for (int i = tid; i < lc * hd; i += THREADS) {
      const int t = i / hd, j = i % hd;
      float acc = 0.f;
      for (int c = 0; c < hd; ++c) acc += rr[t * ld + c] * st[c * hd + j];
      for (int s = 0; s <= t; ++s) acc += aa[t * L + s] * vv[s * ld + j];
      yg[(long long)(c0 + t) * y_ss + j] = acc;
    }
    __syncthreads();
    // S = exp(cum_last) S + kdec^T v
    for (int i = tid; i < hh; i += THREADS) {
      const int c = i / hd, j = i % hd;
      float acc = expf(cm[(lc - 1) * ld + c]) * st[i];
      for (int s = 0; s < lc; ++s) acc += kk[s * ld + c] * vv[s * ld + j];
      st[i] = acc;
    }
  }
  __syncthreads();
  float* so = p.s_out + (long long)nh * hh;
  for (int i = tid; i < hh; i += THREADS) so[i] = st[i];
}

size_t smem_bytes(int hd) {
  return sizeof(float) *
         ((size_t)hd * hd + 5 * (size_t)L * (hd + 1) + L * L + hd);
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.hd);
  cudaError_t e = cudaFuncSetAttribute(
      rwkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  rwkv6_kernel<T><<<p.n * p.h, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rwkv6_scan(
    int dtype, const void* r, const void* k, const void* v, const float* w,
    const float* u, const float* s0, float* y, float* s_out, int n, int s,
    int h, int hd, int nu, long long r_sn, long long r_ss, long long r_sh,
    long long k_sn, long long k_ss, long long k_sh, long long v_sn,
    long long v_ss, long long v_sh, long long w_sn, long long w_ss,
    long long w_sh, long long u_sn, long long u_sh, void* stream) {
  Params p{r,    k,    v,    w,    u,    s0,   y,    s_out, n,    s,
           h,    hd,   nu,   r_sn, r_ss, r_sh, k_sn, k_ss,  k_sh, v_sn,
           v_ss, v_sh, w_sn, w_ss, w_sh, u_sn, u_sh};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
