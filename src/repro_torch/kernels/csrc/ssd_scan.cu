// Chunked Mamba2 SSD scan: scalar per-head decay, B and C shared by the
// heads of a row.
//
// Replaces the TPU kernel repro/kernels/ssd_mamba2.py:ssd_scan (_kernel) and
// computes the recurrence of the model's mamba block
// (repro/models/ssm.py:_ssd_chunked) on the model's own layout:
//
//   x [N, S, H, P], dt [N, S, H] (softplus'ed), a [Na, H] (> 0),
//   B, C [N, S, Ns] (strided; last dim contiguous), s0 [N, H, Ns, P]
//   (optional), y [N, S, H, P] f32, s_fin [N, H, Ns, P] f32
//
// with  S_t = exp(-dt_t a) S_{t-1} + B_t^T (dt_t x_t),  y_t = C_t S_t.
// Row n takes a's row n / (N / Na).  B and C are indexed by row: the heads
// of a row read the same B and C, so the [N*H, S, Ns] broadcast copy the
// TPU wrapper takes is never built.  x, B and C are float32 or bfloat16
// (converted exactly on load, each with its own type code), dt, a and the
// state float32.  As in rwkv6_scan.cu: an initial state s0 (null: zeros),
// any S (the ragged last chunk is masked in the loops), and s_fin may be s0
// itself (one CTA owns one (n, h)), so the cache is updated in place.
//
// Per chunk of Lc <= L rows (as the TPU kernel):
//   cum = inclusive cumsum of -dt a;  xb = x * dt
//   y   = (C B^T * exp(min(cum_t - cum_s, 0)) * [s <= t]) xb      intra
//       + (C * exp(cum)) S                                      inter
//   S   = exp(cum_last) S + (B * exp(cum_last - cum))^T xb
// (the mask includes the diagonal: y_t sees its own input).
//
// Bound on an H100 (zamba2-1.2b serve prefill: N = 32 rows of 1024 tokens,
// H = 8 heads of P = 64 per rank, Ns = 64): bf16 x, B, C and f32 dt read
// once, f32 y written once (~150 MB, 0.045 ms at 3.35 TB/s).  The products
// are ~(L + 2 Ns + 2 L Ns / P) FMAs per output element, float32 outside the
// tensor cores: ~8 GFLOP, ~0.12 ms at 67 TFLOP/s, so operations bound it.
// What the design does: one CTA per (n, h) looping over chunks of L = 64
// rows with the [Ns, P] float32 state in shared memory, the chunk's xb, B,
// C and the [L, L] decayed C B^T staged beside it (rows padded by one float
// so that column walks across threads hit distinct banks); each thread
// forms its own outputs with float32 FMA loops.  No tensor cores, no
// library call.  Not yet: mma.sync/wgmma for the three chunk products,
// sharing C B^T between the heads of a row.
//
// Plain C interface, built with nvcc for sm_90a and loaded with ctypes.  The
// entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 64;          // chunk length
constexpr int THREADS = 256;

struct Params {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* s0;
  float* y;
  float* s_out;
  int n, s, h, p, ns, na;
  long long x_sn, x_ss, x_sh;
  long long dt_sn, dt_ss, dt_sh;
  long long a_sn, a_sh;
  long long b_sn, b_ss;
  long long c_sn, c_ss;
};

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(THREADS) ssd_kernel(Params p) {
  extern __shared__ float sm[];
  const int P = p.p, NS = p.ns;
  const int lp = P + 1, ln = NS + 1;       // padded row strides
  float* st = sm;                          // [NS][P] state
  float* xb = st + NS * P;                 // [L][lp] x * dt
  float* bb = xb + L * lp;                 // [L][ln] B, then B*exp(last-cum)
  float* cc = bb + L * ln;                 // [L][ln] C
  float* mm = cc + L * ln;                 // [L][L] masked decayed C B^T
  float* cum = mm + L * L;                 // [L]

  const int nh = blockIdx.x;
  const int n = nh / p.h, h = nh % p.h;
  const int tid = threadIdx.x;
  const int sp = NS * P;

  const float* s0 = p.s0 ? p.s0 + (long long)nh * sp : nullptr;
  for (int i = tid; i < sp; i += THREADS) st[i] = s0 ? s0[i] : 0.f;
  const float a = p.a[(n / (p.n / p.na)) * p.a_sn + h * p.a_sh];

  const TX* xg = static_cast<const TX*>(p.x) + n * p.x_sn + h * p.x_sh;
  const float* dg = p.dt + n * p.dt_sn + h * p.dt_sh;
  const TB* bg = static_cast<const TB*>(p.b) + n * p.b_sn;
  const TB* cg = static_cast<const TB*>(p.c) + n * p.c_sn;
  float* yg = p.y + ((long long)n * p.s * p.h + h) * P;
  const long long y_ss = (long long)p.h * P;

  for (int c0 = 0; c0 < p.s; c0 += L) {
    const int lc = min(L, p.s - c0);
    __syncthreads();                        // the last chunk's readers done
    for (int i = tid; i < lc * P; i += THREADS) {
      const int t = i / P, j = i % P;
      const long long row = c0 + t;
      xb[t * lp + j] = to_f32<TX>(xg[row * p.x_ss + j]) * dg[row * p.dt_ss];
    }
    for (int i = tid; i < lc * NS; i += THREADS) {
      const int t = i / NS, j = i % NS;
      const long long row = c0 + t;
      bb[t * ln + j] = to_f32<TB>(bg[row * p.b_ss + j]);
      cc[t * ln + j] = to_f32<TB>(cg[row * p.c_ss + j]);
    }
    if (tid == 0) {
      float run = 0.f;
      for (int t = 0; t < lc; ++t) {
        run += -dg[(long long)(c0 + t) * p.dt_ss] * a;
        cum[t] = run;
      }
    }
    __syncthreads();
    // M[t, s] = (C_t . B_s) exp(min(cum_t - cum_s, 0)) for s <= t
    for (int i = tid; i < lc * lc; i += THREADS) {
      const int t = i / lc, s = i % lc;
      float acc = 0.f;
      if (s <= t) {
        for (int j = 0; j < NS; ++j) acc += cc[t * ln + j] * bb[s * ln + j];
        acc *= expf(fminf(cum[t] - cum[s], 0.f));
      }
      mm[t * L + s] = acc;
    }
    __syncthreads();
    // y = M xb + (C * exp(cum)) S, then B * exp(cum_last - cum) in place
    for (int i = tid; i < lc * P; i += THREADS) {
      const int t = i / P, j = i % P;
      float acc = 0.f;
      for (int s = 0; s <= t; ++s) acc += mm[t * L + s] * xb[s * lp + j];
      float inter = 0.f;
      for (int q = 0; q < NS; ++q) inter += cc[t * ln + q] * st[q * P + j];
      yg[(long long)(c0 + t) * y_ss + j] = acc + expf(cum[t]) * inter;
    }
    const float last = cum[lc - 1];
    for (int i = tid; i < lc * NS; i += THREADS) {
      const int t = i / NS, j = i % NS;
      bb[t * ln + j] *= expf(last - cum[t]);
    }
    __syncthreads();
    // S = exp(cum_last) S + bdec^T xb
    const float dec = expf(last);
    for (int i = tid; i < sp; i += THREADS) {
      const int q = i / P, j = i % P;
      float acc = dec * st[i];
      for (int s = 0; s < lc; ++s) acc += bb[s * ln + q] * xb[s * lp + j];
      st[i] = acc;
    }
  }
  __syncthreads();
  float* so = p.s_out + (long long)nh * sp;
  for (int i = tid; i < sp; i += THREADS) so[i] = st[i];
}

size_t smem_bytes(int pdim, int ns) {
  return sizeof(float) * ((size_t)ns * pdim + (size_t)L * (pdim + 1) +
                          2 * (size_t)L * (ns + 1) + L * L + L);
}

template <typename TX, typename TB>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.p, p.ns);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel<TX, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_kernel<TX, TB><<<p.n * p.h, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_scan(
    int x_dtype, int bc_dtype, const void* x, const float* dt, const float* a,
    const void* b, const void* c, const float* s0, float* y, float* s_out,
    int n, int s, int h, int pdim, int ns, int na, long long x_sn,
    long long x_ss, long long x_sh, long long dt_sn, long long dt_ss,
    long long dt_sh, long long a_sn, long long a_sh, long long b_sn,
    long long b_ss, long long c_sn, long long c_ss, void* stream) {
  Params p{x,    dt,    a,     b,     c,     s0,    y,     s_out, n,
           s,    h,     pdim,  ns,    na,    x_sn,  x_ss,  x_sh,  dt_sn,
           dt_ss, dt_sh, a_sn, a_sh,  b_sn,  b_ss,  c_sn,  c_ss};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && bc_dtype == 0) return launch<float, float>(p, st);
  if (x_dtype == 0 && bc_dtype == 1)
    return launch<float, __nv_bfloat16>(p, st);
  if (x_dtype == 1 && bc_dtype == 0)
    return launch<__nv_bfloat16, float>(p, st);
  if (x_dtype == 1 && bc_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
