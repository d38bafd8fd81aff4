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
// any S (the ragged last chunk is zero-padded in shared memory, never in
// device memory).  s_fin may be s0 itself: every column of a state is
// owned by one CTA, which reads it before the first chunk and writes it
// after the last, so the cache's state is updated in place.
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
// operations bound it, just.  The chunks of one (n, h) depend on each
// other through S, so the card fills only with several CTAs per (n, h)
// and several (n, h) per SM; and the chunk's products are so small that
// shared-memory bandwidth, not the FMA units, is what they wait on.  What
// the design does (rwkv6_chunk_kernel):
//   * a thread-block cluster of CLUSTER CTAs per (n, h), CTA_THREADS
//     threads each (320 CTAs of 8 warps at the serve prefill: 2-3 per SM,
//     16-24 warps).  The value columns of the state are independent, so
//     each CTA owns hd / CLUSTER columns of S (in shared memory) and of
//     y.  The pairwise matrix A does not depend on the column: each CTA
//     forms 1 / CLUSTER of its pairs and stores them into every CTA's A
//     through distributed shared memory, double-buffered by chunk parity
//     so that one barrier.cluster per chunk orders the writes and the
//     reads (and none is needed at exit: every remote write precedes the
//     last chunk's barrier);
//   * only the pairs s <= t are formed (a table of them is built once),
//     eight lanes per pair over the channels (16-byte shared loads, a
//     shuffle reduction), so no lane idles on the upper triangle;
//   * the chunk's rows are the 32 lanes of a warp: each lane loads its row
//     (8- or 16-byte loads) and the per-channel cumsum is a shuffle scan
//     across the lanes, not 32 serial steps;
//   * y and the state update are register-tiled, 4 x 4 outputs a thread
//     (two 16-byte shared loads per 16 FMAs, r_dec kept transposed for
//     that), and run at once: half the threads form y's two partial sums
//     (half the channels and half the pairs each) from the current state,
//     the other half the next state into a second buffer;
//   * hd = 64 (the models') is a template constant, so the loops unroll;
//   * the next chunk's r, k, v and w are loaded into registers while the
//     current chunk computes (PREFETCH).
// Measured choices (PERF.md section 6, kernels/variants.py): clusters of 2
// x 256 threads over 4 x 128 and 1 x 512; the 4 x 4 tiles over one row
// of four columns a thread (0.68 -> 0.50 ms on an NVIDIA H100 80GB
// HBM3 at 700.00 W).
// Decode (S = 1, rwkv6_decode_kernel): no pairs; one pass over the state,
// y = r (S + diag(u) k^T v) and S <- w S + k^T v, 32 columns per CTA, 8
// warps over the rows; the bound is the state's bytes (5.2 MB read and
// written at the serve: 0.0016 ms).
//
// Plain C interface, built with nvcc for sm_90a and loaded with ctypes.  The
// entry returns cudaGetLastError() after its launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int L = 32;                // chunk length: the lanes of a warp
constexpr int CLUSTER = 2;           // CTAs per (n, h)
constexpr int CTA_THREADS = 256;
constexpr int MIN_CTAS_PER_SM = 3;   // registers: <= 65536 / (3 x 256)
constexpr bool PREFETCH = true;      // next chunk's loads in flight
constexpr int SPLIT = 8;             // lanes per pair of A
constexpr int DECODE_THREADS = 256;

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
  int vec;   // hd % 4 == 0, every row of r, k, v, w aligned for quads
};

// Four consecutive elements of a row, raw: 8 bytes of bf16 or a float4.
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  using raw = float4;
};
template <>
struct Quad<__nv_bfloat16> {
  using raw = uint2;
};

__device__ __forceinline__ float4 f4(float a) { return make_float4(a, a, a, a); }

__device__ __forceinline__ float4 to_f4(float4 x) { return x; }
__device__ __forceinline__ float4 to_f4(uint2 x) {
  return make_float4(__uint_as_float(x.x << 16),
                     __uint_as_float(x.x & 0xffff0000u),
                     __uint_as_float(x.y << 16),
                     __uint_as_float(x.y & 0xffff0000u));
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Elements c .. c+3 of a row of hd (zero beyond it).
template <typename T>
__device__ __forceinline__ typename Quad<T>::raw load_quad(const T* row,
                                                           int c, int hd,
                                                           bool vec) {
  if constexpr (std::is_same_v<T, float>) {
    if (vec) return *reinterpret_cast<const float4*>(row + c);
    return make_float4(row[c], c + 1 < hd ? row[c + 1] : 0.f,
                       c + 2 < hd ? row[c + 2] : 0.f,
                       c + 3 < hd ? row[c + 3] : 0.f);
  } else {
    if (vec) return *reinterpret_cast<const uint2*>(row + c);
    unsigned e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      e[i] = c + i < hd ? __bfloat16_as_ushort(row[c + i]) : 0u;
    return make_uint2(e[0] | e[1] << 16, e[2] | e[3] << 16);
  }
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

__device__ __forceinline__ float scan32(float x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__device__ __forceinline__ float safe_log(float w) {
  return logf(fmaxf(w, 1e-38f));
}

// Shared memory of a CTA, in floats (every region a multiple of 4).
constexpr int LDT = L + 4;           // row stride of r_dec transposed
constexpr int PAIRS = L * (L + 1) / 2;

struct Layout {
  int hd4, ld, cq4, ldv;
  __host__ __device__ Layout(int hd, int c) {
    hd4 = (hd + 3) / 4;
    ld = 4 * (hd4 | 1);            // odd quads: 8 rows hit 8 bank groups
    cq4 = (hd4 + c - 1) / c;       // column quads a CTA owns
    ldv = 4 * cq4;
  }
  __host__ __device__ int floats() const {
    return 2 * L * ld + (L + 1) * ld + 2 * ld + L * ldv +
           2 * 4 * hd4 * ldv + 2 * L * (L + 1) + 4 * hd4 * LDT +
           2 * L * ldv + PAIRS;
  }
};

// HDC: the head dim at compile time (0: p.hd, at most 4 * HD4MAX).
template <typename T, int C, int NT, int HD4MAX, int HDC>
__global__ void __launch_bounds__(NT, HD4MAX <= 16 ? MIN_CTAS_PER_SM : 1)
    rwkv6_chunk_kernel(Params p) {
  constexpr int NW = NT / 32;
  constexpr int QMAX = (HD4MAX + NW - 1) / NW;          // row quads / lane
  constexpr int VQMAX = (L * ((HD4MAX + C - 1) / C) + NT - 1) / NT;
  using R = typename Quad<T>::raw;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);

  const int hd = HDC ? HDC : p.hd;
  const Layout lay(hd, C);
  const int hd4 = lay.hd4, ld = lay.ld, cq4 = lay.cq4, ldv = lay.ldv;
  float* rr = sm;                    // [L][ld] r, then r * exp(cum_prev)
  float* kk = rr + L * ld;           // [L][ld] k, then k * exp(last - cum)
  float* cx = kk + L * ld;           // [L+1][ld] row t+1: cum_t; row 0: 0
  float* uu = cx + (L + 1) * ld;     // [ld] u
  float* dd = uu + ld;               // [ld] exp(cum_last)
  float* vv = dd + ld;               // [L][ldv] v, this CTA's columns
  float* st = vv + L * ldv;          // [2][4 hd4][ldv] S, this CTA's
                                     // columns, current and next
  float* aa = st + 2 * 4 * hd4 * ldv;   // [2][L][L+1] A by chunk parity
  float* rT = aa + 2 * L * (L + 1);  // [4 hd4][LDT] r * exp(cum_prev)^T
  float* red = rT + 4 * hd4 * LDT;   // [2][L][ldv] y's two halves
  int* pt = reinterpret_cast<int*>(red + 2 * L * ldv);   // [PAIRS] t, s
  const int ss = 4 * hd4 * ldv;      // one state buffer

  const int q = C > 1 ? static_cast<int>(cg::this_cluster().block_rank())
                      : 0;
  const int nh = blockIdx.x / C;
  const int n = nh / p.h, h = nh % p.h;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int col0 = q * ldv;
  const int ncol = max(0, min(ldv, hd - col0));   // this CTA's columns
  const long long hh = (long long)hd * hd;

  const T* rg = static_cast<const T*>(p.r) + n * p.r_sn + h * p.r_sh;
  const T* kg = static_cast<const T*>(p.k) + n * p.k_sn + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + n * p.v_sn + h * p.v_sh;
  const float* wg = p.w + n * p.w_sn + h * p.w_sh;
  const bool vec = p.vec != 0;

  // ---- the state's columns, u, cum's zero row -----------------------------
  const float* s0 = p.s0 ? p.s0 + nh * hh : nullptr;
  for (int i = tid; i < ss; i += NT) {
    const int c = i / ldv, j = i % ldv;
    st[i] = s0 && c < hd && j < ncol ? s0[c * hd + col0 + j] : 0.f;
  }
  for (int i = tid; i < 2 * L * (L + 1); i += NT) aa[i] = 0.f;  // s > t: 0
  for (int i = tid; i < PAIRS; i += NT) {   // pair i = (t, s), row-major
    int t = static_cast<int>((sqrtf(8.f * i + 1.f) - 1.f) * 0.5f);
    while ((t + 1) * (t + 2) / 2 <= i) ++t;
    while (t * (t + 1) / 2 > i) --t;
    pt[i] = t << 8 | (i - t * (t + 1) / 2);
  }
  int cur = 0;                       // the state buffer of S_prev
  const int nu = n / (p.n / p.nu);
  for (int c = tid; c < ld; c += NT) {
    uu[c] = c < hd ? p.u[nu * p.u_sn + h * p.u_sh + c] : 0.f;
    cx[c] = 0.f;
  }

  // ---- a chunk's loads: lane = row, quads warp, warp + NW, ... ------------
  R rq[QMAX], kq[QMAX];
  float4 wq[QMAX];
  R vq[VQMAX];
  auto load = [&](int c0) {
    const int lc = min(L, p.s - c0);
    const long long row = c0 + lane;
#pragma unroll
    for (int i = 0; i < QMAX; ++i) {
      const int cq = warp + NW * i;
      if (cq < hd4 && lane < lc) {
        rq[i] = load_quad<T>(rg + row * p.r_ss, 4 * cq, hd, vec);
        kq[i] = load_quad<T>(kg + row * p.k_ss, 4 * cq, hd, vec);
        wq[i] = load_quad<float>(wg + row * p.w_ss, 4 * cq, hd, vec);
      }
    }
#pragma unroll
    for (int m = 0; m < VQMAX; ++m) {
      const int i = tid + NT * m;
      const int t = i / cq4, jq = i % cq4;
      if (i < L * cq4 && t < lc && 4 * jq < ncol)
        vq[m] = load_quad<T>(vg + (c0 + t) * p.v_ss + col0, 4 * jq, ncol,
                             vec);
    }
  };

  if constexpr (C > 1) cg::this_cluster().sync();   // every peer started
  if (p.s > 0) load(0);

  for (int c0 = 0; c0 < p.s; c0 += L) {
    const int lc = min(L, p.s - c0);
    float* A = aa + ((c0 / L) & 1) * L * (L + 1);
    if (!PREFETCH && c0 > 0) load(c0);
    __syncthreads();   // the last chunk's readers are done
    // ---- registers -> shared memory; the cumsum as a scan over lanes ------
#pragma unroll
    for (int i = 0; i < QMAX; ++i) {
      const int cq = warp + NW * i;
      if (cq < hd4) {                      // warp-uniform
        const bool in = lane < lc;
        const float4 r4 = in ? to_f4(rq[i]) : f4(0.f);
        const float4 k4 = in ? to_f4(kq[i]) : f4(0.f);
        const int c = 4 * cq;
        float4 lw = f4(0.f);
        if (in) {
          lw.x = safe_log(wq[i].x);
          lw.y = c + 1 < hd ? safe_log(wq[i].y) : 0.f;
          lw.z = c + 2 < hd ? safe_log(wq[i].z) : 0.f;
          lw.w = c + 3 < hd ? safe_log(wq[i].w) : 0.f;
        }
        lw.x = scan32(lw.x, lane);
        lw.y = scan32(lw.y, lane);
        lw.z = scan32(lw.z, lane);
        lw.w = scan32(lw.w, lane);
        *reinterpret_cast<float4*>(rr + lane * ld + c) = r4;
        *reinterpret_cast<float4*>(kk + lane * ld + c) = k4;
        *reinterpret_cast<float4*>(cx + (lane + 1) * ld + c) = lw;
      }
    }
#pragma unroll
    for (int m = 0; m < VQMAX; ++m) {
      const int i = tid + NT * m;
      if (i < L * cq4) {
        const int t = i / cq4, jq = i % cq4;
        *reinterpret_cast<float4*>(vv + t * ldv + 4 * jq) =
            t < lc && 4 * jq < ncol ? to_f4(vq[m]) : f4(0.f);
      }
    }
    if (PREFETCH && c0 + L < p.s) load(c0 + L);
    __syncthreads();

    // ---- this CTA's share of the pairs s <= t, into every CTA's A ---------
    {
      const int pairs = lc * (lc + 1) / 2;
      const int per = (pairs + C - 1) / C;
      const int lo = q * per, hi = min(pairs, lo + per);
      const int items = max(0, hi - lo) * SPLIT;
      for (int base = 0; base < items; base += NT) {   // CTA-uniform
        const int i = base + tid;
        const bool on = i < items;
        const int part = i % SPLIT;
        const int ts = on ? pt[lo + i / SPLIT] : 0;
        const int t = ts >> 8, s = ts & 255;
        float acc = 0.f;
        if (on) {
#pragma unroll
          for (int cq = part; cq < hd4; cq += SPLIT) {
            const int c = 4 * cq;
            const float4 r4 = *reinterpret_cast<const float4*>(rr + t * ld + c);
            const float4 k4 = *reinterpret_cast<const float4*>(kk + s * ld + c);
            if (s < t) {
              const float4 cp =
                  *reinterpret_cast<const float4*>(cx + t * ld + c);
              const float4 cm =
                  *reinterpret_cast<const float4*>(cx + (s + 1) * ld + c);
              acc += r4.x * k4.x * expf(fminf(cp.x - cm.x, 0.f));
              acc += r4.y * k4.y * expf(fminf(cp.y - cm.y, 0.f));
              acc += r4.z * k4.z * expf(fminf(cp.z - cm.z, 0.f));
              acc += r4.w * k4.w * expf(fminf(cp.w - cm.w, 0.f));
            } else {
              const float4 u4 = *reinterpret_cast<const float4*>(uu + c);
              acc += r4.x * u4.x * k4.x;
              acc += r4.y * u4.y * k4.y;
              acc += r4.z * u4.z * k4.z;
              acc += r4.w * u4.w * k4.w;
            }
          }
        }
#pragma unroll
        for (int o = SPLIT / 2; o > 0; o >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (on && part == 0) {
          if constexpr (C > 1) {
            cg::cluster_group cl = cg::this_cluster();
#pragma unroll
            for (int r = 0; r < C; ++r)
              cl.map_shared_rank(A, r)[t * (L + 1) + s] = acc;
          } else {
            A[t * (L + 1) + s] = acc;
          }
        }
      }
    }
    __syncthreads();   // A's readers of r, k and cum are done

    // ---- r * exp(cum_prev) (transposed) and k * exp(cum_last - cum) ------
    for (int i = tid; i < L * hd4; i += NT) {
      const int t = i % L, c = 4 * (i / L);
      const float4 r4 = *reinterpret_cast<const float4*>(rr + t * ld + c);
      float4* k4 = reinterpret_cast<float4*>(kk + t * ld + c);
      const float4 cp = *reinterpret_cast<const float4*>(cx + t * ld + c);
      const float4 cm = *reinterpret_cast<const float4*>(cx + (t + 1) * ld + c);
      const float4 cl = *reinterpret_cast<const float4*>(cx + L * ld + c);
      rT[c * LDT + t] = r4.x * expf(cp.x);
      rT[(c + 1) * LDT + t] = r4.y * expf(cp.y);
      rT[(c + 2) * LDT + t] = r4.z * expf(cp.z);
      rT[(c + 3) * LDT + t] = r4.w * expf(cp.w);
      k4->x *= expf(cl.x - cm.x);
      k4->y *= expf(cl.y - cm.y);
      k4->z *= expf(cl.z - cm.z);
      k4->w *= expf(cl.w - cm.w);
    }
    for (int c = tid; c < 4 * hd4; c += NT)
      dd[c] = c < hd ? expf(cx[L * ld + c]) : 0.f;
    if constexpr (C > 1)
      cg::this_cluster().sync();   // every CTA's share of A has landed
    else
      __syncthreads();

    // ---- half the threads: y's two partial sums (half the channels, half
    // the pairs each), the other half: the next state; 4 x 4 a thread -----
    const float* sc = st + cur * ss;
    float* sn = st + (cur ^ 1) * ss;
    constexpr int HALF = NT / 2;
    if (tid < HALF) {
      const int h4 = (hd4 + 1) / 2;
      for (int i = tid; i < 2 * (L / 4) * cq4; i += HALF) {
        const int j = 4 * (i % cq4), t0 = 4 * ((i / cq4) % (L / 4));
        const int kg = i / (cq4 * (L / 4));
        if (t0 >= lc || j >= ncol) continue;
        float4 acc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = f4(0.f);
#pragma unroll
        for (int cq = kg * h4; cq < min(hd4, (kg + 1) * h4); ++cq) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 4 * cq + e;
            const float4 r4 =
                *reinterpret_cast<const float4*>(rT + c * LDT + t0);
            const float4 s4 =
                *reinterpret_cast<const float4*>(sc + c * ldv + j);
            fma4(acc[0], r4.x, s4);
            fma4(acc[1], r4.y, s4);
            fma4(acc[2], r4.z, s4);
            fma4(acc[3], r4.w, s4);
          }
        }
        for (int s = kg; s <= min(t0 + 3, lc - 1); s += 2) {
          const float4 v4 = *reinterpret_cast<const float4*>(vv + s * ldv + j);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            fma4(acc[e], A[(t0 + e) * (L + 1) + s], v4);   // s > t: 0
        }
        float* rd = red + kg * L * ldv + t0 * ldv + j;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          *reinterpret_cast<float4*>(rd + e * ldv) = acc[e];
      }
    } else {
      for (int i = tid - HALF; i < hd4 * cq4; i += HALF) {
        const int j = 4 * (i % cq4), c = 4 * (i / cq4);
        float4 acc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 s4 =
              *reinterpret_cast<const float4*>(sc + (c + e) * ldv + j);
          const float d = dd[c + e];
          acc[e] = make_float4(d * s4.x, d * s4.y, d * s4.z, d * s4.w);
        }
#pragma unroll
        for (int s = 0; s < L; ++s) {   // k_dec's rows past the chunk are 0
          const float4 k4 = *reinterpret_cast<const float4*>(kk + s * ld + c);
          const float4 v4 = *reinterpret_cast<const float4*>(vv + s * ldv + j);
          fma4(acc[0], k4.x, v4);
          fma4(acc[1], k4.y, v4);
          fma4(acc[2], k4.z, v4);
          fma4(acc[3], k4.w, v4);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          *reinterpret_cast<float4*>(sn + (c + e) * ldv + j) = acc[e];
      }
    }
    __syncthreads();

    // ---- y = the two halves' sum ------------------------------------------
    for (int i = tid; i < lc * cq4; i += NT) {
      const int t = i / cq4, j = 4 * (i % cq4);
      if (j >= ncol) continue;
      const float4 a = *reinterpret_cast<const float4*>(red + t * ldv + j);
      const float4 b =
          *reinterpret_cast<const float4*>(red + (L + t) * ldv + j);
      const float4 y4 = make_float4(a.x + b.x, a.y + b.y, a.z + b.z,
                                    a.w + b.w);
      float* yr = p.y + (((long long)n * p.s + c0 + t) * p.h + h) * hd + col0;
      if ((hd & 3) == 0 && j + 4 <= ncol) {
        *reinterpret_cast<float4*>(yr + j) = y4;
      } else {
        const float v[4] = {y4.x, y4.y, y4.z, y4.w};
        for (int e = 0; e < 4 && j + e < ncol; ++e) yr[j + e] = v[e];
      }
    }
    cur ^= 1;
  }
  __syncthreads();
  float* so = p.s_out + nh * hh;
  for (int i = tid; i < hd * ncol; i += NT) {
    const int c = i / ncol, j = i % ncol;
    so[c * hd + col0 + j] = st[cur * ss + c * ldv + j];
  }
}

// S = 1: y = r (S + diag(u) k^T v), S <- w S + k^T v (w as exp(log(max(w,
// 1e-38))), the chunked form's factor), one read and one write of every
// state element.  Block (n, h, 32-column block); lane = column, warp w =
// rows w, w + 8, ...; the warps' partial y summed in shared memory.
template <typename T>
__global__ void __launch_bounds__(DECODE_THREADS)
    rwkv6_decode_kernel(Params p) {
  constexpr int NW = DECODE_THREADS / 32;
  __shared__ float part[NW][32];
  const int hd = p.hd, nb = (hd + 31) / 32;
  const int nh = blockIdx.x / nb, j = (blockIdx.x % nb) * 32 + threadIdx.x % 32;
  const int n = nh / p.h, h = nh % p.h;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool on = j < hd;
  const T* rg = static_cast<const T*>(p.r) + n * p.r_sn + h * p.r_sh;
  const T* kg = static_cast<const T*>(p.k) + n * p.k_sn + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + n * p.v_sn + h * p.v_sh;
  const float* wg = p.w + n * p.w_sn + h * p.w_sh;
  const int nu = n / (p.n / p.nu);
  const float* ug = p.u + nu * p.u_sn + h * p.u_sh;
  const long long hh = (long long)hd * hd;
  const float* s0 = p.s0 ? p.s0 + nh * hh : nullptr;
  float* so = p.s_out + nh * hh;
  const float vj = on ? to_f32<T>(vg[j]) : 0.f;
  float acc = 0.f;
  for (int c = warp; c < hd; c += NW) {
    const float rc = to_f32<T>(rg[c]), kv = to_f32<T>(kg[c]) * vj;
    const float dc = expf(safe_log(wg[c]));
    const float s = on && s0 ? s0[c * hd + j] : 0.f;
    acc += rc * (s + ug[c] * kv);
    if (on) so[c * hd + j] = dc * s + kv;
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && on) {
    float y = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) y += part[w][lane];
    p.y[((long long)n * p.h + h) * hd + j] = y;
  }
}

template <typename T, int HD4MAX, int HDC>
int launch_chunked(const Params& p, cudaStream_t stream) {
  auto kern = rwkv6_chunk_kernel<T, CLUSTER, CTA_THREADS, HD4MAX, HDC>;
  static bool configured = false;   // above 48 KB needs the opt-in
  if (!configured) {
    const int most = Layout(4 * HD4MAX, CLUSTER).floats() * 4;
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n * p.h * CLUSTER);
  cfg.blockDim = dim3(CTA_THREADS);
  cfg.dynamicSmemBytes =
      static_cast<size_t>(Layout(p.hd, CLUSTER).floats()) * 4;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CLUSTER > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// 0: rwkv6_chunk_kernel, 1: rwkv6_decode_kernel.
int path(int s) { return s == 1 ? 1 : 0; }

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  if (path(p.s) == 1) {
    const int nb = (p.hd + 31) / 32;
    rwkv6_decode_kernel<T><<<p.n * p.h * nb, DECODE_THREADS, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  if (p.hd == 64) return launch_chunked<T, 16, 64>(p, stream);   // the models'
  return p.hd <= 64 ? launch_chunked<T, 16, 0>(p, stream)
                    : launch_chunked<T, 32, 0>(p, stream);
}

}  // namespace

// r, k, v, w, u: the last dim contiguous, the others strided (row, step,
// head strides in elements); s0 (or null) and s_out contiguous [n, h, hd,
// hd], s_out may be s0; y contiguous [n, s, h, hd].  vec: hd % 4 == 0, and
// the strides of r, k, v, w are multiples of 4 and their base pointers 16-
// (float32) or 8-byte (bf16) aligned.  hd <= 128.
extern "C" int rwkv6_scan(
    int dtype, const void* r, const void* k, const void* v, const float* w,
    const float* u, const float* s0, float* y, float* s_out, int n, int s,
    int h, int hd, int nu, long long r_sn, long long r_ss, long long r_sh,
    long long k_sn, long long k_ss, long long k_sh, long long v_sn,
    long long v_ss, long long v_sh, long long w_sn, long long w_ss,
    long long w_sh, long long u_sn, long long u_sh, int vec, void* stream) {
  Params p{r,    k,    v,    w,    u,    s0,   y,    s_out, n,    s,
           h,    hd,   nu,   r_sn, r_ss, r_sh, k_sn, k_ss,  k_sh, v_sn,
           v_ss, v_sh, w_sn, w_ss, w_sh, u_sn, u_sh, vec};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (hd < 1 || hd > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch<float>(p, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The kernel a call of s rows takes: 0 = the chunked scan, 1 = decode.
extern "C" int rwkv6_scan_path(int s) { return path(s); }
