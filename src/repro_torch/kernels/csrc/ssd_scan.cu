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
// any S (the ragged last chunk is masked), and s_fin may be s0 itself
// (every column of a state has one owning CTA, which reads it before the
// first chunk and writes it after the last), so the cache is updated in
// place.
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
// once, f32 y and the final state written once (114 MB, 0.034 ms at 3.35
// TB/s).  The function's products are 2 Ns per pair s <= t once per row
// (C B^T does not depend on the head; bf16 operands, 0.14 GFLOP on the
// tensor cores), and per head 2 P per pair and 4 Ns P per row, float32
// outside the tensor cores (their operands carry more bits than TF32
// keeps): 5.39 GFLOP, 0.0805 ms at 67 TFLOP/s, so the float32 operations
// bound it.  The
// chunks of one (n, h) depend on each other through S, and the chunk's
// products are so small that shared-memory bandwidth, not the FMA units,
// is what a plain loop waits on.  What the design does (ssd_chunk_kernel):
//   * one CTA of CTA_THREADS threads per (n, h), the state S in shared
//     memory for the whole walk over the chunks;
//   * the chunk's cumsum is a shuffle scan in every warp, two rows a lane,
//     each row's dt loaded once; dt is folded into the pair matrix M's
//     columns and, with exp(cum_last - cum), into a second copy of x for
//     the state update, so xb is never formed;
//   * the float32 products are register-tiled, 4 x 4 outputs a thread,
//     two 16-byte shared loads per 16 FMAs (C, B and M kept transposed for
//     that; row strides padded so that a warp's loads hit distinct
//     banks): the state update and M's entries on or below the diagonal
//     run at once on the CTA's two halves (neither needs M), then all
//     threads form y, four threads a pair of row tiles 4 b and L - 4 - 4 b
//     (so that every thread's share of the triangle M x is the same), q
//     and s split four ways, the parts summed through shuffles;
//   * C B^T of bf16 B and C is on mma.sync (PAIRS_MMA; products of two
//     bf16 are exact in float32, summed in float32), 16 x 8 tiles a warp,
//     each entry then decayed in float32; float32 B and C take 4 x 4 FMA
//     tiles;
//   * 16-byte loads of x, B and C rows (the wrapper's vec rule); the next
//     chunk's loads in registers while the current one computes
//     (PREFETCH); P = Ns = 64 (the model's) are compile-time constants.
// Measured choices (PERF.md section 6, kernels/variants.py; device time at
// the serve prefill on an NVIDIA H100 80GB HBM3 at 700.00 W): one CTA of
// 512 threads per (n, h) over thread-block clusters that split the
// state's columns and share M through distributed shared memory (0.3107
// against 0.4376 ms for clusters of 2 x 256 threads: no duplicated B, C
// loads, no cluster barrier; the clusters were dropped); the tile pairs
// in y over one tile of two threads (0.3975 -> 0.3618 ms); C B^T on
// mma.sync over FMAs (0.3130 against 0.3394 ms).
// Decode (S = 1, ssd_decode_kernel): no pairs; one pass over the state,
// S <- exp(-dt a) S + B^T (dt x), y = C S, 32 columns per CTA, 16-byte
// state loads, y reduced over Ns through shuffles and shared memory; the
// bound is the state's bytes (8.4 MB read and written at the serve:
// 0.0025 ms).  Other P or Ns, or rows the 16-byte loads cannot take, go
// to ssd_general_kernel (one CTA per (n, h), scalar loops).
//
// Plain C interface, built with nvcc for sm_90a and loaded with ctypes.  The
// entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int L = 64;                // chunk length
constexpr int CTA_THREADS = 512;
constexpr int MIN_CTAS_PER_SM = 1;   // shared memory: ~140 KB a CTA
constexpr bool PREFETCH = true;      // next chunk's loads in flight
constexpr bool PAIRS_MMA = true;     // bf16 C B^T on mma.sync
constexpr int DIM = 64;              // P and Ns of the chunk and decode
                                     // kernels
constexpr int DECODE_THREADS = 128;
constexpr int DECODE_COLS = 32;      // state columns per decode CTA
constexpr int GENERAL_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

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
  int vec;   // rows of x, B, C and the states aligned for 16-byte loads
};

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of a row, raw: four floats or eight bf16.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using raw = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  using raw = uint4;
  static constexpr int n = 8;
};

__device__ __forceinline__ void unpack(float4 v, float* o) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void unpack(uint4 v, float* o) {
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(u[i] << 16);
    o[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float4 f4(float a) {
  return make_float4(a, a, a, a);
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 mul4(float a, float4 b) {
  return make_float4(a * b.x, a * b.y, a * b.z, a * b.w);
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a @ b for one 16x8x16 tile: a 16x16 row-major (4 registers of two
// bf16), b 16x8 column-major (2 registers), c 16x8 float32.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float4 shfl_xor4(float4 v, int m) {
  return make_float4(__shfl_xor_sync(FULL, v.x, m),
                     __shfl_xor_sync(FULL, v.y, m),
                     __shfl_xor_sync(FULL, v.z, m),
                     __shfl_xor_sync(FULL, v.w, m));
}

__device__ __forceinline__ float scan32(float x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Shared memory of a chunk CTA, in floats (every region a multiple of 4).
constexpr int LB = L + 4;            // row stride of B^T
constexpr int LC = L + 8;            // row stride of C^T and M^T
constexpr int LX = DIM + 4;          // row stride of x and S
constexpr int LH = DIM + 8;          // row stride of the bf16 B and C
constexpr int TRI = (L / 4) * (L / 4 + 1) / 2;   // 4 x 4 blocks, s <= t
constexpr int TRI_MMA = (L / 16) * (L / 16 + 1);  // 16 x 8 tiles, s <= t

// mma: bf16 B and C rows kept for mma.sync (PAIRS_MMA and bf16 B, C).
__host__ __device__ constexpr int chunk_floats(bool mma) {
  return DIM * (LC + LB) + 2 * L * LX + 2 * DIM * LX + L * LC + 3 * L + 4 +
         (mma ? L * LH : 0);
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(CTA_THREADS, MIN_CTAS_PER_SM)
    ssd_chunk_kernel(Params p) {
  constexpr int NT = CTA_THREADS, HALF = NT / 2;
  constexpr int P = DIM, NS = DIM;
  constexpr int VX = Vec<TX>::n, VB = Vec<TB>::n;
  constexpr int XV = (L * P / VX + NT - 1) / NT;    // x loads a lane
  constexpr int BV = (L * NS / VB + NT - 1) / NT;   // B (C) loads a lane
  constexpr bool MMA = PAIRS_MMA && std::is_same_v<TB, __nv_bfloat16>;
  using RX = typename Vec<TX>::raw;
  using RB = typename Vec<TB>::raw;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);

  float* cT = sm;                    // [NS][LC] C^T
  float* bT = cT + NS * LC;          // [NS][LB] B^T
  float* xs = bT + NS * LB;          // [L][LX] x
  float* xw = xs + L * LX;           // [L][LX] x * dt * exp(last - cum)
  float* st = xw + L * LX;           // [2][NS][LX] S, current and next
  float* M = st + 2 * NS * LX;       // [L][LC] M^T
  float* cum = M + L * LC;           // [L] cumsum of -dt a
  float* ecum = cum + L;             // [L] exp(cum)
  float* dtv = ecum + L;             // [L] dt
  float* decv = dtv + L;             // [1] exp(cum_last)
  // [L][LH] bf16 B and C rows for mma.sync (MMA only)
  __nv_bfloat16* b16 = reinterpret_cast<__nv_bfloat16*>(decv + 4);
  __nv_bfloat16* c16 = b16 + L * LH;

  const int nh = blockIdx.x;
  const int n = nh / p.h, h = nh % p.h;
  const int tid = threadIdx.x, lane = tid % 32;
  const long long sp = (long long)NS * P;
  const float a = p.a[(n / (p.n / p.na)) * p.a_sn + h * p.a_sh];

  const TX* xg = static_cast<const TX*>(p.x) + n * p.x_sn + h * p.x_sh;
  const float* dg = p.dt + n * p.dt_sn + h * p.dt_sh;
  const TB* bg = static_cast<const TB*>(p.b) + n * p.b_sn;
  const TB* cg_ = static_cast<const TB*>(p.c) + n * p.c_sn;
  constexpr int xq = P / VX, bq = NS / VB;  // 16-byte vectors per row

  // ---- the state --------------------------------------------------------
  const float* si = p.s0 ? p.s0 + nh * sp : nullptr;
  for (int i = tid; i < NS * P; i += NT) {
    const int q = i / P, j = i % P;
    st[q * LX + j] = si ? si[q * P + j] : 0.f;
  }
  int cur = 0;                       // the state buffer of S_prev

  // ---- a chunk's loads: x by rows, B and C lane = row ---------------------
  RX xr[XV];
  RB br[BV], cr[BV];
  float d0 = 0.f, d1 = 0.f;          // dt of rows 2 lane, 2 lane + 1
  auto load = [&](int c0) {
    const int lc = min(L, p.s - c0);
#pragma unroll
    for (int m = 0; m < XV; ++m) {
      const int i = tid + NT * m, s = i / xq, v = i % xq;
      xr[m] = RX{};
      if (i < L * xq && s < lc)
        xr[m] = *reinterpret_cast<const RX*>(xg + (c0 + s) * p.x_ss + v * VX);
    }
#pragma unroll
    for (int m = 0; m < BV; ++m) {
      const int i = tid + NT * m, s = i % L, v = i / L;
      br[m] = RB{};
      cr[m] = RB{};
      if (v < bq && s < lc) {
        br[m] = *reinterpret_cast<const RB*>(bg + (c0 + s) * p.b_ss + v * VB);
        cr[m] = *reinterpret_cast<const RB*>(cg_ + (c0 + s) * p.c_ss +
                                             v * VB);
      }
    }
    d0 = 2 * lane < lc ? dg[(c0 + 2 * lane) * p.dt_ss] : 0.f;
    d1 = 2 * lane + 1 < lc ? dg[(c0 + 2 * lane + 1) * p.dt_ss] : 0.f;
  };

  if (p.s > 0) load(0);

  for (int c0 = 0; c0 < p.s; c0 += L) {
    const int lc = min(L, p.s - c0);
    if (!PREFETCH && c0 > 0) load(c0);
    __syncthreads();   // the last chunk's readers are done

    // ---- the cumsum of -dt a: a shuffle scan, two rows a lane -------------
    const float v0 = -d0 * a, v1 = -d1 * a;
    const float incl = scan32(v0 + v1, lane);
    float excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = 0.f;
    const float cum0 = excl + v0, cum1 = incl;
    const int tl = lc - 1;
    const float last = __shfl_sync(FULL, (tl & 1) ? cum1 : cum0, tl >> 1);
    const float w0 = d0 * expf(last - cum0), w1 = d1 * expf(last - cum1);
    if (tid < 32) {
      cum[2 * lane] = cum0;
      cum[2 * lane + 1] = cum1;
      ecum[2 * lane] = expf(cum0);
      ecum[2 * lane + 1] = expf(cum1);
      dtv[2 * lane] = d0;
      dtv[2 * lane + 1] = d1;
      if (lane == 0) decv[0] = expf(last);
    }

    // ---- registers -> shared memory: x and x * w; B, C transposed ---------
#pragma unroll
    for (int m = 0; m < XV; ++m) {
      const int i = tid + NT * m, s = min(i / xq, L - 1), v = i % xq;
      const float ws0 = __shfl_sync(FULL, w0, s >> 1);
      const float ws1 = __shfl_sync(FULL, w1, s >> 1);
      const float ws = (s & 1) ? ws1 : ws0;
      if (i < L * xq) {
        float f[VX];
        unpack(xr[m], f);
#pragma unroll
        for (int k = 0; k < VX; k += 4) {
          const float4 x4 = make_float4(f[k], f[k + 1], f[k + 2], f[k + 3]);
          st4(xs + s * LX + v * VX + k, x4);
          st4(xw + s * LX + v * VX + k,
              make_float4(x4.x * ws, x4.y * ws, x4.z * ws, x4.w * ws));
        }
      }
    }
#pragma unroll
    for (int m = 0; m < BV; ++m) {
      const int i = tid + NT * m, s = i % L, v = i / L;
      if (v < bq) {
        float f[VB];
        unpack(br[m], f);
#pragma unroll
        for (int e = 0; e < VB; ++e) bT[(v * VB + e) * LB + s] = f[e];
        unpack(cr[m], f);
#pragma unroll
        for (int e = 0; e < VB; ++e) cT[(v * VB + e) * LC + s] = f[e];
        if constexpr (MMA) {
          *reinterpret_cast<RB*>(b16 + s * LH + v * VB) = br[m];
          *reinterpret_cast<RB*>(c16 + s * LH + v * VB) = cr[m];
        }
      }
    }
    if (PREFETCH && c0 + L < p.s) load(c0 + L);
    __syncthreads();

    const float* sc = st + cur * NS * LX;
    float* sn = st + (cur ^ 1) * NS * LX;
    if (tid < HALF) {
      // ---- the next state: S' = exp(last) S + B^T (x * w); 4 x 4 a thread,
      // rows qb + NQ e (a warp's 16 rows of B^T hit distinct banks) --------
      constexpr int NQ = NS / 4, JQ = P / 4;
      const float dec = decv[0];
      for (int i = tid; i < NQ * JQ; i += HALF) {
        const int qb = i % NQ, j = 4 * (i / NQ);
        float4 acc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 s4 = ld4(sc + (qb + NQ * e) * LX + j);
          acc[e] = make_float4(dec * s4.x, dec * s4.y, dec * s4.z,
                               dec * s4.w);
        }
#pragma unroll 4
        for (int s = 0; s < L; s += 4) {   // x * w's rows past lc are 0
          float4 b4[4], x4[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) b4[e] = ld4(bT + (qb + NQ * e) * LB + s);
#pragma unroll
          for (int k = 0; k < 4; ++k) x4[k] = ld4(xw + (s + k) * LX + j);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            fma4(acc[e], b4[e].x, x4[0]);
            fma4(acc[e], b4[e].y, x4[1]);
            fma4(acc[e], b4[e].z, x4[2]);
            fma4(acc[e], b4[e].w, x4[3]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) st4(sn + (qb + NQ * e) * LX + j, acc[e]);
      }
    } else if constexpr (MMA) {
      // ---- M's 16 x 8 tiles on or below the diagonal, a warp each on
      // mma.sync (bf16 products are exact in float32), into M^T ------------
      const int g = lane / 4, tq = lane % 4;
      for (int k = (tid - HALF) / 32; k < TRI_MMA; k += HALF / 32) {
        int i = 0;                          // warp-uniform
        while ((i + 1) * (i + 2) <= k) ++i;
        const int t0 = 16 * i, s0 = 8 * (k - i * (i + 1));
        if (t0 >= lc) continue;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < NS; q += 16) {
          const __nv_bfloat16* ca = c16 + (t0 + g) * LH + q + 2 * tq;
          const __nv_bfloat16* ba = b16 + (s0 + g) * LH + q + 2 * tq;
          const uint32_t af[4] = {ld32(ca), ld32(ca + 8 * LH), ld32(ca + 8),
                                  ld32(ca + 8 * LH + 8)};
          const uint32_t bf[2] = {ld32(ba), ld32(ba + 8)};
          mma_bf16(acc, af, bf);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int tt = t0 + g + 8 * (r >> 1), ss = s0 + 2 * tq + (r & 1);
          M[ss * LC + tt] =
              ss <= tt ? acc[r] * expf(fminf(cum[tt] - cum[ss], 0.f)) * dtv[ss]
                       : 0.f;
        }
      }
    } else {
      // ---- M's 4 x 4 blocks on or below the diagonal, into M^T:
      // M[t, s] = (C_t . B_s) exp(min(cum_t - cum_s, 0)) dt_s, s <= t ------
      for (int k = tid - HALF; k < TRI; k += HALF) {
        int bt = static_cast<int>((sqrtf(8.f * k + 1.f) - 1.f) * 0.5f);
        while ((bt + 1) * (bt + 2) / 2 <= k) ++bt;
        while (bt * (bt + 1) / 2 > k) --bt;
        const int t0 = 4 * bt, s0 = 4 * (k - bt * (bt + 1) / 2);
        if (t0 >= lc) continue;
        float4 acc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = f4(0.f);
#pragma unroll 8
        for (int q = 0; q < NS; ++q) {
          const float4 c4 = ld4(cT + q * LC + t0);
          const float4 b4 = ld4(bT + q * LB + s0);
          fma4(acc[0], c4.x, b4);
          fma4(acc[1], c4.y, b4);
          fma4(acc[2], c4.z, b4);
          fma4(acc[3], c4.w, b4);
        }
        const float4 ct = ld4(cum + t0), cs = ld4(cum + s0);
        const float4 ds = ld4(dtv + s0);
        float4 mv[4];                      // mv[f]: M^T row s0 + f
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = s0 + f <= t0 + e
                       ? at(acc[e], f) *
                             expf(fminf(at(ct, e) - at(cs, f), 0.f)) *
                             at(ds, f)
                       : 0.f;
          mv[f] = make_float4(v[0], v[1], v[2], v[3]);
        }
#pragma unroll
        for (int f = 0; f < 4; ++f) st4(M + (s0 + f) * LC + t0, mv[f]);
      }
    }
    __syncthreads();

    // ---- y = exp(cum) (C S) + M x: four threads a pair of 4 x 4 tiles,
    // rows ta = 4 b and tb = L - 4 - 4 b (17 steps of M x together,
    // whatever b), q and s split four ways, summed through shuffles --------
    {
      constexpr int JQ = P / 4, items = (L / 8) * JQ * 4;
      for (int base = 0; base < items; base += NT) {   // CTA-uniform
        const int i = min(base + tid, items - 1);
        const int k = i & 3, j = 4 * ((i >> 2) % JQ);
        const int ta = 4 * ((i >> 2) / JQ), tb = L - 4 - ta;
        float4 ya[4], yb[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) ya[e] = yb[e] = f4(0.f);
#pragma unroll 4
        for (int q = k; q < NS; q += 4) {
          const float4 s4 = ld4(sc + q * LX + j);
          const float4 ca = ld4(cT + q * LC + ta), cb = ld4(cT + q * LC + tb);
          fma4(ya[0], ca.x, s4);
          fma4(ya[1], ca.y, s4);
          fma4(ya[2], ca.z, s4);
          fma4(ya[3], ca.w, s4);
          fma4(yb[0], cb.x, s4);
          fma4(yb[1], cb.y, s4);
          fma4(yb[2], cb.z, s4);
          fma4(yb[3], cb.w, s4);
        }
        const float4 ea = ld4(ecum + ta), eb = ld4(ecum + tb);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ya[e] = mul4(at(ea, e), ya[e]);
          yb[e] = mul4(at(eb, e), yb[e]);
        }
#pragma unroll 4
        for (int s = k; s < tb + 4; s += 4) {   // M^T[s][t] = 0, s > t
          const float4 x4 = ld4(xs + s * LX + j);
          const float4 mb = ld4(M + s * LC + tb);
          fma4(yb[0], mb.x, x4);
          fma4(yb[1], mb.y, x4);
          fma4(yb[2], mb.z, x4);
          fma4(yb[3], mb.w, x4);
          if (s < ta + 4) {
            const float4 ma = ld4(M + s * LC + ta);
            fma4(ya[0], ma.x, x4);
            fma4(ya[1], ma.y, x4);
            fma4(ya[2], ma.z, x4);
            fma4(ya[3], ma.w, x4);
          }
        }
        // the parts' sum: k < 2 keep tile a, k >= 2 tile b, then k odd
        // keeps rows 2 and 3, k even rows 0 and 1
        const bool hi = k >= 2, odd = k & 1;
        float4 keep[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          keep[e] = add4(hi ? yb[e] : ya[e], shfl_xor4(hi ? ya[e] : yb[e], 2));
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float4 out = add4(odd ? keep[2 + r] : keep[r],
                                  shfl_xor4(odd ? keep[r] : keep[2 + r], 1));
          const int t = (hi ? tb : ta) + 2 * odd + r;
          if (base + tid < items && t < lc)
            st4(p.y + (((long long)n * p.s + c0 + t) * p.h + h) * P + j, out);
        }
      }
    }
    cur ^= 1;
  }
  __syncthreads();
  float* so = p.s_out + nh * sp;
  for (int i = tid; i < NS * P; i += NT) {
    const int q = i / P, j = i % P;
    so[q * P + j] = st[cur * NS * LX + q * LX + j];
  }
}

// S = 1: S <- exp(-dt a) S + B^T (dt x), y = C S; one read and one write of
// every state element.  Block (n, h, DECODE_COLS columns); thread: a column
// quad jq and the rows rg, rg + RG, ...; y summed over the rows through
// shuffles (the lanes of a warp that share jq) and shared memory (warps).
template <typename TX, typename TB>
__global__ void __launch_bounds__(DECODE_THREADS)
    ssd_decode_kernel(Params p) {
  constexpr int JQ = DECODE_COLS / 4;            // column quads
  constexpr int RG = DECODE_THREADS / JQ;        // row groups
  constexpr int NW = DECODE_THREADS / 32;
  constexpr int CB = DIM / DECODE_COLS;          // column blocks
  constexpr int KR = DIM / RG;                   // rows a thread
  __shared__ float4 part[NW][JQ];
  const int nh = blockIdx.x / CB, cb = blockIdx.x % CB;
  const int n = nh / p.h, h = nh % p.h;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int jq = tid % JQ, rg = tid / JQ;
  const int j = cb * DECODE_COLS + 4 * jq;
  const long long sp = (long long)DIM * DIM;
  const float* s0 = p.s0 ? p.s0 + nh * sp : nullptr;
  float* so = p.s_out + nh * sp;

  float4 sv[KR];
#pragma unroll
  for (int k = 0; k < KR; ++k)
    sv[k] = s0 ? ld4(s0 + (rg + RG * k) * DIM + j) : f4(0.f);
  const float dt = p.dt[n * p.dt_sn + h * p.dt_sh];
  const float a = p.a[(n / (p.n / p.na)) * p.a_sn + h * p.a_sh];
  const float d = expf(-dt * a);
  const TX* xg = static_cast<const TX*>(p.x) + n * p.x_sn + h * p.x_sh + j;
  const float4 xb = make_float4(to_f32<TX>(xg[0]) * dt, to_f32<TX>(xg[1]) * dt,
                                to_f32<TX>(xg[2]) * dt, to_f32<TX>(xg[3]) * dt);
  const TB* bg = static_cast<const TB*>(p.b) + n * p.b_sn;
  const TB* cg_ = static_cast<const TB*>(p.c) + n * p.c_sn;
  float4 y4 = f4(0.f);
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    const int q = rg + RG * k;
    const float bq = to_f32<TB>(bg[q]), cq = to_f32<TB>(cg_[q]);
    float4 s4 = sv[k];
    s4 = make_float4(fmaf(bq, xb.x, d * s4.x), fmaf(bq, xb.y, d * s4.y),
                     fmaf(bq, xb.z, d * s4.z), fmaf(bq, xb.w, d * s4.w));
    st4(so + q * DIM + j, s4);
    fma4(y4, cq, s4);
  }
#pragma unroll
  for (int o = JQ; o < 32; o <<= 1) {
    const float4 t = shfl_xor4(y4, o);
    y4 = make_float4(y4.x + t.x, y4.y + t.y, y4.z + t.z, y4.w + t.w);
  }
  if (lane < JQ) part[warp][lane] = y4;
  __syncthreads();
  if (tid < JQ) {
    float4 sum = part[0][tid];
#pragma unroll
    for (int w = 1; w < NW; ++w)
      sum = make_float4(sum.x + part[w][tid].x, sum.y + part[w][tid].y,
                        sum.z + part[w][tid].z, sum.w + part[w][tid].w);
    st4(p.y + ((long long)n * p.h + h) * DIM + cb * DECODE_COLS + 4 * tid,
        sum);
  }
}

// Any P, Ns <= 128 and any strides: one CTA per (n, h) walking the chunks
// with the state in shared memory and scalar loops (the kernel of the
// first port; the TPU kernel's test shapes and unaligned rows take it).
template <typename TX, typename TB>
__global__ void __launch_bounds__(GENERAL_THREADS)
    ssd_general_kernel(Params p) {
  constexpr int THREADS = GENERAL_THREADS;
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
  const TB* cg_ = static_cast<const TB*>(p.c) + n * p.c_sn;
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
      cc[t * ln + j] = to_f32<TB>(cg_[row * p.c_ss + j]);
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

size_t general_smem_bytes(int pdim, int ns) {
  return sizeof(float) * ((size_t)ns * pdim + (size_t)L * (pdim + 1) +
                          2 * (size_t)L * (ns + 1) + L * L + L);
}

template <typename TX, typename TB>
int launch_chunked(const Params& p, cudaStream_t stream) {
  constexpr size_t smem =
      chunk_floats(PAIRS_MMA && std::is_same_v<TB, __nv_bfloat16>) * 4;
  static bool configured = false;   // above 48 KB needs the opt-in
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_kernel<TX, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  ssd_chunk_kernel<TX, TB><<<p.n * p.h, CTA_THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TB>
int launch_general(const Params& p, cudaStream_t stream) {
  const size_t smem = general_smem_bytes(p.p, p.ns);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_general_kernel<TX, TB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_general_kernel<TX, TB><<<p.n * p.h, GENERAL_THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// 0: ssd_chunk_kernel, 1: ssd_decode_kernel, 2: ssd_general_kernel.
int path(int s, int pdim, int ns, int vec) {
  if (pdim != DIM || ns != DIM || !vec) return 2;
  return s == 1 ? 1 : 0;
}

template <typename TX, typename TB>
int launch(const Params& p, cudaStream_t stream) {
  switch (path(p.s, p.p, p.ns, p.vec)) {
    case 0:
      return launch_chunked<TX, TB>(p, stream);
    case 1:
      ssd_decode_kernel<TX, TB>
          <<<p.n * p.h * (DIM / DECODE_COLS), DECODE_THREADS, 0, stream>>>(p);
      return static_cast<int>(cudaGetLastError());
    default:
      return launch_general<TX, TB>(p, stream);
  }
}

}  // namespace

// x, B, C: the last dim contiguous, the others strided (row, step, head
// strides in elements); s0 (or null) and s_out contiguous [n, h, ns, p],
// s_out may be s0; y contiguous [n, s, h, p].  vec: the strides of x, B
// and C are multiples of 16 bytes and their base pointers, s0's and
// s_out's 16-byte aligned.  p, ns <= 128.
extern "C" int ssd_scan(
    int x_dtype, int bc_dtype, const void* x, const float* dt, const float* a,
    const void* b, const void* c, const float* s0, float* y, float* s_out,
    int n, int s, int h, int pdim, int ns, int na, long long x_sn,
    long long x_ss, long long x_sh, long long dt_sn, long long dt_ss,
    long long dt_sh, long long a_sn, long long a_sh, long long b_sn,
    long long b_ss, long long c_sn, long long c_ss, int vec, void* stream) {
  Params p{x,     dt,    a,    b,    c,    s0,   y,    s_out, n,
           s,     h,     pdim, ns,   na,   x_sn, x_ss, x_sh,  dt_sn,
           dt_ss, dt_sh, a_sn, a_sh, b_sn, b_ss, c_sn, c_ss,  vec};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (pdim < 1 || pdim > 128 || ns < 1 || ns > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == 0 && bc_dtype == 0) return launch<float, float>(p, st);
  if (x_dtype == 0 && bc_dtype == 1)
    return launch<float, __nv_bfloat16>(p, st);
  if (x_dtype == 1 && bc_dtype == 0)
    return launch<__nv_bfloat16, float>(p, st);
  if (x_dtype == 1 && bc_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The kernel a call takes: 0 = the chunked scan, 1 = decode, 2 = general.
extern "C" int ssd_scan_path(int s, int pdim, int ns, int vec) {
  return path(s, pdim, ns, vec);
}
