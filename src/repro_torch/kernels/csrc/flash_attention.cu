// Flash attention forward: blockwise attention with an online softmax,
// causal and sliding-window masks, a logit softcap and grouped-query heads.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (_kernel), and computes the function of the model's flash path
// (repro/models/attention.py:_flash_jnp) on the model's own layout:
//
//   q [N, Sq, HK, G, dh], k and v [N, Skv, HK, dh], out like q,
//
// with strides for every dim but the last (which must be contiguous), so
// the Pallas layout [B, H, S, dh] and a sliced cache are passed as views.
// Query i has position q0 + i, key j position j; key j is seen by query i
// when j < kv_len, (causal) j <= q0 + i and (window > 0) j > q0 + i -
// window.  Scores are q.k / sqrt(dh), then softcap * tanh(s / softcap) when
// softcap > 0.  The TPU kernel's function is q0 = 0, kv_len = Skv. Scores
// and the accumulator are float32, p is rounded to the input type before the
// PV product (as _flash_jnp does), masked scores are the finite NEG = -1e30
// (a row whose first blocks are all masked sums exp(0) terms that the first
// unmasked block's alpha = exp(NEG - m) wipes out; with -inf that would be
// exp(-inf + inf) = NaN), and the output is acc / max(l, 1e-30).  KV blocks
// that are masked for every row of a tile, and blocks at or beyond kv_len,
// are neither read nor computed, so decode reads only the filled part of the
// cache.  Ragged Sq, Skv, kv_len and dh are masked in the loads and stores
// (zero-filled in shared memory), never padded in device memory.
//
// Bound on an H100: the serve path's prefill (N = 32, Sq = Skv = 1024,
// HK = 1, G = 3, dh = 128, causal) is 25.8 GFLOP of products over 25 MB,
// far above the card's ~295 flop/byte ridge: bound by operations (989
// TFLOP/s dense bf16).  Its decode (Sq = 1, G = 3) is ~6 flop per byte of
// K/V: bound by the bytes of the cache it reads (3.35 TB/s).  What the
// design does about it:
//   * One CTA per (N, KV head, tile of 128 folded query rows).  The G query
//     heads of a group are folded into the rows of a tile (row = i*G + g),
//     so the group's K/V are read once: in decode, one tile holds all G
//     heads of a token.
//   * bf16: 8 warps, 16 rows each.  K/V blocks of 32 keys are staged
//     into shared memory with cp.async, double-buffered so block b+1
//     loads while block b computes; at dh = 128 a CTA holds 70 KB, so 3
//     fit on an SM.  S = Q K^T and O += P V run on the tensor cores as
//     mma.sync m16n8k16 (bf16 in, float32 accumulate), their operands
//     read from shared memory by ldmatrix (.trans for V); S stays in
//     registers, the row max and sum are reduced across the quad that
//     shares a row, the softmax runs in base 2 (scores scaled by log2 e,
//     exp2f), blocks that every row of a warp sees whole skip the mask,
//     and P is re-packed from the S accumulator registers straight into
//     the A operand of the PV product (the two layouts coincide), so
//     scores never touch memory.
//   * float32: full float32 FMA (no TF32): 4 warps of 4 rows, a lane per
//     key for S, a lane per output column for O.
// Not yet: wgmma/TMA, splitting the KV loop across CTAs for decode
// (decode fills only N*HK CTAs).
//
// Plain C interface, built with nvcc for sm_90a and loaded with ctypes.
// The entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int TC_WARPS = 8;                 // bf16: warps of a CTA
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int BM = 16 * TC_WARPS;           // folded query rows of a tile
constexpr int F_THREADS = 128;              // float32: 4 warps

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int n, sq, skv, hk, g, dh;
  long long q_sn, q_ss, q_sh, q_sg;
  long long k_sn, k_ss, k_sh;
  long long v_sn, v_ss, v_sh;
  long long o_sn, o_ss, o_sh, o_sg;
  int causal, window;
  float softcap, scale;
  int q0, kv_len, vec_ok;
};

// The KV blocks [lo, hi) of width bn that are unmasked for some row of
// the tile whose query positions are [qmin, qmax].
__device__ __forceinline__ void block_range(const Params& P, int bn,
                                            int qmin, int qmax, int* lo,
                                            int* hi) {
  int h = (P.kv_len + bn - 1) / bn;
  if (P.causal) h = qmax < 0 ? 0 : min(h, qmax / bn + 1);
  int l = 0;
  if (P.window > 0) {
    const int first = qmin - P.window + 1;   // first key the tile can see
    if (first > 0) l = first / bn;
  }
  *lo = l;
  *hi = h;
}

__device__ __forceinline__ bool visible(const Params& P, int j, int qpos) {
  return j < P.kv_len && (!P.causal || j <= qpos) &&
         (P.window <= 0 || j > qpos - P.window);
}

__device__ __forceinline__ float cap(const Params& P, float s) {
  s *= P.scale;
  if (P.softcap > 0.f) s = P.softcap * tanhf(s / P.softcap);
  return s;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  // src_bytes == 0 zero-fills the 16 bytes
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8; register i receives matrix i's elements at
// row lane / 4, columns 2 (lane % 4) and +1 (transposed with .trans).
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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

// Stage ROWS rows of DHP elements into shared memory (row pitch LDS):
// row r comes from src(r) (nullptr: a zero row), elements at or beyond
// dh are zero.  16-byte cp.async chunks when vec_ok (dh, every stride and
// the base pointers aligned to 8 elements), element loads otherwise.
template <int DHP, int LDS, int ROWS, class Src>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, Src src,
                                           const __nv_bfloat16* any,
                                           int dh, int vec_ok) {
  constexpr int CH = DHP / 8;
  for (int c = threadIdx.x; c < ROWS * CH; c += TC_THREADS) {
    const int r = c / CH;
    const int d0 = (c % CH) * 8;
    const __nv_bfloat16* s = src(r);
    __nv_bfloat16* d = dst + r * LDS + d0;
    if (vec_ok) {
      const bool in = s != nullptr && d0 < dh;
      cp_async16(d, in ? s + d0 : any, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (s != nullptr && d0 + e < dh) ? s[d0 + e]
                                             : __float2bfloat16(0.f);
    }
  }
}

template <int DHP>
struct TcShape {
  static constexpr int BN = 32;                    // keys per KV block
  static constexpr int LDS = DHP + 8;              // smem row pitch
  static constexpr int SMEM = (BM + 4 * BN) * LDS * 2;
};

template <int DHP>
__global__ void __launch_bounds__(TC_THREADS) fa_bf16_kernel(Params P) {
  using T = __nv_bfloat16;
  constexpr int BN = TcShape<DHP>::BN;
  constexpr int LDS = TcShape<DHP>::LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BM * LDS;        // two buffers of [BN, LDS]
  T* Vs = Ks + 2 * BN * LDS;

  const int n = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * BM;
  const int rows = P.sq * P.g;
  const int row_end = min(row0 + BM, rows);
  int kb_lo, kb_hi;
  block_range(P, BN, P.q0 + row0 / P.g, P.q0 + (row_end - 1) / P.g, &kb_lo,
              &kb_hi);

  const T* qb = static_cast<const T*>(P.q) + n * P.q_sn + h * P.q_sh;
  const T* kb0 = static_cast<const T*>(P.k) + n * P.k_sn + h * P.k_sh;
  const T* vb0 = static_cast<const T*>(P.v) + n * P.v_sn + h * P.v_sh;
  const T* any = static_cast<const T*>(P.q);

  stage_rows<DHP, LDS, BM>(
      Qs,
      [&](int r) -> const T* {
        const int R = row0 + r;
        if (R >= rows) return nullptr;
        return qb + (R / P.g) * P.q_ss + (R % P.g) * P.q_sg;
      },
      any, P.dh, P.vec_ok);
  auto stage_kv = [&](int buf, int kb) {
    stage_rows<DHP, LDS, BN>(
        Ks + buf * BN * LDS,
        [&](int r) -> const T* {
          const int j = kb * BN + r;
          return j < P.kv_len ? kb0 + j * P.k_ss : nullptr;
        },
        any, P.dh, P.vec_ok);
    stage_rows<DHP, LDS, BN>(
        Vs + buf * BN * LDS,
        [&](int r) -> const T* {
          const int j = kb * BN + r;
          return j < P.kv_len ? vb0 + j * P.v_ss : nullptr;
        },
        any, P.dh, P.vec_ok);
  };
  if (kb_lo < kb_hi) stage_kv(0, kb_lo);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int wrow = warp * 16;                  // the warp's first tile row
  const bool live = row0 + wrow < rows;
  // this thread's two rows of the warp's 16: wrow + gid and wrow + gid + 8
  const int qpos_a = P.q0 + (row0 + wrow + gid) / P.g;
  const int qpos_b = P.q0 + (row0 + wrow + gid + 8) / P.g;
  // the first and last query positions of the warp's 16 rows
  const int wq_min = P.q0 + (row0 + wrow) / P.g;
  const int wq_max = P.q0 + (row0 + wrow + 15) / P.g;
  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;
  float o[DHP / 8][4];
#pragma unroll
  for (int t = 0; t < DHP / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;

  for (int kb = kb_lo, it = 0; kb < kb_hi; ++kb, ++it) {
    const int buf = it & 1;
    if (kb + 1 < kb_hi) stage_kv(buf ^ 1, kb + 1);
    cp_async_commit();
    cp_async_wait<1>();          // block kb (and Q) have landed
    __syncthreads();
    if (live) {
      const T* Kt = Ks + buf * BN * LDS;
      const T* Vt = Vs + buf * BN * LDS;
      float s[BN / 8][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      // S = Q K^T: A = Q rows (row-major), B = K^T (K rows are its
      // columns); one ldmatrix.x4 gives the A tile, or the B tiles of two
      // 8-key column blocks
#pragma unroll
      for (int ks = 0; ks < DHP / 16; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, Qs + (wrow + (lane & 15)) * LDS + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < BN / 8; j += 2) {
          uint32_t kr[4];
          ldsm_x4(kr, Kt + (j * 8 + (lane & 7) + (lane >> 4) * 8) * LDS +
                          ks * 16 + ((lane >> 3) & 1) * 8);
          const uint32_t b0[2] = {kr[0], kr[1]}, b1[2] = {kr[2], kr[3]};
          mma_bf16(s[j], a, b0);
          mma_bf16(s[j + 1], a, b1);
        }
      }
      // scale, cap, mask (skipped for a block every row of the warp sees
      // whole); the online softmax of rows a and b in base 2: the scores
      // are scaled by log2(e), which leaves the softmax as it is
      const int k_first = kb * BN, k_last = kb * BN + BN - 1;
      const bool whole = k_last < P.kv_len && (!P.causal || k_last <= wq_min) &&
                         (P.window <= 0 || k_first > wq_max - P.window);
      float mx_a = NEG, mx_b = NEG;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k_first + j * 8 + tig * 2 + e;
          s[j][e] = (whole || visible(P, col, qpos_a))
                        ? cap(P, s[j][e]) * LOG2E : NEG;
          s[j][2 + e] = (whole || visible(P, col, qpos_b))
                            ? cap(P, s[j][2 + e]) * LOG2E : NEG;
          mx_a = fmaxf(mx_a, s[j][e]);
          mx_b = fmaxf(mx_b, s[j][2 + e]);
        }
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][e] = exp2f(s[j][e] - mn_a);
          s[j][2 + e] = exp2f(s[j][2 + e] - mn_b);
          sum_a += s[j][e];
          sum_b += s[j][2 + e];
        }
      }
      // per-thread partial row sums; the quad's sum is taken at the end
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
#pragma unroll
      for (int t = 0; t < DHP / 8; ++t) {
        o[t][0] *= al_a;
        o[t][1] *= al_a;
        o[t][2] *= al_b;
        o[t][3] *= al_b;
      }
      // O += P V: the S accumulators of key tiles 2kk and 2kk+1 are the A
      // operand of one 16-key step; B = V rows kk*16.. read transposed, two
      // 8-column output tiles per ldmatrix.x4.trans
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int t = 0; t < DHP / 8; t += 2) {
          uint32_t vr[4];
          ldsm_x4_t(vr, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 LDS + t * 8 + (lane >> 4) * 8);
          const uint32_t b0[2] = {vr[0], vr[1]}, b1[2] = {vr[2], vr[3]};
          mma_bf16(o[t], a, b0);
          mma_bf16(o[t + 1], a, b1);
        }
      }
    }
    __syncthreads();             // buffer buf is free for block kb + 2
  }
  cp_async_wait<0>();
  if (!live) return;

  const float inv_a = 1.f / fmaxf(quad_sum(l_a), 1e-30f);
  const float inv_b = 1.f / fmaxf(quad_sum(l_b), 1e-30f);
  T* ob = static_cast<T*>(P.o) + n * P.o_sn + h * P.o_sh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int R = row0 + wrow + gid + 8 * half;
    if (R >= rows) continue;
    T* orow = ob + (R / P.g) * P.o_ss + (R % P.g) * P.o_sg;
    const float inv = half ? inv_b : inv_a;
#pragma unroll
    for (int t = 0; t < DHP / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = t * 8 + tig * 2 + e;
        if (d < P.dh) orow[d] = __float2bfloat16(o[t][2 * half + e] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: FMA
// ---------------------------------------------------------------------------

constexpr int FBM = 16;   // query rows of a float32 tile: 4 per warp
constexpr int FBN = 32;   // keys per block: one per lane

template <int DHP>
constexpr int f32_smem() {
  return (FBM * DHP + FBN * (DHP + 1) + FBN * DHP) * 4;
}

template <int DHP>
__global__ void __launch_bounds__(F_THREADS) fa_f32_kernel(Params P) {
  constexpr int LDK = DHP + 1;   // K rows read by lane: no bank conflicts
  constexpr int C = DHP / 32;    // output columns per lane
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;
  float* Ks = Qs + FBM * DHP;
  float* Vs = Ks + FBN * LDK;

  const int n = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * FBM;
  const int rows = P.sq * P.g;
  const int row_end = min(row0 + FBM, rows);
  int kb_lo, kb_hi;
  block_range(P, FBN, P.q0 + row0 / P.g, P.q0 + (row_end - 1) / P.g, &kb_lo,
              &kb_hi);
  const float* qb = static_cast<const float*>(P.q) + n * P.q_sn + h * P.q_sh;
  const float* kb0 = static_cast<const float*>(P.k) + n * P.k_sn + h * P.k_sh;
  const float* vb0 = static_cast<const float*>(P.v) + n * P.v_sn + h * P.v_sh;

  for (int c = threadIdx.x; c < FBM * DHP; c += F_THREADS) {
    const int r = c / DHP, d = c % DHP, R = row0 + r;
    Qs[c] = (R < rows && d < P.dh)
                ? qb[(R / P.g) * P.q_ss + (R % P.g) * P.q_sg + d]
                : 0.f;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int qpos[4];
  float m[4], l[4], o[4][C];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    qpos[rr] = P.q0 + (row0 + warp * 4 + rr) / P.g;
    m[rr] = NEG;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) o[rr][c] = 0.f;
  }

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    __syncthreads();             // the previous block is consumed
    for (int c = threadIdx.x; c < FBN * DHP; c += F_THREADS) {
      const int r = c / DHP, d = c % DHP, j = kb * FBN + r;
      const bool in = j < P.kv_len && d < P.dh;
      Ks[r * LDK + d] = in ? kb0[j * P.k_ss + d] : 0.f;
      Vs[c] = in ? vb0[j * P.v_ss + d] : 0.f;
    }
    __syncthreads();
    const int j = kb * FBN + lane;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < DHP; ++d) {
      const float kv = Ks[lane * LDK + d];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        s[rr] = fmaf(Qs[(warp * 4 + rr) * DHP + d], kv, s[rr]);
    }
    float p[4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const float v = visible(P, j, qpos[rr]) ? cap(P, s[rr]) : NEG;
      const float mn = fmaxf(m[rr], warp_max(v));
      const float al = expf(m[rr] - mn);
      p[rr] = expf(v - mn);
      l[rr] = l[rr] * al + warp_sum(p[rr]);
      m[rr] = mn;
#pragma unroll
      for (int c = 0; c < C; ++c) o[rr][c] *= al;
    }
    for (int jj = 0; jj < FBN; ++jj) {
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const float pj = __shfl_sync(0xffffffffu, p[rr], jj);
#pragma unroll
        for (int c = 0; c < C; ++c)
          o[rr][c] = fmaf(pj, Vs[jj * DHP + lane + 32 * c], o[rr][c]);
      }
    }
  }
  float* ob = static_cast<float*>(P.o) + n * P.o_sn + h * P.o_sh;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int R = row0 + warp * 4 + rr;
    if (R >= rows) continue;
    float* orow = ob + (R / P.g) * P.o_ss + (R % P.g) * P.o_sg;
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = lane + 32 * c;
      if (d < P.dh) orow[d] = o[rr][c] * inv;
    }
  }
}

template <typename K>
void set_smem(K kernel, int bytes) {
  if (bytes > 48 * 1024)   // above 48 KB needs the opt-in
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
}

template <int DHP>
void launch_bf16(const Params& P, cudaStream_t s) {
  constexpr int bytes = TcShape<DHP>::SMEM;
  static bool configured = false;
  if (!configured) {
    set_smem(fa_bf16_kernel<DHP>, bytes);
    configured = true;
  }
  const dim3 grid((P.sq * P.g + BM - 1) / BM, P.hk, P.n);
  fa_bf16_kernel<DHP><<<grid, TC_THREADS, bytes, s>>>(P);
}

template <int DHP>
void launch_f32(const Params& P, cudaStream_t s) {
  constexpr int bytes = f32_smem<DHP>();
  static bool configured = false;
  if (!configured) {
    set_smem(fa_f32_kernel<DHP>, bytes);
    configured = true;
  }
  const dim3 grid((P.sq * P.g + FBM - 1) / FBM, P.hk, P.n);
  fa_f32_kernel<DHP><<<grid, F_THREADS, bytes, s>>>(P);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the head
// dim of every operand is contiguous.  dh <= 256.  vec_ok: dh and every
// q/k/v stride are multiples of 8 and the q/k/v pointers 16-byte aligned.
extern "C" int flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* o, int n,
    int sq, int skv, int hk, int g, int dh, long long q_sn, long long q_ss,
    long long q_sh, long long q_sg, long long k_sn, long long k_ss,
    long long k_sh, long long v_sn, long long v_ss, long long v_sh,
    long long o_sn, long long o_ss, long long o_sh, long long o_sg,
    int causal, int window, float softcap, int q0, int kv_len, int vec_ok,
    void* stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(dh));
  Params P{q,    k,    v,    o,    n,    sq,   skv,    hk,     g,
           dh,   q_sn, q_ss, q_sh, q_sg, k_sn, k_ss,   k_sh,   v_sn,
           v_ss, v_sh, o_sn, o_ss, o_sh, o_sg, causal, window, softcap,
           scale, q0,  kv_len, vec_ok};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (dh <= 16) launch_bf16<16>(P, s);
    else if (dh <= 32) launch_bf16<32>(P, s);
    else if (dh <= 64) launch_bf16<64>(P, s);
    else if (dh <= 128) launch_bf16<128>(P, s);
    else if (dh <= 256) launch_bf16<256>(P, s);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else if (dtype == 0) {
    if (dh <= 32) launch_f32<32>(P, s);
    else if (dh <= 64) launch_f32<64>(P, s);
    else if (dh <= 128) launch_f32<128>(P, s);
    else if (dh <= 256) launch_f32<256>(P, s);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
