// Flash attention forward: blockwise attention with an online softmax,
// causal and sliding-window masks, a logit softcap and grouped-query heads.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (_kernel), and computes the function of the model's flash path
// (repro/models/attention.py:_flash_jnp) on the model's own layout:
//
//   q [N, Sq, HK, G, dh], k [N, Skv, HK, dh], v [N, Skv, HK, dv], out
//   [N, Sq, HK, G, dv] (dv <= dh; dv < dh only for MLA),
//
// with strides for every dim but the last (which must be contiguous), so
// the Pallas layout [B, H, S, dh] and a sliced cache are passed as views.
// Query i has position q0 + i, key j position j; key j is seen by query i
// when j < kv_len, (causal) j <= q0 + i and (window > 0) j > q0 + i -
// window.  Scores are q.k * scale (the caller's, 1 / sqrt(dh) unless it
// says otherwise: MLA's absorbed path takes 1 / sqrt(nope + rope)), then
// softcap * tanh(s / softcap) when softcap > 0.  The TPU kernel's function
// is q0 = 0, kv_len = Skv.  Scores and the accumulator are float32, p is
// rounded to the input type before the PV product (as _flash_jnp does),
// masked scores are the finite NEG = -1e30
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
// K/V: bound by the bytes of the cache it reads (3.35 TB/s).  The G query
// heads of a KV head are folded into the rows of a tile (row = i*G + g),
// so the group's K/V are read once.  Eight kernels, one per call, chosen
// before the launch by plan() (flash_attention_plan):
//   * fa_wgmma_kernel, bf16 prefill (at least 64 folded rows, dh 128 or
//     256, 16-byte strides): a CTA per 128 folded rows of one (n, KV
//     head), one CTA per SM, the row tiles with the most keys first
//     (causal tiles differ in work).  K/V blocks of BN keys (128; 64 at dh
//     256) come by TMA (4-D tensor maps encoded per call with the key
//     extent set to kv_len, so nothing at or beyond kv_len is read: TMA
//     zero-fills it) into two 128-byte-swizzled stages, K and V each with
//     a full and an empty barrier, so the next block's K loads while this
//     block's PV product runs; at dh 128 a third warpgroup is the
//     producer (its registers moved to the consumers by setmaxnreg), at
//     dh 256 thread 0 issues the loads between its products (see
//     WgShape).  Warpgroups 0 and 1 hold 64 rows each: Q is stored in
//     shared memory by 16-byte loads (stage_q: a tile of folded rows is
//     not a TMA box when G does not divide 128; all of a thread's loads
//     in flight at once) and read from there by every block's products;
//     S = Q K^T on wgmma m64nBNk16 (Q and K K-major), the online softmax
//     in float32 registers in base 2 (the row max and sum across the
//     quad that shares a row; the mask only on blocks that cross the
//     causal edge, the window or kv_len, the softcap test once per block:
//     a branch per score cost as much as the products), then P rounded to
//     bf16 in registers is the register A operand of O += P V on wgmma (V
//     MN-major, the transpose-B bit; the accumulator's layout of two
//     8-key groups is A's layout of one 16-key step).  At dh 256 the
//     budget is the register file: O is 64 x 256 float32 a warpgroup (128
//     registers a thread), so BN is 64 (S in 32 registers, on m64n64k16)
//     and O += P V is one m64n256k16 per 16 keys; shared memory holds Q
//     (64 KB) and two K and two V stages of 32 KB (193 KB).  Filling the
//     card: gemma3-1b's prefill per lane on the (2, 4) mesh, [16, 1024,
//     1, 1, 256], is 8 row tiles x 16 lanes = 128 CTAs on 132 SMs, one
//     wave, and the causal tiles hold 2 to 16 blocks: the heaviest-first
//     order starts the 16-block tiles at once, so the launch takes the
//     heaviest tile's 16 blocks where the mean is 9.  A 64-row CTA would
//     halve that tile but leave one consumer warpgroup on an SM, whose
//     softmax then idles the tensor cores; long_500k's 16 383 tiles fill
//     the card many times over.  Bound by operations at every served
//     dh-256 prefill (the long prefill's global layer: 5.63e14 FLOP).
//   * fa_wgmma64_kernel, the same prefill at dh 64 (whisper-medium's
//     encoder self-attention, [32, 1500, 2, 1, 64] non-causal: 36.9 GFLOP,
//     0.0373 ms at the card's peak, and 1.44e8 exponentials, ~0.037 ms at
//     16 a clock an SM: at dh 64 the exponentials cost as much as the
//     products).  The same tiles, blocks and TMA maps as fa_wgmma_kernel,
//     four stages, and the softmax under the products: each warpgroup
//     issues S of block j with O += P V of block j - 1 and runs block j's
//     softmax while the PV product runs, and the two warpgroups take turns
//     to issue (a ping-pong on named barriers), so one's exponentials run
//     under the other's products; a score is one FFMA and one ex2.approx.
//     288 threads, a producer warp beside the two warpgroups; without a
//     softcap (see Wg64Shape).
//   * fa_ring_kernel, bf16 decode (at most 16 folded rows; gemma3-1b,
//     paligemma-3b, gemma2-9b at dh 256; gemma3-1b's [16, 1, 1, 1, 256] at
//     kv_len 1056 reads 17.3 MB: 0.0052 ms at 3.35 TB/s; llama's dh 128,
//     whisper's dh 64; dh up to 32 zero-padded to 32): the keys any query
//     sees are cut into 32-key blocks and the blocks into splits, as many
//     as fill the card's resident CTAs once (the occupancy API's count;
//     gemma3-1b: 16 splits x 16 pairs = 256 CTAs on 264 slots).  A CTA
//     streams its blocks through a ring of cp.async stages (3 at dh 256,
//     107 KB with Q: two CTAs an SM), so it starts with all its stages in
//     flight and keeps the rest in flight while a block is computed; each
//     of its 4 warps takes 8 keys of a block on mma.sync (S on m16n8k16, O
//     += P V on m16n8k8: 3 rows would waste a 64-row wgmma, and decode is
//     bound by bytes), the warps merge their softmax states, and the CTA
//     writes a float32 partial (o, m, l) to scratch; the last CTA of its
//     pair to finish (an atomic ticket) merges the splits into the output
//     in one pass and re-arms the ticket.  A call whose keys fit one split
//     writes its output at once.  One launch per call.
//   * fa_bf16_kernel, other bf16 calls: 8 warps of 16 rows, K/V blocks of
//     32 keys double-buffered by cp.async, mma.sync with ldmatrix
//     operands (the same per-warp step as the split decode).
//   * fa_mla_wgmma_kernel, the bf16 MLA prefill (DeepSeek's absorbed
//     multi-head latent attention: q and k 576 wide, the 512-wide latent
//     and the 64-wide rope part; v the latent, a view of k's first 512
//     columns; 16 q heads over one KV head at TP 8; at least 64 folded
//     rows, 16-byte strides).  Its prefill (N = 32, Sq = Skv = 1024, G =
//     16, causal) is 585 GFLOP over 76 MB: bound by operations.  A CTA of
//     256 threads holds 64 folded rows (4 query positions) and Q (72 KB)
//     for the whole KV loop; thread 0 loads 64-key K blocks of all 576
//     columns by TMA into two stages (144 KB), and V is read from the
//     same stage, so the latent is read once.  S is split by keys across
//     the two warpgroups (m64n32k16 over the 576-deep Q, 16 registers a
//     thread), the row maxima meet in shared memory, P goes to shared
//     memory in bf16 in the swizzle wgmma reads (8 KB), and each
//     warpgroup computes O += P V for half the output's columns on
//     m64n256k16 (a 64 x 256 float32 accumulator: 128 registers a
//     thread), since 512 columns in one warpgroup's registers would not
//     fit.  What holds it back is L2: every 64-row tile reads its keys'
//     whole 1 152-byte rows (5.1 GB of K blocks at the serve prefill
//     against 38 MB of distinct keys), and 64 rows is the most a CTA's
//     registers hold with a 512-wide O; without its products the kernel
//     takes 70 % of its time (kernels/variants.py).
//   * fa_mla_kernel, other bf16 calls with dv != dh or dh > 256: the MLA
//     decode, a v that is its own tensor, and MLA prefills of fewer than
//     64 folded rows.  The decode (Sq = 1, kv_len ~1056) reads 38.9 MB of
//     latent cache for 1.2 GFLOP: bound by bytes.  A 16 x 512 float32
//     accumulator is the whole register file of a warp, so the output's
//     columns are split across the CTA's 8 warps (64 each) while S = Q K^T
//     is split by rows and key slices, and P and each row's rescale
//     factor pass through shared memory between the two.  Q stays in
//     shared memory (576-wide rows); when v is a view of k V is read from
//     the K stage, so K blocks are double-buffered and the latent is read
//     once.  Prefill: 64 folded rows a CTA, 32-key blocks; decode: 16
//     rows, 64-key blocks split across CTAs, one per SM, merged by the
//     last CTA of each (n, KV head) as in fa_ring_kernel.
//   * fa_f32_kernel, float32: full float32 FMA (no TF32), 4 warps of 4
//     rows, a lane per key for S, a lane per output column for O (dh up to
//     576).

// Plain C interface, built with nvcc for sm_90a and loaded with ctypes.
// The entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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
  int n, sq, skv, hk, g, dh, dv;   // dv: v's and out's width (<= dh)
  long long q_sn, q_ss, q_sh, q_sg;
  long long k_sn, k_ss, k_sh;
  long long v_sn, v_ss, v_sh;
  long long o_sn, o_ss, o_sh, o_sg;
  int causal, window;
  float softcap, scale;
  int q0, kv_len, vec_ok;
  int v_in_k;   // v is k's first dv columns (same base and strides)
};

// The KV blocks [lo, hi) of width bn that are unmasked for some row of
// the tile whose query positions are [qmin, qmax] (the host's plan counts
// the MLA decode's blocks with it too).
__host__ __device__ __forceinline__ void blocks_seen(int kv_len, int causal,
                                                     int window, int bn,
                                                     int qmin, int qmax,
                                                     int* lo, int* hi) {
  int h = (kv_len + bn - 1) / bn;
  if (causal) h = qmax < 0 ? 0 : (h < qmax / bn + 1 ? h : qmax / bn + 1);
  int l = 0;
  if (window > 0) {
    const int first = qmin - window + 1;   // first key the tile can see
    if (first > 0) l = first / bn;
  }
  *lo = l;
  *hi = h;
}

__device__ __forceinline__ void block_range(const Params& P, int bn,
                                            int qmin, int qmax, int* lo,
                                            int* hi) {
  blocks_seen(P.kv_len, P.causal, P.window, bn, qmin, qmax, lo, hi);
}

// Branchless (bitwise, not short-circuit), so that a masked score is a
// select and not a divergent branch.
__device__ __forceinline__ bool visible(const Params& P, int j, int qpos) {
  return (j < P.kv_len) & (!P.causal | (j <= qpos)) &
         ((P.window <= 0) | (j > qpos - P.window));
}

__device__ __forceinline__ float cap(const Params& P, float s) {
  s *= P.scale;
  if (P.softcap > 0.f) s = P.softcap * tanhf(s / P.softcap);
  return s;
}

// Every score of a block to its base-2 logit, cap(s) * log2(e), in place.
// The softcap test is taken once for the block: inside the loop it costs
// a divergent branch per score (tanhf has branches of its own) even when
// no cap is set.
template <int N>
__device__ __forceinline__ void logits(const Params& P, float* s) {
  if (P.softcap > 0.f) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      s[i] = P.softcap * tanhf(s[i] * P.scale / P.softcap) * LOG2E;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = s[i] * P.scale * LOG2E;
  }
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

// c += a @ b for one 16x8x8 tile: a 16x8 row-major (2 registers: rows
// lane/4 and +8, columns 2 (lane % 4) and +1, the layout of a 16x8 tile's
// accumulator), b 8x8 column-major (1 register), c 16x8 float32.
__device__ __forceinline__ void mma_bf16_k8(float c[4], const uint32_t a[2],
                                            uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// Stage ROWS rows of DHP elements into shared memory (row pitch LDS):
// row r comes from src(r) (nullptr: a zero row), elements at or beyond
// dh are zero.  16-byte cp.async chunks when vec_ok (dh, every stride and
// the base pointers aligned to 8 elements), element loads otherwise.
template <int DHP, int LDS, int ROWS, int THREADS = TC_THREADS, class Src>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, Src src,
                                           const __nv_bfloat16* any,
                                           int dh, int vec_ok) {
  constexpr int CH = DHP / 8;
  for (int c = threadIdx.x; c < ROWS * CH; c += THREADS) {
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

// One warp's step over a block of 32 keys: S = Q K^T for its 16 query
// rows (Qw, row pitch LDS) against the block's keys (Kt), then the online
// softmax and O += P V (Vt).  The thread holds rows lane/4 (a) and +8
// (b), with query positions qpos_a and qpos_b; `whole`: every key of the
// block is visible to every row of the warp (no mask).  The row sums l
// are per-thread partials (the quad's sum is taken at the end).
template <int DHP, int LDS>
__device__ __forceinline__ void warp_block(
    const __nv_bfloat16* Qw, const __nv_bfloat16* Kt,
    const __nv_bfloat16* Vt, const Params& P, int k_first, bool whole,
    int qpos_a, int qpos_b, float& m_a, float& m_b, float& l_a, float& l_b,
    float (&o)[DHP / 8][4]) {
  constexpr int BN = 32;
  const int lane = threadIdx.x % 32;
  const int tig = lane & 3;
  float s[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // S = Q K^T: A = Q rows (row-major), B = K^T (K rows are its columns);
  // one ldmatrix.x4 gives the A tile, or the B tiles of two 8-key column
  // blocks
#pragma unroll
  for (int ks = 0; ks < DHP / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, Qw + (lane & 15) * LDS + ks * 16 + (lane >> 4) * 8);
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
  // scale, cap, mask (skipped for a whole block); the online softmax of
  // rows a and b in base 2: the scores are scaled by log2(e), which leaves
  // the softmax as it is
  logits<BN / 2>(P, &s[0][0]);
  if (!whole) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k_first + j * 8 + tig * 2 + e;
        s[j][e] = visible(P, col, qpos_a) ? s[j][e] : NEG;
        s[j][2 + e] = visible(P, col, qpos_b) ? s[j][2 + e] : NEG;
      }
    }
  }
  float mx_a = NEG, mx_b = NEG;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
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
    const uint32_t a[4] = {hopper::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                           hopper::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                           hopper::pack_bf16(s[2 * kk + 1][0],
                                             s[2 * kk + 1][1]),
                           hopper::pack_bf16(s[2 * kk + 1][2],
                                             s[2 * kk + 1][3])};
#pragma unroll
    for (int t = 0; t < DHP / 8; t += 2) {
      uint32_t vr[4];
      ldsm_x4_t(vr, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                         t * 8 + (lane >> 4) * 8);
      const uint32_t b0[2] = {vr[0], vr[1]}, b1[2] = {vr[2], vr[3]};
      mma_bf16(o[t], a, b0);
      mma_bf16(o[t + 1], a, b1);
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
    const int k_first = kb * BN, k_last = kb * BN + BN - 1;
    const bool whole = k_last < P.kv_len &&
                       (!P.causal || k_last <= wq_min) &&
                       (P.window <= 0 || k_first > wq_max - P.window);
    if (live)
      warp_block<DHP, LDS>(Qs + wrow * LDS, Ks + buf * BN * LDS,
                           Vs + buf * BN * LDS, P, k_first, whole, qpos_a,
                           qpos_b, m_a, m_b, l_a, l_b, o);
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
// bf16 decode: a ring of 32-key blocks, the KV loop split across CTAs
// ---------------------------------------------------------------------------

// The split decode it replaced staged a 128-key chunk (135 KB at dh 256:
// one CTA an SM) and waited for all of it before any math, so its SM had
// no load in flight while it computed.  fa_ring_kernel streams 32-key
// blocks of K and V through a ring of STAGES stages (33 KB each at dh 256;
// 107 KB with Q: two CTAs an SM), each stage's loads one cp.async group: a
// CTA starts with all STAGES blocks in flight, and while block j is
// computed the next STAGES - 1 are.  Each of the 4 warps takes 8 keys of a
// block: S (16 rows x 8 keys) on mma.sync m16n8k16 over dh, then O += P V
// on m16n8k8, whose A operand is the layout of S's accumulator; each warp
// keeps its own softmax state and 16 x DHP float32 O (128 registers a
// thread at dh 256), and the warps' states merge at the end.  plan() sizes
// the splits from the residency the occupancy API reports, so the grid is
// one wave, and each split takes an equal share of the blocks (within
// one).  Head dims up to 32 take DHP 32, the columns past dh zero.
constexpr int RING_THREADS = 128;              // 4 warps
constexpr int SPLIT_ROWS = 16;                 // folded rows: one mma tile
constexpr int RING_KEYS = 32;                  // keys of a block: 8 a warp
constexpr int RING_MAX_SPLITS = 256;           // partials a (n, KV head)
constexpr int RING_MIN_DHP = 32;               // dh 16 runs zero-padded

template <int DHP>
struct RingShape {
  static_assert(DHP % 32 == 0, "whole 32-dim steps of S");
  static constexpr int LDS = DHP + 8;          // smem row pitch: no conflicts
  static constexpr int STAGES = DHP == 256 ? 3 : 4;
  static constexpr int Q_ELEMS = SPLIT_ROWS * LDS;
  static constexpr int STAGE_ELEMS = 2 * RING_KEYS * LDS;   // K, then V
  static constexpr int PS = SPLIT_ROWS * (DHP + 2);  // floats of a partial
  static constexpr int KV = (Q_ELEMS + STAGES * STAGE_ELEMS) * 2;
  // after the loop the same memory holds the warps' partials, then in the
  // last CTA of (n, h) the split groups' merged states (o, m and l)
  static constexpr int PART = 4 * PS * 4;
  static constexpr int MERGE = SPLIT_ROWS * (DHP / 4) * (16 + 8);
  static constexpr int MAX_AFTER = PART > MERGE ? PART : MERGE;
  static constexpr int SMEM = KV > MAX_AFTER ? KV : MAX_AFTER;
};

// One warp's share of a block: its 8 keys (rows Kw of K and Vw of V, the
// first at position k_first) against the 16 query rows Qs; the online
// softmax of rows a and b (l a per-thread partial) and O += P V, as in
// warp_block.
template <int DHP, int LDS>
__device__ __forceinline__ void ring_step(
    const __nv_bfloat16* Qs, const __nv_bfloat16* Kw,
    const __nv_bfloat16* Vw, const Params& P, int k_first, int qpos_a,
    int qpos_b, float& m_a, float& m_b, float& l_a, float& l_b,
    float (&o)[DHP / 8][4]) {
  const int lane = threadIdx.x % 32, tig = lane & 3;
  // S = Q K^T, 32 dims a step: two A tiles of Q, and one ldmatrix.x4 of
  // the 8 keys gives the B operands of both 16-dim steps
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k32 = 0; k32 < DHP / 32; ++k32) {
    uint32_t a0[4], a1[4], kr[4];
    ldsm_x4(a0, Qs + (lane & 15) * LDS + k32 * 32 + (lane >> 4) * 8);
    ldsm_x4(a1, Qs + (lane & 15) * LDS + k32 * 32 + 16 + (lane >> 4) * 8);
    ldsm_x4(kr, Kw + (lane & 7) * LDS + k32 * 32 + (lane >> 3) * 8);
    const uint32_t b0[2] = {kr[0], kr[1]}, b1[2] = {kr[2], kr[3]};
    mma_bf16(s, a0, b0);
    mma_bf16(s, a1, b1);
  }
  logits<4>(P, s);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int col = k_first + 2 * tig + e;
    s[e] = visible(P, col, qpos_a) ? s[e] : NEG;
    s[2 + e] = visible(P, col, qpos_b) ? s[2 + e] : NEG;
  }
  const float mn_a = fmaxf(m_a, quad_max(fmaxf(s[0], s[1])));
  const float mn_b = fmaxf(m_b, quad_max(fmaxf(s[2], s[3])));
  const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
  const float p0 = exp2f(s[0] - mn_a), p1 = exp2f(s[1] - mn_a);
  const float p2 = exp2f(s[2] - mn_b), p3 = exp2f(s[3] - mn_b);
  l_a = l_a * al_a + p0 + p1;
  l_b = l_b * al_b + p2 + p3;
  const uint32_t a[2] = {hopper::pack_bf16(p0, p1),
                         hopper::pack_bf16(p2, p3)};
  // O += P V: output tile t's B is the 8 keys x 8 columns of V, read
  // transposed; one ldmatrix.x4.trans gives four tiles' B
#pragma unroll
  for (int t = 0; t < DHP / 8; t += 4) {
    uint32_t vr[4];
    ldsm_x4_t(vr, Vw + (lane & 7) * LDS + t * 8 + (lane >> 3) * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[t + i][0] *= al_a;
      o[t + i][1] *= al_a;
      o[t + i][2] *= al_b;
      o[t + i][3] *= al_b;
      mma_bf16_k8(o[t + i], a, vr[i]);
    }
  }
}

// Split `split` of (n, h) walks its share of the 32-key blocks of [key_lo,
// key_hi); the warps' states merge into the CTA's partial (o unnormalized,
// m and l in base 2) at part[(n*HK + h)*splits + split], and the last CTA
// of (n, h) to finish (its ticket) merges the splits into the output and
// re-arms the ticket.  With one split the merged state is the output.
template <int DHP>
__global__ void __launch_bounds__(RING_THREADS)
    fa_ring_kernel(Params P, float* part, int* tickets, int splits,
                   int key_lo, int key_hi) {
  using T = __nv_bfloat16;
  using R = RingShape<DHP>;
  constexpr int LDS = R::LDS, PS = R::PS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* ring = Qs + R::Q_ELEMS;
  __shared__ int last;

  const int split = blockIdx.x, h = blockIdx.y, n = blockIdx.z;
  const int rows = P.sq * P.g;                 // <= SPLIT_ROWS
  const T* qb = static_cast<const T*>(P.q) + n * P.q_sn + h * P.q_sh;
  const T* kb0 = static_cast<const T*>(P.k) + n * P.k_sn + h * P.k_sh;
  const T* vb0 = static_cast<const T*>(P.v) + n * P.v_sn + h * P.v_sh;
  const T* any = static_cast<const T*>(P.q);
  const int nblocks = (key_hi - key_lo + RING_KEYS - 1) / RING_KEYS;
  const int b0 = static_cast<int>((long long)split * nblocks / splits);
  const int nb =
      static_cast<int>((long long)(split + 1) * nblocks / splits) - b0;

  stage_rows<DHP, LDS, SPLIT_ROWS, RING_THREADS>(
      Qs,
      [&](int r) -> const T* {
        return r < rows ? qb + (r / P.g) * P.q_ss + (r % P.g) * P.q_sg
                        : nullptr;
      },
      any, P.dh, P.vec_ok);
  // a block's K and V rows: with 16-byte strides thread t copies the
  // 16-byte chunk t % CH of rows t / CH + i * RPP, its addresses a stride
  // apart (a fixed loop, no division), else stage_rows' element loads
  constexpr int CH = DHP / 8, RPP = RING_THREADS / CH;   // rows a pass
  const int c_d0 = (threadIdx.x % CH) * 8, c_r0 = threadIdx.x / CH;
  auto load = [&](int stage, int b) {
    const int k0 = key_lo + b * RING_KEYS;
    T* Ks = ring + stage * R::STAGE_ELEMS;
    if (P.vec_ok) {
#pragma unroll
      for (int i = 0; i < RING_KEYS / RPP; ++i) {
        const int r = c_r0 + i * RPP, j = k0 + r;
        const bool in = j < key_hi && c_d0 < P.dh;
        cp_async16(Ks + r * LDS + c_d0, in ? kb0 + j * P.k_ss + c_d0 : any,
                   in ? 16 : 0);
        cp_async16(Ks + (RING_KEYS + r) * LDS + c_d0,
                   in ? vb0 + j * P.v_ss + c_d0 : any, in ? 16 : 0);
      }
      return;
    }
    stage_rows<DHP, LDS, RING_KEYS, RING_THREADS>(
        Ks,
        [&](int r) -> const T* {
          return k0 + r < key_hi ? kb0 + (k0 + r) * P.k_ss : nullptr;
        },
        any, P.dh, P.vec_ok);
    stage_rows<DHP, LDS, RING_KEYS, RING_THREADS>(
        Ks + RING_KEYS * LDS,
        [&](int r) -> const T* {
          return k0 + r < key_hi ? vb0 + (k0 + r) * P.v_ss : nullptr;
        },
        any, P.dh, P.vec_ok);
  };
  // fill the ring: one group a stage (Q in the first), empty groups past
  // the split's blocks, so that group j holds block j
  for (int i = 0; i < R::STAGES; ++i) {
    if (i < nb) load(i, b0 + i);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int qpos_a = P.q0 + gid / P.g;
  const int qpos_b = P.q0 + (gid + 8) / P.g;
  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;
  float o[DHP / 8][4];
#pragma unroll
  for (int t = 0; t < DHP / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;

  for (int j = 0; j < nb; ++j) {
    const int stage = j % R::STAGES;
    cp_async_wait<R::STAGES - 1>();   // this thread's loads of block j
    __syncthreads();                  // and every thread's have landed
    const T* Ks = ring + stage * R::STAGE_ELEMS;
    ring_step<DHP, LDS>(Qs, Ks + warp * 8 * LDS,
                        Ks + (RING_KEYS + warp * 8) * LDS, P,
                        key_lo + (b0 + j) * RING_KEYS + warp * 8, qpos_a,
                        qpos_b, m_a, m_b, l_a, l_b, o);
    __syncthreads();                  // every warp is done with the stage
    if (j + R::STAGES < nb) load(stage, b0 + j + R::STAGES);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' states of the live rows -> shared memory: m, l, o
  float* wm = reinterpret_cast<float*>(smem_raw) + warp * PS;
  float* wl = wm + SPLIT_ROWS;
  float* wo = wl + SPLIT_ROWS;
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = gid + 8 * half;
    if (r >= rows) continue;
    if (tig == 0) {
      wm[r] = half ? m_b : m_a;
      wl[r] = half ? l_b : l_a;
    }
#pragma unroll
    for (int t = 0; t < DHP / 8; ++t)
      *reinterpret_cast<float2*>(wo + r * DHP + t * 8 + tig * 2) =
          make_float2(o[t][2 * half], o[t][2 * half + 1]);
  }
  __syncthreads();

  // the CTA's partial: the warps merged by their maxima; with one split it
  // is the output, written at once (no partial, no ticket)
  const long long group = (long long)n * P.hk + h;
  float* pg = part + group * splits * PS;
  T* ob = static_cast<T*>(P.o) + n * P.o_sn + h * P.o_sh;
  auto at = [&](int w) {
    return reinterpret_cast<const float*>(smem_raw) + w * PS;
  };
  for (int i = threadIdx.x; i < rows * DHP; i += RING_THREADS) {
    const int r = i / DHP, d = i % DHP;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < 4; ++w) M = fmaxf(M, at(w)[r]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float f = exp2f(at(w)[r] - M);
      L += at(w)[SPLIT_ROWS + r] * f;
      O += at(w)[2 * SPLIT_ROWS + r * DHP + d] * f;
    }
    if (splits == 1) {
      if (d < P.dh)
        ob[(r / P.g) * P.o_ss + (r % P.g) * P.o_sg + d] =
            __float2bfloat16(O / fmaxf(L, 1e-30f));
      continue;
    }
    float* ps = pg + (long long)split * PS;
    ps[2 * SPLIT_ROWS + r * DHP + d] = O;
    if (d == 0) {
      ps[r] = M;
      ps[SPLIT_ROWS + r] = L;
    }
  }
  if (splits == 1) return;
  __threadfence();               // the partial is visible before the ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + group, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last CTA of (n, h): the splits cut into sg groups, so that every
  // thread has loads to make; a thread merges, for its output float4 and
  // its group's splits, each split's m, l and o into a running state (the
  // loads of one split independent of the state, so unrolled they are in
  // flight together), and the groups' states meet in shared memory
  const int cells = rows * (DHP / 4);           // float4s of the output
  const int sg = max(1, RING_THREADS / cells);  // split groups
  float4* red_o = reinterpret_cast<float4*>(smem_raw);
  float2* red_ml = reinterpret_cast<float2*>(red_o + SPLIT_ROWS * (DHP / 4));
  for (int i = threadIdx.x; i < cells * sg; i += RING_THREADS) {
    const int c = i % cells, gr = i / cells;
    const int r = c / (DHP / 4), d = (c % (DHP / 4)) * 4;
    float M = NEG, L = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int sp = gr; sp < splits; sp += sg) {
      const float* ps = pg + (long long)sp * PS;
      const float m = __ldcg(ps + r), l = __ldcg(ps + SPLIT_ROWS + r);
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          ps + 2 * SPLIT_ROWS + r * DHP + d));
      const float mn = fmaxf(M, m);
      const float fo = exp2f(M - mn), fn = exp2f(m - mn);
      L = L * fo + l * fn;
      acc.x = acc.x * fo + v.x * fn;
      acc.y = acc.y * fo + v.y * fn;
      acc.z = acc.z * fo + v.z * fn;
      acc.w = acc.w * fo + v.w * fn;
      M = mn;
    }
    red_o[i] = acc;
    red_ml[i] = make_float2(M, L);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += RING_THREADS) {
    const int r = c / (DHP / 4), d = (c % (DHP / 4)) * 4;
    float M = NEG;
    for (int gr = 0; gr < sg; ++gr) M = fmaxf(M, red_ml[gr * cells + c].x);
    float L = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int gr = 0; gr < sg; ++gr) {
      const float2 ml = red_ml[gr * cells + c];
      const float4 v = red_o[gr * cells + c];
      const float f = exp2f(ml.x - M);
      L += ml.y * f;
      a[0] += v.x * f;
      a[1] += v.y * f;
      a[2] += v.z * f;
      a[3] += v.w * f;
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    T* orow = ob + (r / P.g) * P.o_ss + (r % P.g) * P.o_sg;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d + e < P.dh) orow[d + e] = __float2bfloat16(a[e] * inv);
  }
  if (threadIdx.x == 0) tickets[group] = 0;
}

// ---------------------------------------------------------------------------
// bf16 prefill: wgmma and TMA (dh 64, 128 or 256)
// ---------------------------------------------------------------------------

// dh 64 and 128: 128-key blocks, 384 threads, the third warpgroup the
// producer (its registers moved to the consumers by setmaxnreg).  dh 256:
// 64-key blocks, so that S (32 float32 registers a thread on m64n64) sits
// beside O (64 x 256 float32 a warpgroup: 128 registers), P and the
// softmax state (128-key blocks would put S at 64); and 256 threads, the
// two consumer warpgroups alone, thread 0 issuing the TMA loads between
// its products.  ptxas compiled the consumers of a 384-thread CTA within
// 168 registers a thread (three warps share an SM sub-partition's 16 384
// registers), whatever setmaxnreg moves at run time: S and O spilled and
// the wgmma instructions were serialized (C7512), as at 288 threads;
// with 256 threads each has up to 255.  Shared memory at dh 256: Q 64
// KB, two K and two V stages of 32 KB each, 193 KB in all.
template <int DH>
struct WgShape {
  static constexpr int BM = 128;              // folded rows of a CTA
  static constexpr int BN = DH == 256 ? 64 : 128;   // keys of a K/V block
  static constexpr int Q_BOX = BM * 128;      // a Q box: BM rows of 64 dims
  static constexpr int KV_BOX = BN * 128;     // a K/V box: BN rows of 64 dims
  static constexpr int Q_BYTES = BM * DH * 2;
  static constexpr int KV_BYTES = BN * DH * 2;
  static constexpr int STAGES = 2;
  static constexpr int THREADS = DH == 256 ? 256 : 384;
  static constexpr bool PRODUCER_WG = THREADS == 384;  // else thread 0
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024 + 256;
};

// Where the key, head and batch coordinates go in a K/V tensor map, whose
// outer dims are ordered by stride.
struct KvOrder {
  int key, head, batch;
};

// The map's coordinate of dim 1 + i (selects, not an indexed array: the
// producer thread runs on the registers setmaxnreg leaves it).
__device__ __forceinline__ int kv_coord(const KvOrder& ord, int i, int j,
                                        int h, int n) {
  return ord.key == i ? j : ord.head == i ? h : n;
}

// S (m64 x BN keys) += Q K^T, one k16 step.
template <int BN>
__device__ __forceinline__ void wgmma_qk(float (&s)[BN / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (BN == 64)
    hopper::wgmma_ss_n64_bf16<0>(s, da, db, scale_d);
  else
    hopper::wgmma_ss_n128_bf16<0>(s, da, db, scale_d);
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DH == 64)
    hopper::wgmma_rs_n64_bf16<1>(o, a, db, 1);
  else if constexpr (DH == 128)
    hopper::wgmma_rs_n128_bf16<1>(o, a, db, 1);
  else
    hopper::wgmma_rs_n256_bf16<1>(o, a, db, 1);
}

// Q of a tile (ROWS folded rows of DH dims from row0; rows at or beyond
// `rows` zero) into the 128-byte swizzle, boxes of 64 dims BOX bytes
// apart, by the 256 consumer threads: every thread issues all its 16-byte
// loads before its first store, so the tile costs one round trip to
// memory, not one a load (a CTA alone on its SM waits through all of
// them).  A tile of folded rows is not a TMA box when G does not divide
// it.
template <int ROWS, int DH, int BOX>
__device__ __forceinline__ void stage_q(unsigned char* Qs,
                                        const __nv_bfloat16* qb,
                                        const Params& P, int row0,
                                        int rows) {
  constexpr int CH = DH / 8;                  // 16-byte chunks of a row
  constexpr int N = ROWS * CH / 256;          // a thread's chunks
  static_assert(ROWS * CH % 256 == 0, "Q tile in whole passes");
  int4 v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = threadIdx.x + 256 * i;
    const int R = row0 + c / CH;
    v[i] = make_int4(0, 0, 0, 0);
    if (R < rows)
      v[i] = __ldg(reinterpret_cast<const int4*>(
          qb + (R / P.g) * P.q_ss + (R % P.g) * P.q_sg + (c % CH) * 8));
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = threadIdx.x + 256 * i;
    const int r = c / CH, k = c % CH;
    *reinterpret_cast<int4*>(Qs + (k / 8) * BOX + r * 128 +
                             (((k % 8) ^ (r % 8)) * 16)) = v[i];
  }
}

// A CTA: 128 folded query rows (row = i*G + g) of one (n, KV head), the
// heaviest row tiles first; warpgroups 0-1 hold 64 rows each; the TMA
// producer of BN-key K/V blocks (2 stages) is thread 256 of a third
// warpgroup, or at dh 256 thread 0 between its products (WgShape).
template <int DH>
__global__ void __launch_bounds__(WgShape<DH>::THREADS, 1)
    fa_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, Params P,
                    KvOrder ok, KvOrder ov) {
  using T = __nv_bfloat16;
  using S = WgShape<DH>;
  constexpr int BOXES = DH / 64;
  constexpr int NS = S::BN / 2;              // S registers a thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = hopper::smem_u32(smem_raw);
  unsigned char* Qs = smem_raw + (((base + 1023u) & ~1023u) - base);
  unsigned char* Ks = Qs + S::Q_BYTES;
  unsigned char* Vs = Ks + S::STAGES * S::KV_BYTES;
  uint64_t* full_k = reinterpret_cast<uint64_t*>(Vs + S::STAGES * S::KV_BYTES);
  uint64_t* full_v = full_k + S::STAGES;
  uint64_t* empty_k = full_v + S::STAGES;   // K read by S = Q K^T
  uint64_t* empty_v = empty_k + S::STAGES;  // V read by O += P V

  const int rows = P.sq * P.g;
  const int tiles = (rows + S::BM - 1) / S::BM;
  const int groups = P.n * P.hk;
  const int nh = blockIdx.x % groups;
  const int n = nh / P.hk, h = nh % P.hk;
  const int row0 = (tiles - 1 - blockIdx.x / groups) * S::BM;
  const int row_end = min(row0 + S::BM, rows);
  int kb_lo, kb_hi;
  block_range(P, S::BN, P.q0 + row0 / P.g, P.q0 + (row_end - 1) / P.g,
              &kb_lo, &kb_hi);
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::STAGES; ++i) {
      hopper::mbar_init(&full_k[i], 1);
      hopper::mbar_init(&full_v[i], 1);
      hopper::mbar_init(&empty_k[i], 8);    // the consumer warps
      hopper::mbar_init(&empty_v[i], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // the producer's step: block kb's K and V by TMA into the stage `ps`
  // names, once the consumers have freed it
  auto produce = [&](hopper::PipeState& ps, int kb) {
    hopper::mbar_wait(&empty_k[ps.stage], ps.phase ^ 1u);
    hopper::mbar_expect_tx(&full_k[ps.stage], S::KV_BYTES);
    const int j = kb * S::BN;
    for (int b = 0; b < BOXES; ++b)
      hopper::tma_load_4d(Ks + ps.stage * S::KV_BYTES + b * S::KV_BOX, &tm_k,
                          &full_k[ps.stage], b * 64, kv_coord(ok, 0, j, h, n),
                          kv_coord(ok, 1, j, h, n), kv_coord(ok, 2, j, h, n));
    hopper::mbar_wait(&empty_v[ps.stage], ps.phase ^ 1u);
    hopper::mbar_expect_tx(&full_v[ps.stage], S::KV_BYTES);
    for (int b = 0; b < BOXES; ++b)
      hopper::tma_load_4d(Vs + ps.stage * S::KV_BYTES + b * S::KV_BOX, &tm_v,
                          &full_v[ps.stage], b * 64, kv_coord(ov, 0, j, h, n),
                          kv_coord(ov, 1, j, h, n), kv_coord(ov, 2, j, h, n));
    ps.advance(S::STAGES);
  };
  hopper::PipeState ps;                 // the producer's place in the ring
  if constexpr (S::PRODUCER_WG) {
    if (threadIdx.x >= 256) {
      // ---- the producer warpgroup: thread 256 ------------------------------
      hopper::reg_dealloc<40>();
      if (threadIdx.x != 256) return;
      for (int kb = kb_lo; kb < kb_hi; ++kb) produce(ps, kb);
      return;
    }
    hopper::reg_alloc<232>();
  } else if (threadIdx.x == 0) {        // thread 0 fills the ring first
    for (int kb = kb_lo; kb < min(kb_hi, kb_lo + S::STAGES); ++kb)
      produce(ps, kb);
  }

  // ---- the consumers --------------------------------------------------------
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, gid = lane >> 2, tig = lane & 3;
  // Q (stage_q), then a barrier of the two consumer warpgroups
  stage_q<S::BM, DH, S::Q_BOX>(
      Qs, static_cast<const T*>(P.q) + n * P.q_sn + h * P.q_sh, P, row0,
      rows);
  hopper::fence_proxy_async_shared();    // generic stores -> wgmma reads
  hopper::named_bar_sync(1, 256);

  const int wrow = wg * 64 + warp * 16;          // the warp's first row
  const int qpos_a = P.q0 + (row0 + wrow + gid) / P.g;
  const int qpos_b = P.q0 + (row0 + wrow + gid + 8) / P.g;
  const int wq_min = P.q0 + (row0 + wg * 64) / P.g;
  const int wq_max = P.q0 + (row0 + wg * 64 + 63) / P.g;
  // the keys [lo, hi) that rows a and b see (visible(), as two bounds)
  const int lo_a = P.window > 0 ? max(0, qpos_a - P.window + 1) : 0;
  const int lo_b = P.window > 0 ? max(0, qpos_b - P.window + 1) : 0;
  const int hi_a = P.causal ? min(P.kv_len, qpos_a + 1) : P.kv_len;
  const int hi_b = P.causal ? min(P.kv_len, qpos_b + 1) : P.kv_len;
  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  const uint64_t dq = hopper::desc_sw128(Qs + wg * 64 * 128, 16, 1024);

  hopper::PipeState st;
  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    // S = Q K^T (both K-major): 64 rows x BN keys per warpgroup
    float s[NS];
    hopper::mbar_wait(&full_k[st.stage], st.phase);
    const uint64_t dk = hopper::desc_sw128(Ks + st.stage * S::KV_BYTES, 16,
                                           1024);
    hopper::fence_operands(s);
    hopper::wg_fence();
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      const uint64_t inner = (ks % 4) * 2;   // 32 bytes a k16 step
      wgmma_qk<S::BN>(s, dq + (ks / 4) * (S::Q_BOX >> 4) + inner,
                      dk + (ks / 4) * (S::KV_BOX >> 4) + inner, ks > 0);
    }
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::fence_operands(s);
    if (lane == 0) hopper::mbar_arrive(&empty_k[st.stage]);

    // the online softmax in base 2 (the mask only where the block crosses
    // the causal edge, the window or kv_len for some row of the warpgroup)
    const int k_first = kb * S::BN, k_last = k_first + S::BN - 1;
    const bool whole = k_last < P.kv_len &&
                       (!P.causal || k_last <= wq_min) &&
                       (P.window <= 0 || k_first > wq_max - P.window);
    logits<NS>(P, s);
    if (!whole) {   // a real branch, taken where the block crosses an edge
      // score (j, e) is key k_first + 2 tig + 8j + e: two compares of a
      // constant with the row's bounds shifted by k_first + 2 tig (the
      // visible() test per score ran the consumers out of registers)
      const int base = k_first + 2 * tig;
      const int la = lo_a - base, ha = hi_a - base;
      const int lb = lo_b - base, hb = hi_b - base;
#pragma unroll
      for (int j = 0; j < S::BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + e;
          s[4 * j + e] = (c >= la) & (c < ha) ? s[4 * j + e] : NEG;
          s[4 * j + 2 + e] = (c >= lb) & (c < hb) ? s[4 * j + 2 + e] : NEG;
        }
      }
    }
    float mx_a = NEG, mx_b = NEG;
#pragma unroll
    for (int j = 0; j < S::BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx_a = fmaxf(mx_a, s[4 * j + e]);
        mx_b = fmaxf(mx_b, s[4 * j + 2 + e]);
      }
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < S::BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] = exp2f(s[4 * j + e] - mn_a);
        s[4 * j + 2 + e] = exp2f(s[4 * j + 2 + e] - mn_b);
        sum_a += s[4 * j + e];
        sum_b += s[4 * j + 2 + e];
      }
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[4 * j] *= al_a;
      o[4 * j + 1] *= al_a;
      o[4 * j + 2] *= al_b;
      o[4 * j + 3] *= al_b;
    }

    // O += P V: P (bf16) from the S registers is the register A operand of
    // each 16-key step (the accumulator's layout of key groups 2kk and
    // 2kk+1 is A's); V [keys, dh] is MN-major (transpose-B)
    hopper::mbar_wait(&full_v[st.stage], st.phase);
    const uint64_t dv = hopper::desc_sw128(Vs + st.stage * S::KV_BYTES,
                                           S::KV_BOX, 1024);
    uint32_t pa[S::BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < S::BN / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] =
            hopper::pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    hopper::fence_operands(o);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < S::BN / 16; ++kk)
      wgmma_pv<DH>(o, pa[kk], dv + kk * (16 * 128 >> 4));
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::fence_operands(o);
    if (lane == 0) hopper::mbar_arrive(&empty_v[st.stage]);
    st.advance(S::STAGES);
    if constexpr (!S::PRODUCER_WG) {
      // thread 0: block kb + STAGES into the stage block kb leaves, once
      // the other warpgroup is done with it too
      if (threadIdx.x == 0 && kb + S::STAGES < kb_hi)
        produce(ps, kb + S::STAGES);
    }
  }

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
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + tig * 2) =
          __floats2bfloat162_rn(o[4 * j + 2 * half] * inv,
                                o[4 * j + 2 * half + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// bf16 prefill at dh 64: the softmax under the products
// ---------------------------------------------------------------------------

// At dh 64 a 64 x 128 block of scores costs as many clocks of the SM's
// exponential units (8192 ex2 at 16 a clock) as of its tensor cores (2 x
// 1.05 MFLOP), so fa_wgmma_kernel<64>'s order (S, wait, softmax, O += P
// V, wait) leaves the tensor cores idle through every softmax.
// fa_wgmma64_kernel runs the softmax under the products:
//   * within a warpgroup, S_j = Q K_j^T is issued with O += P_{j-1} V_{j-1}
//     and block j's softmax runs in S's registers while the PV product
//     runs (wgmma_wait<1>, then <0>); P_j (bf16, the PV product's register
//     operand) is packed from them once that product is done, so S (64
//     registers on m64n128), P (32) and O (32) fit ptxas's 168 (a second
//     P buffer spilled);
//   * between the two consumer warpgroups, a ping-pong on named barriers
//     2 and 3: a warpgroup issues its products after the other has issued
//     its own, so one's exponentials run under the other's products
//     (FlashAttention-3's schedule);
//   * no register that a product in flight reads or writes is touched: a
//     register defined under a product serializes the products (ptxas
//     C7513, C7515), so P and O's rescale come after the wait, O's zeros
//     are pinned before the loop and the descriptors are made before the
//     products;
//   * a score is one FFMA (to base 2, less the row maximum) and one
//     ex2.approx, and the mask is tested only on blocks that cross an edge.
// A CTA holds 128 folded rows and walks 128-key blocks with 288 threads:
// the two consumer warpgroups and a producer warp (thread 256 issues the
// TMA loads, always ahead: loads issued by a consumer between its blocks
// took about 7 % longer), within ptxas's 168 registers a thread (S 64, P
// 32, O 32).  A softcap's tanh would not fit beside them: capped calls
// take fa_wgmma_kernel<64>.  Four K and four V stages of 16 KB beside Q
// (16 KB).
struct Wg64Shape {
  static constexpr int DH = 64;
  static constexpr int BM = 128;              // folded rows of a CTA
  static constexpr int BN = 128;              // keys of a K/V block
  static constexpr int Q_BOX = BM * 128;      // BM rows of 64 dims
  static constexpr int KV_BOX = BN * 128;
  static constexpr int Q_BYTES = BM * DH * 2;
  static constexpr int KV_BYTES = BN * DH * 2;
  static constexpr int STAGES = 4;
  static constexpr int THREADS = 288;
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024 + 256;
};

// Keeps the compiler from moving accesses of P's registers across a
// wgmma wait: a product that reads them runs until it is waited for.
template <int N>
__device__ __forceinline__ void fence_u32(uint32_t (&p)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(p[i][e])::"memory");
}

// The online softmax of a block's S, in place (64 rows x NS / 2 keys, key
// 8j + 2 tig + e of the block in s[4j + e] (row a) and s[4j + 2 + e] (row
// b)): the running maxima m and sums l (per-thread partials) of rows a
// and b, their rescale al, and each score's p in its place.  With MASK, keys
// outside [lo, hi) of a row (bounds relative to the thread's first key)
// are -inf (a block that crosses no edge skips the test: two compares
// and a select a score, twice, cost as much as the rest of the softmax);
// sc takes a score to base 2.
template <bool MASK, int NS>
__device__ __forceinline__ void block_softmax(float (&s)[NS], float sc,
                                              int la, int ha, int lb, int hb,
                                              float (&m)[2], float (&l)[2],
                                              float (&al)[2]) {
  auto v = [&](int i, int lo, int hi) {
    const int c = 8 * (i / 4) + (i % 2);
    return !MASK || ((c >= lo) & (c < hi)) ? s[i] : -INFINITY;
  };
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx_a = fmaxf(mx_a, v(4 * j + e, la, ha));
      mx_b = fmaxf(mx_b, v(4 * j + 2 + e, lb, hb));
    }
  }
  const float mn_a = fmaxf(m[0], quad_max(mx_a) * sc);
  const float mn_b = fmaxf(m[1], quad_max(mx_b) * sc);
  al[0] = hopper::ex2(m[0] - mn_a);
  al[1] = hopper::ex2(m[1] - mn_b);
  m[0] = mn_a;
  m[1] = mn_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    const float p0 = hopper::ex2(fmaf(v(4 * j, la, ha), sc, -mn_a));
    const float p1 = hopper::ex2(fmaf(v(4 * j + 1, la, ha), sc, -mn_a));
    const float p2 = hopper::ex2(fmaf(v(4 * j + 2, lb, hb), sc, -mn_b));
    const float p3 = hopper::ex2(fmaf(v(4 * j + 3, lb, hb), sc, -mn_b));
    sum_a += p0 + p1;
    sum_b += p2 + p3;
    s[4 * j] = p0;
    s[4 * j + 1] = p1;
    s[4 * j + 2] = p2;
    s[4 * j + 3] = p3;
  }
  l[0] = l[0] * al[0] + sum_a;
  l[1] = l[1] * al[1] + sum_b;
}

// A CTA: 128 folded query rows of one (n, KV head), the heaviest row tiles
// first, as fa_wgmma_kernel; the masked scores are -inf, so a score's
// exponential is one FFMA and one ex2 (a row that sees no key at all sums
// to 0 and writes 0).
__global__ void __launch_bounds__(Wg64Shape::THREADS, 1)
    fa_wgmma64_kernel(const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, Params P,
                      KvOrder ok, KvOrder ov) {
  using T = __nv_bfloat16;
  using S = Wg64Shape;
  constexpr int NS = S::BN / 2;              // S registers a thread
  constexpr int NK = S::BN / 16;             // 16-key steps of O += P V
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = hopper::smem_u32(smem_raw);
  unsigned char* Qs = smem_raw + (((base + 1023u) & ~1023u) - base);
  unsigned char* Ks = Qs + S::Q_BYTES;
  unsigned char* Vs = Ks + S::STAGES * S::KV_BYTES;
  uint64_t* full_k = reinterpret_cast<uint64_t*>(Vs + S::STAGES * S::KV_BYTES);
  uint64_t* full_v = full_k + S::STAGES;
  uint64_t* empty_k = full_v + S::STAGES;   // K read by S = Q K^T
  uint64_t* empty_v = empty_k + S::STAGES;  // V read by O += P V

  const int rows = P.sq * P.g;
  const int tiles = (rows + S::BM - 1) / S::BM;
  const int groups = P.n * P.hk;
  const int nh = blockIdx.x % groups;
  const int n = nh / P.hk, h = nh % P.hk;
  const int row0 = (tiles - 1 - blockIdx.x / groups) * S::BM;
  const int row_end = min(row0 + S::BM, rows);
  int kb_lo, kb_hi;
  block_range(P, S::BN, P.q0 + row0 / P.g, P.q0 + (row_end - 1) / P.g,
              &kb_lo, &kb_hi);
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::STAGES; ++i) {
      hopper::mbar_init(&full_k[i], 1);
      hopper::mbar_init(&full_v[i], 1);
      hopper::mbar_init(&empty_k[i], 8);    // the consumer warps
      hopper::mbar_init(&empty_v[i], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- the producer warp: thread 256 ----------------------------------
    if (threadIdx.x != 256) return;
    hopper::PipeState ps;
    for (int kb = kb_lo; kb < kb_hi; ++kb) {
      const int j = kb * S::BN;
      hopper::mbar_wait(&empty_k[ps.stage], ps.phase ^ 1u);
      hopper::mbar_expect_tx(&full_k[ps.stage], S::KV_BYTES);
      hopper::tma_load_4d(Ks + ps.stage * S::KV_BYTES, &tm_k,
                          &full_k[ps.stage], 0, kv_coord(ok, 0, j, h, n),
                          kv_coord(ok, 1, j, h, n), kv_coord(ok, 2, j, h, n));
      hopper::mbar_wait(&empty_v[ps.stage], ps.phase ^ 1u);
      hopper::mbar_expect_tx(&full_v[ps.stage], S::KV_BYTES);
      hopper::tma_load_4d(Vs + ps.stage * S::KV_BYTES, &tm_v,
                          &full_v[ps.stage], 0, kv_coord(ov, 0, j, h, n),
                          kv_coord(ov, 1, j, h, n), kv_coord(ov, 2, j, h, n));
      ps.advance(S::STAGES);
    }
    return;
  }

  // ---- the consumers --------------------------------------------------------
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, gid = lane >> 2, tig = lane & 3;
  stage_q<S::BM, S::DH, S::Q_BOX>(
      Qs, static_cast<const T*>(P.q) + n * P.q_sn + h * P.q_sh, P, row0,
      rows);
  hopper::fence_proxy_async_shared();    // generic stores -> wgmma reads
  hopper::named_bar_sync(1, 256);

  const int wrow = wg * 64 + warp * 16;          // the warp's first row
  const int qpos_a = P.q0 + (row0 + wrow + gid) / P.g;
  const int qpos_b = P.q0 + (row0 + wrow + gid + 8) / P.g;
  const int wq_min = P.q0 + (row0 + wg * 64) / P.g;
  const int wq_max = P.q0 + (row0 + wg * 64 + 63) / P.g;
  const int lo_a = P.window > 0 ? max(0, qpos_a - P.window + 1) : 0;
  const int lo_b = P.window > 0 ? max(0, qpos_b - P.window + 1) : 0;
  const int hi_a = P.causal ? min(P.kv_len, qpos_a + 1) : P.kv_len;
  const int hi_b = P.causal ? min(P.kv_len, qpos_b + 1) : P.kv_len;
  const float sc = P.scale * LOG2E;       // a score's factor to base 2
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, al[2];
  float o[S::DH / 2];
#pragma unroll
  for (int i = 0; i < S::DH / 2; ++i) o[i] = 0.f;
  // the zeros stay here: moved down under a product, their definitions
  // serialize the products (ptxas C7515)
  hopper::fence_operands(o);
  float s[NS];                 // S, then the block's p in its place
  uint32_t pa[NK][4];          // P (bf16) of the block whose O += P V is next
  const uint64_t dq = hopper::desc_sw128(Qs + wg * 64 * 128, 16, 1024);
  hopper::PipeState kst, vst;  // the K and the V stage read next

  // the descriptor of the K (V) block in stage kst (vst), once it has
  // landed, made before the products that read it
  auto k_desc = [&]() {
    hopper::mbar_wait(&full_k[kst.stage], kst.phase);
    return hopper::desc_sw128(Ks + kst.stage * S::KV_BYTES, 16, 1024);
  };
  auto v_desc = [&]() {
    hopper::mbar_wait(&full_v[vst.stage], vst.phase);
    return hopper::desc_sw128(Vs + vst.stage * S::KV_BYTES, S::KV_BOX, 1024);
  };
  // S = Q K^T (both K-major), committed
  auto wgmma_s = [&](uint64_t dk) {
#pragma unroll
    for (int ks = 0; ks < S::DH / 16; ++ks)
      hopper::wgmma_ss_n128_bf16<0>(s, dq + ks * 2, dk + ks * 2, ks > 0);
    hopper::wg_commit();
  };
  // O += P V (V MN-major: transpose-B), P from pa, committed
  auto wgmma_pv = [&](uint64_t dv) {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      hopper::wgmma_rs_n64_bf16<1>(o, pa[kk], dv + kk * (16 * 128 >> 4), 1);
    hopper::wg_commit();
  };
  // block kb's softmax in s (the mask only where the block crosses the
  // causal edge, the window or kv_len for a row of the warpgroup)
  auto softmax = [&](int kb) {
    const int k_first = kb * S::BN, k_last = k_first + S::BN - 1;
    const bool whole = k_last < P.kv_len &&
                       (!P.causal || k_last <= wq_min) &&
                       (P.window <= 0 || k_first > wq_max - P.window);
    const int kbase = k_first + 2 * tig;
    const int la = lo_a - kbase, ha = hi_a - kbase;
    const int lb = lo_b - kbase, hb = hi_b - kbase;
    if (whole)
      block_softmax<false>(s, sc, la, ha, lb, hb, m, l, al);
    else
      block_softmax<true>(s, sc, la, ha, lb, hb, m, l, al);
  };
  // P (bf16) from s: the accumulator's key groups 2kk and 2kk + 1 are the
  // A operand's 16-key step kk
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = hopper::pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  };

  const int nblk = kb_hi - kb_lo;
  // the ping-pong: warpgroup w issues its products after a bar.sync on 2 +
  // w, which the other warpgroup's arrival (after issuing its own) lets
  // through; warpgroup 0 goes first.  Each warpgroup issues nblk times
  // and waits nblk times; warpgroup 1's first arrival is made up front
  // and its arrival after its last issue left out, so the counts match.
  auto my_turn = [&]() { hopper::named_bar_sync(2 + wg, 256); };
  auto your_turn = [&](bool last_issue) {
    if (!(wg == 1 && last_issue)) hopper::named_bar_arrive(3 - wg, 256);
  };
  if (wg == 1 && nblk > 0) hopper::named_bar_arrive(2, 256);
  if (nblk > 0) {
    my_turn();
    const uint64_t dk0 = k_desc();
    hopper::fence_operands(s);
    hopper::wg_fence();
    wgmma_s(dk0);
    your_turn(nblk == 1);
    hopper::wg_wait<0>();
    hopper::fence_operands(s);
    if (lane == 0) hopper::mbar_arrive(&empty_k[kst.stage]);
    kst.advance(S::STAGES);
    softmax(kb_lo);                    // O is 0: no rescale
    pack_p();
    for (int kb = kb_lo + 1; kb < kb_hi; ++kb) {
      my_turn();
      const uint64_t dk = k_desc(), dv = v_desc();
      hopper::fence_operands(s);
      hopper::fence_operands(o);
      fence_u32(pa);
      hopper::wg_fence();
      wgmma_s(dk);                     // S of block kb
      wgmma_pv(dv);                    // O += P V of block kb - 1
      your_turn(kb == kb_hi - 1);
      hopper::wg_wait<1>();            // S is done; the PV product runs on
      hopper::fence_operands(s);
      if (lane == 0) hopper::mbar_arrive(&empty_k[kst.stage]);
      kst.advance(S::STAGES);
      softmax(kb);                     // under the PV product
      hopper::wg_wait<0>();
      hopper::fence_operands(o);
      fence_u32(pa);
      if (lane == 0) hopper::mbar_arrive(&empty_v[vst.stage]);
      vst.advance(S::STAGES);
#pragma unroll
      for (int j = 0; j < S::DH / 8; ++j) {
        o[4 * j] *= al[0];
        o[4 * j + 1] *= al[0];
        o[4 * j + 2] *= al[1];
        o[4 * j + 3] *= al[1];
      }
      pack_p();
    }
    const uint64_t dv = v_desc();      // the last block's O += P V
    hopper::fence_operands(o);
    fence_u32(pa);
    hopper::wg_fence();
    wgmma_pv(dv);
    hopper::wg_wait<0>();
    hopper::fence_operands(o);
    fence_u32(pa);
  }

  const float inv_a = 1.f / fmaxf(quad_sum(l[0]), 1e-30f);
  const float inv_b = 1.f / fmaxf(quad_sum(l[1]), 1e-30f);
  T* ob = static_cast<T*>(P.o) + n * P.o_sn + h * P.o_sh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int R = row0 + wrow + gid + 8 * half;
    if (R >= rows) continue;
    T* orow = ob + (R / P.g) * P.o_ss + (R % P.g) * P.o_sg;
    const float inv = half ? inv_b : inv_a;
#pragma unroll
    for (int j = 0; j < S::DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + tig * 2) =
          __floats2bfloat162_rn(o[4 * j + 2 * half] * inv,
                                o[4 * j + 2 * half + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// bf16 MLA: keys up to 576 wide, values up to 512 wide
// ---------------------------------------------------------------------------

constexpr int MLA_DQ = 576;              // q and k width the kernel takes
constexpr int MLA_DV = 512;              // v and out width
constexpr int MLA_LDS = MLA_DQ + 8;      // smem pitch of Q, K and V rows
constexpr int MLA_THREADS = 256;         // 8 warps
constexpr int MLA_COLS = MLA_DV / 8;     // output columns of a warp: 64
constexpr int MLA_MAX_SPLITS = 8;        // decode: CTAs per (n, KV head)

// RG row groups of 16 folded rows, blocks of BN keys.  S = Q K^T: warp w
// takes row group w % RG and the w / RG-th slice of KW keys of the block;
// O += P V: warp w takes output columns [64 w, 64 w + 64) of every row.
template <int RG, int BN>
struct MlaShape {
  static constexpr int BM = 16 * RG;             // folded rows of a CTA
  static constexpr int KEYS = BN;                // keys of a block
  static constexpr int NKS = 8 / RG;             // key slices of a block
  static constexpr int KW = BN / NKS;            // keys of a slice
  static constexpr int NT = KW / 8;              // its 8-key mma tiles
  static constexpr int LDP = BN + 8;             // P's smem pitch
  static constexpr int Q_ELEMS = BM * MLA_LDS;
  static constexpr int KV_ELEMS = 2 * BN * MLA_LDS;  // 2 K stages, or K, V
  static constexpr int SMEM =
      (Q_ELEMS + KV_ELEMS + BM * LDP) * 2 + (NKS + 1) * BM * 4;
  static constexpr int PART = BM * (MLA_DV + 2);  // a split's m, l and o
  static_assert(NT >= 1 && KW % 8 == 0 && BN % 16 == 0, "MLA block shape");
  static_assert(NKS * BM >= BM * MLA_MAX_SPLITS || RG > 1,
                "the decode merge's weights fit in red");
};

// Prefill: 64 folded rows, 32-key blocks (155 KB of shared memory).
// Decode (at most 16 folded rows): 16 rows, 64-key blocks (171 KB), the
// blocks split across CTAs like fa_ring_kernel's.
using MlaPrefill = MlaShape<4, 32>;
using MlaDecode = MlaShape<1, 64>;

// A CTA: BM folded rows of one (n, KV head) against blocks [lo + split *
// cps, ...) of its visible blocks.  Q stays in shared memory; K blocks are
// double-buffered by cp.async when v is a view of k (V is then read from
// the K stage: v_in_k), else one K and one V stage.  Per block: S on
// mma.sync by slices, the row maxima of the slices met in shared memory,
// P (bf16) and each row's alpha through shared memory to the PV warps,
// whose 16 x 64 accumulators per row group (128 registers at RG = 4) hold
// the output.  The partial (m, l, o) of a split goes to scratch and the
// last CTA of (n, h) merges them; with one split the CTA writes out.
template <int RG, int BN>
__global__ void __launch_bounds__(MLA_THREADS, 1)
    fa_mla_kernel(Params P, float* part, int* tickets, int splits, int cps) {
  using T = __nv_bfloat16;
  using S = MlaShape<RG, BN>;
  constexpr int BM = S::BM, LDS = MLA_LDS, LDP = S::LDP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* KVs = Qs + S::Q_ELEMS;
  T* Ps = KVs + S::KV_ELEMS;
  float* red = reinterpret_cast<float*>(Ps + BM * LDP);   // [NKS][BM]
  float* row_s = red + S::NKS * BM;                      // alpha, then m
  __shared__ int last;

  const int split = blockIdx.x % splits, h = blockIdx.y, n = blockIdx.z;
  const int rows = P.sq * P.g;
  const int tiles = (rows + BM - 1) / BM;
  const int row0 = (tiles - 1 - static_cast<int>(blockIdx.x) / splits) * BM;
  const int row_end = min(row0 + BM, rows);
  const int q_min = P.q0 + row0 / P.g, q_max = P.q0 + (row_end - 1) / P.g;
  int kb_lo, kb_hi;
  block_range(P, BN, q_min, q_max, &kb_lo, &kb_hi);
  const int b_lo = kb_lo + split * cps;
  const int b_hi = min(kb_hi, b_lo + cps);

  const T* qb = static_cast<const T*>(P.q) + n * P.q_sn + h * P.q_sh;
  const T* kb0 = static_cast<const T*>(P.k) + n * P.k_sn + h * P.k_sh;
  const T* vb0 = static_cast<const T*>(P.v) + n * P.v_sn + h * P.v_sh;
  const T* any = static_cast<const T*>(P.q);
  const bool v_in_k = P.v_in_k != 0;
  const int nbuf = v_in_k ? 2 : 1;
  auto k_stage = [&](int buf) { return KVs + buf * BN * LDS; };
  auto v_stage = [&](int buf) {
    return v_in_k ? k_stage(buf) : KVs + BN * LDS;
  };

  stage_rows<MLA_DQ, LDS, BM, MLA_THREADS>(
      Qs,
      [&](int r) -> const T* {
        const int R = row0 + r;
        if (R >= rows) return nullptr;
        return qb + (R / P.g) * P.q_ss + (R % P.g) * P.q_sg;
      },
      any, P.dh, P.vec_ok);
  auto stage = [&](int buf, int kb) {
    stage_rows<MLA_DQ, LDS, BN, MLA_THREADS>(
        k_stage(buf),
        [&](int r) -> const T* {
          const int j = kb * BN + r;
          return j < P.kv_len ? kb0 + j * P.k_ss : nullptr;
        },
        any, P.dh, P.vec_ok);
    if (!v_in_k)
      stage_rows<MLA_DV, LDS, BN, MLA_THREADS>(
          v_stage(buf),
          [&](int r) -> const T* {
            const int j = kb * BN + r;
            return j < P.kv_len ? vb0 + j * P.v_ss : nullptr;
          },
          any, P.dv, P.vec_ok);
  };
  if (b_lo < b_hi) stage(0, b_lo);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp % RG, ks = warp / RG;
  const int ra = rg * 16 + gid, rb = ra + 8;       // this thread's S rows
  const int qpos_a = P.q0 + (row0 + ra) / P.g;
  const int qpos_b = P.q0 + (row0 + rb) / P.g;
  const int c0 = warp * MLA_COLS;                  // its output columns
  const bool pv_live = c0 < P.dv;
  const int nk32 = (P.dh + 31) / 32;               // 32-wide steps of dh
  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;
  float o[RG][MLA_COLS / 8][4];
#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int t = 0; t < MLA_COLS / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[r][t][e] = 0.f;

  for (int kb = b_lo, it = 0; kb < b_hi; ++kb, ++it) {
    const int buf = nbuf == 2 ? (it & 1) : 0;
    if (nbuf == 2 && kb + 1 < b_hi) stage(buf ^ 1, kb + 1);
    cp_async_commit();
    if (nbuf == 2)
      cp_async_wait<1>();        // block kb (and Q) have landed
    else
      cp_async_wait<0>();
    __syncthreads();

    // S = Q K^T: rows ra, rb against the slice's keys, 32 dims a step (one
    // ldmatrix.x4 of K gives a key tile's B operands of both 16-dim steps)
    float s[S::NT][4];
#pragma unroll
    for (int t = 0; t < S::NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
    const T* Qw = Qs + rg * 16 * LDS + (lane & 15) * LDS + (lane >> 4) * 8;
    const T* Kw = k_stage(buf) + (ks * S::KW + (lane & 7)) * LDS +
                  (lane >> 3) * 8;
#pragma unroll 2
    for (int k32 = 0; k32 < nk32; ++k32) {
      uint32_t a0[4], a1[4];
      ldsm_x4(a0, Qw + k32 * 32);
      ldsm_x4(a1, Qw + k32 * 32 + 16);
#pragma unroll
      for (int t = 0; t < S::NT; ++t) {
        uint32_t kr[4];
        ldsm_x4(kr, Kw + t * 8 * LDS + k32 * 32);
        const uint32_t b0[2] = {kr[0], kr[1]}, b1[2] = {kr[2], kr[3]};
        mma_bf16(s[t], a0, b0);
        mma_bf16(s[t], a1, b1);
      }
    }
    logits<S::NT * 4>(P, &s[0][0]);
    const int k_first = kb * BN, k_last = k_first + BN - 1;
    const bool whole = k_last < P.kv_len && (!P.causal || k_last <= q_min) &&
                       (P.window <= 0 || k_first > q_max - P.window);
    if (!whole) {
#pragma unroll
      for (int t = 0; t < S::NT; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k_first + ks * S::KW + t * 8 + tig * 2 + e;
          s[t][e] = visible(P, col, qpos_a) ? s[t][e] : NEG;
          s[t][2 + e] = visible(P, col, qpos_b) ? s[t][2 + e] : NEG;
        }
    }
    // the block's row maxima: the slices meet in shared memory
    float mx_a = NEG, mx_b = NEG;
#pragma unroll
    for (int t = 0; t < S::NT; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx_a = fmaxf(mx_a, s[t][e]);
        mx_b = fmaxf(mx_b, s[t][2 + e]);
      }
    mx_a = quad_max(mx_a);
    mx_b = quad_max(mx_b);
    if (tig == 0) {
      red[ks * BM + ra] = mx_a;
      red[ks * BM + rb] = mx_b;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < S::NKS; ++j) {
      mx_a = fmaxf(mx_a, red[j * BM + ra]);
      mx_b = fmaxf(mx_b, red[j * BM + rb]);
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
    T* Pw = Ps + ks * S::KW + tig * 2;
#pragma unroll
    for (int t = 0; t < S::NT; ++t) {
      const float p0 = exp2f(s[t][0] - mn_a), p1 = exp2f(s[t][1] - mn_a);
      const float p2 = exp2f(s[t][2] - mn_b), p3 = exp2f(s[t][3] - mn_b);
      sum_a += p0 + p1;
      sum_b += p2 + p3;
      *reinterpret_cast<__nv_bfloat162*>(Pw + ra * LDP + t * 8) =
          __floats2bfloat162_rn(p0, p1);
      *reinterpret_cast<__nv_bfloat162*>(Pw + rb * LDP + t * 8) =
          __floats2bfloat162_rn(p2, p3);
    }
    // l: a partial per slice (every slice scales by the same alpha), the
    // slices summed at the end
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
    if (ks == 0 && tig == 0) {
      row_s[ra] = al_a;
      row_s[rb] = al_b;
    }
    __syncthreads();

    // O += P V for the warp's 64 columns of every row group
    if (pv_live) {
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        const float a_lo = row_s[r * 16 + gid], a_hi = row_s[r * 16 + gid + 8];
#pragma unroll
        for (int t = 0; t < MLA_COLS / 8; ++t) {
          o[r][t][0] *= a_lo;
          o[r][t][1] *= a_lo;
          o[r][t][2] *= a_hi;
          o[r][t][3] *= a_hi;
        }
      }
      const T* Vw = v_stage(buf) +
                    ((lane & 7) + ((lane >> 3) & 1) * 8) * LDS + c0 +
                    (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t a[RG][4];
#pragma unroll
        for (int r = 0; r < RG; ++r)
          ldsm_x4(a[r], Ps + (r * 16 + (lane & 15)) * LDP + kk * 16 +
                            (lane >> 4) * 8);
#pragma unroll
        for (int t = 0; t < MLA_COLS / 8; t += 2) {
          uint32_t vr[4];
          ldsm_x4_t(vr, Vw + kk * 16 * LDS + t * 8);
          const uint32_t b0[2] = {vr[0], vr[1]}, b1[2] = {vr[2], vr[3]};
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            mma_bf16(o[r][t], a[r], b0);
            mma_bf16(o[r][t + 1], a[r], b1);
          }
        }
      }
    }
    __syncthreads();             // the stage, P and alpha are free
    if (nbuf == 1 && kb + 1 < b_hi) stage(0, kb + 1);
  }
  cp_async_wait<0>();

  // each row's l summed over the slices, and its m (the slices agree)
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  if (tig == 0) {
    red[ks * BM + ra] = l_a;
    red[ks * BM + rb] = l_b;
    if (ks == 0) {
      row_s[ra] = m_a;
      row_s[rb] = m_b;
    }
  }
  __syncthreads();
  auto row_l = [&](int row) {
    float L = 0.f;
#pragma unroll
    for (int j = 0; j < S::NKS; ++j) L += red[j * BM + row];
    return L;
  };
  const long long group = (long long)n * P.hk + h;
  T* ob = static_cast<T*>(P.o) + n * P.o_sn + h * P.o_sh;
  if (splits == 1) {
    if (!pv_live) return;
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r * 16 + gid + 8 * half, R = row0 + row;
        if (R >= rows) continue;
        const float inv = 1.f / fmaxf(row_l(row), 1e-30f);
        T* orow = ob + (R / P.g) * P.o_ss + (R % P.g) * P.o_sg;
#pragma unroll
        for (int t = 0; t < MLA_COLS / 8; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int d = c0 + t * 8 + tig * 2 + e;
            if (d < P.dv)
              orow[d] = __float2bfloat16(o[r][t][2 * half + e] * inv);
          }
      }
    return;
  }

  // a split's partial: m, l, then o unnormalized, [BM][MLA_DV]
  float* pg = part + group * splits * S::PART;
  float* ps = pg + (long long)split * S::PART;
  if (threadIdx.x < BM) {
    ps[threadIdx.x] = row_s[threadIdx.x];
    ps[BM + threadIdx.x] = row_l(threadIdx.x);
  }
  if (pv_live) {
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int t = 0; t < MLA_COLS / 8; ++t) {
        const int d = c0 + t * 8 + tig * 2;
        float* po = ps + 2 * BM + (r * 16 + gid) * MLA_DV + d;
        *reinterpret_cast<float2*>(po) = make_float2(o[r][t][0], o[r][t][1]);
        *reinterpret_cast<float2*>(po + 8 * MLA_DV) =
            make_float2(o[r][t][2], o[r][t][3]);
      }
  }
  __threadfence();               // the partial is visible before the ticket
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + group, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last CTA of (n, h): each row's weight of every split, exp2(m -
  // M) / L, into shared memory (red is free), then the output four
  // columns a thread, the splits' partials read as float4 (a thread per
  // element, taking the row's maximum again for each, spent the launch
  // on chains of dependent L2 reads)
  float* wts = red;                       // [BM][MLA_MAX_SPLITS]
  if (static_cast<int>(threadIdx.x) < rows) {
    const int r = threadIdx.x;
    float M = NEG;
    for (int sp = 0; sp < splits; ++sp)
      M = fmaxf(M, __ldcg(pg + (long long)sp * S::PART + r));
    float L = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const float* q = pg + (long long)sp * S::PART;
      const float f = exp2f(__ldcg(q + r) - M);
      wts[r * MLA_MAX_SPLITS + sp] = f;
      L += __ldcg(q + BM + r) * f;
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    for (int sp = 0; sp < splits; ++sp) wts[r * MLA_MAX_SPLITS + sp] *= inv;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * (MLA_DV / 4); i += MLA_THREADS) {
    const int r = i / (MLA_DV / 4), d = (i % (MLA_DV / 4)) * 4;
    if (d >= P.dv) continue;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int sp = 0; sp < splits; ++sp) {
      const float w = wts[r * MLA_MAX_SPLITS + sp];
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          pg + (long long)sp * S::PART + 2 * BM + r * MLA_DV + d));
      acc[0] += w * v.x;
      acc[1] += w * v.y;
      acc[2] += w * v.z;
      acc[3] += w * v.w;
    }
    T* orow = ob + (r / P.g) * P.o_ss + (r % P.g) * P.o_sg;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d + e < P.dv) orow[d + e] = __float2bfloat16(acc[e]);
  }
  if (threadIdx.x == 0) tickets[group] = 0;
}

// ---------------------------------------------------------------------------
// bf16 MLA prefill: wgmma and TMA (q/k 576 wide, v k's first 512 columns)
// ---------------------------------------------------------------------------

// 64 folded rows a CTA (4 query positions at G = 16), 64-key blocks of
// 576 columns.  Shared memory, in bytes: Q 64 x 576 x 2 = 73 728 (9
// boxes of 64 dims), two K stages of 73 728, P 64 x 64 x 2 = 8 192 (one
// box), the two halves' row statistics 2 x 64 x 4 = 512, four mbarriers
// 32, and up to 1 023 to align Q to 1 024: 230 943 of the 232 448 a
// block may have.
struct MlaWgShape {
  static constexpr int BM = 64;                  // folded rows of a CTA
  static constexpr int BN = 64;                  // keys of a K block
  static constexpr int HALF = BN / 2;            // keys of a warpgroup's S
  static constexpr int BOX = 64 * 128;           // 64 rows of 64 dims
  static constexpr int BOXES = MLA_DQ / 64;      // 9
  static constexpr int Q_BYTES = BM * MLA_DQ * 2;
  static constexpr int K_BYTES = BN * MLA_DQ * 2;
  static constexpr int P_BYTES = BM * BN * 2;
  static constexpr int STAGES = 2;
  static constexpr int THREADS = 256;   // no producer warps (WgShape<256>)
  static constexpr int SMEM = Q_BYTES + STAGES * K_BYTES + P_BYTES +
                              2 * BM * 4 + 2 * STAGES * 8 + 1023;
  static_assert(SMEM <= 232448, "MLA wgmma tile exceeds shared memory");
};

// A CTA: 64 folded query rows of one (n, KV head), the heaviest row tiles
// first; 256 threads, the two consumer warpgroups (registers: see
// WgShape<256>; O alone is 128).  Thread 0 loads 64-key K blocks (all
// 576 columns) by TMA into two stages between its products; v is k's
// first 512 columns, read from the same stage.  Per
// block, warpgroup w (of 0 and 1):
//   S_w = Q K[32 w : 32 w + 32]^T on m64n32k16 (A = Q, B = K, both
//     K-major in shared memory) over the 36 k16 steps of 576;
//   the row maxima of the two halves meet in shared memory (a named
//     barrier of the 256 consumers), so both warpgroups scale by the same
//     alpha and take p against the same maximum;
//   P_w (bf16) into its 32 columns of the 64 x 64 P tile in shared
//     memory, in the 128-byte swizzle wgmma reads (A, K-major); a second
//     barrier, and each warpgroup reads all of P;
//   O_w += P V[:, 256 w : 256 w + 256] on m64n256k16 (A = P, B = V
//     MN-major: the stage's boxes 4 w .. 4 w + 3, the transpose-B bit):
//     the warpgroup holds the 64 x 256 float32 accumulator of its half of
//     the output's columns (128 registers a thread).
// Each half's l is summed per thread; the two meet at the end.
__global__ void __launch_bounds__(MlaWgShape::THREADS, 1)
    fa_mla_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k, Params P,
                        KvOrder ok) {
  using T = __nv_bfloat16;
  using S = MlaWgShape;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = hopper::smem_u32(smem_raw);
  unsigned char* Qs = smem_raw + (((base + 1023u) & ~1023u) - base);
  unsigned char* Ks = Qs + S::Q_BYTES;
  unsigned char* Ps = Ks + S::STAGES * S::K_BYTES;
  float* red = reinterpret_cast<float*>(Ps + S::P_BYTES);   // [2][BM]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * S::BM);
  uint64_t* empty = full + S::STAGES;       // K (and V) read by both halves

  const int rows = P.sq * P.g;
  const int tiles = (rows + S::BM - 1) / S::BM;
  const int groups = P.n * P.hk;
  const int nh = blockIdx.x % groups;
  const int n = nh / P.hk, h = nh % P.hk;
  const int row0 = (tiles - 1 - blockIdx.x / groups) * S::BM;
  const int row_end = min(row0 + S::BM, rows);
  const int q_min = P.q0 + row0 / P.g, q_max = P.q0 + (row_end - 1) / P.g;
  int kb_lo, kb_hi;
  block_range(P, S::BN, q_min, q_max, &kb_lo, &kb_hi);
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::STAGES; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 8);      // the consumer warps
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // thread 0 produces: block kb's 576 columns by TMA into the stage `ps`
  // names, once both warpgroups have freed it; it fills the ring first
  auto produce = [&](hopper::PipeState& ps, int kb) {
    hopper::mbar_wait(&empty[ps.stage], ps.phase ^ 1u);
    hopper::mbar_expect_tx(&full[ps.stage], S::K_BYTES);
    const int j = kb * S::BN;
    for (int b = 0; b < S::BOXES; ++b)
      hopper::tma_load_4d(Ks + ps.stage * S::K_BYTES + b * S::BOX, &tm_k,
                          &full[ps.stage], b * 64, kv_coord(ok, 0, j, h, n),
                          kv_coord(ok, 1, j, h, n), kv_coord(ok, 2, j, h, n));
    ps.advance(S::STAGES);
  };
  hopper::PipeState ps;
  if (threadIdx.x == 0)
    for (int kb = kb_lo; kb < min(kb_hi, kb_lo + S::STAGES); ++kb)
      produce(ps, kb);

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, gid = lane >> 2, tig = lane & 3;
  stage_q<S::BM, MLA_DQ, S::BOX>(
      Qs, static_cast<const T*>(P.q) + n * P.q_sn + h * P.q_sh, P, row0,
      rows);
  hopper::fence_proxy_async_shared();    // generic stores -> wgmma reads
  hopper::named_bar_sync(1, 256);

  // this thread's rows of the tile (both warpgroups hold all 64 rows)
  const int ra = warp * 16 + gid, rb = ra + 8;
  const int qpos_a = P.q0 + (row0 + ra) / P.g;
  const int qpos_b = P.q0 + (row0 + rb) / P.g;
  const int lo_a = P.window > 0 ? max(0, qpos_a - P.window + 1) : 0;
  const int lo_b = P.window > 0 ? max(0, qpos_b - P.window + 1) : 0;
  const int hi_a = P.causal ? min(P.kv_len, qpos_a + 1) : P.kv_len;
  const int hi_b = P.causal ? min(P.kv_len, qpos_b + 1) : P.kv_len;
  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;
  float o[MLA_DV / 4];                   // 64 rows x 256 columns
#pragma unroll
  for (int i = 0; i < MLA_DV / 4; ++i) o[i] = 0.f;
  const uint64_t dq = hopper::desc_sw128(Qs, 16, 1024);
  const uint64_t dp = hopper::desc_sw128(Ps, 16, 1024);

  hopper::PipeState st;
  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    unsigned char* Kst = Ks + st.stage * S::K_BYTES;
    float s[S::HALF / 2];
    hopper::mbar_wait(&full[st.stage], st.phase);
    const uint64_t dk = hopper::desc_sw128(Kst + wg * S::HALF * 128, 16,
                                           1024);
    hopper::fence_operands(s);
    hopper::wg_fence();
#pragma unroll
    for (int ks = 0; ks < MLA_DQ / 16; ++ks) {
      const uint64_t off = (ks / 4) * (S::BOX >> 4) + (ks % 4) * 2;
      hopper::wgmma_ss_n32_bf16<0>(s, dq + off, dk + off, ks > 0);
    }
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::fence_operands(s);

    // the block's mask only where it crosses an edge for some row of the
    // tile; score (j, e) of this half is key k0 + 2 tig + 8 j + e
    const int b_first = kb * S::BN, b_last = b_first + S::BN - 1;
    const bool whole = b_last < P.kv_len &&
                       (!P.causal || b_last <= q_min) &&
                       (P.window <= 0 || b_first > q_max - P.window);
    logits<S::HALF / 2>(P, s);
    if (!whole) {
      const int k0 = b_first + wg * S::HALF + 2 * tig;
      const int la = lo_a - k0, ha = hi_a - k0;
      const int lb = lo_b - k0, hb = hi_b - k0;
#pragma unroll
      for (int j = 0; j < S::HALF / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + e;
          s[4 * j + e] = (c >= la) & (c < ha) ? s[4 * j + e] : NEG;
          s[4 * j + 2 + e] = (c >= lb) & (c < hb) ? s[4 * j + 2 + e] : NEG;
        }
      }
    }
    // the two halves' row maxima meet in shared memory
    float mx_a = NEG, mx_b = NEG;
#pragma unroll
    for (int j = 0; j < S::HALF / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx_a = fmaxf(mx_a, s[4 * j + e]);
        mx_b = fmaxf(mx_b, s[4 * j + 2 + e]);
      }
    }
    mx_a = quad_max(mx_a);
    mx_b = quad_max(mx_b);
    if (tig == 0) {
      red[wg * S::BM + ra] = mx_a;
      red[wg * S::BM + rb] = mx_b;
    }
    hopper::named_bar_sync(1, 256);
    const float mn_a = fmaxf(m_a, fmaxf(red[ra], red[S::BM + ra]));
    const float mn_b = fmaxf(m_b, fmaxf(red[rb], red[S::BM + rb]));
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    // p, this half's row sums, and P (bf16) into the swizzled tile: keys
    // 32 w + 8 j + 2 tig are 16-byte chunk 4 w + j of the row
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < S::HALF / 8; ++j) {
      const float p0 = exp2f(s[4 * j] - mn_a), p1 = exp2f(s[4 * j + 1] - mn_a);
      const float p2 = exp2f(s[4 * j + 2] - mn_b);
      const float p3 = exp2f(s[4 * j + 3] - mn_b);
      sum_a += p0 + p1;
      sum_b += p2 + p3;
      const int chunk = wg * (S::HALF / 8) + j;
      *reinterpret_cast<uint32_t*>(Ps + ra * 128 + ((chunk ^ gid) * 16) +
                                   tig * 4) = hopper::pack_bf16(p0, p1);
      *reinterpret_cast<uint32_t*>(Ps + rb * 128 + ((chunk ^ gid) * 16) +
                                   tig * 4) = hopper::pack_bf16(p2, p3);
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int j = 0; j < MLA_DV / 16; ++j) {
      o[4 * j] *= al_a;
      o[4 * j + 1] *= al_a;
      o[4 * j + 2] *= al_b;
      o[4 * j + 3] *= al_b;
    }
    hopper::fence_proxy_async_shared();  // P's stores -> wgmma reads
    hopper::named_bar_sync(1, 256);      // both halves of P are written

    // O_w += P V[:, 256 w : 256 w + 256]: V is the stage's first 512
    // columns, MN-major (boxes of 64 columns, LBO a box apart)
    const uint64_t dv = hopper::desc_sw128(Kst + wg * 4 * S::BOX, S::BOX,
                                           1024);
    hopper::fence_operands(o);
    hopper::wg_fence();
#pragma unroll
    for (int kk = 0; kk < S::BN / 16; ++kk)
      hopper::wgmma_ss_n256_bf16<1>(o, dp + kk * 2,
                                    dv + kk * (16 * 128 >> 4), 1);
    hopper::wg_commit();
    hopper::wg_wait<0>();
    hopper::fence_operands(o);
    if (lane == 0) hopper::mbar_arrive(&empty[st.stage]);
    st.advance(S::STAGES);
    if (threadIdx.x == 0 && kb + S::STAGES < kb_hi)
      produce(ps, kb + S::STAGES);
  }

  // each row's l: the quad's partials, then the two halves' (red is free:
  // both halves passed the last block's second barrier)
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  if (tig == 0) {
    red[wg * S::BM + ra] = l_a;
    red[wg * S::BM + rb] = l_b;
  }
  hopper::named_bar_sync(1, 256);
  const float inv_a = 1.f / fmaxf(red[ra] + red[S::BM + ra], 1e-30f);
  const float inv_b = 1.f / fmaxf(red[rb] + red[S::BM + rb], 1e-30f);
  T* ob = static_cast<T*>(P.o) + n * P.o_sn + h * P.o_sh + wg * (MLA_DV / 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int R = row0 + (half ? rb : ra);
    if (R >= rows) continue;
    T* orow = ob + (R / P.g) * P.o_ss + (R % P.g) * P.o_sg;
    const float inv = half ? inv_b : inv_a;
#pragma unroll
    for (int j = 0; j < MLA_DV / 16; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + tig * 2) =
          __floats2bfloat162_rn(o[4 * j + 2 * half] * inv,
                                o[4 * j + 2 * half + 1] * inv);
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
      const bool in = j < P.kv_len;
      Ks[r * LDK + d] = in && d < P.dh ? kb0[j * P.k_ss + d] : 0.f;
      Vs[c] = in && d < P.dv ? vb0[j * P.v_ss + d] : 0.f;
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
      if (d < P.dv) orow[d] = o[rr][c] * inv;
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


// How a call runs: the kernel, and for a split decode its splits.
enum Path {
  PATH_F32 = 0,
  PATH_MMA_SYNC = 1,
  PATH_WGMMA = 2,
  PATH_SPLIT = 3,
  PATH_MLA = 4,
  PATH_MLA_WGMMA = 5
};

struct Plan {
  int path = PATH_MMA_SYNC;
  int dhp = 0;                 // the head dim the kernel is built for
  int splits = 0;              // split decodes: CTAs per (n, h)
  int cps = 0;                 // MLA: blocks a CTA
  int key_lo = 0, key_hi = 0;  // split decode: the keys some query sees
  long long scratch = 0;       // split decode: floats of partials
  bool mla_decode = false;     // MLA: MlaDecode (split), else MlaPrefill
};

inline int padded_dh(int dh) {
  return dh <= 16    ? 16
         : dh <= 32  ? 32
         : dh <= 64  ? 64
         : dh <= 128 ? 128
         : dh <= 256 ? 256
                     : MLA_DQ;
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

// The CTAs of fa_ring_kernel<DHP> an SM holds at once, from the occupancy
// API (its shared memory and registers), read once.
template <int DHP>
int ring_residency() {
  static int per_sm = 0;
  if (per_sm == 0) {
    constexpr int bytes = RingShape<DHP>::SMEM;
    set_smem(fa_ring_kernel<DHP>, bytes);
    int b = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &b, fa_ring_kernel<DHP>, RING_THREADS, bytes) != cudaSuccess ||
        b < 1)
      b = 1;
    per_sm = b;
  }
  return per_sm;
}

inline int ring_residency(int dhp) {
  return dhp == 32    ? ring_residency<32>()
         : dhp == 64  ? ring_residency<64>()
         : dhp == 128 ? ring_residency<128>()
                      : ring_residency<256>();
}

// float32 -> fa_f32_kernel; bf16 with v narrower than k or dh above 256
// (MLA): the prefill at dh 576 and dv 512 with v a view of k (v_in_k),
// at least 64 folded rows, strides TMA can use (vec_ok) and kv_len > 0 ->
// fa_mla_wgmma_kernel, other MLA calls -> fa_mla_kernel, its decode
// shape (at most 16 folded rows) with the visible blocks split across
// CTAs for one CTA per SM; other bf16 with at most 16 folded rows
// (decode) -> fa_ring_kernel, its 32-key blocks shared out over as many
// splits as fill the card's resident CTAs once; bf16 prefill at dh 64,
// 128 or 256 whose strides TMA can use (vec_ok), with at least 64 folded
// rows and kv_len > 0 -> at dh 64 fa_wgmma64_kernel (with a softcap
// fa_wgmma_kernel<64>), else fa_wgmma_kernel; other bf16 ->
// fa_bf16_kernel (mma.sync).
inline Plan plan(int dtype, int n, int sq, int hk, int g, int dh, int dv,
                 int q0, int kv_len, int causal, int window, int vec_ok,
                 int v_in_k) {
  Plan pl;
  pl.dhp = padded_dh(dh);
  const int rows = sq * g;
  if (dtype == 0) {
    pl.path = PATH_F32;
  } else if (dh == MLA_DQ && dv == MLA_DV && v_in_k && vec_ok &&
             rows >= MlaWgShape::BM && kv_len > 0) {
    pl.path = PATH_MLA_WGMMA;
  } else if (dv != dh || dh > 256) {
    pl.path = PATH_MLA;
    pl.splits = 1;
    pl.cps = 1 << 30;
    if (rows <= MlaDecode::BM) {
      pl.mla_decode = true;
      int lo, hi;
      blocks_seen(kv_len, causal, window, MlaDecode::KEYS, q0, q0 + sq - 1,
                  &lo, &hi);
      const int blocks = hi > lo ? hi - lo : 0;
      const int groups = n * hk;
      int splits = min(sm_count() / groups, MLA_MAX_SPLITS);
      splits = max(1, min(splits, blocks));
      pl.cps = max(1, (blocks + splits - 1) / splits);
      pl.splits = max(1, (blocks + pl.cps - 1) / pl.cps);
      if (pl.splits > 1)
        pl.scratch = (long long)groups * pl.splits * MlaDecode::PART;
      else
        pl.cps = 1 << 30;
    }
  } else if (rows <= SPLIT_ROWS) {
    pl.path = PATH_SPLIT;
    const int qmax = q0 + sq - 1;
    int hi = kv_len;
    if (causal) hi = qmax < 0 ? 0 : min(hi, qmax + 1);
    int lo = window > 0 ? max(0, q0 - window + 1) : 0;
    lo = min(lo, hi);
    const int groups = n * hk;
    pl.dhp = max(pl.dhp, RING_MIN_DHP);
    const int blocks = (hi - lo + RING_KEYS - 1) / RING_KEYS;
    const int slots = ring_residency(pl.dhp) * sm_count();
    pl.splits = max(1, min(min(slots / groups, blocks), RING_MAX_SPLITS));
    pl.key_lo = lo;
    pl.key_hi = hi;
    pl.scratch = (long long)groups * pl.splits * SPLIT_ROWS * (pl.dhp + 2);
  } else if (vec_ok && (dh == 64 || dh == 128 || dh == 256) && rows >= 64 &&
             kv_len > 0) {
    pl.path = PATH_WGMMA;
  }
  return pl;
}

template <class Shape, int RG, int BN>
int launch_mla(const Params& P, const Plan& pl, float* part, int* tickets,
               cudaStream_t s) {
  constexpr int bytes = Shape::SMEM;
  static bool configured = false;
  if (!configured) {
    set_smem(fa_mla_kernel<RG, BN>, bytes);
    configured = true;
  }
  const long long x = (long long)((P.sq * P.g + Shape::BM - 1) / Shape::BM) *
                      pl.splits;
  if (x > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(x), P.hk, P.n);
  fa_mla_kernel<RG, BN><<<grid, MLA_THREADS, bytes, s>>>(P, part, tickets,
                                                         pl.splits, pl.cps);
  return 0;
}

template <int DHP>
int launch_ring(const Params& P, const Plan& pl, float* part, int* tickets,
                cudaStream_t s) {
  ring_residency<DHP>();         // sets the shared-memory opt-in once
  const dim3 grid(pl.splits, P.hk, P.n);
  fa_ring_kernel<DHP><<<grid, RING_THREADS, RingShape<DHP>::SMEM, s>>>(
      P, part, tickets, pl.splits, pl.key_lo, pl.key_hi);
  return 0;
}

// The tensor map of k or v [N, kv_len, HK, dh] (strides in elements) in
// boxes of `keys` keys and 64 dims, its outer dims ordered by stride;
// `ord` says where each coordinate goes.
inline int kv_map(CUtensorMap* map, const void* base, const Params& P,
                  long long sn, long long ss, long long sh, int keys,
                  KvOrder* ord) {
  struct Dim {
    long long stride;
    uint64_t extent;
    uint32_t box;
    int which;   // 0 key, 1 head, 2 batch
  } d[3] = {{ss, (uint64_t)P.kv_len, (uint32_t)keys, 0},
            {sh, (uint64_t)P.hk, 1, 1},
            {sn, (uint64_t)P.n, 1, 2}};
  for (int i = 0; i < 3; ++i)          // by stride (insertion sort)
    for (int j = i; j > 0 && d[j].stride < d[j - 1].stride; --j) {
      const Dim t = d[j];
      d[j] = d[j - 1];
      d[j - 1] = t;
    }
  uint64_t dims[4] = {(uint64_t)P.dh, 0, 0, 0}, strides[3];
  uint32_t box[4] = {64, 0, 0, 0};
  for (int i = 0; i < 3; ++i) {
    dims[1 + i] = d[i].extent;
    strides[i] = (uint64_t)d[i].stride * 2;
    box[1 + i] = d[i].box;
    (d[i].which == 0 ? ord->key : d[i].which == 1 ? ord->head : ord->batch) =
        i;
  }
  return hopper_host::encode_16bit(map, base, 4, dims, strides, box, true);
}

template <int DH>
int launch_wgmma(const Params& P, cudaStream_t s) {
  constexpr int bytes = WgShape<DH>::SMEM;
  static bool configured = false;
  if (!configured) {
    set_smem(fa_wgmma_kernel<DH>, bytes);
    configured = true;
  }
  CUtensorMap tk, tv;
  KvOrder ok, ov;
  int rc;
  constexpr int BN = WgShape<DH>::BN;
  if ((rc = kv_map(&tk, P.k, P, P.k_sn, P.k_ss, P.k_sh, BN, &ok)) ||
      (rc = kv_map(&tv, P.v, P, P.v_sn, P.v_ss, P.v_sh, BN, &ov)))
    return rc;
  const long long ctas = (long long)((P.sq * P.g + WgShape<DH>::BM - 1) /
                                     WgShape<DH>::BM) * P.n * P.hk;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fa_wgmma_kernel<DH><<<static_cast<unsigned>(ctas), WgShape<DH>::THREADS,
                        bytes, s>>>(tk, tv, P, ok, ov);
  return 0;
}

int launch_wgmma64(const Params& P, cudaStream_t s) {
  using S = Wg64Shape;
  static bool configured = false;
  if (!configured) {
    set_smem(fa_wgmma64_kernel, S::SMEM);
    configured = true;
  }
  CUtensorMap tk, tv;
  KvOrder ok, ov;
  int rc;
  if ((rc = kv_map(&tk, P.k, P, P.k_sn, P.k_ss, P.k_sh, S::BN, &ok)) ||
      (rc = kv_map(&tv, P.v, P, P.v_sn, P.v_ss, P.v_sh, S::BN, &ov)))
    return rc;
  const long long ctas =
      (long long)((P.sq * P.g + S::BM - 1) / S::BM) * P.n * P.hk;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fa_wgmma64_kernel<<<static_cast<unsigned>(ctas), S::THREADS, S::SMEM, s>>>(
      tk, tv, P, ok, ov);
  return 0;
}

int launch_mla_wgmma(const Params& P, cudaStream_t s) {
  using S = MlaWgShape;
  static bool configured = false;
  if (!configured) {
    set_smem(fa_mla_wgmma_kernel, S::SMEM);
    configured = true;
  }
  CUtensorMap tk;
  KvOrder ok;
  if (const int rc = kv_map(&tk, P.k, P, P.k_sn, P.k_ss, P.k_sh, S::BN, &ok))
    return rc;
  const long long ctas =
      (long long)((P.sq * P.g + S::BM - 1) / S::BM) * P.n * P.hk;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fa_mla_wgmma_kernel<<<static_cast<unsigned>(ctas), S::THREADS, S::SMEM,
                        s>>>(tk, P, ok);
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the head
// dim of every operand is contiguous.  q and k are dh wide, v and out dv
// wide (dv <= dh); dh <= 256, or in bfloat16 with dv != dh and in float32
// dh <= 576 (bfloat16 dv <= 512).  scale multiplies q.k (the callers' 1 /
// sqrt(dh) unless they say otherwise).  vec_ok: dh, dv and every q/k/v
// stride are multiples of 8 and the q/k/v pointers 16-byte aligned.
// v_in_k: v is a view of k's first dv columns (same pointer and strides).
// The split decodes (flash_attention_plan says when) take `scratch`,
// float32 of the size the plan gives, and `tickets`, an int32 per (n, KV
// head) that is zero before the launch and zero again after it.
extern "C" int flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* o, int n,
    int sq, int skv, int hk, int g, int dh, int dv, long long q_sn,
    long long q_ss, long long q_sh, long long q_sg, long long k_sn,
    long long k_ss, long long k_sh, long long v_sn, long long v_ss,
    long long v_sh, long long o_sn, long long o_ss, long long o_sh,
    long long o_sg, int causal, int window, float softcap, float scale,
    int q0, int kv_len, int vec_ok, int v_in_k, void* scratch,
    void* tickets, void* stream) {
  Params P;
  P.q = q;
  P.k = k;
  P.v = v;
  P.o = o;
  P.n = n;
  P.sq = sq;
  P.skv = skv;
  P.hk = hk;
  P.g = g;
  P.dh = dh;
  P.dv = dv;
  P.q_sn = q_sn;
  P.q_ss = q_ss;
  P.q_sh = q_sh;
  P.q_sg = q_sg;
  P.k_sn = k_sn;
  P.k_ss = k_ss;
  P.k_sh = k_sh;
  P.v_sn = v_sn;
  P.v_ss = v_ss;
  P.v_sh = v_sh;
  P.o_sn = o_sn;
  P.o_ss = o_ss;
  P.o_sh = o_sh;
  P.o_sg = o_sg;
  P.causal = causal;
  P.window = window;
  P.softcap = softcap;
  P.scale = scale;
  P.q0 = q0;
  P.kv_len = kv_len;
  P.vec_ok = vec_ok;
  P.v_in_k = v_in_k;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dh < 1 || dv < 1 || dv > dh || dtype < 0 || dtype > 1 ||
      dh > MLA_DQ || (dtype == 1 && (dv > MLA_DV || (dh > 256 && dv == dh))))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan(dtype, n, sq, hk, g, dh, dv, q0, kv_len, causal,
                       window, vec_ok, v_in_k);
  int rc = 0;
  if (pl.path == PATH_F32) {
    if (pl.dhp <= 32) launch_f32<32>(P, s);
    else if (pl.dhp == 64) launch_f32<64>(P, s);
    else if (pl.dhp == 128) launch_f32<128>(P, s);
    else if (pl.dhp == 256) launch_f32<256>(P, s);
    else launch_f32<MLA_DQ>(P, s);
  } else if (pl.path == PATH_MLA) {
    float* part = static_cast<float*>(scratch);
    int* tk = static_cast<int*>(tickets);
    if (pl.splits > 1 && (part == nullptr || tk == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    rc = pl.mla_decode ? launch_mla<MlaDecode, 1, 64>(P, pl, part, tk, s)
                       : launch_mla<MlaPrefill, 4, 32>(P, pl, part, tk, s);
  } else if (pl.path == PATH_SPLIT) {
    if (scratch == nullptr || tickets == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    float* part = static_cast<float*>(scratch);
    int* tk = static_cast<int*>(tickets);
    rc = pl.dhp == 32    ? launch_ring<32>(P, pl, part, tk, s)
         : pl.dhp == 64  ? launch_ring<64>(P, pl, part, tk, s)
         : pl.dhp == 128 ? launch_ring<128>(P, pl, part, tk, s)
                         : launch_ring<256>(P, pl, part, tk, s);
  } else if (pl.path == PATH_MLA_WGMMA) {
    rc = launch_mla_wgmma(P, s);
  } else if (pl.path == PATH_WGMMA) {
    rc = dh == 64 && !(softcap > 0.f) ? launch_wgmma64(P, s)
         : dh == 64  ? launch_wgmma<64>(P, s)
         : dh == 128 ? launch_wgmma<128>(P, s)
                     : launch_wgmma<256>(P, s);
  } else {
    if (pl.dhp == 16) launch_bf16<16>(P, s);
    else if (pl.dhp == 32) launch_bf16<32>(P, s);
    else if (pl.dhp == 64) launch_bf16<64>(P, s);
    else if (pl.dhp == 128) launch_bf16<128>(P, s);
    else launch_bf16<256>(P, s);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The path a call with these arguments takes (0 float32, 1 mma.sync, 2
// wgmma, 3 split decode, 4 MLA, 5 MLA prefill on wgmma) and, in *scratch,
// the float32 scratch it needs.
extern "C" int flash_attention_plan(int dtype, int n, int sq, int hk, int g,
                                    int dh, int dv, int q0, int kv_len,
                                    int causal, int window, int vec_ok,
                                    int v_in_k, long long* scratch) {
  const Plan pl = plan(dtype, n, sq, hk, g, dh, dv, q0, kv_len, causal,
                       window, vec_ok, v_in_k);
  *scratch = pl.scratch;
  return pl.path;
}
