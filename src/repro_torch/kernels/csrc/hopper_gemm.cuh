// The Hopper GEMM mainloop: one 128 x BN output tile of x @ w (16-bit
// operands, float32 accumulator) per call, in a warp-specialized CTA of
// 384 threads (one CTA per SM):
//
//   * warpgroups 0 and 1 (consumers) each own 64 rows of the tile and run
//     wgmma m64nBNk16 on the stages that have landed, one wgmma group in
//     flight, releasing a stage as soon as the group that read it is done;
//   * warpgroup 2 gives its registers to the consumers (setmaxnreg); its
//     first thread (the producer) keeps TMA loads of 64-deep K tiles in
//     flight into a ring of STAGES 128-byte-swizzled stages, paced by
//     full/empty mbarriers; the kernel that includes this header gives
//     the other warps of warpgroup 2 their own work.
//
// A stage is an x tile [128 rows, 64 k] (K-major, 16 KB) and a w tile
// [64 k, BN cols] (MN-major: w is [k, m] with m contiguous, BN/64 boxes
// of 64 columns, 8 KB each), so the B descriptor is MN-major with the
// transpose-B bit set.  The tile shape is a template parameter (Tile<BN,
// STAGES>, BN 128 or 256).  The ring takes Tile<> (BN, STAGES below): the
// 256-wide tile reads 2/3 of the bytes per product that a square 128 x
// 128 tile reads, which is what counts with the ring's 128 SMs pulling
// their operands from L2 at once; three stages ran the ring faster than
// four or six (PERF.md section 6, from kernels/variants.py).  The
// persistent block matmul (block_matmul.cu) picks its own width per call.
// TMA zero-fills what lies beyond a map's extent: ragged n, k and m need
// no masking in the loads, and the epilogue masks the stores.  The
// producer and the consumers walk the same sequence of tiles, so they
// agree on every stage without talking.
//
// Used by agmm_ring.cu and block_matmul.cu for bf16/fp16 operands whose
// base pointers are 16-byte aligned and whose k and m are multiples of 8
// (TMA's 16-byte strides); float32 and unaligned shapes keep mm_tile.cuh.

#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace hgemm {

using namespace hopper;

constexpr int BM = 128;                        // rows of a tile: 2 x 64
constexpr int BN = 256;                        // the ring's tile width
constexpr int BK = 64;                         // K depth of a stage
constexpr int STAGES = 3;                      // the ring's stages
constexpr int A_BYTES = BM * BK * 2;           // 16 KB
constexpr int B_BOX = BK * 64 * 2;             // one 64-column w box, 8 KB
constexpr int CONSUMERS = 256;                 // warpgroups 0 and 1
constexpr int THREADS = CONSUMERS + 128;       // + warpgroup 2
// registers per thread after setmaxnreg (168 at launch; 384 x 168 >=
// 2 x 128 x 208 + 128 x 80): the consumers' 128 accumulators and their
// addresses, and the copy loops of the ring's producer warpgroup, which
// keep eight 16-byte loads in flight per thread
constexpr int CONSUMER_REGS = 208;
constexpr int PRODUCER_REGS = 80;

// The shape of a tile and its ring of stages.
template <int BN_ = BN, int STAGES_ = STAGES>
struct Tile {
  static_assert(BN_ == 128 || BN_ == 256, "wgmma n128 or n256");
  static constexpr int N = BN_;                        // columns of a tile
  static constexpr int STAGES = STAGES_;
  static constexpr int B_BYTES = (N / 64) * B_BOX;     // 16 or 32 KB
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int ACC = N / 2;                    // per thread
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 256;
};

constexpr int ACC = Tile<>::ACC;               // the ring's
constexpr int SMEM_BYTES = Tile<>::SMEM_BYTES;

struct Smem {
  unsigned char* stages;   // STAGES x STAGE_BYTES, 1024-byte aligned
  uint64_t* full;          // [STAGES]: the stage's bytes have landed
  uint64_t* empty;         // [STAGES]: the 8 consumer warps are done
  volatile int* abort;     // set by a role that gives up
  int* scratch;            // 8 ints for the kernel's own use
};

template <class G = Tile<>>
__device__ __forceinline__ Smem carve(unsigned char* raw) {
  const uint32_t base = smem_u32(raw);
  unsigned char* st = raw + (((base + 1023u) & ~1023u) - base);
  Smem s;
  s.stages = st;
  s.full = reinterpret_cast<uint64_t*>(st + G::STAGES * G::STAGE_BYTES);
  s.empty = s.full + G::STAGES;
  s.abort = reinterpret_cast<volatile int*>(s.empty + G::STAGES);
  s.scratch = const_cast<int*>(s.abort) + 1;
  return s;
}

// Thread 0, before a __syncthreads() that every role passes.
template <class G = Tile<>>
__device__ __forceinline__ void init(Smem& s) {
  for (int i = 0; i < G::STAGES; ++i) {
    mbar_init(&s.full[i], 1);
    mbar_init(&s.empty[i], CONSUMERS / 32);
  }
  *s.abort = 0;
  fence_barrier_init();
}

// Producer (one thread): the loads of one output tile, every K tile: x
// from map ma at {kt*BK, a_row, a_z}, w from map mb at {b_col + 64j,
// kt*BK, b_z}.  False if it gave up.
template <class G = Tile<>>
__device__ __forceinline__ bool load_tile(Smem& s, PipeState& st,
                                          const CUtensorMap* ma, int a_row,
                                          int a_z, const CUtensorMap* mb,
                                          int b_col, int b_z, int nk) {
  for (int kt = 0; kt < nk; ++kt) {
    if (!mbar_wait(&s.empty[st.stage], st.phase ^ 1u, s.abort)) return false;
    uint64_t* fb = &s.full[st.stage];
    unsigned char* a = s.stages + st.stage * G::STAGE_BYTES;
    mbar_expect_tx(fb, G::STAGE_BYTES);
    tma_load_3d(a, ma, fb, kt * BK, a_row, a_z);
#pragma unroll
    for (int j = 0; j < G::N / 64; ++j)
      tma_load_3d(a + A_BYTES + j * B_BOX, mb, fb, b_col + 64 * j, kt * BK,
                  b_z);
    st.advance(G::STAGES);
  }
  return true;
}

// Producer: wait until the last `loads` stage fills issued before `st`
// have landed (their global reads are complete).  No stage can be filled
// again before the producer itself refills it, so each full barrier is
// still at the phase of the fill in question.
template <class G = Tile<>>
__device__ __forceinline__ bool loads_landed(Smem& s, PipeState st,
                                             int loads) {
  for (int i = 0; i < loads && i < G::STAGES; ++i) {
    if (st.stage == 0) {
      st.stage = G::STAGES - 1;
      st.phase ^= 1u;
    } else {
      --st.stage;
    }
    if (!mbar_wait(&s.full[st.stage], st.phase, s.abort)) return false;
  }
  return true;
}

template <typename T, int NACC>
__device__ __forceinline__ void mma_k16(float (&acc)[NACC], uint64_t da,
                                        uint64_t db, int scale_d) {
  constexpr bool half = std::is_same_v<T, __half>;
  if constexpr (NACC == 128 && half)
    wgmma_ss_n256_f16<1>(acc, da, db, scale_d);
  else if constexpr (NACC == 128)
    wgmma_ss_n256_bf16<1>(acc, da, db, scale_d);
  else if constexpr (half)
    wgmma_ss_n128_f16<1>(acc, da, db, scale_d);
  else
    wgmma_ss_n128_bf16<1>(acc, da, db, scale_d);
}

// Consumer warpgroup wg: acc = its 64 rows of the tile whose nk stages
// come next in the ring.  False if it gave up.
template <typename T, class G = Tile<>>
__device__ __forceinline__ bool mma_tile(Smem& s, PipeState& st,
                                         float (&acc)[G::ACC], int nk,
                                         int wg) {
  const bool signal = threadIdx.x % 32 == 0;
  PipeState prev = st;
  for (int kt = 0; kt < nk; ++kt) {
    if (!mbar_wait(&s.full[st.stage], st.phase, s.abort)) {
      wg_wait<0>();               // no product in flight past the exit
      return false;
    }
    unsigned char* a = s.stages + st.stage * G::STAGE_BYTES;
    const uint64_t da = desc_sw128(a + wg * 64 * 128, 16, 1024);
    const uint64_t db = desc_sw128(a + A_BYTES, B_BOX, 1024);
    fence_operands(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)   // +32 bytes in x, +16 rows in w
      mma_k16<T>(acc, da + 2 * kk, db + 128 * kk, (kt | kk) != 0);
    wg_commit();
    wg_wait<1>();                 // the previous stage's products are done
    fence_operands(acc);
    if (kt > 0 && signal) mbar_arrive(&s.empty[prev.stage]);
    prev = st;
    st.advance(G::STAGES);
  }
  wg_wait<0>();
  fence_operands(acc);
  if (nk > 0 && signal) mbar_arrive(&s.empty[prev.stage]);
  if (nk == 0) {
#pragma unroll
    for (int i = 0; i < G::ACC; ++i) acc[i] = 0.f;
  }
  return true;
}

template <typename T>
__device__ __forceinline__ T to(float v) {
  if constexpr (std::is_same_v<T, __half>)
    return __float2half_rn(v);
  else
    return __float2bfloat16_rn(v);
}

// Consumer warpgroup wg: its 64 rows of the tile at (row0, col0) into
// o [rows, cols] (row stride ld, cols even), masked at the edges.
// Thread (warp w, lane) holds rows 16w + lane/4 (+8) and, per 8-column
// group j, columns 8j + 2 (lane % 4) and +1.
template <typename T, class G = Tile<>>
__device__ __forceinline__ void store_tile(const float (&acc)[G::ACC], T* o,
                                           long long ld, int rows, int cols,
                                           int row0, int col0, int wg) {
  const int lane = threadIdx.x % 32, w = (threadIdx.x / 32) % 4;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + wg * 64 + w * 16 + g + 8 * half;
    if (r >= rows) continue;
    T* orow = o + r * ld;
#pragma unroll
    for (int j = 0; j < G::N / 8; ++j) {
      const int c = col0 + 8 * j + 2 * t;
      if (c >= cols) continue;
      const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if (c + 1 < cols) {
        T pair[2] = {to<T>(v0), to<T>(v1)};
        *reinterpret_cast<uint32_t*>(orow + c) =
            *reinterpret_cast<const uint32_t*>(pair);
      } else {
        orow[c] = to<T>(v0);
      }
    }
  }
}

}  // namespace hgemm
