// One-kernel ring all-gather-matmul: out[r] = all_gather(x) @ w[r] for p
// ranks stacked on one card, with a float32 accumulator.
//
// Replaces the TPU kernels
// repro/kernels/collective_matmul_rdma.py:ring_allgather_matmul_rdma
// (_agmm_rdma_kernel) and, with blocks_mode set, its interpret-mode tier
// ring_allgather_matmul_blocks (_agmm_block_kernel).  The TPU kernel sends
// the resident chunk to the right neighbour's VMEM over the chip-to-chip
// links while it multiplies it; here every rank lives in the same device
// memory, so the "remote copy" is a copy into the right neighbour's slot
// of a scratch buffer, and the DMA and credit semaphores become counters
// in device memory.
//
// Bound on an H100 at the gate/up shape (p = 8 ranks, x [512, 3072] and
// w [3072, 2048] bf16 per rank): 2*8*4096*3072*2048 = 412 GFLOP, 0.42 ms
// at 989 TFLOP/s, against ~0.26 GB of operands and outputs, 0.08 ms at
// 3.35 TB/s: bound by operations.  Two kernels, chosen before the launch
// from the dtype and the alignment (agmm_ring_path):
//   * bf16/fp16 with vec_ok (agmm_ring_tma_kernel): warp-specialized CTAs
//     of 384 threads, one per SM, on the wgmma/TMA mainloop of
//     hopper_gemm.cuh (128 x 256 output tiles, two consumer warpgroups
//     of 64 rows on m64n256k16, a 3-stage TMA ring of 64-deep K tiles),
//     each rank's C CTAs sharing a step's tiles.  The ring's waits move to
//     the roles that need them, so nothing stops the tensor cores: the
//     producer thread waits for a step's chunk before it issues that
//     step's loads (with a proxy fence, since the slot was written by
//     generic stores on other SMs and TMA reads through the async proxy)
//     and grants the left neighbour its credit as soon as the step's
//     loads have landed; three copy warps of the producer warpgroup send
//     the chunk to the right neighbour and into `gathered` (16-byte
//     loads, eight in flight per thread before their stores), overlapping
//     the products: with the copies taken out it runs ~10 % faster, with
//     one load in flight per thread ~12 % slower (NVIDIA H100 80GB HBM3 at
//     700 W; PERF.md section 6, from kernels/variants.py);
//   * float32, or operands TMA cannot address (agmm_ring_kernel): the
//     256-thread tile loop of mm_tile.cuh (WMMA for 16-bit types, FMA for
//     float32), each block running the protocol below in program order.
//
// Protocol (ring_schedule of the JAX package), for rank r at step s, with
// slot = s % 2, nxt = (s + 1) % 2, src = (r - s + p) % p:
//   1. 1 <= s < p-1: wait until rank r+1 has finished reading its slot
//      nxt at step s-1 (credit);
//   2. s < p-1: each of rank r's C blocks copies its share of the
//      resident chunk (x[r] at s = 0, slot `slot` after) into rank r+1's
//      slot nxt, then signals the arrival with a release;
//   3. its share of the chunk's output tiles goes to out[r] rows src*n,
//      and its share of the chunk to gathered[r] rows src*n;
//   4. s < p-1: wait until the chunk of step s+1 has arrived (acquire);
//   5. s < p-2: grant rank r-1 its credit (slot `slot` is consumed).
// agmm_ring_kernel counts arrivals and credits in monotonic counters
// arrived[r] >= C*(s+1) and credit[r] >= C*s: each block runs the steps
// in order, so a count cannot run ahead of the step it stands for.  In
// agmm_ring_tma_kernel a block's roles run ahead of each other, so every
// step has its own counters: arrived[r][s] (C sends of rank r-1 at step
// s-1) and credit[r][s] (2C grants of rank r+1 after its step s reads:
// one from the producer, one from the copy warps).  The counters are
// zeroed by the wrapper before each launch.  A block of rank r spins on
// counters set by ranks r-1 and r+1, so all p*C blocks must be resident at
// once: the launch is cooperative, and C comes from the occupancy query.
// Slots are read past L1 (cp.async.cg / __ldcg, or TMA through L2), since
// L1 is not coherent across SMs.  Every spin is bounded: on timeout a
// block records (kind, rank, step) in the error words and exits, and the
// other blocks give up when they see it.
//
// blocks_mode: rank `my` of p alone (grid of C blocks, no counters, no
// slots): the chunk of step s is read from x_all[src(my, s)], which is
// what the ring would have delivered.
//
// Plain C interface, built with nvcc for sm_90a and loaded with ctypes.

#include <type_traits>

#include "hopper_gemm.cuh"
#include "mm_tile.cuh"

namespace {

using namespace mmtile;

constexpr unsigned long long WAIT_NS = 5000000000ull;   // 5 s per wait

struct Args {
  const void* x;        // [p, n, k]: rank r's chunk (x_all in blocks_mode)
  const void* w;        // [p, k, m] with batch stride swb (0 = shared)
  void* out;            // [p, p*n, m] ([p*n, m] in blocks_mode)
  void* gath;           // like out with k columns, or null
  void* slots;          // [p, 2, n, k] scratch
  int* flags;           // arrived[p], credit[p], error kind/rank/step,
                        // arrived[p][p], credit[p][p] (per step)
  long long swb;
  int p, n, k, m;
  int blocks_mode, my, vec_ok, C;
};

__device__ __forceinline__ int ld_acquire(const int* f) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(f)
               : "memory");
  return v;
}

__device__ __forceinline__ void red_release(int* f, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(f), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One thread spins until *f >= target; false if it timed out (recorded
// as kind/rank/step) or another block already had.
__device__ __forceinline__ bool poll(const int* f, int target, int* err,
                                     int kind, int rank, int step) {
  bool ok = true;
  const unsigned long long t0 = now_ns();
  while (ld_acquire(f) < target) {
    if (*(volatile int*)err != 0) { ok = false; break; }
    if (now_ns() - t0 > WAIT_NS) {
      if (atomicCAS(err, 0, kind) == 0) {
        atomicExch(err + 1, rank);
        atomicExch(err + 2, step);
      }
      ok = false;
      break;
    }
    __nanosleep(200);
  }
  __threadfence();
  return ok;
}

// Thread 0 of the block polls; every thread of the block gets the answer.
__device__ bool block_wait(const int* f, int target, int* err, int kind,
                           int rank, int step) {
  __shared__ int ok;
  __syncthreads();   // every thread has read the previous answer
  if (threadIdx.x == 0) ok = poll(f, target, err, kind, rank, step);
  __syncthreads();
  return ok != 0;
}

// After every thread of the block has written: publish with a release.
__device__ __forceinline__ void block_signal(int* f) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    red_release(f, 1);
  }
}

// Block c's share of a chunk of `elems` elements: [lo, hi), in 8-element
// units so the vector path stays on 16-byte boundaries.
__device__ __forceinline__ void share(long long elems, int c, int C,
                                      long long* lo, long long* hi) {
  const long long units = (elems + 7) / 8;
  const long long per = (units + C - 1) / C;
  *lo = min(elems, (long long)c * per * 8);
  *hi = min(elems, (long long)(c + 1) * per * 8);
}

// dst (may be null) and dst2 (may be null) <- src over [lo, hi).
template <typename T>
__device__ __forceinline__ void copy_share(const T* src, T* dst, T* dst2,
                                           long long lo, long long hi,
                                           int vec) {
  if (vec) {  // 16-byte aligned, lo and hi multiples of 8 elements
    const int4* s4 = reinterpret_cast<const int4*>(src + lo);
    int4* d4 = dst ? reinterpret_cast<int4*>(dst + lo) : nullptr;
    int4* e4 = dst2 ? reinterpret_cast<int4*>(dst2 + lo) : nullptr;
    const long long n4 = (hi - lo) * (long long)sizeof(T) / 16;
    for (long long i = threadIdx.x; i < n4; i += THREADS) {
      const int4 v = __ldcg(s4 + i);
      if (d4) __stcg(d4 + i, v);
      if (e4) __stcg(e4 + i, v);
    }
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += THREADS) {
      const T v = __ldcg(src + i);
      if (dst) dst[i] = v;
      if (dst2) dst2[i] = v;
    }
  }
}

template <typename T>
__host__ __device__ constexpr int tile_rows() {
  return sizeof(T) == 4 ? FM : BM;
}

template <typename T>
__host__ __device__ constexpr int tile_cols() {
  return sizeof(T) == 4 ? FN : BN;
}

template <typename T>
__host__ __device__ constexpr int tile_count(int m, int n) {
  return ((m + tile_rows<T>() - 1) / tile_rows<T>()) *
         ((n + tile_cols<T>() - 1) / tile_cols<T>());
}

// Output tile t (row-major over the tile grid) of x [m, k] @ w [k, n].
template <typename T>
__device__ __forceinline__ void tile(unsigned char* smem, const T* xb,
                                     const T* wb, T* ob, int m, int n, int k,
                                     int t, int vec_ok) {
  const int tn = (n + tile_cols<T>() - 1) / tile_cols<T>();
  const int row0 = (t / tn) * tile_rows<T>();
  const int col0 = (t % tn) * tile_cols<T>();
  if constexpr (sizeof(T) == 4)
    f32_tile(smem, xb, wb, ob, m, n, k, row0, col0);
  else
    tc_tile(smem, xb, wb, ob, m, n, k, row0, col0, vec_ok);
}

template <typename T>
constexpr int smem_bytes() {
  return sizeof(T) == 4 ? F32_SMEM_BYTES : tc_smem_bytes<T>();
}

template <typename T>
__global__ void __launch_bounds__(THREADS) agmm_ring_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int C = a.C;
  const int c = blockIdx.x % C;
  const int r = a.blocks_mode ? a.my : blockIdx.x / C;
  const int p = a.p, n = a.n, k = a.k, m = a.m;
  const long long chunk = (long long)n * k;
  const T* x = static_cast<const T*>(a.x);
  const T* wr = static_cast<const T*>(a.w) + (long long)r * a.swb;
  T* slots = static_cast<T*>(a.slots);
  int* arrived = a.flags;
  int* credit = a.flags + p;
  int* err = a.flags + 2 * p;
  const long long rows_out = a.blocks_mode ? 0 : (long long)p * n;
  T* out = static_cast<T*>(a.out) + rows_out * r * m;
  T* gath = a.gath ? static_cast<T*>(a.gath) + rows_out * r * k : nullptr;
  const int right = (r + 1) % p;
  const int left = (r + p - 1) % p;
  const int tiles = tile_count<T>(n, m);
  long long lo, hi;
  share(chunk, c, C, &lo, &hi);

  for (int s = 0; s < p; ++s) {
    const int slot = s % 2, nxt = (s + 1) % 2;
    const int src = (r - s + p) % p;
    const T* cur;
    T* send = nullptr;
    if (a.blocks_mode) {
      cur = x + src * chunk;
    } else {
      cur = s == 0 ? x + r * chunk : slots + ((long long)r * 2 + slot) * chunk;
      if (s >= 1 && s < p - 1 &&
          !block_wait(credit + r, C * s, err, 1, r, s))
        return;
      if (s < p - 1) send = slots + ((long long)right * 2 + nxt) * chunk;
    }
    copy_share(cur, send, gath ? gath + src * chunk : nullptr, lo, hi,
               a.vec_ok);
    if (send) block_signal(arrived + right);
    for (int t = c; t < tiles; t += C)
      tile<T>(smem_raw, cur, wr, out + (long long)src * n * m, n, m, k, t,
              a.vec_ok);
    if (a.blocks_mode) continue;
    if (s < p - 1 && !block_wait(arrived + r, C * (s + 1), err, 2, r, s))
      return;
    if (s < p - 2) block_signal(credit + left);
  }
}

// -- bf16/fp16 on the wgmma/TMA mainloop -------------------------------------

constexpr int COPY_THREADS = 96;        // warps 9-11: the ring's copies
constexpr int COPY_BAR = 1;             // their named barrier

// The copy warps' thread 0 polls; all of them get the answer.
__device__ __forceinline__ bool group_wait(const int* f, int target,
                                           int* err, int kind, int rank,
                                           int step, int gtid, int* box) {
  if (gtid == 0)
    *(volatile int*)box = poll(f, target, err, kind, rank, step) ? 1 : 0;
  hopper::named_bar_sync(COPY_BAR, COPY_THREADS);
  const bool ok = *(volatile int*)box != 0;
  hopper::named_bar_sync(COPY_BAR, COPY_THREADS);   // read before rewritten
  return ok;
}

// After every copy thread has written (or read): publish with a release.
__device__ __forceinline__ void group_signal(int* f, int gtid) {
  hopper::named_bar_sync(COPY_BAR, COPY_THREADS);
  if (gtid == 0) {
    __threadfence();
    red_release(f, 1);
  }
}

// The copy warps' share [lo, hi) of a chunk (16-byte aligned, in units of
// 8 elements) into dst and dst2 (either may be null): batches of UNROLL
// 16-byte loads in flight per thread before their stores, since the
// compiler cannot know that the stores do not alias the next loads.
template <typename T>
__device__ __forceinline__ void copy_batched(const T* src, T* dst, T* dst2,
                                             long long lo, long long hi,
                                             int tid) {
  constexpr int UNROLL = 8;
  const int4* s4 = reinterpret_cast<const int4*>(src + lo);
  int4* d4 = dst ? reinterpret_cast<int4*>(dst + lo) : nullptr;
  int4* e4 = dst2 ? reinterpret_cast<int4*>(dst2 + lo) : nullptr;
  const long long n4 = (hi - lo) * (long long)sizeof(T) / 16;
  long long i = tid;
  for (; i + (UNROLL - 1) * COPY_THREADS < n4; i += UNROLL * COPY_THREADS) {
    int4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldcg(s4 + i + u * COPY_THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (d4) __stcg(d4 + i + u * COPY_THREADS, v[u]);
      if (e4) __stcg(e4 + i + u * COPY_THREADS, v[u]);
    }
  }
  for (; i < n4; i += COPY_THREADS) {
    const int4 v = __ldcg(s4 + i);
    if (d4) __stcg(d4 + i, v);
    if (e4) __stcg(e4 + i, v);
  }
}

__host__ __device__ constexpr int tma_tiles(int n, int m) {
  return ((n + hgemm::BM - 1) / hgemm::BM) * ((m + hgemm::BN - 1) / hgemm::BN);
}

// Maps: tm_x over x [p, n, k] (x_all in blocks_mode), tm_slots over
// slots [2p, n, k] (x again in blocks_mode), tm_w over w [pw, k, m]; the
// flags hold the error words at 2p and the per-step counters arrived
// [p][p] and credit [p][p] after them.
template <typename T>
__global__ void __launch_bounds__(hgemm::THREADS, 1)
    agmm_ring_tma_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_slots,
                         const __grid_constant__ CUtensorMap tm_w, Args a) {
  extern __shared__ unsigned char smem_raw[];
  hgemm::Smem sm = hgemm::carve(smem_raw);
  const int C = a.C;
  const int c = blockIdx.x % C;
  const int r = a.blocks_mode ? a.my : blockIdx.x / C;
  const int p = a.p, n = a.n, k = a.k, m = a.m;
  const bool ring = !a.blocks_mode;
  int* err = ring ? a.flags + 2 * p : nullptr;
  int* arrived = ring ? a.flags + 2 * p + 3 : nullptr;
  int* credit = ring ? arrived + p * p : nullptr;
  const int right = (r + 1) % p;
  const int left = (r + p - 1) % p;
  const int tiles = tma_tiles(n, m);
  const int tn = (m + hgemm::BN - 1) / hgemm::BN;
  const int nk = (k + hgemm::BK - 1) / hgemm::BK;
  if (threadIdx.x == 0) hgemm::init(sm);
  __syncthreads();

  if (threadIdx.x >= hgemm::CONSUMERS) {
    hopper::reg_dealloc<hgemm::PRODUCER_REGS>();
    const int ptid = threadIdx.x - hgemm::CONSUMERS;
    if (ptid == 0) {
      // ---- the producer: TMA loads, arrival waits, credit grants --------
      hopper::PipeState st;
      for (int s = 0; s < p; ++s) {
        const int src = (r - s + p) % p;
        const CUtensorMap* ma = &tm_x;
        int az = a.blocks_mode ? src : r;
        if (ring && s > 0) {
          if (!poll(arrived + r * p + s, C, err, 2, r, s)) {
            *sm.abort = 1;
            return;
          }
          hopper::fence_proxy_async_global();   // the slot's generic stores
          ma = &tm_slots;
          az = r * 2 + s % 2;
        }
        int loads = 0;
        for (int t = c; t < tiles; t += C) {
          if (!hgemm::load_tile(sm, st, ma, (t / tn) * hgemm::BM, az, &tm_w,
                                (t % tn) * hgemm::BN, a.swb ? r : 0, nk))
            return;
          loads += nk;
        }
        if (ring && s < p - 2) {
          if (!hgemm::loads_landed(sm, st, loads)) return;
          hopper::fence_proxy_async_global();
          __threadfence();
          red_release(credit + left * p + s, 1);
        }
      }
    } else if (ptid >= 32) {
      // ---- the copy warps: sends to the right neighbour, gathered rows --
      const int gtid = ptid - 32;
      const long long chunk = (long long)n * k;
      const T* x = static_cast<const T*>(a.x);
      T* slots = static_cast<T*>(a.slots);
      const long long rows_out = ring ? (long long)p * n : 0;
      T* gath = a.gath ? static_cast<T*>(a.gath) + rows_out * r * k : nullptr;
      long long lo, hi;
      share(chunk, c, C, &lo, &hi);
      for (int s = 0; s < p; ++s) {
        const int src = (r - s + p) % p;
        const T* cur = x + (long long)(a.blocks_mode ? src : r) * chunk;
        T* send = nullptr;
        if (ring) {
          if (s > 0) {
            if (!group_wait(arrived + r * p + s, C, err, 2, r, s, gtid,
                            sm.scratch)) {
              *sm.abort = 1;
              return;
            }
            cur = slots + ((long long)r * 2 + s % 2) * chunk;
          }
          if (s >= 1 && s < p - 1 &&
              !group_wait(credit + r * p + s - 1, 2 * C, err, 1, r, s, gtid,
                          sm.scratch)) {
            *sm.abort = 1;
            return;
          }
          if (s < p - 1)
            send = slots + ((long long)right * 2 + (s + 1) % 2) * chunk;
        }
        if (send || gath)
          copy_batched(cur, send, gath ? gath + src * chunk : nullptr, lo,
                       hi, gtid);
        if (send) group_signal(arrived + right * p + s + 1, gtid);
        if (ring && s < p - 2) group_signal(credit + left * p + s, gtid);
      }
    }
  } else {
    // ---- the consumers: wgmma over the stages, the epilogue ----------------
    hopper::reg_alloc<hgemm::CONSUMER_REGS>();
    const int wg = threadIdx.x / 128;
    const long long rows_out = ring ? (long long)p * n : 0;
    T* out = static_cast<T*>(a.out) + rows_out * r * m;
    hopper::PipeState st;
    float acc[hgemm::ACC];
#pragma unroll
    for (int i = 0; i < hgemm::ACC; ++i) acc[i] = 0.f;
    for (int s = 0; s < p; ++s) {
      T* ob = out + (long long)((r - s + p) % p) * n * m;
      for (int t = c; t < tiles; t += C) {
        if (!hgemm::mma_tile<T>(sm, st, acc, nk, wg)) return;
        hgemm::store_tile<T>(acc, ob, m, n, m, (t / tn) * hgemm::BM,
                             (t % tn) * hgemm::BN, wg);
      }
    }
  }
}

// Whether a launch takes agmm_ring_tma_kernel: 16-bit operands that TMA
// can address (vec_ok) and a non-empty contraction.
inline bool takes_tma(int dtype, int k, int vec_ok) {
  return (dtype == 1 || dtype == 2) && vec_ok && k > 0;
}

// Blocks per rank: as many as stay resident beside the other ranks', at
// most one per output tile of a step; 0 when not even one fits.
template <typename K>
int blocks_per_rank(K kernel, int threads, int bytes, int ranks, int tiles,
                    int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                bytes)) != cudaSuccess ||
      (e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, bytes)) != cudaSuccess)
    return static_cast<int>(e);
  const int resident = per_sm * sms / ranks;
  *out = resident < tiles ? resident : tiles;
  return 0;
}

template <typename T>
int tile_blocks_per_rank(int ranks, int n, int m, int* out) {
  return blocks_per_rank(agmm_ring_kernel<T>, THREADS, smem_bytes<T>(), ranks,
                         n > 0 && m > 0 ? tile_count<T>(n, m) : 1, out);
}

template <typename T>
int tma_blocks_per_rank(int ranks, int n, int m, int* out) {
  return blocks_per_rank(agmm_ring_tma_kernel<T>, hgemm::THREADS,
                         hgemm::SMEM_BYTES, ranks,
                         n > 0 && m > 0 ? tma_tiles(n, m) : 1, out);
}

template <typename T>
int launch(Args a, cudaStream_t stream) {
  const int ranks = a.blocks_mode ? 1 : a.p;
  int rc = tile_blocks_per_rank<T>(ranks, a.n, a.m, &a.C);
  if (rc != 0) return rc;
  if (a.C < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(agmm_ring_kernel<T>), dim3(ranks * a.C),
      dim3(THREADS), args, smem_bytes<T>(), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tma(Args a, cudaStream_t stream) {
  const int ranks = a.blocks_mode ? 1 : a.p;
  int rc = tma_blocks_per_rank<T>(ranks, a.n, a.m, &a.C);
  if (rc != 0) return rc;
  if (a.C < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const bool bf16 = std::is_same_v<T, __nv_bfloat16>;
  const uint64_t n = a.n, k = a.k, m = a.m, p = a.p;
  const uint64_t xs[2] = {k * 2, n * k * 2};
  const uint32_t xbox[3] = {64, hgemm::BM, 1};
  const uint64_t xd[3] = {k, n, p};
  const uint64_t sd[3] = {k, n, 2 * p};
  const uint64_t wd[3] = {m, k, a.swb ? p : 1};
  const uint64_t ws[2] = {m * 2, k * m * 2};
  const uint32_t wbox[3] = {64, hgemm::BK, 1};
  CUtensorMap tx, ts, tw;
  if ((rc = hopper_host::encode_16bit(&tx, a.x, 3, xd, xs, xbox, bf16)) ||
      (rc = hopper_host::encode_16bit(
           &ts, a.blocks_mode ? a.x : a.slots, 3, a.blocks_mode ? xd : sd,
           xs, xbox, bf16)) ||
      (rc = hopper_host::encode_16bit(&tw, a.w, 3, wd, ws, wbox, bf16)))
    return rc;
  void* args[] = {&tx, &ts, &tw, &a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(agmm_ring_tma_kernel<T>), dim3(ranks * a.C),
      dim3(hgemm::THREADS), args, hgemm::SMEM_BYTES, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  x [p, n, k], w [p, k, m]
// (swb = k*m) or shared [k, m] (swb = 0), out [p, p*n, m], gath
// [p, p*n, k] or null, slots [p, 2, n, k], flags int32 [2p + 3 + 2p^2]
// zeroed (the counters of agmm_ring_kernel, the error words, the per-step
// counters of agmm_ring_tma_kernel); in blocks_mode out is [p*n, m] and
// gath [p*n, k] for rank `my`, and slots and flags are unused.  vec_ok: k
// and m are multiples of 8 and every base pointer is 16-byte aligned.
// Returns the launch's CUDA error.
extern "C" int agmm_ring(int dtype, const void* x, const void* w, void* out,
                         void* gath, void* slots, void* flags, int p, int n,
                         int k, int m, long long swb, int blocks_mode,
                         int my, int vec_ok, void* stream) {
  Args a{x, w, out, gath, slots, static_cast<int*>(flags), swb, p, n, k, m,
         blocks_mode, my, vec_ok, 1};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool tma = takes_tma(dtype, k, vec_ok);
  if (dtype == 0) return launch<float>(a, s);
  if (dtype == 1)
    return tma ? launch_tma<__nv_bfloat16>(a, s) : launch<__nv_bfloat16>(a, s);
  if (dtype == 2) return tma ? launch_tma<__half>(a, s) : launch<__half>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The kernel a launch takes: 0 = agmm_ring_kernel in float32 FMA, 1 =
// agmm_ring_kernel on WMMA tiles, 2 = agmm_ring_tma_kernel (wgmma).
extern "C" int agmm_ring_path(int dtype, int k, int vec_ok) {
  if (dtype == 0) return 0;
  return takes_tma(dtype, k, vec_ok) ? 2 : 1;
}

// The blocks per rank a launch of p ranks gets (-1 on a CUDA error); a
// 16-bit dtype counts the wgmma kernel's.
extern "C" int agmm_ring_blocks_per_rank(int dtype, int p, int n, int m) {
  int c = 0;
  const int rc = dtype == 0 ? tile_blocks_per_rank<float>(p, n, m, &c)
                            : tma_blocks_per_rank<__nv_bfloat16>(p, n, m, &c);
  return rc == 0 ? c : -1;
}
