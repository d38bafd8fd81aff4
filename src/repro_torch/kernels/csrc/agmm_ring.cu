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
// Bound on an H100 at the slice's shape (p = 8 ranks, x [512, 3072] and
// w [3072, 2048] bf16 per rank): 2*8*4096*3072*2048 = 412 GFLOP, 0.42 ms
// at 989 TFLOP/s, against ~0.26 GB of operands and outputs, 0.08 ms at
// 3.35 TB/s: bound by operations.  What the design does about it:
//   * the step products use the tensor-core tile loop of mm_tile.cuh
//     (128x128 tiles, 3-stage cp.async pipeline, WMMA) and each rank's C
//     blocks share a step's tiles, so the whole card multiplies at every
//     step; the ring's copies (n*K per rank and step) are a few percent
//     of its bytes and overlap other blocks' products;
//   * it stays below the bound for the reasons block_matmul.cu does
//     (WMMA, not wgmma/TMA), plus one wait per step on the slowest block
//     of the left neighbour.
//
// Protocol (ring_schedule of the JAX package), for rank r at step s, with
// slot = s % 2, nxt = (s + 1) % 2, src = (r - s + p) % p:
//   1. 1 <= s < p-1: wait until credit[r] >= C*s (rank r+1 has finished
//      reading its slot nxt at step s-1);
//   2. s < p-1: each of rank r's C blocks copies its share of the
//      resident chunk (x[r] at s = 0, slot `slot` after) into rank r+1's
//      slot nxt, then bumps arrived[r+1] with a release;
//   3. its share of the chunk's output tiles goes to out[r] rows src*n,
//      and its share of the chunk to gathered[r] rows src*n;
//   4. s < p-1: wait until arrived[r] >= C*(s+1), with an acquire;
//   5. s < p-2: bump credit[r-1] (slot `slot` is consumed).
// The counters are monotonic and zeroed by the wrapper before each
// launch.  A block of rank r spins on counters set by ranks r-1 and r+1,
// so all p*C blocks must be resident at once: the launch is cooperative,
// and C comes from the occupancy query.  Slots are read past L1
// (cp.async.cg / __ldcg), since L1 is not coherent across SMs.  Every
// spin is bounded: on timeout a block records (kind, rank, step) in the
// error words and exits, and the other blocks give up when they see it.
//
// blocks_mode: rank `my` of p alone (grid of C blocks, no counters, no
// slots): the chunk of step s is read from x_all[src(my, s)], which is
// what the ring would have delivered.
//
// Plain C interface, built with nvcc for sm_90a and loaded with ctypes.

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
  int* flags;           // arrived[p], credit[p], error kind/rank/step
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

// Thread 0 of the block spins until *f >= target; false if it timed out
// (recorded as kind/rank/step) or another block already had.  Every
// thread of the block gets the answer.
__device__ bool block_wait(const int* f, int target, int* err, int kind,
                           int rank, int step) {
  __shared__ int ok;
  __syncthreads();   // every thread has read the previous answer
  if (threadIdx.x == 0) {
    ok = 1;
    const unsigned long long t0 = now_ns();
    while (ld_acquire(f) < target) {
      if (*(volatile int*)err != 0) { ok = 0; break; }
      if (now_ns() - t0 > WAIT_NS) {
        if (atomicCAS(err, 0, kind) == 0) {
          atomicExch(err + 1, rank);
          atomicExch(err + 2, step);
        }
        ok = 0;
        break;
      }
      __nanosleep(200);
    }
    __threadfence();
  }
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

// Blocks per rank: as many as stay resident beside the other ranks', at
// most one per output tile of a step; 0 when not even one fits.
template <typename T>
int blocks_per_rank(int ranks, int n, int m, int* out) {
  const int bytes = smem_bytes<T>();
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(agmm_ring_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                bytes)) != cudaSuccess ||
      (e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, agmm_ring_kernel<T>, THREADS, bytes)) != cudaSuccess)
    return static_cast<int>(e);
  const int resident = per_sm * sms / ranks;
  const int tiles = n > 0 && m > 0 ? tile_count<T>(n, m) : 1;
  *out = resident < tiles ? resident : tiles;
  return 0;
}

template <typename T>
int launch(Args a, cudaStream_t stream) {
  const int ranks = a.blocks_mode ? 1 : a.p;
  int rc = blocks_per_rank<T>(ranks, a.n, a.m, &a.C);
  if (rc != 0) return rc;
  if (a.C < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(agmm_ring_kernel<T>), dim3(ranks * a.C),
      dim3(THREADS), args, smem_bytes<T>(), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  x [p, n, k], w [p, k, m]
// (swb = k*m) or shared [k, m] (swb = 0), out [p, p*n, m], gath
// [p, p*n, k] or null, slots [p, 2, n, k], flags int32 [2p + 3] zeroed;
// in blocks_mode out is [p*n, m] and gath [p*n, k] for rank `my`, and
// slots and flags are unused.  vec_ok: k and m are multiples of 8 and
// every base pointer is 16-byte aligned.  Returns the launch's CUDA error.
extern "C" int agmm_ring(int dtype, const void* x, const void* w, void* out,
                         void* gath, void* slots, void* flags, int p, int n,
                         int k, int m, long long swb, int blocks_mode,
                         int my, int vec_ok, void* stream) {
  Args a{x, w, out, gath, slots, static_cast<int*>(flags), swb, p, n, k, m,
         blocks_mode, my, vec_ok, 1};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, s);
  if (dtype == 2) return launch<__half>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The blocks per rank a launch of p ranks gets (-1 on a CUDA error).
extern "C" int agmm_ring_blocks_per_rank(int dtype, int p, int n, int m) {
  int c = 0;
  const int rc = dtype == 0 ? blocks_per_rank<float>(p, n, m, &c)
                            : blocks_per_rank<__nv_bfloat16>(p, n, m, &c);
  return rc == 0 ? c : -1;
}
