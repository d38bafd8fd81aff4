// Block matmul: out[b] = x[b] @ w[b] with a float32 accumulator.
//
// Replaces the TPU kernel repro/kernels/collective_matmul.py:pallas_matmul
// (_mm_kernel), the per-chunk product of the fused collective-matmul rings.
// One launch covers every stacked rank of a ring step: x [B, m, k], w
// [B, k, n] or one w [k, n] shared by the batch.
//
// Bound on an H100: the main path's ring steps are products well above
// the card's ~295 flop/byte ridge, so operations bound them: the MLP-down
// step, [8, 512, 1024] @ [8, 1024, 3072], is 25.8 GFLOP, 0.026 ms at 989
// TFLOP/s dense bf16 (0.0135 ms for its ~45 MB of operands and output at
// 3.35 TB/s); float32 runs outside the tensor cores at 67 TFLOP/s.  Short
// K is what keeps a tile from its bound: at K = 384 (attn-out, the K/V
// accumulate) a tile is 6 K steps of 64, so a CTA that pays its pipeline
// fill and its epilogue once per tile idles for a large share of it.
//
// Three kernels, chosen before the launch (block_matmul_path):
//   * bf16/fp16 with vec_ok (bm_wgmma_kernel): a persistent grid of
//     min(tiles, SMs) warp-specialized CTAs of 384 threads, one per SM, on
//     the wgmma/TMA mainloop of hopper_gemm.cuh.  CTA i takes tiles i, i +
//     grid, ... of a list ordered batch-major with the row tiles fastest,
//     so the tiles in flight share one w column strip in L2.  Its producer
//     thread issues the TMA loads of all its tiles back to back through a
//     ring of stages, never stopping at a tile boundary: the next tile's K
//     tiles land while the two consumer warpgroups still write the last
//     tile.  Each warpgroup writes its 64 rows into shared memory, from
//     where one thread stores them with TMA as a bulk group that drains
//     while the next tile multiplies (TMA_EPILOGUE), so fills, epilogues
//     and the output's stores overlap.  x and w
//     are read through 3-D tensor maps ({k, m, B} and {n, k, B}, a shared
//     w with a z extent of 1), so a ragged k is zero-filled within its own
//     batch and never reads the next batch's rows.  The tile is 128 x 256,
//     or 128 x 128 where all of those fit in one wave (tile_n), so a
//     small product still spreads over the card;
//   * other bf16/fp16 (mm_tc_kernel) and float32 (mm_f32_kernel): one
//     256-thread block per output tile on the tile loops of mm_tile.cuh
//     (WMMA for 16-bit types, full float32 FMA, no TF32).
// Ragged edges: TMA zero-fills past a map's extent and the epilogue masks
// its stores; the tile loops mask their loads and stores.
//
// Plain C interface, built with nvcc for sm_90a and loaded with ctypes.
// Each entry returns cudaGetLastError() after its launch.

#include <type_traits>

#include "hopper_gemm.cuh"
#include "mm_tile.cuh"

namespace {

using namespace mmtile;

constexpr int WGMMA_STAGES = 3;   // stages of bm_wgmma_kernel's ring
constexpr bool TMA_EPILOGUE = true;   // tile stores through smem and TMA

template <typename T>
__global__ void __launch_bounds__(THREADS)
mm_tc_kernel(const T* __restrict__ x, const T* __restrict__ w,
             T* __restrict__ out, int m, int n, int k, long long sxb,
             long long swb, int vec_ok) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const long long b = blockIdx.z;
  tc_tile<T>(smem_raw, x + b * sxb, w + b * swb, out + b * (long long)m * n,
             m, n, k, blockIdx.y * BM, blockIdx.x * BN, vec_ok);
}

template <typename T>
void launch_tc(dim3 grid, cudaStream_t s, const void* x, const void* w,
               void* out, int m, int n, int k, long long sxb, long long swb,
               int vec_ok) {
  const int bytes = tc_smem_bytes<T>();
  static bool configured = false;   // above 48 KB needs the opt-in
  if (!configured) {
    cudaFuncSetAttribute(mm_tc_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    configured = true;
  }
  mm_tc_kernel<T><<<grid, THREADS, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), m, n, k, sxb, swb, vec_ok);
}

__global__ void __launch_bounds__(THREADS)
mm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ out, int m, int n, int k, long long sxb,
              long long swb) {
  __shared__ __align__(16) unsigned char smem[F32_SMEM_BYTES];
  const long long b = blockIdx.z;
  f32_tile(smem, x + b * sxb, w + b * swb, out + b * (long long)m * n, m, n,
           k, blockIdx.y * FM, blockIdx.x * FN);
}

// -- bf16/fp16 on the wgmma/TMA mainloop -------------------------------------

// Tile t of the list: batch b, row tile t % tm, column tile t / tm within
// the batch (row tiles fastest).
struct TileAt {
  int b, row0, col0;
};

template <class G>
__device__ __forceinline__ TileAt tile_at(int t, int tm, int per_b) {
  const int r = t % per_b;
  return {t / per_b, (r % tm) * hgemm::BM, (r / tm) * G::N};
}

// The output tile's staging buffer: per consumer warpgroup, N/64 boxes of
// 64 rows x 128 bytes, 128-byte swizzled as TMA reads them.
template <class G>
constexpr int c_bytes() {
  return TMA_EPILOGUE ? 2 * (G::N / 64) * 8192 : 0;
}

// Dynamic shared memory: alignment slack, the stages, the barriers
// (padded to 1024 bytes), the staging buffer.
template <class G>
constexpr int smem_bytes() {
  return G::STAGES * G::STAGE_BYTES + 2048 + c_bytes<G>();
}

// Consumer warpgroup wg: its 64 rows of the tile into its half of the
// staging buffer, then one thread stores the boxes with TMA (clipped at
// the output's edges) as one bulk group, which drains while the
// warpgroup multiplies its next tile.  Thread (warp w, lane) holds rows
// 16w + lane/4 (+8) and, per 8-column group j, columns 8j + 2 (lane % 4)
// and +1: a 16-byte chunk j % 8 of a 128-byte row, swizzled by row % 8 =
// lane / 4, so the eight rows of a store hit eight bank groups.
template <typename T, class G>
__device__ __forceinline__ void store_tile_tma(const float (&acc)[G::ACC],
                                               unsigned char* cbuf,
                                               const CUtensorMap* tm_o,
                                               int row0, int col0, int b,
                                               int wg) {
  const int wt = threadIdx.x % 128, lane = threadIdx.x % 32;
  const int w = wt / 32, g = lane / 4, t = lane % 4;
  unsigned char* mine = cbuf + wg * (G::N / 64) * 8192;
  if (wt == 0) hopper::bulk_wait_read<0>();  // the last tile's boxes read
  hopper::named_bar_sync(1 + wg, 128);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    unsigned char* row = mine + (w * 16 + g + 8 * half) * 128 + 4 * t;
#pragma unroll
    for (int j = 0; j < G::N / 8; ++j) {
      const T pair[2] = {hgemm::to<T>(acc[4 * j + 2 * half]),
                         hgemm::to<T>(acc[4 * j + 2 * half + 1])};
      *reinterpret_cast<uint32_t*>(row + (j / 8) * 8192 +
                                   ((j % 8) ^ g) * 16) =
          *reinterpret_cast<const uint32_t*>(pair);
    }
  }
  hopper::fence_proxy_async_shared();   // generic writes -> TMA's reads
  hopper::named_bar_sync(1 + wg, 128);
  if (wt == 0) {
#pragma unroll
    for (int jb = 0; jb < G::N / 64; ++jb)
      hopper::tma_store_3d(tm_o, mine + jb * 8192, col0 + 64 * jb,
                           row0 + 64 * wg, b);
    hopper::bulk_commit();
  }
}

// Maps: tm_x over x {k, m, batch}, tm_w over w {n, k, batch or 1}, tm_o
// over out {n, m, batch} (boxes of 64 x 64).
template <typename T, class G>
__global__ void __launch_bounds__(hgemm::THREADS, 1)
    bm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_w,
                    const __grid_constant__ CUtensorMap tm_o,
                    T* __restrict__ out, int batch, int m, int n, int k,
                    int w_batched) {
  extern __shared__ unsigned char smem_raw[];
  hgemm::Smem sm = hgemm::carve<G>(smem_raw);
  unsigned char* cbuf = sm.stages + G::STAGES * G::STAGE_BYTES + 1024;
  const int tm = (m + hgemm::BM - 1) / hgemm::BM;
  const int per_b = tm * ((n + G::N - 1) / G::N);
  const int tiles = batch * per_b;
  const int nk = (k + hgemm::BK - 1) / hgemm::BK;
  if (threadIdx.x == 0) hgemm::init<G>(sm);
  __syncthreads();

  if (threadIdx.x >= hgemm::CONSUMERS) {
    hopper::reg_dealloc<hgemm::PRODUCER_REGS>();
    if (threadIdx.x == hgemm::CONSUMERS) {
      // ---- the producer: every K tile of every tile of this CTA ----------
      hopper::PipeState st;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const TileAt a = tile_at<G>(t, tm, per_b);
        hgemm::load_tile<G>(sm, st, &tm_x, a.row0, a.b, &tm_w, a.col0,
                            w_batched ? a.b : 0, nk);
      }
    }
  } else {
    // ---- the consumers: wgmma over the stages, the epilogue --------------
    hopper::reg_alloc<hgemm::CONSUMER_REGS>();
    const int wg = threadIdx.x / 128;
    hopper::PipeState st;
    float acc[G::ACC];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const TileAt a = tile_at<G>(t, tm, per_b);
      hgemm::mma_tile<T, G>(sm, st, acc, nk, wg);
      if constexpr (TMA_EPILOGUE)
        store_tile_tma<T, G>(acc, cbuf, &tm_o, a.row0, a.col0, a.b, wg);
      else
        hgemm::store_tile<T, G>(acc, out + (long long)a.b * m * n, n, m, n,
                                a.row0, a.col0, wg);
    }
    if (TMA_EPILOGUE && threadIdx.x % 128 == 0)
      hopper::bulk_wait<0>();   // the stores are done before the CTA exits
  }
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}

// The tile width of a wgmma launch: 128 only where every 128 x 128 tile
// still fits in one wave (twice the 128 x 256 tiles <= SMs), so the
// narrower tile halves the makespan; else 256, which reads 2/3 of the
// bytes per product and pays half the epilogues (at the 512-row K/V
// step, 128 tiles of 256 beat 256 tiles of 128: PERF.md section 6).
int tile_n(int batch, int m, int n, int sms) {
  const long long wide = (long long)batch * ((m + hgemm::BM - 1) / hgemm::BM)
                         * ((n + 255) / 256);
  return 2 * wide > sms ? 256 : 128;
}

template <typename T, int BN_>
int launch_wgmma_tile(cudaStream_t s, const void* x, const void* w,
                      void* out, int batch, int m, int n, int k,
                      long long sxb, int w_batched, int sms) {
  using G = hgemm::Tile<BN_, WGMMA_STAGES>;
  static bool configured = false;   // above 48 KB needs the opt-in
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        bm_wgmma_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<G>());
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const bool bf16 = std::is_same_v<T, __nv_bfloat16>;
  const uint64_t B = batch, M = m, N = n, K = k;
  const uint64_t xd[3] = {K, M, B};
  const uint64_t xs[2] = {K * 2, static_cast<uint64_t>(sxb) * 2};
  const uint32_t xbox[3] = {64, hgemm::BM, 1};
  const uint64_t wd[3] = {N, K, w_batched ? B : 1};
  const uint64_t ws[2] = {N * 2, K * N * 2};
  const uint32_t wbox[3] = {64, hgemm::BK, 1};
  const uint64_t od[3] = {N, M, B};
  const uint64_t os[2] = {N * 2, M * N * 2};
  const uint32_t obox[3] = {64, 64, 1};
  CUtensorMap tx, tw, to;
  int rc;
  if ((rc = hopper_host::encode_16bit(&tx, x, 3, xd, xs, xbox, bf16)) ||
      (rc = hopper_host::encode_16bit(&tw, w, 3, wd, ws, wbox, bf16)) ||
      (rc = hopper_host::encode_16bit(&to, out, 3, od, os, obox, bf16)))
    return rc;
  const long long tiles = (long long)batch * ((m + hgemm::BM - 1) /
                                              hgemm::BM) * ((n + BN_ - 1) /
                                                            BN_);
  const int grid = tiles < sms ? static_cast<int>(tiles) : sms;
  bm_wgmma_kernel<T, G><<<grid, hgemm::THREADS, smem_bytes<G>(), s>>>(
      tx, tw, to, static_cast<T*>(out), batch, m, n, k, w_batched);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_wgmma(cudaStream_t s, const void* x, const void* w, void* out,
                 int batch, int m, int n, int k, long long sxb, int w_batched) {
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  if (tile_n(batch, m, n, sms) == 256)
    return launch_wgmma_tile<T, 256>(s, x, w, out, batch, m, n, k, sxb,
                                     w_batched, sms);
  return launch_wgmma_tile<T, 128>(s, x, w, out, batch, m, n, k, sxb,
                                   w_batched, sms);
}

// Whether a launch takes bm_wgmma_kernel: 16-bit operands that TMA can
// address (vec_ok) and a non-empty contraction.
inline bool takes_wgmma(int dtype, int k, int vec_ok) {
  return (dtype == 1 || dtype == 2) && vec_ok && k > 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  x [batch, m, k] with
// batch stride sxb, w [batch, k, n] with batch stride swb (0 = shared),
// out [batch, m, n] contiguous.  vec_ok: k and n are multiples of 8 and
// both base pointers are 16-byte aligned.
extern "C" int block_matmul(int dtype, const void* x, const void* w,
                            void* out, int batch, int m, int n, int k,
                            long long sxb, long long swb, int vec_ok,
                            void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1 && dtype != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (takes_wgmma(dtype, k, vec_ok)) {
    const int wb = swb != 0;
    return dtype == 1 ? launch_wgmma<__nv_bfloat16>(s, x, w, out, batch, m,
                                                    n, k, sxb, wb)
                      : launch_wgmma<__half>(s, x, w, out, batch, m, n, k,
                                             sxb, wb);
  }
  if (dtype == 0) {
    dim3 grid((n + FN - 1) / FN, (m + FM - 1) / FM, batch);
    mm_f32_kernel<<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), m, n, k, sxb, swb);
  } else {
    dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
    if (dtype == 1)
      launch_tc<__nv_bfloat16>(grid, s, x, w, out, m, n, k, sxb, swb, vec_ok);
    else
      launch_tc<__half>(grid, s, x, w, out, m, n, k, sxb, swb, vec_ok);
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernel a launch takes: 0 = mm_f32_kernel (float32 FMA), 1 =
// mm_tc_kernel (WMMA tiles), 2 = bm_wgmma_kernel (wgmma/TMA, persistent).
extern "C" int block_matmul_path(int dtype, int k, int vec_ok) {
  if (dtype == 0) return 0;
  return takes_wgmma(dtype, k, vec_ok) ? 2 : 1;
}

// The tile width a wgmma launch of this shape takes on the current
// device (-1 on a CUDA error).
extern "C" int block_matmul_tile_n(int batch, int m, int n) {
  int sms = 0;
  return sm_count(&sms) == 0 ? tile_n(batch, m, n, sms) : -1;
}
