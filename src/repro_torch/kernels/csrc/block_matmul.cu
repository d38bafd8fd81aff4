// Block matmul: out[b] = x[b] @ w[b] with a float32 accumulator.
//
// Replaces the TPU kernel repro/kernels/collective_matmul.py:pallas_matmul
// (_mm_kernel), the per-chunk product of the fused collective-matmul rings.
// One launch covers every stacked rank of a ring step: the grid's z
// dimension is the batch, with a batch stride per operand (0 = shared).
//
// Bound on an H100: the ring steps of the slice are large products
// (2*8*512*1024*3072 = 25.8 GFLOP per MLP-down step), well above the
// card's ~295 flop/byte ridge, so they are bound by operations: 989
// TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s for float32 outside
// them.  What the design does about it:
//   * bf16/fp16: 128x128 output tiles, 32-deep K tiles in a 3-stage
//     cp.async pipeline in shared memory (16-byte chunks where aligned,
//     so the next tiles load while this one multiplies), eight warps each
//     running 4x2 16x16x16 tensor-core products (nvcuda::wmma) into
//     float32 fragments.  It reaches the tensor cores but not wgmma or
//     TMA, so it sits below the bound; those are later work.
//   * float32: 64x64 tiles, 16-deep K, 4x4 outputs per thread, full
//     float32 FMA (no TF32).
// Ragged edges are masked in the loads and stores instead of the TPU
// kernel's zero-pad and slice.
//
// Plain C interface, built with nvcc for sm_90a and loaded with ctypes.
// Each entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int LDA = BK + 8;   // padded smem row pitch (elements)
constexpr int LDB = BN + 8;
constexpr int THREADS = 256;  // 8 warps: 2 (rows) x 4 (cols), 64x32 each

template <typename T>
__device__ __forceinline__ T from_float(float v);

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half(v);
}

constexpr int STAGES = 3;              // cp.async pipeline depth
constexpr int A_STAGE = BM * LDA;      // elements of one x stage
constexpr int B_STAGE = BK * LDB;      // elements of one w stage

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  // src_bytes < 16 zero-fills the rest: 0 gives a zero chunk
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

// Stage one [BM, BK] x tile and one [BK, BN] w tile into shared memory:
// 16-byte cp.async chunks where the operand is aligned (vec_ok), chunks
// wholly outside the matrix zero-filled; element-wise masked stores
// otherwise.
template <typename T>
__device__ __forceinline__ void load_tile(T* As, T* Bs, const T* xb,
                                          const T* wb, int m, int n, int k,
                                          int row0, int col0, int k0,
                                          int vec_ok, T zero) {
  const int tid = threadIdx.x;
  for (int c = tid; c < BM * BK / 8; c += THREADS) {
    const int r = c / (BK / 8);
    const int cc = (c % (BK / 8)) * 8;
    const int gr = row0 + r;
    const int gc = k0 + cc;
    T* dst = As + r * LDA + cc;
    if (vec_ok) {  // k % 8 == 0: a chunk is wholly in or out
      const bool in = gr < m && gc < k;
      cp_async16(dst, in ? xb + (long long)gr * k + gc : xb, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gr < m && gc + e < k) ? xb[(long long)gr * k + gc + e]
                                        : zero;
    }
  }
  for (int c = tid; c < BK * BN / 8; c += THREADS) {
    const int r = c / (BN / 8);
    const int cc = (c % (BN / 8)) * 8;
    const int gr = k0 + r;
    const int gc = col0 + cc;
    T* dst = Bs + r * LDB + cc;
    if (vec_ok) {  // n % 8 == 0
      const bool in = gr < k && gc < n;
      cp_async16(dst, in ? wb + (long long)gr * n + gc : wb, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gr < k && gc + e < n) ? wb[(long long)gr * n + gc + e]
                                        : zero;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mm_tc_kernel(const T* __restrict__ x, const T* __restrict__ w,
             T* __restrict__ out, int m, int n, int k, long long sxb,
             long long swb, int vec_ok) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + STAGES * A_STAGE;

  const long long b = blockIdx.z;
  const T* xb = x + b * sxb;
  const T* wb = w + b * swb;
  T* ob = out + b * (long long)m * n;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / 4;
  const int wn = warp % 4;
  const T zero = from_float<T>(0.f);
  const int nk = (k + BK - 1) / BK;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // prologue: STAGES-1 tiles in flight
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_tile(As + s * A_STAGE, Bs + s * B_STAGE, xb, wb, m, n, k, row0,
                col0, s * BK, vec_ok, zero);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();   // tile kt has landed
    __syncthreads();               // ... for every thread; stage kt-1 free
    const int pf = kt + STAGES - 1;
    if (pf < nk)
      load_tile(As + (pf % STAGES) * A_STAGE, Bs + (pf % STAGES) * B_STAGE,
                xb, wb, m, n, k, row0, col0, pf * BK, vec_ok, zero);
    cp_async_commit();
    const T* a = As + (kt % STAGES) * A_STAGE;
    const T* bt = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], a + (wm * 64 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], bt + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: the pipeline's shared memory, reused as one 16x16 float
  // staging tile per warp; write the in-bounds part, converted to T
  float* cs = reinterpret_cast<float*>(smem_raw) + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gr = row0 + wm * 64 + i * 16 + e / 16;
        const int gc = col0 + wn * 32 + j * 16 + e % 16;
        if (gr < m && gc < n) ob[(long long)gr * n + gc] = from_float<T>(cs[e]);
      }
      __syncwarp();
    }
  }
}

template <typename T>
void launch_tc(dim3 grid, cudaStream_t s, const void* x, const void* w,
               void* out, int m, int n, int k, long long sxb, long long swb,
               int vec_ok) {
  const int bytes = STAGES * (A_STAGE + B_STAGE) * sizeof(T);
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

constexpr int FM = 64;
constexpr int FN = 64;
constexpr int FK = 16;

__global__ void __launch_bounds__(256)
mm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ out, int m, int n, int k, long long sxb,
              long long swb) {
  __shared__ float As[FK][FM + 4];   // transposed x tile
  __shared__ float Bs[FK][FN + 4];

  const long long b = blockIdx.z;
  const float* xb = x + b * sxb;
  const float* wb = w + b * swb;
  float* ob = out + b * (long long)m * n;
  const int row0 = blockIdx.y * FM;
  const int col0 = blockIdx.x * FN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += FK) {
    for (int c = tid; c < FM * FK; c += 256) {
      const int r = c / FK;
      const int kk = c % FK;
      const int gr = row0 + r;
      const int gc = k0 + kk;
      As[kk][r] = (gr < m && gc < k) ? xb[(long long)gr * k + gc] : 0.f;
    }
    for (int c = tid; c < FK * FN; c += 256) {
      const int r = c / FN;
      const int cc = c % FN;
      const int gr = k0 + r;
      const int gc = col0 + cc;
      Bs[r][cc] = (gr < k && gc < n) ? wb[(long long)gr * n + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx * 4 + j;
      if (gr < m && gc < n) ob[(long long)gr * n + gc] = acc[i][j];
    }
  }
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
  if (dtype == 0) {
    dim3 grid((n + FN - 1) / FN, (m + FM - 1) / FM, batch);
    mm_f32_kernel<<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), m, n, k, sxb, swb);
  } else {
    dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
    if (dtype == 1) {
      launch_tc<__nv_bfloat16>(grid, s, x, w, out, m, n, k, sxb, swb, vec_ok);
    } else if (dtype == 2) {
      launch_tc<__half>(grid, s, x, w, out, m, n, k, sxb, swb, vec_ok);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
