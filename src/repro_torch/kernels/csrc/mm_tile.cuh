// One output tile of x @ w with a float32 accumulator, computed by one
// 256-thread block: what TMA and wgmma cannot take.  It serves the
// float32 launches and the 16-bit ones that TMA cannot address (k or the
// output width not a multiple of 8, a base pointer not 16-byte aligned)
// of block_matmul.cu (mm_tc_kernel, mm_f32_kernel) and of agmm_ring.cu
// (agmm_ring_kernel).  Every other 16-bit launch of both runs on the
// wgmma/TMA mainloop of hopper_gemm.cuh.
//
//   * bf16/fp16 (tc_tile): a BM x BN = 128x128 output tile, 32-deep K
//     tiles in a 3-stage cp.async pipeline in shared memory (16-byte
//     chunks where aligned), eight warps each running 4x2 16x16x16
//     tensor-core products (nvcuda::wmma) into float32 fragments.
//   * float32 (f32_tile): a 64x64 output tile, 16-deep K, 4x4 outputs
//     per thread, full float32 FMA (no TF32).
//
// x is [m, k] (row stride k), w [k, n] (row stride n), the output tile
// lands in o [m, n] (row stride n).  Ragged edges are masked in the loads
// and stores.  Every load of x goes past L1 (cp.async.cg / __ldcg), so a
// tile may read rows that another SM has just written and released.
// Both functions end with a __syncthreads(), so a block may call them
// again at once for its next tile with the same shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace mmtile {

using namespace nvcuda;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int LDA = BK + 8;   // padded smem row pitch (elements)
constexpr int LDB = BN + 8;
constexpr int THREADS = 256;  // 8 warps: 2 (rows) x 4 (cols), 64x32 each
constexpr int STAGES = 3;              // cp.async pipeline depth
constexpr int A_STAGE = BM * LDA;      // elements of one x stage
constexpr int B_STAGE = BK * LDB;      // elements of one w stage

template <typename T>
constexpr int tc_smem_bytes() {
  return STAGES * (A_STAGE + B_STAGE) * static_cast<int>(sizeof(T));
}

constexpr int FM = 64;
constexpr int FN = 64;
constexpr int FK = 16;
constexpr int F32_SMEM_BYTES = FK * (FM + 4 + FN + 4) * 4;

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
// 16-byte cp.async chunks where the operands are aligned (vec_ok), chunks
// wholly outside the matrix zero-filled; element-wise masked loads
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
        dst[e] = (gr < m && gc + e < k)
                     ? __ldcg(xb + (long long)gr * k + gc + e)
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

// The output tile at (row0, col0) of x @ w, on the tensor cores.
// smem: tc_smem_bytes<T>() bytes, 128-byte aligned.
template <typename T>
__device__ __forceinline__ void tc_tile(unsigned char* smem, const T* xb,
                                        const T* wb, T* ob, int m, int n,
                                        int k, int row0, int col0,
                                        int vec_ok) {
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + STAGES * A_STAGE;
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
  float* cs = reinterpret_cast<float*>(smem) + warp * 256;
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
  __syncthreads();   // the staging tiles are free for the next call
}

// The output tile at (row0, col0) of x @ w in float32 FMA.
// smem: F32_SMEM_BYTES bytes.
__device__ __forceinline__ void f32_tile(unsigned char* smem,
                                         const float* xb, const float* wb,
                                         float* ob, int m, int n, int k,
                                         int row0, int col0) {
  float (*As)[FM + 4] = reinterpret_cast<float (*)[FM + 4]>(smem);  // x^T
  float (*Bs)[FN + 4] =
      reinterpret_cast<float (*)[FN + 4]>(smem + FK * (FM + 4) * 4);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += FK) {
    for (int c = tid; c < FM * FK; c += THREADS) {
      const int r = c / FK;
      const int kk = c % FK;
      const int gr = row0 + r;
      const int gc = k0 + kk;
      As[kk][r] = (gr < m && gc < k) ? __ldcg(xb + (long long)gr * k + gc)
                                     : 0.f;
    }
    for (int c = tid; c < FK * FN; c += THREADS) {
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

}  // namespace mmtile
