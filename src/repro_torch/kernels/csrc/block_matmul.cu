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
// kernel's zero-pad and slice.  The tile loops live in mm_tile.cuh, shared
// with agmm_ring.cu; this file is their batched grid.
//
// Plain C interface, built with nvcc for sm_90a and loaded with ctypes.
// Each entry returns cudaGetLastError() after its launch.

#include "mm_tile.cuh"

namespace {

using namespace mmtile;

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
