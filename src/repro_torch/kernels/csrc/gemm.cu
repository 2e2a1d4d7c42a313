// GEMM for Hopper (sm_90a): out = alpha * A @ B + beta * C0, rounded to the
// input type, with the product accumulated in float32 over K.
//
// Replaces the Pallas TPU kernel `_gemm_kernel` / `gemm` of
// src/repro/kernels/gemm.py (the pl.pallas_call at line 77). There the grid
// walks (m/bm, n/bn, k/bk) with K innermost and "arbitrary", carrying the
// f32 accumulator in a VMEM scratch from one grid step to the next, and
// zero-pads operands whose sizes the blocks do not divide.
//
// Here one thread block owns one (block_m x block_n) output tile and loops
// over K itself (blocks run in parallel and in no order, so nothing can be
// carried between them). Each step stages a (block_m x block_k) tile of A
// and a (block_k x block_n) tile of B in shared memory, in the input type;
// loads outside the matrices read zero, so a partial edge tile computes
// over its whole extent exactly like the padded TPU kernel, without any
// padded copy. Every thread holds an 8 x 8 micro-tile of float32
// accumulators in registers (rows ty + i*(bm/8), columns tx + j*(bn/8), so
// neighbouring threads read neighbouring B elements and write neighbouring
// output elements) and multiplies on the CUDA cores with fmaf: float32
// inputs are multiplied in full float32 (no TF32), bf16 inputs are widened
// to float32.
//
// block_m, block_n and block_k are runtime arguments of this one compiled
// kernel: the tuning space has 10,140 configurations, and a live recording
// must not pay an nvcc build per evaluation. A block has (bm/8)*(bn/8)
// threads, at most 512 (__launch_bounds__, which holds each thread to 128
// registers: 512 x 128 fills the SM's 65,536), and (bm+bn)*bk elements of
// dynamic shared memory, at most 227 KB (232,448 bytes). Configurations
// outside those limits are rejected by the Python wrapper before launch
// (`fits` in kernels/gemm.py); grid_order and acc_dtype stay
// cost-model-only tunables, as in the reference.
//
// What bounds it on the H100: at the hub size (4096^3 bf16) the product is
// 137.4 GFLOP, 0.139 ms at the 989 TFLOP/s bf16 tensor-core peak, against
// 134 MB of operands and output, 0.040 ms at 3.35 TB/s: the operations
// bound it. This first kernel does not use the tensor cores at all; its
// own ceiling is the 67 TFLOP/s float32 FMA rate (>= 2.05 ms), and shared
// memory traffic (two loads per FMA pair of the 8x8 micro-tile) keeps it
// below that. wgmma, TMA and a pipelined producer/consumer ring are the
// later PRs' work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileM = 8;         // micro-tile rows per thread
constexpr int kTileN = 8;         // micro-tile columns per thread
constexpr int kMaxThreads = 512;  // __launch_bounds__ below
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
            const T* __restrict__ c0, T* __restrict__ out, int m, int n,
            int k, int bm, int bn, int bk, float alpha, float beta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* as = reinterpret_cast<T*>(smem_raw);  // [bk][bm]: A tile, transposed
  T* bs = as + static_cast<size_t>(bm) * bk;  // [bk][bn]: B tile

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int sx = bn / kTileN;  // threads across the tile's columns
  const int sy = bm / kTileM;  // threads across the tile's rows
  const int tx = tid % sx;
  const int ty = tid / sx;
  const int row0 = blockIdx.y * bm;
  const int col0 = blockIdx.x * bn;
  const T zero = from_f32<T>(0.0f);

  float acc[kTileM][kTileN];
#pragma unroll
  for (int i = 0; i < kTileM; ++i)
#pragma unroll
    for (int j = 0; j < kTileN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += bk) {
    // stage A: coalesced along K in global memory, stored K-major
    for (int idx = tid; idx < bm * bk; idx += nthreads) {
      const int r = idx / bk;
      const int c = idx - r * bk;
      const int gr = row0 + r;
      const int gc = k0 + c;
      as[c * bm + r] =
          (gr < m && gc < k) ? a[static_cast<size_t>(gr) * k + gc] : zero;
    }
    // stage B: coalesced along N, stored as it is
    for (int idx = tid; idx < bk * bn; idx += nthreads) {
      const int r = idx / bn;
      const int c = idx - r * bn;
      const int gr = k0 + r;
      const int gc = col0 + c;
      bs[idx] =
          (gr < k && gc < n) ? b[static_cast<size_t>(gr) * n + gc] : zero;
    }
    __syncthreads();
    for (int kk = 0; kk < bk; ++kk) {
      float av[kTileM];
      float bv[kTileN];
#pragma unroll
      for (int i = 0; i < kTileM; ++i) av[i] = to_f32(as[kk * bm + ty + i * sy]);
#pragma unroll
      for (int j = 0; j < kTileN; ++j) bv[j] = to_f32(bs[kk * bn + tx + j * sx]);
#pragma unroll
      for (int i = 0; i < kTileM; ++i)
#pragma unroll
        for (int j = 0; j < kTileN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTileM; ++i) {
    const int r = row0 + ty + i * sy;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < kTileN; ++j) {
      const int c = col0 + tx + j * sx;
      if (c >= n) continue;
      const size_t o = static_cast<size_t>(r) * n + c;
      out[o] = from_f32<T>(alpha * acc[i][j] + beta * to_f32(c0[o]));
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* c0, void* out, int m,
           int n, int k, int bm, int bn, int bk, float alpha, float beta,
           cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((n + bn - 1) / bn, (m + bm - 1) / bm);
  const dim3 block((bm / kTileM) * (bn / kTileN));
  const size_t smem = static_cast<size_t>(bm + bn) * bk * sizeof(T);
  gemm_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c0), static_cast<T*>(out), m, n, k, bm, bn, bk,
      alpha, beta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 when it was accepted); does not synchronise.
int repro_gemm(int dtype, const void* a, const void* b, const void* c0,
               void* out, int m, int n, int k, int bm, int bn, int bk,
               float alpha, float beta, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(a, b, c0, out, m, n, k, bm, bn, bk, alpha, beta, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, c0, out, m, n, k, bm, bn, bk, alpha,
                                 beta, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The limits the Python wrapper's fit check must agree with.
void repro_gemm_limits(int* tile_m, int* tile_n, int* max_threads,
                       int* max_smem) {
  *tile_m = kTileM;
  *tile_n = kTileN;
  *max_threads = kMaxThreads;
  *max_smem = kMaxSmem;
}

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
