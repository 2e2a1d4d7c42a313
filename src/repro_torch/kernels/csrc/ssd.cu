// Mamba2 SSD chunked scan for Hopper (sm_90a), float32:
//   h_t = exp(dt_t a) h_{t-1} + dt_t b_t (x) x_t,   y_t = c_t . h_t
// for each of BH independent (batch, head) rows, computed chunk by chunk.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` / `ssd_scan` of
// src/repro/kernels/ssd.py (the pl.pallas_call at line 95). There the grid
// is (BH, chunks) with the chunk axis sequential and the (N, P) state in
// VMEM scratch; per chunk of Q steps it computes, with cum the in-chunk
// prefix sum of dt a:
//   y = ((C B^T) o exp(cum_i - cum_j)[j <= i] o dt_j) X + exp(cum) (C h)
//   h = exp(cum_Q) h + sum_j exp(cum_Q - cum_j) dt_j B_j (x) X_j.
//
// Here one thread block owns one bh row and one kSliceP-column slice of P
// (y's and h's columns are independent), keeps its (N, slice) state in
// shared memory, and walks the chunks in order as the sequential grid axis
// did, zeroing the state at chunk 0. cum is a sequential float32 prefix sum
// within the chunk, product then add, as the reference's `jnp.cumsum` of
// `dt * a`. A chunk of up to 512 steps (a 1 MB decay matrix, 256 KB of B)
// does not fit the 227 KB of shared memory of a block, so the block walks
// it in sub-tiles of kRows steps: for each output sub-tile it stages C
// (transposed), adds the inter-chunk term from the state, then, for each
// sub-tile j0 <= i0 (the ones above the diagonal are all zero), stages B
// and X, forms the kRows x kRows weights and adds their product with X.
// exp(cum_i - cum_j) is computed only for j <= i: above the diagonal its
// exponent is positive and may overflow, and inf times the mask's 0 would
// be NaN. A last pass over the chunk's sub-tiles folds B and X into the
// state.
//
// What bounds it on the H100: at mamba2-130m's width (24 heads x 8
// sequences, 4096 steps, P = 64, N = 128) the scan needs 25.8 GFLOP, each
// step's state update and readout (4 bh L N P; ssd.py `needed_flops`),
// 0.38 ms at the 67 TFLOP/s float32 rate, against 1.21 GB of x, dt, b, c
// and y (0.36 ms at 3.35 TB/s): the operations bound it. The chunked
// algorithm adds its intra-chunk Q x Q terms; in the 64-step sub-tiles on
// or below the diagonal this kernel does 54.8 GFLOP at chunk 128 and
// 112.7 GFLOP at chunk 512. This first kernel runs on the CUDA cores
// with 4 x 4 register tiles read from shared memory, one block per
// (bh, slice) with 136 KB of shared memory (one block an SM: 192 blocks
// at full width are 1.45 waves on 132 SMs); tensor cores and more blocks
// per row are later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;                 // chunk steps a sub-tile
constexpr int kSliceP = 64;               // columns of x, y, h a block owns
constexpr int kMaxN = 128;                // state size the staging holds
constexpr int kTStride = kRows + 4;       // ct[n][i], bt[n][j], wt[j][i]
constexpr int kUStride = kMaxN + 4;       // bu[j][n] in the state pass
constexpr int kFixedFloats = 2 * kMaxN * kTStride + kRows * kSliceP +
                             kRows * kTStride + kMaxN * kSliceP;
constexpr int kMaxSmem = 232448;          // dynamic shared memory a block
static_assert(kRows * kUStride <= kMaxN * kTStride, "bu fits in bt");

size_t smem_bytes(int chunk) {
  return (static_cast<size_t>(kFixedFloats) + 2 * static_cast<size_t>(chunk)) *
         sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ c, float* __restrict__ y, int l, int p,
           int n, int chunk, int n_slices) {
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;                        // [kMaxN][kTStride]
  float* bt = ct + kMaxN * kTStride;       // [kMaxN][kTStride] or bu
  float* xs = bt + kMaxN * kTStride;       // [kRows][kSliceP]
  float* wt = xs + kRows * kSliceP;        // [kRows][kTStride]
  float* hs = wt + kRows * kTStride;       // [kMaxN][kSliceP]
  float* cum = hs + kMaxN * kSliceP;       // [chunk]
  float* dts = cum + chunk;                // [chunk]

  const int row = static_cast<int>(blockIdx.x) / n_slices;
  const int p0 = (static_cast<int>(blockIdx.x) % n_slices) * kSliceP;
  const int tid = threadIdx.x;
  const int ty = tid / 16;   // y, w: rows 4 ty + {0..3}; h: n = 8 ty + {0..7}
  const int tx = tid % 16;   // y, w: cols 4 tx + {0..3}; h: p = 4 tx + {0..3}
  const float a_row = a[row];
  const float* xr = x + static_cast<size_t>(row) * l * p;
  const float* dtr = dt + static_cast<size_t>(row) * l;
  const float* br = b + static_cast<size_t>(row) * l * n;
  const float* cr = c + static_cast<size_t>(row) * l * n;
  float* yr = y + static_cast<size_t>(row) * l * p;

  for (int i = tid; i < kMaxN * kSliceP; i += kThreads) hs[i] = 0.0f;

  // stage x[t0 + j][p0 + q] for j < kRows in xs (zeros past the chunk or P)
  auto stage_x = [&](int t0, int rows) {
    for (int i = tid; i < kRows * kSliceP; i += kThreads) {
      const int j = i / kSliceP;
      const int q = i - j * kSliceP;
      xs[i] = (j < rows && p0 + q < p)
                  ? xr[static_cast<size_t>(t0 + j) * p + p0 + q]
                  : 0.0f;
    }
  };

  for (int t0 = 0; t0 < l; t0 += chunk) {
    __syncthreads();  // the last chunk's reads of cum, dts, hs are done
    for (int i = tid; i < chunk; i += kThreads) dts[i] = dtr[t0 + i];
    __syncthreads();
    if (tid == 0) {
      float s = 0.0f;
      for (int i = 0; i < chunk; ++i) {
        s = __fadd_rn(s, __fmul_rn(dts[i], a_row));
        cum[i] = s;
      }
    }
    __syncthreads();
    const float total = cum[chunk - 1];

    // ---- y for each output sub-tile i0
    for (int i0 = 0; i0 < chunk; i0 += kRows) {
      const int rows_i = min(kRows, chunk - i0);
      __syncthreads();  // the last sub-tile's reads of ct are done
      for (int i = tid; i < kRows * n; i += kThreads) {
        const int r = i / n;
        const int k = i - r * n;
        ct[k * kTStride + r] =
            r < rows_i ? cr[static_cast<size_t>(t0 + i0 + r) * n + k] : 0.0f;
      }
      __syncthreads();

      // inter-chunk term: exp(cum_i) (c_i . h_in)
      float acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[u][w] = 0.0f;
      for (int k = 0; k < n; ++k) {
        const float4 cv =
            *reinterpret_cast<const float4*>(ct + k * kTStride + 4 * ty);
        const float4 hv =
            *reinterpret_cast<const float4*>(hs + k * kSliceP + 4 * tx);
        const float cr4[4] = {cv.x, cv.y, cv.z, cv.w};
        const float hr4[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w)
            acc[u][w] = fmaf(cr4[u], hr4[w], acc[u][w]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 4 * ty + u;
        const float e = i < chunk ? expf(cum[i]) : 0.0f;
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[u][w] *= e;
      }

      // intra-chunk term over the sub-tiles on or below the diagonal
      for (int j0 = 0; j0 <= i0; j0 += kRows) {
        const int rows_j = min(kRows, chunk - j0);
        __syncthreads();  // the last sub-tile's reads of bt, xs, wt are done
        for (int i = tid; i < kRows * n; i += kThreads) {
          const int r = i / n;
          const int k = i - r * n;
          bt[k * kTStride + r] =
              r < rows_j ? br[static_cast<size_t>(t0 + j0 + r) * n + k]
                         : 0.0f;
        }
        stage_x(t0 + j0, rows_j);
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w) s[u][w] = 0.0f;
        for (int k = 0; k < n; ++k) {
          const float4 cv =
              *reinterpret_cast<const float4*>(ct + k * kTStride + 4 * ty);
          const float4 bv =
              *reinterpret_cast<const float4*>(bt + k * kTStride + 4 * tx);
          const float cr4[4] = {cv.x, cv.y, cv.z, cv.w};
          const float br4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int w = 0; w < 4; ++w)
              s[u][w] = fmaf(cr4[u], br4[w], s[u][w]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + 4 * ty + u;
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int j = j0 + 4 * tx + w;
            // exp only on or below the diagonal: never inf times 0
            const float wij = (j <= i && i < chunk)
                                  ? s[u][w] * expf(cum[i] - cum[j]) * dts[j]
                                  : 0.0f;
            wt[(4 * tx + w) * kTStride + 4 * ty + u] = wij;
          }
        }
        __syncthreads();
        for (int j = 0; j < kRows; ++j) {
          const float4 wv =
              *reinterpret_cast<const float4*>(wt + j * kTStride + 4 * ty);
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + j * kSliceP + 4 * tx);
          const float wr4[4] = {wv.x, wv.y, wv.z, wv.w};
          const float xr4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int w = 0; w < 4; ++w)
              acc[u][w] = fmaf(wr4[u], xr4[w], acc[u][w]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = 4 * ty + u;
        if (r >= rows_i) continue;
        float* dst = yr + static_cast<size_t>(t0 + i0 + r) * p + p0;
#pragma unroll
        for (int w = 0; w < 4; ++w)
          if (p0 + 4 * tx + w < p) dst[4 * tx + w] = acc[u][w];
      }
    }

    // ---- state: h = exp(total) h + sum_j exp(total - cum_j) dt_j b_j (x) x_j
    float hacc[8][4];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int w = 0; w < 4; ++w) hacc[u][w] = 0.0f;
    float* bu = bt;  // [kRows][kUStride], b scaled by its step's suffix
    for (int j0 = 0; j0 < chunk; j0 += kRows) {
      const int rows_j = min(kRows, chunk - j0);
      __syncthreads();  // the last reads of bt / bu, xs are done
      for (int i = tid; i < kRows * kMaxN; i += kThreads) {
        const int r = i / kMaxN;
        const int k = i - r * kMaxN;
        float val = 0.0f;
        if (r < rows_j && k < n) {
          const int j = j0 + r;
          val = br[static_cast<size_t>(t0 + j) * n + k] *
                (expf(total - cum[j]) * dts[j]);
        }
        bu[r * kUStride + k] = val;
      }
      stage_x(t0 + j0, rows_j);
      __syncthreads();
      for (int j = 0; j < rows_j; ++j) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(bu + j * kUStride + 8 * ty);
        const float4 b1 =
            *reinterpret_cast<const float4*>(bu + j * kUStride + 8 * ty + 4);
        const float4 xv =
            *reinterpret_cast<const float4*>(xs + j * kSliceP + 4 * tx);
        const float br8[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        const float xr4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w)
            hacc[u][w] = fmaf(br8[u], xr4[w], hacc[u][w]);
      }
    }
    // every read of hs this chunk (the inter-chunk term) is behind a
    // barrier; each thread updates only its own entries
    const float decay = expf(total);
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        float* hp = hs + (8 * ty + u) * kSliceP + 4 * tx + w;
        *hp = decay * *hp + hacc[u][w];
      }
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 when it was accepted);
// does not synchronise. Shapes are checked by the Python wrapper: x and y
// are (bh, l, p), dt (bh, l), a (bh,), b and c (bh, l, n); chunk divides
// l; n <= kMaxN.
int repro_ssd_scan(const void* x, const void* dt, const void* a,
                   const void* b, const void* c, void* y, int bh, int l,
                   int p, int n, int chunk, void* stream) {
  const size_t smem = smem_bytes(chunk);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_slices = (p + kSliceP - 1) / kSliceP;
  const unsigned grid = static_cast<unsigned>(bh) * n_slices;
  ssd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(y), l, p, n, chunk,
      n_slices);
  return static_cast<int>(cudaGetLastError());
}

// The limits the Python wrapper's fit check must agree with.
void repro_ssd_limits(int* max_n, int* fixed_floats, int* max_smem) {
  *max_n = kMaxN;
  *fixed_floats = kFixedFloats;
  *max_smem = kMaxSmem;
}

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
