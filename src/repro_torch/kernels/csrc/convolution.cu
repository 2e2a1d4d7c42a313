// 2-D convolution for Hopper (sm_90a): the same-padded cross-correlation
// out[i, j] = sum_{dy, dx} x[i + dy - fh/2, j + dx - fw/2] * f[dy, dx],
// with zeros outside the image, in float32.
//
// Replaces the Pallas TPU kernel `_conv_kernel` / `conv2d` of
// src/repro/kernels/convolution.py (the pl.pallas_call at line 81). There
// the wrapper gathers one (strip_h+fh-1) x (block_w+fw-1) halo'd patch per
// output tile into device memory, and each grid step holds its whole patch
// in VMEM and applies the fh*fw shifted multiply-adds to it.
//
// Here one thread block owns one (strip_h x block_w) output tile of the
// reference, so the tiling still sets the grid and the halo each tile
// re-reads. A tile of up to 512 x 4096 outputs does not fit the 227 KB of
// shared memory one block may use, so the block walks its tile in
// sub-tiles of kSubH x kSubW outputs: it stages each sub-tile's halo'd
// input (at most 64 x 96 floats) and the filter (at most 33 x 33) in
// shared memory, with zeros outside the image (the reference's zero
// padding, also for tiles the image size does not divide), and each of its
// 256 threads computes kRowsPerThread outputs of one column. No patch is
// ever copied to device memory.
//
// Every tap is an explicit round-to-nearest multiply, then an add
// (__fmul_rn, __fadd_rn), in the reference's order (dy outer, dx inner):
// no FMA contraction, so the kernel equals `conv2d_plain` bit for bit.
//
// What bounds it on the H100: at the hub size (4096 x 4096 image, 17 x 17
// filter) it does 2 * 4096^2 * 289 = 9.70 GFLOP, 0.145 ms at the 67 TFLOP/s
// float32 rate, against 134 MB of image and output, 0.040 ms at 3.35 TB/s:
// the operations bound it. This first kernel reads one shared-memory word
// per multiply-add, and the shared-memory pipe (32 words a clock per SM,
// against 128 float32 lanes) keeps it at a quarter of that rate at best.
// Register blocking along the filter rows is later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kSubW = 64;                               // sub-tile columns
constexpr int kRowGroups = kThreads / kSubW;            // 4
constexpr int kRowsPerThread = 8;
constexpr int kSubH = kRowGroups * kRowsPerThread;      // 32 sub-tile rows
constexpr int kMaxFilter = 33;                          // fh, fw <= 33
constexpr int kHaloH = kSubH + kMaxFilter - 1;          // 64
constexpr int kHaloW = kSubW + kMaxFilter - 1;          // 96

__global__ void __launch_bounds__(kThreads)
conv2d_kernel(const float* __restrict__ x, const float* __restrict__ f,
              float* __restrict__ out, int h, int w, int fh, int fw,
              int strip_h, int block_w) {
  __shared__ float xs[kHaloH * kHaloW];
  __shared__ float fs[kMaxFilter * kMaxFilter];

  const int tid = threadIdx.x;
  const int tx = tid % kSubW;
  const int ty = tid / kSubW;
  const int ph = fh / 2;
  const int pw = fw / 2;
  const int tile_r0 = blockIdx.y * strip_h;
  const int tile_c0 = blockIdx.x * block_w;
  const int tile_r1 = min(tile_r0 + strip_h, h);
  const int tile_c1 = min(tile_c0 + block_w, w);

  for (int i = tid; i < fh * fw; i += kThreads) fs[i] = f[i];

  for (int r0 = tile_r0; r0 < tile_r1; r0 += kSubH) {
    const int rows = min(kSubH, tile_r1 - r0);
    for (int c0 = tile_c0; c0 < tile_c1; c0 += kSubW) {
      const int cols = min(kSubW, tile_c1 - c0);
      const int hh = rows + fh - 1;
      const int hw = cols + fw - 1;
      __syncthreads();  // the previous sub-tile's reads of xs are done
      for (int i = tid; i < hh * hw; i += kThreads) {
        const int rr = i / hw;
        const int cc = i - rr * hw;
        const int gr = r0 - ph + rr;
        const int gc = c0 - pw + cc;
        xs[rr * kHaloW + cc] = (gr >= 0 && gr < h && gc >= 0 && gc < w)
                                   ? x[static_cast<size_t>(gr) * w + gc]
                                   : 0.0f;
      }
      __syncthreads();
      const int row0 = ty * kRowsPerThread;
      if (tx >= cols || row0 >= rows) continue;
      float acc[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.0f;
      for (int dy = 0; dy < fh; ++dy) {
        const float* src = xs + (row0 + dy) * kHaloW + tx;
        for (int dx = 0; dx < fw; ++dx) {
          const float fv = fs[dy * fw + dx];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            acc[i] = __fadd_rn(acc[i], __fmul_rn(src[i * kHaloW + dx], fv));
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        if (row0 + i < rows)
          out[static_cast<size_t>(r0 + row0 + i) * w + c0 + tx] = acc[i];
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 when it was accepted);
// does not synchronise. Shapes are checked by the Python wrapper.
int repro_conv2d(const void* x, const void* f, void* out, int h, int w,
                 int fh, int fw, int strip_h, int block_w, void* stream) {
  const dim3 grid((w + block_w - 1) / block_w, (h + strip_h - 1) / strip_h);
  conv2d_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(f),
      static_cast<float*>(out), h, w, fh, fw, strip_h, block_w);
  return static_cast<int>(cudaGetLastError());
}

// The limit the Python wrapper's fit check must agree with.
void repro_conv2d_limits(int* max_filter) { *max_filter = kMaxFilter; }

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
