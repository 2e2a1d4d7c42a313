// Hotspot thermal stencil for Hopper (sm_90a): `t_block` fused time steps
// of T' = 0.6*T + 0.1*(up + down + left + right) + 0.5*P on a float32 grid
// with periodic boundaries, by ghost-zone (pyramid) temporal blocking.
//
// Replaces the Pallas TPU kernel `_hotspot_kernel` / `hotspot` of
// src/repro/kernels/hotspot.py (the pl.pallas_call at line 90; one step
// is `_stencil_once`, line 40). There the wrapper wrap-pads T and P by
// t_block and gathers one (strip_h+2t) x (block_w+2t) halo'd tile per
// output tile into device memory; each grid step holds its tile in VMEM
// and computes the shrinking pyramid, t_block steps, 1 cell a side each.
//
// Here one thread block owns one (strip_h x block_w) output tile of the
// reference. A halo'd tile of up to 1056 x 4128 floats, two planes of it,
// is far beyond the 227 KB of shared memory one block may use, so the
// pyramid's intermediate planes live in a global scratch buffer: step s
// (1 <= s <= t_block) computes the plane with margin t_block - s around
// the tile from the plane with margin t_block - s + 1, all threads of the
// block sweeping it, with one block-wide barrier between steps. Step 1
// reads T itself and the last step writes the output, so t_block = 1
// needs no scratch. Periodic boundaries are index arithmetic on T and P
// (one wrap, valid while t_block < min(h, w)), not a padded copy.
//
// The grid holds at most as many blocks as the card keeps resident
// (`repro_hotspot_slots`); each block walks the tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... and owns two scratch planes, so the scratch
// is (resident blocks) x 2 planes, not (tiles) x 2, and mostly stays in
// the 50 MB L2.
//
// Every operation is an explicit round-to-nearest multiply or add
// (__fmul_rn, __fadd_rn) in the order of `_stencil_once`:
// ((0.6*c + 0.1*(((up + down) + left) + right)) + 0.5*p). No FMA
// contraction, so the kernel equals `hotspot_plain` bit for bit.
//
// What bounds it on the H100: one launch must read T and P and write the
// output, 3 x 64 MB at 4096 x 4096, 0.060 ms at 3.35 TB/s; its 8 flops a
// cell a step are 2.1 GFLOP even at t_block = 16, 0.032 ms at 67 TFLOP/s:
// the bytes bound it. This first kernel adds the pyramid's scratch traffic
// (five reads and one write a cell a step, mostly in L2) and the wrap
// arithmetic of every read of T and P; a shared-memory pyramid for the
// tilings small enough is later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

__device__ __forceinline__ float stencil(float c, float up, float down,
                                         float left, float right, float p) {
  const float neigh = __fadd_rn(__fadd_rn(__fadd_rn(up, down), left), right);
  return __fadd_rn(__fadd_rn(__fmul_rn(0.6f, c), __fmul_rn(0.1f, neigh)),
                   __fmul_rn(0.5f, p));
}

__global__ void __launch_bounds__(kThreads)
hotspot_kernel(const float* __restrict__ temp, const float* __restrict__ power,
               float* __restrict__ out, float* __restrict__ scratch, int h,
               int w, int strip_h, int block_w, int t_block, int tiles_w,
               int n_tiles) {
  const int stride = block_w + 2 * t_block;  // row stride of a plane
  const size_t plane = static_cast<size_t>(strip_h + 2 * t_block) * stride;
  // this block's two planes: [0, plane) and [plane, 2 * plane)
  float* const mine =
      scratch == nullptr ? nullptr
                         : scratch + static_cast<size_t>(blockIdx.x) * 2 * plane;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = (tile / tiles_w) * strip_h;
    const int c0 = (tile % tiles_w) * block_w;
    for (int s = 1; s <= t_block; ++s) {
      const int m = t_block - s;  // margin of this step's plane
      const int oh = strip_h + 2 * m;
      const int ow = block_w + 2 * m;
      const float* src = s >= 2 ? mine + ((s - 2) & 1) * plane : nullptr;
      float* dst = s < t_block ? mine + ((s - 1) & 1) * plane : nullptr;
      for (int idx = threadIdx.x; idx < oh * ow; idx += kThreads) {
        const int i = idx / ow;
        const int j = idx - i * ow;
        const int gr = wrap(r0 - m + i, h);
        const int gc = wrap(c0 - m + j, w);
        float c, up, down, left, right;
        if (src == nullptr) {  // step 1 reads T, wrapped
          const size_t row = static_cast<size_t>(gr) * w;
          c = temp[row + gc];
          up = temp[static_cast<size_t>(wrap(gr - 1, h)) * w + gc];
          down = temp[static_cast<size_t>(wrap(gr + 1, h)) * w + gc];
          left = temp[row + wrap(gc - 1, w)];
          right = temp[row + wrap(gc + 1, w)];
        } else {  // the previous plane, margin m + 1: (i+1, j+1) is centre
          const float* q = src + static_cast<size_t>(i + 1) * stride + j + 1;
          c = q[0];
          up = q[-stride];
          down = q[stride];
          left = q[-1];
          right = q[1];
        }
        const float v =
            stencil(c, up, down, left, right,
                    power[static_cast<size_t>(gr) * w + gc]);
        if (dst != nullptr)
          dst[static_cast<size_t>(i) * stride + j] = v;
        else
          out[static_cast<size_t>(r0 + i) * w + c0 + j] = v;
      }
      __syncthreads();  // this plane is complete before the next step reads
    }
  }
}

}  // namespace

extern "C" {

// How many blocks of the kernel the card keeps resident at once: the grid
// the wrapper launches (at most) and the scratch slots it allocates.
int repro_hotspot_slots(int* slots) {
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hotspot_kernel,
                                                      kThreads, 0);
  *slots = sms * per_sm;
  return static_cast<int>(e);
}

// scratch: grid x 2 planes of (strip_h + 2 t_block) x (block_w + 2 t_block)
// floats, or null when t_block == 1. Returns cudaGetLastError() after the
// launch; does not synchronise. Shapes are checked by the Python wrapper.
int repro_hotspot(const void* temp, const void* power, void* out,
                  void* scratch, int h, int w, int strip_h, int block_w,
                  int t_block, int grid, void* stream) {
  const int tiles_w = w / block_w;
  const int n_tiles = (h / strip_h) * tiles_w;
  hotspot_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(temp), static_cast<const float*>(power),
      static_cast<float*>(out), static_cast<float*>(scratch), h, w, strip_h,
      block_w, t_block, tiles_w, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
