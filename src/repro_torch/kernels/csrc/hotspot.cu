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
// reference and walks it in sub-tiles of sub_h x sub_w outputs, which the
// wrapper's `plan` chooses (the whole tile where its halo'd tile fits the
// block). The last sub-tile of a row or column is moved back to end at the
// tile's edge, so it may overlap the one before it; the overlap is
// computed twice and written twice with the same values. The pyramid of
// every sub-tile stays on chip:
//
//   * Each halo'd sub-tile, (sub_h + 2t) x (sub_w + 2t) cells, is read
//     from device memory once. A block is threads_x x threads_y threads;
//     thread (x, y) owns column x of the halo'd sub-tile, rows y*R ..
//     y*R + R - 1, and keeps T and P of those R cells in registers. A warp
//     is 32 adjacent columns of one run of rows, so its loads and stores
//     are coalesced along rows. P is read less its outermost ring, which
//     no step reads. The periodic wrap is one test a column and one a row,
//     and only in sub-tiles that touch the grid's edge.
//   * Step s (1 <= s <= t_block) publishes every thread's T to one of two
//     shared-memory planes (alternating, so one barrier a step), then
//     updates the cells at least s from the halo'd sub-tile's edge: left
//     and right from the plane, up and down from the thread's own
//     registers except at the two ends of its run. The rows a warp updates
//     are the same for all its lanes, so rows outside the pyramid cost the
//     warp nothing.
//   * The last step's interior (sub_h x sub_w) goes to `out`, coalesced.
//     No global scratch: device memory sees T and P read once a sub-tile
//     and the output written once.
//
// Every operation is an explicit round-to-nearest multiply or add
// (__fmul_rn, __fadd_rn) in the order of `_stencil_once`:
// ((0.6*c + 0.1*(((up + down) + left) + right)) + 0.5*p). No FMA
// contraction, so the kernel equals `hotspot_plain` bit for bit.
//
// What bounds it on the H100: one launch must read T and P and write the
// output, 3 x 64 MB at 4096 x 4096, 0.060 ms at 3.35 TB/s; its 8 flops a
// cell a step are 2.1 GFLOP even at t_block = 16: the bytes bound it. On
// chip, a cell-step of the pyramid costs 8 float32 instructions and about
// 3 shared-memory words (one store, two loads, and two loads at the ends
// of each run of R): shared memory, 32 words a clock an SM, is the on-chip
// floor, over the pyramid's redundant area, which grows with t_block.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kMaxThreads = 512;  // threads a block
constexpr int kMaxSteps = 16;     // fused steps a launch (t_block)
constexpr int kRows = 16;         // R: the one instantiation's run length
// two planes of at most kMaxThreads * kRows floats
constexpr int kMaxSmem = 2 * kMaxThreads * kRows * 4;

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

__device__ __forceinline__ float stencil(float c, float up, float down,
                                         float left, float right, float p) {
  const float neigh = __fadd_rn(__fadd_rn(__fadd_rn(up, down), left), right);
  return __fadd_rn(__fadd_rn(__fmul_rn(0.6f, c), __fmul_rn(0.1f, neigh)),
                   __fmul_rn(0.5f, p));
}

// R: cells of one column a thread holds. Block (threads_x, threads_y);
// shared memory: two planes of threads_y * R rows of threads_x floats.
// The 2 in the launch bounds keeps two 512-thread blocks on an SM (at most
// 64 registers a thread).
template <int R>
__global__ void __launch_bounds__(kMaxThreads, 2)
hotspot_kernel(const float* __restrict__ temp,
               const float* __restrict__ power, float* __restrict__ out,
               int h, int w, int strip_h, int block_w, int t_block,
               int sub_h, int sub_w, int tiles_w) {
  extern __shared__ float planes[];
  const int pitch = blockDim.x;
  const int plane_floats = blockDim.y * R * pitch;
  const int col = threadIdx.x;       // column in the halo'd sub-tile
  const int row0 = threadIdx.y * R;  // first row of this thread's run
  const int t = t_block;
  const int hh = sub_h + 2 * t;      // rows of the halo'd sub-tile
  const int hw = sub_w + 2 * t;      // columns
  const int tile_r = (blockIdx.x / tiles_w) * strip_h;
  const int tile_c = (blockIdx.x % tiles_w) * block_w;
  const int n_sy = (strip_h + sub_h - 1) / sub_h;
  const int n_sx = (block_w + sub_w - 1) / sub_w;
  const bool in_c = col < hw;
  const bool p_c = col >= 1 && col < hw - 1;  // P's columns: no outer ring

  float tv[R];
  float pv[R];
  int parity = 0;
  for (int sy = 0; sy < n_sy; ++sy) {
    const int r0 = tile_r + min(sy * sub_h, strip_h - sub_h);  // interior
    for (int sx = 0; sx < n_sx; ++sx) {
      const int c0 = tile_c + min(sx * sub_w, block_w - sub_w);
      const bool edge = r0 < t || r0 + sub_h + t > h || c0 < t ||
                        c0 + sub_w + t > w;
      int gc = c0 - t + col;
      if (edge) gc = wrap(gc, w);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = row0 + i;
        tv[i] = 0.0f;
        pv[i] = 0.0f;
        if (in_c && row < hh) {
          int gr = r0 - t + row;
          if (edge) gr = wrap(gr, h);
          const size_t at = static_cast<size_t>(gr) * w + gc;
          tv[i] = temp[at];
          if (p_c && row >= 1 && row < hh - 1) pv[i] = power[at];
        }
      }
      for (int s = 1; s <= t; ++s) {
        float* const pl = planes + parity * plane_floats;
        parity ^= 1;
#pragma unroll
        for (int i = 0; i < R; ++i) pl[(row0 + i) * pitch + col] = tv[i];
        __syncthreads();  // the plane is whole; the other one is free
        if (col >= s && col < hw - s) {
          float prev = 0.0f;  // the run's cell above i, before this step
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const int row = row0 + i;
            const float c = tv[i];
            if (row >= s && row < hh - s) {
              const float* q = pl + row * pitch + col;
              const float up = i == 0 ? q[-pitch] : prev;
              const float down = i == R - 1 ? q[pitch] : tv[i + 1];
              tv[i] = stencil(c, up, down, q[-1], q[1], pv[i]);
            }
            prev = c;
          }
        }
      }
      if (col >= t && col < t + sub_w) {
        float* o = out + (c0 - t + col);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int row = row0 + i;
          if (row >= t && row < t + sub_h)
            o[static_cast<size_t>(r0 - t + row) * w] = tv[i];
        }
      }
    }
  }
}

template <int R>
int launch(const float* temp, const float* power, float* out, int h, int w,
           int strip_h, int block_w, int t_block, int sub_h, int sub_w,
           int tx, int ty, size_t smem, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        hotspot_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int tiles_w = w / block_w;
  const int n_tiles = (h / strip_h) * tiles_w;
  hotspot_kernel<R><<<n_tiles, dim3(tx, ty), smem, stream>>>(
      temp, power, out, h, w, strip_h, block_w, t_block, sub_h, sub_w,
      tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the plan the Python wrapper chose (hotspot.py, `plan`): the
// instantiation with `rows` (R) cells a thread, tx x ty threads, sub-tiles
// of sub_h x sub_w outputs, planes of rows of `pitch` floats, `smem_bytes`
// of shared memory. Returns cudaErrorInvalidValue, launching nothing, for
// a problem or plan outside this kernel's limits, else cudaGetLastError()
// after the launch (0 when it was accepted); does not synchronise. Dtypes
// and contiguity are checked by the wrapper.
int repro_hotspot(const void* temp, const void* power, void* out, int h,
                  int w, int strip_h, int block_w, int t_block, int rows,
                  int tx, int ty, int sub_h, int sub_w, int pitch,
                  int smem_bytes, void* stream) {
  if (h < 1 || w < 1 || strip_h < 1 || block_w < 1 || h % strip_h != 0 ||
      w % block_w != 0 || t_block < 1 || t_block > kMaxSteps ||
      t_block >= h || t_block >= w || rows != kRows || tx < 32 ||
      tx % 32 != 0 || ty < 1 || tx * ty > kMaxThreads || sub_h < 1 ||
      sub_h > strip_h || sub_w < 1 || sub_w > block_w ||
      sub_w + 2 * t_block > tx || sub_h + 2 * t_block > ty * rows ||
      pitch != tx ||
      static_cast<long long>(h / strip_h) * (w / block_w) > INT_MAX ||
      smem_bytes != 2 * ty * rows * pitch * 4 || smem_bytes > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<kRows>(static_cast<const float*>(temp),
                       static_cast<const float*>(power),
                       static_cast<float*>(out), h, w, strip_h, block_w,
                       t_block, sub_h, sub_w, tx, ty,
                       static_cast<size_t>(smem_bytes),
                       static_cast<cudaStream_t>(stream));
}

// The limits the Python wrapper's plan must agree with.
void repro_hotspot_limits(int* max_threads, int* max_steps, int* max_smem,
                          int* rows) {
  *max_threads = kMaxThreads;
  *max_steps = kMaxSteps;
  *max_smem = kMaxSmem;
  *rows = kRows;
}

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
