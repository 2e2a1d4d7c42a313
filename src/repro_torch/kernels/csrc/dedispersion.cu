// Dedispersion for Hopper (sm_90a): out[dm, t] = sum_c x[c, t + delay[c, dm]]
// over the channels in order, in float32.
//
// Replaces the Pallas TPU kernel `_dedisp_kernel` / `dedisperse` of
// src/repro/kernels/dedispersion.py (the pl.pallas_call at line 98). There
// the wrapper zero-pads time and dm to tile multiples and gathers one
// (nchan x block_t+512) time strip, with its MAX_DELAY halo, per time tile
// into device memory; each grid step holds its whole strip in VMEM and
// adds, channel after channel, one dynamic slice per dm of its tile.
//
// Here one thread block owns one (block_dm x block_t) output tile of the
// reference, so the tiling still sets the grid and how often each channel
// strip is re-read. The strip (up to 256 x 4480 floats) and the tile's
// accumulators (up to 128 x 3968) fit neither the 227 KB of shared memory
// of a block nor its registers, so the block walks its tile in sub-tiles
// of kSubT time samples x kGroupDm dms: each of its 256 threads owns one
// time sample and kGroupDm accumulators in registers. The block stages the
// group's delays once, then streams one channel's kSubT+512 samples at a
// time through a double buffer in shared memory (staging channel c+1 while
// it adds channel c, one barrier per channel), re-streaming the channels
// for every dm group of a large block_dm. Samples past the end of the
// signal read zero and outputs past (ndm, ntime-512) are not written, which
// gives the reference's padded-and-sliced result without a padded copy.
// A delay is clamped to [0, 512], as the reference's dynamic_slice clamps
// its start.
//
// Every add is an explicit round-to-nearest __fadd_rn in channel order, so
// the kernel equals `dedisperse_plain` bit for bit.
//
// What bounds it on the H100: at the hub size (256 channels, 16384
// samples, 256 dms) it does 256 x 256 x 15872 = 1.04 G adds, 0.031 ms at
// the 33.5 T float32 adds a second of the card, against 33 MB of signal,
// delays and output, 0.010 ms at 3.35 TB/s: the operations bound it. This
// first kernel reads one shared-memory word per add and waits at one
// barrier per channel; several channels per stage and time samples per
// thread are later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kSubT = kThreads;                 // time samples per sub-tile
constexpr int kGroupDm = 16;                    // dm accumulators a thread
constexpr int kMaxDelay = 512;                  // MAX_DELAY of the reference
constexpr int kSeg = kSubT + kMaxDelay;         // staged samples a channel
constexpr int kMaxSmem = 232448;                // dynamic shared memory

__global__ void __launch_bounds__(kThreads)
dedisp_kernel(const float* __restrict__ x, const int* __restrict__ delays,
              float* __restrict__ out, int nchan, int ntime, int ndm,
              int block_dm, int block_t) {
  extern __shared__ __align__(16) float smem[];
  float* seg = smem;                                    // [2][kSeg]
  int* dly = reinterpret_cast<int*>(smem + 2 * kSeg);   // [nchan][kGroupDm]

  const int tid = threadIdx.x;
  const int nt_out = ntime - kMaxDelay;
  const int dm_begin = blockIdx.y * block_dm;
  const int t_begin = blockIdx.x * block_t;
  const int dm_end = min(dm_begin + block_dm, ndm);
  const int t_end = min(t_begin + block_t, nt_out);

  for (int g0 = dm_begin; g0 < dm_end; g0 += kGroupDm) {
    const int ng = min(kGroupDm, dm_end - g0);
    __syncthreads();  // the previous group's reads of dly are done
    for (int i = tid; i < nchan * kGroupDm; i += kThreads) {
      const int c = i / kGroupDm;
      const int k = i - c * kGroupDm;
      const int d = k < ng ? delays[static_cast<size_t>(c) * ndm + g0 + k] : 0;
      dly[i] = min(max(d, 0), kMaxDelay);
    }
    for (int t0 = t_begin; t0 < t_end; t0 += kSubT) {
      __syncthreads();  // dly is written; the last sub-tile's seg reads done
      for (int i = tid; i < kSeg; i += kThreads)
        seg[i] = t0 + i < ntime ? x[t0 + i] : 0.0f;
      __syncthreads();
      float acc[kGroupDm];
#pragma unroll
      for (int k = 0; k < kGroupDm; ++k) acc[k] = 0.0f;
      for (int c = 0; c < nchan; ++c) {
        if (c + 1 < nchan) {  // stage the next channel into the other buffer
          float* next = seg + ((c + 1) & 1) * kSeg;
          const float* row = x + static_cast<size_t>(c + 1) * ntime;
          for (int i = tid; i < kSeg; i += kThreads)
            next[i] = t0 + i < ntime ? row[t0 + i] : 0.0f;
        }
        const float* cur = seg + (c & 1) * kSeg + tid;
        const int* d = dly + c * kGroupDm;
#pragma unroll
        for (int k = 0; k < kGroupDm; ++k)
          if (k < ng) acc[k] = __fadd_rn(acc[k], cur[d[k]]);
        __syncthreads();  // channel c is consumed, c + 1 is staged
      }
      const int t = t0 + tid;
      if (t < t_end) {
#pragma unroll
        for (int k = 0; k < kGroupDm; ++k)
          if (k < ng) out[static_cast<size_t>(g0 + k) * nt_out + t] = acc[k];
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 when it was accepted);
// does not synchronise. Shapes are checked by the Python wrapper.
int repro_dedisperse(const void* x, const void* delays, void* out, int nchan,
                     int ntime, int ndm, int block_dm, int block_t,
                     void* stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        dedisp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int nt_out = ntime - kMaxDelay;
  const dim3 grid((nt_out + block_t - 1) / block_t,
                  (ndm + block_dm - 1) / block_dm);
  const size_t smem = (2 * kSeg + static_cast<size_t>(nchan) * kGroupDm) * 4;
  dedisp_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(delays),
      static_cast<float*>(out), nchan, ntime, ndm, block_dm, block_t);
  return static_cast<int>(cudaGetLastError());
}

// The limits the Python wrapper's fit check must agree with.
void repro_dedisperse_limits(int* max_delay, int* group_dm, int* seg,
                             int* max_smem) {
  *max_delay = kMaxDelay;
  *group_dm = kGroupDm;
  *seg = kSeg;
  *max_smem = kMaxSmem;
}

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
