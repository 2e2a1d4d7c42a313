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
// strip is re-read. The block walks its tile in sub-tiles of `group` dms x
// `sub_t` samples, which the wrapper's `plan` chooses:
//
//   * Register blocking. A thread owns G dms x T samples of a sub-tile
//     (template parameters), the T samples 32 apart, so a warp's reads of a
//     staged channel are 32 consecutive words whatever the delay: no bank
//     conflict. A thread reads its G delays of a channel once (one 16-byte
//     load where G is a multiple of 4) and reuses each for T samples, so an
//     add costs 1 + 1/(G*T) shared-memory loads, not 2.
//   * Asynchronous multi-channel staging. A ring of kStages stages, each
//     holding up to `chans` channels, is filled with cp.async (16-byte
//     copies, 4-byte ones where a row or the tile start is not 16-byte
//     aligned; src-size 0 zero-fills past the signal). The copies of the
//     stage kStages-1 ahead are in flight while a stage is added, and one
//     barrier a stage, not one a channel, orders the ring. The pipeline runs
//     on across the time sub-tiles of a dm group.
//   * Staging only the span a channel needs. Per dm group the block
//     computes, for each channel, the least delay of the group's dms
//     (aligned down to 4 samples, `lo4`) and the widest span any channel
//     needs, `slot` = sub_t + max_c(hi_c - lo4_c) rounded up to 4: channel c
//     stages samples [t0 + lo4_c, t0 + lo4_c + slot), not sub_t + 512. A
//     stage then holds min(chans, stage_floats / slot) channels, so a
//     delay table of any spread, monotonic in dm or not, runs (fewer
//     channels a stage when the spread is wide).
//
// Samples past the end of the signal read zero and outputs past (ndm,
// ntime-512) are not written, which gives the reference's padded-and-sliced
// result without a padded copy. A delay is clamped to [0, 512], as the
// reference's dynamic_slice clamps its start. Every accumulator starts at
// +0.0f and adds channels 0..nchan-1 in order with __fadd_rn, so the kernel
// equals `dedisperse_plain` bit for bit.
//
// What bounds it on the H100: at the hub size (256 channels, 16384 samples,
// 256 dms) it does 256 x 256 x 15872 = 1.04 G adds, 0.031 ms at the 33.5 T
// float32 adds a second of the card, against 33 MB of signal, delays and
// output, 0.010 ms at 3.35 TB/s. But every add reads its sample from shared
// memory, which delivers 32 words a clock an SM: 132 x 32 x 1.98 GHz = 8.36
// T words/s, a floor of 0.124 ms. Going below it would take samples reused
// across dms in registers, which runtime delays only allow by dynamic
// register indexing or shuffles (each as dear as a shared-memory load):
// left open.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxDelay = 512;    // MAX_DELAY of the reference
constexpr int kStages = 4;        // stages of the cp.async ring
constexpr int kMaxThreads = 256;  // threads a block
constexpr int kMaxChans = 16;     // channels a stage
constexpr int kMaxSmem = 232448;  // dynamic shared memory of a block

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shared memory: the ring [kStages][stage_floats], then per dm group the
// clamped delays [nchan][group], each channel's aligned least delay
// [nchan] and the widest span [1]. The 1 in the launch bounds lets ptxas
// take more than 64 registers (G=8, T=4 spilled under the default cap).
template <int G, int T>
__global__ void __launch_bounds__(kMaxThreads, 1)
dedisp_kernel(const float* __restrict__ x, const int* __restrict__ delays,
              float* __restrict__ out, int nchan, int ntime, int ndm,
              int block_dm, int block_t, int warps_dm, int chans,
              int stage_floats, int vec16) {
  extern __shared__ __align__(16) float smem[];
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int warps_t = nthreads / 32 / warps_dm;
  const int group = warps_dm * G;          // dms of one pass over channels
  const int sub_t = warps_t * 32 * T;      // samples of one sub-tile
  const int k0 = (warp % warps_dm) * G;    // this thread's dms in the group
  const int t_off = (warp / warps_dm) * 32 * T + lane;  // first sample

  float* ring = smem;
  int* dly = reinterpret_cast<int*>(smem + kStages * stage_floats);
  int* lo4 = dly + nchan * group;
  int* span = lo4 + nchan;

  const int nt_out = ntime - kMaxDelay;
  const int dm_begin = blockIdx.y * block_dm;
  const int t_begin = blockIdx.x * block_t;
  const int dm_end = min(dm_begin + block_dm, ndm);
  const int t_end = min(t_begin + block_t, nt_out);
  const int n_sub = (t_end - t_begin + sub_t - 1) / sub_t;

  for (int g0 = dm_begin; g0 < dm_end; g0 += group) {
    const int ng = min(group, dm_end - g0);
    __syncthreads();  // the previous group's reads of the ring and dly done
    if (tid == 0) *span = 0;
    // the group's clamped delays, dm fastest (coalesced); a dm past the
    // tile repeats the group's first, so it widens no span
    for (int i = tid; i < nchan * group; i += nthreads) {
      const int c = i / group;
      const int k = i - c * group;
      const size_t at = static_cast<size_t>(c) * ndm + g0 + (k < ng ? k : 0);
      dly[i] = min(max(delays[at], 0), kMaxDelay);
    }
    __syncthreads();
    for (int c = tid; c < nchan; c += nthreads) {
      const int* r = dly + c * group;
      int lo = kMaxDelay, hi = 0;
      // start at dm c % group, so a warp's lanes read other banks
      for (int n = 0, k = c % group; n < group; ++n) {
        lo = min(lo, r[k]);
        hi = max(hi, r[k]);
        k = k + 1 == group ? 0 : k + 1;
      }
      lo4[c] = lo & ~3;
      atomicMax(span, hi - (lo & ~3));
    }
    __syncthreads();
    const int slot = (sub_t + *span + 3) & ~3;     // floats a staged channel
    const int cps = min(chans, stage_floats / slot);  // channels a stage
    const int fills_sub = (nchan + cps - 1) / cps;    // stages a sub-tile
    const int fills = n_sub * fills_sub;
    const int pieces = vec16 ? slot / 4 : slot;       // copies a channel
    const float inv_pieces = 1.0f / pieces;

    // queue the copies of fill f (sub-tile f / fills_sub, channels from
    // (f % fills_sub) * cps) into stage f % kStages
    auto fill = [&](int f) {
      const int sub = f / fills_sub;
      const int c0 = (f - sub * fills_sub) * cps;
      const int n = min(cps, nchan - c0);
      const int t0 = t_begin + sub * sub_t;
      float* stage = ring + (f % kStages) * stage_floats;
      for (int i = tid; i < n * pieces; i += nthreads) {
        // i / pieces, exact in float for these magnitudes (i < 2^14)
        const int cc = static_cast<int>((i + 0.5f) * inv_pieces);
        const int q = i - cc * pieces;
        const int c = c0 + cc;
        const float* row = x + static_cast<size_t>(c) * ntime;
        if (vec16) {
          const int s = t0 + lo4[c] + 4 * q;
          const int bytes = 4 * min(max(ntime - s, 0), 4);
          cp_async16(stage + cc * slot + 4 * q, bytes ? row + s : row, bytes);
        } else {
          const int s = t0 + lo4[c] + q;
          const int bytes = s < ntime ? 4 : 0;
          cp_async4(stage + cc * slot + q, bytes ? row + s : row, bytes);
        }
      }
    };

#pragma unroll
    for (int p = 0; p < kStages - 1; ++p) {
      if (p < fills) fill(p);
      cp_async_commit();
    }
    float acc[G][T];
    int sub = 0, chunk = 0;
    for (int f = 0; f < fills; ++f) {
      cp_async_wait<kStages - 2>();  // this thread's copies of fill f landed
      __syncthreads();  // everyone's have; everyone is done with fill f - 1
      if (f + kStages - 1 < fills) fill(f + kStages - 1);  // f - 1's stage
      cp_async_commit();
      if (chunk == 0) {
#pragma unroll
        for (int k = 0; k < G; ++k)
#pragma unroll
          for (int j = 0; j < T; ++j) acc[k][j] = 0.0f;
      }
      const float* stage = ring + (f % kStages) * stage_floats + t_off;
      const int c0 = chunk * cps;
      const int n = min(cps, nchan - c0);
#pragma unroll 2
      for (int cc = 0; cc < n; ++cc) {
        const int c = c0 + cc;
        const int* r = dly + c * group + k0;
        int d[G];
        if constexpr (G % 4 == 0) {
#pragma unroll
          for (int k = 0; k < G; k += 4) {
            const int4 v = *reinterpret_cast<const int4*>(r + k);
            d[k] = v.x; d[k + 1] = v.y; d[k + 2] = v.z; d[k + 3] = v.w;
          }
        } else if constexpr (G == 2) {
          const int2 v = *reinterpret_cast<const int2*>(r);
          d[0] = v.x; d[1] = v.y;
        } else {
#pragma unroll
          for (int k = 0; k < G; ++k) d[k] = r[k];
        }
        const int base = cc * slot - lo4[c];
#pragma unroll
        for (int k = 0; k < G; ++k) {
          const float* s = stage + (base + d[k]);
#pragma unroll
          for (int j = 0; j < T; ++j)
            acc[k][j] = __fadd_rn(acc[k][j], s[32 * j]);
        }
      }
      if (chunk == fills_sub - 1) {
        const int t0 = t_begin + sub * sub_t + t_off;
#pragma unroll
        for (int k = 0; k < G; ++k) {
          const int dm = g0 + k0 + k;
          if (dm < dm_end) {
#pragma unroll
            for (int j = 0; j < T; ++j)
              if (t0 + 32 * j < t_end)
                out[static_cast<size_t>(dm) * nt_out + t0 + 32 * j] =
                    acc[k][j];
          }
        }
        chunk = 0;
        ++sub;
      } else {
        ++chunk;
      }
    }
  }
}

template <int G, int T>
int launch(const float* x, const int* delays, float* out, int nchan,
           int ntime, int ndm, int block_dm, int block_t, int warps_dm,
           int warps_t, int chans, int stage_floats, size_t smem,
           int vec16, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        dedisp_kernel<G, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int nt_out = ntime - kMaxDelay;
  const dim3 grid((nt_out + block_t - 1) / block_t,
                  (ndm + block_dm - 1) / block_dm);
  dedisp_kernel<G, T><<<grid, 32 * warps_dm * warps_t, smem, stream>>>(
      x, delays, out, nchan, ntime, ndm, block_dm, block_t, warps_dm, chans,
      stage_floats, vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the plan the Python wrapper chose (dedispersion.py, `plan`):
// G dms and T samples a thread, warps_dm x warps_t warps, up to `chans`
// channels in each of kStages stages of `stage_floats` floats, `smem_bytes`
// of shared memory. Returns cudaErrorInvalidValue, launching nothing, for a
// plan outside this kernel's limits, else cudaGetLastError() after the
// launch (0 when it was accepted); does not synchronise. Shapes are
// checked by the wrapper.
int repro_dedisperse(const void* x, const void* delays, void* out, int nchan,
                     int ntime, int ndm, int block_dm, int block_t, int g,
                     int t, int warps_dm, int warps_t, int chans,
                     int stage_floats, int smem_bytes, void* stream) {
  const int threads = 32 * warps_dm * warps_t;
  const int group = warps_dm * g;
  const int sub_t = 32 * t * warps_t;
  const long long need =
      4LL * (static_cast<long long>(kStages) * stage_floats +
             static_cast<long long>(nchan) * (group + 1) + 4);
  if (warps_dm < 1 || warps_t < 1 || threads > kMaxThreads || chans < 1 ||
      chans > kMaxChans || stage_floats % 4 ||
      stage_floats < sub_t + 4 + (group > 1 ? kMaxDelay : 0) ||
      need != smem_bytes || need > kMaxSmem || block_dm < 1 ||
      block_t < 1 || (ndm + block_dm - 1) / block_dm > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec16 = ntime % 4 == 0 && block_t % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const float* xf = static_cast<const float*>(x);
  const int* d = static_cast<const int*>(delays);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
#define REPRO_DEDISP_CASE(G, T)                                              \
  if (g == G && t == T)                                                      \
    return launch<G, T>(xf, d, o, nchan, ntime, ndm, block_dm, block_t,      \
                        warps_dm, warps_t, chans, stage_floats, smem, vec16, \
                        s);
  REPRO_DEDISP_CASE(1, 2) REPRO_DEDISP_CASE(1, 4)
  REPRO_DEDISP_CASE(2, 2) REPRO_DEDISP_CASE(2, 4)
  REPRO_DEDISP_CASE(4, 2) REPRO_DEDISP_CASE(4, 4)
  REPRO_DEDISP_CASE(8, 2) REPRO_DEDISP_CASE(8, 4)
#undef REPRO_DEDISP_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The limits the Python wrapper's plan must agree with.
void repro_dedisperse_limits(int* max_delay, int* stages, int* max_threads,
                             int* max_chans, int* max_smem) {
  *max_delay = kMaxDelay;
  *stages = kStages;
  *max_threads = kMaxThreads;
  *max_chans = kMaxChans;
  *max_smem = kMaxSmem;
}

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
