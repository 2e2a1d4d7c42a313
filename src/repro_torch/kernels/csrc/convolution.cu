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
// re-reads. The block walks its tile in sub-tiles of sub_h x sub_w
// outputs, which the wrapper's `plan` chooses:
//
//   * Register blocking. A thread owns R output rows x C = 4 adjacent
//     output columns, R*C float32 accumulators in registers. For each
//     filter row dy it loads that row of the filter into registers (float4
//     broadcasts from shared memory), then for each of its R rows reads the
//     C + fw - 1 inputs of the halo row once, as float4s, and runs dx =
//     0..fw-1 over them fully unrolled. The filter width is a template
//     parameter for the widths the repository runs (3, 5, 7, 17); one more
//     instantiation reads any width up to kMaxFilter at run time, unrolled
//     to kMaxFilter under uniform guards.
//   * Halo sub-tiles staged by a cp.async ring. Each sub-tile's halo'd
//     input (sub_h + fh - 1 rows of `pitch` floats) streams into one of 2
//     or 3 ring stages: the copies of the next sub-tiles are in flight
//     while this one is computed, one barrier a stage. Rows whose global
//     start is 16-byte aligned take 16-byte copies; other rows, and the
//     16-byte pieces that straddle the image's left or right edge, take
//     4-byte copies. Pieces wholly outside the image are stored as zeros,
//     the reference's zero padding, also for tiles the image does not
//     divide. No patch is ever copied to device memory.
//
// Every tap is an explicit round-to-nearest multiply, then an add
// (__fmul_rn, __fadd_rn), in the reference's order for every output (dy
// outer, dx inner): no FMA contraction, so the kernel equals
// `conv2d_plain` bit for bit.
//
// What bounds it on the H100: at the hub size (4096 x 4096 image, 17 x 17
// filter) the function is 2 * 4096^2 * 289 = 9.70 GFLOP, 0.1447 ms at the
// 67 TFLOP/s float32 rate that counts an FMA as two operations, against
// 134 MB of image and output, 0.0401 ms at 3.35 TB/s. Without contraction
// the same work is 9.70 G float32 instructions, a floor of 0.2895 ms at 33.5
// T a second: the operations bound it. The kernel it replaces read one
// shared-memory word per multiply-add, so the shared-memory pipe (one
// wavefront a clock an SM, against 4 warp-instructions of float32) held it
// at about 2.25x that floor. Here a warp spends, per filter row, 5 float4
// wavefronts for each of its R rows (at fw 17) and a few broadcasts for the
// filter row, against 34 R clocks of float32 work: the float32 pipe sets
// the pace. Grids of fewer blocks than the card's 132 SMs (the hub's
// 512 x 4096 tiles make 8) are bound by the tiling: each block runs on one
// SM, so such a grid cannot go below (132 / blocks) times the floor.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kC = 4;             // adjacent output columns a thread holds
constexpr int kMaxFilter = 33;    // fh, fw <= 33
constexpr int kMaxStages = 3;     // stages of the cp.async ring
constexpr int kMaxThreads = 512;  // threads a block
constexpr int kMaxSmem = 232448;  // dynamic shared memory of a block

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The pitch of a staged row (the wrapper's `plan` computes the same).
__host__ __device__ inline int staged_pitch(int tx, int fw) {
  return kC * (tx - 1) + 4 * ((kC + fw - 1 + 3) / 4);
}

// FW: the filter width, or 0 for a width read at run time (up to
// kMaxFilter). R: output rows a thread holds. Shared memory: the ring
// [stages][sub_h + fh - 1][pitch], then the filter [fh][fw rounded up to
// 4], zero-padded. The 1 in the launch bounds lets ptxas take up to 128
// registers (fw 17 and 7 spilled under the default cap of 64).
template <int FW, int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
conv2d_kernel(const float* __restrict__ x, const float* __restrict__ f,
              float* __restrict__ out, int h, int w, int fh, int fw_run,
              int strip_h, int block_w, int tx_n, int ty_n, int stages,
              int pitch, int x_vec, int out_vec) {
  constexpr int kFW = FW ? FW : kMaxFilter;        // taps registers hold
  constexpr int kWin4 = (kC + kFW - 1 + 3) / 4;    // float4s of a window
  constexpr int kF4 = (kFW + 3) / 4;               // float4s of a filter row
  const int fw = FW ? FW : fw_run;
  extern __shared__ __align__(16) float smem[];
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int tx = tid % tx_n;
  const int ty = tid / tx_n;
  const int sub_w = tx_n * kC;
  const int sub_h = ty_n * R;
  const int rows_h = sub_h + fh - 1;
  const int stage_floats = rows_h * pitch;
  const int fpitch = (fw + 3) & ~3;
  const int win = kC + fw - 1;                     // floats a window uses
  float* ring = smem;
  float* fs = smem + stages * stage_floats;

  const int ph = fh / 2;
  const int pw = fw / 2;
  const int tile_r0 = blockIdx.y * strip_h;
  const int tile_c0 = blockIdx.x * block_w;
  const int tile_r1 = min(tile_r0 + strip_h, h);
  const int tile_c1 = min(tile_c0 + block_w, w);
  const int n_sub_x = (tile_c1 - tile_c0 + sub_w - 1) / sub_w;
  const int n_sub = n_sub_x * ((tile_r1 - tile_r0 + sub_h - 1) / sub_h);
  const int chunks = (sub_w + fw - 1 + 3) / 4;     // 16-byte pieces a row

  // the filter, each row zero-padded to fpitch; the first barrier of the
  // loop below orders these stores before any read
  for (int i = tid; i < fh * fpitch; i += nthreads) {
    const int r = i / fpitch;
    const int c = i - r * fpitch;
    fs[i] = c < fw ? f[r * fw + c] : 0.0f;
  }

  // queue the copies of sub-tile s into stage s % stages
  auto fill = [&](int s) {
    const int sy = s / n_sub_x;
    const int gr0 = tile_r0 + sy * sub_h - ph;
    const int gc0 = tile_c0 + (s - sy * n_sub_x) * sub_w - pw;
    float* st = ring + (s % stages) * stage_floats;
    for (int i = tid; i < rows_h * chunks; i += nthreads) {
      const int rr = i / chunks;
      const int q = i - rr * chunks;
      const int gr = gr0 + rr;
      const int gc = gc0 + 4 * q;
      float* dst = st + rr * pitch + 4 * q;
      if (gr < 0 || gr >= h || gc + 3 < 0 || gc >= w) {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        continue;
      }
      const long long at = static_cast<long long>(gr) * w + gc;
      if (x_vec && gc >= 0 && gc + 3 < w && at % 4 == 0) {
        cp_async16(dst, x + at);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (gc + k >= 0 && gc + k < w)
            cp_async4(dst + k, x + (at + k));
          else
            dst[k] = 0.0f;
        }
      }
    }
  };

  for (int p = 0; p < stages - 1; ++p) {
    if (p < n_sub) fill(p);
    cp_async_commit();
  }
  for (int s = 0; s < n_sub; ++s) {
    // this thread's copies of sub-tile s landed (the groups after it may
    // still be in flight)
    if (stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // everyone's have; everyone is done with s - 1
    if (s + stages - 1 < n_sub) fill(s + stages - 1);  // s - 1's stage
    cp_async_commit();

    const int sy = s / n_sub_x;
    const int r0 = tile_r0 + sy * sub_h + ty * R;        // first output row
    const int c0 = tile_c0 + (s - sy * n_sub_x) * sub_w + tx * kC;
    if (r0 >= tile_r1 || c0 >= tile_c1) continue;
    const float* st =
        ring + (s % stages) * stage_floats + ty * R * pitch + tx * kC;

    float acc[R][kC];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[i][c] = 0.0f;

    for (int dy = 0; dy < fh; ++dy) {
      float fr[kF4 * 4];
      const float* frow = fs + dy * fpitch;
#pragma unroll
      for (int k = 0; k < kF4; ++k) {
        if (FW || 4 * k < fw) {
          const float4 v = *reinterpret_cast<const float4*>(frow + 4 * k);
          fr[4 * k] = v.x; fr[4 * k + 1] = v.y;
          fr[4 * k + 2] = v.z; fr[4 * k + 3] = v.w;
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float* src = st + (i + dy) * pitch;
        float wv[kWin4 * 4];
#pragma unroll
        for (int k = 0; k < kWin4; ++k) {
          if (FW || 4 * k < win) {
            const float4 v = *reinterpret_cast<const float4*>(src + 4 * k);
            wv[4 * k] = v.x; wv[4 * k + 1] = v.y;
            wv[4 * k + 2] = v.z; wv[4 * k + 3] = v.w;
          }
        }
#pragma unroll
        for (int dx = 0; dx < kFW; ++dx) {
          if (FW || dx < fw) {
#pragma unroll
            for (int c = 0; c < kC; ++c)
              acc[i][c] = __fadd_rn(acc[i][c], __fmul_rn(wv[c + dx], fr[dx]));
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = r0 + i;
      if (row >= tile_r1) break;
      float* o = out + static_cast<size_t>(row) * w + c0;
      if (out_vec && c0 + kC <= tile_c1 &&
          (static_cast<size_t>(row) * w + c0) % 4 == 0) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int c = 0; c < kC; ++c)
          if (c0 + c < tile_c1) o[c] = acc[i][c];
      }
    }
  }
}

template <int FW, int R>
int launch(const float* x, const float* f, float* out, int h, int w, int fh,
           int fw, int strip_h, int block_w, int tx, int ty, int stages,
           int pitch, size_t smem, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv2d_kernel<FW, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int x_vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int out_vec = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((w + block_w - 1) / block_w, (h + strip_h - 1) / strip_h);
  conv2d_kernel<FW, R><<<grid, tx * ty, smem, stream>>>(
      x, f, out, h, w, fh, fw, strip_h, block_w, tx, ty, stages, pitch,
      x_vec, out_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the plan the Python wrapper chose (convolution.py, `plan`): the
// instantiation `filter_width` (0: the run-time width) with `rows` output
// rows a thread, tx x ty threads, `stages` ring stages of rows of `pitch`
// floats, `smem_bytes` of shared memory. Returns cudaErrorInvalidValue,
// launching nothing, for a plan outside this kernel's limits, else
// cudaGetLastError() after the launch (0 when it was accepted); does not
// synchronise. Shapes and dtypes are checked by the wrapper.
int repro_conv2d(const void* x, const void* f, void* out, int h, int w,
                 int fh, int fw, int strip_h, int block_w, int filter_width,
                 int rows, int tx, int ty, int stages, int pitch,
                 int smem_bytes, void* stream) {
  const long long need =
      4LL * (static_cast<long long>(stages) * (ty * rows + fh - 1) * pitch +
             static_cast<long long>(fh) * ((fw + 3) & ~3));
  if (h < 1 || w < 1 || fh < 1 || fh > kMaxFilter || fw < 1 ||
      fw > kMaxFilter || strip_h < 1 || block_w < 1 ||
      (h + strip_h - 1) / strip_h > 65535 ||
      (filter_width != 0 && filter_width != fw) || tx < 1 || ty < 1 ||
      tx * ty > kMaxThreads || stages < 2 || stages > kMaxStages ||
      pitch != staged_pitch(tx, fw) || need != smem_bytes ||
      need > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* ff = static_cast<const float*>(f);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(smem_bytes);
#define REPRO_CONV_CASE(FW, R)                                              \
  if (filter_width == FW && rows == R)                                      \
    return launch<FW, R>(xf, ff, o, h, w, fh, fw, strip_h, block_w, tx, ty, \
                         stages, pitch, smem, s);
  REPRO_CONV_CASE(3, 8) REPRO_CONV_CASE(5, 8) REPRO_CONV_CASE(7, 8)
  REPRO_CONV_CASE(17, 8) REPRO_CONV_CASE(0, 4)
#undef REPRO_CONV_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The limits the Python wrapper's plan must agree with.
void repro_conv2d_limits(int* max_filter, int* max_threads, int* max_stages,
                         int* max_smem, int* cols) {
  *max_filter = kMaxFilter;
  *max_threads = kMaxThreads;
  *max_stages = kMaxStages;
  *max_smem = kMaxSmem;
  *cols = kC;
}

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
