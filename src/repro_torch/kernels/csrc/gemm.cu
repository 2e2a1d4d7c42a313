// GEMM for Hopper (sm_90a): out = alpha * A @ B + beta * C0, rounded to the
// input type, with the product accumulated in float32 over K. A is (m, k)
// and B is (k, n), both row-major.
//
// Replaces the Pallas TPU kernel `_gemm_kernel` / `gemm` of
// src/repro/kernels/gemm.py (the pl.pallas_call at line 77). There the grid
// walks (m/bm, n/bn, k/bk) with K innermost and "arbitrary", carrying the
// f32 accumulator in a VMEM scratch from one grid step to the next, and
// zero-pads operands whose sizes the blocks do not divide.
//
// What bounds it on the H100: at the hub size (4096^3 bf16) the product is
// 137.4 GFLOP, 0.139 ms at the 989 TFLOP/s bf16 tensor-core peak, against
// 134 MB of operands and output, 0.040 ms at 3.35 TB/s: the operations
// bound it, and only wgmma reaches that peak. So the bf16 path below puts
// every product on wgmma, keeps the accumulator in registers, and hides
// the operand copies behind the products with a TMA ring, so that the
// tensor cores and not the loads set the pace (PERF.md has its times).
//
// bfloat16: tensor cores fed by TMA (gemm_wgmma_kernel)
// -----------------------------------------------------
// One thread block owns one (block_m x block_n) output tile, as a grid
// step of the reference does, and loops over K itself (blocks run in
// parallel and in no order, so nothing is carried between them). Its last
// warpgroup is the producer: one thread issues TMA loads
// (cp.async.bulk.tensor.2d, completing on an mbarrier by bytes) into a
// ring of `stages` shared-memory stages, each holding a (rows x block_k)
// tile of A and a (block_k x block_n) tile of B. The first `warpgroups`
// warpgroups are consumers: each waits on a stage's *full* barrier, issues
// wgmma.mma_async m64nNk16 (f32 += bf16 x bf16) from shared-memory
// descriptors, keeps one batch of wgmma in flight, and releases the stage
// before it on its *empty* barrier, so loads of later stages overlap the
// products of earlier ones. The float32 accumulator stays in the
// consumers' registers for the whole K loop; the epilogue computes
// alpha*acc + beta*c0 in float32, rounds to bf16 and stores with bounds
// checks. Every launch decision is the Python plan's (kernels/gemm.py,
// `plan`), checked here against this file's limits (`check_plan`):
//
//   * rows: A's region in a stage has block_m rounded up to 64 rows (a
//     wgmma has 64); the TMA box loads block_m rows, and rows past block_m
//     are computed from stale shared memory and never stored (no row of a
//     product reads another row).
//   * block_n is `pieces` wgmma widths N (a multiple of 32 up to 256; this
//     file instantiates 64, 96, 128, 160, 192 and 256). The (rows/64 x
//     pieces) accumulator fragments of 64 x N are split evenly over the
//     consumer warpgroups, `frags` each: at most 256 columns (128 floats a
//     thread) a warpgroup where there are one or two consumers (two take
//     the producer's spare registers with setmaxnreg), at most 128 where
//     there are three (512 threads hold ptxas to 128 registers a thread,
//     and it cannot fit a 128-float wgmma into them).
//   * Swizzle: A is K-major, in chunks of `swizzle_a` bytes of K per row
//     (128 where block_k % 64 == 0, 64 where block_k % 32 == 0, else 32);
//     B is N-major (wgmma's transpose flag reads it as it lies), in chunks
//     of `swizzle_b` bytes of N per K row (128 where N % 64 == 0, else 64).
//     A TMA box spans one chunk and at most 256 rows, so a stage takes
//     several boxes on one barrier; the barrier expects every byte of
//     every box, the zeros TMA fills outside the matrices included.
//   * Ragged edges: TMA's zero fill outside the matrices takes the place
//     of the reference's jnp.pad. TMA needs row strides that are multiples
//     of 16 bytes, so k and n must be multiples of 8 here; the wrapper
//     pads other shapes with zeros (as the reference pads) and slices.
//   * Tensor maps are encoded on the host for each launch with
//     cuTensorMapEncodeTiled, taken through cudaGetDriverEntryPoint so the
//     library needs no -lcuda, and passed as __grid_constant__ parameters.
//   * One stage (a tiling whose stage fills most of shared memory) runs
//     without overlap: its batch of wgmma finishes before the next load.
//   * A wait on an mbarrier that lasts past kWaitTimeoutNs traps: a fault
//     of the protocol ends the launch with an error instead of hanging.
//
// Left to later PRs: persistent blocks (one tile's epilogue overlaps the
// next one's loads), clusters with TMA multicast of the shared operand,
// and a TMA store in the epilogue.
//
// float32: CUDA cores (gemm_fma_kernel)
// -------------------------------------
// wgmma has no full-float32 product (TF32 keeps about three digits, past
// tests/test_kernels.py's float32 tolerance), so float32 stays on the first
// port's kernel, chosen explicitly by dtype: a (bm/8)*(bn/8)-thread block
// stages (bm x bk) of A, transposed, and (bk x bn) of B in shared memory
// (zero outside the matrices) and each thread accumulates an 8 x 8
// micro-tile with fmaf. Its own ceiling is the 67 TFLOP/s float32 FMA rate.
//
// block_m, block_n and block_k are runtime values on both paths: the
// tuning space has 10,140 configurations, and a live recording must not
// pay an nvcc build per evaluation.

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "gemm_wgmma.cuh"

namespace {

// ------------------------------------------------------------ limits
constexpr int kTileM = 8;           // fma: micro-tile rows per thread
constexpr int kTileN = 8;           // fma: micro-tile columns per thread
constexpr int kMaxThreads = 512;    // fma: __launch_bounds__
constexpr int kMaxSmem = 232448;    // dynamic shared memory a block may use
constexpr int kMaxStages = 4;       // wgmma: ring stages
constexpr int kMaxConsumers = 3;    // wgmma: consumer warpgroups
constexpr int kMaxAccCols = 256;    // wgmma: frags * N a warpgroup holds
constexpr int kMaxAccCols3 = 128;   // ... where there are three consumers
constexpr int kSmemReserved = 1024 + 2 * kMaxStages * 8;  // align + barriers
constexpr int kMaxBox = 256;        // TMA box extent in each dimension
constexpr unsigned long long kWaitTimeoutNs = 2000000000ull;

// ================================================================ float32
__global__ void __launch_bounds__(kMaxThreads)
gemm_fma_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ c0, float* __restrict__ out, int m,
                int n, int k, int bm, int bn, int bk, float alpha,
                float beta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* as = reinterpret_cast<float*>(smem_raw);  // [bk][bm]: A, transposed
  float* bs = as + static_cast<size_t>(bm) * bk;   // [bk][bn]: B tile

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int sx = bn / kTileN;  // threads across the tile's columns
  const int sy = bm / kTileM;  // threads across the tile's rows
  const int tx = tid % sx;
  const int ty = tid / sx;
  const int row0 = blockIdx.y * bm;
  const int col0 = blockIdx.x * bn;

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
          (gr < m && gc < k) ? a[static_cast<size_t>(gr) * k + gc] : 0.0f;
    }
    // stage B: coalesced along N, stored as it is
    for (int idx = tid; idx < bk * bn; idx += nthreads) {
      const int r = idx / bn;
      const int c = idx - r * bn;
      const int gr = k0 + r;
      const int gc = col0 + c;
      bs[idx] =
          (gr < k && gc < n) ? b[static_cast<size_t>(gr) * n + gc] : 0.0f;
    }
    __syncthreads();
    for (int kk = 0; kk < bk; ++kk) {
      float av[kTileM];
      float bv[kTileN];
#pragma unroll
      for (int i = 0; i < kTileM; ++i) av[i] = as[kk * bm + ty + i * sy];
#pragma unroll
      for (int j = 0; j < kTileN; ++j) bv[j] = bs[kk * bn + tx + j * sx];
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
      out[o] = alpha * acc[i][j] + beta * c0[o];
    }
  }
}

// =============================================================== bfloat16
// The launch plan as the kernel reads it (see kernels/gemm.py, `Plan`).
struct Bf16Args {
  int m, n, k, bm, bn, bk;
  int rows;        // A rows a stage holds: bm rounded up to 64
  int stages;
  int pieces;      // wgmma widths N across block_n
  int span_a;      // K elements in one swizzled row of A (swizzle_a / 2)
  int span_b;      // N elements in one swizzled row of B (swizzle_b / 2)
  int a_box_rows;  // rows of one A box (bm split into boxes of <= 256)
  int b_box_k;     // K rows of one B box (bk split into boxes of <= 256)
  float alpha, beta;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try_wait(bar, parity)) {
    if (globaltimer() - t0 > kWaitTimeoutNs) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int inner,
                                            int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(inner), "r"(outer)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units, 14 bits each) and the swizzle mode.
__device__ __forceinline__ uint64_t desc_fields(uint32_t lbo, uint32_t sbo,
                                                int swizzle_bytes) {
  const uint64_t mode = swizzle_bytes == 128 ? 1 : swizzle_bytes == 64 ? 2 : 3;
  return (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

__device__ __forceinline__ uint64_t desc(uint64_t fields, uint32_t addr) {
  return fields | ((addr >> 4) & 0x3FFF);
}

template <int F, int R>
__device__ __forceinline__ void fence_acc(float (&acc)[F][R]) {
#pragma unroll
  for (int f = 0; f < F; ++f)
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(acc[f][i])::"memory");
}

// N: wgmma width; FRAGS: 64 x N accumulator fragments a consumer warpgroup
// holds; NWG: consumer warpgroups (the producer warpgroup is the last).
template <int N, int FRAGS, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const __nv_bfloat16* __restrict__ c0,
                  __nv_bfloat16* __restrict__ out, const Bf16Args p) {
  extern __shared__ __align__(1024) unsigned char smem_ring[];
  const uint32_t raw = smem_u32(smem_ring);
  const uint32_t smem = (raw + 1023u) & ~1023u;  // swizzle atoms need 1024
  const uint32_t stage_bytes = (p.rows + p.bn) * p.bk * 2;
  const uint32_t a_bytes = p.rows * p.bk * 2;
  const uint32_t bars = smem + p.stages * stage_bytes;
  // warp-uniform in a way the compiler can see: the roles branch on it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int kblocks = (p.k + p.bk - 1) / p.bk;
  const int row0 = blockIdx.y * p.bm;
  const int col0 = blockIdx.x * p.bn;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(bars + 8 * s, 1);                     // full: the producer
      mbar_init(bars + 8 * (kMaxStages + s), NWG);    // empty: consumers
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ------------------------------------------------------- producer
    // two consumers take the producer's spare registers
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == NWG * 128) {
      const uint32_t tx_bytes = (p.bm + p.bn) * p.bk * 2;
      const int a_chunks = p.bk / p.span_a;
      const int a_boxes = p.bm / p.a_box_rows;
      const int b_chunks = p.bn / p.span_b;
      const int b_boxes = p.bk / p.b_box_k;
      int stage = 0;
      uint32_t phase = 0;
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(bars + 8 * (kMaxStages + stage), phase ^ 1);
        const uint32_t full = bars + 8 * stage;
        mbar_expect_tx(full, tx_bytes);
        const uint32_t sa = smem + stage * stage_bytes;
        const uint32_t sb = sa + a_bytes;
        const int k0 = kb * p.bk;
        // A chunk i: `rows` rows of span_a K elements each
        for (int i = 0; i < a_chunks; ++i)
          for (int r = 0; r < a_boxes; ++r)
            tma_load_2d(sa + (i * p.rows + r * p.a_box_rows) * p.span_a * 2,
                        &map_a, full, k0 + i * p.span_a,
                        row0 + r * p.a_box_rows);
        // B chunk j: bk K rows of span_b N elements each
        for (int j = 0; j < b_chunks; ++j)
          for (int r = 0; r < b_boxes; ++r)
            tma_load_2d(sb + (j * p.bk + r * p.b_box_k) * p.span_b * 2,
                        &map_b, full, col0 + j * p.span_b,
                        k0 + r * p.b_box_k);
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    float acc[FRAGS][N / 2];
#pragma unroll
    for (int f = 0; f < FRAGS; ++f)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[f][i] = 0.0f;

    const int swz_a = p.span_a * 2;
    const int swz_b = p.span_b * 2;
    // A: K-major, 8-row groups swz_a * 8 bytes apart (LBO unused).
    // B: N-major; LBO steps from one swz_b-wide column chunk to the next
    // (bk rows apart), SBO from one group of 8 K rows to the next.
    const uint64_t fields_a = desc_fields(16, 8 * swz_a, swz_a);
    const uint64_t fields_b = desc_fields(p.bk * swz_b, 8 * swz_b, swz_b);
    uint32_t a_off[FRAGS], b_off[FRAGS];
#pragma unroll
    for (int f = 0; f < FRAGS; ++f) {
      const int frag = wg * FRAGS + f;
      a_off[f] = (frag / p.pieces) * 64 * swz_a;
      b_off[f] = (frag % p.pieces) * (N / p.span_b) * p.bk * swz_b;
    }

    int stage = 0, prev = -1;
    uint32_t phase = 0;
    const bool signals = threadIdx.x % 128 == 0;
    for (int kb = 0; kb < kblocks; ++kb) {
      mbar_wait(bars + 8 * stage, phase);
      const uint32_t sa = smem + stage * stage_bytes;
      const uint32_t sb = sa + a_bytes;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      // K steps of 16: a row of A's chunk i holds span_a K elements, one
      // step every 32 bytes; B's K rows lie swz_b bytes apart
      for (int i = 0; i < p.bk / p.span_a; ++i) {
        for (int kk = 0; kk < p.span_a; kk += 16) {
          const uint32_t a_k = sa + i * p.rows * swz_a + kk * 2;
          const uint32_t b_k = sb + (i * p.span_a + kk) * swz_b;
#pragma unroll
          for (int f = 0; f < FRAGS; ++f)
            wgmma::mma<N>(acc[f], desc(fields_a, a_k + a_off[f]),
                          desc(fields_b, b_k + b_off[f]));
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      if (p.stages == 1) {
        // one stage: its only batch must finish before the next load
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_acc(acc);
        if (signals) mbar_arrive(bars + 8 * kMaxStages);
      } else {
        // one batch stays in flight: every batch before it has finished
        // reading, so its stage goes back to the producer
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        fence_acc(acc);
        if (prev >= 0 && signals)
          mbar_arrive(bars + 8 * (kMaxStages + prev));
      }
      prev = stage;
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);

    // epilogue: out = bf16(alpha * acc + beta * c0), rows < bm only
    const int t = threadIdx.x % 128;
    const int r_in = (t / 32) * 16 + (t % 32) / 4;
    const int c_in = 2 * (t % 4);
#pragma unroll
    for (int f = 0; f < FRAGS; ++f) {
      const int frag = wg * FRAGS + f;
      const int rbase = (frag / p.pieces) * 64 + r_in;
      const int cbase = col0 + (frag % p.pieces) * N + c_in;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = rbase + 8 * h;
        const int r = row0 + rl;
        if (rl >= p.bm || r >= p.m) continue;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int c = cbase + 8 * j;
          if (c >= p.n) continue;  // n is even, so c + 1 < n as well
          const size_t o = static_cast<size_t>(r) * p.n + c;
          const float2 old = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(c0 + o));
          const float2 v = make_float2(
              p.alpha * acc[f][4 * j + 2 * h] + p.beta * old.x,
              p.alpha * acc[f][4 * j + 2 * h + 1] + p.beta * old.y);
          *reinterpret_cast<__nv_bfloat162*>(out + o) =
              __float22bfloat162_rn(v);
        }
      }
    }
  }
}

// ------------------------------------------------------------- host side
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

CUtensorMapSwizzle swizzle_mode(int bytes) {
  return bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
}

// A 2-D bf16 tensor map over a row-major (outer x inner) matrix whose boxes
// are (box_outer x box_inner), swizzled by box_inner * 2 bytes.
bool make_map(CUtensorMap* map, const void* base, int inner, int outer,
              int box_inner, int box_outer) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t unit[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle_mode(box_inner * 2),
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The plan's numbers against this file's limits; false refuses the launch.
bool check_plan(const Bf16Args& p, int wgmma_n, int warpgroups, int frags,
                int swizzle_a, int swizzle_b) {
  const auto valid_swizzle = [](int s) {
    return s == 32 || s == 64 || s == 128;
  };
  if (p.m < 1 || p.n < 1 || p.k < 1 || p.n % 8 || p.k % 8) return false;
  if (p.bm < 1 || p.bm % 8 || p.bk % 16 || p.rows != (p.bm + 63) / 64 * 64)
    return false;
  if (!valid_swizzle(swizzle_a) || !valid_swizzle(swizzle_b) ||
      p.span_a * 2 != swizzle_a || p.span_b * 2 != swizzle_b ||
      p.bk % p.span_a || wgmma_n % p.span_b)
    return false;
  if (p.pieces * wgmma_n != p.bn || warpgroups < 1 ||
      warpgroups > kMaxConsumers ||
      frags * wgmma_n > (warpgroups == 3 ? kMaxAccCols3 : kMaxAccCols) ||
      warpgroups * frags != p.rows / 64 * p.pieces)
    return false;
  if (p.a_box_rows < 1 || p.a_box_rows > kMaxBox || p.bm % p.a_box_rows ||
      p.b_box_k < 1 || p.b_box_k > kMaxBox || p.bk % p.b_box_k)
    return false;
  const long long stage = static_cast<long long>(p.rows + p.bn) * p.bk * 2;
  if (p.stages < 1 || p.stages > kMaxStages ||
      p.stages * stage + kSmemReserved > kMaxSmem)
    return false;
  return static_cast<long long>(p.bk) * swizzle_b < (1 << 18);  // LBO field
}

template <int N, int FRAGS, int NWG>
int launch_wgmma(const void* a, const void* b, const void* c0, void* out,
                 const Bf16Args& p, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_wgmma_kernel<N, FRAGS, NWG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  CUtensorMap map_a, map_b;
  if (encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  if (!make_map(&map_a, a, p.k, p.m, p.span_a, p.a_box_rows) ||
      !make_map(&map_b, b, p.n, p.k, p.span_b, p.b_box_k))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((p.n + p.bn - 1) / p.bn, (p.m + p.bm - 1) / p.bm);
  const size_t smem =
      static_cast<size_t>(p.stages) * (p.rows + p.bn) * p.bk * 2 +
      kSmemReserved;
  gemm_wgmma_kernel<N, FRAGS, NWG><<<grid, 128 * (NWG + 1), smem, stream>>>(
      map_a, map_b, static_cast<const __nv_bfloat16*>(c0),
      static_cast<__nv_bfloat16*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// float32 on the CUDA cores. Returns cudaGetLastError() after the launch
// (0 when it was accepted); does not synchronise.
int repro_gemm_f32(const void* a, const void* b, const void* c0, void* out,
                   int m, int n, int k, int bm, int bn, int bk, float alpha,
                   float beta, void* stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((n + bn - 1) / bn, (m + bm - 1) / bm);
  const dim3 block((bm / kTileM) * (bn / kTileN));
  const size_t smem = static_cast<size_t>(bm + bn) * bk * sizeof(float);
  gemm_fma_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c0), static_cast<float*>(out), m, n, k, bm,
      bn, bk, alpha, beta);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16 on the tensor cores, with the wrapper's launch plan. Returns
// cudaErrorInvalidValue for a plan outside this file's limits or a tensor
// map the driver refuses, else cudaGetLastError() after the launch.
int repro_gemm_bf16(const void* a, const void* b, const void* c0, void* out,
                    int m, int n, int k, int bm, int bn, int bk, int rows,
                    int stages, int wgmma_n, int pieces, int warpgroups,
                    int frags, int swizzle_a, int swizzle_b, float alpha,
                    float beta, void* stream) {
  Bf16Args p;
  p.m = m;
  p.n = n;
  p.k = k;
  p.bm = bm;
  p.bn = bn;
  p.bk = bk;
  p.rows = rows;
  p.stages = stages;
  p.pieces = pieces;
  p.span_a = swizzle_a / 2;
  p.span_b = swizzle_b / 2;
  p.a_box_rows = bm / ((bm + kMaxBox - 1) / kMaxBox);
  p.b_box_k = bk / ((bk + kMaxBox - 1) / kMaxBox);
  p.alpha = alpha;
  p.beta = beta;
  if (!check_plan(p, wgmma_n, warpgroups, frags, swizzle_a, swizzle_b))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_GEMM_CASE(N_, F_, W_)                   \
  if (wgmma_n == N_ && frags == F_ && warpgroups == W_) \
    return launch_wgmma<N_, F_, W_>(a, b, c0, out, p, s);
  REPRO_GEMM_CASE(64, 1, 1) REPRO_GEMM_CASE(64, 1, 2) REPRO_GEMM_CASE(64, 1, 3)
  REPRO_GEMM_CASE(64, 2, 2) REPRO_GEMM_CASE(64, 2, 3) REPRO_GEMM_CASE(64, 4, 2)
  REPRO_GEMM_CASE(96, 1, 1) REPRO_GEMM_CASE(96, 1, 2) REPRO_GEMM_CASE(96, 1, 3)
  REPRO_GEMM_CASE(96, 2, 2)
  REPRO_GEMM_CASE(128, 1, 1) REPRO_GEMM_CASE(128, 1, 2)
  REPRO_GEMM_CASE(128, 1, 3) REPRO_GEMM_CASE(128, 2, 2)
  REPRO_GEMM_CASE(160, 1, 1) REPRO_GEMM_CASE(160, 1, 2)
  REPRO_GEMM_CASE(192, 1, 1) REPRO_GEMM_CASE(192, 1, 2)
  REPRO_GEMM_CASE(256, 1, 1) REPRO_GEMM_CASE(256, 1, 2)
#undef REPRO_GEMM_CASE
  return static_cast<int>(cudaErrorInvalidValue);  // not instantiated
}

// The limits the Python wrapper's plan must agree with.
void repro_gemm_limits(int* tile_m, int* tile_n, int* max_threads,
                       int* max_smem, int* max_stages, int* max_consumers,
                       int* max_acc_cols, int* max_acc_cols3,
                       int* smem_reserved, int* max_box) {
  *tile_m = kTileM;
  *tile_n = kTileN;
  *max_threads = kMaxThreads;
  *max_smem = kMaxSmem;
  *max_stages = kMaxStages;
  *max_consumers = kMaxConsumers;
  *max_acc_cols = kMaxAccCols;
  *max_acc_cols3 = kMaxAccCols3;
  *smem_reserved = kSmemReserved;
  *max_box = kMaxBox;
}

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
