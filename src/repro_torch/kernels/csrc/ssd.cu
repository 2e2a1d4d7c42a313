// Mamba2 SSD chunked scan for Hopper (sm_90a), float32:
//   h_t = exp(dt_t a) h_{t-1} + dt_t b_t (x) x_t,   y_t = c_t . h_t
// for each of BH independent (batch, head) rows, computed chunk by chunk.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` / `ssd_scan` of
// src/repro/kernels/ssd.py (lines 39 and 83). There the grid is (BH,
// chunks) with the chunk axis sequential and the (N, P) state in VMEM
// scratch; per chunk of Q steps, with cum the in-chunk prefix sum of dt a
// and total = cum_{Q-1}, it computes
//   y = ((C B^T) o exp(cum_i - cum_j)[j <= i] o dt_j) X + exp(cum) (C h)
//   h = exp(total) h + sum_j exp(total - cum_j) dt_j B_j (x) X_j.
//
// Here the same algebra runs chunk-parallel, as three kernels that one
// `ssd_scan` call launches in order on one stream:
//
//   1. ssd_chunk_states, one block a (bh, chunk): the chunk's cum, a block
//      scan of dt a (each product rounded, then added), written to a
//      (BH, L) scratch; then, for every chunk but the last (and the last
//      too when the caller asks for the final state), its state
//      S_c = sum_j exp(total_c - cum_j) dt_j B_j^T X_j, an (N, P) tile
//      written to a (BH, L/Q, N, P) scratch. The block walks the tile in
//      kSliceN x kSliceP pieces (one at mamba2-130m's N 128, P 64), so the
//      block that writes cum also reads it back, behind a barrier.
//   2. ssd_state_pass, one thread an (bh, n, p) entry: h_0 = 0, h_{c+1} =
//      exp(total_c) h_c + S_c, writing each chunk's incoming state h_c in
//      place of S_c, and, when asked, the state after the last chunk to a
//      (BH, N, P) output: the decode cache a model's prefill hands on (the
//      Pallas kernel keeps that state in VMEM scratch and returns only y).
//      Bytes-bound; 1.57 M independent entries at full width.
//   3. ssd_chunk_outputs, one block a (bh, chunk, 64-row sub-tile of the
//      chunk, 64-column slice of P), launched heaviest first (the last
//      sub-tiles of a chunk do the most work): the inter-chunk term
//      exp(cum_i) C_i h_in, then for each sub-tile j0 <= i0 of its chunk
//      the weights W = C_i B_j^T o exp(cum_i - cum_j)[j <= i] o dt_j and
//      their product with X_j. exp(cum_i - cum_j) is taken only on or below
//      the diagonal: above it the exponent is positive and may overflow,
//      and inf times the mask's 0 would be NaN. A chunk shorter than 64
//      steps has sub-tiles of its own length (rows past it are zero).
//
// What bounds it on the H100: at mamba2-130m's width (24 heads x 8
// sequences, L 4096, P 64, N 128) the scan needs 25.8 GFLOP, each step's
// state update and readout (4 bh L N P; ssd.py `needed_flops`), 0.38 ms at
// the 67 TFLOP/s float32 rate. The chunked algorithm in 64-row sub-tiles
// does 54.8 GFLOP at chunk 128 (45.1 at 64, 112.7 at 512; ssd.py
// `chunked_flops`), an algorithm floor of 0.82 ms; about 1.6 GB move (x, b,
// c read by passes 1 and 3, the states written, passed and read, y
// written), 0.48 ms at 3.35 TB/s. So the FMA pipe of the CUDA cores bounds
// passes 1 and 3 (TF32 tensor cores would break the 3e-3 tolerance), and
// the design keeps it fed:
//
//   * Register tiles. A pass-1 thread holds 8 (n) x 8 (p) of the state, 4
//     FMAs for each float it loads from shared memory; a pass-3 thread 8
//     rows x 4 columns of y and 8 rows x 4 columns of the C B^T product,
//     2.67 FMAs a loaded float. Operands are row-major in shared memory at a
//     padded pitch and read as float4: what a thread reads along k comes
//     as one float4 for 4 steps of k, and the 8 lanes of a phase read
//     distinct bank quads or one broadcast word.
//   * A cp.async ring of k-slices. The N-deep products (C_i h_in, C_i B_j^T)
//     and the 64-deep ones (W X_j, and pass 1's B^T X over a chunk) stream
//     their operand through a ring of three slots (kSlots1, kSlots3), each
//     one k-slice of kK1 or kK rows or columns (16-byte copies; 4-byte
//     copies where N or P is not a multiple of 4; src-size 0 zero-fills
//     past the data). A slice is staged two slices ahead, one barrier a
//     slice. Pass 3 keeps its 64 x N C sub-tile resident, staged once with
//     the first slice. Pass 1's first slices are copied while its scan
//     runs, and the w of a slice is loaded one slice before it is stored.
//   * 128 threads a block and about 77 KB (pass 1) or 79 KB (pass 3 at N
//     128; 112 KB at N 256) of shared memory: two blocks an SM, 8 warps.
//     Far more blocks than SMs at every chunk (6144 (bh, chunk) blocks in
//     pass 1 and 12288 in pass 3 at chunk 128), where one block a (bh,
//     64-column slice) walked the whole sequence before (1.45 waves).
//   * No chunk limit from shared memory: cum goes through device memory.
//     What remains is N <= kMaxN (the resident C sub-tile) and grids that
//     fit an int.
//
// On the card (PERF.md, scripts/probe_ssd.py) the products run at about
// 61 % of the FMA rate; halving the C loads saves 6 %, so shared memory is
// not what holds them. A fourth ring slot, 64-step slices in pass 1 and
// three blocks an SM in pass 3 do not help. About 0.6 of pass 3's 1.63 ms
// at chunk 128 lies outside its three products (0.18 of it in the mask).
//
// The wrapper (ssd.py) checks shapes, dtypes and devices, and allocates y
// and the two scratch buffers with torch.empty on the input's device.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;             // passes 1 and 3
constexpr int kPassThreads = 256;         // pass 2
constexpr int kRows = 64;                 // steps of a pass-3 sub-tile
constexpr int kSliceP = 64;               // columns of x, y, h a tile owns
constexpr int kSliceN = 128;              // state rows of a pass-1 tile
constexpr int kMaxN = 256;                // state size pass 3 keeps resident
constexpr int kK = 32;                    // depth of a pass-3 k-slice
constexpr int kK1 = 32;                   // steps of a pass-1 slice
constexpr int kSlots1 = 3;                // ring slots of pass 1
constexpr int kSlots3 = 3;                // ring slots of pass 3
constexpr int kMaxSmem = 232448;          // dynamic shared memory of a block
// pass 1 slot: kK steps of B (kSliceN + 4 pitch), of X (kSliceP + 4), w
constexpr int kBPitch1 = kSliceN + 4;
constexpr int kXPitch = kSliceP + 4;
constexpr int kSlot1 = kK1 * kBPitch1 + kK1 * kXPitch + kK1;
constexpr int kSmem1 = (kSlots1 * kSlot1 + kThreads / 32 + 1) * 4;
// pass 3 slot: kK rows of h or X ([kK][kXPitch]) or 64 rows of a B slice
// ([kRows][kK + 4]); then Wt [kRows][kXPitch] and C [kRows][np + 4]
constexpr int kBPitch3 = kK + 4;
constexpr int kSlot3 = kRows * kBPitch3 > kK * kXPitch ? kRows * kBPitch3
                                                        : kK * kXPitch;
static_assert(kSlot1 % 4 == 0 && kSlot3 % 4 == 0, "16-byte slots");
static_assert(kRows % kK == 0, "a sub-tile of X is whole slices");

__host__ __device__ constexpr int padded_n(int n) {
  return (n + kK - 1) / kK * kK;
}

__host__ __device__ constexpr int smem3_floats(int n) {
  return kSlots3 * kSlot3 + kRows * kXPitch + kRows * (padded_n(n) + 4);
}
static_assert(smem3_floats(kMaxN) * 4 <= kMaxSmem, "pass 3 fits a block");
static_assert(kSlots1 >= 2 && kSlots3 >= 2, "a ring stages ahead");
static_assert(kSmem1 <= kMaxSmem, "pass 1 fits a block");

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

// Waits until at most N of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Stages a rows x cols block (cols a multiple of 4) of a row-major matrix
// into dst at `pitch` floats: element (r, q) comes from base[off + r * ld +
// q] when r < nr and q < nq, else it is zero (src-size 0 reads nothing; the
// copy is pointed at `base`). 16-byte copies when `vec` (ld, the block's
// first column and nq multiples of 4, base 16-byte aligned), else 4-byte.
__device__ __forceinline__ void stage(float* dst, int pitch, const float* base,
                                      size_t off, size_t ld, int rows,
                                      int cols, int nr, int nq, bool vec) {
  if (vec) {
    const int c4 = cols / 4;
    for (int idx = threadIdx.x; idx < rows * c4; idx += kThreads) {
      const int r = idx / c4;
      const int q = 4 * (idx - r * c4);
      const bool ok = r < nr && q < nq;
      cp_async16(dst + r * pitch + q, ok ? base + off + r * ld + q : base,
                 ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
      const int r = idx / cols;
      const int q = idx - r * cols;
      const bool ok = r < nr && q < nq;
      cp_async4(dst + r * pitch + q, ok ? base + off + r * ld + q : base,
                ok ? 4 : 0);
    }
  }
}

// ------------------------------------------------------------------ pass 1
// One block a (bh row, chunk). Thread (ty, tx) = (tid / 8, tid % 8) holds
// state rows n0 + 4 ty + {0..3} and + 64, columns p0 + 4 tx + {0..3} and
// + 32 of each kSliceN x kSliceP tile.
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_states(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const float* __restrict__ b,
                 float* cum, float* __restrict__ states, int l, int p, int n,
                 int chunk, int vec_n, int vec_p, int with_last) {
  extern __shared__ __align__(16) float smem[];
  float* wsum = smem + kSlots1 * kSlot1;  // [kThreads / 32] warp totals
  float* total_at = wsum + kThreads / 32;  // the chunk's last cum
  const int nc = l / chunk;
  const int row = static_cast<int>(blockIdx.x) / nc;
  const int ci = static_cast<int>(blockIdx.x) % nc;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const size_t t0 = static_cast<size_t>(row) * l +
                    static_cast<size_t>(ci) * chunk;  // first step, flat
  const float a_row = a[row];
  // no chunk reads the last chunk's state; the final state does
  const bool no_state = ci == nc - 1 && !with_last;

  const int ty = tid / 8;
  const int tx = tid % 8;
  const int tiles_n = (n + kSliceN - 1) / kSliceN;
  const int tiles_p = (p + kSliceP - 1) / kSliceP;
  const int slices = (chunk + kK1 - 1) / kK1;
  const int n_stages = tiles_n * tiles_p * slices;
  float* st = states + (static_cast<size_t>(row) * nc + ci) * n * p;

  // stage u: slice u % slices of tile u / slices (n-tile major); B and X
  // by cp.async, then w = exp(total - cum_j) dt_j of its steps, whose cum
  // and dt lanes tid < kK1 load one slice before they store w
  auto copy_slice = [&](int u) {
    if (u < n_stages) {
      float* slot = smem + u % kSlots1 * kSlot1;
      const int tile = u / slices;
      const int n0 = tile / tiles_p * kSliceN;
      const int p0 = tile % tiles_p * kSliceP;
      const int j0 = u % slices * kK1;
      const int nr = min(kK1, chunk - j0);
      stage(slot, kBPitch1, b, (t0 + j0) * n + n0, n, kK1, kSliceN, nr,
            n - n0, vec_n);
      stage(slot + kK1 * kBPitch1, kXPitch, x, (t0 + j0) * p + p0, p, kK1,
            kSliceP, nr, p - p0, vec_p);
    }
    cp_async_commit();
  };
  float total = 0.0f, w_cum = 0.0f, w_dt = 0.0f;
  auto load_w = [&](int u) {
    const int j = u % slices * kK1 + tid;
    const bool in = u < n_stages && j < chunk;
    w_cum = in ? cum[t0 + j] : total;  // exp(0) x 0 past the chunk
    w_dt = in ? dt[t0 + j] : 0.0f;
  };
  auto store_w = [&](int u) {
    if (u < n_stages)
      smem[u % kSlots1 * kSlot1 + kK1 * (kBPitch1 + kXPitch) + tid] =
          expf(total - w_cum) * w_dt;
  };

  if (!no_state)  // the first slices' copies fly while cum is scanned
    for (int u = 0; u < kSlots1 - 1; ++u) copy_slice(u);
  // cum: pieces of kThreads steps, each an inclusive warp scan, the warp
  // totals before it and the carry of the earlier pieces; every thread
  // computes the same carry in the same order
  float carry = 0.0f;
  for (int base = 0; base < chunk; base += kThreads) {
    const int i = base + tid;
    float v = i < chunk ? __fmul_rn(dt[t0 + i], a_row) : 0.0f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v = __fadd_rn(v, u);
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    float before = carry;
    for (int w = 0; w < warp; ++w) before = __fadd_rn(before, wsum[w]);
    if (i < chunk) cum[t0 + i] = __fadd_rn(before, v);
    if (i == chunk - 1) *total_at = __fadd_rn(before, v);
    for (int w = 0; w < kThreads / 32; ++w) carry = __fadd_rn(carry, wsum[w]);
    __syncthreads();  // wsum is rewritten by the next piece
  }
  if (no_state) return;
  total = *total_at;  // and cum in device memory: behind the barrier
  if (tid < kK1)
    for (int u = 0; u < kSlots1 - 1; ++u) {
      load_w(u);
      store_w(u);
    }

  float acc[8][8];
  for (int u = 0; u < n_stages; ++u) {
    // w of slice u + kSlots1 - 2, loaded in iteration u - 1
    if (u > 0 && tid < kK1) store_w(u + kSlots1 - 2);
    cp_async_wait<kSlots1 - 2>();  // this thread's copies of slice u landed
    __syncthreads();  // everyone's (and the w); slot (u - 1) % kSlots1 is free
    copy_slice(u + kSlots1 - 1);
    if (tid < kK1) load_w(u + kSlots1 - 1);
    const float* bs = smem + u % kSlots1 * kSlot1;
    const float* xs = bs + kK1 * kBPitch1;
    const float* ws = xs + kK1 * kXPitch;
    if (u % slices == 0) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = 0.0f;
    }
#pragma unroll 4
    for (int j = 0; j < kK1; ++j) {
      const float w = ws[j];
      const float4 b0 =
          *reinterpret_cast<const float4*>(bs + j * kBPitch1 + 4 * ty);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + j * kBPitch1 + 64 + 4 * ty);
      const float4 x0 =
          *reinterpret_cast<const float4*>(xs + j * kXPitch + 4 * tx);
      const float4 x1 =
          *reinterpret_cast<const float4*>(xs + j * kXPitch + 32 + 4 * tx);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      const float xv[8] = {x0.x * w, x0.y * w, x0.z * w, x0.w * w,
                           x1.x * w, x1.y * w, x1.z * w, x1.w * w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(bv[r], xv[q], acc[r][q]);
    }
    if (u % slices == slices - 1) {
      const int tile = u / slices;
      const int n0 = tile / tiles_p * kSliceN;
      const int p0 = tile % tiles_p * kSliceP;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int nn = n0 + 4 * ty + r % 4 + 64 * (r / 4);
        if (nn >= n) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pp = p0 + 4 * tx + 32 * h;
          float* dst = st + static_cast<size_t>(nn) * p + pp;
          if (vec_p && pp < p) {
            *reinterpret_cast<float4*>(dst) =
                make_float4(acc[r][4 * h], acc[r][4 * h + 1],
                            acc[r][4 * h + 2], acc[r][4 * h + 3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (pp + e < p) dst[e] = acc[r][4 * h + e];
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------------ pass 2
// One thread V (bh, n, p) entries (V = 4 where N P is a multiple of 4, as
// one float4): walks the chunks in order, eight loads ahead, writing each
// chunk's incoming state over its S_c. Without `h_final` the last chunk's
// S_c was not computed and is not read; with it, the state after the last
// chunk goes to h_final[bh][n][p].
template <int V>
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass(const float* __restrict__ cum, float* __restrict__ states,
               float* __restrict__ h_final, int bh, int l, int chunk, int np) {
  static_assert(V == 1 || V == 4, "a float or a float4");
  const size_t e =
      (static_cast<size_t>(blockIdx.x) * kPassThreads + threadIdx.x) * V;
  if (e >= static_cast<size_t>(bh) * np) return;
  const int nc = l / chunk;
  const int row = static_cast<int>(e / np);
  float* s = states + static_cast<size_t>(row) * nc * np + e % np;
  const float* last = cum + static_cast<size_t>(row) * l + chunk - 1;
  const int n_read = h_final ? nc : nc - 1;  // chunks whose S_c was computed
  float h[V] = {};
  for (int c0 = 0; c0 < nc; c0 += 8) {
    float sv[8][V], decay[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c0 + u;
      const float* src = s + static_cast<size_t>(c) * np;
      if constexpr (V == 4) {
        const float4 v = c < n_read ? *reinterpret_cast<const float4*>(src)
                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        sv[u][0] = v.x;
        sv[u][1] = v.y;
        sv[u][2] = v.z;
        sv[u][3] = v.w;
      } else {
        sv[u][0] = c < n_read ? *src : 0.0f;
      }
      decay[u] = c < nc ? expf(last[static_cast<size_t>(c) * chunk]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c0 + u;
      if (c >= nc) continue;
      float* dst = s + static_cast<size_t>(c) * np;
      if constexpr (V == 4)
        *reinterpret_cast<float4*>(dst) = make_float4(h[0], h[1], h[2], h[3]);
      else
        *dst = h[0];
#pragma unroll
      for (int v = 0; v < V; ++v) h[v] = fmaf(decay[u], h[v], sv[u][v]);
    }
  }
  if (h_final) {
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(h_final + e) =
          make_float4(h[0], h[1], h[2], h[3]);
    else
      h_final[e] = h[0];
  }
}

// ------------------------------------------------------------------ pass 3
// One block a (bh row, chunk, sub-tile of kRows steps, kSliceP columns).
// Thread (ty, tx) = (tid / 16, tid % 16) holds rows i0 + 8 ty + {0..7} of
// y at columns 4 tx + {0..3}, and of C B^T at columns tx + 16 w (w < 4).
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_outputs(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ b, const float* __restrict__ c,
                  const float* __restrict__ cum,
                  const float* __restrict__ states, float* __restrict__ y,
                  int bh, int l, int p, int n, int chunk, int vec_n,
                  int vec_p) {
  extern __shared__ __align__(16) float smem[];
  const int nc = l / chunk;
  const int subs = (chunk + kRows - 1) / kRows;
  const int tiles_p = (p + kSliceP - 1) / kSliceP;
  const int per_sub = nc * bh * tiles_p;
  const int sub = subs - 1 - static_cast<int>(blockIdx.x) / per_sub;
  const int rest = static_cast<int>(blockIdx.x) % per_sub;
  const int ci = rest / (bh * tiles_p);
  const int row = rest / tiles_p % bh;
  const int p0 = rest % tiles_p * kSliceP;
  const int i0 = sub * kRows;
  const int np_ = padded_n(n);
  const int cp = np_ + 4;             // C pitch
  const int nk = np_ / kK;            // k-slices of an N-deep product
  const int n_h = ci > 0 ? nk : 0;    // stages of the inter-chunk term
  const int per_j = nk + kRows / kK;  // stages of one sub-tile j0
  const int n_stages = n_h + (sub + 1) * per_j;

  float* wt = smem + kSlots3 * kSlot3;  // [kRows][kXPitch]: W^T
  float* cs = wt + kRows * kXPitch;    // [kRows][cp]: C of the sub-tile
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const size_t t0 = static_cast<size_t>(row) * l +
                    static_cast<size_t>(ci) * chunk;
  const size_t h_off = (static_cast<size_t>(row) * nc + ci) * n * p;

  stage(cs, cp, c, (t0 + i0) * n, n, kRows, np_, chunk - i0, n, vec_n);
  // stage u: the inter term's k-slices, then per sub-tile j0 its B
  // k-slices and its X row slices
  auto stage_slice = [&](int u) {
    if (u < n_stages) {
      float* slot = smem + u % kSlots3 * kSlot3;
      if (u < n_h) {
        const int k0 = u * kK;
        stage(slot, kXPitch, states, h_off + static_cast<size_t>(k0) * p +
              p0, p, kK, kSliceP, n - k0, p - p0, vec_p);
      } else {
        const int v = u - n_h;
        const int j0 = v / per_j * kRows;
        const int r = v % per_j;
        if (r < nk) {
          const int k0 = r * kK;
          stage(slot, kBPitch3, b, (t0 + j0) * n + k0, n, kRows, kK,
                chunk - j0, n - k0, vec_n);
        } else {
          const int jj = j0 + (r - nk) * kK;
          stage(slot, kXPitch, x, (t0 + jj) * p + p0, p, kK, kSliceP,
                chunk - jj, p - p0, vec_p);
        }
      }
    }
    cp_async_commit();
  };

  float ci_cum[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + 8 * ty + r;
    ci_cum[r] = i < chunk ? cum[t0 + i] : 0.0f;
  }
  for (int u = 0; u < kSlots3 - 1; ++u) stage_slice(u);  // C with the first
  float acc[8][4], g[8][4], cj[4], dj[4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.0f;
  const float* c_rows = cs + 8 * ty * cp;  // row r at + r * cp

  for (int u = 0; u < n_stages; ++u) {
    cp_async_wait<kSlots3 - 2>();  // this thread's slice u (and C) landed
    __syncthreads();  // everyone's; slot (u - 1) % kSlots3 and, after the
                      // last B slice, wt's last readers are done
    stage_slice(u + kSlots3 - 1);
    const float* slot = smem + u % kSlots3 * kSlot3;
    if (u < n_h) {
      // inter-chunk term: acc += C[:, k0 : k0 + kK] h_in[k0 : k0 + kK, :]
      const int k0 = u * kK;
#pragma unroll 2
      for (int kk = 0; kk < kK; kk += 4) {
        float4 cv[8], hv[4];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          cv[r] = *reinterpret_cast<const float4*>(c_rows + r * cp + k0 + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          hv[q] = *reinterpret_cast<const float4*>(slot + (kk + q) * kXPitch +
                                                   4 * tx);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          acc[r][0] = fmaf(cv[r].x, hv[0].x, acc[r][0]);
          acc[r][1] = fmaf(cv[r].x, hv[0].y, acc[r][1]);
          acc[r][2] = fmaf(cv[r].x, hv[0].z, acc[r][2]);
          acc[r][3] = fmaf(cv[r].x, hv[0].w, acc[r][3]);
          acc[r][0] = fmaf(cv[r].y, hv[1].x, acc[r][0]);
          acc[r][1] = fmaf(cv[r].y, hv[1].y, acc[r][1]);
          acc[r][2] = fmaf(cv[r].y, hv[1].z, acc[r][2]);
          acc[r][3] = fmaf(cv[r].y, hv[1].w, acc[r][3]);
          acc[r][0] = fmaf(cv[r].z, hv[2].x, acc[r][0]);
          acc[r][1] = fmaf(cv[r].z, hv[2].y, acc[r][1]);
          acc[r][2] = fmaf(cv[r].z, hv[2].z, acc[r][2]);
          acc[r][3] = fmaf(cv[r].z, hv[2].w, acc[r][3]);
          acc[r][0] = fmaf(cv[r].w, hv[3].x, acc[r][0]);
          acc[r][1] = fmaf(cv[r].w, hv[3].y, acc[r][1]);
          acc[r][2] = fmaf(cv[r].w, hv[3].z, acc[r][2]);
          acc[r][3] = fmaf(cv[r].w, hv[3].w, acc[r][3]);
        }
      }
      if (u == n_h - 1) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float e = expf(ci_cum[r]);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] *= e;
        }
      }
      continue;
    }
    const int v = u - n_h;
    const int j0 = v / per_j * kRows;
    const int r_st = v % per_j;
    if (r_st < nk) {
      // g += C[:, k0 : k0 + kK] B_j[:, k0 : k0 + kK]^T
      const int k0 = r_st * kK;
      if (r_st == 0) {
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int w = 0; w < 4; ++w) g[r][w] = 0.0f;
        // the mask's cum_j and dt_j, read while the product runs
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int j = j0 + tx + 16 * w;
          cj[w] = j < chunk ? cum[t0 + j] : 0.0f;
          dj[w] = j < chunk ? dt[t0 + j] : 0.0f;
        }
      }
#pragma unroll 2
      for (int kk = 0; kk < kK; kk += 4) {
        float4 cv[8], bv[4];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          cv[r] = *reinterpret_cast<const float4*>(c_rows + r * cp + k0 + kk);
#pragma unroll
        for (int w = 0; w < 4; ++w)
          bv[w] = *reinterpret_cast<const float4*>(
              slot + (tx + 16 * w) * kBPitch3 + kk);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            g[r][w] = fmaf(cv[r].x, bv[w].x, g[r][w]);
            g[r][w] = fmaf(cv[r].y, bv[w].y, g[r][w]);
            g[r][w] = fmaf(cv[r].z, bv[w].z, g[r][w]);
            g[r][w] = fmaf(cv[r].w, bv[w].w, g[r][w]);
          }
      }
      if (r_st == nk - 1) {
        // W^T to shared memory: exp only on or below the diagonal
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int j = j0 + tx + 16 * w;
          float wv[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const int i = i0 + 8 * ty + r;
            wv[r] = (j <= i && i < chunk)
                        ? g[r][w] * expf(ci_cum[r] - cj[w]) * dj[w]
                        : 0.0f;
          }
          float* dst = wt + (tx + 16 * w) * kXPitch + 8 * ty;
          *reinterpret_cast<float4*>(dst) =
              make_float4(wv[0], wv[1], wv[2], wv[3]);
          *reinterpret_cast<float4*>(dst + 4) =
              make_float4(wv[4], wv[5], wv[6], wv[7]);
        }
      }
    } else {
      // acc += W[:, jj : jj + kK] X[jj : jj + kK, :] (the barrier of this
      // slice ordered the W^T writes before these reads)
      const float* w_rows = wt + (r_st - nk) * kK * kXPitch + 8 * ty;
#pragma unroll 4
      for (int j = 0; j < kK; ++j) {
        const float4 w0 =
            *reinterpret_cast<const float4*>(w_rows + j * kXPitch);
        const float4 w1 =
            *reinterpret_cast<const float4*>(w_rows + j * kXPitch + 4);
        const float4 xv =
            *reinterpret_cast<const float4*>(slot + j * kXPitch + 4 * tx);
        const float wr[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          acc[r][0] = fmaf(wr[r], xv.x, acc[r][0]);
          acc[r][1] = fmaf(wr[r], xv.y, acc[r][1]);
          acc[r][2] = fmaf(wr[r], xv.z, acc[r][2]);
          acc[r][3] = fmaf(wr[r], xv.w, acc[r][3]);
        }
      }
    }
  }

  const int pp = p0 + 4 * tx;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + 8 * ty + r;
    if (i >= chunk) continue;
    float* dst = y + (t0 + i) * p + pp;
    if (vec_p && pp < p) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (pp + e < p) dst[e] = acc[r][e];
    }
  }
}

bool aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// The shapes every pass takes, and the grids they give, within limits.
bool valid(int bh, int l, int p, int n, int chunk) {
  if (bh < 1 || l < 1 || p < 1 || n < 1 || n > kMaxN || chunk < 1 ||
      l % chunk)
    return false;
  const long long nc = l / chunk;
  const long long subs = (chunk + kRows - 1) / kRows;
  const long long tiles_p = (p + kSliceP - 1) / kSliceP;
  const long long entries = static_cast<long long>(bh) * n * p;
  return bh * nc <= INT_MAX && subs * nc * bh * tiles_p <= INT_MAX &&
         (entries + kPassThreads - 1) / kPassThreads <= INT_MAX &&
         static_cast<long long>(n) * p <= INT_MAX;
}

int configure() {
  static bool done = false;
  if (done) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_states, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_chunk_outputs,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem3_floats(kMaxN) * 4);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_chunk_states,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_chunk_outputs,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  done = true;
  return 0;
}

}  // namespace

extern "C" {

// The three passes of one scan, each launched on `stream` and followed by
// cudaGetLastError() (0 when the launch was accepted); none synchronises.
// x and y are (bh, l, p), dt (bh, l), a (bh,), b and c (bh, l, n); cum is a
// (bh, l) and states a (bh, l / chunk, n, p) float32 scratch; h_final, which
// may be null, the (bh, n, p) state after the last step. A scan that wants
// it passes with_last = 1 to pass 1 and h_final to pass 2. Each returns
// cudaErrorInvalidValue, launching nothing, for shapes outside `valid`.
// Dtypes, contiguity and devices are checked by the Python wrapper.
int repro_ssd_chunk_states(const void* x, const void* dt, const void* a,
                           const void* b, void* cum, void* states, int bh,
                           int l, int p, int n, int chunk, int with_last,
                           void* stream) {
  if (!valid(bh, l, p, n, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (const int e = configure()) return e;
  const int vec_n = n % 4 == 0 && aligned(b);
  const int vec_p = p % 4 == 0 && aligned(x) && aligned(states);
  ssd_chunk_states<<<static_cast<unsigned>(bh) * (l / chunk), kThreads,
                     kSmem1, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(cum), static_cast<float*>(states), l, p, n, chunk,
      vec_n, vec_p, with_last);
  return static_cast<int>(cudaGetLastError());
}

int repro_ssd_state_pass(const void* cum, void* states, void* h_final, int bh,
                         int l, int p, int n, int chunk, void* stream) {
  if (!valid(bh, l, p, n, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long entries = static_cast<long long>(bh) * n * p;
  const bool vec = n * p % 4 == 0 && aligned(states) && aligned(h_final);
  const int per_block = kPassThreads * (vec ? 4 : 1);
  const unsigned grid =
      static_cast<unsigned>((entries + per_block - 1) / per_block);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    ssd_state_pass<4><<<grid, kPassThreads, 0, st>>>(
        static_cast<const float*>(cum), static_cast<float*>(states),
        static_cast<float*>(h_final), bh, l, chunk, n * p);
  else
    ssd_state_pass<1><<<grid, kPassThreads, 0, st>>>(
        static_cast<const float*>(cum), static_cast<float*>(states),
        static_cast<float*>(h_final), bh, l, chunk, n * p);
  return static_cast<int>(cudaGetLastError());
}

int repro_ssd_chunk_outputs(const void* x, const void* dt, const void* b,
                            const void* c, const void* cum,
                            const void* states, void* y, int bh, int l,
                            int p, int n, int chunk, void* stream) {
  if (!valid(bh, l, p, n, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (const int e = configure()) return e;
  const int vec_n = n % 4 == 0 && aligned(b) && aligned(c);
  const int vec_p = p % 4 == 0 && aligned(x) && aligned(y) &&
                    aligned(states);
  const unsigned grid = static_cast<unsigned>(
      (chunk + kRows - 1) / kRows * (l / chunk) * bh *
      ((p + kSliceP - 1) / kSliceP));
  ssd_chunk_outputs<<<grid, kThreads, smem3_floats(n) * 4,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(cum), static_cast<const float*>(states),
      static_cast<float*>(y), bh, l, p, n, chunk, vec_n, vec_p);
  return static_cast<int>(cudaGetLastError());
}

// The limits the Python wrapper's fit check must agree with.
void repro_ssd_limits(int* max_n, int* rows, int* slice_p) {
  *max_n = kMaxN;
  *rows = kRows;
  *slice_p = kSliceP;
}

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
