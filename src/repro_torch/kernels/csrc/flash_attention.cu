// Flash attention (forward) for Hopper (sm_90a): online-softmax attention
// out[h, i] = sum_j softmax_j(q[h, i] . k[h/g, j] * scale) v[h/g, j] over the
// causal and sliding-window masks, with grouped-query heads (g q heads share
// one kv head), in float32 or bf16 with float32 arithmetic. q has sq rows a
// head and k, v skv (cross-attention: queries over another sequence's keys);
// only the first kv_len keys are real, the rest a pad masked as the
// reference's blockwise attention masks it (src/repro/models/attention.py:
// 72-73). Causal and window masks need sq == skv.
//
// Replaces the Pallas TPU kernel `_attn_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py (the pl.pallas_call at line 104).
// There the grid is (heads, q tiles, kv tiles) with the kv axis sequential:
// each step holds one block_q x d q tile and one block_kv x d k/v tile in
// VMEM and folds the tile's scores into float32 m / l / acc scratch.
//
// Here one thread block owns one (head, block_q) output tile of the
// reference, so the tiling still sets the grid, and the block walks the kv
// tiles in order as the sequential grid axis did. Blocks are launched
// heaviest first (the last q tiles under a causal mask). A kv tile is
// visited only when some (q, kv) pair of the block's q tile and that tile
// is unmasked; the reference's grid visits all of them, but a skipped tile
// only adds terms that the first real score multiplies by exactly 0, so
// the output is the same. The walk ends at the sub-tile that holds key
// kv_len - 1: tiles and sub-tiles of pad alone are never staged. Inside a
// visited tile every other sub-tile is computed, masked or not, so block_kv
// still sets the masked work near the diagonal.
//
// The update is the reference's, with its finite NEG_INF = -1e30 mask:
//   m' = max(m, rowmax s), alpha = exp(m - m'), p = exp(s - m'),
//   l' = l alpha + sum p, acc' = acc alpha + p v, out = acc / max(l, 1e-30).
// A row that has seen only masked scores accumulates p = exp(0) = 1, and
// the first real score wipes that with alpha = exp(-1e30 - m) = 0, as on the
// TPU. For bf16 inputs p is rounded to bf16 before the p v product (the
// reference's `p.astype(v.dtype)`); l sums the unrounded p.
// On request (a non-null lse pointer) the kernel also writes each q
// row's logsumexp m + log(max(l, 1e-30)), float32: the statistic the
// reference's custom VJP saves for its backward (models/attention.py:91),
// which recomputes p = exp(s - lse) block by block. A call without one
// (serving) writes nothing more.
//
// What bounds it on the H100: at starcoder2-7b's width (36 q heads over 4
// kv heads, 4096 tokens, d = 128, causal, float32) the useful work is
// 4 * 36 * 4096^2 * 128 / 2 = 154.6 GFLOP, 2.31 ms at the 67 TFLOP/s float32
// rate, against 168 MB of q, k, v and output, 0.05 ms at 3.35 TB/s: the
// operations bound it. Float32 stays on the CUDA cores (TF32 would break the
// float32 tolerance), so the kernel's task is to keep the FMA pipe fed. An
// SM does 128 FMAs a clock but moves 32 words a clock from shared memory
// into registers, broadcast or not (a float4 load takes a warp 4 clocks),
// so a lane must do 4 FMAs for every float it loads. Registers set the
// blocking that gives: 256 threads of at most 255 registers hold the
// 128 x 128 accumulator of a q sub-tile at 64 a thread. The design:
//
//   * Row groups. The 8 neighbouring lanes of a warp form a row group that
//     owns kRows = 4 rows of the q sub-tile (row r * groups + group, so the
//     four groups of a warp read four neighbouring rows). For the scores a
//     lane holds 4 rows x SKV / 8 kv columns (c * 8 + lane): a 4-deep step
//     is 4 q and SKV / 8 k float4 loads for 16 SKV / 8 FMAs, 2.67 FMAs a
//     float at SKV = 64. m, l and alpha live in registers: a row's max and
//     sum take three __shfl_xor_sync within the group.
//   * p v by pairs of groups. The two groups of a pair (16 lanes) share
//     their 8 rows for the accumulator: a lane holds 8 rows x d / 16
//     columns (c * 64 + 4 lane .. + 3), so a kv row is 2 p and d / 64 v
//     float4 loads for 8 d / 16 FMAs, 4 FMAs a float at d = 128. The other
//     group's alpha and l come by one __shfl_xor_sync. p goes to a slice of
//     shared memory per group, written so that one float4 holds the
//     group's 4 rows' p for one kv row, and read only by its pair.
//   * Operands row-major in shared memory at a pitch of D + 4 floats, read
//     as float4 along d: the 8 lanes of a group read 8 different k rows in
//     8 distinct bank quads, and the four groups of a warp share them.
//   * A ring of kSlots = 3 sub-tiles, each a k or a v sub-tile of SKV rows:
//     k of sub-tile u, then its v, then k of u + 1, staged two halves ahead
//     by cp.async (16-byte copies; 4-byte copies when d is not a multiple
//     of 4; converting loads for bf16), one __syncthreads a half, which
//     also orders the p hand-off. Three k or v slots instead of k and v
//     stages let SKV = 64 fit beside the q sub-tile (202,240 bytes at d =
//     128). q is staged once per q sub-tile. Rows past the sequence are
//     clamped to its last row and columns d .. D-1 are zero, so every
//     sub-tile is a whole one and its columns past the tile score -inf.
//   * Masks are computed only on sub-tiles that cross the causal diagonal,
//     the window's edge, the tile's end or kv_len; the others take no
//     compare.
//
// The wrapper's `plan` (flash_attention.py) picks the instantiation: NT
// threads (NT / 8 row groups, a q sub-tile of NT / 2 rows) with SKV (256
// threads with 64, one block an SM; 128 threads with 32, two), and D = 64,
// 128 or 256. The C entry launches only these, and refuses any other plan.
//
// Head dims up to 256 (gemma3-1b's d_head). At D = 256 the WIDE block's q
// sub-tile and ring would take over 227 KB, so D = 256 takes the NARROW
// block at every block_q (174,848 bytes, one block an SM). Its accumulator
// would double to 128 registers a lane and spill, so two blocks share each
// (head, q tile): each computes the full-d scores and softmax and owns one
// 128-column half of v and the output (twice the score work at d 256; a
// faster block is later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kLanes = 8;                  // lanes of a row group
constexpr int kRows = 4;                   // q rows a row group owns
constexpr int kSlots = 3;                  // ring slots (a k or a v sub-tile)
constexpr int kMaxD = 256;                 // head dims an instantiation holds
constexpr int kMaxSmem = 232448;           // dynamic shared memory of a block
constexpr float kNegInf = -1e30f;          // NEG_INF of the reference
static_assert(kRows == 4, "a row group's p for one kv row is one float4");

// Floats of a row group's p slice: sub_kv kv rows of kRows p, padded so the
// slices of a warp's groups start in distinct bank quads.
__host__ __device__ constexpr int p_slice(int sub_kv) {
  return sub_kv * kRows + 4;
}

// Blocks that share one (head, q tile), each owning D / col_blocks of the
// output's columns: two at D = 256, so the accumulator stays 8 x 16 a lane.
__host__ __device__ constexpr int col_blocks(int d_max) {
  return d_max > 128 ? 2 : 1;
}

// Shared memory of one instantiation, in floats: the q sub-tile, the ring
// of k and v sub-tiles, and the row groups' p slices.
__host__ __device__ constexpr int smem_floats(int d_max, int threads,
                                              int sub_kv) {
  return (threads / kLanes * kRows + kSlots * sub_kv) * (d_max + 4) +
         threads / kLanes * p_slice(sub_kv);
}

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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// p as the p v product sees it: rounded to v's type
__device__ __forceinline__ float as_v_type(float p, const float*) { return p; }
__device__ __forceinline__ float as_v_type(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}

// Stages rows row0 .. row0 + N - 1 of an (s, d) matrix (each clamped to
// row s - 1) as float32 rows of pitch D + 4, columns 0 .. d - 1. float:
// cp.async, 16 bytes a copy where `vec` (d a multiple of 4, 16-byte
// aligned), else 4; bf16: converting loads, done when this returns.
template <int D, int NT, int N, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int row0,
                                           int s, int d, int vec) {
  constexpr int P = D + 4;
  if constexpr (std::is_same_v<T, float>) {
    if (vec) {
      for (int idx = threadIdx.x; idx < N * (D / 4); idx += NT) {
        const int i = idx / (D / 4);
        const int c = 4 * (idx % (D / 4));
        if (c < d)
          cp_async16(dst + i * P + c,
                     src + static_cast<size_t>(min(row0 + i, s - 1)) * d + c);
      }
      return;
    }
    for (int idx = threadIdx.x; idx < N * D; idx += NT) {
      const int i = idx / D;
      const int c = idx % D;
      if (c < d)
        cp_async4(dst + i * P + c,
                  src + static_cast<size_t>(min(row0 + i, s - 1)) * d + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < N * D; idx += NT) {
      const int i = idx / D;
      const int c = idx % D;
      if (c < d)
        dst[i * P + c] = __bfloat162float(
            src[static_cast<size_t>(min(row0 + i, s - 1)) * d + c]);
    }
  }
}

// kBf16: the operands' type (0 float, 1 bf16). D: head dims staged (d <=
// D). NT: threads, NT / 8 row groups. SKV: kv rows of a sub-tile.
// Shared memory: smem_floats(D, NT, SKV). The launch bounds keep 256
// threads on an SM (one 256-thread block or two of 128).
template <int kBf16, int D, int NT, int SKV>
__global__ void __launch_bounds__(NT, 256 / NT)
attn_kernel(const void* __restrict__ q_in, const void* __restrict__ k_in,
            const void* __restrict__ v_in, void* __restrict__ out_in,
            float* __restrict__ lse, int bh, int sq, int skv, int kv_len,
            int d, int group, int block_q, int block_kv, int causal,
            int window, float scale, int vec) {
  using T = std::conditional_t<kBf16 != 0, __nv_bfloat16, float>;
  constexpr int P = D + 4;            // staged row pitch, in floats
  constexpr int NG = NT / kLanes;     // row groups
  constexpr int SQ = NG * kRows;      // q rows a sub-tile
  constexpr int C = SKV / kLanes;     // score columns a lane holds
  constexpr int PS = p_slice(SKV);    // floats of a group's p slice
  constexpr int PR = 2 * kRows;       // p v: rows a lane holds (a pair's)
  constexpr int NH = col_blocks(D);   // blocks sharing a q tile
  constexpr int VC = D / NH / 64;     // p v: float4 column chunks a lane
  const T* q = static_cast<const T*>(q_in);
  const T* k = static_cast<const T*>(k_in);
  const T* v = static_cast<const T*>(v_in);
  T* out = static_cast<T*>(out_in);

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [SQ][P]
  float* ring = qs + SQ * P;          // kSlots x [SKV][P]
  float* ps = ring + kSlots * SKV * P;  // NG slices of PS

  const int lane = threadIdx.x % 32;
  const int t = lane % kLanes;                        // lane in its group
  const int grp = threadIdx.x / 32 * (32 / kLanes) + lane / kLanes;
  const bool odd = grp % 2;           // the second group of its pair
  const int pl = lane % (2 * kLanes);  // lane in its pair of groups
  const int pair_grp = grp - odd;     // the pair's first group

  const int n_q = sq / block_q;
  const int blk = static_cast<int>(blockIdx.x) / NH;
  const int qi = n_q - 1 - blk / bh;
  const int h = blk % bh;
  const int col0 = static_cast<int>(blockIdx.x) % NH * (D / NH);  // of v
  const T* qh = q + static_cast<size_t>(h) * sq * d;
  const T* kh = k + static_cast<size_t>(h / group) * skv * d;
  const T* vh = v + static_cast<size_t>(h / group) * skv * d;
  T* oh = out + static_cast<size_t>(h) * sq * d;

  // the kv tiles in which some pair of this q tile is unmasked: none past
  // the one that holds key kv_len - 1
  const int q_begin = qi * block_q;
  const int q_last = q_begin + block_q - 1;
  int kv_tile_end = (kv_len + block_kv - 1) / block_kv;
  if (causal) kv_tile_end = min(kv_tile_end, q_last / block_kv + 1);
  int kv_tile_begin = 0;
  if (window > 0) {
    const int lo = q_begin - window + 1;  // visit iff (j + 1) block_kv > lo
    kv_tile_begin = lo > 0 ? lo / block_kv : 0;
  }
  const int subs = (block_kv + SKV - 1) / SKV;  // sub-tiles a kv tile
  // the last visited tile's sub-tiles up to the one that holds key
  // kv_len - 1 (all of them when kv_len covers the tile)
  const int last_rows = min(block_kv, kv_len - (kv_tile_end - 1) * block_kv);
  const int n_sub = kv_tile_end > kv_tile_begin
                        ? (kv_tile_end - kv_tile_begin - 1) * subs +
                              (last_rows + SKV - 1) / SKV
                        : 0;

  // columns d .. D-1 of every staged row stay 0: no copy writes them
  if (d < D) {
    for (int idx = threadIdx.x; idx < (SQ + kSlots * SKV) * D; idx += NT) {
      const int c = idx % D;
      if (c >= d) qs[idx / D * P + c] = 0.0f;
    }
  }

  // The ring is a sequence of halves: half 2u is k of sub-tile u, half
  // 2u + 1 its v, half n in slot n % kSlots. Advancing to half n waits for
  // it, passes the barrier after which slot (n - 1) % kSlots is free, and
  // stages half n + 2 there: one __syncthreads a half.
  auto kv_first = [&](int u) {
    return (kv_tile_begin + u / subs) * block_kv + u % subs * SKV;
  };
  auto stage_half = [&](int n) {
    if (n < 2 * n_sub)
      stage_rows<D, NT, SKV>(ring + n % kSlots * SKV * P, n % 2 ? vh : kh,
                             kv_first(n / 2), skv, d, vec);
    cp_async_commit();
  };
  auto advance = [&](int n) {
    cp_async_wait<1>();  // this thread's copies of half n landed
    __syncthreads();     // everyone's; slot (n - 1) % kSlots is free
    stage_half(n + 2);
    return ring + n % kSlots * SKV * P;
  };

  for (int qs0 = 0; qs0 < block_q; qs0 += SQ) {
    const int q0 = q_begin + qs0;
    __syncthreads();  // the last sub-tile's reads of qs and the ring are done
    stage_rows<D, NT, SQ>(qs, qh, q0, sq, d, vec);
    stage_half(0);
    stage_half(1);

    // scores and softmax state: the group's rows r * NG + grp
    float m[kRows], l[kRows], alpha[kRows];
    // p v: the pair's rows (a < 4 of its first group, a >= 4 of its
    // second), columns col0 + c * 64 + 4 pl + e
    float acc[PR][4 * VC];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      m[r] = kNegInf;
      l[r] = 0.0f;
    }
#pragma unroll
    for (int a = 0; a < PR; ++a)
#pragma unroll
      for (int e = 0; e < 4 * VC; ++e) acc[a][e] = 0.0f;
    const float* q_rows = qs + grp * P;  // row r at + r * NG * P

    for (int u = 0; u < n_sub; ++u) {
      const float* ks = advance(2 * u);
      const int ks0 = u % subs * SKV;
      const int kv0 = kv_first(u);
      const int cols = min(SKV, block_kv - ks0);

      // scores of rows r * NG + grp against columns c * 8 + t
      float sc[kRows][C];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) sc[r][c] = 0.0f;
#pragma unroll 2
      for (int dd = 0; dd < D; dd += 4) {
        float4 qa[kRows], kb[C];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          qa[r] = *reinterpret_cast<const float4*>(q_rows + r * NG * P + dd);
#pragma unroll
        for (int c = 0; c < C; ++c)
          kb[c] = *reinterpret_cast<const float4*>(
              ks + (c * kLanes + t) * P + dd);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            sc[r][c] = fmaf(qa[r].x, kb[c].x, sc[r][c]);
            sc[r][c] = fmaf(qa[r].y, kb[c].y, sc[r][c]);
            sc[r][c] = fmaf(qa[r].z, kb[c].z, sc[r][c]);
            sc[r][c] = fmaf(qa[r].w, kb[c].w, sc[r][c]);
          }
      }

      // a sub-tile with a masked pair, a pad key or a column past the
      // tile's end
      const bool edge = cols < SKV || (causal && kv0 + SKV - 1 > q0) ||
                        (window > 0 && q0 + SQ - 1 - kv0 >= window) ||
                        kv0 + SKV > kv_len;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int q_pos = q0 + r * NG + grp;
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float x = sc[r][c] * scale;
          if (edge) {
            const int col = c * kLanes + t;
            const int kv_pos = kv0 + col;
            if ((causal && q_pos < kv_pos) ||
                (window > 0 && q_pos - kv_pos >= window) ||
                kv_pos >= kv_len)
              x = kNegInf;
            if (col >= cols) x = -INFINITY;  // no score at all
          }
          sc[r][c] = x;
          mx = fmaxf(mx, x);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float m_new = fmaxf(m[r], mx);
        alpha[r] = __expf(m[r] - m_new);
        float sum = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float p = __expf(sc[r][c] - m_new);
          sum += p;
          sc[r][c] = p;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        l[r] = l[r] * alpha[r] + sum;
        m[r] = m_new;
      }
      // p to the group's slice: kv row j holds the group's 4 rows' p
      float* my_p = ps + grp * PS;
#pragma unroll
      for (int c = 0; c < C; ++c)
        *reinterpret_cast<float4*>(my_p + (c * kLanes + t) * kRows) =
            make_float4(as_v_type(sc[0][c], q), as_v_type(sc[1][c], q),
                        as_v_type(sc[2][c], q), as_v_type(sc[3][c], q));

      // the barrier of the next half orders the p writes before the reads
      const float* vs = advance(2 * u + 1);
      // acc = acc alpha + p v; the other group's alpha by a shuffle
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float other = __shfl_xor_sync(0xffffffffu, alpha[r], kLanes);
        const float lo = odd ? other : alpha[r];
        const float hi = odd ? alpha[r] : other;
#pragma unroll
        for (int e = 0; e < 4 * VC; ++e) {
          acc[r][e] *= lo;
          acc[kRows + r][e] *= hi;
        }
      }
      const float* p_pair = ps + pair_grp * PS;
#pragma unroll 2
      for (int j = 0; j < SKV; ++j) {
        const float4 p0 = *reinterpret_cast<const float4*>(p_pair + j * kRows);
        const float4 p1 =
            *reinterpret_cast<const float4*>(p_pair + PS + j * kRows);
        const float pr[PR] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int c = 0; c < VC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + j * P + col0 + c * 64 + 4 * pl);
#pragma unroll
          for (int a = 0; a < PR; ++a) {
            acc[a][4 * c + 0] = fmaf(pr[a], vv.x, acc[a][4 * c + 0]);
            acc[a][4 * c + 1] = fmaf(pr[a], vv.y, acc[a][4 * c + 1]);
            acc[a][4 * c + 2] = fmaf(pr[a], vv.z, acc[a][4 * c + 2]);
            acc[a][4 * c + 3] = fmaf(pr[a], vv.w, acc[a][4 * c + 3]);
          }
        }
      }
      // the next write of the p slices comes after the next barrier
    }

    // every lane of a group holds its rows' whole l; the pair's by a shuffle
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float other = __shfl_xor_sync(0xffffffffu, l[r], kLanes);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int a = half * kRows + r;
        const int row = r * NG + pair_grp + half;
        const float denom =
            fmaxf(half == static_cast<int>(odd) ? l[r] : other, 1e-30f);
        if (qs0 + row >= block_q) continue;
        T* dst = oh + static_cast<size_t>(q0 + row) * d;
#pragma unroll
        for (int c = 0; c < VC; ++c) {
          const int col = col0 + c * 64 + 4 * pl;
          const float o0 = acc[a][4 * c + 0] / denom;
          const float o1 = acc[a][4 * c + 1] / denom;
          const float o2 = acc[a][4 * c + 2] / denom;
          const float o3 = acc[a][4 * c + 3] / denom;
          if (kBf16 == 0 && vec && col < d) {
            *reinterpret_cast<float4*>(dst + col) =
                make_float4(o0, o1, o2, o3);
          } else {
            if (col + 0 < d) store(dst + col + 0, o0);
            if (col + 1 < d) store(dst + col + 1, o1);
            if (col + 2 < d) store(dst + col + 2, o2);
            if (col + 3 < d) store(dst + col + 3, o3);
          }
        }
      }
    }
    // with an lse output, lane 0 of each group writes its rows'
    // m + log(max(l, 1e-30)) (one of the blocks sharing a q tile)
    if (lse != nullptr && col0 == 0 && t == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = r * NG + grp;
        if (qs0 + row < block_q)
          lse[static_cast<size_t>(h) * sq + q0 + row] =
              m[r] + logf(fmaxf(l[r], 1e-30f));
      }
    }
  }
}

template <int kBf16, int D, int NT, int SKV>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int bh, int sq, int skv, int kv_len, int d, int group, int block_q,
           int block_kv, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr int kSmem = smem_floats(D, NT, SKV) * 4;
  static_assert(kSmem <= kMaxSmem, "an instantiation fits a block");
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_kernel<kBf16, D, NT, SKV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attn_kernel<kBf16, D, NT, SKV>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = d % 4 == 0 && aligned(q) && aligned(k) && aligned(v) &&
                  aligned(out);
  const unsigned grid =
      static_cast<unsigned>(bh) * (sq / block_q) * col_blocks(D);
  attn_kernel<kBf16, D, NT, SKV><<<grid, NT, kSmem, stream>>>(
      q, k, v, out, lse, bh, sq, skv, kv_len, d, group, block_q, block_kv,
      causal, window, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the instantiation the Python wrapper's `plan` chose
// (flash_attention.py): head dims staged up to `d_max`, `threads` threads
// and k/v sub-tiles of `sub_kv` rows; the row groups, q sub-tile, pitch,
// ring and shared memory follow from these. `bf16` selects __nv_bfloat16
// operands. q is (bh, sq, d), k and v (bh / group, skv, d), of which keys
// kv_len .. skv - 1 are a masked pad; window <= 0 means no window, and a
// causal or window mask needs sq == skv. Returns cudaErrorInvalidValue, launching nothing, for a
// problem outside this kernel's limits or a plan it was not built for,
// else cudaGetLastError() after the launch (0 when it was accepted); does
// not synchronise. Dtypes and contiguity are checked by the wrapper. With
// a non-null `lse`, a (bh, s) float32 output, each query row's logsumexp
// of its masked, scaled scores goes there too, m + log(max(l, 1e-30)) as
// the reference's custom VJP saves it (src/repro/models/attention.py:91);
// a null `lse` writes nothing more; it is (bh, sq).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, void* lse, int bh, int sq, int skv,
                          int kv_len, int d, int group, int block_q,
                          int block_kv, int causal, int window, float scale,
                          int bf16, int d_max, int threads, int sub_kv,
                          void* stream) {
  if (bh < 1 || sq < 1 || skv < 1 || kv_len < 1 || kv_len > skv || d < 1 ||
      d > d_max || group < 1 || bh % group || block_q < 1 || block_kv < 1 ||
      sq % block_q || skv % block_kv ||
      ((causal || window > 0) && sq != skv) ||
      static_cast<long long>(bh) * (sq / block_q) * 2 > INT_MAX ||
      (bf16 != 0 && bf16 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_out = static_cast<float*>(lse);
#define REPRO_ATTN_CASE(D, NT, SKV)                                          \
  if (d_max == D && threads == NT && sub_kv == SKV)                          \
    return bf16 ? launch<1, D, NT, SKV>(q, k, v, out, lse_out, bh, sq, skv,  \
                                        kv_len, d, group, block_q, block_kv, \
                                        causal, window, scale, st)           \
                : launch<0, D, NT, SKV>(q, k, v, out, lse_out, bh, sq, skv,  \
                                        kv_len, d, group, block_q, block_kv, \
                                        causal, window, scale, st);
  REPRO_ATTN_CASE(256, 128, 32)
  REPRO_ATTN_CASE(128, 256, 64) REPRO_ATTN_CASE(128, 128, 32)
  REPRO_ATTN_CASE(64, 256, 64) REPRO_ATTN_CASE(64, 128, 32)
#undef REPRO_ATTN_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The limits the Python wrapper's plan must agree with.
void repro_flash_attention_limits(int* max_d, int* rows, int* stages) {
  *max_d = kMaxD;
  *rows = kRows;
  *stages = kSlots;
}

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
