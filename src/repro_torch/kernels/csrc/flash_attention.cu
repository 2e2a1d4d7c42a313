// Flash attention (forward) for Hopper (sm_90a): online-softmax attention
// out[h, i] = sum_j softmax_j(q[h, i] . k[h/g, j] * scale) v[h/g, j] over the
// causal and sliding-window masks, with grouped-query heads (g q heads share
// one kv head), in float32 or bf16 with float32 arithmetic.
//
// Replaces the Pallas TPU kernel `_attn_kernel` / `flash_attention` of
// src/repro/kernels/flash_attention.py (the pl.pallas_call at line 104).
// There the grid is (heads, q tiles, kv tiles) with the kv axis sequential:
// each step holds one block_q x d q tile and one block_kv x d k/v tile in
// VMEM and folds the tile's scores into float32 m / l / acc scratch.
//
// Here one thread block owns one (head, block_q) output tile of the
// reference, so the tiling still sets the grid, and the block walks the kv
// tiles in order as the sequential grid axis did. A tile of up to 1024 q
// rows (512 KB in float32 at d = 128) and 2048 kv rows (2 MB of k and v)
// does not fit the 227 KB of shared memory of a block, so the block walks
// its q tile in sub-tiles of kSubQ rows and each kv tile in sub-tiles of
// kSubKV rows, staging them in shared memory (q and k transposed, v row by
// row, all in float32), and folds every kv sub-tile into m / l in shared
// memory and acc in registers with the reference's update:
//   m' = max(m, rowmax s), alpha = exp(m - m'), p = exp(s - m'),
//   l' = l alpha + sum p, acc' = acc alpha + p v.
// Masked scores are the reference's finite -1e30, never -inf: a row that
// has seen only masked scores accumulates p = exp(0) = 1, and the first
// real score wipes that with alpha = exp(-1e30 - m) = 0, as on the TPU.
// For bf16 inputs p is rounded to bf16 before the p v product (the
// reference's `p.astype(v.dtype)`); l sums the unrounded p. The output is
// acc / max(l, 1e-30).
//
// Fully masked kv tiles are skipped: a kv tile is visited only when some
// (q, kv) pair of the block's q tile and that block_kv tile is unmasked.
// The reference's grid visits all of them; a skipped tile only adds terms
// that the first real score multiplies by exactly 0, so the output is the
// same. Inside a visited tile every sub-tile is computed, masked or not, so
// block_kv still sets how much masked work a block does near the diagonal.
// Blocks are launched heaviest first (the last q tiles under a causal mask).
//
// What bounds it on the H100: at starcoder2-7b's width (36 q heads over 4
// kv heads, 4096 tokens, d = 128, causal, float32) the useful work is
// 4 * 36 * 4096^2 * 128 / 2 = 154.6 GFLOP, 2.31 ms at the 67 TFLOP/s float32
// rate, against 168 MB of q, k, v and output, 0.05 ms at 3.35 TB/s: the
// operations bound it. This first kernel runs on the CUDA cores and reads
// its operands from shared memory for every multiply-add (2 x 4 register
// tiles for the scores, 8 x 4 for acc); tensor cores (wgmma), TMA and
// softmax in registers are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kSubQ = 64;               // q rows staged at once
constexpr int kSubKV = 32;              // kv rows staged at once
constexpr int kMaxD = 128;              // head dims the staging holds
constexpr int kQStride = kSubQ + 4;     // qt[d][i], padded, float4-aligned
constexpr int kKStride = kSubKV + 4;    // kt[d][j]
constexpr int kPStride = kSubQ + 4;     // pt[j][i]
constexpr int kSmemFloats = kMaxD * kQStride + kMaxD * kKStride +
                            kSubKV * kMaxD + kSubKV * kPStride + 3 * kSubQ;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);
constexpr float kNegInf = -1e30f;       // NEG_INF of the reference

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ out, int bh, int s,
            int d, int group, int block_q, int block_kv, int causal,
            int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                              // [kMaxD][kQStride]
  float* kt = qt + kMaxD * kQStride;             // [kMaxD][kKStride]
  float* vs = kt + kMaxD * kKStride;             // [kSubKV][kMaxD]
  float* pt = vs + kSubKV * kMaxD;               // [kSubKV][kPStride]
  float* m_s = pt + kSubKV * kPStride;           // [kSubQ]
  float* l_s = m_s + kSubQ;                      // [kSubQ]
  float* alpha_s = l_s + kSubQ;                  // [kSubQ]

  const int n_q = s / block_q;
  const int qi = n_q - 1 - static_cast<int>(blockIdx.x) / bh;
  const int h = static_cast<int>(blockIdx.x) % bh;
  const size_t q_off = static_cast<size_t>(h) * s * d;
  const size_t kv_off = static_cast<size_t>(h / group) * s * d;
  const int tid = threadIdx.x;
  const int s_ty = tid / 8;   // scores: rows 2 s_ty + {0, 1}
  const int s_tx = tid % 8;   //         cols 4 s_tx + {0..3}
  const int o_ty = tid / 32;  // acc:    rows 8 o_ty + {0..7}
  const int o_tx = tid % 32;  //         cols 4 o_tx + {0..3}

  // the kv tiles in which some pair of this q tile is unmasked
  const int q_begin = qi * block_q;
  const int q_last = q_begin + block_q - 1;
  const int n_kv = s / block_kv;
  int kv_tile_end = n_kv;
  if (causal) kv_tile_end = min(n_kv, q_last / block_kv + 1);
  int kv_tile_begin = 0;
  if (window > 0) {
    const int lo = q_begin - window + 1;  // visit iff (j + 1) block_kv > lo
    kv_tile_begin = lo > 0 ? lo / block_kv : 0;
  }

  for (int qs = 0; qs < block_q; qs += kSubQ) {
    const int q0 = q_begin + qs;
    const int rows = min(kSubQ, block_q - qs);
    __syncthreads();  // the last sub-tile's reads of qt, m_s, l_s are done
    for (int idx = tid; idx < kSubQ * d; idx += kThreads) {
      const int i = idx / d;
      const int dd = idx - i * d;
      qt[dd * kQStride + i] =
          i < rows ? to_f32(q[q_off + static_cast<size_t>(q0 + i) * d + dd])
                   : 0.0f;
    }
    if (tid < kSubQ) {
      m_s[tid] = kNegInf;
      l_s[tid] = 0.0f;
    }
    float acc[8][4];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

    for (int jt = kv_tile_begin; jt < kv_tile_end; ++jt) {
      for (int ks = 0; ks < block_kv; ks += kSubKV) {
        const int kv0 = jt * block_kv + ks;
        const int cols = min(kSubKV, block_kv - ks);
        __syncthreads();  // the last p v product's reads of vs, pt are done
        for (int idx = tid; idx < kSubKV * d; idx += kThreads) {
          const int j = idx / d;
          const int dd = idx - j * d;
          const size_t g = kv_off + static_cast<size_t>(kv0 + j) * d + dd;
          const bool in = j < cols;
          kt[dd * kKStride + j] = in ? to_f32(k[g]) : 0.0f;
          vs[j * kMaxD + dd] = in ? to_f32(v[g]) : 0.0f;
        }
        __syncthreads();

        // scores of rows 2 s_ty + r against cols 4 s_tx + c
        float sc[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[r][c] = 0.0f;
        for (int dd = 0; dd < d; ++dd) {
          const float2 qa =
              *reinterpret_cast<const float2*>(qt + dd * kQStride + 2 * s_ty);
          const float4 kb =
              *reinterpret_cast<const float4*>(kt + dd * kKStride + 4 * s_tx);
          const float qv[2] = {qa.x, qa.y};
          const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              sc[r][c] = fmaf(qv[r], kv[c], sc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 2 * s_ty + r;
          const int q_pos = q0 + row;
          float mx = -INFINITY;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = 4 * s_tx + c;
            const int kv_pos = kv0 + col;
            float x = sc[r][c] * scale;
            if ((causal && q_pos < kv_pos) ||
                (window > 0 && q_pos - kv_pos >= window))
              x = kNegInf;
            // a column past the tile's end is no score at all
            sc[r][c] = col < cols ? x : -INFINITY;
            mx = fmaxf(mx, sc[r][c]);
          }
          // the 8 threads of a row are 8 neighbouring lanes
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          const float m_prev = m_s[row];
          const float m_new = fmaxf(m_prev, mx);
          float sum = 0.0f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float p = __expf(sc[r][c] - m_new);
            sum += p;
            pt[(4 * s_tx + c) * kPStride + row] = as_v_type(p, q);
          }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          sum += __shfl_xor_sync(0xffffffffu, sum, 4);
          if (s_tx == 0) {
            const float alpha = __expf(m_prev - m_new);
            m_s[row] = m_new;
            l_s[row] = l_s[row] * alpha + sum;
            alpha_s[row] = alpha;
          }
        }
        __syncthreads();

        // acc = acc alpha + p v for rows 8 o_ty + a, cols 4 o_tx + b
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const float al = alpha_s[8 * o_ty + a];
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] *= al;
        }
        if (4 * o_tx < d) {
          for (int j = 0; j < cols; ++j) {
            const float4 p0 =
                *reinterpret_cast<const float4*>(pt + j * kPStride + 8 * o_ty);
            const float4 p1 = *reinterpret_cast<const float4*>(
                pt + j * kPStride + 8 * o_ty + 4);
            const float4 vv =
                *reinterpret_cast<const float4*>(vs + j * kMaxD + 4 * o_tx);
            const float pv[8] = {p0.x, p0.y, p0.z, p0.w,
                                 p1.x, p1.y, p1.z, p1.w};
            const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
            for (int a = 0; a < 8; ++a)
#pragma unroll
              for (int b = 0; b < 4; ++b)
                acc[a][b] = fmaf(pv[a], vr[b], acc[a][b]);
          }
        }
      }
    }

    // l_s is final: its last write came before the last barrier
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int row = 8 * o_ty + a;
      if (row >= rows) continue;
      const float denom = fmaxf(l_s[row], 1e-30f);
      T* dst = out + q_off + static_cast<size_t>(q0 + row) * d;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = 4 * o_tx + b;
        if (col < d) store(dst + col, acc[a][b] / denom);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int s, int d, int group, int block_q, int block_kv, int causal,
           int window, float scale, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned grid = static_cast<unsigned>(bh) * (s / block_q);
  attn_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), bh, s, d, group,
      block_q, block_kv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 when it was accepted);
// does not synchronise. Shapes are checked by the Python wrapper: q is
// (bh, s, d), k and v (bh / group, s, d), block_q and block_kv divide s,
// d <= kMaxD; window <= 0 means no window; bf16 selects __nv_bfloat16.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int bh, int s, int d, int group,
                          int block_q, int block_kv, int causal, int window,
                          float scale, int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, out, bh, s, d, group, block_q,
                                      block_kv, causal, window, scale, st)
              : launch<float>(q, k, v, out, bh, s, d, group, block_q,
                              block_kv, causal, window, scale, st);
}

// The limit the Python wrapper's fit check must agree with.
void repro_flash_attention_limits(int* max_d) { *max_d = kMaxD; }

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
