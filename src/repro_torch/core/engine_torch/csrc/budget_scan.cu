// Budget replay scan for Hopper (sm_90a): the sequential float64 budget
// accounting every simulated evaluation goes through.
//
// Replaces the XLA scan of src/repro/core/engine_jax/replay.py:
// `budget_scan` (:66) + `_replay_segment` (:89), jitted as `_replay_jit`
// and vmapped over runs as `_replay_vjit` (:104-108). It is a lax.scan,
// not Pallas, but it is the device half of the main path.
//
// Semantics, per run r and entry j of its row segment:
//   col    = col_of_row[rows[r, j]]
//   value  = col < 0 ? inf : time_s[col]
//   charge = col < 0 ? mean_charge : charge_s[col]
//   commit = fresh[r, j] && spent < max_s[r] && evals < max_e[r]  (before j)
//   if commit: spent += charge, evals += 1
//   accept[r, j] = commit, t_after[r, j] = spent
// and at the end spent[r], evals[r] and exhausted[r] = any(fresh && !accept).
//
// The result must be bit-identical to the numpy engine's left-to-right
// float64 additions (np.cumsum / the scalar commit loop): no parallel
// scan, no reordering. Every add is an explicit round-to-nearest
// __dadd_rn in entry order; the build also passes -fmad=false.
//
// What bounds it on the H100: it moves bytes and does almost no arithmetic.
// Per entry it reads rows (8 B) and fresh (1 B) and writes accept (1 B),
// t_after, value and charge (8 B each); the tables (at most 10,140 x 20 B)
// stay in L2. At R = 1024 runs x N = 10,140 that is about 0.35 GB, ~0.1 ms
// at 3.35 TB/s. At R = 1 (a GA generation, one annealing move) a call is a
// latency chain instead: rows -> col_of_row -> time_s / charge_s, three
// dependent loads, then n dependent float64 adds.
//
// The design rests on one fact: once a fresh entry is refused, spent and
// evals stop changing, so every later fresh entry is refused too. The
// accepted entries are the fresh entries before the first refusal, and
// only the adds over them must run in order.
//
//   * A warp per run, kWarps runs a block. The warp takes its segment in
//     chunks of kChunk entries; lane l owns entries l, l + 32, ... of a
//     chunk, so each load and store of the warp is 32 neighbouring
//     elements (row-major (R, N) is contiguous within a run).
//   * The gathers are off the chain: every lane issues its col_of_row and
//     time_s / charge_s gathers at once, writes value and charge, and puts
//     its charges in the warp's slice of shared memory. The next chunk's
//     rows and fresh are loaded before the walk, so they are in flight
//     while it runs.
//   * One lane walks the chunk in entry order: per entry a shared-memory
//     read, a bit test of the fresh mask (a ballot) and a __dadd_rn, then
//     the spend after the entry written back in place. It compares nothing:
//     the walk is speculative, as if every fresh entry committed.
//   * The caps are then checked by all lanes at once, each against the
//     spend before its entries (the slot before, read back) and the count
//     before them (a popcount of the fresh mask). The first refusal cuts
//     the chunk: entries before it keep the walk's values, entries from it
//     on get accept 0 and the spend before it. After a refusal the warp
//     writes the rest of the segment without walking: accept 0, t_after
//     the frozen spend, value and charge gathered as before.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 4;            // runs a block
constexpr int kSlots = 4;            // entries a lane owns in a chunk
constexpr int kChunk = 32 * kSlots;  // entries a warp takes at a time
constexpr unsigned kAll = 0xffffffffu;

__global__ void __launch_bounds__(32 * kWarps) budget_scan_kernel(
    const int64_t* __restrict__ rows, const uint8_t* __restrict__ fresh,
    const int32_t* __restrict__ col_of_row, const double* __restrict__ time_s,
    const double* __restrict__ charge_s, double mean_charge,
    const double* __restrict__ spent0, const int64_t* __restrict__ evals0,
    const double* __restrict__ max_s, const int64_t* __restrict__ max_e,
    int runs, int64_t n, uint8_t* __restrict__ accept,
    double* __restrict__ t_after, double* __restrict__ value,
    double* __restrict__ charge, double* __restrict__ spent_out,
    int64_t* __restrict__ evals_out, uint8_t* __restrict__ exhausted) {
  __shared__ double chain_smem[kWarps][kChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= runs) return;  // the whole warp: no block-wide barrier follows
  double* chain = chain_smem[warp];
  const unsigned below = (1u << lane) - 1u;  // lanes before this one
  const int64_t base = static_cast<int64_t>(r) * n;
  const double cap_s = max_s[r];
  const int64_t cap_e = max_e[r];
  double spent = spent0[r];
  int64_t evals = evals0[r];
  bool frozen = false;

  int64_t row[kSlots];
  bool fr[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int64_t j = 32 * s + lane;
    row[s] = j < n ? rows[base + j] : 0;
    fr[s] = j < n && fresh[base + j] != 0;
  }
  for (int64_t j0 = 0; j0 < n; j0 += kChunk) {
    const int len = static_cast<int>(n - j0 < kChunk ? n - j0 : kChunk);
    double c[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int k = 32 * s + lane;
      const int32_t col = k < len ? col_of_row[row[s]] : -1;
      const double v = col < 0 ? HUGE_VAL : time_s[col];
      c[s] = col < 0 ? mean_charge : charge_s[col];
      if (k < len) {
        value[base + j0 + k] = v;
        charge[base + j0 + k] = c[s];
      }
    }
    unsigned fm[kSlots];  // fresh entries of each slot, one bit a lane
#pragma unroll
    for (int s = 0; s < kSlots; ++s) fm[s] = __ballot_sync(kAll, fr[s]);
    // the next chunk's rows and fresh, in flight during the walk
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int64_t j = j0 + kChunk + 32 * s + lane;
      row[s] = j < n ? rows[base + j] : 0;
      fr[s] = j < n && fresh[base + j] != 0;
    }
    if (frozen) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int k = 32 * s + lane;
        if (k < len) {
          accept[base + j0 + k] = 0;
          t_after[base + j0 + k] = spent;
        }
      }
      continue;
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) chain[32 * s + lane] = c[s];
    __syncwarp();
    if (lane == 0) {
      double t = spent;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (32 * s >= len) break;
#pragma unroll
        for (int l = 0; l < 32; ++l) {
          if ((fm[s] >> l) & 1u) t = __dadd_rn(t, chain[32 * s + l]);
          chain[32 * s + l] = t;
        }
      }
    }
    __syncwarp();
    // the caps, checked by every lane against the spend and count before
    // each of its entries; the first refusal in entry order cuts the chunk
    int cut = kChunk;
    int64_t ev = evals;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int k = 32 * s + lane;
      const double before = k == 0 ? spent : chain[k - 1];
      const int64_t ev_before = ev + __popc(fm[s] & below);
      const unsigned refused = __ballot_sync(
          kAll, ((fm[s] >> lane) & 1u) &&
                    !(before < cap_s && ev_before < cap_e));
      if (cut == kChunk && refused) cut = 32 * s + __ffs(refused) - 1;
      if (cut == kChunk) ev += __popc(fm[s]);
    }
    double stop = spent;  // the spend before the refused entry
    if (cut < kChunk) {
      if (cut > 0) stop = chain[cut - 1];
      ev += __popc(fm[cut / 32] & ((1u << (cut % 32)) - 1u));
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int k = 32 * s + lane;
      if (k < len) {
        accept[base + j0 + k] = k < cut && ((fm[s] >> lane) & 1u);
        t_after[base + j0 + k] = k < cut ? chain[k] : stop;
      }
    }
    spent = cut < kChunk ? stop : chain[len - 1];
    evals = ev;
    frozen = cut < kChunk;
    __syncwarp();  // every lane has read the chain before the next chunk
  }
  if (lane == 0) {
    spent_out[r] = spent;
    evals_out[r] = evals;
    exhausted[r] = frozen;
  }
}

}  // namespace

extern "C" {

// All pointers are device pointers; per-run arrays have `runs` entries,
// per-entry arrays runs x n (row-major). Returns cudaGetLastError() after
// the launch (0 when it was accepted); does not synchronise.
int repro_budget_scan(const void* rows, const void* fresh,
                      const void* col_of_row, const void* time_s,
                      const void* charge_s, double mean_charge,
                      const void* spent0, const void* evals0,
                      const void* max_s, const void* max_e, int runs,
                      long long n, void* accept, void* t_after, void* value,
                      void* charge, void* spent, void* evals,
                      void* exhausted, void* stream) {
  const dim3 grid((runs + kWarps - 1) / kWarps);
  budget_scan_kernel<<<grid, 32 * kWarps, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(rows), static_cast<const uint8_t*>(fresh),
      static_cast<const int32_t*>(col_of_row),
      static_cast<const double*>(time_s), static_cast<const double*>(charge_s),
      mean_charge, static_cast<const double*>(spent0),
      static_cast<const int64_t*>(evals0), static_cast<const double*>(max_s),
      static_cast<const int64_t*>(max_e), runs, static_cast<int64_t>(n),
      static_cast<uint8_t*>(accept), static_cast<double*>(t_after),
      static_cast<double*>(value), static_cast<double*>(charge),
      static_cast<double*>(spent), static_cast<int64_t*>(evals),
      static_cast<uint8_t*>(exhausted));
  return static_cast<int>(cudaGetLastError());
}

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
