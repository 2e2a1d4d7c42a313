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
// scan, no reordering. One thread walks one run's segment in order, and
// every add is an explicit round-to-nearest __dadd_rn; the build also
// passes -fmad=false, though an add with no multiply gives FMA contraction
// nothing to fuse.
//
// What bounds it on the H100: it moves bytes and does almost no arithmetic.
// Per entry it reads rows (8 B) and fresh (1 B) and writes accept (1 B),
// t_after, value and charge (8 B each); the tables are read through a
// gather. At R=1024 runs x N=10,140 rows that is about 0.35 GB, ~0.1 ms at
// 3.35 TB/s. This simple design is far from that: one thread per run
// means at most R threads in flight (1024 threads fill under 8 of the 132
// SMs), each walking N dependent steps, with lanes of a warp touching
// addresses N elements apart. It is latency-bound, and stays so here on
// purpose: a first kernel that is right. Splitting the gathers off the
// dependent chain, a run-major layout for coalescing, and more runs per
// launch are later work.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;

__global__ void budget_scan_kernel(
    const int64_t* __restrict__ rows, const uint8_t* __restrict__ fresh,
    const int32_t* __restrict__ col_of_row, const double* __restrict__ time_s,
    const double* __restrict__ charge_s, double mean_charge,
    const double* __restrict__ spent0, const int64_t* __restrict__ evals0,
    const double* __restrict__ max_s, const int64_t* __restrict__ max_e,
    int runs, int64_t n, uint8_t* __restrict__ accept,
    double* __restrict__ t_after, double* __restrict__ value,
    double* __restrict__ charge, double* __restrict__ spent_out,
    int64_t* __restrict__ evals_out, uint8_t* __restrict__ exhausted) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= runs) return;
  double spent = spent0[r];
  int64_t evals = evals0[r];
  const double cap_s = max_s[r];
  const int64_t cap_e = max_e[r];
  bool exh = false;
  const int64_t base = static_cast<int64_t>(r) * n;
  for (int64_t j = 0; j < n; ++j) {
    const int64_t idx = base + j;
    const int32_t col = col_of_row[rows[idx]];
    const double v = col < 0 ? HUGE_VAL : time_s[col];
    const double c = col < 0 ? mean_charge : charge_s[col];
    const bool f = fresh[idx] != 0;
    const bool commit = f && spent < cap_s && evals < cap_e;
    if (commit) {
      spent = __dadd_rn(spent, c);
      evals += 1;
    }
    exh = exh || (f && !commit);
    accept[idx] = commit;
    t_after[idx] = spent;
    value[idx] = v;
    charge[idx] = c;
  }
  spent_out[r] = spent;
  evals_out[r] = evals;
  exhausted[r] = exh;
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
  const dim3 grid((runs + kThreads - 1) / kThreads);
  budget_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
