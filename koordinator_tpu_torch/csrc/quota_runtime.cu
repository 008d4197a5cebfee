// K18 quota_runtime: the elastic-quota forest's limited demand and its
// fair-share runtime, in one launch.
//
// Replaces koordinator_tpu/ops/waterfill.py:48 propagate_demand and
// :135 compute_runtime with :74 _redistribute_level (elasticquota
// runtime_quota_calculator.go:111-168, level by level):
//
// 1. limited demand, bottom-up: at each depth d = 5 .. 1, every row adds
//    the sum of its depth-d children's clamped subtree demand,
//    clamp(s) = min(max, allow_lent ? s : max(s, min)); the result is
//    clamped once more;
// 2. runtime, top-down: roots get min(max, cluster_total); at each
//    depth d = 1 .. 5 the level's rows start at min (adjusting, where
//    the limited demand exceeds min) or at their demand (min when they
//    do not lend), each parent's remaining = max(runtime - sum of its
//    children's start, 0), then rounds while some parent row has
//    remaining > 0.5 and adjusting weight (at most max_iters):
//    delta = floor(w * rem / max(tw, 1e-9) + 0.5) a live child, a child
//    reaching its demand clamps there and returns the excess, and the
//    returned excess is all its group re-partitions next round;
// 3. runtime = min(runtime, max), +inf on invalid rows.
//
// Exactness: the reference's segment sums are XLA:CPU's scatter-add,
// each parent adding its children in ascending row index from +0; here
// a thread a (parent, column) walks the parent's children in that
// order (the children table is built first, a stable counting pass
// over `parent`). delta rounds as the reference writes it: the product
// (__fmul_rn), an IEEE division (__fdiv_rn), the add (__fadd_rn), the
// floor; -fmad=false keeps nvcc from contracting anything else. max and
// min are XLA's (guard.cuh). A parent outside [0, Q) names no row (the
// reference's dump row); its rows read NaN as the parent's remaining
// and weight, as jnp.take fills.
//
// What bounds it on the H100: neither bytes nor operations. The state
// is a few hundred KB; the rounds are a chain of block-wide steps (a
// level's rounds each sum every parent's children twice), each ending
// in __syncthreads, so the time is the steps' latency. One block is
// the design: the reference runs the loop on the device too, and a
// grid-wide step a round would need a launch or a grid sync a round.
//
// Design: one block of 1024 threads. Shared memory holds the children
// table (offsets, rows, in-range parent and depth a row: 20 bytes a
// row); the [Q, R] state (subtree demand, sums, runtime, the level's
// runtime, remaining, total weight, excess, adjusting) lives in device
// memory the wrapper allocates, read through L1 by the one SM, every
// phase closed by __syncthreads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "guard.cuh"

namespace {

using koord_guard::xla_max;
using koord_guard::xla_min;

constexpr int THREADS = 1024;
constexpr int DEPTH = 6;  // MAX_QUOTA_DEPTH
constexpr int MAX_Q = 4096;
constexpr int MAX_R = 16;

struct Inputs {
  const float* mn;
  const float* mx;
  const float* sw;
  const float* dem;
  const int32_t* parent;
  const int32_t* depth_anc;
  const uint8_t* lent;
  const uint8_t* valid;
  const float* total;
};

struct Tree {
  const int* seg;   // [Q] parent in [0, Q), else Q
  const int* dep;   // [Q] depth, -1 without an ancestor
  const int* off;   // [Q + 2] children of p at kids[off[p] .. off[p + 1])
  const int* kids;  // [Q]
};

__device__ __forceinline__ float weight_of(const Inputs& in, int i) {
  const float s = in.sw[i];
  const float w = s > 0.0f ? s : in.mx[i];
  return koord_guard::finite(w) ? w : 1.0f;
}

__device__ __forceinline__ float clamp_of(const Inputs& in, int q, int i,
                                          float s) {
  const float floored = in.lent[q] ? s : xla_max(s, in.mn[i]);
  return xla_min(floored, in.mx[i]);
}

// Exclusive scan of cnt[0 .. n) into off[0 .. n], all threads of the
// block (n <= MAX_Q + 1): a chunk a thread, then the chunks' totals.
__device__ void block_exclusive_scan(const int* cnt, int* off, int n,
                                     int* part) {
  const int t = threadIdx.x;
  const int per = (n + THREADS - 1) / THREADS;
  const int lo = min(t * per, n), hi = min(lo + per, n);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += cnt[i];
  part[t] = s;
  __syncthreads();
  if (t == 0) {
    int run = 0;
    for (int k = 0; k < THREADS; ++k) {
      const int v = part[k];
      part[k] = run;
      run += v;
    }
    off[n] = run;
  }
  __syncthreads();
  int run = part[t];
  for (int i = lo; i < hi; ++i) {
    off[i] = run;
    run += cnt[i];
  }
  __syncthreads();
}

// The sum of v(child row k) over p's children in ascending row index,
// from +0 (the reference's scatter-add).
template <class F>
__device__ __forceinline__ float child_sum(const Tree& t, int p, F v) {
  float s = 0.0f;
  for (int k = t.off[p]; k < t.off[p + 1]; ++k) s = __fadd_rn(s, v(t.kids[k]));
  return s;
}

__global__ void __launch_bounds__(THREADS) quota_runtime_kernel(
    Inputs in, int Q, int R, int max_iters, int demand_only,
    float* __restrict__ limited, float* __restrict__ runtime_out,
    int32_t* __restrict__ rounds, float* __restrict__ scratch,
    uint8_t* __restrict__ adj) {
  extern __shared__ int smem[];
  int* seg = smem;                 // [Q]
  int* dep = seg + Q;              // [Q]
  int* cnt = dep + Q;              // [Q + 1]
  int* off = cnt + Q + 1;          // [Q + 2]
  int* kids = off + Q + 2;         // [Q]
  int* part = kids + Q;            // [THREADS]
  const int t = threadIdx.x;
  const int QR = Q * R;
  float* sub = scratch;            // subtree demand
  float* con = sub + QR;           // children's sums
  float* rt = con + QR;            // runtime of the levels so far
  float* lvl = rt + QR;            // the level's runtime
  float* rem = lvl + QR;           // remaining, by parent row
  float* tws = rem + QR;           // total adjusting weight, by parent row
  float* exc = tws + QR;           // excess returned this round

  // --- the children table: a stable counting pass over parent ----------
  for (int q = t; q < Q; q += THREADS) {
    const int p = in.parent[q];
    seg[q] = (p >= 0 && p < Q) ? p : Q;
    int n = 0;
    for (int j = 0; j < DEPTH; ++j) n += in.depth_anc[q * DEPTH + j] >= 0;
    dep[q] = n - 1;
  }
  for (int p = t; p <= Q; p += THREADS) cnt[p] = 0;
  __syncthreads();
  for (int q = t; q < Q; q += THREADS) atomicAdd(&cnt[seg[q]], 1);
  __syncthreads();
  block_exclusive_scan(cnt, off, Q + 1, part);
  for (int p = t; p <= Q; p += THREADS) cnt[p] = 0;  // placed so far
  __syncthreads();
  for (int base = 0; base < Q; base += THREADS) {
    const int q = base + t;
    if (q < Q) {
      const int s = seg[q];
      int r = 0;
      for (int k = base; k < q; ++k) r += seg[k] == s;
      kids[off[s] + cnt[s] + r] = q;
    }
    __syncthreads();
    if (q < Q) atomicAdd(&cnt[seg[q]], 1);
    __syncthreads();
  }
  const Tree tree{seg, dep, off, kids};

  // --- 1. limited demand, bottom-up ------------------------------------
  for (int i = t; i < QR; i += THREADS) sub[i] = in.dem[i];
  __syncthreads();
  for (int d = DEPTH - 1; d >= 1; --d) {
    for (int i = t; i < QR; i += THREADS) {
      const int p = i / R, c = i - p * R;
      con[i] = child_sum(tree, p, [&](int k) {
        const int j = k * R + c;
        return dep[k] == d ? clamp_of(in, k, j, sub[j]) : 0.0f;
      });
    }
    __syncthreads();
    for (int i = t; i < QR; i += THREADS) sub[i] = __fadd_rn(sub[i], con[i]);
    __syncthreads();
  }
  for (int i = t; i < QR; i += THREADS)
    limited[i] = clamp_of(in, i / R, i, sub[i]);
  __syncthreads();
  if (demand_only) return;

  // --- 2. runtime, top-down --------------------------------------------
  for (int i = t; i < QR; i += THREADS) {
    const int q = i / R, c = i - q * R;
    rt[i] = (in.valid[q] && dep[q] == 0) ? xla_min(in.mx[i], in.total[c])
                                         : 0.0f;
  }
  __syncthreads();
  for (int d = 1; d < DEPTH; ++d) {
    for (int i = t; i < QR; i += THREADS) {
      const int q = i / R;
      const bool on = in.valid[q] && dep[q] == d;
      const float dm = limited[i], mn = in.mn[i];
      const bool a = on && dm > mn;
      const float r0 = a ? mn : (in.lent[q] ? xla_min(dm, mn) : mn);
      adj[i] = a;
      lvl[i] = on ? r0 : 0.0f;
    }
    __syncthreads();
    for (int i = t; i < QR; i += THREADS) {
      const int p = i / R, c = i - p * R;
      const float spent = child_sum(tree, p, [&](int k) {
        return lvl[k * R + c];
      });
      rem[i] = xla_max(__fsub_rn(rt[i], spent), 0.0f);
    }
    __syncthreads();
    int it = 0;
    for (;; ++it) {
      bool want = false;
      for (int i = t; i < QR; i += THREADS) {
        const int p = i / R, c = i - p * R;
        const float tw = child_sum(tree, p, [&](int k) {
          const int j = k * R + c;
          return adj[j] ? weight_of(in, j) : 0.0f;
        });
        tws[i] = tw;
        want |= rem[i] > 0.5f && tw > 0.0f;
      }
      want = __syncthreads_or(want);
      if (!(it < max_iters && want)) break;
      for (int i = t; i < QR; i += THREADS) {
        const int q = i / R, c = i - q * R;
        const bool a = adj[i];
        const float w = a ? weight_of(in, i) : 0.0f;
        const int pp = max(in.parent[q], 0);
        const float tw = pp < Q ? tws[pp * R + c] : NAN;
        const float rm = pp < Q ? rem[pp * R + c] : NAN;
        const bool live = a && tw > 0.0f && rm > 0.5f;
        const float delta =
            live ? floorf(__fadd_rn(
                       __fdiv_rn(__fmul_rn(w, rm), xla_max(tw, 1e-9f)), 0.5f))
                 : 0.0f;
        const float nr = __fadd_rn(lvl[i], delta);
        const float dm = limited[i];
        const bool over = live && nr >= dm;
        exc[i] = over ? __fsub_rn(nr, dm) : 0.0f;
        lvl[i] = over ? dm : nr;
        adj[i] = a && !over;
      }
      __syncthreads();
      for (int i = t; i < QR; i += THREADS) {
        if (rem[i] > 0.5f && tws[i] > 0.0f) {
          const int p = i / R, c = i - p * R;
          rem[i] = child_sum(tree, p, [&](int k) { return exc[k * R + c]; });
        }
      }
      __syncthreads();
    }
    if (t == 0) rounds[d] = it;
    for (int i = t; i < QR; i += THREADS) {
      const int q = i / R;
      if (in.valid[q] && dep[q] == d) rt[i] = lvl[i];
    }
    __syncthreads();
  }

  // --- 3. clamp by max; invalid rows never gate --------------------------
  for (int i = t; i < QR; i += THREADS) {
    const int q = i / R;
    runtime_out[i] = in.valid[q] ? xla_min(rt[i], in.mx[i]) : INFINITY;
  }
}

}  // namespace

// min, max, shared_weight, demand f32[Q, R]; parent i32[Q];
// depth_ancestor i32[Q, 6]; allow_lent, valid bool[Q]; total f32[R]
// (read unless demand_only); writes limited f32[Q, R], runtime f32[Q, R]
// (unless demand_only) and rounds i32[6] (the rounds each level ran;
// zeroed by the caller). scratch: f32[7, Q, R]; adjusting: u8[Q, R].
extern "C" int koord_quota_runtime(
    const void* mn, const void* mx, const void* sw, const void* dem,
    const void* parent, const void* depth_anc, const void* lent,
    const void* valid, int Q, int R, int max_iters, int demand_only,
    const void* total, void* limited, void* runtime, void* rounds,
    void* scratch, void* adjusting, void* stream) {
  if (Q <= 0 || Q > MAX_Q || R <= 0 || R > MAX_R || max_iters < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(5 * Q + 3 + THREADS) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      quota_runtime_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Inputs in{(const float*)mn,         (const float*)mx,
                  (const float*)sw,         (const float*)dem,
                  (const int32_t*)parent,   (const int32_t*)depth_anc,
                  (const uint8_t*)lent,     (const uint8_t*)valid,
                  (const float*)total};
  quota_runtime_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      in, Q, R, max_iters, demand_only, (float*)limited, (float*)runtime,
      (int32_t*)rounds, (float*)scratch, (uint8_t*)adjusting);
  return (int)cudaGetLastError();
}
