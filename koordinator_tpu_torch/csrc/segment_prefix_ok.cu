// K2 segment_prefix_ok, chained: the node gate and every quota level of
// one inner commit step in one launch.
//
// Replaces koordinator_tpu/scheduler/batching.py segment_prefix_ok as
// schedule_batch calls it in every inner commit step: once for node
// capacity (core.py:768) and then once per quota level (core.py:891),
// each level seeing only the pods that passed the levels before it. On
// the TPU each call is a masked [P, P] x [P, R] matmul, because sorts are
// slow there; XLA runs it on the matrix unit. Per level l, for the pods
// still alive (alive starts as `active`):
//
//   ok[p] = all_r( base_l[seg_l[p], r] + sum_{q alive: seg_l[q] == seg_l[p],
//                                               rank[q] < rank[p]} req[q, r]
//                  + req[p, r] <= limit_l[seg_l[p], r] + eps )
//           or seg_l[p] >= S_l            (out of range = not gated here)
//   alive[p] &= ok[p]
//
// and the result is alive. An optional mask [P] (the step's pod topology
// verdict, K8) is ANDed into alive after level 0: in the reference the
// topology gates sit between the node gate and the quota levels
// (core.py:768, :776-884, :886-891), so the node level charges every
// trying pod and the quota levels only those that pass both. A pod with
// seg -1 checks against row 0 but
// counts only with the other -1 pods, as in the reference. The requests
// are one [P, R] array shared by the levels (node and quota levels), or
// one a level (the zone gates of a NUMA step, core.py:949-956, where
// level z gates each pod's take in zone z, with segments = the chosen
// node: level z reads the columns of zone z of the take [P, Z, R] in
// place, a level stride and a row stride); a level's base and limit are
// [S_l, R] with a row stride of their own (a zone's columns of the
// [S, Z * R] zone table).
//
// What bounds it on the H100: neither bytes (a few tens of KB) nor
// operations (a few thousand additions): a launch does microseconds of
// work at flagship sizes, so the launches themselves and the chain of
// levels (each waits on the one before) set its time. So one launch
// does every level.
//
// Design: one block of 512 threads (2048 pods a tile). The pods sit in rank
// order (rank is a permutation of [0, P)). Per level, a block scan
// counts the alive pods with a segment in range, in rank order; the
// others take no part in the level's sums, and a level where none is
// in range is skipped. Then, by the n pods in range:
// - n <= SMALL (288 at R = 4, 72 otherwise: the late steps of a round,
//   few pods still trying): the pods are compacted in rank order, with
//   their segments and requests, into shared memory, and each pod's
//   thread sums the requests of the earlier pods of its segment, O(n)
//   a pod from shared memory, no sort;
// - n > SMALL: a block radix sort (cub::BlockRadixSort, stable, over
//   the key's bits only, four keys a thread; the key is seg + 1, and a
//   key past every segment for the pods not in range, which the sort
//   carries along) groups each segment with its pods still in rank
//   order; a segmented scan (in registers over a thread's pods,
//   shuffles across a warp, the warps' trailing segments through
//   shared memory; four columns a pass, each pod's request and its
//   segment's base and limit read beside it, 16 bytes at a time where
//   R is a multiple of 4) gives each pod the sum of its earlier
//   same-segment pods. O(P log P) a level instead of O(P^2).
// Each pod compares and a failing pod drops out of the next level. req
// stays in device memory on the sorted path (read through the cache):
// a copy in shared memory, gathered in rank order, cost more than it
// saved at the flagship's R = 4.
//
// Above 2048 pods (the tiled form, a BASELINE config 4 chunk of 2500
// or a service batch): the same block walks the rank order a tile of
// 2048 positions at a time, each tile through every level as above.
// A pod's verdict at a level depends only on the pods of earlier rank
// that enter that level, and every one of those sits in its own tile
// or an earlier one, so the walk keeps the reference's meaning. Each
// level keeps, in device memory, a carry a segment (S + 1 rows, the
// -1 segment's included): the requests of the pods of earlier tiles
// that entered the level with that segment. A pod's prefix is its
// segment's carry plus its earlier same-segment pods of the tile, and
// the last pod of each segment in the tile writes the new carry (its
// prefix plus its own request), after every read of the tile. The
// rank order, the pods' alive flags (in `out`) and the carries live in
// device memory; one block orders them with its barriers. The path up
// to 2048 pods is the one above, unchanged.
//
// Preconditions, checked in the kernel: rank is a permutation of
// [0, P) and every alive pod's segment is >= -1. A launch that finds
// either broken stops with __trap(): the launch fails and the caller
// sees the CUDA error at its next synchronisation, rather than a gate
// that silently passed pods the reference would have gated.
//
// Exactness: the scan's summation order is not the reference's (the
// tiled form adds a carry first, then the tile's prefix). `exact` is a
// flag on the device that says whether the launch's sums are exact in
// any order, by the order switch's rule (kernels/segment_prefix.py
// exact_in_any_order states it; `switch_verdict` below): the caller
// passes it where the scheduler decided it once a batch for the
// requests fixed for the batch, or the launch decides it itself on its
// own request arrays before level 0 (the step's GPU, zone and amplified
// levels), with no host sync and no launch of its own. The scheduler's workloads
// meet it (requests are multiples of 500 mC and 512 MiB, whole GPU and
// aux percents), and such a launch runs the scan. Any other launch
// (fractional requests, fault C7) runs the pinned form instead: every
// level, each pod's thread walks the pods in index order and adds its
// earlier same-segment pods' requests in XLA:CPU's order of the
// reference's `mask @ req` (kernels/_xla.py xla_mask_dot states the
// rule: four lanes by j mod 4 folded as (l0 + l1) + (l2 + l3) plus the
// tail summed on its own, index order below 8 pods; at R = 1 the fused
// loop's form, a function of P: `pinned_sum1`), then adds base + sum +
// request as the reference does. It is O(P^2) a level on one block, and
// only fractional inputs pay it. The comparison itself keeps the
// reference's order of additions in both forms.

#include <cub/block/block_radix_sort.cuh>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 4;  // pods a thread, consecutive in rank/sorted order
constexpr int MAX_P = THREADS * ITEMS;
constexpr int MAX_R = 11;  // NUM_RESOURCES
constexpr int COLS = 4;    // columns a scan pass
constexpr int MAX_LEVELS = 8;
// at most this many pods in range (a quarter where R != 4): no sort.
// The unsorted sums cost O(n^2) reads; on the H100 they beat a level's
// sort up to about 300 pods at R = 4 (python -m
// koordinator_tpu_torch.sweep_k2).
constexpr int SMALL = 288;
constexpr int PAD = 8;      // pods the unsorted sums read past n
constexpr unsigned FULL = 0xffffffffu;

struct Levels {
  const float* req[MAX_LEVELS];  // [P, R] of the level, rows rstride apart
  const float* base[MAX_LEVELS];
  const float* limit[MAX_LEVELS];
  float* carry[MAX_LEVELS];  // tiled form: [S + 1, R], row seg + 1
  int S[MAX_LEVELS];
  int stride[MAX_LEVELS];  // row stride of base and limit
  int rstride;             // row stride of every level's req
};

// 5 key bits a pass: 3 passes for 10^4 node segments, 2 for quotas
// (7 bits a pass, 2 and 1, measured slower: the counters' scan grows
// with the digits)
using Sort = cub::BlockRadixSort<uint32_t, THREADS, ITEMS, int, 5>;

// A level's shared memory: the sort's, or where few pods are in range,
// those pods compacted in rank order with their requests (the tiled
// form's pod ids take 32 bits).
template <bool TILED>
union LevelStorage {
  Sort::TempStorage sort;
  struct __align__(16) {
    int seg[MAX_P];                      // n, then PAD sentinels
    float req[(SMALL + PAD) * MAX_R];    // [n][R], then zeros
    std::conditional_t<TILED, int32_t, int16_t> pod[MAX_P];
  } in;
};

constexpr int JT = 256;  // pods a staged tile of the pinned form

// Stage the pinned form's tile [j0, j0 + JT) of level l in shared
// memory: each pod's segment (INT_MIN where it is not alive or past P),
// rank and request row. Every thread of the block calls it.
__device__ __forceinline__ void stage_tile(
    const int32_t* seg, const int32_t* rank, const float* req,
    const uint8_t* alive, int rstride, int l, int P, int R, int j0,
    int* seg_s, int* rank_s, float* req_s) {
  __syncthreads();  // the previous tile is read
  for (int jj = threadIdx.x; jj < JT; jj += blockDim.x) {
    const int j = j0 + jj;
    seg_s[jj] = j < P && alive[j] ? seg[(size_t)l * P + j] : INT_MIN;
    rank_s[jj] = j < P ? rank[j] : 0;
    for (int r = 0; r < R; ++r)
      req_s[jj * R + r] = j < P ? req[(size_t)j * rstride + r] : 0.0f;
  }
  __syncthreads();
}

// The pinned form's sum for one pod, R >= 2 (NR: R <= NR): four lanes
// by j mod 4 over j < q, the tail j >= q summed on its own, over the
// staged tile [j0, j0 + JT) of (segment or INT_MIN where not alive,
// rank, request). q is 4 * (P / 4), or 0 below 8 pods.
template <int NR>
__device__ __forceinline__ void pinned_tile(
    const int* seg_s, const int* rank_s, const float* req_s, int j0, int P,
    int q, int R, int si, int ri, float (&acc)[4][NR], float (&tail)[NR]) {
  for (int g = 0; g < JT; g += 4) {
    const int jg = j0 + g;
    if (jg >= P) break;
    if (jg < q) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (seg_s[g + u] == si && rank_s[g + u] < ri) {
#pragma unroll
          for (int r = 0; r < NR; ++r)
            if (r < R)
              acc[u][r] = __fadd_rn(acc[u][r], req_s[(g + u) * R + r]);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (jg + u < P && seg_s[g + u] == si && rank_s[g + u] < ri) {
#pragma unroll
          for (int r = 0; r < NR; ++r)
            if (r < R) tail[r] = __fadd_rn(tail[r], req_s[(g + u) * R + r]);
        }
      }
    }
  }
}

// The first w (4 or 8) lanes of v folded in halves: lane l + lane
// l + w/2 until one is left.
__device__ __forceinline__ float fold_halves(float (&v)[8], int w) {
  if (w == 8) {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __fadd_rn(v[k], v[k + 4]);
  }
  return __fadd_rn(__fadd_rn(v[0], v[2]), __fadd_rn(v[1], v[3]));
}

// The pinned form's sum for pod i at R = 1 (segment si, rank ri), read
// from device memory: the terms t(j) = m * req[j], m = 1 for an alive
// earlier pod of the same segment, else 0, added in the order of
// kernels/_xla.py _fused_matvec (its docstring states the rule; the
// form by P is fused_matvec_form): index order below 28 pods; XLA's
// tiled gemv from 4096; between, vf-wide chunks in ic accumulators,
// kept apart (a loop, from 320 pods) or folded into one chain (the loop
// unrolled whole), then the lanes in halves, a vector epilogue of width
// 8 or 4 and the last terms one at a time.
__device__ float pinned_sum1(const int32_t* seg_l, const int32_t* rank,
                             const float* req, int rstride,
                             const uint8_t* alive, int P, int i, int si,
                             int ri) {
  auto t = [&](int j) {
    const bool m = alive[j] && seg_l[j] == si && rank[j] < ri;
    return __fmul_rn(m ? 1.0f : 0.0f, req[(size_t)j * rstride]);
  };
  float out = 0.0f;
  if (P < 28) {
    for (int j = 0; j < P; ++j) out = __fadd_rn(out, t(j));
    return out;
  }
  if (P >= 4096) {
    const int q = P / 8 * 8;
    float a[8] = {};
    for (int j = 0; j < q; j += 8) {
#pragma unroll
      for (int l = 0; l < 8; ++l) a[l] = __fadd_rn(a[l], t(j + l));
    }
    if (i < q)
      out = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), __fadd_rn(a[2], a[3])),
                      __fadd_rn(__fadd_rn(a[4], a[5]), __fadd_rn(a[6], a[7])));
    else
      out = fold_halves(a, 8);
    float tail = 0.0f;
    for (int j = q; j < P; ++j) tail = __fadd_rn(tail, t(j));
    return __fadd_rn(out, tail);
  }
  const int vf = P < 32 ? 4 : 8;
  const int ic = P < 32 || (P >= 48 && P < 64) ? 2 : 4;
  const int step = vf * ic, n = P / step;
  float v[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) v[l] = l ? -0.0f : 0.0f;
  auto add = [&](float (&acc)[8], int k, int u) {
    const int j = step * k + vf * u;
#pragma unroll
    for (int l = 0; l < 8; ++l)
      if (l < vf) acc[l] = __fadd_rn(acc[l], t(j + l));
  };
  if (P < 320) {  // the loop unrolled whole: one chain
    for (int k = 0; k < n; ++k) add(v, k, 0);
    for (int u = 1; u < ic; ++u) {
      if (n > 1) {
        add(v, 1, u);
        add(v, 0, u);
        for (int k = 2; k < n; ++k) add(v, k, u);
      } else {
        add(v, 0, u);
      }
    }
  } else {  // four accumulators: ((a1 + a0) + a2) + a3
    float a[3][8];
#pragma unroll
    for (int u = 0; u < 3; ++u)
#pragma unroll
      for (int l = 0; l < 8; ++l) a[u][l] = -0.0f;
    for (int k = 0; k < n; ++k) {
      add(v, k, 0);
      add(a[0], k, 1);
      add(a[1], k, 2);
      add(a[2], k, 3);
    }
#pragma unroll
    for (int l = 0; l < 8; ++l)
      v[l] = __fadd_rn(__fadd_rn(__fadd_rn(a[0][l], v[l]), a[1][l]),
                       a[2][l]);
  }
  out = fold_halves(v, vf);
  int j = n * step;
  if (vf == 8) {
    const int rest = P - j;
    const int w = rest % 8 < 4 ? 8 : 4;
    if (rest >= w) {
      float e[8];
#pragma unroll
      for (int l = 0; l < 8; ++l) e[l] = l ? -0.0f : out;
      for (int c = 0; c < rest / w; ++c, j += w) {
#pragma unroll
        for (int l = 0; l < 8; ++l)
          if (l < w) e[l] = __fadd_rn(e[l], t(j + l));
      }
      out = fold_halves(e, w);
    }
  }
  for (; j < P; ++j) out = __fadd_rn(out, t(j));
  return out;
}

// The pinned form of the whole chain, for every thread of the block: a
// level at a time, each pod's verdict from the alive flags at the
// level's start (held in `verdict`, the rank-order scratch this path
// does not use, until every pod has walked the level), its sum in the
// reference's order; seg_s and req_s: shared memory for a staged tile
// (2 * JT ints, JT * R floats). Out of line, so that its registers do
// not crowd the scan's; `lv` is a copy of the levels in shared memory
// (a reference to the kernel's parameter would put them on every
// thread's stack on the scan's path too).
template <int NR, typename V>
__device__ __noinline__ void pinned_chain(
    const int32_t* seg, const int32_t* rank, const uint8_t* mask,
    const Levels& lv, int L, int P, int R, float eps, uint8_t* alive,
    V* verdict, int* seg_s, float* req_s) {
  const int t = threadIdx.x;
  int* rank_s = seg_s + JT;
  for (int l = 0; l < L; ++l) {
    if (l == 1 && mask != nullptr) {
      for (int i = t; i < P; i += THREADS) alive[i] &= mask[i];
      __syncthreads();
    }
    const int S = lv.S[l];
    const float* req = lv.req[l];
    const int q4 = P >= 8 ? P / 4 * 4 : 0;
    for (int c0 = 0; c0 < P; c0 += THREADS) {
      const int i = c0 + t;
      int si = INT_MIN, ri = 0;
      bool gated = false;
      if (i < P && alive[i]) {
        si = seg[(size_t)l * P + i];
        gated = si < S;
        ri = rank[i];
      }
      float cum[NR] = {};
      if (R == 1) {  // block-uniform, as every branch below
        if (gated)
          cum[0] = pinned_sum1(seg + (size_t)l * P, rank, req, lv.rstride,
                               alive, P, i, si, ri);
      } else {
        float acc[4][NR] = {}, tail[NR] = {};
        for (int j0 = 0; j0 < P; j0 += JT) {
          stage_tile(seg, rank, req, alive, lv.rstride, l, P, R, j0, seg_s,
                     rank_s, req_s);
          if (gated)
            pinned_tile<NR>(seg_s, rank_s, req_s, j0, P, q4, R, si, ri, acc,
                            tail);
        }
#pragma unroll
        for (int r = 0; r < NR; ++r)
          cum[r] = __fadd_rn(__fadd_rn(__fadd_rn(acc[0][r], acc[1][r]),
                                       __fadd_rn(acc[2][r], acc[3][r])),
                             tail[r]);
      }
      bool ok = true;
      if (gated) {
        const size_t o = (size_t)max(si, 0) * lv.stride[l];
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          if (r >= R) continue;
          const float lhs = __fadd_rn(__fadd_rn(lv.base[l][o + r], cum[r]),
                                      req[(size_t)i * lv.rstride + r]);
          ok &= lhs <= __fadd_rn(lv.limit[l][o + r], eps);
        }
      }
      if (i < P) verdict[i] = ok;
    }
    __syncthreads();
    for (int i = t; i < P; i += THREADS) alive[i] &= verdict[i] != 0;
    __syncthreads();
  }
}

// --- the order switch (kernels/segment_prefix.py exact_in_any_order) ---

constexpr int MAX_SWITCH = 4;  // request arrays a switch launch reads

struct SwitchArrays {
  const float* ptr[MAX_SWITCH];
  long long level_stride[MAX_SWITCH];
  int levels[MAX_SWITCH];
  int rows[MAX_SWITCH];
  int row_stride[MAX_SWITCH];
};

// The exponent e of x's lowest set bit (x an odd multiple of 2^e) for
// finite nonzero x; INT_MAX for zero (no constraint), INT_MIN for NaN
// and infinities (no bound holds).
__device__ __forceinline__ int low_bit_exponent(float x) {
  const unsigned bits = __float_as_uint(x);
  const int exp = (bits >> 23) & 0xFF;
  if (exp == 0xFF) return INT_MIN;
  const unsigned mant = exp ? (bits & 0x7FFFFFu) | 0x800000u
                            : bits & 0x7FFFFFu;
  if (mant == 0) return INT_MAX;
  return (exp ? exp - 150 : -149) + __ffs(mant) - 1;
}

// The switch's partials: per array (NA) and column (NC), each warp's
// least low_bit_exponent e and sum of magnitudes.
template <int NA, int NC>
struct SwitchPartials {
  int low[NA][NC][WARPS];
  float sum[NA][NC][WARPS];
};

// Every thread of the block: array m's rows (levels x rows, each at
// level * level_stride + row * row_stride, R <= NC columns) into the
// partials. A thread reads four rows at once, all their loads in
// flight before the first use; each warp's lanes meet by shuffles. A
// barrier must follow before switch_decide.
template <int NA, int NC>
__device__ void switch_add(SwitchPartials<NA, NC>& s, int m,
                           const float* ptr, long long level_stride,
                           int levels, int rows, int row_stride, int R) {
  int low[NC];
  float sum[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    low[c] = INT_MAX;
    sum[c] = 0.0f;
  }
  const int n = levels * rows;
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * THREADS) {
    float x[4][NC];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * THREADS;
      const int l = levels > 1 ? i / rows : 0;
      const float* row = ptr + (size_t)l * level_stride +
                         (size_t)(i - l * rows) * row_stride;
#pragma unroll
      for (int c = 0; c < NC; ++c) x[k][c] = i < n && c < R ? row[c] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int c = 0; c < NC; ++c) {  // a zero is neutral to both
        low[c] = min(low[c], low_bit_exponent(x[k][c]));
        sum[c] = __fadd_rn(sum[c], fabsf(x[k][c]));
      }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c >= R) break;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      low[c] = min(low[c], __shfl_xor_sync(FULL, low[c], d));
      sum[c] = __fadd_rn(sum[c], __shfl_xor_sync(FULL, sum[c], d));
    }
    if (lane == 0) {
      s.low[m][c][warp] = low[c];
      s.sum[m][c][warp] = sum[c];
    }
  }
}

// Every thread, after a barrier that follows every switch_add: the
// verdict on n arrays, the same on every thread (each adds the warps'
// partials itself). True where each column of each array has no
// nonzero request, or e >= -149 and its sum of magnitudes below B =
// 2^(24 + e). The f32 sum, in any order, decides as the plain version's
// exact (f64) sum does: while the exact total stays below B every
// partial sum is a multiple of 2^e below B, which f32 holds exactly;
// once a partial sum reaches B, rounding (which is monotone) keeps it
// and every later sum of nonnegative terms at or above B (or inf). B is
// inf in f32 from e = 104 on, which still decides while the total is
// finite (below 2^128 <= B); a total that overflowed there is counted
// again exactly, in f64, by one thread (the branch is the block's).
template <int NA, int NC>
__device__ __forceinline__ bool switch_decide(const SwitchPartials<NA, NC>& s,
                              const SwitchArrays& a, int n, int R) {
  __shared__ int recount;
  bool ok = true;
#pragma unroll  // a's fields at constant indices: no copy in local memory
  for (int m = 0; m < NA; ++m) {
    if (m >= n) break;
    for (int c = 0; c < R; ++c) {
      int e = INT_MAX;
      float total = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        e = min(e, s.low[m][c][w]);
        total = __fadd_rn(total, s.sum[m][c][w]);
      }
      if (e == INT_MAX) continue;  // nothing but zeros
      bool col = e >= -149 && total < ldexpf(1.0f, 24 + e);
      if (e > 104 && isinf(total)) {
        if (threadIdx.x == 0) {
          double exact = 0.0;
          for (int l = 0; l < a.levels[m]; ++l)
            for (int i = 0; i < a.rows[m]; ++i)
              exact += fabs((double)a.ptr[m][(size_t)l * a.level_stride[m] +
                                             (size_t)i * a.row_stride[m] +
                                             c]);
          recount = exact < ldexp(1.0, 24 + e);
        }
        __syncthreads();
        col = recount;
        __syncthreads();  // recount is read
      }
      ok = ok && col;
    }
  }
  return ok;
}

// The switch over n arrays, every thread of the block; a block barrier
// first where `s` was in use.
template <int NA, int NC>
__device__ __forceinline__ bool switch_verdict(SwitchPartials<NA, NC>& s,
                               const SwitchArrays& a, int n, int R) {
#pragma unroll
  for (int m = 0; m < NA; ++m) {
    if (m >= n) break;
    switch_add(s, m, a.ptr[m], a.level_stride[m], a.levels[m], a.rows[m],
               a.row_stride[m], R);
  }
  __syncthreads();
  return switch_decide(s, a, n, R);
}

// The switch as a launch of its own (a flag decided once a batch).
__global__ void __launch_bounds__(THREADS) order_switch_kernel(
    SwitchArrays a, int n, int R, uint8_t* __restrict__ out) {
  __shared__ SwitchPartials<MAX_SWITCH, MAX_R> s;
  const bool ok = switch_verdict(s, a, n, R);
  if (threadIdx.x == 0) out[0] = ok;
}

// NR: the columns the unsorted path unrolls (R <= NR). TILED: P > MAX_P,
// the rank order walked a tile at a time (order_g [P] and lv.carry in
// device memory, the alive flags in `out`).
template <int NR, bool TILED>
__global__ void __launch_bounds__(THREADS) segment_prefix_chain_kernel(
    const int32_t* __restrict__ seg, const int32_t* __restrict__ rank,
    const uint8_t* __restrict__ active, const uint8_t* __restrict__ mask,
    uint8_t* __restrict__ exact, int decide, const float* req_all,
    long long req_level_stride, int req_levels, const float* req0, Levels lv,
    int L, int P, int R, int vec4, float eps, int32_t* __restrict__ order_g,
    uint8_t* __restrict__ out) {
  using PodIdx = std::conditional_t<TILED, int32_t, int16_t>;
  __shared__ LevelStorage<TILED> sh;
  __shared__ int warp_count[2][WARPS];  // by level parity
  __shared__ int16_t order[TILED ? 1 : MAX_P];  // pod at each rank position
  __shared__ uint8_t alive_s[TILED ? 1 : MAX_P];
  __shared__ int carry_key[WARPS];  // each warp's trailing segment
  __shared__ float carry_sum[WARPS][COLS];
  __shared__ uint32_t first_key[WARPS];  // tiled: each warp's first key
  uint8_t* alive;
  if constexpr (TILED) alive = out; else alive = alive_s;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if constexpr (TILED) {
    for (int i = t; i < P; i += THREADS) order_g[i] = -1;
    __syncthreads();
    for (int i = t; i < P; i += THREADS) {
      const int r = rank[i];
      if (r >= 0 && r < P) order_g[r] = i;
      alive[i] = active[i];
    }
  } else {
    for (int i = t; i < MAX_P; i += THREADS) order[i] = -1;
    __syncthreads();
    for (int i = t; i < P; i += THREADS) {
      const int r = rank[i];
      if (r >= 0 && r < P) order[r] = (int16_t)i;
      alive[i] = active[i];
    }
  }
  __syncthreads();
  // rank is a permutation iff every position below P holds a pod
  bool filled = true;
  for (int i = t; i < P; i += THREADS) {
    if constexpr (TILED) filled &= order_g[i] >= 0;
    else filled &= order[i] >= 0;
  }
  if (!__syncthreads_and(filled)) __trap();

  // sums that are not exact in any order: the pinned form gates every
  // level. The launch reads the flag it was given (decided once a
  // batch), or, with `decide`, decides it here on its request arrays
  // (req_all's every level, and req0) and writes it to `exact`.
  bool scan;
  if (decide) {
    __shared__ SwitchPartials<2, NR> sw;
    SwitchArrays a = {};
    a.ptr[0] = req_all;
    a.level_stride[0] = req_level_stride;
    a.levels[0] = req_levels;
    a.ptr[1] = req0;
    a.levels[1] = 1;
    for (int m = 0; m < 2; ++m) {
      a.rows[m] = P;
      a.row_stride[m] = lv.rstride;
    }
    scan = switch_verdict(sw, a, req0 != nullptr ? 2 : 1, R);
    if (t == 0) *exact = scan;
  } else {
    scan = *exact != 0;
  }
  if (__builtin_expect(!scan, 0)) {
    __shared__ Levels lv_s;
    if (t == 0) lv_s = lv;
    __syncthreads();
    if constexpr (TILED)
      pinned_chain<NR>(seg, rank, mask, lv_s, L, P, R, eps, alive, order_g,
                       sh.in.seg, sh.in.req);
    else
      pinned_chain<NR>(seg, rank, mask, lv_s, L, P, R, eps, alive, order,
                       sh.in.seg, sh.in.req);
  }

  // the tiles of the rank order: one below MAX_P pods
  for (int t0 = 0; scan && t0 < P; t0 += MAX_P) {
  // this thread's pods (blocked: rank order) and their segments, each
  // level's read one level ahead
  int mine[ITEMS], snext[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int pos = t0 + t * ITEMS + k;
    if constexpr (TILED) mine[k] = pos < P ? order_g[pos] : -1;
    else mine[k] = pos < P ? order[pos] : -1;
    snext[k] = L > 0 && mine[k] >= 0 ? seg[mine[k]] : 0;
  }

  for (int l = 0; l < L; ++l) {
    if (l == 1 && mask != nullptr) {
      // after level 0: each pod's owner narrows it, before reading it
      // below (level 0's writes precede its closing barrier)
#pragma unroll
      for (int k = 0; k < ITEMS; ++k)
        if (mine[k] >= 0) alive[mine[k]] &= mask[mine[k]];
    }
    const int S = lv.S[l];
    const float* base = lv.base[l];
    const float* limit = lv.limit[l];
    const float* req = lv.req[l];
    const int stride = lv.stride[l];
    const int rstride = lv.rstride;
    float* const carry = lv.carry[l];  // tiled form only
    int scur[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      scur[k] = snext[k];
      if (l + 1 < L && mine[k] >= 0)
        snext[k] = seg[(size_t)(l + 1) * P + mine[k]];
    }
    // the alive pods in range, to compact in rank order
    int cpod[ITEMS], cseg[ITEMS], cnt = 0;
    bool bad = false;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int p = mine[k];
      const bool a = p >= 0 && alive[p];
      const int s = a ? scur[k] : S;
      bad |= s < -1;
      const bool in = a && s < S;
      cpod[k] = in ? p : -1;
      cseg[k] = s;
      cnt += in;
    }
    // block scan of the counts: shuffles within a warp, the warps'
    // totals through shared memory (a level's barrier orders them; the
    // two parities keep a level's reads apart from the next's writes)
    int inc = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(FULL, inc, d);
      if (lane >= d) inc += up;
    }
    int* wc = warp_count[l & 1];
    if (lane == 31) wc[warp] = inc;
    if (__syncthreads_or(bad)) __trap();
    int n = 0, off = inc - cnt;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int x = wc[w];
      n += x;
      off += w < warp ? x : 0;
    }
    if (n == 0) continue;  // block-uniform: nothing to gate

    // R = 4 reads 16 bytes a request: 4x fewer shared-memory reads
    const bool v4 = NR == 4 && R == 4;
    if (n <= (v4 ? SMALL : SMALL / 4)) {
      // few pods: compact them with their requests into shared memory,
      // then each sums the requests of its earlier same-segment pods,
      // in rank order
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        if (cpod[k] >= 0) {
          sh.in.seg[off] = cseg[k];
          sh.in.pod[off] = (PodIdx)cpod[k];
#pragma unroll
          for (int r = 0; r < NR; ++r)
            if (r < R)
              sh.in.req[off * R + r] = req[(size_t)cpod[k] * rstride + r];
          ++off;
        }
      }
      // past n: segments that match no pod, zero requests
      if (t < PAD) sh.in.seg[n + t] = -2;
      for (int i = n * R + t; i < (n + PAD) * R + MAX_R; i += THREADS)
        sh.in.req[i] = 0.0f;
      __syncthreads();
      bool last = false;  // tiled: this pod ends its segment in the tile
      float incl[NR];     // tiled: its prefix plus its request
      if (t < n) {
        const int s = sh.in.seg[t];
        const size_t o = (size_t)max(s, 0) * stride;
        float bas[NR], lim[NR], acc[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r) {  // in flight during the sums
          bas[r] = base[o + min(r, R - 1)];
          lim[r] = limit[o + min(r, R - 1)];
          acc[r] = 0.0f;
          if constexpr (TILED)  // the earlier tiles' pods of the segment
            acc[r] = carry[(size_t)(s + 1) * R + min(r, R - 1)];
        }
        // B earlier pods at a time, every read first (unconditional,
        // inside the padded copy), then each request times 1 where its
        // pod is earlier and of the same segment, else times 0: exact
        constexpr int B = NR == 4 ? PAD : 2;  // registers: B * NR
        for (int j0 = 0; j0 < t; j0 += B) {
          int sj[B];
          float x[B][NR];
          if constexpr (NR == 4) {
            if (v4) {
              const int4 a4 = *(const int4*)(sh.in.seg + j0);
              const int4 b4 = *(const int4*)(sh.in.seg + j0 + 4);
              sj[0] = a4.x; sj[1] = a4.y; sj[2] = a4.z; sj[3] = a4.w;
              sj[4] = b4.x; sj[5] = b4.y; sj[6] = b4.z; sj[7] = b4.w;
#pragma unroll
              for (int b = 0; b < B; ++b) {
                const float4 q = *(const float4*)(sh.in.req + (j0 + b) * 4);
                x[b][0] = q.x; x[b][1] = q.y; x[b][2] = q.z; x[b][3] = q.w;
              }
            }
          }
          if (!v4) {
#pragma unroll
            for (int b = 0; b < B; ++b) {
              sj[b] = sh.in.seg[j0 + b];
#pragma unroll
              for (int r = 0; r < NR; ++r)
                x[b][r] = sh.in.req[(j0 + b) * R + r];
            }
          }
#pragma unroll
          for (int b = 0; b < B; ++b) {
            const float m = sj[b] == s && j0 + b < t ? 1.0f : 0.0f;
#pragma unroll
            for (int r = 0; r < NR; ++r)
              acc[r] = __fadd_rn(acc[r], __fmul_rn(x[b][r], m));
          }
        }
        bool ok = true;
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const float lhs = __fadd_rn(__fadd_rn(bas[r], acc[r]),
                                      sh.in.req[t * R + r]);
          ok &= (r >= R) | (lhs <= __fadd_rn(lim[r], eps));
        }
        if (!ok) alive[sh.in.pod[t]] = 0;
        if constexpr (TILED) {
          // the segment's last pod of the tile carries it on, after
          // every pod of the tile read the carry (the barrier below)
          last = true;
          for (int j = t + 1; j < n; ++j) last &= sh.in.seg[j] != s;
#pragma unroll
          for (int r = 0; r < NR; ++r)
            incl[r] = __fadd_rn(acc[r], sh.in.req[t * R + r]);
        }
      }
      __syncthreads();
      if constexpr (TILED) {
        if (last) {
          const int s = sh.in.seg[t];
#pragma unroll
          for (int r = 0; r < NR; ++r)
            if (r < R) carry[(size_t)(s + 1) * R + r] = incl[r];
        }
      }
      continue;
    }

    // many pods: in rank order, key seg + 1 for the pods in range, a
    // key past every segment for the others
    const uint32_t out_key = (uint32_t)S + 1u;
    uint32_t key[ITEMS];
    int pod[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      key[k] = cpod[k] >= 0 ? (uint32_t)(cseg[k] + 1) : out_key;
      pod[k] = cpod[k];
    }
    const int bits = 32 - __clz((int)out_key);
    Sort(sh.sort).Sort(key, pod, 0, bits);  // stable: rank order kept
    if constexpr (TILED) {
      if (lane == 0) first_key[warp] = key[0];  // read after a barrier
    }

    bool ok[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) ok[k] = true;
    for (int r0 = 0; r0 < R; r0 += COLS) {
      // this thread's pods' requests in columns [r0, r0 + COLS)
      // (every read unconditional, from a valid address, then masked:
      // all of them in flight together)
      // and the base and limit of their segments (out-of-range pods and
      // columns read row 0 and mask the result; where R is a multiple of
      // 4, each row's 4 columns in one 16-byte read)
      float v[ITEMS][COLS], lim[ITEMS][COLS], bas[ITEMS][COLS];
      float cr[ITEMS][COLS];  // tiled: the segment's carry
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const bool in = key[k] != out_key;
        if constexpr (TILED) {
#pragma unroll
          for (int c = 0; c < COLS; ++c)
            cr[k][c] = in ? carry[(size_t)key[k] * R + min(r0 + c, R - 1)]
                          : 0.0f;
        }
        const size_t o =
            (size_t)(in ? max((int)key[k] - 1, 0) : 0) * stride;
        const size_t q = (size_t)max(pod[k], 0) * rstride;
        if (vec4) {
          const float4 x4 = *(const float4*)(req + q + r0);
          const float4 b4 = *(const float4*)(base + o + r0);
          const float4 l4 = *(const float4*)(limit + o + r0);
          v[k][0] = x4.x; v[k][1] = x4.y; v[k][2] = x4.z; v[k][3] = x4.w;
          bas[k][0] = b4.x; bas[k][1] = b4.y; bas[k][2] = b4.z;
          bas[k][3] = b4.w;
          lim[k][0] = l4.x; lim[k][1] = l4.y; lim[k][2] = l4.z;
          lim[k][3] = l4.w;
        } else {
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            const int rc = min(r0 + c, R - 1);
            v[k][c] = req[q + rc];
            bas[k][c] = base[o + rc];
            lim[k][c] = limit[o + rc];
          }
        }
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          v[k][c] = in && r0 + c < R ? v[k][c] : 0.0f;
      }
      // segmented inclusive scan: over the thread's pods, across the
      // warp (shuffles), across the warps (their trailing segments)
      float inc[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) inc[c] = v[0][c];
#pragma unroll
      for (int k = 1; k < ITEMS; ++k)
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          inc[c] = key[k] == key[k - 1] ? __fadd_rn(inc[c], v[k][c])
                                        : v[k][c];
      int ikey = (int)key[ITEMS - 1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int ukey = __shfl_up_sync(FULL, ikey, off);
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const float up = __shfl_up_sync(FULL, inc[c], off);
          if (lane >= off && ukey == ikey) inc[c] = __fadd_rn(up, inc[c]);
        }
      }
      int pkey = __shfl_up_sync(FULL, ikey, 1);
      float pre[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) pre[c] = __shfl_up_sync(FULL, inc[c], 1);
      if (lane == 0) pkey = -1;
      if (lane == 31) {
        carry_key[warp] = ikey;
#pragma unroll
        for (int c = 0; c < COLS; ++c) carry_sum[warp][c] = inc[c];
      }
      __syncthreads();
      int wkey = -1;  // the trailing segment of the warps before this one
      float wsum[COLS] = {};
#pragma unroll
      for (int w = 0; w < WARPS - 1; ++w) {
        if (w < warp) {
          const bool same = carry_key[w] == wkey;
          wkey = carry_key[w];
#pragma unroll
          for (int c = 0; c < COLS; ++c)
            wsum[c] = same ? __fadd_rn(wsum[c], carry_sum[w][c])
                           : carry_sum[w][c];
        }
      }
      if (pkey == -1 || pkey == wkey) {  // lanes before: one segment
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          pre[c] = pkey == -1 ? wsum[c] : __fadd_rn(wsum[c], pre[c]);
        pkey = wkey;
      }
      // tiled: the key after each of this thread's pods (the next
      // thread's first, the next warp's first at a warp's end)
      uint32_t nxt = __shfl_down_sync(FULL, key[0], 1);
      if constexpr (TILED) {
        if (lane == 31) nxt = warp + 1 < WARPS ? first_key[warp + 1] : ~0u;
      }
      // each pod's exclusive prefix, then its comparison
      float ex[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        ex[c] = pkey == (int)key[0] ? pre[c] : 0.0f;
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        if (k > 0) {
#pragma unroll
          for (int c = 0; c < COLS; ++c)
            ex[c] = key[k] == key[k - 1] ? __fadd_rn(ex[c], v[k - 1][c])
                                         : 0.0f;
        }
        const bool in = key[k] != out_key;
        // the segment's last pod of the tile carries it on (every read
        // of the carries precedes the barrier above)
        const bool last = TILED && in && (k + 1 < ITEMS ? key[k + 1] : nxt)
                                              != key[k];
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const float pre_c = TILED ? __fadd_rn(cr[k][c], ex[c]) : ex[c];
          const float lhs = __fadd_rn(__fadd_rn(bas[k][c], pre_c), v[k][c]);
          const bool pass = lhs <= __fadd_rn(lim[k][c], eps);
          ok[k] = ok[k] & (pass | !in | (r0 + c >= R));
          if (last && r0 + c < R)
            carry[(size_t)key[k] * R + r0 + c] = __fadd_rn(pre_c, v[k][c]);
        }
      }
      __syncthreads();  // the carries are read before the next pass
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      if (key[k] != out_key && !ok[k]) alive[pod[k]] = 0;
    __syncthreads();
  }
  }  // the tiles
  if constexpr (TILED) {
    if (L == 1 && mask != nullptr)
      for (int i = t; i < P; i += THREADS) out[i] = out[i] && mask[i];
  } else {
    for (int i = t; i < P; i += THREADS)
      out[i] = alive[i] && (L != 1 || mask == nullptr || mask[i]);
  }
}

}  // namespace

// The order switch: n (<= 4) request arrays of R (<= 11) columns, array
// m at ptrs[m] with levels[m] levels level_strides[m] elements apart,
// rows[m] rows row_strides[m] apart and unit column stride; out: bool[1]
// on the device.
extern "C" int koord_order_switch(const void* const* ptrs,
                                  const long long* level_strides,
                                  const int* levels, const int* rows,
                                  const int* row_strides, int n, int R,
                                  void* out, void* stream) {
  if (n < 0 || n > MAX_SWITCH || R <= 0 || R > MAX_R)
    return (int)cudaErrorInvalidValue;
  SwitchArrays a = {};
  for (int m = 0; m < n; ++m) {
    if (levels[m] < 0 || rows[m] < 0 || level_strides[m] < 0 ||
        (rows[m] > 1 && row_strides[m] < R))
      return (int)cudaErrorInvalidValue;
    a.ptr[m] = (const float*)ptrs[m];
    a.level_stride[m] = level_strides[m];
    a.levels[m] = levels[m];
    a.rows[m] = rows[m];
    a.row_stride[m] = row_strides[m];
  }
  order_switch_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      a, n, R, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// req: level l's [P, R] requests start req_level_stride * l elements in
// (0: shared by the levels), rows req_row_stride (>= R) apart, unit
// column stride; req0: level 0's own [P, R] requests (rows as req's),
// or null; strides: each level's row stride of base and limit (>= R).
// mask: bool[P] ANDed in after level 0, or null. exact: bool[1] on the
// device, true where the launch's sums are exact in any order (the
// scan), false for the pinned form; with `decide`, the launch decides it
// on its own request arrays (req's every level, and req0) by the order
// switch's rule and writes it there. work: above MAX_P
// pods, int32 scratch of P + sum over levels of (nseg[l] + 1) * R
// elements (the rank order, then each level's carries, zeroed here on
// the stream); else unused.

extern "C" int koord_segment_prefix_chain(
    const void* seg, const void* rank, const void* req, const void* req0,
    const void* active, const void* mask, void* exact, int decide,
    const void* const* bases,
    const void* const* limits, const int* nseg, const int* strides, int L,
    int P, int R, long long req_level_stride, int req_row_stride, float eps,
    void* work, void* out, void* stream) {
  if (P <= 0) return 0;
  if (R > MAX_R || R <= 0 || L < 0 || L > MAX_LEVELS ||
      (P > MAX_P && work == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((P > 1 && req_row_stride < R) || req_level_stride < 0 ||
      exact == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool tiled = P > MAX_P;
  cudaStream_t st = (cudaStream_t)stream;
  Levels lv = {};
  lv.rstride = req_row_stride;
  int vec4 = R % 4 == 0 && req_row_stride % 4 == 0;
  float* carry = tiled ? (float*)((int32_t*)work + P) : nullptr;
  for (int l = 0; l < L; ++l) {
    if (nseg[l] <= 0 || (nseg[l] > 1 && strides[l] < R))
      return (int)cudaErrorInvalidValue;
    lv.req[l] = l == 0 && req0 != nullptr
                    ? (const float*)req0
                    : (const float*)req + (size_t)l * req_level_stride;
    lv.base[l] = (const float*)bases[l];
    lv.limit[l] = (const float*)limits[l];
    lv.S[l] = nseg[l];
    lv.stride[l] = strides[l];
    if (tiled) {
      lv.carry[l] = carry;
      carry += (size_t)(nseg[l] + 1) * R;
    }
    vec4 = vec4 && strides[l] % 4 == 0 && ((uintptr_t)lv.req[l] & 15) == 0
           && ((uintptr_t)lv.base[l] & 15) == 0
           && ((uintptr_t)lv.limit[l] & 15) == 0;
  }
  if (tiled) {
    const size_t bytes =
        (size_t)((char*)carry - (char*)((int32_t*)work + P));
    const cudaError_t e =
        cudaMemsetAsync((int32_t*)work + P, 0, bytes, st);
    if (e != cudaSuccess) return (int)e;
  }
#define KOORD_K2_LAUNCH(NR, TILED)                                          \
  segment_prefix_chain_kernel<NR, TILED><<<1, THREADS, 0, st>>>(            \
      (const int32_t*)seg, (const int32_t*)rank, (const uint8_t*)active,     \
      (const uint8_t*)mask, (uint8_t*)exact, decide, (const float*)req,     \
      req_level_stride, req_level_stride > 0 ? L : 1, (const float*)req0,   \
      lv, L, P, R, vec4,                                                    \
      eps, (int32_t*)work, (uint8_t*)out)
  if (R <= 4) {
    if (tiled) KOORD_K2_LAUNCH(4, true);
    else KOORD_K2_LAUNCH(4, false);
  } else {
    if (tiled) KOORD_K2_LAUNCH(MAX_R, true);
    else KOORD_K2_LAUNCH(MAX_R, false);
  }
#undef KOORD_K2_LAUNCH
  return (int)cudaGetLastError();
}
