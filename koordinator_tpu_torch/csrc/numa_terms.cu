// K4 numa_pair_terms: the batch-start NUMA gates and zone score of every
// (pod, node) pair.
//
// Replaces the NUMA part of the static gates of
// koordinator_tpu/scheduler/core.py schedule_batch (:329-370), which XLA
// runs as fused programs over [P, N, Z, 2]:
// - plugins/numaaware.py zone_prefilter: a NUMA-bound pod must fit its
//   whole (cpu, mem) request into one valid zone of the node;
// - the policy node's combined fit: a node with a topology policy
//   admits a pod only if the total free of its valid zones covers the
//   pod's (cpu, mem) request;
// - plugins/numaaware.py numa_score_matrix: the NUMA-bound pod's
//   allocation score of the best zone it fits (most/least allocated
//   over the zone's cpu and memory after the pod), 0 elsewhere.
// It writes bool pair_ok[P, N] (both gates, ANDed into a given mask in
// place when the caller passes one) and f32 pair_score[P, N]; K1 reads
// them as its pair mask and score addend. Under the cascade's stage 2
// (core.py:330-367) P is the batch's numa prefix: the caller passes the
// first P pods and the stage-1 mask, whose first P rows it ANDs. The
// gate tolerance eps comes from the host (scheduler/batching.py EPS).
//
// What bounds it on the H100: bytes, and the zone loop's divisions on
// NUMA-bound rows. A pair writes 5 bytes; a NUMA-bound pod's pair costs
// two correctly rounded divisions a zone it fits. The full gate's numa
// prefix (768 rows of 10^4 nodes) writes 38 MB, half its rows NUMA-bound.
//
// Design (pair_rows.cuh for the spans): a block of 128 threads takes a
// tile of nodes (512 at Z <= 3, 256 at Z <= 7, 128 at Z = 8) and up
// to 64 rows, every G-th row of the batch, so that each block holds a
// like share of the NUMA-bound rows. It classifies its rows once
// (NUMA-bound or not) and reads its nodes' policies; a row that is not
// NUMA-bound, on a tile without a policy node, passes everywhere (the
// full gate's packing forbids policy nodes), so it only stores zero
// scores and leaves the mask alone. Else the block stages, once a (node,
// zone), what every pair reuses: the fit threshold free + eps (NaN on an
// invalid zone, which fails every fit), cap - free, max(cap, 1e-9), and
// the node's total valid free + eps. A thread takes 4 nodes of a row:
// one mask word in (the next row's loaded before this one computes), the
// zone loop (divisions only on the zones that fit), one word and one
// float4 out. (Staging by cp.async behind the passing rows' stores was
// measured slower: its raw rows leave an SM four blocks, not six.)
//
// Exactness against the reference (bit for bit): the file builds with
// -fmad=false and names each rounding. used_after = (cap - free) + req,
// frac = used_after / max(cap, 1e-9) (__fdiv_rn), the mean of the two
// dims as (f0 + f1) * 0.5 (for "least" of 1 - frac; x * 0.5 and x / 2
// are the correctly rounded value of the same real number, so they agree
// on every input, subnormals included: the build has no -ftz), the best
// over the fitting zones from -1, then clip to [0, 1] and * 100: the
// reference's order. The total valid free sums free * valid over the
// zones in zone order from 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_rows.cuh"

namespace {

using koord_rows::SPAN;
using koord_rows::Span;
using koord_rows::THREADS;
using koord_rows::MAX_ROWS;
using koord_rows::ONES;

constexpr int MAX_Z = 8;
constexpr int POLICY_NONE = 0;
constexpr int PER_ZONE = 6;   // staged floats a (node, zone)

struct Args {
  const float* demand;      // [P, 2]
  const uint8_t* single;    // [P]
  const float* cap;         // [N, Z, 2]
  const float* free_;       // [N, Z, 2]
  const uint8_t* valid;     // [N, Z]
  const int32_t* policy;    // [N]
  uint8_t* ok;              // [P, N], the mask ANDed in place with and_in
  float* score;             // [P, N]
  int P, N, Z, least, tile, and_in;
  float eps;
};

// shared floats of a tile: per zone z the planes fe0, fe1 (free + eps,
// NaN where invalid), cmf0, cmf1 (cap - free), mc0, mc1 (max(cap,
// 1e-9)), each `tile` long, then te0, te1 (total valid free + eps), then
// the policy-none bytes
__device__ __forceinline__ float* plane(float* s, int tile, int k) {
  return s + (size_t)k * tile;
}

__global__ void __launch_bounds__(THREADS)
    numa_pair_terms_kernel(const Args a) {
  extern __shared__ float4 s_dyn[];
  float* s = reinterpret_cast<float*>(s_dyn);
  __shared__ float s_d[MAX_ROWS][2];
  __shared__ uint8_t s_bound[MAX_ROWS];

  const int t = threadIdx.x, tile = a.tile, Z = a.Z;
  const int nb = blockIdx.y * tile, nrows = koord_rows::block_rows(a.P);
  const int nodes = min(tile, a.N - nb);
  uint8_t* s_none =
      reinterpret_cast<uint8_t*>(s + (size_t)(PER_ZONE * Z + 2) * tile);

  // 1. the rows' requests and classes, the tile's policies
  bool bound = false, policy = false;
  if (t < nrows) {
    const int p = koord_rows::row_of(t);
    s_d[t][0] = a.demand[(size_t)p * 2];
    s_d[t][1] = a.demand[(size_t)p * 2 + 1];
    bound = a.single[p] != 0;
    s_bound[t] = bound;
  }
  for (int k = t; k < nodes; k += THREADS) {
    const bool none = a.policy[nb + k] == POLICY_NONE;
    s_none[k] = none;
    policy |= !none;
  }
  const bool any_bound = __syncthreads_or(bound);
  const bool any_policy = __syncthreads_or(policy);

  // 2. the tile's zone rows, once a (node, zone)
  if (any_bound || any_policy) {
    for (int k = t; k < nodes; k += THREADS) {
      const size_t n = (size_t)(nb + k);
      float tot0 = 0.0f, tot1 = 0.0f;
      for (int z = 0; z < Z; ++z) {
        const size_t o = (n * Z + z) * 2;
        const float2 c = make_float2(a.cap[o], a.cap[o + 1]);
        const float2 f = make_float2(a.free_[o], a.free_[o + 1]);
        const bool v = a.valid[n * Z + z] != 0;
        const float vf = v ? 1.0f : 0.0f;
        float* zs = plane(s, tile, PER_ZONE * z);
        zs[k] = v ? __fadd_rn(f.x, a.eps) : koord_rows::kNaN();
        zs[tile + k] = v ? __fadd_rn(f.y, a.eps) : koord_rows::kNaN();
        zs[2 * tile + k] = __fsub_rn(c.x, f.x);
        zs[3 * tile + k] = __fsub_rn(c.y, f.y);
        zs[4 * tile + k] = fmaxf(c.x, 1e-9f);
        zs[5 * tile + k] = fmaxf(c.y, 1e-9f);
        tot0 = __fadd_rn(tot0, __fmul_rn(f.x, vf));
        tot1 = __fadd_rn(tot1, __fmul_rn(f.y, vf));
      }
      plane(s, tile, PER_ZONE * Z)[k] = __fadd_rn(tot0, a.eps);
      plane(s, tile, PER_ZONE * Z + 1)[k] = __fadd_rn(tot1, a.eps);
    }
    __syncthreads();
  }

  // 3. the pairs: thread t takes nodes k0..k0+3 of every rpi-th row
  const int spans = tile / SPAN, rpi = THREADS / spans;
  const int k0 = SPAN * (t % spans), rl = t / spans;
  if (k0 >= nodes) return;
  const int cnt = min(SPAN, nodes - k0);
  bool none[SPAN];
  float te0[SPAN], te1[SPAN];
  if (any_policy) {
#pragma unroll
    for (int j = 0; j < SPAN; ++j) {
      none[j] = s_none[k0 + j];
      te0[j] = plane(s, tile, PER_ZONE * Z)[k0 + j];
      te1[j] = plane(s, tile, PER_ZONE * Z + 1)[k0 + j];
    }
  }
  const float zero[SPAN] = {0.0f, 0.0f, 0.0f, 0.0f};
  auto span = [&](int r) {
    return koord_rows::span_of((size_t)koord_rows::row_of(r) * a.N + nb + k0,
                               cnt, a.ok, a.score);
  };
  // a row that is not NUMA-bound on a tile without a policy node passes
  auto reads = [&](int r) {
    return r < nrows && a.and_in && (s_bound[r] || any_policy);
  };
  unsigned in_next =
      reads(rl) ? koord_rows::load_mask(a.ok, span(rl)) : ONES;
  for (int r = rl; r < nrows; r += rpi) {
    const Span sp = span(r);
    const unsigned in = in_next;
    in_next = reads(r + rpi) ? koord_rows::load_mask(a.ok, span(r + rpi))
                             : ONES;
    const bool sg = s_bound[r];
    if (!sg && !any_policy) {
      if (!a.and_in) koord_rows::store_mask(a.ok, sp, ONES);
      koord_rows::store_score(a.score, sp, zero);
      continue;
    }
    const float d0 = s_d[r][0], d1 = s_d[r][1];
    unsigned okbits = 0;
#pragma unroll
    for (int j = 0; j < SPAN; ++j) {
      const bool policy_ok = !any_policy || none[j] ||
                             (te0[j] >= d0 && te1[j] >= d1);
      okbits |= (unsigned)policy_ok << j;
    }
    if (!sg) {
      koord_rows::store_mask(a.ok, sp, koord_rows::and_word(in, okbits));
      koord_rows::store_score(a.score, sp, zero);
      continue;
    }
    // the NUMA-bound pod's zone request: demand * numa_single
    const float q0 = __fmul_rn(d0, 1.0f), q1 = __fmul_rn(d1, 1.0f);
    unsigned fit_any = 0;
    float best[SPAN];
    for (int z = 0; z < Z; ++z) {
      const float* zs = plane(s, tile, PER_ZONE * z) + k0;
      float e0[SPAN], e1[SPAN];
      koord_rows::load4(zs, e0);
      koord_rows::load4(zs + tile, e1);
      unsigned fits = 0;
#pragma unroll
      for (int j = 0; j < SPAN; ++j)
        fits |= (unsigned)(e0[j] >= q0 && e1[j] >= q1) << j;
      fit_any |= fits;
      float zsc[SPAN] = {-1.0f, -1.0f, -1.0f, -1.0f};
      if (fits) {
        float cmf0[SPAN], cmf1[SPAN], mc0[SPAN], mc1[SPAN];
        koord_rows::load4(zs + 2 * tile, cmf0);
        koord_rows::load4(zs + 3 * tile, cmf1);
        koord_rows::load4(zs + 4 * tile, mc0);
        koord_rows::load4(zs + 5 * tile, mc1);
#pragma unroll
        for (int j = 0; j < SPAN; ++j) {
          if (!((fits >> j) & 1)) continue;
          float u0 = __fdiv_rn(__fadd_rn(cmf0[j], q0), mc0[j]);
          float u1 = __fdiv_rn(__fadd_rn(cmf1[j], q1), mc1[j]);
          if (a.least) {
            u0 = __fsub_rn(1.0f, u0);
            u1 = __fsub_rn(1.0f, u1);
          }
          zsc[j] = __fmul_rn(__fadd_rn(u0, u1), 0.5f);
        }
      }
#pragma unroll
      for (int j = 0; j < SPAN; ++j)
        best[j] = z == 0 ? zsc[j] : fmaxf(best[j], zsc[j]);
    }
    float out[SPAN];
#pragma unroll
    for (int j = 0; j < SPAN; ++j)
      out[j] = __fmul_rn(fminf(fmaxf(best[j], 0.0f), 1.0f), 100.0f);
    koord_rows::store_mask(a.ok, sp,
                           koord_rows::and_word(in, okbits & fit_any));
    koord_rows::store_score(a.score, sp, out);
  }
}

}  // namespace

// ptr: demand [P, 2], numa_single [P], numa_cap [N, Z, 2], numa_free
// [N, Z, 2], numa_valid [N, Z], numa_policy [N], and_in [P, N] (null, or
// pair_ok itself: the mask ANDed in place), pair_ok [P, N], pair_score
// [P, N]. least: 0 for "most", 1 for "least"; eps: the gate tolerance.
extern "C" int koord_numa_pair_terms(const void* const* ptr, int P, int N,
                                     int Z, int least, float eps,
                                     void* stream) {
  if (P <= 0 || N <= 0) return 0;
  if (Z <= 0 || Z > MAX_Z || (ptr[6] != nullptr && ptr[6] != ptr[7]))
    return (int)cudaErrorInvalidValue;
  const int per_node = 4 * (PER_ZONE * Z + 2) + 1;
  const int tile = koord_rows::tile_nodes(per_node, 48 * 1024 - 1024);
  const long long tiles = (N + tile - 1) / tile;
  const int rows = koord_rows::rows_per_block(P, tiles);
  const dim3 grid((P + rows - 1) / rows, (unsigned)tiles);
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  Args a;
  a.demand = (const float*)ptr[0];
  a.single = (const uint8_t*)ptr[1];
  a.cap = (const float*)ptr[2];
  a.free_ = (const float*)ptr[3];
  a.valid = (const uint8_t*)ptr[4];
  a.policy = (const int32_t*)ptr[5];
  a.and_in = ptr[6] != nullptr;
  a.ok = (uint8_t*)ptr[7];
  a.score = (float*)ptr[8];
  a.P = P;
  a.N = N;
  a.Z = Z;
  a.least = least;
  a.tile = tile;
  a.eps = eps;
  const size_t shared = (size_t)tile * per_node;
  numa_pair_terms_kernel<<<grid, THREADS, shared, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
