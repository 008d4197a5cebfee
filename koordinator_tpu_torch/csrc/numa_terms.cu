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
// What bounds it on the H100: bytes. A pair costs a few compares, two
// correctly rounded divisions a zone for NUMA-bound pods, and 5 bytes
// written; the inputs (zone columns a node, two requests a pod) are
// tiny. 2 * 10^6 pairs a config-2 chunk write 10 MB.
//
// Design: a block of 256 threads owns a tile of 256 nodes and 16 pods.
// It stages the tile's zone rows (cap, free, valid, the policy and the
// total valid free) and the pods' requests in shared memory, then
// thread t takes node t of the tile for each of the 16 pods, so a warp
// writes 32 consecutive nodes of one pod row at a time. The kernel is
// built for two zone widths, Z <= 4 (18 KB of shared memory a block) and
// Z <= 8 (36 KB), so that the narrow one keeps its occupancy.
//
// Exactness against the reference (bit for bit): the file builds with
// -fmad=false and names each rounding. used_after = (cap - free) + req,
// frac = used_after / max(cap, 1e-9) (__fdiv_rn), the mean of the two
// dims as (f0 + f1) / 2 (for "least" of 1 - frac), the best over the
// fitting zones from -1, then clip to [0, 1] and * 100: the reference's
// order. The total valid free sums free * valid over the zones in zone
// order from 0 (exact on the scheduler's integer-valued zone state in
// any order).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 256;   // nodes a block
constexpr int PODS = 16;    // pods a block
constexpr int MAX_Z = 8;
constexpr int POLICY_NONE = 0;

template <int MZ>
__global__ void __launch_bounds__(THREADS) numa_pair_terms_kernel(
    const float* __restrict__ demand, const uint8_t* __restrict__ single,
    const float* __restrict__ cap, const float* __restrict__ free_,
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ policy,
    int P, int N, int Z, int least, float eps, const uint8_t* and_in,
    uint8_t* out_ok, float* __restrict__ out_score) {
  __shared__ float s_cap[MZ][2][TILE];
  __shared__ float s_free[MZ][2][TILE];
  __shared__ uint8_t s_valid[MZ][TILE];
  __shared__ uint8_t s_policy_none[TILE];
  __shared__ float s_total[2][TILE];
  __shared__ float s_demand[PODS][2];
  __shared__ uint8_t s_single[PODS];

  const int t = threadIdx.x;
  const int n0 = blockIdx.x * TILE, p0 = blockIdx.y * PODS;
  const int n = n0 + t;
  if (n < N) {
    float tot0 = 0.0f, tot1 = 0.0f;
    for (int z = 0; z < Z; ++z) {
      const size_t o = ((size_t)n * Z + z) * 2;
      const float v = valid[(size_t)n * Z + z] ? 1.0f : 0.0f;
      s_cap[z][0][t] = cap[o];
      s_cap[z][1][t] = cap[o + 1];
      s_free[z][0][t] = free_[o];
      s_free[z][1][t] = free_[o + 1];
      s_valid[z][t] = v != 0.0f;
      tot0 = __fadd_rn(tot0, __fmul_rn(free_[o], v));
      tot1 = __fadd_rn(tot1, __fmul_rn(free_[o + 1], v));
    }
    s_total[0][t] = tot0;
    s_total[1][t] = tot1;
    s_policy_none[t] = policy[n] == POLICY_NONE;
  }
  if (t < PODS * 2) {
    const int q = p0 + t / 2;
    s_demand[t / 2][t & 1] = q < P ? demand[(size_t)q * 2 + (t & 1)] : 0.0f;
  }
  if (t < PODS) s_single[t] = p0 + t < P ? single[p0 + t] : 0;
  __syncthreads();
  if (n >= N) return;

  const bool none = s_policy_none[t];
  for (int i = 0; i < PODS && p0 + i < P; ++i) {
    const int p = p0 + i;
    const float d0 = s_demand[i][0], d1 = s_demand[i][1];
    const bool sg = s_single[i];
    // the NUMA-bound pod's zone request: demand * numa_single
    const float m = sg ? 1.0f : 0.0f;
    const float r0 = __fmul_rn(d0, m), r1 = __fmul_rn(d1, m);
    bool any_fit = false;
    float best = 0.0f;
    for (int z = 0; z < Z; ++z) {
      const float c0 = s_cap[z][0][t], c1 = s_cap[z][1][t];
      const float f0 = s_free[z][0][t], f1 = s_free[z][1][t];
      const bool fits = s_valid[z][t] && __fadd_rn(f0, eps) >= r0
                        && __fadd_rn(f1, eps) >= r1;
      any_fit |= fits;
      float zs = -1.0f;
      if (fits) {
        float q0 = __fdiv_rn(__fadd_rn(__fsub_rn(c0, f0), r0),
                             fmaxf(c0, 1e-9f));
        float q1 = __fdiv_rn(__fadd_rn(__fsub_rn(c1, f1), r1),
                             fmaxf(c1, 1e-9f));
        if (least) {
          q0 = __fsub_rn(1.0f, q0);
          q1 = __fsub_rn(1.0f, q1);
        }
        zs = __fdiv_rn(__fadd_rn(q0, q1), 2.0f);
      }
      best = z == 0 ? zs : fmaxf(best, zs);
    }
    const bool zone_ok = any_fit || !sg;
    const bool policy_ok = none || (__fadd_rn(s_total[0][t], eps) >= d0
                                    && __fadd_rn(s_total[1][t], eps) >= d1);
    const size_t o = (size_t)p * N + n;
    out_ok[o] = (and_in == nullptr || and_in[o]) && zone_ok && policy_ok;
    out_score[o] = sg ? __fmul_rn(fminf(fmaxf(best, 0.0f), 1.0f), 100.0f)
                      : 0.0f;
  }
}

}  // namespace

// ptr: demand [P, 2], numa_single [P], numa_cap [N, Z, 2], numa_free
// [N, Z, 2], numa_valid [N, Z], numa_policy [N], and_in [P, N] (or
// null; may be pair_ok itself), pair_ok [P, N], pair_score [P, N].
// least: 0 for "most", 1 for "least"; eps: the gate tolerance.
extern "C" int koord_numa_pair_terms(const void* const* ptr, int P, int N,
                                     int Z, int least, float eps,
                                     void* stream) {
  if (P <= 0 || N <= 0) return 0;
  if (Z <= 0 || Z > MAX_Z) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + TILE - 1) / TILE, (P + PODS - 1) / PODS);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  auto kernel = &numa_pair_terms_kernel<4>;
  if (Z > 4) kernel = &numa_pair_terms_kernel<MAX_Z>;
  kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)ptr[0], (const uint8_t*)ptr[1], (const float*)ptr[2],
      (const float*)ptr[3], (const uint8_t*)ptr[4], (const int32_t*)ptr[5],
      P, N, Z, least, eps, (const uint8_t*)ptr[6], (uint8_t*)ptr[7],
      (float*)ptr[8]);
  return (int)cudaGetLastError();
}
