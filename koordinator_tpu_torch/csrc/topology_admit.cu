// K5 topology_admit: the topology manager of one inner commit step, one
// thread a pod.
//
// Replaces the block of koordinator_tpu/scheduler/core.py schedule_batch
// at :907-948 (and the reported zone of :1068), which XLA runs as a few
// dozen small fused ops each inner step. For each pod, on its chosen
// node (choice clamped into [0, S), as the reference's gather):
// - the node's live zone free, max(cap - used, 0), and its valid zones;
// - the effective policy: single-numa-node for a NUMA-bound pod, else
//   the node's, none for a pod that is not trying; engaged = policy set;
// - scheduler/topologymanager.py capacity_hints (the CPU+memory
//   provider; the request is zero where not engaged);
// - with GPU instances (I > 0, the DeviceShare path, core.py:930-940):
//   the pod's per-instance request at the chosen node
//   (deviceshare.py:111 per_instance_at), the node's instances that fit
//   it per zone on the live instance free (:184 gpu_zone_counts; zone
//   -1 counts in none) and topologymanager.py:97 count_hints with need =
//   count where engaged, else 0;
// - merge_hints over the providers (capacity first, then count),
//   resolve (the four policies, either strategy) and greedy_take.
// It writes the affinity bool[P, Z], engaged bool[P], admit bool[P]
// (policy admission and, where engaged, a take that fills the request),
// the take f32[P, Z, 2] (K2 reads its zone columns as the per-level
// requests of the zone gates), and zone1 i32[P] (the affinity's first
// zone, 0 where it has none). The gate tolerance eps and the strategy
// key's scale 1 + eps come from the host (scheduler/batching.py EPS).
//
// What bounds it on the H100: neither bytes (tens of bytes a pod) nor
// operations (a few hundred a pod, M = 2^Z <= 16 masks): the launch. One
// launch replaces the dozens of ops; a thread holds its pod's whole
// problem in registers, with the mask table as bit tests.
//
// Exactness against the reference (bit for bit): the file builds with
// -fmad=false and names each rounding, in the reference's order:
// - a mask's combined free is the sum over its zones, in zone order
//   from 0, of free * valid * bit (the reference's einsum over the 0/1
//   mask table; exact on integer-valued zone state in any order);
// - the hint key is (((!pref) * 4M(Z+2) + popcount * 4M)
//   + strat * 2M) + id * (1/M), with strat = mask_free /
//   (max(max_m mask_free, 1) * (1 + eps)) (1 - that for "least"); every
//   product is by a power of two or a small integer, so exact, and the
//   sums round in that order; the argmin takes the first minimum;
// - greedy_take orders the affinity's zones by free cpu, ascending and
//   stable (+inf off the affinity for "most", -inf for "least", whose
//   order is then reversed whole), and takes min(max(req - before, 0),
//   avail) with before = cum - avail, cum the running sum; filled sums
//   the takes in zone order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_share.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_Z = 4;
constexpr int MAX_M = 1 << MAX_Z;
constexpr int POLICY_NONE = 0;
constexpr int POLICY_BEST_EFFORT = 1;
constexpr int POLICY_RESTRICTED = 2;
constexpr int POLICY_SINGLE_NUMA_NODE = 3;

// The DeviceShare provider's inputs (I = 0: no provider).
struct Gpu {
  const float* req;      // [P, 3] core, memory, memory ratio
  const float* total;    // [S, 3]
  const float* free_;    // [S, I, 3] live
  const uint8_t* valid;  // [S, I]
  const int32_t* numa;   // [S, I]
  int I;
};

struct Out {
  uint8_t* affinity;   // [P, Z]
  uint8_t* engaged;    // [P]
  uint8_t* admit;      // [P]
  float* take;         // [P, Z, 2]
  int32_t* zone1;      // [P]
};

__global__ void __launch_bounds__(THREADS) topology_admit_kernel(
    const int32_t* __restrict__ choice, const uint8_t* __restrict__ trying,
    const uint8_t* __restrict__ single, const float* __restrict__ demand,
    const float* __restrict__ cap, const float* __restrict__ used,
    const uint8_t* __restrict__ valid_, const int32_t* __restrict__ policy_,
    int P, int S, int Z, int least, float eps, float eps_scale, Gpu gpu,
    Out out) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= P) return;
  const int M = 1 << Z;
  const int nc = min(max(choice[p], 0), S - 1);
  int policy = single[p] ? POLICY_SINGLE_NUMA_NODE : policy_[nc];
  if (!trying[p]) policy = POLICY_NONE;
  const bool engaged = policy > POLICY_NONE;
  const float e = engaged ? 1.0f : 0.0f;
  const float req0 = __fmul_rn(demand[(size_t)p * 2], e);
  const float req1 = __fmul_rn(demand[(size_t)p * 2 + 1], e);

  float fz[MAX_Z][2];
  bool vz[MAX_Z];
  unsigned vmask = 0;
#pragma unroll
  for (int z = 0; z < MAX_Z; ++z) {
    if (z < Z) {
      const size_t o = ((size_t)nc * Z + z) * 2;
      fz[z][0] = fmaxf(__fsub_rn(cap[o], used[o]), 0.0f);
      fz[z][1] = fmaxf(__fsub_rn(cap[o + 1], used[o + 1]), 0.0f);
      vz[z] = valid_[(size_t)nc * Z + z] != 0;
      vmask |= (unsigned)vz[z] << z;
    } else {
      fz[z][0] = fz[z][1] = 0.0f;
      vz[z] = false;
    }
  }

  // capacity_hints: fit and pref as bit sets over the masks
  const bool no_request = req0 <= eps && req1 <= eps;
  unsigned fit = 0;
  int min_cnt = Z + 1;
  for (int m = 1; m < M; ++m) {
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int z = 0; z < MAX_Z; ++z) {
      if (z < Z) {
        const float v = vz[z] ? 1.0f : 0.0f, b = (m >> z) & 1 ? 1.0f : 0.0f;
        a0 = __fadd_rn(a0, __fmul_rn(__fmul_rn(fz[z][0], v), b));
        a1 = __fadd_rn(a1, __fmul_rn(__fmul_rn(fz[z][1], v), b));
      }
    }
    const bool inside = (m & ~vmask) == 0;
    if (inside && __fadd_rn(a0, eps) >= req0 && __fadd_rn(a1, eps) >= req1) {
      fit |= 1u << m;
      min_cnt = min(min_cnt, __popc(m));
    }
  }
  unsigned pref = 0;
  for (int m = 1; m < M; ++m)
    if (((fit >> m) & 1u) && __popc(m) == min_cnt) pref |= 1u << m;
  const unsigned all = M >= 32 ? 0xffffffffu : (1u << M) - 1u;
  if (no_request) fit = pref = all;

  // count_hints (DeviceShare): fitting instances per zone of the node
  if (gpu.I > 0) {
    const koord_dev::PerInst pi = koord_dev::per_instance(
        gpu.total[(size_t)nc * 3 + 1], gpu.req[(size_t)p * 3],
        gpu.req[(size_t)p * 3 + 1], gpu.req[(size_t)p * 3 + 2]);
    int zc[MAX_Z] = {0, 0, 0, 0};
    for (int i = 0; i < gpu.I; ++i) {
      const size_t o = (size_t)nc * gpu.I + i;
      const int zid = gpu.numa[o];
      if (gpu.valid[o] && zid >= 0 && zid < Z &&
          koord_dev::covers(gpu.free_ + o * 3, pi.v, eps))
        ++zc[zid];
    }
    const int need = engaged ? pi.count : 0;
    unsigned cfit = 0, cpref = 0;
    int cmin = Z + 1;
    for (int m = 1; m < M; ++m) {
      int have = 0;
      for (int z = 0; z < Z; ++z)
        if ((m >> z) & 1) have += zc[z];
      if (have >= need) {
        cfit |= 1u << m;
        cmin = min(cmin, __popc(m));
      }
    }
    for (int m = 1; m < M; ++m)
      if (((cfit >> m) & 1u) && __popc(m) == cmin) cpref |= 1u << m;
    if (need <= 0) cfit = cpref = all;
    fit &= cfit;
    pref &= cpref;
  }
  // merge_hints: the AND of the providers, preferred only where it fits
  pref &= fit;

  // resolve: the hint key of every mask
  float mask_free[MAX_M];
  float top = -INFINITY;
  for (int m = 0; m < M; ++m) {
    float s = 0.0f;
#pragma unroll
    for (int z = 0; z < MAX_Z; ++z)
      if (z < Z)
        s = __fadd_rn(s, __fmul_rn(fz[z][0], (m >> z) & 1 ? 1.0f : 0.0f));
    mask_free[m] = s;
    top = fmaxf(top, s);
  }
  const float denom = __fmul_rn(fmaxf(top, 1.0f), eps_scale);
  const float c_pref = 4.0f * M * (Z + 2), c_pop = 4.0f * M;
  const float c_strat = 2.0f * M, c_id = 1.0f / M;
  float key[MAX_M];
  for (int m = 0; m < M; ++m) {
    float strat = __fdiv_rn(mask_free[m], denom);
    if (least) strat = __fsub_rn(1.0f, strat);
    const float k0 = __fadd_rn(((pref >> m) & 1u) ? 0.0f : c_pref,
                               __fmul_rn((float)__popc(m), c_pop));
    key[m] = __fadd_rn(__fadd_rn(k0, __fmul_rn(strat, c_strat)),
                       __fmul_rn((float)m, c_id));
  }
  unsigned single_m = 0;
  for (int m = 0; m < M; ++m)
    if (__popc(m) == 1) single_m |= 1u << m;
  unsigned cand;
  if (policy == POLICY_BEST_EFFORT) cand = fit;
  else if (policy == POLICY_RESTRICTED) cand = fit & pref;
  else if (policy == POLICY_SINGLE_NUMA_NODE) cand = fit & pref & single_m;
  else cand = 0;
  unsigned affinity = vmask;
  bool admit = true;
  if (policy >= POLICY_BEST_EFFORT && policy <= POLICY_SINGLE_NUMA_NODE) {
    if (cand) {
      int best = -1;
      float bk = INFINITY;
      for (int m = 0; m < M; ++m)
        if (((cand >> m) & 1u) && (best < 0 || key[m] < bk)) {
          best = m;
          bk = key[m];
        }
      affinity = (unsigned)best;
    }
    if (policy != POLICY_BEST_EFFORT) admit = cand != 0 || fit == 0;
  }
  if (!engaged) affinity = vmask;

  // greedy_take: the affinity's zones in strategy order
  float kz[MAX_Z];
  int order[MAX_Z];
#pragma unroll
  for (int z = 0; z < MAX_Z; ++z) {
    const bool in = (affinity >> z) & 1u;
    kz[z] = in ? fz[z][0] : (least ? -INFINITY : INFINITY);
    order[z] = z;
  }
  for (int i = 1; i < Z; ++i) {  // stable insertion sort, ascending
    const int oi = order[i];
    int j = i - 1;
    while (j >= 0 && kz[order[j]] > kz[oi]) {
      order[j + 1] = order[j];
      --j;
    }
    order[j + 1] = oi;
  }
  float take[MAX_Z][2];
  float cum0 = 0.0f, cum1 = 0.0f;
  for (int j = 0; j < Z; ++j) {
    const int z = order[least ? Z - 1 - j : j];
    const bool in = (affinity >> z) & 1u;
    const float av0 = in ? fz[z][0] : 0.0f, av1 = in ? fz[z][1] : 0.0f;
    cum0 = __fadd_rn(cum0, av0);
    cum1 = __fadd_rn(cum1, av1);
    const float b0 = __fsub_rn(cum0, av0), b1 = __fsub_rn(cum1, av1);
    take[z][0] = fminf(fmaxf(__fsub_rn(req0, b0), 0.0f), av0);
    take[z][1] = fminf(fmaxf(__fsub_rn(req1, b1), 0.0f), av1);
  }
  float tot0 = 0.0f, tot1 = 0.0f;
  for (int z = 0; z < Z; ++z) {
    tot0 = __fadd_rn(tot0, take[z][0]);
    tot1 = __fadd_rn(tot1, take[z][1]);
  }
  const bool filled = __fadd_rn(tot0, eps) >= req0
                      && __fadd_rn(tot1, eps) >= req1;

  int zone1 = 0;
  for (int z = Z - 1; z >= 0; --z)
    if ((affinity >> z) & 1u) zone1 = z;
  for (int z = 0; z < Z; ++z) {
    out.affinity[(size_t)p * Z + z] = (affinity >> z) & 1u;
    out.take[((size_t)p * Z + z) * 2] = take[z][0];
    out.take[((size_t)p * Z + z) * 2 + 1] = take[z][1];
  }
  out.engaged[p] = engaged;
  out.admit[p] = admit && (!engaged || filled);
  out.zone1[p] = zone1;
}

}  // namespace

// ptr: choice, trying, numa_single, demand [P, 2], numa_cap [S, Z, 2],
// numa_used [S, Z, 2], numa_valid [S, Z], numa_policy [S], then the
// outputs affinity, engaged, admit, take, zone1, then the DeviceShare
// provider's gpu_req [P, 3], gpu_total [S, 3], gpu_free [S, I, 3],
// gpu_valid [S, I], gpu_numa [S, I] (read only when I > 0). least: 0
// for "most", 1 for "least". eps: the gate tolerance; eps_scale: 1 +
// eps as the reference rounds it to f32.
extern "C" int koord_topology_admit(const void* const* ptr, int P, int S,
                                    int Z, int I, int least, float eps,
                                    float eps_scale, void* stream) {
  if (P <= 0) return 0;
  if (S <= 0 || Z <= 0 || Z > MAX_Z || I < 0) return (int)cudaErrorInvalidValue;
  Out out{(uint8_t*)ptr[8], (uint8_t*)ptr[9], (uint8_t*)ptr[10],
          (float*)ptr[11], (int32_t*)ptr[12]};
  Gpu gpu{(const float*)ptr[13], (const float*)ptr[14],
          (const float*)ptr[15], (const uint8_t*)ptr[16],
          (const int32_t*)ptr[17], I};
  topology_admit_kernel<<<(P + THREADS - 1) / THREADS, THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)ptr[0], (const uint8_t*)ptr[1], (const uint8_t*)ptr[2],
      (const float*)ptr[3], (const float*)ptr[4], (const float*)ptr[5],
      (const uint8_t*)ptr[6], (const int32_t*)ptr[7], P, S, Z, least, eps,
      eps_scale, gpu, out);
  return (int)cudaGetLastError();
}
