// K5 topology_admit: the topology manager of one inner commit step, a
// warp a pod.
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
// operations (M = 2^Z <= 256 masks a pod, a few dozen operations each):
// the launch, and the latency of a pod's chain of steps. One launch
// replaces the dozens of ops.
//
// Design: a warp a pod (8 pods a block of 256). Every lane holds the
// pod's zones in registers; lane l takes masks l, l + 32, ... (at Z = 8
// eight a lane, at Z <= 5 at most one), the hint pass keeps each lane's
// fit bits in a register word, and the warp reduces the smallest fitting
// popcounts, the largest mask free and the best hint key (the key, then
// the lower mask id: the first minimum) with shuffles. DeviceShare's
// per-zone instance counts come from a ballot a zone over the lanes'
// instances (lane l: instance l, l + 32, ...). The greedy take runs on
// every lane (Z <= 8 zones); lane z writes zone z.
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
//   sums round in that order; the argmin takes the first minimum (the
//   keys are finite on finite zone state);
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
constexpr int WARPS = THREADS / 32;
constexpr int MAX_Z = 8;
constexpr int MAX_M = 1 << MAX_Z;
constexpr int MASKS = MAX_M / 32;  // masks a lane at most
constexpr unsigned FULL = 0xffffffffu;
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

__device__ __forceinline__ int warp_min(int v) {
  return __reduce_min_sync(FULL, v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// The sum over mask m's zones, in zone order, of a * bit (a * valid *
// bit where `valid` is given: the combined free of the capacity hints).
__device__ __forceinline__ float mask_sum(const float (&a)[MAX_Z],
                                          const bool (&vz)[MAX_Z],
                                          bool use_valid, int m, int Z) {
  float s = 0.0f;
#pragma unroll
  for (int z = 0; z < MAX_Z; ++z) {
    if (z < Z) {
      const float b = (m >> z) & 1 ? 1.0f : 0.0f;
      const float x = use_valid ? __fmul_rn(a[z], vz[z] ? 1.0f : 0.0f)
                                : a[z];
      s = __fadd_rn(s, __fmul_rn(x, b));
    }
  }
  return s;
}

__global__ void __launch_bounds__(THREADS) topology_admit_kernel(
    const int32_t* __restrict__ choice, const uint8_t* __restrict__ trying,
    const uint8_t* __restrict__ single, const float* __restrict__ demand,
    const float* __restrict__ cap, const float* __restrict__ used,
    const uint8_t* __restrict__ valid_, const int32_t* __restrict__ policy_,
    int P, int S, int Z, int least, float eps, float eps_scale, Gpu gpu,
    Out out) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (p >= P) return;  // the whole warp
  const int M = 1 << Z;
  const int nc = min(max(choice[p], 0), S - 1);
  int policy = single[p] ? POLICY_SINGLE_NUMA_NODE : policy_[nc];
  if (!trying[p]) policy = POLICY_NONE;
  const bool engaged = policy > POLICY_NONE;
  const float e = engaged ? 1.0f : 0.0f;
  const float req0 = __fmul_rn(demand[(size_t)p * 2], e);
  const float req1 = __fmul_rn(demand[(size_t)p * 2 + 1], e);

  float fz0[MAX_Z], fz1[MAX_Z];
  bool vz[MAX_Z];
  unsigned vmask = 0;
#pragma unroll
  for (int z = 0; z < MAX_Z; ++z) {
    if (z < Z) {
      const size_t o = ((size_t)nc * Z + z) * 2;
      fz0[z] = fmaxf(__fsub_rn(cap[o], used[o]), 0.0f);
      fz1[z] = fmaxf(__fsub_rn(cap[o + 1], used[o + 1]), 0.0f);
      vz[z] = valid_[(size_t)nc * Z + z] != 0;
      vmask |= (unsigned)vz[z] << z;
    } else {
      fz0[z] = fz1[z] = 0.0f;
      vz[z] = false;
    }
  }

  // count_hints' inputs (DeviceShare): fitting instances per zone of the
  // node, a ballot a zone over the lanes' instances
  int need = 0;
  int zc[MAX_Z];
#pragma unroll
  for (int z = 0; z < MAX_Z; ++z) zc[z] = 0;
  if (gpu.I > 0) {
    const koord_dev::PerInst pi = koord_dev::per_instance(
        gpu.total[(size_t)nc * 3 + 1], gpu.req[(size_t)p * 3],
        gpu.req[(size_t)p * 3 + 1], gpu.req[(size_t)p * 3 + 2]);
    need = engaged ? pi.count : 0;
    for (int i0 = 0; i0 < gpu.I; i0 += 32) {
      const int i = i0 + lane;
      int zid = -1;
      if (i < gpu.I) {
        const size_t o = (size_t)nc * gpu.I + i;
        if (gpu.valid[o] && koord_dev::covers(gpu.free_ + o * 3, pi.v, eps))
          zid = gpu.numa[o];
      }
#pragma unroll
      for (int z = 0; z < MAX_Z; ++z)
        if (z < Z) zc[z] += __popc(__ballot_sync(FULL, zid == z));
    }
  }
  const bool count_all = gpu.I == 0 || need <= 0;

  // the hints of the lane's masks: capacity fit (cfit) and count fit
  // (nfit) a bit each in a word; the warp's smallest fitting popcounts
  // and largest mask free (cpu, without the valid factor)
  const bool no_request = req0 <= eps && req1 <= eps;
  unsigned cfit = 0, nfit = 0;
  int min_cnt = Z + 1, min_nct = Z + 1;
  float top = -INFINITY;
  for (int k = 0; k < MASKS; ++k) {
    const int m = lane + 32 * k;
    if (m >= M) break;
    top = fmaxf(top, mask_sum(fz0, vz, false, m, Z));
    if (m == 0) continue;
    const float a0 = mask_sum(fz0, vz, true, m, Z);
    const float a1 = mask_sum(fz1, vz, true, m, Z);
    const bool inside = (m & ~vmask) == 0;
    if (inside && __fadd_rn(a0, eps) >= req0 && __fadd_rn(a1, eps) >= req1) {
      cfit |= 1u << k;
      min_cnt = min(min_cnt, __popc(m));
    }
    int have = 0;
#pragma unroll
    for (int z = 0; z < MAX_Z; ++z)
      if (z < Z && (m >> z) & 1) have += zc[z];
    if (have >= need) {
      nfit |= 1u << k;
      min_nct = min(min_nct, __popc(m));
    }
  }
  min_cnt = warp_min(min_cnt);
  min_nct = warp_min(min_nct);
  top = warp_max(top);

  // merge_hints (the AND of the providers, preferred only where it
  // fits), resolve's candidates and their hint keys; the lane's best,
  // then the warp's
  const float denom = __fmul_rn(fmaxf(top, 1.0f), eps_scale);
  const float c_pref = 4.0f * M * (Z + 2), c_pop = 4.0f * M;
  const float c_strat = 2.0f * M, c_id = 1.0f / M;
  bool any_fit = false, any_cand = false;
  int best = MAX_M;
  float bk = 0.0f;
  for (int k = 0; k < MASKS; ++k) {
    const int m = lane + 32 * k;
    if (m >= M) break;
    const int pc = __popc(m);
    const bool cf = no_request || ((cfit >> k) & 1u);
    const bool cp = no_request || (((cfit >> k) & 1u) && pc == min_cnt);
    const bool nf = count_all || ((nfit >> k) & 1u);
    const bool np = count_all || (((nfit >> k) & 1u) && pc == min_nct);
    const bool fit = cf && nf, pref = cp && np && fit;
    any_fit |= fit;
    bool cand;
    if (policy == POLICY_BEST_EFFORT) cand = fit;
    else if (policy == POLICY_RESTRICTED) cand = fit && pref;
    else if (policy == POLICY_SINGLE_NUMA_NODE) cand = fit && pref && pc == 1;
    else cand = false;
    if (!cand) continue;
    any_cand = true;
    float strat = __fdiv_rn(mask_sum(fz0, vz, false, m, Z), denom);
    if (least) strat = __fsub_rn(1.0f, strat);
    const float k0 = __fadd_rn(pref ? 0.0f : c_pref,
                               __fmul_rn((float)pc, c_pop));
    const float key = __fadd_rn(__fadd_rn(k0, __fmul_rn(strat, c_strat)),
                                __fmul_rn((float)m, c_id));
    if (best == MAX_M || key < bk) {
      best = m;
      bk = key;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int om = __shfl_xor_sync(FULL, best, off);
    const float ok = __shfl_xor_sync(FULL, bk, off);
    if (om != MAX_M && (best == MAX_M || ok < bk || (ok == bk && om < best))) {
      best = om;
      bk = ok;
    }
  }
  any_fit = __any_sync(FULL, any_fit);
  any_cand = __any_sync(FULL, any_cand);
  unsigned affinity = vmask;
  bool admit = true;
  if (policy >= POLICY_BEST_EFFORT && policy <= POLICY_SINGLE_NUMA_NODE) {
    if (any_cand) affinity = (unsigned)best;
    if (policy != POLICY_BEST_EFFORT) admit = any_cand || !any_fit;
  }
  if (!engaged) affinity = vmask;

  // greedy_take: the affinity's zones in strategy order
  float kz[MAX_Z];
  int order[MAX_Z];
#pragma unroll
  for (int z = 0; z < MAX_Z; ++z) {
    const bool in = (affinity >> z) & 1u;
    kz[z] = in ? fz0[z] : (least ? -INFINITY : INFINITY);
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
  float take0[MAX_Z], take1[MAX_Z];
  float cum0 = 0.0f, cum1 = 0.0f;
  for (int j = 0; j < Z; ++j) {
    const int z = order[least ? Z - 1 - j : j];
    const bool in = (affinity >> z) & 1u;
    const float av0 = in ? fz0[z] : 0.0f, av1 = in ? fz1[z] : 0.0f;
    cum0 = __fadd_rn(cum0, av0);
    cum1 = __fadd_rn(cum1, av1);
    const float b0 = __fsub_rn(cum0, av0), b1 = __fsub_rn(cum1, av1);
    take0[z] = fminf(fmaxf(__fsub_rn(req0, b0), 0.0f), av0);
    take1[z] = fminf(fmaxf(__fsub_rn(req1, b1), 0.0f), av1);
  }
  float tot0 = 0.0f, tot1 = 0.0f;
  for (int z = 0; z < Z; ++z) {
    tot0 = __fadd_rn(tot0, take0[z]);
    tot1 = __fadd_rn(tot1, take1[z]);
  }
  const bool filled = __fadd_rn(tot0, eps) >= req0
                      && __fadd_rn(tot1, eps) >= req1;

#pragma unroll
  for (int z = 0; z < MAX_Z; ++z) {
    if (z < Z && z == lane) {
      out.affinity[(size_t)p * Z + z] = (affinity >> z) & 1u;
      out.take[((size_t)p * Z + z) * 2] = take0[z];
      out.take[((size_t)p * Z + z) * 2 + 1] = take1[z];
    }
  }
  if (lane == 0) {
    out.engaged[p] = engaged;
    out.admit[p] = admit && (!engaged || filled);
    out.zone1[p] = affinity ? __ffs(affinity) - 1 : 0;
  }
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
  if (S <= 0 || Z <= 0 || Z > MAX_Z || I < 0)
    return (int)cudaErrorInvalidValue;
  Out out{(uint8_t*)ptr[8], (uint8_t*)ptr[9], (uint8_t*)ptr[10],
          (float*)ptr[11], (int32_t*)ptr[12]};
  Gpu gpu{(const float*)ptr[13], (const float*)ptr[14],
          (const float*)ptr[15], (const uint8_t*)ptr[16],
          (const int32_t*)ptr[17], I};
  topology_admit_kernel<<<(P + WARPS - 1) / WARPS, THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)ptr[0], (const uint8_t*)ptr[1], (const uint8_t*)ptr[2],
      (const float*)ptr[3], (const float*)ptr[4], (const float*)ptr[5],
      (const uint8_t*)ptr[6], (const int32_t*)ptr[7], P, S, Z, least, eps,
      eps_scale, gpu, out);
  return (int)cudaGetLastError();
}
