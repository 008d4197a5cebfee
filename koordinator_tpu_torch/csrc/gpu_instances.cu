// K7 gpu_instance_pick: the GPU instance gates of one inner commit step,
// one thread a pod on its chosen node, in two launches around K2.
//
// Replaces the GPU block of koordinator_tpu/scheduler/core.py
// schedule_batch (:898-906 and :962-1016), which XLA runs as a few
// dozen small fused ops each inner step, and the [P, P] `any` of its
// one-multi-pod-a-node rule:
// - the choose launch (`koord_gpu_choose`), before the shared gate:
//   each pod's GPU request per instance at its chosen node
//   (plugins/deviceshare.py:111 per_instance_at, device_share.cuh) and,
//   for a shared pod (count 1), its instance (:212
//   choose_gpu_instance: among the valid instances that fit and lie in
//   the pod's NUMA affinity where the topology manager engages it, the
//   most free core for "least", the least for "most", the first index
//   among ties; instance 0 where none fits). It writes the operands of
//   the K2 launch that follows: the pods the gate starts from (the
//   admitted ones, less the shared pods with no instance), and two
//   levels: the shared pods' (node, instance) segments with their
//   per-instance requests (the shared gate, core.py:986-995), and the
//   multi-GPU pods' node segments with a request of one against a
//   capacity of one (the first multi-GPU pod of a node in priority
//   order passes: the reference's first_multi, core.py:1012-1016,
//   without a [P, P] tensor);
// - the take launch (`koord_gpu_take`), after it: two kernels over a
//   grid of blocks, a thread a pod. The surviving shared pods OR their
//   instances into a word a node in device memory (zeroed first on the
//   stream); then each surviving multi-GPU pod takes the lowest-index
//   `count` instances of its node that fit, lie in its affinity and no
//   shared pod of the step took (:246 full_fit_instances with the
//   `exclude`, its node's word), or is rejected when there are fewer.
//   It writes the step's final accept and each pod's instances, bool
//   take[P, I]. Only the first multi-GPU pod of a node survives K2's
//   gate, so no take depends on another multi-GPU pod's: the order of
//   the pods plays no part, and any P takes the same two kernels.
//
// What bounds it on the H100: the launches. A pod reads its node's
// I <= 32 instance rows (12 bytes each) and does a few dozen compares
// and a handful of correctly rounded divisions; a step of 2000 pods
// moves well under 1 MB.
//
// Exactness against the reference (bit for bit): the file builds with
// -fmad=false; the per-instance request and the fit test are
// device_share.cuh's, and the choosers compare without arithmetic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_share.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_I = 32;

struct Pool {
  const float* total;    // [S, 3]
  const float* free_;    // [S, I, 3] live
  const uint8_t* valid;  // [S, I]
  const int32_t* numa;   // [S, I]
  int S, I;
};

// Instance i of node nc lies in the pod's affinity (or the pod is not
// engaged): deviceshare.py _zone_allowed.
__device__ __forceinline__ bool allowed(const Pool& g, int nc, int i,
                                        const uint8_t* affinity,
                                        bool engaged, int p, int Z) {
  if (!engaged) return true;
  const int zid = g.numa[(size_t)nc * g.I + i];
  return zid >= 0 && affinity[(size_t)p * Z + min(zid, Z - 1)];
}

__device__ __forceinline__ bool fits(const Pool& g, int nc, int i,
                                     const float* per, float eps) {
  const size_t o = (size_t)nc * g.I + i;
  return g.valid[o] && koord_dev::covers(g.free_ + o * 3, per, eps);
}

__global__ void __launch_bounds__(THREADS) gpu_choose_kernel(
    const int32_t* __restrict__ choice, const uint8_t* __restrict__ active,
    const float* __restrict__ gpu_req, Pool g,
    const uint8_t* __restrict__ affinity, const uint8_t* __restrict__ engaged,
    int P, int Z, int least, float eps, int32_t* __restrict__ out_count,
    float* __restrict__ out_per, int32_t* __restrict__ out_inst,
    uint8_t* __restrict__ out_gate, int32_t* __restrict__ out_seg,
    float* __restrict__ out_req) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= P) return;
  const int c = choice[p];
  const int nc = min(max(c, 0), g.S - 1);
  const koord_dev::PerInst pi = koord_dev::per_instance(
      g.total[(size_t)nc * 3 + 1], gpu_req[(size_t)p * 3],
      gpu_req[(size_t)p * 3 + 1], gpu_req[(size_t)p * 3 + 2]);
  const bool shared = pi.count == 1, multi = pi.count > 1;
  const bool eng = engaged != nullptr && engaged[p];
  int inst = 0;
  bool any = false;
  float best = 0.0f;
  for (int i = 0; i < g.I; ++i) {
    if (!fits(g, nc, i, pi.v, eps) || !allowed(g, nc, i, affinity, eng, p, Z))
      continue;
    const float key = g.free_[((size_t)nc * g.I + i) * 3];  // free core
    if (!any || (least ? key > best : key < best)) {
      inst = i;
      best = key;
    }
    any = true;
  }
  const bool gate = active[p] && (!shared || any);
  out_count[p] = pi.count;
  out_inst[p] = inst;
  out_gate[p] = gate;
  out_seg[p] = gate && shared ? c * g.I + inst : g.S * g.I;
  out_seg[P + p] = gate && multi ? c : g.S;
  for (int d = 0; d < 3; ++d) {
    out_per[(size_t)p * 3 + d] = pi.v[d];
    out_req[(size_t)p * 3 + d] = pi.v[d];
    out_req[((size_t)P + p) * 3 + d] = d == 0 ? 1.0f : 0.0f;
  }
}

// The take, first kernel: each surviving shared pod's instance into its
// node's word.
__global__ void __launch_bounds__(THREADS) gpu_shared_taken_kernel(
    const int32_t* __restrict__ choice, const uint8_t* __restrict__ alive,
    const int32_t* __restrict__ count, const int32_t* __restrict__ inst,
    int P, int S, unsigned* __restrict__ taken) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= P || !alive[p] || count[p] != 1) return;
  const int c = choice[p];
  if (c >= 0 && c < S) atomicOr(taken + c, 1u << inst[p]);
}

// The take, second kernel: a thread a pod, its final accept and
// instances, given the instances of its node that the step's shared pods
// took (`exclude`, its node's word).
__global__ void __launch_bounds__(THREADS) gpu_take_kernel(
    const int32_t* __restrict__ choice, const uint8_t* __restrict__ alive,
    const int32_t* __restrict__ count, const float* __restrict__ per,
    const int32_t* __restrict__ inst, Pool g,
    const uint8_t* __restrict__ affinity, const uint8_t* __restrict__ engaged,
    int P, int Z, float eps, const unsigned* __restrict__ taken,
    uint8_t* __restrict__ out_accept, uint8_t* __restrict__ out_take) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= P) return;
  const int c = count[p];
  bool acc = alive[p] != 0;
  unsigned take = 0;
  if (acc && c == 1) {
    take = 1u << inst[p];
  } else if (acc && c > 1) {
    const int nc = min(max(choice[p], 0), g.S - 1);
    const unsigned exclude = taken[nc];
    const bool eng = engaged != nullptr && engaged[p];
    const float pv[3] = {per[(size_t)p * 3], per[(size_t)p * 3 + 1],
                         per[(size_t)p * 3 + 2]};
    int n_fit = 0;
    for (int i = 0; i < g.I; ++i) {
      if (((exclude >> i) & 1u) || !fits(g, nc, i, pv, eps) ||
          !allowed(g, nc, i, affinity, eng, p, Z))
        continue;
      if (++n_fit <= c) take |= 1u << i;
    }
    acc = n_fit >= c;
    if (!acc) take = 0;
  }
  out_accept[p] = acc;
  for (int i = 0; i < g.I; ++i)
    out_take[(size_t)p * g.I + i] = (take >> i) & 1u;
}

Pool pool_of(const void* const* ptr, int S, int I) {
  return Pool{(const float*)ptr[0], (const float*)ptr[1],
              (const uint8_t*)ptr[2], (const int32_t*)ptr[3], S, I};
}

}  // namespace

// The choose launch. ptr: gpu_total [S, 3], gpu_free [S, I, 3], gpu_valid
// [S, I], gpu_numa [S, I], choice [P], active [P], gpu_req [P, 3],
// affinity [P, Z] (or null), engaged [P] (or null), then the outputs
// count [P], per_inst [P, 3], inst [P], gate_active [P], seg [2, P], req
// [2, P, 3]. least: 1 for "least", 0 for "most".
extern "C" int koord_gpu_choose(const void* const* ptr, int P, int S, int I,
                                int Z, int least, float eps, void* stream) {
  if (P <= 0) return 0;
  if (S <= 0 || I <= 0 || I > MAX_I || Z <= 0 ||
      (long long)S * I + 1 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  gpu_choose_kernel<<<(P + THREADS - 1) / THREADS, THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)ptr[4], (const uint8_t*)ptr[5], (const float*)ptr[6],
      pool_of(ptr, S, I), (const uint8_t*)ptr[7], (const uint8_t*)ptr[8], P,
      Z, least, eps, (int32_t*)ptr[9], (float*)ptr[10], (int32_t*)ptr[11],
      (uint8_t*)ptr[12], (int32_t*)ptr[13], (float*)ptr[14]);
  return (int)cudaGetLastError();
}

// The take launch. ptr: gpu_total, gpu_free, gpu_valid, gpu_numa (as
// above), choice [P], alive [P], count [P], per_inst [P, 3], inst [P],
// affinity [P, Z] (or null), engaged [P] (or null), then the outputs
// accept [P], take [P, I], then a word a node of scratch, [S] int32.
extern "C" int koord_gpu_take(const void* const* ptr, int P, int S, int I,
                              int Z, float eps, void* stream) {
  if (P <= 0) return 0;
  if (S <= 0 || I <= 0 || I > MAX_I || Z <= 0 || ptr[13] == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* taken = (unsigned*)ptr[13];
  cudaError_t e = cudaMemsetAsync(taken, 0, (size_t)S * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (P + THREADS - 1) / THREADS;
  gpu_shared_taken_kernel<<<blocks, THREADS, 0, st>>>(
      (const int32_t*)ptr[4], (const uint8_t*)ptr[5], (const int32_t*)ptr[6],
      (const int32_t*)ptr[8], P, S, taken);
  gpu_take_kernel<<<blocks, THREADS, 0, st>>>(
      (const int32_t*)ptr[4], (const uint8_t*)ptr[5], (const int32_t*)ptr[6],
      (const float*)ptr[7], (const int32_t*)ptr[8], pool_of(ptr, S, I),
      (const uint8_t*)ptr[9], (const uint8_t*)ptr[10], P, Z, eps, taken,
      (uint8_t*)ptr[11], (uint8_t*)ptr[12]);
  return (int)cudaGetLastError();
}
