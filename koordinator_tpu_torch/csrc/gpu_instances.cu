// K7 gpu_instance_pick: the GPU instance gates of one inner commit step,
// a warp a pod on its chosen node, in two launches around K2.
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
//   without a [P, P] tensor). It also zeroes the take's word of each
//   pod's chosen node;
// - the take launch (`koord_gpu_take`), after it: one cooperative
//   kernel. The surviving shared pods OR their instances into their
//   nodes' words; a grid barrier; then each surviving multi-GPU pod
//   takes the lowest-index `count` instances of its node that fit, lie
//   in its affinity and no shared pod of the step took (:246
//   full_fit_instances with the `exclude`, its node's word), or is
//   rejected when there are fewer. It writes the step's final accept
//   and each pod's instances, bool take[P, I]. Only the first multi-GPU
//   pod of a node survives K2's gate, so no take depends on another
//   multi-GPU pod's: the order of the pods plays no part. The take reads
//   only the words of nodes that some pod of the step chose, which the
//   choose launch zeroed: no memset of its own.
//
// What bounds it on the H100: the launches, then the latency of a pod's
// chain of loads. A pod reads its node's I <= 64 instance rows (12
// bytes each) and does a few dozen compares and a handful of correctly
// rounded divisions; a step of 2000 pods moves well under 1 MB.
//
// Design: a warp a pod in both launches (2000 pods: 2000 warps, spread
// over the 132 SMs). Lane l reads instance
// l and l + 32, so a node's rows come in as one coalesced read. The
// choose reduces each lane's best instance over the warp with shuffles
// (the key, then the lower index); the take's warp gathers its
// instances' verdicts with a ballot a 32 of them, and the lowest
// `count` set bits are those with fewer than `count` set bits below.
// An instance bit lives in a 64-bit word.
//
// Exactness against the reference (bit for bit): the file builds with
// -fmad=false; the per-instance request and the fit test are
// device_share.cuh's, and the choosers compare without arithmetic (the
// keys are never NaN: a NaN free fails the fit test).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_share.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;        // the choose's blocks
constexpr int WARPS = THREADS / 32;
constexpr int TAKE_THREADS = 1024;  // the take's: fewer blocks to barrier
constexpr int TAKE_WARPS = TAKE_THREADS / 32;
constexpr int MAX_I = 64;
constexpr unsigned FULL = 0xffffffffu;

struct Pool {
  const float* total;    // [S, 3]
  const float* free_;    // [S, I, 3] live
  const uint8_t* valid;  // [S, I]
  const int32_t* numa;   // [S, I]
  int S, I;
};

// An instance's row: its valid bit, live free and zone. The loads go
// out together; they depend on the node alone.
struct Row {
  bool valid;
  float f[3];
  int zid;
};

__device__ __forceinline__ Row load_row(const Pool& g, int nc, int i) {
  const size_t o = (size_t)nc * g.I + i;
  return Row{g.valid[o] != 0,
             {g.free_[o * 3], g.free_[o * 3 + 1], g.free_[o * 3 + 2]},
             g.numa[o]};
}

// The instance fits the per-instance request and lies in the pod's
// affinity (or the pod is not engaged): deviceshare.py _zone_allowed.
__device__ __forceinline__ bool usable(const Row& r, const float* per,
                                       float eps, const uint8_t* affinity,
                                       bool engaged, int p, int Z) {
  if (!r.valid || !koord_dev::covers(r.f, per, eps)) return false;
  if (!engaged) return true;
  return r.zid >= 0 && affinity[(size_t)p * Z + min(r.zid, Z - 1)];
}

__global__ void __launch_bounds__(THREADS) gpu_choose_kernel(
    const int32_t* __restrict__ choice, const uint8_t* __restrict__ active,
    const float* __restrict__ gpu_req, Pool g,
    const uint8_t* __restrict__ affinity, const uint8_t* __restrict__ engaged,
    int P, int Z, int least, float eps, int32_t* __restrict__ out_count,
    float* __restrict__ out_per, int32_t* __restrict__ out_inst,
    uint8_t* __restrict__ out_gate, int32_t* __restrict__ out_seg,
    float* __restrict__ out_req, unsigned long long* __restrict__ taken) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (p >= P) return;  // the whole warp
  const int c = choice[p];
  const int nc = min(max(c, 0), g.S - 1);
  // the lane's first row goes out before the request's arithmetic
  Row row = lane < g.I ? load_row(g, nc, lane) : Row{};
  const koord_dev::PerInst pi = koord_dev::per_instance(
      g.total[(size_t)nc * 3 + 1], gpu_req[(size_t)p * 3],
      gpu_req[(size_t)p * 3 + 1], gpu_req[(size_t)p * 3 + 2]);
  const bool shared = pi.count == 1, multi = pi.count > 1;
  const bool eng = engaged != nullptr && engaged[p];
  const bool act = active[p] != 0;
  // the lane's best instance, then the warp's: the better key, then the
  // lower index (every pod's, as the reference's chooser returns it)
  int inst = MAX_I;  // none
  float best = 0.0f;
  for (int i = lane; i < g.I; i += 32) {
    if (i != lane) row = load_row(g, nc, i);
    if (!usable(row, pi.v, eps, affinity, eng, p, Z)) continue;
    const float key = row.f[0];  // free core
    if (inst == MAX_I || (least ? key > best : key < best)) {
      inst = i;
      best = key;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int oi = __shfl_xor_sync(FULL, inst, off);
    const float ob = __shfl_xor_sync(FULL, best, off);
    const bool take = oi != MAX_I &&
                      (inst == MAX_I || (least ? ob > best : ob < best) ||
                       (ob == best && oi < inst));
    if (take) {
      inst = oi;
      best = ob;
    }
  }
  if (lane != 0) return;
  const bool any = inst != MAX_I;
  if (!any) inst = 0;
  const bool gate = act && (!shared || any);
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
  taken[nc] = 0ull;
}

struct Take {
  const int32_t* choice;    // [P]
  const uint8_t* alive;     // [P]
  const int32_t* count;     // [P]
  const float* per;         // [P, 3]
  const int32_t* inst;      // [P]
  const uint8_t* affinity;  // [P, Z] or null
  const uint8_t* engaged;   // [P] or null
  uint8_t* accept;          // [P]
  uint8_t* take;            // [P, I]
  unsigned long long* taken;  // [S], the chosen nodes' words zeroed
  int P, Z;
  float eps;
};

// The take: the surviving shared pods' instances into their nodes'
// words, a grid barrier, then a warp a pod: its final accept and
// instances.
__global__ void __launch_bounds__(TAKE_THREADS) gpu_take_kernel(Take t,
                                                                Pool g) {
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * TAKE_THREADS + threadIdx.x;
  const int stride = gridDim.x * TAKE_THREADS;
  for (int p = tid; p < t.P; p += stride) {
    // the pod's columns load together
    const bool alive = t.alive[p] != 0;
    const int c = t.count[p], node = t.choice[p], inst = t.inst[p];
    if (alive && c == 1 && node >= 0 && node < g.S)
      atomicOr(t.taken + node, 1ull << inst);
  }
  grid.sync();
  const int lane = threadIdx.x & 31;
  for (int p = tid >> 5; p < t.P; p += stride >> 5) {
    // the pod's columns load together, a multi-GPU pod's too
    const int c = t.count[p];
    const bool alive = t.alive[p] != 0;
    const int inst = t.inst[p];
    const int nc = min(max(t.choice[p], 0), g.S - 1);
    const bool eng = t.engaged != nullptr && t.engaged[p];
    const float pv[3] = {t.per[(size_t)p * 3], t.per[(size_t)p * 3 + 1],
                         t.per[(size_t)p * 3 + 2]};
    unsigned long long mask = 0;  // the shared pod's instance, or the
                                  // multi-GPU pod's candidates
    bool acc = alive;
    if (alive && c == 1) {
      mask = 1ull << inst;
    } else if (alive && c > 1) {
      const unsigned long long exclude = __ldcg(t.taken + nc);
      for (int i0 = 0; i0 < g.I; i0 += 32) {
        const int i = i0 + lane;
        const bool ok = i < g.I && !((exclude >> i) & 1ull) &&
                        usable(load_row(g, nc, i), pv, t.eps, t.affinity,
                               eng, p, t.Z);
        mask |= (unsigned long long)__ballot_sync(FULL, ok) << i0;
      }
      acc = __popcll(mask) >= c;
    }
    if (lane == 0) t.accept[p] = acc;
    for (int i = lane; i < g.I; i += 32) {
      // the lowest `count` candidates: those with fewer below them
      const bool in = acc && ((mask >> i) & 1ull) &&
                      (c == 1 || __popcll(mask & ((1ull << i) - 1ull)) < c);
      t.take[(size_t)p * g.I + i] = in;
    }
  }
}

Pool pool_of(const void* const* ptr, int S, int I) {
  return Pool{(const float*)ptr[0], (const float*)ptr[1],
              (const uint8_t*)ptr[2], (const int32_t*)ptr[3], S, I};
}

bool shape_ok(int S, int I, int Z) {
  return S > 0 && I > 0 && I <= MAX_I && Z > 0 &&
         (long long)S * I + 1 <= 0x7fffffffLL;
}

}  // namespace

// The choose launch. ptr: gpu_total [S, 3], gpu_free [S, I, 3], gpu_valid
// [S, I], gpu_numa [S, I], choice [P], active [P], gpu_req [P, 3],
// affinity [P, Z] (or null), engaged [P] (or null), then the outputs
// count [P], per_inst [P, 3], inst [P], gate_active [P], seg [2, P], req
// [2, P, 3], and the take's words, [S] 64-bit (those of the chosen nodes
// zeroed). least: 1 for "least", 0 for "most".
extern "C" int koord_gpu_choose(const void* const* ptr, int P, int S, int I,
                                int Z, int least, float eps, void* stream) {
  if (P <= 0) return 0;
  if (!shape_ok(S, I, Z) || ptr[15] == nullptr)
    return (int)cudaErrorInvalidValue;
  gpu_choose_kernel<<<(P + WARPS - 1) / WARPS, THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)ptr[4], (const uint8_t*)ptr[5], (const float*)ptr[6],
      pool_of(ptr, S, I), (const uint8_t*)ptr[7], (const uint8_t*)ptr[8], P,
      Z, least, eps, (int32_t*)ptr[9], (float*)ptr[10], (int32_t*)ptr[11],
      (uint8_t*)ptr[12], (int32_t*)ptr[13], (float*)ptr[14],
      (unsigned long long*)ptr[15]);
  return (int)cudaGetLastError();
}

// The take launch. ptr: gpu_total, gpu_free, gpu_valid, gpu_numa (as
// above), choice [P] (the choose launch's), alive [P], count [P],
// per_inst [P, 3], inst [P], affinity [P, Z] (or null), engaged [P] (or
// null), then the outputs accept [P], take [P, I], then the choose
// launch's words, [S] 64-bit.
extern "C" int koord_gpu_take(const void* const* ptr, int P, int S, int I,
                              int Z, float eps, void* stream) {
  if (P <= 0) return 0;
  if (!shape_ok(S, I, Z) || ptr[13] == nullptr)
    return (int)cudaErrorInvalidValue;
  // the current card's SMs and the blocks of the take an SM holds, kept
  // a card (the launch goes to the current card)
  constexpr int MAX_CARDS = 64;
  static int sms_of[MAX_CARDS], per_sm_of[MAX_CARDS];
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < MAX_CARDS && sms_of[dev]) {
    sms = sms_of[dev];
    per_sm = per_sm_of[dev];
  } else {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gpu_take_kernel, TAKE_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_CARDS) {
      per_sm_of[dev] = per_sm;
      sms_of[dev] = sms;
    }
  }
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // a warp a pod, at most one block an SM: the barrier's cost grows with
  // the blocks, and a warp takes the next pod after its first
  const int need = (P + TAKE_WARPS - 1) / TAKE_WARPS;
  const int blocks = need < sms ? need : sms;
  Take t{(const int32_t*)ptr[4], (const uint8_t*)ptr[5],
         (const int32_t*)ptr[6], (const float*)ptr[7], (const int32_t*)ptr[8],
         (const uint8_t*)ptr[9], (const uint8_t*)ptr[10], (uint8_t*)ptr[11],
         (uint8_t*)ptr[12], (unsigned long long*)ptr[13], P, Z, eps};
  Pool g = pool_of(ptr, S, I);
  void* args[] = {(void*)&t, (void*)&g};
  e = cudaLaunchCooperativeKernel((const void*)gpu_take_kernel, dim3(blocks),
                                  dim3(TAKE_THREADS), args, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
