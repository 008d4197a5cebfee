// K13 lnl_plan_capped: the LowNodeLoad plan under per-node,
// per-namespace and per-cycle eviction caps: one walk along the global
// eviction order.
//
// Replaces koordinator_tpu/descheduler/lownodeload_device.py
// plan_kernel_capped (:231-276), a `lax.scan` whose step keeps the
// host loop's order of operations: on a node's first pod (the order
// keeps a node's pods together) reset the removed usage and seed the
// node's count from the limiter's count so far; want = active, the
// node still over its high threshold after its removed usage on some
// dim, the budget open on every dim; allow = under the cycle, node and
// namespace caps (1 << 30 = unlimited); a taken pod adds its usage
// times 1.0 to the removed usage, subtracts it from the budget and
// counts once in the three tallies, a skipped pod the same times 0.0.
// A refused pod subtracts nothing and the walk goes on, so the taken
// set is no prefix: the decisions are sequential by nature.
//
// What bounds it on the H100: the chain of dependent steps, not bytes
// or operations: about 30 operations a pod in a row (P = 11 800 at
// config 5, one step a pod), against 1.1 MB of columns read once.
//
// Design: one block; thread 0 walks a chunk of the order with the
// carry in registers and the namespace counts in shared memory, while
// the other warps gather the next chunk's columns (the pod's usage,
// its node's usage and high threshold, its flags, namespace and node
// count) into the other half of a double buffer, so that the walker
// reads shared memory only.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lownodeload.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 256;
constexpr int MAX_NS = 32768;
constexpr int RD_MAX = lnl::MAX_RD;

struct Args {
  const int32_t* order;
  const uint8_t* active;
  const int32_t* pod_node;
  const float* pod_usage_r;
  const float* usage_sel;
  const float* high_abs;
  const float* budget0;
  const int32_t* pod_ns;
  const int32_t* ns_counts0;
  const int32_t* per_node0;
  uint8_t* take;
  int P, N, RD, NS, max_evictions, max_per_node, max_per_ns;
};

// one chunk of staged steps
struct Stage {
  float u[CHUNK][RD_MAX];
  float un[CHUNK][RD_MAX];
  float ha[CHUNK][RD_MAX];
  int flags[CHUNK];  // bit 0: a node's first pod; bit 1: active
  int nsid[CHUNK];
  int cnt0[CHUNK];
  int pod[CHUNK];
};

size_t smem_bytes(int NS) { return 2 * sizeof(Stage) + (size_t)NS * 4; }

__device__ void stage(const Args& a, Stage& s, int c, int worker,
                      int workers) {
  const int RD = a.RD;
  for (int j = worker; j < CHUNK; j += workers) {
    const int i = c * CHUNK + j;
    if (i >= a.P) break;
    const int o = a.order[i];
    const int raw = a.pod_node[o];
    const bool first = i == 0 || raw != a.pod_node[a.order[i - 1]];
    int n = raw < 0 ? raw + a.N : raw;  // the reference's negative gather
    n = min(max(n, 0), a.N - 1);
    s.flags[j] = (first ? 1 : 0) | (a.active[o] ? 2 : 0);
    s.nsid[j] = min(max(a.pod_ns[o], 0), a.NS - 1);
    s.cnt0[j] = a.per_node0[n];
    s.pod[j] = o;
    for (int d = 0; d < RD; ++d) {
      s.u[j][d] = a.pod_usage_r[o * RD + d];
      s.un[j][d] = a.usage_sel[n * RD + d];
      s.ha[j][d] = a.high_abs[n * RD + d];
    }
  }
}

// RDC: the threshold dims, a compile-time count so that the walker's
// per-dim loops unroll to exactly RDC steps
template <int RDC>
__global__ void __launch_bounds__(THREADS) plan_capped_kernel(Args a) {
  extern __shared__ float smem[];
  Stage* buf = (Stage*)smem;
  int* counts = (int*)(buf + 2);
  const int tid = threadIdx.x;
  for (int k = tid; k < a.NS; k += THREADS) counts[k] = a.ns_counts0[k];
  const int chunks = (a.P + CHUNK - 1) / CHUNK;
  stage(a, buf[0], 0, tid, THREADS);
  __syncthreads();

  float removed[RDC], budget[RDC];
#pragma unroll
  for (int d = 0; d < RDC; ++d) {
    removed[d] = 0.0f;
    budget[d] = a.budget0[d];
  }
  int node_cnt = 0, total = 0;
  for (int c = 0; c < chunks; ++c) {
    if (tid == 0) {
      const Stage& s = buf[c & 1];
      const int steps = min(CHUNK, a.P - c * CHUNK);
      for (int j = 0; j < steps; ++j) {
        const int f = s.flags[j];
        if (f & 1) {
#pragma unroll
          for (int d = 0; d < RDC; ++d) removed[d] = 0.0f;
          node_cnt = s.cnt0[j];
        }
        bool still = false, open = true;
#pragma unroll
        for (int d = 0; d < RDC; ++d) {
          still |= __fsub_rn(s.un[j][d], removed[d]) > s.ha[j][d];
          open &= budget[d] > 0.0f;
        }
        const int ns = s.nsid[j];
        const bool want = (f & 2) && still && open;
        const bool allow = total < a.max_evictions &&
                           node_cnt < a.max_per_node &&
                           counts[ns] < a.max_per_ns;
        const bool take = want && allow;
        const float tf = take ? 1.0f : 0.0f;
#pragma unroll
        for (int d = 0; d < RDC; ++d) {
          const float x = __fmul_rn(s.u[j][d], tf);
          removed[d] = __fadd_rn(removed[d], x);
          budget[d] = __fsub_rn(budget[d], x);
        }
        total += take;
        node_cnt += take;
        counts[ns] += take;
        a.take[s.pod[j]] = take;
      }
    } else if (tid >= 32 && c + 1 < chunks) {
      // warps 1.. stage (warp 0's other lanes would share its issue
      // slots with the walker)
      stage(a, buf[(c + 1) & 1], c + 1, tid - 32, THREADS - 32);
    }
    __syncthreads();
  }
}

template <int RDC>
int launch(const Args& a, void* stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        plan_capped_kernel<RDC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(MAX_NS));
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  plan_capped_kernel<RDC><<<1, THREADS, smem_bytes(a.NS),
                            (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int koord_lnl_plan_capped(const void* const* ptr, const int* dims,
                                     void* stream) {
  Args a;
  a.order = (const int32_t*)ptr[0];
  a.active = (const uint8_t*)ptr[1];
  a.pod_node = (const int32_t*)ptr[2];
  a.pod_usage_r = (const float*)ptr[3];
  a.usage_sel = (const float*)ptr[4];
  a.high_abs = (const float*)ptr[5];
  a.budget0 = (const float*)ptr[6];
  a.pod_ns = (const int32_t*)ptr[7];
  a.ns_counts0 = (const int32_t*)ptr[8];
  a.per_node0 = (const int32_t*)ptr[9];
  a.take = (uint8_t*)ptr[10];
  a.P = dims[0];
  a.N = dims[1];
  a.RD = dims[2];
  a.NS = dims[3];
  a.max_evictions = dims[4];
  a.max_per_node = dims[5];
  a.max_per_ns = dims[6];
  if (a.P <= 0) return 0;
  if (a.N < 1 || a.RD < 1 || a.RD > RD_MAX || a.NS < 1 || a.NS > MAX_NS)
    return (int)cudaErrorInvalidValue;
  switch (a.RD) {
    case 1: return launch<1>(a, stream);
    case 2: return launch<2>(a, stream);
    case 3: return launch<3>(a, stream);
    case 4: return launch<4>(a, stream);
    case 5: return launch<5>(a, stream);
    case 6: return launch<6>(a, stream);
    case 7: return launch<7>(a, stream);
    case 8: return launch<8>(a, stream);
    case 9: return launch<9>(a, stream);
    case 10: return launch<10>(a, stream);
    default: return launch<11>(a, stream);
  }
}
