// K19 node_overcommit: koord-manager's batch and mid allocatable of
// every node, in one launch.
//
// Replaces koordinator_tpu/slo_controller/noderesource.py:166
// _batch_allocatable and :190 _mid_allocatable (batchresource
// util.go:38-90, midresource plugin.go:130-160), columns (cpu, memory):
//
//   by_usage   = max(capacity - reserved - max(sys_used, sys_reserved)
//                    - hp_used, 0)
//   by_request = max(capacity - reserved - sys_reserved - hp_request, 0)
//   by_max     = max(capacity - reserved - max(sys_used, sys_reserved)
//                    - hp_max_used_req, 0)
//   batch cpu  = cpu_by_max ? by_max : by_usage
//   batch mem  = by_request (policy 1), by_max (2), else by_usage
//   mid        = max(min(prod_reclaimable, allocatable * ratio), 0)
//
// Exactness: the subtractions run left to right as written, each
// rounded (__fsub_rn), the product once (__fmul_rn); max and min are
// XLA's (guard.cuh: a NaN operand wins, signed zeros ordered), because
// NodeMetric values are reported from outside and may be NaN or
// infinite. A NaN's payload is the card's own (the card does not
// propagate payloads); NaN rows stay NaN as on the host.
//
// What bounds it on the H100: bytes, and few of them (101 bytes a
// node); at 10 000 nodes the launch costs more than the work.
//
// Design: one thread a node, both columns and both tiers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "guard.cuh"

namespace {

using koord_guard::xla_max;
using koord_guard::xla_min;

constexpr int THREADS = 256;

struct Cols {
  const float* cap;
  const float* reserved;
  const float* sys_reserved;
  const float* sys_used;
  const float* hp_req;
  const float* hp_used;
  const float* hp_max;
  const uint8_t* cpu_by_max;
  const int32_t* mem_policy;
  const float* alloc;
  const float* reclaim;
  const float* ratio;
};

__global__ void __launch_bounds__(THREADS) node_overcommit_kernel(
    Cols in, int N, float* __restrict__ batch, float* __restrict__ mid) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  float by_usage[2], by_request[2], by_max[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int i = 2 * n + c;
    const float base = __fsub_rn(in.cap[i], in.reserved[i]);
    const float sys_eff = xla_max(in.sys_used[i], in.sys_reserved[i]);
    by_usage[c] = xla_max(__fsub_rn(__fsub_rn(base, sys_eff), in.hp_used[i]),
                          0.0f);
    by_request[c] = xla_max(
        __fsub_rn(__fsub_rn(base, in.sys_reserved[i]), in.hp_req[i]), 0.0f);
    by_max[c] = xla_max(__fsub_rn(__fsub_rn(base, sys_eff), in.hp_max[i]),
                        0.0f);
    mid[i] = xla_max(
        xla_min(in.reclaim[i], __fmul_rn(in.alloc[i], in.ratio[i])), 0.0f);
  }
  const int policy = in.mem_policy[n];
  batch[2 * n] = in.cpu_by_max[n] ? by_max[0] : by_usage[0];
  batch[2 * n + 1] = policy == 1   ? by_request[1]
                     : policy == 2 ? by_max[1]
                                   : by_usage[1];
}

}  // namespace

// capacity, node_reserved, system_reserved, system_used, hp_request,
// hp_used, hp_max_used_req, allocatable, prod_reclaimable,
// threshold_ratio f32[N, 2]; cpu_by_max bool[N]; mem_policy i32[N];
// writes batch and mid f32[N, 2].
extern "C" int koord_node_overcommit(
    const void* cap, const void* reserved, const void* sys_reserved,
    const void* sys_used, const void* hp_req, const void* hp_used,
    const void* hp_max, const void* cpu_by_max, const void* mem_policy,
    const void* alloc, const void* reclaim, const void* ratio, int N,
    void* batch, void* mid, void* stream) {
  if (N <= 0) return 0;
  const Cols in{(const float*)cap,          (const float*)reserved,
                (const float*)sys_reserved, (const float*)sys_used,
                (const float*)hp_req,       (const float*)hp_used,
                (const float*)hp_max,       (const uint8_t*)cpu_by_max,
                (const int32_t*)mem_policy, (const float*)alloc,
                (const float*)reclaim,      (const float*)ratio};
  const int blocks = (N + THREADS - 1) / THREADS;
  node_overcommit_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      in, N, (float*)batch, (float*)mid);
  return (int)cudaGetLastError();
}
