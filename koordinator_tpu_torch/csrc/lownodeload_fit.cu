// K10 lnl_node_fit: whether each pod fits some underutilized node
// (LowNodeLoad's node_fit: PodFitsAnyNode).
//
// Replaces koordinator_tpu/descheduler/lownodeload_device.py
// _plan_prelude's node_fit block (:103-111): node_req, each node's
// summed pod requests (the reference's scatter-add, in pod order; a pod
// of node -1 adds zeros, which change no sum), dest_free = capacity -
// node_req, and fits[p] = some low node n has pod_req[p] <= dest_free[n]
// + 0.5 on every fit dim: the reference's [P, N, F] comparison reduced
// over the low nodes.
//
// What bounds it on the H100: operations where pods fit late or not at
// all (a compare a dim for every pod and low node: 1.2e8 pairs at config
// 5 if none fit), bytes where they fit early (the [P, R] requests and
// [N, R] capacities once: about 1 MB at config 5).
//
// Design: two launches on the stream, one C call. The first gives each
// low node a warp, which walks the pods' node column 32 at a time and
// finds its pods with a ballot, adding their requests in pod order (one
// lane a fit dim), and appends the node's dest_free + 0.5 row to a
// compact list of low nodes (an atomic slot: `any` does not care about
// the list's order). The second gives each pod a thread, which scans the
// list from shared-memory tiles and stops at its first fit; a block
// stops when all its pods have one. With no fit dim (no pod requests
// anything) every pod fits once a low node exists, as in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 11;  // NUM_RESOURCES: the row stride of pod_req, capacity
constexpr int NODE_WARPS = 8;
constexpr int POD_THREADS = 256;
constexpr int TILE = 512;

// node_req and dest_free + 0.5 of each low node, appended to `dest`
__global__ void __launch_bounds__(NODE_WARPS * 32) low_node_rows(
    const float* __restrict__ pod_req, const int32_t* __restrict__ pod_node,
    const float* __restrict__ capacity, const uint8_t* __restrict__ low_mask,
    int P, int N, int F, unsigned fd_mask, float* __restrict__ dest,
    int* __restrict__ count) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * NODE_WARPS + (threadIdx.x >> 5);
  if (n >= N || !low_mask[n]) return;  // the whole warp leaves together
  // lane d < F owns fit dim fd[d]
  int dim = 0;
  for (int k = 0, seen = 0; k < R; ++k)
    if (fd_mask >> k & 1u) {
      if (seen == lane) dim = k;
      ++seen;
    }
  float acc = 0.0f;
  for (int base = 0; base < P; base += 32) {
    const int j = base + lane;
    unsigned m = __ballot_sync(0xffffffffu, j < P && pod_node[j] == n);
    while (m) {
      const int p = base + __ffs(m) - 1;
      m &= m - 1;
      if (lane < F) acc = __fadd_rn(acc, pod_req[(size_t)p * R + dim]);
    }
  }
  int slot = 0;
  if (lane == 0) slot = atomicAdd(count, 1);
  slot = __shfl_sync(0xffffffffu, slot, 0);
  if (lane < F)
    dest[(size_t)slot * F + lane] =
        __fadd_rn(__fsub_rn(capacity[(size_t)n * R + dim], acc), 0.5f);
}

__global__ void __launch_bounds__(POD_THREADS) pod_fits(
    const float* __restrict__ pod_req, int P, int F, unsigned fd_mask,
    const float* __restrict__ dest, const int* __restrict__ count,
    uint8_t* __restrict__ fits) {
  __shared__ float tile[TILE * R];
  const int p = blockIdx.x * POD_THREADS + threadIdx.x;
  float req[R];
#pragma unroll
  for (int d = 0; d < R; ++d) req[d] = 0.0f;
  if (p < P) {
    int d = 0;
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (fd_mask >> k & 1u) req[d++] = pod_req[(size_t)p * R + k];
  }
  const int L = *count;
  bool found = false;
  for (int t0 = 0; t0 < L; t0 += TILE) {
    const int rows = min(TILE, L - t0);
    for (int i = threadIdx.x; i < rows * F; i += POD_THREADS)
      tile[i] = dest[(size_t)t0 * F + i];
    __syncthreads();
    if (p < P && !found) {
      for (int e = 0; e < rows && !found; ++e) {
        bool ok = true;
#pragma unroll
        for (int d = 0; d < R; ++d)
          if (d < F) ok &= req[d] <= tile[e * F + d];
        found = ok;
      }
    }
    if (__syncthreads_and(found || p >= P)) break;
  }
  if (p < P) fits[p] = found;
}

}  // namespace

extern "C" int koord_lnl_node_fit(const void* pod_req, const void* pod_node,
                                  const void* capacity, const void* low_mask,
                                  void* dest, void* count, void* fits, int P,
                                  int N, int fd_mask, void* stream) {
  if (P <= 0) return 0;
  const unsigned mask = (unsigned)fd_mask;
  const int F = __builtin_popcount(mask);
  if (N < 0 || F > R || (mask >> R) != 0u)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  if (N > 0) {
    low_node_rows<<<(N + NODE_WARPS - 1) / NODE_WARPS, NODE_WARPS * 32, 0,
                    st>>>((const float*)pod_req, (const int32_t*)pod_node,
                          (const float*)capacity, (const uint8_t*)low_mask, P,
                          N, F, mask, (float*)dest, (int*)count);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  pod_fits<<<(P + POD_THREADS - 1) / POD_THREADS, POD_THREADS, 0, st>>>(
      (const float*)pod_req, P, F, mask, (const float*)dest,
      (const int*)count, (uint8_t*)fits);
  return (int)cudaGetLastError();
}
