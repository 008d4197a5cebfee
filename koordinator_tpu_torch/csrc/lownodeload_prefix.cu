// K12 lnl_plan_prefix: the uncapped LowNodeLoad plan's take, along the
// global eviction order, in one block.
//
// Replaces koordinator_tpu/descheduler/lownodeload_device.py
// plan_kernel (:162-187): along the order (pods of a node contiguous), a
// pod goes while its node is still over its high threshold on some dim
// after the earlier takes of that node (a segment exclusive prefix sum
// of the active pods' usage), while the budget is open on every dim
// after the earlier takes (an exclusive prefix sum of the taken pods'
// usage), and while fewer than max_evictions were taken (a count).
// The sums keep the reference's roundings exactly: each exclusive sum
// is its inclusive `jnp.cumsum` (XLA:CPU's blocked scan,
// lownodeload.cuh) minus the pod's own value, and the segment's is
// that minus its value at the segment's start; a segmented restart or
// a true exclusive scan rounds differently and can flip a take.
//
// What bounds it on the H100: neither bytes nor operations. It reads
// the order and a few [P] columns and writes [P] bools (about 0.4 MB
// at config 5, P = 11 800, Rd = 2), a few operations a pod and dim; the
// floor is the scans' levels, two a dim, each a few barriers deep.
//
// Design: one block of 1024 threads holds one dim's column of P floats
// in shared memory at a time (up to 16 384 pods: 64 KB), scans it in
// place, and folds each dim's verdict into a byte a pod (still over /
// budget open); the segment starts are one max-scan of ints, the count
// one add-scan, both exact in any order. Above 16 384 pods (a cluster
// that lists pods on every node) the same block keeps those arrays in
// device memory (scratch from the wrapper) instead: the scan is the
// same blocked-16 recursion, one level deeper, in the same order, so
// the sums and takes are the same.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lownodeload.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int MAX_P = 16384;

struct Args {
  const int32_t* order;
  const uint8_t* active;
  const int32_t* pod_node;
  const float* pod_usage_r;
  const float* usage_sel;
  const float* high_abs;
  const float* budget0;
  uint8_t* take;
  int P, N, RD, max_evictions;
};

size_t smem_bytes(int P) {
  // col f32[P], start i32[P], over u8[P], ok u8[P], scan levels (the
  // wrapper, kernels/lownodeload.py, sizes the same in device memory)
  return (size_t)P * 4 * 2 + (size_t)P * 2 + ((size_t)P / 15 + 32) * 4 + 16;
}

// work: the arrays of smem_bytes(P), in shared memory (null) or in
// device memory
__global__ void __launch_bounds__(THREADS) plan_prefix_kernel(Args a,
                                                              float* work) {
  extern __shared__ float smem[];
  const int P = a.P, N = a.N, RD = a.RD;
  float* col = work != nullptr ? work : smem;
  int* start = (int*)(col + P);
  uint8_t* over = (uint8_t*)(start + P);
  uint8_t* ok = over + P;
  float* scratch = (float*)(((uintptr_t)(ok + P) + 15) & ~(uintptr_t)15);
  __shared__ int warp_tot[32];
  const int tid = threadIdx.x, T = blockDim.x;

  // segment starts: the first pod of each run of one node in the order
  for (int i = tid; i < P; i += T) {
    const bool first =
        i == 0 || a.pod_node[a.order[i]] != a.pod_node[a.order[i - 1]];
    start[i] = first ? i : -1;
    over[i] = 0;
    ok[i] = 1;
  }
  __syncthreads();
  lnl::block_scan(start, P, [](int x, int y) { return max(x, y); }, -1,
                  warp_tot);

  // the node prefix: still over before this pod, on some dim
  for (int d = 0; d < RD; ++d) {
    for (int i = tid; i < P; i += T) {
      const int o = a.order[i];
      col[i] = a.active[o] ? a.pod_usage_r[o * RD + d] : 0.0f;
    }
    __syncthreads();
    lnl::xla_cumsum(col, P, scratch);
    for (int i = tid; i < P; i += T) {
      const int o = a.order[i];
      const int s = start[i];
      const int os = a.order[s];
      const float x = a.active[o] ? a.pod_usage_r[o * RD + d] : 0.0f;
      const float xs = a.active[os] ? a.pod_usage_r[os * RD + d] : 0.0f;
      const float ex = __fsub_rn(col[i], x);
      const float ex_s = __fsub_rn(col[s], xs);
      const float seg = __fsub_rn(ex, ex_s);
      int n = a.pod_node[o];
      n = n < 0 ? n + N : n;  // the reference's negative gather
      n = min(max(n, 0), N - 1);
      if (__fsub_rn(a.usage_sel[n * RD + d], seg) > a.high_abs[n * RD + d])
        over[i] = 1;
    }
    __syncthreads();
  }
  for (int i = tid; i < P; i += T)
    over[i] = over[i] && a.active[a.order[i]];  // take0
  __syncthreads();

  // the budget prefix: open on every dim before this pod
  for (int d = 0; d < RD; ++d) {
    for (int i = tid; i < P; i += T)
      col[i] = over[i] ? a.pod_usage_r[a.order[i] * RD + d] : 0.0f;
    __syncthreads();
    lnl::xla_cumsum(col, P, scratch);
    const float b0 = a.budget0[d];
    for (int i = tid; i < P; i += T) {
      const float y = over[i] ? a.pod_usage_r[a.order[i] * RD + d] : 0.0f;
      if (!(__fsub_rn(b0, __fsub_rn(col[i], y)) > 0.0f)) ok[i] = 0;
    }
    __syncthreads();
  }

  // the per-cycle cap: fewer than max_evictions taken before this pod
  for (int i = tid; i < P; i += T) start[i] = over[i];
  __syncthreads();
  lnl::block_scan(start, P, [](int x, int y) { return x + y; }, 0, warp_tot);
  for (int i = tid; i < P; i += T) {
    const int before = start[i] - over[i];
    a.take[a.order[i]] = over[i] && ok[i] && before < a.max_evictions;
  }
}

}  // namespace

extern "C" int koord_lnl_plan_prefix(const void* const* ptr, const int* dims,
                                     void* stream) {
  Args a;
  a.order = (const int32_t*)ptr[0];
  a.active = (const uint8_t*)ptr[1];
  a.pod_node = (const int32_t*)ptr[2];
  a.pod_usage_r = (const float*)ptr[3];
  a.usage_sel = (const float*)ptr[4];
  a.high_abs = (const float*)ptr[5];
  a.budget0 = (const float*)ptr[6];
  a.take = (uint8_t*)ptr[7];
  a.P = dims[0];
  a.N = dims[1];
  a.RD = dims[2];
  a.max_evictions = dims[3];
  if (a.P <= 0) return 0;
  float* work = (float*)ptr[8];  // [smem_bytes(P) / 4] above MAX_P
  if (a.N < 1 || a.RD < 1 || a.RD > lnl::MAX_RD ||
      (a.P > MAX_P && work == nullptr))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        plan_prefix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(MAX_P));
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  if (a.P > MAX_P)
    plan_prefix_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(a, work);
  else
    plan_prefix_kernel<<<1, THREADS, smem_bytes(a.P),
                         (cudaStream_t)stream>>>(a, nullptr);
  return (int)cudaGetLastError();
}
