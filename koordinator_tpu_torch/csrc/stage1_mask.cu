// K9 stage1_mask: the cascade's stage-1 candidate mask of one batch, every
// (pod, node) pair in one pass.
//
// Replaces koordinator_tpu/scheduler/cascade.py:117 stage1_mask over
// ops/feasibility.py:44 resource_fit, :60 pod_ancestors and :72
// quota_ceiling_ok, applied to the static gates (cascade.py:75
// static_gates and the zero-instance device term), which XLA runs as
// broadcasts over [P, N, F] and [P, D, F]. It writes bool[P, N]: the
// pair passes the static gates (the factored terms kernel K1 takes:
// the pod's device term, the selector table over the node's label
// group, the LoadAware usage gate (node_ok or prod_node_ok, passed on
// a stale metric or by a DaemonSet pod), `schedulable`, and with
// tolerations the forbid table over (toleration set, taint group)),
// AND fl(req + requested) <= fl(alloc + eps) on each of the F checked
// dims (the batch-start fit, exactly K1's round fit), AND the pod's
// quota ceiling: fl(used + req) <= fl(runtime + eps) on each dim at
// each of the first `quota_depth` levels of its ancestor chain (a
// level without an ancestor passes). Table indices follow the
// reference's rule (K1's: a negative selector id matches all, a
// negative label or taint group counts from the table's end, indices
// out of range clamp to its last row or column).
//
// What bounds it on the H100: bytes. A pair costs F adds and compares
// and a few table loads that L1 holds; the [P, N] bytes written
// dominate: 20 MB a full-gate chunk (P = 2000, N = 10^4), 6 us at
// 3.35 TB/s.
//
// Design: a block of 256 threads owns a tile of 256 nodes and 16 pods.
// The first 16 threads reduce their pod's row terms (the device term
// and the quota ceiling, D x F compares) into shared memory beside the
// pods' requests; each thread then holds its node's columns in
// registers (requested, alloc + eps, the gate terms) and walks the 16
// pods, so a warp writes 32 consecutive bytes of one pod row at a time.
//
// Exactness: the file builds with -fmad=false and names its roundings;
// alloc + eps is rounded once a node and compared with the rounded sum
// of each pair, as the reference's broadcast does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 256;  // nodes a block (one a thread)
constexpr int PODS = 16;   // pods a block
constexpr int MAX_F = 11;

struct Args {
  // per pod [P]
  const int32_t* selector_id;
  const uint8_t* prod_gate;
  const uint8_t* daemonset;
  const uint8_t* device_ok;
  const int32_t* toleration_id;  // null without tolerations
  const float* req;              // [P, F]
  const int32_t* pod_anc;        // [P, D]
  // per node [N]
  const int32_t* label_group;
  const uint8_t* node_ok;
  const uint8_t* prod_node_ok;
  const uint8_t* fresh;
  const uint8_t* schedulable;
  const int32_t* taint_group;    // null without tolerations
  const float* requested;        // [N, F]
  const float* alloc;            // [N, F]
  // tables
  const uint8_t* selector_match;  // [S, L]
  const uint8_t* tol_forbid;      // [T, G] or null
  const float* quota_used;        // [Q, F]
  const float* quota_runtime;     // [Q, F]
  uint8_t* out;                   // [P, N]
  int P, N, F, S, L, T, G, D, quota_depth, Q;
  float eps;
};

// A table column by the reference's rule: negative counts from the end,
// out of range clamps to the last.
__device__ __forceinline__ int column(int c, int n) {
  return min(max(c < 0 ? c + n : c, 0), max(n - 1, 0));
}

__global__ void __launch_bounds__(THREADS) stage1_mask_kernel(Args a) {
  __shared__ float s_req[PODS][MAX_F];
  __shared__ uint8_t s_alive[PODS];  // device term and quota ceiling
  __shared__ int s_sel[PODS];        // selector row, -1 = match all
  __shared__ int s_tol[PODS];        // toleration row
  __shared__ uint8_t s_prod[PODS];   // held to the prod-usage gate
  __shared__ uint8_t s_ds[PODS];     // DaemonSet

  const int t = threadIdx.x;
  const int n0 = blockIdx.x * TILE, p0 = blockIdx.y * PODS;
  const int F = a.F;
  for (int e = t; e < PODS * MAX_F; e += THREADS) {
    const int i = e / MAX_F, f = e - i * MAX_F;
    s_req[i][f] = p0 + i < a.P && f < F ? a.req[(size_t)(p0 + i) * F + f]
                                        : 0.0f;
  }
  if (t < PODS) {
    const int p = p0 + t;
    bool alive = false;
    int sel = -1, tol = 0;
    uint8_t prod = 0, ds = 0;
    if (p < a.P) {
      alive = a.device_ok[p] != 0;
      for (int d = 0; d < a.quota_depth && alive; ++d) {
        const int anc = a.pod_anc[(size_t)p * a.D + d];
        if (anc < 0) continue;
        const int q = min(anc, a.Q - 1);
        for (int f = 0; f < F; ++f) {
          const float r = a.req[(size_t)p * F + f];
          alive = alive && __fadd_rn(a.quota_used[(size_t)q * F + f], r)
                               <= __fadd_rn(a.quota_runtime[(size_t)q * F + f],
                                            a.eps);
        }
      }
      const int s = a.selector_id[p];
      sel = s < 0 ? -1 : (a.S > 0 ? min(s, a.S - 1) : -2);
      if (a.tol_forbid != nullptr)
        tol = min(max(a.toleration_id[p], 0), max(a.T - 1, 0));
      prod = a.prod_gate[p];
      ds = a.daemonset[p];
    }
    s_alive[t] = alive;
    s_sel[t] = sel;
    s_tol[t] = tol;
    s_prod[t] = prod;
    s_ds[t] = ds;
  }
  __syncthreads();
  const int n = n0 + t;
  if (n >= a.N) return;

  float rq[MAX_F], al[MAX_F];
#pragma unroll
  for (int f = 0; f < MAX_F; ++f) {
    rq[f] = f < F ? a.requested[(size_t)n * F + f] : 0.0f;
    al[f] = f < F ? __fadd_rn(a.alloc[(size_t)n * F + f], a.eps) : 0.0f;
  }
  const int label = column(a.label_group[n], a.L);
  const int tg = a.tol_forbid != nullptr ? column(a.taint_group[n], a.G) : 0;
  const bool stale = a.fresh[n] == 0;
  const bool ok_usage = a.node_ok[n] != 0, ok_prod = a.prod_node_ok[n] != 0;
  const bool sched = a.schedulable[n] != 0;

  for (int i = 0; i < PODS; ++i) {
    const int p = p0 + i;
    if (p >= a.P) break;
    bool ok = sched && s_alive[i];
    const int sel = s_sel[i];
    if (sel != -1)
      ok = ok && sel >= 0 && a.selector_match[(size_t)sel * a.L + label];
    ok = ok && (stale || s_ds[i] || (s_prod[i] ? ok_prod : ok_usage));
    if (a.tol_forbid != nullptr)
      ok = ok && !a.tol_forbid[(size_t)s_tol[i] * a.G + tg];
#pragma unroll
    for (int f = 0; f < MAX_F; ++f)
      if (f < F) ok = ok && __fadd_rn(s_req[i][f], rq[f]) <= al[f];
    a.out[(size_t)p * a.N + n] = ok;
  }
}

}  // namespace

// ptr: selector_id, prod_gate, daemonset, device_ok, toleration_id (or
// null), req [P, F], pod_anc [P, D], label_group, node_ok, prod_node_ok,
// metric_fresh, schedulable, taint_group (or null), requested [N, F],
// alloc [N, F], selector_match [S, L], tol_forbid [T, G] (or null;
// with toleration_id and taint_group), quota_used [Q, F], quota_runtime
// [Q, F], out [P, N]. dims: P, N, F, S, L, T, G, D, quota_depth, Q.
// eps: the gate tolerance.
extern "C" int koord_stage1_mask(const void* const* ptr, const int* dims,
                                 float eps, void* stream) {
  Args a;
  a.selector_id = (const int32_t*)ptr[0];
  a.prod_gate = (const uint8_t*)ptr[1];
  a.daemonset = (const uint8_t*)ptr[2];
  a.device_ok = (const uint8_t*)ptr[3];
  a.toleration_id = (const int32_t*)ptr[4];
  a.req = (const float*)ptr[5];
  a.pod_anc = (const int32_t*)ptr[6];
  a.label_group = (const int32_t*)ptr[7];
  a.node_ok = (const uint8_t*)ptr[8];
  a.prod_node_ok = (const uint8_t*)ptr[9];
  a.fresh = (const uint8_t*)ptr[10];
  a.schedulable = (const uint8_t*)ptr[11];
  a.taint_group = (const int32_t*)ptr[12];
  a.requested = (const float*)ptr[13];
  a.alloc = (const float*)ptr[14];
  a.selector_match = (const uint8_t*)ptr[15];
  a.tol_forbid = (const uint8_t*)ptr[16];
  a.quota_used = (const float*)ptr[17];
  a.quota_runtime = (const float*)ptr[18];
  a.out = (uint8_t*)ptr[19];
  a.P = dims[0];
  a.N = dims[1];
  a.F = dims[2];
  a.S = dims[3];
  a.L = dims[4];
  a.T = dims[5];
  a.G = dims[6];
  a.D = dims[7];
  a.quota_depth = dims[8];
  a.Q = dims[9];
  a.eps = eps;
  if (a.P <= 0 || a.N <= 0) return 0;
  const bool taints = a.tol_forbid != nullptr;
  if (a.F < 0 || a.F > MAX_F || a.quota_depth < 0 || a.quota_depth > a.D ||
      (a.quota_depth > 0 && a.Q <= 0) || a.L <= 0 ||
      (taints && (a.T <= 0 || a.G <= 0 || a.toleration_id == nullptr ||
                  a.taint_group == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.N + TILE - 1) / TILE, (a.P + PODS - 1) / PODS);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  stage1_mask_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
