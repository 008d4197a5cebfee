// K15 guard_pods: the pod half of the device health guard, in two
// launches.
//
// Replaces koordinator_tpu/scheduler/guards.py:149-211 _batch_defects
// (batch_health, :290) with :163 _bad_domain_groups, and the pod half of
// :255-271 _quarantine (apply_quarantine, :300; guarded_schedule_batch,
// :329). A domain group is bad when its domain row [N] holds an entry
// outside [-1, D) (D the width of its count table); a pod is bad when
// its requests, estimates or GPU ratio hold a non-finite (bit 8) or a
// negative entry (bit 9), when its gang, quota, selector or toleration
// id lies outside [-1, capacity) (bit 10; the capacities are the
// snapshot's gang and quota tables and the batch's own selector and
// toleration tables), or when it carries a bad group (bit 11 is set
// when any group is bad, as the reference sets it). A family whose
// switch is off (has_spread, has_anti, has_aff) is skipped, as the
// reference compiles it out. Every row is scanned, pads included.
//
// Launch one, a block a group row of every family present: the row's
// verdict by a block OR, then the row written anew, copied or all -1
// (the reference's scrub), and bit 11 ORed into health[0]. A carrier
// depends on all its groups, and a group on its whole row, hence two
// launches.
// Launch two, a block 32 pod rows: the rows' requests and estimates
// staged in shared memory (coalesced), a warp a pod scanning them, the
// ids and the carrier columns against the bad groups; warp 0 folds the
// block's classes into health[0] and its bad pods into health[2]. Then
// the rows are written anew: a row to scrub (the scanned mask, or the
// caller's where apply_quarantine gives one) gets max(nan_to_num(x), 0)
// on requests, estimates and GPU ratio and valid cleared; any other row
// is copied bit for bit.
//
// What bounds it on the H100: bytes. At a full-gate batch (P = 2000,
// R = 11, three families of 16, 16 and 8 groups over N = 10^4) the
// domain rows are 1.6 MB read and 1.6 MB written, the pod rows about
// 0.3 MB: 1 us at 3.35 TB/s; both launches are far shorter than their
// launch cost.

#include <cuda_runtime.h>
#include <stdint.h>

#include "guard.cuh"

namespace {

using namespace koord_guard;

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 32;  // pod rows a block: one a lane of warp 0
constexpr int FAMILIES = 3;
constexpr int IDS = 4;
constexpr int MAX_R = 16;
constexpr int MAX_GROUPS = 64;  // a family
constexpr int DOMAIN_MARK = 1;  // a row bit outside the word: a carrier

struct GroupArgs {
  const int32_t* dom[FAMILIES];  // [G, N] or null
  int32_t* dom_out[FAMILIES];
  int G[FAMILIES], D[FAMILIES];
  int N;
  uint8_t* bad_group;  // [G0 + G1 + G2]
  int* health;
};

__global__ void __launch_bounds__(THREADS) guard_groups_kernel(GroupArgs a) {
  int g = blockIdx.x, f = 0;
  while (f < FAMILIES - 1 && g >= a.G[f]) g -= a.G[f++];
  const int32_t* row = a.dom[f] + (size_t)g * a.N;
  const int d = a.D[f];
  int bad = 0;
  for (int n = threadIdx.x; n < a.N; n += THREADS) {
    const int32_t v = row[n];
    bad |= v < -1 || v >= d;
  }
  bad = __syncthreads_or(bad);
  int32_t* out = a.dom_out[f] + (size_t)g * a.N;
  for (int n = threadIdx.x; n < a.N; n += THREADS) out[n] = bad ? -1 : row[n];
  if (threadIdx.x == 0) {
    a.bad_group[blockIdx.x] = bad != 0;
    if (bad) atomicOr(&a.health[0], HEALTH_POD_DOMAIN_RANGE);
  }
}

struct PodArgs {
  const float* req;        // [P, R]
  const float* est;        // [P, R]
  const float* gpu_ratio;  // [P]
  const int32_t* ids[IDS]; // gang, quota, selector, toleration [P]
  int cap[IDS];
  const uint8_t* carrier[FAMILIES];  // [P, G] or null
  int G[FAMILIES];
  const uint8_t* bad_group;
  const uint8_t* valid;  // [P]
  const uint8_t* force;  // [P] rows to scrub, or null: the scan's
  float* req_out;
  float* est_out;
  float* ratio_out;
  uint8_t* valid_out;
  uint8_t* bad_out;  // [P] the scanned mask
  int* health;
  int P, R;
};

__global__ void __launch_bounds__(THREADS) guard_pod_rows_kernel(PodArgs a) {
  __shared__ float s_req[ROWS * MAX_R];
  __shared__ float s_est[ROWS * MAX_R];
  __shared__ int flags[ROWS];
  __shared__ uint8_t scrub_row[ROWS];
  __shared__ uint8_t s_bad[FAMILIES * MAX_GROUPS];
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, a.P - row0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = a.R;
  const int n_groups = a.G[0] + a.G[1] + a.G[2];

  load_tile(s_req, a.req + (size_t)row0 * R, rows * R);
  load_tile(s_est, a.est + (size_t)row0 * R, rows * R);
  for (int i = threadIdx.x; i < n_groups; i += THREADS)
    s_bad[i] = a.bad_group[i];
  __syncthreads();

  for (int r = warp; r < rows; r += WARPS) {
    const int pod = row0 + r;
    bool nonfinite = false, negative = false, id = false, domain = false;
    for (int j = lane; j < R; j += 32) {
      const float q = s_req[r * R + j], e = s_est[r * R + j];
      nonfinite = nonfinite || !finite(q) || !finite(e);
      negative = negative || q < 0.0f || e < 0.0f;
    }
    if (lane == 0) {
      const float gr = a.gpu_ratio[pod];
      nonfinite = nonfinite || !finite(gr);
      negative = negative || gr < 0.0f;
    }
    if (lane < IDS) {
      const int32_t v = a.ids[lane][pod];
      id = v < -1 || v >= a.cap[lane];
    }
    int off = 0;
#pragma unroll
    for (int f = 0; f < FAMILIES; ++f) {
      for (int g = lane; g < a.G[f]; g += 32)
        domain = domain ||
                 (a.carrier[f][(size_t)pod * a.G[f] + g] && s_bad[off + g]);
      off += a.G[f];
    }
    int bits = (nonfinite ? HEALTH_POD_NONFINITE : 0) |
               (negative ? HEALTH_POD_NEGATIVE : 0) |
               (id ? HEALTH_POD_ID_RANGE : 0) | (domain ? DOMAIN_MARK : 0);
    bits = __reduce_or_sync(FULL, bits);
    if (lane == 0) {
      flags[r] = bits;
      scrub_row[r] = a.force != nullptr ? (a.force[pod] != 0) : (bits != 0);
    }
  }
  __syncthreads();

  if (warp == 0) {
    const int f = lane < rows ? flags[lane] : 0;
    const int word = __reduce_or_sync(FULL, f) & ~DOMAIN_MARK;
    const int bad = __popc(__ballot_sync(FULL, f != 0));
    if (lane == 0) {
      if (word) atomicOr(&a.health[0], word);
      if (bad) atomicAdd(&a.health[2], bad);
    }
    if (lane < rows) {
      const int pod = row0 + lane;
      const bool s = scrub_row[lane];
      const float gr = a.gpu_ratio[pod];
      a.bad_out[pod] = f != 0;
      a.valid_out[pod] = a.valid[pod] != 0 && !s;
      a.ratio_out[pod] = s ? scrub(gr) : gr;
    }
  }
  for (int i = threadIdx.x; i < rows * R; i += THREADS) {
    const bool s = scrub_row[i / R];
    const float q = s_req[i], e = s_est[i];
    a.req_out[(size_t)row0 * R + i] = s ? scrub(q) : q;
    a.est_out[(size_t)row0 * R + i] = s ? scrub(e) : e;
  }
}

}  // namespace

// ptr: requests [P, R], estimated [P, R], gpu_ratio [P], gang_id,
// quota_id, selector_id, toleration_id [P], valid [P], force [P] (or
// null), the spread, anti and affinity domain maps [G, N] (null where
// the family is off), their carrier matrices [P, G] (likewise), then
// the outputs: requests, estimated, gpu_ratio, valid, the scanned mask
// [P], the three domain maps (null where off), a bad-group scratch
// [G0 + G1 + G2], health [3] (accumulated: the caller zeroes it).
// dims: P, R, N, gang capacity, quota capacity, selector table rows,
// toleration table rows, G0, G1, G2, D0, D1, D2 (the count tables'
// widths). Returns a CUDA error code; launches launch one only where a
// family is present.
extern "C" int koord_guard_pods(const void* const* ptr, const int* dims,
                                void* stream) {
  const int P = dims[0], R = dims[1], N = dims[2];
  GroupArgs g;
  PodArgs a;
  a.req = (const float*)ptr[0];
  a.est = (const float*)ptr[1];
  a.gpu_ratio = (const float*)ptr[2];
  for (int t = 0; t < IDS; ++t) {
    a.ids[t] = (const int32_t*)ptr[3 + t];
    a.cap[t] = dims[3 + t];
  }
  a.valid = (const uint8_t*)ptr[7];
  a.force = (const uint8_t*)ptr[8];
  int n_groups = 0;
  for (int f = 0; f < FAMILIES; ++f) {
    g.dom[f] = (const int32_t*)ptr[9 + f];
    a.carrier[f] = (const uint8_t*)ptr[12 + f];
    g.dom_out[f] = (int32_t*)ptr[20 + f];
    const bool on = g.dom[f] != nullptr;
    g.G[f] = a.G[f] = on ? dims[7 + f] : 0;
    g.D[f] = dims[10 + f];
    if (on && (a.carrier[f] == nullptr || g.dom_out[f] == nullptr ||
               g.G[f] < 0 || g.G[f] > MAX_GROUPS))
      return (int)cudaErrorInvalidValue;
    n_groups += g.G[f];
  }
  a.req_out = (float*)ptr[15];
  a.est_out = (float*)ptr[16];
  a.ratio_out = (float*)ptr[17];
  a.valid_out = (uint8_t*)ptr[18];
  a.bad_out = (uint8_t*)ptr[19];
  g.bad_group = (uint8_t*)ptr[23];
  a.bad_group = g.bad_group;
  g.health = a.health = (int*)ptr[24];
  g.N = N;
  a.P = P;
  a.R = R;
  if (P < 0 || N < 0 || R < 1 || R > MAX_R) return (int)cudaErrorInvalidValue;
  if (n_groups > 0) {
    guard_groups_kernel<<<n_groups, THREADS, 0, (cudaStream_t)stream>>>(g);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (P > 0) {
    guard_pod_rows_kernel<<<(P + ROWS - 1) / ROWS, THREADS, 0,
                            (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
