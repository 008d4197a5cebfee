// K14 guard_nodes: the node half of the device health guard, one pass
// over the node rows.
//
// Replaces koordinator_tpu/scheduler/guards.py:120-146 _node_defects
// (snapshot_health, :279) and the node half of :214-254 _quarantine
// (apply_quarantine, :300; guarded_schedule_batch, :329), which XLA runs
// as reductions over each node column and a `where` over each scrubbed
// one. For every row it finds the five defect classes: a non-finite
// entry in a metric column (usage, prod_usage, agg_usage and the four
// assigned columns), a negative or non-finite allocatable or requested,
// requested > fl(allocatable + 1) on a dim (NaN compares false), and on
// a valid NUMA zone a free entry that is non-finite, negative or above
// fl(cap + 1). It ORs the class bits into health[0] and adds the bad
// rows into health[1] (one atomic each a block: an OR and an integer
// sum, whose order does not show), writes the scanned mask, and writes
// every scrubbed column anew: a row to scrub (the scanned mask, or the
// caller's where apply_quarantine gives one) gets max(nan_to_num(x), 0)
// on each entry, requested = min(requested, allocatable) and numa_free
// = min(numa_free, numa_cap) after that, and schedulable cleared; any
// other row is copied bit for bit (NaN payloads included). max and min
// follow XLA's rules on NaN and signed zeros (guard.cuh).
//
// What bounds it on the H100: bytes. A row is about 160 floats over 11
// columns (R = 11, Z = 2), read once and written once: 12.9 MB at
// N = 10^4, 3.8 us at 3.35 TB/s; the checks are a few compares an entry.
//
// Design: a block owns 32 consecutive rows, so each column's tile is one
// contiguous span that the block copies into shared memory coalesced
// (each byte read from device memory once). A warp then scans a row at a
// time, its lanes striding over the row's entries, and ORs the classes
// with one warp reduction; warp 0 folds the block's 32 rows into one OR
// and one count. The block writes each column back from its tile,
// coalesced, scrubbing the entries of the rows to scrub.

#include <cuda_runtime.h>
#include <stdint.h>

#include "guard.cuh"

namespace {

using namespace koord_guard;

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 32;  // node rows a block: one a lane of warp 0
constexpr int NCOL = 10;  // scrubbed float columns
constexpr int ALLOC = 0, REQUESTED = 1, AGG = 4, NUMA_FREE = 9;
constexpr int METRIC_FIRST = 2, METRIC_LAST = 8;
constexpr int MAX_R = 16, MAX_AGG = 8, MAX_Z = 8;

struct Args {
  // allocatable, requested, usage, prod_usage, agg_usage,
  // assigned_estimated, assigned_correction, prod_assigned_estimated,
  // prod_assigned_correction, numa_free: [N, width]
  const float* in[NCOL];
  float* out[NCOL];
  const float* numa_cap;      // [N, Z, 2]
  const uint8_t* numa_valid;  // [N, Z]
  const uint8_t* schedulable; // [N]
  const uint8_t* force;       // [N] rows to scrub, or null: the scan's
  uint8_t* schedulable_out;   // [N]
  uint8_t* bad_out;           // [N] the scanned mask
  int* health;                // [3]: word, bad nodes, bad pods
  int N, R, Z, A;             // A = NUM_AGG
};

__device__ __forceinline__ int width(const Args& a, int c) {
  return c == AGG ? a.A * a.R : c == NUMA_FREE ? 2 * a.Z : a.R;
}

__global__ void __launch_bounds__(THREADS) guard_nodes_kernel(Args a) {
  extern __shared__ float smem[];
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, a.N - row0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = a.R, Z2 = 2 * a.Z;

  float* tile[NCOL];
  float* p = smem;
#pragma unroll
  for (int c = 0; c < NCOL; ++c) {
    tile[c] = p;
    p += ROWS * width(a, c);
  }
  float* cap = p;
  p += ROWS * Z2;
  int* flags = (int*)p;  // the row's class bits
  uint8_t* scrub_row = (uint8_t*)(flags + ROWS);
  uint8_t* valid = scrub_row + ROWS;  // [ROWS, Z]

#pragma unroll
  for (int c = 0; c < NCOL; ++c) {
    const int w = width(a, c);
    load_tile(tile[c], a.in[c] + (size_t)row0 * w, rows * w);
  }
  load_tile(cap, a.numa_cap + (size_t)row0 * Z2, rows * Z2);
  for (int i = threadIdx.x; i < rows * a.Z; i += THREADS)
    valid[i] = a.numa_valid[(size_t)row0 * a.Z + i];
  __syncthreads();

  for (int r = warp; r < rows; r += WARPS) {
    bool metric = false, bad_alloc = false, bad_req = false, over = false,
         numa = false;
#pragma unroll
    for (int c = METRIC_FIRST; c <= METRIC_LAST; ++c) {
      const int w = width(a, c);
      for (int j = lane; j < w; j += 32)
        metric = metric || !finite(tile[c][r * w + j]);
    }
    for (int j = lane; j < R; j += 32) {
      const float al = tile[ALLOC][r * R + j];
      const float rq = tile[REQUESTED][r * R + j];
      bad_alloc = bad_alloc || invalid(al);
      bad_req = bad_req || invalid(rq);
      over = over || rq > __fadd_rn(al, OVERCOMMIT_TOL);
    }
    for (int e = lane; e < Z2; e += 32) {
      const float f = tile[NUMA_FREE][r * Z2 + e];
      const float cp = cap[r * Z2 + e];
      if (valid[r * a.Z + (e >> 1)])
        numa = numa || !finite(f) || f < 0.0f ||
               f > __fadd_rn(cp, OVERCOMMIT_TOL);
    }
    int bits = (metric ? HEALTH_NODE_METRIC_NONFINITE : 0) |
               (bad_alloc ? HEALTH_NODE_BAD_ALLOCATABLE : 0) |
               (bad_req ? HEALTH_NODE_BAD_REQUESTED : 0) |
               (over ? HEALTH_NODE_OVERCOMMIT : 0) |
               (numa ? HEALTH_NODE_NUMA_INVALID : 0);
    bits = __reduce_or_sync(FULL, bits);
    if (lane == 0) {
      flags[r] = bits;
      scrub_row[r] = a.force != nullptr ? (a.force[row0 + r] != 0)
                                        : (bits != 0);
    }
  }
  __syncthreads();

  if (warp == 0) {
    const int f = lane < rows ? flags[lane] : 0;
    const int word = __reduce_or_sync(FULL, f);
    const int bad = __popc(__ballot_sync(FULL, f != 0));
    if (lane == 0) {
      if (word) atomicOr(&a.health[0], word);
      if (bad) atomicAdd(&a.health[1], bad);
    }
    if (lane < rows) {
      a.bad_out[row0 + lane] = f != 0;
      a.schedulable_out[row0 + lane] =
          a.schedulable[row0 + lane] != 0 && !scrub_row[lane];
    }
  }

#pragma unroll
  for (int c = 0; c < NCOL; ++c) {
    const int w = width(a, c);
    float* out = a.out[c] + (size_t)row0 * w;
    for (int i = threadIdx.x; i < rows * w; i += THREADS) {
      float x = tile[c][i];
      if (scrub_row[i / w]) {
        x = scrub(x);
        // requested and allocatable share the tile layout, as do
        // numa_free and numa_cap
        if (c == REQUESTED) x = xla_min(x, scrub(tile[ALLOC][i]));
        if (c == NUMA_FREE) x = xla_min(x, cap[i]);
      }
      out[i] = x;
    }
  }
}

}  // namespace

// ptr: the NCOL input columns (allocatable, requested, usage,
// prod_usage, agg_usage, assigned_estimated, assigned_correction,
// prod_assigned_estimated, prod_assigned_correction, numa_free),
// numa_cap, numa_valid, schedulable, force (or null), the NCOL output
// columns in the same order, schedulable_out, bad_out, health [3]
// (accumulated: the caller zeroes it). dims: N, R, Z, NUM_AGG.
extern "C" int koord_guard_nodes(const void* const* ptr, const int* dims,
                                 void* stream) {
  Args a;
  for (int c = 0; c < NCOL; ++c) {
    a.in[c] = (const float*)ptr[c];
    a.out[c] = (float*)ptr[NCOL + 4 + c];
  }
  a.numa_cap = (const float*)ptr[NCOL];
  a.numa_valid = (const uint8_t*)ptr[NCOL + 1];
  a.schedulable = (const uint8_t*)ptr[NCOL + 2];
  a.force = (const uint8_t*)ptr[NCOL + 3];
  a.schedulable_out = (uint8_t*)ptr[2 * NCOL + 4];
  a.bad_out = (uint8_t*)ptr[2 * NCOL + 5];
  a.health = (int*)ptr[2 * NCOL + 6];
  a.N = dims[0];
  a.R = dims[1];
  a.Z = dims[2];
  a.A = dims[3];
  if (a.N <= 0) return 0;
  if (a.R < 1 || a.R > MAX_R || a.Z < 0 || a.Z > MAX_Z || a.A < 1 ||
      a.A > MAX_AGG)
    return (int)cudaErrorInvalidValue;
  // 8 columns of R, agg of A x R, numa_free and numa_cap of 2Z, the
  // flags; then a byte a row and a byte a zone (at most 37 KB, under
  // the 48 KB a launch takes without an opt-in)
  const size_t smem = sizeof(float) * ROWS * (8 * a.R + a.A * a.R + 4 * a.Z + 1)
                      + ROWS + ROWS * a.Z;
  const int grid = (a.N + ROWS - 1) / ROWS;
  guard_nodes_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
