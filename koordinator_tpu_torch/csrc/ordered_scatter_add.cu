// K3 ordered_scatter_add: for each group of a launch, out = target with
// rows[j] added into row idx[l, j] for every level l, each target row's
// updates applied in ascending (l, j); an index in [-S, 0) names row
// S + idx (numpy's rule, as the reference's `.at[]`), other indices
// outside [0, S) are dropped. L levels are L scatters in a row into the
// same target. A launch takes up to MAX_GROUPS independent groups
// (distinct targets, each with its own S, C, L and P): every commit of
// an inner step, of a round or of a batch's rebuild in one launch.
//
// Replaces the `.at[idx].add(rows, mode="drop")` commits of
// koordinator_tpu/scheduler/core.py schedule_batch: node requested and
// quota used per level in each inner step (core.py:1109, :1113-1116), the
// estimate and gang charges per round (core.py:1139-1142), and the
// rebuild from the final assignment (core.py:1212-1225). XLA's CPU
// scatter applies the updates one by one in index order; this kernel
// keeps that order so the sums are bit-equal. It matters for the
// estimates: they need not be integers, and on the card an atomic
// scatter-add (index_add_) adds in an order that changes from run to run.
// One ulp there flips a later round's floored score and moves a pod.
//
// What bounds it on the H100: bytes. It reads and writes each [S, C]
// target once and reads the [L, P] indices and the matched rows; the
// adds are few. Its floor in time is the chain of dependent adds of the
// row that takes the most updates (the quota root takes every quota pod
// of a chunk), which the bit-exact order forbids splitting.
//
// Design: a block owns a contiguous range of one group's target rows
// (the wrapper sizes the ranges from the shapes alone, so that a group's
// blocks scan its indices a few times, not thousands) and first copies
// its range of the target to the output, eight loads in flight a
// thread. It then reads the group's L * P indices once, in tiles of
// 2048 (a warp's 256 as eight coalesced rows of 32; the two tiles after
// it read while this one is placed), ballots the entries that fall in
// its range and appends them to a list in shared memory in (l, j) order
// (the warps' counts, one barrier a tile). When the list would overflow, and
// at the end, the block flushes it: a stable radix sort by row keeps
// each row's entries in (l, j) order, a scan marks the runs of one row,
// the matched rows are gathered into shared memory in that order (in
// segments of STAGE floats; cp.async, every copy of a thread in
// flight), and one thread for each (run, column) adds its run in order
// into the output row, 32 reads in flight. The output is the
// accumulator, so a row continues across flushes and segments. Nothing
// is staged whole: any P, L and S go in one launch.

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SCAN_ITEMS = 8;                 // indices a thread a tile
constexpr int TILE = THREADS * SCAN_ITEMS;    // indices a tile
constexpr int SORT_ITEMS = 8;
constexpr int CAP = THREADS * SORT_ITEMS;     // entries the list holds
constexpr int STAGE = 16384;                  // staged row floats (64 KB)
constexpr int WARPS = THREADS / 32;
constexpr int FLIGHT = 8;  // loads a thread keeps in flight in a copy
constexpr int MAX_GROUPS = 32;
constexpr int MAX_C = 192;  // the instance commit at I = 64: 64 x 3

// One group (kernels/scatter.py _Group mirrors it): its blocks are
// block0 .. block0 + ceil(S / rb) - 1, block b owning rows
// [b * rb, b * rb + rb).
struct Group {
  const float* target;
  const int32_t* idx;
  const float* rows;
  float* out;
  int S, C, P, L, rb, block0;
};

struct Groups {
  int n, blocks;
  Group g[MAX_GROUPS];
};

using Sort = cub::BlockRadixSort<unsigned, THREADS, SORT_ITEMS, int>;
using Scan = cub::BlockScan<int, THREADS>;

struct Shared {
  unsigned row[CAP];  // the list: local row, then sorted
  int j[CAP];         // its row of `rows`
  int runs[CAP + 1];  // start of each run of one row in the sorted list
  union {
    Sort::TempStorage sort;
    Scan::TempStorage scan;
  } tmp;
};

// An asynchronous 4-byte copy from device to shared memory (cp.async:
// no register holds it, so a thread can have all of its copies in
// flight at once); cp_async_wait waits for this thread's.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// The first u in [0, n) with a[u] >= x (n where none).
__device__ __forceinline__ int first_at_least(const int* a, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Sort the list's first `count` entries by row (stable), find the runs
// of one row, and add each run in order into the output rows; every
// thread of the block calls it.
__device__ void flush(Shared& sh, float* stage, const Group& g, int lo,
                      int span, int count) {
  const int t = threadIdx.x;
  const int C = g.C;
  __syncthreads();  // the list is written
  unsigned key[SORT_ITEMS];
  int val[SORT_ITEMS];
#pragma unroll
  for (int i = 0; i < SORT_ITEMS; ++i) {
    const int p = t * SORT_ITEMS + i;
    key[i] = p < count ? sh.row[p] : (unsigned)span;  // empties sort last
    val[i] = p < count ? sh.j[p] : 0;
  }
  const int bits = 32 - __clz(span);
  Sort(sh.tmp.sort).Sort(key, val, 0, bits);
  __syncthreads();  // every thread holds its sorted items
  int flag[SORT_ITEMS], run[SORT_ITEMS];
#pragma unroll
  for (int i = 0; i < SORT_ITEMS; ++i) {
    const int p = t * SORT_ITEMS + i;
    sh.row[p] = key[i];
    sh.j[p] = val[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < SORT_ITEMS; ++i) {
    const int p = t * SORT_ITEMS + i;
    flag[i] = p < count && (p == 0 || sh.row[p - 1] != sh.row[p]);
  }
  int nruns;
  Scan(sh.tmp.scan).ExclusiveSum(flag, run, nruns);
#pragma unroll
  for (int i = 0; i < SORT_ITEMS; ++i)
    if (flag[i]) sh.runs[run[i]] = t * SORT_ITEMS + i;
  if (t == 0) sh.runs[nruns] = count;
  __syncthreads();
  const int seg = STAGE / C;  // entries a staged segment
  for (int s0 = 0; s0 < count; s0 += seg) {
    const int s1 = min(count, s0 + seg);
    // the segment's rows, every copy of a thread in flight at once:
    // element i of the segment is column c of its k-th entry
    const int nv = (s1 - s0) * C;
    for (int i = t, k = t / C, c = t % C; i < nv; i += THREADS) {
      cp_async4(stage + i, g.rows + (size_t)sh.j[s0 + k] * C + c);
      k += THREADS / C;
      c += THREADS % C;
      if (c >= C) {
        c -= C;
        ++k;
      }
    }
    cp_async_wait();
    __syncthreads();
    // the runs that meet [s0, s1): from the one holding s0
    const int u0 = first_at_least(sh.runs, nruns + 1, s0 + 1) - 1;
    const int u1 = first_at_least(sh.runs, nruns + 1, s1);
    for (int q = t; q < (u1 - u0) * C; q += THREADS) {
      const int u = u0 + q / C, c = q - (q / C) * C;
      const int a = max(sh.runs[u], s0), z = min(sh.runs[u + 1], s1);
      float* o = g.out + (size_t)(lo + sh.row[a]) * C + c;
      float acc = *o;
      const float* x = stage + (a - s0) * C + c;
      int k = 0, n = z - a;
      for (; k + 32 <= n; k += 32) {  // the hot rows' chains
        float v[32];
#pragma unroll
        for (int w = 0; w < 32; ++w) v[w] = x[(k + w) * C];
#pragma unroll
        for (int w = 0; w < 32; ++w) acc = __fadd_rn(acc, v[w]);
      }
      for (; k < n; ++k) acc = __fadd_rn(acc, x[k * C]);
      *o = acc;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS) ordered_scatter_add_kernel(
    const Groups gs) {
  extern __shared__ float stage[];  // STAGE floats
  __shared__ Shared sh;
  // this block's group: the last whose first block is not above it
  // (constant indices only, so that the descriptors stay parameters)
  Group g = gs.g[0];
#pragma unroll
  for (int k = 1; k < MAX_GROUPS; ++k)
    if (k < gs.n && (int)blockIdx.x >= gs.g[k].block0) g = gs.g[k];
  const int t = threadIdx.x;
  const int S = g.S, C = g.C;
  const int lo = ((int)blockIdx.x - g.block0) * g.rb;
  const int span = min(g.rb, S - lo);
  {
    const size_t base = (size_t)lo * C, nv = (size_t)span * C;
    for (size_t i0 = t; i0 < nv; i0 += THREADS * FLIGHT) {
      float v[FLIGHT];
#pragma unroll
      for (int f = 0; f < FLIGHT; ++f) {
        const size_t i = i0 + f * THREADS;
        v[f] = i < nv ? __ldg(g.target + base + i) : 0.0f;
      }
#pragma unroll
      for (int f = 0; f < FLIGHT; ++f)
        if (i0 + f * THREADS < nv) g.out[base + i0 + f * THREADS] = v[f];
    }
  }
  // the scan: warp w of a tile reads its 32 * SCAN_ITEMS indices as
  // SCAN_ITEMS coalesced rows of 32, in index order, and ballots each;
  // the warps' match counts (double-buffered by tile) place each warp's
  // matches after the earlier warps'. The two next tiles' indices are
  // read while this one is placed.
  __shared__ int wcount[2][WARPS];
  const int warp = t >> 5, lane = t & 31;
  const int n = g.L * g.P;
  auto load = [&](int e0, int (&x)[SCAN_ITEMS]) {
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      const int e = e0 + warp * 32 * SCAN_ITEMS + k * 32 + lane;
      x[k] = e < n ? __ldg(g.idx + e) : S;
    }
  };
  int cur[SCAN_ITEMS], nxt[SCAN_ITEMS], far[SCAN_ITEMS];
  if (n) load(0, cur);
  if (TILE < n) load(TILE, nxt);
  int count = 0;
  for (int e0 = 0, tile = 0; e0 < n; e0 += TILE, ++tile) {
    if (e0 + 2 * TILE < n) load(e0 + 2 * TILE, far);
    unsigned ball[SCAN_ITEMS];
    int mine = 0;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      int x = cur[k];
      x = x < 0 ? x + S : x;  // [-S, 0) wraps; the rest stays out
      cur[k] = x - lo;
      ball[k] = __ballot_sync(0xffffffffu, x >= lo && x - lo < span);
      mine += __popc(ball[k]);
    }
    if (lane == 0) wcount[tile & 1][warp] = mine;
    __syncthreads();
    int off = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = wcount[tile & 1][w];
      off += w < warp ? c : 0;
      total += c;
    }
    if (total) {  // block-uniform
      if (count + total > CAP) {
        flush(sh, stage, g, lo, span, count);
        count = 0;
      }
      int w = count + off;
      const unsigned below = (1u << lane) - 1u;
#pragma unroll
      for (int k = 0; k < SCAN_ITEMS; ++k) {
        if (ball[k] >> lane & 1u) {
          const int at = w + __popc(ball[k] & below);
          sh.row[at] = (unsigned)cur[k];
          sh.j[at] = (e0 + warp * 32 * SCAN_ITEMS + k * 32 + lane) % g.P;
        }
        w += __popc(ball[k]);
      }
      count += total;
    }
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      cur[k] = nxt[k];
      nxt[k] = far[k];
    }
  }
  if (count) flush(sh, stage, g, lo, span, count);
}

}  // namespace

// desc: a Groups (kernels/scatter.py _Groups), copied into the launch's
// parameter
extern "C" int koord_ordered_scatter_add_many(const void* desc,
                                              void* stream) {
  const Groups* gs = (const Groups*)desc;
  if (gs->n < 1 || gs->n > MAX_GROUPS) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < gs->n; ++k) {
    const Group& g = gs->g[k];
    if (g.S > 0 && (g.C < 1 || g.C > MAX_C || g.rb < 1 || g.P < 0 ||
                    g.L < 0 || (long long)g.L * g.P >= (1ll << 31)))
      return (int)cudaErrorInvalidValue;
  }
  if (gs->blocks <= 0) return 0;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        ordered_scatter_add_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, STAGE * 4);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  ordered_scatter_add_kernel<<<gs->blocks, THREADS, STAGE * 4,
                               (cudaStream_t)stream>>>(*gs);
  return (int)cudaGetLastError();
}
