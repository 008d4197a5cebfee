// K16 delta_rows: the row replacement of a snapshot delta, every column
// it touches in two launches.
//
// Replaces koordinator_tpu/snapshot/delta.py:108 apply_metric_delta and
// :209 apply_topology_delta, each a `col.at[tgt].set(rows, mode="drop")`
// a column (about 20 node and device columns for a topology delta with
// its nested metric delta). The destination columns are fresh copies of
// the snapshot's (the wrapper clones them); this kernel writes delta row
// k into row idx[k] of each column of its index set, where 0 <= idx[k]
// < N (the reference maps -1 to N and drops it; it drops any index out
// of range). On a repeated index XLA:CPU keeps the last row, so a row is
// written only if no later row of its set has the same index: launch
// one takes atomicMax(k) into an [S, N] winner table (filled with -1 by
// the wrapper), launch two copies row k where winner[idx[k]] == k.
//
// What bounds it on the H100: bytes. A 1000-row metric delta moves
// 1000 rows of about 150 floats into the cloned columns: 0.6 MB read
// and written, 0.4 us at 3.35 TB/s; the clones (plain device copies,
// 5 MB at N = 10^4) cost more than the kernel.
//
// Design: launch one a thread an index; launch two a warp a (row,
// column), its lanes copying the row's 4-byte words (bytes where a row
// is not a whole number of words: the bool columns), the columns read
// from a table passed by value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_COLS = 32;
constexpr int MAX_SETS = 2;

struct Table {
  void* dst[MAX_COLS];
  const void* src[MAX_COLS];
  int row_bytes[MAX_COLS];
  int set[MAX_COLS];
  const int32_t* idx[MAX_SETS];  // [K] each
};

__global__ void delta_winner_kernel(Table t, int S, int K, int N,
                                    int32_t* winner) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= S * K) return;
  const int s = i / K, k = i % K;
  const int32_t v = t.idx[s][k];
  if (v >= 0 && v < N) atomicMax(&winner[(size_t)s * N + v], k);
}

__global__ void delta_copy_kernel(Table t, int K, int N,
                                  const int32_t* winner) {
  const int c = blockIdx.y;
  const int k = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (k >= K) return;
  const int s = t.set[c];
  const int32_t v = t.idx[s][k];
  if (v < 0 || v >= N || winner[(size_t)s * N + v] != k) return;
  const int rb = t.row_bytes[c];
  const char* src = (const char*)t.src[c] + (size_t)k * rb;
  char* dst = (char*)t.dst[c] + (size_t)v * rb;
  if ((rb & 3) == 0) {
    for (int w = lane; w < rb / 4; w += 32)
      ((int32_t*)dst)[w] = ((const int32_t*)src)[w];
  } else {
    for (int b = lane; b < rb; b += 32) dst[b] = src[b];
  }
}

}  // namespace

// dst, src: ncols column pointers (the cloned destination [N, ...] and
// the delta's rows [K, ...]); row_bytes and sets: ncols ints (a row's
// bytes, the column's index set); idx: S pointers to i32[K] index sets;
// winner: i32[S, N], filled with -1. Every row must be a whole number
// of 4-byte words or start on a 4-byte boundary (torch's allocations
// do).
extern "C" int koord_delta_rows(const void* const* dst,
                                const void* const* src, const int* row_bytes,
                                const int* sets, int ncols,
                                const void* const* idx, int S, int K, int N,
                                void* winner, void* stream) {
  if (ncols < 0 || ncols > MAX_COLS || S < 1 || S > MAX_SETS || K < 0 ||
      N < 0)
    return (int)cudaErrorInvalidValue;
  if (K == 0 || ncols == 0 || N == 0) return 0;
  Table t;
  for (int c = 0; c < ncols; ++c) {
    if (sets[c] < 0 || sets[c] >= S || row_bytes[c] < 0)
      return (int)cudaErrorInvalidValue;
    t.dst[c] = (void*)dst[c];
    t.src[c] = src[c];
    t.row_bytes[c] = row_bytes[c];
    t.set[c] = sets[c];
  }
  for (int s = 0; s < S; ++s) t.idx[s] = (const int32_t*)idx[s];
  const cudaStream_t st = (cudaStream_t)stream;
  delta_winner_kernel<<<(S * K + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      t, S, K, N, (int32_t*)winner);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((K + WARPS - 1) / WARPS, ncols);
  delta_copy_kernel<<<grid, THREADS, 0, st>>>(t, K, N,
                                              (const int32_t*)winner);
  return (int)cudaGetLastError();
}
