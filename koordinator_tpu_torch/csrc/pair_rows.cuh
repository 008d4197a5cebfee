// Row spans shared by kernels K4 (numa_pair_terms) and K6
// (device_pair_terms). Both write bool pair_ok[P, N], ANDed in place into
// the mask the caller passes (or written whole without one), and f32
// pair_score[P, N], a block of 128 threads taking a tile of nodes and up
// to 64 rows (pods), every G-th row of the batch.
//
// A thread takes SPAN = 4 consecutive nodes of a row. It loads their
// mask bytes as one 32-bit word before it computes, then stores its
// verdicts as one word and its scores as one float4. A thread reads and
// writes only its own bytes, so loading first is safe where the mask is
// the output. A span whose flat start (row * N + node) is not aligned in
// both outputs (N = 1001: the row starts mid-word), or that holds fewer
// than 4 nodes (the row's end), goes byte by byte and float by float:
// that handles a row's unaligned head and tail.
//
// A row whose verdict is "pass" on every node of the tile leaves a given
// mask as it is: the kernel neither loads nor stores its bytes, and only
// stores its zero scores (and, without a mask, the trues).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace koord_rows {

constexpr int SPAN = 4;        // consecutive nodes a thread takes in a row
constexpr int THREADS = 128;   // threads a block
constexpr int MAX_ROWS = 64;   // rows a block
constexpr unsigned ONES = 0x01010101u;  // four trues

// a quiet NaN: the fit threshold of an invalid zone or instance, which
// fails every >= compare
__device__ __forceinline__ float kNaN() { return __int_as_float(0x7fc00000); }

// four consecutive floats of a shared-memory plane (16-byte aligned)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

struct Span {
  size_t e;   // flat index of the span's first pair, row * N + node
  int cnt;    // the span's pairs inside the row (1..4)
  bool vec;   // a whole span, its word and float4 aligned
};

__device__ __forceinline__ Span span_of(size_t e, int cnt,
                                        const uint8_t* ok,
                                        const float* score) {
  const bool vec = cnt == SPAN && ((uintptr_t)(ok + e) & 3) == 0 &&
                   (score == nullptr || ((uintptr_t)(score + e) & 15) == 0);
  return Span{e, cnt, vec};
}

// the span's mask bytes, byte j in bits 8j..8j+7 (0 past the row)
__device__ __forceinline__ unsigned load_mask(const uint8_t* m,
                                              const Span& s) {
  if (s.vec) return *reinterpret_cast<const unsigned*>(m + s.e);
  unsigned w = 0;
  for (int j = 0; j < s.cnt; ++j) w |= (unsigned)m[s.e + j] << (8 * j);
  return w;
}

// the verdict bytes: 1 where the mask byte is nonzero and bit j of ok
// is set, else 0
__device__ __forceinline__ unsigned and_word(unsigned mask, unsigned ok) {
  const unsigned bytes = (ok & 1u) | (ok & 2u) << 7 | (ok & 4u) << 14 |
                         (ok & 8u) << 21;
  return __vcmpne4(mask, 0u) & bytes;
}

__device__ __forceinline__ void store_mask(uint8_t* m, const Span& s,
                                           unsigned w) {
  if (s.vec) {
    *reinterpret_cast<unsigned*>(m + s.e) = w;
    return;
  }
  for (int j = 0; j < s.cnt; ++j) m[s.e + j] = (uint8_t)(w >> (8 * j));
}

__device__ __forceinline__ void store_score(float* out, const Span& s,
                                            const float (&v)[SPAN]) {
  if (s.vec) {
    *reinterpret_cast<float4*>(out + s.e) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
    return;
  }
  for (int j = 0; j < s.cnt; ++j) out[s.e + j] = v[j];
}

// Block x of the G = gridDim.x row blocks takes rows x, x + G, x + 2G,
// ...: every block then holds a like share of each row class, wherever
// the batch's packing put them.
__device__ __forceinline__ int block_rows(int P) {
  return (P - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
}

__device__ __forceinline__ int row_of(int r) {
  return (int)blockIdx.x + r * (int)gridDim.x;
}

// Rows a block: 64, halved down to 8 while the grid would have fewer
// than four blocks for each of the H100's 132 SMs (config 2's 1000
// nodes are two tiles).
inline int rows_per_block(int rows, long long tiles) {
  constexpr long long SMS = 132;
  int r = MAX_ROWS;
  while (r > 8 && tiles * ((rows + r - 1) / r) < 4 * SMS) r /= 2;
  return r;
}

// Nodes a tile: the most of 512, 256, ..., 32 whose per-node shared
// bytes fit `budget`.
inline int tile_nodes(int bytes_per_node, int budget) {
  int tile = 512;
  while (tile > 32 && tile * bytes_per_node > budget) tile /= 2;
  return tile;
}

}  // namespace koord_rows
