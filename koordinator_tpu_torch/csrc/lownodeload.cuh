// Shared helpers of the LowNodeLoad plan kernels K10-K13
// (lownodeload_fit.cu, _order.cu, _prefix.cu, _capped.cu): XLA:CPU's
// orders of f32 additions, which the plan must keep to equal the
// reference bit for bit, as block-wide device functions, and the sort
// key of a float.
//
// - xla_cumsum: `jnp.cumsum` compiles on XLA:CPU to a blocked scan: a
//   sequential prefix within blocks of 16 (zero-padded at the end), the
//   blocks' totals scanned by the same rule, recursively, and each
//   block's exclusive carry (the previous block's inclusive total)
//   added to its prefix. A plain sequential or a warp-shuffle scan
//   rounds differently and can flip a take at a threshold.
// - tree_sum: a column sum over the nodes compiles to XLA:CPU's tree
//   reduction: windows of 32 rows (the padding to a multiple of 32
//   split evenly, the odd one after) summed in order from 0, repeated
//   while more than 32 partials remain, then the rest summed in order.
// - sort_bits: the reference's stable argsort compares -0.0 equal to
//   +0.0 and every NaN equal and above +inf; the key maps a float to
//   an unsigned int of the same order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lnl {

constexpr int MAX_RD = 11;  // threshold dims (NUM_RESOURCES)
constexpr int SCAN_BASE = 16;
constexpr int TREE_BASE = 32;

__device__ __forceinline__ uint32_t sort_bits(float x) {
  if (x == 0.0f) x = 0.0f;                     // -0.0 as +0.0
  uint32_t u = isnan(x) ? 0x7fc00000u : __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The inclusive prefix of buf[0, n) in place (shared memory), in
// XLA:CPU's blocked order. `scratch` (shared) holds the levels' totals:
// at least n / 15 + 16 floats. Every thread of the block calls it; it
// ends with a barrier.
__device__ void xla_cumsum(float* buf, int n, float* scratch) {
  const int T = blockDim.x, tid = threadIdx.x;
  // level k: base pointer and length; level 0 is buf
  float* lvl[8];
  int len[8];
  lvl[0] = buf;
  len[0] = n;
  int k = 0;
  float* next = scratch;
  while (len[k] > SCAN_BASE) {
    const int nb = (len[k] + SCAN_BASE - 1) / SCAN_BASE;
    float* L = lvl[k];
    for (int b = tid; b < nb; b += T) {
      float acc = 0.0f;
      for (int j = 0; j < SCAN_BASE; ++j) {
        const int i = b * SCAN_BASE + j;
        acc = __fadd_rn(acc, i < len[k] ? L[i] : 0.0f);
        if (i < len[k]) L[i] = acc;
      }
      next[b] = acc;
    }
    __syncthreads();
    lvl[k + 1] = next;
    len[k + 1] = nb;
    next += nb;
    ++k;
  }
  if (tid == 0) {
    float acc = 0.0f;
    for (int i = 0; i < len[k]; ++i) {
      acc = __fadd_rn(acc, lvl[k][i]);
      lvl[k][i] = acc;
    }
  }
  __syncthreads();
  for (; k > 0; --k) {
    float* L = lvl[k - 1];
    const float* C = lvl[k];
    for (int i = tid; i < len[k - 1]; i += T) {
      const int b = i / SCAN_BASE;
      L[i] = __fadd_rn(b == 0 ? 0.0f : C[b - 1], L[i]);
    }
    __syncthreads();
  }
}

// The sum over i in [0, n) of v(i), in XLA:CPU's tree order; every
// thread of the block calls it and gets the sum. `ping`, `pong`
// (shared): at least ceil(n / 32) floats each; `out` one shared float.
template <class V>
__device__ float tree_sum(int n, V v, float* ping, float* pong,
                          float* out) {
  const int T = blockDim.x, tid = threadIdx.x;
  if (n <= TREE_BASE) {
    if (tid == 0) {
      float acc = 0.0f;
      for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, v(i));
      *out = acc;
    }
    __syncthreads();
    const float r = *out;
    __syncthreads();
    return r;
  }
  int m = (n + TREE_BASE - 1) / TREE_BASE;
  {
    const int lo = (m * TREE_BASE - n) / 2;
    for (int b = tid; b < m; b += T) {
      float acc = 0.0f;
      for (int j = 0; j < TREE_BASE; ++j) {
        const int i = b * TREE_BASE + j - lo;
        acc = __fadd_rn(acc, (i >= 0 && i < n) ? v(i) : 0.0f);
      }
      ping[b] = acc;
    }
  }
  __syncthreads();
  while (m > TREE_BASE) {
    const int m2 = (m + TREE_BASE - 1) / TREE_BASE;
    const int lo = (m2 * TREE_BASE - m) / 2;
    for (int b = tid; b < m2; b += T) {
      float acc = 0.0f;
      for (int j = 0; j < TREE_BASE; ++j) {
        const int i = b * TREE_BASE + j - lo;
        acc = __fadd_rn(acc, (i >= 0 && i < m) ? ping[i] : 0.0f);
      }
      pong[b] = acc;
    }
    __syncthreads();
    float* t = ping;
    ping = pong;
    pong = t;
    m = m2;
  }
  if (tid == 0) {
    float acc = 0.0f;
    for (int i = 0; i < m; ++i) acc = __fadd_rn(acc, ping[i]);
    *out = acc;
  }
  __syncthreads();
  const float r = *out;
  __syncthreads();
  return r;
}

// Inclusive scan of a[0, n) (shared ints) under an associative op with
// its identity; every thread of the block calls it. `warp_tot`: 32
// shared ints.
template <class Op>
__device__ void block_scan(int* a, int n, Op op, int identity,
                           int* warp_tot) {
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, warps = (T + 31) / 32;
  const int chunk = (n + T - 1) / T;
  const int lo = min(tid * chunk, n), hi = min(lo + chunk, n);
  int acc = identity;
  for (int i = lo; i < hi; ++i) {
    acc = op(acc, a[i]);
    a[i] = acc;
  }
  int incl = acc;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, s);
    if (lane >= s) incl = op(y, incl);
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < warps ? warp_tot[lane] : identity;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, s);
      if (lane >= s) w = op(y, w);
    }
    if (lane < warps) warp_tot[lane] = w;
  }
  __syncthreads();
  int excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = identity;
  if (warp > 0) excl = op(warp_tot[warp - 1], excl);
  for (int i = lo; i < hi; ++i) a[i] = op(excl, a[i]);
  __syncthreads();
}

}  // namespace lnl
