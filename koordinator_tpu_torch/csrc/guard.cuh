// Shared by K14 guard_nodes and K15 guard_pods: the reference's float
// rules for the health scan and the row scrub
// (koordinator_tpu/scheduler/guards.py).
//
// XLA:CPU's maximum and minimum are LLVM's x86 lowering of IEEE
// maximum / minimum, and differ from fmaxf/fminf (and torch's) where
// the scrubbed rows and forget's clamps can show it: the operands are
// ordered by the first one's sign (max takes (b, a) when a's sign bit is
// clear, min when it is set), then x > y ? x : y (x < y for min), then
// x itself if x is a NaN. So a NaN operand wins (which one, on two NaNs,
// follows the order), max(-0, +0) = +0 and min(+0, -0) = -0 in both
// orders.

#pragma once

#include <stdint.h>

namespace koord_guard {

constexpr int HEALTH_NODE_METRIC_NONFINITE = 1 << 0;
constexpr int HEALTH_NODE_BAD_ALLOCATABLE = 1 << 1;
constexpr int HEALTH_NODE_BAD_REQUESTED = 1 << 2;
constexpr int HEALTH_NODE_OVERCOMMIT = 1 << 3;
constexpr int HEALTH_NODE_NUMA_INVALID = 1 << 4;
constexpr int HEALTH_POD_NONFINITE = 1 << 8;
constexpr int HEALTH_POD_NEGATIVE = 1 << 9;
constexpr int HEALTH_POD_ID_RANGE = 1 << 10;
constexpr int HEALTH_POD_DOMAIN_RANGE = 1 << 11;
// guards.OVERCOMMIT_TOL
constexpr float OVERCOMMIT_TOL = 1.0f;

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

__device__ __forceinline__ bool finite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) != 0x7f800000u;
}

__device__ __forceinline__ float xla_max(float a, float b) {
  const bool swap = (__float_as_uint(a) >> 31) == 0u;
  const float x = swap ? b : a, y = swap ? a : b;
  return is_nan(x) ? x : (x > y ? x : y);
}

__device__ __forceinline__ float xla_min(float a, float b) {
  const bool swap = (__float_as_uint(a) >> 31) != 0u;
  const float x = swap ? b : a, y = swap ? a : b;
  return is_nan(x) ? x : (x < y ? x : y);
}

// guards._scrub_rows on one entry of a bad row: max(nan_to_num(x), 0),
// NaN and +-inf to 0 first; every zero comes out +0.
__device__ __forceinline__ float scrub(float x) {
  return xla_max(finite(x) ? x : 0.0f, 0.0f);
}

// guards._row_invalid on one entry: negative or not finite.
__device__ __forceinline__ bool invalid(float x) {
  return !finite(x) || x < 0.0f;
}

// Copy `count` floats from src to a shared tile, all threads of the
// block (the caller synchronises).
__device__ __forceinline__ void load_tile(float* tile, const float* src,
                                          int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) tile[i] = src[i];
}

}  // namespace koord_guard
