// K2 segment_prefix_ok: does each pod fit its segment's limit when charged
// after every earlier-ranked pod of the same segment?
//
// Replaces koordinator_tpu/scheduler/batching.py segment_prefix_ok, called
// once for node capacity (core.py:768) and once per quota level
// (core.py:891) in every inner commit step. On the TPU it is a masked
// [P, P] x [P, R] matmul, because sorts are slow there; XLA runs it on
// the matrix unit.
//
//   ok[p] = all_r( base[seg[p], r] + sum_{q: seg[q] == seg[p],
//                                         rank[q] < rank[p]} req[q, r]
//                  + req[p, r] <= limit[seg[p], r] + eps )
//           or seg[p] >= S            (out of range = no candidate)
//
// What bounds it on the H100: O(P^2) pair tests on 8 bytes each (the seg
// and rank of both pods) that sit in L2 (16 KB at P=2000); the bytes from
// device memory are a few tens of KB. At flagship sizes a launch does a
// few microseconds of work, so the kernel is launch-bound: 3 launches per
// inner step, 2400 per sweep.
//
// Design: one warp per pod; pods whose segment is out of range (not
// trying this step: most of them late in a round) leave at once. The
// lanes stride over the other pods and sum the matching rows, the warp
// reduces the sums by shuffles, and lane 0 compares. A (segment, rank)
// sort followed by a segmented scan would be O(P log P); that is a later
// change.
//
// Exactness: the summation order is not the reference's. The sums are
// still exact on the scheduler's inputs: requests are multiples of
// 500 mC and 512 MiB (utils/synthetic.py) and node/quota usage is a sum
// of such requests, so every partial sum is an integer far below 2^24
// and representable in f32, in any order. The quota root (depth 0 holds
// every quota pod) puts up to a whole chunk in one segment, so this
// reasoning, not a small segment size, is what keeps the result exact.
// The comparison itself keeps the reference's order of additions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_R = 8;
constexpr unsigned FULL = 0xffffffffu;

__global__ void segment_prefix_ok_kernel(
    const int32_t* __restrict__ seg, const int32_t* __restrict__ rank,
    const float* __restrict__ req, const float* __restrict__ base,
    const float* __restrict__ limit, int P, int R, int S, float eps,
    uint8_t* __restrict__ out) {
  const int p = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= P) return;
  const int s = seg[p];
  if (s >= S) {
    if (lane == 0) out[p] = 1;
    return;
  }
  const int rp = rank[p];
  float acc[MAX_R];
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) acc[r] = 0.0f;
  for (int q = lane; q < P; q += 32) {
    if (seg[q] == s && rank[q] < rp) {
#pragma unroll
      for (int r = 0; r < MAX_R; ++r)
        if (r < R) acc[r] = __fadd_rn(acc[r], req[(size_t)q * R + r]);
    }
  }
#pragma unroll
  for (int r = 0; r < MAX_R; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[r] = __fadd_rn(acc[r], __shfl_xor_sync(FULL, acc[r], off));
  }
  if (lane == 0) {
    const int sc = s < 0 ? 0 : s;
    bool ok = true;
#pragma unroll
    for (int r = 0; r < MAX_R; ++r) {
      if (r < R) {
        const size_t o = (size_t)sc * R + r;
        const float lhs = __fadd_rn(__fadd_rn(base[o], acc[r]),
                                    req[(size_t)p * R + r]);
        ok = ok && (lhs <= __fadd_rn(limit[o], eps));
      }
    }
    out[p] = ok ? 1 : 0;
  }
}

}  // namespace

extern "C" int koord_segment_prefix_ok(const void* seg, const void* rank,
                                       const void* req, const void* base,
                                       const void* limit, int P, int R, int S,
                                       float eps, void* out, void* stream) {
  if (P <= 0) return 0;
  if (R > MAX_R || S <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (int)(((size_t)P * 32 + threads - 1) / threads);
  segment_prefix_ok_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)seg, (const int32_t*)rank, (const float*)req,
      (const float*)base, (const float*)limit, P, R, S, eps, (uint8_t*)out);
  return (int)cudaGetLastError();
}
