// K3 ordered_scatter_add: out = target with rows[j] added into row idx[j],
// each target row's updates applied in ascending j, indices outside
// [0, S) dropped.
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
// What bounds it on the H100: bytes. It reads and writes the [S, C]
// target once (0.9 MB at S=10^4, C=11) and reads the [P, C] rows once;
// the adds are few. A launch is a few microseconds.
//
// Design: the wrapper sorts the indices stably (so each target row's
// updates form one run, in ascending j) and passes the sorted indices
// with their original positions. One thread per (target row, column)
// finds its run by binary search and walks it in order from the target's
// value. Rows that receive nothing copy the target.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void ordered_scatter_add_kernel(
    const float* __restrict__ target, const int32_t* __restrict__ sorted_idx,
    const int64_t* __restrict__ order, const float* __restrict__ rows, int S,
    int C, int P, float* __restrict__ out) {
  const size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (t >= (size_t)S * C) return;
  const int s = (int)(t / C);
  const int c = (int)(t % C);
  int lo = 0, hi = P;  // first j with sorted_idx[j] >= s
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sorted_idx[mid] < s)
      lo = mid + 1;
    else
      hi = mid;
  }
  float acc = target[t];
  for (int j = lo; j < P && sorted_idx[j] == s; ++j)
    acc = __fadd_rn(acc, rows[(size_t)order[j] * C + c]);
  out[t] = acc;
}

}  // namespace

extern "C" int koord_ordered_scatter_add(const void* target,
                                         const void* sorted_idx,
                                         const void* order, const void* rows,
                                         int S, int C, int P, void* out,
                                         void* stream) {
  const size_t total = (size_t)S * C;
  if (total == 0) return 0;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  ordered_scatter_add_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)target, (const int32_t*)sorted_idx, (const int64_t*)order,
      (const float*)rows, S, C, P, (float*)out);
  return (int)cudaGetLastError();
}
