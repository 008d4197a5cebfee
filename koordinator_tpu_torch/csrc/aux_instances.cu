// K17 aux_instance_pick: each pod's aux (RDMA/FPGA) instance on its
// chosen node, for both aux pools, in one launch.
//
// Replaces koordinator_tpu/scheduler/plugins/deviceshare.py:274
// choose_aux_instance as schedule_batch calls it in every inner commit
// step (core.py:1020-1039), once a pool: on the pod's chosen node
// (clamped into [0, N)), the valid instances (batch-start aux_valid)
// whose live free covers the request, free + eps >= req, are the
// candidates; "least" takes the one with the most free (argmax of the
// free, -inf where it does not fit), "most" the one with the least
// (argmin, +inf where it does not fit), the first index among ties, as
// jnp's argmax and argmin do (instance 0 where none fits). ok: some
// instance fits, or the pod asks for nothing of the pool (req <= 0).
// One instance serves a whole request (devicehandler_default.go). The
// step's K2 launch then gates the chosen (node, pool, instance)
// segments in priority order, and K3 commits them.
//
// What bounds it on the H100: bytes, and not many of them. A (pod,
// pool) reads its request and its node's J instance free and valid
// bytes (J <= 64: 320 bytes; the aux full gate's J = 8, 40 bytes) and
// writes 5 bytes; 2000 pods read about 330 KB at J = 8, most of it from
// L2 (the pods of a step share nodes). The launch itself costs more
// than the work.
//
// Design: one thread a (pod, pool), 256 threads a block; the thread
// walks its node's J instances in index order with one comparison each.
// Exactness: the fit test adds eps to the free in f32 as the reference
// does (__fadd_rn), and the choice compares values, so it is exact.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_J = 64;

__global__ void __launch_bounds__(THREADS) aux_instance_pick_kernel(
    const int32_t* __restrict__ choice, const float* __restrict__ req,
    const float* __restrict__ free_, const uint8_t* __restrict__ valid,
    int P, int N, int J, int least, float eps, int32_t* __restrict__ inst,
    uint8_t* __restrict__ ok) {
  const int k = blockIdx.x * THREADS + threadIdx.x;  // pod k / 2, pool k % 2
  if (k >= 2 * P) return;
  const int p = k >> 1, a = k & 1;
  const int n = min(max(choice[p], 0), N - 1);
  const float r = req[k];
  const size_t o = ((size_t)n * 2 + a) * J;
  const float none = least ? -INFINITY : INFINITY;
  int best = 0;
  float key = none;
  bool any = false;
  for (int j = 0; j < J; ++j) {
    const float f = free_[o + j];
    const bool fits = __fadd_rn(f, eps) >= r && valid[o + j] != 0;
    any |= fits;
    const float kj = fits ? f : none;
    if (j == 0 || (least ? kj > key : kj < key)) {
      key = kj;
      best = j;
    }
  }
  inst[k] = best;
  ok[k] = any || r <= 0.0f;
}

}  // namespace

// choice i32[P] (any value: clamped into [0, N)), req f32[P, 2],
// aux_free f32[N, 2, J], aux_valid bool[N, 2, J]; writes inst i32[P, 2]
// and ok bool[P, 2]. least: 1 for "least", 0 for "most".
extern "C" int koord_aux_instance_pick(const void* choice, const void* req,
                                       const void* aux_free,
                                       const void* aux_valid, int P, int N,
                                       int J, int least, float eps,
                                       void* inst, void* ok, void* stream) {
  if (P <= 0) return 0;
  if (N <= 0 || J <= 0 || J > MAX_J) return (int)cudaErrorInvalidValue;
  const int blocks = (2 * P + THREADS - 1) / THREADS;
  aux_instance_pick_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)choice, (const float*)req, (const float*)aux_free,
      (const uint8_t*)aux_valid, P, N, J, least, eps, (int32_t*)inst,
      (uint8_t*)ok);
  return (int)cudaGetLastError();
}
