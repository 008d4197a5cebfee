// K6 device_pair_terms: the batch-start DeviceShare gate and pool score of
// every (pod, node) pair.
//
// Replaces the device part of the static gates of
// koordinator_tpu/scheduler/core.py schedule_batch (:305-329), which XLA
// runs as fused programs over [P, N, I, 3]:
// - plugins/deviceshare.py:124 prefilter (its GPU part): a GPU pod needs
//   at least `count` valid instances on the node that each fit its
//   per-instance request at that node's per-GPU memory;
// - plugins/deviceshare.py:152 score_matrix: the least- (or most-)
//   allocated score of the node's GPU pool after the pod's allocation,
//   averaged over the device dims the pod asks for, times 100;
// pods without a GPU request pass everywhere and score 0;
// - the prefilter's aux part (deviceshare.py:123-133), on a snapshot
//   with aux (RDMA/FPGA) pools: for each pool the pod asks for, a valid
//   instance whose free covers the request (one instance serves a whole
//   request, devicehandler_default.go).
// It writes bool pair_ok[P, N] (ANDed into K4's NUMA mask in place when
// the caller passes one) and f32 pair_score[P, N]; K1 reads both. A
// snapshot with aux pools and no GPU instance runs the aux part alone
// and writes no score (there is no GPU pool to score). Under
// the cascade's stage 2 (core.py:304-327) P is the batch's gpu prefix:
// the caller passes the first P pods and the pair mask, whose first P
// rows it ANDs. The gate tolerance eps comes from the host
// (scheduler/batching.py EPS).
//
// What bounds it on the H100: bytes. A pair writes 5 bytes (6 where it
// ANDs into a mask it reads); a GPU pod's pair costs I fit tests and a
// few correctly rounded divisions, and 90 % of the flagship's pods ask
// for no GPU. 2000 x 10^4 pairs a chunk write 100 MB.
//
// Design: a block of TILE threads owns a tile of TILE nodes and 16
// pods. It stages the tile's instance free, valid bits (a word a node),
// per-GPU memory and pool sums, each aux pool's largest valid free, and
// the pods' requests, in shared memory; thread t takes node t of the
// tile for each of the 16 pods, so a warp writes 32 consecutive nodes
// of one pod row at a time. Two builds: up to 16 instances a node on
// tiles of 128 nodes (24 KB of instance free a block), and up to 64 (8
// GPUs in 7 MIG slices) on tiles of 32 nodes, so that the wide one's 24
// KB fit a block as well. An aux pool has a fitting instance iff its
// largest valid free plus eps covers the request: f32 addition rounds
// monotonically, so max_j (free_j + eps) = max_j free_j + eps; any J up
// to 64.
//
// Exactness against the reference (bit for bit): the file builds with
// -fmad=false and names each rounding (device_share.cuh for the
// per-instance request). The pool total is the per-GPU total times the
// valid instance count; the pool free sums free * valid over the
// instances in order from 0 (exact on integer-valued instance state in
// any order). used_after = (pool_total - pool_free) + per * count,
// frac = used_after / max(pool_total, 1e-9), the weighted sum over the
// three dims ((0 + t0 * w0) + t1 * w1) + t2 * w2 (t = frac for "most",
// 1 - frac for "least"; w = 1 where the per-instance request is > 0),
// divided by max(w0 + w1 + w2, 1), clipped to [0, 1], times 100: the
// reference's order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "device_share.cuh"

namespace {

constexpr int PODS = 16;   // pods a block
constexpr int NARROW_I = 16, MAX_I = 64, MAX_J = 64;

// MI instances a node at most, on tiles of TILE nodes (TILE threads)
template <int MI, int TILE>
__global__ void __launch_bounds__(TILE) device_pair_terms_kernel(
    const float* __restrict__ gpu_req, const float* __restrict__ total,
    const float* __restrict__ free_, const uint8_t* __restrict__ valid,
    const float* __restrict__ aux_req, const float* __restrict__ aux_free,
    const uint8_t* __restrict__ aux_valid, int P, int N, int I, int J,
    int least, float eps, const uint8_t* and_in, uint8_t* out_ok,
    float* __restrict__ out_score) {
  using Word = typename std::conditional<(MI > 32), unsigned long long,
                                         unsigned>::type;
  __shared__ float s_free[MI][3][TILE];
  __shared__ Word s_valid[TILE];
  __shared__ float s_mem[TILE];
  __shared__ float s_pool_total[3][TILE];
  __shared__ float s_pool_free[3][TILE];
  __shared__ float s_req[PODS][3];
  __shared__ float s_aux_max[2][TILE];
  __shared__ float s_areq[PODS][2];

  const int t = threadIdx.x;
  const int n0 = blockIdx.x * TILE, p0 = blockIdx.y * PODS;
  const int n = n0 + t;
  if (n < N) {
    Word vbits = 0;
    int vn = 0;
    float pf[3] = {0.0f, 0.0f, 0.0f};
    for (int i = 0; i < I; ++i) {
      const size_t o = (size_t)n * I + i;
      const bool v = valid[o] != 0;
      vbits |= (Word)v << i;
      vn += v;
      for (int d = 0; d < 3; ++d) {
        const float f = free_[o * 3 + d];
        s_free[i][d][t] = f;
        pf[d] = __fadd_rn(pf[d], __fmul_rn(f, v ? 1.0f : 0.0f));
      }
    }
    s_valid[t] = vbits;
    for (int a = 0; a < 2 && J > 0; ++a) {
      float m = -INFINITY;
      for (int j = 0; j < J; ++j) {
        const size_t o = ((size_t)n * 2 + a) * J + j;
        if (aux_valid[o]) m = fmaxf(m, aux_free[o]);
      }
      s_aux_max[a][t] = m;
    }
    s_mem[t] = I > 0 ? total[(size_t)n * 3 + 1] : 0.0f;
    for (int d = 0; d < 3; ++d) {
      s_pool_total[d][t] = __fmul_rn(total[(size_t)n * 3 + d], (float)vn);
      s_pool_free[d][t] = pf[d];
    }
  }
  for (int k = t; k < PODS * 5; k += TILE) {
    if (k < PODS * 3) {
      const int q = p0 + k / 3;
      s_req[k / 3][k % 3] = q < P && I > 0 ? gpu_req[(size_t)q * 3 + k % 3]
                                           : 0.0f;
    } else {
      const int a = k - PODS * 3, q = p0 + a / 2;
      s_areq[a / 2][a % 2] = q < P && J > 0 ? aux_req[(size_t)q * 2 + a % 2]
                                            : 0.0f;
    }
  }
  __syncthreads();
  if (n >= N) return;

  for (int j = 0; j < PODS && p0 + j < P; ++j) {
    const int p = p0 + j;
    const float core = s_req[j][0], mem = s_req[j][1], ratio = s_req[j][2];
    bool ok = true;
    float score = 0.0f;
    if (core > 0.0f || mem > 0.0f || ratio > 0.0f) {
      const koord_dev::PerInst pi =
          koord_dev::per_instance(s_mem[t], core, mem, ratio);
      int n_fit = 0;
      for (int i = 0; i < I; ++i) {
        const float f3[3] = {s_free[i][0][t], s_free[i][1][t],
                             s_free[i][2][t]};
        n_fit += ((s_valid[t] >> i) & 1) && koord_dev::covers(f3, pi.v, eps);
      }
      ok = n_fit >= pi.count;
      float s = 0.0f, wsum = 0.0f;
      for (int d = 0; d < 3; ++d) {
        const float pt = s_pool_total[d][t];
        const float used = __fadd_rn(__fsub_rn(pt, s_pool_free[d][t]),
                                     __fmul_rn(pi.v[d], (float)pi.count));
        float frac = __fdiv_rn(used, fmaxf(pt, 1e-9f));
        if (least) frac = __fsub_rn(1.0f, frac);
        const float w = pi.v[d] > 0.0f ? 1.0f : 0.0f;
        s = __fadd_rn(s, __fmul_rn(frac, w));
        wsum = __fadd_rn(wsum, w);
      }
      score = __fmul_rn(
          fminf(fmaxf(__fdiv_rn(s, fmaxf(wsum, 1.0f)), 0.0f), 1.0f), 100.0f);
    }
    for (int a = 0; a < 2 && J > 0; ++a) {
      const float r = s_areq[j][a];
      ok &= r <= 0.0f || __fadd_rn(s_aux_max[a][t], eps) >= r;
    }
    const size_t o = (size_t)p * N + n;
    out_ok[o] = (and_in == nullptr || and_in[o]) && ok;
    if (out_score != nullptr) out_score[o] = score;
  }
}

}  // namespace

// ptr: gpu_req [P, 3] (core, memory, memory ratio), gpu_total [N, 3],
// gpu_free [N, I, 3], gpu_valid [N, I], and_in [P, N] (or null; may be
// pair_ok itself), pair_ok [P, N], pair_score [P, N] (null where I = 0),
// aux_req [P, 2], aux_free [N, 2, J], aux_valid [N, 2, J] (unread where
// J = 0). least: 1 for "least", 0 for "most"; eps: the gate tolerance.
// I = 0 runs the aux part alone, J = 0 the GPU part alone.
extern "C" int koord_device_pair_terms(const void* const* ptr, int P, int N,
                                       int I, int J, int least, float eps,
                                       void* stream) {
  if (P <= 0 || N <= 0) return 0;
  if (I < 0 || I > MAX_I || J < 0 || J > MAX_J || I + J == 0 ||
      (I > 0 && ptr[6] == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool narrow = I <= NARROW_I;
  const int tile = narrow ? 128 : 32;
  const dim3 grid((N + tile - 1) / tile, (P + PODS - 1) / PODS);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  auto kernel = &device_pair_terms_kernel<NARROW_I, 128>;
  if (!narrow) kernel = &device_pair_terms_kernel<MAX_I, 32>;
  kernel<<<grid, tile, 0, (cudaStream_t)stream>>>(
      (const float*)ptr[0], (const float*)ptr[1], (const float*)ptr[2],
      (const uint8_t*)ptr[3], (const float*)ptr[7], (const float*)ptr[8],
      (const uint8_t*)ptr[9], P, N, I, J, least, eps, (const uint8_t*)ptr[4],
      (uint8_t*)ptr[5], (float*)ptr[6]);
  return (int)cudaGetLastError();
}
