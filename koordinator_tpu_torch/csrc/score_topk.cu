// K1 score_topk: fused fit, LoadAware score, tie-break jitter, mask and
// top-k of one commit round.
//
// Replaces the JAX device program of one round of
// koordinator_tpu/scheduler/core.py schedule_batch: the resource fit
// (core.py:565-577), the quota/activity row mask (core.py:675-684),
// plugins/loadaware.py score_matrix (the floor'd weighted
// least-requested score, loadaware.py:161-219), the jitter, the -1 mask
// and lax.top_k (core.py:721-742). XLA materialises the [P, N] score
// matrix in device memory and reduces it; this kernel never writes it.
//
// What bounds it on the H100: each (pod, node) pair reads one byte of
// the static gate mask (P*N bytes from device memory: 20 MB at P=2000,
// N=10^4) and, for pairs that pass the gates, does two correctly rounded
// f32 divisions per score dim plus one more for the weight average
// (about 6e8 f32 operations at that shape); the per-node columns (about
// 60 bytes a node) stay in L2. Both bounds sit near 10 us; launch and the
// k-round warp merge add a few us.
//
// Design: one warp per pod row, four rows a block. The 32 lanes stride
// over the nodes in ascending order and each keeps its own sorted top-K
// list in registers (K = 8 or 32, unrolled insertion). A node's entry
// enters a lane's list only when strictly greater than the list's last
// entry, so among equal values the lower node index (seen first) stays
// ahead: lax.top_k's order, value descending then index ascending. The
// warp then merges the 32 lists in k rounds of a butterfly arg-max under
// the same total order; the winning lane pops its head. Rows that are
// inactive or over quota are all -1 and write (-1, 0..k-1) directly,
// which is what the order gives them.
//
// Exactness against the reference (bit for bit): the file builds with
// -fmad=false, and the arithmetic names its rounding. The floors sit on
// IEEE divisions (__fdiv_rn). The reference's compiler contracts two
// multiply-adds, and so does this kernel, by name (__fmaf_rn): the
// weighted sum of the per-dim scores and the jitter
// score + h * f32(0.49/1024). The jitter hash is uint32 arithmetic, as
// in the reference.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_DIMS = 8;
constexpr float JITTER = (float)(0.49 / 1024.0);
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

template <int K>
__global__ void score_topk_kernel(
    const uint8_t* __restrict__ static_ok, const uint8_t* __restrict__ row_ok,
    const float* __restrict__ req_fit, const float* __restrict__ requested_fit,
    const float* __restrict__ alloc_fit, const float* __restrict__ est,
    const uint8_t* __restrict__ prod_scored,
    const float* __restrict__ node_term, const float* __restrict__ prod_term,
    const float* __restrict__ alloc_score, const uint8_t* __restrict__ fresh,
    const float* __restrict__ weights, int P, int N, int F, int D, int k,
    int tie_break, float eps, float* __restrict__ out_val,
    int32_t* __restrict__ out_idx) {
  const int p = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= P) return;  // the whole warp leaves together
  float* ov = out_val + (size_t)p * k;
  int32_t* oi = out_idx + (size_t)p * k;
  if (!row_ok[p]) {
    for (int j = lane; j < k; j += 32) {
      ov[j] = -1.0f;
      oi[j] = j;
    }
    return;
  }

  float rq[MAX_DIMS], es[MAX_DIMS], w[MAX_DIMS];
  float wsum = 0.0f;
#pragma unroll
  for (int d = 0; d < MAX_DIMS; ++d) {
    rq[d] = d < F ? req_fit[(size_t)p * F + d] : 0.0f;
    es[d] = d < D ? est[(size_t)p * D + d] : 0.0f;
    w[d] = d < D ? weights[d] : 0.0f;
    if (d < D) wsum = __fadd_rn(wsum, w[d]);
  }
  wsum = fmaxf(wsum, 1e-9f);
  const float* term = prod_scored[p] ? prod_term : node_term;
  const uint8_t* srow = static_ok + (size_t)p * N;

  float lv[K];
  int li[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    lv[j] = -INFINITY;
    li[j] = 0x7fffffff;
  }

  for (int n = lane; n < N; n += 32) {
    bool feas = srow[n] != 0;
#pragma unroll
    for (int f = 0; f < MAX_DIMS; ++f) {
      if (feas && f < F) {
        const size_t o = (size_t)n * F + f;
        feas = __fadd_rn(rq[f], requested_fit[o]) <= __fadd_rn(alloc_fit[o], eps);
      }
    }
    float v = -1.0f;
    if (feas) {
      float score = 0.0f;
      if (fresh[n]) {
        float acc = 0.0f;
#pragma unroll
        for (int d = 0; d < MAX_DIMS; ++d) {
          if (d < D) {
            const size_t o = (size_t)n * D + d;
            const float cap = alloc_score[o];
            const float eu = __fadd_rn(es[d], term[o]);
            float least = floorf(__fdiv_rn(
                __fmul_rn(__fsub_rn(cap, eu), 100.0f), fmaxf(cap, 1e-9f)));
            if (!(cap > 0.0f && eu <= cap)) least = 0.0f;
            acc = __fmaf_rn(least, w[d], acc);
          }
        }
        score = floorf(__fdiv_rn(acc, wsum));
      }
      if (tie_break) {
        const uint32_t h =
            ((uint32_t)p * 2654435761u + (uint32_t)n * 40503u) & 1023u;
        score = __fmaf_rn((float)h, JITTER, score);
      }
      v = score;
    }
    if (v > lv[K - 1]) {
      lv[K - 1] = v;
      li[K - 1] = n;
#pragma unroll
      for (int j = K - 1; j > 0; --j) {
        if (lv[j] > lv[j - 1]) {
          const float tv = lv[j];
          lv[j] = lv[j - 1];
          lv[j - 1] = tv;
          const int ti = li[j];
          li[j] = li[j - 1];
          li[j - 1] = ti;
        }
      }
    }
  }

  for (int r = 0; r < k; ++r) {
    float bv = lv[0];
    int bi = li[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_xor_sync(FULL, bv, off);
      const int i2 = __shfl_xor_sync(FULL, bi, off);
      if (better(v2, i2, bv, bi)) {
        bv = v2;
        bi = i2;
      }
    }
    if (lane == 0) {
      ov[r] = bv;
      oi[r] = bi;
    }
    if (li[0] == bi && lv[0] == bv) {
#pragma unroll
      for (int j = 0; j < K - 1; ++j) {
        lv[j] = lv[j + 1];
        li[j] = li[j + 1];
      }
      lv[K - 1] = -INFINITY;
      li[K - 1] = 0x7fffffff;
    }
  }
}

}  // namespace

extern "C" int koord_score_topk(
    const void* static_ok, const void* row_ok, const void* req_fit,
    const void* requested_fit, const void* alloc_fit, const void* est,
    const void* prod_scored, const void* node_term, const void* prod_term,
    const void* alloc_score, const void* fresh, const void* weights, int P,
    int N, int F, int D, int k, int tie_break, float eps, void* out_val,
    void* out_idx, void* stream) {
  if (P <= 0) return 0;
  if (F > MAX_DIMS || D > MAX_DIMS || k > 32 || k > N || k <= 0)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (int)(((size_t)P * 32 + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
#define KOORD_ARGS                                                          \
  (const uint8_t*)static_ok, (const uint8_t*)row_ok, (const float*)req_fit, \
      (const float*)requested_fit, (const float*)alloc_fit,                 \
      (const float*)est, (const uint8_t*)prod_scored,                       \
      (const float*)node_term, (const float*)prod_term,                     \
      (const float*)alloc_score, (const uint8_t*)fresh,                     \
      (const float*)weights, P, N, F, D, k, tie_break, eps,                 \
      (float*)out_val, (int32_t*)out_idx
  if (k <= 8)
    score_topk_kernel<8><<<blocks, threads, 0, s>>>(KOORD_ARGS);
  else
    score_topk_kernel<32><<<blocks, threads, 0, s>>>(KOORD_ARGS);
#undef KOORD_ARGS
  return (int)cudaGetLastError();
}
