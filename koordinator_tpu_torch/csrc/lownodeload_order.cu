// K11 lnl_eviction_order: the LowNodeLoad plan's classification, budget
// and global eviction order, in one block.
//
// Replaces koordinator_tpu/descheduler/lownodeload_device.py
// _plan_prelude (:75-96, :113-125) less node_fit (K10): per node, the
// usage% on the threshold dims (`sel` = a column gather, the dot's -0.0
// turned +0.0), in deviation mode the thresholds moved to the fresh
// nodes' average, the low and high masks, the high threshold in usage
// units (`capacity * high * f32(0.01)`: XLA's rewrite of `/ 100`), the
// destinations' budget (each term `fma(capacity * high, 0.01, -usage)`,
// as XLA contracts it, summed in its tree order), the source nodes'
// weighted usage% (a chain of fused multiply-adds, as XLA contracts
// it) and rank; per pod, whether it may go (eligible, on a node, the
// node a source) and its weighted usage; and the order: pods by
// (node rank, weighted usage descending, index), which equals the
// reference's two stable argsorts, non-source nodes ranked after the
// sources in index order, nodeless pods last.
//
// What bounds it on the H100: neither bytes nor operations. The inputs
// are [N, 11] f32 twice and a few [P] columns (about 1 MB at config 5),
// the work a few operations a node and pod; the floor is the two
// dependent sorts and the tree sums' levels in one block.
//
// Design: one block of 1024 threads (the sorts and the tree sums need
// every value of a column). Each key is 64 bits, unique (the index in
// its low bits), so the bitonic sort needs no stability: nodes sort on
// (sort_bits(-node_w) or +inf, index); pods on (node rank,
// sort_bits(-pod_w), index). Up to 16 384 nodes and pods the keys sit
// in shared memory (128 KB) and the index takes 14 bits, the rank 15;
// above that (a cluster listing pods on every node) the same block
// sorts in device memory, with an index field of bit_length(P - 1)
// bits and a rank field of bit_length(N) (the wrapper refuses the
// sizes whose fields pass 32 bits together), and the tree sums' partials
// sit in device memory too: the same sums in the same order. No library
// sort: the card path holds no torch.sort.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lownodeload.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int MAX_KEYS = 16384;  // N and P in shared memory
constexpr int IDX_BITS = 14;     // the index field there
constexpr int R = 11;  // NUM_RESOURCES: the row stride of usage, capacity
constexpr int MAX_PARTIALS = MAX_KEYS / 32;

struct Args {
  const float* usage;
  const float* capacity;
  const uint8_t* fresh;
  const uint8_t* source_mask;
  const int32_t* pod_node;
  const float* pod_usage_r;
  const uint8_t* pod_eligible;
  const float* low;
  const float* high;
  const float* weights;
  const int32_t* rdims;
  int32_t* order;
  uint8_t* active;
  float* budget0;
  float* high_abs;
  uint8_t* low_mask;
  float* usage_sel;
  float* pct;       // scratch [N, RD]
  float* term;      // scratch [N, RD]
  int32_t* src_rank;  // scratch [N]
  int32_t* source;    // scratch [N]
  uint64_t* keys;     // above MAX_KEYS: scratch [pow2 >= max(N, P)]
  float* ping;        // above MAX_KEYS: scratch [N / 32 + 1] each
  float* pong;
  int N, P, RD, deviation;
  int node_bits, pod_bits;  // the index fields' widths
};

// ascending bitonic sort of keys[0, m), m a power of two
__device__ void bitonic_sort(uint64_t* keys, int m) {
  for (int k = 2; k <= m; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < m; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t a = keys[i], b = keys[ixj];
          const bool up = (i & k) == 0;
          if ((a > b) == up) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

__device__ int pow2_at_least(int n) {
  int m = 2;
  while (m < n) m <<= 1;
  return m;
}

// BIG: the keys and the tree sums' partials in device memory (a.keys,
// a.ping, a.pong), else in shared memory
template <bool BIG>
__global__ void __launch_bounds__(THREADS) eviction_order_kernel(Args a) {
  extern __shared__ uint64_t s_keys[];  // [pow2 >= max(N, P)]
  __shared__ float s_low[lnl::MAX_RD], s_high[lnl::MAX_RD],
      s_w[lnl::MAX_RD];
  __shared__ int s_rd[lnl::MAX_RD];
  __shared__ float s_ping[BIG ? 1 : MAX_PARTIALS];
  __shared__ float s_pong[BIG ? 1 : MAX_PARTIALS], s_out;
  uint64_t* const keys = BIG ? a.keys : s_keys;
  float* const ping = BIG ? a.ping : s_ping;
  float* const pong = BIG ? a.pong : s_pong;
  const uint64_t node_mask = (1ull << a.node_bits) - 1;
  const uint64_t pod_mask = (1ull << a.pod_bits) - 1;
  const int tid = threadIdx.x, T = blockDim.x;
  const int N = a.N, P = a.P, RD = a.RD;
  if (tid < RD) {
    s_rd[tid] = a.rdims[tid];
    s_low[tid] = a.low[tid];
    s_high[tid] = a.high[tid];
    s_w[tid] = a.weights[tid];
  }
  __syncthreads();

  // usage% on the threshold dims: 100 * usage / max(capacity, eps)
  for (int n = tid; n < N; n += T) {
    for (int d = 0; d < RD; ++d) {
      const float u = __fadd_rn(a.usage[n * R + s_rd[d]], 0.0f);
      const float c = __fadd_rn(a.capacity[n * R + s_rd[d]], 0.0f);
      a.usage_sel[n * RD + d] = u;
      a.pct[n * RD + d] = __fdiv_rn(__fmul_rn(100.0f, u), fmaxf(c, 1e-9f));
    }
  }
  __syncthreads();

  if (a.deviation) {
    int nf = 0;
    for (int base = 0; base < N; base += T) {
      const int n = base + tid;
      nf += __syncthreads_count(n < N && a.fresh[n]);
    }
    const float nff = (float)max(nf, 1);
    for (int d = 0; d < RD; ++d) {
      const float sum = lnl::tree_sum(
          N, [&](int n) { return a.fresh[n] ? a.pct[n * RD + d] : 0.0f; },
          ping, pong, &s_out);
      const float avg = __fdiv_rn(sum, nff);
      if (tid == 0) {
        s_low[d] = fminf(fmaxf(__fsub_rn(avg, s_low[d]), 0.0f), 100.0f);
        s_high[d] = fminf(fmaxf(__fadd_rn(avg, s_high[d]), 0.0f), 100.0f);
      }
      __syncthreads();
    }
  }

  // masks, high_abs, budget terms, node keys
  for (int n = tid; n < N; n += T) {
    const bool fresh = a.fresh[n];
    bool all_low = true, any_high = false;
    float w = 0.0f;
    for (int d = 0; d < RD; ++d) {
      const float p = a.pct[n * RD + d];
      all_low &= p < s_low[d];
      any_high |= p > s_high[d];
      w = __fmaf_rn(p, s_w[d], w);
    }
    const bool low = fresh && all_low;
    const bool src = a.source_mask[n] && fresh && any_high;
    for (int d = 0; d < RD; ++d) {
      const float c = __fadd_rn(a.capacity[n * R + s_rd[d]], 0.0f);
      const float scaled = __fmul_rn(c, s_high[d]);
      a.high_abs[n * RD + d] = __fmul_rn(scaled, 0.01f);
      a.term[n * RD + d] =
          low ? __fmaf_rn(scaled, 0.01f, -a.usage_sel[n * RD + d]) : 0.0f;
    }
    a.low_mask[n] = low;
    a.source[n] = src;
    const float key = src ? -w : __int_as_float(0x7f800000);
    keys[n] = (uint64_t)lnl::sort_bits(key) << a.node_bits | (uint64_t)n;
  }
  const int mn = pow2_at_least(N);
  for (int i = N + tid; i < mn; i += T) keys[i] = ~0ull;
  __syncthreads();

  for (int d = 0; d < RD; ++d) {
    const float b = lnl::tree_sum(
        N, [&](int n) { return a.term[n * RD + d]; }, ping, pong, &s_out);
    if (tid == 0) a.budget0[d] = b;
  }

  // node ranks: sources by weighted usage% descending, then the rest
  bitonic_sort(keys, mn);
  for (int i = tid; i < N; i += T) a.src_rank[keys[i] & node_mask] = i;
  __syncthreads();

  // pods: (node rank, -pod_w, index); nodeless pods rank N
  for (int p = tid; p < P; p += T) {
    const int raw = a.pod_node[p];
    const bool on = raw >= 0;
    const int pn = min(max(raw, 0), N - 1);
    const int rank = on ? a.src_rank[pn] : N;
    float w = 0.0f;
    for (int d = 0; d < RD; ++d)
      w = __fmaf_rn(a.pod_usage_r[p * RD + d], s_w[d], w);
    a.active[p] = a.pod_eligible[p] && on && a.source[pn];
    keys[p] = (uint64_t)rank << (32 + a.pod_bits) |
              (uint64_t)lnl::sort_bits(-w) << a.pod_bits | (uint64_t)p;
  }
  const int mp = pow2_at_least(P);
  for (int i = P + tid; i < mp; i += T) keys[i] = ~0ull;
  __syncthreads();
  bitonic_sort(keys, mp);
  for (int i = tid; i < P; i += T) a.order[i] = (int32_t)(keys[i] & pod_mask);
}

}  // namespace

extern "C" int koord_lnl_eviction_order(const void* const* ptr,
                                        const int* dims, void* stream) {
  Args a;
  a.usage = (const float*)ptr[0];
  a.capacity = (const float*)ptr[1];
  a.fresh = (const uint8_t*)ptr[2];
  a.source_mask = (const uint8_t*)ptr[3];
  a.pod_node = (const int32_t*)ptr[4];
  a.pod_usage_r = (const float*)ptr[5];
  a.pod_eligible = (const uint8_t*)ptr[6];
  a.low = (const float*)ptr[7];
  a.high = (const float*)ptr[8];
  a.weights = (const float*)ptr[9];
  a.rdims = (const int32_t*)ptr[10];
  a.order = (int32_t*)ptr[11];
  a.active = (uint8_t*)ptr[12];
  a.budget0 = (float*)ptr[13];
  a.high_abs = (float*)ptr[14];
  a.low_mask = (uint8_t*)ptr[15];
  a.usage_sel = (float*)ptr[16];
  a.N = dims[0];
  a.P = dims[1];
  a.RD = dims[2];
  a.deviation = dims[3];
  float* scratch = (float*)ptr[17];  // [2 N RD + 2 N]
  a.pct = scratch;
  a.term = scratch + (size_t)a.N * a.RD;
  a.src_rank = (int32_t*)(scratch + (size_t)2 * a.N * a.RD);
  a.source = a.src_rank + a.N;
  if (a.N < 1 || a.P < 0 || a.RD < 1 || a.RD > lnl::MAX_RD)
    return (int)cudaErrorInvalidValue;
  int m = 2;
  while (m < a.N || m < a.P) m <<= 1;
  const bool big = a.N > MAX_KEYS || a.P > MAX_KEYS;
  auto bits = [](long long x) {  // bit_length(x), at least 1
    int b = 1;
    while (b < 62 && (1ll << b) <= x) ++b;
    return b;
  };
  a.node_bits = big ? bits(a.N - 1) : IDX_BITS;
  a.pod_bits = big ? bits(a.P - 1) : IDX_BITS;
  if (big && bits(a.N) + a.pod_bits > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (big) {
    // after the [2 N RD + 2 N] scratch: the keys (8-byte aligned), then
    // the partials
    uintptr_t k = (uintptr_t)(a.source + a.N);
    a.keys = (uint64_t*)((k + 7) & ~(uintptr_t)7);
    a.ping = (float*)(a.keys + m);
    a.pong = a.ping + a.N / 32 + 1;
    eviction_order_kernel<true><<<1, THREADS, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)m * sizeof(uint64_t);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        eviction_order_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(MAX_KEYS * sizeof(uint64_t)));
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  eviction_order_kernel<false><<<1, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}
