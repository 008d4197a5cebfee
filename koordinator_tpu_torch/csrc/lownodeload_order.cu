// K11 lnl_eviction_order: the LowNodeLoad plan's classification, budget
// and global eviction order, grid-wide.
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
// the work a few operations a node and pod; the floor is the chain of
// dependent steps (classify, rank the nodes, bucket the pods, order
// each bucket) and what each costs in launches or grid barriers.
//
// Design: every step spreads over the grid (blocks of 1024 threads); no
// block sorts the whole problem and no library sort runs.
// 1. nodes, a thread a node: pct, masks, high_abs, usage_sel, the
//    budget terms, the source flag and the node's sort key
//    (sort_bits(source ? -w : +inf) above the index: unique, a total
//    order that keeps the reference's -0.0 and NaN rule). The rows are
//    offset by the tree sum's padding, so that each warp holds one
//    level-0 window of 32 rows of XLA:CPU's column sum, which the block
//    adds in order. In deviation mode a first pass does the same for the
//    fresh nodes' pct, one block finishes those sums into the moved
//    thresholds, and the pass above reads them.
// 2. the node ranks. The node pass also counts, a block of 1024 nodes
//    at a time, its nodes of finite key (the sources, F) and of key
//    +inf (the non-sources). Then a grid pass: each block sums the
//    earlier blocks' counts and its own nodes' (ballots), which gives
//    every node its place in its key group in index order; a source is
//    listed at its place, a non-source ranks |F| + its place, and a
//    source whose weighted usage is NaN ranks after all of them. One
//    more block finishes the budget's tree sums meanwhile. Then each
//    source's rank is the count of listed keys below its own: a
//    persistent grid walks the (1024 sources, 256 keys staged in shared
//    memory) tiles of the list, adding by integer atomics (exact).
//    O(|F|^2) compares: 1.3e7 at config 5 (3546 sources).
// 3. the pods by a counting sort on node rank: a thread a pod computes
//    its bucket (its node's rank, N when nodeless), `active` and its key
//    (sort_bits(-w) above the index) and counts its bucket (integer
//    atomics: exact); a grid pass turns the N + 1 counts into the
//    buckets' first slots (each block of 1024 buckets sums the counts
//    before it and scans its own); each pod takes a
//    slot of its bucket (atomics: the order inside a bucket is
//    arbitrary here); a pod of a bucket of at most 32 places itself by
//    counting the keys of its bucket below its own. A bucket above 32 (a
//    hot node, every pod nodeless) is ordered by tiles: each tile of 2048
//    slots that holds one is sorted by (bucket, key) in shared memory (a
//    bitonic sort, its in-warp stages in registers), and its pods add a
//    binary search in each tile of the bucket. The place is unique
//    because the keys are, so the order is the same on every run.
// The steps run in one cooperative launch, grid barriers between them.
// A chain of one kernel a step on the stream took the same device time
// on the H100 and swapped places with it by events, in eight launches.
//
// Limits: N >= 1, 1 <= Rd <= 11, N + 1 and P below 2^31 (the ranks and
// indices are int32; the keys keep the index in 32 bits of their own).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lownodeload.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int TILE = 2 * THREADS;  // keys a tile sort holds
constexpr int R = 11;  // NUM_RESOURCES: the row stride of usage, capacity
constexpr int WINDOWS = THREADS / lnl::TREE_BASE;  // windows a node block
constexpr uint32_t NO_BUCKET = 0xffffffffu;
constexpr uint32_t KEY_INF = 0xff800000u;  // sort_bits(+inf): non-sources
constexpr int RANK_KEYS = 256;  // listed keys a rank block stages
constexpr int SMALL_BUCKET = 32;  // pods a bucket places by counting
// a kernel's shared buffer: the tile sort's keys and buckets, or the
// rank step's staged keys
constexpr int SMEM_BYTES = TILE * (sizeof(uint64_t) + sizeof(uint32_t));
static_assert(SMEM_BYTES >= RANK_KEYS * sizeof(uint64_t),
              "one buffer serves every step");

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
  // scratch
  float* term;       // [N, Rd] the budget terms (first pass: fresh pct)
  float* part_dev;   // [Rd, W0] level-0 window sums of the fresh pct
  float* part_bud;   // [Rd, W0] and of the budget terms
  float* ping;       // [W0 / 32 + 2] each: the later levels
  float* pong;
  float* thr;        // [2 Rd] the thresholds moved (deviation mode)
  uint8_t* source;   // [N]
  uint64_t* node_key;   // [N]
  uint64_t* f_list;     // [N] the finite keys (the sources), index order
  int32_t* blk_count;   // [2 node blocks] each node block's F, +inf count
  int32_t* n_group;     // [2] |F|, the non-sources' count
  int32_t* node_rank;   // [N]
  int32_t* counts;      // [N + 1] pods a bucket
  int32_t* offsets;     // [N + 2] each bucket's first slot, then P
  int32_t* cursor;      // [N + 1]
  uint64_t* pod_key;    // [P] by pod
  int32_t* pod_bucket;  // [P]
  uint64_t* slot_key;   // [P] by slot, sorted in tiles in place
  int32_t* slot_bucket; // [P]
  int N, P, RD, deviation;
  int W0, lo;  // the tree sums' level-0 windows and padding (N > 32)
  int node_blocks;  // blocks of the node pass (rows offset by lo)
};

// max(x, y) that keeps a NaN x, as torch.maximum and jnp.maximum do
__device__ __forceinline__ float max_nan(float x, float y) {
  return x != x ? x : fmaxf(x, y);
}

// clip(x, 0, 100) that keeps a NaN, as torch.clamp and jnp.clip do
__device__ __forceinline__ float clip_nan(float x) {
  return x != x ? x : fminf(fmaxf(x, 0.0f), 100.0f);
}

__device__ __forceinline__ int blocks_of(int n, int per) {
  return (n + per - 1) / per;
}

// The sum of m values x[k * stride], continuing XLA:CPU's tree from a
// level whose partials they are: windows of 32 (the padding split
// evenly) while more than 32 remain, then the rest in order. One block;
// every thread calls it and gets the sum.
__device__ float tree_finish(const float* x, int m, int stride, float* ping,
                             float* pong) {
  __shared__ float s_out;
  const int tid = threadIdx.x;
  const float* src = x;
  int sstride = stride;
  float* dst = ping;
  while (m > lnl::TREE_BASE) {
    const int m2 = blocks_of(m, lnl::TREE_BASE);
    const int lo = (m2 * lnl::TREE_BASE - m) / 2;
    for (int b = tid; b < m2; b += blockDim.x) {
      float acc = 0.0f;
      for (int j = 0; j < lnl::TREE_BASE; ++j) {
        const int k = b * lnl::TREE_BASE + j - lo;
        acc = __fadd_rn(acc, k >= 0 && k < m ? src[(size_t)k * sstride]
                                             : 0.0f);
      }
      dst[b] = acc;
    }
    __syncthreads();
    src = dst;
    sstride = 1;
    dst = dst == ping ? pong : ping;
    m = m2;
  }
  __shared__ float last[lnl::TREE_BASE];
  if (tid < m) last[tid] = src[(size_t)tid * sstride];
  __syncthreads();
  if (tid == 0) {
    float acc = 0.0f;
    for (int k = 0; k < m; ++k) acc = __fadd_rn(acc, last[k]);
    s_out = acc;
  }
  __syncthreads();
  const float r = s_out;
  __syncthreads();
  return r;
}

// Step 1, block vb of the node pass: rows vb * 1024 + t - lo, so that
// warp w holds level-0 window vb * 32 + w. FINAL: the classification
// (thresholds from `thr` in deviation mode) and the budget terms' window
// sums, and the histogram zeroed; else the fresh nodes' pct and their
// window sums.
template <bool FINAL>
__device__ void phase_nodes(const Args& a, int vb) {
  const int tid = threadIdx.x, RD = a.RD;
  const int i = vb * THREADS + tid - a.lo;
  if (FINAL) {
    const int z = vb * THREADS + tid;
    if (z <= a.N) a.counts[z] = 0;
    if (z < a.N) a.node_rank[z] = 0;
  }
  const float* lowp = a.deviation ? a.thr : a.low;
  const float* highp = a.deviation ? a.thr + RD : a.high;
  if (i >= 0 && i < a.N) {
    const bool fresh = a.fresh[i];
    bool all_low = true, any_high = false;
    float w = 0.0f;
    for (int d = 0; d < RD; ++d) {
      const int col = a.rdims[d];
      const float u = __fadd_rn(a.usage[(size_t)i * R + col], 0.0f);
      const float c = __fadd_rn(a.capacity[(size_t)i * R + col], 0.0f);
      const float p = __fdiv_rn(__fmul_rn(100.0f, u), max_nan(c, 1e-9f));
      if (!FINAL) {
        a.term[(size_t)i * RD + d] = fresh ? p : 0.0f;
        continue;
      }
      all_low &= p < lowp[d];
      any_high |= p > highp[d];
      w = __fmaf_rn(p, a.weights[d], w);
    }
    if (FINAL) {
      const bool low = fresh && all_low;
      const bool src = a.source_mask[i] && fresh && any_high;
      for (int d = 0; d < RD; ++d) {
        const int col = a.rdims[d];
        const float u = __fadd_rn(a.usage[(size_t)i * R + col], 0.0f);
        const float c = __fadd_rn(a.capacity[(size_t)i * R + col], 0.0f);
        const float scaled = __fmul_rn(c, highp[d]);
        a.usage_sel[(size_t)i * RD + d] = u;
        a.high_abs[(size_t)i * RD + d] = __fmul_rn(scaled, 0.01f);
        a.term[(size_t)i * RD + d] =
            low ? __fmaf_rn(scaled, 0.01f, -u) : 0.0f;
      }
      a.low_mask[i] = low;
      a.source[i] = src;
      const float key = src ? -w : __int_as_float(0x7f800000);
      a.node_key[i] = (uint64_t)lnl::sort_bits(key) << 32 | (uint32_t)i;
    }
  }
  if (FINAL) {  // the block's nodes of finite key and of key +inf
    bool f = false, inf = false;
    if (i >= 0 && i < a.N) {
      const uint32_t hi = (uint32_t)(a.node_key[i] >> 32);
      f = hi < KEY_INF;
      inf = hi == KEY_INF;
    }
    const int nf = __syncthreads_count(f), ninf = __syncthreads_count(inf);
    if (tid == 0) {
      a.blk_count[2 * vb] = nf;
      a.blk_count[2 * vb + 1] = ninf;
    }
  }
  if (a.N > lnl::TREE_BASE) {
    __syncthreads();  // the block's rows are written
    float* part = FINAL ? a.part_bud : a.part_dev;
    for (int j = tid; j < WINDOWS * RD; j += THREADS) {
      const int b = vb * WINDOWS + j % WINDOWS, d = j / WINDOWS;
      if (b >= a.W0) continue;
      const int r0 = b * lnl::TREE_BASE - a.lo;
      float acc = 0.0f;
      for (int k = 0; k < lnl::TREE_BASE; ++k) {
        const int r = r0 + k;
        acc = __fadd_rn(acc, r >= 0 && r < a.N ? a.term[(size_t)r * RD + d]
                                               : 0.0f);
      }
      part[(size_t)d * a.W0 + b] = acc;
    }
  }
}

// The column sums of step 1's terms (fresh pct or budget), one block.
__device__ float column_sum(const Args& a, const float* part, int d) {
  return a.N > lnl::TREE_BASE
             ? tree_finish(part + (size_t)d * a.W0, a.W0, 1, a.ping, a.pong)
             : tree_finish(a.term + d, a.N, a.RD, a.ping, a.pong);
}

// Deviation mode, one block: the fresh nodes' average pct and the
// thresholds moved to it.
__device__ void phase_deviation(const Args& a) {
  int nf = 0;
  for (int base = 0; base < a.N; base += THREADS) {
    const int n = base + (int)threadIdx.x;
    nf += __syncthreads_count(n < a.N && a.fresh[n]);
  }
  const float nff = (float)max(nf, 1);
  for (int d = 0; d < a.RD; ++d) {
    const float avg = __fdiv_rn(column_sum(a, a.part_dev, d), nff);
    if (threadIdx.x == 0) {
      a.thr[d] = clip_nan(__fsub_rn(avg, a.low[d]));
      a.thr[a.RD + d] = clip_nan(__fadd_rn(avg, a.high[d]));
    }
  }
}

// The budget, one block.
__device__ void phase_budget(const Args& a) {
  for (int d = 0; d < a.RD; ++d) {
    const float b = column_sum(a, a.part_bud, d);
    if (threadIdx.x == 0) a.budget0[d] = b;
  }
}

// One compare-exchange of a bitonic sort's stage (k, j) for element x,
// given its partner's entry: x keeps the smaller of the two where it is
// the pair's lower index in an ascending run or the higher in a
// descending one, else the larger. Entries compare by (bucket, key).
__device__ __forceinline__ void exchange(uint32_t& b, uint64_t& key,
                                         uint32_t ob, uint64_t okey, int x,
                                         int k, int j) {
  const int y = x ^ j;
  const bool keep_min = (x < y) == ((min(x, y) & k) == 0);
  const bool other_less = ob < b || (ob == b && okey < key);
  if (keep_min == other_less) {
    b = ob;
    key = okey;
  }
}

// Stages j = jtop .. 1 of run length k on the thread's two entries
// (elements 2 t and 2 t + 1): j = 1 inside the thread, 2 <= j <= 32
// with the partner thread t ^ (j / 2) of the same warp by shuffles.
__device__ __forceinline__ void register_stages(uint32_t (&b)[2],
                                                uint64_t (&key)[2], int k,
                                                int jtop) {
  const int x0 = 2 * (int)threadIdx.x;
  for (int j = jtop; j >= 1; j >>= 1) {
    if (j == 1) {
      const uint32_t b0 = b[0], b1 = b[1];
      const uint64_t k0 = key[0], k1 = key[1];
      exchange(b[0], key[0], b1, k1, x0, k, 1);
      exchange(b[1], key[1], b0, k0, x0 + 1, k, 1);
      continue;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t ob = __shfl_xor_sync(0xffffffffu, b[e], j >> 1);
      const uint64_t okey = __shfl_xor_sync(0xffffffffu, key[e], j >> 1);
      exchange(b[e], key[e], ob, okey, x0 + e, k, j);
    }
  }
}

// Sort tile vb of keys[0, m) in place by (bucket, key): a bitonic sort
// of 2048 entries, two a thread. The
// stages whose pairs lie inside a warp's 64 entries run in registers
// and shuffles; the others (j >= 64) through shared memory, 25 block
// barriers in all where a plain shared-memory bitonic sort takes 66.
__device__ void phase_tile(uint64_t* keys, int32_t* bucket, int m, int vb,
                           unsigned char* smem) {
  uint64_t* const sk = reinterpret_cast<uint64_t*>(smem);
  uint32_t* const sb = reinterpret_cast<uint32_t*>(sk + TILE);
  const int tid = threadIdx.x;
  const size_t base = (size_t)vb * TILE;
  const int len = min(TILE, (int)(m - base));
  uint32_t b[2];
  uint64_t key[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = 2 * tid + e;
    const bool in = i < len;
    key[e] = in ? keys[base + i] : ~0ull;
    b[e] = in ? (uint32_t)bucket[base + i] : NO_BUCKET;
  }
  for (int k = 2; k <= 64; k <<= 1) register_stages(b, key, k, k >> 1);
  for (int k = 128; k <= TILE; k <<= 1) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sk[2 * tid + e] = key[e];
      sb[2 * tid + e] = b[e];
    }
    __syncthreads();
    for (int j = k >> 1; j >= 64; j >>= 1) {
      const int i = ((tid & ~(j - 1)) << 1) | (tid & (j - 1));
      const int l = i | j;
      const uint32_t bi = sb[i], bl = sb[l];
      const uint64_t ki = sk[i], kl = sk[l];
      const bool greater = bi > bl || (bi == bl && ki > kl);
      if (greater == ((i & k) == 0)) {
        sb[i] = bl;
        sb[l] = bi;
        sk[i] = kl;
        sk[l] = ki;
      }
      __syncthreads();
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      key[e] = sk[2 * tid + e];
      b[e] = sb[2 * tid + e];
    }
    __syncthreads();  // every entry is read before the next run's writes
    register_stages(b, key, k, 32);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = 2 * tid + e;
    if (i < len) {
      keys[base + i] = key[e];
      bucket[base + i] = (int32_t)b[e];
    }
  }
}

// The first index in [lo, hi) of sorted keys whose key is not below k.
__device__ __forceinline__ int lower_bound(const uint64_t* keys, int lo,
                                           int hi, uint64_t k) {
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (keys[mid] < k) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The sum of x over the block; every thread gets it.
__device__ __forceinline__ int block_sum(int x, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  int s = lane < THREADS / 32 ? red[lane] : 0;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
  __syncthreads();  // red is read
  return s;
}

// The exclusive prefix of x in thread order over the block.
__device__ __forceinline__ int block_exclusive(int x, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < THREADS / 32 ? red[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < THREADS / 32) red[lane] = w;
  }
  __syncthreads();
  const int out = (warp ? red[warp - 1] : 0) + incl - x;
  __syncthreads();  // red is read
  return out;
}

// Step 2a, block vb of the node pass's rows: each node's place in its
// key group in index order, from the earlier blocks' counts and its
// own block's; a source is listed at its place, a non-source ranked
// |F| + its place, a source of NaN weighted usage after all of them.
__device__ void phase_node_list(const Args& a, int vb) {
  __shared__ int red[THREADS / 32];
  const int tid = threadIdx.x;
  int pre_f = 0, pre_inf = 0, all_f = 0, all_inf = 0;
  for (int u = tid; u < a.node_blocks; u += THREADS) {
    const int f = a.blk_count[2 * u], inf = a.blk_count[2 * u + 1];
    pre_f += u < vb ? f : 0;
    pre_inf += u < vb ? inf : 0;
    all_f += f;
    all_inf += inf;
  }
  pre_f = block_sum(pre_f, red);
  pre_inf = block_sum(pre_inf, red);
  all_f = block_sum(all_f, red);
  all_inf = block_sum(all_inf, red);
  const int i = vb * THREADS + tid - a.lo;
  const bool in = i >= 0 && i < a.N;
  const uint64_t k = in ? a.node_key[i] : 0;
  const uint32_t hi = (uint32_t)(k >> 32);
  const bool f = in && hi < KEY_INF, inf = in && hi == KEY_INF;
  // the places of the block's earlier nodes, F below bit 16, +inf above
  const int ex = block_exclusive((int)f | (int)inf << 16, red);
  const int place_f = pre_f + (ex & 0xffff);
  const int place_inf = pre_inf + (ex >> 16);
  if (f) a.f_list[place_f] = k;
  else if (inf) a.node_rank[i] = all_f + place_inf;
  else if (in) a.node_rank[i] = all_f + all_inf + (i - place_f - place_inf);
  if (vb == 0 && tid == 0) {
    a.n_group[0] = all_f;
    a.n_group[1] = all_inf;
  }
}

// Step 2b, a persistent walk over the (1024 sources, 256 keys) tiles of
// the list: each source's rank is the count of listed keys below its
// own, the tile's keys staged in shared memory, added by atomics.
__device__ void phase_node_rank(const Args& a, int first, int stride,
                                unsigned char* smem) {
  uint64_t* const staged = reinterpret_cast<uint64_t*>(smem);
  const int tid = threadIdx.x;
  const int nf = a.n_group[0];
  const int tx = blocks_of(nf, THREADS), ty = blocks_of(nf, RANK_KEYS);
  for (int vb = first; vb < tx * ty; vb += stride) {
    const int j0 = vb / tx * RANK_KEYS, jn = min(RANK_KEYS, nf - j0);
    __syncthreads();  // the previous tile's keys are read
    for (int j = tid; j < jn; j += THREADS) staged[j] = a.f_list[j0 + j];
    __syncthreads();
    const int f = vb % tx * THREADS + tid;
    if (f >= nf) continue;
    const uint64_t k = a.f_list[f];
    int below = 0;
#pragma unroll 8
    for (int j = 0; j < jn; ++j) below += staged[j] < k;
    if (below) atomicAdd(&a.node_rank[(uint32_t)k], below);
  }
}

// Step 3a: each pod's bucket, active flag and key; the bucket counted.
__device__ void phase_pods(const Args& a, int vb) {
  const int p = vb * THREADS + (int)threadIdx.x;
  if (p >= a.P) return;
  const int raw = a.pod_node[p];
  const bool on = raw >= 0;
  const int pn = min(max(raw, 0), a.N - 1);
  const int bucket = on ? a.node_rank[pn] : a.N;
  float w = 0.0f;
  for (int d = 0; d < a.RD; ++d)
    w = __fmaf_rn(a.pod_usage_r[(size_t)p * a.RD + d], a.weights[d], w);
  a.active[p] = a.pod_eligible[p] && on && a.source[pn];
  a.pod_key[p] = (uint64_t)lnl::sort_bits(-w) << 32 | (uint32_t)p;
  a.pod_bucket[p] = bucket;
  atomicAdd(&a.counts[bucket], 1);
}

// Step 3b, block vb: buckets [1024 vb, 1024 vb + 1024) of the N + 1
// get their first slots (and the cursors the pods take slots from):
// the counts before them summed, then their own scanned.
__device__ void phase_offsets(const Args& a, int vb) {
  __shared__ int red[THREADS / 32];
  const int tid = threadIdx.x, n = a.N + 1, b = vb * THREADS + tid;
  int before = 0;
  for (int u = tid; u < vb * THREADS; u += THREADS) before += a.counts[u];
  before = block_sum(before, red);
  const int x = b < n ? a.counts[b] : 0;
  const int slot = before + block_exclusive(x, red);
  if (b < n) {
    a.offsets[b] = slot;
    a.cursor[b] = slot;
  }
  // the end of the last bucket, whatever the count of blocks
  if (vb == 0 && tid == 0) a.offsets[n] = a.P;
}

// Step 3c: each pod takes a slot of its bucket.
__device__ void phase_scatter(const Args& a, int vb) {
  const int p = vb * THREADS + (int)threadIdx.x;
  if (p >= a.P) return;
  const int b = a.pod_bucket[p];
  const int slot = atomicAdd(&a.cursor[b], 1);
  a.slot_key[slot] = a.pod_key[p];
  a.slot_bucket[slot] = b;
}

// Step 3d: tile vb of the slots, sorted where it holds a slot of a
// bucket above SMALL_BUCKET (the only buckets the tiles order).
__device__ void phase_pod_tile(const Args& a, int vb, unsigned char* smem) {
  const int pos = vb * TILE + 2 * (int)threadIdx.x;
  bool big = false;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (pos + e < a.P) {
      const int b = a.slot_bucket[pos + e];
      big |= a.offsets[b + 1] - a.offsets[b] > SMALL_BUCKET;
    }
  }
  if (__syncthreads_or(big))
    phase_tile(a.slot_key, a.slot_bucket, a.P, vb, smem);
}

// Step 3e: each slot's pod goes to its place: its bucket's first slot
// plus the keys of its bucket below its own, counted where the bucket
// holds at most SMALL_BUCKET pods, else found by a binary search in
// each tile of the bucket (its own slot where the bucket lies inside
// its tile, which the tile sort ordered).
__device__ void phase_place(const Args& a, int vb) {
  const int pos = vb * THREADS + (int)threadIdx.x;
  if (pos >= a.P) return;
  const uint64_t k = a.slot_key[pos];
  const int b = a.slot_bucket[pos];
  const int bs = a.offsets[b], be = a.offsets[b + 1];
  const int ts = pos / TILE * TILE;
  int place = pos;
  if (be - bs <= SMALL_BUCKET) {
    place = bs;
    for (int q = bs; q < be; ++q) place += a.slot_key[q] < k;
  } else if (bs < ts || be > ts + TILE) {
    place = bs;
    for (int u = bs / TILE; u * TILE < be; ++u) {
      const int lo = max(bs, u * TILE);
      place += lower_bound(a.slot_key, lo, min(be, (u + 1) * TILE), k) - lo;
    }
  }
  a.order[place] = (int32_t)(uint32_t)k;
}

// --- the launch: the steps, grid barriers between ----------------------

__global__ void __launch_bounds__(THREADS) k11_coop(Args a) {
  __shared__ __align__(16) unsigned char smem[SMEM_BYTES];
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, B = blockIdx.x, node_blocks = a.node_blocks;
  if (a.deviation) {
    for (int vb = B; vb < node_blocks; vb += G) phase_nodes<false>(a, vb);
    grid.sync();
    if (B == 0) phase_deviation(a);
    grid.sync();
  }
  for (int vb = B; vb < node_blocks; vb += G) phase_nodes<true>(a, vb);
  grid.sync();
  for (int vb = B; vb <= node_blocks; vb += G) {
    if (vb < node_blocks) phase_node_list(a, vb);
    else phase_budget(a);
  }
  grid.sync();
  phase_node_rank(a, B, G, smem);
  if (a.P == 0) return;
  grid.sync();
  const int pod_blocks = blocks_of(a.P, THREADS);
  for (int vb = B; vb < pod_blocks; vb += G) phase_pods(a, vb);
  grid.sync();
  for (int vb = B; vb < blocks_of(a.N + 1, THREADS); vb += G)
    phase_offsets(a, vb);
  grid.sync();
  for (int vb = B; vb < pod_blocks; vb += G) phase_scatter(a, vb);
  grid.sync();
  for (int vb = B; vb < blocks_of(a.P, TILE); vb += G)
    phase_pod_tile(a, vb, smem);
  grid.sync();
  for (int vb = B; vb < pod_blocks; vb += G) phase_place(a, vb);
}

// The scratch layout of (N, P, Rd), carved from `base` (null: sizes
// only); returns the bytes.
size_t carve(Args* a, char* base, int N, int P, int RD) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += (bytes + 15) / 16 * 16;
    return p;
  };
  const int W0 = N > lnl::TREE_BASE ? (N + lnl::TREE_BASE - 1) /
                                          lnl::TREE_BASE : 0;
  a->W0 = W0;
  a->lo = W0 ? (W0 * lnl::TREE_BASE - N) / 2 : 0;
  a->term = (float*)take(sizeof(float) * (size_t)N * RD);
  a->part_dev = (float*)take(sizeof(float) * (size_t)RD * W0);
  a->part_bud = (float*)take(sizeof(float) * (size_t)RD * W0);
  a->ping = (float*)take(sizeof(float) * (W0 / lnl::TREE_BASE + 2));
  a->pong = (float*)take(sizeof(float) * (W0 / lnl::TREE_BASE + 2));
  a->thr = (float*)take(sizeof(float) * 2 * RD);
  a->source = (uint8_t*)take(N);
  a->node_key = (uint64_t*)take(sizeof(uint64_t) * (size_t)N);
  a->f_list = (uint64_t*)take(sizeof(uint64_t) * (size_t)N);
  a->node_blocks = max((W0 + WINDOWS - 1) / WINDOWS,
                       (N + 1 + THREADS - 1) / THREADS);
  a->blk_count = (int32_t*)take(sizeof(int32_t) * 2 * a->node_blocks);
  a->n_group = (int32_t*)take(sizeof(int32_t) * 2);
  a->node_rank = (int32_t*)take(sizeof(int32_t) * (size_t)N);
  a->counts = (int32_t*)take(sizeof(int32_t) * ((size_t)N + 1));
  a->offsets = (int32_t*)take(sizeof(int32_t) * ((size_t)N + 2));
  a->cursor = (int32_t*)take(sizeof(int32_t) * ((size_t)N + 1));
  a->pod_key = (uint64_t*)take(sizeof(uint64_t) * (size_t)P);
  a->pod_bucket = (int32_t*)take(sizeof(int32_t) * (size_t)P);
  a->slot_key = (uint64_t*)take(sizeof(uint64_t) * (size_t)P);
  a->slot_bucket = (int32_t*)take(sizeof(int32_t) * (size_t)P);
  return off;
}

bool shape_ok(int N, int P, int RD) {
  return N >= 1 && N < 0x7fffffff - 1 && P >= 0 && RD >= 1 &&
         RD <= lnl::MAX_RD;
}

}  // namespace

// Bytes of scratch a launch of (N, P, Rd) needs; -1 where the shape is
// outside the kernel's limits.
extern "C" long long koord_lnl_eviction_order_scratch(int N, int P, int RD) {
  if (!shape_ok(N, P, RD)) return -1;
  Args a = {};
  return (long long)carve(&a, nullptr, N, P, RD);
}

// ptr: the 17 inputs and outputs (Args' order), then the scratch of
// koord_lnl_eviction_order_scratch bytes. dims: N, P, Rd, deviation.
extern "C" int koord_lnl_eviction_order(const void* const* ptr,
                                        const int* dims, void* stream) {
  Args a = {};
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
  if (!shape_ok(a.N, a.P, a.RD)) return (int)cudaErrorInvalidValue;
  carve(&a, (char*)ptr[17], a.N, a.P, a.RD);
  // the current card's SMs and the blocks of k11_coop an SM holds, kept
  // a card (the launch goes to the current card)
  constexpr int MAX_CARDS = 64;
  static int sms_of[MAX_CARDS], per_sm_of[MAX_CARDS];
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < MAX_CARDS && sms_of[dev]) {
    sms = sms_of[dev];
    per_sm = per_sm_of[dev];
  } else {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k11_coop,
                                                        THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    if (dev < MAX_CARDS) {
      per_sm_of[dev] = per_sm;
      sms_of[dev] = sms;
    }
  }
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // the rank step's tiles, at most two blocks an SM of them: the grid
  // needs no more blocks than its widest step
  const long long tiles = (long long)((a.N + THREADS - 1) / THREADS) *
                          ((a.N + RANK_KEYS - 1) / RANK_KEYS);
  const int rank_blocks = (int)(tiles < 2 * sms ? tiles : 2 * sms);
  const int need = max(max(a.node_blocks + 1, rank_blocks),
                       (a.P + THREADS - 1) / THREADS);
  const int g = min(sms * per_sm, need);
  void* args[] = {(void*)&a};
  e = cudaLaunchCooperativeKernel((const void*)k11_coop, dim3(g),
                                  dim3(THREADS), args, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
