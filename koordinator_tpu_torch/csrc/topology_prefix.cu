// K8 topology_prefix_gate: the in-step same-domain prefix gates of pod
// topology spread, inter-pod anti-affinity (both directions) and
// inter-pod affinity (the one-opener-a-group bootstrap), one launch a
// commit step.
//
// Replaces the in-step blocks of koordinator_tpu/scheduler/core.py
// schedule_batch (:776-884). There, per domain class, a [P, P]
// same-domain-and-earlier mask is multiplied into the [P, G] charge
// columns, and each gated pod compares its domain's carried count plus
// those earlier charges with its group's limit. Here each group column
// is one block (singleton classes, the port's full-width form), and the
// semantics are those of kernels/topology_prefix.py's docstring: per
// group g and trying pod p with a domain d = dom_x[g][choice[p]] >= 0,
//
//   occ = base + #{q trying, charging g, seg(q) == seg(p),
//                  rank[q] < rank[p]}
//
// with seg the domain (CAP, OCCUPY) or the whole group (OPENER, whose
// chargers and gated pods are the openers: carriers trying a domain
// that holds no member yet), base the domain's carried count (or the
// group's total for OPENER), and the pod failing on
// fl(occ + 1) > lim[g] (CAP) or occ >= 0.5 (OCCUPY, OPENER).
//
// What bounds it on the H100: neither bytes nor operations. A launch
// reads a few tens of KB (the step's choice, trying and rank, a domain
// and a count a pod and group) and does O(n) compares a gated pod, n
// the group's charging pods (a few dozen in a gpu_share chunk); its
// time is the launch, a block's few barriers and its dependent loads.
// So one launch does every group of every family, one block each, and
// the blocks merge their verdicts through a ticket.
//
// Design: grid = one block a group column (sum of the families' G),
// 512 threads, four pods a thread (2048 pods a tile). A block
// 1. computes for its pods the domain of the chosen column, whether
//    each charges and whether each is gated (an opener reads the
//    domain's count);
// 2. compacts the charging pods, with their ranks and segments, into
//    shared memory (a block scan of the per-thread counts);
//    for OPENER it also sums the group's counts (a block reduction);
// 3. for each gated pod, counts the compacted pods of its segment with
//    a smaller rank, adds the base and compares;
// 4. writes its column's failing pods as bits to scratch; the block
//    that takes the last ticket ORs every column's bits and writes
//    ok[p] = no column failed p, then resets the ticket.
// Above 2048 pods (a service batch or a config-4-sized chunk) the block
// walks the pods a tile of 2048 at a time: for each tile of gated pods
// it compacts each tile of charging pods in turn (steps 1-2) and adds
// their counts (step 3), then writes the gated tile's failures. A count
// of earlier charges is a sum of whole numbers, so adding it up tile by
// tile gives the same count; up to 2048 pods there is one tile of each,
// the steps above.
//
// Exactness: the charges are 0/1 and the counts whole numbers below
// 2^24, so every count and sum is exact in any order, and occ is the
// reference's fl(base + k) with k exact. The comparisons are the
// reference's.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int THREADS = 512;
constexpr int ITEMS = 4;
constexpr int MAX_P = THREADS * ITEMS;
constexpr int WORDS = MAX_P / 32;
constexpr int MAX_FAM = 4;
constexpr int MAX_G = 32;
constexpr int CAP = 0, OCCUPY = 1, OPENER = 2;

struct Family {
  const int32_t* dom;     // [G, X]
  const float* counts;    // [G, D]
  const int32_t* charge;  // [P] bit words
  const int32_t* gate;    // [P] bit words
  const float* lim;       // [G] (CAP) or null
  int G, D, kind;
};

struct Args {
  Family fam[MAX_FAM];
  int nfam;
  const int32_t* choice;  // [P]
  const uint8_t* trying;  // [P]
  const int32_t* rank;    // [P]
  uint32_t* rejected;     // [columns, words]
  int32_t* ticket;        // zero between launches
  uint8_t* out;           // [P]
  int P, X, columns, words;
};

__global__ void __launch_bounds__(THREADS)
    topology_prefix_kernel(const Args a) {
  using Scan = cub::BlockScan<int, THREADS>;
  using Reduce = cub::BlockReduce<float, THREADS>;
  __shared__ union {
    typename Scan::TempStorage scan;
    typename Reduce::TempStorage reduce;
  } tmp;
  __shared__ int s_seg[MAX_P];
  __shared__ int s_rank[MAX_P];
  __shared__ uint32_t s_rej[WORDS];
  __shared__ float s_total;
  __shared__ int s_last;

  const int t = threadIdx.x;
  // this block's family and group
  int f = 0, g = blockIdx.x;
  while (f + 1 < a.nfam && g >= a.fam[f].G) g -= a.fam[f++].G;
  const Family fm = a.fam[f];
  const int P = a.P, X = a.X;
  for (int w = t; w < WORDS; w += THREADS) s_rej[w] = 0u;

  // an opener group's total
  if (fm.kind == OPENER) {
    float part = 0.0f;
    for (int j = t; j < fm.D; j += THREADS)
      part += fm.counts[(size_t)g * fm.D + j];
    const float total = Reduce(tmp.reduce).Sum(part);
    if (t == 0) s_total = total;
    __syncthreads();  // the reduction's storage is reused below
  }

  // 1. a pod's segment, charge and gate (pod i: out of range or not
  // trying = neither)
  auto classify = [&](int i, int& seg, int& rk, bool& charge, bool& gated) {
    charge = gated = false;
    seg = -1;
    rk = 0;
    if (i < P && a.trying[i]) {
      const int c = min(max(a.choice[i], 0), X - 1);
      const int d = fm.dom[(size_t)g * X + c];
      if (d >= 0) {
        rk = a.rank[i];
        if (fm.kind == OPENER) {
          const bool open = ((fm.gate[i] >> g) & 1) &&
                            fm.counts[(size_t)g * fm.D + d] < 0.5f;
          charge = gated = open;
          seg = 0;
        } else {
          charge = (fm.charge[i] >> g) & 1;
          gated = (fm.gate[i] >> g) & 1;
          seg = d;
        }
      }
    }
  };

  for (int g0 = 0; g0 < P; g0 += MAX_P) {  // the gated pods' tiles
    int seg[ITEMS], rk[ITEMS], before[ITEMS];
    bool gated[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      bool ch;
      classify(g0 + t + k * THREADS, seg[k], rk[k], ch, gated[k]);
      before[k] = 0;
    }
    for (int c0 = 0; c0 < P; c0 += MAX_P) {  // the charging pods' tiles
      // 2. the tile's charging pods, compacted
      int cseg[ITEMS], crk[ITEMS], cnt = 0;
      bool charge[ITEMS];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        bool gt;
        classify(c0 + t + k * THREADS, cseg[k], crk[k], charge[k], gt);
        cnt += charge[k];
      }
      int off, n;
      Scan(tmp.scan).ExclusiveSum(cnt, off, n);
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        if (charge[k]) {
          s_seg[off] = cseg[k];
          s_rank[off] = crk[k];
          ++off;
        }
      }
      __syncthreads();
      // 3. each gated pod against the earlier charges of its segment
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        if (!gated[k]) continue;
        int b = 0;
        for (int j = 0; j < n; ++j)
          b += (s_seg[j] == seg[k]) & (s_rank[j] < rk[k]);
        before[k] += b;
      }
      __syncthreads();  // s_seg, s_rank and the scan's storage reused
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (!gated[k]) continue;
      const float base = fm.kind == OPENER
                             ? s_total
                             : fm.counts[(size_t)g * fm.D + seg[k]];
      const float occ = __fadd_rn(base, (float)before[k]);
      const bool fits = fm.kind == CAP ? __fadd_rn(occ, 1.0f) <= fm.lim[g]
                                       : occ < 0.5f;
      if (!fits) {
        const int i = t + k * THREADS;
        atomicOr(&s_rej[i >> 5], 1u << (i & 31));
      }
    }
    __syncthreads();
    // this tile's failures to scratch
    for (int w = t; w < WORDS && g0 / 32 + w < a.words; w += THREADS) {
      a.rejected[(size_t)blockIdx.x * a.words + g0 / 32 + w] = s_rej[w];
      s_rej[w] = 0u;
    }
    __syncthreads();
  }

  // 4. the last block merges every column's failures
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(a.ticket, 1) == a.columns - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = t; i < P; i += THREADS) {
    uint32_t bits = 0u;
    for (int c = 0; c < a.columns; ++c)
      bits |= __ldcg(a.rejected + (size_t)c * a.words + (i >> 5));
    a.out[i] = !((bits >> (i & 31)) & 1u);
  }
  if (t == 0) *a.ticket = 0;
}

}  // namespace

// ptr: per family (dom_x, counts, charge, gate, lim or null), then
// choice, trying, rank, rejected (columns * words int32 scratch),
// ticket, out. dims: P, X, nfam, then per family G, D, kind.
extern "C" int koord_topology_prefix_gate(const void* const* ptr,
                                          const int* dims, void* stream) {
  Args a = {};
  a.P = dims[0];
  a.X = dims[1];
  a.nfam = dims[2];
  if (a.P <= 0) return 0;
  if (a.X <= 0 || a.nfam <= 0 || a.nfam > MAX_FAM)
    return (int)cudaErrorInvalidValue;
  a.columns = 0;
  for (int f = 0; f < a.nfam; ++f) {
    Family& fm = a.fam[f];
    fm.dom = (const int32_t*)ptr[5 * f];
    fm.counts = (const float*)ptr[5 * f + 1];
    fm.charge = (const int32_t*)ptr[5 * f + 2];
    fm.gate = (const int32_t*)ptr[5 * f + 3];
    fm.lim = (const float*)ptr[5 * f + 4];
    fm.G = dims[3 + 3 * f];
    fm.D = dims[4 + 3 * f];
    fm.kind = dims[5 + 3 * f];
    if (fm.G <= 0 || fm.G > MAX_G || fm.D <= 0 || fm.kind < CAP ||
        fm.kind > OPENER || (fm.kind == CAP && fm.lim == nullptr))
      return (int)cudaErrorInvalidValue;
    a.columns += fm.G;
  }
  const int base = 5 * a.nfam;
  a.choice = (const int32_t*)ptr[base];
  a.trying = (const uint8_t*)ptr[base + 1];
  a.rank = (const int32_t*)ptr[base + 2];
  a.rejected = (uint32_t*)ptr[base + 3];
  a.ticket = (int32_t*)ptr[base + 4];
  a.out = (uint8_t*)ptr[base + 5];
  a.words = (a.P + 31) / 32;
  topology_prefix_kernel<<<a.columns, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
