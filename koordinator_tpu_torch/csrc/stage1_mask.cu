// K9 stage1_mask: the cascade's stage-1 candidate mask of one batch, every
// (pod, node) pair in one pass.
//
// Replaces koordinator_tpu/scheduler/cascade.py:117 stage1_mask over
// ops/feasibility.py:44 resource_fit, :60 pod_ancestors and :72
// quota_ceiling_ok, applied to the static gates (cascade.py:75
// static_gates and the zero-instance device term), which XLA runs as
// broadcasts over [P, N, F] and [P, D, F]. It writes bool[P, N]: the
// pair passes the static gates (the factored terms kernel K1 takes:
// the pod's device term, the selector table over the node's label
// group, the LoadAware usage gate (node_ok or prod_node_ok, passed on
// a stale metric or by a DaemonSet pod), `schedulable`, and with
// tolerations the forbid table over (toleration set, taint group)),
// AND fl(req + requested) <= fl(alloc + eps) on each of the F checked
// dims (the batch-start fit, exactly K1's round fit), AND the pod's
// quota ceiling: fl(used + req) <= fl(runtime + eps) on each dim at
// each of the first `quota_depth` levels of its ancestor chain (a
// level without an ancestor passes). Table indices follow the
// reference's rule (K1's: a negative selector id matches all, a
// negative label or taint group counts from the table's end, indices
// out of range clamp to its last row or column).
//
// What bounds it on the H100: bytes, 20 MB written a full-gate chunk
// (P = 2000, N = 10^4), 6 us at 3.35 TB/s; close behind them the issue
// rate, since each of the 2 * 10^7 pairs costs F adds and compares; and
// each block's prologue, a memory round trip and two barriers before
// its first pair. So:
//
// - A block owns 512 nodes and 64 pods (128 threads, 4 adjacent nodes a
//   thread): on a full-gate chunk a pod's terms are computed 20 times
//   and a node's columns read 32 times (40 and 125 with the blocks of
//   256 nodes and 16 pods before).
// - One round trip. Every load of the prologue is issued before its
//   first barrier: the node columns as vectors (requested and alloc as
//   float4, the label and taint groups as int4, the flag bytes as
//   words) and the pods' columns and ancestors. The small tables are
//   read through L1 (staging them into shared memory measured slower).
// - Warps side by side. Warps 0-1 compute 32 pods' terms each (the
//   device term, the quota ceiling, the usage class) while warps 2-3
//   build the gate words: everything but the fit
//   is a function of a pod's (selector row, toleration row, usage
//   class) and a node's (label group, taint group, usage bits), so per
//   32 pods a block holds one word a label group (bit i: pod i's
//   selector row passes it), one a taint group and one a node usage
//   class, built with lanes over the tables' columns and one table read
//   for each distinct row among the 32 pods (a row's pods are one
//   ballot). A node's gate for 32 pods is then three shared loads and
//   two ANDs. Where the tables are too wide for the words (more than
//   2048 label and taint groups together) a pair reads them instead.
// - The pairs. A thread holds its 4 nodes' requested and alloc + eps
//   (rounded once a node) and walks the block's pods, a pod's requests
//   one broadcast load. On the flagship's path (4 checked dims, the
//   words, N a multiple of 4) the walk over 32 pods is unrolled: the 4
//   nodes' gate bits of each pod are a nibble of 4 registers, and the 4
//   verdicts go out as one 4-byte store (bits to bytes by one multiply),
//   so a warp writes 128 contiguous bytes of a pod row. Otherwise the
//   walk is a loop, and a row that does not start 4-byte aligned is
//   written a byte at a time.
// Two builds: exactly 4 checked dims (the flagship's), and any F <= 11.
//
// Exactness: the file builds with -fmad=false and names its roundings;
// alloc + eps is rounded once a node and compared with the rounded sum
// of each pair, as the reference's broadcast does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // warps 0-1 the pods' terms, 2-3 the words
constexpr int NPT = 4;                 // nodes a thread
constexpr int TILE_N = THREADS * NPT;  // nodes a block
constexpr int GROUPS = 2;              // words of 32 pods a block
constexpr int PODS = 32 * GROUPS;      // pods a block
static_assert(THREADS == 64 * GROUPS, "a warp a pod group, twice");
constexpr int MAX_F = 11;
constexpr int MAX_WORDS = 2048;  // label + taint groups held as words
constexpr int PRE_D = 8;  // quota levels whose ancestors load up front

struct Args {
  // per pod [P]
  const int32_t* selector_id;
  const uint8_t* prod_gate;
  const uint8_t* daemonset;
  const uint8_t* device_ok;
  const int32_t* toleration_id;  // null without tolerations
  const float* req;              // [P, F]
  const int32_t* pod_anc;        // [P, D]
  // per node [N]
  const int32_t* label_group;
  const uint8_t* node_ok;
  const uint8_t* prod_node_ok;
  const uint8_t* fresh;
  const uint8_t* schedulable;
  const int32_t* taint_group;    // null without tolerations
  const float* requested;        // [N, F]
  const float* alloc;            // [N, F]
  // tables
  const uint8_t* selector_match;  // [S, L]
  const uint8_t* tol_forbid;      // [T, G] or null
  const float* quota_used;        // [Q, F]
  const float* quota_runtime;     // [Q, F]
  uint8_t* out;                   // [P, N]
  int P, N, F, S, L, T, G, D, quota_depth, Q;
  float eps;
};

// A table column by the reference's rule: negative counts from the end,
// out of range clamps to the last.
__device__ __forceinline__ int column(int c, int n) {
  return min(max(c < 0 ? c + n : c, 0), max(n - 1, 0));
}

// A node's usage bits: 4 schedulable, 1 and 2 the usage gate of an
// ordinary and of a prod pod (passed on a stale metric), each with
// `schedulable`. A pod's class is 4 (DaemonSet), 2 (prod) or 1, 0 when
// its device term or quota ceiling kills it: the pair passes these
// gates where the two share a bit.
__device__ __forceinline__ uint32_t node_bits(uint8_t sched, uint8_t fresh,
                                              uint8_t ok, uint8_t prod_ok) {
  const bool stale = fresh == 0;
  return sched ? 4u | ((stale || ok) ? 1u : 0u) | ((stale || prod_ok) ? 2u : 0u)
               : 0u;
}

// Bits 0-7 of x spread to bits 0, 4, ..., 28.
__device__ __forceinline__ uint32_t spread8(uint32_t x) {
  x &= 0xFFu;
  x = (x | (x << 12)) & 0x000F000Fu;
  x = (x | (x << 6)) & 0x03030303u;
  return (x | (x << 3)) & 0x11111111u;
}

// A pod's selector row: -1 matches all, -2 (an empty table) none.
__device__ __forceinline__ int selector_row(int s, int S) {
  return s < 0 ? -1 : (S > 0 ? min(s, S - 1) : -2);
}

// FK: 4 for exactly four checked dims (the flagship's), unrolled with no
// dim tests; 0 for any F <= MAX_F
template <int FK, bool WORDS>
__global__ void __launch_bounds__(THREADS, 5)
    stage1_mask_kernel(const Args a) {
  constexpr int FMAX = FK ? FK : MAX_F;
  extern __shared__ uint32_t s_words[];  // [GROUPS][L], then [GROUPS][Gt]
  __shared__ __align__(16) float s_req[PODS][FMAX];
  __shared__ int s_sel[PODS];      // selector row (the L1 path)
  __shared__ int s_tol[PODS];      // toleration row (the L1 path)
  __shared__ uint8_t s_cls[PODS];  // usage class, 0 = dead
  __shared__ uint32_t s_usew[GROUPS][8];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n0 = blockIdx.x * TILE_N + t * NPT;
  const int p0 = blockIdx.y * PODS;
  const int F = FK ? FK : a.F, L = a.L, N = a.N;
  const bool taints = a.tol_forbid != nullptr;
  const int Gt = taints ? a.G : 1;
  uint32_t* s_selw = s_words;               // [GROUPS][L]
  uint32_t* s_tolw = s_words + GROUPS * L;  // [GROUPS][Gt]

  // 1. every load of the prologue at once: the node columns (4 adjacent
  // nodes a thread), the tables that fit staged into shared memory, and
  // the pods' columns (warps 0-1 the pods' own, warps 2-3 their table
  // rows); one barrier waits for them all
  float rq[NPT][FMAX], al[NPT][FMAX];
  int label[NPT], tg[NPT];
  uint32_t nb[NPT];
  const bool whole = n0 + NPT <= N;  // all 4 nodes in range
  if (whole && F == FMAX && FMAX % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(a.requested) |
        reinterpret_cast<uintptr_t>(a.alloc)) & 15u) == 0) {
    const float4* q4 = reinterpret_cast<const float4*>(a.requested) +
                       (size_t)n0 * FMAX / 4;
    const float4* c4 = reinterpret_cast<const float4*>(a.alloc) +
                       (size_t)n0 * FMAX / 4;
#pragma unroll
    for (int v = 0; v < NPT * FMAX / 4; ++v) {
      const float4 q = q4[v], c = c4[v];
      const float qs[4] = {q.x, q.y, q.z, q.w}, cs[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        rq[(4 * v + e) / FMAX][(4 * v + e) % FMAX] = qs[e];
        al[(4 * v + e) / FMAX][(4 * v + e) % FMAX] = cs[e];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int n = n0 + j;
#pragma unroll
      for (int f = 0; f < FMAX; ++f) {
        const bool use = n < N && f < F;
        rq[j][f] = use ? a.requested[(size_t)n * F + f] : 0.0f;
        al[j][f] = use ? a.alloc[(size_t)n * F + f] : 0.0f;
      }
    }
  }
  // the flag bytes of the 4 nodes as words (byte j: node j), turned into
  // usage bits after the barrier
  uint32_t sched4 = 0u, fresh4 = 0u, ok4 = 0u, prod4 = 0u;
  if (whole && ((reinterpret_cast<uintptr_t>(a.label_group) |
                 reinterpret_cast<uintptr_t>(a.taint_group)) & 15u) == 0 &&
      ((reinterpret_cast<uintptr_t>(a.schedulable) |
        reinterpret_cast<uintptr_t>(a.fresh) |
        reinterpret_cast<uintptr_t>(a.node_ok) |
        reinterpret_cast<uintptr_t>(a.prod_node_ok)) & 3u) == 0) {
    const int4 lg = *reinterpret_cast<const int4*>(a.label_group + n0);
    const int4 tgv = taints ? *reinterpret_cast<const int4*>(a.taint_group + n0)
                            : make_int4(0, 0, 0, 0);
    sched4 = *reinterpret_cast<const uint32_t*>(a.schedulable + n0);
    fresh4 = *reinterpret_cast<const uint32_t*>(a.fresh + n0);
    ok4 = *reinterpret_cast<const uint32_t*>(a.node_ok + n0);
    prod4 = *reinterpret_cast<const uint32_t*>(a.prod_node_ok + n0);
    label[0] = lg.x; label[1] = lg.y; label[2] = lg.z; label[3] = lg.w;
    tg[0] = tgv.x; tg[1] = tgv.y; tg[2] = tgv.z; tg[3] = tgv.w;
  } else {
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int n = n0 + j;
      const bool in = n < N;
      label[j] = in ? a.label_group[n] : 0;
      tg[j] = in && taints ? a.taint_group[n] : 0;
      if (in) {
        sched4 |= (uint32_t)a.schedulable[n] << (8 * j);
        fresh4 |= (uint32_t)a.fresh[n] << (8 * j);
        ok4 |= (uint32_t)a.node_ok[n] << (8 * j);
        prod4 |= (uint32_t)a.prod_node_ok[n] << (8 * j);
      }
    }
  }
  // warps 0-1: a pod a lane; warps 2-3: the rows of pod group warp - 2
  const int gi = warp & 1, i = gi * 32 + lane, p = p0 + i;
  const bool pod_warp = warp < GROUPS;
  const int pc = min(p, a.P - 1);
  float r[FMAX] = {};
  int anc[PRE_D] = {};
  bool alive = false, ds = false, prod = false;
  if (pod_warp) {
#pragma unroll
    for (int f = 0; f < FMAX; ++f)
      r[f] = p < a.P && f < F ? a.req[(size_t)p * F + f] : 0.0f;
    if (p < a.P) {
      alive = a.device_ok[p] != 0;
      ds = a.daemonset[p] != 0;
      prod = a.prod_gate[p] != 0;
#pragma unroll
      for (int k = 0; k < PRE_D; ++k)
        anc[k] = k < a.quota_depth ? a.pod_anc[(size_t)p * a.D + k] : -1;
    }
  }
  const int sel_id = a.selector_id[pc];
  const int tol_id = taints ? a.toleration_id[pc] : 0;
  __syncthreads();

  // 2. the pods' terms (warps 0-1) beside the gate words (warps 2-3)
  const int sel = selector_row(sel_id, a.S);
  const int tol = taints ? min(max(tol_id, 0), max(a.T - 1, 0)) : 0;
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
#pragma unroll
    for (int f = 0; f < FMAX; ++f) al[j][f] = __fadd_rn(al[j][f], a.eps);
    nb[j] = n0 + j < N ? node_bits((sched4 >> (8 * j)) & 0xFFu,
                                   (fresh4 >> (8 * j)) & 0xFFu,
                                   (ok4 >> (8 * j)) & 0xFFu,
                                   (prod4 >> (8 * j)) & 0xFFu)
                       : 0u;
    label[j] = column(label[j], L);
    tg[j] = taints ? column(tg[j], a.G) : 0;
  }
  if (pod_warp) {
    const int depth = p < a.P ? a.quota_depth : 0;
    // one quota level: fl(used + req) <= fl(runtime + eps) on each dim
    auto level = [&](int ad) {
      if (ad < 0) return;
      const int q = min(ad, a.Q - 1);
#pragma unroll
      for (int f = 0; f < FMAX; ++f)
        if (f < F)
          alive &= __fadd_rn(a.quota_used[(size_t)q * F + f], r[f]) <=
                   __fadd_rn(a.quota_runtime[(size_t)q * F + f], a.eps);
    };
#pragma unroll
    for (int d = 0; d < PRE_D; ++d)
      if (d < depth) level(anc[d]);
    for (int d = PRE_D; d < depth; ++d) level(a.pod_anc[(size_t)p * a.D + d]);
    const uint32_t cls = !alive ? 0u : ds ? 4u : prod ? 2u : 1u;
#pragma unroll
    for (int f = 0; f < FMAX; ++f) s_req[i][f] = r[f];
    s_cls[i] = (uint8_t)cls;
    s_sel[i] = sel;
    s_tol[i] = tol;
    if (WORDS) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint32_t w = __ballot_sync(~0u, (cls & c) != 0u);
        if (lane == 0) s_usew[gi][c] = w;
      }
    }
  } else if (WORDS) {
    // the group's selector and taint words, lanes over the tables'
    // columns, 32 pods a word: a row's pods are one ballot, so a word
    // takes one table read for each distinct row among the 32 pods
    const uint8_t* stab = a.selector_match;
    const uint8_t* ttab = a.tol_forbid;
    const uint32_t all = __ballot_sync(~0u, sel == -1);
    const uint32_t rowed = __ballot_sync(~0u, sel >= 0);
    for (int c = lane; c < ((L + 31) & ~31); c += 32) {
      uint32_t w = all;
      for (uint32_t rest = rowed; rest;) {
        const int s = __shfl_sync(~0u, sel, __ffs((int)rest) - 1);
        const uint32_t m = __ballot_sync(~0u, sel == s);
        if (c < L && stab[(size_t)s * L + c]) w |= m;
        rest &= ~m;
      }
      if (c < L) s_selw[gi * L + c] = w;
    }
    for (int c = lane; c < ((Gt + 31) & ~31); c += 32) {
      uint32_t w = ~0u;
      if (taints) {
        w = 0u;
        for (uint32_t rest = ~0u; rest;) {
          const int s = __shfl_sync(~0u, tol, __ffs((int)rest) - 1);
          const uint32_t m = __ballot_sync(~0u, tol == s);
          if (c < Gt && ttab[(size_t)s * Gt + c] == 0) w |= m;
          rest &= ~m;
        }
      }
      if (c < Gt) s_tolw[gi * Gt + c] = w;
    }
  }
  __syncthreads();
  if (n0 >= N) return;

  // 3. the pairs: a pod at a time, its 4 nodes' verdicts one store
  const uint8_t* stab = a.selector_match;
  const uint8_t* ttab = a.tol_forbid;
  // one pod's 4 verdicts as bits (bit j: node j), `gate` its gate bits
  // (the words' path) or 0xF (the tables read a pair at a time)
  auto verdicts = [&](int pi, uint32_t gate) {
    float rk[FMAX];
#pragma unroll
    for (int f = 0; f < FMAX; ++f) rk[f] = s_req[pi][f];
    int sk = 0, tk = 0;
    uint32_t ck = 0u;
    if (!WORDS) {
      sk = s_sel[pi];
      tk = s_tol[pi];
      ck = s_cls[pi];
    }
    uint32_t bits = 0u;
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      bool ok = true;
      if (!WORDS)
        ok = (nb[j] & ck) != 0u &&
             (sk == -1 || (sk >= 0 && stab[(size_t)sk * L + label[j]])) &&
             (!taints || ttab[(size_t)tk * Gt + tg[j]] == 0);
#pragma unroll
      for (int f = 0; f < FMAX; ++f)
        if (f < F) ok &= __fadd_rn(rk[f], rq[j][f]) <= al[j][f];
      bits |= (uint32_t)ok << j;
    }
    return bits & gate;
  };
  const bool vec =
      (N & 3) == 0 && (reinterpret_cast<uintptr_t>(a.out) & 3u) == 0;
#pragma unroll 1
  for (int g2 = 0; g2 < GROUPS; ++g2) {
    const int pg = p0 + g2 * 32;
    if (pg >= a.P) break;
    const int np = min(32, a.P - pg);
    uint32_t gw[NPT];
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      gw[j] = WORDS ? s_selw[g2 * L + label[j]] & s_tolw[g2 * Gt + tg[j]] &
                          s_usew[g2][nb[j]]
                    : ~0u;
    uint8_t* row = a.out + (size_t)pg * N + n0;
    bool unrolled = false;
    if constexpr (FK == 4 && WORDS) {
     unrolled = vec && np == 32;
     if (unrolled) {
      // the flagship's path, unrolled: the gate bits as a nibble a pod
      // (nib[c] holds pods 8c to 8c + 7, bit j of a nibble node j), four
      // bits to four bytes of 0 or 1 by one multiply
      uint32_t nib[4] = {};
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int j = 0; j < NPT; ++j) nib[c] |= spread8(gw[j] >> (8 * c)) << j;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const uint32_t bits =
            verdicts(g2 * 32 + k, (nib[k >> 3] >> (4 * (k & 7))) & 0xFu);
        *reinterpret_cast<uint32_t*>(row) = (bits * 0x00204081u) & 0x01010101u;
        row += N;
      }
     }
    }
    if (!unrolled) {
#pragma unroll 1
      for (int k = 0; k < np; ++k) {
        uint32_t gate = 0u;
#pragma unroll
        for (int j = 0; j < NPT; ++j) gate |= ((gw[j] >> k) & 1u) << j;
        const uint32_t bits = verdicts(g2 * 32 + k, gate);
        if (vec) {
          *reinterpret_cast<uint32_t*>(row) =
              (bits * 0x00204081u) & 0x01010101u;
        } else {
#pragma unroll
          for (int j = 0; j < NPT; ++j)
            if (n0 + j < N) row[j] = (bits >> j) & 1u;
        }
        row += N;
      }
    }
  }
}

template <int FK, bool WORDS>
int launch(const Args& a, size_t smem, cudaStream_t stream) {
  const dim3 grid((a.N + TILE_N - 1) / TILE_N, (a.P + PODS - 1) / PODS);
  stage1_mask_kernel<FK, WORDS><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ptr: selector_id, prod_gate, daemonset, device_ok, toleration_id (or
// null), req [P, F], pod_anc [P, D], label_group, node_ok, prod_node_ok,
// metric_fresh, schedulable, taint_group (or null), requested [N, F],
// alloc [N, F], selector_match [S, L], tol_forbid [T, G] (or null;
// with toleration_id and taint_group), quota_used [Q, F], quota_runtime
// [Q, F], out [P, N]. dims: P, N, F, S, L, T, G, D, quota_depth, Q.
// eps: the gate tolerance.
extern "C" int koord_stage1_mask(const void* const* ptr, const int* dims,
                                 float eps, void* stream) {
  Args a;
  a.selector_id = (const int32_t*)ptr[0];
  a.prod_gate = (const uint8_t*)ptr[1];
  a.daemonset = (const uint8_t*)ptr[2];
  a.device_ok = (const uint8_t*)ptr[3];
  a.toleration_id = (const int32_t*)ptr[4];
  a.req = (const float*)ptr[5];
  a.pod_anc = (const int32_t*)ptr[6];
  a.label_group = (const int32_t*)ptr[7];
  a.node_ok = (const uint8_t*)ptr[8];
  a.prod_node_ok = (const uint8_t*)ptr[9];
  a.fresh = (const uint8_t*)ptr[10];
  a.schedulable = (const uint8_t*)ptr[11];
  a.taint_group = (const int32_t*)ptr[12];
  a.requested = (const float*)ptr[13];
  a.alloc = (const float*)ptr[14];
  a.selector_match = (const uint8_t*)ptr[15];
  a.tol_forbid = (const uint8_t*)ptr[16];
  a.quota_used = (const float*)ptr[17];
  a.quota_runtime = (const float*)ptr[18];
  a.out = (uint8_t*)ptr[19];
  a.P = dims[0];
  a.N = dims[1];
  a.F = dims[2];
  a.S = dims[3];
  a.L = dims[4];
  a.T = dims[5];
  a.G = dims[6];
  a.D = dims[7];
  a.quota_depth = dims[8];
  a.Q = dims[9];
  a.eps = eps;
  if (a.P <= 0 || a.N <= 0) return 0;
  const bool taints = a.tol_forbid != nullptr;
  if (a.F < 0 || a.F > MAX_F || a.quota_depth < 0 || a.quota_depth > a.D ||
      (a.quota_depth > 0 && a.Q <= 0) || a.L <= 0 ||
      (taints && (a.T <= 0 || a.G <= 0 || a.toleration_id == nullptr ||
                  a.taint_group == nullptr)))
    return (int)cudaErrorInvalidValue;
  if ((a.P + PODS - 1) / PODS > 65535) return (int)cudaErrorInvalidValue;
  const int Gt = taints ? a.G : 1;
  const bool words = (long long)a.L + Gt <= MAX_WORDS;
  const size_t smem = words ? (size_t)GROUPS * (a.L + Gt) * 4 : 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.F == 4)
    return words ? launch<4, true>(a, smem, s) : launch<4, false>(a, smem, s);
  return words ? launch<0, true>(a, smem, s) : launch<0, false>(a, smem, s);
}
