// K1 score_topk: the static gates (in factored form), resource fit,
// LoadAware score, tie-break jitter, -1 mask and top-k of one commit
// round.
//
// Replaces the JAX device program of one round of
// koordinator_tpu/scheduler/core.py schedule_batch: the batch's static
// mask (scheduler/cascade.py static_gates, plugins/deviceshare.py
// prefilter), the resource fit (core.py:565-577), the quota/activity
// row mask (core.py:675-684), plugins/loadaware.py score_matrix (the
// floor'd weighted least-requested score, loadaware.py:161-219), the
// jitter, the -1 mask and lax.top_k (core.py:721-742). XLA materialises
// the [P, N] mask and score matrix in device memory and reduces them;
// this kernel writes neither.
//
// Inputs: the gates come as terms a pod (row mask, device term,
// selector row, DaemonSet, prod gate) and a node (schedulable, label
// group, LoadAware node_ok / prod_node_ok, metric freshness) and the
// selector table; a pair passes when every term does. The selector
// rows of a block's pods are staged in shared memory as bits over the
// label groups. An optional bool[P, N] pair mask carries gates that do
// not factor, and up to two f32[P, N] pair scores are added to the
// LoadAware score before the jitter, in the reference's order
// (core.py:693-699: the NUMA zone score from K4, then the DeviceShare
// pool score from K6, or the latter alone); all are null on the slim
// path.
//
// What bounds it on the H100: operations. A pair that passes the gates
// and the fit costs D + 1 correctly rounded divisions (__fdiv_rn, tens
// of instructions each) and the per-dim score arithmetic; the distinct
// bytes (per-pod and per-node columns, well under 1 MB) are nothing
// beside that. So the design scores as few pairs as it can.
//
// Design.
// - A block owns 16 pod rows and a split of the node axis. It counts
//   the active rows (row mask and device term) with a block scan and
//   takes the g-th group of 16 of them, so rows that are done or gated
//   off cost nothing; the blocks (enough to fill the card, at least one
//   a group) are spread over the groups, and each group's node axis is
//   split over its share of them (at least MIN_SPLIT nodes a split).
// - Node bound: a pod's value of a node is at most the node's value for
//   a pod that estimates zero, with the largest jitter (`score_bound`).
//   The block walks its split in tiles; for each node of a tile it
//   stages that bound once, for each gate class and usage term in use
//   (-inf where the class's gate fails), into shared memory, double
//   buffered, so one barrier a tile separates staging from filtering.
// - Filter: each warp keeps its rows' running top-k, sorted, in shared
//   memory, and each row's k-th entry as a threshold in registers.
//   Lane l takes node l of each 32-node chunk; a pair whose bound does
//   not beat its row's threshold (value descending, then index
//   ascending: lax.top_k's total order) is dropped with one shared load
//   and a compare. The others are queued, by ballot, in the row's
//   queue in shared memory; while a row's list is not full every pair
//   is queued (a -1 may still enter it).
// - Flush: at 32 queued pairs (and at the end of the split) each lane
//   takes one, loads its node's columns from device memory (L2 holds
//   them), evaluates the gates, the fit and the exact value, and the
//   warp merges the batch into the list: the entries that beat the
//   threshold are sorted across the lanes (a bitonic network), each
//   entry finds its rank in the other sorted sequence by a binary
//   search over shuffles, and the k best are written. No thread holds a
//   list in registers.
// - Split merge in the same launch: each (row group, split) writes its
//   partial top-k to scratch; the last block of a group to finish
//   (an atomic ticket, reset by that block for the next launch) merges
//   the other splits' lists into its own, in the same batches. The
//   top-k of a union is the top-k of the parts' top-ks, so this is
//   exact. Rows that are inactive score -1 on every node and are
//   written as (-1, 0..k-1), which is what the order gives them.
// - A pair score (the ADD instance): the value of a pair is
//   jit(fl(la + a)), la the LoadAware score (0 on a stale node), a the
//   pair's addend, jit(x) = fma(h, J, x) with tie-break (else x). The
//   staged bound U of the node is then kept without its jitter, and the
//   filter bounds the pair by jit_1023(fl(U + a)), reading a itself
//   (one coalesced load a lane and row). Proof that this bounds every
//   value: la <= U (score_bound; U = 0 = la on a stale node), so
//   la + a <= U + a and, rounding being monotone, fl(la + a) <=
//   fl(U + a); fma(h, J, x) rounds the exact h * J + x once and does
//   not decrease in x nor in h (J > 0, h <= 1023). Equal values keep
//   the index order by `better`, as for the slim rows. A gated-off
//   class stages -inf, and -inf + a stays -inf for a finite a. The
//   slim instance is unchanged.
// - Two pair scores (the ADD2 instance, the DeviceShare path with
//   NUMA): the value is jit(fl(fl(la + a1) + a2)), a1 K4's zone score
//   and a2 K6's pool score, added in that order as the reference adds
//   them. Pre-summing the addends is not the same: where a pod has
//   both (a NUMA-bound GPU pod), fl(fl(la + a1) + a2) and
//   fl(la + fl(a1 + a2)) can differ in the last bit. The filter bounds
//   the pair by jit_1023(fl(fl(U + a1) + a2)), reading both addends.
//   Proof that this bounds every value: la <= U as above, so
//   fl(la + a1) <= fl(U + a1) (rounding is monotone), and adding a2
//   and rounding again keeps the order: fl(fl(la + a1) + a2) <=
//   fl(fl(U + a1) + a2); the jitter does not decrease in its argument
//   nor in h. A gated-off class stages -inf, and -inf plus two finite
//   addends stays -inf. The slim and one-addend instances are
//   unchanged.
// - Addend rows (the cascade's stage 2, core.py:304-367): each addend
//   covers the batch's first R1 (R2) pod rows, the numa (gpu) prefix;
//   a row at or beyond them adds nothing, in the value and in the
//   bound. The reference concatenates zero rows there, and x + 0 is x
//   exactly (a -0.0 aside, which compares equal), so the values are
//   the reference's.
//
// - The taint term (the TAINT instances, a batch with tolerations): a
//   pod's toleration set t and a node's taint group g pick a forbid bit
//   and a penalty pen = tol_penalty[t][g] >= 0 from two tables over
//   (set, group); the block stages its rows' table rows in shared
//   memory (bits and floats over the groups, as the selector rows are
//   staged), and the tile stages each node's group beside its label
//   (one 16-bit word: label in the low 10 bits, group in the high 6).
//   A forbidden pair is gated off, like a selector miss. The value of a
//   pair becomes jit(max(fl(S - pen), 0)), S the LoadAware sum with its
//   0 to 2 addends added in order (the reference's core.py:693-704),
//   and the -1 mask comes after the floor (core.py:732). The filter
//   bounds the pair by jit_1023(max(fl(B - pen), 0)), B the pair's
//   bound without the penalty (U, or fl(U + a1), or fl(fl(U + a1) +
//   a2), as above), reading the pair's own penalty. Proof that this
//   bounds every value: S <= B (above), so S - pen <= B - pen and,
//   rounding being monotone, fl(S - pen) <= fl(B - pen); max(., 0) and
//   the jitter do not decrease in their argument. (pen >= 0 is not
//   even needed: the filter subtracts the pair's own pen.) A gated-off
//   class stages -inf, and the floor would lift -inf - pen to 0: the
//   filter keeps -inf there, so a gated pair stays out of the queue.
//   Without tolerations the instances are the ones above.
// - Reservation slots (V > 0): slot v is column N + v of the selection
//   (extended index order, so it ranks after every node of equal
//   value; the jitter hashes the extended index). Its value is
//   3 * MAX_NODE_SCORE + 1 = 301 plus jitter where slot_ok[p][v] (the
//   owner match and the static gates at the slot's host node, computed
//   on the host as bool[P, V]), the fit of the request against row
//   N + v of the fit tables (the slot's free and its carried use) and
//   not slot_block[v] (a taken AllocateOnce slot) hold, else -1; no
//   addend and no penalty. The last split of each row group scores its
//   rows' V slot columns exactly, 32 a batch, after its node tiles
//   (V is small: the full-gate workload has 64), and the split merge
//   takes them with the rest. No [P, N + V] tensor exists.
// - The pod topology term (the TOPO instances, a batch with spread,
//   anti-affinity or affinity groups; core.py:587-675 and :705-712).
//   The reference builds blocked[P, N + V] from four 0/1 matmuls over
//   the carried groups. Here a pod has one bit word a family (its
//   spread groups, its anti-affinity carried groups, its anti-affinity
//   matched groups, its affinity groups it cannot open, those it may
//   open) and a column the matching word of the groups that reject it
//   (scheduler/domains.py round_terms, over the slot-extended domain
//   map, so the slot columns are gated through their host node's
//   domain); a pair is blocked where a pod word ANDed with its column
//   word is non-zero: gated off, like a selector miss, on node and slot
//   columns alike. The matmul's sums are of 0s and 1s, so "> 0.5" is
//   "any bit". With a spread penalty map, a node pair's value becomes
//   jit(max(fl(S' - sp), 0)), S' the value before the jitter above (the
//   taint floor included) and sp the pod's carried spread groups'
//   entries of the map at the node, summed in ascending group order
//   from 0 (the reference's f32 matmul: with at most two non-zero terms
//   every order gives these bits); the floor applies to every row, sp
//   = 0 included. Slot columns keep 301 plus jitter. The filter bounds
//   a pair by jit_1023(max(fl(B' - sp), 0)), B' the pair's bound
//   without the spread term (as above), and a blocked pair by -inf.
//   Proof that this bounds every value: the gate only removes pairs;
//   S' <= B' (above), so S' - sp <= B' - sp and, rounding being
//   monotone, fl(S' - sp) <= fl(B' - sp) (sp >= 0 is not needed: the
//   filter subtracts the pair's own sp); max(., 0) and the jitter do
//   not decrease in their argument. A gated-off class stages -inf, and
//   the floor would lift -inf - sp to 0: the filter keeps -inf there.
//
// - Amplified CPU (core.py:383-404, :565-577; amp_ratio given): a
//   CPU-bind pod (amp_bind) must also fit its CPU request times the
//   node's ratio, fl(fl(req * ratio) + requested) <= fl(alloc + eps) on
//   the fit column of CPU, checked with the fit when a pair is scored.
//   It only removes pairs, so the node bounds stay bounds; slot columns
//   keep a ratio of 1, where the check is the fit's own.
//
// Exactness against the reference (bit for bit): the file builds with
// -fmad=false, and the arithmetic names its rounding. The floors sit on
// IEEE divisions (__fdiv_rn). The reference's compiler contracts the
// jitter score + h * f32(0.49/1024) into one fused multiply-add, and so
// does this kernel, by name (__fmaf_rn). The weighted sum of the
// per-dim scores takes the reference's form for the caller's score
// dims (scheduler/plugins/loadaware.py weighted_sum): with `fma_sum`
// an ascending __fmaf_rn chain (dims listed); without it, products
// rounded on their own (__fmul_rn) and summed over 8 lanes folded in
// halves (all dims: XLA:CPU's vectorised dot). The weights are summed
// in order. The jitter hash is uint32 arithmetic, as in the reference.
//
// Instances: up to 4 fit and score dims (the flagship's 4 and 2), 512
// threads a block, one row a warp, 2048-node tiles; and up to
// NUM_RESOURCES = 11 (the reference's defaults), 256 threads, two rows
// a warp, 256-node tiles. Both take 16 rows a block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cub/block/block_scan.cuh>

namespace {

constexpr int MAX_DIMS = 11;  // NUM_RESOURCES
constexpr int NARROW = 4;
constexpr int SUM_LANES = 8;
constexpr int RB = 16;               // pod rows a block
constexpr int MIN_SPLIT = 256;       // nodes a split, at least
constexpr int MAX_K = 32;
constexpr int QUEUE = 64;            // queue of pairs to score, a row
constexpr int MAX_LABELS = 1024;
constexpr int SEL_WORDS = MAX_LABELS / 32;
constexpr int MAX_TG = 64;             // taint groups (table columns)
constexpr int TG_WORDS = MAX_TG / 32;
constexpr int LABEL_BITS = 10;         // a staged word: label | group << 10
constexpr float SLOT_SCORE = 301.0f;   // 3 * MAX_NODE_SCORE + 1
constexpr int SENTINEL = 0x7fffffff - MAX_K;  // list padding: SENTINEL + j
constexpr float JITTER = (float)(0.49 / 1024.0);
constexpr unsigned FULL = 0xffffffffu;
// A pod's gate class: 0 DaemonSet (schedulable only), 1 LoadAware's
// usage gate, 2 its prod-usage gate; with either usage term, six
// staged bounds a node.
constexpr int GATES = 6;
constexpr int PROD_TERM_GATES = 0x2a;      // gate indices 1, 3, 5
constexpr int SELECTOR_USED = 1 << GATES;  // a pod of the block has one
constexpr int TOPO_FAM = 5;  // pod topology families (bit words)
constexpr int TOPO_SPREAD = 0;

// An instance: dims, threads a block and nodes a tile (rows a warp
// follow: RB rows a block).
template <int MAXD_, int THREADS_, int TILE_>
struct Config {
  static constexpr int MAXD = MAXD_;
  static constexpr int THREADS = THREADS_;
  static constexpr int TILE = TILE_;
  static constexpr int ROWS = RB / (THREADS_ / 32);
  static constexpr int NPT = TILE_ / THREADS_;  // nodes a thread stages
  static constexpr int MIN_BLOCKS = MAXD_ == NARROW ? 1 : 2;
};
using Narrow = Config<NARROW, 512, 2048>;
using Wide = Config<MAX_DIMS, 256, 256>;

struct Args {
  // per pod [P]
  const uint8_t* row_ok;
  const uint8_t* device_ok;
  const int32_t* selector_id;
  const uint8_t* prod_gate;
  const uint8_t* daemonset;
  const uint8_t* prod_scored;
  const float* req_fit;  // [P, F]
  const float* est;      // [P, D]
  // per node [N]
  const int32_t* label_group;
  const uint8_t* node_ok;
  const uint8_t* prod_node_ok;
  const uint8_t* fresh;
  const uint8_t* schedulable;
  const float* requested_fit;  // [N, F]
  const float* alloc_fit;      // [N, F]
  const float* node_term;      // [N, D]
  const float* prod_term;      // [N, D]
  const float* alloc_score;    // [N, D]
  const uint8_t* selector_match;  // [S, L]
  const uint8_t* pair_ok;         // [P, N] or null
  const float* pair_score;        // [R1, N] (the ADD instances) or null
  const float* pair_score2;       // [R2, N] (the ADD2 instance) or null
  const int32_t* toleration_id;   // [P] (the TAINT instances) or null
  const int32_t* taint_group;     // [N]
  const uint8_t* tol_forbid;      // [T, G]
  const float* tol_penalty;       // [T, G]
  const uint8_t* slot_ok;         // [P, V] or null (V = 0)
  const uint8_t* slot_block;      // [V]
  const int32_t* pod_words;       // [P, 5] (the TOPO instances) or null
  const int32_t* col_words;       // [5, N + V]
  const float* penalty;           // [SG, LDP] or null
  const uint8_t* amp_bind;        // [P] CPU-bind pods, or null
  const float* amp_ratio;         // [N] CPU amplification, or null
  const float* weights;           // [D]
  float* part_val;                // [gridDim.x, RB, k]
  int32_t* part_idx;
  int32_t* tickets;               // [gridDim.x], zero between launches
  float* out_val;                 // [P, k]
  int32_t* out_idx;
  int P, N, F, D, k, S, L, tie_break, fma_sum, V, T, G, SG, LDP;
  int R1, R2;  // the addends' rows: pod rows at or beyond add nothing
  int amp_col;  // the fit column of CPU (amp_ratio given)
  float eps;
};

__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// The block's running top-k lists (sorted, best first), one a row slot.
__shared__ float t_lv[RB][MAX_K];
__shared__ int t_li[RB][MAX_K];

// One pod row's running top-k, kept by a warp: its list is slot `slot`
// of the arrays above; the threshold (the list's last entry) lives in
// registers, equal in every lane.
struct RowTopK {
  int slot;
  float tv;
  int ti;
};

__device__ void topk_init(RowTopK& r, int k, int lane) {
  for (int j = lane; j < k; j += 32) {
    t_lv[r.slot][j] = -INFINITY;
    t_li[r.slot][j] = SENTINEL + j;
  }
  r.tv = -INFINITY;
  r.ti = SENTINEL + k - 1;
  __syncwarp();
}

// Merge a batch (one entry a lane, valid lanes only; called by the
// whole warp) into the row's list. The entries that beat the threshold
// are sorted across the lanes (a bitonic network; the others become
// distinct entries worse than any), each entry of either sorted
// sequence finds its rank in the other by a binary search over
// shuffles, and the entries whose merged position is below k are
// written there. Every entry is distinct (a node is offered once a
// row; padding indices are distinct), so the positions are a
// permutation.
__device__ void topk_add(RowTopK& r, int k, int lane, float v, int n,
                         bool valid) {
  const bool pass = valid && better(v, n, r.tv, r.ti);
  const unsigned m = __ballot_sync(FULL, pass);
  if (m == 0) return;
  const int c = __popc(m);
  float cv = pass ? v : -INFINITY;
  int ci = pass ? n : 0x7fffffff - lane;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float ov = __shfl_xor_sync(FULL, cv, stride);
      const int oi = __shfl_xor_sync(FULL, ci, stride);
      // descending runs keep the better entry in the lower lane
      const bool keep_better = ((lane & stride) == 0) == ((lane & size) == 0);
      if (better(ov, oi, cv, ci) == keep_better) {
        cv = ov;
        ci = oi;
      }
    }
  }
  float* lvs = t_lv[r.slot];
  int* lis = t_li[r.slot];
  const float lv = lane < k ? lvs[lane] : -INFINITY;
  const int li = lane < k ? lis[lane] : 0x7fffffff;
  // list entries better than this lane's batch entry, and batch entries
  // better than this lane's list entry
  int lo_c = 0, hi_c = k, lo_l = 0, hi_l = c;
#pragma unroll
  for (int step = 0; step < 6; ++step) {
    const int mid_c = (lo_c + hi_c) >> 1, mid_l = (lo_l + hi_l) >> 1;
    const float lmv = __shfl_sync(FULL, lv, mid_c & 31);
    const int lmi = __shfl_sync(FULL, li, mid_c & 31);
    const float cmv = __shfl_sync(FULL, cv, mid_l & 31);
    const int cmi = __shfl_sync(FULL, ci, mid_l & 31);
    if (lo_c < hi_c) {
      if (better(lmv, lmi, cv, ci)) lo_c = mid_c + 1; else hi_c = mid_c;
    }
    if (lo_l < hi_l) {
      if (better(cmv, cmi, lv, li)) lo_l = mid_l + 1; else hi_l = mid_l;
    }
  }
  __syncwarp();
  const int pos_l = lane + lo_l, pos_c = lane + lo_c;
  if (lane < k && pos_l < k) {
    lvs[pos_l] = lv;
    lis[pos_l] = li;
  }
  if (lane < c && pos_c < k) {
    lvs[pos_c] = cv;
    lis[pos_c] = ci;
  }
  __syncwarp();
  r.tv = lvs[k - 1];
  r.ti = lis[k - 1];
}

// Dynamic shared memory of a launch: per node of a tile, in two
// buffers, its bound for each gate class and usage term (GATES of
// them) and its label group.
size_t smem_bytes(int tile) {
  return (size_t)2 * tile * (GATES * sizeof(float) + sizeof(uint16_t));
}

// The floor'd weighted least-requested score over D dims, where dim d
// has capacity cap(d), usage term term(d) and pod estimate es(d). The
// arithmetic and its roundings are the reference's (see the note at
// the top of the file).
template <int MAXD, class Cap, class Term, class Est>
__device__ __forceinline__ float least_requested(Cap cap, Term term, Est es,
                                                 int D, const float* w,
                                                 float wsum, int fma_sum) {
  float acc = 0.0f;
  float lanes[SUM_LANES];
#pragma unroll
  for (int s = 0; s < SUM_LANES; ++s) lanes[s] = 0.0f;
#pragma unroll
  for (int d = 0; d < MAXD; ++d) {
    if (d < D) {
      const float c = cap(d);
      const float eu = __fadd_rn(es(d), term(d));
      float least = floorf(__fdiv_rn(__fmul_rn(__fsub_rn(c, eu), 100.0f),
                                     fmaxf(c, 1e-9f)));
      if (!(c > 0.0f && eu <= c)) least = 0.0f;
      if (fma_sum) {
        acc = __fmaf_rn(least, w[d], acc);
      } else {
        const float prod = __fmul_rn(least, w[d]);
        lanes[d % SUM_LANES] =
            d < SUM_LANES ? prod : __fadd_rn(lanes[d % SUM_LANES], prod);
      }
    }
  }
  if (!fma_sum) {
#pragma unroll
    for (int half = SUM_LANES / 2; half > 0; half >>= 1)
#pragma unroll
      for (int s = 0; s < half; ++s) lanes[s] = __fadd_rn(lanes[s], lanes[s + half]);
    acc = lanes[0];
  }
  return floorf(__fdiv_rn(acc, wsum));
}

// An upper bound of least_requested(cap, term, es, ...) over every
// estimate es >= 0, for weights >= 0. With es >= 0 the rounded
// estimated usage is >= term, and each later step (subtract, scale,
// divide by the capacity, floor, the weighted sum, divide by the
// weight sum, floor) is a rounding that does not decrease as its
// operand grows; so the score is at most its value at es = 0. That
// value is computed here with __fdividef, whose quotient is within 2
// ulp of the divided value (the rounded one within 2.5 ulp); the
// margins (2^-20 of the quotient, 2^-16 of the weighted quotient, which
// also covers the rounding of up to 11 weighted terms) lift the bound
// above every such error before each floor. The 2 ulp hold only for
// divisors below 2^126 (above, __fdividef returns 0), so a capacity or
// weight sum that large gives +inf, as does a NaN bound.
template <int MAXD, class Cap, class Term>
__device__ __forceinline__ float score_bound(Cap cap, Term term, int D,
                                             const float* w, float wsum) {
  float acc = 0.0f;
  bool huge = wsum >= 0x1p126f;
#pragma unroll
  for (int d = 0; d < MAXD; ++d) {
    if (d < D) {
      const float c = cap(d), t = term(d);
      huge = huge || c >= 0x1p126f;
      float u = 0.0f;
      if (c > 0.0f && t <= c) {
        const float q = __fdividef(__fmul_rn(__fsub_rn(c, t), 100.0f),
                                   fmaxf(c, 1e-9f));
        u = fmaxf(floorf(q + fabsf(q) * 0x1p-20f + 0x1p-20f), 0.0f);
      }
      acc = __fmaf_rn(u, w[d], acc);
    }
  }
  const float q = __fdividef(acc, wsum);
  const float s = floorf(q + fabsf(q) * 0x1p-16f + 0x1p-20f);
  return s == s && !huge ? s : INFINITY;
}

// The column of label (or taint) group `lab` in a table of L columns,
// by the reference's index rule: a negative index counts from the end,
// and an index out of range is clamped to it.
__device__ __forceinline__ int label_column(int lab, int L) {
  return min(max(lab < 0 ? lab + L : lab, 0), max(L - 1, 0));
}

// The row of toleration set `t` in tables of T rows: a negative one
// reads row 0, one out of range the last.
__device__ __forceinline__ int tol_row(int t, int T) {
  return min(max(t, 0), max(T - 1, 0));
}

// Whether a pod's topology words (pw) share a bit with column col's.
__device__ __forceinline__ bool topo_blocked(const Args& a, const uint32_t* pw,
                                             int col) {
  const size_t X = (size_t)a.N + a.V;
  uint32_t hit = 0u;
#pragma unroll
  for (int f = 0; f < TOPO_FAM; ++f)
    if (pw[f]) hit |= pw[f] & (uint32_t)a.col_words[f * X + col];
  return hit != 0u;
}

// A pod's spread penalty at node n: its spread groups' (bits of sw)
// entries of the penalty map, summed in ascending group order from 0.
__device__ __forceinline__ float spread_at(const Args& a, uint32_t sw, int n) {
  float sp = 0.0f;
  for (uint32_t m = sw; m; m &= m - 1u)
    sp = __fadd_rn(sp, a.penalty[(size_t)(__ffs(m) - 1) * a.LDP + n]);
  return sp;
}

// A pod's gate class and usage term, as an index of the staged bounds.
__device__ __forceinline__ int gate_of(const Args& a, int row) {
  const int cls = a.daemonset[row] ? 0 : (a.prod_gate[row] ? 2 : 1);
  return cls * 2 + (a.prod_scored[row] ? 1 : 0);
}

// Whether node n passes the static gates of a pod of gate index g, bar
// the node selector.
__device__ __forceinline__ bool node_gate(const Args& a, int n, int g) {
  const int cls = g >> 1;
  const bool stale = a.fresh[n] == 0;
  return a.schedulable[n] &&
         (cls == 0 || (cls == 1 ? a.node_ok[n] : a.prod_node_ok[n]) || stale);
}

template <class C, int ADD, bool TAINT, bool TOPO>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
    score_topk_kernel(const Args a) {
  constexpr int MAXD = C::MAXD, THREADS = C::THREADS, TILE = C::TILE;
  constexpr int ROWS = C::ROWS, NPT = C::NPT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = a.P, N = a.N, F = a.F, D = a.D, k = a.k;

  extern __shared__ float4 dyn[];
  // [2 buffers][GATES][TILE]: the node's bound where the pod's gate
  // class passes it, else -inf
  float* s_ub = reinterpret_cast<float*>(dyn);
  uint16_t* s_label = reinterpret_cast<uint16_t*>(s_ub + 2 * GATES * TILE);

  __shared__ int s_rows[RB];
  __shared__ unsigned s_sel[RB][SEL_WORDS];
  __shared__ float s_rq[RB][MAX_DIMS];
  __shared__ float s_es[RB][MAX_DIMS];
  __shared__ float s_w[MAX_DIMS];
  __shared__ int s_queue[RB][QUEUE];  // a row's pairs to score, by node
  __shared__ unsigned s_forbid[TAINT ? RB : 1][TG_WORDS];  // bits by group
  __shared__ float s_pen[TAINT ? RB : 1][MAX_TG];          // by group
  __shared__ typename cub::BlockScan<int, THREADS>::TempStorage scan_tmp;
  __shared__ int s_last, s_gates;

  // 1. inactive rows score -1 on every node: (-1, 0..k-1)
  const long long pk = (long long)P * k;
  for (long long e = (long long)blockIdx.x * THREADS + tid; e < pk;
       e += (long long)gridDim.x * THREADS) {
    const int r = (int)(e / k);
    if (!(a.row_ok[r] & a.device_ok[r])) {
      a.out_val[e] = -1.0f;
      a.out_idx[e] = (int)(e - (long long)r * k);
    }
  }

  // 2. this block's rows: the active rows of ranks [a0, a0 + RB). Each
  //    thread counts the active rows of its own run of rows, a block scan
  //    ranks the runs, and the threads whose run holds one of those ranks
  //    walk it again to find the rows
  const int per = (P + THREADS - 1) / THREADS;
  const int c0 = min(P, tid * per), c1 = min(P, c0 + per);
  int cnt = 0;
#pragma unroll 8
  for (int r = c0; r < c1; ++r) cnt += a.row_ok[r] & a.device_ok[r];
  int first, total;
  cub::BlockScan<int, THREADS>(scan_tmp).ExclusiveSum(cnt, first, total);
  const int groups = (total + RB - 1) / RB;
  const int splits = groups > 0
      ? max(1, min((int)gridDim.x / groups, max(1, N / MIN_SPLIT))) : 1;
  const int g = (int)blockIdx.x / splits;
  const int split = (int)blockIdx.x - g * splits;
  if (total == 0 || g >= groups) return;  // the whole block
  const int a0 = g * RB;
  if (tid < RB) s_rows[tid] = -1;
  if (tid == 0) s_gates = 0;
  __syncthreads();
  if (first < a0 + RB && first + cnt > a0)
    for (int r = c0, rank = first; r < c1 && rank < a0 + RB; ++r)
      if (a.row_ok[r] & a.device_ok[r]) {
        if (rank >= a0) s_rows[rank - a0] = r;
        ++rank;
      }
  __syncthreads();

  // per row: the selector row as bits over the label groups (all set
  // for "match all"), the fit request and the score estimate; the
  // weights
  const int words = max(1, (a.L + 31) >> 5);
  for (int e = tid; e < RB * words; e += THREADS) {
    const int slot = e / words, wd = e - slot * words;
    const int row = s_rows[slot];
    unsigned bits = 0;
    if (row >= 0) {
      const int sel = a.selector_id[row];
      if (sel < 0) {
        bits = FULL;
      } else if (a.S > 0) {
        const uint8_t* m = a.selector_match + (size_t)min(sel, a.S - 1) * a.L;
        for (int b = 0; b < 32 && wd * 32 + b < a.L; ++b)
          bits |= (unsigned)(m[wd * 32 + b] != 0) << b;
      }
    }
    s_sel[slot][wd] = bits;
  }
  for (int e = tid; e < RB * MAX_DIMS; e += THREADS) {
    const int slot = e / MAX_DIMS, d = e - slot * MAX_DIMS;
    const int row = s_rows[slot];
    s_rq[slot][d] = row >= 0 && d < F ? a.req_fit[(size_t)row * F + d] : 0.0f;
    s_es[slot][d] = row >= 0 && d < D ? a.est[(size_t)row * D + d] : 0.0f;
    if (row >= 0 && d == 0)  // the gate classes and terms in use
      atomicOr(&s_gates, (1 << gate_of(a, row))
                             | (a.selector_id[row] >= 0 ? SELECTOR_USED : 0));
  }
  if (tid < D) s_w[tid] = a.weights[tid];
  if (TAINT) {  // each row's toleration set: forbid bits and penalties
    for (int e = tid; e < RB * MAX_TG; e += THREADS) {
      const int slot = e / MAX_TG, grp = e - slot * MAX_TG;
      const int row = s_rows[slot];
      float pen = 0.0f;
      unsigned bits = 0;
      if (row >= 0 && grp < a.G) {
        const size_t o = (size_t)tol_row(a.toleration_id[row], a.T) * a.G;
        pen = a.tol_penalty[o + grp];
        if ((grp & 31) == 0)
          for (int b = 0; b < 32 && grp + b < a.G; ++b)
            bits |= (unsigned)(a.tol_forbid[o + grp + b] != 0) << b;
      }
      s_pen[slot][grp] = pen;
      if ((grp & 31) == 0) s_forbid[slot][grp >> 5] = bits;
    }
  }
  __syncthreads();
  float wsum = 0.0f;
  bool w_nonneg = true;
  for (int d = 0; d < D; ++d) {
    wsum = __fadd_rn(wsum, s_w[d]);
    w_nonneg = w_nonneg && s_w[d] >= 0.0f;
  }
  wsum = fmaxf(wsum, 1e-9f);
  const int gates_used = s_gates;

  // the warp's rows
  const int slot0 = warp * ROWS;
  int prow[ROWS];
  int gate_sel[ROWS];  // gate class * 2 + usage term
  int term_sel[ROWS];  // 0: node usage term, 1: prod term
  bool bounded[ROWS];  // the node's bound holds for this pod
  bool sel_all[ROWS];  // the pod has no node selector
  bool live[ROWS];     // the slot holds a row
  RowTopK tk[ROWS];
  int qh[ROWS], qt[ROWS];  // the row's queue: taken and added counts
  uint32_t pw[ROWS][TOPO ? TOPO_FAM : 1];  // the row's topology words
  uint32_t fams = 0u;  // the families with a bit in a row of the warp
  bool any = false, any_sel = false;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = s_rows[slot0 + i];
    const int rr = max(row, 0);
    prow[i] = row;
    any = any || row >= 0;
    gate_sel[i] = gate_of(a, rr);
    term_sel[i] = gate_sel[i] & 1;
    sel_all[i] = row < 0 || a.selector_id[rr] < 0;
    live[i] = row >= 0;
    any_sel = any_sel || !sel_all[i];
    bool nonneg = w_nonneg;
    for (int d = 0; d < D; ++d) nonneg = nonneg && s_es[slot0 + i][d] >= 0.0f;
    bounded[i] = nonneg;
    if (TOPO) {
#pragma unroll
      for (int f = 0; f < TOPO_FAM; ++f) {
        pw[i][f] = row >= 0 ? (uint32_t)a.pod_words[(size_t)rr * TOPO_FAM + f]
                            : 0u;
        if (pw[i][f]) fams |= 1u << f;
      }
    }
    tk[i] = RowTopK{slot0 + i, 0.0f, 0};
    qh[i] = qt[i] = 0;
    topk_init(tk[i], k, lane);
  }

  // Score the queued pairs of row r, 32 at a time (fewer at the end):
  // each lane takes one, reads its node's columns, evaluates the gates,
  // the pair mask, the fit and the value, and the warp merges the batch
  // into the row's list.
  auto flush = [&](int r) {
    __syncwarp();
    const int cnt = min(32, qt[r] - qh[r]);
    const bool has = lane < cnt;
    const int n = has ? s_queue[slot0 + r][(qh[r] + lane) & (QUEUE - 1)] : 0;
    qh[r] += cnt;
    const float* term = term_sel[r] ? a.prod_term : a.node_term;
    const bool fresh = a.fresh[n] != 0;
    bool ok = has && node_gate(a, n, gate_sel[r]);
    if (!sel_all[r]) {
      const int label = label_column(a.label_group[n], a.L);
      ok = ok && ((s_sel[slot0 + r][label >> 5] >> (label & 31)) & 1u);
    }
    int tg = 0;
    if (TAINT) {
      tg = label_column(a.taint_group[n], a.G);
      ok = ok && !((s_forbid[slot0 + r][tg >> 5] >> (tg & 31)) & 1u);
    }
    if (a.pair_ok != nullptr)
      ok = ok && a.pair_ok[(size_t)prow[r] * N + n];
    if (TOPO) ok = ok && !topo_blocked(a, pw[r], n);
    if (a.amp_ratio != nullptr && ok && a.amp_bind[prow[r]]) {
      const size_t c = (size_t)n * F + a.amp_col;
      ok = __fadd_rn(__fmul_rn(s_rq[slot0 + r][a.amp_col], a.amp_ratio[n]),
                     a.requested_fit[c])
           <= __fadd_rn(a.alloc_fit[c], a.eps);
    }
    const float* est = s_es[slot0 + r];
    const float* req = a.requested_fit + (size_t)n * F;
    const float* alloc = a.alloc_fit + (size_t)n * F;
    const float* cap = a.alloc_score + (size_t)n * D;
    const float* t = term + (size_t)n * D;
    float v = -1.0f;
    if (MAXD == NARROW) {
      // every column of the pair loaded at once
      float rq[MAXD], al[MAXD], cp[MAXD], tt[MAXD];
#pragma unroll
      for (int d = 0; d < MAXD; ++d) {
        if (d < F) {
          rq[d] = req[d];
          al[d] = alloc[d];
        }
        if (d < D) {
          cp[d] = cap[d];
          tt[d] = t[d];
        }
      }
#pragma unroll
      for (int f = 0; f < MAXD; ++f)
        if (f < F)
          ok = ok & (__fadd_rn(s_rq[slot0 + r][f], rq[f])
                     <= __fadd_rn(al[f], a.eps));
      if (ok)
        v = fresh ? least_requested<MAXD>([&](int d) { return cp[d]; },
                                          [&](int d) { return tt[d]; },
                                          [&](int d) { return est[d]; }, D,
                                          s_w, wsum, a.fma_sum)
                  : 0.0f;
    } else {
      // one fit dim at a time (the filter prefetched the lines into
      // L1), then the score columns: fewer registers
      for (int f = 0; f < F; ++f)
        ok = ok & (__fadd_rn(s_rq[slot0 + r][f], req[f])
                   <= __fadd_rn(alloc[f], a.eps));
      if (ok)
        v = fresh ? least_requested<MAXD>([&](int d) { return cap[d]; },
                                          [&](int d) { return t[d]; },
                                          [&](int d) { return est[d]; }, D,
                                          s_w, wsum, a.fma_sum)
                  : 0.0f;
    }
    if (ADD >= 1 && ok && prow[r] < a.R1)
      v = __fadd_rn(v, a.pair_score[(size_t)prow[r] * N + n]);
    if (ADD == 2 && ok && prow[r] < a.R2)
      v = __fadd_rn(v, a.pair_score2[(size_t)prow[r] * N + n]);
    if (TAINT && ok) v = fmaxf(__fsub_rn(v, s_pen[slot0 + r][tg]), 0.0f);
    if (TOPO && ok && a.penalty != nullptr)
      v = fmaxf(__fsub_rn(v, spread_at(a, pw[r][TOPO_SPREAD], n)), 0.0f);
    if (ok && a.tie_break) {
      const uint32_t h =
          ((uint32_t)prow[r] * 2654435761u + (uint32_t)n * 40503u) & 1023u;
      v = __fmaf_rn((float)h, JITTER, v);
    }
    topk_add(tk[r], k, lane, v, n, has);
  };

  // 3. the split's nodes, a tile at a time: each thread stages NPT
  //    nodes of the tile (the node's bound for each gate class and
  //    usage term in use, -inf where the class's gate fails; the label
  //    if a pod has a selector) into one of two buffers, so one barrier
  //    a tile separates staging from filtering
  const int n_lo = (int)((long long)N * split / splits);
  const int n_hi = (int)((long long)N * (split + 1) / splits);
  const unsigned lower = (1u << lane) - 1u;
  const bool any_prod = (gates_used & PROD_TERM_GATES) != 0;
  for (int t0 = n_lo, buf = 0; t0 < n_hi; t0 += TILE, buf ^= 1) {
    const int tn = min(TILE, n_hi - t0);
    float* ub0 = s_ub + buf * GATES * TILE;
    uint16_t* lab = s_label + buf * TILE;
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int i = tid + j * THREADS;
      const int n = t0 + i;
      if (i < tn) {
        float cap[MAXD], nt[MAXD], pt[MAXD];
#pragma unroll
        for (int d = 0; d < MAXD; ++d) {
          if (d < D) {
            cap[d] = a.alloc_score[(size_t)n * D + d];
            nt[d] = a.node_term[(size_t)n * D + d];
            if (any_prod) pt[d] = a.prod_term[(size_t)n * D + d];
          }
        }
        const bool fresh = a.fresh[n] != 0;
        const bool sched = a.schedulable[n] != 0;
        const bool ok_cls[3] = {sched, sched && (a.node_ok[n] || !fresh),
                                sched && (a.prod_node_ok[n] || !fresh)};
        if ((gates_used & SELECTOR_USED) || TAINT)
          lab[i] = (uint16_t)(
              label_column(a.label_group[n], a.L) |
              (TAINT ? label_column(a.taint_group[n], a.G) << LABEL_BITS : 0));
        // the node's bound: the largest value a pod can give it
        float ub_t[2] = {0.0f, 0.0f};
        if (fresh) {
          ub_t[0] = score_bound<MAXD>([&](int d) { return cap[d]; },
                                      [&](int d) { return nt[d]; }, D, s_w,
                                      wsum);
          if (any_prod)
            ub_t[1] = score_bound<MAXD>([&](int d) { return cap[d]; },
                                        [&](int d) { return pt[d]; }, D, s_w,
                                        wsum);
        }
        if (a.tie_break && !ADD && !TAINT && !TOPO) {  // else in the filter
          ub_t[0] = __fmaf_rn(1023.0f, JITTER, ub_t[0]);
          ub_t[1] = __fmaf_rn(1023.0f, JITTER, ub_t[1]);
        }
#pragma unroll
        for (int gi = 0; gi < GATES; ++gi)
          if ((gates_used >> gi) & 1)
            ub0[gi * TILE + i] = ok_cls[gi >> 1] ? ub_t[gi & 1] : -INFINITY;
      }
    }
    __syncthreads();
    if (!any) continue;

    // The filter: a pair is queued while its row's list is not full (a
    // -1 may still enter it); after that only if it passes the gates and
    // its node's bound could beat the row's k-th entry, which most pairs
    // do not once the lists fill. The inner loop only advances chunks
    // of 32 nodes until one holds a pair to queue; its queued pairs'
    // fit columns are prefetched into L1 for their flush.
    const float* ubr[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) ubr[r] = ub0 + gate_sel[r] * TILE;
    for (int c = 0; c < tn;) {
      unsigned m[ROWS], any_m;
      do {
        const int i = c + lane;
        const bool in = i < tn;
        const int ii = in ? i : 0;
        const int n = t0 + i;
        const int packed = any_sel || TAINT ? lab[ii] : 0;
        const int label = packed & ((1 << LABEL_BITS) - 1);
        const int tg = packed >> LABEL_BITS;
        uint32_t cw[TOPO ? TOPO_FAM : 1];  // the column's topology words
        if (TOPO) {
#pragma unroll
          for (int f = 0; f < TOPO_FAM; ++f)
            cw[f] = ((fams >> f) & 1u) && in
                        ? (uint32_t)a.col_words[(size_t)f * (N + a.V) + n]
                        : 0u;
        }
        any_m = 0;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          float ub = ubr[r][ii];
          if ((ADD >= 1 || TAINT || TOPO) && live[r] && in) {
            if (ADD >= 1 && prow[r] < a.R1)
              ub = __fadd_rn(ub, a.pair_score[(size_t)prow[r] * N + n]);
            if (ADD == 2 && prow[r] < a.R2)
              ub = __fadd_rn(ub, a.pair_score2[(size_t)prow[r] * N + n]);
            if (TAINT && ub != -INFINITY)  // a gated class stays out
              ub = fmaxf(__fsub_rn(ub, s_pen[slot0 + r][tg]), 0.0f);
            if (TOPO) {
              uint32_t hit = 0u;
#pragma unroll
              for (int f = 0; f < TOPO_FAM; ++f) hit |= pw[r][f] & cw[f];
              if (hit)
                ub = -INFINITY;
              else if (a.penalty != nullptr && ub != -INFINITY)
                ub = fmaxf(__fsub_rn(ub, spread_at(a, pw[r][TOPO_SPREAD], n)),
                           0.0f);
            }
            if (a.tie_break) ub = __fmaf_rn(1023.0f, JITTER, ub);
          }
          bool sel = true;
          if (any_sel)
            sel = sel_all[r] ||
                  ((s_sel[slot0 + r][label >> 5] >> (label & 31)) & 1u);
          if (TAINT)
            sel = sel && !((s_forbid[slot0 + r][tg >> 5] >> (tg & 31)) & 1u);
          const bool cand =
              live[r] & in &
              ((tk[r].tv == -INFINITY) |
               (sel & (bounded[r] ? better(ub, n, tk[r].tv, tk[r].ti)
                                  : ub != -INFINITY)));
          m[r] = __ballot_sync(FULL, cand);
          any_m |= m[r];
        }
        c += 32;
      } while (any_m == 0 && c < tn);
      if (any_m == 0) break;
      const int n = t0 + c - 32 + lane;
      if ((any_m >> lane) & 1u) {
        asm volatile("prefetch.global.L1 [%0];" ::"l"(a.requested_fit + (size_t)n * F));
        asm volatile("prefetch.global.L1 [%0];" ::"l"(a.alloc_fit + (size_t)n * F));
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (m[r] == 0) continue;
        if ((m[r] >> lane) & 1u)
          s_queue[slot0 + r][(qt[r] + __popc(m[r] & lower)) & (QUEUE - 1)] = n;
        qt[r] += __popc(m[r]);
        if (qt[r] - qh[r] >= 32) flush(r);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (prow[r] < 0) continue;
    while (qt[r] > qh[r]) flush(r);
  }

  // the slot columns N..N+V-1, in the group's last split, each scored
  // exactly: 301 plus jitter where the pod may use the slot, the slot
  // is open and the request fits its free less its carried use
  if (a.V > 0 && split == splits - 1) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (prow[r] < 0) continue;
      for (int v0 = 0; v0 < a.V; v0 += 32) {
        const int sv = v0 + lane;
        const bool has = sv < a.V;
        const int n = N + sv;
        bool ok = has && a.slot_ok[(size_t)prow[r] * a.V + sv] &&
                  !a.slot_block[sv];
        if (TOPO) ok = ok && !topo_blocked(a, pw[r], n);
        if (ok)
          for (int f = 0; f < F; ++f)
            ok = ok && (__fadd_rn(s_rq[slot0 + r][f],
                                  a.requested_fit[(size_t)n * F + f])
                        <= __fadd_rn(a.alloc_fit[(size_t)n * F + f], a.eps));
        float v = -1.0f;
        if (ok) {
          v = SLOT_SCORE;
          if (a.tie_break) {
            const uint32_t h = ((uint32_t)prow[r] * 2654435761u +
                                (uint32_t)n * 40503u) & 1023u;
            v = __fmaf_rn((float)h, JITTER, v);
          }
        }
        topk_add(tk[r], k, lane, v, n, has);
      }
    }
  }

  // 4. splits: the last block of the group merges the other splits'
  //    lists into its own
  if (splits > 1) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (prow[r] < 0) continue;
      const size_t base = ((size_t)blockIdx.x * RB + slot0 + r) * k;
      for (int j = lane; j < k; j += 32) {
        a.part_val[base + j] = t_lv[slot0 + r][j];
        a.part_idx[base + j] = t_li[slot0 + r][j];
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(&a.tickets[g], 1) == splits - 1;
    __syncthreads();
    if (!s_last) return;  // the whole block
    __threadfence();
    const int total_e = splits * k;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (prow[r] < 0) continue;
      for (int e0 = 0; e0 < total_e; e0 += 32) {
        const int e = e0 + lane;
        const int sp = e / k;
        bool valid = e < total_e && sp != split;
        float v = -INFINITY;
        int i = 0x7fffffff;
        if (valid) {
          const size_t o =
              ((size_t)(g * splits + sp) * RB + slot0 + r) * k + (e - sp * k);
          v = __ldcg(a.part_val + o);
          i = __ldcg(a.part_idx + o);
          valid = i < N + a.V;  // not the padding of a short split
        }
        topk_add(tk[r], k, lane, v, i, valid);
      }
    }
    if (tid == 0) a.tickets[g] = 0;
  }

  // 5. the rows' top-k
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (prow[r] < 0) continue;
    for (int j = lane; j < k; j += 32) {
      a.out_val[(size_t)prow[r] * k + j] = t_lv[slot0 + r][j];
      a.out_idx[(size_t)prow[r] * k + j] = t_li[slot0 + r][j];
    }
  }
}

// Allow the instance its dynamic shared memory and count its resident
// blocks an SM (once).
template <class C, int ADD, bool TAINT, bool TOPO>
int prepare(int* occupancy) {
  static int occ = 0;
  if (occ == 0) {
    const size_t smem = smem_bytes(C::TILE);
    cudaError_t err = cudaFuncSetAttribute(
        score_topk_kernel<C, ADD, TAINT, TOPO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, score_topk_kernel<C, ADD, TAINT, TOPO>, C::THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    occ = max(blocks, 1);
  }
  if (occupancy) *occupancy = occ;
  return 0;
}

template <class C, int ADD, bool TAINT, bool TOPO>
int launch(const Args& a, int blocks, cudaStream_t s) {
  const int rc = prepare<C, ADD, TAINT, TOPO>(nullptr);
  if (rc) return rc;
  score_topk_kernel<C, ADD, TAINT, TOPO>
      <<<blocks, C::THREADS, smem_bytes(C::TILE), s>>>(a);
  return (int)cudaGetLastError();
}

template <class C, bool TAINT, bool TOPO>
int launch(const Args& a, int blocks, cudaStream_t s) {
  if (a.pair_score2 != nullptr)
    return launch<C, 2, TAINT, TOPO>(a, blocks, s);
  return a.pair_score != nullptr ? launch<C, 1, TAINT, TOPO>(a, blocks, s)
                                 : launch<C, 0, TAINT, TOPO>(a, blocks, s);
}

template <class C, bool TOPO>
int launch(const Args& a, int blocks, cudaStream_t s) {
  return a.tol_forbid != nullptr ? launch<C, true, TOPO>(a, blocks, s)
                                 : launch<C, false, TOPO>(a, blocks, s);
}

template <class C>
int launch(const Args& a, int blocks, cudaStream_t s) {
  return a.pod_words != nullptr ? launch<C, true>(a, blocks, s)
                                : launch<C, false>(a, blocks, s);
}

template <class C, bool TAINT, bool TOPO>
int prepare(int add, int* occupancy) {
  if (add == 2) return prepare<C, 2, TAINT, TOPO>(occupancy);
  return add ? prepare<C, 1, TAINT, TOPO>(occupancy)
             : prepare<C, 0, TAINT, TOPO>(occupancy);
}

template <class C, bool TOPO>
int prepare(int add, int taint, int* occupancy) {
  return taint ? prepare<C, true, TOPO>(add, occupancy)
               : prepare<C, false, TOPO>(add, occupancy);
}

template <class C>
int prepare(int add, int taint, int topo, int* occupancy) {
  return topo ? prepare<C, true>(add, taint, occupancy)
              : prepare<C, false>(add, taint, occupancy);
}

}  // namespace

// The grid of one launch for P pods: at least one block per 16 rows,
// and enough blocks to fill every SM as far as the instance's occupancy
// allows (`add`: the number of pair scores, 0 to 2; `taint`: whether the
// batch has tolerations; `topo`: whether it has pod topology terms).
// Returns the block count, or minus a CUDA error code.
extern "C" int koord_score_topk_blocks(int P, int F, int D, int add,
                                       int taint, int topo) {
  const int need = (P + RB - 1) / RB;
  int occ = 0, dev = 0, sms = 0;
  const int rc = F <= NARROW && D <= NARROW
                     ? prepare<Narrow>(add, taint, topo, &occ)
                     : prepare<Wide>(add, taint, topo, &occ);
  if (rc) return -rc;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  return max(max(need, 1), sms * occ);
}

// ptr: row_ok, device_ok, selector_id, prod_gate, daemonset,
// prod_scored, req_fit, est, label_group, node_ok, prod_node_ok, fresh,
// schedulable, requested_fit, alloc_fit, node_term, prod_term,
// alloc_score, selector_match, pair_ok (or null), weights, part_val,
// part_idx, tickets, out_val, out_idx, pair_score (or null),
// pair_score2 (or null; only with pair_score), toleration_id,
// taint_group, tol_forbid, tol_penalty (all four or none), slot_ok,
// slot_block (null where V = 0), pod_words, col_words (both or none),
// penalty (or null; only with the words), amp_bind, amp_ratio (both
// or none). dims: P, N, F, D, k, S, L, tie_break, fma_sum, blocks (from
// koord_score_topk_blocks), V, T, G, SG (the penalty map's groups), LDP
// (its row stride), R1, R2 (the rows of pair_score and pair_score2,
// each at most P), amp_col (the fit column of CPU).
extern "C" int koord_score_topk(const void* const* ptr, const int* dims,
                                float eps, void* stream) {
  Args a;
  a.row_ok = (const uint8_t*)ptr[0];
  a.device_ok = (const uint8_t*)ptr[1];
  a.selector_id = (const int32_t*)ptr[2];
  a.prod_gate = (const uint8_t*)ptr[3];
  a.daemonset = (const uint8_t*)ptr[4];
  a.prod_scored = (const uint8_t*)ptr[5];
  a.req_fit = (const float*)ptr[6];
  a.est = (const float*)ptr[7];
  a.label_group = (const int32_t*)ptr[8];
  a.node_ok = (const uint8_t*)ptr[9];
  a.prod_node_ok = (const uint8_t*)ptr[10];
  a.fresh = (const uint8_t*)ptr[11];
  a.schedulable = (const uint8_t*)ptr[12];
  a.requested_fit = (const float*)ptr[13];
  a.alloc_fit = (const float*)ptr[14];
  a.node_term = (const float*)ptr[15];
  a.prod_term = (const float*)ptr[16];
  a.alloc_score = (const float*)ptr[17];
  a.selector_match = (const uint8_t*)ptr[18];
  a.pair_ok = (const uint8_t*)ptr[19];
  a.weights = (const float*)ptr[20];
  a.part_val = (float*)ptr[21];
  a.part_idx = (int32_t*)ptr[22];
  a.tickets = (int32_t*)ptr[23];
  a.out_val = (float*)ptr[24];
  a.out_idx = (int32_t*)ptr[25];
  a.pair_score = (const float*)ptr[26];
  a.pair_score2 = (const float*)ptr[27];
  a.toleration_id = (const int32_t*)ptr[28];
  a.taint_group = (const int32_t*)ptr[29];
  a.tol_forbid = (const uint8_t*)ptr[30];
  a.tol_penalty = (const float*)ptr[31];
  a.slot_ok = (const uint8_t*)ptr[32];
  a.slot_block = (const uint8_t*)ptr[33];
  a.pod_words = (const int32_t*)ptr[34];
  a.col_words = (const int32_t*)ptr[35];
  a.penalty = (const float*)ptr[36];
  a.amp_bind = (const uint8_t*)ptr[37];
  a.amp_ratio = (const float*)ptr[38];
  a.P = dims[0];
  a.N = dims[1];
  a.F = dims[2];
  a.D = dims[3];
  a.k = dims[4];
  a.S = dims[5];
  a.L = dims[6];
  a.tie_break = dims[7];
  a.fma_sum = dims[8];
  a.eps = eps;
  const int blocks = dims[9];
  a.V = dims[10];
  a.T = dims[11];
  a.G = dims[12];
  a.SG = dims[13];
  a.LDP = dims[14];
  a.R1 = dims[15];
  a.R2 = dims[16];
  a.amp_col = dims[17];
  if (a.P <= 0) return 0;
  const bool taint = a.tol_forbid != nullptr;
  if (a.F > MAX_DIMS || a.D > MAX_DIMS || a.k > MAX_K || a.V < 0 ||
      a.k > a.N + a.V || a.k <= 0 || a.L > MAX_LABELS ||
      a.N >= SENTINEL - a.V || blocks <= 0 ||
      (a.pair_score2 != nullptr && a.pair_score == nullptr) ||
      (a.pair_score != nullptr && (a.R1 <= 0 || a.R1 > a.P)) ||
      (a.pair_score2 != nullptr && (a.R2 <= 0 || a.R2 > a.P)) ||
      (taint && (a.T <= 0 || a.G <= 0 || a.G > MAX_TG ||
                 a.toleration_id == nullptr || a.taint_group == nullptr ||
                 a.tol_penalty == nullptr)) ||
      (a.V > 0 && (a.slot_ok == nullptr || a.slot_block == nullptr)) ||
      ((a.pod_words == nullptr) != (a.col_words == nullptr)) ||
      (a.penalty != nullptr && (a.pod_words == nullptr || a.SG <= 0 ||
                                a.SG > 32 || a.LDP < a.N)) ||
      ((a.amp_bind == nullptr) != (a.amp_ratio == nullptr)) ||
      (a.amp_ratio != nullptr && (a.amp_col < 0 || a.amp_col >= a.F)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return a.F <= NARROW && a.D <= NARROW ? launch<Narrow>(a, blocks, s)
                                        : launch<Wide>(a, blocks, s);
}
