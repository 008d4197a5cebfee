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
// reads a few tens of KB and a gpu_share step's column holds a few
// dozen charging and gated pods, so its time is the launch and the
// chain of dependent steps inside it: a pod's domain needs its choice,
// the counts need every charging pod of the column, and the verdict
// needs every column. Each link is a memory round trip or a barrier
// (a barrier also waits for its threads' loads), so the design cuts
// links:
//
// - Loads in flight. A thread issues the loads of all its pods at once
//   (trying, choice, rank, the charge and gate words; the group's limit
//   and an opener group's counts beside them), so the first level costs
//   one round trip; the domains are the second. An opener's count at its
//   domain comes from shared memory where the group's counts fit.
// - Lists, not a scan. The gated and the charging pods are sets: each
//   warp appends its own to a shared list with a ballot and one atomic.
// - The count walks the charging list once for each gated pod, two
//   (segment, rank) pairs a shared load, while the pod's base count
//   (its domain's carried count) loads in the background.
// - The merge is one atomic. Every block adds its tile's failures to
//   64-bit tallies of six pods (8 bits a pod: how many columns fail it;
//   16 bits: how many blocks have added); the block whose add completes
//   a tally writes the six verdicts and zeroes the tally. Adds commute,
//   so no fence, ticket or last block orders them. The tallies are kept
//   a (device, stream) by the wrapper, zero between launches.
//
// Grid: one block a (group column, tile of gated pods), four pods a
// thread: 128 threads up to 512 pods (the full gate's topo_prefix rows,
// the tail), 512 threads above. Up to one tile (2048 pods: every step
// of the flagship, the full gate and gpu_share) a block classifies its
// pods once and counts against them. Above it (a service batch or a
// config-4-sized chunk) a block counts its gated tile against every
// tile of charging pods in turn; a count of earlier charges is a sum of
// whole numbers, so adding it up tile by tile gives the same count.
//
// Exactness: the charges are 0/1 and the counts whole numbers below
// 2^24, so every count and sum is exact in any order, and occ is the
// reference's fl(base + k) with k exact. The comparisons are the
// reference's. Ranks need not be distinct: a tie is not earlier.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ITEMS = 4;   // pods a thread
constexpr int MAX_FAM = 4;
constexpr int MAX_G = 32;
constexpr int CAP = 0, OCCUPY = 1, OPENER = 2;
constexpr int SMALL = 128, LARGE = 512;  // the two block sizes
constexpr int SMALL_D = 512;  // an opener group's counts staged up to this

// The tallies a tile of `tile` pods needs: one a six pods.
__host__ __device__ constexpr int tally_words(int tile) {
  return (tile + 5) / 6;
}

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
  // [tiles * words_per_tile(THREADS)] tallies of six pods each, zero
  // between launches
  unsigned long long* tally;
  uint8_t* out;           // [P]
  int P, X, columns;
};

// A tile's first-level loads as a thread holds them: item k is pod
// base + t + k * THREADS.
struct Loads {
  int choice[ITEMS], rank[ITEMS];
  uint32_t cw[ITEMS], gw[ITEMS];
  bool trying[ITEMS];
};

// A tile's pods classified for one column.
struct Tile {
  int seg[ITEMS], rank[ITEMS];
  bool charge[ITEMS], gated[ITEMS];
};

template <int THREADS>
__device__ __forceinline__ void load(const Args& a, const Family& fm,
                                     int base, int t, Loads& l) {
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = base + t + k * THREADS;
    const bool in = i < a.P;
    l.trying[k] = in && a.trying[i] != 0;
    l.choice[k] = in ? a.choice[i] : 0;
    l.rank[k] = in ? a.rank[i] : 0;
    l.gw[k] = in ? (uint32_t)fm.gate[i] : 0u;
    l.cw[k] = in && fm.kind != OPENER ? (uint32_t)fm.charge[i] : 0u;
  }
}

// The domains, then the flags. An opener reads its domain's count from
// `cnt` (shared memory where the group's counts fit, else global).
__device__ __forceinline__ void classify(const Args& a, const Family& fm,
                                         int g, const float* cnt,
                                         const Loads& l, Tile& tl) {
  int d[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int c = min(max(l.choice[k], 0), a.X - 1);
    d[k] = l.trying[k] ? fm.dom[(size_t)g * a.X + c] : -1;
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const bool gated = d[k] >= 0 && ((l.gw[k] >> g) & 1u);
    tl.rank[k] = l.rank[k];
    if (fm.kind == OPENER) {
      tl.gated[k] = tl.charge[k] = gated && cnt[gated ? d[k] : 0] < 0.5f;
      tl.seg[k] = 0;
    } else {
      tl.gated[k] = gated;
      tl.charge[k] = d[k] >= 0 && ((l.cw[k] >> g) & 1u);
      tl.seg[k] = d[k];
    }
  }
}

// Append the flagged items' (segment, rank) to a shared list, one
// atomic a warp; with `pods`, each item's pod index in the tile too.
__device__ __forceinline__ void append(const bool (&on)[ITEMS],
                                       const int (&seg)[ITEMS],
                                       const int (&rank)[ITEMS], int t,
                                       int threads, int* n, int2* list,
                                       int16_t* pods) {
  const int lane = t & 31;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const uint32_t bal = __ballot_sync(~0u, on[k]);
    int at = 0;
    if (lane == 0 && bal) at = atomicAdd(n, __popc(bal));
    at = __shfl_sync(~0u, at, 0) + __popc(bal & ((1u << lane) - 1u));
    if (on[k]) {
      list[at] = make_int2(seg[k], rank[k]);
      if (pods) pods[at] = (int16_t)(t + k * threads);
    }
  }
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
    topology_prefix_kernel(const __grid_constant__ Args a) {
  constexpr int WARPS = THREADS / 32, TILE = THREADS * ITEMS;
  __shared__ __align__(16) int2 s_ch[TILE];  // charging pods: (segment, rank)
  __shared__ int2 s_gt[TILE];                // gated pods: (segment, rank)
  __shared__ int16_t s_gp[TILE];             // and their index in the tile
  __shared__ float s_cnt[SMALL_D];           // an opener group's counts
  __shared__ int s_n[3];  // chargers (alternating between tiles), gated
  __shared__ float s_part[WARPS];
  __shared__ uint8_t s_fail[TILE];  // the tile's pods this column fails

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // this block's family, group and gated tile
  int f = 0, g = blockIdx.x;
  while (f + 1 < a.nfam && g >= a.fam[f].G) g -= a.fam[f++].G;
  const Family fm = a.fam[f];
  const int gbase = blockIdx.y * TILE;
  const int tiles = gridDim.y;
  const bool opener = fm.kind == OPENER;
  if (t < 3) s_n[t] = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) s_fail[t + k * THREADS] = 0;

  // every first-level load at once: the tile's pods, the group's limit,
  // an opener group's counts (staged for the openers' test where they
  // fit; their total is reduced later)
  Loads ld;
  load<THREADS>(a, fm, gbase, t, ld);
  const float lim = fm.kind == CAP ? fm.lim[g] : 0.0f;
  float part[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int j = t + k * THREADS;
    part[k] = opener && j < fm.D ? fm.counts[(size_t)g * fm.D + j] : 0.0f;
    if (opener && j < min(fm.D, SMALL_D)) s_cnt[j] = part[k];
  }
  __syncthreads();  // s_n zero and s_cnt staged before use

  const float* cnt = fm.D <= SMALL_D ? s_cnt : fm.counts + (size_t)g * fm.D;
  Tile mine;
  classify(a, fm, g, cnt, ld, mine);
  append(mine.gated, mine.seg, mine.rank, t, THREADS, &s_n[2], s_gt, s_gp);
  // the thread's gated pods (entries t + m * THREADS of the list)
  int before[ITEMS] = {};
  float base[ITEMS] = {};
  for (int ct = 0; ct < tiles; ++ct) {
    Tile ch = mine;
    if (ct != (int)blockIdx.y) {
      Loads lc;
      load<THREADS>(a, fm, ct * TILE, t, lc);
      classify(a, fm, g, cnt, lc, ch);
    }
    if (ct > 0) __syncthreads();  // the last tile's count is done with it
    if (t == 0) s_n[(ct + 1) & 1] = 0;
    int* n_at = &s_n[ct & 1];
    append(ch.charge, ch.seg, ch.rank, t, THREADS, n_at, s_ch, nullptr);
    if (ct == 0 && opener) {  // the opener total's warp parts
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) s += part[k];
      for (int j = t + ITEMS * THREADS; j < fm.D; j += THREADS)
        s += fm.counts[(size_t)g * fm.D + j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(~0u, s, o);
      if (lane == 0) s_part[warp] = s;
    }
    __syncthreads();
    const int n = *n_at, ng = s_n[2];
#pragma unroll
    for (int m = 0; m < ITEMS; ++m) {
      const int e = t + m * THREADS;
      if (e >= ng) break;
      const int2 me = s_gt[e];
      if (ct == 0 && !opener)  // the domain's count, loaded under the walk
        base[m] = fm.counts[(size_t)g * fm.D + me.x];
      // the earlier charging pods of its segment, two a shared load
      const int4* two = reinterpret_cast<const int4*>(s_ch);
      int b = 0, j = 0;
      for (; j + 1 < n; j += 2) {
        const int4 q = two[j >> 1];
        b += ((q.x == me.x) & (q.y < me.y)) + ((q.z == me.x) & (q.w < me.y));
      }
      if (j < n) b += (s_ch[j].x == me.x) & (s_ch[j].y < me.y);
      before[m] += b;
    }
  }

  float total = 0.0f;
  if (opener) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += s_part[w];
  }
  const int ng = s_n[2];
#pragma unroll
  for (int m = 0; m < ITEMS; ++m) {
    const int e = t + m * THREADS;
    if (e >= ng) break;
    const float occ = __fadd_rn(opener ? total : base[m], (float)before[m]);
    const bool fits = fm.kind == CAP ? __fadd_rn(occ, 1.0f) <= lim
                                     : occ < 0.5f;
    if (!fits) s_fail[s_gp[e]] = 1;
  }

  // the merge: every block adds its tile's failures to the tallies of
  // six pods (8 bits a pod, the count of failing columns, and 16 bits
  // of blocks that have added), one atomic a tally; the block whose add
  // is the column count's last writes the six pods' verdicts and zeroes
  // the tally for the next launch. Adds commute, so no fence orders them
  __syncthreads();
  const int npods = min(TILE, a.P - gbase);
  unsigned long long* tally = a.tally + (size_t)blockIdx.y * tally_words(TILE);
  for (int w = t; 6 * w < npods; w += THREADS) {
    unsigned long long add = 1ull << 48;
#pragma unroll
    for (int i = 0; i < 6; ++i)
      if (6 * w + i < npods)
        add += (unsigned long long)s_fail[6 * w + i] << (8 * i);
    const unsigned long long old = atomicAdd(tally + w, add);
    if ((int)(old >> 48) == a.columns - 1) {
      const unsigned long long sum = old + add;
#pragma unroll
      for (int i = 0; i < 6; ++i)
        if (6 * w + i < npods)
          a.out[gbase + 6 * w + i] = ((sum >> (8 * i)) & 0xFFu) == 0;
      tally[w] = 0ull;
    }
  }
}

// The launch floor: an empty kernel with K8's grid and block.
template <int THREADS>
__global__ void __launch_bounds__(THREADS) topology_prefix_floor_kernel() {}

// The block size a launch of P pods takes: 128 threads up to 512 pods
// (the full gate's topo_prefix rows, the tail), else 512.
int block_size(int P) { return P <= SMALL * ITEMS ? SMALL : LARGE; }

}  // namespace

// ptr: per family (dom_x, counts, charge, gate, lim or null), then
// choice, trying, rank, tally (koord_topology_prefix_tallies(P) uint64,
// zero), out. dims: P, X, nfam, then per family G, D, kind.
extern "C" int koord_topology_prefix_gate(const void* const* ptr,
                                          const int* dims, void* stream) {
  Args a = {};
  a.P = dims[0];
  a.X = dims[1];
  a.nfam = dims[2];
  if (a.P <= 0) return 0;
  if (a.X <= 0 || a.nfam <= 0 || a.nfam > MAX_FAM)
    return (int)cudaErrorInvalidValue;
  int columns = 0;
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
    columns += fm.G;
  }
  const int base = 5 * a.nfam;
  a.choice = (const int32_t*)ptr[base];
  a.trying = (const uint8_t*)ptr[base + 1];
  a.rank = (const int32_t*)ptr[base + 2];
  a.tally = (unsigned long long*)ptr[base + 3];
  a.out = (uint8_t*)ptr[base + 4];
  const int threads = block_size(a.P);
  const int tiles = (a.P + threads * ITEMS - 1) / (threads * ITEMS);
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  a.columns = columns;
  const dim3 grid(columns, tiles);
  if (threads == SMALL)
    topology_prefix_kernel<SMALL>
        <<<grid, SMALL, 0, (cudaStream_t)stream>>>(a);
  else
    topology_prefix_kernel<LARGE>
        <<<grid, LARGE, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The zeroed uint64 tallies a launch of P pods takes.
extern "C" long long koord_topology_prefix_tallies(int P) {
  const int threads = block_size(P);
  const int tile = threads * ITEMS;
  return (long long)((P + tile - 1) / tile) * tally_words(tile);
}

// The empty kernel on the grid a launch of P pods over `columns` group
// columns takes (the launch floor K8's time is read against).
extern "C" int koord_topology_prefix_floor(int P, int columns, void* stream) {
  if (P <= 0 || columns <= 0) return (int)cudaErrorInvalidValue;
  const int threads = block_size(P);
  const int tiles = (P + threads * ITEMS - 1) / (threads * ITEMS);
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(columns, tiles);
  if (threads == SMALL)
    topology_prefix_floor_kernel<SMALL>
        <<<grid, SMALL, 0, (cudaStream_t)stream>>>();
  else
    topology_prefix_floor_kernel<LARGE>
        <<<grid, LARGE, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
