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
// ANDs into a mask it reads); a GPU pod's pair costs I fit tests and
// three correctly rounded divisions, and most pods ask for no device
// (the full gate's gpu prefix: about 200 GPU pods of 896 rows).
//
// Design (pair_rows.cuh for the spans): a block of 128 threads takes a
// tile of nodes (256 at I = 8, down to 32 at I = 64) and up to 64 rows,
// every G-th row of the batch. It classifies its rows once: a GPU row (a
// GPU request), an aux row (an aux request, on a snapshot with aux
// pools), or neither. A row that is neither passes everywhere: it only
// stores zero scores and leaves the mask alone. Else the block stages,
// once a node, what every pair reuses: the instances' fit thresholds
// free + eps (NaN on an invalid instance, which fails every fit; the
// tile's [N, I, 3] span read contiguously), pool_total - pool_free and
// max(pool_total, 1e-9), each aux pool's largest valid free + eps (the
// free copied by cp.async, every load of a thread in flight). A GPU
// row's terms are a function of its request's three values and the
// node: the block lists its GPU rows' distinct requests by their bits
// (up to 8 request classes; the full gate's 205 GPU rows hold 4) and
// computes each class's verdicts and scores once a node, which its rows
// then copy; a row past the list computes its own. The per-instance
// request depends on the node only through its per-GPU memory, so the
// block also lists the tile's distinct memories (up to 4, by their bits)
// and computes it once a (class, memory); a node of another memory
// computes it afresh. A thread takes 4 nodes of a row: one mask word
// in, one word and one float4 out.
//
// Exactness against the reference (bit for bit): the file builds with
// -fmad=false and names each rounding (device_share.cuh for the
// per-instance request). The pool total is the per-GPU total times the
// valid instance count; the pool free sums free * valid over the
// instances in order from 0. used_after = (pool_total - pool_free) + per
// * count, frac = used_after / max(pool_total, 1e-9), the weighted sum
// over the three dims ((0 + t0 * w0) + t1 * w1) + t2 * w2 (t = frac for
// "most", 1 - frac for "least"; w = 1 where the per-instance request is
// > 0), divided by max(w0 + w1 + w2, 1), clipped to [0, 1], times 100:
// the reference's order. That last divisor is 1, 2 or 3: a division by 1
// is the identity and one by 2 the exact x * 0.5 (the same real number,
// correctly rounded, subnormals included: no -ftz); 3 keeps __fdiv_rn.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "device_share.cuh"
#include "pair_rows.cuh"

namespace {

using koord_rows::SPAN;
using koord_rows::Span;
using koord_rows::THREADS;
using koord_rows::MAX_ROWS;
using koord_rows::ONES;

constexpr int MAX_I = 64, MAX_J = 64;
constexpr int MAX_MEMS = 4;   // distinct per-GPU memories listed a tile
constexpr int MAX_CLASSES = 8;   // distinct GPU requests listed a block
constexpr int GPU_ROW = 1, AUX_ROW = 2;

struct Args {
  const float* gpu_req;      // [P, 3]
  const float* total;        // [N, 3]
  const float* free_;        // [N, I, 3]
  const uint8_t* valid;      // [N, I]
  const float* aux_req;      // [P, 2]
  const float* aux_free;     // [N, 2, J]
  const uint8_t* aux_valid;  // [N, 2, J]
  uint8_t* ok;               // [P, N], the mask ANDed in place with and_in
  float* score;              // [P, N], or null where I = 0
  int P, N, I, J, least, tile, and_in;
  float eps;
};

// a row's per-instance request at one per-GPU memory, and what its pool
// score needs: the allocation per dim and the weight sum's divisor
struct Req {
  int count;
  int div;          // max(w0 + w1 + w2, 1)
  float v[3];       // the request per instance
  float alloc[3];   // v * count
};

__device__ __forceinline__ Req request_at(float mem, float core, float gm,
                                          float ratio) {
  const koord_dev::PerInst pi = koord_dev::per_instance(mem, core, gm, ratio);
  Req q;
  q.count = pi.count;
  float wsum = 0.0f;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    q.v[d] = pi.v[d];
    q.alloc[d] = __fmul_rn(pi.v[d], (float)pi.count);
    wsum = __fadd_rn(wsum, pi.v[d] > 0.0f ? 1.0f : 0.0f);
  }
  q.div = (int)fmaxf(wsum, 1.0f);
  return q;
}

// the shared planes of a tile, each `tile` long: fe[I][3] (free + eps,
// NaN where invalid), then pa[3] (pool_total - pool_free), pm[3]
// (max(pool_total, 1e-9)), ax[2] (aux largest valid free + eps), the
// memories' bits, the classes' scores [MAX_CLASSES]; then the bytes:
// the classes' verdict bits, a byte a span [MAX_CLASSES], the valid
// bytes [I] and the memory index a node
struct Planes {
  float* fe;
  float* pa;
  float* pm;
  float* ax;
  unsigned* mem;
  float* csc;
  uint8_t* cok;
  uint8_t* vb;
  int8_t* midx;
};

__device__ __forceinline__ Planes planes(float* s, int tile, int I) {
  Planes p;
  p.fe = s;
  p.pa = s + (size_t)3 * I * tile;
  p.pm = p.pa + 3 * tile;
  p.ax = p.pm + 3 * tile;
  p.mem = reinterpret_cast<unsigned*>(p.ax + 2 * tile);
  p.csc = reinterpret_cast<float*>(p.mem + tile);
  p.cok = reinterpret_cast<uint8_t*>(p.csc + MAX_CLASSES * tile);
  p.vb = p.cok + MAX_CLASSES * tile / SPAN;
  p.midx = reinterpret_cast<int8_t*>(p.vb + (size_t)I * tile);
  return p;
}

// The GPU verdict bits and pool scores of the thread's nodes k0..k0+3,
// each for its own per-instance request q[j]: `count` valid instances
// that fit it, and the pool score after the allocation.
__device__ __forceinline__ unsigned gpu_terms(const Planes& sp, int tile,
                                              int I, int k0, int least,
                                              const Req (&q)[SPAN],
                                              float (&out)[SPAN]) {
  int n_fit[SPAN] = {0, 0, 0, 0};
  for (int i = 0; i < I; ++i) {
    const float* fe = sp.fe + (size_t)i * 3 * tile + k0;
    float e0[SPAN], e1[SPAN], e2[SPAN];
    koord_rows::load4(fe, e0);
    koord_rows::load4(fe + tile, e1);
    koord_rows::load4(fe + 2 * tile, e2);
#pragma unroll
    for (int j = 0; j < SPAN; ++j)
      n_fit[j] += e0[j] >= q[j].v[0] && e1[j] >= q[j].v[1] &&
                  e2[j] >= q[j].v[2];
  }
  unsigned okbits = 0;
#pragma unroll
  for (int j = 0; j < SPAN; ++j)
    okbits |= (unsigned)(n_fit[j] >= q[j].count) << j;
  float pa[3][SPAN], pm[3][SPAN];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    koord_rows::load4(sp.pa + d * tile + k0, pa[d]);
    koord_rows::load4(sp.pm + d * tile + k0, pm[d]);
  }
#pragma unroll
  for (int j = 0; j < SPAN; ++j) {
    float s = 0.0f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float used = __fadd_rn(pa[d][j], q[j].alloc[d]);
      float frac = __fdiv_rn(used, pm[d][j]);
      if (least) frac = __fsub_rn(1.0f, frac);
      s = __fadd_rn(s, __fmul_rn(frac, q[j].v[d] > 0.0f ? 1.0f : 0.0f));
    }
    if (q[j].div == 2)
      s = __fmul_rn(s, 0.5f);
    else if (q[j].div == 3)
      s = __fdiv_rn(s, 3.0f);
    out[j] = __fmul_rn(fminf(fmaxf(s, 0.0f), 1.0f), 100.0f);
  }
  return okbits;
}

__global__ void __launch_bounds__(THREADS)
    device_pair_terms_kernel(const Args a) {
  extern __shared__ float4 s_dyn[];
  __shared__ float s_req[MAX_ROWS][3];
  __shared__ float s_areq[MAX_ROWS][2];
  __shared__ uint8_t s_cls[MAX_ROWS];
  __shared__ int8_t s_class[MAX_ROWS];
  __shared__ float s_creq[MAX_CLASSES][3];
  __shared__ Req s_at[MAX_CLASSES][MAX_MEMS];
  __shared__ unsigned s_mems[MAX_MEMS];
  __shared__ int s_first, s_classes;

  const int t = threadIdx.x, tile = a.tile, I = a.I, J = a.J;
  const int nb = blockIdx.y * tile, nrows = koord_rows::block_rows(a.P);
  const int nodes = min(tile, a.N - nb);
  const Planes sp = planes(reinterpret_cast<float*>(s_dyn), tile, I);

  // 1. the rows' requests and classes
  int cls = 0;
  if (t < nrows) {
    const int p = koord_rows::row_of(t);
    float g[3] = {0.0f, 0.0f, 0.0f};
    if (I > 0) {
      for (int d = 0; d < 3; ++d) g[d] = a.gpu_req[(size_t)p * 3 + d];
    }
    float x[2] = {0.0f, 0.0f};
    if (J > 0) {
      for (int d = 0; d < 2; ++d) x[d] = a.aux_req[(size_t)p * 2 + d];
    }
    for (int d = 0; d < 3; ++d) s_req[t][d] = g[d];
    s_areq[t][0] = x[0];
    s_areq[t][1] = x[1];
    if (g[0] > 0.0f || g[1] > 0.0f || g[2] > 0.0f) cls |= GPU_ROW;
    if (!(x[0] <= 0.0f) || !(x[1] <= 0.0f)) cls |= AUX_ROW;
    s_cls[t] = (uint8_t)cls;
  }
  const bool any_gpu = __syncthreads_or(cls & GPU_ROW);
  const bool any_aux = __syncthreads_or(cls & AUX_ROW);

  // 2. the tile's instances, pools and memories, once a node; the GPU
  //    rows' distinct requests (the request classes), once a block.
  //    The tile's [nodes, I, 3] free is read contiguously and copied
  //    asynchronously (element k to plane c = 3i + d of node k / 3I).
  int n_mems = 0;
  if (any_gpu) {
    {
      const int per = 3 * I, dn = THREADS / per, dc = THREADS % per;
      int node = t / per, c = t % per;
      const float* f_in = a.free_ + (size_t)nb * per;
      for (int k = t; k < nodes * per; k += THREADS) {
        __pipeline_memcpy_async(sp.fe + (size_t)c * tile + node, f_in + k,
                                4);
        node += dn;
        c += dc;
        if (c >= per) {
          c -= per;
          ++node;
        }
      }
      __pipeline_commit();
    }
    // the valid bytes, plane-major, four loads in flight a thread
    const int per = I, dn = THREADS / per, dc = THREADS % per;
    int node = t / per, i = t % per;
    const uint8_t* v_in = a.valid + (size_t)nb * I;
    for (int k = t; k < nodes * I; k += 4 * THREADS) {
      uint8_t v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = k + u * THREADS < nodes * I ? v_in[k + u * THREADS] : 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (k + u * THREADS < nodes * I)
          sp.vb[(size_t)i * tile + node] = v[u];
        node += dn;
        i += dc;
        if (i >= per) {
          i -= per;
          ++node;
        }
      }
    }
    if (t < 32) {
      // warp 0 lists the classes: each round takes the first GPU row
      // not yet listed and marks every row whose request has its bits
      const int lane = t;
      bool todo[2];
      int8_t mine[2] = {-1, -1};
      for (int h = 0; h < 2; ++h) {
        const int r = lane + 32 * h;
        todo[h] = r < nrows && (s_cls[r] & GPU_ROW);
      }
      int n = 0;
      for (; n < MAX_CLASSES; ++n) {
        const unsigned b0 = __ballot_sync(0xffffffffu, todo[0]);
        const unsigned b1 = __ballot_sync(0xffffffffu, todo[1]);
        if (!(b0 | b1)) break;
        const int first = b0 ? __ffs(b0) - 1 : 32 + __ffs(b1) - 1;
        for (int h = 0; h < 2; ++h) {
          const int r = lane + 32 * h;
          if (todo[h] &&
              __float_as_uint(s_req[r][0]) ==
                  __float_as_uint(s_req[first][0]) &&
              __float_as_uint(s_req[r][1]) ==
                  __float_as_uint(s_req[first][1]) &&
              __float_as_uint(s_req[r][2]) ==
                  __float_as_uint(s_req[first][2])) {
            mine[h] = (int8_t)n;
            todo[h] = false;
          }
        }
        if (lane < 3) s_creq[n][lane] = s_req[first][lane];
      }
      for (int h = 0; h < 2; ++h)
        if (lane + 32 * h < MAX_ROWS) s_class[lane + 32 * h] = mine[h];
      if (lane == 0) s_classes = n;
    }
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int k = t; k < nodes; k += THREADS) {
      const size_t n = (size_t)(nb + k);
      int vn = 0;
      float pf[3] = {0.0f, 0.0f, 0.0f};
      for (int i = 0; i < I; ++i) {
        const bool v = sp.vb[(size_t)i * tile + k] != 0;
        vn += v;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          float* fe = sp.fe + ((size_t)i * 3 + d) * tile + k;
          const float f = *fe;
          pf[d] = __fadd_rn(pf[d], __fmul_rn(f, v ? 1.0f : 0.0f));
          *fe = v ? __fadd_rn(f, a.eps) : koord_rows::kNaN();
        }
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float pt = __fmul_rn(a.total[n * 3 + d], (float)vn);
        sp.pa[d * tile + k] = __fsub_rn(pt, pf[d]);
        sp.pm[d * tile + k] = fmaxf(pt, 1e-9f);
      }
      sp.mem[k] = __float_as_uint(a.total[n * 3 + 1]);
      sp.midx[k] = -1;
    }
    // the distinct memories: each round lists the first unlisted node's
    // memory and marks every node that has its bits
    for (; n_mems < MAX_MEMS; ++n_mems) {
      if (t == 0) s_first = INT_MAX;
      __syncthreads();
      int cand = INT_MAX;
      for (int k = t; k < nodes; k += THREADS)
        if (sp.midx[k] < 0) cand = min(cand, k);
      cand = __reduce_min_sync(0xffffffffu, cand);
      if ((t & 31) == 0 && cand != INT_MAX) atomicMin(&s_first, cand);
      __syncthreads();
      const int first = s_first;
      if (first == INT_MAX) break;
      const unsigned bits = sp.mem[first];
      for (int k = t; k < nodes; k += THREADS)
        if (sp.midx[k] < 0 && sp.mem[k] == bits) sp.midx[k] = (int8_t)n_mems;
      if (t == 0) s_mems[n_mems] = bits;
      __syncthreads();
    }
    const int n_classes = s_classes;
    for (int k = t; k < n_classes * n_mems; k += THREADS) {
      const int q = k / n_mems, m = k % n_mems;
      s_at[q][m] = request_at(__uint_as_float(s_mems[m]), s_creq[q][0],
                              s_creq[q][1], s_creq[q][2]);
    }
  }
  if (any_aux) {
    for (int k = t; k < nodes * 2; k += THREADS) {
      const size_t o = ((size_t)nb * 2 + k) * J;
      float m = -INFINITY;
#pragma unroll 8
      for (int j = 0; j < J; ++j)
        if (a.aux_valid[o + j]) m = fmaxf(m, a.aux_free[o + j]);
      sp.ax[(k % 2) * tile + k / 2] = __fadd_rn(m, a.eps);
    }
  }
  __syncthreads();

  // 3. each request class's verdicts and scores, once a (class, node):
  //    thread t takes nodes k0..k0+3 of every rpi-th class (and then of
  //    every rpi-th row)
  const int spans = tile / SPAN, rpi = THREADS / spans;
  const int k0 = SPAN * (t % spans), rl = t / spans;
  const int cnt = min(SPAN, nodes - k0);
  int8_t midx[SPAN] = {0, 0, 0, 0};
  const int n_classes = any_gpu ? s_classes : 0;
  if (n_classes > 0 && cnt > 0) {
#pragma unroll
    for (int j = 0; j < SPAN; ++j) midx[j] = sp.midx[k0 + j];
    for (int q = rl; q < n_classes; q += rpi) {
      Req r4[SPAN];
#pragma unroll
      for (int j = 0; j < SPAN; ++j)
        r4[j] = midx[j] >= 0
                    ? s_at[q][midx[j]]
                    : request_at(__uint_as_float(sp.mem[k0 + j]),
                                 s_creq[q][0], s_creq[q][1], s_creq[q][2]);
      float out[SPAN];
      sp.cok[q * spans + k0 / SPAN] =
          (uint8_t)gpu_terms(sp, tile, I, k0, a.least, r4, out);
      *reinterpret_cast<float4*>(sp.csc + q * tile + k0) =
          make_float4(out[0], out[1], out[2], out[3]);
    }
  }
  __syncthreads();

  // 4. the pairs: one mask word in (the next row's loaded before this
  //    one computes); a row without a device request passes everywhere
  //    and only stores its zero scores (and, without a mask, the trues);
  //    the others copy their class's terms or compute their own, then
  //    the aux gate; one word and one float4 out
  if (cnt <= 0) return;
  const float zero[SPAN] = {0.0f, 0.0f, 0.0f, 0.0f};
  auto span = [&](int r) {
    return koord_rows::span_of((size_t)koord_rows::row_of(r) * a.N + nb + k0,
                               cnt, a.ok, a.score);
  };
  auto reads = [&](int r) { return r < nrows && a.and_in && s_cls[r]; };
  unsigned in_next =
      reads(rl) ? koord_rows::load_mask(a.ok, span(rl)) : ONES;
  for (int r = rl; r < nrows; r += rpi) {
    const Span sr = span(r);
    const unsigned in = in_next;
    in_next = reads(r + rpi) ? koord_rows::load_mask(a.ok, span(r + rpi))
                             : ONES;
    const int c = s_cls[r];
    if (!c) {
      if (!a.and_in) koord_rows::store_mask(a.ok, sr, ONES);
      if (a.score) koord_rows::store_score(a.score, sr, zero);
      continue;
    }
    unsigned okbits = (1u << SPAN) - 1;
    float out[SPAN] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (c & GPU_ROW) {
      const int q = s_class[r];
      if (q >= 0) {
        okbits = sp.cok[q * spans + k0 / SPAN];
        koord_rows::load4(sp.csc + q * tile + k0, out);
      } else {
        // a row past the class list computes its own terms
        Req r4[SPAN];
#pragma unroll
        for (int j = 0; j < SPAN; ++j)
          r4[j] = request_at(__uint_as_float(sp.mem[k0 + j]), s_req[r][0],
                             s_req[r][1], s_req[r][2]);
        okbits = gpu_terms(sp, tile, I, k0, a.least, r4, out);
      }
    }
    if (c & AUX_ROW) {
      const float x0 = s_areq[r][0], x1 = s_areq[r][1];
      float ax0[SPAN], ax1[SPAN];
      koord_rows::load4(sp.ax + k0, ax0);
      koord_rows::load4(sp.ax + tile + k0, ax1);
#pragma unroll
      for (int j = 0; j < SPAN; ++j) {
        const bool aux_ok = (x0 <= 0.0f || ax0[j] >= x0) &&
                            (x1 <= 0.0f || ax1[j] >= x1);
        okbits &= ~((unsigned)!aux_ok << j);
      }
    }
    koord_rows::store_mask(a.ok, sr, koord_rows::and_word(in, okbits));
    if (a.score) koord_rows::store_score(a.score, sr, out);
  }
}

}  // namespace

// ptr: gpu_req [P, 3] (core, memory, memory ratio), gpu_total [N, 3],
// gpu_free [N, I, 3], gpu_valid [N, I], and_in [P, N] (null, or pair_ok
// itself: the mask ANDed in place), pair_ok [P, N], pair_score [P, N]
// (null where I = 0), aux_req [P, 2], aux_free [N, 2, J], aux_valid [N,
// 2, J] (unread where J = 0). least: 1 for "least", 0 for "most"; eps:
// the gate tolerance. I = 0 runs the aux part alone, J = 0 the GPU part
// alone.
extern "C" int koord_device_pair_terms(const void* const* ptr, int P, int N,
                                       int I, int J, int least, float eps,
                                       void* stream) {
  if (P <= 0 || N <= 0) return 0;
  if (I < 0 || I > MAX_I || J < 0 || J > MAX_J || I + J == 0 ||
      (I > 0 && ptr[6] == nullptr) ||
      (ptr[4] != nullptr && ptr[4] != ptr[5]))
    return (int)cudaErrorInvalidValue;
  // fe, pa, pm, ax, mem, the classes' scores (4 bytes each), the
  // classes' verdict bits (a byte a span), valid, the memory index
  const int per_node =
      4 * (3 * I + 9 + MAX_CLASSES) + MAX_CLASSES / SPAN + I + 1;
  const int statics = MAX_ROWS * 22 + MAX_CLASSES * (12 + MAX_MEMS *
                                                     (int)sizeof(Req)) + 64;
  const int tile = koord_rows::tile_nodes(per_node, 48 * 1024 - statics);
  const long long tiles = (N + tile - 1) / tile;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const int rows = koord_rows::rows_per_block(P, tiles);
  const dim3 grid((P + rows - 1) / rows, (unsigned)tiles);
  Args a;
  a.gpu_req = (const float*)ptr[0];
  a.total = (const float*)ptr[1];
  a.free_ = (const float*)ptr[2];
  a.valid = (const uint8_t*)ptr[3];
  a.and_in = ptr[4] != nullptr;
  a.ok = (uint8_t*)ptr[5];
  a.score = I > 0 ? (float*)ptr[6] : nullptr;
  a.aux_req = (const float*)ptr[7];
  a.aux_free = (const float*)ptr[8];
  a.aux_valid = (const uint8_t*)ptr[9];
  a.P = P;
  a.N = N;
  a.I = I;
  a.J = J;
  a.least = least;
  a.tile = tile;
  a.eps = eps;
  const size_t shared = (size_t)tile * per_node;
  device_pair_terms_kernel<<<grid, THREADS, shared, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}
