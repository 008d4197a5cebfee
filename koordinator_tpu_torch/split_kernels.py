"""Where a K4, K6, K8 or K9 launch spends its time, on the card.

    python -m koordinator_tpu_torch.split_kernels --tree DIR
        [--kernels k4,k6] [--reps 10]

DIR is a checkout of the commit whose designs are split: commit 9b830cd
for K4 and K6 (the default `--kernels k4,k6`), commit f792110 for K8 and
K9 (`--kernels k8,k9`). The script builds copies of each parent source
under `build/split/`, every kernel and C entry renamed so that the copies
and this tree's kernels load side by side:

- `asis`: the source unchanged;
- `stamped`: a barrier at each phase boundary below, after which thread
  0 of the block writes clock64() (and %globaltimer at its first and
  last stamp) to a device array; K4's and K6's pod loops are cut into
  one loop a phase, each pod's values kept in registers between them;
- ablated copies, for timing only: `nostore` (K9: each verdict folded
  into a register instead of stored), `boundonly` (K4: the rows that are
  not NUMA-bound skipped), `deviceonly` (K6: no work on the rows without
  a device request).

K4's phases (9b830cd: a block 256 nodes x 16 pods, one byte a store): 1
staging the zone rows, 2 the mask loads, 3 the zone loop, 4 the stores;
this tree's: 1 the rows' classes and the tile's policies, 2 staging, 3
the pairs (the last thread's end). K6's (9b830cd: 128 nodes x 16 pods):
1 staging, 2 per_instance, 3 the instance fits, 4 the pool score (and
the aux part), 5 the stores; this tree's: 1 the rows' classes, 2
staging and the request classes' and memories' lists, 3 each request
class's terms, 4 the pairs. K8's phases: 1 the opener
column's count reduction, 2 classifying the gated pods, 3 classifying
the charging pods, 4 the block scan and the compaction, 5 the count
loop, 6 the compare, 7 the scratch write, 8 the fence and the ticket, 9
the last block's merge. K9's: 1 the pods' terms (the request rows and
the device term, quota ceiling and table rows of 16 pods), 2 the node
loads (waited for), 3 the pair loop and its stores.

Shapes are `chip_smoke.py`'s. K4 and K6 at the full gate's first packed
chunk (P = 2000 of 100 000 pods, N = 10 000), on the numa prefix's rows
and the gpu prefix's rows ANDing into K9's mask (`chip_smoke.
prefix_state`), with each prefix's row classes; then the parent's copy
beside this tree's kernel at every other shape of their PERF.md rows
(config 2, N = 10 000, Z = 8; the gpu_share chunk, I = 56). K8 at a
gpu_share step (P = 2000, 56 group columns) and at the full gate's first
packed chunk on its topo_prefix rows (P = 384); K9 at the full gate's
chunk (P = 2000, N = 10 000, F = 4, taints). Each copy that is not
ablated is checked against the plain version. The script prints, a shape
at a time, one JSON line: each copy's device time (torch.profiler,
`chip_smoke.device_ms`), this tree's kernel through its wrapper, and per
phase the mean and largest cycles a block over --reps stamped launches,
with the SM clock the stamps imply. It prints each build's registers
(ptxas) and, for K4 and K6, the static SASS size of each loop of the
parent's and this tree's kernels (`cuobjdump -sass`: the instructions
from a loop's label to its backward branch). The lines also go to
`chiprun_out/split_kernels.json`. Needs a CUDA card and nvcc; run from
this tree's root.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess

import torch

import chip_smoke as cs
from koordinator_tpu_torch.configs import card_name_and_power_limit
from koordinator_tpu_torch.kernels import _launch
from koordinator_tpu_torch.kernels.build import NVCC_FLAGS, ROOT, TOOLCHAIN
from koordinator_tpu_torch.kernels.device_terms import (
    device_pair_terms,
    device_pair_terms_plain,
)
from koordinator_tpu_torch.kernels.numa_terms import (
    STRATEGIES,
    numa_pair_terms,
    numa_pair_terms_plain,
)
from koordinator_tpu_torch.kernels.stage1 import stage1_mask, stage1_mask_plain
from koordinator_tpu_torch.kernels.topology_prefix import (
    launch_floor,
    topology_prefix_gate,
    topology_prefix_gate_plain,
)
from koordinator_tpu_torch.scheduler import domains
from koordinator_tpu_torch.scheduler.batching import EPS
from koordinator_tpu_torch.scheduler.cascade import static_gate_terms
from koordinator_tpu_torch.scheduler.plugins import deviceshare, loadaware

SLOTS = 16  # stamps a block: phases 0-13, start ns at 14, end ns at 15
MAX_BLOCKS = 16384
OUT = os.path.join(ROOT, "chiprun_out", "split_kernels.json")

HEADER = r"""
__device__ long long KOORD_SPLIT[{slots} * {blocks}];
__device__ __forceinline__ long long koord_ns() {{
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
#define SPLIT_AT(k, v) \
  KOORD_SPLIT[(blockIdx.y * gridDim.x + blockIdx.x) * {slots} + (k)] = (v)
#define SPLIT_BEGIN() \
  if (threadIdx.x == 0) {{ SPLIT_AT(0, clock64()); SPLIT_AT(14, koord_ns()); }}
#define SPLIT(k) \
  __syncthreads(); \
  if (threadIdx.x == 0) {{ SPLIT_AT(k, clock64()); SPLIT_AT(15, koord_ns()); }}
#define SPLIT_SINK(x) \
  if (__float_as_uint(x) == 0x7fc00123u) SPLIT_AT(13, 1)
#define SPLIT_LAST(k) \
  atomicMax((unsigned long long*)&KOORD_SPLIT[(blockIdx.y * gridDim.x + \
            blockIdx.x) * {slots} + (k)], (unsigned long long)clock64()); \
  atomicMax((unsigned long long*)&KOORD_SPLIT[(blockIdx.y * gridDim.x + \
            blockIdx.x) * {slots} + 15], (unsigned long long)koord_ns())
"""

FOOTER = r"""
extern "C" int koord_split_read_{v}(void* dst, long long bytes) {{
  return (int)cudaMemcpyFromSymbol(dst, KOORD_SPLIT, bytes);
}}
extern "C" int koord_split_clear_{v}() {{
  void* p;
  cudaGetSymbolAddress(&p, KOORD_SPLIT);
  return (int)cudaMemset(p, 0, sizeof(KOORD_SPLIT));
}}
"""

# (the line a stamp goes before, the stamp), for the f792110 sources
# ("parent") and this tree's ("tree")
_SINK_K8 = ("  {\n    float split_s = 0.0f;\n#pragma unroll\n"
            "    for (int k = 0; k < ITEMS; ++k)\n"
            "      split_s += (float)(mine.seg[k] + mine.rank[k] + "
            "mine.charge[k] + mine.gated[k]);\n"
            "    SPLIT_SINK(split_s);\n  }\n")
K8_STAMPS = {
    "parent": (
        ("  const int t = threadIdx.x;\n", "  SPLIT_BEGIN();\n"),
        ("  // 1. a pod's segment, charge and gate", "  SPLIT(1);\n"),
        ("    for (int c0 = 0; c0 < P; c0 += MAX_P) {", "    SPLIT(2);\n"),
        ("      Scan(tmp.scan).ExclusiveSum(cnt, off, n);",
         "      SPLIT(3);\n"),
        ("      // 3. each gated pod against", "      SPLIT(4);\n"),
        ("      __syncthreads();  // s_seg, s_rank", "      SPLIT(5);\n"),
        ("    // this tile's failures to scratch", "    SPLIT(6);\n"),
        ("  // 4. the last block merges", "  SPLIT(7);\n"),
        ("  if (!s_last) return;", "  SPLIT(8);\n"),
        ("  if (t == 0) *a.ticket = 0;", "  SPLIT(9);\n")),
    "tree": (
        ("  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;\n",
         "  SPLIT_BEGIN();\n"),
        ("  Tile mine;\n", "  SPLIT(1);\n"),
        ("  int before[ITEMS] = {};\n", _SINK_K8 + "  SPLIT(2);\n"),
        ("    const int n = *n_at, ng = s_n[2];", "    SPLIT(3);\n"),
        ("  float total = 0.0f;\n", "  SPLIT(4);\n"),
        ("  // the merge: every block adds", "  SPLIT(5);\n"),
        ("  const int npods = min(TILE, a.P - gbase);", "  SPLIT(6);\n"),
        ("}\n\n// The launch floor", "  SPLIT(7);\n"))}
K9_STAMPS = {
    "parent": (
        ("  const int t = threadIdx.x;\n", "  SPLIT_BEGIN();\n"),
        ("  const int n = n0 + t;\n", "  SPLIT(1);\n"),
        ("  for (int i = 0; i < PODS; ++i) {\n",
         "  {\n    float split_s = (float)(label + tg + stale + ok_usage + "
         "ok_prod + sched);\n#pragma unroll\n    for (int f = 0; f < MAX_F; "
         "++f) split_s += rq[f] + al[f];\n    SPLIT_SINK(split_s);\n  }\n"
         "  SPLIT(2);\n"),
        ("}\n\n}  // namespace", "  SPLIT(3);\n")),
    "tree": (
        ("  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;\n",
         "  SPLIT_BEGIN();\n"),
        ("  // 2. the pods' terms (warps 0-1)", "  SPLIT(1);\n"),
        ("  if (n0 >= N) return;\n", "  SPLIT(2);\n"),
        ("}\n\ntemplate <int FK, bool WORDS>\nint launch(",
         "  SPLIT(3);\n"))}
K9_NOSTORE = (
    ("  for (int i = 0; i < PODS; ++i) {\n", "  unsigned split_acc = 0u;\n"),
    ("}\n\n}  // namespace",
     "  if (split_acc == 0x9e3779b9u) a.out[n] = 2;\n"))
K8_PHASES = {
    "parent": ("opener sum", "classify gated", "classify charging",
               "scan + compaction", "count loop", "compare", "scratch write",
               "fence + ticket", "last block merge"),
    "tree": ("first-level loads, barrier", "classify, gated list",
             "charging list, opener total, barrier",
             "count loop (base loads in flight)", "compare",
             "barrier", "tallies (atomic with return) + verdicts")}
K9_PHASES = {
    "parent": ("pod terms", "node loads (waited for)", "pair loop + stores"),
    "tree": ("loads (nodes, pods), barrier",
             "pod terms | gate words, barrier", "pair loop + stores")}


# K4 and K6 (9b830cd): the pod loop of the stamped copy, one loop a
# phase, from the parent's `if (n >= N) return;` to the kernel's end;
# @ZONES@ is the parent's own zone loop
K4_LOOP = r"""  SPLIT(1);
  const bool live = n < N;
  const bool none = live && s_policy_none[t];
  bool in_ok[PODS], res_ok[PODS];
  float res_sc[PODS];
#pragma unroll
  for (int i = 0; i < PODS; ++i)
    in_ok[i] = live && p0 + i < P &&
               (and_in == nullptr || and_in[(size_t)(p0 + i) * N + n]);
  SPLIT(2);
#pragma unroll
  for (int i = 0; i < PODS; ++i) {
    res_ok[i] = false;
    res_sc[i] = 0.0f;
    if (!live || p0 + i >= P) continue;
    const float d0 = s_demand[i][0], d1 = s_demand[i][1];
    const bool sg = s_single[i];
@ZONES@    const bool zone_ok = any_fit || !sg;
    const bool policy_ok = none || (__fadd_rn(s_total[0][t], eps) >= d0
                                    && __fadd_rn(s_total[1][t], eps) >= d1);
    res_ok[i] = zone_ok && policy_ok;
    res_sc[i] = sg ? __fmul_rn(fminf(fmaxf(best, 0.0f), 1.0f), 100.0f)
                   : 0.0f;
  }
  SPLIT(3);
#pragma unroll
  for (int i = 0; i < PODS; ++i) {
    if (!live || p0 + i >= P) continue;
    const size_t o = (size_t)(p0 + i) * N + n;
    out_ok[o] = in_ok[i] && res_ok[i];
    out_score[o] = res_sc[i];
  }
  SPLIT(4);
"""
K6_LOOP = r"""  SPLIT(1);
  const bool live = n < N;
  bool gpu[PODS];
  koord_dev::PerInst pis[PODS];
#pragma unroll
  for (int j = 0; j < PODS; ++j) {
    const float core = s_req[j][0], mem = s_req[j][1], ratio = s_req[j][2];
    gpu[j] = live && p0 + j < P &&
             (core > 0.0f || mem > 0.0f || ratio > 0.0f);
    pis[j] = koord_dev::PerInst{0, {0.0f, 0.0f, 0.0f}};
    if (gpu[j]) pis[j] = koord_dev::per_instance(s_mem[t], core, mem, ratio);
  }
  SPLIT(2);
  bool oks[PODS];
#pragma unroll
  for (int j = 0; j < PODS; ++j) {
    oks[j] = true;
    if (!gpu[j]) continue;
    int n_fit = 0;
    for (int i = 0; i < I; ++i) {
      const float f3[3] = {s_free[i][0][t], s_free[i][1][t],
                           s_free[i][2][t]};
      n_fit += ((s_valid[t] >> i) & 1) &&
               koord_dev::covers(f3, pis[j].v, eps);
    }
    oks[j] = n_fit >= pis[j].count;
  }
  SPLIT(3);
  float scores[PODS];
#pragma unroll
  for (int j = 0; j < PODS; ++j) {
    scores[j] = 0.0f;
    if (gpu[j]) {
      const koord_dev::PerInst pi = pis[j];
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
      scores[j] = __fmul_rn(
          fminf(fmaxf(__fdiv_rn(s, fmaxf(wsum, 1.0f)), 0.0f), 1.0f),
          100.0f);
    }
    if (live && p0 + j < P)
      for (int a = 0; a < 2 && J > 0; ++a) {
        const float r = s_areq[j][a];
        oks[j] &= r <= 0.0f || __fadd_rn(s_aux_max[a][t], eps) >= r;
      }
  }
  SPLIT(4);
#pragma unroll
  for (int j = 0; j < PODS; ++j) {
    if (!live || p0 + j >= P) continue;
    const size_t o = (size_t)(p0 + j) * N + n;
    out_ok[o] = (and_in == nullptr || and_in[o]) && oks[j];
    if (out_score != nullptr) out_score[o] = scores[j];
  }
  SPLIT(5);
"""
_LOOP_FROM, _LOOP_TO = "  if (n >= N) return;\n", "}\n\n}  // namespace"
_K4_ZONES = ("    // the NUMA-bound pod's zone request",
             "    const bool zone_ok = any_fit || !sg;\n")
K4_BEGIN = (("  const int t = threadIdx.x;\n", "  SPLIT_BEGIN();\n"),)
K6_BEGIN = K4_BEGIN
K4_BOUNDONLY = (("    // the NUMA-bound pod's zone request",
                 "    if (!sg) continue;\n"),)
K6_DEVICEONLY = (("    bool ok = true;\n",
                  "    if (!(core > 0.0f || mem > 0.0f || ratio > 0.0f) &&\n"
                  "        !(J > 0 && (s_areq[j][0] > 0.0f ||\n"
                  "                    s_areq[j][1] > 0.0f)))\n"
                  "      continue;\n"),)
K4_TREE = (("  const int t = threadIdx.x, tile = a.tile, Z = a.Z;\n",
            "  SPLIT_BEGIN();\n"),
           ("  // 2. the tile's zone rows", "  SPLIT(1);\n"),
           ("  // 3. the pairs", "  SPLIT(2);\n"),
           ("}\n\n}  // namespace", "  SPLIT_LAST(3);\n"))
K6_TREE = (("  const int t = threadIdx.x, tile = a.tile, I = a.I, J = a.J;\n",
            "  SPLIT_BEGIN();\n"),
           ("  // 2. the tile's instances", "  SPLIT(1);\n"),
           ("  // 3. each request class", "  SPLIT(2);\n"),
           ("  // 4. the pairs", "  SPLIT(3);\n"),
           ("}\n\n}  // namespace", "  SPLIT_LAST(4);\n"))
K4_PHASES = {
    "parent": ("staging the zone rows", "mask loads", "zone loop", "stores"),
    "tree": ("row classes, tile policies", "staging",
             "pairs (last thread)")}
K6_PHASES = {
    "parent": ("staging", "per_instance", "instance fits",
               "pool score (and aux part)", "stores"),
    "tree": ("row classes", "staging, the classes' and memories' lists",
             "the request classes' terms", "pairs (last thread)")}


def between(src: str, start: str, end: str) -> str:
    """The text of src from `start` up to `end`, each occurring once."""
    if src.count(start) != 1 or src.count(end) != 1:
        raise SystemExit(f"split: {start!r} or {end!r} does not occur "
                         "exactly once")
    i = src.index(start)
    return src[i:src.index(end, i)]


def k4_stamped_source(src: str) -> str:
    """The 9b830cd K4 source with its pod loop cut into one loop a
    phase (K4_LOOP around its own zone loop)."""
    zones = between(src, *_K4_ZONES)
    loop = between(src, _LOOP_FROM, _LOOP_TO)
    return src.replace(loop, K4_LOOP.replace("@ZONES@", zones))


def k6_stamped_source(src: str) -> str:
    loop = between(src, _LOOP_FROM, _LOOP_TO)
    return src.replace(loop, K6_LOOP)

def insert_before(src: str, edits) -> str:
    """src with each edit's text put before its anchor, which must occur
    exactly once and start a line."""
    for anchor, text in edits:
        i = src.find("\n" + anchor) + 1
        if not i or src.count("\n" + anchor) != 1:
            raise SystemExit(f"split: anchor {anchor!r} does not start "
                             "exactly one line")
        src = src[:i] + text + src[i:]
    return src


def variant(src: str, kernel: str, v: str, edits=(),
            stamped=False) -> str:
    """A renamed copy of a kernel source: the kernel `kernel` and every
    C entry get the suffix _v; with `stamped` the split header and
    footer around it."""
    out = insert_before(src, edits)
    if "SPLIT_SINK" in out and "split_acc" in out:
        raise SystemExit("split: a copy is stamped or ablated, not both")
    out = re.sub(rf"\b{kernel}\b", f"{kernel}_{v}", out)
    out = re.sub(r"\b(koord_\w+)\(", rf"\1_{v}(", out)
    if "split_acc" in out:
        out = out.replace("    a.out[(size_t)p * a.N + n] = ok;\n",
                          "    split_acc = split_acc * 3u + ok;\n")
    if stamped:
        head = HEADER.format(slots=SLOTS, blocks=MAX_BLOCKS).replace(
            "KOORD_SPLIT", f"koord_split_{v}")
        foot = FOOTER.format(v=v).replace("KOORD_SPLIT", f"koord_split_{v}")
        at = out.index("namespace {")
        out = out[:at] + head + out[at:] + foot
    return out


def build(sources: dict) -> dict:
    """{name: ctypes.CDLL}: each source (text, or (text, include dir)
    for one that includes its tree's headers) compiled with the port's
    flags, all nvcc processes started together."""
    d = os.path.join(ROOT, "build", "split")
    os.makedirs(d, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        src, inc = src if isinstance(src, tuple) else (src, None)
        cu = os.path.join(d, name + ".cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(d, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [TOOLCHAIN.nvcc(), *NVCC_FLAGS, *(["-I", inc] if inc else []),
             "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"split: nvcc failed for {name}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"split build {name}: {regs}", flush=True)
        libs[name] = ctypes.CDLL(so)
    return libs


def k8_caller(lib, v, choice, trying, rank, fams):
    """f() launching the K8 copy `v` on these operands, and the output it
    writes: the f792110 design takes a columns x words scratch table and
    a ticket, this tree's its zeroed tallies."""
    p = choice.shape[0]
    dev = choice.device
    if hasattr(lib, f"koord_topology_prefix_tallies_{v}"):
        count = getattr(lib, f"koord_topology_prefix_tallies_{v}")
        count.argtypes, count.restype = [ctypes.c_int], ctypes.c_longlong
        scratch = [torch.zeros((count(p),), dtype=torch.int64, device=dev)]
    else:
        columns = sum(f.counts.shape[0] for f in fams)
        scratch = [torch.empty((columns * ((p + 31) // 32),),
                               dtype=torch.int32, device=dev),
                   torch.zeros((1,), dtype=torch.int32, device=dev)]
    out = torch.empty((p,), dtype=torch.bool, device=dev)
    ptrs, dims = [], [p, fams[0].dom_x.shape[1], len(fams)]
    for f in fams:
        ptrs += [f.dom_x.data_ptr(), f.counts.data_ptr(), f.charge.data_ptr(),
                 f.gate.data_ptr(),
                 f.lim.data_ptr() if f.lim is not None else None]
        dims += [f.counts.shape[0], f.counts.shape[1], f.kind]
    ptrs += [choice.data_ptr(), trying.data_ptr(), rank.data_ptr(),
             *(x.data_ptr() for x in scratch), out.data_ptr()]
    cptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    cdims = (ctypes.c_int * len(dims))(*dims)
    fn = getattr(lib, f"koord_topology_prefix_gate_{v}")
    fn.argtypes = [ctypes.c_void_p] * 3
    stream = _launch.stream(dev)

    def call():
        if fn(cptrs, cdims, stream):
            raise SystemExit(f"split: K8 {v} launch failed")
    call.keep = scratch  # the scratch lives as long as the launcher
    return call, out


def k9_caller(lib, v, args):
    """f() launching the K9 copy `v` on stage1_mask's operands, and the
    output it writes (the wrapper's C interface, unchanged)."""
    g, req, requested, alloc, anc, used, runtime, depth, eps = args
    p, f = req.shape
    n = g.label_group.shape[0]
    s, labels = g.selector_match.shape
    t, groups = g.tol_forbid.shape
    out = torch.empty((p, n), dtype=torch.bool, device=req.device)
    tensors = (g.selector_id, g.prod_gate, g.daemonset, g.device_ok,
               g.toleration_id, req, anc, g.label_group, g.node_ok,
               g.prod_node_ok, g.metric_fresh, g.schedulable, g.taint_group,
               requested, alloc, g.selector_match, g.tol_forbid, used,
               runtime, out)
    ptrs = (ctypes.c_void_p * len(tensors))(*(x.data_ptr() for x in tensors))
    dims = (ctypes.c_int * 10)(p, n, f, s, labels, t, groups, anc.shape[1],
                               depth, used.shape[0])
    fn = getattr(lib, f"koord_stage1_mask_{v}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                   ctypes.c_void_p]
    stream = _launch.stream(req.device)

    def call():
        if fn(ptrs, dims, eps, stream):
            raise SystemExit(f"split: K9 {v} launch failed")
    return call, out


def stamps(lib, v, call, reps):
    """Per phase k >= 1 the cycles from the block's previous stamp, over
    `reps` launches and every block that wrote stamp k; the SM clock
    (GHz) the blocks' cycles over their globaltimer spans imply; the
    median span (us) from the first block's start to the last's end."""
    read = getattr(lib, f"koord_split_read_{v}")
    read.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    clear = getattr(lib, f"koord_split_clear_{v}")
    host = (ctypes.c_longlong * (SLOTS * MAX_BLOCKS))()
    phases, cyc, ns, spans = {}, 0, 0, []
    for _ in range(reps):
        if clear():
            raise SystemExit("split: clear failed")
        call()
        torch.cuda.synchronize()
        if read(host, ctypes.sizeof(host)):
            raise SystemExit("split: read failed")
        starts, ends = [], []
        for b in range(MAX_BLOCKS):
            row = host[b * SLOTS:(b + 1) * SLOTS]
            if not row[0]:
                continue
            seen = [k for k in range(1, 13) if row[k]]
            prev = row[0]
            for k in seen:
                phases.setdefault(k, []).append(row[k] - prev)
                prev = row[k]
            if seen and row[15] > row[14]:
                cyc += row[seen[-1]] - row[0]
                ns += row[15] - row[14]
                starts.append(row[14])
                ends.append(row[15])
        spans.append((max(ends) - min(starts)) / 1e3)
    return ({k: (statistics.mean(x), max(x)) for k, x in phases.items()},
            cyc / ns if ns else None, statistics.median(spans))


def split_line(label, names, lib, v, call, reps, times):
    per, ghz, span = stamps(lib, v, call, reps)
    line = {"shape": label, "device_ms": times, "sm_ghz_from_stamps": ghz,
            "blocks_span_us_median": span,
            "phases_cycles": {names[k - 1]: {"mean_a_block": round(m, 1),
                                            "largest": mx}
                              for k, (m, mx) in sorted(per.items())}}
    print("split " + json.dumps(line), flush=True)
    return line


def copy_caller(lib, entry, dims, tensors, ctype_dims):
    """f() launching the kernel copy's C entry `entry` with a pointer
    array of `tensors` (None for a null pointer), then `dims` (ints,
    and the eps float) and the stream."""
    ptrs = (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] + ctype_dims + [ctypes.c_void_p]
    stream = _launch.stream(torch.device("cuda"))

    def call():
        if fn(ptrs, *dims, stream):
            raise SystemExit(f"split: {entry} launch failed")
    call.keep = tensors
    return call


def k4_copy(lib, v, a, mask):
    """(f, ok, score): the K4 copy `v` on numa_pair_terms' operands `a`,
    ANDing into `mask` in place (None: no mask)."""
    demand, single, cap, free_, valid, policy, strategy = a
    rows, (n, z, _) = demand.shape[0], cap.shape
    ok = mask if mask is not None else torch.empty(
        (rows, n), dtype=torch.bool, device=demand.device)
    score = torch.empty((rows, n), dtype=torch.float32, device=ok.device)
    call = copy_caller(
        lib, f"koord_numa_pair_terms_{v}",
        (rows, n, z, STRATEGIES.index(strategy), EPS),
        (demand, single, cap, free_, valid, policy, mask, ok, score),
        [ctypes.c_int] * 4 + [ctypes.c_float])
    return call, ok, score


def k6_copy(lib, v, a, mask):
    """(f, ok, score): the K6 copy `v` on device_pair_terms' operands
    (gpu_req, devices, strategy, aux_req) ANDing into `mask`."""
    g, d, strategy, aux = a
    rows, (n, i, _) = g.shape[0], d.gpu_free.shape
    j = d.aux_free.shape[2] if aux is not None else 0
    ok = mask if mask is not None else torch.empty(
        (rows, n), dtype=torch.bool, device=g.device)
    score = torch.empty((rows, n), dtype=torch.float32, device=ok.device)
    call = copy_caller(
        lib, f"koord_device_pair_terms_{v}",
        (rows, n, i, j, int(strategy == "least"), EPS),
        (g, d.gpu_total, d.gpu_free, d.gpu_valid, mask, ok, score, aux,
         d.aux_free if j else None, d.aux_valid if j else None),
        [ctypes.c_int] * 5 + [ctypes.c_float])
    return call, ok, score


def sass_loops(so: str, kernel: str) -> dict:
    """For each function of library `so` whose name holds `kernel`: its
    instruction count, its divisions' reciprocals (MUFU.RCP), stores,
    loads and barriers, and each loop as (first, last offset,
    instructions) from a backward branch's target to the branch."""
    tool = os.path.join(os.path.dirname(TOOLCHAIN.nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True).stdout
    found = {}
    for part in re.split(r"\n\s*Function : ", out)[1:]:
        name = part.split("\n", 1)[0].strip()
        if kernel not in name:
            continue
        insts, labels = [], {}
        for ln in part.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", ln)
            if lab:
                labels[lab.group(1)] = None
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", ln)
            if m:
                off = int(m.group(1), 16)
                for k, val in labels.items():
                    if val is None:
                        labels[k] = off
                insts.append((off, m.group(2).strip()))
        loops = []
        for off, text in insts:
            b = re.search(r"\bBRA(?:\.\w+)*\s+(?:`\((\.L_x_\d+)\)|"
                          r"(0x[0-9a-f]+))", text)
            if not b:
                continue
            target = labels.get(b.group(1)) if b.group(1) else int(
                b.group(2), 16)
            if target is not None and target <= off:
                loops.append((hex(target), hex(off), sum(
                    1 for o, _ in insts if target <= o <= off)))
        ops = [t.split()[0] if not t.startswith("@") else t.split()[1]
               for _, t in insts]
        found[name[:80]] = {
            "instructions": len(insts),
            "MUFU.RCP": sum(o.startswith("MUFU.RCP") for o in ops),
            "STG": sum(o.startswith("STG") for o in ops),
            "LDG": sum(o.startswith("LDG") for o in ops),
            "LDS": sum(o.startswith("LDS") for o in ops),
            "BAR": sum(o.startswith("BAR") for o in ops),
            "CALL": sum(o.startswith("CALL") for o in ops),
            "loops": loops}
    return found


def k46_shapes(dev, gen):
    """[(kernel, label, operands, mask, full-gate prefix?)] at the full
    gate's prefixes and every other shape of K4's and K6's PERF.md rows,
    printing the prefixes' row classes."""
    st = cs.prefix_state(dev, gen)
    base, rn, rg = st["mask"], st["prefixes"]["numa"], st["prefixes"]["gpu"]
    nodes, d, b = st["snap"].nodes, st["snap"].devices, st["batch"]
    classes = cs.prefix_row_classes(st)
    print("split row classes " + json.dumps(classes), flush=True)
    out = [("k4", f"K4 full gate numa prefix {rn} of {b.num_pods} rows, "
            f"N={nodes.numa_cap.shape[0]}, K9's mask",
            (st["demand"][:rn], b.numa_single[:rn], nodes.numa_cap,
             nodes.numa_free, nodes.numa_valid, nodes.numa_policy, "most"),
            base, True),
           ("k6", f"K6 full gate gpu prefix {rg} of {b.num_pods} rows, "
            f"N={d.gpu_free.shape[0]}, K9's mask",
            (st["gpu_req"][:rg], d, "least", None), base, True)]
    for label, n, z in (("cfg2 P=2000 N=1000 Z=2", 1000, 2),
                        ("P=2000 N=10000 Z=2", 10_000, 2),
                        ("Z=8 P=2000 N=1000", 1000, 8)):
        snap, pods = cs.numa_state(dev, gen, n, z)
        out.append(("k4", "K4 " + label,
                    cs.k4_args(snap, cs.slice_batch(pods, 0, 2000), "most"),
                    None, False))
    for label, n, gpus in (("gpu_share chunk P=2000 N=10000 I=8", 10_000, 8),
                           ("I=56 P=2000 N=1000", 1000, 56)):
        snap, batch = cs.gpu_state(dev, gen, n, 2000, 2000, False, gpus)
        mask = torch.rand((2000, n), generator=gen, device=dev) < 0.8
        out.append(("k6", f"K6 {label}, mask",
                    (cs.gpu_req_of(batch), snap.devices, "least", None),
                    mask, False))
    snap, batch, prefixes = cs.aux_state(dev)
    rows = prefixes["gpu"]
    g = cs.gpu_req_of(batch)[:rows].contiguous()
    a = deviceshare.aux_request(batch.requests)[:rows].contiguous()
    mask = torch.rand((batch.num_pods, snap.num_nodes), generator=gen,
                      device=dev) < 0.8
    out += [("k6", f"K6 aux full gate {rows} rows I=8 J=8, mask",
             (g, snap.devices, "least", a), mask, False),
            ("k6", f"K6 aux full gate {rows} rows without the aux part",
             (g, snap.devices, "least", None), mask, False)]
    return out


def run_k4_k6(args, lines) -> None:
    src = {}
    for tree, root in (("parent", args.tree), ("tree", ROOT)):
        csrc = os.path.join(root, "koordinator_tpu_torch", "csrc")
        for k, name in (("k4", "numa_terms"), ("k6", "device_terms")):
            with open(os.path.join(csrc, name + ".cu")) as f:
                src[k, tree] = (f.read(), csrc)
    kn = {"k4": "numa_pair_terms_kernel", "k6": "device_pair_terms_kernel"}
    stamped_parent = {"k4": k4_stamped_source, "k6": k6_stamped_source}
    begin = {"k4": K4_BEGIN, "k6": K6_BEGIN}
    tree_stamps = {"k4": K4_TREE, "k6": K6_TREE}
    ablated = {"k4": ("boundonly", K4_BOUNDONLY),
               "k6": ("deviceonly", K6_DEVICEONLY)}
    sources = {}
    for k in ("k4", "k6"):
        text, inc = src[k, "parent"]
        sources[f"{k}_asis"] = (variant(text, kn[k], "asis"), inc)
        name, edits = ablated[k]
        sources[f"{k}_{name}"] = (variant(text, kn[k], name, edits), inc)
        sources[f"{k}_parent"] = (variant(stamped_parent[k](text), kn[k],
                                          "parent", begin[k], stamped=True),
                                  inc)
        text, inc = src[k, "tree"]
        sources[f"{k}_tree"] = (variant(text, kn[k], "tree", tree_stamps[k],
                                        stamped=True), inc)
    libs = build(sources)
    for name in ("numa_terms", "device_terms"):
        path = TOOLCHAIN._target(name)
        if os.path.exists(path):   # rebuilt, so that ptxas reports it
            os.remove(path)
    TOOLCHAIN.build_all()
    sass = {}
    for k, name in (("k4", "numa_terms"), ("k6", "device_terms")):
        print(f"split build {name} (this tree): " + json.dumps(
            [ln.strip() for ln in TOOLCHAIN.ptxas[name].splitlines()
             if "registers" in ln or "spill" in ln]), flush=True)
        sass[f"{k} parent"] = sass_loops(
            os.path.join(ROOT, "build", "split", f"lib{k}_asis.so"), kn[k])
        sass[f"{k} tree"] = sass_loops(TOOLCHAIN._target(name), kn[k])
    print("split sass " + json.dumps(sass), flush=True)
    lines.append({"sass": sass})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)
    wrappers = {"k4": (numa_pair_terms, numa_pair_terms_plain),
                "k6": (lambda g, d, s, aux, m: device_pair_terms(
                           g, d, s, m, aux),
                       lambda g, d, s, aux, m: device_pair_terms_plain(
                           g, d, s, m, aux))}
    copy = {"k4": k4_copy, "k6": k6_copy}

    def same(got, want):
        return torch.equal(got[0], want[0]) and (
            want[1] is None or torch.equal(got[1].view(torch.int32),
                                           want[1].view(torch.int32)))

    def checked(k, v, a, mask, want, label):
        call, ok, score = copy[k](libs[f"{k}_{v}"], v, a,
                                  None if mask is None else mask.clone())
        call()
        torch.cuda.synchronize()
        if v != ablated[k][0] and not same((ok, score), want):
            raise SystemExit(f"split: {k} {v} ({label}) differs")
        return call

    # 1. the parent's copies at every shape first, so that their split
    #    stands even where this tree's kernel differs
    shapes = []
    for k, label, a, mask, prefix in k46_shapes(dev, gen):
        want = wrappers[k][1](*a, mask)
        names = ["asis"] + ([ablated[k][0], "parent"] if prefix else [])
        calls = {v: checked(k, v, a, mask, want, label) for v in names}
        times = {("parent stamped" if v == "parent" else "parent " + v):
                 cs.device_ms(calls[v], f"{kn[k]}_{v}") for v in names[1:]}
        if prefix:
            phases = K4_PHASES if k == "k4" else K6_PHASES
            lines.append(split_line(f"{label} (parent)", phases["parent"],
                                    libs[f"{k}_parent"], "parent",
                                    calls["parent"], args.reps, times))
        shapes.append((k, label, a, mask, prefix, want, calls))
    # 2. this tree's kernel, checked, beside the parent's in turns
    for k, label, a, mask, prefix, want, calls in shapes:
        wrap = wrappers[k][0]
        if not same(wrap(*a, None if mask is None else mask.clone()), want):
            raise SystemExit(f"split: this tree's {k} ({label}) differs")
        buf = None if mask is None else mask.clone()

        def tree_call():
            wrap(*a, buf)
        times = {}
        for key, fn, symbol in (
                ("parent 1", calls["asis"], f"{kn[k]}_asis"),
                ("tree 1", tree_call, kn[k]), ("tree 2", tree_call, kn[k]),
                ("parent 2", calls["asis"], f"{kn[k]}_asis")):
            times[key] = cs.device_ms(fn, symbol)
        if not prefix:
            line = {"shape": label, "device_ms": times}
            print("split " + json.dumps(line), flush=True)
            lines.append(line)
            continue
        call = checked(k, "tree", a, mask, want, label)
        times["tree stamped"] = cs.device_ms(call, f"{kn[k]}_tree")
        phases = K4_PHASES if k == "k4" else K6_PHASES
        lines.append(split_line(f"{label} (tree)", phases["tree"],
                                libs[f"{k}_tree"], "tree", call, args.reps,
                                times))


def run_k8_k9(args, lines) -> None:
    src = {}
    for tree, root in (("parent", args.tree), ("tree", ROOT)):
        csrc = os.path.join(root, "koordinator_tpu_torch", "csrc")
        for k, name in (("k8", "topology_prefix"), ("k9", "stage1_mask")):
            with open(os.path.join(csrc, name + ".cu")) as f:
                src[k, tree] = f.read()
    k8n, k9n = "topology_prefix_kernel", "stage1_mask_kernel"
    libs = build({
        "k8_asis": variant(src["k8", "parent"], k8n, "asis"),
        "k9_asis": variant(src["k9", "parent"], k9n, "asis"),
        "k9_nostore": variant(src["k9", "parent"], k9n, "nostore",
                              K9_NOSTORE),
        **{f"k8_{t}": variant(src["k8", t], k8n, t, K8_STAMPS[t],
                              stamped=True) for t in ("parent", "tree")},
        **{f"k9_{t}": variant(src["k9", t], k9n, t, K9_STAMPS[t],
                              stamped=True) for t in ("parent", "tree")}})
    for name in ("topology_prefix", "stage1_mask"):
        path = TOOLCHAIN._target(name)
        if os.path.exists(path):   # rebuilt, so that ptxas reports it
            os.remove(path)
    TOOLCHAIN.build_all()
    for name in ("topology_prefix", "stage1_mask"):
        print(f"split build {name} (this tree): " + json.dumps(
            [ln.strip() for ln in TOOLCHAIN.ptxas[name].splitlines()
             if "registers" in ln or "spill" in ln]), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2026)

    snap, batch = cs.gpu_state(dev, gen, 10_000, 8000, 2000)
    batch, topo, counts, _, lim = cs.topo_state(snap, batch, gen)
    choice, trying, rank = cs.k8_step(snap, batch, gen)
    k8_cases = [("K8 gpu_share step P=2000", choice, trying, rank,
                 domains.step_families(topo, counts, lim))]
    choice, trying, rank, fams, _ = cs.k8_full_gate_step(dev, gen)
    k8_cases.append((f"K8 full gate topo_prefix P={choice.shape[0]}",
                     choice, trying, rank, fams))
    for label, choice, trying, rank, fams in k8_cases:
        want = topology_prefix_gate_plain(choice, trying, rank, fams)
        times, calls = {}, {}
        for v in ("asis", "parent", "tree"):
            call, out = k8_caller(libs["k8_" + v], v, choice, trying, rank,
                                  fams)
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise SystemExit(f"split: K8 {v} ({label}) differs")
            times["parent" if v == "asis" else v + " stamped"] = \
                cs.device_ms(call, f"topology_prefix_kernel_{v}")
            calls[v] = call
        columns = sum(f.counts.shape[0] for f in fams)
        times["floor"] = cs.device_ms(
            lambda: launch_floor(choice.shape[0], columns, dev),
            "topology_prefix_floor_kernel")
        if not torch.equal(topology_prefix_gate(choice, trying, rank, fams),
                           want):
            raise SystemExit(f"split: this tree's K8 ({label}) differs")
        times["tree"] = cs.device_ms(
            lambda: topology_prefix_gate(choice, trying, rank, fams),
            "topology_prefix_kernel")
        for t in ("parent", "tree"):
            lines.append(split_line(f"{label} ({t})", K8_PHASES[t],
                                    libs["k8_" + t], t, calls[t], args.reps,
                                    times))

    cfg = loadaware.LoadAwareConfig.make(device=dev)
    snap, batch, _, _ = cs.fullgate_state(dev, gen, 10_000)
    gates = static_gate_terms(snap.nodes, batch, cfg, snap.devices)
    k9_args = cs.k9_args(snap, batch, gates, cs.FIT_DIMS)
    want = stage1_mask_plain(*k9_args)
    times, calls = {}, {}
    for v in ("asis", "nostore", "parent", "tree"):
        call, out = k9_caller(libs["k9_" + v], v, k9_args)
        call()
        torch.cuda.synchronize()
        if v != "nostore" and not torch.equal(out, want):
            raise SystemExit(f"split: K9 {v} differs")
        times[{"asis": "parent", "nostore": "parent without stores"}.get(
            v, v + " stamped")] = cs.device_ms(call, f"stage1_mask_kernel_{v}")
        calls[v] = call
    if not torch.equal(stage1_mask(*k9_args), want):
        raise SystemExit("split: this tree's K9 differs")
    times["tree"] = cs.device_ms(lambda: stage1_mask(*k9_args),
                                 "stage1_mask_kernel")
    for t in ("parent", "tree"):
        lines.append(split_line(f"K9 full-gate chunk P=2000 N=10000 F=4 ({t})",
                                K9_PHASES[t], libs["k9_" + t], t, calls[t],
                                args.reps, times))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--kernels", default="k4,k6",
                    choices=("k4,k6", "k8,k9"))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("split_kernels: needs a CUDA card")
    print(card_name_and_power_limit(), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    lines = []
    (run_k4_k6 if args.kernels == "k4,k6" else run_k8_k9)(args, lines)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(lines, f, indent=1)


if __name__ == "__main__":
    main()
