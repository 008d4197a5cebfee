"""Where a K8 and a K9 launch spend their time, on the card.

    python -m koordinator_tpu_torch.split_k8_k9 --tree DIR [--reps 10]

DIR is a checkout of commit f792110, whose `csrc/topology_prefix.cu`
(K8: one block a group column; classify, block scan, a serial count,
a columns x words scratch table merged by the last block) and
`csrc/stage1_mask.cu` (K9: a block 256 nodes x 16 pods, one byte a
store) are the designs this script splits. It builds three copies of
each source under `build/split/`, every kernel and C entry renamed so
that the copies and this tree's kernels load side by side:

- `asis`: the source unchanged;
- `stamped`: a barrier at each phase boundary below, after which thread
  0 of the block writes clock64() (and %globaltimer at its first and
  last stamp) to a device array;
- `nostore` (K9 only): each verdict folded into a register instead of
  stored, so that the stores' share shows as a difference in time.

K8's phases: 1 the opener column's count reduction, 2 classifying the
gated pods, 3 classifying the charging pods, 4 the block scan and the
compaction, 5 the count loop, 6 the compare, 7 the scratch write, 8
the fence and the ticket, 9 the last block's merge. K9's: 1 the pods'
terms (the request rows and the device term, quota ceiling and table
rows of 16 pods), 2 the node loads (waited for), 3 the pair loop and
its stores.

Shapes are `chip_smoke.py`'s: K8 at a gpu_share step (P = 2000, 56 group
columns) and at the full gate's first packed chunk on its topo_prefix
rows (P = 384); K9 at the full gate's chunk (P = 2000, N = 10 000, F = 4,
taints). Each copy is checked against the plain version. The script
prints, a shape at a time, one JSON line: each copy's device time
(torch.profiler, `chip_smoke.device_ms`), the empty kernel on K8's grid
(this tree's `launch_floor`), this tree's kernel through its wrapper,
and per phase the mean and largest cycles a block over --reps stamped
launches, with the SM clock the stamps imply. The lines also go to
`chiprun_out/split_k8_k9.json`. Needs a CUDA card and nvcc; run from
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
from koordinator_tpu_torch.kernels.stage1 import stage1_mask, stage1_mask_plain
from koordinator_tpu_torch.kernels.topology_prefix import (
    launch_floor,
    topology_prefix_gate,
    topology_prefix_gate_plain,
)
from koordinator_tpu_torch.scheduler import domains
from koordinator_tpu_torch.scheduler.cascade import static_gate_terms
from koordinator_tpu_torch.scheduler.plugins import loadaware

SLOTS = 16  # stamps a block: phases 0-13, start ns at 14, end ns at 15
MAX_BLOCKS = 16384
OUT = os.path.join(ROOT, "chiprun_out", "split_k8_k9.json")

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
    """{name: ctypes.CDLL}: each source compiled with the port's flags,
    all nvcc processes started together."""
    d = os.path.join(ROOT, "build", "split")
    os.makedirs(d, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = os.path.join(d, name + ".cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(d, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [TOOLCHAIN.nvcc(), *NVCC_FLAGS, "-o", so, cu],
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("split_k8_k9: needs a CUDA card")
    print(card_name_and_power_limit(), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
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
    lines = []

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
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(lines, f, indent=1)


if __name__ == "__main__":
    main()
