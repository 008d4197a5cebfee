"""Where the slim flagship's (or BASELINE config 2's, gpu_share's, the
full gate's, BASELINE config 5's or the guarded cycle's) time goes on
the card.

    python -m koordinator_tpu_torch.profile_flagship
        [--workload flagship|config2|gpushare|fullgate|descheduler|
                    descheduler_capped|guarded]
        [--out chiprun_out/profile_<workload>.json]
    python -m koordinator_tpu_torch.profile_flagship --summarize FILE...

Builds the kernels, runs the workload (the 100k x 10k slim flagship;
config 2: 10k pods x 1k nodes on the NUMA path; gpu_share_100kx10k,
the DeviceShare path with NUMA, taints, reservation slots and the pod
topology groups; or score_bind_100k_pods_10k_nodes_full_gate, the same
pods packed, with the cascade and the packing prefixes) once to warm up and once untraced, then traces one
more run of the same size with torch.profiler recording device
activity only (no host-side operator
events), so the traced wall time stays close to the untraced one. It
prints, and writes as JSON to `--out`: the untraced run, the traced
run's wall time, the device's busy time (the union of its kernels'
intervals), idle share and number of device activities (kernels,
copies, memsets), and the device time and launch
count of every kernel name, largest first. The descheduler workloads
are BASELINE config 5 at 10 000 nodes (`configs.run_config_5_descheduler`,
plain or capped); each run holds two plans, its warm one and its timed
one. The guarded workload is `configs.guarded_cycle` (steps 2-5 of
`run_guarded_cycles` at 10 000 nodes, ten batches) on inputs built
once, untimed. On the full gate one more traced run records host and device
activity with the plain-torch parts that have no kernel of their own
under `torch.profiler.record_function` ranges (`domains.round_terms`,
`reservation.slot_columns` and the tail's `tail_select` with its
topology budget): their calls a run and the device time of the kernels
launched inside them. Every report also sums the device time and
launches of each of the port's scheduler kernels (`PORT_KERNELS`, by
symbol) and of the memsets; `--summarize` prints those sums, with each
report's untraced `value`, busy time, idle share and activity count, for
reports already written (a parent tree's too). Needs a CUDA card, but
not to summarize.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from koordinator_tpu_torch.configs import (
    card_name_and_power_limit,
    guarded_cycle,
    guarded_cycle_inputs,
    run_config_2_numa,
    run_config_5_descheduler,
    run_full_gate,
    run_gpu_share,
)
from koordinator_tpu_torch.flagship import run_northstar
from koordinator_tpu_torch.kernels.build import build_all
from koordinator_tpu_torch.scheduler import core

# the full gate's plain-torch parts measured under ranges: (range name,
# the function's name in scheduler/core.py, where its call sites look
# it up)
RANGES = (("domains.round_terms", "round_terms"),
          ("reservation.slot_columns", "slot_columns"),
          ("core.tail_select (select and topology budget)", "tail_select"))

# the port's scheduler kernels by symbol fragment (K7's with the
# symbols of its earlier two-kernel take, so that an older tree's report
# sums the same way), and the memsets
PORT_KERNELS = (
    ("K1 score_topk", ("score_topk_kernel",)),
    ("K2 segment_prefix_chain", ("segment_prefix_chain_kernel",)),
    ("K2 order_switch", ("order_switch_kernel",)),
    ("K3 ordered_scatter_add", ("ordered_scatter_add_kernel",)),
    ("K4 numa_pair_terms", ("numa_pair_terms_kernel",)),
    ("K5 topology_admit", ("topology_admit_kernel",)),
    ("K6 device_pair_terms", ("device_pair_terms_kernel",)),
    ("K7 gpu_instance_pick", ("gpu_choose_kernel", "gpu_shared_taken_kernel",
                              "gpu_take_kernel")),
    ("K8 topology_prefix_gate", ("topology_prefix_kernel",)),
    ("K9 stage1_mask", ("stage1_mask_kernel",)),
    ("K17 aux_instance_pick", ("aux_instance_pick_kernel",)),
    ("memsets", ("Memset",)))


# a run's placement counts, which a kernel change must not move
PLACEMENT_KEYS = ("placed", "gpu_pods_placed", "numa_bound_placed",
                  "slot_consumers", "once_slots_taken", "spread_placed",
                  "anti_placed", "aff_placed", "stragglers_after_sweep",
                  "stragglers_final", "never_retried")


def kernel_totals(kernels_by_device_time) -> dict:
    """{label: {device_us, launches}} of PORT_KERNELS over a report's
    `kernels_by_device_time` rows."""
    out = {}
    for label, frags in PORT_KERNELS:
        rows = [k for k in kernels_by_device_time
                if any(f in k["name"] for f in frags)]
        out[label] = {"device_us": sum(k["device_us"] for k in rows),
                      "launches": sum(k["launches"] for k in rows)}
    return out


def summarize(paths) -> dict:
    """{path: the untraced value and placements, the traced run's busy
    time, idle share and activities, and `kernel_totals`} of written
    reports."""
    out = {}
    for path in paths:
        with open(path) as f:
            r = json.load(f)
        t = r["traced_run"]
        line = r["untraced_run"]
        out[path] = {
            "card": r.get("card"),
            "value": line.get("value"),
            "placements": {k: line[k] for k in PLACEMENT_KEYS if k in line},
            "device_busy_us": t["device_busy_us"],
            "device_idle_share": t["device_idle_share"],
            "device_activities": t["device_activities"],
            "port_kernels": kernel_totals(r["kernels_by_device_time"])}
    return out


def _busy_us(events) -> float:
    """Microseconds during which at least one kernel ran on the device."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _ranged(name, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


def range_times(run) -> list:
    """One traced run with host and device activity and each of RANGES
    wrapped in a record_function range: [{range, device_us, calls}]."""
    saved = {attr: getattr(core, attr) for _, attr in RANGES}
    try:
        for name, attr in RANGES:
            setattr(core, attr, _ranged(name, saved[attr]))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        for attr, fn in saved.items():
            setattr(core, attr, fn)
    # the host-side range events (the device-side annotation of a range
    # spans its gaps too): each one's device time is that of the kernels
    # launched inside it
    totals = {name: [0.0, 0] for name, _ in RANGES}
    for e in prof.events():
        if e.name in totals and e.device_type == \
                torch.autograd.DeviceType.CPU:
            totals[e.name][0] += (getattr(e, "device_time_total", None)
                                  or getattr(e, "cuda_time_total", 0.0))
            totals[e.name][1] += 1
    return [{"range": name, "device_us": t, "calls": c}
            for name, (t, c) in totals.items()]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=(
        "flagship", "config2", "gpushare", "fullgate", "descheduler",
        "descheduler_capped", "guarded"), default="flagship")
    ap.add_argument("--out", default=None,
                    help="default chiprun_out/profile_<workload>.json")
    ap.add_argument("--summarize", nargs="+", metavar="FILE",
                    help="print the sums of written reports and exit")
    args = ap.parse_args()
    if args.summarize:
        print(json.dumps(summarize(args.summarize), indent=1))
        return
    out = args.out or f"chiprun_out/profile_{args.workload}.json"
    if args.workload == "flagship":
        warm_up = functools.partial(run_northstar, device="cuda", snap_seed=0)
        run = functools.partial(run_northstar, device="cuda", snap_seed=7)
    elif args.workload == "config2":
        warm_up = run = functools.partial(run_config_2_numa, device="cuda")
    elif args.workload == "gpushare":
        warm_up = run = functools.partial(run_gpu_share, device="cuda")
    elif args.workload.startswith("descheduler"):
        warm_up = run = functools.partial(
            run_config_5_descheduler, args.workload == "descheduler_capped",
            device="cuda")
    elif args.workload == "guarded":
        inputs = {}

        def run():
            if not inputs:
                inputs.update(guarded_cycle_inputs(device="cuda"))
            seconds, result = guarded_cycle(inputs)
            return {"metric": "guarded_cycles_10k", "value": seconds}, result
        warm_up = run
    else:
        def run():
            line, result, _ = run_full_gate(device="cuda")
            return line, result
        warm_up = run
    if not torch.cuda.is_available():
        raise SystemExit("profile_flagship: no CUDA device")
    card = card_name_and_power_limit()
    build_all()
    warm_up()
    untraced, _ = run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        line, _ = run()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise SystemExit("profile_flagship: the trace holds no device "
                         "activity")
    busy = _busy_us(kernels)
    by_name = {}
    for e in kernels:
        agg = by_name.setdefault(e.name, [0.0, 0])
        agg[0] += e.time_range.end - e.time_range.start
        agg[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    ranges = range_times(run) if args.workload == "fullgate" else None
    report = {
        "workload": args.workload,
        "card": card,
        "untraced_run": untraced,
        "traced_run": {"line": line,
                       "wall_us": wall_us, "device_busy_us": busy,
                       "device_idle_share": 1.0 - busy / wall_us,
                       "device_activities": len(kernels)},
        "kernels_by_device_time": [
            {"name": n[:120], "device_us": t, "launches": c}
            for n, (t, c) in top],
    }
    report["port_kernels"] = kernel_totals(report["kernels_by_device_time"])
    if ranges is not None:
        report["ranges"] = ranges
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
