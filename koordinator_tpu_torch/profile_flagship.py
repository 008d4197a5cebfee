"""Where the slim flagship's (or BASELINE config 2's, gpu_share's, the
full gate's, BASELINE config 5's or the guarded cycle's) time goes on
the card.

    python -m koordinator_tpu_torch.profile_flagship
        [--workload flagship|config2|gpushare|fullgate|descheduler|
                    descheduler_capped|guarded]
        [--out chiprun_out/profile_<workload>.json]

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
launched inside them. Needs a CUDA card.
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
    args = ap.parse_args()
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
    if ranges is not None:
        report["ranges"] = ranges
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
