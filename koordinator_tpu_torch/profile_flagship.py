"""Where the slim flagship's (or BASELINE config 2's, gpu_share's or the
full gate's) time goes on the card.

    python -m koordinator_tpu_torch.profile_flagship
        [--workload flagship|config2|gpushare|fullgate]
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
count of each kernel name, largest first. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from koordinator_tpu_torch.configs import (
    run_config_2_numa,
    run_full_gate,
    run_gpu_share,
)
from koordinator_tpu_torch.flagship import run_northstar
from koordinator_tpu_torch.kernels.build import build_all


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=("flagship", "config2",
                                           "gpushare", "fullgate"),
                    default="flagship")
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
    else:
        def run():
            line, result, _ = run_full_gate(device="cuda")
            return line, result
        warm_up = run
    if not torch.cuda.is_available():
        raise SystemExit("profile_flagship: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
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
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
