"""Where the slim flagship's time goes on the card.

    python -m koordinator_tpu_torch.profile_flagship
        [--out chiprun_out/profile_flagship.json]

Builds the kernels, runs the 100k x 10k flagship once to warm up and
once untraced, then traces one more run of the same size with
torch.profiler recording device activity only (no host-side operator
events), so the traced wall time stays close to the untraced one. It
prints, and writes as JSON to `--out`: the untraced run, the traced
run's wall time, the device's busy time (the union of its kernels'
intervals), idle share and number of device activities (kernels,
copies, memsets), and the device time and launch
count of each kernel name, largest first. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

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
    ap.add_argument("--out", default="chiprun_out/profile_flagship.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_flagship: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    build_all()
    run_northstar(device="cuda", snap_seed=0)            # warm-up
    untraced, _ = run_northstar(device="cuda", snap_seed=7)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        line, _ = run_northstar(device="cuda", snap_seed=7)
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
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
