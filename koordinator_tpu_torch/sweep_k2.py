"""K2's device time against the share of pods trying, on the card.

    python -m koordinator_tpu_torch.sweep_k2 [--reps 3]

Builds the kernels and runs `chip_smoke.py`'s chained gate (node level
and 2 quota levels, P = 2000, the flagship's 4 fit dims) with 1 % to
100 % of the pods trying. Per share it prints one JSON line: the pods
in range at each level (the kernel sums a level without a sort up to
its SMALL threshold), the result's equality with the plain version,
and the kernel's device time from torch.profiler, best of --reps
traces of 20 launches each. Needs a CUDA card; run from the repo root.
"""

from __future__ import annotations

import argparse
import json

import torch

import chip_smoke
from koordinator_tpu_torch.configs import card_name_and_power_limit
from koordinator_tpu_torch.kernels.build import build_all
from koordinator_tpu_torch.kernels.segment_prefix import (
    segment_prefix_chain,
    segment_prefix_chain_plain,
    segment_prefix_ok_plain,
)

SHARES = (0.01, 0.05, 0.08, 0.13, 0.2, 0.3, 0.4, 0.55, 0.7, 1.0)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    print(card_name_and_power_limit())
    build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    snap, pods = chip_smoke.loaded_state(dev, gen)
    for share in SHARES:
        kw = chip_smoke.k2_case(snap, pods, gen, 0, share,
                                chip_smoke.FIT_DIMS)
        equal = torch.equal(segment_prefix_chain(**kw),
                            segment_prefix_chain_plain(**kw))
        alive, in_range = kw["active"], []
        for level, (base, limit, s) in zip(kw["seg"], kw["tables"]):
            in_range.append(int((alive & (level < s)).sum()))
            alive = alive & segment_prefix_ok_plain(
                torch.where(alive, level, s).to(torch.int32), kw["rank"],
                torch.where(alive[:, None], kw["req"], 0.0), base, limit,
                s, chip_smoke.EPS)
        device_ms = min(chip_smoke.device_ms(
            lambda: segment_prefix_chain(**kw),
            "segment_prefix_chain_kernel") for _ in range(args.reps))
        print("sweep_k2 " + json.dumps({
            "share": share, "in_range_per_level": in_range,
            "equal": equal, "device_ms": device_ms}), flush=True)
        if not equal:
            raise SystemExit("K2 differs from its plain version")


if __name__ == "__main__":
    main()
