"""The port's hand-written CUDA kernels: wrappers, plain versions and
launch counts.

Each kernel module holds a wrapper (checks device, dtype, shape and
contiguity, allocates its outputs, launches on the current stream and
adds one to its launch count), and beside it the plain PyTorch version
of the same function. A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Dict

def _wrappers():
    from koordinator_tpu_torch.kernels import (
        scatter,
        score_topk,
        segment_prefix,
    )
    return {"score_topk": score_topk.score_topk,
            "segment_prefix_ok": segment_prefix.segment_prefix_ok,
            "ordered_scatter_add": scatter.ordered_scatter_add}


def launch_counts() -> Dict[str, int]:
    """{kernel name: launches since the last reset}."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
