"""PyTorch/CUDA port of `koordinator_tpu`'s slim score-and-bind path.

The JAX package stays the reference; this package re-states its slim
flagship (schedule a pending-pod queue against a node snapshot in
chunks, then retry the stragglers) in plain PyTorch around three CUDA
kernels written for Hopper (`csrc/`, bound in `kernels/`). Module names
mirror the JAX package so that each function's counterpart is easy to
find. The package imports torch and numpy only.

Float32 matrix products and convolutions never take the TF32 path here:
the placements are held bit for bit against the float32 reference.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. "cuda" (the default) raises
    when no CUDA device is present: the port never falls back to the
    host on its own; a caller that wants the plain path asks for
    "cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host")
    return dev
