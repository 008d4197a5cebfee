"""The port stands alone: it imports nothing of JAX or the JAX package,
and its entry points run on the card unless the caller asks for the
host."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from koordinator_tpu_torch import configs, flagship
from koordinator_tpu_torch.bridge import from_reference
from koordinator_tpu_torch.descheduler import DeviceLowNodeLoad
from koordinator_tpu_torch.scheduler.plugins.loadaware import LoadAwareConfig
from koordinator_tpu_torch.utils import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "koordinator_tpu")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("refused import of " + name)
        return None

sys.meta_path.insert(0, Refuse())
import koordinator_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    koordinator_tpu_torch.__path__, "koordinator_tpu_torch."))
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print(len(names), leaked)
"""


def test_port_and_chip_smoke_import_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    count, leaked = proc.stdout.strip().split(" ", 1)
    assert int(count) >= 20 and leaked == "[]"


@pytest.mark.parametrize("call", [
    lambda: synthetic.synthetic_cluster(4),
    lambda: synthetic.synthetic_pods(4),
    lambda: LoadAwareConfig.make(),
    lambda: from_reference("GangState", {}),
    lambda: flagship.run_northstar(8, 4, 8),
    lambda: configs.run_config_2_numa(8, 4, 8),
    lambda: DeviceLowNodeLoad(),
    lambda: configs.run_config_5_descheduler(n_nodes=8),
    lambda: configs.run_config_5_descheduler(capped=True, n_nodes=8),
], ids=["synthetic_cluster", "synthetic_pods", "LoadAwareConfig.make",
        "from_reference", "run_northstar", "run_config_2_numa",
        "DeviceLowNodeLoad", "run_config_5_descheduler",
        "run_config_5_descheduler_capped"])
def test_entry_points_default_to_the_card(call):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
