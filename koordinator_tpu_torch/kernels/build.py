"""Build the CUDA sources under `csrc/` and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C function and compiles on its
own into `build/kernels/lib<name>-<hash>.so` at the repository root
(the hash is of the source and the shared headers `csrc/*.cuh`, so an
edited source or header rebuilds). All sources
compile in parallel, one `nvcc` each, at the first launch of any
kernel, or up front through `build_all()`. Flags: sm_90a, -O3, and
`-fmad=false`, so that nvcc contracts no multiply-add the reference
rounds twice; the kernels ask for a fused multiply-add by name
(`__fmaf_rn`) exactly where the reference's compiler fuses one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(ROOT, "build", "kernels")
SOURCES = ("score_topk", "segment_prefix_ok", "ordered_scatter_add",
           "numa_terms", "topology_admit", "device_terms", "gpu_instances",
           "topology_prefix", "stage1_mask", "lownodeload_fit",
           "lownodeload_order", "lownodeload_prefix", "lownodeload_capped",
           "guard_nodes", "guard_pods", "delta_rows", "aux_instances",
           "quota_runtime", "node_overcommit")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")


class Toolchain:
    """The loaded kernel libraries of one process, with what their
    build reported (seconds, ptxas register/spill lines)."""

    def __init__(self):
        self.libs: Dict[str, ctypes.CDLL] = {}
        self.functions: Dict[tuple, ctypes._CFuncPtr] = {}
        self.build_s = 0.0
        self.ptxas: Dict[str, str] = {}

    def nvcc(self) -> str:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        found = cand if os.path.exists(cand) else shutil.which("nvcc")
        if not found:
            raise RuntimeError("nvcc not found: the CUDA kernels build only "
                               "on a host with the CUDA toolkit")
        return found

    def _target(self, name: str) -> str:
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
        for src in [name + ".cu"] + headers:
            with open(os.path.join(CSRC, src), "rb") as f:
                digest.update(f.read())
        return os.path.join(BUILD_DIR,
                            f"lib{name}-{digest.hexdigest()[:12]}.so")

    def build_all(self) -> None:
        """Compile every source not built yet (all at once) and load
        every library."""
        todo = [n for n in SOURCES if n not in self.libs]
        if not todo:
            return
        t0 = time.perf_counter()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name in todo:
            out = self._target(name)
            if os.path.exists(out):
                continue
            cmd = [self.nvcc(), *NVCC_FLAGS, "-o", out + ".tmp",
                   os.path.join(CSRC, name + ".cu")]
            procs[name] = (out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (out, proc) in procs.items():
            log, _ = proc.communicate()
            self.ptxas[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
            else:
                os.replace(out + ".tmp", out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name in todo:
            self.libs[name] = ctypes.CDLL(self._target(name))
        self.build_s += time.perf_counter() - t0

    def function(self, name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
        """The C entry point `symbol` of kernel library `name`, built on
        first use, with its argument types declared (pointers as
        c_void_p, so that ctypes does not cut them to 32 bits)."""
        key = (name, symbol)
        if key not in self.functions:
            if name not in self.libs:
                self.build_all()
            fn = getattr(self.libs[name], symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self.functions[key] = fn
        return self.functions[key]


TOOLCHAIN = Toolchain()


def build_all() -> Toolchain:
    """Build and load every kernel of the port; returns the toolchain
    (its `build_s` and `ptxas` say what the build cost and reported)."""
    TOOLCHAIN.build_all()
    return TOOLCHAIN


def check(rc: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
