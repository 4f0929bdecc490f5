"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C entry point and compiles with
``nvcc`` alone (no PyTorch headers) into its own shared library for
``sm_90a``.  The build happens at first use, into
``build/repro_torch_kernels/`` at the repository root, and every source
compiles in its own ``nvcc`` process, all started together.  A library
is named after a hash of its source and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  Nothing here runs at
import time: this module imports on a machine with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("feature_resample", "fused_adam", "gather_loss", "flash_attention",
           "topk_gating")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_ENTRIES: dict = {}      # name -> configured ctypes function


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the repro_torch kernels build from source")
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every named source that has no current library, in
    parallel, and return the library paths.  Raises with the compiler's
    output when any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _target(n) for n in names if not _target(n).exists()}
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: _target(n) for n in names}


def entry(name: str, argtypes: list):
    """The C entry point ``<name>_launch`` of ``csrc/<name>.cu``, built
    if needed, with its argument types declared (ctypes would otherwise
    pass every Python int as a 32-bit int and cut the pointers)."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(ctypes.CDLL(str(build_all((name,))[name])),
                     f"{name}_launch")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s card, which must be the
    current device (the kernels launch there)."""
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {t.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return torch.cuda.current_stream().cuda_stream


def check(rc: int, name: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
