"""Build and load the hand-written CUDA kernels.

Each ``gecco_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, loaded with
``ctypes``. The build runs at first use, from the sources in the checkout,
into ``gecco_tpu_torch/_build/`` (git-ignored); a library's file name carries
a hash of its sources, so an edit rebuilds it. ``build_all`` starts one
``nvcc`` per source, all at once.

Nothing here runs at import time: the CPU tests import every module, and
this machine-independent code only runs when a wrapper meets a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["KERNEL_SOURCES", "build_all", "library", "launch", "check_cuda"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNEL_SOURCES = (
    "pool_ext", "hside", "unpool", "mlp", "pool_ext_bwd", "unpool_bwd", "mlp_bwd",
    "projective_gather", "induced_attention", "induced_attention_bwd", "unpool_mlp",
    "pool", "pool_bwd", "pool_ext_wmma", "unpool_wmma", "mlp_wmma", "pool_ext_bwd_wmma",
    "unpool_bwd_wmma", "mlp_bwd_wmma", "pool_ext_bwd_v1", "pool_ext_bwd_v2", "hside_wmma",
    "pool_wmma", "pool_ext_bwd_twopass", "pool_bwd_wmma", "induced_attention_wmma",
    "induced_attention_bwd_wmma", "unpool_mlp_wmma", "projective_gather_simt", "f32_simt",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha1()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build_all(names=KERNEL_SOURCES) -> dict[str, str]:
    """Compile every missing library in parallel; returns each source's
    ``ptxas`` report (registers, shared memory, spills). Raises on a failed
    build with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, target)
    reports = {}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{out}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target = _target(name)
            if not target.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(target))
            _libs[name] = lib
        return lib


def _arg(a):
    if a is None:
        return ctypes.c_void_p(None)
    if isinstance(a, torch.Tensor):
        return ctypes.c_void_p(a.data_ptr())
    if isinstance(a, bool) or not isinstance(a, int):
        raise TypeError(f"kernel argument must be a tensor or an int, got {type(a)}")
    return ctypes.c_int(a)


def launch(lib_name: str, fn: str, *args) -> None:
    """Call ``fn`` of a kernel library on the current stream. Tensors pass
    as device pointers, None as a null pointer, ints as C ints; the C
    function returns the launch's ``cudaGetLastError()``, and a non-zero
    code raises here."""
    f = getattr(library(lib_name), fn)
    f.restype = ctypes.c_int
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    err = f(*[_arg(a) for a in args], stream)
    if err != 0:
        raise RuntimeError(f"{lib_name}.{fn}: CUDA error {err} at launch")


def check_cuda(name: str, tensors: dict, dtypes: dict) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of its dtype,
    all on one device."""
    device = None
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} must be a CUDA tensor, got {t.device}")
        if device is not None and t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
        device = t.device
        if t.dtype != dtypes[key]:
            raise ValueError(f"{name}: {key} must be {dtypes[key]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
