"""Build and load the port's CUDA kernels.

The sources in ``data_compression_tpu_torch/csrc/*.cu`` have a plain C
interface.  At the first launch on a CUDA tensor they are compiled with
``nvcc`` for ``sm_90a`` into one shared library under
``data_compression_tpu_torch/build/`` (git-ignored, located relative to
this package, not the working directory) and loaded with ``ctypes``.
The library's file name carries a hash of the sources and flags, so a
stale build is never loaded.  Importing this module builds nothing, so
it imports on machines with neither ``nvcc`` nor a GPU.

Every C entry point takes pointers and the stream as ``c_void_p`` and
returns ``cudaGetLastError()``; ``check`` raises if it is not 0.  A
failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("huffman_encode.cu", "compact.cu", "huffman_decode.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_longlong
SIGNATURES = {
    # name: argtypes (every entry point returns a cudaError_t as int)
    "dct_huffman_encode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I64, _P],
    "dct_compact": [_P, _P, _P, _P, _I, _I64, _P],
    "dct_huffman_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path() -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libdct_kernels-{h.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
    cmd += [str(CSRC_DIR / name) for name in SOURCES]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n{r.stdout}\n{r.stderr}"
        )
    os.replace(tmp, target)  # atomic: a concurrent build never sees a half-written file


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        target = _library_path()
        if not target.exists():
            t0 = time.perf_counter()
            _build(target)
            build_seconds = time.perf_counter() - t0
        loaded = ctypes.CDLL(str(target))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(loaded, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        loaded.dct_error_string.argtypes = [ctypes.c_int]
        loaded.dct_error_string.restype = ctypes.c_char_p
        _lib = loaded
        return _lib


def check(rc: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib().dct_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, as an integer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(*tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}; CPU tensors take the plain version")
