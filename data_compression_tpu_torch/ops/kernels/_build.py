"""Build and load the port's CUDA kernels.

The sources in ``data_compression_tpu_torch/csrc/*.cu`` have a plain C
interface.  At the first launch on a CUDA tensor they are compiled with
``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, all started together,
then one link) into one shared library under
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
import re
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
SOURCES = ("huffman_encode.cu", "compact.cu", "huffman_decode.cu", "copy.cu", "microbench.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_longlong
SIGNATURES = {
    # name: argtypes (every entry point returns a cudaError_t as int)
    "dct_huffman_encode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I64, _I, _P],
    "dct_huffman_encode_rows": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "dct_compact": [_P, _P, _P, _I, _I64, _I64, _P],
    "dct_huffman_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "dct_copy": [_P, _P, _I64, _P],
    "dct_lookup": [_I, _P, _P, _P, _I, _I, _P],
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


def _run(procs) -> None:
    """Wait for every (command, process); raise on the first failure."""
    failed = None
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}"
    if failed:
        raise RuntimeError(failed)


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    objs, procs = [], []
    for name in SOURCES:
        obj = tmp.with_name(f"{tmp.name}.{name}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC_DIR / name)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
        objs.append(obj)
    try:
        _run(procs)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
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


def ptxas_usage(source: str) -> dict:
    """Per kernel of ``csrc/<source>``, what ``nvcc -Xptxas -v`` reports
    for sm_90a at the library's optimisation level (a cubin built apart
    from the library): {mangled name: {"registers", "stack",
    "spill_stores", "spill_loads"}}, the last three in bytes."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"ptxas-{os.getpid()}-{source}.cubin"
    cmd = [_nvcc(), "-arch=sm_90a", "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v",
           "-o", str(out), str(CSRC_DIR / source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    finally:
        out.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    usage, name = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            usage.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            usage[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            usage.setdefault(name, {})
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name]["registers"] = int(m.group(1))
    return usage


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
