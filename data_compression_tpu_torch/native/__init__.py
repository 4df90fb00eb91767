"""ctypes binding of the port's native CPU runtime (``libdctpu.c``).

Counterpart of ``data_compression_tpu/native/__init__.py``: the same C
functions and argument types, the same batch drivers and error codes.
Three differences:

  * Where it builds.  At first use, ``cc -O3 -march=native -fopenmp
    -shared -fPIC`` into the git-ignored ``data_compression_tpu_torch/
    build/``, under a file name that carries a hash of the source, the
    flags and the host CPU, so a library built for another machine or
    another source is never loaded.  The build writes a temporary file
    and renames it into place, so concurrent builds (test workers) never
    load a half-written library.  If the OpenMP build fails, one serial
    build without ``-fopenmp`` follows; its output bytes are the same.
    ``openmp`` records which build loaded, ``build_seconds`` the wall
    time of this process's build (None when the library was there).
  * No fallback.  ``load()`` raises RuntimeError, with the compiler's
    message, when it cannot build or load the library; no caller takes
    a Python path instead.
  * No ``DCTPU_NATIVE_LIB`` override.

``huffman_encode_chunk`` / ``huffman_decode_chunk`` are bound for the
parity tests only: no path of the port calls them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "libdctpu.c"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CC = "cc"
CFLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
OPENMP_FLAG = "-fopenmp"
CC_TIMEOUT_S = 300
KINDS = ("nybble", "small_byte", "small_nybble")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
openmp: Optional[bool] = None  # whether the loaded build runs its batch drivers with OpenMP
build_seconds: Optional[float] = None  # wall time of this process's build

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i64 = ctypes.c_int64


def _host_id() -> bytes:
    """The host CPU's identity as ``-march=native`` sees it: machine,
    model name and feature flags of the first processor."""
    ident = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags", "Features")):
                    ident.append(line.strip())
                elif not line.strip() and len(ident) > 1:
                    break
    except OSError:
        pass
    return "\n".join(ident).encode()


def _library_path(with_openmp: bool) -> Path:
    h = hashlib.sha256()
    h.update(" ".join((CC, *CFLAGS)).encode())
    h.update(_host_id())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libdctpu-{h.hexdigest()[:16]}-{'omp' if with_openmp else 'serial'}.so"


def _compile(target: Path, with_openmp: bool) -> Optional[str]:
    """Build ``target``; -> None, or the compiler's message on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [CC, *CFLAGS, *((OPENMP_FLAG,) if with_openmp else ()), "-o", str(tmp), str(SRC)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=CC_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{' '.join(cmd)}: {e}"
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"{' '.join(cmd)} failed ({r.returncode}):\n{r.stderr}"
    os.replace(tmp, target)  # atomic: a concurrent build never sees a half-written file
    return None


def _bind(lib: ctypes.CDLL) -> None:
    lib.dct_crc32.restype = ctypes.c_uint32
    lib.dct_crc32.argtypes = [_u8p, _i64, ctypes.c_uint32]
    for kind in KINDS:
        for op in ("encode", "decode"):
            fn = getattr(lib, f"dct_{kind}_{op}")
            fn.restype = _i64
            fn.argtypes = [_u8p, _i64, _u8p, _i64]
        f = getattr(lib, f"dct_{kind}_encode_batch")
        f.restype = None
        f.argtypes = [_u8p, _i64p, _i64p, _u8p, _i64, _i64p, _i64]
        g = getattr(lib, f"dct_{kind}_decode_batch")
        g.restype = None
        g.argtypes = [_u8p, _i64p, _i64p, _i64p, _u8p, _i64, _i64p, _i64]
    lib.dct_huffman_capped_lengths_batch.restype = None
    lib.dct_huffman_capped_lengths_batch.argtypes = [
        _i64p, _i64, ctypes.c_int, ctypes.c_int, ctypes.c_int, _i32p, _i64p,
    ]
    lib.dct_huffman_encode_chunk.restype = _i64
    lib.dct_huffman_encode_chunk.argtypes = [
        _u8p, _i64, ctypes.c_int, ctypes.POINTER(ctypes.c_uint32), _i32p, _u8p, _i64,
    ]
    lib.dct_huffman_decode_chunk.restype = _i64
    lib.dct_huffman_decode_chunk.argtypes = [
        _u8p, _i64, _i64, ctypes.c_int, ctypes.c_int, _i64p, _i64p, _i32p, _u8p,
    ]


def load() -> ctypes.CDLL:
    """The loaded native library, built on first use; raises
    RuntimeError when it can neither be built nor loaded."""
    global _lib, openmp, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        errors = []
        for with_openmp in (True, False):
            target = _library_path(with_openmp)
            if not target.exists():
                t0 = time.perf_counter()
                err = _compile(target, with_openmp)
                if err is not None:
                    errors.append(err)
                    continue
                build_seconds = time.perf_counter() - t0
            try:
                lib = ctypes.CDLL(str(target))
            except OSError as e:
                errors.append(f"loading {target}: {e}")
                continue
            _bind(lib)
            _lib, openmp = lib, with_openmp
            return _lib
        raise RuntimeError("the native runtime libdctpu could not be built or loaded:\n"
                           + "\n".join(errors))


def _buf(b: bytes):
    return (ctypes.c_uint8 * len(b)).from_buffer_copy(b) if b else (ctypes.c_uint8 * 1)()


def _encode_one(kind: str, src: bytes) -> bytes:
    cap = 2 * len(src) + 16
    out = (ctypes.c_uint8 * cap)()
    n = getattr(load(), f"dct_{kind}_encode")(_buf(src), len(src), out, cap)
    if n < 0:
        raise ValueError(f"native {kind} encode error {n}")
    return ctypes.string_at(out, n)


def _decode_one(kind: str, payload: bytes, raw_len: int) -> bytes:
    if raw_len < 0:
        raise ValueError(f"negative raw length {raw_len}")
    out = (ctypes.c_uint8 * max(raw_len, 1))()
    n = getattr(load(), f"dct_{kind}_decode")(_buf(payload), len(payload), out, raw_len)
    if n < 0:
        raise ValueError(f"native {kind} decode error {n}")
    return ctypes.string_at(out, n)


def nybble_encode(src: bytes) -> bytes:
    return _encode_one("nybble", src)


def nybble_decode(payload: bytes, raw_len: int) -> bytes:
    return _decode_one("nybble", payload, raw_len)


def small_byte_encode(src: bytes) -> bytes:
    return _encode_one("small_byte", src)


def small_byte_decode(payload: bytes, raw_len: int) -> bytes:
    return _decode_one("small_byte", payload, raw_len)


def small_nybble_encode(src: bytes) -> bytes:
    return _encode_one("small_nybble", src)


def small_nybble_decode(payload: bytes, raw_len: int) -> bytes:
    return _decode_one("small_nybble", payload, raw_len)


def _raise_first(kind: str, op: str, out_len: np.ndarray) -> None:
    bad = np.flatnonzero(out_len < 0)
    if bad.size:
        raise ValueError(
            f"native {kind} {op} error {int(out_len[bad[0]])} (block {int(bad[0])})"
        )


def encode_batch(kind: str, blocks: np.ndarray, lengths) -> list:
    """Encode independent blocks in parallel (OpenMP across blocks).

    ``blocks``: [B, S] uint8; ``lengths``: valid bytes per block.
    Returns per-block payload bytes; raises ValueError on the first
    block error (the single-block wrappers' codes)."""
    if kind not in KINDS:
        raise ValueError(f"no native batch encoder for {kind!r}")
    lib = load()
    blocks = np.ascontiguousarray(blocks, np.uint8)
    if blocks.ndim != 2:
        raise ValueError(f"blocks must be [B, S], got shape {blocks.shape}")
    B, S = blocks.shape
    lens = np.ascontiguousarray(lengths, np.int64)
    if lens.shape != (B,) or bool(((lens < 0) | (lens > S)).any()):
        raise ValueError("block lengths must be B values in [0, S]")
    offs = np.arange(B, dtype=np.int64) * S
    stride = 2 * S + 16
    dst = np.empty((B, stride), np.uint8)
    out_len = np.empty(B, np.int64)
    getattr(lib, f"dct_{kind}_encode_batch")(
        blocks.ctypes.data_as(_u8p), offs.ctypes.data_as(_i64p), lens.ctypes.data_as(_i64p),
        dst.ctypes.data_as(_u8p), stride, out_len.ctypes.data_as(_i64p), B,
    )
    _raise_first(kind, "encode", out_len)
    return [dst[i, : int(out_len[i])].tobytes() for i in range(B)]


def decode_batch(kind: str, payloads, raw_lens) -> list:
    """Decode independent payloads in parallel (OpenMP across blocks)."""
    if kind not in KINDS:
        raise ValueError(f"no native batch decoder for {kind!r}")
    lib = load()
    B = len(payloads)
    if B == 0:
        return []
    plens = np.asarray([len(p) for p in payloads], np.int64)
    offs = np.zeros(B, np.int64)
    np.cumsum(plens[:-1], out=offs[1:])
    src = np.frombuffer(b"".join(payloads), np.uint8) if int(plens.sum()) else np.zeros(1, np.uint8)
    rls = np.ascontiguousarray(raw_lens, np.int64)
    if rls.shape != (B,) or bool((rls < 0).any()):
        raise ValueError("raw lengths must be B values >= 0")
    stride = max(1, int(rls.max()))
    dst = np.empty((B, stride), np.uint8)
    out_len = np.empty(B, np.int64)
    getattr(lib, f"dct_{kind}_decode_batch")(
        src.ctypes.data_as(_u8p), offs.ctypes.data_as(_i64p), plens.ctypes.data_as(_i64p),
        rls.ctypes.data_as(_i64p), dst.ctypes.data_as(_u8p), stride,
        out_len.ctypes.data_as(_i64p), B,
    )
    _raise_first(kind, "decode", out_len)
    return [dst[i, : int(out_len[i])].tobytes() for i in range(B)]


def huffman_capped_lengths_batch(hists: np.ndarray, arity: int, cap: int) -> np.ndarray:
    """Per-block canonical Huffman lengths under the length cap ``cap``:
    [B, S <= 256] int64 histograms -> [B, S] int32, OpenMP-parallel
    across blocks, row-identical to ``huffman.batched.capped_lengths_batch_ref``."""
    lib = load()
    hists = np.ascontiguousarray(hists, np.int64)
    if hists.ndim != 2 or hists.shape[1] > 256:
        raise ValueError(f"histograms must be [B, S <= 256], got shape {hists.shape}")
    B, S = hists.shape
    out = np.empty((B, S), np.int32)
    status = np.empty(B, np.int64)
    lib.dct_huffman_capped_lengths_batch(
        hists.ctypes.data_as(_i64p), B, S, arity, cap,
        out.ctypes.data_as(_i32p), status.ctypes.data_as(_i64p),
    )
    _raise_first("huffman", "lengths", status)
    return out


def crc32(data: bytes, seed: int = 0) -> int:
    return int(load().dct_crc32(_buf(data), len(data), seed))


def _chunk_arity(arity: int) -> None:
    if arity not in (2, 3, 16):  # the C digit-per-byte table covers these only
        raise ValueError(f"native huffman chunk coding takes n = 2, 3 or 16, not {arity}")


def huffman_encode_chunk(syms, packed_tab, bits_tab, arity: int) -> bytes:
    """One chunk's wire bytes.  ``packed_tab`` / ``bits_tab``: a row of
    ``huffman.batched.packed_rows``.  Parity tests only."""
    _chunk_arity(arity)
    lib = load()
    syms = np.ascontiguousarray(syms, np.uint8)
    pt = np.ascontiguousarray(packed_tab, np.uint32)
    bt = np.ascontiguousarray(bits_tab, np.int32)
    if pt.shape != (256,) or bt.shape != (256,):
        raise ValueError("encode tables must hold 256 entries")
    cap = 4 * max(1, syms.size) + 64
    out = (ctypes.c_uint8 * cap)()
    n = lib.dct_huffman_encode_chunk(
        syms.ctypes.data_as(_u8p), syms.size, arity,
        pt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), bt.ctypes.data_as(_i32p), out, cap,
    )
    if n < 0:
        raise ValueError(f"native huffman encode error {n}")
    return ctypes.string_at(out, n)


def huffman_decode_chunk(payload: bytes, count: int, dec_tables: dict, arity: int, L: int):
    """``count`` symbols of one chunk.  ``dec_tables``: a row of
    ``huffman.batched.decode_rows`` padded to ``L``.  Parity tests only."""
    _chunk_arity(arity)
    lib = load()
    limit = np.ascontiguousarray(dec_tables["limit_scaled"], np.int64)
    bmf = np.ascontiguousarray(dec_tables["base_minus_first"], np.int64)
    symbols = np.ascontiguousarray(dec_tables["symbols"], np.int32)
    if limit.shape != (L + 1,) or bmf.shape != (L + 1,) or symbols.shape != (256,):
        raise ValueError("decode tables must be [L + 1], [L + 1] and [256]")
    out = (ctypes.c_uint8 * max(count, 1))()
    n = lib.dct_huffman_decode_chunk(
        _buf(payload), len(payload), count, arity, L,
        limit.ctypes.data_as(_i64p), bmf.ctypes.data_as(_i64p), symbols.ctypes.data_as(_i32p),
        out,
    )
    if n < 0:
        raise ValueError(f"native huffman decode error {n}")
    return np.frombuffer(ctypes.string_at(out, count), np.uint8)
