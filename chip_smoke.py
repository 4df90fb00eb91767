#!/usr/bin/env python3
"""Bring-up smoke run of ``data_compression_tpu_torch`` on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA device
and ``nvcc``.  It needs no arguments, no environment variables and no
network; it imports nothing of JAX.  Phases (any failure raises and the
script exits non-zero without a result line):

  1. print the card (``nvidia-smi`` name and power limit);
  2. build the CUDA kernels from ``data_compression_tpu_torch/csrc``,
     and print ``nvcc -Xptxas -v``'s registers, stack and spill bytes of
     the encode and compaction kernels (``_build.ptxas_usage``),
     requiring 0 stack and 0 spill; build the native C runtime
     (``data_compression_tpu_torch/native/libdctpu.c``, by ``cc``) and
     print its build seconds and whether it runs with OpenMP;
  3. at each Huffman arity with kernels (2, 16, 3), run each kernel
     against its plain PyTorch version on the card at the main path's
     shapes (64 MiB = 1024 blocks of 64 KiB, C = 512: a seeded
     enwik-like corpus plus one deep-code block, whose table at n = 3
     and 16 is replaced by a complete tree that reaches the length cap)
     and require byte equality of the valid bytes; both encode kernels
     also encode the input with that block's chunk 0 made of L-digit
     symbols, whose wire bytes fill max_chunk_bytes; the compaction
     kernel also writes into a guarded canvas 7 bytes off 16-byte
     alignment and must leave the guard bytes alone; the decode kernel
     reads the encode kernel's payloads and must give back the input;
  3b. the main path's table build: on the 1024 block histograms of the
     64 MiB input, the native builder's code lengths must equal the
     plain Python builder's (``capped_lengths_batch_ref``) at n = 2, 16
     and 3; both host times are printed with the host CPU's model name
     and ``os.cpu_count()``;
  4. the slice at each arity: ``compress`` -> ``decompress`` of the
     64 MiB input on ``cuda`` must round-trip, with the launch count of
     each of its kernels > 0; then compress / decompress GB/s for the
     kernel path (tables from the native builder), for the same path
     with the plain Python table builder, and at n = 2 also for the
     plain path (each kernel wrapper swapped for its plain version);
  5. the sharded pipeline in a one-rank NCCL group, at each arity:
     ``compress_sharded`` of the 64 MiB input, with per-block and with
     shared tables, must give ``compress``'s frame on ``cuda`` and
     ``decompress_sharded`` must round-trip, with the launch count of
     each of its kernels > 0; then its GB/s, and the time of its
     collectives; the group is destroyed;
  6. wire parity: the frames of the golden inputs (Huffman at n = 2, 16
     and 3, and the serial codecs) must hash to the SHA-256 recorded from
     the JAX package, and decode back;
  7. the profiling tools: the copy kernel against ``clone()`` on the
     64 MiB input and each lookup-variant kernel against its plain
     version at B = 128 (byte equality); at each arity the rows-encode
     stages 1-2 and decode stages 1-3 observables against their
     definitions from the plain full versions (exact); then
     ``tools.ablate`` at 64 MiB per arity and ``tools.microbench``,
     their JSON logged, with the launch count
     of the copy kernel, every lookup variant, the rows-encode and the
     decode kernel > 0;
  8. the serial codecs (literal, nybble, small_byte, small_byte with the
     ISPRINT mode, small_nybble) made for ``cuda``: ``compress`` ->
     ``decompress`` of the 64 MiB input must round-trip exactly; their
     ratio, compress / decompress GB/s and route (the native runtime's
     OpenMP batch drivers on the host, or the pass-through) are printed;
     a frame with one payload byte flipped must raise ValueError.

The line before the last is a JSON object of the kernels, one entry
per kernel and arity (name, arity, route, source, the TPU kernel it
replaces, launches in that arity's runs of phases 4 and 5, or for the
tools' kernels in phase 7, each counted from 0, max abs error against
the plain version, ms per call, plain ms per call, the bound: the
bytes the call must move at 3.35 TB/s, and library ms, the time of one
PyTorch call computing the same function, or null; the compaction
entries have ``device_ms``, the copy kernel's ``device_ms`` and
``library_device_ms``: device time per call by torch.profiler,
``tools.timing.device_ms``, null where no profiler session held every
device record).  A time per call is the best of 3 trials
of back-to-back calls, each at least 0.05 s
(``tools.timing.time_chain``), the lookup variants' the median of
single launches with the input cold in L2 (``tools.timing.cold_ms``).
The decode and compaction kernels are timed alone, through
``decode_launcher`` and ``compact_launcher`` (inputs checked and
offsets computed once); the wrappers ``decode_chunks`` and
``compact_blocks``, whose checks read back from the card on every call,
are timed on lines of their own.  The last line
is ``{"ok": true, "device": {...}}``.  Exits non-zero without printing
a result when no CUDA device is available or when the package is not
beside this script.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
MIB = 1 << 20
MAIN_BYTES = 64 * MIB
SEED = 7
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
TRIAL_S = 0.05  # seconds per trial of every chain timing (timing.time_chain)
COLD_REPS = 10  # HBM-cold launches per lookup-variant timing in phase 7

KERNELS = [
    # (name, wrapper module, wrapper, plain version, source, TPU kernel it replaces)
    ("huffman_encode", "encode", "encode_blocks", "encode_blocks_ref",
     "data_compression_tpu_torch/csrc/huffman_encode.cu",
     "data_compression_tpu/ops/pallas/encode_kernel.py:474"),
    ("compact", "compact", "compact_blocks", "compact_blocks_ref",
     "data_compression_tpu_torch/csrc/compact.cu",
     "data_compression_tpu/ops/pallas/compact_kernel.py:68"),
    ("huffman_decode", "decode", "decode_chunks", "decode_chunks_ref",
     "data_compression_tpu_torch/csrc/huffman_decode.cu",
     "data_compression_tpu/ops/pallas/decode_kernel.py:547"),
    ("huffman_encode_rows", "encode", "encode_chunk_rows", "encode_chunk_rows_ref",
     "data_compression_tpu_torch/csrc/huffman_encode.cu",
     "data_compression_tpu/ops/pallas/encode_kernel.py:433"),
]
# the kernels each path runs: the single-device slice and the sharded
# pipeline; the profiling tools' own kernels are in tool_kernels()
SLICE_KERNELS = ("huffman_encode", "compact", "huffman_decode")
SHARDED_KERNELS = ("huffman_encode_rows", "huffman_decode")
# Huffman arities with kernels, and the symbols of a complete tree at the
# length cap for each of n = 3 and 16 (1 + a multiple of n - 1)
ARITIES = (2, 16, 3)
COMPLETE_SYMBOLS = {16: 256, 3: 255}


def log(msg: str) -> None:
    print(msg, flush=True)


def chain_ms(fn, iters: int = 12) -> float:
    """Best ms per call of ``fn`` launched back to back (``time_chain``,
    trials of at least ``TRIAL_S``)."""
    from data_compression_tpu_torch.tools import timing

    return timing.time_chain(fn, iters=iters, min_trial_s=TRIAL_S) * 1e3


def tool_kernels():
    """(name, source, TPU kernel it replaces) of the tools' kernels: the
    copy kernel and one per lookup variant."""
    from data_compression_tpu_torch.ops.kernels import microbench as kmb

    return [("copy", "data_compression_tpu_torch/csrc/copy.cu", "tools/ablate.py:149")] + [
        (f"lookup_{v}", "data_compression_tpu_torch/csrc/microbench.cu", kmb.REPLACES[v])
        for v in kmb.VARIANTS
    ]


def timed(fn):
    """(result, CUDA-event ms, wall ms) of one call ending in a sync."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def fmt_ms(ms) -> str:
    """A device reading for the log: ms, or "not measured" (None)."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bound_ms(nbytes: int) -> float:
    """Least ms to move ``nbytes`` through device memory."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_abs_err(a, b, valid) -> int:
    """Largest |a - b| over the valid positions; raises unless 0."""
    err = int((a.to(int) - b.to(int)).abs()[valid].max()) if bool(valid.any()) else 0
    if err:
        raise AssertionError(f"kernel disagrees with its plain version (max abs err {err})")
    return err


@contextmanager
def plain_kernels(modules):
    """Swap each kernel wrapper for its plain version (on any device); the
    compaction's ``total``, a size its plain version does not take, is
    dropped."""
    saved = []
    for mod, wrapper, ref in modules:
        saved.append((mod, wrapper, getattr(mod, wrapper)))
        plain = getattr(mod, ref)
        setattr(mod, wrapper, lambda *a, total=None, _plain=plain, **k: _plain(*a, **k))
    try:
        yield
    finally:
        for mod, wrapper, fn in saved:
            setattr(mod, wrapper, fn)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def kernel_phase(n: int, data: bytes, mods: dict, dev) -> dict:
    """Each kernel against its plain version at arity ``n`` on the main
    path's shapes; -> {kernel: max_abs_err, ms, plain_ms}.  The last
    block's table reaches the length cap L: the deep-code block's own at
    n = 2, a complete tree (last limit exactly n**L) at n = 3 and 16."""
    import numpy as np
    import torch

    from data_compression_tpu_torch import CodecConfig, framing
    from data_compression_tpu_torch.config import ARITY_MAX_LEN, wire_bytes
    from data_compression_tpu_torch.huffman import batched as hb
    from data_compression_tpu_torch.models.huffman import HuffmanCodec
    from data_compression_tpu_torch.tools import timing
    from data_compression_tpu_torch.utils.corpora import complete_lengths

    L = ARITY_MAX_LEN[n]
    cfg = CodecConfig(arity=n)
    C = cfg.chunk_syms
    codec = HuffmanCodec(cfg, dev)
    blocks, lengths = framing.split_blocks(data, cfg.block_size)
    dev_blocks, dev_lens = codec.upload_blocks(blocks, lengths)
    tb, _ = codec.tables(dev_blocks, dev_lens)
    if n == 2:
        if int(tb.max_len[-1]) != L:
            raise AssertionError("deep-code block lost its 15-digit codes")
    else:
        table_lengths = tb.lengths.copy()
        table_lengths[-1] = complete_lengths(n, L, COMPLETE_SYMBOLS[n])
        tb = hb.codes_batch(table_lengths, n)
    dense = hb.encode_tensors(tb, dev)["dense"]
    enc, cmp_, dec = mods["encode"], mods["compact"], mods["decode"]
    results = {}

    # chunk 0 of the last block rewritten to its table's L-digit symbols,
    # so that its wire bytes fill all max_chunk_bytes (both encode layouts)
    deep = torch.from_numpy(np.flatnonzero(tb.lengths[-1] == L).astype(np.uint8)).to(dev)
    rows_in = dev_blocks.clone()
    rows_in[-1, :C] = deep[torch.arange(C, device=dev) % deep.numel()]

    def compact_encode(blocks):
        """The compact encode kernel against its plain version on
        ``blocks``; -> (rows, digits, block_bytes, max abs err)."""
        rows, digits, bb = enc.encode_blocks(blocks, dev_lens, dense, C, n)
        rows_r, digits_r, bb_r = enc.encode_blocks_ref(blocks, dev_lens, dense, C, n)
        torch.cuda.synchronize()
        if not (torch.equal(digits, digits_r) and torch.equal(bb, bb_r)):
            raise AssertionError(f"encode n={n}: digit or byte counts differ from plain")
        valid = torch.arange(rows.shape[1], device=dev)[None, :] < bb[:, None].long()
        return rows, digits, bb, max_abs_err(rows, rows_r, valid)

    _, digits, _, deep_err = compact_encode(rows_in)
    if int(digits.max()) != L * C:
        raise AssertionError(f"encode n={n}: no chunk filled max_chunk_bytes in the compact layout")
    rows, digits, bb, err = compact_encode(dev_blocks)
    raw = int(dev_lens.long().sum())  # symbol bytes the kernels read
    results["huffman_encode"] = dict(
        max_abs_err=max(err, deep_err),
        ms=chain_ms(lambda: enc.encode_blocks(dev_blocks, dev_lens, dense, C, n)),
        plain_ms=chain_ms(lambda: enc.encode_blocks_ref(dev_blocks, dev_lens, dense, C, n), 1),
        bound_ms=bound_ms(raw + nbytes_of(dev_lens, dense, digits, bb) + int(bb.long().sum())),
        bound_by="bytes", library_ms=None,
    )

    flat = cmp_.compact_blocks(rows, bb)
    flat_r = cmp_.compact_blocks_ref(rows, bb)
    if flat.shape != flat_r.shape:
        raise AssertionError(f"compact n={n}: output sizes differ")
    total = flat.numel()
    everywhere = torch.ones_like(flat, dtype=torch.bool)
    # the main path's call, with the total it already holds (no host read)
    err = max(max_abs_err(flat, flat_r, everywhere),
              max_abs_err(cmp_.compact_blocks(rows, bb, total=total), flat_r, everywhere))
    # the kernel alone, into flat's place 7 bytes into a guarded canvas
    launch = cmp_.compact_launcher(rows, bb)  # checked once; the kernel alone per call
    canvas = torch.full((total + 32,), 0xA5, dtype=torch.uint8, device=dev)
    launch(canvas[7 : 7 + total])
    err = max(err, max_abs_err(canvas[7 : 7 + total], flat_r, everywhere))
    if bool((canvas[:7] != 0xA5).any()) or bool((canvas[7 + total:] != 0xA5).any()):
        raise AssertionError(f"compact n={n}: wrote outside its output")
    log(f"wrapper compact_blocks n={n}: "
        f"{chain_ms(lambda: cmp_.compact_blocks(rows, bb)):.4f} ms per call (offsets, bounds "
        "check and total in one host read, launch); with the total given, as the compress "
        f"path calls it: {chain_ms(lambda: cmp_.compact_blocks(rows, bb, total=total)):.4f} ms "
        "per call (offsets, launch; no host read)")
    keep = torch.arange(rows.shape[1], device=dev)[None, :] < bb[:, None].long()
    results["compact"] = dict(
        max_abs_err=err,
        ms=chain_ms(launch),
        device_ms=timing.device_ms_or_none(launch),
        plain_ms=chain_ms(lambda: cmp_.compact_blocks_ref(rows, bb), 1),
        bound_ms=bound_ms(2 * total + nbytes_of(bb)),
        bound_by="bytes",
        library_ms=chain_ms(lambda: torch.masked_select(rows, keep)),
    )
    del rows, flat_r, keep, canvas, everywhere

    # decode the encoded payloads, parsed as decompress parses a frame
    nb = wire_bytes(digits.cpu().numpy().astype(np.int64), n)
    payloads = codec._assemble_payloads(flat.cpu().numpy(), nb, lengths, tb.table_bytes())
    args, _ = codec.decode_inputs(payloads, lengths, None)
    out = dec.decode_chunks(**args)
    out_r = dec.decode_chunks_ref(**args)
    valid = torch.arange(C, device=dev)[None, :] < args["chunk_cnt"][:, None]
    log(f"wrapper decode_chunks n={n}: {chain_ms(lambda: dec.decode_chunks(**args)):.4f} ms "
        "per call (input checks with a host sync, searchsorted, launch)")
    launch = dec.decode_launcher(**args)  # checked once; the kernel alone per call
    results["huffman_decode"] = dict(
        max_abs_err=max_abs_err(out, out_r, valid),
        ms=chain_ms(launch),
        plain_ms=chain_ms(lambda: dec.decode_chunks_ref(**args), 1),
        bound_ms=bound_ms(nbytes_of(*(args[k] for k in ("flat", "chunk_off", "chunk_cnt",
                                                           "chunk_blk", "limit", "bmf",
                                                           "symbols")))
                          + int(args["chunk_cnt"].long().sum())),
        bound_by="bytes", library_ms=None,
    )
    if not torch.equal(out[valid], torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)):
        raise AssertionError(f"decode n={n}: symbols differ from the input")
    del out, out_r, args, flat, digits, bb, valid

    # the rows kernel, on the input whose chunk fills its row
    rows, digits = enc.encode_chunk_rows(rows_in, dev_lens, dense, C, n)
    rows_r, digits_r = enc.encode_chunk_rows_ref(rows_in, dev_lens, dense, C, n)
    torch.cuda.synchronize()
    if not torch.equal(digits, digits_r):
        raise AssertionError(f"encode rows n={n}: digit counts differ from the plain version")
    if int(digits.max()) != L * C:
        raise AssertionError(f"encode rows n={n}: no chunk filled its row")
    valid = torch.arange(rows.shape[1], device=dev)[None, :] < wire_bytes(digits[:, None].long(), n)
    results["huffman_encode_rows"] = dict(
        max_abs_err=max_abs_err(rows, rows_r, valid),
        ms=chain_ms(lambda: enc.encode_chunk_rows(rows_in, dev_lens, dense, C, n)),
        plain_ms=chain_ms(lambda: enc.encode_chunk_rows_ref(rows_in, dev_lens, dense, C, n), 1),
        bound_ms=bound_ms(raw + nbytes_of(dev_lens, dense, digits)
                          + int(wire_bytes(digits.long(), n).sum())),
        bound_by="bytes", library_ms=None,
    )
    del rows, rows_r, digits, digits_r, valid, rows_in, dev_blocks
    torch.cuda.empty_cache()
    for name, r in results.items():
        log(f"kernel {name} n={n}: max_abs_err {r['max_abs_err']} "
            f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms"
            + ("" if r["library_ms"] is None else f" library {r['library_ms']:.4f} ms")
            + ("" if "device_ms" not in r else f"; device {fmt_ms(r['device_ms'])}"))
    return results


def tool_kernel_phase(data: bytes, dev) -> dict:
    """The tools' kernels against their plain versions: the copy kernel
    on the 64 MiB input, each lookup variant on the microbenchmark's
    B = 128 inputs (HBM-cold times); -> {kernel: max_abs_err, ms,
    plain_ms, bound_ms, bound_by, library_ms}."""
    import torch

    from data_compression_tpu_torch.ops.kernels import copy as kcopy
    from data_compression_tpu_torch.ops.kernels import microbench as kmb
    from data_compression_tpu_torch.tools import microbench, timing

    results = {}
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev).view(-1, 512, 128)
    y = kcopy.copy_blocks(x)
    everywhere = torch.ones_like(x, dtype=torch.bool)
    err = max_abs_err(y, kcopy.copy_blocks_ref(x), everywhere)
    max_abs_err(y, x, everywhere)
    dst = torch.empty_like(x)
    results["copy"] = dict(
        max_abs_err=err,
        ms=chain_ms(lambda: kcopy.copy_blocks(x)),
        plain_ms=chain_ms(lambda: kcopy.copy_blocks_ref(x)),
        bound_ms=bound_ms(2 * x.numel()), bound_by="bytes",
        library_ms=chain_ms(lambda: dst.copy_(x)),
        device_ms=timing.device_ms_or_none(lambda: kcopy.copy_blocks(x)),
        library_device_ms=timing.device_ms_or_none(lambda: dst.copy_(x)),
    )
    del x, y, dst, everywhere

    s, tables = microbench.make_inputs(microbench.B, dev)
    everywhere = torch.ones_like(s, dtype=torch.bool)
    for name in kmb.VARIANTS:
        t = tables[name]
        got = kmb.lookup_variant(name, s, t)
        err = max_abs_err(got, kmb.lookup_variant_ref(name, s, t), everywhere)
        lib = microbench.library_call(name, s, t)
        results[f"lookup_{name}"] = dict(
            max_abs_err=err,
            ms=timing.cold_ms(lambda: kmb.lookup_variant(name, s, t), COLD_REPS, dev),
            plain_ms=timing.cold_ms(lambda: kmb.lookup_variant_ref(name, s, t), COLD_REPS, dev),
            bound_ms=bound_ms(2 * s.numel() + microbench.table_bytes(t)), bound_by="bytes",
            library_ms=None if lib is None else timing.cold_ms(lib, COLD_REPS, dev),
        )
    for name, r in results.items():
        log(f"kernel {name}: max_abs_err {r['max_abs_err']} kernel {r['ms']:.4f} ms "
            f"plain {r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms"
            + ("" if r["library_ms"] is None else f" library {r['library_ms']:.4f} ms")
            + ("" if "device_ms" not in r else f"; device {fmt_ms(r['device_ms'])}, "
               f"library device {fmt_ms(r['library_device_ms'])}"))
    return results


def rates(data: bytes, cfg, blob: bytes, label: str, card: str, host: str) -> None:
    """Best of 3 compress / decompress GB/s of ``data`` on cuda."""
    from data_compression_tpu_torch import compress, decompress

    best = {}
    for _ in range(3):
        b, ev_c, wall_c = timed(lambda: compress(data, cfg, device="cuda"))
        r, ev_d, wall_d = timed(lambda: decompress(b, device="cuda"))
        if b != blob or r != data:
            raise AssertionError(f"{label} output differs")
        for k, v in (("compress_event", ev_c), ("compress_wall", wall_c),
                     ("decompress_event", ev_d), ("decompress_wall", wall_d)):
            best[k] = min(best.get(k, float("inf")), v)
    gbps = {k: len(data) / (v * 1e-3) / 1e9 for k, v in best.items()}
    log(f"{label}: compress {gbps['compress_event']:.4f} GB/s (events) "
        f"{gbps['compress_wall']:.4f} GB/s (wall); decompress "
        f"{gbps['decompress_event']:.4f} GB/s (events) "
        f"{gbps['decompress_wall']:.4f} GB/s (wall); best of 3, {len(data) // MIB} MiB; card {card}; "
        f"host {host}")


def table_phase(data: bytes, dev, host: str) -> None:
    """The native builder's code lengths against the plain builder's on
    the main path's 1024 block histograms, at each arity; both host
    times (native: best of 5; plain: one call)."""
    import numpy as np

    from data_compression_tpu_torch import CodecConfig, framing, native
    from data_compression_tpu_torch.config import ARITY_MAX_LEN
    from data_compression_tpu_torch.huffman import batched as hb
    from data_compression_tpu_torch.models.huffman import HuffmanCodec
    from data_compression_tpu_torch.ops.histogram import block_histograms

    cfg = CodecConfig()
    blocks, lengths = framing.split_blocks(data, cfg.block_size)
    hists = block_histograms(*HuffmanCodec(cfg, dev).upload_blocks(blocks, lengths)).cpu().numpy()
    for n in ARITIES:
        native_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            got = native.huffman_capped_lengths_batch(hists, n, ARITY_MAX_LEN[n])
            native_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        want = hb.capped_lengths_batch_ref(hists, n)
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(got, want):
            raise AssertionError(f"native code lengths at n={n} differ from the plain builder's")
        log(f"table build n={n}, {hists.shape[0]} histograms: native == plain; native "
            f"{min(native_ms):.4f} ms (best of 5, openmp {native.openmp}), plain "
            f"{plain_ms:.4f} ms; host {host}")


SERIAL = [
    # (label, config kwargs)
    ("literal", dict(codec="literal")),
    ("nybble", dict(codec="nybble")),
    ("small_byte", dict(codec="small_byte")),
    ("small_byte isprint_literal", dict(codec="small_byte", isprint_literal=True)),
    ("small_nybble", dict(codec="small_nybble")),
]


def serial_phase(data: bytes, card: str, host: str) -> None:
    """Each serial codec made for cuda: exact round trip of ``data``,
    ratio, GB/s and route; one flipped payload byte must raise."""
    from data_compression_tpu_torch import CodecConfig, compress, decompress, framing, native

    for label, kw in SERIAL:
        cfg = CodecConfig(**kw)
        blob = compress(data, cfg, device="cuda")
        if decompress(blob, device="cuda") != data:
            raise AssertionError(f"serial {label}: round trip on cuda is not exact")
        route = ("host, pass-through" if cfg.codec == "literal"
                 else f"host native, {'OpenMP' if native.openmp else 'serial'}")
        log(f"serial {label}: {len(data) // MIB} MiB round trip exact, ratio "
            f"{len(blob) / len(data):.6f}, route {route}")
        rates(data, cfg, blob, f"serial {label}", card, host)
        f = framing.unpack_frame(blob)
        lo = len(blob) - sum(e.comp_len for e in f.entries)
        corrupt = bytearray(blob)
        corrupt[(lo + len(blob)) // 2] ^= 0xFF
        try:
            decompress(bytes(corrupt), device="cuda")
        except ValueError as e:
            log(f"serial {label}: a flipped payload byte raises ValueError ({e})")
        else:
            raise AssertionError(f"serial {label}: a flipped payload byte decoded without error")


def sharded_phase(data: bytes, blobs: dict, card: str, count_launches) -> dict:
    """compress_sharded / decompress_sharded in a one-rank NCCL group on
    cuda:0 at each arity, per-block and shared tables; -> {arity:
    launches of the path's kernels, summed over its two checked runs}."""
    import torch
    import torch.distributed as dist

    from data_compression_tpu_torch import CodecConfig, compress
    from data_compression_tpu_torch.config import max_chunk_bytes
    from data_compression_tpu_torch.parallel import (
        compress_sharded, decompress_sharded, make_mesh, multihost,
    )
    from data_compression_tpu_torch.parallel import pipeline

    dev = torch.device("cuda", 0)
    multihost.initialize("nccl", f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
                         device=dev)
    try:
        mesh = make_mesh(dev)
        totals = {}
        for n in ARITIES:
            total = totals[n] = {}
            for shared in (False, True):
                cfg = CodecConfig(arity=n, shared_table=shared)
                want = blobs[n] if not shared else compress(data, cfg, device="cuda")
                label = f"n={n}, {'shared table' if shared else 'per-block tables'}"

                def run():
                    f = compress_sharded(data, cfg, mesh)
                    return f, decompress_sharded(f, None, mesh)

                (frame, back), counts = count_launches(SHARDED_KERNELS, run)
                if frame != want:
                    raise AssertionError(f"sharded frame ({label}) differs from compress on cuda")
                if back != data:
                    raise AssertionError(f"sharded round trip ({label}) is not exact")
                for name, k in counts.items():
                    total[name] = total.get(name, 0) + k
                best = {}
                for _ in range(3):
                    f, ev_c, wall_c = timed(lambda: compress_sharded(data, cfg, mesh))
                    r, ev_d, wall_d = timed(lambda: decompress_sharded(f, None, mesh))
                    if f != want or r != data:
                        raise AssertionError(f"sharded output ({label}) differs between runs")
                    for k, v in (("compress_event", ev_c), ("compress_wall", wall_c),
                                 ("decompress_event", ev_d), ("decompress_wall", wall_d)):
                        best[k] = min(best.get(k, float("inf")), v)
                gbps = {k: len(data) / (v * 1e-3) / 1e9 for k, v in best.items()}
                log(f"sharded ({label}, 1 NCCL rank): frame == compress on cuda, round trip "
                    f"exact, launches {counts}; compress {gbps['compress_event']:.4f} GB/s "
                    f"(events) {gbps['compress_wall']:.4f} GB/s (wall); decompress "
                    f"{gbps['decompress_event']:.4f} GB/s (events) "
                    f"{gbps['decompress_wall']:.4f} GB/s (wall); best of 3, {len(data) // MIB} MiB; card {card}")

        # the collectives of the path at its n = 2 shapes (one rank)
        cfg = CodecConfig()
        nblk = -(-len(data) // cfg.block_size)
        ncb = cfg.block_size // cfg.chunk_syms
        rows = torch.empty((nblk * ncb, max_chunk_bytes(cfg.chunk_syms, 2)),
                           dtype=torch.uint8, device=dev)
        digits = torch.empty((nblk * ncb,), dtype=torch.int32, device=dev)
        hists = torch.empty((nblk, 256), dtype=torch.int64, device=dev)
        syms = torch.empty((nblk, cfg.block_size), dtype=torch.uint8, device=dev)
        hist_sum = torch.empty((256,), dtype=torch.int64, device=dev)
        coll = {
            "all_gather rows": chain_ms(lambda: pipeline._all_gather(rows, mesh)),
            "all_gather digits": chain_ms(lambda: pipeline._all_gather(digits, mesh)),
            "all_gather hists": chain_ms(lambda: pipeline._all_gather(hists, mesh)),
            "all_gather symbols": chain_ms(lambda: pipeline._all_gather(syms, mesh)),
            "all_reduce hist": chain_ms(lambda: dist.all_reduce(hist_sum)),
        }
        log("sharded collectives (1 NCCL rank, ms per call, CUDA events): "
            + ", ".join(f"{k} {v:.4f}" for k, v in coll.items()) + f"; card {card}")
        return totals
    finally:
        dist.destroy_process_group()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "data_compression_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: data_compression_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    import importlib

    from data_compression_tpu_torch import CodecConfig, compress, decompress, native
    from data_compression_tpu_torch.huffman import batched as hb
    from data_compression_tpu_torch.ops.kernels import _build
    from data_compression_tpu_torch.tools import timing
    from data_compression_tpu_torch.tools.e2e import cpu_model
    from data_compression_tpu_torch.utils.corpora import GENERATORS, deep_code_block, enwik_like

    # -- 1. the card
    card = timing.card()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    dev = torch.device("cuda", 0)

    # -- 2. build
    t0 = time.perf_counter()
    _build.lib()
    log(f"kernel build: {time.perf_counter() - t0:.3f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'})")
    for source in ("huffman_encode.cu", "compact.cu"):
        usage = _build.ptxas_usage(source)
        for fn, u in sorted(usage.items()):
            log(f"ptxas {source} {fn}: {u}")
        if not usage or any(u.get("stack", 1) or u.get("spill_stores", 1)
                            or u.get("spill_loads", 1) for u in usage.values()):
            raise AssertionError(f"a kernel of {source} uses stack or spills (nvcc -Xptxas -v above)")
    t0 = time.perf_counter()
    native.load()
    log(f"native runtime build: {time.perf_counter() - t0:.3f} s "
        f"(cc {native.build_seconds if native.build_seconds is not None else 'cached'}), "
        f"openmp {native.openmp}")

    # -- 3. each kernel against its plain version at the main path's shapes
    data = enwik_like(MAIN_BYTES - 64 * 1024, SEED) + deep_code_block(64 * 1024, SEED)
    mods = {m: importlib.import_module(f"data_compression_tpu_torch.ops.kernels.{m}")
            for m in {m for _, m, *_ in KERNELS} | {"copy", "microbench"}}
    results = {n: kernel_phase(n, data, mods, dev) for n in ARITIES}

    # -- 3b. the main path's table build: the native builder against the plain one
    host = f"{cpu_model()}, os.cpu_count() {os.cpu_count()}"
    table_phase(data, dev, host)
    wrappers = {name: getattr(mods[m], w) for name, m, w, *_ in KERNELS}
    wrappers["copy"] = mods["copy"].copy_blocks
    wrappers.update({f"lookup_{v}": fn for v, fn in mods["microbench"].WRAPPERS.items()})

    def count_launches(path_kernels, run):
        """Run one path with every count at 0; -> (result, launches of
        the path's kernels), raising if one of them never launched."""
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.synchronize()
        out = run()
        torch.cuda.synchronize()
        counts = {name: wrappers[name].launches for name in path_kernels}
        if not all(k > 0 for k in counts.values()):
            raise AssertionError(f"a kernel of the path never launched: {counts}")
        return out, counts

    # -- 4. the slice through the public entry points, at each arity
    blobs, slice_launches = {}, {}
    for n in ARITIES:
        cfg = CodecConfig(arity=n)

        def slice_run():
            b = compress(data, cfg, device="cuda")
            return b, decompress(b, device="cuda")

        (blob, back), slice_launches[n] = count_launches(SLICE_KERNELS, slice_run)
        if back != data:
            raise AssertionError(f"round trip on cuda at n={n} is not exact")
        blobs[n] = blob
        log(f"slice n={n}: {len(data) // MIB} MiB round trip exact, ratio {len(blob) / len(data):.6f}, "
            f"launches {slice_launches[n]}")
        rates(data, cfg, blob, f"slice n={n} kernel path", card, host)
        with mock.patch.object(hb, "capped_lengths_batch", hb.capped_lengths_batch_ref):
            rates(data, cfg, blob, f"slice n={n} kernel path, plain table builder", card, host)
        if n == 2:
            with plain_kernels([(mods[m], w, ref) for _, m, w, ref, *_ in KERNELS]):
                rates(data, cfg, blob, "slice n=2 plain path", card, host)

    # -- 5. the sharded pipeline in a one-rank NCCL group
    sharded_launches = sharded_phase(data, blobs, card, count_launches)

    # -- 6. wire parity with the JAX package's recorded hashes
    golden = json.loads((ROOT / "tests" / "data" / "torch_golden.json").read_text())
    for case in golden["cases"]:
        x = GENERATORS[case["gen"]](case["size"], case["seed"])
        cfg = CodecConfig(codec=case["codec"], arity=case["arity"],
                          shared_table=case["shared_table"],
                          isprint_literal=case["isprint_literal"])
        f = compress(x, cfg, device="cuda")
        digest = hashlib.sha256(f).hexdigest()
        if digest != case["sha256"] or len(f) != case["length"]:
            raise AssertionError(f"golden {case['name']}: frame differs from the JAX package's")
        if decompress(f, device="cuda") != x:
            raise AssertionError(f"golden {case['name']}: round trip failed")
        log(f"golden {case['name']}: sha256 and length match, round trip exact")

    # -- 7. the profiling tools and their kernels
    from data_compression_tpu_torch.tools import ablate, microbench

    tool_results = tool_kernel_phase(data, dev)
    for n in ARITIES:
        errs = ablate.check_stages(ablate.prepare(data, n, dev))
        torch.cuda.empty_cache()
        log(f"stages n={n}: every observable equals its definition from the plain full "
            f"versions (max abs err {errs})")

    def tools_run():
        reports = [ablate.run(n, MAIN_BYTES // MIB, dev, TRIAL_S) for n in ARITIES]
        return reports, microbench.run(dev, COLD_REPS)

    tools_path = [name for name, *_ in tool_kernels()] + list(SHARDED_KERNELS)
    (reports, variants), tool_launches = count_launches(tools_path, tools_run)
    for report in reports:
        log(f"tools.ablate: {json.dumps(report)}")
    for r in variants:
        log(f"tools.microbench: {json.dumps(r)}")
    log(f"tools launches {tool_launches}; card {card}")

    # -- 8. the serial codecs, made for cuda (they run on the host)
    serial_phase(data, card, host)

    log(f"card: {card}")
    print(json.dumps({"kernels": [
        dict(name=name, arity=n, route="cuda", source=src, replaces=rep,
             launches=slice_launches[n].get(name, 0) + sharded_launches[n].get(name, 0),
             **results[n][name])
        for n in ARITIES
        for name, _, _, _, src, rep in KERNELS
    ] + [
        dict(name=name, arity=None, route="cuda", source=src, replaces=rep,
             launches=tool_launches[name], **tool_results[name])
        for name, src, rep in tool_kernels()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
