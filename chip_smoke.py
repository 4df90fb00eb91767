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
     the encode, compaction, histogram, table-build, decode-table,
     lookup, serial-lane and compress-finishing kernels
     (``_build.ptxas_usage``), requiring
     0 stack and 0 spill; build the native C runtime
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
     collectives; then the scaling harness's step,
     ``multihost.measure_encode_throughput`` on 64 MiB at the main path's
     geometry (its launches of the rows encode kernel > 0, counted into
     that kernel's entry at n = 2), whose gathered per-chunk wire bytes
     must equal the plain rows encode's on the same blocks and table,
     with its bytes/s, compute and collective seconds; the group is
     destroyed; then in child processes ``parallel.dryrun`` at one NCCL
     rank (every round trip exact) and ``tools.scaling_bench 1 64
     --device cuda``, whose reports are printed, and both at 2 ranks on
     ``cuda:0-1`` where the machine has a second card (otherwise a line
     says that run needs one; nothing runs in its place);
  6. wire parity: the frames of the golden inputs (Huffman at n = 2, 16
     and 3, and the serial codecs) must hash to the SHA-256 recorded from
     the JAX package, and decode back;
  7. the profiling tools: the copy kernel against ``clone()`` on the
     64 MiB input and each lookup-variant kernel against its plain
     version at B = 128 (byte equality), timed against both the HBM
     bound and the reachable floor (the cold time of ``copy_`` and of the
     copy kernel on the same 8 MiB); at each arity the rows-encode
     stages 1-2 and decode stages 1-3 observables against their
     definitions from the plain full versions (exact); then
     ``tools.ablate`` at 64 MiB per arity and ``tools.microbench``,
     their JSON logged, with the launch count
     of the copy kernel, every lookup variant, the rows-encode and the
     decode kernel > 0;
  8. the serial codecs' lanes (``csrc/nybble_lanes.cu``,
     ``csrc/small_lanes.cu``): each of the six lane kernels (encode and
     decode of nybble, small_byte, small_nybble) against the native
     batch drivers, rows and totals then the decode, on the whole 64 MiB
     input, on 64 KiB of one byte value and on 64 KiB of 7-bit random
     bytes, and against its plain version, byte for byte, on the same
     blocks and payloads (the plain step loop run on the card once on
     the 1,024 blocks and the two edge blocks together, and timed; every
     plain lane's step is one CUDA graph replay); each decoder also
     against the native decoder on 256 payloads of 64 KiB blocks, crafted
     (small codecs: the deepest words, each span's source ending where it
     is written; nybble: token streams ending at the body's end, one step
     or a literal's second nybble past it), real with flipped bytes or
     cut short, and random, with equal statuses and equal OK rows; the
     nybble lanes also on 64 MiB of one-context blocks (1,024
     ``deep_code_block`` seeds: nearly every step in context 1, the
     encoder's worst case), against the native batch drivers and timed
     (device ms); the small encoders
     and decoders also against the native batch drivers on three 24 MiB
     (small_byte) or 16 MiB (small_nybble) blocks, one of which rewrites
     each slot of its context more than 65,535 times
     (``corpora.long_small_blocks``); each timed at 64 MiB (chain and
     device ms) beside its HBM bound and its serial-chain floor (steps of
     the longest lane (nybble encode: the longest context chain of any
     block, counted on the host) x one step's dependent cycles read off
     the SASS, at the SM clock a spin kernel measures), with its CTAs resident an
     SM (occupancy API) and the waves of the 64 MiB launch.  Then each
     serial codec (literal, nybble,
     small_byte, small_byte with the ISPRINT mode, small_nybble) made for
     ``cuda``: ``compress`` -> ``decompress`` of the 64 MiB input must
     round-trip exactly through the lanes, each lane of its path and the
     compaction launched, and give the frame made for ``cpu``; ratio and
     compress / decompress GB/s of the lane route (``cuda``) and of the
     native route (``cpu``), each line naming its route; a frame with one
     payload byte flipped must raise ValueError on ``cuda``;
  9. streamed files: a 1 GiB file (16 copies of the 64 MiB input, each
     rotated by a seeded offset) through ``python -m
     data_compression_tpu_torch compress`` / ``decompress`` on cuda in
     child processes: the output must be exact, with 64 frames; frames 0
     and 63 must equal ``compress`` of their 16 MiB slices; each child's
     kernel launch counts must be > 0; compress / decompress GB/s, peak
     host RSS against a one-batch (16 MiB) file, whose growth must stay
     under 128 MiB (8 batches), and ``torch.cuda.max_memory_allocated``
     are printed; a printable round trip of one 16 MiB batch must be
     exact;
 10. the histogram kernel against its plain version (``index_add_``)
     and numpy on the 64 MiB input, on 64 MiB of one byte value and on 64
     MiB of a 16-byte record repeated, on the first 256 blocks of each
     (one streamed batch) and on their first 7 (whose rows the kernel
     cuts into slices, a thread-block cluster a row), byte for byte,
     all timed; then the device-resident pipeline at n = 2, 16
     and 3 on the 64 MiB input: the table-build kernel's code lengths and
     encode table (``build_tables``, one launch) must equal its plain
     version's and the native builder's; ``compress_blocks_device`` and
     ``decode_blocks_device`` run under
     ``torch.cuda.set_sync_debug_mode("error")`` (no host read either
     way), the frame must equal phase 4's and the decode must give back
     the input; the decode-table kernel (``decode_tables``) must equal its
     plain version and the host's ``decode_tensors``; device GB/s of each
     direction (best of 3 chains, CUDA events) are printed beside the
     time of each stage and of the decompress as it ran before the
     decode-table kernel (torch-op tables, the checked decode).

Every compress path runs the histogram kernel: its launches must be > 0
in phases 4, 5, 9 (the streamed compress child) and 10.

The line before the last is a JSON object of the kernels, one entry
per kernel and arity (name, arity, route, source, the TPU kernel it
replaces, launches in that arity's runs of phases 4, 5 and 10, or for
the tools' kernels in phase 7, each counted from 0, max abs error against
the plain version, ms per call, plain ms per call, the bound: the
bytes the call must move at 3.35 TB/s (the table build's: its
histograms in, its code lengths and encode table out; the histogram's:
the valid bytes and lengths in, the counts out; the "replaces" of
these two names the JAX function, which reaches no Pallas kernel, as
does the decode-table kernel's: its rows in, its tables out), and
library ms, the time of one PyTorch call computing the same function,
or null; the histogram has one entry (arity null) whose launches sum
phases 4, 5, 9 and 10, whose library ms is its ``index_add_`` plain
version's, ``one_value_ms`` / ``one_value_plain_ms`` on the
one-value input, ``period16_*`` on the 16-byte record, ``batch_*`` and
``period16_batch_*`` on the first 256 blocks (``batch_slices`` slices a
row; ``small_batch_slices`` for 7 blocks); the decode tables have
``launch_floor_ms``, the device ms of an empty kernel on their grid;
the table build's ``lengths_only_ms`` is the same
kernel writing lengths alone (``huffman_lengths``); the histogram, the
table build and the decode tables have ``device_ms`` (their chain times
include the wrapper's enqueue, which can outlast the kernel; the decode
tables' ``plain_device_ms`` too); the compaction entries have
``device_ms``, the copy kernel's ``device_ms`` and
``library_device_ms``: device time per call of back-to-back calls held
behind a spin kernel, ``tools.timing.device_ms``; the lookup entries
have ``floor_ms`` / ``floor_copy_kernel_ms`` (the reachable floor) and
``warm_ms`` (device ms with the input warm in L2); the six lanes' entries
(arity null, launches summed over phase 8's codec runs, "replaces" the
JAX lane, which reaches no Pallas kernel) have ``device_ms``, the plain
version's ms at ``plain_shape``, ``hbm_bound_ms`` and
``chain_floor_ms`` with its steps, cycles a step and ``sm_mhz``, the
higher of the two as ``bound_ms``, ``layout``, ``ctas_per_sm``,
``blocks_per_cta``, ``threads_per_cta``, ``smem_per_cta`` (read off the
kernel at the launch's block size, ``serial_lanes.lane_occupancy``) and ``waves``; the small
encoders' ``long_block_*``: the long blocks' size, a slot's rewrites and the three statuses;
the decoders' ``random_payloads``: blocks, OK and FORMAT statuses of the payload mix; the nybble
lanes' ``one_context_device_ms`` and ``one_context_chain_steps`` on the one-context input).  A time per call is the best of 3 trials
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
import re
import shutil
import socket
import subprocess
import sys
import tempfile
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
SLICE_KERNELS = ("histogram", "huffman_encode", "compact", "huffman_decode")
SHARDED_KERNELS = ("histogram", "huffman_encode_rows", "huffman_decode")
DEVICE_KERNELS = ("histogram", "table_build", "huffman_encode", "compact", "decode_tables",
                  "huffman_decode")
TABLE_BUILD = ("table_build", "data_compression_tpu_torch/csrc/table_build.cu",
               "data_compression_tpu/ops/table_build.py:230")
DECODE_TABLES = ("decode_tables", "data_compression_tpu_torch/csrc/decode_tables.cu",
                 "data_compression_tpu/ops/table_build.py:320")
HISTOGRAM = ("histogram", "data_compression_tpu_torch/csrc/histogram.cu",
             "data_compression_tpu/ops/histogram.py:23")
STREAM_COPIES = 16  # phase 9: copies of the 64 MiB input in the streamed file
RSS_GROWTH_LIMIT = 128 * MIB  # phase 9: 8 batches of 16 MiB
# phase 9's child: the CLI as ``python -m`` runs it, then on stderr its
# peak RSS (resident pages of /proc/self/statm, or VmRSS, sampled every
# millisecond by a thread: ru_maxrss would carry the parent's peak across
# fork and exec, and not every /proc has VmHWM; null if no sample was
# taken), device memory and kernel launches
CLI_CHILD = r"""
import json, os, runpy, sys, threading, time
peak = [None]
def rss():
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except OSError:
        with open("/proc/self/status") as f:
            return 1024 * int(next(ln.split()[1] for ln in f if ln.startswith("VmRSS:")))
def sample():
    while True:
        peak[0] = max(peak[0] or 0, rss())
        time.sleep(0.001)
threading.Thread(target=sample, daemon=True).start()
sys.argv = ["data_compression_tpu_torch"] + sys.argv[1:]
try:
    runpy.run_module("data_compression_tpu_torch", run_name="__main__")
except SystemExit as e:
    if e.code:
        raise
import torch
from data_compression_tpu_torch.ops.kernels import compact, decode, encode, histogram
print("CHILD " + json.dumps({
    "peak_rss": peak[0],
    "max_memory_allocated": torch.cuda.max_memory_allocated(),
    "launches": {"histogram": histogram.block_histograms.launches,
                 "huffman_encode": encode.encode_blocks.launches,
                 "compact": compact.compact_blocks.launches,
                 "huffman_decode": decode.decode_chunks.launches}}), file=sys.stderr)
"""
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
        device_ms=timing.device_ms(launch),
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
            + ("" if "device_ms" not in r else f"; device {r['device_ms']:.4f} ms"))
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
        device_ms=timing.device_ms(lambda: kcopy.copy_blocks(x)),
        library_device_ms=timing.device_ms(lambda: dst.copy_(x)),
    )
    del x, y, dst, everywhere

    s, tables = microbench.make_inputs(microbench.B, dev)
    everywhere = torch.ones_like(s, dtype=torch.bool)
    floor = microbench.floors(dev, COLD_REPS)
    log(f"lookups: reachable floor of one cold 8 MiB launch: copy_ "
        f"{floor['floor_copy_ms']:.4f} ms, copy kernel {floor['floor_copy_kernel_ms']:.4f} ms "
        f"(HBM bound {bound_ms(2 * s.numel()):.4f} ms)")
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
            floor_ms=floor["floor_copy_ms"], floor_copy_kernel_ms=floor["floor_copy_kernel_ms"],
            warm_ms=timing.device_ms(lambda: kmb.lookup_variant(name, s, t)),
        )
    for name, r in results.items():
        log(f"kernel {name}: max_abs_err {r['max_abs_err']} kernel {r['ms']:.4f} ms "
            f"plain {r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms"
            + ("" if r["library_ms"] is None else f" library {r['library_ms']:.4f} ms")
            + ("" if "device_ms" not in r else f"; device {r['device_ms']:.4f} ms, "
               f"library device {r['library_device_ms']:.4f} ms")
            + ("" if "floor_ms" not in r else f"; reachable floor {r['floor_ms']:.4f} ms "
               f"({r['ms'] / r['floor_ms']:.3f}x), warm in L2 "
               f"{r['warm_ms']:.4f} ms"))
    return results


def rates(data: bytes, cfg, blob: bytes, label: str, card: str, host: str,
          device: str = "cuda") -> None:
    """Best of 3 compress / decompress GB/s of ``data`` on ``device``."""
    from data_compression_tpu_torch import compress, decompress

    best = {}
    for _ in range(3):
        b, ev_c, wall_c = timed(lambda: compress(data, cfg, device=device))
        r, ev_d, wall_d = timed(lambda: decompress(b, device=device))
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
    from data_compression_tpu_torch.ops.kernels.histogram import block_histograms

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


LANES = [
    # (name, codec, direction, source, JAX lane it replaces (no Pallas kernel))
    ("nybble_encode", "nybble", "encode", "data_compression_tpu_torch/csrc/nybble_lanes.cu",
     "data_compression_tpu/ops/scan_codecs.py:47"),
    ("nybble_decode", "nybble", "decode", "data_compression_tpu_torch/csrc/nybble_lanes.cu",
     "data_compression_tpu/ops/scan_codecs.py:115"),
    ("small_byte_encode", "small_byte", "encode", "data_compression_tpu_torch/csrc/small_lanes.cu",
     "data_compression_tpu/ops/scan_codecs.py:297"),
    ("small_byte_decode", "small_byte", "decode", "data_compression_tpu_torch/csrc/small_lanes.cu",
     "data_compression_tpu/ops/scan_codecs.py:191"),
    ("small_nybble_encode", "small_nybble", "encode",
     "data_compression_tpu_torch/csrc/small_lanes.cu", "data_compression_tpu/ops/scan_codecs.py:454"),
    ("small_nybble_decode", "small_nybble", "decode",
     "data_compression_tpu_torch/csrc/small_lanes.cu", "data_compression_tpu/ops/scan_codecs.py:603"),
]
# One step's serial chain: (shared-memory loads, dependent integer
# operations) from one step's state to the next's, read off the SASS of
# the committed kernels (`cuobjdump -sass` of the library that
# `ops/kernels/_build.py` builds); a floor only goes down, so an entry
# keeps its old count where the compiled chain is longer.
# nybble encode (one context's chain, its row in two registers; was
# (1, 12) with the row in shared memory): the splat's XOR, the zero-byte
# add and mask, the low word's borrow, the high word's (IADD3.X), its
# XOR and the merge: 7 operations, no load.  Its steps are the longest
# context chain of any block, counted on the host.
# nybble decode (was (1, 17)): from one row load to the next, the
# forwarded row's select, the byte (`__byte_perm`, predicated on the
# record), the context's row offset (`& 0x78`) and the address: 4
# operations and the load; the move-to-front that the next select also
# waits on (the splat, XOR, zero-byte add and mask, the borrows (2), XOR,
# merge: 9 operations) is shorter at these costs.
# small encode: the target key from the index, the compares
# and offers (2), the two-level minimum (2), the warp's minimum
# (`__reduce_min_sync`), the test and the next index (2) (scheme B: the
# literal shortcut's select); no shared load.
# small decode (read off the SASS; the span copy runs in another warp):
# from one entry load to the next, scheme A the context's row offset by
# shift and mask (2), the fixed row's select, the index's merge and the
# address (the exit test, before the next lookup, is as long: the length
# by shift and mask, the word's end, the compare, the branch); scheme B
# the length (2), its test, the last three nybbles (4), the byte by
# parity (4), the row offset, select, merge and address (4): 15 compiled;
# it keeps the 14 it had, as a floor only goes down.
LANE_CHAIN = {"nybble_encode": (0, 7), "nybble_decode": (1, 4),
              "small_byte_encode": (0, 8), "small_byte_decode": (1, 5),
              "small_nybble_encode": (0, 9), "small_nybble_decode": (1, 14)}
SHARED_LOAD_CYCLES = 30  # H100 shared-memory load latency, about 30 cycles (assumed)
INT_OP_CYCLES = 4  # a dependent integer operation, about 4 cycles (assumed)
LANE_EDGE_BYTES = 65536  # phase 8: one block of one byte value, one of 7-bit random bytes
# phase 8: the small encoders on blocks long enough that some dictionary
# slot is written more than 65,535 times (a 16-bit generation counter
# would wrap): bytes whose context is all one (& 31 == 1) put every insert
# into one context's 127 (scheme A) or 128 (scheme B) slots, at about
# 0.41 / 0.55 words a byte (native encoder)
LONG_LANE_BYTES = {"small_byte": 24 << 20, "small_nybble": 16 << 20}
SERIAL = [
    # (label, config kwargs, lanes of its path)
    ("literal", dict(codec="literal"), ()),
    ("nybble", dict(codec="nybble"), ("nybble_encode", "nybble_decode")),
    ("small_byte", dict(codec="small_byte"), ("small_byte_encode", "small_byte_decode")),
    ("small_byte isprint_literal", dict(codec="small_byte", isprint_literal=True),
     ("small_byte_encode", "small_byte_decode")),
    ("small_nybble", dict(codec="small_nybble"), ("small_nybble_encode", "small_nybble_decode")),
]


def sm_cycles_per_ms() -> float:
    """The SM clock as a spin of 50M cycles (``torch.cuda._sleep``) reads
    it on CUDA events: cycles per ms."""
    import torch

    cycles = 50_000_000
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def lane_check(kind: str, blocks, lengths, dev, label: str) -> tuple:
    """Encode and decode lane kernels of ``kind`` against the native batch
    drivers on ``blocks``: payload rows and totals, then the decode of
    the native payloads; -> (device blocks, lengths, rows, totals, status,
    (flat payloads, offsets, plens, raw lens, S)), the inputs and outputs
    held against the plain versions and timed."""
    import numpy as np
    import torch

    from data_compression_tpu_torch import native
    from data_compression_tpu_torch.models.nybble import seven_bit_blocks
    from data_compression_tpu_torch.ops.kernels import serial_lanes as lanes

    dev_blocks = torch.from_numpy(blocks).to(dev)
    dev_lens = torch.from_numpy(lengths.astype(np.int32)).to(dev)
    rows, totals, status = lanes.ENCODERS[kind](dev_blocks, dev_lens)
    ok = seven_bit_blocks(blocks, lengths) if kind != "small_nybble" else np.ones(len(lengths), bool)
    st = status.cpu().numpy()
    if not np.array_equal(st == lanes.OK, ok) or bool((st[~ok] != lanes.INPUT).any()):
        raise AssertionError(f"{label}: {kind} encode lane status differs from the 7-bit test")
    idx = np.flatnonzero(ok)
    want = native.encode_batch(kind, blocks[idx], lengths[idx])
    rows_h, tot_h = rows.cpu().numpy(), totals.cpu().numpy()
    for k, i in enumerate(idx):
        if rows_h[i, : tot_h[i]].tobytes() != want[k]:
            raise AssertionError(f"{label}: {kind} encode lane differs from native (block {i})")
    plens = np.array([len(p) for p in want], np.int64)
    offsets = np.zeros(len(want), np.int64)
    np.cumsum(plens[:-1], out=offsets[1:])
    flat = torch.from_numpy(np.frombuffer(b"".join(want), np.uint8).copy()).to(dev)
    args = (flat, torch.from_numpy(offsets).to(dev), torch.from_numpy(plens.astype(np.int32)).to(dev),
            torch.from_numpy(lengths[idx].astype(np.int32)).to(dev), blocks.shape[1])
    out, st = lanes.DECODERS[kind](*args)
    if bool((st != lanes.OK).any()):
        raise AssertionError(f"{label}: {kind} decode lane refused a native payload")
    out_h = out.cpu().numpy()
    for k, i in enumerate(idx):
        if out_h[k, : lengths[i]].tobytes() != blocks[i, : lengths[i]].tobytes():
            raise AssertionError(f"{label}: {kind} decode lane differs from the input (block {i})")
    log(f"lanes {kind}, {label}: encode rows and totals equal the native batch driver's on "
        f"{len(idx)} blocks ({len(lengths) - len(idx)} raw), decode gives back every block")
    return dev_blocks, dev_lens, rows, totals, status, args


def lane_against_plain(kind: str, main: tuple, edges: tuple, dev) -> tuple:
    """The lane kernels' outputs on the main path's blocks and on the two
    edge blocks (``lane_check``'s tuples) against their plain versions,
    run on the card once on those blocks together (a lane reads only its
    own block, and the plain step loop costs the same at B = 1026 as at
    1024); -> (encode err, decode err, plain encode ms, plain decode ms)."""
    import torch

    from data_compression_tpu_torch.ops.kernels import serial_lanes as lanes

    if kind == "nybble":
        plain_enc, plain_dec = lanes.nybble_encode_ref, lanes.nybble_decode_ref
    else:
        nyb = kind == "small_nybble"
        plain_enc = lambda b, n: lanes.small_encode_ref(b, n, nyb)  # noqa: E731
        plain_dec = lambda *a: lanes.small_decode_ref(*a, nyb)  # noqa: E731
    blocks, lens, rows, totals, status = (torch.cat((m, e)) for m, e in zip(main[:5], edges[:5]))
    (rows_r, totals_r, status_r), enc_ms, _ = timed(lambda: plain_enc(blocks, lens))
    if not (torch.equal(totals, totals_r) and torch.equal(status, status_r)):
        raise AssertionError(f"{kind} encode lane totals or status differ from the plain version's")
    enc_err = max_abs_err(rows, rows_r, torch.arange(rows.shape[1], device=dev)[None, :]
                          < totals[:, None].long())
    (fm, om, pm, rm, S), (fe, oe, pe, re, _) = main[5], edges[5]
    args = (torch.cat((fm, fe)), torch.cat((om, oe + fm.numel())), torch.cat((pm, pe)),
            torch.cat((rm, re)), S)
    (out_r, st_r), dec_ms, _ = timed(lambda: plain_dec(*args))
    outs = [lanes.DECODERS[kind](*a) for a in (main[5], edges[5])]
    out, st = torch.cat([o for o, _ in outs]), torch.cat([s for _, s in outs])
    if not torch.equal(st, st_r):
        raise AssertionError(f"{kind} decode lane status differs from the plain version's")
    dec_err = max_abs_err(out, out_r, torch.arange(S, device=dev)[None, :] < args[3][:, None].long())
    return enc_err, dec_err, enc_ms, dec_ms


def long_lane_check(kind: str, dev) -> dict:
    """The small encoder (and decoder) of ``kind`` against the native
    batch drivers on ``corpora.long_small_blocks``; -> what the kernels
    line notes."""
    import numpy as np

    from data_compression_tpu_torch.utils.corpora import long_small_blocks

    S = LONG_LANE_BYTES[kind]
    blocks, lengths = long_small_blocks(S, SEED), np.full(3, S, np.int64)
    _, _, _, totals, status, _ = lane_check(kind, blocks, lengths, dev, f"3 x {S} bytes")
    words = int(totals[0]) - 2
    slots = 128 if kind == "small_nybble" else 127
    writes = (words - 1) // slots  # every word but the first inserts into context 1
    if writes <= 65535:
        raise AssertionError(f"{kind}: the one-context block wrote a slot only {writes} times")
    log(f"lanes {kind}: {S}-byte blocks equal the native batch driver's; the one-context block's "
        f"{words} words write each slot of its context at least {writes} times (> 65,535)")
    return {"long_block_bytes": S, "long_block_slot_writes": writes,
            "long_block_status": status.cpu().tolist()}


def decode_mix_against_native(kind: str, dev) -> dict:
    """The decoder of ``kind`` against the native decoder on 256 payloads
    of 64 KiB blocks (``corpora.payload_mix``: crafted streams (the small
    codecs' deepest words; nybble token streams ending at the body's end,
    one step or a literal's second nybble past it), a real payload with
    flipped bytes or cut short, random bodies); statuses must be equal and
    OK rows equal; -> the counts."""
    import numpy as np
    import torch

    from data_compression_tpu_torch import native
    from data_compression_tpu_torch.ops.kernels import serial_lanes as lanes
    from data_compression_tpu_torch.utils.corpora import enwik_like, payload_mix

    S = LANE_EDGE_BYTES
    real = getattr(native, f"{kind}_encode")(enwik_like(S, SEED))
    payloads, raws = payload_mix(kind, S, 256, SEED, real)
    plens = np.array([len(p) for p in payloads], np.int64)
    offsets = np.concatenate([[0], np.cumsum(plens)[:-1]]).astype(np.int64)
    flat = np.frombuffer(b"".join(payloads), np.uint8).copy()
    out, st = lanes.DECODERS[kind](
        torch.from_numpy(flat).to(dev), torch.from_numpy(offsets).to(dev),
        torch.from_numpy(plens.astype(np.int32)).to(dev),
        torch.tensor(raws, dtype=torch.int32, device=dev), S)
    out, st = out.cpu().numpy(), st.cpu().numpy()
    ok = 0
    for i, (p, n) in enumerate(zip(payloads, raws)):
        try:
            want = getattr(native, f"{kind}_decode")(p, n)
        except ValueError:
            want = None
        if st[i] != (lanes.FORMAT if want is None else lanes.OK):
            raise AssertionError(f"{kind} decode lane: status {st[i]} on payload {i}, "
                                 f"native {'refuses' if want is None else 'decodes'} it")
        if want is not None:
            if out[i, :n].tobytes() != want:
                raise AssertionError(f"{kind} decode lane differs from native on payload {i}")
            ok += 1
    if not 0 < ok < len(payloads):
        raise AssertionError(f"{kind}: the payload mix gave {ok} OK blocks of {len(payloads)}")
    log(f"lanes {kind}: decode of {len(payloads)} crafted, corrupted, cut and random payloads "
        f"({S}-byte blocks) gives the native decoder's statuses ({ok} OK, "
        f"{len(payloads) - ok} FORMAT) and its bytes on every OK block")
    return {"blocks": len(payloads), "ok": ok, "format": len(payloads) - ok}


def one_context_phase(dev, card: str) -> dict:
    """Both nybble lanes on 64 MiB of one-context blocks (1,024
    ``deep_code_block`` seeds: symbols 0-15, nearly every step in context
    1, so the encoder's block is one 64K-step chain), against the native
    batch drivers, then timed (device ms); -> {direction: kernels-line
    keys}."""
    from data_compression_tpu_torch import CodecConfig, framing
    from data_compression_tpu_torch.ops.kernels import serial_lanes as lanes
    from data_compression_tpu_torch.tools import timing
    from data_compression_tpu_torch.utils.corpora import deep_code_block

    one = b"".join(deep_code_block(LANE_EDGE_BYTES, seed) for seed in range(1024))
    blocks, lengths = framing.split_blocks(one, CodecConfig().block_size)
    fb, fl, _, _, _, dargs = lane_check("nybble", blocks, lengths, dev, "64 MiB of one context")
    chain = lanes.longest_context_chain(blocks, lengths)
    enc_ms = timing.device_ms(lambda: lanes.nybble_encode(fb, fl), 4)
    dec_ms = timing.device_ms(lambda: lanes.nybble_decode(*dargs), 4)
    log(f"lanes nybble, one context ({len(lengths)} deep-code blocks, longest context chain "
        f"{chain} steps): encode {enc_ms:.4f} device ms, decode {dec_ms:.4f} device ms; card {card}")
    return {"encode": {"one_context_device_ms": enc_ms, "one_context_chain_steps": chain},
            "decode": {"one_context_device_ms": dec_ms,
                       "one_context_chain_steps": int(lengths.max()) - 1}}


def lane_phase(data: bytes, dev, card: str) -> dict:
    """Phase 8a: each lane kernel against the native batch drivers on the
    whole 64 MiB input, on 64 KiB of one byte value and on 64 KiB of
    7-bit random bytes, and against its plain version, run on the card on
    all those blocks (byte for byte, the plain version timed); each timed
    at 64 MiB with its two bounds; -> {lane: kernels-line entry}."""
    import numpy as np
    import torch

    from data_compression_tpu_torch import CodecConfig, framing
    from data_compression_tpu_torch.ops.kernels import serial_lanes as lanes
    from data_compression_tpu_torch.tools import timing

    blocks, lengths = framing.split_blocks(data, CodecConfig().block_size)
    rng = np.random.default_rng(SEED)
    edges = np.stack([np.full(LANE_EDGE_BYTES, ord("a"), np.uint8),
                      rng.integers(0, 128, LANE_EDGE_BYTES, dtype=np.uint8)])
    results = {}
    for kind in ("nybble", "small_byte", "small_nybble"):
        enc, dec = lanes.ENCODERS[kind], lanes.DECODERS[kind]
        # the native batch drivers on the edge blocks and at full size
        edge = lane_check(kind, edges, np.full(2, LANE_EDGE_BYTES, np.int64), dev,
                          "64 KiB of one value, 7-bit random")
        main = lane_check(kind, blocks, lengths, dev, "64 MiB")
        enc_err, dec_err, enc_plain_ms, dec_plain_ms = lane_against_plain(kind, main, edge, dev)
        plain_shape = f"{len(lengths) + len(edges)} x {blocks.shape[1]}"
        log(f"lanes {kind}: kernels equal their plain versions on the 64 MiB input and the two "
            f"edge blocks, {plain_shape} bytes (max abs err {enc_err} / {dec_err}); plain "
            f"encode {enc_plain_ms:.1f} ms, plain decode {dec_plain_ms:.1f} ms on the card; "
            f"card {card}")
        long = long_lane_check(kind, dev) if kind != "nybble" else {}
        fb, fl, _, totals, _, dargs = main
        n = lengths.astype(np.int64)
        tot = totals.cpu().numpy().astype(np.int64)
        plens = dargs[2].cpu().numpy().astype(np.int64)
        steps = {"encode": int(n.max()) * (2 if kind == "small_nybble" else 1)
                 - (2 if kind == "small_byte" else 3),
                 "decode": int(n.max()) - 1 if kind == "nybble" else int(plens.max()) - 2}
        extra = {"encode": {}, "decode": {}}
        if kind == "nybble":
            steps["encode"] = lanes.longest_context_chain(blocks, lengths)
            extra = one_context_phase(dev, card)
        moved = {"encode": int(n.sum()) + nbytes_of(fl) + int(tot.sum()) + 8 * len(n),
                 "decode": int(plens.sum()) + 16 * len(plens) + int(n[tot > 0].sum())
                 + 4 * len(plens)}
        timings = {
            "encode": (chain_ms(lambda: enc(fb, fl), 2), timing.device_ms(lambda: enc(fb, fl), 4)),
            "decode": (chain_ms(lambda: dec(*dargs), 2), timing.device_ms(lambda: dec(*dargs), 4)),
        }
        clock = sm_cycles_per_ms()
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for direction, plain_ms, err in (("encode", enc_plain_ms, enc_err),
                                         ("decode", dec_plain_ms, dec_err)):
            name = f"{kind}_{direction}"
            loads, ops = LANE_CHAIN[name]
            cycles = loads * SHARED_LOAD_CYCLES + ops * INT_OP_CYCLES
            floor = steps[direction] * cycles / clock
            hbm = bound_ms(moved[direction])
            ms, dms = timings[direction]
            results[name] = dict(
                max_abs_err=err, ms=ms, device_ms=dms, plain_ms=plain_ms, plain_shape=plain_shape,
                bound_ms=max(floor, hbm), bound_by="operations" if floor >= hbm else "bytes",
                hbm_bound_ms=hbm, chain_floor_ms=floor, chain_steps=steps[direction],
                chain_step_cycles=cycles, sm_mhz=clock / 1e3, library_ms=None)
            occ = lanes.lane_occupancy(name, blocks.shape[1])
            ctas, per_cta = occ["ctas_per_sm"], occ["blocks_per_cta"]
            waves = -(-len(n) // (ctas * per_cta * sms))
            results[name].update(**occ, waves=waves, **(long if direction == "encode" else {}),
                                 **extra[direction])
            if direction == "decode":
                results[name]["random_payloads"] = decode_mix_against_native(kind, dev)
            log(f"kernel {name}: 64 MiB {ms:.4f} ms (device {dms:.4f} ms); HBM bound "
                f"{hbm:.4f} ms, serial-chain floor {floor:.4f} ms ({steps[direction]} steps x "
                f"{cycles} cycles at {clock / 1e3:.0f} MHz), {ms / max(floor, hbm):.2f}x the "
                f"higher; plain {plain_ms:.1f} ms on {plain_shape}; {ctas} CTAs x {per_cta} "
                f"blocks an SM resident, {len(n)} blocks in {waves} wave(s); card {card}")
        del fb, fl, totals, dargs, main, edge
        torch.cuda.empty_cache()
    return results


def serial_phase(data: bytes, card: str, host: str, count_launches) -> dict:
    """Phase 8b: each serial codec made for cuda: exact round trip of
    ``data`` through its lanes (each lane and the compaction launched),
    the frame equal to the one made for cpu (the native route); ratio and
    GB/s of both routes; one flipped payload byte must raise.  -> the
    launches of each lane, summed over the codecs' runs."""
    from data_compression_tpu_torch import CodecConfig, compress, decompress, framing, native

    launches = {}
    for label, kw, path in SERIAL:
        cfg = CodecConfig(**kw)

        def run():
            b = compress(data, cfg, device="cuda")
            return b, decompress(b, device="cuda")

        (blob, back), counts = count_launches(path + (("compact",) if path else ()), run)
        if back != data:
            raise AssertionError(f"serial {label}: round trip on cuda is not exact")
        cpu_blob = compress(data, cfg, device="cpu")
        if blob != cpu_blob:
            raise AssertionError(f"serial {label}: the cuda frame differs from the cpu frame")
        for name in path:
            launches[name] = launches.get(name, 0) + counts[name]
        route = "host, pass-through" if not path else "lanes (CUDA kernels)"
        log(f"serial {label}: {len(data) // MIB} MiB round trip exact on cuda, frame == cpu "
            f"frame, ratio {len(blob) / len(data):.6f}, route {route}, launches {counts}")
        rates(data, cfg, blob, f"serial {label}, cuda route: {route}", card, host)
        if path:
            native_route = f"native, {'OpenMP' if native.openmp else 'serial'} batch drivers"
            rates(data, cfg, blob, f"serial {label}, cpu route: {native_route}", card, host,
                  device="cpu")
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
    return launches


def sharded_phase(data: bytes, blobs: dict, card: str, count_launches) -> dict:
    """compress_sharded / decompress_sharded in a one-rank NCCL group on
    cuda:0 at each arity, per-block and shared tables; -> {arity:
    launches of the path's kernels, summed over its two checked runs}."""
    import torch
    import torch.distributed as dist

    from data_compression_tpu_torch import CodecConfig, compress
    from data_compression_tpu_torch.config import max_chunk_bytes, wire_bytes
    from data_compression_tpu_torch.ops.kernels import encode
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

        # the scaling harness's step at the main path's geometry (n = 2)
        report, counts = count_launches(
            ("huffman_encode_rows",),
            lambda: multihost.measure_encode_throughput(cfg, len(data), device=dev))
        blocks, lens, dense = multihost.encode_share(cfg, len(data), mesh)
        gathered = multihost.encode_counts(blocks, lens, dense, cfg, mesh)
        _, digits = encode.encode_chunk_rows_ref(blocks, lens, dense, cfg.chunk_syms, cfg.arity)
        if not torch.equal(gathered, wire_bytes(digits, cfg.arity)):
            raise AssertionError("measure_encode_throughput's counts differ from the plain "
                                 "rows encode's")
        totals[2]["huffman_encode_rows"] += counts["huffman_encode_rows"]
        log(f"measure_encode_throughput (1 NCCL rank, {len(data) // MIB} MiB, "
            f"{cfg.block_size // 1024} KiB blocks of {ncb} x {cfg.chunk_syms}): gathered counts == "
            f"plain rows encode's, launches {counts}; bytes_per_s {report['bytes_per_s']:.1f}, "
            f"best_s {report['best_s']:.6f}, compute_s {report['compute_s']:.6f}, "
            f"collective_s {report['collective_s']:.6f}; card {card}")
        return totals
    finally:
        dist.destroy_process_group()


def multiproc_phase(card: str) -> None:
    """The dry run and the scaling tool on cuda in child processes: one
    rank, and two where the machine has a second card."""
    import torch

    from data_compression_tpu_torch.parallel import dryrun

    ranks = (1, 2) if torch.cuda.device_count() >= 2 else (1,)
    for n in ranks:
        report = dryrun.dryrun_multichip(n, "cuda", timeout=300)
        log(f"dryrun_multichip ({n} NCCL rank{'s' if n > 1 else ''}): {json.dumps(report)}")
        with tempfile.TemporaryDirectory() as tmp:
            out = Path(tmp) / "scaling.json"
            r = subprocess.run([sys.executable, "-m", "data_compression_tpu_torch.tools.scaling_bench",
                                str(n), str(MAIN_BYTES // MIB), "--device", "cuda", "--out", str(out),
                                "--timeout", "240"],
                               cwd=ROOT, capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise AssertionError(f"scaling_bench {n}: exit {r.returncode}\n{r.stderr[-3000:]}")
            report = json.loads(out.read_text())
            log(f"scaling_bench {n} {MAIN_BYTES // MIB} --device cuda: {json.dumps(report)}; "
                f"card {card}")
    if ranks == (1,):
        log(f"dryrun_multichip and scaling_bench at 2 NCCL ranks: not run, they need a second "
            f"card (this machine has {torch.cuda.device_count()})")


def run_cli(args, label: str) -> dict:
    """One CLI command in a child process on cuda; -> its report (peak
    RSS, device memory, launches) with the wall seconds and the seconds
    the CLI printed for its own work."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", CLI_CHILD, *args], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"{label}: exit {r.returncode}\n{r.stderr[-3000:]}")
    report = json.loads(r.stderr.split("CHILD ", 1)[1])
    if report["peak_rss"] is None:
        raise AssertionError(f"{label}: the child took no sample of its RSS")
    m = re.search(r"\(ratio [0-9.]+, ([0-9.]+)s on|\(([0-9.]+)s on", r.stderr)
    if m is None:
        raise AssertionError(f"{label}: no time in the CLI's report\n{r.stderr[-2000:]}")
    report.update(wall_s=wall, cli_s=float(m.group(1) or m.group(2)))
    return report


def same_files(a: Path, b: Path) -> bool:
    with open(a, "rb") as f, open(b, "rb") as g:
        while True:
            x, y = f.read(64 * MIB), g.read(64 * MIB)
            if x != y:
                return False
            if not x:
                return True


def stream_phase(data: bytes, card: str) -> dict:
    """The streamed CLI on a 1 GiB file against its one-batch baseline;
    -> the kernel launches of the 1 GiB file's compress child."""
    import numpy as np

    from data_compression_tpu_torch import CodecConfig, api, compress, decompress, framing

    cfg = CodecConfig()
    batch = api.DEFAULT_BATCH_BLOCKS * cfg.block_size
    offsets = np.random.default_rng(SEED).integers(0, len(data), STREAM_COPIES)
    build = ROOT / "data_compression_tpu_torch" / "build"
    build.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="stream-", dir=build))
    try:
        src, one = work / "in", work / "one"
        with open(src, "wb") as f:
            for off in offsets.tolist():
                f.write(data[off:])
                f.write(data[:off])
        one.write_bytes(data[:batch])
        size = src.stat().st_size
        reports = {}
        for name, path in (("one batch", one), ("1 GiB", src)):
            out, back = work / (path.name + ".dctz"), work / (path.name + ".back")
            c = run_cli(["compress", str(path), str(out)], f"compress {name}")
            d = run_cli(["decompress", str(out), str(back)], f"decompress {name}")
            if not same_files(path, back):
                raise AssertionError(f"streamed round trip ({name}) is not exact")
            for label, rep in (("compress", c), ("decompress", d)):
                kernels = SLICE_KERNELS[:3] if label == "compress" else SLICE_KERNELS[3:]
                if not all(rep["launches"][k] > 0 for k in kernels):
                    raise AssertionError(f"{label} {name}: a kernel never launched: "
                                         f"{rep['launches']}")
            reports[name] = (c, d, out)
        frames, first, last = 0, None, None
        with open(reports["1 GiB"][2], "rb") as f:
            while (frame := framing.read_frame(f)) is not None:
                first = frame if frames == 0 else first
                last, frames = frame, frames + 1
        want = -(-size // batch)
        if frames != want:
            raise AssertionError(f"streamed file has {frames} frames, not {want}")
        with open(src, "rb") as f:
            head = f.read(batch)
            f.seek((want - 1) * batch)
            tail = f.read()
        if first != compress(head, cfg, device="cuda") or last != compress(tail, cfg, device="cuda"):
            raise AssertionError("streamed first or last frame differs from compress of its slice")
        for name, (c, d, out) in reports.items():
            n = (size if name == "1 GiB" else batch)
            log(f"stream {name} ({n} bytes -> {out.stat().st_size}): compress "
                f"{n / c['cli_s'] / 1e9:.4f} GB/s in the CLI, {n / c['wall_s'] / 1e9:.4f} GB/s "
                f"with the child's start; decompress {n / d['cli_s'] / 1e9:.4f} / "
                f"{n / d['wall_s'] / 1e9:.4f} GB/s; peak host RSS compress "
                f"{c['peak_rss'] / MIB:.1f} MiB, decompress {d['peak_rss'] / MIB:.1f} MiB; "
                f"max_memory_allocated compress {c['max_memory_allocated'] / MIB:.1f} MiB, "
                f"decompress {d['max_memory_allocated'] / MIB:.1f} MiB; launches "
                f"{c['launches']} / {d['launches']}; card {card}")
        for i, label in enumerate(("compress", "decompress")):
            growth = reports["1 GiB"][i]["peak_rss"] - reports["one batch"][i]["peak_rss"]
            log(f"stream {label}: peak RSS growth from one batch to 1 GiB {growth / MIB:.1f} MiB "
                f"(limit {RSS_GROWTH_LIMIT // MIB} MiB)")
            if growth > RSS_GROWTH_LIMIT:
                raise AssertionError(f"streamed {label} RSS grew {growth / MIB:.1f} MiB")
        log(f"stream: {frames} frames; frames 0 and {frames - 1} == compress of their slices")
        launches = reports["1 GiB"][0]["launches"]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    text = compress(data[:batch], cfg, device="cuda", printable=True)
    t1 = time.perf_counter()
    if not text.startswith(framing.PRINTABLE_MAGIC) or decompress(text, device="cuda") != data[:batch]:
        raise AssertionError("printable round trip of one batch is not exact")
    log(f"stream printable: one batch ({batch} bytes -> {len(text)} printable) round trip exact; "
        f"compress {(t1 - t0) * 1e3:.1f} ms, decompress {(time.perf_counter() - t1) * 1e3:.1f} ms "
        "(host wall)")
    return launches


def histogram_phase(data: bytes, dev, card: str) -> dict:
    """The histogram kernel against its plain version (``index_add_``) and
    numpy's counts on the 64 MiB input, on 64 MiB of one byte value (0,
    zero padding) and on 64 MiB of one random 16-byte record repeated
    (period 16: every thread loads the same vector), on the first
    streamed batch's 256 blocks of each (phase 9's shape) and on their
    first 7 blocks, whose rows the kernel cuts into slices (a cluster a
    row), byte for byte; -> its kernels-line entry, with the one-value,
    period-16 and batch times."""
    import numpy as np
    import torch

    from data_compression_tpu_torch import CodecConfig, api, framing
    from data_compression_tpu_torch.ops.kernels import histogram as khist
    from data_compression_tpu_torch.tools import timing

    blocks, lengths = framing.split_blocks(data, CodecConfig().block_size)
    dev_blocks = torch.from_numpy(blocks).to(dev)
    dev_lens = torch.from_numpy(lengths.astype(np.int32)).to(dev)
    one = torch.zeros_like(dev_blocks)
    record = np.random.default_rng(SEED).integers(0, 256, 16, dtype=np.uint8)
    period_host = np.tile(record, blocks.size // 16).reshape(blocks.shape)
    period = torch.from_numpy(period_host).to(dev)
    everywhere = torch.ones((dev_blocks.shape[0], 256), dtype=torch.bool, device=dev)

    def counts(host):
        return np.stack([np.bincount(host[i, :lengths[i]], minlength=256)
                         for i in range(len(lengths))])

    want = counts(blocks)
    want_one = np.zeros_like(want)
    want_one[:, 0] = lengths
    want_period = counts(period_host)
    batch, small = api.DEFAULT_BATCH_BLOCKS, 7
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slices = khist.slices_for(batch, blocks.shape[1], sms)
    small_slices = khist.slices_for(small, blocks.shape[1], sms)
    if small_slices < 2:
        raise AssertionError(f"a batch of {small} blocks is not cut into slices ({small_slices})")
    errs = []
    for name, rows, wanted in (("text", dev_blocks, want), ("one value", one, want_one),
                               ("period 16", period, want_period)):
        for n_rows in (len(lengths), batch, small):
            rws, lens, w = rows[:n_rows], dev_lens[:n_rows], wanted[:n_rows]
            got = khist.block_histograms(rws, lens)
            errs.append(max_abs_err(got, khist.block_histograms_ref(rws, lens),
                                    everywhere[:n_rows]))
            if not np.array_equal(got.cpu().numpy(), w):
                raise AssertionError(f"histogram kernel ({name}, {n_rows} blocks) differs from "
                                     "numpy's counts")
    part, part_lens, part_one = dev_blocks[:batch], dev_lens[:batch], one[:batch]
    part_period = period[:batch]
    got = khist.block_histograms(dev_blocks, dev_lens)
    got_part = khist.block_histograms(part, part_lens)
    plain_ms = chain_ms(lambda: khist.block_histograms_ref(dev_blocks, dev_lens))
    entry = dict(
        max_abs_err=max(errs),
        ms=chain_ms(lambda: khist.block_histograms(dev_blocks, dev_lens)),
        device_ms=timing.device_ms(lambda: khist.block_histograms(dev_blocks, dev_lens)),
        plain_ms=plain_ms,
        bound_ms=bound_ms(int(lengths.sum()) + nbytes_of(dev_lens, got)), bound_by="bytes",
        library_ms=plain_ms,  # the plain version is one index_add_ (and its index math)
        one_value_ms=chain_ms(lambda: khist.block_histograms(one, dev_lens)),
        one_value_plain_ms=chain_ms(lambda: khist.block_histograms_ref(one, dev_lens)),
        batch_slices=slices, small_batch_slices=small_slices,
        batch_ms=chain_ms(lambda: khist.block_histograms(part, part_lens)),
        batch_device_ms=timing.device_ms(lambda: khist.block_histograms(part, part_lens)),
        batch_one_value_ms=chain_ms(lambda: khist.block_histograms(part_one, part_lens)),
        batch_plain_ms=chain_ms(lambda: khist.block_histograms_ref(part, part_lens)),
        batch_bound_ms=bound_ms(int(lengths[:batch].sum()) + nbytes_of(part_lens, got_part)),
        period16_ms=chain_ms(lambda: khist.block_histograms(period, dev_lens)),
        period16_device_ms=timing.device_ms(lambda: khist.block_histograms(period, dev_lens)),
        period16_batch_ms=chain_ms(lambda: khist.block_histograms(part_period, part_lens)),
        period16_batch_device_ms=timing.device_ms(
            lambda: khist.block_histograms(part_period, part_lens)),
    )
    log(f"kernel histogram: 64 MiB of text, of one byte value and of a 16-byte record equal "
        f"the plain version and numpy's counts, and so do their first {batch} blocks (slices "
        f"a row: {slices}) and {small} blocks (slices a row: {small_slices}) (max_abs_err "
        f"{entry['max_abs_err']}); kernel {entry['ms']:.4f} ms "
        f"(device {entry['device_ms']:.4f} ms), one value {entry['one_value_ms']:.4f} ms, "
        f"period 16 {entry['period16_ms']:.4f} ms (device {entry['period16_device_ms']:.4f} "
        f"ms); plain (index_add_) {entry['plain_ms']:.4f} ms, one value "
        f"{entry['one_value_plain_ms']:.4f} ms; bound {entry['bound_ms']:.4f} ms; {batch} "
        f"blocks: kernel {entry['batch_ms']:.4f} ms (device {entry['batch_device_ms']:.4f} ms), "
        f"one value {entry['batch_one_value_ms']:.4f} ms, period 16 "
        f"{entry['period16_batch_ms']:.4f} ms (device {entry['period16_batch_device_ms']:.4f} "
        f"ms), plain {entry['batch_plain_ms']:.4f} ms, bound {entry['batch_bound_ms']:.4f} ms; "
        f"card {card}")
    return entry


def device_phase(data: bytes, blobs: dict, dev, card: str, count_launches) -> tuple:
    """The device-resident pipeline at each arity; -> ({arity: launches of
    its kernels}, {arity: the table-build kernel's kernels-line entry},
    {arity: the decode-table kernel's})."""
    import numpy as np
    import torch

    from data_compression_tpu_torch import CodecConfig, device_api, framing
    from data_compression_tpu_torch.huffman import batched as hb
    from data_compression_tpu_torch.ops import table_build as tbd
    from data_compression_tpu_torch.ops.kernels import compact as kcompact
    from data_compression_tpu_torch.ops.kernels import decode as kdecode
    from data_compression_tpu_torch.ops.kernels import encode as kencode
    from data_compression_tpu_torch.ops.kernels import table_build as ktb
    from data_compression_tpu_torch.ops.kernels.histogram import block_histograms
    from data_compression_tpu_torch.tools import timing

    blocks, lengths = framing.split_blocks(data, CodecConfig().block_size)
    dev_blocks = torch.from_numpy(blocks).to(dev)
    dev_lens = torch.from_numpy(lengths.astype(np.int32)).to(dev)
    valid = torch.arange(blocks.shape[1], device=dev)[None, :] < dev_lens[:, None]
    hists = block_histograms(dev_blocks, dev_lens)
    host_hists = hists.cpu().numpy()
    launches, entries, dt_entries = {}, {}, {}
    for n in ARITIES:
        cfg = CodecConfig(arity=n)
        C = cfg.chunk_syms
        lengths_k, dense_k = ktb.build_tables(hists, n)
        lengths_r, dense_r = ktb.build_tables_ref(hists, n)
        native = hb.capped_lengths_batch(host_hists, n)
        native_dense = hb.dense_rows(hb.codes_batch(native, n)).reshape(len(native), -1)
        if not (np.array_equal(lengths_k.cpu().numpy(), native)
                and np.array_equal(ktb.huffman_lengths(hists, n).cpu().numpy(), native)):
            raise AssertionError(f"table build n={n}: lengths differ from the native builder's")
        if not np.array_equal(dense_k.cpu().numpy(), native_dense):
            raise AssertionError(f"table build n={n}: encode table differs from the native one")
        entries[n] = dict(
            max_abs_err=max(max_abs_err(lengths_k, lengths_r, torch.ones_like(lengths_k).bool()),
                            max_abs_err(dense_k, dense_r, torch.ones_like(dense_k).bool())),
            ms=chain_ms(lambda: ktb.build_tables(hists, n)),
            device_ms=timing.device_ms(lambda: ktb.build_tables(hists, n)),
            plain_ms=chain_ms(lambda: ktb.build_tables_ref(hists, n), 1),
            bound_ms=bound_ms(nbytes_of(hists, lengths_k, dense_k)), bound_by="bytes",
            library_ms=None,
            lengths_only_ms=chain_ms(lambda: ktb.huffman_lengths(hists, n)),
        )

        def run():
            torch.cuda.set_sync_debug_mode("error")
            try:
                dc = device_api.compress_blocks_device(dev_blocks, dev_lens, cfg, device=dev)
                inputs = device_api.chunk_inputs(dc)
                out = device_api.decode_blocks_device(*inputs, dc.table_rows, n, C, device=dev)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            return dc, inputs, out

        (dc, inputs, out), launches[n] = count_launches(DEVICE_KERNELS, run)
        if device_api.to_frame(dc, blocks, cfg) != blobs[n]:
            raise AssertionError(f"device pipeline n={n}: frame differs from compress's")
        if not torch.equal(out.view(dev_blocks.shape)[valid], dev_blocks[valid]):
            raise AssertionError(f"device pipeline n={n}: decode did not give back the input")
        table_rows = dc.table_rows
        tables_k = ktb.decode_tables(table_rows, n)
        tables_r = tbd.decode_tables_device(table_rows, n)
        host = hb.decode_tensors(hb.codes_batch(table_rows.cpu().numpy().astype(np.int64), n),
                                 "cpu").values()
        if not all(torch.equal(k.cpu(), h) for k, h in zip(tables_k, host)):
            raise AssertionError(f"decode tables n={n}: differ from the host builder's")

        def plain_tables():
            return tbd.decode_tables_device(table_rows, n)

        dt_entries[n] = dict(
            max_abs_err=max(max_abs_err(k, r, torch.ones_like(k).bool())
                            for k, r in zip(tables_k, tables_r)),
            ms=chain_ms(lambda: ktb.decode_tables(table_rows, n)),
            device_ms=timing.device_ms(lambda: ktb.decode_tables(table_rows, n)),
            plain_ms=chain_ms(plain_tables), plain_device_ms=timing.device_ms(plain_tables),
            bound_ms=bound_ms(nbytes_of(table_rows, *tables_k)), bound_by="bytes",
            library_ms=None,
            launch_floor_ms=timing.device_ms(lambda: ktb.decode_tables_floor(table_rows)),
        )
        lim, bmf, syms = tables_k
        rows, digits, bb = kencode.encode_blocks(dev_blocks, dev_lens, dense_k, C, n)
        total = int(bb.long().sum())
        stage = {
            "histogram kernel": chain_ms(lambda: block_histograms(dev_blocks, dev_lens)),
            "table build kernel (lengths and encode table)": entries[n]["ms"],
            "encode kernel": chain_ms(lambda: kencode.encode_blocks(dev_blocks, dev_lens, dense_k,
                                                                    C, n)),
            "compaction kernel, out_cap B*S": chain_ms(
                lambda: kcompact.compact_blocks(rows, bb, total=dev_blocks.numel())),
            "decode tables kernel": dt_entries[n]["ms"],
            "decode tables (torch ops, plain)": dt_entries[n]["plain_ms"],
            "decode kernel": chain_ms(kdecode.decode_launcher(*inputs, lim, bmf, syms, C, n,
                                                              check=False)),
            "decode kernel with its input check (one host read)": chain_ms(
                lambda: kdecode.decode_chunks(*inputs, lim, bmf, syms, C, n)),
        }
        del rows, digits, bb

        def decompress():
            return device_api.decode_blocks_device(*inputs, table_rows, n, C, device=dev)

        comp = chain_ms(lambda: device_api.compress_blocks_device(dev_blocks, dev_lens, cfg,
                                                                  device=dev))
        dec = chain_ms(decompress)
        dec_device = timing.device_ms(decompress)  # raises if the decompress reads back
        before = chain_ms(lambda: kdecode.decode_chunks(*inputs, *plain_tables(), C, n))
        log(f"device pipeline n={n}: no host read in compress or decompress (sync debug mode "
            f"error), frame == compress's, decode exact; launches {launches[n]}; payload {total} "
            f"bytes; compress {comp:.4f} ms = {len(data) / comp / 1e6:.2f} GB/s, decompress "
            f"{dec:.4f} ms = {len(data) / dec / 1e6:.2f} GB/s (best of 3 chains, CUDA events), "
            f"device {dec_device:.4f} ms; the decompress as before the decode-table kernel "
            f"(torch-op tables, checked decode with one host read) {before:.4f} ms = "
            f"{len(data) / before / 1e6:.2f} GB/s; stages ms: "
            + ", ".join(f"{k} {v:.4f}" for k, v in stage.items()) + f"; card {card}")
        d = dt_entries[n]
        log(f"kernel decode_tables n={n}: == plain == host decode_tensors (max_abs_err "
            f"{d['max_abs_err']}); kernel {d['ms']:.4f} ms (device {d['device_ms']:.4f} ms), "
            f"plain (torch ops) {d['plain_ms']:.4f} ms (device {d['plain_device_ms']:.4f} ms), "
            f"bound {d['bound_ms']:.4f} ms, an empty kernel on its grid (device) "
            f"{d['launch_floor_ms']:.4f} ms")
        e = entries[n]
        log(f"kernel table_build n={n}: lengths == native == plain, encode table == native == "
            f"plain (max_abs_err {e['max_abs_err']}); kernel {e['ms']:.4f} ms (device "
            f"{e['device_ms']:.4f} ms; lengths only "
            f"{e['lengths_only_ms']:.4f} ms) plain {e['plain_ms']:.4f} ms bound "
            f"{e['bound_ms']:.4f} ms")
        del dc, out, inputs, tables_k, tables_r
        torch.cuda.empty_cache()
    return launches, entries, dt_entries


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
    for source in ("huffman_encode.cu", "compact.cu", "histogram.cu", "table_build.cu",
                   "decode_tables.cu", "microbench.cu", "nybble_lanes.cu", "small_lanes.cu",
                   "compress_chain.cu"):
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
    wrappers["table_build"] = importlib.import_module(
        "data_compression_tpu_torch.ops.kernels.table_build").build_tables
    wrappers["decode_tables"] = importlib.import_module(
        "data_compression_tpu_torch.ops.kernels.table_build").decode_tables
    wrappers["histogram"] = importlib.import_module(
        "data_compression_tpu_torch.ops.kernels.histogram").block_histograms
    wrappers["copy"] = mods["copy"].copy_blocks
    from data_compression_tpu_torch.ops.kernels import serial_lanes

    wrappers.update({f"{kind}_{d}": fns[kind] for d, fns in (("encode", serial_lanes.ENCODERS),
                                                              ("decode", serial_lanes.DECODERS))
                     for kind in serial_lanes.KINDS})
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
    multiproc_phase(card)

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

    # -- 8. the serial codecs' lanes, and the serial codecs made for cuda
    lane_results = lane_phase(data, dev, card)
    lane_launches = serial_phase(data, card, host, count_launches)

    # -- 9. streamed files through the CLI on cuda
    stream_launches = stream_phase(data, card)

    # -- 10. the device-resident pipeline
    hist_result = histogram_phase(data, dev, card)
    device_launches, table_results, dt_results = device_phase(data, blobs, dev, card,
                                                              count_launches)

    log(f"card: {card}")
    print(json.dumps({"kernels": [
        dict(name=name, arity=n, route="cuda", source=src, replaces=rep,
             launches=(slice_launches[n].get(name, 0) + sharded_launches[n].get(name, 0)
                       + device_launches[n].get(name, 0)),
             **results[n][name])
        for n in ARITIES
        for name, _, _, _, src, rep in KERNELS
    ] + [
        dict(name=HISTOGRAM[0], arity=None, route="cuda", source=HISTOGRAM[1],
             replaces=HISTOGRAM[2],
             launches=sum(runs[n]["histogram"] for runs in (slice_launches, sharded_launches,
                                                            device_launches) for n in ARITIES)
             + stream_launches["histogram"],
             **hist_result)
    ] + [
        dict(name=TABLE_BUILD[0], arity=n, route="cuda", source=TABLE_BUILD[1],
             replaces=TABLE_BUILD[2], launches=device_launches[n]["table_build"],
             **table_results[n])
        for n in ARITIES
    ] + [
        dict(name=DECODE_TABLES[0], arity=n, route="cuda", source=DECODE_TABLES[1],
             replaces=DECODE_TABLES[2], launches=device_launches[n]["decode_tables"],
             **dt_results[n])
        for n in ARITIES
    ] + [
        dict(name=name, arity=None, route="cuda", source=src, replaces=rep,
             launches=tool_launches[name], **tool_results[name])
        for name, src, rep in tool_kernels()
    ] + [
        dict(name=name, arity=None, route="cuda", source=src, replaces=rep,
             launches=lane_launches[name], **lane_results[name])
        for name, _, _, src, rep in LANES
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
