#!/usr/bin/env python3
"""Bring-up smoke run of ``data_compression_tpu_torch`` on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA device
and ``nvcc``.  It needs no arguments, no environment variables and no
network; it imports nothing of JAX.  Phases (any failure raises and the
script exits non-zero without a result line):

  1. print the card (``nvidia-smi`` name and power limit);
  2. build the CUDA kernels from ``data_compression_tpu_torch/csrc``;
  3. run each kernel against its plain PyTorch version on the card at
     the main path's shapes (64 MiB = 1024 blocks of 64 KiB, C = 512:
     a seeded enwik-like corpus plus one deep-code block) and require
     byte equality of the valid bytes;
  4. the slice: ``compress`` -> ``decompress`` of the 64 MiB input on
     ``cuda`` must round-trip, with every kernel's launch count > 0;
     then compress / decompress GB/s for the kernel path and for the
     plain path (each kernel wrapper swapped for its plain version);
  5. wire parity: the frames of the golden inputs must hash to the
     SHA-256 recorded from the JAX package, and decode back.

The line before the last is a JSON object of the kernels (name, route,
source, the TPU kernel it replaces, launches in the phase-4 run, max
abs error against the plain version, ms per call, plain ms per call);
the last line is ``{"ok": true, "device": {...}}``.  Exits non-zero
without printing a result when no CUDA device is available or when the
package is not beside this script.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MIB = 1 << 20
MAIN_BYTES = 64 * MIB
SEED = 7

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
]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call of ``fn`` by CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def max_abs_err(a, b, valid) -> int:
    """Largest |a - b| over the valid positions; raises unless 0."""
    err = int((a.to(int) - b.to(int)).abs()[valid].max()) if bool(valid.any()) else 0
    if err:
        raise AssertionError(f"kernel disagrees with its plain version (max abs err {err})")
    return err


@contextmanager
def plain_kernels(modules):
    """Swap each kernel wrapper for its plain version (on any device)."""
    saved = []
    for mod, wrapper, ref in modules:
        saved.append((mod, wrapper, getattr(mod, wrapper)))
        setattr(mod, wrapper, getattr(mod, ref))
    try:
        yield
    finally:
        for mod, wrapper, fn in saved:
            setattr(mod, wrapper, fn)


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

    from data_compression_tpu_torch import CodecConfig, compress, decompress, framing
    from data_compression_tpu_torch.models.huffman import HuffmanCodec
    from data_compression_tpu_torch.ops.kernels import _build
    from data_compression_tpu_torch.utils.corpora import deep_code_block, enwik_like

    # -- 1. the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    dev = torch.device("cuda", 0)

    # -- 2. build
    t0 = time.perf_counter()
    _build.lib()
    log(f"kernel build: {time.perf_counter() - t0:.3f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'})")

    # -- 3. each kernel against its plain version at the main path's shapes
    data = enwik_like(MAIN_BYTES - 64 * 1024, SEED) + deep_code_block(64 * 1024, SEED)
    cfg = CodecConfig()
    codec = HuffmanCodec(cfg, dev)
    blocks, lengths = framing.split_blocks(data, cfg.block_size)
    dev_blocks, dev_lens = codec.upload_blocks(blocks, lengths)
    tb, _ = codec.tables(dev_blocks, dev_lens)
    if int(tb.max_len[-1]) != 15:
        raise AssertionError("deep-code block lost its 15-digit codes")
    from data_compression_tpu_torch.huffman.batched import to_device

    dense = to_device(tb, dev)["dense"]
    C = cfg.chunk_syms
    mods = {m: importlib.import_module(f"data_compression_tpu_torch.ops.kernels.{m}")
            for _, m, *_ in KERNELS}
    enc, cmp_, dec = mods["encode"], mods["compact"], mods["decode"]
    results = {}

    rows, digits, bb = enc.encode_blocks(dev_blocks, dev_lens, dense, C)
    rows_r, digits_r, bb_r = enc.encode_blocks_ref(dev_blocks, dev_lens, dense, C)
    torch.cuda.synchronize()
    if not (torch.equal(digits, digits_r) and torch.equal(bb, bb_r)):
        raise AssertionError("encode: digit or byte counts differ from the plain version")
    valid = torch.arange(rows.shape[1], device=dev)[None, :] < bb[:, None].long()
    results["huffman_encode"] = dict(
        max_abs_err=max_abs_err(rows, rows_r, valid),
        ms=cuda_ms(lambda: enc.encode_blocks(dev_blocks, dev_lens, dense, C), 20),
        plain_ms=cuda_ms(lambda: enc.encode_blocks_ref(dev_blocks, dev_lens, dense, C), 3),
    )
    del rows_r, digits_r, bb_r

    flat = cmp_.compact_blocks(rows, bb)
    flat_r = cmp_.compact_blocks_ref(rows, bb)
    if flat.shape != flat_r.shape:
        raise AssertionError("compact: output sizes differ")
    results["compact"] = dict(
        max_abs_err=max_abs_err(flat, flat_r, torch.ones_like(flat, dtype=torch.bool)),
        ms=cuda_ms(lambda: cmp_.compact_blocks(rows, bb), 20),
        plain_ms=cuda_ms(lambda: cmp_.compact_blocks_ref(rows, bb), 3),
    )
    del rows, flat, flat_r

    frame = framing.unpack_frame(compress(data, cfg, device=dev))
    if any(e.is_literal for e in frame.entries):
        raise AssertionError("main-path input fell back to LITERAL blocks")
    args, _ = codec.decode_inputs(
        frame.payloads, [e.raw_len for e in frame.entries], frame.shared_table
    )
    out = dec.decode_chunks(**args)
    out_r = dec.decode_chunks_ref(**args)
    valid = torch.arange(C, device=dev)[None, :] < args["chunk_cnt"][:, None]
    results["huffman_decode"] = dict(
        max_abs_err=max_abs_err(out, out_r, valid),
        ms=cuda_ms(lambda: dec.decode_chunks(**args), 20),
        plain_ms=cuda_ms(lambda: dec.decode_chunks_ref(**args), 2),
    )
    del out, out_r, args
    for name, r in results.items():
        log(f"kernel {name}: max_abs_err {r['max_abs_err']} "
            f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms")

    # -- 4. the slice through the public entry points
    for _, m, w, *_ in KERNELS:
        getattr(mods[m], w).launches = 0
    torch.cuda.synchronize()
    blob = compress(data, CodecConfig(), device="cuda")
    back = decompress(blob, device="cuda")
    torch.cuda.synchronize()
    launches = {name: getattr(mods[m], w).launches for name, m, w, *_ in KERNELS}
    if back != data:
        raise AssertionError("64 MiB round trip on cuda is not exact")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    ratio = len(blob) / len(data)
    log(f"slice: 64 MiB round trip exact, ratio {ratio:.6f}, launches {launches}")

    def rates(label):
        best = {}
        for _ in range(3):
            b, ev_c, wall_c = timed(lambda: compress(data, CodecConfig(), device="cuda"))
            r, ev_d, wall_d = timed(lambda: decompress(b, device="cuda"))
            if b != blob or r != data:
                raise AssertionError(f"{label} path output differs")
            for k, v in (("compress_event", ev_c), ("compress_wall", wall_c),
                         ("decompress_event", ev_d), ("decompress_wall", wall_d)):
                best[k] = min(best.get(k, float("inf")), v)
        gbps = {k: len(data) / (v * 1e-3) / 1e9 for k, v in best.items()}
        log(f"slice {label}: compress {gbps['compress_event']:.4f} GB/s (events) "
            f"{gbps['compress_wall']:.4f} GB/s (wall); decompress "
            f"{gbps['decompress_event']:.4f} GB/s (events) "
            f"{gbps['decompress_wall']:.4f} GB/s (wall); best of 3, 64 MiB; card {card}")
        return gbps

    rates("kernel path")
    with plain_kernels([(mods[m], w, ref) for _, m, w, ref, *_ in KERNELS]):
        rates("plain path")

    # -- 5. wire parity with the JAX package's recorded hashes
    golden = json.loads((ROOT / "tests" / "data" / "torch_golden.json").read_text())
    for case in golden["cases"]:
        x = (enwik_like(case["size"], case["seed"]) if case["gen"] == "enwik_like"
             else deep_code_block(case["size"], case["seed"]))
        f = compress(x, CodecConfig(shared_table=case["shared_table"]), device="cuda")
        digest = hashlib.sha256(f).hexdigest()
        if digest != case["sha256"] or len(f) != case["length"]:
            raise AssertionError(f"golden {case['name']}: frame differs from the JAX package's")
        if decompress(f, device="cuda") != x:
            raise AssertionError(f"golden {case['name']}: round trip failed")
        log(f"golden {case['name']}: sha256 and length match, round trip exact")

    log(f"card: {card}")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=launches[name], **results[name])
        for name, _, _, _, src, rep in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
