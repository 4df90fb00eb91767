"""Device time of the device pipeline's stages on the card.

    python -m data_compression_tpu_torch.tools.device_stages [--mib 64] [--reps 1]

For n = 2, 16 and 3 on the chip smoke run's input (a seeded enwik-like
corpus plus one deep-code block, 64 KiB blocks): ms per call of the
per-block histogram on that input, on the same size of one byte value
(0) and of one random 16-byte record repeated (period 16), and on the
first streamed batch (``api.DEFAULT_BATCH_BLOCKS`` blocks) of each, of
the code lengths and encode table from the histograms
(``build_tables``), of the code lengths alone (``huffman_lengths``), of
``device_api.compress_blocks_device``, of the decode tables from the
compressed table rows by their kernel (``decode_tables``), by an empty
kernel on its grid (``decode_tables_floor``, where the package timed has
it) and by their plain torch ops (``decode_tables_device``), and of
``device_api.decode_blocks_device``; then, for each serial codec
(nybble, small_byte, small_nybble), of its encode lane on the blocks and
of its decode lane on that lane's payloads (``ops/kernels/
serial_lanes.py``), and of both nybble lanes on the same size of
one-context blocks (``deep_code_block`` seeds 0, 1, ...: nearly every
step's context is 1, the nybble encoder's worst case; ``codec``
"nybble_one_context").  Each time is the best of 3 chained trials
(``timing.time_chain``, ``*_ms``; where the host's enqueue of a call
outlasts its kernels, this is host time), and beside it the device time
per call of back-to-back calls held behind a spin kernel
(``timing.device_ms``, ``*_device_ms``).  One JSON line per arity or
codec and repetition, with the card's name and power limit and the
directory of the package that was timed (``root``: the first on
``sys.path``).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from data_compression_tpu_torch import CodecConfig, api, device_api, framing
from data_compression_tpu_torch.ops.kernels import compact as kcompact
from data_compression_tpu_torch.ops.kernels import histogram as khist
from data_compression_tpu_torch.ops.kernels import serial_lanes as lanes
from data_compression_tpu_torch.ops import table_build as tbd
from data_compression_tpu_torch.ops.kernels import table_build as ktb
from data_compression_tpu_torch.tools import timing
from data_compression_tpu_torch.utils.corpora import deep_code_block, enwik_like

ARITIES = (2, 16, 3)
SEED = 7
TRIAL_S = 0.05
LANE_ITERS = 4  # calls a lane's reading chains (each lane takes ms)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mib", type=int, default=64, help="input size in MiB")
    p.add_argument("--reps", type=int, default=1, help="repetitions of every reading")
    args = p.parse_args(argv)
    dev = timing.require_cuda("cuda")
    card = timing.card()
    size = args.mib << 20
    data = enwik_like(size - 65536, SEED) + deep_code_block(65536, SEED)
    blocks, lengths = framing.split_blocks(data, CodecConfig().block_size)
    dev_blocks = torch.from_numpy(blocks).to(dev)
    dev_lens = torch.from_numpy(lengths.astype(np.int32)).to(dev)
    one = torch.zeros_like(dev_blocks)
    record = torch.from_numpy(np.random.default_rng(SEED).integers(0, 256, 16, dtype=np.uint8))
    period = record.to(dev).repeat(dev_blocks.numel() // 16).view(dev_blocks.shape)
    batch = api.DEFAULT_BATCH_BLOCKS
    hists = khist.block_histograms(dev_blocks, dev_lens)
    ctx_blocks, ctx_lens = framing.split_blocks(
        b"".join(deep_code_block(65536, seed) for seed in range(size // 65536)),
        CodecConfig().block_size)
    lane_inputs = [(kind, kind, dev_blocks, dev_lens) for kind in lanes.KINDS] + [
        ("nybble_one_context", "nybble", torch.from_numpy(ctx_blocks).to(dev),
         torch.from_numpy(ctx_lens.astype(np.int32)).to(dev))]

    root = str(sys.modules["data_compression_tpu_torch"].__path__[0])

    def ms(fn, iters=12):
        return timing.time_chain(fn, iters=iters, min_trial_s=TRIAL_S) * 1e3

    for rep in range(args.reps):
        for n in ARITIES:
            cfg = CodecConfig(arity=n)
            dc = device_api.compress_blocks_device(dev_blocks, dev_lens, cfg, device=dev)
            inputs = device_api.chunk_inputs(dc)
            steps = {
                "histogram": lambda: khist.block_histograms(dev_blocks, dev_lens),
                "histogram_one_value": lambda: khist.block_histograms(one, dev_lens),
                "histogram_period16": lambda: khist.block_histograms(period, dev_lens),
                "histogram_batch": lambda: khist.block_histograms(dev_blocks[:batch],
                                                                  dev_lens[:batch]),
                "histogram_batch_one_value": lambda: khist.block_histograms(one[:batch],
                                                                            dev_lens[:batch]),
                "histogram_batch_period16": lambda: khist.block_histograms(period[:batch],
                                                                           dev_lens[:batch]),
                "tables": lambda: ktb.build_tables(hists, n),
                "lengths": lambda: ktb.huffman_lengths(hists, n),
                "compress": lambda: device_api.compress_blocks_device(dev_blocks, dev_lens, cfg,
                                                                      device=dev),
                "decode_tables": lambda: ktb.decode_tables(dc.table_rows, n),
                "decode_tables_floor": lambda: ktb.decode_tables_floor(dc.table_rows),
                "decode_tables_plain": lambda: tbd.decode_tables_device(dc.table_rows, n),
                "decompress": lambda: device_api.decode_blocks_device(
                    *inputs, dc.table_rows, n, cfg.chunk_syms, device=dev),
            }
            if not hasattr(ktb, "decode_tables_floor"):  # a package from before it
                del steps["decode_tables_floor"]
            row = {"root": root, "rep": rep, "arity": n, "mib": args.mib, "card": card}
            for name, step in steps.items():
                row[f"{name}_ms"] = ms(step)
                row[f"{name}_device_ms"] = timing.device_ms(step)
            row["compress_gbps"] = size / row["compress_ms"] / 1e6
            row["decompress_gbps"] = size / row["decompress_ms"] / 1e6
            print(json.dumps(row), flush=True)
        for label, kind, lane_blocks, lane_lens in lane_inputs:
            enc, dec = lanes.ENCODERS[kind], lanes.DECODERS[kind]
            rows, totals, status = enc(lane_blocks, lane_lens)
            ok = status == lanes.OK
            plens = totals[ok]
            dargs = (kcompact.compact_blocks(rows[ok], plens),
                     torch.cumsum(plens, 0, dtype=torch.int64) - plens, plens, lane_lens[ok],
                     blocks.shape[1])
            row = {"root": root, "rep": rep, "codec": label, "mib": args.mib,
                   "blocks": int(ok.sum()), "card": card}
            for name, step in (("encode", lambda: enc(lane_blocks, lane_lens)),
                               ("decode", lambda: dec(*dargs))):
                row[f"{name}_ms"] = ms(step, LANE_ITERS)
                row[f"{name}_device_ms"] = timing.device_ms(step, LANE_ITERS)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
