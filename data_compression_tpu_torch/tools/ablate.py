"""Stage ablation of the Huffman rows-encode and decode kernels on a CUDA
device, with the compact encode kernel beside them.

    python -m data_compression_tpu_torch.tools.ablate [arity] [mb] [--out FILE] [--device cuda]
    python -m data_compression_tpu_torch.tools.ablate [arity] --smoke [--device cpu]

Counterpart of the JAX package's ``tools/ablate.py``.  The input is ``mb``
MiB (default 64: 8 MiB would sit in the 50 MB L2) of the seeded
enwik-like corpus (``utils.corpora.enwik_like``, seed 0) in 64 KiB
blocks of 128 chunks x 512 symbols, with the port's own per-block tables
(``HuffmanCodec.tables``) and decode inputs (``HuffmanCodec.decode_inputs``
of the rows kernel's payloads).  ``arity`` is 2 (default), 3 or 16;
other arities have no kernels and raise ValueError.

Times are best-of-3 CUDA-event trials of back-to-back launches, each
trial at least 0.25 s (``timing.time_chain``).  The report (one JSON
line on stdout, also written to ``--out``; progress on stderr):

  arity, mb, used_symbols_mean (symbols with a code, mean over blocks)
  passthrough_ms / passthrough_gbps  the copy kernel over [B, 512, 128]
  passthrough_library_ms             Tensor.copy_ of the same bytes
  encode_stage{1,2,3}_ms             cumulative: the rows kernel at stages=k
  encode_lookup_ms, encode_merge_ms, encode_wire_ms
                                     stage 1, 2 - 1, 3 - 2; encode_gbps
  encode_compact_ms                  the compact encode kernel (the
                                     single-device path's) on the same input
  compact_ms, compact_bytes          the block compaction kernel alone
                                     (``compact_launcher``: offsets once,
                                     then the launch) on the compact
                                     encode's rows, and the payload bytes it
                                     moves; compact_gbps = bytes / compact_ms
  compact_wrapper_ms                 ``compact_blocks`` on the same rows:
                                     offsets, bounds check and total with
                                     one host read, then the launch
  decode_window_walk_ms, decode_rank_ms, decode_ranksym_ms, decode_store_ms
                                     the decode kernel's stage 1, 2 - 1,
                                     3 - 2, 4 - 3; decode_gbps
  copy_envelope_gbps                 timing.measure_envelope
  device_ms                          {passthrough, passthrough_library,
                                     encode_stage{1,2,3}, encode_compact,
                                     compact, decode_stage{1..4}:
                                     device ms per call of back-to-back
                                     calls held behind a spin kernel
                                     (timing.device_ms)}, against which a
                                     chain time shows whether the device or
                                     the host set it; compact_wrapper reads
                                     back to the host, so its reading is
                                     torch.profiler's
                                     (timing.profiled_device_ms_or_none,
                                     null where no session was whole)

``--smoke`` runs on ``--device`` (default cuda, as every entry point;
``--device cpu`` runs the plain versions) one
16 KiB + 8 KiB input at ``chunk_syms`` = 128 through the rows encode and
the decode (their plain versions on the CPU) at every stage, checks each
stage's observable against its definition and the round trip, times
nothing, and prints ``{"smoke": true, "roundtrip_ok": ..., "blocks": 2}``
last.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional

import numpy as np
import torch

from data_compression_tpu_torch import framing
from data_compression_tpu_torch.config import (
    FAST_ARITIES,
    CodecConfig,
    max_chunk_bytes,
    wire_bytes,
)
from data_compression_tpu_torch.huffman import batched as hb
from data_compression_tpu_torch.models.huffman import HuffmanCodec
from data_compression_tpu_torch.ops.kernels import compact as kcmp
from data_compression_tpu_torch.ops.kernels import copy as kcopy
from data_compression_tpu_torch.ops.kernels import decode as kdec
from data_compression_tpu_torch.ops.kernels import encode as kenc
from data_compression_tpu_torch.tools import timing
from data_compression_tpu_torch.utils.corpora import enwik_like

MIB = 1 << 20
LANES = 128
SEED = 0


@dataclasses.dataclass
class Inputs:
    """One ablation input on its device, with its tables and the decode
    kernel's arguments."""

    data: bytes
    arity: int
    chunk_syms: int
    blocks: torch.Tensor  # [B, S] uint8
    lens: torch.Tensor  # [B] int32
    dense: torch.Tensor  # encode table entries
    tb: hb.TableBatch
    decode_args: dict  # keyword arguments of decode_chunks


def prepare(data: bytes, arity: int, device, block_size: int = 65536,
            chunk_syms: int = 512) -> Inputs:
    """Tables, encode rows and decode inputs of ``data`` on ``device``."""
    if arity not in FAST_ARITIES:
        raise ValueError(f"arity {arity} has no kernels (kernel arities: {FAST_ARITIES})")
    cfg = CodecConfig(arity=arity, block_size=block_size, chunk_syms=chunk_syms)
    codec = HuffmanCodec(cfg, device)
    blocks, lengths = framing.split_blocks(data, block_size)
    dev_blocks, dev_lens = codec.upload_blocks(blocks, lengths)
    tb, _ = codec.tables(dev_blocks, dev_lens)
    dense = hb.encode_tensors(tb, codec.device)["dense"]
    rows, digits = kenc.encode_chunk_rows(dev_blocks, dev_lens, dense, chunk_syms, arity)
    nb = wire_bytes(digits.long(), arity)
    mb = max_chunk_bytes(chunk_syms, arity)
    flat = rows[torch.arange(mb, device=rows.device)[None, :] < nb[:, None]]
    payloads = codec._assemble_payloads(
        flat.cpu().numpy(), nb.view(blocks.shape[0], -1).cpu().numpy(), lengths,
        tb.table_bytes(),
    )
    args, _ = codec.decode_inputs(payloads, lengths, None)
    return Inputs(data, arity, chunk_syms, dev_blocks, dev_lens, dense, tb, args)


def encode_observables(rows, digits, arity):
    """(stage 1, stage 2) observables of each row of a full rows encode:
    its digit count and the sum of its wire bytes, as int64."""
    nb = wire_bytes(digits.long(), arity)
    valid = torch.arange(rows.shape[1], device=rows.device)[None, :] < nb[:, None]
    return digits.long(), torch.where(valid, rows.long(), 0).sum(1)


def decode_observables(out, args, tb):
    """(stage 1, 2, 3) observables of each chunk of a full decode output:
    the sums of its symbols' code lengths, ranks (index in the block's
    sorted symbols) and bytes, as int64 mod 2**32."""
    dev = out.device
    C = out.shape[1]
    valid = torch.arange(C, device=dev)[None, :] < args["chunk_cnt"].long()[:, None]
    B = tb.lengths.shape[0]
    # rank_of[b, sorted_symbols[b, r]] = r for r < n_used; column 256 takes the padding
    sorted_syms = torch.from_numpy(tb.sorted_symbols.astype(np.int64)).to(dev)
    r = torch.arange(256, device=dev).expand(B, 256)
    used = r < torch.from_numpy(tb.n_used.astype(np.int64)).to(dev)[:, None]
    rank_of = torch.zeros((B, 257), dtype=torch.int64, device=dev)
    rank_of.scatter_(1, torch.where(used, sorted_syms, 256), r)
    code_len = torch.from_numpy(tb.lengths.astype(np.int64)).to(dev)
    blk = args["chunk_blk"].long()[:, None]
    sym = out.long()
    per_symbol = (code_len.reshape(-1)[blk * 256 + sym], rank_of.reshape(-1)[blk * 257 + sym], sym)
    return tuple(torch.where(valid, v, 0).sum(1) & 0xFFFFFFFF for v in per_symbol)


def check_stages(inp: Inputs) -> dict:
    """Each partial stage's observable of the rows-encode and decode
    wrappers against its definition from the plain full versions, and
    the full outputs against the plain ones; raises on any difference.
    -> {stage name: max abs err} (all 0)."""
    n, C = inp.arity, inp.chunk_syms
    rows_r, digits_r = kenc.encode_chunk_rows_ref(inp.blocks, inp.lens, inp.dense, C, n)
    want = encode_observables(rows_r, digits_r, n)
    errs = {}
    for k in (1, 2):
        _, got = kenc.encode_chunk_rows(inp.blocks, inp.lens, inp.dense, C, n, stages=k)
        errs[f"encode_stage{k}"] = _max_err(got.long(), want[k - 1], f"encode stage {k}")
    rows, digits = kenc.encode_chunk_rows(inp.blocks, inp.lens, inp.dense, C, n)
    nb = wire_bytes(digits_r.long(), n)
    valid = torch.arange(rows.shape[1], device=rows.device)[None, :] < nb[:, None]
    errs["encode_stage3"] = max(
        _max_err(digits.long(), digits_r.long(), "encode digits"),
        _max_err(rows[valid], rows_r[valid], "encode rows"),
    )
    del rows_r, rows, valid

    out_r = kdec.decode_chunks_ref(**inp.decode_args)
    want = decode_observables(out_r, inp.decode_args, inp.tb)
    launch = kdec.decode_launcher(**inp.decode_args)
    for k in (1, 2, 3):
        got = kdec.stage_sums(launch(k))
        errs[f"decode_stage{k}"] = _max_err(got, want[k - 1], f"decode stage {k}")
    out = launch(4)
    valid = torch.arange(C, device=out.device)[None, :] < inp.decode_args["chunk_cnt"][:, None]
    errs["decode_stage4"] = _max_err(out[valid], out_r[valid], "decode")
    return errs


def _max_err(got, want, what) -> int:
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err:
        raise AssertionError(f"{what}: differs from its definition (max abs err {err})")
    return err


def _progress(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def measure(inp: Inputs, min_trial_s: float = 0.25) -> dict:
    """The ablation report of ``inp`` (see the module docstring)."""
    dev = timing.require_cuda(inp.blocks.device)
    n, C = inp.arity, inp.chunk_syms
    nbytes = len(inp.data)

    report = {"arity": n, "mb": nbytes / MIB,
              "used_symbols_mean": float(inp.tb.n_used.mean())}
    device = report["device_ms"] = {}

    def t(name, step, reads_back=False):
        """Seconds per call of ``step`` in a chain; its device ms per call
        goes into ``device_ms[name]``, from the profiler where the step
        reads back to the host and so cannot run behind the gate."""
        per = timing.time_chain(step, min_trial_s=min_trial_s)
        device[name] = (timing.profiled_device_ms_or_none(step) if reads_back
                        else timing.device_ms(step))
        _progress(f"{name}: {per * 1e3} ms, device {device[name]} ms")
        return per

    x = inp.blocks.view(inp.blocks.shape[0], -1, LANES)
    dst = torch.empty_like(x)
    tp = t("passthrough", lambda: kcopy.copy_blocks(x))
    report["passthrough_ms"] = tp * 1e3
    report["passthrough_gbps"] = x.numel() / tp / 1e9
    report["passthrough_library_ms"] = t("passthrough_library", lambda: dst.copy_(x)) * 1e3

    enc = {}
    for k in kenc.ENCODE_STAGES:
        enc[k] = t(f"encode_stage{k}",
                   lambda k=k: kenc.encode_chunk_rows(inp.blocks, inp.lens, inp.dense, C, n,
                                                      stages=k))
        report[f"encode_stage{k}_ms"] = enc[k] * 1e3
    report["encode_lookup_ms"] = enc[1] * 1e3
    report["encode_merge_ms"] = (enc[2] - enc[1]) * 1e3
    report["encode_wire_ms"] = (enc[3] - enc[2]) * 1e3
    report["encode_gbps"] = nbytes / enc[3] / 1e9
    report["encode_compact_ms"] = t(
        "encode_compact", lambda: kenc.encode_blocks(inp.blocks, inp.lens, inp.dense, C, n)) * 1e3

    rows, _, bb = kenc.encode_blocks(inp.blocks, inp.lens, inp.dense, C, n)
    report["compact_bytes"] = int(bb.long().sum())
    report["compact_ms"] = t("compact", kcmp.compact_launcher(rows, bb)) * 1e3
    report["compact_gbps"] = report["compact_bytes"] / report["compact_ms"] / 1e6
    report["compact_wrapper_ms"] = t("compact_wrapper", lambda: kcmp.compact_blocks(rows, bb),
                                     reads_back=True) * 1e3
    del rows, bb

    launch = kdec.decode_launcher(**inp.decode_args)
    dec = {}
    for k in kdec.DECODE_STAGES:
        dec[k] = t(f"decode_stage{k}", lambda k=k: launch(k))
    report["decode_window_walk_ms"] = dec[1] * 1e3
    report["decode_rank_ms"] = (dec[2] - dec[1]) * 1e3
    report["decode_ranksym_ms"] = (dec[3] - dec[2]) * 1e3
    report["decode_store_ms"] = (dec[4] - dec[3]) * 1e3
    report["decode_gbps"] = nbytes / dec[4] / 1e9

    report["copy_envelope_gbps"] = timing.measure_envelope(dev, min_trial_s)
    return report


def run(arity: int = 2, mb: int = 64, device="cuda", min_trial_s: float = 0.25) -> dict:
    """The ablation report of ``mb`` MiB of the seeded corpus at ``arity``."""
    dev = timing.require_cuda(device)
    inp = prepare(enwik_like(mb * MIB, SEED), arity, dev)
    report = measure(inp, min_trial_s)
    report["device"] = torch.cuda.get_device_name(dev)
    return report


def smoke(arity: int = 2, device="cuda") -> bool:
    """Two blocks (16 KiB + 8 KiB, chunk_syms 128) through every stage."""
    if torch.device(device).type == "cuda":
        timing.require_cuda(device)  # no card: raise, never run elsewhere
    S = 128 * LANES
    inp = prepare(enwik_like(S + S // 2, SEED), arity, device, block_size=S, chunk_syms=128)
    check_stages(inp)
    out = kdec.decode_chunks(**inp.decode_args)
    ok = out[torch.arange(128)[None, :].to(out.device)
             < inp.decode_args["chunk_cnt"][:, None]].cpu().numpy().tobytes() == inp.data
    print(json.dumps({"smoke": True, "roundtrip_ok": bool(ok), "blocks": int(inp.blocks.shape[0])}))
    return ok


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m data_compression_tpu_torch.tools.ablate")
    ap.add_argument("arity", nargs="?", type=int, default=2)
    ap.add_argument("mb", nargs="?", type=int, default=64)
    ap.add_argument("--out", default=None, help="also write the report to this file")
    ap.add_argument("--smoke", action="store_true", help="tiny check, no timing")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --smoke also runs on cpu)")
    args = ap.parse_args(argv)
    if args.smoke:
        return 0 if smoke(args.arity, args.device) else 1
    report = run(args.arity, args.mb, args.device)
    report["card"] = timing.card()
    text = json.dumps(report)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
