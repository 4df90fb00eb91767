"""Compress cells: ``device_api.compress_blocks_device`` on buffers that lie
on the device, with the raw lengths an int32 tensor there, so the call
reads nothing back.

The check compares every output of the sampled calls with the plain
reference's (``portbench/reference/huffman.py``), which works the
histograms, the code lengths, the codes and the payload out again from the
raw buffer: the wire length rows (histogram and table build), the chunk
wire bytes (encode) and the payload up to its total (encode and
compaction).  The control is the reference in the program's place with
one table for the whole buffer, built from the summed histogram: it breaks
the configuration's per-block tables.
"""

from __future__ import annotations

import types

import torch

from data_compression_tpu_torch import device_api
from data_compression_tpu_torch.config import CodecConfig
from portbench.reference import huffman as ref

LIMITS = {"length_rows_differing": 0, "chunk_bytes_differing": 0, "payload_bytes_differing": 0}


def prepare(cell, buffers, lens, device):
    cfg = cell.config
    codec = CodecConfig(codec="huffman", arity=cfg["arity"], block_size=cfg["block_size"],
                        chunk_syms=cfg["chunk_syms"], shared_table=False)  # per-block tables
    return types.SimpleNamespace(cfg=cfg, codec=codec, buffers=buffers, lens=lens,
                                 device=device, totals=[None] * len(buffers))


def call(state, buf):
    return device_api.compress_blocks_device(state.buffers[buf], state.lens[buf], state.codec,
                                             device=state.device)


def note(state, buf, out):
    state.totals[buf] = out.total


def raw_bytes(state) -> int:
    return int(sum(int(l.sum()) for l in state.lens)) // len(state.lens)


def stage(state) -> dict:
    """Byte counts of one call, for the roofline readers."""
    B, S = state.buffers[0].shape
    C = state.cfg["chunk_syms"]
    totals = [int(t) for t in state.totals if t is not None]
    return {"blocks": B, "block_size": S, "chunks": B * (S // C), "raw_bytes": raw_bytes(state),
            "code_digits": state.cfg["max_code_digits"],
            "payload_bytes": sum(totals) / len(totals) if totals else None}


def expected(state, buf):
    """The reference's (length rows [B, 256] uint8, chunk wire bytes [B, S/C]
    int32, payload uint8) for input buffer ``buf``."""
    cfg = state.cfg
    n = cfg["arity"]
    raw, lens = state.buffers[buf], state.lens[buf]
    lengths = ref.code_lengths(ref.histograms(raw, lens), n, cfg["max_code_digits"])
    payload, chunk_bytes = ref.encode(raw, lens, lengths, n, cfg["chunk_syms"])
    return lengths.to(torch.uint8), chunk_bytes, payload


def control(state, buf):
    """The reference in the program's place with one table for the buffer."""
    cfg = state.cfg
    n = cfg["arity"]
    raw, lens = state.buffers[buf], state.lens[buf]
    hist = ref.histograms(raw, lens).sum(0, keepdim=True)
    row = ref.code_lengths(hist, n, cfg["max_code_digits"])
    lengths = row.expand(raw.shape[0], -1).contiguous()
    payload, chunk_bytes = ref.encode(raw, lens, lengths, n, cfg["chunk_syms"])
    return types.SimpleNamespace(flat=payload, nb=chunk_bytes, table_rows=lengths.to(torch.uint8),
                                 total=torch.tensor(payload.numel()))


def _payload(out) -> torch.Tensor:
    total = int(out.total)
    if total <= out.flat.numel():
        return out.flat[:total]
    return torch.as_tensor(out.download()[0]).to(out.flat.device)  # the program's own overflow path


def _differing(got: torch.Tensor, want: torch.Tensor) -> int:
    """Elements of ``want`` that ``got`` does not hold (all, when the
    shapes differ)."""
    if got.shape != want.shape:
        return want.numel()
    return int((got.to(want.device) != want).sum())


def judge(state, kept) -> tuple:
    """-> ({number: (value, limit)} summed over the kept (buffer, output)
    pairs, kept calls with any difference)."""
    got = dict.fromkeys(LIMITS, 0)
    wrong = 0
    for buf in sorted({b for b, _ in kept}):
        rows, chunk_bytes, payload = expected(state, buf)
        for b, out in kept:
            if b != buf:
                continue
            mine = _payload(out)
            n = min(mine.numel(), payload.numel())
            diff = {
                "length_rows_differing": (
                    rows.shape[0] if out.table_rows.shape != rows.shape
                    else int((out.table_rows.to(rows.device) != rows).any(1).sum())),
                "chunk_bytes_differing": _differing(out.nb, chunk_bytes),
                "payload_bytes_differing": (int((mine[:n].to(payload.device) != payload[:n]).sum())
                                            + abs(mine.numel() - payload.numel())),
            }
            wrong += any(diff.values())
            for k, v in diff.items():
                got[k] += v
        del rows, chunk_bytes, payload
    return {k: (v, LIMITS[k]) for k, v in got.items()}, wrong
