"""Decompress cells: ``device_api.decode_blocks_device`` on payloads that lie
on the device, with the chunk offsets, symbol counts, block ids and wire
length rows a frame's index gives.

Set-up makes each input buffer's payload with the plain reference's
encoder (``portbench/reference/huffman.py``), not with the program.  The
check compares every valid decoded byte of the sampled calls with the raw
buffer the payload was made from.  The control is the reference's decoder
in the program's place, reading every chunk with the first block's table:
it breaks the configuration's per-block tables.
"""

from __future__ import annotations

import types

import torch

from data_compression_tpu_torch import device_api
from portbench.reference import huffman as ref

LIMITS = {"symbols_differing": 0}


def _index(chunk_bytes, lens, C):
    """A frame's chunk index: (chunk_off [K+1] int64, chunk_cnt [K] int32,
    chunk_blk [K] int32)."""
    B, ncb = chunk_bytes.shape
    dev = chunk_bytes.device
    off = torch.zeros(B * ncb + 1, dtype=torch.int64, device=dev)
    torch.cumsum(chunk_bytes.view(-1).to(torch.int64), 0, out=off[1:])
    first = torch.arange(ncb, device=dev)[None, :] * C
    cnt = (lens.to(torch.int64)[:, None] - first).clamp(0, C).to(torch.int32).view(-1)
    blk = (torch.arange(B * ncb, device=dev) // ncb).to(torch.int32)
    return off, cnt, blk


def prepare(cell, buffers, lens, device):
    cfg = cell.config
    n, C = cfg["arity"], cfg["chunk_syms"]
    frames = []
    for raw, ln in zip(buffers, lens):
        lengths = ref.code_lengths(ref.histograms(raw, ln), n, cfg["max_code_digits"])
        payload, chunk_bytes = ref.encode(raw, ln, lengths, n, C)
        off, cnt, blk = _index(chunk_bytes, ln, C)
        frames.append(types.SimpleNamespace(flat=payload, chunk_off=off, chunk_cnt=cnt,
                                            chunk_blk=blk, rows=lengths.to(torch.uint8),
                                            chunk_bytes=chunk_bytes))
    return types.SimpleNamespace(cfg=cfg, buffers=buffers, lens=lens, device=device, frames=frames)


def call(state, buf):
    f = state.frames[buf]
    return device_api.decode_blocks_device(f.flat, f.chunk_off, f.chunk_cnt, f.chunk_blk, f.rows,
                                           arity=state.cfg["arity"],
                                           chunk_syms=state.cfg["chunk_syms"], device=state.device)


def note(state, buf, out):
    pass


def raw_bytes(state) -> int:
    return int(sum(int(l.sum()) for l in state.lens)) // len(state.lens)


def stage(state) -> dict:
    B, S = state.buffers[0].shape
    C = state.cfg["chunk_syms"]
    return {"blocks": B, "block_size": S, "chunks": B * (S // C), "raw_bytes": raw_bytes(state),
            "code_digits": state.cfg["max_code_digits"],
            "payload_bytes": sum(f.flat.numel() for f in state.frames) / len(state.frames)}


def control(state, buf):
    f = state.frames[buf]
    cfg = state.cfg
    B = f.rows.shape[0]
    C = cfg["chunk_syms"]
    counts = f.chunk_cnt.view(B, -1)
    one = f.rows[:1].expand(B, -1)
    return ref.decode(f.flat, f.chunk_bytes, counts, one, cfg["arity"], C,
                      cfg["max_code_digits"]).view(-1, C)


def judge(state, kept) -> tuple:
    """-> ({number: (value, limit)}, kept calls with any difference): the
    decoded bytes of the kept calls that differ from the raw buffer, over
    each block's valid prefix."""
    total, wrong = 0, 0
    for buf, out in kept:
        raw, lens = state.buffers[buf], state.lens[buf]
        B, S = raw.shape
        if out.numel() != raw.numel():
            diff = int(lens.sum())
        else:
            valid = torch.arange(S, device=raw.device)[None, :] < lens.to(torch.int64)[:, None]
            diff = int(((out.reshape(B, S).to(raw.device) != raw) & valid).sum())
        total += diff
        wrong += diff > 0
    return {"symbols_differing": (total, LIMITS["symbols_differing"])}, wrong
