"""The serial codecs' device lanes (counterpart of
``data_compression_tpu/ops/scan_codecs.py``, its six public names).

One lane per block: the MTF and LZW schemes are sequential within a
block, so the parallelism is across blocks.  The lanes are the CUDA
kernels of ``ops/kernels/serial_lanes.py`` on a CUDA device and their
plain versions on the CPU; the bytes are the JAX lanes', which are the
native runtime's.

Encode: one upload of the [B, S] blocks, the encode lane into rows and
totals, one download of the totals and status, the compaction kernel
(``ops/kernels/compact.py``, given the total) packing the rows, one
download of the payload bytes.  Decode: one upload of the joined
payloads and their offsets, the decode lane, one download of the rows
and of the status.

Where the JAX functions differ, so do these: S is not rounded up to
4096 (one block is a batch), every function takes ``device`` (default
``"cuda"``), and a decode that the native runtime would refuse (a
payload too short, an index past the dictionary, a word past the raw
length) raises ValueError naming the codec and the block where JAX's
lane decodes garbage.  ``encode_payloads`` / ``decode_payloads`` are the
codecs' routes on a CUDA device: the same lanes, with the native
runtime's checks only (a block of raw length 0 decodes to nothing
whatever its payload).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from data_compression_tpu_torch.ops.kernels import compact as kcompact
from data_compression_tpu_torch.ops.kernels import serial_lanes as lanes

TYPE_BYTE = {"nybble": lanes.NYBBLES_TYPE, "small_byte": lanes.EIGHT_BIT_PRUNED,
             "small_nybble": lanes.EIGHT_BIT_PRUNED}


def encode_payloads(kind: str, blocks: np.ndarray, lengths, device="cuda") -> List[bytes]:
    """[B, S] uint8 blocks (valid prefix per ``lengths``) -> per-block
    payloads through ``kind``'s encode lane on ``device``.  A nybble or
    small_byte block holding a byte >= 0x80 comes back raw; an empty block
    gives the lone type byte."""
    blocks = np.ascontiguousarray(blocks, np.uint8)
    lengths = np.asarray(lengths, np.int64)
    B = blocks.shape[0]
    if B == 0:
        return []
    dev = torch.device(device)
    rows, totals, status = lanes.ENCODERS[kind](
        torch.from_numpy(blocks).to(dev), torch.from_numpy(lengths.astype(np.int32)).to(dev))
    tot, st = torch.stack((totals, status)).cpu().numpy().astype(np.int64)
    if (st == lanes.CAPACITY).any():
        raise RuntimeError(f"{kind} encode lane: row too small (block {int(np.argmax(st))})")
    flat = kcompact.compact_blocks(rows, totals, total=int(tot.sum())).cpu().numpy()
    ends = np.cumsum(tot)
    payloads = []
    for i in range(B):
        if st[i] == lanes.INPUT:  # bytes >= 0x80: the raw block (LITERAL fallback)
            payloads.append(blocks[i, : int(lengths[i])].tobytes())
        else:
            payloads.append(flat[ends[i] - tot[i]: ends[i]].tobytes())
    return payloads


def decode_payloads(kind: str, payloads: List[bytes], raw_lens, device="cuda") -> List[bytes]:
    """Per-block payloads -> raw blocks through ``kind``'s decode lane on
    ``device``; ValueError names the first block the lane refused."""
    B = len(payloads)
    if B == 0:
        return []
    raw = np.asarray(raw_lens, np.int64)
    if raw.shape != (B,) or bool((raw < 0).any()):
        raise ValueError("raw lengths must be B values >= 0")
    plens = np.array([len(p) for p in payloads], np.int64)
    offsets = np.zeros(B, np.int64)
    np.cumsum(plens[:-1], out=offsets[1:])
    joined = b"".join(payloads)
    dev = torch.device(device)
    flat = torch.from_numpy(np.frombuffer(joined, np.uint8).copy()).to(dev)
    S = int(raw.max())
    out, status = lanes.DECODERS[kind](
        flat, torch.from_numpy(offsets).to(dev), torch.from_numpy(plens.astype(np.int32)).to(dev),
        torch.from_numpy(raw.astype(np.int32)).to(dev), S)
    out, st = out.cpu().numpy(), status.cpu().numpy()
    bad = np.flatnonzero(st != lanes.OK)
    if bad.size:
        raise ValueError(f"{kind} decode lane: block {int(bad[0])}: bad or truncated payload")
    return [out[i, : int(raw[i])].tobytes() for i in range(B)]


def _check_types(kind: str, payloads: List[bytes]) -> None:
    """JAX's check: every payload starts with the codec's type byte."""
    for i, p in enumerate(payloads):
        if len(p) == 0 or p[0] != TYPE_BYTE[kind]:
            raise ValueError(f"block {i}: bad {kind} stream type byte")


def nybble_encode_blocks(blocks: np.ndarray, lengths: np.ndarray, device="cuda") -> List[bytes]:
    """Lane encode of [B, S] blocks -> payloads; blocks holding bytes >=
    0x80 are returned raw (the framing layer makes them LITERAL blocks)."""
    return encode_payloads("nybble", blocks, lengths, device)


def nybble_decode_blocks(payloads: List[bytes], raw_lens: List[int], device="cuda") -> List[bytes]:
    """Lane decode of framed nybble payloads."""
    _check_types("nybble", payloads)
    return decode_payloads("nybble", payloads, raw_lens, device)


def small_byte_encode_blocks(blocks: np.ndarray, lengths: np.ndarray,
                             device="cuda") -> List[bytes]:
    """Lane scheme-A encode, one lane per block; blocks holding bytes >=
    0x80 are returned raw."""
    return encode_payloads("small_byte", blocks, lengths, device)


def small_byte_decode_blocks(payloads: List[bytes], raw_lens: List[int],
                             device="cuda") -> List[bytes]:
    """Lane span-LZW decode, one lane per block."""
    _check_types("small_byte", payloads)
    return decode_payloads("small_byte", payloads, raw_lens, device)


def small_nybble_encode_blocks(blocks: np.ndarray, lengths: np.ndarray,
                               device="cuda") -> List[bytes]:
    """Lane scheme-B encode, one lane per block (any byte values)."""
    return encode_payloads("small_nybble", blocks, lengths, device)


def small_nybble_decode_blocks(payloads: List[bytes], raw_lens: List[int],
                               device="cuda") -> List[bytes]:
    """Lane nybble-LZW decode, one lane per block."""
    _check_types("small_nybble", payloads)
    return decode_payloads("small_nybble", payloads, raw_lens, device)
