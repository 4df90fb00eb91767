"""Huffman chunk encode, n = 2, 3 and 16 (kernels: ``csrc/huffman_encode.cu``).

For each block of ``blocks`` [B, S], chunk k holds symbols
[k*C, (k+1)*C) of the block's valid prefix.  Each chunk is a
byte-aligned stream of base-n digits, D = ARITY_DIGITS_PER_BYTE[n] to a
byte, little-endian: byte = sum of digit[D*j + i] * n**i (8 bits at n=2,
two nybbles, low first, at n=16, five trits at n=3), the last byte
zero-padded.  Its wire bytes are ceil(digits / D).

``dense`` is ``huffman.batched.encode_tensors``'s layout: [B, 256]
entries ``digits << PACKED_LEN_SHIFT[n] | code`` at n = 2 (shift 15)
and n = 16 (shift 28), or [B, 512] at n = 3 (codes in [:, :256], field
bits in [:, 256:]); a code holds its stream digit m in bit field m of
``BITS_PER_DIGIT[n]`` bits.  Two output layouts:

``encode_blocks`` replaces ``data_compression_tpu/ops/pallas/
encode_kernel.py`` ``_encode_pallas_compact``: the chunks of a block lie
back to back in ``rows[b]``.
  rows [B, S/C * max_chunk_bytes(C, n)] uint8 — bytes past
      ``block_bytes[b]`` are undefined;
  digits [B, S/C] int32 — code digits per chunk;
  block_bytes [B] int32 — payload bytes of each block.

``encode_chunk_rows`` replaces ``_encode_pallas``: chunk k of block b has
a fixed-stride row of its own, ``b*S/C + k``.
  rows [B*S/C, max_chunk_bytes(C, n)] uint8 — bytes past
      ceil(digits / D) of each row are undefined;
  digits [B*S/C] int32.
Its ``stages`` argument is ``_encode_pallas(stages=)``'s profiling
ablation, each stage a prefix of the work with its own observable in
``digits`` (``rows`` are undefined at stages < 3):
  1  lookup only: the chunk's digit count (= the full kernel's digits);
  2  + digit accumulation into wire bytes, not stored: the sum of the
     chunk's wire bytes (= ``rows[row, :ceil(digits / D)].sum()`` of the
     full kernel);
  3  the full kernel (the library path).
"""

from __future__ import annotations

import torch

from data_compression_tpu_torch.config import (
    ARITY_DIGITS_PER_BYTE,
    ARITY_MAX_LEN,
    max_chunk_bytes,
    wire_bytes,
)
from data_compression_tpu_torch.huffman.batched import BITS_PER_DIGIT, PACKED_LEN_SHIFT
from data_compression_tpu_torch.ops.kernels import _build

# digit-count field of a packed entry: 4 bits at n=2, 3 at n=16
_LEN_MASK = {2: 0xF, 16: 0x7}
_DENSE_WIDTH = {2: 256, 3: 512, 16: 256}


def check_geometry(blocks, raw_lens, chunk_syms, arity):
    """The encode's checks of everything but the table: -> (B, S, C, S/C)."""
    if arity not in _DENSE_WIDTH:
        raise ValueError(f"no encode kernel for arity {arity}")
    if blocks.dtype != torch.uint8 or blocks.dim() != 2:
        raise ValueError(f"blocks must be [B, S] uint8, got {blocks.dtype} {tuple(blocks.shape)}")
    B, S = blocks.shape
    C = chunk_syms
    if C < 16 or C & (C - 1) or S % C:
        raise ValueError(f"chunk_syms {C} must be a power of two >= 16 dividing {S}")
    if raw_lens.dtype != torch.int32 or tuple(raw_lens.shape) != (B,):
        raise ValueError(f"raw_lens must be [{B}] int32")
    return B, S, C, S // C


def _check(blocks, raw_lens, dense, chunk_syms, arity):
    B, S, C, ncb = check_geometry(blocks, raw_lens, chunk_syms, arity)
    w = _DENSE_WIDTH[arity]
    if dense.dtype != torch.int32 or tuple(dense.shape) != (B, w):
        raise ValueError(f"dense must be [{B}, {w}] int32 at arity {arity}")
    return B, S, C, ncb


def row_capacity(S, C, arity):
    """Bytes of a block's row in ``encode_blocks``' output: S/C chunks of
    ``max_chunk_bytes``; ValueError past the kernel's int32 offsets."""
    row_cap = S // C * max_chunk_bytes(C, arity)
    if row_cap >= 2**31:
        raise ValueError(f"block of {S} symbols too large for the encode kernel")
    return row_cap


def _symbol_codes(blocks, raw_lens, dense, C, arity):
    """Per symbol: digit count [B, S/C, C] (0 past the valid length) and
    field-packed code [B, S], both int64 (torch's >> on int32 is
    arithmetic)."""
    B, S = blocks.shape
    idx = blocks.to(torch.int64)
    dense = dense.to(torch.int64)
    if arity == 3:
        code = torch.gather(dense[:, :256], 1, idx)
        nd = (torch.gather(dense[:, 256:], 1, idx) >> 1) & 0xF
    else:
        sh = PACKED_LEN_SHIFT[arity]
        ent = torch.gather(dense, 1, idx)
        code = ent & ((1 << sh) - 1)
        nd = (ent >> sh) & _LEN_MASK[arity]
    valid = torch.arange(S, device=blocks.device)[None, :] < raw_lens.to(torch.int64)[:, None]
    return torch.where(valid, nd, 0).view(B, S // C, C), code


def _scatter_digits(code, nd, row, sym_digit, shape, arity):
    """Bytes [rows, width] with digit m of each symbol's code at stream
    digit ``sym_digit + m`` of its row (digit j is digit j % D of byte
    j // D, weight n**(j % D))."""
    nrows, width = shape
    D = ARITY_DIGITS_PER_BYTE[arity]
    bpd = BITS_PER_DIGIT[arity]
    digits = torch.zeros((nrows, width * D), dtype=torch.uint8, device=code.device)
    for m in range(ARITY_MAX_LEN[arity]):
        sel = m < nd
        digits[row[sel], (sym_digit + m)[sel]] = (
            (code >> (m * bpd)) & ((1 << bpd) - 1)
        )[sel].to(torch.uint8)
    planes = digits.view(nrows, width, D)
    out = torch.zeros((nrows, width), dtype=torch.int32, device=code.device)
    for i in range(D):
        out += planes[:, :, i].to(torch.int32) * arity**i
    return (out & 0xFF).to(torch.uint8)


def encode_blocks_ref(blocks, raw_lens, dense, chunk_syms, arity=2):
    """Plain PyTorch version (any device): per-symbol digit offsets by
    cumsum, digits scattered into a digit array, then D digits packed
    to each byte."""
    B, S, C, ncb = _check(blocks, raw_lens, dense, chunk_syms, arity)
    nd, code = _symbol_codes(blocks, raw_lens, dense, C, arity)
    digits = nd.sum(-1)  # [B, ncb]
    nbytes = wire_bytes(digits, arity)
    chunk_start = torch.cumsum(nbytes, 1) - nbytes  # byte offset in the row
    D = ARITY_DIGITS_PER_BYTE[arity]
    sym_digit = ((chunk_start * D)[:, :, None] + torch.cumsum(nd, -1) - nd).view(B, S)
    row = torch.arange(B, device=blocks.device)[:, None].expand(B, S)
    rows = _scatter_digits(code, nd.view(B, S), row, sym_digit,
                           (B, ncb * max_chunk_bytes(C, arity)), arity)
    return rows, digits.to(torch.int32), nbytes.sum(1).to(torch.int32)


ENCODE_STAGES = (1, 2, 3)


def _check_stages(stages):
    if stages not in ENCODE_STAGES:
        raise ValueError(f"encode stages must be one of {ENCODE_STAGES}, got {stages!r}")


def encode_chunk_rows_ref(blocks, raw_lens, dense, chunk_syms, arity=2, stages=3):
    """Plain PyTorch version (any device) of ``encode_chunk_rows``: the
    digit scatter of ``encode_blocks_ref`` with one fixed-stride row per
    chunk, so each symbol's digit offset is its in-chunk digit cumsum.
    At stages < 3 the rows are zeros and ``digits`` holds the stage's
    observable."""
    B, S, C, ncb = _check(blocks, raw_lens, dense, chunk_syms, arity)
    _check_stages(stages)
    nd, code = _symbol_codes(blocks, raw_lens, dense, C, arity)
    digits = nd.sum(-1).view(B * ncb)
    mb = max_chunk_bytes(C, arity)
    if stages == 1:
        return torch.zeros((B * ncb, mb), dtype=torch.uint8, device=blocks.device), \
            digits.to(torch.int32)
    sym_digit = (torch.cumsum(nd, -1) - nd).view(B, S)
    row = torch.arange(B * ncb, device=blocks.device).view(B, ncb, 1).expand(B, ncb, C)
    rows = _scatter_digits(code, nd.view(B, S), row.reshape(B, S), sym_digit,
                           (B * ncb, mb), arity)
    if stages == 2:
        valid = torch.arange(mb, device=blocks.device)[None, :] < wire_bytes(digits, arity)[:, None]
        wire_sum = torch.where(valid, rows.to(torch.int64), 0).sum(1)
        return torch.zeros_like(rows), wire_sum.to(torch.int32)
    return rows, digits.to(torch.int32)


def require_kernel_inputs(blocks, *tensors):
    """The encode kernels' inputs on one CUDA device, contiguous, the
    blocks 16-byte aligned."""
    _build.require_cuda(blocks, *tensors)
    if blocks.data_ptr() % 16:
        raise ValueError("blocks must be 16-byte aligned")


def encode_blocks(blocks, raw_lens, dense, chunk_syms, arity=2):
    """Encode on the tensors' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  -> (rows, digits, block_bytes)."""
    if blocks.device.type == "cpu":
        return encode_blocks_ref(blocks, raw_lens, dense, chunk_syms, arity)
    B, S, C, ncb = _check(blocks, raw_lens, dense, chunk_syms, arity)
    require_kernel_inputs(blocks, raw_lens, dense)
    row_cap = row_capacity(S, C, arity)
    dev = blocks.device
    rows = torch.empty((B, row_cap), dtype=torch.uint8, device=dev)
    digits = torch.empty((B, ncb), dtype=torch.int32, device=dev)
    block_bytes = torch.empty((B,), dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            rc = _build.lib().dct_huffman_encode(
                blocks.data_ptr(), raw_lens.data_ptr(), dense.data_ptr(),
                rows.data_ptr(), digits.data_ptr(), block_bytes.data_ptr(),
                B, S, C, row_cap, arity, _build.stream_of(blocks),
            )
        _build.check(rc, "huffman_encode")
        encode_blocks.launches += 1
    return rows, digits, block_bytes


encode_blocks.launches = 0


def encode_chunk_rows(blocks, raw_lens, dense, chunk_syms, arity=2, stages=3):
    """Per-chunk-row encode on the tensors' device: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors.  -> (rows, digits)."""
    if blocks.device.type == "cpu":
        return encode_chunk_rows_ref(blocks, raw_lens, dense, chunk_syms, arity, stages)
    B, S, C, ncb = _check(blocks, raw_lens, dense, chunk_syms, arity)
    _check_stages(stages)
    require_kernel_inputs(blocks, raw_lens, dense)
    mb = max_chunk_bytes(C, arity)
    dev = blocks.device
    rows = torch.empty((B * ncb, mb), dtype=torch.uint8, device=dev)
    digits = torch.empty((B * ncb,), dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            rc = _build.lib().dct_huffman_encode_rows(
                blocks.data_ptr(), raw_lens.data_ptr(), dense.data_ptr(),
                rows.data_ptr(), digits.data_ptr(), B, S, C, mb, arity, stages,
                _build.stream_of(blocks),
            )
        _build.check(rc, "huffman_encode_rows")
        encode_chunk_rows.launches += 1
    return rows, digits


encode_chunk_rows.launches = 0
