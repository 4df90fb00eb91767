"""Huffman chunk encode, n = 2 (kernel: ``csrc/huffman_encode.cu``).

Replaces ``data_compression_tpu/ops/pallas/encode_kernel.py``
``_encode_pallas_compact``.  For each block of ``blocks`` [B, S], chunk
k holds symbols [k*C, (k+1)*C) of the block's valid prefix; each chunk
is a byte-aligned bit stream (stream digit j = bit j&7 of byte j>>3) and
the chunks of a block lie back to back in ``rows[b]``.

Outputs:
  rows [B, S/C * max_chunk_bytes(C, 2)] uint8 — bytes past
      ``block_bytes[b]`` are undefined;
  digits [B, S/C] int32 — code digits per chunk (its wire bytes are
      ceil(digits / 8));
  block_bytes [B] int32 — payload bytes of each block.
"""

from __future__ import annotations

import torch

from data_compression_tpu_torch.config import ARITY_MAX_LEN, max_chunk_bytes
from data_compression_tpu_torch.huffman.batched import PACKED_LEN_SHIFT
from data_compression_tpu_torch.ops.kernels import _build

_SHIFT = PACKED_LEN_SHIFT[2]
_L = ARITY_MAX_LEN[2]


def _check(blocks, raw_lens, dense, chunk_syms):
    if blocks.dtype != torch.uint8 or blocks.dim() != 2:
        raise ValueError(f"blocks must be [B, S] uint8, got {blocks.dtype} {tuple(blocks.shape)}")
    B, S = blocks.shape
    C = chunk_syms
    if C < 16 or C & (C - 1) or S % C:
        raise ValueError(f"chunk_syms {C} must be a power of two >= 16 dividing {S}")
    if raw_lens.dtype != torch.int32 or tuple(raw_lens.shape) != (B,):
        raise ValueError(f"raw_lens must be [{B}] int32")
    if dense.dtype != torch.int32 or tuple(dense.shape) != (B, 256):
        raise ValueError(f"dense must be [{B}, 256] int32")
    return B, S, C, S // C


def encode_blocks_ref(blocks, raw_lens, dense, chunk_syms):
    """Plain PyTorch version (any device): per-symbol bit offsets by
    cumsum, bits scattered into a bit array, then packed to bytes."""
    B, S, C, ncb = _check(blocks, raw_lens, dense, chunk_syms)
    dev = blocks.device
    cap = ncb * max_chunk_bytes(C, 2)
    # int64 throughout: torch's >> on int32 is arithmetic
    ent = torch.gather(dense.to(torch.int64), 1, blocks.to(torch.int64))
    valid = torch.arange(S, device=dev)[None, :] < raw_lens.to(torch.int64)[:, None]
    nd = torch.where(valid, (ent >> _SHIFT) & 0xF, 0).view(B, ncb, C)
    code = (ent & ((1 << _SHIFT) - 1)).view(B, S)
    digits = nd.sum(-1)  # [B, ncb]
    nbytes = (digits + 7) // 8
    chunk_start = torch.cumsum(nbytes, 1) - nbytes  # byte offset in the row
    sym_bit = (
        (chunk_start * 8)[:, :, None] + torch.cumsum(nd, -1) - nd
    ).view(B, S)
    nd = nd.view(B, S)
    bits = torch.zeros((B, cap * 8), dtype=torch.uint8, device=dev)
    row = torch.arange(B, device=dev)[:, None].expand(B, S)
    for m in range(_L):
        sel = m < nd
        bits[row[sel], (sym_bit + m)[sel]] = ((code >> m) & 1)[sel].to(torch.uint8)
    planes = bits.view(B, cap, 8)
    rows = torch.zeros((B, cap), dtype=torch.uint8, device=dev)
    for i in range(8):
        rows |= planes[:, :, i] << i
    return rows, digits.to(torch.int32), nbytes.sum(1).to(torch.int32)


def encode_blocks(blocks, raw_lens, dense, chunk_syms):
    """Encode on the tensors' device: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  -> (rows, digits, block_bytes)."""
    if blocks.device.type == "cpu":
        return encode_blocks_ref(blocks, raw_lens, dense, chunk_syms)
    B, S, C, ncb = _check(blocks, raw_lens, dense, chunk_syms)
    _build.require_cuda(blocks, raw_lens, dense)
    if blocks.data_ptr() % 16:
        raise ValueError("blocks must be 16-byte aligned")
    row_cap = ncb * max_chunk_bytes(C, 2)
    if row_cap >= 2**31:
        raise ValueError(f"block of {S} symbols too large for the encode kernel")
    dev = blocks.device
    rows = torch.empty((B, row_cap), dtype=torch.uint8, device=dev)
    digits = torch.empty((B, ncb), dtype=torch.int32, device=dev)
    block_bytes = torch.empty((B,), dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            rc = _build.lib().dct_huffman_encode(
                blocks.data_ptr(), raw_lens.data_ptr(), dense.data_ptr(),
                rows.data_ptr(), digits.data_ptr(), block_bytes.data_ptr(),
                B, S, C, row_cap, _build.stream_of(blocks),
            )
        _build.check(rc, "huffman_encode")
        encode_blocks.launches += 1
    return rows, digits, block_bytes


encode_blocks.launches = 0
