"""Huffman tables built on the device, from histograms to the tables the
encode and decode kernels read, without a host read.

Counterpart of ``data_compression_tpu/ops/table_build.py``:
``encode_tables_device`` and ``decode_tables_device`` are torch ops on
the device, as the JAX functions are ``jnp`` outside Pallas.  They give
the layouts of ``huffman.batched.encode_tensors`` / ``dense_rows`` and
``decode_tensors`` / ``decode_rows``, which the port's kernels read (not
the TPU's padded Pallas layouts).  The code lengths, and with them the
encode table in the same launch, come from the table-build kernel
(``ops/kernels/table_build.py``: ``huffman_lengths``, ``build_tables``);
``encode_tables_device`` is the plain version of that table, and
``decode_tables_device`` of the decode-table kernel (``decode_tables``
there), which builds the decode tables on CUDA in one launch.

Only the three arities with kernels (2, 3, 16) have these tables; any
other arity raises KeyError, as in the JAX package.
"""

from __future__ import annotations

import torch

from data_compression_tpu_torch.config import ARITY_MAX_LEN
from data_compression_tpu_torch.huffman.batched import BITS_PER_DIGIT, PACKED_LEN_SHIFT


def _kernel_arity(arity):
    if arity not in BITS_PER_DIGIT:
        raise KeyError(f"no device tables for huffman arity {arity} (arities "
                       f"{tuple(BITS_PER_DIGIT)} have kernels)")


def _canonical(lengths, arity):
    """The canonical code's per-length arrays, l = 0..L, int64 [B, L+1]:
    (count, scaled, its exclusive prefix): ``scaled[l] = count[l] *
    n**(L-l)``, so ``first_code[l] = exclusive[l] // n**(L-l)`` (the
    recurrence ``f[l+1] = (f[l] + count[l]) * n`` of
    ``huffman.batched.codes_batch`` as one cumsum) and the decode limit
    ``(first_code[l] + count[l]) * n**(L-l)`` is the inclusive prefix.
    Few launches: these run between device tensors on every call."""
    L = ARITY_MAX_LEN[arity]
    lv = torch.arange(L + 1, device=lengths.device)
    count = (lengths[:, :, None] == lv[1:]).sum(1)
    count = torch.cat([torch.zeros_like(count[:, :1]), count], 1)
    scaled = count * (arity ** (L - lv))
    inclusive = torch.cumsum(scaled, 1)
    return count, scaled, inclusive


def encode_tables_device(lengths, arity):
    """[B, 256] code lengths -> (dense, n_used [B] int32): ``dense`` is
    ``encode_tensors``' int32 layout, [B, 256] ``digits << shift | code``
    at n = 2 and 16, [B, 512] field-packed codes then field bits at n = 3
    (``dense_rows(codes_batch(lengths))`` row by row)."""
    _kernel_arity(arity)
    bpd = BITS_PER_DIGIT[arity]
    L = ARITY_MAX_LEN[arity]
    dev = lengths.device
    lengths = lengths.to(torch.int64)
    used = lengths > 0
    count, scaled, inclusive = _canonical(lengths, arity)
    lv = torch.arange(L + 1, device=dev)
    first_code = (inclusive - scaled) // (arity ** (L - lv))
    # code = first_code[len] + rank among the symbols of its length
    onehot = (lengths[:, :, None] == lv).to(torch.int64)
    rank = (torch.cumsum(onehot, 1) - onehot).gather(2, lengths.clamp(0, L)[:, :, None])[:, :, 0]
    codes = first_code.gather(1, lengths.clamp(0, L)) + rank
    # digit m of the code, MSB first, in bit field m (fields are disjoint: sum = or)
    m = lv[:L]
    place = (lengths[:, :, None] - 1 - m).clamp(min=0)
    digits = codes[:, :, None] // (arity ** place) % arity
    packed = torch.where(m < lengths[:, :, None], digits << (m * bpd), 0).sum(2)
    sh = PACKED_LEN_SHIFT.get(arity)
    if sh is not None:
        dense = (lengths << sh) | packed
    else:
        dense = torch.cat([packed, lengths * bpd], 1)
    return dense.to(torch.int32), used.sum(1).to(torch.int32)


def decode_tables_device(rows, arity):
    """[B, 256] wire length rows -> (limit, bmf [B, L+1], symbols [B, 256]),
    all int32: ``decode_tensors``' scaled decode tables (``decode_rows``
    of ``codes_batch(rows)``)."""
    _kernel_arity(arity)
    L = ARITY_MAX_LEN[arity]
    dev = rows.device
    lengths = rows.to(torch.int64)
    used = lengths > 0
    count, scaled, inclusive = _canonical(lengths, arity)
    lv = torch.arange(L + 1, device=dev)
    ok = (lv >= 1) & (lv <= lengths.max(1).values[:, None])
    limit = torch.cummax(torch.where(ok, inclusive, 0), 1).values
    base_minus_first = (torch.cumsum(count, 1) - count) - (inclusive - scaled) // (arity ** (L - lv))
    bmf = torch.where(ok, base_minus_first, 0)
    sym = torch.arange(256, device=dev)
    order = torch.argsort(torch.where(used, lengths * 512 + sym, 1 << 20), 1)
    symbols = torch.where(sym < used.sum(1, keepdim=True), order, 0)
    return limit.to(torch.int32), bmf.to(torch.int32), symbols.to(torch.int32)
