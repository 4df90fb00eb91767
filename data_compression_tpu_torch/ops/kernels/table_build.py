"""Capped canonical Huffman code lengths, and the encode kernel's table,
on the device (kernel: ``csrc/table_build.cu``).

Replaces ``data_compression_tpu/ops/table_build.py``
``huffman_lengths_device`` and ``encode_tables_device``: no Pallas
kernel, but a ``lax.scan`` over the merges, vectorised across blocks,
inside a ``lax.while_loop`` for the length cap, then ``jnp`` ops.  In:

  hists [B, 256] — per-block byte counts (any integer type; int64 is
      read as it is, others are converted); a row's total below 2**54.

Out of ``huffman_lengths``: [B, 256] int32 code lengths in base-n digits
under the cap ``ARITY_MAX_LEN[n]``, bit-identical to the host builder
(``huffman.batched.capped_lengths_batch``, the native
``dct_huffman_capped_lengths_batch``) and to the JAX function: leaves
keyed on (count, seniority) with the dummies of count 1 after the used
symbols, the leaf popped on a tie, internal nodes first in, first out;
while a tree is too deep its nonzero counts become ``(c + 1) // 2``.
Any arity 2..64 builds.  ``build_tables`` (n = 2, 3 and 16, the arities
with encode kernels) also gives the encode kernel's table ``dense``, the
layout of ``ops.table_build.encode_tables_device``, from the same
launch.

The plain versions: ``huffman_lengths_ref``, a torch transcription of
the JAX build, B blocks wide per merge step, in int64 (a block's counts
may sum past 2**31 there too); ``build_tables_ref``, that followed by
``encode_tables_device``.

``decode_tables`` (kernel: ``csrc/decode_tables.cu``) replaces the JAX
``decode_tables_device`` (``jnp`` ops, no Pallas kernel): [B, 256] uint8
wire length rows -> the decode kernel's tables in one launch, bit-identical
to its plain version ``ops.table_build.decode_tables_device``; the three
tables are views of one allocation.  ``decode_tables_floor`` launches an
empty kernel on the same grid, the launch floor its time is read against.
"""

from __future__ import annotations

import torch

from data_compression_tpu_torch.config import ARITY_MAX_LEN
from data_compression_tpu_torch.huffman.batched import BITS_PER_DIGIT, PACKED_LEN_SHIFT
from data_compression_tpu_torch.ops.kernels import _build
from data_compression_tpu_torch.ops.table_build import (
    _kernel_arity,
    decode_tables_device,
    encode_tables_device,
)

S = 256  # alphabet
MAXD = 64  # >= arity - 2 dummy leaves
NL = S + MAXD  # leaf slots (sorted position); internal node t has id NL + t
_INF = 1 << 62
_SEN_BITS = 9  # seniority < NL < 2**9 in the leaf sort key


def _check(hists, arity):
    cap = ARITY_MAX_LEN[arity]  # KeyError outside 2..64, as the JAX function
    if hists.dim() != 2 or hists.shape[1] != S or hists.is_floating_point():
        raise ValueError(f"hists must be [B, {S}] integers, got {hists.dtype} "
                         f"{tuple(hists.shape)}")
    return hists.shape[0], cap


def _build_once_ref(f, arity):
    """Uncapped lengths [B, S] int64 of the counts ``f`` [B, S] int64."""
    B, dev = f.shape[0], f.device
    n1 = arity - 1
    T = (NL - 1) // n1  # merges of the largest tree
    used = f > 0
    k = used.sum(1)
    d = torch.where(k > 0, (n1 - (k - 1) % n1) % n1, 0)
    # leaf keys count << 9 | seniority: reals in symbol order, then dummies
    rank = torch.cumsum(used, 1) - 1
    real_key = torch.where(used, (f << _SEN_BITS) + rank, _INF)
    j = torch.arange(MAXD, device=dev)[None, :]
    dummy_key = torch.where(j < d[:, None], (1 << _SEN_BITS) + k[:, None] + j, _INF)
    keys = torch.sort(torch.cat([real_key, dummy_key], 1), 1).values  # [B, NL]
    in_tree = torch.arange(NL, device=dev)[None, :] < (k + d)[:, None]
    leaf_cnt = torch.where(in_tree, keys >> _SEN_BITS, _INF)
    leaf_sen = torch.where(in_tree, keys & ((1 << _SEN_BITS) - 1), (1 << _SEN_BITS) - 1)

    b = torch.arange(B, device=dev)
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    lp, nh, nt = zeros.clone(), zeros.clone(), zeros.clone()
    remaining = k + d
    node_cnt = torch.full((B, T + 1), _INF, dtype=torch.int64, device=dev)  # + a dump slot
    parent = torch.full((B, NL + T + 1), -1, dtype=torch.int64, device=dev)  # + a dump slot
    for _ in range(T):
        active = remaining > 1
        total = zeros.clone()
        for _ in range(arity):
            lc = torch.where(lp < NL, leaf_cnt.gather(1, lp.clamp(max=NL - 1)[:, None])[:, 0],
                             _INF)
            nc = torch.where(nh < nt, node_cnt.gather(1, nh[:, None])[:, 0], _INF)
            pick_leaf = lc <= nc
            child = torch.where(active, torch.where(pick_leaf, lp, NL + nh), NL + T)
            parent[b, child] = NL + nt
            total += torch.where(active, torch.minimum(lc, nc), 0)
            lp += active & pick_leaf
            nh += active & ~pick_leaf
        node_cnt[b, torch.where(active, nt, T)] = total
        nt += active
        remaining -= torch.where(active, n1, 0)

    # internal depths from the root down (parents have larger ids), then leaves
    depth = torch.zeros((B, NL + T + 1), dtype=torch.int64, device=dev)
    for t in range(T - 1, -1, -1):
        p = parent[:, NL + t]
        depth[:, NL + t] = torch.where(p >= 0, depth.gather(1, p.clamp(min=0)[:, None])[:, 0] + 1,
                                       0)
    pl = parent[:, :NL]
    leaf_depth = torch.where(pl >= 0, depth.gather(1, pl.clamp(min=0)) + 1, 0)
    # sorted position -> seniority -> symbol
    pos_of_sen = torch.zeros((B, 1 << _SEN_BITS), dtype=torch.int64, device=dev)
    pos_of_sen.scatter_(1, leaf_sen, torch.arange(NL, device=dev).expand(B, NL))
    lengths = leaf_depth.gather(1, pos_of_sen.gather(1, rank.clamp(min=0)))
    lengths = torch.where(used, lengths, 0)
    return torch.where(used & (k == 1)[:, None], 1, lengths)


def huffman_lengths_ref(hists, arity):
    """Plain PyTorch version (any device) of ``huffman_lengths``: the JAX
    build's merge loop over all blocks at once, rebuilt with halved counts
    while any block's longest code exceeds the cap (reading that
    condition back each pass)."""
    _, cap = _check(hists, arity)
    f = hists.to(torch.int64)
    lengths = _build_once_ref(f, arity)
    while True:
        over = lengths.max(1).values > cap if lengths.numel() else lengths.new_zeros(0).bool()
        if not bool(over.any()):
            return lengths.to(torch.int32)
        f = torch.where(over[:, None] & (f > 0), (f + 1) // 2, f)
        lengths = torch.where(over[:, None], _build_once_ref(f, arity), lengths)


def table_params(arity):
    """The kernel's encode-table arguments at ``arity``: (dense_mode: 1 for
    [B, 256] packed entries, 2 for [B, 512] codes and field bits; the
    length's shift; bits a digit).  KeyError for an arity without
    kernels."""
    _kernel_arity(arity)
    return (1 if arity in PACKED_LEN_SHIFT else 2, PACKED_LEN_SHIFT.get(arity, 0),
            BITS_PER_DIGIT[arity])


def _launch(hists, arity, with_table):
    """One kernel launch: -> (lengths, dense or None)."""
    B, cap = _check(hists, arity)
    hists = hists.to(torch.int64).contiguous()
    _build.require_cuda(hists)
    dev = hists.device
    lengths = torch.empty((B, S), dtype=torch.int32, device=dev)
    dense, mode, shift, bpd = None, 0, 0, 0
    if with_table:
        mode, shift, bpd = table_params(arity)
        dense = torch.empty((B, S * mode), dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            rc = _build.lib().dct_table_build(
                hists.data_ptr(), lengths.data_ptr(), 0 if dense is None else dense.data_ptr(),
                B, arity, cap, mode, shift, bpd, _build.stream_of(hists))
        _build.check(rc, "table_build")
    return lengths, dense


def huffman_lengths(hists, arity):
    """Code lengths on the tensors' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  -> [B, 256] int32."""
    if hists.device.type == "cpu":
        return huffman_lengths_ref(hists, arity)
    lengths, _ = _launch(hists, arity, False)
    if lengths.shape[0]:
        huffman_lengths.launches += 1
    return lengths


huffman_lengths.launches = 0


def build_tables_ref(hists, arity):
    """Plain PyTorch version (any device) of ``build_tables``."""
    _kernel_arity(arity)
    lengths = huffman_lengths_ref(hists, arity)
    dense, _ = encode_tables_device(lengths, arity)
    return lengths, dense


def build_tables(hists, arity):
    """Code lengths and the encode table on the tensors' device, one
    launch for CUDA tensors, the plain version for CPU tensors.  ->
    (lengths [B, 256] int32, dense [B, 256] int32 at n = 2 and 16,
    [B, 512] at n = 3)."""
    if hists.device.type == "cpu":
        return build_tables_ref(hists, arity)
    _kernel_arity(arity)
    lengths, dense = _launch(hists, arity, True)
    if lengths.shape[0]:
        build_tables.launches += 1
    return lengths, dense


build_tables.launches = 0


def decode_tables(rows, arity):
    """The decode kernel's tables from [B, 256] uint8 wire length rows on
    the tensors' device: one launch for CUDA tensors, the plain version
    (``ops.table_build.decode_tables_device``) for CPU tensors.  ->
    (limit [B, L+1], bmf [B, L+1], symbols [B, 256]) int32, L =
    ``ARITY_MAX_LEN[arity]``; arities without kernels raise KeyError."""
    _kernel_arity(arity)
    if rows.dtype != torch.uint8 or rows.dim() != 2 or rows.shape[1] != S:
        raise ValueError(f"rows must be [B, {S}] uint8, got {rows.dtype} {tuple(rows.shape)}")
    if rows.device.type == "cpu":
        return decode_tables_device(rows, arity)
    rows = rows.contiguous()
    _build.require_cuda(rows)
    B, L, dev = rows.shape[0], ARITY_MAX_LEN[arity], rows.device
    out = torch.empty(B * (2 * (L + 1) + S), dtype=torch.int32, device=dev)  # one allocation
    limit, bmf, symbols = out.split([B * (L + 1), B * (L + 1), B * S])
    limit, bmf, symbols = limit.view(B, L + 1), bmf.view(B, L + 1), symbols.view(B, S)
    if B:
        with torch.cuda.device(dev):
            rc = _build.lib().dct_decode_tables(rows.data_ptr(), limit.data_ptr(),
                                                bmf.data_ptr(), symbols.data_ptr(), B, arity,
                                                L, _build.stream_of(rows))
        _build.check(rc, "decode_tables")
        decode_tables.launches += 1
    return limit, bmf, symbols


decode_tables.launches = 0


def decode_tables_floor(rows):
    """Launch an empty kernel on ``decode_tables``' grid for ``rows``
    (CUDA tensors only): the launch floor its time is read against."""
    _build.require_cuda(rows)
    with torch.cuda.device(rows.device):
        rc = _build.lib().dct_decode_tables_floor(rows.shape[0], _build.stream_of(rows))
    _build.check(rc, "decode_tables_floor")
