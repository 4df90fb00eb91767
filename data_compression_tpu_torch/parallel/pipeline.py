"""Sharded compress / decompress pipeline over ``torch.distributed``.

Counterpart of ``data_compression_tpu/parallel/pipeline.py``
(``compress_sharded`` / ``decompress_sharded`` with the per-shard kernel
steps ``make_shardmap_encode_step`` / ``make_shardmap_decode_step``).
Every rank calls with the same bytes and returns the same bytes.

Compress, on each rank of the mesh:
  1. its contiguous share of the blocks (B padded to a multiple of the
     world size with zero-length blocks) goes to the rank's device;
  2. per-block histograms (``torch.bincount``); per-block tables need
     every block's histogram, so the [B_local, 256] histograms are
     all-gathered; the shared table needs only their sum, which is
     all-reduced;
  3. host canonical tables: deterministic, so every rank builds the same;
  4. ``encode_chunk_rows`` (the per-chunk-rows kernel) on the local
     blocks, then an all-gather of the per-chunk digit counts and of the
     fixed-stride rows (the allgather-of-lengths design);
  5. exact offsets from the gathered lengths and vectorized frame
     assembly, identical on every rank.

Decompress: every rank parses the whole frame (so a corrupt stream
raises on every rank before any collective), decodes its contiguous
share of the coded blocks with the decode kernel, all-gathers the
symbols and checks every block's CRC.

Arities outside FAST_ARITIES have no kernel, as in the JAX package:
``compress_sharded`` raises KeyError for them, as the JAX package's does
(its sharded encode looks up a bit-field width they lack), and
``decompress_sharded`` decodes them on the host path on every rank, with
no collective.

The JAX package's XLA steps (``make_sharded_encode_step`` /
``make_sharded_decode_step``) and its ``use_pallas`` switch are not
carried over: the port has one route per device, the kernels on CUDA
and their plain versions on the CPU, for every chunk geometry.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from data_compression_tpu_torch import framing
from data_compression_tpu_torch.api import BytesLike, _as_bytes, pack_blocks
from data_compression_tpu_torch.config import (
    FAST_ARITIES, CodecConfig, max_chunk_bytes, wire_bytes,
)
from data_compression_tpu_torch.huffman import batched as hb
from data_compression_tpu_torch.models.base import EncodeResult
from data_compression_tpu_torch.models.huffman import HuffmanCodec, capped_lengths
from data_compression_tpu_torch.ops.histogram import block_histograms
from data_compression_tpu_torch.ops.kernels import decode as kdecode
from data_compression_tpu_torch.ops.kernels import encode as kencode
from data_compression_tpu_torch.parallel.mesh import Mesh, make_mesh
from data_compression_tpu_torch.utils.crc import crc32

# torch >= 2.13 renames all_gather_into_tensor to all_gather_single
_all_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[n, ...] on every rank -> [world * n, ...] in rank order."""
    x = x.contiguous()
    out = torch.empty((mesh.world_size * x.shape[0], *x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _all_gather_into(out, x, group=mesh.group)
    return out


def _pad_blocks(blocks: np.ndarray, lengths: np.ndarray, multiple: int):
    """Pad the block count to a multiple of ``multiple`` with zero-length
    blocks.  -> (blocks, lengths)."""
    B = blocks.shape[0]
    Bp = -(-max(B, 1) // multiple) * multiple
    if Bp == B:
        return blocks, lengths
    pb = np.zeros((Bp, blocks.shape[1]), np.uint8)
    pb[:B] = blocks
    pl = np.zeros(Bp, lengths.dtype)
    pl[:B] = lengths
    return pb, pl


def _table_lengths(mesh: Mesh, config: CodecConfig, dev_blocks, dev_lens) -> np.ndarray:
    """Code lengths of every block's table, [B, 256] int32, the same on
    every rank: from the all-gathered per-block histograms, or in shared
    mode from the all-reduced stream histogram (one row, repeated)."""
    hists = block_histograms(dev_blocks, dev_lens)
    B = mesh.world_size * hists.shape[0]
    if config.shared_table:
        total = hists.sum(dim=0)
        dist.all_reduce(total, group=mesh.group)
        row = np.asarray(capped_lengths(total.cpu().numpy(), config.arity), np.int32)
        return np.tile(row, (B, 1))
    hists = _all_gather(hists, mesh).cpu().numpy()
    return hb.capped_lengths_batch(hists, config.arity)


def compress_sharded(data: BytesLike, config: CodecConfig,
                     mesh: Optional[Mesh] = None) -> bytes:
    """Framed compression (huffman codec) across the ranks of ``mesh``
    (default: the default group on this rank's CUDA device).  The frame
    is byte-identical to ``api.compress``'s for the same config."""
    if config.codec != "huffman":
        raise ValueError(f"the sharded pipeline runs the huffman codec, not {config.codec}")
    mesh = mesh or make_mesh("cuda")
    codec = HuffmanCodec(config, mesh.device)
    raw = _as_bytes(data)
    S, C = config.block_size, config.chunk_syms
    ncb, mb = S // C, max_chunk_bytes(C, config.arity)

    blocks, lengths = framing.split_blocks(raw, S)
    B_real = blocks.shape[0]
    if B_real == 0:
        # as the JAX package's sharded frame: no chunk size in the header
        return framing.pack_frame(config.codec_id, config.arity, S, 0, [], [], [], [])
    if config.arity not in FAST_ARITIES:
        raise KeyError(f"no sharded encode for huffman arity {config.arity}: it has no "
                       f"bit-field wire packing (arities {FAST_ARITIES} do)")
    blocks, lengths = _pad_blocks(blocks, lengths, mesh.world_size)
    per = blocks.shape[0] // mesh.world_size
    lo = mesh.rank * per
    dev_blocks, dev_lens = codec.upload_blocks(blocks[lo : lo + per], lengths[lo : lo + per])

    table_lengths = _table_lengths(mesh, config, dev_blocks, dev_lens)
    local = hb.codes_batch(table_lengths[lo : lo + per], config.arity)
    dense = hb.encode_tensors(local, mesh.device)["dense"]
    rows, digits = kencode.encode_chunk_rows(dev_blocks, dev_lens, dense, C, config.arity)
    digits = _all_gather(digits, mesh)
    rows = _all_gather(rows, mesh)

    # rows past a chunk's wire bytes are undefined: keep the valid bytes,
    # in chunk order (padded blocks have none)
    nbytes = wire_bytes(digits.to(torch.int64), config.arity)
    keep = torch.arange(mb, device=rows.device)[None, :] < nbytes[:, None]
    flat = rows[keep].cpu().numpy()
    nb = nbytes.view(-1, ncb)[:B_real].cpu().numpy()
    blocks, lengths = blocks[:B_real], lengths[:B_real]
    table_rows = None if config.shared_table else table_lengths[:B_real].astype(np.uint8)
    payloads = codec._assemble_payloads(flat, nb, lengths, table_rows)
    shared = table_lengths[0].astype(np.uint8).tobytes() if config.shared_table else None
    return pack_blocks(config, len(raw), blocks, lengths, EncodeResult(payloads, shared))


def _decode_share(codec: HuffmanCodec, mesh: Mesh, payloads, raw_lens,
                  shared_table) -> np.ndarray:
    """Symbols of the coded blocks, [n, S] uint8, the same on every rank:
    each rank decodes its contiguous share, then all-gather."""
    S, C = codec.config.block_size, codec.config.chunk_syms
    n = len(payloads)
    per = -(-n // mesh.world_size)
    b0, b1 = min(n, mesh.rank * per), min(n, (mesh.rank + 1) * per)
    args, n_real = codec.decode_inputs(payloads, raw_lens, shared_table)
    k_start = np.zeros(n + 1, np.int64)
    np.cumsum(n_real, out=k_start[1:])
    k0, k1 = int(k_start[b0]), int(k_start[b1])
    out = kdecode.decode_chunks(
        flat=args["flat"],
        chunk_off=args["chunk_off"][k0 : k1 + 1],
        chunk_cnt=args["chunk_cnt"][k0:k1],
        chunk_blk=args["chunk_blk"][k0:k1] - b0,
        limit=args["limit"][b0:b1],
        bmf=args["bmf"][b0:b1],
        symbols=args["symbols"][b0:b1],
        chunk_syms=C,
        arity=args["arity"],
    )
    # chunk j of local block i goes to row i, symbols [j*C, (j+1)*C)
    blk = np.repeat(np.arange(b1 - b0), n_real[b0:b1])
    pos = np.arange(k0, k1) - np.repeat(k_start[b0:b1], n_real[b0:b1])
    local = torch.zeros((per, S // C, C), dtype=torch.uint8, device=mesh.device)
    local[torch.from_numpy(blk).to(mesh.device), torch.from_numpy(pos).to(mesh.device)] = out
    return _all_gather(local.view(per, S), mesh)[:n].cpu().numpy()


def decompress_sharded(data: BytesLike, config: Optional[CodecConfig] = None,
                       mesh: Optional[Mesh] = None) -> bytes:
    """Framed decompression (huffman codec) across the ranks of ``mesh``
    (default: the default group on this rank's CUDA device).  ``config``
    only supplies the chunk size of a frame that records none."""
    mesh = mesh or make_mesh("cuda")
    frame = framing.unpack_frame(_as_bytes(data))
    if frame.codec_name != "huffman":
        raise ValueError(f"the sharded pipeline runs the huffman codec, not {frame.codec_name}")
    C = frame.chunk_syms or (config.chunk_syms if config else 4096)
    codec = HuffmanCodec(
        CodecConfig(arity=frame.arity, block_size=frame.block_size, chunk_syms=C,
                    shared_table=frame.shared_table is not None),
        mesh.device,
    )
    entries = frame.entries
    out = [frame.payloads[i] if e.is_literal else None for i, e in enumerate(entries)]
    coded = [i for i, e in enumerate(entries) if not e.is_literal]
    payloads = [frame.payloads[i] for i in coded]
    raw_lens = [entries[i].raw_len for i in coded]
    if coded and frame.arity not in FAST_ARITIES:
        for i, blk in zip(coded, codec.decode_blocks(payloads, raw_lens, frame.shared_table)):
            out[i] = blk
    elif coded:
        syms = _decode_share(codec, mesh, payloads, raw_lens, frame.shared_table)
        for k, i in enumerate(coded):
            out[i] = syms[k, : entries[i].raw_len].tobytes()
    for i, e in enumerate(entries):
        if len(out[i]) != e.raw_len or crc32(out[i]) != e.crc:
            raise ValueError(f"block {i}: integrity check failed")
    result = b"".join(out)
    if len(result) != frame.total_len:
        raise ValueError("total length mismatch")
    return result
