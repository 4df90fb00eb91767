"""Device-resident compression pipeline: bytes already in device memory
go to compressed payloads with no host read in between.

Counterpart of ``data_compression_tpu/device_api.py``.  ``api.compress``
serves bytes on the host; this module serves a producer whose data
already lives on the card.  ``compress_blocks_device`` runs five kernels
on the current stream: the per-block histogram
(``ops/kernels/histogram.py``) -> code lengths and the encode table in
one launch (``ops/kernels/table_build.py`` ``build_tables``) -> the
compact encode kernel -> a finishing kernel (the chunks' wire bytes, the
block offsets and payload total, the uint8 length rows) -> the
compaction kernel, and returns a handle whose tensors stay on the
device.  On the card one native call (``csrc/compress_chain.cu``)
enqueues them all into outputs allocated here; on the CPU each stage
takes its plain version.  Only ``DeviceCompressed.download`` reads back:
the payload total, and so whether the output fitted its capacity.
``decode_blocks_device`` builds the decode tables from the wire length
rows (``ops/kernels/table_build.py`` ``decode_tables``, one launch) and
runs the decode kernel, with no host read either: as the JAX function,
it does not check its offsets, and the decode kernel clamps every chunk
into ``flat`` itself.  Both entry points record the host time of their
stages in the call recorder (``utils/tracing.py``, ``STAGES``).

Per-block tables at n = 2, 3 and 16 only (the arities with kernels):
shared tables raise ValueError, other arities KeyError, as the JAX
functions do.  The TPU layouts of the JAX API (8-block decode cells,
4096-aligned compaction, maxlen buckets, interpret mode) are not carried
over: the flat payload is tight, and the decode takes the decode
kernel's own inputs (``ops/kernels/decode.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from data_compression_tpu_torch import api
from data_compression_tpu_torch.config import (
    ARITY_DIGITS_PER_BYTE,
    ARITY_MAX_LEN,
    CodecConfig,
    wire_bytes,
)
from data_compression_tpu_torch.models.base import EncodeResult
from data_compression_tpu_torch.models.huffman import HuffmanCodec
from data_compression_tpu_torch.ops.kernels import _build
from data_compression_tpu_torch.ops.kernels import compact as kcompact
from data_compression_tpu_torch.ops.kernels import decode as kdecode
from data_compression_tpu_torch.ops.kernels import encode as kencode
from data_compression_tpu_torch.ops.kernels.histogram import block_histograms, slices_for
from data_compression_tpu_torch.ops.kernels.table_build import (
    build_tables,
    decode_tables,
    table_params,
)
from data_compression_tpu_torch.utils import tracing

# The chain's clock at the end of its four kernel stages, then the mask of
# the kernels it launched.
_Stamps = ctypes.c_longlong * 5


@dataclasses.dataclass
class DeviceCompressed:
    """A device-resident compressed batch of blocks; every tensor lies on
    the device that compressed it."""

    flat: torch.Tensor  # [cap] uint8: the block payloads back to back, chunk order
    nb: torch.Tensor  # [B, S/C] int32: wire bytes of each chunk
    total: torch.Tensor  # [] int64: payload bytes; above cap when flat overflowed
    table_rows: torch.Tensor  # [B, 256] uint8: each block's wire length table
    raw_lens: torch.Tensor  # [B] int32: valid bytes of each block
    arity: int
    chunk_syms: int
    rows: torch.Tensor  # the encode kernel's block rows, compacted again on overflow
    block_bytes: torch.Tensor  # [B] int32

    def download(self):
        """-> host (flat payload bytes [total] uint8, nb [B, S/C] int64,
        table rows [B, 256] uint8, raw lengths [B] int64).  The one host
        read of the pipeline: when the payload outgrew ``flat``, the
        blocks are compacted again at their exact size first."""
        total = int(self.total)
        flat = self.flat
        if total > flat.numel():
            flat = kcompact.compact_blocks(self.rows, self.block_bytes, total=total)
        return (flat[:total].cpu().numpy(), self.nb.cpu().numpy().astype(np.int64),
                self.table_rows.cpu().numpy(), self.raw_lens.cpu().numpy().astype(np.int64))


def _on(t: torch.Tensor, device: torch.device) -> bool:
    """Whether ``t`` lies on ``device`` (a device without an index, as
    "cuda", matches any of its kind)."""
    return t.device.type == device.type and device.index in (None, t.device.index)


def _lens_on(raw_lens, device, B: int) -> torch.Tensor:
    """The raw lengths as a [B] int32 tensor on ``device`` (host values
    are copied there: a synchronising copy, made before the pipeline)."""
    lens = torch.as_tensor(raw_lens)
    if lens.shape != (B,) or lens.is_floating_point():
        raise ValueError(f"raw_lens must be [{B}] integers")
    if _on(lens, device) and lens.dtype == torch.int32:
        return lens.contiguous()
    return lens.to(device=device, dtype=torch.int32)


def _compact_into(rows, block_bytes, cap: int) -> torch.Tensor:
    """[cap] uint8 on the CPU: the first ``cap`` payload bytes, zeros past
    the payload's end (on the card the compaction kernel, handed ``cap``
    as its output size, writes them itself); the plain compaction takes
    only the exact size, so its output is cut or padded to ``cap`` here."""
    exact = kcompact.compact_blocks(rows, block_bytes)
    flat = torch.zeros(cap, dtype=torch.uint8)
    n = min(cap, exact.numel())
    flat[:n] = exact[:n]
    return flat


def compress_blocks_device(
    blocks: torch.Tensor,
    raw_lens,
    config: Optional[CodecConfig] = None,
    out_cap: Optional[int] = None,
    device="cuda",
) -> DeviceCompressed:
    """Compress [B, S] uint8 blocks on ``device`` (S = ``config.block_size``,
    block b valid up to ``raw_lens[b]``) with per-block tables.  With
    ``raw_lens`` an int32 tensor on the device, nothing is read back:
    the compaction writes the first ``out_cap`` payload bytes (default
    B * S) into ``flat`` and zeros past the payload's end, and
    ``download`` compacts again if the payload was longer.  On the card
    one native call enqueues every kernel (``chained`` counts such calls,
    ``finish_launches`` the finishing kernel's launches; the other four
    kernels count on their wrappers' ``launches``)."""
    with tracing.call("device_api.compress") as rec:
        out = _compress(rec, blocks, raw_lens, config, out_cap, device)
    return out


compress_blocks_device.chained = 0  # calls that took the native chain
compress_blocks_device.finish_launches = 0  # launches of its compress_finish_kernel


def _compress(rec, blocks, raw_lens, config, out_cap, device) -> DeviceCompressed:
    """``compress_blocks_device``'s stages, each but the last ended on
    ``rec``.  A function of its own, so that its temporaries are freed at
    its return, inside the call's last stage: the frees are host time of
    the call."""
    config = config or CodecConfig()
    if config.codec != "huffman" or config.shared_table:
        raise ValueError("the device pipeline runs the huffman codec with per-block tables")
    arity, C = config.arity, config.chunk_syms
    device = torch.device(device)
    if not _on(blocks, device):
        raise ValueError(f"blocks are on {blocks.device}, not {device}")
    if blocks.dtype != torch.uint8 or blocks.dim() != 2 or blocks.shape[1] != config.block_size:
        raise ValueError(f"blocks must be [B, {config.block_size}] uint8")
    B, S = blocks.shape
    lens = _lens_on(raw_lens, device, B)
    cap = B * S if out_cap is None else out_cap
    if cap < 0:
        raise ValueError(f"out_cap must be >= 0, got {cap}")
    if device.type == "cuda":
        return _chain(rec, blocks, lens, arity, C, cap)
    rec.next_stage()
    hist = block_histograms(blocks, lens)
    rec.next_stage()
    lengths, dense = build_tables(hist, arity)
    del hist  # not held through the encode's and the compaction's allocations
    rec.next_stage()
    rows, digits, block_bytes = kencode.encode_blocks(blocks, lens, dense, C, arity)
    rec.next_stage()
    flat = _compact_into(rows, block_bytes, cap)
    rec.next_stage()
    return DeviceCompressed(
        flat=flat, nb=wire_bytes(digits, arity),
        total=block_bytes.sum(dtype=torch.int64), table_rows=lengths.to(torch.uint8),
        raw_lens=lens, arity=arity, chunk_syms=C, rows=rows, block_bytes=block_bytes,
    )


def _chain(rec, blocks, lens, arity, C, cap) -> DeviceCompressed:
    """The card's stages: the outputs and one scratch allocation for the
    temporaries (laid out by ``csrc/compress_chain.cu``), then one native
    call that enqueues the five kernels, stamps the ends of the kernel
    stages on the recorder's clock and says which kernels it launched."""
    mode, shift, bpd = table_params(arity)  # KeyError without kernels, as build_tables
    B, S, C, ncb = kencode.check_geometry(blocks, lens, C, arity)
    kencode.require_kernel_inputs(blocks, lens)
    row_cap = kencode.row_capacity(S, C, arity)
    dev = blocks.device
    lib = _build.lib()
    scratch = torch.empty(lib.dct_compress_scratch_bytes(B, ncb, mode), dtype=torch.uint8,
                          device=dev)
    flat = torch.empty(cap, dtype=torch.uint8, device=dev)
    rows = torch.empty((B, row_cap), dtype=torch.uint8, device=dev)
    block_bytes = torch.empty(B, dtype=torch.int32, device=dev)
    nb = torch.empty((B, ncb), dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    table_rows = torch.empty((B, 256), dtype=torch.uint8, device=dev)
    stamps = _Stamps()
    rec.next_stage()
    rc = lib.dct_compress_chain(
        blocks.data_ptr(), lens.data_ptr(), B, S, C, slices_for(B, S, _build.sm_count(dev)),
        scratch.data_ptr(), arity, ARITY_MAX_LEN[arity], mode, shift, bpd, rows.data_ptr(),
        row_cap, block_bytes.data_ptr(), nb.data_ptr(), ARITY_DIGITS_PER_BYTE[arity],
        total.data_ptr(), table_rows.data_ptr(), flat.data_ptr(), cap, dev.index, rec.clock_id,
        stamps, _build.stream_of(blocks))
    _build.check(rc, "compress_chain")
    rec.stamped(stamps[:4])
    launched = stamps[4]  # bit k: the chain's k-th kernel was launched
    block_histograms.launches += launched & 1
    build_tables.launches += launched >> 1 & 1
    kencode.encode_blocks.launches += launched >> 2 & 1
    compress_blocks_device.finish_launches += launched >> 3 & 1
    kcompact._counted.launches += launched >> 4 & 1
    compress_blocks_device.chained += 1
    return DeviceCompressed(flat=flat, nb=nb, total=total, table_rows=table_rows, raw_lens=lens,
                            arity=arity, chunk_syms=C, rows=rows, block_bytes=block_bytes)


def to_frame(dc: DeviceCompressed, blocks, config: Optional[CodecConfig] = None) -> bytes:
    """The frame ``api.compress`` writes for the same bytes: ``blocks``
    (the compressed [B, S] blocks, on any device or as numpy) give each
    block's CRC and its LITERAL fallback; the payloads are assembled as
    the codec assembles them."""
    flat, nb, table_rows, raw_lens = dc.download()
    host_blocks = blocks.cpu().numpy() if isinstance(blocks, torch.Tensor) else np.asarray(blocks)
    config = config or CodecConfig(arity=dc.arity, block_size=host_blocks.shape[1],
                                   chunk_syms=dc.chunk_syms)
    codec = HuffmanCodec(config, dc.flat.device)
    payloads = codec._assemble_payloads(flat, nb, raw_lens, table_rows)
    return api.pack_blocks(config, int(raw_lens.sum()), host_blocks, raw_lens,
                           EncodeResult(payloads=payloads))


def chunk_inputs(dc: DeviceCompressed):
    """The decode kernel's inputs for every chunk of ``dc`` (empty ones
    too), built on the device: -> (flat, chunk_off [K+1] int64, chunk_cnt
    [K] int32, chunk_blk [K] int32), K = B * S/C.  Row k of the decode is
    chunk k % (S/C) of block k // (S/C)."""
    B, ncb = dc.nb.shape
    dev, C = dc.nb.device, dc.chunk_syms
    chunk_off = torch.zeros(B * ncb + 1, dtype=torch.int64, device=dev)
    torch.cumsum(dc.nb.view(-1), 0, out=chunk_off[1:])
    first = torch.arange(ncb, device=dev, dtype=torch.int32)[None, :] * C
    chunk_cnt = (dc.raw_lens[:, None] - first).clamp(0, C).to(torch.int32).view(-1)
    chunk_blk = (torch.arange(B * ncb, device=dev) // ncb).to(torch.int32)
    return dc.flat, chunk_off, chunk_cnt, chunk_blk


def decode_blocks_device(flat, chunk_off, chunk_cnt, chunk_blk, table_rows, arity=2,
                         chunk_syms=512, device="cuda") -> torch.Tensor:
    """Decode chunk streams on ``device`` (the inputs of
    ``ops/kernels/decode.py``, with the [B, 256] uint8 wire length rows in
    place of the decode tables, which are built from them on the device).
    -> [K, C] uint8 symbols on the device; bytes past chunk_cnt[k] are
    undefined.  Two launches and no host read: the offsets are not
    checked (``decode_chunks`` checks them), a chunk past ``flat`` decodes
    from its bytes inside it."""
    with tracing.call("device_api.decompress") as rec:
        out = _decode(rec, flat, chunk_off, chunk_cnt, chunk_blk, table_rows, arity, chunk_syms,
                      device)
    return out


def _decode(rec, flat, chunk_off, chunk_cnt, chunk_blk, table_rows, arity, chunk_syms,
            device) -> torch.Tensor:
    """``decode_blocks_device``'s stages, as ``_compress`` holds
    ``compress_blocks_device``'s."""
    device = torch.device(device)
    for t in (flat, chunk_off, chunk_cnt, chunk_blk, table_rows):
        if not _on(t, device):
            raise ValueError(f"decode inputs must lie on {device}, got {t.device}")
    rec.next_stage()
    limit, bmf, symbols = decode_tables(table_rows, arity)
    rec.next_stage()
    launch = kdecode.decode_launcher(flat, chunk_off, chunk_cnt, chunk_blk, limit, bmf, symbols,
                                     chunk_syms, arity, check=False)
    rec.next_stage()
    return launch()
